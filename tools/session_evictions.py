#!/usr/bin/env python3
"""The session cell's outcome counts at several KV pool sizes and
preemption policies, on one card.

``chip_smoke.py``'s phase ``session`` holds that its burst evicts at least
once; this runs the same traffic (``chip_smoke.session_traffic``: 48
requests, seed 0, SLAs, 16 paced then 32 at once) through
``ServingSession`` over llama2-7b (bf16, full depth, K = 8 after
``warmup(fused_ladder=True)``, prefix cache, journal, watchdog) once per
(blocks, policy) pair and prints the counters, goodput and TTFT p50, so
the pool and policy the phase uses can be chosen from measurements.

    python3 tools/session_evictions.py [blocks:policy ...]

Default pairs: 32:requeue 32:reject 24:requeue 32:requeue 32:reject
24:requeue. Run from the repository root on a machine with one card.
"""
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DEFAULT = ("32:requeue", "32:reject", "24:requeue", "32:requeue",
           "32:reject", "24:requeue")


def main(argv):
    import numpy as np
    import torch

    import chip_smoke as cs
    from deepspeedsyclsupport_tpu_torch.inference.v2 import (
        ServingPolicyConfig, ServingSession, journal_path)
    from deepspeedsyclsupport_tpu_torch.ops import _build

    pairs = [(int(b), p) for b, p in (a.split(":") for a in argv or DEFAULT)]
    print(cs.card_line(), flush=True)
    cs.phase_build(_build)
    model, params = cs.serve_params(torch)
    traffic = cs.session_traffic(np, model.config.vocab_size)
    for blocks, policy in pairs:
        eng = cs.serve_engine(torch, model, params,
                              decode_steps_per_dispatch=8, num_blocks=blocks)
        eng.warmup(fused_ladder=True)
        jdir = tempfile.mkdtemp(prefix="dstpu_evictions_")
        sess = ServingSession(eng, ServingPolicyConfig(
            prefix_cache={"enabled": True}, journal_path=journal_path(jdir),
            watchdog_enabled=True, watchdog_deadline_s=60.0,
            preempt_policy=policy))
        events, _v, submitted, wall = cs.drive_session(sess, traffic)
        sess.close()
        ttft, _itl, good = cs.session_latency(np, events, submitted, traffic)
        print(f"{blocks} blocks, {policy}: {sess.counters} in {wall:.2f} s, "
              f"goodput {good / wall:.1f} tok/s, TTFT p50 "
              f"{np.percentile(list(ttft.values()), 50) * 1e3:.0f} ms",
              flush=True)
        shutil.rmtree(jdir, ignore_errors=True)
        del eng, sess
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
