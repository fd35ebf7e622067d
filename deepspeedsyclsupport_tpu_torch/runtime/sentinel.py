"""Training-health sentinel: NaN / spike detection and graduated response.

Port of ``deepspeedsyclsupport_tpu/runtime/sentinel.py`` for one card:

* **detect**: health scalars computed on the card from the step's grads
  (:func:`health_metrics`: the nonfinite element count and one grad norm
  per region, the regions named as the JAX package's ``monitor/mfu.py``
  ``SCOPE_REGIONS``), then robust z-scores (median / MAD over a sliding
  window, :class:`RobustStat`) of the loss and the grad norm on the host,
  ``cfg.lag`` steps later;
* **respond**: the engine's gate discards any update whose mean loss is
  above the cap :meth:`TrainingSentinel.gate_array` gives (NaN compares
  false, so a nonfinite loss is discarded even before the history is
  warm); the host ladder then escalates ``warn`` -> ``skip`` (the stream
  position is journaled) -> ``rollback`` (``load_checkpoint`` of the newest
  promoted *last-good* tag, the registered data loader rewound with it,
  optionally a transient LR cut) -> ``abort`` with
  :data:`DIVERGENCE_EXIT_CODE` (220), which the elastic agent classes on
  its own;
* **replay**: every skip is journaled (``health_journal_rank<N>.jsonl``)
  and the loader's position rides the checkpoint meta, so a rolled-back or
  restarted run drops the same stream positions before dispatch and
  trains the run that never saw them, bit for bit.

Where the port differs by design: its optimizer's step count and learning
rate live on the host, so while the sentinel is armed the engine reads the
gate (``finite`` and the loss cap's verdict) on the host once a step and
skips the update there; the JAX package selects the update on the device.
The decisions and the trajectory are the same. Telemetry (the ``Health/*``
events, the goodput ledger) is not ported yet (ROADMAP.md A.3.4).

Import hygiene: stdlib, numpy and torch only; the elastic agent imports
:data:`DIVERGENCE_EXIT_CODE` from here.
"""
import collections
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import logger

#: Distinguished "training diverged past recovery" exit code (after the
#: preemption 217, collective hang 218 and serving decode hang 219): outside
#: the shell's signal-death range, classed separately by
#: ``elasticity/elastic_agent.py`` (``divergence_restarts``).
DIVERGENCE_EXIT_CODE = 220

#: the JAX package's ``monitor/mfu.py`` region registry (a copy: the port
#: imports nothing of the JAX package)
SCOPE_REGIONS = ("embed", "attn", "mlp", "head", "loss", "optimizer")

#: param-path keyword -> region for the per-region grad norms. First match
#: wins; unmatched leaves land in "other".
_REGION_KEYWORDS = (
    ("embed", ("embed", "wte", "wpe", "tok_", "pos_")),
    ("attn", ("attn", "attention", "q_proj", "k_proj", "v_proj", "o_proj",
              "qkv")),
    ("mlp", ("mlp", "ffn", "fc", "dense", "w_in", "w_out", "gate_proj",
             "up_proj", "down_proj")),
    ("head", ("head", "lm_head", "logits", "unembed")),
)

#: regions the grad-norm breakdown can emit (SCOPE minus loss / optimizer,
#: which label phases, not parameters) and the unmatched bucket
GRAD_REGIONS = tuple(r for r in SCOPE_REGIONS
                     if r not in ("loss", "optimizer")) + ("other",)


def region_of_param(path: str) -> str:
    """A param path (``layers/attn/wq``) -> its grad-norm region."""
    low = path.lower()
    for region, keys in _REGION_KEYWORDS:
        if any(k in low for k in keys):
            return region
    return "other"


def health_metrics(grads: Sequence[Any], paths: Sequence[str],
                   norms: Optional[Sequence[Any]] = None) -> Dict[str, Any]:
    """The detect half's scalars, on the grads' device: ``health_nonfinite``
    (the nonfinite element count, int32) and ``health_rn_<region>`` (the
    grad norm of each region present, float32). ``grads`` are the unscaled,
    unclipped float32 grads, ``paths`` their param paths; ``norms`` (one
    per grad, ``torch._foreach_norm``'s) saves recomputing them."""
    import torch

    if norms is None:
        norms = torch._foreach_norm(list(grads)) if grads else []
    return {"health_nonfinite": nonfinite_count(grads),
            **region_norms(paths, norms)}


def nonfinite_count(grads: Sequence[Any]) -> Any:
    """The nonfinite elements of ``grads``: an int32 scalar on their
    device. A leaf whose norm is finite has none, so a caller holding the
    norms needs this only when one of them is not."""
    import torch

    if not grads:
        return torch.zeros((), dtype=torch.int32)
    return torch.stack([(~torch.isfinite(g)).sum() for g in grads]
                       ).sum().to(torch.int32)


def region_norms(paths: Sequence[str], norms: Sequence[Any]
                 ) -> Dict[str, Any]:
    """``health_rn_<region>``: the grad norm of each region present, from
    the per-leaf norms."""
    import torch

    by_region: Dict[str, List[Any]] = {}
    for path, n in zip(paths, norms):
        by_region.setdefault(region_of_param(path), []).append(n)
    return {f"health_rn_{region}": torch.linalg.vector_norm(torch.stack(ns))
            for region, ns in by_region.items()}


# ------------------------------------------------------------- host stats
class RobustStat:
    """Sliding-window robust statistics of one scalar series: z-scores are
    (x - median) / (1.4826 MAD), an EWMA kept beside them for the journal's
    trend. Anomalous samples are not fed back (the caller updates only on
    healthy verdicts), so a spike cannot widen its own band."""

    def __init__(self, window: int, alpha: float):
        self.values: collections.deque = collections.deque(maxlen=window)
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self._memo: Optional[Tuple[float, float]] = None  # (median, spread)

    def update(self, x: float) -> None:
        if not math.isfinite(x):
            return
        self.values.append(float(x))
        self.ewma = (float(x) if self.ewma is None
                     else self.alpha * float(x)
                     + (1.0 - self.alpha) * self.ewma)
        self._memo = None

    def __len__(self) -> int:
        return len(self.values)

    @staticmethod
    def _median_sorted(xs: List[float]) -> float:
        n = len(xs)
        mid = n // 2
        return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])

    def _stats(self) -> Tuple[float, float]:
        if self._memo is None:
            xs = sorted(self.values)
            med = self._median_sorted(xs)
            mad = self._median_sorted(sorted(abs(v - med) for v in xs))
            self._memo = (med, max(1.4826 * mad,
                                   1e-3 * max(1.0, abs(med))))
        return self._memo

    def spread(self) -> float:
        """1.4826 MAD with a relative floor: a flat history must not turn
        the band into an equality test."""
        if not self.values:
            return float("inf")
        return self._stats()[1]

    def median(self) -> float:
        return self._stats()[0] if self.values else float("nan")

    def z(self, x: float) -> float:
        """Robust z of ``x`` (inf for a nonfinite sample, 0 while the window
        is empty)."""
        if not math.isfinite(x):
            return float("inf")
        if not self.values:
            return 0.0
        return (float(x) - self.median()) / self.spread()

    def state_dict(self) -> Dict[str, Any]:
        return {"values": list(self.values), "ewma": self.ewma}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.values.clear()
        self.values.extend(float(v) for v in sd.get("values", []))
        self.ewma = sd.get("ewma")
        self._memo = None


def _scalar(x, kind):
    """A metric (0-d tensor, numpy or Python number) as ``kind``."""
    if hasattr(x, "item"):
        x = x.item()
    return kind(x)


# --------------------------------------------------------------- sentinel
class TrainingSentinel:
    """One engine's health sentinel. Wiring (``runtime/engine.py``):

    * :meth:`offer_batch` once per ``train_batch`` call, before any work:
      advances the stream position and answers whether it is a journaled
      bad position to drop before dispatch (the replay path);
    * :meth:`gate_array`: ``[loss_cap, grad_scale]`` for this step's gate;
    * :meth:`at_step_boundary` from the engine's step boundary: queue this
      step's scalars and decide every step at least ``cfg.lag`` old;
    * :meth:`note_checkpoint` from the save path: the tag is promoted to
      ``last_good`` once a healthy step at least ``cfg.last_good_k`` beyond
      it is seen;
    * :meth:`state_dict` / :meth:`load_state_dict` ride the checkpoint
      meta; the journal's skips are re-read at construction.

    ``exit_fn`` (default ``sys.exit``) is injectable, so tests observe the
    rc-220 abort without dying."""

    def __init__(self, engine: Any, cfg: Any, rank: int = 0,
                 exit_fn: Optional[Callable[[int], None]] = None):
        self.engine = engine
        self.cfg = cfg
        self.rank = int(rank)
        self._exit_fn = exit_fn or sys.exit
        self._loss_stat = RobustStat(cfg.window, cfg.ewma_alpha)
        self._gn_stat = RobustStat(cfg.window, cfg.ewma_alpha)
        # (step, stream position, scalars) awaiting their lag
        self._pending: collections.deque = collections.deque()
        self._position = 0            # batches offered so far
        self._bad_positions = set()   # journaled skips, replayed
        self._healthy_steps = 0
        self._anomaly_streak = 0
        self._rollbacks = 0
        self._lr_cut_left = 0
        self._save_dir: Optional[str] = cfg.checkpoint_dir
        self._pending_tags: List[Tuple[str, int]] = []  # awaiting promotion
        self._promoted_step = -1
        self._journal_fh = None
        self._journal_path: Optional[str] = None
        self._resolve_journal()
        self._replay_journal()

    # ---------------------------------------------------------- journal
    def _resolve_journal(self) -> None:
        d = self.cfg.journal_dir or self._save_dir
        if d is None:
            return
        os.makedirs(d, exist_ok=True)
        self._journal_path = os.path.join(
            d, f"health_journal_rank{self.rank}.jsonl")

    def _replay_journal(self) -> None:
        """Re-read a journal from before a restart: its skip decisions must
        survive it (the checkpoint meta carries only those old enough to
        have been saved)."""
        if self._journal_path is None or \
                not os.path.exists(self._journal_path):
            return
        n = 0
        with open(self._journal_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail from a crash mid-append
                if rec.get("event") in ("skip", "nonfinite_skip") and \
                        rec.get("position") is not None:
                    self._bad_positions.add(int(rec["position"]))
                    n += 1
        if n:
            logger.info("sentinel: replaying %d journaled skip decision(s) "
                        "from %s", n, self._journal_path)

    def _journal(self, record: Dict[str, Any]) -> None:
        if self._journal_path is None:
            self._resolve_journal()
            if self._journal_path is None:
                return
        if self._journal_fh is None:
            self._journal_fh = open(self._journal_path, "a")
        self._journal_fh.write(json.dumps(record) + "\n")
        self._journal_fh.flush()

    def close(self) -> None:
        if self._journal_fh is not None:
            self._journal_fh.close()
            self._journal_fh = None

    # ------------------------------------------------------- step-path API
    def offer_batch(self) -> bool:
        """Advance the stream position; True means the engine drops this
        batch before dispatch (a journaled skip being replayed)."""
        pos = self._position
        self._position += 1
        if pos in self._bad_positions:
            self._journal({"event": "skip_replay", "position": pos,
                           "step": self.engine.global_steps})
            return True
        return False

    def gate_array(self) -> np.ndarray:
        """``[loss_cap, grad_scale]``: the cap is the robust band's skip
        edge once warm (+inf before; a NaN loss is gated all the same), the
        scale the transient post-rollback LR cut (1.0 otherwise)."""
        if len(self._loss_stat) >= self.cfg.warmup_steps:
            cap = (self._loss_stat.median()
                   + self.cfg.z_skip * self._loss_stat.spread())
        else:
            cap = float("inf")
        scale = self.cfg.lr_cut if self._lr_cut_left > 0 else 1.0
        return np.asarray([cap, scale], np.float32)

    def at_step_boundary(self, global_steps: int,
                         metrics: Dict[str, Any]) -> None:
        """Queue this step's scalars; decide every queued step at least
        ``cfg.lag`` steps old."""
        keep = {k: v for k, v in metrics.items()
                if k in ("loss", "grad_norm", "finite")
                or k.startswith("health_")}
        self._pending.append((global_steps, self._position - 1, keep))
        while self._pending and \
                self._pending[0][0] <= global_steps - self.cfg.lag:
            step, pos, m = self._pending.popleft()
            self._process(step, pos, m)

    # --------------------------------------------------------- the verdict
    def _process(self, step: int, pos: int, m: Dict[str, Any]) -> None:
        loss = _scalar(m.get("loss", float("nan")), float)
        gn = _scalar(m.get("grad_norm", float("nan")), float)
        finite = _scalar(m.get("finite", True), bool)
        nonfinite = _scalar(m.get("health_nonfinite", 0), int)
        regions = {k[len("health_rn_"):]: _scalar(v, float)
                   for k, v in m.items() if k.startswith("health_rn_")}
        loss_z = self._loss_stat.z(loss)
        gn_z = self._gn_stat.z(gn)
        warmed = len(self._loss_stat) >= self.cfg.warmup_steps

        loss_bad = math.isnan(loss) or math.isinf(loss)
        if (not finite or nonfinite > 0) and not loss_bad and \
                getattr(self.engine, "fp16_enabled", False):
            # an fp16 loss-scale overflow (nonfinite grads, finite loss):
            # the scaler skipped the update and retries at a lower scale.
            # Ledgered, but NOT a bad position: replaying it as a skip
            # would desync the scaler from the original run
            self._record("overflow", step, pos, loss, loss_z, gn_z,
                         nonfinite, skipped=False)
            return
        if nonfinite > 0 or not finite or loss_bad:
            worst = max(regions, key=regions.get) if regions else None
            self._anomaly(step, pos, "nonfinite", loss, loss_z, gn_z,
                          nonfinite,
                          detail=f"nonfinite grads in region "
                                 f"{worst or '?'}" if nonfinite else
                                 "nonfinite loss")
            return
        if warmed and (loss_z > self.cfg.z_skip or gn_z > self.cfg.z_skip):
            self._anomaly(step, pos, "spike", loss, loss_z, gn_z, nonfinite,
                          detail=f"loss_z={loss_z:.1f} gn_z={gn_z:.1f}")
            return
        if warmed and (loss_z > self.cfg.z_warn or gn_z > self.cfg.z_warn):
            # warn rung: journaled, the sample kept (refusing it would
            # freeze the band), the streak not advanced
            self._record("warn", step, pos, loss, loss_z, gn_z, nonfinite,
                         skipped=False)
        self._loss_stat.update(loss)
        self._gn_stat.update(gn)
        self._healthy_steps += 1
        self._anomaly_streak = 0
        if self._lr_cut_left > 0:
            self._lr_cut_left -= 1
        self._check_promotions(step)

    def _anomaly(self, step: int, pos: int, cause: str, loss: float,
                 loss_z: float, gn_z: float, nonfinite: int,
                 detail: str = "") -> None:
        from ..monitor.monitor import resilience_counters

        self._anomaly_streak += 1
        self._bad_positions.add(pos)
        resilience_counters.incr("skipped_batches")
        logger.warning(
            "sentinel: step %d (stream position %d) unhealthy (%s%s); "
            "update was discarded, position journaled (streak %d/%d)",
            step, pos, cause, f": {detail}" if detail else "",
            self._anomaly_streak, self.cfg.skip_limit)
        self._record("skip", step, pos, loss, loss_z, gn_z, nonfinite,
                     skipped=True, cause=cause)
        if self._anomaly_streak >= self.cfg.skip_limit:
            self._escalate(step, cause)

    def _record(self, action: str, step: int, pos: int, loss: float,
                loss_z: float, gn_z: float, nonfinite: int, skipped: bool,
                cause: Optional[str] = None) -> None:
        rec = {"event": action, "step": step, "position": pos,
               "loss": None if math.isnan(loss) else loss,
               "loss_z": None if not math.isfinite(loss_z) else
               round(loss_z, 4),
               "grad_norm_z": None if not math.isfinite(gn_z) else
               round(gn_z, 4),
               "nonfinite": nonfinite}
        if cause:
            rec["cause"] = cause
        if skipped:
            rec["streak"] = self._anomaly_streak
        self._journal(rec)

    # --------------------------------------------------------- escalation
    def _escalate(self, step: int, cause: str) -> None:
        if self._rollbacks >= self.cfg.rollback_limit or \
                self._save_dir is None or \
                getattr(self.engine, "_dataloader", None) is None:
            self._abort(step, cause)
            return
        self._rollback(step, cause)

    def _rollback(self, step: int, cause: str) -> None:
        from ..checkpoint.engine import find_last_good_tag
        from ..monitor.monitor import resilience_counters

        tag, skipped = find_last_good_tag(self._save_dir)
        if tag is None:
            logger.error("sentinel: no promoted last-good tag under %s "
                         "(skipped: %s) — cannot roll back", self._save_dir,
                         skipped)
            self._abort(step, cause)
            return
        t0 = time.perf_counter()
        logger.warning("sentinel: anomaly streak hit %d at step %d (%s); "
                       "rolling back to last-good tag %s",
                       self._anomaly_streak, step, cause, tag)
        bad = set(self._bad_positions)   # survive the meta restore below
        self._pending.clear()            # verdicts of a rewound future
        self._rollbacks += 1
        # restores params / optimizer / scaler, global_steps, the
        # registered loader's position and this sentinel's saved state
        self.engine.load_checkpoint(self._save_dir, tag)
        self._bad_positions |= bad
        self._anomaly_streak = 0
        self._lr_cut_left = self.cfg.lr_cut_steps
        rolled_to = self.engine.global_steps
        self._pending_tags = [(t, s) for t, s in self._pending_tags
                              if s <= rolled_to]
        dur = time.perf_counter() - t0
        resilience_counters.incr("rollbacks")
        self._journal({"event": "rollback", "step": step,
                       "rolled_back_to": rolled_to, "tag": tag,
                       "cause": cause, "duration_s": round(dur, 3),
                       "lr_cut_steps": self._lr_cut_left})
        logger.warning("sentinel: rolled back to step %d (tag %s) in "
                       "%.2fs; %d journaled bad position(s) will be "
                       "skipped on replay", rolled_to, tag, dur,
                       len(self._bad_positions))

    def _abort(self, step: int, cause: str) -> None:
        from .loss_scaler import overflow_ledger

        logger.error(
            "sentinel: divergence at step %d (%s) beyond the response "
            "ladder (rollbacks %d/%d); exiting with divergence code %d",
            step, cause, self._rollbacks, self.cfg.rollback_limit,
            DIVERGENCE_EXIT_CODE)
        # the scaler's overflow ledger joins the post-mortem record
        self._journal({"event": "abort", "step": step, "cause": cause,
                       "rollbacks": self._rollbacks,
                       "scaler": overflow_ledger(self.engine.scaler_state)})
        self.close()
        self._exit_fn(DIVERGENCE_EXIT_CODE)

    # --------------------------------------------------------- promotions
    def note_checkpoint(self, tag: str, step: int, save_dir: str) -> None:
        """A checkpoint was written at ``step``: queue it for promotion."""
        self._save_dir = save_dir
        if self.rank == 0:
            self._pending_tags.append((tag, int(step)))

    def _check_promotions(self, healthy_step: int) -> None:
        if not self._pending_tags or self._save_dir is None:
            return
        k = self.cfg.last_good_k
        ripe = [(t, s) for t, s in self._pending_tags if healthy_step >= s + k]
        if not ripe:
            return
        self._pending_tags = [(t, s) for t, s in self._pending_tags
                              if healthy_step < s + k]
        tag, s = max(ripe, key=lambda ts: ts[1])
        if s <= self._promoted_step:
            return
        from ..checkpoint.engine import promote_last_good

        promote_last_good(self._save_dir, tag)
        self._promoted_step = s
        logger.info("sentinel: promoted %s (step %d) to last-good "
                    "(%d healthy steps beyond it)", tag, s,
                    healthy_step - s)

    # -------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, Any]:
        return {
            "position": self._position,
            "bad_positions": sorted(self._bad_positions),
            "healthy_steps": self._healthy_steps,
            "anomaly_streak": self._anomaly_streak,
            "rollbacks": self._rollbacks,
            "lr_cut_left": self._lr_cut_left,
            "promoted_step": self._promoted_step,
            "pending_tags": [list(ts) for ts in self._pending_tags],
            "loss_stat": self._loss_stat.state_dict(),
            "gn_stat": self._gn_stat.state_dict(),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._position = int(sd.get("position", 0))
        # UNION: skips journaled after the save must survive the rollback
        # that restores it
        self._bad_positions |= {int(p) for p in sd.get("bad_positions", [])}
        self._healthy_steps = int(sd.get("healthy_steps", 0))
        self._anomaly_streak = int(sd.get("anomaly_streak", 0))
        # self._rollbacks is NOT restored: the ladder's budget counts
        # rollbacks per process lifetime
        self._lr_cut_left = int(sd.get("lr_cut_left", 0))
        self._promoted_step = max(self._promoted_step,
                                  int(sd.get("promoted_step", -1)))
        self._pending_tags = [(str(t), int(s))
                              for t, s in sd.get("pending_tags", [])]
        self._loss_stat.load_state_dict(sd.get("loss_stat", {}))
        self._gn_stat.load_state_dict(sd.get("gn_stat", {}))
