"""PyTorch port: the package imports neither ``jax`` nor the JAX package.

Every module of ``deepspeedsyclsupport_tpu_torch`` (and ``chip_smoke.py``)
is imported in a fresh interpreter whose meta path refuses ``jax`` and
``deepspeedsyclsupport_tpu``; importing must build no kernel either.
"""
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "deepspeedsyclsupport_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import deepspeedsyclsupport_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    from deepspeedsyclsupport_tpu_torch.ops import _build
    assert not _build._LOADED, "importing built a kernel"
    print(len(names), "modules")
""")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 67
    for name in ("compression.quantize", "parallel.moe",
                 "ops.flash_attention", "ops.evoformer_attn",
                 "ops.sparse_attention", "runtime.engine", "runtime.config",
                 "runtime.optimizers", "runtime.lr_schedules",
                 "runtime.loss_scaler", "runtime.constants",
                 "runtime.resilience", "runtime.sentinel",
                 "runtime.dataloader", "checkpoint.ckpt_engine",
                 "utils.logging", "utils.podid", "utils.fault_injection",
                 "comm.watchdog", "monitor.reqtrace", "monitor.telemetry",
                 "monitor.monitor", "inference.v2.serving",
                 "inference.v2.supervisor", "inference.v2.fleet.failover",
                 "inference.v2.fleet.router", "inference.v2.fleet.pool",
                 "inference.v2.fleet.cli", "inference.v2.fleet.__main__",
                 "elasticity.elasticity", "elasticity.elastic_agent",
                 "checkpoint.engine", "comm.comm", "comm.topology",
                 "comm.comms_logging", "runtime.zero",
                 "parallel.tensor_parallel", "parallel.pipeline",
                 "parallel.ulysses", "parallel.ring_attention", "moe",
                 "moe.layer", "comm.quantized", "runtime.zeropp",
                 "runtime.onebit"):
        assert importlib.util.find_spec(
            f"deepspeedsyclsupport_tpu_torch.{name}") is not None, name
