"""Roofline partition of one step: per-region FLOPs/bytes vs peaks.

Port of ``deepspeedsyclsupport_tpu/analysis/roofline.py``. The analytic
half of the MFU ledger (``monitor/mfu.py`` holds the trace/join half):
where the JAX package walks the step's jaxpr, the port counts ONE REAL
STEP's aten ops (``profiling/flops_profiler.OpCounter``), each attributed
to its ``mfu.<region>`` (forward and backward: an op the autograd engine
runs takes its forward op's region), and prices each region against a
device peak-spec:

* analytic FLOPs per region — the flops profiler's rules (``2·M·N·K`` a
  product, element count an elementwise op, input count a reduction); the
  hand-written kernels report their own, counted as their plain versions'
  products count them;
* HBM bytes per region — a perfect-fusion FLOOR: products, reductions and
  data movement count operand + result bytes, elementwise ops the result
  only, views nothing;
* comm bytes per region — the payloads of the step's ``torch.distributed``
  collectives, in the derived ``collective`` region.

Each region's roofline-achievable time is ``max(flops/peak, bytes/hbm_bw,
comm/link_bw)`` and the max's argument is the bound-by verdict.
"""
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class DeviceSpec:
    """Per-device peaks. ``peak_flops`` is the dense bf16 (or fp32 for the
    CPU) matmul peak; ``hbm_gbps`` main-memory bandwidth; ``ici_gbps``
    per-device interconnect bandwidth (one direction, all links: NVLink on
    a GPU; the field keeps the JAX package's name)."""
    name: str
    peak_flops: float
    hbm_gbps: float
    ici_gbps: float

    def as_dict(self) -> Dict[str, float]:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_gbps": self.hbm_gbps, "ici_gbps": self.ici_gbps}


#: Peak-spec registry. The H100 SXM row is NVIDIA's data sheet at 700 W:
#: 989 TFLOPS dense bf16, 3.35 TB/s HBM3, NVLink 900 GB/s both ways (450
#: one way). Add a device by adding a row here and a match in
#: :func:`device_spec`.
DEVICE_SPECS: Dict[str, DeviceSpec] = {
    "h100-sxm": DeviceSpec("h100-sxm", 989e12, 3350.0, 450.0),
    # CPU entry: replaced by a measured calibration (calibrate_cpu_spec)
    # the first time it is asked for, so CPU MFU numbers mean "fraction of
    # what THIS host's torch actually peaks at"
    "cpu": DeviceSpec("cpu", 5e10, 10.0, 1.0),
}

_cpu_calibrated: Optional[DeviceSpec] = None


def calibrate_cpu_spec(force: bool = False) -> DeviceSpec:
    """Measured CPU peaks (cached process-wide): a chain of 512³ float32
    matmuls prices ``peak_flops``, a 16 MiB elementwise pass prices
    ``hbm_gbps``. Coarse (one shape, one dtype) but honest."""
    global _cpu_calibrated
    if _cpu_calibrated is not None and not force:
        return _cpu_calibrated
    import torch

    n, iters = 512, 8
    x = torch.ones((n, n), dtype=torch.float32) / n

    def chain(x):
        for _ in range(iters):
            x = x @ x
        return x

    chain(x)  # warm
    t0 = time.perf_counter()
    chain(x)
    dt = max(time.perf_counter() - t0, 1e-9)
    peak = 2.0 * n ** 3 * iters / dt
    m = 1 << 22  # 4M float32 = 16 MiB through the pass
    y = torch.ones((m,), dtype=torch.float32)
    y + 1.0
    t0 = time.perf_counter()
    y + 1.0
    dt = max(time.perf_counter() - t0, 1e-9)
    bw = 2.0 * m * 4 / dt / 1e9  # read + write
    _cpu_calibrated = DeviceSpec("cpu", peak, bw,
                                 DEVICE_SPECS["cpu"].ici_gbps)
    return _cpu_calibrated


def device_spec(device: Any = None, calibrate_cpu: bool = True
                ) -> DeviceSpec:
    """Spec for a device: a ``torch.device`` (or its string, ``"cuda:0"``,
    ``"cpu"``), a card's name as ``torch.cuda.get_device_name`` gives it,
    or None (card 0 when there is one, else the CPU). An H100 maps to the
    H100 SXM row; an unknown card borrows it and SAYS so in the spec's
    name; the CPU returns the calibrated CPU entry."""
    import torch

    name = None
    if isinstance(device, str) and not device.split(":")[0] in (
            "cuda", "cpu", "meta"):
        name = device
    else:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type != "cuda":
            return (calibrate_cpu_spec() if calibrate_cpu
                    else DEVICE_SPECS["cpu"])
        name = torch.cuda.get_device_name(device)
    if "H100" in name.upper():
        return DEVICE_SPECS["h100-sxm"]
    base = DEVICE_SPECS["h100-sxm"]
    return DeviceSpec(f"gpu-unknown({name or '?'})~h100-sxm",
                      base.peak_flops, base.hbm_gbps, base.ici_gbps)


# ----------------------------------------------------------- region costing
def region_costs(counter: Any) -> Dict[str, Dict[str, float]]:
    """Per-region analytic cost table ``{region: {"flops", "hbm_bytes",
    "comm_bytes", "n_eqns", "matmul_flops"}}`` of the step an
    ``OpCounter`` counted (``n_eqns``: its aten ops, under the JAX
    package's key)."""
    out: Dict[str, Dict[str, float]] = {}
    for region, row in counter.by_region().items():
        out[region] = {"flops": row["flops"], "hbm_bytes": row["hbm_bytes"],
                       "comm_bytes": row["comm_bytes"],
                       "n_eqns": row["n_ops"],
                       "matmul_flops": row["matmul_flops"]}
    return out


def roofline_table(costs: Dict[str, Dict[str, float]],
                   spec: DeviceSpec,
                   census_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Evaluate per-region costs against a device spec: each region's
    achievable time is the max of its compute, memory and comm terms and
    ``bound_by`` names the binding one. ``census_bytes`` (the HLO
    collective census total, ``analysis/collectives.py``) is added to the
    ``collective`` region — partitioner-inserted traffic the jaxpr can't
    see. Serializes to the ``monitor/mfu.ledger`` roofline contract."""
    regions: Dict[str, Dict[str, Any]] = {}
    total_flops = total_achievable = 0.0
    costs = {k: dict(v) for k, v in costs.items()}
    if census_bytes:
        col = costs.setdefault(
            "collective",
            {"flops": 0.0, "hbm_bytes": 0.0, "comm_bytes": 0.0, "n_eqns": 0})
        col["comm_bytes"] += float(census_bytes)
    for name, c in costs.items():
        t_compute = c["flops"] / spec.peak_flops if spec.peak_flops else 0.0
        t_memory = c["hbm_bytes"] / (spec.hbm_gbps * 1e9) \
            if spec.hbm_gbps else 0.0
        t_comm = c["comm_bytes"] / (spec.ici_gbps * 1e9) \
            if spec.ici_gbps else 0.0
        terms = {"compute": t_compute, "memory": t_memory, "comm": t_comm}
        bound = max(terms, key=terms.get)
        achievable = terms[bound]
        regions[name] = {
            "flops": c["flops"], "hbm_bytes": c["hbm_bytes"],
            "comm_bytes": c["comm_bytes"],
            "t_compute": t_compute, "t_memory": t_memory, "t_comm": t_comm,
            "achievable_s": achievable,
            "bound_by": bound if achievable > 0 else None,
        }
        total_flops += c["flops"]
        total_achievable += achievable
    return {
        "device": spec.name,
        "spec": spec.as_dict(),
        "regions": regions,
        "total_flops": total_flops,
        "total_achievable_s": total_achievable,
    }
