"""Analysis of the port's train step and codebase.

Port of ``deepspeedsyclsupport_tpu/analysis/``. The JAX package's graph
analyzers read the compiled step (its HLO and jaxpr); the port has no
compiled program: the eager façade is the program. So:

* ``collectives`` (census vs the analytic expectation) reads the comms
  logger's record window of the last step (``comm/comms_logging.py``,
  one entry per collective call, in HLO's conventions) and the engine's
  plan (``Engine._specs``);
* ``donation`` audits the step's in-place updates: each param, master and
  moment tensor keeps its storage;
* ``dtype_audit`` is a ``TorchDispatchMode`` that rides the flops
  profiler's dispatch on a counted step;
* ``resharding`` is the torch equivalent: the census's ``other`` class as
  the internal-reshard signal, and a boundary check that each leaf a rank
  holds at step entry is the shard its ``_specs`` entry gives;
* ``capture`` gives ``meta``-device stand-ins of the full param tree (a
  rank holds shards) for the census's expectation and classifier;
* ``roofline`` prices the counted step's regions (the MFU ledger);
* ``codelint`` + ``baseline``: the AST rule engine over the port's tree,
  against its own baseline (``analysis/dslint_baseline.json``); CLI
  ``python -m deepspeedsyclsupport_tpu_torch.analysis.codelint --check``.

Documented n/a, with their reasons:

* ``jaxpr_walk`` (the recursive jaxpr traversal): there is no jaxpr; the
  job it does for the flops profiler and the dtype audit, every op of a
  step with its multiplicity, is done by ``profiling/flops_profiler.py``'s
  ``OpCounter``, which sees each op as it runs;
* ``hlo_comms.parse_collectives`` / ``summarize_compiled`` and
  ``donation.parse_aliased_params``: there is no HLO text or alias header
  to parse (``comm/hlo_comms.py`` keeps ``summarize_collectives``).
"""
from .capture import abstract_params, abstract_step_args
from .collectives import (CollectiveClasses, CollectiveExpectation,
                          check_collectives, classify_collectives,
                          collective_census, expected_train_collectives)
from .donation import DonationReport, donation_audit
from .dtype_audit import DtypeReport, dtype_audit
from .resharding import ReshardingReport, resharding_audit
from .roofline import (DEVICE_SPECS, DeviceSpec, device_spec, region_costs,
                       roofline_table)

__all__ = [
    "abstract_step_args", "abstract_params",
    "collective_census", "classify_collectives", "expected_train_collectives",
    "check_collectives", "CollectiveExpectation", "CollectiveClasses",
    "donation_audit", "DonationReport",
    "dtype_audit", "DtypeReport",
    "resharding_audit", "ReshardingReport",
    "DeviceSpec", "DEVICE_SPECS", "device_spec", "region_costs",
    "roofline_table",
]
