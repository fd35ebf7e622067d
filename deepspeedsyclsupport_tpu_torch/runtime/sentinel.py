"""Training-health sentinel: its distinguished exit code.

Of ``deepspeedsyclsupport_tpu/runtime/sentinel.py`` the port carries, so
far, only what the elastic agent reads: the rc a run exits with when the
sentinel's skip -> rollback -> abort ladder is exhausted. The sentinel
itself is not ported yet (ROADMAP.md A.3.3).
"""

#: Distinguished "training diverged past recovery" exit code (after the
#: preemption 217, collective hang 218 and serving decode hang 219): outside
#: the shell's signal-death range, classed separately by
#: ``elasticity/elastic_agent.py`` (``divergence_restarts``).
DIVERGENCE_EXIT_CODE = 220
