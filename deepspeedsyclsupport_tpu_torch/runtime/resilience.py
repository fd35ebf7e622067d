"""Preemption-aware resilience: its distinguished exit code.

Of ``deepspeedsyclsupport_tpu/runtime/resilience.py`` the port carries, so
far, only what the elastic agent reads. The SIGTERM -> emergency save ->
exit manager is not ported yet (ROADMAP.md A.3.3).
"""
from .sentinel import DIVERGENCE_EXIT_CODE  # noqa: F401  (re-export)

# Distinguished "I was preempted and saved cleanly" exit code. Chosen outside
# the shell's 126/127/128+N signal-death range so it can't be confused with a
# crash, and mirrored by the elastic agent's free-restart accounting.
PREEMPTION_EXIT_CODE = 217
