"""Import-path compat for ``deepspeed.moe`` (port of
``deepspeedsyclsupport_tpu/moe``)."""
from . import layer  # noqa: F401
