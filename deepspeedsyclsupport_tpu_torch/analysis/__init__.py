"""Analysis of the port's train step: the roofline partition
(``analysis/roofline.py``), the analytic half of the MFU ledger. The JAX
package's compiled-program analyzers (collective census, donation, dtype
and resharding audits, the codebase lint) are not ported yet (ROADMAP.md,
A.3.4 the rest)."""
from .roofline import (DEVICE_SPECS, DeviceSpec, device_spec, region_costs,
                       roofline_table)

__all__ = ["DeviceSpec", "DEVICE_SPECS", "device_spec", "region_costs",
           "roofline_table"]
