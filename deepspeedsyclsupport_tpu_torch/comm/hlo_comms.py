"""The census summary of one step's collectives.

Port of ``deepspeedsyclsupport_tpu/comm/hlo_comms.py``. The JAX package
parses the optimized HLO of its compiled step, because the partitioner
inserts collectives that no façade call sees. The port has no compiled
program: the eager façade is the program, and every collective of a step
is a façade call, recorded in the comms logger's census window
(``comm/comms_logging.py``) in the same entry format
``parse_collectives`` returns (``{"op", "bytes", "shape",
"group_size"}``). :func:`summarize_collectives` gives the JAX summary's
shape from those entries.

Parsing HLO text (``parse_collectives``, ``summarize_compiled``) has no
counterpart: there is no HLO to parse (a documented n/a).
"""
from collections import defaultdict
from typing import Any, Dict, Iterable

# opcodes that move data between devices (JAX hlo_comms.py:26-29); the
# census spells each entry with the one its façade call lowers to
# (comms_logging.HLO_OPCODES)
COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)


def summarize_collectives(census: Iterable[Dict[str, Any]]
                          ) -> Dict[str, Dict[str, Any]]:
    """``{opcode: {count, total_bytes, example_shape, group_size}}`` of a
    census (JAX ``summarize_collectives``): ``example_shape`` the largest
    entry's shape, ``group_size`` the last entry's that has one."""
    summary: Dict[str, Dict[str, Any]] = defaultdict(
        lambda: {"count": 0, "total_bytes": 0, "example_shape": None,
                 "group_size": None, "_max": -1})
    for rec in census:
        s = summary[rec["op"]]
        s["count"] += 1
        s["total_bytes"] += rec["bytes"]
        if rec["bytes"] > s["_max"]:
            s["example_shape"], s["_max"] = rec["shape"], rec["bytes"]
        if rec.get("group_size"):
            s["group_size"] = rec["group_size"]
    for s in summary.values():
        del s["_max"]
    return dict(summary)
