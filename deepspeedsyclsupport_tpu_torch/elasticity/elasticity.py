"""Elastic batch-size configuration.

Analog of ``deepspeed/elasticity/elasticity.py`` (774 LoC): given a maximum
acceptable global batch size and a set of candidate micro-batch sizes, find the
global batch size that stays valid across a whole RANGE of chip counts, so a job
can lose or gain hardware and resume without changing its effective batch (the
contract ``compute_elastic_config`` at ``elasticity/elasticity.py:233`` serves
for torchelastic; here the restart path is a process relaunch + the
checkpoint load, which needs no conversion).

A copy of ``deepspeedsyclsupport_tpu/elasticity/elasticity.py`` (stdlib-only).

The math is topology-independent and ports as pure functions. v0.2 semantics:
``model_parallel_size`` divides chips into model replicas first.
"""
from dataclasses import dataclass
from functools import reduce
from typing import Dict, List, Sequence, Tuple


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


def _lcm(a: int, b: int) -> int:
    from math import gcd

    return a * b // gcd(a, b)


def get_valid_gpus(batch_size: int, micro_batches: Sequence[int],
                   min_valid_gpus: int, max_valid_gpus: int) -> List[int]:
    """Chip counts that evenly factor ``batch_size = micro × gas × gpus`` for
    some micro in ``micro_batches`` (reference ``_get_valid_gpus``)."""
    valid = set()
    for mb in micro_batches:
        if batch_size % mb:
            continue
        max_gpus = batch_size // mb
        for g in range(1, max_gpus + 1):
            if max_gpus % g == 0 and min_valid_gpus <= g <= max_valid_gpus:
                valid.add(g)
    return sorted(valid)


def get_best_candidates(max_acceptable_batch_size: int,
                        micro_batches: Sequence[int],
                        min_gpus: int, max_gpus: int,
                        prefer_larger: bool
                        ) -> Tuple[int, List[int], Dict[int, List[int]]]:
    """Search candidate batch sizes (multiples of lcm(micro_batches) and power-
    of-two scalings, reference ``_get_compatible_candidate_batch_sizes``): pick
    the one covering the most chip counts, tie-broken by batch size."""
    base = reduce(_lcm, micro_batches)
    candidates = set()
    b = base
    while b <= max_acceptable_batch_size:
        candidates.add(b)
        b *= 2
    for mb in micro_batches:
        b = mb
        while b <= max_acceptable_batch_size:
            candidates.add(b)
            b *= 2
    best: Tuple[int, List[int]] = (0, [])
    table: Dict[int, List[int]] = {}
    for c in sorted(candidates, reverse=prefer_larger):
        gpus = get_valid_gpus(c, micro_batches, min_gpus, max_gpus)
        table[c] = gpus
        if len(gpus) > len(best[1]):
            best = (c, gpus)
    if not best[1]:
        raise ElasticityError(
            f"no batch size ≤ {max_acceptable_batch_size} compatible with "
            f"micro batches {list(micro_batches)} on {min_gpus}..{max_gpus} chips")
    return best[0], best[1], table


def get_compatible_gpus(max_acceptable_batch_size: int,
                        micro_batches: Sequence[int],
                        min_gpus: int = 1, max_gpus: int = 10000,
                        prefer_larger: bool = True) -> Tuple[int, List[int]]:
    b, gpus, _ = get_best_candidates(max_acceptable_batch_size, micro_batches,
                                     min_gpus, max_gpus, prefer_larger)
    return b, gpus


@dataclass
class ElasticResult:
    final_batch_size: int
    valid_gpus: List[int]
    micro_batch_per_gpu: int
    gradient_accumulation_steps: int


def compute_elastic_config(ds_config: dict, target_deployment_size: int = None,
                           return_microbatch: bool = True) -> ElasticResult:
    """Reference ``compute_elastic_config`` (``elasticity/elasticity.py:233``):
    resolve the elastic section against a concrete chip count.

    ``return_microbatch=False`` skips micro-batch/GAS resolution (the fields
    come back 0), matching the reference's two return shapes — use it when the
    deployment only needs the batch size and valid-chip-count set.
    """
    e = dict(ds_config.get("elasticity", {}))
    if not e.get("enabled", False):
        raise ElasticityConfigError("elasticity section missing or disabled")
    max_batch = int(e.get("max_train_batch_size", 0))
    micro_batches = [int(m) for m in e.get("micro_batch_sizes", [])]
    if max_batch < 1 or not micro_batches:
        raise ElasticityConfigError(
            "elasticity needs max_train_batch_size and micro_batch_sizes")
    min_gpus = int(e.get("min_gpus", 1))
    max_gpus = int(e.get("max_gpus", 10000))
    prefer_larger = bool(e.get("prefer_larger_batch", True))
    mp = int(e.get("model_parallel_size", 1))

    batch, gpus = get_compatible_gpus(max_batch, micro_batches, min_gpus,
                                      max_gpus, prefer_larger)
    if target_deployment_size is None:
        return ElasticResult(batch, gpus, 0, 0)
    if target_deployment_size % mp:
        raise ElasticityError(
            f"deployment of {target_deployment_size} chips does not divide by "
            f"model_parallel_size {mp} — {target_deployment_size % mp} chips "
            f"would be stranded")
    dp = target_deployment_size // mp
    if dp < 1 or dp not in gpus:
        raise ElasticityError(
            f"deployment of {target_deployment_size} chips (dp={dp} at "
            f"mp={mp}) is not in the valid set {gpus} for batch {batch}")
    if not return_microbatch:
        return ElasticResult(batch, gpus, 0, 0)
    # choose the largest compatible micro batch (fewest accumulation steps)
    per_gpu = batch // dp
    micro = max((m for m in micro_batches if per_gpu % m == 0), default=None)
    if micro is None:
        raise ElasticityError(
            f"no micro batch in {micro_batches} divides per-chip batch {per_gpu}")
    return ElasticResult(batch, gpus, micro, per_gpu // micro)
