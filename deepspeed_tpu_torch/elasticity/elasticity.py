"""Elastic training batch math — world-size-compatible batch configurations
(counterpart of ``deepspeed_tpu/elasticity/elasticity.py``).

Capability parity with the reference's ``elasticity/elasticity.py`` (v0.1/0.2):
from a target max batch size + admissible micro-batch sizes + a node range,
pick a global batch size that stays valid (divisible into micro*gas*world)
across as many world sizes as possible, so a job restarted at a different
scale keeps a compatible batch. The candidate enumeration follows the same
highly-composite-number idea (HCN_LIST, elasticity.py:19-58): HCNs maximize
divisor count and therefore the set of compatible world sizes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# highly composite numbers — maximal divisor counts (reference: HCN_LIST)
HCN_LIST = [1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840,
            1260, 1680, 2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720,
            45360, 50400, 55440, 83160, 110880, 166320, 221760, 277200]

LATEST_ELASTICITY_VERSION = 0.2


class ElasticityError(Exception):
    pass


def get_valid_gpus(batch_size: int, micro_batches: Sequence[int],
                   min_gpus: int, max_gpus: int) -> List[int]:
    """World sizes at which batch_size = mb * gas * gpus for some mb, gas>=1."""
    valid = set()
    for mb in micro_batches:
        if batch_size % mb != 0:
            continue
        per_mb = batch_size // mb
        for g in range(min_gpus, max_gpus + 1):
            if per_mb % g == 0:
                valid.add(g)
    return sorted(valid)


def get_best_candidates(max_acceptable_batch_size: int,
                        micro_batches: Sequence[int],
                        min_gpus: int, max_gpus: int,
                        prefer_larger: bool = True
                        ) -> Tuple[int, List[int]]:
    """Candidate batches mb*HCN <= max; pick the one valid at the most world
    sizes (ties broken toward larger/smaller batch per prefer_larger)."""
    best_batch, best_valid = None, []
    for mb in sorted(set(micro_batches)):
        for hcn in HCN_LIST:
            b = mb * hcn
            if b > max_acceptable_batch_size:
                break
            valid = get_valid_gpus(b, micro_batches, min_gpus, max_gpus)
            better = (len(valid) > len(best_valid) or
                      (len(valid) == len(best_valid) and best_batch is not None
                       and (b > best_batch if prefer_larger else b < best_batch)))
            if best_batch is None or better:
                best_batch, best_valid = b, valid
    if best_batch is None or not best_valid:
        raise ElasticityError(
            f"no valid elastic batch <= {max_acceptable_batch_size} for "
            f"micro_batches {list(micro_batches)} and gpu range "
            f"[{min_gpus}, {max_gpus}]")
    return best_batch, best_valid


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "",
                           world_size: int = 0) -> Tuple[int, List[int], int]:
    """(final_batch_size, valid_gpus, micro_batch_for_world_size).

    reference signature: elasticity.py compute_elastic_config; raises if the
    current world size is not among the valid ones.
    """
    e = ds_config.get("elasticity", {})
    if not e.get("enabled", False):
        raise ElasticityError("elasticity section missing or disabled")
    version = float(e.get("version", 0.1))
    if version > LATEST_ELASTICITY_VERSION:
        raise ElasticityError(f"unsupported elasticity version {version}")
    micro_batches = e.get("micro_batch_sizes", [2, 4, 6])
    max_batch = int(e.get("max_train_batch_size", 2000))
    min_gpus = int(e.get("min_gpus", 1))
    max_gpus = int(e.get("max_gpus", 10000))
    prefer_larger = bool(e.get("prefer_larger_batch", True))

    final_batch, valid_gpus = get_best_candidates(
        max_batch, micro_batches, min_gpus, max_gpus, prefer_larger)

    micro = 0
    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityError(
                f"world size {world_size} not in valid elastic gpu counts "
                f"{valid_gpus} for batch {final_batch}")
        # largest admissible micro batch that divides the per-gpu share
        per_gpu = final_batch // world_size
        fitting = [mb for mb in micro_batches if per_gpu % mb == 0]
        if not fitting:
            raise ElasticityError(
                f"no micro batch in {micro_batches} divides {per_gpu}")
        micro = max(fitting)
    return final_batch, valid_gpus, micro
