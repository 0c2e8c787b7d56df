"""The session's mesh of named axes over ``torch.distributed`` process
groups (counterpart of ``deepspeed_tpu/parallel/mesh.py``, which builds a
``jax.sharding.Mesh``; reference ``deepspeed/utils/groups.py``: the data /
model / expert group registry).

Axis layout (outer -> inner), as in the JAX package:

    pipe    pipeline-parallel stages
    data    pure data parallel / ZeRO shards
    expert  expert parallel, carved out of data parallel
    seq     sequence / context parallel
    model   tensor parallel (innermost)

Each axis, and each tuple of axes the engine reduces over
(:data:`ZERO_AXES`, :data:`BATCH_AXES`), is one process group: the ranks
that differ only in those coordinates (``ProcessTopology``). Only
``data`` may exceed 1 in the port so far: pipelines, tensor, sequence and
expert parallelism raise ``NotImplementedError`` naming ROADMAP.md (items
3 and 4.1), as the engine does for their config sections. So every group
is the whole world or one rank.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

from .topology import ProcessTopology

MESH_AXES = ("pipe", "data", "expert", "seq", "model")

# Axes over which ZeRO shards non-expert params/grads/optimizer state. Expert
# params shard over ("data","seq") only (their "DP group" excludes the expert axis).
ZERO_AXES = ("data", "expert", "seq")
EXPERT_ZERO_AXES = ("data", "seq")
# Axes over which the global batch is split.
BATCH_AXES = ("data", "expert")

_UNPORTED_AXES = {"pipe": "pipelines (ROADMAP item 4.1)",
                  "model": "tensor parallelism (ROADMAP item 4.1)",
                  "seq": "sequence parallelism (ROADMAP item 3)",
                  "expert": "expert parallelism (ROADMAP item 4.1)"}


class MeshManager:
    """Owns the session's axis sizes and their process groups; answers
    the group-size queries of ``deepspeed/utils/groups.py``.

    ``devices``: one entry per rank of the job (only its length is read);
    default the ``torch.distributed`` world, one rank without a process
    group. Groups exist only in a process group of that size, built here
    by every rank together."""

    def __init__(self,
                 devices: Optional[Sequence] = None,
                 pp_size: int = 1,
                 tp_size: int = 1,
                 sp_size: int = 1,
                 ep_size: int = 1,
                 dp_size: Optional[int] = None):
        from .. import comm
        n = len(devices) if devices is not None else comm.get_world_size()
        denom = pp_size * tp_size * sp_size * ep_size
        if n % denom != 0:
            raise ValueError(
                f"world size {n} not divisible by pipe({pp_size}) * model({tp_size}) "
                f"* seq({sp_size}) * expert({ep_size})")
        inferred_dp = n // denom
        if dp_size is not None and dp_size != inferred_dp:
            raise ValueError(f"dp_size={dp_size} inconsistent with world size {n}")
        for axis, size in (("pipe", pp_size), ("model", tp_size),
                           ("seq", sp_size), ("expert", ep_size)):
            if size > 1:
                raise NotImplementedError(
                    f"mesh axis '{axis}' of size {size}: "
                    f"{_UNPORTED_AXES[axis]} is not ported to "
                    "deepspeed_tpu_torch yet (see ROADMAP.md)")
        self.shape = dict(zip(MESH_AXES, (pp_size, inferred_dp, ep_size,
                                          sp_size, tp_size)))
        self.topology = ProcessTopology(list(MESH_AXES),
                                        list(self.shape.values()))
        self._self_group = None
        if comm.is_initialized() and comm.get_world_size() == n and n > 1:
            # every group of this mesh is the world or one rank: the
            # single-rank groups are made by all ranks, in rank order
            import torch.distributed as dist
            mine = comm.get_rank()
            for r in range(n):
                g = dist.new_group([r])
                if r == mine:
                    self._self_group = g

    # -- groups.py-compatible accessors --------------------------------------

    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    def get_data_parallel_world_size(self) -> int:
        """DP degree as the reference defines it (includes ranks later carved for EP)."""
        return self.shape["data"] * self.shape["expert"] * self.shape["seq"]

    def get_model_parallel_world_size(self) -> int:
        return self.shape["model"]

    def get_pipe_parallel_world_size(self) -> int:
        return self.shape["pipe"]

    def get_expert_parallel_world_size(self) -> int:
        return self.shape["expert"]

    def get_sequence_parallel_world_size(self) -> int:
        return self.shape["seq"]

    def get_expert_data_parallel_world_size(self) -> int:
        return self.shape["data"] * self.shape["seq"]

    # -- groups ---------------------------------------------------------------

    def axes_size(self, axes: Union[str, Sequence[str]]) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; have {MESH_AXES}")
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of this rank along ``axes`` (one name or a
        tuple): None (the default group) when it spans the world."""
        from .. import comm
        size = self.axes_size(axes)
        if not comm.is_initialized() or \
                comm.get_world_size() != self.world_size:
            raise RuntimeError(f"{self.describe()}: no process group of "
                               f"{self.world_size} ranks to take groups from")
        if size == self.world_size:
            return None
        return self._self_group

    def axis_rank(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's index within its group along ``axes``."""
        from .. import comm
        coord = self.topology.get_coord(comm.get_rank())
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + getattr(coord, a)
        return idx

    def local_batch_slice(self, global_batch: int) -> int:
        return global_batch // (self.shape["data"] * self.shape["expert"])

    def describe(self) -> str:
        return (f"Mesh(pipe={self.shape['pipe']}, data={self.shape['data']}, "
                f"expert={self.shape['expert']}, seq={self.shape['seq']}, "
                f"model={self.shape['model']})")


_GLOBAL_MESH: Optional[MeshManager] = None


def set_global_mesh(mm: Optional[MeshManager]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mm


def get_global_mesh() -> Optional[MeshManager]:
    return _GLOBAL_MESH


def build_mesh_from_config(config, devices: Optional[Sequence] = None
                           ) -> MeshManager:
    """Derive mesh axis sizes from a DeepSpeedConfig."""
    mm = MeshManager(
        devices=devices,
        pp_size=config.pipeline.stages,
        tp_size=config.tensor_parallel.tp_size,
        sp_size=config.sequence_parallel.sp_size,
        ep_size=config.moe.ep_size if config.moe.enabled else 1,
    )
    set_global_mesh(mm)
    return mm

