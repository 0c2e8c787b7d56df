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
(:data:`ZERO_AXES`, :data:`BATCH_AXES`, :data:`EXPERT_ZERO_AXES`), is
one process group: the ranks that differ only in those coordinates
(``ProcessTopology``). ``data``, ``expert`` and ``seq`` may exceed 1
in the port: the ranks of a ``seq`` group share their samples and each
holds one chunk of every sequence (``parallel/ring_attention.py``); an
``expert`` group takes distinct samples, as ``data`` does, and splits
the experts of every MoE layer among its ranks, whose queues cross it
(``moe/layer.py``), while the expert leaves' ZeRO group is
:data:`EXPERT_ZERO_AXES`. A ``model`` group shares its samples and
splits every layer's heads and MLP columns and the vocabulary among its
ranks (tensor parallelism, ``utils/partitioning.py``); the step tail
reduces over :data:`STEP_AXES`. A ``pipe`` group holds one pipeline
stage a rank (``runtime/pipe``): the ranks of one ``(data, expert, seq,
model)`` coordinate, in stage order. ``pipe`` composes with ``data``,
``expert`` and ``model``; with ``seq`` above 1 it raises
``NotImplementedError`` naming ROADMAP.md (item 4.1: the JAX pipelined
model puts its micro-batches on ``(data, expert)`` only and threads no
ring or Ulysses attention through its stages).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .topology import ProcessTopology

MESH_AXES = ("pipe", "data", "expert", "seq", "model")

# Axes over which ZeRO shards non-expert params/grads/optimizer state. Expert
# params shard over ("data","seq") only (their "DP group" excludes the expert axis).
ZERO_AXES = ("data", "expert", "seq")
EXPERT_ZERO_AXES = ("data", "seq")
# Axes over which the global batch is split.
BATCH_AXES = ("data", "expert")
# Axes of the train step's flag, norm and loss: the ZeRO axes and the
# model axis (every rank but the pipeline's).
STEP_AXES = ZERO_AXES + ("model",)

# the axis tuples whose process groups every mesh builds
_GROUP_AXES = tuple((a,) for a in MESH_AXES) + (ZERO_AXES, EXPERT_ZERO_AXES,
                                               BATCH_AXES, STEP_AXES)


def _axes(axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


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
        if pp_size > 1 and sp_size > 1:
            raise NotImplementedError(
                f"mesh axis 'pipe' of size {pp_size} together with seq "
                f"({sp_size}) above 1: the JAX pipelined model threads no "
                "ring or Ulysses attention through its stages, and "
                "deepspeed_tpu_torch does not either (ROADMAP item 4.1; "
                "see ROADMAP.md)")
        self.shape = dict(zip(MESH_AXES, (pp_size, inferred_dp, ep_size,
                                          sp_size, tp_size)))
        self.topology = ProcessTopology(list(MESH_AXES),
                                        list(self.shape.values()))
        # this rank's group along each axis tuple of _GROUP_AXES (None:
        # the world); every rank makes every group, in one order
        self._groups: Dict[Tuple[str, ...], object] = {}
        if comm.is_initialized() and comm.get_world_size() == n and n > 1:
            import torch.distributed as dist
            mine = comm.get_rank()
            made: Dict[Tuple[int, ...], object] = {}
            for axes in _GROUP_AXES:
                for ranks in self.comm_lists(axes):
                    key = tuple(ranks)
                    if len(key) == n:
                        made[key] = None
                    elif key not in made:
                        made[key] = dist.new_group(list(key))
                    if mine in key:
                        self._groups[axes] = made[key]

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

    def comm_lists(self, axes: Union[str, Sequence[str]]
                   ) -> List[List[int]]:
        """Every group along ``axes``: the ranks that differ only in
        those coordinates, each list in axis-index order (the first axis
        outermost, as :meth:`axis_rank` counts)."""
        axes = _axes(axes)
        self.axes_size(axes)                    # unknown names raise
        topo = self.topology
        groups: Dict[tuple, List[Tuple[int, int]]] = {}
        for r in range(self.world_size):
            coord = topo.get_coord(r)
            key = tuple(getattr(coord, a) for a in MESH_AXES
                        if a not in axes)
            groups.setdefault(key, []).append((self._index(coord, axes), r))
        return [[r for _, r in sorted(members)]
                for _, members in sorted(groups.items())]

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of this rank along ``axes`` (one name or a
        tuple of :data:`MESH_AXES`, or of the tuples the engine reduces
        over): None (the default group) when it spans the world."""
        from .. import comm
        axes = _axes(axes)
        size = self.axes_size(axes)
        if not comm.is_initialized() or \
                comm.get_world_size() != self.world_size:
            raise RuntimeError(f"{self.describe()}: no process group of "
                               f"{self.world_size} ranks to take groups from")
        if size == self.world_size:
            return None
        if axes not in self._groups:
            raise ValueError(f"no process group along {axes}: the mesh "
                             f"builds {list(_GROUP_AXES)}")
        return self._groups[axes]

    def _index(self, coord, axes: Tuple[str, ...]) -> int:
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + getattr(coord, a)
        return idx

    def axis_rank(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's index within its group along ``axes`` (0 without a
        process group)."""
        from .. import comm
        if not comm.is_initialized():
            return 0
        return self._index(self.topology.get_coord(comm.get_rank()),
                           _axes(axes))

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

