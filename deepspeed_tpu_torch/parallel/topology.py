"""N-D cartesian process topology with named axes (a copy of
``deepspeed_tpu/parallel/topology.py``, which imports nothing of JAX; the
port keeps its own).

Capability parity with the reference's ``deepspeed/runtime/pipe/topology.py``
(ProcessTopology / PipeDataParallelTopology / PipeModelDataParallelTopology /
PipelineParallelGrid). Pure coordinate math: the single source of truth for
rank <-> coordinate mapping and axis-local peer groups, from which
``parallel/mesh.py`` builds one ``torch.distributed`` process group per axis.
"""

from __future__ import annotations

import itertools
from collections import namedtuple
from typing import Dict, List, Sequence


class ProcessTopology:
    """Maps global ranks onto an N-D grid of named axes.

    Axis order is outer-to-inner: the LAST axis varies fastest with rank
    (matching the reference's row-major layout, topology.py:9-230); inner
    axes should be the high-bandwidth (NVLink) ones.
    """

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have equal length")
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate axis names in {axes}")
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self._coord_to_rank: Dict[tuple, int] = {}
        for rank, coord in enumerate(itertools.product(*[range(d) for d in self.dims])):
            self._coord_to_rank[coord] = rank
        self._rank_to_coord = {r: self.ProcessCoord(*c) for c, r in self._coord_to_rank.items()}

    def world_size(self) -> int:
        size = 1
        for d in self.dims:
            size *= d
        return size

    def get_rank(self, **coord_kwargs) -> int:
        if set(coord_kwargs.keys()) != set(self.axes):
            raise ValueError(f"expected axes {self.axes}, got {list(coord_kwargs)}")
        key = tuple(coord_kwargs[a] for a in self.axes)
        return self._coord_to_rank[key]

    def get_coord(self, rank: int):
        return self._rank_to_coord[rank]

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)] if axis in self.axes else 0

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def get_rank_repr(self, rank: int, omit_axes=("data",), inner_sep="_", outer_sep="-") -> str:
        """String like 'pipe_00-model_00' used in checkpoint file names."""
        coord = self.get_coord(rank)
        parts = []
        for axis, idx in zip(self.axes, coord):
            if axis in omit_axes:
                continue
            parts.append(f"{axis}{inner_sep}{idx:02d}")
        return outer_sep.join(parts)

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """All peer groups along ``axis``: ranks that differ only in that coordinate."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        for other_coord in itertools.product(*[range(self.get_dim(a)) for a in other_axes]):
            fixed = dict(zip(other_axes, other_coord))
            group = [self.get_rank(**{**fixed, axis: i}) for i in range(self.get_dim(axis))]
            lists.append(group)
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        """Ranks whose coordinates match all given axis=value constraints."""
        out = []
        for rank in range(self.world_size()):
            coord = self.get_coord(rank)
            if all(getattr(coord, a) == v for a, v in filter_kwargs.items()):
                out.append(rank)
        return out

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """(pipe, data) grid; data innermost so DP peers are adjacent.

    reference: topology.py:232-241.
    """

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """(pipe, data, model) grid for 3D parallelism. reference: topology.py:243-248."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Per-rank view of a pipeline topology: stage ids, peer groups, tied-weight groups.

    Capability parity with reference topology.py:249-453, minus the process
    groups (``parallel/mesh.py`` builds them).
    """

    def __init__(self, topology: ProcessTopology, global_rank: int = 0):
        self._topo = topology
        self.global_rank = global_rank
        self.world_size = topology.world_size()
        self.pipe_parallel_size = topology.get_dim("pipe") or 1
        self.data_parallel_size = topology.get_dim("data") or 1
        self.model_parallel_size = topology.get_dim("model") or 1
        coord = topology.get_coord(global_rank)
        self.stage_id = getattr(coord, "pipe", 0)
        self.data_parallel_id = getattr(coord, "data", 0)
        self.model_parallel_id = getattr(coord, "model", 0)

    def get_stage_id(self) -> int:
        return self.stage_id

    def get_data_parallel_id(self) -> int:
        return self.data_parallel_id

    def get_pipe_parallel_rank(self) -> int:
        return self.stage_id

    def get_data_parallel_rank(self) -> int:
        return self.data_parallel_id

    def get_model_parallel_rank(self) -> int:
        return self.model_parallel_id

    def get_pipe_parallel_world_size(self) -> int:
        return self.pipe_parallel_size

    def get_data_parallel_world_size(self) -> int:
        return self.data_parallel_size

    def get_model_parallel_world_size(self) -> int:
        return self.model_parallel_size

    def stage_to_global(self, stage_id: int) -> int:
        """Global rank of the same (data, model) coordinate at another pipeline stage."""
        kwargs = {"pipe": stage_id}
        if "data" in self._topo.axes:
            kwargs["data"] = self.data_parallel_id
        if "model" in self._topo.axes:
            kwargs["model"] = self.model_parallel_id
        return self._topo.get_rank(**kwargs)

    def pipe_group(self) -> List[int]:
        """All ranks in this rank's pipeline (same data/model coordinate)."""
        kwargs = {}
        if "data" in self._topo.axes:
            kwargs["data"] = self.data_parallel_id
        if "model" in self._topo.axes:
            kwargs["model"] = self.model_parallel_id
        return self._topo.filter_match(**kwargs)

    def dp_group(self) -> List[int]:
        kwargs = {"pipe": self.stage_id}
        if "model" in self._topo.axes:
            kwargs["model"] = self.model_parallel_id
        return self._topo.filter_match(**kwargs)

    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    def is_last_stage(self) -> bool:
        return self.stage_id == self.pipe_parallel_size - 1
