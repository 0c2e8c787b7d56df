"""ZeRO stages 0-3 as a sharding policy (counterpart of
``deepspeed_tpu/runtime/zero/stages.py``, whose rules this module keeps).

The policy is a pure function of (shape, stage, world): no device, no
process group. Which state each stage shards:

  stage 0: nothing (grads are all-reduced)
  stage 1: the fp32 master and the optimizer moments
  stage 2: + the gradients (reduce-scattered instead of all-reduced)
  stage 3: + the compute parameters (gathered around each use)

A leaf is sharded by inserting the ZeRO axes on its largest dimension that
the ZeRO world size divides (:func:`insert_zero_axes`); compute parameters
skip the last (feature) dim of a >= 2-D leaf (``avoid_last``) and stay
whole under ``stage3_param_persistence_threshold`` elements; gradients
under :attr:`ZeroShardingPolicy.GRAD_SHARD_MIN_ELEMS` stay whole. A spec
is a tuple with one entry per dim (None, an axis name or a tuple of
names), canonicalized as the JAX package canonicalizes its
``PartitionSpec`` s: size-1 axes dropped, single names unwrapped, trailing
Nones stripped.

Composed with a tensor-parallel spec (the JAX package's
``_compose_tp_dim``): the ZeRO axes widen the leaf's TP dim where the
TP and ZeRO sizes together divide it (an embedding table excepted: its
vocab dim is gathered, not contracted), else they take a fresh dim that
no TP axis holds.

The engine splits a leaf over the ZeRO group on :meth:`param_dim` /
:meth:`master_dim` / :meth:`grad_dim`, the dim of the spec: under TP a
dim of this rank's shard (a composed TP dim is split within the shard).
At a world of one the specs shard nothing, and these give the dim a
split would take at any world size (the TP dim where composable, else
the largest one), so that the engine's sharded path, with its
collectives, runs over a 1-way split (``runtime/zero/partition.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

from ...parallel.mesh import EXPERT_ZERO_AXES, MeshManager, ZERO_AXES

Spec = Tuple


def _axes_size(mesh_shape: dict, axes: Tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= mesh_shape.get(a, 1)
    return size


def canonicalize_spec(spec: Sequence, mesh_shape: dict) -> Spec:
    """Drop mesh axes of size 1, unwrap single-name tuples, strip trailing
    Nones (the JAX package's canonical form)."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        # drop only KNOWN size-1 axes; an unknown (typo'd) axis must stay
        names = tuple(n for n in names if mesh_shape.get(n, 0) != 1)
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _base(shape: Sequence[int], tp_spec: Optional[Sequence]) -> list:
    ndim = len(shape)
    base = list(tp_spec) if tp_spec is not None else []
    return base[:ndim] + [None] * (ndim - len(base))


def _free_dim(shape: Sequence[int], base: list, zero_size: int,
              avoid_last: bool) -> Optional[int]:
    """The largest dim that no TP axis holds (``base``: the TP spec's
    entries) and ``zero_size`` divides (the last one skipped with
    ``avoid_last`` on a >= 2-D leaf), None if there is none."""
    ndim = len(shape)
    free = [i for i in range(ndim) if base[i] is None and shape[i] > 0
            and shape[i] % max(zero_size, 1) == 0]
    if avoid_last and ndim > 1:
        free = [i for i in free if i != ndim - 1]
    if not free:
        return None
    return max(free, key=lambda i: shape[i])


def insert_zero_axes(shape: Sequence[int],
                     tp_spec: Optional[Sequence],
                     zero_axes: Tuple[str, ...],
                     zero_size: int,
                     avoid_last: bool = False) -> Spec:
    """A TP spec (or none) with the ZeRO axes on one more dim, the
    largest that no TP axis holds and ``zero_size`` divides
    (``avoid_last``: compute params keep their last dim whole, see the
    JAX package)."""
    base = _base(shape, tp_spec)
    if zero_size <= 1:
        return tuple(base)
    dim = _free_dim(shape, base, zero_size, avoid_last)
    if dim is None:
        return tuple(base)
    base[dim] = tuple(zero_axes) if len(zero_axes) > 1 else zero_axes[0]
    return tuple(base)


def _entry_axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _numel(shape) -> int:
    return int(math.prod(shape)) if len(shape) else 1


class ZeroShardingPolicy:
    """Maps (shape, stage, world) to the spec of each train-state element.

    ``mesh``: a :class:`~deepspeed_tpu_torch.parallel.mesh.MeshManager`, or
    the ZeRO world size as an int (a data-only mesh)."""

    # grads smaller than this stay whole (the JAX package's floor: a
    # 64-element layernorm grad is not worth a reduce-scatter)
    GRAD_SHARD_MIN_ELEMS = 8192

    def __init__(self, stage: int, mesh: Union[MeshManager, int],
                 param_persistence_threshold: int = 0):
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"invalid ZeRO stage {stage}")
        self.stage = stage
        self.mesh_shape = (dict(mesh.shape) if isinstance(mesh, MeshManager)
                           else {"pipe": 1, "data": int(mesh), "expert": 1,
                                 "seq": 1, "model": 1})
        self._zero_size = _axes_size(self.mesh_shape, ZERO_AXES)
        self._expert_zero_size = _axes_size(self.mesh_shape, EXPERT_ZERO_AXES)
        # reference: stage3_param_persistence_threshold (stage3.py
        # persistent params) — compute-dtype params smaller than this stay
        # whole; the fp32 master/grad/optimizer shards are unaffected
        self.param_persistence_threshold = int(param_persistence_threshold)

    @property
    def zero_size(self) -> int:
        return self._zero_size

    def _zero_axes_for(self, is_expert: bool) -> Tuple[Tuple[str, ...], int]:
        if is_expert:
            return EXPERT_ZERO_AXES, self._expert_zero_size
        return ZERO_AXES, self._zero_size

    def _canon(self, spec: Spec) -> Spec:
        return canonicalize_spec(spec, self.mesh_shape)

    def _compose_dim(self, shape, tp_spec, axes: Tuple[str, ...],
                     size: int, path: str = "") -> Optional[int]:
        """The TP dim that the ZeRO axes widen (JAX ``_compose_tp_dim``):
        the first TP-sharded dim that the TP size times ``size`` divides;
        None for an embedding table, a spec without TP axes or none
        divisible."""
        if tp_spec is None or "embedding" in path:
            return None
        for i, b in enumerate(_base(shape, tp_spec)):
            if b is None:
                continue
            ab = _entry_axes(b)
            if any(a in ab for a in axes):
                continue
            tp_sz = _axes_size(self.mesh_shape, ab)
            if shape[i] > 0 and shape[i] % (tp_sz * max(size, 1)) == 0:
                return i
        return None

    def _zero_spec(self, shape, tp_spec, is_expert, path, avoid_last=False
                   ) -> Spec:
        axes, size = self._zero_axes_for(is_expert)
        if size > 1:
            i = self._compose_dim(shape, tp_spec, axes, size, path)
            if i is not None:
                base = _base(shape, tp_spec)
                base[i] = _entry_axes(base[i]) + tuple(axes)
                return self._canon(base)
        return self._canon(insert_zero_axes(tuple(shape), tp_spec, axes,
                                            size, avoid_last=avoid_last))

    # -- specs ---------------------------------------------------------------

    def _persistent(self, shape) -> bool:
        return _numel(shape) < self.param_persistence_threshold

    def param_spec(self, shape, tp_spec=None, is_expert: bool = False,
                   path: str = "") -> Spec:
        """Compute-dtype params: sharded only at stage 3; params under the
        persistence threshold stay whole."""
        if self.stage < 3 or self._persistent(shape):
            return self._canon(insert_zero_axes(shape, tp_spec, (), 1))
        return self._zero_spec(shape, tp_spec, is_expert, path,
                               avoid_last=True)

    def master_spec(self, shape, tp_spec=None, is_expert: bool = False,
                    path: str = "") -> Spec:
        """fp32 master params + optimizer state: sharded from stage 1 up."""
        if self.stage < 1:
            return self._canon(insert_zero_axes(shape, tp_spec, (), 1))
        return self._zero_spec(shape, tp_spec, is_expert, path)

    def grad_spec(self, shape, tp_spec=None, is_expert: bool = False,
                  path: str = "") -> Spec:
        """Gradients: sharded from stage 2 up (a reduce-scatter)."""
        if self.stage < 2 or _numel(shape) < self.GRAD_SHARD_MIN_ELEMS \
                or self._tp_embedding(tp_spec, path):
            return self._canon(insert_zero_axes(shape, tp_spec, (), 1))
        return self._zero_spec(shape, tp_spec, is_expert, path)

    def _tp_embedding(self, tp_spec, path: str) -> bool:
        """A vocab-parallel embedding's grad stays TP-only (the JAX
        package's exception: widening the vocab dim breaks the grad
        scatter, and the grad is 1 / tp a rank already)."""
        if tp_spec is None or "embedding" not in path:
            return False
        axes = tuple(a for d in tp_spec if d is not None
                     for a in _entry_axes(d))
        return _axes_size(self.mesh_shape, axes) > 1

    # -- the dims the engine splits on ----------------------------------------

    def _dim(self, shape, shards: bool, avoid_last: bool,
             is_expert: bool, tp_spec=None, path: str = "") -> Optional[int]:
        if not shards:
            return None
        axes, size = self._zero_axes_for(is_expert)
        shape = tuple(shape)
        i = self._compose_dim(shape, tp_spec, axes, size, path)
        if i is not None:
            return i
        return _free_dim(shape, _base(shape, tp_spec), size, avoid_last)

    def param_dim(self, shape, is_expert: bool = False, tp_spec=None,
                  path: str = "") -> Optional[int]:
        """The dim a compute parameter splits on (of the whole ``shape``
        and its ``tp_spec``: under TP the same dim of this rank's
        shard)."""
        return self._dim(shape, self.stage == 3 and not self._persistent(
            shape), True, is_expert, tp_spec, path)

    def master_dim(self, shape, is_expert: bool = False, tp_spec=None,
                   path: str = "") -> Optional[int]:
        return self._dim(shape, self.stage >= 1, False, is_expert, tp_spec,
                         path)

    def grad_dim(self, shape, is_expert: bool = False, tp_spec=None,
                 path: str = "") -> Optional[int]:
        return self._dim(shape, self.stage >= 2 and _numel(shape) >=
                         self.GRAD_SHARD_MIN_ELEMS
                         and not self._tp_embedding(tp_spec, path), False,
                         is_expert, tp_spec, path)

    # -- flat-dict helpers ----------------------------------------------------

    def tree_specs(self, shapes: Dict[str, Sequence[int]], spec_fn,
                   tp_specs=None) -> Dict[str, Spec]:
        """``{path: spec}`` for a flat ``{path: shape}`` dict (with
        ``tp_specs``, a flat ``{path: TP spec or None}``)."""
        tp_specs = tp_specs or {}
        return {path: spec_fn(tuple(shape), tp_specs.get(path), False, path)
                for path, shape in shapes.items()}

    def param_specs(self, shapes, tp_specs=None):
        return self.tree_specs(shapes, self.param_spec, tp_specs)

    def master_specs(self, shapes, tp_specs=None):
        return self.tree_specs(shapes, self.master_spec, tp_specs)

    def grad_specs(self, shapes, tp_specs=None):
        return self.tree_specs(shapes, self.grad_spec, tp_specs)
