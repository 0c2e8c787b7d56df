"""Tensor-parallel sharding rules and the shard maps of the ``model`` axis
(counterpart of ``deepspeed_tpu/utils/partitioning.py``).

A model's rule table (``TransformerConfig.tp_rules()``) maps regexes on a
parameter's ``/``-joined path to a :class:`PartitionSpec` over the mesh
axes; :func:`build_tp_specs` applies it, first match winning, as the JAX
package does. Where JAX hands the specs to GSPMD, the port places each
model rank's shard itself and runs Megatron's layers over it
(``models/transformer.py``, ``models/generation.py``). Eager torch cannot
partition by an arbitrary spec, so the port takes exactly the in-tree
table (:func:`check_tp_rules`).

A rank's shard of a leaf is not always the contiguous slice its spec
names (:func:`tp_shard`):

* the fused ``attn_qkv`` columns: rank r of t holds its own heads
  (:func:`head_split`): the columns of q heads ``[a_r, b_r)``, balanced
  (71 over 4: 18, 18, 18, 17), then the columns of the k heads those q
  heads read, ``[a_r // g, (b_r - 1) // g]`` with g = nh / kv, and the
  same v heads' (GSPMD splits the columns contiguously and reshards after
  the split; a Megatron rank computes its heads whole). A kv head that
  several ranks read (multi-query attention, kv % t != 0, or a rank
  straddling two groups) is held by each of them: a replicated piece
  whose gradients are rank-partial, summed over exactly its holders
  (:func:`kv_grad_sum`), written to a checkpoint and counted in the grad
  norm by its lowest holder only (``TPShard.shared``). The row-parallel
  ``attn_proj`` rows follow the q heads;
* the vocab dim (``wte/embedding`` rows, ``lm_head/kernel`` columns):
  ceil(V / t) a rank, the last rank's short shard padded with zero rows
  locally (GSPMD pads too); padded rows are never looked up and their
  logits are -inf in the loss and dropped in a gather.

Every place that maps shard <-> whole (placement, checkpoint pieces,
reshard on load) goes through :class:`TPShard`'s segments.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

_NOT_PORTED = "is not ported to deepspeed_tpu_torch yet (see ROADMAP.md)"


class PartitionSpec(tuple):
    """One entry per leaf dim: None, a mesh axis name or a tuple of names
    (``jax.sharding.PartitionSpec``'s meaning; a tuple, so two specs
    compare by value)."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def path_str(path) -> str:
    """'transformer/h_0/attn/c_attn/kernel'-style key path string: keys
    (``.key``), indices (``.idx``) or plain values, joined by ``/``."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def spec_for(path: str, rules: Optional[Dict[str, PartitionSpec]]
             ) -> Optional[PartitionSpec]:
    """The spec of the first rule whose regex ``path`` matches, else None."""
    for pat, spec in (rules or {}).items():
        if re.search(pat, path):
            return spec
    return None


def build_tp_specs(params, rules: Optional[Dict[str, PartitionSpec]]):
    """A tree of specs (or None) with the structure of the nested dict
    ``params``: each leaf's spec from ``rules`` (regex searched against
    the ``/``-joined path, first match wins, in insertion order). None
    rules: no leaf is sharded."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        return spec_for(path_str(prefix), rules)
    return walk(params, ())


def check_tp_rules(rules, cfg, table=None
                   ) -> Optional[Dict[str, PartitionSpec]]:
    """``rules`` as the port runs them: None (replicated weights, every
    model rank computes the whole model) or the in-tree table (``table``,
    default ``cfg.tp_rules()``; a pipelined model's is its own
    ``tp_rules()``, the blocks led by ``pipe``), compared by value. Any
    other table raises: GSPMD partitions by any spec, eager torch only by
    the Megatron layers the port writes for that table (ROADMAP.md
    Queue 3)."""
    if rules is None:
        return None
    want = cfg.tp_rules() if table is None else table
    got = {k: (None if v is None else PartitionSpec(*v))
           for k, v in dict(rules).items()}
    if list(got.items()) != list(want.items()):
        raise NotImplementedError(
            "sharding_rules other than the model's own cfg.tp_rules(): a "
            "rule table of any other form (GSPMD partitions by any spec) "
            + _NOT_PORTED)
    return want


def head_split(nh: int, kv: int, rank: int, size: int
               ) -> Tuple[int, int, int, int]:
    """(a, b, ka, kb): rank ``rank`` of ``size`` computes query heads
    ``[a, b)``, balanced (the first nh % size ranks one more), and holds
    kv heads ``[ka, kb)``, the ones those query heads read (query head i
    reads kv head i // (nh / kv))."""
    base, extra = divmod(nh, size)
    a = rank * base + min(rank, extra)
    b = a + base + (1 if rank < extra else 0)
    g = nh // kv
    return a, b, a // g, (b - 1) // g + 1


def kv_shared(cfg, size: int) -> bool:
    """Whether some kv head is held by more than one of ``size`` model
    ranks (its gradient then sums over its holders)."""
    spans = [head_split(cfg.num_heads, cfg.kv_heads, r, size)[2:]
             for r in range(size)]
    return any(spans[r][0] < spans[r - 1][1] for r in range(1, size))


@dataclasses.dataclass(frozen=True)
class TPContext:
    """This rank's place on the mesh's ``model`` axis: its index ``rank``
    of ``size`` ranks, and the whole vocabulary (the padded vocab shards
    are ceil(vocab / size) rows)."""

    rank: int
    size: int
    vocab: int
    axis: str = "model"

    def head_range(self, cfg) -> Tuple[int, int, int, int]:
        """(a, b, ka, kb) of :func:`head_split`: this rank's query heads
        ``[a, b)`` and kv heads ``[ka, kb)``."""
        return head_split(cfg.num_heads, cfg.kv_heads, self.rank, self.size)

    def heads(self, cfg) -> Tuple[int, int]:
        """(query heads, kv heads) of this rank."""
        a, b, ka, kb = self.head_range(cfg)
        return b - a, kb - ka


def kv_index(cfg, tp) -> Optional[torch.Tensor]:
    """For each local query head, the local kv head it reads; None where
    that is ``repeat_interleave``'s pattern (every kv head read by nh / kv
    query heads in turn, as on one rank and at any even split)."""
    nh, kv = cfg.num_heads, cfg.kv_heads
    g = nh // kv
    a, b, ka, _ = ((0, nh, 0, kv) if tp is None else tp.head_range(cfg))
    if a % g == 0 and b % g == 0:
        return None
    return torch.arange(a, b) // g - ka


def check_tp_model(cfg, size: int) -> None:
    """Raise for the model shapes the port's TP layers do not take at
    ``size`` model ranks: fewer query heads than ranks (a rank would
    compute no head)."""
    if cfg.num_heads < size:
        raise ValueError(
            f"num_heads {cfg.num_heads} < tp_size {size}: a model rank "
            "would hold no attention head")


@dataclasses.dataclass(frozen=True)
class TPShard:
    """One rank's shard of a leaf along ``dim`` (negative: counted from
    the end, so a stacked ``[L, ...]`` leaf and one layer's slice share
    it): local positions ``[ls, ls + n)`` hold whole positions
    ``[ws, ws + n)`` for each ``(ls, ws, n)`` of ``segs``; the local
    extent is ``local`` (past the segments: zero padding) and the whole
    one ``whole``."""

    dim: int
    segs: Tuple[Tuple[int, int, int], ...]
    local: int
    whole: int
    # per segment: True where a lower model rank holds the same whole
    # positions (a shared kv head); empty: none shared
    shared: Tuple[bool, ...] = ()

    def owned_segs(self) -> Tuple[Tuple[int, int, int], ...]:
        """The non-empty segments this rank writes and counts (the
        shared ones are their lowest holder's)."""
        flags = self.shared or (False,) * len(self.segs)
        return tuple(sg for sg, sh in zip(self.segs, flags)
                     if sg[2] > 0 and not sh)

    def owned_mask(self) -> Optional[torch.Tensor]:
        """A [local] f32 weight along ``dim``, 0 at shared positions;
        None when nothing is shared."""
        if not any(self.shared):
            return None
        m = torch.zeros(self.local)
        for ls, _, n in self.owned_segs():
            m[ls:ls + n] = 1.0
        return m

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor (a copy where it pads or
        gathers segments, else a view)."""
        if whole.shape[self.dim] != self.whole:
            raise ValueError(f"leaf of {tuple(whole.shape)}: dim {self.dim} "
                             f"is not {self.whole} long")
        parts = [whole.narrow(self.dim, ws, n) for _, ws, n in self.segs
                 if n > 0]
        used = sum(n for _, _, n in self.segs)
        if used < self.local:
            shape = list(whole.shape)
            shape[self.dim] = self.local - used
            parts.append(torch.zeros(shape, dtype=whole.dtype,
                                     device=whole.device))
        return parts[0] if len(parts) == 1 else torch.cat(parts, self.dim)


def _vocab_dim(path: str) -> Optional[int]:
    if re.search(r"(^|/)wte/embedding$", path):
        return -2
    if re.search(r"(^|/)lm_head/kernel$", path):
        return -1
    return None


def tp_shard(path: str, shape: Sequence[int], spec, cfg, rank: int,
             size: int) -> Optional[TPShard]:
    """The :class:`TPShard` of rank ``rank`` of ``size`` for the leaf at
    ``path`` of ``shape`` (stacked or one layer's) under ``spec`` (its TP
    spec, or None: whole on every rank). A pipelined table's ``pipe`` on
    the layer dim is the stage's split, not a TP one: it is passed
    over."""
    if spec is None or size < 1:
        return None
    spec = tuple(spec)
    ndim = len(shape)
    # align the spec's trailing entries with the leaf's trailing dims (a
    # stacked rule's leading None or "pipe" is the layer dim)
    offs = len(spec) - ndim
    dims = [i - len(spec) for i, e in enumerate(spec)
            if e is not None and "model" in ((e,) if isinstance(e, str)
                                             else tuple(e))
            and i >= offs]
    if not dims:
        return None
    if any(e is not None and e not in ("model", "pipe", "expert")
           for e in spec):
        raise NotImplementedError(
            f"'{path}': a spec over other axes than 'model' and 'expert' "
            f"({spec}) under tensor parallelism " + _NOT_PORTED)
    dim = dims[0]
    n = int(shape[dim])
    nh, kv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    if path.endswith("attn_qkv/kernel") or path.endswith("attn_qkv/bias"):
        if n != (nh + 2 * kv) * hd:
            raise ValueError(f"'{path}' of {tuple(shape)}: {n} columns, "
                             f"expected {(nh + 2 * kv) * hd}")
        a, b, ka, kb = head_split(nh, kv, rank, size)
        # kv heads [ka, ks) are also the rank below's (its last one)
        ks = ka
        if rank > 0 and head_split(nh, kv, rank - 1, size)[3] > ka:
            ks = ka + 1
        ql, kl = (b - a) * hd, (kb - ka) * hd
        segs, shared = [(0, a * hd, ql)], [False]
        for base, lo in ((nh * hd, ql), ((nh + kv) * hd, ql + kl)):
            sh = (ks - ka) * hd
            segs += [(lo, base + ka * hd, sh),
                     (lo + sh, base + ks * hd, kl - sh)]
            shared += [True, False]
        keep = [i for i, sg in enumerate(segs) if sg[2] > 0]
        shared = tuple(shared[i] for i in keep)
        return TPShard(dim, tuple(segs[i] for i in keep), ql + 2 * kl, n,
                       shared if any(shared) else ())
    if path.endswith("attn_proj/kernel") and n == nh * hd:
        a, b, _, _ = head_split(nh, kv, rank, size)
        return TPShard(dim, ((0, a * hd, (b - a) * hd),), (b - a) * hd, n)
    if _vocab_dim(path) == dim:
        c = -(-n // size)
        lo = min(rank * c, n)
        return TPShard(dim, ((0, lo, min(c, n - lo)),), c, n)
    if n % size:
        raise NotImplementedError(
            f"'{path}' of {tuple(shape)}: dim {dim} of {n} does not split "
            f"over {size} model ranks " + _NOT_PORTED)
    c = n // size
    return TPShard(dim, ((0, rank * c, c),), c, n)


def shard_tree(params: Dict[str, Any], cfg, ctx: Optional[TPContext],
               rules, prefix: str = "") -> Dict[str, Any]:
    """This rank's shards of a scan-layout parameter tree of full-precision
    leaves: every leaf the rules shard, cut by :func:`tp_shard`, the rest
    as given. Quantized forms are made from the shards afterwards (the
    int8 engine's per-channel scales reduced over the model axis, the
    blockwise serving weights packed a shard at a time)."""
    if ctx is None:
        return params
    out: Dict[str, Any] = {}
    for key, val in params.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out[key] = shard_tree(val, cfg, ctx, rules, path + "/")
            continue
        sh = tp_shard(path, tuple(val.shape), spec_for(path, rules), cfg,
                      ctx.rank, ctx.size)
        out[key] = val if sh is None else sh.take(val).contiguous()
    return out


def tp_assemble(pieces: Sequence[torch.Tensor], maps: Sequence[TPShard]
                ) -> torch.Tensor:
    """The whole leaf from every model rank's shard (``pieces[r]`` under
    ``maps[r]``), their padding dropped."""
    dim = maps[0].dim
    shape = list(pieces[0].shape)
    shape[dim] = maps[0].whole
    out = pieces[0].new_empty(shape)
    for piece, sh in zip(pieces, maps):
        for ls, ws, n in sh.segs:
            if n:
                out.narrow(dim, ws, n).copy_(piece.narrow(dim, ls, n))
    return out
