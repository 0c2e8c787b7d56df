"""Block-sparse flash attention: the tile schedule, the CUDA kernels'
wrappers and their plain versions.

Replaces the Pallas kernels of
``deepspeed_tpu/ops/pallas/block_sparse_attention.py``: the forward
``_fwd_kernel`` (launched by ``_fwd``) and the backward ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel`` (launched by ``_bwd``); entry
``block_sparse_flash_attention`` with its custom VJP ``_bs_flash``.

The layout ([H, S / fine, S / fine] bool, a ``SparsityConfig.make_layout``
output) is a schedule, not a mask: :func:`schedule` coarsens it to the
kernels' 64 x 64 tiles and lists, per (head, query tile), the key tiles
holding a live (q, k) pair, and the transpose for dK / dV, as CSR arrays
with one flag word per listed tile (see ``csrc/block_sparse_attention.cu``).
Tiles that causal masking or the window leave empty are not listed. The
schedule and its device tensors are built once per (layout bytes, S,
options, device) and cached.

* :func:`block_sparse_flash_attention` — o, differentiable: a
  ``torch.autograd.Function`` whose forward is
  :func:`block_sparse_attention_fwd` and whose backward computes delta =
  rowsum(dO * O) (a plain torch op, as in the JAX package) and calls
  :func:`block_sparse_attention_bwd_dq` and
  :func:`block_sparse_attention_bwd_dkv`.
* Each of those three wrappers launches its CUDA kernel for CUDA tensors
  (or raises) and runs its plain version for CPU tensors:
  :func:`block_sparse_attention_reference` (o, lse) and
  :func:`block_sparse_attention_bwd_reference` (dq, dk, dv).
* :func:`tileable` — the shape check the kernels make, as a pure function:
  routers that fall back call it first and never wrap a launch in ``try``.
* :func:`fwd_route`, :func:`dq_route`, :func:`dkv_route` — which form of
  each kernel a call takes, pure functions of the head dim and dtype.
* :meth:`Schedule.cta_slots` — the persistent kernels' per-CTA item lists,
  balanced on the host.

Semantics: the fine layout applies per element (``layout[h, q // fine, k
// fine]``), then causal (key <= query, S = Sk) and the window (query - key
< window). ``layout_exact=False`` (the sliding-window route, whose layout
the window itself defines) skips the layout lookup inside a listed tile;
the layout must then hold every block pair that causal and the window
leave live (``ValueError`` otherwise), so both settings compute the same.
A query row with no live key gives zeros and zero gradients; the TPU kernel
gives such a row the mean of V over the keys its tiles visited when its
list is not empty (ROADMAP.md, Queue 3, documented divergences).

Bound on the card: operations at the train leg's shape (see the CUDA
source).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import build
from .attention import (KERNEL_DTYPES, NEG_INF, head_dim_reason,
                        masked_logits)

__all__ = ["block_sparse_flash_attention", "block_sparse_attention_fwd",
           "block_sparse_attention_bwd_dq", "block_sparse_attention_bwd_dkv",
           "block_sparse_attention_reference",
           "block_sparse_attention_bwd_reference", "schedule", "tileable",
           "fwd_route", "dq_route", "dkv_route", "coarse_layout",
           "active_lists", "TILE"]

TILE = 64                                   # the kernels' q and k tile
LAYOUT_BIT, POS_BIT = 1, 2                  # csrc/block_sparse_attention.cu
WIDE_FROM = 256                             # wider heads: the wide kernels


def dkv_route(D: int, dtype: torch.dtype) -> str:
    """Which form of the dK/dV kernel of ``csrc/block_sparse_attention.cu``
    a call takes: ``"wgmma"`` (bf16 / fp16 at D 64, the long leg's call:
    persistent, TMA-fed, on ``wgmma``: ``bs_dkv_wg``), ``"mma"`` (the
    other 16-bit widths up to 256, ``mma.sync``), ``"f32"`` (CUDA cores) or
    ``"wide"`` (above 256: the output columns split over CTAs)."""
    if D > WIDE_FROM:
        return "wide"
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if D == 64 else "mma"


def fwd_route(D: int, dtype: torch.dtype) -> str:
    """The forward kernel's form, by :func:`dkv_route`'s rule: ``"wgmma"``
    is ``bs_fwd_wg`` (persistent over the host's (head, query tile)
    items), ``"mma"`` ``bs_fwd_mma``."""
    return dkv_route(D, dtype)


def dq_route(D: int, dtype: torch.dtype) -> str:
    """The dQ kernel's form, by :func:`dkv_route`'s rule: ``"wgmma"`` is
    ``bs_dq_wg``, ``"mma"`` ``bs_dq_mma``."""
    return dkv_route(D, dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("block_sparse_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, n_ptr in ((lib.block_sparse_attention_fwd_launch, 13),
                      (lib.block_sparse_attention_bwd_dq_launch, 15),
                      (lib.block_sparse_attention_bwd_dkv_launch, 15)):
        if fn.argtypes is None:
            fn.argtypes = [P] * n_ptr + [I] * 7 + [F, I, P]
            fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------------ schedule

def tileable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             fine_block: int, layout=None) -> Optional[str]:
    """None if the kernels take these inputs (and ``layout``'s shape, when
    given), else why not. A pure function of the shapes and dtypes, the
    same on every device."""
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        return (f"q, k, v must be [B, H, S, D] of one shape, got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    reason = head_dim_reason(D)
    if reason is not None:
        return reason
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return (f"dtypes {q.dtype}, {k.dtype}, {v.dtype} (the kernels take "
                "float32, bfloat16 or float16, all alike)")
    if fine_block <= 0 or fine_block % 8 or S % fine_block:
        return (f"S={S} with layout block {fine_block} (the block must be a "
                "multiple of 8 that divides S)")
    nf = S // fine_block
    if layout is not None and tuple(np.shape(layout)) != (H, nf, nf):
        return (f"layout shape {tuple(np.shape(layout))} != {(H, nf, nf)} "
                f"for S={S}, block {fine_block}")
    if -(-S // TILE) > 65535:
        return f"S={S}: more than 65535 tiles of {TILE}"
    return None


def _overlap(S: int, block: int, tile: int) -> np.ndarray:
    """[ceil(S / tile), S // block] bool: tile t covers some position of
    layout block f."""
    pos = np.arange(S)
    m = np.zeros((-(-S // tile), S // block), dtype=bool)
    m[pos // tile, pos // block] = True
    return m


def coarse_layout(layout: np.ndarray, fine_block: int, S: int,
                  tile_q: int = TILE, tile_k: int = TILE) -> np.ndarray:
    """[H, nQ, nK] bool: query tile i and key tile j (of tile_q / tile_k
    positions) hold a live pair of the fine layout."""
    mq = _overlap(S, fine_block, tile_q).astype(np.float32)
    mk = _overlap(S, fine_block, tile_k).astype(np.float32)
    lay = np.asarray(layout, dtype=np.float32)
    return np.einsum("if,hfg,jg->hij", mq, lay, mk, optimize=True) > 0


def active_lists(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of a [H, n, m] bool tile mask: (ptr [H * n + 1], idx) int32, the
    listed columns of each (head, row) in ascending order."""
    H, n, m = mask.shape
    rows = mask.reshape(H * n, m)
    ptr = np.zeros(H * n + 1, np.int32)
    np.cumsum(rows.sum(1), out=ptr[1:])
    idx = np.nonzero(rows)[1].astype(np.int32)
    return ptr, idx


# the persistent kernels' CTAs an SM (their grids: csrc/
# block_sparse_attention.cu, launch_dkv_wg and launch_q_wg), and what
# taking up an item costs each beside its tiles (the own tiles' load, the
# epilogue), in tiles. The forward's and dq's were measured by
# ``chip_smoke.py --sweep-item-cost`` at the long leg's call, costs 0 to
# 8, in two runs: each kernel's readings spread 3.5-3.8% over all costs
# with no trend, about twice the spread of repeats at one cost (PERF.md,
# PR 9), so 1 is kept; the lists' costliest CTA held 79 tiles at every
# cost. "q": the query side's
# (head, query tile) items of the forward and dq; "k": dk/dv's (head, key
# tile) items
CTAS_PER_SM = 2
ITEM_COST = {"q": 1, "k": 3}


def balance(costs: np.ndarray, slots: int) -> Tuple[np.ndarray, np.ndarray]:
    """Longest-processing-time-first assignment of items to ``slots``
    workers: each item, costliest first, goes to the least-loaded worker
    (the lowest index on a tie). Returns CSR (ptr [slots + 1], items) int32:
    worker w takes items[ptr[w]:ptr[w + 1]], costliest first. The makespan
    is within 4/3 of the best."""
    import heapq
    order = np.argsort(-np.asarray(costs), kind="stable")
    heap = [(0, w) for w in range(slots)]
    owner = np.empty(len(order), np.int64)
    for item in order:
        load, w = heapq.heappop(heap)
        owner[item] = w
        heapq.heappush(heap, (load + int(costs[item]), w))
    by_worker = np.argsort(owner[order], kind="stable")
    items = order[by_worker].astype(np.int32)
    ptr = np.zeros(slots + 1, np.int32)
    np.cumsum(np.bincount(owner, minlength=slots), out=ptr[1:])
    return ptr, items


def fine_bits(layout: np.ndarray, fine_block: int, S: int, h: np.ndarray,
              qt: np.ndarray, kt: np.ndarray) -> np.ndarray:
    """[n, 2] int32: the fine layout over each listed tile (head h, query
    tile qt, key tile kt) at 8 x 8 granularity, 64 bits, low word first:
    bit 8 rg + kg is ``layout[h, (64 qt + 8 rg) // fine, (64 kt + 8 kg) //
    fine]``, positions past S taken at S - 1 (the ragged edge is masked by
    position). A fine block is a multiple of 8, so each 8 x 8 group lies in
    one block: the wgmma forward and dq mask a tile from this word alone
    (``mask_bits`` in the CUDA source)."""
    g = np.arange(0, TILE, 8)
    out = np.empty((len(h), 8), np.uint8)
    for c0 in range(0, len(h), 1 << 16):          # bounded temporaries
        sl = slice(c0, c0 + (1 << 16))
        rows = np.minimum(qt[sl, None] * TILE + g, S - 1) // fine_block
        cols = np.minimum(kt[sl, None] * TILE + g, S - 1) // fine_block
        live = layout[h[sl, None, None], rows[:, :, None], cols[:, None, :]]
        out[sl] = np.packbits(live.reshape(-1, 64), axis=1,
                              bitorder="little")
    return out.view("<i4").reshape(-1, 2)


def longest_first(mask: np.ndarray) -> np.ndarray:
    """[H * n] int32: each head's rows of a [H, n, m] tile mask ordered by
    descending list length (ties in row order), the kernels' launch
    order."""
    counts = mask.sum(2)
    return np.argsort(-counts, axis=1, kind="stable").astype(
        np.int32).reshape(-1)


@dataclasses.dataclass
class Schedule:
    """A layout's tile lists on one device, and the options they encode."""
    H: int
    S: int
    fine: int
    causal: bool
    window: int
    layout_exact: bool
    layout: np.ndarray                # [H, nf, nf] bool
    visited: np.ndarray               # [H, nT, nT] bool: the listed tiles
    flags: np.ndarray                 # [H, nT, nT] int32
    dev: Dict[str, Optional[torch.Tensor]]

    @property
    def n_tiles(self) -> int:
        return int(self.visited.sum())

    def item_costs(self, side: str) -> np.ndarray:
        """[H * nT] int: what each item of a persistent kernel costs a CTA,
        in tiles: its list length plus ITEM_COST[side]. side "q": the
        (head, query tile) items of the forward and dq, over their key
        tiles; "k": the (head, key tile) items of dk/dv, over their query
        tiles."""
        lengths = self.visited.sum(2 if side == "q" else 1)
        return lengths.reshape(-1) + ITEM_COST[side]

    def cta_slots(self, side: str, sms: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ptr, items) int32 on the schedule's device: the items (h * nT
        + t) of one ``side``'s persistent kernels' CTAs on a card of
        ``sms`` SMs, balanced by :func:`balance` over :meth:`item_costs`;
        cached."""
        key = f"slots_{side}_{sms}_{ITEM_COST[side]}"
        if key not in self.dev:
            ptr, items = balance(self.item_costs(side), CTAS_PER_SM * sms)
            dev = self.dev["k_ptr"].device
            self.dev[key] = (torch.as_tensor(ptr, device=dev),
                             torch.as_tensor(items, device=dev))
        return self.dev[key]

    def keep(self, device) -> torch.Tensor:
        """[H, S, S] bool: the live (q, k) entries, from the fine layout,
        causal and the window alone (not from the tile lists)."""
        from .sparse_attention import layout_to_dense_mask
        S = self.S
        keep = layout_to_dense_mask(self.layout, self.fine, device=device)
        qp = torch.arange(S, device=device)[:, None]
        kp = torch.arange(S, device=device)[None, :]
        if self.causal:
            keep = keep & (kp <= qp)
        if self.window:
            keep = keep & (qp - kp < self.window)
        return keep


_SCHEDULES: Dict[tuple, Schedule] = {}


def _band(nf: int, fine: int, causal: bool, window: int) -> np.ndarray:
    """[nf, nf] bool: layout block pair (i, j) holds a (q, k) pair that
    causal (k <= q) and the window (q - k < window) leave live."""
    i, j = np.indices((nf, nf))
    live = np.ones((nf, nf), dtype=bool)
    if causal:
        live &= (i - j) * fine + fine - 1 >= 0        # the largest q - k
    if window:
        live &= (i - j) * fine - fine + 1 < window    # the smallest q - k
    return live


def schedule(layout, fine_block: int, S: int, *, causal: bool = False,
             window: int = 0, layout_exact: bool = True,
             device=None) -> Schedule:
    """The cached tile schedule of ``layout`` at sequence length S.

    Per pair of 64-row tiles (i queries, j keys): listed when the coarsened
    layout holds a pair there and causal / the window leave one; its flag
    has LAYOUT_BIT when ``layout_exact`` and the layout does not cover the
    whole tile, POS_BIT when causal, the window or the ragged edge (S not a
    multiple of 64) masks part of it. Device tensors: ``q_ptr``, ``q_idx``,
    ``q_flags``, ``q_order`` (query-tile lists, and each head's query tiles
    longest list first: the launch order), ``q_bits`` (each listed tile's
    :func:`fine_bits` where its flag has LAYOUT_BIT, else all ones: the
    wgmma forward's and dq's mask), ``k_ptr``, ``k_idx``,
    ``k_flags``, ``k_order`` (their transpose) int32, and ``layout`` uint8
    (None unless layout_exact)."""
    window = int(window) if window and window > 0 else 0
    device = torch.device(device if device is not None else "cpu")
    lay = np.asarray(layout, dtype=bool)
    key = (lay.shape, hashlib.blake2b(np.packbits(lay).tobytes()).digest(),
           int(fine_block), int(S), bool(causal), window, bool(layout_exact),
           str(device))
    hit = _SCHEDULES.get(key)
    if hit is not None:
        return hit
    if not layout_exact and (_band(lay.shape[1], fine_block, causal, window)
                             & ~lay).any():
        raise ValueError("layout_exact=False needs a layout that holds every "
                         "block pair causal and the window leave live")
    H, T = lay.shape[0], TILE
    vis = coarse_layout(lay, fine_block, S)
    nT = vis.shape[1]
    first = np.arange(nT) * T
    last = np.minimum(first + T, S) - 1
    qf, ql = first[:, None], last[:, None]
    kf, kl = first[None, :], last[None, :]
    pos = (ql - qf + 1 < T) | (kl - kf + 1 < T)     # the ragged edge
    if causal:
        vis = vis & (kf <= ql)[None]
        pos = pos | (kl > qf)
    if window:
        vis = vis & (qf - kl < window)[None]
        pos = pos | (ql - kf >= window)
    flags = np.where(pos, POS_BIT, 0)[None].repeat(H, 0).astype(np.int32)
    if layout_exact:
        holes = coarse_layout(~lay, fine_block, S)     # a dead entry inside
        flags |= np.where(holes, LAYOUT_BIT, 0).astype(np.int32)
    flags = np.where(vis, flags, 0).astype(np.int32)
    vis_t = vis.transpose(0, 2, 1)
    q_lists, k_lists = active_lists(vis), active_lists(vis_t)
    q_flags = flags[vis]
    q_bits = np.full((len(q_flags), 2), -1, np.int32)
    holed = (q_flags & LAYOUT_BIT) != 0
    if holed.any():
        h, qt, kt = (a[holed] for a in np.nonzero(vis))
        q_bits[holed] = fine_bits(lay, fine_block, S, h, qt, kt)
    i32 = dict(dtype=torch.int32, device=device)
    dev = {"q_ptr": torch.as_tensor(q_lists[0], **i32),
           "q_idx": torch.as_tensor(q_lists[1], **i32),
           "q_flags": torch.as_tensor(q_flags, **i32),
           "q_bits": torch.as_tensor(q_bits.reshape(-1), **i32),
           "q_order": torch.as_tensor(longest_first(vis), **i32),
           "k_ptr": torch.as_tensor(k_lists[0], **i32),
           "k_idx": torch.as_tensor(k_lists[1], **i32),
           "k_flags": torch.as_tensor(flags.transpose(0, 2, 1)[vis_t], **i32),
           "k_order": torch.as_tensor(longest_first(vis_t), **i32),
           "layout": (torch.as_tensor(lay.astype(np.uint8), device=device)
                      if layout_exact else None)}
    sched = Schedule(H, int(S), int(fine_block), bool(causal), window,
                     bool(layout_exact), lay, vis, flags, dev)
    if len(_SCHEDULES) >= 64:
        _SCHEDULES.clear()
    _SCHEDULES[key] = sched
    return sched


# ------------------------------------------------------------------ entries

def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))


def _prepare(q, k, v, layout, fine_block, causal, window, layout_exact,
             name):
    reason = tileable(q, k, v, fine_block, layout)
    if reason is not None:
        raise ValueError(f"{name} cannot tile: {reason}")
    return schedule(layout, fine_block, q.shape[2], causal=causal,
                    window=window, layout_exact=layout_exact,
                    device=q.device)


class _BlockSparseAttention(torch.autograd.Function):
    """o = block_sparse_attention_fwd(...)[0]; the backward runs the dq and
    dk/dv wrappers on the saved q, k, v, o and lse (the JAX package's
    ``_bs_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, sched, scale):
        # kept by a remat region that keeps "attn" (see _FlashAttention)
        from .checkpoint_name import reuse
        o, lse = reuse("attn", lambda: _fwd(q, k, v, sched, scale), q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sched, ctx.scale = sched, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, ctx.sched, ctx.scale)
        if q.device.type == "cpu":
            dq, dk, dv = _bwd_reference(*args)
        else:
            dq, (dk, dv) = _dq(*args), _dkv(*args)
        return dq, dk, dv, None, None


def block_sparse_flash_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, layout, fine_block: int, *,
                                 causal: bool = False,
                                 sm_scale: Optional[float] = None,
                                 window: int = 0,
                                 layout_exact: bool = True) -> torch.Tensor:
    """Layout-skipping attention. q, k, v: [B, H, S, D]; layout [H, S /
    fine_block, S / fine_block] bool. Returns o [B, H, S, D], differentiable
    in q, k and v. Raises ``ValueError`` (naming the tile) for inputs the
    kernels do not take (see :func:`tileable`); callers that fall back
    check :func:`tileable` first."""
    sched = _prepare(q, k, v, layout, fine_block, causal, window,
                     layout_exact, "block_sparse_flash_attention")
    scale = _scale(q, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BlockSparseAttention.apply(q, k, v, sched, scale)
    return _fwd(q, k, v, sched, scale)[0]


def block_sparse_attention_fwd(q, k, v, layout, fine_block, *, causal=False,
                               sm_scale=None, window=0, layout_exact=True
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward -> (o [B, H, S, D], lse [B, H, S] f32). CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version."""
    sched = _prepare(q, k, v, layout, fine_block, causal, window,
                     layout_exact, "block_sparse_attention_fwd")
    return _fwd(q, k, v, sched, _scale(q, sm_scale))


def block_sparse_attention_bwd_dq(q, k, v, do, lse, delta, layout,
                                  fine_block, *, causal=False, sm_scale=None,
                                  window=0, layout_exact=True) -> torch.Tensor:
    """dq from q, k, v, dO, the forward's lse and delta = rowsum(dO * O)
    [B, H, S] f32. CUDA tensors launch the kernel (or raise); CPU tensors
    run the plain version."""
    sched = _prepare(q, k, v, layout, fine_block, causal, window,
                     layout_exact, "block_sparse_attention_bwd_dq")
    return _dq(q, k, v, do, lse, delta, sched, _scale(q, sm_scale))


def block_sparse_attention_bwd_dkv(q, k, v, do, lse, delta, layout,
                                   fine_block, *, causal=False, sm_scale=None,
                                   window=0, layout_exact=True
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), same inputs as :func:`block_sparse_attention_bwd_dq`."""
    sched = _prepare(q, k, v, layout, fine_block, causal, window,
                     layout_exact, "block_sparse_attention_bwd_dkv")
    return _dkv(q, k, v, do, lse, delta, sched, _scale(q, sm_scale))


block_sparse_attention_fwd.launches = 0
block_sparse_attention_bwd_dq.launches = 0
block_sparse_attention_bwd_dkv.launches = 0


# ------------------------------------------------------------------ launches

def _cuda_operands(sched, *ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"block-sparse attention kernels need CUDA tensors, "
                         f"got {dev}")
    if any(t.device != dev for t in ts):
        raise ValueError("block-sparse attention: inputs on different devices")
    if sched.dev["q_ptr"].device != dev:
        raise ValueError("block-sparse attention: schedule built for "
                         f"{sched.dev['q_ptr'].device}, inputs on {dev}")
    ts = [t.contiguous() for t in ts]
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("block-sparse attention kernels: inputs must be "
                         "16-byte aligned")
    return ts


def _ints(q, sched):
    B, H, S, D = q.shape
    return (B * H, H, S, D, sched.fine, int(sched.causal), sched.window)


def _tail(q, scale):
    return (float(scale), KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd(q, k, v, sched, scale):
    if q.device.type == "cpu":
        return _reference(q, k, v, sched, scale)
    q, k, v = _cuda_operands(sched, q, k, v)
    d = sched.dev
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    cta_ptr, cta_items = sched.cta_slots("q", build.sm_count(q.device))
    lib = _lib()
    build.count_launch(block_sparse_attention_fwd)
    err = lib.block_sparse_attention_fwd_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(d["layout"]), _ptr(d["q_ptr"]),
        _ptr(d["q_idx"]), _ptr(d["q_flags"]), _ptr(d["q_order"]),
        _ptr(cta_ptr), _ptr(cta_items), _ptr(d["q_bits"]), _ptr(o),
        _ptr(lse),
        *_ints(q, sched), *_tail(q, scale))
    build.check(lib, "block_sparse_attention", err)
    return o, lse


def _bwd_operands(q, k, v, do, lse, delta, sched):
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"block-sparse attention backward: dO "
                         f"{tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != tuple(q.shape[:3]) or t.dtype != torch.float32:
            raise ValueError(f"block-sparse attention backward: {name} must "
                             f"be [B, H, S] float32, got {tuple(t.shape)} "
                             f"{t.dtype}")
    return _cuda_operands(sched, q, k, v, do, lse, delta)


def _dq(q, k, v, do, lse, delta, sched, scale):
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, do, lse, delta, sched, scale)[0]
    q, k, v, do, lse, delta = _bwd_operands(q, k, v, do, lse, delta, sched)
    d = sched.dev
    dq = torch.empty_like(q)
    cta_ptr, cta_items = sched.cta_slots("q", build.sm_count(q.device))
    lib = _lib()
    build.count_launch(block_sparse_attention_bwd_dq)
    err = lib.block_sparse_attention_bwd_dq_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
        _ptr(d["layout"]), _ptr(d["q_ptr"]), _ptr(d["q_idx"]),
        _ptr(d["q_flags"]), _ptr(d["q_order"]), _ptr(cta_ptr),
        _ptr(cta_items), _ptr(d["q_bits"]), _ptr(dq), *_ints(q, sched),
        *_tail(q, scale))
    build.check(lib, "block_sparse_attention", err)
    return dq


def _dkv(q, k, v, do, lse, delta, sched, scale):
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, do, lse, delta, sched, scale)[1:]
    q, k, v, do, lse, delta = _bwd_operands(q, k, v, do, lse, delta, sched)
    d = sched.dev
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    cta_ptr, cta_items = sched.cta_slots("k", build.sm_count(q.device))
    lib = _lib()
    build.count_launch(block_sparse_attention_bwd_dkv)
    err = lib.block_sparse_attention_bwd_dkv_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
        _ptr(d["layout"]), _ptr(d["k_ptr"]), _ptr(d["k_idx"]),
        _ptr(d["k_flags"]), _ptr(d["k_order"]), _ptr(cta_ptr),
        _ptr(cta_items), _ptr(dk), _ptr(dv),
        *_ints(q, sched), *_tail(q, scale))
    build.check(lib, "block_sparse_attention", err)
    return dk, dv


# ------------------------------------------------------------ plain versions

def _logits(q, k, sched, scale):
    """f32 logits of q k^T with -1e30 off the kernels' live entries, and
    the [H, S] live-row mask."""
    keep = sched.keep(q.device)
    s = masked_logits(q, k, causal=False, mask=keep[None], sm_scale=scale)
    return s, keep.any(-1)


def _reference(q, k, v, sched, scale):
    s, live = _logits(q, k, sched, scale)
    lse = torch.where(live, torch.logsumexp(s, dim=-1),
                      torch.tensor(NEG_INF, device=s.device))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", probs.to(ct), v.to(ct))
    o = torch.where(live[..., None], o, torch.zeros((), dtype=o.dtype,
                                                    device=o.device))
    return o.to(q.dtype), lse


def _bwd_reference(q, k, v, do, lse, delta, sched, scale):
    s, _ = _logits(q, k, sched, scale)
    f32 = torch.float32
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - lse.to(f32)[..., None]),
                    torch.zeros((), dtype=f32, device=s.device))
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.to(f32)[..., None]) * scale
    pr = p.to(v.dtype).to(f32)                      # P, dS in the value dtype
    dsr = ds.to(q.dtype).to(f32)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsr, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", pr, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def block_sparse_attention_reference(q, k, v, layout, fine_block, *,
                                     causal=False, sm_scale=None, window=0,
                                     layout_exact=True
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward -> (o, lse): f32 logits (:func:`masked_logits`)
    with -1e30 off the dense layout, causal and window mask, an f32
    softmax, P cast to q's dtype before P V; lse the logsumexp of the
    logits. A row with no live key gives o = 0 and lse = -1e30."""
    sched = schedule(layout, fine_block, q.shape[2], causal=causal,
                     window=window, layout_exact=layout_exact,
                     device=q.device)
    return _reference(q, k, v, sched, _scale(q, sm_scale))


def block_sparse_attention_bwd_reference(q, k, v, do, lse, delta, layout,
                                         fine_block, *, causal=False,
                                         sm_scale=None, window=0,
                                         layout_exact=True
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """Plain PyTorch backward -> (dq, dk, dv): the TPU kernels' formula on
    the same masked f32 logits s: p = exp(s - lse), exactly 0 off the mask
    (a row with no live key gets zero gradients), dp = dO V^T, dS = p (dp -
    delta) sm_scale, P and dS rounded to the value dtype before dV = P^T
    dO, dK = dS^T Q, dQ = dS K; products summed in f32."""
    sched = schedule(layout, fine_block, q.shape[2], causal=causal,
                     window=window, layout_exact=layout_exact,
                     device=q.device)
    return _bwd_reference(q, k, v, do, lse, delta, sched, _scale(q, sm_scale))
