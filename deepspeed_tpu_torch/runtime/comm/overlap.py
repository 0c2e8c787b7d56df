"""Chunked overlap schedules: the chunked all-gather -> matmul and the
chunked gradient reduce-scatter (counterpart of
``deepspeed_tpu/runtime/comm/overlap.py``; T3 / ZeRO++ style), the comm
plan's ``overlap`` / ``overlap_int8`` algorithms.

They replace two whole-tensor collectives: the ZeRO-3 parameter gather
(:func:`make_overlap_gather`) and the ZeRO-2 gradient sync
(:func:`overlap_grad_sync`). Each splits its payload into ``chunks``
pieces and issues one chunk-sized collective a piece. Here "overlap"
means that every chunk's collective is posted with ``async_op=True``
(``comm.all_gather_async`` / ``comm.all_to_all_async``) and waited on
only where its result is used: the next chunks' transfers fly while a
landed chunk is reduced or assembled.

``overlap`` moves exact f32 chunks; ``overlap_int8`` quantizes each chunk
on its own (``quantized.py``'s blockwise int8), its scales riding with
it, so a chunk is complete on arrival. The segment bounds and each hop's
padding are the JAX package's, so the int8 bytes agree.

The gather's backward is its transpose: the gradient reduce-scattered in
the same chunks (:func:`chunked_reduce_scatter`), exact for both
algorithms (straight-through past the quantizer).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ...comm import comm
from ...quant_format import block_dequant, block_quant
from .quantized import DEFAULT_BLOCK, _chunks, _reduce

#: default pieces a collective is cut into
DEFAULT_CHUNKS = 4

OVERLAP_ALGOS = ("overlap", "overlap_int8")


def effective_chunks(length: int, chunks: int) -> int:
    """Largest c <= chunks that divides ``length`` (>= 1): chunk edges
    are equal, so every chunk is the same collective shape."""
    c = max(1, min(int(chunks), int(length)))
    while length % c:
        c -= 1
    return c


def _segment_bounds(length: int, chunks: int) -> List[Tuple[int, int]]:
    """[lo, hi) bounds cutting ``length`` into ``chunks`` nearly equal
    contiguous segments (flat-buffer chunking: segments need not be
    equal, each hop pads itself)."""
    ch = max(1, min(int(chunks), int(length)))
    base, rem = divmod(length, ch)
    bounds, lo = [], 0
    for k in range(ch):
        hi = lo + base + (1 if k < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _check(algo: str, what: str) -> None:
    if algo not in OVERLAP_ALGOS:
        raise ValueError(f"{what} algo {algo!r}: expected "
                         f"{'|'.join(OVERLAP_ALGOS)}")


# ---------------------------------------------------------------------------
# posted hops: post() starts the transfers, the returned callable waits
# for them and finishes the hop
# ---------------------------------------------------------------------------

def _post_rs(seg: torch.Tensor, axis, n: int, *, algo: str, bits: int,
             block: int, mean: bool):
    """A reduce-scatter hop of one flat segment (``quantized.py``'s
    ``rs_*_local`` contract), posted; the callable returns the served
    chunk."""
    if algo == "overlap_int8":
        chunks, _ = _chunks(seg, n, block)
        q, scales, _ = block_quant(chunks, bits, block)
        hq = comm.all_to_all_async(q, axis=axis)
        hs = comm.all_to_all_async(scales, axis=axis)
        return lambda: _reduce(block_dequant(hq.wait(), hs.wait(), 0), mean)
    chunks, _ = _chunks(seg, n)
    h = comm.all_to_all_async(chunks, axis=axis)
    return lambda: _reduce(h.wait(), mean)


def _post_ag(flat: torch.Tensor, axis, *, algo: str, bits: int,
             block: int):
    """An all-gather hop of one flat chunk, posted; the callable returns
    the ranks' chunks stacked [n, len] (int8: dequantized)."""
    if algo == "overlap_int8":
        q, scales, pad = block_quant(flat, bits, block)
        hq = comm.all_gather_async(q, axis=axis, tiled=False)
        hs = comm.all_gather_async(scales, axis=axis, tiled=False)
        return lambda: block_dequant(hq.wait(), hs.wait(), pad)
    h = comm.all_gather_async(flat, axis=axis, tiled=False)
    return h.wait


# ---------------------------------------------------------------------------
# chunked grad sync (the ZeRO-2 seam)
# ---------------------------------------------------------------------------

def overlap_grad_sync(x: torch.Tensor, *, axis="data",
                      chunks: int = DEFAULT_CHUNKS, algo: str = "overlap",
                      bits: int = 8, block: int = DEFAULT_BLOCK,
                      mean: bool = True) -> torch.Tensor:
    """``grad_sync``'s contract (this rank's gradient in, the reduced one
    in its shape out) with the flat buffer cut by :func:`_segment_bounds`
    into ``chunks`` segments, each with its own reduce-scatter and
    all-gather hop. Every segment's reduce-scatter is posted first; each
    is waited on, reduced and its all-gather posted in turn; the gathers
    are waited on as the result is assembled.

    ``algo``: ``"overlap"`` (exact f32 chunks) or ``"overlap_int8"``
    (each chunk blockwise int8, its scales with it)."""
    _check(algo, "overlap_grad_sync")
    n = comm.axis_size(axis)
    flat = x.reshape(-1).to(torch.float32)
    bounds = _segment_bounds(flat.numel(), chunks)
    rs = [_post_rs(flat[lo:hi], axis, n, algo=algo, bits=bits, block=block,
                   mean=mean) for lo, hi in bounds]
    ag = [_post_ag(served(), axis, algo=algo, bits=bits, block=block)
          for served in rs]
    outs = [done().reshape(-1)[:hi - lo]
            for done, (lo, hi) in zip(ag, bounds)]
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked param gather (the ZeRO-3 seam) and its transpose
# ---------------------------------------------------------------------------

def chunked_gather(shard: torch.Tensor, axis, dim: int, *,
                   chunks: int = DEFAULT_CHUNKS, algo: str = "overlap",
                   bits: int = 8, block: int = DEFAULT_BLOCK
                   ) -> torch.Tensor:
    """The whole tensor along ``dim`` from this rank's ``shard``, as
    :func:`effective_chunks` chunk-sized all-gathers of the shard's
    pieces along ``dim`` (every one posted before the first is waited
    on), reassembled in rank-major order. ``overlap_int8`` quantizes each
    piece blockwise on its flattened payload."""
    _check(algo, "chunked_gather")
    n = comm.axis_size(axis)
    local = shard.shape[dim]
    ch = effective_chunks(local, chunks)
    step = local // ch
    posted = []
    for k in range(ch):
        c = shard.narrow(dim, k * step, step).contiguous()
        if algo == "overlap_int8":
            posted.append((_post_ag(c.reshape(-1), axis, algo=algo,
                                    bits=bits, block=block), c.shape))
        else:
            h = comm.all_gather_async(c, axis=axis, tiled=False)
            posted.append((h.wait, c.shape))
    parts = [done().reshape((n,) + tuple(shape)) for done, shape in posted]
    g = torch.cat(parts, dim=1 + dim) if ch > 1 else parts[0]
    g = g.movedim(0, dim)                     # [..., n, local, ...]
    shape = list(shard.shape)
    shape[dim] = n * local
    return g.reshape(shape).to(shard.dtype)


def chunked_reduce_scatter(full: torch.Tensor, axis, dim: int, *,
                           chunks: int = DEFAULT_CHUNKS) -> torch.Tensor:
    """This rank's slab along ``dim`` of the group's sum of ``full``, in
    the chunks of :func:`chunked_gather` (its transpose): chunk k of
    every rank's slab is one reduce-scatter. Exact, element for element
    the whole-tensor reduce-scatter's sum."""
    n = comm.axis_size(axis)
    local = full.shape[dim] // n
    ch = effective_chunks(local, chunks)
    step = local // ch
    outs = []
    for k in range(ch):
        piece = torch.cat([full.narrow(dim, r * local + k * step, step)
                           for r in range(n)], dim=dim)
        outs.append(comm.reduce_scatter(piece.contiguous(), axis=axis,
                                        scatter_dim=dim))
    return torch.cat(outs, dim=dim) if ch > 1 else outs[0]


class _OverlapGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, axis, dim, chunks, algo, bits, block):
        ctx.args = (axis, dim, chunks)
        return chunked_gather(shard, axis, dim, chunks=chunks, algo=algo,
                              bits=bits, block=block)

    @staticmethod
    def backward(ctx, g):
        axis, dim, chunks = ctx.args
        gs = chunked_reduce_scatter(g.to(torch.float32), axis, dim,
                                    chunks=chunks).to(g.dtype)
        return gs, None, None, None, None, None, None


def make_overlap_gather(axis, dim: int, *, chunks: int = DEFAULT_CHUNKS,
                        algo: str = "overlap", bits: int = 8,
                        block: int = DEFAULT_BLOCK):
    """The chunked explicit all-gather of one ZeRO-3 leaf sharded on
    ``dim`` over ``axis``: ``f(shard)`` -> the whole leaf
    (:func:`chunked_gather`); its backward reduce-scatters the gradient
    in the same chunks (:func:`chunked_reduce_scatter`, in f32), so
    neither direction issues a whole-tensor collective."""
    _check(algo, "make_overlap_gather")

    def gather(shard: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and shard.requires_grad:
            return _OverlapGather.apply(shard, axis, dim, chunks, algo, bits,
                                        block)
        return chunked_gather(shard, axis, dim, chunks=chunks, algo=algo,
                              bits=bits, block=block)

    return gather


# ---------------------------------------------------------------------------
# benchmark pipelines (the comm benchmark's overlap cells)
# ---------------------------------------------------------------------------

def chunked_ag_matmul(x: torch.Tensor, w: torch.Tensor, *, axis,
                      chunks: int = DEFAULT_CHUNKS, algo: str = "overlap",
                      bits: int = 8, block: int = DEFAULT_BLOCK
                      ) -> torch.Tensor:
    """The T3 all-gather -> matmul pipeline: ``w`` this rank's rows [S, C]
    of a [n S, C] weight, ``x`` [B, n S] the same on every rank; returns
    ``x @ W`` as ``sum_k x[:, rows_k] @ all_gather(w_k)``, chunk k+1's
    gather in flight while chunk k multiplies."""
    _check(algo, "chunked_ag_matmul")
    n = comm.axis_size(axis)
    S = w.shape[0]
    ch = effective_chunks(S, chunks)
    step = S // ch
    cols = [torch.as_tensor(np.concatenate(
        [np.arange(r * S + k * step, r * S + (k + 1) * step)
         for r in range(n)]), device=x.device) for k in range(ch)]
    posted = [_post_ag(w[k * step:(k + 1) * step].reshape(-1), axis,
                       algo=algo if algo == "overlap_int8" else "overlap",
                       bits=bits, block=block) for k in range(ch)]
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(ch):
        wk = posted[k]().reshape(-1, w.shape[1])          # [n * step, C]
        xk = x.index_select(1, cols[k])
        acc = acc + xk.to(torch.float32) @ wk.to(torch.float32)
    return acc.to(x.dtype)


def chunked_rs(g: torch.Tensor, *, axis, chunks: int = DEFAULT_CHUNKS,
               algo: str = "overlap", bits: int = 8,
               block: int = DEFAULT_BLOCK, mean: bool = True
               ) -> torch.Tensor:
    """Chunked reduce-scatter of this rank's precomputed flat buffer
    [L]: the comm-only half of :func:`chunked_matmul_rs`. Returns this
    rank's served chunks, concatenated in chunk order (each padded by its
    hop)."""
    _check(algo, "chunked_rs")
    n = comm.axis_size(axis)
    flat = g.reshape(-1).to(torch.float32)
    posted = [_post_rs(flat[lo:hi], axis, n, algo=algo, bits=bits,
                       block=block, mean=mean)
              for lo, hi in _segment_bounds(flat.numel(), chunks)]
    outs = [done() for done in posted]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def chunked_matmul_rs(u: torch.Tensor, v: torch.Tensor, *, axis,
                      chunks: int = DEFAULT_CHUNKS, algo: str = "overlap",
                      bits: int = 8, block: int = DEFAULT_BLOCK,
                      mean: bool = True) -> torch.Tensor:
    """The gradient-producing side: chunk k's segment ``u @ v[:, seg_k]``
    (``u`` this rank's [B], ``v`` [B, L]) is computed and its
    reduce-scatter posted at once, before the next segment's matmul.
    Returns this rank's served chunks in chunk order."""
    _check(algo, "chunked_matmul_rs")
    n = comm.axis_size(axis)
    uf = u.to(torch.float32)
    posted = [_post_rs(uf @ v[:, lo:hi].to(torch.float32), axis, n,
                       algo=algo, bits=bits, block=block, mean=mean)
              for lo, hi in _segment_bounds(v.shape[1], chunks)]
    outs = [done() for done in posted]
    return torch.cat(outs) if len(outs) > 1 else outs[0]
