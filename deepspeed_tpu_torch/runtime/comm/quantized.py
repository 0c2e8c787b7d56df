"""Blockwise-scaled int8 collectives: the quantized reduce-scatter and
all-to-all (counterpart of ``deepspeed_tpu/runtime/comm/quantized.py``;
ZeRO++ qgZ / EQuARX style, the wire-hot siblings of ``compressed.py``'s
allreduce family).

Two sites carry most of the bytes at scale: the ZeRO-2 gradient sync (a
reduce-scatter of every gradient leaf over the data ranks) and the MoE
expert dispatch / combine (an all-to-all of the token queues over the
``expert`` group). Both get an int8 wire format here: values are
quantized in fixed-size blocks with one f32 scale a block
(``quant_format.block_quant``), the int8 payload and the small scale
tensor each cross in a collective of their own, and receivers dequantize:
about 4x fewer bytes than f32 and 2x fewer than bf16 (docs/COMM.md: the
error is at most block_absmax / 127 an element). They keep no state (no
error feedback): the grad sync runs under the comm plan's accuracy
guard, and the dispatch's error is bounded per block.

Where the JAX package runs a ``shard_map`` body over a stacked [n, ...]
global array, each function here takes THIS rank's local tensor and
runs the same body over the process group of ``axis`` through the
counted facade (``comm.comm``: NCCL for CUDA tensors, gloo for an
explicit CPU group). The flat layout, the padding to whole blocks and
the block grid are the JAX package's, so the int8 bytes agree.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ...comm import comm
from ...quant_format import QUANT_BLOCK, block_dequant, block_quant

#: the wire format's block granularity: the shared format's
DEFAULT_BLOCK = QUANT_BLOCK

__all__ = ["DEFAULT_BLOCK", "block_quant", "block_dequant",
           "rs_quantized_local", "rs_exact_local", "ag_quantized_local",
           "a2a_quantized_local", "quantized_reduce_scatter", "grad_sync",
           "quantized_all_to_all", "make_queue_exchange"]


def _chunks(x_flat: torch.Tensor, n: int, multiple: int = 1
            ) -> Tuple[torch.Tensor, int]:
    """Flat f32 ``x_flat`` zero-padded and cut into [n, c] rows, c a
    multiple of ``multiple``."""
    c = -(-x_flat.numel() // n)
    c = -(-c // multiple) * multiple
    pad = n * c - x_flat.numel()
    return F.pad(x_flat.to(torch.float32), (0, pad)).reshape(n, c), pad


def _reduce(recv: torch.Tensor, mean: bool) -> torch.Tensor:
    return recv.mean(dim=0) if mean else recv.sum(dim=0)


# ---------------------------------------------------------------------------
# one rank's hops
# ---------------------------------------------------------------------------

def rs_quantized_local(x_flat: torch.Tensor, axis, n: int = None, *,
                       bits: int = 8, block: int = DEFAULT_BLOCK,
                       mean: bool = False) -> Tuple[torch.Tensor, int]:
    """One reduce-scatter hop: this rank's whole flat buffer in, its
    REDUCED chunk out. Wire: an int8 all-to-all of the payload and an f32
    all-to-all of the per-block scales (~1/block overhead). Each rank's
    chunk is padded to whole blocks. Returns (served [c] f32, pad)."""
    n = comm.axis_size(axis) if n is None else n
    chunks, pad = _chunks(x_flat, n, block)
    q, scales, _ = block_quant(chunks, bits, block)
    q_recv = comm.all_to_all(q, axis=axis)
    s_recv = comm.all_to_all(scales, axis=axis)
    return _reduce(block_dequant(q_recv, s_recv, 0), mean), pad


def rs_exact_local(x_flat: torch.Tensor, axis, n: int = None, *,
                   mean: bool = False) -> Tuple[torch.Tensor, int]:
    """:func:`rs_quantized_local`'s contract over an exact f32 wire: the
    same dim-0 all-to-all and local reduce (``grad_sync(algo="exact")``
    and every exact hop of ``overlap.py``)."""
    n = comm.axis_size(axis) if n is None else n
    chunks, pad = _chunks(x_flat, n)
    return _reduce(comm.all_to_all(chunks, axis=axis), mean), pad


def ag_quantized_local(x_flat: torch.Tensor, axis, *, bits: int = 8,
                       block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Quantized all-gather hop: each rank gives its flat chunk, every
    rank gets the int8 roundtripped concatenation [n * len]."""
    q, scales, pad = block_quant(x_flat, bits, block)
    out_q = comm.all_gather(q, axis=axis, tiled=False)          # [n, cp]
    out_s = comm.all_gather(scales, axis=axis, tiled=False)     # [n, nb]
    return block_dequant(out_q, out_s, pad).reshape(-1)


def a2a_quantized_local(x: torch.Tensor, axis, *, bits: int = 8,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The dim-0 split / concat all-to-all over an int8 wire: each dim-0
    row is blockwise quantized on its flattened payload (blocks never
    straddle two rows, so a row moves with its own scales), payload and
    scales cross in two all-to-alls, the receiver dequantizes to
    ``x.dtype``."""
    lead = x.shape[0]
    q, scales, pad = block_quant(x.reshape(lead, -1), bits, block)
    q_recv = comm.all_to_all(q, axis=axis)
    s_recv = comm.all_to_all(scales, axis=axis)
    return block_dequant(q_recv, s_recv, pad).to(x.dtype).reshape(x.shape)


# ---------------------------------------------------------------------------
# the public collectives (one rank's tensor over the group of ``axis``)
# ---------------------------------------------------------------------------

def quantized_reduce_scatter(x: torch.Tensor, *, axis="data", bits: int = 8,
                             block: int = DEFAULT_BLOCK,
                             mean: bool = False) -> torch.Tensor:
    """Blockwise-int8 reduce-scatter of this rank's ``x``: this rank's
    reduced (sum or mean) chunk [c] of the flattened tensor. Wire bytes a
    rank: ~(n - 1) / n x numel int8 plus scales, a quarter of an f32
    exchange."""
    served, _ = rs_quantized_local(x.reshape(-1), axis, bits=bits,
                                   block=block, mean=mean)
    return served


def grad_sync(x: torch.Tensor, *, axis="data", algo: str = "int8",
              bits: int = 8, block: int = DEFAULT_BLOCK,
              mean: bool = True) -> torch.Tensor:
    """ZeRO-2 gradient sync: a reduce-scatter and an all-gather in the
    chosen wire format. ``x``: this rank's gradient; returns the reduced
    (mean by default) gradient in ``x``'s shape and dtype, the same on
    every rank (the engine then takes its ZeRO slab of it).

    ``algo``:
      * ``"int8"``: qgZ's two quantized hops: a blockwise-int8
        all-to-all (the reduce-scatter), dequantize and reduce,
        re-quantize the served chunk, an int8 all-gather. ~25% of the f32
        wire bytes.
      * ``"exact"``: the same two hops in f32, so that byte audits
        compare one op structure.

    A block holding an inf or a NaN comes out non-finite (its scale
    carries it), so the step's overflow check skips the step."""
    if algo not in ("exact", "int8"):
        raise ValueError(f"grad_sync algo {algo!r}: expected exact|int8")
    flat = x.reshape(-1).to(torch.float32)
    if algo == "int8":
        served, _ = rs_quantized_local(flat, axis, bits=bits, block=block,
                                       mean=mean)
        full = ag_quantized_local(served, axis, bits=bits, block=block)
    else:
        served, _ = rs_exact_local(flat, axis, mean=mean)
        full = comm.all_gather(served, axis=axis)
    return full[:flat.numel()].reshape(x.shape).to(x.dtype)


def quantized_all_to_all(x: torch.Tensor, *, axis="expert", bits: int = 8,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """int8 all-to-all over ``axis`` (dim-0 split and concat, the
    facade's ``comm.all_to_all`` default layout): the result equals the
    exact all-to-all's within blockwise-int8 tolerance."""
    return a2a_quantized_local(x, axis, bits=bits, block=block)


# ---------------------------------------------------------------------------
# the MoE queue exchange
# ---------------------------------------------------------------------------

class _QuantizedExchange(torch.autograd.Function):
    """The dim-0 peer exchange over an int8 wire. It is an involution and
    its own transpose, so the backward sends the cotangent through the
    same int8 exchange (straight-through past the quantizer)."""

    @staticmethod
    def forward(ctx, x, axis, bits, block):
        ctx.args = (axis, bits, block)
        return a2a_quantized_local(x, axis, bits=bits, block=block)

    @staticmethod
    def backward(ctx, g):
        axis, bits, block = ctx.args
        return (a2a_quantized_local(g.contiguous(), axis, bits=bits,
                                    block=block), None, None, None)


def make_queue_exchange(*, axis: str = "expert", algo: str = "int8",
                        bits: int = 8, block: int = DEFAULT_BLOCK):
    """(dispatch, combine) exchange pair of the MoE layer's queues.

    dispatch: this rank's queues [E, C, H] -> its experts' queues
    [E / ep, ep * C, H] (the rows of peer r at [r * C, (r + 1) * C)), the
    layout of ``comm.all_to_all(split_dim=0, concat_dim=1)``; combine is
    the exact inverse. With ``algo="int8"`` each direction quantizes each
    dim-0 row (an expert's [C, H] payload, flattened) and both directions
    of the backward cross the same int8 wire (the JAX package's
    ``custom_vjp`` pair); ``"exact"`` is the facade's differentiable
    all-to-all."""
    if algo not in ("exact", "int8"):
        raise ValueError(f"queue exchange algo {algo!r}: expected "
                         "exact|int8")

    def exchange(x):
        if algo == "int8":
            return _QuantizedExchange.apply(x, axis, bits, block)
        return comm.all_to_all(x, axis=axis)

    def dispatch(queues):
        ep = comm.axis_size(axis)
        y = exchange(queues)            # block r: peer r's rows of MY experts
        E, C, H = y.shape
        return (y.reshape(ep, E // ep, C, H).transpose(0, 1)
                .reshape(E // ep, ep * C, H))

    def combine(out):
        ep = comm.axis_size(axis)
        El, Q, H = out.shape
        y = (out.reshape(El, ep, Q // ep, H).transpose(0, 1)
             .reshape(ep * El, Q // ep, H))
        return exchange(y.contiguous())

    return dispatch, combine
