"""Compressed collectives: 1-bit and int8 allreduce with error feedback,
and ZeRO++'s quantized weight gather, qwZ (counterpart of
``deepspeed_tpu/runtime/comm/compressed.py``; reference
``runtime/comm/nccl.py:52-204`` ``compressed_allreduce``).

The allreduces compress (signs and a scale, or int8 and a scale), cut the
flat buffer into one chunk a rank, let every rank "serve" its chunk
(average, then re-compress with the server's error feedback) and
all-gather the served chunks. The wire carries bit-packed signs (1 bit an
element) or int8 payloads beside f32 scales: ~32x or ~4x fewer bytes
than f32. The error-feedback buffers are the caller's (the 1-bit
optimizers keep them in their state).

Each function takes THIS rank's local tensors and runs over the process
group of its axis through the counted facade (``comm.comm``), where the
JAX package maps a ``shard_map`` body over a stacked [n, ...] array.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...comm import comm
from ...ops.quantizer import pack_signs, unpack_signs
from ...quant_format import div_exact
from .quantized import _chunks


def chunk_elems(numel: int, n: int, multiple: int = 8) -> int:
    """The chunk length each rank serves in the 1-bit path for
    ``numel`` elements (the length of its ``server_error``)."""
    c = -(-numel // n)
    return -(-c // multiple) * multiple


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, *, axis: str = "data"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-bit allreduce of this rank's ``x`` with two-level error
    feedback. ``worker_error`` [numel] and ``server_error``
    [chunk_elems(numel, n)] are the rank's running compensation buffers.
    Returns (the average over the group, in x's shape and dtype, the new
    worker error, the new server error)."""
    n, my = comm.axis_size(axis), comm.axis_rank(axis)
    flat = x.reshape(-1).to(torch.float32)
    corrected = flat + worker_error
    chunks, _ = _chunks(corrected, n, 8)                  # [n, c], c % 8 == 0
    scale = chunks.abs().mean(dim=1, keepdim=True)        # [n, 1]
    signs = torch.where(chunks >= 0, 1.0, -1.0)
    new_w = corrected - (signs * scale).reshape(-1)[:corrected.numel()]
    c = chunks.shape[1]
    # rank r serves chunk r: an all-to-all of the PACKED signs (1 bit an
    # element on the wire) and an all-gather of the per-chunk scales
    packed = pack_signs(signs.reshape(-1)).reshape(n, c // 8)
    packed_recv = comm.all_to_all(packed, axis=axis)
    signs_recv = unpack_signs(packed_recv.reshape(-1)).reshape(n, c)
    scales_all = comm.all_gather(scale[:, 0].contiguous(), axis=axis,
                                 tiled=False)             # [n, n]
    served = (signs_recv * scales_all[:, my][:, None]).mean(dim=0)
    # the server re-compresses with its own error feedback
    served_c = served + server_error
    s_scale = served_c.abs().mean()
    s_signs = torch.where(served_c >= 0, 1.0, -1.0)
    new_s = served_c - s_signs * s_scale
    out_packed = comm.all_gather(pack_signs(s_signs), axis=axis)
    out_scales = comm.all_gather(s_scale.reshape(1), axis=axis)   # [n]
    out = (unpack_signs(out_packed).reshape(n, c)
           * out_scales[:, None]).reshape(-1)
    return (out[:flat.numel()].reshape(x.shape).to(x.dtype), new_w, new_s)


def _sym_quant(x: torch.Tensor, qmax: float, dim=None):
    """Symmetric quant: (clipped rounded f32 values, f32 scale); ``dim``
    None scales the whole tensor, an int each slice along it
    (keepdim)."""
    xf = x.to(torch.float32)
    absmax = (xf.abs().amax() if dim is None
              else xf.abs().amax(dim=dim, keepdim=True))
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        div_exact(absmax, qmax))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return torch.nan_to_num(q, nan=0.0), scale


def _int8_exchange(flat: torch.Tensor, error: torch.Tensor, axis: str,
                   qmax: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The error-feedback int8 chunk exchange of
    :func:`quantized_allreduce`: (the group's average of ``flat +
    error``, the new error)."""
    n, my = comm.axis_size(axis), comm.axis_rank(axis)
    flat = flat + error
    chunks, _ = _chunks(flat, n)
    q, scale = _sym_quant(chunks, qmax, dim=1)
    new_err = flat - (q * scale).reshape(-1)[:flat.numel()]
    q_recv = comm.all_to_all(q.to(torch.int8), axis=axis)
    scales_all = comm.all_gather(scale[:, 0].contiguous(), axis=axis,
                                 tiled=False)
    served = (q_recv.to(torch.float32)
              * scales_all[:, my][:, None]).mean(dim=0)
    s_q, s_scale = _sym_quant(served, qmax)
    out_q = comm.all_gather(s_q.to(torch.int8), axis=axis)
    out_scales = comm.all_gather(s_scale.reshape(1), axis=axis)
    c = served.shape[0]
    out = (out_q.to(torch.float32).reshape(n, c)
           * out_scales[:, None]).reshape(-1)[:flat.numel()]
    return out, new_err


def quantized_allreduce(x: torch.Tensor, error: torch.Tensor, *,
                        axis: str = "data", bits: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 allreduce with error feedback (EQuARX style): int8 chunks
    reduce-scattered, averaged, the int8 results all-gathered. ``error``
    [numel]: this rank's buffer. Returns (the average in x's shape and
    dtype, the new error)."""
    qmax = float(2 ** (bits - 1) - 1)
    out, new_err = _int8_exchange(x.reshape(-1).to(torch.float32), error,
                                  axis, qmax)
    return out.reshape(x.shape).to(x.dtype), new_err


def hierarchical_quantized_allreduce(x: torch.Tensor, error: torch.Tensor,
                                     *, intra_axis: str, inter_axis: str,
                                     bits: int = 8
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level int8 allreduce (ZeRO++ qgZ's hierarchy): an exact
    average over the fast ``intra_axis``, then the error-feedback int8
    exchange of :func:`quantized_allreduce` over the slow
    ``inter_axis``. ``error`` [numel]: the buffer of this rank's
    inter-axis level. Returns (the average, the new error)."""
    qmax = float(2 ** (bits - 1) - 1)
    local = comm.all_reduce(x.to(torch.float32).clone(),
                            op=comm.ReduceOp.AVG, axis=intra_axis)
    out, new_err = _int8_exchange(local.reshape(-1), error, inter_axis, qmax)
    return out.reshape(x.shape).to(x.dtype), new_err


# ---------------------------------------------------------------------------
# ZeRO++ quantized weight gather (qwZ)
# ---------------------------------------------------------------------------

def quantized_gather_local(shard: torch.Tensor, axis, dim: int, *,
                           bits: int = 8, scale=None) -> torch.Tensor:
    """The int8 all-gather of this rank's ``shard`` along ``dim``: the
    int8 payload and one f32 scale a shard (``scale``: this rank's, by
    default absmax / qmax of the shard) cross the wire, every rank
    dequantizes the concatenation, in the shard's dtype."""
    qmax = float(2 ** (bits - 1) - 1)
    xf = shard.to(torch.float32)
    if scale is None:
        _, scale = _sym_quant(xf, qmax)
    q = torch.nan_to_num(torch.clamp(torch.round(xf / scale), -qmax, qmax),
                         nan=0.0).to(torch.int8)
    qg = comm.all_gather(q, axis=axis, tiled=False)             # [k, ...]
    sg = comm.all_gather(scale.reshape(1).to(torch.float32), axis=axis)
    deq = qg.to(torch.float32) * sg.reshape((-1,) + (1,) * shard.dim())
    return torch.cat(list(deq.unbind(0)), dim=dim).to(shard.dtype)


class _QuantizedGather(torch.autograd.Function):
    """int8 gather forward; the backward reduce-scatters the cotangent
    (exact, summed over the group) back to the shard."""

    @staticmethod
    def forward(ctx, shard, axis, dim, bits):
        ctx.args = (axis, dim)
        return quantized_gather_local(shard, axis, dim, bits=bits)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.args
        return (comm.reduce_scatter(g.contiguous(), axis=axis,
                                    scatter_dim=dim), None, None, None)


def make_quantized_gather(axis, dim: int, bits: int = 8):
    """ZeRO++'s quantized weight gather (qwZ): ``f(shard)`` -> the whole
    tensor along ``dim`` over the group of ``axis`` (a name or the
    composed ZeRO axes), from int8 shards with one scale each: a quarter
    of the bf16 gather's bytes. The backward is exact: the cotangents
    reduce-scattered back to the shard (the gradient of the ranks'
    summed losses; under the JAX package's SPMD the cotangent reaching
    this seam is global already, and its backward is the slice)."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits={bits}: the wire dtype is int8, so only "
                         "2..8-bit quantization is supported")

    def gather(shard: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and shard.requires_grad:
            return _QuantizedGather.apply(shard, axis, dim, bits)
        return quantized_gather_local(shard, axis, dim, bits=bits)

    return gather
