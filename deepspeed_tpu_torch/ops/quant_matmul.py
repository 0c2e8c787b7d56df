"""Weight-only blockwise-int8 matmul: packing, the CUDA kernel's wrapper
and its plain version.

Replaces the Pallas kernel of ``deepspeed_tpu/ops/pallas/quant_matmul.py``
(``_kernel``, launched by ``quant_matmul``). Weights are stored int8 with
one f32 scale per block of contraction elements and column (the
``quant_format`` blockwise format, ``QUANT_BLOCK`` = 256 by default; the
kernel takes any block that :func:`pack_kernel` makes), and

    y[m, n] = sum_kb (x[m, kb-block] . q[kb-block, n]) * s[kb, n]

accumulated in f32: each K-block's partial product is scaled once.

* :func:`pack_kernel` / :func:`pack_decode_weights` — pack once at engine
  construction (``serving.weight_dtype: "int8"``); under tensor
  parallelism a row-parallel shard off the scale grid packs at a finer
  block with its whole blocks' scales (:func:`pack_row_shard`).
* :func:`quant_matmul` — CUDA tensors launch ``csrc/quant_matmul.cu`` (or
  raise), one launch a call, for any N and K; CPU tensors run
  :func:`quant_matmul_reference`.

:func:`_plan` picks the kernel of ``csrc/quant_matmul.cu`` from the shape:
a bf16 x of at most 16 rows (decode) takes the tensor-core GEMV, bound by
the bytes of the int8 weights read once; a longer bf16 x (prefill) the
tensor-core GEMM, bound by operations above about 300 rows; an f32 x the
exact f32 loop on CUDA cores. Where the tiles are too few to fill the
card, K is split in whole blocks, the CTAs of a tile form one
thread-block cluster and add their sums in a fixed order through
distributed shared memory, inside the same launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..quant_format import QUANT_BLOCK, block_quant
from . import build

__all__ = ["quant_matmul", "quant_matmul_reference", "pack_kernel",
           "pack_row_shard", "pack_decode_weights"]

_X_DTYPES = (torch.float32, torch.bfloat16)


def pack_kernel(w: torch.Tensor, block: int = QUANT_BLOCK):
    """[..., K, N] weight -> (q int8 [..., Kp, N], scales f32
    [..., Kp/block, N]): blockwise symmetric int8 along the contraction
    dim, Kp = K padded to a block multiple (padded rows quantize to 0).
    Leading dims (the stacked layer axis) pack independently."""
    q, s, _pad = block_quant(w.transpose(-1, -2), 8, block)
    return (q.transpose(-1, -2).contiguous(),
            s.transpose(-1, -2).contiguous())


def pack_row_shard(w: torch.Tensor, offset: int, whole: int,
                   axis: str = "model", block: int = QUANT_BLOCK):
    """A row-parallel shard's blockwise int8 packing: ``w`` [K, N] holds
    rows ``[offset, offset + K)`` of a [whole, N] leaf whose other rows
    the other ranks of ``axis`` hold, and may start and end mid-block.
    It packs at the scale block b = gcd(offset, K, ``block``), each
    sub-block's scale its whole block's: the block's absmax all-reduced
    with MAX over ``axis`` (every rank holding a part of it). The int8
    values and the scales then equal the whole leaf's packing, cut, each
    scale repeated over its block's b-row sub-blocks. Every rank of
    ``axis`` makes the all-reduce, a shard on the grid too (b =
    ``block``: :func:`pack_kernel`'s values), so uneven shards on both
    sides of the grid make the same collectives."""
    import math
    K, N = w.shape
    b = math.gcd(math.gcd(offset, K), block)
    from .. import comm
    wf = w.to(torch.float32).reshape(K // b, b, N)
    amax = wf.abs().amax(dim=1)                          # [K / b, N]
    # the whole block of each sub-block
    blk = (offset + torch.arange(K // b, device=w.device) * b) // block
    buf = torch.zeros(-(-whole // block), N, device=w.device)
    buf.index_reduce_(0, blk, amax, "amax")
    comm.all_reduce(buf, op=comm.ReduceOp.MAX, axis=axis)
    a = buf.index_select(0, blk)
    scale = torch.where(a == 0, torch.ones_like(a), a / 127.0)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(K, N).contiguous(), scale.contiguous()


def pack_decode_weights(params: Dict[str, Any], block: int = QUANT_BLOCK,
                        rows: Optional[Dict[str, Tuple[int, int]]] = None
                        ) -> Dict[str, Any]:
    """Pack a scan-layout parameter tree's dense kernels to blockwise int8:
    the direct matmul leaves of ``blocks`` (attn_qkv, attn_proj,
    mlp_fc/gate/proj) and ``lm_head``. Leaves that already carry an int8
    form are left alone. ``rows``: a tensor-parallel rank's row-parallel
    leaves, ``{name: (row offset, whole rows)}``, packed by
    :func:`pack_row_shard`."""
    def _pack(sub, cut=None):
        if "kernel_scale" in sub or "kernel_qscale" in sub:
            return sub
        w = sub["kernel"]
        pack = (functools.partial(pack_kernel, block=block) if cut is None
                else functools.partial(pack_row_shard, offset=cut[0],
                                       whole=cut[1], block=block))
        if w.dim() > 2:
            # one layer at a time: the f32 temporaries of one layer, not
            # of the whole stack
            q0, s0 = pack(w[0])
            q = q0.new_empty((w.shape[0],) + tuple(q0.shape))
            s = s0.new_empty((w.shape[0],) + tuple(s0.shape))
            q[0], s[0] = q0, s0
            for i in range(1, w.shape[0]):
                q[i], s[i] = pack(w[i])
        else:
            q, s = pack(w)
        out = {k: v for k, v in sub.items() if k != "kernel"}
        out["kernel"], out["kernel_qscale"] = q, s
        return out

    out = dict(params)
    blocks = dict(params["blocks"])
    for name, sub in blocks.items():
        if isinstance(sub, dict) and "kernel" in sub:
            blocks[name] = _pack(sub, (rows or {}).get(name))
    out["blocks"] = blocks
    if isinstance(params.get("lm_head"), dict) and "kernel" in params["lm_head"]:
        out["lm_head"] = _pack(params["lm_head"])
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("quant_matmul")
    fn = lib.quant_matmul_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 4 + [I] * 11 + [P]
        fn.restype = ctypes.c_int
    return lib


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                 *, impl: str = "auto") -> torch.Tensor:
    """x [..., K] @ blockwise-int8 weight -> [..., N] in x's dtype.

    q: [Kp, N] int8, scales: [Kp/block, N] f32 (:func:`pack_kernel`;
    Kp >= K). CUDA tensors launch the kernel, and raise on what it does
    not take; CPU tensors, or ``impl="reference"``, run the plain
    version."""
    if impl == "reference" or (impl == "auto" and x.device.type == "cpu"):
        return quant_matmul_reference(x, q, scales)
    if impl != "auto":
        raise ValueError(f"quant_matmul impl {impl!r}: expected 'auto' or "
                         "'reference'")
    return _launch(x, q, scales)


quant_matmul.launches = 0

# the kernels of csrc/quant_matmul.cu: (regime code, rows, columns of a
# CTA tile, CTAs an SM holds)
GEMV_MAX_M = 16
_REGIMES = {"simt": (0, 8, 128, 1), "gemv": (1, GEMV_MAX_M, 128, 2),
            "gemm": (2, 128, 128, 1)}


# split K: the CTAs of a tile form one thread-block cluster (portable size)
MAX_SPLITS = 8


class Plan(NamedTuple):
    """One launch: ``regime`` names the kernel; the grid is ``tiles`` x
    ``splits`` CTAs, split ``s`` taking K-blocks [s * kb_per, (s + 1) *
    kb_per) of ``nkb``, the splits of a tile one cluster."""
    regime: str
    tiles: int
    kb_per: int
    splits: int


def block_reason(block: int):
    """None if the kernel takes scale blocks of ``block`` rows, else why
    not (a pure function of the block): it takes every block that
    :func:`pack_kernel` makes, any block of at least one row."""
    if block < 1:
        return f"scale block {block} (blocks hold at least one row)"
    return None


def _plan(M: int, N: int, nkb: int, sms: int, dtype: torch.dtype,
          block: int = QUANT_BLOCK) -> Plan:
    """The kernel, its tiles and its split of K for an [M, K] x [K, N]
    call with ``nkb`` scale blocks of ``block`` rows on a card of ``sms``
    SMs. K is split in whole blocks. Tiles that fill the card's CTA slots
    are not split. Fewer are split into at most one wave of CTAs and at
    most MAX_SPLITS a tile: the count that minimises the waves times the
    K rows each CTA walks (the smallest count on a tie)."""
    reason = block_reason(block)
    if reason is not None:
        raise ValueError(f"quant_matmul kernel: {reason}")
    regime = ("simt" if dtype == torch.float32 else
              "gemv" if M <= GEMV_MAX_M else "gemm")
    _, bm, bn, per_sm = _REGIMES[regime]
    if regime == "gemv" and M > 8:
        per_sm = 1                      # two 8-row halves: twice the smem
    tiles = -(-M // bm) * -(-N // bn)
    slots = per_sm * sms
    best = None
    for want in range(1, nkb + 1):
        kb_per = -(-nkb // want)
        splits = -(-nkb // kb_per)
        if splits > 1 and (tiles * splits > slots or splits > MAX_SPLITS):
            break
        cost = -(-tiles * splits // slots) * kb_per * block
        if best is None or cost < best[0]:
            best = (cost, kb_per, splits)
    _, kb_per, splits = best
    return Plan(regime, tiles, kb_per, splits)


def _launch(x, q, scales):
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"quant_matmul kernel: x dtype {x.dtype} (expected "
                        "float32 or bfloat16)")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("quant_matmul kernel: q must be int8 and scales "
                        "float32")
    if q.dim() != 2 or scales.dim() != 2 or scales.shape[1] != q.shape[1]:
        raise ValueError(f"quant_matmul: q {tuple(q.shape)} / scales "
                         f"{tuple(scales.shape)} are not [Kp, N] / [nkb, N]")
    Kp, N = q.shape
    nkb = scales.shape[0]
    if Kp % nkb:
        raise ValueError(f"quant_matmul: Kp {Kp} is not a multiple of the "
                         f"{nkb} scale rows")
    block = Kp // nkb
    reason = block_reason(block)
    if reason is not None:
        raise ValueError(f"quant_matmul kernel: {reason}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quant_matmul kernel needs CUDA tensors, x is on "
                         f"{dev}")
    for t in (q, scales):
        if t.device != dev:
            raise ValueError(f"quant_matmul: a weight is on {t.device}, x on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError("quant_matmul: q and scales must be contiguous")
    lead, K = x.shape[:-1], x.shape[-1]
    if K > Kp:
        raise ValueError(f"quant_matmul: x has K={K} > packed Kp={Kp}")
    xf = x.reshape(-1, K).contiguous()
    M = xf.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return out.reshape(lead + (N,))
    plan = _plan(M, N, nkb, build.sm_count(dev), x.dtype, block)
    qvec = N % 16 == 0 and q.data_ptr() % 16 == 0
    xvec = K % 8 == 0 and xf.data_ptr() % 16 == 0
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.count_launch(quant_matmul)
    err = lib.quant_matmul_launch(
        xf.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        M, K, N, nkb, block, _REGIMES[plan.regime][0], plan.tiles,
        plan.kb_per, plan.splits, int(qvec), int(xvec), stream)
    build.check(lib, "quant_matmul", err)
    return out.reshape(lead + (N,))


def quant_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: each K-block's partial product scaled once,
    summed in f32, cast to x's dtype. Any scale block, as the JAX
    reference and the CUDA kernel take."""
    Kp, N = q.shape
    nkb = scales.shape[0]
    block = Kp // nkb
    lead, K = x.shape[:-1], x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, K)
    if Kp > K:
        xf = torch.nn.functional.pad(xf, (0, Kp - K))
    xb = xf.reshape(-1, nkb, block)
    qb = q.to(torch.float32).reshape(nkb, block, N)
    part = torch.einsum("mkb,kbn->mkn", xb, qb) * scales[None].to(
        torch.float32)
    return part.sum(dim=1).reshape(lead + (N,)).to(x.dtype)
