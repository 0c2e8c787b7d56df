"""Paged-attention decode: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas kernel of ``deepspeed_tpu/ops/pallas/paged_attention.py``
(``_kernel``, launched by ``paged_attention``). The serving KV cache is a
pool of fixed-size blocks shared by every sequence; a per-sequence block
table maps logical block j to a physical pool block. Each decode step
attends one fresh query per sequence to its scattered K/V.

* :func:`paged_attention` — one query token per sequence. For CUDA
  tensors it launches ``csrc/paged_attention.cu`` (or raises); for CPU
  tensors it runs :func:`paged_attention_reference`.
* :func:`paged_attention_reference` — the plain PyTorch version: a dense
  gather through the block table, then the decode attention math. It also
  takes T > 1 queries (prefill, positioned by ``q_start``), which the
  serving path runs through it on every device, as the JAX package does.

Bound on the card: bytes (the live K/V rows, read once). See the note in
the CUDA source for what the kernel's layout does about it: where B * nh
CTAs would leave the card's SMs few loads in flight, :func:`split_plan`
cuts each sequence's context into up to 8 ranges whose CTAs combine in
one thread-block cluster, in the same launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build
from .attention import check_kernel_inputs

__all__ = ["paged_attention", "paged_attention_reference", "kernel_gate",
           "split_plan"]

NEG_INF = -1e30
_INT8_POOL = 3                      # csrc/paged_attention.cu pool_dtype code
MAX_SPLITS = 8                      # a portable thread-block cluster
SPLIT_MIN_TOKENS = 128              # positions a split walks at the least


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 9 + [I] * 8 + [ctypes.c_float] * 2 + [I] * 3 + [P]
        fn.restype = ctypes.c_int
    return lib


def paged_attention(q: torch.Tensor,
                    k_pool: torch.Tensor,
                    v_pool: torch.Tensor,
                    block_tables: torch.Tensor,
                    context_lens: torch.Tensor,
                    *,
                    sm_scale: Optional[float] = None,
                    alibi_slopes=None,
                    softcap: float = 0.0,
                    window: Optional[int] = None,
                    layer_idx: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    impl: str = "auto") -> torch.Tensor:
    """One decode token per sequence against a paged KV pool.

    q: [B, nh, 1, hd], each sequence's query at logical position
    ``context_lens[b] - 1``. k_pool/v_pool: [nh, num_blocks, block_size,
    hd], or with ``layer_idx`` (a python int) the stacked [L, nh,
    num_blocks, block_size, hd]. int8 pools carry f32 ``k_scale`` /
    ``v_scale`` (one per row; any shape that reshapes to the pool's
    [..., num_blocks, block_size]). block_tables: [B, max_blocks] int32,
    entries < num_blocks (the serving engine's ``BlockPool`` guarantees
    it). context_lens: [B] int32. ``window`` <= 0 or None means global;
    ``alibi_slopes``: [nh]; ``softcap``: tanh cap, 0 = off.

    CUDA tensors launch the kernel, and raise on what it does not take
    (:func:`kernel_gate`); CPU tensors, or ``impl="reference"``, run the
    plain version. Returns [B, nh, 1, hd] in q's dtype."""
    kw = dict(sm_scale=sm_scale, alibi_slopes=alibi_slopes, softcap=softcap,
              window=window, layer_idx=layer_idx, k_scale=k_scale,
              v_scale=v_scale)
    if impl == "reference" or (impl == "auto" and q.device.type == "cpu"):
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         context_lens, **kw)
    if impl != "auto":
        raise ValueError(f"paged_attention impl {impl!r}: expected 'auto' "
                         "or 'reference'")
    return _launch(q, k_pool, v_pool, block_tables, context_lens, **kw)


paged_attention.launches = 0


def split_plan(B: int, nh: int, max_ctx: int, sms: int) -> int:
    """CTAs a (lane, head) for a decode step of B lanes and nh heads whose
    contexts hold at most ``max_ctx`` positions, on a card of ``sms`` SMs:
    enough for 1.5 CTAs an SM (the kernel's register pipeline keeps its
    loads in flight; more, smaller splits measured slower on an H100,
    PERF.md), at most MAX_SPLITS, and none walking fewer than
    SPLIT_MIN_TOKENS positions. A pure function of the shapes (the context
    lengths stay on the device)."""
    want = -(-3 * sms // (2 * max(B * nh, 1)))
    return max(1, min(MAX_SPLITS, want, max_ctx // SPLIT_MIN_TOKENS))


def kernel_gate(q, k_pool, v_pool, *, quant: bool = False,
                layer_idx: Optional[int] = None):
    """What the kernel takes, from the shapes and dtypes alone (the same on
    every device; a launch adds the device checks): one query a sequence
    [B, nh, 1, hd], pools [L?, nh, blocks, block_size, hd] of q's dtype, or
    int8 with scales (``quant``), any head dim hd % 8 == 0, q in
    f32, bf16 or fp16. Returns (pools with the layer dim, layer, q dtype
    code, pool dtype code); raises ValueError or TypeError."""
    B, nh, T, hd = q.shape
    if T != 1:
        raise ValueError(f"paged_attention decodes 1 token per sequence "
                         f"(got T={T}); prefill runs the gather reference")
    if layer_idx is None:
        k_pool, v_pool = k_pool.unsqueeze(0), v_pool.unsqueeze(0)
        layer = 0
    else:
        layer = int(layer_idx)
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be [L, nh, blocks, block_size, hd], "
                         f"got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    L, pnh, nblk, bs, phd = k_pool.shape
    if (pnh, phd) != (nh, hd) or not 0 <= layer < L:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not fit q "
                         f"{tuple(q.shape)} at layer {layer}")
    if quant != (k_pool.dtype == torch.int8):
        raise TypeError("k_scale/v_scale pair with an int8 pool and only "
                        f"with one (pool dtype {k_pool.dtype})")
    if quant:
        code = check_kernel_inputs("paged_attention", hd, q.dtype)
        pool_code = _INT8_POOL
    else:
        code = check_kernel_inputs("paged_attention", hd, q.dtype,
                                   k_pool.dtype, v_pool.dtype)
        pool_code = code
    return k_pool, v_pool, layer, code, pool_code


def _launch(q, k_pool, v_pool, block_tables, context_lens, *, sm_scale,
            alibi_slopes, softcap, window, layer_idx, k_scale, v_scale):
    B, nh, _, hd = q.shape
    quant = k_scale is not None
    k_pool, v_pool, layer, code, pool_code = kernel_gate(
        q, k_pool, v_pool, quant=quant, layer_idx=layer_idx)
    nblk, bs = k_pool.shape[2:4]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, q is "
                         f"on {dev}")
    tensors = [k_pool, v_pool, block_tables, context_lens]
    if quant:
        k_scale = k_scale.reshape(k_pool.shape[:-1])
        v_scale = v_scale.reshape(v_pool.shape[:-1])
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("k_scale/v_scale must be float32")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"paged_attention: a tensor is on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError("paged_attention: pools, scales and tables "
                             "must be contiguous")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if block_tables.shape[0] != B or context_lens.numel() != B:
        raise ValueError("block_tables / context_lens do not match the batch")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention kernel: pools must be 16-byte "
                         "aligned")
    q = q.contiguous()
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).reshape(nh).contiguous()
    out = torch.empty((B, nh, 1, hd), dtype=q.dtype, device=dev)
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(hd))
    nbk = block_tables.shape[1]
    splits = split_plan(B, nh, nbk * bs, build.sm_count(dev))
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.count_launch(paged_attention)
    err = lib.paged_attention_launch(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(k_scale), ptr(v_scale),
        ptr(block_tables), ptr(context_lens), ptr(slopes), ptr(out),
        B, nh, nblk, bs, hd, nbk, layer,
        int(window or 0), float(scale), float(softcap or 0.0), splits,
        code, pool_code, stream)
    build.check(lib, "paged_attention", err)
    return out


def paged_attention_reference(q: torch.Tensor,
                              k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              context_lens: torch.Tensor,
                              *,
                              sm_scale: Optional[float] = None,
                              alibi_slopes=None,
                              softcap: float = 0.0,
                              window=None,
                              layer_idx=None,
                              k_scale=None,
                              v_scale=None,
                              q_start=None) -> torch.Tensor:
    """Plain PyTorch version: gather through the block table, then the
    decode attention math (f32 scores, softcap before the ALiBi bias
    before the -1e30 masks, f32 softmax). q may carry T > 1 tokens at
    logical positions [ctx - T, ctx), or [q_start, q_start + T) when
    ``q_start`` [B] is given (a bucket-padded prefill: outputs past ctx
    are garbage the caller discards). int8 pools dequantize after the
    gather."""
    B, nh, T, hd = q.shape
    quant = k_scale is not None
    if quant:
        k_scale = k_scale.to(torch.float32).reshape(k_pool.shape[:-1])
        v_scale = v_scale.to(torch.float32).reshape(v_pool.shape[:-1])
    if layer_idx is not None:
        k_pool, v_pool = k_pool[layer_idx], v_pool[layer_idx]
        if quant:
            k_scale, v_scale = k_scale[layer_idx], v_scale[layer_idx]
    bs = k_pool.shape[2]
    nbk = block_tables.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(hd))
    dev = q.device
    bt = block_tables.to(device=dev, dtype=torch.long)
    lens = context_lens.to(device=dev, dtype=torch.long).reshape(B)

    # gather [nh, B, nbk, bs, hd] -> [B, nh, K, hd], K = nbk * bs logical
    k = k_pool[:, bt].permute(1, 0, 2, 3, 4).reshape(B, nh, nbk * bs, hd)
    v = v_pool[:, bt].permute(1, 0, 2, 3, 4).reshape(B, nh, nbk * bs, hd)
    if quant:
        ks = k_scale[:, bt].permute(1, 0, 2, 3).reshape(B, nh, nbk * bs)
        vs = v_scale[:, bt].permute(1, 0, 2, 3).reshape(B, nh, nbk * bs)
        k = (k.to(torch.float32) * ks[..., None]).to(q.dtype)
        v = (v.to(torch.float32) * vs[..., None]).to(q.dtype)

    ar = torch.arange(T, device=dev)
    if q_start is not None:
        q_abs = (torch.as_tensor(q_start, device=dev).to(torch.long)
                 .reshape(B)[:, None] + ar)                  # [B, T]
    else:
        q_abs = lens[:, None] - T + ar                       # [B, T]
    k_pos = torch.arange(nbk * bs, device=dev)               # [K]
    ct = torch.promote_types(q.dtype, k.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)).to(
        torch.float32) * scale
    if softcap:
        from .attention import apply_softcap
        s = apply_softcap(s, softcap)
    if alibi_slopes is not None:
        sl = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                             device=dev).reshape(nh)
        dist = (k_pos[None, None, :] - q_abs[:, :, None]).to(torch.float32)
        s = s + sl[None, :, None, None] * dist[:, None]
    keep = k_pos[None, None, :] <= q_abs[:, :, None]         # [B, T, K]
    if window is not None:
        win = int(window)
        keep = keep & ((q_abs[:, :, None] - k_pos[None, None, :] < win)
                       | (win <= 0))
    s = torch.where(keep[:, None], s, torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1).to(q.dtype)
    ct = torch.promote_types(prob.dtype, v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", prob.to(ct), v.to(ct))
