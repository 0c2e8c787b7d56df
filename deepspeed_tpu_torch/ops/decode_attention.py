"""Decode attention against a dense KV cache: the CUDA kernel's wrapper and
its plain version.

Replaces the Pallas kernel of ``deepspeed_tpu/ops/pallas/decode_attention.py``
(``_kernel``, launched by ``decode_attention``). T <= 64 new queries at
absolute positions ``[cur_len - T, cur_len)`` attend to a preallocated
cache whose positions ``>= cur_len`` are dead; the kernel reads only the
live rows.

* :func:`decode_attention` — for CUDA tensors it launches
  ``csrc/decode_attention.cu`` (or raises); for CPU tensors it runs
  :func:`decode_attention_reference`.
* :func:`decode_attention_reference` — the plain PyTorch version: the
  cache attention math of ``deepspeed_tpu/models/generation.py``
  (``forward_with_cache``'s jnp path) over the whole cache. It also takes
  what only that path serves, left-pad lengths and an int8 cache with its
  scales, so ``models/generation.forward_with_cache`` runs it for ragged
  batches and the int8 cache on every device.

The TPU wrapper's ``ValueError`` for shapes that do not tile (a
``max_len`` without a 128-multiple block, small head dims) is a TPU
constraint: the CUDA kernel takes any ``max_len`` and any head dim
``hd % 8 == 0`` in f32, bf16 or fp16, and raises for T > 64 or what else it
lacks (:func:`kernel_gate`). At T = 1 it splits a (sequence, head)'s context
over a cluster of CTAs where the batch leaves the card short of them
(:func:`split_plan`).

Bound on the card: bytes (the live K/V rows, read once). See the note in
the CUDA source for what the design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build
from .attention import check_kernel_inputs

__all__ = ["decode_attention", "decode_attention_reference", "MAX_T",
           "kernel_gate", "split_plan", "route"]

NEG_INF = -1e30
MAX_T = 64                                  # queries per call
MAX_SPLITS = 8                              # a portable cluster (T = 1)
SPLIT_MIN_TOKENS = 128                      # the least context a split walks
WIDE_FROM = 256                             # wider heads: the wide kernels


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 8 + [ctypes.c_float] * 2 + [I, I, P]
        fn.restype = ctypes.c_int
    return lib


def decode_attention(q: torch.Tensor,
                     k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cur_len: int,
                     *,
                     window: Optional[int] = None,
                     sm_scale: Optional[float] = None,
                     layer_idx: Optional[int] = None,
                     alibi_slopes=None,
                     softcap: float = 0.0,
                     impl: str = "auto") -> torch.Tensor:
    """Attention of T new tokens against a preallocated KV cache.

    q: [B, nh, T, hd], the queries at absolute positions
    ``[cur_len - T, cur_len)``. k_cache/v_cache: [B, nh, max_len, hd], or
    with ``layer_idx`` (a python int) the stacked [L, B, nh, max_len, hd],
    read at that layer without a copy. cur_len: python int, the valid
    length including the T new tokens. ``window`` <= 0 or None means
    global; ``alibi_slopes``: [nh]; ``softcap``: tanh cap, 0 = off.

    CUDA tensors launch the kernel, and raise on what it does not take
    (:func:`kernel_gate`); CPU tensors, or ``impl="reference"``, run the plain version. Returns
    [B, nh, T, hd] in q's dtype."""
    kw = dict(window=window, sm_scale=sm_scale, layer_idx=layer_idx,
              alibi_slopes=alibi_slopes, softcap=softcap)
    if impl == "reference" or (impl == "auto" and q.device.type == "cpu"):
        return decode_attention_reference(q, k_cache, v_cache, cur_len, **kw)
    if impl != "auto":
        raise ValueError(f"decode_attention impl {impl!r}: expected 'auto' "
                         "or 'reference'")
    return _launch(q, k_cache, v_cache, cur_len, **kw)


decode_attention.launches = 0


def split_plan(B: int, nh: int, T: int, hd: int, live: int, sms: int) -> int:
    """CTAs a (sequence, head) at T = 1 up to head dim 256 (1 for every
    other call): enough for 1.5 CTAs an SM, as the paged kernel's plan,
    at most MAX_SPLITS, none walking fewer than SPLIT_MIN_TOKENS of the
    ``live`` positions. A pure function of the shapes."""
    if T != 1 or hd > WIDE_FROM:
        return 1
    want = -(-3 * sms // (2 * max(B * nh, 1)))
    return max(1, min(MAX_SPLITS, want, live // SPLIT_MIN_TOKENS))


def route(T: int, hd: int, dtype: torch.dtype) -> str:
    """Which kernel of ``csrc/decode_attention.cu`` a call takes, from
    its shape and dtype: ``"row"`` (T = 1, a row split over a warp's
    lanes, the context over a cluster), ``"mma"`` (1 < T, 16-bit: tensor
    cores), ``"f32"`` (1 < T, f32: CUDA cores), or ``"wide"`` for head
    dims above 256 (the output columns split over CTAs)."""
    if hd > WIDE_FROM:
        return "wide"
    if T == 1:
        return "row"
    return "f32" if dtype == torch.float32 else "mma"


def kernel_gate(q, k_cache, v_cache, cur_len: int,
                layer_idx: Optional[int] = None):
    """What the kernel takes, from the shapes and dtypes alone (the same on
    every device; a launch adds the device checks): T <= 64 queries [B,
    nh, T, hd], caches [L?, B, nh, max_len, hd] of q's dtype with T <=
    cur_len <= max_len, any head dim hd % 8 == 0, f32, bf16 or fp16.
    Returns (caches with the layer dim, layer, dtype code); raises
    ValueError or TypeError."""
    B, nh, T, hd = q.shape
    if T > MAX_T:
        raise ValueError(f"decode_attention takes T <= {MAX_T} queries "
                         f"(got T={T}); longer prefills run the flash kernel "
                         "or the plain cache path")
    if layer_idx is None:
        k_cache, v_cache = k_cache.unsqueeze(0), v_cache.unsqueeze(0)
        layer = 0
    else:
        layer = int(layer_idx)
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(f"caches must be [L?, B, nh, max_len, hd], got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    L, cb, cnh, max_len, chd = k_cache.shape
    if (cb, cnh, chd) != (B, nh, hd) or not 0 <= layer < L:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q "
                         f"{tuple(q.shape)} at layer {layer}")
    if not T <= int(cur_len) <= max_len:
        raise ValueError(f"cur_len {cur_len} must lie in [T={T}, "
                         f"max_len={max_len}]")
    code = check_kernel_inputs("decode_attention", hd, q.dtype,
                               k_cache.dtype, v_cache.dtype)
    return k_cache, v_cache, layer, code


def _launch(q, k_cache, v_cache, cur_len, *, window, sm_scale, layer_idx,
            alibi_slopes, softcap):
    B, nh, T, hd = q.shape
    k_cache, v_cache, layer, code = kernel_gate(q, k_cache, v_cache, cur_len,
                                                layer_idx)
    max_len = k_cache.shape[3]
    cur_len = int(cur_len)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, q is "
                         f"on {dev}")
    for t in (k_cache, v_cache):
        if t.device != dev:
            raise ValueError(f"decode_attention: a cache is on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError("decode_attention: caches must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention kernel: caches must be 16-byte "
                         "aligned")
    if B > 65535:
        raise ValueError(f"decode_attention kernel: batch {B} too large")
    q = q.contiguous()
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).reshape(nh).contiguous()
    out = torch.empty((B, nh, T, hd), dtype=q.dtype, device=dev)
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(hd))
    win = int(window or 0)
    live = min(cur_len, win) if win > 0 else cur_len   # the keys walked
    splits = split_plan(B, nh, T, hd, live, build.sm_count(dev))
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    decode_attention.launches += 1
    err = lib.decode_attention_launch(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(slopes), ptr(out),
        B, nh, T, max_len, hd, layer, cur_len, win,
        float(scale), float(softcap or 0.0), splits, code, stream)
    build.check(lib, "decode_attention", err)
    return out


def decode_attention_reference(q: torch.Tensor,
                               k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               cur_len: int,
                               *,
                               window: Optional[int] = None,
                               sm_scale: Optional[float] = None,
                               layer_idx: Optional[int] = None,
                               alibi_slopes=None,
                               softcap: float = 0.0,
                               pad: Optional[torch.Tensor] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version over the whole cache (the JAX decode path's
    jnp math): scores in the cache's compute dtype, then f32 times
    ``sm_scale``, softcap, the ALiBi bias ``slope * (k - q_abs)``, the
    causal, window and left-pad masks to -1e30, an f32 softmax, and P cast
    to q's dtype before P V.

    ``pad`` [B]: left-pad lengths of a ragged batch (cache slots below
    ``pad[b]`` are dead for sample b). ``k_scale``/``v_scale`` (f32, one
    per cache row, shaped like the cache with a trailing 1): an int8
    cache, dequantized on read to q's dtype. Neither has a kernel."""
    B, nh, T, hd = q.shape
    if layer_idx is not None:
        k_cache, v_cache = k_cache[layer_idx], v_cache[layer_idx]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer_idx], v_scale[layer_idx]
    if k_scale is not None:
        k_cache = (k_cache.to(torch.float32) * k_scale).to(q.dtype)
        v_cache = (v_cache.to(torch.float32) * v_scale).to(q.dtype)
    max_len = k_cache.shape[2]
    dev = q.device
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(hd))
    q_abs = int(cur_len) - T + torch.arange(T, device=dev)       # [T]
    k_pos = torch.arange(max_len, device=dev)                    # [K]
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k_cache.to(ct)).to(
        torch.float32) * scale
    if softcap:
        from .attention import apply_softcap
        s = apply_softcap(s, softcap)
    if alibi_slopes is not None:
        sl = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                             device=dev).reshape(nh)
        dist = (k_pos[None, :] - q_abs[:, None]).to(torch.float32)
        s = s + sl[:, None, None] * dist[None]
    keep = k_pos[None, :] <= q_abs[:, None]                      # [T, K]
    win = int(window or 0)
    if win > 0:
        keep = keep & (q_abs[:, None] - k_pos[None, :] < win)
    if pad is not None:
        live = k_pos[None, :] >= pad.to(dev).reshape(B)[:, None]  # [B, K]
        keep = (keep[None] & live[:, None])[:, None]             # [B,1,T,K]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1).to(q.dtype)
    ct = torch.promote_types(prob.dtype, v_cache.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", prob.to(ct), v_cache.to(ct))
