"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Replaces the forward Pallas kernel of
``deepspeed_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel``, launched
by ``_fwd``; entry ``flash_attention``, mask classification
``_normalize_mask``). The backward kernels (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) come with the training slice.

* :func:`flash_attention` — o; :func:`flash_attention_fwd` — (o, lse) with
  lse [B, H, S] f32, the row logsumexp the backward will need. For CUDA
  tensors they launch ``csrc/flash_attention_fwd.cu`` (or raise); for CPU
  tensors they run :func:`flash_attention_reference`.
* :func:`flash_attention_reference` — the plain PyTorch version: the JAX
  wrapper's ``_reference_fallback`` (``mha_reference`` with the ALiBi bias
  and the window mask materialized), whose lse is the logsumexp of the
  masked f32 logits.

A query row with no live key: the kernel writes zeros (as the TPU kernel
does), the plain version the uniform average that the JAX reference
gives. Comparisons hold live rows against each other and the kernel's
rows to zero.

The TPU wrapper's block sizes and its fallback for shapes that do not
tile have no counterpart: the CUDA kernel masks any ragged edge itself.
Bound on the card: bytes at head_dim 64 (see the CUDA source).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from .attention import (alibi_bias_from_slopes, masked_logits, window_mask)

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)                  # csrc/flash_attention_fwd.cu


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 8 + [ctypes.c_float] * 2 + [I, P]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    mask=None,
                    alibi_slopes=None,
                    window: int = 0,
                    softcap: float = 0.0,
                    impl: str = "auto") -> torch.Tensor:
    """Flash attention. q, k, v: [batch, heads, seq, head_dim] -> o of q's
    shape and dtype. See :func:`flash_attention_fwd`."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               mask=mask, alibi_slopes=alibi_slopes,
                               window=window, softcap=softcap, impl=impl)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *,
                        causal: bool = True,
                        sm_scale: Optional[float] = None,
                        mask=None,
                        alibi_slopes=None,
                        window: int = 0,
                        softcap: float = 0.0,
                        impl: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward -> (o [B, H, S, D], lse [B, H, S] f32).

    ``mask``: bool (True = attend), any shape broadcastable to [B, H, S,
    Sk]; a key-padding mask (no head or query dim) rides as one [B, Sk]
    row, anything else as (q, k) tiles per batch or per head.
    ``alibi_slopes``: [H]; the bias slope * (k - q) is built from indices.
    ``window`` > 0: causal sliding window (q - k < window). ``softcap``:
    Gemma-2 tanh cap. Causal masking, ALiBi and the window place query i at
    position i + Sk - S.

    Forward only: inputs that require grad raise (the backward kernels
    come with the training slice). CUDA tensors launch the kernel and raise
    on what it does not take (fp16, a head dim other than 32, 64 or 128,
    a non-causal window); CPU tensors, or ``impl="reference"``, run the
    plain version."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in deepspeed_tpu_torch so far: "
            "its backward kernels come with the training slice (see "
            "ROADMAP.md); call it under torch.no_grad() or on tensors that "
            "do not require grad")
    kw = dict(causal=causal, sm_scale=sm_scale, mask=mask,
              alibi_slopes=alibi_slopes,
              window=int(window) if window and window > 0 else 0,
              softcap=float(softcap) if softcap else 0.0)
    if impl == "reference" or (impl == "auto" and q.device.type == "cpu"):
        return flash_attention_reference(q, k, v, **kw)
    if impl != "auto":
        raise ValueError(f"flash_attention impl {impl!r}: expected 'auto' "
                         "or 'reference'")
    return _launch(q, k, v, **kw)


flash_attention_fwd.launches = 0


def _normalize_mask(mask, B: int, H: int, S: int, Sk: int, device):
    """Classify a bool mask into the kernel's two forms: a key mask
    [B, 1, Sk] (no head or query dim) or (q, k) tiles [B(*H), S, Sk].
    Returns (kvm, qkm, per_head), int32 and contiguous."""
    mask = torch.as_tensor(mask, device=device)
    if mask.dim() > 4:
        raise ValueError(f"attention mask has rank {mask.dim()} > 4")
    mask = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
    mb, mh, mq, mk = mask.shape
    if mb not in (1, B) or mh not in (1, H) or mq not in (1, S) \
            or mk not in (1, Sk):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not "
                         f"broadcast to {(B, H, S, Sk)}")
    mask = mask.to(torch.bool)
    if mh == 1 and mq == 1:
        kvm = mask.expand(B, 1, 1, Sk).reshape(B, 1, Sk)
        return kvm.to(torch.int32).contiguous(), None, False
    per_head = mh == H and H > 1
    if per_head:
        qkm = mask.expand(B, H, S, Sk).reshape(B * H, S, Sk)
    else:
        qkm = mask.expand(B, 1, S, Sk).reshape(B, S, Sk)
    return None, qkm.to(torch.int32).contiguous(), per_head


def _launch(q, k, v, *, causal, sm_scale, mask, alibi_slopes, window,
            softcap):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q, k, v [B, H, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    Sk = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, H, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel: dtype {q.dtype} (expected "
                        "float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel: q, k, v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype} differ")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {D} (expected "
                         f"one of {_HEAD_DIMS})")
    if window and not causal:
        raise ValueError("flash_attention kernel: a sliding window needs "
                         "causal=True (the JAX wrapper sends a non-causal "
                         "window to its reference)")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, q is "
                         f"on {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k, v on different devices")
    if B * H > 65535:
        raise ValueError(f"flash_attention kernel: B * H = {B * H} > 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention kernel: q, k, v must be 16-byte "
                         "aligned")
    kvm = qkm = None
    per_head = False
    if mask is not None:
        kvm, qkm, per_head = _normalize_mask(mask, B, H, S, Sk, dev)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).reshape(H).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    flash_attention_fwd.launches += 1
    err = lib.flash_attention_fwd_launch(
        ptr(q), ptr(k), ptr(v), ptr(kvm), ptr(qkm), ptr(slopes), ptr(o),
        ptr(lse), B * H, H, S, Sk, D, int(bool(causal)), int(window),
        int(per_head), float(scale), float(softcap), _DTYPES[q.dtype],
        stream)
    build.check(lib, "flash_attention_fwd", err)
    return o, lse


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              causal: bool = True,
                              sm_scale: Optional[float] = None,
                              mask=None,
                              alibi_slopes=None,
                              window: int = 0,
                              softcap: float = 0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version -> (o, lse): the JAX ``_reference_fallback``
    (ALiBi bias and window mask materialized, ``mha_reference`` math) and
    the logsumexp of its masked f32 logits."""
    S, Sk = q.shape[-2], k.shape[-2]
    dev = q.device
    bias = None
    if alibi_slopes is not None:
        bias = alibi_bias_from_slopes(alibi_slopes, S, Sk, device=dev)
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    if window:
        wmask = window_mask(S, Sk, window, device=dev)
        mask = wmask if mask is None else mask & wmask
    logits = masked_logits(q, k, causal=causal, bias=bias, mask=mask,
                           sm_scale=sm_scale, softcap=softcap)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(ct), v.to(ct)), lse
