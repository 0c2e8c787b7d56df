"""Flash attention forward and backward: the CUDA kernels' wrappers and
their plain versions.

Replaces the Pallas kernels of ``deepspeed_tpu/ops/pallas/flash_attention.py``:
the forward ``_fwd_kernel`` (launched by ``_fwd``) and the backward
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (launched by ``_bwd``); entry
``flash_attention`` with its custom VJP, mask classification
``_normalize_mask``.

* :func:`flash_attention` — o, differentiable: a ``torch.autograd.Function``
  whose forward is :func:`flash_attention_fwd` and whose backward is
  :func:`flash_attention_bwd`.
* :func:`flash_attention_fwd` — (o, lse) with lse [B, H, S] f32, the row
  logsumexp the backward reads. CUDA tensors launch
  ``csrc/flash_attention_fwd.cu`` (or raise); CPU tensors run
  :func:`flash_attention_reference`.
* :func:`flash_attention_bwd` — (dq, dk, dv) from q, k, v, o, lse and dO.
  ``delta = rowsum(dO * O)`` is a plain torch op (the JAX package computes
  it outside its kernels too); CUDA tensors then launch the two kernels of
  ``csrc/flash_attention_bwd.cu`` through :func:`flash_attention_bwd_dq`
  and :func:`flash_attention_bwd_dkv` (or raise); CPU tensors run
  :func:`flash_attention_bwd_reference`.
* :func:`flash_attention_reference` — the plain forward: the JAX wrapper's
  ``_reference_fallback`` (``mha_reference`` with the ALiBi bias and the
  window mask materialized), whose lse is the logsumexp of the masked f32
  logits.
* :func:`flash_attention_bwd_reference` — the plain backward: the kernels'
  lse-based formula over the same dense masked logits.

A query row with no live key: the forward kernel writes zeros (as the TPU
kernel does), the plain forward the uniform average that the JAX reference
gives; both backward versions give that row, and its keys' share of dk and
dv, exactly zero gradients (the TPU kernel's ``_bwd_p`` guard).

The TPU wrapper's block sizes and its fallback for shapes that do not tile
have no counterpart: the CUDA kernels mask any ragged edge themselves.
Bound on the card: bytes for the forward at head_dim 64, operations for the
backward (see the CUDA sources).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from .attention import (KERNEL_DTYPES, NEG_INF, alibi_bias_from_slopes,
                        check_kernel_inputs, masked_logits, window_mask)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "kernel_gate"]


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 8 + [ctypes.c_float] * 2 + [I, P]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, n_ptr in ((lib.flash_attention_bwd_dq_launch, 10),
                      (lib.flash_attention_bwd_dkv_launch, 11)):
        if fn.argtypes is None:
            fn.argtypes = [P] * n_ptr + [I] * 8 + [F] * 2 + [I, P]
            fn.restype = ctypes.c_int
    return lib


def _options(causal, sm_scale, mask, alibi_slopes, window, softcap):
    return dict(causal=causal, sm_scale=sm_scale, mask=mask,
                alibi_slopes=alibi_slopes,
                window=int(window) if window and window > 0 else 0,
                softcap=float(softcap) if softcap else 0.0)


def _plain(q: torch.Tensor, impl: str) -> bool:
    """True for the plain version: CPU tensors or impl="reference"."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"flash_attention impl {impl!r}: expected 'auto' "
                         "or 'reference'")
    return impl == "reference" or q.device.type == "cpu"


class _FlashAttention(torch.autograd.Function):
    """o = flash_attention_fwd(q, k, v)[0]; the backward runs
    flash_attention_bwd on the saved q, k, v, o and lse (the JAX
    package's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kw, impl):
        # a remat region that keeps "attn" stores (o, lse) here and hands
        # them back in its recomputation, so the kernel launches once
        from .checkpoint_name import reuse
        o, lse = reuse("attn", lambda: flash_attention_fwd(q, k, v,
                                                           impl=impl, **kw),
                       q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.impl = kw, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, impl=ctx.impl,
                                         **ctx.kw)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    mask=None,
                    alibi_slopes=None,
                    window: int = 0,
                    softcap: float = 0.0,
                    impl: str = "auto") -> torch.Tensor:
    """Flash attention. q, k, v: [batch, heads, seq, head_dim] -> o of q's
    shape and dtype, differentiable in q, k and v. See
    :func:`flash_attention_fwd` for the options."""
    kw = _options(causal, sm_scale, mask, alibi_slopes, window, softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kw, impl)
    return flash_attention_fwd(q, k, v, impl=impl, **kw)[0]


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

    Not differentiable itself (:func:`flash_attention` is). CUDA tensors
    launch the kernel and raise on what it does not take
    (:func:`kernel_gate`: a head dim below 8 or not a multiple of 8, a
    dtype other than f32, bf16 and fp16, a non-causal window); CPU
    tensors, or ``impl="reference"``, run the plain version."""
    kw = _options(causal, sm_scale, mask, alibi_slopes, window, softcap)
    if _plain(q, impl):
        return flash_attention_reference(q, k, v, **kw)
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


def kernel_gate(q, k, v, *, causal=True, window=0,
                name="flash_attention"):
    """What the forward and backward kernels take, from the shapes and
    dtypes of q, k, v alone (the same on every device; a launch adds the
    device checks): [B, H, S, D] and [B, H, Sk, D], a head dim D % 8 == 0
    from 8 on, f32, bf16 or fp16 alike, no non-causal window. Returns (B,
    H, S, Sk, D); raises ValueError or TypeError."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name} takes q, k, v [B, H, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    Sk = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, H, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    check_kernel_inputs(name, D, q.dtype, k.dtype, v.dtype)
    if window and not causal:
        raise ValueError(f"{name} kernel: a sliding window needs causal=True "
                         "(the JAX wrapper sends a non-causal window to its "
                         "reference)")
    if B * H > 65535:
        raise ValueError(f"{name} kernel: B * H = {B * H} > 65535")
    return B, H, S, Sk, D


def _check_inputs(q, k, v, causal, window, name):
    """:func:`kernel_gate`, then the device checks."""
    dims = kernel_gate(q, k, v, causal=causal, window=window, name=name)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, q is on {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"{name}: q, k, v on different devices")
    return dims


def _extras(mask, alibi_slopes, B, H, S, Sk, dev):
    """(kvm, qkm, per_head, slopes) in the kernels' layouts."""
    kvm = qkm = None
    per_head = False
    if mask is not None:
        kvm, qkm, per_head = _normalize_mask(mask, B, H, S, Sk, dev)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).reshape(H).contiguous()
    return kvm, qkm, per_head, slopes


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(*ts):
    ts = [t.contiguous() for t in ts]
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention kernels: inputs must be 16-byte "
                         "aligned")
    return ts


def _launch(q, k, v, *, causal, sm_scale, mask, alibi_slopes, window,
            softcap):
    B, H, S, Sk, D = _check_inputs(q, k, v, causal, window, "flash_attention")
    dev = q.device
    q, k, v = _aligned(q, k, v)
    kvm, qkm, per_head, slopes = _extras(mask, alibi_slopes, B, H, S, Sk, dev)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.count_launch(flash_attention_fwd)
    err = lib.flash_attention_fwd_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(kvm), _ptr(qkm), _ptr(slopes),
        _ptr(o), _ptr(lse), B * H, H, S, Sk, D, int(bool(causal)),
        int(window), int(per_head), float(scale), float(softcap),
        KERNEL_DTYPES[q.dtype], stream)
    build.check(lib, "flash_attention_fwd", err)
    return o, lse


# ------------------------------------------------------------------ backward

def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *,
                        causal: bool = True,
                        sm_scale: Optional[float] = None,
                        mask=None,
                        alibi_slopes=None,
                        window: int = 0,
                        softcap: float = 0.0,
                        impl: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward -> (dq, dk, dv) in the inputs' dtypes.

    o and lse [B, H, S] are the forward's outputs, do the gradient of o;
    the options are the forward's. CUDA tensors compute delta = rowsum(dO *
    O) in f32 and launch the dq and the dk/dv kernels (or raise on what
    they do not take); CPU tensors, or ``impl="reference"``, run
    :func:`flash_attention_bwd_reference`."""
    kw = _options(causal, sm_scale, mask, alibi_slopes, window, softcap)
    if _plain(q, impl):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = _bwd_args(q, k, v, do, lse, delta, **kw)
    return (_launch_dq(*args),) + _launch_dkv(*args)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           sm_scale=None, mask=None, alibi_slopes=None,
                           window=0, softcap=0.0) -> torch.Tensor:
    """The dq kernel alone (CUDA tensors; raises otherwise): dq [B, H, S,
    D] from q, k, v, do, lse [B, H, S] and delta [B, H, S] f32."""
    kw = _options(causal, sm_scale, mask, alibi_slopes, window, softcap)
    return _launch_dq(*_bwd_args(q, k, v, do, lse, delta, **kw))


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            sm_scale=None, mask=None, alibi_slopes=None,
                            window=0, softcap=0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel alone (CUDA tensors; raises otherwise): (dk, dv)
    [B, H, Sk, D], same inputs as :func:`flash_attention_bwd_dq`."""
    kw = _options(causal, sm_scale, mask, alibi_slopes, window, softcap)
    return _launch_dkv(*_bwd_args(q, k, v, do, lse, delta, **kw))


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def _bwd_args(q, k, v, do, lse, delta, *, causal, sm_scale, mask,
              alibi_slopes, window, softcap):
    """Validated, contiguous kernel operands shared by both launches."""
    B, H, S, Sk, D = _check_inputs(q, k, v, causal, window,
                                   "flash_attention_bwd")
    dev = q.device
    if do.shape != q.shape or do.dtype != q.dtype or do.device != dev:
        raise ValueError(f"flash_attention_bwd: dO {tuple(do.shape)} "
                         f"{do.dtype} does not match q {tuple(q.shape)} "
                         f"{q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(f"flash_attention_bwd: {name} must be [B, H, S] "
                             f"float32 on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    q, k, v, do, lse, delta = _aligned(q, k, v, do, lse, delta)
    kvm, qkm, per_head, slopes = _extras(mask, alibi_slopes, B, H, S, Sk, dev)
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    ptrs = tuple(_ptr(t) for t in (q, k, v, do, lse, delta, kvm, qkm,
                                   slopes))
    ints = (B * H, H, S, Sk, D, int(bool(causal)), int(window), int(per_head))
    tail = (float(scale), float(softcap), KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    keep = (q, k, v, do, lse, delta, kvm, qkm, slopes)   # alive until launch
    return q, k, ptrs, ints, tail, keep


def _launch_dq(q, k, ptrs, ints, tail, keep):
    lib = _bwd_lib()
    dq = torch.empty_like(q)
    build.count_launch(flash_attention_bwd_dq)
    err = lib.flash_attention_bwd_dq_launch(*ptrs, dq.data_ptr(), *ints,
                                            *tail)
    build.check(lib, "flash_attention_bwd", err)
    return dq


def _launch_dkv(q, k, ptrs, ints, tail, keep):
    lib = _bwd_lib()
    dk, dv = torch.empty_like(k), torch.empty_like(k)
    build.count_launch(flash_attention_bwd_dkv)
    err = lib.flash_attention_bwd_dkv_launch(*ptrs, dk.data_ptr(),
                                             dv.data_ptr(), *ints, *tail)
    build.check(lib, "flash_attention_bwd", err)
    return dk, dv


# ------------------------------------------------------------ plain versions

def _dense_masks(S, Sk, mask, alibi_slopes, window, device):
    """The ALiBi bias and the window mask materialized, as the JAX
    wrapper's ``_reference_fallback`` builds them."""
    bias = None
    if alibi_slopes is not None:
        bias = alibi_bias_from_slopes(alibi_slopes, S, Sk, device=device)
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).to(torch.bool)
    if window:
        wmask = window_mask(S, Sk, window, device=device)
        mask = wmask if mask is None else mask & wmask
    return bias, mask


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              causal: bool = True,
                              sm_scale: Optional[float] = None,
                              mask=None,
                              alibi_slopes=None,
                              window: int = 0,
                              softcap: float = 0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward -> (o, lse): the JAX ``_reference_fallback``
    (ALiBi bias and window mask materialized, ``mha_reference`` math) and
    the logsumexp of its masked f32 logits."""
    bias, mask = _dense_masks(q.shape[-2], k.shape[-2], mask, alibi_slopes,
                              window, q.device)
    logits = masked_logits(q, k, causal=causal, bias=bias, mask=mask,
                           sm_scale=sm_scale, softcap=softcap)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(ct), v.to(ct)), lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True,
                                  sm_scale: Optional[float] = None,
                                  mask=None,
                                  alibi_slopes=None,
                                  window: int = 0,
                                  softcap: float = 0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch backward -> (dq, dk, dv): the TPU kernels' formula on
    the dense masked f32 logits s (:func:`masked_logits`, the forward's
    pipeline): p = exp(s - lse), exactly 0 where s is masked (so a row with
    no live key gets zero gradients), dp = dO V^T, dS = p (dp - delta)
    dsoft scale with delta = rowsum(dO * O) and dsoft the softcap's
    derivative 1 - tanh^2, P and dS rounded to the value dtype before dV =
    P^T dO, dK = dS^T Q, dQ = dS K; products summed in f32."""
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(D))
    bias, mask = _dense_masks(q.shape[-2], k.shape[-2], mask, alibi_slopes,
                              window, q.device)
    s = masked_logits(q, k, causal=causal, bias=bias, mask=mask,
                      sm_scale=scale, softcap=softcap)
    f32 = torch.float32
    p = torch.where(s > 0.5 * NEG_INF,
                    torch.exp(s - lse.to(f32)[..., None]),
                    torch.zeros((), dtype=f32, device=s.device))
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    delta = (dof * o.to(f32)).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta)
    if softcap:
        raw = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        ds = ds * (1.0 - torch.tanh(raw / softcap) ** 2)
    ds = ds * scale
    pr = p.to(v.dtype).to(f32)                      # P, dS in the value dtype
    dsr = ds.to(q.dtype).to(f32)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsr, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", pr, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
