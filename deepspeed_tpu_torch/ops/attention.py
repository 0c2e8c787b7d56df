"""Attention helpers (counterpart of ``deepspeed_tpu/ops/attention.py``):
the plain masks and biases, ``mha_reference`` (the oracle the flash
kernels' plain versions are built from), ``apply_softcap``, the
``paged_attention`` dispatch of the serving path,
``sliding_window_attention`` (the block-sparse kernels' window route),
the ``attention`` router of the training model, and the head-dim and
dtype gate that every CUDA attention kernel's wrapper shares.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -1e30
_DROPOUT_LOGGED = False

# What the CUDA attention kernels take (ops/csrc/*attention*.cu): any head
# dim D % 8 == 0 (as the TPU kernels do), in these dtypes; the value is the
# dtype code of their C entry points.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def head_dim_reason(D: int) -> Optional[str]:
    """None if the attention kernels take head dim ``D``, else why not:
    they take any ``D % 8 == 0`` from 8 on. The JAX flash wrapper sends
    other head dims to its jnp reference; the port raises on CUDA instead of
    switching quietly to the plain version (ROADMAP.md, documented
    divergences)."""
    if D % 8 or D < 8:
        return (f"head_dim {D} (the attention kernels take D % 8 == 0 from "
                "8 on; the JAX wrapper's quiet switch to its reference is "
                "not carried over, ROADMAP.md documented divergences)")
    return None


def check_kernel_inputs(name: str, D: int, *dtypes: torch.dtype) -> int:
    """Raise unless the attention kernels take head dim ``D`` (ValueError)
    and ``dtypes``, all alike (TypeError). A pure function of the shape and
    the dtypes, the same on every device; returns the dtype code."""
    reason = head_dim_reason(D)
    if reason is not None:
        raise ValueError(f"{name} kernel: {reason}")
    if dtypes[0] not in KERNEL_DTYPES:
        raise TypeError(f"{name} kernel: dtype {dtypes[0]} (expected "
                        "float32, bfloat16 or float16)")
    if any(dt != dtypes[0] for dt in dtypes[1:]):
        raise TypeError(f"{name} kernel: dtypes {', '.join(map(str, dtypes))} "
                        "differ")
    return KERNEL_DTYPES[dtypes[0]]


def causal_mask(q_len: int, k_len: int, device=None) -> torch.Tensor:
    """[q_len, k_len] bool mask, True = attend, aligned bottom-right: query
    i sits at position i + k_len - q_len, so the last row sees every key."""
    offset = k_len - q_len
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(k_len, device=device)[None, :]
    return k_pos <= q_pos + offset


def apply_softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit softcapping: tanh(x / cap) * cap, computed in f32."""
    return torch.tanh(x.to(torch.float32) / cap) * cap


def alibi_bias_from_slopes(slopes, q_len: int, k_len: int,
                           device=None) -> torch.Tensor:
    """[H] per-head slopes -> [1, H, q_len, k_len] additive f32 ALiBi bias
    slope * (k_pos - q_pos), query positions aligned bottom-right as in
    :func:`causal_mask`."""
    sl = torch.as_tensor(slopes, dtype=torch.float32,
                         device=device).reshape(-1)
    q_pos = torch.arange(q_len, device=sl.device) + (k_len - q_len)
    k_pos = torch.arange(k_len, device=sl.device)
    dist = (k_pos[None, :] - q_pos[:, None]).to(torch.float32)
    return sl[None, :, None, None] * dist[None, None]


def window_mask(q_len: int, k_len: int, window: int,
                device=None) -> torch.Tensor:
    """[1, 1, q_len, k_len] bool sliding-window mask (True = attend):
    q_pos - k_pos < window, query positions aligned as in
    :func:`causal_mask`."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (k_len - q_len)
    k_pos = torch.arange(k_len, device=device)[None, :]
    return (q_pos - k_pos < window)[None, None]


def masked_logits(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  sm_scale: Optional[float] = None,
                  softcap: float = 0.0) -> torch.Tensor:
    """The f32 logits :func:`mha_reference` softmaxes: q k^T in the
    inputs' dtype, then f32 times the scale, softcap, the additive bias,
    and -1e30 where the causal mask or ``mask`` (True = attend) drops an
    entry. [B, H, q_len, k_len]."""
    q_len, head_dim = q.shape[-2:]
    k_len = k.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(head_dim))
    ct = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)).to(
        torch.float32) * scale
    if softcap:
        logits = apply_softcap(logits, softcap)
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=logits.device)
    if causal:
        logits = torch.where(causal_mask(q_len, k_len, logits.device)[None, None],
                             logits, neg)
    if mask is not None:
        logits = torch.where(torch.as_tensor(mask, device=logits.device)
                             .to(torch.bool), logits, neg)
    return logits


class HeadSlice(NamedTuple):
    """A dropout generator whose mask is drawn over ``total`` heads (dim
    1) and cut to heads ``[lo, lo + x.shape[1])``: a tensor-parallel
    rank's share of the whole model's mask."""

    generator: torch.Generator
    lo: int
    total: int


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): keep each entry with
    probability 1 - rate, drawn from ``generator`` (on x's device; a
    :class:`HeadSlice` draws the whole heads' mask and keeps its slice),
    and scale the kept ones by 1 / (1 - rate). Identity at rate 0 or
    without a generator."""
    if rate <= 0.0 or generator is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = tuple(x.shape)
    if isinstance(generator, HeadSlice):
        whole = shape[:1] + (generator.total,) + shape[2:]
        keep = torch.rand(whole, generator=generator.generator,
                          device=x.device, dtype=torch.float32).narrow(
            1, generator.lo, shape[1]) < 1.0 - rate
    else:
        keep = torch.rand(shape, generator=generator, device=x.device,
                          dtype=torch.float32) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  sm_scale: Optional[float] = None,
                  dropout_rate: float = 0.0,
                  dropout_rng: Optional[torch.Generator] = None,
                  softcap: float = 0.0) -> torch.Tensor:
    """Multi-head attention, plain PyTorch. q, k, v: [batch, heads, seq,
    head_dim]; f32 softmax over :func:`masked_logits`, P cast to q's
    dtype before P V. A row with no live key softmaxes to uniform weights,
    as in the JAX reference. ``dropout_rate`` > 0 with a ``dropout_rng``
    (a ``torch.Generator`` on q's device) drops attention probabilities
    (Bernoulli keep, scaled by 1 / (1 - rate)), as the JAX reference does
    with its key."""
    logits = masked_logits(q, k, causal=causal, bias=bias, mask=mask,
                           sm_scale=sm_scale, softcap=softcap)
    probs = dropout(torch.softmax(logits, dim=-1), dropout_rate,
                    dropout_rng).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(ct), v.to(ct))


def paged_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                    sm_scale: Optional[float] = None,
                    alibi_slopes=None,
                    softcap: float = 0.0,
                    window=None,
                    layer_idx=None,
                    k_scale=None,
                    v_scale=None,
                    q_start=None,
                    impl: str = "auto") -> torch.Tensor:
    """q [B, nh, T, hd] against a block pool ([L?, nh, num_blocks,
    block_size, hd]) through ``block_tables`` [B, max_blocks] and
    ``context_lens`` [B].

    Decode (T == 1) goes to ``ops.paged_attention.paged_attention``: the
    CUDA kernel for CUDA tensors, its plain version for CPU tensors. The
    query position is ctx - 1 by the decode contract, so ``q_start``
    carries nothing there. Prefill (T > 1, possibly with padded trailing
    queries positioned by ``q_start``) runs the plain gather on every
    device, because the JAX package computes prefill outside any Pallas
    kernel too. ``impl="reference"`` forces the plain version."""
    from .paged_attention import paged_attention as _decode
    from .paged_attention import paged_attention_reference
    kw = dict(sm_scale=sm_scale, alibi_slopes=alibi_slopes, softcap=softcap,
              window=window, layer_idx=layer_idx, k_scale=k_scale,
              v_scale=v_scale)
    if impl not in ("auto", "reference"):
        raise ValueError(f"paged_attention impl {impl!r}: expected 'auto' "
                         "or 'reference'")
    if impl == "auto" and q.shape[2] == 1:
        return _decode(q, k_pool, v_pool, block_tables, context_lens, **kw)
    return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                     context_lens, q_start=q_start, **kw)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int, *,
                             sm_scale: Optional[float] = None
                             ) -> torch.Tensor:
    """Causal sliding-window attention on the block-sparse kernels: the
    layout visits only the tiles that meet the window (compute and K/V
    loads scale with the window, not the sequence) and the kernels apply
    the exact per-token window q_pos - k_pos < window inside a tile (the
    JAX package's ``sliding_window_attention``). Raises ``ValueError`` for
    shapes the kernels do not take; :func:`sliding_window_tileable` says so
    beforehand."""
    from .block_sparse_attention import block_sparse_flash_attention
    from .sparse_attention import config_layout
    cfg, fine = _window_config(q, window)
    # the window and causal masks define the pattern exactly, so the
    # kernels skip the per-element layout lookup (layout_exact=False)
    return block_sparse_flash_attention(
        q, k, v, config_layout(cfg, q.shape[-2]), fine, causal=True,
        sm_scale=sm_scale, window=window, layout_exact=False)


def _window_config(q: torch.Tensor, window: int):
    """The LocalSlidingWindow layout of the window route and its block."""
    from .sparse_attention import LocalSlidingWindowSparsityConfig
    S = q.shape[-2]
    fine = 64 if S % 64 == 0 else 16
    w_blocks = -(-(window - 1) // fine) + 1 if window > 1 else 1
    return LocalSlidingWindowSparsityConfig(
        num_heads=q.shape[1], block=fine,
        num_sliding_window_blocks=w_blocks,
        attention="unidirectional"), fine


def sliding_window_tileable(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> bool:
    """Whether :func:`sliding_window_attention` takes these inputs (the
    window itself never matters): a pure shape check, the same on every
    device."""
    from .block_sparse_attention import tileable
    if q.dim() != 4 or q.shape[-2] % 16:
        return False
    return tileable(q, k, v, _window_config(q, 1)[1]) is None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              alibi_slopes=None,
              sm_scale: Optional[float] = None,
              dropout_rate: float = 0.0,
              dropout_rng: Optional[torch.Generator] = None,
              impl: str = "auto",
              window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """Dispatching attention entry point (the JAX package's ``attention``).
    Shapes: [batch, heads, seq, head_dim]; differentiable.

    ``impl="ring"`` / ``"ulysses"``: sequence parallelism
    (``parallel/ring_attention.py``), q, k and v this rank's chunk of the
    sequence split over the mesh's ``seq`` axis. A ring or Ulysses call
    with a mask, bias, ALiBi, window, softcap or dropout routes as "auto"
    at seq-world 1 and raises ``NotImplementedError`` above it: the JAX
    router sends such calls to its reference over the global sequence,
    which in the port would attend within one rank's chunk, a wrong
    answer (ROADMAP.md Queue 3).

    A pure causal sliding window (no mask, bias, ALiBi, softcap or
    dropout) with ``impl`` "auto" or "flash" goes to
    :func:`sliding_window_attention`, the block-sparse kernels, when they
    take the shapes (:func:`sliding_window_tileable`), as the JAX package
    sends it there on a TPU. Other kernel-capable calls (no dropout, no
    generic additive ``bias``, no non-causal window), and a window the
    block-sparse kernels cannot take, go to
    ``ops.flash_attention.flash_attention``. Whatever the device: the
    wrappers launch the CUDA kernels for CUDA tensors and run their plain
    versions for CPU tensors. Other calls, ``impl="reference"`` and
    ``impl="sparse"`` (whose layout the model's ``Block`` applies; here it
    falls through as in the JAX router) run ``mha_reference`` with the
    ALiBi bias and the window mask materialized (a non-kernel-capable
    "flash" call warns first, as in the JAX package). Attention dropout
    (``dropout_rate`` > 0, drawn from ``dropout_rng``) has no kernel path
    in either package: the JAX router sends it to its reference, and so
    does this one on every device, counting each such call in
    ``attention.plain_calls``."""
    window = 0 if window is None or window <= 0 else int(window)
    if impl not in ("auto", "flash", "reference", "sparse", "ring",
                    "ulysses"):
        raise ValueError(f"attention impl {impl!r}: expected 'auto', "
                         "'flash', 'reference', 'ring', 'ulysses' or "
                         "'sparse'")
    if impl in ("ring", "ulysses"):
        extras = [name for name, on in (
            ("mask", mask is not None), ("bias", bias is not None),
            ("ALiBi", alibi_slopes is not None),
            ("dropout", dropout_rate > 0.0), ("window", bool(window)),
            ("softcap", bool(softcap))) if on]
        if not extras:
            from ..parallel import ring_attention as ra
            fn = ra.ring_attention if impl == "ring" else \
                ra.ulysses_attention
            return fn(q, k, v, causal=causal, sm_scale=sm_scale)
        from .. import comm
        sp = comm.axis_size("seq") if comm.is_initialized() else 1
        if sp > 1:
            raise NotImplementedError(
                f"attention impl={impl!r} with {', '.join(extras)} at "
                f"seq-world {sp}: the JAX router's reference fallback would "
                "attend within this rank's chunk only (ROADMAP.md Queue 3)")
        impl = "auto"
    kernel_capable = (dropout_rate == 0.0 and bias is None
                      and (window == 0 or causal))
    pure_window = (window and causal and mask is None and bias is None
                   and alibi_slopes is None and softcap == 0.0
                   and dropout_rate == 0.0)
    if impl in ("auto", "flash") and pure_window \
            and sliding_window_tileable(q, k, v):
        return sliding_window_attention(q, k, v, window, sm_scale=sm_scale)
    if impl == "flash" and not kernel_capable:
        from ..utils.logging import logger
        logger.warning("attention impl='flash' has no kernel path for "
                       "dropout, a generic bias or a non-causal window; "
                       "falling back to reference")
    if impl in ("auto", "flash") and kernel_capable:
        from .flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               mask=mask, alibi_slopes=alibi_slopes,
                               window=window, softcap=softcap)
    if dropout_rate > 0.0:
        global _DROPOUT_LOGGED
        if not _DROPOUT_LOGGED:
            _DROPOUT_LOGGED = True
            from ..utils.logging import logger
            logger.info("attention dropout: the plain attention path "
                        "(mha_reference) on every device, as the JAX "
                        "router sends it to its reference")
        attention.plain_calls += 1
    if alibi_slopes is not None:
        ali = alibi_bias_from_slopes(alibi_slopes, q.shape[-2], k.shape[-2],
                                     device=q.device)
        bias = ali if bias is None else bias + ali
    if window:
        wmask = window_mask(q.shape[-2], k.shape[-2], window, device=q.device)
        mask = wmask if mask is None else \
            torch.as_tensor(mask, device=q.device).to(torch.bool) & wmask
    return mha_reference(q, k, v, causal=causal, bias=bias, mask=mask,
                         sm_scale=sm_scale, dropout_rate=dropout_rate,
                         dropout_rng=dropout_rng, softcap=softcap)


attention.plain_calls = 0
