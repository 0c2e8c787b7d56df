"""Attention entry points of the serving slice (counterpart of
``deepspeed_tpu/ops/attention.py``: ``apply_softcap`` and the
``paged_attention`` dispatch)."""

from __future__ import annotations

from typing import Optional

import torch


def apply_softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit softcapping: tanh(x / cap) * cap, computed in f32."""
    return torch.tanh(x.to(torch.float32) / cap) * cap


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
