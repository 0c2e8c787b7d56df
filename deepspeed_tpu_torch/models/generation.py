"""KV-cache decode and autoregressive generation (counterpart of
``deepspeed_tpu/models/generation.py``).

The cache is a dict of preallocated tensors ``[L, B, nh, max_len, hd]``
(:func:`init_cache`) plus ``pos``, a python int, so the generation loop
never waits on the device to learn where to write. :func:`forward_with_cache`
runs T new tokens through every layer against it and :func:`generate`
is the prefill-then-decode loop, written as a host Python loop over that
function (the JAX package compiles the same loop into one program).

Attention routing depends only on the call, never on the device; the
kernel wrappers then choose by tensor device (CUDA launches the kernel,
CPU runs its plain version), so the CPU tests walk the card's routes:

* the prefill of an empty cache (``prefill_flash``, T > 1, no left pad, a
  bf16/f32 cache, one window for every layer) -> ``ops.flash_attention``;
* every other call with T <= 64, no left pad and a bf16/f32 cache ->
  ``ops.decode_attention``;
* ragged (left-padded) batches, the int8 cache, mixed per-layer windows
  on a prefill, T > 64 without the flash prefill, and
  ``attention_impl == "reference"`` -> the plain cache path
  (``decode_attention_reference``), as the JAX package computes each of
  these outside any Pallas kernel.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..quant_format import kv_quantize
from .transformer import TransformerConfig

PyTree = Any


def _layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float,
                rms: bool = False) -> torch.Tensor:
    """LayerNorm / RMSNorm computed in f32, returned in x's dtype."""
    xf = x.to(torch.float32)
    if rms:
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * p["scale"]).to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _kernel_of(p: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """Matmul weight in ``dtype``, dequantizing the int8 weight-only forms:
    blockwise ``kernel_qscale`` (q [..., Kp, N] int8, scales
    [..., Kp/block, N] f32: w[i, n] = q[i, n] * s[i // block, n]) or
    per-output-channel ``kernel_scale``. The served path sends blockwise
    kernels to the ``quant_matmul`` kernel instead (see :func:`_dense`)."""
    k = p["kernel"]
    if "kernel_qscale" in p:
        s = p["kernel_qscale"]
        nkb = s.shape[-2]
        qb = k.shape[-2] // nkb
        w = (k.to(torch.float32).reshape(
                k.shape[:-2] + (nkb, qb, k.shape[-1]))
             * s[..., :, None, :])
        return w.reshape(k.shape).to(dtype)
    if "kernel_scale" in p:
        return (k.to(torch.float32) * p["kernel_scale"]).to(dtype)
    return k.to(dtype)


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor],
           impl: str = "auto") -> torch.Tensor:
    """x @ W (+ bias). Blockwise-int8 kernels go through ``quant_matmul``
    (the hand-written kernel for CUDA tensors; ``impl="reference"`` forces
    its plain version); every other weight is a plain ``torch.matmul``,
    as the JAX package left it to XLA, through ``checkpoint_name.dot``
    (``x @ W``, whose output a "dots" remat region keeps)."""
    if "kernel_qscale" in p:
        from ..ops.quant_matmul import quant_matmul
        y = quant_matmul(x, p["kernel"], p["kernel_qscale"], impl=impl)
    else:
        from ..ops.checkpoint_name import dot
        y = dot(x, _kernel_of(p, x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def check_decodable(cfg: TransformerConfig) -> None:
    """Raise for the models that the cache and paged paths cannot run:
    post-LN encoders and MoE (as the JAX package's decode raises for
    post-LN), and encoders without an LM head, which have no logits to
    decode with."""
    if cfg.post_ln:
        raise NotImplementedError("post-LN encoders (BERT) do not decode")
    if cfg.no_lm_head:
        raise ValueError(
            "a no_lm_head model (an encoder such as the CLIP text model) "
            "returns hidden states and has no logits to decode with")
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "MoE decode and serving (models/generation._moe_mlp) are not "
            "ported yet; see ROADMAP.md")


def ensure_scan_layout(params: PyTree, num_layers: int) -> PyTree:
    """Restack a per-layer tree (blocks_0..blocks_{L-1}) into the scan
    layout (``blocks`` leaves [L, ...]) that the decode path consumes."""
    if "blocks" in params:
        return params
    names = [f"blocks_{i}" for i in range(num_layers)]
    missing = [n for n in names if n not in params]
    if missing:
        raise ValueError(
            f"params have neither 'blocks' (scan layout) nor all of "
            f"blocks_0..blocks_{num_layers - 1} (missing {missing[:3]}...); "
            "cannot build the decode layout")

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return torch.stack(nodes)

    rest = {k: v for k, v in params.items() if k not in names}
    return {**rest, "blocks": stack(*(params[n] for n in names))}


# cache lengths round up to this multiple (the JAX package's tiling of its
# decode kernel); positions past the logical end are masked, never read
KV_CACHE_ROUND = 256


def padded_cache_len(n: int) -> int:
    return -(-n // KV_CACHE_ROUND) * KV_CACHE_ROUND


def init_cache(cfg: TransformerConfig, batch_size: int, max_len: int,
               dtype=None, pad_lens=None, device=None) -> Dict[str, Any]:
    """Preallocated KV cache: ``k``/``v`` [L, B, nh, max_len, hd] zeros in
    ``dtype`` (default ``cfg.dtype``) and ``pos`` = 0, a python int.

    ``dtype=torch.int8``: int8 rows with one f32 scale per (layer, batch,
    head, position) in ``k_scale``/``v_scale`` [L, B, nh, max_len, 1]
    (``quant_format.kv_quantize``). ``pad_lens`` [B]: left-pad lengths of
    a ragged batch, kept as ``pad``: slots below ``pad[b]`` are dead for
    sample b and logical positions are slot - pad."""
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, batch_size, cfg.num_heads, max_len, cfg.head_dim)
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    cache: Dict[str, Any] = {"k": zeros(shape, dtype),
                             "v": zeros(shape, dtype), "pos": 0}
    if dtype == torch.int8:
        cache["k_scale"] = zeros(shape[:-1] + (1,), torch.float32)
        cache["v_scale"] = zeros(shape[:-1] + (1,), torch.float32)
    if pad_lens is not None:
        cache["pad"] = torch.as_tensor(pad_lens, device=device).to(
            torch.int64).reshape(batch_size)
    return cache


def forward_with_cache(cfg: TransformerConfig, params: PyTree,
                       input_ids: torch.Tensor, cache: Dict[str, Any],
                       prefer_kernel: Optional[bool] = None,
                       prefill_flash: bool = False,
                       *,
                       impl: str = "auto"
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run T_new tokens at cache positions [pos, pos + T_new). Returns
    (logits [B, T_new, V] f32, cache). Params must be in the scan layout
    (``ensure_scan_layout``).

    The cache is written IN PLACE (slice assignment into its tensors) and
    ``cache["pos"]`` advances: torch has no buffer donation, and a copy of
    the cache per token would double its memory and traffic. The same dict
    is returned.

    ``prefill_flash``: the caller guarantees the cache is empty (pos ==
    0); the prefill attention then runs the flash kernel over the fresh
    K/V. ``prefer_kernel`` is accepted for the JAX signature and ignored:
    the JAX package's B / max_len regime heuristic for its decode kernel
    was measured on a TPU v5e and says nothing about this card, so every
    eligible call takes the kernel (see the module docstring).
    ``impl="reference"`` (or ``cfg.attention_impl == "reference"``) sends
    all attention to the plain cache path."""
    del prefer_kernel
    check_decodable(cfg)
    if "blocks" not in params:
        raise ValueError(
            "forward_with_cache needs scan-layers params (a 'blocks' subtree "
            "stacked [L, ...]); restack with "
            "models.generation.ensure_scan_layout(params, L)")
    if impl not in ("auto", "reference"):
        raise ValueError(f"forward_with_cache impl {impl!r}: expected 'auto' "
                         "or 'reference'")
    from ..ops.attention import apply_softcap
    from ..ops.decode_attention import (MAX_T, decode_attention,
                                        decode_attention_reference)
    from ..ops.flash_attention import flash_attention
    from .transformer import _ACTIVATIONS, alibi_slopes, apply_rotary
    B, T_new = input_ids.shape
    dev = input_ids.device
    input_ids = input_ids.to(torch.long)
    pos = int(cache["pos"])
    k_all, v_all = cache["k"], cache["v"]
    L, max_len = cfg.num_layers, k_all.shape[3]
    if pos + T_new > max_len:
        raise ValueError(f"cache of {max_len} positions cannot take "
                         f"{T_new} tokens at position {pos}")
    nh, hd, kvh = cfg.num_heads, cfg.head_dim, cfg.kv_heads
    rms = cfg.norm == "rmsnorm"
    eps = cfg.layer_norm_eps
    act = _ACTIVATIONS[cfg.activation]
    sm_scale = (cfg.attn_scale if cfg.attn_scale is not None
                else 1.0 / float(np.sqrt(hd)))
    dense = partial(_dense, impl=impl)

    wte = params["wte"]["embedding"]
    x = wte.to(cfg.dtype)[input_ids]
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    q_abs = pos + torch.arange(T_new, device=dev)           # cache slots [T]
    pad = cache.get("pad")                                  # [B] left pads
    # logical positions: slot - pad for a left-padded ragged batch
    q_log = (torch.clamp(q_abs[None, :] - pad[:, None], min=0)
             if pad is not None else q_abs)
    if cfg.pos_embed == "learned":
        wpe = params["wpe"]["embedding"].to(cfg.dtype)
        x = x + (wpe[q_log] if pad is not None else wpe[q_log][None])
    if cfg.embed_ln:
        x = _layer_norm(x, params["ln_emb"], eps, rms)

    slopes = (torch.as_tensor(alibi_slopes(nh), dtype=torch.float32,
                              device=dev)
              if cfg.pos_embed == "alibi" else None)
    windows = ([int(w) for w in cfg.layer_windows]
               if cfg.layer_windows is not None else [0] * L)
    inv_freq = cfg.rope_inv_freq(max_len)
    quant_kv = k_all.dtype == torch.int8
    kernels = impl == "auto" and cfg.attention_impl in ("auto", "flash")
    uniform_window = cfg.uniform_window()
    use_flash = (kernels and bool(prefill_flash) and T_new > 1
                 and pad is None and not quant_kv
                 and uniform_window is not None)
    use_decode = (kernels and not use_flash and T_new <= MAX_T
                  and pad is None and not quant_kv)
    cur_len = pos + T_new
    write = slice(pos, cur_len)

    blocks = params["blocks"]
    for li in range(L):
        p = {name: {k: t[li] for k, t in sub.items()}
             for name, sub in blocks.items()}
        h = _layer_norm(x, p["ln1"], eps, rms)
        qkv = dense(h, p["attn_qkv"])
        q, k, v = torch.split(qkv, [nh * hd, kvh * hd, kvh * hd], dim=-1)
        to_heads = lambda t, n: t.reshape(B, T_new, n, hd).transpose(1, 2)
        q, k, v = to_heads(q, nh), to_heads(k, kvh), to_heads(v, kvh)
        if cfg.qk_norm:
            q = _layer_norm(q, p["q_norm"], eps, rms=True)
            k = _layer_norm(k, p["k_norm"], eps, rms=True)
        if cfg.pos_embed == "rotary":
            q = apply_rotary(q, q_log, cfg.rotary_dim, cfg.rotary_interleaved,
                             cfg.rope_theta, inv_freq=inv_freq)
            k = apply_rotary(k, q_log, cfg.rotary_dim, cfg.rotary_interleaved,
                             cfg.rope_theta, inv_freq=inv_freq)
        if kvh != nh:
            # GQA: repeat kv to all heads BEFORE the cache write, so the
            # cache keeps the JAX layout [L, B, nh, len, hd]
            k = torch.repeat_interleave(k, nh // kvh, dim=1)
            v = torch.repeat_interleave(v, nh // kvh, dim=1)
        if quant_kv:
            (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
            k_all[li, :, :, write] = kq
            v_all[li, :, :, write] = vq
            cache["k_scale"][li, :, :, write] = ks
            cache["v_scale"][li, :, :, write] = vs
        else:
            k_all[li, :, :, write] = k.to(k_all.dtype)
            v_all[li, :, :, write] = v.to(v_all.dtype)
        if use_flash:
            # an empty cache: attention over the fresh k/v is exactly the
            # causal prefill, and arange positions equal the cache slots
            o = flash_attention(q, k, v, causal=True, sm_scale=sm_scale,
                                window=uniform_window,
                                softcap=cfg.attn_softcap,
                                alibi_slopes=slopes)
        elif use_decode:
            o = decode_attention(q, k_all, v_all, cur_len,
                                 window=windows[li], sm_scale=sm_scale,
                                 layer_idx=li, alibi_slopes=slopes,
                                 softcap=cfg.attn_softcap)
        else:
            scales = ({"k_scale": cache["k_scale"],
                       "v_scale": cache["v_scale"]} if quant_kv else {})
            o = decode_attention_reference(
                q, k_all, v_all, cur_len, window=windows[li],
                sm_scale=sm_scale, layer_idx=li, alibi_slopes=slopes,
                softcap=cfg.attn_softcap, pad=pad, **scales)
        o = o.transpose(1, 2).reshape(B, T_new, nh * hd)
        attn_out = dense(o, p["attn_proj"])
        if cfg.post_block_norms:
            attn_out = _layer_norm(attn_out, p["post_attn_norm"], eps, rms)

        def mlp(hin):
            if cfg.gated_mlp:
                g = act(dense(hin, p["mlp_gate"]))
                return dense(g * dense(hin, p["mlp_fc"]), p["mlp_proj"])
            return dense(act(dense(hin, p["mlp_fc"])), p["mlp_proj"])

        if cfg.parallel_residual:
            m_in = (_layer_norm(x, p["ln2"], eps, rms)
                    if cfg.parallel_residual_dual_ln else h)
            x = x + attn_out + mlp(m_in)
        else:
            x_mid = x + attn_out
            m = mlp(_layer_norm(x_mid, p["ln2"], eps, rms))
            if cfg.post_block_norms:
                m = _layer_norm(m, p["post_mlp_norm"], eps, rms)
            x = x_mid + m
    x = _layer_norm(x, params["ln_f"], eps, rms)
    if cfg.tie_embeddings:
        logits = torch.einsum("bth,vh->btv", x, wte.to(x.dtype))
    else:
        logits = dense(x, params["lm_head"])
    if cfg.final_logit_softcap:
        logits = apply_softcap(logits, cfg.final_logit_softcap)
    cache["pos"] = cur_len
    return logits.to(torch.float32), cache


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter (HF TopPLogitsWarper): keep the smallest prefix of
    the descending distribution whose mass reaches ``top_p``; the top
    token always survives. Masking is positional in the (stable) sorted
    order, so tied logits at the boundary keep the sorted-prefix count."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p       # mass BEFORE the entry
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, -1e30))


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """CTRL-style (HF RepetitionPenaltyLogitsProcessor): every seen token's
    positive logit divides by the penalty, a negative one multiplies."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: Optional[int],
            top_p: Optional[float] = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B]: argmax at temperature 0, else a
    draw from ``generator`` after temperature, top-k and top-p (the HF
    processor order). The draws differ from the JAX package's
    ``jax.random`` stream by design; the filters are the same."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    if top_p is not None and top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(cfg: TransformerConfig,
             params: PyTree,
             input_ids: torch.Tensor,
             max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             repetition_penalty: Optional[float] = None,
             attention_mask=None,
             kv_cache_dtype: Optional[str] = None) -> torch.Tensor:
    """Prefill, then one token per step: input_ids [B, T_prompt] ->
    [B, T_prompt + max_new_tokens] (int64).

    ``attention_mask`` [B, T_prompt]: prompts must be LEFT-padded (0s then
    1s per row; a right-padded mask raises). An all-ones mask is dropped,
    so a uniform batch keeps the kernels. Sampling: ``temperature``,
    ``top_k``, ``top_p`` in the HF order, drawn from ``generator`` (default:
    a generator on the ids' device seeded 0); ``repetition_penalty``
    rescales every token already in the sample's prompt (pads included) or
    output. ``kv_cache_dtype="int8"``: the int8 cache."""
    if attention_mask is not None:
        mask_np = np.asarray(torch.as_tensor(attention_mask).cpu(),
                             dtype=np.int32)
        if not (np.diff(mask_np, axis=1) >= 0).all():
            raise ValueError(
                "generate() requires LEFT-padded prompts: every "
                "attention_mask row must be non-decreasing (0s then 1s). "
                "Re-tokenize with padding_side='left'.")
        attention_mask = (None if mask_np.all() else
                          torch.as_tensor(mask_np, device=input_ids.device))
    return _generate(cfg, params, input_ids, max_new_tokens, temperature,
                     generator, top_k, top_p, repetition_penalty,
                     attention_mask, kv_cache_dtype)


def _generate(cfg, params, input_ids, max_new_tokens, temperature,
              generator, top_k, top_p, repetition_penalty, attention_mask,
              kv_cache_dtype):
    B, T_in = input_ids.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens {max_new_tokens}: expected >= 1")
    max_len = T_in + max_new_tokens
    if max_len > cfg.max_seq_len:
        raise ValueError(f"generation length {max_len} exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: expected None "
                         "or 'int8'")
    dev = input_ids.device
    ids = input_ids.to(torch.long)
    params = ensure_scan_layout(params, cfg.num_layers)
    pad_lens = None
    if attention_mask is not None:
        pad_lens = T_in - attention_mask.to(torch.long).sum(dim=1)
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = init_cache(cfg, B, padded_cache_len(max_len),
                       dtype=torch.int8 if kv_cache_dtype == "int8" else None,
                       pad_lens=pad_lens, device=dev)
    rep = repetition_penalty is not None and repetition_penalty != 1.0
    seen = None
    if rep:
        # every prompt token, pads included (HF penalizes the pad id of a
        # left-padded batch too), then each generated token
        seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev)
        seen.scatter_(1, ids, True)

    def pick(logits_last):
        if rep:
            logits_last = apply_repetition_penalty(logits_last, seen,
                                                   repetition_penalty)
        tok = _sample(logits_last, generator, temperature, top_k, top_p)
        if rep:
            seen.scatter_(1, tok[:, None], True)
        return tok

    with torch.no_grad():
        # the first forward runs against the empty cache: the prefill
        # attention takes the flash kernel where eligible
        logits, cache = forward_with_cache(cfg, params, ids, cache,
                                           prefill_flash=True)
        toks = [pick(logits[:, -1])]
        for _ in range(max_new_tokens - 1):
            logits, cache = forward_with_cache(cfg, params, toks[-1][:, None],
                                               cache)
            toks.append(pick(logits[:, -1]))
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
