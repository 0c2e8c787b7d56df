"""Paged transformer forward over a block pool (counterpart of
``deepspeed_tpu/serving/model_runner.py``).

:func:`paged_forward` serves both regimes:

* **prefill** — B=1, T = the block-padded prompt (suffix): writes the
  prompt's K/V into the sequence's pool blocks and returns logits for
  every query position;
* **decode** — B = max_batch lanes, T=1: one fresh token per lane.

The layer math is the JAX package's, op for op (f32 norms and scores,
the -1e30 masks, GQA heads repeated before the pool write). Layers run as
a Python loop over the stacked ``[L, ...]`` leaves. Inactive lanes have
all-NULL block tables, so their writes land in the null block.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.generation import (_dense, _layer_norm, _moe_mlp, _row_dense,
                                 check_decodable, expand_kv, lm_logits,
                                 local_alibi_slopes, tp_embedding)
from ..models.transformer import (_ACTIVATIONS, TransformerConfig,
                                  apply_rotary, layer_params)
from ..ops.attention import paged_attention
from ..quant_format import kv_quantize

PyTree = Any


def paged_forward(cfg: TransformerConfig,
                  params: PyTree,
                  input_ids: torch.Tensor,
                  pools: Dict[str, torch.Tensor],
                  block_tables: torch.Tensor,
                  q_start: torch.Tensor,
                  context_lens: torch.Tensor,
                  block_size: int,
                  *,
                  impl: str = "auto",
                  tp=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run T tokens per lane at logical positions [q_start, q_start + T)
    against the paged pool. Returns (logits [B, T, V] f32, pools).

    input_ids: [B, T]. pools: {"k","v"} [L, nh, num_slots, hd] (+ f32
    "k_scale"/"v_scale" [L, nh, num_slots, 1] for an int8 pool, whose rows
    are quantized on write). block_tables: [B, max_blocks_per_seq] int32.
    q_start: [B] — first query's logical position (tokens below it are
    already in the pool). context_lens: [B] — valid tokens including this
    call's real queries; positions past it are padding whose K/V go to
    the null block and whose logits are never read.

    The pool tensors are updated IN PLACE (``index_copy_``) and the same
    dict is returned: torch has no buffer donation, and a copy of the pool
    per step would double its memory. ``impl="reference"`` sends the
    attention and the int8 matmuls to their plain versions. ``tp``: this
    rank's ``TPContext`` when ``params`` are its model-axis shards and
    the pools hold its heads (the Megatron layers; the logits are
    gathered, so every rank returns the whole [B, T, V])."""
    check_decodable(cfg)
    if "blocks" not in params:
        raise ValueError("paged_forward needs scan-layers params "
                         "(models.generation.ensure_scan_layout)")
    B, T = input_ids.shape
    dev = input_ids.device
    nbk = block_tables.shape[1]
    bs = int(block_size)
    k_pool, v_pool = pools["k"], pools["v"]
    quant_kv = "k_scale" in pools
    if k_pool.dtype == torch.int8 and not quant_kv:
        raise ValueError(
            "int8 KV pool without k_scale/v_scale leaves — build pools "
            "with serving.kv_cache.init_pool(dtype=torch.int8)")
    num_slots = k_pool.shape[2]
    if num_slots % bs:
        raise ValueError(f"pool slots {num_slots} not divisible by "
                         f"block_size {bs}")
    nb_pool = num_slots // bs
    L = cfg.num_layers
    nh, hd, kvh = cfg.num_heads, cfg.head_dim, cfg.kv_heads
    nh_all = nh
    if tp is not None:
        nh, kvh = tp.heads(cfg)
    rms = cfg.norm == "rmsnorm"
    eps = cfg.layer_norm_eps
    act = _ACTIVATIONS[cfg.activation]
    sm_scale = (cfg.attn_scale if cfg.attn_scale is not None
                else 1.0 / float(np.sqrt(hd)))
    dense = partial(_dense, impl=impl)
    row = partial(_row_dense, tp=tp, impl=impl)

    bt = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    q_start = q_start.to(device=dev, dtype=torch.long).reshape(B)
    ctx = context_lens.to(device=dev, dtype=torch.int32).reshape(B)

    wte = params["wte"]["embedding"]
    x = (wte.to(cfg.dtype)[input_ids] if tp is None
         else tp_embedding(input_ids, wte.to(cfg.dtype), tp))
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)

    pos = q_start[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    if cfg.pos_embed == "learned":
        wpe = params["wpe"]["embedding"].to(cfg.dtype)
        x = x + wpe[torch.clamp(pos, max=wpe.shape[0] - 1)]
    if cfg.embed_ln:
        x = _layer_norm(x, params["ln_emb"], eps, rms)

    slopes = (local_alibi_slopes(nh_all, tp, cfg, dev)
              if cfg.pos_embed == "alibi" else None)
    windows = ([int(w) for w in cfg.layer_windows]
               if cfg.layer_windows is not None else [0] * L)
    inv_freq = cfg.rope_inv_freq(nbk * bs)

    # write slots: logical position p of lane b lives in pool slot
    # bt[b, p // bs] * bs + p % bs; padded positions (>= ctx) go to the
    # null block so they cannot corrupt live state
    blk = torch.clamp(pos // bs, 0, nbk - 1)
    off = pos % bs
    phys = torch.gather(bt.long(), 1, blk)
    valid = pos < ctx[:, None]
    flat_slots = torch.where(valid, phys * bs + off, off).reshape(B * T)

    kp5 = k_pool.view(L, nh, nb_pool, bs, hd)
    vp5 = v_pool.view(L, nh, nb_pool, bs, hd)
    scale_kw = ({"k_scale": pools["k_scale"], "v_scale": pools["v_scale"]}
                if quant_kv else {})
    blocks = params["blocks"]
    for li in range(L):
        p = layer_params(blocks, li)
        h = _layer_norm(x, p["ln1"], eps, rms)
        qkv = dense(h, p["attn_qkv"])
        q, k, v = torch.split(qkv, [nh * hd, kvh * hd, kvh * hd], dim=-1)
        to_heads = lambda t, n: t.reshape(B, T, n, hd).transpose(1, 2)
        q, k, v = to_heads(q, nh), to_heads(k, kvh), to_heads(v, kvh)
        if cfg.qk_norm:
            q = _layer_norm(q, p["q_norm"], eps, rms=True)
            k = _layer_norm(k, p["k_norm"], eps, rms=True)
        if cfg.pos_embed == "rotary":
            q = apply_rotary(q, pos, cfg.rotary_dim, cfg.rotary_interleaved,
                             cfg.rope_theta, inv_freq=inv_freq)
            k = apply_rotary(k, pos, cfg.rotary_dim, cfg.rotary_interleaved,
                             cfg.rope_theta, inv_freq=inv_freq)
        # GQA: repeat kv to full heads before the pool write, so the
        # pool stays [*, nh, ...] and the paged kernel applies unchanged
        k, v = expand_kv(k, cfg, tp), expand_kv(v, cfg, tp)
        # one scatter per layer: [B, nh, T, hd] -> rows [nh, B*T, hd] into
        # the layer's flat slots
        k_rows = k.permute(1, 0, 2, 3).reshape(nh, B * T, hd)
        v_rows = v.permute(1, 0, 2, 3).reshape(nh, B * T, hd)
        if quant_kv:
            (kq, ks), (vq, vs) = kv_quantize(k_rows), kv_quantize(v_rows)
            k_pool[li].index_copy_(1, flat_slots, kq)
            v_pool[li].index_copy_(1, flat_slots, vq)
            pools["k_scale"][li].index_copy_(1, flat_slots, ks)
            pools["v_scale"][li].index_copy_(1, flat_slots, vs)
        else:
            k_pool[li].index_copy_(1, flat_slots, k_rows.to(k_pool.dtype))
            v_pool[li].index_copy_(1, flat_slots, v_rows.to(v_pool.dtype))
        o = paged_attention(q, kp5, vp5, bt, ctx, sm_scale=sm_scale,
                            alibi_slopes=slopes, softcap=cfg.attn_softcap,
                            window=windows[li], layer_idx=li,
                            q_start=q_start, impl=impl, **scale_kw)
        o = o.transpose(1, 2).reshape(B, T, nh * hd)
        attn_out = row(o, p["attn_proj"])
        if cfg.post_block_norms:
            attn_out = _layer_norm(attn_out, p["post_attn_norm"], eps, rms)

        def mlp(hin):
            if cfg.moe_experts > 0:
                return _moe_mlp(cfg, p["moe"], hin, tp)
            if cfg.gated_mlp:
                g = act(dense(hin, p["mlp_gate"]))
                return row(g * dense(hin, p["mlp_fc"]), p["mlp_proj"])
            return row(act(dense(hin, p["mlp_fc"])), p["mlp_proj"])

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
    return lm_logits(cfg, params, x, dense, tp), pools
