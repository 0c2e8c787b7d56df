"""Transformer configuration, presets and the position helpers.

Counterpart of the config half of ``deepspeed_tpu/models/transformer.py``:
``TransformerConfig`` (every field, same names and defaults, with torch
dtypes), the presets, the activations, ``apply_rotary`` and
``alibi_slopes``. The flax modules have no counterpart yet: the serving
and generation paths run the layer math in ``serving/model_runner.py``
and ``models/generation.py`` over a plain dict of stacked parameters,
which :func:`init_params` builds from a seed.

Parameter layout (the JAX package's scan layout, names kept): dense
kernels are ``[in, out]`` so the forward computes ``x @ W``, and every
block leaf is stacked ``[L, ...]`` under ``blocks``::

    wte/embedding [V, H]      wpe/embedding [max_seq_len, H]  (learned)
    blocks/{ln1, attn_qkv, attn_proj, ln2, mlp_gate, mlp_fc, mlp_proj,
            q_norm, k_norm, post_attn_norm, post_mlp_norm}
    ln_f                      lm_head/kernel [H, V]  (untied)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Dtype = Any


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.0
    causal: bool = True
    tie_embeddings: bool = True
    use_bias: bool = True
    dtype: Dtype = torch.bfloat16  # compute dtype
    remat: bool = False
    remat_policy: str = "dots"
    scan_layers: bool = True
    fused_loss: bool = False
    loss_chunk: int = 128
    attention_impl: str = "auto"
    layer_norm_eps: float = 1e-5
    activation: str = "gelu"       # gelu (tanh) | gelu_exact | relu | silu
    attn_scale: Optional[float] = None   # None = 1/sqrt(head_dim)
    pos_embed: str = "learned"     # learned | rotary | alibi | none
    rotary_dim: int = 0            # 0 = whole head_dim
    rotary_interleaved: bool = True
    parallel_residual: bool = False
    parallel_residual_dual_ln: bool = False
    post_ln: bool = False
    embed_ln: bool = False
    token_type_vocab: int = 0
    mlm_head: bool = False
    lm_head_bias: bool = False
    no_lm_head: bool = False
    qkv_bias: Optional[bool] = None       # None = use_bias
    attn_out_bias: Optional[bool] = None  # None = use_bias
    layer_windows: Optional[Tuple[int, ...]] = None   # per layer, 0 = global
    ltd_tokens: int = 0
    ltd_start: int = 0
    ltd_end: int = 0
    pld: bool = False
    norm: str = "layernorm"        # "rmsnorm": no-mean, no-bias (Llama)
    gated_mlp: bool = False        # SwiGLU: proj(act(gate(x)) * fc(x))
    num_kv_heads: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling_type: Optional[str] = None   # "linear"|"dynamic"|"llama3"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 0
    head_dim_override: Optional[int] = None
    mlp_bias: Optional[bool] = None       # None = use_bias
    qk_norm: bool = False
    embed_scale: Optional[float] = None
    post_block_norms: bool = False
    attn_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    mlp_dim_override: Optional[int] = None
    moe_experts: int = 0
    moe_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    sparse_attention: Optional[Tuple[Tuple[str, Any], ...]] = None
    activation_quant: Optional[str] = None

    def __post_init__(self):
        if self.post_block_norms and self.parallel_residual:
            raise NotImplementedError(
                "post_block_norms (Gemma-2 sandwich) + parallel_residual "
                "is not implemented")
        if self.activation_quant not in (None, "int8", "fp8"):
            raise ValueError(
                f"activation_quant {self.activation_quant!r}: expected "
                "'int8', 'fp8' or None")

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_heads

    def uniform_window(self) -> Optional[int]:
        """The single window every layer shares when ``layer_windows`` is
        uniform: 0 for no or global windows, the window size otherwise;
        None when layers mix windows (the prefill then cannot run one
        flash kernel configuration for every layer)."""
        if self.layer_windows is None:
            return 0
        vals = {max(int(w), 0) for w in self.layer_windows}
        return vals.pop() if len(vals) == 1 else None

    @property
    def mlp_dim(self) -> int:
        if self.mlp_dim_override is not None:
            return self.mlp_dim_override
        return self.hidden_size * self.mlp_ratio

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def rope_inv_freq(self, seq_len: Optional[int] = None):
        """Static inverse-frequency table with the configured rope scaling
        (float32 numpy), or None for the plain-theta table."""
        t = self.rope_scaling_type
        if t is None or t == "default":
            return None
        rd = self.rotary_dim or self.head_dim
        inv = 1.0 / (self.rope_theta ** (np.arange(0, rd, 2,
                                                   dtype=np.float32) / rd))
        f = self.rope_scaling_factor
        orig = self.rope_original_max_position or self.max_seq_len
        if t == "linear":
            inv = inv / f
        elif t == "dynamic":
            eff = max(seq_len or self.max_seq_len, orig)
            base = self.rope_theta * (
                (f * eff / orig) - (f - 1)) ** (rd / (rd - 2))
            inv = 1.0 / (base ** (np.arange(0, rd, 2,
                                            dtype=np.float32) / rd))
        elif t == "llama3":
            lo, hi = self.rope_low_freq_factor, self.rope_high_freq_factor
            low_wl, high_wl = orig / lo, orig / hi
            wavelen = 2.0 * np.pi / inv
            inv_l = np.where(wavelen > low_wl, inv / f, inv)
            smooth = (orig / wavelen - lo) / (hi - lo)
            smoothed = (1.0 - smooth) * inv_l / f + smooth * inv_l
            is_medium = (wavelen >= high_wl) & (wavelen <= low_wl)
            inv = np.where(is_medium, smoothed, inv_l)
        else:
            raise NotImplementedError(
                f"rope_scaling type {t!r} is not implemented")
        return inv.astype(np.float32)


_PRESETS = {
    "gpt2-tiny": dict(hidden_size=128, num_layers=2, num_heads=4, vocab_size=1024,
                      max_seq_len=256),
    "gpt2-125m": dict(hidden_size=768, num_layers=12, num_heads=12),
    "gpt2-350m": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt2-760m": dict(hidden_size=1536, num_layers=24, num_heads=16),
    "gpt2-1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16),
    "gpt2-2.7b": dict(hidden_size=2560, num_layers=32, num_heads=32),
    "gpt2-6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32),
    # TinyLlama-1.1B shapes: RMSNorm + SwiGLU + GQA 32q/4kv + rotary
    "llama-1.1b": dict(hidden_size=2048, num_layers=22, num_heads=32,
                       num_kv_heads=4, mlp_dim_override=5632,
                       norm="rmsnorm", gated_mlp=True, activation="silu",
                       pos_embed="rotary", rotary_interleaved=False,
                       use_bias=False, tie_embeddings=False,
                       vocab_size=32000, max_seq_len=2048),
    "bert-base": dict(hidden_size=768, num_layers=12, num_heads=12, causal=False,
                      vocab_size=30522, max_seq_len=512),
    "bert-large": dict(hidden_size=1024, num_layers=24, num_heads=16, causal=False,
                       vocab_size=30522, max_seq_len=512),
}


def get_config(name: str, **overrides) -> TransformerConfig:
    if name not in _PRESETS:
        raise ValueError(f"unknown preset '{name}'; have {sorted(_PRESETS)}")
    kw = dict(_PRESETS[name])
    kw.update(overrides)
    return TransformerConfig(**kw)


_ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # flax nn.gelu default
    "gelu_exact": F.gelu,
    "relu": F.relu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "silu": F.silu,
}


def apply_rotary(x: torch.Tensor, positions: torch.Tensor,
                 rotary_dim: int = 0, interleaved: bool = True,
                 theta: float = 10000.0, inv_freq=None) -> torch.Tensor:
    """Rotary embedding on x [B, nh, S, hd] at positions [B, S] or [S];
    interleaved=True is GPT-J rotate_every_two, False GPT-NeoX rotate_half.
    Only the first ``rotary_dim`` channels rotate. Angles are f32."""
    B, nh, S, hd = x.shape
    rd = rotary_dim or hd
    if positions.dim() == 1:
        positions = positions[None, :]
    if inv_freq is None:
        inv_freq = 1.0 / (theta ** (torch.arange(
            0, rd, 2, device=x.device, dtype=torch.float32) / rd))
    else:
        inv_freq = torch.as_tensor(inv_freq, dtype=torch.float32,
                                   device=x.device)
    ang = positions[:, :, None].to(torch.float32) * inv_freq[None, None, :]
    sin = torch.sin(ang)[:, None, :, :]                 # [B, 1, S, rd/2]
    cos = torch.cos(ang)[:, None, :, :]
    xr = x[..., :rd].to(torch.float32)
    if interleaved:
        x1 = xr[..., 0::2]
        x2 = xr[..., 1::2]
        rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(B, nh, S, rd)
    else:
        x1 = xr[..., :rd // 2]
        x2 = xr[..., rd // 2:]
        rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), x[..., rd:]], dim=-1)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """ALiBi per-head slopes (BLOOM; HF build_alibi_tensor formula)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))
    if np.log2(num_heads).is_integer():
        return pow2_slopes(num_heads)
    base = 2 ** int(np.floor(np.log2(num_heads)))
    extra = pow2_slopes(2 * base)[0::2][:num_heads - base]
    return np.concatenate([pow2_slopes(base), extra])


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None, dtype=None) -> Dict[str, Any]:
    """Random scan-layout parameters for ``cfg`` from ``generator``'s seed.

    Kernels and embeddings are normal with std 1/sqrt(fan_in) (the scale
    of flax's lecun_normal), norm scales are 1 and biases 0. Values are
    drawn in float32 on the generator's device, then moved to ``device``
    (default: the generator's) and cast to ``dtype`` (default
    ``cfg.dtype``)."""
    if cfg.moe_experts > 0 or cfg.post_ln:
        raise NotImplementedError("init_params builds decoder blocks "
                                  "without MoE")
    gdev = generator.device
    device = torch.device(device) if device is not None else gdev
    dtype = dtype or cfg.dtype
    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    nh, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim

    def normal(*shape, fan_in):
        t = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * (fan_in ** -0.5)
        return t.to(device=device, dtype=dtype)

    def const(value, *shape):
        return torch.full(shape, value, device=device, dtype=dtype)

    def norm(*lead, width=H):
        p = {"scale": const(1.0, *lead, width)}
        if cfg.norm != "rmsnorm":
            p["bias"] = const(0.0, *lead, width)
        return p

    def dense(fan_in, fan_out, bias):
        p = {"kernel": normal(L, fan_in, fan_out, fan_in=fan_in)}
        if bias:
            p["bias"] = const(0.0, L, fan_out)
        return p

    use = lambda flag: cfg.use_bias if flag is None else flag
    blocks = {
        "ln1": norm(L),
        "attn_qkv": dense(H, (nh + 2 * kvh) * hd, use(cfg.qkv_bias)),
        "attn_proj": dense(nh * hd, H, use(cfg.attn_out_bias)),
    }
    if cfg.qk_norm:
        blocks["q_norm"] = {"scale": const(1.0, L, hd)}
        blocks["k_norm"] = {"scale": const(1.0, L, hd)}
    if not cfg.parallel_residual or cfg.parallel_residual_dual_ln:
        blocks["ln2"] = norm(L)
    if cfg.gated_mlp:
        blocks["mlp_gate"] = dense(H, cfg.mlp_dim, use(cfg.mlp_bias))
        blocks["mlp_fc"] = dense(H, cfg.mlp_dim, use(cfg.mlp_bias))
        blocks["mlp_proj"] = dense(cfg.mlp_dim, H, use(cfg.mlp_bias))
    else:
        blocks["mlp_fc"] = dense(H, cfg.mlp_dim, cfg.use_bias)
        blocks["mlp_proj"] = dense(cfg.mlp_dim, H, cfg.use_bias)
    if cfg.post_block_norms:
        blocks["post_attn_norm"] = norm(L)
        blocks["post_mlp_norm"] = norm(L)

    params: Dict[str, Any] = {"wte": {"embedding": normal(V, H, fan_in=H)},
                              "blocks": blocks, "ln_f": norm()}
    if cfg.pos_embed == "learned":
        params["wpe"] = {"embedding": normal(cfg.max_seq_len, H, fan_in=H)}
    if cfg.embed_ln:
        params["ln_emb"] = norm()
    if not cfg.tie_embeddings:
        head = {"kernel": normal(H, V, fan_in=H)}
        if cfg.lm_head_bias:
            head["bias"] = const(0.0, V)
        params["lm_head"] = head
    return params
