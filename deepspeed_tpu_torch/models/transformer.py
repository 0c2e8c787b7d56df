"""The transformer: configuration, presets, position helpers, the
trainable ``Transformer`` module and the losses.

Counterpart of ``deepspeed_tpu/models/transformer.py``:
``TransformerConfig`` (every field, same names and defaults, with torch
dtypes), the presets, the activations, ``apply_rotary``, ``alibi_slopes``
and ``alibi_bias``; ``Block`` and ``Transformer`` as ``nn.Module``s with
the block forms the HF policies produce (pre-LN and post-LN, parallel
residual with one or two norms, per-layer windows, token types, the MLM
head, no LM head); ``DeepSpeedTransformerLayer``; ``cross_entropy``,
``causal_lm_loss``, ``masked_lm_loss``, the chunked fused CE and
``build_model``. The serving and generation paths run the same layer math
(``models/generation.py``'s ``_layer_norm`` and ``_dense``) over a plain
dict of stacked parameters, which :func:`init_params` builds from a seed
and :func:`models.convert.scan_params` takes from a trained module.

Parameter layout (the JAX package's scan layout, names kept): dense
kernels are ``[in, out]`` so the forward computes ``x @ W``, and every
block leaf is stacked ``[L, ...]`` under ``blocks``::

    wte/embedding [V, H]      wpe/embedding [max_seq_len, H]  (learned)
    tte/embedding [token_type_vocab, H]   ln_emb          (encoders)
    blocks/{ln1, attn_qkv, attn_proj, ln2, mlp_gate, mlp_fc, mlp_proj,
            q_norm, k_norm, post_attn_norm, post_mlp_norm}
    ln_f (not post-LN)        lm_head/kernel [H, V]  (untied)
    mlm_transform, mlm_ln, mlm_bias [V]  (the MLM head; mlm_bias is a
                                          bare array, not a dict)

The ``Transformer`` module keeps the flax tree's names with one
``Block`` per layer: ``wte.embedding``, ``blocks.<i>.attn_qkv.kernel``
[in, out], ``ln_f.scale``, ``lm_head.kernel``, ... so the bridge to the
scan layout is a stack / unstack (``models/convert.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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

    def _embed_params(self) -> int:
        h, v = self.hidden_size, self.vocab_size
        n = v * h
        if self.pos_embed == "learned":
            n += self.max_seq_len * h
        if not self.tie_embeddings and not self.no_lm_head:
            n += v * h                        # untied lm_head
        return n

    def _attn_params(self) -> int:
        h = self.hidden_size
        return (self.num_heads + 2 * self.kv_heads) * self.head_dim * h \
            + self.num_heads * self.head_dim * h   # qkv (GQA) + out proj

    def _mlp_params(self) -> int:
        return (3 if self.gated_mlp else 2) * self.mlp_dim * self.hidden_size

    def num_params(self) -> int:
        """Matmul and embedding parameters (norms and biases left out, as
        the JAX package counts): every expert of a MoE layer, its router
        included."""
        per_layer = self._attn_params() \
            + self._mlp_params() * max(self.moe_experts, 1)
        if self.moe_experts > 0:
            per_layer += self.hidden_size * self.moe_experts  # router
        return self._embed_params() + self.num_layers * per_layer

    def num_active_params(self) -> int:
        """The parameters a token touches: ``num_params`` for a dense
        model; a MoE layer routes each token through ``moe_k`` of its
        ``moe_experts`` expert MLPs. The N of the 6N FLOPs a token."""
        if self.moe_experts <= 0:
            return self.num_params()
        per_layer = (self._attn_params() + self._mlp_params() * self.moe_k
                     + self.hidden_size * self.moe_experts)
        return self._embed_params() + self.num_layers * per_layer

    def tp_rules(self) -> Dict[str, Any]:
        """Megatron-style TP over the mesh's ``model`` axis: the JAX
        package's table, regex for regex and spec for spec (a regex on a
        parameter's ``/``-joined path -> ``utils.partitioning.
        PartitionSpec``). Stacked block leaves lead with the layer dim.
        Column-parallel: qkv, fc and gate (output dim); row-parallel: the
        attention and MLP projections (input dim); the embedding is
        vocab-parallel, the untied head's columns too. The expert stacks'
        rules are kept for the table's sake: MoE under TP raises."""
        from ..utils.partitioning import PartitionSpec as P
        lead = (None,) if self.scan_layers else ()
        prefix = r"blocks/" if self.scan_layers else r"blocks_\d+/"

        def block(spec):
            return P(*(lead + spec))

        return {
            prefix + r".*attn_qkv/kernel": block((None, "model")),
            prefix + r".*attn_qkv/bias": block(("model",)),
            prefix + r".*attn_proj/kernel": block(("model", None)),
            prefix + r".*mlp_fc/kernel": block((None, "model")),
            prefix + r".*mlp_fc/bias": block(("model",)),
            prefix + r".*mlp_gate/kernel": block((None, "model")),
            prefix + r".*mlp_gate/bias": block(("model",)),
            prefix + r".*mlp_proj/kernel": block(("model", None)),
            r"wte/embedding": P("model", None),
            r"lm_head/kernel": P(None, "model"),
            prefix + r".*experts/fc/kernel": block(("expert", None, "model")),
            prefix + r".*experts/fc/bias": block(("expert", "model")),
            prefix + r".*experts/gate/kernel": block(("expert", None,
                                                      "model")),
            prefix + r".*experts/gate/bias": block(("expert", "model")),
            prefix + r".*experts/proj/kernel": block(("expert", "model",
                                                      None)),
            prefix + r".*experts/proj/bias": block(("expert", None)),
        }

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


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator],
                device=None, dtype=None) -> Dict[str, Any]:
    """Random scan-layout parameters for ``cfg`` from ``generator``'s seed.

    Kernels and embeddings are normal with std 1/sqrt(fan_in) (the scale
    of flax's lecun_normal), norm scales are 1 and biases 0. Values are
    drawn in float32 on the generator's device, then moved to ``device``
    (default: the generator's) and cast to ``dtype`` (default
    ``cfg.dtype``). ``device="meta"`` (no generator needed): the shapes
    only."""
    plan = _init_plan(cfg)
    if device is not None and torch.device(device).type == "meta":
        return _map_plan(plan, lambda path, spec: torch.empty(
            spec[2], device="meta", dtype=dtype or cfg.dtype))
    leaves = dict(iter_init_params(cfg, generator, device, dtype))
    return _map_plan(plan, lambda path, spec: leaves[path])


def layer_params(blocks: Dict[str, Any], li: int, clone: bool = False
                 ) -> Dict[str, Any]:
    """Layer ``li``'s slice of a scan-layout ``blocks`` tree (leaves
    stacked [L, ...], nested under ``moe``), as views or copies."""
    return {k: (layer_params(v, li, clone) if isinstance(v, dict)
                else (v[li].clone() if clone else v[li]))
            for k, v in blocks.items()}


def _map_plan(node, fn, prefix=()):
    return {k: (_map_plan(v, fn, prefix + (k,)) if isinstance(v, dict)
                else fn(prefix + (k,), v)) for k, v in node.items()}


def iter_init_params(cfg: TransformerConfig, generator: torch.Generator,
                     device=None, dtype=None):
    """The leaves of :func:`init_params` as (path tuple, tensor), one at a
    time in the order they are drawn (the same values), so a caller can
    keep a slab of each and drop the rest (``zero.Init``)."""
    gdev = generator.device
    device = torch.device(device) if device is not None else gdev
    dtype = dtype or cfg.dtype
    flat = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat.append((prefix + (k,), v))
    walk(_init_plan(cfg), ())
    # draws in the order the plan made them; constants draw nothing
    flat.sort(key=lambda item: item[1][1])
    for path, (kind, _, shape, arg) in flat:
        if kind == "normal":
            t = torch.randn(shape, generator=generator, device=gdev,
                            dtype=torch.float32) * (arg ** -0.5)
            yield path, t.to(device=device, dtype=dtype)
        else:
            yield path, torch.full(shape, arg, device=device, dtype=dtype)


def _init_plan(cfg: TransformerConfig) -> Dict[str, Any]:
    """The scan-layout tree of :func:`init_params` as leaf specs (kind,
    draw order, shape, fan-in or constant), in the tree's key order. A
    MoE model's blocks hold ``moe``: the router ``gate/kernel`` [L, H, E]
    and the experts' stacks ``experts/{gate,fc,proj}`` [L, E, in, out]
    (biased as ``use_bias``), in place of the dense MLP."""
    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    nh, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    draws = itertools.count()

    def normal(*shape, fan_in):
        return ("normal", next(draws), shape, fan_in)

    def const(value, *shape):
        return ("const", -1, shape, value)

    def norm(*lead, width=H, rms=cfg.norm == "rmsnorm"):
        p = {"scale": const(1.0, *lead, width)}
        if not rms:
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
    if cfg.moe_experts > 0:
        E, F_ = cfg.moe_experts, cfg.mlp_dim

        def expert(fan_in, fan_out):
            p = {"kernel": normal(L, E, fan_in, fan_out, fan_in=fan_in)}
            if cfg.use_bias:
                p["bias"] = const(0.0, L, E, fan_out)
            return p
        experts = {"gate": expert(H, F_)} if cfg.gated_mlp else {}
        experts.update(fc=expert(H, F_), proj=expert(F_, H))
        blocks["moe"] = {"gate": {"kernel": normal(L, H, E, fan_in=H)},
                         "experts": experts}
    elif cfg.gated_mlp:
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
                              "blocks": blocks}
    if not cfg.post_ln:        # post-LN stacks end normed by each ln2
        params["ln_f"] = norm()
    if cfg.pos_embed == "learned":
        params["wpe"] = {"embedding": normal(cfg.max_seq_len, H, fan_in=H)}
    if cfg.token_type_vocab > 0:
        params["tte"] = {"embedding": normal(cfg.token_type_vocab, H,
                                             fan_in=H)}
    if cfg.embed_ln:
        params["ln_emb"] = norm()
    if cfg.mlm_head:
        # BERT cls.predictions: dense + LayerNorm transform, then the tied
        # decoder plus a bare [V] output bias
        params["mlm_transform"] = {"kernel": normal(H, H, fan_in=H),
                                   "bias": const(0.0, H)}
        params["mlm_ln"] = norm(rms=False)
        params["mlm_bias"] = const(0.0, V)
    elif not cfg.tie_embeddings and not cfg.no_lm_head:
        head = {"kernel": normal(H, V, fan_in=H)}
        if cfg.lm_head_bias:
            head["bias"] = const(0.0, V)
        params["lm_head"] = head
    return params


def alibi_bias(num_heads: int, q_pos: torch.Tensor,
               k_pos: torch.Tensor) -> torch.Tensor:
    """Additive bias slope * (k - q): [B, H, Sq, Sk] for [B, S] positions,
    [1, H, Sq, Sk] for shared [S]."""
    slopes = torch.as_tensor(alibi_slopes(num_heads), dtype=torch.float32,
                             device=q_pos.device)
    if q_pos.dim() == 1:
        q_pos, k_pos = q_pos[None], k_pos[None]
    dist = (k_pos[:, None, :] - q_pos[:, :, None]).to(torch.float32)
    return slopes[None, :, None, None] * dist[:, None]


# ------------------------------------------------------------------ modules

_NOT_PORTED = "is not ported to deepspeed_tpu_torch yet (see ROADMAP.md)"


def _check_trainable(cfg: TransformerConfig) -> None:
    """Raise for the config features the module does not implement."""
    unported = {
        "random-LTD (ltd_tokens)": cfg.ltd_tokens > 0, "pld": cfg.pld,
        "activation_quant": cfg.activation_quant,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"Transformer: {', '.join(bad)} "
                                  + _NOT_PORTED)
    if cfg.remat:
        from ..runtime.act_checkpoint import check_block_policy
        check_block_policy(cfg.remat_policy)
    if cfg.fused_loss and cfg.final_logit_softcap:
        raise ValueError("fused_loss with final_logit_softcap is not "
                         "supported (the chunked CE has no softcap term)")
    if cfg.fused_loss and not cfg.tie_embeddings and cfg.lm_head_bias:
        raise ValueError("fused_loss with a biased untied lm_head is not "
                         "supported (the chunked CE has no bias term)")


class _Leaf(nn.Module):
    """A flax leaf module's parameters under their flax names (kernel,
    bias, scale, embedding); ``p`` is the dict the shared layer math
    (``generation._dense`` / ``_layer_norm``) takes."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    @property
    def p(self) -> Dict[str, torch.Tensor]:
        # attribute lookup: a ZeRO-3 unit puts the gathered whole tensor
        # in the instance dict, ahead of the shard in _parameters
        return {name: getattr(self, name) for name in self._parameters}


def _sparse_block_attention(cfg: TransformerConfig, q, k, v, *, mask, bias,
                            slopes, window, sm_scale, dropout_rate=0.0,
                            dropout_rng=None, tp=None):
    """attention_impl == "sparse": the block-sparse layout that the
    ``sparse_attention`` ds_config section selects (the engine wires the
    parsed section into ``cfg.sparse_attention``).

    A clean call (no mask, bias, ALiBi, window, softcap or dropout) runs
    ``ops.sparse_attention.sparse_attention``: the layout-skipping kernels,
    whose cost scales with the layout's density. Anything else composes
    the layout into a dense mask over ``mha_reference``: the sparsity is
    still applied exactly, only the skipping is lost. Unknown modes raise
    here (and in the engine's wiring), never silently dense."""
    from ..ops.attention import (alibi_bias_from_slopes, mha_reference,
                                 window_mask)
    from ..ops.sparse_attention import (SPARSITY_CONFIGS, config_layout,
                                        layout_to_dense_mask,
                                        sparse_attention)
    B, H, S, D = q.shape
    kwargs = {key: (list(val) if isinstance(val, tuple) else val)
              for key, val in (cfg.sparse_attention or ())}
    mode = kwargs.pop("mode", "fixed")
    if mode not in SPARSITY_CONFIGS:
        raise ValueError(f"unknown sparse attention mode '{mode}'; "
                         f"have {sorted(SPARSITY_CONFIGS)}")
    cls = SPARSITY_CONFIGS[mode]
    allowed = {f.name for f in dataclasses.fields(cls)} - {"num_heads"}
    # the layout of the model's heads; a tensor-parallel rank (q holding
    # its H of them) takes its heads' layouts, as GSPMD shards JAX's
    sp_cfg = cls(num_heads=cfg.num_heads,
                 **{key: val for key, val in kwargs.items()
                    if key in allowed and val is not None})
    heads = None
    if tp is not None:
        a, b, _, _ = tp.head_range(cfg)
        heads = slice(a, b)
    clean = (mask is None and bias is None and slopes is None
             and dropout_rate == 0.0 and not window and not cfg.attn_softcap)
    if clean:
        return sparse_attention(q, k, v, sp_cfg, causal=cfg.causal,
                                sm_scale=sm_scale, heads=heads)
    if slopes is not None:
        bias = alibi_bias_from_slopes(slopes, S, S, device=q.device)
    layout = config_layout(sp_cfg, S)
    if heads is not None:
        layout = layout[heads]
    lmask = layout_to_dense_mask(layout, sp_cfg.block, device=q.device)[None]
    mask = lmask if mask is None else mask & lmask
    if window:
        mask = mask & window_mask(S, S, window, device=q.device)
    return mha_reference(q, k, v, causal=cfg.causal, bias=bias, mask=mask,
                         sm_scale=sm_scale, dropout_rate=dropout_rate,
                         dropout_rng=dropout_rng, softcap=cfg.attn_softcap)


def _tp_leaf(p: Dict[str, torch.Tensor], tp) -> Dict[str, torch.Tensor]:
    """A replicated leaf used on this rank's share of the model (its
    heads): each tensor through ``_col_in``, so the ranks' partial
    gradients are summed over the model axis (Megatron's copy to the
    model-parallel region). The leaf itself without ``tp``."""
    if tp is None:
        return p
    from .generation import _col_in
    return {k: _col_in(v, tp) for k, v in p.items()}


_MASK64 = (1 << 64) - 1
#: the dropout sites of a block (0 is the embeddings'), as seed offsets
_SITES = {"embed": 0, "attn_probs": 1, "attn_out": 2, "mlp": 3,
          "gating": 4}


def mix_seed(*xs: int) -> int:
    """A 63-bit seed from integers (splitmix64 over them in order): the
    port's counterpart of folding values into a JAX key."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = ((h ^ (int(x) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h & ((1 << 63) - 1)


def site_generator(seed: int, site: str, device) -> torch.Generator:
    """The generator of one dropout site (or of a MoE layer's gating
    noise, site "gating"), made from its seed where the draw happens: a remat recomputation makes it again from the same seed
    and draws the same mask (``torch.utils.checkpoint`` restores the
    default generators' state, not an explicit generator's)."""
    return torch.Generator(device=device).manual_seed(
        mix_seed(seed, _SITES[site]))


class Block(nn.Module):
    """One transformer block (the JAX package's ``Block``): LayerNorm or
    RMSNorm, a fused qkv projection with GQA, qk-norm, rotary or ALiBi
    positions, attention through ``ops.attention`` (the flash kernels, or
    the block-sparse kernels for a pure window) or, with
    ``attention_impl="sparse"``, through the configured block-sparse
    layout, GELU or SwiGLU MLP, or with ``cfg.moe_experts`` > 0 a
    mixture of experts in its place (``moe.layer.MoE``: SwiGLU experts
    with ``gated_mlp``, the GELU MLP otherwise). The residual forms:
    pre-LN (with the Gemma-2 sandwich norms), post-LN (BERT: LN after
    each residual add) and parallel (GPT-J: one LN feeds both branches;
    GPT-NeoX: ``ln2`` feeds the MLP)."""

    def __init__(self, cfg: TransformerConfig,
                 params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        # this rank's TPContext when the parameters are its model-axis
        # shards (Transformer.set_tp), else None
        self.tp = None
        for name, leaf in params.items():
            if name == "moe":
                from ..moe.layer import MoE
                # the JAX Block's MoE: one capacity factor for training
                # and eval
                self.moe = MoE(
                    cfg.hidden_size, cfg.moe_experts, k=cfg.moe_k,
                    capacity_factor=cfg.moe_capacity_factor,
                    eval_capacity_factor=cfg.moe_capacity_factor,
                    dtype=cfg.dtype, params=leaf, activation=cfg.activation)
            else:
                self.add_module(name, _Leaf(leaf))

    def forward(self, x: torch.Tensor, attn_mask=None, positions=None,
                window: int = 0, dropout_seed: Optional[int] = None,
                gating_seed: Optional[int] = None):
        """The block's output; a MoE block returns (output, aux), its
        router's load-balance loss.

        ``dropout_seed``: this layer's seed in training with
        ``cfg.dropout`` > 0 (None: no dropout). Each site draws from a
        generator made from it here (:func:`site_generator`).
        ``gating_seed``: in training, the seed of a MoE layer's top-2
        Gumbel noise (None: no noise). The block's MoE takes one capacity
        factor for training and eval, as the JAX Block's does, so the
        noise is all that training changes there."""
        from ..ops.attention import HeadSlice, attention, dropout
        from .generation import (_col_in, _dense, _layer_norm, _row_dense,
                                 expand_kv, kv_grad_sum, local_alibi_slopes)
        cfg, tp = self.cfg, self.tp
        rate = cfg.dropout if dropout_seed is not None else 0.0
        gen = ((lambda site: site_generator(dropout_seed, site, x.device))
               if rate > 0.0 else (lambda site: None))
        B, S, H = x.shape
        nh, kv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        if nh % kv != 0:
            raise ValueError(f"num_heads {nh} not divisible by "
                             f"num_kv_heads {kv}")
        nh_all, h0 = nh, 0
        if tp is not None:                      # this rank's heads
            nh, kv = tp.heads(cfg)
            h0 = tp.head_range(cfg)[0]
        rms, eps = cfg.norm == "rmsnorm", cfg.layer_norm_eps
        act = _ACTIVATIONS[cfg.activation]
        h = x if cfg.post_ln else _layer_norm(x, self.ln1.p, eps, rms)
        qkv = _dense(_col_in(h, tp), kv_grad_sum(self.attn_qkv.p, cfg, tp))
        q, k, v = torch.split(qkv, [nh * hd, kv * hd, kv * hd], dim=-1)
        to_heads = lambda t, n: t.reshape(B, S, n, hd).transpose(1, 2)
        q, k, v = to_heads(q, nh), to_heads(k, kv), to_heads(v, kv)
        if cfg.qk_norm:
            # replicated scales applied to this rank's heads: their
            # gradients are summed over the model axis (_col_in)
            q = _layer_norm(q, _tp_leaf(self.q_norm.p, tp), eps, rms=True)
            k = _layer_norm(k, _tp_leaf(self.k_norm.p, tp), eps, rms=True)
        if cfg.pos_embed == "rotary":
            pos = (positions if positions is not None
                   else torch.arange(S, device=x.device))
            inv_freq = cfg.rope_inv_freq(S)
            q = apply_rotary(q, pos, cfg.rotary_dim, cfg.rotary_interleaved,
                             cfg.rope_theta, inv_freq=inv_freq)
            k = apply_rotary(k, pos, cfg.rotary_dim, cfg.rotary_interleaved,
                             cfg.rope_theta, inv_freq=inv_freq)
        # GQA: each k/v head serves nh / kv query heads (jnp.repeat);
        # autograd sums dk and dv back onto the kv heads
        k, v = expand_kv(k, cfg, tp), expand_kv(v, cfg, tp)
        bias = slopes = None
        if cfg.pos_embed == "alibi":
            if positions is None:   # slopes: the kernels build the bias
                slopes = local_alibi_slopes(nh_all, tp, cfg, x.device)
            else:                   # per-sample positions: materialized
                bias = alibi_bias(nh_all, positions, positions)
                if tp is not None:
                    bias = bias[:, h0:h0 + nh]
        probs_rng = gen("attn_probs")
        if probs_rng is not None and tp is not None:
            # the mask of the model's [B, nh, S, S] probabilities from the
            # 1-rank generator, this rank's heads cut out (JAX draws once
            # over the global heads, GSPMD shards it): t times the random
            # bits of the local mask, and each head its own mask
            probs_rng = HeadSlice(probs_rng, h0, nh_all)
        if cfg.attention_impl == "sparse":
            out = _sparse_block_attention(
                cfg, q, k, v, mask=attn_mask, bias=bias, slopes=slopes,
                window=window, sm_scale=cfg.attn_scale, dropout_rate=rate,
                dropout_rng=probs_rng, tp=tp)
        else:
            out = attention(q, k, v, causal=cfg.causal, mask=attn_mask,
                            bias=bias, alibi_slopes=slopes,
                            sm_scale=cfg.attn_scale, dropout_rate=rate,
                            dropout_rng=probs_rng,
                            impl=cfg.attention_impl, window=window,
                            softcap=cfg.attn_softcap)
        out = out.transpose(1, 2).reshape(B, S, nh * hd)
        out = dropout(_row_dense(out, self.attn_proj.p, tp), rate,
                      gen("attn_out"))

        aux = []

        def mlp(m):
            if cfg.moe_experts > 0:
                g = (site_generator(gating_seed, "gating", x.device)
                     if gating_seed is not None else None)
                m, a = self.moe(m, train=g is not None, generator=g)
                aux.append(a)
                return m
            m = _col_in(m, tp)
            if cfg.gated_mlp:
                m = act(_dense(m, self.mlp_gate.p)) * _dense(m, self.mlp_fc.p)
            else:
                m = act(_dense(m, self.mlp_fc.p))
            return _row_dense(m, self.mlp_proj.p, tp)

        def done(y):
            return (y, aux[0]) if aux else y

        if cfg.parallel_residual:
            m_in = (_layer_norm(x, self.ln2.p, eps, rms)
                    if cfg.parallel_residual_dual_ln else h)
            return done(x + out + dropout(mlp(m_in), rate, gen("mlp")))
        if cfg.post_ln:
            x = _layer_norm(x + out, self.ln1.p, eps, rms)
            m = dropout(mlp(x), rate, gen("mlp"))
            return done(_layer_norm(x + m, self.ln2.p, eps, rms))
        if cfg.post_block_norms:
            out = _layer_norm(out, self.post_attn_norm.p, eps, rms)
        x = x + out
        m = mlp(_layer_norm(x, self.ln2.p, eps, rms))
        if cfg.post_block_norms:
            m = _layer_norm(m, self.post_mlp_norm.p, eps, rms)
        return done(x + dropout(m, rate, gen("mlp")))


class Transformer(nn.Module):
    """GPT-style LM or BERT-style encoder (the JAX package's
    ``Transformer``): ``forward(batch, train=False)`` takes ids [B, S] or a
    dict with ``input_ids`` and optional ``attention_mask`` (key padding),
    ``position_ids``, ``token_type_ids`` and ``labels``; it returns f32
    logits [B, S, V] (the MLM head's with ``cfg.mlm_head``), the final
    hidden states [B, S, H] in f32 with ``cfg.no_lm_head``, or the loss
    with ``cfg.fused_loss``. Each layer attends with its own static window
    from ``cfg.layer_windows`` (0 = global).

    ``params``: a scan-layout (or per-layer) parameter dict of tensors,
    e.g. from :func:`init_params` or ``models.convert.params_from_jax``;
    default :func:`init_params` from ``seed`` in float32 on ``device``.
    Parameters keep their dtype; the forward computes in ``cfg.dtype``
    (the flax modules' ``dtype`` with ``param_dtype=float32``), so f32
    parameters receive f32 gradients through the casts and compute-dtype
    parameters their own. Features the module does not implement raise
    ``NotImplementedError`` at construction. ``cfg.dropout`` > 0 drops
    out in training at the JAX model's sites: the embeddings, the
    attention probabilities (through the plain attention path, as the JAX
    router sends them to its reference), the attention output and the MLP
    output."""

    def __init__(self, cfg: TransformerConfig,
                 params: Optional[Dict[str, Any]] = None, *, seed: int = 0,
                 device=None):
        super().__init__()
        _check_trainable(cfg)
        self.cfg = cfg
        if params is None:
            from ..zero import get_active_init
            if get_active_init() is not None:
                # zero.Init: shapes on meta; the engine draws the same
                # values leaf by leaf and keeps each rank's slabs
                params = init_params(cfg, None, device="meta",
                                     dtype=torch.float32)
                self.zero_init_values = functools.partial(
                    self._seeded_values, seed, device or "cpu")
            else:
                gen = torch.Generator(device=device or "cpu").manual_seed(
                    seed)
                params = init_params(cfg, gen, dtype=torch.float32)
        from .generation import ensure_scan_layout
        params = ensure_scan_layout(params, cfg.num_layers)
        for name, sub in params.items():
            if name == "blocks":
                continue
            if isinstance(sub, dict):
                self.add_module(name, _Leaf(sub))
            else:                   # a bare top-level array (mlm_bias)
                self.register_parameter(name, nn.Parameter(sub))
        self.blocks = nn.ModuleList(
            Block(cfg, layer_params(params["blocks"], li, clone=True))
            for li in range(cfg.num_layers))
        self.tp = None

    def set_tp(self, tp) -> None:
        """Run the Megatron layers as rank ``tp.rank`` of ``tp.size`` on
        the mesh's ``model`` axis (a ``utils.partitioning.TPContext``;
        None: the single-device math). The parameters must be (or become,
        as the engine places them) this rank's shards."""
        if tp is not None:
            from ..utils.partitioning import check_tp_model
            check_tp_model(self.cfg, tp.size)
        self.tp = tp
        for blk in self.blocks:
            blk.tp = tp
            if hasattr(blk, "moe"):
                blk.moe.tp = tp

    def _seeded_values(self, seed: int, gen_device, device=None):
        """(parameter name, f32 value) of ``Transformer(cfg, seed=seed,
        device=gen_device)``, one ``init_params`` leaf at a time (a block
        leaf's layers one after another)."""
        gen = torch.Generator(device=gen_device).manual_seed(seed)
        for path, t in iter_init_params(self.cfg, gen, device=device,
                                        dtype=torch.float32):
            if path[0] == "blocks":
                for li in range(self.cfg.num_layers):
                    yield ".".join(("blocks", str(li)) + path[1:]), t[li]
            else:
                yield ".".join(path), t

    def forward(self, batch, train: bool = False,
                dropout_seed: Optional[int] = None,
                gating_seed: Optional[int] = None,
                vocab_parallel: bool = False):
        """``dropout_seed``: with ``train`` and ``cfg.dropout`` > 0, the
        seed of this call's masks (the engine's is per step, micro-batch
        and rank; default one drawn from torch's default generator). The
        embeddings' site and each layer's sites draw from generators made
        from it where they draw, so a remat recomputation repeats them.

        A MoE model (``cfg.moe_experts`` > 0) returns ``(logits, aux)``,
        or ``(loss, aux)`` under ``fused_loss``, with ``aux`` the routers'
        load-balance losses summed over the layers (f32), as the JAX
        ``Transformer`` does; :func:`make_moe_loss` folds it into the
        loss. ``gating_seed``: with ``train``, the seed of the top-2
        routers' Gumbel noise (each layer's generator made from it where
        it draws, as dropout's are); None gates without noise, as the JAX
        model does without a "gating" rng.

        Under sequence parallelism (``attention_impl`` "ring" or
        "ulysses" in a seq group of more than one rank) ``batch`` is this
        rank's chunk of each sequence, whose global positions default to
        the chunk's (``ring_attention.chunk_positions``). The engine adds
        the losses' ``shifted_labels`` (the next-token labels cut on the
        whole sample) and ``label_count`` (the whole samples' count of
        labels): the fused CE then takes ``shifted_labels`` without a
        shift and divides by ``label_count``, so a rank's loss is its
        share of the mean.

        Under TP (:meth:`set_tp`) the logits are gathered over the model
        axis, so every rank returns the whole [B, S, V]; with
        ``vocab_parallel`` they stay this rank's vocab shard [B, S,
        ceil(V / t)], for a loss given the same TP context
        (:func:`cross_entropy`, :func:`causal_lm_loss`,
        :func:`masked_lm_loss` with ``tp=``)."""
        from ..ops.attention import dropout
        from .generation import (_col_in, _dense, _layer_norm, tp_embedding,
                                 vocab_slice)
        cfg, tp = self.cfg, self.tp
        seed = None
        if train and cfg.dropout > 0.0:
            seed = (int(dropout_seed) if dropout_seed is not None else
                    int(torch.randint(0, 1 << 62, (1,)).item()))
        if isinstance(batch, dict):
            ids = batch["input_ids"]
            attention_mask = batch.get("attention_mask")
            position_ids = batch.get("position_ids")
            token_type_ids = batch.get("token_type_ids")
        else:
            ids, attention_mask, position_ids = batch, None, None
            token_type_ids = None
        emb = self.wte.embedding
        dev, dt = emb.device, cfg.dtype
        ids = torch.as_tensor(ids, device=dev).long()
        B, S = ids.shape
        rms, eps = cfg.norm == "rmsnorm", cfg.layer_norm_eps
        user_positions = None
        if position_ids is not None:
            user_positions = torch.as_tensor(position_ids, device=dev).long()
        elif cfg.attention_impl in ("ring", "ulysses"):
            # this rank's chunk of a sequence split over the seq group
            from ..parallel.ring_attention import chunk_positions
            user_positions = chunk_positions(B, S, dev)
        x = (F.embedding(ids, emb) if tp is None
             else tp_embedding(ids, emb, tp)).to(dt)
        if cfg.embed_scale is not None:
            x = x * torch.tensor(cfg.embed_scale, dtype=dt)
        if cfg.pos_embed == "learned":
            pos = (user_positions if user_positions is not None
                   else torch.arange(S, device=dev)[None])
            x = x + F.embedding(pos, self.wpe.embedding).to(dt)
        if cfg.token_type_vocab > 0:
            tt = (torch.zeros_like(ids) if token_type_ids is None else
                  torch.as_tensor(token_type_ids, device=dev).long())
            x = x + F.embedding(tt, self.tte.embedding).to(dt)
        if cfg.embed_ln:
            x = _layer_norm(x, self.ln_emb.p, eps, rms)
        if seed is not None:
            x = dropout(x, cfg.dropout, site_generator(seed, "embed", dev))
        attn_mask = None
        if attention_mask is not None:        # [B, 1, 1, S] key padding
            attn_mask = torch.as_tensor(attention_mask, device=dev).to(
                torch.bool)[:, None, None, :]
        windows = ([max(int(w), 0) for w in cfg.layer_windows]
                   if cfg.layer_windows is not None
                   else [0] * cfg.num_layers)
        seeds = [None if seed is None else mix_seed(seed, li + 1)
                 for li in range(cfg.num_layers)]
        gseeds = [None if gating_seed is None or not train
                  else mix_seed(int(gating_seed), li + 1)
                  for li in range(cfg.num_layers)]
        auxes = []
        remat = cfg.remat and torch.is_grad_enabled()
        if remat:
            # each block one checkpointed region under cfg.remat_policy
            from ..runtime.act_checkpoint import remat_block
        for blk, window, ls, gs in zip(self.blocks, windows, seeds, gseeds):
            args = (x, attn_mask, user_positions, window, ls, gs)
            x = (remat_block(blk, cfg.remat_policy, *args) if remat
                 else blk(*args))
            if cfg.moe_experts > 0:
                x, a = x
                auxes.append(a)
        aux_total = (torch.stack(auxes).sum() if auxes else None)
        if not cfg.post_ln:
            x = _layer_norm(x, self.ln_f.p, eps, rms)
        if cfg.mlm_head:
            # BERT cls.predictions: transform (dense, activation,
            # LayerNorm), then the tied decoder plus the output bias
            h = _ACTIVATIONS[cfg.activation](_dense(x, self.mlm_transform.p))
            h = _col_in(_layer_norm(h, self.mlm_ln.p, eps), tp)
            logits = (h @ emb.to(dt).transpose(0, 1)).to(torch.float32)
            bias = self.mlm_bias if tp is None else vocab_slice(
                _col_in(self.mlm_bias, tp), tp)
            return self._vocab_out(logits + bias.to(torch.float32),
                                   vocab_parallel)
        if cfg.no_lm_head:                    # encoder use (CLIP text)
            return x.to(torch.float32)
        x = _col_in(x, tp)
        if cfg.fused_loss:
            head = (emb if cfg.tie_embeddings
                    else self.lm_head.kernel.transpose(0, 1))
            shift, count = (1 if cfg.causal else 0), None
            labels = (batch.get("labels", ids) if isinstance(batch, dict)
                      else ids)
            if isinstance(batch, dict) and "label_count" in batch:
                count = batch["label_count"]
                if cfg.causal:
                    labels, shift = batch["shifted_labels"], 0
            labels = torch.as_tensor(labels, device=dev).long()
            loss = _fused_causal_lm_loss(x, head, labels, cfg.loss_chunk,
                                         shift=shift, count=count, tp=tp)
            return loss if aux_total is None else (loss, aux_total)
        if cfg.tie_embeddings:
            logits = x @ emb.to(dt).transpose(0, 1)
        elif tp is not None and "bias" in self.lm_head._parameters:
            logits = _dense(x, {"kernel": self.lm_head.kernel})
            logits = logits + vocab_slice(_col_in(self.lm_head.bias, tp),
                                          tp).to(dt)
        else:
            logits = _dense(x, self.lm_head.p)
        logits = logits.to(torch.float32)
        if cfg.final_logit_softcap:
            from ..ops.attention import apply_softcap
            logits = apply_softcap(logits, cfg.final_logit_softcap)
        logits = self._vocab_out(logits, vocab_parallel)
        return logits if aux_total is None else (logits, aux_total)

    def _vocab_out(self, logits: torch.Tensor, vocab_parallel: bool
                   ) -> torch.Tensor:
        """Under TP: the whole logits gathered over the model axis, or
        with ``vocab_parallel`` this rank's vocab shard."""
        if self.tp is None or vocab_parallel:
            return logits
        from .generation import gather_vocab
        return gather_vocab(logits, self.tp)


class _VocabLogSumExp(torch.autograd.Function):
    """logsumexp over the last dim of f32 logits, the plain CE's and the
    vocab-parallel CE's alike (:func:`nll_terms`): the max and the sum of
    exponentials, each all-reduced over the model axis ``axis`` (None:
    this process holds the whole vocabulary and nothing is reduced). The
    operations of ``torch.logsumexp`` and its backward, written out so
    that both CE paths run them, in the same order, whatever
    ``torch.logsumexp``'s own kernel does: one model rank computes the
    plain values bit for bit."""

    @staticmethod
    def forward(ctx, x, axis):
        from .. import comm
        m = torch.amax(x, dim=-1, keepdim=True)
        if axis is not None:
            comm.all_reduce(m, op=comm.ReduceOp.MAX, axis=axis)
        ms = m.squeeze(-1)
        ms = ms.masked_fill(ms.abs() == float("inf"), 0)
        s = torch.sum((x - m).exp(), dim=-1)
        if axis is not None:
            comm.all_reduce(s, axis=axis)
        out = s.log().add(ms)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - out.unsqueeze(-1)).exp(), None


def vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor, tp
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, target logit) of f32 vocab-parallel logits [...,
    ceil(V / t)] (this rank's vocab shard; its padding past V masked to
    -inf) for labels [...] over the whole vocabulary: the max, the sum of
    exponentials and the target logit each all-reduced over the model
    axis, so no rank forms the whole [..., V]. Labels outside [0, V)
    (ignore_index) give a target logit of 0."""
    from .. import comm
    vc = logits.shape[-1]
    lo = tp.rank * vc
    if lo + vc > tp.vocab:
        col = torch.arange(vc, device=logits.device)
        logits = logits.masked_fill(col >= tp.vocab - lo, float("-inf"))
    logz = _VocabLogSumExp.apply(logits, tp.axis)
    local = labels - lo
    own = (local >= 0) & (local < vc)
    gold = logits.gather(-1, torch.where(own, local, torch.zeros_like(
        local))[..., None])[..., 0]
    gold = torch.where(own, gold, torch.zeros((), dtype=gold.dtype,
                                              device=gold.device))
    return logz, comm.tp_reduce_from(gold, axis=tp.axis)


def nll_terms(logits: torch.Tensor, labels: torch.Tensor,
              valid: torch.Tensor, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, target logit) of f32 logits [..., V] for labels [...]
    where ``valid`` (a target logit of 0 elsewhere). ``tp``: the logits
    are this rank's vocab shard, taken through
    :func:`vocab_parallel_terms`. Both paths run the same operations
    (:class:`_VocabLogSumExp`, one gather, one select), so over one model
    rank the vocab-parallel terms, their gradient too, are the plain ones
    bit for bit."""
    if tp is not None:
        return vocab_parallel_terms(logits, torch.where(
            valid, labels, torch.full_like(labels, -1)), tp)
    logz = _VocabLogSumExp.apply(logits, None)
    gold = logits.gather(-1, torch.where(valid, labels, torch.zeros_like(
        labels))[..., None])[..., 0]
    gold = torch.where(valid, gold, torch.zeros((), dtype=gold.dtype,
                                                device=gold.device))
    return logz, gold


def _chunk_nll(xc: torch.Tensor, emb_c: torch.Tensor, tc: torch.Tensor,
               tp=None):
    ok = tc != -100                                  # ignore_index + padding
    valid = ok.to(torch.float32)
    logits = (xc @ emb_c.transpose(0, 1)).to(torch.float32)
    logz, gold = nll_terms(logits, tc, ok, tp)
    return ((logz - gold) * valid).sum(), valid.sum()


def _fused_causal_lm_loss(x: torch.Tensor, emb: torch.Tensor,
                          labels: torch.Tensor, chunk: int,
                          shift: int = 1, count=None, tp=None
                          ) -> torch.Tensor:
    """Next-token CE without materializing [B, S, V] logits.

    x: [B, S, H] final hidden states (compute dtype); emb: [V, H] head
    (the tied embedding, or the untied head kernel transposed); labels
    [B, S]. The vocab projection runs per sequence chunk under
    ``torch.utils.checkpoint``, so forward and backward hold one [B,
    chunk, V] logits tile at a time. The chunk matmul accumulates in f32
    inside the tensor cores and rounds its logits to the compute dtype
    before the f32 logsumexp (the JAX package keeps f32 logits: a bf16
    run differs by that rounding, an f32 run not at all). Drops the last
    position (``shift``), ignores -100 labels and divides by max(count,
    1), the count of valid labels here or the given ``count``. Under TP
    (``tp``) ``emb`` is this rank's vocab shard and each chunk's terms
    come from :func:`vocab_parallel_terms`."""
    B, S, H = x.shape
    if shift:
        xs, tgt = x[:, :-1], labels[:, 1:]
    else:
        xs, tgt = x, labels
    n = S - shift
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad), value=-100)
    emb_c = emb.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    valid = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, n + pad, chunk):
        nll, cnt = checkpoint(_chunk_nll, xs[:, c0:c0 + chunk], emb_c,
                              tgt[:, c0:c0 + chunk], tp, use_reentrant=False)
        total = total + nll
        valid = valid + cnt
    if count is not None:
        valid = torch.as_tensor(count, dtype=torch.float32, device=x.device)
    return total / torch.clamp(valid, min=1.0)


def fused_loss_passthrough(outputs, batch):
    """Engine loss_fn for models built with fused_loss=True (outputs IS
    the loss)."""
    return outputs


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100, count=None, tp=None
                  ) -> torch.Tensor:
    """Token-level CE with an ignore mask; f32 accumulation. Divides by
    the count of valid labels, or by ``count`` when given (a sequence
    chunk's share of the whole samples' mean). ``tp``: the logits are
    this rank's vocab shard (a TP ``Transformer``'s with
    ``vocab_parallel``), taken through :func:`vocab_parallel_terms`."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    valid = labels != ignore_index
    logz, gold = nll_terms(logits.to(torch.float32), labels, valid, tp)
    nll = (logz - gold) * valid
    n = valid.sum() if count is None else torch.as_tensor(
        count, dtype=torch.float32, device=logits.device)
    return nll.sum() / torch.clamp(n, min=1)


def causal_lm_loss(logits: torch.Tensor, batch, tp=None) -> torch.Tensor:
    """Next-token prediction: shift logits and labels by one. A
    sequence-parallel chunk's batch carries the labels already shifted on
    the whole sample (``shifted_labels``) and their whole count
    (``label_count``). ``tp``: vocab-parallel logits, as
    :func:`cross_entropy` takes them."""
    if isinstance(batch, dict) and "shifted_labels" in batch:
        return cross_entropy(logits, batch["shifted_labels"],
                             count=batch["label_count"], tp=tp)
    labels = (batch.get("labels", batch["input_ids"])
              if isinstance(batch, dict) else batch)
    labels = torch.as_tensor(labels, device=logits.device)
    return cross_entropy(logits[:, :-1], labels[:, 1:], tp=tp)


def masked_lm_loss(logits: torch.Tensor, batch, tp=None) -> torch.Tensor:
    """BERT-style: loss only where labels != -100 (over ``label_count``
    labels when a sequence-parallel chunk's batch gives it). ``tp``:
    vocab-parallel logits, as :func:`cross_entropy` takes them."""
    return cross_entropy(logits, batch["labels"],
                         count=batch.get("label_count"), tp=tp)


def make_moe_loss(aux_weight: float = 0.01, base_loss=None):
    """The loss of a MoE model's ``(logits, aux)``: ``base_loss(logits,
    batch) + aux_weight * aux`` (default base :func:`causal_lm_loss`;
    under ``fused_loss`` the model's outputs are ``(loss, aux)`` and the
    base is :func:`fused_loss_passthrough`). It carries the JAX
    package's markers ``_moe_loss``, ``_moe_base_loss`` and
    ``_moe_aux_weight``; the engine reads the base loss from them."""
    base = base_loss or causal_lm_loss

    def moe_loss(outputs, batch):
        logits, aux = outputs
        return base(logits, batch) + aux_weight * aux

    moe_loss._moe_loss = True
    moe_loss._moe_base_loss = base
    moe_loss._moe_aux_weight = aux_weight
    return moe_loss


def build_model(name_or_cfg, *, seed: int = 0, device=None,
                **overrides) -> Tuple[Transformer, TransformerConfig]:
    """(Transformer, cfg) for a preset name (with config overrides) or a
    ``TransformerConfig``; parameters from :func:`init_params` at ``seed``,
    float32 on ``device`` (default the CPU)."""
    cfg = (name_or_cfg if isinstance(name_or_cfg, TransformerConfig)
           else get_config(name_or_cfg, **overrides))
    return Transformer(cfg, seed=seed, device=device), cfg


class DeepSpeedTransformerLayer(nn.Module):
    """The reference's fused-layer API
    (``ops/transformer/transformer.py:459``), as the JAX package exports
    it: one :class:`Block` applied to [B, S, H] hidden states, configured
    by a ``TransformerConfig`` (exported as ``DeepSpeedTransformerConfig``;
    batch size and sequence length are runtime shapes, not fields).

    ``params``: one block's parameters, ``{leaf: {name: tensor}}`` under
    the flax names (``ln1``, ``attn_qkv``, ...), moved to ``device``;
    default one layer of :func:`init_params` drawn in float32 from
    ``seed`` on ``device``. ``device`` is ``cuda`` unless the caller
    passes ``device="cpu"`` (``utils.device.resolve_device``).
    ``forward(hidden_states, attention_mask=None, train=False)`` takes a
    boolean or integer mask, True/1 = attend, [B, S] (key padding) or
    broadcastable to [B, 1, S, S]."""

    def __init__(self, config: TransformerConfig,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 *, seed: int = 0, device=None):
        super().__init__()
        if config.moe_experts > 0:
            # the single-layer API has no channel for the router's aux loss
            raise ValueError(
                "DeepSpeedTransformerLayer does not support MoE configs "
                "(the router aux loss would be silently dropped); build "
                "the full model via models.build_model(moe_experts=...)")
        _check_trainable(config)
        from ..utils.device import resolve_device
        dev = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            one = dataclasses.replace(config, num_layers=1)
            params = {name: {k: t[0] for k, t in sub.items()} for name, sub in
                      init_params(one, gen, dtype=torch.float32)["blocks"]
                      .items()}
        params = {name: {k: torch.as_tensor(t).to(dev) for k, t in sub.items()}
                  for name, sub in params.items()}
        self.config = config
        self.block = Block(config, params)

    def forward(self, hidden_states: torch.Tensor, attention_mask=None,
                train: bool = False, dropout_seed: Optional[int] = None
                ) -> torch.Tensor:
        """With ``train`` and ``config.dropout`` > 0 the block drops out
        from ``dropout_seed`` (default one drawn from torch's default
        generator)."""
        seed = None
        if train and self.config.dropout > 0.0:
            seed = (int(dropout_seed) if dropout_seed is not None else
                    int(torch.randint(0, 1 << 62, (1,)).item()))
        if attention_mask is not None:
            mask = torch.as_tensor(attention_mask,
                                   device=hidden_states.device)
            if mask.is_floating_point():
                # the reference feeds ADDITIVE float masks ((1-m)*-1e4);
                # read as booleans they would attend the inverted positions
                raise ValueError(
                    "DeepSpeedTransformerLayer takes a boolean/int "
                    "attention_mask (True/1 = attend), not the additive "
                    "float mask; convert with mask = additive_mask >= 0")
            attention_mask = mask.to(torch.bool)
            if attention_mask.dim() == 2:     # HF-style [B, S] key mask
                attention_mask = attention_mask[:, None, None, :]
        return self.block(hidden_states.to(self.config.dtype),
                          attention_mask, dropout_seed=seed)


# the reference's export name (deepspeed/__init__.py:24-25)
DeepSpeedTransformerConfig = TransformerConfig
