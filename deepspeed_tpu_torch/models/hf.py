"""HuggingFace weight import: the policy-based module-substitution surface
(counterpart of ``deepspeed_tpu/models/hf.py``).

The reference's ``deepspeed/module_inject`` walks a live torch model and
rewires its layers to fused CUDA modules; here, as in the JAX package, a
"policy" maps a HF state dict's weight names into the scan-layout
parameter tree of the port's ``Transformer`` (``models/transformer.py``)
and builds the matching ``TransformerConfig``.

Policies: GPT-2, GPT-Neo, GPT-NeoX, GPT-J, OPT, BLOOM, BERT, RoBERTa,
DistilBERT, CLIP-text, Megatron-GPT, Llama, Mistral, Qwen2, Qwen3, Falcon
(7B/40B/11B), GPT-BigCode/StarCoder, Phi, Gemma, Gemma-2 and Mixtral: 21.

A loader takes a live ``nn.Module`` (read through ``state_dict()`` and
``.config``) or a state dict of tensors plus the HF config (any object
with HF's attribute names). torch Linear weights are [out, in] and
transpose into the [in, out] kernels; GPT-2's Conv1D is already [in, out].
Stacks and concatenations run on the state dict's own device, and every
leaf comes back as a float32 tensor that owns its memory (the tree never
aliases the caller's weights). ``transformers`` is never imported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from .transformer import Transformer, TransformerConfig

PyTree = Any

_ROADMAP = "see ROADMAP.md"


def _getter(sd, prefix: str, dtype=torch.float32):
    """Name -> tensor of ``sd[prefix + name]`` in ``dtype`` (float32;
    a tensor already in ``dtype`` is not copied)."""
    return lambda name: torch.as_tensor(sd[prefix + name]).detach().to(
        dtype)


def _t(w: torch.Tensor) -> torch.Tensor:
    """torch Linear [out, in] -> kernel [in, out]."""
    return w.transpose(0, 1)


def _own(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(t.shape, dtype=dtype, device=t.device).copy_(t)


def _to_f32(params: PyTree, dtype=torch.float32) -> PyTree:
    """Every leaf in ``dtype`` (float32) and owning its memory. The block
    leaves are fresh stacks already; the rest may be views of the
    caller's tensors and are copied."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _own(node, dtype)
    return {k: v if k == "blocks" else walk(v) for k, v in params.items()}


def load_hf_gpt2(model_or_state_dict,
                 config=None) -> Tuple[PyTree, TransformerConfig]:
    """Convert a HF GPT2LMHeadModel (or its state_dict) to (params, cfg).

    HF Conv1D stores weights [in, out], the kernel layout already, so
    kernels map without transposition."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "transformer.")
    g = _getter(sd, prefix)

    L = config.n_layer
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.n_positions,
        hidden_size=config.n_embd,
        num_layers=L,
        num_heads=config.n_head,
        tie_embeddings=True,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_epsilon),
    )

    _stk = _stacker(g, L)

    def stack(name):
        return _stk(lambda i: g(f"h.{i}.{name}"))

    blocks = {
        "ln1": {"scale": stack("ln_1.weight"), "bias": stack("ln_1.bias")},
        "attn_qkv": {"kernel": stack("attn.c_attn.weight"),
                     "bias": stack("attn.c_attn.bias")},
        "attn_proj": {"kernel": stack("attn.c_proj.weight"),
                      "bias": stack("attn.c_proj.bias")},
        "ln2": {"scale": stack("ln_2.weight"), "bias": stack("ln_2.bias")},
        "mlp_fc": {"kernel": stack("mlp.c_fc.weight"),
                   "bias": stack("mlp.c_fc.bias")},
        "mlp_proj": {"kernel": stack("mlp.c_proj.weight"),
                     "bias": stack("mlp.c_proj.bias")},
    }
    params = {
        "wte": {"embedding": g("wte.weight")},
        "wpe": {"embedding": g("wpe.weight")},
        "blocks": blocks,
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
    }
    return _to_f32(params), cfg


def _prefix(sd, candidate: str) -> str:
    """Detect whether keys carry the wrapper prefix (model vs bare decoder)."""
    return candidate if any(k.startswith(candidate) for k in sd) else ""


def _stacker(g, L: int):
    """Per-layer getter -> stacked [L, ...] leaf, each layer written into
    the stack as it is read (one layer's temporaries at a time)."""
    def stack(fn):
        first = fn(0)
        out = torch.empty((L,) + tuple(first.shape), dtype=first.dtype,
                          device=first.device)
        out[0] = first
        del first
        for i in range(1, L):
            out[i] = fn(i)
        return out
    return stack


def _concat_qkv_linear(g, fmt: str, names=("q", "k", "v")):
    """Separate torch Linear projections -> one [H, 3H] qkv kernel."""
    def kernel(i):
        return torch.cat([_t(g(fmt.format(i=i, p=p))) for p in names],
                         dim=1)

    def bias(i):
        return torch.cat([g(fmt.format(i=i, p=p).replace(
            ".weight", ".bias")) for p in names])

    return kernel, bias


def _sd_and_config(model_or_state_dict, config):
    if hasattr(model_or_state_dict, "state_dict"):
        return (dict(model_or_state_dict.state_dict()),
                config or model_or_state_dict.config)
    if config is None:
        raise ValueError("pass the HF config when giving a raw state_dict")
    return dict(model_or_state_dict), config


def load_hf_gpt_neo(model_or_state_dict, config=None):
    """GPT-Neo (HF GPTNeoForCausalLM): separate unbiased q/k/v torch Linears
    concat into the qkv kernel; unscaled attention (attn_scale=1.0);
    alternating global/local attention layers become layer_windows."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "transformer.")
    g = _getter(sd, prefix)
    L = config.num_layers
    # config.attention_layers: ["global", "local", ...] per layer
    windows = tuple(config.window_size if a == "local" else 0
                    for a in config.attention_layers)
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        hidden_size=config.hidden_size,
        num_layers=L,
        num_heads=config.num_heads,
        mlp_ratio=(config.intermediate_size or 4 * config.hidden_size)
        // config.hidden_size,
        tie_embeddings=True,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_epsilon),
        attn_scale=1.0,
        qkv_bias=False,
        layer_windows=windows if any(windows) else None,
    )

    def qkv(i):
        ws = [_t(g(f"h.{i}.attn.attention.{p}_proj.weight"))
              for p in ("q", "k", "v")]
        return torch.cat(ws, dim=1)                          # [H, 3H]

    stack = _stacker(g, L)

    blocks = {
        "ln1": {"scale": stack(lambda i: g(f"h.{i}.ln_1.weight")),
                "bias": stack(lambda i: g(f"h.{i}.ln_1.bias"))},
        "attn_qkv": {"kernel": stack(qkv)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.attn.attention.out_proj.weight"))),
            "bias": stack(lambda i: g(f"h.{i}.attn.attention.out_proj.bias"))},
        "ln2": {"scale": stack(lambda i: g(f"h.{i}.ln_2.weight")),
                "bias": stack(lambda i: g(f"h.{i}.ln_2.bias"))},
        "mlp_fc": {"kernel": stack(lambda i: _t(g(f"h.{i}.mlp.c_fc.weight"))),
                   "bias": stack(lambda i: g(f"h.{i}.mlp.c_fc.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.mlp.c_proj.weight"))),
            "bias": stack(lambda i: g(f"h.{i}.mlp.c_proj.bias"))},
    }
    params = {
        "wte": {"embedding": g("wte.weight")},
        "wpe": {"embedding": g("wpe.weight")},
        "blocks": blocks,
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
    }
    return _to_f32(params), cfg


def load_hf_gptj(model_or_state_dict, config=None):
    """GPT-J (HF GPTJForCausalLM): rotary positions, parallel attention+MLP
    residual off one shared LayerNorm, untied biased lm_head."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "transformer.")
    g = _getter(sd, prefix)
    top = _getter(sd, "")
    L = config.n_layer
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.n_positions,
        hidden_size=config.n_embd,
        num_layers=L,
        num_heads=config.n_head,
        mlp_ratio=(getattr(config, "n_inner", None) or 4 * config.n_embd)
        // config.n_embd,
        tie_embeddings=False,
        lm_head_bias=True,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_epsilon),
        pos_embed="rotary",
        rotary_dim=config.rotary_dim or 0,
        parallel_residual=True,
        qkv_bias=False,
        attn_out_bias=False,
    )

    def qkv(i):
        ws = [_t(g(f"h.{i}.attn.{p}_proj.weight")) for p in ("q", "k", "v")]
        return torch.cat(ws, dim=1)

    stack = _stacker(g, L)

    blocks = {
        "ln1": {"scale": stack(lambda i: g(f"h.{i}.ln_1.weight")),
                "bias": stack(lambda i: g(f"h.{i}.ln_1.bias"))},
        "attn_qkv": {"kernel": stack(qkv)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.attn.out_proj.weight")))},
        "mlp_fc": {"kernel": stack(lambda i: _t(g(f"h.{i}.mlp.fc_in.weight"))),
                   "bias": stack(lambda i: g(f"h.{i}.mlp.fc_in.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.mlp.fc_out.weight"))),
            "bias": stack(lambda i: g(f"h.{i}.mlp.fc_out.bias"))},
    }
    params = {
        "wte": {"embedding": g("wte.weight")},
        "blocks": blocks,
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
        "lm_head": {"kernel": _t(top("lm_head.weight")),
                    "bias": top("lm_head.bias")},
    }
    return _to_f32(params), cfg


def load_hf_opt(model_or_state_dict, config=None):
    """OPT (HF OPTForCausalLM): pre-LN decoder with ReLU and learned
    positions at a +2 offset, baked in by dropping the embedding table's
    first two rows."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "model.decoder.") or "decoder."
    g = _getter(sd, prefix)
    if not getattr(config, "do_layer_norm_before", True):
        raise NotImplementedError("OPT with do_layer_norm_before=False "
                                  "(350m variant) is post-LN; not mapped")
    if config.word_embed_proj_dim != config.hidden_size:
        raise NotImplementedError("OPT word_embed_proj_dim != hidden_size "
                                  "needs the projection layers")
    L = config.num_hidden_layers
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        hidden_size=config.hidden_size,
        num_layers=L,
        num_heads=config.num_attention_heads,
        mlp_ratio=config.ffn_dim // config.hidden_size,
        tie_embeddings=True,
        scan_layers=True,
        layer_norm_eps=1e-5,
        activation="relu",
    )
    qkv_w, qkv_b = _concat_qkv_linear(g, "layers.{i}.self_attn.{p}_proj.weight")
    stack = _stacker(g, L)

    blocks = {
        "ln1": {"scale": stack(
            lambda i: g(f"layers.{i}.self_attn_layer_norm.weight")),
            "bias": stack(lambda i: g(f"layers.{i}.self_attn_layer_norm.bias"))},
        "attn_qkv": {"kernel": stack(qkv_w), "bias": stack(qkv_b)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"layers.{i}.self_attn.out_proj.weight"))),
            "bias": stack(lambda i: g(f"layers.{i}.self_attn.out_proj.bias"))},
        "ln2": {"scale": stack(lambda i: g(f"layers.{i}.final_layer_norm.weight")),
                "bias": stack(lambda i: g(f"layers.{i}.final_layer_norm.bias"))},
        "mlp_fc": {"kernel": stack(lambda i: _t(g(f"layers.{i}.fc1.weight"))),
                   "bias": stack(lambda i: g(f"layers.{i}.fc1.bias"))},
        "mlp_proj": {"kernel": stack(lambda i: _t(g(f"layers.{i}.fc2.weight"))),
                     "bias": stack(lambda i: g(f"layers.{i}.fc2.bias"))},
    }
    params = {
        "wte": {"embedding": g("embed_tokens.weight")},
        # OPTLearnedPositionalEmbedding adds +2 to every position index
        "wpe": {"embedding": g("embed_positions.weight")[2:]},
        "blocks": blocks,
        "ln_f": {"scale": g("final_layer_norm.weight"),
                 "bias": g("final_layer_norm.bias")},
    }
    return _to_f32(params), cfg


def load_hf_bloom(model_or_state_dict, config=None, max_seq_len=None):
    """BLOOM (HF BloomForCausalLM): ALiBi attention, LayerNorm on the word
    embeddings, fused qkv stored head-major ([nh, 3, hd] on the out dim),
    permuted here into the contiguous q|k|v layout.

    ALiBi has no positional table, so max_seq_len is only a KV-cache
    sizing bound: the config's training length (seq_length, 2048 for the
    released BLOOMs) unless ``max_seq_len`` is given."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "transformer.")
    g = _getter(sd, prefix)
    L = config.n_layer
    H = config.hidden_size
    nh = config.n_head
    hd = H // nh
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=max_seq_len or getattr(config, "seq_length", 2048),
        hidden_size=H,
        num_layers=L,
        num_heads=nh,
        mlp_ratio=4,
        tie_embeddings=True,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_epsilon),
        pos_embed="alibi",
        embed_ln=True,
    )

    def qkv_w(i):
        w = g(f"h.{i}.self_attention.query_key_value.weight")  # [3H, H]
        w = w.reshape(nh, 3, hd, H).permute(1, 0, 2, 3).reshape(3 * H, H)
        return _t(w)                                           # [H, 3H]

    def qkv_b(i):
        b = g(f"h.{i}.self_attention.query_key_value.bias")
        return b.reshape(nh, 3, hd).permute(1, 0, 2).reshape(3 * H)

    stack = _stacker(g, L)

    blocks = {
        "ln1": {"scale": stack(lambda i: g(f"h.{i}.input_layernorm.weight")),
                "bias": stack(lambda i: g(f"h.{i}.input_layernorm.bias"))},
        "attn_qkv": {"kernel": stack(qkv_w), "bias": stack(qkv_b)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.self_attention.dense.weight"))),
            "bias": stack(lambda i: g(f"h.{i}.self_attention.dense.bias"))},
        "ln2": {"scale": stack(
            lambda i: g(f"h.{i}.post_attention_layernorm.weight")),
            "bias": stack(lambda i: g(f"h.{i}.post_attention_layernorm.bias"))},
        "mlp_fc": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.mlp.dense_h_to_4h.weight"))),
            "bias": stack(lambda i: g(f"h.{i}.mlp.dense_h_to_4h.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.mlp.dense_4h_to_h.weight"))),
            "bias": stack(lambda i: g(f"h.{i}.mlp.dense_4h_to_h.bias"))},
    }
    params = {
        "wte": {"embedding": g("word_embeddings.weight")},
        "ln_emb": {"scale": g("word_embeddings_layernorm.weight"),
                   "bias": g("word_embeddings_layernorm.bias")},
        "blocks": blocks,
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
    }
    return _to_f32(params), cfg


def _bert_encoder_blocks(g, L: int, enc: str = "encoder.layer."):
    """BERT-family encoder mapping shared by the BERT and RoBERTa loaders
    (identical HF key names and layouts)."""
    qkv_w, qkv_b = _concat_qkv_linear(
        g, enc + "{i}.attention.self.{p}.weight",
        names=("query", "key", "value"))
    stack = _stacker(g, L)
    return {
        "attn_qkv": {"kernel": stack(qkv_w), "bias": stack(qkv_b)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"{enc}{i}.attention.output.dense.weight"))),
            "bias": stack(lambda i: g(f"{enc}{i}.attention.output.dense.bias"))},
        "ln1": {"scale": stack(
            lambda i: g(f"{enc}{i}.attention.output.LayerNorm.weight")),
            "bias": stack(
                lambda i: g(f"{enc}{i}.attention.output.LayerNorm.bias"))},
        "mlp_fc": {"kernel": stack(
            lambda i: _t(g(f"{enc}{i}.intermediate.dense.weight"))),
            "bias": stack(lambda i: g(f"{enc}{i}.intermediate.dense.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"{enc}{i}.output.dense.weight"))),
            "bias": stack(lambda i: g(f"{enc}{i}.output.dense.bias"))},
        "ln2": {"scale": stack(lambda i: g(f"{enc}{i}.output.LayerNorm.weight")),
                "bias": stack(lambda i: g(f"{enc}{i}.output.LayerNorm.bias"))},
    }


def load_hf_bert(model_or_state_dict, config=None):
    """BERT (HF BertForMaskedLM): post-LN encoder with token-type embeddings
    and the MLM prediction head (transform + tied decoder + bias)."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "bert.")
    g = _getter(sd, prefix)
    top = _getter(sd, "")
    L = config.num_hidden_layers
    act = {"gelu": "gelu_exact", "gelu_new": "gelu", "relu": "relu"}[
        config.hidden_act]
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        hidden_size=config.hidden_size,
        num_layers=L,
        num_heads=config.num_attention_heads,
        mlp_ratio=config.intermediate_size // config.hidden_size,
        causal=False,
        tie_embeddings=True,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_eps),
        activation=act,
        post_ln=True,
        embed_ln=True,
        token_type_vocab=config.type_vocab_size,
        mlm_head=True,
    )
    blocks = _bert_encoder_blocks(g, L)
    params = {
        "wte": {"embedding": g("embeddings.word_embeddings.weight")},
        "wpe": {"embedding": g("embeddings.position_embeddings.weight")},
        "tte": {"embedding": g("embeddings.token_type_embeddings.weight")},
        "ln_emb": {"scale": g("embeddings.LayerNorm.weight"),
                   "bias": g("embeddings.LayerNorm.bias")},
        "blocks": blocks,
        "mlm_transform": {
            "kernel": _t(top("cls.predictions.transform.dense.weight")),
            "bias": top("cls.predictions.transform.dense.bias")},
        "mlm_ln": {"scale": top("cls.predictions.transform.LayerNorm.weight"),
                   "bias": top("cls.predictions.transform.LayerNorm.bias")},
        "mlm_bias": top("cls.predictions.bias"),
    }
    return _to_f32(params), cfg


def load_hf_roberta(model_or_state_dict, config=None):
    """RoBERTa (HF RobertaForMaskedLM): BERT's post-LN encoder with position
    ids offset by padding_idx+1 (baked in by dropping the first rows) and
    the lm_head transform instead of cls.predictions."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "roberta.")
    g = _getter(sd, prefix)
    top = _getter(sd, "")
    L = config.num_hidden_layers
    offset = config.pad_token_id + 1          # RoBERTa position offset
    act = {"gelu": "gelu_exact", "gelu_new": "gelu", "relu": "relu"}[
        config.hidden_act]
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings - offset,
        hidden_size=config.hidden_size,
        num_layers=L,
        num_heads=config.num_attention_heads,
        mlp_ratio=config.intermediate_size // config.hidden_size,
        causal=False,
        tie_embeddings=True,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_eps),
        activation=act,
        post_ln=True,
        embed_ln=True,
        token_type_vocab=config.type_vocab_size,
        mlm_head=True,
    )
    blocks = _bert_encoder_blocks(g, L)
    params = {
        "wte": {"embedding": g("embeddings.word_embeddings.weight")},
        "wpe": {"embedding": g("embeddings.position_embeddings.weight")[offset:]},
        "tte": {"embedding": g("embeddings.token_type_embeddings.weight")},
        "ln_emb": {"scale": g("embeddings.LayerNorm.weight"),
                   "bias": g("embeddings.LayerNorm.bias")},
        "blocks": blocks,
        "mlm_transform": {"kernel": _t(top("lm_head.dense.weight")),
                          "bias": top("lm_head.dense.bias")},
        "mlm_ln": {"scale": top("lm_head.layer_norm.weight"),
                   "bias": top("lm_head.layer_norm.bias")},
        "mlm_bias": top("lm_head.bias"),
    }
    return _to_f32(params), cfg


def load_hf_distilbert(model_or_state_dict, config=None):
    """DistilBERT (HF DistilBertForMaskedLM): BERT-style post-LN encoder,
    no token-type embeddings, vocab_transform/vocab_projector MLM head."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "distilbert.")
    g = _getter(sd, prefix)
    top = _getter(sd, "")
    L = config.n_layers
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        hidden_size=config.dim,
        num_layers=L,
        num_heads=config.n_heads,
        mlp_ratio=config.hidden_dim // config.dim,
        causal=False,
        tie_embeddings=True,
        scan_layers=True,
        layer_norm_eps=1e-12,
        activation="gelu_exact" if config.activation == "gelu" else "relu",
        post_ln=True,
        embed_ln=True,
        mlm_head=True,
    )
    lyr = "transformer.layer."
    qkv_w, qkv_b = _concat_qkv_linear(
        g, lyr + "{i}.attention.{p}_lin.weight", names=("q", "k", "v"))
    stack = _stacker(g, L)
    blocks = {
        "attn_qkv": {"kernel": stack(qkv_w), "bias": stack(qkv_b)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"{lyr}{i}.attention.out_lin.weight"))),
            "bias": stack(lambda i: g(f"{lyr}{i}.attention.out_lin.bias"))},
        "ln1": {"scale": stack(lambda i: g(f"{lyr}{i}.sa_layer_norm.weight")),
                "bias": stack(lambda i: g(f"{lyr}{i}.sa_layer_norm.bias"))},
        "mlp_fc": {"kernel": stack(
            lambda i: _t(g(f"{lyr}{i}.ffn.lin1.weight"))),
            "bias": stack(lambda i: g(f"{lyr}{i}.ffn.lin1.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"{lyr}{i}.ffn.lin2.weight"))),
            "bias": stack(lambda i: g(f"{lyr}{i}.ffn.lin2.bias"))},
        "ln2": {"scale": stack(
            lambda i: g(f"{lyr}{i}.output_layer_norm.weight")),
            "bias": stack(lambda i: g(f"{lyr}{i}.output_layer_norm.bias"))},
    }
    params = {
        "wte": {"embedding": g("embeddings.word_embeddings.weight")},
        "wpe": {"embedding": g("embeddings.position_embeddings.weight")},
        "ln_emb": {"scale": g("embeddings.LayerNorm.weight"),
                   "bias": g("embeddings.LayerNorm.bias")},
        "blocks": blocks,
        "mlm_transform": {"kernel": _t(top("vocab_transform.weight")),
                          "bias": top("vocab_transform.bias")},
        "mlm_ln": {"scale": top("vocab_layer_norm.weight"),
                   "bias": top("vocab_layer_norm.bias")},
        "mlm_bias": top("vocab_projector.bias"),
    }
    return _to_f32(params), cfg


def _deinterleave_qkv(w, b, nh: int, hd: int):
    """Per-head-interleaved fused qkv ([nh, 3, hd] out-rows, GPT-NeoX /
    Megatron v2+) -> the [H, 3H] kernel with q/k/v column groups."""
    H = nh * hd
    wr = w.reshape(nh, 3, hd, H)
    kernel = torch.cat(
        [_t(wr[:, j].reshape(H, H)) for j in range(3)], dim=1)   # [H, 3H]
    bias = None
    if b is not None:
        br = b.reshape(nh, 3, hd)
        bias = torch.cat([br[:, j].reshape(H) for j in range(3)])
    return kernel, bias


def load_hf_gpt_neox(model_or_state_dict, config=None):
    """GPT-NeoX (HF GPTNeoXForCausalLM, e.g. Pythia): dual-LayerNorm parallel
    residual (x + attn(ln1 x) + mlp(ln2 x)), rotate_half rotary over
    rotary_pct of head_dim, per-head-interleaved fused qkv, untied unbiased
    embed_out."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "gpt_neox.")
    g = _getter(sd, prefix)
    top = _getter(sd, "")
    L = config.num_hidden_layers
    nh = config.num_attention_heads
    H = config.hidden_size
    hd = H // nh
    parallel = bool(getattr(config, "use_parallel_residual", True))
    base = float(getattr(config, "rotary_emb_base", 10000.0))
    cfg = TransformerConfig(
        rope_theta=base,
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        hidden_size=H,
        num_layers=L,
        num_heads=nh,
        mlp_ratio=config.intermediate_size // H,
        tie_embeddings=False,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_eps),
        pos_embed="rotary",
        rotary_dim=int(hd * config.rotary_pct),
        rotary_interleaved=False,
        parallel_residual=parallel,
        parallel_residual_dual_ln=parallel,
        # HF ACT2FN["gelu"] is exact-erf (the NeoX default); "gelu" here
        # is the tanh approximation. A strict map: unknown activations
        # fail at load, not in the forward
        activation={"gelu": "gelu_exact", "gelu_new": "gelu",
                    "gelu_pytorch_tanh": "gelu", "relu": "relu",
                    "quick_gelu": "quick_gelu"}[
            getattr(config, "hidden_act", "gelu")],
    )

    qkv_ws, qkv_bs = zip(*[_deinterleave_qkv(
        g(f"layers.{i}.attention.query_key_value.weight"),
        g(f"layers.{i}.attention.query_key_value.bias"), nh, hd)
        for i in range(L)])

    stack = _stacker(g, L)
    blocks = {
        "ln1": {"scale": stack(lambda i: g(f"layers.{i}.input_layernorm.weight")),
                "bias": stack(lambda i: g(f"layers.{i}.input_layernorm.bias"))},
        "ln2": {"scale": stack(
            lambda i: g(f"layers.{i}.post_attention_layernorm.weight")),
            "bias": stack(
            lambda i: g(f"layers.{i}.post_attention_layernorm.bias"))},
        "attn_qkv": {"kernel": torch.stack(qkv_ws),
                     "bias": torch.stack(qkv_bs)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"layers.{i}.attention.dense.weight"))),
            "bias": stack(lambda i: g(f"layers.{i}.attention.dense.bias"))},
        "mlp_fc": {"kernel": stack(
            lambda i: _t(g(f"layers.{i}.mlp.dense_h_to_4h.weight"))),
            "bias": stack(lambda i: g(f"layers.{i}.mlp.dense_h_to_4h.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"layers.{i}.mlp.dense_4h_to_h.weight"))),
            "bias": stack(lambda i: g(f"layers.{i}.mlp.dense_4h_to_h.bias"))},
    }
    params = {
        "wte": {"embedding": g("embed_in.weight")},
        "blocks": blocks,
        "ln_f": {"scale": g("final_layer_norm.weight"),
                 "bias": g("final_layer_norm.bias")},
        "lm_head": {"kernel": _t(top("embed_out.weight"))},
    }
    return _to_f32(params), cfg


def load_hf_clip_text(model_or_state_dict, config=None):
    """CLIP text encoder (HF CLIPTextModel): causal pre-LN stack with
    quick_gelu and no LM head; the output is the final hidden states."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    if hasattr(config, "text_config"):      # full CLIPConfig passed
        config = config.text_config
    prefix = _prefix(sd, "text_model.")
    g = _getter(sd, prefix)
    L = config.num_hidden_layers
    H = config.hidden_size
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        hidden_size=H,
        num_layers=L,
        num_heads=config.num_attention_heads,
        mlp_ratio=config.intermediate_size // H,
        tie_embeddings=False,
        no_lm_head=True,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_eps),
        activation={"quick_gelu": "quick_gelu", "gelu": "gelu_exact"}.get(
            config.hidden_act, config.hidden_act),
        causal=True,
    )
    fmt = "encoder.layers.{i}.self_attn.{p}_proj.weight"
    qkv_kernel, qkv_bias = _concat_qkv_linear(g, fmt)
    stack = _stacker(g, L)
    blocks = {
        "ln1": {"scale": stack(
            lambda i: g(f"encoder.layers.{i}.layer_norm1.weight")),
            "bias": stack(lambda i: g(f"encoder.layers.{i}.layer_norm1.bias"))},
        "attn_qkv": {"kernel": stack(qkv_kernel), "bias": stack(qkv_bias)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"encoder.layers.{i}.self_attn.out_proj.weight"))),
            "bias": stack(
            lambda i: g(f"encoder.layers.{i}.self_attn.out_proj.bias"))},
        "ln2": {"scale": stack(
            lambda i: g(f"encoder.layers.{i}.layer_norm2.weight")),
            "bias": stack(lambda i: g(f"encoder.layers.{i}.layer_norm2.bias"))},
        "mlp_fc": {"kernel": stack(
            lambda i: _t(g(f"encoder.layers.{i}.mlp.fc1.weight"))),
            "bias": stack(lambda i: g(f"encoder.layers.{i}.mlp.fc1.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"encoder.layers.{i}.mlp.fc2.weight"))),
            "bias": stack(lambda i: g(f"encoder.layers.{i}.mlp.fc2.bias"))},
    }
    params = {
        "wte": {"embedding": g("embeddings.token_embedding.weight")},
        "wpe": {"embedding": g("embeddings.position_embedding.weight")},
        "blocks": blocks,
        "ln_f": {"scale": g("final_layer_norm.weight"),
                 "bias": g("final_layer_norm.bias")},
    }
    return _to_f32(params), cfg


def load_megatron_gpt(state_dict, config, version: int = 2):
    """Megatron-LM GPT (NVIDIA checkpoint 'model' dict): pre-LN GPT-2-shaped
    stack under language_model.{embedding,transformer|encoder} keys with a
    fused query_key_value whose row layout depends on checkpoint version:
    >=2 per-head [q|k|v] interleaved; 0 q/k/v chunked. Tied embeddings.
    ``config`` needs num_layers/hidden_size/num_heads/vocab_size/
    max_seq_len (a dict or any attribute object)."""
    get = (config.get if isinstance(config, dict)
           else lambda k, d=None: getattr(config, k, d))
    L, H = get("num_layers"), get("hidden_size")
    nh = get("num_heads")
    hd = H // nh
    sd = dict(state_dict)
    lm = _prefix(sd, "language_model.")
    enc = "transformer." if any(
        k.startswith(f"{lm}transformer.") for k in sd) else "encoder."
    g = _getter(sd, lm)
    ge = lambda n: g(enc + n)
    cfg = TransformerConfig(
        vocab_size=get("vocab_size"),
        max_seq_len=get("max_seq_len", 1024),
        hidden_size=H, num_layers=L, num_heads=nh,
        mlp_ratio=get("mlp_ratio", 4),
        tie_embeddings=True, scan_layers=True,
        layer_norm_eps=float(get("layer_norm_eps", 1e-5)),
    )

    def qkv(i):
        w = ge(f"layers.{i}.attention.query_key_value.weight")
        b = ge(f"layers.{i}.attention.query_key_value.bias")
        if version >= 2:
            return _deinterleave_qkv(w, b, nh, hd)
        return _t(w), b                            # chunked: already [q|k|v]

    qkv_ws, qkv_bs = zip(*[qkv(i) for i in range(L)])
    stack = _stacker(g, L)
    blocks = {
        "ln1": {"scale": stack(lambda i: ge(f"layers.{i}.input_layernorm.weight")),
                "bias": stack(lambda i: ge(f"layers.{i}.input_layernorm.bias"))},
        "attn_qkv": {"kernel": torch.stack(qkv_ws),
                     "bias": torch.stack(qkv_bs)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(ge(f"layers.{i}.attention.dense.weight"))),
            "bias": stack(lambda i: ge(f"layers.{i}.attention.dense.bias"))},
        "ln2": {"scale": stack(
            lambda i: ge(f"layers.{i}.post_attention_layernorm.weight")),
            "bias": stack(
            lambda i: ge(f"layers.{i}.post_attention_layernorm.bias"))},
        "mlp_fc": {"kernel": stack(
            lambda i: _t(ge(f"layers.{i}.mlp.dense_h_to_4h.weight"))),
            "bias": stack(lambda i: ge(f"layers.{i}.mlp.dense_h_to_4h.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(ge(f"layers.{i}.mlp.dense_4h_to_h.weight"))),
            "bias": stack(lambda i: ge(f"layers.{i}.mlp.dense_4h_to_h.bias"))},
    }
    params = {
        "wte": {"embedding": g("embedding.word_embeddings.weight")},
        "wpe": {"embedding": g("embedding.position_embeddings.weight")},
        "blocks": blocks,
        "ln_f": {"scale": ge("final_layernorm.weight"),
                 "bias": ge("final_layernorm.bias")},
    }
    return _to_f32(params), cfg


def stack_layers(layer, L: int) -> PyTree:
    """``layer(i)`` -> a tree of one layer's leaves; returns the same tree
    of stacked [L, ...] leaves, each layer written into the stacks as it
    is made (one layer's temporaries at a time)."""
    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        return torch.empty((L,) + tuple(node.shape), dtype=node.dtype,
                           device=node.device)

    def write(dst, node, i):
        for k, v in node.items():
            if isinstance(v, dict):
                write(dst[k], v, i)
            else:
                dst[k][i] = v

    first = layer(0)
    out = alloc(first)
    write(out, first, 0)
    del first
    for i in range(1, L):
        write(out, layer(i), i)
    return out


def llama_layer(g, i: int, qkv_bias=False, o_bias=False, mlp_bias=False,
                qk_norm=False, moe_experts=0, norm_plus_one=False,
                sandwich_norms=False) -> PyTree:
    """Layer ``i`` of the Llama/Mistral/Qwen2/Qwen3/Mixtral/Gemma block
    mapping, in the scan layout without the layer dim: RMSNorm + GQA qkv
    ([q | k | v] columns, every kernel [in, out]) + SwiGLU (dense, or
    ``moe_experts`` SwiGLU experts behind a router: HF block_sparse_moe
    w1/w3/w2 -> moe.experts gate/fc/proj). ``g(name)``: the HF tensor of
    ``layers.{i}.<name>`` (under the model prefix). The bias flags are
    presence-driven by the caller (Llama attention_bias has q/k/v/o
    biases; Qwen2 q/k/v only; mlp_bias biases gate/up/down; qk_norm adds
    Qwen3's per-head q/k RMSNorm)."""
    at = lambda name: g(f"layers.{i}.{name}")
    # Gemma stores RMSNorm weights as w with the forward computing
    # x * (1 + w): folding the +1 into the stored scale makes the plain
    # scale-multiply RMSNorm equivalent. The fold happens in f32 (like
    # HF's 1.0 + weight.float()) for 16-bit state dicts too
    ln_w = ((lambda a: (a.float() + 1.0).to(a.dtype)) if norm_plus_one
            else (lambda a: a))

    def proj(hf, biased):
        p = {"kernel": _t(at(f"{hf}.weight"))}
        if biased:
            p["bias"] = at(f"{hf}.bias")
        return p

    qkv = {"kernel": torch.cat([_t(at(f"self_attn.{p}_proj.weight"))
                                for p in ("q", "k", "v")], dim=1)}
    if qkv_bias:
        qkv["bias"] = torch.cat([at(f"self_attn.{p}_proj.bias")
                                 for p in ("q", "k", "v")])
    # Gemma-2 sandwich layout: post_attention_layernorm is the POST-attn
    # branch norm and pre_feedforward_layernorm takes the pre-MLP (ln2)
    # slot; everyone else's post_attention_layernorm IS the pre-MLP norm
    ln2_src = ("pre_feedforward_layernorm" if sandwich_norms
               else "post_attention_layernorm")
    layer = {
        "ln1": {"scale": ln_w(at("input_layernorm.weight"))},
        "attn_qkv": qkv,                      # [H, (nh + 2*kv) * hd]
        "attn_proj": proj("self_attn.o_proj", o_bias),
        "ln2": {"scale": ln_w(at(f"{ln2_src}.weight"))},
    }
    if sandwich_norms:
        for ours, hfn in (("post_attn_norm", "post_attention_layernorm"),
                          ("post_mlp_norm", "post_feedforward_layernorm")):
            layer[ours] = {"scale": ln_w(at(f"{hfn}.weight"))}
    if moe_experts > 0:
        def experts(w):
            """[E, in, out] expert-stacked kernels (HF stores [out, in])."""
            return torch.stack(
                [_t(at(f"block_sparse_moe.experts.{j}.{w}.weight"))
                 for j in range(moe_experts)])

        layer["moe"] = {
            "gate": {"kernel": _t(at("block_sparse_moe.gate.weight"))},
            # HF MixtralBlockSparseTop2MLP: w1 = gate, w3 = up, w2 = down
            "experts": {"gate": {"kernel": experts("w1")},
                        "fc": {"kernel": experts("w3")},
                        "proj": {"kernel": experts("w2")}},
        }
    else:
        layer.update(
            mlp_gate=proj("mlp.gate_proj", mlp_bias),
            mlp_fc=proj("mlp.up_proj", mlp_bias),
            mlp_proj=proj("mlp.down_proj", mlp_bias),
        )
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            layer[name] = {"scale": at(f"self_attn.{name}.weight")}
    return layer


def _llama_family_params(sd, prefix, L, dtype=torch.float32, **flags):
    """The Llama-family tree (:func:`llama_layer`'s layers stacked, the
    embedding and the final norm) with leaves read in ``dtype``
    (float32)."""
    g = _getter(sd, prefix, dtype)
    ln_f = g("norm.weight")
    if flags.get("norm_plus_one"):
        ln_f = (ln_f.float() + 1.0).to(ln_f.dtype)
    params = {
        "wte": {"embedding": g("embed_tokens.weight")},
        "blocks": stack_layers(lambda i: llama_layer(g, i, **flags), L),
        "ln_f": {"scale": ln_f},
    }
    return params, g


def _load_hf_llama_family(model_or_state_dict, config,
                          use_sliding_window=False, moe=False,
                          activation="silu", embed_scale=None,
                          norm_plus_one=False, gemma2=False,
                          dtype=torch.float32):
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "model.")
    L = config.num_hidden_layers
    moe_experts = int(getattr(config, "num_local_experts", 0)) if moe else 0
    moe_k = int(getattr(config, "num_experts_per_tok", 2)) if moe else 1
    windows = None
    if use_sliding_window:
        w = getattr(config, "sliding_window", None)
        if use_sliding_window == "qwen2":
            # Qwen2 gates the window behind use_sliding_window and leaves
            # the first max_window_layers on full attention
            if getattr(config, "use_sliding_window", False) and w:
                mw = int(getattr(config, "max_window_layers", 0))
                windows = tuple(0 if i < mw else int(w) for i in range(L))
        elif use_sliding_window == "layer_types":
            # Qwen3 / Gemma-2: per-layer attention kind in config.layer_types
            lt = getattr(config, "layer_types", None)
            if w and lt:
                windows = tuple(int(w) if t == "sliding_attention" else 0
                                for t in lt)
            elif w:
                # the JAX package loads this config with every layer global
                # (a divergence recorded in ROADMAP.md Queue 3)
                raise NotImplementedError(
                    f"config sets sliding_window={w} but no layer_types: "
                    "which layers slide is unknown, and loading every "
                    f"layer as global would be wrong ({_ROADMAP}, Queue 3)")
        elif w:                                  # Mistral: every layer
            windows = (int(w),) * L
    kv = getattr(config, "num_key_value_heads", None) \
        or config.num_attention_heads
    tie = bool(getattr(config, "tie_word_embeddings", False))
    # scaled RoPE (Llama-3.1+ / linear PI / dynamic NTK) maps onto the
    # static rope_scaling_* config knobs (TransformerConfig.rope_inv_freq
    # mirrors HF modeling_rope_utils). Unsupported geometries (yarn /
    # longrope) fail here rather than decode garbage
    scaling = getattr(config, "rope_scaling", None) or {}
    rope_type = scaling.get("rope_type", scaling.get("type", "default"))
    if rope_type not in ("default", "linear", "dynamic", "llama3"):
        raise NotImplementedError(
            f"rope_scaling type {rope_type!r} is not implemented "
            "(yarn / longrope): loading with plain rope_theta would "
            "produce wrong frequencies")
    rope_kwargs = {}
    if rope_type != "default":
        # "factor" is mandatory for every scaled type (HF raises KeyError
        # in modeling_rope_utils too): a missing key must not load as an
        # unscaled table
        rope_kwargs = dict(
            rope_scaling_type=rope_type,
            rope_scaling_factor=float(scaling["factor"]),
            # dynamic NTK: HF ignores the dict's
            # original_max_position_embeddings and stretches relative to
            # config.max_position_embeddings; llama3 reads the dict key
            rope_original_max_position=int(
                config.max_position_embeddings if rope_type != "llama3"
                else scaling.get("original_max_position_embeddings",
                                 config.max_position_embeddings)),
        )
        if rope_type == "llama3":
            rope_kwargs.update(
                rope_low_freq_factor=float(scaling["low_freq_factor"]),
                rope_high_freq_factor=float(scaling["high_freq_factor"]))
    # decoupled head_dim (Mistral-Nemo style): qkv projects to
    # (nh + 2*kv) * head_dim independent of hidden_size/num_heads
    hd_cfg = getattr(config, "head_dim", None)
    # bias flags are presence-driven: a fresh Qwen2 carries zero q/k/v
    # biases that a config-only check could drop while still passing
    # random-init parity
    qkv_bias = prefix + "layers.0.self_attn.q_proj.bias" in sd
    o_bias = prefix + "layers.0.self_attn.o_proj.bias" in sd
    mlp_bias = prefix + "layers.0.mlp.gate_proj.bias" in sd
    qk_norm = prefix + "layers.0.self_attn.q_norm.weight" in sd
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        hidden_size=config.hidden_size,
        num_layers=L,
        num_heads=config.num_attention_heads,
        num_kv_heads=kv,
        mlp_dim_override=config.intermediate_size,
        norm="rmsnorm",
        gated_mlp=True,
        activation=activation,
        embed_scale=embed_scale,
        pos_embed="rotary",
        rotary_interleaved=False,           # HF rotate_half layout
        rope_theta=float(getattr(config, "rope_theta", 10000.0)),
        head_dim_override=int(hd_cfg) if hd_cfg else None,
        use_bias=False,
        qkv_bias=qkv_bias,
        attn_out_bias=o_bias,
        mlp_bias=mlp_bias,
        qk_norm=qk_norm,
        tie_embeddings=tie,
        layer_norm_eps=float(config.rms_norm_eps),
        layer_windows=windows,
        scan_layers=True,
        # Mixtral: the capacity factor E/k makes the GShard queues
        # drop-free, matching HF's capacity-less routing at eval
        moe_experts=moe_experts,
        moe_k=moe_k,
        moe_capacity_factor=(float(moe_experts) / moe_k if moe_experts
                             else 1.25),
        moe_aux_weight=float(getattr(config, "router_aux_loss_coef", 0.01)),
        # Gemma-2: sandwich norms, tanh softcapping on attention scores and
        # final logits, and the query_pre_attn_scalar attention scale
        post_block_norms=gemma2,
        attn_softcap=(float(getattr(config, "attn_logit_softcapping", 0)
                            or 0) if gemma2 else 0.0),
        final_logit_softcap=(float(getattr(config,
                                           "final_logit_softcapping", 0)
                                   or 0) if gemma2 else 0.0),
        attn_scale=(float(config.query_pre_attn_scalar) ** -0.5
                    if gemma2 else None),
        **rope_kwargs,
    )
    params, g = _llama_family_params(sd, prefix, L, qkv_bias=qkv_bias,
                                     o_bias=o_bias, mlp_bias=mlp_bias,
                                     qk_norm=qk_norm,
                                     moe_experts=moe_experts,
                                     norm_plus_one=norm_plus_one,
                                     sandwich_norms=gemma2, dtype=dtype)
    if not tie:
        if "lm_head.weight" not in sd:
            # fail loudly like every other CausalLM loader: a tied head
            # fabricated for an untied checkpoint would decode garbage
            raise KeyError(
                "untied checkpoint (tie_word_embeddings=False) has no "
                "lm_head.weight — is this a bare LlamaModel state dict? "
                "Export the ForCausalLM model, or set tie_word_embeddings")
        params["lm_head"] = {"kernel": _t(_getter(sd, "", dtype)(
            "lm_head.weight"))}
    return _to_f32(params, dtype), cfg


def load_hf_llama(model_or_state_dict, config=None):
    """Llama/Llama-2/3 (HF LlamaForCausalLM): RMSNorm pre-norm, SwiGLU MLP,
    GQA, rotate_half rotary with config rope_theta."""
    return _load_hf_llama_family(model_or_state_dict, config)


def load_hf_mistral(model_or_state_dict, config=None):
    """Mistral (HF MistralForCausalLM): the Llama block family plus a
    uniform sliding attention window on every layer."""
    return _load_hf_llama_family(model_or_state_dict, config,
                                 use_sliding_window=True)


def load_hf_qwen2(model_or_state_dict, config=None):
    """Qwen2/Qwen2.5 (HF Qwen2ForCausalLM): the Llama block family with
    q/k/v biases (no o bias, detected from the state dict), optionally
    tied embeddings, and a sliding window gated behind use_sliding_window
    with the first max_window_layers on full attention."""
    return _load_hf_llama_family(model_or_state_dict, config,
                                 use_sliding_window="qwen2")


def load_hf_qwen3(model_or_state_dict, config=None):
    """Qwen3 (HF Qwen3ForCausalLM): the Llama block family with per-head
    q/k RMSNorm before rotary, a decoupled head_dim, no attention biases,
    and per-layer sliding windows driven by config.layer_types."""
    return _load_hf_llama_family(model_or_state_dict, config,
                                 use_sliding_window="layer_types")


def load_hf_falcon(model_or_state_dict, config=None):
    """Falcon (HF FalconForCausalLM), two supported variants:

    * 7B-style (multi_query, parallel_attn, single input_layernorm):
      GPT-J-style parallel residual with a shared LN, MQA (kv=1), fused
      query_key_value already in q|k|v order.
    * 40B-style (new_decoder_architecture): parallel residual with SEPARATE
      ln_attn/ln_mlp (parallel_residual_dual_ln), GQA, and the fused qkv
      interleaved PER KV GROUP ([q_g0.., k0, v0, q_g1.., k1, v1]),
      de-interleaved here into the q|k|v kernel layout.

    Both: rotate_half rotary, exact-erf GELU MLP, no biases except the
    layernorms, tied embeddings. Legacy falcon-rw variants (alibi or
    sequential blocks) are refused loudly."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "transformer.")
    g = _getter(sd, prefix)
    L = config.num_hidden_layers
    nh = config.num_attention_heads
    H = config.hidden_size
    hd = H // nh
    new_arch = bool(getattr(config, "new_decoder_architecture", False))
    if getattr(config, "alibi", False) or not (
            new_arch or getattr(config, "parallel_attn", False)):
        raise NotImplementedError(
            "only the rotary parallel-attention Falcon variants are "
            "supported (7B-style multi_query/parallel_attn or 40B-style "
            "new_decoder_architecture); alibi / sequential falcon-rw "
            "checkpoints would load with the wrong block math")
    if new_arch:
        kv = int(config.num_kv_heads)
    elif getattr(config, "multi_query", True):
        kv = 1
    else:
        raise NotImplementedError(
            "Falcon multi_query=False (per-head-interleaved MHA qkv) is "
            "not supported")
    if getattr(config, "rope_scaling", None):
        raise NotImplementedError(
            f"Falcon rope_scaling={config.rope_scaling} is not wired into "
            "this policy; loading with plain rope_theta would produce "
            "wrong frequencies")
    if prefix + "h.0.self_attention.query_key_value.bias" in sd:
        raise NotImplementedError(
            "Falcon config.bias=True checkpoints (biased linears) are not "
            "supported; silently dropping the biases would change every "
            "projection")
    # Falcon2-11B: new_decoder_architecture with ONE shared layernorm
    # (num_ln_in_parallel_attn=1), presence-driven like the bias flags
    dual_ln = new_arch and prefix + "h.0.ln_attn.weight" in sd

    def qkv(i):
        w = g(f"h.{i}.self_attention.query_key_value.weight")
        if new_arch:
            # [(kv, nh/kv + 2, hd), H] groups -> contiguous q | k | v
            w = w.reshape(kv, nh // kv + 2, hd, H)
            q = w[:, :-2].reshape(nh * hd, H)
            k = w[:, -2].reshape(kv * hd, H)
            v = w[:, -1].reshape(kv * hd, H)
            w = torch.cat([q, k, v], dim=0)
        return _t(w)                                # [H, (nh + 2*kv) * hd]

    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=getattr(config, "max_position_embeddings", 2048),
        hidden_size=H,
        num_layers=L,
        num_heads=nh,
        num_kv_heads=kv,
        mlp_dim_override=int(getattr(config, "ffn_hidden_size", None)
                             or 4 * H),
        # strict map (HF get_activation(config.activation); "gelu" = erf):
        # unknown activations fail at load, not in the forward
        activation={"gelu": "gelu_exact", "gelu_pytorch_tanh": "gelu",
                    "gelu_new": "gelu", "relu": "relu"}[
            getattr(config, "activation", "gelu")],
        pos_embed="rotary",
        rotary_interleaved=False,                   # rotate_half
        rope_theta=float(getattr(config, "rope_theta", 10000.0)),
        parallel_residual=True,
        parallel_residual_dual_ln=dual_ln,
        use_bias=False,
        tie_embeddings=True,
        layer_norm_eps=float(config.layer_norm_epsilon),
        scan_layers=True,
    )
    stack = _stacker(g, L)
    ln1 = "ln_attn" if dual_ln else "input_layernorm"
    blocks = {
        "ln1": {"scale": stack(lambda i: g(f"h.{i}.{ln1}.weight")),
                "bias": stack(lambda i: g(f"h.{i}.{ln1}.bias"))},
        "attn_qkv": {"kernel": stack(qkv)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.self_attention.dense.weight")))},
        "mlp_fc": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.mlp.dense_h_to_4h.weight")))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"h.{i}.mlp.dense_4h_to_h.weight")))},
    }
    if dual_ln:
        blocks["ln2"] = {"scale": stack(lambda i: g(f"h.{i}.ln_mlp.weight")),
                         "bias": stack(lambda i: g(f"h.{i}.ln_mlp.bias"))}
    params = {
        "wte": {"embedding": g("word_embeddings.weight")},
        "blocks": blocks,
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
    }
    return _to_f32(params), cfg


def load_hf_gpt_bigcode(model_or_state_dict, config=None):
    """GPT-BigCode / StarCoder (HF GPTBigCodeForCausalLM): the GPT-2 block
    family with MULTI-QUERY attention (one shared k/v head). HF's fused
    c_attn is [H + 2*head_dim, H] with q first, then the single k and v
    head: the GQA qkv kernel layout at num_kv_heads=1, so the kernel maps
    with only a transpose (nn.Linear, not GPT-2's Conv1D). tanh-GELU MLP,
    learned positions, tied embeddings."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "transformer.")
    g = _getter(sd, prefix)
    L = config.n_layer
    if not getattr(config, "multi_query", True):
        raise NotImplementedError(
            "GPTBigCode with multi_query=False stores c_attn in the "
            "interleaved per-head MHA layout; only the multi-query form "
            "(StarCoder) is supported")
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.n_positions,
        hidden_size=config.n_embd,
        num_layers=L,
        num_heads=config.n_head,
        num_kv_heads=1,                       # MQA
        mlp_dim_override=config.n_inner or 4 * config.n_embd,
        # strict map: unknown activations fail at load, and HF "gelu"
        # (exact erf) is NOT the tanh "gelu" here
        activation={"gelu_pytorch_tanh": "gelu", "gelu_new": "gelu",
                    "gelu": "gelu_exact", "relu": "relu"}[
            getattr(config, "activation_function", "gelu_pytorch_tanh")],
        tie_embeddings=True,
        scan_layers=True,
        layer_norm_eps=float(config.layer_norm_epsilon),
    )
    _stk = _stacker(g, L)
    stack = lambda name, t=True: _stk(
        lambda i: _t(g(f"h.{i}.{name}")) if t else g(f"h.{i}.{name}"))
    blocks = {
        "ln1": {"scale": stack("ln_1.weight", t=False),
                "bias": stack("ln_1.bias", t=False)},
        "attn_qkv": {"kernel": stack("attn.c_attn.weight"),
                     "bias": stack("attn.c_attn.bias", t=False)},
        "attn_proj": {"kernel": stack("attn.c_proj.weight"),
                      "bias": stack("attn.c_proj.bias", t=False)},
        "ln2": {"scale": stack("ln_2.weight", t=False),
                "bias": stack("ln_2.bias", t=False)},
        "mlp_fc": {"kernel": stack("mlp.c_fc.weight"),
                   "bias": stack("mlp.c_fc.bias", t=False)},
        "mlp_proj": {"kernel": stack("mlp.c_proj.weight"),
                     "bias": stack("mlp.c_proj.bias", t=False)},
    }
    params = {
        "wte": {"embedding": g("wte.weight")},
        "wpe": {"embedding": g("wpe.weight")},
        "blocks": blocks,
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
    }
    return _to_f32(params), cfg


def load_hf_phi(model_or_state_dict, config=None):
    """Phi-1/1.5/2 (HF PhiForCausalLM): GPT-J-style parallel residual with
    a SINGLE shared LayerNorm feeding both branches
    (PhiDecoderLayer.forward: attn(ln(x)) + mlp(ln(x)) + x), partial
    rotate_half rotary over partial_rotary_factor * head_dim channels,
    biased q/k/v/dense and fc1/fc2, and a biased untied lm_head."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    prefix = _prefix(sd, "model.")
    L = config.num_hidden_layers
    if getattr(config, "qk_layernorm", False):
        raise NotImplementedError(
            "PhiConfig.qk_layernorm=True (per-head q/k LayerNorm with "
            "biases) is not supported; loading without it would silently "
            "change every attention score")
    g = _getter(sd, prefix)
    top = _getter(sd, "")
    stack = _stacker(g, L)
    qkv, qkv_b = _concat_qkv_linear(
        g, "layers.{i}.self_attn.{p}_proj.weight")
    nh = config.num_attention_heads
    kv = getattr(config, "num_key_value_heads", None) or nh
    hd = config.hidden_size // nh
    cfg = TransformerConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        hidden_size=config.hidden_size,
        num_layers=L,
        num_heads=nh,
        num_kv_heads=kv,
        mlp_dim_override=config.intermediate_size,
        activation="gelu",                  # HF gelu_new = tanh approx
        pos_embed="rotary",
        rotary_dim=int(config.partial_rotary_factor * hd),
        rotary_interleaved=False,           # rotate_half
        rope_theta=float(getattr(config, "rope_theta", 10000.0)),
        parallel_residual=True,             # shared ln1 feeds both branches
        use_bias=True,
        tie_embeddings=False,
        lm_head_bias=True,
        layer_norm_eps=float(config.layer_norm_eps),
        scan_layers=True,
    )
    blocks = {
        "ln1": {"scale": stack(
            lambda i: g(f"layers.{i}.input_layernorm.weight")),
            "bias": stack(
            lambda i: g(f"layers.{i}.input_layernorm.bias"))},
        "attn_qkv": {"kernel": stack(qkv), "bias": stack(qkv_b)},
        "attn_proj": {"kernel": stack(
            lambda i: _t(g(f"layers.{i}.self_attn.dense.weight"))),
            "bias": stack(lambda i: g(f"layers.{i}.self_attn.dense.bias"))},
        "mlp_fc": {"kernel": stack(
            lambda i: _t(g(f"layers.{i}.mlp.fc1.weight"))),
            "bias": stack(lambda i: g(f"layers.{i}.mlp.fc1.bias"))},
        "mlp_proj": {"kernel": stack(
            lambda i: _t(g(f"layers.{i}.mlp.fc2.weight"))),
            "bias": stack(lambda i: g(f"layers.{i}.mlp.fc2.bias"))},
    }
    params = {
        "wte": {"embedding": g("embed_tokens.weight")},
        "blocks": blocks,
        "ln_f": {"scale": g("final_layernorm.weight"),
                 "bias": g("final_layernorm.bias")},
        "lm_head": {"kernel": _t(top("lm_head.weight")),
                    "bias": top("lm_head.bias")},
    }
    return _to_f32(params), cfg


def _gemma_activation(config) -> str:
    """The tanh GELU that Gemma's and Gemma-2's gated MLPs run by default.
    A config naming the exact erf GELU raises: the JAX package loads it as
    the tanh form (a divergence recorded in ROADMAP.md Queue 3)."""
    for attr in ("hidden_activation", "hidden_act"):
        if getattr(config, attr, None) == "gelu":
            raise NotImplementedError(
                f"Gemma config {attr}='gelu' (exact erf GELU): the gated "
                "MLP here runs the tanh approximation, and loading it so "
                f"would change every activation ({_ROADMAP}, Queue 3)")
    return "gelu"


def load_hf_gemma(model_or_state_dict, config=None):
    """Gemma (HF GemmaForCausalLM): the Llama block family with three
    deltas: RMSNorm weights stored as w with forward x*(1+w) (folded into
    the scale at load), token embeddings scaled by sqrt(hidden_size) in
    the compute dtype, and a tanh-GELU gated MLP. head_dim is decoupled
    (256 at 7B) and embeddings are always tied."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    return _load_hf_llama_family(
        sd, config, activation=_gemma_activation(config),
        embed_scale=float(config.hidden_size) ** 0.5,
        norm_plus_one=True)


def load_hf_gemma2(model_or_state_dict, config=None):
    """Gemma-2 (HF Gemma2ForCausalLM): Gemma's deltas plus sandwich norms
    (each branch output normed again before its residual), tanh
    softcapping on attention scores and final logits, query_pre_attn_scalar
    attention scaling, and alternating sliding/full-attention layers via
    config.layer_types."""
    sd, config = _sd_and_config(model_or_state_dict, config)
    return _load_hf_llama_family(
        sd, config, use_sliding_window="layer_types",
        activation=_gemma_activation(config),
        embed_scale=float(config.hidden_size) ** 0.5,
        norm_plus_one=True, gemma2=True)


def load_hf_mixtral(model_or_state_dict, config=None, dtype=torch.float32):
    """Mixtral (HF MixtralForCausalLM): the Mistral block family with the
    dense SwiGLU MLP replaced by num_local_experts SwiGLU experts behind a
    top-(num_experts_per_tok) router (HF block_sparse_moe gate + w1/w3/w2
    experts -> moe/gate and moe/experts/{gate,fc,proj}). ``dtype``: the
    leaves' dtype (float32), read in it layer by layer, so a bf16 state
    dict maps into bf16 leaves without an f32 copy of the experts."""
    return _load_hf_llama_family(model_or_state_dict, config,
                                 use_sliding_window=True, moe=True,
                                 dtype=dtype)


HF_POLICIES = {
    "llama": load_hf_llama,
    "LlamaForCausalLM": load_hf_llama,
    "mistral": load_hf_mistral,
    "MistralForCausalLM": load_hf_mistral,
    "qwen2": load_hf_qwen2,
    "Qwen2ForCausalLM": load_hf_qwen2,
    "qwen3": load_hf_qwen3,
    "Qwen3ForCausalLM": load_hf_qwen3,
    "mixtral": load_hf_mixtral,
    "MixtralForCausalLM": load_hf_mixtral,
    "gemma": load_hf_gemma,
    "GemmaForCausalLM": load_hf_gemma,
    "gemma2": load_hf_gemma2,
    "Gemma2ForCausalLM": load_hf_gemma2,
    "phi": load_hf_phi,
    "PhiForCausalLM": load_hf_phi,
    "gpt_bigcode": load_hf_gpt_bigcode,
    "GPTBigCodeForCausalLM": load_hf_gpt_bigcode,
    "falcon": load_hf_falcon,
    "FalconForCausalLM": load_hf_falcon,
    "gptneo": load_hf_gpt_neo,
    "GPTNeoForCausalLM": load_hf_gpt_neo,
    "gptj": load_hf_gptj,
    "GPTJForCausalLM": load_hf_gptj,
    "gpt2": load_hf_gpt2,
    "GPT2LMHeadModel": load_hf_gpt2,
    "opt": load_hf_opt,
    "OPTForCausalLM": load_hf_opt,
    "bloom": load_hf_bloom,
    "BloomForCausalLM": load_hf_bloom,
    "bert": load_hf_bert,
    "BertForMaskedLM": load_hf_bert,
    "roberta": load_hf_roberta,
    "RobertaForMaskedLM": load_hf_roberta,
    "distilbert": load_hf_distilbert,
    "DistilBertForMaskedLM": load_hf_distilbert,
    "gptneox": load_hf_gpt_neox,
    "GPTNeoXForCausalLM": load_hf_gpt_neox,
    "clip": load_hf_clip_text,
    "CLIPTextModel": load_hf_clip_text,
    # CLIPTextModelWithProjection is deliberately NOT aliased: its output is
    # text_embeds through text_projection, which this encoder-only policy
    # does not model; aliasing it would silently return the wrong tensor
}


def load_hf(model, arch: str = None, config=None, dtype=None):
    """(params, cfg) of ``model`` (a live HF model, or a state dict with
    ``config``) by its architecture name: ``arch``, default the model's
    class name. Exact matches only: substring matching misfires on
    sibling architectures (GPTNeoX contains 'gptneo', Roberta 'bert').
    Leaves are float32, or ``dtype`` (Mixtral's policy reads them in it;
    the others cast the float32 tree)."""
    arch = arch or type(model).__name__
    fn = HF_POLICIES.get(arch) or HF_POLICIES.get(arch.lower())
    if fn is not None:
        if dtype is None or dtype == torch.float32:
            return fn(model, config=config)
        if fn is load_hf_mixtral:
            return fn(model, config=config, dtype=dtype)
        params, cfg = fn(model, config=config)
        cast = lambda n: ({k: cast(v) for k, v in n.items()}
                          if isinstance(n, dict) else n.to(dtype))
        return cast(params), cfg
    raise NotImplementedError(
        f"no import policy for architecture '{arch}'; have "
        f"{sorted(k for k in HF_POLICIES if not k.islower())}")


def replace_transformer_layer(model, config=None, arch: str = None,
                              dtype=None):
    """The reference's API (module_inject/replace_module.py:300): where the
    reference rewires a torch model's layers in place to fused CUDA
    modules, the substitution here is functional. The matched policy maps
    the HF weights onto the port's ``Transformer`` and this returns
    ``(module, params, cfg)``: the module owns a copy of the weights, and
    ``params`` is the scan-layout tree that ``init_inference(module, ...,
    model_parameters=params)`` serves. ``dtype`` (a torch dtype) sets the
    compute dtype and the weights' (default float32 weights). The input
    model is never mutated; a state dict the caller holds no reference to
    is freed once mapped, before the module's copy is made. Mixtral's
    experts become the ``Transformer``'s MoE layers."""
    params, cfg = load_hf(model, arch=arch, config=config, dtype=dtype)
    del model
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return Transformer(cfg, params), params, cfg


def revert_transformer_layer(model, *_, **__):
    """The reference's API (deepspeed/__init__.py:35) undoes its in-place
    layer surgery. The substitution here never touched the original
    model, so revert returns it unchanged."""
    return model
