"""Port parity: the HF import (``deepspeed_tpu_torch.models.hf``) and the
block forms its policies need, against the JAX package and HF itself.

Tiny random-init HF models (2 layers, widths <= 64, seeded) built from
``transformers``' config classes, one per architecture policy (and the
Falcon 40B-style, GPT-NeoX sequential and Qwen3 windowed variants):

* the port's ``load_hf`` tree equals the JAX package's leaf for leaf,
  exactly (f32 HF models), and the two ``TransformerConfig``s agree field
  by field (dtype aside: torch's against jnp's);
* the port's ``Transformer`` logits (hidden states for CLIP) match HF's
  own torch forward at rtol = atol = 2e-3, in f32 on the CPU with
  ``attention_impl="auto"`` (the kernels' plain versions);
* Mixtral maps like JAX, ``replace_transformer_layer`` runs it against
  HF's logits (2e-3) and greedy tokens (equal), and refuses a top-3
  router, which the MoE layer does not take;
* the port's ``Transformer`` against the JAX ``Transformer`` on the same
  numpy-seeded weights for each new block form, f32 at rtol = atol =
  1e-4; 3-step ``train_batch`` trajectories against the JAX engine (loss
  rtol 1e-4, grad norm rtol 1e-3, as ``test_torch_training.py``);
* ``forward_with_cache`` in two chunks against the full forward (2e-3),
  ``serve()`` greedy tokens against ``generate()``'s, and
  ``DeepSpeedTransformerLayer`` against the JAX layer (1e-4).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import deepspeed_tpu
from deepspeed_tpu.models import hf as jhf
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel.mesh import MeshManager

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import hf as thf
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.generation import (forward_with_cache,
                                                   init_cache)

TOL = 2e-3
V = 96


@pytest.fixture(autouse=True)
def _precise_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _perturb(model, names, std=0.3, seed=0):
    """Move the named parameters off their init (ones / zeros would let a
    loader that drops or misplaces them pass)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if any(n in name for n in names):
                p.add_(torch.randn(p.shape, generator=g) * std)
    return model


def _llama_kw(**over):
    kw = dict(vocab_size=V, hidden_size=32, intermediate_size=56,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
    kw.update(over)
    return kw


def _bert_batch(rng, S=16):
    tt = rng.integers(0, 2, (2, S))
    mask = np.ones((2, S), np.int64)
    mask[1, S - 5:] = 0
    return {"token_type_ids": tt, "attention_mask": mask}


# name -> (a function making the HF model, seq len, extra batch, output)
CASES = {
    "gpt2": (lambda: transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=V, n_positions=32, n_embd=32, n_layer=2, n_head=4)),
        16, None, "logits"),
    "gpt_neo": (lambda: transformers.GPTNeoForCausalLM(
        transformers.GPTNeoConfig(
            vocab_size=V, max_position_embeddings=32, hidden_size=32,
            num_layers=2, num_heads=4, intermediate_size=64,
            attention_types=[[["global", "local"], 1]], window_size=8)),
        24, None, "logits"),
    "gptj": (lambda: transformers.GPTJForCausalLM(transformers.GPTJConfig(
        vocab_size=V, n_positions=32, n_embd=32, n_layer=2, n_head=4,
        rotary_dim=4)), 16, None, "logits"),
    "opt": (lambda: transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=V, max_position_embeddings=32, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, ffn_dim=64,
        word_embed_proj_dim=32, do_layer_norm_before=True)),
        16, None, "logits"),
    "bloom": (lambda: transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=V, hidden_size=32, n_layer=2, n_head=4)),
        16, None, "logits"),
    "bert": (lambda: _perturb(transformers.BertForMaskedLM(
        transformers.BertConfig(
            vocab_size=V, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, type_vocab_size=2)),
        ("LayerNorm", "predictions.bias")), 16, _bert_batch, "logits"),
    "roberta": (lambda: _perturb(transformers.RobertaForMaskedLM(
        transformers.RobertaConfig(
            vocab_size=V, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=34, type_vocab_size=1, pad_token_id=1)),
        ("LayerNorm", "layer_norm", "lm_head.bias")), 16, None, "logits"),
    "distilbert": (lambda: _perturb(transformers.DistilBertForMaskedLM(
        transformers.DistilBertConfig(
            vocab_size=V, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
            max_position_embeddings=32)),
        ("layer_norm", "LayerNorm", "vocab_projector.bias")),
        16, None, "logits"),
    "gpt_neox": (lambda: _perturb(transformers.GPTNeoXForCausalLM(
        transformers.GPTNeoXConfig(
            vocab_size=V, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, rotary_pct=0.5,
            rotary_emb_base=50000, use_parallel_residual=True)),
        ("layernorm",)), 16, None, "logits"),
    "gpt_neox_sequential": (lambda: transformers.GPTNeoXForCausalLM(
        transformers.GPTNeoXConfig(
            vocab_size=V, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, rotary_pct=1.0,
            use_parallel_residual=False)), 16, None, "logits"),
    "clip": (lambda: transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=V, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=32)), 16, None, "last_hidden_state"),
    "llama": (lambda: transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **_llama_kw(rope_theta=500000.0, attention_bias=True))),
        20, None, "logits"),
    "mistral": (lambda: transformers.MistralForCausalLM(
        transformers.MistralConfig(**_llama_kw(sliding_window=8))),
        24, None, "logits"),
    "qwen2": (lambda: _perturb(transformers.Qwen2ForCausalLM(
        transformers.Qwen2Config(**_llama_kw(
            num_hidden_layers=3, sliding_window=8, use_sliding_window=True,
            max_window_layers=1))), ("q_proj.bias", "k_proj.bias",
                                     "v_proj.bias")), 20, None, "logits"),
    "qwen3": (lambda: _perturb(transformers.Qwen3ForCausalLM(
        transformers.Qwen3Config(**_llama_kw(
            head_dim=16, tie_word_embeddings=False))),
        ("q_norm", "k_norm")), 20, None, "logits"),
    "qwen3_windowed": (lambda: transformers.Qwen3ForCausalLM(
        transformers.Qwen3Config(**_llama_kw(
            head_dim=16, use_sliding_window=True, sliding_window=8,
            max_window_layers=1,
            layer_types=["full_attention", "sliding_attention"]))),
        24, None, "logits"),
    "mixtral": (lambda: transformers.MixtralForCausalLM(
        transformers.MixtralConfig(**_llama_kw(
            num_local_experts=4, num_experts_per_tok=2))),
        20, None, "logits"),
    "gemma": (lambda: _perturb(transformers.GemmaForCausalLM(
        transformers.GemmaConfig(**_llama_kw(head_dim=16))), ("norm",)),
        20, None, "logits"),
    "gemma2": (lambda: _perturb(transformers.Gemma2ForCausalLM(
        transformers.Gemma2Config(**_llama_kw(
            head_dim=16, query_pre_attn_scalar=32,
            attn_logit_softcapping=5.0, final_logit_softcapping=30.0,
            sliding_window=8,
            layer_types=["sliding_attention", "full_attention"]))),
        ("norm",)), 24, None, "logits"),
    "phi": (lambda: transformers.PhiForCausalLM(transformers.PhiConfig(
        vocab_size=V, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64)), 20, None, "logits"),
    "gpt_bigcode": (lambda: transformers.GPTBigCodeForCausalLM(
        transformers.GPTBigCodeConfig(
            vocab_size=V, n_embd=32, n_head=4, n_layer=2, n_positions=64,
            n_inner=64)), 20, None, "logits"),
    "falcon": (lambda: transformers.FalconForCausalLM(
        transformers.FalconConfig(
            vocab_size=V, hidden_size=32, num_attention_heads=4,
            num_hidden_layers=2, new_decoder_architecture=False,
            multi_query=True, parallel_attn=True, bias=False)),
        20, None, "logits"),
    "falcon_40b": (lambda: _perturb(transformers.FalconForCausalLM(
        transformers.FalconConfig(
            vocab_size=V, hidden_size=32, num_attention_heads=4,
            num_hidden_layers=2, new_decoder_architecture=True,
            num_kv_heads=2)), ("ln_attn", "ln_mlp")), 20, None, "logits"),
}
_HF = {}


def _hf(name):
    """(HF model, ids, extra batch) of a case, built once."""
    if name not in _HF:
        build, S, extra, _ = CASES[name]
        torch.manual_seed(sum(map(ord, name)))
        model = build().eval()
        rng = np.random.default_rng(len(name))
        # ids from 2 up: RoBERTa derives its positions from pad id 1
        ids = rng.integers(2, V, (2, S))
        _HF[name] = (model, ids, extra(rng, S) if extra else {})
    return _HF[name]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _torch_cfg(jcfg, **over):
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f.update(dtype=torch.float32, **over)
    return ttr.TransformerConfig(**f)


def _assert_same_cfg(tcfg, jcfg):
    for fl in dataclasses.fields(jcfg):
        if fl.name != "dtype":
            assert getattr(tcfg, fl.name) == getattr(jcfg, fl.name), fl.name
    assert (tcfg.dtype, jcfg.dtype) == (torch.bfloat16, jnp.bfloat16)


# ------------------------------------------------------------- the policies

@pytest.mark.parametrize("name", sorted(CASES))
def test_mapped_tree_and_config_equal_jax(name):
    model, _, _ = _hf(name)
    tparams, tcfg = thf.load_hf(model)
    jparams, jcfg = jhf.load_hf(model)
    _assert_same_cfg(tcfg, jcfg)
    tflat = {k: v.numpy() for k, v in _flat(tparams).items()}
    jflat = _flat(jparams)
    assert sorted(tflat) == sorted(jflat)
    for k, ref in jflat.items():
        assert tflat[k].dtype == np.float32, k
        np.testing.assert_array_equal(tflat[k], np.asarray(ref), err_msg=k)
    # the tree owns its memory: the HF model's weights are not aliased
    ptrs = {p.data_ptr() for p in model.state_dict().values()}
    assert not ptrs & {t.data_ptr() for t in _flat(tparams).values()}


@pytest.mark.parametrize("name", sorted(set(CASES) - {"mixtral"}))
def test_forward_matches_hf(name):
    model, ids, extra = _hf(name)
    out_attr = CASES[name][3]
    module, params, cfg = deepspeed_tpu_torch.replace_transformer_layer(
        model, dtype=torch.float32)
    assert module.cfg is cfg and cfg.dtype == torch.float32
    batch = {"input_ids": torch.from_numpy(ids),
             **{k: torch.from_numpy(v) for k, v in extra.items()}}
    with torch.no_grad():
        ref = getattr(model(**batch), out_attr).numpy()
        ours = module(batch).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    assert deepspeed_tpu_torch.revert_transformer_layer(model) is model


def test_mixtral_maps_but_replace_refuses():
    """Mixtral maps; replace_transformer_layer runs it (the next test)
    but refuses a router of more than two experts a token, which the
    MoE layer (top-1 / top-2, as in JAX) does not take."""
    from types import SimpleNamespace
    model, _, _ = _hf("mixtral")
    params, cfg = thf.load_hf(model)
    assert cfg.moe_experts == 4 and cfg.moe_k == 2
    assert tuple(params["blocks"]["moe"]["experts"]["gate"]["kernel"].shape) \
        == (2, 4, 32, 56)
    ns = SimpleNamespace(**dict(model.config.to_dict(),
                                num_experts_per_tok=3))
    with pytest.raises(ValueError, match="k must be 1 or 2"):
        thf.replace_transformer_layer(model.state_dict(), config=ns,
                                      arch="mixtral")


def test_mixtral_replace_matches_hf_logits_and_greedy_tokens():
    """replace_transformer_layer on Mixtral: the MoE Transformer's logits
    against HF's at 2e-3 (its capacity factor E/k makes the queues
    drop-free, as HF's router is) and greedy tokens through the cache
    decode path equal to HF's generate, as the JAX package holds it
    (tests/test_hf_policies.py); with ``dtype=torch.bfloat16`` the
    leaves map in bf16, equal to the f32 tree cast."""
    model, ids, _ = _hf("mixtral")
    module, params, cfg = thf.replace_transformer_layer(
        model, dtype=torch.float32)
    assert cfg.moe_capacity_factor == 2.0 and module.cfg is cfg
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
        logits, aux = module({"input_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(logits.numpy(), ref, rtol=TOL, atol=TOL)
    assert np.isfinite(aux.item())
    from deepspeed_tpu_torch.models.generation import generate
    pids = np.random.default_rng(22).integers(0, V, (2, 10))
    with torch.no_grad():
        gref = model.generate(torch.tensor(pids), max_new_tokens=8,
                              do_sample=False).numpy()
    out = generate(cfg, params, torch.from_numpy(pids), 8)
    np.testing.assert_array_equal(out.numpy(), gref)
    _, bf, bcfg = thf.replace_transformer_layer(model, dtype=torch.bfloat16)
    assert bcfg.dtype == torch.bfloat16
    for k, v in _flat(params).items():
        assert torch.equal(_flat(bf)[k], v.to(torch.bfloat16)), k


def test_megatron_gpt_load_matches_jax():
    """A synthetic Megatron-LM state dict (v2 per-head interleaved qkv and
    v0 chunked): the port's tree equals the JAX package's, the v2
    de-interleave equals the hand-concatenated kernel, and the mapped
    model runs as the JAX Transformer does."""
    rng = np.random.default_rng(16)
    L, H, nh, S = 2, 32, 4, 32
    hd = H // nh
    mk = lambda *shape: (rng.standard_normal(shape) * 0.05).astype(np.float32)
    q, k, v = (mk(L, H, H) for _ in range(3))
    qb, kb, vb = (mk(L, H) for _ in range(3))
    sd = {"language_model.embedding.word_embeddings.weight": mk(V, H),
          "language_model.embedding.position_embeddings.weight": mk(S, H),
          "language_model.encoder.final_layernorm.weight": mk(H),
          "language_model.encoder.final_layernorm.bias": mk(H)}
    for i in range(L):
        p = f"language_model.encoder.layers.{i}."
        w = np.stack([x[i].reshape(nh, hd, H) for x in (q, k, v)], axis=1)
        b = np.stack([x[i].reshape(nh, hd) for x in (qb, kb, vb)], axis=1)
        sd[p + "attention.query_key_value.weight"] = w.reshape(3 * H, H)
        sd[p + "attention.query_key_value.bias"] = b.reshape(3 * H)
        for name, shape in (("input_layernorm", (H,)),
                            ("post_attention_layernorm", (H,))):
            sd[p + name + ".weight"] = 1.0 + mk(*shape)
            sd[p + name + ".bias"] = mk(*shape)
        sd[p + "attention.dense.weight"] = mk(H, H)
        sd[p + "attention.dense.bias"] = mk(H)
        sd[p + "mlp.dense_h_to_4h.weight"] = mk(2 * H, H)
        sd[p + "mlp.dense_h_to_4h.bias"] = mk(2 * H)
        sd[p + "mlp.dense_4h_to_h.weight"] = mk(H, 2 * H)
        sd[p + "mlp.dense_4h_to_h.bias"] = mk(H)
    meta = {"num_layers": L, "hidden_size": H, "num_heads": nh,
            "vocab_size": V, "max_seq_len": S, "mlp_ratio": 2}
    tsd = {key: torch.from_numpy(a) for key, a in sd.items()}
    for version in (2, 0):
        tparams, tcfg = thf.load_megatron_gpt(tsd, meta, version=version)
        jparams, jcfg = jhf.load_megatron_gpt(sd, meta, version=version)
        _assert_same_cfg(tcfg, jcfg)
        tflat, jflat = _flat(tparams), _flat(jparams)
        assert sorted(tflat) == sorted(jflat)
        for key in jflat:
            np.testing.assert_array_equal(tflat[key].numpy(),
                                          np.asarray(jflat[key]))
    tparams, tcfg = thf.load_megatron_gpt(tsd, meta, version=2)
    jparams, jcfg = jhf.load_megatron_gpt(sd, meta, version=2)
    np.testing.assert_array_equal(
        tparams["blocks"]["attn_qkv"]["kernel"][0].numpy(),
        np.concatenate([q[0].T, k[0].T, v[0].T], axis=1))
    ids = rng.integers(0, V, (2, 16))
    with torch.no_grad():
        ours = ttr.Transformer(_torch_cfg(jcfg), tparams)(
            torch.from_numpy(ids)).numpy()
    ref = jtr.Transformer(dataclasses.replace(jcfg, dtype=jnp.float32)).apply(
        {"params": jparams}, {"input_ids": jnp.asarray(ids)})
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_fail_loud_branches_keep_their_messages():
    """The JAX loaders' refusals, with their messages: yarn rope, an
    untied state dict without lm_head.weight, Phi's qk_layernorm, an
    unknown activation, an unknown architecture, a raw state dict
    without its config."""
    torch.manual_seed(5)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **_llama_kw(num_hidden_layers=1)))
    yarn = transformers.LlamaConfig(**_llama_kw(num_hidden_layers=1))
    yarn.rope_scaling = {"rope_type": "yarn", "factor": 2.0}
    with pytest.raises(NotImplementedError, match="yarn"):
        thf.load_hf(llama.state_dict(), arch="llama", config=yarn)
    sd = {k: v for k, v in llama.state_dict().items()
          if k != "lm_head.weight"}
    with pytest.raises(KeyError, match="lm_head.weight"):
        thf.load_hf(sd, arch="LlamaForCausalLM", config=llama.config)
    with pytest.raises(NotImplementedError, match="qk_layernorm"):
        thf.load_hf(transformers.PhiForCausalLM(transformers.PhiConfig(
            vocab_size=V, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=4, qk_layernorm=True)))
    neox = transformers.GPTNeoXConfig(
        vocab_size=V, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=4, intermediate_size=64, hidden_act="tanh")
    with pytest.raises(KeyError, match="tanh"):
        thf.load_hf(transformers.GPTNeoXForCausalLM(neox))
    with pytest.raises(NotImplementedError, match="no import policy"):
        thf.load_hf(object(), arch="T5ForConditionalGeneration")
    with pytest.raises(ValueError, match="HF config"):
        thf.load_hf(llama.state_dict(), arch="llama")
    with pytest.raises(NotImplementedError, match="multi_query"):
        thf.load_hf(transformers.GPTBigCodeForCausalLM(
            transformers.GPTBigCodeConfig(
                vocab_size=V, n_embd=32, n_head=4, n_layer=1,
                n_positions=64, multi_query=False)))
    with pytest.raises(NotImplementedError, match="alibi"):
        thf.load_hf(transformers.FalconForCausalLM(transformers.FalconConfig(
            vocab_size=V, hidden_size=32, num_attention_heads=4,
            num_hidden_layers=1, new_decoder_architecture=False,
            multi_query=False, parallel_attn=False, alibi=True)))


def test_raw_state_dict_with_a_plain_config_object():
    """The card's input form: a state dict under HF's names and the
    config as a plain object with HF's attribute names (no
    transformers); the tree equals the live model's."""
    from types import SimpleNamespace
    model, ids, _ = _hf("phi")
    ns = SimpleNamespace(**model.config.to_dict())
    module, params, cfg = thf.replace_transformer_layer(
        model.state_dict(), config=ns, arch="PhiForCausalLM",
        dtype=torch.float32)
    ref, _ = thf.load_hf(model)
    flat, rflat = _flat(params), _flat(ref)
    assert sorted(flat) == sorted(rflat)
    for k in rflat:
        assert torch.equal(flat[k], rflat[k]), k
    assert cfg.rotary_dim == 4 and cfg.head_dim == 8


def test_layer_types_without_layer_types_raises():
    """JAX loads a layer_types policy (Qwen3, Gemma-2) whose config has a
    sliding_window but no layer_types with every layer global
    (deepspeed_tpu/models/hf.py:869-874); the port raises."""
    from types import SimpleNamespace
    model, _, _ = _hf("qwen3_windowed")
    ns = SimpleNamespace(**{k: v for k, v in model.config.to_dict().items()
                            if k != "layer_types"})
    _, jcfg = jhf.load_hf(model.state_dict(), arch="qwen3", config=ns)
    assert jcfg.layer_windows is None                   # all global
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        thf.load_hf(model.state_dict(), arch="qwen3", config=ns)
    ns.sliding_window = None                            # no window: loads
    assert thf.load_hf(model.state_dict(), arch="qwen3",
                       config=ns)[1].layer_windows is None


@pytest.mark.parametrize("attr", ["hidden_activation", "hidden_act"])
def test_gemma_exact_gelu_raises(attr):
    """JAX loads a Gemma config naming the exact GELU as the tanh form
    (deepspeed_tpu/models/hf.py:1263); the port raises."""
    from types import SimpleNamespace
    model, _, _ = _hf("gemma")
    ns = SimpleNamespace(**model.config.to_dict())
    setattr(ns, attr, "gelu")
    assert jhf.load_hf(model.state_dict(), arch="gemma",
                       config=ns)[1].activation == "gelu"     # tanh
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        thf.load_hf(model.state_dict(), arch="gemma", config=ns)


# -------------------------------------------- the block forms against JAX

BLOCK_FORMS = {
    # BERT: post-LN, token types, embedding LN, the MLM head, no causal
    "post_ln_mlm": dict(causal=False, post_ln=True, embed_ln=True,
                        token_type_vocab=2, mlm_head=True,
                        activation="gelu_exact", layer_norm_eps=1e-12),
    # CLIP text: no LM head
    "no_lm_head": dict(tie_embeddings=False, no_lm_head=True,
                       activation="quick_gelu"),
    # GPT-J: one shared LN feeds both branches
    "parallel": dict(parallel_residual=True, pos_embed="rotary",
                     rotary_dim=4, tie_embeddings=False, lm_head_bias=True),
    # GPT-NeoX: ln2 feeds the MLP branch
    "parallel_dual_ln": dict(parallel_residual=True,
                             parallel_residual_dual_ln=True,
                             pos_embed="rotary", rotary_interleaved=False,
                             tie_embeddings=False),
    # GPT-Neo: mixed per-layer windows, unscaled attention
    "mixed_windows": dict(layer_windows=(0, 6, 3), num_layers=3,
                          attn_scale=1.0),
}


def _jax_cfg(form, **extra):
    kw = dict(hidden_size=32, num_layers=2, num_heads=4, vocab_size=64,
              max_seq_len=64, dtype=jnp.float32)
    kw.update(BLOCK_FORMS[form])
    kw.update(extra)
    return jtr.get_config("gpt2-tiny", **kw)


def _seeded_params(jcfg, seed):
    """The flax tree's structure with numpy-seeded values: kernels and
    embeddings normal x 0.2, norm scales 1 + normal x 0.2, biases normal x
    0.1."""
    shapes = jax.eval_shape(
        lambda: jtr.Transformer(jcfg).init(
            jax.random.PRNGKey(0),
            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"])
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return 1.0 + 0.2 * z
        return (0.1 if "bias" in name else 0.2) * z
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("form", sorted(BLOCK_FORMS))
def test_block_form_matches_jax_transformer(form):
    jcfg = _jax_cfg(form)
    jp = _seeded_params(jcfg, seed=len(form))
    rng = np.random.default_rng(3)
    batch = {"input_ids": rng.integers(0, 64, (2, 20)).astype(np.int32)}
    if jcfg.token_type_vocab:
        batch.update(_bert_batch(rng, 20))
    ref = np.asarray(jtr.Transformer(jcfg).apply({"params": jp}, batch))
    module = ttr.Transformer(_torch_cfg(jcfg), params_from_jax(jp))
    with torch.no_grad():
        ours = module({k: torch.from_numpy(v) for k, v in batch.items()})
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_encoder_init_params_match_the_flax_tree():
    """init_params builds the encoder tree under JAX's names (tte, ln_emb,
    mlm_transform, mlm_ln, a bare mlm_bias, no ln_f for post-LN), and the
    bert presets build and run with the encoder knobs on."""
    for form in ("post_ln_mlm", "no_lm_head"):
        jcfg = _jax_cfg(form)
        shapes = _flat(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), jax.eval_shape(
                lambda: jtr.Transformer(jcfg).init(
                    jax.random.PRNGKey(0),
                    {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"])))
        ours = ttr.init_params(_torch_cfg(jcfg), torch.Generator())
        assert {k: tuple(v.shape) for k, v in _flat(ours).items()} == \
            {k: v.shape for k, v in shapes.items()}
    for preset in ("bert-base", "bert-large"):
        m, cfg = ttr.build_model(preset, num_layers=1, post_ln=True,
                                 embed_ln=True, token_type_vocab=2,
                                 mlm_head=True, dtype=torch.float32)
        assert "ln_f" not in dict(m.named_children())
        assert isinstance(m.mlm_bias, torch.nn.Parameter)
        ids = torch.zeros(1, 8, dtype=torch.long)
        with torch.no_grad():
            out = m({"input_ids": ids, "token_type_ids": ids + 1})
        assert out.shape == (1, 8, 30522) and torch.isfinite(out).all()


def test_bare_leaf_round_trips_and_serves():
    """mlm_bias (a bare array) through the module, scan_params,
    module_to_jax and the InferenceEngine's cast; the engine's forward
    passes attention_mask and token_type_ids through."""
    from deepspeed_tpu_torch.models.convert import module_to_jax, scan_params
    jcfg = _jax_cfg("post_ln_mlm")
    jp = _seeded_params(jcfg, seed=1)
    tcfg = _torch_cfg(jcfg)
    module = ttr.Transformer(tcfg, params_from_jax(jp))
    sp = scan_params(module)
    assert torch.equal(sp["mlm_bias"], torch.from_numpy(jp["mlm_bias"]))
    back = _flat(module_to_jax(module))
    assert sorted(back) == sorted(_flat(jp))
    np.testing.assert_array_equal(back["mlm_bias"], jp["mlm_bias"])
    eng = deepspeed_tpu_torch.init_inference(
        module, {"dtype": "bf16"}, model_parameters=sp, device="cpu")
    assert eng.params["mlm_bias"].dtype == torch.bfloat16
    rng = np.random.default_rng(2)
    batch = {"input_ids": rng.integers(0, 64, (2, 16)),
             **_bert_batch(rng)}
    ref = np.asarray(jtr.Transformer(dataclasses.replace(
        jcfg, dtype=jnp.bfloat16)).apply({"params": jp}, batch))
    out = eng.forward(batch)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.1, atol=0.1)
    other = eng.forward(dict(batch, token_type_ids=1 - batch[
        "token_type_ids"]))
    assert not torch.allclose(out, other)
    with pytest.raises(NotImplementedError, match="post-LN"):
        eng.generate(torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(NotImplementedError, match="post-LN"):
        eng.serve()


def test_no_lm_head_refuses_to_decode():
    jcfg = _jax_cfg("no_lm_head")
    tcfg = _torch_cfg(jcfg)
    eng = deepspeed_tpu_torch.init_inference(
        tcfg, {"dtype": "float32"},
        model_parameters=ttr.init_params(tcfg, torch.Generator()),
        device="cpu")
    assert eng.forward(torch.zeros(1, 4, dtype=torch.long)).shape == \
        (1, 4, 32)
    for call in (lambda: eng.generate(torch.zeros(1, 4, dtype=torch.long),
                                      2),
                 eng.serve):
        with pytest.raises(ValueError, match="no logits to decode"):
            call()


_TRAIN = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 3e-3, "weight_decay": 0.01}},
          "gradient_clipping": 1.0, "steps_per_print": 100}


@pytest.mark.parametrize("form", ["post_ln_mlm", "parallel"])
def test_train_batch_trajectory_matches_jax_engine(form, tmp_path):
    """BERT (MLM labels on 15% of live positions, masked_lm_loss, a
    key-padding mask and token types) and GPT-J (causal LM): 3 steps."""
    jcfg = _jax_cfg(form)
    jp = jax.tree.map(np.asarray, _seeded_params(jcfg, seed=7))
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(_TRAIN))
    mlm = jcfg.mlm_head
    jeng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=str(path), model_parameters=jp,
        loss_fn=jtr.masked_lm_loss if mlm else jtr.causal_lm_loss,
        mesh_manager=MeshManager(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(_torch_cfg(jcfg)), config=str(path),
        model_parameters=jp,
        loss_fn=ttr.masked_lm_loss if mlm else ttr.causal_lm_loss,
        device="cpu")
    rng = np.random.default_rng(11)
    batch = {"input_ids": rng.integers(0, 64, (4, 16)).astype(np.int32)}
    if mlm:
        lens = np.array([16, 11, 14, 9])
        batch["attention_mask"] = (np.arange(16)[None] < lens[:, None]
                                   ).astype(np.int32)
        batch["token_type_ids"] = rng.integers(0, 2, (4, 16)).astype(
            np.int32)
        pick = (rng.random((4, 16)) < 0.15) & (batch["attention_mask"] > 0)
        pick[:, 0] = True
        batch["labels"] = np.where(pick, batch["input_ids"], -100).astype(
            np.int32)
    losses = []
    for _ in range(3):
        jm = jax.device_get(jeng.train_batch(batch))
        tm = teng.train_batch(batch)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        losses.append(tm["loss"])
    assert losses[-1] < losses[0]


# ------------------------------------------------ decode, serve and layer

@pytest.mark.parametrize("name", ["gptj", "gpt_neox", "phi", "falcon",
                                  "bloom", "gemma2"])
def test_forward_with_cache_in_two_chunks_matches_full(name):
    model, ids, _ = _hf(name)
    params, cfg = thf.load_hf(model)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        full = ttr.Transformer(cfg, params)(ids)
        cache = init_cache(cfg, ids.shape[0], 64)
        half = ids.shape[1] // 2
        _, cache = forward_with_cache(cfg, params, ids[:, :half], cache)
        last, _ = forward_with_cache(cfg, params, ids[:, half:], cache)
    np.testing.assert_allclose(last[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["phi", "gemma2"])
def test_serve_greedy_tokens_equal_generate(name):
    model, ids, _ = _hf(name)
    module, params, cfg = thf.replace_transformer_layer(
        model, dtype=torch.float32)
    eng = deepspeed_tpu_torch.init_inference(
        module, {"dtype": "float32"}, model_parameters=params, device="cpu")
    prompts = torch.from_numpy(ids[:, :10])
    gen = eng.generate(prompts, max_new_tokens=8)
    srv = eng.serve({"block_size": 8, "pool_blocks": 16, "max_batch": 2,
                     "max_blocks_per_seq": 4})
    outs = srv.generate_batch([p.tolist() for p in prompts], 8)
    assert [list(o) for o in outs] == gen[:, 10:].tolist()


def test_deepspeed_transformer_layer_matches_jax():
    """One block on [B, S, H] hidden states, on the same params as the
    JAX layer; the mask contract: a [B, S] int mask (tail masked) changes
    the visible rows, an additive float mask and MoE raise."""
    cfg = jtr.TransformerConfig(hidden_size=32, num_heads=4, num_layers=1,
                                dtype=jnp.float32, causal=False)
    layer = jtr.DeepSpeedTransformerLayer(cfg)
    x = np.random.default_rng(4).standard_normal((2, 8, 32)).astype(
        np.float32)
    jp = jax.device_get(layer.init(jax.random.PRNGKey(0), x))
    mask = np.ones((2, 8), np.int32)
    mask[:, -3:] = 0
    tp = params_from_jax(jp["params"]["Block_0"])
    tlayer = deepspeed_tpu_torch.DeepSpeedTransformerLayer(
        _torch_cfg(cfg), tp, device="cpu")
    assert deepspeed_tpu_torch.DeepSpeedTransformerConfig is \
        ttr.TransformerConfig
    with torch.no_grad():
        for m in (None, mask):
            ref = np.asarray(layer.apply(jp, x, m))
            ours = tlayer(torch.from_numpy(x),
                          None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4,
                                       atol=1e-4)
        full = tlayer(torch.from_numpy(x))
        masked = tlayer(torch.from_numpy(x), torch.from_numpy(mask))
    assert not torch.allclose(full[:, :5], masked[:, :5])
    with pytest.raises(ValueError, match="additive"):
        tlayer(torch.from_numpy(x),
               torch.from_numpy((1.0 - mask) * -10000.0))
    with pytest.raises(ValueError, match="MoE"):
        deepspeed_tpu_torch.DeepSpeedTransformerLayer(
            ttr.TransformerConfig(hidden_size=32, num_heads=4, num_layers=1,
                                  moe_experts=4))
    seeded = deepspeed_tpu_torch.DeepSpeedTransformerLayer(
        _torch_cfg(cfg), seed=3, device="cpu")
    assert seeded(torch.from_numpy(x)).shape == (2, 8, 32)


def test_deepspeed_transformer_layer_defaults_to_cuda(monkeypatch):
    """Like every entry point, the layer runs on CUDA unless the caller
    passes device="cpu": with no card and no device it raises, seeded or
    given its params, rather than carrying on on the CPU."""
    cfg = ttr.TransformerConfig(hidden_size=32, num_heads=4, num_layers=1,
                                dtype=torch.float32, causal=False)
    cpu = deepspeed_tpu_torch.DeepSpeedTransformerLayer(cfg, device="cpu")
    assert {p.device.type for p in cpu.parameters()} == {"cpu"}
    params = {name: dict(leaf.p) for name, leaf in cpu.block.named_children()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"params": params}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            deepspeed_tpu_torch.DeepSpeedTransformerLayer(cfg, **kw)
