"""Port parity: deepspeed_tpu_torch generation vs the JAX package.

The same flax-initialized f32 weights (numpy in, ``params_from_jax``) run
through both packages on the CPU:

* ``forward_with_cache`` prefill logits (the JAX prefill on its flash
  kernel in interpret mode, the port's on the flash wrapper, which runs
  the plain version for CPU tensors) and decode logits agree to atol 1e-4
  (f32, sums in another order) for the serving tests' three architectures
  and a uniform-window one, so the flash prefill runs with a window;
* the routes are the call's, not the device's: counting wrappers show
  which calls reach the flash and decode wrappers;
* ``generate`` is token-exact against JAX ``generate`` greedy, also for a
  left-padded ragged batch and the int8 KV cache, and through
  ``init_inference(...).generate`` (whose f32 ``forward`` logits match
  JAX's to 1e-4); the port's ``ServingEngine`` greedy
  outputs equal its own ``generate()``;
* ``apply_top_p`` / ``apply_repetition_penalty`` equal JAX's exactly, and
  sampling reproduces from a generator seed inside the filtered support;
* ``quantize_weights_int8`` bytes equal JAX's (scales to rtol 1e-6), and
  the int8 engine's ``forward`` logits match JAX's to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import InferenceEngine as JInferenceEngine
from deepspeed_tpu.inference.engine import \
    quantize_weights_int8 as jax_quantize_weights_int8
from deepspeed_tpu.models import build_model
from deepspeed_tpu.models import generation as jgen

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.engine import quantize_weights_int8
from deepspeed_tpu_torch.models import generation as tgen
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.serving.engine import ServingEngine

ARCHS = {
    "llama": dict(pos_embed="rotary", rotary_interleaved=False,
                  norm="rmsnorm", gated_mlp=True, activation="silu",
                  num_kv_heads=2, tie_embeddings=False, use_bias=False,
                  mlp_dim_override=48),
    "gpt2": dict(),
    "alibi_softcap_window": dict(pos_embed="alibi", attn_softcap=20.0,
                                 final_logit_softcap=15.0,
                                 layer_windows=(6, 0)),
    "uniform_window": dict(pos_embed="rotary", layer_windows=(9, 9),
                           attn_softcap=10.0),
}
_MODELS = {}


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _model(arch):
    """(flax model, jax cfg, jax params, port cfg, port params), once per
    architecture."""
    if arch not in _MODELS:
        _, jcfg = build_model("gpt2-tiny", hidden_size=32, num_layers=2,
                              num_heads=4, vocab_size=64, max_seq_len=128,
                              attention_impl="auto", dtype=jnp.float32,
                              **ARCHS[arch])
        model, _ = build_model(jcfg)
        jp = model.init(jax.random.PRNGKey(3),
                        {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        jp = _numpy_tree(jax.device_get(jp))
        f = {fl.name: getattr(jcfg, fl.name)
             for fl in dataclasses.fields(jcfg)}
        f["dtype"] = torch.float32
        _MODELS[arch] = (model, jcfg, jp, TransformerConfig(**f),
                         params_from_jax(jp))
    return _MODELS[arch]


def _ids(B, T, seed):
    return np.random.default_rng(seed).integers(1, 64, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_with_cache_matches_jax(arch):
    """Prefill of an empty cache, then three decode steps."""
    _, jcfg, jp, cfg, tp = _model(arch)
    B, T, max_len = 2, 32, 64
    ids = _ids(B, T, 5)
    jc = jgen.init_cache(jcfg, B, max_len)
    tc = tgen.init_cache(cfg, B, max_len)
    jl, jc = jgen.forward_with_cache(jcfg, jp, jnp.asarray(ids), jc,
                                     prefill_flash="interpret")
    tl, tc = tgen.forward_with_cache(cfg, tp, torch.from_numpy(ids), tc,
                                     prefill_flash=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    rng = np.random.default_rng(6)
    for _ in range(3):
        tok = rng.integers(1, 64, (B, 1)).astype(np.int32)
        jl, jc = jgen.forward_with_cache(jcfg, jp, jnp.asarray(tok), jc)
        tl, tc = tgen.forward_with_cache(cfg, tp, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    assert tc["pos"] == int(jc["pos"]) == T + 3
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4, rtol=0)


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls that reach the flash and decode wrappers."""
    n = {"flash": 0, "decode": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention",
                        counting("flash", tfa.flash_attention))
    monkeypatch.setattr(tda, "decode_attention",
                        counting("decode", tda.decode_attention))

    def run(arch, T, **kw):
        *_, cfg, tp = _model(arch)
        n.update(flash=0, decode=0)
        cache = tgen.init_cache(cfg, 2, 128, dtype=kw.pop("dtype", None),
                                pad_lens=kw.pop("pad_lens", None))
        tgen.forward_with_cache(cfg, tp, torch.ones(2, T, dtype=torch.long),
                                cache, **kw)
        return n["flash"], n["decode"]
    return run


def test_routing_follows_the_call(routes):
    L = 2
    assert routes("llama", 32, prefill_flash=True) == (L, 0)
    assert routes("llama", 1) == (0, L)
    assert routes("llama", 64) == (0, L)          # T <= 64 without flash
    assert routes("llama", 65) == (0, 0)          # plain cache path
    assert routes("uniform_window", 32, prefill_flash=True) == (L, 0)
    assert routes("alibi_softcap_window", 32, prefill_flash=True) == (0, L)
    assert routes("llama", 32, prefill_flash=True, pad_lens=[0, 3]) == (0, 0)
    assert routes("llama", 1, dtype=torch.int8) == (0, 0)
    assert routes("llama", 32, prefill_flash=True, impl="reference") == (0, 0)


@pytest.mark.parametrize("arch", ["llama", "alibi_softcap_window"])
def test_generate_greedy_token_exact(arch):
    _, jcfg, jp, cfg, tp = _model(arch)
    ids = _ids(2, 16, 7)
    jout = jgen.generate(jcfg, jp, jnp.asarray(ids), 10)
    tout = tgen.generate(cfg, tp, torch.from_numpy(ids), 10)
    assert tout.dtype == torch.long
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("variant", ["ragged", "int8_kv"])
def test_ragged_batch_and_int8_cache_match_jax(variant):
    _, jcfg, jp, cfg, tp = _model("llama")
    ids = _ids(3, 12, 8)
    kw = {}
    if variant == "ragged":
        mask = np.ones((3, 12), np.int32)
        mask[1, :4] = 0
        mask[2, :9] = 0
        kw["attention_mask"] = mask
    else:
        kw["kv_cache_dtype"] = "int8"
    jout = jgen.generate(jcfg, jp, jnp.asarray(ids), 8,
                         **{k: (jnp.asarray(v) if k == "attention_mask"
                                else v) for k, v in kw.items()})
    tout = tgen.generate(cfg, tp, torch.from_numpy(ids), 8, **kw)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    if variant == "ragged":          # the all-ones mask is dropped
        ones = tgen.generate(cfg, tp, torch.from_numpy(ids), 4,
                             attention_mask=np.ones((3, 12), np.int32))
        np.testing.assert_array_equal(
            ones.numpy(), tgen.generate(cfg, tp, torch.from_numpy(ids),
                                        4).numpy())


def test_top_p_and_repetition_penalty_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 64)).astype(np.float32)
    logits[1, 7] = logits[1, 9]                     # a tie inside the nucleus
    for p in (0.0, 0.3, 0.9, 1.0):
        np.testing.assert_array_equal(
            tgen.apply_top_p(torch.from_numpy(logits), p).numpy(),
            np.asarray(jgen.apply_top_p(jnp.asarray(logits), p)))
    seen = rng.random((5, 64)) < 0.3
    np.testing.assert_array_equal(
        tgen.apply_repetition_penalty(torch.from_numpy(logits),
                                      torch.from_numpy(seen), 1.3).numpy(),
        np.asarray(jgen.apply_repetition_penalty(jnp.asarray(logits),
                                                 jnp.asarray(seen), 1.3)))


def test_sampling_reproduces_inside_the_filtered_support():
    *_, cfg, tp = _model("llama")
    ids = torch.from_numpy(_ids(2, 10, 9))
    kw = dict(temperature=0.7, top_k=4, top_p=0.95, repetition_penalty=1.2)
    draw = lambda seed: tgen.generate(
        cfg, tp, ids, 8, generator=torch.Generator().manual_seed(seed), **kw)
    a, b = draw(1), draw(1)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    # teacher-forced logits of the drawn sequence: every drawn token is
    # among the top 4 after the repetition penalty of what preceded it
    cache = tgen.init_cache(cfg, 2, 128)
    logits, _ = tgen.forward_with_cache(cfg, tp, a, cache)
    for t in range(10, 18):
        seen = torch.zeros(2, cfg.vocab_size, dtype=torch.bool)
        seen.scatter_(1, a[:, :t], True)
        pen = tgen.apply_repetition_penalty(logits[:, t - 1], seen, 1.2)
        top4 = torch.topk(pen, 4).indices
        assert (top4 == a[:, t:t + 1]).any(dim=1).all()
    # top_k=1 keeps only the argmax: sampling equals greedy
    greedy = tgen.generate(cfg, tp, ids, 6)
    one = tgen.generate(cfg, tp, ids, 6, temperature=1.0, top_k=1,
                        generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(one, greedy, atol=0, rtol=0)


def test_generate_guards():
    *_, cfg, tp = _model("gpt2")
    ids = torch.from_numpy(_ids(2, 6, 10))
    right = np.ones((2, 6), np.int32)
    right[0, 4:] = 0
    with pytest.raises(ValueError, match="LEFT-padded"):
        tgen.generate(cfg, tp, ids, 3, attention_mask=right)
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.generate(cfg, tp, ids, 200)


def test_serving_engine_equals_generate():
    """The JAX suite's own invariant, in the port: continuous-batching
    greedy outputs equal sequential generate()."""
    *_, cfg, tp = _model("llama")
    serve = {"block_size": 16, "pool_blocks": 40, "max_batch": 3,
             "max_blocks_per_seq": 6}
    prompts = [list(_ids(1, n, 20 + n)[0]) for n in (5, 17, 9, 30)]
    eng = ServingEngine(cfg, tp, serving=serve, device="cpu")
    outs = eng.generate_batch(prompts, 6)
    for p, o in zip(prompts, outs):
        seq = tgen.generate(cfg, tp, torch.tensor([p]), 6)
        assert o == seq[0, len(p):].tolist()


def test_init_inference_generate_matches_jax():
    model, jcfg, jp, cfg, tp = _model("llama")
    ids = _ids(2, 11, 12)
    jeng = JInferenceEngine(model, {"dtype": "float32"}, model_parameters=jp)
    teng = deepspeed_tpu_torch.init_inference(cfg, {"dtype": "float32"},
                                              model_parameters=tp,
                                              device="cpu")
    np.testing.assert_array_equal(
        teng.generate(ids, max_new_tokens=7).numpy(),
        np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=7)))
    # the f32 forward applies the Transformer module, as JAX applies flax
    np.testing.assert_allclose(teng.forward(ids).numpy(),
                               np.asarray(jeng.forward(jnp.asarray(ids))),
                               atol=1e-4, rtol=0)


def test_int8_weights_and_engine_match_jax():
    model, jcfg, jp, cfg, tp = _model("llama")
    jq = jax_quantize_weights_int8(jgen.ensure_scan_layout(jp, 2))
    tq = quantize_weights_int8(tp)
    jb, tb = jq["blocks"], tq["blocks"]
    for name in ("attn_qkv", "attn_proj", "mlp_gate", "mlp_fc", "mlp_proj"):
        assert tb[name]["kernel"].dtype == torch.int8
        np.testing.assert_array_equal(tb[name]["kernel"].numpy(),
                                      np.asarray(jb[name]["kernel"]))
        np.testing.assert_allclose(tb[name]["kernel_scale"].numpy(),
                                   np.asarray(jb[name]["kernel_scale"]),
                                   rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tq["lm_head"]["kernel"].numpy(),
                                  np.asarray(jq["lm_head"]["kernel"]))
    assert "kernel_scale" not in tq["wte"]
    ids = _ids(2, 9, 13)
    jeng = JInferenceEngine(model, {"dtype": "int8"}, model_parameters=jp)
    teng = deepspeed_tpu_torch.init_inference(cfg, {"dtype": "int8"},
                                              model_parameters=tp,
                                              device="cpu")
    np.testing.assert_allclose(teng.forward({"input_ids": ids}).numpy(),
                               np.asarray(jeng.forward({"input_ids": ids})),
                               atol=1e-4, rtol=0)
