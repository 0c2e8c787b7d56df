"""Port parity: deepspeed_tpu_torch serving path vs the JAX package.

The same flax-initialized f32 weights (numpy in, ``params_from_jax``)
run through both packages on the CPU:

* ``paged_forward`` prefill and decode logits agree to atol 1e-4 (f32,
  sums in another order) for a llama-style config, ``gpt2-tiny`` and an
  ALiBi + softcap + window config;
* the ``ServingEngine`` greedy outputs are token-exact against the JAX
  engine on staggered requests with a shared prefix (equal prefix hits),
  also under chunked prefill, an int8 KV pool and int8 weights;
* ``init_inference(...).serve()`` works from a JSON file, and the config
  surface dumps equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config import ServingConfig as JServingConfig
from deepspeed_tpu.inference.config import \
    load_inference_config as jax_load_inference_config
from deepspeed_tpu.models import build_model
from deepspeed_tpu.serving.engine import ServingEngine as JServingEngine
from deepspeed_tpu.serving.kv_cache import init_pool as jax_init_pool
from deepspeed_tpu.serving.model_runner import paged_forward as jax_paged_forward

import deepspeed_tpu_torch
from deepspeed_tpu_torch.config.config import ServingConfig
from deepspeed_tpu_torch.inference.config import load_inference_config
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.serving.kv_cache import init_pool
from deepspeed_tpu_torch.serving.model_runner import paged_forward

ARCHS = {
    "llama": dict(pos_embed="rotary", rotary_interleaved=False,
                  norm="rmsnorm", gated_mlp=True, activation="silu",
                  num_kv_heads=2, tie_embeddings=False, use_bias=False,
                  mlp_dim_override=48),
    "gpt2": dict(),
    "alibi_softcap_window": dict(pos_embed="alibi", attn_softcap=20.0,
                                 final_logit_softcap=15.0,
                                 layer_windows=(6, 0)),
}
SERVE = {"block_size": 16, "pool_blocks": 40, "max_batch": 3,
         "max_blocks_per_seq": 6}


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port_cfg(jcfg, **kw):
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f["dtype"] = torch.float32
    f.update(kw)
    return TransformerConfig(**f)


_MODELS = {}


def _model(arch):
    """(jax cfg, jax params, port cfg, port params), built once per arch."""
    if arch not in _MODELS:
        _, jcfg = build_model("gpt2-tiny", hidden_size=32, num_layers=2,
                              num_heads=4, vocab_size=64, max_seq_len=128,
                              attention_impl="reference", dtype=jnp.float32,
                              **ARCHS[arch])
        model, _ = build_model(jcfg)
        jp = model.init(jax.random.PRNGKey(3),
                        {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        jp = _numpy_tree(jax.device_get(jp))
        _MODELS[arch] = (jcfg, jp, _port_cfg(jcfg), params_from_jax(jp))
    return _MODELS[arch]


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_has_the_jax_layout(arch):
    """Seeded port weights have the JAX package's names and shapes."""
    _, jp, cfg, tp = _model(arch)
    mine = init_params(cfg, torch.Generator().manual_seed(0))
    assert _shapes(mine) == _shapes(tp)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_paged_forward_prefill_and_decode_match_jax(arch):
    jcfg, jp, cfg, tp = _model(arch)
    bs, nbk, nblocks = 16, 4, 12
    rng = np.random.default_rng(5)
    B, T = 2, 32
    ids = rng.integers(1, 64, size=(B, T)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    ctx = np.asarray([21, 32], np.int32)        # lane 0 carries 11 padded
    q0 = np.zeros((B,), np.int32)

    jpools = jax_init_pool(jcfg, nblocks, bs)
    tpools = init_pool(cfg, nblocks, bs)
    jl, jpools = jax_paged_forward(jcfg, jp, jnp.asarray(ids), jpools,
                                   jnp.asarray(bt), jnp.asarray(q0),
                                   jnp.asarray(ctx), bs)
    tl, tpools = paged_forward(cfg, tp, torch.from_numpy(ids), tpools,
                               torch.from_numpy(bt), torch.from_numpy(q0),
                               torch.from_numpy(ctx), bs)
    for b in range(B):
        np.testing.assert_allclose(tl[b, :ctx[b]].numpy(),
                                   np.asarray(jl)[b, :ctx[b]], atol=1e-4,
                                   rtol=0)
    for step in range(3):                      # decode on top of the prefill
        tok = rng.integers(1, 64, size=(B, 1)).astype(np.int32)
        jl, jpools = jax_paged_forward(jcfg, jp, jnp.asarray(tok), jpools,
                                       jnp.asarray(bt), jnp.asarray(ctx),
                                       jnp.asarray(ctx + 1), bs)
        tl, tpools = paged_forward(cfg, tp, torch.from_numpy(tok), tpools,
                                   torch.from_numpy(bt),
                                   torch.from_numpy(ctx),
                                   torch.from_numpy(ctx + 1), bs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        ctx = ctx + 1
    np.testing.assert_allclose(tpools["k"].numpy(), np.asarray(jpools["k"]),
                               atol=1e-4, rtol=0)


def _drive(eng, prompts, new):
    """Staggered arrivals: half up front, the rest after two steps."""
    h = len(prompts) // 2
    reqs = [eng.submit(p, n) for p, n in zip(prompts[:h], new[:h])]
    eng.step()
    eng.step()
    reqs += [eng.submit(p, n) for p, n in zip(prompts[h:], new[h:])]
    eng.run_until_idle()
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("variant", ["plain", "chunked", "int8_kv",
                                     "int8_weights"])
def test_serving_engine_token_exact_vs_jax(variant):
    arch = "gpt2" if variant == "chunked" else "llama"
    jcfg, jp, cfg, tp = _model(arch)
    extra = {"plain": {}, "chunked": {"prefill_chunk_tokens": 10},
             "int8_kv": {"kv_cache_dtype": "int8"},
             "int8_weights": {"weight_dtype": "int8",
                              "kv_cache_dtype": "int8"}}[variant]
    serving = dict(SERVE, **extra)
    rng = np.random.default_rng(17)
    system = list(rng.integers(1, 64, size=16))  # one shared full block
    prompts = [system + list(rng.integers(1, 64, size=n))
               for n in (3, 9, 14, 1, 6)] + [list(rng.integers(1, 64, 7))]
    new = [5, 3, 6, 4, 5, 3]
    jeng = JServingEngine(jcfg, jp, serving=serving)
    teng = ServingEngine(cfg, tp, serving=serving, device="cpu")
    jout = _drive(jeng, prompts, new)
    tout = _drive(teng, prompts, new)
    assert tout == jout
    assert [len(o) for o in tout] == new
    assert teng.stats == jeng.stats
    assert teng.stats["prefix_hit_tokens"] > 0
    assert teng.pool.used_count == jeng.pool.used_count


def test_init_inference_serve_from_json_file(tmp_path):
    jcfg, jp, cfg, tp = _model("llama")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"dtype": "float32", "serving": SERVE}))
    srv = deepspeed_tpu_torch.init_inference(
        cfg, str(path), model_parameters=tp, device="cpu").serve()
    jeng = JServingEngine(jcfg, jp, serving=SERVE)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    assert srv.generate_batch([prompt], 4) == jeng.generate_batch([prompt], 4)


def test_lane_topk_topp_matches_jax():
    """The per-lane top-k / top-p filter (``serving.sampling_filters``)
    keeps exactly the JAX filter's logits, lane by lane."""
    from deepspeed_tpu.serving.engine import lane_topk_topp as jax_filter
    from deepspeed_tpu_torch.serving.engine import lane_topk_topp
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 64)).astype(np.float32)
    logits[2, 10] = logits[2, 11]                      # a tie at the kth value
    tks = np.asarray([5, 0, 8, 0, 1, 3], np.int32)
    tps = np.asarray([1.0, 0.9, 0.5, 1.0, 1.0, 0.95], np.float32)
    port = lane_topk_topp(torch.from_numpy(logits), torch.from_numpy(tks),
                          torch.from_numpy(tps)).numpy()
    ref = np.asarray(jax_filter(jnp.asarray(logits), jnp.asarray(tks),
                                jnp.asarray(tps)))
    np.testing.assert_array_equal(port > -1e29, ref > -1e29)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


def test_sampled_lanes_finish_next_to_greedy_lanes():
    """Temperature and filtered lanes draw from the engine's generator
    (their tokens differ from the JAX engine's by design); greedy lanes
    beside them stay token-exact."""
    jcfg, jp, cfg, tp = _model("llama")
    serving = dict(SERVE, sampling_filters=True)
    teng = ServingEngine(cfg, tp, serving=serving, device="cpu")
    jeng = JServingEngine(jcfg, jp, serving=serving)
    p = [5, 9, 2, 33, 7]
    greedy = teng.submit(p, 5)
    sampled = teng.submit(p, 5, temperature=0.8, top_k=4, top_p=0.9)
    teng.run_until_idle()
    assert greedy.output_tokens == jeng.generate_batch([p], 5)[0]
    assert len(sampled.output_tokens) == 5
    assert all(0 <= t < cfg.vocab_size for t in sampled.output_tokens)


CONFIGS = [
    {},
    {"dtype": "bf16", "serving": {"block_size": 32, "pool_blocks": 256,
                                  "max_batch": 8, "max_blocks_per_seq": 64}},
    {"serving": {"kv_cache_dtype": "int8", "weight_dtype": "int8",
                 "prefill_chunk_tokens": 64,
                 "fleet": {"priority_aging_s": 5.0, "batch_highwater": 0.5,
                           "autoscale": {"enabled": False}}}},
    {"tp": {"tp_size": 1}, "watchdog": {"serve_timeout": 0.0},
     "max_tokens": 2048, "unknown_key": 7},
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_config_surface_dumps_equal(i):
    d = CONFIGS[i]
    assert (load_inference_config(d).model_dump()
            == jax_load_inference_config(d).model_dump())
    s = d.get("serving", {})
    assert ServingConfig(**s).model_dump() == JServingConfig(**s).model_dump()
