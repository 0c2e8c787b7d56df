"""Port parity: mixture of experts (``deepspeed_tpu_torch.moe``, the MoE
``Transformer``, its decode and serving paths and its engine) against the
JAX package, on the CPU in f32.

Inputs and weights come from numpy seeds and flax inits, carried across
by ``models.convert``. Tolerances:

* gating: dispatch masks and expert counts exact, combine weights and aux
  atol 1e-6, the combine weights' gradient w.r.t. the logits atol 1e-6;
* the ``MoE`` layer (GELU and SwiGLU experts, top-1 and top-2, a dropping
  and a no-drop capacity): y atol 1e-6, aux 1e-6 and every parameter's
  grad 1e-5 relative to its largest; the index-formed queues against the
  one-hot einsums (``moe_reference``) atol 1e-6;
* top-2's Gumbel pick: the first choice never changes, and over 20,000
  tokens each second pick's frequency is within 0.015 of softmax over
  the other experts' logits;
* a 2-layer MoE ``Transformer`` (gpt2-tiny widths with GELU experts, and
  a Mixtral-shaped one with SwiGLU experts and top-2): logits atol 1e-5,
  aux and the loss rtol 1e-5 (plain and fused CE), every grad atol 2e-5
  plus rtol 1e-4, as ``test_torch_training.py``; under each remat policy
  the same grads;
* the grouped gating of one process standing in for a mesh (the JAX
  layer's G groups) equals the JAX model under its mesh (1e-5), and an
  ungrouped fallback raises;
* ``forward_with_cache`` (prefill and decode), ``generate`` tokens and
  ``paged_forward`` (prefill and decode) against JAX's (atol 1e-4);
  ``serve()`` tokens equal ``generate()``'s, with bf16 and int8 weights;
* ``num_params`` / ``num_active_params`` equal JAX's;
* a 12-step ``train_batch`` trajectory with the ``moe`` section and
  ``make_moe_loss`` against the JAX engine at top-1 (loss rtol 1e-4, grad
  norm 1e-3; the JAX engine's top-2 always draws its Gumbel noise in
  training, so no top-2 trajectory can match it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import build_model as jbuild_model
from deepspeed_tpu.models import generation as jgen
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager
from deepspeed_tpu.serving.kv_cache import init_pool as jax_init_pool
from deepspeed_tpu.serving.model_runner import \
    paged_forward as jax_paged_forward

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import generation as tgen
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import (module_from_jax,
                                                module_to_jax,
                                                params_from_jax)
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.serving.kv_cache import init_pool
from deepspeed_tpu_torch.serving.model_runner import paged_forward

ARCHS = {
    # gpt2-tiny widths: LayerNorm, GELU experts with biases, tied head
    "gpt2": dict(moe_experts=4, moe_k=1, moe_capacity_factor=1.0),
    # Mixtral-shaped: RMSNorm, GQA, rotary, SwiGLU experts, top-2
    "mixtral": dict(pos_embed="rotary", rotary_interleaved=False,
                    norm="rmsnorm", gated_mlp=True, activation="silu",
                    num_kv_heads=2, tie_embeddings=False, use_bias=False,
                    mlp_dim_override=48, moe_experts=4, moe_k=2,
                    moe_capacity_factor=1.0),
}


@pytest.fixture(autouse=True)
def _precise_and_meshless(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _cfgs(arch, **extra):
    kw = dict(hidden_size=32, num_layers=2, num_heads=4, vocab_size=64,
              max_seq_len=64, attention_impl="auto", dtype=jnp.float32)
    kw.update(ARCHS[arch])
    kw.update(extra)
    _, jcfg = jbuild_model("gpt2-tiny", **kw)
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f["dtype"] = torch.float32
    return jcfg, ttr.TransformerConfig(**f)


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        p = jax.jit(jtr.Transformer(jcfg).init)(
            jax.random.PRNGKey(3), {"input_ids": np.zeros((1, 8), np.int32)})
        _PARAMS[arch] = _np(jax.device_get(p["params"]))
    return _PARAMS[arch]


def _ids(B, S, seed):
    return np.random.default_rng(seed).integers(0, 64, (B, S)).astype(
        np.int32)


def _logits(T, E, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((T, E)) * scale
            ).astype(np.float32)


# ------------------------------------------------------------------ gating

@pytest.mark.parametrize("k,cf", [(1, 0.5), (1, 2.0), (2, 0.5), (2, 2.0)])
def test_gating_matches_jax(k, cf):
    lg = _logits(64, 4, seed=k * 10 + int(cf))
    jf = jsm.top1_gating if k == 1 else jsm.top2_gating
    tf = tsm.top1_gating if k == 1 else tsm.top2_gating
    jaux, jcomb, jdisp, jcnt = jf(jnp.asarray(lg), capacity_factor=cf)
    taux, tcomb, tdisp, tcnt = tf(torch.from_numpy(lg), capacity_factor=cf)
    np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jdisp))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(tcomb.numpy(), np.asarray(jcomb), atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    assert tsm.compute_capacity(64, 4, cf, k) == jsm.compute_capacity(
        64, 4, cf, k)
    if cf < 1.0:                         # the capacity really drops tokens
        assert tcnt.sum().item() < 64 * k


@pytest.mark.parametrize("k", [1, 2])
def test_combine_gradient_matches_jax(k):
    lg = _logits(32, 4, seed=7 + k)
    w = np.random.default_rng(9).standard_normal((32, 4, 16)).astype(
        np.float32)
    jf = jsm.top1_gating if k == 1 else jsm.top2_gating
    tf = tsm.top1_gating if k == 1 else tsm.top2_gating

    def jloss(x):
        aux, comb, _, _ = jf(x, capacity=16)
        return jnp.sum(comb * w) + 0.1 * aux

    jg = jax.grad(jloss)(jnp.asarray(lg))
    x = torch.from_numpy(lg).requires_grad_()
    aux, comb, disp, _ = tf(x, capacity=16)
    assert not disp.requires_grad
    ((comb * torch.from_numpy(w)).sum() + 0.1 * aux).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_gumbel_second_pick_follows_softmax_of_the_rest():
    T, E = 20000, 4
    lg = torch.from_numpy(np.tile(np.array([[2.0, 0.5, 0.0, -1.0]],
                                           np.float32), (T, 1)))
    gen = torch.Generator().manual_seed(0)
    r = tsm.route(lg, 2, T, gen)
    clean = tsm.route(lg, 2, T, None)
    assert torch.equal(r.expert[:, 0], clean.expert[:, 0])   # first: clean
    assert (r.expert[:, 0] == 0).all()
    assert (r.expert[:, 1] != r.expert[:, 0]).all()
    freq = torch.bincount(r.expert[:, 1], minlength=E).double() / T
    want = torch.softmax(lg[0, 1:].double(), 0)
    np.testing.assert_allclose(freq[1:].numpy(), want.numpy(), atol=0.015)
    # no generator: the second pick is the clean runner-up every time
    assert (clean.expert[:, 1] == 1).all()
    # the layer draws only in training, only for top-2
    H = 8
    m = tlayer.MoE(H, 4, k=2, dtype=torch.float32, seed=1)
    x = torch.randn(2, 16, H, generator=torch.Generator().manual_seed(2))
    y0, _ = m(x, train=False, generator=torch.Generator().manual_seed(5))
    y1, _ = m(x, train=False)
    assert torch.equal(y0, y1)
    y2, _ = m(x, train=True, generator=torch.Generator().manual_seed(5))
    y3, _ = m(x, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(y2, y3)


# ------------------------------------------------------------------- layer

def _jax_layer(gated, k, cf, H=16, F=24, E=4):
    if gated:
        mk = lambda: jlayer.GatedExpertMLP(H, F, dtype=jnp.float32,
                                           use_bias=False, name="experts")
    else:
        mk = lambda: jlayer.ExpertMLP(H, F, dtype=jnp.float32,
                                      name="experts")
    return jlayer.MoE(hidden_size=H, num_experts=E, expert=mk, k=k,
                      capacity_factor=cf, eval_capacity_factor=cf,
                      dtype=jnp.float32)


@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["drop", "nodrop"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("gated", [False, True], ids=["gelu", "swiglu"])
def test_moe_layer_matches_flax(gated, k, cf):
    H, E, B, S = 16, 4, 2, 12
    jm = _jax_layer(gated, k, cf)
    x = np.random.default_rng(0).standard_normal((B, S, H)).astype(
        np.float32)
    jp = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    wt = np.cos(np.arange(B * S * H)).reshape(B, S, H).astype(np.float32)

    def jloss(p):
        y, aux = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y * wt) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp)
    m = tlayer.MoE(H, E, k=k, capacity_factor=cf, eval_capacity_factor=cf,
                   dtype=torch.float32, params=params_from_jax(_np(jp)))
    assert isinstance(m.experts, (tlayer.GatedExpertMLP if gated
                                  else tlayer.ExpertMLP))
    y, aux = m(torch.from_numpy(x))
    ((y * torch.from_numpy(wt)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-6)
    grads = dict(m.named_parameters())
    for path, g in _flat(_np(jg)).items():
        got = grads[path.replace("/", ".")].grad.numpy()
        np.testing.assert_allclose(got, g, atol=1e-5 * np.abs(g).max(),
                                   err_msg=path)
    # the index-formed queues against the one-hot einsums
    with torch.no_grad():
        yr, auxr = tlayer.moe_reference(m, torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), yr.numpy(), atol=1e-6)
    assert auxr.item() == aux.item()


def test_moe_layer_default_params_and_k_check():
    m = tlayer.MoE(32, 4, dtype=torch.float32)
    assert tuple(m.experts.fc.kernel.shape) == (4, 32, 128)
    assert tuple(m.gate.kernel.shape) == (32, 4)
    y, aux = m(torch.randn(2, 8, 32))
    assert y.shape == (2, 8, 32) and torch.isfinite(aux)
    with pytest.raises(ValueError, match="k must be 1 or 2"):
        tlayer.MoE(32, 4, k=3)


# ------------------------------------------------------------- transformer

@pytest.mark.parametrize("arch,fused", [("gpt2", False), ("gpt2", True),
                                        ("mixtral", False),
                                        ("mixtral", True)])
def test_moe_transformer_logits_aux_and_grads_match_flax(arch, fused):
    extra = dict(fused_loss=True, loss_chunk=8) if fused else {}
    jcfg, tcfg = _cfgs(arch, **extra)
    jp = _params(arch)
    batch = {"input_ids": _ids(3, 24, seed=1)}
    jmodel = jtr.Transformer(jcfg)
    base = jtr.fused_loss_passthrough if fused else jtr.causal_lm_loss
    jlf = jtr.make_moe_loss(0.01, base_loss=base)

    def jloss(p):
        out = jmodel.apply({"params": p}, batch)
        return jlf(out, batch), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    module = module_from_jax(jp, tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out, aux = module(tb)
    tlf = ttr.make_moe_loss(
        0.01, base_loss=ttr.fused_loss_passthrough if fused
        else ttr.causal_lm_loss)
    assert tlf._moe_loss and tlf._moe_aux_weight == 0.01
    tl = tlf((out, aux), tb)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jout[1]), rtol=1e-5)
    if not fused:
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(jout[0]), atol=1e-5, rtol=0)
    tgrads = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        key = "/".join(["blocks"] + parts[2:]) if parts[0] == "blocks" \
            else "/".join(parts)
        tgrads.setdefault(key, []).append(p.grad.numpy())
    tgrads = {k: (np.stack(v) if k.startswith("blocks/") else v[0])
              for k, v in tgrads.items()}
    jflat = _flat(_np(jg))
    assert sorted(tgrads) == sorted(jflat)
    for name, g in jflat.items():
        np.testing.assert_allclose(tgrads[name], g, atol=2e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["full", "attn", "dots"])
def test_moe_transformer_under_remat_keeps_its_grads(policy):
    _, tcfg = _cfgs("mixtral")
    jp = _params("mixtral")
    tb = {"input_ids": torch.from_numpy(_ids(2, 16, seed=2))}
    lf = ttr.make_moe_loss(0.01)

    def grads(cfg):
        m = module_from_jax(jp, cfg)
        lf(m(tb, train=True, gating_seed=11), tb).backward()
        return {n: p.grad.clone() for n, p in m.named_parameters()}

    ref = grads(tcfg)
    got = grads(dataclasses.replace(tcfg, remat=True, remat_policy=policy))
    for n in ref:
        torch.testing.assert_close(got[n], ref[n], rtol=1e-5, atol=1e-7)


def test_moe_init_params_and_module_round_trip():
    jcfg, tcfg = _cfgs("mixtral")
    jp = _params("mixtral")
    shapes = lambda t: {k: (shapes(v) if isinstance(v, dict)
                            else tuple(v.shape)) for k, v in t.items()}
    mine = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    assert shapes(mine) == shapes(jp)
    module = module_from_jax(jp, tcfg)
    back = _flat(module_to_jax(module))
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # a seeded module builds the MoE blocks, each layer its own experts
    m = ttr.Transformer(tcfg, seed=4)
    assert tuple(m.blocks[1].moe.experts.gate.kernel.shape) == (4, 32, 48)
    with pytest.raises(ValueError, match="MoE"):
        ttr.DeepSpeedTransformerLayer(tcfg, device="cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_num_params_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.num_active_params() == jcfg.num_active_params()
    assert tcfg.num_active_params() < tcfg.num_params()
    dense_j, dense_t = _cfgs(arch, moe_experts=0)
    assert dense_t.num_params() == dense_j.num_params() == \
        dense_t.num_active_params()


def test_grouped_gating_matches_the_jax_mesh_and_ungrouped_raises():
    """One process standing in for a data 2 x expert 2 mesh gates its
    tokens in the mesh's 4 groups, as the JAX model does under it."""
    jcfg, tcfg = _cfgs("gpt2")
    jp = _params("gpt2")
    ids = _ids(4, 16, seed=3)
    mm = MeshManager(devices=jax.devices()[:4], ep_size=2)
    jmesh.set_global_mesh(mm)
    jlog, jaux = jax.jit(lambda p, b: jtr.Transformer(jcfg).apply(
        {"params": p}, b, train=True))(jp, {"input_ids": ids})
    tmesh.set_global_mesh(tmesh.MeshManager(devices=list(range(4)),
                                            ep_size=2))
    module = module_from_jax(jp, tcfg)
    with torch.no_grad():
        log, aux = module({"input_ids": torch.from_numpy(ids)}, train=True)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 3"):
        module({"input_ids": torch.from_numpy(ids[:3, :5])})


# ---------------------------------------------------------- decode / serve

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_forward_with_cache_and_generate_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = _params(arch)
    tp = params_from_jax(jp)
    ids = _ids(3, 21, seed=4)
    fwc = jax.jit(lambda p, x, c: jgen.forward_with_cache(jcfg, p, x, c))
    jc = jgen.init_cache(jcfg, 3, 64)
    jl, jc = fwc(jp, jnp.asarray(ids[:, :20]), jc)
    jl2, jc = fwc(jp, jnp.asarray(ids[:, 20:]), jc)
    tc = tgen.init_cache(tcfg, 3, 64)
    tl, tc = tgen.forward_with_cache(tcfg, tp, torch.from_numpy(ids[:, :20]),
                                     tc, prefill_flash=True)
    tl2, tc = tgen.forward_with_cache(tcfg, tp, torch.from_numpy(ids[:, 20:]),
                                      tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4)
    out = tgen.generate(tcfg, tp, torch.from_numpy(ids[:, :10]), 8)
    ref = jgen.generate(jcfg, jp, jnp.asarray(ids[:, :10]), 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_paged_forward_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, max_seq_len=128)
    jp = _params(arch)
    tp = params_from_jax(jp)
    bs, nblocks, B, T = 16, 12, 2, 32
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 64, size=(B, T)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    ctx = np.asarray([21, 32], np.int32)
    q0 = np.zeros((B,), np.int32)
    jpools = jax_init_pool(jcfg, nblocks, bs)
    tpools = init_pool(tcfg, nblocks, bs)
    jpf = lambda *a: jax_paged_forward(jcfg, jp, *a, bs)
    jl, jpools = jpf(jnp.asarray(ids), jpools, jnp.asarray(bt),
                     jnp.asarray(q0), jnp.asarray(ctx))
    tl, tpools = paged_forward(tcfg, tp, torch.from_numpy(ids), tpools,
                               torch.from_numpy(bt), torch.from_numpy(q0),
                               torch.from_numpy(ctx), bs)
    for b in range(B):
        np.testing.assert_allclose(tl[b, :ctx[b]].numpy(),
                                   np.asarray(jl)[b, :ctx[b]], atol=1e-4)
    for _ in range(2):
        tok = rng.integers(1, 64, size=(B, 1)).astype(np.int32)
        jl, jpools = jpf(jnp.asarray(tok), jpools, jnp.asarray(bt),
                         jnp.asarray(ctx), jnp.asarray(ctx + 1))
        tl, tpools = paged_forward(tcfg, tp, torch.from_numpy(tok), tpools,
                                   torch.from_numpy(bt),
                                   torch.from_numpy(ctx),
                                   torch.from_numpy(ctx + 1), bs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        ctx = ctx + 1


@pytest.mark.parametrize("weights", [None, "int8"])
def test_moe_serve_tokens_equal_generate(weights):
    """serve() on the MoE model: greedy tokens equal generate()'s; under
    serving.weight_dtype int8 the MoE subtree stays unpacked (the router
    and experts are no dense leaves) and attention and the head go
    through quant_matmul, whose plain version runs here."""
    _, tcfg = _cfgs("mixtral", max_seq_len=128)
    tp = params_from_jax(_params("mixtral"))
    serving = {"block_size": 16, "pool_blocks": 40, "max_batch": 3,
               "max_blocks_per_seq": 6}
    if weights:
        serving["weight_dtype"] = weights
    eng = deepspeed_tpu_torch.init_inference(
        tcfg, {"dtype": "float32", "serving": serving}, model_parameters=tp,
        device="cpu")
    srv = eng.serve()
    if weights:
        assert "kernel_qscale" in srv.params["blocks"]["attn_qkv"]
        assert "kernel_qscale" not in srv.params["blocks"]["moe"][
            "experts"]["fc"]
    prompts = [list(_ids(1, n, seed=n)[0]) for n in (5, 17, 30)]
    outs = srv.generate_batch(prompts, 6)
    for p, o in zip(prompts, outs):
        ref = tgen.generate(tcfg, srv.params,
                            torch.tensor([p]), 6)[0, len(p):].tolist()
        assert list(o) == ref


def test_moe_int8_engine_matches_jax():
    """dtype int8 (per-channel weight-only): the experts quantize and
    dequantize through _kernel_of, the router (a ``gate`` path) and the
    SwiGLU experts' ``gate`` projection stay f32, as in JAX."""
    from deepspeed_tpu.inference.engine import InferenceEngine as JEngine
    jcfg, tcfg = _cfgs("mixtral")
    jp = _params("mixtral")
    ids = _ids(2, 12, seed=6)
    jeng = JEngine(jtr.Transformer(jcfg), {"dtype": "int8"},
                   model_parameters=jp)
    teng = deepspeed_tpu_torch.init_inference(
        tcfg, {"dtype": "int8"}, model_parameters=params_from_jax(jp),
        device="cpu")
    ex = teng.params["blocks"]["moe"]["experts"]
    assert ex["fc"]["kernel"].dtype == torch.int8
    assert ex["gate"]["kernel"].dtype != torch.int8
    assert teng.params["blocks"]["moe"]["gate"]["kernel"].dtype != torch.int8
    got = teng.forward({"input_ids": ids}).to(torch.float32).numpy()
    want = np.asarray(jeng.forward({"input_ids": ids}), np.float32)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)


# ------------------------------------------------------------------ engine

def test_moe_engine_trajectory_matches_jax_at_top1(tmp_path):
    jcfg, tcfg = _cfgs("mixtral", moe_k=1)
    jp = _params("mixtral")
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 0.5, "zero_optimization": {"stage": 1},
           "steps_per_print": 100, "moe": {"enabled": True, "ep_size": 1}}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=cfg, model_parameters=jp,
        loss_fn=jtr.make_moe_loss(0.02),
        mesh_manager=MeshManager(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=cfg, model_parameters=jp,
        loss_fn=ttr.make_moe_loss(0.02), device="cpu")
    losses = []
    for step in range(12):
        batch = {"input_ids": _ids(8, 16, seed=20 + step % 3)}
        jm = jax.device_get(jeng.train_batch(batch))
        tm = teng.train_batch(batch)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        assert np.isfinite(tm["aux"]) and tm["aux"] > 0
        losses.append(tm["loss"])
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    # a checkpoint of the MoE engine crosses to the JAX engine
    teng.save_checkpoint(str(tmp_path))
    jeng2, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=cfg, model_parameters=jp,
        loss_fn=jtr.make_moe_loss(0.02),
        mesh_manager=MeshManager(devices=jax.devices()[:1]))
    jeng2.load_checkpoint(str(tmp_path))
    sd = teng.module_state_dict()
    for k, v in jeng2.module_state_dict().items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), sd[k],
                                      err_msg=k)


def test_moe_engine_top2_draws_noise_per_step():
    """Top-2 training draws its Gumbel second pick from the engine's
    per-step gating seed: two engines agree bitwise, and a step's noise
    differs from the next's."""
    _, tcfg = _cfgs("mixtral")
    jp = _params("mixtral")
    cfg = {"train_batch_size": 4, "optimizer": {"type": "AdamW",
                                                "params": {"lr": 1e-3}},
           "moe": {"enabled": True}}
    engs = [deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=cfg, model_parameters=jp,
        loss_fn=ttr.make_moe_loss(0.02), device="cpu")[0] for _ in range(2)]
    batch = {"input_ids": _ids(4, 16, seed=30)}
    first = engs[0]._gating_seed(0)
    a = [engs[0].train_batch(batch) for _ in range(2)]
    b = [engs[1].train_batch(batch) for _ in range(2)]
    assert [m["loss"] for m in a] == [m["loss"] for m in b]
    assert engs[0]._gating_seed(0) not in (first, engs[0]._dropout_seed(0))
    with pytest.raises(ValueError, match="moe.ep_size 2"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), device="cpu",
            config=dict(cfg, moe={"enabled": True, "ep_size": 2}))
