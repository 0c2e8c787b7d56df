"""Port parity: deepspeed_tpu_torch training vs the JAX package, on the CPU.

The same flax-initialized f32 weights (numpy in, ``module_from_jax``) and
the same numpy-seeded batches go through both packages. Two small
architectures: gpt2-tiny (LayerNorm, GELU, learned positions, tied head)
and a two-layer llama shape (RMSNorm, SwiGLU, GQA 4q/2kv, rotary, untied
head); a third (ALiBi, a uniform window of 6, attention and logit
softcaps) for the model's grads. Both run ``attention_impl="auto"``: the JAX model takes its
reference attention on the CPU, the port's the flash wrappers, whose plain
forward and backward run for CPU tensors. Tolerances, all f32:

* logits atol 1e-5, loss rtol 1e-5, every parameter's grad atol 2e-5 plus
  rtol 1e-4 (sums in another order), for the plain and the fused CE;
* Adam / AdamW parameters and moments after 6 updates on a fixed grad
  stream: rtol 1e-5, parameters also atol 1e-6 (the same f32 formula, the
  scalars lr and bias correction in Python doubles here, f32 there);
* lr schedules rtol 1e-5 (the JAX package evaluates them in f32); the
  loss scaler exactly;
* a 12-step ``initialize`` + ``train_batch`` trajectory (gas 2, AdamW,
  clipping, WarmupLR, JSON config): loss rtol 1e-4 and grad norm rtol
  1e-3 (Adam's normalized updates carry the f32 rounding of each step);
* an fp16 step fed 1e30 is skipped identically: the scale halves, the
  step holds, the parameters stay.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

import deepspeed_tpu
from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JInferenceEngine
from deepspeed_tpu.models import build_model as jbuild_model
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.parallel.mesh import MeshManager
from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu.runtime import lr_schedules as jlr

import deepspeed_tpu_torch
from deepspeed_tpu_torch.config.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.models import generation as tgen
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import (module_from_jax,
                                                module_to_jax,
                                                params_from_jax, scan_params)
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import loss_scaler as tls
from deepspeed_tpu_torch.runtime import lr_schedules as tlr

ARCHS = {
    "gpt2": dict(),
    "llama": dict(pos_embed="rotary", rotary_interleaved=False,
                  norm="rmsnorm", gated_mlp=True, activation="silu",
                  num_kv_heads=2, tie_embeddings=False, use_bias=False,
                  mlp_dim_override=48),
    # the kernels' other features: ALiBi, a uniform window, softcaps
    "alibi": dict(pos_embed="alibi", attn_softcap=20.0, layer_windows=(6, 6),
                  final_logit_softcap=15.0),
}
# head dim 32 at seq 256: shapes the block-sparse kernels take, so the
# sparse impl and a pure window run their wrappers' plain versions
ARCHS["gpt2_wide"] = dict(hidden_size=64, num_heads=2, max_seq_len=256)
ARCHS["llama_wide"] = dict(ARCHS["llama"], hidden_size=64, num_heads=2,
                           num_kv_heads=1, mlp_dim_override=96,
                           max_seq_len=256)
SPARSE = {
    "fixed": (("attention", "unidirectional"), ("block", 16),
              ("mode", "fixed"), ("num_global_blocks", 1),
              ("num_local_blocks", 4)),
    "bigbird": (("block", 32), ("different_layout_per_head", True),
                ("mode", "bigbird"), ("num_random_blocks", 2)),
}
_MODELS = {}


@pytest.fixture(autouse=True)
def _precise_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _cfgs(arch, **extra):
    """(jax cfg, port cfg) of a tiny f32 model."""
    kw = dict(hidden_size=32, num_layers=2, num_heads=4, vocab_size=64,
              max_seq_len=64, attention_impl="auto", dtype=jnp.float32)
    kw.update(ARCHS[arch])
    kw.update(extra)
    _, jcfg = jbuild_model("gpt2-tiny", **kw)
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f["dtype"] = torch.float32
    return jcfg, ttr.TransformerConfig(**f)


def _params(arch):
    """flax-initialized numpy params of the architecture, once."""
    if arch not in _MODELS:
        jcfg, _ = _cfgs(arch)
        jp = jax.jit(jtr.Transformer(jcfg).init)(   # eager init: 4x slower
            jax.random.PRNGKey(3),
            {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        _MODELS[arch] = _numpy_tree(jax.device_get(jp))
    return _MODELS[arch]


def _batch(B, S, seed, pad=False):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, 64, (B, S)).astype(np.int32)}
    if pad:                                     # right padding: no dead rows
        lens = rng.integers(S // 2, S + 1, B)
        batch["attention_mask"] = (np.arange(S)[None] < lens[:, None]).astype(
            np.int32)
    return batch


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _grad_tree(module):
    """The module's grads under the flax paths of the scan layout."""
    out, stacks = {}, {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        g = p.grad.numpy()
        if parts[0] == "blocks":
            stacks.setdefault(f"blocks/{parts[2]}/{parts[3]}", []).append(g)
        else:
            out["/".join(parts)] = g
    out.update({k: np.stack(v) for k, v in stacks.items()})
    return out


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("arch,fused", [
    ("gpt2", False), ("gpt2", True), ("llama", False), ("llama", True),
    ("alibi", False)])
def test_transformer_loss_and_grads_match_flax(arch, fused):
    jp = _params(arch)
    extra = dict(fused_loss=True, loss_chunk=8) if fused else {}
    jcfg, tcfg = _cfgs(arch, **extra)
    batch = _batch(3, 24, seed=1, pad=arch == "gpt2")
    jmodel = jtr.Transformer(jcfg)

    def jloss(p):
        out = jmodel.apply({"params": p}, batch)
        return out if fused else jtr.causal_lm_loss(out, batch)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jp))
    module = module_from_jax(jp, tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = module(tb)
    tl = out if fused else ttr.causal_lm_loss(out, tb)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    if not fused:
        with torch.no_grad():
            logits = module(tb).numpy()
        np.testing.assert_allclose(
            logits, np.asarray(jmodel.apply({"params": jp}, batch)),
            atol=1e-5, rtol=0)
    tgrads = _grad_tree(module)
    jflat = _flat(_numpy_tree(jg))
    assert sorted(tgrads) == sorted(jflat)
    for name, g in jflat.items():
        np.testing.assert_allclose(tgrads[name], g, atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_module_round_trip_and_scan_params():
    jp = _params("llama")
    _, tcfg = _cfgs("llama")
    module = module_from_jax(jp, tcfg)
    back = _flat(module_to_jax(module))
    ref = _flat(jp)
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])
    # the trained module's weights feed the inference path directly
    ids = torch.from_numpy(_batch(2, 12, seed=4)["input_ids"])
    sp = scan_params(module)
    cache = tgen.init_cache(tcfg, 2, 64)
    logits, _ = tgen.forward_with_cache(tcfg, sp, ids, cache)
    with torch.no_grad():
        np.testing.assert_allclose(logits.numpy(), module(ids).numpy(),
                                   atol=1e-5, rtol=0)


def test_fused_ce_ignores_minus_100_and_drops_last_position():
    x = torch.randn(2, 9, 8)
    emb = torch.randn(16, 8)
    labels = torch.randint(0, 16, (2, 9))
    labels[0, 3] = -100
    logits = x @ emb.T
    ref = ttr.cross_entropy(logits[:, :-1], labels[:, 1:])
    got = ttr._fused_causal_lm_loss(x, emb, labels, chunk=3)
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)
    none = torch.full_like(labels, -100)
    assert ttr._fused_causal_lm_loss(x, emb, none, chunk=4).item() == 0.0


def test_unported_model_features_raise():
    for kw in (dict(pld=True), dict(ltd_tokens=4),
               dict(remat=True, remat_policy="offload")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=2,
                            num_heads=2, vocab_size=32, **kw)
    # activation_quant is ported (tests/test_torch_compression_training.py)
    for fmt in ("int8", "fp8"):
        m, _ = ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=2,
                               num_heads=2, vocab_size=32,
                               activation_quant=fmt)
        with torch.no_grad():
            assert torch.isfinite(m(torch.zeros(2, 8, dtype=torch.long))
                                  ).all()
    # MoE builds and returns (logits, aux) (tests/test_torch_moe.py)
    m, _ = ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=2,
                           num_heads=2, vocab_size=32, moe_experts=2)
    with torch.no_grad():
        logits, aux = m(torch.zeros(2, 8, dtype=torch.long))
    assert logits.shape == (2, 8, 32) and torch.isfinite(aux)
    # the block forms of the HF policies build and run
    ids = torch.zeros(2, 8, dtype=torch.long)
    for kw, width in ((dict(post_ln=True, causal=False), 32),
                      (dict(parallel_residual=True), 32),
                      (dict(parallel_residual=True,
                            parallel_residual_dual_ln=True), 32),
                      (dict(mlm_head=True, token_type_vocab=2,
                            embed_ln=True), 32),
                      (dict(no_lm_head=True, tie_embeddings=False), 16),
                      (dict(layer_windows=(4, 0)), 32)):
        m, _ = ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=2,
                               num_heads=2, vocab_size=32, **kw)
        with torch.no_grad():
            out = m(ids)
        assert out.shape == (2, 8, width) and torch.isfinite(out).all(), kw
    # dropout trains (it raised until the dropout sites were ported;
    # tests/test_torch_dropout.py holds its statistics)
    m, _ = ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=1,
                           num_heads=2, vocab_size=32, dropout=0.1)
    ids4 = torch.zeros(1, 4, dtype=torch.long)
    assert torch.isfinite(m(ids4, train=True)).all()
    assert not torch.equal(m(ids4, train=True, dropout_seed=1),
                           m(ids4, train=True, dropout_seed=2))
    ids = torch.zeros(1, 8, dtype=torch.long)
    m, _ = ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=1,
                           num_heads=2, vocab_size=32, layer_windows=(4,))
    # a pure window the block-sparse kernels cannot take (head dim 8, S 8)
    assert torch.isfinite(m(ids)).all()     # the flash route's window
    m, _ = ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=1,
                           num_heads=2, vocab_size=32, layer_windows=(4,),
                           attention_impl="reference")
    assert torch.isfinite(m(ids)).all()
    m, _ = ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=1,
                           num_heads=2, vocab_size=32, layer_windows=(4,),
                           attn_softcap=20.0)
    assert torch.isfinite(m(ids)).all()     # window + softcap: flash path


def _spy_block_sparse(monkeypatch):
    """Count the plain block-sparse forward's calls (the CPU route of the
    kernels' wrappers)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
    calls = []
    real = tbs._reference

    def spy(*a, **kw):
        calls.append(a[3])
        return real(*a, **kw)

    monkeypatch.setattr(tbs, "_reference", spy)
    return calls


@pytest.mark.parametrize("arch,layout", [("gpt2_wide", "fixed"),
                                         ("llama_wide", "bigbird")])
def test_sparse_transformer_loss_and_grads_match_flax(arch, layout,
                                                      monkeypatch):
    """attention_impl="sparse" with a sparse_attention tuple: the JAX model
    takes its dense-mask oracle on the CPU, the port the block-sparse
    wrappers' plain versions (each layer once); loss, logits and every
    grad agree to the tolerances of the dense model above."""
    jp = _params(arch)
    jcfg, tcfg = _cfgs(arch, attention_impl="sparse",
                       sparse_attention=SPARSE[layout])
    batch = _batch(2, 256, seed=7)
    jmodel = jtr.Transformer(jcfg)

    def jloss(p):
        return jtr.causal_lm_loss(jmodel.apply({"params": p}, batch), batch)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, jp))
    module = module_from_jax(jp, tcfg)
    calls = _spy_block_sparse(monkeypatch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = module(tb)
    assert len(calls) == tcfg.num_layers
    tl = ttr.causal_lm_loss(out, tb)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax.jit(jmodel.apply)({"params": jp}, batch)),
        atol=1e-5, rtol=0)
    tgrads, jflat = _grad_tree(module), _flat(_numpy_tree(jg))
    assert sorted(tgrads) == sorted(jflat)
    for name, g in jflat.items():
        np.testing.assert_allclose(tgrads[name], g, atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_uniform_window_transformer_matches_flax(monkeypatch):
    """A pure uniform window (layer_windows=(64, 64)): the port sends it to
    the block-sparse window route, the JAX model on the CPU to its
    reference with the window mask; fused loss and every grad agree."""
    jp = _params("llama_wide")
    jcfg, tcfg = _cfgs("llama_wide", layer_windows=(64, 64), fused_loss=True,
                       loss_chunk=64)
    batch = _batch(2, 256, seed=8)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.Transformer(jcfg).apply({"params": p}, batch)))(
            jax.tree.map(jnp.asarray, jp))
    module = module_from_jax(jp, tcfg)
    calls = _spy_block_sparse(monkeypatch)
    tl = module({k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(calls) == 2
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = _flat(_numpy_tree(jg))
    tgrads = _grad_tree(module)
    for name, g in jflat.items():
        np.testing.assert_allclose(tgrads[name], g, atol=2e-5, rtol=1e-4,
                                   err_msg=name)


# -------------------------------------------------------- optimizer & co

@pytest.mark.parametrize("name,kw", [
    ("adam", dict(lr=1e-2, weight_decay=0.1)),
    ("adamw", dict(lr=1e-2, weight_decay=0.05)),
    ("adam", dict(lr=3e-3, bias_correction=False, betas=(0.8, 0.95))),
])
def test_optimizer_trajectory_matches_jax(name, kw):
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (5,), (3, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    jo = getattr(jopt, name)(**kw)
    to = getattr(topt, name)(**kw)
    jp = [jnp.asarray(p) for p in params]
    js = jo.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = to.init(tp)
    for step, g in enumerate(grads):
        jp, js = jo.update([jnp.asarray(x) for x in g], js, jp,
                           jnp.asarray(step, jnp.int32),
                           lr_t=jnp.asarray(kw["lr"] * 0.9 ** step))
        tp, ts = to.update([torch.from_numpy(x) for x in g], ts, tp, step,
                           lr_t=kw["lr"] * 0.9 ** step)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for slot in ("m", "v"):
        for a, b in zip(ts[slot], js[slot]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-9)


def test_pure_bf16_moments_and_unported_optimizers():
    p = [torch.randn(4, 3).to(torch.bfloat16)]
    opt = topt.adamw(lr=1e-2)
    st = opt.init(p)
    assert st["m"][0].dtype == torch.bfloat16
    opt.update([torch.randn(4, 3)], st, p, 0)
    assert p[0].dtype == torch.bfloat16
    # LAMB, SGD and Adagrad are ported (tests/test_torch_optimizers.py);
    # the 1-bit family still raises
    for name in ("lamb", "fusedlamb", "sgd", "adagrad"):
        assert topt.build_optimizer(name, {"lr": 1e-3}).name in (
            "lamb", "sgd", "adagrad")
    for name in ("onebitadam", "zerooneadam", "onebitlamb"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            topt.build_optimizer(name, {"lr": 1e-3})
    with pytest.raises(ValueError, match="Unknown"):
        topt.build_optimizer("nope")


@pytest.mark.parametrize("kind,params", [
    ("WarmupLR", dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2,
                      warmup_num_steps=10)),
    ("WarmupLR", dict(warmup_max_lr=1e-2, warmup_num_steps=7,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=30, warmup_max_lr=2e-3,
                           warmup_num_steps=5)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=4,
                         lr_range_test_step_rate=2.0,
                         lr_range_test_staircase=True)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                      cycle_first_step_size=6, cycle_second_step_size=4,
                      decay_step_size=3, decay_lr_rate=0.5)),
])
def test_lr_schedule_curves_match_jax(kind, params):
    jf = jlr.build_schedule(kind, params)
    tf = tlr.build_schedule(kind, params)
    for s in range(40):
        np.testing.assert_allclose(tf(s), float(jf(s)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"{kind} step {s}")
    sched = tlr.LRScheduler(tf)
    sched.step(3)
    assert sched.get_lr() == [tf(3)]


@pytest.mark.parametrize("hyst,window", [(2, 3), (1, 2)])
def test_loss_scaler_transitions_match_jax(hyst, window):
    kw = dict(initial_scale_power=5, scale_window=window, min_scale=2.0,
              hysteresis=hyst)
    js, ts = jls.LossScaler(**kw), tls.LossScaler(**kw)
    jst, tst = js.init(), ts.init()
    for ovf in [False, True, True, False, False, False, True, True, True,
                True, True, False, False, False, False]:
        jst = js.update(jst, jnp.asarray(ovf))
        tst = ts.update(tst, ovf)
        assert (tst.scale, tst.good_steps, tst.hysteresis) == (
            float(jst.scale), int(jst.good_steps), int(jst.hysteresis))
    static = tls.LossScaler(static_scale=8.0)
    assert static.update(static.init(), True).scale == 8.0
    assert tls.LossScaler(enabled=False).init().scale == 1.0


@pytest.mark.parametrize("cfg", [
    {"train_batch_size": 32},
    {"train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2},
    {"train_batch_size": 24, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 6},
])
def test_batch_triples_resolve_like_jax(cfg):
    t, j = TConfig(**cfg), JConfig(**cfg)
    t.resolve_batch_sizes(1)
    j.resolve_batch_sizes(1)
    key = ("train_batch_size", "train_micro_batch_size_per_gpu",
           "gradient_accumulation_steps")
    assert tuple(getattr(t, k) for k in key) == \
        tuple(getattr(j, k) for k in key)
    full = {"train_batch_size": 8, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 3, "cpu_offload": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    assert TConfig(**full).model_dump() == JConfig(**full).model_dump()
    bad = {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2}
    with pytest.raises(ValueError, match="inconsistency"):
        TConfig(**bad).resolve_batch_sizes(1)


# ---------------------------------------------------------------- engine

_TRAIN_CFG = {
    "train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_num_steps": 4, "warmup_max_lr": 3e-3,
                             "warmup_type": "linear"}},
    "gradient_clipping": 0.5,
    "zero_optimization": {"stage": 1},
    "steps_per_print": 100,
}


def _engines(arch, tmp_path, cfg=None, **extra):
    jcfg, tcfg = _cfgs(arch, **extra)
    path = tmp_path / f"ds_{arch}.json"
    path.write_text(json.dumps(cfg or _TRAIN_CFG))
    fused = bool(extra.get("fused_loss"))
    jeng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=str(path),
        model_parameters=_params(arch),
        loss_fn=jtr.fused_loss_passthrough if fused else jtr.causal_lm_loss,
        mesh_manager=MeshManager(devices=jax.devices()[:1]))
    teng, topt_, _, tsched = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=str(path),
        model_parameters=_params(arch),
        loss_fn=ttr.fused_loss_passthrough if fused else ttr.causal_lm_loss,
        device="cpu")
    assert topt_ is teng.optimizer and tsched is teng.lr_scheduler
    return jeng, teng


@pytest.mark.parametrize("arch,extra", [
    ("gpt2", {}), ("llama", dict(fused_loss=True, loss_chunk=8))])
def test_train_batch_trajectory_matches_jax_engine(arch, extra, tmp_path):
    jeng, teng = _engines(arch, tmp_path, **extra)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches)
    losses = []
    for step in range(12):
        batch = _batch(8, 16, seed=100 + step % 3)
        jm = jax.device_get(jeng.train_batch(batch))
        tm = teng.train_batch(batch)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert tm["overflow"] == bool(jm["overflow"]) is False
        losses.append(tm["loss"])
    # CPU tensors: the flash wrappers ran their plain versions
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dq.launches) == before
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
    assert teng.skipped_steps == jeng.skipped_steps == 0
    assert teng.train_batch_size == 8
    assert teng.train_micro_batch_size_per_gpu() == 4
    assert teng.gradient_accumulation_steps() == 2
    assert teng.zero_optimization_stage() == 1
    sd = teng.module_state_dict()
    jsd = {k: np.array(v) for k, v in jeng.module_state_dict().items()}
    assert sorted(sd) == sorted(jsd)
    if "blocks/attn_qkv/bias" in sd:
        # the key bias's gradient is zero in exact arithmetic (softmax is
        # shift invariant): Adam normalizes each side's rounding noise
        # into steps of about lr, so that slice is left out
        kb = slice(32, 64)
        sd["blocks/attn_qkv/bias"][:, kb] = 0
        jsd["blocks/attn_qkv/bias"][:, kb] = 0
    for k in jsd:
        np.testing.assert_allclose(sd[k], jsd[k], atol=2e-4, rtol=1e-3,
                                   err_msg=k)


def test_train_batch_trajectory_with_sparse_attention_matches_jax_engine(
        tmp_path, monkeypatch):
    """A sparse_attention ds_config section (fixed, unidirectional, block
    16, two local blocks): both engines wire it into attention_impl
    "sparse"; 12 steps agree to the dense trajectory's tolerances."""
    section = {"mode": "fixed", "block": 16, "num_local_blocks": 2,
               "attention": "unidirectional"}
    jeng, teng = _engines("gpt2_wide", tmp_path,
                          cfg=dict(_TRAIN_CFG, sparse_attention=section))
    assert teng.module.cfg.attention_impl == "sparse"
    assert all(b.cfg.attention_impl == "sparse" for b in teng.module.blocks)
    assert dict(teng.module.cfg.sparse_attention)["num_local_blocks"] == 2
    calls = _spy_block_sparse(monkeypatch)
    losses = []
    for step in range(12):
        batch = _batch(8, 64, seed=200 + step % 3)
        jm = jax.device_get(jeng.train_batch(batch))
        tm = teng.train_batch(batch)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        losses.append(tm["loss"])
    assert len(calls) == 12 * 2 * 2           # steps x micro-batches x layers
    assert losses[-1] < losses[0]


def test_sparse_attention_wiring_raises_like_jax():
    _, tcfg = _cfgs("gpt2_wide")
    cfg = {"train_batch_size": 8}
    with pytest.raises(ValueError, match="unknown sparse attention mode"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), device="cpu",
            config=dict(cfg, sparse_attention={"mode": "nope"}))
    with pytest.raises(ValueError, match="TransformerConfig"):
        deepspeed_tpu_torch.initialize(
            model=_TLin(np.ones((6, 4), np.float32)), device="cpu",
            config=dict(cfg, sparse_attention={"mode": "fixed"}))
    _, flash = _cfgs("gpt2_wide", attention_impl="flash")
    with pytest.raises(ValueError, match="conflicts"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(flash), device="cpu",
            config=dict(cfg, sparse_attention={"mode": "fixed"}))
    with pytest.raises(ValueError, match="sequence_parallel.mode"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), device="cpu",
            config=dict(cfg, sequence_parallel={"mode": "nope"}))
    # mixed per-layer windows: each layer routes its own static window
    _, mixed = _cfgs("gpt2_wide", layer_windows=(4, 0))
    module = ttr.Transformer(mixed)
    assert [b.cfg.layer_windows for b in module.blocks] == [(4, 0)] * 2
    with torch.no_grad():
        assert torch.isfinite(module(torch.zeros(1, 8, dtype=torch.long))
                              ).all()


def test_forward_backward_step_equals_train_batch(tmp_path):
    _, tcfg = _cfgs("llama", fused_loss=True, loss_chunk=8)
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(_TRAIN_CFG))
    engs = [deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=str(path),
        model_parameters=_params("llama"), device="cpu")[0]
        for _ in range(2)]
    for step in range(3):
        batch = _batch(8, 16, seed=step)
        m0 = engs[0].train_batch(batch)
        for i in range(2):
            micro = {k: v[4 * i:4 * i + 4] for k, v in batch.items()}
            assert engs[1].step() is None or i == 0
            engs[1].forward(micro)
            engs[1].backward()
            assert engs[1].is_gradient_accumulation_boundary() == (i == 1)
        m1 = engs[1].step()
        assert m0 == m1
    for a, b in zip(engs[0].module.parameters(), engs[1].module.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="before"):
        engs[1].backward()
    engs[1].eval()
    assert torch.isfinite(engs[1](_batch(4, 16, seed=9)))
    out = engs[0].eval_batch(_batch(4, 16, seed=9))
    assert torch.isfinite(out)


class _JLin(jnn.Module):
    @jnn.compact
    def __call__(self, batch, train=False):
        y = jnn.Dense(4, use_bias=False)(batch["x"])
        return jnp.mean(y * y)


class _TLin(torch.nn.Module):
    def __init__(self, kernel):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.from_numpy(kernel))

    def forward(self, batch):
        y = batch["x"].float() @ self.kernel.float()
        return (y * y).mean()


def test_fp16_overflow_step_is_skipped_like_jax(tmp_path):
    cfg = {"train_batch_size": 4,
           "fp16": {"enabled": True, "initial_scale_power": 8,
                    "hysteresis": 1},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 3,
                                    "warmup_max_lr": 1e-2}}}
    kernel = np.random.default_rng(0).standard_normal((6, 4)).astype(
        np.float32)
    jeng, *_ = deepspeed_tpu.initialize(
        model=_JLin(), config=cfg,
        model_parameters={"Dense_0": {"kernel": kernel}},
        mesh_manager=MeshManager(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(model=_TLin(kernel), config=cfg,
                                              device="cpu")
    assert teng.module.kernel.dtype == torch.float16
    bad = {"x": np.full((4, 6), 1e30, np.float32)}
    jm = jax.device_get(jeng.train_batch(bad))
    tm = teng.train_batch(bad)
    assert tm["overflow"] is True and bool(jm["overflow"]) is True
    assert tm["loss_scale"] == float(jm["loss_scale"]) == 256.0
    assert teng.get_loss_scale() == jeng.get_loss_scale() == 128.0
    assert teng.skipped_steps == jeng.skipped_steps == 1
    assert teng.step_count == int(jeng.state.step) == 0
    assert tm["nonfinite_streak"] == int(jm["nonfinite_streak"]) == 1
    np.testing.assert_array_equal(teng.master[0].numpy(), kernel)
    good = {"x": np.random.default_rng(1).standard_normal((4, 6)).astype(
        np.float32)}
    jm = jax.device_get(jeng.train_batch(good))
    tm = teng.train_batch(good)
    assert tm["overflow"] is False and teng.step_count == 1
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=2e-3)
    np.testing.assert_allclose(
        teng.master[0].numpy(),
        np.asarray(jeng.state.master["Dense_0"]["kernel"]), rtol=1e-3,
        atol=1e-5)


def test_initialize_dataloader_and_config_arguments(tmp_path):
    _, tcfg = _cfgs("gpt2")
    data = [{"input_ids": np.arange(16, dtype=np.int32) % 64}
            for _ in range(20)]
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(_TRAIN_CFG))
    import argparse
    args = deepspeed_tpu_torch.add_config_arguments(
        argparse.ArgumentParser()).parse_args(
            ["--deepspeed", "--deepspeed_config", str(path)])
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        args=args, model=ttr.Transformer(tcfg), training_data=data,
        loss_fn=ttr.causal_lm_loss, device="cpu")
    batch = next(iter(loader))
    assert batch["input_ids"].shape == (8, 16) and len(loader) == 3
    assert deepspeed_tpu_torch.default_inference_config() == \
        deepspeed_tpu.default_inference_config()
    assert np.isfinite(eng.train_batch(batch)["loss"])


@pytest.mark.parametrize("section", [
    {"zero_optimization": {"stage": 2,
                           "offload_optimizer": {"device": "cpu"}}},
    # comm_plan, eigenvalue, ZeRO's quantized weights and compression
    # training are ported (test_ported_sections_initialize); amp is not
    {"amp": {"enabled": True}},
    # the integrity sentinel, the watchdog and the straggler detector are
    # ported (tests/test_torch_sentinel.py); the flops profiler is not
    {"flops_profiler": {"enabled": True}},
    {"progressive_layer_drop": {"enabled": True}},
    {"curriculum_learning": {"enabled": True}},
    {"wandb": {"enabled": True}},
    # moe is ported (tests/test_torch_moe.py); data efficiency is not
    {"data_efficiency": {"enabled": True}},
    # sequence parallelism is ported (tests/test_torch_sequence_parallel.py)
    {"autotuning": {"enabled": True}},
    # tensor parallelism is ported (tests/test_torch_tensor_parallel.py),
    # together with sequence parallelism too (tests/test_torch_tp_compose_
    # dist.py); NVMe parameter offload is not
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
    {"pipeline": {"stages": 2}},
    {"activation_checkpointing": {"cpu_checkpointing": True}},
    {"sparse_gradients": True},
    {"tensorboard": {"enabled": True}},
])
def test_unported_sections_raise(section):
    _, tcfg = _cfgs("gpt2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg),
            config={"train_batch_size": 8, **section}, device="cpu")


@pytest.mark.parametrize("section", [
    {"comm_plan": {"enabled": True}},
    {"eigenvalue": {"enabled": True}},
    {"zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
    {"compression_training": {"weight_quantization": {
        "shared_parameters": {"enabled": True}}}},
])
def test_ported_sections_initialize(section):
    """The sections this test file's refusal list once held: each
    initializes (their parity tests: tests/test_torch_{comm_plan,
    compression_training,comm_quantized_dist}.py)."""
    _, tcfg = _cfgs("gpt2")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), device="cpu",
        loss_fn=ttr.causal_lm_loss,
        config={"train_batch_size": 8,
                "optimizer": {"type": "SGD", "params": {"lr": 0.1}},
                **section})
    m = eng.train_batch(_batch(8, 16, seed=1))
    assert np.isfinite(m["loss"])


def test_checkpoint_and_onebit_raise():
    _, tcfg = _cfgs("gpt2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg), device="cpu",
            config={"train_batch_size": 8,
                    "optimizer": {"type": "OneBitAdam",
                                  "params": {"lr": 1e-3}}})


def test_inference_forward_matches_jax():
    """The bf16/f32 InferenceEngine.forward applies the Transformer module,
    as the JAX engine applies its flax model: logits to atol 1e-5."""
    jp = _params("llama")
    jcfg, tcfg = _cfgs("llama")
    ids = _batch(2, 12, seed=6)["input_ids"]
    jeng = JInferenceEngine(jtr.Transformer(jcfg), {"dtype": "float32"},
                            model_parameters=jp)
    teng = deepspeed_tpu_torch.init_inference(
        tcfg, {"dtype": "float32"}, model_parameters=params_from_jax(jp),
        device="cpu")
    np.testing.assert_allclose(teng.forward({"input_ids": ids}).numpy(),
                               np.asarray(jeng.forward({"input_ids": ids})),
                               atol=1e-5, rtol=0)
