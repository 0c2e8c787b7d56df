"""Mixture of experts through the pipeline, in one process: the MoE
routers' aux scalar riding the port's stage interpreter against the JAX
package's pipelined model (``deepspeed_tpu/models/pipeline.py``,
``runtime/pipe/{one_f_one_b,mpmd/executor}.py``) and the port's plain
``Transformer``.

* **Executor** on toy tanh stages with an aux side channel: loss, aux and
  grads against JAX's SPMD 1F1B ``with_aux`` and autograd; every
  (schedule, backward) pair bitwise equal.
* **Model** at pp 2 (4 layers, hidden 64, 4 experts; a GELU top-1 and a
  SwiGLU top-2 Mixtral-style config) from one flax-initialized tree
  (``params_from_jax``): loss, aux and every leaf's grad under gpipe,
  1F1B, store and recompute bitwise equal to each other, within 1e-5 of
  the plain ``Transformer`` per micro-batch under ``make_moe_loss`` (JAX
  ``tests/test_mpmd.py::test_mpmd_model_moe_aux_matches_plain_autodiff``'s
  oracle) and 2e-4 of JAX's ``train_value_and_grad`` and
  ``mpmd_value_and_grad`` (``tests/test_pipeline.py::
  test_1f1b_moe_matches_autodiff``).
* **Engine**: ``initialize(...).train_batch()`` with ``make_moe_loss``
  under every (schedule, backward) pair against the plain engine, the
  loss falling, ``eval_batch`` giving ``(logits, aux)`` with aux > 0
  (``test_moe_pipeline_composition``); an unmarked custom loss raising
  JAX's ``ValueError`` (``test_1f1b_moe_requires_marked_loss``); the
  pipelined ``tp_rules()`` equal to JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.models.pipeline import \
    build_pipelined_model as jbuild_pipelined
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.pipe.one_f_one_b import \
    pipeline_1f1b_value_and_grad as j1f1b

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.pipeline import PipelinedTransformer
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.runtime.pipe.mpmd import mpmd_value_and_grad
from deepspeed_tpu_torch.runtime.pipe.one_f_one_b import \
    pipeline_1f1b_value_and_grad


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


# ----------------------------------------------------------------- executor


def _toy(pp=4, n_micro=6, mb=2, H=8):
    rng = np.random.RandomState(1)
    sp = {"w": rng.randn(pp, H, H) * 0.3, "b": rng.randn(pp, H) * 0.1,
          "a": rng.randn(pp, H) * 0.5}
    head = {"v": rng.randn(H) * 0.5}
    return sp, head, rng.randn(n_micro, mb, H), rng.randn(n_micro, mb)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(tree, dtype=torch.float32)


def _toy_stage(p, x, extra, stage):
    y = torch.tanh(x @ p["w"] + p["b"])
    return y, torch.mean((y @ p["a"]) ** 2)


def _toy_loss(h, y, lab):
    return torch.mean((y @ h["v"] - lab) ** 2)


def test_executor_aux_matches_jax_1f1b_and_autograd():
    """Each stage's aux, summed over stages and averaged over micro-
    batches, with the constant cotangent ``aux_cotangent`` into every
    stage's backward: JAX's SPMD 1F1B ``with_aux`` and autograd of
    loss + w x aux; all four (schedule, backward) pairs bitwise equal."""
    pp, w = 4, 0.3
    sp, head, micros, labels = _toy(pp)
    loss, aux, gs, gh, gm = pipeline_1f1b_value_and_grad(
        _toy_stage, _toy_loss, _t(sp), _t(head), _t(micros), _t(labels),
        pp=pp, with_aux=True, aux_cotangent=w)
    p, h, m = _t(sp), _t(head), _t(micros)
    for t in (*p.values(), *h.values(), m):
        t.requires_grad_(True)
    ls, auxes = [], []
    for i in range(micros.shape[0]):
        x, a = m[i], 0.0
        for s in range(pp):
            x, ai = _toy_stage({k: v[s] for k, v in p.items()}, x, {}, s)
            a = a + ai
        ls.append(_toy_loss(h, x, _t(labels)[i]))
        auxes.append(a)
    ref_aux = torch.stack(auxes).mean()
    (torch.stack(ls).mean() + w * ref_aux).backward()
    np.testing.assert_allclose(float(aux), ref_aux.item(), rtol=1e-5)
    np.testing.assert_allclose(float(loss), torch.stack(ls).mean().item(),
                               rtol=1e-5)
    for k in ("w", "b", "a"):
        np.testing.assert_allclose(gs[k].numpy(), p[k].grad.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(gm.numpy(), m.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:pp]).reshape(pp), ("pipe",))

    def jstage(p, x, extra, stage):
        y = jnp.tanh(x @ p["w"] + p["b"])
        return y, jnp.mean((y @ p["a"]) ** 2)

    def jloss(h, y, lab):
        return jnp.mean((y @ h["v"] - lab) ** 2)
    f = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                  tree)
    jl, jaux, jgs, jgh, jgm = jax.jit(lambda a, b, c, d: j1f1b(
        jstage, jloss, a, b, c, d, mesh=mesh, pp=pp, with_aux=True,
        aux_cotangent=w))(f(sp), f(head), f(micros), f(labels))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("w", "b", "a"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(jgs[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(gh["v"].numpy(), np.asarray(jgh["v"]),
                               rtol=1e-4, atol=1e-6)
    outs = {(sched, bw): mpmd_value_and_grad(
        _toy_stage, lambda h, y, lab, ctx: _toy_loss(h, y, lab), _t(sp),
        _t(head), _t(micros), _t(labels), pp=pp, schedule=sched,
        backward=bw, with_aux=True, aux_cotangent=w)
        for sched in ("gpipe", "1f1b") for bw in ("recompute", "store")}
    for key, out in outs.items():
        assert torch.equal(out[0], loss) and torch.equal(out[1], aux), key
        for k in ("w", "b", "a"):
            assert torch.equal(out[2][k], gs[k]), (key, k)
        assert torch.equal(out[4], gm), key


# -------------------------------------------------------------------- model


BASE = dict(hidden_size=64, num_layers=4, num_heads=4, vocab_size=256,
            max_seq_len=64, moe_experts=4, moe_capacity_factor=2.0)
ARCHS = {
    "gpt2": dict(BASE),
    "mixtral": dict(BASE, num_kv_heads=2, norm="rmsnorm", gated_mlp=True,
                    activation="silu", use_bias=False, pos_embed="rotary",
                    rotary_interleaved=False, tie_embeddings=False,
                    moe_k=2),
}
S, TB, GAS = 16, 8, 4


def _cfgs(arch, **over):
    jcfg = jtr.get_config("gpt2-tiny", **dict(
        ARCHS[arch], dtype=jnp.float32, attention_impl="reference", **over))
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f.update(dtype=torch.float32, attention_impl="auto")
    return jcfg, ttr.TransformerConfig(**f)


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        p = jax.jit(jtr.Transformer(jcfg).init)(
            jax.random.PRNGKey(7), {"input_ids": np.zeros((1, 8), np.int32)}
        )["params"]
        _PARAMS[arch] = jax.tree.map(np.asarray, jax.device_get(p))
    return _PARAMS[arch]


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, 256, (TB, S))
    return {"input_ids": ids.astype(np.int32)}


def _micros(batch):
    return {k: torch.as_tensor(v).reshape((GAS, -1) + v.shape[1:])
            for k, v in batch.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_leaf(flat, name):
    parts = name.split(".")
    if parts[0] == "blocks":
        return flat["blocks/" + "/".join(parts[2:])][int(parts[1])]
    return flat["/".join(parts)]


def _plain_per_micro(arch, batch):
    """The JAX oracle's objective on the plain ``Transformer``: each
    micro-batch's make_moe_loss, averaged (the aux is nonlinear in the
    batch's composition, so a whole-batch aux differs)."""
    _, tcfg = _cfgs(arch)
    plain = ttr.Transformer(tcfg, params_from_jax(_params(arch)))
    moe_loss = ttr.make_moe_loss(tcfg.moe_aux_weight)
    ids = torch.as_tensor(batch["input_ids"]).reshape(GAS, -1, S)
    losses, auxes = [], []
    for i in range(GAS):
        mb = {"input_ids": ids[i]}
        logits, aux = plain(mb)
        losses.append(moe_loss((logits, aux), mb))
        auxes.append(aux)
    loss = torch.stack(losses).mean()
    loss.backward()
    return (loss.detach(), torch.stack(auxes).mean().detach(),
            {n: p.grad for n, p in plain.named_parameters()})


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_pipeline_matches_plain_and_jax(arch):
    _, tcfg = _cfgs(arch)
    batch = _batch(5)
    got = {}
    for bw in ("recompute", "store"):
        piped = PipelinedTransformer(tcfg, 2, GAS, backward=bw,
                                     params=params_from_jax(_params(arch)))
        for sched in ("gpipe", "1f1b"):
            loss, grads = piped.pipeline_value_and_grad(_micros(batch),
                                                        schedule=sched)
            got[sched, bw] = (loss, piped.last_aux, grads)
    base = got["1f1b", "recompute"]
    for key, (loss, aux, grads) in got.items():
        assert torch.equal(loss, base[0]) and torch.equal(aux, base[1]), key
        for n, g in base[2].items():
            assert torch.equal(grads[n], g), (key, n)
    loss, aux, grads = base
    assert float(aux) > 0
    ref_loss, ref_aux, ref = _plain_per_micro(arch, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    for n, g in ref.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    # JAX's pipelined model: 1F1B (both configs) and the mpmd placement
    jcfg, _ = _cfgs(arch)
    jpiped, _ = jbuild_pipelined(jcfg, pp=2, n_micro=GAS)
    config = {"train_batch_size": TB, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": GAS,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "pipeline": {"stages": 2, "schedule": "1f1b"}}
    mm = jmesh.MeshManager(devices=jax.devices()[:2], pp_size=2)
    jeng, *_ = jds.initialize(
        model=jpiped, config=config, model_parameters=_params(arch),
        loss_fn=jtr.make_moe_loss(jcfg.moe_aux_weight), example_batch=batch,
        mesh_manager=mm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jeng.mesh:
        runs = [jax.jit(lambda p, b: jpiped.train_value_and_grad(
            p, b, mesh=jeng.mesh))(jeng.state.params, jb)]
    if arch == "gpt2":
        runs.append(jpiped.mpmd_value_and_grad(jeng.state.params, jb,
                                               mesh=jeng.mesh))
    for jl, jg in runs:
        np.testing.assert_allclose(float(loss), float(jl), rtol=2e-4)
        flat = _flat(jax.device_get(jg))
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), _jax_leaf(flat, n),
                                       rtol=2e-4, atol=2e-5, err_msg=n)


_ENGINE_CFG = {"train_batch_size": TB, "train_micro_batch_size_per_gpu": 2,
               "gradient_accumulation_steps": GAS,
               "optimizer": {"type": "AdamW", "params": {"lr": 2e-3}},
               "gradient_clipping": 1.0, "steps_per_print": 100}


def test_engine_trains_moe_through_every_schedule_and_backward():
    """``initialize(...).train_batch()`` with ``make_moe_loss`` under
    gpipe and 1F1B, recompute and store: three steps within 1e-5 of the
    plain engine (every target valid: the global token mean is the
    per-micro mean), the metrics' aux too; the loss falls; ``eval_batch``
    returns (logits, aux) with aux > 0."""
    _, tcfg = _cfgs("gpt2")
    moe_loss = ttr.make_moe_loss(tcfg.moe_aux_weight)
    plain, *_ = tds.initialize(
        model=ttr.Transformer(tcfg), config=_ENGINE_CFG,
        model_parameters=_params("gpt2"), loss_fn=moe_loss, device="cpu",
        dist_init_required=False)
    seeds = (20, 21, 20, 20)
    ref = [plain.train_batch(_batch(s)) for s in seeds]
    assert ref[-1]["loss"] < ref[0]["loss"]
    for sched in ("gpipe", "1f1b"):
        for bw in ("recompute", "store"):
            eng, *_ = tds.initialize(
                model=PipelinedTransformer(tcfg, 2, GAS, backward=bw),
                config=dict(_ENGINE_CFG, pipeline={"schedule": sched}),
                model_parameters=_params("gpt2"), loss_fn=moe_loss,
                device="cpu", dist_init_required=False)
            for s, want in zip(seeds, ref):
                m = eng.train_batch(_batch(s))
                np.testing.assert_allclose(
                    [m["loss"], m["grad_norm"], m["aux"]],
                    [want["loss"], want["grad_norm"], want["aux"]],
                    rtol=1e-5, err_msg=f"{sched}/{bw}")
    logits, aux = eng.eval_batch(_batch(1))
    assert logits.shape == (TB, S, 256) and float(aux) > 0


def test_moe_pipeline_requires_a_marked_loss():
    """A raw custom loss on a MoE pipeline under 1F1B or the mpmd
    placement raises JAX's ``ValueError``; ``make_moe_loss(w,
    base_loss=...)`` of a custom base trains (its base gets bare
    logits), and so does ``causal_lm_loss`` (the config's aux weight)."""
    _, tcfg = _cfgs("gpt2")

    def raw_loss(out, b):           # written against (logits, aux)
        logits, aux = out
        return ttr.causal_lm_loss(logits, b) + 0.01 * aux

    for pipe in ({"schedule": "1f1b"}, {"schedule": "gpipe",
                                        "placement": "mpmd"}):
        with pytest.raises(ValueError, match="make_moe_loss"):
            tds.initialize(model=PipelinedTransformer(tcfg, 2, GAS),
                           config=dict(_ENGINE_CFG, pipeline=pipe),
                           loss_fn=raw_loss, device="cpu",
                           dist_init_required=False)

    def base(logits, b):
        return ttr.causal_lm_loss(logits, b)

    for loss_fn in (ttr.make_moe_loss(0.01, base_loss=base),
                    ttr.causal_lm_loss):
        eng, *_ = tds.initialize(
            model=PipelinedTransformer(tcfg, 2, GAS, seed=2),
            config=dict(_ENGINE_CFG, pipeline={"schedule": "1f1b"}),
            loss_fn=loss_fn, device="cpu", dist_init_required=False)
        losses = [eng.train_batch(_batch(9))["loss"] for _ in range(4)]
        assert losses[-1] < losses[0], losses


def test_pipelined_tp_rules_equal_jax():
    jcfg, tcfg = _cfgs("mixtral")
    jpiped, _ = jbuild_pipelined(jcfg, pp=2, n_micro=GAS)
    want = jpiped.tp_rules()
    got = PipelinedTransformer(tcfg, 2, GAS).tp_rules()
    assert list(got) == list(want)
    for k, spec in want.items():
        assert tuple(got[k]) == tuple(spec), k
