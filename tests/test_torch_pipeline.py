"""Pipeline parallelism in one process: the port's schedules, channel,
stage interpreter and ``PipelinedTransformer`` against the JAX package
(``deepspeed_tpu/runtime/pipe``, ``models/pipeline.py``) and the port's
plain ``Transformer``.

* **Schedules**: the clock tables, every stage's instruction stream, the
  generator schedules, the partitioners, ``PipelineModule`` and
  ``bubble_fraction`` equal JAX's over pp 1-8 x n_micro 1-16.
* **Channel**: ``LocalChannel``'s FIFO, its raise on a schedule violation
  and the ``pipe.xfer`` failpoint (JAX ``tests/test_mpmd.py:138``).
* **Executor** on the toy tanh stages (JAX ``tests/test_pipeline.py:188``):
  loss and grads against autograd and JAX's ``pipeline_1f1b_value_and_
  grad`` at pp 4; store == recompute and gpipe == 1F1B bitwise; fp16 loss
  scaling.
* **Model** at pp 2, gpt2-style and llama-style (rotary, RMSNorm, untied
  head, ``embed_scale``, GQA; JAX ``tests/test_pipeline.py:614``): loss and
  grads within 1e-5 of the plain ``Transformer`` and 2e-4 of JAX's
  ``train_value_and_grad``, logits against JAX's ``apply``; masked
  batches, dropout masks equal under gpipe and 1F1B (and the plain
  model's for the same seeds), a custom ``loss_fn``, fp16 scaling
  through the engine; the refusals.
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
from deepspeed_tpu.runtime.pipe import module as jmodule
from deepspeed_tpu.runtime.pipe import schedule as jsched
from deepspeed_tpu.runtime.pipe.one_f_one_b import \
    pipeline_1f1b_value_and_grad as j1f1b

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.pipeline import (PipelinedTransformer,
                                                 build_pipelined_model)
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.runtime.pipe import module as tmodule
from deepspeed_tpu_torch.runtime.pipe import schedule as tsched
from deepspeed_tpu_torch.runtime.pipe.mpmd import (ChannelTimeout,
                                                   LocalChannel,
                                                   mpmd_value_and_grad)
from deepspeed_tpu_torch.runtime.pipe.one_f_one_b import \
    pipeline_1f1b_value_and_grad
from deepspeed_tpu_torch.runtime.pipe.spmd import (pipeline_apply,
                                                   stack_stage_params,
                                                   unstack_stage_params)


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


# ---------------------------------------------------------------- schedules


def _stream(streams):
    return [[[type(i).__name__, i.kwargs] for i in tick] for tick in streams]


@pytest.mark.parametrize("n_micro", range(1, 17))
@pytest.mark.parametrize("pp", range(1, 9))
def test_schedules_and_partitions_match_jax(pp, n_micro):
    for name in ("1f1b", "gpipe"):
        jt = jsched.build_tables(name, n_micro, pp)
        tt = tsched.build_tables(name, n_micro, pp)
        assert sorted(jt) == sorted(tt)
        for k in ("fwd", "bwd", "recv_f", "recv_b"):
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
        assert int(tt["ticks"]) == int(jt["ticks"])
        for s in range(pp):
            assert _stream(tsched.stage_instruction_stream(tt, s)) == \
                _stream(jsched.stage_instruction_stream(jt, s))
    for s in range(pp):
        for cls in ("TrainSchedule", "InferenceSchedule",
                    "DataParallelSchedule"):
            a = getattr(tsched, cls)(micro_batches=n_micro, stages=pp,
                                     stage_id=s)
            b = getattr(jsched, cls)(micro_batches=n_micro, stages=pp,
                                     stage_id=s)
            assert _stream(list(a)) == _stream(list(b))
            assert a.num_pipe_buffers() == b.num_pipe_buffers()
    assert tsched.bubble_fraction(n_micro, pp) == \
        jsched.bubble_fraction(n_micro, pp)
    L = n_micro + pp
    assert tmodule.partition_uniform(L, pp) == \
        jmodule.partition_uniform(L, pp)
    w = np.random.default_rng(pp * 17 + n_micro).random(L) * 10
    assert tmodule.partition_balanced(list(w), pp) == \
        jmodule.partition_balanced(list(w), pp)

    class Dense:
        pass

    class Norm:
        pass
    kinds = [Dense if i % 3 else Norm for i in range(L)]
    for method in ("uniform", "parameters", "type:dense"):
        tm = tmodule.PipelineModule(
            [tmodule.LayerSpec(k) for k in kinds], pp,
            partition_method=method, param_counts=list(w))
        jm = jmodule.PipelineModule(
            [jmodule.LayerSpec(k) for k in kinds], pp,
            partition_method=method, param_counts=list(w))
        assert tm.parts == jm.parts
        assert [tm.stage_of_layer(i) for i in range(L)] == \
            [jm.stage_of_layer(i) for i in range(L)]
        assert tm.homogeneous_span() == jm.homogeneous_span()


# ------------------------------------------------------------------ channel


def test_local_channel_fifo_and_schedule_violation():
    ch = LocalChannel()
    ch.send("act", 0, 1, 0, "a0")
    ch.send("act", 0, 1, 1, "a1")
    assert ch.pending("act", 1) == 2
    assert ch.recv("act", 1, 0) == "a0"
    with pytest.raises(RuntimeError, match="schedule violation"):
        ch.recv("act", 1, 2)                  # expected micro 2, queued 1
    ch.clear()
    with pytest.raises(ChannelTimeout):
        ch.recv("act", 1, 0)
    # a payload moves to its receiver's device
    ch = LocalChannel(placements={1: torch.device("cpu")})
    ch.send("grad", 2, 1, 0, torch.ones(2, dtype=torch.float64))
    assert ch.recv("grad", 1, 0).device.type == "cpu"


def test_local_channel_xfer_failpoint():
    from deepspeed_tpu_torch.testing import chaos
    chaos.reset_for_tests()
    try:
        ch = LocalChannel()
        chaos.arm("pipe.xfer", "raise", match="act:0->1")
        with pytest.raises(IOError):
            ch.send("act", 0, 1, 0, "x")
        # keyed: the grad edge is untouched
        ch.send("grad", 1, 0, 0, "g")
        assert ch.recv("grad", 0, 0) == "g"
        assert chaos.fired("pipe.xfer") == ["pipe.xfer"]
    finally:
        chaos.reset_for_tests()


# ----------------------------------------------------------------- executor


def _toy(pp=4, n_micro=6, mb=2, H=8):
    rng = np.random.RandomState(0)
    sp = {"w": rng.randn(pp, H, H) * 0.3, "b": rng.randn(pp, H) * 0.1}
    head = {"v": rng.randn(H) * 0.5}
    micros = rng.randn(n_micro, mb, H)
    labels = rng.randn(n_micro, mb)
    return sp, head, micros, labels


def _t(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _t(v, dtype) for k, v in tree.items()}
    return torch.tensor(tree, dtype=dtype)


def _toy_stage(p, x, extra, stage):
    return torch.tanh(x @ p["w"] + p["b"])


def _toy_loss(h, y, lab):
    return torch.mean((y @ h["v"] - lab) ** 2)


def test_executor_matches_autograd_and_jax_1f1b():
    """The toy tanh stages at pp 4: the port's 1F1B loss and grads against
    autograd of the stacked stages and JAX's SPMD 1F1B executor."""
    pp = 4
    sp, head, micros, labels = _toy(pp)
    loss, _, gs, gh, gm = pipeline_1f1b_value_and_grad(
        _toy_stage, _toy_loss, _t(sp), _t(head), _t(micros), _t(labels),
        pp=pp)
    # autograd of the stacked stages, the mean over micro-batches
    p, h, m = _t(sp), _t(head), _t(micros)
    for t in (*p.values(), *h.values(), m):
        t.requires_grad_(True)
    ls = []
    for i in range(micros.shape[0]):
        x = m[i]
        for s in range(pp):
            x = _toy_stage({k: v[s] for k, v in p.items()}, x, {}, s)
        ls.append(_toy_loss(h, x, _t(labels)[i]))
    ref = torch.stack(ls).mean()
    ref.backward()
    np.testing.assert_allclose(float(loss), ref.item(), rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(gs[k].numpy(), p[k].grad.numpy(),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gh["v"].numpy(), h["v"].grad.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gm.numpy(), m.grad.numpy(), rtol=1e-4,
                               atol=1e-5)
    # JAX's SPMD 1F1B on a pipe mesh of 4 CPU devices
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:pp]).reshape(pp), ("pipe",))

    def jstage(p, x, extra, stage):
        return jnp.tanh(x @ p["w"] + p["b"])

    def jloss(h, y, lab):
        return jnp.mean((y @ h["v"] - lab) ** 2)
    f = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                  tree)
    jl, _, jgs, jgh, jgm = jax.jit(lambda a, b, c, d: j1f1b(
        jstage, jloss, a, b, c, d, mesh=mesh, pp=pp))(
        f(sp), f(head), f(micros), f(labels))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(jgs[k]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gh["v"].numpy(), np.asarray(jgh["v"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_store_recompute_gpipe_1f1b_bitwise_and_loss_scale(dtype):
    """Every (schedule, backward) pair gives the same bits: the grads
    accumulate in micro order on every stage in all four; a loss scale
    multiplies the grads and not the loss."""
    pp = 4
    sp, head, micros, labels = _toy(pp, n_micro=7)
    outs = {}
    for sched in ("gpipe", "1f1b"):
        for bw in ("recompute", "store"):
            outs[sched, bw] = mpmd_value_and_grad(
                _toy_stage, lambda h, y, lab, ctx: _toy_loss(h, y, lab),
                _t(sp, dtype), _t(head, dtype), _t(micros, dtype),
                _t(labels, dtype), pp=pp, schedule=sched, backward=bw)
    base = outs["1f1b", "recompute"]
    for key, out in outs.items():
        assert torch.equal(out[0], base[0]), key
        for k in ("w", "b"):
            assert torch.equal(out[2][k], base[2][k]), key
        assert torch.equal(out[3]["v"], base[3]["v"]), key
        assert torch.equal(out[4], base[4]), key
    scaled = mpmd_value_and_grad(
        _toy_stage, lambda h, y, lab, ctx: _toy_loss(h, y, lab),
        _t(sp, dtype), _t(head, dtype), _t(micros, dtype),
        _t(labels, dtype), pp=pp, loss_scale=256.0)
    assert torch.equal(scaled[0], base[0])
    for k in ("w", "b"):
        torch.testing.assert_close(scaled[2][k] / 256.0, base[2][k],
                                   rtol=1e-2 if dtype != torch.float32
                                   else 1e-6, atol=1e-6)


def test_pipeline_apply_and_stage_stacking():
    pp = 4
    sp, head, micros, labels = _toy(pp)
    out = pipeline_apply(_toy_stage, _t(sp), _t(micros), pp=pp)
    x = _t(micros)
    for s in range(pp):
        x = _toy_stage({k: v[s] for k, v in _t(sp).items()}, x, {}, s)
    torch.testing.assert_close(out, x, rtol=0, atol=0)
    tree = {"a": np.arange(24.0).reshape(8, 3), "b": {"c": np.ones((8,))}}
    st = stack_stage_params(tree, 4)
    assert st["a"].shape == (4, 2, 3) and st["b"]["c"].shape == (4, 2)
    back = unstack_stage_params(st)
    np.testing.assert_array_equal(back["a"], tree["a"])
    with pytest.raises(ValueError, match="not divisible"):
        stack_stage_params(tree, 3)


# -------------------------------------------------------------------- model


BASE = dict(hidden_size=64, num_layers=4, num_heads=4, vocab_size=256,
            max_seq_len=64)
ARCHS = {
    "gpt2": dict(BASE),
    "llama": dict(BASE, num_kv_heads=2, norm="rmsnorm", gated_mlp=True,
                  activation="silu", use_bias=False, pos_embed="rotary",
                  rotary_interleaved=False, tie_embeddings=False,
                  embed_scale=8.0),
}
S = 16


def _cfgs(arch, fp16=False, **over):
    jcfg = jtr.get_config("gpt2-tiny", **dict(
        ARCHS[arch], dtype=jnp.float16 if fp16 else jnp.float32,
        attention_impl="reference", **over))
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f.update(dtype=torch.float16 if fp16 else torch.float32,
             attention_impl="auto")
    return jcfg, ttr.TransformerConfig(**f)


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        p = jax.jit(jtr.Transformer(jcfg).init)(
            jax.random.PRNGKey(5), {"input_ids": np.zeros((1, 8), np.int32)}
        )["params"]
        _PARAMS[arch] = jax.tree.map(np.asarray, jax.device_get(p))
    return _PARAMS[arch]


def _batch(seed, B=8, masked=False, uneven=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, S)).astype(np.int32)
    b = {"input_ids": ids}
    if masked:
        mask = np.ones((B, S), np.int32)
        for i in range(B):
            pad = int(rng.integers(0, S // 3))
            if pad:
                mask[i, -pad:] = 0
        b["attention_mask"] = mask
        b["labels"] = np.where(mask > 0, ids, -100).astype(np.int32)
    if uneven:
        lab = ids.copy()
        lab[: B // 2, 3:] = -100
        b["labels"] = lab.astype(np.int32)
    return b


def _models(arch, pp=2, n_micro=4, **over):
    _, tcfg = _cfgs(arch, **over)
    tree = params_from_jax(_params(arch))
    plain = ttr.Transformer(tcfg, tree)
    piped = PipelinedTransformer(tcfg, pp, n_micro,
                                 params=params_from_jax(_params(arch)))
    return plain, piped, tcfg


def _plain_loss_and_grads(plain, batch):
    plain.zero_grad()
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss = ttr.causal_lm_loss(plain(b), b)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in plain.named_parameters()}


def _micros(batch, n):
    return {k: torch.as_tensor(v).reshape((n, -1) + v.shape[1:])
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_pipelined_model_matches_plain_and_jax(arch):
    plain, piped, tcfg = _models(arch)
    batch = _batch(5)
    ref_loss, ref = _plain_loss_and_grads(plain, batch)
    got = {}
    for sched in ("gpipe", "1f1b"):
        loss, grads = piped.pipeline_value_and_grad(_micros(batch, 4),
                                                    schedule=sched)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        for n, g in ref.items():
            np.testing.assert_allclose(grads[n].numpy(), g.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
        got[sched] = (loss, grads)
    for n in ref:
        assert torch.equal(got["gpipe"][1][n], got["1f1b"][1][n]), n
    # JAX's 1F1B train_value_and_grad on a pipe x data mesh
    jcfg, _ = _cfgs(arch)
    jpiped, _ = jbuild_pipelined(jcfg, pp=2, n_micro=4)
    config = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 4,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "pipeline": {"stages": 2, "schedule": "1f1b"}}
    mm = jmesh.MeshManager(devices=jax.devices()[:2], pp_size=2)
    jeng, *_ = jds.initialize(model=jpiped, config=config,
                              model_parameters=_params(arch),
                              loss_fn=jtr.causal_lm_loss,
                              example_batch=batch, mesh_manager=mm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jeng.mesh:
        jl, jg = jax.jit(lambda p, b: jpiped.train_value_and_grad(
            p, b, mesh=jeng.mesh))(jeng.state.params, jb)
    # the JAX pipelined apply's SPMD scan does not lower on jax 0.9
    # (shard_map out_specs); its plain Transformer is the same function
    jlogits = jtr.Transformer(jcfg).apply({"params": jeng.state.params}, jb)
    np.testing.assert_allclose(float(got["1f1b"][0]), float(jl), rtol=2e-4)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(jax.device_get(jg), "")
    for n, g in got["1f1b"][1].items():
        parts = n.split(".")
        if parts[0] == "blocks":
            want = flat["blocks/" + "/".join(parts[2:])][int(parts[1])]
        else:
            want = flat["/".join(parts)]
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4, atol=2e-5,
                                   err_msg=n)
    logits = piped({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)


def test_masked_batches_match_plain():
    plain, piped, _ = _models("gpt2")
    batch = _batch(6, masked=True)
    ref_loss, ref = _plain_loss_and_grads(plain, batch)
    loss, grads = piped.pipeline_value_and_grad(_micros(batch, 4))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for n, g in ref.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    logits = piped({k: torch.as_tensor(v) for k, v in batch.items()})
    want = plain({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits.numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_dropout_masks_equal_under_gpipe_1f1b_and_the_plain_model():
    """Masks seeded by (micro-batch, global layer): gpipe, 1F1B and the
    plain model given each micro-batch's seed draw the same ones."""
    plain, piped, _ = _models("gpt2", dropout=0.2)
    batch = _batch(7)
    seeds = [ttr.mix_seed(11, i) for i in range(4)]
    outs = {s: piped.pipeline_value_and_grad(_micros(batch, 4), schedule=s,
                                             seeds=seeds)
            for s in ("gpipe", "1f1b")}
    for n in outs["gpipe"][1]:
        assert torch.equal(outs["gpipe"][1][n], outs["1f1b"][1][n]), n
    plain.zero_grad()
    ids = torch.as_tensor(batch["input_ids"]).reshape(4, 2, S)
    ls = []
    for i in range(4):
        out = plain({"input_ids": ids[i]}, train=True, dropout_seed=seeds[i])
        ls.append(ttr.causal_lm_loss(out, {"input_ids": ids[i]}))
    loss = torch.stack(ls).mean()
    loss.backward()
    np.testing.assert_allclose(float(outs["1f1b"][0]), float(loss),
                               rtol=1e-5)
    for n, p in plain.named_parameters():
        np.testing.assert_allclose(outs["1f1b"][1][n].numpy(),
                                   p.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def _smoothed_ce(logits, batch):
    tgt = torch.as_tensor(batch["input_ids"]).long()[:, 1:]
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -lp.gather(-1, tgt[..., None])[..., 0]
    return torch.mean(0.9 * nll - 0.1 * lp.mean(-1))


def test_custom_loss_fn_per_micro_and_whole_batch():
    """A per-token-mean custom loss per micro-batch (1F1B / mpmd) and once
    over the whole batch (spmd gpipe) both equal the plain model's."""
    plain, piped, _ = _models("gpt2")
    batch = _batch(8)
    plain.zero_grad()
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    ref = _smoothed_ce(plain(b), b)
    ref.backward()
    for whole in (False, True):
        loss, grads = piped.pipeline_value_and_grad(
            _micros(batch, 4), loss_fn=_smoothed_ce, batch_loss=whole,
            schedule="gpipe" if whole else "1f1b")
        np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
        for n, p in plain.named_parameters():
            np.testing.assert_allclose(grads[n].numpy(), p.grad.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)


_ENGINE_CFG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
               "gradient_accumulation_steps": 4,
               "optimizer": {"type": "AdamW", "params": {"lr": 2e-3}},
               "gradient_clipping": 1.0, "steps_per_print": 100}


def test_engine_in_one_process_matches_the_plain_engine():
    """``initialize`` picks the PipelineEngine; one process holds both
    stages. Three steps against the plain engine at gas 4 (the global
    token mean equals the per-micro mean when every target counts), and
    the redirected micro-batch API raises."""
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine
    _, tcfg = _cfgs("llama")
    plain, *_ = tds.initialize(
        model=ttr.Transformer(tcfg, seed=3), config=_ENGINE_CFG,
        model_parameters=_params("llama"), loss_fn=ttr.causal_lm_loss,
        device="cpu", dist_init_required=False)
    piped, *_ = tds.initialize(
        model=PipelinedTransformer(tcfg, 2, 4), config=dict(
            _ENGINE_CFG, pipeline={"schedule": "1f1b"}),
        model_parameters=_params("llama"), loss_fn=ttr.causal_lm_loss,
        device="cpu", dist_init_required=False)
    assert isinstance(piped, PipelineEngine)
    for seed in (20, 21, 20):
        a = plain.train_batch(_batch(seed))
        b = piped.train_batch(_batch(seed))
        np.testing.assert_allclose([b["loss"], b["grad_norm"]],
                                   [a["loss"], a["grad_norm"]], rtol=1e-5)
    got = piped.module_state_dict()
    for k, v in plain.module_state_dict().items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for call in (piped.forward, piped.backward, piped.step):
        with pytest.raises(RuntimeError, match="train_batch/eval_batch"):
            call(_batch(1))
    logits = piped.eval_batch(_batch(1))
    assert logits.shape == (8, S, 256)


def test_fp16_loss_scaling_through_the_engine():
    """fp16: the scale seeds every stage's backward, the engine unscales;
    a forced overflow skips the step and halves the scale."""
    _, tcfg = _cfgs("gpt2", fp16=True)
    eng, *_ = tds.initialize(
        model=PipelinedTransformer(tcfg, 2, 4, seed=1), config=dict(
            _ENGINE_CFG, fp16={"enabled": True, "initial_scale_power": 8,
                               "hysteresis": 1},
            pipeline={"schedule": "1f1b"}),
        loss_fn=ttr.causal_lm_loss, device="cpu", dist_init_required=False)
    m = eng.train_batch(_batch(30))
    assert np.isfinite(m["loss"]) and not m["overflow"]
    assert m["loss_scale"] == 256.0
    with torch.no_grad():
        eng.module.blocks["1"].mlp_proj.kernel.fill_(6e4)
    m = eng.train_batch(_batch(31))
    assert m["overflow"] and eng.get_loss_scale() == 128.0


def test_refusals_name_what_they_refuse():
    _, tcfg = _cfgs("gpt2")
    with pytest.raises(ValueError, match="not divisible by pp"):
        PipelinedTransformer(tcfg, 3, 2)
    with pytest.raises(ValueError, match="recompute|store"):
        PipelinedTransformer(tcfg, 2, 2, backward="stash")
    for over, what in ((dict(layer_windows=(8, 8, 8, 8)), "sliding"),
                       (dict(embed_ln=True), "embed_ln"),
                       (dict(token_type_vocab=2), "token_type_vocab"),
                       (dict(mlm_head=True), "mlm_head"),
                       (dict(no_lm_head=True), "no_lm_head"),
                       (dict(fused_loss=True), "fused_loss")):
        with pytest.raises(NotImplementedError, match=what):
            PipelinedTransformer(dataclasses.replace(tcfg, **over), 2, 2)
    # MoE rides the pipe now (tests/test_torch_pipeline_moe.py): the
    # model builds and its forward returns (logits, aux)
    moe = PipelinedTransformer(dataclasses.replace(tcfg, moe_experts=2),
                               2, 4)
    logits, aux = moe(torch.as_tensor(_batch(2)["input_ids"]))
    assert logits.shape == (8, S, 256) and float(aux) > 0
    model = PipelinedTransformer(tcfg, 2, 4)
    for extra, err, what in (
            ({"pipeline": {"schedule": "zigzag"}}, ValueError,
             "unknown pipeline.schedule"),
            ({"pipeline": {"placement": "ring"}}, ValueError,
             "unknown pipeline.placement"),
            ({"sequence_parallel": {"sp_size": 2}}, NotImplementedError,
             "sequence_parallel.*ROADMAP"),
            ({"gradient_accumulation_steps": 2, "train_batch_size": 4},
             ValueError, "n_micro")):
        with pytest.raises(err, match=what):
            tds.initialize(model=model, config=dict(_ENGINE_CFG, **extra),
                           device="cpu", dist_init_required=False)
    # ZeRO stage 3 under a pipeline is ported (one process: the whole
    # state; across ranks, tests/test_torch_pipeline_compose_dist.py)
    eng, *_ = tds.initialize(
        model=model, config=dict(_ENGINE_CFG, zero_optimization={
            "stage": 3}), device="cpu", dist_init_required=False)
    assert eng.zero_optimization_stage() == 3
    assert np.isfinite(eng.train_batch(_batch(3))["loss"])
    store = PipelinedTransformer(tcfg, 2, 4, backward="store")
    with pytest.raises(ValueError, match="backward='recompute'"):
        tds.initialize(model=store, config=dict(
            _ENGINE_CFG, pipeline={"placement": "mpmd"}), device="cpu",
            dist_init_required=False)
    with pytest.raises(NotImplementedError, match="PipelinedTransformer"):
        tds.initialize(model=ttr.Transformer(tcfg), config=dict(
            _ENGINE_CFG, pipeline={"stages": 2}), device="cpu",
            dist_init_required=False)
    # the MPMD stage worker, its driver and the socket channel are not
    # ported (ROADMAP item 4.3)
    from deepspeed_tpu_torch.runtime.pipe import mpmd
    for name in ("MPMDStageSupervisor", "StageWorkerSpec", "SocketChannel"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md item 4.3"):
            getattr(mpmd, name)
    # pipe with model or expert composes; with seq it raises
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmesh.MeshManager(devices=range(4), pp_size=2, sp_size=2)
    for kw in (dict(tp_size=2), dict(ep_size=2), {}):
        mm = tmesh.MeshManager(devices=range(4), pp_size=2, **kw)
        assert mm.shape["pipe"] == 2 and mm.axes_size(
            ("data", "expert", "model")) == 2


def test_seeded_stage_params_build_the_plain_models_values():
    """``seeded_params``: a stage's layers from per-layer seeds equal the
    same layers of the whole model built from the same call."""
    from deepspeed_tpu_torch.models.pipeline import seeded_params
    _, tcfg = _cfgs("llama")
    whole = ttr.Transformer(tcfg, seeded_params(tcfg, 9))
    stage1 = PipelinedTransformer(tcfg, 2, 4, stage=1,
                                  params=seeded_params(tcfg, 9, [2, 3]))
    got = dict(stage1.named_parameters())
    for n, p in whole.named_parameters():
        if n.startswith("blocks.") and int(n.split(".")[1]) < 2:
            assert n not in got
            continue
        assert torch.equal(got[n], p), n
    piped, _ = build_pipelined_model(tcfg, 2, 4, stage=0, seed=4)
    assert sorted({n.split(".")[1] for n, _ in piped.named_parameters()
                   if n.startswith("blocks.")}) == ["0", "1"]
