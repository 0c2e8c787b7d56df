"""ZeRO stages 0-3 across two real gloo ranks on the CPU: the port's
data-parallel engine against the 1-rank port and the JAX engine.

One spawn of two processes (``test_torch_comm._spawn``: a ``file://``
rendezvous, killed and failed past its own clock) runs every 2-rank case
on a 2-layer narrow llama (hidden 64, RMSNorm, SwiGLU, GQA 2q/1kv,
rotary, untied head; the flax-initialized f32 weights of
``test_torch_training``, whose qkv kernels are wide enough for the grad
floor, so stages 2-3 reduce-scatter them) with
the global batch [16, 16], gas 2 (8 rows a micro-batch, 4 on each rank):

* ``train_batch`` at stages 0, 1, 2 and 3, fp32 and bf16 compute with an
  fp32 master, three steps on one batch. Each rank's loss and grad norm (the global
  batch's) match the 1-rank port engine at rtol 1e-5 in fp32 and 2e-2 in
  bf16 (the ranks sum a micro-batch's grads in another order and round
  to bf16 apart), and, in fp32, the JAX engine on its 8-device mesh at
  rtol 2e-4 (its own bound, ``tests/test_engine.py``). From stage 1 up
  each rank holds half of the master and moment bytes (the leaves no dim
  of which two divides stay whole: 1/2 within 2%); at stage 3 every
  compute parameter over the persistence threshold is a half slab
  between steps;
* ``zero.Init``: a model built inside it holds no values; the engine
  fills each rank's slabs with the seeded values of the same model built
  outside it (equal bitwise once gathered), and trains to the 1-rank
  port's loss;
* ``GatheredParameters(modifier_rank=0)``: rank 0's edit of the gathered
  embedding reaches both ranks' slabs and masters;
* a shard write that fails on rank 1 alone publishes nothing and leaves
  ``latest`` (no rank hangs: the failure is folded into an all-reduced
  flag);
* a 2-rank sharded save (``model_states-shard{0,1}.npz``) loads into a
  1-rank port engine (state bitwise, next losses rtol 1e-5) and into the
  JAX engine (state bitwise, next losses rtol 2e-4); a checkpoint the JAX
  engine saved on its 8-device mesh at stage 3 loads into the two port
  ranks (state bitwise, next losses rtol 2e-4).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as ttr

from test_torch_comm import _spawn
from test_torch_training import _TRAIN_CFG, _batch, _cfgs, _params

ARCH, STEPS, TB, S = "llama_wide", 3, 16, 16
PRECS = {"fp32": {}, "bf16": {"bf16": {"enabled": True}}}
TOL = {"fp32": 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    # one left by an earlier test file would pin the JAX engines'
    # activations to its devices
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


def _config(stage, prec="fp32"):
    cfg = {k: v for k, v in _TRAIN_CFG.items()
           if k != "train_micro_batch_size_per_gpu"}
    cfg.update(train_batch_size=TB, zero_optimization={
        "stage": stage, "stage3_param_persistence_threshold": 64},
        **PRECS[prec])
    return cfg


def _port_cfg_fields():
    _, tcfg = _cfgs(ARCH)
    f = {fl.name: getattr(tcfg, fl.name) for fl in dataclasses.fields(tcfg)}
    f["dtype"] = "float32"
    return f


WORKER = r"""
import json, os, sys
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.models import transformer as ttr

plan = json.load(open(sys.argv[1]))
ds.comm.init_distributed(device="cpu")
rank = ds.comm.get_rank()
fields = dict(plan["cfg"], dtype=torch.float32)
tcfg = ttr.TransformerConfig(**fields)
with np.load(plan["params"]) as z:
    flat = {k: z[k] for k in z.files}
params = {}
for k, v in flat.items():
    node = params
    parts = k.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = v

def batch(seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 64, (plan["tb"], plan["seq"]))
            .astype(np.int32)}

def engine(cfg, model=None, from_params=True):
    eng, *_ = ds.initialize(
        model=model if model is not None else ttr.Transformer(tcfg, seed=9),
        config=cfg, model_parameters=params if from_params else None,
        loss_fn=ttr.causal_lm_loss, device="cpu")
    return eng

def steps(eng, seeds):
    out = []
    for s in seeds:
        m = eng.train_batch(batch(s))
        out.append([m["loss"], m["grad_norm"]])
    return out

def state(eng, name):
    sd = eng.module_state_dict()
    if rank == 0:
        np.savez(os.path.join(plan["dir"], name), **sd)

def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)

res = {"rank": rank, "train": {}}
for key, cfg in plan["train"].items():
    eng = engine(cfg)
    traj = steps(eng, [100] * plan["steps"])
    e = eng.dp
    full = [int(np.prod(x.shape)) for x in e.entries]
    res["train"][key] = {
        "traj": traj,
        "master_bytes": e.shard_sizes()["masters"],
        "moment_bytes": nbytes([t for s in eng.opt_state.values()
                                for t in s]),
        "full_master_bytes": 4 * sum(full),
        "param_numel": [p.numel() for p in eng._params],
        "full_numel": full,
        "gathered": [x.gathered for x in e.entries],
        "over_threshold": [n >= 64 for n in full]}

# zero.Init: the model holds no values until the engine places its slabs
cfg3 = plan["stage3"]
with zero.Init(config=cfg3):
    model = ttr.Transformer(tcfg, seed=5)
res["init_meta"] = all(p.is_meta for p in model.parameters())
eng = engine(cfg3, model=model, from_params=False)
res["init_numel"] = [p.numel() for p in eng._params]
state(eng, "init_state.npz")
res["init_traj"] = steps(eng, [110])

# GatheredParameters with write-back from rank 0
eng = engine(cfg3)
p = eng.module.wte.embedding
res["gp_shard"] = list(p.shape)
with zero.GatheredParameters(p, modifier_rank=0):
    res["gp_full"] = list(p.shape)
    if rank == 0:
        p.data[0].fill_(0.25)
res["gp_after"] = list(p.shape)
i = next(j for j, q in enumerate(eng._params) if q is p)
sd = eng.module_state_dict()
res["gp_row0"] = sd["wte/embedding"][0].tolist()
res["gp_master_has"] = bool((eng.dp.masters[i] == 0.25).any())
res["gp_traj"] = steps(eng, [120])

# a 2-rank sharded save
eng = engine(cfg3)
steps(eng, [200, 201])
ck = os.path.join(plan["dir"], "port_ck")
eng.save_checkpoint(ck)
state(eng, "saved_state.npz")
res["after_save"] = steps(eng, [202, 203])
res["port_ck_files"] = sorted(os.listdir(os.path.join(ck, "global_step2")))
# a write failure on rank 1 alone: folded into the all-reduced ok flag,
# so no rank hangs, nothing is published and `latest` stays
from deepspeed_tpu_torch.testing import chaos
if rank == 1:
    chaos.arm("ckpt.write", "raise")
eng.save_checkpoint(ck, tag="bad")
chaos.reset_for_tests()
ds.comm.barrier()
res["bad_save"] = {"latest": open(os.path.join(ck, "latest")).read(),
                   "dirs": sorted(os.listdir(ck))}

# the JAX engine's 8-device checkpoint into the two ranks
eng = engine(cfg3, from_params=False)
eng.load_checkpoint(plan["jax_ck"])
state(eng, "from_jax_state.npz")
res["from_jax"] = steps(eng, [302, 303])
res["ops"] = ds.comm.op_counts()
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""


def _jax_engine(cfg, devices):
    jcfg, _ = _cfgs(ARCH)
    eng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=cfg,
        model_parameters=_params(ARCH), loss_fn=jtr.causal_lm_loss,
        mesh_manager=MeshManager(devices=devices))
    return eng


def _port_engine(cfg, seed=9, from_params=True):
    _, tcfg = _cfgs(ARCH)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg, seed=seed), config=cfg,
        model_parameters=_params(ARCH) if from_params else None,
        loss_fn=ttr.causal_lm_loss, device="cpu")
    return eng


def _traj(eng, seeds):
    out = []
    for s in seeds:
        m = jax.device_get(eng.train_batch(_batch(TB, S, seed=s)))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return out


def _jax_state(eng):
    return {k: np.asarray(v, np.float32)
            for k, v in eng.module_state_dict().items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_dist")
    old, jmesh._GLOBAL_MESH = jmesh._GLOBAL_MESH, None
    try:
        with jax.default_matmul_precision("highest"):
            jeng = _jax_engine(_config(3), jax.devices()[:8])
            jax_pre = _traj(jeng, [300, 301])
            jeng.save_checkpoint(str(tmp / "jax_ck"))
            jax_saved = _jax_state(jeng)
            jax_post = _traj(jeng, [302, 303])
    finally:
        jmesh._GLOBAL_MESH = old
    np.savez(tmp / "params.npz", **_flat(_params(ARCH)))
    train = {f"{stage}/{prec}": _config(stage, prec)
             for stage in range(4) for prec in PRECS}
    plan = {"cfg": _port_cfg_fields(), "params": str(tmp / "params.npz"),
            "dir": str(tmp), "tb": TB, "seq": S, "steps": STEPS,
            "train": train, "stage3": _config(3),
            "jax_ck": str(tmp / "jax_ck")}
    (tmp / "plan.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, 2, tmp, "zero_worker", args=[tmp / "plan.json"])
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    return {"dir": tmp, "ranks": ranks, "jax_pre": jax_pre,
            "jax_saved": jax_saved, "jax_post": jax_post}


_PORT_REF = {}


def _port_ref(stage, prec):
    if (stage, prec) not in _PORT_REF:
        _PORT_REF[stage, prec] = _traj(_port_engine(_config(stage, prec)),
                                       [100] * STEPS)
    return _PORT_REF[stage, prec]


@pytest.mark.parametrize("prec", sorted(PRECS))
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_two_ranks_match_the_one_rank_port(world, stage, prec):
    ref = np.array(_port_ref(stage, prec))
    for r in world["ranks"]:
        got = np.array(r["train"][f"{stage}/{prec}"]["traj"])
        np.testing.assert_allclose(got, ref, rtol=TOL[prec])
    assert ref[-1, 0] < ref[0, 0]


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_two_ranks_match_the_jax_engine_on_eight_devices(world, stage):
    ref = np.array(_traj(_jax_engine(_config(stage), jax.devices()[:8]),
                         [100] * STEPS))
    for r in world["ranks"]:
        got = np.array(r["train"][f"{stage}/fp32"]["traj"])
        np.testing.assert_allclose(got, ref, rtol=2e-4)


@pytest.mark.parametrize("prec", sorted(PRECS))
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_per_rank_state_is_sharded_by_stage(world, stage, prec):
    for r in world["ranks"]:
        t = r["train"][f"{stage}/{prec}"]
        share = t["master_bytes"] / t["full_master_bytes"]
        moments = t["moment_bytes"] / (2 * t["full_master_bytes"])
        if stage == 0:
            assert moments == 1.0
            assert share == (1.0 if prec == "bf16" else 0.0)  # fp32 aliases
        else:
            assert abs(share - 0.5) < 0.02 and abs(moments - 0.5) < 0.02
        for n, full, g, over in zip(t["param_numel"], t["full_numel"],
                                    t["gathered"], t["over_threshold"]):
            half = stage == 3 and over
            assert g == half
            assert n == (full // 2 if half else full)


def test_zero_init_places_the_seeded_values_as_slabs(world):
    _, tcfg = _cfgs(ARCH)
    ref = _port_engine(_config(3), seed=5, from_params=False)
    want = ref.module_state_dict()
    with np.load(world["dir"] / "init_state.npz") as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    loss = _traj(ref, [110])[0][0]
    for r in world["ranks"]:
        assert r["init_meta"]
        full = [p.numel() for p in ref._params]
        assert sum(r["init_numel"]) < 0.6 * sum(full)
        np.testing.assert_allclose(r["init_traj"][0][0], loss, rtol=1e-5)


def test_gathered_parameters_writes_back_from_the_modifier_rank(world):
    for r in world["ranks"]:
        vocab, hidden = r["gp_full"]
        assert r["gp_shard"] == [vocab // 2, hidden] == r["gp_after"]
        assert r["gp_row0"] == [0.25] * hidden
        assert np.isfinite(r["gp_traj"][0][0])
    # rank 0 owns row 0 of the master slab, rank 1 does not
    assert [r["gp_master_has"] for r in world["ranks"]] == [True, False]


def test_two_rank_sharded_save_loads_into_one_rank_port_and_jax(world):
    tmp = world["dir"]
    ck = str(tmp / "port_ck")
    r0 = world["ranks"][0]
    assert r0["port_ck_files"] == sorted(
        ["ckpt_meta.json", "meta.json", "model_states-shard0.npz",
         "model_states-shard1.npz", "optim_states-shard0.npz",
         "optim_states-shard1.npz"])
    with open(os.path.join(ck, "global_step2", "meta.json")) as f:
        meta = json.load(f)
    assert meta["num_shards"] == 2 and meta["sharded"]
    with np.load(tmp / "saved_state.npz") as z:
        saved = {k: z[k] for k in z.files}
    port = _port_engine(_config(3), seed=11, from_params=False)
    port.load_checkpoint(ck)
    for k, v in port.module_state_dict().items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    got = np.array(_traj(port, [202, 203]))
    for r in world["ranks"]:
        np.testing.assert_allclose(got, np.array(r["after_save"]),
                                   rtol=1e-5)
    jeng = _jax_engine(_config(3), jax.devices()[:1])
    jeng.load_checkpoint(ck)
    for k, v in _jax_state(jeng).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    jgot = np.array(_traj(jeng, [202, 203]))
    np.testing.assert_allclose(jgot, np.array(r0["after_save"]), rtol=2e-4)


def test_jax_eight_device_checkpoint_loads_into_two_port_ranks(world):
    with np.load(world["dir"] / "from_jax_state.npz") as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(world["jax_saved"])
    for k, v in world["jax_saved"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for r in world["ranks"]:
        np.testing.assert_allclose(np.array(r["from_jax"]),
                                   np.array(world["jax_post"]), rtol=2e-4)
        # stage 3 gathered and reduce-scattered through the facade
        assert r["ops"]["all_gather"] > 0 and r["ops"]["reduce_scatter"] > 0
        assert r["train"]["2/fp32"]["master_bytes"] > 0


def test_zero_init_without_a_process_group_materializes_whole():
    """One process: the engine fills an Init-built model whole, a
    ``Transformer`` from its seeded values (equal to the model built
    outside Init), any other module through its ``reset_parameters``; a
    stage below 3 leaves Init off."""
    from deepspeed_tpu_torch import zero
    _, tcfg = _cfgs(ARCH)
    with zero.Init(config=_config(3)) as zi:
        assert zero.get_active_init() is zi
        model = ttr.Transformer(tcfg, seed=5)
        lin = torch.nn.Sequential(torch.nn.Linear(4, 6))
    assert zero.get_active_init() is None
    assert all(p.is_meta for p in model.parameters())
    assert all(p.is_meta for p in lin.parameters())
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_config(3), loss_fn=ttr.causal_lm_loss,
        device="cpu")
    ref = _port_engine(_config(3), seed=5, from_params=False)
    for k, v in ref.module_state_dict().items():
        np.testing.assert_array_equal(eng.module_state_dict()[k], v,
                                      err_msg=k)
    torch.manual_seed(0)
    values = dict(zero.init_values(lin, "cpu"))
    zero.materialize(lin, values.items())
    torch.manual_seed(0)
    want = torch.nn.Linear(4, 6)
    torch.testing.assert_close(lin[0].weight, want.weight, rtol=0, atol=0)
    with zero.Init(config=_config(2)):
        assert zero.get_active_init() is None
        assert not ttr.Transformer(tcfg, seed=5).wte.embedding.is_meta
    with pytest.raises(ValueError, match="reset_parameters"):
        with zero.Init(config=_config(3)):
            bare = torch.nn.Module()
            bare.w = torch.nn.Parameter(torch.zeros(3))
        list(zero.init_values(bare, "cpu"))


def test_on_device_and_gathered_parameters_without_an_engine():
    from deepspeed_tpu_torch import zero
    with zero.OnDevice(dtype=torch.float64, device="meta"):
        m = torch.nn.Linear(3, 5)
    assert m.weight.is_meta and m.weight.dtype == torch.float64
    assert torch.get_default_dtype() == torch.float32
    shapes = zero.OnDevice(device="meta").init(torch.nn.Linear, 2, 7)
    assert shapes.weight.is_meta and tuple(shapes.weight.shape) == (7, 2)
    lin = torch.nn.Linear(2, 2)
    with zero.GatheredParameters(lin, modifier_rank=0) as ps:
        assert ps == list(lin.parameters())
        ps[0].data.fill_(1.5)
    assert torch.all(lin.weight == 1.5)


def test_one_rank_write_failure_publishes_nothing(world):
    for r in world["ranks"]:
        assert r["bad_save"]["latest"] == "global_step2"
        assert "bad" not in r["bad_save"]["dirs"]
        assert "bad.failed" in r["bad_save"]["dirs"]
        assert "bad.tmp" not in r["bad_save"]["dirs"]
