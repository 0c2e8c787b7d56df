"""Expert parallelism across real gloo ranks on the CPU: the port's MoE
engine against the JAX engine and the 1-rank port.

The model is a 2-layer Mixtral-shaped MoE (hidden 64, RMSNorm, GQA
4q/2kv, rotary, untied head, 4 SwiGLU experts of width 128 a layer, top-1
routing), its flax-initialized f32 weights fed to both packages. Two
spawns (``test_torch_comm._spawn``: a ``file://`` rendezvous, killed and
failed past their own clock):

* **2 ranks, ``moe.ep_size`` 2** (each rank holds 2 experts a layer; the
  batch splits over the expert axis): 12 ``train_batch`` steps at ZeRO
  stages 0-3 with a dropping capacity (factor 1) and aux weight 0.01.
  Each rank gates its own tokens, so the run is held to the JAX engine
  on a 2-device mesh with ``ep_size`` 2 whose MoE gates in the mesh's 2
  groups (its global mesh set): loss and grad norm rtol 2e-4 (the JAX
  engine's stage 0 stands for stages 0-2, whose steps are one function
  there, and its stage 3 for stage 3). At no drop (factor E/k) and aux
  weight 0 the grouping changes nothing: three steps against the
  1-rank port without a mesh at rtol 1e-5. ``expert_parallel_apply``
  against the experts applied locally (atol 1e-6). A sharded save (each
  rank writing its own experts) loads into a 1-rank port engine and
  into the JAX engine (state bitwise; next losses rtol 1e-5 / 2e-4).
* **4 ranks, data 2 x expert 2**: the expert leaves' grads are reduced
  over the expert-data group and divided by the 4 batch ranks (dividing
  by ``data`` alone would leave them twice too large, which 2 ranks at
  ``ep_size`` 2 cannot show): three steps at stages 2 and 3, no drop and
  aux 0, against the 1-rank port at rtol 1e-5; each rank's expert
  slabs are a quarter of the expert leaves at stage 3, and a sharded
  save there (experts split over ``expert``, then over the expert-data
  group) loads into the 1-rank port bitwise.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import build_model as jbuild_model
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as ttr

from test_torch_comm import _spawn

ARCH = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            vocab_size=64, max_seq_len=64, attention_impl="auto",
            pos_embed="rotary", rotary_interleaved=False, norm="rmsnorm",
            gated_mlp=True, activation="silu", tie_embeddings=False,
            use_bias=False, mlp_dim_override=128, moe_experts=4, moe_k=1)
DROP = dict(moe_capacity_factor=1.0)            # tokens past C drop
NO_DROP = dict(moe_capacity_factor=4.0)         # E / k: nothing drops
AUX, STEPS, S = 0.01, 12, 16


def _base(tb, stage, **extra):
    cfg = {"train_batch_size": tb, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 0.5, "steps_per_print": 100,
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 64}}
    cfg.update(extra)
    return cfg


def _moe(tb, stage, ep):
    return _base(tb, stage, moe={"enabled": True, "ep_size": ep})


_CFGS = {}


def _cfgs(**over):
    key = tuple(sorted(over.items()))
    if key not in _CFGS:
        _, jcfg = jbuild_model("gpt2-tiny", **dict(ARCH, dtype=jax.numpy.
                                                   float32, **over))
        f = {fl.name: getattr(jcfg, fl.name)
             for fl in dataclasses.fields(jcfg)}
        f["dtype"] = torch.float32
        _CFGS[key] = (jcfg, ttr.TransformerConfig(**f))
    return _CFGS[key]


_PARAMS = {}


def _params():
    if not _PARAMS:
        jcfg, _ = _cfgs(**DROP)
        p = jax.jit(jtr.Transformer(jcfg).init)(
            jax.random.PRNGKey(7),
            {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        _PARAMS["p"] = jax.tree.map(np.asarray, jax.device_get(p))
    return _PARAMS["p"]


def _batch(tb, seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 64, (tb, S)).astype(np.int32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_engine(cfg, over, aux=AUX):
    """The JAX engine on a 2-device mesh with ep_size 2, its global mesh
    set so the MoE gates in the mesh's 2 groups."""
    jcfg, _ = _cfgs(**over)
    mm = MeshManager(devices=jax.devices()[:2], ep_size=2)
    jmesh.set_global_mesh(mm)
    eng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=cfg, model_parameters=_params(),
        loss_fn=jtr.make_moe_loss(aux), mesh_manager=mm)
    return eng


def _port_engine(cfg, over, aux=AUX, from_params=True):
    _, tcfg = _cfgs(**over)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg, seed=3), config=cfg,
        model_parameters=_params() if from_params else None,
        loss_fn=ttr.make_moe_loss(aux), device="cpu")
    return eng


def _traj(eng, tb, seeds):
    out = []
    for s in seeds:
        m = jax.device_get(eng.train_batch(_batch(tb, s)))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return out


WORKER = r"""
import json, os, sys
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import transformer as ttr

plan = json.load(open(sys.argv[1]))
ds.comm.init_distributed(device="cpu")
rank, world = ds.comm.get_rank(), ds.comm.get_world_size()
with np.load(plan["params"]) as z:
    flat = {k: z[k] for k in z.files}
params = {}
for k, v in flat.items():
    node = params
    parts = k.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = v

def batch(tb, seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 64, (tb, plan["seq"]))
            .astype(np.int32)}

def engine(run, from_params=True):
    tcfg = ttr.TransformerConfig(**dict(run["model"], dtype=torch.float32))
    eng, *_ = ds.initialize(
        model=ttr.Transformer(tcfg, seed=3), config=run["config"],
        model_parameters=params if from_params else None,
        loss_fn=ttr.make_moe_loss(run["aux"]), device="cpu")
    return eng

def steps(eng, tb, seeds):
    out = []
    for s in seeds:
        m = eng.train_batch(batch(tb, s))
        out.append([m["loss"], m["grad_norm"]])
    return out

res = {"rank": rank, "runs": {}}
for key, run in plan["runs"].items():
    ds.comm.reset_op_counts()
    eng = engine(run)
    tb = run["config"]["train_batch_size"]
    out = {"traj": steps(eng, tb, run["seeds"]),
           "ops": ds.comm.op_counts()}
    out["expert_numel"] = sum(e.param.numel() for e in eng.dp.entries
                              if e.eslab is not None)
    out["expert_full"] = sum(int(np.prod(e.full_shape))
                             for e in eng.dp.entries if e.eslab is not None)
    if run.get("save"):
        ck = os.path.join(plan["dir"], key.replace("/", "_"))
        eng.save_checkpoint(ck)
        sd = eng.module_state_dict()
        if rank == 0:
            np.savez(os.path.join(plan["dir"], key.replace("/", "_")
                                  + "_state.npz"), **sd)
        out["after_save"] = steps(eng, tb, run["after"])
        out["files"] = sorted(os.listdir(os.path.join(ck, "global_step%d"
                                                      % len(run["seeds"]))))
    res["runs"][key] = out

if plan.get("apply"):
    # expert_parallel_apply: each rank holds 2 of 4 experts and 3 queue
    # slots of every expert
    from deepspeed_tpu_torch.moe import expert_parallel_apply
    from deepspeed_tpu_torch.parallel.mesh import get_global_mesh
    ep = get_global_mesh().shape["expert"]
    erank = ds.comm.axis_rank("expert")
    g = np.random.default_rng(4)
    w = torch.from_numpy(g.standard_normal((4, 8, 8)).astype(np.float32))
    disp = torch.from_numpy(g.standard_normal((4, 3 * ep, 8))
                            .astype(np.float32))
    El = 4 // ep
    mine = disp[:, 3 * erank:3 * erank + 3]
    out = expert_parallel_apply(lambda wk, x: torch.tanh(x @ wk),
                                w[El * erank:El * erank + El], mine, ep)
    local = torch.tanh(torch.bmm(disp, w))[:, 3 * erank:3 * erank + 3]
    res["apply_err"] = float((out - local).abs().max())
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""


def _run(tmp, name, world, runs, apply=False):
    np.savez(tmp / "params.npz", **_flat(_params()))
    plan = {"params": str(tmp / "params.npz"), "dir": str(tmp), "seq": S,
            "runs": runs, "apply": apply}
    (tmp / f"{name}.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, world, tmp, name, args=[tmp / f"{name}.json"])
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    return ranks


def _model_fields(over):
    _, tcfg = _cfgs(**over)
    f = {fl.name: getattr(tcfg, fl.name) for fl in dataclasses.fields(tcfg)}
    f["dtype"] = "float32"
    return f


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    from deepspeed_tpu_torch.parallel import mesh as tmesh
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_two")
    seeds = [100 + s % 3 for s in range(STEPS)]
    runs = {f"drop/{st}": {"model": _model_fields(DROP), "aux": AUX,
                           "config": _moe(8, st, 2), "seeds": seeds}
            for st in range(4)}
    runs["nodrop"] = {"model": _model_fields(NO_DROP), "aux": 0.0,
                      "config": _moe(8, 1, 2), "seeds": [110, 111, 112]}
    runs["save"] = {"model": _model_fields(DROP), "aux": AUX,
                    "config": _moe(8, 1, 2), "seeds": [120, 121],
                    "save": True, "after": [122, 123]}
    return {"dir": tmp, "ranks": _run(tmp, "moe_two", 2, runs, apply=True)}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_four")
    runs = {f"nodrop/{st}": {"model": _model_fields(NO_DROP), "aux": 0.0,
                             "config": _moe(16, st, 2),
                             "seeds": [130, 131, 132], "save": st == 3,
                             "after": [133]}
            for st in (2, 3)}
    return {"dir": tmp, "ranks": _run(tmp, "moe_four", 4, runs)}


_JAX = {}


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_two_expert_ranks_match_the_jax_engine(two, stage):
    jstage = 3 if stage == 3 else 0
    if jstage not in _JAX:
        _JAX[jstage] = np.array(_traj(_jax_engine(_moe(8, jstage, 2), DROP),
                                      8, [100 + s % 3 for s in range(STEPS)]))
    ref = _JAX[jstage]
    for r in two["ranks"]:
        got = np.array(r["runs"][f"drop/{stage}"]["traj"])
        np.testing.assert_allclose(got, ref, rtol=2e-4)
        # 2 exchanges a layer in each forward and each backward
        ops = r["runs"][f"drop/{stage}"]["ops"]
        assert ops["all_to_all"] == STEPS * 2 * 2 * 2 * 2
    assert ref[-3:, 0].mean() < ref[:3, 0].mean()


def test_two_expert_ranks_at_no_drop_match_the_one_rank_port(two):
    ref = np.array(_traj(_port_engine(_base(8, 1), NO_DROP, aux=0.0), 8,
                         [110, 111, 112]))
    for r in two["ranks"]:
        np.testing.assert_allclose(np.array(r["runs"]["nodrop"]["traj"]),
                                   ref, rtol=1e-5)
        # each rank trains half of the experts
        run = r["runs"]["nodrop"]
        assert run["expert_numel"] * 2 == run["expert_full"]


def test_expert_parallel_apply_matches_local_experts(two):
    for r in two["ranks"]:
        assert r["apply_err"] < 1e-6


def test_sharded_save_with_experts_loads_into_one_rank_port_and_jax(two):
    tmp = two["dir"]
    ck = str(tmp / "save")
    r0 = two["ranks"][0]["runs"]["save"]
    assert r0["files"] == sorted(
        ["ckpt_meta.json", "meta.json", "model_states-shard0.npz",
         "model_states-shard1.npz", "optim_states-shard0.npz",
         "optim_states-shard1.npz"])
    with np.load(tmp / "save_state.npz") as z:
        saved = {k: z[k] for k in z.files}
    assert saved["blocks/moe/experts/fc/kernel"].shape == (2, 4, 64, 128)
    # the 1-rank port, its MoE in the same 2 gating groups
    from deepspeed_tpu_torch.parallel import mesh as tmesh
    tmesh.set_global_mesh(tmesh.MeshManager(devices=[0, 1], ep_size=2))
    port = _port_engine(_base(8, 1), DROP, from_params=False)
    port.load_checkpoint(ck)
    for k, v in port.module_state_dict().items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    got = np.array(_traj(port, 8, [122, 123]))
    for r in two["ranks"]:
        np.testing.assert_allclose(got, np.array(r["runs"]["save"]
                                                 ["after_save"]), rtol=1e-5)
    tmesh.set_global_mesh(None)
    jeng = _jax_engine(_moe(8, 1, 2), DROP)
    jeng.load_checkpoint(ck)
    for k, v in jeng.module_state_dict().items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), saved[k],
                                      err_msg=k)
    jgot = np.array(_traj(jeng, 8, [122, 123]))
    np.testing.assert_allclose(jgot, np.array(r0["after_save"]), rtol=2e-4)


@pytest.mark.parametrize("stage", [2, 3])
def test_data_by_expert_ranks_scale_expert_grads_by_the_batch_ranks(
        four, stage):
    ref = np.array(_traj(_port_engine(_base(16, stage), NO_DROP, aux=0.0),
                         16, [130, 131, 132]))
    for r in four["ranks"]:
        run = r["runs"][f"nodrop/{stage}"]
        np.testing.assert_allclose(np.array(run["traj"]), ref, rtol=1e-5)
        # the expert split, then at stage 3 the expert-data group's slab
        assert run["expert_numel"] * (4 if stage == 3 else 2) == \
            run["expert_full"]


def test_data_by_expert_sharded_save_loads_into_one_rank_port(four):
    tmp = four["dir"]
    with np.load(tmp / "nodrop_3_state.npz") as z:
        saved = {k: z[k] for k in z.files}
    port = _port_engine(_base(16, 3), NO_DROP, aux=0.0, from_params=False)
    port.load_checkpoint(str(tmp / "nodrop_3"))
    for k, v in port.module_state_dict().items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    got = np.array(_traj(port, 16, [133]))
    for r in four["ranks"]:
        np.testing.assert_allclose(got, np.array(r["runs"]["nodrop/3"]
                                                 ["after_save"]), rtol=1e-5)
