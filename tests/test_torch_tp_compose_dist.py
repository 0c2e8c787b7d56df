"""Tensor parallelism composed with the expert and sequence axes, across
four real gloo ranks on the CPU, against the JAX package's engines on
four of its eight virtual devices and against the 1-rank port.

One spawn (``test_torch_comm._spawn``: a ``file://`` rendezvous, killed
and failed past its own clock) runs, in one 4-rank world:

* **MoE served at tp 4**: a 2-layer Mixtral-shaped MoE (hidden 64, 4
  heads over 2 kv heads, so each kv head is held by two ranks, rotary,
  4 SwiGLU experts of width 128, top-1) through ``init_inference`` with
  ``tensor_parallel.tp_size`` 4: each rank holds a quarter of every
  expert's ``fc`` / ``gate`` columns and ``proj`` rows. Its f32
  ``forward`` logits are held to the JAX tp-4 inference engine's at rtol
  1e-5 (atol 1e-5), its greedy ``generate()`` and ``serve()`` tokens are
  equal to the JAX engine's.
* **MoE trained at tp 2 x ep 2** (ZeRO 1, dropping capacity 1.0, aux
  weight 0.01): three ``train_batch`` steps against the JAX engine on a
  tp 2 x ep 2 mesh whose MoE gates in the mesh's 2 groups (its global
  mesh set, as ``tests/test_moe.py:130`` composes them): loss and grad
  norm within rtol 2e-4, the step's aux equal on every rank. The expert kernels are a quarter a rank (two
  experts, half of each one's columns). A sharded save there loads into
  a 1-rank port engine, the JAX engine and ``zero_to_fp32`` bitwise, and
  the next step agrees (rtol 1e-5 / 2e-4).
* **sp 2 x tp 2, ring and Ulysses** (ZeRO 1): a 2-layer llama shape
  (hidden 64, 4 heads over 2 kv heads, rotary, SwiGLU, untied head),
  each rank a 8-token chunk of its seq group's 16-token samples on its 2
  local heads: three steps within rtol 1e-5 of the 1-rank port and 2e-4
  of the JAX engine at sp 2 x tp 2 (which lowers on jax 0.9).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.engine import InferenceEngine as JInferenceEngine
from deepspeed_tpu.models import build_model as jbuild_model
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.parallel import mesh as tmesh

from test_torch_comm import _spawn

BASE = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            max_seq_len=64, attention_impl="auto", pos_embed="rotary",
            rotary_interleaved=False, norm="rmsnorm", gated_mlp=True,
            activation="silu", tie_embeddings=False, use_bias=False,
            mlp_dim_override=128)
ARCHS = {
    "moe": dict(BASE, vocab_size=64, moe_experts=4, moe_k=1,
                moe_capacity_factor=1.0),
    "llama": dict(BASE, vocab_size=256),
}
AUX, S, NEW = 0.01, 16, 6
SEEDS = [100, 101, 100]
PROMPTS = [[5, 17, 3, 9, 50, 7], [1, 2, 3], [20, 10, 50, 25, 12, 6, 3, 1]]
SERVING = {"block_size": 8, "pool_blocks": 32, "max_batch": 4,
           "max_blocks_per_seq": 8}
SP_MODES = ("ring", "ulysses")


def _base(tb, stage, **extra):
    cfg = {"train_batch_size": tb, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 0.5, "steps_per_print": 100,
           "zero_optimization": {"stage": stage}}
    cfg.update(extra)
    return cfg


def _moe_cfg(tp=2, ep=2):
    return _base(8, 1, moe={"enabled": True, "ep_size": ep},
                 tensor_parallel={"tp_size": tp})


def _sp_cfg(mode, sp=2, tp=2):
    cfg = _base(8, 1)
    if sp > 1:
        cfg["sequence_parallel"] = {"sp_size": sp, "mode": mode}
    if tp > 1:
        cfg["tensor_parallel"] = {"tp_size": tp}
    return cfg


_CFGS = {}


def _cfgs(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _CFGS:
        _, jcfg = jbuild_model("gpt2-tiny", **dict(ARCHS[arch], dtype=jax.
                                                   numpy.float32, **over))
        f = {fl.name: getattr(jcfg, fl.name)
             for fl in dataclasses.fields(jcfg)}
        f["dtype"] = torch.float32
        _CFGS[key] = (jcfg, ttr.TransformerConfig(**f))
    return _CFGS[key]


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        p = jax.jit(jtr.Transformer(jcfg).init)(
            jax.random.PRNGKey(7),
            {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        _PARAMS[arch] = jax.tree.map(np.asarray, jax.device_get(p))
    return _PARAMS[arch]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _fields(arch, **over):
    _, tcfg = _cfgs(arch, **over)
    f = {fl.name: getattr(tcfg, fl.name) for fl in dataclasses.fields(tcfg)}
    f["dtype"] = "float32"
    return f


def _batch(arch, seed, tb=8):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, ARCHS[arch]["vocab_size"], (tb, S))
            .astype(np.int32)}


def _ids():
    return _batch("moe", 3, tb=2)["input_ids"]


WORKER = r"""
import json, os, sys
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax

plan = json.load(open(sys.argv[1]))
ds.comm.init_distributed(device="cpu")
rank = ds.comm.get_rank()

def tree(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out

def tcfg(fields):
    return ttr.TransformerConfig(**dict(fields, dtype=torch.float32))

def batch(seed, vocab, tb=8):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (tb, plan["seq"]))
            .astype(np.int32)}

res = {"rank": rank, "runs": {}}
inf = plan["infer"]
cfg = tcfg(inf["model"])
ids = np.asarray(plan["ids"], np.int32)
eng = ds.init_inference(cfg, {"dtype": "float32", "tensor_parallel": {
    "tp_size": 4}}, model_parameters=params_from_jax(tree(inf["params"])),
    sharding_rules=cfg.tp_rules(), device="cpu")
logits = eng.forward(torch.from_numpy(ids))
if isinstance(logits, tuple):
    logits = logits[0]
res["infer"] = {
    "fc": list(eng.params["blocks"]["moe"]["experts"]["fc"]["kernel"].shape),
    "proj": list(eng.params["blocks"]["moe"]["experts"]["proj"]["kernel"]
                 .shape),
    "logits": logits.tolist(),
    "generate": eng.generate(ids, max_new_tokens=plan["new"]).tolist(),
    "serve": eng.serve(plan["serving"]).generate_batch(plan["prompts"],
                                                       plan["new"])}

for key, run in plan["runs"].items():
    cfg = tcfg(run["model"])
    moe = cfg.moe_experts > 0
    loss = ttr.make_moe_loss(plan["aux"]) if moe else ttr.causal_lm_loss
    ds.comm.reset_op_counts()
    eng, *_ = ds.initialize(
        model=ttr.Transformer(cfg, seed=3), config=run["config"],
        model_parameters=tree(run["params"]), loss_fn=loss,
        sharding_rules=cfg.tp_rules(), device="cpu")
    traj = []
    for s in run["seeds"]:
        m = eng.train_batch(batch(s, cfg.vocab_size))
        traj.append([m["loss"], m["grad_norm"]] + ([m["aux"]] if moe
                                                   else []))
    o = {"traj": traj, "ops": ds.comm.op_counts(),
         "world": [eng.batch_world, eng.seq_world, eng.tp.size]}
    if moe:
        o["expert_numel"] = sum(e.param.numel() for e in eng.dp.entries
                                if e.eslab is not None)
        o["expert_full"] = sum(int(np.prod(e.full_shape))
                               for e in eng.dp.entries
                               if e.eslab is not None)
    if run.get("save"):
        ck = os.path.join(plan["dir"], key)
        eng.save_checkpoint(ck)
        sd = eng.module_state_dict()
        if rank == 0:
            np.savez(os.path.join(plan["dir"], key + "_state.npz"), **sd)
        m = eng.train_batch(batch(run["after"], cfg.vocab_size))
        o["after"] = [m["loss"], m["grad_norm"]]
    res["runs"][key] = o
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


def _save_params(tmp, arch):
    path = tmp / f"{arch}_params.npz"
    if not path.exists():
        np.savez(path, **_flat(_params(arch)))
    return str(path)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_compose")
    runs = {"moe": {"model": _fields("moe"),
                    "params": _save_params(tmp, "moe"),
                    "config": _moe_cfg(), "seeds": SEEDS, "save": True,
                    "after": 113}}
    for mode in SP_MODES:
        runs[mode] = {"model": _fields("llama", attention_impl=mode),
                      "params": _save_params(tmp, "llama"),
                      "config": _sp_cfg(mode), "seeds": SEEDS}
    plan = {"dir": str(tmp), "seq": S, "aux": AUX, "new": NEW,
            "ids": _ids().tolist(), "prompts": PROMPTS,
            "serving": SERVING, "runs": runs,
            "infer": {"model": _fields("moe"),
                      "params": _save_params(tmp, "moe")}}
    (tmp / "plan.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, 4, tmp, "tp_compose", args=[tmp / "plan.json"],
                  timeout=300)
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    return {"dir": tmp, "ranks": ranks}


def _jax_moe_engine(stage=1):
    """The JAX engine on a tp 2 x ep 2 mesh of 4 devices, its global
    mesh set (the MoE gates in the mesh's 2 groups)."""
    jcfg, _ = _cfgs("moe")
    mm = MeshManager(devices=jax.devices()[:4], ep_size=2, tp_size=2)
    jmesh.set_global_mesh(mm)
    eng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=_moe_cfg(),
        model_parameters=_params("moe"), mesh_manager=mm,
        loss_fn=jtr.make_moe_loss(AUX), sharding_rules=jcfg.tp_rules())
    return eng


def test_moe_served_at_tp4_matches_jax_tp_engine(four):
    jcfg, _ = _cfgs("moe")
    eng = JInferenceEngine(
        model=jtr.Transformer(jcfg), model_parameters=_params("moe"),
        config={"dtype": "float32", "tensor_parallel": {"tp_size": 4}},
        sharding_rules=jcfg.tp_rules())
    logits = eng.forward({"input_ids": jnp.asarray(_ids())})
    if isinstance(logits, tuple):
        logits = logits[0]
    gen = np.asarray(eng.generate(jnp.asarray(_ids()), max_new_tokens=NEW))
    prompts = [np.asarray(eng.generate(jnp.asarray([p]),
                                       max_new_tokens=NEW))[0, len(p):]
               for p in PROMPTS]
    for r in four["ranks"]:
        inf = r["infer"]
        # every expert on each rank, a quarter of its columns / rows
        assert inf["fc"] == [2, 4, 64, 32] and inf["proj"] == [2, 4, 32, 64]
        np.testing.assert_allclose(np.array(inf["logits"]),
                                   np.asarray(logits), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.array(inf["generate"]), gen)
        for got, want in zip(inf["serve"], prompts):
            assert got == want.tolist()


def test_moe_at_tp2_by_ep2_matches_jax_engine(four):
    eng = _jax_moe_engine()
    ref = []
    for s in SEEDS:
        m = jax.device_get(eng.train_batch(_batch("moe", s)))
        ref.append([float(m["loss"]), float(m["grad_norm"])])
    auxes = []
    for r in four["ranks"]:
        run = r["runs"]["moe"]
        traj = np.array(run["traj"])
        np.testing.assert_allclose(traj[:, :2], np.array(ref), rtol=2e-4)
        auxes.append(traj[:, 2])
        assert run["world"] == [2, 1, 2]
        # two of four experts, half of each one's columns or rows
        assert run["expert_numel"] * 4 == run["expert_full"]
        # a MoE layer's two exchanges a micro-batch each way (gas 2)
        assert run["ops"]["all_to_all"] == 3 * 2 * 2 * 4
    # the step's aux, the mean over the gating groups, on every rank
    for a in auxes[1:]:
        np.testing.assert_array_equal(a, auxes[0])
    assert np.all(auxes[0] > 0)
    assert ref[-1][0] < ref[0][0]


def test_moe_tp2_by_ep2_sharded_save_loads_everywhere(four):
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        convert_zero_checkpoint_to_fp32_state_dict
    tmp = four["dir"]
    r0 = four["ranks"][0]["runs"]["moe"]
    with np.load(tmp / "moe_state.npz") as z:
        saved = {k: z[k] for k in z.files}
    assert saved["blocks/moe/experts/fc/kernel"].shape == (2, 4, 64, 128)
    _, tcfg = _cfgs("moe")
    port, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg, seed=5), config=_base(8, 1),
        loss_fn=ttr.make_moe_loss(AUX), device="cpu",
        dist_init_required=False)
    port.load_checkpoint(str(tmp / "moe"))
    for k, v in port.module_state_dict().items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    sd = convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp / "moe"), str(tmp / "moe_fp32.npz"))
    assert sorted(sd) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    jeng = _jax_moe_engine()
    jeng.load_checkpoint(str(tmp / "moe"))
    for k, v in jeng.module_state_dict().items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), saved[k],
                                      err_msg=k)
    jm = jax.device_get(jeng.train_batch(_batch("moe", 113)))
    np.testing.assert_allclose([float(jm["loss"]), float(jm["grad_norm"])],
                               r0["after"], rtol=2e-4)


_SP = {}


def _sp_refs(mode):
    """(1-rank port trajectory, JAX sp 2 x tp 2 trajectory) of the llama
    shape under ``mode``."""
    if mode not in _SP:
        _, tcfg = _cfgs("llama")
        port, *_ = deepspeed_tpu_torch.initialize(
            model=ttr.Transformer(tcfg, seed=3), config=_base(8, 1),
            model_parameters=_params("llama"), loss_fn=ttr.causal_lm_loss,
            device="cpu", dist_init_required=False)
        one = [[m["loss"], m["grad_norm"]] for m in (
            port.train_batch(_batch("llama", s)) for s in SEEDS)]
        jcfg, _ = _cfgs("llama", attention_impl=mode)
        mm = MeshManager(devices=jax.devices()[:4], sp_size=2, tp_size=2)
        jmesh.set_global_mesh(mm)
        jeng, *_ = deepspeed_tpu.initialize(
            model=jtr.Transformer(jcfg), config=_sp_cfg(mode),
            model_parameters=_params("llama"), mesh_manager=mm,
            loss_fn=jtr.causal_lm_loss, sharding_rules=jcfg.tp_rules())
        jx = [[float(m["loss"]), float(m["grad_norm"])] for m in (
            jax.device_get(jeng.train_batch(_batch("llama", s)))
            for s in SEEDS)]
        _SP[mode] = np.array(one), np.array(jx)
    return _SP[mode]


@pytest.mark.parametrize("mode", SP_MODES)
def test_sp2_by_tp2_matches_one_rank_port_and_jax(four, mode):
    one, jx = _sp_refs(mode)
    for r in four["ranks"]:
        run = r["runs"][mode]
        assert run["world"] == [1, 2, 2]
        np.testing.assert_allclose(np.array(run["traj"]), one, rtol=1e-5)
        np.testing.assert_allclose(np.array(run["traj"]), jx, rtol=2e-4)
        if mode == "ring":
            # the ring rotates k / v chunks and exchanges no heads
            assert run["ops"]["ppermute_async"] > 0
            assert run["ops"].get("all_to_all", 0) == 0
        else:
            # q, k, v in and o out, forward and backward: 8 head
            # exchanges a layer a micro-batch (2 layers, gas 2, 3 steps)
            assert run["ops"]["all_to_all"] == 8 * 2 * 2 * 3
    assert one[-1, 0] < one[0, 0]
