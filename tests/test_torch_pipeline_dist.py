"""Pipeline parallelism across two gloo ranks on the CPU: each rank holds
one stage of a ``PipelinedTransformer`` (pp 2 x data 1) under the
``PipelineEngine``, against the 1-rank port and the JAX
``PipelineEngine`` on 2 devices (JAX ``tests/test_pipeline.py:232``,
``tests/test_mpmd.py:317``).

One spawn (``test_torch_comm._spawn``: a ``file://`` rendezvous, killed
and failed past its own clock) runs, from the same flax-initialized
weights (gpt2-style, hidden 64, 4 layers, vocab 256, 8 x 16 tokens, gas
4):

* ``train_batch`` under gpipe and 1F1B, three steps: within rtol 1e-5 of
  the 1-rank port's ``PipelineEngine`` (one process holding both
  stages) and 2e-4 of the JAX engine (gpipe through its mpmd placement,
  the spmd gpipe scan not lowering on jax 0.9); one transfer
  (``comm.ppermute`` over ``pipe``) a tick and direction: 2 x n_micro a
  step; the embedding and head leaves bitwise equal on both ranks; the
  ``eval_batch`` logits on both;
* uneven -100 labels (the global token mean over the whole batch);
* ZeRO-1 and ZeRO-2 at pp 2 x data 1 (stage 3:
  ``test_torch_pipeline_compose_dist.py``);
* (a second spawn, 4 ranks) pp 2 x data 2 at ZeRO 1 with uneven labels:
  the valid-target count summed over the data group;
* a sharded save after the gpipe run: each rank writes its blocks at
  their layer offsets and pipe rank 0 the shared leaves. It loads into a
  1-rank port engine, into the JAX engine and through ``zero_to_fp32``;
  and a 1-rank port tag loads into pp 2, whose next step matches.
"""

import json

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

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.pipeline import PipelinedTransformer
from deepspeed_tpu_torch.parallel import mesh as tmesh

from test_torch_comm import _spawn

KW = dict(hidden_size=64, num_layers=4, num_heads=4, vocab_size=256,
          max_seq_len=64)
S, TB, GAS = 16, 8, 4
SEEDS = [40, 41, 40]


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


def _jcfg():
    return jtr.get_config("gpt2-tiny", **KW, dtype=jnp.float32,
                          attention_impl="reference")


def _tcfg():
    return ttr.get_config("gpt2-tiny", **KW, dtype=torch.float32)


_P = {}


def _params():
    if "p" not in _P:
        p = jax.jit(jtr.Transformer(_jcfg()).init)(
            jax.random.PRNGKey(3),
            {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        _P["p"] = jax.tree.map(np.asarray, jax.device_get(p))
    return _P["p"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batch(seed, uneven=False):
    ids = np.random.default_rng(seed).integers(0, 256, (TB, S)).astype(
        np.int32)
    b = {"input_ids": ids}
    if uneven:
        lab = ids.copy()
        lab[:3, 2:] = -100          # micro-batches 0 and 1 mostly masked
        lab[5, 9:] = -100
        b["labels"] = lab
    return b


def _config(schedule="1f1b", stage=0, pp=2, placement="spmd", micro=2):
    return {"train_batch_size": TB, "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "gradient_clipping": 0.5, "steps_per_print": 100,
            "zero_optimization": {"stage": stage},
            "pipeline": {"stages": pp, "schedule": schedule,
                         "placement": placement}}


RUNS = {
    "gpipe": dict(schedule="gpipe", stage=0, save=True),
    "1f1b": dict(schedule="1f1b", stage=0),
    "uneven": dict(schedule="1f1b", stage=0, uneven=True),
    "zero1": dict(schedule="1f1b", stage=1),
    "zero2": dict(schedule="gpipe", stage=2),
}

WORKER = r"""
import hashlib, json, os, sys
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.pipeline import PipelinedTransformer

plan = json.load(open(sys.argv[1]))
ds.comm.init_distributed(device="cpu")
rank = ds.comm.get_rank()
# the mesh's order: pipe outermost, then data
stage = rank // (ds.comm.get_world_size() // 2)
cfg = ttr.get_config("gpt2-tiny", **plan["kw"], dtype=torch.float32)
with np.load(plan["params"]) as z:
    flat = {k: z[k] for k in z.files}
tree = {}
for k, v in flat.items():
    node = tree
    for p in k.split("/")[:-1]:
        node = node.setdefault(p, {})
    node[k.split("/")[-1]] = v

def batch(seed, uneven=False):
    ids = np.random.default_rng(seed).integers(0, 256, (8, 16)).astype(
        np.int32)
    b = {"input_ids": ids}
    if uneven:
        lab = ids.copy()
        lab[:3, 2:] = -100
        lab[5, 9:] = -100
        b["labels"] = lab
    return b

def engine(run):
    model = PipelinedTransformer(cfg, 2, 4, stage=stage,
                                 params=params_from_jax(tree))
    eng, *_ = ds.initialize(model=model, config=run["config"],
                            loss_fn=ttr.causal_lm_loss, device="cpu")
    return eng

res = {"rank": rank, "runs": {}}
for key, run in plan["runs"].items():
    eng = engine(run)
    o = {"held": sorted({n.split(".")[1] for n, _ in
                         eng.module.named_parameters()
                         if n.startswith("blocks.")}),
         "eval": eng.eval_batch(batch(plan["eval"])).tolist()}
    traj, ops = [], []
    for s in plan["seeds"]:
        ds.comm.reset_op_counts()
        m = eng.train_batch(batch(s, run.get("uneven", False)))
        ops.append(ds.comm.op_counts())
        traj.append([m["loss"], m["grad_norm"]])
    o["traj"], o["ops"] = traj, ops[0]
    o["shared"] = {n: hashlib.sha256(p.detach().numpy().tobytes())
                   .hexdigest() for n, p in eng.module.named_parameters()
                   if not n.startswith("blocks.")}
    if run.get("save"):
        ck = os.path.join(plan["dir"], key)
        eng.save_checkpoint(ck)
        sd = eng.module_state_dict()
        if rank == 0:
            np.savez(os.path.join(plan["dir"], key + "_state.npz"), **sd)
        m = eng.train_batch(batch(plan["after"]))
        o["after"] = [m["loss"], m["grad_norm"]]
        o["files"] = sorted(os.listdir(os.path.join(ck, "global_step3")))
    res["runs"][key] = o
if plan.get("one_rank_tag"):
    eng = engine({"config": plan["load_config"]})
    eng.load_checkpoint(plan["one_rank_tag"])
    m = eng.train_batch(batch(plan["after"]))
    res["loaded_step"] = [m["loss"], m["grad_norm"]]
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""


def _port_engine(schedule="1f1b", stage=0, pp=2):
    eng, *_ = tds.initialize(
        model=PipelinedTransformer(_tcfg(), pp, GAS),
        config=dict(_config(schedule, stage), pipeline={
            "schedule": schedule}),
        model_parameters=_params(), loss_fn=ttr.causal_lm_loss,
        device="cpu", dist_init_required=False)
    return eng


def _plain_engine(stage=0):
    eng, *_ = tds.initialize(
        model=ttr.Transformer(_tcfg(), seed=1),
        config={k: v for k, v in _config(stage=stage).items()
                if k != "pipeline"},
        model_parameters=_params(), loss_fn=ttr.causal_lm_loss,
        device="cpu", dist_init_required=False)
    return eng


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_two")
    np.savez(tmp / "params.npz", **_flat(_params()))
    # a 1-rank port tag (one step in), for the pp-2 load
    one = _plain_engine()
    one.train_batch(_batch(50))
    one.save_checkpoint(str(tmp / "one_rank"))
    plan = {"kw": KW, "params": str(tmp / "params.npz"), "dir": str(tmp),
            "seeds": SEEDS, "eval": 60, "after": 61,
            "one_rank_tag": str(tmp / "one_rank"),
            "load_config": _config(),
            "runs": {k: {"config": _config(r["schedule"], r["stage"]),
                         "uneven": r.get("uneven", False),
                         "save": r.get("save", False)}
                     for k, r in RUNS.items()}}
    (tmp / "plan.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, 2, tmp, "pp_two", args=[tmp / "plan.json"])
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    return {"dir": tmp, "ranks": ranks, "one": one}


_REF = {}


def _port_traj(key):
    if key not in _REF:
        run = RUNS[key]
        eng = _port_engine(run["schedule"], run["stage"])
        _REF[key] = np.array([[m["loss"], m["grad_norm"]] for m in (
            eng.train_batch(_batch(s, run.get("uneven", False)))
            for s in SEEDS)])
    return _REF[key]


def _jax_engine(schedule):
    piped, _ = jbuild_pipelined(_jcfg(), pp=2, n_micro=GAS)
    mm = jmesh.MeshManager(devices=jax.devices()[:2], pp_size=2)
    eng, *_ = jds.initialize(
        model=piped, config=_config(
            schedule, placement="mpmd" if schedule == "gpipe" else "spmd"),
        model_parameters=_params(), loss_fn=jtr.causal_lm_loss,
        example_batch=_batch(1), mesh_manager=mm)
    return eng


@pytest.mark.parametrize("key", sorted(RUNS))
def test_pp2_train_batch_matches_one_rank_port(two, key):
    ref = _port_traj(key)
    runs = [r["runs"][key] for r in two["ranks"]]
    assert [r["held"] for r in runs] == [["0", "1"], ["2", "3"]]
    for run in runs:
        np.testing.assert_allclose(np.array(run["traj"]), ref, rtol=1e-5)
        # one ppermute a tick and direction that any stage sends in
        assert run["ops"]["ppermute"] == 2 * GAS
    assert runs[0]["shared"] == runs[1]["shared"]
    assert ref[-1, 0] < ref[0, 0]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp2_train_batch_matches_jax_pipeline_engine(two, schedule):
    jeng = _jax_engine(schedule)
    jref = np.array([[float(m["loss"]), float(m["grad_norm"])]
                     for m in (jax.device_get(jeng.train_batch(_batch(s)))
                               for s in SEEDS)])
    np.testing.assert_allclose(
        np.array(two["ranks"][0]["runs"][schedule]["traj"]), jref,
        rtol=2e-4)


def test_uneven_labels_take_the_global_token_mean(two):
    """The default objective over uneven -100 labels is the whole batch's
    token mean (the plain engine's per-micro means differ)."""
    ref = _port_traj("uneven")
    plain = _plain_engine()
    b = _batch(SEEDS[0], uneven=True)
    logits = plain.module(torch.as_tensor(b["input_ids"]))
    whole = ttr.causal_lm_loss(logits, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
    np.testing.assert_allclose(ref[0, 0], float(whole.detach()), rtol=1e-5)
    assert abs(plain.train_batch(b)["loss"] - ref[0, 0]) > 1e-3


def test_eval_batch_gives_every_rank_the_logits(two):
    want = _port_engine().eval_batch(_batch(60)).numpy()
    for r in two["ranks"]:
        for run in r["runs"].values():
            np.testing.assert_allclose(np.array(run["eval"]), want,
                                       rtol=1e-5, atol=1e-6)


def test_pp2_tag_loads_into_one_rank_port_jax_and_zero_to_fp32(two):
    tmp = two["dir"]
    r0 = two["ranks"][0]["runs"]["gpipe"]
    assert r0["files"] == sorted(
        ["ckpt_meta.json", "meta.json"]
        + [f"{k}-shard{i}.npz" for k in ("model_states", "optim_states")
           for i in range(2)])
    with np.load(tmp / "gpipe_state.npz") as z:
        saved = {k: z[k] for k in z.files}
    assert saved["blocks/attn_qkv/kernel"].shape == (4, 64, 192)
    port = _plain_engine()
    port.load_checkpoint(str(tmp / "gpipe"))
    for k, v in port.module_state_dict().items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    m = port.train_batch(_batch(61))
    np.testing.assert_allclose([m["loss"], m["grad_norm"]], r0["after"],
                               rtol=1e-5)
    jeng = _jax_engine("1f1b")
    jeng.load_checkpoint(str(tmp / "gpipe"))
    for k, v in jeng.module_state_dict().items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), saved[k],
                                      err_msg=k)
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        convert_zero_checkpoint_to_fp32_state_dict
    sd = convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp / "gpipe"), str(tmp / "fp32.npz"))
    assert sorted(sd) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)


def test_one_rank_tag_loads_into_pp2(two):
    one = two["one"]
    m = one.train_batch(_batch(61))
    for r in two["ranks"]:
        np.testing.assert_allclose(r["loaded_step"],
                                   [m["loss"], m["grad_norm"]], rtol=1e-5)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_four")
    np.savez(tmp / "params.npz", **_flat(_params()))
    plan = {"kw": KW, "params": str(tmp / "params.npz"), "dir": str(tmp),
            "seeds": SEEDS, "eval": 60, "after": 61,
            "runs": {"data2": {"config": _config("1f1b", 1, micro=1),
                               "uneven": True}}}
    (tmp / "plan.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, 4, tmp, "pp_four", args=[tmp / "plan.json"])
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    return ranks


def test_pp2_by_data2_matches_one_rank_port(four):
    """Each micro-batch's rows split over two data ranks a stage: the
    trajectory (uneven labels, ZeRO 1) within rtol 1e-5 of the 1-rank
    port's on the same global batches."""
    ref = _port_traj("uneven")
    assert [r["runs"]["data2"]["held"] for r in four] == \
        [["0", "1"], ["0", "1"], ["2", "3"], ["2", "3"]]
    for r in four:
        np.testing.assert_allclose(np.array(r["runs"]["data2"]["traj"]),
                                   ref, rtol=1e-5)
    assert len({json.dumps(r["runs"]["data2"]["shared"], sort_keys=True)
                for r in four}) == 1
