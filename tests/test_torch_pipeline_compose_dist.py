"""The pipeline composed with the other axes across four gloo ranks on the
CPU: pp 2 x tp 2 (each stage's blocks, the embedding and the head as
Megatron shards), pp 2 x ep 2 under ZeRO-1 (a MoE model whose experts
split over each stage's expert group, the JAX ladder's configuration,
``tests/test_pipeline.py::test_ladder_zero1_pp_moe_ep_composition``) and
pp 2 x data 2 under ZeRO-3 (each stage's parameters sharded over its data
group and gathered around its ticks).

One spawn a mode (``test_torch_comm._spawn``: a ``file://`` rendezvous,
killed and failed past its own clock), from one flax-initialized tree
(hidden 64, 4 layers, vocab 256, 8 x 16 tokens, gas 4, 1F1B):

* two ``train_batch`` steps: the losses and grad norms, and every leaf
  after them, within 1e-5 of the 1-rank port's ``PipelineEngine`` (one
  process holding both stages; for ep a global mesh stands in for the
  expert group's gating groups) and 2e-4 of the JAX ``PipelineEngine``
  on the same pipe x model / pipe x expert / pipe x data mesh of four CPU
  devices (its 1F1B, which lowers on this host's jax with either axis);
* every rank's gathered state bitwise equal (the shared leaves agree over
  ``pipe``), and the counted collectives of a step;
* a sharded save: it loads into the 1-rank port, whose next step matches
  the spawn's, into the JAX engine and through ``zero_to_fp32``; and a
  1-rank port tag loads into the composed engine, whose next step matches
  the 1-rank engine's.
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
from deepspeed_tpu_torch.models.pipeline import PipelinedTransformer
from deepspeed_tpu_torch.parallel import mesh as tmesh

from test_torch_comm import _spawn

KW = dict(hidden_size=64, num_layers=4, num_heads=4, vocab_size=256,
          max_seq_len=64)
S, TB, GAS = 16, 8, 4
SEEDS = [40, 41]
AFTER = 61
MODES = {
    # pp 2 x tp 2: a llama-style model (GQA, untied head), ZeRO-1
    "tp": dict(kw=dict(KW, num_kv_heads=2, norm="rmsnorm", gated_mlp=True,
                       activation="silu", use_bias=False,
                       pos_embed="rotary", rotary_interleaved=False,
                       tie_embeddings=False),
               zero=1, micro=2, mesh=dict(tp_size=2),
               extra={"tensor_parallel": {"tp_size": 2}}, rules=True),
    # pp 2 x ep 2: gpt2-style MoE, ZeRO-1
    "ep": dict(kw=dict(KW, moe_experts=4, moe_capacity_factor=2.0),
               zero=1, micro=1, mesh=dict(ep_size=2),
               extra={"moe": {"enabled": True, "ep_size": 2}}, rules=True),
    # pp 2 x data 2: gpt2-style, ZeRO-3
    "zero3": dict(kw=dict(KW), zero=3, micro=1, mesh={}, extra={},
                  rules=False),
}


@pytest.fixture(autouse=True)
def _no_session_mesh(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    monkeypatch.setattr(tmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


def _jcfg(mode):
    return jtr.get_config("gpt2-tiny", **MODES[mode]["kw"],
                          dtype=jnp.float32, attention_impl="reference")


def _tcfg(mode):
    return ttr.get_config("gpt2-tiny", **MODES[mode]["kw"],
                          dtype=torch.float32)


_P = {}


def _params(mode):
    if mode not in _P:
        p = jax.jit(jtr.Transformer(_jcfg(mode)).init)(
            jax.random.PRNGKey(3),
            {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        _P[mode] = jax.tree.map(np.asarray, jax.device_get(p))
    return _P[mode]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, 256, (TB, S))
    return {"input_ids": ids.astype(np.int32)}


def _config(mode, world=4):
    m = MODES[mode]
    cfg = {"train_batch_size": TB, "gradient_accumulation_steps": GAS,
           # SGD with momentum: Adam would scale an element whose
           # gradient is rounding noise up to a step of lr, so its leaves
           # after a step would not compare element for element
           "optimizer": {"type": "SGD",
                         "params": {"lr": 0.05, "momentum": 0.9,
                                    "weight_decay": 0.01}},
           "gradient_clipping": 0.5, "steps_per_print": 100,
           # stage 3 shards every leaf, however small
           "zero_optimization": {"stage": m["zero"],
                                 "stage3_param_persistence_threshold": 0},
           "pipeline": {"stages": 2, "schedule": "1f1b"}}
    if world > 1:
        cfg.update(m["extra"], train_micro_batch_size_per_gpu=m["micro"])
    else:
        cfg.update(train_micro_batch_size_per_gpu=TB // GAS,
                   pipeline={"schedule": "1f1b"})
    return cfg


def _loss(mode, jax_side=False):
    mod = jtr if jax_side else ttr
    if MODES[mode]["kw"].get("moe_experts"):
        return mod.make_moe_loss(0.01)
    return mod.causal_lm_loss


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
stage = rank // 2                  # the mesh's order: pipe outermost
cfg = ttr.get_config("gpt2-tiny", **plan["kw"], dtype=torch.float32)
with np.load(plan["params"]) as z:
    flat = {k: z[k] for k in z.files}
tree = {}
for k, v in flat.items():
    node = tree
    for p in k.split("/")[:-1]:
        node = node.setdefault(p, {})
    node[k.split("/")[-1]] = v
moe = cfg.moe_experts > 0
loss_fn = ttr.make_moe_loss(0.01) if moe else ttr.causal_lm_loss

def batch(seed):
    ids = np.random.default_rng(seed).integers(0, 256, (8, 16))
    return {"input_ids": ids.astype(np.int32)}

def engine():
    model = PipelinedTransformer(cfg, 2, 4, stage=stage,
                                 params=params_from_jax(tree))
    eng, *_ = ds.initialize(
        model=model, config=plan["config"], loss_fn=loss_fn, device="cpu",
        sharding_rules=model.tp_rules() if plan["rules"] else None)
    return eng

eng = engine()
res = {"rank": rank, "traj": [], "ops": None}
for s in plan["seeds"]:
    ds.comm.reset_op_counts()
    m = eng.train_batch(batch(s))
    res["ops"] = ds.comm.op_counts()
    res["traj"].append([m["loss"], m["grad_norm"]] + (
        [m["aux"]] if moe else []))
res["held"] = sorted({n.split(".")[1] for n, _ in
                      eng.module.named_parameters()
                      if n.startswith("blocks.")})
res["shapes"] = {n: list(p.shape) for n, p in eng.module.named_parameters()
                 if n in ("wte.embedding", "blocks.0.attn_qkv.kernel",
                          "blocks.2.attn_qkv.kernel",
                          "blocks.0.moe.experts.fc.kernel",
                          "blocks.2.moe.experts.fc.kernel")}
sd = eng.module_state_dict()
res["hash"] = hashlib.sha256(b"".join(
    k.encode() + sd[k].tobytes() for k in sorted(sd))).hexdigest()
if rank == 0:
    np.savez(os.path.join(plan["dir"], "state.npz"), **sd)
ck = os.path.join(plan["dir"], "ckpt")
eng.save_checkpoint(ck)
m = eng.train_batch(batch(plan["after"]))
res["after"] = [m["loss"], m["grad_norm"]]
res["files"] = sorted(os.listdir(os.path.join(ck, "global_step2")))
eng = engine()
eng.load_checkpoint(plan["one_rank_tag"])
m = eng.train_batch(batch(plan["after"]))
res["loaded_step"] = [m["loss"], m["grad_norm"]]
print("RESULT " + json.dumps(res), flush=True)
torch.distributed.destroy_process_group()
"""


def _one_rank(mode):
    """The 1-rank port's PipelineEngine (one process, both stages); for
    a MoE model under a global mesh of the spawn's shape, so its gating
    groups are the expert group's."""
    if MODES[mode]["kw"].get("moe_experts"):
        tmesh.set_global_mesh(tmesh.MeshManager(
            devices=range(4), pp_size=2, **MODES[mode]["mesh"]))
    eng, *_ = tds.initialize(
        model=PipelinedTransformer(_tcfg(mode), 2, GAS),
        config=_config(mode, world=1), model_parameters=_params(mode),
        loss_fn=_loss(mode), device="cpu", dist_init_required=False)
    return eng


def _jax_engine(mode):
    piped, _ = jbuild_pipelined(_jcfg(mode), pp=2, n_micro=GAS)
    mm = jmesh.MeshManager(devices=jax.devices()[:4], pp_size=2,
                           **MODES[mode]["mesh"])
    jmesh.set_global_mesh(mm)
    eng, *_ = jds.initialize(
        model=piped, config=_config(mode), model_parameters=_params(mode),
        loss_fn=_loss(mode, jax_side=True), example_batch=_batch(1),
        mesh_manager=mm, sharding_rules=piped.tp_rules())
    return eng


_RUNS = {}


def _run(mode, tmp_path_factory):
    """The spawn of ``mode`` and the 1-rank port's run beside it."""
    if mode in _RUNS:
        return _RUNS[mode]
    tmp = tmp_path_factory.mktemp(f"pp_{mode}")
    np.savez(tmp / "params.npz", **_flat(_params(mode)))
    one = _one_rank(mode)
    one.train_batch(_batch(50))
    one.save_checkpoint(str(tmp / "one_rank"))
    loaded = one.train_batch(_batch(AFTER))
    ref = _one_rank(mode)
    traj = [ref.train_batch(_batch(s)) for s in SEEDS]
    state = ref.module_state_dict()
    plan = {"kw": MODES[mode]["kw"], "params": str(tmp / "params.npz"),
            "dir": str(tmp), "seeds": SEEDS, "after": AFTER,
            "one_rank_tag": str(tmp / "one_rank"),
            "config": _config(mode), "rules": MODES[mode]["rules"]}
    (tmp / "plan.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, 4, tmp, f"pp_{mode}", args=[tmp / "plan.json"])
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    tmesh.set_global_mesh(None)
    _RUNS[mode] = {"dir": tmp, "ranks": ranks, "traj": traj,
                   "state": state, "loaded": loaded}
    return _RUNS[mode]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_composed_pipeline_matches_one_rank_port(mode, tmp_path_factory):
    run = _run(mode, tmp_path_factory)
    moe = bool(MODES[mode]["kw"].get("moe_experts"))
    want = np.array([[m["loss"], m["grad_norm"]] + ([m["aux"]] if moe
                                                    else [])
                     for m in run["traj"]])
    assert [r["held"] for r in run["ranks"]] == \
        [["0", "1"], ["0", "1"], ["2", "3"], ["2", "3"]]
    for r in run["ranks"]:
        np.testing.assert_allclose(np.array(r["traj"]), want, rtol=1e-5)
    # every rank's gathered state is the same: the shared leaves agree
    # over 'pipe', the shards over 'model' / 'expert' / 'data'
    assert len({r["hash"] for r in run["ranks"]}) == 1
    with np.load(run["dir"] / "state.npz") as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(run["state"])
    for k, v in run["state"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    ops = run["ranks"][0]["ops"]
    # one transfer a tick and direction that any stage sends in
    assert ops["ppermute"] == 2 * GAS
    shapes = run["ranks"][0]["shapes"]
    if mode == "tp":
        # each rank's heads (2 q + 1 kv of 4 + 2, head dim 16) and its
        # vocab rows
        assert shapes["blocks.0.attn_qkv.kernel"] == [64, 64]
        assert shapes["wte.embedding"] == [128, 64]
        assert ops["tp_reduce_from"] > 0
    if mode == "ep":
        # each rank's 2 of 4 experts; 4 all-to-alls a MoE layer and
        # micro-batch (2 forward, 2 backward; recompute: 2 more)
        assert shapes["blocks.0.moe.experts.fc.kernel"][0] == 2
        assert ops["all_to_all"] >= 4 * 2 * GAS
    if mode == "zero3":
        # the blocks' slabs over the data group, gathered around each
        # stage's ticks: at least a forward and a backward gather a leaf
        # and micro-batch
        qkv = shapes["blocks.0.attn_qkv.kernel"]
        assert qkv[0] * qkv[1] * 2 == 64 * 192
        assert ops["all_gather"] >= 2 * GAS * 2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_composed_pipeline_matches_jax_engine(mode, tmp_path_factory):
    run = _run(mode, tmp_path_factory)
    jeng = _jax_engine(mode)
    jref = np.array([[float(m["loss"]), float(m["grad_norm"])]
                     for m in (jax.device_get(jeng.train_batch(_batch(s)))
                               for s in SEEDS)])
    np.testing.assert_allclose(
        np.array(run["ranks"][0]["traj"])[:, :2], jref, rtol=2e-4)
    with np.load(run["dir"] / "state.npz") as z:
        got = {k: z[k] for k in z.files}
    for k, v in jeng.module_state_dict().items():
        np.testing.assert_allclose(got[k], np.asarray(v, np.float32),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_composed_tag_crosses_to_one_rank_jax_and_zero_to_fp32(
        mode, tmp_path_factory):
    run = _run(mode, tmp_path_factory)
    tmp = run["dir"]
    with np.load(tmp / "state.npz") as z:
        saved = {k: z[k] for k in z.files}
    r0 = run["ranks"][0]
    assert "meta.json" in r0["files"] and any(
        f.startswith("model_states-shard") for f in r0["files"])
    port = _one_rank(mode)
    port.load_checkpoint(str(tmp / "ckpt"))
    for k, v in port.module_state_dict().items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    m = port.train_batch(_batch(AFTER))
    tmesh.set_global_mesh(None)
    np.testing.assert_allclose([m["loss"], m["grad_norm"]], r0["after"],
                               rtol=1e-5)
    jeng = _jax_engine(mode)
    jeng.load_checkpoint(str(tmp / "ckpt"))
    for k, v in jeng.module_state_dict().items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), saved[k],
                                      err_msg=k)
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        convert_zero_checkpoint_to_fp32_state_dict
    sd = convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp / "ckpt"), str(tmp / "fp32.npz"))
    assert sorted(sd) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    # and the 1-rank tag loaded into the composed engine
    want = run["loaded"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["loaded_step"],
                                   [want["loss"], want["grad_norm"]],
                                   rtol=1e-5)
