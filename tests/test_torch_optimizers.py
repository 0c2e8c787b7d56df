"""Port parity: LAMB, SGD (momentum, Nesterov) and Adagrad against the JAX
package, on the CPU.

* one optimizer's updates, three in a row on the same numpy leaves
  (including a zero leaf, whose LAMB trust ratio is 1), against the JAX
  ``update``: parameters and state rtol 1e-6 (atol 1e-7);
* 12-step ``initialize`` + ``train_batch`` trajectories (gas 2, WarmupLR,
  clipping, the llama shape of ``test_torch_training``) against the JAX
  engine: loss rtol 1e-4, grad norm rtol 1e-3, as for AdamW there;
* LAMB at ZeRO 2 over two gloo ranks, each holding half of every
  splittable master, against the 1-rank engine (rtol 1e-5): the trust
  ratio's norms are the whole tensors' only if the slabs' squared norms
  are summed over the group;
* each optimizer's checkpoint saved by one package and resumed by the
  other: state bit-exact, then 4 steps side by side (the trajectory
  tolerances).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.ops import optimizers as topt

from test_torch_comm import _spawn
from test_torch_sequence_parallel import WORKER, _fields, _flat
from test_torch_training import _TRAIN_CFG, _batch, _cfgs, _params

OPTS = {
    "lamb": ("LAMB", dict(lr=2e-2, weight_decay=0.01)),
    "sgd": ("SGD", dict(lr=5e-2)),
    "sgd_momentum": ("SGD", dict(lr=5e-2, momentum=0.9, weight_decay=1e-3)),
    "sgd_nesterov": ("SGD", dict(lr=5e-2, momentum=0.9, nesterov=True)),
    "adagrad": ("Adagrad", dict(lr=5e-2, weight_decay=1e-3)),
}


@pytest.fixture(autouse=True)
def _precise(monkeypatch):
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


def _build(pkg, key):
    name, kw = OPTS[key]
    return getattr(pkg, name.lower())(**kw)


@pytest.mark.parametrize("key", sorted(OPTS))
def test_update_matches_jax(key):
    rng = np.random.default_rng(7)
    shapes = [(7, 5), (5,), (3, 2, 4), (4,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params[-1][:] = 0.0                 # LAMB: |p| = 0, trust ratio 1
    jo, to = _build(jopt, key), _build(topt, key)
    jp = [jnp.asarray(p) for p in params]
    js = jo.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = to.init(tp)
    assert sorted(ts) == sorted(js)
    lr = OPTS[key][1]["lr"]
    for step in range(3):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jp, js = jo.update([jnp.asarray(x) for x in g], js, jp,
                           jnp.asarray(step, jnp.int32),
                           lr_t=jnp.asarray(lr * 0.9 ** step))
        tp, ts = to.update([torch.from_numpy(x) for x in g], ts, tp, step,
                           lr_t=lr * 0.9 ** step)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for slot in js:
        for a, b in zip(ts[slot], js[slot]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=slot)


def _config(key, **extra):
    name, kw = OPTS[key]
    return dict(_TRAIN_CFG, optimizer={"type": name, "params": kw}, **extra)


def _engines(key):
    jcfg, tcfg = _cfgs("llama")
    jeng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=_config(key),
        model_parameters=_params("llama"), loss_fn=jtr.causal_lm_loss,
        mesh_manager=MeshManager(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=_config(key),
        model_parameters=_params("llama"), loss_fn=ttr.causal_lm_loss,
        device="cpu")
    return jeng, teng


def _side_by_side(jeng, teng, steps, seed0):
    losses = []
    for s in range(steps):
        batch = _batch(8, 16, seed=seed0 + s % 3)
        jm = jax.device_get(jeng.train_batch(batch))
        tm = teng.train_batch(batch)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        losses.append(tm["loss"])
    return losses


@pytest.mark.parametrize("key", sorted(OPTS))
def test_train_batch_trajectory_matches_jax_engine(key):
    jeng, teng = _engines(key)
    assert teng.optimizer.name == OPTS[key][0].lower()
    losses = _side_by_side(jeng, teng, 12, 100)
    assert losses[-1] < losses[0]


def test_lamb_zero2_two_ranks_match_one_rank(tmp_path):
    cfg = _config("lamb", zero_optimization={"stage": 2})
    del cfg["train_micro_batch_size_per_gpu"]       # 2 a rank at 2 ranks
    np.savez(tmp_path / "llama.npz", **_flat(_params("llama")))
    plan = {"tb": 8, "seq": 16, "steps": 6, "attention": False,
            "train": {"lamb": {"arch": "llama", "cfg": _fields("llama"),
                               "ds": cfg,
                               "params": str(tmp_path / "llama.npz")}}}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    outs = _spawn(WORKER, 2, tmp_path, "lamb_worker",
                  args=[tmp_path / "plan.json"])
    _, tcfg = _cfgs("llama")
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=cfg,
        model_parameters=_params("llama"), loss_fn=ttr.causal_lm_loss,
        device="cpu")
    ref = np.array([[m["loss"], m["grad_norm"]] for m in (
        teng.train_batch(_batch(8, 16, seed=100 + s % 3))
        for s in range(6))])
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res = json.loads(line[-1][len("RESULT "):])
        assert res["train"]["lamb"]["batch"] == [2, res["rank"]]
        np.testing.assert_allclose(np.array(res["train"]["lamb"]["traj"]),
                                   ref, rtol=1e-5)
        assert res["ops"]["all_reduce"] >= 6 * 2   # stats + norms a step


@pytest.mark.parametrize("key", ["lamb", "sgd_momentum", "adagrad"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_crosses_packages(key, direction, tmp_path):
    from deepspeed_tpu.runtime import checkpointing as jck
    jeng, teng = _engines(key)
    src = teng if direction == "port_to_jax" else jeng
    for s in range(3):
        src.train_batch(_batch(8, 16, seed=s))
    d = str(tmp_path / "ck")
    src.save_checkpoint(d)
    fresh_j, fresh_t = _engines(key)
    if direction == "port_to_jax":
        jeng = fresh_j
        jeng.load_checkpoint(d)
    else:
        teng = fresh_t
        teng.load_checkpoint(d)
    files = jck.read_flat_npz(os.path.join(d, "global_step3",
                                           "optim_states.npz"))
    slots = {"lamb": ("m", "v"), "sgd_momentum": ("momentum",),
             "adagrad": ("sum",)}[key]
    params, _, moments = teng._ckpt_leaves()
    assert sorted({k.split("/")[0] for k in moments}) == sorted(slots)
    for k, leaf in moments.items():
        np.testing.assert_array_equal(leaf.read().numpy(),
                                      np.asarray(files["opt_state/" + k]),
                                      err_msg=k)
    jsd = jeng.module_state_dict()
    for k, leaf in params.items():
        np.testing.assert_array_equal(leaf.read().numpy(),
                                      np.asarray(jsd[k]), err_msg=k)
    _side_by_side(jeng, teng, 4, 50)
