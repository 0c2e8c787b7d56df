"""Port parity: checkpoints that cross between deepspeed_tpu_torch and the
JAX package, on the CPU.

The same flax-initialized weights and numpy-seeded batches as
``tests/test_torch_training.py`` (its helpers): a gpt2-style and a
llama-style GQA model, 2 layers, f32 compute, trained by both engines
under the three precisions of the engine (bf16 compute + fp32 master,
fp32 with the master aliasing the parameters, pure bf16). Tolerances:

* the npz format: every leaf bit-exact, bf16 as ``torch.bfloat16``, in
  the three directions (port -> port, JAX ``write_flat_npz`` -> port,
  port -> JAX ``read_flat_npz``), key sets equal;
* a JAX checkpoint loaded into the port: parameters, master and both
  moments bit-exact, f32 logits atol 1e-5, then 5 ``train_batch`` steps
  against the JAX engine continuing (loss rtol 1e-4, grad norm rtol 1e-3,
  lr rtol 1e-6, the trajectory tolerances of test_torch_training.py); a
  port checkpoint loaded into the JAX engine the same way;
* a port save -> load -> 12 steps equals the uninterrupted 12 exactly;
* ``InferenceEngine.load_checkpoint``: logits against the JAX engine
  loading the same file, atol 1e-5 (f32) and 1e-4 (int8, as
  test_torch_generation.py's int8 engine).
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import inspect_checkpoint as jinspect
from deepspeed_tpu.inference.engine import InferenceEngine as JInferenceEngine
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager
from deepspeed_tpu.runtime import checkpointing as jck
from deepspeed_tpu.utils import zero_to_fp32 as jz2f

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import (DeepSpeedCheckpoint,
                                            inspect_checkpoint)
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime import checkpointing as tck
from deepspeed_tpu_torch.utils import zero_to_fp32 as tz2f

from test_torch_training import _TRAIN_CFG, _batch, _cfgs, _params

PRECISIONS = {"bf16_master": {"bf16": {"enabled": True}},
              "fp32": {},
              "pure_bf16": {"bf16": {"enabled": True,
                                     "master_weights": False}}}


@pytest.fixture(autouse=True)
def _precise_matmuls(monkeypatch):
    # no session mesh: one left by an earlier test file would pin the
    # activations of these one-device engines to its devices
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    with jax.default_matmul_precision("highest"):
        yield


def _config(prec, **extra):
    return dict(_TRAIN_CFG, **PRECISIONS[prec], **extra)


def _jax_engine(arch, cfg):
    jcfg, _ = _cfgs(arch)
    eng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=cfg,
        model_parameters=_params(arch), loss_fn=jtr.causal_lm_loss,
        mesh_manager=MeshManager(devices=jax.devices()[:1]))
    return eng


def _port_engine(arch, cfg, from_jax=True, seed=5):
    _, tcfg = _cfgs(arch)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg, seed=seed), config=cfg,
        model_parameters=_params(arch) if from_jax else None,
        loss_fn=ttr.causal_lm_loss, device="cpu")
    return eng


def _bits(x):
    """Comparable bits of a numpy / ml_dtypes / torch leaf."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16), "bfloat16"
    return x, str(x.dtype)


def _assert_same_bits(got, want, label):
    (g, gd), (w, wd) = _bits(got), _bits(want)
    assert gd == wd, f"{label}: dtype {gd} vs {wd}"
    np.testing.assert_array_equal(g, w, err_msg=label)


def _port_leaves(eng):
    """The port engine's checkpoint view as {file key: host tensor}."""
    params, master, moments = eng._ckpt_leaves()
    out = {f"model/{k}": v.read() for k, v in params.items()}
    out.update({f"optim/master/{k}": v.read()
                for k, v in (master or {}).items()})
    out.update({f"optim/opt_state/{k}": v.read() for k, v in moments.items()})
    return out


def _jax_files(tag_dir):
    out = {f"model/{k}": v for k, v in jck.read_flat_npz(
        os.path.join(tag_dir, "model_states.npz")).items()}
    out.update({f"optim/{k}": v for k, v in jck.read_flat_npz(
        os.path.join(tag_dir, "optim_states.npz")).items()})
    return out


def _continue(jeng, teng, steps, seed0):
    for s in range(steps):
        batch = _batch(8, 16, seed=seed0 + s)
        jm = jax.device_get(jeng.train_batch(batch))
        tm = teng.train_batch(batch)
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert tm["overflow"] == bool(jm["overflow"]) is False
    assert teng.global_steps == jeng.global_steps
    np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)


# ------------------------------------------------------------- npz format

_DTYPES = ("bfloat16", "float32", "float64", "float16", "int32", "int64",
           "int8", "uint8", "uint16", "bool")


def _leaves():
    rng = np.random.default_rng(0)
    out = {}
    for i, dt in enumerate(_DTYPES):
        x = rng.standard_normal((3, 5)) * 100
        if dt == "bool":
            out[f"g/{dt}"] = x > 0
        elif dt == "bfloat16":
            out[f"g/{dt}"] = x.astype(ml_dtypes.bfloat16)
        else:
            out[f"g/{dt}"] = x.astype(dt)
    out["scalar"] = np.asarray(7, np.int32)
    return out


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("direction", ["port_to_port", "jax_to_port",
                                       "port_to_jax"])
def test_flat_npz_round_trips_bit_exact(direction, tmp_path):
    leaves = _leaves()
    path = str(tmp_path / "x.npz")
    if direction == "jax_to_port":
        jck.write_flat_npz(leaves, path)
    else:
        tck.write_flat_npz({k: _as_torch(v) for k, v in leaves.items()},
                           path)
    got = (jck.read_flat_npz(path) if direction == "port_to_jax"
           else tck.read_flat_npz(path))
    assert sorted(got) == sorted(leaves)
    for k, v in leaves.items():
        _assert_same_bits(got[k], v if direction == "port_to_jax"
                          else _as_torch(v), k)
    if direction != "port_to_jax":
        assert got["g/bfloat16"].dtype == torch.bfloat16


# ------------------------------------------------------- JAX <-> port

@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_jax_checkpoint_loads_into_port_and_continues(arch, prec, tmp_path):
    cfg = _config(prec)
    jeng = _jax_engine(arch, cfg)
    for s in range(3):
        jeng.train_batch(_batch(8, 16, seed=s))
    d = str(tmp_path / "ck")
    jeng.save_checkpoint(d)
    teng = _port_engine(arch, cfg, from_jax=False)      # other weights
    teng.load_checkpoint(d)
    files = _jax_files(os.path.join(d, "global_step3"))
    leaves = _port_leaves(teng)
    assert sorted(leaves) == sorted(files)
    assert ("optim/master/wte/embedding" in files) == (prec == "bf16_master")
    for k, v in files.items():
        _assert_same_bits(leaves[k], v, k)
    assert (teng.step_count, teng.global_steps, teng.data_position) == \
        (3, 3, 3)
    if prec == "fp32":
        batch = _batch(2, 16, seed=50)
        np.testing.assert_allclose(
            teng.eval_batch(batch).numpy(),
            np.asarray(jeng.eval_batch(batch)), atol=1e-5, rtol=0)
    _continue(jeng, teng, 5, seed0=10)


@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_port_checkpoint_loads_into_jax_and_continues(prec, tmp_path):
    cfg = _config(prec)
    teng = _port_engine("llama", cfg)
    for s in range(3):
        teng.train_batch(_batch(8, 16, seed=s))
    d = str(tmp_path / "ck")
    teng.save_checkpoint(d, client_state={"note": "port"})
    jeng = _jax_engine("llama", cfg)
    _, client = jeng.load_checkpoint(d)
    assert client["note"] == "port" and client["global_steps"] == 3
    assert int(jax.device_get(jeng.state.step)) == 3
    files = _jax_files(os.path.join(d, "global_step3"))
    for k, v in _port_leaves(teng).items():
        _assert_same_bits(files[k], v, k)
    _continue(jeng, teng, 5, seed0=20)


@pytest.mark.parametrize("async_save", [False, True])
def test_port_save_load_then_12_steps_equal_uninterrupted(async_save,
                                                          tmp_path):
    cfg = _config("bf16_master",
                  checkpoint={"async_save": async_save, "keep_last": 1})
    a = _port_engine("gpt2", cfg)
    for s in range(3):
        a.train_batch(_batch(8, 16, seed=s))
    d = str(tmp_path / "ck")
    a.save_checkpoint(d)
    assert a.wait_for_checkpoints()
    # built the same way (the parameter order sets the grad norm's sum
    # order), holding the step-0 weights until the load
    b = _port_engine("gpt2", cfg)
    b.load_checkpoint(d)
    for s in range(12):
        batch = _batch(8, 16, seed=30 + s % 4)
        ma, mb = a.train_batch(batch), b.train_batch(batch)
        assert (ma["loss"], ma["grad_norm"], ma["lr"]) == \
            (mb["loss"], mb["grad_norm"], mb["lr"]), s
    for (ka, va), (kb, vb) in zip(_port_leaves(a).items(),
                                  _port_leaves(b).items()):
        assert ka == kb and torch.equal(va, vb), ka
    assert a.close() and b.close()


def test_sharded_jax_checkpoint_assembles_in_port(tmp_path):
    """A leaf sharded over the mesh's data axes, a replicated leaf and a
    replicated bf16 leaf, written as ``tests/test_checkpointing.py``
    writes them (``write_shard_npz``), reassemble whole in the port."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = MeshManager().mesh
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    bf = jnp.asarray(rng.standard_normal((8, 4)), jnp.bfloat16)
    tree = {"w": jax.device_put(jnp.asarray(w), NamedSharding(
                mesh, P(("data", "expert", "seq"), None))),
            "b": jax.device_put(jnp.asarray(b), NamedSharding(mesh, P())),
            "h": jax.device_put(bf, NamedSharding(mesh, P()))}
    jck.write_shard_npz(tree, str(tmp_path / "model_states-shard0.npz"))
    out = tck.load_sharded_tree(str(tmp_path), "model_states",
                                expected_shards=1)
    assert sorted(out) == ["b", "h", "w"]
    _assert_same_bits(out["w"], w, "w")
    _assert_same_bits(out["b"], b, "b")
    _assert_same_bits(out["h"], np.asarray(bf), "h")
    # into live tensors through Leaves, shapes checked
    live = tck.Leaf([torch.zeros(8) for _ in range(16)], stacked=True)
    tck.load_sharded_tree(str(tmp_path), "model_states", like={"w": live})
    assert torch.equal(torch.stack(live.parts), torch.from_numpy(w))
    with pytest.raises(FileNotFoundError, match="expected 2"):
        tck.load_sharded_tree(str(tmp_path), "model_states",
                              expected_shards=2)


def test_load_module_only_and_load_module_state_dict(tmp_path):
    cfg = _config("bf16_master")
    a = _port_engine("llama", cfg)
    for s in range(2):
        a.train_batch(_batch(8, 16, seed=s))
    d = str(tmp_path / "ck")
    a.save_checkpoint(d)
    b = _port_engine("llama", cfg)              # the step-0 weights
    b.load_checkpoint(d, load_module_only=True)
    assert b.global_steps == 0 and b.get_lr() == [0.0]
    assert b.step_count == 2             # the optimizer state is restored
    for (_, pa), (_, pb) in zip(a.module.named_parameters(),
                                b.module.named_parameters()):
        assert torch.equal(pa, pb)
    # weights only: parameters and master follow, the moments do not
    c = _port_engine("llama", cfg)
    sd = a.module_state_dict()
    with pytest.raises(KeyError, match="missing"):
        c.load_module_state_dict({k: v for k, v in sd.items()
                                  if k != "wte/embedding"})
    c.load_module_state_dict(sd)
    for (_, pa), (_, pc), mc in zip(a.module.named_parameters(),
                                    c.module.named_parameters(), c.master):
        assert torch.equal(pa, pc)
        assert torch.equal(mc, pa.float())
    assert all(not m.any() for m in c.opt_state["m"])
    c.load_module_state_dict({"wte/embedding": sd["wte/embedding"] * 0},
                             strict=False)
    wte = [id(p) for p in c._params].index(id(c.module.wte.embedding))
    assert not c.module.wte.embedding.any() and not c.master[wte].any()
    # the JAX engine takes the port's state dict and gives it back
    jeng = _jax_engine("llama", cfg)
    jeng.load_module_state_dict(sd)
    jsd = jeng.module_state_dict()
    assert sorted(jsd) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(np.asarray(jsd[k], np.float32), sd[k],
                                      err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("source", ["16bit_model", "model_states"])
def test_inference_engine_load_checkpoint_matches_jax(dtype, source,
                                                      tmp_path):
    teng = _port_engine("llama", _config("fp32"))
    for s in range(2):
        teng.train_batch(_batch(8, 16, seed=s))
    if source == "16bit_model":
        path = teng.save_16bit_model(str(tmp_path))
    else:
        path = os.path.join(teng.save_checkpoint(str(tmp_path / "ck")),
                            "model_states.npz")
    jcfg, tcfg = _cfgs("llama")
    jp = _params("llama")
    jinf = JInferenceEngine(jtr.Transformer(jcfg), {"dtype": dtype},
                            model_parameters=jp).load_checkpoint(path)
    tinf = deepspeed_tpu_torch.init_inference(
        tcfg, {"dtype": dtype}, model_parameters=params_from_jax(jp),
        device="cpu")
    assert tinf.load_checkpoint(path) is tinf
    ids = _batch(2, 12, seed=7)["input_ids"]
    got = tinf.forward({"input_ids": ids}).numpy()
    np.testing.assert_allclose(got, np.asarray(jinf.forward(
        {"input_ids": ids})), atol=1e-5 if dtype == "float32" else 1e-4,
        rtol=0)
    if dtype == "float32":      # the loaded weights are the trained ones
        np.testing.assert_allclose(got, teng.eval_batch(
            {"input_ids": ids}).numpy(), atol=1e-5, rtol=0)
    else:
        assert tinf.params["blocks"]["attn_qkv"]["kernel"].dtype == \
            torch.int8


def test_inspect_checkpoint_and_zero_to_fp32_agree_across_packages(
        tmp_path, capsys):
    cfg = _config("bf16_master")
    jeng, teng = _jax_engine("llama", cfg), _port_engine("llama", cfg)
    for s in range(2):
        batch = _batch(8, 16, seed=s)
        jeng.train_batch(batch)
        teng.train_batch(batch)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jeng.save_checkpoint(jd)
    teng.save_checkpoint(td)
    for d in (jd, td):
        assert inspect_checkpoint(d) == jinspect(d)
    summary = inspect_checkpoint(td)
    assert summary["step"] == 2 and summary["dtypes"] == ["bfloat16"]
    assert summary == {**jinspect(jd), "tag": "global_step2"}
    ck = DeepSpeedCheckpoint(td)
    assert ck.parameter_names() == sorted(teng.module_state_dict())
    assert ck.get_parameter("wte/embedding").dtype == torch.bfloat16
    # zero_to_fp32: the CLI on either package's tag, against the other's
    for d in (jd, td):
        out_t, out_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
        tz2f.main([d, out_t])
        jz2f.convert_zero_checkpoint_to_fp32_state_dict(d, out_j)
        with np.load(out_t) as t, np.load(out_j) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in t.files:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert "fp32 tensors" in capsys.readouterr().out
    master = tck.consolidated_fp32_state_dict(teng._ckpt_state())
    with np.load(out_t) as t:
        for k, v in master.items():
            np.testing.assert_array_equal(t[k], v, err_msg=k)
    with open(os.path.join(td, "global_step2", "meta.json")) as f:
        assert json.load(f)["master_aliases_params"] is False
