"""Port parity: the training-integrity sentinel and the engine's
resilience hooks (``deepspeed_tpu_torch/runtime/{sentinel,engine}.py``)
against the JAX package, on the CPU.

* ``TrainingSentinel``: the same spike, non-finite and clean sequences
  through both packages' sentinels give the same verdict, the same
  anomaly text and the same skip ceiling step for step (the ladder cases
  of ``tests/test_sentinel.py``); ``compare_replica_checksums`` votes
  alike; the ``last_audited_clean`` marker crosses both ways;
* ``state_checksum`` equals the JAX engine's audit program on the same
  f32 / bf16 / int8 / bool leaves;
* the engine: a ``sentinel.spike`` run (a float per-sample weight scaled
  by the armed factor) skips and rolls back at the same steps as the JAX
  engine, with losses within ``tests/test_torch_training.py``'s
  trajectory tolerance (rtol 1e-4), the data position not rewound; an
  in-process emergency save (``install_preemption_handler``, rc 114) of
  either package loads into the other; ``fast_forward_dataloader`` gives
  the JAX engine's position (the two tests share one engine pair: one
  JAX compile); the watchdog, heartbeat and straggler
  sections and ``elasticity`` no longer raise;
* a 2-rank gloo SDC audit: a bit flipped on rank 1
  (``sentinel.sdc:flag:match=1``) loses the vote, rank 1 stamps the SDC
  flag and both ranks raise ``TrainingIntegrityError`` (rc 118).
"""

import dataclasses
import json
import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.config.config import IntegrityConfig as JIntegrity
from deepspeed_tpu.models import build_model as jbuild_model
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.mesh import MeshManager
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import sentinel as jsl
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.testing import chaos as jchaos

import deepspeed_tpu_torch
from deepspeed_tpu_torch.config.config import IntegrityConfig as TIntegrity
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime import sentinel as tsl
from deepspeed_tpu_torch.runtime.engine import state_checksum
from deepspeed_tpu_torch.testing import chaos

from test_torch_comm import _spawn


@pytest.fixture(autouse=True)
def _port_chaos(monkeypatch):
    # no session mesh: one left by an earlier test file would pin the
    # activations of these one-device JAX engines to its devices
    monkeypatch.setattr(jmesh, "_GLOBAL_MESH", None)
    chaos.reset_for_tests()
    with jax.default_matmul_precision("highest"):
        yield
    chaos.reset_for_tests()


# ------------------------------------------------------------- the ladder

def _pair(**kw):
    kw.setdefault("enabled", True)
    kw.setdefault("metrics", ["loss", "grad_norm"])
    kw.setdefault("window", 16)
    kw.setdefault("zmax", 5.0)
    kw.setdefault("warmup_steps", 4)
    kw.setdefault("cooldown_steps", 0)
    kw.setdefault("rollback_after", 2)
    kw.setdefault("strike_window", 10)
    kw.setdefault("abort_after_rollbacks", 1)
    return (jsl.TrainingSentinel(JIntegrity(**kw)),
            tsl.TrainingSentinel(TIntegrity(**kw)))


def _clean(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"loss": v, "grad_norm": v} for v in
            (1.0 + 0.01 * rng.standard_normal(n)).tolist()]


SPIKE = {"loss": 100.0, "grad_norm": 100.0}
SEQUENCES = {
    # strike, rollback (note_rollback), a clean stretch, a reproduced
    # spike after the rollback: the abort
    "strike_rollback_abort": (_clean(6) + [SPIKE, SPIKE] + ["rollback"] +
                              _clean(3, 1) + [SPIKE, SPIKE], {}),
    # one event counts once inside the cooldown
    "cooldown": (_clean(6) + [SPIKE] * 4 + _clean(2), {"cooldown_steps": 3}),
    # strikes age out of the window
    "window": (_clean(6) + [SPIKE] + _clean(12, 2) + [SPIKE],
               {"strike_window": 5, "rollback_after": 2}),
    # the in-step skip strikes, and the sample never enters the baseline
    "skip_flag": (_clean(6) + [dict(_clean(1)[0], anomaly_skip=1.0,
                                    overflow=1.0)] + _clean(3, 3), {}),
    # non-finite values strike; the streak bound raises NonFiniteError
    "nonfinite": (_clean(5) + [{"loss": math.nan, "grad_norm": 1.0}] +
                  [{"loss": 1.0, "grad_norm": 1.0, "nonfinite_streak": s}
                   for s in (1, 2, 3)], {"nonfinite_abort_after": 3}),
    # detector off: inert, but the streak abort still holds
    "disabled": (_clean(3) + [SPIKE, {"loss": 1.0, "nonfinite_streak": 2}],
                 {"enabled": False, "nonfinite_abort_after": 2}),
    # a clean stretch after a rollback retires the abort arm
    "rollback_retired": (_clean(6) + [SPIKE, SPIKE, "rollback"] +
                         _clean(14, 4) + [SPIKE, SPIKE],
                         {"strike_window": 10}),
}


def _walk(sent, seq):
    out = []
    for step, host in enumerate(seq):
        if host == "rollback":
            sent.note_rollback(step)
            out.append(("rollback", sent.rollbacks_done))
            continue
        lim = sent.spike_limit()
        try:
            v = sent.observe(step, host)
        except jsl.TrainingIntegrityError.__mro__[1] as e:
            out.append((type(e).__name__, str(e), getattr(e, "exit_code",
                                                          None)))
            break
        out.append((v, sent.last_anomaly, lim, len(sent.strikes),
                    sent.accepted))
    return out


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sentinel_verdicts_equal_jax(name):
    seq, kw = SEQUENCES[name]
    j, t = _pair(**kw)
    assert _walk(t, seq) == _walk(j, seq)
    assert t.metric_keys == j.metric_keys


def test_spike_limit_and_votes_equal_jax(tmp_path):
    for kw in ({}, {"skip": False}, {"metrics": ["loss"]},
               {"enabled": False}):
        j, t = _pair(**kw)
        for h in _clean(8):
            assert t.spike_limit() == j.spike_limit()
            j.observe(0, h), t.observe(0, h)
        assert t.spike_limit() == j.spike_limit()
    for pairs in ([("a", 1), ("b", 1), ("c", 2)], [("a", 1), ("b", 2)],
                  [("a", 5)], [], [("a", 3), ("b", 3), ("c", 3)],
                  [("a", 1), ("b", 2), ("c", 2), ("d", 1), ("e", 3)]):
        assert tsl.compare_replica_checksums(pairs) == \
            jsl.compare_replica_checksums(pairs)
    tsl.write_last_audited_clean(str(tmp_path), "global_step7")
    assert jsl.read_last_audited_clean(str(tmp_path)) == "global_step7"
    jsl.write_last_audited_clean(str(tmp_path), "global_step9")
    assert tsl.read_last_audited_clean(str(tmp_path)) == "global_step9"
    assert tsl.read_last_audited_clean(str(tmp_path / "none")) is None
    assert tsl.INTEGRITY_EXIT_CODE == jsl.INTEGRITY_EXIT_CODE == 118


def test_state_checksum_equals_jax_audit_program():
    rng = np.random.default_rng(7)
    leaves = [rng.standard_normal((5, 7)).astype(np.float32),
              rng.standard_normal(33).astype(np.float32),
              rng.integers(-128, 127, (3, 4)).astype(np.int8),
              rng.integers(0, 2, 9).astype(bool)]
    bf = rng.standard_normal((6, 6)).astype(np.float32)
    jfn = JEngine._make_audit_fn(None)
    want = int(jfn(tuple(jnp.asarray(x) for x in leaves) +
                   (jnp.asarray(bf, jnp.bfloat16),)))
    got = state_checksum([torch.from_numpy(x) for x in leaves] +
                         [torch.from_numpy(bf).to(torch.bfloat16)])
    assert got == want
    flipped = [torch.from_numpy(x.copy()) for x in leaves]
    flipped[0].view(-1).view(torch.uint8)[5] ^= 1
    assert state_checksum(flipped) != state_checksum(
        [torch.from_numpy(x) for x in leaves])


# ------------------------------------------------------------- the engines

KW = dict(hidden_size=32, num_layers=1, num_heads=4, vocab_size=64,
          max_seq_len=64, attention_impl="auto", dtype=jnp.float32)
_P = {}


def _cfgs():
    _, jcfg = jbuild_model("gpt2-tiny", **KW)
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f["dtype"] = torch.float32
    return jcfg, ttr.TransformerConfig(**f)


def _params():
    if "p" not in _P:
        jcfg, _ = _cfgs()
        p = jax.jit(jtr.Transformer(jcfg).init)(
            jax.random.PRNGKey(3),
            {"input_ids": np.zeros((1, 8), np.int32)})["params"]
        _P["p"] = jax.tree.map(np.asarray, jax.device_get(p))
    return _P["p"]


def _batch(step):
    rng = np.random.default_rng(100 + step % 3)
    return {"input_ids": rng.integers(0, 64, (8, 16)).astype(np.int32),
            "w": np.ones(8, np.float32)}


def _jloss(out, b):
    return jtr.causal_lm_loss(out, b) * jnp.mean(b["w"])


def _tloss(out, b):
    return ttr.causal_lm_loss(out, b) * b["w"].mean()


CFG = {"train_batch_size": 8, "gradient_accumulation_steps": 1,
       "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
       "gradient_clipping": 1.0, "steps_per_print": 1000,
       "integrity": {"enabled": True, "metrics": ["loss", "grad_norm"],
                     "window": 8, "warmup_steps": 3, "zmax": 50.0,
                     "cooldown_steps": 0, "rollback_after": 2,
                     "strike_window": 20}}


def _engines(cfg=CFG):
    jcfg, tcfg = _cfgs()
    jeng, *_ = deepspeed_tpu.initialize(
        model=jtr.Transformer(jcfg), config=cfg, model_parameters=_params(),
        loss_fn=_jloss, mesh_manager=MeshManager(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=cfg, model_parameters=_params(),
        loss_fn=_tloss, device="cpu")
    return jeng, teng


_SHARED = {}


def _shared_engines():
    """The spike test's engine pair, which the emergency-save test then
    takes over (one JAX engine built and compiled for both)."""
    if "pair" not in _SHARED:
        _SHARED["pair"] = _engines()
    return _SHARED["pair"]


def test_spike_skip_and_rollback_steps_equal_jax_engine(tmp_path):
    _SHARED.pop("pair", None)
    jeng, teng = _shared_engines()
    rows = {"jax": [], "port": []}
    for step in range(9):
        if step == 5:
            jeng.save_checkpoint(str(tmp_path / "j"))
            teng.save_checkpoint(str(tmp_path / "t"))
            # steps 6 and 7 are poisoned: skip + strike, skip + rollback
            jchaos.arm("sentinel.spike", "flag", times=2, factor=1000)
            chaos.arm("sentinel.spike", "flag", times=2, factor=1000)
        for key, eng in (("jax", jeng), ("port", teng)):
            m = eng.train_batch(_batch(step))
            if key == "jax":
                m = jax.device_get(m)
            rows[key].append({
                "loss": float(m["loss"]),
                "skip": bool(m.get("anomaly_skip", False)),
                "verdict": eng.sentinel.last_verdict,
                "rollbacks": eng.sentinel.rollbacks_done,
                "global_steps": eng.global_steps,
                "data_position": eng.data_position})
    jchaos.reset_for_tests()
    for j, t in zip(rows["jax"], rows["port"]):
        np.testing.assert_allclose(t.pop("loss"), j.pop("loss"), rtol=1e-4)
        assert t == j
    verdicts = [r["verdict"] for r in rows["port"]]
    assert verdicts[5:7] == [tsl.STRIKE, tsl.ROLLBACK]
    assert [r["skip"] for r in rows["port"]][5:7] == [True, True]
    # rolled back to step 5; the poisoned span is not replayed
    assert rows["port"][6]["global_steps"] == 5
    assert rows["port"][6]["data_position"] == 7
    assert teng.skipped_steps == 0          # the restored tag's count
    dl_t = tdl.DeepSpeedDataLoader([np.asarray([i]) for i in range(64)],
                                   batch_size=4)
    dl_j = jdl.DeepSpeedDataLoader([np.asarray([i]) for i in range(64)],
                                   batch_size=4)
    assert teng.fast_forward_dataloader(dl_t) == \
        jeng.fast_forward_dataloader(dl_j) == teng.data_position
    np.testing.assert_array_equal(next(iter(dl_t)), next(iter(dl_j)))


def test_emergency_save_crosses_both_ways(tmp_path):
    jeng, teng = _shared_engines()
    for step in range(3):
        jeng.train_batch(_batch(step))
        teng.train_batch(_batch(step))
    assert jeng.global_steps == teng.global_steps
    tag = f"global_step{teng.global_steps}"
    saved = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    codes = []
    try:
        handler = teng.install_preemption_handler(
            str(tmp_path / "t"), exit_fn=codes.append)
        handler(signal.SIGTERM)
        jhandler = jeng.install_preemption_handler(
            str(tmp_path / "j"), exit_fn=codes.append)
        jhandler(signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, saved[0])
        signal.signal(signal.SIGINT, saved[1])
    assert codes == [114, 114]
    meta = json.loads((tmp_path / "t" / tag / "meta.json").read_text())
    assert meta["client_state"]["preempted"] is True
    # the port's tag into the JAX engine (its own state kept for the other
    # direction), the JAX tag into a fresh port engine
    jeng_sd = {k: np.asarray(v, np.float32)
               for k, v in jeng.module_state_dict().items()}
    _, tcfg = _cfgs()
    tnew, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), loss_fn=_tloss, device="cpu",
        config=CFG)
    jeng.load_checkpoint(str(tmp_path / "t"))
    tnew.load_checkpoint(str(tmp_path / "j"))
    for got, want in ((jeng.module_state_dict(), teng.module_state_dict()),
                      (tnew.module_state_dict(), jeng_sd)):
        for k, v in want.items():
            np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                       np.asarray(v, np.float32),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert jeng.global_steps == tnew.global_steps == teng.global_steps
    jm = jax.device_get(jeng.train_batch(_batch(3)))
    tm = teng.train_batch(_batch(3))
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)


@pytest.mark.parametrize("where", ["micro", "optimizer"])
def test_preemption_inside_a_step_saves_at_its_end(tmp_path, where):
    """A SIGTERM inside a step (from micro-batch 1's loss of 2, or just
    before the optimizer's update) saves nothing torn and does not lose
    the save: the handler waits for the step's end, then writes an
    intact tag of that step and exits 114. A fresh engine loaded from the
    tag holds the signalled engine's state and takes the same next
    step."""
    _, tcfg = _cfgs()
    cfg = dict(CFG, gradient_accumulation_steps=2)
    calls = {"loss": 0, "update": 0}

    def loss_fn(out, b):
        calls["loss"] += 1
        if where == "micro" and calls["loss"] == 4:     # step 2, micro 1
            os.kill(os.getpid(), signal.SIGTERM)
        return _tloss(out, b)

    teng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=cfg, model_parameters=_params(),
        loss_fn=loss_fn, device="cpu")
    update = teng.optimizer.update

    def update_then_signal(*a, **kw):
        calls["update"] += 1
        if where == "optimizer" and calls["update"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return update(*a, **kw)

    teng.optimizer = teng.optimizer._replace(update=update_then_signal)
    saved = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    codes = []
    ck = str(tmp_path / "ck")
    try:
        teng.install_preemption_handler(ck, exit_fn=codes.append)
        teng.train_batch(_batch(0))
        assert codes == []
        teng.train_batch(_batch(1))
    finally:
        signal.signal(signal.SIGTERM, saved[0])
        signal.signal(signal.SIGINT, saved[1])
    assert codes == [114]
    from deepspeed_tpu_torch.runtime import checkpointing as ckl
    assert ckl.get_latest_tag(ck) == "global_step2"
    assert ckl.verify_tag(os.path.join(ck, "global_step2")) is None
    fresh, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), config=cfg, model_parameters=_params(),
        loss_fn=_tloss, device="cpu")
    fresh.load_checkpoint(ck)
    assert fresh.global_steps == teng.global_steps == 2
    for k, v in teng.module_state_dict().items():
        torch.testing.assert_close(fresh.module_state_dict()[k], v,
                                   rtol=0, atol=0, msg=k)
    assert fresh.train_batch(_batch(2))["loss"] == \
        teng.train_batch(_batch(2))["loss"]


def test_resilience_sections_are_ported(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_HEARTBEAT_DIR", str(tmp_path / "hb"))
    _, tcfg = _cfgs()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=ttr.Transformer(tcfg), device="cpu",
        loss_fn=ttr.causal_lm_loss,
        config={"train_batch_size": 8, "steps_per_print": 1000,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "watchdog": {"stall_timeout": 30.0, "compile_timeout": 30.0},
                "straggler": {"enabled": True},
                "elasticity": {"enabled": True, "max_train_batch_size": 8,
                               "micro_batch_sizes": [8]},
                "integrity": {"audit_interval": 1}})
    assert eng.watchdog is not None and eng.straggler is not None
    eng.train_batch({"input_ids": _batch(0)["input_ids"]})
    eng.save_checkpoint(str(tmp_path / "ck"))
    eng.train_batch({"input_ids": _batch(1)["input_ids"]})
    # a clean audit marks the newest tag; a tag=None resume prefers it
    assert tsl.read_last_audited_clean(str(tmp_path / "ck")) == \
        "global_step1"
    eng.close()
    from deepspeed_tpu_torch.runtime import heartbeat as hb
    rec = hb.read_heartbeats(str(tmp_path / "hb"))[0]
    assert rec["phase"] == hb.PHASE_EXIT and rec["step"] == 2
    assert eng.watchdog.fired is False


SDC_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.runtime import heartbeat as hb
from deepspeed_tpu_torch.runtime.sentinel import TrainingIntegrityError

# keyed by rank; the second audit's traversal fires
os.environ["DSTPU_CHAOS"] = "sentinel.sdc:flag:match=1:skip=1"
ds.comm.init_distributed(device="cpu")
rank = ds.comm.get_rank()
cfg = ttr.get_config("gpt2-tiny", hidden_size=32, num_layers=1, num_heads=2,
                     vocab_size=64, max_seq_len=32, dtype=torch.float32)
eng, *_ = ds.initialize(
    model=ttr.Transformer(cfg, seed=0), loss_fn=ttr.causal_lm_loss,
    device="cpu", config={
        "train_batch_size": 4, "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "integrity": {"audit_interval": 2}})
res = {"rank": rank, "steps": 0}
ids = np.random.default_rng(0).integers(0, 64, (4, 16))
ds.comm.reset_op_counts()
try:
    for _ in range(4):
        eng.train_batch({"input_ids": ids})
        res["steps"] = eng.global_steps
except TrainingIntegrityError as e:
    res["error"], res["code"] = str(e), e.exit_code
res["gathers"] = ds.comm.op_counts().get("all_gather", 0)
res["flags"] = hb.read_heartbeats(os.environ["DSTPU_HEARTBEAT_DIR"]).get(
    rank, {}).get("flags")
print("RESULT " + json.dumps(res), flush=True)
"""


def test_two_rank_sdc_audit_flags_the_flipped_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_HEARTBEAT_DIR", str(tmp_path / "hb"))
    outs = _spawn(SDC_WORKER, 2, tmp_path, "sdc")
    ranks = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        ranks.append(json.loads([ln for ln in out.splitlines()
                                 if ln.startswith("RESULT ")][-1][7:]))
    # the first audit (step 2) is clean; the flip lands at the second.
    # Two replicas that disagree have no majority: the JAX vote implicates
    # both (the mismatch is certain, the culprit is not), so both stamp
    # SDC, the flipped rank among them
    want = jsl.compare_replica_checksums([("proc0/dev0", 1),
                                          ("proc1/dev0", 2)])
    for r in ranks:
        assert r["steps"] == 3 and r["code"] == 118
        assert f"implicated: {want}" in r["error"]
        assert r["gathers"] == 2
    assert ranks[1]["flags"] == ["SDC"]
    assert ranks[0]["flags"] == (["SDC"] if "proc0/dev0" in want else None)
