"""Crash-safety of the port's checkpoints, on the CPU: the matrix of
``tests/test_chaos.py`` (spec parsing; a crash at every ``ckpt.*``
failpoint, then a resume from the newest intact tag; quarantine;
truncated, bit-flipped and explicitly requested corrupt tags; markerless
and legacy tags; retention through the config; the async writer's
bounded retries, failure isolation and idempotent close) against
``deepspeed_tpu_torch``'s engine and checkpoint modules.

Engines are a tiny port ``Transformer`` (2 layers, hidden 16) with Adam
and WarmupLR, shared per module. The subprocess leg that kills a save
mid-write is marked ``slow``; its tier-1 cousin is the raise-mode matrix
``test_crash_at_every_failpoint_then_resume``.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import AsyncCheckpointEngine
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.runtime import checkpointing as ck
from deepspeed_tpu_torch.testing import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = {"train_batch_size": 8,
       "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
       "scheduler": {"type": "WarmupLR",
                     "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                "warmup_num_steps": 10}}}

#: every named failpoint a save traverses, in execution order
SAVE_FAILPOINTS = ["ckpt.write", "ckpt.meta", "ckpt.digest", "ckpt.marker",
                   "ckpt.rename", "ckpt.latest"]


@pytest.fixture(autouse=True)
def _chaos_isolation():
    chaos.reset_for_tests()
    yield
    chaos.reset_for_tests()


def _engine(extra=None, seed=0):
    cfg = {**CFG, **(extra or {})}
    model, _ = ttr.build_model("gpt2-tiny", hidden_size=16, num_layers=2,
                               num_heads=2, vocab_size=32, max_seq_len=16,
                               dtype=torch.float32, seed=seed)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, loss_fn=ttr.causal_lm_loss, device="cpu")
    return engine


def random_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 32, (n, 8))}


def _step(engine):
    return engine.step_count


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One (trainer, resumer) engine pair and a two-tag checkpoint
    template for the whole module."""
    template = str(tmp_path_factory.mktemp("template") / "ck")
    builder = _engine()
    builder.train_batch(random_batch(8, seed=0))
    builder.save_checkpoint(template)               # global_step1
    builder.train_batch(random_batch(8, seed=1))
    builder.save_checkpoint(template)               # global_step2
    return {"trainer": _engine(), "resumer": _engine(seed=1),
            "template": template}


def _clone_template(shared, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(shared["template"], d)
    return d


# ---------------------------------------------------------------- failpoints

def test_chaos_spec_parsing_and_reset():
    fps = chaos.parse_spec("a:raise;b:kill:skip=3;c:raise:times=2:skip=1")
    assert set(fps) == {"a", "b", "c"}
    assert fps["b"].mode == "kill" and fps["b"].skip == 3
    assert fps["b"].code == chaos.KILL_EXIT_CODE == 13
    assert fps["c"].times == 2 and fps["c"].skip == 1
    for bad in ("nocolon", "a:explode", "a:kill:bogus=1"):
        with pytest.raises(ValueError):
            chaos.parse_spec(bad)
    chaos.arm("x", "raise", skip=1)
    chaos.failpoint("x")                     # skipped hit
    with pytest.raises(chaos.ChaosError):
        chaos.failpoint("x")
    chaos.failpoint("x")                     # times=1 exhausted: passes
    assert chaos.fired("x") == ["x"]
    chaos.reset_for_tests()
    chaos.failpoint("x")                     # disarmed: no-op
    assert chaos.fired() == []
    assert set(SAVE_FAILPOINTS) <= set(chaos.FAILPOINTS)


def test_chaos_env_spec_and_sleep_mode(monkeypatch):
    monkeypatch.setenv("DSTPU_CHAOS", "ckpt.digest:raise:skip=1")
    chaos.reset_for_tests()
    assert chaos.armed() == ["ckpt.digest"]
    chaos.failpoint("ckpt.digest")
    with pytest.raises(IOError):
        chaos.failpoint("ckpt.digest")
    chaos.arm("s", "sleep", ms=40)
    t0 = time.monotonic()
    chaos.failpoint("s")
    assert time.monotonic() - t0 >= 0.03 and chaos.fired("s") == ["s"]


def test_crash_at_every_failpoint_then_resume(shared, tmp_path):
    """For each failpoint: kill a real save there, then a fresh load
    resumes from the newest intact tag with the step, the optimizer and
    the lr schedule intact, and ``latest`` never names a tag without its
    completion marker."""
    d = str(tmp_path / "ck")
    e, r = shared["trainer"], shared["resumer"]
    e.train_batch(random_batch(8, seed=0))
    e.save_checkpoint(d)
    done = _step(e)                                     # newest intact step
    for fp in SAVE_FAILPOINTS:
        e.train_batch(random_batch(8, seed=done))
        n0 = len(chaos.fired(fp))
        chaos.arm(fp, "raise", times=100)
        with pytest.raises(IOError):
            e.save_checkpoint(d)
        chaos.disarm()
        assert len(chaos.fired(fp)) > n0, fp

        latest = ck.get_latest_tag(d)
        assert latest is not None, fp
        assert os.path.exists(os.path.join(d, latest, ck.CKPT_META_FILE)), fp

        _, client = r.load_checkpoint(d)
        # the marker is written before the rename and `latest`: a crash at
        # those two leaves the new tag durable (the load finishes the
        # publish / repairs the pointer); earlier stages roll back
        expected = done + 1 if fp in ("ckpt.rename", "ckpt.latest") else done
        assert _step(r) == expected, fp
        assert client["global_steps"] == expected, fp
        assert r.lr_scheduler.state_dict()["last_step"] == expected, fp

        e.save_checkpoint(d)         # a clean save of the same tag succeeds
        done += 1
        assert ck.get_latest_tag(d) == f"global_step{done}", fp
        assert ck.verify_tag(os.path.join(d, f"global_step{done}")) is None, fp

    r.load_checkpoint(d)
    b = random_batch(8, seed=77)
    assert e.train_batch(b)["loss"] == r.train_batch(b)["loss"]


def test_quarantined_staging_left_for_forensics(shared, tmp_path):
    d = str(tmp_path / "ck")
    e = shared["trainer"]
    e.train_batch(random_batch(8, seed=0))
    chaos.arm("ckpt.write", "raise", times=100)
    with pytest.raises(IOError):
        e.save_checkpoint(d)
    chaos.disarm()
    assert any(n.endswith(ck.QUARANTINE_SUFFIX) for n in os.listdir(d))
    assert ck.list_tags(d) == []
    with pytest.raises(FileNotFoundError):
        ck.resolve_load_tag(d)


# ------------------------------------------------------ corruption + rollback

def test_truncated_tag_rolls_back(shared, tmp_path):
    d = _clone_template(shared, tmp_path)
    npz = os.path.join(d, "global_step2", "model_states.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    r = shared["resumer"]
    r.load_checkpoint(d)
    assert _step(r) == 1
    assert ck.get_latest_tag(d) == "global_step1"
    assert os.path.isdir(os.path.join(d, "global_step2"))


def test_bitflip_detected_by_digest(shared, tmp_path):
    d = _clone_template(shared, tmp_path)
    npz = os.path.join(d, "global_step2", "model_states.npz")
    size = os.path.getsize(npz)
    with open(npz, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff" * 16)
    assert "digest mismatch" in ck.verify_tag(os.path.join(d, "global_step2"))
    r = shared["resumer"]
    r.load_checkpoint(d)
    assert _step(r) == 1


def test_explicit_corrupt_tag_raises(shared, tmp_path):
    d = _clone_template(shared, tmp_path)
    npz = os.path.join(d, "global_step2", "model_states.npz")
    with open(npz, "r+b") as f:
        f.truncate(10)
    with pytest.raises(ck.CheckpointIntegrityError, match="global_step2"):
        shared["resumer"].load_checkpoint(d, tag="global_step2")


def test_markerless_tag_without_data_skipped(shared, tmp_path):
    d = _clone_template(shared, tmp_path)
    bogus = os.path.join(d, "global_step9")
    os.makedirs(bogus)
    with open(os.path.join(bogus, "meta.json"), "w") as f:
        json.dump({"step": 9}, f)
    ck.write_latest(d, "global_step9")
    r = shared["resumer"]
    r.load_checkpoint(d)
    assert _step(r) == 2
    assert ck.get_latest_tag(d) == "global_step2"


def test_legacy_markerless_tag_still_loads(shared, tmp_path):
    d = _clone_template(shared, tmp_path)
    os.remove(os.path.join(d, "global_step2", ck.CKPT_META_FILE))
    assert ck.verify_tag(os.path.join(d, "global_step2")) is None
    r = shared["resumer"]
    r.load_checkpoint(d)
    assert _step(r) == 2


def test_interrupted_publish_is_recovered(shared, tmp_path):
    """A staging dir holding its marker (the crash hit between the marker
    and the rename) is promoted by the next load."""
    d = _clone_template(shared, tmp_path)
    os.replace(os.path.join(d, "global_step2"),
               os.path.join(d, "global_step2" + ck.STAGING_SUFFIX))
    r = shared["resumer"]
    r.load_checkpoint(d)
    assert _step(r) == 2
    assert os.path.isdir(os.path.join(d, "global_step2"))


# ------------------------------------------------------------- retention GC

def _fake_tag(d, step):
    p = os.path.join(d, f"global_step{step}")
    os.makedirs(p)
    with open(os.path.join(p, "meta.json"), "w") as f:
        json.dump({"step": step}, f)


def test_retention_keep_last_and_every(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(d)
    for s in range(1, 8):
        _fake_tag(d, s)
    ck.write_latest(d, "global_step7")
    removed = ck.prune_checkpoints(d, keep_last=2, keep_every=3)
    assert sorted(ck.list_tags(d)) == ["global_step3", "global_step6",
                                       "global_step7"]
    assert sorted(removed) == ["global_step1", "global_step2",
                               "global_step4", "global_step5"]
    assert ck.prune_checkpoints(d, keep_last=0) == []      # retention off


def test_engine_retention_wired_through_config(tmp_path):
    """checkpoint.keep_last / keep_every flow from the ds_config."""
    d = str(tmp_path / "ck")
    e = _engine({"checkpoint": {"keep_last": 2, "keep_every": 2}})
    for i in range(5):
        e.train_batch(random_batch(8, seed=i))
        e.save_checkpoint(d)
    assert ck.list_tags(d) == ["global_step2", "global_step4",
                               "global_step5"]


# ------------------------------------------------- async writer: retry/failure

def test_async_retry_recovers_from_transient_io(tmp_path):
    eng = AsyncCheckpointEngine(max_retries=3, retry_backoff=0.01)
    path = str(tmp_path / "x.npz")
    chaos.arm("ckpt.write", "raise", times=2)      # fails twice, then clean
    eng.create("t1")
    eng.save({"a": torch.zeros(4), "b": np.ones(2, np.float32)}, path)
    res = eng.commit("t1")
    assert res and res.ok
    assert len(chaos.fired("ckpt.write")) == 2
    assert torch.equal(ck.read_flat_npz(path)["a"], torch.zeros(4))
    eng.close()


def test_async_retries_are_bounded_and_commit_names_the_path(tmp_path):
    eng = AsyncCheckpointEngine(max_retries=2, retry_backoff=0.01)
    path = str(tmp_path / "y.npz")
    chaos.arm("ckpt.write", "raise", times=100)
    eng.create("t1")
    eng.save({"a": torch.zeros(4), "b": torch.ones(2)}, path)
    res = eng.commit("t1")
    chaos.disarm()
    assert not res
    assert res.failed_paths() == [path]
    assert "ChaosError" in res.failures[0][1]
    assert len(chaos.fired("ckpt.write")) == 3     # 1 try + 2 retries
    eng.close()


def test_async_failure_does_not_poison_next_tag(tmp_path):
    eng = AsyncCheckpointEngine(max_retries=0, retry_backoff=0.01)
    stage = str(tmp_path / "tag1.tmp")
    os.makedirs(stage)
    chaos.arm("ckpt.write", "raise", times=1)
    eng.create("tag1", stage_dir=stage)
    eng.save({"a": torch.zeros(4), "b": torch.ones(2)},
             os.path.join(stage, "m.npz"))
    eng.run(lambda: open(str(tmp_path / "latest1"), "w").write("tag1"),
            label="latest1")
    res = eng.commit("tag1")
    assert not res
    assert not os.path.exists(str(tmp_path / "latest1"))
    assert os.path.isdir(str(tmp_path / "tag1") + ck.QUARANTINE_SUFFIX)
    eng.create("tag2")
    path2 = str(tmp_path / "z.npz")
    eng.save({"b": torch.ones(4)}, path2)
    assert eng.commit("tag2")
    assert os.path.exists(path2)
    eng.close()


def test_async_close_explicit_and_idempotent(tmp_path):
    eng = AsyncCheckpointEngine()
    path = str(tmp_path / "c.npz")
    eng.save({"a": torch.zeros(2)}, path)
    res = eng.close()                               # drains pending writes
    assert res.ok and os.path.exists(path)
    assert eng.close().ok                           # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        eng.run(lambda: None)


def test_engine_async_save_snapshot_failure_then_clean_save(tmp_path):
    """An async save snapshots the state before it returns (the next step
    updates the tensors in place); a save whose writes fail leaves
    ``latest`` alone and does not block the next one."""
    d = str(tmp_path / "ck")
    e = _engine({"checkpoint": {"async_save": True, "write_retries": 0}})
    e.train_batch(random_batch(8, seed=0))
    chaos.arm("ckpt.write", "sleep", ms=300)        # the writer is slow
    e.save_checkpoint(d)
    saved = {k: v.detach().clone() for k, v in e.module.named_parameters()}
    e.train_batch(random_batch(8, seed=1))          # mutates in place
    assert e.wait_for_checkpoints()
    chaos.disarm()
    assert ck.get_latest_tag(d) == "global_step1"
    r = _engine(seed=3)
    r.load_checkpoint(d)
    for k, p in r.module.named_parameters():
        assert torch.equal(p, saved[k]), k

    chaos.arm("ckpt.write", "raise", times=100)
    e.save_checkpoint(d)
    res = e.wait_for_checkpoints()
    chaos.disarm()
    assert not res and res.failed_paths()
    assert ck.get_latest_tag(d) == "global_step1"

    e.train_batch(random_batch(8, seed=2))
    e.save_checkpoint(d)
    assert e.wait_for_checkpoints()
    assert ck.get_latest_tag(d) == "global_step3"
    assert e.close() and e.close()


def test_nebula_section_selects_the_async_writer(tmp_path):
    """As in the JAX engine, the nebula section is an alias of
    checkpoint.async_save."""
    e = _engine({"nebula": {"enabled": True}})
    e.train_batch(random_batch(8, seed=0))
    e.save_checkpoint(str(tmp_path / "ck"))
    assert isinstance(e.checkpoint_engine, AsyncCheckpointEngine)
    assert e.wait_for_checkpoints() and e.close()
    assert ck.get_latest_tag(str(tmp_path / "ck")) == "global_step1"


def test_multiprocess_save_raises_naming_roadmap(monkeypatch, tmp_path):
    monkeypatch.setattr(ck, "_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="2.6"):
        _engine().save_checkpoint(str(tmp_path / "ck"))
    assert not os.path.exists(str(tmp_path / "ck"))


# ---------------------------------------------- kill mid-write (subprocess)

# tier-2: a real os._exit in the middle of the first array of a save. The
# tier-1 cousin is test_crash_at_every_failpoint_then_resume (the same
# stages in raise mode, in process).
@pytest.mark.slow
def test_kill_mid_write_then_resume(tmp_path):
    d = str(tmp_path / "ck")
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})
        from test_torch_ckpt_resilience import _engine, random_batch
        e = _engine()
        e.train_batch(random_batch(8, seed=0))
        e.save_checkpoint({d!r})
        e.train_batch(random_batch(8, seed=1))
        e.save_checkpoint({d!r})       # DSTPU_CHAOS kills this one
    """)
    env = dict(os.environ, DSTPU_CHAOS="ckpt.write:kill:skip=2")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == chaos.KILL_EXIT_CODE, out.stderr
    assert ck.get_latest_tag(d) == "global_step1"
    assert any(n.endswith(ck.STAGING_SUFFIX) for n in os.listdir(d))
    r = _engine(seed=2)
    r.load_checkpoint(d)
    assert _step(r) == 1
