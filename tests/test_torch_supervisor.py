"""Port parity: run supervision (``deepspeed_tpu_torch/launcher/
supervisor.py``, ``elasticity/elastic_agent.py``) against the JAX
package, and the runner's launch of a training script end to end.

Supervisor scenarios (the tier-1 part of ``tests/test_supervisor.py``)
run through BOTH packages' ``RunSupervisor`` over short ``python -c``
ranks: the rc aggregation (clean 0, a crash beats a preemption, a stall's
117), the fail-fast teardown, connect-phase retries, spec env reaching a
local rank, a blackholed host's attribution and the Popen facade; both
must give the same rc and the same per-rank record.

End to end on the CPU (``python -m deepspeed_tpu_torch.launcher.runner``
over a ``localhost slots=1`` hostfile, ``--launcher local``): a tiny
engine with ``install_preemption_handler`` is preempted at step 3 by
``DSTPU_CHAOS=run.preempt:sigterm`` (rc 114, an emergency tag), and a
relaunch resumes from it with the data loader fast-forwarded: its steps
4-6 equal a clean run's bitwise; ``health`` reads the rank's records.

Slow (``scripts/tier2.sh``), each naming its tier-1 cousin:
``run.hang`` -> rc 117 through the runner (cousin:
``test_supervisor_scenarios_equal_jax[stall]`` and the heartbeat tests of
``test_torch_heartbeat.py``), the elastic agent resuming a preempted
world uncounted (cousin: the preempt/resume leg here) and the
heartbeat-silence teardown (cousin: ``[stall]``).
"""

import io
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu.launcher import supervisor as jsup
from deepspeed_tpu.testing import chaos as jchaos

from deepspeed_tpu_torch.exit_codes import (PREEMPTION_EXIT_CODE,
                                            STALL_EXIT_CODE)
from deepspeed_tpu_torch.launcher import supervisor as tsup
from deepspeed_tpu_torch.testing import chaos

REPO = str(Path(__file__).resolve().parents[1])
PY = sys.executable
JOIN_S = 120


@pytest.fixture(autouse=True)
def _port_chaos():
    chaos.reset_for_tests()
    yield
    chaos.reset_for_tests()


SENT = tsup.STARTED_SENTINEL
HANDLER = ("import signal, sys, time\n"
           "signal.signal(signal.SIGTERM, lambda *a: sys.exit(114))\n"
           "time.sleep(60)\n")
SCENARIOS = {
    # name: (ranks as (code, host, remote), kwargs, armed chaos, want rc)
    "clean": ([("pass", "h0", False), ("pass", "h1", False)], {}, None, 0),
    # a crash tears the world down; the torn-down rank's own 114 does not
    # count: the rc that costs the restart budget wins
    "crash_beats_preemption": ([(HANDLER, "h0", False),
                                ("import time; time.sleep(0.3); "
                                 "raise SystemExit(7)", "h1", False)],
                               {"grace_secs": 5.0}, None, 7),
    "stall": ([(f"raise SystemExit({STALL_EXIT_CODE})", "h0", False),
               ("import time; time.sleep(60)", "h1", False)],
              {"grace_secs": 1.0}, None, STALL_EXIT_CODE),
    "preempted": ([(f"raise SystemExit({PREEMPTION_EXIT_CODE})", "h0",
                    False)], {}, None, PREEMPTION_EXIT_CODE),
    "connect_retry": ([(f"print('{SENT}'); print('payload ran')", "h0",
                        True)], {"connect_backoff": 0.01},
                      ("launch.ssh", dict(times=2)), 0),
    "connect_bounded": ([("pass", "h0", True)],
                        {"connect_retries": 2, "connect_backoff": 0.01},
                        ("launch.ssh", dict(times=100)),
                        tsup.SSH_CONNECT_RC),
    "started_never_retried": ([(f"print('{SENT}', flush=True); "
                                f"raise SystemExit({tsup.SSH_CONNECT_RC})",
                                "h0", True)], {"connect_backoff": 0.01},
                              None, tsup.SSH_CONNECT_RC),
    "blackholed_host": ([("import time; time.sleep(60)", "h0", False),
                         (f"print('{SENT}')", "h1", True)],
                        {"grace_secs": 0.5, "connect_retries": 1,
                         "connect_backoff": 0.01},
                        ("host.blackhole", dict(times=100, match="h1")),
                        tsup.SSH_CONNECT_RC),
}


def _supervise(mod, ranks, kwargs, armed, log_dir):
    """One scenario through ``mod``'s supervisor and chaos."""
    ch = chaos if mod is tsup else jchaos
    ch.reset_for_tests()
    if armed is not None:
        ch.arm(armed[0], "raise", **armed[1])
    specs = [mod.RankSpec(host, [PY, "-c", code], remote=remote)
             for code, host, remote in ranks]
    buf = io.StringIO()
    t0 = time.monotonic()
    sup = mod.RunSupervisor(specs, stream=buf, log_dir=log_dir, **kwargs)
    rc = sup.run()
    ch.reset_for_tests()
    return {"rc": rc, "s": time.monotonic() - t0,
            "attempts": [st.attempts for st in sup.status],
            "started": [st.started for st in sup.status],
            "signaled": [st.signaled for st in sup.status],
            "failed": sup.failed_hosts(), "out": buf.getvalue()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_scenarios_equal_jax(name, tmp_path):
    ranks, kwargs, armed, want = SCENARIOS[name]
    got = [_supervise(mod, ranks, kwargs, armed, str(tmp_path / mod.__name__))
           for mod in (jsup, tsup)]
    j, t = got
    assert t["rc"] == j["rc"] == want, (t, j)
    for key in ("attempts", "started", "signaled", "failed"):
        assert t[key] == j[key], key
    assert t["s"] < 30
    if name == "connect_retry":
        assert "payload ran" in t["out"] and SENT not in t["out"]
        log = (tmp_path / tsup.__name__ / "h0.rank0.log").read_text()
        assert "[h0] payload ran" in log


def test_supervisor_popen_facade_and_spec_env():
    sup = tsup.RunSupervisor([tsup.RankSpec(
        "h0", [PY, "-c", "import time; time.sleep(60)"])],
        grace_secs=0.5).start()
    assert sup.poll() is None
    with pytest.raises(subprocess.TimeoutExpired):
        sup.wait(timeout=0.2)
    sup.terminate()
    rc = sup.wait(timeout=30)
    assert rc != 0 and sup.poll() == rc == sup.returncode
    env = tsup.RunSupervisor([tsup.RankSpec(
        "localhost", [PY, "-c", "import os, sys; sys.exit(0 if os.environ."
                      "get('DSTPU_VERIFY_ENV') == 'yes' else 5)"],
        env={"DSTPU_VERIFY_ENV": "yes"})])
    assert env.run() == 0


# --------------------------------------------------------------- end to end

TRAIN = r"""
import json, os, sys
import numpy as np
import torch
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.runtime import checkpointing as ckl
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

ck, steps = sys.argv[1], int(sys.argv[2])
cfg = ttr.get_config("gpt2-tiny", hidden_size=32, num_layers=2, num_heads=2,
                     vocab_size=64, max_seq_len=32, dtype=torch.float32)
conf = {"train_batch_size": 4, "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
        "watchdog": {"stall_timeout": float(os.environ.get("STALL", "60")),
                     "compile_timeout": float(os.environ.get("COMPILE",
                                                             "0"))},
        "straggler": {"enabled": True}}
torch.manual_seed(0)
eng, *_ = ds.initialize(model=ttr.Transformer(cfg, seed=0), config=conf,
                        loss_fn=ttr.causal_lm_loss, device="cpu")
loader = RepeatingLoader([{"input_ids": np.random.default_rng(i).integers(
    0, 64, (4, 16))} for i in range(8)])
if ckl.get_latest_tag(ck):
    eng.load_checkpoint(ck)
    print("RESUMED " + json.dumps({"step": eng.global_steps,
          "skipped": eng.fast_forward_dataloader(loader)}), flush=True)
eng.install_preemption_handler(ck, grace_secs=30)
save_at = int(os.environ.get("SAVE_AT", "0"))
while eng.global_steps < steps:
    m = eng.train_batch(next(loader))
    print("STEP " + json.dumps({"step": eng.global_steps, "loss": m["loss"],
                                "grad_norm": m["grad_norm"]}), flush=True)
    if eng.global_steps == save_at:
        eng.save_checkpoint(ck)
eng.close()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _runner(tmp_path, ck, steps, chaos_spec=None, extra=(), env_extra=None):
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent(TRAIN))
    (tmp_path / "hostfile").write_text("localhost slots=1\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **(env_extra or {}))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "DSTPU_HEARTBEAT_DIR",
                "DSTPU_CHAOS", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    if chaos_spec:
        env["DSTPU_CHAOS"] = chaos_spec
    cmd = [PY, "-m", "deepspeed_tpu_torch.launcher.runner",
           "-H", str(tmp_path / "hostfile"), "--launcher", "local",
           "--master_port", str(_free_port()), "--grace_secs", "5",
           "--heartbeat_dir", str(tmp_path / "hb"), *extra,
           str(script), str(ck), str(steps)]
    p = subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        out, _ = p.communicate(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        pytest.fail(f"runner: not done in {JOIN_S} s")
    steps_seen = [json.loads(ln.split("STEP ", 1)[1])
                  for ln in out.splitlines() if "STEP {" in ln]
    return p.returncode, out, steps_seen


def _clean_trajectory(steps):
    """The same script's numbers without a launcher (in this process)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import transformer as ttr
    cfg = ttr.get_config("gpt2-tiny", hidden_size=32, num_layers=2,
                         num_heads=2, vocab_size=64, max_seq_len=32,
                         dtype=torch.float32)
    torch.manual_seed(0)
    eng, *_ = ds.initialize(
        model=ttr.Transformer(cfg, seed=0), loss_fn=ttr.causal_lm_loss,
        device="cpu", dist_init_required=False,
        config={"train_batch_size": 4, "steps_per_print": 1000,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    out = []
    for i in range(steps):
        ids = np.random.default_rng(i % 8).integers(0, 64, (4, 16))
        m = eng.train_batch({"input_ids": ids})
        out.append({"step": i + 1, "loss": m["loss"],
                    "grad_norm": m["grad_norm"]})
    return out


def test_runner_preempt_emergency_tag_and_resume(tmp_path, capsys):
    ck = tmp_path / "ck"
    rc, out, first = _runner(tmp_path, ck, 6, "run.preempt:sigterm:skip=3")
    assert rc == PREEMPTION_EXIT_CODE, out[-3000:]
    assert [s["step"] for s in first] == [1, 2, 3]
    from deepspeed_tpu_torch.runtime import checkpointing as ckl
    assert ckl.get_latest_tag(str(ck)) == "global_step3"
    assert ckl.verify_tag(str(ck / "global_step3")) is None
    from deepspeed_tpu_torch.launcher.runner import health_main
    from deepspeed_tpu_torch.runtime import heartbeat as hb
    # the rank's record: PREEMPTED, then (as in the JAX engine) the
    # emergency save's SAVE phase
    recs = (tmp_path / "hb" / "rank0.hb").read_text()
    assert hb.PHASE_PREEMPTED in recs
    rc, out, rest = _runner(tmp_path, ck, 6)
    assert rc == 0, out[-3000:]
    assert '"skipped": 3' in out
    assert [s["step"] for s in rest] == [4, 5, 6]
    # the clean twin's numbers, bit for bit (one process, the same seeds)
    assert first + rest == _clean_trajectory(6)
    capsys.readouterr()
    assert health_main([str(tmp_path / "hb")]) == 0
    assert "clean exit" in capsys.readouterr().out


@pytest.mark.slow
def test_runner_run_hang_exits_stall_rc(tmp_path):
    """Slow: ``run.hang`` wedges the rank at step 3; its watchdog dumps
    the stacks and exits 117, which the runner returns within
    stall_timeout + the grace (tier-1 cousin:
    ``test_supervisor_scenarios_equal_jax[stall]``)."""
    t0 = time.monotonic()
    rc, out, seen = _runner(tmp_path, tmp_path / "ck", 6,
                            "run.hang:hang:skip=3", env_extra={"STALL": "3"})
    assert rc == STALL_EXIT_CODE, out[-3000:]
    assert len(seen) == 3 and "no step progress" in out
    assert time.monotonic() - t0 < 60


@pytest.mark.slow
def test_runner_elastic_resumes_preemption_uncounted(tmp_path):
    """Slow: ``--elastic --max_restarts 0``: the preempted world (rc 114)
    relaunches uncounted and finishes clean (tier-1 cousin:
    ``test_runner_preempt_emergency_tag_and_resume``)."""
    rc, out, seen = _runner(tmp_path, tmp_path / "ck", 6,
                            "run.preempt:sigterm:skip=3",
                            extra=("--elastic", "--max_restarts", "0"))
    assert rc == 0, out[-3000:]
    assert [s["step"] for s in seen] == [1, 2, 3, 4, 5, 6]


@pytest.mark.slow
def test_heartbeat_silence_tears_down_world_as_stall(tmp_path):
    """Slow: a rank whose record goes silent past heartbeat_timeout tears
    the world down with rc 117 (tier-1 cousin: ``[stall]``)."""
    from deepspeed_tpu_torch.runtime import heartbeat as hb
    d = str(tmp_path / "hb")
    sup = tsup.RunSupervisor([
        tsup.RankSpec("h0", [PY, "-c", "import time; time.sleep(60)"]),
    ], grace_secs=0.5, heartbeat_dir=d, heartbeat_timeout=1.0,
        heartbeat_poll=0.05, stream=io.StringIO()).start()
    w = hb.HeartbeatWriter(d, 0, host="h0", refresh_interval=0)
    w.write(hb.PHASE_STEP, 1, force=True)
    assert sup.wait(timeout=60) == STALL_EXIT_CODE


CRASHES = {
    # failpoint spec at the 4th train_batch entry: (rc, resumed from)
    "run.kill:kill:skip=3": (13, 2),
    "run.preempt:sigterm:skip=3": (PREEMPTION_EXIT_CODE, 3),
    "run.hang:hang:skip=3": (STALL_EXIT_CODE, 2),
}


@pytest.mark.slow
@pytest.mark.parametrize("spec", sorted(CRASHES))
def test_crash_at_every_run_failpoint_then_resume(tmp_path, spec):
    """Slow: a run crashed, preempted or wedged at step 4 (a periodic tag
    at step 2) exits with its rc through the runner, and a relaunch
    resumes from the newest intact tag, its steps the clean run's bit
    for bit (tier-1 cousins: ``test_runner_preempt_emergency_tag_and_
    resume`` and ``test_torch_ckpt_resilience.py::test_crash_at_every_
    failpoint_then_resume``, the save's own failpoints)."""
    want_rc, resumed = CRASHES[spec]
    ck = tmp_path / "ck"
    rc, out, first = _runner(tmp_path, ck, 6, spec,
                             env_extra={"SAVE_AT": "2", "STALL": "3"})
    assert rc == want_rc, out[-3000:]
    assert [s["step"] for s in first] == [1, 2, 3]
    rc, out, rest = _runner(tmp_path, ck, 6)
    assert rc == 0, out[-3000:]
    assert f'"step": {resumed}, "skipped": {resumed}' in out
    assert first[:resumed] + rest == _clean_trajectory(6)


@pytest.mark.slow
def test_compile_hang_exits_stall_rc_within_compile_timeout(tmp_path):
    """Slow: ``run.compile_hang`` wedges the first step's COMPILE phase;
    ``watchdog.compile_timeout`` fires rc 117 before any step (tier-1
    cousin: ``test_supervisor_scenarios_equal_jax[stall]``)."""
    t0 = time.monotonic()
    rc, out, seen = _runner(tmp_path, tmp_path / "ck", 6,
                            "run.compile_hang:hang",
                            env_extra={"COMPILE": "3"})
    assert rc == STALL_EXIT_CODE, out[-3000:]
    assert seen == [] and "COMPILE" in out
    assert time.monotonic() - t0 < 60
