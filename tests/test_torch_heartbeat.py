"""Port parity: the heartbeat channel, the straggler detector and the
serving stall watchdog (``deepspeed_tpu_torch/runtime``) against the JAX
package's.

* records the port writes are read by JAX's reader and its ``dstpu
  health`` view (``launcher/runner.py:health_main``), and records JAX
  writes by the port's reader: the same schema, phases and file layout;
* ``StepClock`` and the ``StragglerDetector`` verdicts equal JAX's on the
  same step sequences and channel snapshots; ``RollingRobust`` equals
  JAX's;
* ``watchdog.serve_timeout`` arms the serving engine's stall watchdog:
  a wedged iteration exits rc 117 with a stack dump and a STALLED
  record, in a subprocess on its own clock.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from deepspeed_tpu.launcher.runner import health_main
from deepspeed_tpu.runtime import heartbeat as jhb
from deepspeed_tpu.runtime import sentinel as jsent
from deepspeed_tpu.runtime import straggler as jstr

from deepspeed_tpu_torch.exit_codes import STALL_EXIT_CODE
from deepspeed_tpu_torch.runtime import heartbeat as thb
from deepspeed_tpu_torch.runtime import sentinel as tsent
from deepspeed_tpu_torch.runtime import straggler as tstr
from deepspeed_tpu_torch.runtime.watchdog import StallWatchdog
from deepspeed_tpu_torch.testing import chaos

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_chaos():
    chaos.reset_for_tests()
    yield
    chaos.reset_for_tests()


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _write_session(hb, directory, clock):
    """Two ranks through a serving life: INIT, SERVE with gauges and a
    straggler flag on rank 1, then EXIT on rank 0 and STALLED on rank 1."""
    w0 = hb.HeartbeatWriter(directory, 0, host="replica-0", min_interval=0,
                            refresh_interval=0, clock=clock)
    w1 = hb.HeartbeatWriter(directory, 1, host="replica-1", min_interval=0,
                            refresh_interval=0, clock=clock)
    for w in (w0, w1):
        w.write(hb.PHASE_INIT, 0, force=True)
    clock.t += 1.0
    w0.write(hb.PHASE_SERVE, 5, extra={"queue": 2, "active": 3, "lanes": 4,
                                       "step_ms": 12.5, "role": "DECODE"})
    w1.write(hb.PHASE_SERVE, 7, extra={"queue": 0, "active": 1, "lanes": 4,
                                       "step_ms": 80.0})
    w1.add_flag("STRAGGLER")
    clock.t += 1.0
    w0.stamp_terminal(hb.PHASE_EXIT)
    w1.stamp_terminal(hb.PHASE_STALLED, lock_timeout=1.0)
    return [hb.heartbeat_path(directory, r) for r in (0, 1)]


def _lines(paths):
    return [[json.loads(ln) for ln in Path(p).read_text().splitlines()]
            for p in paths]


def test_port_records_equal_jax_records(tmp_path):
    """The same writes through both packages leave the same files (but the
    pid), so every reader of one package reads the other's."""
    tp = _write_session(thb, str(tmp_path / "port"), _Clock())
    jp = _write_session(jhb, str(tmp_path / "jax"), _Clock())
    strip = lambda recs: [[{k: v for k, v in r.items() if k != "pid"}
                           for r in rank] for rank in recs]
    assert strip(_lines(tp)) == strip(_lines(jp))
    assert [Path(p).name for p in tp] == [Path(p).name for p in jp]
    for d in ("port", "jax"):
        got_j = jhb.read_heartbeats(str(tmp_path / d))
        got_t = thb.read_heartbeats(str(tmp_path / d))
        assert got_j == got_t and sorted(got_t) == [0, 1]
        assert thb.terminal_records(str(tmp_path / d)) == \
            jhb.terminal_records(str(tmp_path / d))
        assert thb.flagged_ranks(str(tmp_path / d), "STRAGGLER") == \
            jhb.flagged_ranks(str(tmp_path / d), "STRAGGLER")


def test_jax_health_reads_port_channel(tmp_path, capsys):
    d = str(tmp_path)
    clock = _Clock(1e9)
    w = thb.HeartbeatWriter(d, 0, host="replica-0", min_interval=0,
                            refresh_interval=0)
    w.write(thb.PHASE_SERVE, 3, extra={"queue": 1, "active": 2, "lanes": 4,
                                       "step_ms": 9.0, "role": "PREFILL"})
    assert health_main([d]) == 0                  # live, fresh
    out = capsys.readouterr().out
    assert "SERVE" in out and "role=PREFILL" in out and "9ms" in out
    w.stamp_terminal(thb.PHASE_EXIT)
    assert health_main([d]) == 0
    assert "clean exit" in capsys.readouterr().out
    w2 = thb.HeartbeatWriter(d, 1, host="replica-1", min_interval=0,
                             refresh_interval=0, clock=clock)
    w2.write(thb.PHASE_SERVE, 1)
    w2.stamp_terminal(thb.PHASE_STALLED, lock_timeout=1.0)
    assert health_main([d]) == 1
    assert "wedged (rc 117)" in capsys.readouterr().out


def test_port_reader_reads_jax_channel_and_clear(tmp_path):
    d = str(tmp_path)
    w = jhb.HeartbeatWriter(d, 3, host="h", min_interval=0,
                            refresh_interval=0)
    w.write(jhb.PHASE_SERVE, 2, extra={"queue": 0})
    recs = thb.read_heartbeats(d)
    assert recs[3]["phase"] == "SERVE" and recs[3]["gauges"] == {"queue": 0}
    assert [r["rank"] for r in thb.stale_ranks(d, 0.0, now=1e12)] == [3]
    thb.clear_channel(d)
    assert thb.read_heartbeats(d) == {} == jhb.read_heartbeats(d)


def test_writer_throttle_refresh_and_failpoint(tmp_path):
    """min_interval drops same-phase writes, transitions always write; an
    armed ``hb.write`` silences the rank without raising."""
    clock = _Clock()
    w = thb.HeartbeatWriter(str(tmp_path), 0, host="h", min_interval=1.0,
                            refresh_interval=0, clock=clock)
    assert w.write(thb.PHASE_SERVE, 1)
    assert not w.write(thb.PHASE_SERVE, 2)       # throttled
    assert w.write(thb.PHASE_SAVE, 2)            # transition
    chaos.arm("hb.write", times=1)
    clock.t += 5
    assert not w.write(thb.PHASE_SERVE, 3)       # swallowed
    assert chaos.fired("hb.write")
    clock.t += 5
    assert w.write(thb.PHASE_SERVE, 4)
    assert thb.read_heartbeats(str(tmp_path))[0]["step"] == 4


# --------------------------------------------------------------------------
# straggler machinery


def test_rolling_robust_equals_jax():
    rng = np.random.default_rng(4)
    for window in (4, 7, 16):
        t, j = tsent.RollingRobust(window), jsent.RollingRobust(window)
        for x in rng.normal(10.0, 2.0, 40):
            t.push(x)
            j.push(x)
            assert t.stats() == j.stats()
            assert t.zscore(x) == j.zscore(x)
            assert t.threshold(3.0) == j.threshold(3.0)
    vals = list(rng.normal(size=9))
    assert tsent._median(vals) == jsent._median(vals)
    assert tsent.SDC_FLAG == jsent.SDC_FLAG


def test_step_clock_equals_jax():
    tc, jc = _Clock(0.0), _Clock(0.0)
    t = tstr.StepClock(window=4, clock=tc)
    j = jstr.StepClock(window=4, clock=jc)
    for gap in (0.01, 0.02, 0.5, 0.015, 0.03, 0.011, 0.2):
        tc.t += gap
        jc.t += gap
        assert t.mark() == j.mark()
    t.reset()
    j.reset()
    assert t.mark() == j.mark()
    for ms in (5.0, 7.5, 100.0):
        assert t.push_ms(ms) == j.push_ms(ms)
    assert t.gauge() == j.gauge()


def _scfg(**kw):
    base = dict(zmax=3.0, rel_threshold=1.5, warmup=1, strike_window=2,
                cooldown=3, abort_after=2)
    base.update(kw)
    return SimpleNamespace(**base)


def _snapshot(gauges, phase="SERVE"):
    return {r: {"rank": r, "phase": phase, "gauges": {"step_ms": ms}}
            for r, ms in gauges.items()}


@pytest.mark.parametrize("world", [2, 6])
def test_straggler_verdicts_equal_jax(world):
    """The same snapshot sequences through both detectors: one slow rank
    flagged after warmup and strikes, then ABORT; a uniformly slow world
    and compile-phase windows give no verdict; a clean window retires."""
    rng = np.random.default_rng(world)
    seq = []
    for w in range(14):
        g = {r: float(rng.normal(20.0, 0.5)) for r in range(world)}
        if 3 <= w < 9 or w >= 11:
            g[world - 1] = 90.0                   # one slow rank
        if w == 10:
            g = {r: 95.0 for r in range(world)}   # uniformly slow
        seq.append(_snapshot(g, "COMPILE" if w == 9 else "SERVE"))
    seq.append({0: {"rank": 0, "phase": "SERVE",
                    "gauges": {"step_ms": 10.0}}})    # one gauge: no window
    t, j = tstr.StragglerDetector(_scfg()), jstr.StragglerDetector(_scfg())
    verdicts = []
    for snap in seq:
        vt, vj = t.observe(snap), j.observe(snap)
        assert vt == vj and t.slow_now == j.slow_now
        assert t.windows == j.windows and t.strikes == j.strikes
        verdicts.append(vt)
    flat = [v for vt in verdicts for v in vt.values()]
    assert tstr.SLOW in flat and tstr.ABORT in flat
    assert verdicts[10] == {} and verdicts[9] == {}
    t.forget(world - 1)
    j.forget(world - 1)
    assert t.strikes == j.strikes and t.persist == j.persist
    assert (tstr.STRAGGLER_FLAG, tstr.STEP_MS_GAUGE) == \
        (jstr.STRAGGLER_FLAG, jstr.STEP_MS_GAUGE)


def test_record_step_ms_phase_guards():
    for rec in ({"phase": "SERVE", "gauges": {"step_ms": 3}},
                {"phase": "STEP", "gauges": {"step_ms": "x"}},
                {"phase": "COMPILE", "gauges": {"step_ms": 3}},
                {"phase": "EXIT", "gauges": {"step_ms": 3}},
                {"phase": "SERVE"}):
        assert tstr.record_step_ms(rec) == jstr.record_step_ms(rec)


# --------------------------------------------------------------------------
# the serving stall watchdog


def test_watchdog_fires_once_with_stalled_record(tmp_path):
    """In-process: a SERVE phase that stops beating fires the one rc-117
    path (exit_fn), stamping STALLED through the writer."""
    fired = []
    w = thb.HeartbeatWriter(str(tmp_path), 0, host="h", min_interval=0,
                            refresh_interval=0)
    wd = StallWatchdog(stall_timeout=0.0, phase_timeouts={"SERVE": 0.2},
                       phase="SERVE", heartbeat=w, exit_fn=fired.append,
                       stream=io.StringIO(), poll_interval=0.02).start()
    try:
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        wd.stop()
    assert fired == [STALL_EXIT_CODE] and wd.fired
    assert thb.read_heartbeats(str(tmp_path))[0]["phase"] == "STALLED"
    with pytest.raises(ValueError, match="positive deadline"):
        StallWatchdog(stall_timeout=0.0)


_WEDGE = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, {repo!r})
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import get_config, init_params
    from deepspeed_tpu_torch.runtime.heartbeat import HeartbeatWriter
    cfg = get_config("gpt2-tiny", hidden_size=32, num_layers=1, num_heads=2,
                     vocab_size=64, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    eng = deepspeed_tpu_torch.init_inference(
        cfg, {{"dtype": "float32", "watchdog": {{"serve_timeout": 1.0}},
              "serving": {{"block_size": 16, "pool_blocks": 8,
                           "max_batch": 2, "max_blocks_per_seq": 4,
                           "prefill_chunk_tokens": 8}}}},
        model_parameters=params, device="cpu")
    srv = eng.serve(heartbeat=HeartbeatWriter({hb!r}, 0, host="w",
                                              min_interval=0))
    assert srv._watchdog is not None
    srv.submit([1, 2, 3, 4], 4)
    print("serving", flush=True)
    srv.step()              # the armed serve.chunk hang wedges this step
    print("not reached", flush=True)
""")


def test_serve_timeout_wedged_iteration_exits_117(tmp_path):
    """``watchdog.serve_timeout`` arms the engine's watchdog from the
    config; a step wedged in ``serve.chunk`` (hang mode) exits rc 117
    with an all-threads stack dump and a STALLED record that JAX's
    ``dstpu health`` reads as a wedge. The child runs on its own clock
    and is killed past it."""
    hb_dir = str(tmp_path / "hb")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["DSTPU_CHAOS"] = "serve.chunk:hang"
    proc = subprocess.Popen(
        [sys.executable, "-c", _WEDGE.format(repo=str(REPO), hb=hb_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == STALL_EXIT_CODE, err[-2000:]
    assert "serving" in out and "not reached" not in out
    assert "dstpu watchdog" in err and "SERVE" in err
    rec = jhb.read_heartbeats(hb_dir)[0]
    assert rec["phase"] == "STALLED"
    assert health_main([hb_dir]) == 1
