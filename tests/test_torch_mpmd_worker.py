"""Port parity: the MPMD stage worker, its driver and the socket channel
(``deepspeed_tpu_torch/runtime/pipe/mpmd/{stage_worker,driver,
channel}.py``) against the JAX package, on the CPU.

* the port's ``toy_spec`` draws the JAX toy's parameters and data from
  the same ``np.random.RandomState(seed)`` / ``default_rng`` streams:
  equal element for element;
* two stage worker processes (``--device cpu``) under
  ``MPMDStageSupervisor`` for two steps over the socket star give the
  losses of the JAX in-process ``MPMDPipeline`` on the same toy with the
  same Adam (rtol 1e-5); the run has its own 30 s clock and its children
  are killed past it; ``health`` shows the STAGE column;
* the socket channel's codec keeps bf16 and f32 payloads bit for bit.

Slow (``scripts/tier2.sh``; tier-1 cousin:
``test_two_stage_workers_match_jax_in_process_pipeline``): a stage killed
by ``pipe.stage_kill`` mid-run (each stage in turn) is restarted alone,
the survivor parks and resyncs, and the trajectory equals the uninjected
twin's.
"""

import argparse
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.optimizers import adam as jadam
from deepspeed_tpu.runtime.pipe.mpmd import MPMDPipeline as JPipeline
from deepspeed_tpu.runtime.pipe.mpmd import stage_worker as jsw

from deepspeed_tpu_torch.runtime.pipe.mpmd import (MPMDStageSupervisor,
                                                   StageWorkerSpec)
from deepspeed_tpu_torch.runtime.pipe.mpmd import channel as tch
from deepspeed_tpu_torch.runtime.pipe.mpmd import stage_worker as tsw

# the run's own clock: two stage processes start in ~3 s each alone, but
# under a six-worker suite's load a 15 s clock expired, so it is 30 s
PP, STEPS, CLOCK_S = 2, 2, 30.0


def _args(stage, **kw):
    ns = dict(stage=stage, pp=PP, hidden=8, mb=2, n_micro=4, seed=0)
    ns.update(kw)
    return argparse.Namespace(**ns)


def test_toy_spec_equals_jax_toy():
    for s in range(PP):
        j, t = jsw.toy_spec(_args(s)), tsw.toy_spec(_args(s))
        for tree in ("stage_init", "head_init"):
            assert sorted(j[tree]) == sorted(t[tree])
            for k in j[tree]:
                np.testing.assert_array_equal(t[tree][k].numpy(),
                                              np.asarray(j[tree][k]))
        for step in (0, 5):
            for a, b in zip(t["data"](step), j["data"](step)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_losses(steps, lr=1e-2):
    """The JAX in-process pipeline on the toy: both stages in one
    process, one Adam over every stage's parameters and the head (Adam
    is per element, so it equals each stage worker's own)."""
    specs = [jsw.toy_spec(_args(s)) for s in range(PP)]
    stacked = {k: jnp.stack([sp["stage_init"][k] for sp in specs])
               for k in specs[0]["stage_init"]}
    params = {"stage": stacked, "head": specs[-1]["head_init"]}
    dev = jax.devices("cpu")[0]
    pipe = JPipeline(specs[0]["stage_fn"], specs[0]["loss_fn"], pp=PP,
                     schedule="1f1b", devices=[dev] * PP)
    opt = jadam(lr=lr)
    state = opt.init(params)
    out = []
    for k in range(steps):
        micros, labels = specs[0]["data"](k)
        loss, _aux, sg, hg, _ = pipe.value_and_grad(
            params["stage"], params["head"], micros, labels)
        out.append(float(loss))
        params, state = opt.update({"stage": sg, "head": hg}, state, params,
                                   jnp.asarray(k, jnp.int32))
    return out


def _run(tmp_path, steps, specs=None, clock=CLOCK_S):
    """The driver over two CPU stage workers under its own clock: past
    ``clock`` seconds every child is killed and the test fails."""
    sup = MPMDStageSupervisor(
        PP, workdir=str(tmp_path / "w"), steps=steps, specs=specs,
        log_dir=str(tmp_path / "logs"), heartbeat_dir=str(tmp_path / "hb"),
        worker_args=["--device", "cpu"], grace_secs=2.0)
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("rc", sup.run()),
                         daemon=True)
    t0 = time.monotonic()
    t.start()
    t.join(clock)
    if t.is_alive():
        for p in sup.procs:
            if p is not None and p.poll() is None:
                p.kill()
        t.join(10)
        pytest.fail(f"stage workers not done in {clock} s")
    logs = {s: (tmp_path / "logs" / f"stage{s}.log").read_text()
            for s in range(PP)}
    losses = {}
    for ln in logs[PP - 1].splitlines():
        if ln.startswith("mpmd_step: "):
            rec = json.loads(ln[len("mpmd_step: "):])
            losses[rec["step"]] = rec["loss"]     # a replay rewrites a step
    return box["rc"], sup, [losses[k] for k in sorted(losses)], logs, \
        time.monotonic() - t0


def test_two_stage_workers_match_jax_in_process_pipeline(tmp_path, capsys):
    rc, sup, losses, logs, secs = _run(tmp_path, STEPS)
    assert rc == 0, logs
    assert sup.restarts == [0, 0]
    np.testing.assert_allclose(losses, _jax_losses(STEPS), rtol=1e-5)
    for s in range(PP):
        step = [json.loads(ln.split(": ", 1)[1]) for ln in
                logs[s].splitlines() if ln.startswith("mpmd_stage_step")]
        # one activation out and one cotangent back per micro-batch
        assert [r["bytes_sent"] for r in step] == [4 * 2 * 8 * 4] * STEPS
        assert "mpmd_launches" in logs[s]
    from deepspeed_tpu_torch.launcher.runner import health_main
    capsys.readouterr()
    assert health_main([str(tmp_path / "hb")]) == 0
    table = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in table[1:]] == ["0", "1"]   # STAGE


def test_socket_codec_keeps_payload_bits():
    for t in (torch.randn(3, 5), torch.randn(2, 4).to(torch.bfloat16),
              torch.randn(7).to(torch.float16)):
        meta, raw = tch._to_bytes(t)
        back = tch._from_bytes(meta, raw, None)
        assert back.dtype == t.dtype and back.shape == t.shape
        assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))


def test_fabric_reads_a_started_frame_whole(monkeypatch):
    """The socket endpoint's read: a deadline bounds only the wait for a
    frame to start (a frame split across the deadline arrives whole, the
    stream stays in step), no deadline waits past the mid-frame bound for
    a quiet peer, and a frame stalled mid-way is a torn stream."""
    import socket
    import threading
    from deepspeed_tpu_torch.runtime.fabric import (ChannelTimeout,
                                                    FrameCorrupt, sockets)
    from deepspeed_tpu_torch.runtime.fabric.frame import pack_frame
    monkeypatch.setattr(sockets, "MID_FRAME_S", 0.3)
    a, b = socket.socketpair()
    ep = sockets.SocketEndpoint.__new__(sockets.SocketEndpoint)
    ep._sock, ep.ident = a, "test"
    raw = [pack_frame({"k": i}, bytes(range(200)) * 50) for i in range(3)]

    def later(delay, data):
        threading.Timer(delay, b.sendall, args=(data,)).start()

    b.sendall(raw[0][:40])                     # the deadline falls mid-frame
    later(0.1, raw[0][40:] + raw[1])
    assert ep._read_one(0.01)[0] == {"k": 0}
    assert ep._read_one(0.01)[0] == {"k": 1}   # still in step
    with pytest.raises(ChannelTimeout):
        ep._read_one(0.05)
    later(0.6, raw[2])                         # quiet past the bound
    assert ep._read_one(None)[0] == {"k": 2}
    b.sendall(raw[0][:40])
    with pytest.raises(FrameCorrupt):
        ep._read_one(1.0)
    a.close()
    b.close()


@pytest.mark.slow
@pytest.mark.parametrize("victim", [0, 1])
def test_killed_stage_restarts_alone_and_replays_the_twin(tmp_path, victim):
    """Slow: ``pipe.stage_kill`` kills one stage before its step 2; the
    driver restarts it alone from its newest tag, the survivor parks and
    resyncs, and the losses equal the uninjected twin's (tier-1 cousin:
    ``test_two_stage_workers_match_jax_in_process_pipeline``)."""
    steps = 4
    rc, _, twin, _, _ = _run(tmp_path / "twin", steps, clock=60)
    assert rc == 0
    specs = [StageWorkerSpec() for _ in range(PP)]
    specs[victim] = StageWorkerSpec(env_first={
        "DSTPU_CHAOS": f"pipe.stage_kill:kill:match={victim}:skip=2"})
    rc, sup, losses, logs, _ = _run(tmp_path / "kill", steps, specs=specs,
                                    clock=60)
    assert rc == 0, logs
    assert sup.restarts == [int(victim == 0), int(victim == 1)]
    assert losses == twin
