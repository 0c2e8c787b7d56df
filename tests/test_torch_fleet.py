"""Port parity: the serving fleet (``deepspeed_tpu_torch/serving/fleet.py``,
``autoscale.py``) against the JAX package's.

The same flax-initialized f32 weights (numpy in, ``params_from_jax``) of a
2-layer, width-64 llama-style model serve through both packages on the
CPU. Greedy tokens are exact:

* a 2-replica thread fleet's tokens equal the JAX ``ServingFleet``'s and
  the port's own ``ServingEngine``'s;
* a replica killed mid-decode (``serve.replica_kill``, raise mode) has
  its in-flight requests requeued exactly once — final tokens and the
  ``on_token`` ledger equal the unkilled run's — with a ``serve.requeue``
  crash parked on the orphan list; retry-budget exhaustion concludes
  FAILED; a queued request past its deadline concludes TIMEOUT; submit
  validates synchronously;
* the supervisor's verdicts, and ``AutoscalePolicy`` decisions on the
  same ``Observation`` sequences, equal JAX's; the autoscaler grows and
  drains a fleet; a pressured latency request preempts a batch lane;
* ``init_inference(...).serve()`` returns a started fleet for replicas,
  floor-1 autoscale and disaggregated roles;
* kernel launch counters add up exactly under concurrent threads.

The heavy chaos matrices run behind ``slow``, each naming its tier-1
cousin. Every fleet is closed in a finalizer.
"""

import dataclasses
import json
import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import build_model
from deepspeed_tpu.serving import autoscale as jas
from deepspeed_tpu.serving.fleet import FleetSupervisor as JFleetSupervisor
from deepspeed_tpu.serving.fleet import ServingFleet as JServingFleet
from deepspeed_tpu.serving.fleet import _Replica as _JReplica
from deepspeed_tpu.config.config import AutoscaleConfig as JAutoscaleConfig

import deepspeed_tpu_torch
from deepspeed_tpu_torch.config.config import AutoscaleConfig
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.runtime import heartbeat as hb
from deepspeed_tpu_torch.serving import autoscale as tas
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.serving.fleet import (BLACKLISTED, LIVE, RETIRED,
                                               FleetSupervisor, ServingFleet,
                                               _Replica)
from deepspeed_tpu_torch.serving.scheduler import (BATCH, FAILED, FINISHED,
                                                   LATENCY, SHED, STANDARD,
                                                   TIMEOUT, AdmissionRejected)
from deepspeed_tpu_torch.testing import chaos

LLAMA = dict(pos_embed="rotary", rotary_interleaved=False, norm="rmsnorm",
             gated_mlp=True, activation="silu", num_kv_heads=2,
             tie_embeddings=False, use_bias=False, mlp_dim_override=96)
SERVE = {"block_size": 16, "pool_blocks": 40, "max_batch": 3,
         "max_blocks_per_seq": 6}
PROMPT_LENS = (5, 11, 16, 9, 13, 7)
NEW = 12


@pytest.fixture(autouse=True)
def _port_chaos():
    chaos.reset_for_tests()
    yield
    chaos.reset_for_tests()


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, port params, prompts)."""
    _, jcfg = build_model("gpt2-tiny", hidden_size=64, num_layers=2,
                          num_heads=4, vocab_size=64, max_seq_len=128,
                          attention_impl="reference", dtype=jnp.float32,
                          **LLAMA)
    model, _ = build_model(jcfg)
    jp = model.init(jax.random.PRNGKey(3),
                    {"input_ids": np.zeros((1, 8), np.int32)})["params"]
    jp = _numpy_tree(jax.device_get(jp))
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f["dtype"] = torch.float32
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, 64, size=n)]
               for n in PROMPT_LENS]
    return jcfg, jp, TransformerConfig(**f), params_from_jax(jp), prompts


@pytest.fixture(scope="module")
def reference(tiny):
    """The port engine's greedy tokens for the prompts (the oracle every
    fleet leg is held to; the first test holds it to JAX's)."""
    _, _, cfg, params, prompts = tiny
    eng = ServingEngine(cfg, params, serving=SERVE, device="cpu")
    return eng.generate_batch(prompts, NEW)


def _serving(replicas=2, serve=None, **fleet_kw):
    fleet = {"replicas": replicas, "poll_interval": 0.02,
             "heartbeat_interval": 0.02, "heartbeat_timeout": 60.0}
    fleet.update(fleet_kw)
    return dict(serve or SERVE, fleet=fleet)


@pytest.fixture
def fleets(tmp_path):
    """Builds fleets on the CPU with their heartbeat channel under
    tmp_path; closes every one of them at teardown."""
    made = []

    def make(cfg, params, serving, **kw):
        kw.setdefault("heartbeat_dir", str(tmp_path / f"hb{len(made)}"))
        flt = ServingFleet(cfg, params, serving=serving, device="cpu", **kw)
        made.append(flt)
        return flt

    yield make
    for flt in made:
        flt.close(timeout=5.0)


def _ledger(emitted):
    return lambda r, t: emitted.setdefault(r.rid, []).append(t)


# ---------------------------------------------------------------------------
# tier-1


def test_fleet_tokens_equal_jax_fleet_and_engine(tiny, reference, fleets):
    jcfg, jp, cfg, params, prompts = tiny
    jflt = JServingFleet(jcfg, jp, serving=_serving(2))
    try:
        jflt.start()
        jax_out = jflt.generate_batch(prompts, NEW, timeout=240)
    finally:
        jflt.close()
    flt = fleets(cfg, params, _serving(2)).start()
    emitted = {}
    reqs = [flt.submit(p, NEW, on_token=_ledger(emitted)) for p in prompts]
    assert flt.drain(timeout=120)
    out = [r.output_tokens for r in reqs]
    assert out == jax_out == reference
    assert all(r.state == FINISHED for r in reqs)
    assert [emitted[r.rid] for r in reqs] == out
    assert flt.stats["completed"] == len(prompts)
    assert flt.stats["tokens_emitted"] == len(prompts) * NEW
    # every replica served; each stamped SERVE records with gauges
    recs = hb.read_heartbeats(flt.heartbeat_dir)
    assert sorted(recs) == [0, 1]
    assert all(r["phase"] == hb.PHASE_SERVE and "lanes" in r["gauges"]
               for r in recs.values())
    flt.close()
    recs = hb.read_heartbeats(flt.heartbeat_dir)
    assert all(r["phase"] == hb.PHASE_EXIT for r in recs.values())


def test_fleet_kill_requeues_exactly_once_token_exact(tiny, reference,
                                                     fleets):
    """``serve.replica_kill`` mid-decode on replica 1: its in-flight
    requests requeue onto the survivor and the restarted replica and
    finish token-exact, each token emitted once; a ``serve.requeue``
    crash orphans the request for the next poll instead of losing it."""
    _, _, cfg, params, prompts = tiny
    flt = fleets(cfg, params, _serving(2))
    emitted = {}
    reqs = [flt.submit(p, NEW, on_token=_ledger(emitted)) for p in prompts]
    chaos.arm("serve.replica_kill", "raise", match="1", skip=5)
    chaos.arm("serve.requeue", "raise", times=1)
    flt.start()
    assert flt.drain(timeout=120)
    assert chaos.fired("serve.replica_kill") and chaos.fired("serve.requeue")
    assert flt.stats["deaths"] == 1 and flt.stats["restarts"] == 1
    assert flt.stats["requeues"] >= 1
    death = flt.deaths[0]
    assert death["replica"] == 1 and death["reason"] == "crash"
    assert death["action"] == "restart"
    assert death["evidence"]["phase"] == hb.PHASE_SERVE
    assert "ChaosError" in death["error"]
    assert [r.output_tokens for r in reqs] == reference
    assert [emitted[r.rid] for r in reqs] == reference
    assert sum(r.retries for r in reqs) >= 1
    assert hb.read_heartbeats(flt.heartbeat_dir)[1]["phase"] in (
        hb.PHASE_SERVE, hb.PHASE_STALLED)


def test_fleet_retry_budget_exhaustion_fails_cleanly(tiny, reference,
                                                     fleets):
    _, _, cfg, params, prompts = tiny
    seen = []
    flt = fleets(cfg, params, _serving(1, retry_budget=0))
    req = flt.submit(prompts[1], NEW, on_finish=lambda r: seen.append(r.state))
    chaos.arm("serve.replica_kill", "raise", match="0", skip=3)
    flt.start()
    assert req.wait(timeout=60)
    assert req.state == FAILED and "retry budget" in req.error
    assert seen == [FAILED]
    assert flt.stats["failed"] == 1 and flt.stats["requeues"] == 0
    ok = flt.submit(prompts[0], NEW)            # the fleet recovered
    assert ok.wait(timeout=60) and ok.state == FINISHED
    assert ok.output_tokens == reference[0]


def test_fleet_deadline_sheds_queued_request_with_timeout(tiny, fleets):
    _, _, cfg, params, _ = tiny
    rng = np.random.default_rng(5)
    serve = {"block_size": 16, "pool_blocks": 6, "max_batch": 1,
             "max_blocks_per_seq": 4, "prefix_cache": False}
    flt = fleets(cfg, params, _serving(1, serve=serve, poll_interval=0.01))
    head = flt.submit(list(rng.integers(1, 64, size=30)), 16)
    late = flt.submit(list(rng.integers(1, 64, size=30)), 16,
                      deadline_s=0.02)
    tail = flt.submit(list(rng.integers(1, 64, size=20)), 4)
    flt.start()
    assert late.wait(timeout=60)
    assert late.state == TIMEOUT and "deadline" in late.error
    assert head.wait(timeout=60) and head.state == FINISHED
    assert tail.wait(timeout=60) and tail.state == FINISHED
    assert flt.stats["timeout"] == 1 and flt.stats["completed"] == 2


def test_fleet_submit_validation_is_synchronous(tiny, fleets):
    _, _, cfg, params, _ = tiny
    serve = {"block_size": 16, "pool_blocks": 3, "max_batch": 2,
             "max_blocks_per_seq": 8}
    flt = fleets(cfg, params, _serving(2, serve=serve, max_queue=1))
    with pytest.raises(ValueError, match="empty prompt"):
        flt.submit([], 4)
    with pytest.raises(ValueError, match="max_model_len"):
        flt.submit(list(range(1, 120)), 32)
    with pytest.raises(ValueError, match="pool has 2"):
        flt.submit(list(range(1, 40)), 16)
    with pytest.raises(ValueError, match="priority tier"):
        flt.submit([1, 2, 3], 4, priority="urgent")
    flt.submit([1, 2, 3], 2)
    with pytest.raises(RuntimeError, match="queue full"):
        flt.submit([4, 5, 6], 2)
    chaos.arm("serve.enqueue")
    with pytest.raises(chaos.ChaosError):
        flt.submit([4, 5, 6], 2)


def test_fleet_overload_ladder_sheds_and_rejects(tiny, fleets):
    _, _, cfg, params, prompts = tiny
    flt = fleets(cfg, params, _serving(1, max_queue=3, batch_highwater=0.99))
    shed = []
    p = prompts[0]
    flt.submit(p, 4, priority=STANDARD)
    flt.submit(p, 4, priority=STANDARD)
    victim = flt.submit(p, 4, priority=BATCH, on_finish=shed.append)
    with pytest.raises(AdmissionRejected) as ei:
        flt.submit(p, 4, priority=BATCH)
    assert ei.value.info["reason"] == "queue_full"
    kept = flt.submit(p, 4, priority=LATENCY)
    assert victim.state == SHED and shed == [victim]
    assert json.loads(victim.error)["reason"] == "displaced_by_tier"
    assert flt.stats["shed"] == 1 and kept.rid in flt._outstanding


def _verdicts(sup_cls, rep_cls, timeout):
    sup = sup_cls(SimpleNamespace(
        fcfg=SimpleNamespace(heartbeat_timeout=timeout)))
    now = time.monotonic()
    out = []
    rep = rep_cls(0)
    rep.thread = SimpleNamespace(is_alive=lambda: False)
    out.append(sup._verdict(rep, {"phase": "SERVE", "ts": time.time()}, now))
    rep = rep_cls(1)
    for rec in ({"phase": "SERVE", "ts": time.time()},
                {"phase": "SERVE", "ts": time.time() - 5.0},
                {"phase": "STALLED", "ts": time.time() - 5.0},
                {"phase": "EXIT", "ts": time.time() - 50.0}):
        out.append(sup._verdict(rep, rec, now))
    rep.started_ts = now - 0.2
    out.append(sup._verdict(rep, None, now))
    rep.started_ts = now - 5.0
    out.append(sup._verdict(rep, None, now))
    rep.warming = True
    out.append(sup._verdict(rep, None, now))
    return out


def test_fleet_supervisor_verdict_units():
    """Model-free: thread death is a crash; a stale non-terminal record
    or a replica that never wrote is silence; a terminal record is a
    conclusion; a warming replica is exempt; 0 disables silence. The
    port's verdicts equal JAX's on the same inputs."""
    for timeout in (1.0, 0.0):
        port = _verdicts(FleetSupervisor, _Replica, timeout)
        assert port == _verdicts(JFleetSupervisor, _JReplica, timeout)
    assert _verdicts(FleetSupervisor, _Replica, 1.0) == [
        "crash", None, "silence", None, None, None, "silence", None]
    rep = _Replica(0)
    rep.warm_failed = True
    rep.thread = SimpleNamespace(is_alive=lambda: False)
    sup = FleetSupervisor(SimpleNamespace(
        fcfg=SimpleNamespace(heartbeat_timeout=1.0)))
    assert sup._verdict(rep, None, time.monotonic()) == "warm-up failed"


def test_fleet_warm_failure_fails_the_replica(tiny, fleets, monkeypatch):
    """A replica whose warm-up raises is a death with its reason in
    ``fleet.deaths``: it never serves on regardless."""
    _, _, cfg, params, prompts = tiny
    flt = fleets(cfg, params, _serving(1, blacklist_after=1,
                                       min_replicas=0))
    flt.start()
    rep = flt._replicas[0]

    def broken(*a, **kw):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(ServingEngine, "run_until_idle", broken)
    flt._restart(0, rep.generation + 1, rep.strikes)
    flt.supervisor.poll()
    deadline = time.monotonic() + 10
    while not flt.deaths and time.monotonic() < deadline:
        flt.supervisor.poll()
        time.sleep(0.01)
    assert flt.deaths[0]["reason"] == "warm-up failed"
    assert "no kernel" in flt.deaths[0]["error"]
    assert flt.deaths[0]["action"] == "blacklist"
    assert flt._replicas[0].state == BLACKLISTED


def test_fleet_straggler_detection_off_by_default(tiny, fleets):
    _, _, cfg, params, _ = tiny
    flt = fleets(cfg, params, _serving(2))
    assert flt.supervisor._straggler is None
    flt2 = fleets(cfg, params, _serving(2, straggler={"enabled": True}))
    assert flt2.supervisor._straggler is not None


def _policy(mod, cfg_cls, **kw):
    base = dict(enabled=True, min_replicas=1, max_replicas=4,
                up_queue_per_replica=4, up_after=2, down_idle_s=10.0,
                cooldown_s=15.0)
    base.update(kw)
    return mod.AutoscalePolicy(cfg_cls(**base))


def _observations(mod, rng):
    """A fake-clock trace: a burst, warming, steady state, a trough,
    deadline pressure, back to idle."""
    seq, t = [], 0.0
    for i in range(80):
        t += float(rng.uniform(0.5, 2.0))
        phase = i // 10
        queue = {0: 0, 1: 20, 2: 30, 3: 2, 4: 0, 5: 0, 6: 1, 7: 0}[phase]
        seq.append((mod.Observation(
            queue_depth=queue + int(rng.integers(0, 2)) * (queue > 0),
            pressured=1 if phase == 6 and i % 2 else 0,
            live=1 + (phase in (2, 3, 4, 5)), warming=int(i in (21, 22)),
            draining=int(i == 59), active_lanes=0 if phase in (0, 4, 5, 7)
            else 3, total_lanes=8), t))
    return seq


@pytest.mark.parametrize("kw", [{}, dict(up_after=1, cooldown_s=0.0),
                                dict(min_replicas=2, max_replicas=2)])
def test_autoscale_policy_decisions_equal_jax(kw):
    rng = np.random.default_rng(11)
    t_pol = _policy(tas, AutoscaleConfig, **kw)
    j_pol = _policy(jas, JAutoscaleConfig, **kw)
    verdicts = []
    for (obs, now), (jobs, _) in zip(_observations(tas, rng),
                                     _observations(
                                         jas, np.random.default_rng(11))):
        v = t_pol.observe(obs, now)
        assert v == j_pol.observe(jobs, now)
        if v is not None:
            assert t_pol.describe(obs) == j_pol.describe(jobs)
        verdicts.append(v)
    if not kw.get("min_replicas"):
        assert tas.SCALE_UP in verdicts and tas.SCALE_DOWN in verdicts
    assert tas.AUTOSCALER_RANK == jas.AUTOSCALER_RANK
    ev = tas.ScaleEvent("up", 1, "queue=9>4x1", 1.0, 9, 1)
    assert ev.as_gauges() == jas.ScaleEvent("up", 1, "queue=9>4x1", 1.0, 9,
                                            1).as_gauges()


_SNAPPY_AS = {"enabled": True, "min_replicas": 1, "max_replicas": 2,
              "up_queue_per_replica": 1, "up_after": 2,
              "down_idle_s": 0.2, "cooldown_s": 0.1}


def test_fleet_autoscale_up_then_drain_down_token_exact(tiny, reference,
                                                        fleets):
    _, _, cfg, params, prompts = tiny
    emitted = {}
    flt = fleets(cfg, params, _serving(1, autoscale=_SNAPPY_AS))
    reqs = [flt.submit(p, NEW, on_token=_ledger(emitted)) for p in prompts]
    flt.start()
    assert flt.drain(timeout=120)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not (
            flt.stats["scale_ups"] >= 1 and flt.stats["scale_downs"] >= 1
            and len(flt.live_replicas()) == 1):
        time.sleep(0.02)
    assert flt.stats["scale_ups"] >= 1 and flt.stats["scale_downs"] >= 1
    assert [r.output_tokens for r in reqs] == reference
    assert [emitted[r.rid] for r in reqs] == reference
    ups = [e for e in flt.scale_events if e.action == tas.SCALE_UP]
    downs = [e for e in flt.scale_events if e.action == tas.SCALE_DOWN]
    assert ups[0].replica == 1 and "queue" in ups[0].reason
    assert downs[0].drained_ts is not None and downs[0].error is None
    assert flt._replicas[downs[0].replica].state == RETIRED
    assert flt.stats["deaths"] == 0
    recs = hb.read_heartbeats(flt.heartbeat_dir)
    assert recs[downs[0].replica]["phase"] == hb.PHASE_EXIT
    assert recs[tas.AUTOSCALER_RANK]["gauges"]["role"] == "AUTOSCALER"


def test_fleet_preemption_token_exact_no_retry_charge(tiny, fleets):
    _, _, cfg, params, prompts = tiny
    serve = dict(SERVE, max_batch=1)
    eng = ServingEngine(cfg, params, serving=serve, device="cpu")
    b_oracle, l_oracle = eng.generate_batch([prompts[2]], 30)[0], \
        eng.generate_batch([prompts[5]], 8)[0]
    emitted = {}
    flt = fleets(cfg, params, _serving(1, serve=serve,
                                       preempt_pressure_s=30.0))
    breq = flt.submit(prompts[2], 30, priority=BATCH,
                      on_token=_ledger(emitted))
    flt.start()
    deadline = time.monotonic() + 30
    while not flt._replicas[0].inflight:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    lreq = flt.submit(prompts[5], 8, priority=LATENCY, deadline_s=20.0)
    assert flt.drain(timeout=120)
    assert flt.stats["preempted"] == 1 and breq.preemptions == 1
    assert breq.retries == 0
    assert breq.output_tokens == b_oracle == emitted[breq.rid]
    assert lreq.output_tokens == l_oracle


def test_init_inference_serve_returns_started_fleets(tiny, reference,
                                                     tmp_path):
    """``serve()`` dispatches: replicas > 1, floor-1 autoscale and
    disaggregated roles each return a started fleet (tokens exact); a
    one-sided disaggregation raises; a plain config returns an engine."""
    _, _, cfg, params, prompts = tiny
    base = {"dtype": "float32", "serving": dict(SERVE)}
    eng = deepspeed_tpu_torch.init_inference(cfg, base,
                                             model_parameters=params,
                                             device="cpu")
    cases = {"replicas": {"replicas": 2},
             "autoscale": {"replicas": 1, "autoscale": dict(_SNAPPY_AS)},
             "disagg": {"prefill_replicas": 1, "decode_replicas": 1}}
    for name, fleet in cases.items():
        fleet = dict(fleet, poll_interval=0.02, heartbeat_interval=0.02,
                     heartbeat_dir=str(tmp_path / name))
        srv = eng.serve(dict(SERVE, fleet=fleet))
        try:
            assert isinstance(srv, ServingFleet) and srv._started
            assert srv.supervisor._thread.is_alive()
            assert srv.generate_batch(prompts[:3], NEW) == reference[:3]
            if name == "autoscale":
                assert srv.autoscale.max_replicas == 2
            if name == "disagg":
                assert srv.disagg and srv.n_replicas == 2
        finally:
            srv.close()
    with pytest.raises(ValueError, match="both be > 0"):
        eng.serve(dict(SERVE, fleet={"prefill_replicas": 1}))
    assert isinstance(eng.serve(), ServingEngine)


def test_launch_counters_exact_under_threads():
    """Each wrapper counts its launches under one lock: N threads calling
    a counted wrapper through a stub launch add up exactly, and a launch
    scope tallies only its own thread's launches."""
    n_threads, per = 8, 2000
    before = tpa.paged_attention.launches
    tallies = [dict() for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as can be
    try:
        def stub_launch(tally):
            with build.launch_scope(tally):
                for _ in range(per):
                    build.count_launch(tpa.paged_attention)

        ts = [threading.Thread(target=stub_launch, args=(t,))
              for t in tallies]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert tpa.paged_attention.launches - before == n_threads * per
    assert tallies == [{"paged_attention": per}] * n_threads
    tpa.paged_attention.launches = before


# ---------------------------------------------------------------------------
# slow: the heavy chaos matrices (each names its tier-1 cousin)


# tier-1 cousin: test_fleet_kill_requeues_exactly_once_token_exact
@pytest.mark.slow
def test_fleet_3replica_kill_matrix(tiny, reference, fleets):
    _, _, cfg, params, prompts = tiny
    for victim in ("0", "1", "2"):
        emitted = {}
        flt = fleets(cfg, params, _serving(3))
        reqs = [flt.submit(p, NEW, on_token=_ledger(emitted))
                for p in prompts]
        chaos.arm("serve.replica_kill", "raise", match=victim, skip=4)
        flt.start()
        assert flt.drain(timeout=120)
        chaos.disarm()
        assert flt.stats["deaths"] == 1
        assert flt.deaths[0]["replica"] == int(victim)
        assert [r.output_tokens for r in reqs] == reference
        assert [emitted[r.rid] for r in reqs] == reference
        flt.close()


# tier-1 cousin: test_fleet_supervisor_verdict_units (the silence verdict)
@pytest.mark.slow
def test_fleet_hang_silence_detected_and_blacklisted(tiny, reference,
                                                     fleets):
    """``serve.replica_hang`` wedges replica 1 with work in hand: it goes
    heartbeat-silent, the supervisor declares it (silence), requeues its
    work and blacklists it; the survivor serves everything token-exact."""
    _, _, cfg, params, prompts = tiny
    flt = fleets(cfg, params, _serving(2, blacklist_after=1,
                                       poll_interval=0.1))
    flt.start()
    flt.warmup()
    flt.fcfg.heartbeat_timeout = 1.0       # now silence means silence
    emitted = {}
    reqs = [flt.submit(p, NEW, on_token=_ledger(emitted)) for p in prompts]
    chaos.arm("serve.replica_hang", "hang", match="1", skip=3)
    assert flt.drain(timeout=120)
    assert flt.stats["deaths"] == 1
    assert flt.deaths[0]["reason"] == "silence"
    assert flt.deaths[0]["action"] == "blacklist"
    assert flt._replicas[1].state == BLACKLISTED
    assert flt._replicas[0].state == LIVE
    assert [r.output_tokens for r in reqs] == reference
    assert [emitted[r.rid] for r in reqs] == reference
    assert hb.read_heartbeats(flt.heartbeat_dir)[1]["phase"] == \
        hb.PHASE_STALLED


# tier-1 cousin: test_fleet_kill_requeues_exactly_once_token_exact
@pytest.mark.slow
def test_fleet_parole_restores_min_replicas(tiny, reference, fleets):
    _, _, cfg, params, prompts = tiny
    flt = fleets(cfg, params, _serving(1, blacklist_after=1,
                                       min_replicas=1))
    reqs = [flt.submit(p, NEW) for p in prompts]
    chaos.arm("serve.replica_kill", "raise", match="0", skip=3)
    flt.start()
    assert flt.drain(timeout=120)
    assert flt.stats["blacklisted"] == 1 and flt.stats["paroles"] == 1
    assert flt._replicas[0].state == LIVE
    assert [r.output_tokens for r in reqs] == reference


# tier-1 cousin: test_fleet_submit_validation_is_synchronous (serve.oom is
# the engine's transient admission failure; its single-engine unit is in
# test_torch_disagg.py)
@pytest.mark.slow
def test_fleet_serve_oom_keeps_other_replicas_serving(tiny, reference,
                                                      fleets):
    _, _, cfg, params, prompts = tiny
    flt = fleets(cfg, params, _serving(2))
    chaos.arm("serve.oom", "raise", times=3)
    reqs = [flt.submit(p, NEW) for p in prompts]
    flt.start()
    assert flt.drain(timeout=120)
    assert chaos.fired("serve.oom")
    assert flt.stats["deaths"] == 0
    assert [r.output_tokens for r in reqs] == reference
