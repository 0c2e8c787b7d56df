"""Port parity: the process-placement fleet
(``deepspeed_tpu_torch/serving/procfleet.py`` and its child,
``replica_worker.py``).

Two CPU child processes serve the 2-layer, width-64 llama-style model
from the weights the hub stages once (flat npz, the port's ``load_tree``
in the child), over the fabric's TCP star:

* their greedy tokens equal the port's thread fleet's (which
  ``test_torch_fleet.py`` holds to the JAX ``ServingFleet``), with every
  ``on_token`` fired once;
* a child killed by ``serve.replica_kill`` in kill mode (``os._exit``)
  is restarted by the hub, and the restarted child serves token-exact;
* ``init_inference(...).serve()`` with ``placement: "process"`` returns a
  started ``ProcessFleet``; the config wire format round-trips;
* each spawn (the children's start, a restart) runs on its own clock:
  past it the test kills the children itself and fails. A spawn of two
  children takes about 5 s on an idle host and up to ~10 s with the
  suite's six workers beside it, so the clock is 30 s.

The JAX ``ProcessFleet`` leg (its children compile) runs behind ``slow``;
its tier-1 cousin is ``test_serve_returns_two_children_token_exact``.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models.transformer import get_config, init_params
from deepspeed_tpu_torch.runtime import heartbeat as hb
from deepspeed_tpu_torch.serving import (ProcessFleet, ServingEngine,
                                         ServingFleet, make_fleet)
from deepspeed_tpu_torch.serving.replica_worker import (cfg_from_dict,
                                                        cfg_to_dict)
from deepspeed_tpu_torch.serving.scheduler import FINISHED
from deepspeed_tpu_torch.testing import chaos

LLAMA = dict(pos_embed="rotary", rotary_interleaved=False, norm="rmsnorm",
             gated_mlp=True, activation="silu", num_kv_heads=2,
             tie_embeddings=False, use_bias=False, mlp_dim_override=96)
SERVE = {"block_size": 16, "pool_blocks": 40, "max_batch": 3,
         "max_blocks_per_seq": 6, "prefix_cache": False}
SPAWN_CLOCK_S = 30.0
NEW = 10


@pytest.fixture(autouse=True)
def _port_chaos():
    chaos.reset_for_tests()
    yield
    chaos.reset_for_tests()


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("gpt2-tiny", hidden_size=64, num_layers=2, num_heads=4,
                     vocab_size=64, max_seq_len=128, dtype=torch.float32,
                     **LLAMA)
    params = init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(1, 64, size=n)]
               for n in (5, 12, 16, 9, 14, 7)]
    return cfg, params, prompts


@pytest.fixture(scope="module")
def reference(tiny, tmp_path_factory):
    """The thread fleet's tokens (2 replicas) and the engine's."""
    cfg, params, prompts = tiny
    eng_out = ServingEngine(cfg, params, serving=SERVE,
                            device="cpu").generate_batch(prompts, NEW)
    flt = ServingFleet(cfg, params, device="cpu", serving=dict(
        SERVE, fleet={"replicas": 2, "poll_interval": 0.02}),
        heartbeat_dir=str(tmp_path_factory.mktemp("thread_hb")))
    try:
        flt.start()
        out = flt.generate_batch(prompts, NEW, timeout=60)
    finally:
        flt.close()
    assert out == eng_out
    return out


def _scfg(replicas=2, **fleet):
    f = {"replicas": replicas, "placement": "process",
         "heartbeat_timeout": 30.0, "poll_interval": 0.02,
         "heartbeat_interval": 0.05, "retry_budget": 2}
    f.update(fleet)
    return dict(SERVE, fleet=f)


class _SpawnClock:
    """Kills a fleet's child processes if a spawn outlives its clock;
    ``lap()`` starts the clock of the next spawn (a restart)."""

    def __init__(self, seconds):
        self.fleets, self.expired = [], False
        self.seconds = seconds
        self._timer = None
        self.lap()

    def lap(self):
        if self._timer is not None:
            self._timer.cancel()
        self.t0 = time.monotonic()
        self._timer = threading.Timer(self.seconds, self._expire)
        self._timer.daemon = True
        self._timer.start()

    def _expire(self):
        self.expired = True
        for fl in self.fleets:
            for rep in list(fl._replicas):
                if rep.proc is not None and rep.proc.poll() is None:
                    rep.proc.kill()

    def stop(self):
        self._timer.cancel()
        return time.monotonic() - self.t0


@pytest.fixture
def spawn_clock():
    clock = _SpawnClock(SPAWN_CLOCK_S)
    yield clock
    clock.stop()
    for fl in clock.fleets:
        fl.close(timeout=5.0)
        for rep in fl._replicas:
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.kill()
                rep.proc.wait(5.0)
    assert not clock.expired, f"spawn outlived its {SPAWN_CLOCK_S}s clock"


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def test_cfg_wire_roundtrip(tiny):
    cfg, _, _ = tiny
    d = json.loads(json.dumps(cfg_to_dict(cfg)))
    cfg2 = cfg_from_dict(d)
    assert cfg2 == cfg and cfg2.dtype == torch.float32
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16, layer_windows=(4, 0))
    assert cfg_from_dict(json.loads(json.dumps(cfg_to_dict(bf)))) == bf


def test_placement_dispatch(tiny):
    cfg, params, _ = tiny
    with pytest.raises(ValueError, match="placement"):
        make_fleet(cfg, params, serving={"fleet": {"placement": "bogus"}},
                   device="cpu")
    with pytest.raises(ValueError, match="process"):
        ServingFleet(cfg, params, serving={"fleet": {"placement": "process"}},
                     device="cpu")
    with pytest.raises(ValueError, match="disagg"):
        ProcessFleet(cfg, params, device="cpu", serving={
            "fleet": {"placement": "process", "prefill_replicas": 1,
                      "decode_replicas": 1}})


def test_serve_returns_two_children_token_exact(tiny, reference, tmp_path,
                                               spawn_clock):
    """``init_inference(...).serve()`` with ``placement: "process"``
    returns a started ``ProcessFleet`` of two CPU children: token-exact
    with the thread fleet, every token emitted once, SERVE records with
    the children's gauges, EXIT records after close."""
    cfg, params, prompts = tiny
    eng = init_inference(cfg, {"dtype": "float32"}, model_parameters=params,
                         device="cpu")
    srv = eng.serve(_scfg(2, heartbeat_dir=str(tmp_path / "hb")))
    spawn_clock.fleets.append(srv)
    assert isinstance(srv, ProcessFleet) and srv._started
    assert srv.device.type == "cpu"
    srv.warmup(timeout=SPAWN_CLOCK_S)
    pids = srv.pids()
    assert sorted(pids) == [0, 1] and os.getpid() not in pids.values()
    emitted = {}
    reqs = [srv.submit(p, NEW, on_token=lambda r, t: emitted.setdefault(
        r.rid, []).append(t)) for p in prompts]
    assert srv.drain(timeout=SPAWN_CLOCK_S)
    assert [r.output_tokens for r in reqs] == reference
    assert [emitted[r.rid] for r in reqs] == reference
    assert all(r.state == FINISHED for r in reqs)
    assert sorted(srv.kernel_launches) == [0, 1]  # children report counts
    recs = hb.read_heartbeats(str(tmp_path / "hb"))
    assert {recs[i]["gauges"]["pid"] for i in (0, 1)} == set(pids.values())
    srv.close()
    assert spawn_clock.stop() <= SPAWN_CLOCK_S
    recs = hb.read_heartbeats(str(tmp_path / "hb"))
    assert [recs[i]["phase"] for i in (0, 1)] == [hb.PHASE_EXIT] * 2
    assert all(p.proc.poll() is not None for p in srv._replicas)


def test_kill_mode_child_is_restarted_token_exact(tiny, reference, tmp_path,
                                                  spawn_clock):
    """Replica 1's first process dies by ``serve.replica_kill`` in kill
    mode (``os._exit(13)``; the spec rides the FIRST spawn only): the hub
    records the death and restarts the child, the batch in flight stays
    token-exact, and the restarted child serves a second batch
    token-exact."""
    cfg, params, prompts = tiny
    fl = ProcessFleet(
        cfg, params, serving=_scfg(2), device="cpu",
        heartbeat_dir=str(tmp_path / "hb"), workdir=str(tmp_path / "w"),
        log_dir=str(tmp_path / "logs"),
        env_first={"DSTPU_CHAOS": "serve.replica_kill:kill:match=1:skip=60"})
    spawn_clock.fleets.append(fl)
    fl.start()
    # the first child's pid, taken before the warm-up: under load the
    # kill (60 loop iterations, idle ones included) can land during it
    first_pid = fl.pids()[1]
    fl.warmup(timeout=SPAWN_CLOCK_S)
    reqs = [fl.submit(p, NEW) for p in prompts]
    assert fl.drain(timeout=SPAWN_CLOCK_S)
    assert [r.output_tokens for r in reqs] == reference
    spawn_clock.lap()                              # the restart's clock
    # the kill fires on replica 1's loop (it iterates while idle too)
    _wait(lambda: fl.stats["restarts"] >= 1, SPAWN_CLOCK_S,
          "replica 1 was never killed and restarted")
    death = fl.deaths[0]
    assert death["replica"] == 1 and death["action"] == "restart"
    assert death["reason"] == "process exit rc=13"
    fl.warmup(timeout=SPAWN_CLOCK_S)
    assert fl.pids()[1] != first_pid and fl.stats["deaths"] == 1
    reqs = [fl.submit(p, NEW) for p in prompts]
    assert fl.drain(timeout=SPAWN_CLOCK_S)
    assert [r.output_tokens for r in reqs] == reference
    assert any(r.replica == 1 for r in reqs)       # the new child served
    fl.close()
    assert all(p.proc.poll() is not None for p in fl._replicas
               if p.proc is not None)
    assert spawn_clock.stop() <= SPAWN_CLOCK_S


# tier-1 cousin: test_serve_returns_two_children_token_exact
@pytest.mark.slow
def test_process_fleet_tokens_equal_jax_process_fleet(tmp_path):
    """The JAX ProcessFleet and the port's, on the same weights: equal
    greedy tokens (the JAX children compile, hence slow)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import build_model
    from deepspeed_tpu.serving import ProcessFleet as JProcessFleet
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    _, jcfg = build_model("gpt2-tiny", hidden_size=64, num_layers=2,
                          num_heads=4, vocab_size=64, max_seq_len=128,
                          attention_impl="reference", dtype=jnp.float32,
                          **LLAMA)
    model, _ = build_model(jcfg)
    jp = jax.device_get(model.init(
        jax.random.PRNGKey(3),
        {"input_ids": np.zeros((1, 8), np.int32)})["params"])
    f = {fl.name: getattr(jcfg, fl.name) for fl in dataclasses.fields(jcfg)}
    f["dtype"] = torch.float32
    cfg = TransformerConfig(**f)
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8], [9, 9, 9]]
    outs = []
    for name, fleet in (
            ("jax", lambda: JProcessFleet(
                jcfg, jp, serving=_scfg(2),
                heartbeat_dir=str(tmp_path / "jhb"),
                workdir=str(tmp_path / "jw"))),
            ("port", lambda: ProcessFleet(
                cfg, params_from_jax(jp), serving=_scfg(2), device="cpu",
                heartbeat_dir=str(tmp_path / "thb"),
                workdir=str(tmp_path / "tw")))):
        fl = fleet()
        try:
            fl.start()
            fl.warmup(timeout=240)
            reqs = [fl.submit(p, NEW) for p in prompts]
            assert fl.drain(timeout=240)
            outs.append([r.output_tokens for r in reqs])
        finally:
            fl.close()
    assert outs[0] == outs[1]
