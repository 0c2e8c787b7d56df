"""Port parity: disaggregated serving (``deepspeed_tpu_torch/serving/
disagg.py`` and the fleet's prefill / decode roles) against the JAX
package's.

The same flax-initialized f32 weights (2 layers, width 64, llama-style)
serve through both packages on the CPU; greedy tokens are exact:

* ``DisaggEngine`` equals JAX's ``DisaggEngine`` and the port's
  whole-prefill ``ServingEngine``, under whole and chunked prefill;
* the handoff queue is bounded and deadline-aware, and its
  ``serve.handoff`` failpoint leaves the blocks with the caller;
* handoff chaos (``serve.handoff`` standalone, ``serve.handoff_drop`` on
  a fleet's decode replica) recovers token-exact with exact refcounts:
  no block leaks and none is freed twice (``release`` raises on a double
  free, so an empty pool after the prefix cache is cleared proves both);
* a prefill replica killed mid-chunk requeues its request with the chunk
  progress carried; the role gauges ride the heartbeat records;
* the engine's own failpoints: ``serve.oom`` keeps a request queued,
  ``serve.chunk`` in a single engine leaves it queued for a requeue.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import build_model
from deepspeed_tpu.serving.disagg import DisaggEngine as JDisaggEngine

from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.runtime import heartbeat as hb
from deepspeed_tpu_torch.serving.disagg import (BlockHandoff, DisaggEngine,
                                                HandoffFull, HandoffItem)
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.serving.fleet import ServingFleet
from deepspeed_tpu_torch.serving.kv_cache import BlockPool
from deepspeed_tpu_torch.serving.scheduler import (FINISHED, HANDOFF,
                                                   QUEUED, TIMEOUT, Request)
from deepspeed_tpu_torch.testing import chaos

LLAMA = dict(pos_embed="rotary", rotary_interleaved=False, norm="rmsnorm",
             gated_mlp=True, activation="silu", num_kv_heads=2,
             tie_embeddings=False, use_bias=False, mlp_dim_override=96)
SERVE = {"block_size": 16, "pool_blocks": 40, "max_batch": 3,
         "max_blocks_per_seq": 6}
PROMPT_LENS = (5, 21, 33, 11)
NEW = 8


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
    jp = model.init(jax.random.PRNGKey(5),
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
    """Whole-prefill single-engine greedy tokens (the oracle)."""
    _, _, cfg, params, prompts = tiny
    eng = ServingEngine(cfg, params, serving=SERVE, device="cpu")
    return eng.generate_batch(prompts, NEW)


def _fleet_serving(chunk=10, **fleet_kw):
    fleet = {"prefill_replicas": 1, "decode_replicas": 1,
             "poll_interval": 0.02, "heartbeat_interval": 0.02,
             "heartbeat_timeout": 60.0}
    fleet.update(fleet_kw)
    return dict(SERVE, max_batch=2, prefill_chunk_tokens=chunk, fleet=fleet)


@pytest.fixture
def fleets(tmp_path):
    made = []

    def make(cfg, params, serving):
        flt = ServingFleet(cfg, params, serving=serving, device="cpu",
                           heartbeat_dir=str(tmp_path / f"hb{len(made)}"))
        made.append(flt)
        return flt

    yield make
    for flt in made:
        flt.close(timeout=5.0)


def _balanced(pool, prefix_cache):
    """Every block back: the cache's own references dropped, nothing
    else may hold one (a double free would have raised in release)."""
    if prefix_cache is not None:
        prefix_cache.clear()
    return pool.used_count == 0


# ---------------------------------------------------------------------------
# tier-1


@pytest.mark.parametrize("chunk", [0, 10])
def test_disagg_engine_tokens_equal_jax_and_whole_prefill(tiny, reference,
                                                          chunk):
    jcfg, jp, cfg, params, prompts = tiny
    serving = dict(SERVE, prefill_chunk_tokens=chunk)
    jeng = JDisaggEngine(jcfg, jp, serving=serving)
    try:
        jax_out = jeng.generate_batch(prompts, NEW)
    finally:
        jeng.close()
    eng = DisaggEngine(cfg, params, serving=serving, device="cpu")
    try:
        out = eng.generate_batch(prompts, NEW)
        assert out == jax_out == reference
        assert eng.handoff.pushed == eng.handoff.popped == len(prompts)
        assert eng.prefill.active == 0          # the prefill role never decodes
        st = eng.stats
        assert st["completed"] == len(prompts)
        assert st["prefill_tokens"] == sum(PROMPT_LENS) - \
            st["prefix_hit_tokens"]
    finally:
        eng.close()
    assert _balanced(eng.pool, eng.shared.prefix_cache)


def test_handoff_bounded_and_deadline_aware():
    pool = BlockPool(num_blocks=16, block_size=4)
    ho = BlockHandoff(pool, capacity=1)

    def item(req):
        blocks = pool.alloc(1)
        return HandoffItem(req=req, blocks=blocks,
                           table=np.asarray(blocks, np.int32), ctx=4,
                           last_tok=1)

    a = item(Request(prompt=[1], max_new_tokens=4))
    b = item(Request(prompt=[2], max_new_tokens=4))
    ho.push(a)
    assert a.req.state == HANDOFF
    with pytest.raises(HandoffFull):
        ho.push(b)                              # backpressure, no drop
    assert ho.pending == 1
    got = ho.pop()
    assert got is a and ho.pop() is None
    pool.release(got.blocks)
    done = []
    late = Request(prompt=[3], max_new_tokens=4,
                   deadline_ts=time.monotonic() - 1.0,
                   on_finish=lambda r: done.append(r.state))
    ho.push(item(late))
    shed = ho.shed_expired()
    assert [it.req.rid for it in shed] == [late.rid]
    assert late.state == TIMEOUT and done == [TIMEOUT]
    assert ho.timed_out == 1
    pool.release(b.blocks)
    assert pool.used_count == 0


def test_handoff_push_failpoint_leaves_blocks_with_caller():
    pool = BlockPool(num_blocks=8, block_size=4)
    ho = BlockHandoff(pool, capacity=4)
    blocks = pool.alloc(1)
    it = HandoffItem(req=Request(prompt=[1], max_new_tokens=2),
                     blocks=blocks, table=np.asarray(blocks, np.int32),
                     ctx=4, last_tok=0)
    chaos.arm("serve.handoff", "raise", times=1)
    with pytest.raises(chaos.ChaosError):
        ho.push(it)
    assert ho.pending == 0 and pool.refcount(blocks[0]) == 1
    ho.push(it)                                 # the retry lands
    assert ho.pending == 1
    assert ho.drain_release() == 1 and pool.used_count == 0


def test_disagg_handoff_chaos_refcount_exact(tiny, reference):
    """A ``serve.handoff`` crash mid-run on the standalone pair: the
    finished item is held and retried, every request finishes
    token-exact, and the shared pool balances exactly."""
    _, _, cfg, params, prompts = tiny
    eng = DisaggEngine(cfg, params, serving=dict(SERVE,
                                                 prefill_chunk_tokens=10),
                       device="cpu")
    reqs = [eng.submit(p, NEW) for p in prompts]
    chaos.arm("serve.handoff", "raise", times=1, skip=1)
    raised = False
    for _ in range(2000):
        if eng.idle:
            break
        try:
            eng.step()
        except chaos.ChaosError:
            raised = True
    assert raised and chaos.fired("serve.handoff")
    assert [r.output_tokens for r in reqs] == reference
    assert all(r.state == FINISHED for r in reqs)
    eng.close()
    assert _balanced(eng.pool, eng.shared.prefix_cache)


def test_disagg_fleet_tokens_and_handoff_drop_refcounts(tiny, reference,
                                                        fleets):
    """The fleet's 1 + 1 roles over one shared pool: token-exact with
    handoffs counted; then ``serve.handoff_drop`` kills the decode
    replica with a popped item in hand — its blocks ride the quarantine,
    the request requeues exactly once, and the pool balances exactly."""
    _, _, cfg, params, prompts = tiny
    flt = fleets(cfg, params, _fleet_serving(retry_budget=3)).start()
    out = flt.generate_batch(prompts, NEW, timeout=120)
    assert out == reference
    assert flt._handoff.pushed == flt._handoff.popped == len(prompts)
    recs = hb.read_heartbeats(flt.heartbeat_dir)
    roles = {r: (rec.get("gauges") or {}).get("role")
             for r, rec in recs.items()}
    assert roles == {0: "PREFILL", 1: "DECODE"}
    flt.close()
    flt._drain_quarantine()
    assert _balanced(flt._shared.pool, flt._shared.prefix_cache)

    emitted = {}
    flt = fleets(cfg, params, _fleet_serving(retry_budget=3))
    reqs = [flt.submit(p, NEW, on_token=lambda r, t: emitted.setdefault(
        r.rid, []).append(t)) for p in prompts]
    chaos.arm("serve.handoff_drop", "raise", times=1, skip=1)
    flt.start()
    assert flt.drain(timeout=120)
    assert chaos.fired("serve.handoff_drop")
    assert flt.stats["deaths"] == 1 and flt.deaths[0]["replica"] == 1
    assert [r.output_tokens for r in reqs] == reference
    assert [emitted[r.rid] for r in reqs] == reference
    flt.close()
    flt._drain_quarantine()
    assert _balanced(flt._shared.pool, flt._shared.prefix_cache)


def test_disagg_fleet_requeue_carries_chunk_progress(tiny, fleets):
    """A prefill replica killed on a later chunk of a long prompt
    requeues the request with the dead leg's chunk progress, and the
    retry completes token-exact."""
    _, _, cfg, params, _ = tiny
    rng = np.random.default_rng(3)
    long_prompt = [int(t) for t in rng.integers(1, 64, size=40)]
    oracle = ServingEngine(cfg, params, serving=SERVE,
                           device="cpu").generate_batch([long_prompt], 6)[0]
    flt = fleets(cfg, params, _fleet_serving(retry_budget=2))
    req = flt.submit(long_prompt, 6)
    chaos.arm("serve.chunk", "raise", times=1, skip=2)
    flt.start()
    assert req.wait(timeout=60) and req.state == FINISHED
    assert req.output_tokens == oracle
    assert req.retries == 1 and req.prefill_progress > 0
    assert flt.deaths[0]["replica"] == 0
    flt.close()
    flt._drain_quarantine()
    assert _balanced(flt._shared.pool, flt._shared.prefix_cache)


def test_engine_failpoints_keep_requests_queued(tiny, reference):
    """``serve.oom`` (in ``BlockPool.alloc``) defers admission — the
    request stays queued and is served next iteration; ``serve.chunk``
    escapes a single engine's step with the request QUEUED and its
    blocks released; ``serve.enqueue`` surfaces at submit."""
    _, _, cfg, params, prompts = tiny
    eng = ServingEngine(cfg, params, serving=SERVE, device="cpu")
    chaos.arm("serve.oom", "raise", times=2)
    assert eng.generate_batch(prompts, NEW) == reference
    assert len(chaos.fired("serve.oom")) == 2
    eng = ServingEngine(cfg, params, serving=dict(SERVE,
                                                  prefill_chunk_tokens=8),
                        device="cpu")
    req = eng.submit(prompts[1], NEW)
    chaos.arm("serve.chunk", "raise", times=1, skip=1)
    eng.step()
    with pytest.raises(chaos.ChaosError):
        eng.step()
    assert req.state == QUEUED and eng.pool.used_count == 0
    chaos.arm("serve.enqueue")
    with pytest.raises(chaos.ChaosError):
        eng.submit(prompts[0], 2)


def test_held_state_preempt_and_cancel(tiny):
    """The fleet hooks on a plain engine: ``has_work`` / ``wants_dispatch``
    pace a worker, ``preempt_request`` evicts a running lane (blocks back,
    request QUEUED, tokens kept), ``cancel_request`` withdraws a queued
    one, ``held_state`` detaches every held sequence."""
    _, _, cfg, params, prompts = tiny
    eng = ServingEngine(cfg, params, serving=dict(SERVE, max_batch=2,
                                                  prefix_cache=False),
                        device="cpu")
    assert not eng.has_work and eng.wants_dispatch
    a, b = eng.submit(prompts[0], NEW), eng.submit(prompts[3], NEW)
    c = eng.submit(prompts[1], NEW)
    assert eng.has_work and not eng.wants_dispatch
    eng.step()
    assert a.state == b.state == "RUNNING" and c.state == QUEUED
    assert eng.cancel_request(c) and eng.scheduler.pending == 0
    n_tok = len(a.output_tokens)
    assert eng.preempt_request(a) and a.state == QUEUED
    assert len(a.output_tokens) == n_tok and eng.stats["preempted"] == 1
    assert not eng.preempt_request(a)
    blocks, reqs = eng.held_state()
    assert reqs == [b] and len(blocks) == 1
    eng.pool.release(blocks[0])
    assert eng.pool.used_count == 0 and eng.active == 0


# ---------------------------------------------------------------------------
# slow (tier-1 cousins: test_disagg_fleet_tokens_and_handoff_drop_refcounts
# and test_disagg_fleet_requeue_carries_chunk_progress)


@pytest.mark.slow
@pytest.mark.parametrize("failpoint", ["serve.chunk", "serve.handoff",
                                       "serve.handoff_drop"])
def test_disagg_fleet_crash_matrix_all_failpoints(tiny, reference, fleets,
                                                  failpoint):
    _, _, cfg, params, prompts = tiny
    emitted = {}
    flt = fleets(cfg, params, _fleet_serving(retry_budget=3))
    reqs = [flt.submit(p, NEW, on_token=lambda r, t: emitted.setdefault(
        r.rid, []).append(t)) for p in prompts]
    chaos.arm(failpoint, "raise", times=1, skip=1)
    flt.start()
    assert flt.drain(timeout=120)
    assert chaos.fired(failpoint) and flt.stats["deaths"] == 1
    assert [r.output_tokens for r in reqs] == reference
    assert [emitted[r.rid] for r in reqs] == reference
    flt.close()
    flt._drain_quarantine()
    assert _balanced(flt._shared.pool, flt._shared.prefix_cache)
