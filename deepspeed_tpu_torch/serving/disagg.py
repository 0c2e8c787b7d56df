"""Disaggregated serving: a PrefillEngine/DecodeEngine pair over a
paged-KV block handoff (counterpart of ``deepspeed_tpu/serving/disagg.py``).

Prefill and decode are different regimes — prefill is compute-bound over
a whole prompt, decode is bandwidth-bound one token at a time — and
the single engine interleaves them in one loop, so every prefill (even
chunked) steals iterations from running decodes. This module splits the
two into ROLES connected by a :class:`BlockHandoff`:

* the **prefill role** (:class:`PrefillEngine`) admits requests under the
  shared block budget, runs CHUNKED prefill (``serving.
  prefill_chunk_tokens`` per iteration — the engine's chunk machinery),
  samples the first token from the last real position's logits, and
  pushes a :class:`HandoffItem` — the request, its refcounted block IDs,
  block table, context length and sampler state (first token, emitted
  prefix) — onto the handoff queue;
* the **decode role** (:class:`DecodeEngine`) pops finished items,
  installs them into its fixed-shape decode lanes, and decodes.

**Zero-copy by construction.** Both roles share ONE
:class:`~.kv_cache.SharedPagedState` — device pool, refcounted
:class:`~.kv_cache.BlockPool`, prefix cache — so the handoff transfers
block *ownership* (a list of ints plus sampler state), never KV bytes.
The refcounted block table is the transfer unit; no logical state is
copied. The roles' forward calls serialize on the shared state's device
lock (both update the pool tensors in place).

**Bounded and deadline-aware.** The queue holds at most
``serving.handoff_queue`` items — a full queue stalls prefill (the item
is retried next iteration; backpressure, never a drop) — and an item
whose request deadline passes while it waits is SHED: blocks released,
request concluded TIMEOUT (handoff wait is queue wait the request's
deadline already bounds).

**Failure domains** (the fleet wires roles as replicas —
``serving.fleet.prefill_replicas`` / ``decode_replicas``; see
serving/fleet.py): a dead prefill replica releases its half-prefilled
request's blocks and requeues it exactly-once (chunk progress carried on
``Request.prefill_progress``); a dead decode replica requeues through
the existing token-exact prompt+emitted path. Chaos failpoints:
``serve.chunk`` (per prefill chunk, in serving/engine.py),
``serve.handoff`` (inside :meth:`BlockHandoff.push`, before the item is
queued — a crash there leaves the blocks with the dying prefill role),
``serve.handoff_drop`` (between pop and install — a crash there leaves a
popped item with the dying decode role). The crash-at-every-failpoint
matrix in the tests pins that every request still concludes
COMPLETED (token-exact) or FAILED-within-retry-budget and that the
pool's free+refcounted accounting balances after recovery.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

import torch

from ..runtime.fabric import ChannelTimeout, LocalEndpoint
from ..testing import chaos
from ..utils.device import resolve_device
from ..utils.logging import logger
from .engine import ServingEngine, _Seq, resolve_kv_dtype
from .kv_cache import NULL_BLOCK, SharedPagedState
from .scheduler import HANDOFF, RUNNING, TIMEOUT, Request

PyTree = Any


class HandoffFull(RuntimeError):
    """The bounded handoff queue is at capacity — the prefill role's
    signal to hold the finished item and retry (backpressure), never to
    drop it."""


@dataclass
class HandoffItem:
    """One finished prefill crossing the prefill->decode boundary: block
    ownership (IDs into the SHARED pool — zero-copy) plus the sampler
    state decode resumes from (``last_tok`` = the first sampled token,
    already on ``req.output_tokens`` as the emitted prefix; ``ctx`` = the
    next-token logits position, i.e. the prompt length)."""
    req: Request
    blocks: List[int]
    table: np.ndarray
    ctx: int
    last_tok: int
    enqueue_ts: float = field(default_factory=time.monotonic)


class BlockHandoff:
    """The bounded, deadline-aware prefill->decode queue (module
    docstring). ``on_push`` (the fleet's registration hook) runs under
    the queue lock, so a consumer can never pop an item before its
    producer-side bookkeeping exists."""

    def __init__(self, pool, capacity: int = 16,
                 on_push: Optional[Callable[[HandoffItem], None]] = None):
        self.pool = pool
        self.capacity = int(capacity)
        self.on_push = on_push
        # the queue is a local fabric endpoint: items ride
        # BY REFERENCE — ownership transfer, never KV bytes — and every
        # push/pop traverses the fabric's net.* chaos surface, the same
        # failure model the cross-process backends exercise
        self._ep = LocalEndpoint(ident="handoff")
        self._mu = threading.Lock()
        self.pushed = 0
        self.popped = 0
        self.timed_out = 0

    @property
    def pending(self) -> int:
        return self._ep.pending()

    def push(self, item: HandoffItem) -> None:
        """Enqueue a finished prefill. The ``serve.handoff`` failpoint —
        and the fabric's ``net.send`` below it — fires BEFORE the item
        is queued or its state mutated: a crash there leaves the blocks
        owned by the (dying) prefill role, whose death path releases
        them — the item is never half-queued. Raises :class:`HandoffFull`
        at capacity."""
        chaos.failpoint("serve.handoff")
        with self._mu:
            if self._ep.pending() >= self.capacity:
                raise HandoffFull(
                    f"handoff queue at capacity ({self.capacity}); "
                    "decode is behind — prefill holds the item")
            self._ep.send({"kind": "handoff", "rid": item.req.rid},
                          item, key="handoff")
            item.req.state = HANDOFF
            self.pushed += 1
            if self.on_push is not None:
                self.on_push(item)

    def pop(self) -> Optional[HandoffItem]:
        # bounded acquire: recv(timeout=0) is a non-blocking poll, but a
        # wedged chaos hook inside it must not hold _mu against push and
        # shed forever — a starved pop returns None like an empty queue
        if not self._mu.acquire(timeout=5.0):
            return None
        try:
            try:
                _meta, item = self._ep.recv(timeout=0.0, key="handoff")
            except ChannelTimeout:
                return None
            self.popped += 1
            return item
        finally:
            self._mu.release()

    def shed_expired(self) -> List[HandoffItem]:
        """Deadline-aware: conclude every queued item whose request
        deadline has passed — blocks released, request TIMEOUT (callback
        fires). Handoff wait is queue wait; the same TTL that bounds
        admission wait bounds it."""
        now = time.monotonic()
        with self._mu:
            expired = [it for _m, it in self._ep.purge(
                lambda _meta, it: it.req.expired(now))]
            self.timed_out += len(expired)
        for it in expired:
            self.pool.release(it.blocks)
            logger.warning("disagg: request %d shed from the handoff "
                           "queue past its deadline", it.req.rid)
            it.req._finish(TIMEOUT,
                           error="deadline exceeded in handoff queue")
        return expired

    def drain_release(self) -> int:
        """Shutdown path: release every queued item's blocks (their
        requests are left to the owner to conclude). Returns items
        drained."""
        n = 0
        while True:
            item = self.pop()
            if item is None:
                return n
            try:
                self.pool.release(item.blocks)
            except ValueError:
                logger.exception("disagg: drain found inconsistent "
                                 "handoff blocks")
            n += 1


class PrefillEngine(ServingEngine):
    """The prefill ROLE: chunked prefill into the SHARED pool, handoff on
    completion. Never decodes — its lanes stay empty. One request prefills at a time (the
    chunk machinery's invariant); a finished item that hits a full
    handoff queue is held and retried (``_ready``), with admission paused
    behind it."""

    role = "PREFILL"

    def __init__(self, cfg, params, serving=None, *, shared: SharedPagedState,
                 handoff: BlockHandoff, **kw):
        super().__init__(cfg, params, serving=serving, shared=shared, **kw)
        self.handoff = handoff
        self._ready: Optional[_Seq] = None    # finished, awaiting queue room
        self._handed: List[Request] = []      # pushed since last take_*

    # the prefill role ALWAYS runs the chunk machinery (chunk <= 0 means
    # one whole-suffix chunk) so completion flows through _install
    def _chunked_mode(self) -> bool:
        return True

    def _admission_capacity(self) -> bool:
        return self._ready is None

    @property
    def idle(self) -> bool:
        return (self.scheduler.pending == 0 and self._prefilling is None
                and self._ready is None)

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.pending or self._prefilling is not None
                    or self._ready is not None)

    @property
    def wants_dispatch(self) -> bool:
        return (self.scheduler.pending == 0 and self._prefilling is None
                and self._ready is None)

    @property
    def backpressured(self) -> bool:
        # a finished item held at a full handoff, or a queued request
        # whose blocks the decode side still holds
        return self._ready is not None or (
            self._prefilling is None and self.scheduler.pending > 0)

    def _install(self, seq: _Seq) -> None:
        self._ready = seq
        self._flush_ready()

    def _flush_ready(self) -> None:
        seq = self._ready
        if seq is None:
            return
        item = HandoffItem(req=seq.req, blocks=seq.blocks, table=seq.table,
                           ctx=seq.ctx, last_tok=seq.last_tok)
        try:
            self.handoff.push(item)
        except HandoffFull:
            return                        # backpressure: retry next step
        self._ready = None
        self._handed.append(seq.req)

    def take_handed_off(self) -> List[Request]:
        """Requests pushed since the last call (the fleet worker's
        post-step bookkeeping hook)."""
        out, self._handed = self._handed, []
        return out

    def step(self) -> int:
        with self._lock:
            self._flush_ready()           # a backpressured item first
            done = self._admit()
            done += self._advance_prefill()
            self.steps += 1
            self.stats["timeout"] = self.scheduler.timed_out
            self._stamp_heartbeat()
            return done

    def warm(self) -> None:
        """Run one chunk-sized prefill off the serving path (kernel
        libraries loaded, the allocator warmed; nothing reaches the
        handoff: a 1-token-budget request concludes at prefill end and
        releases its blocks). Warm requests leave no trace: no
        prefix-cache inserts (``_warming`` gates them — a dummy prompt
        must not hold shared pool blocks per restart) and stats are
        restored."""
        with self._lock:
            n = max(self._chunk, 3)
            saved = dict(self.stats)
            self._warming = True
            try:
                pf = self._start_prefill(Request(prompt=[1] * n,
                                                 max_new_tokens=1))
                self._prefilling = pf
                while self._prefilling is not None:
                    self._advance_prefill()
            finally:
                self._warming = False
                self.stats.update(saved)

    def _collect_held(self, blocks, reqs) -> None:
        if self._ready is not None:
            blocks.append(self._ready.blocks)
            reqs.append(self._ready.req)
            self._ready = None


class DecodeEngine(ServingEngine):
    """The decode ROLE: pops handoff items into its fixed-shape lanes and
    decodes. It never allocates blocks — ownership arrives with the item,
    and :meth:`ServingEngine._finish` releases to the shared pool.

    ``auto_pull=False`` (the fleet) moves the pop/install into the
    fleet's dispatch section so installs are fenced by the replica lock;
    standalone (:class:`DisaggEngine`) pulls inside :meth:`step`. The
    ``serve.handoff_drop`` failpoint fires between pop and install — in
    the fleet that's a replica death with a popped item in hand (cleaned
    up by the death path); standalone, the held item is retried next
    step."""

    role = "DECODE"

    def __init__(self, cfg, params, serving=None, *, shared: SharedPagedState,
                 handoff: BlockHandoff, auto_pull: bool = True, **kw):
        super().__init__(cfg, params, serving=serving, shared=shared, **kw)
        self.handoff = handoff
        self._auto_pull = auto_pull
        self._holding: Optional[HandoffItem] = None   # popped, not installed

    @property
    def idle(self) -> bool:
        return (self.active == 0 and self._holding is None
                and (not self._auto_pull or self.handoff.pending == 0))

    @property
    def has_work(self) -> bool:
        return bool(self.active or self._holding is not None)

    @property
    def wants_dispatch(self) -> bool:
        return False                      # fed by the handoff, not submit

    @property
    def lanes_free(self) -> bool:
        return self._free_slot() is not None

    def install_item(self, item: HandoffItem) -> bool:
        """Install a popped item into a free lane (fleet dispatch path —
        caller holds the replica lock; we take the engine lock so a
        concurrent death-path collection can't interleave)."""
        with self._lock:
            return self._install_locked(item)

    def _install_locked(self, item: HandoffItem) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        item.req.state = RUNNING
        self._slots[slot] = _Seq(item.req, item.blocks, item.table,
                                 item.ctx, item.last_tok)
        return True

    def _pull_handoff(self) -> None:
        # standalone path (caller holds self._lock): a previously-held
        # item (serve.handoff_drop escape) installs first
        if self._holding is not None:
            if not self._install_locked(self._holding):
                return
            self._holding = None
        while self._free_slot() is not None:
            item = self.handoff.pop()
            if item is None:
                return
            self._holding = item
            chaos.failpoint("serve.handoff_drop")
            self._install_locked(item)
            self._holding = None

    def step(self) -> int:
        with self._lock:
            if self._auto_pull:
                self.handoff.shed_expired()
                self._pull_handoff()
            done = self._decode_step() if self.active else 0
            self.steps += 1
            self._stamp_heartbeat()
            return done

    def warm(self) -> None:
        """Run one all-null-table decode step off the serving path: its
        writes sink into the null block and its logits are discarded, so
        the kernels are built and loaded and the allocator warmed before
        the replica goes live — a restarted decode replica must not pay
        that under a live heartbeat timeout."""
        with self._lock:
            B = self.max_batch
            zeros = np.zeros((B,), np.int64)
            self._shared.run(self._forward, self.params,
                             np.zeros((B, 1), np.int64),
                             np.full((B, self.nbk), NULL_BLOCK, np.int32),
                             zeros, (zeros + 1).astype(np.int32))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _collect_held(self, blocks, reqs) -> None:
        if self._holding is not None:
            blocks.append(self._holding.blocks)
            reqs.append(self._holding.req)
            self._holding = None


class DisaggEngine:
    """The single-process disaggregated pair (tests, batch use, and the
    API the fleet mirrors): one PrefillEngine + one DecodeEngine over one
    shared paged state and one handoff queue, stepped together. Greedy
    output is token-exact with whole-prefill serving and with sequential
    ``generate()`` (the acceptance matrix pins all three modes)."""

    def __init__(self, cfg, params, serving=None, heartbeat=None,
                 device=None):
        from ..config.config import ServingConfig
        if serving is None:
            serving = ServingConfig()
        elif isinstance(serving, dict):
            serving = ServingConfig(**serving)
        self.scfg = serving
        dev = resolve_device(device)
        self.shared = SharedPagedState(cfg, serving,
                                       dtype=resolve_kv_dtype(serving),
                                       device=dev)
        self.handoff = BlockHandoff(self.shared.pool,
                                    capacity=serving.handoff_queue)
        self.prefill = PrefillEngine(cfg, params, serving=serving,
                                     shared=self.shared,
                                     handoff=self.handoff,
                                     heartbeat=heartbeat, device=dev)
        # the decode role serves the prefill role's weights (moved and,
        # under int8 weights, packed once)
        self.decode = DecodeEngine(cfg, self.prefill.params,
                                   serving=serving, shared=self.shared,
                                   handoff=self.handoff, device=dev)

    # ------------------------------------------------------------------ facade

    @property
    def pool(self):
        return self.shared.pool

    @property
    def pools(self):
        return self.shared.pools

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               **kw) -> Request:
        return self.prefill.submit(prompt, max_new_tokens, **kw)

    @property
    def idle(self) -> bool:
        return (self.prefill.idle and self.decode.idle
                and self.handoff.pending == 0)

    def step(self) -> int:
        """One disagg iteration: at most one prefill chunk, then one
        decode step — the two roles' device work serializes on the
        shared pool's lock (one process, one device); the fleet runs the
        same pair on worker threads."""
        done = self.prefill.step()
        # drain the handed-off ledger (the fleet's bookkeeping hook) so
        # long-lived standalone use doesn't accumulate dead Requests
        self.prefill.take_handed_off()
        done += self.decode.step()
        return done

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(f"disagg loop not idle after {max_steps} steps")

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 32, temperature: float = 0.0,
                       eos_token_id=None) -> List[List[int]]:
        reqs = [self.submit(p, max_new_tokens, temperature=temperature,
                            eos_token_id=eos_token_id) for p in prompts]
        self.run_until_idle()
        return [r.output_tokens for r in reqs]

    def close(self) -> None:
        self.handoff.drain_release()
        self.prefill.close()
        self.decode.close()

    def __enter__(self) -> "DisaggEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def stats(self):
        """Merged role stats (prefill owns admission/prefill counters,
        decode owns completion counters; 'completed' sums both — a
        one-token request concludes on the prefill side). 'timeout'
        additionally counts handoff-queue sheds, which neither role's
        scheduler sees."""
        merged = dict(self.prefill.stats)
        for k, v in self.decode.stats.items():
            merged[k] = merged.get(k, 0) + v
        merged["timeout"] = merged.get("timeout", 0) + self.handoff.timed_out
        return merged
