"""ServingEngine — the continuous-batching serving loop (counterpart of
``deepspeed_tpu/serving/engine.py``).

Requests are submitted from any thread, admitted under the block-pool
budget, prefilled into paged KV blocks (reusing cached prefix blocks for
shared prompts), and decoded in flight: new prefills join as finishing
sequences free their blocks, with no batch-drain barrier. The decode step
always runs ``max_batch`` lanes over a ``[max_batch, max_blocks_per_seq]``
block table, so admissions and completions change data, never shapes.

Greedy output is token-exact with the JAX package's engine on the same
weights in f32 (the tests pin it). Sampling draws from a
``torch.Generator`` seeded by ``serving.seed``, so sampled tokens differ
from the JAX engine's, which draws from ``jax.random``.

Under tensor parallelism (``tp``, this rank's ``TPContext``) every rank
of the model group runs this same loop on the same submissions: the
same scheduler decisions and block tables, its heads' pools, its shards
of the weights, and the gathered logits, from which identically seeded
generators pick the same tokens on every rank.

Supervision: each loop iteration stamps a ``SERVE`` heartbeat record
(runtime/heartbeat.py) with queue / active-lane gauges, and
``watchdog.serve_timeout`` arms the stall watchdog (rc 117 on a wedged
iteration, :meth:`ServingEngine.arm_watchdog`). The fleet
(serving/fleet.py, serving/procfleet.py) and the disaggregated roles
(serving/disagg.py) drive the engine through its fleet hooks:
``has_work``, ``wants_dispatch``, ``held_state``, ``preempt_request``,
``cancel_request`` and the ``_admission_capacity`` / ``_chunked_mode`` /
``_install`` override points. Chaos failpoints: ``serve.chunk`` per
prefill chunk, ``serve.oom`` in ``BlockPool.alloc``, ``serve.enqueue``
in ``Scheduler.submit``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.generation import ensure_scan_layout
from ..models.transformer import TransformerConfig
from ..runtime.heartbeat import PHASE_EXIT, PHASE_SERVE
from ..testing import chaos
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .kv_cache import NULL_BLOCK, BlockPoolExhausted, SharedPagedState
from .model_runner import paged_forward
from .scheduler import (FAILED, FINISHED, PREFILL, PRIORITY_TIERS, QUEUED,
                        RUNNING, STANDARD, TIER_RANK, Request, Scheduler)

PyTree = Any

_KV_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "f32": torch.float32, "float32": torch.float32,
              "int8": torch.int8, None: None}

def resolve_kv_dtype(serving):
    """``serving.kv_cache_dtype`` -> torch dtype (None = model dtype)."""
    if serving.kv_cache_dtype not in _KV_DTYPES:
        raise ValueError(
            f"serving.kv_cache_dtype={serving.kv_cache_dtype!r} is not "
            f"supported; choose one of "
            f"{sorted(k for k in _KV_DTYPES if k)} or null for the "
            "model dtype")
    return _KV_DTYPES[serving.kv_cache_dtype]


def lane_topk_topp(logits: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Per-lane top-k / top-p filter: ``logits`` [B, V] (already
    temperature-scaled), ``top_k`` [B] int (<= 0 = off), ``top_p`` [B]
    float (>= 1 = off). The kth value keeps ties; the nucleus is taken
    positionally in the sorted order and always keeps the top token. One
    descending sort serves both filters, and the result scatters back
    through it."""
    B, V = logits.shape
    order = torch.argsort(-logits, dim=-1, stable=True)
    sl = torch.gather(logits, -1, order)                         # desc
    k = torch.clamp(top_k.long(), 1, V)
    kth = torch.gather(sl, -1, (k - 1)[:, None])                 # [B, 1]
    keep_k = (top_k[:, None] <= 0) | (sl >= kth)
    neg = torch.full_like(sl, -1e30)
    probs = torch.softmax(torch.where(keep_k, sl, neg), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = ((cum - probs) < top_p[:, None]) | (top_p[:, None] >= 1.0)
    final_sorted = torch.where(keep_k & keep_p, sl, neg)
    return torch.full_like(logits, -1e30).scatter(-1, order, final_sorted)


@dataclass
class _Seq:
    """One active lane: a RUNNING request's bookkeeping."""
    req: Request
    blocks: List[int]                  # every block this seq holds
    table: np.ndarray                  # [max_blocks_per_seq] i32 physical ids
    ctx: int                           # tokens whose K/V is in the pool
    last_tok: int                      # sampled, not yet written back


@dataclass
class _Prefilling:
    """A prompt mid-chunked-prefill: its lifetime blocks are allocated,
    ``done`` tokens of K/V are in the pool, and each loop iteration
    advances at most ``serving.prefill_chunk_tokens`` more."""
    req: Request
    blocks: List[int]
    table: np.ndarray
    done: int
    total: int                         # == len(req.prompt)


class ServingEngine:
    """Continuous-batching server over a paged KV cache (module docstring).

    ``params``: scan-layout (or per-layer) parameter tree of tensors; it is
    moved to ``device`` (default CUDA; ``device="cpu"`` runs the plain
    PyTorch versions of the kernels). ``serving``: a ``ServingConfig`` or
    a dict of its fields. ``generator``: the sampling generator (default:
    one on ``device`` seeded with ``serving.seed``). ``tp``: this rank's
    ``TPContext`` when ``params`` are its model-axis shards (module
    docstring). ``heartbeat``: a ``runtime.heartbeat.HeartbeatWriter``
    that every loop iteration stamps."""

    #: heartbeat-gauge role tag; the disaggregated roles override it
    #: (``dstpu health`` shows ``role=PREFILL`` / ``role=DECODE``)
    role: Optional[str] = None

    def __init__(self,
                 cfg: TransformerConfig,
                 params: PyTree,
                 serving=None,
                 heartbeat=None,
                 generator: Optional[torch.Generator] = None,
                 device=None,
                 shared: Optional[SharedPagedState] = None,
                 tp=None):
        from ..config.config import ServingConfig
        if serving is None:
            serving = ServingConfig()
        elif isinstance(serving, dict):
            serving = ServingConfig(**serving)
        self.scfg = serving
        self.cfg = cfg
        self.device = resolve_device(device)
        bs = int(serving.block_size)
        self.block_size = bs
        self.max_batch = int(serving.max_batch)
        self.max_model_len = min(int(serving.max_blocks_per_seq) * bs,
                                 cfg.max_seq_len)
        self.nbk = -(-self.max_model_len // bs)      # table width
        if cfg.rope_scaling_type == "dynamic":
            raise NotImplementedError(
                "serving does not support rope_scaling_type='dynamic' "
                "(length-dependent table); use linear/llama3 scaling")
        params = ensure_scan_layout(params, cfg.num_layers)
        self.params = _to_device(params, self.device)
        self.tp = tp
        kv_dtype = resolve_kv_dtype(serving)
        if serving.weight_dtype is not None:
            if serving.weight_dtype != "int8":
                raise ValueError(
                    f"serving.weight_dtype {serving.weight_dtype!r}: only "
                    "'int8' (blockwise weight-only) or null")
            # pack once: dense kernels -> blockwise int8 + per-256-element
            # f32 scales; the decode matmuls then run the quant_matmul
            # kernel and never materialize a full-precision weight
            from ..ops.quant_matmul import pack_decode_weights
            _check_row_blocks(self.params, tp)
            self.params = pack_decode_weights(self.params)
        self._shared = shared if shared is not None else SharedPagedState(
            cfg, serving, dtype=kv_dtype, device=self.device, tp=tp)
        self.scheduler = Scheduler(self.pool, serving.max_queue,
                                   self.max_model_len, self.prefix_cache,
                                   aging_s=serving.fleet.priority_aging_s,
                                   batch_highwater=serving.fleet
                                   .batch_highwater)
        self._slots: List[Optional[_Seq]] = [None] * self.max_batch
        self._prefilling: Optional[_Prefilling] = None
        self._warming = False      # role warms: no prefix-cache inserts
        self._chunk = int(serving.prefill_chunk_tokens)
        self._use_filters = bool(serving.sampling_filters)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(serving.seed))
        self._gen = generator
        self._heartbeat = heartbeat
        self._watchdog = None
        self._lock = threading.Lock()
        self.steps = 0                     # loop iterations executed
        self.stats: Dict[str, int] = {
            "completed": 0, "failed": 0, "timeout": 0,
            "tokens_generated": 0, "prefill_tokens": 0,
            "prefix_hit_tokens": 0, "preempted": 0}
        log_dist(
            f"ServingEngine: pool={serving.pool_blocks}x{bs} tokens "
            f"(~{(serving.pool_blocks - 1) * bs} cacheable), "
            f"max_batch={self.max_batch}, max_model_len="
            f"{self.max_model_len}, prefix_cache={serving.prefix_cache}, "
            f"prefill_chunk={self._chunk or 'whole'}, device={self.device}",
            ranks=[0])

    # -- the paged-KV state --------------------------------------------------

    @property
    def pool(self):
        return self._shared.pool

    @property
    def pools(self):
        return self._shared.pools

    @property
    def prefix_cache(self):
        return self._shared.prefix_cache

    # -- device programs -------------------------------------------------------

    def _pick(self, logits: torch.Tensor, temps: np.ndarray,
              tks: np.ndarray, tps: np.ndarray) -> np.ndarray:
        """Per-lane sampling: greedy lanes (temperature <= 0) take the
        argmax, the others draw from softmax(logits / temperature), after
        the per-lane top-k/top-p filter when ``serving.sampling_filters``.
        Returns host token ids [B]."""
        greedy = torch.argmax(logits, dim=-1)
        if not (temps > 0.0).any():
            return greedy.cpu().numpy()
        dev = logits.device
        t = torch.as_tensor(temps, device=dev)
        scaled = logits / torch.clamp(t, min=1e-6)[:, None]
        if self._use_filters:
            scaled = lane_topk_topp(scaled, torch.as_tensor(tks, device=dev),
                                    torch.as_tensor(tps, device=dev))
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=self._gen)[:, 0]
        return torch.where(t <= 0.0, greedy, sampled).cpu().numpy()

    def _forward(self, params, pools, ids, tables, q0, ctx):
        dev = self.device
        with torch.no_grad():
            logits, _ = paged_forward(
                self.cfg, params, torch.as_tensor(ids, device=dev), pools,
                torch.as_tensor(tables, device=dev),
                torch.as_tensor(q0, device=dev),
                torch.as_tensor(ctx, device=dev), self.block_size, tp=self.tp)
        return logits

    # -- submission ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, eos_token_id: Optional[int] = None,
               on_finish=None, top_k=None, top_p=None,
               deadline_s: Optional[float] = None,
               priority: str = STANDARD) -> Request:
        """Enqueue a generation request (thread-safe); returns the live
        :class:`Request`. ``deadline_s`` is a queue-wait TTL; ``priority``
        picks the latency/standard/batch tier. ``top_k``/``top_p`` need
        ``serving.sampling_filters``."""
        if (top_k is not None or top_p is not None) \
                and not self._use_filters:
            raise NotImplementedError(
                "per-lane top_k/top_p need serving.sampling_filters=true "
                "(the nucleus filter adds a [B, V] sort to every decode "
                "step)")
        if priority not in TIER_RANK:
            raise ValueError(f"unknown priority tier {priority!r}; pick "
                             f"one of {PRIORITY_TIERS}")
        req = Request(prompt=[int(t) for t in prompt],
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature),
                      top_k=int(top_k) if top_k is not None else None,
                      top_p=float(top_p) if top_p is not None else None,
                      eos_token_id=eos_token_id, on_finish=on_finish,
                      priority=priority)
        if deadline_s is not None:
            req.deadline_ts = req.arrival_ts + float(deadline_s)
        return self.scheduler.submit(req)

    # -- the loop --------------------------------------------------------------

    @property
    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def idle(self) -> bool:
        return (self.active == 0 and self.scheduler.pending == 0
                and self._prefilling is None)

    @property
    def has_work(self) -> bool:
        """Would a :meth:`step` make progress? (fleet worker pacing)."""
        return bool(self.active or self.scheduler.pending
                    or self._prefilling is not None)

    @property
    def backpressured(self) -> bool:
        """After a step: is the engine waiting on blocks it does not hold
        (a queued request, no lane running, nothing prefilling — its head
        does not fit a pool that others hold)? A fleet worker paces such
        an engine like an idle one instead of spinning on it."""
        return (self.active == 0 and self._prefilling is None
                and self.scheduler.pending > 0)

    @property
    def wants_dispatch(self) -> bool:
        """Should the fleet hand this engine another request? Keeping the
        per-engine queue empty is the load balancing."""
        return self.scheduler.pending == 0 and self.active < self.max_batch

    def held_state(self, timeout: float = 1.0):
        """Death-path collection (disaggregated fleet): detach and return
        ``(block_lists, requests)`` for every sequence this engine holds —
        decode lanes and any in-flight prefill — so a dead replica's share
        of a shared pool can be released once its thread is gone. None if
        the engine lock cannot be taken within ``timeout`` (a wedge inside
        a step): the caller parks and retries."""
        if not self._lock.acquire(timeout=timeout):
            return None
        try:
            blocks: List[List[int]] = []
            reqs: List[Request] = []
            if self._prefilling is not None:
                blocks.append(self._prefilling.blocks)
                reqs.append(self._prefilling.req)
                self._prefilling = None
            for i, s in enumerate(self._slots):
                if s is not None:
                    blocks.append(s.blocks)
                    reqs.append(s.req)
                    self._slots[i] = None
            self._collect_held(blocks, reqs)
            return blocks, reqs
        finally:
            self._lock.release()

    def _collect_held(self, blocks, reqs) -> None:
        """Subclass hook: detach role-specific block holders (runs under
        the engine lock inside :meth:`held_state`)."""

    def preempt_request(self, req: Request, timeout: float = 1.0) -> bool:
        """Evict one running decode lane: its blocks return to the pool,
        the slot frees, and the request reverts to QUEUED with its tokens
        intact (the fleet requeues it from prompt + emitted). Only a
        RUNNING lane is preemptible. False when the request holds no lane
        here or the lock cannot be taken within ``timeout``."""
        if not self._lock.acquire(timeout=timeout):
            return False
        try:
            for i, s in enumerate(self._slots):
                if s is not None and s.req is req:
                    self._slots[i] = None
                    self.pool.release(s.blocks)
                    req.state = QUEUED
                    self.stats["preempted"] += 1
                    return True
            return False
        finally:
            self._lock.release()

    def cancel_request(self, req: Request, timeout: float = 1.0) -> bool:
        """Withdraw a request (the process fleet's ``cancel`` command):
        drop it from the queue if still queued, else evict its lane. Never
        concludes it — the hub owns its ledger."""
        if self.scheduler.withdraw(req):
            return True
        return self.preempt_request(req, timeout=timeout)

    def step(self) -> int:
        """One loop iteration: admit (whole prefill, or start a chunked
        one), advance an in-flight chunked prefill by at most one chunk,
        then one decode step over the active lanes. Returns requests
        completed this iteration."""
        with self._lock:
            done = self._admit()
            done += self._advance_prefill()
            if self.active:
                done += self._decode_step()
            self.steps += 1
            self.stats["timeout"] = self.scheduler.timed_out
            self._stamp_heartbeat()
            return done

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Drive the loop until queue and lanes drain."""
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(f"serving loop not idle after {max_steps} steps")

    def run_forever(self, stop=None, idle_wait: float = 0.01) -> None:
        """The long-lived server entry: iterate until ``stop`` (a
        ``threading.Event``) is set, idle-waiting (and still stamping the
        SERVE heartbeat) between requests; :meth:`close` stamps EXIT at
        the end, so a finished loop reads as a conclusion, not silence."""
        stop = stop if stop is not None else threading.Event()
        try:
            while not stop.is_set():
                if self.idle:
                    with self._lock:
                        self._stamp_heartbeat()
                    stop.wait(idle_wait)
                    continue
                self.step()
        finally:
            self.close()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 32, temperature: float = 0.0,
                       eos_token_id=None) -> List[List[int]]:
        """Submit all, drain, return outputs in order."""
        reqs = [self.submit(p, max_new_tokens, temperature,
                            eos_token_id=eos_token_id) for p in prompts]
        self.run_until_idle()
        return [r.output_tokens for r in reqs]

    # -- supervision -----------------------------------------------------------

    def arm_watchdog(self, serve_timeout: float, **kw):
        """A loop that stops iterating for ``serve_timeout`` seconds is a
        wedge: stack dumps, a STALLED heartbeat record, exit rc 117
        (runtime/watchdog.py)."""
        from ..runtime.watchdog import StallWatchdog
        self._watchdog = StallWatchdog(
            stall_timeout=0.0, phase_timeouts={PHASE_SERVE: serve_timeout},
            phase=PHASE_SERVE, heartbeat=self._heartbeat, **kw).start()
        return self._watchdog

    def close(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._heartbeat is not None:
            try:
                self._heartbeat.stamp_terminal(PHASE_EXIT)
            except Exception:
                pass

    def _stamp_heartbeat(self) -> None:
        if self._watchdog is not None:
            self._watchdog.beat(self.steps)
        if self._heartbeat is not None:
            try:
                gauges = {"queue": self.scheduler.pending,
                          "active": self.active,
                          "lanes": self.max_batch}
                if self.role is not None:
                    gauges["role"] = self.role
                self._heartbeat.write(PHASE_SERVE, self.steps, extra=gauges)
            except Exception:
                pass                      # diagnostics must not kill serving

    # -- admission -------------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _admission_capacity(self) -> bool:
        """Can a new prefill begin? Base engine: a free decode lane (the
        finished prefill needs one); the disaggregated roles override."""
        return self._free_slot() is not None

    def _chunked_mode(self) -> bool:
        return self._chunk > 0

    def _admit(self) -> int:
        """Fill free lanes from the queue head; returns requests that
        finished during admission (max_new_tokens == 1). With chunked
        prefill, admission only starts one prefill per iteration. A
        transient allocation failure (a full pool, chaos ``serve.oom``)
        puts the request back at the head."""
        self.scheduler.shed_expired()
        done = 0
        if self._chunked_mode():
            if self._prefilling is None and self._admission_capacity():
                req = self.scheduler.next_admission()
                if req is not None:
                    try:
                        self._prefilling = self._start_prefill(req)
                    except (BlockPoolExhausted, chaos.ChaosError) as e:
                        logger.warning("serving: admission of request %d "
                                       "deferred (%s)", req.rid, e)
                        self.scheduler.requeue_front(req)
            return done
        while self._free_slot() is not None:
            req = self.scheduler.next_admission()
            if req is None:
                return done
            try:
                done += self._prefill_request(req)
            except (BlockPoolExhausted, chaos.ChaosError) as e:
                logger.warning("serving: admission of request %d deferred "
                               "(%s)", req.rid, e)
                self.scheduler.requeue_front(req)
                return done
        return done

    def _alloc_blocks(self, req: Request):
        """Fork the prompt's cached prefix and allocate the rest of its
        lifetime budget: (n_prefix_tokens, blocks, table)."""
        P = len(req.prompt)
        req.state = PREFILL
        n_pref, forked = (self.prefix_cache.match(req.prompt)
                          if self.prefix_cache is not None else (0, []))
        try:
            total_blocks = self.pool.blocks_for_tokens(
                P + max(req.max_new_tokens - 1, 0))
            priv = self.pool.alloc(total_blocks - len(forked))
        except BaseException:
            if forked:
                self.pool.release(forked)
            req.state = QUEUED
            raise
        blocks = list(forked) + priv
        table = np.full((self.nbk,), NULL_BLOCK, np.int32)
        table[:len(blocks)] = blocks
        req.prefix_hit_tokens = n_pref
        req.prefill_progress = n_pref
        self.stats["prefix_hit_tokens"] += n_pref
        return n_pref, blocks, table

    def _start_prefill(self, req: Request) -> _Prefilling:
        n_pref, blocks, table = self._alloc_blocks(req)
        return _Prefilling(req, blocks, table, done=n_pref,
                           total=len(req.prompt))

    def _run_prefill(self, req: Request, table: np.ndarray, start: int,
                     toks: Sequence[int]) -> int:
        """Prefill ``toks`` at positions [start, start + len) padded to a
        block multiple; returns the token sampled at the last real one."""
        n = len(toks)
        Tb = -(-n // self.block_size) * self.block_size
        ids = np.zeros((1, Tb), np.int64)
        ids[0, :n] = toks
        logits = self._shared.run(
            self._forward, self.params, ids, table[None],
            np.asarray([start], np.int64), np.asarray([start + n], np.int32))
        filt = self._filter_args(req)
        return int(self._pick(logits[:, n - 1],
                              np.asarray([req.temperature], np.float32),
                              *filt)[0])

    def _advance_prefill(self) -> int:
        """Run at most one chunk of the in-flight chunked prefill (the
        ``serve.chunk`` failpoint fires per chunk); on the final chunk the
        next token is sampled and the sequence installed — in a decode
        lane here, into the block handoff for a prefill role."""
        pf = self._prefilling
        if pf is None:
            return 0
        req = pf.req
        n = (pf.total - pf.done if self._chunk <= 0
             else min(self._chunk, pf.total - pf.done))
        try:
            chaos.failpoint("serve.chunk")
            tok = self._run_prefill(req, pf.table, pf.done,
                                    req.prompt[pf.done:pf.done + n])
        except BaseException as e:
            # a failed chunk must not leak the lifetime allocation; a
            # chaos or interrupt escape leaves the request QUEUED for a
            # requeue path, a plain Exception fails the request
            self._prefilling = None
            self.pool.release(pf.blocks)
            if isinstance(e, Exception) \
                    and not isinstance(e, chaos.ChaosError):
                self.stats["failed"] += 1
                req._finish(FAILED, error=repr(e))
            else:
                req.state = QUEUED
            raise
        pf.done += n
        req.prefill_progress = pf.done
        self.stats["prefill_tokens"] += n
        if pf.done < pf.total:
            return 0              # a mid-prompt chunk's sample is discarded
        self._prefilling = None
        return self._first_token(_Seq(req, pf.blocks, pf.table, pf.total,
                                      tok))

    def _first_token(self, seq: _Seq) -> int:
        """Record a finished prefill's sampled token, cache its prompt's
        full blocks (not for a role's warm-up prompt), then finish it or
        install it."""
        req = seq.req
        req.first_token_ts = time.monotonic()
        req.output_tokens.append(seq.last_tok)
        req.prefill_progress = len(req.prompt)
        self.stats["tokens_generated"] += 1
        if self.prefix_cache is not None and not self._warming:
            self.prefix_cache.insert(
                req.prompt, seq.blocks[:len(req.prompt) // self.block_size])
        if req.max_new_tokens <= 1 or (req.eos_token_id is not None
                                       and seq.last_tok == req.eos_token_id):
            self._finish(seq)
            return 1
        self._install(seq)
        return 0

    def _install(self, seq: _Seq) -> None:
        """Place a fully prefilled sequence where decode will find it — a
        free lane here; the prefill role hands it off instead."""
        seq.req.state = RUNNING
        self._slots[self._free_slot()] = seq

    def _filter_args(self, *reqs):
        """(top_k [n] i32, top_p [n] f32); 0 / 1.0 = off."""
        tks = np.asarray([r.top_k or 0 for r in reqs], np.int32)
        tps = np.asarray([r.top_p if r.top_p is not None else 1.0
                          for r in reqs], np.float32)
        return tks, tps

    def _prefill_request(self, req: Request) -> int:
        n_pref, blocks, table = self._alloc_blocks(req)
        P = len(req.prompt)
        suffix = req.prompt[n_pref:]
        try:
            tok = self._run_prefill(req, table, n_pref, suffix)
        except BaseException as e:
            # a failed forward must not leak the refcounted blocks
            self.pool.release(blocks)
            if isinstance(e, Exception):
                self.stats["failed"] += 1
                req._finish(FAILED, error=repr(e))
            else:
                req.state = QUEUED
            raise
        self.stats["prefill_tokens"] += len(suffix)
        return self._first_token(_Seq(req, blocks, table, P, tok))

    # -- decode ----------------------------------------------------------------

    def _decode_step(self) -> int:
        B = self.max_batch
        toks = np.zeros((B, 1), np.int64)
        ctx = np.zeros((B,), np.int64)
        temps = np.zeros((B,), np.float32)
        tks = np.zeros((B,), np.int32)
        tps = np.ones((B,), np.float32)
        tables = np.full((B, self.nbk), NULL_BLOCK, np.int32)
        live = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        for i, s in live:
            toks[i, 0] = s.last_tok
            ctx[i] = s.ctx
            temps[i] = s.req.temperature
            tks[i] = s.req.top_k or 0
            tps[i] = s.req.top_p if s.req.top_p is not None else 1.0
            tables[i] = s.table
        # toks[b] sits at logical position ctx[b]; after the write the valid
        # length is ctx + 1
        logits = self._shared.run(self._forward, self.params, toks, tables,
                                  ctx, (ctx + 1).astype(np.int32))
        nxt = self._pick(logits[:, -1], temps, tks, tps)
        done = 0
        for i, s in live:
            s.ctx += 1
            tok = int(nxt[i])
            s.req.output_tokens.append(tok)
            s.last_tok = tok
            self.stats["tokens_generated"] += 1
            eos = (s.req.eos_token_id is not None
                   and tok == s.req.eos_token_id)
            if eos or len(s.req.output_tokens) >= s.req.max_new_tokens:
                self._slots[i] = None
                self._finish(s)
                done += 1
        return done

    def _finish(self, seq: _Seq) -> None:
        self.pool.release(seq.blocks)
        self.stats["completed"] += 1
        seq.req._finish(FINISHED)


def _check_row_blocks(params, tp) -> None:
    """Blockwise int8 packs each rank's shard: a row-parallel shard (the
    attention and MLP projections' K / t rows) packs as the whole leaf's
    packing cut there only in whole scale blocks."""
    from ..quant_format import QUANT_BLOCK
    if tp is None or tp.size == 1:
        return
    for name in ("attn_proj", "mlp_proj"):
        sub = params["blocks"].get(name)
        if isinstance(sub, dict) and "kernel" in sub and \
                sub["kernel"].shape[-2] % QUANT_BLOCK:
            raise NotImplementedError(
                f"serving.weight_dtype int8 under tp_size {tp.size}: "
                f"{name}'s {sub['kernel'].shape[-2]} rows a rank are not "
                f"whole scale blocks of {QUANT_BLOCK} (is not ported to "
                "deepspeed_tpu_torch yet; see ROADMAP.md)")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
