"""ServingFleet — supervised multi-replica serving with request requeue
(counterpart of ``deepspeed_tpu/serving/fleet.py``).

One serving engine has no failure story: a wedged or killed loop takes
every in-flight request with it. This module shrinks the serving failure
domain to one replica: N continuous-batching replica engines — weights
SHARED by reference on one device, a KV pool and a sampling generator
per replica — pull work from ONE bounded admission queue, and a
:class:`FleetSupervisor` watches each replica's SERVE heartbeat records
(runtime/heartbeat.py) the way a launcher watches training ranks. Losing
a replica costs one replica, not the fleet.

Failure semantics (the contract the chaos tests pin):

* **Detection is the rc-117 silence contract, fleet-side.** Each replica
  worker stamps a SERVE record (with queue/active gauges) every loop
  iteration onto the fleet's heartbeat channel. A dead worker thread, or
  ``heartbeat_timeout`` seconds of record silence from a live one (the
  chaos ``serve.replica_hang`` shape — a loop wedged in a failpoint or a
  stuck device), declares the replica DOWN. The supervisor stamps a
  ``STALLED`` terminal record as evidence (``dstpu health`` on
  ``fleet.heartbeat_dir`` shows it) and records the replica's last
  heartbeat in ``fleet.deaths`` for attribution.
* **Teardown is replica-local.** Only the dead replica is torn down and
  (unless blacklisted) restarted with a fresh engine; surviving replicas
  keep their engines, pools and sampling state — fleet throughput
  recovers without touching them.
* **Requeue is exactly-once.** A FleetRequest carries its
  tokens-emitted-so-far; a requeued request re-enters the queue with
  ``prompt + emitted`` as its prompt and only the REMAINING budget as
  ``max_new_tokens``, so the resumed replica replays the generated
  prefix through its prefix cache (prefill, full-block reuse when
  cached) and ``on_token`` callbacks never re-fire a token. Tokens a
  dying replica generated but never emitted are deliberately dropped —
  greedy decode regenerates them identically; emission, not generation,
  is the exactly-once boundary. The emission/discard race is closed
  under the per-replica lock: the supervisor marks a replica DOWN under
  the same lock the worker syncs tokens under, so a declared-dead
  replica can never emit concurrently with its requests being re-served.
* **Retry budget.** Every requeue costs one retry; past
  ``retry_budget`` the request concludes FAILED (callback fires, status
  observable) instead of bouncing between dying replicas forever. The
  ``serve.requeue`` failpoint fires inside the requeue itself: a crash
  THERE parks the request on an orphan list the supervisor retries next
  poll — a requeue failure defers a request, never loses it.
* **Blacklist / parole.** ``blacklist_after`` strikes quarantine a
  repeatedly-dying replica (no restart); when live replicas would drop
  below ``min_replicas`` the least-struck blacklisted replica is paroled
  back — the elastic agent's host machinery, applied to serving.
* **Graceful degradation.** The fleet keeps serving at reduced capacity
  with replicas down; per-request deadlines (``deadline_s`` /
  ``fleet.default_deadline_s``) shed expired queued requests with a
  TIMEOUT status — bounded-latency load shedding, not silent starvation.

Chaos failpoints (testing/chaos.py): ``serve.replica_kill`` and
``serve.replica_hang`` fire at the top of each worker iteration, KEYED
by the replica index (``match=1`` takes out replica 1 only). In-process
replicas use ``raise`` / ``hang`` modes — ``kill`` mode would
``os._exit`` the whole process; it belongs to a future process-per-
replica deployment, where the same heartbeat channel does the same job.

Threading model: one worker thread per replica (dispatch and token
sync/stamp under the replica lock; the engine step runs OUTSIDE it so a
wedge inside a kernel can never hold the lock the supervisor needs to
fence the replica), one supervisor thread (``poll_interval`` cadence;
``poll()`` is public for deterministic tests). ``submit()`` is
thread-safe from any thread. A hung worker is abandoned (daemon
threads; its per-replica pool stays allocated until process exit — the
price of in-process replicas). Each worker counts its replica's kernel
launches (``kernel_launches``, ``ops.build.launch_scope``).
"""

from __future__ import annotations

import json
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..models.generation import ensure_scan_layout
from ..ops import build
from ..runtime import heartbeat as hb
from ..runtime.straggler import (STEP_MS_GAUGE, STRAGGLER_FLAG, StepClock,
                                 StragglerDetector)
from ..testing import chaos
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .autoscale import (AUTOSCALER_RANK, SCALE_DOWN, SCALE_UP,
                        AutoscalePolicy, Observation, ScaleEvent)
from .engine import ServingEngine, _to_device, resolve_kv_dtype
from .kv_cache import SharedPagedState
from .scheduler import (BATCH, FAILED, FINISHED, LATENCY, PRIORITY_TIERS,
                        QUEUED, RUNNING, SHED, STANDARD, TIER_RANK, TIMEOUT,
                        TieredQueue, admit_or_shed, check_admissible)

PyTree = Any

#: the kernels a serving replica launches (paged attention every forward,
#: quant_matmul under int8 weights): built before the first replica starts
SERVING_KERNELS = ("paged_attention", "quant_matmul")

#: replica lifecycle states. RETIRED concludes a scale-down
#: drain: the replica finished its lanes and left cleanly (EXIT stamp) —
#: unlike DOWN it is not a failure and earns no strike.
LIVE, DOWN, BLACKLISTED, RETIRED = "LIVE", "DOWN", "BLACKLISTED", "RETIRED"


@dataclass
class FleetRequest:
    """One generation request riding the fleet — survives replica death.

    ``output_tokens`` holds only EMITTED tokens (synced from a live
    replica under its lock, ``on_token`` fired per token); it is the
    exactly-once ledger a requeue resumes from. ``retries`` counts
    requeues; ``state`` ends FINISHED, FAILED (budget exhausted or a
    deterministic per-request failure) or TIMEOUT (deadline shed)."""
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    deadline_ts: Optional[float] = None
    on_token: Optional[Callable[["FleetRequest", int], None]] = None
    on_finish: Optional[Callable[["FleetRequest"], None]] = None
    rid: int = 0
    #: priority tier: latency | standard | batch — dispatch
    #: order, the overload ladder's shed order, and preemption standing
    priority: str = STANDARD
    state: str = QUEUED
    output_tokens: List[int] = field(default_factory=list)
    retries: int = 0
    #: times a deadline-pressured latency request evicted this one's
    #: lane (requeued token-exact; does NOT charge the retry budget)
    preemptions: int = 0
    replica: Optional[int] = None      # current / last assignment
    #: disagg: prompt tokens the last (possibly dead) prefill leg got
    #: into the pool — requeue carries it for the death ledger
    prefill_progress: int = 0
    error: Optional[str] = None
    arrival_ts: float = field(default_factory=time.monotonic)
    finish_ts: Optional[float] = None
    _synced: int = 0                   # engine tokens consumed this leg
    _done_evt: threading.Event = field(default_factory=threading.Event)

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, FAILED, TIMEOUT, SHED)

    @property
    def remaining(self) -> int:
        return max(self.max_new_tokens - len(self.output_tokens), 0)

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_ts is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline_ts

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request concludes; True iff it did in time."""
        return self._done_evt.wait(timeout)

    def _finish(self, state: str, error: Optional[str] = None) -> bool:
        """First conclusion wins — exactly-once for on_finish too."""
        if self.done:
            return False
        self.state = state
        self.error = error
        self.finish_ts = time.monotonic()
        self._done_evt.set()
        if self.on_finish is not None:
            try:
                self.on_finish(self)
            except Exception:
                logger.exception("fleet: on_finish callback for request "
                                 "%d raised", self.rid)
        return True


class _Replica:
    """One replica slot: engine + worker thread + heartbeat writer.

    A restart builds a NEW _Replica for the same index (strikes carried
    over) — an abandoned hung worker holds the OLD object, whose DOWN
    state makes its loop exit if it ever wakes, and whose engine/pool it
    can scribble on harmlessly."""

    def __init__(self, idx: int, generation: int = 0, strikes: int = 0):
        self.idx = idx
        self.generation = generation
        self.strikes = strikes
        self.state = LIVE
        self.warming = False           # silence-exempt during warmup()
        #: set when the replica's warm-up raised: its worker exits at once
        #: and the supervisor records the reason (no quiet plain path)
        self.warm_failed = False
        #: scale-down in flight: dispatch skips a draining
        #: replica; its lanes finish, then the supervisor RETIREs it.
        #: State stays LIVE so death supervision still covers the drain
        #: window — a draining replica that dies requeues exactly-once.
        self.draining = False
        self.step_clock = StepClock()  # rolling per-iteration wall gauge
        self.engine: Optional[ServingEngine] = None
        self.thread: Optional[threading.Thread] = None
        self.writer: Optional[hb.HeartbeatWriter] = None
        self.lock = threading.Lock()   # worker step/sync vs supervisor down
        self.inflight: Dict[int, Any] = {}   # rid -> (FleetRequest, eng req)
        #: disagg decode role: a handoff item popped but not yet
        #: installed (the serve.handoff_drop death window) — its blocks
        #: ride the quarantine if the replica dies here
        self.holding: Optional[Any] = None
        self.error: Optional[str] = None
        self.started_ts = time.monotonic()


class ServingFleet:
    """N supervised replica serving loops behind one admission queue
    (module docstring has the failure semantics).

    ``serving`` is a ``ServingConfig`` (or dict); its ``fleet`` section
    (``FleetConfig``) sizes and tunes the fleet. ``params`` are moved to
    ``device`` (default CUDA) once — and packed once under
    ``serving.weight_dtype: "int8"`` — and shared by reference across
    replicas; per-replica state is the KV pool and the sampling
    generator (each seeded with ``serving.seed``).
    """

    def __init__(self, cfg, params: PyTree, serving=None,
                 heartbeat_dir: Optional[str] = None, device=None):
        from ..config.config import ServingConfig
        if serving is None:
            serving = ServingConfig()
        elif isinstance(serving, dict):
            serving = ServingConfig(**serving)
        self.cfg = cfg
        self.scfg = serving
        self.fcfg = serving.fleet
        self.device = resolve_device(device)
        if str(self.fcfg.placement) == "process":
            raise ValueError(
                "serving.fleet.placement='process' builds a ProcessFleet "
                "(serving/procfleet.py) — construct one directly or go "
                "through serving.make_fleet(...)")
        params = _to_device(ensure_scan_layout(params, cfg.num_layers),
                            self.device)
        if serving.weight_dtype == "int8":
            from ..ops.quant_matmul import pack_decode_weights
            params = pack_decode_weights(params)
        self.params = params
        # disaggregated roles (serving/disagg.py): prefill
        # replicas fill paged blocks and hand them — zero-copy, over ONE
        # shared pool — to decode replicas through the bounded handoff
        self.n_prefill = int(self.fcfg.prefill_replicas)
        self.n_decode = int(self.fcfg.decode_replicas)
        if (self.n_prefill > 0) != (self.n_decode > 0):
            raise ValueError(
                "serving.fleet: prefill_replicas and decode_replicas "
                "must both be > 0 for disaggregated serving (got "
                f"{self.n_prefill}/{self.n_decode})")
        self.disagg = self.n_prefill > 0
        if self.disagg:
            from .disagg import BlockHandoff
            self.n_replicas = self.n_prefill + self.n_decode
            self._shared = SharedPagedState(
                cfg, serving, dtype=resolve_kv_dtype(serving),
                device=self.device)
            self._handoff = BlockHandoff(
                self._shared.pool, capacity=int(serving.handoff_queue),
                on_push=self._register_handoff)
            #: engine-request rid -> FleetRequest, recorded at dispatch so
            #: the push-time registration hook (which runs on the prefill
            #: worker thread, without its replica lock) needs no replica
            #: state — guarded by _qlock
            self._er2freq: Dict[int, FleetRequest] = {}
            #: engine-request rid -> (freq, er) for items in (or through)
            #: the handoff queue: registered atomically at push, consumed
            #: at decode dispatch / deadline shed — the exactly-once
            #: ledger across the role boundary (guarded by _qlock)
            self._handoff_inflight: Dict[int, tuple] = {}
            #: (replica, block-lists) of dead disagg replicas, released
            #: into the SHARED pool only once the replica thread is
            #: provably gone (its abandoned final step may still write
            #: through its old tables; releasing earlier could hand those
            #: blocks to a new owner mid-scribble)
            self._quarantine: List[tuple] = []
        else:
            self.n_replicas = max(1, int(self.fcfg.replicas))
            self._shared = None
            self._handoff = None
        # traffic-shaped autoscaling (serving/autoscale.py):
        # plain replicas only — disagg role counts are a placement
        # decision the queue-depth trigger cannot make
        self.autoscale: Optional[AutoscalePolicy] = None
        if self.fcfg.autoscale.enabled:
            if self.disagg:
                raise ValueError(
                    "serving.fleet.autoscale does not apply to "
                    "disaggregated fleets (role counts are a placement "
                    "decision) — unset prefill/decode_replicas")
            self.autoscale = AutoscalePolicy(self.fcfg.autoscale)
            self.n_replicas = min(max(self.n_replicas,
                                      self.autoscale.min_replicas),
                                  self.autoscale.max_replicas)
        self.heartbeat_dir = (heartbeat_dir or self.fcfg.heartbeat_dir
                              or tempfile.mkdtemp(prefix="dstpu-fleet-hb-"))
        self._queue = TieredQueue(                # guarded by _qlock
            aging_s=float(self.fcfg.priority_aging_s))
        self._qlock = threading.Lock()
        self._stats_lock = threading.Lock()      # counters bumped from N
        #                                          workers + supervisor
        self._orphans: List[FleetRequest] = []   # failed requeues, retried
        #: fenced-but-wedged replicas whose teardown awaits their lock
        self._pending_down: List[tuple] = []
        self._outstanding: Dict[int, FleetRequest] = {}
        self._rid = 0
        self._stop = threading.Event()
        self._started = False
        self._lock = threading.Lock()            # replica-list mutations
        self._replicas: List[_Replica] = [_Replica(i)
                                          for i in range(self.n_replicas)]
        self.supervisor = FleetSupervisor(self)
        #: death ledger: {replica, generation, reason, evidence (last
        #: heartbeat record), strikes, detected_ts, action,
        #: restarted_ts} — the attribution trail tests and the bench read
        self.deaths: List[dict] = []
        #: capacity ledger, the death-ledger idiom applied to
        #: scale events: every autoscaler verdict (up / up_failed / down)
        #: with its trigger, timestamps and queue/live evidence — what
        #: the bench records and the autoscaler heartbeat rank mirrors
        self.scale_events: List[ScaleEvent] = []
        self._as_writer: Optional[hb.HeartbeatWriter] = None
        #: replica index -> {kernel wrapper name: launches} made by that
        #: replica's worker threads, over every generation of the index
        self.kernel_launches: Dict[int, Dict[str, int]] = {}
        self.stats: Dict[str, int] = {
            "submitted": 0, "completed": 0, "failed": 0, "timeout": 0,
            "requeues": 0, "deaths": 0, "restarts": 0, "paroles": 0,
            "blacklisted": 0, "tokens_emitted": 0, "shed": 0,
            "preempted": 0, "scale_ups": 0, "scale_downs": 0}
        # run-scoped channel: stale records from a previous fleet in a
        # reused dir must not trip silence at t=0
        hb.clear_channel(self.heartbeat_dir)
        log_dist(
            f"ServingFleet: {self.n_replicas} replicas, "
            f"retry_budget={self.fcfg.retry_budget}, "
            f"heartbeat_timeout={self.fcfg.heartbeat_timeout}s, "
            f"heartbeat_dir={self.heartbeat_dir}", ranks=[0])

    # -------------------------------------------------------------- lifecycle

    def start(self) -> "ServingFleet":
        if self._started:
            return self
        self._started = True
        if self.device.type == "cuda":
            # every library built before a replica's first step: an nvcc
            # run inside a step would read as heartbeat silence
            build.build(SERVING_KERNELS)
        for rep in self._replicas:
            self._launch(rep)
        if self.autoscale is not None:
            # the autoscaler's own heartbeat rank: scale events are
            # operator evidence in the SAME channel `dstpu health`
            # reads; refreshed every supervisor poll so the record
            # never reads as silent while the fleet is supervised
            self._as_writer = hb.HeartbeatWriter(
                self.heartbeat_dir, rank=AUTOSCALER_RANK,
                host="autoscaler",
                min_interval=float(self.fcfg.heartbeat_interval),
                refresh_interval=0.0)
            self._stamp_autoscaler(force=True)
        self.supervisor.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        """Stop the supervisor and workers; stamp EXIT terminal records
        for every live replica so a closed fleet reads as concluded, not
        silent. ``timeout`` bounds the WHOLE close (an abandoned hung
        worker must not stall shutdown). Outstanding requests are left
        un-concluded — drain first if they matter."""
        self.supervisor.stop()
        self._stop.set()
        deadline = time.monotonic() + timeout
        for rep in self._replicas:
            if rep.state != LIVE:
                continue                # hung/blacklisted: abandoned daemons
            t = rep.thread
            if t is not None and t.is_alive():
                t.join(max(0.0, deadline - time.monotonic()))
            if rep.writer is not None:
                rep.writer.stamp_terminal(hb.PHASE_EXIT, lock_timeout=1.0)
        if self._as_writer is not None:
            self._as_writer.stamp_terminal(hb.PHASE_EXIT, lock_timeout=1.0)
        if self.disagg:
            # items still crossing the role boundary return their blocks
            # (their requests are left un-concluded, same as the queue)
            self._handoff.drain_release()
            self._drain_quarantine()

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- submission

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token=None, on_finish=None,
               priority: str = STANDARD) -> FleetRequest:
        """Enqueue onto the SHARED fleet queue (thread-safe, bounded —
        raises on a full queue or an inadmissible request, the caller
        must know synchronously). ``deadline_s`` defaults to
        ``fleet.default_deadline_s`` (0 = wait forever). ``priority``
        picks the latency/standard/batch tier; at a hard-full queue a
        higher-tier arrival sheds the youngest lowest-tier queued request
        (victim concludes SHED, callback fires) and a rejection is always
        the machine-readable :class:`~.scheduler.AdmissionRejected` —
        never a hang, never a silent drop."""
        chaos.failpoint("serve.enqueue")
        if priority not in TIER_RANK:
            raise ValueError(f"unknown priority tier {priority!r}; pick "
                             f"one of {PRIORITY_TIERS}")
        prompt = [int(t) for t in prompt]
        # eager admissibility — the SAME predicate every replica's
        # scheduler applies (shared pool geometry): a request no replica
        # could ever admit must be rejected now, not discovered
        # asynchronously at dispatch
        bs = int(self.scfg.block_size)
        check_admissible(
            len(prompt), int(max_new_tokens), bs,
            int(self.scfg.pool_blocks),
            min(int(self.scfg.max_blocks_per_seq) * bs,
                self.cfg.max_seq_len))
        if deadline_s is None and self.fcfg.default_deadline_s > 0:
            deadline_s = self.fcfg.default_deadline_s
        with self._qlock:
            self._rid += 1
            req = FleetRequest(
                prompt=prompt, max_new_tokens=int(max_new_tokens),
                temperature=float(temperature), eos_token_id=eos_token_id,
                on_token=on_token, on_finish=on_finish, rid=self._rid,
                priority=priority)
            if deadline_s is not None:
                req.deadline_ts = req.arrival_ts + float(deadline_s)
            # the overload ladder (scheduler.admit_or_shed):
            # raises AdmissionRejected before touching fleet state
            victim = admit_or_shed(self._queue, req,
                                   int(self.fcfg.max_queue),
                                   float(self.fcfg.batch_highwater))
            self._outstanding[req.rid] = req
        self._bump("submitted")
        if victim is not None:
            self._conclude(victim, SHED, json.dumps(
                {"error": "shed", "reason": "displaced_by_tier",
                 "tier": victim.priority}, sort_keys=True))
        return req

    @property
    def pending(self) -> int:
        with self._qlock:
            return len(self._queue) + len(self._orphans)

    @property
    def idle(self) -> bool:
        with self._qlock:
            return not self._outstanding

    def live_replicas(self) -> List[int]:
        with self._lock:
            return [r.idx for r in self._replicas if r.state == LIVE]

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until every submitted request concludes (FINISHED /
        FAILED / TIMEOUT); True iff all did within ``timeout``."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._qlock:
                reqs = list(self._outstanding.values())
            if not reqs:
                return True
            reqs[0].wait(min(0.05, max(deadline - time.monotonic(), 0.0)))
            with self._qlock:
                for rid in [r.rid for r in reqs if r.done]:
                    self._outstanding.pop(rid, None)
        with self._qlock:
            return not self._outstanding

    def warmup(self, prompt: Optional[Sequence[int]] = None,
               max_new_tokens: int = 2) -> None:
        """Serve one short request on every live replica OFF the serving
        path (kernel libraries loaded, the allocator and the library
        handles warmed). The silence detector cannot tell a long
        legitimate step from a wedge — that is inherent to the rc-117
        contract — so warm the fleet before arming a tight
        ``heartbeat_timeout``, and keep the timeout above the worst-case
        legitimate step latency. While a replica warms its ``warming``
        flag exempts it from the SILENCE verdict (its worker is parked
        on the replica lock and cannot stamp) — thread death is still
        detected. Restarted replicas are warmed before they rejoin (see
        ``_restart``) for the same reason."""
        prompt = list(prompt) if prompt is not None else [1, 2, 3]
        with self._lock:
            reps = [r for r in self._replicas if r.state == LIVE]
        for rep in reps:
            rep.warming = True
            try:
                with rep.lock:
                    if rep.state != LIVE or rep.engine is None:
                        continue
                    if self.disagg:
                        # role engines warm off-path without touching
                        # the real handoff (a warm item crossing roles
                        # would never conclude — it has no FleetRequest)
                        rep.engine.warm()
                    else:
                        rep.engine.submit(prompt, max_new_tokens)
                        rep.engine.run_until_idle()
                    if rep.writer is not None:
                        # fresh ts before the silence clock resumes
                        rep.writer.write(hb.PHASE_SERVE, rep.engine.steps,
                                         force=True)
            finally:
                rep.warming = False

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 32, temperature: float = 0.0,
                       eos_token_id=None,
                       timeout: float = 120.0) -> List[List[int]]:
        """Convenience: submit all, drain, return outputs in order."""
        reqs = [self.submit(p, max_new_tokens, temperature,
                            eos_token_id=eos_token_id) for p in prompts]
        if not self.drain(timeout):
            raise RuntimeError(f"fleet did not drain within {timeout}s")
        return [r.output_tokens for r in reqs]

    # ---------------------------------------------------------- replica setup

    def _role(self, idx: int) -> Optional[str]:
        if not self.disagg:
            return None
        return "PREFILL" if idx < self.n_prefill else "DECODE"

    def _launch(self, rep: _Replica, warm: bool = False) -> None:
        if self.disagg:
            from .disagg import DecodeEngine, PrefillEngine
            if rep.idx < self.n_prefill:
                rep.engine = PrefillEngine(
                    self.cfg, self.params, serving=self.scfg,
                    shared=self._shared, handoff=self._handoff,
                    device=self.device)
            else:
                rep.engine = DecodeEngine(
                    self.cfg, self.params, serving=self.scfg,
                    shared=self._shared, handoff=self._handoff,
                    auto_pull=False, device=self.device)
        else:
            rep.engine = ServingEngine(self.cfg, self.params,
                                       serving=self.scfg,
                                       device=self.device)
        if warm:
            # a restarted replica must not rejoin until it can actually
            # serve. A warm-up that raises fails THIS replica: its worker
            # exits at once and the supervisor records the reason — it
            # never serves on regardless
            try:
                if self.disagg:
                    rep.engine.warm()
                else:
                    rep.engine.submit([1, 2, 3], 2)
                    rep.engine.run_until_idle()
            except Exception as e:
                logger.exception("fleet: replica %d warm-up failed",
                                 rep.idx)
                rep.warm_failed = True
                rep.error = f"warm-up failed: {e!r}"
        # refresh_interval=0: NO background re-stamper — a wedged replica
        # loop must read as silence (the whole point); the worker itself
        # is the liveness signal, min_interval paces the writes
        rep.writer = hb.HeartbeatWriter(
            self.heartbeat_dir, rank=rep.idx, host=f"replica-{rep.idx}",
            min_interval=float(self.fcfg.heartbeat_interval),
            refresh_interval=0.0)
        rep.started_ts = time.monotonic()
        # launch stamp: overwrite any previous generation's record (e.g.
        # the STALLED verdict of the engine this one replaces) so this
        # generation's silence is measured from ITS OWN record — a
        # terminal leftover would otherwise exempt a hung restart from
        # silence detection forever
        launch_gauges = {"queue": 0, "active": 0,
                         "lanes": int(self.scfg.max_batch)}
        if rep.engine.role is not None:
            launch_gauges["role"] = rep.engine.role
        rep.writer.write(hb.PHASE_SERVE, 0, force=True, extra=launch_gauges)
        rep.thread = threading.Thread(
            target=self._worker, args=(rep,),
            name=f"dstpu-fleet-replica-{rep.idx}", daemon=True)
        rep.thread.start()

    # ------------------------------------------------------------ worker loop

    def _worker(self, rep: _Replica) -> None:
        """One replica's serve loop: chaos gates, dispatch from the shared
        queue, one engine step, token sync, heartbeat stamp. ANY escape
        (chaos ``serve.replica_kill``, a real device failure) is replica
        death: record the error and fall silent — the supervisor detects,
        attributes and requeues. A loop wedged inside a step or failpoint
        (``serve.replica_hang``) is the silence case."""
        eng = rep.engine
        decode_role = self.disagg and rep.idx >= self.n_prefill
        if rep.warm_failed:
            return                      # the supervisor reads the reason
        tally = self.kernel_launches.setdefault(rep.idx, {})
        try:
            while not self._stop.is_set() and rep.state == LIVE:
                # the iteration clock starts BEFORE the chaos gates so an
                # armed serve.replica_slow (sleep + every=/p= jitter —
                # degraded, not dead) inflates this replica's step_ms
                # gauge exactly like a thermal-throttled host would
                t_iter = time.monotonic()
                chaos.failpoint("serve.replica_hang", key=str(rep.idx))
                chaos.failpoint("serve.replica_kill", key=str(rep.idx))
                chaos.failpoint("serve.replica_slow", key=str(rep.idx))
                with rep.lock:
                    if rep.state != LIVE:
                        return
                    if decode_role:
                        self._dispatch_decode(rep)
                    else:
                        self._dispatch(rep)
                    worked = eng.has_work
                # the step runs OUTSIDE rep.lock: a wedge inside a kernel
                # must not hold the lock the supervisor needs to fence
                # this replica — only the short dispatch/sync sections
                # contend
                if worked:
                    with build.launch_scope(tally):
                        eng.step()
                with rep.lock:
                    if rep.state != LIVE:
                        return          # fenced mid-step: the supervisor
                        #                 requeued our work; emitting now
                        #                 would double-fire tokens (a
                        #                 handoff pushed during the fenced
                        #                 step survives — its registration
                        #                 makes the teardown requeue skip
                        #                 it, and a decode replica serves
                        #                 the item exactly once)
                    if worked:
                        if self.disagg and not decode_role:
                            # drop handed-off requests from THIS replica's
                            # ledger BEFORE syncing: their tokens (the
                            # first token included) are emitted by the
                            # decode side only — one emitter per request
                            self._collect_handoffs(rep)
                        self._sync(rep)
                        # serving-iteration wall time (chaos gates +
                        # dispatch + step + sync): the straggler
                        # detector's cross-replica sample — idle spins
                        # are not steps and are not recorded
                        rep.step_clock.push_ms(
                            (time.monotonic() - t_iter) * 1000.0)
                    self._stamp(rep)
                if not worked or eng.backpressured:
                    # a spinning worker would starve the others of the
                    # interpreter lock their host-side steps need
                    time.sleep(0.005)
        except BaseException as e:     # noqa: BLE001 — death IS the contract
            rep.error = repr(e)
            logger.warning("fleet: replica %d loop died: %s", rep.idx, e)
            # no terminal stamp: a genuinely killed process could not
            # stamp either — the record goes silent / the thread dies,
            # and detection must work from that evidence alone

    def _dispatch(self, rep: _Replica) -> None:
        """Pull from the shared queue into this replica while it has free
        lanes and an empty engine queue (keeping the per-engine queue
        empty is the load-balancing: a request never waits on a busy
        replica while another has a free lane). Expired requests are shed
        here with TIMEOUT. Caller holds rep.lock. (Disagg: prefill-role
        replicas dispatch one request at a time — ``wants_dispatch`` —
        and decode-role replicas never dispatch from here at all.)
        A DRAINING replica (scale-down in flight) admits nothing — its
        lanes finish, then the supervisor retires it."""
        if rep.draining:
            return
        eng = rep.engine
        while eng.wants_dispatch:
            with self._qlock:
                req = self._queue.popnext()
            if req is None:
                return
            if req.expired():
                self._conclude(req, TIMEOUT,
                               "deadline exceeded while queued")
                continue
            if req.done:               # concluded while queued (close etc.)
                continue
            # the remaining TTL rides into the engine: a dispatched
            # request the replica cannot admit yet (block budget) is
            # still deadline-bounded by the ENGINE's shed — the fleet
            # queue can no longer see it
            dl = (max(req.deadline_ts - time.monotonic(), 0.0)
                  if req.deadline_ts is not None else None)
            try:
                er = eng.submit(req.prompt + req.output_tokens,
                                req.remaining,
                                temperature=req.temperature,
                                eos_token_id=req.eos_token_id,
                                deadline_s=dl, priority=req.priority)
            except BaseException:
                # an exploding enqueue (chaos serve.enqueue, engine-side
                # validation) kills THIS replica, but the popped request
                # must go back on the shared queue first — in neither
                # queue nor inflight it would be lost forever
                with self._qlock:
                    self._queue.appendleft(req)
                raise
            req.replica, req._synced = rep.idx, 0
            req.state = RUNNING
            rep.inflight[req.rid] = (req, er)
            if self.disagg:
                # push-time registration (on the prefill worker thread,
                # inside the engine step, WITHOUT rep.lock) resolves the
                # fleet request through this map instead of touching
                # replica state
                with self._qlock:
                    self._er2freq[er.rid] = req

    # ---------------------------------------------------- disagg role plumbing

    def _register_handoff(self, item) -> None:
        """BlockHandoff.on_push hook (runs under the handoff lock, on the
        pushing prefill worker's thread): record the item in the
        cross-role exactly-once ledger ATOMICALLY with the enqueue, so a
        decode replica can never pop an unregistered item, and a teardown
        requeue can never double-serve a pushed one."""
        er = item.req
        with self._qlock:
            freq = self._er2freq.pop(er.rid, None)
            if freq is not None:
                self._handoff_inflight[er.rid] = (freq, er)

    def _collect_handoffs(self, rep: _Replica) -> None:
        """Prefill worker post-step: requests pushed to the handoff this
        step leave THIS replica's inflight ledger UNCONDITIONALLY — the
        push itself moved ownership (registration is atomic with the
        enqueue), and a fast decode replica may have ALREADY popped the
        item and consumed the registration; keying the removal on the
        registration's presence would leave the request in BOTH
        replicas' ledgers with two workers racing the same ``_synced``
        cursor. Caller holds rep.lock."""
        for er in rep.engine.take_handed_off():
            for frid, (_freq, er2) in list(rep.inflight.items()):
                if er2 is er:
                    rep.inflight.pop(frid)
                    break

    def _dispatch_decode(self, rep: _Replica) -> None:
        """Decode worker: shed expired handoff items, then pop items into
        free lanes. The ``serve.handoff_drop`` failpoint fires between
        pop and install — a crash there is a decode-replica death with a
        popped item in hand: the request is already on rep.inflight (the
        death path requeues it through the token-exact prompt+emitted
        path) and the item's blocks ride ``rep.holding`` into the shared-
        pool quarantine. Caller holds rep.lock."""
        self._shed_handoff()
        eng = rep.engine
        while eng.lanes_free:
            item = self._handoff.pop()
            if item is None:
                return
            with self._qlock:
                pair = self._handoff_inflight.pop(item.req.rid, None)
                if pair is not None:
                    # takeover is ATOMIC with the pop: a prefill-replica
                    # teardown deciding whether to requeue this request
                    # reads (registration, owner) under the same lock, so
                    # it either sees the registration (skip) or sees this
                    # replica as owner (skip) — never a gap that would
                    # requeue a request a live decode replica is serving
                    pair[0].replica = rep.idx
            if pair is None or pair[0].done:
                # no live fleet request behind the item (concluded while
                # queued, or a close() edge): release and drop — blocks
                # must never leak the shared pool's accounting
                self._shared.pool.release(item.blocks)
                continue
            freq, er = pair
            rep.inflight[freq.rid] = (freq, er)
            rep.holding = item
            chaos.failpoint("serve.handoff_drop")
            rep.engine.install_item(item)
            rep.holding = None

    def _shed_handoff(self) -> None:
        """Deadline-aware handoff: conclude fleet requests whose items
        expired in the queue (runs at decode dispatch AND on the
        supervisor cadence — the latter covers a fleet with every decode
        replica down)."""
        for item in self._handoff.shed_expired():
            with self._qlock:
                pair = self._handoff_inflight.pop(item.req.rid, None)
            if pair is not None:
                self._conclude(pair[0], TIMEOUT,
                               "deadline exceeded in handoff queue")

    def _drain_quarantine(self) -> None:
        """Release dead disagg replicas' blocks into the SHARED pool once
        their worker threads are provably gone (supervisor cadence). A
        still-wedged engine (held_state timed out at teardown) is
        re-probed each pass; one wedged forever leaks its blocks — the
        same verdict the per-replica-pool design gives an abandoned
        worker, and the price of zero-copy sharing."""
        with self._qlock:
            pending, self._quarantine = self._quarantine, []
        keep = []
        for rep, blocks in pending:
            if blocks is None:
                hs = (rep.engine.held_state(timeout=0.2)
                      if rep.engine is not None else ([], []))
                if hs is None:
                    keep.append((rep, None))
                    continue
                blocks = list(hs[0])
                if rep.holding is not None:
                    blocks.append(rep.holding.blocks)
                    rep.holding = None
            if rep.thread is not None and rep.thread.is_alive():
                keep.append((rep, blocks))
                continue
            for bl in blocks:
                try:
                    self._shared.pool.release(bl)
                except ValueError:
                    logger.exception(
                        "fleet: quarantine release of replica %d blocks "
                        "found inconsistent refcounts", rep.idx)
        with self._qlock:
            self._quarantine.extend(keep)

    def _sync_one(self, req: FleetRequest, er) -> None:
        """Emit one request's newly generated tokens (the exactly-once
        cursor walk). Caller holds the owning replica's lock — worker
        sync, supervisor teardown and lane preemption all serialize
        here."""
        toks = er.output_tokens
        while req._synced < len(toks):
            tok = int(toks[req._synced])
            req._synced += 1
            req.output_tokens.append(tok)
            self._bump("tokens_emitted")
            if req.on_token is not None:
                try:
                    req.on_token(req, tok)
                except Exception:
                    logger.exception("fleet: on_token callback for "
                                     "request %d raised", req.rid)

    def _sync(self, rep: _Replica) -> None:
        """Emit newly generated tokens (exactly once — ``_sync_one`` is
        the only place fleet ``output_tokens`` grows) and conclude
        finished engine requests. Caller holds rep.lock; the supervisor
        flips state to DOWN under the same lock, so emission never races
        a requeue."""
        for rid in list(rep.inflight):
            req, er = rep.inflight[rid]
            self._sync_one(req, er)
            if er.done:
                del rep.inflight[rid]
                if self.disagg:
                    with self._qlock:
                        self._er2freq.pop(er.rid, None)
                if er.state == FAILED:
                    # deterministic per-request failure (the engine marked
                    # it before propagating would have killed the replica;
                    # reaching here means the engine concluded it cleanly)
                    self._conclude(req, FAILED, er.error)
                elif er.state == TIMEOUT:
                    self._conclude(req, TIMEOUT, er.error)
                else:
                    self._conclude(req, FINISHED)

    def _stamp(self, rep: _Replica) -> None:
        if rep.writer is None:
            return
        try:
            eng = rep.engine
            with self._qlock:
                qdepth = len(self._queue)
            gauges = {"queue": qdepth, "active": eng.active,
                      "lanes": eng.max_batch}
            rate = rep.step_clock.gauge()
            if rate is not None:
                gauges[STEP_MS_GAUGE] = rate
            if eng.role is not None:
                # PREFILL / DECODE visible in `dstpu health`
                gauges["role"] = eng.role
                if self.disagg:
                    gauges["handoff"] = self._handoff.pending
            rep.writer.write(hb.PHASE_SERVE, eng.steps, extra=gauges)
        except Exception:
            pass                        # diagnostics must not kill a replica

    def _bump(self, key: str, n: int = 1) -> None:
        # dict += from N worker threads + the supervisor is a lost-update
        # race; every counter goes through this one lock
        with self._stats_lock:
            self.stats[key] += n

    def _conclude(self, req: FleetRequest, state: str,
                  error: Optional[str] = None) -> None:
        if req._finish(state, error):
            self._bump({FINISHED: "completed", FAILED: "failed",
                        TIMEOUT: "timeout", SHED: "shed"}[state])
        with self._qlock:
            self._outstanding.pop(req.rid, None)

    # ------------------------------------------------- death handling (called
    # by FleetSupervisor; the mechanics live here, the detection there)

    def _replica_down(self, rep: _Replica, reason: str,
                      evidence: Optional[dict]) -> None:
        """Tear down ONE replica: mark DOWN under its lock (fencing any
        late token sync — the worker re-checks state under the same lock
        before emitting, and steps run outside it, so this acquire only
        ever waits on the short dispatch/sync sections), stamp STALLED
        evidence, requeue its in-flight requests, then
        strike/blacklist/restart.

        If the lock cannot be acquired (the worker is wedged INSIDE its
        critical section — e.g. a blocked user on_token callback), the
        replica is only FENCED (state -> DOWN; the worker exits at its
        next state check) and the teardown is parked for the next poll:
        requeueing while the wedged worker could still wake and emit
        would double-fire tokens, and exactly-once beats promptness. A
        section wedged forever defers its requests forever — the same
        verdict a process-wide wedge earns from the rc-117 stack."""
        if not rep.lock.acquire(timeout=5.0):
            rep.state = DOWN
            with self._qlock:
                self._pending_down.append((rep, reason, evidence))
            logger.warning(
                "fleet: replica %d fenced but wedged inside its critical "
                "section — teardown deferred", rep.idx)
            return
        try:
            if rep.state == DOWN:
                pass                    # parked teardown: finish it now
            elif rep.state != LIVE:
                return                  # already fully handled
            rep.state = DOWN
            inflight = list(rep.inflight.values())
            rep.inflight.clear()
            if self.disagg:
                # the dead replica's share of the SHARED pool (decode
                # lanes / half-prefilled chunks / a popped-but-
                # uninstalled item) is detached NOW — under the replica
                # lock, so the worker can't be mid-dispatch — and
                # released only once the thread is provably dead (the
                # abandoned final step may still write through its old
                # tables): _drain_quarantine on the supervisor cadence
                hs = (rep.engine.held_state(timeout=1.0)
                      if rep.engine is not None else ([], []))
                q_blocks = None if hs is None else list(hs[0])
                if q_blocks is not None and rep.holding is not None:
                    q_blocks.append(rep.holding.blocks)
                    rep.holding = None
                with self._qlock:
                    self._quarantine.append((rep, q_blocks))
        finally:
            rep.lock.release()
        rep.strikes += 1
        self._bump("deaths")
        if rep.writer is not None:
            # the verdict, durable: dstpu health shows STALLED for this
            # replica until a restart generation overwrites the rank file
            rep.writer.stamp_terminal(hb.PHASE_STALLED, lock_timeout=1.0)
        death = {"replica": rep.idx, "generation": rep.generation,
                 "reason": reason, "error": rep.error, "evidence": evidence,
                 "strikes": rep.strikes, "detected_ts": time.monotonic(),
                 "action": None, "restarted_ts": None}
        self.deaths.append(death)
        logger.warning(
            "fleet: replica %d DOWN (%s; strike %d): last heartbeat %s",
            rep.idx, reason, rep.strikes,
            "none" if evidence is None else
            f"phase={evidence.get('phase')} step={evidence.get('step')}")
        # reversed: each requeue appendlefts, so walking newest-first
        # leaves the earliest-admitted request at the queue HEAD —
        # FIFO standing preserved across the teardown
        for req, er in reversed(inflight):
            self._requeue(req, er, from_idx=rep.idx)
        if rep.draining:
            # the replica was already being scaled down: its death just
            # ends the drain early — lanes requeued exactly-once above,
            # and the autoscaler wanted the capacity gone, so no strike
            # toward blacklist and no replacement
            death["action"] = "retired"
            self._note_drained(rep, clean=False)
            return
        blacklist_after = int(self.fcfg.blacklist_after)
        if blacklist_after > 0 and rep.strikes >= blacklist_after:
            rep.state = BLACKLISTED
            with self._lock:
                self._replicas[rep.idx] = rep
            self._bump("blacklisted")
            death["action"] = "blacklist"
            logger.warning("fleet: replica %d BLACKLISTED after %d strikes",
                           rep.idx, rep.strikes)
            return
        # the decision is recorded BEFORE the (warm-including, slow)
        # relaunch: readers draining on survivors must see the verdict
        # as soon as it is made, not after the replacement warmed
        death["action"] = "restart"
        self._restart(rep.idx, rep.generation + 1, rep.strikes)
        death["restarted_ts"] = time.monotonic()

    def _replica_drain(self, rep: _Replica, evidence: Optional[dict]
                       ) -> None:
        """Straggler remediation, fleet-side (runtime/straggler.py): a
        replica the cross-replica detector verdicted SLOW is DRAINED
        through the existing death path — admission stops (the DOWN
        fence), its in-flight lanes requeue through the exactly-once
        token-exact path, the strike counts toward ``blacklist_after``,
        and the replacement restarts warmed — instead of letting one
        throttled replica hold the shared queue's p99 hostage. The
        sticky STRAGGLER flag lands on the record BEFORE the STALLED
        verdict so ``dstpu health`` (and the death ledger's evidence)
        names the reason, the SDC-flag pattern."""
        logger.warning(
            "fleet: replica %d is a straggler (step_ms %s vs the fleet) "
            "— draining", rep.idx,
            (evidence or {}).get("gauges", {}).get(STEP_MS_GAUGE))
        if rep.writer is not None:
            rep.writer.add_flag(STRAGGLER_FLAG, lock_timeout=1.0)
        self._replica_down(rep, "straggler", evidence)

    def _requeue(self, req: FleetRequest, er,
                 from_idx: Optional[int] = None,
                 charge_retry: bool = True) -> None:
        """Exactly-once requeue: conclude what the dead replica already
        concluded, finish requests whose budget is spent, retry-budget
        the rest back onto the queue HEAD of their tier (they were
        admitted first — FIFO standing is preserved). ``from_idx`` names
        the dying replica (None for orphan retries): a disagg request
        whose owner moved past it — pushed into the handoff, or already
        popped by a decode replica — is NOT requeued.
        ``charge_retry=False`` is the preemption path: a
        batch lane evicted for a pressured latency request lost nothing
        to a failure, so the eviction must not march it toward a FAILED
        verdict. ``serve.requeue`` crashes here park the request on the
        orphan list for the next supervisor poll."""
        try:
            chaos.failpoint("serve.requeue")
            if self.disagg and er is not None:
                with self._qlock:
                    self._er2freq.pop(er.rid, None)
                    handed = er.rid in self._handoff_inflight
                    taken_over = (from_idx is not None
                                  and req.replica is not None
                                  and req.replica != from_idx)
                if handed or taken_over:
                    # the dying prefill replica's push DID land (fenced
                    # mid-step): either the item still sits registered in
                    # the handoff queue, or a decode replica already
                    # popped it and took ownership (assignment atomic
                    # with the pop under _qlock) — it will be served
                    # exactly once there; requeueing the request too
                    # would serve it twice
                    return
                if er.prefill_progress:
                    # chunk progress carried: how far the dead leg's
                    # prefill got, for the death ledger / observability
                    req.prefill_progress = int(er.prefill_progress)
            if er is not None and er.done and er.state in (FAILED, TIMEOUT):
                self._conclude(req, er.state, er.error)
                return
            if (req.remaining <= 0
                    or (req.eos_token_id is not None and req.output_tokens
                        and req.output_tokens[-1] == req.eos_token_id)):
                self._conclude(req, FINISHED)
                return
            if req.expired():
                self._conclude(req, TIMEOUT, "deadline exceeded at requeue")
                return
            if charge_retry:
                req.retries += 1
            if req.retries > int(self.fcfg.retry_budget):
                self._conclude(
                    req, FAILED,
                    f"retry budget exhausted ({self.fcfg.retry_budget} "
                    f"requeues) after replica failures")
                return
            req.replica, req.state, req._synced = None, QUEUED, 0
            with self._qlock:
                self._queue.appendleft(req)
            self._bump("requeues")
        except chaos.ChaosError as e:
            logger.warning("fleet: requeue of request %d failed (%s) — "
                           "orphaned for retry", req.rid, e)
            with self._qlock:
                self._orphans.append(req)

    def _retry_orphans(self) -> None:
        with self._qlock:
            orphans, self._orphans = self._orphans, []
        for req in orphans:
            self._requeue(req, None)

    def _shed_expired(self) -> None:
        # ONE `now` for both passes: a deadline crossing between the
        # partitioning comprehensions would otherwise drop a request
        # from the queue without ever concluding it
        now = time.monotonic()
        with self._qlock:
            expired = self._queue.remove_expired(now)
        for req in expired:
            self._conclude(req, TIMEOUT, "deadline exceeded while queued")

    def _restart(self, idx: int, generation: int, strikes: int,
                 parole: bool = False) -> None:
        fresh = _Replica(idx, generation=generation, strikes=strikes)
        with self._lock:
            self._replicas[idx] = fresh
        self._bump("restarts")           # counted at initiation: observers
        if parole:                       # must not wait out the warm-up
            self._bump("paroles")
        self._launch(fresh, warm=True)
        logger.warning("fleet: replica %d %s (generation %d)",
                       idx, "PAROLED" if parole else "restarted", generation)

    def _maybe_parole(self) -> None:
        """Capacity floor: with live replicas below ``min_replicas``,
        parole the least-struck blacklisted replica back (strikes stand —
        it can be re-blacklisted) rather than serving starved."""
        with self._lock:
            live = sum(1 for r in self._replicas if r.state == LIVE)
            candidates = [r for r in self._replicas
                          if r.state == BLACKLISTED]
        if live >= int(self.fcfg.min_replicas) or not candidates:
            return
        victim = min(candidates, key=lambda r: (r.strikes, r.idx))
        self._restart(victim.idx, victim.generation + 1, victim.strikes,
                      parole=True)

    # ------------------------------------------------- traffic shaping
    # (autoscaling + preemption; the POLICY lives in serving/autoscale.py,
    # these are the mechanisms the supervisor drives each poll)

    def _autoscale_tick(self) -> None:
        """Feed this poll's gauges — the same numbers the replicas stamp
        into their SERVE heartbeats — through the AutoscalePolicy and
        perform its verdict. Also completes any drain in flight."""
        if self.autoscale is None:
            return
        now = time.monotonic()
        with self._lock:
            reps = list(self._replicas)
        serving = [r for r in reps if r.state == LIVE
                   and not r.draining and not r.warming]
        warming = sum(1 for r in reps if r.state == LIVE and r.warming)
        draining = [r for r in reps if r.state == LIVE and r.draining]
        for rep in draining:
            self._finish_drain(rep)
        with self._qlock:
            qdepth = len(self._queue)
            pressured = self._queue.pressured(
                float(self.fcfg.autoscale.pressure_s), now)
        active = sum(r.engine.active for r in serving
                     if r.engine is not None)
        obs = Observation(
            queue_depth=qdepth, pressured=pressured, live=len(serving),
            warming=warming, draining=len(draining), active_lanes=active,
            total_lanes=len(serving) * int(self.scfg.max_batch))
        verdict = self.autoscale.observe(obs, now)
        if verdict == SCALE_UP:
            self._scale_up(self.autoscale.describe(obs), obs)
        elif verdict == SCALE_DOWN:
            self._scale_down(self.autoscale.describe(obs), obs)

    def _scale_up(self, reason: str, obs: Observation) -> None:
        """Append a NEW replica slot and launch it WARMED (the restart
        path's warm=True): it warms off-path and only then starts its
        worker — scaled-up capacity never serves cold, and its warm-up
        cannot read as heartbeat silence. The ``serve.scale_up``
        failpoint crashes inside the spawn: the slot rolls back and the
        event records ``up_failed`` — a failed spawn leaves the fleet
        exactly as it was (no phantom replica) and still starts the
        cooldown (the overload that caused it is still being answered)."""
        with self._lock:
            idx = len(self._replicas)
            rep = _Replica(idx)
            self._replicas.append(rep)
        event = ScaleEvent(action=SCALE_UP, replica=idx, reason=reason,
                           ts=time.monotonic(), queue=obs.queue_depth,
                           live=obs.live)
        try:
            chaos.failpoint("serve.scale_up", key=str(idx))
            self._launch(rep, warm=True)
        except Exception as e:
            with self._lock:
                if self._replicas and self._replicas[-1] is rep:
                    self._replicas.pop()
            event.action = "up_failed"
            event.error = repr(e)
            self.scale_events.append(event)
            self._stamp_autoscaler(force=True)
            logger.warning("fleet: scale-up of replica %d failed: %s",
                           idx, e)
            return
        self._bump("scale_ups")
        self.scale_events.append(event)
        self._stamp_autoscaler(force=True)
        logger.warning("fleet: scaled UP to replica %d (%s)", idx, reason)

    def _scale_down(self, reason: str, obs: Observation) -> None:
        """Start draining the NEWEST serving replica (LIFO keeps the
        original fleet's indices stable): admission stops now, its lanes
        finish, and ``_finish_drain`` retires it — the straggler-drain
        discipline without the strike. The event is recorded at
        initiation (``drained_ts`` lands at completion), so `dstpu
        health` shows the drain while it is in flight."""
        with self._lock:
            cands = [r for r in self._replicas if r.state == LIVE
                     and not r.draining and not r.warming]
        if len(cands) <= self.autoscale.min_replicas:
            return
        rep = max(cands, key=lambda r: r.idx)
        rep.draining = True
        self.scale_events.append(ScaleEvent(
            action=SCALE_DOWN, replica=rep.idx, reason=reason,
            ts=time.monotonic(), queue=obs.queue_depth, live=obs.live))
        self._stamp_autoscaler(force=True)
        logger.warning("fleet: scaling DOWN replica %d (%s) — draining",
                       rep.idx, reason)

    def _finish_drain(self, rep: _Replica) -> None:
        """Retire a draining replica once its lanes emptied: state flips
        to RETIRED under the replica lock (the worker exits at its next
        state check; a step cannot be in flight for an idle engine) and
        the EXIT terminal stamp — not STALLED — records a conclusion,
        not a failure. A still-busy or lock-contended drain just waits
        for the next poll; a draining replica that DIES instead goes
        through ``_replica_down`` (exactly-once requeue, no restart)."""
        if rep.inflight or (rep.engine is not None
                            and rep.engine.has_work):
            return
        if not rep.lock.acquire(timeout=1.0):
            return
        try:
            if rep.state != LIVE or not rep.draining:
                return
            if rep.inflight or rep.engine.has_work:
                return
            rep.state = RETIRED
        finally:
            rep.lock.release()
        if rep.writer is not None:
            rep.writer.stamp_terminal(hb.PHASE_EXIT, lock_timeout=1.0)
        self._note_drained(rep, clean=True)
        logger.warning("fleet: replica %d RETIRED (drain complete)",
                       rep.idx)

    def _note_drained(self, rep: _Replica, clean: bool) -> None:
        """Conclude the replica's scale-down event in the capacity
        ledger (``clean=False``: the drain ended by death — its lanes
        requeued exactly-once rather than finishing in place)."""
        self._bump("scale_downs")
        for ev in reversed(self.scale_events):
            if ev.action == SCALE_DOWN and ev.replica == rep.idx \
                    and ev.drained_ts is None:
                ev.drained_ts = time.monotonic()
                if not clean:
                    ev.error = "drain ended by replica death"
                break
        self._stamp_autoscaler(force=True)

    def _stamp_autoscaler(self, force: bool = False) -> None:
        """The autoscaler's heartbeat record: refreshed every supervisor
        poll (so it never reads as silent while supervised) and forced
        on every scale event — `dstpu health` shows the last verdict in
        the gauges column alongside the replicas it acted on."""
        if self._as_writer is None:
            return
        try:
            with self._qlock:
                qdepth = len(self._queue)
            with self._lock:
                live = sum(1 for r in self._replicas
                           if r.state == LIVE and not r.draining)
            gauges = {"role": "AUTOSCALER", "queue": qdepth, "live": live,
                      "events": len(self.scale_events)}
            if self.scale_events:
                ev = self.scale_events[-1]
                gauges["event"] = f"{ev.action}@r{ev.replica}"
            self._as_writer.write(hb.PHASE_SERVE, len(self.scale_events),
                                  force=force, extra=gauges)
        except Exception:
            pass                        # diagnostics must not kill a poll

    def _maybe_preempt(self) -> None:
        """Deadline-pressured latency admission: when a
        latency-tier request is queued within ``preempt_pressure_s`` of
        its deadline and NO serving replica has a free lane, evict the
        youngest RUNNING batch-tier lane and requeue it through the
        exactly-once token-exact path (emitted prefix carried, no
        retry-budget charge) — the freed lane admits the pressured
        request at the owner's next dispatch. At most one eviction per
        poll bounds the churn. The ``serve.preempt`` failpoint fires in
        the window between eviction and requeue: a crash there parks the
        victim on the orphan list — deferred, never lost, never
        double-emitted (its lane is gone and its cursor was synced under
        the replica lock)."""
        window = float(self.fcfg.preempt_pressure_s)
        if window <= 0 or self.disagg:
            return
        now = time.monotonic()
        with self._qlock:
            pressured = next(
                (r for r in self._queue
                 if r.priority == LATENCY and r.deadline_ts is not None
                 and 0.0 <= (r.deadline_ts - now) < window), None)
        if pressured is None:
            return
        with self._lock:
            reps = [r for r in self._replicas
                    if r.state == LIVE and not r.draining]
        if any(r.engine is not None and r.engine.wants_dispatch
               for r in reps):
            return                       # a free lane will serve it
        for rep in reps:
            if not rep.lock.acquire(timeout=1.0):
                continue
            try:
                if rep.state != LIVE:
                    continue
                victim = None
                for freq, er in rep.inflight.values():
                    if freq.priority == BATCH and er.state == RUNNING \
                            and (victim is None
                                 or freq.arrival_ts > victim[0].arrival_ts):
                        victim = (freq, er)
                if victim is None:
                    continue
                freq, er = victim
                # sync BEFORE evicting: tokens the engine already
                # generated are emitted (the healthy-replica economy the
                # death path cannot have), then the eviction drops only
                # lane state — the requeue resumes from prompt+emitted
                self._sync_one(freq, er)
                if not rep.engine.preempt_request(er, timeout=1.0):
                    continue
                rep.inflight.pop(freq.rid, None)
                freq.preemptions += 1
                self._bump("preempted")
                logger.warning(
                    "fleet: preempting batch request %d on replica %d "
                    "for pressured latency request %d", freq.rid,
                    rep.idx, pressured.rid)
                try:
                    chaos.failpoint("serve.preempt")
                except chaos.ChaosError as e:
                    logger.warning(
                        "fleet: preemption requeue of request %d failed "
                        "(%s) — orphaned for retry", freq.rid, e)
                    with self._qlock:
                        self._orphans.append(freq)
                    return
                self._requeue(freq, None, from_idx=rep.idx,
                              charge_retry=False)
                return
            finally:
                rep.lock.release()


class FleetSupervisor:
    """Consumes the fleet's heartbeat channel and replica thread liveness;
    detection only — teardown/requeue mechanics live on the fleet.

    DOWN verdicts, in evidence order:

    * a dead worker thread (the in-process analog of a rank exit) — the
      last heartbeat record is the attribution;
    * ``heartbeat_timeout`` seconds of record silence from a live thread
      (rc-117 contract: the record is non-terminal and stale, or the
      replica never wrote despite ``heartbeat_timeout`` since launch) —
      the wedge/hang case.

    ``poll()`` is the public deterministic entry (tests call it
    directly); ``start()`` runs it on a daemon thread every
    ``poll_interval`` seconds. Each poll also retries orphaned requeues,
    sheds expired queued requests, and applies the parole floor."""

    def __init__(self, fleet: ServingFleet):
        self.fleet = fleet
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # straggler drain: the cross-rank relative-slowness
        # detector over the replicas' step_ms SERVE gauges — fleet.
        # straggler.enabled opts in (getattr: verdict-unit tests build
        # the supervisor over a bare fcfg namespace)
        scfg = getattr(fleet.fcfg, "straggler", None)
        self._straggler: Optional[StragglerDetector] = (
            StragglerDetector(scfg)
            if scfg is not None and scfg.enabled else None)

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="dstpu-fleet-supervisor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        interval = max(float(self.fleet.fcfg.poll_interval), 0.01)
        while not self._stop.wait(interval):
            try:
                self.poll()
            except Exception:
                logger.exception("fleet supervisor poll failed")

    # ------------------------------------------------------------- detection

    def poll(self) -> List[dict]:
        """One supervision pass; returns the deaths it declared (a
        fenced-but-wedged teardown records its death only once its lock
        frees, possibly on a later poll — the ledger snapshot below
        captures whichever pass it lands on)."""
        fleet = self.fleet
        records = hb.read_heartbeats(fleet.heartbeat_dir)
        now = time.monotonic()
        n_deaths = len(fleet.deaths)
        with fleet._lock:
            reps = list(fleet._replicas)
        # finish any fenced-but-wedged teardowns first: their lock may
        # have freed (worker exited at its DOWN fence) since last poll
        with fleet._qlock:
            pending, fleet._pending_down = fleet._pending_down, []
        for rep, reason, ev in pending:
            fleet._replica_down(rep, reason, ev)
        for rep in reps:
            if rep.state != LIVE:
                continue
            evidence = records.get(rep.idx)
            verdict = self._verdict(rep, evidence, now)
            if verdict is not None:
                fleet._replica_down(rep, verdict, evidence)
        if self._straggler is not None:
            self._check_stragglers(reps, records)
        fleet._retry_orphans()
        fleet._shed_expired()
        fleet._maybe_preempt()
        fleet._autoscale_tick()
        fleet._stamp_autoscaler()
        if fleet.disagg:
            # handoff deadlines must hold even with every decode replica
            # down, and dead replicas' shared-pool blocks release once
            # their threads are provably gone
            fleet._shed_handoff()
            fleet._drain_quarantine()
        fleet._maybe_parole()
        return list(fleet.deaths[n_deaths:])

    def _check_stragglers(self, reps: List[_Replica],
                          records: Dict[int, dict]) -> None:
        """One straggler observation window over the LIVE replicas'
        step_ms gauges (runtime/straggler.py): a verdicted replica is
        drained through the replica-death path. Warming replicas are
        excluded — their frozen pre-warm gauge measures nothing."""
        live = {r.idx: r for r in reps
                if r.state == LIVE and not r.warming and not r.draining}
        snapshot = {idx: rec for idx, rec in records.items()
                    if idx in live}
        for idx in self._straggler.observe(snapshot):
            rep = live.get(idx)
            if rep is None or rep.state != LIVE:
                continue
            self._straggler.forget(idx)   # the replacement starts clean
            self.fleet._replica_drain(rep, records.get(idx))

    def _verdict(self, rep: _Replica, evidence: Optional[dict],
                 now: float) -> Optional[str]:
        if rep.thread is not None and not rep.thread.is_alive():
            return "warm-up failed" if rep.warm_failed else "crash"
        if rep.warming:
            # warmup() holds the replica lock through a warm-up request;
            # the parked worker cannot stamp — silence is expected and
            # healthy here (thread death above still applies)
            return None
        timeout = float(self.fleet.fcfg.heartbeat_timeout)
        if timeout <= 0:
            return None
        if evidence is None:
            # expected-but-never-wrote: launched long enough ago that the
            # first loop iteration's stamp is overdue
            if now - rep.started_ts > timeout:
                return "silence"
            return None
        if evidence.get("phase") in hb.TERMINAL_PHASES:
            return None                 # a conclusion, not silence
        if hb.record_age(evidence) > timeout:
            return "silence"
        return None
