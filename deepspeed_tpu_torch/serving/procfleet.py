"""ProcessFleet — the serving fleet with process-per-replica placement
(counterpart of ``deepspeed_tpu/serving/procfleet.py``).

``serving.fleet.placement: "process"`` runs each replica engine in its
own supervised OS process (serving/replica_worker.py) instead of a
thread: the failure domain the thread fleet shrank to a thread becomes a
real process boundary — a replica death is a process death, its CUDA
context, pool and weights die WITH it (no abandoned-thread leak), and
the same machinery extends to replicas on other hosts. The public
surface mirrors :class:`~.fleet.ServingFleet`
(submit/drain/close/warmup/stats/deaths/kernel_launches), so callers
swap placements without code changes; :func:`make_fleet` picks by
config.

Plumbing, over the transfer fabric (runtime/fabric/):

* **Weights via checkpoint load.** The hub saves params once
  (runtime/checkpointing.save_tree flat-npz) plus the model/serving
  configs as JSON into a workdir; every spawn (and every warmed
  restart) loads from there onto the hub's device. No live tensors
  cross the process boundary. On CUDA the hub builds the serving
  kernels' libraries before the first spawn, so no two children ever
  run ``nvcc`` on one library; children are started with
  ``subprocess`` (a fresh interpreter, never a fork of the hub's CUDA
  context).
* **A TCP star.** Workers dial in with hello ``{"ident": "replica-N"}``;
  the hub bumps that ident's EPOCH, answers ``welcome {gen: epoch}``
  (fabric generation fencing), and reads frames on a per-connection
  thread. A frame whose connection epoch is no longer current is
  dropped — a half-dead worker's late tokens cannot land after its
  requests were requeued. Link loss is NOT death: the worker redials
  (bounded fabric ladder) into a fresh epoch and keeps serving.
* **Exactly-once by hub arithmetic.** Dispatch sends ``prompt`` +
  ``emitted`` (the requeue prefix) and the budget; workers frame
  CUMULATIVE token lists with the dispatch ``base``, and the hub
  appends only ``toks[have - base:]`` — duplicated, reordered-by-
  redial, or replayed frames are no-ops on the FleetRequest ledger.
* **Death verdicts: process exit or heartbeat silence.** Workers stamp
  SERVE records (queue/active/pool_used/pid gauges) into the shared
  heartbeat dir (``dstpu health`` shows per-process replica rows); the
  supervisor poll declares DOWN only on ``proc.poll() is not None`` or
  ``heartbeat_timeout`` of record silence. Teardown
  requeues in-flight requests token-exactly (retry budget, orphan
  parking on ``serve.requeue`` crashes), stamps STALLED evidence,
  strikes/blacklists/paroles, and respawns a warmed replacement with a
  fresh generation.

Disagg roles are refused: prefill/decode share ONE in-process pool by
construction — the zero-copy handoff cannot cross a process boundary.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..models.generation import ensure_scan_layout
from ..ops import build
from ..runtime import heartbeat as hb
from ..runtime.fabric import HubConn, read_frame
from ..testing import chaos
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .autoscale import (AUTOSCALER_RANK, SCALE_DOWN, SCALE_UP,
                        AutoscalePolicy, Observation, ScaleEvent)
from .fleet import (BLACKLISTED, DOWN, LIVE, RETIRED, SERVING_KERNELS,
                    FleetRequest)
from .scheduler import (BATCH, FAILED, FINISHED, LATENCY, PRIORITY_TIERS,
                        QUEUED, RUNNING, SHED, STANDARD, TIER_RANK, TIMEOUT,
                        TieredQueue, admit_or_shed, check_admissible)

PyTree = Any


class _Proc:
    """One replica process slot. A restart builds a NEW _Proc for the
    same index (strikes carried) — the dead one keeps its Popen handle
    for post-mortem rc reads only."""

    def __init__(self, idx: int, generation: int = 0, strikes: int = 0):
        self.idx = idx
        self.generation = generation   # spawn generation (death ledger)
        self.strikes = strikes
        self.state = LIVE
        self.ready = False             # worker warmed + said hello
        self.draining = False          # scale-down in flight
        self.proc: Optional[subprocess.Popen] = None
        self.conn: Optional[HubConn] = None
        self.pid: Optional[int] = None
        self.inflight: Dict[int, FleetRequest] = {}
        self.error: Optional[str] = None
        self.started_ts = time.monotonic()
        self.retired_ts: Optional[float] = None
        #: the worker's served-kernel launch counts, from its newest frame
        self.launches: Dict[str, int] = {}


class ProcessFleet:
    """See module docstring. Same constructor shape as ServingFleet;
    ``workdir`` overrides the private tempdir the weights npz + config
    JSONs land in; ``env_first`` is overlaid on the FIRST spawn of each
    replica only (one-shot DSTPU_CHAOS specs must not re-arm in
    restarted processes). ``device`` (default CUDA) is the device every
    worker serves on."""

    def __init__(self, cfg, params: PyTree, serving=None,
                 heartbeat_dir: Optional[str] = None,
                 workdir: Optional[str] = None,
                 env_first: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None, device=None):
        from ..config.config import ServingConfig
        if serving is None:
            serving = ServingConfig()
        elif isinstance(serving, dict):
            serving = ServingConfig(**serving)
        self.cfg = cfg
        self.scfg = serving
        self.fcfg = serving.fleet
        self.device = resolve_device(device)
        if int(self.fcfg.prefill_replicas) or int(self.fcfg.decode_replicas):
            raise ValueError(
                "serving.fleet: placement='process' requires plain "
                "replicas — disaggregated prefill/decode roles share one "
                "in-process KV pool (the zero-copy handoff cannot cross "
                "a process boundary)")
        self.n_replicas = max(1, int(self.fcfg.replicas))
        # traffic-shaped autoscaling: the SAME policy the
        # thread fleet feeds — disagg is already refused above, so the
        # plain-replicas precondition holds by construction
        self.autoscale: Optional[AutoscalePolicy] = None
        if self.fcfg.autoscale.enabled:
            self.autoscale = AutoscalePolicy(self.fcfg.autoscale)
            self.n_replicas = min(max(self.n_replicas,
                                      self.autoscale.min_replicas),
                                  self.autoscale.max_replicas)
        self.heartbeat_dir = (heartbeat_dir or self.fcfg.heartbeat_dir
                              or tempfile.mkdtemp(prefix="dstpu-pfleet-hb-"))
        self.workdir = workdir or tempfile.mkdtemp(prefix="dstpu-pfleet-")
        self.log_dir = log_dir
        self._env_first = dict(env_first or {})
        self._env_first_spawned: set = set()
        self._queue = TieredQueue(                # guarded by _qlock
            aging_s=float(self.fcfg.priority_aging_s))
        self._qlock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._orphans: List[FleetRequest] = []
        self._outstanding: Dict[int, FleetRequest] = {}
        self._rid = 0
        self._stop = threading.Event()
        self._started = False
        self._lock = threading.Lock()            # replica-list mutations
        self._replicas: List[_Proc] = [_Proc(i)
                                       for i in range(self.n_replicas)]
        #: per-ident hello epoch — the fabric generation fence. Bumped on
        #: every hello AND on every death verdict, so frames from a
        #: fenced connection can never land post-requeue.
        self._epochs: List[int] = [0] * self.n_replicas
        self._server: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._accept_t: Optional[threading.Thread] = None
        self._poll_t: Optional[threading.Thread] = None
        self._logs: Dict[int, Any] = {}
        self.deaths: List[dict] = []
        #: capacity ledger, mirroring ServingFleet: every
        #: autoscaler verdict with its trigger and queue/live evidence
        self.scale_events: List[ScaleEvent] = []
        self._as_writer: Optional[hb.HeartbeatWriter] = None
        #: launch counts of dead worker generations, by replica index
        self._dead_launches: Dict[int, Dict[str, int]] = {}
        self.stats: Dict[str, int] = {
            "submitted": 0, "completed": 0, "failed": 0, "timeout": 0,
            "requeues": 0, "deaths": 0, "restarts": 0, "paroles": 0,
            "blacklisted": 0, "tokens_emitted": 0, "shed": 0,
            "preempted": 0, "scale_ups": 0, "scale_downs": 0}
        hb.clear_channel(self.heartbeat_dir)
        self._stage_artifacts(params)
        log_dist(
            f"ProcessFleet: {self.n_replicas} replica processes, "
            f"retry_budget={self.fcfg.retry_budget}, "
            f"heartbeat_dir={self.heartbeat_dir}", ranks=[0])

    # ------------------------------------------------------------------ setup

    def _stage_artifacts(self, params: PyTree) -> None:
        """Write the restart-stable artifacts every spawn loads: weights
        as a flat npz, model + serving configs as JSON."""
        from ..runtime.checkpointing import save_tree
        from .replica_worker import cfg_to_dict
        os.makedirs(self.workdir, exist_ok=True)
        self._params_path = os.path.join(self.workdir, "params.npz")
        save_tree(ensure_scan_layout(params, self.cfg.num_layers),
                  self._params_path)
        self._model_json = os.path.join(self.workdir, "model.json")
        with open(self._model_json, "w") as f:
            json.dump(cfg_to_dict(self.cfg), f)
        self._serving_json = os.path.join(self.workdir, "serving.json")
        with open(self._serving_json, "w") as f:
            json.dump(self.scfg.model_dump(mode="json"), f)

    def _worker_cmd(self, idx: int) -> List[str]:
        argv = ["--replica", str(idx),
                "--hub-port", str(self.port),
                "--params", self._params_path,
                "--model-json", self._model_json,
                "--serving-json", self._serving_json,
                "--hb-dir", self.heartbeat_dir,
                "--hb-interval", str(self.fcfg.heartbeat_interval),
                "--device", str(self.device)]
        # the package root goes on sys.path INSIDE the child, never
        # through PYTHONPATH (an inherited one could shadow the child's
        # own dependencies)
        import deepspeed_tpu_torch
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__)))
        boot = ("import sys; sys.path.insert(0, {root!r}); "
                "from deepspeed_tpu_torch.serving.replica_worker "
                "import main; raise SystemExit(main({argv!r}))").format(
                    root=pkg_root, argv=argv)
        return [sys.executable, "-c", boot]

    def _spawn(self, rep: _Proc) -> None:
        env = dict(os.environ)
        if rep.idx not in self._env_first_spawned:
            env.update(self._env_first)
            self._env_first_spawned.add(rep.idx)
        out = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            if rep.idx not in self._logs:
                self._logs[rep.idx] = open(
                    os.path.join(self.log_dir,
                                 f"replica{rep.idx}.log"), "ab")
            out = self._logs[rep.idx]
        proc = subprocess.Popen(
            self._worker_cmd(rep.idx), env=env, stdout=out,
            stderr=subprocess.STDOUT if out else None)
        with self._lock:
            rep.proc = proc
            rep.pid = proc.pid

    # -------------------------------------------------------------- lifecycle

    def start(self) -> "ProcessFleet":
        if self._started:
            return self
        self._started = True
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", 0))
        self._server.listen(self.n_replicas + 4)
        self.port = self._server.getsockname()[1]
        self._accept_t = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._accept_t.start()
        if self.device.type == "cuda":
            build.build(SERVING_KERNELS)
        for rep in self._replicas:
            self._spawn(rep)
        if self.autoscale is not None:
            # the autoscaler's own heartbeat rank — scale events are
            # operator evidence in the SAME channel `dstpu health`
            # reads; refreshed every supervisor poll
            self._as_writer = hb.HeartbeatWriter(
                self.heartbeat_dir, rank=AUTOSCALER_RANK,
                host="autoscaler",
                min_interval=float(self.fcfg.heartbeat_interval),
                refresh_interval=0.0)
            self._stamp_autoscaler(force=True)
        self._poll_t = threading.Thread(target=self._poll_loop, daemon=True)
        self._poll_t.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop polling, ask workers to exit (rc 0), reap within
        ``timeout``, kill stragglers. Outstanding requests are left
        un-concluded — drain first if they matter."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        for rep in self._replicas:
            conn = rep.conn
            if conn is not None:
                try:
                    conn.send({"cmd": "stop"})
                    continue
                except OSError:
                    pass
            # no link to carry the stop (a worker still loading, a
            # restarted one that never dialed in): it serves nothing yet,
            # so it is killed now rather than waited for
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.kill()
        for rep in self._replicas:
            p = rep.proc
            if p is None or p.poll() is not None:
                continue
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(5.0)
        for rep in self._replicas:
            if rep.conn is not None:
                rep.conn.close()
                rep.conn = None
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        if self._poll_t is not None:
            self._poll_t.join(2.0)
        if self._as_writer is not None:
            self._as_writer.stamp_terminal(hb.PHASE_EXIT, lock_timeout=1.0)
        for f in self._logs.values():
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self) -> "ProcessFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- submission
    # (the ServingFleet contract verbatim — same admission predicate,
    # same bounded queue, same failpoint)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token=None, on_finish=None,
               priority: str = STANDARD) -> FleetRequest:
        chaos.failpoint("serve.enqueue")
        if priority not in TIER_RANK:
            raise ValueError(f"unknown priority tier {priority!r}; pick "
                             f"one of {PRIORITY_TIERS}")
        prompt = [int(t) for t in prompt]
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

    @property
    def kernel_launches(self) -> Dict[int, Dict[str, int]]:
        """Replica index -> {kernel wrapper name: served launches} as the
        workers report them, summed over every process generation."""
        with self._lock:
            out = {i: dict(d) for i, d in self._dead_launches.items()}
            for r in self._replicas:
                tally = out.setdefault(r.idx, {})
                for k, v in r.launches.items():
                    tally[k] = tally.get(k, 0) + v
        return out

    def pids(self) -> Dict[int, Optional[int]]:
        """Live replica index -> worker PID (the chaos matrix and the
        bench kill PROCESSES, not threads)."""
        with self._lock:
            return {r.idx: r.pid for r in self._replicas
                    if r.state == LIVE}

    def drain(self, timeout: float = 60.0) -> bool:
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
               max_new_tokens: int = 2, timeout: float = 120.0) -> None:
        """Block until every live replica process warmed and said
        ready — workers warm THEMSELVES at spawn (weights + warm-up off
        the serving path); this is the barrier, not the trigger."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                waiting = [r.idx for r in self._replicas
                           if r.state == LIVE and not r.ready]
            if not waiting:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"fleet warmup: replicas {waiting} not ready in {timeout}s")

    # ------------------------------------------------------------- hub plumbing

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._server.settimeout(0.2)
                sock, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(sock,),
                             daemon=True).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        """Hello -> epoch bump -> welcome -> reader loop. Re-dials from
        a living worker land here too: the NEW epoch fences every frame
        the old connection might still cough up."""
        try:
            meta, _ = read_frame(sock)
            if meta.get("cmd") != "hello":
                sock.close()
                return
            idx = int(meta["replica"])
            with self._lock:
                if not 0 <= idx < self.n_replicas:
                    sock.close()
                    return
                self._epochs[idx] += 1
                epoch = self._epochs[idx]
                rep = self._replicas[idx]
                dead = rep.state != LIVE
                old = rep.conn if not dead else None
            if dead:
                # a RETIRED (or verdicted) worker redialing in: answer
                # with the stop its teardown may have missed — the epoch
                # bump above already fences anything it frames meanwhile
                conn = HubConn(sock, ident=f"replica-{idx}", gen=epoch)
                conn.welcome()
                try:
                    conn.send({"cmd": "stop"})
                except OSError:
                    pass
                conn.close()
                return
            with self._lock:
                conn = HubConn(sock, ident=f"replica-{idx}", gen=epoch)
                rep.conn = conn
                if meta.get("pid") is not None:
                    rep.pid = int(meta["pid"])
            if old is not None:
                old.close()
            conn.welcome()
            # re-dispatch everything this replica still owes: a redial
            # means frames in flight on the old connection may be LOST
            # (a serve command the worker never read would strand its
            # request RUNNING forever). The worker dedups by rid, and
            # the emitted prefix + base arithmetic keep a genuinely
            # re-served request token-exact — so re-sending is free.
            with self._qlock:
                owed = [(req, list(req.output_tokens))
                        for req in rep.inflight.values() if not req.done]
            for req, emitted in owed:
                dl = (max(req.deadline_ts - time.monotonic(), 0.0)
                      if req.deadline_ts is not None else None)
                conn.send({"cmd": "serve", "rid": req.rid,
                           "prompt": req.prompt,
                           "max_new_tokens": req.max_new_tokens,
                           "emitted": emitted,
                           "temperature": req.temperature,
                           "eos": req.eos_token_id, "deadline_s": dl})
        except (OSError, ValueError, KeyError):
            try:
                sock.close()
            except OSError:
                pass
            return
        self._read_conn(rep, conn, epoch)

    def _read_conn(self, rep: _Proc, conn: HubConn, epoch: int) -> None:
        while not self._stop.is_set():
            try:
                meta, _ = read_frame(conn.sock)
            except OSError:
                break
            with self._lock:
                stale = self._epochs[rep.idx] != epoch
            if stale:
                break                   # fenced: drop frame, stop reading
            cmd = meta.get("cmd")
            if cmd == "ready":
                with self._lock:
                    rep.ready = True
            elif cmd in ("prog", "done"):
                if meta.get("launches"):
                    with self._lock:
                        rep.launches = {k: int(v) for k, v in
                                        meta["launches"].items()}
                self._apply_tokens(rep, meta, final=(cmd == "done"))
                if cmd == "done":
                    # at-least-once done delivery: the worker re-sends
                    # its conclusion until acked; _apply_tokens is
                    # idempotent, so a duplicate costs nothing and a
                    # frame lost to corruption/partition costs a retry
                    try:
                        conn.send({"cmd": "ack", "rid": int(meta["rid"])})
                    except OSError:
                        pass            # next re-send lands on the redial
        # the reader owns teardown of ITS connection: closing the socket
        # (not just dropping the ref) is what turns a one-sided hub-side
        # failure (e.g. a FrameCorrupt read) into the OSError the
        # worker's send path needs to trigger its redial ladder
        conn.close()
        with self._lock:
            if rep.conn is conn:
                rep.conn = None         # link lost — NOT death; the
                #                         worker redials, or the poll's
                #                         exit/silence verdict lands

    def _apply_tokens(self, rep: _Proc, meta: dict, final: bool) -> None:
        """The exactly-once append: cumulative leg tokens + dispatch
        base make every frame idempotent on the hub ledger."""
        rid = int(meta["rid"])
        base = int(meta.get("base", 0))
        toks = [int(t) for t in meta.get("toks", [])]
        fresh: List[int] = []
        with self._qlock:
            req = self._outstanding.get(rid)
            if req is None or req.done or req.replica != rep.idx:
                return                  # concluded or reassigned: stale
            have = len(req.output_tokens)
            fresh = toks[max(have - base, 0):]
            req.output_tokens.extend(fresh)
        if fresh:
            self._bump("tokens_emitted", len(fresh))
            if req.on_token is not None:
                for t in fresh:
                    try:
                        req.on_token(req, t)
                    except Exception:
                        logger.exception(
                            "fleet: on_token for request %d raised", rid)
        if final:
            rep.inflight.pop(rid, None)
            state = meta.get("state", FINISHED)
            if state not in (FINISHED, FAILED, TIMEOUT):
                state = FINISHED
            self._conclude(req, state, meta.get("error"))
        elif (len(req.output_tokens) >= req.max_new_tokens
              or (req.eos_token_id is not None and fresh
                  and fresh[-1] == req.eos_token_id)):
            # budget/eos satisfaction concludes hub-side even if the
            # worker's done frame is lost on the wire — the cumulative
            # prog that carried the last token is proof enough
            rep.inflight.pop(rid, None)
            self._conclude(req, FINISHED)

    # -------------------------------------------------------------- supervisor

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception:
                logger.exception("ProcessFleet: poll failed")
            self._stop.wait(float(self.fcfg.poll_interval))

    def poll(self) -> List[dict]:
        """One supervision pass (public for deterministic tests): death
        verdicts (process exit / heartbeat silence), orphan retries,
        deadline sheds, dispatch. Returns deaths verdicted this pass."""
        verdicts: List[dict] = []
        with self._lock:
            reps = list(self._replicas)
            ready = {r.idx for r in reps if r.ready}
        timeout = float(self.fcfg.heartbeat_timeout)
        records = hb.read_heartbeats(self.heartbeat_dir)
        # stale_ranks returns RECORDS (non-terminal, gone silent), not
        # rank ints — project down to the rank set before membership tests
        stale = ({int(rec["rank"]) for rec in hb.stale_ranks(
                      self.heartbeat_dir, timeout, records=records)}
                 if timeout > 0 else set())
        now = time.monotonic()
        for rep in reps:
            if rep.state == RETIRED and rep.proc is not None:
                # reap the retired worker (its stop command exits rc 0
                # and it stamps its own EXIT). A worker that never got
                # the stop — link down at drain time — is killed after a
                # grace window; the hub stamps EXIT on its behalf (a
                # RETIRED replica concluded, it did not fail).
                if rep.proc.poll() is None and rep.retired_ts is not None \
                        and now - rep.retired_ts > 5.0:
                    rep.proc.kill()
                    rep.retired_ts = None
                    try:
                        w = hb.HeartbeatWriter(
                            self.heartbeat_dir, rank=rep.idx,
                            refresh_interval=0)
                        w.stamp_terminal(hb.PHASE_EXIT, lock_timeout=1.0)
                    except Exception:
                        pass
                continue
            if rep.state != LIVE or rep.proc is None:
                continue
            rc = rep.proc.poll()
            if rc is not None and rc != 0:
                verdicts.append(self._replica_down(
                    rep, f"process exit rc={rc}", records.get(rep.idx)))
            elif rc == 0 and not self._stop.is_set():
                # a worker never exits 0 unbidden — treat as death too
                # (covers a stop command it was never sent)
                verdicts.append(self._replica_down(
                    rep, "process exit rc=0", records.get(rep.idx)))
            elif rep.idx in ready and rep.idx in stale:
                verdicts.append(self._replica_down(
                    rep, "heartbeat silence", records.get(rep.idx)))
        self._retry_orphans()
        self._shed_expired()
        self._maybe_parole()
        self._maybe_preempt()
        self._autoscale_tick()
        self._stamp_autoscaler()
        self._dispatch_all()
        return verdicts

    def _replica_down(self, rep: _Proc, reason: str,
                      evidence: Optional[dict]) -> dict:
        """Tear down ONE replica process: bump its epoch FIRST (fencing
        any frames a half-dead worker or dying connection still emits —
        the process-placement analogue of marking DOWN under the replica
        lock), kill the process, requeue in-flight token-exactly, stamp
        STALLED evidence, then strike / blacklist / warmed restart."""
        with self._lock:
            if rep.state != LIVE:
                return {}
            rep.state = DOWN
            self._epochs[rep.idx] += 1
            conn, rep.conn = rep.conn, None
            pid = rep.pid
        if conn is not None:
            conn.close()
        if rep.proc is not None and rep.proc.poll() is None:
            rep.proc.kill()
            try:
                rep.proc.wait(5.0)
            except subprocess.TimeoutExpired:
                pass
        inflight = list(rep.inflight.values())
        rep.inflight.clear()
        with self._lock:
            dead = self._dead_launches.setdefault(rep.idx, {})
            for k, v in rep.launches.items():
                dead[k] = dead.get(k, 0) + v
            rep.launches = {}
        rep.strikes += 1
        self._bump("deaths")
        try:
            w = hb.HeartbeatWriter(self.heartbeat_dir, rank=rep.idx,
                                   refresh_interval=0)
            w.stamp_terminal(hb.PHASE_STALLED, lock_timeout=1.0)
        except Exception:
            pass                        # diagnostics must not block teardown
        death = {"replica": rep.idx, "generation": rep.generation,
                 "reason": reason, "error": rep.error, "evidence": evidence,
                 "strikes": rep.strikes, "detected_ts": time.monotonic(),
                 "action": None, "restarted_ts": None}
        self.deaths.append(death)
        logger.warning(
            "fleet: replica process %d DOWN (%s; strike %d; pid %s)",
            rep.idx, reason, rep.strikes, pid)
        for req in reversed(inflight):
            self._requeue(req)
        if rep.draining:
            # the replica was already being scaled down: its death just
            # ends the drain early — lanes requeued exactly-once above,
            # and the autoscaler wanted the capacity gone, so no strike
            # toward blacklist and no replacement
            rep.state = RETIRED
            death["action"] = "retired"
            self._note_drained(rep, clean=False)
            return death
        blacklist_after = int(self.fcfg.blacklist_after)
        if blacklist_after > 0 and rep.strikes >= blacklist_after:
            rep.state = BLACKLISTED
            with self._lock:
                self._replicas[rep.idx] = rep
            self._bump("blacklisted")
            death["action"] = "blacklist"
            logger.warning("fleet: replica %d BLACKLISTED after %d strikes",
                           rep.idx, rep.strikes)
            return death
        death["action"] = "restart"
        self._restart(rep.idx, rep.generation + 1, rep.strikes)
        death["restarted_ts"] = time.monotonic()
        return death

    def _requeue(self, req: FleetRequest, charge_retry: bool = True) -> None:
        """ServingFleet._requeue, minus the disagg arm: conclude spent /
        finished / expired requests, retry-budget the rest back onto the
        queue HEAD (of the request's own tier). A ``serve.requeue`` crash
        parks on the orphan list. ``charge_retry=False`` is the
        preemption path: the fleet evicted a healthy victim for capacity
        reasons, so the victim's failure budget is untouched."""
        try:
            chaos.failpoint("serve.requeue")
            if req.done:
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
            req.replica, req.state = None, QUEUED
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
            self._requeue(req)

    def _shed_expired(self) -> None:
        now = time.monotonic()
        with self._qlock:
            expired = self._queue.remove_expired(now)
        for req in expired:
            self._conclude(req, TIMEOUT, "deadline exceeded while queued")

    def _restart(self, idx: int, generation: int, strikes: int,
                 parole: bool = False) -> None:
        fresh = _Proc(idx, generation=generation, strikes=strikes)
        with self._lock:
            self._replicas[idx] = fresh
        self._bump("restarts")
        if parole:
            self._bump("paroles")
        self._spawn(fresh)
        logger.warning("fleet: replica %d %s (process generation %d)",
                       idx, "PAROLED" if parole else "restarted", generation)

    def _maybe_parole(self) -> None:
        with self._lock:
            live = sum(1 for r in self._replicas if r.state == LIVE)
            if live >= max(1, int(self.fcfg.min_replicas)):
                return
            black = [r for r in self._replicas if r.state == BLACKLISTED]
        if not black:
            return
        rep = min(black, key=lambda r: r.strikes)
        self._restart(rep.idx, rep.generation + 1, rep.strikes, parole=True)

    # ------------------------------------------------- traffic shaping
    # (autoscaling + preemption — the process-placement mechanisms for
    # the one policy in serving/autoscale.py; mirrors ServingFleet)

    def _autoscale_tick(self) -> None:
        """Feed this poll's gauges through the AutoscalePolicy and
        perform its verdict; also completes any drain in flight. A
        spawned-but-not-ready worker counts as WARMING (it is compiling
        off-path), so the policy stays silent until it lands."""
        if self.autoscale is None:
            return
        now = time.monotonic()
        with self._lock:
            reps = list(self._replicas)
            serving = [r for r in reps if r.state == LIVE and r.ready
                       and not r.draining]
            warming = sum(1 for r in reps
                          if r.state == LIVE and not r.ready)
            draining = [r for r in reps if r.state == LIVE and r.draining]
        for rep in draining:
            self._finish_drain(rep)
        with self._qlock:
            qdepth = len(self._queue)
            pressured = self._queue.pressured(
                float(self.fcfg.autoscale.pressure_s), now)
        active = sum(len(r.inflight) for r in serving)
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
        """Append a NEW replica slot — the replica list, the epoch fence
        table, and ``n_replicas`` (the hello-bound check) grow together
        under the list lock — and spawn its worker, which warms itself
        before saying ready (scaled-up capacity never serves cold). A
        ``serve.scale_up`` crash rolls the slot back and records
        ``up_failed``: a failed spawn leaves the fleet exactly as it
        was, and the policy's cooldown still debounces the retry."""
        with self._lock:
            idx = len(self._replicas)
            rep = _Proc(idx)
            self._replicas.append(rep)
            self._epochs.append(0)
            self.n_replicas += 1
        event = ScaleEvent(action=SCALE_UP, replica=idx, reason=reason,
                           ts=time.monotonic(), queue=obs.queue_depth,
                           live=obs.live)
        try:
            chaos.failpoint("serve.scale_up", key=str(idx))
            self._spawn(rep)
        except Exception as e:
            with self._lock:
                if self._replicas and self._replicas[-1] is rep:
                    self._replicas.pop()
                    self._epochs.pop()
                    self.n_replicas -= 1
            event.action = "up_failed"
            event.error = repr(e)
            self.scale_events.append(event)
            self._stamp_autoscaler(force=True)
            logger.warning("fleet: scale-up of replica process %d "
                           "failed: %s", idx, e)
            return
        self._bump("scale_ups")
        self.scale_events.append(event)
        self._stamp_autoscaler(force=True)
        logger.warning("fleet: scaled UP to replica process %d (%s)",
                       idx, reason)

    def _scale_down(self, reason: str, obs: Observation) -> None:
        """Start draining the NEWEST serving replica (LIFO keeps the
        original fleet's indices stable): dispatch skips it from now on,
        its in-flight lanes finish, and ``_finish_drain`` retires the
        process. The event is recorded at initiation (``drained_ts``
        lands at completion) so `dstpu health` shows the drain in
        flight."""
        with self._lock:
            cands = [r for r in self._replicas if r.state == LIVE
                     and r.ready and not r.draining]
        if len(cands) <= self.autoscale.min_replicas:
            return
        rep = max(cands, key=lambda r: r.idx)
        rep.draining = True
        self.scale_events.append(ScaleEvent(
            action=SCALE_DOWN, replica=rep.idx, reason=reason,
            ts=time.monotonic(), queue=obs.queue_depth, live=obs.live))
        self._stamp_autoscaler(force=True)
        logger.warning("fleet: scaling DOWN replica process %d (%s) — "
                       "draining", rep.idx, reason)

    def _finish_drain(self, rep: _Proc) -> None:
        """Retire a draining replica once its lanes emptied: flip to
        RETIRED *before* sending the stop command — the poll's
        process-exit check skips non-LIVE replicas, so the worker's
        clean rc-0 exit reads as the conclusion it is, not a death. The
        worker stamps its own EXIT terminal on the way out; the epoch
        bump fences any frame its dying connection still emits. A
        draining replica that DIES instead goes through
        ``_replica_down`` (exactly-once requeue, action 'retired')."""
        if rep.inflight:
            return
        with self._lock:
            if rep.state != LIVE or not rep.draining:
                return
            if rep.inflight:
                return
            rep.state = RETIRED
            rep.retired_ts = time.monotonic()
            self._epochs[rep.idx] += 1
            conn, rep.conn = rep.conn, None
        if conn is not None:
            try:
                conn.send({"cmd": "stop"})
            except OSError:
                pass                    # redial lands on the stop answer
            conn.close()
        self._note_drained(rep, clean=True)
        logger.warning("fleet: replica process %d RETIRED (drain "
                       "complete)", rep.idx)

    def _note_drained(self, rep: _Proc, clean: bool) -> None:
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
        poll (never reads as silent while supervised), forced on every
        scale event — `dstpu health` shows the last verdict alongside
        the replica processes it acted on."""
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
        """Deadline-pressured latency admission, process placement: when
        a latency-tier request is queued within ``preempt_pressure_s``
        of its deadline and no serving replica has a free lane, tell the
        youngest batch-tier victim's worker to ``cancel`` the lane and
        requeue the victim hub-side. Exactly-once holds by the existing
        ledger arithmetic: every prog frame already synced the emitted
        prefix cumulatively, frames the dying leg still sends before the
        cancel lands only extend that prefix idempotently, and once the
        victim is requeued (``replica = None``) the stale-frame guard in
        ``_apply_tokens`` drops anything late. ``serve.preempt`` fires
        between the lane eviction and the requeue: a crash there parks
        the victim on the orphan list — deferred, never lost. At most
        one eviction per poll bounds the churn."""
        window = float(self.fcfg.preempt_pressure_s)
        if window <= 0:
            return
        now = time.monotonic()
        with self._qlock:
            pressured = next(
                (r for r in self._queue
                 if r.priority == LATENCY and r.deadline_ts is not None
                 and 0.0 <= (r.deadline_ts - now) < window), None)
        if pressured is None:
            return
        cap = int(self.scfg.max_batch)
        with self._lock:
            reps = [r for r in self._replicas
                    if r.state == LIVE and r.ready and not r.draining
                    and r.conn is not None]
        if any(len(r.inflight) < cap for r in reps):
            return                       # a free lane will serve it
        victim_rep, victim = None, None
        for rep in reps:
            for req in rep.inflight.values():
                if req.priority == BATCH and not req.done \
                        and (victim is None
                             or req.arrival_ts > victim.arrival_ts):
                    victim_rep, victim = rep, req
        if victim is None:
            return
        with self._lock:
            conn = victim_rep.conn
        try:
            if conn is None:
                raise OSError("no connection")
            conn.send({"cmd": "cancel", "rid": victim.rid})
        except OSError:
            return                       # link down: the poll verdict owns it
        victim_rep.inflight.pop(victim.rid, None)
        victim.preemptions += 1
        self._bump("preempted")
        logger.warning(
            "fleet: preempting batch request %d on replica process %d "
            "for pressured latency request %d", victim.rid,
            victim_rep.idx, pressured.rid)
        try:
            chaos.failpoint("serve.preempt")
        except chaos.ChaosError as e:
            logger.warning(
                "fleet: preemption requeue of request %d failed (%s) — "
                "orphaned for retry", victim.rid, e)
            with self._qlock:
                self._orphans.append(victim)
            return
        self._requeue(victim, charge_retry=False)

    # --------------------------------------------------------------- dispatch

    def _dispatch_all(self) -> None:
        with self._lock:
            reps = [r for r in self._replicas
                    if r.state == LIVE and r.ready and not r.draining
                    and r.conn is not None]
        cap = int(self.scfg.max_batch)
        for rep in reps:
            while len(rep.inflight) < cap:
                with self._qlock:
                    req = self._queue.popnext()
                if req is None:
                    break
                if req.done:
                    continue
                if req.expired():
                    self._conclude(req, TIMEOUT,
                                   "deadline exceeded while queued")
                    continue
                dl = (max(req.deadline_ts - time.monotonic(), 0.0)
                      if req.deadline_ts is not None else None)
                frame = {"cmd": "serve", "rid": req.rid,
                         "prompt": req.prompt,
                         "max_new_tokens": req.max_new_tokens,
                         "emitted": list(req.output_tokens),
                         "temperature": req.temperature,
                         "eos": req.eos_token_id, "deadline_s": dl}
                with self._lock:
                    conn = rep.conn
                try:
                    if conn is None:
                        raise OSError("no connection")
                    conn.send(frame)
                except OSError:
                    # never delivered: back on the HEAD, not a retry.
                    # The link is down — the worker redials or the next
                    # poll's verdict lands; either way stop pushing.
                    with self._qlock:
                        self._queue.appendleft(req)
                    with self._lock:
                        if rep.conn is conn:
                            rep.conn = None
                    break
                req.replica, req.state = rep.idx, RUNNING
                rep.inflight[req.rid] = req

    # ------------------------------------------------------------------ misc

    def _conclude(self, req: FleetRequest, state: str,
                  error: Optional[str] = None) -> None:
        if not req._finish(state, error):
            return
        with self._qlock:
            self._outstanding.pop(req.rid, None)
        self._bump({FINISHED: "completed", FAILED: "failed",
                    TIMEOUT: "timeout", SHED: "shed"}[state])

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + n


def make_fleet(cfg, params: PyTree, serving=None, **kw):
    """Placement-dispatching fleet constructor: ``serving.fleet.
    placement`` picks :class:`~.fleet.ServingFleet` (threads, the
    default) or :class:`ProcessFleet` (supervised OS processes). Both
    expose the same serving surface."""
    from ..config.config import ServingConfig
    from .fleet import ServingFleet
    if serving is None:
        serving = ServingConfig()
    elif isinstance(serving, dict):
        serving = ServingConfig(**serving)
    placement = str(serving.fleet.placement)
    if placement == "process":
        return ProcessFleet(cfg, params, serving=serving, **kw)
    if placement != "thread":
        raise ValueError(
            f"serving.fleet.placement {placement!r}: expected 'thread' "
            "or 'process'")
    return ServingFleet(cfg, params, serving=serving, **kw)
