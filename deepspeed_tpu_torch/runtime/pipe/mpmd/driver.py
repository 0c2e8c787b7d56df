"""MPMD stage supervisor — spawn, route, and single-stage restart
(counterpart of ``deepspeed_tpu/runtime/pipe/mpmd/driver.py``, ported near
verbatim: it supervises processes and routes frames, and knows nothing of
the framework the stages run).

The launcher-side half of the MPMD pipeline's elasticity story. Where
RunSupervisor (launcher/supervisor.py) tears the WORLD down on first
failure — correct for an SPMD program whose ranks are one failure
domain — stages of an MPMD pipeline are independent programs, so the
right response to a dead stage is to restart THAT stage and park the
rest. This supervisor:

* spawns one ``stage_worker`` process per stage (per-stage argv/env via
  :class:`StageWorkerSpec` — chaos specs ride the env exactly like the
  launcher's DSTPU_* forwarding);
* owns the transfer star: every worker holds ONE TCP connection here,
  and a router thread forwards data frames stage→stage — a restarted
  stage simply reconnects, no peer rewiring (the host-bounce
  topology);
* supervises through the EXISTING substrate: worker rc's follow the
  0/114/117/118 contract (114 restarts uncounted, 117/crash restarts
  counted against ``max_restarts``, 118 aborts the world), and the
  per-stage heartbeat channel (STAGE gauge) is shared with
  ``dstpu health``;
* on a counted death runs the park/resync protocol: survivors park (in
  place — their processes, compiles, and connections survive), the dead
  stage restarts and restores its newest durable tag, then every stage
  resyncs to that step and training replays from there — each
  microbatch applied exactly once (tests/test_mpmd.py pins the loss
  trajectory against an uninjected twin).

Exit code: 0 when every stage finishes; otherwise the triggering rc
aggregated RunSupervisor-style (integrity 118 > voluntary crash rc >
stall 117 > preemption 114).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from ....exit_codes import INTEGRITY_EXIT_CODE, PREEMPTION_EXIT_CODE
from ...fabric import HubConn, read_frame
from ...watchdog import STALL_EXIT_CODE


class StageWorkerSpec:
    """Per-stage launch description: extra argv appended to the common
    worker command and env overlaid on the inherited environment.
    ``env_first`` applies ONLY to the initial spawn, not to restarts —
    a one-shot chaos spec must not re-arm in the restarted process
    (fresh processes re-read DSTPU_CHAOS with fresh hit counters)."""

    def __init__(self, extra_argv: Optional[Sequence[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 env_first: Optional[Dict[str, str]] = None):
        self.extra_argv = list(extra_argv or [])
        self.env = dict(env or {})
        self.env_first = dict(env_first or {})
        self._spawned = False


class _StageConn(HubConn):
    """Hub-side stage connection — the fabric :class:`HubConn` (bounded
    write lock: a peer wedged mid-read starves later senders into the
    OSError a dead peer raises anyway) plus the stage's resume step."""

    def __init__(self, sock: socket.socket, resume_step: int):
        super().__init__(sock)
        self.resume_step = resume_step


class MPMDStageSupervisor:
    """See module docstring. ``worker_argv_base`` is the common command
    prefix (without --stage/--driver-port); the supervisor appends
    per-stage arguments and its own port."""

    def __init__(self, pp: int, *,
                 workdir: str,
                 steps: int,
                 n_micro: int = 4,
                 schedule: str = "1f1b",
                 specs: Optional[List[StageWorkerSpec]] = None,
                 worker_argv_base: Optional[List[str]] = None,
                 max_restarts: int = 2,
                 grace_secs: float = 5.0,
                 park_ack_timeout: float = 20.0,
                 restart_timeout: float = 60.0,
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout: float = 0.0,
                 log_dir: Optional[str] = None,
                 worker_args: Optional[List[str]] = None):
        self.pp = pp
        self.workdir = workdir
        self.steps = steps
        self.n_micro = n_micro
        self.schedule = schedule
        self.specs = specs or [StageWorkerSpec() for _ in range(pp)]
        if len(self.specs) != pp:
            raise ValueError(f"{len(self.specs)} specs for pp={pp}")
        self.max_restarts = max_restarts
        self.grace_secs = grace_secs
        self.park_ack_timeout = park_ack_timeout
        self.restart_timeout = restart_timeout
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_timeout = heartbeat_timeout
        self.log_dir = log_dir
        self.worker_args = list(worker_args or [])
        #: None = the default -c bootstrap (sys.path injection); a custom
        #: base argv replaces the whole command prefix
        self._base = worker_argv_base
        self.procs: List[Optional[subprocess.Popen]] = [None] * pp
        self.conns: Dict[int, _StageConn] = {}
        self.restarts = [0] * pp
        self.preemptions = [0] * pp
        self.generation = 0
        self.parked: set = set()
        self.done: set = set()
        # frames for a stage that has not connected yet (a fast upstream
        # stage's first activations can beat its peer's dial): delivered
        # on its hello; a restart's generation fences any stale ones
        self._backlog: Dict[int, List[tuple]] = {}
        # the stage a recovery restarts: its hello triggers the resync
        # (see _serve_conn), and _resynced says it went out
        self._recovering: Optional[int] = None
        self._resynced = threading.Event()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._server: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._logs: List[Optional[object]] = [None] * pp

    # -------------------------------------------------------------- plumbing

    def _worker_cmd(self, stage: int) -> List[str]:
        ckpt = os.path.join(self.workdir, f"stage{stage}")
        argv = [
            "--stage", str(stage), "--pp", str(self.pp),
            "--n-micro", str(self.n_micro), "--steps", str(self.steps),
            "--schedule", self.schedule,
            "--driver-port", str(self.port),
            "--ckpt-dir", ckpt,
        ] + self.worker_args + self.specs[stage].extra_argv
        if self._base is not None:
            return self._base + argv
        # the worker imports this package whatever the supervisor's cwd
        import deepspeed_tpu_torch
        pkg_root = os.path.dirname(os.path.dirname(
            deepspeed_tpu_torch.__file__))
        boot = ("import sys; sys.path.insert(0, {root!r}); "
                "from deepspeed_tpu_torch.runtime.pipe.mpmd.stage_worker "
                "import main; raise SystemExit(main({argv!r}))").format(
                    root=pkg_root, argv=argv)
        return [sys.executable, "-c", boot]

    def _spawn(self, stage: int) -> None:
        spec = self.specs[stage]
        env = dict(os.environ)
        env.update(spec.env)
        if not spec._spawned:
            env.update(spec.env_first)
            spec._spawned = True
        if self.heartbeat_dir:
            env["DSTPU_HEARTBEAT_DIR"] = self.heartbeat_dir
        out = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            if self._logs[stage] is None:
                self._logs[stage] = open(
                    os.path.join(self.log_dir, f"stage{stage}.log"), "ab")
            out = self._logs[stage]
        self.procs[stage] = subprocess.Popen(
            self._worker_cmd(stage), env=env, stdout=out,
            stderr=subprocess.STDOUT if out else None)

    def _router(self) -> None:
        """Accept stage connections and forward frames. One reader thread
        per connection keeps the star simple; writes serialize per-conn."""
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
        stage = None
        try:
            meta, _ = read_frame(sock)
            if meta.get("cmd") != "hello":
                sock.close()
                return
            stage = int(meta["stage"])
            conn = _StageConn(sock, int(meta.get("resume_step", 0)))
            with self._lock:
                self.conns[stage] = conn
                self.parked.discard(stage)
                gen = self.generation
                held = self._backlog.pop(stage, [])
                resync = self._recovering == stage
            if resync:
                # the survivors learn the new generation BEFORE the
                # joiner's welcome: its first frames (stamped with it)
                # then reach them after the resync on the same ordered
                # connection, never before (where they would be fenced
                # as stale and lost)
                self._broadcast({"cmd": "resync",
                                 "step": int(conn.resume_step), "gen": gen},
                                exclude=stage)
                with self._lock:
                    self.parked.clear()
                    self._recovering = None
                self._resynced.set()
            # hand the joiner the current park/resync generation so its
            # frames are accepted by peers that lived through restarts
            conn.send({"cmd": "welcome", "gen": gen})
            for meta, payload in held:
                conn.send(meta, payload)
            while not self._stop.is_set():
                meta, payload = read_frame(sock)
                if "cmd" in meta:
                    with self._lock:
                        if meta["cmd"] == "parked":
                            self.parked.add(int(meta["stage"]))
                        elif meta["cmd"] == "done":
                            self.done.add(int(meta["stage"]))
                    continue
                dst = int(meta["dst"])
                with self._lock:
                    target = self.conns.get(dst)
                    if target is None and dst not in self.done:
                        self._backlog.setdefault(dst, []).append(
                            (meta, payload))
                if target is not None:
                    try:
                        target.send(meta, payload)
                    except OSError:
                        pass        # dst died; its restart will resync
        except OSError:
            pass                    # reader ends when the peer goes away
        finally:
            if stage is not None:
                with self._lock:
                    if self.conns.get(stage) is not None \
                            and self.conns[stage].sock is sock:
                        del self.conns[stage]

    def _broadcast(self, meta: dict, exclude: Optional[int] = None) -> None:
        with self._lock:
            targets = [c for st, c in self.conns.items() if st != exclude]
        for c in targets:
            try:
                c.send(meta)
            except OSError:
                pass

    # ------------------------------------------------------------------- run

    def start(self) -> "MPMDStageSupervisor":
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", 0))
        self._server.listen(self.pp + 2)
        self.port = self._server.getsockname()[1]
        threading.Thread(target=self._router, daemon=True).start()
        for s in range(self.pp):
            self._spawn(s)
        return self

    def run(self) -> int:
        if self._server is None:
            self.start()
        try:
            return self._run()
        finally:
            self._teardown()

    def _run(self) -> int:
        done_deadline = None
        while True:
            time.sleep(0.05)
            with self._lock:
                all_done = len(self.done) == self.pp
            rcs = [(s, p.poll()) for s, p in enumerate(self.procs)
                   if p is not None]
            exited = {s: rc for s, rc in rcs if rc is not None}
            if all_done:
                # every stage reported done: the run's RESULT is final.
                # Drain process exits (bounded by grace), then return 0
                # even if a worker's post-done teardown died or wedged —
                # hb write / close hiccups must not hang or fail a
                # finished run (_teardown kills any straggler).
                if done_deadline is None:
                    done_deadline = time.monotonic() + self.grace_secs
                if all(p is None or p.poll() is not None
                       for p in self.procs) or \
                        time.monotonic() >= done_deadline:
                    return 0
                continue
            if len(exited) == self.pp and \
                    all(rc == 0 for rc in exited.values()):
                return 0
            dead = [(s, rc) for s, rc in exited.items()
                    if rc != 0 and s not in self.done]
            if not dead:
                self._check_heartbeat_silence()
                continue
            s, rc = dead[0]
            if rc == INTEGRITY_EXIT_CODE:
                return INTEGRITY_EXIT_CODE
            counted = rc != PREEMPTION_EXIT_CODE
            if counted:
                self.restarts[s] += 1
                if self.restarts[s] > self.max_restarts:
                    return STALL_EXIT_CODE if rc == STALL_EXIT_CODE else rc
            else:
                self.preemptions[s] += 1
            if not self._recover(s):
                return STALL_EXIT_CODE

    def _check_heartbeat_silence(self) -> None:
        """A stage whose heartbeat went silent past the deadline is
        wedged-but-alive: kill it so the rc path takes over (the kill
        surfaces as a counted death and the stage restarts)."""
        if not (self.heartbeat_dir and self.heartbeat_timeout > 0):
            return
        from ...heartbeat import stale_ranks
        for rec in stale_ranks(self.heartbeat_dir, self.heartbeat_timeout):
            s = int(rec["rank"])
            p = self.procs[s] if 0 <= s < self.pp else None
            if p is not None and p.poll() is None:
                p.kill()

    def _recover(self, stage: int) -> bool:
        """Park survivors -> restart ``stage`` -> resync everyone to the
        restarted stage's restored step. True on success. The parked set
        is sticky until resync: a survivor still parked from a previous
        (failed) recovery round counts as acked."""
        with self._lock:
            self.conns.pop(stage, None)
            self.generation += 1
        self._broadcast({"cmd": "park"}, exclude=stage)
        live = [s for s in range(self.pp)
                if s != stage and s not in self.done]
        deadline = time.monotonic() + self.park_ack_timeout
        while time.monotonic() < deadline:
            with self._lock:
                if all(s in self.parked for s in live):
                    break
            time.sleep(0.02)
        with self._lock:
            self._recovering = stage
            self._resynced.clear()
        self._spawn(stage)
        deadline = time.monotonic() + self.restart_timeout
        while time.monotonic() < deadline:
            if self._resynced.is_set():
                return True
            if self.procs[stage].poll() is not None:
                # died again before hello: surface the fresh rc to the
                # main loop so the restart budget sees every death
                with self._lock:
                    self._recovering = None
                return True
            time.sleep(0.02)
        with self._lock:
            self._recovering = None
        return False

    def _teardown(self) -> None:
        self._stop.set()
        for p in self.procs:
            if p is not None and p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + self.grace_secs
        for p in self.procs:
            if p is None:
                continue
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            if p.poll() is None:
                p.kill()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        for f in self._logs:
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
