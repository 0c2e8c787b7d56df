"""RunSupervisor — fail-fast supervision of a multi-host launch
(counterpart of ``deepspeed_tpu/launcher/supervisor.py``, ported near
verbatim: it supervises processes and reads the heartbeat channel, and
knows nothing of the framework the ranks run).

The pre-round-4 launcher waited on per-host ssh processes SERIALLY
(runner.py): a crashed host was only noticed after every EARLIER host in
the list exited, a wedged host stalled the whole pod forever (each live
rank sits in a collective waiting for the dead one), and the final
``rc = rc or p.returncode`` folded every exit code into "first nonzero" —
erasing the preemption/crash distinction ``DSElasticAgent`` depends on.

This module supervises all ranks CONCURRENTLY:

- **first failure tears the world down**: any rank exiting nonzero (or a
  preempted/stalled rank) triggers SIGTERM to every other rank, a grace
  deadline for their preemption handlers to checkpoint, then SIGKILL for
  the stragglers. No half-dead worlds burning GPU hours.
- **connect-phase retries**: ssh dispatch that fails BEFORE the remote
  shell started (ssh's own rc 255 under ``-o ConnectTimeout``, or a
  ``launch.ssh`` chaos fault) retries with bounded exponential backoff.
  A rank whose remote shell already started (it printed the
  :data:`STARTED_SENTINEL` line) is NEVER retried — re-dispatching a rank
  that may have run user code would double-run the job.
- **per-host log persistence** (``log_dir``): every rank's prefixed
  output is mirrored to ``<log_dir>/<host>.rank<k>.log`` alongside the
  live prefixed stream (local ranks switch to captured pipes), so the
  post-mortem for a torn-down pod doesn't depend on terminal scrollback.
- **preemption-aware aggregation**: the overall rc is computed from the
  ranks that exited VOLUNTARILY (before teardown signaled them): a
  genuine crash rc wins, else a preemption (``PREEMPTION_EXIT_CODE``,
  114) yields 114 — so "the pod was preempted" survives the launcher and
  the elastic agent resumes without burning its restart budget. A stalled
  rank's ``STALL_EXIT_CODE`` propagates the same way and DOES count as a
  failure.

The supervisor exposes a ``Popen``-like facade (``poll``/``wait``/
``terminate``/``kill``/``returncode``) so ``DSElasticAgent.launch_fn``
can return a started supervisor and the agent's monitor loop supervises
the supervisor itself.

reference counterpart: ``deepspeed/launcher/runner.py``'s pdsh path +
``launch.py``'s terminate_process_tree sweep; concurrency and the rc
contract are the JAX package's additions (one hung rank deadlocks EVERY
collective in a multi-controller job, so liveness is global).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..elasticity.elastic_agent import PREEMPTION_EXIT_CODE
from ..runtime import heartbeat as hb
from ..runtime.sentinel import INTEGRITY_EXIT_CODE
from ..runtime.straggler import HOST_NAMING_FLAGS
from ..runtime.watchdog import STALL_EXIT_CODE
from ..testing import chaos
from ..utils.logging import logger

#: Line a remote shell prints once ssh has connected and the per-host
#: bootstrap is about to exec — the boundary between "connect phase"
#: (retryable) and "ran user code" (never retried).
STARTED_SENTINEL = "DSTPU-RANK-STARTED"

#: ssh reserves 255 for ITS OWN failures (connection refused/timeout,
#: auth); user commands exiting 255 are indistinguishable, which is why
#: the sentinel — not the rc — decides retryability.
SSH_CONNECT_RC = 255


class RankSpec:
    """One supervised rank: where and what to launch.

    ``remote=True`` marks ssh dispatch — connect-phase failures retry and
    stdout is scanned for :data:`STARTED_SENTINEL`. Local ranks are
    "started" by construction (Popen succeeding IS the start).

    ``env``: extra environment for LOCAL ranks (remote ranks carry their
    exports inside the ssh command line) — the .deepspeed_env /
    collect_env_exports entries a loopback host must still receive even
    though no ssh shell injects them."""

    __slots__ = ("host", "cmd", "remote", "env")

    def __init__(self, host: str, cmd: Sequence[str], remote: bool = False,
                 env: Optional[dict] = None):
        self.host = host
        self.cmd = list(cmd)
        self.remote = remote
        self.env = dict(env) if env else None


class _RankStatus:
    __slots__ = ("rc", "signaled", "started", "attempts", "finished_at")

    def __init__(self):
        self.rc: Optional[int] = None
        self.signaled = False       # torn down by the supervisor
        self.started = False        # remote shell reached user code
        self.attempts = 0
        self.finished_at: Optional[float] = None


class HeartbeatMonitor:
    """Launcher-side consumer of the rank heartbeat channel
    (runtime/heartbeat.py). Answers two questions the process/pipe view
    cannot: *which phase* is a silent remote rank actually in, and *has
    it stopped attesting liveness* (process or host dead — in-worker
    phase deadlines handle wedges and stamp terminal records).

    ``expected_ranks``: ranks that MUST eventually write — one that has
    produced no file ``timeout`` seconds after monitoring began counts
    silent too (a blackholed host never says anything at all)."""

    def __init__(self, heartbeat_dir: str, timeout: float,
                 expected_ranks: Optional[Sequence[int]] = None,
                 clock=None):
        self.heartbeat_dir = heartbeat_dir
        self.timeout = float(timeout)
        self.expected = set(int(r) for r in (expected_ranks or ()))
        self._clock = clock or time.time
        self._started = self._clock()

    @property
    def enabled(self) -> bool:
        return bool(self.heartbeat_dir) and self.timeout > 0

    def snapshot(self) -> dict:
        return hb.read_heartbeats(self.heartbeat_dir)

    def silent_ranks(self) -> List[dict]:
        """Ranks that stopped attesting: last record non-terminal and
        older than ``timeout`` (hb.stale_ranks — ONE staleness rule for
        launcher and agent), or expected but never seen."""
        now = self._clock()
        records = self.snapshot()
        out = hb.stale_ranks(self.heartbeat_dir, self.timeout, now,
                             records=records)
        if now - self._started > self.timeout:
            for rank in sorted(self.expected - set(records)):
                out.append({"rank": rank, "host": None, "phase": None,
                            "step": None, "ts": None, "missing": True})
        return out

    def terminal_records(self) -> dict:
        return hb.terminal_records(self.heartbeat_dir)


def _grace_then_kill(proc, grace_secs: float) -> None:
    """Post-SIGTERM escalation shared by both supervisors: poll until the
    grace deadline (the workers' emergency-checkpoint budget), SIGKILL
    whatever is still alive."""
    deadline = time.monotonic() + grace_secs
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.05)
    if proc.poll() is None:
        try:
            proc.kill()
        except OSError:
            pass


class RunSupervisor:
    """Monitor every rank concurrently; tear the world down on first
    failure; aggregate exit codes preemption-aware."""

    def __init__(self,
                 specs: Sequence[RankSpec],
                 grace_secs: float = 30.0,
                 connect_retries: int = 3,
                 connect_backoff: float = 0.5,
                 connect_backoff_max: float = 10.0,
                 popen_fn: Optional[Callable[..., subprocess.Popen]] = None,
                 stream=None,
                 log_dir: Optional[str] = None,
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout: float = 0.0,
                 heartbeat_poll: float = 1.0):
        self.specs = list(specs)
        self.grace_secs = float(grace_secs)
        self.connect_retries = int(connect_retries)
        self.connect_backoff = float(connect_backoff)
        self.connect_backoff_max = float(connect_backoff_max)
        self._popen = popen_fn or subprocess.Popen
        self._stream = stream if stream is not None else sys.stdout
        # per-host log persistence: with log_dir set, every rank's output
        # (local ranks included — they switch to captured pipes) is also
        # written to <log_dir>/<host>.rank<k>.log, truncated on the first
        # dispatch attempt and appended across connect retries, so a
        # post-mortem doesn't depend on scrollback
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        # heartbeat-channel liveness (round 6): with a shared heartbeat
        # dir, ranks whose ssh pipe is silent still attest liveness via
        # per-rank files; a rank that stops attesting (host dead, process
        # blackholed) triggers the same fail-fast teardown as an exit —
        # reported as a STALL so the elastic agent counts it
        self.heartbeat_monitor: Optional[HeartbeatMonitor] = None
        self.heartbeat_poll = float(heartbeat_poll)
        self.heartbeat_dir = heartbeat_dir
        if heartbeat_dir and heartbeat_timeout > 0:
            self.heartbeat_monitor = HeartbeatMonitor(
                heartbeat_dir, heartbeat_timeout,
                expected_ranks=range(len(self.specs)))
        self._hb_stall: Optional[str] = None    # teardown evidence
        self._hb_silent: List[dict] = []        # snapshot AT detection
        self.status = [_RankStatus() for _ in self.specs]
        self._procs: List[Optional[subprocess.Popen]] = [None] * len(self.specs)
        self._lock = threading.Lock()
        self._teardown_started = threading.Event()
        self._done = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False
        self.returncode: Optional[int] = None
        if not self.specs:
            self.returncode = 0
            self._done.set()

    # -------------------------------------------------------------- lifecycle

    def start(self) -> "RunSupervisor":
        if self._started or not self.specs:
            return self
        self._started = True
        if self.heartbeat_dir:
            # the channel is run-scoped: records from a previous attempt
            # in a reused dir must not trip silence at t=0 or leak a
            # prior STALLED verdict into this run's evidence
            hb.clear_channel(self.heartbeat_dir)
        for idx in range(len(self.specs)):
            t = threading.Thread(target=self._monitor_rank, args=(idx,),
                                 name=f"dstpu-rank-{idx}", daemon=True)
            self._threads.append(t)
            t.start()
        if self.heartbeat_monitor is not None:
            t = threading.Thread(target=self._monitor_heartbeats,
                                 name="dstpu-heartbeat-monitor", daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def _monitor_heartbeats(self) -> None:
        while not self._done.wait(self.heartbeat_poll):
            if self._teardown_started.is_set():
                return
            # a rank whose PROCESS already finished is the rank monitor's
            # jurisdiction (its rc decides), not silence: a clean rank
            # that never called engine.close() leaves a frozen
            # non-terminal record, and treating that as a wedge would
            # tear down the still-healthy survivors as rc 117
            silent = [r for r in self.heartbeat_monitor.silent_ranks()
                      if not self._rank_exited(r.get("rank"))]
            if not silent:
                continue
            desc = ", ".join(
                f"rank {r.get('rank')}"
                + (f" ({r['host']})" if r.get("host") else "")
                + (" never wrote" if r.get("missing")
                   else f" silent in {r.get('phase')} at step "
                        f"{r.get('step')}")
                for r in silent)
            # snapshot NOW: after the teardown freezes every rank's
            # record, re-evaluating would implicate the whole world
            with self._lock:
                self._hb_silent = silent
                self._hb_stall = desc
            logger.error("supervisor: heartbeat silence — %s (timeout "
                         "%.1fs); tearing down the world", desc,
                         self.heartbeat_monitor.timeout)
            self._trigger_teardown(f"heartbeat silence: {desc}")
            return

    def _rank_exited(self, rank) -> bool:
        return (isinstance(rank, int) and 0 <= rank < len(self.status)
                and self.status[rank].rc is not None)

    def run(self) -> int:
        """start() + wait(): the non-elastic launcher entry point."""
        return self.start().wait()

    # ----------------------------------------------------- Popen-like facade

    def poll(self) -> Optional[int]:
        return self.returncode if self._done.is_set() else None

    def wait(self, timeout: Optional[float] = None) -> int:
        if not self._done.wait(timeout):
            raise subprocess.TimeoutExpired(cmd="RunSupervisor",
                                            timeout=timeout)
        return self.returncode

    def terminate(self) -> None:
        """External teardown request (elastic agent: membership change)."""
        self._trigger_teardown("terminate() requested")

    def kill(self) -> None:
        with self._lock:
            procs = [p for p in self._procs if p is not None]
            for st, p in zip(self.status, self._procs):
                if p is not None and p.poll() is None:
                    st.signaled = True
        self._teardown_started.set()    # stop pending connect retries
        for p in procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass

    # ---------------------------------------------------------- rank monitor

    def rank_log_path(self, idx: int) -> Optional[str]:
        if not self.log_dir:
            return None
        return os.path.join(self.log_dir,
                            f"{self.specs[idx].host}.rank{idx}.log")

    def _open_rank_log(self, idx: int):
        path = self.rank_log_path(idx)
        if path is None:
            return None
        mode = "w" if self.status[idx].attempts <= 1 else "a"
        try:
            return open(path, mode, encoding="utf-8", errors="replace")
        except OSError as e:
            logger.warning("supervisor: cannot open rank log %s: %s",
                           path, e)
            return None

    def _forward_output(self, idx: int, proc: subprocess.Popen,
                        log=None) -> None:
        """Reader for a rank's merged stdout/stderr: recognizes the
        started sentinel, prefixes every other line with the host, and
        mirrors the prefixed lines into the rank's log file when
        persistence is on."""
        st = self.status[idx]
        host = self.specs[idx].host
        try:
            for line in proc.stdout:
                if STARTED_SENTINEL in line:
                    st.started = True
                    continue
                prefixed = f"[{host}] {line}"
                if log is not None:
                    try:
                        log.write(prefixed)
                        log.flush()
                    except (ValueError, OSError):
                        try:
                            log.close()   # ENOSPC etc: stop logging, but
                        except OSError:   # release the descriptor now
                            pass
                        log = None
                try:
                    self._stream.write(prefixed)
                    self._stream.flush()
                except (ValueError, OSError):
                    pass    # parent stream closed mid-teardown
        finally:
            if log is not None:
                try:
                    log.close()
                except OSError:
                    pass

    def _launch_once(self, idx: int) -> subprocess.Popen:
        spec = self.specs[idx]
        # keyed failpoint: a blackholed host fails EVERY dispatch to it
        # (arm with match=<host>), driving the blacklist/degraded-resume
        # path without touching the other hosts of the world
        chaos.failpoint("host.blackhole", key=spec.host)
        log = self._open_rank_log(idx)
        if spec.remote or log is not None:
            try:
                if spec.remote:
                    # the ssh dispatch failpoint: tests simulate connection
                    # failures deterministically (raise mode == ConnectTimeout)
                    chaos.failpoint("launch.ssh")
                env = {**os.environ, **spec.env} \
                    if (not spec.remote and spec.env) else None
                proc = self._popen(spec.cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True,
                                   env=env)
            except BaseException:
                # connect retries re-open the log per attempt: releasing
                # it here keeps a failing rank from accumulating handles
                if log is not None:
                    try:
                        log.close()
                    except OSError:
                        pass
                raise
            if not spec.remote:
                self.status[idx].started = True
            reader = threading.Thread(target=self._forward_output,
                                      args=(idx, proc, log),
                                      name=f"dstpu-out-{idx}", daemon=True)
            reader.start()
            proc._dstpu_reader = reader
        else:
            env = {**os.environ, **spec.env} if spec.env else None
            proc = self._popen(spec.cmd, env=env)
            self.status[idx].started = True
        return proc

    def _monitor_rank(self, idx: int) -> None:
        spec = self.specs[idx]
        st = self.status[idx]
        attempt = 0
        rc: Optional[int] = None
        while not self._teardown_started.is_set():
            attempt += 1
            st.attempts = attempt
            try:
                proc = self._launch_once(idx)
            except (OSError, chaos.ChaosError) as e:
                rc = SSH_CONNECT_RC
                if self._retry_connect(spec, st, attempt, e):
                    continue
                break
            with self._lock:
                self._procs[idx] = proc
                late_teardown = (self._teardown_started.is_set()
                                 and proc.poll() is None)
                if late_teardown:
                    st.signaled = True
            if late_teardown:
                # this proc registered after _do_teardown's snapshot — it
                # still gets the full SIGTERM -> grace -> SIGKILL contract
                self._term_then_kill(proc)
            rc = proc.wait()
            reader = getattr(proc, "_dstpu_reader", None)
            if reader is not None:
                reader.join(timeout=5)
            with self._lock:
                connect_failed = (spec.remote and not st.started
                                  and not st.signaled
                                  and rc == SSH_CONNECT_RC)
            if connect_failed and self._retry_connect(
                    spec, st, attempt,
                    f"ssh exited {SSH_CONNECT_RC} before the remote shell "
                    "started"):
                with self._lock:
                    self._procs[idx] = None
                continue
            break
        if rc is None or (self._teardown_started.is_set() and not st.started
                          and rc == SSH_CONNECT_RC):
            # the teardown aborted this rank's connect attempts — its 255
            # is an artifact of the abort, not the failure that triggered it
            with self._lock:
                st.signaled = True
        st.rc = SSH_CONNECT_RC if rc is None else rc
        st.finished_at = time.monotonic()
        self._on_rank_exit(idx)

    def _retry_connect(self, spec: RankSpec, st: _RankStatus, attempt: int,
                       why) -> bool:
        """Bounded exponential backoff for CONNECT-phase failures only."""
        if not spec.remote or st.started or attempt > self.connect_retries:
            return False
        delay = min(self.connect_backoff * (2 ** (attempt - 1)),
                    self.connect_backoff_max)
        logger.warning(
            "supervisor: connect to %s failed (%s); retry %d/%d in %.2fs",
            spec.host, why, attempt, self.connect_retries, delay)
        # sleep in slices so a teardown mid-backoff aborts the retry
        deadline = time.monotonic() + delay
        while time.monotonic() < deadline:
            if self._teardown_started.wait(min(0.05, delay)):
                return False
        return not self._teardown_started.is_set()

    # -------------------------------------------------------------- teardown

    def _on_rank_exit(self, idx: int) -> None:
        st = self.status[idx]
        spec = self.specs[idx]
        with self._lock:
            signaled = st.signaled
        if st.rc != 0 and not signaled:
            kind = {PREEMPTION_EXIT_CODE: "preempted"}.get(st.rc, "failed")
            logger.error("supervisor: rank %d (%s) %s with rc=%d — tearing "
                         "down the world", idx, spec.host, kind, st.rc)
            self._trigger_teardown(f"rank {idx} ({spec.host}) rc={st.rc}")
        with self._lock:
            all_done = all(s.rc is not None for s in self.status)
        if all_done and not self._done.is_set():
            self.returncode = self._aggregate()
            self._done.set()

    def _term_then_kill(self, proc: subprocess.Popen) -> None:
        """SIGTERM one process now, SIGKILL it if it outlives the grace
        deadline — the per-proc form of _do_teardown's sweep, for procs
        that registered after the sweep's snapshot."""
        try:
            proc.terminate()
        except OSError:
            return
        threading.Thread(target=_grace_then_kill,
                         args=(proc, self.grace_secs),
                         name="dstpu-late-teardown", daemon=True).start()

    def _trigger_teardown(self, reason: str) -> None:
        with self._lock:
            if self._teardown_started.is_set():
                return
            self._teardown_started.set()
        t = threading.Thread(target=self._do_teardown, args=(reason,),
                             name="dstpu-teardown", daemon=True)
        t.start()

    def _do_teardown(self, reason: str) -> None:
        """SIGTERM the survivors (their preemption handlers get the grace
        window to checkpoint), then SIGKILL whatever outlives it."""
        with self._lock:
            live = []
            for st, p in zip(self.status, self._procs):
                if p is not None and p.poll() is None:
                    st.signaled = True
                    live.append(p)
        if live:
            logger.warning("supervisor: teardown (%s): SIGTERM %d ranks, "
                           "grace %.1fs", reason, len(live), self.grace_secs)
        for p in live:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + self.grace_secs
        while time.monotonic() < deadline:
            if all(p.poll() is not None for p in live):
                return
            time.sleep(0.05)
        for p in live:
            if p.poll() is None:
                logger.error("supervisor: rank outlived the grace deadline "
                             "— SIGKILL")
                try:
                    p.kill()
                except OSError:
                    pass

    # ----------------------------------------------------------- aggregation

    def _aggregate(self) -> int:
        """Overall rc from the VOLUNTARY exits (ranks that finished before
        teardown signaled them): genuine crash > preemption > clean. The
        torn-down remnants' codes (-15/-9, or 114 from their own handlers)
        must not mask what actually happened first."""
        with self._lock:
            voluntary = [st for st in self.status if not st.signaled]
            hb_stall = self._hb_stall
        crashes = [st for st in voluntary
                   if st.rc not in (0, PREEMPTION_EXIT_CODE)]
        if crashes:
            first = min(crashes, key=lambda s: s.finished_at or 0.0)
            return first.rc
        if hb_stall is not None:
            # the teardown was triggered by heartbeat silence, not an
            # exit: every rank is a torn-down remnant, and the honest rc
            # is "wedged" — counted by the elastic agent, like any stall
            return STALL_EXIT_CODE
        if any(st.rc == PREEMPTION_EXIT_CODE for st in voluntary):
            return PREEMPTION_EXIT_CODE
        if all(st.rc == 0 for st in self.status):
            return 0
        # only torn-down ranks are nonzero: an external terminate() (the
        # elastic agent's restart) — surface a preemption if any handler
        # checkpointed, else the first nonzero remnant
        if any(st.rc == PREEMPTION_EXIT_CODE for st in self.status):
            return PREEMPTION_EXIT_CODE
        nonzero = [st.rc for st in self.status if st.rc != 0]
        return nonzero[0] if nonzero else 0

    @property
    def rank_hosts(self) -> List[str]:
        """World-ordered host per rank (one rank per spec) — the elastic
        agent's rank->host recovery indexes THIS, not its own hostfile
        membership, which launch-side --include/--exclude/--num_nodes
        filters may have narrowed further."""
        return [spec.host for spec in self.specs]

    def failed_hosts(self) -> List[str]:
        """Hosts this run has evidence AGAINST — the elastic agent's
        blacklist feed: voluntary nonzero exits (crash/stall rc), remote
        ranks that never got past the connect phase (a blackholed host),
        ranks the heartbeat monitor called silent, and ranks whose record
        carries an integrity flag (a cross-replica SDC audit implicated
        their chips — evidence MORE precise than the exit code, which
        every rank shares when the audit aborts the world)."""
        out = []
        for spec, st in zip(self.specs, self.status):
            # rc 118 exempt: an integrity abort exits EVERY rank with the
            # same code by construction (the audit is collective), so the
            # rc names no host — only the flagged record below does.
            # Striking on the rc would quarantine the whole innocent world
            voluntary_failure = (st.rc not in (None, 0, PREEMPTION_EXIT_CODE,
                                               INTEGRITY_EXIT_CODE)
                                 and not st.signaled)
            never_started = (spec.remote and not st.started
                             and not st.signaled
                             and st.rc == SSH_CONNECT_RC)
            if voluntary_failure or never_started:
                out.append(spec.host)
        if self._hb_stall is not None:
            # the snapshot taken when silence was DETECTED — not a fresh
            # silent_ranks() call: by attribution time the teardown has
            # frozen every survivor's record, and re-evaluating would
            # strike the whole (innocent) world
            for rec in self._hb_silent:
                host = hb.rec_host(rec, self.rank_hosts)
                if host and host not in out:
                    out.append(host)
        if self.heartbeat_dir:
            # host-NAMING flags only — SDC (a chip computing garbage) and
            # STRAGGLER (a host dragging the synchronous step): each is
            # stamped by exactly the implicated rank. The generic
            # INTEGRITY mark (launch.py stamps it on every rank of an
            # rc-118 abort for health visibility) names no host
            for flag in HOST_NAMING_FLAGS:
                for rec in hb.flagged_ranks(self.heartbeat_dir,
                                            flag=flag).values():
                    host = hb.rec_host(rec, self.rank_hosts)
                    if host and host not in out:
                        out.append(host)
        return out


class BackendSupervisor:
    """Supervision for the SCHEDULER-dispatched launchers (pdsh / slurm /
    openmpi / mvapich).

    Those backends fan the world out through ONE scheduler command; the
    launcher sees a single Popen whose pipe says nothing about per-rank
    liveness, whose teardown semantics belong to the scheduler, and whose
    exit code flattens the rc 114/117 contract (``pdsh -S`` returns the
    LARGEST rc, ``srun`` whatever its step policy picks). This class
    restores the three supervision properties the ssh path has had since
    round 4:

    - **per-rank liveness** via the heartbeat channel: a rank that stops
      attesting (host dead, process blackholed) triggers teardown after
      ``heartbeat_timeout`` — through the backend's OWN kill path
      (``kill_cmd``: ``scancel``, ``pdsh -w ... pkill``) first, because
      SIGTERM to the scheduler process alone may orphan remote ranks;
    - **fail-fast teardown** with the same SIGTERM → ``grace_secs`` →
      SIGKILL contract as RunSupervisor (the grace window is the workers'
      emergency-checkpoint budget);
    - **preemption-aware rc reconstruction**: the workers' terminal
      heartbeat records (STALLED / PREEMPTED) overrule the scheduler's
      flattened rc, so ``dstpu --elastic`` treats a preempted slurm world
      exactly like a preempted ssh world (resume, uncounted).

    ``route_line`` (from the backend's MultiNodeRunner) demultiplexes the
    scheduler's merged output — ``pdsh``'s ``host:`` / ``srun --label``'s
    ``rank:`` prefixes — into per-key files under ``log_dir``, mirroring
    the PR-5 ssh-path log persistence.

    Exposes the same Popen-like facade as RunSupervisor (``poll`` /
    ``wait`` / ``terminate`` / ``kill`` / ``returncode``) so
    DSElasticAgent supervises either interchangeably.
    """

    def __init__(self,
                 cmd: Sequence[str],
                 kill_cmd: Optional[Sequence[str]] = None,
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout: float = 0.0,
                 heartbeat_poll: float = 1.0,
                 grace_secs: float = 30.0,
                 popen_fn: Optional[Callable[..., subprocess.Popen]] = None,
                 run_fn: Optional[Callable[..., object]] = None,
                 stream=None,
                 log_dir: Optional[str] = None,
                 route_line: Optional[Callable[[str],
                                              Optional[tuple]]] = None,
                 backend: str = "backend",
                 rank_hosts: Optional[Sequence[str]] = None):
        self.cmd = list(cmd)
        # hostfile-ordered host per rank: lets silence/stall evidence be
        # attributed even for a rank that NEVER wrote a record (node dead
        # before launch.py ran — there is no self-reported host to read)
        self.rank_hosts = list(rank_hosts) if rank_hosts else []
        self.kill_cmd = list(kill_cmd) if kill_cmd else None
        self.grace_secs = float(grace_secs)
        self.heartbeat_poll = float(heartbeat_poll)
        self.backend = backend
        self._popen = popen_fn or subprocess.Popen
        self._run_cmd = run_fn or subprocess.run
        self._stream = stream if stream is not None else sys.stdout
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self.route_line = route_line
        self.heartbeat_monitor: Optional[HeartbeatMonitor] = None
        if heartbeat_dir and heartbeat_timeout > 0:
            # expected_ranks closes the never-wrote blind spot: a host
            # dead BEFORE launch.py runs produces no record at all, and
            # without the expectation the launch would hang unsupervised
            self.heartbeat_monitor = HeartbeatMonitor(
                heartbeat_dir, heartbeat_timeout,
                expected_ranks=(range(len(self.rank_hosts))
                                if self.rank_hosts else None))
        self._heartbeat_dir = heartbeat_dir
        self._hb_stall: Optional[str] = None
        self._silent_hosts: List[str] = []
        self._proc: Optional[subprocess.Popen] = None
        self._done = threading.Event()
        self._teardown_started = threading.Event()
        self._started = False
        self.returncode: Optional[int] = None

    # -------------------------------------------------------------- lifecycle

    def start(self) -> "BackendSupervisor":
        if self._started:
            return self
        self._started = True
        if self._heartbeat_dir:
            # run-scoped channel: a prior attempt's STALLED record in a
            # reused dir must not reconstruct THIS run's clean rc as 117,
            # and its stale records must not trip silence at t=0
            hb.clear_channel(self._heartbeat_dir)
        capture = bool(self.log_dir) or self._stream is not sys.stdout
        if capture:
            self._proc = self._popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
            threading.Thread(target=self._forward_output,
                             name="dstpu-backend-out", daemon=True).start()
        else:
            self._proc = self._popen(self.cmd)
        threading.Thread(target=self._monitor, name="dstpu-backend-monitor",
                         daemon=True).start()
        return self

    def run(self) -> int:
        return self.start().wait()

    # ----------------------------------------------------- Popen-like facade

    def poll(self) -> Optional[int]:
        return self.returncode if self._done.is_set() else None

    def wait(self, timeout: Optional[float] = None) -> int:
        if not self._done.wait(timeout):
            raise subprocess.TimeoutExpired(cmd="BackendSupervisor",
                                            timeout=timeout)
        return self.returncode

    def terminate(self) -> None:
        self._trigger_teardown("terminate() requested")

    def kill(self) -> None:
        self._teardown_started.set()
        p = self._proc
        if p is not None and p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass

    def _rank_host(self, rec: dict) -> Optional[str]:
        """A record's host, falling back to the hostfile-ordered mapping
        for ranks that never self-reported one (shared helper — see
        heartbeat.rec_host)."""
        return hb.rec_host(rec, self.rank_hosts)

    def failed_hosts(self) -> List[str]:
        """Blacklist feed: hosts whose ranks went heartbeat-silent,
        stamped a STALLED terminal record, or carry a host-naming flag —
        SDC (the audit's per-host attribution) or STRAGGLER (the
        relative-slowness detector's): the scheduler's flattened rc can
        name neither the bad chip nor the slow host; the flagged record
        can."""
        out = list(self._silent_hosts)
        if self._heartbeat_dir:
            for rec in hb.terminal_records(self._heartbeat_dir).values():
                if rec.get("phase") == hb.PHASE_STALLED:
                    host = self._rank_host(rec)
                    if host and host not in out:
                        out.append(host)
            for flag in HOST_NAMING_FLAGS:
                for rec in hb.flagged_ranks(self._heartbeat_dir,
                                            flag=flag).values():
                    host = self._rank_host(rec)
                    if host and host not in out:
                        out.append(host)
        return out

    # -------------------------------------------------------------- internals

    def _log_path(self, key: str) -> str:
        return os.path.join(self.log_dir, f"{key}.log")

    def _forward_output(self) -> None:
        """Mirror the scheduler's merged stream, demultiplexing per-rank
        prefixes into per-key files when log persistence is on."""
        logs = {}
        try:
            for line in self._proc.stdout:
                try:
                    self._stream.write(line)
                    self._stream.flush()
                except (ValueError, OSError):
                    pass
                if not self.log_dir:
                    continue
                key, payload = self.backend, line
                if self.route_line is not None:
                    routed = self.route_line(line)
                    if routed is not None:
                        key, payload = routed
                log = logs.get(key)
                if log is None:
                    try:
                        log = open(self._log_path(key), "w",
                                   encoding="utf-8", errors="replace")
                    except OSError as e:
                        logger.warning("backend supervisor: cannot open "
                                       "%s: %s", self._log_path(key), e)
                        log = False      # do not retry every line
                    logs[key] = log
                if log:
                    try:
                        log.write(payload)
                        log.flush()
                    except (ValueError, OSError):
                        try:
                            log.close()
                        except OSError:
                            pass
                        logs[key] = False
        finally:
            for log in logs.values():
                if log:
                    try:
                        log.close()
                    except OSError:
                        pass

    def _monitor(self) -> None:
        while True:
            rc = self._proc.poll()
            if rc is not None:
                break
            if (self.heartbeat_monitor is not None
                    and not self._teardown_started.is_set()):
                silent = self.heartbeat_monitor.silent_ranks()
                if silent:
                    desc = ", ".join(
                        f"rank {r.get('rank')}"
                        + (f" ({r['host']})" if r.get("host") else "")
                        for r in silent)
                    self._hb_stall = desc
                    self._silent_hosts = [
                        h for h in (self._rank_host(r) for r in silent)
                        if h]
                    logger.error(
                        "backend supervisor (%s): heartbeat silence — %s "
                        "(timeout %.1fs); tearing the launch down via the "
                        "scheduler kill path", self.backend, desc,
                        self.heartbeat_monitor.timeout)
                    self._trigger_teardown(f"heartbeat silence: {desc}")
            if self._done.wait(self.heartbeat_poll):
                return
        self.returncode = self._reconstruct_rc(rc)
        self._done.set()

    def _trigger_teardown(self, reason: str) -> None:
        if self._teardown_started.is_set():
            return
        self._teardown_started.set()
        threading.Thread(target=self._do_teardown, args=(reason,),
                         name="dstpu-backend-teardown", daemon=True).start()

    def _do_teardown(self, reason: str) -> None:
        """The scheduler's own kill path first (it reaches the REMOTE
        ranks; signaling the local scheduler proc alone may orphan them),
        then SIGTERM → grace → SIGKILL on the scheduler process itself."""
        logger.warning("backend supervisor (%s): teardown (%s), grace %.1fs",
                       self.backend, reason, self.grace_secs)
        if self.kill_cmd:
            try:
                # bounded SHORT of grace_secs: the kill command is a
                # scheduler CLI call that works in seconds or not at all,
                # and it runs BEFORE the grace wait — an unbounded (or
                # grace-sized) hang here would stretch total teardown to
                # ~2x grace and blow past the elastic agent's
                # teardown_grace budget, SIGKILLing mid-emergency-save
                self._run_cmd(self.kill_cmd,
                              timeout=max(1.0, min(self.grace_secs, 5.0)))
            except (OSError, subprocess.SubprocessError) as e:
                logger.warning("backend supervisor: kill command failed: %s",
                               e)
        p = self._proc
        if p is None:
            return
        try:
            p.terminate()
        except OSError:
            return
        _grace_then_kill(p, self.grace_secs)

    def _reconstruct_rc(self, scheduler_rc: int) -> int:
        """The scheduler flattened the per-rank rcs; the workers' terminal
        heartbeat records carry what actually happened. Stall evidence
        (incl. a silence-triggered teardown) wins — a wedge is a counted
        failure; then preemption; then the scheduler's own verdict."""
        terminal = (hb.terminal_records(self._heartbeat_dir)
                    if self._heartbeat_dir else {})
        phases = {rec.get("phase") for rec in terminal.values()}
        if self._hb_stall is not None or hb.PHASE_STALLED in phases:
            return STALL_EXIT_CODE
        if scheduler_rc == 0:
            return 0
        if scheduler_rc in (PREEMPTION_EXIT_CODE, STALL_EXIT_CODE):
            return scheduler_rc       # the contract survived the backend
        if hb.PHASE_PREEMPTED in phases:
            return PREEMPTION_EXIT_CODE
        return scheduler_rc
