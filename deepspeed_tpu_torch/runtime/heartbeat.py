"""Rank heartbeat channel — per-rank liveness records on a shared directory
(counterpart of ``deepspeed_tpu/runtime/heartbeat.py``: the same record
schema, phases and file layout, so either package's ``dstpu health``
reader reads the other's records).

The run-supervision stack can see a rank *exit* (RunSupervisor) and
a rank *stop stepping* (StallWatchdog), but both signals have blind spots:
a rank wedged BEFORE its first completed step never arms the step
watchdog, and the pdsh/slurm/openmpi backends hide every rank behind one
scheduler process whose pipe stays silent while the pod hangs. This
module is the third signal: every rank periodically appends a small JSON
record describing *where it is* to a per-rank file under a shared
``--heartbeat-dir``; launcher-side consumers (``HeartbeatMonitor`` /
``BackendSupervisor`` in launcher/supervisor.py, ``dstpu health``) read
the records to tell "slow compile" from "wedged" without any worker
cooperation beyond the writes.

Record schema (one JSON object per line, newest last)::

    {"rank": 3, "host": "worker-3", "pid": 4711,
     "phase": "STEP", "step": 120, "ts": 1754200000.0}

Records may carry an optional ``gauges`` sub-dict of small phase-specific
load counters (the SERVE phase stamps ``{"queue": …, "active": …,
"lanes": …}``) and a sticky ``flags`` list (integrity evidence).

Design constraints:

- **Crash-evidence quality.** The file is rewritten via tmp + atomic
  ``os.replace`` so a reader never sees a torn record, and the last
  record survives the writer's death — it IS the post-mortem ("rank 3
  died in RESTORE at step 0").
- **Bounded.** Only the newest ``keep_records`` records are retained;
  a month-long run cannot grow the file.
- **Harmless.** A heartbeat is diagnostics: any ``OSError`` (full disk,
  dead NFS — or the ``hb.write`` chaos failpoint simulating either) is
  swallowed after a warning. Losing the signal degrades supervision to
  exit-only supervision; it must never kill a healthy rank.
- **Throttled.** Same-phase writes within ``min_interval`` seconds are
  dropped so a fast step loop doesn't turn the shared filesystem into a
  hot path. Phase TRANSITIONS always write.

Terminal phases: a rank that exits through a supervised path stamps WHY
as its final record — ``STALLED`` (watchdog rc 117), ``PREEMPTED``
(SIGTERM handler, rc 114), ``EXIT`` (clean close). Backend supervisors
use these to keep the rc 114/117 contract on launchers whose scheduler
flattens exit codes (docs/RESILIENCE.md).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..testing import chaos
from ..utils.logging import logger

# Lifecycle phases, in nominal order. INIT covers process bootstrap
# (the process group rendezvous); RESTORE a checkpoint load; COMPILE the
# window between the first train_batch entry and the first completed
# step (XLA compile + sharded-restore materialization); STEP the steady
# state; SAVE a checkpoint write.
PHASE_INIT = "INIT"
PHASE_RESTORE = "RESTORE"
PHASE_COMPILE = "COMPILE"
PHASE_STEP = "STEP"
PHASE_SAVE = "SAVE"
#: the serving loop's steady state: one record per loop
#: iteration cadence — the serving analog of STEP, so the watchdog /
#: health stack supervises a long-lived server the way it supervises
#: training (serving/engine.py stamps it; watchdog.serve_timeout bounds it)
PHASE_SERVE = "SERVE"
#: terminal phases — the final record of a rank that died supervised
PHASE_STALLED = "STALLED"
PHASE_PREEMPTED = "PREEMPTED"
PHASE_EXIT = "EXIT"

PHASES = (PHASE_INIT, PHASE_RESTORE, PHASE_COMPILE, PHASE_STEP, PHASE_SAVE,
          PHASE_SERVE)
TERMINAL_PHASES = (PHASE_STALLED, PHASE_PREEMPTED, PHASE_EXIT)

#: env var carrying the shared heartbeat directory to every worker
#: (dstpu --heartbeat-dir exports it; the DSTPU_ prefix already forwards)
HEARTBEAT_DIR_ENV = "DSTPU_HEARTBEAT_DIR"

#: env var carrying THIS rank's hostfile-vocabulary host name.
#: launch.py sets it (per worker process, from world_info) so records
#: name hosts the way the OPERATOR's hostfile does — the elastic agent's
#: blacklist and the supervisors' attribution compare against hostfile
#: members, and ``socket.gethostname()`` (FQDN, or an alias the hostfile
#: never uses) would silently never match.
HEARTBEAT_HOST_ENV = "DSTPU_HEARTBEAT_HOST"

#: env var overriding THIS worker's channel rank. Normally the rank is
#: the caller's process rank, but a worker running OUTSIDE a
#: process group (a chaos child sharing a channel with siblings,
#: a single-process twin in a multi-worker test rig) reads process index
#: 0 — every sibling would fight over rank0.hb. The launcher-side
#: consumers only care that records land in distinct per-rank files.
HEARTBEAT_RANK_ENV = "DSTPU_HEARTBEAT_RANK"

_SUFFIX = ".hb"


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank{int(rank)}{_SUFFIX}")


class HeartbeatWriter:
    """One rank's liveness reporter. See module docstring for contract.

    A background *refresher* thread re-stamps the newest record's ``ts``
    every ``refresh_interval`` seconds while the phase is non-terminal:
    the main thread is BLOCKED inside a long kernel build or first
    launch (and inside a collective during a wedge), so without the refresher every
    slow phase would read as launcher-side silence. With it, silence
    means "process or host dead" — phase *progress* is the in-worker
    watchdog's jurisdiction, which stamps a terminal ``STALLED`` record
    when it shoots a wedge. ``refresh_interval=0`` disables the thread
    (tests that need records to go stale on command)."""

    def __init__(self, directory: str, rank: int, host: Optional[str] = None,
                 min_interval: float = 1.0, keep_records: int = 50,
                 refresh_interval: float = 15.0, clock=None):
        self.directory = directory
        self.rank = int(rank)
        self.host = host or _hostname()
        self.min_interval = float(min_interval)
        self.refresh_interval = float(refresh_interval)
        self._records: deque = deque(maxlen=max(1, int(keep_records)))
        self._flags: List[str] = []     # sticky marks (e.g. "SDC"), carried
        #                                 by every subsequent record
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._refresher: Optional[threading.Thread] = None
        self._last_write = 0.0
        self._last_phase: Optional[str] = None
        self._warned = False
        try:
            os.makedirs(directory, exist_ok=True)
        except OSError as e:
            self._warn(e)

    @classmethod
    def from_env(cls, rank: int, host: Optional[str] = None
                 ) -> Optional["HeartbeatWriter"]:
        """A writer iff the launcher exported a heartbeat dir, else None
        (the channel is opt-in: it needs a filesystem every host shares).

        If launch.py registered a process-level writer for this rank
        (:func:`set_process_writer`), that writer is ADOPTED instead of
        creating a second one: two live refreshers would fight over the
        rank file, and closing the first would leave the record
        unrefreshed through the user script's import/setup window.

        ``DSTPU_HEARTBEAT_RANK`` overrides ``rank`` (see
        :data:`HEARTBEAT_RANK_ENV`: workers outside a process group all
        read rank 0)."""
        env_rank = os.environ.get(HEARTBEAT_RANK_ENV, "")
        if env_rank:
            try:
                rank = int(env_rank)
            except ValueError:
                logger.warning("heartbeat: ignoring non-integer %s=%r",
                               HEARTBEAT_RANK_ENV, env_rank)
        existing = _process_writer
        if existing is not None and existing.rank == int(rank):
            return existing
        directory = os.environ.get(HEARTBEAT_DIR_ENV, "")
        if not directory:
            return None
        return cls(directory, rank, host=host)

    @property
    def path(self) -> str:
        return heartbeat_path(self.directory, self.rank)

    def write(self, phase: str, step: int, force: bool = False,
              lock_timeout: Optional[float] = None,
              extra: Optional[dict] = None) -> bool:
        """Record {rank, host, phase, step, ts}. Returns True if a record
        was actually written (False = throttled or swallowed failure).

        ``extra`` carries small phase-specific gauges under a ``gauges``
        sub-dict (the serving loop's queue-depth / active-lane
        counts), so ``dstpu health`` can show LOAD as well as liveness —
        namespaced so a gauge can never shadow a schema key.

        Exit paths (the watchdog's rc-117 fire, the preemption signal
        handler) must pass ``lock_timeout``: the writer lock may be held
        by a refresher wedged in dead-storage I/O — or, under a signal
        handler, by the very write frame the signal interrupted on this
        same thread — and an exit path that blocks forever on a
        diagnostics lock defeats the exit it exists to report. On
        timeout the record is dropped (the process is dying anyway;
        silence or the scheduler rc carries the verdict)."""
        if lock_timeout is None:
            # unbounded by design for steady-state callers (the refresher
            # thread, per-step writes); exit paths pass lock_timeout
            self._lock.acquire()
        elif not self._lock.acquire(timeout=lock_timeout):
            if phase in TERMINAL_PHASES:
                self._stop.set()
            return False
        try:
            now = self._clock()
            if (not force and phase == self._last_phase
                    and now - self._last_write < self.min_interval):
                return False
            rec = {"rank": self.rank, "host": self.host, "pid": os.getpid(),
                   "phase": phase, "step": int(step), "ts": now}
            if extra:
                rec["gauges"] = {str(k): v for k, v in extra.items()}
            if self._flags:
                rec["flags"] = list(self._flags)
            self._records.append(rec)
            transition = phase != self._last_phase
            self._last_phase = phase
            ok = self._flush(durable=transition or phase in TERMINAL_PHASES)
            if ok:
                self._last_write = now
        finally:
            self._lock.release()
        if phase in TERMINAL_PHASES:
            self._stop.set()            # the final word needs no refresh
        elif self.refresh_interval > 0:
            self._ensure_refresher()
        return ok

    def close(self) -> None:
        self._stop.set()

    def add_flag(self, flag: str, step: int = 0,
                 lock_timeout: Optional[float] = None) -> bool:
        """Stamp a STICKY mark (e.g. ``SDC``) onto this rank's record:
        the flag rides every record written from now on, so launcher-side
        consumers (supervisor/agent blacklist evidence, ``dstpu health``)
        see it no matter which record they read last. Re-writes the
        current phase immediately (forced) so the evidence is durable
        before the caller acts on it — integrity aborts exit right
        after stamping."""
        with self._lock:
            if flag not in self._flags:
                self._flags.append(flag)
            phase = self._last_phase or PHASE_INIT
            last = self._records[-1] if self._records else None
            step = int(last.get("step", step)) if last is not None else step
            # carry the newest record's gauges: a STRAGGLER flag whose
            # re-write dropped the step_ms gauge would erase the very
            # evidence it marks
            gauges = dict(last.get("gauges") or {}) if last else None
        return self.write(phase, step, force=True, lock_timeout=lock_timeout,
                          extra=gauges or None)

    def stamp_terminal(self, phase: str,
                       lock_timeout: Optional[float] = None) -> bool:
        """Append a terminal record reusing the newest record's step — the
        writer's owner is done and ``phase`` is the final word. A no-op
        when a terminal phase already stands (the engine's EXIT/PREEMPTED
        conclusion must not be overwritten by launch.py's fallback).
        ``lock_timeout`` bounds the lock as in :meth:`write`."""
        if lock_timeout is None:
            # unbounded only for non-exit callers; exit paths pass
            # lock_timeout
            self._lock.acquire()
        elif not self._lock.acquire(timeout=lock_timeout):
            self._stop.set()
            return False
        try:
            last = self._records[-1] if self._records else None
            if last is not None and last.get("phase") in TERMINAL_PHASES:
                self._stop.set()
                return False
            step = int(last.get("step", 0)) if last is not None else 0
        finally:
            self._lock.release()
        return self.write(phase, step, force=True, lock_timeout=lock_timeout)

    def _flush(self, durable: bool = True) -> bool:
        """Rewrite the rank file atomically from the in-memory records.
        Caller holds the lock.

        ``durable=False`` skips the fsync: steady-state STEP re-writes
        and refresher re-stamps hit the SHARED filesystem every second
        from the training hot path, and an fsync there (NFS: tens of ms)
        is charged straight to step time on every rank. Losing an
        unsynced re-stamp to a host crash just reads as silence — which
        is exactly what a dead host should read as. Phase transitions
        and terminal stamps stay durable: they ARE the post-mortem."""
        try:
            # the heartbeat-loss failpoint: an armed hb.write makes this
            # rank go silent exactly like a dead NFS mount would
            chaos.failpoint("hb.write")
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for r in self._records:
                    f.write(json.dumps(r, sort_keys=True) + "\n")
                if durable:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
            return True
        except OSError as e:
            self._warn(e)
            return False

    def _ensure_refresher(self) -> None:
        if self._refresher is not None and self._refresher.is_alive():
            return
        self._refresher = threading.Thread(target=self._refresh_loop,
                                           name="dstpu-heartbeat",
                                           daemon=True)
        self._refresher.start()

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_interval):
            with self._lock:
                if not self._records or \
                        self._records[-1]["phase"] in TERMINAL_PHASES:
                    continue
                # re-stamp (not append): "still alive in this phase"
                self._records[-1] = dict(self._records[-1],
                                         ts=self._clock())
                if self._flush(durable=False):
                    self._last_write = self._records[-1]["ts"]

    def _warn(self, err) -> None:
        if not self._warned:
            self._warned = True
            logger.warning(
                "heartbeat: write to %s failed (%s) — liveness reporting "
                "degraded for rank %d (training unaffected)",
                self.directory, err, self.rank)


#: the process-level writer launch.py hands off to the engine — kept
#: alive (refresher included) across the runpy boundary so the INIT
#: record cannot go stale while the user script is still importing /
#: building the model, before any engine exists to take over.
_process_writer: Optional[HeartbeatWriter] = None


def set_process_writer(writer: Optional[HeartbeatWriter]) -> None:
    global _process_writer
    _process_writer = writer


def _hostname() -> str:
    name = os.environ.get(HEARTBEAT_HOST_ENV, "")
    if name:
        return name
    import socket
    try:
        return socket.gethostname()
    except OSError:
        return "unknown"


def clear_channel(directory: str) -> None:
    """Remove every rank record (and stranded tmp) from the channel — the
    launcher-side start of a NEW supervised run attempt. The channel is
    run-scoped evidence: a STALLED record or a stale non-terminal record
    left by a previous attempt in a reused directory must never be read
    as this run's verdict (a clean degraded relaunch would reconstruct
    rc 117 forever) or trip the silence monitor at t=0. Failures are
    swallowed: an uncleanable share degrades to pre-clear behavior."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        if name.startswith("rank") and (name.endswith(_SUFFIX)
                                        or name.endswith(_SUFFIX + ".tmp")):
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass


def read_heartbeats(directory: str) -> Dict[int, dict]:
    """Latest record per rank: {rank: record}. Unreadable or torn files
    are skipped (the atomic replace makes torn files rare; a reader must
    still never crash on a half-dead share)."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("rank") and name.endswith(_SUFFIX)):
            continue
        try:
            with open(os.path.join(directory, name), encoding="utf-8") as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
            rec = json.loads(lines[-1]) if lines else None
        except (OSError, ValueError, IndexError):
            continue
        if isinstance(rec, dict) and "rank" in rec:
            out[int(rec["rank"])] = rec
    return out


def rec_host(rec: dict, rank_hosts: List[str],
             known_hosts: Optional[List[str]] = None) -> Optional[str]:
    """Best host attribution for a record — THE shared rank->host recovery
    used by RunSupervisor, BackendSupervisor, and the elastic agent, so
    blacklist evidence lands on the same host no matter which consumer
    read the record. The self-reported host wins when it is usable
    (non-empty and, when ``known_hosts`` is given, in that vocabulary —
    e.g. an out-of-band gethostname() FQDN the hostfile never uses is
    NOT usable); otherwise the rank's position in ``rank_hosts``, the
    world-ordered hosts the run was actually launched over."""
    host = rec.get("host")
    rank = rec.get("rank")
    usable = bool(host) and (known_hosts is None or host in known_hosts)
    if not usable and isinstance(rank, int) and 0 <= rank < len(rank_hosts):
        return rank_hosts[rank]
    return host


def record_age(rec: dict, now: Optional[float] = None) -> float:
    """Seconds since this record was written (clock-skew tolerant: never
    negative)."""
    now = time.time() if now is None else now
    return max(0.0, now - float(rec.get("ts", 0.0)))


def stale_ranks(directory: str, timeout: float,
                now: Optional[float] = None,
                records: Optional[Dict[int, dict]] = None) -> List[dict]:
    """Records older than ``timeout`` whose phase is non-terminal — ranks
    that were alive, said so, and then went silent. Terminal records are
    *conclusions*, not silence (a rank that stamped PREEMPTED and exited
    is not wedged, however old its record gets). ``records`` lets a
    caller that already holds a snapshot avoid a second directory read."""
    now = time.time() if now is None else now
    out = []
    if records is None:
        records = read_heartbeats(directory)
    for rank in sorted(records):
        rec = records[rank]
        if rec.get("phase") in TERMINAL_PHASES:
            continue
        if record_age(rec, now) > timeout:
            out.append(rec)
    return out


def terminal_records(directory: str) -> Dict[int, dict]:
    """Ranks whose LAST word was a terminal phase — the evidence backend
    supervisors use to reconstruct the rc contract after a scheduler
    flattened the real exit codes."""
    return {rank: rec for rank, rec in read_heartbeats(directory).items()
            if rec.get("phase") in TERMINAL_PHASES}


def flagged_ranks(directory: str,
                  flag: Optional[str] = None) -> Dict[int, dict]:
    """Ranks whose latest record carries integrity flags — the FLAGS
    column of ``dstpu health`` (any flag), and with ``flag=`` the
    blacklist feed: supervisors/agent filter to ``SDC``, the only mark
    that names a HOST, so the generic ``INTEGRITY`` abort mark (stamped
    by every rank of a diverged run) never strikes the innocent world."""
    return {rank: rec for rank, rec in read_heartbeats(directory).items()
            if rec.get("flags") and
            (flag is None or flag in rec["flags"])}
