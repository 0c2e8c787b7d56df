"""In-worker liveness watchdog — turn a silent hang into a diagnosable exit
(counterpart of ``deepspeed_tpu/runtime/watchdog.py``; in this package the
serving engine's ``arm_watchdog`` arms it, and the training engine's
``watchdog`` section drives its phase deadlines: init, restore, compile,
step and save).

In a one-process-per-host multi-controller job a single wedged rank (a
deadlocked collective, a hung host, a dead coordinator) stalls EVERY rank:
all of them sit inside a collective waiting for the straggler, forever.
Durable checkpoints don't help if nothing ever exits — supervision
needs a liveness signal.

A single armed/unarmed stall clock fed by ``engine.step()`` would leave
the whole pre-first-step window (compile hangs, wedged sharded restores)
unbounded, so this is a PHASE-AWARE watchdog: the worker lifecycle is explicit phases (INIT → RESTORE →
COMPILE → STEP → SAVE, runtime/heartbeat.py), each with its OWN deadline:

========  =============================================  ==================
phase     covers                                         config key
========  =============================================  ==================
INIT      process-group rendezvous                       ``DSTPU_INIT_TIMEOUT`` / :func:`init_deadline`
RESTORE   ``engine.load_checkpoint``                     ``watchdog.restore_timeout``
COMPILE   first ``train_batch`` entry → first completion ``watchdog.compile_timeout``
STEP      steady-state step gaps                         ``watchdog.stall_timeout``
SAVE      ``engine.save_checkpoint``                     ``watchdog.save_timeout``
========  =============================================  ==================

A deadline of 0 leaves that phase unbounded (a single stall clock's semantics for
everything but STEP). On expiry the watchdog dumps EVERY thread's stack
(``faulthandler`` — the hang is usually in a collective or an IO thread),
stamps a terminal ``STALLED`` heartbeat record if a writer is attached
(launcher-side supervisors read it to keep the rc contract), and exits
:data:`STALL_EXIT_CODE`.

**Single rc-117 path**: every deadline in this module — phase deadlines
and :func:`init_deadline` — fires through one guarded :func:`_fire`
implementation. A process where two timers expire in the same instant
(an init deadline racing an armed watchdog used to be two independent
``threading.Timer``/thread exits) performs exactly one dump-and-exit;
the loser returns without side effects.

Exit-code contract (docs/RESILIENCE.md): 0 = clean,
``PREEMPTION_EXIT_CODE`` (114) = checkpointed-and-resumable,
``STALL_EXIT_CODE`` (117) = wedged (counts against the elastic agent's
``max_restarts`` — a stall is a failure, not a preemption).

reference counterpart: torch-elastic's watchdog/healthcheck timers on the
agent; placing the heartbeat IN the worker is what lets a worker
self-report before the collective deadlock propagates.
"""

from __future__ import annotations

import contextlib
import faulthandler
import io
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from .heartbeat import (PHASE_COMPILE, PHASE_INIT, PHASE_RESTORE, PHASE_SAVE,
                        PHASE_STALLED, PHASE_STEP)

#: Exit code meaning "this worker made no progress within its current
#: phase's deadline". Distinct from Python's 0-2, shell signal codes
#: (>=128), chaos.KILL_EXIT_CODE and PREEMPTION_EXIT_CODE. Re-exported
#: from the single-source contract module.
from ..exit_codes import STALL_EXIT_CODE  # noqa: E402


def _dump_stacks(stream, reason: str) -> None:
    """All-threads stack dump. Best-effort: diagnostics must never mask
    the exit itself. faulthandler (async-signal-safe, the production
    path) needs a real fd; fd-less streams (tests, redirected stderr)
    fall back to a pure-Python dump via sys._current_frames()."""
    try:
        stream.write(f"\n=== dstpu watchdog: {reason} — "
                     "dumping all thread stacks ===\n")
        stream.flush()
        try:
            stream.fileno()
            faulthandler.dump_traceback(file=stream, all_threads=True)
        except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
            import traceback
            names = {t.ident: t.name for t in threading.enumerate()}
            for tid, frame in sys._current_frames().items():
                stream.write(f"\nThread {names.get(tid, '?')} ({tid}):\n")
                traceback.print_stack(frame, file=stream)
        stream.flush()
    except Exception:
        pass


#: bound on the terminal-stamp lock acquisition inside :func:`_fire` —
#: the writer's refresher may hold the lock wedged in dead-storage I/O,
#: and the rc-117 exit must never wait on diagnostics
_STAMP_LOCK_TIMEOUT = 5.0

# The process-wide rc-117 once-guard. Held (not re-released) when the
# exit_fn actually exits the process; released afterwards for test
# exit_fns that return, so independent tests can each observe a fire.
_fire_lock = threading.Lock()
_fire_in_progress = False


def _fire(stream, reason: str, exit_fn: Callable[[int], None],
          heartbeat=None, step: int = 0) -> bool:
    """THE rc-117 exit path. Returns False (without any side effects) if
    another deadline in this process is already mid-exit — the fix for
    an init deadline and an armed phase watchdog double-firing."""
    global _fire_in_progress
    # bounded: the guard only brackets flag flips, so a starved acquire
    # means another deadline is mid-exit (or the interpreter is dying) —
    # either way this fire yields rather than wedging the exit path
    if not _fire_lock.acquire(timeout=_STAMP_LOCK_TIMEOUT):
        return False
    try:
        if _fire_in_progress:
            return False
        _fire_in_progress = True
    finally:
        _fire_lock.release()
    try:
        _dump_stacks(stream, reason)
        if heartbeat is not None:
            try:
                # the final word: launcher-side supervisors read STALLED
                # to restore rc 117 through schedulers that flatten rcs.
                # Bounded lock: the writer's refresher may itself be the
                # wedge (dead NFS blocks inside _flush WITHOUT raising),
                # and an exit path that waits on a diagnostics lock would
                # turn the guaranteed rc-117 exit back into a hang
                heartbeat.write(PHASE_STALLED, step, force=True,
                                lock_timeout=_STAMP_LOCK_TIMEOUT)
            except Exception:
                pass
        exit_fn(STALL_EXIT_CODE)
        return True
    finally:
        # same bound on the reset: a test exit_fn that returns must not
        # leave the NEXT fire waiting forever if the guard is starved
        if _fire_lock.acquire(timeout=_STAMP_LOCK_TIMEOUT):
            _fire_in_progress = False
            _fire_lock.release()


class StallWatchdog:
    """Phase-aware deadline monitor.

    ``enter_phase(p)`` moves the lifecycle clock into phase ``p`` and
    restarts it; ``beat()`` marks progress WITHIN the current phase (the
    engine's step path calls it per optimizer step). A gap longer than
    the current phase's deadline — ``stall_timeout`` for STEP,
    ``phase_timeouts[p]`` otherwise, 0 = unbounded — fires the single
    rc-117 path. ``suspended()`` brackets operations whose duration is
    legitimately unbounded regardless of phase (the preemption grace
    window); leaving the bracket re-arms the clock from now.
    """

    def __init__(self,
                 stall_timeout: float,
                 poll_interval: Optional[float] = None,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 stream=None,
                 phase_timeouts: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 heartbeat=None,
                 phase: str = PHASE_STEP):
        self.timeouts: Dict[str, float] = {PHASE_STEP: float(stall_timeout)}
        for k, v in (phase_timeouts or {}).items():
            self.timeouts[k] = float(v)
        positive = [t for t in self.timeouts.values() if t > 0]
        if not positive:
            raise ValueError(
                "watchdog needs at least one positive deadline (0 disables "
                "a phase at the config layer, not here)")
        self.stall_timeout = float(stall_timeout)
        self.poll_interval = (float(poll_interval) if poll_interval
                              else max(min(positive) / 4.0, 0.05))
        self.labels = dict(labels or {})
        self.heartbeat = heartbeat
        self._exit_fn = exit_fn or os._exit
        self._stream = stream if stream is not None else sys.stderr
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._phase = phase
        self._step = 0
        self._suspends = 0          # nested suspensions (save inside grace)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False          # observable by in-process tests

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        # fresh event per start: start() after stop() must arm a REAL
        # monitor, not a thread that sees the stale stop flag and dies
        self._stop = threading.Event()
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(target=self._run,
                                        name="dstpu-stall-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.poll_interval * 4)
        self._thread = None

    # ------------------------------------------------------------ heartbeat

    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    def enter_phase(self, phase: str, step: Optional[int] = None) -> None:
        """Move the lifecycle clock into ``phase`` and restart it. The
        old phase's elapsed time is never charged to the new one."""
        with self._lock:
            self._phase = phase
            if step is not None:
                self._step = int(step)
            self._last_beat = time.monotonic()

    @contextlib.contextmanager
    def phase_scope(self, phase: str):
        """Bracket a bounded section (a RESTORE or SAVE): enter the
        phase, and on exit return to the prior phase with a fresh clock —
        the section's duration must not count toward the next gap."""
        with self._lock:
            prev = self._phase
        self.enter_phase(phase)
        try:
            yield self
        finally:
            self.enter_phase(prev)

    def beat(self, step: Optional[int] = None) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            if step is not None:
                self._step = int(step)

    def suspend(self) -> None:
        with self._lock:
            self._suspends += 1

    def resume(self) -> None:
        with self._lock:
            self._suspends = max(0, self._suspends - 1)
            # the suspended window must not count toward the NEXT gap
            self._last_beat = time.monotonic()

    @contextlib.contextmanager
    def suspended(self):
        """Bracket a legitimately unbounded section: the watchdog cannot
        fire inside, and the clock restarts on exit."""
        self.suspend()
        try:
            yield self
        finally:
            self.resume()

    # ----------------------------------------------------------------- loop

    def _describe(self, phase: str, gap: float, timeout: float) -> str:
        if phase in self.labels:
            return (f"{self.labels[phase]} did not complete within "
                    f"{timeout:.1f}s")
        if phase == PHASE_STEP:
            return (f"no step progress for {gap:.1f}s "
                    f"(stall_timeout={timeout:.1f}s)")
        key = {PHASE_INIT: "init", PHASE_RESTORE: "restore",
               PHASE_COMPILE: "compile", PHASE_SAVE: "save"}.get(
                   phase, phase.lower())
        return (f"phase {phase} made no progress for {gap:.1f}s "
                f"({key}_timeout={timeout:.1f}s)")

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            with self._lock:
                if self._suspends > 0:
                    continue
                phase = self._phase
                step = self._step
                gap = time.monotonic() - self._last_beat
            timeout = self.timeouts.get(phase, 0.0)
            if timeout <= 0 or gap <= timeout:
                continue
            if _fire(self._stream, self._describe(phase, gap, timeout),
                     self._exit_fn, heartbeat=self.heartbeat, step=step):
                self.fired = True
            return          # fired (or lost the race to another deadline)


@contextlib.contextmanager
def init_deadline(timeout: float,
                  what: str = "torch.distributed.init_process_group",
                  exit_fn: Optional[Callable[[int], None]] = None,
                  stream=None):
    """Hard deadline around process bootstrap. ``timeout <= 0`` is a
    no-op (opt-in knob). If the body doesn't finish in time, dump all
    stacks and exit ``STALL_EXIT_CODE`` — a worker that never rendezvoused
    holds no state worth saving, and the fast distinct exit is what lets
    the supervisor tear the launch down instead of waiting forever.

    Implemented as a one-phase :class:`StallWatchdog` pinned to INIT, so
    the deadline rides the same poll loop and the same guarded
    :func:`_fire` path as every other phase — there is no second timer
    implementation that could double-exit."""
    if timeout is None or timeout <= 0:
        yield
        return
    wd = StallWatchdog(stall_timeout=0.0,
                       poll_interval=min(float(timeout) / 4.0, 1.0),
                       exit_fn=exit_fn, stream=stream,
                       phase_timeouts={PHASE_INIT: float(timeout)},
                       labels={PHASE_INIT: what},
                       phase=PHASE_INIT)
    wd.start()
    try:
        yield
    finally:
        wd.stop()
