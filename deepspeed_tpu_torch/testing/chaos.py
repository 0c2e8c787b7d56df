"""Fault-injection harness: named failpoints for crash-safety tests
(counterpart of ``deepspeed_tpu/testing/chaos.py``: the same spec grammar,
catalog and modes). In this package every name of the catalog is
instrumented: the ``ckpt.*`` failpoints of ``runtime/checkpointing.py``,
the ``serve.*`` ones of the serving engine, scheduler, block pool,
disaggregated roles and fleets, ``hb.write``, the ``net.*`` ones of the
transfer fabric, the ``run.*`` and ``sentinel.*`` ones of the training
engine's step entry and SDC audit, ``pipe.stage_kill`` and ``pipe.xfer``
of the MPMD stage worker and its channels, and ``host.blackhole`` /
``launch.ssh`` of the launcher's supervisor.

The checkpoint stack is only provably restartable if a test can crash a
real save at EVERY stage — mid-array-write, after the data but before the
completion marker, between the rename and the ``latest`` update — and then
demonstrate that a fresh engine resumes from the newest intact tag. This
module provides the crash trigger: production code declares *failpoints*
(named, stable identifiers; see docs/RESILIENCE.md for the catalog) and
tests arm them to raise an ``IOError`` or kill the process at exactly that
point.

Design constraints:

- **Zero cost disarmed.** ``failpoint(name)`` with nothing armed is one
  dict lookup that misses. No env reads, no locks on the fast path.
- **Deterministic.** A failpoint fires on an exact hit index (``skip``
  hits pass through first) for an exact number of times — no randomness,
  so the crash-at-every-stage matrix is a plain parametrize.
- **Cross-process.** Subprocess tests (kill-mid-write, SIGTERM) arm
  failpoints in the child via the ``DSTPU_CHAOS`` env var, parsed once at
  first failpoint evaluation in that process.

Spec syntax (env var or ``arm()``)::

    DSTPU_CHAOS="ckpt.write:raise"            # raise IOError on 1st hit
    DSTPU_CHAOS="ckpt.write:kill"             # os._exit(13) on 1st hit
    DSTPU_CHAOS="ckpt.write:raise:skip=1"     # pass 1 hit, fail the 2nd
    DSTPU_CHAOS="ckpt.write:raise:times=2"    # fail the first 2 hits
    DSTPU_CHAOS="a:raise;b:kill:skip=3"       # several failpoints
    DSTPU_CHAOS="run.preempt:kill:code=114"   # kill with a chosen exit code
    DSTPU_CHAOS="run.hang:hang"               # block forever (wedged rank)
    DSTPU_CHAOS="ckpt.write:sleep:ms=300"     # delay, then continue
    DSTPU_CHAOS="run.preempt:sigterm"         # SIGTERM self (preemption)
    DSTPU_CHAOS="host.blackhole:raise:match=w2"  # keyed: only host w2
    DSTPU_CHAOS="sentinel.spike:flag:factor=1000"  # query-style injection
    DSTPU_CHAOS="run.slow:sleep:ms=300:times=0"   # every hit, forever
    DSTPU_CHAOS="run.slow:sleep:ms=300:every=3:times=0"  # every 3rd hit
    DSTPU_CHAOS="run.slow:sleep:ms=300:p=40:times=0"     # ~40% of hits

Run-supervision modes (round-4): ``hang`` blocks the calling thread
forever — the userspace approximation of a wedged collective, what the
stall watchdog and the supervisor's teardown exist to catch. ``sleep``
delays ``ms`` milliseconds and then continues — for overlap tests that
need an IO operation to still be in flight when something else happens.
``sigterm`` sends SIGTERM to the calling process (the installed
preemption handler fires, exactly like a real TPU preemption notice).
``kill`` takes ``code=N`` to emulate any exit-code contract.

Intermittent-slowness semantics (round-15, the straggler defense —
*degraded, not dead*): ``times=0`` means UNLIMITED fires (the default
stays 1), and two deterministic jitter filters shape WHICH eligible
traversals fire: ``every=N`` fires the first post-``skip`` traversal
and every Nth after it (periodic throttling — a host that hiccups on a
cadence), while ``p=P`` (percent, 0-100) fires P% of eligible
traversals on an evenly-spaced accumulator pattern (acc += P, fire and
subtract at 100) — probabilistic-LOOKING degradation with zero
randomness, so the straggler matrices stay exactly reproducible. The
``run.slow`` failpoint at the train-batch boundary and the keyed
``serve.replica_slow`` in the fleet worker loop combine these with
``sleep`` to make one rank/replica slow-but-alive.

Serving failpoints (round-8, the continuous-batching loop): on the
serving hot path production code declares ``serve.enqueue``
(Scheduler.submit — an exploding enqueue must surface to the submitting
caller, never wedge the loop) and ``serve.oom`` (BlockPool.alloc — an
injected allocation failure must leave the request QUEUED and the loop
serving, indistinguishable from a genuinely full pool).

Fleet failpoints (round-11, serving/fleet.py): ``serve.replica_kill``
and ``serve.replica_hang`` fire at the top of each replica worker
iteration, KEYED by the replica index (``match=1`` takes out replica 1
only) — ``raise`` mode is replica death (in-flight requests must
requeue with exactly-once emission), ``hang`` is the silence case the
FleetSupervisor detects through the heartbeat channel. ``serve.requeue``
fires inside the requeue itself: a crash THERE must orphan-and-retry
the request, never lose it. In-process fleets use ``raise``/``hang``;
``kill`` mode would exit the whole process and belongs to
process-per-replica deployments.

Disaggregated-serving failpoints (round-12, serving/disagg.py):
``serve.chunk`` fires per chunked-prefill chunk (serving/engine.py —
a crash mid-prefill must release the partial allocation and requeue the
request exactly-once, chunk progress carried); ``serve.handoff`` fires
inside ``BlockHandoff.push`` BEFORE the item is queued (a crash leaves
the blocks with the dying prefill role — never a half-queued item);
``serve.handoff_drop`` fires between a decode-side pop and the lane
install (a crash there is a decode death holding a popped item — its
blocks ride the quarantine, the request requeues through the
token-exact prompt+emitted path). The crash-at-every-failpoint matrix
lives in tests/test_disagg.py.

Query mode (round-7, the training-integrity sentinel): ``flag`` never
raises or kills — production code ASKS :func:`flag` whether the site is
armed and fired, and perturbs its own data when it is (a grad spike
scales the batch, an SDC fault flips a bit in one replica's weights).
The ``factor=N`` option carries the perturbation magnitude.

reference counterpart: DeepSpeed's tests monkeypatch torch.save /
simulate SIGTERM by hand per test; a named-failpoint registry is the
framework-neutral equivalent of kernel-style fault injection (fail_make_
request) — one mechanism, every crash site.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, List, Optional

#: exit code used by ``kill`` mode — distinct from Python's 1 and from
#: PREEMPTION_EXIT_CODE so tests can tell "chaos killed it" apart from
#: ordinary failures. Re-exported from the single-source contract module.
from ..exit_codes import KILL_EXIT_CODE  # noqa: E402

_lock = threading.Lock()
_armed: Dict[str, "_FailPoint"] = {}
_env_loaded = False
_history: List[str] = []        # fired failpoint names, in order

#: Catalog of every failpoint/flag name instrumented in the package,
#: name -> where it fires. graftlint rule TPU020 checks that every
#: ``failpoint("...")`` / ``chaos.flag("...")`` call site in source uses a
#: name listed here AND documented in docs/RESILIENCE.md's failpoint
#: table, so the catalog, the docs, and the instrumentation can never
#: drift apart (the failpoint analogue of
#: ``test_facade_catalog_covers_comm_module``). Arming an uncataloged
#: name from a test still works — the catalog constrains *source*
#: instrumentation sites, not test scripts.
FAILPOINTS: Dict[str, str] = {
    "pipe.stage_kill": "MPMD stage worker, top of the stage step loop",
    "pipe.xfer": "MPMD channel, inter-stage frame read/write",
    "ckpt.write": "checkpoint shard write",
    "ckpt.digest": "checkpoint shard digest computation",
    "ckpt.marker": "checkpoint commit-marker write",
    "ckpt.rename": "checkpoint atomic rename into place",
    "ckpt.latest": "LATEST pointer update",
    "ckpt.meta": "checkpoint metadata write",
    "run.kill": "training step loop, hard kill",
    "run.preempt": "training step loop, simulated preemption",
    "run.hang": "training step loop, infinite hang",
    "run.slow": "training step loop, injected per-step delay",
    "run.compile_hang": "first-step compilation, infinite hang",
    "sentinel.spike": "flag: sentinel sees a fake loss spike",
    "sentinel.sdc": "flag: sentinel sees a fake checksum mismatch",
    "hb.write": "heartbeat file write",
    "host.blackhole": "launcher, host stops responding",
    "launch.ssh": "launcher, ssh/session establishment",
    "serve.chunk": "serving engine, per-chunk prefill",
    "serve.handoff": "disagg prefill->decode block handoff push",
    "serve.handoff_drop": "disagg handoff entry expiry/drop",
    "serve.enqueue": "serving scheduler/fleet request enqueue",
    "serve.replica_hang": "fleet replica worker, infinite hang",
    "serve.replica_kill": "fleet replica worker, hard kill",
    "serve.replica_slow": "fleet replica worker, injected delay",
    "serve.requeue": "fleet, in-flight requeue after replica death",
    "serve.scale_up": "fleet autoscaler, between slot append and warmed "
                      "spawn (keyed by new replica index)",
    "serve.preempt": "fleet preemption, between lane eviction and the "
                     "victim's requeue",
    "serve.oom": "KV block pool exhaustion",
    "net.connect": "fabric endpoint, per dial attempt (initial + redial)",
    "net.send": "fabric endpoint send, surfaced to the caller unretried",
    "net.recv": "fabric endpoint recv, frame delivery to the caller",
    "net.corrupt": "flag: fabric frame codec flips a payload bit on-wire",
    "net.partition": "fabric link I/O, mid-stream loss driving the "
                     "redial ladder",
    "net.slow": "fabric endpoint send, injected link latency",
}


class ChaosError(IOError):
    """The injected fault. Subclasses IOError so code under test exercises
    its real transient-IO handling (retry/backoff, quarantine) — a chaos
    fault must be indistinguishable from a disk hiccup."""

    def __init__(self, name: str):
        super().__init__(f"chaos failpoint '{name}' fired")
        self.failpoint = name


_MODES = ("raise", "kill", "hang", "sleep", "sigterm", "flag")


class _FailPoint:
    __slots__ = ("name", "mode", "skip", "times", "hits", "fired", "code",
                 "ms", "match", "factor", "every", "p", "acc")

    def __init__(self, name: str, mode: str, skip: int = 0, times: int = 1,
                 code: Optional[int] = None, ms: int = 0,
                 match: Optional[str] = None, factor: int = 1,
                 every: int = 0, p: int = 0):
        if mode not in _MODES:
            raise ValueError(f"chaos mode must be one of {_MODES}, "
                             f"got {mode!r}")
        if not 0 <= p <= 100:
            raise ValueError(f"chaos p= must be a percentage 0-100, got {p}")
        self.name = name
        self.mode = mode
        self.skip = skip
        self.times = times  # fire budget; 0 = unlimited (round 15)
        self.code = KILL_EXIT_CODE if code is None else code
        self.ms = ms        # sleep mode: delay in milliseconds
        self.match = match  # keyed failpoints: fire only when key == match
        self.factor = factor  # flag mode: perturbation magnitude
        self.every = every  # jitter: fire 1st eligible hit + every Nth after
        self.p = p          # jitter: fire P% of eligible hits (accumulator)
        self.acc = 0        # the p= accumulator — deterministic, no PRNG
        self.hits = 0       # total traversals of this failpoint
        self.fired = 0      # times it actually failed

    def advance(self) -> bool:
        """One traversal's fire decision (caller holds the module lock):
        skip first, then the fire budget (``times=0`` = unlimited), then
        the deterministic jitter filters — ``every=N`` passes the first
        post-skip traversal and every Nth after it; ``p=P`` passes P% of
        what remains via an evenly-spaced accumulator."""
        self.hits += 1
        if self.hits <= self.skip:
            return False
        if 0 < self.times <= self.fired:
            return False
        if self.every > 1 and (self.hits - self.skip - 1) % self.every != 0:
            return False
        if self.p > 0:
            self.acc += self.p
            if self.acc < 100:
                return False
            self.acc -= 100
        self.fired += 1
        _history.append(self.name)
        return True


def parse_spec(spec: str) -> Dict[str, _FailPoint]:
    """Parse a ``DSTPU_CHAOS`` spec string (see module docstring)."""
    out: Dict[str, _FailPoint] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"bad chaos spec {part!r}: expected name:mode[:k=v...]")
        name, mode = fields[0], fields[1]
        kwargs = {}
        for f in fields[2:]:
            k, _, v = f.partition("=")
            if k == "match":            # keyed failpoints take a STRING
                kwargs[k] = v           # (e.g. match=worker-2 on
                continue                # host.blackhole)
            if k not in ("skip", "times", "code", "ms", "factor", "every",
                         "p"):
                raise ValueError(f"bad chaos spec option {f!r} in {part!r}")
            kwargs[k] = int(v)
        out[name] = _FailPoint(name, mode, **kwargs)
    return out


def _load_env_once() -> None:
    global _env_loaded
    # registry lock: brackets dict ops only, never blocking work — a
    # signal handler passing through a failpoint cannot wedge on it
    with _lock:  # graftlint: disable=TPU019
        if _env_loaded:
            return
        _env_loaded = True
        spec = os.environ.get("DSTPU_CHAOS", "")
        if spec:
            _armed.update(parse_spec(spec))


def arm(name: str, mode: str = "raise", skip: int = 0, times: int = 1,
        code: Optional[int] = None, ms: int = 0,
        match: Optional[str] = None, factor: int = 1,
        every: int = 0, p: int = 0) -> None:
    """Programmatically arm a failpoint (in-process tests). ``match``
    restricts a KEYED failpoint to one key — e.g. ``host.blackhole``
    with ``match="worker-2"`` only fires for that host's dispatch.
    ``times=0`` = unlimited fires; ``every=``/``p=`` are the
    deterministic jitter filters (module docstring)."""
    with _lock:
        _armed[name] = _FailPoint(name, mode, skip=skip, times=times,
                                  code=code, ms=ms, match=match,
                                  factor=factor, every=every, p=p)


def disarm(name: Optional[str] = None) -> None:
    """Disarm one failpoint, or all of them (``name=None``). The fired
    history survives so a test can still assert WHAT fired; use
    :func:`reset_for_tests` for a full wipe."""
    global _env_loaded
    with _lock:
        if name is None:
            _armed.clear()
            _env_loaded = True      # env consumed; do not re-read
        else:
            _armed.pop(name, None)


def reset_for_tests() -> None:
    """Full reset incl. re-reading DSTPU_CHAOS on next use — conftest's
    per-test hook, so a test that sets the env var (subprocess specs) and
    one that arms programmatically can't interfere."""
    global _env_loaded
    with _lock:
        _armed.clear()
        _history.clear()
        _env_loaded = False


def fired(name: Optional[str] = None) -> List[str]:
    """Names of failpoints that actually fired (optionally filtered)."""
    with _lock:
        return [h for h in _history if name is None or h == name]


def armed() -> List[str]:
    _load_env_once()
    with _lock:
        return sorted(_armed)


def failpoint(name: str, key: Optional[str] = None) -> None:
    """Declare a failpoint. No-op unless a test armed ``name``.

    ``raise`` mode raises :class:`ChaosError` (an IOError). ``kill`` mode
    calls ``os._exit(code)`` (default ``KILL_EXIT_CODE``) — no atexit
    handlers, no flushes: the closest userspace approximation of the
    machine dying. ``hang`` blocks this thread forever (a wedged rank);
    ``sleep`` delays ``ms`` milliseconds then continues; ``sigterm``
    raises SIGTERM in this process (drives the preemption handler).

    ``key`` marks a KEYED site (the dispatching host, a rank id): a spec
    armed with ``match=K`` fires — and counts hits — only when
    ``key == K``, so one armed ``host.blackhole`` can take out a single
    host of a multi-host world.
    """
    if not _env_loaded:
        _load_env_once()
    if not _armed:
        return
    # registry lock: dict lookups and counter bumps only (the injected
    # hang/sleep happens AFTER release) — safe under a signal handler
    with _lock:  # graftlint: disable=TPU019
        fp = _armed.get(name)
        if fp is None:
            return
        if fp.match is not None and key != fp.match:
            return
        if not fp.advance():
            return
        mode, code, ms = fp.mode, fp.code, fp.ms
    if mode == "kill":
        os._exit(code)
    if mode == "hang":
        while True:             # cannot be woken — only killed from outside
            time.sleep(3600)
    if mode == "sleep":
        time.sleep(ms / 1000.0)
        return
    if mode == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if mode == "flag":
        return          # query sites use flag(); traversal alone is inert
    raise ChaosError(name)


def flag(name: str, key: Optional[str] = None) -> Optional[int]:
    """Query-style failpoint: the injection magnitude (``factor``) when an
    armed ``flag``-mode spec fires at this traversal, else ``None``.

    Unlike :func:`failpoint`, the site itself performs the perturbation —
    this only answers "should I, and how hard?". Hit/skip/times/match
    accounting is identical, so a spec like
    ``sentinel.spike:flag:skip=10:times=3:factor=1000`` scales exactly
    steps 11-13 and nothing else."""
    if not _env_loaded:
        _load_env_once()
    if not _armed:
        return None
    with _lock:
        fp = _armed.get(name)
        if fp is None or fp.mode != "flag":
            return None
        if fp.match is not None and key != fp.match:
            return None
        if not fp.advance():
            return None
        return fp.factor
