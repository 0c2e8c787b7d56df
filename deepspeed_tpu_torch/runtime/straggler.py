"""Straggler defense — relative-slowness detection over the heartbeat channel
(counterpart of ``deepspeed_tpu/runtime/straggler.py``: the same gauge,
detector and verdicts; in this package the serving fleet's supervisor,
the training engine's ``straggler`` section and the MPMD stage workers'
step stamps use them).

The resilience stack defends against *dead* (rc 114/117: phase watchdogs,
heartbeat silence) and *wrong* (rc 118: the integrity sentinel and SDC
audit). A slow-but-alive host — thermal throttling, a degraded NIC, a
noisy neighbor — passes every one of those checks while the synchronous
step drags the whole world down to its pace: at MPMD scale one slow
stage stalls every downstream clock tick, and in a serving fleet one
throttled replica holds the shared queue's p99 hostage. This module is
the third leg of the threat model: *slow*.

Evidence rides the EXISTING heartbeat channel (the ROADMAP guardrail —
no new liveness plumbing): every worker stamps a rolling per-step
wall-time gauge (``step_ms``, a :class:`StepClock` median over the last
few steps) into its heartbeat records — the engine step loop, MPMD stage
workers (STAGE-tagged) and fleet replica workers (SERVE) all stamp it,
and ``dstpu health`` renders it as the RATE column.

Detection is *relative*: a :class:`StragglerDetector` consumes a channel
snapshot per observation window and compares each rank's gauge against
the WORLD's — the sentinel's :class:`~.sentinel.RollingRobust`
median/MAD machinery applied cross-rank instead of cross-step, with the
judged rank LEFT OUT of its own baseline (self-inclusion makes a 2-rank
world undetectable past ``rel_threshold >= 2`` and drags every median
toward the straggler). A rank is *slow* in a window when its step time
sits ``zmax`` robust sigmas above the other ranks' median AND above
``rel_threshold`` x that median (the relative floor is what makes a
uniformly-slow world — everyone throttled by the same rack — produce
ZERO verdicts: the baseline scales with the world). Worlds too small
for a meaningful MAD (< 4 other gauges) fall back to the relative floor
alone. Records in COMPILE/RESTORE/SAVE phases, terminal records, and
records predating the gauge are never compared — a compile is not a
straggle.

Verdicts are warmup-gated (the first ``warmup`` complete windows only
feed the baseline), require ``strike_window`` CONSECUTIVE slow windows,
and are cooldown-debounced (one verdict per ``cooldown`` windows per
rank). The escalation ladder mirrors the sentinel's:

1. **flag** — the slow rank stamps a sticky ``STRAGGLER`` heartbeat flag
   on itself (every rank runs the same detector over the same shared
   snapshot, so self-verdicts need no coordination — the SDC pattern).
   Visible in ``dstpu health``; evidence-only by default.
2. **blacklist evidence** — RunSupervisor / BackendSupervisor /
   DSElasticAgent consume the flag exactly like the SDC flag (it names a
   HOST; the rc names nobody), so a struck host is quarantined by
   ``--blacklist-after`` and the next world re-forms without it (parole
   under ``min_nodes`` unchanged).
3. **abort** — with ``straggler.abort_after > 0``, a rank still slow
   ``abort_after`` windows past its verdict stamps a STALLED terminal
   record and raises :class:`StragglerAbort` (rc 117, the existing
   stall path): the supervisor tears the world down, the elastic agent
   counts the stall and relaunches without the slow host. 0 (the
   default) never tears anything down — detection is evidence-only.

Fleet-side the ladder is a DRAIN instead of a teardown: FleetSupervisor
runs the same detector over the replicas' SERVE gauges and hands a slow
replica to the existing replica-death path — admission stops, its lanes
requeue through the exactly-once token-exact path, the replica restarts
warmed and the strike counts toward ``blacklist_after``.

Chaos: ``run.slow`` (train-batch boundary) and the keyed
``serve.replica_slow`` (fleet worker loop) inject *degraded, not dead*
hosts via the ``sleep`` mode's ``every=``/``p=`` jitter semantics
(docs/RESILIENCE.md catalog).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from .heartbeat import PHASE_SERVE, PHASE_STEP, TERMINAL_PHASES
from .sentinel import SDC_FLAG, RollingRobust, _median
from .watchdog import STALL_EXIT_CODE

#: sticky heartbeat flag naming a slow HOST — consumed as blacklist
#: evidence by both supervisors and the elastic agent, exactly like the
#: SDC flag (and unlike the generic INTEGRITY mark, which names nobody)
STRAGGLER_FLAG = "STRAGGLER"

#: the heartbeat flags that NAME A HOST — each is stamped by exactly the
#: implicated rank, so the record is per-host blacklist evidence. The
#: one vocabulary all three consumers (RunSupervisor, BackendSupervisor,
#: DSElasticAgent) sweep; the generic INTEGRITY mark is deliberately
#: absent (launch.py stamps it on EVERY rank of an rc-118 abort for
#: health visibility — it names nobody)
HOST_NAMING_FLAGS = (SDC_FLAG, STRAGGLER_FLAG)

#: the heartbeat gauge key workers stamp and the detector reads
STEP_MS_GAUGE = "step_ms"

#: verdict vocabulary returned by :meth:`StragglerDetector.observe`
SLOW = "SLOW"
ABORT = "ABORT"


class StragglerAbort(RuntimeError):
    """Rung 3: this rank has been persistently slow past
    ``straggler.abort_after`` windows and is tearing the world down so
    the elastic agent can relaunch without it. Carries the STALL exit
    code (117) — launch.py maps any exception with ``exit_code`` onto
    ``sys.exit``, and the supervisors/agent already treat 117 as a
    counted, blacklist-attributable failure."""

    exit_code = STALL_EXIT_CODE


class StepClock:
    """Worker-side rolling step-wall-time gauge.

    ``mark()`` at each step boundary records the gap since the previous
    boundary and returns the rolling MEDIAN of the last ``window`` gaps
    in milliseconds (robust: one checkpoint save or GC pause cannot spike
    the gauge). ``reset()`` drops the pending boundary so a gap spanning
    a non-step phase (RESTORE/SAVE/COMPILE, a pipeline park) is never
    charged as a step. ``push_ms()`` feeds an explicitly-measured
    duration instead (the fleet worker times its own iteration)."""

    def __init__(self, window: int = 8, clock=None):
        self.buf: deque = deque(maxlen=max(2, int(window)))
        self._clock = clock or time.monotonic
        self._last: Optional[float] = None

    def mark(self) -> Optional[float]:
        now = self._clock()
        if self._last is not None:
            self.buf.append((now - self._last) * 1000.0)
        self._last = now
        return self.gauge()

    def push_ms(self, ms: float) -> Optional[float]:
        self.buf.append(float(ms))
        return self.gauge()

    def reset(self) -> None:
        self._last = None

    def gauge(self) -> Optional[float]:
        """Rolling median step time in ms, or None before the first
        completed gap (records predating the gauge render as ``-`` in
        ``dstpu health``)."""
        if not self.buf:
            return None
        return round(_median(self.buf), 2)


def record_step_ms(rec: dict) -> Optional[float]:
    """A record's comparable step gauge, or None when the record must
    not participate in a window: terminal phases are conclusions, and
    non-STEP/SERVE phases (COMPILE, RESTORE, SAVE, INIT) measure
    something other than steady-state step cadence — a rank mid-compile
    or mid-restore must never read as a straggler."""
    phase = rec.get("phase")
    if phase in TERMINAL_PHASES or phase not in (PHASE_STEP, PHASE_SERVE):
        return None
    val = (rec.get("gauges") or {}).get(STEP_MS_GAUGE)
    try:
        return float(val) if val is not None else None
    except (TypeError, ValueError):
        return None


class StragglerDetector:
    """Cross-rank relative-slowness detector (module docstring has the
    criteria and the ladder). One instance per consumer:

    - each ENGINE holds one and acts only on verdicts against its own
      rank (flag -> abort);
    - the FleetSupervisor holds one and drains any verdicted replica;
    - tests drive :meth:`observe` directly with synthetic snapshots.

    ``observe(records)`` consumes one window — the latest heartbeat
    snapshot — and returns ``{rank: SLOW | ABORT}`` for the verdicts
    ISSUED this window (an empty dict is the healthy steady state).
    ``slow_now`` holds the ranks the current window measured slow
    (pre-strike/cooldown gating), for introspection."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.zmax = float(cfg.zmax)
        self.rel_threshold = float(cfg.rel_threshold)
        self.warmup = int(cfg.warmup)
        self.strike_window = max(1, int(cfg.strike_window))
        self.cooldown = int(cfg.cooldown)
        self.abort_after = int(cfg.abort_after)
        self.windows = 0                      # complete windows consumed
        self.strikes: Dict[int, int] = {}     # consecutive slow windows
        self.verdicts: Dict[int, int] = {}    # rank -> window of last verdict
        self.persist: Dict[int, int] = {}     # slow windows since verdict
        self.slow_now: set = set()

    def _slow(self, value: float, others: list) -> bool:
        """Is ``value`` slow relative to the OTHER ranks' gauges?

        Leave-one-out: the judged rank's own gauge must not sit in the
        baseline — with it included, a 2-rank world can NEVER cross a
        ``rel_threshold >= 2`` (x > t*(x+f)/2 has no solution), and even
        in larger worlds the straggler drags the median toward itself.
        The others' median IS the world's pace without the suspect."""
        med = _median(others)
        if med <= 0.0:
            return False
        if value <= self.rel_threshold * med:
            # the relative floor: a uniformly-slow world raises the
            # others' median with it, so nobody crosses — the
            # false-positive guard the acceptance tests pin
            return False
        if len(others) < 4:
            return True                       # small world: ratio only
        rr = RollingRobust(window=len(others))
        for v in others:
            rr.push(v)
        o_med, sigma = rr.stats()             # never None at >= 4
        return (value - o_med) / sigma > self.zmax

    def observe(self, records: Dict[int, dict]) -> Dict[int, str]:
        gauges: Dict[int, float] = {}
        for rank, rec in records.items():
            ms = record_step_ms(rec)
            if ms is not None:
                gauges[int(rank)] = ms
        if len(gauges) < 2:
            # one gauge is not a distribution: never a verdict (and not a
            # window — warmup must count only comparable windows)
            self.slow_now = set()
            return {}
        self.windows += 1
        self.slow_now = {
            rank for rank, v in gauges.items()
            if self._slow(v, [g for r2, g in gauges.items() if r2 != rank])}
        out: Dict[int, str] = {}
        for rank in gauges:
            if rank in self.slow_now:
                self.strikes[rank] = self.strikes.get(rank, 0) + 1
            else:
                # a clean window retires the whole arm for this rank:
                # strikes, the post-verdict persistence count, and (once
                # the cooldown lapses) eligibility for a fresh verdict
                self.strikes[rank] = 0
                self.persist.pop(rank, None)
                continue
            if self.windows <= self.warmup:
                continue                      # warmup feeds the baseline
            if rank in self.persist:
                # already verdicted: count persistence toward the abort
                self.persist[rank] += 1
                if 0 < self.abort_after <= self.persist[rank]:
                    out[rank] = ABORT
                continue
            if self.strikes[rank] < self.strike_window:
                continue
            last = self.verdicts.get(rank)
            if last is not None and self.windows - last <= self.cooldown:
                continue                      # debounced: one event, one strike
            self.verdicts[rank] = self.windows
            self.persist[rank] = 0
            out[rank] = SLOW
        return out

    def forget(self, rank: int) -> None:
        """Drop all per-rank state — the fleet calls this after draining
        a replica so its warmed replacement starts from a clean slate
        (the cooldown stamp stays, debouncing an immediate re-verdict)."""
        self.strikes.pop(rank, None)
        self.persist.pop(rank, None)
