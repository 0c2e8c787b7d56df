"""Traffic-shaped replica autoscaling: the policy half (counterpart of
``deepspeed_tpu/serving/autoscale.py``, the same decisions on the same
observations).

The fleet already reacts to *faults* through supervised evidence — a
dead thread, heartbeat silence, a straggler verdict. This module applies
the same evidence-driven discipline to *load*: every supervisor poll
feeds an :class:`Observation` (the fleet's OWN SERVE heartbeat gauges —
queue depth, active lanes, live/warming replica counts, deadline
pressure) into an :class:`AutoscalePolicy`, which answers ``"up"``,
``"down"``, or ``None``.

Design contract:

* **Deterministic and clock-injectable.** The policy holds no threads
  and does no I/O: ``observe(obs, now)`` is a pure state machine over
  explicit timestamps, so the false-flap guards are unit tests with a
  fake clock, not sleeps.
* **Hysteresis + cooldown, both directions.** A scale-up needs
  ``up_after`` CONSECUTIVE overloaded observations; a scale-down needs
  an unbroken ``down_idle_s`` seconds of idle trough. After ANY verdict
  ``cooldown_s`` must pass before the next — a single burst causes at
  most one event (pinned test).
* **Warming is not idleness.** While any replica is warming (compiling
  off-path before taking traffic) the policy issues NO verdict at all:
  the warming replica is capacity already in flight (scaling up again
  would overshoot) and its heartbeat silence is compile, not an idle
  fleet (scaling down would flap). Pinned test.
* **Bounds.** ``min_replicas <= live <= max_replicas`` — the parole
  floor and the chip budget. The DECISION is bounded here; the
  MECHANISM (warmed spawn / drain-then-teardown) lives in the fleets.

The mechanism half — spawning a warmed replica, draining one through
the straggler-drain path, stamping scale events into the heartbeat
channel — lives in serving/fleet.py and serving/procfleet.py; both feed
this one policy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

#: reserved heartbeat rank for the autoscaler's own record: scale events
#: are operator evidence, so they land in the SAME channel `dstpu
#: health` reads — far above any replica index (replicas grow from 0,
#: bounded by max_replicas).
AUTOSCALER_RANK = 999

SCALE_UP, SCALE_DOWN = "up", "down"


@dataclass
class Observation:
    """One supervisor poll's view of the fleet, in gauge terms (the same
    numbers the replicas stamp into their SERVE heartbeats)."""
    queue_depth: int = 0       # shared admission queue length
    pressured: int = 0         # queued requests near their deadline
    live: int = 0              # LIVE replicas taking traffic (not draining)
    warming: int = 0           # replicas spawned but still compiling
    draining: int = 0          # replicas winding down (scale-down in flight)
    active_lanes: int = 0      # busy decode lanes across live replicas
    total_lanes: int = 0       # capacity: live replicas x max_batch


@dataclass
class ScaleEvent:
    """One autoscaling verdict, as recorded in ``fleet.scale_events``
    and stamped into the heartbeat channel (the death-ledger idiom,
    applied to capacity)."""
    action: str                # "up" | "down" | "up_failed"
    replica: int               # replica index spawned / drained (-1: none)
    reason: str                # trigger, human- and machine-readable
    ts: float                  # monotonic timestamp of the verdict
    queue: int                 # queue depth at the verdict
    live: int                  # live replica count at the verdict
    drained_ts: Optional[float] = None   # scale-down: drain completion
    error: Optional[str] = None          # up_failed / drain-by-death detail

    def as_gauges(self) -> dict:
        return {"event": f"{self.action}@r{self.replica}",
                "reason": self.reason, "queue": self.queue,
                "live": self.live}


class AutoscalePolicy:
    """Queue-depth + deadline-pressure triggers behind hysteresis,
    cooldown, and min/max bounds. One instance per fleet; the supervisor
    calls :meth:`observe` once per poll."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.min_replicas = max(1, int(cfg.min_replicas))
        self.max_replicas = max(self.min_replicas, int(cfg.max_replicas))
        self._hot_streak = 0           # consecutive overloaded polls
        self._idle_since: Optional[float] = None
        self._last_event_ts: Optional[float] = None

    # ------------------------------------------------------------- triggers

    def _overloaded(self, obs: Observation) -> bool:
        if obs.pressured > 0:
            return True
        capacity = max(obs.live, 1)
        return obs.queue_depth > self.cfg.up_queue_per_replica * capacity

    def _idle(self, obs: Observation) -> bool:
        return obs.queue_depth == 0 and obs.active_lanes == 0

    # -------------------------------------------------------------- verdict

    def observe(self, obs: Observation,
                now: Optional[float] = None) -> Optional[str]:
        """Feed one poll's gauges; returns ``"up"``/``"down"``/``None``.
        The caller performs the mechanism and the policy's cooldown
        starts at the verdict — a failed spawn still debounces (the
        condition that caused it is still being answered)."""
        if now is None:
            now = time.monotonic()
        if obs.warming > 0:
            # warming capacity is an answer in flight: no verdict either
            # direction until it lands (false-flap guard, pinned test)
            self._hot_streak = 0
            self._idle_since = None
            return None
        overloaded = self._overloaded(obs)
        self._hot_streak = self._hot_streak + 1 if overloaded else 0
        if self._idle(obs):
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None
        if self._last_event_ts is not None \
                and (now - self._last_event_ts) < self.cfg.cooldown_s:
            return None
        if overloaded and self._hot_streak >= max(1, self.cfg.up_after) \
                and obs.live + obs.warming < self.max_replicas:
            self._last_event_ts = now
            self._hot_streak = 0
            return SCALE_UP
        if self._idle_since is not None \
                and (now - self._idle_since) >= self.cfg.down_idle_s \
                and obs.live - obs.draining > self.min_replicas:
            self._last_event_ts = now
            self._idle_since = None
            return SCALE_DOWN
        return None

    def describe(self, obs: Observation) -> str:
        """The reason string a verdict records (scale-event ledger)."""
        if obs.pressured > 0:
            return f"deadline_pressure={obs.pressured}"
        if self._overloaded(obs):
            return (f"queue={obs.queue_depth}>"
                    f"{self.cfg.up_queue_per_replica}x{max(obs.live, 1)}")
        return f"idle_trough>={self.cfg.down_idle_s}s"


__all__ = ["AUTOSCALER_RANK", "SCALE_UP", "SCALE_DOWN", "Observation",
           "ScaleEvent", "AutoscalePolicy"]
