"""The fabric's channel contract: one `Endpoint`, one failure model.

Every cross-boundary transfer of the package — the disagg
prefill→decode block handoff, the process-placement fleet's
request/token streams — rides an :class:`Endpoint`. The contract:

* ``send(meta, payload)`` / ``recv(timeout)`` / ``close()`` — frames are
  (JSON meta, bytes-or-object payload) pairs, delivered FIFO per
  connection.
* **Generation fencing.** Every data frame is stamped with the
  endpoint's current ``generation`` (handed out by the hub at
  handshake, bumped on every reconnect and on park/resync). ``recv``
  drops data frames whose generation is not current — a reconnected
  peer's stale in-flight frames can never leak into the new epoch.
  Control frames (any meta carrying ``"cmd"``) bypass the fence.
* **Bounded jittered reconnect.** A dial failure backs off and retries
  until the connect deadline; a mid-stream ``OSError`` (link partition,
  peer reset) runs the :class:`RedialPolicy` ladder — bounded attempts,
  exponential backoff with jitter — and resumes with a FRESH generation
  from the hub's welcome. Exhausted attempts raise
  :class:`ChannelClosed`, the peer-fatal verdict.
* **Per-recv deadlines.** ``recv(timeout=...)`` past its deadline raises
  :class:`ChannelTimeout` — the "peer late or dead at the barrier"
  signal the park/resync protocol and the fleet requeue path consume.
* **Liveness stays in the heartbeat channel.** The fabric reports LINK
  verdicts only (``ChannelTimeout`` / ``ChannelClosed``); whether the
  PEER is dead is decided by the heartbeat channel
  (``runtime/heartbeat.py`` stale_ranks / terminal records) — a
  partitioned link must not be mistaken for a dead process.

Fault injection: the six ``net.*`` failpoints (connect/send/recv/
corrupt/partition/slow — see ``testing/chaos.py``) are traversed at
THIS layer, so every transport inherits the same chaos surface.
"""

from __future__ import annotations

import random
import time
from typing import Any, Optional, Tuple


class ChannelTimeout(IOError):
    """recv() exceeded its deadline — the sending peer is late or dead."""


class ChannelClosed(IOError):
    """The transport is gone (peer hangup / hub teardown / redial
    ladder exhausted)."""


class FrameCorrupt(OSError):
    """A frame failed its CRC32 check — peer-fatal: the stream can no
    longer be trusted (a torn frame desynchronizes the length-prefixed
    framing). Callers treat it exactly like a dead peer."""


class WriteLockStarved(OSError):
    """The bounded per-connection write lock could not be acquired — a
    peer wedged mid-read keeps ``sendall`` (and with it the frame lock)
    stuck; a writer starved past the bound is facing a dead peer and
    fails like one."""


class RedialPolicy:
    """Bounded jittered reconnect ladder for mid-stream link loss.

    ``attempts`` redials, sleeping ``min(cap, base * 2**k)`` scaled by a
    uniform ``1 ± jitter/2`` factor between tries (jitter decorrelates a
    fleet of spokes re-dialing a restarted hub). ``dial_timeout`` bounds
    each redial's connect phase — deliberately shorter than the initial
    connect budget: a redial races a supervisor that may already be
    restarting this process."""

    def __init__(self, attempts: int = 2, base: float = 0.05,
                 cap: float = 1.0, jitter: float = 0.5,
                 dial_timeout: float = 2.0):
        self.attempts = int(attempts)
        self.base = float(base)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self.dial_timeout = float(dial_timeout)

    def delay(self, attempt: int) -> float:
        d = min(self.cap, self.base * (2.0 ** attempt))
        return d * (1.0 + self.jitter * (random.random() - 0.5))

    def sleep(self, attempt: int) -> None:
        time.sleep(max(0.0, self.delay(attempt)))


class Endpoint:
    """The abstract channel endpoint (module docstring has the
    contract). Backends: :class:`~.local.LocalEndpoint` (in-process
    queue with a placement hook — the CPU-testable reference) and
    :class:`~.sockets.SocketEndpoint` (the hardened TCP star spoke)."""

    ident: str = "endpoint"
    generation: int = 0

    def send(self, meta: dict, payload: Any = b"", *,
             key: Optional[str] = None, **kw) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None, *,
             key: Optional[str] = None) -> Tuple[dict, Any]:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def __enter__(self) -> "Endpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
