"""Local fabric backend — in-process queue with a placement hook.

The CPU-testable reference: frames are passed BY REFERENCE through a
bounded-lock deque (zero-copy — the disagg block handoff moves pool
block ownership, not tensor bytes), with an optional ``place`` hook
that moves the payload onto the receiving side's device at send time
(an explicit device-to-device hop). No framing, no CRC — there is no wire — but the
same ``net.send`` / ``net.recv`` / ``net.slow`` chaos surface as the
socket backend, so every in-process matrix exercises the identical
failure model the cross-process one does.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

from ...testing import chaos
from .endpoint import ChannelClosed, ChannelTimeout, Endpoint

#: bound on internal queue-lock holds — the critical sections are
#: pointer swaps; a starved waiter is facing a wedged holder
_MU_TIMEOUT = 5.0


class LocalEndpoint(Endpoint):
    """Loopback endpoint: ``send`` appends to the queue, ``recv`` pops.

    ``recv(timeout=0)`` is non-blocking (in-process pipelines are
    synchronous — an empty queue is a schedule bug, surfaced as an
    immediate :class:`ChannelTimeout`); a positive timeout waits on the
    queue condition (the handoff consumer's deadline-aware pop).
    ``place(meta, payload)`` runs at send time under no lock."""

    def __init__(self, ident: str = "local",
                 place: Optional[Callable[[dict, Any], Any]] = None,
                 fence: bool = False):
        self.ident = ident
        self.generation = 0
        self._place = place
        self._fence = fence
        self._q: deque = deque()
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._closed = False

    def send(self, meta: dict, payload: Any = b"", *,
             key: Optional[str] = None, **kw) -> None:
        k = key or self.ident
        chaos.failpoint("net.slow", key=k)
        chaos.failpoint("net.send", key=k)
        if self._closed:
            raise ChannelClosed(f"{self.ident}: endpoint closed")
        if self._place is not None:
            payload = self._place(meta, payload)
        frame = (dict(meta, gen=self.generation), payload)
        with self._cond:
            self._q.append(frame)
            self._cond.notify()

    def recv(self, timeout: Optional[float] = 0.0, *,
             key: Optional[str] = None) -> Tuple[dict, Any]:
        chaos.failpoint("net.recv", key=key or self.ident)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                while self._q:
                    meta, payload = self._q.popleft()
                    if self._fence and "cmd" not in meta and \
                            meta.get("gen", self.generation) \
                            != self.generation:
                        continue        # stale epoch — dropped at receipt
                    return meta, payload
                if self._closed:
                    raise ChannelClosed(f"{self.ident}: endpoint closed")
                left = (1.0 if deadline is None
                        else deadline - time.monotonic())
                if left <= 0:
                    raise ChannelTimeout(
                        f"{self.ident}: no frame within {timeout}s")
                self._cond.wait(timeout=min(left, 1.0))

    # ------------------------------------------------- queue introspection
    # (the handoff's bounded-capacity and deadline-shed logic lives in
    # its owner; the fabric exposes the primitives)

    def pending(self) -> int:
        with self._mu:
            return len(self._q)

    def peek_all(self) -> List[Tuple[dict, Any]]:
        with self._mu:
            return list(self._q)

    def purge(self, pred: Callable[[dict, Any], bool]
              ) -> List[Tuple[dict, Any]]:
        """Remove and return every queued frame matching ``pred`` —
        the deadline-shed primitive (atomic under the queue lock)."""
        with self._mu:
            hit = [f for f in self._q if pred(f[0], f[1])]
            if hit:
                self._q = deque(f for f in self._q
                                if not pred(f[0], f[1]))
        return hit

    def clear(self) -> List[Tuple[dict, Any]]:
        """Drop every queued frame (park: in-flight transfers of an
        abandoned step must not leak into the replay)."""
        with self._mu:
            dropped = list(self._q)
            self._q.clear()
        return dropped

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
