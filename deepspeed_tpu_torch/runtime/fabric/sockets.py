"""Socket fabric backend — the hardened star spoke.

One TCP connection to a hub (the process fleet's dispatcher). The handshake is hello/welcome: the spoke sends
``{"cmd": "hello", "ident": ..., **hello}``, the hub answers
``{"cmd": "welcome", "gen": G}`` and G becomes the spoke's generation —
every data frame is stamped with it, and both directions drop data
frames from any other generation at receipt (a reconnected peer's
stale in-flight frames can never leak into the new epoch).

Failure handling (the hardening the bespoke transports used to
half-implement each):

* dial: backoff-retried until the connect deadline (``net.connect``
  fires per attempt), then :class:`ChannelClosed`;
* mid-stream ``OSError`` on send OR recv: the :class:`RedialPolicy`
  ladder — bounded attempts, exponential jittered backoff, full
  re-handshake (fresh generation) — and the failed send is re-issued
  on the new connection with the NEW generation, so a
  maybe-delivered duplicate of the old frame is fenced out at the
  receiver; exhausted attempts raise :class:`ChannelClosed`;
* recv deadline: :class:`ChannelTimeout`;
* CRC mismatch: :class:`FrameCorrupt` (peer-fatal, no redial — the
  stream is desynchronized);
* writes serialize under a BOUNDED per-connection lock — a peer wedged
  mid-read starves the next writer into :class:`WriteLockStarved`
  (an ``OSError``) instead of wedging it.
"""

from __future__ import annotations

import select
import socket
import threading
import time
from collections import deque
from typing import Optional, Tuple

from ...testing import chaos
from .endpoint import (ChannelClosed, ChannelTimeout, Endpoint,
                       FrameCorrupt, RedialPolicy, WriteLockStarved)
from .frame import read_frame, write_frame

#: seconds a frame that has started to arrive may take to finish
MID_FRAME_S = 30.0


class SocketEndpoint(Endpoint):
    """Spoke endpoint of the star (module docstring has the contract).

    ``hello`` is extra meta for the handshake frame (a replica worker
    rides ``replica``/``pid`` on it); ``redial=None`` disables
    mid-stream reconnect (first link loss is peer-fatal)."""

    def __init__(self, addr: Tuple[str, int], ident: str, *,
                 hello: Optional[dict] = None,
                 connect_timeout: float = 30.0,
                 redial: Optional[RedialPolicy] = None,
                 fence: bool = True,
                 lock_timeout: float = 30.0):
        self.addr = addr
        self.ident = ident
        self.generation = 0
        self._hello = dict(hello or {})
        self._redial = redial
        self._fence = fence
        self._lock_timeout = float(lock_timeout)
        self._wlock = threading.Lock()
        self._pending: deque = deque()   # control frames read pre-welcome
        self._closed = False
        self._sock: Optional[socket.socket] = None
        self._dial(connect_timeout)

    # ------------------------------------------------------------- dialing

    def _dial(self, budget: float) -> None:
        """Connect + handshake within ``budget`` seconds, backoff-retrying
        refused dials (the hub may still be binding, or mid-restart)."""
        deadline = time.monotonic() + budget
        attempt = 0
        last_err: Optional[Exception] = None
        while True:
            try:
                chaos.failpoint("net.connect", key=self.ident)
                sock = socket.create_connection(self.addr, timeout=5.0)
                break
            except OSError as e:
                last_err = e
                if time.monotonic() >= deadline:
                    raise ChannelClosed(
                        f"{self.ident}: cannot reach hub at "
                        f"{self.addr}: {last_err}")
                RedialPolicy(base=0.05, cap=0.5).sleep(attempt)
                attempt += 1
        self._sock = sock
        try:
            sock.settimeout(None)
            write_frame(sock, {"cmd": "hello", "ident": self.ident,
                               **self._hello})
            welcome = self._read_until_welcome(
                max(0.1, deadline - time.monotonic()))
        except ChannelTimeout:
            # no welcome: the half-open socket must not outlive the
            # failed handshake — a leaked fd per redial attempt adds up
            try:
                sock.close()
            finally:
                self._sock = None
            raise
        except OSError as e:
            try:
                sock.close()
            finally:
                self._sock = None
            raise ChannelClosed(
                f"{self.ident}: handshake with hub failed: {e}")
        self.generation = int(welcome.get("gen", 0))

    def _read_until_welcome(self, timeout: float) -> dict:
        """Consume frames until the welcome; control frames seen first
        are parked for recv (a broadcast can race the handshake)."""
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise ChannelTimeout(
                    f"{self.ident}: no welcome within {timeout}s")
            self._sock.settimeout(left)
            try:
                meta, payload = read_frame(self._sock)
            except socket.timeout:
                raise ChannelTimeout(
                    f"{self.ident}: no welcome within {timeout}s")
            finally:
                self._sock.settimeout(None)
            if meta.get("cmd") == "welcome":
                return meta
            self._pending.append((meta, payload))

    def _redial_or_raise(self, err: Exception, attempt: int) -> int:
        pol = self._redial
        if self._closed or pol is None or attempt >= pol.attempts:
            raise ChannelClosed(
                f"{self.ident}: link lost"
                + (f" and {attempt} redial(s) exhausted" if pol else "")
                + f": {err}")
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        pol.sleep(attempt)
        self._dial(pol.dial_timeout)     # fresh generation via welcome
        return attempt + 1

    # ---------------------------------------------------------------- send

    def send(self, meta: dict, payload: bytes = b"", *,
             key: Optional[str] = None,
             lock_timeout: Optional[float] = None) -> None:
        k = key or self.ident
        chaos.failpoint("net.slow", key=k)
        chaos.failpoint("net.send", key=k)
        bound = self._lock_timeout if lock_timeout is None else lock_timeout
        attempt = 0
        while True:
            try:
                chaos.failpoint("net.partition", key=k)
                # the frame is packed INSIDE the retry loop: a redial
                # bumps the generation, and the re-sent frame must carry
                # the new one (the maybe-delivered original is fenced)
                self._locked_write(
                    dict(meta, gen=self.generation), payload, bound, k)
                return
            except (WriteLockStarved, FrameCorrupt):
                raise                    # not link faults — no redial
            except OSError as e:
                attempt = self._redial_or_raise(e, attempt)

    def _locked_write(self, meta: dict, payload: bytes,
                      lock_timeout: float, key: str) -> None:
        if not self._wlock.acquire(timeout=lock_timeout):
            raise WriteLockStarved(
                f"{self.ident}: channel write lock starved for "
                f"{lock_timeout}s (peer wedged mid-frame?)")
        try:
            write_frame(self._sock, meta, payload, key=key)
        finally:
            self._wlock.release()

    # ---------------------------------------------------------------- recv

    def recv(self, timeout: Optional[float] = None, *,
             key: Optional[str] = None) -> Tuple[dict, bytes]:
        k = key or self.ident
        deadline = None if timeout is None else time.monotonic() + timeout
        attempt = 0
        while True:
            if self._pending:
                meta, payload = self._pending.popleft()
            else:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0:
                    # timeout=0 is a POLL, not a no-op: a frame already
                    # on the wire must be deliverable (the serve loop
                    # drains commands between engine steps this way)
                    try:
                        readable, _, _ = select.select(
                            [self._sock], [], [], 0)
                    except (OSError, ValueError):
                        readable = []
                    if not readable:
                        raise ChannelTimeout(
                            f"{self.ident}: transfer barrier deadline "
                            f"exceeded ({timeout}s)")
                    # readable: a frame header is in flight — bound the
                    # read anyway (a peer wedged mid-frame must not
                    # wedge the poll)
                    left = 1.0
                try:
                    chaos.failpoint("net.partition", key=k)
                    meta, payload = self._read_one(left)
                except ChannelTimeout:
                    raise
                except FrameCorrupt:
                    raise                # peer-fatal, stream torn
                except OSError as e:
                    if self._closed:
                        raise ChannelClosed(
                            f"{self.ident}: endpoint closed")
                    attempt = self._redial_or_raise(e, attempt)
                    continue
            if meta.get("cmd") == "welcome":
                # hub-side epoch bump mid-stream (park/resync hands the
                # new generation through the control path instead)
                self.generation = int(meta.get("gen", self.generation))
                continue
            chaos.failpoint("net.recv", key=k)
            if "cmd" not in meta and self._fence and \
                    meta.get("gen", self.generation) != self.generation:
                continue    # stale-generation data frame — dropped
            return meta, payload

    def _read_one(self, timeout: Optional[float]
                  ) -> Tuple[dict, bytes]:
        """One frame. ``timeout`` (None: none) bounds the wait for the
        frame to START: once its first byte is readable the whole frame is
        read under the mid-frame bound, since a deadline that fired mid-frame
        would drop
        the bytes already read and leave the stream out of step with its
        frame boundaries (every later read would parse payload bytes as a
        header). A frame that stalls mid-way past the bound is a torn
        stream: :class:`FrameCorrupt`."""
        try:
            # no deadline (None): wait as long as the peer is quiet
            readable, _, _ = select.select([self._sock], [], [], timeout)
        except ValueError as e:           # closed under us
            raise OSError(str(e)) from e
        if not readable:
            raise ChannelTimeout("transfer barrier deadline exceeded")
        self._sock.settimeout(MID_FRAME_S)
        try:
            return read_frame(self._sock)
        except socket.timeout:
            raise FrameCorrupt(
                f"{self.ident}: a frame stalled mid-way for "
                f"{MID_FRAME_S}s — stream torn")
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:
                pass                     # socket died mid-read

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        self._closed = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class HubConn:
    """Hub-side half of one spoke connection: framed writes under a
    BOUNDED per-connection lock (a spoke wedged mid-read starves the
    next writer into an ``OSError`` instead of wedging the router).
    The hub's accept loop reads the hello itself (it routes on it) and
    answers with the welcome carrying the spoke's generation."""

    def __init__(self, sock: socket.socket, ident: str = "",
                 gen: int = 0):
        self.sock = sock
        self.ident = ident
        self.gen = int(gen)
        self.wlock = threading.Lock()

    def send(self, meta: dict, payload: bytes = b"",
             lock_timeout: float = 5.0) -> None:
        if not self.wlock.acquire(timeout=lock_timeout):
            raise WriteLockStarved(
                f"hub connection write lock starved for {lock_timeout}s "
                f"(peer wedged mid-frame?)")
        try:
            write_frame(self.sock, meta, payload,
                        key=self.ident or None)
        finally:
            self.wlock.release()

    def welcome(self, lock_timeout: float = 5.0, **extra) -> None:
        self.send({"cmd": "welcome", "gen": self.gen, **extra},
                  lock_timeout=lock_timeout)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
