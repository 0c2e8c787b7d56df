"""Inter-stage transfer channels: the explicit seam of the stage
interpreter (counterpart of ``deepspeed_tpu/runtime/pipe/mpmd/
channel.py``).

The interpreter (``executor.py``) hands each stage's outgoing activation
or cotangent to ``send`` and takes each incoming one from ``recv``; what
moves it is the channel:

* :class:`LocalChannel`: one process holds every stage (the JAX
  package's ``MPMDPipeline(devices=[...])``). A FIFO per (kind, edge);
  a payload moves to the receiving stage's device with ``.to(device)``.
* :class:`SocketChannel`: each stage is its own OS process (the stage
  worker, ``stage_worker.py``): payloads ride fabric frames
  (``runtime/fabric``: CRC framing, generation fencing, redial) over ONE
  TCP connection to the driver (``driver.py``), which routes them stage
  to stage — a star, so a restarted stage just reconnects. A payload
  crosses as its bytes (host bounce) and lands on the stage's device.
  Control frames (park / resync / stop) share the connection; one that
  arrives while a receive waits surfaces as :class:`ParkSignal`.
* :class:`PipeGroupChannel`: each rank of the mesh's ``pipe`` axis holds
  one stage. Its group is the caller's own ``pipe`` group: the ranks of
  its ``(data, expert, seq, model)`` coordinate, one a stage, so a
  payload goes to the neighbouring stage of the same data, expert and
  model coordinates. Every rank knows the clock tables, so the transfers
  of one tick and kind are one counted ``comm.ppermute`` over ``pipe``
  whose permutation holds only the edges that send at that tick; every
  rank joins it, in the same order (activations, then cotangents), so no
  rank waits on a transfer another has not posted. The boundary is the
  stage input's shape ``[mb, S, H]`` in the compute dtype on every edge.

Ordering contract: the clock tables send each edge's payloads in strictly
increasing micro order, so a FIFO per (kind, destination) suffices;
``recv`` checks the micro id it pops and raises on a schedule violation
instead of consuming the wrong tensor. Every send and recv traverses the
``pipe.xfer`` failpoint (keyed ``"<kind>:<src>-><dst>"``) of
``testing/chaos.py``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ....testing import chaos
# re-exported: the exceptions are the channel's public contract, owned by
# the fabric (the stage worker, the driver and tests import them here)
from ...fabric import (ChannelClosed, ChannelTimeout,  # noqa: F401
                       RedialPolicy, SocketEndpoint)

#: transfer kinds: activations flow downstream, cotangents upstream
KIND_ACT = "act"
KIND_GRAD = "grad"


def _inbound(kind: str, dst: int) -> str:
    """The failpoint key of the edge that brings ``kind`` to ``dst``."""
    src = dst - 1 if kind == KIND_ACT else dst + 1
    return f"{kind}:{src}->{dst}"


class LocalChannel:
    """In-process FIFO channel. ``placements``: optional {stage: device};
    a payload sent to a stage with a placement moves there at send time
    (the device-to-device hop). Without one the payload is handed over as
    it is."""

    def __init__(self, placements: Optional[Dict[int, Any]] = None):
        self.placements = placements or {}
        self._q: Dict[Tuple[str, int], deque] = defaultdict(deque)

    def begin(self, tables, boundary=None) -> None:
        """A walk of ``tables`` starts (nothing to set up in-process)."""

    def end_tick(self, t: int) -> None:
        """Tick ``t`` of the walk is done (in-process sends are already
        queued)."""

    def send(self, kind: str, src: int, dst: int, micro: int,
             payload) -> None:
        chaos.failpoint("pipe.xfer", key=f"{kind}:{src}->{dst}")
        dev = self.placements.get(dst)
        if dev is not None and isinstance(payload, torch.Tensor):
            payload = payload.to(dev)
        self._q[(kind, dst)].append((int(micro), payload))

    def recv(self, kind: str, dst: int, micro: int):
        q = self._q[(kind, dst)]
        if not q:
            # in-process execution is synchronous: an empty queue is a
            # schedule bug, not a slow peer
            raise ChannelTimeout(
                f"no {kind} payload queued for stage {dst} (micro {micro})")
        chaos.failpoint("pipe.xfer", key=_inbound(kind, dst))
        got, payload = q.popleft()
        if got != micro:
            raise RuntimeError(
                f"schedule violation: stage {dst} expected {kind} of micro "
                f"{micro}, channel delivered micro {got}")
        return payload

    def pending(self, kind: str, dst: int) -> int:
        return len(self._q[(kind, dst)])

    def clear(self) -> None:
        """Drop every queued payload (an abandoned step's transfers must
        not leak into the next)."""
        self._q.clear()


class PipeGroupChannel:
    """This rank's end of the ``pipe`` axis: it holds stage ``stage``
    (its index on ``axis``) of a pipeline whose clock tables every rank
    builds alike. ``send`` keeps the payload until the tick ends;
    :meth:`end_tick` runs the tick's transfers, one ``comm.ppermute`` per
    kind that any stage sends at that tick, every rank taking part."""

    def __init__(self, stage: int, axis: str = "pipe"):
        from .... import comm
        self.stage, self.axis = int(stage), axis
        self.pp = comm.axis_size(axis)
        if not 0 <= self.stage < self.pp:
            raise ValueError(f"stage {stage} of a '{axis}' axis of "
                             f"{self.pp}")
        self._out: Dict[Tuple[str, int], torch.Tensor] = {}
        self._q: Dict[str, deque] = defaultdict(deque)
        self._tables = None
        self._zeros: Optional[torch.Tensor] = None

    def begin(self, tables, boundary) -> None:
        """A walk of ``tables`` starts; ``boundary`` is (shape, dtype,
        device) of the payload every edge carries."""
        shape, dtype, device = boundary
        if self._out or any(self._q.values()):
            raise RuntimeError("pipe channel: payloads left from the last "
                               "walk")
        self._tables = tables
        if self._zeros is None or tuple(self._zeros.shape) != tuple(shape) \
                or self._zeros.dtype != dtype \
                or self._zeros.device != torch.device(device):
            self._zeros = torch.zeros(shape, dtype=dtype, device=device)

    def send(self, kind: str, src: int, dst: int, micro: int,
             payload: torch.Tensor) -> None:
        chaos.failpoint("pipe.xfer", key=f"{kind}:{src}->{dst}")
        if src != self.stage or abs(dst - src) != 1:
            raise ValueError(f"pipe channel of stage {self.stage}: cannot "
                             f"send {kind} {src}->{dst}")
        self._out[(kind, int(micro))] = payload

    def end_tick(self, t: int) -> None:
        from .... import comm
        tabs = self._tables
        for kind, table, step in ((KIND_ACT, tabs["fwd"], 1),
                                  (KIND_GRAD, tabs["bwd"], -1)):
            row = [int(m) for m in table[t]]
            perm = [(s, s + step) for s in range(self.pp)
                    if row[s] >= 0 and 0 <= s + step < self.pp]
            if not perm:
                continue
            me = self.stage
            mine = row[me] if any(a == me for a, _ in perm) else None
            payload = (self._out.pop((kind, mine)) if mine is not None
                       else self._zeros)
            if payload.shape != self._zeros.shape or \
                    payload.dtype != self._zeros.dtype:
                raise ValueError(
                    f"pipe channel: {kind} payload {tuple(payload.shape)} "
                    f"{payload.dtype}, the boundary is "
                    f"{tuple(self._zeros.shape)} {self._zeros.dtype}")
            got = comm.ppermute(payload.contiguous(), perm, axis=self.axis)
            src = next((a for a, b in perm if b == me), None)
            if src is not None:
                self._q[kind].append((row[src], got))
        if self._out:
            raise RuntimeError(f"pipe channel: sends {sorted(self._out)} "
                               f"that tick {t} of the tables does not carry")

    def recv(self, kind: str, dst: int, micro: int):
        chaos.failpoint("pipe.xfer", key=_inbound(kind, dst))
        q = self._q[kind]
        if dst != self.stage or not q:
            raise ChannelTimeout(
                f"no {kind} payload arrived for stage {dst} (micro {micro})")
        got, payload = q.popleft()
        if got != micro:
            raise RuntimeError(
                f"schedule violation: stage {dst} expected {kind} of micro "
                f"{micro}, channel delivered micro {got}")
        return payload

    def clear(self) -> None:
        self._out.clear()
        self._q.clear()


# ------------------------------------------------------------ payload codec

_DTYPES = {str(d): d for d in (torch.float32, torch.float16, torch.bfloat16,
                               torch.float64, torch.int64, torch.int32)}


def _to_bytes(t: torch.Tensor) -> Tuple[dict, bytes]:
    """A tensor's dtype and shape, and its bytes (one device-to-host
    copy)."""
    t = t.detach().contiguous()
    raw = t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    return {"dtype": str(t.dtype), "shape": list(t.shape)}, raw


def _from_bytes(meta: dict, raw: bytes, device) -> torch.Tensor:
    host = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    t = host.view(_DTYPES[meta["dtype"]]).reshape(meta["shape"])
    return t.to(device) if device is not None else t


class SocketChannel:
    """One stage's endpoint of the host-bounce star (module docstring).
    The fabric :class:`SocketEndpoint` owns the connection: dial backoff,
    CRC framing, the bounded write lock, mid-stream redial and generation
    fencing (frames of an abandoned park/resync generation are dropped at
    receipt).

    Data frames ({kind, src, dst, micro, dtype, shape} + the tensor's
    bytes) interleave with CONTROL frames ({cmd: park|resync|stop, ...})
    from the driver on the same connection; :meth:`recv` parks control
    frames on a side queue for the worker loop (:meth:`poll_control`),
    and one that arrives while a receive waits raises
    :class:`ParkSignal`, so the worker abandons its in-flight step.

    As the interpreter's channel (``executor.MPMDPipeline``): ``recv``
    waits at most ``timeout`` seconds (:class:`ChannelTimeout` past it)
    inside ``waiting()`` (the stage worker suspends its step watchdog
    there: a late peer is the channel's business, a wedged compute the
    watchdog's), and a payload lands on the device of the walk's
    boundary. ``bytes_sent`` / ``bytes_recv`` / ``send_s`` /
    ``wait_s`` count the traffic."""

    def __init__(self, driver_addr: Tuple[str, int], stage: int,
                 resume_step: int = 0, connect_timeout: float = 30.0,
                 timeout: Optional[float] = None,
                 waiting: Optional[Callable[[], Any]] = None):
        self.stage = stage
        self.timeout = timeout
        self._waiting = waiting or contextlib.nullcontext
        self._device = None
        # the driver's welcome hands the CURRENT park/resync generation,
        # so a restarted stage's frames are accepted by the survivors
        self._ep = SocketEndpoint(
            driver_addr, ident=f"stage-{stage}",
            hello={"stage": stage, "resume_step": int(resume_step)},
            connect_timeout=connect_timeout,
            redial=RedialPolicy(attempts=2, base=0.05, dial_timeout=2.0))
        self._data: Dict[Tuple[str, int], deque] = defaultdict(deque)
        self._control: deque = deque()
        self.bytes_sent = self.bytes_recv = 0
        self.send_s = self.wait_s = 0.0

    @property
    def generation(self) -> int:
        """Park/resync generation (the fabric endpoint stamps every data
        frame with it and fences receipt); the resync path assigns it."""
        return self._ep.generation

    @generation.setter
    def generation(self, gen: int) -> None:
        self._ep.generation = int(gen)

    # -- the interpreter's channel interface ---------------------------------

    def begin(self, tables, boundary=None) -> None:
        """A walk starts: payloads land on the boundary's device."""
        if boundary is not None:
            self._device = boundary[2]

    def end_tick(self, t: int) -> None:
        """Sends go out as they are made: nothing to do at a tick's end."""

    def clear(self) -> None:
        """An abandoned walk (the interpreter's error path)."""

    def send(self, kind: str, src: int, dst: int, micro: int,
             payload, lock_timeout: float = 30.0) -> None:
        edge = f"{kind}:{src}->{dst}"
        chaos.failpoint("pipe.xfer", key=edge)
        t0 = time.perf_counter()
        if isinstance(payload, torch.Tensor):
            meta, raw = _to_bytes(payload)
        else:
            arr = np.ascontiguousarray(payload)
            meta, raw = {"dtype": str(torch.from_numpy(arr).dtype),
                         "shape": list(arr.shape)}, arr.tobytes()
        self._ep.send(dict(meta, kind=kind, src=src, dst=dst,
                           micro=int(micro)),
                      raw, key=edge, lock_timeout=lock_timeout)
        self.bytes_sent += len(raw)
        self.send_s += time.perf_counter() - t0

    def send_control(self, meta: dict, lock_timeout: float = 30.0) -> None:
        self._ep.send(meta, b"", lock_timeout=lock_timeout)

    def _pump_one(self, timeout: Optional[float]) -> None:
        meta, payload = self._ep.recv(timeout)
        if "cmd" in meta:
            self._control.append(meta)
        else:
            self.bytes_recv += len(payload)
            self._data[(meta["kind"], meta["micro"])].append(
                (meta, payload))

    def recv(self, kind: str, dst: int, micro: int,
             timeout: Optional[float] = None) -> torch.Tensor:
        assert dst == self.stage
        timeout = self.timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.perf_counter()
        try:
            with self._waiting():
                while True:
                    q = self._data.get((kind, int(micro)))
                    if q:
                        meta, raw = q.popleft()
                        return _from_bytes(meta, raw, self._device)
                    if self._control:
                        # a park/stop arrived while we waited at the
                        # barrier: the step is over
                        raise ParkSignal(self._control[0].get("cmd",
                                                              "park"))
                    left = (None if deadline is None
                            else max(0.0, deadline - time.monotonic()))
                    if left == 0.0:
                        raise ChannelTimeout(
                            f"stage {self.stage}: no {kind} for micro "
                            f"{micro} within {timeout}s")
                    self._pump_one(left)
        finally:
            self.wait_s += time.perf_counter() - t0

    # -- control ---------------------------------------------------------------

    def poll_control(self, timeout: float = 0.0) -> Optional[dict]:
        """Next control frame if one is queued (or arrives within
        ``timeout``); data frames pumped meanwhile stay queued."""
        if timeout == 0.0:
            if not self._control:
                try:
                    self._pump_one(0.001)
                except (ChannelTimeout, ChannelClosed):
                    pass
            return self._control.popleft() if self._control else None
        deadline = time.monotonic() + timeout
        while True:
            if self._control:
                return self._control.popleft()
            left = max(0.0, deadline - time.monotonic())
            if left == 0.0:
                return None
            try:
                self._pump_one(left)
            except ChannelTimeout:
                return None

    def wait_control(self, cmd: str, timeout: float) -> dict:
        """Block until a control frame with ``cmd`` arrives (frames of
        other commands are consumed and dropped)."""
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise ChannelTimeout(f"no '{cmd}' control within {timeout}s")
            got = self.poll_control(timeout=left)
            if got is not None and got.get("cmd") == cmd:
                return got

    def clear_data(self) -> None:
        self._data.clear()

    def close(self) -> None:
        self._ep.close()


class ParkSignal(Exception):
    """Raised out of a blocked recv when the driver parks the pipeline:
    the worker abandons the in-flight step and enters the park loop."""

    def __init__(self, cmd: str):
        super().__init__(cmd)
        self.cmd = cmd
