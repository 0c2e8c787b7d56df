"""Inter-stage transfer channels: the explicit seam of the stage
interpreter (counterpart of ``deepspeed_tpu/runtime/pipe/mpmd/
channel.py``).

The interpreter (``executor.py``) hands each stage's outgoing activation
or cotangent to ``send`` and takes each incoming one from ``recv``; what
moves it is the channel:

* :class:`LocalChannel`: one process holds every stage (the JAX
  package's ``MPMDPipeline(devices=[...])``). A FIFO per (kind, edge);
  a payload moves to the receiving stage's device with ``.to(device)``.
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

from collections import defaultdict, deque
from typing import Any, Dict, Optional, Tuple

import torch

from ....testing import chaos

#: transfer kinds: activations flow downstream, cotangents upstream
KIND_ACT = "act"
KIND_GRAD = "grad"


def _inbound(kind: str, dst: int) -> str:
    """The failpoint key of the edge that brings ``kind`` to ``dst``."""
    src = dst - 1 if kind == KIND_ACT else dst + 1
    return f"{kind}:{src}->{dst}"


class ChannelTimeout(TimeoutError):
    """No payload for a receive: in a synchronous interpreter, a schedule
    bug, not a slow peer."""


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
