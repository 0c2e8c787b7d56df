"""Pipeline instruction schedules: pure Python, no device (counterpart
of ``deepspeed_tpu/runtime/pipe/schedule.py``; reference
``runtime/pipe/schedule.py``: the ``PipeSchedule`` classes, 1F1B's
``TrainSchedule``, ``InferenceSchedule`` and the instruction vocabulary).

The schedule half of the schedule / placement split: it decides which
micro-batch each stage forwards, backwards, sends and receives at every
clock tick. :func:`build_1f1b_tables` and :func:`build_gpipe_tables` give
the clock tables, and :func:`stage_instruction_stream` renders one
stage's view of them as per-tick instruction lists, which the port's one
executor (``mpmd/executor.py``) interprets against a transfer channel:
in one process over every stage, or one stage a rank over the mesh's
``pipe`` axis. The generator schedules (``TrainSchedule`` etc.) are the
reference's API view of the same discipline.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


# -- instruction vocabulary (reference: schedule.py:336-476) ------------------

class PipeInstruction:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
        return f"{type(self).__name__}({args})"

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class LoadMicroBatch(PipeInstruction):
    pass


class BufferOpInstruction(PipeInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


# -- schedules ---------------------------------------------------------------

class PipeSchedule:
    """Yields, per clock tick, the list of instructions one stage executes."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        if not 0 <= stage_id < stages:
            raise ValueError(f"stage_id {stage_id} out of range for {stages} stages")
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.stages - 1

    def num_pipe_buffers(self) -> int:
        return self.micro_batches

    def steps(self) -> Iterator[List[PipeInstruction]]:
        raise NotImplementedError

    def __iter__(self):
        return self.steps()

    def _buffer_idx(self, micro_batch_id: int) -> int:
        return micro_batch_id % self.num_pipe_buffers()


class InferenceSchedule(PipeSchedule):
    """Forward-only fill-drain: each tick forwards one microbatch downstream."""

    def num_pipe_buffers(self) -> int:
        return 2

    def steps(self):
        total = self.micro_batches + self.stages - 1
        for tick in range(total):
            cmds: List[PipeInstruction] = []
            mb = tick - self.stage_id
            if 0 <= mb < self.micro_batches:
                buf = self._buffer_idx(mb)
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(buffer_id=buf))
                else:
                    cmds.append(RecvActivation(buffer_id=buf))
                cmds.append(ForwardPass(buffer_id=buf))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buffer_id=buf))
            yield cmds


class TrainSchedule(PipeSchedule):
    """1F1B: warm up with (stages-1-stage_id) forwards, then alternate 1
    forward / 1 backward, drain remaining backwards, then reduce + step.

    Bubble fraction = (stages-1)/(micro_batches+stages-1), identical to the
    reference's schedule (schedule.py:182-289).
    """

    def num_pipe_buffers(self) -> int:
        # in-flight activations this stage must hold (reference: 289)
        return max(2, min(self.micro_batches, self.stages - self.stage_id))

    def _forwards_before_first_backward(self) -> int:
        return min(self.micro_batches, self.stages - self.stage_id)

    def steps(self):
        m, s, sid = self.micro_batches, self.stages, self.stage_id
        warmup = min(m, s - 1 - sid)
        fwd_id, bwd_id = 0, 0
        # clock-aligned: stage sid idles sid ticks before its first forward
        for _ in range(sid):
            yield []
        # warmup forwards
        for _ in range(warmup):
            yield self._fwd_cmds(fwd_id)
            fwd_id += 1
        # steady state: 1F1B
        while fwd_id < m:
            yield self._fwd_cmds(fwd_id) + self._bwd_cmds(bwd_id)
            fwd_id += 1
            bwd_id += 1
        # drain backwards
        while bwd_id < m:
            yield self._bwd_cmds(bwd_id)
            bwd_id += 1
        yield [ReduceTiedGrads(), ReduceGrads(), OptimizerStep()]

    def _fwd_cmds(self, mb: int) -> List[PipeInstruction]:
        buf = self._buffer_idx(mb)
        cmds: List[PipeInstruction] = []
        if self.is_first_stage:
            cmds.append(LoadMicroBatch(buffer_id=buf))
        else:
            cmds.append(RecvActivation(buffer_id=buf))
        cmds.append(ForwardPass(buffer_id=buf))
        if not self.is_last_stage:
            cmds.append(SendActivation(buffer_id=buf))
        return cmds

    def _bwd_cmds(self, mb: int) -> List[PipeInstruction]:
        buf = self._buffer_idx(mb)
        cmds: List[PipeInstruction] = []
        if not self.is_last_stage:
            cmds.append(RecvGrad(buffer_id=buf))
        cmds.append(BackwardPass(buffer_id=buf))
        if not self.is_first_stage:
            cmds.append(SendGrad(buffer_id=buf))
        return cmds


class DataParallelSchedule(PipeSchedule):
    """Degenerate single-stage schedule (reference: schedule.py:477+)."""

    def num_pipe_buffers(self) -> int:
        return 1

    def steps(self):
        for mb in range(self.micro_batches):
            yield [LoadMicroBatch(buffer_id=0), ForwardPass(buffer_id=0),
                   BackwardPass(buffer_id=0)]
        yield [ReduceGrads(), OptimizerStep()]


def bubble_fraction(micro_batches: int, stages: int) -> float:
    """Idle fraction of the GPipe/1F1B pipeline."""
    return (stages - 1) / (micro_batches + stages - 1)


# -- clock-aligned tick tables (the schedule/placement seam) ------------------

def build_1f1b_tables(n_micro: int, pp: int) -> Dict[str, np.ndarray]:
    """Clock-aligned 1F1B tables via event simulation.

    Returns arrays [T, pp]: fwd[t,s] / bwd[t,s] = micro id computed (-1 =
    bubble), recv_f[t,s] = micro id whose activation ARRIVES at (t,s) from
    s-1 (sent at t-1), recv_b[t,s] = cotangent arriving from s+1. Every
    stage obeys: warmup of (pp-1-s) forwards, then backward-priority
    alternation (the reference TrainSchedule discipline, schedule.py:151).

    Consumed by the stage interpreter (mpmd/executor.py, via
    :func:`stage_instruction_stream`), whichever channel it runs over.
    """
    slots = min(pp, n_micro)
    fwd_done = -np.ones((pp, n_micro), np.int64)    # tick fwd finished
    bwd_done = -np.ones((pp, n_micro), np.int64)
    fwd_next = [0] * pp
    bwd_next = [0] * pp
    rows_f, rows_b = [], []
    t = 0
    while any(b < n_micro for b in bwd_next):
        row_f = [-1] * pp
        row_b = [-1] * pp
        for s in range(pp):
            f, b = fwd_next[s], bwd_next[s]
            # a tick holds one forward AND one backward (the executor's scan
            # body computes both — that IS the 1F1B steady state); the ring
            # capacity caps in-flight forwards
            if f < n_micro and f - b < slots and (
                    s == 0 or 0 <= fwd_done[s - 1, f] < t):
                row_f[s] = f
                fwd_done[s, f] = t
                fwd_next[s] += 1
            if b < n_micro and (
                    (s == pp - 1 and 0 <= fwd_done[s, b] <= t)
                    or (s < pp - 1 and 0 <= bwd_done[s + 1, b] < t)):
                row_b[s] = b
                bwd_done[s, b] = t
                bwd_next[s] += 1
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1
        if t > 6 * (n_micro + pp) + 8:
            raise RuntimeError("1F1B schedule failed to converge")
    fwd = np.asarray(rows_f, np.int32)
    bwd = np.asarray(rows_b, np.int32)
    T = fwd.shape[0]
    recv_f = -np.ones_like(fwd)
    recv_b = -np.ones_like(bwd)
    recv_f[1:, 1:] = fwd[:-1, :-1]
    recv_b[1:, :-1] = bwd[:-1, 1:]
    return {"fwd": fwd, "bwd": bwd, "recv_f": recv_f, "recv_b": recv_b,
            "ticks": T}


def build_gpipe_tables(n_micro: int, pp: int) -> Dict[str, np.ndarray]:
    """Clock-aligned GPipe tables: full forward fill/drain, then the full
    backward wave in reverse pipeline direction — same array contract as
    :func:`build_1f1b_tables`, so the MPMD interpreter runs either
    schedule through one code path. In-flight forwards reach ``n_micro``
    (the GPipe memory regime), unlike 1F1B's ``min(pp, n_micro)`` bound.
    """
    T_f = n_micro + pp - 1
    T = T_f + n_micro + pp - 1
    fwd = -np.ones((T, pp), np.int32)
    bwd = -np.ones((T, pp), np.int32)
    for t in range(T_f):
        for s in range(pp):
            m = t - s
            if 0 <= m < n_micro:
                fwd[t, s] = m
    # backward: stage pp-1 leads (micro m at T_f+m); stage s waits
    # (pp-1-s) extra ticks for the cotangent to ripple upstream
    for m in range(n_micro):
        for s in range(pp):
            bwd[T_f + m + (pp - 1 - s), s] = m
    recv_f = -np.ones_like(fwd)
    recv_b = -np.ones_like(bwd)
    recv_f[1:, 1:] = fwd[:-1, :-1]
    recv_b[1:, :-1] = bwd[:-1, 1:]
    return {"fwd": fwd, "bwd": bwd, "recv_f": recv_f, "recv_b": recv_b,
            "ticks": T}


def build_tables(schedule: str, n_micro: int, pp: int) -> Dict[str, np.ndarray]:
    """Tick tables for a named schedule ('gpipe' | '1f1b')."""
    if schedule == "1f1b":
        return build_1f1b_tables(n_micro, pp)
    if schedule == "gpipe":
        return build_gpipe_tables(n_micro, pp)
    raise ValueError(f"unknown pipeline schedule {schedule!r} (gpipe | 1f1b)")


def stage_instruction_stream(tables: Dict[str, np.ndarray], stage: int,
                             ) -> List[List[PipeInstruction]]:
    """Render ONE stage's view of the clock tables as per-tick instruction
    lists — the reference's ``_exec_schedule`` shape, using the same
    instruction vocabulary the generator schedules yield. ``buffer_id``
    carries the MICRO id (the MPMD interpreter keys its buffers by micro;
    the legacy generators' ``micro % num_pipe_buffers`` ring indexing is a
    placement concern, not a schedule one).

    Receives are ordered before computes within a tick (the payload was
    sent one tick earlier and must be consumed before the matching
    forward/backward fires).
    """
    pp = tables["fwd"].shape[1]
    if not 0 <= stage < pp:
        raise ValueError(f"stage {stage} out of range for {pp} stages")
    out: List[List[PipeInstruction]] = []
    for t in range(int(tables["ticks"])):
        cmds: List[PipeInstruction] = []
        rf = int(tables["recv_f"][t, stage])
        rb = int(tables["recv_b"][t, stage])
        f = int(tables["fwd"][t, stage])
        b = int(tables["bwd"][t, stage])
        if rf >= 0:
            cmds.append(RecvActivation(buffer_id=rf))
        if rb >= 0:
            cmds.append(RecvGrad(buffer_id=rb))
        if f >= 0:
            if stage == 0:
                cmds.append(LoadMicroBatch(buffer_id=f))
            cmds.append(ForwardPass(buffer_id=f))
            if stage < pp - 1:
                cmds.append(SendActivation(buffer_id=f))
        if b >= 0:
            cmds.append(BackwardPass(buffer_id=b))
            if stage > 0:
                cmds.append(SendGrad(buffer_id=b))
        out.append(cmds)
    return out
