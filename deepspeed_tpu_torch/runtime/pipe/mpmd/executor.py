"""The stage interpreter: per-stage forward and backward over explicit
transfers (counterpart of ``deepspeed_tpu/runtime/pipe/mpmd/
executor.py``).

The JAX package places one schedule two ways: one SPMD program over the
``pipe`` mesh axis (``ppermute`` inside a scan), or this interpreter of
each stage's instruction stream against a transfer channel. Eager
PyTorch has no single-program form, so the port has this one executor
behind both ``pipeline.placement`` values; the channel is what varies
(``channel.py``): a :class:`~.channel.LocalChannel` when one process
holds every stage, a :class:`~.channel.PipeGroupChannel` when each rank
of the ``pipe`` axis holds one.

The interpreter walks :func:`..schedule.stage_instruction_stream` tick by
tick, the receives of a tick before its computes. A stage's forward runs
its body; its backward has two modes:

* ``recompute`` (the default): the forward keeps only its detached input;
  the backward re-runs the stage from it under autograd and takes the
  grads of the stage's parameters and input with ``torch.autograd.grad``.
  The last stage skips its forward (its backward recomputes it anyway);
* ``store``: the forward keeps its graph to the backward tick (no
  recompute; every in-flight micro-batch's activations stay live: up to
  ``n_micro`` of them under gpipe, ``min(pp, n_micro)`` under 1F1B).

The last stage computes each micro-batch's loss and seeds its own
backward with ``loss_scale``. Grads and the loss accumulate in f32 in
backward-table tick order, which is micro order on every stage under both
schedules, so gpipe and 1F1B give bitwise-equal grads under deterministic
algorithms, and so do store and recompute. The results are the JAX
executor's: (mean loss, mean aux, each stage's grads / n_micro, the
head's grads / n_micro, the stage-0 input cotangents / n_micro), the
grads scaled by ``loss_scale``.

MoE's aux scalar (``with_aux``): the stage body returns ``(y, aux)``.
Each stage accumulates its aux in forward-table order (the last stage,
whose forward the recompute mode skips, at its backward ticks: micro
order too), and every stage's backward seeds its aux with the constant
cotangent ``aux_cotangent x loss_scale``, so the routers of every stage
get the aux gradient; the result's aux is the stages' sum / n_micro, the
JAX executor's. Without ``with_aux`` the aux is 0.

ZeRO-3 (``gather``): ``gather(tree)`` is a context in which the
parameters of ``tree`` (a stage's blocks, the head) are whole; it yields
the tensors to differentiate in :func:`tree_leaves` order. A stage's
blocks are gathered around its forward tick and again around its
backward tick (in ``store`` mode the forward's graph keeps them to the
backward); their grads accumulate whole and the caller reduce-scatters
them after the step's last backward tick.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..schedule import (BackwardPass, ForwardPass, LoadMicroBatch,
                        RecvActivation, RecvGrad, SendActivation, SendGrad,
                        build_gpipe_tables, build_tables,
                        stage_instruction_stream)
from .channel import LocalChannel

PyTree = Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` that take grads, in order: a module's
    trainable parameters, a dict's values in insertion order, a list's
    items."""
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [p for p in tree.parameters() if p.requires_grad]
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.requires_grad else []
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return []


def tree_like(tree, values: Sequence[torch.Tensor]):
    """``values`` (in :func:`tree_leaves` order) in ``tree``'s dict / list
    structure (a module gives the flat list)."""
    it = iter(values)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return next(it) if node.requires_grad else None
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    if isinstance(tree, nn.Module):
        return list(values)
    return walk(tree)


def _micro(tree, m: int):
    """Micro-batch ``m`` of a pytree of [n_micro, ...] leaves."""
    if isinstance(tree, dict):
        return {k: _micro(v, m) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tree[m]
    if isinstance(tree, torch.Tensor):
        return tree[m]
    return tree


def _to(tree, device):
    if device is None:
        return tree
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def forward_tables(n_micro: int, pp: int) -> Dict[str, Any]:
    """The forward half of the gpipe tables (fill and drain, no backward
    tick): the walk behind ``pipeline_apply`` / ``eval_batch``."""
    T = n_micro + pp - 1
    tables = build_gpipe_tables(n_micro, pp)
    out = {k: tables[k][:T] for k in ("fwd", "recv_f")}
    out.update(bwd=-np.ones_like(out["fwd"]),
               recv_b=-np.ones_like(out["fwd"]), ticks=T)
    return out


class MPMDPipeline:
    """One pipeline's stage programs and its interpreter.

    stage_fn(one_stage_params, x, extra, stage) -> y: every stage's body
        (the JAX executors' contract; ``extra`` is the micro-batch's
        slice of ``extras``).
    loss_fn(head_params, y, labels_micro, ctx) -> scalar: the last stage's
        head and per-micro loss. With ``batch_loss``, called once with
        every micro-batch's output (a list) and the whole ``labels``.
    pp, schedule: the stages and "gpipe" | "1f1b".
    devices: optional device of each stage (one process: a payload moves
        to its receiver's device); channel: default a
        :class:`LocalChannel` over ``devices``; stages: the stages this
        process runs (default all; a :class:`PipeGroupChannel` rank's one).
    backward: "recompute" | "store" (module docstring).
    with_aux: the stage body returns (y, aux) (MoE; module docstring).
    gather: ZeRO-3's context of whole parameters (module docstring)."""

    def __init__(self, stage_fn: Callable, loss_fn: Callable, *,
                 pp: int, schedule: str = "1f1b",
                 devices: Optional[Sequence] = None,
                 channel=None,
                 stages: Optional[Sequence[int]] = None,
                 backward: str = "recompute",
                 batch_loss: bool = False,
                 with_aux: bool = False,
                 gather: Optional[Callable] = None):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline schedule {schedule!r} "
                             "(gpipe | 1f1b)")
        if backward not in ("recompute", "store"):
            raise ValueError(f"backward must be recompute|store, got "
                             f"{backward!r}")
        if devices is not None and len(devices) != pp:
            raise ValueError(f"{len(devices)} devices for pp={pp}")
        self.pp, self.schedule, self.backward = pp, schedule, backward
        self.batch_loss, self.with_aux = batch_loss, with_aux
        self._gather = gather if gather is not None else _held
        self.devices = (list(devices) if devices is not None
                        else [None] * pp)
        self.stages = list(range(pp)) if stages is None else list(stages)
        self.channel = channel if channel is not None else LocalChannel(
            placements={s: d for s, d in enumerate(self.devices)
                        if d is not None})
        self._stage_fn, self._loss_fn = stage_fn, loss_fn
        self._streams: Dict[Any, Any] = {}

    def _walk(self, n_micro: int, forward_only: bool = False):
        key = (n_micro, "forward" if forward_only else self.schedule)
        if key not in self._streams:
            tables = (forward_tables(n_micro, self.pp) if forward_only
                      else build_tables(self.schedule, n_micro, self.pp))
            self._streams[key] = (tables, {
                s: stage_instruction_stream(tables, s) for s in self.stages})
        return self._streams[key]

    def value_and_grad(self, stage_params: Sequence[PyTree],
                       head_params: PyTree, micros, labels, *,
                       extras: Optional[PyTree] = None,
                       loss_ctx: Any = None,
                       loss_scale=None,
                       aux_cotangent: float = 0.0,
                       n_micro: Optional[int] = None,
                       boundary=None):
        """One pipeline step. ``stage_params[s]``: stage s's parameters
        (a module or a tree of tensors; only this process's stages are
        read); ``micros`` [n_micro, mb, ...]: stage 0's inputs (None where
        stage 0 is not here: give ``n_micro`` and ``boundary``, the
        (shape, dtype, device) of every edge's payload); ``labels``: the
        last stage's per-micro targets; ``aux_cotangent``: the aux's
        weight in the objective (``with_aux``). Returns (mean loss, mean
        aux of this process's stages, {stage: grads in ``tree_leaves``
        order}, head grads, dmicros)."""
        return self._run(stage_params, head_params, micros, labels,
                         extras, loss_ctx, loss_scale, n_micro, boundary,
                         forward_only=False, aux_cotangent=aux_cotangent)

    def forward(self, stage_params: Sequence[PyTree], micros, *,
                extras: Optional[PyTree] = None,
                n_micro: Optional[int] = None, boundary=None):
        """The forward walk alone, without grads: the last stage's output
        of each micro-batch (a list; empty where the last stage is not
        here); with ``with_aux``, (that list, the mean aux of this
        process's stages)."""
        with torch.no_grad():
            return self._run(stage_params, None, micros, None, extras,
                             None, None, n_micro, boundary,
                             forward_only=True)

    def _body(self, stage_params, s, x, extras, mid):
        """(y, aux or None) of stage ``s`` on micro-batch ``mid``."""
        out = self._stage_fn(stage_params[s], x, _micro(extras, mid), s)
        return out if self.with_aux else (out, None)

    def _run(self, stage_params, head_params, micros, labels, extras,
             loss_ctx, loss_scale, n_micro, boundary, forward_only,
             aux_cotangent=0.0):
        pp, last = self.pp, self.pp - 1
        if micros is not None:
            n_micro = int(micros.shape[0])
            boundary = boundary or (tuple(micros.shape[1:]), micros.dtype,
                                    micros.device)
        if n_micro is None:
            raise ValueError("value_and_grad without micros needs n_micro")
        tables, streams = self._walk(n_micro, forward_only)
        extras = {} if extras is None else extras
        scale = 1.0 if loss_scale is None else float(loss_scale)
        aux_ct = float(aux_cotangent) * scale
        store = self.backward == "store"
        f32 = torch.float32
        gather = self._gather
        ext = {s: _to(extras, self.devices[s]) for s in self.stages}
        acc = {s: [None] * len(tree_leaves(stage_params[s]))
               for s in self.stages}
        hacc: List[Optional[torch.Tensor]] = (
            [None] * len(tree_leaves(head_params))
            if last in self.stages else [])
        lacc = None
        aux_acc: Dict[int, torch.Tensor] = {}
        if last in self.stages and labels is not None:
            labels = _to(labels, self.devices[last])
        in_act = {s: {} for s in self.stages}
        in_grad = {s: {} for s in self.stages}
        saved = {s: {} for s in self.stages}
        out_y = {s: {} for s in self.stages}
        out_dx = {s: {} for s in self.stages}
        dmicros: Dict[int, torch.Tensor] = {}
        outputs: Dict[int, torch.Tensor] = {}
        dys: Dict[int, torch.Tensor] = {}

        def add(slots, grads, at=0):
            for i in range(len(slots)):
                g = grads[at + i]
                if g is None:
                    continue
                slots[i] = (g.to(f32) if slots[i] is None
                            else slots[i].add_(g.to(f32)))

        def add_aux(s, a):
            if a is not None:
                a = a.detach().to(f32)
                aux_acc[s] = a if s not in aux_acc else aux_acc[s] + a

        # the aux of a forward the recompute mode skips (the last stage's)
        # is taken at its backward tick
        aux_at_bwd = not (store or self.batch_loss or forward_only)

        ch = self.channel
        ch.begin(tables, boundary)
        try:
            for t in range(int(tables["ticks"])):
                for s in self.stages:
                    for inst in streams[s][t]:
                        mid = inst.buffer_id
                        if isinstance(inst, RecvActivation):
                            in_act[s][mid] = ch.recv("act", s, mid)
                        elif isinstance(inst, RecvGrad):
                            in_grad[s][mid] = ch.recv("grad", s, mid)
                        elif isinstance(inst, LoadMicroBatch):
                            x = micros[mid]
                            if self.devices[s] is not None:
                                x = x.to(self.devices[s])
                            in_act[s][mid] = x.detach()
                        elif isinstance(inst, ForwardPass):
                            x = in_act[s].pop(mid)
                            if forward_only:
                                with gather(stage_params[s]):
                                    y, a = self._body(stage_params, s, x,
                                                      ext[s], mid)
                                add_aux(s, a)
                                if s == last:
                                    outputs[mid] = y
                                else:
                                    out_y[s][mid] = y
                            elif store:
                                x = x.detach().requires_grad_(True)
                                with torch.enable_grad(), \
                                        gather(stage_params[s]) as lv:
                                    y, a = self._body(stage_params, s, x,
                                                      ext[s], mid)
                                add_aux(s, a)
                                saved[s][mid] = (x, y, a, lv)
                                if s < last:
                                    out_y[s][mid] = y.detach()
                                elif self.batch_loss:
                                    outputs[mid] = y
                            else:
                                saved[s][mid] = x
                                # the last stage's backward recomputes its
                                # body: a forward here would be pure double
                                # compute, unless the whole-batch loss
                                # needs every output first
                                if s < last or self.batch_loss:
                                    with torch.no_grad(), \
                                            gather(stage_params[s]):
                                        y, a = self._body(stage_params, s,
                                                          x, ext[s], mid)
                                    add_aux(s, a)
                                    if s < last:
                                        out_y[s][mid] = y
                                    else:
                                        outputs[mid] = y
                        elif isinstance(inst, SendActivation):
                            ch.send("act", s, s + 1, mid, out_y[s].pop(mid))
                        elif isinstance(inst, BackwardPass):
                            if s == last and self.batch_loss and not dys:
                                lacc = self._batch_loss(
                                    head_params, hacc, outputs, labels,
                                    loss_ctx, scale, dys, add)
                            if store:
                                xb, y, a, lv = saved[s].pop(mid)
                                held = contextlib.nullcontext(lv)
                            else:
                                xb = saved[s].pop(mid).detach() \
                                    .requires_grad_(True)
                                held = gather(stage_params[s])
                            with held as lv:
                                if not store:
                                    with torch.enable_grad():
                                        y, a = self._body(stage_params, s,
                                                          xb, ext[s], mid)
                                    if s == last and aux_at_bwd:
                                        add_aux(s, a)
                                if a is not None and not a.requires_grad:
                                    a = None
                                if s == last and not self.batch_loss:
                                    with gather(head_params) as hl, \
                                            torch.enable_grad():
                                        loss = self._loss_fn(
                                            head_params, y,
                                            _micro(labels, mid), loss_ctx)
                                        obj = loss.to(f32) * scale
                                        if a is not None:
                                            obj = obj + a.to(f32) * aux_ct
                                        gs = torch.autograd.grad(
                                            obj, lv + hl + [xb],
                                            allow_unused=True)
                                    add(acc[s], gs)
                                    add(hacc, gs, len(lv))
                                    l32 = loss.detach().to(f32)
                                    lacc = l32 if lacc is None else \
                                        lacc + l32
                                else:
                                    dy = (dys.pop(mid) if s == last
                                          else in_grad[s].pop(mid))
                                    outs, gos = [y], [dy.to(y.dtype)]
                                    if a is not None:
                                        outs.append(a)
                                        gos.append(torch.full_like(a, aux_ct))
                                    gs = torch.autograd.grad(
                                        outs, lv + [xb], grad_outputs=gos,
                                        allow_unused=True)
                                    add(acc[s], gs)
                            del lv
                            dx = gs[-1]
                            if dx is None:
                                dx = torch.zeros_like(xb)
                            dx = dx.to(xb.dtype)
                            if s == 0:
                                dmicros[mid] = dx
                            else:
                                out_dx[s][mid] = dx
                        elif isinstance(inst, SendGrad):
                            ch.send("grad", s, s - 1, mid,
                                    out_dx[s].pop(mid))
                ch.end_tick(t)
        except BaseException:
            ch.clear()
            raise
        dev = boundary[2]
        aux = torch.zeros((), dtype=f32, device=dev)
        for s in self.stages:
            if s in aux_acc:
                aux = aux + aux_acc[s].to(dev)
        aux = aux / n_micro
        if forward_only:
            outs = [outputs[m] for m in sorted(outputs)]
            return (outs, aux) if self.with_aux else outs
        loss = (torch.zeros((), dtype=f32, device=dev) if lacc is None
                else lacc / n_micro)
        grads = {s: [None if a is None else a.div_(n_micro)
                     for a in acc[s]] for s in self.stages}
        hgrads = [None if a is None else a.div_(n_micro) for a in hacc]
        dm = None
        if 0 in self.stages:
            dm = torch.stack([dmicros[m] for m in range(n_micro)]) / n_micro
        return loss, aux, grads, hgrads, dm

    def _batch_loss(self, head_params, hacc, outputs, labels, loss_ctx,
                    scale, dys, add):
        """The whole-batch loss at the last stage's first backward tick:
        ``loss_fn`` over every micro-batch's output at once, its grads
        into the head's accumulator and each output's cotangent into
        ``dys``. Returns the loss times n_micro (the caller divides)."""
        n = len(outputs)
        ys = [outputs[m].detach().requires_grad_(True) for m in range(n)]
        with self._gather(head_params) as hl, torch.enable_grad():
            loss = self._loss_fn(head_params, ys, labels, loss_ctx)
            gs = torch.autograd.grad(loss.to(torch.float32) * scale,
                                     hl + ys, allow_unused=True)
        add(hacc, [None if g is None else g * n for g in gs[:len(hl)]])
        for m in range(n):
            g = gs[len(hl) + m]
            dys[m] = torch.zeros_like(ys[m]) if g is None else g * n
        return loss.detach().to(torch.float32) * n


@contextlib.contextmanager
def _held(tree):
    """The default ``gather``: the parameters as they are held."""
    yield tree_leaves(tree)

def _stack_stage_trees(per_stage: Sequence[PyTree]) -> PyTree:
    """[tree of stage 0, ...] -> one tree with a leading [pp] dim."""
    first = per_stage[0]
    if isinstance(first, dict):
        return {k: _stack_stage_trees([t[k] for t in per_stage])
                for k in first}
    return torch.stack(list(per_stage))


def mpmd_value_and_grad(stage_fn: Callable, loss_fn: Callable,
                        stage_params: PyTree, head_params: PyTree,
                        micros, labels, *,
                        pp: int,
                        devices: Optional[Sequence] = None,
                        schedule: str = "1f1b",
                        extras: Optional[PyTree] = None,
                        loss_scale=None,
                        loss_ctx: Any = None,
                        backward: str = "recompute",
                        channel=None,
                        with_aux: bool = False,
                        aux_cotangent: float = 0.0):
    """One-shot functional form (tests, parity oracles): ``stage_params``
    a tree of [pp, ...] tensors, as the JAX executors take. Returns (loss,
    aux, stage grads [pp, ...], head grads, dmicros) in the trees'
    structure."""
    per_stage = [_select(stage_params, s) for s in range(pp)]
    head = _detached(head_params)
    pipe = MPMDPipeline(stage_fn, loss_fn, pp=pp, schedule=schedule,
                        devices=devices, channel=channel, backward=backward,
                        with_aux=with_aux)
    loss, aux, grads, hgrads, dm = pipe.value_and_grad(
        per_stage, head, micros, labels, extras=extras, loss_ctx=loss_ctx,
        loss_scale=loss_scale, aux_cotangent=aux_cotangent)
    gs = _stack_stage_trees([tree_like(per_stage[s], grads[s])
                             for s in range(pp)])
    return loss, aux, gs, tree_like(head, hgrads), dm


def _select(tree, s):
    if isinstance(tree, dict):
        return {k: _select(v, s) for k, v in tree.items()}
    return tree[s].detach().clone().requires_grad_(True)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)
