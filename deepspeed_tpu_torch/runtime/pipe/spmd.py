"""The forward-only pipeline walk and the stage-stacking helpers
(counterpart of ``deepspeed_tpu/runtime/pipe/spmd.py``, where GPipe is
one SPMD program over the ``pipe`` axis).

In the port, :func:`pipeline_apply` walks the gpipe tables' forward half
through the stage interpreter (``mpmd/executor.py``): the path behind a
pipelined model's ``forward`` and the engine's ``eval_batch``.
:func:`stack_stage_params` / :func:`unstack_stage_params` convert
``[L, ...]`` scan-layout leaves to ``[pp, L / pp, ...]`` and back, on
numpy or torch trees (for the conversion and checkpoints).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from .mpmd.executor import MPMDPipeline, _select

PyTree = Any


def pipeline_apply(stage_fn: Callable, stage_params: PyTree, micros, *,
                   pp: int, devices: Optional[Sequence] = None,
                   extras: PyTree = None, channel=None,
                   with_aux: bool = False):
    """Run the stacked stages over micro-batches: ``stage_fn(
    one_stage_params, x, extra, stage) -> y`` (``(y, aux)`` with
    ``with_aux``), ``stage_params`` a tree of [pp, ...] tensors,
    ``micros`` [n_micro, mb, ...] entering stage 0. Returns the last
    stage's [n_micro, mb, ...] outputs (no grads); with ``with_aux``,
    (outputs, the aux summed over stages, averaged over micro-batches),
    as the JAX function does."""
    per_stage = [_select(stage_params, s) for s in range(pp)]
    pipe = MPMDPipeline(stage_fn, None, pp=pp, schedule="gpipe",
                        devices=devices, channel=channel, with_aux=with_aux)
    out = pipe.forward(per_stage, micros, extras=extras)
    if with_aux:
        return torch.stack(out[0]), out[1]
    return torch.stack(out)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_stage_params(per_layer_params: PyTree, pp: int) -> PyTree:
    """[L, ...]-stacked per-layer params -> [pp, L/pp, ...] per-stage
    stacks."""
    def reshape(x):
        L = x.shape[0]
        if L % pp != 0:
            raise ValueError(f"layer count {L} not divisible by {pp} stages")
        return x.reshape((pp, L // pp) + tuple(x.shape[1:]))

    return _map(reshape, per_layer_params)


def unstack_stage_params(stage_params: PyTree) -> PyTree:
    """[pp, L/pp, ...] -> [L, ...] (checkpoint / interop layout)."""
    return _map(lambda x: x.reshape((x.shape[0] * x.shape[1],)
                                    + tuple(x.shape[2:])), stage_params)
