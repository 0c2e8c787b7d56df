"""1F1B: the hand-scheduled forward / backward interleave (counterpart
of ``deepspeed_tpu/runtime/pipe/one_f_one_b.py``, whose executor is one
SPMD program over the ``pipe`` axis).

In the port the stage interpreter (``mpmd/executor.py``) is the only
executor; this module keeps the JAX entry point's name and contract over
it at schedule "1f1b": each stage holds at most ``min(pp, n_micro)``
micro-batches in flight, and ``store_outputs`` picks the backward mode
(False: recompute the stage from its saved input; True: keep the
forward's graph to the backward tick).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from .mpmd.executor import mpmd_value_and_grad
# the clock tables live in the schedule layer; re-exported for callers
# of the JAX module's name
from .schedule import build_1f1b_tables  # noqa: F401

PyTree = Any


def pipeline_1f1b_value_and_grad(
        stage_fn: Callable, loss_fn: Callable, stage_params: PyTree,
        head_params: PyTree, micros, labels, *, pp: int,
        devices: Optional[Sequence] = None, extras: Optional[PyTree] = None,
        with_aux: bool = False, aux_cotangent: float = 0.0,
        loss_scale=None, store_outputs: bool = False, channel=None):
    """One 1F1B pass (the JAX function's contract). ``stage_fn(
    one_stage_params, x, extra, stage) -> y`` (``(y, aux)`` with
    ``with_aux``, each stage's aux seeded with the constant cotangent
    ``aux_cotangent``); ``loss_fn(head_params, y, labels_micro) ->
    scalar`` at the last stage; ``stage_params`` a tree of [pp, ...]
    tensors; ``micros`` [n_micro, mb, ...]; ``labels`` a tree of
    [n_micro, ...]. Returns (mean loss, mean aux (0 without
    ``with_aux``), stage grads [pp, ...], head grads, dmicros), the grads
    scaled by ``loss_scale``."""
    return mpmd_value_and_grad(
        stage_fn, lambda h, y, lab, ctx: loss_fn(h, y, lab), stage_params,
        head_params, micros, labels, pp=pp, devices=devices,
        schedule="1f1b", extras=extras, loss_scale=loss_scale,
        backward="store" if store_outputs else "recompute", channel=channel,
        with_aux=with_aux, aux_cotangent=aux_cotangent)
