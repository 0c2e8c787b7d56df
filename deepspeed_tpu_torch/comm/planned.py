"""Plan-routed collective entry points: the ``comm`` facade's face of
``comm_plan`` (counterpart of ``deepspeed_tpu/comm/planned.py``).

A wiring site calls one function here instead of picking a wire format
itself: the engine's ZeRO-2 gradient sync calls
:func:`planned_grad_sync` with the algorithm it resolved at initialize,
the ZeRO-3 parameter gather builds its chunked gathers through
:func:`planned_param_gather`, and the MoE layer asks
:func:`moe_exchange_spec` (which reads the engine's active plan context)
whether its queue exchange leaves the exact all-to-all. The collectives
live in ``runtime/comm/``; the policy in ``comm_plan/``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def planned_grad_sync(x: torch.Tensor, *, axis="data", algo: str = "int8",
                      bits: int = 8, block: int = 256, mean: bool = True,
                      chunks: int = 4) -> torch.Tensor:
    """The ZeRO-2 grad-sync entry point: this rank's gradient in, the
    reduced gradient (the same on every rank) out, in the wire format and
    schedule of ``algo`` (``exact``, ``int8``, or the chunked
    ``overlap`` / ``overlap_int8``)."""
    from ..runtime.comm.overlap import OVERLAP_ALGOS, overlap_grad_sync
    from ..runtime.comm.quantized import grad_sync
    if algo in OVERLAP_ALGOS:
        return overlap_grad_sync(x, axis=axis, chunks=chunks, algo=algo,
                                 bits=bits, block=block, mean=mean)
    return grad_sync(x, axis=axis, algo=algo, bits=bits, block=block,
                     mean=mean)


def planned_param_gather(axis, dim: int, *, algo: str, chunks: int = 4,
                         bits: int = 8, block: int = 256):
    """The ZeRO-3 parameter gather of one leaf for the ``overlap``
    family: the chunked all-gather whose backward is the chunked
    gradient reduce-scatter (``runtime.comm.overlap.make_overlap_gather``)."""
    from ..runtime.comm.overlap import make_overlap_gather
    return make_overlap_gather(axis, dim, chunks=chunks, algo=algo,
                               bits=bits, block=block)


def moe_exchange_spec(nbytes: int, axis: str = "expert"
                      ) -> Optional[Tuple[str, int, int]]:
    """Asked by ``moe.layer.MoE`` where it exchanges its queues:
    ``(algo, bits, block)`` when the active plan routes the expert
    all-to-all through the explicit exchange, or None for the exact
    all-to-all (no context installed, an expert group of one, or an
    exact verdict). ``nbytes``: the exchange's bytes over every gating
    group, as the JAX layer sizes its global array."""
    from ..comm_plan.runtime import active_context, resolve_algo
    from . import comm
    ctx = active_context()
    if ctx is None:
        return None
    ep = comm.axis_size(axis)
    if ep <= 1:
        return None
    algo = resolve_algo(ctx, "moe_all_to_all", axis, nbytes, axis_size=ep)
    if algo == "exact":
        return None
    return algo, ctx.bits, ctx.block


def planned_queue_exchange(*, algo: str, bits: int = 8, block: int = 256,
                           axis: str = "expert"):
    """(dispatch, combine) pair of the MoE queues (see
    ``runtime.comm.quantized.make_queue_exchange``)."""
    from ..runtime.comm.quantized import make_queue_exchange
    return make_queue_exchange(axis=axis, algo=algo, bits=bits, block=block)
