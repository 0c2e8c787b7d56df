"""Named values that a remat region keeps (the port's counterpart of
``jax.ad_checkpoint.checkpoint_name``, applied where the value is made).

A value is named where it is computed: :func:`reuse` inside the attention
wrappers' autograd functions (``"attn"``: the forward's o and row
logsumexp) and :func:`dot` for a block's matmuls (``"dot"``). Outside a
region that keeps the name, both compute as usual. Inside one
(:func:`keep_region`), the forward stores each named value and the
backward's recomputation gets the stored tensors back in the same order
instead of computing again, so a kept attention forward launches its
kernel once. The stored tensors ride to the backward as the saved tensors
of one autograd node after the region (what
``torch.autograd.graph.saved_tensors_hooks`` sees), and are freed as the
recomputation consumes them.

``runtime/act_checkpoint.py`` builds the block policies on this module;
it sits with the kernel wrappers so that they need nothing above them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

_local = threading.local()


def _signature(inputs: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in inputs)


class _Frame:
    """The kept values of one checkpointed region: appended in the
    forward, handed to the backward through :class:`_Hold`, read back in
    order by the recomputation, which must make the same named calls on
    inputs of the same shapes and dtypes (``keys``)."""

    __slots__ = ("keep", "mode", "saved", "keys", "cursor")

    def __init__(self, keep: Sequence[str]):
        self.keep = frozenset(keep)
        self.mode: Optional[str] = None
        self.saved: Optional[list] = []
        self.keys: list = []
        self.cursor = 0

    @contextlib.contextmanager
    def active(self, mode: str):
        prev = getattr(_local, "frame", None)
        _local.frame, self.mode, self.cursor = self, mode, 0
        try:
            yield
        finally:
            _local.frame = prev
            if mode == "recompute":
                self.saved = None           # consumed (or early-stopped)


def _frame_keeping(name: str) -> Optional[_Frame]:
    f = getattr(_local, "frame", None)
    return f if f is not None and name in f.keep else None


def reuse(name: str, compute: Callable[[], Any], *inputs: torch.Tensor
          ) -> Any:
    """``compute()`` — a tensor or a tuple of tensors — unless a region
    that keeps ``name`` is being recomputed, in which case the value its
    forward stored comes back instead. ``inputs`` are the tensors
    ``compute`` reads: the recomputed call must match the stored one by
    name and by their shapes and dtypes, or this raises. Call it inside an
    autograd function's forward, so the node and its saved tensors are the
    same in the forward and the recomputation."""
    f = _frame_keeping(name)
    if f is None:
        return compute()
    key = (name, _signature(inputs))
    if f.mode == "recompute":
        i = f.cursor
        if i >= len(f.keys) or f.keys[i] != key:
            want = f.keys[i] if i < len(f.keys) else "nothing"
            raise RuntimeError(
                f"remat recomputation diverged from its forward: kept call "
                f"{i} was {want}, the recomputation made {key}")
        f.cursor += 1
        return f.saved[i]
    out = compute()
    f.keys.append(key)
    f.saved.append(tuple(t.detach() for t in out) if isinstance(out, tuple)
                   else out.detach())
    return out


class _Dot(torch.autograd.Function):
    """x @ w (w 2-D) whose output a region keeping "dot" keeps."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return reuse("dot", lambda: x @ w, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; inside a region that keeps "dot" its output is kept."""
    if _frame_keeping("dot") is None:
        return x @ w
    return _Dot.apply(x, w)


class _Hold(torch.autograd.Function):
    """Identity on a region's output whose node saves the region's kept
    values: they live as saved tensors until the backward reaches the
    region, then go back to the frame for the recomputation."""

    @staticmethod
    def forward(ctx, y, frame, n_out, *flat):
        ctx.frame, ctx.n_out = frame, n_out
        ctx.save_for_backward(*flat)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        flat, saved, i = ctx.saved_tensors, [], 0
        for n in ctx.n_out:
            saved.append(flat[i] if n == 0 else tuple(flat[i:i + n]))
            i += max(n, 1)
        ctx.frame.saved = saved
        return (g, None, None) + (None,) * len(flat)


def keep_region(fn: Callable, keep: Sequence[str], args, kwargs):
    """``fn(*args, **kwargs)`` as one non-reentrant checkpointed region
    that keeps the values named in ``keep`` and recomputes the rest."""
    frame = _Frame(keep)
    y = _torch_checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (frame.active("forward"),
                            frame.active("recompute")), **kwargs)
    saved, frame.saved = frame.saved, []
    if not saved:
        return y
    flat, n_out = [], []
    for s in saved:
        if isinstance(s, tuple):
            flat.extend(s)
            n_out.append(len(s))
        else:
            flat.append(s)
            n_out.append(0)
    return _Hold.apply(y, frame, tuple(n_out), *flat)
