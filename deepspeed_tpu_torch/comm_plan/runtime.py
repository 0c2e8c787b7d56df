"""The active-plan context and the algorithm resolution ladder
(counterpart of ``deepspeed_tpu/comm_plan/runtime.py``).

The engine makes its :class:`PlanContext` active around the model's
forward (``use_context``), so a seam inside the model, the MoE layer's
queue exchange, reads the plan where it runs without any config threaded
through the modules. The context is a thread-local stack: two engines in
one process (an exact and a quantized twin) each see their own plan, and
an engine without ``comm_plan`` sees none.

The ladder of a site's query (:func:`resolve_algo`):

1. an override from the ``comm_plan`` section (the site alias first,
   then the wire kind); an algorithm the site cannot run RAISES: a
   forced choice never degrades silently;
2. the loaded plan's (kind, axis, bucket) entry; an entry naming an
   algorithm the site cannot run falls through;
3. the size-threshold heuristic.

:class:`AccuracyGuard` is the engine's safety valve: once the observed
global grad norm drops below ``guard_min_grad_norm``, the following
steps run the exact sync (near convergence the int8 error is no longer
small beside the signal). It only ever forces exact.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional

from .plan import CommPlan, SITE_ALGOS, SITE_KIND
from .selector import heuristic_algo

_tls = threading.local()


@dataclass
class PlanContext:
    """Everything a wiring site needs to pick an algorithm."""
    plan: Optional[CommPlan] = None
    overrides: dict = field(default_factory=dict)
    bits: int = 8
    block: int = 256
    size_threshold: int = 4 * 2 ** 20
    overlap_chunks: int = 4            # pieces per overlap-family collective
    resolved: dict = field(default_factory=dict)   # site -> algo (audit)


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextlib.contextmanager
def use_context(ctx: Optional[PlanContext]):
    """Make ``ctx`` the active plan context for the dynamic extent (a
    None ctx is a no-op, so callers stay unconditional)."""
    if ctx is None:
        yield
        return
    st = _stack()
    st.append(ctx)
    try:
        yield
    finally:
        st.pop()


def active_context() -> Optional[PlanContext]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def resolve_algo(ctx: PlanContext, site: str, axis: str, nbytes: int,
                 axis_size: int) -> str:
    """The ladder; returns an algorithm the SITE can run."""
    if site not in SITE_ALGOS:
        raise ValueError(f"unknown comm-plan site {site!r} "
                         f"(known: {sorted(SITE_ALGOS)})")
    kind = SITE_KIND[site]
    supported = SITE_ALGOS[site]
    for key in (site, kind):
        forced = (ctx.overrides or {}).get(key)
        if forced is not None:
            if forced not in supported:
                raise ValueError(
                    f"comm_plan.overrides[{key!r}] = {forced!r} is not "
                    f"executable at site {site!r} (supported: "
                    f"{supported})")
            ctx.resolved[site] = forced
            return forced
    if ctx.plan is not None:
        chosen = ctx.plan.choose(kind, axis, nbytes)
        if chosen is not None and chosen in supported:
            ctx.resolved[site] = chosen
            return chosen
    algo = heuristic_algo(kind, nbytes, axis_size,
                          size_threshold=ctx.size_threshold)
    if algo not in supported:
        algo = "exact"
    ctx.resolved[site] = algo
    return algo


class AccuracyGuard:
    """Host-side exact-mode latch on small grad norms (see the module
    docstring)."""

    def __init__(self, min_grad_norm: float):
        self.min_grad_norm = float(min_grad_norm)
        self._last: Optional[float] = None

    def observe(self, grad_norm: float) -> None:
        if grad_norm == grad_norm:      # ignore NaN (overflow steps)
            self._last = float(grad_norm)

    @property
    def use_exact(self) -> bool:
        return self._last is not None and self._last < self.min_grad_norm
