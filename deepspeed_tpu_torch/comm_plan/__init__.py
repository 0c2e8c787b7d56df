"""Communication planning: an algorithm per collective (counterpart of
``deepspeed_tpu/comm_plan``).

* :mod:`plan`: :class:`CommPlan`, the JSON decision table by {collective
  kind, mesh axis, message-size bucket};
* :mod:`selector`: a plan from sweep records (argmin latency a cell,
  deterministic tie-break), and the size-threshold heuristic where no
  sweep exists;
* :mod:`runtime`: the active-plan context the engine installs around the
  model's forward, the resolution ladder (override > plan entry >
  heuristic) and the accuracy guard;
* :mod:`cli`: ``comm-plan show`` (``sweep`` is ROADMAP item 5.3).

The collectives the plan routes live in ``runtime/comm/`` and are called
through ``comm.planned`` (docs/COMM.md).
"""

from .plan import ALGOS, CommPlan, PlanEntry, SITE_ALGOS, bucket_of
from .selector import heuristic_algo, parse_bench_lines, select_plan
from .runtime import (
    AccuracyGuard,
    PlanContext,
    active_context,
    resolve_algo,
    use_context,
)

__all__ = ["ALGOS", "CommPlan", "PlanEntry", "SITE_ALGOS", "bucket_of",
           "heuristic_algo", "parse_bench_lines", "select_plan",
           "AccuracyGuard", "PlanContext", "active_context", "resolve_algo",
           "use_context"]
