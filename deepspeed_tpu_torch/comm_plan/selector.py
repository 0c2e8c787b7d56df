"""Plan selection: sweep records in, CommPlan out (counterpart of
``deepspeed_tpu/comm_plan/selector.py``).

Records are the ``comm_bench: {json}`` rows of a collective sweep (the
JAX package's ``benchmarks/communication.py``; the port's sweep is
ROADMAP item 5.3) — one dict per (op, algo, axis, size) with a measured
``latency_us``. The selector groups them by (kind, axis, bucket) and
picks the fastest algorithm per cell; ties break toward the SAFER
algorithm (lower index in :data:`plan.ALGOS`, i.e. ``exact`` first), and
record order never matters — same sweep, same plan, byte for byte.

Where no sweep covers a query, :func:`heuristic_algo` applies the safe
size-threshold policy: exact below the threshold (latency-bound regime —
quantize/dequant overhead and scale traffic buy nothing), int8 above it
(bandwidth-bound — the 4x payload cut is the win ZeRO++/EQuARX measure),
and always exact on a single-member axis (nothing to exchange). The
``overlap`` family is deliberately NEVER a heuristic verdict: whether a
hand-pipelined chunk schedule beats the scheduler is a property of the
host's wire, so overlap is only ever selected from recorded sweep rows
(whose latency_us is the overlap cell's EXPOSED comm time) or forced by
an override — never hard-coded.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from .plan import ALGOS, CommPlan, PlanEntry, bucket_of

BENCH_PREFIX = "comm_bench:"

#: heuristic regime boundary (bytes): messages at or above quantize
DEFAULT_SIZE_THRESHOLD = 4 * 2 ** 20


def parse_bench_lines(text: str) -> List[Dict]:
    """Extract the machine-readable sweep rows from benchmark stdout.
    Malformed lines are skipped (a truncated run keeps its good rows)."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith(BENCH_PREFIX):
            continue
        try:
            row = json.loads(line[len(BENCH_PREFIX):])
        except ValueError:
            continue
        if isinstance(row, dict) and "op" in row:
            rows.append(row)
    return rows


def _row_bytes(row: Dict) -> Optional[int]:
    if "size_bytes" in row:
        return int(row["size_bytes"])
    if "size_mb" in row:
        return int(float(row["size_mb"]) * 2 ** 20)
    return None


def select_plan(records: Iterable[Dict], meta: Optional[Dict] = None
                ) -> CommPlan:
    """argmin-latency per (kind, axis, bucket); deterministic under
    record shuffling (ties break by latency, then ALGOS order)."""
    cells: Dict[tuple, List[Dict]] = {}
    for row in records:
        nbytes = _row_bytes(row)
        algo = row.get("algo", "exact")
        if nbytes is None or "latency_us" not in row or algo not in ALGOS:
            continue
        key = (str(row["op"]), str(row.get("axis", "all")),
               bucket_of(nbytes))
        cells.setdefault(key, []).append(row)
    plan = CommPlan(meta=dict(meta or {}))
    for (kind, axis, bucket), rows in cells.items():
        best = min(rows, key=lambda r: (float(r["latency_us"]),
                                        ALGOS.index(r.get("algo",
                                                          "exact"))))
        plan.add(PlanEntry(kind=kind, axis=axis, bucket=bucket,
                           algo=best.get("algo", "exact"),
                           est_us=float(best["latency_us"]),
                           source="sweep"))
    return plan


def heuristic_algo(kind: str, nbytes: int, axis_size: int,
                   size_threshold: int = DEFAULT_SIZE_THRESHOLD) -> str:
    """The no-sweep fallback policy. Conservative by construction: only
    the two kinds with a quantized implementation ever leave exact."""
    if axis_size <= 1:
        return "exact"
    if kind in ("reduce_scatter", "all_to_all", "all_reduce") and \
            nbytes >= size_threshold:
        return "int8"
    return "exact"
