"""CommPlan — the JSON-serializable per-collective algorithm table
(counterpart of ``deepspeed_tpu/comm_plan/plan.py``, the same table and
JSON, so a plan crosses between the two packages).

A plan maps (collective kind, mesh axis, message-size bucket) to one of
the algorithm names in :data:`ALGOS`. Kinds are the WIRE ops the
benchmark sweeps measure (``all_reduce``/``all_gather``/
``reduce_scatter``/``all_to_all``); the engine's wiring sites consult
them through site aliases (``grad_reduce_scatter`` -> ``reduce_scatter``,
``moe_all_to_all`` -> ``all_to_all``, ``param_all_gather`` ->
``all_gather``) so a single sweep steers every training seam and any
future caller of the same wire op.

Buckets are ceil(log2(message bytes)) — one decision per octave of
message size, matching how collective latency curves actually bend (a
flat latency floor below ~1 MB, bandwidth-bound above). An axis of
``"all"`` (the benchmark's flat mesh) acts as the wildcard row for axes
without their own sweep.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

#: every algorithm name a plan may mention, ordered safest-first (the
#: selector's tie-break): exact moves exact whole tensors, overlap moves
#: exact CHUNKS (same math, hand-pipelined wire schedule — T3-style
#: chunked allgather->matmul / chunked grad reduce-scatter), int8 and
#: overlap_int8 put the blockwise-quantized format on the wire
ALGOS = ("exact", "overlap", "int8", "overlap_int8", "hierarchical",
         "onebit")

#: algorithms whose wire format is LOSSY — the accuracy guard's exact
#: latch applies to these only (overlap moves exact values; forcing it
#: back to a whole-tensor schedule would change nothing numerically)
QUANTIZED_ALGOS = frozenset(("int8", "overlap_int8", "hierarchical",
                             "onebit"))

#: algorithms each engine wiring SITE can actually execute. The plan/
#: selector may know more (the benchmark measures onebit/hierarchical
#: allreduce too); a site falls back to its own ladder when the chosen
#: algo is not executable at that seam.
SITE_ALGOS = {
    "grad_reduce_scatter": ("exact", "int8", "overlap", "overlap_int8"),
    "moe_all_to_all": ("exact", "int8"),
    "param_all_gather": ("exact", "overlap", "overlap_int8"),
}

#: site alias -> wire kind the sweeps record
SITE_KIND = {
    "grad_reduce_scatter": "reduce_scatter",
    "moe_all_to_all": "all_to_all",
    "param_all_gather": "all_gather",
}

PLAN_VERSION = 1


def bucket_of(nbytes: int) -> int:
    """Message-size bucket: ceil(log2(bytes)), floored at 2^10 (sub-KiB
    messages share one latency-floor bucket)."""
    return max(10, math.ceil(math.log2(max(int(nbytes), 1))))


@dataclass
class PlanEntry:
    kind: str
    axis: str
    bucket: int
    algo: str
    est_us: Optional[float] = None      # selector's winning latency
    source: str = "sweep"               # sweep | heuristic | override

    def key(self) -> Tuple[str, str, int]:
        return (self.kind, self.axis, self.bucket)


@dataclass
class CommPlan:
    """Decision table + provenance. ``choose`` returns None when no entry
    covers the query — callers fall through to the heuristic ladder."""

    entries: Dict[Tuple[str, str, int], PlanEntry] = field(
        default_factory=dict)
    meta: Dict = field(default_factory=dict)
    version: int = PLAN_VERSION

    def add(self, entry: PlanEntry) -> None:
        self.entries[entry.key()] = entry

    def choose(self, kind: str, axis: str, nbytes: int) -> Optional[str]:
        """Exact (kind, axis, bucket) row, else the (kind, 'all', bucket)
        wildcard. Unknown bucket -> None (heuristic fallback)."""
        b = bucket_of(nbytes)
        e = self.entries.get((kind, axis, b)) or \
            self.entries.get((kind, "all", b))
        return e.algo if e is not None else None

    def entry_for(self, kind: str, axis: str,
                  nbytes: int) -> Optional[PlanEntry]:
        b = bucket_of(nbytes)
        return self.entries.get((kind, axis, b)) or \
            self.entries.get((kind, "all", b))

    # -- serialization -------------------------------------------------------

    def to_json(self) -> str:
        rows = [asdict(self.entries[k])
                for k in sorted(self.entries)]
        return json.dumps({"version": self.version, "meta": self.meta,
                           "entries": rows}, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CommPlan":
        doc = json.loads(text)
        ver = doc.get("version", PLAN_VERSION)
        if ver > PLAN_VERSION:
            raise ValueError(
                f"comm plan version {ver} is newer than this build "
                f"understands ({PLAN_VERSION})")
        plan = cls(meta=dict(doc.get("meta") or {}), version=ver)
        for row in doc.get("entries", ()):
            algo = row.get("algo")
            if algo not in ALGOS:
                raise ValueError(f"comm plan entry has unknown algo "
                                 f"{algo!r} (known: {ALGOS})")
            plan.add(PlanEntry(kind=row["kind"], axis=row["axis"],
                               bucket=int(row["bucket"]), algo=algo,
                               est_us=row.get("est_us"),
                               source=row.get("source", "sweep")))
        return plan

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CommPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def describe(self) -> str:
        if not self.entries:
            return "comm plan: empty (heuristics apply everywhere)"
        lines = [f"{'kind':<16} {'axis':<8} {'bucket':<8} {'~size':<10} "
                 f"{'algo':<12} {'est_us':<10} source"]
        for key in sorted(self.entries):
            e = self.entries[key]
            size = 2 ** e.bucket
            human = (f"{size // 2**20}MiB" if size >= 2 ** 20
                     else f"{size // 2**10}KiB")
            lines.append(
                f"{e.kind:<16} {e.axis:<8} {e.bucket:<8} {'<=' + human:<10} "
                f"{e.algo:<12} "
                f"{'' if e.est_us is None else round(e.est_us, 1):<10} "
                f"{e.source}")
        return "\n".join(lines)
