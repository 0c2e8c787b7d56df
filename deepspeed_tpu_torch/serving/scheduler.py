"""Continuous-batching request scheduler: admission + tiered FIFO queue.

Counterpart of ``deepspeed_tpu/serving/scheduler.py`` (without its chaos
failpoints). Contract:

* **Admission by block budget.** A request is admitted only when the pool
  can cover its whole lifetime — ``ceil((prompt + max_new - 1) /
  block_size)`` blocks, minus a prefix-cache hit — so an admitted
  sequence never runs out of pool mid-decode.
* **Strict FIFO** within a tier: a head that does not fit blocks
  everything behind it.
* **Deadlines.** A still-queued request past ``deadline_s`` is shed with
  TIMEOUT at the next admission pass.
* **Priority tiers.** latency / standard / batch; the highest tier is
  served first, and a tier head that waited longer than ``aging_s`` is
  served as if it were latency-tier.
* **Overload ladder.** Past ``batch_highwater`` of ``max_queue`` new
  batch-tier submissions are rejected; at a full queue a higher-tier
  arrival sheds the youngest queued request of the lowest tier below it,
  else the arrival is rejected — machine-readably either way.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..utils.logging import logger
from .kv_cache import BlockPool, PrefixCache

QUEUED, PREFILL, RUNNING, FINISHED, FAILED, TIMEOUT, SHED = (
    "QUEUED", "PREFILL", "RUNNING", "FINISHED", "FAILED", "TIMEOUT", "SHED")

#: priority tiers, highest first. Rank 0 dispatches first.
LATENCY, STANDARD, BATCH = "latency", "standard", "batch"
PRIORITY_TIERS = (LATENCY, STANDARD, BATCH)
TIER_RANK = {LATENCY: 0, STANDARD: 1, BATCH: 2}

_rid = itertools.count()


class AdmissionRejected(RuntimeError):
    """Machine-readable admission rejection; ``info`` carries the verdict
    and the message embeds it as JSON."""

    def __init__(self, reason: str, tier: str, queue: int, max_queue: int):
        self.info = {"error": "admission_rejected", "reason": reason,
                     "tier": tier, "queue": queue, "max_queue": max_queue}
        super().__init__(
            f"serving queue full ({queue}/{max_queue}): "
            + json.dumps(self.info, sort_keys=True))


def check_admissible(prompt_tokens: int, max_new_tokens: int,
                     block_size: int, num_blocks: int,
                     max_model_len: Optional[int],
                     label: str = "request") -> None:
    """Reject synchronously what no pool of ``num_blocks`` (one reserved
    null block) could ever serve: an empty prompt, a request beyond
    ``max_model_len``, or a lifetime block budget above the pool."""
    if prompt_tokens <= 0:
        raise ValueError("empty prompt")
    total = prompt_tokens + max_new_tokens
    if max_model_len is not None and total > max_model_len:
        raise ValueError(
            f"{label}: prompt + max_new_tokens = {total} "
            f"exceeds max_model_len {max_model_len}")
    life = prompt_tokens + max(max_new_tokens - 1, 0)
    need = -(-max(life, 0) // block_size)       # BlockPool.blocks_for_tokens
    allocatable = num_blocks - 1                # null block reserved
    if need > allocatable:
        raise ValueError(
            f"{label}: needs {need} KV blocks, pool has {allocatable} "
            "total — raise serving.pool_blocks or shrink the request")


@dataclass
class Request:
    """One generation request riding the serving loop."""
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    on_finish: Optional[Callable[["Request"], None]] = None
    #: absolute monotonic deadline for a still-QUEUED request (None = none)
    deadline_ts: Optional[float] = None
    priority: str = STANDARD
    rid: int = field(default_factory=lambda: next(_rid))
    # -- filled by the engine -------------------------------------------------
    state: str = QUEUED
    output_tokens: List[int] = field(default_factory=list)
    prefix_hit_tokens: int = 0
    prefill_progress: int = 0        # prompt tokens whose K/V is in the pool
    arrival_ts: float = field(default_factory=time.monotonic)
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    error: Optional[str] = None

    @property
    def tokens(self) -> List[int]:
        return list(self.prompt) + list(self.output_tokens)

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, FAILED, TIMEOUT, SHED)

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_ts is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline_ts

    def _finish(self, state: str = FINISHED,
                error: Optional[str] = None) -> None:
        self.state = state
        self.error = error
        self.finish_ts = time.monotonic()
        if self.on_finish is not None:
            try:
                self.on_finish(self)
            except Exception:           # callbacks must not kill the loop
                logger.exception("serving: on_finish callback for request "
                                 "%d raised", self.rid)


class TieredQueue:
    """Priority-tiered FIFO queue: one deque per tier, highest tier first,
    strict FIFO within a tier, and an aging floor. Not locked itself:
    callers serialize access under their own lock."""

    def __init__(self, aging_s: float = 30.0):
        self.aging_s = float(aging_s)
        self._tiers: Dict[str, deque] = {t: deque() for t in PRIORITY_TIERS}

    @staticmethod
    def _tier(req) -> str:
        t = getattr(req, "priority", STANDARD)
        return t if t in TIER_RANK else STANDARD

    def append(self, req) -> None:
        self._tiers[self._tier(req)].append(req)

    def appendleft(self, req) -> None:
        """Front of the request's own tier (requeue / preemption)."""
        self._tiers[self._tier(req)].appendleft(req)

    def __len__(self) -> int:
        return sum(len(q) for q in self._tiers.values())

    def peeknext(self, now: Optional[float] = None):
        """The one logical head: the best (effective rank, arrival) among
        the tier heads; a head aged past ``aging_s`` competes at rank 0."""
        if now is None:
            now = time.monotonic()
        best_key, best = None, None
        for tier in PRIORITY_TIERS:
            q = self._tiers[tier]
            if not q:
                continue
            head = q[0]
            rank = TIER_RANK[tier]
            if rank and self.aging_s > 0 and \
                    (now - head.arrival_ts) > self.aging_s:
                rank = 0
            key = (rank, head.arrival_ts, TIER_RANK[tier])
            if best_key is None or key < best_key:
                best_key, best = key, head
        return best

    def remove(self, req) -> bool:
        """Remove a specific request; True iff it was queued."""
        q = self._tiers[self._tier(req)]
        try:
            q.remove(req)
            return True
        except ValueError:
            return False

    def remove_expired(self, now: float) -> List:
        """Extract every queued request past its deadline."""
        expired: List = []
        for tier, q in self._tiers.items():
            if any(r.expired(now) for r in q):
                expired.extend(r for r in q if r.expired(now))
                self._tiers[tier] = deque(r for r in q if not r.expired(now))
        return expired

    def shed_victim(self, arriving_rank: int):
        """The youngest queued request of the lowest tier strictly below
        ``arriving_rank``, extracted; None when no lower tier has any."""
        for tier in reversed(PRIORITY_TIERS):
            if TIER_RANK[tier] <= arriving_rank:
                return None
            q = self._tiers[tier]
            if q:
                return q.pop()
        return None


def admit_or_shed(tq: TieredQueue, req, max_queue: int,
                  batch_highwater: float = 1.0):
    """The admission ladder (caller holds its queue lock): appends ``req``
    and returns the shed victim to conclude, or raises
    :class:`AdmissionRejected`."""
    tier = TieredQueue._tier(req)
    depth = len(tq)
    if depth >= max_queue:
        victim = tq.shed_victim(TIER_RANK[tier])
        if victim is None:
            raise AdmissionRejected("queue_full", tier, depth, max_queue)
        tq.append(req)
        return victim
    if tier == BATCH and depth >= batch_highwater * max_queue:
        raise AdmissionRejected("batch_highwater", tier, depth, max_queue)
    tq.append(req)
    return None


class Scheduler:
    """FIFO queue + block-budget admission over a shared :class:`BlockPool`.
    ``submit`` may be called from any thread; admission and completion run
    on the serving loop's thread."""

    def __init__(self, pool: BlockPool, max_queue: int = 4096,
                 max_model_len: Optional[int] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 aging_s: float = 30.0, batch_highwater: float = 1.0):
        self.pool = pool
        self.prefix_cache = prefix_cache
        self.max_queue = int(max_queue)
        self.max_model_len = max_model_len
        self._queue = TieredQueue(aging_s=aging_s)
        self.batch_highwater = float(batch_highwater)
        self._lock = threading.Lock()
        self.timed_out = 0           # requests shed past their deadline
        self.shed = 0                # requests shed by the overload ladder

    def submit(self, req: Request) -> Request:
        """Enqueue; raises on a full queue or an over-long request."""
        check_admissible(len(req.prompt), req.max_new_tokens,
                         self.pool.block_size, self.pool.num_blocks,
                         self.max_model_len, label=f"request {req.rid}")
        with self._lock:
            victim = admit_or_shed(self._queue, req, self.max_queue,
                                   self.batch_highwater)
            if victim is not None:
                self.shed += 1
        if victim is not None:
            victim._finish(SHED, error=json.dumps(
                {"error": "shed", "reason": "displaced_by_tier",
                 "tier": TieredQueue._tier(victim)}, sort_keys=True))
        return req

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def pending(self) -> int:
        return len(self)

    def blocks_needed(self, req: Request, prefix_tokens: int = 0) -> int:
        """Lifetime block budget: prompt + max_new - 1 tokens (the final
        sampled token is never written back), minus a prefix hit."""
        life = len(req.prompt) + max(req.max_new_tokens - 1, 0)
        return self.pool.blocks_for_tokens(life - prefix_tokens)

    def shed_expired(self) -> List[Request]:
        """Conclude every still-queued request past its deadline with
        TIMEOUT (callbacks fire outside the queue lock)."""
        now = time.monotonic()
        with self._lock:
            expired = self._queue.remove_expired(now)
            self.timed_out += len(expired)
        for req in expired:
            logger.warning("serving: request %d shed past its deadline "
                           "after %.2fs queued", req.rid,
                           now - req.arrival_ts)
            req._finish(TIMEOUT, error="deadline exceeded while queued")
        return expired

    def next_admission(self) -> Optional[Request]:
        """Pop the head iff its block budget fits (net of its prefix hit,
        after evicting unused cached prefixes other than its own)."""
        with self._lock:
            head = self._queue.peeknext()
            if head is None:
                return None
            hit_tokens, hit_key = ((0, None) if self.prefix_cache is None
                                   else self.prefix_cache.peek(head.prompt))
            need = self.blocks_needed(head, prefix_tokens=hit_tokens)
            if need > self.pool.free_count and self.prefix_cache is not None:
                self.prefix_cache.evict(need, protect=hit_key)
            if need > self.pool.free_count:
                return None
            self._queue.remove(head)
            return head

    def requeue_front(self, req: Request) -> None:
        """Put an admission back at the head (transient allocation
        failure); FIFO order is preserved."""
        with self._lock:
            self._queue.appendleft(req)
