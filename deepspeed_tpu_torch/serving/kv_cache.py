"""Paged KV cache: a fixed pool of blocks + per-sequence block tables.

Counterpart of ``deepspeed_tpu/serving/kv_cache.py`` (without its chaos
failpoints):

* one preallocated device pool ``[L, nh, num_blocks * block_size, hd]``
  (per k and v) shared by every in-flight sequence;
* a host-side :class:`BlockPool` allocator with reference counts, so
  blocks can be shared between sequences (prefix reuse);
* a :class:`PrefixCache` mapping token-prefix hashes to full-block runs
  of already prefilled prompts.

Blocks are shared at full-block granularity only, and a sequence writes
K/V only at positions at or past its fork point, so shared blocks are
read-only by construction. Physical block 0 is the NULL block: never
allocated, the write target of padded lanes, and never read.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

#: physical block 0 — the write sink for padded lanes, never allocated
NULL_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """Allocation would exceed the pool — the scheduler keeps the request
    QUEUED (admission control), never a crash."""


def init_pool(cfg, num_blocks: int, block_size: int, dtype=None,
              device=None, tp=None) -> Dict[str, torch.Tensor]:
    """Device pool: k/v ``[L, nh, num_blocks*block_size, hd]`` (flat slots,
    slot = block * block_size + offset; attention views the same memory
    as ``[L, nh, num_blocks, block_size, hd]``). ``dtype=torch.int8``
    adds f32 ``k_scale`` / ``v_scale`` ``[L, nh, slots, 1]``, one per row
    (``quant_format.kv_quantize``). Under TP (``tp``, a ``TPContext``) nh
    is this rank's query heads."""
    dtype = dtype or cfg.dtype
    nh = cfg.num_heads if tp is None else tp.heads(cfg)[0]
    shape = (cfg.num_layers, nh, num_blocks * block_size, cfg.head_dim)
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
    if dtype == torch.int8:
        return {"k": z(shape, torch.int8), "v": z(shape, torch.int8),
                "k_scale": z(shape[:-1] + (1,), torch.float32),
                "v_scale": z(shape[:-1] + (1,), torch.float32)}
    return {"k": z(shape, dtype), "v": z(shape, dtype)}


class BlockPool:
    """Host-side block allocator with refcounts. ``num_blocks`` counts the
    reserved null block: a pool of N blocks has N - 1 allocatable.
    alloc/fork/release are atomic under an internal lock."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is the null "
                             "block)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(num_blocks - 1, NULL_BLOCK, -1))
        self._refs: Dict[int, int] = {}
        self._mu = threading.Lock()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.block_size)

    def alloc(self, n: int) -> List[int]:
        """``n`` fresh private blocks (refcount 1); raises
        :class:`BlockPoolExhausted` when the pool can't cover them."""
        with self._mu:
            if n > len(self._free):
                raise BlockPoolExhausted(
                    f"need {n} blocks, {len(self._free)} free "
                    f"(pool {self.num_blocks - 1} x {self.block_size} "
                    "tokens)")
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
            return out

    def fork(self, blocks: Sequence[int]) -> List[int]:
        """Share ``blocks`` with another holder (+1 refcount each); the
        caller treats them as read-only."""
        with self._mu:
            for b in blocks:
                if b == NULL_BLOCK or b not in self._refs:
                    raise ValueError(f"fork of unallocated block {b}")
            for b in blocks:
                self._refs[b] += 1
            return list(blocks)

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; a block returns to the free list
        when its last holder releases it."""
        with self._mu:
            for b in blocks:
                refs = self._refs.get(b)
                if refs is None:
                    raise ValueError(f"release of unallocated block {b}")
                if refs > 1:
                    self._refs[b] = refs - 1
                else:
                    del self._refs[b]
                    self._free.append(b)


def _chain_keys(tokens: Sequence[int], block_size: int,
                max_blocks: int) -> List[str]:
    """Per-block-boundary prefix digests, computed incrementally: key k
    hashes tokens[:k*block_size] by extending one running sha1."""
    keys: List[str] = []
    h = hashlib.sha1()
    for k in range(max_blocks):
        for t in tokens[k * block_size:(k + 1) * block_size]:
            h.update(int(t).to_bytes(4, "little", signed=True))
        keys.append(h.hexdigest())
    return keys


class PrefixCache:
    """Token-prefix hash -> full-block run of an already-prefilled prompt.

    Entries hold their own refcount on the blocks (``pool.fork``), so a
    cached prefix outlives the request that made it; LRU eviction under
    allocation pressure releases them. Hash collisions are guarded by
    comparing the stored token prefix on match."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        # key -> (tokens ref, n_blocks, blocks, last_used)
        self._entries: Dict[str, Tuple[Tuple[int, ...], int, List[int],
                                       int]] = {}
        self._clock = 0
        self._mu = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def _lookup(self, tokens: Sequence[int]
                ) -> Tuple[int, Optional[str], List[int]]:
        """(n_cached_tokens, entry key, blocks) of the longest cached
        full-block prefix — no fork, no LRU touch."""
        bs = self.pool.block_size
        max_blocks = (len(tokens) - 1) // bs
        if max_blocks <= 0 or not self._entries:
            return 0, None, []
        keys = _chain_keys(tokens, bs, max_blocks)
        for k in range(max_blocks, 0, -1):
            ent = self._entries.get(keys[k - 1])
            if ent is None:
                continue
            etoks, ek, blocks, _ = ent
            if ek != k or tuple(etoks[:k * bs]) != \
                    tuple(int(t) for t in tokens[:k * bs]):
                continue                       # hash collision — skip
            return k * bs, keys[k - 1], blocks
        return 0, None, []

    def peek(self, tokens: Sequence[int]) -> Tuple[int, Optional[str]]:
        """(n_cached_tokens, entry key) without taking a reference."""
        with self._mu:
            n, key, _ = self._lookup(tokens)
            return n, key

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached full-block prefix of ``tokens``, capped at
        ``len(tokens) - 1`` so at least one token is left to prefill.
        Returns ``(n_cached_tokens, forked_blocks)``."""
        with self._mu:
            n, key, blocks = self._lookup(tokens)
            if key is None:
                return 0, []
            self._clock += 1
            ent = self._entries[key]
            self._entries[key] = (ent[0], ent[1], ent[2], self._clock)
            return n, self.pool.fork(blocks)

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> None:
        """Register every full-block prefix of a prefilled prompt; the cache
        forks the blocks it keeps, duplicate keys are refreshed."""
        bs = self.pool.block_size
        nfull = len(tokens) // bs
        if nfull <= 0:
            return
        shared = tuple(int(t) for t in tokens[:nfull * bs])
        keys = _chain_keys(shared, bs, nfull)
        with self._mu:
            for k in range(1, nfull + 1):
                key = keys[k - 1]
                self._clock += 1
                ent = self._entries.get(key)
                if ent is not None and ent[1] == k \
                        and ent[0][:k * bs] == shared[:k * bs]:
                    self._entries[key] = (ent[0], ent[1], ent[2],
                                          self._clock)
                    continue
                held = self.pool.fork(list(blocks[:k]))
                self._entries[key] = (shared, k, held, self._clock)

    def evict(self, need_blocks: int,
              protect: Optional[str] = None) -> int:
        """Release least-recently-used entries until ``need_blocks`` are
        free (or nothing evictable remains); ``protect`` exempts one
        entry key. Returns entries evicted."""
        evicted = 0
        with self._mu:
            while self.pool.free_count < need_blocks:
                victims = [k for k in self._entries if k != protect]
                if not victims:
                    break
                key = min(victims, key=lambda k: self._entries[k][3])
                _, _, blocks, _ = self._entries.pop(key)
                self.pool.release(blocks)
                evicted += 1
        return evicted


class SharedPagedState:
    """The paged-KV state: one device pool dict, one :class:`BlockPool`,
    one :class:`PrefixCache`. ``device_lock`` serializes the forward calls
    that update the pool."""

    def __init__(self, cfg, serving, dtype=None, device=None, tp=None):
        self.pool = BlockPool(serving.pool_blocks, serving.block_size)
        self.pools: Dict[str, Any] = init_pool(
            cfg, serving.pool_blocks, serving.block_size, dtype=dtype,
            device=device, tp=tp)
        self.prefix_cache = (PrefixCache(self.pool)
                             if serving.prefix_cache else None)
        self.device_lock = threading.Lock()

    def run(self, fn, params, *args):
        """Execute ``fn(params, pools, *args) -> out``; ``fn`` updates the
        pool tensors in place (torch has no buffer donation), so the lock
        spans the call."""
        with self.device_lock:
            return fn(params, self.pools, *args)
