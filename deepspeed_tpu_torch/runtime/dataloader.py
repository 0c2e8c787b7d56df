"""Data loading: deterministic batching over indexable datasets.

The port's own copy of the JAX-free ``deepspeed_tpu/runtime/dataloader.py``
(DeepSpeedDataLoader, RepeatingLoader): the same batches in the same order
from the same seed. Batches are numpy arrays; the engine moves them to its
device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np


class RepeatingLoader:
    """reference: runtime/dataloader.py:16 — wraps an iterator to restart on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def fast_forward(self, num_batches: int) -> None:
        """Deterministically position the stream as if ``num_batches`` had
        been consumed — the resume half of ``engine.data_position``: after
        a rollback-abort or SDC relaunch the restored state must NOT
        re-see the batches it already trained on (the poisoned span among
        them). Delegates to the wrapped loader's own ``fast_forward`` when
        it has one (epoch-aware, O(1)); otherwise drains ``num_batches``
        items (correct for any iterator, O(n))."""
        ff = getattr(self.loader, "fast_forward", None)
        if callable(ff):
            ff(num_batches)
            self.data_iter = iter(self.loader)
            return
        for _ in range(int(num_batches)):
            next(self)


def _default_collate(samples):
    """Stack a list of samples (tuples/dicts/arrays) into batch arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([np.asarray(s[i]) for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batched, shuffled, epoch-aware loader. reference: runtime/dataloader.py:39."""

    def __init__(self,
                 dataset,
                 batch_size: int,
                 shuffle: bool = True,
                 seed: int = 42,
                 drop_last: bool = True,
                 collate_fn: Optional[Callable] = None,
                 data_sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.data_sampler = data_sampler
        self.epoch = 0
        self._start_batch = 0       # in-epoch offset set by fast_forward
        self.len = len(dataset) // batch_size if drop_last else \
            (len(dataset) + batch_size - 1) // batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.len

    def fast_forward(self, num_batches: int) -> None:
        """O(1) deterministic reposition: the loader behaves as if
        ``num_batches`` global batches had already been drawn — same
        epoch boundary, same per-epoch permutation (seed + epoch), so a
        resumed run sees exactly the batches a never-interrupted run
        would see next. Feeds ``engine.fast_forward_dataloader`` at
        resume (docs/RESILIENCE.md: the poisoned span is skipped, not
        replayed).

        With an external ``data_sampler`` the guarantee holds only if
        the sampler derives its order from ``set_epoch`` (the torch
        idiom — ``__iter__`` forwards the epoch); a sampler carrying
        hidden iteration state of its own cannot be repositioned from
        here, so the resume may re-see consumed batches."""
        if self.len <= 0:
            return
        num_batches = max(0, int(num_batches))
        self.epoch = num_batches // self.len
        self._start_batch = num_batches % self.len
        if self.data_sampler is not None and not callable(
                getattr(self.data_sampler, "set_epoch", None)):
            from ..utils.logging import logger
            logger.warning(
                f"fast_forward with a {type(self.data_sampler).__name__} "
                "sampler that has no set_epoch(): the resumed order "
                "depends on the sampler's own state — the skipped span "
                "may be partially re-seen")

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        if self.data_sampler is not None:
            # epoch-aware samplers (the torch set_epoch idiom) re-derive
            # their order from the epoch — which also makes fast_forward's
            # multi-epoch reposition honest for them
            se = getattr(self.data_sampler, "set_epoch", None)
            if callable(se):
                se(self.epoch)
            order = np.asarray(list(iter(self.data_sampler)))
        elif self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        limit = self.len * self.batch_size if self.drop_last else n
        first = self._start_batch * self.batch_size
        self._start_batch = 0       # one partial epoch, then full ones
        for start in range(first, limit, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
        self.epoch += 1
