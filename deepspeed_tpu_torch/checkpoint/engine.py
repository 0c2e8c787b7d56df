"""Pluggable checkpoint engines — sync, async (thread-offloaded) writers
(counterpart of ``deepspeed_tpu/checkpoint/engine.py``).

Capability parity with the reference's
``deepspeed/runtime/checkpoint_engine/checkpoint_engine.py`` (CheckpointEngine
ABC: create/save/load/commit) + the Nebula async engine (``nebula/``): the
engine abstraction lets save_checkpoint hand tensors to a writer that
persists them off the training thread; ``commit`` is the durability barrier.

The async engine is handed host copies taken SYNCHRONOUSLY by
``runtime.checkpointing.save_checkpoint`` (one pinned host copy per leaf:
the training step updates the master and moments in place) and performs
file IO on a worker thread — the part worth hiding, exactly what the
reference offloads to Nebula's service.

Failure semantics (round-3: crash-safe checkpointing):

- transient IO errors (``OSError``) retry with bounded exponential backoff
  before counting as a failure;
- a failed write poisons only ITS OWN checkpoint generation (``create``
  starts a new one), so one bad tag never blocks subsequent saves;
- ``commit`` returns a :class:`CommitResult` naming exactly which
  paths/jobs failed (truthy on success — existing ``assert commit(...)``
  call sites keep working) and quarantines the failed tag's staging dir;
- ``close()`` is the explicit shutdown (``__del__`` remains a safety net).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import logger


class CommitResult:
    """Outcome of a durability barrier. Truthy iff every write landed;
    ``failures`` lists (path-or-label, error) pairs so callers learn WHICH
    write failed, not just that one did."""

    __slots__ = ("failures",)

    def __init__(self, failures: Optional[List[Tuple[str, str]]] = None):
        self.failures: List[Tuple[str, str]] = list(failures or ())

    @property
    def ok(self) -> bool:
        return not self.failures

    def failed_paths(self) -> List[str]:
        return [path for path, _ in self.failures]

    def __bool__(self) -> bool:
        return self.ok

    def __repr__(self) -> str:
        if self.ok:
            return "CommitResult(ok)"
        return f"CommitResult(failures={self.failures!r})"


class CheckpointEngine:
    """reference: checkpoint_engine.py:19 — create/save/load/commit."""

    # sync engines may receive lazy (thunk-valued) flat dicts and stream
    # leaf-by-leaf; async engines need materialized host copies (the
    # training thread updates its tensors in place)
    wants_lazy = True

    def create(self, tag: str, stage_dir: Optional[str] = None) -> None:
        """Start of a checkpoint under ``tag``. ``stage_dir`` (when given)
        is the staging directory to quarantine if this tag's writes fail."""

    def run(self, fn: Callable[[], Any], label: Optional[str] = None) -> None:
        """Execute ``fn`` with this engine's ordering guarantees (async:
        after all previously submitted saves). ``label`` names the job in
        commit() failure reports."""
        fn()

    def save(self, state_dict: Dict[str, Any], path: str) -> None:
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        from ..runtime.checkpointing import read_flat_npz
        return read_flat_npz(path)

    def commit(self, tag: str) -> CommitResult:
        """Durability barrier: returns when everything under ``tag`` is on
        disk (reference: engine.commit for Nebula's async persistence)."""
        return CommitResult()

    def close(self) -> CommitResult:
        """Release resources. Idempotent; engines with pending writes drain
        them first."""
        return CommitResult()


class NpzCheckpointEngine(CheckpointEngine):
    """Synchronous writer (the reference's TorchCheckpointEngine role)."""

    def save(self, state_dict: Dict[str, Any], path: str) -> None:
        from ..runtime.checkpointing import write_flat_npz
        write_flat_npz(state_dict, path)


class AsyncCheckpointEngine(CheckpointEngine):
    """File IO on a worker thread; commit() joins all pending writes.

    reference: nebula/ async persistence + checkpoint/constants tagging.
    """

    wants_lazy = False

    def __init__(self, max_retries: int = 3, retry_backoff: float = 0.05):
        # one worker => FIFO: anything run() after save() lands after it —
        # the `latest`-after-data guarantee depends on this, so the worker
        # count is not configurable
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-writer")
        # (future, label, generation) — generation keys failure isolation
        # AND which staging dir to quarantine (commit may drain several
        # tags at once; quarantining "the current" stage dir would hit the
        # wrong tag's)
        self._pending: List[Tuple[Future, str, int]] = []
        self._lock = threading.Lock()
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self._gen = 0               # checkpoint generation (bumped by create)
        self._failed_gen = -1       # newest generation with a failed write
        self._gen_stage: Dict[int, Optional[str]] = {}
        self._closed = False

    def create(self, tag: str, stage_dir: Optional[str] = None) -> None:
        # a failed PREVIOUS tag must not poison this one: jobs carry their
        # generation, and the skip guard only fires within a generation
        with self._lock:
            self._gen += 1
            self._gen_stage[self._gen] = stage_dir

    def save(self, state_dict: Dict[str, Any], path: str) -> None:
        from ..runtime.checkpointing import write_flat_npz

        def job():
            write_flat_npz(state_dict, path)
            return path

        self.run(job, label=path)

    def run(self, fn: Callable[[], Any], label: Optional[str] = None) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncCheckpointEngine is closed")
            gen = self._gen
        name = label or getattr(fn, "__name__", "<job>")

        def guarded():
            # later jobs (e.g. the finalize/`latest` step) must not run
            # after an earlier write OF THE SAME TAG failed — `latest`
            # would point at a corrupt checkpoint
            with self._lock:
                poisoned = self._failed_gen == gen
            if poisoned:
                raise RuntimeError(
                    f"skipped '{name}': an earlier write for this "
                    "checkpoint failed")
            attempt = 0
            while True:
                try:
                    return fn()
                except OSError as e:
                    # transient IO: bounded exponential backoff, full
                    # rewrite per attempt (writers are idempotent)
                    attempt += 1
                    if attempt > self.max_retries:
                        with self._lock:
                            self._failed_gen = gen
                        raise
                    delay = self.retry_backoff * (2 ** (attempt - 1))
                    logger.warning(
                        "checkpoint write '%s' failed (%s); retry %d/%d "
                        "in %.2fs", name, e, attempt, self.max_retries,
                        delay)
                    time.sleep(delay)
                except Exception:
                    with self._lock:
                        self._failed_gen = gen
                    raise

        with self._lock:
            self._pending.append((self._pool.submit(guarded), name, gen))

    def commit(self, tag: str) -> CommitResult:
        with self._lock:
            pending, self._pending = self._pending, []
        failures: List[Tuple[str, str]] = []
        failed_gens = []
        for fut, name, gen in pending:
            try:
                fut.result()
            except Exception as e:
                logger.error("async checkpoint write failed: %s: %s",
                             name, e)
                failures.append((name, f"{e.__class__.__name__}: {e}"))
                if gen not in failed_gens:
                    failed_gens.append(gen)
        if failed_gens:
            from ..runtime.checkpointing import quarantine_staging
            for gen in failed_gens:
                with self._lock:
                    stage_dir = self._gen_stage.get(gen)
                if stage_dir is not None:
                    quarantine_staging(stage_dir, reason=failures[0][1])
        with self._lock:
            drained = {gen for _, _, gen in pending}
            for gen in drained:
                if gen != self._gen:        # current tag may still add jobs
                    self._gen_stage.pop(gen, None)
        return CommitResult(failures)

    def close(self, wait: bool = True) -> CommitResult:
        """Drain pending writes (``wait=True``) and shut the worker down.
        Idempotent; ``save``/``run`` after close raise."""
        with self._lock:
            if self._closed:
                return CommitResult()
            self._closed = True
        result = self.commit("close") if wait else CommitResult()
        self._pool.shutdown(wait=wait)
        return result

    def __del__(self):
        try:
            self.close(wait=False)
        except Exception:
            pass


def build_checkpoint_engine(config) -> CheckpointEngine:
    """Pick the writer from the ds_config (checkpoint.async_save, or the
    nebula section as its alias)."""
    ckpt = config.checkpoint
    async_save = bool(getattr(ckpt, "async_save", False))
    if getattr(config, "nebula", None) is not None and config.nebula.enabled:
        async_save = True
    if async_save:
        return AsyncCheckpointEngine(
            max_retries=int(getattr(ckpt, "write_retries", 3)),
            retry_backoff=float(getattr(ckpt, "write_retry_backoff", 0.05)))
    return NpzCheckpointEngine()
