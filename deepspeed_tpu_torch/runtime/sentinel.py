"""Training-integrity sentinel (counterpart of
``deepspeed_tpu/runtime/sentinel.py``): detect wrong numbers, not just
dead ranks.

**Detection.** The train step already computes the global grad norm;
with the ``integrity`` config section enabled it also computes the
update norm and the param norm as tensor ops on the step's device, and
every step's scalars ride ``_after_step``'s one batched ``.cpu()`` pull.
The host-side :class:`TrainingSentinel` keeps rolling ROBUST statistics
per metric (median/MAD z-score — a single spike cannot drag the baseline
the way a mean/std would) with a warmup before any verdict and a
cooldown so one event counts once.

**Remediation ladder** (each rung strictly stronger, each rung observable):

1. **skip** — the sentinel feeds the step a grad-norm ceiling derived
   from its rolling stats; the step skips the update when the raw global
   norm exceeds it, through the SAME keep-old-state path the fp16 loss
   scaler and the bf16 non-finite guard use.
2. **rollback** — ``rollback_after`` strikes inside ``strike_window``
   steps roll the engine back to the newest intact checkpoint through the
   verified loader. The data pipeline is NOT rewound — the poisoned span
   is fast-forwarded past (``engine.data_position``).
3. **abort** — a spike that reproduces after a rollback is not data, it
   is the run: raise :class:`TrainingIntegrityError`, whose
   ``exit_code`` (:data:`INTEGRITY_EXIT_CODE`) launch.py turns into a
   distinct rc.

``TrainState.nonfinite_streak`` counts consecutive skipped steps of ANY
kind (overflow, non-finite, sentinel spike), and
:meth:`TrainingSentinel.observe` raises :class:`NonFiniteError` when it
reaches the configured bound.

**Cross-replica SDC audit.** Every ``integrity.audit_interval`` steps the
engine hashes the bytes of every leaf that the data-parallel replicas
hold identically; the per-rank checksums are all-gathered and
:func:`compare_replica_checksums` takes the majority vote. The implicated
rank stamps an ``SDC`` flag into its heartbeat record, and every rank
aborts with :data:`INTEGRITY_EXIT_CODE` so the relaunch resumes from the
last audited-clean checkpoint (the ``last_audited_clean`` marker).
"""

from __future__ import annotations

import math
from collections import Counter, deque
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.logging import logger

#: rc for an integrity abort (ladder rung 3, or a detected SDC) — distinct
#: from clean 0, preemption, and stall: the run is *wrong*, not dead or
#: slow, and must not silently relaunch into the same divergence without
#: the operator being able to tell. Re-exported from the single-source
#: contract module.
from ..exit_codes import INTEGRITY_EXIT_CODE  # noqa: E402

#: heartbeat flag stamped by a rank whose device(s) lost the checksum
#: majority vote — the elastic agent and supervisors read it as blacklist
#: evidence against that rank's host.
SDC_FLAG = "SDC"

#: sentinel verdicts (observe() return values)
OK = "ok"
COOLDOWN = "cooldown"       # anomaly inside the cooldown window: no new strike
STRIKE = "strike"           # anomaly recorded (rung 1 already acted in the step)
ROLLBACK = "rollback"       # rung 2: caller must restore the last intact tag


class TrainingIntegrityError(RuntimeError):
    """The remediation ladder ran out of rungs: a spike reproduced after a
    rollback, a rollback was needed but no checkpoint exists, or a
    cross-replica SDC audit failed. ``exit_code`` is the process rc
    contract (launch.py maps an uncaught integrity error onto it)."""

    exit_code = INTEGRITY_EXIT_CODE


class NonFiniteError(TrainingIntegrityError):
    """The non-finite/skip streak guard tripped: ``abort_after``
    consecutive steps were skipped in the step (inf/nan grads, or sentinel
    spikes). Each of those steps left params/optimizer untouched, so the
    last checkpoint — and even the live state — is still clean to restart
    from."""


def _median(vals) -> float:
    """Median of a non-empty sequence — shared by the rolling baselines
    here and the cross-rank straggler detector (runtime/straggler.py)."""
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class RollingRobust:
    """Rolling median/MAD over the last ``window`` accepted samples.

    Robust by construction: a handful of outliers cannot drag the median
    or inflate the MAD the way they would a mean/std, so the detector's
    baseline survives the very anomalies it exists to catch."""

    #: MAD -> sigma for a normal distribution
    _K = 1.4826

    def __init__(self, window: int):
        self.buf: deque = deque(maxlen=max(4, int(window)))

    def __len__(self) -> int:
        return len(self.buf)

    def push(self, x: float) -> None:
        self.buf.append(float(x))

    def stats(self) -> Optional[Tuple[float, float]]:
        """(median, robust sigma), or None with < 4 samples. The sigma is
        floored so a perfectly-flat warmup (MAD 0) cannot turn the first
        jitter into an anomaly."""
        if len(self.buf) < 4:
            return None
        vals = list(self.buf)
        med = _median(vals)
        mad = _median([abs(v - med) for v in vals])
        sigma = self._K * mad
        floor = max(abs(med), 1.0) * 1e-3
        return med, max(sigma, floor)

    def zscore(self, x: float) -> Optional[float]:
        st = self.stats()
        if st is None:
            return None
        med, sigma = st
        return (x - med) / sigma

    def threshold(self, zmax: float) -> Optional[float]:
        st = self.stats()
        if st is None:
            return None
        med, sigma = st
        return med + zmax * sigma


class TrainingSentinel:
    """Host half of the integrity layer: consumes the per-step host
    metrics (one batched pull), keeps the rolling robust stats, hands the
    engine the next step's skip ceiling, and walks the remediation
    ladder. See the module docstring for the ladder semantics."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.enabled = bool(cfg.enabled)
        self.nonfinite_abort_after = int(cfg.nonfinite_abort_after)
        # grad_norm is tracked whenever the skip rung is on, even if the
        # user dropped it from cfg.metrics — the skip ceiling is derived
        # from ITS rolling stats, and a configured-on rung that silently
        # never arms is worse than an extra tracked scalar
        tracked = list(cfg.metrics)
        if cfg.skip and "grad_norm" not in tracked:
            tracked.append("grad_norm")
        self.stats: Dict[str, RollingRobust] = {
            m: RollingRobust(cfg.window) for m in tracked}
        self.accepted = 0               # clean samples folded into the window
        self.strikes: deque = deque()   # steps at which anomalies struck
        self.cooldown_until = -1
        self.rollbacks_done = 0         # rollbacks since the last clean stretch
        self.last_rollback_step: Optional[int] = None
        self.last_clean_audit_step: Optional[int] = None
        self.sdc_detected = False
        self.last_verdict = OK
        self.last_anomaly: Optional[str] = None

    # ------------------------------------------------------------ engine feed

    @property
    def wants_every_step(self) -> bool:
        """With the detector on, every step's scalars must reach the host
        (still ONE batched pull per step); streak-only mode keeps the
        print-step cadence the PR-3 guard shipped with."""
        return self.enabled

    @property
    def metric_keys(self) -> Tuple[str, ...]:
        """Metric names the engine folds into its batched pull."""
        keys = ["loss", "lr", "grad_norm", "loss_scale"]
        if self.nonfinite_abort_after > 0 or self.enabled:
            keys.append("nonfinite_streak")
        if self.enabled:
            keys += [m for m in self.stats if m not in keys]
            keys += ["overflow", "anomaly_skip"]
        return tuple(dict.fromkeys(keys))

    def spike_limit(self) -> Optional[float]:
        """Grad-norm ceiling for the NEXT step's skip
        (ladder rung 1); +inf while warming up, so the step always takes
        a ceiling once the skip rung is on."""
        if not self.enabled or not self.cfg.skip:
            return None
        if "grad_norm" not in self.stats or \
                self.accepted < self.cfg.warmup_steps:
            return math.inf
        thr = self.stats["grad_norm"].threshold(self.cfg.zmax)
        return math.inf if thr is None else float(thr)

    # -------------------------------------------------------------- detection

    def _armed(self) -> bool:
        return self.accepted >= self.cfg.warmup_steps

    def observe(self, step: int, host: Dict[str, float]) -> str:
        """Walk the ladder for one step's host metrics. Raises
        :class:`NonFiniteError` on the skip-streak bound and
        :class:`TrainingIntegrityError` when a rollback-grade anomaly
        reproduces after ``abort_after_rollbacks`` rollbacks; otherwise
        returns a verdict (the engine performs ROLLBACK itself — it owns
        the checkpoint dir and the data pipeline)."""
        streak = int(host.get("nonfinite_streak", 0) or 0)
        if 0 < self.nonfinite_abort_after <= streak:
            raise NonFiniteError(
                f"{streak} consecutive non-finite/skipped steps at global "
                f"step {step} "
                f"(integrity.nonfinite_abort_after="
                f"{self.nonfinite_abort_after}); the run has diverged — "
                "restart from the last checkpoint with a lower lr / higher "
                "warmup")
        if not self.enabled:
            self.last_verdict = OK
            return OK

        anomalies: List[str] = []
        skipped = bool(host.get("anomaly_skip", 0)) or bool(
            host.get("overflow", 0))
        if host.get("anomaly_skip", 0):
            # the JAX package's wording, so both sentinels log alike
            anomalies.append("in-jit grad-norm spike (batch skipped)")
        clean_values: List[Tuple[str, float]] = []
        for m in self.stats:
            if m not in host:
                continue
            v = float(host[m])
            if not math.isfinite(v):
                if not skipped:
                    anomalies.append(f"{m} non-finite")
                continue
            z = self.stats[m].zscore(v) if self._armed() else None
            if z is not None and z > self.cfg.zmax:
                anomalies.append(f"{m}={v:.6g} (robust z={z:.1f} > "
                                 f"{self.cfg.zmax:g})")
            elif not skipped:
                clean_values.append((m, v))

        if not anomalies:
            for m, v in clean_values:
                self.stats[m].push(v)
            if clean_values:
                self.accepted += 1
            if self.rollbacks_done and self.last_rollback_step is not None \
                    and step - self.last_rollback_step > self.cfg.strike_window:
                # a clean stretch after a rollback retires the "reproduced
                # post-rollback" abort arm — the rollback worked
                self.rollbacks_done = 0
            self.last_verdict = OK
            return OK

        self.last_anomaly = "; ".join(anomalies)
        if step < self.cooldown_until:
            self.last_verdict = COOLDOWN
            return COOLDOWN
        self.cooldown_until = step + self.cfg.cooldown_steps
        self.strikes.append(step)
        while self.strikes and self.strikes[0] < step - self.cfg.strike_window:
            self.strikes.popleft()
        logger.warning(
            "integrity sentinel: anomaly at step %d (%s) — strike %d/%d "
            "in the last %d steps", step, self.last_anomaly,
            len(self.strikes), self.cfg.rollback_after,
            self.cfg.strike_window)
        if len(self.strikes) >= self.cfg.rollback_after:
            self.strikes.clear()
            if self.rollbacks_done >= self.cfg.abort_after_rollbacks:
                raise TrainingIntegrityError(
                    f"anomaly reproduced after {self.rollbacks_done} "
                    f"rollback(s) at step {step} ({self.last_anomaly}); "
                    "the divergence is not the data — aborting with rc "
                    f"{INTEGRITY_EXIT_CODE} (inspect lr/init/hardware "
                    "before resuming)")
            self.last_verdict = ROLLBACK
            return ROLLBACK
        self.last_verdict = STRIKE
        return STRIKE

    # ------------------------------------------------------------ remediation

    def note_rollback(self, restored_step: int) -> None:
        """Called by the engine AFTER the verified restore: the ladder
        advances one rung, the strike window resets, and a post-rollback
        cooldown absorbs the detector's view of the restored state."""
        self.rollbacks_done += 1
        self.last_rollback_step = restored_step
        self.strikes.clear()
        self.cooldown_until = restored_step + self.cfg.cooldown_steps

    def note_clean_audit(self, step: int) -> None:
        self.last_clean_audit_step = step


# ---------------------------------------------------------------------------
# Cross-replica SDC audit: host-side vote over per-device checksums
# ---------------------------------------------------------------------------

def compare_replica_checksums(values: Iterable[Tuple[str, int]]
                              ) -> List[str]:
    """Majority vote over ``(replica_key, checksum)`` pairs: the keys whose
    checksum lost the vote — the implicated replicas. With no strict
    winner (e.g. a 1-vs-1 mismatch across two replicas) EVERY key is
    implicated: the mismatch is certain, the culprit is not, and
    supervision must treat both copies as suspect rather than guess."""
    pairs = list(values)
    if len(pairs) < 2:
        return []
    counts = Counter(v for _, v in pairs)
    if len(counts) == 1:
        return []
    ranked = counts.most_common()
    top, top_n = ranked[0]
    if len(ranked) > 1 and ranked[1][1] == top_n:
        return [k for k, _ in pairs]
    return [k for k, v in pairs if v != top]


#: name of the marker file (inside a checkpoint save dir) naming the
#: newest tag that existed at the last CLEAN cross-replica audit — the
#: tag a post-SDC relaunch should resume from (tags written after the
#: last clean audit may carry the corruption that the audit later caught).
LAST_AUDITED_CLEAN_FILE = "last_audited_clean"


def write_last_audited_clean(save_dir: str, tag: str) -> None:
    """Atomic marker update (tmp + replace, like the `latest` pointer).
    Failures are swallowed: the marker is an optimization of WHERE to
    resume, never a condition for resuming at all."""
    import os
    try:
        tmp = os.path.join(save_dir, LAST_AUDITED_CLEAN_FILE + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(tag)
        os.replace(tmp, os.path.join(save_dir, LAST_AUDITED_CLEAN_FILE))
    except OSError as e:
        logger.warning("integrity: cannot write %s marker under %s: %s",
                       LAST_AUDITED_CLEAN_FILE, save_dir, e)


def read_last_audited_clean(save_dir: str) -> Optional[str]:
    import os
    path = os.path.join(save_dir, LAST_AUDITED_CLEAN_FILE)
    try:
        with open(path, encoding="utf-8") as f:
            tag = f.read().strip()
    except OSError:
        return None
    return tag or None
