"""Training-integrity sentinel: the part of
``deepspeed_tpu/runtime/sentinel.py`` that ``runtime/straggler.py``
stands on — the ``SDC`` heartbeat flag and the rolling robust
(median / MAD) statistics. The training sentinel itself
(``TrainingSentinel``, its remediation ladder and the audited-clean
resume) is a later slice of the port (see ROADMAP.md).
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

#: heartbeat flag stamped by a rank whose device(s) lost the checksum
#: majority vote — the elastic agent and supervisors read it as blacklist
#: evidence against that rank's host.
SDC_FLAG = "SDC"


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
