"""Per-op communication accounting (counterpart of
``deepspeed_tpu/comm/logging.py``; reference
``deepspeed/utils/comms_logging.py``: per-op records and the
``log_summary`` table).

Two ledgers: :class:`CommsLogger` records (bytes, seconds) per call while
the ``comms_logger`` section enables it, as the JAX package's does; the
facade's counts (``comm.op_counts``) are always on, one per collective
issued, as each kernel wrapper counts its launches. The seconds are the
host time of the call: NCCL returns once the collective is queued, so
they are launch times, not transfer times.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} PB"


class CommsLogger:
    def __init__(self, enabled: bool = False, verbose: bool = False,
                 prof_all: bool = True, debug: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.debug = debug
        # op name -> list of (nbytes, seconds)
        self.comms_dict: Dict[str, List] = defaultdict(list)

    def configure(self, enabled: bool = False, verbose: bool = False,
                  prof_all: bool = True, debug: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.debug = debug

    def append(self, op_name: str, nbytes: int, seconds: float):
        self.comms_dict[op_name].append((nbytes, seconds))
        if self.verbose:
            from ..utils.logging import logger
            logger.info(f"comm op: {op_name} | size: {_fmt_bytes(nbytes)}")

    def reset(self):
        self.comms_dict.clear()

    def log_summary(self) -> str:
        lines = [f"{'Op':<20}{'Count':>8}{'Total Size':>14}"
                 f"{'Total Host Time':>18}"]
        for op, recs in sorted(self.comms_dict.items()):
            total_bytes = sum(r[0] for r in recs)
            total_time = sum(r[1] for r in recs)
            lines.append(f"{op:<20}{len(recs):>8}{_fmt_bytes(total_bytes):>14}"
                         f"{total_time * 1e3:>15.2f} ms")
        out = "\n".join(lines)
        from ..utils.logging import logger
        logger.info("\n" + out)
        return out
