"""Rank-aware logging (counterpart of ``deepspeed_tpu/utils/logging.py``).

The rank comes from ``torch.distributed`` when a process group is up, else
0. Records go to stderr, so a script's stdout carries only its results.
"""

import logging
import os
import sys
from typing import Iterable, Optional

_LOGGER_NAME = "deepspeed_tpu_torch"


def _create_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    level = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    logger.propagate = False
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(
        logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
                          datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(handler)
    return logger


logger = _create_logger()


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the listed ranks (None / [-1] = all)."""
    my_rank = _rank()
    ranks = None if ranks is None else list(ranks)
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
