"""deepspeed_tpu_torch.checkpoint — engines + universal-checkpoint utilities
(counterpart of ``deepspeed_tpu/checkpoint/``).

reference: deepspeed/runtime/checkpoint_engine/ (pluggable writers) and
deepspeed/checkpoint/ (DeepSpeedCheckpoint inspector + universal/reshape
machinery — largely mooted here because checkpoints are name-keyed whole
tensors, topology-free by construction).
"""

from .engine import (AsyncCheckpointEngine, CheckpointEngine, CommitResult,
                     NpzCheckpointEngine, build_checkpoint_engine)
from .universal import DeepSpeedCheckpoint, inspect_checkpoint

__all__ = ["CheckpointEngine", "NpzCheckpointEngine", "AsyncCheckpointEngine",
           "CommitResult", "build_checkpoint_engine", "DeepSpeedCheckpoint",
           "inspect_checkpoint"]
