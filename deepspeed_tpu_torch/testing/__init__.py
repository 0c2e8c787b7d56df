"""deepspeed_tpu_torch.testing — fault-injection / chaos utilities.

Production code calls ``chaos.failpoint`` at checkpoint-critical sites;
with no failpoints armed every call is a dict lookup that misses.
"""

from . import chaos

__all__ = ["chaos"]
