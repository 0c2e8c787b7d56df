"""The stage interpreter, its transfer channels and the MPMD stage
processes (counterpart of ``deepspeed_tpu/runtime/pipe/mpmd``):

* ``channel.py`` — ``LocalChannel`` in one process, ``PipeGroupChannel``
  over the ``pipe`` axis, ``SocketChannel`` over the transfer fabric's
  TCP star (one process a stage);
* ``executor.py`` — ``MPMDPipeline``, ``mpmd_value_and_grad``;
* ``stage_worker.py`` — one stage as a supervised OS process: STAGE
  heartbeats, per-stage durable tags, the step watchdog, park/resync and
  the rc 0/114/117/118 contract;
* ``driver.py`` — ``MPMDStageSupervisor`` and ``StageWorkerSpec``: spawn
  the stage workers, route their transfers, restart only a dead stage and
  resync the survivors from its tag.
"""

from .channel import (ChannelClosed, ChannelTimeout, LocalChannel,
                      PipeGroupChannel, SocketChannel)
from .driver import MPMDStageSupervisor, StageWorkerSpec
from .executor import MPMDPipeline, mpmd_value_and_grad

__all__ = ["ChannelClosed", "ChannelTimeout", "LocalChannel",
           "PipeGroupChannel", "SocketChannel", "MPMDPipeline",
           "mpmd_value_and_grad", "MPMDStageSupervisor", "StageWorkerSpec"]
