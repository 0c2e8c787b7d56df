"""The stage interpreter and its transfer channels (counterpart of
``deepspeed_tpu/runtime/pipe/mpmd``): ``channel.py`` (``LocalChannel``
in one process, ``PipeGroupChannel`` over the ``pipe`` axis) and
``executor.py`` (``MPMDPipeline``, ``mpmd_value_and_grad``). The stage
worker, its driver and ``SocketChannel`` are not ported (ROADMAP.md item
4.1)."""

from .channel import ChannelTimeout, LocalChannel, PipeGroupChannel
from .executor import MPMDPipeline, mpmd_value_and_grad

__all__ = ["ChannelTimeout", "LocalChannel", "PipeGroupChannel",
           "MPMDPipeline", "mpmd_value_and_grad"]
