"""The stage interpreter and its transfer channels (counterpart of
``deepspeed_tpu/runtime/pipe/mpmd``): ``channel.py`` (``LocalChannel``
in one process, ``PipeGroupChannel`` over the ``pipe`` axis) and
``executor.py`` (``MPMDPipeline``, ``mpmd_value_and_grad``). The stage
worker (one stage as a supervised process), its driver
(``MPMDStageSupervisor``, ``StageWorkerSpec``) and ``SocketChannel`` are
not ported: they stand on the run-side heartbeats and watchdog and on
the transfer fabric that the serving fleet shares (ROADMAP.md item 4.3).
Their names raise ``NotImplementedError`` saying so."""

from .channel import ChannelTimeout, LocalChannel, PipeGroupChannel
from .executor import MPMDPipeline, mpmd_value_and_grad

__all__ = ["ChannelTimeout", "LocalChannel", "PipeGroupChannel",
           "MPMDPipeline", "mpmd_value_and_grad"]

_LATER = ("MPMDStageSupervisor", "StageWorkerSpec", "SocketChannel",
          "ChannelClosed")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"{name}: the MPMD stage worker, its driver and the socket "
            "transfer channel (runtime/pipe/mpmd/{stage_worker,driver}.py "
            "on runtime/fabric) are not ported to deepspeed_tpu_torch yet "
            "(see ROADMAP.md item 4.3)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
