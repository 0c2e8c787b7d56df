"""One fault-tolerant transfer fabric (counterpart of
``deepspeed_tpu/runtime/fabric/``: the same frame bytes, so a frame one
package writes the other reads).

The package's single cross-boundary channel layer: the disagg block
handoff (`serving/disagg.py`) and the process-placement serving fleet
ride ONE :class:`Endpoint` contract with one failure model:

* length-prefixed frames with a CRC32 trailer (:mod:`.frame`) — a
  corrupted frame is a peer-fatal :class:`FrameCorrupt`, never silent
  garbage;
* generation-fenced delivery — a reconnected peer's stale in-flight
  frames are dropped at receipt;
* bounded jittered reconnect/backoff on dial and mid-stream ``OSError``
  (:class:`RedialPolicy`), per-recv deadlines raising
  :class:`ChannelTimeout`;
* peer-death verdicts stay in the heartbeat channel — the fabric
  reports LINK state only;
* the six ``net.*`` chaos failpoints live at this layer, so every
  transport inherits the same fault-injection surface.

Backends: :class:`LocalEndpoint` (in-process queue with an optional
placement hook, the CPU-testable reference) and :class:`SocketEndpoint` /
:class:`HubConn` (the hardened TCP star). docs/RESILIENCE.md §"The
transfer fabric" has the delivery contract and the failpoint table.
"""

from .endpoint import (ChannelClosed, ChannelTimeout, Endpoint,
                       FrameCorrupt, RedialPolicy, WriteLockStarved)
from .frame import pack_frame, read_frame, write_frame
from .local import LocalEndpoint
from .sockets import HubConn, SocketEndpoint

__all__ = ["Endpoint", "LocalEndpoint", "SocketEndpoint", "HubConn",
           "RedialPolicy", "ChannelTimeout", "ChannelClosed",
           "FrameCorrupt", "WriteLockStarved",
           "pack_frame", "read_frame", "write_frame"]
