"""Fabric wire format — length-prefixed JSON+bytes frames, CRC32 trailer.

    !II  (head_len, payload_len)
    head_len bytes of JSON meta
    payload_len bytes of payload
    !I   CRC32 over head + payload

The trailer is the corruption fence: a flipped bit anywhere in the frame
raises :class:`FrameCorrupt` (an ``OSError``) at receipt instead of
feeding silent garbage into ``np.frombuffer``/``np.load`` — peer-fatal,
because a torn frame also desynchronizes the length prefix and nothing
after it can be trusted. This module is the ONLY framing code in the
package; the process fleet's hub and its replica workers call these
functions.

``net.corrupt`` (flag mode, keyed by the sender's ident) flips one
payload bit AFTER the CRC is computed — on-wire corruption, proven
caught at the receiving end.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Optional, Tuple

from ...testing import chaos
from .endpoint import ChannelClosed, FrameCorrupt

_HDR = struct.Struct("!II")
_CRC = struct.Struct("!I")


def pack_frame(meta: dict, payload: bytes = b"", *,
               key: Optional[str] = None) -> bytes:
    head = json.dumps(meta, sort_keys=True).encode()
    crc = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
    if chaos.flag("net.corrupt", key=key):
        # on-wire bit flip, injected AFTER the trailer was computed —
        # the receiver's CRC check must catch it
        if payload:
            payload = bytes([payload[0] ^ 0x01]) + payload[1:]
        else:
            head = bytes([head[0] ^ 0x01]) + head[1:]
    return _HDR.pack(len(head), len(payload)) + head + payload \
        + _CRC.pack(crc)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ChannelClosed("peer closed the transfer connection")
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> Tuple[dict, bytes]:
    hlen, plen = _HDR.unpack(_read_exact(sock, _HDR.size))
    head = _read_exact(sock, hlen)
    payload = _read_exact(sock, plen) if plen else b""
    want, = _CRC.unpack(_read_exact(sock, _CRC.size))
    got = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
    if got != want:
        raise FrameCorrupt(
            f"frame CRC mismatch (want {want:#010x}, got {got:#010x}) — "
            "corrupted link, stream unrecoverable")
    return json.loads(head.decode()), payload


def write_frame(sock: socket.socket, meta: dict, payload: bytes = b"", *,
                key: Optional[str] = None) -> None:
    sock.sendall(pack_frame(meta, payload, key=key))
