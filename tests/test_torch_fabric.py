"""Port parity: the transfer fabric (``deepspeed_tpu_torch/runtime/fabric``)
against the JAX package's.

* frames packed by one package are read by the other, byte for byte the
  same wire format (length prefix, JSON meta, payload, CRC32 trailer);
* a corrupted frame raises each package's ``FrameCorrupt``, and the
  port's ``net.corrupt`` failpoint flips a bit on the wire after the
  trailer was computed;
* ``LocalEndpoint`` and a loopback ``SocketEndpoint`` pass the same
  message sequences as JAX's, including timeouts, generation fences,
  redials and closes — each spoke dialing one hub built from the port's
  ``HubConn``.

Pure sockets and threads: no model, no device.
"""

import socket
import threading
import time

import pytest

from deepspeed_tpu.runtime import fabric as jfab

from deepspeed_tpu_torch.runtime import fabric as tfab
from deepspeed_tpu_torch.testing import chaos

PKGS = {"port": tfab, "jax": jfab}


@pytest.fixture(autouse=True)
def _port_chaos():
    chaos.reset_for_tests()
    yield
    chaos.reset_for_tests()


def _pipe():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


# --------------------------------------------------------------------------
# frame codec across the packages


@pytest.mark.parametrize("payload", [b"\x00\x01block-bytes\xff", b""])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_frames_cross_between_packages(writer, reader, payload):
    meta = {"cmd": "prog", "rid": 7, "toks": [1, 2, 3], "base": 0}
    assert tfab.pack_frame(meta, payload) == jfab.pack_frame(meta, payload)
    a, b = _pipe()
    try:
        PKGS[writer].write_frame(a, meta, payload)
        PKGS[writer].write_frame(a, {"empty": True})
        got = PKGS[reader].read_frame(b)
        assert got == (meta, payload)
        assert PKGS[reader].read_frame(b) == ({"empty": True}, b"")
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("where", ["head", "payload", "trailer"])
def test_corrupted_frame_raises_frame_corrupt(pkg, where):
    frame = bytearray(tfab.pack_frame({"cmd": "x", "seq": 1}, b"payload"))
    hlen = len(b'{"cmd": "x", "seq": 1}')
    pos = {"head": 8 + 2, "payload": 8 + hlen + 3, "trailer": len(frame) - 1}
    frame[pos[where]] ^= 0x01
    a, b = _pipe()
    try:
        a.sendall(bytes(frame))
        with pytest.raises(PKGS[pkg].FrameCorrupt):
            PKGS[pkg].read_frame(b)
        assert issubclass(PKGS[pkg].FrameCorrupt, OSError)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("payload", [b"block-bytes", b""])
def test_net_corrupt_flips_on_wire_and_jax_catches_it(payload):
    """The port's ``net.corrupt`` flag flips a bit after the trailer was
    computed; the JAX reader (and the port's) rejects the frame."""
    chaos.arm("net.corrupt", mode="flag", times=2)
    frames = [tfab.pack_frame({"seq": i}, payload) for i in range(2)]
    for pkg, frame in zip(("jax", "port"), frames):
        a, b = _pipe()
        try:
            a.sendall(frame)
            with pytest.raises(PKGS[pkg].FrameCorrupt):
                PKGS[pkg].read_frame(b)
        finally:
            a.close()
            b.close()
    clean = tfab.pack_frame({"seq": 9}, payload)
    assert clean == jfab.pack_frame({"seq": 9}, payload)


# --------------------------------------------------------------------------
# LocalEndpoint: one script, both packages, equal transcripts


def _local_script(fab):
    out = []

    def attempt(fn):
        try:
            r = fn()
            out.append(("ok", r))
        except (fab.ChannelTimeout, fab.ChannelClosed) as e:
            out.append(("raise", type(e).__name__))

    ep = fab.LocalEndpoint("loop", fence=True)
    for i in range(3):
        ep.send({"seq": i}, f"p{i}".encode())
    attempt(lambda: ep.pending())
    attempt(lambda: ep.recv(timeout=0.0))
    ep.generation = 1                   # a resync: older data is stale
    ep.send({"seq": 3}, b"p3")
    attempt(lambda: [m["seq"] for m, _ in ep.peek_all()])
    attempt(lambda: ep.recv(timeout=0.0))         # gen 0 dropped, gen 1 out
    ep.generation = 0
    ep.send({"cmd": "stop"}, b"")                 # control: never fenced
    ep.generation = 2
    attempt(lambda: ep.recv(timeout=0.0))
    attempt(lambda: ep.recv(timeout=0.0))         # empty poll
    t0 = time.monotonic()
    attempt(lambda: ep.recv(timeout=0.05))        # a positive deadline
    out.append(("waited", time.monotonic() - t0 >= 0.04))
    ep.send({"seq": 4}, b"x")
    ep.send({"seq": 5}, b"y")
    attempt(lambda: [m["seq"] for m, _ in
                     ep.purge(lambda m, _p: m["seq"] == 4)])
    attempt(lambda: [m["seq"] for m, _ in ep.clear()])
    threading.Timer(0.05, lambda: ep.send({"seq": 6}, b"late")).start()
    attempt(lambda: ep.recv(timeout=2.0))         # woken by the send
    ep.close()
    attempt(lambda: ep.recv(timeout=0.0))
    attempt(lambda: ep.send({"seq": 7}))
    return out


def test_local_endpoint_sequences_match_jax():
    port, jax_side = _local_script(tfab), _local_script(jfab)
    assert port == jax_side
    assert ("raise", "ChannelTimeout") in port
    assert port[-2:] == [("raise", "ChannelClosed"), ("raise", "ChannelClosed")]


def test_local_endpoint_chaos_surface():
    ep = tfab.LocalEndpoint("loop")
    chaos.arm("net.send")
    with pytest.raises(chaos.ChaosError):
        ep.send({"seq": 0})
    chaos.disarm()
    ep.send({"seq": 0})
    chaos.arm("net.recv")
    with pytest.raises(chaos.ChaosError):
        ep.recv(timeout=0.0)


# --------------------------------------------------------------------------
# SocketEndpoint: a port hub, spokes of both packages, equal transcripts


class MiniHub:
    """Per-ident epochs, recorded frames, from the port's HubConn."""

    def __init__(self):
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.addr = self.srv.getsockname()
        self.epochs, self.conns, self.frames = {}, {}, []
        self._mu = threading.Lock()
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while not self._stop.is_set():
            try:
                sock, _ = self.srv.accept()
            except OSError:
                return
            if self._stop.is_set():
                sock.close()
                continue
            threading.Thread(target=self._serve, args=(sock,),
                             daemon=True).start()

    def _serve(self, sock):
        try:
            hello, _ = tfab.read_frame(sock)
        except OSError:
            sock.close()
            return
        ident = hello.get("ident", "?")
        with self._mu:
            self.epochs[ident] = self.epochs.get(ident, 0) + 1
            conn = tfab.HubConn(sock, ident, gen=self.epochs[ident])
            self.conns[ident] = conn
        conn.welcome()
        while True:
            try:
                meta, payload = tfab.read_frame(sock)
            except OSError:
                break
            with self._mu:
                self.frames.append((ident, meta, payload))
        conn.close()

    @staticmethod
    def sever(conn):
        try:
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        conn.close()

    def conn(self, ident, gen=None, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mu:
                c = self.conns.get(ident)
                if c is not None and (gen is None or c.gen == gen):
                    return c
            time.sleep(0.01)
        raise AssertionError(f"no hub connection for {ident}")

    def wait_frames(self, n, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mu:
                if len(self.frames) >= n:
                    return list(self.frames)
            time.sleep(0.01)
        with self._mu:
            return list(self.frames)

    def close(self):
        self._stop.set()
        try:
            self.srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.srv.close()
        with self._mu:
            conns = list(self.conns.values())
        for c in conns:
            self.sever(c)


def _socket_script(fab):
    """One spoke of package ``fab`` through a session against the port
    hub; returns the transcript (what the spoke saw, what the hub got)."""
    hub = MiniHub()
    out = []
    ep = fab.SocketEndpoint(
        tuple(hub.addr), "spoke-0", hello={"replica": 0},
        connect_timeout=5.0,
        redial=fab.RedialPolicy(attempts=2, base=0.01, cap=0.05,
                                dial_timeout=0.3))
    try:
        out.append(("gen", ep.generation))
        ep.send({"cmd": "ready"})
        ep.send({"seq": 1}, b"tokens")
        got = hub.wait_frames(2)
        out.append(("hub", [(m, p) for _, m, p in got]))
        conn = hub.conn("spoke-0")
        conn.send({"cmd": "serve", "rid": 3}, b"")
        conn.send({"seq": 2, "gen": 0}, b"stale")      # fenced at receipt
        conn.send({"seq": 3, "gen": conn.gen}, b"fresh")
        for _ in range(2):
            meta, payload = ep.recv(timeout=2.0)
            out.append(("recv", meta, payload))
        t0 = time.monotonic()
        try:
            ep.recv(timeout=0.1)
        except fab.ChannelTimeout:
            out.append(("timeout", time.monotonic() - t0 < 2.0))
        try:
            ep.recv(timeout=0.0)
        except fab.ChannelTimeout:
            out.append(("poll", "empty"))
        conn.send({"cmd": "ack", "rid": 3})
        deadline = time.monotonic() + 2.0
        while True:                                   # timeout=0 is a poll
            try:
                out.append(("polled", ep.recv(timeout=0.0)[0]))
                break
            except fab.ChannelTimeout:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        # link loss mid-stream: the spoke redials into generation 2 and
        # re-sends the frame stamped with it
        hub.sever(conn)
        try:
            ep.recv(timeout=1.0)          # the read sees the link go
        except fab.ChannelTimeout:
            out.append(("redialed", "timeout"))
        ep.send({"seq": 4}, b"after-redial")
        out.append(("gen", ep.generation))
        frames = hub.wait_frames(3)
        out.append(("hub", [(m, p) for _, m, p in frames[2:]]))
        # the hub goes away for good: the ladder is exhausted
        hub.close()
        time.sleep(0.05)
        try:
            for _ in range(3):
                ep.send({"seq": 5}, b"x")
                time.sleep(0.05)
            ep.recv(timeout=1.0)
        except fab.ChannelClosed:
            out.append(("closed", True))
    finally:
        ep.close()
        hub.close()
    return out


def test_socket_endpoint_sequences_match_jax():
    """A JAX spoke and a port spoke against the same port hub produce
    the same transcript: the handshake's generation, frames both ways
    with the stale one fenced, the receive deadline and poll, the redial
    into a fresh generation, and the closed verdict."""
    port, jax_side = _socket_script(tfab), _socket_script(jfab)
    assert port == jax_side
    assert port[0] == ("gen", 1)
    assert ("recv", {"cmd": "serve", "rid": 3}, b"") in port
    assert ("recv", {"seq": 3, "gen": 1}, b"fresh") in port
    assert ("gen", 2) in port
    assert port[-1] == ("closed", True)


def test_socket_dial_retries_through_net_connect():
    hub = MiniHub()
    chaos.arm("net.connect", times=2)
    try:
        ep = tfab.SocketEndpoint(tuple(hub.addr), "spoke-0",
                                 connect_timeout=5.0)
        try:
            assert ep.generation == 1
            assert len(chaos.fired("net.connect")) == 2
        finally:
            ep.close()
    finally:
        hub.close()


def test_redial_exhaustion_raises_channel_closed():
    hub = MiniHub()
    ep = tfab.SocketEndpoint(tuple(hub.addr), "spoke-0", connect_timeout=2.0,
                             redial=None)
    try:
        hub.sever(hub.conn("spoke-0"))
        with pytest.raises(tfab.ChannelClosed):
            for _ in range(50):
                ep.send({"seq": 0}, b"x" * 4096)
                time.sleep(0.01)
    finally:
        ep.close()
        hub.close()
