"""ZeroMQ transport, wire-compatible with the reference ecosystem.

Message = 3 frames: [topic][uint32-LE sample_rate][payload]
(ref: publish/zmqpublisher.cpp:61-73; consumer decode/decode.cpp:283-366).

The reference always sends the topic frame with length 5 regardless of the
actual topic (zmqpublisher.cpp:69 — a known wart, SURVEY.md §2.6);
``legacy_topic_len5=True`` reproduces that for byte-exact interop with
existing SDRReceiver/JAERO feeders.
"""

from __future__ import annotations

import struct

try:
    import zmq
    _HAVE_ZMQ = True
except ImportError:          # pragma: no cover
    zmq = None
    _HAVE_ZMQ = False

MAX_FRAME = 192000           # consumer-side cap (ref: decode/decode.h:44)


def _tune_socket(sock):
    """Keepalive + reconnect options for flaky links
    (ref: zmqpublisher.cpp:24-37)."""
    sock.setsockopt(zmq.TCP_KEEPALIVE, 1)
    sock.setsockopt(zmq.TCP_KEEPALIVE_CNT, 10)
    sock.setsockopt(zmq.TCP_KEEPALIVE_IDLE, 1)
    sock.setsockopt(zmq.TCP_KEEPALIVE_INTVL, 1)
    sock.setsockopt(zmq.RECONNECT_IVL, 1000)


class ZmqPublisher:
    def __init__(self, address: str, bind: bool = True,
                 legacy_topic_len5: bool = False, context=None):
        if not _HAVE_ZMQ:
            raise RuntimeError("pyzmq not available")
        self.ctx = context or zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PUB)
        _tune_socket(self.sock)
        if bind:
            self.sock.bind(address)
        else:
            self.sock.connect(address)
        self.legacy_topic_len5 = legacy_topic_len5

    def publish(self, topic: str, sample_rate: int, payload: bytes):
        t = topic.encode()
        if self.legacy_topic_len5:
            t = (t + b"\x00" * 5)[:5]
        self.sock.send(t, zmq.SNDMORE)
        self.sock.send(struct.pack("<I", sample_rate), zmq.SNDMORE)
        self.sock.send(payload)

    def close(self):
        self.sock.close(0)


class ZmqSubscriber:
    """Blocking-with-timeout 3-frame consumer (ref: decode.cpp:307-354)."""

    def __init__(self, address: str, topic: str = "", context=None):
        if not _HAVE_ZMQ:
            raise RuntimeError("pyzmq not available")
        self.ctx = context or zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.SUB)
        _tune_socket(self.sock)
        self.sock.connect(address)
        # reference matches the 5-byte-truncated topic; subscribe to the
        # prefix so both conventions interoperate
        self.sock.setsockopt(zmq.SUBSCRIBE, topic.encode()[:5])
        self.topic = topic

    def recv(self, timeout_ms: int = 100):
        """Returns (topic, sample_rate, payload) or None on timeout."""
        if not self.sock.poll(timeout_ms):
            return None
        parts = self.sock.recv_multipart()
        if len(parts) != 3:
            return None
        topic = parts[0].rstrip(b"\x00").decode(errors="replace")
        rate = struct.unpack("<I", parts[1])[0]
        payload = parts[2][:MAX_FRAME]
        return topic, rate, payload

    def close(self):
        self.sock.close(0)
