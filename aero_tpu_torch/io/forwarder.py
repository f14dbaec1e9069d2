"""TCP/UDP forwarders for decoded frames.

Behavioral equivalent of ForwardTarget (ref: decode/forwarder.cpp):
``FMT=URL`` spec parsing (tcp/udp only, :136-184), plain sockets with one
reconnect-and-retry (:109-134), newline-terminated frames
(ref: decode.cpp:408).

``AsyncForwardQueue`` is the reference's forwarder thread (the condvar
consumer of sendBuffer, ref: decode/decode.cpp:368-416): egress runs on
its own worker so a stalled TCP sink never blocks the decode loop.  The
queue is BOUNDED; on overflow the OLDEST item is dropped and counted
(the reference's unbounded QList would instead grow without limit).
"""

from __future__ import annotations

import socket
import threading
from collections import deque
from dataclasses import dataclass
from urllib.parse import urlparse

FORMATS = ("jaero", "jsondump", "text")


@dataclass
class ForwardSpec:
    fmt: str
    scheme: str
    host: str
    port: int


def parse_forwarder(spec: str) -> ForwardSpec:
    """Parse 'FMT=URL' (e.g. 'jsondump=tcp://feed.example.org:5571')."""
    fmt, _, url = spec.partition("=")
    fmt = fmt.strip().lower()
    if fmt not in FORMATS:
        raise ValueError(f"unknown forward format {fmt!r} (use {FORMATS})")
    u = urlparse(url.strip())
    if u.scheme not in ("tcp", "udp"):
        raise ValueError(f"unsupported scheme {u.scheme!r} (tcp/udp only)")
    if not u.hostname or not u.port:
        raise ValueError(f"bad forward URL {url!r}")
    return ForwardSpec(fmt, u.scheme, u.hostname, u.port)


class ForwardTarget:
    def __init__(self, spec: ForwardSpec):
        self.spec = spec
        self.sock: socket.socket | None = None
        self.closed = False

    def _connect(self):
        infos = socket.getaddrinfo(
            self.spec.host, self.spec.port,
            type=(socket.SOCK_STREAM if self.spec.scheme == "tcp"
                  else socket.SOCK_DGRAM))
        family, stype, proto, _, addr = infos[0]
        s = socket.socket(family, stype, proto)
        s.settimeout(5.0)
        s.connect(addr)
        self.sock = s

    def send(self, line: str) -> bool:
        """Send one newline-terminated frame; reconnect and retry once
        (ref: forwarder.cpp:109-134)."""
        data = (line + "\n").encode()
        for attempt in range(2):
            # re-checked every attempt: close() may land while a send is in
            # flight, and the retry path must not reopen a socket after
            # shutdown (ADVICE r3)
            if self.closed:
                return False
            try:
                if self.sock is None:
                    self._connect()
                self.sock.sendall(data)
                return True
            except OSError:
                try:
                    if self.sock:
                        self.sock.close()
                except OSError:
                    pass
                self.sock = None
        return False

    def close(self):
        # permanent: send() stops reconnecting, so a worker thread still
        # draining cannot reopen the socket after shutdown
        self.closed = True
        if self.sock:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class AsyncForwardQueue:
    """Bounded queue + worker thread decoupling decode from egress.

    ``submit`` never blocks: if the queue is full the oldest entry is
    dropped and ``dropped`` incremented.  The worker formats per target
    (each target has its own FMT) and sends with the ForwardTarget
    reconnect-retry semantics.  Ref: decode/decode.cpp:368-416.
    """

    def __init__(self, targets, maxsize: int = 512):
        self.targets = list(targets)
        self.maxsize = maxsize
        self.dropped = 0
        self.sent = 0
        self.errors = 0
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="aero-forwarder")
        self._thread.start()

    def submit(self, station_id: str, disable_reassembly: bool, item):
        with self._cv:
            if len(self._q) >= self.maxsize:
                self._q.popleft()
                self.dropped += 1
            self._q.append((station_id, disable_reassembly, item))
            self._idle.clear()
            self._cv.notify()

    def _run(self):
        from aero_tpu_torch.io.output import to_output_format
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._idle.set()
                    self._cv.wait()
                if self._stop and not self._q:
                    self._idle.set()
                    return
                sid, dis, item = self._q.popleft()
            if self._stop:
                self.dropped += 1   # close() without flush(): drop fast
                continue
            # one poison item (e.g. an unserializable parsed payload)
            # must not kill egress for the life of the process — the
            # reference's forwarder thread loops forever
            # (decode.cpp:368-416).  Format+send per target in its own
            # try/except so one target's formatter exception can't
            # suppress delivery to the others (ADVICE r3).
            delivered = False
            for t in self.targets:
                try:
                    if t.send(to_output_format(t.spec.fmt, sid, dis, item)):
                        delivered = True
                except Exception:                  # noqa: BLE001
                    self.errors += 1
            if delivered:
                self.sent += 1

    def flush(self, timeout: float | None = 10.0) -> bool:
        """Wait until the queue drains (or timeout).  Returns drained?"""
        return self._idle.wait(timeout)

    def close(self, timeout: float = 5.0):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout)
        # targets close even if the worker outlives the join timeout:
        # ForwardTarget.close() latches `closed`, so a still-draining
        # worker cannot reconnect/reopen after shutdown
        for t in self.targets:
            t.close()

    def __len__(self):
        return len(self._q)
