"""POSIX signal -> callback bridge (EventNotifier parity).

The reference's `common/notifier.{h,cpp}` turns SIGHUP/SIGINT/SIGTERM
into Qt signals via the self-pipe trick so the event loop can shut down
cleanly (ref: common/notifier.cpp:85-189, wired in publish/main.cpp and
decode/main.cpp).  Python delivers signals on the main thread between
bytecodes, so no pipe is needed: this notifier just registers handlers,
latches a stop flag the run loops poll, and invokes optional callbacks.

SIGINT/SIGTERM request shutdown; SIGHUP fires a user hook (the station
CLI uses it to dump live stats on demand) and does NOT stop the process,
matching the reference's separation of `hangup` from `terminate`.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable


class EventNotifier:
    """Latches shutdown requests from SIGINT/SIGTERM; SIGHUP -> hook."""

    def __init__(self, on_hangup: Callable[[], None] | None = None,
                 on_stop: Callable[[], None] | None = None):
        self._stop = threading.Event()
        self.on_hangup = on_hangup
        self.on_stop = on_stop
        self._installed = False
        self._previous: dict[int, object] = {}

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    def request_stop(self) -> None:
        self._stop.set()
        if self.on_stop:
            self.on_stop()

    def install(self) -> "EventNotifier":
        """Register handlers.  No-op off the main thread (tests, library
        embedders): the flag can still be driven via request_stop()."""
        try:
            self._previous[signal.SIGINT] = signal.signal(
                signal.SIGINT, self._handle_stop)
            self._previous[signal.SIGTERM] = signal.signal(
                signal.SIGTERM, self._handle_stop)
            if hasattr(signal, "SIGHUP"):
                self._previous[signal.SIGHUP] = signal.signal(
                    signal.SIGHUP, self._handle_hangup)
            self._installed = True
        except ValueError:
            pass
        return self

    def uninstall(self) -> None:
        if self._installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
            self._installed = False

    def _handle_stop(self, signum, frame) -> None:
        self.request_stop()

    def _handle_hangup(self, signum, frame) -> None:
        if self.on_hangup:
            self.on_hangup()
