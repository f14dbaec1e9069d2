"""Logging: the reference's INF/DBG/WARN/CRIT macros (common/logger.h:6-26)
map onto python logging with ANSI colors and a global verbosity gate."""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",     # cyan
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[35m",  # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def get_logger(name: str = "aero_tpu") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_ColorFormatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        log.addHandler(h)
        log.setLevel(logging.INFO)
    return log


def set_verbosity(level: int):
    """0 = info, 1+ = debug (the reference's gMaxLogVerbosity gate)."""
    get_logger().setLevel(logging.DEBUG if level > 0 else logging.INFO)
