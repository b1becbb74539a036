"""In-memory ring-buffer log with per-subsystem level filters + getlog.

Parity target: lightningd/log.c — a bounded ring of structured entries
(the reference prunes at 10M bytes), per-subsystem level overrides
(`--log-level=debug:gossipd`), and the `getlog` RPC that replays the
ring.  Implemented as a logging.Handler so every module's stdlib logger
feeds the same ring the RPC reads.
"""
from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass

LEVELS = {"io": 5, "debug": logging.DEBUG, "info": logging.INFO,
          "unusual": logging.WARNING, "broken": logging.ERROR}
_LEVEL_NAMES = {5: "IO", logging.DEBUG: "DEBUG", logging.INFO: "INFO",
                logging.WARNING: "UNUSUAL", logging.ERROR: "BROKEN",
                logging.CRITICAL: "BROKEN"}

logging.addLevelName(5, "IO")


def level_name(levelno: int) -> str:
    for threshold in (logging.CRITICAL, logging.ERROR, logging.WARNING,
                      logging.INFO, logging.DEBUG, 5):
        if levelno >= threshold:
            return _LEVEL_NAMES[threshold]
    return "IO"


@dataclass
class LogEntry:
    ts: float
    levelno: int
    subsystem: str
    message: str
    node_id: str | None = None


class LogRing(logging.Handler):
    """Bounded structured log sink with per-subsystem filtering."""

    def __init__(self, max_entries: int = 100_000,
                 default_level: str = "info"):
        super().__init__(level=1)
        self.entries: collections.deque[LogEntry] = collections.deque(
            maxlen=max_entries)
        self.default_level = LEVELS[default_level]
        self.overrides: dict[str, int] = {}   # subsystem prefix -> levelno
        self.n_skipped = 0
        # total records accepted per level name, monotone — the ring
        # itself is bounded, so the obs collector reads emit rates here
        self.n_emitted: dict[str, int] = {}

    # -- configuration ----------------------------------------------------

    def set_level(self, spec: str) -> None:
        """'debug' or 'debug:gossipd' (reference --log-level syntax)."""
        level, _, subsys = spec.partition(":")
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}")
        if subsys:
            self.overrides[subsys] = LEVELS[level]
        else:
            self.default_level = LEVELS[level]

    def threshold_for(self, subsystem: str) -> int:
        for prefix, lv in self.overrides.items():
            if prefix in subsystem:
                return lv
        return self.default_level

    # -- logging.Handler --------------------------------------------------

    def emit(self, record: logging.LogRecord) -> None:
        sub = record.name.removeprefix("lightning_tpu_torch.")
        if record.levelno < self.threshold_for(sub):
            self.n_skipped += 1
            return
        try:
            msg = record.getMessage()
        except Exception:
            msg = str(record.msg)
        self._count(record.levelno)
        self.entries.append(LogEntry(record.created, record.levelno,
                                     sub, msg))

    def add(self, subsystem: str, message: str,
            level: str = "info") -> None:
        """Direct structured append (non-stdlib paths)."""
        if LEVELS[level] >= self.threshold_for(subsystem):
            self._count(LEVELS[level])
            self.entries.append(LogEntry(time.time(), LEVELS[level],
                                         subsystem, message))

    def _count(self, levelno: int) -> None:
        name = level_name(levelno)
        self.n_emitted[name] = self.n_emitted.get(name, 0) + 1

    # -- RPC surface ------------------------------------------------------

    def getlog(self, level: str = "info") -> dict:
        """doc/schemas/lightning-getlog.json shape."""
        threshold = LEVELS.get(level)
        if threshold is None:
            raise ValueError(f"unknown log level {level!r}")
        first = self.entries[0].ts if self.entries else time.time()
        out = [
            {"type": level_name(e.levelno),
             "time": f"{e.ts - first:.9f}",
             "source": e.subsystem,
             "log": e.message}
            for e in self.entries if e.levelno >= threshold
        ]
        return {"created_at": f"{first:.9f}",
                "bytes_used": sum(len(e.message) for e in self.entries),
                "bytes_max": self.entries.maxlen or 0,
                "log": out}


def install(ring: LogRing, root: str = "lightning_tpu_torch") -> None:
    """Attach the ring to the package's root logger."""
    lg = logging.getLogger(root)
    lg.addHandler(ring)
    lg.setLevel(1)
