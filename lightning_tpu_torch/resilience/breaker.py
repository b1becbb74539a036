"""Per-family circuit breakers (the state machine only).

After ``threshold`` consecutive failures a breaker opens; after an
exponential backoff (with deterministic per-family jitter, so breakers of
different families do not probe in lockstep) it half-opens and lets
exactly one probe through: success closes it, failure re-opens it with a
doubled backoff.  Transitions are counted (``clntpu_breaker_*``) and
emitted on the events bus (topic ``breaker_transition``).

The "verify" breaker supervises the replay's bucket dispatches and
hsmd's sig-checks, the "sign" breaker hsmd's batched sign, the "route"
and "mcf" breakers the routing services' flushes.  An open
breaker makes those dispatches raise ``BreakerOpen`` (or, where the
caller opts in, re-check on the host).  The knobs are constructor
arguments with the defaults threshold 5, backoff 1.0 s and ceiling
30.0 s.
"""
from __future__ import annotations

import random
import threading
import time

from ..obs import families as _f
from ..utils import events

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

THRESHOLD = 5
BACKOFF_S = 1.0
MAX_BACKOFF_S = 30.0
# cap the exponent so a breaker that flaps for days can't overflow
_MAX_TRIP_EXP = 16


class BreakerOpen(RuntimeError):
    """A dispatch refused because its family's breaker is open: retry
    after ``retry_in_s`` seconds."""

    def __init__(self, family: str, retry_in_s: float):
        super().__init__(f"{family} breaker open; retry in "
                         f"{retry_in_s:.3f}s")
        self.family = family
        self.retry_in_s = retry_in_s


class CircuitBreaker:
    """Thread-safe three-state breaker."""

    def __init__(self, family: str, *, threshold: int = THRESHOLD,
                 base_backoff: float = BACKOFF_S,
                 max_backoff: float = MAX_BACKOFF_S,
                 clock=time.monotonic):
        self.family = family
        self.threshold = int(threshold)
        self.base_backoff = base_backoff
        self.max_backoff = max_backoff
        self._clock = clock
        self._lock = threading.Lock()
        # deterministic per-family jitter stream
        self._rng = random.Random(family)
        self.state = CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        self._seq = 0
        self._retry_at = 0.0
        self._open_backoff = 0.0
        _f.BREAKER_STATE.labels(family).set(_STATE_CODE[CLOSED])

    def allow(self) -> bool:
        """True: the caller may dispatch.  An open breaker whose backoff
        has elapsed half-opens and grants exactly one probe."""
        evt = None
        try:
            with self._lock:
                if self.state == CLOSED:
                    return True
                if self.state == OPEN and self._clock() >= self._retry_at:
                    evt = self._transition(HALF_OPEN)
                    return True
                # open and waiting, or a half-open probe in flight
                _f.BREAKER_SHORT_CIRCUITS.labels(self.family).inc()
                return False
        finally:
            self._emit(evt)

    def record_success(self) -> None:
        evt = None
        with self._lock:
            self.consecutive_failures = 0
            if self.state != CLOSED:
                evt = self._transition(CLOSED)
        self._emit(evt)

    def record_failure(self) -> None:
        _f.BREAKER_FAILURES.labels(self.family).inc()
        evt = None
        with self._lock:
            self.consecutive_failures += 1
            if self.state == HALF_OPEN or (
                    self.state == CLOSED
                    and self.consecutive_failures >= self.threshold):
                evt = self._trip()
        self._emit(evt)

    # -- internals (lock held; transitions return the event payload) ------

    def _trip(self) -> dict:
        self.trips += 1
        backoff = min(self.max_backoff,
                      self.base_backoff
                      * 2.0 ** min(self.trips - 1, _MAX_TRIP_EXP))
        backoff *= 1.0 + 0.1 * self._rng.random()
        self._open_backoff = backoff
        self._retry_at = self._clock() + backoff
        return self._transition(OPEN)

    def _transition(self, to: str) -> dict:
        """State change under the lock.  The caller emits the event once
        the lock is released (a subscriber calling back into the breaker
        must not deadlock); ``seq`` orders events that reach the bus out
        of transition order."""
        self.state = to
        self._seq += 1
        _f.BREAKER_STATE.labels(self.family).set(_STATE_CODE[to])
        _f.BREAKER_TRANSITIONS.labels(self.family, to).inc()
        return {
            "family": self.family, "to": to, "seq": self._seq,
            "consecutive_failures": self.consecutive_failures,
            "backoff_s": round(self._open_backoff, 3) if to == OPEN
            else 0.0,
        }

    @staticmethod
    def _emit(evt: dict | None) -> None:
        if evt is not None:
            events.emit("breaker_transition", evt)

    def retry_in_s(self) -> float:
        """Seconds until an open breaker half-opens (0.0 otherwise)."""
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return max(0.0, self._retry_at - self._clock())

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "trips": self.trips,
                "threshold": self.threshold,
            }
            if self.state == OPEN:
                out["retry_in_s"] = round(
                    max(0.0, self._retry_at - self._clock()), 3)
            return out

    def force_open(self) -> None:
        """Trip immediately regardless of history."""
        with self._lock:
            evt = self._trip()
        self._emit(evt)

    def reset(self) -> None:
        evt = None
        with self._lock:
            self.consecutive_failures = 0
            self.trips = 0
            if self.state != CLOSED:
                evt = self._transition(CLOSED)
        self._emit(evt)


_breakers: dict[str, CircuitBreaker] = {}
_registry_lock = threading.Lock()


def get(family: str) -> CircuitBreaker:
    """Process-wide breaker for a dispatch family, made on first use."""
    brk = _breakers.get(family)
    if brk is None:
        with _registry_lock:
            brk = _breakers.get(family)
            if brk is None:
                brk = _breakers[family] = CircuitBreaker(family)
    return brk


def all_breakers() -> dict[str, CircuitBreaker]:
    return dict(_breakers)


def reset_for_tests() -> None:
    with _registry_lock:
        for brk in _breakers.values():
            brk.reset()
        _breakers.clear()
