"""Overload control for a queue in front of a batched device dispatch.

* **Watermarks and a ladder.**  An ``OverloadController`` holds a low and
  a high watermark over its family's backlog (queued plus in-flight
  units).  NORMAL below the low one, ELEVATED between, SATURATED at or
  above the high one; once saturated it stays so until the backlog falls
  below the low watermark.  Transitions are counted
  (``clntpu_overload_*``) and emitted on the events bus (topic
  ``overload_state``).
* **An adaptive flush window.**  As pressure rises the consumer's size
  trigger and latency budget widen from their base up to
  ``FLUSH_WIDEN`` times it, so batches grow when dispatch overhead
  matters most.
* **Shedding by priority.**  At the high watermark admission is ordered:
  own-node traffic (PRIO_OWN) outranks fresh third-party channel data
  (PRIO_FRESH), which outranks node announcements (PRIO_BULK).  Each
  class above BULK keeps one more ``high_wm // 4`` band, so the queue is
  bounded at ``high_wm + 2 * (high_wm // 4)``.  Every shed is counted
  (``clntpu_shed_total{family,priority,reason}``) and recorded with the
  message's identity in a bounded ring, so shed traffic can be asked
  for again.
* **Backpressure.**  ``wait_capacity()`` pauses a transport while the
  family is saturated, at most ``BACKPRESSURE_MAX_S`` a message; all
  waiters wake together when the backlog drains below the low watermark.
* **A retry hint.**  ``retry_after_s`` is the backlog over the observed
  drain rate, doubled while the family's circuit breaker is open.

Admission compares the backlog (queued plus in-flight) with a limit per
priority, so a storm submitted without yielding to the event loop sheds a
set that depends on its content alone.
"""
from __future__ import annotations

import asyncio
import collections
import time

from ..obs import families as _f
from ..utils import events

# max widening factor of the flush size and window under full pressure
FLUSH_WIDEN = 8
# bound of one transport pause while saturated
BACKPRESSURE_MAX_S = 0.25
# shed ring capacity
SHED_RING = 1024

NORMAL, ELEVATED, SATURATED = 0, 1, 2
STATE_NAMES = ("normal", "elevated", "saturated")

# priorities: a lower value is more important and sheds last
PRIO_OWN, PRIO_FRESH, PRIO_BULK, PRIO_QUERY = 0, 1, 2, 3
PRIO_NAMES = ("own", "fresh", "bulk", "query")


class Overloaded(RuntimeError):
    """Retryable admission rejection: the consumer's backlog is past its
    high watermark; ``retry_after_s`` is the hint for the caller."""

    def __init__(self, family: str, retry_after_s: float, backlog: int):
        super().__init__(
            f"{family} overloaded (backlog {backlog}); "
            f"retry in {retry_after_s:.2f}s")
        self.family = family
        self.retry_after_s = retry_after_s
        self.backlog = backlog


class OverloadController:
    """Watermarked backlog supervision for one dispatch family."""

    def __init__(self, family: str, high_wm: int, low_wm: int = 0, *,
                 breaker_family: str | None = None,
                 now=time.monotonic):
        if high_wm <= 0:
            raise ValueError("high watermark must be positive")
        self.family = family
        self.high_wm = int(high_wm)
        self.low_wm = int(low_wm) or max(1, self.high_wm // 2)
        if self.low_wm > self.high_wm:
            raise ValueError("low watermark above high watermark")
        # the breaker whose open state slows this family's drain
        self.breaker_family = breaker_family or family
        self.now = now
        self._headroom = max(1, self.high_wm // 4)
        self.hard_cap = self.high_wm + 2 * self._headroom
        self.pending = 0         # queued units
        self.inflight = 0        # units inside a running flush
        self.peak_backlog = 0
        self.state = NORMAL
        self.shed_counts: dict[tuple[str, str], int] = {}
        # drain-rate EWMA (units a second) for the retry hint
        self._drain_rate = 0.0
        self._drained = asyncio.Event()
        self._drained.set()
        _f.OVERLOAD_STATE.labels(family).set(NORMAL)

    # -- backlog and ladder -------------------------------------------------

    def update(self, pending: int, inflight: int = 0) -> None:
        """Report the consumer's queue occupancy: moves the ladder and
        wakes backpressure waiters on drain."""
        self.pending = pending
        self.inflight = inflight
        total = pending + inflight
        if total > self.peak_backlog:
            self.peak_backlog = total
        if total >= self.high_wm:
            state = SATURATED
        elif total >= self.low_wm:
            state = SATURATED if self.state == SATURATED else ELEVATED
        else:
            state = NORMAL
        if state != self.state:
            self.state = state
            _f.OVERLOAD_STATE.labels(self.family).set(state)
            _f.OVERLOAD_TRANSITIONS.labels(self.family,
                                           STATE_NAMES[state]).inc()
            events.emit("overload_state",
                        {"family": self.family,
                         "state": STATE_NAMES[state],
                         "backlog": total})
        if total < self.low_wm:
            self._drained.set()
        elif state == SATURATED:
            self._drained.clear()

    # -- admission and shedding ---------------------------------------------

    def _limit(self, priority: int) -> int:
        """Backlog past which `priority` sheds."""
        if priority <= PRIO_OWN:
            return self.hard_cap
        if priority == PRIO_FRESH:
            return self.high_wm + self._headroom
        return self.high_wm

    def admit(self, priority: int, n: int = 1) -> bool:
        """Admission against the whole backlog (queued and in flight),
        counting the candidate's own weight ``n`` (a
        channel_announcement is 4 signatures)."""
        return self.pending + self.inflight + n <= self._limit(priority)

    def shed(self, priority: int, reason: str, **key) -> None:
        """Count one shed message and record it with its identity
        ``key`` (kind, scid, node id, timestamp...)."""
        pname = PRIO_NAMES[priority]
        _f.SHED.labels(self.family, pname, reason).inc()
        k = (pname, reason)
        self.shed_counts[k] = self.shed_counts.get(k, 0) + 1
        rec = {"family": self.family, "priority": pname, "reason": reason}
        rec.update(key)
        _shed_ring.append(rec)

    # -- adaptive flush widening --------------------------------------------

    def _pressure(self) -> float:
        """0.0 at or below the low watermark, 1.0 at or above the high."""
        total = self.pending + self.inflight
        if total <= self.low_wm:
            return 0.0
        span = max(1, self.high_wm - self.low_wm)
        return min(1.0, (total - self.low_wm) / span)

    def widen_factor(self) -> float:
        """1.0 when calm, up to FLUSH_WIDEN under full pressure."""
        return 1.0 + self._pressure() * (max(1, FLUSH_WIDEN) - 1)

    def flush_target(self, base: int) -> int:
        """The consumer's size trigger, widened from ``base``."""
        return max(1, int(base * self.widen_factor()))

    def window_s(self, base_ms: float) -> float:
        """The consumer's latency budget in seconds, widened likewise."""
        return base_ms * self.widen_factor() / 1000.0

    # -- backpressure -------------------------------------------------------

    async def wait_capacity(self, max_wait: float | None = None) -> float:
        """Pause while the family is SATURATED, at most ``max_wait``
        seconds (default BACKPRESSURE_MAX_S); returns the seconds waited."""
        if self.state != SATURATED:
            return 0.0
        bound = BACKPRESSURE_MAX_S if max_wait is None else max_wait
        _f.BACKPRESSURE_WAITS.labels(self.family).inc()
        t0 = self.now()
        try:
            await asyncio.wait_for(self._drained.wait(), bound)
        except asyncio.TimeoutError:
            pass
        waited = max(0.0, self.now() - t0)
        _f.BACKPRESSURE_WAIT_SECONDS.labels(self.family).observe(waited)
        return waited

    # -- drain rate and retry hint ------------------------------------------

    def note_drain(self, units: int, seconds: float) -> None:
        """Fold one completed flush into the drain-rate EWMA."""
        if units <= 0 or seconds <= 0:
            return
        rate = units / seconds
        self._drain_rate = (rate if self._drain_rate == 0.0
                            else 0.7 * self._drain_rate + 0.3 * rate)

    def retry_after_s(self) -> float:
        """Backlog over the drain rate, clamped to [0.05, 5] s, doubled
        while this family's circuit breaker is open."""
        total = self.pending + self.inflight
        if self._drain_rate > 0:
            hint = total / self._drain_rate
        else:
            hint = 0.1
        hint = min(5.0, max(0.05, hint))
        from . import breaker as _breaker

        if _breaker.get(self.breaker_family).state == "open":
            hint = min(10.0, hint * 2)
        return hint

    def overloaded(self) -> Overloaded:
        """The admission rejection for this family, hint included."""
        return Overloaded(self.family, self.retry_after_s(),
                          self.pending + self.inflight)

    def snapshot(self) -> dict:
        from . import breaker as _breaker

        return {
            "state": STATE_NAMES[self.state],
            "backlog": self.pending + self.inflight,
            "pending": self.pending,
            "inflight": self.inflight,
            "peak_backlog": self.peak_backlog,
            "low_wm": self.low_wm,
            "high_wm": self.high_wm,
            "hard_cap": self.hard_cap,
            "widen_factor": round(self.widen_factor(), 3),
            "drain_rate_per_s": round(self._drain_rate, 3),
            "retry_after_s": round(self.retry_after_s(), 3),
            "breaker": _breaker.get(self.breaker_family).state,
            "shed": {f"{p}:{r}": n
                     for (p, r), n in sorted(self.shed_counts.items())},
        }


_controllers: dict[str, OverloadController] = {}
_shed_ring: collections.deque = collections.deque(maxlen=SHED_RING)


def controller(family: str, high_wm: int, low_wm: int = 0, *,
               breaker_family: str | None = None,
               now=time.monotonic) -> OverloadController:
    """Create and register the controller of `family` (the last one
    made for a family wins)."""
    ctl = OverloadController(family, high_wm, low_wm,
                             breaker_family=breaker_family, now=now)
    _controllers[family] = ctl
    return ctl


def get(family: str) -> OverloadController | None:
    return _controllers.get(family)


def recent_sheds(limit: int | None = None) -> list[dict]:
    """The shed ring, oldest first."""
    out = [dict(r) for r in _shed_ring]
    if limit is not None:
        out = out[-limit:]
    return out


def snapshot() -> dict:
    """Every controller's state, and the recent sheds."""
    return {
        "families": {f: c.snapshot()
                     for f, c in sorted(_controllers.items())},
        "sheds_recorded": len(_shed_ring),
        "recent_sheds": recent_sheds(64),
    }


def reset_for_tests() -> None:
    _controllers.clear()
    _shed_ring.clear()
