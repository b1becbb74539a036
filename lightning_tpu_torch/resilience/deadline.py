"""Dispatch deadlines and supervised-loop restart backoff.

* ``guard(aw, deadline_s, family, seam)`` bounds an awaitable; a blown
  deadline is counted (``clntpu_deadline_exceeded_total{family,seam}``),
  emitted on the events bus and raises ``DeadlineExceeded``, which the
  caller's own failure handling takes like any other error.
* ``note_exceeded`` counts a deadline that a thread-side caller manages
  itself (the replay's wait on its prepared-bucket queue).
  The work under ``asyncio.to_thread`` cannot be cancelled: the guard
  frees the caller, the worker runs on until it returns.
* ``RestartBackoff`` paces the restarts of a supervised loop:
  exponential from ``base`` to ``cap``, reset after a healthy iteration;
  ``note_restart`` counts one (``clntpu_loop_restarts_total{loop}``).

A deadline is off (None) unless the caller sets one.
"""
from __future__ import annotations

import asyncio
import logging

from ..obs import families as _f
from ..utils import events

log = logging.getLogger("lightning_tpu_torch.resilience.deadline")


class DeadlineExceeded(RuntimeError):
    pass


def note_exceeded(family: str, seam: str, deadline_s: float) -> None:
    """Count and emit a blown deadline."""
    _f.DEADLINE_EXCEEDED.labels(family, seam).inc()
    events.emit("deadline_exceeded", {"family": family, "seam": seam,
                                      "deadline_s": deadline_s})
    log.warning("%s:%s dispatch deadline (%.3fs) exceeded",
                family, seam, deadline_s)


async def guard(aw, deadline_s: float | None, family: str, seam: str):
    """Await ``aw`` within ``deadline_s`` seconds (no bound when None)."""
    if deadline_s is None:
        return await aw
    try:
        return await asyncio.wait_for(aw, deadline_s)
    except asyncio.TimeoutError:
        note_exceeded(family, seam, deadline_s)
        raise DeadlineExceeded(
            f"{family}:{seam} dispatch exceeded {deadline_s:g}s deadline"
        ) from None


class RestartBackoff:
    """Exponential restart pacing for a supervised loop."""

    def __init__(self, base: float = 0.05, cap: float = 5.0):
        self.base = base
        self.cap = cap
        self._next = base

    def next(self) -> float:
        delay = self._next
        self._next = min(self.cap, self._next * 2.0)
        return delay

    def reset(self) -> None:
        self._next = self.base


def note_restart(loop: str, error: BaseException, delay: float) -> None:
    """Count and emit one supervised-loop restart."""
    _f.LOOP_RESTARTS.labels(loop).inc()
    events.emit("loop_restart", {"loop": loop, "error": repr(error),
                                 "restart_delay_s": round(delay, 3)})
    log.error("%s loop error; restarting in %.2fs", loop, delay,
              exc_info=error)
