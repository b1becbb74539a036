"""Poisoned-batch quarantine: bisection of a failing batched dispatch.

A batched dispatch fails as a UNIT: one malformed row (an input that
trips a kernel's operand check, a buffer the runtime rejects) takes the
other rows of the bucket down with it.  ``bisect`` gets the serial
behaviour back only when it is needed: it dispatches halves of the
failing index set again, recursing into whichever half still raises,
until the poison is isolated to single rows.  Clean subsets complete on
the card at most ceil(log2 n) levels deep (at most 2 log2 n extra
dispatches); the isolated rows are quarantined, counted per family and
reason, and handed back to the caller, which decides what they mean.

``clntpu_quarantine_total{family,reason}`` counts every diverted row;
the events bus carries a ``quarantine`` topic per isolated row.
"""
from __future__ import annotations

import logging

import numpy as np

from ..obs import families as _f
from ..obs import flight as _flight
from ..utils import events

log = logging.getLogger("lightning_tpu_torch.resilience.quarantine")


class Quarantined(RuntimeError):
    """A batched dispatch completed every clean row and isolated
    ``rows`` (ascending indices into the caller's items), which nobody
    re-checked.  ``verdicts`` holds the results of every other row, and
    False at the quarantined ones."""

    def __init__(self, family: str, rows, verdicts):
        rows = [int(r) for r in rows]
        super().__init__(f"{family}: {len(rows)} quarantined row(s) "
                         f"{rows[:8]}{'...' if len(rows) > 8 else ''}")
        self.family = family
        self.rows = rows
        self.verdicts = verdicts


def note(family: str, reason: str, rows: int = 1) -> None:
    """Count rows diverted off a device result without a bisection
    (say, CRC-bad store records sent to a re-check)."""
    _f.QUARANTINE.labels(family, reason).inc(rows)
    _flight.note_quarantine(rows)


def bisect(indices, attempt, family: str, fatal: tuple = ()):
    """Recursively isolate the rows a batched ``attempt`` cannot process.

    ``attempt(idx)`` takes an int index array and returns per-index
    results (len == len(idx)), raising if the subset still holds a
    poisoned row.  An exception of a type in ``fatal`` is not bisected:
    it propagates at once (a lost CUDA context fails every later call,
    so splitting would only dispatch into it again).  Returns
    ``(parts, quarantined)``: ``parts`` lists ``(idx, results)`` for
    every subset that succeeded, ``quarantined`` the isolated indices
    (counted, in ascending order).
    """
    parts: list[tuple[np.ndarray, object]] = []
    bad: list[int] = []
    stack = [np.asarray(indices)]
    while stack:
        idx = stack.pop()
        if len(idx) == 0:
            continue
        try:
            parts.append((idx, attempt(idx)))
        except fatal:
            raise
        except Exception as e:
            if len(idx) == 1:
                row = int(idx[0])
                reason = type(e).__name__
                _f.QUARANTINE.labels(family, reason).inc()
                _flight.note_quarantine(1)
                events.emit("quarantine", {"family": family, "row": row,
                                           "reason": reason})
                log.warning("%s: quarantined row %d (%s: %s)",
                            family, row, reason, e)
                bad.append(row)
            else:
                mid = len(idx) // 2
                stack.append(idx[mid:])
                stack.append(idx[:mid])
    bad.sort()
    return parts, bad
