"""Dispatch flight recorder: a bounded per-family ring of dispatch
records, for the post-mortem of the batched paths on the card.

Aggregate counters (clntpu_replay_* and friends) answer "how much";
they cannot answer "WHICH dispatch blew the p99, and what did the
breaker and quarantine machinery see at that moment".  Every batched
dispatch (a verify bucket, a sign batch, a sig-check batch) gets a
process-monotonic ``dispatch_id`` and a JSON-able record of its shape,
timing split (queue wait / prep / dispatch / readback), the breaker
state it dispatched under, the faults it hit and its outcome.  The last
RING_SIZE records of each family stay in a ring: ``recent()`` and
``summary()`` read them.

The slow-dispatch watchdog rides ``finish()``: a dispatch whose total
(queue wait + prep + dispatch) exceeds SLOW_DISPATCH_S, or, with no
threshold set, the rolling per-family p99, is logged, counted
(``clntpu_slow_dispatch_total{family}``) and emitted on the events bus
(topic ``slow_dispatch``) with the full record attached.

``dispatch_ms`` is the host's time in the dispatch call.  Kernel
launches are asynchronous, so on the card it is the enqueue time; the
device time shows in the readback that waits for it.

Outcome vocabulary (fixed; the port re-checks nothing on the host after
a failed dispatch, so of the JAX package's outcomes it records ok,
host, bisect, deadline and error, and "breaker" where the JAX package
records host_breaker):

    ok             device dispatch completed
    host           no device dispatch was needed (every row of the batch
                   had a host answer), or a recovered sign/check failure
    breaker        breaker open -> the device rows fail with BreakerOpen
    bisect         dispatch raised -> quarantine bisection completed it
    deadline       dispatch deadline blown -> the device rows fail
    error          dispatch failed with no recovery path
"""
from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
from contextlib import contextmanager

from ..utils import events, trace as _trace
from . import families as _f

log = logging.getLogger("lightning_tpu_torch.obs.flight")

OUTCOMES = ("ok", "host", "breaker", "bisect", "deadline", "error")

# carriers stored per record are capped like span corr ids — a 10k-sig
# ingest flush must not pin 10k ints per ring slot.  One constant for
# both layers: records and flow chains cap at the same width.
CORR_CAP = _trace.CORR_CAP


def corr_ids(carriers) -> list:
    """The capped corr-id list a DispatchRecord stores for an iterable
    of trace.Carrier (the one idiom every dispatch site needs)."""
    return [c.corr_id for c in carriers][:CORR_CAP]

# the ring's capacity per family and the slow-dispatch threshold in
# seconds (None: the rolling per-family p99); read at each finish()
RING_SIZE = 256
SLOW_DISPATCH_S: float | None = None
_WATCH_WINDOW = 128      # rolling per-family duration window (p99 source)
_P99_MIN_SAMPLES = 32    # no p99 verdicts before the window has history
_P99_FLOOR_S = 0.005     # p99 mode ignores sub-5ms dispatches (noise)

_lock = threading.Lock()
_ids = itertools.count(1)        # thread-safe without the lock (CPython)
_rings: dict[str, collections.deque] = {}       # guarded-by: _lock
_counts: dict[str, int] = {}                    # guarded-by: _lock
_windows: dict[str, collections.deque] = {}     # guarded-by: _lock
_tls = threading.local()


def _ring_size() -> int:
    return max(1, int(RING_SIZE))


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current() -> dict | None:
    """The in-flight record on THIS thread (faultinject and quarantine
    annotate it), or None outside a dispatch."""
    st = _stack()
    return st[-1] if st else None


def begin(family: str, *, corr_ids=(), shape=None, n_real: int = 0,
          lanes: int = 0, queue_wait_ms: float = 0.0,
          prep_ms: float = 0.0, breaker_state: str | None = None) -> dict:
    """Open a DispatchRecord and make it the thread's current one.
    Callers set ``rec["outcome"]`` as the dispatch resolves and must
    pair with ``finish()`` (or use the ``dispatch()`` context manager,
    which does both)."""
    rec = {
        "dispatch_id": next(_ids),
        "family": family,
        "ts": time.time(),
        "ts_ns": time.monotonic_ns(),
        "tid": threading.get_native_id(),
        "thread": threading.current_thread().name,
        "shape": list(shape) if shape is not None else None,
        "n_real": int(n_real),
        "lanes": int(lanes),
        "occupancy": round(n_real / lanes, 4) if lanes else None,
        "queue_wait_ms": round(float(queue_wait_ms), 3),
        "prep_ms": round(float(prep_ms), 3),
        "dispatch_ms": None,
        "readback_ms": None,
        "breaker_state": breaker_state,
        # host<->device operand bytes staged for THIS dispatch; dispatch
        # sites fill them in when a device path actually runs
        "h2d_bytes": 0,
        "d2h_bytes": 0,
        "faults": [],
        "quarantined": 0,
        "outcome": None,
        "corr_ids": list(corr_ids)[:CORR_CAP],
        "_open": True,
    }
    parent = current()
    if parent is not None:
        rec["parent_dispatch_id"] = parent["dispatch_id"]
    _stack().append(rec)
    return rec


def defer(rec: dict) -> None:
    """Pop a record off the thread's dispatch stack WITHOUT sealing it
    — for pipelines whose outcome is only known at a later readback
    (the streaming replay).  The caller owns calling finish() exactly
    once afterwards; finish() is idempotent, so a blanket
    seal-everything finally block is safe."""
    st = _stack()
    if rec in st:
        st.remove(rec)


def finish(rec: dict, outcome: str | None = None, *,
           dispatch_ms: float | None = None,
           error: str | None = None) -> None:
    """Seal a record into its family ring, meter it, and run the
    slow-dispatch watchdog.  Idempotent: a record already sealed is
    left alone (deferred pipeline records are finished from a finally
    block that cannot know which ones an error path sealed early)."""
    if not rec.pop("_open", False):
        return
    st = _stack()
    if rec in st:
        st.remove(rec)
    if outcome is not None:
        rec["outcome"] = outcome
    if rec["outcome"] is None:
        rec["outcome"] = "ok"
    if dispatch_ms is not None:
        rec["dispatch_ms"] = round(float(dispatch_ms), 3)
    if error is not None:
        rec["error"] = error
    family = rec["family"]
    with _lock:
        ring = _rings.get(family)
        if ring is None or ring.maxlen != _ring_size():
            ring = collections.deque(ring or (), maxlen=_ring_size())
            _rings[family] = ring
        ring.append(rec)
        _counts[family] = _counts.get(family, 0) + 1
    _f.DISPATCHES.labels(family, rec["outcome"]).inc()
    _watchdog(rec)


@contextmanager
def dispatch(family: str, **fields):
    """One supervised dispatch: begin() on enter, finish() on exit with
    dispatch wall time measured; an escaping exception seals the record
    with outcome ``error`` (unless the body already resolved it) and
    re-raises."""
    rec = begin(family, **fields)
    t0 = time.perf_counter()
    try:
        yield rec
    except BaseException as e:
        if rec["outcome"] is None:
            rec["outcome"] = "error"
        finish(rec, dispatch_ms=(time.perf_counter() - t0) * 1e3,
               error=type(e).__name__)
        raise
    finish(rec, dispatch_ms=(time.perf_counter() - t0) * 1e3)


def note_fault(seam: str, family: str) -> None:
    """faultinject.fire() hook: stamp the injected fault onto the
    in-flight record so a post-mortem shows WHICH dispatch ate it."""
    rec = current()
    if rec is not None and len(rec["faults"]) < 16:
        rec["faults"].append(seam + ":" + family)


def note_quarantine(rows: int) -> None:
    """quarantine hook: rows diverted off the in-flight dispatch."""
    rec = current()
    if rec is not None:
        rec["quarantined"] += int(rows)


# -- the slow-dispatch watchdog --------------------------------------------


def _quantile(sorted_vals: list[float], q: float) -> float:
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def _watchdog(rec: dict) -> None:
    total_s = (rec["queue_wait_ms"] + rec["prep_ms"]
               + (rec["dispatch_ms"] or 0.0)) / 1e3
    family = rec["family"]
    thr = SLOW_DISPATCH_S
    with _lock:
        win = _windows.get(family)
        if win is None:
            win = _windows[family] = collections.deque(
                maxlen=_WATCH_WINDOW)
        history = sorted(win)
        win.append(total_s)
    slow = thr is not None and total_s > thr
    if (not slow and thr is None and len(history) >= _P99_MIN_SAMPLES
            and total_s >= _P99_FLOOR_S):
        slow = total_s > _quantile(history, 0.99)
    if not slow:
        return
    rec["slow"] = True
    _f.SLOW_DISPATCH.labels(family).inc()
    log.warning(
        "slow dispatch %d (%s): %.1f ms total (wait %.1f + prep %.1f "
        "+ dispatch %.1f), outcome %s",
        rec["dispatch_id"], family, total_s * 1e3, rec["queue_wait_ms"],
        rec["prep_ms"], rec["dispatch_ms"] or 0.0, rec["outcome"])
    events.emit("slow_dispatch", dict(rec))


# -- exposition -------------------------------------------------------------


def recent(family: str | None = None, limit: int | None = None) -> list[dict]:
    """The last ``limit`` flight records (all families merged in
    dispatch order when family is None).  Returns copies: callers may
    serialize while dispatches continue."""
    with _lock:
        if family is not None:
            recs = list(_rings.get(family, ()))
        else:
            recs = sorted(
                (r for ring in _rings.values() for r in ring),
                key=lambda r: r["dispatch_id"])
        if limit is not None:
            recs = recs[-limit:] if limit > 0 else []
        return [dict(r) for r in recs]


def summary() -> dict:
    """Per-family lifetime counts, ring occupancy and the latest
    record."""
    with _lock:
        fams = {
            fam: {
                "total": _counts.get(fam, 0),
                "ring": len(ring),
                "last": dict(ring[-1]) if ring else None,
            }
            for fam, ring in _rings.items()
        }
    return {"ring_size": _ring_size(), "families": fams}


def reset_for_tests() -> None:
    with _lock:
        _rings.clear()
        _counts.clear()
        _windows.clear()
    _tls.stack = []
