"""Tracing spans: lightweight structured profiling of the port's phases.

After Core Lightning's common/trace.c (trace_span_start/end emitting USDT
probes for contrib/cln-tracer), re-targeted: a completed span becomes one
JSON-able record in a sink (an in-memory ring by default), and a workload
can be bracketed by a ``torch.profiler`` session so the host spans line
up with the card's timeline.

Usage:
    from lightning_tpu_torch.utils import trace
    with trace.span("gossip/verify", batch=4096):
        ...
    trace.set_sink(path_or_callable)   # default: in-memory ring

Spans nest via a contextvar; each record carries its parent's name and
span id.  A span measures wall time between enter and exit.

Cross-thread correlation: contextvars do not follow work onto a producer
thread or a flush loop, so causality is carried by an explicit
``Carrier``.  ``new_corr()`` mints one inside the enqueue span (stamping
that span with the correlation id); the carrier rides the queue item or
batch to wherever the work is dispatched, and every downstream span
opened with ``corr=carrier`` shares the id.  Every record carries
``span_id``/``parent_id``/``tid``/``thread``; spans on a dispatch path
also carry ``corr_ids`` (and ``corr_id``, the first) and ``dispatch_id``.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager

_current = contextvars.ContextVar("trace_span", default=None)

_records: list[dict] = []        # guarded-by: _lock
_MAX_RECORDS = 10_000
_sink = None          # guarded-by: _lock  (None -> ring; else callable)
_file = None          # guarded-by: _lock
# taps see EVERY record regardless of the sink (the obs collector feeds
# span-duration histograms from here; a tap must never raise into the
# traced code path)
_taps: list = []                 # guarded-by: _lock
# one lock for ring, taps and sink swaps: flush loops, the replay
# producer thread and the main thread all emit concurrently
_lock = threading.RLock()

_span_ids = itertools.count(1)
_corr_ids = itertools.count(1)

# spans on a big coalesced dispatch can carry hundreds of carriers; cap
# what a single record stores so the ring stays bounded
CORR_CAP = 32


class Carrier:
    """Explicit correlation context, the cross-thread causality token.

    Mint with ``new_corr()`` at the enqueue point; pass by reference to
    the thread or loop doing the work; open downstream spans with
    ``corr=carrier``.  Deliberately not a contextvar: it must survive
    hops contextvars cannot follow."""

    __slots__ = ("corr_id", "span_id")

    def __init__(self, corr_id: int, span_id: int):
        self.corr_id = corr_id
        self.span_id = span_id

    def __repr__(self):
        return f"Carrier(corr_id={self.corr_id}, span_id={self.span_id})"


class _Span:
    __slots__ = ("name", "span_id", "corr_ids")

    def __init__(self, name: str, span_id: int):
        self.name = name
        self.span_id = span_id
        self.corr_ids: list[int] = []


def new_corr() -> Carrier:
    """Mint a correlation carrier at the CURRENT span (the enqueue
    point).  The enclosing span's record gains the correlation id; with
    no enclosing span the carrier still correlates every downstream span
    that adopts it."""
    cur = _current.get()
    c = Carrier(next(_corr_ids), cur.span_id if cur is not None else 0)
    if cur is not None and len(cur.corr_ids) < CORR_CAP:
        cur.corr_ids.append(c.corr_id)
    return c


def as_carriers(corr) -> tuple:
    """Normalize a ``corr=`` argument: None, one Carrier, or an
    iterable of Carriers -> tuple of Carriers."""
    if corr is None:
        return ()
    if isinstance(corr, Carrier):
        return (corr,)
    return tuple(c for c in corr if isinstance(c, Carrier))


def set_sink(sink) -> None:
    """sink: a path (append JSON lines), a callable(record), or None
    (the in-memory ring, the default).  The previous file sink is closed
    even when opening the new one fails (records then go to the ring)."""
    global _sink, _file
    with _lock:
        old, _file = _file, None
        _sink = None
        try:
            if isinstance(sink, str):
                f = open(sink, "a")
                _file = f
                _sink = lambda rec: (f.write(json.dumps(rec) + "\n"),
                                     f.flush())
            else:
                _sink = sink
        finally:
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass


def add_tap(fn) -> None:
    """Register fn(record) to observe every completed span, in addition
    to the configured sink."""
    with _lock:
        if fn not in _taps:
            _taps.append(fn)


def remove_tap(fn) -> None:
    with _lock:
        if fn in _taps:
            _taps.remove(fn)


def records() -> list[dict]:
    with _lock:
        return list(_records)


def reset() -> None:
    with _lock:
        _records.clear()


def _emit(rec: dict) -> None:
    with _lock:
        taps = list(_taps)
    for tap in taps:
        try:
            tap(rec)
        except Exception:
            pass
    # the sink runs under the lock: set_sink closes the old file under
    # the same lock, so a rotation never closes the file under a write
    with _lock:
        if _sink is not None:
            _sink(rec)
            return
        _records.append(rec)
        if len(_records) > _MAX_RECORDS:
            del _records[: _MAX_RECORDS // 2]


@contextmanager
def span(name: str, corr=None, dispatch_id: int | None = None,
         **attributes):
    """Measure one phase; attaches to the enclosing span as parent.

    ``corr`` (a Carrier or iterable of Carriers) stamps the record with
    the correlation ids; ``dispatch_id`` ties the span to its flight
    record (obs/flight.py)."""
    parent = _current.get()
    sp = _Span(name, next(_span_ids))
    for c in as_carriers(corr):
        if len(sp.corr_ids) >= CORR_CAP:
            break
        sp.corr_ids.append(c.corr_id)
    token = _current.set(sp)
    t0 = time.monotonic_ns()
    err = None
    try:
        yield sp
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        _current.reset(token)
        rec = {
            "name": name,
            "parent": parent.name if parent is not None else None,
            "span_id": sp.span_id,
            "parent_id": parent.span_id if parent is not None else None,
            "tid": threading.get_native_id(),
            "thread": threading.current_thread().name,
            "start_ns": t0,
            "duration_ns": time.monotonic_ns() - t0,
        }
        if sp.corr_ids:
            rec["corr_ids"] = list(sp.corr_ids)
            rec["corr_id"] = sp.corr_ids[0]
        if dispatch_id is not None:
            rec["dispatch_id"] = dispatch_id
        if attributes:
            rec["attributes"] = attributes
        if err is not None:
            rec["error"] = err
        _emit(rec)


# -- the card's timeline ------------------------------------------------------
# One torch.profiler session brackets a whole workload (a replay, a smoke
# phase) and every dispatch inside annotates itself, so the host spans
# line up with the card's kernels in one Chrome trace.  Both are no-ops
# unless a profile directory is given and a session is active.

_profile_active = False          # guarded-by: _lock
_profile_seq = itertools.count(1)


@contextmanager
def profile_session(profile_dir: str | None = None):
    """Bracket a workload with a ``torch.profiler`` session (CPU
    activity, and CUDA activity when a card is present) and export it as
    a Chrome trace, ``<profile_dir>/trace-<pid>-<n>.json``.  Yields that
    path, or None when no directory is given or a session is already
    active (nested or concurrent sessions are no-ops: the flag flips
    under the module lock)."""
    global _profile_active
    if not profile_dir:
        yield None
        return
    with _lock:
        owner = not _profile_active
        if owner:
            _profile_active = True
    if not owner:
        yield None
        return
    try:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace-{os.getpid()}-"
                                         f"{next(_profile_seq)}.json")
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except BaseException:
        with _lock:
            _profile_active = False
        raise
    try:
        yield path
    finally:
        with _lock:
            _profile_active = False
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)


@contextmanager
def annotation(name: str, device=None):
    """A named range around one dispatch inside a profile session:
    ``torch.profiler.record_function``, plus an NVTX range when
    ``device`` is a CUDA device.  A no-op outside a session."""
    if not _profile_active:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextmanager
def device_span(name: str, profile_dir: str | None = None, **attributes):
    """A span that also captures the card's timeline when
    ``profile_dir`` is given (a ``profile_session`` around it)."""
    if profile_dir:
        with profile_session(profile_dir):
            with span(name, profiled=True, **attributes):
                yield
    else:
        with span(name, **attributes):
            yield


def summarize() -> dict:
    """Aggregate by span name: count and total/mean duration."""
    agg: dict[str, list[int]] = {}
    for r in records():
        agg.setdefault(r["name"], []).append(r["duration_ns"])
    return {
        name: {
            "count": len(ds),
            "total_ms": sum(ds) / 1e6,
            "mean_ms": sum(ds) / len(ds) / 1e6,
        }
        for name, ds in agg.items()
    }
