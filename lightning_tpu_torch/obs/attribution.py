"""Perf attribution: stage breakdown of the batched dispatch pipelines.

A critical-path pipeline model over the flight records (obs/flight.py)
and the ``clntpu_replay_*`` stage counters that turns them into, per
dispatch family:

  * the stage breakdown (queue_wait / prep / stall / dispatch /
    readback seconds) and which stages sit ON the critical path;
  * overlap efficiency (how much host prep the producer pipeline hid
    behind the card's work);
  * the bottleneck stage and a speedup-if-removed projection for every
    critical stage (Amdahl over the critical path);
  * achieved throughput against a kernel rate the caller passes in
    (``kernel_rate``: items a second of the family's kernels alone).

Also here: the post-warmup RETRACE DETECTOR.  Warmup functions wrap
their bodies in ``warmup_scope()``; once any warmup has completed, a
program-shape first sight reported by ``note_program()`` is an anomaly
(the live path met a shape its warmup promised) and fires
``clntpu_retrace_total{program}`` and a ``retrace`` events-bus topic.
The port has no warmup functions yet, so the detector is never armed
and ``clntpu_retrace_total`` stays at 0 on the card; the dispatch sites
report their shapes all the same.

Imports nothing heavy.  ``sample_device_memory()`` reads the CUDA
caching allocator's statistics only when torch is already imported and
has initialised CUDA in this process: reporting memory never
initialises the card.
"""
from __future__ import annotations

import logging
import sys
import threading
import time
from contextlib import contextmanager

from ..utils import events
from . import families as _f

log = logging.getLogger("lightning_tpu_torch.obs.attribution")

# the five-stage vocabulary (the flight-record fields and the
# clntpu_replay_* counter family)
STAGES = ("queue_wait", "prep", "stall", "dispatch", "readback")

# reconciliation tolerance: ring sums and the clntpu_replay_* counters
# measure the same quantities through different code paths; relative
# disagreement beyond this is unattributed wall time and the report
# says so instead of papering over it.  Disagreement under ABS_FLOOR_S
# per dispatch is timer placement overhead (the counter's stopwatch
# wraps the record's) and never counts against the epsilon — without
# the floor, a µs-scale stub workload reads as 80% "unattributed".
EPSILON = 0.05
ABS_FLOOR_S = 1e-3

_RETRACE_RING = 64

_lock = threading.Lock()
_seen: set = set()           # guarded-by: _lock
_warmup_depth = 0            # guarded-by: _lock
_armed = False                # guarded-by: _lock
_retraces: list = []          # guarded-by: _lock
_retrace_count = 0            # guarded-by: _lock (monotonic; the ring
#                               above keeps only the recent 64)


# ---------------------------------------------------------------------------
# The retrace detector


def note_program(program: str, key=()) -> bool:
    """Record a program-shape first-sight.  Call from every dispatch
    site (routing/device's route sweep, routing/mcf_device's mcf solve)
    with the program name and its static shape key.  Returns
    True when the sighting fired the retrace anomaly: first sight of
    this (program, key), outside any warmup_scope, after at least one
    warmup completed."""
    global _retrace_count
    k = (str(program), tuple(key) if isinstance(key, (list, tuple))
         else (key,))
    with _lock:
        if k in _seen:
            return False
        _seen.add(k)
        fire = _armed and _warmup_depth == 0
        if fire:
            ev = {"program": k[0], "key": list(k[1]),
                  "ts": round(time.time(), 3)}
            _retraces.append(ev)
            del _retraces[:-_RETRACE_RING]
            _retrace_count += 1
    if fire:
        _f.RETRACE.labels(k[0]).inc()
        log.warning(
            "post-warmup retrace: program %r compiled a new shape %r "
            "on the live path: warmup() coverage is incomplete",
            k[0], k[1])
        events.emit("retrace", ev)
    return fire


@contextmanager
def warmup_scope():
    """Bracket a warmup body: first-sights inside the scope are
    expected (they ARE the warmup) and never fire the anomaly; the
    first scope to EXIT arms the detector for the rest of the process
    lifetime.  Re-entrant and thread-safe."""
    global _warmup_depth, _armed
    with _lock:
        _warmup_depth += 1
    try:
        yield
    finally:
        with _lock:
            _warmup_depth -= 1
            _armed = True


def retrace_state() -> dict:
    """The ``retraces`` section of the perf report.  ``total`` is the
    monotonic lifetime count (it must agree with clntpu_retrace_total);
    ``recent`` is the bounded ring of the last few events."""
    with _lock:
        return {"armed": _armed, "in_warmup": _warmup_depth > 0,
                "known_programs": len(_seen), "total": _retrace_count,
                "recent": [dict(r) for r in _retraces]}


# ---------------------------------------------------------------------------
# Device memory


def sample_device_memory() -> dict:
    """Per-device memory statistics of the CUDA caching allocator, set
    on the clntpu_device_memory_bytes gauge and returned as a dict keyed
    ``cuda:N``.  The JAX package's names for its backend's statistics:
    ``bytes_in_use`` (``allocated_bytes.all.current``),
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``),
    ``bytes_limit`` (the device's total memory, ``mem_get_info``) and
    ``bytes_reserved`` (``reserved_bytes.all.current``).  Samples only
    when torch is already imported and CUDA initialised in this process,
    and only devices the allocator has used."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    try:
        if not torch.cuda.is_initialized():
            return {}
        n = torch.cuda.device_count()
    except Exception:
        return {}
    out: dict = {}
    for d in range(n):
        try:
            ms = torch.cuda.memory_stats(d)
        except Exception:
            ms = None
        if not ms:
            continue
        try:
            limit = torch.cuda.mem_get_info(d)[1]
        except Exception:
            limit = None
        dev = f"cuda:{d}"
        stats = {}
        for stat, v in (("bytes_in_use",
                         ms.get("allocated_bytes.all.current")),
                        ("peak_bytes_in_use",
                         ms.get("allocated_bytes.all.peak")),
                        ("bytes_limit", limit),
                        ("bytes_reserved",
                         ms.get("reserved_bytes.all.current"))):
            if v is not None:
                stats[stat] = int(v)
                _f.DEVICE_MEMORY.labels(dev, stat).set(float(v))
        if stats:
            out[dev] = stats
    return out


# ---------------------------------------------------------------------------
# The critical-path pipeline model


def _ring_sums(records: list[dict]) -> dict:
    """Per-stage second totals (and byte/item tallies) over a list of
    flight DispatchRecords."""
    out = {"queue_wait_s": 0.0, "prep_s": 0.0, "dispatch_s": 0.0,
           "readback_s": 0.0, "h2d_bytes": 0, "d2h_bytes": 0,
           "items": 0, "lanes": 0, "quarantined": 0}
    first_ns = last_ns = None
    outcomes: dict = {}
    for r in records:
        out["queue_wait_s"] += (r.get("queue_wait_ms") or 0.0) / 1e3
        out["prep_s"] += (r.get("prep_ms") or 0.0) / 1e3
        out["dispatch_s"] += (r.get("dispatch_ms") or 0.0) / 1e3
        out["readback_s"] += (r.get("readback_ms") or 0.0) / 1e3
        out["h2d_bytes"] += int(r.get("h2d_bytes") or 0)
        out["d2h_bytes"] += int(r.get("d2h_bytes") or 0)
        out["items"] += int(r.get("n_real") or 0)
        out["lanes"] += int(r.get("lanes") or 0)
        out["quarantined"] += int(r.get("quarantined") or 0)
        oc = r.get("outcome") or "?"
        outcomes[oc] = outcomes.get(oc, 0) + 1
        ns = r.get("ts_ns")
        if ns is not None:
            first_ns = ns if first_ns is None else min(first_ns, ns)
            last_ns = ns if last_ns is None else max(last_ns, ns)
    out["outcomes"] = outcomes
    if first_ns is not None and last_ns is not None and records:
        # span start -> last record start + its own duration.  prep is
        # included so a serial family's span is never SMALLER than its
        # critical path (an internally inconsistent report); for the
        # overlapped replay this overstates by at most the last
        # bucket's hidden prep — bounded, and errs toward reporting
        # idle time rather than hiding it.
        last = max(records, key=lambda r: r.get("ts_ns") or 0)
        tail_s = ((last.get("queue_wait_ms") or 0.0)
                  + (last.get("prep_ms") or 0.0)
                  + (last.get("dispatch_ms") or 0.0)
                  + (last.get("readback_ms") or 0.0)) / 1e3
        out["wall_span_s"] = (last_ns - first_ns) / 1e9 + tail_s
    else:
        out["wall_span_s"] = 0.0
    return out


def _speedup(critical_s: float, stage_s: float) -> float | None:
    """Amdahl over the critical path: end-to-end speedup if this stage
    cost nothing (None when the stage IS the whole path)."""
    if critical_s <= 0 or stage_s <= 0:
        return 1.0
    rest = critical_s - stage_s
    if rest <= 0:
        return None
    return round(critical_s / rest, 4)


def attribute_family(family: str, records: list[dict], *,
                     stage_totals_s: dict | None = None,
                     ring_complete: bool = True,
                     kernel_rate: float | None = None,
                     epsilon: float = EPSILON) -> dict:
    """Attribute one dispatch family's wall time across the pipeline
    stages and name the bottleneck.

    ``records`` are the family's flight DispatchRecords (ring order).
    ``stage_totals_s`` — when given (the verify family passes the
    clntpu_replay_* counter totals: keys prep/stall/dispatch/readback)
    — is the authoritative OVERLAPPED-pipeline timing source: prep runs
    on a producer thread and only its ``stall`` share is visible on the
    critical path, so critical = stall + dispatch + readback.  Without
    it the family is modeled serial (route flushes, sign batches):
    every stage is on the critical path and critical = queue_wait +
    prep + dispatch + readback.

    Returns the per-family report section: stages, critical-path
    membership, overlap ratio, bottleneck, per-stage speedup-if-removed,
    throughput, transfer rates, an optional roofline comparison, and,
    when both sources cover the same dispatches (``ring_complete``), a
    reconciliation block asserting the two agree within ``epsilon``."""
    ring = _ring_sums(records)
    overlapped = stage_totals_s is not None
    if overlapped:
        stages = {
            "queue_wait_s": round(ring["queue_wait_s"], 6),
            "prep_s": round(stage_totals_s.get("prep", 0.0), 6),
            "stall_s": round(stage_totals_s.get("stall", 0.0), 6),
            "dispatch_s": round(stage_totals_s.get("dispatch", 0.0), 6),
            "readback_s": round(stage_totals_s.get("readback", 0.0), 6),
        }
        critical = {"stall": stages["stall_s"],
                    "dispatch": stages["dispatch_s"],
                    "readback": stages["readback_s"]}
        prep = stages["prep_s"]
        overlap = (max(0.0, 1.0 - stages["stall_s"] / prep)
                   if prep > 0 else None)
    else:
        stages = {
            "queue_wait_s": round(ring["queue_wait_s"], 6),
            "prep_s": round(ring["prep_s"], 6),
            "stall_s": round(ring["prep_s"], 6),  # serial: all visible
            "dispatch_s": round(ring["dispatch_s"], 6),
            "readback_s": round(ring["readback_s"], 6),
        }
        critical = {"queue_wait": stages["queue_wait_s"],
                    "prep": stages["prep_s"],
                    "dispatch": stages["dispatch_s"],
                    "readback": stages["readback_s"]}
        overlap = 0.0 if stages["prep_s"] > 0 else None
    critical_s = sum(critical.values())
    bottleneck = (max(critical, key=lambda s: critical[s])
                  if critical_s > 0 else None)
    # Rates divide RING-scoped items/bytes, so they must divide by
    # RING-scoped seconds too: the stage counters are process-lifetime
    # while the ring is bounded, and mixing the two understates every
    # rate by (lifetime/ring) once the ring wraps.  The ring's stall
    # share is the recorded queue waits — or inline prep when the
    # replay ran serial (depth 0 records no queue waits at all).
    if overlapped:
        stall_ring = ring["queue_wait_s"] or ring["prep_s"]
        window_s = stall_ring + ring["dispatch_s"] + ring["readback_s"]
    else:
        window_s = critical_s
    section = {
        "family": family,
        "dispatches": len(records),
        "items": ring["items"],
        "lanes": ring["lanes"],
        "occupancy": (round(ring["items"] / ring["lanes"], 4)
                      if ring["lanes"] else None),
        "outcomes": ring["outcomes"],
        "quarantined": ring["quarantined"],
        "pipeline": "overlapped" if overlapped else "serial",
        "stages": stages,
        "critical_path": sorted(critical),
        "critical_path_s": round(critical_s, 6),
        "window_s": round(window_s, 6),
        "hidden_prep_s": round(max(0.0, stages["prep_s"]
                                   - stages["stall_s"]), 6),
        "overlap_ratio": (round(overlap, 4)
                          if overlap is not None else None),
        "wall_span_s": round(ring["wall_span_s"], 6),
        "idle_s": round(max(0.0, ring["wall_span_s"] - critical_s), 6),
        "bottleneck": bottleneck,
        "speedup_if_removed": {s: _speedup(critical_s, v)
                               for s, v in critical.items()},
        "transfer": {
            "h2d_bytes": ring["h2d_bytes"],
            "d2h_bytes": ring["d2h_bytes"],
            "h2d_bytes_per_s": (round(ring["h2d_bytes"] / window_s, 1)
                                if window_s > 0 else None),
        },
    }
    if window_s > 0 and ring["items"]:
        achieved = ring["items"] / window_s
        section["throughput_per_s"] = round(achieved, 1)
        if kernel_rate:
            section["roofline"] = {
                "kernel_items_per_s": round(float(kernel_rate), 1),
                "achieved_items_per_s": round(achieved, 1),
                "fraction_of_roofline": round(achieved / kernel_rate, 4),
                "gap_x": round(kernel_rate / achieved, 2),
            }
    else:
        section["throughput_per_s"] = None
    if overlapped:
        # the two timing sources must agree on the same dispatches:
        # counters are process-lifetime, the ring is bounded, so only a
        # ring that still holds every dispatch can be reconciled
        recon = {"checked": bool(ring_complete), "epsilon": epsilon}
        if ring_complete:
            floor = ABS_FLOOR_S * max(1, len(records))

            def rel(a: float, b: float) -> float:
                if abs(a - b) <= floor:
                    return 0.0
                scale = max(abs(a), abs(b))
                return (round(abs(a - b) / scale, 6)
                        if scale > 1e-9 else 0.0)

            # which ring quantity the stall counter measured depends on
            # pipeline depth: a STREAMED replay surfaces stall as the
            # per-record producer-queue wait, a SERIAL one (depth 0)
            # as inline prep (stall == prep by definition).  Reconcile
            # against whichever interpretation the ring supports.
            stall_vs_qw = rel(ring["queue_wait_s"], stages["stall_s"])
            stall_vs_prep = rel(ring["prep_s"], stages["stall_s"])
            stall_ring = (ring["queue_wait_s"]
                          if stall_vs_qw <= stall_vs_prep
                          else ring["prep_s"])
            errs = {
                "prep": rel(ring["prep_s"], stages["prep_s"]),
                "stall": min(stall_vs_qw, stall_vs_prep),
                "dispatch": rel(ring["dispatch_s"],
                                stages["dispatch_s"]),
                "readback": rel(ring["readback_s"],
                                stages["readback_s"]),
            }
            recon["rel_err"] = errs
            recon["max_rel_err"] = max(errs.values())
            recon["ok"] = recon["max_rel_err"] <= epsilon
            recon["unattributed_s"] = round(
                abs(stall_ring + ring["dispatch_s"]
                    + ring["readback_s"] - critical_s), 6)
        section["reconciliation"] = recon
    return section


def _counter_value(metrics: dict, name: str) -> float:
    fam = metrics.get(name)
    if not fam:
        return 0.0
    return float(sum(s.get("value", 0.0) for s in fam.get("samples", ())))


def replay_stage_totals(metrics: dict) -> dict | None:
    """Extract the clntpu_replay_* stage totals (seconds) from a
    metrics snapshot; None when the pipeline has not run (all zero), so
    the verify family falls back to the serial ring model instead of
    reconciling against nothing."""
    totals = {
        "prep": _counter_value(metrics, "clntpu_replay_prep_seconds_total"),
        "stall": _counter_value(
            metrics, "clntpu_replay_prep_stall_seconds_total"),
        "dispatch": _counter_value(
            metrics, "clntpu_replay_dispatch_seconds_total"),
        "readback": _counter_value(
            metrics, "clntpu_replay_readback_seconds_total"),
    }
    if not any(v > 0 for v in totals.values()):
        return None
    return totals


def report_local(kernel_rate: float | None = None,
                 families: list[str] | None = None,
                 metrics: dict | None = None,
                 flight_summary: dict | None = None) -> dict:
    """The full perf report off THIS process's live registry and
    flight rings.  Callers that already hold a registry snapshot or a
    flight summary pass them in to avoid a second full walk."""
    from . import REGISTRY, flight

    if metrics is None:
        metrics = REGISTRY.snapshot()["metrics"]
    summ = (flight_summary if flight_summary is not None
            else flight.summary())["families"]
    report: dict = {
        "generated_at": round(time.time(), 3),
        "epsilon": EPSILON,
        "kernel_rate": kernel_rate,
        "families": {},
        "retraces": retrace_state(),
        "device_memory": sample_device_memory(),
    }
    for fam in sorted(summ):
        if families is not None and fam not in families:
            continue
        records = flight.recent(fam)
        totals = replay_stage_totals(metrics) if fam == "verify" else None
        report["families"][fam] = attribute_family(
            fam, records, stage_totals_s=totals,
            ring_complete=summ[fam]["total"] == len(records),
            kernel_rate=kernel_rate if fam == "verify" else None)
    return report


def report_from_snapshot(snap: dict,
                         kernel_rate: float | None = None) -> dict:
    """The same report computed OFFLINE from a saved capture: a dict
    with ``metrics`` (a registry snapshot's), ``dispatch_log`` (flight
    records), ``dispatches`` (a flight summary) and, optionally,
    ``perf``.  Ring completeness cannot be judged from a
    capture, so reconciliation is only attempted when the log holds at
    least as many dispatches as the lifetime counter reports."""
    metrics = snap.get("metrics", {})
    by_family: dict[str, list] = {}
    for rec in snap.get("dispatch_log", ()):
        by_family.setdefault(rec.get("family", "?"), []).append(rec)
    totals_fam = (snap.get("dispatches", {}) or {}).get("families", {})
    report: dict = {
        "generated_at": round(time.time(), 3),
        "epsilon": EPSILON,
        "kernel_rate": kernel_rate,
        "families": {},
        "retraces": snap.get("perf", {}).get("retraces", {}),
        "device_memory": snap.get("perf", {}).get("device_memory", {}),
    }
    for fam in sorted(by_family):
        records = by_family[fam]
        lifetime = (totals_fam.get(fam) or {}).get("total", len(records))
        totals = replay_stage_totals(metrics) if fam == "verify" else None
        report["families"][fam] = attribute_family(
            fam, records, stage_totals_s=totals,
            ring_complete=len(records) >= lifetime,
            kernel_rate=kernel_rate if fam == "verify" else None)
    return report


def compact(report: dict) -> dict:
    """The one-line-per-family view: bottleneck, critical path and
    throughput, no sub-tables."""
    fams = {}
    for fam, sec in report.get("families", {}).items():
        fams[fam] = {
            "bottleneck": sec.get("bottleneck"),
            "critical_path_s": sec.get("critical_path_s"),
            "throughput_per_s": sec.get("throughput_per_s"),
            "overlap_ratio": sec.get("overlap_ratio"),
        }
    return {"families": fams,
            "retraces": report.get("retraces", {}).get("total", 0)}


def reset_for_tests() -> None:
    global _warmup_depth, _armed, _retrace_count
    with _lock:
        _seen.clear()
        _retraces.clear()
        _warmup_depth = 0
        _armed = False
        _retrace_count = 0
