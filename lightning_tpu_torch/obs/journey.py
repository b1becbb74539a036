"""Per-item journeys: entity-level provenance through the batched
dispatch pipelines.

The flight ring, the perf attribution, the health SLOs and the incident
bundles all key on the BATCH, so none of them can answer "why is this
scid's channel_update not in my route planes?" or "where did part 3 of
this payment spend 400 ms?".  This module keys on the WORK ITEM: a
sampled entity (a channel's scid, a node id, a payment hash) gathers one
bounded journey of hop records as it moves through the pipeline, each
hop carrying the ``dispatch_id``/``corr_id`` of the batch that carried
it, so a journey stitches into the flight ring and the trace timeline.

Sampling is DETERMINISTIC and entity-keyed: ``crc32(kind/key) % sample
== 0``.  The same entity is therefore sampled at every hop, in every
thread and process, with no coordination.  ``sample`` 0 disables (the
default: no table growth, one int compare an item), 1 samples
everything.  ``configure(sample, max_entities, hops)`` sets the three
settings (the table's LRU bound and the hops kept a journey); nothing is
read from the environment.

Queue wait against service: a hop's ``wait_ms`` is the time the ITEM
spent queued before its batch dispatched (flush start - enqueue),
``service_ms`` the batch execution it shared.  Dispatch sites also add,
for EVERY item sampled or not, the batch-side
``clntpu_journey_batch_wait_seconds_total{stage}``; with sample 1 the
per-item waits add up to it.

Imports nothing heavy; the unsampled fast path is one int compare,
sampled hops take one short critical section on ``_lock``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
import zlib

from . import families as _f

# entity classes (bounded label vocabulary)
KINDS = ("channel", "node", "payment")

# The FIXED hop vocabulary (the JAX package's).  Call sites pass one of
# these as a string literal, so the per-hop histograms stay bounded.
HOPS = (
    # gossip-message journey (ingest → planes)
    "recv",        # peer bytes reached gossipd
    "admit",       # passed precheck + overload admission, queued
    "shed",        # overload/pending-cap shed (terminal)
    "drop",        # dedup/stale/ratelimit/badsig/utxo drop (terminal)
    "verify",      # signature checked inside a batched verify dispatch
    "store",       # durable gossip_store append (write-ahead fsync)
    "fold",        # folded into the live gossmap arrays
    "planes",      # route-planes parameter patch picked the update up
    "mcf_planes",  # MCF planes refreshed over the update
    # payment journey (xpay → HTLC resolution)
    "enqueue",     # getroutes query entered the mcf flush queue
    "mcf_flush",   # solved inside a batched mcf dispatch
    "parts",       # flow decomposed into MPP parts
    "htlc_add",    # one part's HTLC offered on a channel
    "htlc_part",   # receiver-side MPP accumulator verdict
    "htlc_settle",  # part fulfilled (terminal)
    "htlc_fail",   # part failed (terminal)
)
HOP_SET = frozenset(HOPS)
TERMINAL_HOPS = frozenset(("shed", "drop", "htlc_settle", "htlc_fail"))

# batch-side reconciliation stages (clntpu_journey_batch_wait label set)
STAGES = ("verify", "mcf")

_WINDOW = 256        # per-hop (wait, service) window for p50/p99
_E2E_WINDOW = 512    # rolling end-to-end latencies of finished journeys

_lock = threading.Lock()
_ids = itertools.count(1)            # thread-safe without the lock
# (kind, key) -> journey dict, LRU order    guarded-by: _lock
_table: "collections.OrderedDict[tuple, dict]" = collections.OrderedDict()
_hop_wait: dict[str, collections.deque] = {}      # guarded-by: _lock
_hop_service: dict[str, collections.deque] = {}   # guarded-by: _lock
_e2e_ms: collections.deque = collections.deque(maxlen=_E2E_WINDOW)
                                                  # guarded-by: _lock
_evicted = 0                                      # guarded-by: _lock


# the defaults of the three settings (sampling off)
SAMPLE = 0
MAX_ENTITIES = 512
HOPS_PER_JOURNEY = 64

_SAMPLE = SAMPLE
_MAX = MAX_ENTITIES
_HOPCAP = HOPS_PER_JOURNEY


def configure(sample: int = SAMPLE, max_entities: int = MAX_ENTITIES,
              hops: int = HOPS_PER_JOURNEY) -> None:
    """Set the sampling modulus (0 off, 1 every entity), the journey
    table's bound and the hops kept a journey."""
    global _SAMPLE, _MAX, _HOPCAP
    _SAMPLE = int(sample)
    _MAX = max(1, int(max_entities))
    _HOPCAP = max(1, int(hops))


def settings() -> dict:
    """The three settings ``configure`` sets."""
    return {"sample": _SAMPLE, "max_entities": _MAX, "hops": _HOPCAP}


# -- sampling ---------------------------------------------------------------


def canon_key(kind: str, key) -> object:
    """Canonical table key: int for channels (scid), lowercase hex for
    node ids / payment hashes (bytes accepted)."""
    if kind == "channel":
        return int(key)
    if isinstance(key, (bytes, bytearray, memoryview)):
        return bytes(key).hex()
    return str(key).lower()


def _key_bytes(kind: str, key) -> bytes:
    if kind == "channel":
        return int(key).to_bytes(8, "big", signed=False)
    k = canon_key(kind, key)
    try:
        return bytes.fromhex(k)
    except ValueError:
        return k.encode()


def enabled() -> bool:
    """True when sampling is configured at all — the cheap pre-gate
    dispatch sites consult before doing any per-item bookkeeping."""
    return _SAMPLE > 0


def sampled(kind: str, key) -> bool:
    """Deterministic entity-keyed sampling decision.  Stable across
    threads, processes, and restarts: every hop of a sampled entity is
    recorded with no coordination, and an unsampled entity costs one
    int compare here."""
    n = _SAMPLE
    if n <= 0:
        return False
    if n == 1:
        return True
    h = zlib.crc32(kind.encode() + b"/" + _key_bytes(kind, key))
    return h % n == 0


# -- recording --------------------------------------------------------------


def hop(name: str, kind: str, key, *, outcome: str = "ok",
        wait_s: float = 0.0, service_s: float = 0.0,
        dispatch_id: int | None = None, corr_id: int | None = None,
        t_ns: int | None = None, **attrs) -> bool:
    """Record one hop on an entity's journey (no-op unless sampled).

    ``name`` must be one of HOPS.  ``wait_s``/``service_s`` split the
    batching tax (see the module docstring);
    ``dispatch_id`` links the hop to the flight-ring record of the
    batch that carried the item, ``corr_id`` to its trace flow chain.
    Returns True when the hop was recorded."""
    if name not in HOP_SET:
        raise ValueError(f"unknown journey hop {name!r}")
    if kind not in KINDS:
        raise ValueError(f"unknown journey kind {kind!r}")
    if not sampled(kind, key):
        return False
    now = time.monotonic_ns() if t_ns is None else int(t_ns)
    rec = {
        "hop": name,
        "t_ns": now,
        "outcome": str(outcome),
        "wait_ms": round(float(wait_s) * 1e3, 3),
        "service_ms": round(float(service_s) * 1e3, 3),
        "dispatch_id": None if dispatch_id is None else int(dispatch_id),
        "corr_id": None if corr_id is None else int(corr_id),
    }
    if attrs:
        rec["attrs"] = {k: v for k, v in attrs.items() if v is not None}
    k = (kind, canon_key(kind, key))
    created = False
    with _lock:
        j = _table.get(k)
        if j is None:
            created = True
            j = {
                "seq": next(_ids),
                "kind": kind,
                "key": k[1],
                "first_ns": now,
                "last_ns": now,
                "done": False,
                "truncated": 0,
                "hops": [],
            }
            _table[k] = j
            global _evicted
            while len(_table) > _MAX:
                _table.popitem(last=False)
                _evicted += 1
        else:
            _table.move_to_end(k)
        if len(j["hops"]) < _HOPCAP:
            j["hops"].append(rec)
        else:
            j["truncated"] += 1
        j["last_ns"] = max(j["last_ns"], now)
        terminal = name in TERMINAL_HOPS
        if terminal:
            j["done"] = True
            _e2e_ms.append((j["last_ns"] - j["first_ns"]) / 1e6)
        w = _hop_wait.get(name)
        if w is None:
            w = _hop_wait[name] = collections.deque(maxlen=_WINDOW)
            _hop_service[name] = collections.deque(maxlen=_WINDOW)
        w.append(rec["wait_ms"])
        _hop_service[name].append(rec["service_ms"])
        table_size = len(_table)
    if created:
        _f.JOURNEY_SAMPLED.labels(kind).inc()
    _f.JOURNEY_TABLE.set(table_size)
    _f.JOURNEY_HOP_WAIT.labels(name).observe(float(wait_s))
    _f.JOURNEY_HOP_SERVICE.labels(name).observe(float(service_s))
    return True


def note_batch_wait(stage: str, wait_s: float) -> None:
    """Batch-side queue-wait accounting, incremented by dispatch sites
    for EVERY item (sampled or not): Σ(flush_start − enqueue) over the
    batch.  The per-item journey waits must reconcile against this
    counter within ε when sampling is 1."""
    if stage not in STAGES:
        raise ValueError(f"unknown journey stage {stage!r}")
    _f.JOURNEY_BATCH_WAIT.labels(stage).inc(max(0.0, float(wait_s)))


# -- exposition -------------------------------------------------------------


def _copy(j: dict) -> dict:
    out = dict(j)
    out["hops"] = [dict(h) for h in j["hops"]]
    out["e2e_ms"] = round((j["last_ns"] - j["first_ns"]) / 1e6, 3)
    return out


def lookup(kind: str, key) -> dict | None:
    """One entity's journey (a copy), or None when never sampled."""
    with _lock:
        j = _table.get((kind, canon_key(kind, key)))
        return None if j is None else _copy(j)


def recent(limit: int = 20) -> list[dict]:
    """The most recently touched journeys, newest first (copies)."""
    with _lock:
        js = sorted(_table.values(), key=lambda j: j["last_ns"],
                    reverse=True)
        if limit is not None and limit > 0:
            js = js[:limit]
        return [_copy(j) for j in js]


def _quantile(vals: list[float], q: float) -> float | None:
    if not vals:
        return None
    s = sorted(vals)
    return s[min(len(s) - 1, int(q * len(s)))]


def e2e_p99_ms() -> float | None:
    """Rolling p99 of finished journeys' end-to-end latency (the
    slow-journey threshold)."""
    with _lock:
        return _quantile(list(_e2e_ms), 0.99)


def summary() -> dict:
    """The journeys section of an incident bundle: sampling
    config, table occupancy, per-hop queue-vs-service quantiles, the
    rolling e2e tail, and the slowest finished journey."""
    with _lock:
        by_hop = {}
        for name, w in _hop_wait.items():
            sv = list(_hop_service[name])
            wv = list(w)
            by_hop[name] = {
                "count": len(wv),
                "wait_ms_p50": _quantile(wv, 0.50),
                "wait_ms_p99": _quantile(wv, 0.99),
                "service_ms_p50": _quantile(sv, 0.50),
                "service_ms_p99": _quantile(sv, 0.99),
            }
        slowest = None
        for j in _table.values():
            if not j["done"]:
                continue
            if slowest is None or (j["last_ns"] - j["first_ns"]) > (
                    slowest["last_ns"] - slowest["first_ns"]):
                slowest = j
        e2e = list(_e2e_ms)
        return {
            "enabled": _SAMPLE > 0,
            "sample": _SAMPLE,
            "max_entities": _MAX,
            "entities": len(_table),
            "finished": sum(1 for j in _table.values() if j["done"]),
            "evicted": _evicted,
            "by_hop": by_hop,
            "e2e_ms_p50": _quantile(e2e, 0.50),
            "e2e_ms_p99": _quantile(e2e, 0.99),
            "slowest": None if slowest is None else _copy(slowest),
        }


# Chrome-trace splice: journey hops render as X slices on synthetic
# per-journey tracks (tid base 1 << 29, below the flight-ring band at
# 1 << 30) whose corr_ids hook them into the existing flow-arrow
# chains: obs/traceexport.chrome_trace treats these exactly like live
# span records.
JOURNEY_TID_BASE = 1 << 29


def journey_span_records(limit: int | None = None) -> list[dict]:
    """Span-record-shaped dicts (one per hop) for chrome_trace():
    every field trace.py spans carry that the exporter reads — name,
    start/duration, a synthetic per-journey tid, span_id (flow sort
    key), and the hop's corr_id for flow splicing."""
    out = []
    for j in recent(limit=limit or 0):
        tid = JOURNEY_TID_BASE + j["seq"]
        for i, h in enumerate(j["hops"]):
            busy_ns = int((h["wait_ms"] + h["service_ms"]) * 1e6)
            out.append({
                "name": "journey/" + h["hop"],
                "start_ns": h["t_ns"] - max(busy_ns, 1_000),
                "duration_ns": max(busy_ns, 1_000),
                "tid": tid,
                "thread": "journey:" + j["kind"],
                "span_id": -(j["seq"] * 1_000 + i),
                "corr_ids": ([h["corr_id"]]
                             if h["corr_id"] is not None else []),
                "attributes": {
                    "kind": j["kind"], "key": str(j["key"]),
                    "outcome": h["outcome"],
                    "dispatch_id": h["dispatch_id"],
                },
            })
    return out


def reset_for_tests() -> None:
    global _evicted
    with _lock:
        _table.clear()
        _hop_wait.clear()
        _hop_service.clear()
        _e2e_ms.clear()
        _evicted = 0
    configure()
