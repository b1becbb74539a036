"""The metric families of the port's supervised dispatch paths.

The same names, help texts, labels and buckets as the JAX package's
``obs/families.py``, so a scrape of either reads the same series.  They
live here, in a module that imports nothing heavy, so the series are
present at zero before their owner modules are imported; the registry
returns the same object for a same-name family, so owner modules import
these instruments rather than re-declaring them.  The route and MCF
families come with the routing slice's supervision.
"""
from __future__ import annotations

from . import registry as _r
from .registry import SIZE_BUCKETS

from . import REGISTRY

RATIO_BUCKETS = _r.RATIO_BUCKETS
DURATION_BUCKETS = _r.DURATION_BUCKETS

# -- daemon/hsmd.py: the batched sign and check ---------------------------
SIGN_BATCH_SIGS = REGISTRY.histogram(
    "clntpu_sign_batch_sigs",
    "Signatures per hsmd batched-sign call, by operation",
    labelnames=("op",), buckets=SIZE_BUCKETS)
SIGN_CALLS = REGISTRY.counter(
    "clntpu_sign_total",
    "hsmd batched-sign calls, by operation and host/device path",
    labelnames=("op", "path"))

# -- resilience/: supervision of the dispatches ---------------------------
BREAKER_STATE = REGISTRY.gauge(
    "clntpu_breaker_state",
    "Circuit-breaker state per dispatch family "
    "(0 = closed, 1 = open, 2 = half-open)",
    labelnames=("family",))
BREAKER_TRANSITIONS = REGISTRY.counter(
    "clntpu_breaker_transitions_total",
    "Circuit-breaker state transitions, by family and target state",
    labelnames=("family", "to"))
BREAKER_FAILURES = REGISTRY.counter(
    "clntpu_breaker_failures_total",
    "Device dispatch failures recorded against a breaker",
    labelnames=("family",))
BREAKER_SHORT_CIRCUITS = REGISTRY.counter(
    "clntpu_breaker_short_circuits_total",
    "Dispatches diverted to the host fallback because the breaker was "
    "open (or a half-open probe was already in flight)",
    labelnames=("family",))
QUARANTINE = REGISTRY.counter(
    "clntpu_quarantine_total",
    "Rows diverted off a failing device dispatch (bisect-isolated or "
    "readback-lost) and re-checked host-side, by family and reason",
    labelnames=("family", "reason"))
FAULT_INJECTED = REGISTRY.counter(
    "clntpu_fault_injected_total",
    "Faults fired by the LIGHTNING_TPU_FAULT injection harness",
    labelnames=("seam", "family", "action"))
DEADLINE_EXCEEDED = REGISTRY.counter(
    "clntpu_deadline_exceeded_total",
    "Dispatch deadlines blown (a hung/slow worker surfaced instead of a "
    "silent stall), by family and seam",
    labelnames=("family", "seam"))
LOOP_RESTARTS = REGISTRY.counter(
    "clntpu_loop_restarts_total",
    "Supervised flush/producer loop restarts after an escaped exception",
    labelnames=("loop",))
INGEST_FLUSH_ERRORS = REGISTRY.counter(
    "clntpu_ingest_flush_errors_total",
    "GossipIngest flush-loop iterations that raised (the loop restarts "
    "with backoff instead of dying silently)")

# -- resilience/overload.py: overload control -----------------------------
SHED = REGISTRY.counter(
    "clntpu_shed_total",
    "Messages/queries shed by the overload controller, by family, "
    "priority class, and reason (every shed is also recorded in the "
    "shed ring — never silently dropped)",
    labelnames=("family", "priority", "reason"))
OVERLOAD_STATE = REGISTRY.gauge(
    "clntpu_overload_state",
    "Degradation-ladder state per dispatch family "
    "(0 = normal, 1 = elevated, 2 = saturated)",
    labelnames=("family",))
OVERLOAD_TRANSITIONS = REGISTRY.counter(
    "clntpu_overload_transitions_total",
    "Degradation-ladder transitions, by family and target state",
    labelnames=("family", "to"))
BACKPRESSURE_WAITS = REGISTRY.counter(
    "clntpu_backpressure_waits_total",
    "Transport read pauses taken because the family was saturated "
    "(one per paused message, bounded per wait)",
    labelnames=("family",))
BACKPRESSURE_WAIT_SECONDS = REGISTRY.histogram(
    "clntpu_backpressure_wait_seconds",
    "Seconds a saturated family paused one transport read",
    labelnames=("family",), buckets=DURATION_BUCKETS)
INGEST_BACKLOG = REGISTRY.gauge(
    "clntpu_ingest_backlog_sigs",
    "Total unverified ingest backlog: queued signatures plus the "
    "in-flight flush batch (the queue gauge counts only queued)")

# -- gossip/verify.py: the replay pipeline's stages --------------------------
# "prep" is the host's bucket build (slice, pack, pin), "stall" is the
# part of prep VISIBLE on the dispatch thread's critical path,
# "dispatch" is upload + kernel enqueue, "readback" is the single
# end-of-replay block on the verdicts.
REPLAY_PREP = REGISTRY.counter(
    "clntpu_replay_prep_seconds_total",
    "Host bucket-prep busy time (slice + pack + pad), all buckets")
REPLAY_STALL = REGISTRY.counter(
    "clntpu_replay_prep_stall_seconds_total",
    "Prep time visible on the dispatch critical path (queue-empty waits; "
    "== prep time when the pipeline is serial/depth 0)")
REPLAY_DISPATCH = REGISTRY.counter(
    "clntpu_replay_dispatch_seconds_total",
    "Dispatch-thread time spent uploading + enqueueing bucket programs")
REPLAY_READBACK = REGISTRY.counter(
    "clntpu_replay_readback_seconds_total",
    "Time blocked on the single end-of-replay device readback")
REPLAY_OVERLAP = REGISTRY.histogram(
    "clntpu_replay_overlap_ratio",
    "Per-replay fraction of host prep hidden behind device compute "
    "(1 - stall/prep; serial pipelines observe 0)",
    buckets=RATIO_BUCKETS)
REPLAY_QDEPTH = REGISTRY.histogram(
    "clntpu_replay_queue_depth",
    "Prepared-bucket queue depth sampled at each dispatch",
    buckets=_r.log2_buckets(1.0, 16.0))
REPLAY_BUCKETS = REGISTRY.counter(
    "clntpu_replay_buckets_total",
    "Fused bucket dispatches, by device path",
    labelnames=("path",))

# -- transfer accounting of the batched dispatches ------------------------
TRANSFER_BYTES = REGISTRY.counter(
    "clntpu_transfer_bytes_total",
    "Host<->device bytes staged for batched dispatches, by family and "
    "direction (h2d = operand upload, d2h = result readback; "
    "operand-size accounting, not a PCIe counter)",
    labelnames=("family", "direction"))
# -- gossip/store.py: crash-consistent restart ----------------------------
RECOVERY_STORE_ROWS = REGISTRY.counter(
    "clntpu_recovery_store_rows_total",
    "Store records handled by the recovery scan, by action "
    "(requalified = crc-bad but host re-check passed, dropped = "
    "crc-bad and failed the re-check, flagged deleted)",
    labelnames=("action",))
RECOVERY_STORE_TRUNCATED_BYTES = REGISTRY.counter(
    "clntpu_recovery_store_truncated_bytes_total",
    "Torn-tail bytes truncated off the gossip store at recovery "
    "(a crash mid-append leaves at most one partial record at EOF)")

# -- obs/flight.py: the dispatch flight recorder --------------------------
DISPATCHES = REGISTRY.counter(
    "clntpu_dispatches_total",
    "Flight-recorded dispatches, by family and outcome (the aggregate "
    "view of the listdispatches ring)",
    labelnames=("family", "outcome"))
SLOW_DISPATCH = REGISTRY.counter(
    "clntpu_slow_dispatch_total",
    "Dispatches flagged by the slow-dispatch watchdog (over "
    "LIGHTNING_TPU_SLOW_DISPATCH_S, or the rolling per-family p99)",
    labelnames=("family",))
