"""The metric families of the port's supervised dispatch paths.

The same names, help texts, labels and buckets as the JAX package's
``obs/families.py``, so a scrape of either reads the same series.  They
live here, in a module that imports nothing heavy, so the series are
present at zero before their owner modules are imported; the registry
returns the same object for a same-name family, so owner modules import
these instruments rather than re-declaring them.
"""
from __future__ import annotations

from . import registry as _r
from .registry import SIZE_BUCKETS

from . import REGISTRY

RATIO_BUCKETS = _r.RATIO_BUCKETS
DURATION_BUCKETS = _r.DURATION_BUCKETS

# -- routing/device.py: the supervised route flushes ---------------------
ROUTE_FLUSH_SECONDS = REGISTRY.histogram(
    "clntpu_route_flush_seconds",
    "End-to-end wall time of one route flush (plane refresh + solve + "
    "reconstruct, device and host paths together)",
    buckets=DURATION_BUCKETS)
ROUTE_BATCH_QUERIES = REGISTRY.histogram(
    "clntpu_route_batch_queries",
    "Route queries coalesced per flush", buckets=SIZE_BUCKETS)
ROUTE_OCCUPANCY = REGISTRY.histogram(
    "clntpu_route_batch_occupancy_ratio",
    "Real queries / padded device lanes per dispatch",
    buckets=RATIO_BUCKETS)
ROUTE_QUERIES = REGISTRY.counter(
    "clntpu_route_queries_total",
    "Route queries solved, by execution path and outcome",
    labelnames=("path", "outcome"))
ROUTE_FALLBACK = REGISTRY.counter(
    "clntpu_route_fallback_total",
    "Queries diverted from the device solver to host dijkstra, by reason",
    labelnames=("reason",))
ROUTE_QUEUE = REGISTRY.gauge(
    "clntpu_route_queue_queries",
    "Route queries currently queued awaiting a flush")
# observed by the getroute RPC command, which the port does not have yet:
# declared so the series is present at zero, never observed
ROUTE_ANSWER_SECONDS = REGISTRY.histogram(
    "clntpu_route_answer_seconds",
    "getroute RPC latency for answered queries (ok or no-route; "
    "TRY_AGAIN rejections excluded)",
    buckets=DURATION_BUCKETS)

# -- routing/mcf_device.py: the supervised min-cost-flow flushes ---------
MCF_FLUSH_SECONDS = REGISTRY.histogram(
    "clntpu_mcf_flush_seconds",
    "End-to-end wall time of one mcf flush (lane prep + batched solve + "
    "flow decomposition, device and host paths together)",
    buckets=DURATION_BUCKETS)
MCF_BATCH_QUERIES = REGISTRY.histogram(
    "clntpu_mcf_batch_queries",
    "getroutes/xpay queries coalesced per mcf flush", buckets=SIZE_BUCKETS)
MCF_OCCUPANCY = REGISTRY.histogram(
    "clntpu_mcf_batch_occupancy_ratio",
    "Real mcf queries / padded device lanes per dispatch",
    buckets=RATIO_BUCKETS)
MCF_QUERIES = REGISTRY.counter(
    "clntpu_mcf_queries_total",
    "Min-cost-flow queries solved, by execution path and outcome",
    labelnames=("path", "outcome"))
MCF_FALLBACK = REGISTRY.counter(
    "clntpu_mcf_fallback_total",
    "Queries diverted from the device mcf solver to the host oracle, "
    "by reason",
    labelnames=("reason",))
MCF_QUEUE = REGISTRY.gauge(
    "clntpu_mcf_queue_queries",
    "Min-cost-flow queries currently queued awaiting a flush")
MCF_PARTS = REGISTRY.histogram(
    "clntpu_mcf_parts_per_query",
    "Route parts per successfully solved mcf query (MPP split width)",
    buckets=SIZE_BUCKETS)

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

# -- obs/attribution.py: the retrace detector and device memory ----------
RETRACE = REGISTRY.counter(
    "clntpu_retrace_total",
    "Program-shape compile first-sights AFTER warmup() completed — "
    "every increment is an anomaly (a live dispatch paid a compile the "
    "warmup contract promises it never does), by program",
    labelnames=("program",))
DEVICE_MEMORY = REGISTRY.gauge(
    "clntpu_device_memory_bytes",
    "Live device-memory statistics where the backend exposes "
    "memory_stats() (TPU does; CPU reports nothing), by device and stat",
    labelnames=("device", "stat"))

# -- obs/health.py: the health engine -------------------------------------
HEALTH_STATE = REGISTRY.gauge(
    "clntpu_health_state",
    "Rolled-up daemon health from the continuous SLO evaluator "
    "(0 = healthy, 1 = degraded, 2 = unhealthy)")
SLO_BREACH = REGISTRY.counter(
    "clntpu_slo_breach_total",
    "SLO breach ENTRIES recorded by the health engine (one increment "
    "per transition into breach, not per breached tick), by SLO name",
    labelnames=("slo",))

# -- obs/incident.py: the incident recorder -------------------------------
INCIDENTS = REGISTRY.counter(
    "clntpu_incidents_total",
    "Incident bundles frozen to disk by the black-box recorder, by the "
    "trigger class that names the bundle (escalations re-count under "
    "the new class)",
    labelnames=("trigger",))
INCIDENT_TRIGGERS = REGISTRY.counter(
    "clntpu_incident_triggers_total",
    "Incident triggers observed, by class and what the episode "
    "debouncer did with them (capture = opened a bundle, escalate = "
    "re-froze the open bundle under a higher-severity class, absorb = "
    "suppressed inside the cooldown window)",
    labelnames=("trigger", "action"))
INCIDENT_BYTES = REGISTRY.gauge(
    "clntpu_incident_store_bytes",
    "Total bytes of incident bundles on disk (bounded by "
    "LIGHTNING_TPU_INCIDENT_MAX_BYTES with oldest-first rotation)")

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

# -- obs/journey.py: per-item journeys -----------------------------------
JOURNEY_SAMPLED = REGISTRY.counter(
    "clntpu_journey_sampled_total",
    "Entities admitted to the journey table by the deterministic "
    "sampler (one per entity, not per hop), by entity kind",
    labelnames=("kind",))
JOURNEY_TABLE = REGISTRY.gauge(
    "clntpu_journey_table_size",
    "Journeys currently held in the bounded per-entity table "
    "(LRU-rotated at LIGHTNING_TPU_JOURNEY_MAX)")
JOURNEY_HOP_WAIT = REGISTRY.histogram(
    "clntpu_journey_hop_wait_seconds",
    "Per-ITEM queue-induced wait at each journey hop (time the item "
    "sat queued before its batch dispatched — the batching tax, split "
    "from service time per doc/journeys.md)",
    labelnames=("hop",), buckets=DURATION_BUCKETS)
JOURNEY_HOP_SERVICE = REGISTRY.histogram(
    "clntpu_journey_hop_service_seconds",
    "Per-ITEM service time at each journey hop (the batch execution "
    "the item shared, split from queue wait per doc/journeys.md)",
    labelnames=("hop",), buckets=DURATION_BUCKETS)
JOURNEY_BATCH_WAIT = REGISTRY.counter(
    "clntpu_journey_batch_wait_seconds_total",
    "Batch-side queue-wait accounting by pipeline stage: "
    "Σ(flush_start − enqueue) over EVERY item of every batch, sampled "
    "or not — the reconciliation target the summed per-item journey "
    "waits must match within ε when sampling is 1",
    labelnames=("stage",))
