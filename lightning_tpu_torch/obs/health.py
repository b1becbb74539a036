"""Health engine: time-series telemetry rings and continuous SLO
evaluation over the live metrics registry.

* **Sampler.**  ``tick()`` snapshots the metrics registry and the
  flight, overload and breaker state; ``start()`` runs it every
  ``interval_s`` on a daemon thread, and a harness drives it by hand
  with an injected clock (``now=``).  The registry walk happens ONLY
  inside the tick (hot paths never pay for it), and the tick also
  refreshes ``clntpu_device_memory_bytes``.

* **Time-series rings.**  Every registry series folds into a bounded
  ring of ``ring`` points: counter deltas become rates (over the ACTUAL
  time between ticks), gauges keep their last value, and log2-bucket
  histograms become per-window estimated p50/p99 (log-interpolated
  inside the containing bucket) plus an observation rate.

* **SLO engine.**  Declarative ``SloSpec``s (route p99, ingest accept
  floor, shed ratio, breaker open-time, deadline exceedances, retrace
  count) are evaluated every tick against short and long windows into
  per-SLO ok/warn/breach with error-budget burn rates
  (violated fraction / (1 - objective)).  ``DEFAULT_SLO`` seeds the
  thresholds.

* **State machine.**  Per-SLO statuses roll up into
  healthy -> degraded -> unhealthy with hysteresis: escalation is
  immediate, de-escalation takes ``recover_ticks`` consecutive clean
  ticks.  Transitions emit the ``health_state`` events topic and set
  ``clntpu_health_state``; each transition INTO breach counts
  ``clntpu_slo_breach_total{slo}`` and emits ``slo_breach``.

The JAX package reads its defaults from ``LIGHTNING_TPU_HEALTH_*``
environment variables; here they are the module constants
``INTERVAL_S``, ``RING``, ``SHORT_TICKS``, ``LONG_TICKS`` and
``RECOVER_TICKS``, and the constructor's arguments.  Imports nothing
heavy: device memory comes from attribution.sample_device_memory(),
which never initialises the card.
"""
from __future__ import annotations

import logging
import math
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field

from ..utils import events
from . import REGISTRY
from . import attribution as _attribution
from . import families as _f
from . import flight as _flight

log = logging.getLogger("lightning_tpu_torch.obs.health")

# -- the SLO table the stock specs are seeded from ---------------------------
DEFAULT_SLO = {
    # p99 latency of ANSWERED getroute RPCs (ok or noroute; TRY_AGAIN
    # retries excluded: they are the mechanism that protects this)
    "route_p99_s": 2.0,
    # verified-signature throughput floor while gossip is flowing
    "min_accept_sigs_per_s": 20.0,
    # at least this many getroute answers must land during the storm
    # (a harness-level liveness floor — not evaluable as a live
    # windowed SLO, so the health engine does not carry it)
    "min_route_answers": 20,
}

# -- rolled-up states (clntpu_health_state; ladder-style hysteresis) -------
HEALTHY, DEGRADED, UNHEALTHY = 0, 1, 2
STATE_NAMES = ("healthy", "degraded", "unhealthy")

# per-SLO statuses
OK, WARN, BREACH = "ok", "warn", "breach"

# headline window rates served in every report: display name -> family
# (a histogram family contributes its sum), curated so a report stays
# small
HEADLINE_RATES = {
    "gossip_accepted_per_s": "clntpu_gossip_accepted_total",
    "verify_sigs_per_s": "clntpu_gossip_flush_sigs",
    "route_queries_per_s": "clntpu_route_queries_total",
    "rpc_requests_per_s": "clntpu_rpc_requests_total",
    "sheds_per_s": "clntpu_shed_total",
    "dispatches_per_s": "clntpu_dispatches_total",
}


# the engine's defaults: seconds between ticks, points a ring holds, the
# short and long windows in ticks, and the clean ticks a recovery takes
INTERVAL_S = 5.0
RING = 240
SHORT_TICKS = 6
LONG_TICKS = 60
RECOVER_TICKS = 3


# ---------------------------------------------------------------------------
# log2-histogram quantile estimation


def estimate_quantile(bounds, bucket_counts, overflow: float,
                      q: float) -> float | None:
    """Estimate the q-quantile of a windowed histogram given its
    per-bucket (NON-cumulative) counts aligned to ``bounds`` plus the
    +Inf ``overflow`` count.

    The estimate is the smallest value v with P(X <= v) >= q,
    log-interpolated inside the containing bucket (the registry's
    ladders are powers of two, so log interpolation is the natural
    within-bucket model: ``lo * (hi/lo)**frac``).  The first bucket
    extends the ladder downward (lo = bound/2); observations in the
    overflow bucket clamp to the top finite bound (Prometheus
    histogram_quantile semantics).  Returns None for an empty window.
    """
    total = sum(bucket_counts) + overflow
    if total <= 0:
        return None
    q = min(1.0, max(0.0, q))
    rank = max(1.0, math.ceil(q * total))
    cum = 0.0
    for i, n in enumerate(bucket_counts):
        if n <= 0:
            continue
        if cum + n >= rank:
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else bounds[0] / 2.0
            frac = (rank - cum) / n
            return lo * (hi / lo) ** frac
        cum += n
    return float(bounds[-1])


def window_buckets(prev: dict, cur: dict) -> tuple[list, float]:
    """Per-bucket non-cumulative counts between two registry histogram
    samples (each ``{"buckets": [(bound, cum), ...], "count": N}``),
    plus the +Inf overflow delta."""
    pb = {b: c for b, c in prev.get("buckets", ())}
    counts, last = [], 0.0
    for bound, cum in cur.get("buckets", ()):
        cum_d = cum - pb.get(bound, 0.0)
        counts.append(cum_d - last)
        last = cum_d
    overflow = (cur.get("count", 0) - prev.get("count", 0)) - last
    return counts, max(0.0, overflow)


# ---------------------------------------------------------------------------
# SLO specs


@dataclass
class SloSpec:
    """One declarative SLO evaluated every sampler tick.

    kind:
      quantile_max  estimated q-quantile of `family` over the window
                    must stay <= `max`
      rate_min      rate of `family` (counter value, or histogram sum)
                    must stay >= `min` — but ONLY while any `active`
                    family saw traffic in the window (an idle daemon
                    is not in breach of a throughput floor)
      ratio_max     rate(`num`) / (rate(`num`) + sum(rate(d) for den))
                    must stay <= `max` (the shed-ratio shape)
      saturated     no sample of gauge `family` may sit at/above
                    `level` (the overload ladder's SATURATED)
      breaker_open  no circuit breaker may stay continuously open
                    longer than `max_open_s`
      increase_max  `family` may grow by at most `max` over the window
                    (0 = any increase is a breach: retraces, deadline
                    exceedances)

    `window` picks the evaluation span: "short" reacts fast (the
    degradation signals), "long" approximates a whole-run verdict (the
    customer-facing SLOs).  `severity`
    feeds the roll-up: only a "major" breach whose long burn rate
    exhausted the budget escalates to unhealthy.
    """

    name: str
    kind: str
    params: dict = field(default_factory=dict)
    window: str = "short"              # "short" | "long"
    severity: str = "minor"            # "minor" | "major"
    objective: float = 0.9             # good-tick target; budget = 1 - obj
    description: str = ""


def default_slo_specs(slo: dict | None = None) -> list[SloSpec]:
    """The stock SLO set, thresholds seeded from DEFAULT_SLO updated
    by ``slo`` (keys of DEFAULT_SLO only)."""
    t = dict(DEFAULT_SLO)
    if slo:
        t.update({k: v for k, v in slo.items() if k in DEFAULT_SLO})
    return [
        SloSpec(
            "route_p99", "quantile_max",
            # answered queries ONLY (clntpu_route_answer_seconds omits
            # TRY_AGAIN rejections): the population a load harness's
            # post-hoc p99 judges — fast 429s must not dilute the tail
            {"family": "clntpu_route_answer_seconds", "q": 0.99,
             "max": float(t["route_p99_s"])},
            window="long", severity="major",
            description="p99 of answered getroute RPCs"),
        SloSpec(
            "ingest_accept", "rate_min",
            {"family": "clntpu_gossip_flush_sigs",
             "min": float(t["min_accept_sigs_per_s"]),
             "active": ["clntpu_gossip_accepted_total",
                        "clntpu_gossip_dropped_total",
                        "clntpu_gossip_flush_sigs"]},
            severity="major",
            description="verified-signature throughput floor while "
                        "gossip is flowing (short window: reacts to a "
                        "stalled pipeline, goes inactive when idle)"),
        SloSpec(
            "shed_ratio", "ratio_max",
            {"num": "clntpu_shed_total",
             "den": ["clntpu_gossip_accepted_total",
                     "clntpu_route_queries_total"],
             "max": 0.01},
            description="load shed vs. work admitted"),
        SloSpec(
            "overload_saturated", "saturated",
            {"family": "clntpu_overload_state", "level": 2.0},
            description="a dispatch family's backlog is past its high "
                        "watermark"),
        SloSpec(
            "breaker_open", "breaker_open", {"max_open_s": 5.0},
            severity="major",
            description="a circuit breaker stayed open (host-fallback "
                        "mode) beyond the grace period"),
        SloSpec(
            "deadline_rate", "increase_max",
            {"family": "clntpu_deadline_exceeded_total", "max": 0.0},
            severity="major",
            description="dispatch deadlines blown in the window"),
        SloSpec(
            "retrace", "increase_max",
            {"family": "clntpu_retrace_total", "max": 0.0},
            severity="major",
            description="post-warmup compile on the live path"),
    ]


# ---------------------------------------------------------------------------
# the engine


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return name + "{" + inner + "}"


def _labels_match(labels: dict, want: dict | None) -> bool:
    if not want:
        return True
    return all(labels.get(k) == v for k, v in want.items())


class HealthEngine:
    """Periodic sampler + SLO evaluator + health state machine.

    Construct one per process (``ensure_engine()`` / ``install()``
    manage the process's singleton), ``start()`` the
    daemon thread, ``stop()`` on shutdown.  ``tick()`` is public so
    tests and harnesses drive the engine deterministically with an
    injected clock.
    """

    def __init__(self, interval_s: float | None = None,
                 ring: int | None = None,
                 slos: list[SloSpec] | None = None,
                 short_ticks: int | None = None,
                 long_ticks: int | None = None,
                 recover_ticks: int | None = None,
                 registry=None, now=time.monotonic):
        self.interval_s = max(0.05, float(
            interval_s if interval_s is not None else INTERVAL_S))
        self.ring = max(8, ring if ring is not None else RING)
        self.short_ticks = max(1, short_ticks if short_ticks is not None
                               else SHORT_TICKS)
        self.long_ticks = max(
            self.short_ticks,
            long_ticks if long_ticks is not None else LONG_TICKS)
        self.recover_ticks = max(
            1, recover_ticks if recover_ticks is not None
            else RECOVER_TICKS)
        self.slos = list(slos) if slos is not None else default_slo_specs()
        self._registry = registry if registry is not None else REGISTRY
        self._now = now
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._thread: threading.Thread | None = None
        # series key -> {"kind", "raw": deque[(ts, raw)], "points": deque}
        self._series: dict[str, dict] = {}
        # SLO name -> evaluation state
        self._slo_state: dict[str, dict] = {
            s.name: {"violated": deque(maxlen=self.long_ticks),
                     "observed": deque(maxlen=self.ring),
                     "status": OK, "was_violated": False,
                     "breaches_total": 0, "burn_short": 0.0,
                     "burn_long": 0.0, "value": None}
            for s in self.slos}
        self._ticks = 0
        self._last_mono: float | None = None
        self._last_wall: float | None = None
        self._state = HEALTHY
        self._state_since = time.time()
        self._recover_run = 0
        self._transitions = 0
        # breaker family -> monotonic ts it was first seen open
        self._open_since: dict[str, float] = {}
        self._breaker_view: dict[str, dict] = {}
        self._overload_view: dict[str, str] = {}
        self._flight_view: dict[str, dict] = {}
        _f.HEALTH_STATE.set(float(HEALTHY))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._run, name="health-sampler", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_ev.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # a broken evaluator must never kill the sampler; the
                # next tick retries with fresh state
                log.exception("health tick failed")

    # -- sampling ----------------------------------------------------------

    def tick(self) -> None:
        """One sample + evaluate cycle (the ONLY place the registry is
        walked)."""
        # refresh the device-memory gauge first so this tick's snapshot
        # carries it (continuous sampling — previously getperf-only)
        try:
            _attribution.sample_device_memory()
        except Exception:
            pass
        snap = self._registry.snapshot()["metrics"]
        # tap the breaker/overload/flight subsystems BEFORE taking the
        # engine lock — each tap takes its subsystem's own lock
        taps = self._collect_taps()
        now = self._now()
        eval_errors = ()
        breach_entries = ()
        with self._lock:
            self._ticks += 1
            elapsed = (now - self._last_mono
                       if self._last_mono is not None else None)
            self._last_mono = now
            self._last_wall = time.time()
            self._fold(snap, now, elapsed)
            self._sample_taps(now, taps)
            transition = None
            if elapsed is not None:
                eval_errors, breach_entries = self._evaluate(now)
                transition = self._roll_up()
        # the events bus runs arbitrary subscriber callbacks
        # synchronously — emitting OUTSIDE the lock keeps a subscriber
        # that calls back into report()/state_name() (or is just slow)
        # from deadlocking the sampler and every report() caller;
        # same for logging, whose handlers are pluggable
        for name, tb in eval_errors:
            log.error("SLO %s evaluation failed:\n%s", name, tb)
        for entry in breach_entries:
            # one emission per transition INTO breach (the same edge
            # clntpu_slo_breach_total meters): the incident recorder's
            # slo_breach trigger
            events.emit("slo_breach", entry)
        if transition is not None:
            state, breached = transition
            log.log(logging.WARNING if state != HEALTHY else logging.INFO,
                    "health state -> %s (breached: %s)",
                    STATE_NAMES[state], ",".join(breached) or "none")
            events.emit("health_state",
                        {"state": STATE_NAMES[state],
                         "breached": breached,
                         "ts": round(self._state_since, 3)})

    def _fold(self, snap: dict, now: float, elapsed: float | None) -> None:
        for name, fam in snap.items():
            kind = fam.get("kind")
            for s in fam.get("samples", ()):
                labels = s.get("labels", {})
                key = _series_key(name, labels)
                ser = self._series.get(key)
                if ser is None:
                    ser = self._series[key] = {
                        "kind": kind, "family": name, "labels": labels,
                        "raw": deque(maxlen=self.long_ticks + 1),
                        "points": deque(maxlen=self.ring),
                    }
                    # a monotone series born mid-run (a labeled child's
                    # first increment creates it) baselines at zero one
                    # tick back — otherwise the very event that created
                    # it escapes every window (the first deadline
                    # exceedance / retrace would never breach)
                    if elapsed is not None and kind == "counter":
                        ser["raw"].append((now - elapsed, 0.0))
                    elif elapsed is not None and kind == "histogram":
                        ser["raw"].append((now - elapsed, {
                            "buckets": [(b, 0.0) for b, _
                                        in s.get("buckets", ())],
                            "sum": 0.0, "count": 0}))
                if kind == "histogram":
                    raw = {"buckets": [(b, c) for b, c
                                       in s.get("buckets", ())],
                           "sum": s.get("sum", 0.0),
                           "count": s.get("count", 0)}
                    point = None
                    if ser["raw"] and elapsed:
                        prev_ts, prev = ser["raw"][-1]
                        span = max(now - prev_ts, 1e-9)
                        counts, over = window_buckets(prev, raw)
                        bounds = [b for b, _ in raw["buckets"]]
                        point = (
                            round((raw["count"] - prev["count"])
                                  / span, 6),
                            estimate_quantile(bounds, counts, over, 0.5),
                            estimate_quantile(bounds, counts, over, 0.99),
                        )
                    ser["raw"].append((now, raw))
                    ser["points"].append(point)
                elif kind == "counter":
                    v = float(s.get("value", 0.0))
                    point = None
                    if ser["raw"] and elapsed:
                        prev_ts, prev = ser["raw"][-1]
                        span = max(now - prev_ts, 1e-9)
                        # a reset registry (tests) must not produce a
                        # negative rate
                        point = round(max(0.0, v - prev) / span, 6)
                    ser["raw"].append((now, v))
                    ser["points"].append(point)
                else:  # gauge: last value IS the point
                    v = float(s.get("value", 0.0))
                    ser["raw"].append((now, v))
                    ser["points"].append(v)

    def _collect_taps(self):
        """Breaker / overload / flight state, gathered OUTSIDE the
        engine lock: every call here takes the
        tapped subsystem's own lock — breaker.get/snapshot, overload
        snapshot, the flight-ring summary — and holding ours across
        theirs builds acquisition edges into code we don't control.
        (Lazy imports, so obs.health never forces the resilience
        package on importers that only want the quantile math.)
        Returns (breakers, overload_view, flight_view) or
        None."""
        try:
            from ..resilience import FAMILIES, breaker as _breaker
            from ..resilience import overload as _overload
        except Exception:
            return None
        breakers = {}
        for fam in FAMILIES:
            brk = _breaker.get(fam)
            breakers[fam] = (brk.state, brk.trips)
        overload_view = {
            f: c.snapshot()["state"]
            for f, c in sorted(getattr(_overload, "_controllers",
                                       {}).items())}
        try:
            summ = _flight.summary()["families"]
            flight_view = {f: {"total": v["total"],
                               "ring": v["ring"]}
                           for f, v in summ.items()}
        except Exception:
            flight_view = {}
        return breakers, overload_view, flight_view

    def _sample_taps(self, now: float, taps) -> None:
        """Fold pre-collected tap state into the engine's views (lock
        held; pure bookkeeping, no calls out)."""
        if taps is None:
            return
        breakers, self._overload_view, self._flight_view = taps
        view = {}
        for fam, (state, trips) in breakers.items():
            if state == "open":
                self._open_since.setdefault(fam, now)
                open_s = now - self._open_since[fam]
            else:
                self._open_since.pop(fam, None)
                open_s = 0.0
            view[fam] = {"state": state, "open_s": round(open_s, 3),
                         "trips": trips}
        self._breaker_view = view

    # -- windowed reads (lock held) ----------------------------------------

    def _window(self, spec_window: str) -> int:
        return (self.short_ticks if spec_window == "short"
                else self.long_ticks)

    def _matching(self, family: str, labels: dict | None):
        for ser in self._series.values():
            if ser["family"] == family and _labels_match(
                    ser["labels"], labels):
                yield ser

    @staticmethod
    def _span(ser: dict, k: int):
        """(prev, cur, seconds) raw endpoints over the last k ticks (or
        the series' whole history when shorter)."""
        raw = ser["raw"]
        if len(raw) < 2:
            return None
        idx = max(0, len(raw) - 1 - k)
        t0, a = raw[idx]
        t1, b = raw[-1]
        if t1 <= t0:
            return None
        return a, b, t1 - t0

    def _rate(self, family: str, k: int,
              labels: dict | None = None) -> float | None:
        """Summed window rate for a counter family (histogram families
        contribute their `sum` — e.g. sigs/s off a batch-size
        histogram).  None when no series has two points yet."""
        total, span, seen = 0.0, 0.0, False
        for ser in self._matching(family, labels):
            got = self._span(ser, k)
            if got is None:
                continue
            a, b, s = got
            if ser["kind"] == "histogram":
                total += max(0.0, b["sum"] - a["sum"])
            else:
                total += max(0.0, b - a)
            span = max(span, s)
            seen = True
        if not seen or span <= 0:
            return None
        return total / span

    def _increase(self, family: str, k: int,
                  labels: dict | None = None) -> float | None:
        total, seen = 0.0, False
        for ser in self._matching(family, labels):
            got = self._span(ser, k)
            if got is None:
                continue
            a, b, _ = got
            if ser["kind"] == "histogram":
                total += max(0.0, b["count"] - a["count"])
            else:
                total += max(0.0, b - a)
            seen = True
        return total if seen else None

    def _quantile(self, family: str, k: int, q: float,
                  labels: dict | None = None) -> float | None:
        """Windowed quantile estimate over the merged bucket deltas of
        every matching histogram series."""
        merged: dict[float, float] = {}
        overflow = 0.0
        bounds: list[float] | None = None
        for ser in self._matching(family, labels):
            if ser["kind"] != "histogram":
                continue
            got = self._span(ser, k)
            if got is None:
                continue
            a, b, _ = got
            counts, over = window_buckets(a, b)
            bs = [bd for bd, _ in b["buckets"]]
            bounds = bounds or bs
            for bd, n in zip(bs, counts):
                merged[bd] = merged.get(bd, 0.0) + n
            overflow += over
        if bounds is None:
            return None
        return estimate_quantile(
            bounds, [merged.get(bd, 0.0) for bd in bounds], overflow, q)

    def _gauge_peak(self, family: str,
                    labels: dict | None = None) -> float | None:
        peak, seen = 0.0, False
        for ser in self._matching(family, labels):
            if not ser["raw"]:
                continue
            peak = max(peak, ser["raw"][-1][1])
            seen = True
        return peak if seen else None

    # -- SLO evaluation (lock held) ----------------------------------------

    def _evaluate_spec(self, spec: SloSpec):
        """-> (violated: bool | None, observed value).  None = no data
        / inactive this window (counts as good for the burn rate)."""
        p = spec.params
        k = self._window(spec.window)
        if spec.kind == "quantile_max":
            est = self._quantile(p["family"], k, p.get("q", 0.99),
                                 p.get("labels"))
            if est is None:
                return None, None
            return est > p["max"], round(est, 6)
        if spec.kind == "rate_min":
            active = False
            for fam in p.get("active", (p["family"],)):
                inc = self._increase(fam, k)
                if inc:
                    active = True
                    break
            if not active:
                return None, None
            rate = self._rate(p["family"], k) or 0.0
            return rate < p["min"], round(rate, 3)
        if spec.kind == "ratio_max":
            num = self._rate(p["num"], k)
            if num is None:
                return None, None
            den = num + sum(self._rate(d, k) or 0.0 for d in p["den"])
            if den <= 0:
                return None, None
            ratio = num / den
            return ratio > p["max"], round(ratio, 6)
        if spec.kind == "saturated":
            peak = self._gauge_peak(p["family"], p.get("labels"))
            if peak is None:
                return None, None
            return peak >= p.get("level", 2.0), peak
        if spec.kind == "breaker_open":
            worst = 0.0
            for st in self._breaker_view.values():
                worst = max(worst, st.get("open_s", 0.0))
            return worst > p.get("max_open_s", 5.0), round(worst, 3)
        if spec.kind == "increase_max":
            inc = self._increase(p["family"], k, p.get("labels"))
            if inc is None:
                return None, None
            return inc > p.get("max", 0.0), inc
        raise ValueError(f"unknown SLO kind {spec.kind!r}")

    def _evaluate(self, now: float) -> tuple[list, list]:
        errors: list = []
        entries: list = []
        for spec in self.slos:
            st = self._slo_state[spec.name]
            try:
                violated, observed = self._evaluate_spec(spec)
            except Exception:
                # runs under the engine lock: collect, let tick() log
                # after release (handlers are pluggable — lock-order)
                errors.append((spec.name, traceback.format_exc()))
                violated, observed = None, None
            st["violated"].append(1 if violated else 0)
            st["observed"].append(observed)
            st["value"] = observed
            budget = max(1e-6, 1.0 - spec.objective)
            ring = st["violated"]
            short = list(ring)[-self.short_ticks:]
            st["burn_short"] = round(
                (sum(short) / len(short)) / budget, 3) if short else 0.0
            st["burn_long"] = round(
                (sum(ring) / len(ring)) / budget, 3) if ring else 0.0
            if violated:
                st["status"] = BREACH
                if not st["was_violated"]:
                    st["breaches_total"] += 1
                    _f.SLO_BREACH.labels(spec.name).inc()
                    entries.append({
                        "slo": spec.name, "kind": spec.kind,
                        "window": spec.window,
                        "severity": spec.severity,
                        "observed": observed,
                        "breaches_total": st["breaches_total"],
                    })
            elif st["burn_short"] > 1.0:
                st["status"] = WARN
            else:
                st["status"] = OK
            st["was_violated"] = bool(violated)
        return errors, entries

    # -- roll-up state machine (lock held) ---------------------------------

    def _breached(self) -> list[str]:
        return [s.name for s in self.slos
                if self._slo_state[s.name]["status"] == BREACH]

    def _roll_up(self) -> tuple[int, list[str]] | None:
        """Advance the state machine; returns the (state, breached)
        transition for the caller to emit OUTSIDE the lock, or None."""
        breached = self._breached()
        target = HEALTHY
        if breached:
            target = DEGRADED
            for spec in self.slos:
                st = self._slo_state[spec.name]
                if (spec.severity == "major" and st["status"] == BREACH
                        and st["burn_long"] > 1.0):
                    target = UNHEALTHY
                    break
        if target >= self._state:
            # escalation (or holding steady) is immediate: the
            # overload ladder's hysteresis shape
            self._recover_run = 0
            if target > self._state:
                return self._set_state(target, breached)
        else:
            self._recover_run += 1
            if self._recover_run >= self.recover_ticks:
                self._recover_run = 0
                return self._set_state(target, breached)
        return None

    def _set_state(self, state: int,
                   breached: list[str]) -> tuple[int, list[str]]:
        self._state = state
        self._state_since = time.time()
        self._transitions += 1
        _f.HEALTH_STATE.set(float(state))
        return (state, breached)

    # -- exposition --------------------------------------------------------

    def state_name(self) -> str:
        with self._lock:
            return STATE_NAMES[self._state] if self._ticks else "unknown"

    def report(self, series=None, points=None) -> dict:
        """The engine's report.
        ``series``: family names whose time-series rings to extract;
        ``points`` caps ring length in the reply."""
        with self._lock:
            slos = {}
            for spec in self.slos:
                st = self._slo_state[spec.name]
                slos[spec.name] = {
                    "status": st["status"],
                    "violated": st["was_violated"],
                    "kind": spec.kind,
                    "window": spec.window,
                    "severity": spec.severity,
                    "objective": spec.objective,
                    "burn_short": st["burn_short"],
                    "burn_long": st["burn_long"],
                    "breaches_total": st["breaches_total"],
                    "observed": st["value"],
                    "threshold": next(
                        (spec.params[k] for k in
                         ("max", "min", "max_open_s", "level")
                         if k in spec.params), None),
                    "description": spec.description,
                    # a bounded tail of the per-tick observed values —
                    # the SLO panel's sparkline source
                    "recent": list(st["observed"])[-16:],
                }
            rates = {}
            for label, fam in HEADLINE_RATES.items():
                r = self._rate(fam, self.short_ticks)
                rates[label] = round(r, 3) if r is not None else None
            out = {
                "running": self.running,
                "state": (STATE_NAMES[self._state] if self._ticks
                          else "unknown"),
                "state_code": self._state,
                "since": round(self._state_since, 3),
                "ticks": self._ticks,
                "transitions": self._transitions,
                "interval_s": self.interval_s,
                "ring_points": self.ring,
                "short_ticks": self.short_ticks,
                "long_ticks": self.long_ticks,
                "recover_ticks": self.recover_ticks,
                "last_tick_at": self._last_wall,
                "breached": self._breached(),
                "slos": slos,
                "rates": rates,
                "breakers": dict(self._breaker_view),
                "overload": dict(self._overload_view),
                "flight": dict(self._flight_view),
            }
            if series:
                want = set(series)
                rings: dict[str, dict] = {}
                for key, ser in self._series.items():
                    if ser["family"] not in want:
                        continue
                    pts = list(ser["points"])
                    if points is not None and points > 0:
                        pts = pts[-points:]
                    rings[key] = {"kind": ser["kind"], "points": pts}
                out["rings"] = rings
            return out


def compact(report: dict) -> dict:
    """The bounded view of a report: state, breached SLOs, per-SLO
    status and the headline window rates."""
    return {
        "state": report.get("state"),
        "breached": report.get("breached", []),
        "slos": {n: s.get("status")
                 for n, s in report.get("slos", {}).items()},
        "rates": report.get("rates", {}),
    }


def empty_report() -> dict:
    """The report when no engine was ever installed."""
    return {"running": False, "state": "unknown", "state_code": -1,
            "ticks": 0, "breached": [], "slos": {}, "rates": {}}


# ---------------------------------------------------------------------------
# process singleton

_engine: HealthEngine | None = None
_engine_lock = threading.Lock()


def current() -> HealthEngine | None:
    return _engine


def install(engine: HealthEngine | None) -> HealthEngine | None:
    """Make `engine` the process's health engine (harnesses install
    their own fast-tick engine; None uninstalls)."""
    global _engine
    with _engine_lock:
        _engine = engine
    return engine


def ensure_engine(**kw) -> HealthEngine:
    """The process's engine, made on first use (with the module
    constants where ``kw`` names no value)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = HealthEngine(**kw)
        return _engine


def reset_for_tests() -> None:
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.stop(timeout=1.0)
        _engine = None
