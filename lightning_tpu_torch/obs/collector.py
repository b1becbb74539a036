"""Collector: unifies the three pre-existing telemetry silos into the
metrics registry so one scrape answers for all of them.

  * trace spans (utils/trace.py) — every completed span feeds
    ``clntpu_span_duration_seconds{name=...}`` via a trace tap, so span
    timing aggregates survive the span ring's pruning;
  * events bus (utils/events.py)  — every topic emission bumps
    ``clntpu_events_total{topic=...}``;
  * logring (utils/logring.py)   — per-level emit counts plus the
    skip/drop counters are published as gauges at collect time (the
    ring already tracks them; no hot-path hook needed).

Installation is idempotent and survives ``events.reset()`` (tests call
it for isolation): every ``ensure_installed()`` re-checks that the taps
are still attached.
"""
from __future__ import annotations

from . import registry as R


class Collector:
    def __init__(self, reg: R.Registry):
        self.reg = reg
        self._ring = None
        self._span_hist = reg.histogram(
            "clntpu_span_duration_seconds",
            "Duration of completed trace spans, by span name",
            labelnames=("name",), buckets=R.DURATION_BUCKETS)
        self._span_errs = reg.counter(
            "clntpu_span_errors_total",
            "Trace spans that exited with an exception, by span name",
            labelnames=("name",))
        self._events = reg.counter(
            "clntpu_events_total",
            "Events-bus emissions, by topic",
            labelnames=("topic",))
        self._log_entries = reg.gauge(
            "clntpu_log_entries",
            "Entries currently held in the log ring, by level",
            labelnames=("level",))
        self._log_emitted = reg.counter(
            "clntpu_log_emitted_total",
            "Log records accepted into the ring, by level",
            labelnames=("level",))
        self._log_skipped = reg.gauge(
            "clntpu_log_skipped",
            "Log records dropped below the subsystem threshold")

    # -- taps -------------------------------------------------------------

    def _on_span(self, rec: dict) -> None:
        name = rec.get("name", "?")
        self._span_hist.labels(name).observe(
            rec.get("duration_ns", 0) / 1e9)
        if "error" in rec:
            self._span_errs.labels(name).inc()

    def _on_event(self, topic: str, payload: dict) -> None:
        self._events.labels(topic).inc()

    def _on_collect(self) -> None:
        ring = self._ring
        if ring is None:
            return
        from ..utils import logring as LR

        by_level: dict[str, int] = {}
        for e in list(ring.entries):
            lv = LR.level_name(e.levelno)
            by_level[lv] = by_level.get(lv, 0) + 1
        # set EVERY known level, not just the ones present: the bounded
        # ring rotates entries out, and a gauge left at its old value
        # would report a phantom BROKEN entry forever
        for lv in ("IO", "DEBUG", "INFO", "UNUSUAL", "BROKEN"):
            self._log_entries.labels(lv).set(by_level.get(lv, 0))
        self._log_skipped.set(ring.n_skipped)
        # copy: logging threads insert new levels concurrently, and a
        # mid-iteration resize would abort this scrape's log metrics
        for lv, n in dict(getattr(ring, "n_emitted", {})).items():
            c = self._log_emitted.labels(lv)
            delta = n - c.sample()
            if delta > 0:
                c.inc(delta)

    # -- lifecycle --------------------------------------------------------

    def install(self, ring=None) -> None:
        from ..utils import events, trace

        if self._on_span not in getattr(trace, "_taps", ()):
            trace.add_tap(self._on_span)
        if self._on_event not in events._wildcard:
            events.subscribe_all(self._on_event)
        if ring is not None:
            self._ring = ring
        self.reg.on_collect(self._on_collect)

    def uninstall(self) -> None:
        from ..utils import events, trace

        trace.remove_tap(self._on_span)
        events.unsubscribe_all(self._on_event)
        self._ring = None
