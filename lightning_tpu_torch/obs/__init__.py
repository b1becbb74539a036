"""Unified observability: metrics registry + silo collector.

One process-wide default registry; hot-path modules create their
instruments at import time and mutate them lock-cheaply:

    from lightning_tpu_torch import obs
    _FLUSHES = obs.counter("clntpu_gossip_flushes_total", "...")
    _FLUSHES.inc()

``snapshot()`` is the JSON view and ``render_prometheus()`` the
Prometheus text exposition of the same registry.

``ensure_installed()`` attaches the trace/events/logring collector; it
is idempotent and safe to call from every exposition path (tests call
``events.reset()``, which would otherwise silently detach the events
tap).
"""
from __future__ import annotations

from .collector import Collector
from .registry import (DURATION_BUCKETS, OVERFLOW_LABEL, RATIO_BUCKETS,
                       SIZE_BUCKETS, Registry, log2_buckets)

REGISTRY = Registry()
_collector = Collector(REGISTRY)


def counter(name: str, help: str = "", labelnames=(), **kw):
    return REGISTRY.counter(name, help, labelnames, **kw)


def gauge(name: str, help: str = "", labelnames=(), **kw):
    return REGISTRY.gauge(name, help, labelnames, **kw)


def histogram(name: str, help: str = "", labelnames=(),
              buckets=DURATION_BUCKETS, **kw):
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets, **kw)


def ensure_installed(ring=None) -> None:
    """Attach (or re-attach) the span/events/logring collector."""
    _collector.install(ring=ring)


def snapshot() -> dict:
    ensure_installed()
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    ensure_installed()
    return REGISTRY.render_prometheus()


def reset_for_tests() -> None:
    """Drop every family and re-create the collector's own metrics.
    Instruments held by other modules at import time keep working but
    become invisible until re-registered — tests that assert on them
    should read snapshot deltas or use fresh registries instead."""
    global _collector
    _collector.uninstall()
    REGISTRY.reset()
    _collector = Collector(REGISTRY)
