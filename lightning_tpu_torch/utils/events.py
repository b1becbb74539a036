"""Tiny synchronous notification bus (the port's own copy).

In-process subscribers to named topics, after Core Lightning's
notification topics (lightningd/notification.c).  Emission never raises:
a broken subscriber must not break the emitter.
"""
from __future__ import annotations

import logging

log = logging.getLogger("lightning_tpu_torch.events")

_subscribers: dict[str, list] = {}
_wildcard: list = []


def subscribe(topic: str, fn) -> None:
    _subscribers.setdefault(topic, []).append(fn)


def subscribe_all(fn) -> None:
    """fn(topic, payload) for every emission."""
    _wildcard.append(fn)


def unsubscribe_all(fn) -> None:
    if fn in _wildcard:
        _wildcard.remove(fn)


def unsubscribe(topic: str, fn) -> None:
    lst = _subscribers.get(topic, [])
    if fn in lst:
        lst.remove(fn)


def emit(topic: str, payload: dict) -> None:
    for fn in list(_subscribers.get(topic, [])):
        try:
            fn(payload)
        except Exception:
            log.exception("subscriber for %s failed", topic)
    for fn in list(_wildcard):
        try:
            fn(topic, payload)
        except Exception:
            log.exception("wildcard subscriber failed on %s", topic)


def reset() -> None:
    """Test isolation helper."""
    _subscribers.clear()
    _wildcard.clear()
