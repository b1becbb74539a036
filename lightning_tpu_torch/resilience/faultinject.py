"""Deterministic fault injection at the seams of the batched dispatches.

Named seams inside the dispatch pipelines call ``fire(seam, family)``;
a spec armed with ``arm()`` makes that call raise or hang on a
deterministic schedule, so the supervision (breakers, quarantine,
deadlines) is exercised end to end on real workloads.  Faults are armed
only through ``arm()``: nothing is read from the environment.

Spec grammar (comma-separated specs):

    seam:family:action:rate[:arg]

* ``seam``   — where: ``prep``, ``dispatch``, ``readback``, ``mesh``,
               ``sign``, ``producer``, ``append`` (store append),
               ``commit`` (db commit) (or ``*``).
* ``family`` — which dispatch family: ``verify``, ``route``, ``sign``,
               ``mesh``, ``ingest``, ``store``, ``db`` (or ``*``).
* ``action`` — ``raise`` (throw ``FaultInjected``), ``hang``
               (sleep ``arg`` seconds, default 0.05, then continue),
               or ``crash`` (flush output, then ``os._exit(arg)``,
               default exit code 137, the kill -9 convention).
* ``rate``   — fraction of matching calls that fire, in (0, 1];
               default 1.  Firing is DETERMINISTIC: each spec's call
               count walks a Bresenham schedule (fire iff
               floor(n * rate) > floor((n - 1) * rate)), so a spec fires
               on the same calls in every run.

Examples::

    arm("dispatch:verify:raise:0.1")
    arm("sign:sign:raise:0.5,mesh:mesh:raise:1")
    arm("producer:verify:hang:1:30")     # 30 s hang, every call
    arm("append:store:crash:1")          # die mid-append

Disarmed, ``fire()`` is one list test: cheap enough for every bucket.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import sys
import threading
import time
from dataclasses import dataclass, field

from ..obs import families as _f
from ..obs import flight as _flight
from ..utils import events

log = logging.getLogger("lightning_tpu_torch.resilience.faultinject")

SEAMS = ("prep", "dispatch", "readback", "mesh", "sign", "producer",
         "append", "commit")
ACTIONS = ("raise", "hang", "crash")


class FaultInjected(RuntimeError):
    """The injected failure: a RuntimeError subclass, so it walks the
    handler paths a real CUDA error would."""


@dataclass
class _Spec:
    seam: str
    family: str
    action: str
    rate: float
    arg: float
    raw: str
    calls: int = 0
    fired: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def should_fire(self) -> bool:
        with self._lock:
            self.calls += 1
            n = self.calls
            hit = math.floor(n * self.rate) > math.floor((n - 1) * self.rate)
            if hit:
                self.fired += 1
            return hit


def parse(spec_str: str) -> list[_Spec]:
    """Parse a spec string; raises ValueError on bad grammar."""
    out = []
    for part in spec_str.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 3 or len(fields) > 5:
            raise ValueError(
                f"fault spec {part!r}: want seam:family:action:rate[:arg]")
        seam, family, action = fields[0], fields[1], fields[2]
        if action not in ACTIONS:
            raise ValueError(
                f"fault spec {part!r}: action must be one of {ACTIONS}")
        rate = float(fields[3]) if len(fields) > 3 and fields[3] else 1.0
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"fault spec {part!r}: rate must be in (0, 1]")
        # arg: hang = sleep seconds; crash = exit code (137 mirrors the
        # shell's kill -9 convention)
        default_arg = 137.0 if action == "crash" else 0.05
        arg = float(fields[4]) if len(fields) > 4 else default_arg
        out.append(_Spec(seam, family, action, rate, arg, part))
    return out


# the armed specs, in arming order
_armed: list[_Spec] = []


def _matching(seam: str, family: str):
    return [s for s in list(_armed)
            if s.seam in ("*", seam) and s.family in ("*", family)]


def fire(seam: str, family: str) -> None:
    """Injection point: a no-op unless an armed spec matches this seam
    and family AND its deterministic schedule says fire."""
    if not _armed:
        return
    for spec in _matching(seam, family):
        if not spec.should_fire():
            continue
        _f.FAULT_INJECTED.labels(seam, family, spec.action).inc()
        # stamp the in-flight dispatch record (if any), so the flight
        # ring shows WHICH dispatch took this injection
        _flight.note_fault(seam, family)
        events.emit("fault_injected",
                    {"seam": seam, "family": family, "spec": spec.raw})
        if spec.action == "hang":
            time.sleep(spec.arg)
        elif spec.action == "crash":
            _crash(seam, family, spec)
        else:
            raise FaultInjected(
                f"injected fault at {seam}:{family} (spec {spec.raw!r})")


def crash_armed(seam: str, family: str) -> bool:
    """True when a crash-action spec matches this seam and family.  Does
    NOT consume any spec's schedule: seams that must stage a partial
    write for the kill to land mid-record (the store append) check this
    before deciding where to place their ``fire()`` call."""
    return any(s.action == "crash" for s in _matching(seam, family))


def _crash(seam: str, family: str, spec: _Spec) -> None:
    """The crash action: flush the output, then ``os._exit``, which
    skips atexit and excepthook on purpose, as a SIGKILL would."""
    log.critical("injected crash at %s:%s (spec %r): os._exit",
                 seam, family, spec.raw)
    try:
        sys.stdout.flush()
        sys.stderr.flush()
        for h in logging.getLogger().handlers:
            h.flush()
    except Exception:
        pass
    os._exit(int(spec.arg))


@contextlib.contextmanager
def arm(spec_str: str):
    """Faults active inside the with block."""
    specs = parse(spec_str)
    _armed.extend(specs)
    try:
        yield specs
    finally:
        for s in specs:
            _armed.remove(s)


def active_specs() -> list[str]:
    return [s.raw for s in _armed]


def reset_for_tests() -> None:
    _armed.clear()
