"""Supervision of the batched dispatches on the card.

Every batched path (the store replay's buckets, the live ingest's
flushes through them, hsmd's batched sign and sig-check) treats the
card as a peer that can fail, hang or be handed a poisoned batch.  This
package is the common machinery:

* ``breaker``      — per-family circuit breakers (closed -> open ->
                     half-open probe with exponential backoff and
                     jitter);
* ``deadline``     — dispatch deadlines and loop restart backoff, so a
                     hung worker surfaces as a counted event instead of a
                     silent stall;
* ``quarantine``   — bisection of a poisoned batch: isolate the
                     offending rows, complete the rest on the card;
* ``overload``     — watermarked backlog control of the flush queues;
* ``faultinject``  — deterministic faults at named seams, armed with
                     ``faultinject.arm("dispatch:verify:raise:0.1")``.

Breakers, armed faults and the flight ring are process-global: reset
them between probes in one process (``reset_for_tests``).
"""
from __future__ import annotations

from . import (breaker, deadline, faultinject,  # noqa: F401
               overload, quarantine)

# the canonical dispatch families (a breaker exists for each even before
# its first dispatch, so a snapshot and a fresh scrape agree on the
# vocabulary)
FAMILIES = ("verify", "route", "sign", "mesh")


def resilience_snapshot() -> dict:
    """Breaker states plus whatever fault specs are armed."""
    return {
        "breakers": {f: breaker.get(f).snapshot() for f in FAMILIES},
        "faults_armed": faultinject.active_specs(),
    }


def reset_for_tests() -> None:
    breaker.reset_for_tests()
    faultinject.reset_for_tests()
    overload.reset_for_tests()
