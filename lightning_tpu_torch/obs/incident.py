"""Incident recorder: automatic incident capture into forensic bundles
on disk.

The registry is point-in-time, the flight rings wrap within seconds of
an incident, and a crash loses all of it.  When a breaker trips or the
process dies with nobody watching, this recorder leaves a durable,
correlated evidence bundle on disk.

**Triggers.**  The recorder subscribes to the events-bus topics the rest
of the port already emits (no hot path gains a call site):

  * ``health_state``        the health engine going degraded/unhealthy;
  * ``slo_breach``          SLO breach ENTRIES (one per transition into
                            breach, obs/health.py);
  * ``breaker_transition``  a circuit breaker OPENING (to="open");
  * ``slow_dispatch``       the flight recorder's watchdog;
  * ``deadline_exceeded``   a dispatch deadline blown;
  * ``quarantine``          rows diverted off a failing dispatch;
  * ``sys.excepthook`` / ``threading.excepthook``: unhandled crashes
    (the bundle is frozen BEFORE the interpreter unwinds);
  * a ``faulthandler`` dump file armed in the bundle directory, so a
    hard crash (a SIGSEGV in an extension) leaves native tracebacks
    next to the bundles.

**Episodes.**  Triggers are debounced per episode: the first trigger
opens an episode and freezes a bundle; for ``cooldown_s`` further
triggers are absorbed into the same episode.  A strictly
higher-severity trigger RE-freezes the bundle under its own name (a
route fault storm blows a deadline, then opens the breaker: the one
bundle is named ``breaker_open``, the deadline in its history), anything
else only counts.  Per-class counts live in the manifest, and at most
one bundle exists per episode.

**Bundles.**  One directory per episode holding the correlated frozen
state as separate JSON artifacts (``ARTIFACTS``): the full metrics
snapshot, every per-family flight ring, the recent trace spans as a
validated Chrome-trace export, the health report with its SLO rings,
the breaker/overload/shed state, the port's knobs (``knobs.json``:
module constants and the arguments of the installed services, engines
and this recorder; nothing is read from the environment) and the
journeys, with a ``manifest.json`` naming the trigger and its
correlation.  Bundles are bounded by count and total bytes
(oldest-first rotation; the open episode's bundle is never rotated
away).

**Hot-path contract.**  Subscriber callbacks only classify the trigger
under the recorder's own lock and enqueue; all capture I/O runs on a
dedicated worker thread, never under any subsystem lock.  Crash hooks
block on the worker draining: the dying interpreter waits for its own
black box to flush.  Imports nothing heavy.
"""
from __future__ import annotations

import faulthandler
import json
import logging
import os
import queue
import re
import shutil
import sys
import threading
import time
import traceback

from ..utils import events, trace as _trace
from . import REGISTRY, ensure_installed
from . import families as _f

log = logging.getLogger("lightning_tpu_torch.obs.incident")

MANIFEST_SCHEMA = 1

# trigger class -> severity (higher wins an episode's name; the ladder
# ranks forensic SPECIFICITY: a crash or an open breaker names a root
# cause, a health roll-up is a symptom of one)
SEVERITY = {
    "slow_dispatch": 20,
    "quarantine": 30,
    "slo_breach": 40,
    "health_degraded": 45,
    "health_unhealthy": 50,
    "deadline": 60,
    "breaker_open": 70,
    "thread_crash": 80,
    "crash": 90,
}
TRIGGER_CLASSES = tuple(sorted(SEVERITY))

# events-bus topic -> trigger class (payload-conditional mappings are
# resolved in _classify)
_TOPIC_CLASSES = {
    "breaker_transition": "breaker_open",
    "health_state": "health_degraded",
    "slo_breach": "slo_breach",
    "slow_dispatch": "slow_dispatch",
    "deadline_exceeded": "deadline",
    "quarantine": "quarantine",
}

# artifact file names inside a bundle directory (manifest.json rides
# beside them); get() validates requested names against this
ARTIFACTS = ("metrics.json", "flight.json", "trace.json", "health.json",
             "resilience.json", "knobs.json", "journeys.json")

_ID_RE = re.compile(r"^inc-[0-9]+-[0-9]+$")
_REDACT_RE = re.compile(r"PASSPHRASE|SECRET|TOKEN|PASSWORD")

# bound the trigger payload stored in the manifest (a slow_dispatch
# payload is a full DispatchRecord — fine; an adversarially huge one
# must not balloon the manifest)
_PAYLOAD_CAP = 32 << 10


# the recorder's defaults: bundles kept, bytes kept, and the seconds an
# episode absorbs further triggers
MAX_BUNDLES = 16
MAX_BYTES = 64 << 20
COOLDOWN_S = 60.0


def _jsonable(obj):
    """Round-trip through json with a lossy fallback so an artifact
    write can never raise on an exotic payload value."""
    return json.loads(json.dumps(obj, default=repr))


def _classify(topic: str, payload: dict) -> str | None:
    """Map a bus emission to a trigger class, or None when the emission
    is not incident-shaped (breaker closing, health recovering)."""
    cls = _TOPIC_CLASSES.get(topic)
    if cls is None:
        return None
    if topic == "breaker_transition":
        return "breaker_open" if payload.get("to") == "open" else None
    if topic == "health_state":
        state = payload.get("state")
        if state == "unhealthy":
            return "health_unhealthy"
        if state == "degraded":
            return "health_degraded"
        return None
    return cls


def _correlation(cls: str, payload: dict) -> dict:
    """The bounded correlation block the manifest carries: whatever
    identity the trigger payload offers (dispatch family, corr ids,
    SLO name, breaker seq) plus the class itself."""
    out: dict = {"class": cls}
    for k in ("family", "slo", "seam", "loop", "dispatch_id",
              "corr_ids", "seq", "state", "reason", "row", "thread",
              "exception"):
        if isinstance(payload, dict) and payload.get(k) is not None:
            out[k] = payload[k]
    return _jsonable(out)


_PKG = __name__.rsplit(".", 2)[0]

# the module constants knobs.json lists, by module (a module not yet
# imported is left out: the recorder imports nothing to report it)
KNOB_CONSTANTS = (
    ("obs.flight", ("RING_SIZE", "SLOW_DISPATCH_S")),
    ("obs.health", ("INTERVAL_S", "RING", "SHORT_TICKS", "LONG_TICKS",
                    "RECOVER_TICKS")),
    ("obs.incident", ("MAX_BUNDLES", "MAX_BYTES", "COOLDOWN_S")),
    ("obs.journey", ("SAMPLE", "MAX_ENTITIES", "HOPS_PER_JOURNEY")),
    ("resilience.breaker", ("THRESHOLD", "BACKOFF_S", "MAX_BACKOFF_S")),
    ("resilience.overload", ("FLUSH_WIDEN", "BACKPRESSURE_MAX_S",
                             "SHED_RING")),
    ("gossip.verify", ("DEFAULT_BUCKET",)),
    ("gossip.ingest", ("INGEST_HIGH_WM", "PENDING_CAP", "RATELIMIT_BURST",
                       "RATELIMIT_INTERVAL")),
    ("routing.device", ("ROUTE_BATCH", "ROUTE_FLUSH_MS",
                        "ROUTE_MAX_AMOUNT_MSAT", "ROUTE_MAX_RISKFACTOR",
                        "ROUTE_HIGH_WM")),
    ("routing.mcf_device", ("MCF_BATCH", "MCF_FLUSH_MS",
                            "MCF_MAX_AMOUNT_MSAT", "MCF_HIGH_WM")),
)


def resolve_knobs(recorder: "IncidentRecorder | None" = None) -> dict:
    """The port's knobs where the JAX package lists its environment
    variables: each imported module's constants (``source`` constant),
    the journey settings, and the arguments of the installed health
    engine, the live routing services, the overload controllers, the
    breakers and ``recorder`` (``source`` argument).  Reads no
    environment variable."""
    knobs: dict[str, dict] = {}

    def put(name: str, value, source: str) -> None:
        knobs[name] = {"value": _jsonable(value), "source": source}

    for mod_name, attrs in KNOB_CONSTANTS:
        mod = sys.modules.get(f"{_PKG}.{mod_name}")
        if mod is None:
            continue
        for attr in attrs:
            put(f"{mod_name}.{attr}", getattr(mod, attr), "constant")
    journey = sys.modules.get(f"{_PKG}.obs.journey")
    if journey is not None:
        for k, v in journey.settings().items():
            put(f"journey.{k}", v, "argument")
    health = sys.modules.get(f"{_PKG}.obs.health")
    eng = health.current() if health is not None else None
    if eng is not None:
        for k in ("interval_s", "ring", "short_ticks", "long_ticks",
                  "recover_ticks"):
            put(f"health.{k}", getattr(eng, k), "argument")
    routing = sys.modules.get(f"{_PKG}.routing.device")
    for svc in (routing.live_services() if routing is not None else ()):
        for k in ("flush_ms", "batch", "deadline_s"):
            put(f"{svc.FAMILY}_service.{k}", getattr(svc, k), "argument")
    overload = sys.modules.get(f"{_PKG}.resilience.overload")
    if overload is not None:
        for fam, ctl in sorted(overload._controllers.items()):
            put(f"overload.{fam}.high_wm", ctl.high_wm, "argument")
            put(f"overload.{fam}.low_wm", ctl.low_wm, "argument")
    breaker = sys.modules.get(f"{_PKG}.resilience.breaker")
    if breaker is not None:
        for fam, brk in sorted(breaker.all_breakers().items()):
            for k in ("threshold", "base_backoff", "max_backoff"):
                put(f"breaker.{fam}.{k}", getattr(brk, k), "argument")
    if recorder is not None:
        for k in ("directory", "max_bundles", "max_bytes", "cooldown_s"):
            put(f"incident.{k}", getattr(recorder, k), "argument")
    return knobs


class IncidentRecorder:
    """The black-box recorder: classify triggers cheaply on the
    emitter's thread, capture bundles on a dedicated worker.

    Construct one per process (``install()`` manages the process's
    singleton), ``start()``/``stop()`` bracket its lifetime.  ``now=``
    injects a clock for deterministic cooldown tests; ``drain()`` blocks
    until queued captures are on disk.
    """

    def __init__(self, directory: str, *,
                 max_bundles: int | None = None,
                 max_bytes: int | None = None,
                 cooldown_s: float | None = None,
                 triggers=None,
                 disabled: bool = False,
                 process_hooks: bool = False,
                 now=time.monotonic):
        self.directory = os.path.abspath(directory)
        self.max_bundles = max(1, max_bundles if max_bundles is not None
                               else MAX_BUNDLES)
        self.max_bytes = max(1 << 12, max_bytes if max_bytes is not None
                             else MAX_BYTES)
        self.cooldown_s = max(0.0, cooldown_s if cooldown_s is not None
                              else COOLDOWN_S)
        self.triggers = frozenset(triggers if triggers is not None
                                  else TRIGGER_CLASSES)
        self.disabled = bool(disabled)
        self.process_hooks = process_hooks
        self._now = now
        self._lock = threading.Lock()
        self._episode: dict | None = None       # guarded-by: self._lock
        self._ep_seq = 0                        # guarded-by: self._lock
        self._queue: queue.Queue = queue.Queue()
        self._cond = threading.Condition()
        self._pending = 0                       # guarded-by: self._cond
        self._thread: threading.Thread | None = None
        self._stop_ev = threading.Event()
        self._subscribed: list = []
        self._prev_sys_hook = None
        self._prev_thread_hook = None
        self._fault_file = None
        self._faulthandler_armed = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Subscribe the trigger surfaces, spawn the capture worker,
        and (with process_hooks) arm the crash hooks + faulthandler."""
        if self.disabled:
            return
        if self._thread is not None and self._thread.is_alive():
            return
        os.makedirs(self.directory, exist_ok=True)
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._run, name="incident-recorder", daemon=True)
        self._thread.start()
        for topic in sorted(set(_TOPIC_CLASSES)):
            fn = self._make_subscriber(topic)
            events.subscribe(topic, fn)
            self._subscribed.append((topic, fn))
        if self.process_hooks:
            self._install_process_hooks()
        log.info("incident recorder armed: dir=%s cooldown=%.1fs "
                 "max_bundles=%d max_bytes=%d triggers=%s",
                 self.directory, self.cooldown_s, self.max_bundles,
                 self.max_bytes, ",".join(sorted(self.triggers)))

    def stop(self, timeout: float = 10.0) -> None:
        """Unsubscribe, flush the worker (pending captures complete),
        finalize the open episode's manifest, restore crash hooks."""
        for topic, fn in self._subscribed:
            events.unsubscribe(topic, fn)
        self._subscribed.clear()
        self._restore_process_hooks()
        t = self._thread
        if t is not None and t.is_alive():
            self.drain(timeout)
            self._stop_ev.set()
            self._queue.put(None)
            t.join(timeout)
        self._thread = None
        # final manifest refresh so absorbed-trigger counts recorded
        # since the last capture are durable
        with self._lock:
            ep = self._episode
            snap = self._manifest_view(ep) if (
                ep is not None and ep.get("captured_at")) else None
        if snap is not None:
            try:
                self._write_json(
                    os.path.join(snap["_dir"], "manifest.json"),
                    {k: v for k, v in snap.items()
                     if not k.startswith("_")})
            except OSError:
                log.exception("incident manifest finalize failed")

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every queued capture has been processed (tests
        and the crash hooks use this); False on timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0,
                                       timeout)

    def note_crash(self, reason: str, extra: dict | None = None,
                   timeout: float = 10.0) -> bool:
        """Synchronously freeze a crash bundle: trigger + drain.

        The excepthook path captures interpreter-unwinding crashes, but
        a deliberate ``os._exit`` (the fault grammar's crash action)
        skips every hook — callers about to hard-exit use this to make
        sure the bundle the next boot will look for is on disk first.
        Returns False when the capture did not flush within timeout."""
        self._trigger("crash", {"reason": reason,
                                "thread": threading.current_thread().name,
                                **(extra or {})})
        return self.drain(timeout)

    # -- trigger intake (emitter threads; must stay cheap) -----------------

    def _make_subscriber(self, topic: str):
        def _on_event(payload: dict, _topic=topic) -> None:
            try:
                cls = _classify(_topic, payload
                                if isinstance(payload, dict) else {})
                if cls is not None:
                    self._trigger(cls, payload)
            except Exception:
                log.exception("incident trigger intake failed (%s)",
                              _topic)
        return _on_event

    def _trigger(self, cls: str, payload) -> None:
        """Classify against the open episode and enqueue capture work.
        Returns after a dict update — capture I/O never runs on the
        emitter's thread."""
        if self.disabled or cls not in self.triggers:
            return
        if not isinstance(payload, dict):
            payload = {"payload": payload}
        sev = SEVERITY.get(cls, 0)
        now = self._now()
        wall = time.time()
        with self._lock:
            ep = self._episode
            if ep is None or (now - ep["opened_mono"]) > self.cooldown_s:
                self._ep_seq += 1
                ep = self._episode = {
                    "id": f"inc-{int(wall * 1000)}-{self._ep_seq}",
                    "seq": self._ep_seq,
                    "opened_mono": now,
                    "opened_at": wall,
                    "severity": sev,
                    "trigger_class": cls,
                    "trigger_payload": payload,
                    "trigger_at": wall,
                    "history": [{"class": cls, "at": round(wall, 3),
                                 "action": "capture"}],
                    "suppressed": {},
                    "captured_at": None,
                    "recaptures": 0,
                    "capture_errors": {},
                    "artifacts": {},
                    "trace_problems": None,
                }
                action = "capture"
            elif sev > ep["severity"]:
                ep["severity"] = sev
                ep["trigger_class"] = cls
                ep["trigger_payload"] = payload
                ep["trigger_at"] = wall
                ep["recaptures"] += 1
                if len(ep["history"]) < 64:
                    ep["history"].append(
                        {"class": cls, "at": round(wall, 3),
                         "action": "escalate"})
                action = "escalate"
            else:
                ep["suppressed"][cls] = ep["suppressed"].get(cls, 0) + 1
                action = "absorb"
        # metering + queueing OUTSIDE the lock: the counter inc walks
        # the registry's family lock and the queue has its own.  The op
        # carries ITS episode so a capture queued just before the
        # cooldown rolled a new episode still freezes the old bundle.
        _f.INCIDENT_TRIGGERS.labels(cls, action).inc()
        if action in ("capture", "escalate"):
            self._enqueue(("capture", ep))
        else:
            # absorbed triggers only touch memory; a debounced manifest
            # refresh keeps the on-disk suppressed counts roughly live
            # without one write per quarantined row
            self._enqueue(("refresh", ep))

    def _enqueue(self, op) -> None:
        with self._cond:
            self._pending += 1
        self._queue.put(op)

    # -- capture worker ----------------------------------------------------

    def _run(self) -> None:
        last_refresh = 0.0
        while True:
            op = self._queue.get()
            try:
                if op is None or self._stop_ev.is_set():
                    if op is None:
                        return
                    continue
                if op[0] == "capture":
                    self._capture(op[1])
                    last_refresh = self._now()
                elif op[0] == "refresh":
                    if self._now() - last_refresh >= 1.0:
                        self._refresh_manifest(op[1])
                        last_refresh = self._now()
            except Exception:
                # the black box must never take the daemon down
                log.exception("incident capture failed")
            finally:
                with self._cond:
                    self._pending = max(0, self._pending - 1)
                    self._cond.notify_all()

    def _manifest_view(self, ep: dict) -> dict:
        """A JSON-ready copy of the episode's manifest state (caller
        holds the lock); keys starting with "_" are worker-internal."""
        payload = _jsonable(ep["trigger_payload"])
        if len(json.dumps(payload)) > _PAYLOAD_CAP:
            payload = {"truncated": True,
                       "repr": repr(ep["trigger_payload"])[:_PAYLOAD_CAP]}
        return {
            "schema": MANIFEST_SCHEMA,
            "id": ep["id"],
            "trigger": {
                "class": ep["trigger_class"],
                "severity": ep["severity"],
                "at": round(ep["trigger_at"], 3),
                "payload": payload,
            },
            "correlation": _correlation(ep["trigger_class"],
                                        ep["trigger_payload"]),
            "episode": {
                "opened_at": round(ep["opened_at"], 3),
                "cooldown_s": self.cooldown_s,
                "seq": ep["seq"],
            },
            "history": list(ep["history"]),
            "suppressed": dict(ep["suppressed"]),
            "captured_at": ep["captured_at"],
            "recaptures": ep["recaptures"],
            "trace_problems": ep["trace_problems"],
            "capture_errors": dict(ep["capture_errors"]),
            "artifacts": dict(ep["artifacts"]),
            "process": {
                "pid": os.getpid(),
                "argv": list(sys.argv),
                "python": sys.version.split()[0],
            },
            "_dir": os.path.join(self.directory, ep["id"]),
        }

    def _capture(self, ep: dict) -> None:
        """Freeze the correlated bundle for `ep` (worker thread only;
        holds NO lock while collecting or writing)."""
        t0 = time.perf_counter()
        with self._lock:
            snap = self._manifest_view(ep)
        bundle_dir = snap["_dir"]
        os.makedirs(bundle_dir, exist_ok=True)
        artifacts: dict[str, dict] = {}
        errors: dict[str, str] = {}
        trace_problems = None
        for name, builder in (
                ("metrics.json", self._art_metrics),
                ("flight.json", self._art_flight),
                ("trace.json", self._art_trace),
                ("health.json", self._art_health),
                ("resilience.json", self._art_resilience),
                ("knobs.json", self._art_knobs),
                ("journeys.json", self._art_journeys)):
            try:
                obj = builder()
                if name == "trace.json":
                    obj, trace_problems = obj
                path = os.path.join(bundle_dir, name)
                self._write_json(path, obj)
                artifacts[name] = {"bytes": os.path.getsize(path)}
            except Exception as e:
                errors[name] = f"{type(e).__name__}: {e}"
        captured_at = round(time.time(), 3)
        capture_ms = round((time.perf_counter() - t0) * 1e3, 1)
        with self._lock:
            # the episode may have escalated while we wrote: keep the
            # artifact bookkeeping, re-read trigger naming at write time
            ep["captured_at"] = captured_at
            ep["artifacts"] = artifacts
            ep["capture_errors"] = errors
            ep["trace_problems"] = trace_problems
            manifest = self._manifest_view(ep)
            manifest["capture_ms"] = capture_ms
            cls = ep["trigger_class"]
        self._write_json(os.path.join(bundle_dir, "manifest.json"),
                         {k: v for k, v in manifest.items()
                          if not k.startswith("_")})
        _f.INCIDENTS.labels(cls).inc()
        total = self._rotate(keep=snap["id"])
        log.warning("incident bundle frozen: %s trigger=%s (%d artifacts"
                    ", %.0f ms, store %d bytes)", snap["id"], cls,
                    len(artifacts), capture_ms, total)

    def _refresh_manifest(self, ep: dict) -> None:
        """Debounced rewrite of an episode's manifest so absorbed
        trigger counts land on disk (worker thread only)."""
        with self._lock:
            if not ep.get("captured_at"):
                return
            manifest = self._manifest_view(ep)
        self._write_json(os.path.join(manifest["_dir"], "manifest.json"),
                         {k: v for k, v in manifest.items()
                          if not k.startswith("_")})

    @staticmethod
    def _write_json(path: str, obj) -> None:
        """Atomic-rename write so a concurrent reader (summary(), a
        CLI) never sees a torn artifact."""
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf8") as f:
            json.dump(obj, f, indent=1, default=repr)
        os.replace(tmp, path)

    # -- artifact builders (worker thread; each may raise, the caller
    #    records the error instead of losing the bundle) -------------------

    @staticmethod
    def _art_metrics() -> dict:
        ensure_installed()
        try:
            from .attribution import sample_device_memory
            sample_device_memory()
        except Exception:
            pass
        return REGISTRY.snapshot()

    @staticmethod
    def _art_flight() -> dict:
        from . import flight
        return {"summary": flight.summary(),
                "records": flight.recent()}

    @staticmethod
    def _art_trace():
        from . import flight, traceexport
        obj = traceexport.chrome_trace(_trace.records(), flight.recent())
        problems = traceexport.validate(obj)
        if problems:
            obj["validation_problems"] = problems[:32]
        return obj, len(problems)

    @staticmethod
    def _art_health() -> dict:
        from . import health as _health
        eng = _health.current()
        if eng is None:
            return _health.empty_report()
        return eng.report(
            series=sorted(set(_health.HEADLINE_RATES.values())))

    @staticmethod
    def _art_resilience() -> dict:
        from ..resilience import overload, resilience_snapshot
        return {"resilience": resilience_snapshot(),
                "overload": overload.snapshot()}

    def _art_knobs(self) -> dict:
        return resolve_knobs(self)

    @staticmethod
    def _art_journeys() -> dict:
        """The per-item journey table at incident time: what each
        recently-sampled entity was doing when the trigger fired,
        stitched by dispatch_id to the flight.json records frozen beside
        it."""
        from . import journey as _journey
        return {"enabled": _journey.enabled(),
                "summary": _journey.summary(),
                "journeys": _journey.recent(limit=50)}

    # -- retention ---------------------------------------------------------

    def _bundle_dirs(self) -> list[tuple[str, int]]:
        """(bundle_id, bytes) pairs on disk, oldest first (ids embed
        their epoch-ms open time, so lexical-by-timestamp sorting is
        chronological)."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if not _ID_RE.match(name):
                continue
            path = os.path.join(self.directory, name)
            if not os.path.isdir(path):
                continue
            size = 0
            for root, _dirs, files in os.walk(path):
                for fn in files:
                    try:
                        size += os.path.getsize(os.path.join(root, fn))
                    except OSError:
                        pass
            out.append((name, size))
        out.sort(key=lambda p: (int(p[0].split("-")[1]),
                                int(p[0].split("-")[2])))
        return out

    def _rotate(self, keep: str) -> int:
        """Oldest-first rotation to the count/bytes bounds; `keep` (the
        episode just captured) is never removed.  Returns the resident
        byte total (also set on the gauge)."""
        bundles = self._bundle_dirs()
        total = sum(s for _, s in bundles)
        dropped = []
        while bundles and (len(bundles) > self.max_bundles
                           or total > self.max_bytes):
            name, size = bundles[0]
            if name == keep:
                break
            try:
                shutil.rmtree(os.path.join(self.directory, name))
            except OSError:
                break
            bundles.pop(0)
            total -= size
            dropped.append(name)
        _f.INCIDENT_BYTES.set(float(total))
        if dropped:
            log.info("incident rotation dropped %s", ",".join(dropped))
        return total

    # -- crash hooks -------------------------------------------------------

    def _install_process_hooks(self) -> None:
        self._prev_sys_hook = sys.excepthook
        sys.excepthook = self._sys_excepthook
        self._prev_thread_hook = threading.excepthook
        threading.excepthook = self._thread_excepthook
        try:
            path = os.path.join(self.directory, "faulthandler.log")
            self._fault_file = open(path, "a", encoding="utf8")
            if not faulthandler.is_enabled():
                faulthandler.enable(file=self._fault_file,
                                    all_threads=True)
                self._faulthandler_armed = True
        except OSError:
            log.exception("faulthandler arming failed")

    def _restore_process_hooks(self) -> None:
        if self._prev_sys_hook is not None:
            sys.excepthook = self._prev_sys_hook
            self._prev_sys_hook = None
        if self._prev_thread_hook is not None:
            threading.excepthook = self._prev_thread_hook
            self._prev_thread_hook = None
        if self._faulthandler_armed:
            try:
                faulthandler.disable()
            except Exception:
                pass
            self._faulthandler_armed = False
        if self._fault_file is not None:
            try:
                self._fault_file.close()
            except OSError:
                pass
            self._fault_file = None

    def _crash_payload(self, etype, value, tb, thread=None) -> dict:
        return {
            "exception": getattr(etype, "__name__", str(etype)),
            "message": str(value)[:2048],
            "thread": thread or threading.current_thread().name,
            "traceback": "".join(
                traceback.format_exception(etype, value, tb))[-16384:],
        }

    def _sys_excepthook(self, etype, value, tb) -> None:
        try:
            self._trigger("crash", self._crash_payload(etype, value, tb))
            # the interpreter is unwinding: wait for the black box to
            # flush before the process dies (worker is a daemon thread)
            self.drain(10.0)
        except Exception:
            log.exception("crash capture failed")
        finally:
            if self._prev_sys_hook is not None:
                self._prev_sys_hook(etype, value, tb)
            else:
                sys.__excepthook__(etype, value, tb)

    def _thread_excepthook(self, args) -> None:
        try:
            if args.exc_type is not SystemExit:
                self._trigger("thread_crash", self._crash_payload(
                    args.exc_type, args.exc_value, args.exc_traceback,
                    thread=getattr(args.thread, "name", None)))
                self.drain(10.0)
        except Exception:
            log.exception("thread-crash capture failed")
        finally:
            prev = self._prev_thread_hook
            if prev is not None:
                prev(args)

    # -- exposition ----------------------------------------------------------

    def summary(self, limit: int | None = None) -> dict:
        """Newest-first bundle summaries
        off the on-disk manifests, with the open episode's live
        suppressed counts merged in."""
        with self._lock:
            ep = self._episode
            live = (dict(ep["suppressed"]), ep["id"]) if ep else None
        bundles = self._bundle_dirs()
        total = sum(s for _, s in bundles)
        rows = []
        now = time.time()
        for name, size in reversed(bundles):
            if limit is not None and len(rows) >= limit:
                break
            row = {"id": name, "bytes": size, "trigger": None,
                   "captured_at": None, "age_s": None,
                   "recaptures": 0, "suppressed": 0}
            try:
                with open(os.path.join(self.directory, name,
                                       "manifest.json"),
                          encoding="utf8") as f:
                    man = json.load(f)
                row["trigger"] = (man.get("trigger") or {}).get("class")
                row["captured_at"] = man.get("captured_at")
                if row["captured_at"]:
                    row["age_s"] = round(now - row["captured_at"], 1)
                row["recaptures"] = man.get("recaptures", 0)
                suppressed = man.get("suppressed") or {}
                if live is not None and live[1] == name:
                    suppressed = live[0]
                row["suppressed"] = int(sum(suppressed.values()))
                row["correlation"] = man.get("correlation")
            except (OSError, ValueError):
                row["trigger"] = "unreadable"
            rows.append(row)
        return {"incidents": rows, "count": len(bundles),
                "total_bytes": total, "dir": self.directory,
                "enabled": not self.disabled}

    def get(self, incident_id: str, artifact: str | None = None) -> dict:
        """One bundle: the manifest (always) plus one
        named artifact's content on request.  Raises KeyError on an
        unknown id, ValueError on a malformed id/artifact name."""
        if not _ID_RE.match(incident_id or ""):
            raise ValueError(f"malformed incident id {incident_id!r}")
        if artifact is not None and artifact not in ARTIFACTS:
            raise ValueError(
                f"unknown artifact {artifact!r} (want one of "
                f"{', '.join(ARTIFACTS)})")
        bundle_dir = os.path.join(self.directory, incident_id)
        man_path = os.path.join(bundle_dir, "manifest.json")
        if not os.path.isfile(man_path):
            raise KeyError(incident_id)
        with open(man_path, encoding="utf8") as f:
            out = {"id": incident_id, "manifest": json.load(f)}
        if artifact is not None:
            with open(os.path.join(bundle_dir, artifact),
                      encoding="utf8") as f:
                out["artifact"] = {"name": artifact,
                                   "content": json.load(f)}
        return out


# ---------------------------------------------------------------------------
# process singleton

_recorder: IncidentRecorder | None = None
_recorder_lock = threading.Lock()


def current() -> IncidentRecorder | None:
    return _recorder


def install(rec, **kw) -> IncidentRecorder | None:
    """Make `rec` the process's recorder: an IncidentRecorder, or a
    directory to build one in (``kw`` are its arguments), or None to
    uninstall.  Does not start or stop it.  (The JAX package's
    ``install_from_env`` reads the directory from the environment.)"""
    global _recorder
    if rec is not None and not isinstance(rec, IncidentRecorder):
        rec = IncidentRecorder(rec, **kw)
    with _recorder_lock:
        _recorder = rec
    return rec


def reset_for_tests() -> None:
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            _recorder.stop(timeout=2.0)
        _recorder = None
