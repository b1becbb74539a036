"""Chrome trace-event export: span ring + flight ring -> a
Perfetto-loadable JSON timeline.

Serializes the trace-span ring (utils/trace.py) and the dispatch flight
ring (obs/flight.py) into the Chrome trace-event format
(``{"traceEvents": [...]}``), which chrome://tracing and
https://ui.perfetto.dev both open:

* every completed span is a complete ("X") event on its thread's lane
  (``tid`` from the record; lanes are named by "M" metadata events);
* every correlation id (trace.Carrier) becomes a flow-arrow chain of
  "s"/"t"/"f" events threading the enqueue span to its flush, dispatch
  and readback spans across threads;
* every flight record is an "X" event on a synthetic per-family
  ``flight:<family>`` lane, its args carrying the whole record (breaker
  state, faults, quarantine, timing split).

Spans and flight records share one clock (time.monotonic_ns), so the
lanes line up.  ``validate()`` checks the schema Perfetto enforces, so a
malformed export fails loudly instead of rendering an empty timeline.
Imports nothing heavy.
"""
from __future__ import annotations

PID = 1
PROCESS_NAME = "lightning_tpu"
# synthetic lanes for flight records sit far above real native tids
FLIGHT_TID_BASE = 1 << 30

_FLOW_NAME = "corr"
_FLOW_CAT = "flow"


def _span_event(rec: dict, pid: int) -> dict:
    args = dict(rec.get("attributes", ()))
    for k in ("span_id", "parent_id", "corr_ids", "dispatch_id", "error"):
        if rec.get(k) is not None:
            args[k] = rec[k]
    return {
        "ph": "X",
        "name": rec["name"],
        "cat": "span",
        "ts": rec["start_ns"] / 1e3,
        "dur": rec["duration_ns"] / 1e3,
        "pid": pid,
        "tid": rec.get("tid", 0),
        "args": args,
    }


def _flight_event(rec: dict, tid: int, pid: int) -> dict:
    dur_ms = (rec.get("dispatch_ms") or 0.0) + (rec.get("readback_ms")
                                                or 0.0)
    return {
        "ph": "X",
        "name": "dispatch/" + rec["family"],
        "cat": "dispatch",
        "ts": rec["ts_ns"] / 1e3,
        "dur": dur_ms * 1e3,
        "pid": pid,
        "tid": tid,
        "args": {k: v for k, v in rec.items()
                 if k not in ("ts_ns",) and v is not None},
    }


def chrome_trace(span_records, flight_records=(), *, pid: int = PID) -> dict:
    """Build the Chrome trace-event object.  Deterministic for a given
    input (the golden-file test relies on it): events appear as
    metadata, then spans in input order, then flow chains in corr-id
    order, then flight lanes in input order."""
    span_records = [r for r in span_records if "start_ns" in r]
    events: list[dict] = []
    tid_names: dict[int, str] = {}
    for rec in span_records:
        tid = rec.get("tid", 0)
        if tid not in tid_names:
            tid_names[tid] = rec.get("thread") or f"tid-{tid}"

    fam_tids: dict[str, int] = {}
    flight_events = []
    for rec in flight_records:
        fam = rec["family"]
        tid = fam_tids.get(fam)
        if tid is None:
            tid = fam_tids[fam] = FLIGHT_TID_BASE + len(fam_tids)
            tid_names[tid] = "flight:" + fam
        flight_events.append(_flight_event(rec, tid, pid))

    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": PROCESS_NAME}})
    for tid in sorted(tid_names):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tid_names[tid]}})

    events.extend(_span_event(r, pid) for r in span_records)

    # flow arrows: one chain per correlation id, hop after hop in span
    # start order — the enqueue span starts the chain, every later span
    # carrying the id is a step, the last is the binding finish
    by_corr: dict[int, list[dict]] = {}
    for rec in span_records:
        for cid in rec.get("corr_ids", ()):
            by_corr.setdefault(cid, []).append(rec)
    for cid in sorted(by_corr):
        chain = sorted(by_corr[cid],
                       key=lambda r: (r["start_ns"], r["span_id"]))
        if len(chain) < 2:
            continue
        last = len(chain) - 1
        for i, rec in enumerate(chain):
            ev = {
                "ph": "s" if i == 0 else ("f" if i == last else "t"),
                "name": _FLOW_NAME,
                "cat": _FLOW_CAT,
                "id": cid,
                "ts": rec["start_ns"] / 1e3,
                "pid": pid,
                "tid": rec.get("tid", 0),
            }
            if i == last:
                ev["bp"] = "e"   # bind to the enclosing slice
            events.append(ev)

    events.extend(flight_events)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate(trace_obj: dict) -> list[str]:
    """Schema check for the fields Perfetto/chrome://tracing require;
    returns a list of problems (empty == valid).  Checked per event:

    * "M" metadata: name + args.name;
    * "X" complete: name, numeric ts, numeric dur >= 0, pid, tid;
    * "s"/"t"/"f" flow: id, name, numeric ts, pid, tid; "f" needs
      bp="e"; every flow id must have exactly one "s" and one "f", and
      each flow event must bind INSIDE an "X" slice on its tid (the
      rule Perfetto enforces when attaching arrows).
    """
    errs: list[str] = []
    if not isinstance(trace_obj, dict):
        return ["top-level value is not an object"]
    evs = trace_obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    slices: dict[object, list[tuple[float, float]]] = {}
    flows: dict[object, dict[str, int]] = {}
    for i, ev in enumerate(evs):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            if not ev.get("name") or "name" not in ev.get("args", {}):
                errs.append(f"{where}: metadata needs name + args.name")
            continue
        if ph not in ("X", "s", "t", "f"):
            errs.append(f"{where}: unknown ph {ph!r}")
            continue
        for key in ("ts", "pid", "tid"):
            if not isinstance(ev.get(key), (int, float)):
                errs.append(f"{where}: {key} missing/non-numeric")
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errs.append(f"{where}: name missing")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event needs dur >= 0")
            elif isinstance(ev.get("ts"), (int, float)):
                slices.setdefault(ev.get("tid"), []).append(
                    (ev["ts"], ev["ts"] + dur))
        else:
            if "id" not in ev:
                errs.append(f"{where}: flow event needs id")
            if ph == "f" and ev.get("bp") != "e":
                errs.append(f"{where}: flow finish needs bp='e'")
            counts = flows.setdefault(ev.get("id"), {"s": 0, "f": 0})
            if ph in counts:
                counts[ph] += 1
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict) or ev.get("ph") not in ("s", "t", "f"):
            continue
        ts, tid = ev.get("ts"), ev.get("tid")
        if not isinstance(ts, (int, float)):
            continue
        if not any(a <= ts <= b for a, b in slices.get(tid, ())):
            errs.append(f"event[{i}]: flow event at ts={ts} binds no "
                        f"slice on tid={tid}")
    for fid, counts in flows.items():
        if counts["s"] != 1 or counts["f"] != 1:
            errs.append(f"flow id {fid!r}: needs exactly one start and "
                        f"one finish (got s={counts['s']}, "
                        f"f={counts['f']})")
    return errs
