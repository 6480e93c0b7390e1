"""Trace exporters and loaders: JSONL event stream <-> Chrome trace JSON.

Port of ``src/repro/telemetry/export.py`` (plain Python, kept as is).

The tracer's native representation is a flat list of event dicts
(``type`` in ``span | instant | counter | drift | counters``), streamed
one-per-line in JSONL mode.  :func:`to_chrome` converts that list to the
Chrome trace-event format Perfetto / ``chrome://tracing`` load:

* span     -> ``ph="X"`` complete event (ts + dur, both µs)
* instant  -> ``ph="i"`` with thread scope
* counter  -> ``ph="C"`` counter sample
* drift    -> ``ph="i"`` with ``cat="drift"`` and the predicted/measured
  pair in ``args`` (so nothing is lost round-tripping through Chrome
  format — ``analysis/trace_report.py`` reads either file)
* counters (the final snapshot) -> one ``ph="C"`` per counter name

:func:`validate_chrome` is the schema check the tests pin — the
structural subset Perfetto's importer requires (known phase codes,
numeric non-negative timestamps, durations on complete events, a
top-level ``traceEvents`` list).  :func:`load_trace` reads either format
back into the native event list.
"""

from __future__ import annotations

import json


def to_chrome(events: list[dict],
              thread_names: dict[int, str] | None = None) -> dict:
    """Convert native tracer events to a Chrome trace-event object."""
    out: list[dict] = []
    pid = None
    for ev in events:
        pid = ev.get("pid", pid)
    pid = pid if pid is not None else 0
    for tid, name in sorted((thread_names or {}).items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}})
    for ev in events:
        kind = ev.get("type")
        if kind == "span":
            args = dict(ev.get("args") or {})
            if ev.get("parent") is not None:
                args["parent_span"] = ev["parent"]
            args["span_id"] = ev.get("id")
            out.append({"ph": "X", "name": ev["name"], "cat": "span",
                        "ts": ev["ts"], "dur": ev["dur"],
                        "pid": ev.get("pid", pid),
                        "tid": ev.get("tid", 0), "args": args})
        elif kind == "instant":
            out.append({"ph": "i", "s": "t", "name": ev["name"],
                        "cat": "event", "ts": ev["ts"],
                        "pid": ev.get("pid", pid),
                        "tid": ev.get("tid", 0),
                        "args": dict(ev.get("args") or {})})
        elif kind == "counter":
            out.append({"ph": "C", "name": ev["name"], "cat": "counter",
                        "ts": ev["ts"], "pid": ev.get("pid", pid),
                        "tid": 0,
                        "args": {"value": ev.get("value", 0)}})
        elif kind == "drift":
            args = dict(ev.get("args") or {})
            args["predicted_s"] = ev["predicted_s"]
            args["measured_s"] = ev["measured_s"]
            out.append({"ph": "i", "s": "t", "name": ev["name"],
                        "cat": "drift", "ts": ev["ts"],
                        "pid": ev.get("pid", pid), "tid": 0,
                        "args": args})
        elif kind == "counters":
            for cname, val in sorted(ev.get("values", {}).items()):
                out.append({"ph": "C", "name": cname, "cat": "counter",
                            "ts": ev["ts"], "pid": ev.get("pid", pid),
                            "tid": 0, "args": {"value": val}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def from_chrome(obj: dict) -> list[dict]:
    """Invert :func:`to_chrome` back to the native event list (lossy
    only in thread-name metadata, which the reports never consume)."""
    events: list[dict] = []
    for ev in obj.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "X":
            args = dict(ev.get("args") or {})
            span_id = args.pop("span_id", None)
            parent = args.pop("parent_span", None)
            events.append({"type": "span", "name": ev.get("name"),
                           "ts": ev.get("ts"), "dur": ev.get("dur"),
                           "pid": ev.get("pid"), "tid": ev.get("tid"),
                           "id": span_id, "parent": parent,
                           "args": args})
        elif ph == "i" and ev.get("cat") == "drift":
            args = dict(ev.get("args") or {})
            events.append({"type": "drift", "name": ev.get("name"),
                           "ts": ev.get("ts"), "pid": ev.get("pid"),
                           "predicted_s": args.pop("predicted_s", None),
                           "measured_s": args.pop("measured_s", None),
                           "args": args})
        elif ph == "i":
            events.append({"type": "instant", "name": ev.get("name"),
                           "ts": ev.get("ts"), "pid": ev.get("pid"),
                           "tid": ev.get("tid"),
                           "args": dict(ev.get("args") or {})})
        elif ph == "C":
            events.append({"type": "counter", "name": ev.get("name"),
                           "ts": ev.get("ts"), "pid": ev.get("pid"),
                           "value": (ev.get("args") or {}).get("value")})
    return events


def load_trace(path: str) -> list[dict]:
    """Read a trace file in either format into native events: ``*.jsonl``
    as one event per line, anything else as Chrome trace-event JSON."""
    if path.endswith(".jsonl"):
        events = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
        return events
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, dict) and "traceEvents" in obj:
        return from_chrome(obj)
    raise ValueError(f"{path}: not a Chrome trace-event file "
                     "(no traceEvents key)")


_KNOWN_PH = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s",
             "t", "f"}


def validate_chrome(obj: dict) -> list[str]:
    """Structural schema check for the Chrome trace-event format —
    returns a list of violations (empty = loads in Perfetto)."""
    errors: list[str] = []
    if not isinstance(obj, dict):
        return ["top level must be a JSON object"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing/empty name")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errors.append(f"{where}: bad ts {ts!r}")
        if not isinstance(ev.get("pid"), int):
            errors.append(f"{where}: bad pid {ev.get('pid')!r}")
        if not isinstance(ev.get("tid"), int):
            errors.append(f"{where}: bad tid {ev.get('tid')!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: complete event needs dur >= 0, "
                              f"got {dur!r}")
        if ph == "i" and ev.get("s") not in (None, "g", "p", "t"):
            errors.append(f"{where}: bad instant scope {ev.get('s')!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: args must be an object")
    return errors
