"""The span tracer, typed counters, and drift records.

Port of ``src/repro/telemetry/tracer.py`` (plain Python, kept as is); the
reference's profiler bridge becomes a ``torch.profiler`` bridge
(:mod:`repro_torch.telemetry.torchbridge`).

One process-wide :class:`Tracer` (module-level singleton, off by
default) records four event kinds into an in-memory buffer and,
optionally, a streaming JSONL file:

* **spans** — named durations with parent/child structure.  The current
  span is thread-local; code that moves work to another thread (the
  autotuner's measurement worker, most importantly) carries the context
  across explicitly with :func:`current_context` / :func:`attach` —
  thread-locality is the default, inheritance is opt-in and visible.
* **counters** — monotonically increasing named integers
  (:func:`inc`), queryable in-process (:func:`counters`) so tests can
  assert exact values, and exported as Chrome counter events.
  :func:`sample` additionally records a *timestamped* value (gauge
  semantics: slot occupancy, peak bytes).
* **instant events** — point-in-time markers with args (:func:`event`).
* **drift records** — one measured latency paired with its analytic
  ``perf_model`` prediction (:func:`drift`); the raw material of
  ``analysis/trace_report.py``'s model-vs-measured summary.

Everything is disabled until :func:`configure` runs (or the
``REPRO_TRACE`` env var names an output path at import time).  Disabled,
every entry point is one attribute load and a falsy check — no dict
building, no clock reads — so instrumented hot paths cost nothing
measurable; tests pin this (``tests/test_telemetry.py``).

Timestamps are microseconds since the tracer epoch
(``time.perf_counter`` based), the unit Chrome trace events use.  This
module is dependency-free on purpose: no torch, no repro_torch.core — every
other layer may import it without cycles.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass


@dataclass
class SpanContext:
    """The handle :func:`current_context` returns and :func:`attach`
    restores on another thread — just enough identity for parenting."""

    span_id: int
    name: str


class _Tls(threading.local):
    span: "SpanContext | None" = None


_tls = _Tls()


class _NoopSpan:
    """Shared do-nothing context manager for the disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class Tracer:
    def __init__(self):
        self.enabled = False
        self.path: str | None = None
        self.profiler_bridge = False
        self.events: list[dict] = []
        self.counters: dict[str, int] = {}
        self._stream = None          # open JSONL handle (path *.jsonl)
        self._lock = threading.Lock()
        self._next_id = 1
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._tids: dict[object, int] = {}
        self._warned: set[str] = set()

    # -- clock / ids --------------------------------------------------------

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self, key: object | None = None) -> int:
        """Small stable lane id for a thread (default: the calling
        thread) or a named virtual lane (serving request lifecycles)."""
        if key is None:
            key = threading.get_ident()
        with self._lock:
            tid = self._tids.get(key)
            if tid is None:
                tid = len(self._tids)
                self._tids[key] = tid
        return tid

    # -- recording ----------------------------------------------------------

    def _record(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)
            if self._stream is not None:
                json.dump(ev, self._stream)
                self._stream.write("\n")

    def span_event(self, name: str, ts: float, dur: float, *,
                   span_id: int, parent: int | None, tid: int,
                   args: dict | None) -> None:
        self._record({"type": "span", "name": name, "ts": ts,
                      "dur": dur, "pid": self._pid, "tid": tid,
                      "id": span_id, "parent": parent,
                      "args": args or {}})

    # -- output -------------------------------------------------------------

    def flush(self) -> None:
        """Write the configured output file.  ``*.jsonl`` paths stream
        at record time (this just appends the final counter snapshot);
        any other path gets the full Chrome trace-event JSON."""
        if not self.enabled:
            return
        from repro_torch.telemetry import export
        snap = {"type": "counters", "ts": self.now_us(),
                "values": dict(self.counters)}
        with self._lock:
            self.events.append(snap)
            if self._stream is not None:
                json.dump(snap, self._stream)
                self._stream.write("\n")
                self._stream.flush()
        if self.path and not self.path.endswith(".jsonl"):
            obj = export.to_chrome(self.events,
                                   thread_names=self._thread_names())
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(obj, f)
            os.replace(tmp, self.path)

    def _thread_names(self) -> dict[int, str]:
        names = {}
        for key, tid in self._tids.items():
            names[tid] = key if isinstance(key, str) else f"thread-{tid}"
        return names


_TRACER = Tracer()


def _get() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def configure(path: str | None = None, *,
              profiler_bridge: bool | None = None) -> Tracer:
    """Enable tracing.  ``path`` (optional) is the output file: a
    ``*.jsonl`` suffix streams one JSON event per line as recorded, any
    other suffix buffers and :func:`finalize` writes Chrome trace-event
    JSON.  No path = in-memory only (tests assert on
    :func:`counters` / ``snapshot()``).  ``profiler_bridge=True`` mirrors
    every span into ``torch.profiler.record_function`` (defaults to the
    ``REPRO_TRACE_JAX`` env var, the reference's knob, so one setting
    drives both packages)."""
    t = _TRACER
    t.enabled = True
    if profiler_bridge is None:
        profiler_bridge = os.environ.get("REPRO_TRACE_JAX", "") not in (
            "", "0")
    t.profiler_bridge = profiler_bridge
    if path:
        t.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if path.endswith(".jsonl"):
            t._stream = open(path, "w")
    t._tid()       # lane 0 = the configuring (main) thread
    return t


def finalize() -> None:
    """Flush the output file (if any) and disable the tracer."""
    t = _TRACER
    if not t.enabled:
        return
    t.flush()
    if t._stream is not None:
        t._stream.close()
        t._stream = None
    t.enabled = False
    t.path = None


def reset() -> None:
    """Disable and drop all recorded state (tests)."""
    t = _TRACER
    if t._stream is not None:
        t._stream.close()
        t._stream = None
    t.enabled = False
    t.path = None
    t.profiler_bridge = False
    t.events.clear()
    t.counters.clear()
    t._tids.clear()
    t._warned.clear()
    t._next_id = 1
    t._t0 = time.perf_counter()
    _tls.span = None


# -- spans -------------------------------------------------------------------


class _Span:
    __slots__ = ("name", "args", "span_id", "parent", "t0", "_ann",
                 "_prev")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args
        self._ann = None

    def __enter__(self):
        t = _TRACER
        with t._lock:
            self.span_id = t._next_id
            t._next_id += 1
        self._prev = _tls.span
        self.parent = (self._prev.span_id if self._prev is not None
                       else None)
        _tls.span = SpanContext(self.span_id, self.name)
        if t.profiler_bridge:
            from repro_torch.telemetry import torchbridge
            self._ann = torchbridge.annotation(self.name)
            if self._ann is not None:
                self._ann.__enter__()
        self.t0 = t.now_us()
        return self

    def __exit__(self, *exc):
        t = _TRACER
        t1 = t.now_us()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        _tls.span = self._prev
        t.span_event(self.name, self.t0, t1 - self.t0,
                     span_id=self.span_id, parent=self.parent,
                     tid=t._tid(), args=self.args)
        return False


def span(name: str, **args):
    """Context manager timing a named span; parents under the calling
    thread's current span.  Returns a shared no-op when disabled."""
    if not _TRACER.enabled:
        return _NOOP
    return _Span(name, args)


def complete_span(name: str, start_us: float, end_us: float, *,
                  lane: str | None = None, **args) -> None:
    """Record an already-timed span from explicit tracer-clock
    timestamps (µs, :func:`now_us`) — the serving engine reconstructs
    request lifecycles this way.  ``lane`` names a virtual thread row
    so overlapping request spans render side by side in Perfetto."""
    t = _TRACER
    if not t.enabled:
        return
    with t._lock:
        span_id = t._next_id
        t._next_id += 1
    cur = _tls.span
    t.span_event(name, start_us, max(end_us - start_us, 0.0),
                 span_id=span_id,
                 parent=cur.span_id if cur is not None else None,
                 tid=t._tid(lane), args=args)


def now_us() -> float:
    """Microseconds since the tracer epoch (0.0 when disabled)."""
    t = _TRACER
    return t.now_us() if t.enabled else 0.0


def current_context() -> SpanContext | None:
    """The calling thread's current span — capture before handing work
    to a worker thread, restore there with :func:`attach`."""
    if not _TRACER.enabled:
        return None
    return _tls.span


@contextmanager
def suspended():
    """Temporarily disable recording without dropping buffered state —
    the overhead benchmark measures the disabled fast path even when the
    suite runs under an active trace."""
    t = _TRACER
    prev = t.enabled
    t.enabled = False
    try:
        yield
    finally:
        t.enabled = prev


@contextmanager
def attach(ctx: SpanContext | None):
    """Adopt ``ctx`` as the current span on this thread — the explicit
    cross-thread handoff (spans opened inside parent under it)."""
    prev = _tls.span
    _tls.span = ctx
    try:
        yield
    finally:
        _tls.span = prev


# -- counters / events / drift ----------------------------------------------


def inc(name: str, value: int = 1) -> None:
    """Increment a typed counter (monotone; exported at finalize)."""
    t = _TRACER
    if not t.enabled:
        return
    with t._lock:
        t.counters[name] = t.counters.get(name, 0) + value


def counters() -> dict[str, int]:
    """Snapshot of every counter (empty dict when disabled)."""
    return dict(_TRACER.counters)


def sample(name: str, value: float) -> None:
    """Record a timestamped gauge sample (Chrome counter track)."""
    t = _TRACER
    if not t.enabled:
        return
    t._record({"type": "counter", "name": name, "ts": t.now_us(),
               "pid": t._pid, "value": value})


def event(name: str, **args) -> None:
    """Record an instant event."""
    t = _TRACER
    if not t.enabled:
        return
    t._record({"type": "instant", "name": name, "ts": t.now_us(),
               "pid": t._pid, "tid": t._tid(), "args": args})


def drift(name: str, *, predicted_s: float, measured_s: float,
          **args) -> None:
    """Record one model-vs-measured drift pair: the analytic
    ``perf_model`` prediction next to the wall-clock measurement of the
    same unit of work (a tuned step, a whole plan)."""
    t = _TRACER
    if not t.enabled:
        return
    t._record({"type": "drift", "name": name, "ts": t.now_us(),
               "pid": t._pid, "predicted_s": predicted_s,
               "measured_s": measured_s, "args": args})


def drift_records() -> list[dict]:
    """Every drift record so far (in-process view)."""
    return [e for e in _TRACER.events if e.get("type") == "drift"]


def snapshot() -> list[dict]:
    """Copy of the full in-memory event buffer."""
    with _TRACER._lock:
        return list(_TRACER.events)


def warn_once_key(key: str) -> bool:
    """True exactly once per key per process — the warn-once gate the
    degrade paths share (works with the tracer disabled too: silent
    degrades must warn even when nobody asked for a trace)."""
    t = _TRACER
    with t._lock:
        if key in t._warned:
            return False
        t._warned.add(key)
        return True


# Zero-config CI hook: REPRO_TRACE=<path> enables tracing at import time
# (benchmarks and tests then need no plumbing to produce a trace file).
_env_path = os.environ.get("REPRO_TRACE")
if _env_path:
    configure(_env_path)
del _env_path
