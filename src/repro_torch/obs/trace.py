"""Low-overhead comm-event span tracer with Chrome ``trace_event`` export.

The paper's argument rests on *seeing* where communication time goes — the
per-configuration breakdowns of Figs. 9–11 and the per-edge behavior at 48
FPGAs.  This module is the software analogue: every layer of the comm stack
(collective entry points, wire chunks, driver phases, watchdog events) emits
spans into a thread-safe ring buffer, exported as Chrome ``trace_event`` JSON
viewable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Enable with the ``REPRO_TRACE`` environment variable:

- unset / ``0`` — disabled (the default).  :func:`span` returns a shared
  no-op context manager and :func:`instant` returns immediately: the
  instrumented code paths are byte-for-byte the seed behavior, no events
  are recorded, and no buffer exists (asserted by ``tests/test_obs.py``).
- ``1``        — collect spans in memory (read back via :func:`events`).
- ``chrome:<path>`` — collect and export to ``<path>`` at process exit
  (or on an explicit :func:`flush`).

Span semantics: the port runs eagerly, so spans in the collective and
wire-chunk layers time the host-side *issue* of the device work (launches
are asynchronous), once per call — and, under a CUDA graph, once per
capture only: a replay runs no Python.  They record the structure the
device executes (one span per exchange round, per wire chunk, with hop
distances and byte counts).  Host-level spans (driver segments, host steps)
measure real wall clock.  Both land on the same timeline; the ``cat`` field
tells them apart (``collective``/``wire`` = issue-time structure,
``driver`` = wall time).

Tracks: ``rank=`` (when the caller knows it) maps to a Chrome ``pid`` so
per-rank activity renders as separate process tracks; host threads map to
``tid`` within a track, and nested ``with span(...)`` blocks on one thread
nest by time containment — per-round spans sit inside their collective's
span, per-chunk spans inside their round's.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Any, Optional

ENV_VAR = "REPRO_TRACE"
DEFAULT_CAPACITY = 1 << 16


def _jsonable(v: Any):
    """Clamp span args to JSON-serializable scalars (enums and arbitrary
    objects stringify — args must never hold live tracers or arrays)."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    value = getattr(v, "value", None)   # enums carry their value
    if isinstance(value, (bool, int, float, str)):
        return value
    return str(v)


class Tracer:
    """Thread-safe ring buffer of Chrome trace events.

    The buffer is bounded (``capacity`` events); overflow drops the oldest
    event and counts it, so a long-running service can leave tracing on
    without unbounded growth — the export carries the drop count.
    """

    def __init__(self, sink: Optional[str] = None,
                 capacity: int = DEFAULT_CAPACITY):
        self.sink = sink
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._t0 = time.perf_counter()
        self._tids: dict[int, int] = {}

    # ------------------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)

    def complete(self, name: str, cat: str, ts_us: float, dur_us: float,
                 rank: Optional[int], args: dict) -> None:
        self.emit({"name": name, "cat": cat, "ph": "X",
                   "ts": round(ts_us, 3), "dur": round(dur_us, 3),
                   "pid": 0 if rank is None else int(rank) + 1,
                   "tid": self._tid(),
                   "args": {k: _jsonable(v) for k, v in args.items()}})

    def instant(self, name: str, cat: str, rank: Optional[int],
                args: dict) -> None:
        self.emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                   "ts": round(self.now_us(), 3),
                   "pid": 0 if rank is None else int(rank) + 1,
                   "tid": self._tid(),
                   "args": {k: _jsonable(v) for k, v in args.items()}})

    # ------------------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def to_chrome(self) -> dict:
        """The full Chrome ``trace_event`` payload: process-name metadata for
        every track, then the buffered events in emission order."""
        evs = self.events()
        pids = sorted({e["pid"] for e in evs})
        meta = [{"name": "process_name", "ph": "M", "pid": p, "tid": 0,
                 "args": {"name": "host" if p == 0 else f"rank {p - 1}"}}
                for p in pids]
        payload = {"traceEvents": meta + evs, "displayTimeUnit": "ms"}
        if self._dropped:
            payload["otherData"] = {"dropped_events": self._dropped}
        return payload

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# ----------------------------------------------------------------------
# Module-level gate: one global tracer (or None = disabled)
# ----------------------------------------------------------------------

_TRACER: Optional[Tracer] = None
_ATEXIT_REGISTERED = False


class _NullSpan:
    """Shared no-op context manager — the guaranteed-cheap disabled path.
    ``span()`` returns this singleton when tracing is off: no allocation,
    no clock read, no buffer append."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records wall time between ``__enter__``/``__exit__``
    and emits a Chrome complete ("X") event.  ``set(**args)`` attaches
    results known only after the timed region (e.g. the measured latency)."""
    __slots__ = ("_tracer", "name", "cat", "rank", "args", "_ts")

    def __init__(self, tracer: Tracer, name: str, cat: str,
                 rank: Optional[int], args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.rank = rank
        self.args = args
        self._ts = 0.0

    def __enter__(self):
        self._ts = self._tracer.now_us()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self.name, self.cat, self._ts,
                              self._tracer.now_us() - self._ts,
                              self.rank, self.args)
        return False

    def set(self, **args):
        self.args.update(args)
        return self


def configure(mode: Optional[str] = None) -> Optional[Tracer]:
    """(Re)configure the global tracer from ``mode`` (or the ``REPRO_TRACE``
    env var when ``mode`` is None).  Returns the active tracer or None.
    Safe to call at runtime — tests toggle tracing on and off with it."""
    global _TRACER, _ATEXIT_REGISTERED
    if mode is None:
        mode = os.environ.get(ENV_VAR, "0")
    mode = (mode or "0").strip()
    if mode in ("", "0"):
        _TRACER = None
        return None
    sink = mode[len("chrome:"):] if mode.startswith("chrome:") else None
    if mode != "1" and sink is None:
        raise ValueError(f"{ENV_VAR} must be 0, 1, or chrome:<path>, "
                         f"got {mode!r}")
    _TRACER = Tracer(sink=sink)
    if sink and not _ATEXIT_REGISTERED:
        atexit.register(flush)
        _ATEXIT_REGISTERED = True
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def mode() -> Optional[str]:
    """The active trace mode: None (off), "1", or "chrome:<path>"."""
    t = _TRACER
    if t is None:
        return None
    return f"chrome:{t.sink}" if t.sink else "1"


def tracer() -> Optional[Tracer]:
    return _TRACER


def span(name: str, cat: str = "comm", rank: Optional[int] = None, **args):
    """Context manager timing one region; no-op singleton when disabled.

    ::

        with trace.span("sendrecv", cat="collective", hops=2, nbytes=65536):
            ...                                   # traced region
        with trace.span("sweep.candidate", cat="sweep") as sp:
            sec = measure(...)
            sp.set(us_per_call=sec * 1e6)         # late-bound results
    """
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, cat, rank, args)


def instant(name: str, cat: str = "comm", rank: Optional[int] = None,
            **args) -> None:
    """Zero-duration instant event (watchdog stragglers, checkpoint marks)."""
    t = _TRACER
    if t is not None:
        t.instant(name, cat, rank, args)


def traced(name: Optional[str] = None, cat: str = "comm", **attrs):
    """Decorator form of :func:`span`; enablement is checked per call, so a
    function decorated while tracing is off still emits spans after a later
    :func:`configure`."""
    import functools

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **k):
            t = _TRACER
            if t is None:
                return fn(*a, **k)
            with _Span(t, label, cat, None, dict(attrs)):
                return fn(*a, **k)
        return wrapper
    return deco


def events() -> list[dict]:
    """The buffered events (tests and in-process consumers); [] when off."""
    t = _TRACER
    return t.events() if t is not None else []


def clear() -> None:
    t = _TRACER
    if t is not None:
        t.clear()


def flush() -> Optional[str]:
    """Export to the configured ``chrome:<path>`` sink (no-op otherwise).
    Registered via atexit when a sink is configured, so any CLI run with
    ``REPRO_TRACE=chrome:trace.json`` leaves a loadable trace behind."""
    t = _TRACER
    if t is not None and t.sink:
        return t.export_chrome(t.sink)
    return None


# Read the env gate once at import; tests reconfigure at runtime.
configure()
