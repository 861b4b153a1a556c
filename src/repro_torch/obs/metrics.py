"""Metrics registry: counters, gauges, and fixed-bucket latency histograms.

The always-on half of the observability substrate (tracing is opt-in, a
counter bump is a dict lookup + integer add): the plan cache's hit/miss
counters (including the disk tier's ``plans.disk_hits`` / ``disk_misses`` /
``disk_writes`` / ``disk_corrupt``), per-edge byte counters, exchange round
counts, sweep latency
histograms, and the watchdog's straggler/dropped-event counters all live
here.  ACCL+ exposes per-collective timing from its collective engine to
drive tuning; this registry is that feed for ACCL-X — ``snapshot()`` is what
a scraper (or the sweep summary, or the elastic runtime's re-selection
policy) reads.

Conventions:

- Names are dotted paths (``plans.plan_hits``, ``comm.edge_bytes``).
- Optional labels distinguish series of one name
  (``counter("comm.edge_bytes", hops=2)``); the snapshot renders them as
  ``name{hops=2}``.
- Histograms use fixed log-spaced bucket bounds (1-2-5 per decade over
  0.1 us .. 100 s by default) and report p50/p95/p99 by linear
  interpolation inside the bucket — O(1) memory however many observations.

Everything is host-side pure Python (no torch imports), so the comm core can
depend on it without layering cycles.
"""
from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence

_LOCK = threading.RLock()


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render(name: str, lk: tuple) -> str:
    if not lk:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"


def parse_labels(rendered: str) -> tuple[str, dict]:
    """Invert :func:`_render`: ``"comm.edge_bytes{hops=2}"`` ->
    ``("comm.edge_bytes", {"hops": "2"})``.  The decoder consumers of
    ``Registry.find``/``snapshot`` use to get label values back out of a
    series name (e.g. the DegradationMonitor splitting per-hop traffic)."""
    if "{" not in rendered:
        return rendered, {}
    name, _, body = rendered.partition("{")
    labels = {}
    for pair in body.rstrip("}").split(","):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        labels[k] = v
    return name, labels


class Counter:
    """Monotonic (between resets) integer/float counter."""
    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n=1) -> None:
        with _LOCK:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        with _LOCK:
            self._value = 0


class Gauge:
    """Last-write-wins scalar (queue depths, current config ids)."""
    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        with _LOCK:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with _LOCK:
            self._value = 0.0


def default_bounds() -> tuple[float, ...]:
    """1-2-5 series per decade, 0.1 .. 1e8 (microsecond latencies from
    100 ns to 100 s when observations are in us)."""
    bounds = []
    decade = 0.1
    while decade < 1e8:
        for m in (1.0, 2.0, 5.0):
            bounds.append(decade * m)
        decade *= 10.0
    return tuple(bounds)


_DEFAULT_BOUNDS = default_bounds()


class Histogram:
    """Fixed-bucket histogram with interpolated percentile summaries."""
    __slots__ = ("name", "bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else _DEFAULT_BOUNDS
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be sorted")
        self.counts = [0] * (len(self.bounds) + 1)   # +1 overflow bucket
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        with _LOCK:
            self.counts[bisect.bisect_left(self.bounds, v)] += 1
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)

    def percentile(self, p: float) -> float:
        """Interpolated percentile (``p`` in [0, 100]) from the buckets,
        clamped to the observed min/max."""
        with _LOCK:
            if self.count == 0:
                return 0.0
            target = p / 100.0 * self.count
            seen = 0.0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                lo = self.bounds[i - 1] if i > 0 else self.vmin
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                if seen + c >= target:
                    frac = (target - seen) / c
                    v = lo + frac * (max(hi, lo) - lo)
                    return min(max(v, self.vmin), self.vmax)
                seen += c
            return self.vmax

    def summary(self) -> dict:
        with _LOCK:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "mean": 0.0,
                        "p50": 0.0, "p95": 0.0, "p99": 0.0,
                        "min": 0.0, "max": 0.0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "min": self.vmin, "max": self.vmax}

    def reset(self) -> None:
        with _LOCK:
            self.counts = [0] * (len(self.bounds) + 1)
            self.count = 0
            self.total = 0.0
            self.vmin = float("inf")
            self.vmax = float("-inf")


class Registry:
    """Get-or-create store of named instruments.

    One global instance (:func:`registry`) serves the whole process; tests
    may build private registries.  Type mismatches on an existing name raise
    — a counter never silently shadows a histogram.
    """

    def __init__(self):
        self._instruments: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, _label_key(labels))
        with _LOCK:
            inst = self._instruments.get(key)
            if inst is None:
                other = next((k for k in self._instruments
                              if k[1:] == key[1:]), None)
                if other is not None:
                    raise TypeError(
                        f"{_render(name, key[2])} already registered as "
                        f"{other[0]}, requested {cls.__name__}")
                inst = cls(_render(name, key[2]), **kw)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def snapshot(self) -> dict:
        """``{rendered_name: value-or-summary}`` for every instrument."""
        with _LOCK:
            items = list(self._instruments.values())
        out = {}
        for inst in items:
            if isinstance(inst, Histogram):
                out[inst.name] = inst.summary()
            else:
                out[inst.name] = inst.value
        return out

    def counters(self, prefixes: Sequence[str]) -> list[Counter]:
        """Every counter whose name starts with one of ``prefixes``."""
        with _LOCK:
            items = list(self._instruments.values())
        return [c for c in items if isinstance(c, Counter)
                and c.name.startswith(tuple(prefixes))]

    def find(self, prefix: str) -> dict:
        """Snapshot restricted to names starting with ``prefix``."""
        return {k: v for k, v in self.snapshot().items()
                if k.startswith(prefix)}

    def reset(self) -> None:
        with _LOCK:
            items = list(self._instruments.values())
        for inst in items:
            inst.reset()


def percentile_of(samples: Sequence[float], p: float,
                  bounds: Optional[Sequence[float]] = None) -> float:
    """Interpolated percentile of a raw sample list, computed through the
    same fixed-bucket machinery the registry histograms use — so a
    per-candidate tail estimate (the sweep's ``TuneEntry.p95_us``) agrees
    bucket-for-bucket with the aggregate ``sweep.us`` series.  Empty input
    returns 0.0 (the "no tail data" sentinel ``TuneDB._rank`` respects)."""
    h = Histogram("adhoc", bounds=bounds)
    for v in samples:
        h.observe(v)
    return h.percentile(p)


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-global registry every subsystem publishes into."""
    return _REGISTRY
