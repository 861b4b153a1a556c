"""Fault-tolerance runtime (PyTorch port): straggler watchdog, preemption
handler, and the survivors' torus for elastic re-forming.

- **Straggler mitigation** — a step-time watchdog keeps a robust running
  estimate (median + MAD); steps slower than ``median + k·MAD`` are logged
  and counted (``watchdog.stragglers``, which the
  :class:`~repro_torch.runtime.faults.DegradationMonitor` reads).
- **Preemption** — SIGTERM/SIGINT set a flag; the loop drains at the next
  step boundary (the handler never touches device state from the signal
  context).
- **Elastic re-forming** — :func:`survivor_topology` is the sub-torus the
  survivors of a rank loss re-form on
  (:func:`repro_torch.runtime.elastic.run_swe_elastic` uses it).

The JAX package's ``elastic_restore`` and ``resume_session`` rebuild an LM
training session from a checkpoint; they come with the port's checkpointer
and training slice.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import threading
import time
from collections import deque
from typing import Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


# ----------------------------------------------------------------------
# Straggler watchdog
# ----------------------------------------------------------------------

@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    threshold: float


class StepWatchdog:
    """Robust step-time outlier detection (median + k·MAD).

    Retention is bounded for long-running jobs: ``events`` keeps the most
    recent ``max_events`` stragglers (older ones are counted in
    ``events_dropped`` and the ``watchdog.events_dropped`` metrics counter,
    never silently lost), and ``durations`` keeps enough history for the
    rolling ``window`` plus a stable ``median_step`` — O(1) memory over an
    unbounded run instead of one float per step forever.

    Every completed step emits a ``watchdog.step`` instant event when
    tracing is on; detected stragglers additionally emit
    ``watchdog.straggler`` and bump the ``watchdog.stragglers`` counter.
    """

    def __init__(self, k: float = 5.0, warmup: int = 5, window: int = 50,
                 max_events: int = 256):
        self.k = k
        self.warmup = warmup
        self.window = window
        self.max_events = max_events
        self.durations: deque[float] = deque(maxlen=max(4 * window, 200))
        self.events: deque[StragglerEvent] = deque(maxlen=max_events)
        self.events_dropped = 0
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self, step: int):
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> Optional[StragglerEvent]:
        if self._t0 is None:
            return None
        dt = time.perf_counter() - self._t0
        # Consume the start mark: a second end_step at the same boundary is
        # a no-op instead of appending the duration twice (which would skew
        # the median and could emit a phantom straggler).
        self._t0 = None
        hist = list(self.durations)[-self.window:]
        event = None
        if len(hist) >= self.warmup:
            med = statistics.median(hist)
            mad = statistics.median([abs(x - med) for x in hist]) or 1e-9
            thr = med + self.k * mad
            if dt > thr:
                event = StragglerEvent(self._step, dt, thr)
                if len(self.events) == self.events.maxlen:
                    self.events_dropped += 1
                    obs_metrics.registry().counter(
                        "watchdog.events_dropped").inc()
                self.events.append(event)
                obs_metrics.registry().counter("watchdog.stragglers").inc()
                obs_trace.instant("watchdog.straggler", cat="watchdog",
                                  step=self._step, ms=dt * 1e3,
                                  threshold_ms=thr * 1e3)
        self.durations.append(dt)
        obs_trace.instant("watchdog.step", cat="watchdog", step=self._step,
                          ms=dt * 1e3)
        return event

    @property
    def median_step(self) -> float:
        return statistics.median(self.durations) if self.durations else 0.0


# ----------------------------------------------------------------------
# Preemption handling
# ----------------------------------------------------------------------

class PreemptionGuard:
    """SIGTERM/SIGINT -> set a flag; the training loop checkpoints and exits
    at the next step boundary.

    Contract details that matter in production:

    - **SIGINT is guarded by default** — a Ctrl-C drains exactly like a
      scheduler's SIGTERM instead of stack-tracing mid-step.
    - **Pre-existing custom handlers are chained**, not dropped: if the
      launcher installed its own SIGTERM hook, the guard sets its flag and
      then calls the old handler.  Default dispositions (``SIG_DFL``,
      ``SIG_IGN``, Python's KeyboardInterrupt handler) are *replaced* — the
      whole point is to turn them into a drain.
    - **Nested / re-entrant use restores correctly**: each ``__enter__``
      pushes the handlers it displaced and ``__exit__`` pops exactly that
      frame, so an inner guard (e.g. an eval loop inside the train loop)
      hands the signals back to the outer one, not to the defaults.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = threading.Event()
        self._stack: list[dict] = []
        self._signals = tuple(signals)

    @staticmethod
    def _chainable(old) -> bool:
        """Is ``old`` a custom handler worth chaining?  Dispositions and
        Python's default KeyboardInterrupt raiser are not — replacing them
        IS the guard's job."""
        return callable(old) and old is not signal.default_int_handler

    def __enter__(self):
        frame = {}
        for sig in self._signals:
            old = signal.getsignal(sig)
            frame[sig] = old
            chain = old if self._chainable(old) else None

            def handler(signum, sframe, _chain=chain):
                self._requested.set()
                if _chain is not None:
                    _chain(signum, sframe)

            signal.signal(sig, handler)
        self._stack.append(frame)
        return self

    def __exit__(self, *exc):
        frame = self._stack.pop()
        for sig, old in frame.items():
            signal.signal(sig, old)
        return False

    @property
    def preempted(self) -> bool:
        return self._requested.is_set()

    def request(self):   # for tests / software-triggered drain
        self._requested.set()


# ----------------------------------------------------------------------
# Elastic re-forming
# ----------------------------------------------------------------------

def survivor_topology(topology, n_survivors: int):
    """The :class:`~repro_torch.core.topology.TorusSpec` the survivors
    re-form on: ``topology.shrink`` at ``n_survivors`` ranks (identity when
    the count is unchanged or there was no torus)."""
    if topology is None:
        return None
    n = int(n_survivors)
    return topology if n == topology.n_ranks else topology.shrink(n)
