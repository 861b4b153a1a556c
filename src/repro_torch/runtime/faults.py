"""Deterministic fault injection + degradation monitoring for the elastic
runtime (PyTorch port; host-pure, the JAX package's schedules event for
event).

The paper's configurability claim inverts under failure: when a link degrades
or a rank dies, the *previously optimal* CommConfig is no longer optimal, so
fault handling must re-enter the tuning loop, not just restart.  This module
supplies the two halves the recovery path needs:

**Injection** — a :class:`FaultSchedule` is a seeded, reproducible list of
events (``DEGRADED_LINK(edge, slowdown)``, ``RANK_LOST(rank, step)``,
``STRAGGLER(rank, factor)``, ``PREEMPT(step)``); the :class:`FaultInjector`
fires them at step boundaries:

- degraded links land at the **wire layer**: the active slowdowns are folded
  into the :class:`~repro_torch.core.topology.TorusSpec`
  (:meth:`FaultInjector.degrade_spec`), whose routed permutes then execute
  real extra hold rounds — measured latency grows, values stay bitwise
  identical;
- rank loss lands at the **driver layer**: :class:`RankLostError` unwinds the
  step loop and the driver re-forms on the survivors' sub-torus
  (``TorusSpec.shrink``) from the last segment snapshot;
- stragglers land at the **host layer** as injected step-boundary delay —
  exactly what :class:`~repro_torch.runtime.fault_tolerance.StepWatchdog` flags;
- preemptions set the :class:`~repro_torch.runtime.fault_tolerance.
  PreemptionGuard` flag, driving the drain path.

The same seed replays the same schedule: kill-and-resume runs are
reproducible end to end, which is what lets tests assert bitwise-identical
result streams across two faulted runs.

**Monitoring** — the :class:`DegradationMonitor` is the decision consumer of
the obs substrate: per-edge latency samples (plus ``comm.edge_bytes{hops=}``
traffic deltas and ``watchdog.stragglers`` from the metrics registry) are
compared against a per-edge EWMA baseline; an edge whose samples exceed
``threshold x baseline`` for ``hysteresis`` *consecutive* observations is
confirmed degraded — the runtime then re-routes around it
(``TorusSpec.with_reroute``) and re-selects configs from the calibrated
model (:func:`repro_torch.tune.elastic.model_reselect`).  A post-switch cooldown
and the consecutive-streak rule keep steady noise from flapping selection.
"""
from __future__ import annotations

import dataclasses
import json
import random
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics


# ----------------------------------------------------------------------
# Events
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradedLink:
    """Physical link ``edge`` runs ``slowdown``x slower from ``step`` on."""
    step: int
    edge: tuple[int, int]
    slowdown: float
    kind: str = dataclasses.field(default="degraded_link", repr=False)


@dataclasses.dataclass(frozen=True)
class RankLost:
    """Rank ``rank`` dies at the boundary before executing ``step``."""
    step: int
    rank: int
    kind: str = dataclasses.field(default="rank_lost", repr=False)


@dataclasses.dataclass(frozen=True)
class Straggler:
    """Rank ``rank`` runs ``factor``x slower for ``duration`` steps."""
    step: int
    rank: int
    factor: float
    duration: int = 5
    kind: str = dataclasses.field(default="straggler", repr=False)


@dataclasses.dataclass(frozen=True)
class Preempt:
    """The scheduler preempts the job at ``step`` (SIGTERM-equivalent)."""
    step: int
    kind: str = dataclasses.field(default="preempt", repr=False)


@dataclasses.dataclass(frozen=True)
class ChunkLoss:
    """The wire starts losing chunks from ``step`` on — the step-level
    handle on :mod:`repro_torch.core.reliable`'s chunk-granularity fault
    injection.  ``drop``/``dup``/``reorder`` are per-transmission
    probabilities; outcomes are drawn deterministically from the schedule
    seed, so two runs under the same schedule fault identically."""
    step: int
    drop: float
    dup: float = 0.0
    reorder: float = 0.0
    kind: str = dataclasses.field(default="chunk_loss", repr=False)


_KINDS = {"degraded_link": DegradedLink, "rank_lost": RankLost,
          "straggler": Straggler, "preempt": Preempt,
          "chunk_loss": ChunkLoss}


class RankLostError(RuntimeError):
    """Raised by the injector when a rank dies; carries (rank, step) so the
    recovery path knows who to exclude and where to resume."""

    def __init__(self, rank: int, step: int):
        super().__init__(f"rank {rank} lost at step {step}")
        self.rank = rank
        self.step = step


# ----------------------------------------------------------------------
# Schedule
# ----------------------------------------------------------------------

SCHEDULE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An ordered, reproducible list of fault events.

    Three ways in: :meth:`generate` (seeded random schedule),
    :meth:`parse` (the compact CLI spelling, e.g.
    ``"degraded_link@5=0-1x3.0;rank_lost@10=r5;straggler@7=r2x4.0;
    preempt@30"``), or :meth:`from_json`/:meth:`load` (the persisted form —
    what the CI smoke passes to ``python -m repro_torch.runtime.elastic``).
    """
    events: tuple = ()
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.step, e.kind))))

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    def at(self, step: int) -> list:
        return [e for e in self.events if e.step == step]

    def through(self, step: int) -> list:
        return [e for e in self.events if e.step <= step]

    # -- seeded generation ---------------------------------------------
    @classmethod
    def generate(cls, seed: int, n_steps: int, spec=None,
                 n_ranks: Optional[int] = None,
                 degraded_links: int = 1, rank_losses: int = 0,
                 stragglers: int = 1, preempts: int = 0,
                 slowdown_range=(2.0, 4.0),
                 factor_range=(2.0, 6.0)) -> "FaultSchedule":
        """A reproducible random schedule: same (seed, args) -> same events.

        ``spec`` (a TorusSpec) supplies the physical links degradations can
        hit; without one, ring edges ``(i, i+1)`` over ``n_ranks`` are used.
        Events land in the middle 80% of the run so recovery has steps left
        to prove itself on.
        """
        rng = random.Random(seed)
        if spec is not None:
            n_ranks = spec.n_ranks
            links = [(spec.rank_at(a), spec.rank_at(b))
                     for a, b in _torus_links(spec.shape)]
        elif n_ranks:
            links = [(i, (i + 1) % n_ranks) for i in range(n_ranks)]
        else:
            raise ValueError("generate needs spec= or n_ranks=")
        lo, hi = max(1, n_steps // 10), max(2, (9 * n_steps) // 10)
        step = lambda: rng.randrange(lo, hi)
        events: list = []
        for _ in range(degraded_links):
            events.append(DegradedLink(step(), tuple(rng.choice(links)),
                                       round(rng.uniform(*slowdown_range), 2)))
        for _ in range(stragglers):
            events.append(Straggler(step(), rng.randrange(n_ranks),
                                    round(rng.uniform(*factor_range), 2)))
        for _ in range(rank_losses):
            events.append(RankLost(step(), rng.randrange(n_ranks)))
        for _ in range(preempts):
            events.append(Preempt(step()))
        return cls(events=tuple(events), seed=seed)

    # -- compact CLI spelling ------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "FaultSchedule":
        """``kind@step[=args]`` items joined by ``;``:

        - ``degraded_link@5=0-1x3.0``  (edge 0-1, 3x slower from step 5)
        - ``rank_lost@10=r5``          (rank 5 dies before step 10)
        - ``straggler@7=r2x4.0``       (rank 2 runs 4x slower from step 7)
        - ``preempt@30``
        - ``chunk_loss@5=0.05``        (wire drops 5% of chunks from step 5;
          optional ``d``/``r`` suffixes add duplicate/reorder rates, e.g.
          ``chunk_loss@5=0.05d0.02r0.1``)

        Malformed items — an unknown kind, a missing/negative step, a
        missing or trailing argument, a slowdown/straggler factor below 1,
        a self-loop edge, an out-of-range loss rate — and exact duplicate
        events all raise ``ValueError`` naming the offending item: a bad
        compact string must never silently drop or double-fire an event.
        """
        events: list = []
        seen: set = set()
        for item in filter(None, (s.strip() for s in text.split(";"))):
            head, _, arg = item.partition("=")
            kind, at, step_s = head.partition("@")
            try:
                if not at or not step_s:
                    raise ValueError("missing '@step'")
                step = int(step_s)
                if step < 0:
                    raise ValueError(f"step must be >= 0, got {step}")
                if kind == "degraded_link":
                    edge_s, x, slow_s = arg.partition("x")
                    a_s, dash, b_s = edge_s.partition("-")
                    if not (x and dash):
                        raise ValueError("expected A-BxSLOWDOWN")
                    a, b, slow = int(a_s), int(b_s), float(slow_s)
                    if a == b:
                        raise ValueError(f"edge {a}-{b} is a self-loop")
                    if slow < 1.0:
                        raise ValueError(
                            f"slowdown must be >= 1, got {slow}")
                    ev = DegradedLink(step, (a, b), slow)
                elif kind == "rank_lost":
                    ev = RankLost(step, _parse_rank(arg))
                elif kind == "straggler":
                    rank_s, x, fac_s = arg.partition("x")
                    if not x:
                        raise ValueError("expected rRANKxFACTOR")
                    fac = float(fac_s)
                    if fac < 1.0:
                        raise ValueError(f"factor must be >= 1, got {fac}")
                    ev = Straggler(step, _parse_rank(rank_s), fac)
                elif kind == "preempt":
                    if arg:
                        raise ValueError(
                            f"preempt takes no argument, got {arg!r}")
                    ev = Preempt(step)
                elif kind == "chunk_loss":
                    ev = ChunkLoss(step, **_parse_rates(arg))
                else:
                    raise ValueError(f"unknown fault kind {kind!r}")
            except (ValueError, TypeError) as e:
                raise ValueError(f"bad fault item {item!r}: {e}") from None
            if ev in seen:
                raise ValueError(f"duplicate fault item {item!r}: the event "
                                 f"would fire twice")
            seen.add(ev)
            events.append(ev)
        return cls(events=tuple(events))

    # -- persistence ----------------------------------------------------
    def to_json(self) -> str:
        evs = []
        for e in self.events:
            d = dataclasses.asdict(e)
            d["kind"] = e.kind
            evs.append(d)
        return json.dumps({"version": SCHEDULE_VERSION, "seed": self.seed,
                           "events": evs}, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        payload = json.loads(text)
        if payload.get("version") != SCHEDULE_VERSION:
            raise ValueError(f"unsupported fault schedule version "
                             f"{payload.get('version')!r}")
        events = []
        for d in payload.get("events", ()):
            d = dict(d)
            klass = _KINDS[d.pop("kind")]
            if "edge" in d:
                d["edge"] = tuple(d["edge"])
            events.append(klass(**d))
        return cls(events=tuple(events), seed=payload.get("seed"))

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path) -> "FaultSchedule":
        return cls.from_json(Path(path).read_text())


def _parse_rank(arg: str) -> int:
    """``r5`` or ``5`` -> 5; anything else (``rr5``, ``r-1``, empty) raises."""
    s = arg[1:] if arg.startswith("r") else arg
    if not s.isdigit():
        raise ValueError(f"expected a rank like 'r5', got {arg!r}")
    return int(s)


def _parse_rates(arg: str) -> dict:
    """``0.05[d<dup>][r<reorder>]`` -> ChunkLoss rate kwargs."""
    out = {"drop": arg, "dup": "0", "reorder": "0"}
    rest = arg
    for key, mark in (("reorder", "r"), ("dup", "d")):
        head, sep, tail = rest.rpartition(mark)
        if sep:
            out[key] = tail
            rest = head
    out["drop"] = rest
    rates = {}
    for key, s in out.items():
        try:
            v = float(s)
        except ValueError:
            raise ValueError(f"bad {key} rate {s!r} in {arg!r}") from None
        if not 0.0 <= v < 1.0:
            raise ValueError(f"{key} rate must be in [0, 1), got {v}")
        rates[key] = v
    if not any(rates.values()):
        raise ValueError(f"chunk_loss needs a non-zero rate, got {arg!r}")
    return rates


def _torus_links(shape: tuple[int, int]) -> list[tuple[int, int]]:
    """All physical (cell, cell) single-hop links of an R x C torus."""
    rows, cols = shape
    links = set()
    for r in range(rows):
        for c in range(cols):
            cell = r * cols + c
            if cols > 1:
                right = r * cols + (c + 1) % cols
                links.add((min(cell, right), max(cell, right)))
            if rows > 1:
                down = ((r + 1) % rows) * cols + c
                links.add((min(cell, down), max(cell, down)))
    return sorted(links)


# ----------------------------------------------------------------------
# Injector
# ----------------------------------------------------------------------

class FaultInjector:
    """Fire a :class:`FaultSchedule` into a running step loop.

    The loop calls :meth:`poll` at every step boundary; the injector fires
    each event exactly once (events whose step was skipped over — e.g. a
    segment boundary every 10 steps — fire at the first boundary past
    them):

    - ``DegradedLink``  -> recorded in :attr:`active_slowdowns`; the caller
      rebuilds its wire plans via :meth:`degrade_spec` when :meth:`poll`
      returns a non-empty fired list.
    - ``Straggler``     -> host-side delay injected at the polled boundary
      (``sleep(base_step_s * (factor - 1))`` for the event's duration) —
      what the StepWatchdog measures and flags.
    - ``Preempt``       -> ``guard.request()`` (the software-triggered
      drain).
    - ``RankLost``      -> raises :class:`RankLostError` (after applying
      everything else due at the same boundary).
    """

    def __init__(self, schedule: FaultSchedule, base_step_s: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.schedule = schedule
        self.base_step_s = base_step_s
        self._sleep = sleep
        self._fired: set[int] = set()       # indices into schedule.events
        self.active_slowdowns: dict[tuple[int, int], float] = {}
        self._stragglers: list[Straggler] = []
        self._chunk_loss: dict[str, float] = {}
        self.fired_events: list = []

    def poll(self, step: int, guard=None) -> list:
        """Fire everything due at or before ``step``; returns the newly
        fired events (empty most steps).  Raises :class:`RankLostError`
        last, so same-boundary degradations/preempts are not lost."""
        fired: list = []
        lost: Optional[RankLost] = None
        for i, ev in enumerate(self.schedule.events):
            if i in self._fired or ev.step > step:
                continue
            self._fired.add(i)
            fired.append(ev)
            self.fired_events.append(ev)
            reg = obs_metrics.registry()
            reg.counter("faults.injected", kind=ev.kind).inc()
            if isinstance(ev, DegradedLink):
                a, b = ev.edge
                key = (min(a, b), max(a, b))
                self.active_slowdowns[key] = max(
                    ev.slowdown, self.active_slowdowns.get(key, 1.0))
            elif isinstance(ev, Straggler):
                self._stragglers.append(ev)
            elif isinstance(ev, ChunkLoss):
                for key in ("drop", "dup", "reorder"):
                    self._chunk_loss[key] = max(
                        getattr(ev, key), self._chunk_loss.get(key, 0.0))
            elif isinstance(ev, Preempt):
                if guard is not None:
                    guard.request()
            elif isinstance(ev, RankLost):
                lost = ev
        delay = self.straggler_delay_s(step)
        if delay > 0.0:
            self._sleep(delay)
        if lost is not None:
            raise RankLostError(lost.rank, step)
        return fired

    def straggler_delay_s(self, step: int) -> float:
        """Extra host time this boundary owes to active stragglers."""
        extra = 0.0
        for s in self._stragglers:
            if s.step <= step < s.step + s.duration:
                extra = max(extra, self.base_step_s * (s.factor - 1.0))
        return extra

    def wire_faults(self):
        """The chunk-level :class:`repro_torch.core.reliable.WireFaults`
        schedule the fired ``chunk_loss`` events imply (None while none has
        fired).  The caller activates it with ``reliable.inject`` around its
        runner's first call, which draws the runner's delivery plans — the
        wire-granularity extension of the step-level schedule.  Seeded from
        the FaultSchedule seed, so outcomes replay exactly."""
        if not self._chunk_loss:
            return None
        from repro_torch.core import reliable
        drop = self._chunk_loss.get("drop", 0.0)
        # A requested loss rate guarantees at least one observable loss:
        # the first transmission of the first message is pinned dropped, so
        # short traces (few messages on the wire) still exercise recovery
        # instead of depending on how early the seeded draws happen to hit.
        pinned = frozenset({(0, 0, 0)}) if drop > 0.0 else frozenset()
        return reliable.WireFaults(seed=self.schedule.seed or 0,
                                   drop=drop,
                                   dup=self._chunk_loss.get("dup", 0.0),
                                   reorder=self._chunk_loss.get("reorder", 0.0),
                                   drop_events=pinned)

    def degrade_spec(self, spec):
        """Fold the active link slowdowns into ``spec`` (a TorusSpec) —
        the wire-layer injection point.  Identity when nothing is active
        or there is no torus."""
        if spec is None or not self.active_slowdowns:
            return spec
        for (a, b), f in sorted(self.active_slowdowns.items()):
            spec = spec.with_link_slowdown(a, b, f)
        return spec

    def edge_latency_samples(self, step: int, edges: Sequence[tuple],
                             noise: float = 0.05) -> dict:
        """Synthetic per-edge latency telemetry (arbitrary units): 1.0 x
        the edge's active slowdown x seeded multiplicative noise.  This is
        the emulation stand-in for per-edge wire timing a real fabric
        exports; deterministic in (schedule seed, step, edge) so monitor
        tests replay exactly."""
        out = {}
        for a, b in edges:
            key = (min(int(a), int(b)), max(int(a), int(b)))
            # String seed: tuple seeds go through hash() and depend on
            # PYTHONHASHSEED — a fresh process would sample differently.
            rng = random.Random(f"{self.schedule.seed or 0}:{step}:{key}")
            base = self.active_slowdowns.get(key, 1.0)
            out[key] = base * (1.0 + rng.uniform(-noise, noise))
        return out


# ----------------------------------------------------------------------
# Degradation monitor
# ----------------------------------------------------------------------

class DegradationMonitor:
    """Hysteresis-gated detector of degraded-but-alive links.

    Feed it per-edge latency samples each step (:meth:`observe`); it keeps a
    per-edge EWMA baseline (updated only from samples it does NOT flag, so a
    degradation can't normalize itself into the baseline) and flags samples
    above ``threshold x baseline``.  An edge is **confirmed** — returned
    from :meth:`observe` exactly once per episode — only after ``hysteresis``
    consecutive flagged samples, and further confirmations for that edge are
    suppressed for ``cooldown`` steps after a switch: one noisy step never
    triggers re-selection, and steady noise never flaps it.

    It is also the obs substrate's decision consumer: :meth:`registry_deltas`
    reads ``comm.edge_bytes{hops=}`` and ``watchdog.stragglers`` deltas from
    the metrics registry since the last call.  :meth:`observe` skips streak
    updates when the registry shows no comm traffic since the last
    observation (``require_traffic=True``) — no evidence, no verdict — and
    exposes the straggler delta so a driver can couple watchdog pressure
    with edge flags.
    """

    def __init__(self, threshold: float = 1.5, hysteresis: int = 3,
                 cooldown: int = 20, alpha: float = 0.2,
                 retransmit_threshold: int = 0,
                 registry: Optional[obs_metrics.Registry] = None):
        if hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")
        self.threshold = threshold
        self.hysteresis = hysteresis
        self.cooldown = cooldown
        self.alpha = alpha
        # wire.retransmits deltas above this per observation count toward a
        # wire-degradation streak (0 = any retransmission is evidence).
        self.retransmit_threshold = retransmit_threshold
        self._reg = registry or obs_metrics.registry()
        self._baseline: dict[tuple, float] = {}
        self._streak: dict[tuple, int] = {}
        self._cooldown_until: dict[tuple, int] = {}
        self._last_counts: dict[str, float] = {}
        self.confirmed: set[tuple] = set()
        self.last_straggler_delta = 0
        self._wire_streak = 0
        self._wire_cooldown_until = -1
        self.last_retransmit_delta = 0
        self.wire_confirmed = False      # newly confirmed this observe()
        self.wire_confirmations = 0

    # -- obs substrate --------------------------------------------------
    def registry_deltas(self) -> dict:
        """Per-series deltas since the last call for the series the monitor
        consumes: ``comm.edge_bytes{hops=...}`` (keyed by hop distance) and
        ``watchdog.stragglers``."""
        snap = self._reg.find("comm.edge_bytes")
        snap["watchdog.stragglers"] = self._reg.counter(
            "watchdog.stragglers").value
        snap["wire.retransmits"] = self._reg.counter(
            "wire.retransmits").value
        deltas: dict = {"edge_bytes": {}, "stragglers": 0, "traffic": 0.0,
                        "retransmits": 0}
        for rendered, val in snap.items():
            prev = self._last_counts.get(rendered, 0)
            self._last_counts[rendered] = val
            d = val - prev
            name, labels = obs_metrics.parse_labels(rendered)
            if name == "comm.edge_bytes":
                hops = int(labels.get("hops", 1))
                deltas["edge_bytes"][hops] = (
                    deltas["edge_bytes"].get(hops, 0) + d)
                deltas["traffic"] += d
            elif name == "wire.retransmits":
                deltas["retransmits"] += d
            else:
                deltas["stragglers"] += d
        return deltas

    # -- detection ------------------------------------------------------
    def observe(self, step: int, edge_latency: dict,
                require_traffic: bool = False) -> list[tuple]:
        """Ingest one step's per-edge samples; returns edges *newly
        confirmed* degraded this step (usually empty)."""
        deltas = self.registry_deltas()
        self.last_straggler_delta = deltas["stragglers"]
        self._observe_wire(step, deltas["retransmits"])
        if require_traffic and deltas["traffic"] <= 0:
            return []
        confirmed_now: list[tuple] = []
        for edge, x in edge_latency.items():
            edge = (min(edge), max(edge))
            x = float(x)
            base = self._baseline.get(edge)
            if base is None:
                self._baseline[edge] = x
                self._streak[edge] = 0
                continue
            if x > self.threshold * base:
                self._streak[edge] = self._streak.get(edge, 0) + 1
            else:
                self._streak[edge] = 0
                # Only unflagged samples refresh the baseline: a slow edge
                # must not drag its own baseline up until it looks normal.
                self._baseline[edge] = (1 - self.alpha) * base + self.alpha * x
            if (self._streak[edge] >= self.hysteresis
                    and step >= self._cooldown_until.get(edge, -1)):
                self._cooldown_until[edge] = step + self.cooldown
                self._streak[edge] = 0
                self.confirmed.add(edge)
                confirmed_now.append(edge)
                self._reg.counter("monitor.confirmations").inc()
        return confirmed_now

    def _observe_wire(self, step: int, retransmit_delta: float) -> None:
        """The retransmit-rate degradation signal: sustained
        ``wire.retransmits`` growth across ``hysteresis`` consecutive
        observations confirms a lossy wire — same streak + cooldown
        discipline as the per-edge latency signal, surfaced via
        :attr:`wire_confirmed` for one observe() so the elastic loop can
        re-select loss-priced configs exactly once per episode."""
        self.last_retransmit_delta = retransmit_delta
        self.wire_confirmed = False
        if retransmit_delta > self.retransmit_threshold:
            self._wire_streak += 1
        else:
            self._wire_streak = 0
        if (self._wire_streak >= self.hysteresis
                and step >= self._wire_cooldown_until):
            self._wire_cooldown_until = step + self.cooldown
            self._wire_streak = 0
            self.wire_confirmed = True
            self.wire_confirmations += 1
            self._reg.counter("monitor.wire_confirmations").inc()

    def baseline(self, edge: tuple) -> Optional[float]:
        return self._baseline.get((min(edge), max(edge)))
