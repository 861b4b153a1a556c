"""Persistent autotuning results store and the auto-config selection API.

``TuneDB`` is a JSON-backed table of measured results keyed by
(topology, collective, message size).  ``select_config`` is the single entry
point every workload uses: given a collective, a message size, and the ranks
it will run on, return the fastest measured ``CommConfig`` — or fall back to
the paper's ``OPTIMIZED_CONFIG`` when the cache is cold.

The JSON file is the JAX package's format, field for field: either package
loads the other's file, and :func:`topology_key` keeps their entries apart.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.core.config import CommConfig, OPTIMIZED_CONFIG
from repro_torch.tune.space import config_from_dict

DB_VERSION = 1


def default_db_path() -> Path:
    """Resolve the TuneDB location (``REPRO_TUNE_DB`` env overrides)."""
    env = os.environ.get("REPRO_TUNE_DB")
    if env:
        return Path(env)
    return Path.cwd() / ".repro_tune" / "tunedb.json"


def topology_key(n_ranks: int | None = None, device=None) -> str:
    """Stable key for "the substrate this measurement ran on":
    ``torch-<device type>:<ranks>``, e.g. ``torch-cuda:8`` for 8 stacked
    ranks on the card.  ``device`` defaults to the card when one is present.

    The ``torch-`` prefix keeps the two packages apart in a shared TuneDB
    file: the JAX package keys its entries ``cpu:8``/``tpu:8`` and relaxes
    only to entries of the same platform, so neither package is ever
    answered by the other's measurements."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    platform = torch.device(device).type
    return f"torch-{platform}:{n_ranks if n_ranks is not None else 1}"


@dataclasses.dataclass
class TuneEntry:
    """One measured (collective, message size, config) data point."""
    topo: str
    collective: str
    msg_bytes: int
    config: dict                  # config_to_dict(CommConfig)
    us_per_call: float            # bare collective latency (latency_us)
    gbps: float = 0.0             # derived effective bandwidth
    # Worst-case torus hop distance of the measured pattern
    # (Communicator.torus_hops / max_hops): 1 = direct link, >1 = routed —
    # the paper's direct-link vs Ethernet-switch distinction.  Entries
    # measured at different hop distances are distinct data points.
    hops: int = 1
    # Virtual torus the measurement ran on (TorusSpec.name, e.g. "4x4" or
    # "2x4:snake"); "" = the substrate's native flat mesh.  Kept as a
    # distinct data point per emulated placement — two tori can produce the
    # same hop distance with different routing schedules.
    torus: str = ""
    # End-to-end seconds-per-iteration (µs) of the collective's consumer
    # loop (row_parallel matmul+reduce, halo-fold step) — what the paper's
    # §5 result says actually decides the scaling config.  0.0 = not
    # measured (latency-only sweep).
    e2e_us: float = 0.0
    # p95 of the sweep's per-rep samples (µs), from the same
    # ``sweep.us{collective=}`` histogram machinery the registry exports —
    # the dispersion the variance-aware selection breaks near-ties on.
    # 0.0 = not recorded (point-estimate-only entry).
    p95_us: float = 0.0
    # Injected per-transmission chunk-loss rate the measurement ran under
    # (sweep --loss-rate); 0.0 = clean wire.  Entries measured under
    # different loss rates are distinct data points — the jumbo-vs-segment
    # winner flips with loss, so a lossy-wire answer must come from a
    # lossy-wire measurement.
    loss: float = 0.0
    # Which consumer loop produced ``e2e_us`` ("row_parallel",
    # "decode_step", "prefill", "halo_fold", "moe_loop"; "" = bare-latency
    # entry).  One collective serves phases with opposite cost structures —
    # decode's tiny latency-bound per-token combines vs prefill's
    # throughput-bound bulk reduces — so each consumer's measurement is a
    # distinct data point and selection prefers a matching one.
    consumer: str = ""

    @property
    def latency_us(self) -> float:
        """Bare collective latency — alias of ``us_per_call``."""
        return self.us_per_call

    @property
    def comm_config(self) -> CommConfig:
        return config_from_dict(self.config)

    def key(self) -> tuple:
        return (self.topo, self.collective, self.msg_bytes)

    def metric(self, objective: str = "latency") -> float:
        """Ranking metric for ``objective`` (µs); e2e falls back to bare
        latency for entries without a consumer-loop measurement."""
        if objective == "e2e" and self.e2e_us > 0.0:
            return self.e2e_us
        return self.us_per_call


class TuneDB:
    """In-memory table of TuneEntry, one *best* entry per (key, config).

    ``add`` keeps every distinct config's measurement (so calibration can fit
    across the whole space) but ``best``/``nearest`` answer with the fastest.
    """

    def __init__(self, entries: Sequence[TuneEntry] = ()):
        self.entries: list[TuneEntry] = list(entries)

    def __len__(self) -> int:
        return len(self.entries)

    def add(self, entry: TuneEntry) -> None:
        cfg_key = tuple(sorted(entry.config.items()))
        for i, e in enumerate(self.entries):
            if (e.key() == entry.key() and e.hops == entry.hops
                    and e.torus == entry.torus and e.loss == entry.loss
                    and e.consumer == entry.consumer
                    and tuple(sorted(e.config.items())) == cfg_key):
                # Merge: fastest latency wins; an e2e measurement is kept
                # even when it rides a slower latency rerun (and the
                # fastest e2e wins when both entries carry one).  p95
                # follows the winning latency measurement (dispersion is a
                # property of the run that produced the point estimate).
                e2e = (min(e.e2e_us, entry.e2e_us)
                       if e.e2e_us > 0.0 and entry.e2e_us > 0.0
                       else max(e.e2e_us, entry.e2e_us))
                best = entry if entry.us_per_call < e.us_per_call else e
                self.entries[i] = dataclasses.replace(best, e2e_us=e2e)
                return
        self.entries.append(entry)

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------
    def candidates(self, collective: str, topo: str | None = None,
                   hops: int | None = None,
                   torus: str | None = None,
                   loss: float | None = None,
                   consumer: str | None = None) -> list[TuneEntry]:
        """Entries for ``collective`` (optionally per topology).

        With ``torus`` given (a ``TorusSpec.name``), prefer entries measured
        on that virtual placement: a flat-mesh "2-hop" ring measurement never
        routed and must not outrank a routed 2-hop measurement when the
        caller IS on the torus (and vice versa); when none match, relax to
        every entry.  With ``hops`` given, prefer entries measured at
        exactly that hop distance; when none exist, relax to the nearest
        measured distance — a 3-hop edge is better served by a 2-hop
        measurement than a 1-hop one (the direct-link vs routed cost
        structures differ).  ``loss`` works the same way for the injected
        chunk-loss rate: a lossy caller prefers lossy-wire measurements
        (jumbo frames win clean links, small segments win lossy ones) and
        relaxes to the nearest measured rate.  ``consumer`` prefers entries
        whose ``e2e_us`` was measured inside that consumer loop (a decode
        caller must not be answered by a prefill-loop measurement when a
        decode-loop one exists) and relaxes to every entry when the
        consumer was never swept.
        """
        cands = [e for e in self.entries
                 if e.collective == collective
                 and (topo is None or e.topo == topo)]
        if consumer is not None:
            matched = [e for e in cands if e.consumer == consumer]
            if matched:
                cands = matched
        if torus is not None:
            matched = [e for e in cands if e.torus == torus]
            if matched:
                cands = matched
        if loss is not None and cands:
            matched = [e for e in cands if e.loss == loss]
            if matched:
                cands = matched
            else:
                nearest_l = min({e.loss for e in cands},
                                key=lambda l: abs(l - loss))
                cands = [e for e in cands if e.loss == nearest_l]
        if hops is not None and cands:
            matched = [e for e in cands if e.hops == hops]
            if matched:
                return matched
            nearest_h = min({e.hops for e in cands},
                            key=lambda h: abs(h - hops))
            return [e for e in cands if e.hops == nearest_h]
        return cands

    #: Entries within this fraction of the best metric are a "near-tie" and
    #: re-rank by measured p95 — the variance-aware slice of selection: two
    #: configs indistinguishable on the mean are distinguishable on tail
    #: latency, which is what the latency-sensitive paths feel.
    NEAR_TIE = 0.05

    @classmethod
    def _rank(cls, entries: list[TuneEntry], objective: str
              ) -> Optional[TuneEntry]:
        """Fastest entry under ``objective``.  For ``e2e``, entries with a
        measured consumer-loop time outrank latency-only entries (a measured
        e2e beats a proxy); with none measured, fall back to bare latency.
        Entries within :data:`NEAR_TIE` of the winner's metric break the
        tie on recorded ``p95_us``; entries without a recorded p95 cannot
        win a near-tie (an unknown tail never beats a measured one), and a
        DB with no dispersion recorded ranks exactly as before."""
        if not entries:
            return None
        metric = None
        if objective == "e2e":
            with_e2e = [e for e in entries if e.e2e_us > 0.0]
            if with_e2e:
                entries = with_e2e
                metric = lambda e: e.e2e_us  # noqa: E731
        if metric is None:
            metric = lambda e: e.us_per_call  # noqa: E731
        best = min(entries, key=metric)
        near = [e for e in entries
                if metric(e) <= metric(best) * (1.0 + cls.NEAR_TIE)]
        with_p95 = [e for e in near if e.p95_us > 0.0]
        if len(near) > 1 and with_p95:
            # Variance-aware: the lowest measured tail wins the near-tie.
            # Entries without recorded dispersion cannot win it — an
            # unknown tail must not beat a measured one on missing data.
            return min(with_p95, key=lambda e: (e.p95_us, metric(e)))
        return best

    def best(self, collective: str, msg_bytes: int, topo: str | None = None,
             hops: int | None = None, objective: str = "latency",
             torus: str | None = None,
             loss: float | None = None,
             consumer: str | None = None) -> Optional[TuneEntry]:
        """Fastest entry at exactly ``msg_bytes`` (None if not measured)."""
        exact = [e for e in self.candidates(collective, topo, hops, torus,
                                            loss, consumer)
                 if e.msg_bytes == msg_bytes]
        return self._rank(exact, objective)

    def nearest(self, collective: str, msg_bytes: int, topo: str | None = None,
                hops: int | None = None, objective: str = "latency",
                torus: str | None = None,
                loss: float | None = None,
                consumer: str | None = None) -> Optional[TuneEntry]:
        """Fastest entry at the measured message size closest (in log space)
        to ``msg_bytes`` — message-size behaviour is scale-free, so log
        distance is the right metric (1 KiB is "nearer" 4 KiB than 64 KiB)."""
        cands = self.candidates(collective, topo, hops, torus, loss, consumer)
        if not cands:
            return None
        target = math.log(max(1, msg_bytes))
        nearest_size = min({e.msg_bytes for e in cands},
                           key=lambda s: abs(math.log(max(1, s)) - target))
        exact = [e for e in cands if e.msg_bytes == nearest_size]
        return self._rank(exact, objective)

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save(self, path: os.PathLike | str | None = None) -> Path:
        path = Path(path) if path is not None else default_db_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"version": DB_VERSION,
                   "entries": [dataclasses.asdict(e) for e in self.entries]}
        # Unique temp name + atomic replace: two processes saving the same
        # DB concurrently never collide on the temp file or tear the target.
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
        tmp.replace(path)
        return path

    @classmethod
    def load(cls, path: os.PathLike | str | None = None) -> "TuneDB":
        """Load a DB; a missing, torn, corrupt, or schema-incompatible file
        yields an empty DB (the sweep rebuilds and overwrites) — a damaged
        cache must never take the tuner down."""
        path = Path(path) if path is not None else default_db_path()
        if not path.exists():
            return cls()
        try:
            payload = json.loads(path.read_text())
            if payload.get("version") != DB_VERSION:
                return cls()
            return cls([TuneEntry(**e) for e in payload.get("entries", ())])
        except (OSError, ValueError, TypeError):
            return cls()


def select_config(collective: str, msg_bytes: int, n_ranks: int | None = None,
                  db: TuneDB | None = None,
                  path: os.PathLike | str | None = None,
                  topo: str | None = None,
                  hops: int | None = None,
                  objective: str = "latency",
                  torus: str | None = None,
                  loss: float | None = None,
                  consumer: str | None = None,
                  fallback: CommConfig = OPTIMIZED_CONFIG) -> CommConfig:
    """The autotuner's answer to "how should I communicate?".

    Looks up the fastest measured config for (collective, msg_bytes) on this
    topology (``topo``, or ``topology_key(n_ranks)``); with ``hops`` given, prefers measurements taken at the same
    torus hop distance (multi-hop edges may want a different transport or
    window than direct links — the paper's direct-link vs Ethernet-switch
    distinction); relaxes to other device counts on the SAME platform (a
    config tuned on another platform's cost structure is worse than no
    tuning); falls back to the paper's ``OPTIMIZED_CONFIG`` on a cold cache
    so callers can unconditionally pass ``comm_cfg="auto"``.

    ``objective`` selects the ranking metric: ``"latency"`` (bare collective
    microbenchmark — the default) or ``"e2e"`` (the measured consumer-loop
    wall clock, ``TuneEntry.e2e_us``).  The paper's §5 finding is exactly
    that these disagree when the consumer has hideable compute: the config
    that wins the microbench is not the one that scales the application.
    Entries without an e2e measurement rank by bare latency under either
    objective.

    ``torus`` (a ``TorusSpec.name``, e.g. ``"4x4"``) prefers entries
    measured on that virtual placement: a caller routing over an emulated
    torus must not be answered by an unrouted flat-mesh measurement that
    happens to share a hop count (and relaxes to any entry when that
    placement was never swept).

    ``loss`` prefers entries measured under that injected chunk-loss rate
    (nearest measured rate when no exact match): on a lossy wire the
    GUARANTEED small-segment configs that looked slow on the clean sweep
    are the ones that actually win, and only lossy-wire measurements can
    say so.

    ``consumer`` names the caller's consumer loop ("decode_step",
    "prefill", "row_parallel", ...): entries whose ``e2e_us`` was measured
    inside that loop are preferred, which is how serving's two phases
    resolve *different* configs from the same TuneDB — a latency-bound
    decode step and a throughput-bound prefill disagree about the winner
    even at the same message size.
    """
    if objective not in ("latency", "e2e"):
        raise ValueError(f"objective must be 'latency' or 'e2e', "
                         f"got {objective!r}")
    if db is None:
        db = TuneDB.load(path)
    if topo is None:
        topo = topology_key(n_ranks)
    platform = topo.split(":", 1)[0]
    entry = (db.best(collective, msg_bytes, topo, hops, objective, torus,
                     loss, consumer)
             or db.nearest(collective, msg_bytes, topo, hops, objective,
                           torus, loss, consumer))
    if entry is None:
        same_platform = TuneDB([e for e in db.entries
                                if e.topo.split(":", 1)[0] == platform])
        entry = same_platform.nearest(collective, msg_bytes, None, hops,
                                      objective, torus, loss, consumer)
    if entry is None:
        return fallback
    return entry.comm_config
