"""Measured configuration sweeps — the b_eff synthetic benchmark, automated.

For every (collective, message size, candidate ``CommConfig``) triple the
engine builds the collective on ``n_ranks`` stacked ranks, times it with
warm-up and records the result in a :class:`~repro_torch.tune.db.TuneDB`.
Scheduling is honoured the way the runtime honours it:

- fused and overlapped configs are device-scheduled: ``inner`` ops are
  captured as ONE CUDA graph, replayed ``reps`` times and timed with CUDA
  events;
- host-scheduled configs run eagerly with ``torch.cuda.synchronize()`` after
  every op, timed with the host clock;
- on the CPU (``device="cpu"``, the tests) both run eagerly under
  ``time.perf_counter``.

CLI (the card by default; ``--device cpu`` for the plain path)::

    PYTHONPATH=src python -m repro_torch.tune.sweep --fast --calibrate
    PYTHONPATH=src python -m repro_torch.tune.sweep --sizes 1024,65536 \\
        --collectives all_reduce,sendrecv --out .repro_tune/tunedb.json
    # virtual 4x4 torus, per-edge hop-distance axis (TuneEntry.hops)
    PYTHONPATH=src python -m repro_torch.tune.sweep --ranks 16 \\
        --topology 4x4 --hop-distances 1,2,4 --collectives sendrecv
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from contextlib import nullcontext
from typing import Callable, Sequence

import torch

from repro_torch.core import collectives, reliable
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import H100, CommConfig, Reliability, Scheduling
from repro_torch.core.topology import TorusSpec
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.tune import prune as tune_prune
from repro_torch.tune import space as tune_space
from repro_torch.tune.db import TuneDB, TuneEntry, default_db_path, topology_key

# Message sizes (bytes per rank) swept by default — the paper's Fig. 4 spans
# 64 B .. 4 MiB.
FULL_SIZES = (1 << 10, 1 << 14, 1 << 17, 1 << 20)
FAST_SIZES = (1 << 10, 1 << 14)
# "small" smoke set: one mid + one large size, so the pruning model still
# sees the bandwidth/segmentation-separated regime.
NAMED_SIZES = {"small": (1 << 14, 1 << 20), "full": FULL_SIZES}

SWEEPABLE = ("sendrecv", "all_reduce", "all_gather", "reduce_scatter",
             "multi_neighbor", "all_to_all")

# Collectives with end-to-end consumer-loop benchmarks (the hideable-compute
# consumers of the paper's §5 argument).  Under ``--objective e2e`` each
# consumer is measured and recorded as its own TuneEntry (tagged
# ``TuneEntry.consumer``).  all_reduce's and all_to_all's consumers (the
# tensor-parallel layers, the serving phases, the MoE loop) come with the
# port's LM path.
CONSUMERS: dict[str, tuple[str, ...]] = {
    "multi_neighbor": ("halo_fold",),
}

# Collectives whose benchmark pattern is parameterized by a torus hop
# distance (the --hop-distances axis): the perm is a translation of the
# whole virtual torus by exactly d hops.
HOP_PATTERNED = ("sendrecv", "multi_neighbor")

OBJECTIVES = ("latency", "e2e")


def consumer_flops(collective: str, msg_bytes: int) -> float:
    """Hideable per-iteration compute (FLOPs) of a collective's consumer
    loop — feeds the e2e prediction (compute_s = flops / peak)."""
    if collective == "multi_neighbor":
        # elementwise interior update over the state (~12 flops/element)
        return 12.0 * (msg_bytes / 4.0)
    return 0.0


# ----------------------------------------------------------------------
# Microbenchmark builders
# ----------------------------------------------------------------------

def _payload_elems(msg_bytes: int, n: int) -> int:
    """float32 elements per rank, padded to a multiple of the rank count so
    reduce-scatter/all-to-all constraints hold for every collective."""
    elems = max(n, msg_bytes // 4)
    return elems + (-elems) % n


def _multi_neighbor_rounds(comm) -> list:
    """The 4-neighbor halo pattern (ring distance ±1, ±2) — the SWE
    exchange."""
    return [comm.ring_perm(1), comm.reverse_ring_perm(1),
            comm.ring_perm(2), comm.reverse_ring_perm(2)]


def _pattern_hops(collective: str, comm) -> int:
    """Worst-case torus hop distance of the pattern a collective exercises
    (recorded per TuneEntry so selection can prefer hop-matched results)."""
    if collective == "multi_neighbor":
        return comm.max_hops(
            [e for r in _multi_neighbor_rounds(comm) for e in r])
    if collective == "all_to_all":
        # every rank exchanges with every other rank
        return max((comm.torus_hops(0, j) for j in range(comm.size)),
                   default=0) or 1
    return comm.max_hops(comm.ring_perm())


def _hop_rounds(comm, hop_distance: int) -> list:
    return [comm.hop_perm(hop_distance),
            comm.topo.reverse_hop_perm(hop_distance)]


def _per_rank_total(y: torch.Tensor) -> torch.Tensor:
    """``(n, 1)`` sum of each rank's result: the benchmark ops feed it back
    at zero weight so that every op's result is consumed."""
    return y.reshape(y.shape[0], -1).sum(1, keepdim=True)


def _build_op(collective: str, comm, cfg: CommConfig,
              hop_distance: int | None = None) -> Callable:
    """Stacked ``(n, elems)`` -> same-shaped tensor exercising one
    collective op.  ``hop_distance`` (virtual torus only) replaces the
    hop-patterned collectives' default edge list with a translation perm at
    exactly that many torus hops."""
    if hop_distance is not None and collective not in HOP_PATTERNED:
        raise ValueError(f"{collective!r} has no hop-parameterized pattern "
                         f"(hop-patterned: {HOP_PATTERNED})")
    if collective == "sendrecv":
        perm = (comm.hop_perm(hop_distance) if hop_distance is not None
                else comm.ring_perm())

        def op(x):
            return collectives.sendrecv(x, perm, comm, cfg)
    elif collective == "all_reduce":
        def op(x):
            return collectives.all_reduce(x, comm, cfg) / comm.size
    elif collective == "all_gather":
        def op(x):
            y = collectives.all_gather(x, comm, cfg, axis=0)
            return x + 0.0 * _per_rank_total(y)
    elif collective == "reduce_scatter":
        def op(x):
            y = collectives.reduce_scatter(x, comm, cfg)
            return x + 0.0 * _per_rank_total(y)
    elif collective == "multi_neighbor":
        mn_rounds = (_hop_rounds(comm, hop_distance)
                     if hop_distance is not None
                     else _multi_neighbor_rounds(comm))

        def op(x):
            outs = collectives.multi_neighbor_exchange(
                [x] * len(mn_rounds), mn_rounds, comm, cfg)
            return sum(outs) / len(outs)
    elif collective == "all_to_all":
        def op(x):
            # (n, elems/n) bucketed payload per rank — the MoE dispatch shape
            y = collectives.all_to_all(x.reshape(x.shape[0], comm.size, -1),
                                       comm, cfg)
            return x + 0.0 * _per_rank_total(y)
    else:
        raise ValueError(f"unknown collective {collective!r} "
                         f"(sweepable: {SWEEPABLE})")
    return op


def _build_consumer_op(collective: str, comm, cfg: CommConfig,
                       msg_bytes: int, hop_distance: int | None = None,
                       consumer: str | None = None
                       ) -> tuple[Callable, tuple]:
    """One iteration of the collective's consumer loop: ``(op,
    per_rank_shape)``.  The halo fold: a 4-neighbor exchange, a fold of the
    received halos, and an interior update the overlapped schedule can issue
    while the exchange is in flight."""
    if consumer is None:
        consumer = (CONSUMERS.get(collective) or ("",))[0]
    if collective != "multi_neighbor" or consumer != "halo_fold":
        raise ValueError(f"no consumer-loop benchmark {consumer!r} for "
                         f"{collective!r} (consumers: {CONSUMERS})")
    rounds = (_hop_rounds(comm, hop_distance) if hop_distance is not None
              else _multi_neighbor_rounds(comm))
    elems = _payload_elems(msg_bytes, comm.size)

    def op(x):
        payloads = [x] * len(rounds)
        interior = x * 0.999 + 0.001 * torch.tanh(x)     # hideable compute
        if cfg.scheduling == Scheduling.OVERLAPPED:
            halo, _ = collectives.multi_neighbor_exchange(
                payloads, rounds, comm, cfg,
                consume=lambda c, r, m: c + m, init=torch.zeros_like(x))
        else:
            halo = sum(collectives.multi_neighbor_exchange(
                payloads, rounds, comm, cfg))
        return interior + 1e-3 * torch.tanh(halo)

    return op, (elems,)


# Per-rep seconds of the most recent _time_program call.  The sweep reads
# this right after each measurement to estimate the candidate's tail
# (TuneEntry.p95_us); injected test timers never populate it, so the sweep's
# p95 falls back to 0.0 (the "no tail data" sentinel) — run_sweep clears the
# list before every timer call.
_LAST_SAMPLES: list[float] = []


def _time_program(op: Callable, n_ranks: int, msg_bytes: int,
                  cfg: CommConfig, device=None, warmup: int = 1,
                  reps: int = 3, inner: int = 8,
                  per_dev_shape: tuple | None = None,
                  hops: int = 1) -> float:
    """Seconds per collective op under the config's scheduling discipline,
    on ``n_ranks`` stacked ranks of a zero f32 message on ``device``.

    On the card, fused and overlapped configs capture ``inner`` chained ops
    as one CUDA graph (after ``warmup`` eager ops, which build the kernels
    and fill the plan caches) and time ``reps`` replays with CUDA events;
    host-scheduled configs synchronize after every op and read the host
    clock.  On the CPU every op runs eagerly under ``perf_counter``.  Each
    rep's per-op seconds go to :data:`_LAST_SAMPLES`.  ``hops`` (the
    pattern's hop distance) is for model timers; the clock needs none, the
    routed permutes pay it.
    """
    device = resolve_device(device)
    if per_dev_shape is None:
        per_dev_shape = (_payload_elems(msg_bytes, n_ranks),)
    x = torch.zeros((n_ranks,) + tuple(per_dev_shape), dtype=torch.float32,
                    device=device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        x = op(x)
    sync()
    del _LAST_SAMPLES[:]
    if cuda and cfg.scheduling != Scheduling.HOST:
        # fused and overlapped are both device-scheduled: one graph launch
        # amortized over `inner` ops
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = x
            for _ in range(inner):
                y = op(y)
        graph.replay()
        sync()
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            _LAST_SAMPLES.append(a.elapsed_time(b) * 1e-3 / inner)
        return sum(_LAST_SAMPLES) / len(_LAST_SAMPLES)
    # Host scheduling (and the CPU): one op at a time, the host waits for
    # each before issuing the next.
    t0 = time.perf_counter()
    for _ in range(reps):
        t1 = time.perf_counter()
        for _ in range(inner):
            x = op(x)
            sync()
        _LAST_SAMPLES.append((time.perf_counter() - t1) / inner)
    return (time.perf_counter() - t0) / (reps * inner)


# ----------------------------------------------------------------------
# Sweep driver
# ----------------------------------------------------------------------

def _seed_calibration(comm, db: TuneDB, topo: str, sizes: Sequence[int],
                      reps: int, inner: int, log: Callable[[str], None],
                      timer, device, torus: str = ""):
    """Cold-cache calibration seed: measure the sendrecv corner configs so
    the Eq. 1 fit has points on THIS substrate before pruning starts.  The
    seed measurements are real TuneDB entries (they also serve selection)."""
    log("[prune] cold cache: seeding Eq.1 calibration with a sendrecv "
        "corner sweep")
    hops = _pattern_hops("sendrecv", comm)
    for msg_bytes in sizes:
        for cfg in tune_space.enumerate_configs("sendrecv", fast=True):
            op = _build_op("sendrecv", comm, cfg)
            sec = timer(op, comm.size, msg_bytes, cfg, device=device,
                        reps=reps, inner=inner, hops=hops)
            db.add(TuneEntry(
                topo=topo, collective="sendrecv", msg_bytes=int(msg_bytes),
                config=tune_space.config_to_dict(cfg),
                us_per_call=sec * 1e6, gbps=msg_bytes / sec / 1e9,
                hops=hops, torus=torus))
    return tune_prune.calibration_from_db(db, topo)


def run_sweep(n_ranks: int = 8, collectives: Sequence[str] = SWEEPABLE,
              sizes: Sequence[int] | None = None, fast: bool = False,
              db: TuneDB | None = None, max_configs: int | None = None,
              reps: int = 3, inner: int = 8,
              log: Callable[[str], None] | None = None,
              prune: bool = False,
              prune_ratio: float = tune_prune.DEFAULT_RATIO,
              calibration=None,
              objective: str = "latency",
              stats: dict | None = None,
              topology: TorusSpec | None = None,
              hop_distances: Sequence[int] | None = None,
              loss_rate: float = 0.0,
              timer: Callable | None = None,
              device=None) -> TuneDB:
    """Measure every candidate config on ``n_ranks`` stacked ranks of
    ``device`` (default: the card) and return the populated TuneDB.

    ``prune=True`` enables the paper-style model-guided search: an Eq. 1
    calibration (fitted from existing sendrecv entries, or from a small seed
    sweep on a cold cache) predicts every candidate's latency and the sweep
    skips configs ranked more than ``prune_ratio``× off the predicted
    incumbent.  ``stats`` (optional dict) receives the bookkeeping:
    candidate/measured/pruned counts and wall clock, and the estimated
    exhaustive wall clock the pruning saved.

    ``objective="e2e"`` additionally measures each candidate inside the
    collectives' consumer loops (:data:`CONSUMERS`), one tagged
    ``TuneEntry`` per consumer, and keeps consumer-distinct candidates
    (overlapped scheduling) in the space.

    ``topology`` places the ranks on a virtual multi-hop torus: multi-hop
    edges route through intermediate ranks, so measured latency carries the
    per-hop cost.  ``hop_distances`` adds the per-edge sweep axis — the
    hop-patterned collectives are measured once per distance with
    ``TuneEntry.hops`` recording it.

    ``loss_rate`` > 0 sweeps a LOSSY wire: every candidate is forced to
    ``Reliability.GUARANTEED`` (best-effort delivery cannot survive chunk
    loss), each measurement runs under the seeded
    :class:`~repro_torch.core.reliable.WireFaults` chunk-drop schedule at
    that rate (``inject`` resets the message counter per measurement, so
    every candidate faces the same drop pattern), and entries record
    ``TuneEntry.loss`` so selection can prefer configs measured on a
    matching wire — the sweep half of the paper's "jumbo frames win clean
    links, small segments win lossy ones".

    ``timer`` overrides the measurement function (signature of
    :func:`_time_program`) — deterministic model-driven timers make the
    selection pipeline testable end to end without a clock.  A measurement
    that raises fails the sweep.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, "
                         f"got {objective!r}")
    if not 0.0 <= loss_rate < 1.0:
        raise ValueError(f"loss_rate must be in [0, 1), got {loss_rate}")
    wire = (reliable.WireFaults(seed=17, drop=loss_rate)
            if loss_rate > 0.0 else None)
    device = resolve_device(device)
    if sizes is None:
        sizes = FAST_SIZES if fast else FULL_SIZES
    if db is None:
        db = TuneDB()
    if fast:
        reps, inner = min(reps, 2), min(inner, 4)
    log = log or (lambda s: None)
    timer = timer or _time_program
    stats = stats if stats is not None else {}
    stats.update(total=0, measured=0, pruned=0, e2e_measured=0, wall_s=0.0)
    reg = obs_metrics.registry()
    reg.counter("sweep.runs").inc()
    cache_ctrs = {k: reg.counter(f"plans.{k}")
                  for k in ("plan_hits", "plan_misses")}
    cache_before = {k: int(c.value) for k, c in cache_ctrs.items()}
    t_start = time.perf_counter()

    comm = Communicator(("x",), (n_ranks,), topo=topology)
    topo = topology_key(n_ranks, device)
    torus = topology.name if topology is not None else ""
    if hop_distances is not None:
        if topology is None:
            raise ValueError("--hop-distances requires --topology "
                             "(hop distances live on a virtual torus)")
        bad = [d for d in hop_distances
               if not 1 <= d <= topology.diameter]
        if bad:
            raise ValueError(f"hop distances {bad} outside this torus's "
                             f"[1, {topology.diameter}]")

    if prune and calibration is None:
        calibration = tune_prune.calibration_from_db(db, topo)
        if calibration is None:
            # Seed wall clock is calibration overhead, not sweep time.
            t_seed = time.perf_counter()
            calibration = _seed_calibration(comm, db, topo, sizes, reps,
                                            inner, log, timer, device,
                                            torus=torus)
            stats["seed_s"] = time.perf_counter() - t_seed
        if calibration is None:
            log("[prune] calibration unavailable — sweeping exhaustively")
        else:
            log(f"[prune] {calibration.summary()}")

    for coll in collectives:
        cands = tune_space.enumerate_configs(coll, fast=fast,
                                             objective=objective)
        if wire is not None:
            # Best-effort candidates cannot deliver under chunk loss:
            # promote everything to GUARANTEED and dedup (promotion can
            # collide candidates that differed only in reliability).
            forced = []
            for c in cands:
                g = dataclasses.replace(c,
                                        reliability=Reliability.GUARANTEED)
                if g not in forced:
                    forced.append(g)
            cands = forced
        if max_configs is not None:
            cands = cands[:max_configs]
        if hop_distances is not None and coll in HOP_PATTERNED:
            distances: list[int | None] = list(hop_distances)
        else:
            distances = [None]
        consumers = CONSUMERS.get(coll, ()) if objective == "e2e" else ()
        for hop_d in distances:
            hops = hop_d if hop_d is not None else _pattern_hops(coll, comm)
            log(f"[{topo}{'/' + torus if torus else ''}] {coll}: "
                f"{len(cands)} configs x {len(sizes)} sizes "
                f"(pattern hops={hops}"
                + (f", e2e consumers={','.join(consumers)}"
                   if consumers else "") + ")")
            for msg_bytes in sizes:
                stats["total"] += len(cands)
                to_measure = cands
                if prune and calibration is not None:
                    compute_s = (consumer_flops(coll, msg_bytes)
                                 / H100.peak_flops if consumers else 0.0)
                    to_measure, skipped = tune_prune.prune_candidates(
                        cands, msg_bytes, calibration, prune_ratio,
                        collective=coll,
                        objective="e2e" if consumers else "latency",
                        compute_s=compute_s, hops=hops, loss=loss_rate)
                    stats["pruned"] += len(skipped)
                    reg.counter("sweep.pruned").inc(len(skipped))
                    if skipped:
                        log(f"  prune {coll}/{msg_bytes}B: measuring "
                            f"{len(to_measure)}/{len(cands)} (model skipped "
                            f"{len(skipped)})")
                for i, cfg in enumerate(to_measure):
                    op = _build_op(coll, comm, cfg, hop_distance=hop_d)
                    del _LAST_SAMPLES[:]
                    with obs_trace.span("sweep.candidate", cat="sweep",
                                        collective=coll,
                                        msg_bytes=int(msg_bytes),
                                        hops=hops, cfg=i) as sp, (
                            reliable.inject(wire) if wire is not None
                            else nullcontext()):
                        sec = timer(op, n_ranks, msg_bytes, cfg,
                                    device=device, reps=reps, inner=inner,
                                    hops=hops)
                        sp.set(us_per_call=sec * 1e6)
                    # Per-rep samples feed both the aggregate series and
                    # this candidate's tail estimate; timers that report
                    # only a mean contribute that single point.
                    samples = [s * 1e6 for s in _LAST_SAMPLES]
                    hist = reg.histogram("sweep.us", collective=coll)
                    for v in (samples or [sec * 1e6]):
                        hist.observe(v)
                    p95_us = obs_metrics.percentile_of(samples, 95.0)
                    consumer_e2e: dict[str, float] = {}
                    for consumer in consumers:
                        cop, shape = _build_consumer_op(
                            coll, comm, cfg, msg_bytes, hop_distance=hop_d,
                            consumer=consumer)
                        with (reliable.inject(wire) if wire is not None
                              else nullcontext()):
                            e2e_sec = timer(cop, n_ranks, msg_bytes, cfg,
                                            device=device, reps=reps,
                                            inner=inner, per_dev_shape=shape,
                                            hops=hops)
                        consumer_e2e[consumer] = e2e_sec * 1e6
                        stats["e2e_measured"] += 1
                        reg.histogram("sweep.e2e_us",
                                      collective=coll).observe(e2e_sec * 1e6)
                    stats["measured"] += 1
                    for consumer, e2e_us in (consumer_e2e.items()
                                             or ((None, 0.0),)):
                        db.add(TuneEntry(
                            topo=topo, collective=coll,
                            msg_bytes=int(msg_bytes),
                            config=tune_space.config_to_dict(cfg),
                            us_per_call=sec * 1e6,
                            gbps=msg_bytes / sec / 1e9,
                            hops=hops, e2e_us=e2e_us, torus=torus,
                            p95_us=p95_us, loss=loss_rate,
                            consumer=consumer or ""))
                best = db.best(coll, msg_bytes, topo, hops=hops)
                if best is not None:
                    log(f"  {coll:15s} {msg_bytes:>8d}B h{hops} best "
                        f"{best.us_per_call:9.1f} us  ({best.gbps:6.3f} GB/s)  "
                        f"{best.config['mode']}/{best.config['scheduling']}"
                        f"/{best.config['algorithm']}")
                for consumer in consumers:
                    be = db.best(coll, msg_bytes, topo, hops=hops,
                                 objective="e2e", consumer=consumer)
                    if be is not None and be.e2e_us > 0.0:
                        log(f"  {coll:15s} {msg_bytes:>8d}B h{hops} best e2e "
                            f"{be.e2e_us:9.1f} us/iter ({consumer}) "
                            f"{be.config['mode']}/{be.config['scheduling']}")
    stats["wall_s"] = time.perf_counter() - t_start
    for k, c in cache_ctrs.items():
        stats[k] = int(c.value) - cache_before[k]
    stats["latency_hist"] = reg.find("sweep.us{")
    if stats["measured"]:
        sweep_s = stats["wall_s"] - stats.get("seed_s", 0.0)
        stats["est_exhaustive_s"] = sweep_s * stats["total"] / stats["measured"]
    return db


def sweep_summary(stats: dict) -> str:
    """One-line wall-clock summary (exhaustive vs calibration-pruned), plus
    the plan-cache hit/miss counts."""
    line = (f"sweep wall clock {stats.get('wall_s', 0.0):.1f}s: measured "
            f"{stats.get('measured', 0)}/{stats.get('total', 0)} candidate "
            f"configs")
    if stats.get("e2e_measured"):
        line += f" ({stats['e2e_measured']} consumer-loop e2e)"
    if stats.get("pruned"):
        line += (f" — {stats['pruned']} pruned by the calibrated model "
                 f"(exhaustive est. ~{stats.get('est_exhaustive_s', 0.0):.1f}s)")
    line += (f" — plan cache: {stats.get('plan_hits', 0)} plan hits / "
             f"{stats.get('plan_misses', 0)} misses")
    hists = stats.get("latency_hist") or {}
    for name, h in sorted(hists.items()):
        if h.get("count"):
            line += (f"\n  {name}: p50 {h['p50']:.1f} us, "
                     f"p95 {h['p95']:.1f} us over {h['count']} samples")
    return line


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune.sweep",
        description="Measured CommConfig sweep on stacked ranks -> TuneDB "
        "JSON.")
    ap.add_argument("--fast", action="store_true",
                    help="smoke sweep: corner configs, small sizes")
    ap.add_argument("--ranks", type=int, default=8,
                    help="stacked ranks of the swept communicator")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the card; fails without "
                    "one) or 'cpu' (the plain PyTorch path)")
    ap.add_argument("--collectives", default=",".join(SWEEPABLE),
                    help=f"comma list from {SWEEPABLE}")
    ap.add_argument("--sizes", default=None,
                    help="comma list of message sizes in bytes, or a named "
                    f"set from {tuple(NAMED_SIZES)}")
    ap.add_argument("--max-configs", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help=f"TuneDB path (default {default_db_path()})")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the Eq.1 constants from this run's sendrecv "
                    "measurements and report model vs measured")
    ap.add_argument("--prune", action="store_true",
                    help="model-guided pruning: skip configs the calibrated "
                    "Eq.1 model ranks more than --prune-ratio off the "
                    "predicted incumbent")
    ap.add_argument("--prune-ratio", type=float,
                    default=tune_prune.DEFAULT_RATIO)
    ap.add_argument("--assert-pruned", action="store_true",
                    help="exit non-zero unless the sweep measured strictly "
                    "fewer configs than the exhaustive candidate space")
    ap.add_argument("--objective", choices=OBJECTIVES, default="latency",
                    help="ranking metric recorded by the sweep: bare "
                    "collective latency, or 'e2e' — additionally measure the "
                    "halo-fold consumer loop and record TuneEntry.e2e_us")
    ap.add_argument("--topology", default=None,
                    help="virtual torus placement, e.g. '4x4' or "
                    "'2x4:snake' (rows x cols must equal --ranks)")
    ap.add_argument("--hop-distances", default=None,
                    help="comma list of torus hop distances to sweep the "
                    "hop-patterned collectives at (requires --topology)")
    ap.add_argument("--loss-rate", type=float, default=0.0,
                    help="sweep a lossy wire: seeded chunk-drop rate in "
                    "[0, 1); candidates are forced to guaranteed delivery "
                    "and entries record TuneEntry.loss so "
                    "select_config(loss=...) can prefer lossy-wire "
                    "measurements")
    args = ap.parse_args(argv)

    if args.sizes in NAMED_SIZES:
        sizes = NAMED_SIZES[args.sizes]
    else:
        try:
            sizes = ([int(s) for s in args.sizes.split(",")]
                     if args.sizes else None)
        except ValueError:
            ap.error(f"--sizes must be comma-separated integers or one of "
                     f"{tuple(NAMED_SIZES)}, got {args.sizes!r}")
    colls = [c.strip() for c in args.collectives.split(",") if c.strip()]
    unknown = [c for c in colls if c not in SWEEPABLE]
    if unknown:
        ap.error(f"unknown collective(s) {unknown}; sweepable: {SWEEPABLE}")
    topology = None
    if args.topology:
        try:
            topology = TorusSpec.parse(args.topology)
        except ValueError as e:
            ap.error(str(e))
        if topology.n_ranks != args.ranks:
            ap.error(f"--topology {args.topology} places {topology.n_ranks} "
                     f"ranks but --ranks is {args.ranks}")
    hop_distances = None
    if args.hop_distances:
        if topology is None:
            ap.error("--hop-distances requires --topology")
        try:
            hop_distances = [int(d) for d in args.hop_distances.split(",")]
        except ValueError:
            ap.error(f"--hop-distances must be comma-separated integers, "
                     f"got {args.hop_distances!r}")

    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    db = TuneDB.load(args.out)
    stats: dict = {}
    db = run_sweep(n_ranks=args.ranks, collectives=colls, sizes=sizes,
                   fast=args.fast, db=db, max_configs=args.max_configs,
                   log=lambda s: print(s, flush=True), prune=args.prune,
                   prune_ratio=args.prune_ratio, objective=args.objective,
                   stats=stats, topology=topology,
                   hop_distances=hop_distances, loss_rate=args.loss_rate,
                   device=device)
    path = db.save(args.out)
    print(f"wrote {len(db)} entries -> {path}")
    print(sweep_summary(stats))

    if args.calibrate:
        from repro_torch.tune.calibrate import (calibrate_from_db,
                                               model_vs_measured)
        topo = topology_key(args.ranks, device)
        result = calibrate_from_db(db, topo)
        print(result.summary())
        for row in model_vs_measured(result, db, topo):
            print("  " + row)
    if args.assert_pruned and stats.get("pruned", 0) <= 0:
        print("ASSERT-PRUNED FAILED: the calibrated model pruned zero "
              "candidates (the sweep measured the exhaustive space)",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
