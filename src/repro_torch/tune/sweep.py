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

Every candidate's timed program goes through the plan cache's program memo
(``plans.captured_program``): the built op, and on the card the CUDA graph
captured from it with its static input.  A sweep drops the programs it
looked up when it ends, unless it was asked to keep them
(``keep_programs``): then the next sweep in the same process (same
collective, config, size and bench mesh) replays instead of re-building
and re-capturing, and drops them in turn.  ``--plan-dir`` adds the disk tier of the
plan cache, so a fresh process re-derives no schedule; ``--warm-check``
guards both (see :func:`main`).

CLI (the card by default; ``--device cpu`` for the plain path)::

    PYTHONPATH=src python -m repro_torch.tune.sweep --fast --calibrate
    PYTHONPATH=src python -m repro_torch.tune.sweep --sizes 1024,65536 \\
        --collectives all_reduce,sendrecv --out .repro_tune/tunedb.json
    # virtual 4x4 torus, per-edge hop-distance axis (TuneEntry.hops)
    PYTHONPATH=src python -m repro_torch.tune.sweep --ranks 16 \\
        --topology 4x4 --hop-distances 1,2,4 --collectives sendrecv
    # plan store + warm checks (in-process, then a fresh process)
    PYTHONPATH=src python -m repro_torch.tune.sweep --fast --sizes small \\
        --collectives sendrecv,all_reduce,hierarchical_all_reduce \\
        --plan-dir /tmp/plans --warm-check
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import weakref
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import (collectives, planstore, plans, reliable,
                              streaming)
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import (H100, CommConfig, CommMode, Reliability,
                                     Scheduling)
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
             "multi_neighbor", "all_to_all", "hierarchical_all_reduce")

# Collectives with end-to-end consumer-loop benchmarks (the hideable-compute
# consumers of the paper's §5 argument), one tuple per collective.
# all_reduce serves three phases with opposite cost structures: the
# training row-parallel matmul+reduce layer, the serving decode step (tiny
# latency-bound per-token combines with almost no hideable compute), and
# prefill (throughput-bound bulk reduces behind a large hideable matmul).
# Under ``--objective e2e`` each consumer is measured separately and
# recorded as its own TuneEntry (tagged ``TuneEntry.consumer``) so
# ``select_config(consumer=...)`` can answer per phase.  The first consumer
# in each tuple is the primary one — the one the pruning model predicts
# with.
CONSUMERS: dict[str, tuple[str, ...]] = {
    "all_reduce": ("row_parallel", "decode_step", "prefill"),
    "multi_neighbor": ("halo_fold",),
    "all_to_all": ("moe_loop",),
}

# row_parallel consumer geometry: the reduced output is (tokens, _ROWPAR_D)
# with tokens*_ROWPAR_D*4 = msg_bytes; the hideable per-rank matmul
# contracts over _ROWPAR_FF features.
_ROWPAR_D = 64
_ROWPAR_FF = 128
# moe_loop consumer geometry: a (tokens, _MOE_D) dispatch payload with
# tokens*_MOE_D*4 = msg_bytes; each expert's FFN expands to _MOE_FF.
_MOE_D = 32
_MOE_FF = 64
# decode_step consumer geometry: a (batch, _DEC_D) per-token activation with
# batch*_DEC_D*4 = msg_bytes; the per-step matmul contracts over _DEC_D —
# almost nothing to hide the combines behind.
_DEC_D = 16
# prefill consumer geometry: (tokens, _PRE_FF) activations with
# tokens*_PRE_FF*4 = msg_bytes and a _PRE_FF-wide contraction — a large
# hideable matmul per combine.
_PRE_FF = 256

# Collectives whose benchmark pattern is parameterized by a torus hop
# distance (the --hop-distances axis): the perm is a translation of the
# whole virtual torus by exactly d hops.
HOP_PATTERNED = ("sendrecv", "multi_neighbor")

OBJECTIVES = ("latency", "e2e")


def consumer_flops(collective: str, msg_bytes: int,
                   consumer: str | None = None) -> float:
    """Hideable per-iteration compute (FLOPs) of a collective's consumer
    loop — feeds the e2e prediction (compute_s = flops / peak).  With
    ``consumer`` omitted, the collective's primary consumer is assumed."""
    if consumer is None:
        consumer = (CONSUMERS.get(collective) or ("",))[0]
    if collective == "all_reduce":
        if consumer == "decode_step":
            # tiny per-token matmul + the LSE max/sum pair: ~4 flops/elem
            return 4.0 * (msg_bytes / 4.0)
        if consumer == "prefill":
            # bulk matmul: 2 * tokens * ff^2 with tokens*ff = msg_bytes/4
            return 2.0 * _PRE_FF * (msg_bytes / 4.0)
        # matmul: 2 * tokens * ff * d with tokens*d = msg_bytes/4 elements
        return 2.0 * _ROWPAR_FF * (msg_bytes / 4.0)
    if collective == "multi_neighbor":
        # elementwise interior update over the state (~12 flops/element)
        return 12.0 * (msg_bytes / 4.0)
    if collective == "all_to_all":
        # expert FFN: two matmuls (D->FF, FF->D) over tokens*D = msg/4 elems
        return 4.0 * _MOE_FF * (msg_bytes / 4.0)
    return 0.0


# ----------------------------------------------------------------------
# Microbenchmark builders
# ----------------------------------------------------------------------

def _payload_elems(msg_bytes: int, n: int) -> int:
    """float32 elements per rank, padded to a multiple of the rank count so
    reduce-scatter/all-to-all constraints hold for every collective."""
    elems = max(n, msg_bytes // 4)
    return elems + (-elems) % n


@dataclasses.dataclass(frozen=True)
class _BenchMesh:
    """The stacked ranks a sweep benches on, as a mesh shape: enough surface
    (``axis_names`` and a ``shape`` mapping) for ``Communicator.from_mesh``.
    The hierarchical all-reduce benches on ``(n // 2, 2)`` ``("inner",
    "outer")``, every other collective on one ``"x"`` axis."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def _mesh_key(mesh) -> tuple:
    """Program-cache key component for the bench mesh's STRUCTURE: two
    factorizations of one rank count (an 8-rank axis vs a 4x2 inner/outer
    mesh) build different programs and must never replay each other's."""
    return (tuple(mesh.axis_names),
            tuple(mesh.shape[a] for a in mesh.axis_names))


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
              subcomms=None, hop_distance: int | None = None) -> Callable:
    """Stacked ``(n, elems)`` -> same-shaped tensor exercising one
    collective op.  ``subcomms`` is the (inner, outer) communicator pair of
    the hierarchical (cross-pod) all-reduce, which runs over a 2-axis
    bench mesh.  ``hop_distance`` (virtual torus only) replaces the
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
    elif collective == "hierarchical_all_reduce":
        inner, outer = subcomms

        def op(x):
            return collectives.hierarchical_all_reduce(
                x, inner, outer, cfg) / (inner.size * outer.size)
    else:
        raise ValueError(f"unknown collective {collective!r} "
                         f"(sweepable: {SWEEPABLE})")
    return op


def _rank_weight(seed: int, shape: tuple, n: int, device) -> torch.Tensor:
    """The reference's ``RandomState(seed).randn(*shape) * 0.05`` f32
    weight, the same on each of ``n`` stacked ranks."""
    w = np.random.RandomState(seed).randn(*shape) * 0.05
    return torch.from_numpy(w.astype(np.float32)).to(device).expand(
        n, *shape)


def _tp_combine(h: torch.Tensor, w: torch.Tensor, comm,
                cfg: CommConfig) -> torch.Tensor:
    """``models.layers.row_parallel``'s combine: streaming mode or
    overlapped scheduling routes the chunked, double-buffered
    overlapped_matmul_allreduce; buffered fused/host configs issue one
    all-reduce after the whole matmul."""
    if (cfg.mode == CommMode.STREAMING
            or cfg.scheduling == Scheduling.OVERLAPPED):
        return streaming.overlapped_matmul_allreduce(h, w, comm, cfg)
    return collectives.all_reduce(streaming.matmul_f32(h, w), comm, cfg)


def _build_consumer_op(collective: str, comm, cfg: CommConfig,
                       msg_bytes: int, hop_distance: int | None = None,
                       consumer: str | None = None, device=None
                       ) -> tuple[Callable, tuple]:
    """One iteration of the collective's consumer loop: ``(op,
    per_rank_shape)``.

    ``op`` maps a stacked ``(n, *per_rank_shape)`` payload to a same-shaped
    payload so iterations chain; the body is compute the schedule could
    hide the collective behind.  ``consumer`` picks one of the collective's
    loops from :data:`CONSUMERS` (default: the primary one); the
    all_reduce loops' weights are made on ``device`` (the card unless
    another is named), outside any capture."""
    if consumer is None:
        consumer = (CONSUMERS.get(collective) or ("",))[0]
    n = comm.size

    if collective == "all_reduce" and consumer == "decode_step":
        # Serving decode step: a tiny (batch, d) per-token activation, the
        # LSE-combine pair (max reduce + sum reduce, as in
        # models.attention.decode_attention) and a row-parallel output
        # combine with a near-trivial matmul.  Almost no hideable compute:
        # the config's fixed per-op cost dominates.
        b = max(4, msg_bytes // 4 // _DEC_D)
        w = _rank_weight(2, (_DEC_D, _DEC_D), n, resolve_device(device))

        def op(h):
            m = collectives.all_reduce(h, comm, cfg, op="max")
            y = _tp_combine(h, w, comm, cfg)
            return torch.tanh(h + 1e-3 * (y - 1e-3 * m))

        return op, (b, _DEC_D)

    if collective == "all_reduce" and consumer == "prefill":
        # Serving prefill: bulk (tokens, ff) activations with a wide
        # hideable matmul per combine — throughput-bound.
        tokens = max(8, msg_bytes // 4 // _PRE_FF)
        w = _rank_weight(3, (_PRE_FF, _PRE_FF), n, resolve_device(device))

        def op(h):
            return torch.tanh(h + 1e-3 * _tp_combine(h, w, comm, cfg))

        return op, (tokens, _PRE_FF)

    if collective == "all_reduce" and consumer == "row_parallel":
        # Row-parallel TP layer: per-rank matmul + combine of the partial
        # sum, the reduced output fed back into the activation's shape so
        # the next iteration depends on this one.
        tokens = max(8, msg_bytes // 4 // _ROWPAR_D)
        w = _rank_weight(0, (_ROWPAR_FF, _ROWPAR_D), n,
                         resolve_device(device))

        def op(h):
            y = _tp_combine(h, w, comm, cfg)
            return torch.tanh(h + 1e-3 * y.sum(-1, keepdim=True))

        return op, (tokens, _ROWPAR_FF)

    if collective == "all_to_all" and consumer == "moe_loop":
        # MoE expert loop: dispatch (all_to_all) -> expert FFN -> combine
        # (all_to_all back).  The FFN is the hideable compute: the chunked
        # overlapped dispatch and combine (streaming.chunked_all_to_all)
        # let the expert matmuls of chunk i run while chunk i+1 is on the
        # wire.
        tokens = max(n, msg_bytes // 4 // _MOE_D)
        tokens += (-tokens) % n              # all_to_all split constraint
        # both weights drawn in turn from one RandomState(1), as the
        # reference draws them
        rng = np.random.RandomState(1)
        dev = resolve_device(device)
        w1, w2 = (torch.from_numpy((rng.randn(*shape) * 0.05).astype(
            np.float32)).to(dev).expand(n, *shape)
            for shape in ((_MOE_D, _MOE_FF), (_MOE_FF, _MOE_D)))

        def op(x):
            y = collectives.all_to_all(x, comm, cfg)            # dispatch
            h = torch.tanh(streaming.matmul_f32(y, w1))
            h = streaming.matmul_f32(h, w2)
            z = collectives.all_to_all(h.to(x.dtype), comm, cfg)  # combine
            return torch.tanh(x + 1e-3 * z)

        return op, (tokens, _MOE_D)

    if collective != "multi_neighbor" or consumer != "halo_fold":
        raise ValueError(f"no consumer-loop benchmark {consumer!r} for "
                         f"{collective!r} (consumers: {CONSUMERS})")
    # Halo-fold step: a 4-neighbor exchange, a fold of the received halos,
    # and an interior update the overlapped schedule can issue while the
    # exchange is in flight.
    rounds = (_hop_rounds(comm, hop_distance) if hop_distance is not None
              else _multi_neighbor_rounds(comm))
    elems = _payload_elems(msg_bytes, n)

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


@dataclasses.dataclass
class SweepProgram:
    """One candidate's timed program, as the plan cache's program memo
    holds it: the built op and, once timed on the card under device
    scheduling, the CUDA graph of ``inner`` chained ops with the static
    input it reads, by ``(inner, whole stacked shape)``.  ``shape`` is a
    consumer loop's per-rank payload shape (None: the collective's own
    message)."""
    op: Callable
    shape: tuple | None = None
    graphs: dict = dataclasses.field(default_factory=dict)


# One graph memory pool per device for every captured sweep program: a
# graph's outputs are never read and no two replay at once, so the
# intermediates of one may reuse another's blocks, and the programs the
# memo keeps cost one graph's footprint, not the sum of all.
_POOLS: dict = {}
# The static inputs: one zero tensor per (shape, device), which no op
# writes, shared by the graphs that hold it and freed with the last.
_ZEROS: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _zeros(shape: tuple, device) -> torch.Tensor:
    key = (shape, str(device))
    x = _ZEROS.get(key)
    if x is None:
        x = _ZEROS[key] = torch.zeros(shape, dtype=torch.float32,
                                      device=device)
    return x


def _capture(op: Callable, x: torch.Tensor, warmup: int, inner: int,
             device) -> torch.cuda.CUDAGraph:
    """``warmup`` eager ops on ``x`` (they build the kernels and fill the
    plan caches, pinned index tensors included), then ``inner`` chained ops
    captured as one graph that reads ``x``."""
    for _ in range(warmup):
        op(x)
    torch.cuda.synchronize(device)
    if str(device) not in _POOLS:
        _POOLS[str(device)] = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=_POOLS[str(device)]):
        y = x
        for _ in range(inner):
            y = op(y)
    del y
    return graph


def _time_program(op: Callable, n_ranks: int, msg_bytes: int,
                  cfg: CommConfig, device=None, warmup: int = 1,
                  reps: int = 3, inner: int = 8,
                  per_dev_shape: tuple | None = None,
                  hops: int = 1, program: SweepProgram | None = None
                  ) -> float:
    """Seconds per collective op under the config's scheduling discipline,
    on ``n_ranks`` stacked ranks of a zero f32 message on ``device``.

    On the card, fused and overlapped configs capture ``inner`` chained ops
    as one CUDA graph (after ``warmup`` eager ops, which build the kernels
    and fill the plan caches) and time ``reps`` replays with CUDA events;
    host-scheduled configs synchronize after every op and read the host
    clock.  On the CPU every op runs eagerly under ``perf_counter``.  Each
    rep's per-op seconds go to :data:`_LAST_SAMPLES`.  ``hops`` (the
    pattern's hop distance) is for model timers; the clock needs none, the
    routed permutes pay it.  With ``program`` (the sweep's memo entry for
    this candidate) a graph captured once is replayed by every later
    timing of the same shape.
    """
    device = resolve_device(device)
    if per_dev_shape is None:
        per_dev_shape = (_payload_elems(msg_bytes, n_ranks),)
    shape = (n_ranks,) + tuple(per_dev_shape)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    del _LAST_SAMPLES[:]
    if cuda and cfg.scheduling != Scheduling.HOST:
        # fused and overlapped are both device-scheduled: one graph launch
        # amortized over `inner` ops
        gkey = (inner, shape)
        graph, x = (program.graphs.get(gkey, (None, None))
                    if program is not None else (None, None))
        if graph is None:
            x = _zeros(shape, device)
            graph = _capture(op, x, warmup, inner, device)
            if program is not None:
                program.graphs[gkey] = (graph, x)
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
    x = torch.zeros(shape, dtype=torch.float32, device=device)
    for _ in range(warmup):
        x = op(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        t1 = time.perf_counter()
        for _ in range(inner):
            x = op(x)
            sync()
        _LAST_SAMPLES.append((time.perf_counter() - t1) / inner)
    return (time.perf_counter() - t0) / (reps * inner)


def _config_items(cfg: CommConfig) -> tuple:
    return tuple(sorted(tune_space.config_to_dict(cfg).items()))


# ----------------------------------------------------------------------
# Sweep driver
# ----------------------------------------------------------------------

def _seed_calibration(mesh, comm, db: TuneDB, topo: str,
                      sizes: Sequence[int], reps: int, inner: int,
                      log: Callable[[str], None], timer, device,
                      program: Callable, torus: str = ""):
    """Cold-cache calibration seed: measure the sendrecv corner configs so
    the Eq. 1 fit has points on THIS substrate before pruning starts.  The
    seed measurements are real TuneDB entries (they also serve selection)."""
    log("[prune] cold cache: seeding Eq.1 calibration with a sendrecv "
        "corner sweep")
    hops = _pattern_hops("sendrecv", comm)
    for msg_bytes in sizes:
        for cfg in tune_space.enumerate_configs("sendrecv", fast=True):
            prog = program(
                ("sweep", topo, torus, 0, _mesh_key(mesh), "sendrecv",
                 _config_items(cfg), int(msg_bytes)),
                lambda: SweepProgram(_build_op("sendrecv", comm, cfg)))
            sec = timer(prog.op, comm.size, msg_bytes, cfg, device=device,
                        reps=reps, inner=inner, hops=hops, program=prog)
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
              device=None, keep_programs: bool = False) -> TuneDB:
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

    Every candidate's program (its op, and on the card its CUDA graphs)
    goes through the plan cache's program memo, and this sweep owns the
    programs it looks up: they are dropped when it returns or raises,
    unless ``keep_programs``, which hands them to the next sweep that looks
    them up (the CLI's ``--warm-check`` keeps the cold run's for the warm
    one).
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, "
                         f"got {objective!r}")
    if not 0.0 <= loss_rate < 1.0:
        raise ValueError(f"loss_rate must be in [0, 1), got {loss_rate}")
    wire = (reliable.WireFaults(seed=17, drop=loss_rate)
            if loss_rate > 0.0 else None)
    losskey: tuple = (("loss", loss_rate),) if wire is not None else ()
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
                  for k in ("plan_hits", "plan_misses", "program_hits",
                            "program_misses", "disk_hits", "disk_misses",
                            "disk_corrupt")}
    cache_before = {k: int(c.value) for k, c in cache_ctrs.items()}
    t_start = time.perf_counter()

    owned: list = []

    def program(key, build):
        owned.append(key)
        return plans.captured_program(key, build)

    try:
        mesh = _BenchMesh(("x",), (n_ranks,))
        comm = Communicator.from_mesh(mesh, "x", topo=topology)
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
                calibration = _seed_calibration(
                    mesh, comm, db, topo, sizes, reps, inner, log, timer,
                    device, program, torus=torus)
                stats["seed_s"] = time.perf_counter() - t_seed
            if calibration is None:
                log("[prune] calibration unavailable — sweeping "
                    "exhaustively")
            else:
                log(f"[prune] {calibration.summary()}")

        for coll in collectives:
            bench_mesh, subcomms = mesh, None
            if coll == "hierarchical_all_reduce":
                if n_ranks < 4 or n_ranks % 2:
                    log(f"[{topo}] {coll}: skipped (needs an even rank count "
                        f">= 4, have {n_ranks})")
                    continue
                # inner (in-pod) x outer (cross-pod) factorization, inner major
                bench_mesh = _BenchMesh(("inner", "outer"), (n_ranks // 2, 2))
                subcomms = (Communicator.from_mesh(bench_mesh, "inner"),
                            Communicator.from_mesh(bench_mesh, "outer"))
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
                hops = (hop_d if hop_d is not None
                        else _pattern_hops(coll, comm))
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
                                f"{len(to_measure)}/{len(cands)} (model "
                                f"skipped "
                                f"{len(skipped)})")
                    for i, cfg in enumerate(to_measure):
                        prog = program(
                            ("sweep", topo, torus, hop_d or 0,
                             _mesh_key(bench_mesh), coll, _config_items(cfg),
                             int(msg_bytes)) + losskey,
                            lambda: SweepProgram(_build_op(
                                coll, comm, cfg, subcomms=subcomms,
                                hop_distance=hop_d)))
                        del _LAST_SAMPLES[:]
                        with obs_trace.span("sweep.candidate", cat="sweep",
                                            collective=coll,
                                            msg_bytes=int(msg_bytes),
                                            hops=hops, cfg=i) as sp, (
                                reliable.inject(wire) if wire is not None
                                else nullcontext()):
                            sec = timer(prog.op, n_ranks, msg_bytes, cfg,
                                        device=device, reps=reps, inner=inner,
                                        hops=hops, program=prog)
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
                            cprog = program(
                                ("sweep_e2e", topo, torus, hop_d or 0,
                                 _mesh_key(bench_mesh), coll, consumer,
                                 _config_items(cfg), int(msg_bytes)) + losskey,
                                lambda: SweepProgram(*_build_consumer_op(
                                    coll, comm, cfg, msg_bytes,
                                    hop_distance=hop_d, consumer=consumer,
                                    device=device)))
                            with (reliable.inject(wire) if wire is not None
                                  else nullcontext()):
                                e2e_sec = timer(cprog.op, n_ranks, msg_bytes,
                                                cfg, device=device, reps=reps,
                                                inner=inner,
                                                per_dev_shape=cprog.shape,
                                                hops=hops, program=cprog)
                            consumer_e2e[consumer] = e2e_sec * 1e6
                            stats["e2e_measured"] += 1
                            reg.histogram("sweep.e2e_us", collective=coll
                                      ).observe(e2e_sec * 1e6)
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
                            f"{best.us_per_call:9.1f} us  "
                            f"({best.gbps:6.3f} GB/s)  "
                            f"{best.config['mode']}/"
                            f"{best.config['scheduling']}"
                            f"/{best.config['algorithm']}")
                    for consumer in consumers:
                        be = db.best(coll, msg_bytes, topo, hops=hops,
                                     objective="e2e", consumer=consumer)
                        if be is not None and be.e2e_us > 0.0:
                            log(f"  {coll:15s} {msg_bytes:>8d}B h{hops} "
                                f"best e2e "
                                f"{be.e2e_us:9.1f} us/iter ({consumer}) "
                                f"{be.config['mode']}/"
                                f"{be.config['scheduling']}")
        stats["wall_s"] = time.perf_counter() - t_start
        for k, c in cache_ctrs.items():
            stats[k] = int(c.value) - cache_before[k]
        stats["latency_hist"] = reg.find("sweep.us{")
        if stats["measured"]:
            sweep_s = stats["wall_s"] - stats.get("seed_s", 0.0)
            stats["est_exhaustive_s"] = (sweep_s * stats["total"]
                                         / stats["measured"])
        return db
    finally:
        if not keep_programs:
            plans.drop_programs(owned)


def sweep_summary(stats: dict) -> str:
    """One-line wall-clock summary (exhaustive vs calibration-pruned), plus
    the plan-cache hit/miss counts behind the warm-sweep win."""
    line = (f"sweep wall clock {stats.get('wall_s', 0.0):.1f}s: measured "
            f"{stats.get('measured', 0)}/{stats.get('total', 0)} candidate "
            f"configs")
    if stats.get("e2e_measured"):
        line += f" ({stats['e2e_measured']} consumer-loop e2e)"
    if stats.get("pruned"):
        line += (f" — {stats['pruned']} pruned by the calibrated model "
                 f"(exhaustive est. ~{stats.get('est_exhaustive_s', 0.0):.1f}s)")
    line += (f" — plan cache: {stats.get('program_hits', 0)} program hits"
             f" / {stats.get('program_misses', 0)} misses, "
             f"{stats.get('plan_hits', 0)} plan hits / "
             f"{stats.get('plan_misses', 0)} misses")
    if stats.get("disk_hits", 0) or stats.get("disk_misses", 0):
        line += (f" — plan store: {stats.get('disk_hits', 0)} disk hits / "
                 f"{stats.get('disk_misses', 0)} disk misses")
    hists = stats.get("latency_hist") or {}
    for name, h in sorted(hists.items()):
        if h.get("count"):
            line += (f"\n  {name}: p50 {h['p50']:.1f} us, "
                     f"p95 {h['p95']:.1f} us over {h['count']} samples")
    return line


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

STATS_ENV = "REPRO_SWEEP_STATS_JSON"


def _dump_stats_json(stats: dict) -> None:
    """Machine-readable stats channel: when ``REPRO_SWEEP_STATS_JSON`` names
    a path, the (first) sweep's stats dict is written there — how the
    cross-process warm check reads a child sweep's wall clock and disk
    counts without parsing log lines."""
    path = os.environ.get(STATS_ENV)
    if not path:
        return
    payload = {k: v for k, v in stats.items() if k != "latency_hist"}
    Path(path).write_text(json.dumps(payload))


def _cross_process_warm_check(child_argv: Sequence[str],
                              cold_s: float) -> int:
    """The second half of ``--warm-check`` when a plan store is active:
    rerun this exact sweep in a FRESH python process against the populated
    plan directory.  It looks up exactly the plans the cold run wrote, so
    the child must replay them all from disk: ``disk_hits`` > 0,
    ``disk_misses`` == 0 and ``disk_corrupt`` == 0.  Its wall clock is
    printed beside the cold run's and held to no bar: the JAX package's
    30 % bar measures the trace and XLA compile a fresh JAX process skips,
    and a torch process has neither (ROADMAP.md Queue 3)."""
    import subprocess
    import tempfile

    argv = [a for a in child_argv if a != "--warm-check"]
    fd, stats_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    env = dict(os.environ)
    env[STATS_ENV] = stats_path
    env[planstore.ENV_VAR] = str(planstore.plan_dir())
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune.sweep", *argv],
            capture_output=True, text=True, env=env)
        if proc.returncode != 0:
            print("CROSS-PROCESS WARM-CHECK FAILED: child sweep exited "
                  f"{proc.returncode}\n{proc.stdout[-2000:]}"
                  f"\n{proc.stderr[-2000:]}", file=sys.stderr)
            return 5
        try:
            child = json.loads(Path(stats_path).read_text())
        except (OSError, ValueError):
            print("CROSS-PROCESS WARM-CHECK FAILED: child stats JSON "
                  "missing or unreadable", file=sys.stderr)
            return 5
    finally:
        try:
            os.unlink(stats_path)
        except OSError:
            pass
    warm_s = child.get("wall_s", float("inf"))
    hits, misses, corrupt = (child.get(k, 0) for k in
                             ("disk_hits", "disk_misses", "disk_corrupt"))
    print(f"plan-store cross-process check: cold {cold_s:.3f}s -> "
          f"fresh-process {warm_s:.3f}s ({warm_s / max(cold_s, 1e-9):.3f} "
          f"of cold), {hits} disk hits / {misses} misses / {corrupt} "
          f"corrupt")
    if hits <= 0 or misses or corrupt:
        print("CROSS-PROCESS WARM-CHECK FAILED: the fresh process did not "
              "replay every plan from the disk store", file=sys.stderr)
        return 5
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    raw_argv = list(argv) if argv is not None else sys.argv[1:]
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
    ap.add_argument("--plan-dir", default=None,
                    help="disk-backed plan store directory (also via "
                    "REPRO_PLAN_DIR): plan schedules persist as versioned "
                    "JSON, so a FRESH process rerunning this sweep "
                    "re-derives none")
    ap.add_argument("--warm-check", action="store_true",
                    help="run the sweep twice in this process (cold, then "
                    "warm against the populated plan cache) and exit "
                    "non-zero unless the warm sweep replayed cached "
                    "programs and its wall clock is at least 30%% lower; "
                    "with a plan dir active, additionally rerun the sweep "
                    "in a FRESH subprocess and require every plan it looks "
                    "up to come from the disk store")
    args = ap.parse_args(argv)

    if args.plan_dir:
        # Through the env so the cross-process warm-check child inherits
        # the same store.
        os.environ[planstore.ENV_VAR] = args.plan_dir
    store = planstore.active()
    if store is not None:
        print(f"plan store: {store.root} "
              f"({store.entry_count()} entries on disk)", flush=True)

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
    kwargs = dict(n_ranks=args.ranks, collectives=colls, sizes=sizes,
                  fast=args.fast, max_configs=args.max_configs,
                  log=lambda s: print(s, flush=True), prune=args.prune,
                  prune_ratio=args.prune_ratio, objective=args.objective,
                  topology=topology, hop_distances=hop_distances,
                  loss_rate=args.loss_rate, device=device)
    db = run_sweep(db=db, stats=stats, keep_programs=args.warm_check,
                   **kwargs)
    path = db.save(args.out)
    print(f"wrote {len(db)} entries -> {path}")
    print(sweep_summary(stats))
    _dump_stats_json(stats)

    if args.warm_check:
        warm_stats: dict = {}
        db = run_sweep(db=db, stats=warm_stats, **kwargs)
        db.save(args.out)
        print("warm " + sweep_summary(warm_stats))
        cold_s = stats.get("wall_s", 0.0)
        warm_s = warm_stats.get("wall_s", 0.0)
        print(f"plan-cache warm check: cold {cold_s:.3f}s -> warm "
              f"{warm_s:.3f}s ({warm_s / max(cold_s, 1e-9):.3f} of cold)")
        if warm_stats.get("program_hits", 0) <= 0:
            print("WARM-CHECK FAILED: the warm sweep replayed zero cached "
                  "programs (plan cache broken?)", file=sys.stderr)
            return 4
        if warm_s > 0.7 * cold_s:
            print("WARM-CHECK FAILED: warm sweep wall clock is not >= 30% "
                  "lower than cold (plan cache ineffective)",
                  file=sys.stderr)
            return 4
        if planstore.active() is not None:
            rc = _cross_process_warm_check(raw_argv, cold_s)
            if rc:
                return rc

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
