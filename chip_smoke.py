#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises and the script
exits non-zero:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel from this checkout's sources;
2. every kernel held against its plain PyTorch version on the card, at the
   test shapes and at the main paths' full-size shapes (``swe_step`` with
   and without the boundary row list; ``quantize``/``dequantize`` at blocks
   256 and 1024, f32 and bf16), and timed with CUDA events beside its
   bound;
3. the main path at full size — the bight mesh at 312,000 target elements
   (270,886 elements) on 48 stacked ranks — under the fused, overlapped and
   host-scheduled configurations for 200 steps (20-step segments): final
   states bitwise equal, mass drift, finiteness, and the kernel launch
   counts; then one fused run with the plain version, against the kernel run,
   and a profile of one fused segment (device time by kernel);
4. routing: the 1696-element mesh on a 2x4 torus (8 ranks) and the full size
   on a 6x8 torus (48 ranks), each bitwise equal to its flat run;
5. the int8 wire (the ``quantize``/``dequantize`` kernels, checked
   against their plain version and timed in phase 2): the ZeRO-1 gradient
   sync of mamba2-130m's 128,915,904 f32 gradients over 8 ranks (ring
   reduce-scatter + all-gather, and ring all-reduce) on the NONE, BF16 and
   INT8 wires; the autotuner sweep (sendrecv and the 4-neighbor exchange at
   48 ranks, the ring collectives over the full axes at 8 ranks, the Eq. 1
   fit); and ``comm_cfg="auto"`` at full size from that TuneDB, flat and on
   a 6x8 torus, bitwise equal to the runs with the selected configs given
   explicitly;
6. a ``kernels:`` line, the kernel table as one JSON line, and as the last
   line ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one, or when the repository
is missing beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ATOL_KERNEL = 1e-5      # tests/test_kernels.py::test_swe_step_sweep
ATOL_PLAIN_RUN = 1e-4   # tests/test_swe.py partition/mode parity bound
MASS_DRIFT = 5e-3       # tests/test_swe.py::test_mass_conservation_multidevice
STEPS, N_INNER = 200, 20
FULL_ELEMENTS, FULL_RANKS = 312000, 48
TIMED_RUNS = 60
SLEEP_CYCLES = 4_000_000   # ~2 ms at the H100's clock
COURANT = 0.4
# Device-memory bandwidth by card (NVIDIA data sheets); the H100 SXM figure
# is the default.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100 80GB HBM3": 3.35e12}
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_bandwidth(name: str) -> float:
    for key, bw in HBM_BYTES_PER_S.items():
        if key in name:
            return bw
    return HBM_BYTES_PER_S["H100 80GB HBM3"]


# ----------------------------------------------------------------------
# Kernel inputs, bounds and timing
# ----------------------------------------------------------------------

def random_inputs(P, E, H, seed, device):
    """Seeded kernel inputs: positive depths, small momenta, every edge
    type, neighbour indices over [state | halo]."""
    rng = np.random.RandomState(seed)
    st = np.abs(rng.randn(P, E, 3)) * 0.1 + np.array([1.0, 0, 0])
    hl = np.abs(rng.randn(P, H, 3)) * 0.1 + np.array([1.0, 0, 0])
    nrm = rng.randn(P, E, 3, 2) * 0.01
    nidx = rng.randint(0, E + H, (P, E, 3))
    et = rng.randint(0, 4, (P, E, 3))
    area = np.abs(rng.randn(P, E)) * 1e-3 + 1e-4
    valid = (rng.rand(P, E) > 0.05).astype(np.float64)
    rows = rng.randint(0, E, (P, max(1, E // 7)))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    args = [f32(st), f32(hl), f32(nrm), i32(nidx), i32(et), f32(area),
            f32(valid), torch.ones((), dtype=torch.float32, device=device)]
    return args, i32(rows)


def kernel_bytes(args, rows) -> int:
    """Bytes the function must move for these inputs: each input byte it
    needs read once, each output byte written once.  Rows listed twice are
    updated once; land and sea edges read no neighbour index or row; only
    the referenced rows of ``[state | halo]`` are read."""
    state, halo, _, neigh_idx, edge_type = args[:5]
    P, E = state.shape[:2]
    ext = E + halo.shape[1]
    dev = state.device
    if rows is None:
        own = torch.arange(P * E, device=dev)
    else:
        own = torch.unique((torch.arange(P, device=dev).view(P, 1) * E
                            + rows.long()).reshape(-1))
    p, e = own // E, own % E
    nidx = neigh_idx.reshape(P * E, 3)[own].long()
    reads_nb = (edge_type.reshape(P * E, 3)[own] != 1) & (
        edge_type.reshape(P * E, 3)[own] != 2)
    ext_rows = (p.unsqueeze(1) * ext + nidx)[reads_nb]
    ext_read = torch.unique(torch.cat([p * ext + e, ext_rows])).numel()
    per_row = 24 + 12 + 4 + 4 + 12   # normals, edge_type, area, valid, out
    nbytes = (ext_read * 12 + own.numel() * per_row
              + int(reads_nb.sum().item()) * 4 + 4)   # + h_sea
    if rows is not None:
        nbytes += rows.numel() * 4
    return nbytes


def time_ms(fn, flush) -> float:
    """Median of TIMED_RUNS CUDA-event timings of ``fn``, with the L2 cache
    flushed before each run (the main path reads these arrays cold).  A
    sleep kernel ahead of each run lets the host enqueue the flush and the
    timed launch before the card reaches them, so the events time the
    device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
# Main path helpers
# ----------------------------------------------------------------------

def stable_dt(sim) -> float:
    """COURANT times the smallest area/perimeter over the fastest initial
    gravity wave: the explicit Rusanov update's stability limit."""
    edge = np.linalg.norm(sim.mesh.normals, axis=-1).sum(axis=1)
    c = np.sqrt(9.81 * sim.pm.state0[..., 0].max())
    return float(COURANT * (sim.mesh.area / edge).min() / c)


def mass(sim, state) -> float:
    s = state.detach().cpu().numpy().astype(np.float64)
    return float(np.sum(s[..., 0] * sim.pm.area * sim.pm.valid))


def run_fused(driver, sim, update=None):
    """Build the segment runner (captures its graph) and run STEPS steps;
    returns (state, microseconds per step of the replays)."""
    run = driver.make_sim_runner(sim, N_INNER, update=update)
    torch.cuda.synchronize()
    state, t = sim.state, 0.0
    t0 = time.perf_counter()
    for _ in range(STEPS // N_INNER):
        state = run(state, t)
        t += N_INNER * sim.swe.dt
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) / STEPS * 1e6


def profile_segment(driver, sim, step_us: float) -> None:
    """Device time by kernel over one replayed fused segment: where a step's
    time goes on the card.  The busy share is taken against ``step_us``, the
    unprofiled step time (the profiler slows the host down)."""
    from torch.profiler import ProfilerActivity, profile
    run = driver.make_sim_runner(sim, N_INNER)
    state = run(sim.state, 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(state, N_INNER * sim.swe.dt)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / N_INNER
    log(f"[profile] fused segment: {len(rows)} kernel names, device busy "
        f"{busy:.1f} us/step of the {step_us:.1f} us/step measured above "
        f"({100 * busy / step_us:.1f} %)")
    for us, count, key in rows[:8]:
        log(f"[profile]   {us / N_INNER:8.2f} us/step  {count / N_INNER:5.1f}"
            f"/step  {key[:70]}")


def run_host(driver, sim):
    runner = driver.make_host_scheduled_runner(sim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = runner.run(sim.state, 0.0, STEPS)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / STEPS * 1e6
    check(runner.dispatches == 2 * STEPS,
          f"host runner dispatched {runner.dispatches}, want {2 * STEPS}")
    return state, us

# ----------------------------------------------------------------------
# The int8 wire: kernels, gradient sync, sweep, autotuned SWE
# ----------------------------------------------------------------------

QUANT_LENGTHS = (1, 255, 1000, 4097, 65536)   # per rank, 3 ranks
# mamba2-130m's parameter count (the leaf total of its JAX init) over 8
# data-parallel ranks: the ZeRO-1 gradient sync's stacked f32 gradient
GRAD_PARAMS, GRAD_RANKS = 128_915_904, 8
GRAD_TIMED_RUNS = 3
SWEEP_P2P_RANKS, SWEEP_RING_RANKS = 48, 8


def build_all(libraries) -> None:
    """Build every kernel library at once: one nvcc per source, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.load(), libraries.values()))
    for name, lib in libraries.items():
        log(f"[build] {name}: nvcc {lib.seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def quant_bytes(P: int, n: int, block: int, itemsize: int,
                kind: str) -> int:
    """Bytes a quantize (or dequantize) call must move: each input byte read
    once, each output byte written once.  Quantize reads P*n values and
    writes every code of its blocks (the padded tail too) and one f32 scale
    per block; dequantize reads the P*n codes it needs and the scales and
    writes P*n values."""
    nb = -(-n // block)
    if kind == "quantize":
        return P * n * itemsize + P * nb * block + P * nb * 4
    return P * n + P * nb * 4 + P * n * itemsize


def check_quant(qops, qref, x, block) -> tuple[int, float]:
    """Kernels vs plain version on ``x``: scales bitwise, codes within one
    step, dequantized values bitwise for the same codes, and the round trip
    within 0.51 of the block's scale.  Returns the largest code difference
    and the largest dequantize difference."""
    q, s = qops.quantize(x, block)
    qr, sr = qref.quantize(x, block)
    P, n = x.shape[0], x[0].numel()
    check(torch.equal(s, sr), f"quantize scales differ (block {block}, "
          f"{tuple(x.shape)} {x.dtype})")
    codes = int((q.int() - qr.int()).abs().max().item()) if q.numel() else 0
    check(codes <= 1, f"quantize codes differ by {codes}")
    deq = 0.0
    for dt in (torch.float32, torch.bfloat16):
        d = qops.dequantize(q, s, tuple(x.shape), dt)
        dr = qref.dequantize(q, s, tuple(x.shape), dt)
        deq = max(deq, (d.float() - dr.float()).abs().max().item())
    check(deq == 0.0, f"dequantize differs from its plain version by {deq}")
    err = (qops.dequantize(q, s, tuple(x.shape), torch.float32)
           - x.float()).abs().reshape(P, -1)
    bound = 0.51 * s.expand(-1, -1, block).reshape(P, -1)[:, :n]
    check(bool((err <= bound).all()), "quantize round trip over 0.51 scale")
    return codes, deq


def phase_quant_kernels(dev, flush, bw) -> dict:
    """The int8 kernels against their plain version at the test shapes and
    at the gradient sync's full-size ring step, then timed at the main
    path's shape (block 256, f32)."""
    import torch.nn.functional as F
    from repro_torch.kernels.quant import ops as qops, ref as qref
    gen = torch.Generator(device=dev).manual_seed(2)
    seg = GRAD_PARAMS // GRAD_RANKS
    full = torch.randn((GRAD_RANKS, seg), generator=gen, device=dev) * 1e-3
    max_code, max_deq = 0, 0.0
    for block in (256, 1024):
        for dt in (torch.float32, torch.bfloat16):
            for n in QUANT_LENGTHS:
                x = (torch.randn((3, n), generator=gen, device=dev)
                     * torch.tensor([[0.5], [3.0], [40.0]], device=dev))
                c, d = check_quant(qops, qref, x.to(dt), block)
                max_code, max_deq = max(max_code, c), max(max_deq, d)
            c, d = check_quant(qops, qref, full.to(dt), block)
            max_code, max_deq = max(max_code, c), max(max_deq, d)
            log(f"[quant] block {block} {str(dt)[6:]}: test shapes and "
                f"{tuple(full.shape)} agree (codes within {c}, scales "
                f"bitwise, dequantize bitwise)")
    # How CUDA PyTorch divides by a Python scalar (the reason the plain
    # version divides tensor by tensor): scales of this input that a
    # reciprocal multiply rounds away from the IEEE amax / 127.
    amax = F.pad(full, (0, (-seg) % 256)).reshape(GRAD_RANKS, -1, 256) \
        .abs().amax(2)
    off = int(((amax / 127.0) != (amax / amax.new_full((), 127.0))).sum())
    log(f"[quant] amax / 127.0 (Python scalar) differs from the IEEE "
        f"division in {off} of {amax.numel()} scales of this input")
    q, s = qops.quantize(full, 256)
    shape = tuple(full.shape)
    cases = {"quantize": (lambda: qops.quantize(full, 256),
                          lambda: qref.quantize(full, 256)),
             "dequantize": (lambda: qops.dequantize(q, s, shape,
                                                    torch.float32),
                            lambda: qref.dequantize(q, s, shape,
                                                    torch.float32))}
    out = {}
    for name, (kern, plain) in cases.items():
        nbytes = quant_bytes(GRAD_RANKS, seg, 256, 4, name)
        k_ms, p_ms = time_ms(kern, flush), time_ms(plain, flush)
        out[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=nbytes / bw * 1e3,
                         bound_by="bytes", nbytes=nbytes,
                         max_abs_err=float(max_code if name == "quantize"
                                           else max_deq))
        log(f"[quant] {name} at {shape} block 256: kernel {k_ms * 1e3:.2f} "
            f"us, plain {p_ms * 1e3:.2f} us, bound {nbytes / bw * 1e6:.2f} "
            f"us ({nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s, bytes); "
            f"library call: none")
    return out


def time_cuda(fn, runs: int = GRAD_TIMED_RUNS) -> float:
    """Median ms of ``fn`` over ``runs`` CUDA-event timings after one warm
    run (for calls long enough that launch overhead does not count)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def with_plain_int8_wire(fn):
    """``fn()`` with the wire's int8 encode and decode taken from the plain
    version (``kernels/quant/ref.py``) instead of the kernels, on the same
    card: the same inputs, the same ring, the same reducer order."""
    from repro_torch.core import plugins
    from repro_torch.kernels.quant import ref as qref
    kernels = plugins.quant_ops
    plugins.quant_ops = qref
    try:
        return fn()
    finally:
        plugins.quant_ops = kernels


def phase_grad_sync(dev) -> dict:
    """The ZeRO-1 data-parallel gradient sync at full width: ring
    reduce-scatter then ring all-gather of mamba2-130m's f32 gradient over
    8 ranks, and the ring all-reduce, on the NONE, BF16 and INT8 wires.

    Gates: NONE within 1e-6 * sum_r |x_r| of ``x.sum(0)`` per element;
    BF16 within one bf16 rounding (2^-8 relative, 2^-9 plus the f32 sums'
    rounding) of ``sum_r |x_r|`` per element per hop; INT8 bitwise equal to
    the same ring run on the card through the plain quantizer, which
    tests/test_torch_quant.py holds bitwise to the JAX package's, plus one
    quantisation step (<= sum_r max|x_r| / 127) per hop as a sanity bound.
    Returns the INT8 run's kernel launches."""
    from repro_torch.core import collectives
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.config import CommConfig, Compression
    from repro_torch.kernels.quant import ops as qops
    comm = Communicator(("x",), (GRAD_RANKS,))
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = torch.randn((GRAD_RANKS, GRAD_PARAMS), generator=gen,
                        device=dev) * 1e-3
    exact = grads.sum(0)
    absum = grads.abs().sum(0)
    carried = grads.abs().amax(1).sum().item()   # bounds every carried sum
    hops = 2 * (GRAD_RANKS - 1)                  # rs + ag, or one all-reduce

    def zero1(cfg):
        seg = collectives.reduce_scatter(grads, comm, cfg)
        return collectives.all_gather(seg, comm, cfg)

    def run_all(cfg):
        return {"reduce_scatter+all_gather": zero1(cfg),
                "all_reduce": collectives.all_reduce(grads, comm, cfg)}

    launches, results = {}, {}
    for wire in ("none", "bf16", "int8"):
        cfg = CommConfig(algorithm="ring", compression=Compression(wire))
        qops.launches.update(quantize=0, dequantize=0)
        outs = run_all(cfg)
        torch.cuda.synchronize()
        if wire == "int8":
            launches = dict(qops.launches)
            check(launches == {"quantize": 2 * hops, "dequantize": 2 * hops},
                  f"int8 gradient sync launched {launches}, want "
                  f"{2 * hops} of each kernel")
            plain = with_plain_int8_wire(lambda: run_all(cfg))
            for k, out in outs.items():
                check(torch.equal(out, plain[k]),
                      f"int8 {k} differs from the plain int8 wire: max "
                      f"|kernel - plain| "
                      f"{(out - plain[k]).abs().max().item()}")
            log("[gradsync] int8 wire through the kernels is bitwise equal "
                "to the plain int8 wire on the same card, both collectives")
            del plain
        ms = {k: time_cuda(lambda k=k: zero1(cfg) if k.startswith("reduce")
                           else collectives.all_reduce(grads, comm, cfg))
              for k in outs}
        for k, out in outs.items():
            check(tuple(out.shape) == tuple(grads.shape)
                  and bool(torch.isfinite(out).all()), f"{wire} {k} shape")
            err = (out - exact).abs()
            if wire == "none":
                check(bool((err <= 1e-6 * absum).all()),
                      f"none {k} disagrees with x.sum(0)")
                results[k] = out
                bound = 0.0
            elif wire == "bf16":
                # one bf16 rounding of a partial sum (|p| <= sum_r |x_r|)
                # per hop, per element
                lim = hops * 2.0 ** -8 * absum
                check(bool((err <= lim).all()),
                      f"bf16 {k}: error over hops * 2^-8 * sum_r |x_r|")
                check(bool(((out - results[k]).abs() <= lim).all()),
                      f"bf16 {k} disagrees with the NONE wire")
                bound = lim.max().item()
                del lim
            else:
                # sanity bound; the gate is the bitwise check above
                bound = hops * carried / 127.0
                check(err.max().item() <= bound,
                      f"int8 {k}: error {err.max().item()} over {bound}")
                check((out - results[k]).abs().max().item() <= bound,
                      f"int8 {k} disagrees with the NONE wire")
            log(f"[gradsync] {wire} {k} on ({GRAD_RANKS}, {GRAD_PARAMS}) "
                f"f32: {ms[k]:.3f} ms; max|out - x.sum(0)| "
                f"{err.max().item():.3e} (bound {bound:.3e}), rms "
                f"{err.pow(2).mean().sqrt().item():.3e}")
            del err
        del outs
    log(f"[gradsync] int8 wire kernel launches: quantize "
        f"{launches['quantize']}, dequantize {launches['dequantize']}")
    profile_device_time("gradsync", lambda: collectives.all_reduce(
        grads, comm, CommConfig(algorithm="ring",
                                compression=Compression.INT8)))
    return launches


def profile_device_time(tag: str, fn) -> None:
    """Device time by kernel over one call of ``fn`` (already warm), and
    the card's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] profile: {len(rows)} kernel names, device busy "
        f"{busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms profiled wall time")
    for us, count, key in rows[:8]:
        log(f"[{tag}]   {us / 1e3:8.3f} ms  {count:5d} launches  {key[:70]}")


def summarize_sweep(db, topo, collectives, sizes) -> None:
    for coll in collectives:
        for size in sizes:
            best = db.best(coll, size, topo)
            if best is None:
                continue
            c = best.config
            log(f"[sweep] {topo} {coll} {size} B: {best.us_per_call:.2f} us "
                f"({c['mode']}/{c['scheduling']}/{c['transport']}/"
                f"w{c['window']}/{c['chunk_bytes']}B/{c['compression']}/"
                f"{c['algorithm']})")


def phase_sweep(dev, db_path) -> None:
    """The autotuner: sendrecv and the 4-neighbor exchange at 48 ranks over
    the fast axes, and the ring collectives at 8 ranks over the full axes
    at 1 MiB (every int8 ring candidate); the Eq. 1 fit on the 48-rank
    sendrecv points.  Saves the TuneDB to ``db_path``."""
    from repro_torch import tune
    from repro_torch.tune import sweep
    from repro_torch.kernels.quant import ops as qops
    t0 = time.perf_counter()
    db = tune.TuneDB()
    p2p = ("sendrecv", "multi_neighbor")
    ring = ("all_reduce", "reduce_scatter", "all_gather")
    stats = {}
    sweep.run_sweep(SWEEP_P2P_RANKS, collectives=p2p,
                    sizes=sweep.FULL_SIZES, fast=True, db=db, device=dev,
                    stats=stats)
    log(f"[sweep] {SWEEP_P2P_RANKS} ranks: {sweep.sweep_summary(stats)}")
    qops.launches.update(quantize=0, dequantize=0)
    stats = {}
    sweep.run_sweep(SWEEP_RING_RANKS, collectives=ring, sizes=(1 << 20,),
                    db=db, device=dev, stats=stats)
    log(f"[sweep] {SWEEP_RING_RANKS} ranks: {sweep.sweep_summary(stats)}")
    n_int8 = sum(1 for e in db.entries if e.config["compression"] == "int8")
    check(n_int8 == 3 * sum(1 for c in tune.enumerate_configs("all_reduce")
                            if c.compression.value == "int8"),
          f"the sweep measured {n_int8} int8 ring candidates")
    check(qops.launches["quantize"] > 0 and qops.launches["dequantize"] > 0,
          "the int8 ring candidates never launched the kernels")
    check(all(math.isfinite(e.us_per_call) and e.us_per_call > 0
              for e in db.entries), "a sweep entry is not a positive time")
    log(f"[sweep] int8 candidates: {n_int8}; kernel launches (captured "
        f"once per graph): quantize {qops.launches['quantize']}, dequantize "
        f"{qops.launches['dequantize']}")
    summarize_sweep(db, tune.topology_key(SWEEP_P2P_RANKS, dev), p2p,
                    sweep.FULL_SIZES)
    topo8 = tune.topology_key(SWEEP_RING_RANKS, dev)
    summarize_sweep(db, topo8, ring, (1 << 20,))
    for coll in ring:
        for wire in ("none", "bf16", "int8"):
            best = min((e for e in db.candidates(coll, topo8)
                        if e.config["compression"] == wire
                        and e.config["algorithm"] == "ring"),
                       key=lambda e: e.us_per_call)
            log(f"[sweep] {coll} 1 MiB best ring/{wire}: "
                f"{best.us_per_call:.2f} us ({best.config['scheduling']})")
    cal = tune.calibrate_from_db(db, tune.topology_key(SWEEP_P2P_RANKS, dev))
    log(f"[sweep] Eq. 1 fit on {SWEEP_P2P_RANKS}-rank sendrecv: "
        f"{cal.summary()}")
    db.save(db_path)
    log(f"[sweep] {len(db)} entries in {time.perf_counter() - t0:.1f} s")


def phase_auto(driver, sim, db_path, dev) -> int:
    """comm_cfg="auto" at full size from the sweep's TuneDB, flat and on a
    6x8 torus (per-round configs): each run bitwise equal to the same run
    with the selected configs given explicitly.  Returns swe_step
    launches."""
    from repro_torch import tune
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.config import Scheduling
    from repro_torch.core.topology import TorusSpec
    from repro_torch.kernels.swe_step import ops as swe_ops
    t0 = time.perf_counter()
    auto = driver.build_simulation(FULL_ELEMENTS, FULL_RANKS, "auto",
                                   device=dev, tune_db_path=db_path)
    auto.swe = sim.swe
    pm = sim.pm
    halo_bytes = int(pm.s_max) * 12
    spec = TorusSpec.parse("6x8")
    db = tune.TuneDB.load(db_path)
    topo = tune.topology_key(FULL_RANKS, dev)
    flat = Communicator(("data",), (FULL_RANKS,))
    want = tune.select_config(
        "multi_neighbor", halo_bytes, db=db, topo=topo,
        hops=flat.max_hops([e for r in pm.rounds for e in r]), torus="")
    check(auto.comm_cfg == want, f"auto picked {auto.comm_cfg}, the TuneDB "
          f"says {want}")
    cfg_t, rounds_t = driver._resolve_comm_cfg("auto", pm, spec, dev,
                                              db_path, "latency")
    torus = Communicator(("data",), (FULL_RANKS,), topo=spec)
    explicit_rounds = [dataclasses.replace(tune.select_config(
        "multi_neighbor", halo_bytes, db=db, topo=topo,
        hops=max(1, torus.max_hops(r)), torus=spec.name),
        scheduling=cfg_t.scheduling) for r in pm.rounds]
    if rounds_t is not None:
        check(rounds_t == explicit_rounds, "per-round configs differ")
    runs = {
        "flat": (auto, dataclasses.replace(sim, comm_cfg=want)),
        "6x8 torus": (
            dataclasses.replace(auto, topology=spec, comm_cfg=cfg_t,
                                round_cfgs=rounds_t),
            dataclasses.replace(sim, topology=spec, comm_cfg=cfg_t,
                                round_cfgs=(None if rounds_t is None
                                            else explicit_rounds)))}
    swe_ops.launches = 0
    for label, (a, e) in runs.items():
        states = []
        for s in (a, e):
            if s.comm_cfg.scheduling == Scheduling.HOST:
                states.append(run_host(driver, s)[0])
            else:
                states.append(run_fused(driver, s)[0])
        check(torch.equal(*states), f"auto ({label}) differs from the run "
              f"with its configs given explicitly")
        check(bool(torch.isfinite(states[0]).all()), f"auto ({label}) NaN")
        c = a.comm_cfg
        log(f"[auto] {label}: {c.mode.value}/{c.scheduling.value}/"
            f"{c.transport.value}/w{c.window}/{c.chunk_bytes}B, per-round "
            f"configs {'none' if a.round_cfgs is None else len(set(a.round_cfgs))}"
            f"; bitwise equal to the explicit run over {STEPS} steps")
    launched = swe_ops.launches
    check(launched > 0, "the autotuned runs never launched swe_step")
    log(f"[auto] {time.perf_counter() - t0:.1f} s; swe_step launches "
        f"{launched}")
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG,
                                         CommConfig, Scheduling)
    from repro_torch.core.topology import TorusSpec
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.swe_step import ops as swe_ops, ref as swe_ref
    from repro_torch.swe import driver
    from repro_torch.swe.dg_solver import FLOP_PER_ELEMENT, SWEConfig

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. the card and the build ------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_all({"swe_step": swe_ops.LIBRARY, "quant": quant_ops.LIBRARY})
    log(f"[build] both libraries built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    bw = card_bandwidth(name)

    # -- 2. kernel against its plain version ----------------------------
    max_err = 0.0
    for E in (100, 512, 1300):
        args, rows = random_inputs(1, E, 3 * E, E, dev)
        got, want = (swe_ops.swe_step(*args, dt=1e-4),
                     swe_ref.swe_step_ref(*args, dt=1e-4))
        base = torch.rand_like(got)
        got_b = swe_ops.swe_step(*args, dt=1e-4, rows=rows, out=base.clone())
        want_b = swe_ref.swe_step_ref(*args, dt=1e-4, rows=rows,
                                      out=base.clone())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_b = (got_b - want_b).abs().max().item()
        log(f"[kernel] swe_step E={E}: max|kernel-plain| {err:.3e}, with "
            f"row list {err_b:.3e} (atol {ATOL_KERNEL})")
        check(err <= ATOL_KERNEL and err_b <= ATOL_KERNEL,
              f"swe_step disagrees with its plain version at E={E}")
        max_err = max(max_err, err, err_b)

    t0 = time.perf_counter()
    sim = driver.build_simulation(FULL_ELEMENTS, FULL_RANKS, CommConfig(),
                                  device=dev)
    # SWEConfig's default dt (1e-4) suits meshes of a few thousand elements;
    # at full size it is ~26x over the explicit scheme's CFL limit and the
    # state blows up.  Take the Courant-limited step of this mesh instead.
    sim.swe = SWEConfig(dt=stable_dt(sim))
    pm = sim.pm
    log(f"[setup] bight mesh {sim.mesh.n_elements} elements on {pm.n_parts} "
        f"ranks: E_max {pm.e_max}, H_max {pm.h_max}, S_max {pm.s_max}, "
        f"rounds {pm.n_rounds}, N_max {pm.n_max}, B_max "
        f"{pm.boundary_idx.shape[1]}, dt {sim.swe.dt:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    sa = driver._static_args(sim)
    gen = torch.Generator(device=dev).manual_seed(0)
    halo = 1.0 + 0.1 * torch.rand((pm.n_parts, pm.h_max, 3), generator=gen,
                                  device=dev)
    full_args = [sim.state, halo, sa["normals"], sa["neigh_idx"],
                 sa["edge_type"], sa["area"], sa["valid"],
                 torch.ones((), dtype=torch.float32, device=dev)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for label, rows in (("full pass", None),
                        ("boundary rows", sa["boundary_idx"])):
        if rows is None:
            kern = lambda: swe_ops.swe_step(*full_args, dt=1e-4)
            plain = lambda: swe_ref.swe_step_ref(*full_args, dt=1e-4)
        else:
            base = swe_ops.swe_step(*full_args, dt=1e-4)
            out_k, out_p = base.clone(), base.clone()
            kern = lambda: swe_ops.swe_step(*full_args, dt=1e-4, rows=rows,
                                            out=out_k)
            plain = lambda: swe_ref.swe_step_ref(*full_args, dt=1e-4,
                                                 rows=rows, out=out_p)
        err = (kern() - plain()).abs().max().item()
        check(err <= ATOL_KERNEL,
              f"swe_step disagrees with its plain version at full size "
              f"({label}): {err}")
        max_err = max(max_err, err)
        nbytes = kernel_bytes(full_args, rows)
        n_rows = pm.n_parts * (pm.e_max if rows is None else rows.shape[1])
        bound_bytes_ms = nbytes / bw * 1e3
        bound_ops_ms = n_rows * FLOP_PER_ELEMENT / F32_FLOP_PER_S * 1e3
        k_ms, p_ms = time_ms(kern, flush), time_ms(plain, flush)
        timings[label] = dict(ms=k_ms, plain_ms=p_ms,
                              bound_ms=max(bound_bytes_ms, bound_ops_ms),
                              bound_by=("bytes" if bound_bytes_ms
                                        >= bound_ops_ms else "operations"),
                              nbytes=nbytes)
        log(f"[kernel] swe_step {label} at ({pm.n_parts}, {pm.e_max}): "
            f"max|kernel-plain| {err:.3e}; kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, bound {timings[label]['bound_ms'] * 1e3:.2f}"
            f" us ({nbytes / 1e6:.2f} MB at {bw / 1e12:.2f} TB/s, "
            f"{timings[label]['bound_by']}); library call: none")

    quant_timings = phase_quant_kernels(dev, flush, bw)

    # -- 3. main path at full size -------------------------------------
    modes = (("fused", CommConfig(), 1 + N_INNER),
             ("overlapped", OVERLAPPED_CONFIG, 2 + 2 * N_INNER),
             ("host", BASELINE_CONFIG, STEPS))
    m0 = mass(sim, sim.state)
    finals, launches_by_mode, step_us = {}, {}, {}
    swe_ops.launches = 0
    for label, cfg, want_launches in modes:
        msim = dataclasses.replace(sim, comm_cfg=cfg)
        before = swe_ops.launches
        if cfg.scheduling == Scheduling.HOST:
            state, us = run_host(driver, msim)
        else:
            state, us = run_fused(driver, msim)
        launches_by_mode[label] = swe_ops.launches - before
        finals[label], step_us[label] = state, us
        drift = (mass(sim, state) - m0) / m0
        log(f"[main] {label}: {us:.1f} us/step over {STEPS} steps; mass drift "
            f"{drift:.3e}; kernel launches {launches_by_mode[label]}")
        check(launches_by_mode[label] == want_launches,
              f"{label}: {launches_by_mode[label]} kernel launches, want "
              f"{want_launches}")
        check(bool(torch.isfinite(state).all()), f"{label}: non-finite state")
        check(abs(drift) < MASS_DRIFT, f"{label}: mass drift {drift}")
    main_launches = swe_ops.launches
    for label in ("overlapped", "host"):
        check(torch.equal(finals[label], finals["fused"]),
              f"{label} final state differs from fused")
    log(f"[main] fused, overlapped and host final states bitwise equal; "
        f"swe_step launched {main_launches} times (a captured launch counts "
        f"once; each fused/overlapped graph replays it {N_INNER} or "
        f"{2 * N_INNER} times per segment)")
    plain_state, plain_us = run_fused(driver, sim,
                                      update=swe_ref.swe_step_ref)
    diff = (plain_state - finals["fused"]).abs().max().item()
    log(f"[main] fused with the plain version: {plain_us:.1f} us/step, "
        f"max|plain-kernel| after {STEPS} steps {diff:.3e} "
        f"(atol {ATOL_PLAIN_RUN})")
    check(diff <= ATOL_PLAIN_RUN, "plain-version run disagrees with kernel")

    profile_segment(driver, sim, step_us["fused"])

    # -- 4. routing ----------------------------------------------------
    small = driver.build_simulation(1696, 8, CommConfig(), device=dev)
    for label, flat_sim, spec, flat_state in (
            ("1696 elements, 2x4 torus", small, "2x4", None),
            (f"{sim.mesh.n_elements} elements, 6x8 torus", sim, "6x8",
             finals["fused"])):
        if flat_state is None:
            flat_state, _ = run_fused(driver, flat_sim)
        torus_sim = dataclasses.replace(flat_sim,
                                        topology=TorusSpec.parse(spec))
        torus_state, us = run_fused(driver, torus_sim)
        check(torch.equal(torus_state, flat_state),
              f"{label}: torus state differs from flat")
        log(f"[routing] {label}: bitwise equal to flat ({us:.1f} us/step)")

    # -- 5. the int8 wire: gradient sync, sweep, autotuned SWE ----------
    quant_launches = phase_grad_sync(dev)
    db_path = Path(__file__).resolve().parent / ".repro_tune" / \
        "chip_smoke_tunedb.json"
    phase_sweep(dev, db_path)
    phase_auto(driver, sim, db_path, dev)

    # -- 6. summary ----------------------------------------------------
    log(f"kernels: swe_step launches={main_launches} "
        + " ".join(f"{k}={v}" for k, v in launches_by_mode.items())
        + " ".join(f"; {k} launches={v} (gradient sync)"
                   for k, v in quant_launches.items()))
    full = timings["full pass"]
    rows = [{
        "name": "swe_step", "route": "cuda",
        "source": "src/repro_torch/kernels/swe_step/csrc/swe_step.cu",
        "replaces": "src/repro/kernels/swe_step/swe_step.py:83",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None}]
    for kname, line in (("quantize", 34), ("dequantize", 60)):
        t = quant_timings[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/quant/csrc/quant.cu",
            "replaces": f"src/repro/kernels/quant/quant.py:{line}",
            "launches": quant_launches[kname],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
