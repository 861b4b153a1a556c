#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises and the script
exits non-zero:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel from this checkout's sources;
2. every kernel held against its plain PyTorch version on the card, at the
   test shapes and at the main path's full-size shapes, with and without the
   boundary row list, and timed with CUDA events beside its bound;
3. the main path at full size — the bight mesh at 312,000 target elements
   (270,886 elements) on 48 stacked ranks — under the fused, overlapped and
   host-scheduled configurations for 200 steps (20-step segments): final
   states bitwise equal, mass drift, finiteness, and the kernel launch
   counts; then one fused run with the plain version, against the kernel run,
   and a profile of one fused segment (device time by kernel);
4. routing: the 1696-element mesh on a 2x4 torus (8 ranks) and the full size
   on a 6x8 torus (48 ranks), each bitwise equal to its flat run;
5. a ``kernels:`` line, the kernel table as one JSON line, and as the last
   line ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one, or when the repository
is missing beside it.
"""
from __future__ import annotations

import dataclasses
import json
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG,
                                         CommConfig, Scheduling)
    from repro_torch.core.topology import TorusSpec
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
    swe_ops.load_library()
    log(f"[build] swe_step: nvcc {swe_ops.build_seconds:.2f} s, loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in swe_ops.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
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

    # -- 5. summary ----------------------------------------------------
    log(f"kernels: swe_step launches={main_launches} "
        + " ".join(f"{k}={v}" for k, v in launches_by_mode.items()))
    full = timings["full pass"]
    log(json.dumps({"kernels": [{
        "name": "swe_step", "route": "cuda",
        "source": "src/repro_torch/kernels/swe_step/csrc/swe_step.cu",
        "replaces": "src/repro/kernels/swe_step/swe_step.py:83",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None}]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
