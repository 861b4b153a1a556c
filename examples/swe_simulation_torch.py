"""End-to-end shallow-water simulation on the PyTorch port (the paper's
application, §4), all partitions stacked on one CUDA card.

Run:  PYTHONPATH=src python examples/swe_simulation_torch.py [--elements 2000]
      (add --device cpu to run the plain PyTorch path on the CPU; add
      --plan-dir DIR to persist the exchange's plans: a rerun replays them)

Simulates tidal flow in a synthetic bight over ``--partitions`` ranks with
the ACCL-X halo exchange and reports the step time and mass conservation,
then the Eq. 2/3 scalability model for the paper's configurations on the
H100's constants.  ``--comm auto`` takes the halo exchange's config from the
TuneDB that ``python -m repro_torch.tune.sweep`` wrote for this device.
"""
import argparse
import hashlib
import time

import numpy as np
import torch

from repro_torch.core import latmodel, planstore, plans
from repro_torch.core.config import (BASELINE_CONFIG, H100, OVERLAPPED_CONFIG,
                                     CommConfig)
from repro_torch.core.topology import TorusSpec
from repro_torch.runtime.fault_tolerance import StepWatchdog
from repro_torch.swe import driver


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--comm", default="streaming",
                    choices=("streaming", "overlapped", "baseline", "auto"),
                    help="halo-exchange config: the paper's streaming/baseline"
                         " constants, 'overlapped' = exchange on a second"
                         " stream with the interior/boundary split, or 'auto'"
                         " = pick from the TuneDB sweep (python -m "
                         "repro_torch.tune.sweep)")
    ap.add_argument("--objective", default="latency",
                    choices=("latency", "e2e"),
                    help="with --comm auto: rank TuneDB entries by bare "
                         "exchange latency or by the measured halo-fold "
                         "consumer loop (sweep with --objective e2e first)")
    ap.add_argument("--tune-db", default=None,
                    help="TuneDB path for --comm auto (default "
                         "$REPRO_TUNE_DB or .repro_tune/tunedb.json)")
    ap.add_argument("--topology", default=None,
                    help="place the partitions on a virtual torus, e.g. "
                         "'2x4' or '2x4:snake' (rows x cols = partitions); "
                         "multi-hop halo edges route through intermediate "
                         "partitions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--plan-dir", default=None,
                    help="persist CommPlans to this directory (or set "
                         "REPRO_PLAN_DIR): a rerun of the same simulation "
                         "replays its schedules from disk")
    args = ap.parse_args()

    if args.plan_dir is not None:
        planstore.configure(args.plan_dir)
    store = planstore.active()
    if store is not None:
        print(f"plan store: {store.root} "
              f"({store.entry_count()} entries on disk)")

    cfg = {"streaming": CommConfig(), "overlapped": OVERLAPPED_CONFIG,
           "baseline": BASELINE_CONFIG, "auto": "auto"}[args.comm]
    topology = TorusSpec.parse(args.topology) if args.topology else None
    sim = driver.build_simulation(args.elements, args.partitions, cfg,
                                  topology=topology, device=args.device,
                                  tune_db_path=args.tune_db,
                                  objective=args.objective)
    dev = sim.device
    print(f"comm config ({args.comm}): {sim.comm_cfg}")
    print(f"mesh: {sim.mesh.n_elements} elements over {args.partitions} "
          f"partitions on {dev} (N_max={sim.pm.n_max}, "
          f"rounds={sim.pm.n_rounds}"
          + (f", torus={topology.name}" if topology else "") + ")")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def mass(state):
        s = state.detach().cpu().numpy().astype(np.float64)
        return float(np.sum(s[..., 0] * sim.pm.area * sim.pm.valid))

    m0 = mass(sim.state)
    n_inner = 20
    if sim.round_cfgs is not None:
        print(f"per-round configs: {len(set(sim.round_cfgs))} distinct over "
              f"{len(sim.round_cfgs)} rounds")
    if sim.comm_cfg.scheduling.value == "host":
        runner = driver.make_host_scheduled_runner(sim)
        sync()
        t0 = time.perf_counter()
        state, _ = runner.run(sim.state, 0.0, args.steps)
        sync()
        steps = args.steps
    else:
        run = driver.make_sim_runner(sim, n_inner=n_inner)
        state = run(sim.state, 0.0)          # first segment: warm
        sync()
        # Segment-level watchdog: each 20-step launch is one "step" — a slow
        # segment (straggling host) shows up as a watchdog.straggler
        # instant in the trace and on the watchdog.stragglers counter.
        watchdog = StepWatchdog(warmup=2, window=16)
        t = n_inner * sim.swe.dt
        t0 = time.perf_counter()
        for i in range(args.steps // n_inner - 1):
            watchdog.start_step(i)
            state = run(state, t)
            sync()
            watchdog.end_step()
            t += n_inner * sim.swe.dt
        sync()
        steps = max(args.steps - n_inner, 1)
    us = (time.perf_counter() - t0) / steps * 1e6
    m1 = mass(state)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU (plain PyTorch path)")
    print(f"ran {args.steps} steps, {us:.1f} us/step on {name}")
    print(f"mass conservation: {m0:.6f} -> {m1:.6f} "
          f"(drift {(m1 - m0) / m0:.2e})")
    if sim.comm_cfg.scheduling.value != "host":
        print(f"watchdog: median segment {watchdog.median_step*1e3:.1f}ms, "
              f"{len(watchdog.events)} straggler(s)")
    digest = hashlib.sha256(state.detach().cpu().numpy().tobytes())
    print(f"final state digest: {digest.hexdigest()[:16]}")
    if store is not None:
        st = plans.cache_stats()
        print(f"plan store: {st['disk_hits']} disk hits / "
              f"{st['disk_misses']} misses / {st['disk_writes']} writes "
              f"-> {store.root} ({store.entry_count()} entries)")

    # Eq. 2/3 model (with the overlap term) on the H100's constants
    w = driver.build_workload(sim)
    n = args.partitions
    print("\nEq.2/3 model + overlap term (this partitioning, H100 "
          "constants):")
    for label, c in (("MPI+PCIe baseline", BASELINE_CONFIG),
                     ("ACCL-X streaming", CommConfig()),
                     ("ACCL-X overlapped", OVERLAPPED_CONFIG)):
        thr = latmodel.eq2_throughput_overlap(w, c, H100) * n
        stall = latmodel.stall_fraction_overlap(w, c, H100)
        print(f"  {label:20s}: {thr/1e9:8.2f} GFLOP/s "
              f"(pipeline stall {stall*100:.0f}%, "
              f"overlap {latmodel.overlap_fraction(c)*100:.0f}%)")


if __name__ == "__main__":
    main()
