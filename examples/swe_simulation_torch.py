"""End-to-end shallow-water simulation on the PyTorch port (the paper's
application, §4), all partitions stacked on one CUDA card.

Run:  PYTHONPATH=src python examples/swe_simulation_torch.py [--elements 2000]
      (add --device cpu to run the plain PyTorch path on the CPU)

Simulates tidal flow in a synthetic bight over ``--partitions`` ranks with
the ACCL-X halo exchange and reports the step time and mass conservation.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.config import BASELINE_CONFIG, OVERLAPPED_CONFIG, CommConfig
from repro_torch.core.topology import TorusSpec
from repro_torch.swe import driver


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--comm", default="streaming",
                    choices=("streaming", "overlapped", "baseline"),
                    help="halo-exchange config: the paper's streaming/baseline"
                         " constants, or 'overlapped' = exchange on a second"
                         " stream with the interior/boundary split")
    ap.add_argument("--topology", default=None,
                    help="place the partitions on a virtual torus, e.g. "
                         "'2x4' or '2x4:snake' (rows x cols = partitions); "
                         "multi-hop halo edges route through intermediate "
                         "partitions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    cfg = {"streaming": CommConfig(), "overlapped": OVERLAPPED_CONFIG,
           "baseline": BASELINE_CONFIG}[args.comm]
    topology = TorusSpec.parse(args.topology) if args.topology else None
    sim = driver.build_simulation(args.elements, args.partitions, cfg,
                                  topology=topology, device=args.device)
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
    if args.comm == "baseline":
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
        t = n_inner * sim.swe.dt
        t0 = time.perf_counter()
        for _ in range(args.steps // n_inner - 1):
            state = run(state, t)
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


if __name__ == "__main__":
    main()
