"""Time the SWE main path's captured segments of two checkouts of this
repository in turn on one card: A, B, B, A, each a fresh process, so that
the card's drift and the noise between calls fall on both trees alike.

Run (card only):

    PYTHONPATH=src python examples/swe_ab_torch.py --trees OLD_TREE .

Each run imports the tree's own ``src`` and ``chip_smoke.py`` and times the
fused and the overlapped schedule as that script's main path does
(``run_fused``: the full-size bight mesh on 48 stacked ranks, 200 steps in
20-step captured segments, each timing a fresh capture), ``--reps`` times
each in turn, plus the host's time to issue one segment (no
synchronisation: the copies in, the replay, the copy out).  It prints each
run's medians; the last line is one JSON object with every run's readings
and each tree's median over its runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def worker(tree: Path, reps: int) -> dict:
    """``reps`` timings of each schedule of ``tree`` in this process ->
    µs/step per timing, and the host's µs to issue a fused segment."""
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from repro_torch.core.config import OVERLAPPED_CONFIG, CommConfig
    from repro_torch.swe import driver
    from repro_torch.swe.dg_solver import SWEConfig
    sim = driver.build_simulation(cs.FULL_ELEMENTS, cs.FULL_RANKS,
                                  CommConfig(), device="cuda")
    sim.swe = SWEConfig(dt=cs.stable_dt(sim))
    modes = {"fused": CommConfig(), "overlapped": OVERLAPPED_CONFIG}
    out: dict = {label: [] for label in modes}
    for _ in range(reps):
        for label, cfg in modes.items():
            out[label].append(cs.run_fused(
                driver, dataclasses.replace(sim, comm_cfg=cfg))[1])
    run = driver.make_sim_runner(sim, cs.N_INNER)
    state = run(sim.state, 0.0)
    issue = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run(state, 0.0)
        issue.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    out["issue_us"] = statistics.median(issue)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker).resolve(), args.reps)))
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    trees = [Path(t).resolve() for t in args.trees]
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree), "--reps",
             str(args.reps)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"tree": str(tree), **out})
        print(f"{tree}: fused {statistics.median(out['fused']):.1f}, "
              f"overlapped {statistics.median(out['overlapped']):.1f} "
              f"us/step (medians of {args.reps}: fused {out['fused']}); "
              f"a fused segment issued in {out['issue_us']:.1f} us",
              flush=True)
    median = {str(t): {k: statistics.median(
        x for r in runs if r["tree"] == str(t)
        for x in (r[k] if isinstance(r[k], list) else [r[k]]))
        for k in ("fused", "overlapped", "issue_us")} for t in trees}
    print(json.dumps({"runs": runs, "median": median}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
