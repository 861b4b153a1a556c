"""Time LM training steps of two checkouts of this repository in turn on
one card: A, B, B, A, each a fresh process, so that the card's drift and
the noise between calls fall on both trees alike.

Run (card only):

    PYTHONPATH=src python examples/train_ab_torch.py --trees OLD_TREE .

Each run imports the tree's own ``src`` and drives its own
``examples/train_lm_torch.py`` (``run``) at the flags after ``--`` (by
default ``chip_smoke.py``'s training main path: qwen3-8b at full width, 4
layers, ``(data=2, model=4)``, ZeRO-1, 8 x 1024 tokens, 8 steps, here with
no checkpoint) with the ``train.step`` spans on, both trees under one
allocator setting, and prints the median ms/step over steps 2..N;
the last line is one JSON object with every run's reading and each tree's
mean.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# chip_smoke.py's training main path, with no checkpoint (a full-width
# save is 17 GB of disk writes and runs beside the timed steps)
TRAIN_FLAGS = ["--arch", "qwen3-8b", "--full-size", "--layers", "4", "--dp",
               "2", "--tp", "4", "--seq", "1024", "--batch", "8", "--steps",
               "8", "--lr", "3e-4", "--seed", "0", "--ckpt-every", "1000"]


def step_ms(events) -> tuple[float, int]:
    """The median ``train.step`` span of trace ``events``, in ms, over steps
    2..N (the first compiles and fills the caches), and N."""
    durs = [e["dur"] for e in events if e.get("name") == "train.step"]
    return statistics.median(durs[1:]) / 1e3, len(durs)


def worker(tree: Path, flags: list) -> dict:
    """One training run of ``tree`` in this process -> its median ms/step
    over steps 2..N and its loss stream."""
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", tree / "examples" / "train_lm_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    from repro_torch.obs import trace as obs_trace
    obs_trace.configure("1")
    res = ex.run(ex.parser().parse_args(flags), log=lambda *_: None)
    ms, steps = step_ms(obs_trace.events())
    return {"ms_per_step": ms, "steps": steps, "loss": res["history"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("flags", nargs="*", help="train_lm_torch.py flags")
    args = ap.parse_args()
    flags = args.flags or TRAIN_FLAGS
    if args.worker:
        print(json.dumps(worker(Path(args.worker).resolve(), flags)))
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    trees = [Path(t).resolve() for t in args.trees]
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree), "--", *flags],
            capture_output=True, text=True,
            # one allocator setting for both trees: growable segments,
            # which leave neither tree's run at the mercy of fragmentation
            env=dict(os.environ, PYTHONPATH=str(tree / "src"),
                     PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"tree": str(tree), **out})
        print(f"{tree}: {out['ms_per_step']:.1f} ms/step (median of steps "
              f"2-{out['steps']}), loss {out['loss'][0]:.4f} -> "
              f"{out['loss'][-1]:.4f}", flush=True)
    mean = {str(t): statistics.mean(r["ms_per_step"] for r in runs
                                    if r["tree"] == str(t)) for t in trees}
    print(json.dumps({"runs": runs, "mean_ms_per_step": mean}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
