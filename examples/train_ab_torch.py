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

With ``--profile`` each tree then trains once more under
``torch.profiler`` (not timed): the run's device time by kernel name over
its N steps, per step, and the flash kernels' share (names holding
``flash``), printed beside the timed runs' ms/step:

    PYTHONPATH=src python examples/train_ab_torch.py --trees OLD . \
        --profile -- --arch gemma3-1b --full-size --layers 26 --dp 2 \
        --tp 4 --seq 1024 --batch 8 --steps 4 --lr 3e-4 --seed 0

With ``--ssd-bwd`` each run times only the SSD scan's backward instead, at
mamba2-130m's training shape in bf16 (``chip_smoke.py``'s SSD_TRAIN) under
the model's steep decay and a shallow one: ``torch.autograd.grad`` through
the tree's own ``ssd_chunked`` (its forward's buffers kept), CUDA events,
the L2 flushed before each call, the median of 60; each run also prints a
digest of the gradients' bits per decay, so two trees that should compute
the same bits show it:

    PYTHONPATH=src python examples/train_ab_torch.py --trees OLD . --ssd-bwd
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


# mamba2-130m's training shape (chip_smoke.py's SSD_TRAIN): 8 stacked
# ranks x 4 sequences, 2048 tokens in 16 chunks of 128, 6 heads of 64,
# state 128
SSD_TRAIN = (8, 4, 2048, 6, 64, 128, 128)
SSD_RUNS = 60


def ssd_bwd_worker(tree: Path) -> dict:
    """The SSD backward of ``tree``'s ``ssd_chunked`` at SSD_TRAIN in bf16,
    per decay: the median CUDA-event ms of SSD_RUNS calls of
    ``torch.autograd.grad(y, leaves, dy, retain_graph=True)``, each after an
    L2 flush and a sleep kernel that lets the host queue the call, and a
    digest of the gradients' bits (``<decay>_digest``)."""
    import hashlib

    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.ssd_scan import ops
    dev = torch.device("cuda", 0)
    R, B, S, H, P, N, L = SSD_TRAIN
    gen = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for decay in ("steep", "shallow"):
        if decay == "steep":   # the model's: dt = softplus(N(0, 1)), A to -16
            dt = torch.nn.functional.softplus(rnd(R, B, S, H))
            a = -torch.linspace(1.0, 16.0, R * H, device=dev).view(R, H)
        else:
            dt, a = rnd(R, B, S, H).abs() * 0.1 + 0.01, -(rnd(R, H).abs() + 0.5)
        leaves = [t.detach().requires_grad_(True) for t in (
            rnd(R, B, S, H, P).bfloat16(), dt, a, rnd(R, B, S, 1, N).bfloat16(),
            rnd(R, B, S, 1, N).bfloat16())]
        dy = rnd(R, B, S, H, P)
        y, _ = ops.ssd_chunked(*leaves, L)
        call = lambda: torch.autograd.grad(y, leaves, dy,  # noqa: E731
                                           retain_graph=True)
        h = hashlib.sha256()
        for g in call():
            h.update(g.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out[f"{decay}_digest"] = h.hexdigest()[:16]
        torch.cuda.synchronize()
        before, times = ops.bwd_launches, []
        for _ in range(SSD_RUNS):
            torch.cuda._sleep(4_000_000)
            flush.zero_()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            call()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        assert ops.bwd_launches == before + SSD_RUNS, "the kernel did not run"
        out[decay] = statistics.median(times)
        del y, leaves, call
    return out


# tiny spin kernels that open a profile: the profiler loses its first
# device records most often (chip_smoke.py's LEAD_IN)
LEAD_IN = 256


def worker(tree: Path, flags: list, profile: bool = False) -> dict:
    """One training run of ``tree`` in this process -> its median ms/step
    over steps 2..N and its loss stream; with ``profile``, under
    ``torch.profiler``, also the device ms a step (the run's over its N
    steps) in all and by kernel name, the eight largest, and the flash
    kernels' (``flash_ms_per_step``)."""
    import torch
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", tree / "examples" / "train_lm_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    from repro_torch.obs import trace as obs_trace
    obs_trace.configure("1")
    args = ex.parser().parse_args(flags)
    if not profile:
        res = ex.run(args, log=lambda *_: None)
        ms, steps = step_ms(obs_trace.events())
        return {"ms_per_step": ms, "steps": steps, "loss": res["history"]}
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(100)
        res = ex.run(args, log=lambda *_: None)
        torch.cuda.synchronize()
    ms, steps = step_ms(obs_trace.events())
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.count // steps,
                    e.key) for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and "spin_kernel" not in e.key), reverse=True)
    return {"profiled_ms_per_step": ms, "steps": steps,
            "loss": res["history"],
            "device_ms_per_step": sum(r[0] for r in rows),
            "flash_ms_per_step": sum(r[0] for r in rows if "flash" in r[2]),
            "top": [[round(t, 3), n, k[:90]] for t, n, k in rows[:8]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--ssd-bwd", action="store_true",
                    help="time only the SSD scan's backward")
    ap.add_argument("--profile", action="store_true",
                    help="then train each tree once more under the "
                    "profiler (device time by kernel, flash kernels' share)")
    ap.add_argument("flags", nargs="*", help="train_lm_torch.py flags")
    args = ap.parse_args()
    flags = args.flags or TRAIN_FLAGS
    if args.worker:
        tree = Path(args.worker).resolve()
        print(json.dumps(ssd_bwd_worker(tree) if args.ssd_bwd
                         else worker(tree, flags, args.profile)))
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    trees = [Path(t).resolve() for t in args.trees]
    runs, profiles = [], []
    order = [(t, False) for t in (trees[0], trees[1], trees[1], trees[0])]
    if args.profile and not args.ssd_bwd:
        order += [(t, True) for t in trees]
    for tree, prof in order:
        mode = ["--ssd-bwd"] if args.ssd_bwd else []
        mode += ["--profile"] if prof else []
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree), *mode, "--",
             *flags],
            capture_output=True, text=True,
            # one allocator setting for both trees: growable segments,
            # which leave neither tree's run at the mercy of fragmentation
            env=dict(os.environ, PYTHONPATH=str(tree / "src"),
                     PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        if prof:
            profiles.append({"tree": str(tree), **out})
            print(f"{tree}: profiled run, device "
                  f"{out['device_ms_per_step']:.1f} ms a step (over its "
                  f"{out['steps']} steps), the flash "
                  f"kernels {out['flash_ms_per_step']:.1f} ms; largest: "
                  f"{out['top']}", flush=True)
            continue
        runs.append({"tree": str(tree), **out})
        if args.ssd_bwd:
            print(f"{tree}: SSD backward {out['steep'] * 1e3:.2f} us steep, "
                  f"{out['shallow'] * 1e3:.2f} us shallow (median of "
                  f"{SSD_RUNS}); gradient digests {out['steep_digest']}, "
                  f"{out['shallow_digest']}", flush=True)
        else:
            print(f"{tree}: {out['ms_per_step']:.1f} ms/step (median of "
                  f"steps 2-{out['steps']}), loss {out['loss'][0]:.4f} -> "
                  f"{out['loss'][-1]:.4f}", flush=True)
    keys = ("steep", "shallow") if args.ssd_bwd else ("ms_per_step",)
    mean = {str(t): {k: statistics.mean(r[k] for r in runs
                                        if r["tree"] == str(t))
                     for k in keys} for t in trees}
    print(json.dumps({"runs": runs, "mean": mean, "profiles": profiles}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
