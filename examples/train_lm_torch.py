"""End-to-end LM training on the PyTorch port: the twin of
``examples/train_lm.py``, with the same flags.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 200   # card
      PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
      PYTHONPATH=src python examples/train_lm_torch.py --arch gemma3-1b \
          --full-size --layers 26 --dp 2 --tp 4 --seq 1024 --batch 8  # card

The full production stack on stacked ranks: the train step over a
``(data, model)`` mesh (``--dp`` x ``--tp``, the reference's 8-device
``(4, 2)`` by default), ACCL-X collectives (the TP combines under
``--comm``, the ZeRO-1 reduce-scatter under ``--grad-comm``), the
synthetic data pipeline, async checkpoints, the straggler watchdog and the
preemption drain.  On the card attention runs the hand-written CUDA
flash-attention kernels, forward and backward, and the step runs under
deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA
starts).

``--fsdp`` gathers each layer's data-sharded weights at use (ZeRO-3 over
the data axis), ``--seq-parallel`` runs the dense blocks under
Megatron-SP, and ``--remat-policy dots`` keeps the weight products'
outputs for the backward (``build_session``'s own arguments and
``ModelConfig.remat_policy``).

``--arch`` defaults to mamba2-130m, as the reference example does: on the
card its SSD scan runs the hand-written CUDA forward and backward kernels
(``--seq`` must be whole SSD chunks: 128 with ``--full-size``, 32
without).  Without ``--full-size`` the model is a ~100M-parameter
reduction of the family in float32, as in the reference; ``--full-size``
takes the published widths in bf16 at ``--layers`` layers (mamba2-130m's
24 and gemma3-1b's 26 fit one 80 GB card, full qwen3-8b does not).
gemma3-1b trains its 5:1 local/global stack: one recomputed unit per
super-block of five windowed layers and a global one, the trailing layers
windowed and not recomputed.
"""
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.config import (OVERLAPPED_CONFIG, CommConfig,  # noqa: E402
                                     Compression)
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import mesh as mesh_mod, setup  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import loop as loop_mod  # noqa: E402

COMMS = {"fused": CommConfig(), "overlapped": OVERLAPPED_CONFIG,
         "auto": "auto"}
GRAD_COMMS = {"same": None,
              "int8": CommConfig(algorithm="ring",
                                 compression=Compression.INT8)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--full-size", action="store_true",
                    help="the published widths (bf16, --layers layers); "
                    "defaults to a ~100M-scale reduction in float32")
    ap.add_argument("--layers", type=int, default=4,
                    help="depth with --full-size")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between async checkpoints (half the run "
                    "by default)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in --ckpt-dir "
                    "(params, and the Adam moments a drain saved) and train "
                    "up to --steps")
    ap.add_argument("--comm", default="fused", choices=tuple(COMMS),
                    help="TP comm path: fused (one all-reduce per combine), "
                    "overlapped (chunked double-buffered TP reduce), or auto "
                    "(fastest measured TuneDB config)")
    ap.add_argument("--grad-comm", default="same", choices=tuple(GRAD_COMMS),
                    help="the ZeRO-1 gradient wire: the TP config, or the "
                    "int8 ring")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the layer weights over the data axis, "
                    "gathered one layer at a time")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron-SP: the residual stream sequence-sharded "
                    "over the model axis (dense family)")
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "dots"),
                    help="recompute whole blocks, or keep the weight "
                    "products' outputs")
    ap.add_argument("--dp", type=int, default=4)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="the card unless named (cpu runs the plain path)")
    ap.add_argument("--json", default=None,
                    help="write the loss stream and timings here")
    return ap


def model_config(args):
    cfg = dataclasses.replace(get_config(args.arch),
                              remat_policy=args.remat_policy)
    if args.full_size:
        return dataclasses.replace(cfg, n_layers=args.layers)
    # ~100M-param variant of the same family, CPU-trainable
    return dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, 6), d_model=min(cfg.d_model, 512),
        d_ff=min(cfg.d_ff, 1024) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 8192),
        ssm_chunk=min(cfg.ssm_chunk, 32) if cfg.ssm_chunk else 0,
        dtype=torch.float32, remat=False)


def run(args, log=print, faults=None) -> dict:
    """Train as the flags say -> the loss and gradient-norm streams, the
    wall seconds and the peak device memory, with the session.  ``faults``
    (a
    :class:`repro_torch.runtime.faults.FaultInjector`) is polled at every
    step boundary."""
    cfg = model_config(args)
    mesh = mesh_mod.make_test_mesh(args.dp, args.tp)
    log(f"arch={cfg.name} params≈{cfg.param_count() / 1e6:.0f}M "
        f"layers={cfg.n_layers} mesh=({args.dp}x{args.tp})")
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                         zero1=True, grad_comm=GRAD_COMMS[args.grad_comm])
    sess = setup.build_session(cfg, mesh, COMMS[args.comm], oc=oc,
                               seed=args.seed, device=args.device,
                               fsdp=args.fsdp,
                               seq_parallel=args.seq_parallel)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    start = 0
    if args.resume:
        from repro_torch.runtime.fault_tolerance import resume_session
        sess, start = resume_session(ckpt_dir, sess)
        log(f"[resume] from step {start} in {ckpt_dir}")
    cuda = sess.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(sess.device)
    t0 = time.perf_counter()
    norms = []
    history = loop_mod.train(
        sess, data_cfg,
        loop_mod.LoopConfig(n_steps=args.steps - start,
                            ckpt_every=args.ckpt_every
                            or max(args.steps // 2, 1),
                            ckpt_dir=ckpt_dir, log_every=10), log=log,
        faults=faults, grad_norms=norms)
    seconds = time.perf_counter() - t0
    return {"history": history, "grad_norms": norms, "seconds": seconds,
            "peak_bytes": (torch.cuda.max_memory_allocated(sess.device)
                           if cuda else None),
            "ckpt_dir": ckpt_dir, "session": sess}


def main():
    args = parser().parse_args()
    out = run(args)
    history = out["history"]
    print(f"\nloss: {history[0]:.3f} -> {history[-1]:.3f} "
          f"({len(history)} steps, {out['seconds']:.1f} s); checkpoints in "
          f"{out['ckpt_dir']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({k: out[k] for k in ("history", "grad_norms",
                                           "seconds", "peak_bytes")}, f)
    if not args.resume:
        assert history[-1] < history[0], "loss should decrease"


if __name__ == "__main__":
    main()
