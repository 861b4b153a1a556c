"""How far a rounding-sized perturbation of the SSD scan, and two faults
planted in the scan's plain version, move mamba2-130m's logits through its
first ``--layers`` layers at full width (random weights from ``--seed``).

Every run goes through the scan's plain version (``kernels/ssd_scan/
ref.py``), on the card unless ``--device`` names another.  Against the
unperturbed run it prints, for each variant, the largest logit change as a
share of max|logit|: at the last position, over every position, and over
the second row of every chunk but the first (where the carried state still
counts).  The variants:

- ``noise``: y times ``1 + --noise * N(0, 1)`` (a seeded generator), the
  size of two summation orders' difference;
- ``inter-chunk term dropped``: y without ``C·exp(cum)·h_prev``, every chunk
  scanned from a zero state (h_final kept);
- ``decay mask strict (i > j)``: y_i without its own ``(C_i·B_i) dt_i x_i``.

``chip_smoke.py`` plants the same two faults (it imports them from here)
to show that its kernel-vs-plain logits gate catches them.

Run:  PYTHONPATH=src python examples/ssm_fault_probe_torch.py --device cpu \\
          --layers 4 --dtype float32 --tokens 256
"""
import argparse
import dataclasses
import types

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.config import CommConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ref
from repro_torch.models import sharding, ssm, transformer
from repro_torch.models.common import MeshContext, Runtime


def without_inter_chunk(x, dt, A, B, C, chunk):
    """A planted fault: y without the inter-chunk term C·exp(cum)·h_prev
    (every chunk scanned from a zero state; h_final kept)."""
    ys = [ref.ssd_chunked_ref(x[:, :, s:s + chunk], dt[:, :, s:s + chunk],
                              A, B[:, :, s:s + chunk], C[:, :, s:s + chunk],
                              chunk)[0]
          for s in range(0, x.shape[2], chunk)]
    return torch.cat(ys, 2), ref.ssd_chunked_ref(x, dt, A, B, C, chunk)[1]


def strict_mask(x, dt, A, B, C, chunk):
    """A planted fault: the decay mask i > j, so y_i loses its own
    (C_i·B_i) dt_i x_i term."""
    y, h = ref.ssd_chunked_ref(x, dt, A, B, C, chunk)
    rep = x.shape[3] // B.shape[3]
    diag = (C.float().repeat_interleave(rep, 3)
            * B.float().repeat_interleave(rep, 3)).sum(-1)
    return y - (diag * dt)[..., None] * x.float(), h


FAULTS = {"inter-chunk term dropped": without_inter_chunk,
          "decay mask strict (i > j)": strict_mask}


def through(fn, scan=None):
    """``fn()`` with the model's SSD scan replaced by ``scan`` (the plain
    version by default)."""
    kernel = ssm.ssd_ops
    ssm.ssd_ops = types.SimpleNamespace(
        ssd_chunked=scan or ref.ssd_chunked_ref)
    try:
        return fn()
    finally:
        ssm.ssd_ops = kernel


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=1,
                    help="the first layers of the full-width model")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--tokens", type=int, default=256,
                    help="prompt length (whole chunks of 128)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--noise", type=float, default=1e-7,
                    help="relative size of the perturbation of y")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main() -> int:
    args = parser().parse_args()
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              n_layers=args.layers,
                              dtype=getattr(torch, args.dtype))
    params = sharding.shard_params(
        transformer.init_model(args.seed, cfg, args.tp, dev), cfg, args.tp)
    rt = Runtime(cfg=cfg, mesh=MeshContext.stacked(args.tp),
                 comm=CommConfig())
    tokens = torch.as_tensor(np.random.RandomState(args.seed + 1).randint(
        0, cfg.vocab_size, (args.batch, args.tokens)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def noisy(*inp):
        y, h = ref.ssd_chunked_ref(*inp)
        return y * (1 + args.noise * torch.randn(
            y.shape, generator=gen, device=y.device)), h

    def logits(scan):
        return through(lambda: transformer.forward(
            params, {"tokens": tokens}, rt).logits.float(), scan)
    base = logits(None)
    peak = base.abs().max()
    second_rows = torch.arange(cfg.ssm_chunk + 1, args.tokens,
                               cfg.ssm_chunk, device=dev)
    print(f"mamba2-130m, first {args.layers} layer(s), {args.dtype}, tp "
          f"{args.tp}, {args.batch} x {args.tokens} tokens on {dev}; "
          f"max|logit| {peak.item():.4g}")
    for name, scan in [(f"noise {args.noise:g}", noisy)] + list(
            FAULTS.items()):
        d = (logits(scan) - base).abs() / peak        # (P, B, S, V/tp)
        rows = d[:, :, second_rows].max().item() if len(second_rows) else 0
        print(f"{name}: last position {d[:, :, -1].max().item():.4g}, "
              f"every position {d.max().item():.4g}, second rows of "
              f"chunks 2.. {rows:.4g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
