"""How far float32 rounding moves zamba2's smoke config (the hybrid family:
Mamba2 groups with a weight-shared attention block) in the port, against
the same model run in float64.

For each ``(dp, tp)`` mesh of ``--meshes`` it takes one step's gradients
(model-synced, averaged over the data ranks, as the training step syncs
them) and the forward logits from the same weights and batch (both made
from ``--seed``), in float32 and in float64, and prints, as a share of
each leaf's max|grad| (of max|logit| for the logits):

- the float64 run of each mesh against the float64 run of the first mesh
  (the port's sharding, summed model-axis gradients and the shared block's
  summed uses, without rounding noise);
- the float32 run against the first mesh's float64 run;
- ``--perturb`` more float32 runs, each with every RMSNorm input scaled by
  ``1 + 2^-24 · N(0, 1)`` (one ulp of noise, a seeded generator), against
  it: how much one rounding's worth of difference can move the result.

The float64 run casts where the model casts to float32 (``Tensor.float``,
patched to float64 while it runs) and takes the SSD scan's plain version,
which computes in float64 on float64 inputs.  ``tests/test_torch_hybrid.py``
sets its bounds from these readings.

Run:  PYTHONPATH=src python examples/hybrid_noise_probe_torch.py --device cpu
"""
import argparse
import contextlib
import dataclasses
import types

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.config import CommConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.models import layers, ssm, transformer
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts


@contextlib.contextmanager
def float64_model():
    """The port's model code in float64 while the context lasts: its casts
    to float32 (``Tensor.float``) cast to float64, and the SSD scan is its
    plain version."""
    cast, scan = torch.Tensor.float, ssm.ssd_ops
    torch.Tensor.float = lambda self, *a, **kw: self.to(torch.float64)
    ssm.ssd_ops = types.SimpleNamespace(ssd_chunked=ssd_ref.ssd_chunked_ref)
    try:
        yield
    finally:
        torch.Tensor.float, ssm.ssd_ops = cast, scan


@contextlib.contextmanager
def ulp_noise(seed: int):
    """Every RMSNorm input scaled by ``1 + 2^-24 · N(0, 1)`` while the
    context lasts."""
    norm = layers.rms_norm
    gen = torch.Generator().manual_seed(seed)

    def noisy(x, weight, eps):
        n = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
        return norm(x * (1 + 2.0 ** -24 * n), weight, eps)
    layers.rms_norm = noisy
    try:
        yield
    finally:
        layers.rms_norm = norm


def run(cfg, full, batch, dp: int, tp: int, device, f64: bool = False):
    """``(gradients, logits)`` of one step on a ``(dp, tp)`` stack from the
    full parameter tree ``full``: the gradients as full arrays by leaf
    name, the logits (rank 0's vocab shards joined), both in float64."""
    sess = setup.build_session(cfg, mesh_mod.make_test_mesh(dp, tp),
                               CommConfig(), oc=adamw.OptConfig(zero1=False),
                               device=device)
    params = setup.stacked_params(sess, full)
    if f64:
        params = adamw._unflatten(params, [
            t.double() for _, t in adamw.leaves_with_names(params)])
    rt = sess.rt
    stacked = setup.shard_batch(sess, batch)
    _, _, grads = ts.make_loss_and_grad(rt)(params, stacked)
    grads = ts.grad_model_sync(grads, sess.mask, rt)
    grads = adamw._unflatten(grads, [
        adamw.leaf_all_reduce(g, n, rt.dp_comm(), rt.comm) / dp
        for n, g in adamw.leaves_with_names(grads)])
    with torch.no_grad():
        logits = transformer.forward(params, stacked, rt).logits
    tokens_logits = torch.cat(logits[:tp].unbind(0), dim=-1)[0]
    return ({"/".join(n): t.double().cpu() for n, t in
             adamw.leaves_with_names(setup.global_params(sess, grads))},
            tokens_logits.double().cpu())


def gap(got, want) -> tuple[float, str]:
    """The largest leaf gap, as a share of that leaf's max|grad|, and the
    leaf."""
    return max((float((got[n] - w).abs().max() / w.abs().max()), n)
               for n, w in want.items())


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1x1,1x4,2x4",
                    help="(dp)x(tp) meshes, the first the reference")
    ap.add_argument("--perturb", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"),
                              dtype=torch.float32)
    full = transformer.init_model(args.seed, cfg, 1, device)
    rng = np.random.RandomState(args.seed)
    batch = {k: rng.randint(0, cfg.vocab_size, (4, 48))
             for k in ("tokens", "labels")}
    meshes = [tuple(int(v) for v in m.split("x"))
              for m in args.meshes.split(",")]
    with float64_model():
        ref_g, ref_l = run(cfg, full, batch, *meshes[0], device, f64=True)
    print(f"{cfg.name} f32, seed {args.seed}, on {device}: gaps as a share "
          f"of each leaf's max|grad| (logits: of max|logit|) against the "
          f"float64 run at {meshes[0]}")
    for dp, tp in meshes:
        with float64_model():
            g64, l64 = run(cfg, full, batch, dp, tp, device, f64=True)
        g32, l32 = run(cfg, full, batch, dp, tp, device)
        noisy = []
        for s in range(args.perturb):
            with ulp_noise(s):
                g, lg = run(cfg, full, batch, dp, tp, device)
            noisy.append((gap(g, ref_g)[0], rel(lg, ref_l)))
        print(f"({dp}, {tp}): float64 {gap(g64, ref_g)[0]:.3e} (logits "
              f"{rel(l64, ref_l):.3e}); float32 {gap(g32, ref_g)[0]:.3e} "
              f"({gap(g32, ref_g)[1]}; logits {rel(l32, ref_l):.3e}); "
              f"float32 with one ulp of noise at every norm input: grads "
              + ", ".join(f"{a:.3e}" for a, _ in noisy) + "; logits "
              + ", ".join(f"{b:.3e}" for _, b in noisy))


if __name__ == "__main__":
    main()
