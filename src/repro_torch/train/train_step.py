"""Training step — manual SPMD on stacked ranks, all communication via
ACCL-X.

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` over a stacked batch (``(P, B_local, S)``: each data
rank's rows repeated over its model group; ``launch.setup`` cuts a global
batch so).  Communication per step, as in the JAX package:

  forward/backward   TP combines + f-operator sums   (streaming or buffered)
  grad model-sum     sum over 'model' for replicated-storage/sharded-use
                     leaves (sharding.grad_model_sum_mask)
  grad data-sync     ZeRO-1 flat reduce-scatter over 'data' (optional int8
                     ring wire) and a sum over 'pod', or an all-reduce
                     over ('pod', 'data') in plain mode
  param update       Adam on the owned slice, all-gather of the delta

The backward is autograd of the sum of every row's loss: row by row the
gradient each device of the JAX package takes of its own loss (the
collectives carry the JAX package's custom gradients, ``models/layers``).
Microbatching (``accum_steps`` > 1) is a Python loop over slices of the
local batch in place of ``lax.scan``, accumulating f32 gradients.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives
from repro_torch.models import transformer
from repro_torch.models.common import Runtime
from repro_torch.optim import adamw


def grad_model_sync(grads, mask, rt: Runtime):
    """Sum over the model axis where the mask says so."""
    if rt.mesh.tp == 1:
        return grads
    comm = rt.tp_comm()
    named = adamw.leaves_with_names(grads)
    flags = [m for _, m in adamw.leaves_with_names(mask)]
    out = []
    for (names, g), m in zip(named, flags):
        if m:
            g = adamw.leaf_all_reduce(g.float(), names, comm, rt.comm
                                      ).to(g.dtype)
        out.append(g)
    return adamw._unflatten(grads, out)


def make_loss_and_grad(rt: Runtime, accum_steps: int = 1):
    """``(params, batch) -> (loss (P,), parts, grads)``."""
    def single(params, batch):
        named = adamw.leaves_with_names(params)
        leaves = [p.detach().requires_grad_(True) for _, p in named]
        tracked = adamw._unflatten(params, leaves)
        with torch.enable_grad():
            loss, parts = transformer.loss_fn(tracked, batch, rt)
            grads = torch.autograd.grad(loss.sum(), leaves)
        parts = {k: v.detach() for k, v in parts.items()}
        return loss.detach(), parts, adamw._unflatten(params, list(grads))

    if accum_steps == 1:
        return single

    def accumulated(params, batch):
        b = batch["tokens"].shape[1]
        if b % accum_steps:
            raise ValueError(f"local batch {b} does not split into "
                             f"{accum_steps} microbatches")
        mb = b // accum_steps
        loss_sum, grads, parts = None, None, None
        for i in range(accum_steps):
            micro = {k: v[:, i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, parts, g = single(params, micro)
            g = adamw.tree_map(lambda x: x.float(), g)
            grads = g if grads is None else adamw.tree_map(
                torch.add, grads, g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = adamw.tree_map(lambda g: g / accum_steps, grads)
        return loss_sum / accum_steps, parts, grads

    return accumulated


def _dp_mean(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """A per-rank scalar ``(P,)`` averaged over the data ranks -> row 0."""
    if rt.mesh.dp > 1:
        x = collectives.all_reduce(x, rt.dp_comm(), rt.comm) / rt.mesh.dp
    return x[0]


def make_train_step(rt: Runtime, oc: adamw.OptConfig, mask,
                    accum_steps: int = 1, ms_mask=None, donate: bool = False):
    """``mask = sharding.grad_model_sum_mask(...)``; ``ms_mask =
    sharding.model_sharded_mask(param_specs)`` (both static trees).
    ``donate``: the step may overwrite the optimizer state it is given.
    Metrics are 0-d tensors."""
    loss_and_grad = make_loss_and_grad(rt, accum_steps)

    def train_step(params, opt_state, batch):
        loss, parts, grads = loss_and_grad(params, batch)
        grads = grad_model_sync(grads, mask, rt)
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, oc, rt, rt.fsdp_plan, ms_mask,
            donate=donate)
        del grads
        metrics = {"loss": _dp_mean(loss, rt), "ce": _dp_mean(parts["ce"], rt),
                   "aux": _dp_mean(parts["aux"], rt), "lr": opt_metrics["lr"],
                   "grad_norm": opt_metrics["grad_norm"][0]}
        return params, opt_state, metrics

    return train_step


def make_eval_step(rt: Runtime):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, parts = transformer.loss_fn(params, batch, rt)
        out = {"loss": loss, **parts}
        return {k: _dp_mean(v, rt) for k, v in out.items()}
    return eval_step
