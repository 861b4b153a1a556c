"""Model assembly for the dense (qwen3) and ssm (mamba2) families:
initialisation, the full forward pass (training and prefill logits) and the
training loss, on stacked ranks.

The JAX package scans its stacked layers with ``lax.scan``; here the
per-layer loop is a Python loop over views of the stacked weights.  Under
FSDP each layer's weights are gathered inside the recomputed block, so
one layer is materialized at a time in the forward and again in the
backward.
The other families (local/global attention, MoE, MLA, hybrid, VLM,
audio) come with later slices and raise here.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, sharding, ssm
from repro_torch.models.common import ModelConfig, Runtime


def require_ported_family(cfg: ModelConfig) -> None:
    """Raise unless the port runs ``cfg``'s family: dense without
    local/global attention or MLA, or ssm."""
    dense = (cfg.family == "dense" and not cfg.local_global_ratio
             and not cfg.use_mla)
    if not dense and cfg.family != "ssm":
        raise NotImplementedError(
            f"the port runs the dense family without local/global attention "
            f"and the ssm family so far, not {cfg.name} ({cfg.family}); see "
            f"ROADMAP.md Queue 1 item 8")


def layer_params(stacked: Any, i: int) -> Any:
    """Layer ``i``'s weights: views of the stacked ``(L, ...)`` leaves."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# ----------------------------------------------------------------------
# Initialization (full, unsharded arrays; sharding.shard_params cuts them)
# ----------------------------------------------------------------------

def init_dense_layer(gen: torch.Generator, cfg: ModelConfig, tp: int,
                     device) -> dict:
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "attn": attention.init_attention(gen, cfg, cfg.dtype, device, tp),
        "ln2": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                               cfg.dtype, device),
    }


def init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {"ln": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
            "ssm": ssm.init_ssm(gen, cfg, cfg.dtype, device)}


def _fill(stack: Any, i: int, layer: Any) -> None:
    if isinstance(layer, dict):
        for k, v in layer.items():
            _fill(stack[k], i, v)
    else:
        stack[i].copy_(layer)


def _alloc(layer: Any, n: int) -> Any:
    if isinstance(layer, dict):
        return {k: _alloc(v, n) for k, v in layer.items()}
    return layer.new_empty((n,) + tuple(layer.shape))


def init_model(seed: int, cfg: ModelConfig, tp: int = 1, device=None):
    """Full parameter tree of the JAX package's layout (``layers`` leaves
    stacked ``(n_layers, ...)``), drawn from ``torch.Generator(seed)`` on
    ``device``.  The JAX package draws other numbers from the same seed:
    to run both on the same weights, take the JAX package's parameters
    through ``sharding.from_reference``.  ``device`` defaults to the card
    (:func:`repro_torch.device.resolve_device`)."""
    require_ported_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       cfg.dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                  device=device),
    }
    stack = None
    for i in range(cfg.n_layers):
        layer = (init_ssm_layer(gen, cfg, device) if cfg.family == "ssm"
                 else init_dense_layer(gen, cfg, tp, device))
        if stack is None:
            stack = _alloc(layer, cfg.n_layers)
        _fill(stack, i, layer)
    params["layers"] = stack
    return params


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

def dense_block(p, x, positions, rt: Runtime, window=None):
    h = layers.rms_norm(x, p["ln1"], rt.cfg.norm_eps)
    x = x + attention.attention(p["attn"], h, positions, rt, window=window)
    h = layers.rms_norm(x, p["ln2"], rt.cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h, rt, rt.cfg.mlp_type)


def dense_block_sp(p, x_s, positions, rt: Runtime, window=None):
    """The Megatron-SP dense block: ``x_s (P, B, S/tp, D)`` sequence-sharded.
    The norms run on the shard; attention and the MLP all-gather in and
    reduce-scatter out (the wire volume of the all-reduce they replace,
    and a residual tp times smaller between blocks)."""
    cfg = rt.cfg
    h = layers.rms_norm(x_s, p["ln1"], cfg.norm_eps)
    x_s = x_s + attention.attention(p["attn"], h, positions, rt,
                                    window=window, sp=True)
    h = layers.rms_norm(x_s, p["ln2"], cfg.norm_eps)
    return x_s + layers.mlp(p["mlp"], h, rt, cfg.mlp_type, sp=True)


def ssm_block(p, x, rt: Runtime):
    return x + ssm.ssm_forward(p["ssm"], layers.rms_norm(x, p["ln"],
                                                         rt.cfg.norm_eps), rt)


class ForwardOut(NamedTuple):
    logits: torch.Tensor     # vocab-sharded (P, B, S, V/tp), f32


def positions_for(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm)


def _save_dots(ctx, op, *args, **kwargs):
    """Policy "dots": keep the matmuls of weight products
    (:func:`layers.weight_product`), recompute everything else, the flash
    and SSD kernels included."""
    from torch.utils.checkpoint import CheckpointPolicy
    if layers.in_weight_product() and op.overloadpacket in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_save_dots)


def _maybe_remat(fn, rt: Runtime, train: bool):
    """``cfg.remat`` in training: the block's activations are recomputed in
    the backward pass (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint``).  Policy "full" recomputes the whole block;
    "dots" keeps the weight products' outputs
    (``dots_with_no_batch_dims_saveable``)."""
    if not (rt.cfg.remat and train):
        return fn
    policy = rt.cfg.remat_policy
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {policy!r}: 'full' or 'dots'")
    kw = {"context_fn": _dots_context} if policy == "dots" else {}

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)
    return remat


def use_seq_parallel(rt: Runtime, seq_len: int) -> bool:
    """Megatron-SP applies to the dense family with sharded q heads and a
    sequence that divides by ``tp`` (otherwise the plain block runs)."""
    cfg, tp = rt.cfg, rt.mesh.tp
    return (rt.seq_parallel and cfg.family == "dense" and tp > 1
            and seq_len % tp == 0 and attention.attn_dims(cfg, tp).q_sharded)


def forward(params, batch: dict, rt: Runtime, train: bool = False
            ) -> ForwardOut:
    """Logits of every position of ``batch["tokens"]``: ``(B, S)`` the same
    on every row, or ``(P, B, S)`` per row (a batch cut over the data
    ranks).  ``train=True`` recomputes each block in the backward pass
    when ``cfg.remat`` is set; an FSDP layer's weights are gathered
    inside the recomputed block."""
    cfg = rt.cfg
    require_ported_family(cfg)
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens, rt)
    positions = positions_for(tokens[0] if tokens.dim() == 3 else tokens)
    plan = sharding.subplan(rt.fsdp_plan, "layers")
    use_sp = use_seq_parallel(rt, x.shape[2])
    if cfg.family == "ssm":
        def block(p, h):
            return ssm_block(sharding.apply_fsdp(p, plan, rt), h, rt)
    else:
        body = functools.partial(dense_block_sp if use_sp else dense_block,
                                 positions=positions, rt=rt,
                                 window=cfg.sliding_window)

        def block(p, h):
            return body(sharding.apply_fsdp(p, plan, rt), h)
    blk = _maybe_remat(block, rt, train)
    if use_sp:
        x = layers.sp_shard_seq(x, rt)
    for i in range(cfg.n_layers):
        x = blk(layer_params(params["layers"], i), x)
    if use_sp:
        x = layers.sp_unshard_seq(x, rt)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return ForwardOut(logits=layers.logits_shard(params["embed"], x, rt))


def loss_fn(params, batch: dict, rt: Runtime):
    """Every row's training loss ``(P,)`` (the mean cross-entropy of its
    data rank's batch; equal across a model group) and its parts."""
    out = forward(params, batch, rt, train=True)
    ce = layers.cross_entropy_vocab_sharded(out.logits, batch["labels"], rt,
                                            batch.get("loss_mask"))
    aux = torch.zeros_like(ce)
    return ce, {"ce": ce, "aux": aux}
