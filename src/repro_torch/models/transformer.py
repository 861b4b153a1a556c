"""Model assembly for the dense (qwen3, command-r, deepseek-coder, and
gemma3's 5:1 local/global attention), moe (mixtral), ssm (mamba2) and
hybrid (zamba2) families: initialisation, the full forward pass (training
and prefill logits) and the training loss, on stacked ranks.

The JAX package scans its stacked layers with ``lax.scan``; here the
per-layer loop is a Python loop over views of the stacked weights.  Under
FSDP each layer's weights are gathered inside the recomputed block, so
one layer is materialized at a time in the forward and again in the
backward.  Under ``local_global_ratio = r`` the stack is the JAX
package's: ``blocks`` of ``r`` windowed local layers and one global layer
(one recomputed unit each), then the ``trailing`` windowed layers.  The
moe family runs its leading ``dense_layers`` (unwindowed) and then its
MoE ``layers`` at ``cfg.sliding_window``, one recomputed unit each that
carries the layer's load-balance loss; under ``use_mla`` (deepseek-v3)
every layer's attention is Multi-head Latent Attention
(:mod:`repro_torch.models.mla`).  The hybrid family is Zamba2's: ``groups``
of ``hybrid_attn_every`` Mamba2 layers, each group followed by one
weight-shared attention block (``shared_attn``: its input is
``concat(hidden, embedding)`` projected back to ``d_model``), one
recomputed unit a group, then the ``trailing`` Mamba2 layers.  The other
families (VLM, audio) come with later slices and raise here.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mla, moe, sharding, ssm
from repro_torch.models.common import ModelConfig, Runtime


def require_ported_family(cfg: ModelConfig) -> None:
    """Raise unless the port runs ``cfg``'s family: dense (local/global
    attention included), moe (with or without MLA), ssm, or hybrid."""
    if (cfg.use_mla and cfg.family != "moe") \
            or cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"the port runs the dense, moe (MLA in the moe family only), ssm "
            f"and hybrid families so far, not {cfg.name} ({cfg.family}"
            + (", MLA" if cfg.use_mla else "") + "); see ROADMAP.md Queue 1")


def layer_params(stacked: Any, i: int) -> Any:
    """Layer ``i``'s weights: views of the stacked ``(L, ...)`` leaves."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def local_global_counts(cfg: ModelConfig) -> tuple[int, int]:
    """``(n_blocks, n_trailing)`` of a local/global stack: ``L // (r + 1)``
    super-blocks of ``r`` local layers and one global, then the rest."""
    blk = cfg.local_global_ratio + 1
    return cfg.n_layers // blk, cfg.n_layers % blk


def hybrid_counts(cfg: ModelConfig) -> tuple[int, int]:
    """``(n_groups, n_trailing)`` of a hybrid stack: ``L // k`` groups of
    ``k = hybrid_attn_every`` Mamba2 layers, each followed by the shared
    attention block, then the rest."""
    k = cfg.hybrid_attn_every
    return cfg.n_layers // k, cfg.n_layers % k


def ssm_layers(params, cfg: ModelConfig) -> list:
    """Every Mamba2 layer's weights (views) in layer order: ``layers`` in
    the ssm family; in the hybrid family each group's ``k`` layers, then
    the trailing layers (the shared attention block runs after layer
    ``g·k + k - 1`` for every group ``g``)."""
    if cfg.family == "ssm":
        return [layer_params(params["layers"], i)
                for i in range(cfg.n_layers)]
    ng, nt = hybrid_counts(cfg)
    return ([layer_params(layer_params(params["groups"], g)["ssm"], j)
             for g in range(ng) for j in range(cfg.hybrid_attn_every)]
            + [layer_params(params["trailing"], i) for i in range(nt)])


def attention_layers(params, cfg: ModelConfig):
    """Every attention layer's weights (views) with its attention window,
    in layer order: ``layers`` at ``cfg.sliding_window``; under
    local/global attention each block's local layers (windowed) and global
    layer (no window), then the trailing layers (windowed); in the moe
    family the ``dense_layers`` head (no window), then the MoE ``layers``
    (windowed).  A layer's feed-forward is an MoE block where it holds
    ``moe``, else its ``mlp``."""
    if cfg.family == "moe":
        return ([(layer_params(params["dense_layers"], i), None)
                 for i in range(cfg.n_dense_layers)]
                + [(layer_params(params["layers"], i), cfg.sliding_window)
                   for i in range(cfg.n_layers - cfg.n_dense_layers)])
    if not cfg.local_global_ratio:
        return [(layer_params(params["layers"], i), cfg.sliding_window)
                for i in range(cfg.n_layers)]
    nb, nt = local_global_counts(cfg)
    out = []
    for b in range(nb):
        blk = layer_params(params["blocks"], b)
        out += [(layer_params(blk["local"], j), cfg.sliding_window)
                for j in range(cfg.local_global_ratio)]
        out.append((blk["global"], None))
    out += [(layer_params(params["trailing"], i), cfg.sliding_window)
            for i in range(nt)]
    return out


# ----------------------------------------------------------------------
# Initialization (full, unsharded arrays; sharding.shard_params cuts them)
# ----------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ModelConfig, tp: int,
              device) -> dict:
    """A layer's attention weights: MLA's under ``use_mla``, else GQA's."""
    if cfg.use_mla:
        return mla.init_mla(gen, cfg, cfg.dtype, device)
    return attention.init_attention(gen, cfg, cfg.dtype, device, tp)


def init_dense_layer(gen: torch.Generator, cfg: ModelConfig, tp: int,
                     device) -> dict:
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "attn": init_attn(gen, cfg, tp, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                               cfg.dtype, device),
    }


def init_moe_layer(gen: torch.Generator, cfg: ModelConfig, tp: int,
                   device) -> dict:
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "attn": init_attn(gen, cfg, tp, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "moe": moe.init_moe(gen, cfg, cfg.dtype, device, tp),
    }


def init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {"ln": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
            "ssm": ssm.init_ssm(gen, cfg, cfg.dtype, device)}


def _fill(stack: Any, i, layer: Any) -> None:
    if isinstance(layer, dict):
        for k, v in layer.items():
            _fill(stack[k], i, v)
    else:
        stack[i].copy_(layer)


def _alloc(layer: Any, lead: tuple) -> Any:
    if isinstance(layer, dict):
        return {k: _alloc(v, lead) for k, v in layer.items()}
    return layer.new_empty(lead + tuple(layer.shape))


def _stack(make, lead: tuple) -> Any:
    """``make()`` called once per index of ``lead`` (row-major), the
    layers stacked ``(*lead, ...)``."""
    stack = None
    for idx in np.ndindex(*lead):
        layer = make()
        if stack is None:
            stack = _alloc(layer, lead)
        _fill(stack, idx, layer)
    return stack


def init_model(seed: int, cfg: ModelConfig, tp: int = 1, device=None):
    """Full parameter tree of the JAX package's layout (``layers`` leaves
    stacked ``(n_layers, ...)``; under local/global attention ``blocks``
    with ``local`` leaves ``(n_blocks, r, ...)`` and ``global`` leaves
    ``(n_blocks, ...)``, and ``trailing`` ``(n_trailing, ...)`` when the
    depth leaves any; in the moe family ``layers`` of the ``n_layers -
    n_dense_layers`` MoE layers, expert leaves in the flattened layout of
    ``tp`` (:func:`repro_torch.models.moe.init_moe`), and ``dense_layers``
    when the config has a dense head; in the hybrid family ``groups`` with
    ``ssm`` leaves ``(n_groups, k, ...)``, ``trailing`` ``(n_layers % k,
    ...)`` and ``shared_attn = {proj_in (2·D, D), block: a dense layer}``),
    drawn from ``torch.Generator(seed)`` on ``device`` in layer order.  The
    JAX package draws other numbers from the same seed: to run both on the
    same weights, take the JAX package's parameters through
    ``sharding.from_reference``.  ``device`` defaults to
    the card (:func:`repro_torch.device.resolve_device`)."""
    require_ported_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       cfg.dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                  device=device),
    }
    if cfg.family == "ssm":
        params["layers"] = _stack(lambda: init_ssm_layer(gen, cfg, device),
                                  (cfg.n_layers,))
        return params
    if cfg.family == "hybrid":
        ng, nt = hybrid_counts(cfg)
        params["groups"] = {"ssm": _stack(
            lambda: init_ssm_layer(gen, cfg, device),
            (ng, cfg.hybrid_attn_every))}
        if nt:
            params["trailing"] = _stack(
                lambda: init_ssm_layer(gen, cfg, device), (nt,))
        params["shared_attn"] = {
            "proj_in": layers.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                         cfg.dtype, device),
            "block": init_dense_layer(gen, cfg, tp, device)}
        return params

    def dense():
        return init_dense_layer(gen, cfg, tp, device)
    if cfg.family == "moe":
        params["layers"] = _stack(lambda: init_moe_layer(gen, cfg, tp,
                                                         device),
                                  (cfg.n_layers - cfg.n_dense_layers,))
        if cfg.n_dense_layers:
            params["dense_layers"] = _stack(dense, (cfg.n_dense_layers,))
        return params
    if not cfg.local_global_ratio:
        params["layers"] = _stack(dense, (cfg.n_layers,))
        return params
    r = cfg.local_global_ratio
    nb, nt = local_global_counts(cfg)
    params["blocks"] = _stack(lambda: {"local": _stack(dense, (r,)),
                                       "global": dense()}, (nb,))
    if nt:
        params["trailing"] = _stack(dense, (nt,))
    return params


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

def attend(p, h, positions, rt: Runtime, window=None):
    """A layer's self-attention of the normed ``h``: MLA under ``use_mla``
    (which takes no window), else GQA at ``window``."""
    if rt.cfg.use_mla:
        return mla.mla_attention(p, h, positions, rt)
    return attention.attention(p, h, positions, rt, window=window)


def dense_block(p, x, positions, rt: Runtime, window=None):
    h = layers.rms_norm(x, p["ln1"], rt.cfg.norm_eps)
    x = x + attend(p["attn"], h, positions, rt, window=window)
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


def moe_layer(p, x, positions, rt: Runtime, window=None):
    """Attention, then the MoE block: ``(x, aux (P,))``."""
    h = layers.rms_norm(x, p["ln1"], rt.cfg.norm_eps)
    x = x + attend(p["attn"], h, positions, rt, window=window)
    h = layers.rms_norm(x, p["ln2"], rt.cfg.norm_eps)
    y, aux = moe.moe_block(p["moe"], h, rt)
    return x + y, aux


def ssm_block(p, x, rt: Runtime):
    return x + ssm.ssm_forward(p["ssm"], layers.rms_norm(x, p["ln"],
                                                         rt.cfg.norm_eps), rt)


def shared_input(p, x, x_embed):
    """The shared block's input: ``concat(hidden, embedding)`` projected
    back to ``d_model`` by ``proj_in`` (replicated; a weight product with
    fp32 accumulation and one rounding to x's dtype, as ``jnp.dot(...,
    preferred_element_type=float32).astype``)."""
    return layers.rank_matmul(torch.cat([x, x_embed], dim=-1), p["proj_in"])


def shared_attn_fwd(p, x, x_embed, positions, rt: Runtime):
    """Zamba2's shared block (the JAX package's ``_shared_attn_fwd``): its
    projected input through a dense block.  The caller adds the result to
    ``x``."""
    return dense_block(p["block"], shared_input(p, x, x_embed), positions,
                       rt)


class ForwardOut(NamedTuple):
    logits: torch.Tensor     # vocab-sharded (P, B, S, V/tp), f32
    aux_loss: torch.Tensor   # (P,) f32: the MoE load-balance loss (0 else)


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
    sequence that divides by ``tp``, outside a local/global stack
    (otherwise the plain block runs, as in the JAX package)."""
    cfg, tp = rt.cfg, rt.mesh.tp
    return (rt.seq_parallel and cfg.family == "dense" and tp > 1
            and not cfg.local_global_ratio
            and seq_len % tp == 0 and attention.attn_dims(cfg, tp).q_sharded)


def _local_global_stack(params, x, positions, rt: Runtime, train: bool):
    """gemma3's stack: one recomputed unit per super-block (``r`` local
    layers at the sliding window, then the global layer unwindowed), its
    FSDP gather inside the unit; then the trailing layers, windowed and
    not recomputed (the JAX package's ``_local_global_stack``)."""
    cfg = rt.cfg
    bplan = sharding.subplan(rt.fsdp_plan, "blocks")
    tplan = sharding.subplan(rt.fsdp_plan, "trailing")

    def unit(p, h):
        p = sharding.apply_fsdp(p, bplan, rt)
        for j in range(cfg.local_global_ratio):
            h = dense_block(layer_params(p["local"], j), h, positions, rt,
                            window=cfg.sliding_window)
        return dense_block(p["global"], h, positions, rt, window=None)
    blk = _maybe_remat(unit, rt, train)
    nb, nt = local_global_counts(cfg)
    for b in range(nb):
        x = blk(layer_params(params["blocks"], b), x)
    for i in range(nt):
        p = sharding.apply_fsdp(layer_params(params["trailing"], i), tplan,
                                rt)
        x = dense_block(p, x, positions, rt, window=cfg.sliding_window)
    return x


def _moe_stack(params, x, positions, rt: Runtime, train: bool):
    """The moe family's stack: the ``dense_layers`` head unwindowed (not
    recomputed, as in the JAX package), then each MoE layer at the sliding
    window as one recomputed unit, its FSDP gather inside it, carrying its
    load-balance loss: ``(x, aux summed over the layers (P,))``."""
    cfg = rt.cfg
    dplan = sharding.subplan(rt.fsdp_plan, "dense_layers")
    mplan = sharding.subplan(rt.fsdp_plan, "layers")
    for i in range(cfg.n_dense_layers):
        p = sharding.apply_fsdp(layer_params(params["dense_layers"], i),
                                dplan, rt)
        x = dense_block(p, x, positions, rt, window=None)

    def unit(p, h):
        return moe_layer(sharding.apply_fsdp(p, mplan, rt), h, positions, rt,
                         window=cfg.sliding_window)
    blk = _maybe_remat(unit, rt, train)
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers - cfg.n_dense_layers):
        x, a = blk(layer_params(params["layers"], i), x)
        aux = aux + a
    return x, aux


def _hybrid_stack(params, x, positions, rt: Runtime, train: bool):
    """Zamba2's stack: one recomputed unit a group (its FSDP gather inside
    the unit; ``k`` Mamba2 layers, then the shared block on ``concat(h,
    x_embed)``), then the trailing Mamba2 layers, not recomputed.  The
    shared block's weights and the embedding are closed over: one set of
    weights used after every group, never FSDP-gathered, its gradient the
    sum over every use (the JAX package's hybrid branch)."""
    cfg = rt.cfg
    gplan = sharding.subplan(rt.fsdp_plan, "groups")
    tplan = sharding.subplan(rt.fsdp_plan, "trailing")
    shared, x_embed = params["shared_attn"], x

    def unit(p, h):
        p = sharding.apply_fsdp(p, gplan, rt)
        for j in range(cfg.hybrid_attn_every):
            h = ssm_block(layer_params(p["ssm"], j), h, rt)
        return h + shared_attn_fwd(shared, h, x_embed, positions, rt)
    blk = _maybe_remat(unit, rt, train)
    ng, nt = hybrid_counts(cfg)
    for g in range(ng):
        x = blk(layer_params(params["groups"], g), x)
    for i in range(nt):
        p = sharding.apply_fsdp(layer_params(params["trailing"], i), tplan,
                                rt)
        x = ssm_block(p, x, rt)
    return x


def _layer_stack(params, x, positions, rt: Runtime, train: bool):
    """The ``layers`` stack: one recomputed block a layer, its FSDP gather
    inside the block; dense blocks under Megatron-SP when it applies."""
    cfg = rt.cfg
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
    return x


def forward(params, batch: dict, rt: Runtime, train: bool = False
            ) -> ForwardOut:
    """Logits of every position of ``batch["tokens"]``: ``(B, S)`` the same
    on every row, or ``(P, B, S)`` per row (a batch cut over the data
    ranks).  ``train=True`` recomputes each block (each super-block under
    local/global attention, each group of the hybrid stack) in the
    backward pass when ``cfg.remat`` is set; an FSDP layer's weights are
    gathered inside the recomputed block."""
    cfg = rt.cfg
    require_ported_family(cfg)
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens, rt)
    positions = positions_for(tokens[0] if tokens.dim() == 3 else tokens)
    if cfg.family == "moe":
        x, aux = _moe_stack(params, x, positions, rt, train)
    else:
        stack = (_hybrid_stack if cfg.family == "hybrid"
                 else _local_global_stack if cfg.local_global_ratio
                 else _layer_stack)
        x = stack(params, x, positions, rt, train)
        aux = torch.zeros((x.shape[0],), dtype=torch.float32,
                          device=x.device)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return ForwardOut(logits=layers.logits_shard(params["embed"], x, rt),
                      aux_loss=aux)


def loss_fn(params, batch: dict, rt: Runtime):
    """Every row's training loss ``(P,)`` (the mean cross-entropy of its
    data rank's batch, plus ``0.01 ·`` the MoE load-balance loss; equal
    across a model group) and its parts."""
    out = forward(params, batch, rt, train=True)
    ce = layers.cross_entropy_vocab_sharded(out.logits, batch["labels"], rt,
                                            batch.get("loss_mask"))
    return ce + 0.01 * out.aux_loss, {"ce": ce, "aux": out.aux_loss}
