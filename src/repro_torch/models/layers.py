"""Core layers of the dense LM path on stacked ranks.

Every activation and every weight carries the ranks of the ``(data,
model)`` mesh as its leading dimension: rank ``p``'s value is ``x[p]``.  A
replicated weight (a norm's scale) is the same row on every rank.

Autograd of the stacked program is the per-rank autograd of the JAX
package: every row-local op differentiates row by row, and the two ops that
couple rows carry the JAX package's custom gradients — the sum all-reduce
(identity backward, :func:`repro_torch.core.collectives.all_reduce`) and
the *f* operator :func:`tp_grad_sum` (all-reduce backward).  So the
gradient of the sum of every row's loss is, row by row, what each device
of the JAX package computes for its own loss.

Tensor-parallel convention, as in the JAX package: activations enter
replicated across the ``model`` axis; column-parallel matmuls produce
sharded features; row-parallel matmuls produce partial sums that are
combined with an ACCL-X all-reduce.  The combine runs **buffered** (one
all-reduce after the full matmul) or **streaming** (the chunk-pipelined
:func:`repro_torch.core.streaming.overlapped_matmul_allreduce`) per the
CommConfig — the paper's §3.1 modes applied to TP.

Where the JAX package reads ``lax.axis_index``, these functions take the
rank from ``comm.rank()``: one value per row of the rank dimension.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import collectives, plans, streaming
from repro_torch.core.config import CommMode, Scheduling
from repro_torch.models.common import Runtime

# Set while a weight product runs: remat policy "dots" saves the matmuls
# issued under it (the JAX package's dots_with_no_batch_dims_saveable; on
# the stacked layout every product is batched over the rank dimension, so
# the op type alone cannot tell a weight product from attention's).
_WEIGHT_PRODUCT = contextvars.ContextVar("weight_product", default=False)


@contextlib.contextmanager
def weight_product():
    token = _WEIGHT_PRODUCT.set(True)
    try:
        yield
    finally:
        _WEIGHT_PRODUCT.reset(token)


def in_weight_product() -> bool:
    return _WEIGHT_PRODUCT.get()


def rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`repro_torch.core.streaming.rank_matmul`, a weight product."""
    with weight_product():
        return streaming.rank_matmul(x, w)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`repro_torch.core.streaming.matmul_f32`, a weight product."""
    with weight_product():
        return streaming.matmul_f32(x, w)


def per_rank(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """View a per-rank leaf ``(P, *shape)`` so that it broadcasts against a
    stacked ``(P, ..., *shape)`` tensor of ``ndim`` dimensions."""
    return w.reshape((w.shape[0],) + (1,) * (ndim - w.dim())
                     + tuple(w.shape[1:]))


def rank_index(rt: Runtime, device) -> torch.Tensor:
    """This row's rank on the ``model`` axis, for every row: ``(tp,)``."""
    return rt.tp_comm().rank(device)


def rank_slice(x: torch.Tensor, start: torch.Tensor, width: int,
               dim: int) -> torch.Tensor:
    """Row ``p`` of the stacked ``x`` sliced to ``[start[p], start[p] +
    width)`` along message dimension ``dim`` (``lax.dynamic_slice_in_dim``
    with a per-rank start)."""
    P = x.shape[0]
    idx = start.view(P, 1) + torch.arange(width, device=x.device)
    shape = [P] + [1] * (x.dim() - 1)
    shape[dim + 1] = width
    idx = idx.view(shape).expand(*x.shape[:dim + 1], width,
                                 *x.shape[dim + 2:])
    return torch.gather(x, dim + 1, idx)


# ----------------------------------------------------------------------
# Initialization helpers (full, unsharded arrays; sharding.shard_params
# cuts them into per-rank shards)
# ----------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / d_in) ** 0.5).to(dtype)


# ----------------------------------------------------------------------
# Normalization
# ----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """``x (P, ..., D)``, ``weight (P, D)``; the scale is ``1 + weight``."""
    h = x.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * (1.0 + per_rank(weight, x.dim()).float())).to(x.dtype)


# ----------------------------------------------------------------------
# Rotary position embedding
# ----------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    """``1 / theta ** (arange(0, hd, 2) / hd)`` in f32, computed once on the
    CPU per (head_dim, theta) and kept on ``device``: the same table on
    every device, and no host-to-device copy (a sync) per call."""
    def build():
        exps = (torch.arange(0, head_dim, 2, dtype=torch.float32)
                / torch.tensor(float(head_dim)))
        base = torch.tensor(theta, dtype=torch.float32)
        return (torch.ones(()) / torch.pow(base, exps)).to(device)
    return plans._memo("rope_frequencies",
                       (head_dim, float(theta), str(device)), build,
                       pinned=True)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq), broadcast
    against x's leading dims."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs      # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Tensor-parallel matmuls
# ----------------------------------------------------------------------

class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        rt = ctx.rt
        return collectives.all_reduce(ct, rt.tp_comm(), rt.comm), None


def tp_grad_sum(x: torch.Tensor, rt: Runtime, enable: bool = True
                ) -> torch.Tensor:
    """Megatron's *f* operator: identity forward, all-reduce backward.

    Placed where a replicated activation enters a model-sharded branch —
    each TP rank back-propagates only its shard's partial cotangent, so the
    backward pass must sum them over the model axis."""
    if not enable or rt.mesh.tp == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GradSum.apply(x, rt)
    return x


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.s, None


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """Identity forward; scales the cotangent by ``s`` in backward.

    For a loss computed the same way on every TP rank (the MoE aux loss):
    gradients are summed over the model axis at sync time, so a path that
    every rank computes identically pre-scales its cotangent by 1/tp."""
    return _ScaleGrad.apply(x, s)


def col_parallel(x: torch.Tensor, w_shard: torch.Tensor) -> torch.Tensor:
    """Replicated x @ column-sharded w -> feature-sharded output (no
    comm)."""
    return rank_matmul(x, w_shard)


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor,
                 rt: Runtime) -> torch.Tensor:
    """Feature-sharded x @ row-sharded w -> replicated output (one
    combine).

    Streaming mode — and any config with ``Scheduling.OVERLAPPED`` — routes
    the combine through ``streaming.overlapped_matmul_allreduce`` (the
    per-layer TP reduce chunked and double-buffered against the matmul);
    buffered non-overlapped configs issue one all-reduce after the full
    matmul.  On the CPU all paths are bitwise identical."""
    if rt.mesh.tp == 1:
        return rank_matmul(x_shard, w_shard)
    if (rt.comm.mode == CommMode.STREAMING
            or rt.comm.scheduling == Scheduling.OVERLAPPED):
        lead = x_shard.shape[:-1]
        h2 = x_shard.reshape(x_shard.shape[0], -1, x_shard.shape[-1])
        with weight_product():
            out = streaming.overlapped_matmul_allreduce(
                h2, w_shard, rt.tp_comm(), rt.comm)
        return out.reshape(*lead, w_shard.shape[-1]).to(x_shard.dtype)
    partial = matmul_f32(x_shard, w_shard)
    out = collectives.all_reduce(partial, rt.tp_comm(), rt.comm)
    return out.to(x_shard.dtype)


# ----------------------------------------------------------------------
# Megatron-SP: the residual stream sequence-sharded over the model axis
# ----------------------------------------------------------------------

def scatter_sum(x: torch.Tensor, comm, cfg, axis: int = 0) -> torch.Tensor:
    """The sum reduce-scatter of stacked ``x`` along message dim ``axis``
    (``lax.psum_scatter(..., scatter_dimension=axis, tiled=True)``)."""
    if axis == 0:
        return collectives.reduce_scatter(x, comm, cfg)
    out = collectives.reduce_scatter(x.movedim(axis + 1, 1), comm, cfg)
    return out.movedim(1, axis + 1).contiguous()


def _seq_shard(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Each row's sequence shard of ``x (P, B, S, ...)``: its model rank's
    ``S / tp`` positions."""
    L = x.shape[2] // rt.mesh.tp
    return rank_slice(x, rank_index(rt, x.device) * L, L, dim=1)


def _seq_gather(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    return collectives.all_gather(x, rt.tp_comm(), rt.comm, axis=1)


class _ShardSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return _seq_shard(x, rt)

    @staticmethod
    def backward(ctx, ct):
        return _seq_gather(ct, ctx.rt), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return _seq_gather(x, rt)

    @staticmethod
    def backward(ctx, ct):
        rt = ctx.rt
        return scatter_sum(ct, rt.tp_comm(), rt.comm, axis=1), None


class _UnshardSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return _seq_gather(x, rt)

    @staticmethod
    def backward(ctx, ct):
        return _seq_shard(ct, ctx.rt), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, rt):
        ctx.rt = rt
        return scatter_sum(partial, rt.tp_comm(), rt.comm, axis=1)

    @staticmethod
    def backward(ctx, ct):
        return _seq_gather(ct, ctx.rt), None


def sp_shard_seq(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Slice each row's sequence shard (the SP stack entry).  Backward: the
    shards' cotangents are disjoint in time, so the full-sequence
    cotangent is their all-gather."""
    return x if rt.mesh.tp == 1 else _ShardSeq.apply(x, rt)


def sp_all_gather(x_s: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Megatron-SP's *g*: all-gather the sequence-sharded activation to
    full; backward, the sum reduce-scatter of the rank-partial cotangents
    (the *f* operator's sum, so no tp_grad_sum on SP branches).  Only where
    the gathered value feeds rank-local sharded branches."""
    return x_s if rt.mesh.tp == 1 else _GatherSeq.apply(x_s, rt)


def sp_unshard_seq(x_s: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The SP stack exit: an all-gather whose output is consumed
    replicated (final norm, cross-entropy), so its cotangent is already
    equal on every rank and the backward takes each row's slice."""
    return x_s if rt.mesh.tp == 1 else _UnshardSeq.apply(x_s, rt)


def sp_reduce_scatter(partial: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The row-parallel combine in SP form: a sum reduce-scatter over the
    sequence dim (in place of the all-reduce: a sharded result), its wire
    in the activation dtype (a bf16 model's: half the bytes of the f32
    partials; the matmul accumulated in f32 already); backward, the
    all-gather."""
    if rt.mesh.tp == 1:
        return partial
    return _ReduceScatterSeq.apply(partial.to(rt.cfg.dtype), rt)


# ----------------------------------------------------------------------
# MLP (SwiGLU / GELU), column->row parallel
# ----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype, device):
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype, device),
         "w_down": dense_init(gen, d_ff, d_model, dtype, device)}
    if mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    return p


def mlp(params, x: torch.Tensor, rt: Runtime, mlp_type: str,
        sharded: Optional[bool] = None, sp: bool = False) -> torch.Tensor:
    """``sp=True``: x arrives sequence-sharded; all-gather in,
    reduce-scatter out (Megatron-SP).  Otherwise x is replicated and the
    *f* operator applies.  ``sharded`` (default: ``d_ff`` divides by
    ``tp``) says whether the hidden dim is cut over the model ranks."""
    if sharded is None:
        sharded = bool(rt.cfg.d_ff) and rt.cfg.d_ff % rt.mesh.tp == 0
    sp = sp and sharded and rt.mesh.tp > 1
    x = sp_all_gather(x, rt) if sp else tp_grad_sum(x, rt, sharded)
    up = col_parallel(x, params["w_up"])
    if mlp_type == "swiglu":
        gate = col_parallel(x, params["w_gate"])
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    if sp:
        return sp_reduce_scatter(matmul_f32(h, params["w_down"]),
                                 rt).to(x.dtype)
    return row_parallel(h, params["w_down"], rt)


# ----------------------------------------------------------------------
# Vocab-sharded embedding / logits / greedy sampling
# ----------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype,
                   device):
    emb = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                      device=device) * 0.02
    return {"table": emb.to(dtype)}


def _row_tokens(token_ids: torch.Tensor, P: int) -> torch.Tensor:
    """``(B, S)`` ids shared by every row, or ``(P, B, S)`` per row ->
    ``(P, B, S)``."""
    if token_ids.dim() == 2:
        return token_ids.unsqueeze(0).expand((P,) + tuple(token_ids.shape))
    return token_ids


def embed(params, token_ids: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Vocab-sharded lookup of ``token_ids``, ``(B, S)`` the same on every
    row or ``(P, B, S)`` per row (a training batch cut over the data
    ranks): local gather + all-reduce of masked rows -> ``(P, B, S, D)``."""
    table = params["table"]            # (P, vocab/tp, D) local shards
    P = table.shape[0]
    if rt.mesh.tp == 1 or table.shape[1] >= rt.cfg.vocab_size:
        if token_ids.dim() == 2:
            return table[:, token_ids]
        rows = torch.arange(P, device=table.device).view(P, 1, 1)
        return table[rows, token_ids]
    tokens = _row_tokens(token_ids, P)
    shard = rank_index(rt, table.device).view(P, 1, 1)
    vshard = table.shape[1]
    local = tokens - shard * vshard                    # (P, B, S)
    valid = (local >= 0) & (local < vshard)
    prow = torch.arange(P, device=table.device).view(P, 1, 1)
    rows = table[prow, local.clamp(0, vshard - 1)]     # (P, B, S, D)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    return collectives.all_reduce(rows, rt.tp_comm(), rt.comm
                                  ).to(table.dtype)


def logits_shard(params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """x (P, …, D) -> vocab-sharded f32 logits (P, …, vocab/tp); no
    combine (the cross-entropy and sampling handle the sharded vocab with
    two small reductions)."""
    table = params["table"]
    # f operator only when the vocab is genuinely sharded
    x = tp_grad_sum(x, rt, rt.mesh.tp > 1
                    and table.shape[1] < rt.cfg.vocab_size)
    return matmul_f32(x, table.transpose(1, 2).to(x.dtype))


def cross_entropy_vocab_sharded(logits: torch.Tensor, labels: torch.Tensor,
                                rt: Runtime,
                                mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Stable cross-entropy over vocab-sharded logits ``(P, B, S, V/tp)``
    with ``labels`` ``(B, S)`` or ``(P, B, S)``: a max and a sum
    all-reduce over the model axis -> every row's mean loss ``(P,)``.

    The shift is detached before its max all-reduce (math-neutral; the max
    has no gradient), and the picked logit is summed over the model axis
    raw so that every rank forms the same loss: the consumers of a sum
    all-reduce must be replicated computations (its backward is the
    identity)."""
    tp = rt.mesh.tp
    if logits.shape[-1] >= rt.cfg.vocab_size:
        tp = 1   # vocab replicated on every model rank: no collectives
    z = logits.float()
    zmax = z.detach().amax(dim=-1, keepdim=True)
    if tp > 1:
        zmax = collectives.all_reduce(zmax, rt.tp_comm(), rt.comm, op="max")
    ez = torch.exp(z - zmax)
    denom = ez.sum(dim=-1, keepdim=True)
    if tp > 1:
        denom = collectives.all_reduce(denom, rt.tp_comm(), rt.comm)
    vshard = logits.shape[-1]
    P = logits.shape[0]
    labels = _row_tokens(labels, P)
    if tp > 1:
        shard = rank_index(rt, logits.device).view(P, 1, 1)
        local = labels - shard * vshard
        valid = (local >= 0) & (local < vshard)
        picked = torch.gather(z, -1, local.clamp(0, vshard - 1)[..., None]
                              )[..., 0]
        picked = torch.where(valid, picked, torch.zeros_like(picked))
        picked = collectives.all_reduce(picked, rt.tp_comm(), rt.comm)
    else:
        picked = torch.gather(z, -1, labels[..., None].long())[..., 0]
    nll = -(picked - zmax[..., 0] - torch.log(denom[..., 0]))
    if mask is not None:
        mask = _row_tokens(mask, P).to(nll.dtype)
        nll = nll * mask
        return nll.flatten(1).sum(1) / torch.clamp_min(
            mask.flatten(1).sum(1), 1.0)
    return nll.flatten(1).mean(1)


def greedy_sample_vocab_sharded(logits: torch.Tensor, rt: Runtime
                                ) -> torch.Tensor:
    """argmax over vocab-sharded logits ``(P, B, vocab/tp)`` -> int32
    ``(P, B)``, the same token on every rank: an all-reduce ``max`` of the
    local maxima, then an all-reduce ``min`` of the int32 candidates (the
    lowest index among equal maxima, as ``argmax`` picks)."""
    tp = rt.mesh.tp
    vshard = logits.shape[-1]
    local_max = logits.amax(dim=-1)
    local_arg = logits.argmax(dim=-1).to(torch.int32)
    if tp == 1 or vshard >= rt.cfg.vocab_size:
        return local_arg
    shard = rank_index(rt, logits.device).to(torch.int32).view(
        (-1,) + (1,) * (local_arg.dim() - 1))
    global_arg = local_arg + shard * vshard
    gmax = collectives.all_reduce(local_max, rt.tp_comm(), rt.comm, op="max")
    cand = torch.where(local_max >= gmax, global_arg,
                       torch.full_like(global_arg, torch.iinfo(torch.int32).max))
    return collectives.all_reduce(cand, rt.tp_comm(), rt.comm, op="min")
