"""Mixture-of-Experts with expert parallelism over the ``model`` axis, on
stacked ranks.

Expert placement is the JAX package's flattened (expert × ff-shard)
layout: each expert leaf is stored ``(tp, e_loc, a, b)`` and cut over the
model ranks on its first dim, so model rank ``m`` holds slice ``m``: whole
experts ``(m // tp_inner) * e_loc + j`` (``j < e_loc``), each cut into
``tp_inner`` ff-shards across neighbouring ranks when ``tp > n_experts``.
On stacked ranks a layer's expert leaf is ``(P, 1, e_loc, a, b)``: row
``p`` holds model shard ``p % tp``.

Activations are replicated across the model axis between blocks, so the
dispatch is a local capacity-bounded gather and the combine one ACCL-X
all-reduce (f32) that sums the experts' contributions and the ff-shards
of one expert at once.  The all-to-all variant (:func:`moe_block_a2a`,
EP over the *data* axis: tokens travel) is the pattern whose latency the
streaming levers target: under overlapped scheduling with streaming
delivery both its all-to-alls are tiled into wire chunks, bitwise equal
to the fused op.

Capacity follows Switch/GShard: an expert takes at most ``C =
capacity_factor · T · top_k / n_experts`` tokens; an overflowing token
drops that expert's contribution (its other experts still fire).  ``C``
is set by the token count alone, so the block's shapes are static.

Top-k picks follow ``lax.top_k``: the larger value first and, among equal
values, the lower index (a stable descending sort), for the expert choice
and the capacity gather alike.  Each expert's outputs are added into the
tokens' rows one expert at a time, in expert order; within one expert the
rows are distinct, so the sum is the same on every run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, Runtime


def moe_layout(cfg: ModelConfig, tp: int) -> tuple[int, int]:
    """``(experts_per_rank, tp_inner)``.  Requires ``n_experts % tp == 0``
    or ``tp % n_experts == 0``."""
    E = cfg.n_experts
    if E % tp == 0:
        return E // tp, 1
    if tp % E == 0:
        return 1, tp // E
    raise ValueError(f"n_experts={E} incompatible with tp={tp}")


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             tp: int) -> dict:
    """Full arrays shaped ``(tp, e_loc, d, ff_slice)`` (``w_down``: ``(tp,
    e_loc, ff_slice, d)``), the model ranks' slices on dim 0; the values
    are drawn as ``(E, a, b)`` and rearranged, so they do not depend on
    ``tp``."""
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e_loc, tp_inner = moe_layout(cfg, tp)
    E = cfg.n_experts

    def normal(a, b, scale):
        return torch.randn((E, a, b), generator=gen, dtype=torch.float32,
                           device=device) * scale

    def cols(full):         # (E, a, b) -> (tp, e_loc, a, b / tp_inner)
        a, b = full.shape[1:]
        full = full.reshape(E, a, tp_inner, b // tp_inner).movedim(2, 1)
        return full.reshape(tp, e_loc, a, b // tp_inner).to(dtype)

    def rows(full):         # (E, a, b) -> (tp, e_loc, a / tp_inner, b)
        a, b = full.shape[1:]
        return full.reshape(tp, e_loc, a // tp_inner, b).to(dtype)

    p = {"router": layers.dense_init(gen, d, E, torch.float32, device),
         "w_gate": cols(normal(d, ff, (1.0 / d) ** 0.5)),
         "w_up": cols(normal(d, ff, (1.0 / d) ** 0.5)),
         "w_down": rows(normal(ff, d, (1.0 / ff) ** 0.5))}
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(gen, d, ff * cfg.n_shared_experts,
                                      cfg.mlp_type, dtype, device)
    return p


def _expert_mlp(xg, wg, wu, wd, mlp_type: str) -> torch.Tensor:
    """One expert per row: ``xg (P, n, D)``, weights ``(P, D, F)`` and
    ``(P, F, D)`` -> ``(P, n, D)`` f32 (products in f32, the hidden state
    rounded to the input dtype before the down projection)."""
    if mlp_type == "swiglu":
        h = F.silu(layers.matmul_f32(xg, wg)) * layers.matmul_f32(xg, wu)
    else:
        h = F.gelu(layers.matmul_f32(xg, wu), approximate="tanh")
    return layers.matmul_f32(h.to(xg.dtype), wd)


def _top_k(v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the ``k`` largest, ties to the
    lower index."""
    if k > v.shape[-1]:
        raise ValueError(f"top-{k} of {v.shape[-1]} values")
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, xt: torch.Tensor, cfg: ModelConfig):
    """Router of ``xt (P, T, D)`` (f32): ``(gates (P, T, E), aux (P,))``,
    a token's gate the renormalised top-k probability of each chosen
    expert (0 elsewhere), aux the Switch load-balance loss ``E · Σ_e f_e
    · P_e``."""
    logits = torch.bmm(xt.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                     # (P, T, E)
    top_p, top_e = _top_k(probs, cfg.n_experts_per_tok)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    dispatch = F.one_hot(top_e, cfg.n_experts).to(torch.float32)
    f_e = dispatch.sum(2).mean(1)
    aux = cfg.n_experts * (f_e * probs.mean(1)).sum(-1)
    gates = (dispatch * top_p[..., None]).sum(2)
    return gates, aux


def capacity(cfg: ModelConfig, T: int) -> int:
    """Tokens an expert takes of ``T``: ``capacity_factor · T · top_k /
    n_experts``, at least 8 and at most ``T`` (a decode step's few)."""
    cap = int(cfg.capacity_factor * T * cfg.n_experts_per_tok
              / cfg.n_experts)
    return min(T, max(8, cap))


def dropped(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The (token, expert) assignments of ``x (P, B, S, D)`` (the block's
    input) that :func:`moe_block`'s capacity cut drops, a count a row
    ``(P,)``: each expert's chosen tokens past its capacity."""
    P, B, S, D = x.shape
    gates, _ = _route(params, x.reshape(P, B * S, D), cfg)
    over = (gates > 0).sum(1) - capacity(cfg, B * S)
    return over.clamp_min(0).sum(-1)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (P, T, D)`` at ``idx (P, n)`` -> ``(P, n, D)``."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _add_rows(out: torch.Tensor, idx: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """``out (P, T, D)`` with ``y (P, n, D)`` added at rows ``idx (P, n)``
    (distinct within a row of ``idx``)."""
    P, T, D = out.shape
    flat = (idx + torch.arange(P, device=idx.device)[:, None] * T).reshape(-1)
    return out.reshape(P * T, D).index_add(
        0, flat, y.reshape(-1, D)).reshape(P, T, D)


def moe_block(params, x: torch.Tensor, rt: Runtime
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (P, B, S, D)`` replicated across the model axis -> ``(out (P, B,
    S, D), aux (P,))``."""
    cfg = rt.cfg
    tp = rt.mesh.tp
    e_loc, tp_inner = moe_layout(cfg, tp)
    P, B, S, D = x.shape
    x_pre_f = x
    x = layers.tp_grad_sum(x, rt, tp > 1)
    T = B * S
    xt = x.reshape(P, T, D)

    gates, aux = _route(params, xt, cfg)
    # The full value on every rank (the loss agrees across tp); 1/tp on the
    # gradient, since every rank computes this path and the gradients are
    # summed over the model axis at sync.
    if tp > 1:
        aux = layers.scale_grad(aux, 1.0 / tp)

    cap = capacity(cfg, T)
    # row p holds model shard p % tp: local expert j is global expert
    # (shard // tp_inner) * e_loc + j
    first = (layers.rank_index(rt, x.device) // tp_inner) * e_loc
    # the stacked expert leaves (P, 1, e_loc, a, b) as (P, e_loc, a, b)
    wg, wu, wd = (params[k].flatten(1, 2)
                  for k in ("w_gate", "w_up", "w_down"))

    out = torch.zeros((P, T, D), dtype=torch.float32, device=x.device)
    for j in range(e_loc):
        g_e = torch.gather(gates, 2, (first + j).view(P, 1, 1).expand(
            P, T, 1))[..., 0]
        sel_g, sel_idx = _top_k(g_e, cap)        # capacity-bounded gather
        keep = sel_g > 0
        y = _expert_mlp(_gather_rows(xt, sel_idx), wg[:, j], wu[:, j],
                        wd[:, j], cfg.mlp_type)
        y = y * (sel_g * keep)[..., None]
        out = _add_rows(out, sel_idx,
                        torch.where(keep[..., None], y, torch.zeros_like(y)))

    if tp > 1:
        # the experts' sum and the ff-shards' sum of one expert in one op
        out = collectives.all_reduce(out, rt.tp_comm(), rt.comm)

    y = out.to(x.dtype).reshape(P, B, S, D)
    if cfg.n_shared_experts:
        # the pre-f input: layers.mlp applies its own f operator, and two
        # would sum the shared experts' cotangent twice
        ff_sh = (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
        y = y + layers.mlp(params["shared"], x_pre_f, rt, cfg.mlp_type,
                           sharded=ff_sh % tp == 0 and tp > 1)
    return y, aux.to(torch.float32)


def moe_block_a2a(params, x_shard: torch.Tensor, rt: Runtime
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """All-to-all dispatch variant (EP over the *data* axis; tokens
    travel).

    ``x_shard (P, T_loc, D)``: each data rank's tokens.  Tokens are
    bucketed per destination expert owner, exchanged with ``all_to_all``,
    run through the owner's local experts and sent back.  The expert
    leaves are read as the JAX package reads them, ``(-1, D, F)`` of each
    row's tree: a row applies its tree's experts ``0 .. e_loc - 1``."""
    cfg = rt.cfg
    dp = rt.mesh.dp
    comm = rt.dp_comm()
    if cfg.n_experts % dp:
        raise ValueError("the a2a variant needs n_experts % dp == 0")
    e_loc = cfg.n_experts // dp
    P, T, D = x_shard.shape

    gates, aux = _route(params, x_shard, cfg)
    cap = max(8, int(cfg.capacity_factor * T * cfg.n_experts_per_tok
                     / cfg.n_experts))
    # buckets per destination rank, (P, dp, e_loc · cap, ...): expert e
    # goes to rank e // e_loc, slot e % e_loc
    picks = [_top_k(gates[..., e], cap) for e in range(cfg.n_experts)]
    send = torch.stack([_gather_rows(x_shard, i) for _, i in picks], 1)
    send = send.reshape(P, dp, e_loc * cap, D)
    send_gate = torch.stack([g for g, _ in picks], 1).reshape(P, dp, -1)
    send_idx = torch.stack([i for _, i in picks], 1).reshape(P, dp, -1)

    # dispatch: overlapped scheduling with streaming delivery tiles it into
    # independent wire chunks; fused issues one all-to-all
    recv = collectives.all_to_all(send, comm, rt.comm)
    wg, wu, wd = (params[k].reshape(P, -1, *params[k].shape[-2:])
                  for k in ("w_gate", "w_up", "w_down"))
    ys = []
    for j in range(e_loc):
        xg = recv[:, :, j * cap:(j + 1) * cap].reshape(P, -1, D)
        y = _expert_mlp(xg, wg[:, j], wu[:, j], wd[:, j], cfg.mlp_type)
        ys.append(y.reshape(P, dp, cap, D))
    y_out = torch.cat(ys, dim=2)                   # (P, dp, e_loc · cap, D)
    # combine: the same chunked routing as the dispatch
    back = collectives.all_to_all(y_out.to(x_shard.dtype), comm, rt.comm)

    out = torch.zeros((P, T, D), dtype=torch.float32, device=x_shard.device)
    for r in range(dp):
        for j in range(e_loc):
            sl = slice(j * cap, (j + 1) * cap)
            g = send_gate[:, r, sl]
            seg = back[:, r, sl].float()
            w = torch.where(g > 0, g, torch.zeros_like(g))
            out = _add_rows(out, send_idx[:, r, sl], seg * w[..., None])
    return out.to(x_shard.dtype), aux
