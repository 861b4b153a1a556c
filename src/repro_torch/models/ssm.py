"""Mamba2 (SSD — state-space duality) layers on stacked tensor-parallel
ranks.

Prefill uses the chunked SSD algorithm: within a chunk the output is an
attention-like masked matmul, across chunks a ``(heads, state, head_dim)``
state is carried.  That scan is the SSD kernel
(:mod:`repro_torch.kernels.ssd_scan`): the CUDA kernel on the card, its
plain version on the CPU.  Decode is the single-token recurrence.

TP layout, as in the JAX package: heads (``d_inner / head_dim``) are
sharded over ``model`` when divisible (mamba2-130m's 24 heads at tp 2 and
4); otherwise the layer computes replicated on every rank.  The B/C/dt
projections are small and always computed replicated.  Where the JAX
package slices the replicated ``dt``, ``A_log``, ``D``, ``dt_bias`` and
``norm`` at ``lax.axis_index * heads``, each row of the rank dimension
gathers its slice at ``comm.rank() * heads``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, Runtime


def ssm_dims(cfg: ModelConfig, tp: int) -> tuple[int, bool]:
    """(local_heads, sharded?)"""
    nh = cfg.ssm_heads
    if tp > 1 and nh % tp == 0:
        return nh // tp, True
    return nh, False


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """Full (unsharded) parameter arrays; ``dt_bias``, ``A_log`` and ``D``
    are float32 whatever ``dtype`` is."""
    d, di = cfg.d_model, cfg.d_inner
    nh, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    f32 = dict(dtype=torch.float32, device=device)
    p = {name: layers.dense_init(gen, d, width, dtype, device)
         for name, width in (("w_z", di), ("w_x", di), ("w_B", g * n),
                             ("w_C", g * n), ("w_dt", nh))}
    p["dt_bias"] = torch.zeros((nh,), **f32)
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, nh, **f32))
    p["D"] = torch.ones((nh,), **f32)
    p["conv_x"] = (torch.randn((cfg.conv_width, di), generator=gen, **f32)
                   * (1.0 / cfg.conv_width) ** 0.5).to(dtype)
    p["norm"] = torch.zeros((di,), dtype=dtype, device=device)
    p["w_out"] = layers.dense_init(gen, di, d, dtype, device)
    return p


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                    state: Optional[torch.Tensor] = None):
    """Causal depthwise conv.  x ``(P, B, S, C)``, w ``(P, W, C)``, state
    ``(P, B, W-1, C)`` or None.  Returns (y, new_state)."""
    P, B, S, Ch = x.shape
    W = w.shape[1]
    if state is None:
        state = x.new_zeros((P, B, W - 1, Ch))
    xp = torch.cat([state, x], dim=2)
    wf = w.float()
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xp[:, :, i:i + S].float() * wf[:, i].view(P, 1, 1, Ch)
    new_state = xp[:, :, -(W - 1):] if W > 1 else state
    return F.silu(y).to(x.dtype), new_state


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, v.new_zeros(()))


def _head_leaves(params, start, hl: int, p_dim: int):
    """(A_log, D, dt_bias, norm) of each row's heads: the slice at
    ``start`` (the rank's first head) when heads shard, else the leaves."""
    leaves = (params["A_log"], params["D"], params["dt_bias"])
    if start is None:
        return leaves + (params["norm"],)
    return tuple(layers.rank_slice(t, start, hl, dim=0) for t in leaves) + (
        layers.rank_slice(params["norm"], start * p_dim, hl * p_dim, dim=0),)


def _gate_norm_out(params, y, z, norm_w, rt: Runtime, sharded: bool,
                   hl: int, dtype):
    """Gated per-head RMSNorm (grouped per SSD head, so the result is the
    same under any tp) and the output projection: row-parallel with one
    combine when heads shard, else replicated on every rank."""
    cfg = rt.cfg
    lead = y.shape[:-1]
    yg = (y * F.silu(z.float()).to(dtype)).reshape(
        *lead, hl, cfg.ssm_head_dim)
    yg = layers.rms_norm(yg, norm_w.reshape(-1, hl, cfg.ssm_head_dim),
                         cfg.norm_eps)
    y = yg.reshape(*lead, hl * cfg.ssm_head_dim)
    if sharded:
        return layers.row_parallel(y, params["w_out"], rt)
    return layers.rank_matmul(y, params["w_out"])


def ssm_forward(params, x: torch.Tensor, rt: Runtime,
                return_state: bool = False):
    """Full-sequence Mamba2 block from a zero state.  x ``(P, B, S, D)``
    replicated -> ``(P, B, S, D)``; with ``return_state`` also
    ``(conv_state (P, B, W-1, d_inner_local), ssd_state (P, B, hl, N,
    head_dim) f32)``."""
    cfg = rt.cfg
    hl, sharded = ssm_dims(cfg, rt.mesh.tp)
    P, B, S, _ = x.shape
    p_dim = cfg.ssm_head_dim

    x = layers.tp_grad_sum(x, rt, sharded)
    # column-parallel when heads shard; else the same per-rank product
    # with full weights
    z = layers.col_parallel(x, params["w_z"])
    xin = layers.col_parallel(x, params["w_x"])
    gn = (cfg.ssm_groups, cfg.ssm_state)
    Bp, Cp = (layers.matmul_f32(x, params[w]).to(x.dtype).reshape(
        P, B, S, *gn) for w in ("w_B", "w_C"))
    dt = layers.matmul_f32(x, params["w_dt"])

    start = layers.rank_index(rt, x.device) * hl if sharded else None
    if sharded:
        dt = layers.rank_slice(dt, start, hl, dim=2)
    A_log, Dp, dt_bias, norm_w = _head_leaves(params, start, hl, p_dim)

    xin, new_conv = _depthwise_conv(xin, params["conv_x"])
    dt = _softplus(dt + layers.per_rank(dt_bias, dt.dim()))
    A = -torch.exp(A_log)

    xh = xin.reshape(P, B, S, hl, p_dim)
    y, h_final = ssd_ops.ssd_chunked(xh, dt, A, Bp, Cp, cfg.ssm_chunk)
    y = y + xh.float() * layers.per_rank(Dp, 4)[..., None]
    y = y.reshape(P, B, S, hl * p_dim).to(x.dtype)
    out = _gate_norm_out(params, y, z, norm_w, rt, sharded, hl, x.dtype)
    if return_state:
        return out, (new_conv, h_final)
    return out


class SSMState(NamedTuple):
    conv: torch.Tensor    # ([L,] P, B, W-1, d_inner_local) in cfg.dtype
    h: torch.Tensor       # ([L,] P, B, local_heads, state, head_dim) f32


def init_ssm_state(cfg: ModelConfig, batch: int, tp: int, device,
                   n_layers: int) -> SSMState:
    """Zero states of ``batch`` sequences on ``tp`` stacked ranks for
    ``n_layers`` layers."""
    hl, _ = ssm_dims(cfg, tp)
    return SSMState(
        conv=torch.zeros((n_layers, tp, batch, cfg.conv_width - 1,
                          hl * cfg.ssm_head_dim),
                         dtype=cfg.dtype, device=device),
        h=torch.zeros((n_layers, tp, batch, hl, cfg.ssm_state,
                       cfg.ssm_head_dim),
                      dtype=torch.float32, device=device))


def ssm_decode(params, x: torch.Tensor, state: SSMState, rt: Runtime
               ) -> tuple[torch.Tensor, SSMState]:
    """Single-token recurrent step.  x ``(P, B, 1, D)``; returns the
    output and a new state (the state given is not written)."""
    cfg = rt.cfg
    hl, sharded = ssm_dims(cfg, rt.mesh.tp)
    P, B = x.shape[:2]
    p_dim = cfg.ssm_head_dim

    z = layers.col_parallel(x, params["w_z"])
    xin = layers.col_parallel(x, params["w_x"])
    gn = (cfg.ssm_groups, cfg.ssm_state)
    Bp = layers.matmul_f32(x, params["w_B"])[:, :, 0].reshape(P, B, *gn)
    Cp = layers.matmul_f32(x, params["w_C"])[:, :, 0].reshape(P, B, *gn)
    Bp, Cp = Bp[:, :, 0], Cp[:, :, 0]
    dt = layers.matmul_f32(x, params["w_dt"])[:, :, 0]          # (P, B, nh)

    start = layers.rank_index(rt, x.device) * hl if sharded else None
    if sharded:
        dt = layers.rank_slice(dt, start, hl, dim=1)
    A_log, Dp, dt_bias, norm_w = _head_leaves(params, start, hl, p_dim)

    xin, new_conv = _depthwise_conv(xin, params["conv_x"], state.conv)
    dt = _softplus(dt + dt_bias[:, None])                        # (P, B, hl)
    A = -torch.exp(A_log)

    xh = xin[:, :, 0].reshape(P, B, hl, p_dim).float()
    decay = torch.exp(dt * A[:, None])
    # h: (P, B, hl, n, p);  h' = decay·h + dt·B ⊗ x
    dBx = torch.einsum("rbh,rbn,rbhp->rbhnp", dt, Bp, xh)
    h_new = state.h * decay[..., None, None] + dBx
    y = torch.einsum("rbn,rbhnp->rbhp", Cp, h_new)
    y = y + xh * Dp[:, None, :, None]
    y = y.reshape(P, B, 1, hl * p_dim).to(x.dtype)
    out = _gate_norm_out(params, y, z, norm_w, rt, sharded, hl, x.dtype)
    return out, SSMState(conv=new_conv, h=h_new)
