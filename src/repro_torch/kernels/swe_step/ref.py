"""Plain PyTorch version of the swe_step kernel — the CPU path and the
oracle the CUDA kernel is held against.  The physics delegates to the
solver's own math (``repro_torch.swe.dg_solver``), as the JAX package's
``swe_step/ref.py`` does."""
from __future__ import annotations

import torch

from repro_torch.swe.dg_solver import reflect, rusanov


def element_update(u, u_n, normals, edge_type, area, valid, h_sea, *,
                   dt: float):
    """Rusanov flux through 3 edges + the explicit update, per element.

    ``u (..., 3)``, ``u_n (..., 3, 3)`` neighbour states, ``normals
    (..., 3, 2)``, ``edge_type (..., 3)``, ``area``/``valid (...)``,
    ``h_sea`` a 0-dim tensor."""
    ub = u.unsqueeze(-2).expand(u_n.shape)
    u_land = reflect(ub, normals)
    u_sea = torch.stack([h_sea.expand(ub.shape[:-1]), ub[..., 1], ub[..., 2]],
                        dim=-1)
    et = edge_type.unsqueeze(-1)
    u_r = torch.where(et == 1, u_land, torch.where(et == 2, u_sea, u_n))
    f = rusanov(ub, u_r, normals)
    div = f[..., 0, :] + f[..., 1, :] + f[..., 2, :]
    # tensor / tensor: PyTorch computes `scalar / tensor` as a reciprocal
    # times the scalar, which rounds differently from a true division
    k = area.new_full((), dt) / torch.clamp(area, min=1e-12)
    new = (u - k.unsqueeze(-1) * div) * valid.unsqueeze(-1)
    h = torch.clamp(new[..., 0], min=1e-6) * valid
    return torch.cat([h.unsqueeze(-1), new[..., 1:]], dim=-1)


def swe_step_ref(state, halo, normals, neigh_idx, edge_type, area, valid,
                 h_sea, *, dt: float, rows=None, out=None):
    """The kernel's function on stacked ranks.

    ``state (P, E, 3)``, ``halo (P, H, 3)``, ``normals (P, E, 3, 2)``,
    ``neigh_idx``/``edge_type (P, E, 3)`` (an index below ``E`` reads
    ``state[p]``, else ``halo[p][idx - E]``), ``area``/``valid (P, E)``,
    ``h_sea`` a 0-dim tensor.  Without ``rows`` returns the updated state;
    with ``rows (P, n)`` updates only those rows of ``out`` in place and
    returns ``out``."""
    P = state.shape[0]
    ext = torch.cat([state, halo], dim=1)
    if rows is None:
        u, nidx, nrm, et, ar, vl = (state, neigh_idx, normals, edge_type,
                                    area, valid)
    else:
        r = rows.long()
        r3 = r.unsqueeze(-1).expand(-1, -1, 3)
        u = torch.gather(state, 1, r3)
        nidx = torch.gather(neigh_idx, 1, r3)
        nrm = torch.gather(normals, 1,
                           r[..., None, None].expand(-1, -1, 3, 2))
        et = torch.gather(edge_type, 1, r3)
        ar = torch.gather(area, 1, r)
        vl = torch.gather(valid, 1, r)
    n = nidx.shape[1]
    u_n = torch.gather(ext, 1, nidx.long().reshape(P, n * 3, 1)
                       .expand(-1, -1, 3)).reshape(P, n, 3, 3)
    new = element_update(u, u_n, nrm, et, ar, vl, h_sea, dt=dt)
    if rows is None:
        return new
    out.scatter_(1, r3, new)
    return out
