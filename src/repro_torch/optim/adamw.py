"""AdamW with ZeRO-1 optimizer-state sharding over the data axis (PyTorch
port, stacked ranks).

Two modes, as in the JAX package:

- **plain**: full fp32 moments per rank; gradients averaged over the data
  axis with an ACCL-X all-reduce.  It refuses FSDP leaves whose data
  ranks hold different slices (the JAX package's plain route sums them).
- **zero1**: every rank's gradients are flattened into one vector (leaves
  in sorted-key order, as ``jax.tree.flatten`` orders them), padded to a
  multiple of ``dp`` and reduce-scattered over the ``data`` axis through
  ``oc.grad_comm or rt.comm`` — where the paper's ring reduce-scatter and
  its int8 wire plug in.  Each data rank owns ``1/dp`` of every model
  shard's optimizer state, runs Adam on its slice, and the delta is
  all-gathered back.  On a ``(pod, data, model)`` mesh the slices are cut
  over the last data axis only and summed over the pod axes
  (``pod_reduce``, a flat all-reduce) between the reduce-scatter and the
  update, so every pod holds the same slices.

Stacked layout: a parameter leaf holds every rank on its rank dimension
(``(P, ...)``, or ``(n_layers, P, ...)`` under ``layers``); the zero1
moments are ``(P, k)``, row ``p`` the slice of data rank ``(p // tp) %
dp`` of model shard ``p % tp``, ``dp`` the last data axis's size (the JAX
package's global ``(tp, dp, k)``, replicated over pods, see
:func:`global_slices`).  Every per-rank scalar (the gradient norm, the
clip scale) is a ``(P,)`` vector, equal across the ranks that share it.

FSDP leaves (``fsdp_plan`` code >= 0) stay out of the flat vector: their
gradients arrive already summed over the last data axis (the backward of
the FSDP all-gather is the sum reduce-scatter), are summed over the pods
and divided by the data-rank count once, here, and each rank's shard keeps
its own moments (``m_fsdp``/``v_fsdp``, trees of the FSDP leaves only) and
updates in place: ZeRO-3 naturally.

Divisions by a Python scalar are written tensor by tensor: PyTorch divides
by a scalar as a multiply by its reciprocal on the card, which rounds
differently from the JAX package's division.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import collectives
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import CommConfig
from repro_torch.models import sharding
from repro_torch.models.common import Runtime

# columns per elementwise pass over a (P, n) flat vector: a full-width
# temporary is GBs, a chunk's 1 GB at most
_CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    zero1: bool = True
    moment_dtype: Any = torch.float32
    # Separate wire config for the gradient reduce-scatter/all-gather (e.g.
    # ring + int8 compression) without touching the forward TP collectives.
    grad_comm: Optional[CommConfig] = None


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def schedule(step: torch.Tensor, oc: OptConfig) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 on ``step``'s device."""
    step = step.float()
    one = _f32(1.0, step)
    warm = torch.minimum(one, (step + 1) / _f32(max(1, oc.warmup_steps),
                                                step))
    t = torch.clamp((step - oc.warmup_steps)
                    / _f32(max(1, oc.total_steps - oc.warmup_steps), step),
                    0.0, 1.0)
    cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi, step) * t))
    return oc.lr * warm * cos


# ----------------------------------------------------------------------
# Trees and the flat layout
# ----------------------------------------------------------------------

def leaves_with_names(tree, names: tuple = ()) -> list:
    """``[(names, leaf), ...]`` in sorted-key order (``jax.tree.flatten``'s
    order for dicts)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_names(tree[k], names + (k,)))
        return out
    return [(names, tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def partition_params(tree, fsdp_plan):
    """Split ``tree`` into ``(regular, fsdp)`` by the plan's codes: two
    trees of the same nesting, each holding only its own leaves (the JAX
    package's ``None`` leaves are left out, as ``jax.tree.leaves`` skips
    them)."""
    if fsdp_plan is None:
        return tree, {}
    reg, fs = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            r, f = partition_params(v, fsdp_plan[k])
            if r:
                reg[k] = r
            if f:
                fs[k] = f
        elif fsdp_plan[k] >= 0:
            fs[k] = v
        else:
            reg[k] = v
    return reg, fs


def _merge(reg, fs):
    """Inverse of :func:`partition_params`."""
    out = dict(reg)
    for k, v in fs.items():
        out[k] = _merge(reg.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _unflatten(tree, values: list):
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    out = build(tree)
    return _reorder(out, tree)


def _reorder(out, like):
    if isinstance(like, dict):
        return {k: _reorder(out[k], v) for k, v in like.items()}
    return out


def rank_dim(names) -> int:
    """The rank dimension of a leaf: after its layer dimension, if any."""
    return sharding._n_stack_dims(list(names))


def per_rank(x: torch.Tensor, leaf: torch.Tensor, names) -> torch.Tensor:
    """A ``(P,)`` per-rank value viewed to broadcast against ``leaf``."""
    r = rank_dim(names)
    return x.view((1,) * r + (-1,) + (1,) * (leaf.dim() - r - 1))


def rows(leaf: torch.Tensor, names) -> torch.Tensor:
    """``leaf`` as ``(P, size)``: each rank's values, row-major."""
    r = rank_dim(names)
    return leaf.movedim(r, 0).reshape(leaf.shape[r], -1)


def from_rows(x: torch.Tensor, leaf: torch.Tensor, names) -> torch.Tensor:
    """Inverse of :func:`rows`, in ``leaf``'s layout."""
    r = rank_dim(names)
    shape = list(leaf.shape)
    P = shape.pop(r)
    return x.reshape([P] + shape).movedim(0, r)


def leaf_all_reduce(g: torch.Tensor, names, comm: Communicator,
                    cfg: CommConfig) -> torch.Tensor:
    """The sum all-reduce of a parameter-shaped leaf (rank dimension
    ``rank_dim(names)``) over ``comm``'s groups."""
    r = rank_dim(names)
    return collectives.all_reduce(g.movedim(r, 0), comm, cfg).movedim(
        0, r).contiguous()


def _row_sum(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(chunk).sum(-1)`` over column chunks of ``x (P, n)`` -> ``(P,)``
    f32."""
    out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for a in range(0, x.shape[1], _CHUNK):
        out = out + fn(x[:, a:a + _CHUNK].float()).sum(-1)
    return out


def _sq(x: torch.Tensor) -> torch.Tensor:
    return _row_sum(x, torch.square)


# ----------------------------------------------------------------------
# State
# ----------------------------------------------------------------------

def _flat_size(params) -> int:
    return sum(rows(l, n).shape[1] for n, l in leaves_with_names(params))


def refuse_plain_fsdp(fsdp_plan) -> None:
    """The plain route all-reduces every gradient over the data axis; on a
    data-sharded FSDP leaf that would add the gradients of different
    slices together, so it is refused (FSDP trains under ZeRO-1)."""
    if fsdp_plan is not None and any(
            c >= 0 for _, c in leaves_with_names(fsdp_plan)):
        raise ValueError("FSDP with data-sharded leaves needs the ZeRO-1 "
                         "route (OptConfig(zero1=True)): the plain route's "
                         "data all-reduce would sum different slices")


def init_state(params, oc: OptConfig, rt: Runtime, fsdp_plan=None):
    """Optimizer state: plain — moment trees shaped like ``params``; zero1
    (``dp > 1``) — ``m_slice``/``v_slice`` ``(P, ceil(n / dp))``, ``n`` a
    rank's count of regular (non-FSDP) parameters, and ``m_fsdp``/
    ``v_fsdp`` shaped like the FSDP leaves' shards."""
    dp = rt.mesh.data_sizes[-1]
    any_leaf = leaves_with_names(params)[0][1]
    step = torch.zeros((), dtype=torch.int32, device=any_leaf.device)

    def zeros(p):
        return torch.zeros(p.shape, dtype=oc.moment_dtype, device=p.device)
    if not oc.zero1 or dp == 1:
        refuse_plain_fsdp(fsdp_plan)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": step}
    reg, fs = partition_params(params, fsdp_plan)
    n = _flat_size(reg)
    k = (n + (-n) % dp) // dp
    P = rt.mesh.n_ranks
    return {"m_slice": torch.zeros((P, k), dtype=oc.moment_dtype,
                                   device=any_leaf.device),
            "v_slice": torch.zeros((P, k), dtype=oc.moment_dtype,
                                   device=any_leaf.device),
            "m_fsdp": tree_map(zeros, fs), "v_fsdp": tree_map(zeros, fs),
            "step": step}


def global_slices(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Stacked zero1 slices ``(P, k)`` -> the JAX package's global ``(tp,
    dp, k)`` (``P('model', 'data', None)``, ``dp`` the last data axis's
    size).  The slices are replicated over the pod axes: pod 0's copy is
    taken."""
    tp, dp = rt.mesh.tp, rt.mesh.data_sizes[-1]
    return x.reshape(-1, dp, tp, x.shape[-1])[0].transpose(0, 1).contiguous()


def stacked_slices(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Inverse of :func:`global_slices`: every pod gets the same slices."""
    tp, dp = rt.mesh.tp, rt.mesh.data_sizes[-1]
    pods = rt.mesh.dp // dp
    x = x.transpose(0, 1).reshape(1, dp * tp, -1)
    return x.expand(pods, -1, -1).reshape(pods * dp * tp, -1).contiguous()


def state_specs(param_spec_tree, oc: OptConfig, rt: Runtime,
                fsdp_plan=None):
    """Spec tree matching :func:`init_state`'s output (the JAX package's
    PartitionSpecs as tuples; ``()`` is replicated)."""
    dp = rt.mesh.data_sizes[-1]
    if not oc.zero1 or dp == 1:
        return {"m": param_spec_tree, "v": param_spec_tree, "step": ()}
    sl = (rt.mesh.axis_model, rt.mesh.data_axes[-1], None)
    fs = partition_params(param_spec_tree, fsdp_plan)[1]
    return {"m_slice": sl, "v_slice": sl, "m_fsdp": fs, "v_fsdp": fs,
            "step": ()}


# ----------------------------------------------------------------------
# The update
# ----------------------------------------------------------------------

def _adam_update(g, m, v, p32, lr, oc: OptConfig, step):
    b1, b2 = oc.b1, oc.b2
    m32 = m.float() * b1 + g * (1 - b1)
    v32 = v.float() * b2 + g * g * (1 - b2)
    t = step.float() + 1.0
    mhat = m32 / (1 - torch.pow(_f32(b1, t), t))
    vhat = v32 / (1 - torch.pow(_f32(b2, t), t))
    upd = mhat / (torch.sqrt(vhat) + oc.eps) + oc.weight_decay * p32
    return p32 - lr * upd, m32.to(m.dtype), v32.to(v.dtype)


def clip_scale(gnorm: torch.Tensor, oc: OptConfig) -> torch.Tensor:
    if oc.clip_norm is None:
        return torch.ones_like(gnorm)
    return torch.minimum(torch.ones_like(gnorm),
                         _f32(oc.clip_norm, gnorm) / (gnorm + 1e-9))


def rt_comm_data(rt: Runtime) -> Communicator:
    """The groups of the last data axis."""
    return Communicator.from_mesh(rt.mesh, rt.mesh.data_axes[-1])


def pod_reduce(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The sum of a stacked ``(P, ...)`` value over the pod axes (every data
    axis but the last), through ``rt.comm``; the identity without pods."""
    pod_axes = rt.mesh.data_axes[:-1]
    if not pod_axes:
        return x
    return collectives.all_reduce(
        x, Communicator.from_mesh(rt.mesh, pod_axes), rt.comm)


def sharded_global_norm(grads, ms_mask, rt: Runtime) -> torch.Tensor:
    """Every rank's global gradient norm ``(P,)`` (plain mode): the squared
    norms of model-sharded leaves summed over the model axis, replicated
    leaves counted once."""
    named = leaves_with_names(grads)
    if ms_mask is None or rt.mesh.tp == 1:
        return torch.sqrt(sum(_sq(rows(g, n)) for n, g in named))
    flags = [m for _, m in leaves_with_names(ms_mask)]
    sq_sharded = sum(_sq(rows(g, n)) for (n, g), m in zip(named, flags) if m)
    sq_repl = sum(_sq(rows(g, n)) for (n, g), m in zip(named, flags)
                  if not m)
    sq_sharded = collectives.all_reduce(sq_sharded, rt.tp_comm(), rt.comm)
    return torch.sqrt(sq_sharded + sq_repl)


def apply_updates(params, grads, state, oc: OptConfig, rt: Runtime,
                  fsdp_plan=None, ms_mask=None, donate: bool = False):
    """One optimizer step -> ``(params, state, {"lr", "grad_norm"})``
    (``grad_norm`` is ``(P,)``).  ``grads`` must already be model-axis
    correct (``train_step.grad_model_sync``); this routine reduces them
    over the data axis per mode.  ``donate`` lets the zero1 update write
    the new moments into ``state``'s (the JAX package's buffer donation):
    the same values, without a second copy of the moments."""
    step = state["step"]
    lr = schedule(step, oc)
    if "m_slice" not in state:
        refuse_plain_fsdp(fsdp_plan)
        return _apply_plain(params, grads, state, oc, rt, ms_mask, step, lr)
    reg_p, fs_p = partition_params(params, fsdp_plan)
    reg_g, fs_g = partition_params(grads, fsdp_plan)
    reg_ms, fs_ms = (partition_params(ms_mask, fsdp_plan)
                     if ms_mask is not None else (None, None))
    new_reg, m2, v2, fs_g, scale, gnorm = _apply_zero1(
        reg_p, reg_g, state, oc, rt, reg_ms, step, lr, donate, fs_g, fs_ms)
    new_fs, m_fs, v_fs = _apply_fsdp_leaves(fs_p, fs_g, state, scale, oc,
                                            step, lr, donate)
    return _reorder(_merge(new_reg, new_fs), params), \
        {"m_slice": m2, "v_slice": v2, "m_fsdp": m_fs, "v_fsdp": v_fs,
         "step": step + 1}, {"lr": lr, "grad_norm": gnorm}


def _apply_plain(params, grads, state, oc, rt, ms_mask, step, lr):
    dp = rt.mesh.dp
    named = leaves_with_names(grads)
    if dp > 1:
        grads = _unflatten(grads, [
            leaf_all_reduce(g.float(), names, rt.dp_comm(), rt.comm) / dp
            for names, g in named])
    else:
        grads = tree_map(lambda g: g.float(), grads)
    gnorm = sharded_global_norm(grads, ms_mask, rt)
    scale = clip_scale(gnorm, oc)
    named = leaves_with_names(params)
    outs = []
    for (names, p), (_, g), (_, m), (_, v) in zip(
            named, leaves_with_names(grads), leaves_with_names(state["m"]),
            leaves_with_names(state["v"])):
        p2, m2, v2 = _adam_update(g * per_rank(scale, g, names), m, v,
                                  p.float(), lr, oc, step)
        outs.append((p2.to(p.dtype), m2, v2))
    new_p = _unflatten(params, [o[0] for o in outs])
    new_m = _unflatten(params, [o[1] for o in outs])
    new_v = _unflatten(params, [o[2] for o in outs])
    return new_p, {"m": new_m, "v": new_v, "step": step + 1}, \
        {"lr": lr, "grad_norm": gnorm}


def _segments(tree) -> list:
    """``[(names, leaf, start, end), ...]``: each leaf's columns in a
    rank's flat vector."""
    out, off = [], 0
    for names, leaf in leaves_with_names(tree):
        n = rows(leaf, names).shape[1]
        out.append((names, leaf, off, off + n))
        off += n
    return out


def _owned(tree, g: int, r: int, k: int, tp: int) -> torch.Tensor:
    """Columns ``[r k, (r + 1) k)`` (the slice of data rank ``r`` of the
    last data axis) of the flat f32 vectors of the rows of data group ``g``
    (the ``g``-th block of ``tp`` rows) -> ``(tp, k)`` (zeros past the
    end)."""
    lo, hi = r * k, (r + 1) * k
    pieces = []
    for names, leaf, a, b in _segments(tree):
        if b <= lo or a >= hi:
            continue
        x = rows(leaf, names)[g * tp:(g + 1) * tp]
        pieces.append(x[:, max(lo, a) - a:min(hi, b) - a].float())
    got = sum(p.shape[1] for p in pieces)
    if got < k:
        pieces.append(torch.zeros((tp, k - got), dtype=torch.float32,
                                  device=pieces[0].device if pieces
                                  else None))
    return torch.cat(pieces, dim=1)


def _apply_fsdp_leaves(params, grads, state, scale, oc, step, lr, donate):
    """Adam on each FSDP shard (``grads`` the data-mean gradients,
    ``scale`` the global clip), layer by layer; ``donate`` writes the new
    moments into ``state``'s."""
    outs = []
    for (names, p), (_, g), (_, m), (_, v) in zip(
            leaves_with_names(params), leaves_with_names(grads),
            leaves_with_names(state["m_fsdp"]),
            leaves_with_names(state["v_fsdp"])):
        p2 = torch.empty_like(p)
        m2 = m if donate else torch.empty_like(m)
        v2 = v if donate else torch.empty_like(v)
        s = per_rank(scale, g, names)[0]    # FSDP leaves are layer stacks
        for i in range(p.shape[0]):
            # one layer at a time: a full-width leaf's f32 temporaries
            # are GBs
            new, m2[i], v2[i] = _adam_update(g[i] * s, m[i], v[i],
                                             p[i].float(), lr, oc, step)
            p2[i] = new.to(p.dtype)
        outs.append((p2, m2, v2))
    return tuple(_unflatten(params, [o[j] for o in outs]) for j in range(3))


def _apply_zero1(params, grads, state, oc, rt, ms_mask, step, lr, donate,
                 fs_g, fs_ms):
    """The ZeRO-1 update of the regular leaves -> ``(params, m_slice,
    v_slice, fsdp gradients, clip scale, gradient norm)``: the FSDP
    leaves' gradients ``fs_g`` join the global norm and come back
    pod-reduced and divided by the data-rank count."""
    tp, dp = rt.mesh.tp, rt.mesh.data_sizes[-1]
    gcfg = oc.grad_comm or rt.comm
    segs = _segments(grads)
    n = segs[-1][3]
    k = (n + (-n) % dp) // dp
    # the flat gradient, padded: (P, dp k)
    flat_g = torch.cat([rows(g, names).float() for names, g, _, _ in segs]
                       + ([torch.zeros((rt.mesh.n_ranks, dp * k - n),
                                       device=segs[0][1].device)]
                          if dp * k > n else []), dim=1)
    # the mean over every data rank, pods included: the slice of the last
    # data axis's reduce-scatter, summed over the pods
    dpf = _f32(float(rt.mesh.dp), flat_g)
    g_slice = collectives.reduce_scatter(flat_g, rt_comm_data(rt), gcfg) / dpf
    del flat_g
    g_slice = pod_reduce(g_slice, rt)

    # Global grad norm: weight 1 for model-sharded leaves (disjoint shards,
    # summed over the model axis), 1/tp for replicated ones (equal on every
    # model rank: counted once after the model-axis sum); slices summed
    # over data (pods hold equal slices after pod_reduce: not summed).
    flags = ([m for _, m in leaves_with_names(ms_mask)] if ms_mask
             is not None else [1] * len(segs))
    pods = rt.mesh.dp // dp
    gv = g_slice.view(pods, dp, tp, k)
    sq_rows = []
    for r in range(dp):
        sq = torch.zeros((pods, tp), dtype=torch.float32,
                         device=g_slice.device)
        for (_, _, a, b), m in zip(segs, flags):
            lo, hi = max(a, r * k), min(b, (r + 1) * k)
            if hi <= lo:
                continue
            part = torch.stack([_sq(gv[q, r, :, lo - r * k:hi - r * k])
                                for q in range(pods)])
            sq = sq + (part if m else part * _f32(1.0 / tp, part))
        sq_rows.append(sq)
    sq = torch.stack(sq_rows, dim=1).reshape(-1)
    # FSDP leaves: summed over the last data axis already (the gather's
    # backward); summed over the pods and divided by every data rank
    # here, once; each row's shard adds its own squares
    fs_named = leaves_with_names(fs_g)
    fs_flags = ([m for _, m in leaves_with_names(fs_ms)] if fs_ms
                else [1] * len(fs_named))
    fs_out = []
    for (names, g), m in zip(fs_named, fs_flags):
        r = rank_dim(names)
        g = pod_reduce(g.float().movedim(r, 0), rt).movedim(0, r) / dpf
        part = _sq(rows(g, names))
        sq = sq + (part if m else part * _f32(1.0 / tp, part))
        fs_out.append(g)
    if dp > 1:
        sq = collectives.all_reduce(sq, rt_comm_data(rt), rt.comm)
    if tp > 1:
        sq = collectives.all_reduce(sq, rt.tp_comm(), rt.comm)
    gnorm = torch.sqrt(sq)
    scale = clip_scale(gnorm, oc)

    # Adam on the owned slice, column chunk by chunk (a full-width slice
    # is GBs per temporary); the moments go to new buffers, or are updated
    # in place when the caller donates the state
    p_slice = torch.cat([_owned(params, g, g % dp, k, tp)
                         for g in range(pods * dp)])
    m_old, v_old = state["m_slice"], state["v_slice"]
    m2 = m_old if donate else torch.empty_like(m_old)
    v2 = v_old if donate else torch.empty_like(v_old)
    delta = torch.empty_like(p_slice)
    g_slice = g_slice * scale[:, None]
    for a in range(0, k, _CHUNK):
        b = min(k, a + _CHUNK)
        p2, m2[:, a:b], v2[:, a:b] = _adam_update(
            g_slice[:, a:b], m_old[:, a:b], v_old[:, a:b], p_slice[:, a:b],
            lr, oc, step)
        delta[:, a:b] = p2 - p_slice[:, a:b]
        del p2
    del g_slice, p_slice
    if dp > 1:
        delta_full = collectives.all_gather(delta, rt_comm_data(rt), gcfg,
                                            axis=0, tiled=True)
    else:
        delta_full = delta
    del delta
    new = []
    for names, p, a, b in _segments(params):
        x = (rows(p, names).float() + delta_full[:, a:b]).to(p.dtype)
        new.append(from_rows(x, p, names).contiguous())
    return (_unflatten(params, new), m2, v2, _unflatten(fs_g, fs_out), scale,
            gnorm)
