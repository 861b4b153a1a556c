"""Parameter sharding rules of the LM path — one source of truth.

``param_specs`` gives every leaf of a full (global) parameter tree its
tensor-parallel spec, the JAX package's ``_base_spec`` rules for the dense,
moe and ssm leaves; ``shard_params`` cuts the full arrays into per-rank shards
stacked on a rank dimension, and ``unshard_params`` puts them back together.
``from_reference`` is the weight carrier from the JAX package: its
parameters as numpy arrays (``jax.device_get`` of a ``build_session``
tree) in, the port's stacked shards out.

TP rules (model axis), with ``tp`` the stacked rank count:
  embed.table        (V, D)         -> ('model', None)   vocab-sharded
  attn wq            (D, Heff*hd)   -> (None, 'model')   col-parallel
  attn wk/wv         (D, KV*hd)     -> (None, 'model') if kv_sharded
  attn wo            (Heff*hd, D)   -> ('model', None)   row-parallel
  MLA w_uq/w_uk/w_uv (lora, H*·)    -> (None, 'model')   col-parallel
  MLA wo             (H*v_hd, D)    -> ('model', None)   row-parallel
  MLA w_dq/w_dkv/w_kr, q_norm/kv_norm -> replicated
  mlp w_up/w_gate    (D, F)         -> (None, 'model')
  mlp w_down         (F, D)         -> ('model', None)
  moe router         (D, E)         -> replicated
  moe w_gate/w_up/w_down (tp, e_loc, a, b) -> ('model', None, None, None)
                                       (flattened EP: one slice a rank)
  ssm w_z/w_x        (D, d_inner)   -> (None, 'model') if ssm heads shard
  ssm conv_x         (W, d_inner)   -> (None, 'model') if ssm heads shard
  ssm w_out          (d_inner, D)   -> ('model', None) if ssm heads shard
  ssm w_B/w_C/w_dt                  -> replicated
  hybrid shared_attn proj_in (2D, D) -> replicated
  norms, A_log, D, dt_bias          -> replicated
A leaf under a stack key (``_STACK_KEYS``: ``layers``, gemma3's
``blocks`` and ``trailing``, the hybrid family's ``groups`` and
``trailing``) carries its leading stack dimensions, one, or two under
``blocks/local`` (``(n_blocks, r, ...)``: ``r`` local layers a
super-block) and ``groups/ssm`` (``(n_groups, k, ...)``: ``k`` Mamba2
layers a group); the hybrid family's ``shared_attn`` (one block used after
every group) has none, takes the dense rules by leaf name and is never
FSDP-cut.  A leaf's shards are laid out ``(*stack, P, ...)`` so that layer
``i``'s view is a stacked ``(P, ...)`` tensor.  On a ``(data, model)``
mesh ``P = dp · tp`` and row ``p`` holds model shard ``p % tp``; every
data rank holds a copy of the ``tp`` shards.  An MoE expert leaf's body
dim 0 *is* the model dim, of size ``tp``: its shards are ``(*stack, P, 1,
e_loc, a, b)`` (:mod:`repro_torch.models.moe` reads them so), and a tree
built at another ``tp`` is refused.

FSDP (``build_fsdp_plan``, ``apply_fsdp``): each layer-stack weight takes
a ``data`` factor on the first body dim that can carry it
(``_fsdp_dim``), ``("model", "data")`` on a model-sharded dim (cut over
the model ranks, then each model shard over the data ranks).  Row ``p``
then holds data rank ``(p // tp) % dp``'s slice of model shard ``p % tp``
(``dp`` the last data axis's size; pods hold copies), as the ZeRO-1 slices
do.  ``apply_fsdp`` all-gathers those dims back to full at use, inside
the recomputed block: one layer materialized at a time (ZeRO-3 style);
its backward is the sum reduce-scatter, so each FSDP gradient leaves
summed over the data ranks.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.communicator import Communicator
from repro_torch.models import attention, layers, ssm
from repro_torch.models.common import MeshContext, ModelConfig, Runtime

_STACK_KEYS = ("layers", "blocks", "groups", "trailing", "encoder",
               "dense_layers")
_MIN_FSDP_SHARD = 8   # don't data-shard below this many rows per rank


def _n_stack_dims(names: list[str]) -> int:
    """Leading stack dims of a leaf: 1 under a stack key, 2 where a
    super-block stacks its inner layers (``blocks/local``,
    ``groups/ssm``)."""
    n = 0
    if any(k in names for k in _STACK_KEYS):
        n = 1
        if "blocks" in names and "local" in names:
            n = 2
        if "groups" in names and "ssm" in names:
            n = 2
    return n


def _is_expert(names) -> bool:
    """An MoE expert leaf: ``(tp, e_loc, a, b)`` in the full tree."""
    return len(names) >= 2 and names[-2] == "moe" and names[-1] in (
        "w_gate", "w_up", "w_down")


def _base_spec(names: list[str], cfg: ModelConfig, tp: int):
    """TP spec entries for the unstacked (body) dims, or None =
    replicated."""
    leaf = names[-1]
    dims = attention.attn_dims(cfg, tp)
    _, ssm_sharded = ssm.ssm_dims(cfg, tp)
    mlp_shardable = bool(cfg.d_ff) and cfg.d_ff % tp == 0 and tp > 1
    if leaf == "table":
        return ("model", None) if tp > 1 and cfg.vocab_size % tp == 0 \
            else (None, None)
    if leaf == "router":
        return (None, None)
    if _is_expert(names):
        return ("model", None, None, None) if tp > 1 else (None,) * 4
    if leaf == "wq":
        return (None, "model") if dims.q_sharded else (None, None)
    if leaf in ("wk", "wv"):
        return (None, "model") if dims.kv_sharded else (None, None)
    if leaf == "wo":
        if cfg.use_mla:
            return ("model", None) if tp > 1 else (None, None)
        return ("model", None) if dims.q_sharded else (None, None)
    if leaf in ("w_uq", "w_uk", "w_uv"):
        return (None, "model") if tp > 1 else (None, None)
    if leaf in ("w_dq", "w_dkv", "w_kr"):
        return (None, None)
    if leaf in ("w_up", "w_gate"):
        return (None, "model") if mlp_shardable else (None, None)
    if leaf == "w_down":
        return ("model", None) if mlp_shardable else (None, None)
    if leaf in ("w_z", "w_x", "conv_x"):
        return (None, "model") if ssm_sharded else (None, None)
    if leaf == "w_out":
        return ("model", None) if ssm_sharded else (None, None)
    return None  # norms, w_B, w_C, w_dt, A_log, D, dt_bias


def _fsdp_dim(base, body_shape, tp: int, dp: int) -> int:
    """First body dim that can take a 'data' factor; -1 if none."""
    if len(body_shape) < 2 or dp <= 1:
        return -1
    entries = list(base) if base is not None else [None] * len(body_shape)
    for j, dim in enumerate(body_shape):
        local = dim // tp if entries[j] == "model" else dim
        if entries[j] not in (None, "model"):
            continue
        if local % dp == 0 and local // dp >= _MIN_FSDP_SHARD:
            return j
    return -1


def _map(fn, tree: Any, names: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, names + (k,)) for k, v in tree.items()}
    return fn(list(names), tree)


def _mesh_sizes(mesh) -> tuple[int, int]:
    """``(tp, dp)`` of a ``MeshContext`` (``dp`` its last data axis, the one
    FSDP factors), or ``(mesh, 1)`` for a tensor-parallel size."""
    if isinstance(mesh, MeshContext):
        return mesh.model_size, mesh.data_sizes[-1]
    return int(mesh), 1


def _spec(names: list[str], shape: tuple, cfg: ModelConfig, tp: int,
          dp: int, fsdp: bool) -> tuple:
    n_stack = _n_stack_dims(names)
    base = _base_spec(names, cfg, tp)
    body = list(base) if base is not None else [None] * (len(shape) - n_stack)
    if fsdp and n_stack > 0:
        j = _fsdp_dim(base, shape[n_stack:], tp, dp)
        if j >= 0:
            body[j] = ("model", "data") if body[j] == "model" else "data"
    return (None,) * n_stack + tuple(body)


def param_specs(params: Any, cfg: ModelConfig, mesh, fsdp: bool = False):
    """Spec tree of a full parameter tree: a tuple per leaf, ``None`` for
    a leading layer dimension and for a replicated dim, ``"model"`` for
    the dim cut over the model ranks (``mesh`` is a ``MeshContext`` or the
    tensor-parallel size).  With ``fsdp`` a layer-stack leaf's FSDP dim
    carries ``"data"``, or ``("model", "data")`` (the JAX package's
    PartitionSpec entries); every other leaf is replicated over data."""
    tp, dp = _mesh_sizes(mesh)
    return _map(lambda names, leaf: _spec(names, tuple(leaf.shape), cfg, tp,
                                          dp, fsdp), params)


def build_fsdp_plan(params: Any, cfg: ModelConfig, mesh: MeshContext):
    """Tree of int codes matching ``params`` (full shapes; meta tensors
    do): -1 = no gather, else ``gather_dim * 100 + body_ndim``, the gather
    dim in *body* coordinates (stack dims stripped)."""
    tp, dp = _mesh_sizes(mesh)

    def plan_of(names, leaf):
        n_stack = _n_stack_dims(names)
        if n_stack == 0:
            return -1
        body = tuple(leaf.shape[n_stack:])
        j = _fsdp_dim(_base_spec(names, cfg, tp), body, tp, dp)
        return j * 100 + len(body) if j >= 0 else -1
    return _map(plan_of, params)


def subplan(plan, key: str):
    return None if plan is None else plan.get(key)


def _code(plan, names) -> int:
    for n in names:
        if plan is None:
            return -1
        plan = plan.get(n)
    return -1 if plan is None else plan


def fsdp_comm(rt: Runtime) -> Communicator:
    """The groups FSDP gathers over: the last data axis."""
    return Communicator.from_mesh(rt.mesh, rt.mesh.data_axes[-1])


class _GatherFsdp(torch.autograd.Function):
    """All-gather of a weight's data-factored dim; the backward is the sum
    reduce-scatter (the JAX package's AD transpose of the gather)."""

    @staticmethod
    def forward(ctx, shard, axis, rt):
        ctx.axis, ctx.rt = axis, rt
        return collectives.all_gather(shard, fsdp_comm(rt), rt.comm,
                                      axis=axis, tiled=True)

    @staticmethod
    def backward(ctx, ct):
        rt = ctx.rt
        return layers.scatter_sum(ct, fsdp_comm(rt), rt.comm,
                                  ctx.axis), None, None


def apply_fsdp(layer_params: Any, plan: Any, rt: Runtime):
    """All-gather the 'data'-factored dims of one layer's stacked weights
    (``(P, *body_shard)`` leaves) back to their model shards, over the
    last data axis through ``rt.comm``.  A leaf that keeps stack dims at
    this site (a super-block's ``local`` leaves, ``(r, P, *body)``) is
    gathered with its rank dimension moved first, its plan code offset by
    the leftover dims."""
    if plan is None or rt.mesh.data_sizes[-1] == 1:
        return layer_params

    def fix(leaf, code):
        if isinstance(leaf, dict):
            return {k: fix(v, code[k]) for k, v in leaf.items()}
        if code < 0:
            return leaf
        j, body_ndim = divmod(code, 100)
        extra = leaf.dim() - 1 - body_ndim   # leftover stack dims here
        if extra == 0:
            return _GatherFsdp.apply(leaf, j, rt)
        full = _GatherFsdp.apply(leaf.movedim(extra, 0), j + extra, rt)
        return full.movedim(0, extra)
    return fix(layer_params, plan)


def grad_model_sum_mask(params: Any, cfg: ModelConfig, tp: int,
                        seq_parallel: bool = False):
    """1 where the gradient must be SUMMED over the model axis at sync
    time: parameters stored replicated but *used* shardwise (each rank
    back-propagates only the slice it consumed) — replicated-KV weights
    under head-sharded attention, the q/k norms of sharded heads, MLA's
    down-projections and their norms (each rank back-propagates its own
    heads' share), the sliced SSM scalars, the MoE router (each rank
    back-propagates the gates of its own experts), and under Megatron-SP
    the block norms, which run on sequence shards (SP is off under
    local/global attention, whose stack runs the plain block)."""
    dims = attention.attn_dims(cfg, tp)
    _, ssm_sharded = ssm.ssm_dims(cfg, tp)
    sp_active = (seq_parallel and tp > 1 and dims.q_sharded
                 and cfg.family in ("dense", "vlm")
                 and not cfg.local_global_ratio)

    def mask_of(names, leaf):
        if tp == 1:
            return 0
        leaf_name = names[-1]
        parent = names[-2] if len(names) >= 2 else ""
        if sp_active and leaf_name in ("ln1", "ln2") and "layers" in names:
            return 1
        if cfg.use_mla and leaf_name in ("w_dq", "w_dkv", "w_kr", "q_norm",
                                         "kv_norm"):
            return 1
        if not cfg.use_mla and leaf_name in ("q_norm", "k_norm") \
                and dims.q_sharded:
            return 1
        if leaf_name in ("wk", "wv") and dims.q_sharded \
                and not dims.kv_sharded:
            return 1
        if ssm_sharded and parent == "ssm" and leaf_name in (
                "w_B", "w_C", "w_dt", "A_log", "D", "dt_bias", "norm"):
            return 1
        if leaf_name == "router":
            return 1
        return 0
    return _map(mask_of, params)


def _has_model(entry) -> bool:
    return entry == "model" or (isinstance(entry, tuple) and "model" in entry)


def model_sharded_mask(spec_tree):
    """1 where the parameter (hence its gradient) is cut over the model
    axis: such leaves hold disjoint shards, whose squared norms sum over
    the model axis; replicated leaves hold equal gradients (count once)."""
    if isinstance(spec_tree, dict):
        return {k: model_sharded_mask(v) for k, v in spec_tree.items()}
    return 1 if any(_has_model(e) for e in spec_tree) else 0


def _piece(leaf: torch.Tensor, spec: tuple, m: int, d: int, tp: int,
           dp: int, names) -> torch.Tensor:
    """The part of a full ``leaf`` that model rank ``m``, data rank ``d``
    holds under ``spec`` (a view)."""
    for axis, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            k, r = (tp, m) if a == "model" else (dp, d)
            idx, n = idx * k + r, n * k
        size = leaf.shape[axis]
        if size % n:
            raise ValueError(f"{'.'.join(names)}: dim {axis} of "
                             f"{tuple(leaf.shape)} does not divide by {n}")
        leaf = leaf.narrow(axis, idx * (size // n), size // n)
    return leaf


def shard_params(params: Any, cfg: ModelConfig, tp: int, device=None,
                 dp: int = 1, fsdp_dp: int = 1):
    """Cut every full leaf into its per-rank shards, stacked: ``(dp · tp,
    ...)``, or ``(*stack, dp · tp, ...)`` under a stack key, in the
    leaf's dtype on ``device``.  Row ``p`` holds model shard ``p % tp``
    (replicated leaves are copied to every row); ``fsdp_dp > 1`` (the last
    data axis's size) also cuts each FSDP leaf's FSDP dim, row ``p`` taking
    data rank ``(p // tp) % fsdp_dp``'s slice."""
    P = dp * tp

    def cut(names, leaf):
        leaf = leaf.to(device) if device is not None else leaf
        n_stack = _n_stack_dims(names)
        if _is_expert(names) and leaf.shape[n_stack] != tp:
            raise ValueError(f"{'/'.join(names)}: {tuple(leaf.shape)} is an "
                             f"expert stack built at tp="
                             f"{leaf.shape[n_stack]}, not {tp}")
        spec = _spec(names, tuple(leaf.shape), cfg, tp, fsdp_dp, fsdp_dp > 1)
        return torch.stack([_piece(leaf, spec, p % tp, (p // tp) % fsdp_dp,
                                   tp, fsdp_dp, names) for p in range(P)],
                           dim=n_stack)
    return _map(cut, params)


def unshard_params(params: Any, cfg: ModelConfig, tp: int | None = None,
                   plan: Any = None, fsdp_dp: int = 1):
    """Inverse of :func:`shard_params`: full arrays from pod 0's rows (data
    ranks ``0 .. fsdp_dp-1`` of the FSDP leaves, ``plan``'s codes; the
    first data rank's rows of every other leaf), a replicated leaf taken
    from row 0.  ``tp`` defaults to the whole rank dimension (one data
    rank).  ``params`` may hold a subset of ``plan``'s leaves."""
    def glue(names, leaf):
        n_stack = _n_stack_dims(names)
        n = tp or leaf.shape[n_stack]
        spec = _base_spec(names, cfg, n)
        jm = n_stack + spec.index("model") if spec and "model" in spec else -1
        code = _code(plan, names) if fsdp_dp > 1 else -1
        jd = n_stack + code // 100 if code >= 0 else -1
        shards = []
        for m in range(n if jm >= 0 else 1):
            parts = [leaf.select(n_stack, d * n + m)
                     for d in range(fsdp_dp if jd >= 0 else 1)]
            shards.append(torch.cat(parts, dim=jd) if jd >= 0 else parts[0])
        return torch.cat(shards, dim=jm) if jm >= 0 else shards[0]
    return _map(glue, params)


_TORCH_FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def from_reference(np_params: Any, cfg: ModelConfig, tp: int, device=None,
                   dp: int = 1, fsdp_dp: int = 1):
    """The JAX package's parameter tree (numpy arrays; ``layers``, or
    gemma3's ``blocks/{local,global}`` and ``trailing``, or the moe
    family's ``layers`` and ``dense_layers``, with GQA or MLA attention,
    or the hybrid family's ``groups/ssm``, ``trailing`` and
    ``shared_attn``;
    an MoE tree built at the same ``tp``, its expert layout depending on
    it) -> the port's
    stacked per-rank shards on ``device`` (FSDP leaves cut over ``fsdp_dp``
    data ranks), each leaf in its own float type (the SSM layer's ``A_log``,
    ``D`` and ``dt_bias`` stay float32 under a bf16 config, as in the JAX
    package)."""
    def to_torch(names, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=_TORCH_FLOATS[np.dtype(a.dtype).name])
    return shard_params(_map(to_torch, np_params), cfg, tp, dp=dp,
                        fsdp_dp=fsdp_dp)
