"""Parameter sharding rules of the LM path — one source of truth.

``param_specs`` gives every leaf of a full (global) parameter tree its
tensor-parallel spec, the JAX package's ``_base_spec`` rules for the dense
and ssm leaves; ``shard_params`` cuts the full arrays into per-rank shards
stacked on a rank dimension, and ``unshard_params`` puts them back together.
``from_reference`` is the weight carrier from the JAX package: its
parameters as numpy arrays (``jax.device_get`` of a ``build_session``
tree) in, the port's stacked shards out.

TP rules (model axis), with ``tp`` the stacked rank count:
  embed.table        (V, D)         -> ('model', None)   vocab-sharded
  attn wq            (D, Heff*hd)   -> (None, 'model')   col-parallel
  attn wk/wv         (D, KV*hd)     -> (None, 'model') if kv_sharded
  attn wo            (Heff*hd, D)   -> ('model', None)   row-parallel
  mlp w_up/w_gate    (D, F)         -> (None, 'model')
  mlp w_down         (F, D)         -> ('model', None)
  ssm w_z/w_x        (D, d_inner)   -> (None, 'model') if ssm heads shard
  ssm conv_x         (W, d_inner)   -> (None, 'model') if ssm heads shard
  ssm w_out          (d_inner, D)   -> ('model', None) if ssm heads shard
  ssm w_B/w_C/w_dt                  -> replicated
  norms, A_log, D, dt_bias          -> replicated
A leaf under ``layers`` carries one leading layer dimension; its shards
are laid out ``(n_layers, P, ...)`` so that layer ``i``'s view is a
stacked ``(P, ...)`` tensor.  On a ``(data, model)`` mesh ``P = dp · tp``:
every data rank holds a copy of the ``tp`` shards (row ``p`` is shard
``p % tp``).  FSDP (a data-axis factor on the weights) is not ported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import attention, ssm
from repro_torch.models.common import MeshContext, ModelConfig

_STACK_KEYS = ("layers",)


def _n_stack_dims(names: list[str]) -> int:
    return 1 if any(k in names for k in _STACK_KEYS) else 0


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
    if leaf == "wq":
        return (None, "model") if dims.q_sharded else (None, None)
    if leaf in ("wk", "wv"):
        return (None, "model") if dims.kv_sharded else (None, None)
    if leaf == "wo":
        return ("model", None) if dims.q_sharded else (None, None)
    if leaf in ("w_up", "w_gate"):
        return (None, "model") if mlp_shardable else (None, None)
    if leaf == "w_down":
        return ("model", None) if mlp_shardable else (None, None)
    if leaf in ("w_z", "w_x", "conv_x"):
        return (None, "model") if ssm_sharded else (None, None)
    if leaf == "w_out":
        return ("model", None) if ssm_sharded else (None, None)
    return None  # norms, w_B, w_C, w_dt, A_log, D, dt_bias


def _map(fn, tree: Any, names: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, names + (k,)) for k, v in tree.items()}
    return fn(list(names), tree)


def _tp_of(mesh) -> int:
    return mesh.model_size if isinstance(mesh, MeshContext) else int(mesh)


def param_specs(params: Any, cfg: ModelConfig, mesh, fsdp: bool = False):
    """Spec tree of a full parameter tree: a tuple per leaf, ``None`` for
    a leading layer dimension and for a replicated dim, ``"model"`` for
    the dim cut over the model ranks (``mesh`` is a ``MeshContext`` or the
    tensor-parallel size).  Every leaf is replicated over the data axis."""
    if fsdp:
        raise NotImplementedError(
            "FSDP (build_fsdp_plan / apply_fsdp) is not ported yet; see "
            "ROADMAP.md Queue 1")
    tp = _tp_of(mesh)

    def spec_of(names, leaf):
        n_stack = _n_stack_dims(names)
        base = _base_spec(names, cfg, tp)
        body = base if base is not None else (None,) * (leaf.dim() - n_stack)
        return (None,) * n_stack + tuple(body)
    return _map(spec_of, params)


def grad_model_sum_mask(params: Any, cfg: ModelConfig, tp: int):
    """1 where the gradient must be SUMMED over the model axis at sync
    time: parameters stored replicated but *used* shardwise (each rank
    back-propagates only the slice it consumed) — replicated-KV weights
    under head-sharded attention, the q/k norms of sharded heads, and the
    sliced SSM scalars."""
    dims = attention.attn_dims(cfg, tp)
    _, ssm_sharded = ssm.ssm_dims(cfg, tp)

    def mask_of(names, leaf):
        if tp == 1:
            return 0
        leaf_name = names[-1]
        parent = names[-2] if len(names) >= 2 else ""
        if leaf_name in ("q_norm", "k_norm") and dims.q_sharded:
            return 1
        if leaf_name in ("wk", "wv") and dims.q_sharded \
                and not dims.kv_sharded:
            return 1
        if ssm_sharded and parent == "ssm" and leaf_name in (
                "w_B", "w_C", "w_dt", "A_log", "D", "dt_bias", "norm"):
            return 1
        return 0
    return _map(mask_of, params)


def model_sharded_mask(spec_tree):
    """1 where the parameter (hence its gradient) is cut over the model
    axis: such leaves hold disjoint shards, whose squared norms sum over
    the model axis; replicated leaves hold equal gradients (count once)."""
    if isinstance(spec_tree, dict):
        return {k: model_sharded_mask(v) for k, v in spec_tree.items()}
    return 1 if "model" in spec_tree else 0


def _model_dim(spec) -> int:
    return spec.index("model") if "model" in spec else -1


def shard_params(params: Any, cfg: ModelConfig, tp: int, device=None,
                 dp: int = 1):
    """Cut every full leaf into its ``tp`` per-rank shards (replicated
    leaves are copied to every rank), each data rank holding a copy:
    ``(dp · tp, ...)``, or ``(n_layers, dp · tp, ...)`` under ``layers``,
    in the leaf's dtype on ``device``."""
    specs = param_specs(params, cfg, tp)

    def cut(names, leaf):
        spec = specs
        for n in names:
            spec = spec[n]
        n_stack = _n_stack_dims(names)
        leaf = leaf.to(device) if device is not None else leaf
        j = _model_dim(spec)
        P = dp * tp
        if j < 0:
            shape = leaf.shape[:n_stack] + (P,) + leaf.shape[n_stack:]
            return leaf.unsqueeze(n_stack).expand(shape).contiguous()
        if leaf.shape[j] % tp:
            raise ValueError(f"{'.'.join(names)}: dim {j} of "
                             f"{tuple(leaf.shape)} does not divide by {tp}")
        return torch.stack(torch.chunk(leaf, tp, dim=j) * dp, dim=n_stack)
    return _map(cut, params)


def unshard_params(params: Any, cfg: ModelConfig, tp: int | None = None):
    """Inverse of :func:`shard_params`: full arrays from the first data
    rank's shards (rows ``0 .. tp-1``), a replicated leaf taken from row
    0.  ``tp`` defaults to the whole rank dimension (one data rank)."""
    def glue(names, leaf):
        n_stack = _n_stack_dims(names)
        n = tp or leaf.shape[n_stack]
        body = leaf.select(n_stack, 0)
        spec = _base_spec(names, cfg, n)
        if spec is None or "model" not in spec:
            return body
        j = n_stack + spec.index("model")
        return torch.cat(leaf.narrow(n_stack, 0, n).unbind(n_stack), dim=j)
    return _map(glue, params)


_TORCH_FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def from_reference(np_params: Any, cfg: ModelConfig, tp: int, device=None,
                   dp: int = 1):
    """The JAX package's parameter tree (numpy arrays) -> the port's stacked
    per-rank shards on ``device``, each leaf in its own float type (the SSM
    layer's ``A_log``, ``D`` and ``dt_bias`` stay float32 under a bf16
    config, as in the JAX package)."""
    def to_torch(names, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=_TORCH_FLOATS[np.dtype(a.dtype).name])
    return shard_params(_map(to_torch, np_params), cfg, tp, dp=dp)
