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
are laid out ``(n_layers, tp, ...)`` so that layer ``i``'s view is a
stacked ``(tp, ...)`` tensor.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import attention, ssm
from repro_torch.models.common import ModelConfig

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


def param_specs(params: Any, cfg: ModelConfig, tp: int):
    """Spec tree of a full parameter tree: a tuple per leaf, ``None`` for
    a leading layer dimension and for a replicated dim, ``"model"`` for
    the dim cut over the ranks."""
    def spec_of(names, leaf):
        n_stack = _n_stack_dims(names)
        base = _base_spec(names, cfg, tp)
        body = base if base is not None else (None,) * (leaf.dim() - n_stack)
        return (None,) * n_stack + tuple(body)
    return _map(spec_of, params)


def _model_dim(spec) -> int:
    return spec.index("model") if "model" in spec else -1


def shard_params(params: Any, cfg: ModelConfig, tp: int, device=None):
    """Cut every full leaf into its ``tp`` per-rank shards (replicated
    leaves are copied to every rank): ``(tp, ...)``, or ``(n_layers, tp,
    ...)`` under ``layers``, in the leaf's dtype on ``device``."""
    specs = param_specs(params, cfg, tp)

    def cut(names, leaf):
        spec = specs
        for n in names:
            spec = spec[n]
        n_stack = _n_stack_dims(names)
        leaf = leaf.to(device) if device is not None else leaf
        j = _model_dim(spec)
        if j < 0:
            shape = leaf.shape[:n_stack] + (tp,) + leaf.shape[n_stack:]
            return leaf.unsqueeze(n_stack).expand(shape).contiguous()
        if leaf.shape[j] % tp:
            raise ValueError(f"{'.'.join(names)}: dim {j} of "
                             f"{tuple(leaf.shape)} does not divide by {tp}")
        return torch.stack(torch.chunk(leaf, tp, dim=j), dim=n_stack)
    return _map(cut, params)


def unshard_params(params: Any, cfg: ModelConfig):
    """Inverse of :func:`shard_params`: full arrays, a replicated leaf
    taken from rank 0."""
    def glue(names, leaf):
        n_stack = _n_stack_dims(names)
        tp = leaf.shape[n_stack]
        body = leaf.select(n_stack, 0)
        spec = _base_spec(names, cfg, tp)
        if spec is None or "model" not in spec:
            return body
        j = n_stack + spec.index("model")
        return torch.cat(leaf.unbind(n_stack), dim=j)
    return _map(glue, params)


_TORCH_FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def from_reference(np_params: Any, cfg: ModelConfig, tp: int, device=None):
    """The JAX package's parameter tree (numpy arrays) -> the port's stacked
    per-rank shards on ``device``, each leaf in its own float type (the SSM
    layer's ``A_log``, ``D`` and ``dt_bias`` stay float32 under a bf16
    config, as in the JAX package)."""
    def to_torch(names, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=_TORCH_FLOATS[np.dtype(a.dtype).name])
    return shard_params(_map(to_torch, np_params), cfg, tp)
