"""Serving shapes of the LM path (what ``train/serve.py`` reads)."""
from __future__ import annotations

import dataclasses

from repro_torch.models import decode, ssm
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


def decode_seq_axes(shape: ShapeSpec) -> tuple:
    """KV-timeline shard axes: the model axis.  The JAX package also spans
    the data axes when the batch is smaller than the data-parallel size
    (long-context decode); on one card the data axis has size 1, so the
    batch always covers it."""
    return ("model",)


def ssm_state_abstract(cfg: ModelConfig, batch: int, tp: int,
                       n_layers: int) -> ssm.SSMState:
    """The ssm family's decode state as meta tensors (shapes and dtypes,
    no storage): ``conv (L, tp, B, W-1, d_inner_local)`` in ``cfg.dtype``
    and ``h (L, tp, B, local_heads, state, head_dim)`` f32, heads sharded
    over the stacked ranks when they divide (the JAX package's
    ``_ssm_state_abstract``)."""
    return ssm.init_ssm_state(cfg, batch, tp, "meta", n_layers)


def hybrid_state_abstract(cfg: ModelConfig, batch: int, tp: int,
                          max_len: int, n_shards: int) -> decode.HybridCache:
    """The hybrid family's decode state as meta tensors: every Mamba2
    layer's state, ``(L, tp, ...)`` as :func:`ssm_state_abstract`, and
    the shared block's sequence-sharded KV cache of each group, ``(n_groups,
    tp, B, ceil(max_len / n_shards), KV, hd)`` in ``cfg.dtype`` (the JAX
    package's ``{"groups": {"ssm", "attn"}, "trailing"}`` in layer
    order)."""
    return decode.init_hybrid_cache(cfg, batch, max_len, n_shards, tp,
                                    "meta")
