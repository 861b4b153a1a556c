"""Serving shapes of the LM path (what ``train/serve.py`` reads)."""
from __future__ import annotations

import dataclasses

from repro_torch.models import ssm
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
