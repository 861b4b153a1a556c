"""Serving shapes of the LM path (what ``train/serve.py`` reads)."""
from __future__ import annotations

import dataclasses


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
