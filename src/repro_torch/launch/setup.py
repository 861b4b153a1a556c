"""Launcher glue: build a serving session (config, runtime, parameters on
the device) for a stacked ``(data=1, model=tp)`` mesh.

The JAX package's session also carries optimizer state and the training
step's shardings; those come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.config import CommConfig
from repro_torch.device import resolve_device
from repro_torch.models import sharding, transformer
from repro_torch.models.common import MeshContext, ModelConfig, Runtime


@dataclasses.dataclass
class Session:
    cfg: ModelConfig
    tp: int
    rt: Runtime
    params: Any


def build_session(cfg: ModelConfig, tp: int, comm: CommConfig | str,
                  seed: int = 0, device=None) -> Session:
    """Initialise ``cfg``'s parameters from ``seed`` on the device (the card
    unless ``device`` names another) as stacked per-rank shards over ``tp``
    ranks.  ``comm="auto"`` is not ported yet (ROADMAP.md Queue 1 item 8:
    the sweep has no LM consumer loops)."""
    if not isinstance(comm, CommConfig):
        raise NotImplementedError(
            f"comm={comm!r}: autotuned serving needs the sweep's prefill and "
            f"decode_step consumers, which the port does not have yet "
            f"(ROADMAP.md Queue 1 item 8); pass a CommConfig")
    dev = resolve_device(device)
    params = sharding.shard_params(transformer.init_model(seed, cfg, tp, dev),
                                   cfg, tp)
    rt = Runtime(cfg=cfg, mesh=MeshContext.stacked(tp), comm=comm)
    return Session(cfg=cfg, tp=tp, rt=rt, params=params)
