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
                  seed: int = 0, device=None, tune_db_path=None,
                  objective: str = "latency") -> Session:
    """Initialise ``cfg``'s parameters from ``seed`` on the device (the card
    unless ``device`` names another) as stacked per-rank shards over ``tp``
    ranks.

    ``comm="auto"`` asks the autotuner for the fastest measured config for
    the LM path's dominant collective — the per-layer row-parallel TP
    combine, a (tokens, d_model) f32 partial sum at a nominal 1K-token
    microbatch — on ``tp`` ranks of the device's platform, falling back to
    ``OPTIMIZED_CONFIG`` on a cold TuneDB.  ``objective="e2e"`` ranks by
    the measured ``row_parallel`` consumer-loop time."""
    dev = resolve_device(device)
    if not isinstance(comm, CommConfig):
        from repro_torch.core.collectives import resolve_config
        comm = resolve_config(comm, "all_reduce", 4 * cfg.d_model * 1024,
                              n_ranks=tp, db_path=tune_db_path,
                              objective=objective, consumer="row_parallel",
                              device=dev)
    params = sharding.shard_params(transformer.init_model(seed, cfg, tp, dev),
                                   cfg, tp)
    rt = Runtime(cfg=cfg, mesh=MeshContext.stacked(tp), comm=comm)
    return Session(cfg=cfg, tp=tp, rt=rt, params=params)
