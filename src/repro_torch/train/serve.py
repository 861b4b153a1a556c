"""Serving entry points: prefill and decode_step builders on stacked
tensor-parallel ranks.

Used by ``examples/serve_lm_torch.py`` (continuous-batching serving with
greedy sampling), ``chip_smoke.py`` and the tests.  The builders take a
concrete ``CommConfig``; the JAX package's ``comm="auto"`` (a per-phase
TuneDB selection) needs the sweep's ``prefill`` and ``decode_step``
consumer loops, which the port does not have yet, and raises here.
"""
from __future__ import annotations

import torch

from repro_torch.core.config import CommConfig
from repro_torch.device import resolve_device
from repro_torch.launch import input_specs as isp
from repro_torch.models import decode as dec
from repro_torch.models.common import MeshContext, ModelConfig, Runtime

# Which sweep consumer loop stands in for each serving phase under
# ``comm="auto"`` (not ported yet).
PHASE_CONSUMERS = {"prefill": "prefill", "decode": "decode_step"}


def cache_len(cfg: ModelConfig, shape: isp.ShapeSpec) -> int:
    if cfg.family == "vlm":
        return shape.seq_len + cfg.num_patches
    return shape.seq_len


def serve_msg_bytes(cfg: ModelConfig, shape: isp.ShapeSpec) -> int:
    """Dominant TP-collective message size of a serving phase (bytes):
    both phases' per-layer combine carries (tokens, d_model) f32
    partials."""
    tokens = shape.global_batch
    if shape.kind == "prefill":
        tokens *= shape.seq_len
    return 4 * cfg.d_model * tokens


def serve_runtime(cfg: ModelConfig, tp: int, comm,
                  shape: isp.ShapeSpec) -> Runtime:
    if not isinstance(comm, CommConfig):
        raise NotImplementedError(
            f"comm={comm!r}: per-phase autotuned serving needs the sweep's "
            f"{PHASE_CONSUMERS.get(shape.kind, 'decode_step')!r} consumer "
            f"loop, which the port does not have yet (ROADMAP.md Queue 1 "
            f"item 8); pass a CommConfig")
    return Runtime(cfg=cfg, mesh=MeshContext.stacked(tp), comm=comm,
                   seq_axes=isp.decode_seq_axes(shape))


def _tokens(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.long, device=device)


def build_serve_fn(cfg: ModelConfig, tp: int, comm, shape: isp.ShapeSpec,
                   cache_capacity: int | None = None, device=None):
    """Returns ``(rt, fn)`` for serving on ``tp`` stacked ranks on the
    device (the card unless ``device`` names another):

    - prefill kind: ``fn(params, batch) -> ServeState``, ``batch["tokens"]``
      of exactly ``(global_batch, seq_len)``;
    - decode kind: ``fn(params, token, state) -> ServeState``, ``token``
      ``(global_batch,)``, on caches of ``cache_len(cfg, shape)`` positions
      (dense) or on the fixed-size SSM state (ssm), updated in place.

    ``cache_capacity`` (prefill only) decouples the KV-cache capacity from
    the prompt length: the caches a prefill returns cover
    ``cache_capacity`` positions (prompt + planned generation).  Defaults
    to ``cache_len(cfg, shape)``.  The ssm family's state does not depend
    on it, as in the JAX package's prefill."""
    rt = serve_runtime(cfg, tp, comm, shape)
    dev = resolve_device(device)
    B = shape.global_batch

    if shape.kind == "prefill":
        min_len = cache_len(cfg, shape)
        max_len = cache_capacity if cache_capacity is not None else min_len
        if max_len < min_len:
            raise ValueError(
                f"cache_capacity={max_len} is smaller than the prefill "
                f"shape needs ({min_len}: prompt"
                + (" + patch prefix" if cfg.family == "vlm" else "") + ")")

        def prefill_fn(params, batch):
            tokens = _tokens(batch["tokens"], dev)
            if tuple(tokens.shape) != (B, shape.seq_len):
                raise ValueError(f"prefill built for tokens of "
                                 f"{(B, shape.seq_len)}, got "
                                 f"{tuple(tokens.shape)}")
            return dec.prefill(params, {"tokens": tokens}, rt, max_len)
        return rt, prefill_fn

    if cache_capacity is not None:
        raise ValueError("cache_capacity applies to the prefill builder; "
                         "a decode ShapeSpec's seq_len IS the capacity")

    if cfg.family == "ssm":
        # a fixed-size state: the sequence length does not enter it
        want = isp.ssm_state_abstract(cfg, B, tp, cfg.n_layers)

        def check_caches(caches):
            for got, ref in zip(caches, want):
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    raise ValueError(
                        f"decode built for SSM states of {tuple(ref.shape)} "
                        f"{ref.dtype}, got {tuple(got.shape)} {got.dtype}")
    else:
        capacity = -(-cache_len(cfg, shape) // rt.sp_size)

        def check_caches(caches):
            if caches.k.shape[3] != capacity:
                raise ValueError(f"decode built for caches of {capacity} "
                                 f"positions per shard, got "
                                 f"{caches.k.shape[3]}")

    def decode_fn(params, token, state):
        token = _tokens(token, dev)
        if tuple(token.shape) != (B,):
            raise ValueError(f"decode built for tokens of {(B,)}, got "
                             f"{tuple(token.shape)}")
        check_caches(state.caches)
        return dec.decode_step(params, token, state, rt)
    return rt, decode_fn
