"""Serving path of the dense family: prefill (build caches) and
single-token decode, on stacked tensor-parallel ranks.

Caches carry a leading layer axis, ``KVCache(k (L, P, B, S_shard, KV,
hd), ...)``, and every cache is **sequence-sharded over the model axis**:
row ``p`` holds positions ``[p·S_shard, (p+1)·S_shard)`` of every layer,
and decode's partial attention combines via two small ACCL-X all-reduces
(the LSE trick).

Unlike the JAX package's functional update, :func:`decode_step` writes the
new token's K/V into the caches it is given (in place) and returns a state
that shares them: the state passed in is consumed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention, layers
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import (_require_dense, layer_params,
                                            positions_for)


class ServeState(NamedTuple):
    caches: attention.KVCache     # leading layer axis on k and v
    last_logits: torch.Tensor     # (P, B, V/tp) vocab-sharded, f32
    length: int


def layer_cache(caches: attention.KVCache, i: int) -> attention.KVCache:
    """Layer ``i``'s view of the stacked caches (writes go through)."""
    return attention.KVCache(k=caches.k[i], v=caches.v[i],
                             length=caches.length)


def _prefill_dense(p, x, positions, rt: Runtime, cache, window=None):
    cfg = rt.cfg
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, (k, v) = attention.attention(p["attn"], h, positions, rt,
                                    window=window, return_kv=True)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + layers.mlp(p["mlp"], h, rt, cfg.mlp_type)
    attention.prefill_into_cache(cache, k, v, rt)
    return x


def _decode_dense(p, x, cache, rt: Runtime, window=None):
    cfg = rt.cfg
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attention.decode_attention(p["attn"], h, cache, rt,
                                          window=window)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + layers.mlp(p["mlp"], h, rt, cfg.mlp_type)
    return x, cache


def prefill(params, batch: dict, rt: Runtime, max_len: int) -> ServeState:
    """Prefill ``batch["tokens"] (B, S)`` into caches of ``max_len``
    positions; ``last_logits`` are the last position's."""
    cfg = rt.cfg
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens, rt)
    positions = positions_for(tokens)
    caches = attention.init_kv_cache(cfg, B, max_len, rt.sp_size, cfg.dtype,
                                     rt.mesh.tp, x.device, cfg.n_layers)
    for i in range(cfg.n_layers):
        x = _prefill_dense(layer_params(params["layers"], i), x, positions,
                           rt, layer_cache(caches, i), cfg.sliding_window)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = layers.logits_shard(params["embed"], x[:, :, -1], rt)
    return ServeState(caches=caches._replace(length=S), last_logits=last,
                      length=S)


def decode_step(params, token: torch.Tensor, state: ServeState, rt: Runtime
                ) -> ServeState:
    """token: (B,) — append one token (its K/V written into the caches in
    place), return the updated state."""
    cfg = rt.cfg
    _require_dense(cfg)
    x = layers.embed(params["embed"], token[:, None], rt)
    caches = state.caches
    for i in range(cfg.n_layers):
        x, _ = _decode_dense(layer_params(params["layers"], i), x,
                             layer_cache(caches, i), rt, cfg.sliding_window)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.logits_shard(params["embed"], x[:, :, -1], rt)
    length = state.length + 1
    return ServeState(caches=caches._replace(length=length),
                      last_logits=logits, length=length)


def greedy_tokens(state: ServeState, rt: Runtime) -> torch.Tensor:
    """The next tokens ``(B,)`` int32: greedy sampling over the
    vocab-sharded logits (every rank agrees; row 0 is returned)."""
    return layers.greedy_sample_vocab_sharded(state.last_logits, rt)[0]
