"""Serving path of the dense, moe, ssm and hybrid families: prefill (build
caches) and single-token decode, on stacked tensor-parallel ranks.

Caches carry a leading layer axis.  The dense and moe families' are
``KVCache(k (L, P, B, S_shard, KV, hd), ...)`` in layer order
(:func:`repro_torch.models.transformer.attention_layers`: under
local/global attention each block's local layers, its global layer, then
the trailing layers; in the moe family the dense head, then the MoE
layers; all sharing one length; the JAX package nests them as
``{"blocks": {"local", "global"}, "trailing"}`` and ``{"dense",
"moe"}``); under MLA (deepseek-v3) they are the compressed latents,
``MLACache(ckv (L, P, B, S_shard, kv_lora_rank), k_rope (L, P, B, S_shard,
rope_dim), ...)``, in the same layer order.  Every cache is
**sequence-sharded over the model axis**: row ``p`` holds positions
``[p·S_shard, (p+1)·S_shard)`` of every layer, and decode's partial
attention combines via two small ACCL-X all-reduces (the LSE trick).  The
ssm family's are ``SSMState(conv (L, P, B, W-1, d_inner_local), h (L, P,
B, local_heads, state, head_dim) f32)``: a fixed size, whatever the
sequence length, sharded over heads when they divide.  The hybrid family's
(zamba2) are ``HybridCache(ssm, attn)``: every Mamba2 layer's
``SSMState`` in layer order (``(L, P, B, ...)``: each group's ``k``
layers, then the trailing ones) and one sequence-sharded ``KVCache`` per
run of the shared attention block (``(n_groups, P, B, S_shard, KV,
hd)``), sharing the state's one length.  The JAX package nests the same
tensors as ``{"groups": {"ssm": SSMState (n_groups, k, B, ...), "attn":
KVCache (n_groups, B, S, ...)}, "trailing": SSMState (n_trailing, B,
...)}``: its ``groups/ssm`` leaves are ``ssm[:n_groups·k]`` reshaped
``(n_groups, k, ...)``, its ``trailing`` leaves ``ssm[n_groups·k:]``.

Unlike the JAX package's functional update, :func:`prefill` and
:func:`decode_step` write into a state's buffers (the caches, the last
logits and the cache position) and return it: the state passed to a
decode step is consumed.  ``ServeState.length`` (and the caches'
``length``, the same tensor) is a 0-d long tensor on the device, as the
JAX package's is a traced scalar, and both functions set it on the
device: a step reads nothing on the host, so it can be captured as one
CUDA graph whose static state is the one it writes
(:mod:`repro_torch.train.serve`).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.models import attention, layers, mla, moe, ssm
from repro_torch.models.common import ModelConfig, Runtime
from repro_torch.models.transformer import (attention_layers, hybrid_counts,
                                            positions_for,
                                            require_ported_family,
                                            shared_input, ssm_layers)


class HybridCache(NamedTuple):
    """The hybrid family's caches: every Mamba2 layer's state in layer
    order and the shared attention block's KV cache of each group."""
    ssm: ssm.SSMState         # conv, h: (L, P, B, ...)
    attn: attention.KVCache   # k, v: (n_groups, P, B, S_shard, KV, hd)


class ServeState(NamedTuple):
    # leading layer axis on every leaf: the KV caches (dense, moe), the
    # latent caches (MLA), the stacked SSM state (ssm) or both (hybrid)
    caches: Union[attention.KVCache, mla.MLACache, ssm.SSMState,
                  HybridCache]
    last_logits: torch.Tensor     # (P, B, V/tp) vocab-sharded, f32
    length: torch.Tensor          # 0-d long, on the device


def layer_cache(caches, i: int):
    """Layer ``i``'s view of the stacked KV or latent caches (writes go
    through)."""
    if isinstance(caches, mla.MLACache):
        return mla.MLACache(ckv=caches.ckv[i], k_rope=caches.k_rope[i],
                            length=caches.length)
    return attention.KVCache(k=caches.k[i], v=caches.v[i],
                             length=caches.length)


def _ffn(p, x, rt: Runtime):
    """The layer's feed-forward on ``x``: its MoE block (the load-balance
    loss dropped) or its MLP."""
    h = layers.rms_norm(x, p["ln2"], rt.cfg.norm_eps)
    if "moe" in p:
        return x + moe.moe_block(p["moe"], h, rt)[0]
    return x + layers.mlp(p["mlp"], h, rt, rt.cfg.mlp_type)


def _prefill_layer(p, x, positions, rt: Runtime, cache, window=None):
    h = layers.rms_norm(x, p["ln1"], rt.cfg.norm_eps)
    if rt.cfg.use_mla:
        a, (ckv, k_rope) = mla.mla_attention(p["attn"], h, positions, rt,
                                             return_latents=True)
        x = _ffn(p, x + a, rt)
        mla.mla_prefill_cache(cache, ckv, k_rope, rt)
        return x
    a, (k, v) = attention.attention(p["attn"], h, positions, rt,
                                    window=window, return_kv=True)
    x = _ffn(p, x + a, rt)
    attention.prefill_into_cache(cache, k, v, rt)
    return x


def _decode_layer(p, x, cache, rt: Runtime, window=None):
    h = layers.rms_norm(x, p["ln1"], rt.cfg.norm_eps)
    if rt.cfg.use_mla:
        a, cache = mla.mla_decode(p["attn"], h, cache, rt)
    else:
        a, cache = attention.decode_attention(p["attn"], h, cache, rt,
                                              window=window)
    return _ffn(p, x + a, rt), cache


def _ssm_walk(params, x, rt: Runtime, step):
    """Every Mamba2 layer in layer order through ``step(p, h, i)`` (which
    writes layer ``i``'s state), and in the hybrid family the shared block
    through ``step(None, h, g)`` after each group ``g``: the new hidden
    state."""
    cfg = rt.cfg
    k = cfg.hybrid_attn_every
    shared_after = ({g * k + k - 1: g for g in range(hybrid_counts(cfg)[0])}
                    if cfg.family == "hybrid" else {})
    for i, p in enumerate(ssm_layers(params, cfg)):
        x = step(p, x, i)
        if i in shared_after:
            x = step(None, x, shared_after[i])
    return x


def init_state(params, rt: Runtime, batch: int, max_len: int,
               device=None) -> ServeState:
    """A zero state of ``batch`` sequences with caches of ``max_len``
    positions (the KV and latent caches; the ssm family's state has a
    fixed size, and the hybrid family's KV caches take ``max_len``), on
    ``device`` (the parameters' by default): buffers a prefill's ``out=``
    writes into."""
    cfg = rt.cfg
    dev = params["final_norm"].device if device is None else device
    if cfg.family == "ssm":
        caches = ssm.init_ssm_state(cfg, batch, rt.mesh.tp, dev,
                                    cfg.n_layers)
    elif cfg.family == "hybrid":
        caches = init_hybrid_cache(cfg, batch, max_len, rt.sp_size,
                                   rt.mesh.tp, dev)
    elif cfg.use_mla:
        caches = mla.init_mla_cache(cfg, batch, max_len, rt.sp_size,
                                    cfg.dtype, rt.mesh.tp, dev, cfg.n_layers)
    else:
        caches = attention.init_kv_cache(cfg, batch, max_len, rt.sp_size,
                                         cfg.dtype, rt.mesh.tp, dev,
                                         cfg.n_layers)
    length = torch.zeros((), dtype=torch.long, device=dev)
    if cfg.family == "hybrid":
        caches = caches._replace(attn=caches.attn._replace(length=length))
    elif cfg.family != "ssm":
        caches = caches._replace(length=length)     # one tensor for both
    table = params["embed"]["table"]
    return ServeState(
        caches=caches,
        last_logits=torch.zeros((rt.mesh.tp, batch, table.shape[1]),
                                dtype=torch.float32, device=dev),
        length=length)


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int,
                      n_shards: int, tp: int, device) -> HybridCache:
    """Zero hybrid caches: ``cfg.n_layers`` Mamba2 states and one KV cache
    of ``max_len`` positions (cut into ``n_shards`` sequence shards) a
    group, with a length of their own (:func:`init_state` shares the
    state's)."""
    return HybridCache(
        ssm=ssm.init_ssm_state(cfg, batch, tp, device, cfg.n_layers),
        attn=attention.init_kv_cache(cfg, batch, max_len, n_shards,
                                     cfg.dtype, tp, device,
                                     hybrid_counts(cfg)[0]))


def _store(state: ServeState, last: torch.Tensor, length: torch.Tensor
           ) -> ServeState:
    state.last_logits.copy_(last)
    state.length.copy_(length)
    c = state.caches
    if isinstance(c, HybridCache):
        c = c.attn
    if not isinstance(c, ssm.SSMState) and c.length is not state.length:
        c.length.copy_(length)
    return state


def prefill(params, batch: dict, rt: Runtime, max_len: int,
            out: ServeState | None = None) -> ServeState:
    """Prefill ``batch["tokens"] (B, S)`` into caches of ``max_len``
    positions (the ssm family's state has a fixed size and ignores
    ``max_len``); ``last_logits`` are the last position's.  The hybrid
    family's shared block reads the prompt's embedding beside each group's
    output.  The result is written into ``out`` (:func:`init_state`'s
    shapes; a new state when None), which is returned."""
    cfg = rt.cfg
    require_ported_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    if out is None:
        out = init_state(params, rt, B, max_len)
    caches = out.caches
    x = layers.embed(params["embed"], tokens, rt)
    if cfg.family in ("ssm", "hybrid"):
        states = caches.ssm if cfg.family == "hybrid" else caches
        positions, x_embed = positions_for(tokens), x

        def step(p, h, i):
            if p is None:       # the shared block after group i
                sp = params["shared_attn"]
                return h + _prefill_layer(
                    sp["block"], shared_input(sp, h, x_embed), positions,
                    rt, layer_cache(caches.attn, i))
            y, (conv, hstate) = ssm.ssm_forward(
                p["ssm"], layers.rms_norm(h, p["ln"], cfg.norm_eps), rt,
                return_state=True)
            states.conv[i].copy_(conv)
            states.h[i].copy_(hstate)
            return h + y
        x = _ssm_walk(params, x, rt, step)
    else:
        positions = positions_for(tokens)
        for i, (p, window) in enumerate(attention_layers(params, cfg)):
            x = _prefill_layer(p, x, positions, rt, layer_cache(caches, i),
                               window)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = layers.logits_shard(params["embed"], x[:, :, -1], rt)
    return _store(out, last, torch.full((), S, dtype=torch.long,
                                        device=x.device))


def decode_step(params, token: torch.Tensor, state: ServeState, rt: Runtime
                ) -> ServeState:
    """token: (B,) — append one token (its K/V, or the new SSM state, or
    both in the hybrid family, whose shared block reads the token's
    embedding, into the caches; the logits and the advanced length into
    ``last_logits`` and ``length``), all in ``state``'s buffers, and return
    ``state``."""
    cfg = rt.cfg
    require_ported_family(cfg)
    x = layers.embed(params["embed"], token[:, None], rt)
    caches = state.caches
    if cfg.family in ("ssm", "hybrid"):
        states = caches.ssm if cfg.family == "hybrid" else caches
        x_embed = x

        def step(p, h, i):
            if p is None:       # the shared block after group i
                sp = params["shared_attn"]
                return h + _decode_layer(
                    sp["block"], shared_input(sp, h, x_embed),
                    layer_cache(caches.attn, i), rt)[0]
            y, new = ssm.ssm_decode(
                p["ssm"], layers.rms_norm(h, p["ln"], cfg.norm_eps),
                ssm.SSMState(conv=states.conv[i], h=states.h[i]), rt)
            states.conv[i].copy_(new.conv)
            states.h[i].copy_(new.h)
            return h + y
        x = _ssm_walk(params, x, rt, step)
    else:
        for i, (p, window) in enumerate(attention_layers(params, cfg)):
            x, _ = _decode_layer(p, x, layer_cache(caches, i), rt, window)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.logits_shard(params["embed"], x[:, :, -1], rt)
    return _store(state, logits, state.length + 1)


def greedy_tokens(state: ServeState, rt: Runtime) -> torch.Tensor:
    """The next tokens ``(B,)`` int32: greedy sampling over the
    vocab-sharded logits (every rank agrees; row 0 is returned)."""
    return layers.greedy_sample_vocab_sharded(state.last_logits, rt)[0]
