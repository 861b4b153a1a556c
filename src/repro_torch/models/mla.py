"""Multi-head Latent Attention (DeepSeek-V3), on stacked ranks.

Prefill and training compute standard multi-head attention from the
decompressed latents, on the flash kernel (q/k head dim ``qk_nope_dim +
qk_rope_dim``, v head dim ``v_head_dim``); decode caches only the
compressed latent (``kv_lora_rank + qk_rope_dim`` values a token) and uses
the absorbed-matmul form:

    score_h(t) = (q_nope_h @ W_uk_h) · c_kv(t) + q_rope_h · k_rope(t)
    out_h      = W_uv_h @ (Σ_t p_h(t) · c_kv(t))

Heads are sharded over the ``model`` axis (``w_uq``, ``w_uk``, ``w_uv``
column-parallel, ``wo`` row-parallel); the down-projections ``w_dq``,
``w_dkv``, ``w_kr`` and their norms are stored replicated and used
shard-wise, so their gradients are summed over the model axis
(:func:`repro_torch.models.sharding.grad_model_sum_mask`).  The latent cache
is sequence-sharded over the ``model`` axis like the GQA cache: each rank
attends its slice of the timeline for all heads, and the partials combine
with a max all-reduce, then one sum all-reduce of the concatenated
``[denominator | latent]``.

Stacked layout: ``x (P, B, S, D)``; where the JAX package reads
``lax.axis_index``, each row's rank comes from ``comm.rank()``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import collectives
from repro_torch.models import attention, layers
from repro_torch.models.common import ModelConfig, Runtime


def local_heads(cfg: ModelConfig, tp: int) -> int:
    if cfg.n_heads % tp:
        raise ValueError(f"MLA requires n_heads % tp == 0, got "
                         f"{cfg.n_heads} heads over tp={tp}")
    return cfg.n_heads // tp


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """Full (unsharded) arrays; ``sharding.shard_params`` cuts them."""
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim

    def dense(a, b):
        return layers.dense_init(gen, a, b, dtype, device)
    return {
        "w_dq": dense(d, cfg.q_lora_rank),
        "w_uq": dense(cfg.q_lora_rank, H * qk),
        "w_dkv": dense(d, r),
        "w_kr": dense(d, cfg.qk_rope_dim),
        "w_uk": dense(r, H * cfg.qk_nope_dim),
        "w_uv": dense(r, H * cfg.v_head_dim),
        "wo": dense(H * cfg.v_head_dim, d),
        "q_norm": torch.zeros((cfg.q_lora_rank,), dtype=dtype, device=device),
        "kv_norm": torch.zeros((r,), dtype=dtype, device=device),
    }


def _project(params, x, positions, cfg: ModelConfig, hl: int):
    """Shared q/kv projection of ``x (P, B, S, D)``: each rank's ``q_nope
    (P, B, S, hl, nope)`` and ``q_rope`` (post-rope), and the replicated
    latent ``ckv (P, B, S, kv_lora_rank)`` and shared ``k_rope (P, B, S,
    rope_dim)`` (post-rope)."""
    P, B, S, _ = x.shape
    nope = cfg.qk_nope_dim
    cq = layers.rms_norm(layers.rank_matmul(x, params["w_dq"]),
                         params["q_norm"], cfg.norm_eps)
    q = layers.col_parallel(cq, params["w_uq"]).reshape(
        P, B, S, hl, nope + cfg.qk_rope_dim)
    q_nope = q[..., :nope]
    q_rope = layers.apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv = layers.rms_norm(layers.rank_matmul(x, params["w_dkv"]),
                          params["kv_norm"], cfg.norm_eps)
    k_rope = layers.rank_matmul(x, params["w_kr"])
    k_rope = layers.apply_rope(k_rope[..., None, :], positions,
                               cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_attention(params, x: torch.Tensor, positions: torch.Tensor,
                  rt: Runtime, return_latents: bool = False):
    """Training and prefill MLA of ``x (P, B, S, D)``, replicated: heads
    sharded over tp, the flash kernel causal over ``[q_nope | q_rope]`` and
    ``[k_nope | k_rope]`` (the shared rope key broadcast to every head;
    scale ``1/sqrt(nope + rope)``) with v of ``v_head_dim``, one
    row-parallel combine -> ``(P, B, S, D)``.  ``return_latents`` also
    returns ``(ckv, k_rope)`` for the latent decode cache."""
    cfg = rt.cfg
    tp = rt.mesh.tp
    hl = local_heads(cfg, tp)
    nope, ropd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    x = layers.tp_grad_sum(x, rt, tp > 1)
    P, B, S, _ = x.shape
    q_nope, q_rope, ckv, k_rope = _project(params, x, positions, cfg, hl)
    k_nope = layers.col_parallel(ckv, params["w_uk"]).reshape(
        P, B, S, hl, nope)
    v = layers.col_parallel(ckv, params["w_uv"]).reshape(P, B, S, hl, vd)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[..., None, :].expand(P, B, S, hl,
                                                           ropd)], dim=-1)
    out = attention._sdpa(q_cat, k_cat, v, None, True, None)
    out = out.reshape(P, B, S, hl * vd).to(x.dtype)
    y = layers.row_parallel(out, params["wo"], rt)
    if return_latents:
        return y, (ckv, k_rope)
    return y


class MLACache(NamedTuple):
    ckv: torch.Tensor     # (P, B, S_shard, kv_lora_rank): row p's slice of
                          # time; (L, P, ...) in a serving state
    k_rope: torch.Tensor  # (P, B, S_shard, rope_dim)
    length: torch.Tensor  # 0-d long on the cache's device: global tokens
                          # already in the cache

    @property
    def seq_shard(self) -> int:
        return self.ckv.shape[-2]


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   n_shards: int, dtype, tp: int, device,
                   n_layers: int) -> MLACache:
    """Zero latent caches of ``max_len`` positions cut into ``n_shards``
    sequence shards, for ``n_layers`` layers: ``ckv (L, P, B, S_shard,
    kv_lora_rank)`` and ``k_rope (L, P, B, S_shard, rope_dim)``."""
    shard_len = max(1, -(-max_len // n_shards))
    lead = (n_layers, tp, batch, shard_len)
    return MLACache(
        ckv=torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                        device=device),
        k_rope=torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dtype,
                           device=device),
        length=torch.zeros((), dtype=torch.long, device=device))


def mla_prefill_cache(cache: MLACache, ckv: torch.Tensor,
                      k_rope: torch.Tensor, rt: Runtime) -> None:
    """Scatter the full-sequence latents ``(P, B, S, ·)``, replicated, into
    the sequence-sharded cache (a layer's view), in place.  The caller sets
    the length."""
    attention.scatter_into_shards(((ckv, cache.ckv), (k_rope, cache.k_rope)),
                                  rt)


def mla_decode(params, x: torch.Tensor, cache: MLACache, rt: Runtime
               ) -> tuple[torch.Tensor, MLACache]:
    """One decode step with the absorbed latent cache.  ``x (P, B, 1, D)``
    replicated -> ``(P, B, 1, D)`` and the cache, the new latent written by
    its owner (in place) and the length advanced.  Nothing is read on the
    host: the step can be captured."""
    cfg = rt.cfg
    tp = rt.mesh.tp
    hl = local_heads(cfg, tp)
    P, B = x.shape[:2]
    nope, ropd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank

    pos = cache.length.view(1, 1).expand(B, 1)
    q_nope, q_rope, ckv_new, kr_new = _project(params, x, pos, cfg, hl)
    attention.write_at_length(((ckv_new, cache.ckv), (kr_new, cache.k_rope)),
                              cache.length, rt)
    cache = MLACache(ckv=cache.ckv, k_rope=cache.k_rope,
                     length=cache.length + 1)

    # Absorb W_uk into q: q_abs (P, B, hl, r); every rank needs all heads.
    w_uk = params["w_uk"].reshape(P, r, hl, nope)
    q_abs = torch.einsum("pbhd,prhd->pbhr", q_nope[:, :, 0].float(),
                         w_uk.float())
    qr = q_rope[:, :, 0].float()
    if tp > 1:
        q_abs = collectives.all_gather(q_abs, rt.tp_comm(), rt.comm, axis=1)
        qr = collectives.all_gather(qr, rt.tp_comm(), rt.comm, axis=1)

    # Local attention over each row's slice of the timeline.
    sp = rt.sp_size
    L = cache.seq_shard
    k_pos = (attention._sp_shards(rt, x.device).view(P, 1) * L
             + torch.arange(L, device=x.device))
    bias = torch.where(k_pos < cache.length, 0.0, float("-inf"))  # (P, L)
    ckv = cache.ckv.float()
    s = (torch.einsum("pbhr,pbtr->pbht", q_abs, ckv)
         + torch.einsum("pbhd,pbtd->pbht", qr, cache.k_rope.float())
         ) * (1.0 / (nope + ropd) ** 0.5) + bias.view(P, 1, 1, L)
    m_loc = s.amax(dim=-1)
    m = (collectives.all_reduce(m_loc, rt.sp_comm(), rt.comm, op="max")
         if sp > 1 else m_loc)
    p = torch.where(torch.isfinite(s), torch.exp(s - m[..., None]), 0.0)
    s_loc = p.sum(dim=-1)
    lat_loc = torch.einsum("pbht,pbtr->pbhr", p, ckv)
    if sp > 1:
        # the denominator and the latent partials ride one sum all-reduce
        dl = collectives.all_reduce(
            torch.cat([s_loc[..., None], lat_loc], dim=-1), rt.sp_comm(),
            rt.comm)
        denom, lat = dl[..., 0], dl[..., 1:]
    else:
        denom, lat = s_loc, lat_loc
    lat = lat / torch.clamp_min(denom[..., None], 1e-30)       # (P, B, H, r)

    # Decompress with each rank's own W_uv heads; combine row-parallel.
    if tp > 1:
        lat = layers.rank_slice(lat, layers.rank_index(rt, x.device) * hl,
                                hl, dim=1)
    w_uv = params["w_uv"].reshape(P, r, hl, vd)
    o = torch.einsum("pbhr,prhv->pbhv", lat, w_uv.float())
    o = o.reshape(P, B, 1, hl * vd).to(x.dtype)
    return layers.row_parallel(o, params["wo"], rt), cache
