"""Attention — GQA with TP prefill and sequence-parallel decode, on stacked
ranks.

Parallel layouts (as in the JAX package):

- **Prefill**: q heads sharded over the ``model`` axis when divisible; kv
  heads sharded too when ``n_kv_heads % tp == 0``, else computed replicated
  and each rank slices the kv group its q heads need.  The core attention
  is the flash kernel (:mod:`repro_torch.kernels.flash_attention`): the
  CUDA kernel on the card, its plain version on the CPU.
- **Decode**: the KV cache is sharded over the ``model`` axis along the
  *sequence* dimension.  Every rank attends its slice of the timeline for
  all heads and the partials combine with a log-sum-exp reduction: two
  ACCL-X all-reduces per layer (a max, then one sum over ``[s, o]``).

Stacked layout: ``x (P, B, S, D)`` with P the tensor-parallel ranks; the
per-rank kv-group slice and the per-rank cache slices take each row's rank
from ``comm.rank()``.  The JAX package's jnp paths for long sequences
(``_sdpa_dense``, ``_sdpa_tiled``) have no counterpart: the kernel's plain
version is the CPU path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, Runtime


class AttnDims(NamedTuple):
    n_heads: int          # effective (possibly zero-padded) q heads
    n_real_heads: int     # q heads carrying real weights
    n_kv: int             # global kv heads
    head_dim: int
    q_sharded: bool       # q heads sharded over tp
    kv_sharded: bool      # kv heads sharded over tp
    local_heads: int      # q heads computed on each rank
    local_kv: int         # kv heads computed on each rank


def attn_dims(cfg: ModelConfig, tp: int) -> AttnDims:
    """Resolve the TP layout for attention heads (the JAX package's rule:
    q heads padded with zero-weight heads when ``n_heads % tp != 0`` and
    the padded grouping stays GQA-valid; otherwise replicated compute)."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    h_eff = cfg.padded_heads or H
    kv_sharded = KV > 0 and KV % tp == 0 and tp > 1
    if tp == 1 or KV == 0:
        return AttnDims(h_eff, H, KV, hd, False, False, h_eff, KV)
    if h_eff % tp == 0 and cfg.shard_attn != "replicate":
        local = h_eff // tp
        group = h_eff // KV
        if h_eff % KV == 0 and (group % local == 0 or local % group == 0):
            return AttnDims(h_eff, H, KV, hd, True, kv_sharded, local,
                            KV // tp if kv_sharded else KV)
    return AttnDims(h_eff, H, KV, hd, False, False, h_eff, KV)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                   tp: int = 1):
    """Full (unsharded) parameter arrays; ``sharding.shard_params`` cuts
    them.  Zero-padded head columns/rows are part of the stored arrays."""
    hd = cfg.resolved_head_dim
    dims = attn_dims(cfg, tp)
    wq = layers.dense_init(gen, cfg.d_model, dims.n_real_heads * hd, dtype,
                           device)
    wk = layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                           device)
    wv = layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                           device)
    wo = layers.dense_init(gen, dims.n_real_heads * hd, cfg.d_model, dtype,
                           device)
    pad = (dims.n_heads - dims.n_real_heads) * hd
    if pad:
        wq = F.pad(wq, (0, pad))
        wo = F.pad(wo, (0, 0, 0, pad))
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _sdpa(q, k, v, softcap: Optional[float], causal: bool,
          window: Optional[int]):
    """q (P, B, S, H, hd), k (P, B, T, KV, hd), v (P, B, T, KV, hd_v) ->
    (P, B, S, H, hd_v): the flash kernel on (P·B, ...)."""
    P, B = q.shape[:2]
    out = fa_ops.flash_attention(
        q.reshape(P * B, *q.shape[2:]), k.reshape(P * B, *k.shape[2:]),
        v.reshape(P * B, *v.shape[2:]), causal=causal, window=window,
        softcap=softcap)
    return out.reshape(q.shape[:-1] + v.shape[-1:])


def _zero_padded_heads(out: torch.Tensor, dims: AttnDims, rt: Runtime
                       ) -> torch.Tensor:
    """Zero the zero-weight padded q heads' outputs ``(P, B, S, heads,
    hd)``, each row's heads being its shard's (or all heads): the values
    they add through wo's zero rows are nothing either way, but wo's pad
    rows then get exactly zero gradient and stay zero in training, as in
    the JAX package."""
    if dims.n_heads == dims.n_real_heads:
        return out
    P, heads = out.shape[0], out.shape[3]
    gidx = torch.arange(heads, device=out.device).expand(P, heads)
    if heads != dims.n_heads:
        gidx = gidx + layers.rank_index(rt, out.device).view(P, 1) * heads
    keep = (gidx < dims.n_real_heads).to(out.dtype)
    return out * keep.view(P, 1, 1, heads, 1)


def attention(params, x: torch.Tensor, positions: torch.Tensor, rt: Runtime,
              window: Optional[int] = None, causal: Optional[bool] = None,
              return_kv: bool = False, sp: bool = False):
    """Full self-attention (training, prefill).  x: (P, B, S, D)
    replicated; positions (B, S).

    ``return_kv`` additionally returns post-rope full-head (P, B, S, KV, hd)
    k/v for cache construction (all-gathered if kv was TP-sharded).
    Returns (P, B, S, D) replicated (row-parallel combine via ACCL-X).
    ``sp=True`` (Megatron-SP): x arrives and the result leaves
    sequence-sharded, (P, B, S/tp, D); all-gather in, reduce-scatter out,
    so the kernel sees the same full-sequence, head-sharded shapes."""
    cfg, mesh = rt.cfg, rt.mesh
    dims = attn_dims(cfg, mesh.tp)
    causal = cfg.causal if causal is None else causal
    hd = dims.head_dim

    if sp and dims.q_sharded:
        # the all-gather's backward performs the f operator's sum
        x = layers.sp_all_gather(x, rt)
    else:
        x = layers.tp_grad_sum(x, rt, dims.q_sharded)
    P, B, S, _ = x.shape
    q = layers.col_parallel(x, params["wq"]).reshape(P, B, S, -1, hd)
    k = layers.col_parallel(x, params["wk"]).reshape(P, B, S, -1, hd)
    v = layers.col_parallel(x, params["wv"]).reshape(P, B, S, -1, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    kv_full = None
    if return_kv:
        if dims.kv_sharded:
            kv_full = (collectives.all_gather(k, rt.tp_comm(), rt.comm,
                                              axis=2),
                       collectives.all_gather(v, rt.tp_comm(), rt.comm,
                                              axis=2))
        else:
            kv_full = (k, v)

    if dims.q_sharded and not dims.kv_sharded:
        # KV computed replicated; each rank slices the kv heads its q group
        # needs.
        group = dims.n_heads // dims.n_kv
        n_need = max(1, dims.local_heads // group)
        start = layers.rank_index(rt, x.device) * dims.local_heads // group
        k = layers.rank_slice(k, start, n_need, dim=2)
        v = layers.rank_slice(v, start, n_need, dim=2)

    out = _sdpa(q, k, v, cfg.attn_logit_softcap, causal, window)
    out = _zero_padded_heads(out, dims, rt)
    out = out.reshape(P, B, S, -1)
    if dims.q_sharded and sp:
        y = layers.sp_reduce_scatter(layers.matmul_f32(out, params["wo"]),
                                     rt).to(x.dtype)
    elif dims.q_sharded:
        y = layers.row_parallel(out, params["wo"], rt)
    else:
        # replicated attention: wo applied fully on every rank, no combine
        y = layers.rank_matmul(out, params["wo"])
    if return_kv:
        return y, kv_full
    return y


# ----------------------------------------------------------------------
# Decode with sequence-sharded KV cache (SP decode + LSE combine)
# ----------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (P, B, S_shard, KV, hd): row p's slice of time
    v: torch.Tensor
    length: torch.Tensor  # 0-d long on the cache's device: global tokens
                          # already in the cache

    @property
    def seq_shard(self) -> int:
        return self.k.shape[2]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_shards: int,
                  dtype, tp: int, device, n_layers: int) -> KVCache:
    """Zero caches of ``max_len`` positions cut into ``n_shards`` sequence
    shards, for ``n_layers`` layers: ``(L, P, B, S_shard, KV, hd)``."""
    shard_len = max(1, -(-max_len // n_shards))
    shape = (n_layers, tp, batch, shard_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.long, device=device))


def _sp_shards(rt: Runtime, device) -> torch.Tensor:
    """Every row's shard of the decode timeline: ``(P,)``."""
    if rt.sp_size > 1:
        return rt.sp_comm().rank(device)
    return torch.zeros(rt.mesh.tp, dtype=torch.long, device=device)


def scatter_into_shards(pairs, rt: Runtime) -> None:
    """Scatter each full-sequence ``(P, B, S, ...)`` tensor of ``pairs``
    (``(full, buf)``), replicated, into its sequence-sharded cache buffer
    ``(P, B, L, ...)``, in place: row p keeps positions ``[shard_p·L,
    shard_p·L + L)`` (zeros past S)."""
    full0, buf0 = pairs[0]
    S, L = full0.shape[2], buf0.shape[2]
    pad = rt.sp_size * L - S
    if pad < 0:
        raise ValueError(f"a cache of {rt.sp_size} x {L} positions cannot "
                         f"hold {S} tokens")
    start = _sp_shards(rt, full0.device) * L
    for full, buf in pairs:
        if pad > 0:
            full = F.pad(full, (0, 0) * (full.dim() - 3) + (0, pad))
        buf.copy_(layers.rank_slice(full, start, L, dim=1))


def prefill_into_cache(cache: KVCache, k_full: torch.Tensor,
                       v_full: torch.Tensor, rt: Runtime) -> None:
    """Scatter full-sequence K/V (P, B, S, KV, hd), replicated, into the
    sequence-sharded cache, in place (:func:`scatter_into_shards`).  The
    caller sets the length."""
    scatter_into_shards(((k_full, cache.k), (v_full, cache.v)), rt)


def write_at_length(pairs, length: torch.Tensor, rt: Runtime) -> None:
    """Write each new ``(P, B, 1, ...)`` entry of ``pairs`` (``(new, buf
    (P, B, L, ...))``) at global position ``length``: only the row that owns
    that position writes (in place), at its local offset.

    Owner and offset are computed on the device from the length tensor, so
    the write reads nothing on the host and can be captured: every row
    writes its entry at the offset, and a row that does not own the
    position writes back the value already there (row ``p`` owns shard
    ``p``, or every row shard 0 without sequence sharding; no row once the
    cache is full)."""
    buf0 = pairs[0][1]
    P, L = buf0.shape[0], buf0.shape[2]
    owner = torch.div(length, L, rounding_mode="floor")
    if rt.sp_size == 1:
        mine = (owner == 0).expand(P)
    else:
        mine = _sp_shards(rt, buf0.device) == owner
    rows = torch.arange(P, device=buf0.device)
    offs = torch.remainder(length, L).expand(P)
    for new, buf in pairs:
        # advanced indices on dims 0 and 2: (P, B, ...) at each row's offset
        m = mine.view((P,) + (1,) * (buf.dim() - 2))
        buf[rows, :, offs] = torch.where(m, new[:, :, 0].to(buf.dtype),
                                         buf[rows, :, offs])


def append_to_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    rt: Runtime) -> KVCache:
    """Write one new (P, B, 1, KV, hd) entry at global position
    ``cache.length`` (:func:`write_at_length`)."""
    write_at_length(((k_new, cache.k), (v_new, cache.v)), cache.length, rt)
    return KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


def decode_attention(params, x: torch.Tensor, cache: KVCache, rt: Runtime,
                     window: Optional[int] = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  x: (P, B, 1, D) replicated.  Returns (P, B, 1, D)
    and the cache, updated in place (the new K/V written by its owner).

    q/k/v are projected (sharded projections all-gathered to all heads),
    each rank attends its slice of the timeline, and the partials combine
    with the LSE trick: an all-reduce max, then one all-reduce sum of the
    concatenated ``[s, o]``."""
    cfg, mesh = rt.cfg, rt.mesh
    hd = cfg.resolved_head_dim
    P, B = x.shape[:2]
    dims = attn_dims(cfg, mesh.tp)

    if dims.q_sharded:
        q_loc = layers.col_parallel(x, params["wq"]).reshape(
            P, B, 1, dims.local_heads, hd)
        q = collectives.all_gather(q_loc, rt.tp_comm(), rt.comm, axis=2)
    else:
        q = layers.rank_matmul(x, params["wq"]).reshape(P, B, 1, dims.n_heads,
                                                        hd)
    if dims.kv_sharded:
        k_loc = layers.col_parallel(x, params["wk"]).reshape(
            P, B, 1, dims.local_kv, hd)
        v_loc = layers.col_parallel(x, params["wv"]).reshape(
            P, B, 1, dims.local_kv, hd)
        k_new = collectives.all_gather(k_loc, rt.tp_comm(), rt.comm, axis=2)
        v_new = collectives.all_gather(v_loc, rt.tp_comm(), rt.comm, axis=2)
    else:
        k_new = layers.rank_matmul(x, params["wk"]).reshape(P, B, 1,
                                                            dims.n_kv, hd)
        v_new = layers.rank_matmul(x, params["wv"]).reshape(P, B, 1,
                                                            dims.n_kv, hd)

    pos = cache.length.view(1, 1).expand(B, 1)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k_new = layers.rms_norm(k_new, params["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, pos, cfg.rope_theta)
    k_new = layers.apply_rope(k_new, pos, cfg.rope_theta)
    cache = append_to_cache(cache, k_new, v_new, rt)

    # Local attention over each row's slice of the timeline.
    sp = rt.sp_size
    L = cache.seq_shard
    k_pos = (_sp_shards(rt, x.device).view(P, 1) * L
             + torch.arange(L, device=x.device))
    valid = k_pos < cache.length
    if window is not None:
        valid &= k_pos > cache.length - 1 - window
    bias = torch.where(valid, 0.0, float("-inf"))               # (P, L)

    KV = dims.n_kv
    rep = dims.n_heads // KV
    qg = q.reshape(P, B, KV, rep, hd).float()
    scores = torch.einsum("pbgrd,pbtgd->pbgrt", qg, cache.k.float())
    # tensor / tensor: on the card PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which rounds differently (torch.full
    # fills on the device: no host-to-device copy)
    scores = (scores / torch.full((), hd ** 0.5, device=x.device)
              + bias.view(P, 1, 1, 1, L))
    if cfg.attn_logit_softcap:
        c = torch.full((), cfg.attn_logit_softcap, device=x.device)
        scores = c * torch.tanh(scores / c)
    m_loc = scores.amax(dim=-1)                                 # (P,B,KV,rep)
    if sp > 1:
        m = collectives.all_reduce(m_loc, rt.sp_comm(), rt.comm, op="max")
    else:
        m = m_loc
    p = torch.exp(scores - m[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    s_loc = p.sum(dim=-1)
    o_loc = torch.einsum("pbgrt,pbtgd->pbgrd", p, cache.v.float())
    if sp > 1:
        # softmax denominator and weighted values share one sum all-reduce
        so = collectives.all_reduce(
            torch.cat([s_loc[..., None], o_loc], dim=-1), rt.sp_comm(),
            rt.comm)
        s, o = so[..., 0], so[..., 1:]
    else:
        s, o = s_loc, o_loc
    out = o / torch.clamp_min(s[..., None], 1e-30)
    out = _zero_padded_heads(out.reshape(P, B, 1, dims.n_heads, hd), dims,
                             rt)
    out = out.reshape(P, B, 1, dims.n_heads * hd).to(x.dtype)

    if dims.q_sharded:
        # row-parallel output projection: each rank takes its heads
        width = dims.local_heads * hd
        out_loc = layers.rank_slice(
            out, layers.rank_index(rt, x.device) * width, width, dim=2)
        y = layers.row_parallel(out_loc, params["wo"], rt)
    else:
        y = layers.rank_matmul(out, params["wo"])
    return y, cache
