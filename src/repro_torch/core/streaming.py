"""Streaming (chunked, overlapped) communication engine — stacked-rank
backend.

Every tensor here carries the ranks of the communicator as its leading
dimension: rank ``p``'s message is ``x[p]``.  The JAX package's
``lax.ppermute(x, perm)`` becomes a gather along that dimension, and ranks
that receive nothing get **zeros**, as ``ppermute`` gives them (the halo
fold's ``recv_slot = -1`` masking relies on it).  Chunk plans are derived
from ONE rank's shape (``x.shape[1:]``), so chunk counts and boundaries are
the JAX package's.

Transport semantics (paper §3.4):

- **unordered** ("UDP"): chunk permutes are independent.
- **ordered** ("TCP"): chunk *i* may only start once chunk *i - window* has
  been delivered.  The engine issues every chunk of a message on one CUDA
  stream, in chunk order, and a stream runs its work in issue order — so
  the ack dependency of ``plans.ChunkPlan.ack_of`` holds by construction.

Reliable delivery (``Reliability.GUARANTEED`` under an injected
:class:`~repro_torch.core.reliable.WireFaults` schedule): every message asks
:func:`repro_torch.core.reliable.plan_for` for a delivery plan and, when it
gets one, executes it slot by slot (:func:`_reliable_stream`).  A clean
message, or any message outside a fault context, takes the unprotected path
and launches exactly what ``BEST_EFFORT`` launches.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.config import CommConfig, CommMode, Compression
from repro_torch.core import plans, plugins, reliable, topology
from repro_torch.obs import trace as obs_trace


def _perm_index(edges: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) index tensors of an edge list on ``device``, built once.
    Cached so that no host-to-device copy happens while a CUDA graph is
    being captured (the capture replays what a warm-up call cached)."""
    def build():
        src = torch.tensor([s for s, _ in edges], dtype=torch.long)
        dst = torch.tensor([d for _, d in edges], dtype=torch.long)
        return src.to(device), dst.to(device)
    return plans._memo("perm_index", (edges, str(device)), build,
                       pinned=True)


def _dest_mask(dests: tuple, n: int, device) -> torch.Tensor:
    """Boolean ``(n,)`` mask of a batch's destination ranks, built once."""
    def build():
        m = torch.zeros(n, dtype=torch.bool)
        m[list(dests)] = True
        return m.to(device)
    return plans._memo("dest_mask", (dests, n, str(device)), build,
                       pinned=True)


def _permute(t: torch.Tensor, edges) -> torch.Tensor:
    """One single-round permute along the rank dimension: ``out[d] = t[s]``
    for every edge ``(s, d)``, zeros on ranks that receive nothing."""
    edges = tuple((int(s), int(d)) for s, d in edges)
    out = torch.zeros_like(t)
    if edges:
        src, dst = _perm_index(edges, t.device)
        out.index_copy_(0, dst, t.index_select(0, src))
    return out


def wire_permute(t: torch.Tensor, perm) -> torch.Tensor:
    """One wire traversal of an (encoded) stacked tensor: a plain edge list
    is a single permute; a :class:`~repro_torch.core.topology.RoutedPerm`
    executes each store-and-forward batch as sequential single-hop permutes
    — intermediate ranks forward, arrived messages hold via self-edges — and
    merges batches by destination mask (a pure select).  Values are
    bitwise-identical to the direct permute."""
    if not isinstance(perm, topology.RoutedPerm):
        return _permute(t, perm)

    def run_batch(batch):
        out = t
        for rnd in batch.rounds:
            out = _permute(out, rnd)
        return out

    if len(perm.batches) == 1:
        return run_batch(perm.batches[0])
    acc = torch.zeros_like(t)
    shape = (t.shape[0],) + (1,) * (t.dim() - 1)
    for batch in perm.batches:
        out = run_batch(batch)
        is_dst = _dest_mask(batch.dests, t.shape[0], t.device).view(shape)
        acc = torch.where(is_dst, out, acc)
    return acc


def _wire(enc, perm):
    """Move an encoded payload (a tensor, or a tuple of tensors for the int8
    format) across the wire."""
    if isinstance(enc, tuple):
        return tuple(wire_permute(e, perm) for e in enc)
    return wire_permute(enc, perm)


def num_chunks(nbytes: int, cfg: CommConfig) -> int:
    return max(1, min(cfg.max_chunks, math.ceil(nbytes / cfg.chunk_bytes)))


def _per_rank_elems(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:])


def aligned_chunks(x: torch.Tensor, cfg: CommConfig, align: int = 1
                   ) -> tuple[int, int]:
    """Wire-chunk geometry for streaming one rank's ``x[p]``:
    ``(n_chunks, chunk_elems)``, with ``chunk_elems`` a multiple of
    ``align`` so a chunk never splits a logical row."""
    p = plans.chunk_plan(tuple(x.shape[1:]), x.dtype, cfg, align=align)
    return p.n_chunks, p.chunk_elems


def split_chunks(x: torch.Tensor, n: int):
    """Flatten each rank's message and split it into ``n`` equal chunks
    (zero-padded).  Returns ``(chunks (P, n, L), unsplit_fn)``."""
    P = x.shape[0]
    flat = x.reshape(P, -1)
    size = flat.shape[1]
    pad = (-size) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    chunks = flat.reshape(P, n, -1)
    shape, dtype = x.shape, x.dtype

    def unsplit(cs: torch.Tensor) -> torch.Tensor:
        return cs.reshape(P, -1)[:, :size].reshape(shape).to(dtype)

    return chunks, unsplit


def _reliable_stream(rplan, chunks, perm, cfg: CommConfig,
                     consume: Callable | None = None, init=None):
    """Execute a :class:`~repro_torch.core.reliable.DeliveryPlan`: one real
    wire round per slot, value-preserving.

    Every slot — original transmission, lost transmission, duplicate,
    backoff hold — encodes its sequence's chunk and runs a full
    :func:`_wire` permute of it, so recovery costs real permute rounds.
    Only ``DELIVER`` slots are decoded into the receiver's reassembly
    buffer; the other slots' outputs are dropped (eager PyTorch and a CUDA
    graph execute every launched permute, so no barrier is needed).  Slots
    are issued in order on one stream, which gives ordered transport's
    chain of slot *j* on slot *j - window*.

    ``consume(carry, seq, chunk)`` fires in sequence order through the
    reassembly flush: seq *i* is folded only once every seq ``<= i`` has
    been delivered, so a pipelined consumer's fold order is the lossless
    one under any wire reorder.

    ``chunks[seq]`` is sequence ``seq``'s stacked ``(P, ...)`` chunk.
    Returns ``(carry, [chunk_0, ..., chunk_{n-1}])`` in sequence order.
    """
    received: dict = {}
    carry = init
    next_flush = 0
    n_slots = len(rplan.slots)
    for j, slot in enumerate(rplan.slots):
        with obs_trace.span("wire.slot", cat="wire", slot=j, of=n_slots,
                            seq=slot.seq, action=slot.action,
                            attempt=slot.attempt):
            enc, dec = plugins.wire_encode(chunks[slot.seq], cfg)
            out = _wire(enc, perm)
            if slot.action == reliable.DELIVER:
                received[slot.seq] = dec(out)
        if consume is not None:
            while next_flush in received:
                carry = consume(carry, next_flush, received[next_flush])
                next_flush += 1
    return carry, [received[i] for i in range(rplan.n_chunks)]


def chunked_permute(x: torch.Tensor, perm: Sequence[tuple[int, int]],
                    cfg: CommConfig) -> torch.Tensor:
    """Streaming point-to-point transfer of ``x`` along ``perm``: one permute
    per wire chunk (per delivery-plan slot under a fault schedule), in the
    compression plugin's wire format."""
    plan = plans.chunk_plan(tuple(x.shape[1:]), x.dtype, cfg,
                            equal_split=True)
    n = plan.n_chunks
    chunks, unsplit = split_chunks(x, n)
    rplan = reliable.plan_for(cfg, n)
    if rplan is not None:
        _, seq_chunks = _reliable_stream(rplan, chunks.unbind(1), perm, cfg)
        return unsplit(torch.stack(seq_chunks, dim=1))
    received = []
    for i in range(n):
        payload = chunks[:, i]
        with obs_trace.span("wire.chunk", cat="wire", chunk=i, of=n,
                            elems=int(payload.shape[1]),
                            acked=int(plan.ack_of[i])):
            enc, dec = plugins.wire_encode(payload, cfg)
            received.append(dec(_wire(enc, perm)))
    return unsplit(torch.stack(received, dim=1))


def buffered_permute(x: torch.Tensor, perm: Sequence[tuple[int, int]],
                     cfg: CommConfig) -> torch.Tensor:
    """Buffered transfer: one whole-message permute, then a staging copy.

    The copy is the receive buffer in device memory — the consumer reads
    the message only after the *entire* message has landed and been staged
    (the paper's l_m term).  Under a fault schedule the message is one
    chunk: losing it costs a whole-message retransmit."""
    rplan = reliable.plan_for(cfg, 1)
    if rplan is not None:
        _, (msg,) = _reliable_stream(rplan, [x], perm, cfg)
        return msg.clone()
    with obs_trace.span("wire.message", cat="wire",
                        elems=_per_rank_elems(x)):
        enc, dec = plugins.wire_encode(x, cfg)
        out = _wire(enc, perm)
        if isinstance(out, tuple):
            out = tuple(o.clone() for o in out)
        else:
            out = out.clone()
        return dec(out)


def pipelined_consume(x: torch.Tensor, perm: Sequence[tuple[int, int]],
                      cfg: CommConfig, consume: Callable, init,
                      align: int = 1):
    """Stream ``x`` to the neighbor and fold ``consume`` over arriving wire
    chunks.

    ``consume(carry, chunk_index, chunk) -> carry`` runs on chunk *i* (the
    decoded ``(P, chunk_elems)`` chunk; the tail is zero-padded) right after
    it lands.  Chunk boundaries fall on multiples of ``align`` flat
    elements.  Returns ``(carry, received_message)``.
    """
    plan = plans.chunk_plan(tuple(x.shape[1:]), x.dtype, cfg, align=align)
    n, chunk_elems = plan.n_chunks, plan.chunk_elems
    P = x.shape[0]
    flat = x.reshape(P, -1)
    pad = n * chunk_elems - flat.shape[1]
    if pad:
        flat = F.pad(flat, (0, pad))
    chunks = flat.reshape(P, n, chunk_elems)
    rplan = reliable.plan_for(cfg, n)
    if rplan is not None:
        carry, seq_chunks = _reliable_stream(rplan, chunks.unbind(1), perm,
                                             cfg, consume=consume, init=init)
        msg = (torch.stack(seq_chunks, dim=1).reshape(P, -1)
               [:, :_per_rank_elems(x)].reshape(x.shape).to(x.dtype))
        return carry, msg
    carry = init
    received = []
    for i in range(n):
        payload = chunks[:, i]
        with obs_trace.span("wire.chunk", cat="wire", chunk=i, of=n,
                            elems=int(chunk_elems),
                            acked=int(plan.ack_of[i])):
            enc, dec = plugins.wire_encode(payload, cfg)
            r = dec(_wire(enc, perm))
            received.append(r)
            carry = consume(carry, i, r)
    msg = (torch.stack(received, dim=1).reshape(P, -1)
           [:, :_per_rank_elems(x)].reshape(x.shape).to(x.dtype))
    return carry, msg


def double_buffered_exchange(payloads: Sequence[torch.Tensor],
                             perms: Sequence[Sequence[tuple[int, int]]],
                             cfg: CommConfig,
                             consume: Callable | None = None,
                             init=None,
                             chunk_consume: Callable | None = None,
                             chunk_align: int = 1):
    """Multi-round exchange through two alternating halo buffers.

    Round ``r`` lands in buffer ``r % 2``; under ordered transport round
    ``r`` waits on round ``r - 2`` (its own buffer), which the single stream
    the rounds are issued on guarantees.  Each round's transfer is
    :func:`pipelined_consume` (streaming) or :func:`buffered_permute`
    (buffered).

    - ``consume(carry, round_index, message) -> carry`` folds each round's
      reassembled message.
    - ``chunk_consume(carry, round_index, chunk_index, chunk) -> carry``
      folds each ``chunk_align``-aligned wire chunk as it lands (streaming
      rounds only; buffered rounds still fold through ``consume``).

    Returns ``(carry, received)`` with ``received`` in round order.
    """
    carry = init
    received = []
    for r, (payload, perm) in enumerate(zip(payloads, perms)):
        hops = (perm.max_hops if isinstance(perm, topology.RoutedPerm)
                else 1)
        with obs_trace.span("round", cat="collective", round=r, buf=r % 2,
                            hops=hops, elems=_per_rank_elems(payload)):
            if cfg.mode == CommMode.STREAMING:
                if chunk_consume is not None:
                    carry, msg = pipelined_consume(
                        payload, perm, cfg,
                        lambda c, i, ch, _r=r: chunk_consume(c, _r, i, ch),
                        carry, align=chunk_align)
                else:
                    carry, msg = pipelined_consume(
                        payload, perm, cfg, lambda c, _i, _chunk: c, carry)
                    if consume is not None:
                        carry = consume(carry, r, msg)
            else:
                msg = buffered_permute(payload, perm, cfg)
                if consume is not None:
                    carry = consume(carry, r, msg)
        received.append(msg)
    return carry, received


def all_to_all_blocks(x: torch.Tensor, n: int, cfg: CommConfig,
                      split_axis: int, concat_axis: int) -> torch.Tensor:
    """One tiled all-to-all on stacked ranks (``lax.all_to_all(...,
    tiled=True)``): rank ``s`` splits its ``x[s]`` along ``split_axis`` into
    ``n`` blocks, block ``j`` goes to rank ``j``, and each rank concatenates
    what it receives along ``concat_axis`` in source order.  With the
    compression plugin on, the blocks travel in bf16 (any compression: the
    int8 format has no all-to-all)."""
    orig = x.dtype
    if cfg.compression != Compression.NONE and cfg.enable_compression_plugin:
        x = x.to(torch.bfloat16)
    nd = x.dim() - 1
    parts = x.chunk(n, dim=1 + split_axis % nd)     # parts[j][s]: s -> j
    blocks = torch.stack(parts, 0)                  # (dst, src, ...)
    return torch.cat(blocks.unbind(1), dim=1 + concat_axis % nd).to(orig)


def chunked_all_to_all(x: torch.Tensor, comm, cfg: CommConfig,
                       split_axis: int = 0, concat_axis: int = 0
                       ) -> torch.Tensor:
    """Streaming all-to-all (MoE dispatch/combine): tile a non-exchanged
    axis of each rank's message into wire chunks, one all-to-all per chunk.

    Chunks are issued in order on one stream, so ordered transport's "chunk
    *i* waits on chunk *i - window*" holds by construction.  Values are
    bitwise-identical to the single all-to-all — tiling a non-split axis
    only partitions pure data movement.  Falls back to one call when no
    tileable axis exists (1-D payloads) or the message fits one chunk."""
    n = comm.size
    nd = x.dim() - 1
    tile_axis = next((a for a in range(nd - 1, -1, -1)
                      if a not in (split_axis % nd, concat_axis % nd)), None)
    if tile_axis is None:
        return all_to_all_blocks(x, n, cfg, split_axis, concat_axis)
    nc = min(num_chunks(_per_rank_elems(x) * x.element_size(), cfg),
             x.shape[1 + tile_axis])
    if nc <= 1:
        return all_to_all_blocks(x, n, cfg, split_axis, concat_axis)
    dim = x.shape[1 + tile_axis]
    width = math.ceil(dim / nc)
    outs = []
    for start in range(0, dim, width):
        sl = x.narrow(1 + tile_axis, start, min(width, dim - start))
        outs.append(all_to_all_blocks(sl, n, cfg, split_axis, concat_axis))
    return torch.cat(outs, dim=1 + tile_axis)


# ----------------------------------------------------------------------
# Streaming tensor parallelism: the row-parallel matmul's combine
# ----------------------------------------------------------------------

def rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-rank product of stacked ``x (P, ..., K)`` and ``w (P, K, N)`` ->
    ``(P, ..., N)`` in x's dtype: one batched matmul over the rank
    dimension (fp32 accumulation, one rounding to x's dtype)."""
    P, K = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(P, -1, K), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


class _BmmF32(torch.autograd.Function):
    """``bmm(x, w, out_dtype=float32)`` of low-precision inputs on the card,
    differentiable: the cotangent is rounded to the inputs' dtype and each
    gradient is one batched matmul in that dtype."""

    @staticmethod
    def forward(ctx, x3, w):
        ctx.save_for_backward(x3, w)
        return torch.bmm(x3, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, ct):
        x3, w = ctx.saved_tensors
        ct = ct.to(x3.dtype)
        dx = torch.bmm(ct, w.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        dw = torch.bmm(x3.transpose(1, 2), ct) if ctx.needs_input_grad[1] \
            else None
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`rank_matmul` with an fp32 result (the JAX package's
    ``jnp.dot(..., preferred_element_type=float32)``): a bf16 product is
    not rounded to bf16 before it is summed across ranks."""
    P, K = x.shape[0], x.shape[-1]
    x3 = x.reshape(P, -1, K)
    if x.dtype == torch.float32:
        out = torch.bmm(x3, w)
    elif x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _BmmF32.apply(x3, w)
        else:
            out = torch.bmm(x3, w, out_dtype=torch.float32)
    else:
        out = torch.bmm(x3.float(), w.float())
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


_side_streams: dict = {}


def overlapped_matmul_allreduce(h: torch.Tensor, w: torch.Tensor, comm,
                                cfg: CommConfig,
                                n_chunks: int | None = None) -> torch.Tensor:
    """Row-parallel TP matmul with the reduction double-buffered against
    compute.

    ``h``: stacked ``(P, tokens, ff_shard)`` activation shards; ``w``:
    ``(P, ff_shard, d)`` weight shards; result: ``(P, tokens, d)`` fully
    reduced, in h's dtype.  ``comm`` is the caller's TP communicator.

    Token rows are split into wire chunks (``plans.chunk_plan`` of one
    rank's f32 ``(tokens, d)`` partial, aligned to whole rows).  On the
    card each chunk's all-reduce runs on a second stream, forked after the
    chunk's matmul, so reduce *i* overlaps matmul *i + 1*; under ordered
    transport chunk *i*'s matmul waits on reduce *i − 2* (the two-deep ack
    chain of the per-layer double buffering).  On the CPU the chunks run in
    order.  The per-chunk combine is the native all-reduce (an int8 wire
    becomes no compression, as in the JAX package).  On the CPU the result
    is bitwise equal to the whole matmul + all-reduce: row chunking never
    changes a row's arithmetic there.
    """
    import dataclasses
    from repro_torch.core import collectives
    from repro_torch.core.config import Transport
    tokens = h.shape[1]
    if n_chunks is None:
        p = plans.chunk_plan((tokens, w.shape[-1]), torch.float32, cfg,
                             align=w.shape[-1])
        n_chunks = p.n_chunks
    n_chunks = max(1, min(n_chunks, tokens))
    while tokens % n_chunks:
        n_chunks -= 1
    cfg_native = dataclasses.replace(
        cfg, algorithm="native",
        compression=(Compression.NONE if cfg.compression == Compression.INT8
                     else cfg.compression))
    rows = tokens // n_chunks
    ordered = cfg.transport == Transport.ORDERED
    side = main = None
    if h.is_cuda and n_chunks > 1:
        main = torch.cuda.current_stream(h.device)
        side = _side_streams.get(h.device)
        if side is None:
            side = _side_streams[h.device] = torch.cuda.Stream(h.device)
    parts: list[torch.Tensor] = []
    partials: list[torch.Tensor] = []
    done: list = []
    for i in range(n_chunks):
        hc = h[:, i * rows:(i + 1) * rows]
        if side is not None and ordered and i >= 2:
            main.wait_event(done[i - 2])
        partial = matmul_f32(hc, w)
        if side is None:
            parts.append(collectives.all_reduce(partial, comm, cfg_native))
            continue
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = collectives.all_reduce(partial, comm, cfg_native)
            ev = torch.cuda.Event()
            ev.record(side)
        # each partial stays referenced until the join below, so the
        # caching allocator cannot hand it to another main-stream
        # allocation while the side stream still reads it; after the join
        # every buffer is free for reuse on either stream (side-stream work
        # always starts by waiting on the main stream).  No record_stream:
        # under a CUDA graph capture it would hold every chunk's buffers
        # until the capture ends.
        partials.append(partial)
        parts.append(out)
        done.append(ev)
    if side is not None:
        main.wait_stream(side)
    del partials
    return torch.cat(parts, dim=1).to(h.dtype)
