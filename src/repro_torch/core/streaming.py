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

The JAX package's reliable-delivery branch (``reliable.plan_for``) is not
ported yet: a ``GUARANTEED`` config runs the fast path, as the JAX package
does on a clean wire.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.config import CommConfig, CommMode
from repro_torch.core import plans, plugins, topology
from repro_torch.obs import trace as obs_trace


def _perm_index(edges: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) index tensors of an edge list on ``device``, built once.
    Cached so that no host-to-device copy happens while a CUDA graph is
    being captured (the capture replays what a warm-up call cached)."""
    def build():
        src = torch.tensor([s for s, _ in edges], dtype=torch.long)
        dst = torch.tensor([d for _, d in edges], dtype=torch.long)
        return src.to(device), dst.to(device)
    return plans._memo("perm_index", (edges, str(device)), build)


def _dest_mask(dests: tuple, n: int, device) -> torch.Tensor:
    """Boolean ``(n,)`` mask of a batch's destination ranks, built once."""
    def build():
        m = torch.zeros(n, dtype=torch.bool)
        m[list(dests)] = True
        return m.to(device)
    return plans._memo("dest_mask", (dests, n, str(device)), build)


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


def chunked_permute(x: torch.Tensor, perm: Sequence[tuple[int, int]],
                    cfg: CommConfig) -> torch.Tensor:
    """Streaming point-to-point transfer of ``x`` along ``perm``: one permute
    per wire chunk, in the compression plugin's wire format."""
    plan = plans.chunk_plan(tuple(x.shape[1:]), x.dtype, cfg,
                            equal_split=True)
    n = plan.n_chunks
    chunks, unsplit = split_chunks(x, n)
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
    (the paper's l_m term)."""
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
