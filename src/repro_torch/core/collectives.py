"""ACCL-X collectives over the stacked-rank backend.

Every payload carries the communicator's ranks as its leading dimension
(``x[p]`` is rank ``p``'s message).  Point-to-point ops take explicit
``(src, dst)`` edge lists, as the shallow-water halo exchange does (paper
§4.1).

Two algorithm families for the collectives, selected by
``CommConfig.algorithm``:

- ``native`` — one reduction or block move along the rank dimension (the
  JAX package's ``psum``/``all_gather``/``psum_scatter``/``all_to_all``).
- ``ring``   — explicit permute rings (the CCLO analogue), required for the
  int8 wire format: every hop goes through the compression plugin, whose
  int8 encode and decode are the CUDA kernels of
  :mod:`repro_torch.kernels.quant` on the card.

The JAX package's per-rank ``jnp.take(acc, (d - t) % n)`` and
``dynamic_update_index_in_dim`` become a gather and a scatter over
``(arange(P), idx)``.  The ring algorithms update their accumulator in
place (one copy of the message instead of one per step).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.communicator import Communicator
from repro_torch.core.config import (CommConfig, CommMode, Compression,
                                     Scheduling)
from repro_torch.core import plans, plugins, streaming, topology
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace


def _nbytes(x: torch.Tensor) -> int:
    """Per-rank byte count of a stacked payload."""
    return math.prod(x.shape[1:]) * x.element_size()


def _record_edges(comm: Communicator, perm, nbytes: int) -> None:
    """Per-edge byte accounting: every edge moves ``nbytes``, counted under
    its torus hop distance (the per-edge axis of the paper's Fig. 9)."""
    reg = obs_metrics.registry()
    reg.counter("comm.bytes").inc(nbytes * len(perm))
    for s, d in perm:
        reg.counter("comm.edge_bytes",
                    hops=comm.torus_hops(int(s), int(d))).inc(nbytes)


def resolve_config(cfg, collective: str = "all_reduce",
                   msg_bytes: int = 1 << 20, n_ranks: int | None = None,
                   db_path=None, hops: int | None = None,
                   objective: str = "latency", torus: str | None = None,
                   consumer: str | None = None, device=None) -> CommConfig:
    """Resolve a ``CommConfig | "auto" | None`` to a concrete config.

    ``"auto"`` asks the autotuner (:func:`repro_torch.tune.select_config`)
    for the fastest measured config for this collective, message size and
    rank count on ``device``'s platform, falling back to
    ``OPTIMIZED_CONFIG`` on a cold cache.  ``hops``, ``objective``,
    ``torus`` and ``consumer`` refine the lookup as in ``select_config``.
    """
    if isinstance(cfg, CommConfig):
        return cfg
    if cfg is None or cfg == "auto":
        from repro_torch.tune import select_config, topology_key
        return select_config(collective, msg_bytes, path=db_path,
                             topo=topology_key(n_ranks, device), hops=hops,
                             objective=objective, torus=torus,
                             consumer=consumer)
    raise TypeError(f"comm config must be CommConfig or 'auto', got {cfg!r}")


def sendrecv(x: torch.Tensor, perm: Sequence[tuple[int, int]],
             comm: Communicator, cfg: CommConfig) -> torch.Tensor:
    """Single send/recv along an edge list (each rank sends at most once).

    On a communicator placed on a virtual torus every multi-hop edge is
    routed: the transfer runs one single-hop permute per torus hop,
    value-identical to the direct permute.
    """
    perm = plans.validated_perm(comm, perm)
    nbytes = _nbytes(x)
    hops = comm.max_hops(perm)
    _record_edges(comm, perm, nbytes)
    perm = topology.routed_perm(comm, perm)
    with obs_trace.span("sendrecv", cat="collective", nbytes=nbytes,
                        hops=hops, edges=len(perm.edges)
                        if isinstance(perm, topology.RoutedPerm)
                        else len(perm),
                        mode=cfg.mode, transport=cfg.transport,
                        scheduling=cfg.scheduling,
                        reliability=cfg.reliability):
        if cfg.mode == CommMode.STREAMING:
            return streaming.chunked_permute(x, perm, cfg)
        return streaming.buffered_permute(x, perm, cfg)


def edge_color_rounds(edges: Sequence[tuple[int, int]]):
    """Greedily color a multi-neighbor exchange into permute-able rounds.

    Each round is a valid permutation fragment: every rank appears at most
    once as source and once as destination.  The number of rounds is the
    N_max of Eq. 3.  Derived once per edge list and replayed from the plan
    cache.
    """
    return plans.edge_rounds(edges)


def multi_neighbor_exchange(payloads: Sequence[torch.Tensor],
                            rounds: Sequence[Sequence[tuple[int, int]]],
                            comm: Communicator, cfg,
                            consume=None, init=None,
                            chunk_consume=None, chunk_align: int = 1):
    """Halo exchange with several neighbors: one sendrecv per round.

    ``payloads[r]`` is the stacked ``(P, ...)`` message of round ``r``
    (ranks not sending in a round carry a dummy row).  Rounds are issued in
    order on one stream, which also realizes ordered transport's chain.
    Overlapped scheduling routes through the double-buffered engine.

    ``cfg`` may be a sequence of per-round configs (serial scheduling only;
    the double-buffered overlapped engine requires a uniform config).

    Overlapped scheduling additionally accepts the engine's consume hooks
    (see :func:`repro_torch.core.streaming.double_buffered_exchange`).  When
    either hook is given the return value is ``(carry, received)``;
    otherwise just ``received`` (round order).
    """
    round_cfgs = None
    if not isinstance(cfg, CommConfig):
        round_cfgs = list(cfg)
        if len(round_cfgs) != len(rounds):
            raise ValueError(f"{len(round_cfgs)} per-round configs for "
                             f"{len(rounds)} rounds")
        cfg = round_cfgs[0] if round_cfgs else CommConfig()
    obs_metrics.registry().counter("comm.exchange_rounds").inc(len(rounds))
    exchange_span = obs_trace.span(
        "multi_neighbor", cat="collective", rounds=len(rounds),
        hops=comm.max_hops([e for r in rounds for e in r]),
        nbytes=_nbytes(payloads[0]) if payloads else 0,
        mode=cfg.mode, transport=cfg.transport, scheduling=cfg.scheduling,
        reliability=cfg.reliability)
    if cfg.scheduling == Scheduling.OVERLAPPED:
        if round_cfgs is not None and any(c != cfg for c in round_cfgs):
            raise ValueError(
                "per-round configs require serial scheduling; the "
                "double-buffered overlapped engine pipelines all rounds "
                "under one config")
        if payloads:
            plan = plans.get_plan("multi_neighbor", comm, cfg,
                                  payloads[0].shape[1:], payloads[0].dtype,
                                  rounds, align=chunk_align)
            rounds = list(plan.perms)
        else:
            rounds = [plans.validated_perm(comm, perm) for perm in rounds]
        rounds = [topology.routed_perm(comm, perm) for perm in rounds]
        with exchange_span:
            carry, received = streaming.double_buffered_exchange(
                payloads, rounds, cfg, consume=consume, init=init,
                chunk_consume=chunk_consume, chunk_align=chunk_align)
        if consume is not None or chunk_consume is not None:
            return carry, received
        return received
    received = []
    with exchange_span:
        for r, (payload, perm) in enumerate(zip(payloads, rounds)):
            rcfg = round_cfgs[r] if round_cfgs is not None else cfg
            received.append(sendrecv(payload, perm, comm, rcfg))
    return received


# ----------------------------------------------------------------------
# Ring collectives (explicit permute algorithms; carry wire compression)
# ----------------------------------------------------------------------

def _ring_send(payload: torch.Tensor, comm: Communicator,
               cfg: CommConfig) -> torch.Tensor:
    """One ring hop with wire encoding.  On a virtual torus the rank ring's
    multi-hop edges (e.g. row-major wraps) are routed through the fabric."""
    enc, dec = plugins.wire_encode(payload, cfg)
    perm = topology.routed_perm(comm, comm.ring_perm())
    return dec(streaming._wire(enc, perm))


def _shifted_ranks(n: int, shift: int, device) -> torch.Tensor:
    """``(arange(n) + shift) % n`` on ``device``, built once (outside any
    CUDA graph capture, by the warm-up call)."""
    return plans._memo("ring_index", (n, shift % n, str(device)),
                       lambda: (torch.arange(n) + shift).remainder(n)
                       .to(device))


def _accumulator(x: torch.Tensor, shape) -> torch.Tensor:
    """A private copy of ``x`` viewed as ``shape``, in f32 for low-precision
    inputs: the ring's accumulator, updated in place."""
    dtype = (torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
             else x.dtype)
    return x.reshape(shape).to(dtype, copy=True)


def ring_all_reduce(x: torch.Tensor, comm: Communicator, cfg: CommConfig,
                    op: str = "sum") -> torch.Tensor:
    """Ring all-reduce = reduce-scatter phase + all-gather phase.

    2·(n−1) permute steps moving 2·(n−1)/n of the data per rank — the
    bandwidth-optimal schedule ACCL's CCLO implements.  With the int8 wire
    format the bytes on the wire shrink 4x (compression plugin)."""
    n = comm.size
    if n == 1:
        return x
    reducer = plugins.reduce_op(op, cfg)
    dev = x.device
    d = _shifted_ranks(n, 0, dev)
    flat = x.reshape(n, -1)
    if flat.shape[1] % n:
        flat = F.pad(flat, (0, (-flat.shape[1]) % n))
    # each rank's message cut into n segments (zero-padded)
    acc = _accumulator(flat, (n, n, -1))
    # Phase 1: reduce-scatter.  After n-1 steps rank d holds the fully
    # reduced segment (d+1) mod n.
    for t in range(n - 1):
        payload = acc[d, _shifted_ranks(n, -t, dev)]
        recvd = _ring_send(payload, comm, cfg)
        recv_idx = _shifted_ranks(n, -1 - t, dev)
        acc[d, recv_idx] = reducer(acc[d, recv_idx], recvd)

    my_idx = _shifted_ranks(n, 1, dev)
    cur = acc[d, my_idx]
    out = torch.zeros_like(acc)
    out[d, my_idx] = cur
    # Phase 2: all-gather the reduced segments around the ring.
    for t in range(n - 1):
        recvd = _ring_send(cur, comm, cfg)
        out[d, _shifted_ranks(n, -t, dev)] = recvd
        cur = recvd
    size = math.prod(x.shape[1:])
    return out.reshape(n, -1)[:, :size].reshape(x.shape).to(x.dtype)


def ring_all_gather(x: torch.Tensor, comm: Communicator,
                    cfg: CommConfig) -> torch.Tensor:
    """Ring all-gather; every rank gets ``(n, *x.shape[1:])`` stacked by
    source rank, so the result is ``(n, n, *x.shape[1:])``."""
    n = comm.size
    if n == 1:
        return x[:, None]
    dev = x.device
    d = _shifted_ranks(n, 0, dev)
    out = x.new_zeros((n, n) + tuple(x.shape[1:]))
    out[d, d] = x
    cur = x
    for t in range(n - 1):
        recvd = _ring_send(cur, comm, cfg)
        out[d, _shifted_ranks(n, -1 - t, dev)] = recvd
        cur = recvd
    return out


def ring_reduce_scatter(x: torch.Tensor, comm: Communicator, cfg: CommConfig,
                        op: str = "sum") -> torch.Tensor:
    """Reduce-scatter over each rank's leading dimension (must divide by
    ``comm.size``): rank ``d`` gets the reduced segment ``d``."""
    n = comm.size
    if n == 1:
        return x
    if x.shape[1] % n:
        raise ValueError(f"leading dim {x.shape[1]} not divisible by {n}")
    reducer = plugins.reduce_op(op, cfg)
    dev = x.device
    d = _shifted_ranks(n, 0, dev)
    acc = _accumulator(x, (n, n, x.shape[1] // n) + tuple(x.shape[2:]))
    # Ring offset chosen so rank d finishes holding fully reduced segment d.
    for t in range(n - 1):
        payload = acc[d, _shifted_ranks(n, -t - 1, dev)]
        recvd = _ring_send(payload, comm, cfg)
        recv_idx = _shifted_ranks(n, -t - 2, dev)
        acc[d, recv_idx] = reducer(acc[d, recv_idx], recvd)
    return acc[d, d].to(x.dtype)


# ----------------------------------------------------------------------
# Dispatching wrappers
# ----------------------------------------------------------------------

def _native_sum(x: torch.Tensor) -> torch.Tensor:
    """``psum``: the sum over the rank dimension, on every rank."""
    return x.sum(0, keepdim=True).expand_as(x).contiguous()


def _all_reduce_sum(x: torch.Tensor, comm: Communicator,
                    cfg: CommConfig) -> torch.Tensor:
    if cfg.algorithm == "ring" and comm.single_axis and comm.size > 1:
        return ring_all_reduce(x, comm, cfg, "sum")
    if cfg.compression == Compression.BF16:
        enc, dec = plugins.wire_encode(x, cfg)
        return dec(_native_sum(enc))
    return _native_sum(x)


def all_reduce(x: torch.Tensor, comm: Communicator, cfg: CommConfig,
               op: str = "sum") -> torch.Tensor:
    """All-reduce over the rank dimension.

    The JAX package wraps the sum in a ``custom_vjp`` whose backward is the
    identity (replicated-output gradient semantics for tensor-parallel
    layers); that waits for the port's training slice, which is the first
    caller to differentiate through a collective."""
    with obs_trace.span("all_reduce", cat="collective", op=op,
                        nbytes=_nbytes(x), algorithm=cfg.algorithm,
                        mode=cfg.mode, transport=cfg.transport,
                        scheduling=cfg.scheduling,
                        reliability=cfg.reliability,
                        hops=comm.max_hops(comm.ring_perm())
                        if cfg.algorithm == "ring" and comm.single_axis
                        else 1):
        if op == "sum":
            return _all_reduce_sum(x, comm, cfg)
        if cfg.algorithm == "ring" and comm.single_axis:
            return ring_all_reduce(x, comm, cfg, op)
        if op == "max":
            return x.amax(0, keepdim=True).expand_as(x).contiguous()
        if op == "min":
            return x.amin(0, keepdim=True).expand_as(x).contiguous()
        raise ValueError(f"native all_reduce does not support op={op}")


def all_gather(x: torch.Tensor, comm: Communicator, cfg: CommConfig,
               axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """All-gather of every rank's ``x[p]``: concatenated along ``axis`` of
    the message (``tiled``) or stacked (the ring path stacks on a new
    leading axis, the native one at ``axis``, as in the JAX package)."""
    n = comm.size
    with obs_trace.span("all_gather", cat="collective", nbytes=_nbytes(x),
                        algorithm=cfg.algorithm, mode=cfg.mode,
                        transport=cfg.transport, scheduling=cfg.scheduling,
                        reliability=cfg.reliability):
        if cfg.algorithm == "ring" and comm.single_axis:
            stacked = ring_all_gather(x, comm, cfg)
            if not tiled:
                return stacked
            return torch.cat(stacked.unbind(1), dim=1 + axis)
        if tiled:
            one = torch.cat(x.unbind(0), dim=axis)
        else:
            one = torch.stack(x.unbind(0), dim=axis)
        return one.unsqueeze(0).expand((n,) + tuple(one.shape)).contiguous()


def reduce_scatter(x: torch.Tensor, comm: Communicator, cfg: CommConfig,
                   op: str = "sum") -> torch.Tensor:
    """Reduce-scatter over each rank's leading dimension."""
    with obs_trace.span("reduce_scatter", cat="collective",
                        nbytes=_nbytes(x), algorithm=cfg.algorithm,
                        mode=cfg.mode, transport=cfg.transport,
                        scheduling=cfg.scheduling,
                        reliability=cfg.reliability):
        if cfg.algorithm == "ring" and comm.single_axis:
            return ring_reduce_scatter(x, comm, cfg, op)
        if op != "sum":
            raise ValueError(f"native reduce_scatter does not support "
                             f"op={op}")
        n = comm.size
        total = x.sum(0)
        return total.reshape((n, total.shape[0] // n)
                             + tuple(total.shape[1:]))


def all_to_all(x: torch.Tensor, comm: Communicator, cfg: CommConfig,
               split_axis: int = 0, concat_axis: int = 0) -> torch.Tensor:
    """All-to-all (MoE dispatch).  Wire compression via a bf16 cast if
    enabled.  Overlapped scheduling with streaming delivery tiles the
    message into wire chunks (:func:`streaming.chunked_all_to_all`),
    bitwise-identical to the single all-to-all."""
    with obs_trace.span("all_to_all", cat="collective", nbytes=_nbytes(x),
                        mode=cfg.mode, transport=cfg.transport,
                        scheduling=cfg.scheduling,
                        reliability=cfg.reliability):
        if (cfg.scheduling == Scheduling.OVERLAPPED
                and cfg.mode == CommMode.STREAMING):
            return streaming.chunked_all_to_all(x, comm, cfg, split_axis,
                                                concat_axis)
        return streaming.all_to_all_blocks(x, comm.size, cfg, split_axis,
                                           concat_axis)


def broadcast(x: torch.Tensor, root: int, comm: Communicator,
              cfg: CommConfig) -> torch.Tensor:
    """Broadcast from ``root`` (one-to-all)."""
    is_root = (comm.rank(x.device) == root).view(
        (-1,) + (1,) * (x.dim() - 1))
    masked = torch.where(is_root, x, torch.zeros_like(x))
    return all_reduce(masked, comm, cfg, op="sum")
