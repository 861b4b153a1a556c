"""ACCL-X point-to-point collectives over the stacked-rank backend.

Every payload carries the communicator's ranks as its leading dimension
(``x[p]`` is rank ``p``'s message).  Point-to-point ops take explicit
``(src, dst)`` edge lists, as the shallow-water halo exchange does (paper
§4.1).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.communicator import Communicator
from repro_torch.core.config import CommConfig, CommMode, Scheduling
from repro_torch.core import plans, streaming, topology
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
