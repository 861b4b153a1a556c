"""Piecewise-constant discontinuous-Galerkin (cell-centered FV) shallow-water
solver with ACCL-X halo exchange — PyTorch port on stacked ranks.

All partitions of the mesh run in one process as the leading dimension of
every tensor: ``state`` is ``(P, E_max, 3)``.  Per time step (paper Fig.
7/8):

  1. the halo exchange for the boundary elements (one permute per wire
     chunk, or one whole-message permute plus a staging copy when buffered);
  2. the element update: Rusanov fluxes through the three edges of every
     element — neighbours read from ``[state | halo]`` — and the explicit
     update.  On CUDA tensors this is the hand-written ``swe_step`` kernel;
     on CPU tensors its plain PyTorch version.

Under ``Scheduling.OVERLAPPED`` the step is split into an interior pass
against a zero halo, issued while the exchange runs on a second CUDA stream,
and a boundary pass over ``boundary_idx`` against the real halo, written
over the interior result.  Both passes run the same kernel, so all schedules
are bitwise-equal — only the dependency structure differs.

Rusanov (local Lax-Friedrichs) flux; reflective land boundaries; open-sea
boundary with optional tidal forcing (the bight-of-Abaco scenario).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import collectives, reliable, streaming
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import CommConfig, Scheduling
from repro_torch.obs import trace as obs_trace
from repro_torch.swe.partition import PartitionedMesh

G = 9.81
# FLOP count per element per step (3 edges × Rusanov ≈ 75 flops + update),
# used for the Eq. 2 throughput accounting like the paper's FLOP_sum.
FLOP_PER_ELEMENT = 260.0


def _norm(n):
    """Length of 2-vectors ``n (..., 2)``, written out so that every shape
    takes the same arithmetic (bitwise-stable across schedules)."""
    return torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1])


def physical_flux(u, n):
    """u: (..., 3) = (h, hu, hv); n: (..., 2) scaled outward normal."""
    h = torch.clamp(u[..., 0], min=1e-8)
    hu, hv = u[..., 1], u[..., 2]
    un = (hu * n[..., 0] + hv * n[..., 1]) / h      # normal velocity * |n|
    f0 = h * un
    f1 = hu * un + 0.5 * G * h * h * n[..., 0]
    f2 = hv * un + 0.5 * G * h * h * n[..., 1]
    return torch.stack([f0, f1, f2], dim=-1)


def rusanov(u_l, u_r, n):
    """Rusanov numerical flux through an edge with scaled normal n."""
    nlen = torch.clamp(_norm(n), min=1e-12).unsqueeze(-1)
    nhat = n / nlen
    h_l = torch.clamp(u_l[..., 0], min=1e-8)
    h_r = torch.clamp(u_r[..., 0], min=1e-8)
    un_l = (u_l[..., 1] * nhat[..., 0] + u_l[..., 2] * nhat[..., 1]) / h_l
    un_r = (u_r[..., 1] * nhat[..., 0] + u_r[..., 2] * nhat[..., 1]) / h_r
    lam = torch.maximum(un_l.abs() + torch.sqrt(G * h_l),
                        un_r.abs() + torch.sqrt(G * h_r)).unsqueeze(-1)
    return 0.5 * (physical_flux(u_l, n) + physical_flux(u_r, n)
                  - lam * nlen * (u_r - u_l))


def reflect(u, n):
    """Reflective (land) ghost state: mirror the normal momentum."""
    nlen = torch.clamp(_norm(n), min=1e-12).unsqueeze(-1)
    nhat = n / nlen
    qn = u[..., 1] * nhat[..., 0] + u[..., 2] * nhat[..., 1]
    return torch.stack([u[..., 0],
                        u[..., 1] - 2 * qn * nhat[..., 0],
                        u[..., 2] - 2 * qn * nhat[..., 1]], dim=-1)


def halo_payloads(state, send_idx, send_mask):
    """Every round's send rows of every rank: ``(P, R, S_max, 3)``, zero
    where ``send_mask`` is 0 (what the paper's communication kernel stages
    for the wire)."""
    P, R, S = send_idx.shape
    rows = torch.gather(state, 1, send_idx.reshape(P, R * S, 1)
                        .expand(-1, -1, 3)).reshape(P, R, S, 3)
    return rows * send_mask.unsqueeze(-1)


@dataclasses.dataclass(frozen=True)
class SWEConfig:
    dt: float = 1e-4
    tidal_amplitude: float = 0.0
    tidal_omega: float = 0.5
    h_sea: float = 1.0


def make_step_fn(pm: PartitionedMesh, comm_cfg: CommConfig,
                 swe: SWEConfig = SWEConfig(), topology=None,
                 round_cfgs=None, update=None):
    """Returns ``step(state, t, area, normals, neigh_idx, edge_type, valid,
    send_idx, send_mask, recv_slot, boundary_idx)`` on stacked ``(P, ...)``
    tensors; ``t`` is a 0-dim float32 tensor on the state's device.

    ``comm_cfg.scheduling == OVERLAPPED`` selects the interior/boundary-split
    step; all other schedules use the exchange-then-update step.  Both are
    bitwise-equal.  ``topology`` places the partitions on a virtual torus
    (multi-hop exchange edges are routed, value-identical); ``round_cfgs``
    is one config per exchange round (serial scheduling only).
    ``update`` replaces the element update (default: the ``swe_step``
    kernel's wrapper); a caller passes the plain version to run it on the
    card for comparison.

    Under a wire fault schedule (:func:`repro_torch.core.reliable.inject`)
    the step's first call draws one delivery plan per message and every
    later call replays them in issue order (``step.tape``, a
    :class:`~repro_torch.core.reliable.PlanTape`): one step function is
    one traced program of the JAX package, whatever calls it how often.
    """
    if update is None:
        from repro_torch.kernels.swe_step import ops
        update = ops.swe_step
    comm = Communicator(("data",), (pm.n_parts,), topo=topology)
    rounds = pm.rounds
    H = pm.h_max
    exchange_cfg = (list(round_cfgs) if round_cfgs is not None
                    and comm_cfg.scheduling != Scheduling.OVERLAPPED
                    else comm_cfg)
    side_streams: dict = {}

    def sea_level(t):
        return swe.h_sea + swe.tidal_amplitude * torch.sin(swe.tidal_omega * t)

    def payloads_for(state, send_idx, send_mask):
        pay = halo_payloads(state, send_idx, send_mask)
        return [pay[:, r] for r in range(pay.shape[1])]

    def fold_round(halo, recv_slot_r, recv):
        """Scatter-add one round's message (or any row-aligned slice of it)
        into its halo slots, in place.  Rows with ``recv_slot = -1`` add
        zeros to the last slot; every real slot gets exactly one non-zero
        term, so the sum is exact in any order."""
        P = halo.shape[0]
        ok = recv_slot_r >= 0
        slot = torch.where(ok, recv_slot_r, H - 1)
        slot = slot + torch.arange(P, device=halo.device).unsqueeze(1) * H
        vals = torch.where(ok.unsqueeze(-1), recv, 0.0)
        halo.view(P * H, 3).index_add_(0, slot.reshape(-1),
                                        vals.reshape(-1, 3))
        return halo

    def exchange(state, send_idx, send_mask, recv_slot):
        """Halo exchange -> (P, H_max, 3) halo buffer."""
        halo = state.new_zeros((pm.n_parts, H, 3))
        if not rounds:
            return halo
        received = collectives.multi_neighbor_exchange(
            payloads_for(state, send_idx, send_mask), rounds, comm,
            exchange_cfg)
        for r, recv in enumerate(received):
            fold_round(halo, recv_slot[:, r], recv)
        return halo

    def exchange_overlapped(state, send_idx, send_mask, recv_slot):
        """Double-buffered exchange with chunk-level halo consume: each
        recv_slot-aligned wire chunk is scatter-added into the halo as it
        lands (buffered-mode rounds fold per round)."""
        halo = state.new_zeros((pm.n_parts, H, 3))
        if not rounds:
            return halo
        payloads = payloads_for(state, send_idx, send_mask)
        # Every round's payload is (S_max, 3) per rank: align chunks to 3
        # flat elements so a wire chunk carries whole (h, hu, hv) rows.
        _, chunk_elems = streaming.aligned_chunks(payloads[0], comm_cfg,
                                                  align=3)
        rows_per_chunk = chunk_elems // 3

        def fold_chunk(h, r, i, chunk):
            r0 = i * rows_per_chunk
            slots = recv_slot[:, r, r0:min(r0 + rows_per_chunk, pm.s_max)]
            rows = chunk.reshape(chunk.shape[0], -1, 3)[:, :slots.shape[1]]
            return fold_round(h, slots, rows)

        halo, _ = collectives.multi_neighbor_exchange(
            payloads, rounds, comm, comm_cfg,
            consume=lambda h, r, recv: fold_round(h, recv_slot[:, r], recv),
            init=halo, chunk_consume=fold_chunk, chunk_align=3)
        return halo

    def step_serial(state, t, area, normals, neigh_idx, edge_type, valid,
                    send_idx, send_mask, recv_slot, boundary_idx):
        with obs_trace.span("swe.exchange", cat="phase",
                            rounds=pm.n_rounds):
            halo = exchange(state, send_idx, send_mask, recv_slot)
        with obs_trace.span("swe.update", cat="phase"):
            return update(state, halo, normals, neigh_idx, edge_type, area,
                          valid, sea_level(t), dt=swe.dt)

    def step_overlapped(state, t, area, normals, neigh_idx, edge_type, valid,
                        send_idx, send_mask, recv_slot, boundary_idx):
        h_sea = sea_level(t)
        zero_halo = state.new_zeros((pm.n_parts, H, 3))

        def interior():
            # every element against an EMPTY halo: boundary rows come out
            # wrong here and are overwritten by the boundary pass
            with obs_trace.span("swe.interior", cat="phase"):
                return update(state, zero_halo, normals, neigh_idx,
                              edge_type, area, valid, h_sea, dt=swe.dt)

        def halo_exchange():
            with obs_trace.span("swe.exchange", cat="phase",
                                rounds=pm.n_rounds):
                return exchange_overlapped(state, send_idx, send_mask,
                                           recv_slot)

        if state.is_cuda:
            # The exchange runs on a second stream, forked from and joined
            # back into the compute stream (also inside a graph capture).
            main = torch.cuda.current_stream(state.device)
            side = side_streams.get(state.device)
            if side is None:
                side = side_streams[state.device] = torch.cuda.Stream(
                    state.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                halo = halo_exchange()
            new = interior()
            main.wait_stream(side)
        else:
            new = interior()
            halo = halo_exchange()
        # Boundary pass: recompute ONLY the elements with a remote edge
        # against the real halo, written over the interior result.  Padded
        # boundary_idx entries repeat a real row with identical values.
        with obs_trace.span("swe.boundary", cat="phase"):
            return update(state, halo, normals, neigh_idx, edge_type, area,
                          valid, h_sea, dt=swe.dt, rows=boundary_idx,
                          out=new)

    body = (step_overlapped if comm_cfg.scheduling == Scheduling.OVERLAPPED
            else step_serial)
    tape = reliable.PlanTape()

    def step(*args, **kwargs):
        with tape.play():
            return body(*args, **kwargs)

    step.tape = tape
    return step


def initial_state(mesh, hump: bool = True) -> np.ndarray:
    """Still water + Gaussian hump in the bight (for conservation tests and
    the quickstart scenario)."""
    E = mesh.n_elements
    state = np.zeros((E, 3))
    state[:, 0] = 1.0
    if hump:
        c = mesh.centroids
        state[:, 0] += 0.3 * np.exp(-60.0 * ((c[:, 0] - 0.55) ** 2
                                             + (c[:, 1] - 0.5) ** 2))
    return state


def total_mass(state, area, valid) -> torch.Tensor:
    return torch.sum(state[..., 0] * area * valid)
