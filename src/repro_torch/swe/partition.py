"""Mesh partitioning + halo communication schedule.

Recursive coordinate bisection over element centroids (balanced partitions),
then for every ordered neighbor pair (p -> q) the list of p's elements whose
state q needs (the *halo*, paper Fig. 6).  The exchange schedule is the
edge-colored round structure of ``collectives.edge_color_rounds`` — the
number of rounds a partition participates in is N_max of Eq. 3.

All per-partition arrays are padded to uniform shapes, so the partitions
stack into a leading rank dimension of one set of tensors.  The arrays are
those of the JAX package's ``repro.swe.partition``, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.collectives import edge_color_rounds
from repro_torch.swe.mesh_gen import Mesh


@dataclasses.dataclass
class PartitionedMesh:
    n_parts: int
    e_max: int               # padded elements per partition
    h_max: int               # padded halo slots per partition
    s_max: int               # padded send count per round
    n_rounds: int
    rounds: list             # list of perm lists [(src,dst), ...]
    # Per-partition padded arrays (leading dim = n_parts):
    state0: np.ndarray       # (P, E_max, 3) initial state
    area: np.ndarray         # (P, E_max)
    normals: np.ndarray      # (P, E_max, 3, 2)
    neigh_idx: np.ndarray    # (P, E_max, 3) index into [local | halo] ext array
    edge_type: np.ndarray    # (P, E_max, 3) 0=interior 1=land 2=sea 3=remote
    valid: np.ndarray        # (P, E_max) 1 for real elements
    send_idx: np.ndarray     # (P, R, S_max) local element ids to send (or 0)
    send_mask: np.ndarray    # (P, R, S_max)
    recv_slot: np.ndarray    # (P, R, S_max) halo slot for arriving data (or -1)
    n_core: np.ndarray       # (P,) elements with no remote edge
    n_send: np.ndarray       # (P,) distinct elements sent
    n_neighbors: np.ndarray  # (P,)
    # Interior/boundary element split for the overlapped schedule: boundary
    # elements have >=1 remote edge and consume the halo; interior elements
    # update without it.  Padded entries repeat the partition's first boundary
    # element so a scatter over boundary_idx writes duplicate-identical rows.
    boundary_idx: np.ndarray  # (P, B_max) local ids of boundary elements
    n_boundary: np.ndarray    # (P,) real boundary element count

    @property
    def n_max(self) -> int:
        return int(self.n_neighbors.max())


def _rcb(centroids: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection -> part id per element."""
    part = np.zeros(len(centroids), np.int32)

    def split(idx, parts_left, base):
        if parts_left == 1:
            part[idx] = base
            return
        half = parts_left // 2
        c = centroids[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        cut = int(round(len(idx) * half / parts_left))
        split(idx[order[:cut]], half, base)
        split(idx[order[cut:]], parts_left - half, base + half)

    split(np.arange(len(centroids)), n_parts, 0)
    return part


def partition_mesh(mesh: Mesh, n_parts: int, initial_state: np.ndarray
                   ) -> PartitionedMesh:
    part = _rcb(mesh.centroids, n_parts)
    E = mesh.n_elements
    local_ids = [np.where(part == p)[0] for p in range(n_parts)]
    g2l = np.full(E, -1, np.int64)
    for p, ids in enumerate(local_ids):
        g2l[ids] = np.arange(len(ids))

    # halo requirements: for edge (e in p) adjacent to (n in q != p),
    # p must RECEIVE n from q  => q sends n to p.
    send: dict[tuple[int, int], list[int]] = {}
    for e in range(E):
        p = part[e]
        for j in range(3):
            n = mesh.neighbors[e, j]
            if n >= 0 and part[n] != p:
                send.setdefault((int(part[n]), int(p)), []).append(int(n))
    send = {k: sorted(set(v)) for k, v in send.items()}

    edges = sorted(send)
    rounds = edge_color_rounds(edges)
    n_rounds = len(rounds)
    s_max = max((len(v) for v in send.values()), default=1)

    # halo layout per partition: slots grouped by (source q, element order)
    halo_slot: dict[int, dict[tuple[int, int], int]] = {p: {} for p in range(n_parts)}
    h_count = np.zeros(n_parts, np.int64)
    for (q, p), elems in send.items():
        for g in elems:
            halo_slot[p][(q, g)] = int(h_count[p])
            h_count[p] += 1
    h_max = max(1, int(h_count.max()))
    e_max = max(len(ids) for ids in local_ids)

    P = n_parts
    state0 = np.zeros((P, e_max, 3))
    area = np.ones((P, e_max))
    normals = np.zeros((P, e_max, 3, 2))
    neigh_idx = np.zeros((P, e_max, 3), np.int32)
    edge_type = np.ones((P, e_max, 3), np.int32)  # pad edges behave as land
    valid = np.zeros((P, e_max), np.float32)
    send_idx = np.zeros((P, n_rounds, s_max), np.int32)
    send_mask = np.zeros((P, n_rounds, s_max), np.float32)
    recv_slot = np.full((P, n_rounds, s_max), 0, np.int32)
    recv_mask = np.zeros((P, n_rounds, s_max), np.float32)
    n_core = np.zeros(P, np.int64)
    n_send_arr = np.zeros(P, np.int64)
    n_neighbors = np.zeros(P, np.int64)
    boundary_lists: list[np.ndarray] = []

    for p in range(P):
        ids = local_ids[p]
        k = len(ids)
        state0[p, :k] = initial_state[ids]
        area[p, :k] = mesh.area[ids]
        normals[p, :k] = mesh.normals[ids]
        valid[p, :k] = 1.0
        has_remote = np.zeros(k, bool)
        for li, g in enumerate(ids):
            for j in range(3):
                n = mesh.neighbors[g, j]
                if n == -1:
                    edge_type[p, li, j] = 1
                elif n == -2:
                    edge_type[p, li, j] = 2
                elif part[n] == p:
                    edge_type[p, li, j] = 0
                    neigh_idx[p, li, j] = g2l[n]
                else:
                    edge_type[p, li, j] = 3
                    has_remote[li] = True
                    neigh_idx[p, li, j] = e_max + halo_slot[p][(int(part[n]), int(n))]
        n_core[p] = int((~has_remote).sum())
        boundary_lists.append(np.where(has_remote)[0].astype(np.int32))
        nb = set()
        sent = set()
        for (src, dst), elems in send.items():
            if src == p or dst == p:
                nb.add(dst if src == p else src)
            if src == p:
                sent.update(elems)
        n_neighbors[p] = len(nb)
        n_send_arr[p] = len(sent)

    for r, perm in enumerate(rounds):
        for (src, dst) in perm:
            elems = send[(src, dst)]
            for i, g in enumerate(elems):
                send_idx[src, r, i] = g2l[g]
                send_mask[src, r, i] = 1.0
                recv_slot[dst, r, i] = halo_slot[dst][(src, g)]
                recv_mask[dst, r, i] = 1.0
    # store recv mask in the sign: recv_slot=-1 means ignore
    recv_slot = np.where(recv_mask > 0, recv_slot, -1)

    b_max = max(1, max((len(b) for b in boundary_lists), default=1))
    boundary_idx = np.zeros((P, b_max), np.int32)
    n_boundary = np.zeros(P, np.int64)
    for p, blist in enumerate(boundary_lists):
        n_boundary[p] = len(blist)
        if len(blist):
            boundary_idx[p, :len(blist)] = blist
            boundary_idx[p, len(blist):] = blist[0]
        # no boundary elements (single partition): all-zero padding; the
        # duplicate writes carry identical values so the scatter is exact

    return PartitionedMesh(
        n_parts=P, e_max=e_max, h_max=h_max, s_max=s_max, n_rounds=n_rounds,
        rounds=rounds, state0=state0, area=area, normals=normals,
        neigh_idx=neigh_idx, edge_type=edge_type, valid=valid,
        send_idx=send_idx, send_mask=send_mask, recv_slot=recv_slot,
        n_core=n_core, n_send=n_send_arr, n_neighbors=n_neighbors,
        boundary_idx=boundary_idx, n_boundary=n_boundary)
