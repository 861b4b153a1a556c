"""Synthetic unstructured triangular mesh over a bight-shaped domain.

The paper simulates the tidal flow of the bight of Abaco (1696-element mesh,
scaled up to ~312k elements for weak scaling).  We generate a comparable
family of meshes: jittered-grid points inside a bight polygon (a bay with an
open-sea edge on one side), Delaunay-triangulated; boundary edges are
classified *land* (coastline) or *sea* (open boundary), as in the paper's
Figure 5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import Delaunay


@dataclasses.dataclass
class Mesh:
    nodes: np.ndarray        # (N, 2) float64
    elements: np.ndarray     # (E, 3) int32 node ids, CCW
    neighbors: np.ndarray    # (E, 3) int32: adjacent element id, or
                             #   -1 = land boundary, -2 = sea boundary
    area: np.ndarray         # (E,)
    normals: np.ndarray      # (E, 3, 2) outward normal * edge length
    centroids: np.ndarray    # (E, 2)

    @property
    def n_elements(self) -> int:
        return len(self.elements)


def _bight_mask(pts: np.ndarray) -> np.ndarray:
    """A bay shape on [0,1]²: water = inside the bight; the x=1 edge is the
    open sea."""
    x, y = pts[:, 0], pts[:, 1]
    # coastline: a cosine-shaped bay carved from the west
    coast = 0.25 * (1 - np.cos(2 * np.pi * y)) * 0.5
    return x > coast


def generate_bight_mesh(target_elements: int = 1696, seed: int = 0) -> Mesh:
    """Jittered-grid Delaunay mesh with ≈ target_elements triangles."""
    # elements ≈ 2 * points for Delaunay in 2D; solve for grid size
    n_pts = max(16, int(target_elements / 2))
    aspect = 1.0
    nx = int(np.sqrt(n_pts * aspect))
    ny = max(2, n_pts // max(nx, 1))
    rng = np.random.RandomState(seed)
    gx, gy = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny))
    pts = np.stack([gx.ravel(), gy.ravel()], 1)
    jitter = 0.35 / max(nx, ny)
    interior = ((pts[:, 0] > 0) & (pts[:, 0] < 1)
                & (pts[:, 1] > 0) & (pts[:, 1] < 1))
    pts[interior] += rng.uniform(-jitter, jitter, pts[interior].shape)
    pts = pts[_bight_mask(pts)]

    tri = Delaunay(pts)
    elements = tri.simplices.astype(np.int32)
    # drop slivers hugging the concave coastline
    cent = pts[elements].mean(1)
    keep = _bight_mask(cent)
    # quality filter: tiny slivers force dt -> 0 (CFL); drop anything far
    # below the median area
    a = _areas(pts, elements)
    keep &= a > 0.05 * np.median(a[a > 1e-12])
    elements = elements[keep]

    neighbors = _build_neighbors(pts, elements)
    area = _areas(pts, elements)
    normals = _edge_normals(pts, elements)
    return Mesh(nodes=pts, elements=elements, neighbors=neighbors,
                area=area, normals=normals, centroids=pts[elements].mean(1))


def _areas(nodes, elements):
    p = nodes[elements]
    return 0.5 * np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))


def _edge_normals(nodes, elements):
    """Outward normal scaled by edge length; edge j connects vertex j and
    j+1 (mod 3)."""
    p = nodes[elements]          # (E,3,2)
    out = np.zeros((len(elements), 3, 2))
    cent = p.mean(1)
    for j in range(3):
        a, b = p[:, j], p[:, (j + 1) % 3]
        t = b - a
        n = np.stack([t[:, 1], -t[:, 0]], 1)   # rotate -90°
        mid = 0.5 * (a + b)
        flip = np.einsum("ij,ij->i", n, mid - cent) < 0
        n[flip] *= -1
        out[:, j] = n
    return out


def _build_neighbors(nodes, elements):
    """(E,3) adjacency; -1 land, -2 sea (open boundary near x≈max)."""
    edge_map: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for e, tri_nodes in enumerate(elements):
        for j in range(3):
            key = tuple(sorted((int(tri_nodes[j]), int(tri_nodes[(j + 1) % 3]))))
            edge_map.setdefault(key, []).append((e, j))
    neigh = np.full((len(elements), 3), -1, np.int32)
    xmax = nodes[:, 0].max()
    for key, users in edge_map.items():
        if len(users) == 2:
            (e1, j1), (e2, j2) = users
            neigh[e1, j1] = e2
            neigh[e2, j2] = e1
        else:
            (e, j), = users
            n1, n2 = key
            # open-sea boundary: both endpoints on the eastern edge
            if nodes[n1, 0] > xmax - 1e-6 and nodes[n2, 0] > xmax - 1e-6:
                neigh[e, j] = -2
            else:
                neigh[e, j] = -1
    return neigh
