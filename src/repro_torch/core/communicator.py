"""Communicator abstraction — the MPI-like layer of ACCL-X (PyTorch port).

A :class:`Communicator` names a process group.  The port's backend runs all
ranks of the group in one process, as the leading dimension of every tensor
the collectives take (the *stacked-rank* backend): rank ``p``'s data is
``x[p]``.  ``rank()`` is therefore the whole rank axis at once.

A communicator may be one group of a larger stacked mesh: ``split`` of a
``(data, model)`` communicator gives the groups of one axis.  The stacked
rank dimension then holds every rank of the mesh, in row-major order over
``mesh_sizes`` (as ``jax.make_mesh`` lays out devices): a ``model`` group
is ``tp`` contiguous rows, a ``data`` group rows strided by ``tp``.  The
collectives run on each group separately (:meth:`Communicator.groups`).

The topology helpers mirror the paper's setups:

- ``ring_perm``      — the b_eff virtual ring (paper §3.3).
- ``neighbor_perms`` — point-to-point neighbor lists (the shallow-water
                       halo exchange, paper §4.1).
- ``torus_hops``     — hop distance on a 2-D torus (the latency model's
                       per-hop term).
- ``topo``           — optional :class:`~repro_torch.core.topology.TorusSpec`
                       virtual placement: every multi-hop point-to-point
                       edge is routed (store-and-forward single-hop
                       permutes) by the transport layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Communicator:
    """A process group over one or more named axes.

    ``axis_names`` is ordered major-to-minor; rank = row-major index over
    the axis sizes.  ``topo`` attaches a virtual torus placement: it changes
    hop accounting and how the transport moves multi-hop messages, never
    their values.
    """
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    topo: Optional["TorusSpec"] = None
    # the stacked mesh this group is cut from (major to minor); empty when
    # the group spans the whole rank dimension
    mesh_axes: Tuple[str, ...] = ()
    mesh_sizes: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.topo is not None and self.topo.n_ranks != self.size:
            raise ValueError(
                f"torus spec {self.topo.name} places {self.topo.n_ranks} "
                f"ranks but the communicator has {self.size}")

    @classmethod
    def from_mesh(cls, mesh, axis_names: Sequence[str] | str,
                  topo: Optional["TorusSpec"] = None) -> "Communicator":
        """The group over ``axis_names`` of ``mesh`` (anything with
        ``axis_names`` and a ``shape`` mapping, such as
        :class:`~repro_torch.models.common.MeshContext`).  Axes left out
        make it one group of several on the stacked rank dimension."""
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        sizes = tuple(mesh.shape[a] for a in axis_names)
        all_axes = tuple(mesh.axis_names)
        if tuple(a for a in all_axes if mesh.shape[a] > 1) == tuple(
                a for a in axis_names if mesh.shape[a] > 1):
            return cls(axis_names, sizes, topo=topo)
        return cls(axis_names, sizes, topo=topo, mesh_axes=all_axes,
                   mesh_sizes=tuple(mesh.shape[a] for a in all_axes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def stacked_size(self) -> int:
        """Rows of the stacked rank dimension: every rank of the mesh."""
        return math.prod(self.mesh_sizes) if self.mesh_axes else self.size

    @property
    def n_groups(self) -> int:
        return self.stacked_size // self.size

    def local(self) -> "Communicator":
        """This group on its own (a tensor holding only its rows)."""
        if not self.mesh_axes:
            return self
        return Communicator(self.axis_names, self.axis_sizes, topo=self.topo)

    def _layout(self) -> tuple[int, int, int]:
        """``(outer, size, inner)``: the stacked rows viewed so that a group
        is ``[o, :, i]`` (the group's axes must be adjacent in the mesh)."""
        if not self.mesh_axes:
            return 1, self.size, 1
        idx = [self.mesh_axes.index(a) for a in self.axis_names]
        if idx != list(range(idx[0], idx[0] + len(idx))):
            raise ValueError(f"axes {self.axis_names} are not adjacent in "
                             f"the mesh {self.mesh_axes}")
        return (math.prod(self.mesh_sizes[:idx[0]]), self.size,
                math.prod(self.mesh_sizes[idx[-1] + 1:]))

    def groups(self, x: torch.Tensor, fn) -> torch.Tensor:
        """Apply ``fn(rows, comm)`` to each group's rows of the stacked
        ``x`` (``(size, ...)``, in rank order, with the group's own
        communicator) and put the results back on the stacked rows.  Each
        group's result is written into the one output as it comes, so a
        call holds the output and one group's result at a time (a
        full-width ZeRO-1 gather's output is 10 GB)."""
        if self.n_groups == 1:
            return fn(x, self.local())
        outer, n, inner = self._layout()
        xv = x.reshape((outer, n, inner) + tuple(x.shape[1:]))
        comm = self.local()
        out = None
        for o in range(outer):
            for i in range(inner):
                y = fn(xv[o, :, i], comm)
                if out is None:
                    out = y.new_empty((outer, y.shape[0], inner)
                                      + tuple(y.shape[1:]))
                out[o, :, i] = y
                del y
        return out.reshape((outer * n * inner,) + tuple(out.shape[3:]))

    @property
    def single_axis(self) -> bool:
        return len(self.axis_names) == 1

    @property
    def axis(self) -> str:
        if not self.single_axis:
            raise ValueError(f"communicator spans axes {self.axis_names}")
        return self.axis_names[0]

    def rank(self, device=None) -> torch.Tensor:
        """Rank within its group of every row of the stacked rank dimension:
        ``arange(size)`` for a group spanning it."""
        if self.n_groups == 1:
            return torch.arange(self.size, device=device)
        outer, n, inner = self._layout()
        r = torch.arange(n).view(1, n, 1).expand(outer, n, inner)
        return r.reshape(-1).to(device)

    def split(self, axis_name: str) -> "Communicator":
        """The groups over one axis (``MPI_Comm_split``): each group of the
        returned communicator holds the ranks that differ only along
        ``axis_name``."""
        if axis_name not in self.axis_names:
            raise ValueError(f"{axis_name} not in {self.axis_names}")
        axes = self.mesh_axes or self.axis_names
        sizes = self.mesh_sizes or self.axis_sizes
        i = axes.index(axis_name)
        if math.prod(sizes) == sizes[i]:
            return Communicator((axis_name,), (sizes[i],))
        return Communicator((axis_name,), (sizes[i],), mesh_axes=axes,
                            mesh_sizes=sizes)

    def auto_config(self, collective: str, msg_bytes: int, db_path=None,
                    hops: int | None = None, objective: str = "latency",
                    device=None):
        """Autotuned ``CommConfig`` for a collective this communicator will
        run (host-side; consults the persistent TuneDB keyed by THIS
        communicator's size and ``device``'s platform — ``OPTIMIZED_CONFIG``
        on a cold cache).  ``hops`` defaults to this communicator's ring
        pattern (placement-aware when a torus spec is attached, in which
        case measurements on the same placement are preferred)."""
        from repro_torch.tune import select_config, topology_key
        if hops is None:
            hops = self.max_hops(self.ring_perm())
        return select_config(collective, msg_bytes, path=db_path,
                             topo=topology_key(self.size, device),
                             hops=hops, objective=objective,
                             torus=self.topo.name if self.topo else "")

    # ------------------------------------------------------------------
    # Topology helpers (static, host-side)
    # ------------------------------------------------------------------
    def ring_perm(self, step: int = 1) -> list[tuple[int, int]]:
        from repro_torch.core import plans
        return list(plans.ring_perm(self.size, step))

    def reverse_ring_perm(self, step: int = 1) -> list[tuple[int, int]]:
        from repro_torch.core import plans
        return list(plans.ring_perm(self.size, -step))

    def neighbor_perms(self, edges: Sequence[Tuple[int, int]]) -> list[tuple[int, int]]:
        """Validate an explicit point-to-point pattern of (src, dst) pairs:
        each rank is the source of at most one pair per permute."""
        srcs = [s for s, _ in edges]
        if len(set(srcs)) != len(srcs):
            raise ValueError("each rank may send at most once per ppermute")
        for s, d in edges:
            if not (0 <= s < self.size and 0 <= d < self.size):
                raise ValueError(f"edge ({s},{d}) outside communicator size {self.size}")
        return list(edges)

    def hop_perm(self, d: int) -> list[tuple[int, int]]:
        """Translation perm at exactly ``d`` torus hops (requires a
        :class:`~repro_torch.core.topology.TorusSpec`)."""
        if self.topo is None:
            raise ValueError("hop_perm requires a torus spec "
                             "(Communicator(..., topo=TorusSpec(...)))")
        return self.topo.hop_perm(d)

    def torus_hops(self, src: int, dst: int, torus_shape: Tuple[int, int] | None = None
                   ) -> int:
        """Manhattan hop count between two ranks on a 2-D torus.

        With a :class:`~repro_torch.core.topology.TorusSpec` attached the
        distance follows the spec's shape *and placement*; otherwise ranks
        are laid out row-major on ``torus_shape`` (defaults to the squarest
        factorization of the communicator size).
        """
        if self.topo is not None and torus_shape is None:
            return self.topo.hops(src, dst)
        n = self.size
        if torus_shape is None:
            a = int(math.isqrt(n))
            while n % a:
                a -= 1
            torus_shape = (a, n // a)
        rows, cols = torus_shape
        (sr, sc), (dr, dc) = divmod(src, cols), divmod(dst, cols)
        dy = min((sr - dr) % rows, (dr - sr) % rows)
        dx = min((sc - dc) % cols, (dc - sc) % cols)
        return dy + dx

    def max_hops(self, edges: Sequence[Tuple[int, int]]) -> int:
        return max((self.torus_hops(s, d) for s, d in edges), default=0)
