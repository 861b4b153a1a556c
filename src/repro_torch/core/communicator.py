"""Communicator abstraction — the MPI-like layer of ACCL-X (PyTorch port).

A :class:`Communicator` names a process group.  The port's backend runs all
ranks of the group in one process, as the leading dimension of every tensor
the collectives take (the *stacked-rank* backend): rank ``p``'s data is
``x[p]``.  ``rank()`` is therefore the whole rank axis at once.

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

    def __post_init__(self):
        if self.topo is not None and self.topo.n_ranks != self.size:
            raise ValueError(
                f"torus spec {self.topo.name} places {self.topo.n_ranks} "
                f"ranks but the communicator has {self.size}")

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def single_axis(self) -> bool:
        return len(self.axis_names) == 1

    @property
    def axis(self) -> str:
        if not self.single_axis:
            raise ValueError(f"communicator spans axes {self.axis_names}")
        return self.axis_names[0]

    def rank(self, device=None) -> torch.Tensor:
        """Rank of every row of the stacked rank dimension: ``arange(size)``."""
        return torch.arange(self.size, device=device)

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
