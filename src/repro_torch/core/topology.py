"""Virtual multi-hop torus topology — emulate 2-D torus placements.

The paper's central result is *where* a message travels: on the 48-FPGA
installation the best configuration depends on the per-edge hop distance.
Ranks stacked on one card have no such structure — every permute costs the
same — so this module supplies a **virtual torus transport**: a
:class:`TorusSpec` places the communicator's ranks on an ``R x C`` torus,
and every point-to-point transfer whose edge spans more than one torus hop
is *routed* — lowered to a sequence of single-hop permute rounds through the
intermediate ranks (store-and-forward).  Each extra hop is one extra
physically executed permute.

Routing is value-preserving by construction: intermediate ranks only
forward, so the received message is bitwise-identical to a direct permute.

Glossary:

- *cell*      — linear row-major index into the ``R x C`` torus.
- *placement* — rank -> cell map (default identity).  ``snake_placement``
  lays ranks boustrophedon so the rank ring ``i -> i+1`` is a hop-1 cycle.
- *route*     — dimension-ordered (rows first, minimal wrap direction)
  store-and-forward path; its length equals the Manhattan hop distance.
- *hop perm*  — a translation of the whole torus by a fixed displacement.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TorusSpec:
    """A virtual ``R x C`` torus placement with calibrated per-hop costs.

    ``shape``          — (rows, cols); ``rows * cols`` ranks are emulated.
    ``per_hop_ns``     — per-extra-hop latency for the Eq. 1 model.
    ``bisection_gbps`` — aggregate bisection bandwidth of the emulated torus.
    ``placement``      — rank -> cell (row-major linear index); identity when
                         omitted.
    ``link_slowdowns`` — degraded physical links, ``(((a, b), factor), ...)``
                         with ``a``/``b`` adjacent ranks and ``factor >= 1``;
                         a traversal of a degraded hop adds
                         ``ceil(factor) - 1`` hold rounds (values unchanged).
    ``reroute``        — when True, routing picks the cheaper dimension
                         order around degraded links.
    """
    shape: Tuple[int, int]
    per_hop_ns: float = 500.0
    bisection_gbps: float = 400.0
    placement: Optional[Tuple[int, ...]] = None
    link_slowdowns: Optional[Tuple[Tuple[Tuple[int, int], float], ...]] = None
    reroute: bool = False

    def __post_init__(self):
        rows, cols = self.shape
        if rows < 1 or cols < 1:
            raise ValueError(f"torus shape must be positive, got {self.shape}")
        object.__setattr__(self, "shape", (int(rows), int(cols)))
        if self.placement is not None:
            p = tuple(int(c) for c in self.placement)
            if sorted(p) != list(range(self.n_ranks)):
                raise ValueError(
                    f"placement must be a permutation of range({self.n_ranks})"
                    f", got {p}")
            object.__setattr__(self, "placement", p)
        if self.link_slowdowns is not None:
            canon = {}
            for (a, b), f in self.link_slowdowns:
                a, b, f = int(a), int(b), float(f)
                if f < 1.0:
                    raise ValueError(f"link slowdown must be >= 1, got {f}")
                if self.hops(a, b) != 1:
                    raise ValueError(
                        f"({a},{b}) is not a single-hop link on {self.name} "
                        f"(hops={self.hops(a, b)}); degrade physical links "
                        f"only")
                key = (min(a, b), max(a, b))
                canon[key] = max(f, canon.get(key, 1.0))
            canon = {k: f for k, f in canon.items() if f > 1.0}
            object.__setattr__(
                self, "link_slowdowns",
                tuple(sorted(canon.items())) if canon else None)

    @classmethod
    def parse(cls, text: str, **kw) -> "TorusSpec":
        """Parse the CLI spelling: ``"4x4"`` or ``"4x4:snake"``."""
        body, _, tag = text.partition(":")
        try:
            rows, cols = (int(v) for v in body.lower().split("x"))
        except ValueError:
            raise ValueError(f"torus spec must look like '4x4[:snake]', "
                             f"got {text!r}") from None
        if tag and tag != "snake":
            raise ValueError(f"unknown placement tag {tag!r} (only 'snake')")
        placement = snake_placement((rows, cols)) if tag == "snake" else None
        return cls(shape=(rows, cols), placement=placement, **kw)

    @property
    def n_ranks(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def name(self) -> str:
        """Stable human-readable identity; a custom placement carries a
        digest of its tuple so distinct placements never alias."""
        if self.placement is None:
            tag = ""
        elif self.placement == snake_placement(self.shape):
            tag = ":snake"
        else:
            digest = zlib.crc32(repr(self.placement).encode()) & 0xFFFFFF
            tag = f":p{digest:06x}"
        return f"{self.shape[0]}x{self.shape[1]}{tag}"

    def key(self) -> tuple:
        """Value identity for plan-cache keying (placement and degradation
        state included)."""
        return (self.shape, self.per_hop_ns, self.bisection_gbps,
                self.placement, self.link_slowdowns, self.reroute)

    def link_slowdown(self, a: int, b: int) -> float:
        """Slowdown factor on the physical link ``{a, b}`` (1.0 = healthy)."""
        if not self.link_slowdowns:
            return 1.0
        key = (min(int(a), int(b)), max(int(a), int(b)))
        for k, f in self.link_slowdowns:
            if k == key:
                return f
        return 1.0

    def path_cost(self, ranks: Sequence[int]) -> float:
        """Sum of per-hop slowdown factors along a rank path — the route
        comparator under ``reroute``."""
        return sum(self.link_slowdown(ranks[i], ranks[i + 1])
                   for i in range(len(ranks) - 1))

    # ------------------------------------------------------------------
    # Coordinates and distances
    # ------------------------------------------------------------------
    def cell(self, rank: int) -> int:
        return self.placement[rank] if self.placement is not None else rank

    def rank_at(self, cell: int) -> int:
        if self.placement is None:
            return cell
        return self.placement.index(cell)

    def coords(self, rank: int) -> Tuple[int, int]:
        c = self.cell(rank)
        return divmod(c, self.shape[1])

    def hops(self, src: int, dst: int) -> int:
        """Manhattan hop distance between two placed ranks."""
        rows, cols = self.shape
        (sr, sc), (dr, dc) = self.coords(src), self.coords(dst)
        dy = min((sr - dr) % rows, (dr - sr) % rows)
        dx = min((sc - dc) % cols, (dc - sc) % cols)
        return dy + dx

    def max_hops(self, edges: Sequence[Tuple[int, int]]) -> int:
        return max((self.hops(s, d) for s, d in edges), default=0)

    @property
    def diameter(self) -> int:
        """Worst-case hop distance on this torus."""
        rows, cols = self.shape
        return rows // 2 + cols // 2

    # ------------------------------------------------------------------
    # Patterns
    # ------------------------------------------------------------------
    def _displacement(self, d: int) -> Tuple[int, int]:
        """A minimal (dy, dx) with dy + dx == d."""
        rows, cols = self.shape
        if not 0 <= d <= self.diameter:
            raise ValueError(f"hop distance {d} outside [0, {self.diameter}] "
                             f"for torus {self.shape}")
        dy = min(d, rows // 2)
        dx = d - dy
        if dx > cols // 2:
            dx = cols // 2
            dy = d - dx
        return dy, dx

    def hop_perm(self, d: int) -> list[tuple[int, int]]:
        """Translation perm at exactly ``d`` hops: every rank sends to the
        rank ``d`` hops away (a bijection)."""
        rows, cols = self.shape
        dy, dx = self._displacement(d)
        perm = []
        for rank in range(self.n_ranks):
            r, c = self.coords(rank)
            dst_cell = ((r + dy) % rows) * cols + (c + dx) % cols
            perm.append((rank, self.rank_at(dst_cell)))
        return perm


def snake_placement(shape: Tuple[int, int]) -> Tuple[int, ...]:
    """Boustrophedon placement: rank ``i`` and ``i+1`` are always torus
    neighbors, so the rank ring is a hop-1 cycle (the closing edge is hop-1
    too when ``rows`` is even)."""
    rows, cols = shape
    cells = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        cells.extend(r * cols + c for c in cs)
    return tuple(cells)


# ----------------------------------------------------------------------
# Store-and-forward routing
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RouteBatch:
    """One conflict-free store-and-forward schedule: ``rounds`` are valid
    single-hop permutes (holds spelled as ``(r, r)`` self-edges); ``dests``
    are the final destinations this batch delivers to."""
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...]
    dests: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class RoutedPerm:
    """A multi-hop lowering of one edge list.

    The wire layer (:func:`repro_torch.core.streaming.wire_permute`) runs
    each batch's rounds as sequential permutes; batches merge by
    destination mask (a pure select — bitwise-exact)."""
    edges: Tuple[Tuple[int, int], ...]
    batches: Tuple[RouteBatch, ...]
    max_hops: int

    @property
    def n_rounds(self) -> int:
        return sum(len(b.rounds) for b in self.batches)


def _dim_route(spec: TorusSpec, src: int, dst: int,
               rows_first: bool) -> list[int]:
    """Minimal dimension-ordered route in the requested order (ranks
    visited, incl. endpoints), each dimension along the shorter wrap."""
    rows, cols = spec.shape
    r, c = spec.coords(src)
    tr, tc = spec.coords(dst)
    cells = [r * cols + c]

    def walk_rows():
        nonlocal r
        while r != tr:
            step = 1 if (tr - r) % rows <= (r - tr) % rows else -1
            r = (r + step) % rows
            cells.append(r * cols + c)

    def walk_cols():
        nonlocal c
        while c != tc:
            step = 1 if (tc - c) % cols <= (c - tc) % cols else -1
            c = (c + step) % cols
            cells.append(r * cols + c)

    if rows_first:
        walk_rows(), walk_cols()
    else:
        walk_cols(), walk_rows()
    return [spec.rank_at(cell) for cell in cells]


def route(spec: TorusSpec, src: int, dst: int) -> list[int]:
    """Dimension-ordered minimal route (ranks visited, incl. endpoints):
    rows first, then columns.  Under ``spec.reroute`` with degraded links
    the column-first route wins when it is strictly cheaper."""
    primary = _dim_route(spec, src, dst, rows_first=True)
    if not (spec.reroute and spec.link_slowdowns):
        return primary
    alt = _dim_route(spec, src, dst, rows_first=False)
    if spec.path_cost(alt) < spec.path_cost(primary):
        return alt
    return primary


def _lockstep_rounds(routes: Sequence[Sequence[int]]
                     ) -> Optional[list[list[tuple[int, int]]]]:
    """Schedule all routes advancing one hop per round (arrived messages hold
    via self-edges).  Returns None when two messages would ever occupy the
    same rank — the caller then splits the edge list into batches."""
    depth = max(len(r) for r in routes) - 1
    pos = [[r[min(t, len(r) - 1)] for r in routes] for t in range(depth + 1)]
    for col in pos:
        if len(set(col)) != len(col):
            return None
    return [[(pos[t][m], pos[t + 1][m]) for m in range(len(routes))]
            for t in range(depth)]


def route_rounds(spec: TorusSpec, edges: Sequence[Tuple[int, int]]
                 ) -> RoutedPerm:
    """Lower an edge list to conflict-free store-and-forward batches.

    Translation-invariant patterns schedule in ONE batch (every message
    advances in lockstep).  Irregular patterns (the SWE partition's edges)
    greedily group edges whose lockstep schedules don't collide; leftover
    edges open new batches (the emulated fabric's link contention).
    """
    edges = tuple((int(s), int(d)) for s, d in edges)
    routes = {e: route(spec, *e) for e in edges}
    batches: list[RouteBatch] = []
    pending = list(edges)
    while pending:
        batch: list[tuple[int, int]] = []
        sched: Optional[list] = None
        rest: list[tuple[int, int]] = []
        for e in pending:
            trial = _lockstep_rounds([routes[b] for b in batch] + [routes[e]])
            if trial is not None:
                batch.append(e)
                sched = trial
            else:
                rest.append(e)
        assert sched is not None  # a single route always schedules
        batches.append(RouteBatch(
            rounds=tuple(_degrade_rounds(spec, sched)),
            dests=tuple(d for _, d in batch)))
        pending = rest
    return RoutedPerm(edges=edges, batches=tuple(batches),
                      max_hops=spec.max_hops(edges))


def _degrade_rounds(spec: TorusSpec, sched: Sequence[Sequence[Tuple[int, int]]]
                    ) -> list[tuple[Tuple[int, int], ...]]:
    """Expand a lockstep schedule with ``ceil(f) - 1`` hold rounds after a
    round whose worst traversed link is slowed by factor ``f``."""
    out: list[tuple[Tuple[int, int], ...]] = []
    for rnd in sched:
        rnd = tuple(rnd)
        out.append(rnd)
        if not spec.link_slowdowns:
            continue
        worst = max((spec.link_slowdown(s, d) for s, d in rnd if s != d),
                    default=1.0)
        hold = tuple((d, d) for _, d in rnd)
        out.extend(hold for _ in range(math.ceil(worst) - 1))
    return out


def routed_perm(comm, perm: Sequence[Tuple[int, int]]):
    """The transport-facing entry point: ``perm`` unchanged when the
    communicator has no torus spec (or every edge is a healthy direct link),
    else the cached :class:`RoutedPerm` lowering."""
    spec = getattr(comm, "topo", None)
    edges = tuple((int(s), int(d)) for s, d in perm)
    if spec is None or (spec.max_hops(edges) <= 1 and not any(
            spec.link_slowdown(s, d) > 1.0 for s, d in edges if s != d)):
        return edges
    from repro_torch.core import plans
    return plans._memo("route", (spec.key(), edges),
                       lambda: route_rounds(spec, edges))
