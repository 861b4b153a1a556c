"""Collective-plan cache — build a schedule once, replay it.

ACCL+ holds a precompiled *plan* in the collective engine that applications
replay call after call.  This module is that cache for the port: a
:class:`CommPlan` built once per ``(collective, communicator key, CommConfig,
shape/dtype)`` captures what the comm layer derives on the host —

- the :func:`~repro_torch.core.streaming.aligned_chunks` wire-chunk layout,
- the greedy edge-coloring of a multi-neighbor exchange into permute rounds,
- ring/neighbor permutations (validated once, replayed as tuples),
- the ack-window dependency structure of ordered transport,
- the reliable wire's delivery plans (kind ``"wire"``,
  :func:`repro_torch.core.reliable.delivery_plan`).

Everything here is host-side Python holding static schedule data (and the
small index tensors the wire derives from it), so cached and uncached
execution are bitwise-identical by construction.  The cache lives in memory
for the life of the process — a captured CUDA graph reads those index
tensors by address, so entries are never dropped; keys are full value
tuples, so a change to the config, the communicator, the payload shape or
dtype, or the pattern produces a different key.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import threading
from typing import Any, Callable, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics

_LOCK = threading.RLock()
_CACHE: dict[tuple, Any] = {}
# Lookup sentinel: a cached value may legitimately be falsy or None.
_MISSING = object()
_STAT_NAMES = ("plan_hits", "plan_misses")
_STATS = {k: obs_metrics.registry().counter(f"plans.{k}")
          for k in _STAT_NAMES}


def _comm_key(comm) -> tuple:
    """Stable identity of a communicator: its axes, their sizes and any
    virtual torus placed on it.  Accepts a Communicator, a plain axis-name
    tuple/str, or None."""
    if comm is None:
        return ()
    if hasattr(comm, "axis_names"):
        topo = getattr(comm, "topo", None)
        return (tuple(comm.axis_names), tuple(getattr(comm, "axis_sizes", ())),
                topo.key() if topo is not None else None)
    if isinstance(comm, str):
        return ((comm,), ())
    return (tuple(comm), ())


def _cfg_key(cfg) -> tuple:
    """Canonical identity of a CommConfig: ``(name, primitive)`` pairs with
    enum members folded to their string values."""
    if cfg is None:
        return ()
    out: list = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = v.value
        out.append((f.name, v))
    return tuple(out)


def _memo(kind: str, key: tuple, build: Callable[[], Any]):
    full = (kind,) + key
    # Hold the (reentrant) lock across lookup AND build so concurrent
    # same-key callers neither build twice nor double-count the miss.
    with _LOCK:
        cached = _CACHE.get(full, _MISSING)
        if cached is not _MISSING:
            _STATS["plan_hits"].inc()
            return cached
        value = build()
        _STATS["plan_misses"].inc()
        _CACHE[full] = value
        return value


# ----------------------------------------------------------------------
# Schedule fragments
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Wire-chunk layout of one streamed message: how many chunks, how many
    flat elements each, and which earlier chunk every chunk acks on
    (``-1`` = independent — unordered transport or inside the window)."""
    n_chunks: int
    chunk_elems: int
    ack_of: tuple[int, ...]

    @property
    def padded_elems(self) -> int:
        return self.n_chunks * self.chunk_elems


def _build_chunk_plan(size: int, itemsize: int, chunk_bytes: int,
                      max_chunks: int, ordered: bool, window: int,
                      align: int, equal_split: bool) -> ChunkPlan:
    nbytes = size * itemsize
    n = max(1, min(max_chunks, math.ceil(max(1, nbytes) / chunk_bytes)))
    per = max(1, math.ceil(size / n))
    if equal_split:
        # chunked_permute layout: exactly n equal chunks (zero-padded tail).
        chunk_elems = per
    else:
        # recv_slot-aligned layout: chunk boundaries land on `align`
        # multiples, so the chunk count may shrink below n.
        chunk_elems = max(align, math.ceil(per / align) * align)
        n = max(1, math.ceil(size / chunk_elems))
    ack = tuple((i - window) if (ordered and i >= window) else -1
                for i in range(n))
    return ChunkPlan(n_chunks=n, chunk_elems=chunk_elems, ack_of=ack)


def chunk_plan(shape: Sequence[int], dtype, cfg, align: int = 1,
               equal_split: bool = False) -> ChunkPlan:
    """Cached wire-chunk layout plus the ordered-transport ack structure for
    ONE rank's message of ``shape``/``dtype`` (a ``torch.dtype``).

    ``equal_split=True`` reproduces the plain ``chunked_permute`` split
    (exactly ``num_chunks`` equal chunks); the default reproduces the
    ``align``-aware layout of ``aligned_chunks``."""
    size = int(math.prod(shape)) if shape else 1
    from repro_torch.core.config import Transport
    ordered = cfg.transport == Transport.ORDERED
    key = (size, str(dtype), cfg.chunk_bytes, cfg.max_chunks, ordered,
           cfg.window, align, equal_split)
    return _memo("chunks", key,
                 lambda: _build_chunk_plan(size, dtype.itemsize,
                                           cfg.chunk_bytes, cfg.max_chunks,
                                           ordered, cfg.window, align,
                                           equal_split))


def _color_edges(edges: Sequence[tuple[int, int]]
                 ) -> tuple[tuple[tuple[int, int], ...], ...]:
    """Greedy edge coloring into permute-able rounds (each round a valid
    permutation fragment).  The round count is Eq. 3's N_max."""
    rounds: list[list[tuple[int, int]]] = []
    for e in edges:
        placed = False
        for r in rounds:
            if all(e[0] != s and e[1] != d for s, d in r):
                r.append(tuple(e))
                placed = True
                break
        if not placed:
            rounds.append([tuple(e)])
    return tuple(tuple(r) for r in rounds)


def edge_rounds(edges: Sequence[tuple[int, int]]
                ) -> tuple[tuple[tuple[int, int], ...], ...]:
    """Cached greedy edge-coloring of a neighbor list into rounds."""
    key = (tuple((int(s), int(d)) for s, d in edges),)
    return _memo("rounds", key, lambda: _color_edges(edges))


def ring_perm(n: int, step: int = 1) -> tuple[tuple[int, int], ...]:
    """Cached ring permutation for an ``n``-rank communicator."""
    return _memo("ring", (n, step),
                 lambda: tuple((i, (i + step) % n) for i in range(n)))


def validated_perm(comm, perm: Sequence[tuple[int, int]]
                   ) -> tuple[tuple[int, int], ...]:
    """Cached neighbor-perm validation: each rank sends at most once and all
    endpoints are inside the communicator.  Raises the same ``ValueError`` as
    ``Communicator.neighbor_perms`` on the first (and only) derivation."""
    edges = tuple((int(s), int(d)) for s, d in perm)
    ck = _comm_key(comm)

    def build():
        comm.neighbor_perms(edges)
        return edges

    return _memo("perm", (ck, edges), build)


# ----------------------------------------------------------------------
# The aggregate plan
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommPlan:
    """One collective call's replayable schedule, built once per
    ``(collective, communicator key, CommConfig, shape/dtype)`` [+ pattern
    extras]."""
    collective: str
    comm_key: tuple
    cfg_key: tuple
    shape: tuple
    dtype: str
    chunks: Optional[ChunkPlan] = None
    perms: tuple = ()                  # validated (src, dst) tuples per round


def get_plan(collective: str, comm, cfg, shape: Sequence[int], dtype,
             rounds: Sequence[Sequence[tuple[int, int]]],
             align: int = 1) -> CommPlan:
    """Fetch (or build) the :class:`CommPlan` for one collective call site.

    ``shape`` is ONE rank's payload shape.  ``rounds`` is the (already
    colored) round structure: each round is validated once against ``comm``
    and replayed as ``plan.perms``; ``align`` keys the recv_slot-aligned
    chunk layout."""
    ck = _comm_key(comm)
    fk = _cfg_key(cfg)
    shape = tuple(int(s) for s in shape)
    dt = str(dtype)
    rk = tuple(tuple((int(s), int(d)) for s, d in r) for r in rounds)
    key = (collective, ck, fk, shape, dt, align, rk)

    def build() -> CommPlan:
        from repro_torch.core.config import CommMode, Transport
        chunks = None
        if cfg.mode == CommMode.STREAMING:
            chunks = _build_chunk_plan(
                int(math.prod(shape)) if shape else 1,
                dtype.itemsize, cfg.chunk_bytes, cfg.max_chunks,
                cfg.transport == Transport.ORDERED, cfg.window, align,
                equal_split=False)
        for r in rk:
            comm.neighbor_perms(r)
        return CommPlan(collective=collective, comm_key=ck, cfg_key=fk,
                        shape=shape, dtype=dt, chunks=chunks, perms=rk)

    return _memo("plan", key, build)
