"""Search-space enumeration for the ACCL-X autotuner.

The tunable surface is the full ``CommConfig`` cross product:

    mode x scheduling x transport x window x chunk_bytes x compression
         x algorithm

Most of that product is either invalid (``CommConfig.__post_init__`` rejects
it — e.g. int8 wire compression with native collectives) or redundant
(``window`` is only consulted by the ordered transport; ``algorithm`` is only
consulted by collectives, not point-to-point ops).  This module enumerates the
*valid, non-redundant* candidates so the sweep engine never burns wall clock
measuring a configuration twice.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

from repro_torch.core.config import (CommConfig, CommMode, Compression,
                                     Reliability, Scheduling, Transport)

# Default tuning axes.  ``window``/``chunk_bytes`` follow the paper's §3.3
# transport tuning (window scaling, jumbo frames); the rest is the §3.1/§3.2
# mode/scheduling/plugin surface.
DEFAULT_AXES: dict[str, tuple] = {
    "mode": tuple(CommMode),
    "scheduling": tuple(Scheduling),
    "transport": tuple(Transport),
    "window": (1, 4, 8),
    "chunk_bytes": (1 << 16, 1 << 20),
    "compression": tuple(Compression),
    "algorithm": ("native", "ring"),
}

# A trimmed space for --fast smoke sweeps: the paper's four named corner
# configurations plus the ring-algorithm variant and both segment sizes
# (64 KiB vs jumbo 1 MiB — the axis the pruning model separates).
FAST_AXES: dict[str, tuple] = {
    "mode": tuple(CommMode),
    "scheduling": tuple(Scheduling),
    "transport": (Transport.UNORDERED,),
    "window": (4,),
    "chunk_bytes": (1 << 16, 1 << 20),
    "compression": (Compression.NONE,),
    "algorithm": ("native", "ring"),
}

# Which config fields a collective's implementation actually reads.  Fields
# not listed are irrelevant for that collective and get canonicalized to the
# CommConfig default so enumeration does not emit behavioural duplicates.
_RELEVANT_FIELDS: dict[str, frozenset[str]] = {
    # Point-to-point: streaming.chunked/buffered_permute read mode, transport,
    # window, chunk_bytes; scheduling decides dispatch granularity.
    "sendrecv": frozenset(
        {"mode", "scheduling", "transport", "window", "chunk_bytes"}),
    "multi_neighbor": frozenset(
        {"mode", "scheduling", "transport", "window", "chunk_bytes"}),
    # Collectives: algorithm + compression select the implementation; ring
    # algorithms additionally honor the point-to-point wire fields.
    "all_reduce": frozenset(
        {"mode", "scheduling", "transport", "window", "chunk_bytes",
         "compression", "algorithm"}),
    "all_gather": frozenset(
        {"mode", "scheduling", "transport", "window", "chunk_bytes",
         "compression", "algorithm"}),
    "reduce_scatter": frozenset(
        {"mode", "scheduling", "transport", "window", "chunk_bytes",
         "compression", "algorithm"}),
    # all_to_all: chunked-overlap delivery (streaming + overlapped) reads the
    # wire fields; fused/host execution reads only scheduling + compression.
    "all_to_all": frozenset(
        {"mode", "scheduling", "transport", "window", "chunk_bytes",
         "compression"}),
}

_DEFAULTS = CommConfig()

# Collectives with an e2e consumer-loop benchmark whose *consumer* reads
# Scheduling.OVERLAPPED even though the bare collective executes identically
# to fused (the double-buffered halo fold; see sweep.CONSUMERS).  Under the
# e2e objective the overlapped variants must stay distinct candidates — the
# paper's §5 finding is that the microbench cannot rank them but the
# consumer loop can.  all_reduce's consumers (the tensor-parallel layers and
# the serving phases) come with the port's LM path.
CONSUMER_COLLECTIVES = frozenset({"multi_neighbor"})


def _canonicalize(cfg: CommConfig, collective: str | None,
                  objective: str = "latency") -> CommConfig:
    """Collapse fields a collective (or the config itself) never reads."""
    updates: dict = {}
    if collective is not None:
        relevant = _RELEVANT_FIELDS.get(collective)
        if relevant is not None:
            for f in DEFAULT_AXES:
                if f not in relevant:
                    updates[f] = getattr(_DEFAULTS, f)
    merged = dataclasses.replace(cfg, **updates) if updates else cfg
    # The retransmit/timeout/backoff knobs are only consulted by the
    # GUARANTEED protocol; best-effort configs differing only in them are
    # the same program.
    if merged.reliability == Reliability.BEST_EFFORT:
        merged = dataclasses.replace(
            merged, ack_timeout=_DEFAULTS.ack_timeout,
            max_retransmits=_DEFAULTS.max_retransmits,
            backoff_base=_DEFAULTS.backoff_base,
            backoff_cap=_DEFAULTS.backoff_cap)
    # window is only consulted when chunks form an ack chain (ordered
    # transport) or by the GUARANTEED send window; best-effort unordered
    # configs differing only in window are identical.
    if (merged.transport == Transport.UNORDERED
            and merged.reliability == Reliability.BEST_EFFORT
            and merged.window != _DEFAULTS.window):
        merged = dataclasses.replace(merged, window=_DEFAULTS.window)
    # Overlapped scheduling only changes behaviour for the multi-round halo
    # exchange (double-buffered delivery) and the chunk-tiled all_to_all
    # (streaming delivery only); every other collective executes the
    # overlapped config exactly like the fused one, so collapse it and
    # never measure the duplicate.
    if merged.scheduling == Scheduling.OVERLAPPED:
        keep_overlapped = (objective == "e2e"
                           and collective in CONSUMER_COLLECTIVES)
        if collective == "all_to_all" and merged.mode != CommMode.STREAMING:
            # buffered all_to_all has no wire chunks to tile: same program
            merged = dataclasses.replace(merged, scheduling=Scheduling.FUSED)
        elif (collective not in (None, "multi_neighbor", "all_to_all")
              and not keep_overlapped):
            merged = dataclasses.replace(merged, scheduling=Scheduling.FUSED)
        elif (collective == "multi_neighbor"
              and merged.mode == CommMode.BUFFERED
              and merged.window != _DEFAULTS.window):
            # buffered rounds have no wire chunks: the double-buffered path
            # chains whole rounds per buffer and never reads the ack window.
            # STREAMING rounds DO read it (pipelined_consume chains chunk i
            # on chunk i-window), so those variants stay distinct.
            merged = dataclasses.replace(merged, window=_DEFAULTS.window)
    if (collective == "all_to_all"
            and merged.scheduling != Scheduling.OVERLAPPED):
        # without chunked-overlap delivery the wire fields are never read
        merged = dataclasses.replace(
            merged, mode=_DEFAULTS.mode, transport=_DEFAULTS.transport,
            window=_DEFAULTS.window, chunk_bytes=_DEFAULTS.chunk_bytes)
    return merged


def enumerate_configs(collective: str | None = None,
                      axes: dict[str, Sequence] | None = None,
                      fast: bool = False,
                      objective: str = "latency") -> list[CommConfig]:
    """All valid, deduplicated ``CommConfig`` candidates for ``collective``.

    Invalid combinations are pruned by attempting construction — the single
    source of truth for validity is ``CommConfig.__post_init__`` itself, so
    the search space can never drift from the config's rules.

    ``objective="e2e"`` keeps candidates distinct when the collective's
    *consumer loop* distinguishes them even though the bare collective does
    not (overlapped scheduling for :data:`CONSUMER_COLLECTIVES`).
    """
    if axes is None:
        axes = FAST_AXES if fast else DEFAULT_AXES
    names = list(axes)
    seen: set[CommConfig] = set()
    out: list[CommConfig] = []
    for combo in itertools.product(*(axes[n] for n in names)):
        try:
            cfg = CommConfig(**dict(zip(names, combo)))
            # Canonicalization can itself produce an invalid combo (e.g.
            # resetting an irrelevant algorithm='ring' to 'native' while
            # int8 compression stays relevant) — prune those too.
            cfg = _canonicalize(cfg, collective, objective)
        except ValueError:
            continue
        if cfg in seen:
            continue
        seen.add(cfg)
        out.append(cfg)
    return out


def space_size(axes: dict[str, Sequence] | None = None) -> int:
    """Raw (unpruned) cross-product size — for reporting pruning ratios."""
    if axes is None:
        axes = DEFAULT_AXES
    n = 1
    for vals in axes.values():
        n *= len(vals)
    return n


# ----------------------------------------------------------------------
# CommConfig <-> JSON-safe dict (the TuneDB wire format)
# ----------------------------------------------------------------------

_ENUM_FIELDS = {"mode": CommMode, "scheduling": Scheduling,
                "transport": Transport, "compression": Compression,
                "reliability": Reliability}


def config_to_dict(cfg: CommConfig) -> dict:
    d = dataclasses.asdict(cfg)
    for f in _ENUM_FIELDS:
        d[f] = d[f].value if isinstance(d[f], _ENUM_FIELDS[f]) else str(d[f])
    return d


def config_from_dict(d: dict) -> CommConfig:
    kw = dict(d)
    for f, enum_cls in _ENUM_FIELDS.items():
        if f in kw:
            kw[f] = enum_cls(kw[f])
    return CommConfig(**kw)
