"""Latency and throughput models — the paper's Equations 1–3 on one H100.

Paper (FPGA)                         Here (stacked ranks on one card)
----------------------------------   ------------------------------------------
l_k  XRT kernel invocation ~30 µs    an eager launch plus host sync (host
                                     scheduling) or one op replayed inside a
                                     CUDA graph (fused scheduling)
l_m  copy via global memory          device-memory staging copy (buffered
                                     receive)
l_c  QSFP link latency + size/bw     one rank permute (+ one more permute per
                                     extra virtual-torus hop) + size/bw

Eq. 1  buffered : L = 2·l_k + l_m + l_c
       streaming: L = l_k + l_c
Eq. 2  throughput = f · FLOP_total /
         (max(E_core + D_ext, L_comm·f) + E_send + E_recv + L_pipe)
Eq. 3  L_comm = (E_send + E_recv + 2·N_max·l_k·f + N_max·l_m·f)/f + L_pingping

Pure Python, the same functions as the JAX package's ``core/latmodel.py``;
the default :class:`~repro_torch.core.config.HardwareSpec` is the H100's.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.config import (CommConfig, CommMode, Compression,
                                     H100, HardwareSpec, Reliability,
                                     Scheduling)


def wire_bytes(msg_bytes: int, cfg: CommConfig) -> float:
    """Bytes on the wire after the compression plugin (int8: payload/4 of f32
    + per-block f32 scales; bf16: /2)."""
    if cfg.compression == Compression.INT8:
        elems = msg_bytes / 4.0  # wire format defined relative to f32 payloads
        return elems * 1.0 + (elems / cfg.quant_block) * 4.0
    if cfg.compression == Compression.BF16:
        return msg_bytes / 2.0
    return float(msg_bytes)


def l_k(cfg: CommConfig, hw: HardwareSpec = H100) -> float:
    """Command-scheduling latency: the paper's 30 µs (host) vs sub-µs (PL)."""
    return hw.host_dispatch if cfg.scheduling == Scheduling.HOST else hw.fused_dispatch


def n_commands(msg_bytes: int, cfg: CommConfig) -> float:
    """Scheduled commands per transfer — the Eq. 3 'one more scheduled
    command' term, applied at wire-chunk granularity.

    Buffered mode moves the whole message through the staging buffer: two
    commands (write + read-back), independent of segmentation.  Streaming
    mode issues one command per wire chunk (``num_chunks``), which is what
    prices small segments out at multi-MiB messages — the paper's
    segmentation/jumbo-frame trade-off."""
    if cfg.mode == CommMode.BUFFERED:
        return 2.0
    return float(max(1, min(cfg.max_chunks,
                            math.ceil(max(1, msg_bytes) / cfg.chunk_bytes))))


def l_m(msg_bytes: int, hw: HardwareSpec = H100) -> float:
    """Staging copy through HBM (write + read back)."""
    return 2.0 * msg_bytes / hw.hbm_bw


def l_c(msg_bytes: int, cfg: CommConfig, hw: HardwareSpec = H100,
        hops: int = 1) -> float:
    """Link latency: first-hop latency + per-extra-hop penalty + serialization."""
    lat = hw.ici_latency + max(0, hops - 1) * hw.ici_hop_latency
    return lat + wire_bytes(msg_bytes, cfg) / hw.ici_bw


def expected_retransmit_factor(cfg: CommConfig, loss: float) -> float:
    """Expected wire slots per chunk under per-transmission loss rate
    ``loss`` — the reliability layer's Eq. 1 term.

    A chunk that fails its first ``k`` transmissions costs, beyond the one
    lossless slot, ``k`` retransmission slots plus each retry's ack-timeout
    wait and capped-exponential backoff holds
    (``reliable.backoff_holds`` in the JAX package).  Summing over the loss
    geometric series (truncated at ``max_retransmits`` — the emulated wire
    relents within the cap):

        E[slots] = 1 + sum_{k>=1} p^k (ack_timeout + backoff(k) + 1)

    BEST_EFFORT has no protocol, so loss never costs it slots (it costs it
    the delivery guarantee instead); the factor is 1.0.  This is what makes
    ``select_config`` answer "jumbo frames win clean links, small segments
    win lossy ones": the factor multiplies *per-chunk* serialization, and a
    buffered/jumbo transfer re-pays its whole message per retransmit while
    small segments only re-pay the lost chunk.
    """
    if loss <= 0.0 or cfg.reliability != Reliability.GUARANTEED:
        return 1.0
    if not 0.0 <= loss < 1.0:
        raise ValueError(f"loss rate must be in [0, 1), got {loss}")
    factor = 1.0
    for k in range(1, cfg.max_retransmits + 1):
        backoff = min(cfg.backoff_base * (2 ** (k - 1)), cfg.backoff_cap)
        factor += (loss ** k) * (cfg.ack_timeout + backoff + 1.0)
    return factor


def pingping_latency(msg_bytes: int, cfg: CommConfig, hw: HardwareSpec = H100,
                     hops: int = 1, loss: float = 0.0) -> float:
    """Eq. 1 with the multi-hop route term.  At ``hops == 1`` this is the
    classic model; a routed ``h``-hop edge (the virtual torus transport's
    store-and-forward lowering) additionally pays:

    - buffered : the whole message re-serializes at every hop —
      ``h x wire/bw`` (each intermediate stages the full message before
      forwarding);
    - streaming: wire chunks *wormhole* through the route — chunk pipelining
      across hops occupies the wire for ``(n_chunks + h - 1)`` chunk slots,
      so small segments amortize the route depth while a single jumbo chunk
      pays ``h`` full serializations.

    This hop x segmentation interaction is what makes the per-edge winner
    hop-dependent (the paper's direct-link vs routed distinction): jumbo
    chunks win direct links (fewer scheduled commands), small chunks win
    long routes (pipelining) — and it mirrors what the emulated transport
    physically executes (one permute per chunk per hop).

    ``loss`` prices the GUARANTEED reliability protocol on a lossy wire:
    per-chunk serialization (and its scheduled command) is multiplied by
    :func:`expected_retransmit_factor` — buffered mode's single jumbo
    "chunk" re-pays the whole message per retransmit, streaming re-pays one
    segment, which flips the jumbo-vs-segment winner as loss grows.
    """
    h = max(1, hops)
    lat = hw.ici_latency + (h - 1) * hw.ici_hop_latency
    wire = wire_bytes(msg_bytes, cfg)
    rf = expected_retransmit_factor(cfg, loss)
    if cfg.mode == CommMode.BUFFERED:
        return (2.0 * l_k(cfg, hw) + l_m(msg_bytes, hw) + lat
                + rf * h * wire / hw.ici_bw)
    # Streaming: no staging copy; every chunk is one scheduled command
    # (n_commands — sub-µs fused on real hardware, dominant on host-CPU
    # substrates), and chunks pipeline across the route's hops.
    n = n_commands(msg_bytes, cfg)
    return (rf * n * l_k(cfg, hw) + lat
            + rf * (n + h - 1) * (wire / n) / hw.ici_bw)


def effective_bandwidth(msg_bytes: int, cfg: CommConfig,
                        hw: HardwareSpec = H100, hops: int = 1,
                        loss: float = 0.0) -> float:
    """B/s delivered for a message of msg_bytes (the b_eff metric)."""
    return msg_bytes / pingping_latency(msg_bytes, cfg, hw, hops, loss=loss)


def buffered_peak_bw(hw: HardwareSpec = H100) -> float:
    """Series-bandwidth cap of buffered mode: (1/bw_link + 1/bw_mem)^-1.

    Paper: (1/12.5 + 1/14)^-1 GB/s = 6.6 GB/s.  Here: device-memory staging
    (write + read = hbm_bw/2 effective) in series with the wire.
    """
    return 1.0 / (1.0 / hw.ici_bw + 2.0 / hw.hbm_bw)


# ----------------------------------------------------------------------
# Application model (shallow water, Eq. 2/3)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SWEWorkload:
    """Static description of one partition's work per timestep (in elements
    and cycles, as the paper counts them)."""
    e_total: int        # total mesh elements (global)
    e_core: int         # core elements on the critical partition
    e_send: int         # elements sent per step (largest sender)
    e_recv: int         # elements received per step
    d_ext: int          # extra pipeline cycles for external data projection
    l_pipe: int         # pipeline fill depth (cycles)
    n_max: int          # max neighbor count over partitions
    flop_per_element: float
    freq: float         # kernel clock f (element rate, elements/s)
    msg_bytes: int      # largest single halo message


def eq3_l_comm(w: SWEWorkload, cfg: CommConfig, hw: HardwareSpec = H100,
               hops: int = 1) -> float:
    """Eq. 3 — seconds of communication latency on the critical partition."""
    per_element = (w.e_send + w.e_recv) / w.freq
    sched = 2.0 * w.n_max * l_k(cfg, hw)
    staging = w.n_max * (l_m(w.msg_bytes, hw) if cfg.mode == CommMode.BUFFERED else 0.0)
    return per_element + sched + staging + pingping_latency(w.msg_bytes, cfg, hw, hops)


def eq2_throughput(w: SWEWorkload, cfg: CommConfig, hw: HardwareSpec = H100,
                   hops: int = 1) -> float:
    """Eq. 2 — modeled FLOP/s for the partitioned simulation."""
    l_comm_cycles = eq3_l_comm(w, cfg, hw, hops) * w.freq
    denom_cycles = (max(w.e_core + w.d_ext, l_comm_cycles)
                    + w.e_send + w.e_recv + w.l_pipe)
    flop_total = w.flop_per_element * w.e_total
    return w.freq * flop_total / denom_cycles


def overlap_fraction(cfg: CommConfig) -> float:
    """Fraction of L_comm the step *structure* can hide behind interior
    compute (the §5 overlap term).

    Eq. 2's ``max(E_core, L_comm)`` assumes perfect hiding; in practice the
    fused step fences the element update on the whole exchange, so only
    chunk-level pipelining overlaps.  The overlapped schedule's
    interior/boundary split makes the interior update independent of the
    exchange — full hiding.  Host scheduling serializes everything.
    """
    if cfg.scheduling == Scheduling.OVERLAPPED:
        return 1.0
    if cfg.scheduling == Scheduling.FUSED:
        # chunk pipelining inside the exchange, but the update still fences
        return 0.6 if cfg.mode == CommMode.STREAMING else 0.3
    return 0.0


def eq2_throughput_overlap(w: SWEWorkload, cfg: CommConfig,
                           hw: HardwareSpec = H100, hops: int = 1) -> float:
    """Eq. 2 with the explicit overlap term: the exposed step time
    interpolates between fully serialized (compute + L_comm) and fully
    hidden (max(compute, L_comm)) by :func:`overlap_fraction`.

    This is the term that moves the strong-scaling knee: under the
    overlapped schedule the throughput stays compute-bound until L_comm
    itself exceeds the interior work, instead of degrading as soon as the
    exchange stops fitting under the chunk pipeline.
    """
    l_comm_cycles = eq3_l_comm(w, cfg, hw, hops) * w.freq
    compute_cycles = w.e_core + w.d_ext
    ov = overlap_fraction(cfg)
    exposed = (ov * max(compute_cycles, l_comm_cycles)
               + (1.0 - ov) * (compute_cycles + l_comm_cycles))
    denom_cycles = exposed + w.e_send + w.e_recv + w.l_pipe
    flop_total = w.flop_per_element * w.e_total
    return w.freq * flop_total / denom_cycles


def e2e_consumer_latency(msg_bytes: int, cfg: CommConfig, compute_s: float,
                         hw: HardwareSpec = H100, hops: int = 1,
                         loss: float = 0.0) -> float:
    """Overlap-aware Eq. 2 applied to a consumer loop: predicted seconds per
    iteration of (hideable compute + collective) under ``cfg``.

    The exposed time interpolates between fully hidden —
    ``max(compute, comm)`` — and fully serialized — ``compute + comm`` — by
    :func:`overlap_fraction`: ``ov·max(comm, compute) + (1−ov)·(comm +
    compute)``.  This is the prediction behind the autotuner's ``e2e``
    objective (§5: the config that wins the bare-latency microbench is not
    the one that scales the consuming kernel), and what lets ``tune.prune``
    rank candidates end-to-end without measuring them.
    """
    comm_s = pingping_latency(msg_bytes, cfg, hw, hops, loss=loss)
    ov = overlap_fraction(cfg)
    return ov * max(compute_s, comm_s) + (1.0 - ov) * (compute_s + comm_s)


def stall_fraction(w: SWEWorkload, cfg: CommConfig, hw: HardwareSpec = H100,
                   hops: int = 1) -> float:
    """Fraction of the step spent stalled on communication (paper: 75–80 %
    for the MPI+PCIe baseline at ~6000 elements/partition).

    Assumes the perfect-hiding ``max()`` of the plain Eq. 2; pair it with
    :func:`eq2_throughput`.  The overlap-aware counterpart (pair with
    :func:`eq2_throughput_overlap`) is :func:`stall_fraction_overlap`.
    """
    l_comm_cycles = eq3_l_comm(w, cfg, hw, hops) * w.freq
    compute_cycles = w.e_core + w.d_ext
    total = max(compute_cycles, l_comm_cycles) + w.e_send + w.e_recv + w.l_pipe
    return max(0.0, l_comm_cycles - compute_cycles) / total


def stall_fraction_overlap(w: SWEWorkload, cfg: CommConfig,
                           hw: HardwareSpec = H100, hops: int = 1) -> float:
    """Stall fraction under the same exposed-time model as
    :func:`eq2_throughput_overlap`: the share of the step spent on
    communication the schedule could not hide behind interior compute."""
    l_comm_cycles = eq3_l_comm(w, cfg, hw, hops) * w.freq
    compute_cycles = w.e_core + w.d_ext
    ov = overlap_fraction(cfg)
    exposed = (ov * max(compute_cycles, l_comm_cycles)
               + (1.0 - ov) * (compute_cycles + l_comm_cycles))
    total = exposed + w.e_send + w.e_recv + w.l_pipe
    return (exposed - compute_cycles) / total


# ----------------------------------------------------------------------
# Roofline terms
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """dominant / sum — 1.0 means perfectly bound by one resource
        (no wasted time on the others if fully overlapped)."""
        s = self.compute_s + self.memory_s + self.collective_s
        return self.bound_s / s if s > 0 else 0.0


def roofline_terms(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
                   n_chips: int, hw: HardwareSpec = H100) -> RooflineTerms:
    """The three-term roofline of the assignment.

    ``hlo_flops``/``hlo_bytes`` are the program's operation and byte totals
    per device (the JAX package's names, which take them from XLA's cost
    analysis); ``collective_bytes`` is the summed operand size of its
    collectives.
    """
    return RooflineTerms(
        compute_s=hlo_flops / (n_chips * hw.peak_flops),
        memory_s=hlo_bytes / (n_chips * hw.hbm_bw),
        collective_s=collective_bytes / (n_chips * hw.ici_bw),
    )
