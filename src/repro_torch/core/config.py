"""Configuration for the ACCL-X communication layer (PyTorch port).

The same configuration surface as the JAX package (paper §3):

- ``mode``       — buffered vs. streaming communication (paper §3.1).
- ``scheduling`` — host-scheduled (one launch per phase with a host sync in
                   between, the paper's l_k) vs. fused (a whole simulation
                   segment replayed as one CUDA graph).  ``overlapped``
                   additionally runs the halo exchange on a second stream
                   while the interior elements update (paper §5).
- ``transport``  — ordered ("TCP"-like: chunk i waits on chunk i - window)
                   vs. unordered ("UDP"-like: chunks independent).
- ``window``     — in-flight chunks before the next chunk waits on an ack.
- ``chunk_bytes``— chunk/segment size on the wire (jumbo-frame / MSS).
- plugins        — compression (quantized wire format) and arithmetic
                   (reduction ops) can be compiled out ("ACCL minimal").
"""
from __future__ import annotations

import dataclasses
import enum


class CommMode(str, enum.Enum):
    BUFFERED = "buffered"
    STREAMING = "streaming"


class Scheduling(str, enum.Enum):
    HOST = "host"    # one launch per phase, host sync between phases
    FUSED = "fused"  # the step (and a whole segment) as one CUDA graph
    # Fused + the exchange on a second stream: interior elements update
    # while the halo is in flight; only boundary elements wait for it.
    OVERLAPPED = "overlapped"


class Transport(str, enum.Enum):
    ORDERED = "ordered"      # TCP-like: chunk i+window depends on chunk i
    UNORDERED = "unordered"  # UDP-like: chunks independent, any-order arrival


class Compression(str, enum.Enum):
    NONE = "none"
    INT8 = "int8"    # per-block int8 wire format (4x fewer bytes vs f32)
    BF16 = "bf16"    # wire-cast to bf16 (2x fewer bytes vs f32)


class Reliability(str, enum.Enum):
    """The paper's network-stack axis: TCP (guaranteed delivery) or UDP
    (best effort).  On a clean wire both run the same program; under an
    injected fault schedule (:mod:`repro_torch.core.reliable`) GUARANTEED
    executes the retransmit protocol and BEST_EFFORT raises."""
    BEST_EFFORT = "best_effort"
    GUARANTEED = "guaranteed"


@dataclasses.dataclass(frozen=True)
class CommConfig:
    mode: CommMode = CommMode.STREAMING
    scheduling: Scheduling = Scheduling.FUSED
    transport: Transport = Transport.UNORDERED
    window: int = 4                    # in-flight chunks (ordered transport)
    chunk_bytes: int = 1 << 20         # 1 MiB wire chunks ("jumbo")
    max_chunks: int = 16               # cap on chunks per message
    compression: Compression = Compression.NONE
    # Plugin build flags — "ACCL minimal" removes both (paper Fig. 3).
    enable_compression_plugin: bool = True
    enable_arithmetic_plugin: bool = True
    # "native" = built-in collectives, "ring" = explicit permute rings
    # (required for the int8 wire format).
    algorithm: str = "native"
    # Quantization block size for the int8 wire format.
    quant_block: int = 256
    # Reliable-wire protocol parameters, validated as in the JAX package.
    reliability: Reliability = Reliability.BEST_EFFORT
    ack_timeout: int = 2       # slots without an ack before a retransmit
    max_retransmits: int = 4   # attempts per chunk before the wire "relents"
    backoff_base: int = 1      # hold slots before the 1st retransmit
    backoff_cap: int = 4       # backoff ceiling in hold slots

    def __post_init__(self):
        if self.compression != Compression.NONE and not self.enable_compression_plugin:
            raise ValueError(
                "compression requested but the compression plugin was compiled "
                "out (enable_compression_plugin=False); rebuild with the plugin "
                "enabled — mirrors an ACCL 'minimal' build lacking the feature.")
        if self.compression == Compression.INT8 and self.algorithm == "native":
            raise ValueError(
                "int8 wire compression requires algorithm='ring' (native "
                "collectives cannot carry a quantized wire format).")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.chunk_bytes < 512:
            raise ValueError("chunk_bytes must be >= 512")
        if self.ack_timeout < 1:
            raise ValueError("ack_timeout must be >= 1 slot")
        if self.max_retransmits < 1:
            raise ValueError("max_retransmits must be >= 1 (a transport that "
                             "never retransmits is BEST_EFFORT, not a "
                             "zero-retry GUARANTEED)")
        if self.backoff_base < 0:
            raise ValueError("backoff_base must be >= 0")
        if self.backoff_cap < self.backoff_base:
            raise ValueError("backoff_cap must be >= backoff_base (the cap "
                             "bounds the exponential schedule from above)")


# Paper-faithful baseline: buffered communication scheduled from the host.
BASELINE_CONFIG = CommConfig(
    mode=CommMode.BUFFERED,
    scheduling=Scheduling.HOST,
    transport=Transport.ORDERED,
    window=1,
    chunk_bytes=1 << 16,
    compression=Compression.NONE,
    algorithm="native",
)

# The paper's best configuration: streaming + fused scheduling + tuned
# transport (window scaling + jumbo frames).
OPTIMIZED_CONFIG = CommConfig(
    mode=CommMode.STREAMING,
    scheduling=Scheduling.FUSED,
    transport=Transport.UNORDERED,
    window=8,
    chunk_bytes=1 << 20,
    compression=Compression.NONE,
    algorithm="native",
)

# The §5 configuration that scales to 48 FPGAs: streaming delivery plus an
# overlapped halo exchange.
OVERLAPPED_CONFIG = CommConfig(
    mode=CommMode.STREAMING,
    scheduling=Scheduling.OVERLAPPED,
    transport=Transport.UNORDERED,
    window=8,
    chunk_bytes=1 << 20,
    compression=Compression.NONE,
    algorithm="native",
)

# ACCL "minimal" build: plugins compiled out.
MINIMAL_CONFIG = CommConfig(
    mode=CommMode.STREAMING,
    scheduling=Scheduling.FUSED,
    transport=Transport.UNORDERED,
    enable_compression_plugin=False,
    enable_arithmetic_plugin=False,
)


# Eq. 1 wire constants of one H100 (NVIDIA H100 80GB HBM3, 700 W power
# limit), fitted by ``tune.calibrate.fit_latency_model`` on the card's
# sendrecv sweeps (8 ranks, FULL_SIZES, every candidate):
# - the per-hop latency on the 2x4-torus sweep at hop distances 1, 2, 3
#   (``python -m repro_torch.tune.sweep --collectives sendrecv --topology 2x4
#   --hop-distances 1,2,3 --calibrate``, 384 points);
# - the rest on the flat sweep (``python -m repro_torch.tune.sweep
#   --calibrate``, 128 points, its one hop distance priced at the above).
# The fits are poor (rms relative error 1.75 and 3.17): Eq. 1 charges one
# link latency to every message, while on one card a graph-replayed permute
# takes ~10 us and a host-synchronized one ~200 us.
WIRE_BW = 33.91e9            # B/s
WIRE_LATENCY = 8.79e-6       # s
WIRE_HOP_LATENCY = 53.49e-6  # s
HOST_DISPATCH = 65.2e-6      # s
FUSED_DISPATCH = 0.519e-6    # s


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline and wire constants of the card the port runs on (Eq. 1-3).

    The defaults describe one NVIDIA H100 SXM5 80 GB.  The compute and
    memory figures are NVIDIA's data-sheet values.  The ``ici_*`` and
    dispatch fields describe the port's "wire" — a permute of the stacked
    rank dimension in device memory — and are the fitted constants above.
    Of the JAX spec's fields, this one keeps those the latency model reads:
    the cross-card (``dcn_*``) and memory-size fields come with the slices
    that read them.
    The paper's equivalents: link peak 12.5 GB/s (100 Gb/s QSFP),
    global-memory copy bandwidth 14 GB/s, XRT kernel launch l_k = 30 us.
    """
    name: str = "h100-sxm"
    peak_flops: float = 989e12          # dense bf16 FLOP/s (data sheet)
    hbm_bw: float = 3.35e12             # B/s HBM3 (data sheet)
    ici_bw: float = WIRE_BW             # B/s of a rank permute (fitted)
    ici_latency: float = WIRE_LATENCY   # s per message (fitted)
    # s per extra virtual-torus hop: one more routed permute (fitted)
    ici_hop_latency: float = WIRE_HOP_LATENCY
    # Command scheduling costs (the paper's l_k), fitted:
    host_dispatch: float = HOST_DISPATCH    # s per eager op + host sync
    fused_dispatch: float = FUSED_DISPATCH  # s per op replayed in a graph


H100 = HardwareSpec()
