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
    (best effort).  The port has no fault injection yet, so a GUARANTEED
    config runs the fast path, as the JAX package does on a clean wire."""
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
