"""ACCL-X — the paper's communication framework, ported to PyTorch.

Public API:
    CommConfig / CommMode / Scheduling / Transport / Compression
    Communicator
    collectives: sendrecv, multi_neighbor_exchange, edge_color_rounds
    streaming:   chunked_permute, buffered_permute, pipelined_consume,
                 double_buffered_exchange
    plans:       CommPlan cache (schedules derived once, replayed per call)
    topology:    TorusSpec virtual multi-hop torus placement + routed transport
"""
from repro_torch.core.config import (
    BASELINE_CONFIG, MINIMAL_CONFIG, OPTIMIZED_CONFIG, OVERLAPPED_CONFIG,
    CommConfig, CommMode, Compression, Scheduling, Transport,
)
from repro_torch.core.communicator import Communicator
from repro_torch.core.topology import TorusSpec
from repro_torch.core import (collectives, plans, plugins, streaming,
                              topology)

__all__ = [
    "BASELINE_CONFIG", "MINIMAL_CONFIG", "OPTIMIZED_CONFIG",
    "OVERLAPPED_CONFIG", "CommConfig", "CommMode", "Compression",
    "Scheduling", "Transport", "Communicator", "TorusSpec", "collectives",
    "plans", "plugins", "streaming", "topology",
]
