"""Where the port's entry points run."""
from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when no card is present and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the enclosed code (training: the
    embedding backward, the stacked gathers' index_add, cuBLAS), restored
    on exit so serving keeps its own settings.  ``CUBLAS_WORKSPACE_CONFIG``
    must be set before CUDA starts for cuBLAS to honour it; it is set here
    only if missing (``chip_smoke.py`` and the training example set it
    first thing)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)
