"""Plain PyTorch version of the int8 ``quantize``/``dequantize`` kernels.

The function of the JAX package's ``repro/core/plugins.py::quantize_int8``
(the wire, any block) and ``repro/kernels/quant/ref.py::quantize_ref``
(block 1024), on stacked ranks: each rank's message is flattened, cut into
blocks of ``block`` elements (the last one zero-padded) and quantized on its
own.  It serves CPU tensors and the tests; the card runs the kernels.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def quantize(x: torch.Tensor, block: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (P, ...)`` f32 or bf16 -> codes int8 ``(P, nblocks, block)`` and
    scales f32 ``(P, nblocks, 1)``: ``scale = amax / 127`` (1 where the
    block is all zero), ``q = clip(round(x / scale), -127, 127)``."""
    flat = x.reshape(x.shape[0], -1)
    pad = (-flat.shape[1]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(x.shape[0], -1, block).to(torch.float32)
    amax = blocks.abs().amax(dim=2, keepdim=True)
    # tensor / tensor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which can round the scale 1 ulp away from
    # the JAX package's (and the kernel's) IEEE amax / 127
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype) -> torch.Tensor:
    """Inverse of :func:`quantize` for a stacked message of ``shape``:
    ``q * scale`` in f32, trimmed to the message and cast to ``dtype``."""
    flat = (q.to(torch.float32) * scale).reshape(q.shape[0], -1)
    n = math.prod(shape[1:])
    return flat[:, :n].reshape(shape).to(dtype)
