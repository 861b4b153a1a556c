"""ACCL-X compression plugin (PyTorch port).

A per-block int8 (or bf16-cast) wire format for point-to-point transfers:
4x (int8) or 2x (bf16) fewer bytes on the wire.  Disabling the plugin in
:class:`~repro_torch.core.config.CommConfig` removes it ("ACCL minimal").

Every function takes stacked-rank tensors ``(P, ...)``: quantization blocks
are cut from each rank's own flattened message, exactly as the JAX package
quantizes each rank's local chunk, and never run across the rank dimension.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import CommConfig, Compression


def quantize_int8(x: torch.Tensor, block: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank, per-block symmetric int8 quantization of ``x (P, ...)``.

    Returns ``q`` int8 ``(P, nblocks, block)`` and ``scales`` f32
    ``(P, nblocks, 1)``; each rank's message is zero-padded to a block
    multiple on its own."""
    flat = x.reshape(x.shape[0], -1)
    pad = (-flat.shape[1]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(x.shape[0], -1, block).to(torch.float32)
    amax = blocks.abs().amax(dim=2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` for a stacked message of ``shape``."""
    flat = (q.to(torch.float32) * scale).reshape(q.shape[0], -1)
    n = 1
    for s in shape[1:]:
        n *= s
    return flat[:, :n].reshape(shape).to(dtype)


def wire_encode(x: torch.Tensor, cfg: CommConfig):
    """Encode a stacked message for the wire per the comm config.

    Returns ``(payload, decode_fn)``; the payload is a tensor or a tuple of
    tensors, each moved along the rank dimension by the wire.  With
    compression disabled this is an identity and adds no operations."""
    if cfg.compression == Compression.NONE:
        return x, lambda p: p
    if not cfg.enable_compression_plugin:  # defensive; CommConfig validates too
        raise ValueError("compression plugin not built")
    if cfg.compression == Compression.BF16:
        orig = x.dtype
        return x.to(torch.bfloat16), lambda p: p.to(orig)
    if cfg.compression == Compression.INT8:
        q, s = quantize_int8(x, cfg.quant_block)
        shape, dtype = tuple(x.shape), x.dtype
        return (q, s), lambda p: dequantize_int8(p[0], p[1], shape, dtype)
    raise ValueError(f"unknown compression {cfg.compression}")
