"""ACCL-X plugins — compression and arithmetic (PyTorch port).

- **compression plugin** — a per-block int8 (or bf16-cast) wire format for
  point-to-point transfers and the ring collectives: 4x (int8) or 2x (bf16)
  fewer bytes on the wire.  The int8 encode and decode are the CUDA kernels
  of :mod:`repro_torch.kernels.quant` on the card and their plain PyTorch
  version on CPU tensors.
- **arithmetic plugin** — the reduction-operator table of the reduce-style
  collectives (sum/max/min/prod, with fp32 accumulation for low-precision
  sums).

Disabling a plugin in :class:`~repro_torch.core.config.CommConfig` removes
it ("ACCL minimal").

Every function takes stacked-rank tensors ``(P, ...)``: quantization blocks
are cut from each rank's own flattened message, exactly as the JAX package
quantizes each rank's local chunk, and never run across the rank dimension.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.config import CommConfig, Compression
from repro_torch.kernels.quant import ops as quant_ops

# ----------------------------------------------------------------------
# Compression plugin: the wire formats
# ----------------------------------------------------------------------

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
        # codes int8 (P, nblocks, block), scales f32 (P, nblocks, 1)
        q, s = quant_ops.quantize(x, cfg.quant_block)
        shape, dtype = tuple(x.shape), x.dtype
        return (q, s), lambda p: quant_ops.dequantize(p[0], p[1], shape,
                                                      dtype)
    raise ValueError(f"unknown compression {cfg.compression}")


# ----------------------------------------------------------------------
# Arithmetic plugin: reduction-operator table
# ----------------------------------------------------------------------

def _acc_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # fp32 accumulation for low-precision inputs
    if a.dtype in (torch.bfloat16, torch.float16):
        return (a.to(torch.float32) + b.to(torch.float32)).to(a.dtype)
    return a + b


_REDUCE_OPS: dict[str, Callable] = {
    "sum": _acc_sum,
    "max": torch.maximum,
    "min": torch.minimum,
    "prod": torch.mul,
}


def reduce_op(name: str, cfg: CommConfig) -> Callable:
    if not cfg.enable_arithmetic_plugin:
        raise ValueError(
            f"reduction '{name}' requires the arithmetic plugin, which was "
            "compiled out (enable_arithmetic_plugin=False)")
    try:
        return _REDUCE_OPS[name]
    except KeyError:
        raise ValueError(f"unknown reduction '{name}'") from None
