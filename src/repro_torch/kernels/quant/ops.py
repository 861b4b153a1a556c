"""Wrappers, build and launch counters for the CUDA int8 ``quantize`` and
``dequantize`` kernels.

On CPU tensors they run the plain PyTorch version (:mod:`.ref`); on CUDA
tensors they launch the kernels of ``csrc/quant.cu`` or raise — there is no
fallback.  The kernels are compiled at first use by
:mod:`repro_torch.kernels._build` and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant.cu"

# Kernel launches issued by each wrapper (a launch captured into a CUDA
# graph counts once, at capture).
launches = {"quantize": 0, "dequantize": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.quantize_launch.argtypes = [vp, i, ll, ll, vp, vp, ll, i, i, i, i,
                                    vp]
    lib.quantize_launch.restype = i
    lib.dequantize_launch.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
    lib.dequantize_launch.restype = i


LIBRARY = _build.Library(SOURCE, _bind)


def load_library() -> ctypes.CDLL:
    """Build the kernel library if needed and load it (once per process)."""
    return LIBRARY.load()


_INT_MAX = 2**31 - 1
_MAX_RANKS = 65535       # dequantize's grid.y extent


def _check_block(block: int) -> None:
    if not isinstance(block, int) or block < 1:
        raise ValueError(f"quant block must be a positive int, got {block!r}")


def _check_sizes(P: int, n: int, block: int) -> None:
    """The kernels index a rank's elements with 32-bit ints and put the
    ranks on the grid's y axis."""
    if n + block > _INT_MAX or P > _MAX_RANKS:
        raise ValueError(f"quant kernels take at most {_MAX_RANKS} ranks of "
                         f"fewer than 2**31 - block elements, got ({P}, {n})")


def quantize(x: torch.Tensor, block: int):
    """Per-rank, per-block symmetric int8 quantization of ``x (P, ...)``
    (f32 or bf16): codes int8 ``(P, nblocks, block)``, scales f32
    ``(P, nblocks, 1)``."""
    _check_block(block)
    if x.device.type == "cpu":
        return ref.quantize(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"quantize runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("quantize needs a leading rank dimension")
    P = x.shape[0]
    flat = x.reshape(P, -1)      # a view where the layout allows, no copy
    n = flat.shape[1]
    _check_sizes(P, n, block)
    nb = -(-n // block)
    q = torch.empty((P, nb, block), dtype=torch.int8, device=x.device)
    s = torch.empty((P, nb, 1), dtype=torch.float32, device=x.device)
    if P * nb == 0:
        return q, s
    # 4 elements per access where the layout allows it
    vec = (flat.stride(1) == 1 and flat.stride(0) % 4 == 0 and n % 4 == 0
           and block % 4 == 0
           and flat.data_ptr() % (4 * flat.element_size()) == 0)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.quantize_launch(
            flat.data_ptr(), _DTYPES[x.dtype], flat.stride(0),
            flat.stride(1), q.data_ptr(), s.data_ptr(), P, n, block, nb,
            int(vec), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    launches["quantize"] += 1
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor, shape, dtype
               ) -> torch.Tensor:
    """Inverse of :func:`quantize`: a stacked message of ``shape`` in
    ``dtype`` (f32 or bf16 on the card)."""
    if q.device.type == "cpu":
        return ref.dequantize(q, s, shape, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if dtype not in _DTYPES:
        raise ValueError(f"dequantize writes float32 or bfloat16, got {dtype}")
    if q.dtype != torch.int8 or q.dim() != 3 or not q.is_contiguous():
        raise ValueError("dequantize: codes must be a contiguous int8 "
                         "(P, nblocks, block) tensor")
    P, nb, block = q.shape
    if s.device != q.device or s.dtype != torch.float32 or \
            tuple(s.shape) != (P, nb, 1) or not s.is_contiguous():
        raise ValueError(f"dequantize: scales must be a contiguous float32 "
                         f"({P}, {nb}, 1) tensor on {q.device}")
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape[1:])
    if not shape or shape[0] != P or -(-n // block) != nb:
        raise ValueError(f"dequantize: message shape {shape} does not fit "
                         f"codes of shape {tuple(q.shape)}")
    _check_sizes(P, n, block)
    out = torch.empty((P, n), dtype=dtype, device=q.device)
    if P * n == 0:
        return out.reshape(shape)
    vec = n % 4 == 0 and block % 4 == 0
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.dequantize_launch(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), _DTYPES[dtype], P, n,
            block, nb, int(vec),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequantize kernel launch failed: CUDA error "
                           f"{err}")
    launches["dequantize"] += 1
    return out.reshape(shape)
