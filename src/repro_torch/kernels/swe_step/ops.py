"""Wrapper, build and launch counter for the CUDA ``swe_step`` kernel.

``swe_step(...)`` takes stacked-rank tensors.  On CPU tensors it runs the
plain PyTorch version (:mod:`.ref`); on CUDA tensors it launches the kernel
in ``csrc/swe_step.cu`` (tiles staged by 16-byte ``cp.async``; the row
list one thread per row) or raises — there is no fallback.  The kernel is
compiled at first use by :mod:`repro_torch.kernels._build` (``nvcc`` for
``sm_90a``, into ``build/`` beside this file) and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swe_step import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "swe_step.cu"

# Kernel launches issued by `swe_step`: one per call on CUDA tensors.  Under
# a CUDA graph this counts the capture, not the replays: a captured launch
# counts once, and every replay of the graph runs it again without Python.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.swe_step_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = _build.Library(SOURCE, _bind)


def load_library() -> ctypes.CDLL:
    """Build the kernel library if needed and load it (once per process)."""
    return LIBRARY.load()


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"swe_step: {name} is on {t.device}, state on "
                         f"{device}")
    if t.dtype != dtype:
        raise ValueError(f"swe_step: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"swe_step: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"swe_step: {name} must be contiguous")


def swe_step(state, halo, normals, neigh_idx, edge_type, area, valid, h_sea,
             *, dt: float, rows=None, out=None):
    """One explicit SWE step per element slot of the stacked state.

    ``state (P, E, 3)`` f32, ``halo (P, H, 3)`` f32, ``normals (P, E, 3, 2)``
    f32, ``neigh_idx``/``edge_type (P, E, 3)`` int32, ``area``/``valid
    (P, E)`` f32, ``h_sea`` a one-element f32 tensor.  Without ``rows``
    returns a new ``(P, E, 3)`` state.  With ``rows (P, n)`` int32 it
    updates only those rows of ``out`` in place and returns ``out`` (the
    overlapped schedule's boundary pass over its interior result)."""
    global launches
    if state.device.type == "cpu":
        return ref.swe_step_ref(state, halo, normals, neigh_idx, edge_type,
                                area, valid, h_sea, dt=dt, rows=rows,
                                out=out)
    if state.device.type != "cuda":
        raise ValueError(f"swe_step runs on CUDA or CPU tensors, got "
                         f"{state.device}")
    dev = state.device
    P, E, H = state.shape[0], state.shape[1], halo.shape[1]
    _check("state", state, torch.float32, (P, E, 3), dev)
    _check("halo", halo, torch.float32, (P, H, 3), dev)
    _check("normals", normals, torch.float32, (P, E, 3, 2), dev)
    _check("neigh_idx", neigh_idx, torch.int32, (P, E, 3), dev)
    _check("edge_type", edge_type, torch.int32, (P, E, 3), dev)
    _check("area", area, torch.float32, (P, E), dev)
    _check("valid", valid, torch.float32, (P, E), dev)
    _check("h_sea", h_sea, torch.float32, h_sea.shape, dev)
    if h_sea.numel() != 1:
        raise ValueError("swe_step: h_sea must hold one value")
    if rows is None:
        if out is not None:
            raise ValueError("swe_step: `out` is only taken with `rows`")
        out = torch.empty_like(state)
        n = E
    else:
        if out is None:
            raise ValueError("swe_step: `rows` updates `out` in place; "
                             "pass it")
        n = rows.shape[1]
        _check("rows", rows, torch.int32, (P, n), dev)
        _check("out", out, torch.float32, (P, E, 3), dev)
    if P * n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.swe_step_launch(
            state.data_ptr(), halo.data_ptr(), normals.data_ptr(),
            neigh_idx.data_ptr(), edge_type.data_ptr(), area.data_ptr(),
            valid.data_ptr(), h_sea.data_ptr(),
            rows.data_ptr() if rows is not None else None, out.data_ptr(),
            P, E, H, n, float(dt), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swe_step kernel launch failed: CUDA error {err}")
    launches += 1
    return out
