"""Wrappers, builds and launch counters for the CUDA flash-attention
kernels: the forward, and the backward of ``csrc/flash_attention_bwd.cu``.

``flash_attention(q, k, v, ...)`` takes the model layout: ``q (N, S, H,
d)``, ``k (N, T, KV, d)`` and ``v (N, T, KV, d_v)`` with ``H % KV == 0``
(v's head dim may differ from q's, as MLA's does: d 192, d_v 128).  On
CPU tensors it runs the plain PyTorch version (:mod:`.ref`); on CUDA
tensors it launches the kernel of ``csrc/flash_attention.cu`` or raises —
there is no fallback.  The kernel is compiled at first use by
:mod:`repro_torch.kernels._build` and loaded with ``ctypes``.

The launcher picks one of the source's kernels by dtype and the two head
dims, q's and k's d and v's d_v, which the wrapper first zero-pads up to
one of the kernels' instantiations (:func:`route`; the output is
allocated at the padded d_v and its columns past d_v, all zero, are
dropped): bf16 runs wgmma fed by TMA, at d = d_v 64 or 128 one kernel, at
d = d_v 256 its form with a producer warpgroup (a 128-byte swizzled row
holds 64 bf16, so bf16 head dims below 64 pad to 64, and both are padded
to the larger one's instantiation), and at d 192 with d_v 128 (MLA's) a
form that reads q and k at 192 columns and v at 128, so that MLA's
tensors are neither padded nor copied (bf16 pairs with 128 < d <= 192 and
d_v <= 128 pad to it); f32 inputs, which are held to 3e-5 (no bf16 or TF32
tensor cores), run the fp32-FMA kernel at one padded head dim.

``flash_attention`` is differentiable.  On the card its forward, when a
gradient is wanted, also writes every row's log-sum-exp (serving never asks
for it, so its launches and outputs are unchanged), and its backward is the
backward kernel (:func:`flash_attention_bwd`): deterministic, with no
atomics.  On the CPU autograd differentiates the plain version.

The backward's kernels in ``csrc/flash_attention_bwd.cu`` are picked by
the same :func:`route` (:func:`bwd_route` gives it for one head dim): bf16
runs wgmma fed by TMA at the forward's padded head dims (d = d_v 64, 128
or 256, or d 192 with d_v 128), reading views in place by the forward's
rule (:func:`_rows_aligned`); f32 inputs, held to 1e-4, run the fp32-FMA
kernels on contiguous copies.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")

# Kernel launches issued by `flash_attention` (forward) and by
# `flash_attention_bwd` (one per call: its three kernels in one launch),
# each also by route (:func:`route`'s kinds).
launches = 0
route_launches = {"wgmma": 0, "wgmma192": 0, "fma": 0}
bwd_launches = 0
bwd_route_launches = {"wgmma": 0, "wgmma192": 0, "fma": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' instantiated head dims, by dtype
HEAD_DIMS = {torch.float32: (16, 32, 64, 128, 256),
             torch.bfloat16: (64, 128, 256)}
_D_MAX = 256
_GRID_MAX = 65535                    # grid.y (heads) and grid.z (N)
# the bf16 route for MLA's head dims: q/k 192 (128 nope + 64 rope), v 128
_MLA_DIMS = (192, 128)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
    fn = lib.flash_attention_launch
    fn.argtypes = [vp] * 4 + [i] * 8 + [ll] * 12 + [f, i, i, f, vp, vp]
    fn.restype = i


def _bind_bwd(lib: ctypes.CDLL) -> None:
    vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [vp] * 10 + [i] * 7 + [f, i, i, f, vp]
    fn.restype = i
    fn = lib.flash_attention_bwd_wgmma_launch
    fn.argtypes = [vp] * 10 + [i] * 8 + [ll] * 15 + [f, i, i, f, vp]
    fn.restype = i


LIBRARY = _build.Library(SOURCE, _bind)
BWD_LIBRARY = _build.Library(BWD_SOURCE, _bind_bwd)
# the fp32-FMA backward's instantiated head dims (both dtypes); the wgmma
# route's are the forward's bf16 ones
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)
# the wgmma backward's scratch rows (L log2 e and delta) per (n, head):
# S rounded up to this
_STATS_ROWS = 128


def load_library() -> ctypes.CDLL:
    """Build the kernel library if needed and load it (once per process)."""
    return LIBRARY.load()


def padded_head_dim(dtype: torch.dtype, d: int) -> int:
    """The instantiated head dim that ``dtype`` inputs of head dim ``d``
    are zero-padded up to."""
    return next(h for h in HEAD_DIMS[dtype] if h >= d)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` in place: a unit inner stride, a
    16-byte-aligned start, and every other stride of an extent over 1 a
    positive multiple of 16 bytes (TMA's rule).  A tensor that fails is
    copied."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st * t.element_size() % 16 == 0)
        for n, st in zip(t.shape[:3], t.stride()[:3]))


def route(dtype: torch.dtype, d: int, d_v: int) -> tuple[str, int, int]:
    """The kernels that ``dtype`` inputs of q/k head dim ``d`` and v head
    dim ``d_v`` take, forward and backward, and the head dims they are
    zero-padded to: ``("wgmma192", 192, 128)`` for bf16 with 128 < d <= 192
    and d_v <= 128 (MLA's 192 and 128 pad nothing); else one head dim for
    both, :func:`bwd_route`'s at the larger of the two."""
    if dtype == torch.bfloat16 and 128 < d <= _MLA_DIMS[0] \
            and d_v <= _MLA_DIMS[1]:
        return ("wgmma192",) + _MLA_DIMS
    kind, dp = bwd_route(dtype, max(d, d_v))
    return kind, dp, dp


def bwd_route(dtype: torch.dtype, d: int) -> tuple[str, int]:
    """The backward kernel that ``dtype`` inputs of head dim ``d`` take and
    the head dim they are zero-padded to: ``("wgmma", 64, 128 or 256)`` for
    bf16, as the forward pads it, and ``("fma", the next of BWD_HEAD_DIMS)``
    for f32 (held to 1e-4, which no tensor-core type keeps)."""
    if dtype == torch.bfloat16 and d <= _D_MAX:
        return "wgmma", padded_head_dim(dtype, d)
    return "fma", next(h for h in BWD_HEAD_DIMS if h >= d)


def _fwd_operand(t: torch.Tensor, dp: int) -> torch.Tensor:
    """What the forward kernel reads for ``t``: zero-padded to head dim
    ``dp`` (zero columns change no product and give zero output columns),
    and ``t`` itself where it is already so wide and :func:`_rows_aligned`
    lets the kernels read it in place; else a fresh copy."""
    if t.shape[-1] != dp:
        t = F.pad(t, (0, dp - t.shape[-1]))
    return t if _rows_aligned(t) else t.clone(
        memory_format=torch.contiguous_format)


def _bwd_operand(t: torch.Tensor, dp: int, route: str) -> torch.Tensor:
    """What the backward kernel of ``route`` reads for ``t``: zero-padded to
    head dim ``dp``; the wgmma routes read a view in place where
    :func:`_rows_aligned` allows it (TMA, as the forward), the fp32-FMA
    route a contiguous tensor."""
    if route == "fma":
        if t.shape[-1] != dp:
            t = F.pad(t, (0, dp - t.shape[-1]))
        return t.contiguous()
    return _fwd_operand(t, dp)


def _check(q, k, v, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (N, S, H, d), k (N, T, KV, "
                         "d) and v (N, T, KV, d_v)")
    N, S, H, d = q.shape
    if tuple(k.shape[:3]) != tuple(v.shape[:3]) or k.shape[0] != N \
            or k.shape[3] != d or not 0 < v.shape[3] <= _D_MAX:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} q heads do not group onto "
                         f"{k.shape[2]} kv heads")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if softcap is not None and softcap < 0:
        raise ValueError(f"flash_attention: softcap must be >= 0, got "
                         f"{softcap}")


def _forward(q, k, v, causal, window, softcap, want_lse: bool):
    """The forward kernel on CUDA tensors -> ``(out (N, S, H, d_v), lse or
    None)``; ``lse`` is ``(N, H, S)`` f32."""
    global launches
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    N, S, H, d = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    if d > _D_MAX:
        raise ValueError(f"flash_attention: head dim {d} over {_D_MAX}")
    if H > _GRID_MAX or N > _GRID_MAX or max(S, T) >= 2**31 - 64:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} over the "
                         f"kernel's grid")
    out_shape = (N, S, H, dv)
    lse = (torch.empty((N, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if N * S * H == 0:
        return q.new_empty(out_shape), lse
    if T == 0:   # no key is visible: every row is 0 (and TMA needs keys)
        if lse is not None:
            lse.fill_(ref.NEG_INF)
        return q.new_zeros(out_shape), lse
    kind, dp, dvp = route(q.dtype, d, dv)
    q, k = (_fwd_operand(t, dp) for t in (q, k))
    v = _fwd_operand(v, dvp)
    out = torch.empty((N, S, H, dvp), dtype=q.dtype, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], dp, dvp, N, S, T, H, KV,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 1.0 / math.sqrt(d), int(causal),
            -1 if window is None else int(window),
            float(softcap) if softcap else 0.0,
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    route_launches[kind] += 1
    return (out if dvp == dv else out[..., :dv]), lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q (N, S, H, d)`` over ``k (N, T, KV, d)`` and ``v (N,
    T, KV, d_v)`` -> ``(N, S, H, d_v)`` in q's dtype (f32 or bf16 on the
    card), fp32 inside, scores scaled by ``1/sqrt(d)``.

    Options as in the JAX package's kernel: ``causal`` (``k_pos <= q_pos``),
    a sliding ``window`` (``k_pos > q_pos - window``) and a tanh
    ``softcap``.  Differentiable: on the card the backward kernel runs."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """The forward with every row's log-sum-exp: ``(out (N, S, H, d_v), lse
    (N, H, S) f32)``, the kernel on the card and the plain version on the
    CPU."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, return_lse=True)
    return _forward(q, k, v, causal, window, softcap, True)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """Gradients ``(dq, dk, dv)`` of attention at ``q``, ``k``, ``v`` for the
    output cotangent ``dout``, given the forward's output and row
    log-sum-exp (``dv`` has v's head dim, which may differ from q's).  On
    CUDA tensors the backward kernels of the forward's :func:`route` run
    (or raise); on CPU tensors autograd
    differentiates the plain version (which needs neither ``out`` nor
    ``lse``)."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                           window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, out, dout)):
        raise ValueError(f"flash_attention_bwd takes float32 or bfloat16 "
                         f"tensors of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}, {out.dtype}, {dout.dtype}")
    N, S, H, d = q.shape
    T = k.shape[1]
    if d > _D_MAX or H > _GRID_MAX or N > _GRID_MAX \
            or max(S, T) >= 2**31 - 256:
        raise ValueError(f"flash_attention_bwd: shape {tuple(q.shape)} over "
                         f"the kernel's limits")
    if N * S * H == 0 or T == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    return _backward(q, k, v, out, dout, lse,
                     route(q.dtype, d, v.shape[3]), causal, window, softcap)


def _backward(q, k, v, out, dout, lse, kernels: tuple, causal, window,
              softcap):
    """The backward kernels of ``kernels``, ``(kind, padded d, padded
    d_v)`` as :func:`route` gives it, on checked, non-empty CUDA tensors:
    q and k zero-padded to the first head dim, v, out and dout to the second
    (dout's padded columns are zero, so the padded columns of dq, dk and dv
    are too), the gradients sliced back to q's d and v's d_v.  ``("fma",
    dp, dvp)`` also runs bf16 (``chip_smoke.py`` times the fp32-FMA kernels
    beside the wgmma route on the same inputs)."""
    global bwd_launches
    kind, dp, dvp = kernels
    N, S, H, d = q.shape
    T, KV, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    q, k = (_bwd_operand(t, dp, kind) for t in (q, k))
    v, out, dout = (_bwd_operand(t, dvp, kind) for t in (v, out, dout))
    lse = lse.float().contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    lib = BWD_LIBRARY.load()
    scale = 1.0 / math.sqrt(d)
    opts = (int(causal), -1 if window is None else int(window),
            float(softcap) if softcap else 0.0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind != "fma":
            s_pad = -(-S // _STATS_ROWS) * _STATS_ROWS
            stats = torch.empty((2, N, H, s_pad), dtype=torch.float32,
                                device=q.device)
            err = lib.flash_attention_bwd_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dp, dvp, N, S,
                T, H, KV, s_pad, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
                scale, *opts, stream)
        else:
            delta = torch.empty((N, H, S), dtype=torch.float32,
                                device=q.device)
            err = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _DTYPES[q.dtype], dp, N, S, T, H, KV, scale, *opts, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch ({kind} "
                           f"route) failed: CUDA error {err}")
    bwd_launches += 1
    bwd_route_launches[kind] += 1
    if dp != d:
        dq, dk = dq[..., :d], dk[..., :d]
    if dvp != dv_dim:
        dv = dv[..., :dv_dim]
    return dq, dk, dv
