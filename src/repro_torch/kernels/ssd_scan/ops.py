"""Wrapper, build and launch counter for the CUDA SSD chunked-scan kernel.

``ssd_chunked(x, dt, A, B, C, chunk)`` takes the model layout: ``x (R,
Bt, S, H, P)``, ``dt (R, Bt, S, H)``, ``A (R, H)``, ``B``/``C (R, Bt, S,
G, N)`` with R the stacked ranks.  On CPU tensors it runs the plain
PyTorch version (:mod:`.ref`); on CUDA tensors it launches the kernel of
``csrc/ssd_scan.cu`` or raises — there is no fallback.  The kernels are
compiled at first use by :mod:`repro_torch.kernels._build` and loaded with
``ctypes``.

One call launches three kernels, the chunk-parallel form: chunk states,
the state hand-off across chunks, chunk outputs.  ``launches`` counts
calls (one per call, as the serving path's one-per-layer-per-wave check
reads it).  The wrapper allocates the two f32 scratch buffers the passes
share: the chunk states ``(R, Bt, H, S / chunk, N, P)`` (100 MB at
mamba2-130m's serving shape) and the cumulative decay ``(R, Bt, H, S)``.

Under autograd on the card the forward keeps those two buffers (each
chunk's incoming state and the decay) and its backward is the kernel of
``csrc/ssd_scan_bwd.cu`` (a second library, which also includes the flash
kernels' ``hopper.cuh``): five kernels per call, which ``bwd_launches``
counts once; bf16 calls run its wgmma route, f32 calls its mma.sync one.
There is no fallback there either: a build or launch failure raises.  On
CPU tensors autograd differentiates the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
BWD_SOURCE = SOURCE.with_name("ssd_scan_bwd.cu")
# the wgmma descriptor and fence helpers the backward's bf16 route shares
# with the flash-attention kernels
HOPPER_HEADER = (SOURCE.parents[2] / "flash_attention" / "csrc"
                 / "hopper.cuh")

# Calls of `ssd_chunked` that launched the kernels (three each), and of
# its backward (five each).
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' tiles (shared memory rows of at most these)
MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 128, 128, 64
_GRID_MAX = 2**31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.ssd_scan_launch
    fn.argtypes = [vp] * 9 + [i] * 9 + [ll] * 18 + [vp]
    fn.restype = i


def _bind_bwd(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes = [vp] * 19 + [i] * 9 + [ll] * 18 + [vp]
    fn.restype = i


LIBRARY = _build.Library(SOURCE, _bind)
BWD_LIBRARY = _build.Library(BWD_SOURCE, _bind_bwd,
                             includes=(HOPPER_HEADER,))


def load_library() -> ctypes.CDLL:
    """Build the kernel library if needed and load it (once per process)."""
    return LIBRARY.load()


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` in place with 16-byte loads: a unit
    inner stride, a 16-byte-aligned start, and every other stride of an
    extent over 1 a multiple of 16 bytes.  A tensor that fails is
    copied."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or st * t.element_size() % 16 == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def _pad_last(t: torch.Tensor, to: int) -> torch.Tensor:
    return t if t.shape[-1] == to else F.pad(t, (0, to - t.shape[-1]))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of ``x`` over chunks of ``chunk`` rows: ``y (R, Bt, S,
    H, P)`` and ``h_final (R, Bt, H, N, P)``, both float32.  x, B and C are
    float32 or bfloat16 of one dtype on the card; dt and A float32."""
    ref._check(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        return _SSDScan.apply(x, dt, A, B, C, chunk)
    return _forward(x, dt, A, B, C, chunk)


class _SSDScan(torch.autograd.Function):
    """The forward kernel under autograd, keeping each chunk's incoming
    state and the decay for the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, h_final, states, cum = _forward(x, dt, A, B, C, chunk, keep=True)
        ctx.save_for_backward(x, dt, A, B, C, states, cum)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C, states, cum = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return (*_backward(x, dt, A, B, C, states, cum, ctx.chunk, dy, dh),
                None)


def _forward(x, dt, A, B, C, chunk, keep=False):
    """The kernel on CUDA tensors; with ``keep`` also the scratch it leaves
    (each chunk's incoming state, padded, and the decay)."""
    global launches
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("ssd_chunked: x, dt, A, B and C must share a device")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_chunked takes float32 or bfloat16 x, B, C of "
                         f"one dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_chunked takes float32 dt and A, got "
                         f"{dt.dtype}, {A.dtype}")
    R, Bt, S, H, P = x.shape
    N = B.shape[4]
    blocks = R * Bt * H * (S // chunk)
    if chunk > MAX_CHUNK or N > MAX_STATE or P > MAX_HEAD_DIM \
            or blocks > _GRID_MAX:
        raise ValueError(f"ssd_chunked: chunk {chunk}, state {N}, head dim "
                         f"{P} or {blocks} (rank, batch, head, chunk) "
                         f"blocks over the kernels' limits ({MAX_CHUNK}, "
                         f"{MAX_STATE}, {MAX_HEAD_DIM}, {_GRID_MAX})")
    if R * Bt * H == 0 or S == 0:
        y = torch.empty((R, Bt, S, H, P), dtype=torch.float32,
                        device=x.device)
        h_final = torch.zeros((R, Bt, H, N, P), dtype=torch.float32,
                              device=x.device)
        return (y, h_final, None, None) if keep else (y, h_final)
    # the kernels tile N and P in whole 16-byte vectors: zero columns of x,
    # B and C change no product and give zero columns, cut off below
    Pv, Nv = -(-P // 8) * 8, -(-N // 8) * 8
    x = _pad_last(x, Pv)
    B, C = _pad_last(B, Nv), _pad_last(C, Nv)
    x, B, C = (t if _rows_aligned(t) else t.contiguous() for t in (x, B, C))
    y = torch.empty((R, Bt, S, H, Pv), dtype=torch.float32, device=x.device)
    h_final = torch.empty((R, Bt, H, Nv, Pv), dtype=torch.float32,
                          device=x.device)
    states = torch.empty((R, Bt, H, S // chunk, Nv, Pv), dtype=torch.float32,
                         device=x.device)
    cum = torch.empty((R, Bt, H, S), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h_final.data_ptr(), states.data_ptr(),
            cum.data_ptr(), _DTYPES[x.dtype],
            R, Bt, S, H, Pv, B.shape[3], Nv, chunk, *x.stride()[:4],
            *dt.stride(), *A.stride(), *B.stride()[:4], *C.stride()[:4],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    if (Pv, Nv) != (P, N):
        y = y[..., :P].contiguous()
        h_final = h_final[..., :N, :P].contiguous()
    return (y, h_final, states, cum) if keep else (y, h_final)


def _backward(x, dt, A, B, C, states, cum, chunk, dy, dh):
    """The backward kernel: (dx, ddt, dA, dB, dC) of the scan from the
    cotangents ``dy`` of y and ``dh`` of h_final (None for zero) and the
    forward's ``states`` and ``cum``."""
    global bwd_launches
    R, Bt, S, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    if states is None:   # an empty scan
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros_like(A), torch.zeros_like(B), torch.zeros_like(C))
    Pv, Nv = -(-P // 8) * 8, -(-N // 8) * 8
    xp = _pad_last(x, Pv)
    Bp, Cp = _pad_last(B, Nv), _pad_last(C, Nv)
    xp, Bp, Cp = (t if _rows_aligned(t) else t.contiguous()
                  for t in (xp, Bp, Cp))
    dy = _pad_last(dy.float(), Pv).contiguous()
    if dh is not None:
        dh = F.pad(dh.float(), (0, Pv - P, 0, Nv - N)).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((R, Bt, S, H, Pv), dtype=x.dtype, device=x.device)
    ddt = torch.empty((R, Bt, S, H), **f32)
    dA = torch.empty((R, H), **f32)
    dB = torch.empty((R, Bt, S, G, Nv), dtype=B.dtype, device=x.device)
    dC = torch.empty((R, Bt, S, G, Nv), dtype=C.dtype, device=x.device)
    nc = S // chunk
    grad = torch.empty((R, Bt, H, nc, Nv, Pv), **f32)
    dcum = torch.empty((R, Bt, H, S), **f32)
    ddtd = torch.empty((R, Bt, H, S), **f32)
    tail = torch.empty((R, Bt, H, nc), **f32)
    dapart = torch.empty((R, H, Bt, nc), **f32)
    lib = BWD_LIBRARY.load()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd_launch(
            xp.data_ptr(), dt.data_ptr(), A.data_ptr(), Bp.data_ptr(),
            Cp.data_ptr(), dy.data_ptr(),
            None if dh is None else dh.data_ptr(), states.data_ptr(),
            cum.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), grad.data_ptr(), dcum.data_ptr(),
            ddtd.data_ptr(), tail.data_ptr(), dapart.data_ptr(),
            _DTYPES[x.dtype], R, Bt, S, H, Pv, G, Nv, chunk,
            *xp.stride()[:4], *dt.stride(), *A.stride(), *Bp.stride()[:4],
            *Cp.stride()[:4], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    bwd_launches += 1
    if Pv != P:
        dx = dx[..., :P].contiguous()
    if Nv != N:
        dB, dC = dB[..., :N].contiguous(), dC[..., :N].contiguous()
    return dx, ddt, dA, dB, dC
