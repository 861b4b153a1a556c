"""Plain PyTorch version of the SSD chunked-scan kernel.

The counterpart of the JAX package's ``repro/models/ssm.py::
ssd_chunked_ref`` on the port's stacked model layout: a loop over chunks
carrying the ``(H, N, P)`` state, with, per chunk, the intra-chunk masked
decay matmul ``(C·Bᵀ ∘ exp(cumᵢ − cumⱼ)·[i ≥ j]) · (dt·x)``, the
inter-chunk term ``C·exp(cum)·h_prev`` and the state hand-off
``h = exp(cum_L)·h + (B·exp(cum_L − cum)·dt)ᵀ·x``.  The exponent is masked
before ``exp`` (future entries would overflow), never the result.  Head
``h`` reads B/C group ``h // (H / G)`` (the JAX reference has ``G = 1``).
It serves CPU tensors and the tests; the card runs the kernel.
"""
from __future__ import annotations

import torch


def _check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 5 or dt.dim() != 4 or A.dim() != 2 or B.dim() != 5 \
            or C.dim() != 5:
        raise ValueError("ssd_chunked takes x (R, Bt, S, H, P), dt (R, Bt, "
                         "S, H), A (R, H) and B, C (R, Bt, S, G, N)")
    R, Bt, S, H, P = x.shape
    if tuple(dt.shape) != (R, Bt, S, H) or tuple(A.shape) != (R, H):
        raise ValueError(f"ssd_chunked: dt {tuple(dt.shape)} or A "
                         f"{tuple(A.shape)} do not fit x {tuple(x.shape)}")
    if tuple(B.shape) != tuple(C.shape) or tuple(B.shape[:3]) != (R, Bt, S):
        raise ValueError(f"ssd_chunked: B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} do not fit x {tuple(x.shape)}")
    G = B.shape[3]
    if G < 1 or H % G:
        raise ValueError(f"ssd_chunked: {H} heads do not group onto {G} "
                         f"B/C groups")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"ssd_chunked: chunk must be a positive int, got "
                         f"{chunk!r}")
    if S % chunk:
        raise ValueError(f"ssd_chunked: sequence {S} is not a multiple of "
                         f"the chunk {chunk}")


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``(R, Bt, S, H, P)``; dt ``(R, Bt, S, H)`` (post-softplus); A
    ``(R, H)`` negative; B, C ``(R, Bt, S, G, N)``.  Returns y ``(R, Bt, S,
    H, P)`` and the final state ``(R, Bt, H, N, P)``, both float32 (float64
    for float64 inputs, which the card's checks use as a yardstick)."""
    _check(x, dt, A, B, C, chunk)
    R, Bt, S, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    nc = S // chunk
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[:, :, None]
    neg_inf = torch.full((), float("-inf"), dtype=work, device=x.device)
    Af = A.to(work)[:, None, None, :]                         # (R,1,1,H)

    def heads(t):   # (R, Bt, L, G, N) -> (R, Bt, L, H, N)
        return t.to(work).repeat_interleave(H // G, dim=3)

    h = torch.zeros((R, Bt, H, N, P), dtype=work, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc = x[:, :, sl].to(work)                             # (R,Bt,L,H,P)
        dtc = dt[:, :, sl].to(work)                           # (R,Bt,L,H)
        Bc, Cc = heads(B[:, :, sl]), heads(C[:, :, sl])       # (R,Bt,L,H,N)
        cum = torch.cumsum(dtc * Af, dim=2)                   # (R,Bt,L,H)
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (R,Bt,i,j,H)
        lmat = torch.exp(torch.where(mask, diff, neg_inf))
        cb = torch.einsum("rbihn,rbjhn->rbijh", Cc, Bc)
        w = cb * lmat
        y = torch.einsum("rbijh,rbjhp->rbihp", w, dtc[..., None] * xc)
        y = y + torch.einsum("rbihn,rbih,rbhnp->rbihp", Cc, torch.exp(cum), h)
        decay_end = torch.exp(cum[:, :, -1:] - cum)           # (R,Bt,L,H)
        s_c = torch.einsum("rbjh,rbjhn,rbjhp->rbhnp", decay_end * dtc, Bc, xc)
        h = h * torch.exp(cum[:, :, -1])[..., None, None] + s_c
        ys.append(y)
    y = torch.cat(ys, dim=2) if ys else x.new_zeros(x.shape, dtype=work)
    return y, h
