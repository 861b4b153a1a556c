"""Plain PyTorch version of the flash-attention kernel.

Dense fp32 attention in the model layout with the masks, the order of
operations and the floor of the JAX package's Pallas kernel
(``repro/kernels/flash_attention/flash_attention.py``): scores times
``1/sqrt(d)``, then the tanh softcap; masked scores are ``-1e30`` and their
probabilities exactly 0; the output is ``(p @ v) / max(sum p, 1e-30)``.
Grouped-query attention maps q head ``h`` to kv head ``h // (H / KV)``, as
the JAX wrapper's ``jnp.repeat`` does; v's head dim ``d_v`` may differ from
q's and k's ``d`` (MLA's 128 against 192), the scale staying ``1/sqrt(d)``.
It serves CPU tensors and the tests; the card runs the kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def visible(S: int, T: int, causal: bool, window: Optional[int],
            device) -> torch.Tensor:
    """``(S, T)`` mask of the keys each query sees: positions unshifted,
    both from 0 (also when ``S != T``)."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        return_lse: bool = False):
    """``q (N, S, H, d)``, ``k (N, T, KV, d)``, ``v (N, T, KV, d_v)`` ->
    ``(N, S, H, d_v)`` in q's dtype, computed in fp32 (``p @ v`` takes any
    ``d_v``).  With
    ``return_lse`` also every row's log-sum-exp of its visible scores,
    ``(N, H, S)`` (``max + log(max(sum, 1e-30))``, as the kernel writes
    it)."""
    N, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float().transpose(1, 2)                                # N H S d
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)  # N H T d
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if softcap:
        c = s.new_full((), softcap)
        s = c * torch.tanh(s / c)
    ok = visible(S, T, causal, window, q.device)
    s = torch.where(ok, s, s.new_full((), NEG_INF))
    smax = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - smax), s.new_zeros(()))
    denom = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    out = (torch.matmul(p, vf) / denom).transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, (smax + torch.log(denom))[..., 0].float()
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """The plain backward: autograd through :func:`flash_attention_ref` ->
    ``(dq, dk, dv)`` in the inputs' dtypes and shapes (``dv`` of v's head
    dim ``d_v``)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, window=window,
                                  softcap=softcap)
        return torch.autograd.grad(out, leaves, dout)
