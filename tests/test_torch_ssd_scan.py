"""The port's SSD chunked scan (its plain version, which the CPU runs)
against the JAX package's, on the CPU.

- against ``repro/models/ssm.py::ssd_chunked_ref`` (the model's
  reference), ``repro/kernels/ssd_scan/ops.py::ssd_chunked`` (the Pallas
  kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and the
  flat-layout oracle ``repro/kernels/ssd_scan/ref.py::ssd_ref`` (y only: it
  returns no state), at the three shapes of
  ``tests/test_kernels.py::test_ssd_scan_sweep`` and at the serving head
  (P 64, N 128, chunk 128);
- on stacked ranks whose A differ (every rank's row against the JAX
  reference on that row), bf16 inputs, and the naive per-token recurrence
  (``test_ssd_scan_matches_sequential_recurrence``'s form).

Tolerances: atol = rtol = 1e-4 on y and h_final, the bound of
``test_ssd_scan_sweep`` (the summation orders of the cumulative decay and
of the products differ); 1e-3 against the naive recurrence, that test's
bound.  The CUDA kernel is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``cuda`` marker).

JAX runs in this process (one CPU device suffices): no subprocess."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jax_ops
from repro.kernels.ssd_scan.ref import ssd_ref as jax_flat_ref
from repro.models.ssm import ssd_chunked_ref as jax_model_ref

from repro_torch.kernels.ssd_scan import ops, ref

# name -> (B, S, H, P, N, chunk)
CASES = {
    "sweep_small": (1, 32, 2, 8, 8, 16),
    "sweep_batched": (2, 64, 3, 16, 8, 16),
    "sweep_wide": (1, 128, 4, 32, 16, 32),
    "serving_head": (1, 256, 2, 64, 128, 128),
}
TOL = 1e-4


def _inputs(B, S, H, P, N, seed=0):
    """test_ssd_scan_sweep's inputs: positive dt, negative A, G = 1."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, P).astype(np.float32),
            (np.abs(rng.randn(B, S, H)) * 0.1 + 0.01).astype(np.float32),
            -(np.abs(rng.randn(H)) + 0.5).astype(np.float32),
            rng.randn(B, S, 1, N).astype(np.float32),
            rng.randn(B, S, 1, N).astype(np.float32))


def _port(x, dt, a, b, c, chunk):
    """The plain version on one stacked rank -> numpy (y, h_final)."""
    t = [torch.from_numpy(v)[None] for v in (x, dt, a, b, c)]
    y, h = ref.ssd_chunked_ref(*t, chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    return y[0].numpy(), h[0].numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_model_reference(case):
    B, S, H, P, N, chunk = CASES[case]
    x, dt, a, b, c = _inputs(B, S, H, P, N)
    y, h = _port(x, dt, a, b, c, chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    y_r, h_r = jax_model_ref(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                             chunk)
    _close(y, np.asarray(y_r), "y")
    _close(h, np.asarray(h_r), "h_final")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_pallas_kernel(case):
    B, S, H, P, N, chunk = CASES[case]
    x, dt, a, b, c = _inputs(B, S, H, P, N, seed=1)
    y, h = _port(x, dt, a, b, c, chunk)
    y_k, h_k = jax_ops.ssd_chunked(*(jnp.asarray(v)
                                     for v in (x, dt, a, b, c)), chunk,
                                   interpret=True)
    _close(y, np.asarray(y_k), "y")
    _close(h, np.asarray(h_k), "h_final")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_flat_oracle(case):
    """``ssd_ref`` takes the flat ``(B·H, S, ·)`` layout with B/C per head
    and returns y only."""
    B, S, H, P, N, chunk = CASES[case]
    x, dt, a, b, c = _inputs(B, S, H, P, N, seed=2)
    y, _ = _port(x, dt, a, b, c, chunk)
    flat = lambda v: v.transpose(0, 2, 1, 3).reshape(B * H, S, -1)
    bh = lambda v: flat(np.broadcast_to(v, (B, S, H, N)))
    y_f = jax_flat_ref(jnp.asarray(flat(x)),
                       jnp.asarray(dt.transpose(0, 2, 1).reshape(B * H, S)),
                       jnp.asarray(np.tile(a, B)), jnp.asarray(bh(b)),
                       jnp.asarray(bh(c)), chunk)
    y_f = np.asarray(y_f).reshape(B, H, S, P).transpose(0, 2, 1, 3)
    _close(y, y_f, "y")


def test_stacked_ranks_take_their_own_decay():
    """Two stacked ranks with different A (the head-sharded model gathers
    each rank's slice): each row equals the JAX reference on that row."""
    B, S, H, P, N, chunk = 2, 64, 3, 16, 8, 16
    rows = [_inputs(B, S, H, P, N, seed=s) for s in (3, 4)]
    stack = [torch.from_numpy(np.stack(v)) for v in zip(*rows)]
    y, h = ops.ssd_chunked(*stack, chunk)
    for r, inp in enumerate(rows):
        y_r, h_r = jax_model_ref(*(jnp.asarray(v) for v in inp), chunk)
        _close(y[r].numpy(), np.asarray(y_r), f"rank {r} y")
        _close(h[r].numpy(), np.asarray(h_r), f"rank {r} h_final")


def test_bf16_inputs_compute_in_f32():
    """bf16 x, B, C give float32 outputs equal to the f32 scan of the same
    rounded values (the model's prefill casts B and C to x's dtype)."""
    x, dt, a, b, c = (torch.from_numpy(v)[None]
                      for v in _inputs(*CASES["sweep_batched"][:5], seed=5))
    xb, bb, cb = (t.bfloat16() for t in (x, b, c))
    y, h = ops.ssd_chunked(xb, dt, a, bb, cb, 16)
    y32, h32 = ref.ssd_chunked_ref(xb.float(), dt, a, bb.float(),
                                   cb.float(), 16)
    assert y.dtype == h.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(h, h32)


def test_matches_sequential_recurrence():
    """SSD chunked == the naive per-token state recurrence (the SSM
    definition), as test_ssd_scan_matches_sequential_recurrence checks the
    JAX reference."""
    rng = np.random.RandomState(2)
    B, S, H, P, N = 1, 32, 2, 8, 4
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = (np.abs(rng.randn(B, S, H)) * 0.1 + 0.01).astype(np.float32)
    a = -(np.abs(rng.randn(H)) + 0.5).astype(np.float32)
    b = rng.randn(B, S, 1, N).astype(np.float32)
    c = rng.randn(B, S, 1, N).astype(np.float32)
    y, hf = _port(x, dt, a, b, c, 8)
    h = np.zeros((B, H, N, P))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        for hh in range(H):
            h[:, hh] = h[:, hh] * np.exp(dt[:, t, hh] * a[hh])[:, None, None] \
                + dt[:, t, hh][:, None, None] * np.einsum(
                    "bn,bp->bnp", b[:, t, 0], x[:, t, hh])
            ys[:, t, hh] = np.einsum("bn,bnp->bp", c[:, t, 0], h[:, hh])
    np.testing.assert_allclose(y, ys, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(hf, h, atol=1e-3, rtol=1e-3)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper is the plain version: the same values,
    bitwise, and no kernel launch counted."""
    t = [torch.from_numpy(v)[None]
         for v in _inputs(*CASES["sweep_wide"][:5], seed=6)]
    before = ops.launches
    got = ops.ssd_chunked(*t, 32)
    want = ref.ssd_chunked_ref(*t, 32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launches == before


def test_wrapper_rejects_what_the_scan_does_not_take():
    x, dt, a, b, c = (torch.from_numpy(v)[None]
                      for v in _inputs(1, 32, 2, 8, 8))
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd_chunked(x, dt, a, b, c, 12)   # 32 % 12 != 0
    with pytest.raises(ValueError):
        ops.ssd_chunked(x, dt, a, b, c, 0)
    with pytest.raises(ValueError):
        ops.ssd_chunked(x, dt[:, :, :16], a, b, c, 16)
    with pytest.raises(ValueError):
        ops.ssd_chunked(x, dt, a[:, :1], b, c, 16)
    with pytest.raises(ValueError):
        ops.ssd_chunked(x[0], dt, a, b, c, 16)
    with pytest.raises(ValueError):      # 2 heads over 3 groups
        ops.ssd_chunked(x, dt, a, b.expand(-1, -1, -1, 3, -1),
                        c.expand(-1, -1, -1, 3, -1), 16)
