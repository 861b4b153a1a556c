"""The port's swe_step plain version (its CPU path) against the JAX
package's oracle and Pallas kernel (interpret mode).  The CUDA kernel is
held against the JAX oracle here where a card is present (it skips without
one), and against this plain version in ``test_torch_cuda.py``, which needs
no JAX.

Tolerance: atol 1e-5 in float32, the bound of
``tests/test_kernels.py::test_swe_step_sweep``; the two sides differ only in
the order and fusion of float32 operations."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swe_step import ops as ref_ops
from repro.kernels.swe_step.ref import swe_step_ref as jax_swe_step_ref

from repro_torch.kernels.swe_step import ops, ref

ATOL = 1e-5
DT = 1e-4


def _jax_inputs(E):
    """The inputs of test_kernels.py::test_swe_step_sweep (numpy, seed E)."""
    rng = np.random.RandomState(E)
    u = (np.abs(rng.randn(E, 3)) * 0.1 + np.array([1.0, 0, 0])).astype(np.float32)
    u_n = (np.abs(rng.randn(E, 3, 3)) * 0.1 + np.array([1.0, 0, 0])).astype(np.float32)
    nx = (rng.randn(E, 3) * 0.01).astype(np.float32)
    ny = (rng.randn(E, 3) * 0.01).astype(np.float32)
    et = rng.randint(0, 3, (E, 3)).astype(np.int32)
    area = (np.abs(rng.randn(E)) * 1e-3 + 1e-4).astype(np.float32)
    valid = (rng.rand(E) > 0.05).astype(np.float32)
    return u, u_n, nx, ny, et, area, valid


def _port_inputs(u, u_n, nx, ny, et, area, valid, device="cpu"):
    """The same function on the port's layout: one rank, the neighbour rows
    laid out as the halo so that ``neigh_idx`` gathers exactly ``u_n``."""
    E = u.shape[0]
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device).contiguous()
    nidx = (E + np.arange(E * 3)).reshape(1, E, 3)
    return [t(u[None], torch.float32),
            t(u_n.reshape(1, E * 3, 3), torch.float32),
            t(np.stack([nx, ny], -1)[None], torch.float32),
            t(nidx, torch.int32), t(et[None], torch.int32),
            t(area[None], torch.float32), t(valid[None], torch.float32),
            torch.ones((), dtype=torch.float32, device=device)]


@pytest.mark.parametrize("E", [1, 3, 100, 257, 512, 1300])
def test_plain_matches_jax_ref_and_pallas(E):
    arrays = _jax_inputs(E)
    jx = [jnp.asarray(a) for a in arrays]
    want_ref = np.asarray(jax_swe_step_ref(*jx, 1.0, dt=DT))
    want_pallas = np.asarray(ref_ops.swe_step(*jx, 1.0, dt=DT))
    got = ref.swe_step_ref(*_port_inputs(*arrays), dt=DT)[0].numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("E", [100, 1300])
def test_boundary_rows(E):
    """With a row list the update touches exactly those rows (duplicates
    included) and writes the full pass's values there, bitwise."""
    arrays = _jax_inputs(E)
    args = _port_inputs(*arrays)
    full = ref.swe_step_ref(*args, dt=DT)
    rng = np.random.RandomState(E + 1)
    rows_np = rng.randint(0, E, (1, E // 7))
    rows_np[0, -3:] = rows_np[0, 0]         # padded duplicates
    rows = torch.as_tensor(rows_np, dtype=torch.int32)
    base = torch.full_like(full, -7.0)
    out = ref.swe_step_ref(*args, dt=DT, rows=rows, out=base.clone())
    mask = torch.zeros(E, dtype=torch.bool)
    mask[rows.long()[0]] = True
    assert torch.equal(out[0, mask], full[0, mask])
    assert torch.equal(out[0, ~mask], base[0, ~mask])
    want = np.asarray(jax_swe_step_ref(*[jnp.asarray(a) for a in arrays],
                                       1.0, dt=DT))
    np.testing.assert_allclose(out[0, mask].numpy(), want[mask.numpy()],
                               atol=ATOL, rtol=0)


def _stacked(P, E, H, seed, nan):
    """``P`` ranks of different data with neighbours over ``[state |
    halo]`` and every edge type (numpy); with ``nan``, NaN depths in a
    state row and a halo row."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: a.astype(np.float32)
    st = f32(np.abs(rng.randn(P, E, 3)) * 0.1 + [1.0, 0, 0])
    hl = f32(np.abs(rng.randn(P, H, 3)) * 0.1 + [1.0, 0, 0])
    if nan:
        st[0, 5, 0] = hl[P - 1, 2, 0] = np.nan
    return (st, hl, f32(rng.randn(P, E, 3, 2) * 0.01),
            rng.randint(0, E + H, (P, E, 3)).astype(np.int32),
            rng.randint(0, 4, (P, E, 3)).astype(np.int32),
            f32(np.abs(rng.randn(P, E)) * 1e-3 + 1e-4),
            f32(rng.rand(P, E) > 0.05))


@pytest.mark.parametrize("nan", [False, True])
def test_plain_matches_jax_ref_on_stacked_ranks(nan):
    """Three ranks of different data, neighbours in the state and the halo,
    a slot count that is no multiple of 4: each rank of the plain version
    against the JAX oracle on that rank's gathered neighbours, NaN depths
    reaching the same slots."""
    P, E, H = 3, 257, 40
    st, hl, nrm, nidx, et, area, valid = _stacked(P, E, H, 11, nan)
    got = ref.swe_step_ref(*[torch.from_numpy(a) for a in
                             (st, hl, nrm, nidx, et, area, valid)],
                           torch.tensor(1.1), dt=DT).numpy()
    assert np.isnan(got).any() == nan
    for p in range(P):
        u_n = np.concatenate([st[p], hl[p]])[nidx[p]]
        want = np.asarray(jax_swe_step_ref(
            *[jnp.asarray(a) for a in (st[p], u_n, nrm[p, ..., 0],
                                       nrm[p, ..., 1], et[p], area[p],
                                       valid[p])], 1.1, dt=DT))
        np.testing.assert_allclose(got[p], want, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 3, 100, 257, 512, 1300])
def test_cuda_kernel_matches_jax_ref(E):
    """The CUDA kernel against the JAX package's oracle, on a machine that
    has both a card and JAX (the card-only tests without JAX are in
    ``test_torch_cuda.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = _jax_inputs(E)
    want = np.asarray(jax_swe_step_ref(*[jnp.asarray(a) for a in arrays],
                                       1.0, dt=DT))
    before = ops.launches
    got = ops.swe_step(*_port_inputs(*arrays, device="cuda"), dt=DT)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    np.testing.assert_allclose(got[0].cpu().numpy(), want, atol=ATOL, rtol=0)


def test_wrapper_takes_plain_version_on_cpu():
    args = _port_inputs(*_jax_inputs(100))
    before = ops.launches
    got = ops.swe_step(*args, dt=DT)
    assert torch.equal(got, ref.swe_step_ref(*args, dt=DT))
    assert ops.launches == before
