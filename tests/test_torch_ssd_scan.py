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

The backward: autograd of the plain version against ``jax.grad`` of the
JAX model reference (dx, ddt, dA, dB, dC, with and without a cotangent of
h_final), within the same 1e-4.

The CUDA kernels' arithmetic is mirrored here in torch: the
chunk-parallel decomposition (chunk states, the state hand-off, chunk
outputs) against both references, also under the serving model's steep
decay in float64; the backward kernel's passes (U_c, the hand-off in
reverse, the per-group gradients and the row-order reverse cumsum) against
autograd of the plain version, in f32 within 1e-4 and under the model's
decay in float64; the three-term bf16 split of an
f32 operand (it rebuilds f32 to 2^-24, and a split product stays inside
``chip_smoke.py``'s float64 gate); and the wrapper's padding of N and P to
whole 16-byte vectors and its alignment rule.

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


# ---------------------------------------------------------------------
# The kernels' arithmetic, mirrored in torch: the chunk-parallel
# decomposition and the three-term bf16 split
# ---------------------------------------------------------------------

def _passes_1_2(x, dt, A, B, C, chunk):
    """Passes 1 and 2 of the CUDA forward in plain torch (in x's float
    type): each chunk's running decay ``cum`` (a sequential sum, as the
    kernels take it) and state ``S_c = B^T (exp(cum_last - cum) dt x)``, and
    the hand-off ``h_c = exp(cum_last) h_{c-1} + S_c`` keeping each chunk's
    incoming state.  Returns ``cum (R, Bt, nc, L, H)``, the incoming states
    ``(R, Bt, nc, H, N, P)``, ``h_final`` and the per-head views of x, dt,
    B and C by chunk."""
    R, Bt, S, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    nc, hpg = S // chunk, H // G
    grp = torch.arange(H) // hpg
    xs = x.reshape(R, Bt, nc, chunk, H, P)
    dts = dt.reshape(R, Bt, nc, chunk, H)
    Bs = B.reshape(R, Bt, nc, chunk, G, N)[..., grp, :]
    Cs = C.reshape(R, Bt, nc, chunk, G, N)[..., grp, :]
    cum = torch.zeros_like(dts)
    run = torch.zeros_like(dts[:, :, :, 0])
    for i in range(chunk):                       # pass 1: row order
        run = run + dts[:, :, :, i] * A[:, None, None, :]
        cum[:, :, :, i] = run
    last = cum[:, :, :, -1:]                     # (R, Bt, nc, 1, H)
    w = torch.exp(last - cum) * dts
    states = torch.einsum("rbcjhn,rbcjh,rbcjhp->rbchnp", Bs, w, xs)
    h = torch.zeros_like(states[:, :, 0])       # pass 2
    incoming = []
    for c in range(nc):
        incoming.append(h)
        h = h * torch.exp(last[:, :, c, 0])[..., None, None] + states[:, :, c]
    return cum, torch.stack(incoming, 2), h, (xs, dts, Bs, Cs)


def _decay(cum, chunk):
    """``D_ij = exp(cum_i - cum_j)`` for ``j <= i``, the exponent masked
    before exp: ``(R, Bt, nc, i, j, H)``."""
    diff = cum[:, :, :, :, None, :] - cum[:, :, :, None, :, :]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    return torch.exp(torch.where(tri[:, :, None], diff, torch.full(
        (), float("-inf"), dtype=cum.dtype)))


def _three_pass(x, dt, A, B, C, chunk):
    """The CUDA kernels' decomposition in plain torch (in x's float type):
    passes 1 and 2 (:func:`_passes_1_2`), then pass 3, ``y = ((C B^T) o
    exp(cum_i - cum_j) dt_j)_{j <= i} x + exp(cum_i) C h_{c-1}`` with the
    exponent masked before exp."""
    R, Bt, S, H, P = x.shape
    cum, incoming, h, (xs, dts, Bs, Cs) = _passes_1_2(x, dt, A, B, C, chunk)
    cb = torch.einsum("rbcihn,rbcjhn->rbcijh", Cs, Bs)  # pass 3
    W = cb * _decay(cum, chunk) * dts[:, :, :, None, :, :]
    y = torch.einsum("rbcijh,rbcjhp->rbcihp", W, xs)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "rbcihn,rbchnp->rbcihp", Cs, incoming)
    return y.reshape(R, Bt, S, H, P), h


@pytest.mark.parametrize("case", list(CASES))
def test_three_pass_decomposition_matches_both_references(case):
    B_, S, H, P, N, chunk = CASES[case]
    x, dt, a, b, c = _inputs(B_, S, H, P, N, seed=7)
    y, h = _three_pass(*(torch.from_numpy(v)[None] for v in (x, dt, a, b, c)),
                       chunk)
    want_y, want_h = _port(x, dt, a, b, c, chunk)
    _close(y[0].numpy(), want_y, "y vs the plain version")
    _close(h[0].numpy(), want_h, "h_final vs the plain version")
    y_r, h_r = jax_model_ref(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                             chunk)
    _close(y[0].numpy(), np.asarray(y_r), "y vs the JAX model reference")
    _close(h[0].numpy(), np.asarray(h_r), "h_final vs the JAX reference")


def test_three_pass_decomposition_under_the_models_decay():
    """The serving model's decay: dt = softplus(N(0, 1)) and A = -linspace(1,
    16, H), 4 chunks of 128 (cum reaches ~-1e3 in a chunk, most of a steep
    head's triangle underflows).  In float64 the decomposition equals the
    plain version; the JAX reference (float32) agrees to its own rounding,
    1e-4 of max|y| (the f32 plain version sits at ~1e-5 there)."""
    rng = np.random.RandomState(8)
    B_, S, H, P, N, chunk = 2, 512, 4, 16, 32, 128
    x = rng.randn(B_, S, H, P)
    dt = np.log1p(np.exp(rng.randn(B_, S, H)))
    a = -np.linspace(1.0, 16.0, H)
    b, c = rng.randn(B_, S, 1, N), rng.randn(B_, S, 1, N)
    f64 = [torch.from_numpy(v)[None] for v in (x, dt, a, b, c)]
    y, h = _three_pass(*f64, chunk)
    y_p, h_p = ref.ssd_chunked_ref(*f64, chunk)
    assert y.dtype == torch.float64
    scale = y_p.abs().max().item()
    assert (y - y_p).abs().max().item() <= 1e-10 * scale
    assert (h - h_p).abs().max().item() <= 1e-10 * h_p.abs().max().item()
    y_r, h_r = jax_model_ref(*(jnp.asarray(v, jnp.float32)
                               for v in (x, dt, a, b, c)), chunk)
    assert np.abs(y[0].numpy() - np.asarray(y_r)).max() <= 1e-4 * scale
    assert np.abs(h[0].numpy() - np.asarray(h_r)).max() \
        <= 1e-4 * h_p.abs().max().item()


def _split3(v: torch.Tensor):
    """The kernels' three bf16 terms of an f32 value: each the rounded
    remainder of the ones before."""
    terms, r = [], v.float()
    for _ in range(3):
        t = r.to(torch.bfloat16)
        terms.append(t)
        r = r - t.float()
    return terms


def test_three_bf16_terms_rebuild_f32():
    rng = np.random.RandomState(9)
    v = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -30, 30, 4096)).astype(np.float32))
    hi, mid, lo = _split3(v)
    rebuilt = hi.double() + mid.double() + lo.double()
    assert ((rebuilt - v.double()).abs()
            <= 2.0 ** -24 * v.double().abs()).all()
    assert (hi.double() == v.to(torch.bfloat16).double()).all()


def test_split_product_stays_within_the_float64_gate():
    """A state product B^T (w . x) with B exactly bf16 and w . x f32, the
    form of every product in the kernels: three bf16 products accumulated
    in f32 err against float64 by at most twice the f32 product's own error
    plus 1e-6 of its scale, chip_smoke.py's gate for the scan."""
    rng = np.random.RandomState(10)
    b = torch.from_numpy(rng.randn(128, 128).astype(np.float32)).bfloat16()
    v = torch.from_numpy((rng.randn(128, 64) * np.exp(
        -rng.uniform(0, 30, (128, 1)))).astype(np.float32))
    exact = b.double().T @ v.double()
    plain = b.float().T @ v
    split = sum(b.float().T @ t.float() for t in _split3(v))
    err_p = (plain.double() - exact).abs().max().item()
    err_s = (split.double() - exact).abs().max().item()
    assert err_s <= 2 * err_p + 1e-6 * exact.abs().max().item()


def test_scaled_split_product_stays_within_the_float64_gate():
    """The bf16 route's form of the state term x g^T: bf16 x (exact) times
    g's three bf16 terms, accumulated in f32 smallest first, and only then
    scaled by each row's f32 factor exp(cL - cum_j) dt_j, errs against
    float64 by at most twice the f32 product of the scaled x (the form the
    kernel used before) plus 1e-6 of its scale: chip_smoke.py's gate."""
    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.randn(128, 64).astype(np.float32)).bfloat16()
    g = torch.from_numpy((rng.randn(128, 64) * np.exp(
        -rng.uniform(0, 30, (128, 1)))).astype(np.float32))
    s = torch.from_numpy(np.exp(-rng.uniform(0, 30, 128)).astype(np.float32))
    exact = s.double()[:, None] * (x.double() @ g.double().T)
    plain = (s[:, None] * x.float()) @ g.T
    split = s[:, None] * sum(x.float() @ t.float().T
                             for t in reversed(_split3(g)))
    err_p = (plain.double() - exact).abs().max().item()
    err_s = (split.double() - exact).abs().max().item()
    assert err_s <= 2 * err_p + 1e-6 * exact.abs().max().item()


def test_backward_library_build_covers_the_flash_header(tmp_path):
    """The backward includes the flash kernels' ``hopper.cuh``: its build's
    name covers that header as well as its own folder, so an edit there
    never loads a stale build."""
    from repro_torch.kernels import _build
    assert ops.HOPPER_HEADER.exists()
    assert ops.BWD_LIBRARY.includes == (ops.HOPPER_HEADER,)
    csrc = tmp_path / "kern" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "../../other/h.cuh"\n')
    other = tmp_path / "other"
    other.mkdir()
    (other / "h.cuh").write_text("// v1\n")
    lib = _build.Library(csrc / "k.cu", lambda lib: None,
                         includes=(other / "h.cuh",))
    first = lib.digest()
    assert first != _build.Library(csrc / "k.cu", lambda lib: None).digest()
    (other / "h.cuh").write_text("// v2\n")
    assert lib.digest() != first


def test_wrapper_pads_to_whole_vectors_and_copies_misaligned_rows():
    """On the card the kernels take N and P in whole 16-byte vectors and
    rows that start 16-byte aligned: the wrapper zero-pads the last dim
    (zero columns change no product) and copies a view that is not
    aligned."""
    x = torch.zeros(1, 2, 32, 3, 8)
    assert ops._rows_aligned(x) and ops._rows_aligned(x.bfloat16())
    assert not ops._rows_aligned(torch.zeros(1, 2, 32, 3, 9)[..., 1:])
    fused = torch.zeros(1, 2, 32, 48)
    assert ops._rows_aligned(fused[..., :32].view(1, 2, 32, 4, 8))
    assert not ops._rows_aligned(fused[..., 1:33])
    padded = ops._pad_last(torch.ones(2, 12), 16)
    assert padded.shape == (2, 16) and not padded[:, 12:].any()
    assert ops._pad_last(x, 8) is x


# ---------------------------------------------------------------------
# The backward: the plain version's autograd against jax.grad of the JAX
# model reference, and the backward kernel's passes mirrored in torch
# ---------------------------------------------------------------------

def _cotangents(B, S, H, P, N, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, P).astype(np.float32),
            rng.randn(B, H, N, P).astype(np.float32))


def _plain_grads(inp, chunk, dy, dh):
    """(dx, ddt, dA, dB, dC) of ``<y, dy> + <h_final, dh>`` through the
    plain version (autograd), ``dh`` None for a zero cotangent."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inp]
    y, h = ref.ssd_chunked_ref(*leaves, chunk)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("with_dh", [False, True], ids=["no_dh", "dh"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_grad(case, with_dh):
    """Autograd of the plain version against ``jax.grad`` of the JAX model
    reference, for every input's gradient, with a zero and a nonzero
    cotangent of h_final: within 1e-4, the SSD tolerance."""
    import jax
    B, S, H, P, N, chunk = CASES[case]
    x, dt, a, b, c = _inputs(B, S, H, P, N, seed=11)
    dy, dh = _cotangents(B, S, H, P, N, seed=12)
    dh = dh if with_dh else np.zeros_like(dh)

    def loss(*args):
        y, h = jax_model_ref(*args, chunk)
        return (y * dy).sum() + (h * dh).sum()
    want = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(v) for v in (x, dt, a, b, c)))
    got = _plain_grads([torch.from_numpy(v)[None] for v in (x, dt, a, b, c)],
                       chunk, torch.from_numpy(dy)[None],
                       torch.from_numpy(dh)[None] if with_dh else None)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _close(g[0].numpy(), np.asarray(w), name)


def _bwd_passes(x, dt, A, B, C, chunk, dy, dh=None):
    """The backward kernel's passes in plain torch (in x's float type),
    from the forward's ``cum`` and incoming states (:func:`_passes_1_2`):
    b1, ``U_c = C^T (exp(cum) dy)``; b2, the hand-off in reverse, ``g_{c-1}
    = exp(cum_last) g_c + U_c`` from ``g = dh``, keeping each chunk's
    ``g_c``; b3, per (chunk, group), the rows-i pass (dC, the row sums of
    ``W = (C B^T) o Z``, ``Z = D dt_j (dy x^T)``, the inter-chunk term) and
    the rows-j pass (dx, dB, the column sums of W, the direct ddt, the
    state terms), dB and dC summed over the group's heads; b4, the reverse
    cumsum of dcum in row order, ddt and dA.  As in the kernel's bf16
    route, the chunk-state products dy h^T and x g^T are formed first and
    scaled by their row factors (exp(cum_i); exp(cL - cum_j) dt_j) after."""
    R, Bt, S, H, P = x.shape
    G, N = B.shape[3], B.shape[4]
    nc, hpg = S // chunk, H // G
    cum, hprev, _, (xs, dts, Bs, Cs) = _passes_1_2(x, dt, A, B, C, chunk)
    dys = dy.reshape(R, Bt, nc, chunk, H, P)
    last = cum[:, :, :, -1]                              # (R, Bt, nc, H)
    ec = torch.exp(cum)
    U = torch.einsum("rbcihn,rbcih,rbcihp->rbchnp", Cs, ec, dys)   # b1
    g = torch.zeros_like(hprev[:, :, 0]) if dh is None else dh    # b2
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = g * torch.exp(last[:, :, c])[..., None, None] + U[:, :, c]
    gc = torch.stack(gs, 2)
    D = _decay(cum, chunk)                                          # b3
    strict = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool),
                        -1)[:, :, None]
    cb = torch.einsum("rbcihn,rbcjhn->rbcijh", Cs, Bs)
    M = torch.einsum("rbcihp,rbcjhp->rbcijh", dys, xs)
    Z = D * dts[:, :, :, None, :, :] * M
    W = cb * Z * strict
    # rows i; the chunk-state product dy h^T first, then its row scale
    dyh = torch.einsum("rbcihp,rbchnp->rbcihn", dys, hprev)
    dC = torch.einsum("rbcijh,rbcjhn->rbcihn", Z, Bs) + ec[..., None] * dyh
    dcum = W.sum(4) + ec * (dys * torch.einsum(
        "rbcihn,rbchnp->rbcihp", Cs, hprev)).sum(-1)
    # rows j
    de = torch.exp(last[:, :, :, None] - cum)            # (R, Bt, nc, L, H)
    V = torch.einsum("rbcjhn,rbchnp->rbcjhp", Bs, gc)
    q = (V * xs).sum(-1)
    dx = dts[..., None] * (torch.einsum("rbcijh,rbcihp->rbcjhp", cb * D, dys)
                           + de[..., None] * V)
    xg = torch.einsum("rbcjhp,rbchnp->rbcjhn", xs, gc)   # x g^T, then scaled
    dB = (torch.einsum("rbcijh,rbcihn->rbcjhn", Z, Cs)
          + (de * dts)[..., None] * xg)
    s = de * dts * q
    dcum = dcum - W.sum(3) - s
    ddt_direct = (cb * D * M).sum(3) + de * q
    tail = s.sum(3) + torch.exp(last) * (hprev * gc).sum((-1, -2))
    ddt = torch.zeros_like(dts)                                     # b4
    rc, da = tail, torch.zeros_like(tail)
    for j in reversed(range(chunk)):
        rc = rc + dcum[:, :, :, j]
        ddt[:, :, :, j] = ddt_direct[:, :, :, j] + rc * A[:, None, None, :]
        da = da + rc * dts[:, :, :, j]
    by_group = lambda t: t.reshape(R, Bt, S, G, hpg, N).sum(4)  # noqa: E731
    return (dx.reshape(R, Bt, S, H, P), ddt.reshape(R, Bt, S, H),
            da.sum((1, 2)), by_group(dB), by_group(dC))


@pytest.mark.parametrize("with_dh", [False, True], ids=["no_dh", "dh"])
@pytest.mark.parametrize("case", list(CASES) + ["groups"])
def test_backward_passes_match_the_plain_backward(case, with_dh):
    """The backward kernel's decomposition against autograd of the plain
    version, in float32, within 1e-4; ``groups`` takes 2 B/C groups over 4
    heads (head h reads group h // 2)."""
    B_, S, H, P, N, chunk = CASES.get(case, (2, 64, 4, 16, 8, 16))
    x, dt, a, b, c = _inputs(B_, S, H, P, N, seed=13)
    if case == "groups":
        rng = np.random.RandomState(14)
        b, c = (rng.randn(B_, S, 2, N).astype(np.float32) for _ in range(2))
    dy, dh = _cotangents(B_, S, H, P, N, seed=15)
    inp = [torch.from_numpy(v)[None] for v in (x, dt, a, b, c)]
    dy, dh = torch.from_numpy(dy)[None], torch.from_numpy(dh)[None]
    dh = dh if with_dh else None
    got = _bwd_passes(*inp, chunk, dy, dh)
    want = _plain_grads(inp, chunk, dy, dh)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape, name
        _close(g.numpy(), w.numpy(), name)


def test_backward_passes_under_the_models_decay():
    """The training model's decay (dt = softplus(N(0, 1)), A =
    -linspace(1, 16, H)) at 4 chunks of 128, in float64: the decomposition
    equals autograd of the plain version to 1e-10 of each gradient's max."""
    rng = np.random.RandomState(16)
    B_, S, H, P, N, chunk = 1, 512, 4, 16, 32, 128
    inp = [torch.from_numpy(v)[None] for v in (
        rng.randn(B_, S, H, P), np.log1p(np.exp(rng.randn(B_, S, H))),
        -np.linspace(1.0, 16.0, H), rng.randn(B_, S, 1, N),
        rng.randn(B_, S, 1, N))]
    dy = torch.from_numpy(rng.randn(1, B_, S, H, P))
    dh = torch.from_numpy(rng.randn(1, B_, H, N, P))
    got = _bwd_passes(*inp, chunk, dy, dh)
    want = _plain_grads(inp, chunk, dy, dh)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == torch.float64, name
        assert (g - w).abs().max().item() <= 1e-10 * w.abs().max().item(), \
            name
