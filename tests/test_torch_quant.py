"""The port's int8 quantizer (the compression plugin's wire format) against
the JAX package's two oracles, on the CPU.

- block 1024 against ``repro/kernels/quant/ref.py::quantize_ref`` (the TPU
  kernel's oracle) and the Pallas kernel itself in interpret mode;
- block 256 (``CommConfig.quant_block``, the wire's) against
  ``repro/core/plugins.py::quantize_int8``.

Tolerances: codes and scales bitwise equal against both oracles — the same
IEEE divisions, the same round-half-to-even; dequantized values bitwise
equal too (one f32 multiply, one cast).  The Pallas kernel in interpret mode
may differ by one code at rounding ties
(``tests/test_kernels.py::test_quant_roundtrip_sweep``).  The CUDA kernels
are held against this plain version on the card (``cuda`` marker; they skip
here): codes within one step, scales bitwise, dequantized error at most
0.51 of the block's scale.

JAX runs in this process (one CPU device suffices): no subprocess."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plugins as jax_plugins
from repro.kernels.quant import ops as jax_quant_ops
from repro.kernels.quant.ref import quantize_ref as jax_quantize_ref

from repro_torch.core import plugins
from repro_torch.core.config import CommConfig, Compression
from repro_torch.kernels.quant import ops, ref

P = 3
LENGTHS = [1, 255, 256, 1000, 1024, 3000, 4097]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _input(n, seed, dtype="f32"):
    """(P, n) numpy f32 values that are exact in ``dtype``: each rank on its
    own scale, a zero run and a few exact .5-code candidates."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(P, n) * np.array([[0.5], [3.0], [40.0]])).astype(
        np.float32)
    x[:, : min(n, 7)] = 0.0
    if dtype == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _torch(x, dtype):
    return torch.from_numpy(x).to(DTYPES[dtype][0])


def _jax(x, dtype):
    return jnp.asarray(x).astype(DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_matches_wire_quantizer_block_256(n, dtype):
    x = _input(n, n, dtype)
    q, s = ref.quantize(_torch(x, dtype), 256)
    nb = -(-n // 256)
    assert q.shape == (P, nb, 256) and q.dtype == torch.int8
    assert s.shape == (P, nb, 1) and s.dtype == torch.float32
    for p in range(P):
        qj, sj = jax_plugins.quantize_int8(_jax(x[p], dtype), 256)
        assert np.array_equal(q[p].numpy(), np.asarray(qj))
        assert np.array_equal(s[p].numpy(), np.asarray(sj))
        for out in DTYPES:
            want = jax_plugins.dequantize_int8(qj, sj, (n,),
                                               DTYPES[out][1])
            got = ref.dequantize(q[p:p + 1], s[p:p + 1], (1, n),
                                 DTYPES[out][0])
            assert got.dtype == DTYPES[out][0]
            assert np.array_equal(got.float().numpy()[0],
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_matches_kernel_oracle_block_1024(n, dtype):
    x = _input(n, 7 * n, dtype)
    q, s = ref.quantize(_torch(x, dtype), 1024)
    for p in range(P):
        qj, sj = jax_quantize_ref(_jax(x[p], dtype))
        assert np.array_equal(q[p].reshape(qj.shape).numpy(), np.asarray(qj))
        assert np.array_equal(s[p].numpy(), np.asarray(sj))


@pytest.mark.parametrize("n", [1000, 3000])
def test_plain_matches_pallas_kernel_in_interpret_mode(n):
    x = _input(n, 11 * n)
    q, s = ref.quantize(torch.from_numpy(x), 1024)
    for p in range(P):
        qk, sk = jax_quant_ops.quantize(jnp.asarray(x[p]), interpret=True)
        d = np.abs(q[p].reshape(qk.shape).numpy().astype(np.int32)
                   - np.asarray(qk, np.int32))
        assert d.max() <= 1
        assert np.array_equal(s[p].numpy(), np.asarray(sk))


def test_blocks_never_cross_ranks():
    x = _input(1000, 3)
    q, s = ref.quantize(torch.from_numpy(x), 256)
    big = x.copy()
    big[0, -1] = 1e6        # rank 0's last (padded) block
    qb, sb = ref.quantize(torch.from_numpy(big), 256)
    assert np.array_equal(sb[1:].numpy(), s[1:].numpy())
    assert np.array_equal(qb[1:].numpy(), q[1:].numpy())
    assert sb[0, -1, 0].item() == np.float32(1e6) / np.float32(127.0)
    # and the stacked result is the per-rank result
    for p in range(P):
        qp, sp = ref.quantize(torch.from_numpy(big[p:p + 1]), 256)
        assert torch.equal(qp[0], qb[p]) and torch.equal(sp[0], sb[p])


def test_zero_and_nan_blocks_take_the_reference_scale():
    """An all-zero block gets scale 1 and zero codes; a block holding a NaN
    gets the scale the JAX package gives it (``amax > 0`` is false for a NaN
    amax: 1.0), not the scale of its finite values."""
    x = np.zeros((1, 512), np.float32)
    x[0, 256:] = np.linspace(-2, 2, 256)
    x[0, 300] = np.nan
    q, s = ref.quantize(torch.from_numpy(x), 256)
    qj, sj = jax_plugins.quantize_int8(jnp.asarray(x[0]), 256)
    assert np.array_equal(s[0].numpy(), np.asarray(sj))
    assert s[0, :, 0].tolist() == [1.0, 1.0]
    assert np.array_equal(q[0, 0].numpy(), np.asarray(qj)[0])
    assert not q[0, 0].any()


def test_wire_encode_int8_uses_the_plain_version_on_cpu():
    x = torch.from_numpy(_input(1000, 5))
    cfg = CommConfig(algorithm="ring", compression=Compression.INT8)
    before = dict(ops.launches)
    (q, s), dec = plugins.wire_encode(x, cfg)
    qr, sr = ref.quantize(x, cfg.quant_block)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(dec((q, s)), ref.dequantize(qr, sr, x.shape, x.dtype))
    assert ops.launches == before      # no kernel on CPU tensors


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(2, 10)
    with pytest.raises(ValueError):
        ops.quantize(x, 0)
    with pytest.raises(ValueError):
        ops.quantize(x.to("meta"), 256)


# ----------------------------------------------------------------------
# The CUDA kernels against the plain version (card only)
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [256, 1024])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernels_match_plain_on_the_card(card, block, dtype):
    for n in LENGTHS:
        x = _torch(_input(n, n + block, dtype), dtype).to(card)
        before = dict(ops.launches)
        q, s = ops.quantize(x, block)
        qr, sr = ref.quantize(x, block)
        torch.cuda.synchronize()
        assert ops.launches["quantize"] == before["quantize"] + 1
        assert torch.equal(s, sr)
        assert (q.int() - qr.int()).abs().max().item() <= 1
        for out in DTYPES.values():
            d = ops.dequantize(q, s, tuple(x.shape), out[0])
            dr = ref.dequantize(q, s, tuple(x.shape), out[0])
            assert torch.equal(d, dr)
        err = (ops.dequantize(q, s, tuple(x.shape), torch.float32)
               - x.float()).abs().reshape(P, -1)
        bound = s.expand(-1, -1, block).reshape(P, -1)[:, :n] * 0.51
        assert (err <= bound).all()
    # views the kernel reads in place: shifted by one element (unaligned),
    # every other column (strided), a transpose
    base = _torch(_input(2 * 1024 + 2, block, dtype), dtype).to(card)
    for view in (base[:, 1:1025], base[:, ::2], base[:, :1024].t()):
        q, s = ops.quantize(view, block)
        qr, sr = ref.quantize(view, block)
        assert torch.equal(s, sr)
        assert (q.int() - qr.int()).abs().max().item() <= 1


def test_chip_smoke_quant_bound_accounting():
    """The bytes chip_smoke.py divides by the card's bandwidth for the
    gradient sync's ring step: each f32 read once, every code of the padded
    blocks and one scale per block written once (quantize); the codes of
    the message, the scales and the f32 output (dequantize)."""
    import importlib.util
    from helpers import REPO
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n = cs.GRAD_PARAMS // cs.GRAD_RANKS
    assert n == 16_114_488 and n % 256            # the padding is exercised
    nb = -(-n // 256)
    assert cs.quant_bytes(8, n, 256, 4, "quantize") == \
        8 * n * 4 + 8 * nb * 256 + 8 * nb * 4 == 646_595_456
    assert cs.quant_bytes(8, n, 256, 4, "dequantize") == \
        8 * n + 8 * nb * 4 + 8 * n * 4 == 646_593_856
