"""The port's flash attention (its plain version, which the CPU runs)
against the JAX package's, on the CPU.

- against ``repro/kernels/flash_attention/ops.py::flash_attention``, the
  Pallas kernel in interpret mode, and against its oracle
  ``flash_attention_reference`` (``ref.py::attention_ref``), in the model
  layout ``(B, S, H, d)`` / ``(B, T, KV, d)`` with GQA;
- options: causal or not, a sliding window, a tanh softcap, lengths that
  are not multiples of the tile, S != T both ways, rows that see no key,
  and q heads over kv heads at rep 1, 2 and 4.

Tolerances: 3e-5 in float32 and 2e-2 in bfloat16, the bounds of
``tests/test_kernels.py::test_flash_attention_sweep`` (the summation order
of the products and of the online softmax differs; bf16 outputs round
once).  The CUDA kernel is held against this plain version on the card at
the same tolerances (``tests/test_torch_cuda.py``, ``cuda`` marker).

The head dim the wrapper pads to by dtype, which picks the kernel
(``padded_head_dim``), the backward's route by dtype and head dim
(``bwd_route``), the route both directions take by dtype and the two head
dims (``route``: the d_qk 192 / d_v 128 route reads MLA's tensors with no
padding and no copy), the rule by which either reads a view in place or
copies it (TMA's alignment), and the build loader's naming of a library by
all its sources are checked here too; the kernels themselves run only on
the card.

JAX runs in this process (one CPU device suffices): no subprocess."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops

from repro_torch.kernels.flash_attention import ops, ref

# name -> (B, S, T, H, KV, d, causal, window, softcap)
CASES = {
    "causal_rep2": (2, 100, 100, 4, 2, 16, True, None, None),
    "full_rep1": (1, 64, 64, 2, 2, 32, False, None, None),
    "window_rep4": (1, 200, 200, 8, 2, 32, True, 37, None),
    "softcap": (2, 130, 130, 4, 2, 16, True, None, 5.0),
    "window_softcap_bidirectional": (1, 90, 90, 4, 4, 16, False, 20, 3.0),
    "cross_S_lt_T": (1, 64, 300, 2, 2, 32, False, None, None),
    "cross_causal_S_gt_T_rep4": (1, 150, 70, 4, 1, 16, True, None, None),
    "ragged_multi_tile_rep4": (2, 129, 129, 8, 2, 64, True, None, None),
    "cross_causal_window": (1, 50, 140, 4, 2, 16, True, 30, None),
    "rows_without_keys": (1, 150, 70, 2, 2, 16, True, 20, None),
    "gemma3_like_d256_window": (1, 130, 130, 4, 1, 256, True, 37, None),
}
DTYPES = {"f32": (torch.float32, jnp.float32, 3e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(case, seed=0):
    B, S, T, H, KV, d = CASES[case][:6]
    rng = np.random.RandomState(seed + sum(map(ord, case)))
    return (rng.randn(B, S, H, d).astype(np.float32),
            rng.randn(B, T, KV, d).astype(np.float32),
            rng.randn(B, T, KV, d).astype(np.float32))


def _kwargs(case):
    causal, window, softcap = CASES[case][6:]
    return dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_jax_kernel(case, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _inputs(case)
    kw = _kwargs(case)
    got = ref.flash_attention_ref(*(torch.from_numpy(a).to(tdt)
                                    for a in (q, k, v)), **kw)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    kernel = np.asarray(jax_ops.flash_attention(jq, jk, jv, interpret=True,
                                                **kw), np.float32)
    oracle = np.asarray(jax_ops.flash_attention_reference(jq, jk, jv, **kw),
                        np.float32)
    np.testing.assert_allclose(got, kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)
    if case == "rows_without_keys":
        # q rows >= T - 1 + window see no key: exactly zero on both sides
        S, T, w = CASES[case][1], CASES[case][2], CASES[case][7]
        assert not got[:, T - 1 + w:].any()
        assert not kernel[:, T - 1 + w:].any()


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper is the plain version: the same values,
    bitwise, and no kernel launch counted."""
    q, k, v = (torch.from_numpy(a) for a in _inputs("window_rep4"))
    before = ops.launches
    got = ops.flash_attention(q, k, v, causal=True, window=37)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=37)
    assert torch.equal(got, want)
    assert ops.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs("causal_rep2"))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v[:, :50])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError):
        ops.flash_attention(q[0], k[0], v[0])


# (dtype, head dim) -> the head dim the wrapper zero-pads it to, which the
# launcher dispatches on: bf16 at 64, 128 or 256 runs wgmma + TMA (a
# 128-byte swizzled row holds 64 bf16, so smaller bf16 head dims pad to
# 64); f32 (held to 3e-5) at every d runs fp32 FMA
PADDED = {("bf16", 16): 64, ("bf16", 24): 64, ("bf16", 32): 64,
          ("bf16", 48): 64, ("bf16", 64): 64, ("bf16", 100): 128,
          ("bf16", 128): 128, ("bf16", 200): 256, ("bf16", 256): 256,
          ("f32", 16): 16, ("f32", 64): 64, ("f32", 128): 128,
          ("f32", 256): 256}


@pytest.mark.parametrize("dtype,d", list(PADDED))
def test_padded_head_dim_by_dtype(dtype, d):
    tdt = DTYPES[dtype][0]
    assert ops.padded_head_dim(tdt, d) == PADDED[(dtype, d)]
    assert ops.padded_head_dim(tdt, d) in ops.HEAD_DIMS[tdt]


def test_tma_alignment_rule():
    """The kernels read a tensor in place only with a unit inner stride, a
    16-byte-aligned start and every other stride of an extent over 1 a
    positive multiple of 16 bytes (TMA's rule); anything else is copied."""
    t = torch.zeros(2, 64, 4, 128, dtype=torch.bfloat16)
    assert ops._rows_aligned(t)
    # q/k/v as views of one fused projection: strides of 16-byte multiples
    qkv = torch.zeros(2, 64, 3, 4, 128, dtype=torch.bfloat16)
    assert all(ops._rows_aligned(v) for v in qkv.unbind(2))
    flat = torch.zeros(1 + 2 * 64 * 4 * 128, dtype=torch.bfloat16)
    assert not ops._rows_aligned(flat[1:].view(2, 64, 4, 128))  # start
    odd = torch.zeros(2, 64, 4, 129, dtype=torch.bfloat16)[..., :128]
    assert not ops._rows_aligned(odd)                           # row stride
    kv = torch.zeros(2, 64, 1, 128, dtype=torch.bfloat16)
    assert not ops._rows_aligned(kv.expand(-1, -1, 4, -1))      # stride 0
    assert ops._rows_aligned(kv)                  # extent 1: never stepped
    assert not ops._rows_aligned(t.transpose(2, 3))             # inner
    assert not ops._rows_aligned(t.float()[..., ::2])


# (dtype, head dim) -> the backward's route and the head dim it pads to:
# bf16 runs wgmma + TMA (at 64, 128 or 256, as the forward pads); f32 (held
# to 1e-4: no tensor-core type keeps it) runs the fp32-FMA kernels
BWD_ROUTES = {("bf16", 16): ("wgmma", 64), ("bf16", 32): ("wgmma", 64),
              ("bf16", 64): ("wgmma", 64), ("bf16", 100): ("wgmma", 128),
              ("bf16", 128): ("wgmma", 128), ("bf16", 200): ("wgmma", 256),
              ("bf16", 256): ("wgmma", 256), ("f32", 16): ("fma", 16),
              ("f32", 48): ("fma", 64), ("f32", 128): ("fma", 128),
              ("f32", 256): ("fma", 256)}


@pytest.mark.parametrize("dtype,d", list(BWD_ROUTES))
def test_backward_route_by_dtype_and_head_dim(dtype, d):
    tdt = DTYPES[dtype][0]
    route, dp = ops.bwd_route(tdt, d)
    assert (route, dp) == BWD_ROUTES[(dtype, d)]
    if route == "wgmma":
        assert dp == ops.padded_head_dim(tdt, d)
    else:
        assert dp in ops.BWD_HEAD_DIMS


# bf16 (N, S, H, d) operands as the backward may receive them
BWD_VIEWS = {
    "contiguous": lambda: torch.randn(2, 64, 4, 128).bfloat16(),
    "fused_qkv": lambda: torch.randn(2, 64, 3, 4, 128).bfloat16()[:, :, 1],
    "offset_start": lambda: torch.randn(
        1 + 2 * 64 * 4 * 128).bfloat16()[1:].view(2, 64, 4, 128),
    "odd_row_stride": lambda: torch.randn(
        2, 64, 4, 129).bfloat16()[..., :128],
    "expanded_head": lambda: torch.randn(
        2, 64, 1, 128).bfloat16().expand(-1, -1, 4, -1),
    "expanded_all": lambda: torch.ones(()).bfloat16().expand(2, 64, 4, 128),
    "head_dim_outer": lambda: torch.randn(
        2, 64, 128, 4).bfloat16().transpose(2, 3),
}


@pytest.mark.parametrize("view", list(BWD_VIEWS))
def test_backward_reads_in_place_by_the_forward_rule(view):
    """The wgmma backward reads an operand in place exactly when the
    forward's rule (``_rows_aligned``) lets TMA read it, and copies it
    otherwise; the fp32-FMA route reads contiguous tensors; a padded head
    dim is a zero-padded copy either way."""
    t = BWD_VIEWS[view]()
    got = ops._bwd_operand(t, 128, "wgmma")
    assert (got is t) == ops._rows_aligned(t)
    assert ops._rows_aligned(got) and torch.equal(got, t)
    fma = ops._bwd_operand(t, 128, "fma")
    assert fma.is_contiguous() and torch.equal(fma, t)
    for route in ("wgmma", "fma"):
        padded = ops._bwd_operand(t[..., :100], 128, route)
        assert padded.is_contiguous() and padded.shape[-1] == 128
        assert torch.equal(padded[..., :100], t[..., :100])
        assert not padded[..., 100:].any()


# (dtype, q/k head dim, v head dim) -> (kind, padded d, padded d_v): the
# kernels both directions take (``route``).  bf16 with 128 < d <= 192 and
# d_v <= 128 takes the d_qk 192 / d_v 128 route (MLA's dims pad nothing);
# every other pair keeps one head dim for both, its single-head-dim route
# at the larger of the two (bf16 wgmma at 64, 128 or 256; f32 fp32 FMA)
ROUTES = {("bf16", 192, 128): ("wgmma192", 192, 128),
          ("bf16", 160, 96): ("wgmma192", 192, 128),
          ("bf16", 129, 128): ("wgmma192", 192, 128),
          ("bf16", 192, 16): ("wgmma192", 192, 128),
          ("bf16", 192, 192): ("wgmma", 256, 256),
          ("bf16", 256, 256): ("wgmma", 256, 256),
          ("bf16", 192, 129): ("wgmma", 256, 256),
          ("bf16", 128, 192): ("wgmma", 256, 256),
          ("bf16", 200, 128): ("wgmma", 256, 256),
          ("bf16", 128, 128): ("wgmma", 128, 128),
          ("bf16", 128, 64): ("wgmma", 128, 128),
          ("bf16", 24, 16): ("wgmma", 64, 64),
          ("f32", 192, 128): ("fma", 256, 256),
          ("f32", 160, 96): ("fma", 256, 256),
          ("f32", 128, 128): ("fma", 128, 128),
          ("f32", 24, 16): ("fma", 32, 32)}


@pytest.mark.parametrize("dtype,d,dv", list(ROUTES))
def test_route_by_dtype_and_head_dims(dtype, d, dv):
    tdt = DTYPES[dtype][0]
    assert ops.route(tdt, d, dv) == ROUTES[(dtype, d, dv)]


@pytest.mark.parametrize("dtype,d,dv", list(ROUTES))
def test_backward_route_agrees_with_the_forwards(dtype, d, dv):
    """Both directions take ``route``'s kernels; off the d_qk 192 / d_v 128
    route that is the backward's single-head-dim route (``bwd_route``) at
    the larger head dim, and for bf16 the forward's ``padded_head_dim``, as
    before v's head dim could differ; on it, no head dim pads further than
    that route would pad it."""
    tdt = DTYPES[dtype][0]
    kind, dp, dvp = ops.route(tdt, d, dv)
    old_kind, old_dp = ops.bwd_route(tdt, max(d, dv))
    assert d <= dp and dv <= dvp and kind in ops.bwd_route_launches
    assert kind in ops.route_launches
    if kind == "wgmma192":
        assert old_kind == "wgmma" and max(dp, dvp) <= old_dp
    else:
        assert (kind, dp, dvp) == (old_kind, old_dp, old_dp)
        if tdt == torch.bfloat16:
            assert dp == ops.padded_head_dim(tdt, max(d, dv))


def test_mla_operands_are_read_in_place():
    """At MLA's head dims (192, 128) the wrapper hands the kernels q, k, v,
    the output and its cotangent as they are, contiguous or as views of
    16-byte strides (no padding, no copy); (160, 96) is zero-padded up to
    the route's (192, 128)."""
    qkv = torch.randn(2, 64, 2, 4, 192).bfloat16()
    wide = torch.randn(2, 64, 4, 256).bfloat16()
    for q in (torch.randn(2, 64, 4, 192).bfloat16(), qkv[:, :, 0],
              qkv[:, :, 1]):
        assert ops._fwd_operand(q, 192) is q
        assert ops._bwd_operand(q, 192, "wgmma192") is q
    for v in (torch.randn(2, 64, 4, 128).bfloat16(), wide[..., :128],
              wide[..., 128:]):
        assert ops._fwd_operand(v, 128) is v
        assert ops._bwd_operand(v, 128, "wgmma192") is v
    small = torch.randn(2, 64, 4, 160).bfloat16()
    padded = ops._fwd_operand(small, 192)
    assert padded.shape[-1] == 192 and ops._rows_aligned(padded)
    assert torch.equal(padded[..., :160], small)
    assert not padded[..., 160:].any()


@pytest.mark.parametrize("d,dv", [(192, 128), (160, 96)])
def test_cpu_wrapper_returns_v_head_dim(d, dv):
    """On CPU tensors of the d_qk 192 / d_v 128 route's pairs the wrapper is
    the plain version: outputs of v's head dim, the same bits, no launch
    counted on any route; its backward gives dv of v's head dim."""
    rng = np.random.RandomState(d + dv)
    q, k = (torch.from_numpy(rng.randn(1, 40, 4, d).astype(np.float32))
            .bfloat16() for _ in range(2))
    v = torch.from_numpy(rng.randn(1, 40, 4, dv).astype(np.float32))
    v = v.bfloat16()
    before = (ops.launches, dict(ops.route_launches), ops.bwd_launches,
              dict(ops.bwd_route_launches))
    got = ops.flash_attention(q, k, v, window=17)
    assert tuple(got.shape) == (1, 40, 4, dv) and got.dtype == torch.bfloat16
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, window=17))
    dout = torch.ones_like(got)
    dq, dk, dvg = ops.flash_attention_bwd(q, k, v, None, dout, None,
                                          window=17)
    assert (dq.shape, dk.shape, dvg.shape) == (q.shape, k.shape, v.shape)
    assert (ops.launches, ops.route_launches, ops.bwd_launches,
            ops.bwd_route_launches) == before


def test_library_build_name_covers_sources(tmp_path):
    """A build is named by every file under ``csrc/`` and the nvcc flags: an
    edited header or a new file names another build, so a stale library is
    never loaded; the same sources name the same."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "kern" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("// v1\n")
    lib = _build.Library(csrc / "k.cu", lambda lib: None)
    first = lib.digest()
    assert lib.build_dir == tmp_path / "kern" / "build"
    assert _build.Library(csrc / "k.cu", lambda lib: None).digest() == first
    (csrc / "k.cuh").write_text("// v2\n")
    assert lib.digest() != first
    second = lib.digest()
    (csrc / "more.cuh").write_text("\n")
    assert lib.digest() != second


def test_library_build_log_lies_beside_the_library(tmp_path, monkeypatch):
    """The build's log (ptxas registers and spills) is saved beside the
    library, so a later process that loads the same build reads it back
    without building; a library found without its log is built again.  A
    C compiler stands in for nvcc."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "kern" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text("int k(void) { return 7; }\n")
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\n'
                    f'echo built >> "{tmp_path}/builds"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info    : Used 40 registers"\n'
                    'exec cc -shared -fPIC -x c -o "$2" "$3"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))

    def builds() -> int:
        return len((tmp_path / "builds").read_text().split())

    first = _build.Library(csrc / "k.cu", lambda lib: None)
    assert first.load().k() == 7
    assert "Used 40 registers" in first.log and first.seconds > 0
    assert first.path().with_suffix(".log").read_text() == first.log
    again = _build.Library(csrc / "k.cu", lambda lib: None)
    again.load()
    assert (again.log, again.seconds, builds()) == (first.log, 0.0, 1)
    first.path().with_suffix(".log").unlink()
    third = _build.Library(csrc / "k.cu", lambda lib: None)
    third.load()
    assert (third.log, builds()) == (first.log, 2)
    assert sorted(p.name for p in first.build_dir.iterdir()) == sorted(
        (first.path().name, first.path().with_suffix(".log").name))


# the backward is held to 1e-4 in float32 (a gradient sums more products
# than the forward's output; both sides differentiate fp32 attention)
GRAD_TOL = 1e-4


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_grad(case):
    """The plain backward (autograd through the plain version, which the
    CPU trains through) against ``jax.grad`` of the JAX package's
    ``flash_attention_reference``, float32, on the forward tests' grid:
    dq, dk and dv each within 1e-4 + 1e-4 |jax|."""
    import jax
    q, k, v = _inputs(case)
    kw = _kwargs(case)
    rng = np.random.RandomState(7)
    dout = rng.randn(*q.shape).astype(np.float32)
    got = ops.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)), None,
        torch.from_numpy(dout), None, **kw)

    def f(jq, jk, jv):
        out = jax_ops.flash_attention_reference(jq, jk, jv, **kw)
        return jnp.sum(out * jnp.asarray(dout))
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_autograd_through_the_cpu_wrapper_is_the_plain_backward():
    """``flash_attention`` on CPU tensors differentiates like the plain
    version, and ``flash_attention_lse`` gives the plain log-sum-exp; no
    kernel launch is counted."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs("window_rep4"))
    before = (ops.launches, ops.bwd_launches)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    ops.flash_attention(q, k, v, causal=True, window=37).backward(dout)
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       dout, causal=True, window=37)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)
    with torch.no_grad():
        out, lse = ops.flash_attention_lse(q, k, v, causal=True, window=37)
    B, S, H = q.shape[:3]
    assert tuple(lse.shape) == (B, H, S) and lse.dtype == torch.float32
    # the log-sum-exp normalises the visible probabilities to 1
    s = torch.einsum("bshd,bthd->bhst", q.detach(),
                     k.detach().repeat_interleave(4, 2)) / 32 ** 0.5
    ok = ref.visible(S, k.shape[1], True, 37, "cpu")
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(B, H, S))
    assert (ops.launches, ops.bwd_launches) == before
