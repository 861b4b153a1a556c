"""Card-only tests of the port: the CUDA ``swe_step`` kernel against its
plain PyTorch version, the main path's schedules on the card, and the int8
wire (the CUDA ``quantize``/``dequantize`` kernels) inside the ring
collectives.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the kernel vs its plain version 1e-5 (float32, the bound of
``tests/test_kernels.py::test_swe_step_sweep``); a 20-step run with the
plain version vs the kernel 1e-4 (``tests/test_swe.py``'s parity bound).
The int8 ring on the card vs the plain wire on the CPU: bitwise equal (the
kernels divide as the plain version does, IEEE, and the same f32 reducer
runs in the same order); a streamed sendrecv: one quantisation step of the
source rank's block.

The flash-attention kernel against its plain version: 3e-5 in float32 and
2e-2 in bfloat16 (``tests/test_kernels.py``'s bounds); the smoke serving
path (float32) on the card against the CPU: equal greedy tokens, logits
within 1e-4 of max|logit| (``tests/test_torch_serve.py``'s bound).

The SSD scan kernel against its plain version: 1e-4 + 1e-4 |plain| on y
and h_final (``tests/test_kernels.py::test_ssd_scan_sweep``'s bound), in
float32 and in bfloat16 (both compute in float32 from the same bf16
values); under the serving model's steep decay, against the plain version
in float64 (at most twice the f32 plain version's error + 1e-6 max|y|,
``chip_smoke.py``'s gate); mamba2's smoke serving path on the card against
the CPU, as qwen3's.  The flash kernel's wgmma + TMA path (bf16, d 64 and
128) on ragged lengths, S != T, windows, softcaps and GQA rep 1 to 8."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import collectives
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG,
                                     CommConfig, Compression, Scheduling,
                                     Transport)
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.quant import ops as quant_ops, ref as quant_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref
from repro_torch.kernels.swe_step import ops, ref
from repro_torch.swe import driver

pytestmark = pytest.mark.cuda
DT = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(E, device, seed=0):
    """One rank whose neighbour rows all live in the halo, every edge
    type, positive depths."""
    rng = np.random.RandomState(seed + E)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return [t(np.abs(rng.randn(1, E, 3)) * 0.1 + [1.0, 0, 0], torch.float32),
            t(np.abs(rng.randn(1, 3 * E, 3)) * 0.1 + [1.0, 0, 0],
              torch.float32),
            t(rng.randn(1, E, 3, 2) * 0.01, torch.float32),
            t((E + rng.permutation(3 * E)).reshape(1, E, 3), torch.int32),
            t(rng.randint(0, 4, (1, E, 3)), torch.int32),
            t(np.abs(rng.randn(1, E)) * 1e-3 + 1e-4, torch.float32),
            t(rng.rand(1, E) > 0.05, torch.float32),
            torch.ones((), dtype=torch.float32, device=device)]


@pytest.mark.parametrize("E", [100, 512, 1300])
def test_kernel_matches_plain(card, E):
    args = _inputs(E, card)
    rows = torch.randint(0, E, (1, max(1, E // 7)), dtype=torch.int32,
                         device=card)
    before = ops.launches
    got = ops.swe_step(*args, dt=DT)
    base = torch.rand_like(got)
    got_b = ops.swe_step(*args, dt=DT, rows=rows, out=base.clone())
    torch.cuda.synchronize()
    assert ops.launches == before + 2
    want = ref.swe_step_ref(*args, dt=DT)
    want_b = ref.swe_step_ref(*args, dt=DT, rows=rows, out=base.clone())
    assert (got - want).abs().max().item() <= 1e-5
    assert (got_b - want_b).abs().max().item() <= 1e-5


def test_kernel_rejects_what_it_does_not_take(card):
    args = _inputs(100, card)
    bad = [
        args[:3] + [args[3].long()] + args[4:],          # index dtype
        [args[0].double()] + args[1:],                   # state dtype
        args[:2] + [args[2].transpose(1, 2).contiguous()
               .transpose(1, 2)] + args[3:],      # non-contiguous
        args[:5] + [args[5].cpu()] + args[6:],           # device mismatch
    ]
    for b in bad:
        with pytest.raises(ValueError):
            ops.swe_step(*b, dt=DT)
    with pytest.raises(ValueError):   # a row list updates `out` in place
        ops.swe_step(*args, dt=DT,
                     rows=torch.zeros((1, 3), dtype=torch.int32, device=card))


def _ranks_inputs(P, E, device, seed):
    """``P`` ranks of different data, every edge type (0 to 3), and
    neighbours next to the slot (inside its tile), anywhere in the rank
    (mostly outside it) and in the halo."""
    rng = np.random.RandomState(seed)
    H = E // 3 + 2
    e = np.arange(E).reshape(1, E, 1)
    near = np.clip(e + rng.randint(-3, 4, (P, E, 3)), 0, E - 1)
    far = rng.randint(0, E, (P, E, 3))
    in_halo = E + rng.randint(0, H, (P, E, 3))
    pick = rng.randint(0, 3, (P, E, 3))
    nidx = np.where(pick == 0, near, np.where(pick == 1, far, in_halo))
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return [t(np.abs(rng.randn(P, E, 3)) * 0.1 + [1.0, 0, 0], torch.float32),
            t(np.abs(rng.randn(P, H, 3)) * 0.1 + [1.0, 0, 0], torch.float32),
            t(rng.randn(P, E, 3, 2) * 0.01, torch.float32),
            t(nidx, torch.int32), t(rng.randint(0, 4, (P, E, 3)), torch.int32),
            t(np.abs(rng.randn(P, E)) * 1e-3 + 1e-4, torch.float32),
            t(rng.rand(P, E) > 0.05, torch.float32),
            torch.full((), 1.1, dtype=torch.float32, device=device)]


def _ragged_rows(P, E, device, seed):
    """A row list of odd length with duplicates in every rank."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, E, (P, E // 2 + 3))
    rows[:, -2:] = rows[:, :1]
    return torch.as_tensor(rows, dtype=torch.int32, device=device)


def _check_both_passes(args, rows):
    """The full pass and the row-list pass against the plain version
    (1e-5), unlisted rows untouched, and the row pass writing the full
    pass's values bitwise (the schedules' invariant)."""
    before = ops.launches
    got = ops.swe_step(*args, dt=DT)
    base = torch.full_like(got, -7.0)
    got_b = ops.swe_step(*args, dt=DT, rows=rows, out=base.clone())
    torch.cuda.synchronize()
    assert ops.launches == before + 2
    want = ref.swe_step_ref(*args, dt=DT)
    want_b = ref.swe_step_ref(*args, dt=DT, rows=rows, out=base.clone())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0, equal_nan=True)
    torch.testing.assert_close(got_b, want_b, atol=1e-5, rtol=0,
                               equal_nan=True)
    listed = torch.zeros(got.shape[:2], dtype=torch.bool, device=got.device)
    listed.scatter_(1, rows.long(), True)
    assert torch.equal(got_b[~listed], base[~listed])
    assert torch.equal(got_b[listed].nan_to_num(nan=-9.0),
                       got[listed].nan_to_num(nan=-9.0))
    return got


@pytest.mark.parametrize("E", [1, 3, 255, 257, 1353])
def test_kernel_edges_match_plain(card, E):
    """Slot counts that are no multiple of 4 or of the tile, three ranks of
    different data (tiles straddle ranks), neighbours in and out of the
    tile and in the halo, every edge type, a ragged row list with
    duplicates."""
    _check_both_passes(_ranks_inputs(3, E, card, seed=E),
                       _ragged_rows(3, E, card, seed=E + 1))


def test_kernel_propagates_nan_as_the_plain_version(card):
    """A NaN depth in the state and in the halo reaches the same slots as
    in the plain version (a clamp that dropped it would hide a blown-up
    state)."""
    P, E = 2, 700
    args = _ranks_inputs(P, E, card, seed=5)
    args[0][0, 10, 0] = float("nan")
    args[0][1, 600, 0] = float("nan")
    args[1][1, :5, 0] = float("nan")
    got = _check_both_passes(args, _ragged_rows(P, E, card, seed=6))
    assert got.isnan().any()


def test_kernel_reads_unaligned_views(card):
    """Contiguous views that start off a 16-byte boundary take the
    per-thread path and give the aligned launch's values bitwise."""
    P, E = 2, 300
    args = _ranks_inputs(P, E, card, seed=7)
    want = ops.swe_step(*args, dt=DT)
    shifted = list(args)
    for i in (0, 2, 3, 4, 5, 6):
        buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype,
                          device=card)
        shifted[i] = buf[1:].view(args[i].shape)
        shifted[i].copy_(args[i])
        assert shifted[i].is_contiguous() and shifted[i].data_ptr() % 16
    got = _check_both_passes(shifted, _ragged_rows(P, E, card, seed=8))
    assert torch.equal(got, want)


def test_schedules_on_the_card(card):
    """Every schedule launches the kernel, all stay bitwise equal, and the
    plain version agrees with the kernel after 20 steps."""
    sim = driver.build_simulation(1696, 8, CommConfig())
    states = {}
    for name, cfg in (("fused", CommConfig()),
                      ("overlapped", OVERLAPPED_CONFIG),
                      ("host", BASELINE_CONFIG)):
        s = dataclasses.replace(sim, comm_cfg=cfg)
        before = ops.launches
        if cfg.scheduling == Scheduling.HOST:
            states[name], _ = driver.make_host_scheduled_runner(s).run(
                s.state, 0.0, 20)
        else:
            run = driver.make_sim_runner(s, 10)
            states[name] = run(run(s.state, 0.0), 10 * DT)
        assert ops.launches > before, name
    torch.cuda.synchronize()
    for name in states:
        assert torch.equal(states[name], states["fused"]), name
    run = driver.make_sim_runner(sim, 10, update=ref.swe_step_ref)
    plain = run(run(sim.state, 0.0), 10 * DT)
    assert (plain - states["fused"]).abs().max().item() <= 1e-4


def test_plain_quant_scale_is_a_true_division_on_the_card(card):
    """The plain version's scale is ``amax / 127`` rounded once (IEEE), as
    the JAX package and the kernel compute it: not ``amax * (1/127)``,
    which is what CUDA PyTorch makes of a division by a Python scalar."""
    x = torch.randn(8, 1 << 16, device=card) * 3
    _, s = quant_ref.quantize(x, 256)
    amax = x.reshape(8, -1, 256).abs().amax(2, keepdim=True).cpu().numpy()
    want = amax / np.float32(127.0)          # numpy: one IEEE f32 division
    assert np.array_equal(s.cpu().numpy(), want)
    _, sk = quant_ops.quantize(x, 256)
    assert torch.equal(sk, s)


def test_int8_ring_collectives_launch_the_kernels_in_a_graph(card):
    """The ring all-reduce on the int8 wire, captured as a CUDA graph:
    the kernels launch at capture, the replay gives the eager result, and
    both agree with the plain wire on the CPU."""
    comm = Communicator(("x",), (8,))
    cfg = CommConfig(algorithm="ring", compression=Compression.INT8)
    rng = np.random.RandomState(0)
    x_cpu = torch.from_numpy(rng.randn(8, 3001).astype(np.float32))
    x = x_cpu.to(card)
    before = dict(quant_ops.launches)
    eager = collectives.all_reduce(x, comm, cfg)
    hops = 2 * (comm.size - 1)
    assert quant_ops.launches["quantize"] == before["quantize"] + hops
    assert quant_ops.launches["dequantize"] == before["dequantize"] + hops
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = collectives.all_reduce(x, comm, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    plain = collectives.all_reduce(x_cpu, comm, cfg)
    assert torch.equal(eager.cpu(), plain)
    bound = hops * x_cpu.abs().amax(1).sum().item() / 127.0
    assert (eager.cpu() - x_cpu.sum(0)).abs().max().item() <= bound


def test_int8_wire_streams_strided_chunks(card):
    """A streamed sendrecv hands the wire strided chunk views: the kernel
    reads them in place and the received message matches the plain wire
    within one step of the source rank's block."""
    comm = Communicator(("x",), (8,))
    cfg = CommConfig(algorithm="ring", compression=Compression.INT8,
                     chunk_bytes=2048)
    x_cpu = torch.from_numpy(
        np.random.RandomState(1).randn(8, 5000).astype(np.float32))
    before = quant_ops.launches["quantize"]
    got = collectives.sendrecv(x_cpu.to(card), comm.ring_perm(), comm, cfg)
    torch.cuda.synchronize()
    assert quant_ops.launches["quantize"] > before
    want = collectives.sendrecv(x_cpu, comm.ring_perm(), comm, cfg)
    step = x_cpu.abs().amax(1).roll(1).unsqueeze(1) / 127.0
    assert ((got.cpu() - want).abs() <= step * 1.0001).all()


# (N, S, T, H, KV, d, causal, window, softcap)
FLASH_CASES = [
    (2, 64, 64, 4, 2, 16, True, None, None),
    (2, 100, 77, 4, 4, 32, False, None, None),
    (1, 130, 200, 8, 2, 64, True, 37, None),
    (3, 65, 129, 4, 1, 128, False, None, 5.0),
    (1, 33, 300, 2, 2, 48, True, 17, 5.0),
    (2, 257, 257, 4, 2, 256, True, None, None),
    (1, 150, 70, 2, 2, 16, True, 20, None),
    (16, 1024, 1024, 8, 2, 128, True, None, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(card, case, dtype):
    N, S, T, H, KV, d, causal, window, softcap = case
    gen = torch.Generator(device=card).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((N, S, H, d), (N, T, KV, d), (N, T, KV, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa_ref.flash_attention_ref(q, k, v, **kw).float()
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    # tests/test_kernels.py's assert_allclose(atol=tol, rtol=tol)
    assert ((got.float() - want).abs() <= tol + tol * want.abs()).all()


def test_flash_kernel_takes_strided_views(card):
    """q/k/v as views of a fused (N, S, 3, H, d) projection: the kernel
    reads them through their strides."""
    qkv = torch.randn(2, 96, 3, 4, 32, device=card)
    q, k, v = qkv.unbind(2)
    got = fa_ops.flash_attention(q, k, v, window=10, softcap=2.0)
    want = fa_ref.flash_attention_ref(q, k, v, window=10, softcap=2.0)
    assert ((got - want).abs() <= 3e-5 + 3e-5 * want.abs()).all()


def test_flash_kernel_copies_unaligned_bf16_views(card):
    """bf16 views whose rows do not start 16-byte aligned (an odd element
    offset, an odd row stride) still take the tensor-core path: the
    wrapper copies them first."""
    N, S, H, d = 2, 80, 4, 64
    buf = torch.randn(1 + N * S * H * (d + 1), device=card).bfloat16()
    q = buf[1:].view(N, S, H, d + 1)[..., :d]
    k, v = q[:, :, :2], q[:, :, 2:]
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.flash_attention_ref(q, k, v).float()
    assert ((got.float() - want).abs() <= 2e-2 + 2e-2 * want.abs()).all()


# (N, S, T, H, KV, d, causal, window, softcap) on the wgmma + TMA path (bf16,
# d 64 or 128): lengths that are no multiple of the 128-row q tile or the
# 64-row kv tile, S != T both ways, a window and a softcap, GQA rep 1, 2, 4
# and 8, a padded head dim (100 -> 128), more work items than SMs
WGMMA_CASES = [
    (2, 200, 200, 8, 8, 128, True, None, None),
    (1, 333, 129, 8, 4, 128, True, None, None),
    (2, 77, 301, 8, 2, 64, False, None, None),
    (1, 260, 260, 8, 1, 128, True, 50, 3.0),
    (3, 128, 64, 2, 2, 100, False, 20, None),
    (4, 513, 513, 16, 2, 128, True, None, None),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_path_matches_plain(card, case):
    N, S, T, H, KV, d, causal, window, softcap = case
    assert fa_ops.padded_head_dim(torch.bfloat16, d) in (64, 128)
    gen = torch.Generator(device=card).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(shape, generator=gen, device=card).bfloat16()
               for shape in ((N, S, H, d), (N, T, KV, d), (N, T, KV, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, **kw).float()
    assert ((got.float() - want).abs() <= 2e-2 + 2e-2 * want.abs()).all()


def test_flash_wgmma_reads_strided_views_in_place(card):
    """bf16 q/k/v as views of one fused (N, S, 3, H, 128) projection: every
    stride is a multiple of 16 bytes, so TMA reads them in place (no copy),
    and the result matches the plain version."""
    qkv = torch.randn(2, 150, 3, 4, 128, device=card).bfloat16()
    q, k, v = qkv.unbind(2)
    assert all(fa_ops._rows_aligned(t) for t in (q, k, v))
    got = fa_ops.flash_attention(q, k, v, window=40, softcap=4.0)
    want = fa_ref.flash_attention_ref(q, k, v, window=40,
                                      softcap=4.0).float()
    assert ((got.float() - want).abs() <= 2e-2 + 2e-2 * want.abs()).all()


def test_flash_kernel_takes_an_empty_key_sequence(card):
    """T = 0: no key is visible and every row is 0 (what the kernels give a
    row without a visible key); a TMA map needs a non-empty tensor, so the
    wrapper answers without a launch."""
    q = torch.randn(1, 5, 2, 128, device=card).bfloat16()
    kv = torch.empty(1, 0, 2, 128, device=card).bfloat16()
    got = fa_ops.flash_attention(q, kv, kv, causal=False)
    assert got.shape == q.shape and not got.any()


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.randn(1, 8, 2, 16, device=card)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q.cpu(), q)
    big = torch.randn(1, 8, 2, 512, device=card)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(big, big, big)


# (R, B, S, H, P, N, chunk): tests/test_kernels.py's sweep, a chunk that
# is no multiple of 32, stacked ranks, and mamba2-130m's serving head
SSD_CASES = [
    (1, 1, 32, 2, 8, 8, 16),
    (1, 2, 64, 3, 16, 8, 16),
    (1, 1, 128, 4, 32, 16, 32),
    (2, 1, 120, 2, 24, 40, 40),
    (4, 2, 512, 6, 64, 128, 128),
]


def _ssd_inputs(case, dtype, card):
    R, B, S, H, P, N, _ = case
    gen = torch.Generator(device=card).manual_seed(sum(case))
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=card)
    return (rnd(R, B, S, H, P).to(dtype),
            rnd(R, B, S, H).abs() * 0.1 + 0.01,
            -(rnd(R, H).abs() + 0.5),
            rnd(R, B, S, 1, N).to(dtype), rnd(R, B, S, 1, N).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(card, case, dtype):
    inp = _ssd_inputs(case, dtype, card)
    before = ssd_ops.launches
    y, h = ssd_ops.ssd_chunked(*inp, case[-1])
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    y_p, h_p = ssd_ref.ssd_chunked_ref(*inp, case[-1])
    for got, want in ((y, y_p), (h, h_p)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()


# (R, B, S, H, G, P, N, chunk): one chunk, an odd number of chunks, N and P
# that the wrapper pads to whole 16-byte vectors (12 -> 16, 20 -> 24), two
# and three B/C groups (head h reads group h // (H / G))
SSD_SHAPES = [
    (1, 2, 64, 2, 1, 16, 32, 64),
    (2, 1, 80, 3, 1, 16, 16, 16),
    (1, 2, 48, 2, 1, 12, 20, 16),
    (1, 1, 96, 6, 2, 32, 64, 32),
    (2, 2, 160, 6, 3, 64, 128, 32),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_chunks_groups_and_padding(card, shape, dtype):
    R, B, S, H, G, P, N, chunk = shape
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=card)
    inp = (rnd(R, B, S, H, P).to(dtype), rnd(R, B, S, H).abs() * 0.1 + 0.01,
           -(rnd(R, H).abs() + 0.5), rnd(R, B, S, G, N).to(dtype),
           rnd(R, B, S, G, N).to(dtype))
    before = ssd_ops.launches
    y, h = ssd_ops.ssd_chunked(*inp, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    y_p, h_p = ssd_ref.ssd_chunked_ref(*inp, chunk)
    for got, want in ((y, y_p), (h, h_p)):
        assert got.shape == want.shape and got.is_contiguous()
        assert ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()


def test_ssd_kernel_copies_misaligned_views(card):
    """bf16 x, B and C whose rows do not start 16-byte aligned (an odd
    element offset in a fused projection): the wrapper copies them, and the
    result matches the plain version."""
    R, B, S, H, P, N = 1, 2, 64, 2, 16, 16
    gen = torch.Generator(device=card).manual_seed(2)
    fused = torch.randn((R, B, S, 1 + H * P + 2 * N), generator=gen,
                        device=card).bfloat16()
    x = fused[..., 1:1 + H * P].view(R, B, S, H, P)
    b = fused[..., 1 + H * P:1 + H * P + N].unsqueeze(3)
    c = fused[..., 1 + H * P + N:].unsqueeze(3)
    assert not any(ssd_ops._rows_aligned(t) for t in (x, b, c))
    dt = torch.rand((R, B, S, H), generator=gen, device=card) * 0.1 + 0.01
    a = -torch.rand((R, H), generator=gen, device=card) - 0.5
    for g, w in zip(ssd_ops.ssd_chunked(x, dt, a, b, c, 16),
                    ssd_ref.ssd_chunked_ref(x, dt, a, b, c, 16)):
        assert ((g - w).abs() <= 1e-4 + 1e-4 * w.abs()).all()


def test_ssd_kernel_under_steep_decay(card):
    """The serving model's decay (dt = softplus(N(0, 1)), A = -linspace(1,
    16, H)): most of a steep head's products underflow and are skipped.
    Against the plain version in float64, the kernel errs at most twice as
    much as the f32 plain version plus 1e-6 of max|y|, chip_smoke.py's
    serving-shape gate."""
    R, B, S, H, P, N, chunk = 2, 2, 512, 6, 64, 128, 128
    gen = torch.Generator(device=card).manual_seed(3)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=card)
    inp = (rnd(R, B, S, H, P).bfloat16(),
           torch.nn.functional.softplus(rnd(R, B, S, H)),
           -torch.linspace(1.0, 16.0, R * H, device=card).view(R, H),
           rnd(R, B, S, 1, N).bfloat16(), rnd(R, B, S, 1, N).bfloat16())
    got = ssd_ops.ssd_chunked(*inp, chunk)
    plain = ssd_ref.ssd_chunked_ref(*inp, chunk)
    exact = ssd_ref.ssd_chunked_ref(*(t.double() for t in inp), chunk)
    for g, p, e in zip(got, plain, exact):
        err_k = (g.double() - e).abs().max().item()
        err_p = (p.double() - e).abs().max().item()
        assert err_k <= 2 * err_p + 1e-6 * e.abs().max().item()


def test_ssd_kernel_reads_strided_views(card):
    """x, B and C as views of one fused projection, dt as a transposed
    view: the kernel reads them through their strides."""
    R, B, S, H, P, N = 1, 2, 64, 2, 16, 8
    gen = torch.Generator(device=card).manual_seed(1)
    fused = torch.randn((R, B, S, H * P + 2 * N), generator=gen, device=card)
    x = fused[..., :H * P].view(R, B, S, H, P)
    b = fused[..., H * P:H * P + N].unsqueeze(3)
    c = fused[..., H * P + N:].unsqueeze(3)
    dt = (torch.rand((R, B, H, S), generator=gen, device=card) * 0.1
          + 0.01).transpose(2, 3)
    a = -torch.rand((R, H), generator=gen, device=card) - 0.5
    got = ssd_ops.ssd_chunked(x, dt, a, b, c, 16)
    want = ssd_ref.ssd_chunked_ref(x, dt, a, b, c, 16)
    for g, w in zip(got, want):
        assert ((g - w).abs() <= 1e-4 + 1e-4 * w.abs()).all()


def test_cuda_tensors_never_reach_the_ssd_plain_version(card, monkeypatch):
    """With the plain version made to raise, the wrapper on CUDA tensors
    still answers (the kernel), and rejects what the kernel does not
    take instead of falling back."""
    inp = _ssd_inputs(SSD_CASES[1], torch.float32, card)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ssd_ref, "ssd_chunked_ref", refuse)
    y, h = ssd_ops.ssd_chunked(*inp, 16)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    x, dt, a, b, c = inp
    with pytest.raises(ValueError):          # dtypes differ
        ssd_ops.ssd_chunked(x, dt, a, b.bfloat16(), c, 16)
    with pytest.raises(ValueError):          # a head dim over 64
        ssd_ops.ssd_chunked(x.repeat(1, 1, 1, 1, 5), dt, a, b, c, 16)
    with pytest.raises(ValueError):          # devices differ
        ssd_ops.ssd_chunked(x, dt.cpu(), a, b, c, 16)


# mamba2's prompt is whole SSD chunks of 16
@pytest.mark.parametrize("arch,S", [("qwen3-8b", 24), ("mamba2-130m", 32)])
def test_smoke_serving_on_the_card_matches_the_cpu(card, arch, S):
    """The smoke config in float32 at tp = 4 from the same weights: one
    kernel launch (flash attention, or the SSD scan) per layer per prefill,
    the same greedy tokens over 4 decode steps as on the CPU, logits within
    1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec, sharding, transformer
    from repro_torch.train import serve
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    kernel = ssd_ops if cfg.family == "ssm" else fa_ops
    tp, B, GEN = 4, 4, 4
    full = transformer.init_model(0, cfg, tp, "cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
    out = {}
    for where in ("cpu", card):
        params = sharding.shard_params(full, cfg, tp, where)
        rt, pre = serve.build_serve_fn(
            cfg, tp, CommConfig(), isp.ShapeSpec("s", S, B, "prefill"),
            cache_capacity=S + GEN, device=where)
        _, step = serve.build_serve_fn(
            cfg, tp, CommConfig(), isp.ShapeSpec("s", S + GEN, B, "decode"),
            device=where)
        before = kernel.launches
        st = pre(params, {"tokens": toks})
        launched = kernel.launches - before
        got = []
        for _ in range(GEN):
            nxt = dec.greedy_tokens(st, rt)
            got.append(nxt.cpu())
            st = step(params, nxt, st)
        out[str(where)] = (torch.stack(got, 1), st.last_logits.cpu(),
                           launched)
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[2] == 0 and gpu[2] == cfg.n_layers
    assert torch.equal(cpu[0], gpu[0])
    assert (cpu[1] - gpu[1]).abs().max() <= 1e-4 * cpu[1].abs().max()


def test_overlapped_combine_on_the_card(card):
    """The streamed row-parallel combine (16 chunks on a second stream)
    against the whole matmul + all-reduce: bitwise equal, as the JAX
    package promises, so that a stream or event ordering fault shows."""
    from repro_torch.core import streaming
    comm = Communicator(("model",), (4,))
    gen = torch.Generator(device=card).manual_seed(0)
    h = torch.randn(4, 1024, 768, generator=gen, device=card)
    w = torch.randn(4, 768, 1024, generator=gen, device=card)
    whole = collectives.all_reduce(streaming.matmul_f32(h, w), comm,
                                   CommConfig())
    for cfg in (CommConfig(chunk_bytes=1 << 18),
                CommConfig(chunk_bytes=1 << 18,
                           transport=Transport.ORDERED, window=2)):
        got = streaming.overlapped_matmul_allreduce(h, w, comm, cfg)
        torch.cuda.synchronize()
        assert torch.equal(got, whole), (got - whole).abs().max().item()


# ----------------------------------------------------------------------
# The reliable wire on the card
# ----------------------------------------------------------------------

from test_torch_reliable import (MATRIX, MATRIX_N, SWE_FAULTS,  # noqa: E402
                                 matrix_configs, matrix_faults, matrix_run)
from repro_torch.core import reliable  # noqa: E402
from repro_torch.core.config import Reliability  # noqa: E402


@pytest.mark.parametrize("path,sched,fname", MATRIX)
def test_reliable_parity_matrix_on_the_card(card, path, sched, fname):
    """The 30-cell matrix on CUDA tensors: bitwise equal to the lossless
    run on the card and to the same cell on the CPU, with the CPU's
    counter deltas."""
    x = (torch.arange(4 * MATRIX_N, dtype=torch.float32)
         .reshape(4, MATRIX_N) * 0.37 + 1.0)
    base, cfg = matrix_configs(sched)
    deltas, outs = [], []
    for dev in ("cpu", card):
        before = reliable.wire_counters()
        with reliable.inject(matrix_faults(fname)):
            outs.append(matrix_run(path, cfg, x.to(dev)).cpu())
        after = reliable.wire_counters()
        deltas.append({k: after[k] - before[k] for k in after})
    clean = matrix_run(path, base, x.to(card)).cpu()
    assert torch.equal(outs[1], clean)
    assert torch.equal(outs[1], outs[0])
    assert deltas[0] == deltas[1]


@pytest.mark.parametrize("sched", ["fused", "overlapped", "host"])
def test_swe_under_faults_on_the_card(card, sched):
    """GUARANTEED + drop/dup/reorder on the card: the graph-captured
    (fused, overlapped) and host-scheduled runners draw the CPU's plans
    once per build and give the lossless BEST_EFFORT state bitwise."""
    cfg = CommConfig(chunk_bytes=512, scheduling=Scheduling(sched),
                     reliability=Reliability.GUARANTEED)
    results = {}
    for dev in ("cpu", card):
        sim = driver.build_simulation(16000, 8, cfg, device=dev)
        lossless = dataclasses.replace(
            sim, comm_cfg=dataclasses.replace(
                cfg, reliability=Reliability.BEST_EFFORT))
        before = reliable.wire_counters()
        with reliable.inject(reliable.WireFaults(**SWE_FAULTS["mixed"])):
            state, tape = _run_twice(sim, sched)
        after = reliable.wire_counters()
        clean, _ = _run_twice(lossless, sched)
        assert torch.equal(state, clean)
        results[str(dev)] = (state.cpu(), tape.entries,
                             {k: after[k] - before[k] for k in after})
    (s_cpu, e_cpu, d_cpu), (s_card, e_card, d_card) = results.values()
    assert e_card == e_cpu and d_card == d_cpu and d_card["retransmits"]
    assert (s_card - s_cpu).abs().max().item() <= 1e-4


def _run_twice(sim, sched):
    """Two calls of one runner build (10 steps): the state and its tape."""
    if sched == "host":
        runner = driver.make_host_scheduled_runner(sim)
        state, t = runner.run(sim.state, 0.0, 5)
        state, _ = runner.run(state, t, 5)
        return state, runner.tape
    run = driver.make_sim_runner(sim, 5)
    state = run(run(sim.state, 0.0), 5 * sim.swe.dt)
    torch.cuda.synchronize()
    return state, run.tape


def test_int8_recovery_rounds_launch_the_quant_kernels(card):
    """A streamed int8 sendrecv under faults: every slot encodes (one
    quantize per slot), every delivered chunk decodes (one dequantize per
    chunk), and the message is bitwise the lossless one."""
    comm = Communicator(("x",), (8,))
    cfg = CommConfig(algorithm="ring", compression=Compression.INT8,
                     chunk_bytes=2048, reliability=Reliability.GUARANTEED)
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 5000)
                         .astype(np.float32)).to(card)
    clean = collectives.sendrecv(x, comm.ring_perm(), comm, cfg)
    before = dict(quant_ops.launches)
    tape = reliable.PlanTape()
    with reliable.inject(reliable.WireFaults(seed=5, drop=0.3, dup=0.2,
                                             reorder=0.3)), tape.play():
        got = collectives.sendrecv(x, comm.ring_perm(), comm, cfg)
    torch.cuda.synchronize()
    (plan,) = tape.plans
    assert plan.extra_slots > 0
    assert quant_ops.launches["quantize"] - before["quantize"] == \
        len(plan.slots)
    assert quant_ops.launches["dequantize"] - before["dequantize"] == \
        plan.n_chunks
    assert torch.equal(got, clean)
