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
the CPU, as qwen3's.  The flash kernel's wgmma + TMA path (bf16, d 64,
128 and 256) on ragged lengths, S != T, windows, softcaps and GQA rep 1 to
8.

The flash backward against the plain backward: 1e-4 (f32, the FMA route)
and 2e-2 (bf16) in the form tol + tol |plain|, two runs bitwise equal; the
route each dtype and head dim takes, by its launch counter; the forward's
bits unchanged against digests of the forward kernel as it was before its
tensor maps moved into a shared header.

The SSD backward against autograd of the plain version: tol + tol |plain|
with 1e-4 in float32 and, in bfloat16, 1e-4 + 2^-7 |plain| (dx, dB and dC
leave in bf16: one rounding step); at the training head, under the
model's steep decay and a shallow one, against the plain backward in
float64, the forward's gate; two runs bitwise equal.

zamba2-7b's shapes: the flash forward and backward at head dim 112 (bf16
zero-padded to the d 128 route) and the SSD scan at state 64 (its tp 4
head, 28 heads of 64, under its decay, against float64); its smoke
config (the hybrid family) served on the card against the CPU and
captured against eager, every state buffer bitwise."""
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


@pytest.mark.parametrize("name,cfg,per_step", [
    ("fused", CommConfig(), 1), ("overlapped", OVERLAPPED_CONFIG, 2)])
def test_segment_graphs_count_their_replays(card, name, cfg, per_step):
    """A segment runner's graph counts what its replays run: after k
    replays of a 10-step segment, ``swe_step`` launches and
    ``comm.exchange_rounds`` moved by k x 10 x the per-step count (the
    eager warm-up step before the capture counts once, the capture not at
    all)."""
    from repro_torch.obs import metrics as obs_metrics
    rounds = obs_metrics.registry().counter("comm.exchange_rounds")
    sim = dataclasses.replace(driver.build_simulation(1696, 8, CommConfig()),
                              comm_cfg=cfg)
    # one eager step: the exchange rounds and launches of a step
    l0, r0 = ops.launches, rounds.value
    driver.make_step_fn(sim.pm, cfg, sim.swe)(sim.state, torch.zeros(
        (), device=card), **driver._static_args(sim))
    step_rounds = rounds.value - r0
    assert ops.launches - l0 == per_step and step_rounds > 0
    l0, r0 = ops.launches, rounds.value
    run = driver.make_sim_runner(sim, 10)
    assert (ops.launches - l0, rounds.value - r0) == (per_step, step_rounds)
    state = sim.state
    for k in range(1, 4):
        state = run(state, 10 * DT * (k - 1))
        assert ops.launches - l0 == per_step + 10 * k * per_step
        assert rounds.value - r0 == step_rounds * (1 + 10 * k)
    torch.cuda.synchronize()
    assert torch.isfinite(state).all()


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
    # zamba2-7b's head dim, 3584 / 32 (bf16 pads it to 128)
    (2, 200, 200, 8, 8, 112, True, None, None),
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
# d 64, 128 or 256): lengths that are no multiple of the 128-row q tile or
# the 64-row kv tile, S != T both ways, a window and a softcap, GQA rep 1,
# 2, 4 and 8, a padded head dim (100 -> 128, 192 -> 256), more work items
# than SMs; at d 256 gemma3-1b's heads (4 over 1) and window
WGMMA_CASES = [
    (2, 200, 200, 8, 8, 128, True, None, None),
    (1, 333, 129, 8, 4, 128, True, None, None),
    (2, 77, 301, 8, 2, 64, False, None, None),
    (1, 260, 260, 8, 1, 128, True, 50, 3.0),
    (3, 128, 64, 2, 2, 100, False, 20, None),
    (4, 513, 513, 16, 2, 128, True, None, None),
    (1, 260, 260, 4, 1, 256, True, 50, 3.0),
    (2, 333, 129, 4, 4, 256, True, None, None),
    (2, 77, 301, 8, 2, 256, False, None, None),
    (3, 130, 130, 4, 1, 192, True, 37, None),
    (8, 1024, 1024, 4, 1, 256, True, 512, None),
    (16, 1024, 1024, 8, 8, 112, True, None, None),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_path_matches_plain(card, case):
    N, S, T, H, KV, d, causal, window, softcap = case
    assert fa_ops.padded_head_dim(torch.bfloat16, d) in (64, 128, 256)
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


@pytest.mark.parametrize("d", [128, 256])
def test_flash_wgmma_reads_strided_views_in_place(card, d):
    """bf16 q/k/v as views of one fused (N, S, 3, H, d) projection: every
    stride is a multiple of 16 bytes, so TMA reads them in place (no copy),
    and the result matches the plain version."""
    qkv = torch.randn(2, 150, 3, 4, d, device=card).bfloat16()
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
    (4, 1, 256, 28, 64, 64, 128),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_state_64_under_steep_decay(card, dtype):
    """zamba2-7b's SSD head at tp 4 (28 heads a rank, head dim 64, state 64,
    chunk 128) under its decay (A = -linspace(1, 16, 112) cut into the
    ranks' heads, dt = softplus(N(0, 1))): against the plain version in
    float64, the kernel errs at most twice as much as the f32 plain version
    plus 1e-6 of max|y|, chip_smoke.py's serving-shape gate."""
    R, B, S, H, P, N, chunk = 4, 2, 512, 28, 64, 64, 128
    gen = torch.Generator(device=card).manual_seed(7)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=card)
    inp = (rnd(R, B, S, H, P).to(dtype),
           torch.nn.functional.softplus(rnd(R, B, S, H)),
           -torch.linspace(1.0, 16.0, R * H, device=card).view(R, H),
           rnd(R, B, S, 1, N).to(dtype), rnd(R, B, S, 1, N).to(dtype))
    before = ssd_ops.launches
    got = ssd_ops.ssd_chunked(*inp, chunk)
    assert ssd_ops.launches == before + 1
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


def _prefill_launches(cfg) -> tuple[int, int]:
    """(flash, SSD) launches of one prefill: one a layer of its kind (the
    hybrid family: one SSD scan a Mamba2 layer, one flash launch a run of
    the shared block)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every, cfg.n_layers
    return (0, cfg.n_layers) if cfg.family == "ssm" else (cfg.n_layers, 0)


def _launches() -> tuple[int, int]:
    return fa_ops.launches, ssd_ops.launches


# logits of the smoke config on the card against the CPU, as a share of
# max|logit|: tests/test_torch_serve.py's bound, and
# tests/test_torch_hybrid.py's for zamba2 (its random-weight smoke model is
# ill-conditioned in f32: card against CPU read 1.3e-4)
SMOKE_REL = {"qwen3-8b": 1e-4, "mamba2-130m": 1e-4, "zamba2-7b": 1e-3}


# mamba2's and zamba2's prompts are whole SSD chunks of 16
@pytest.mark.parametrize("arch,S", [("qwen3-8b", 24), ("mamba2-130m", 32),
                                    ("zamba2-7b", 32)])
def test_smoke_serving_on_the_card_matches_the_cpu(card, arch, S):
    """The smoke config in float32 at tp = 4 from the same weights: one
    kernel launch (flash attention, or the SSD scan; both in the hybrid
    family) per layer per prefill, the same greedy tokens over 4 decode
    steps as on the CPU, logits within SMOKE_REL."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec, sharding, transformer
    from repro_torch.train import serve
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
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
        before = _launches()
        st = pre(params, {"tokens": toks})
        launched = tuple(a - b for a, b in zip(_launches(), before))
        got = []
        for _ in range(GEN):
            nxt = dec.greedy_tokens(st, rt)
            got.append(nxt.cpu())
            st = step(params, nxt, st)
        out[str(where)] = (torch.stack(got, 1), st.last_logits.cpu(),
                           launched)
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[2] == (0, 0) and gpu[2] == _prefill_launches(cfg)
    assert torch.equal(cpu[0], gpu[0])
    assert (cpu[1] - gpu[1]).abs().max() <= SMOKE_REL[arch] \
        * cpu[1].abs().max()


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


# ----------------------------------------------------------------------
# Captured programs: core/scheduler.py and serving as CUDA graphs
# ----------------------------------------------------------------------

def test_fused_runner_replays_one_graph_on_the_card(card):
    """Host-scheduled and fused runners on the card: bitwise equal over
    four steps, the fused one a warm-up and capture, then three replays of
    one graph; the all-reduce counter counts every step, replays too."""
    from repro_torch.core import scheduler
    from repro_torch.obs import metrics as obs_metrics
    comm = Communicator(("x",), (4,))
    phases = [scheduler.Phase("a", lambda c: torch.tanh(c) * 2.0),
              scheduler.Phase("comm", lambda c: collectives.all_reduce(
                  c, comm, CommConfig()), is_comm=True),
              scheduler.Phase("b", lambda c: c * c + 1.0)]
    host = scheduler.HostScheduledRunner(phases)
    fused = scheduler.FusedRunner(phases)
    ctr = obs_metrics.registry().counter("comm.collectives",
                                         kind="all_reduce", op="sum")
    x = torch.randn(4, 256, device=card)
    for i in range(4):
        before = ctr.value
        got = fused.run_step(x + i)
        assert ctr.value == before + 1
        assert torch.equal(got, host.run_step(x + i))
    assert fused._graph.replays == 3 and fused.dispatch_count == 4
    assert host.dispatch_count == 12
    assert scheduler.measure_dispatch_overhead(50) > 0.0


def test_captured_graph_node_counts_are_what_a_replay_launches(card):
    """Under keeping_topology() a capture keeps its graph: node_counts
    reads two kernels and one copy (what the eager call launched), the
    lazily instantiated replay computes the eager answer, and a graph
    captured outside the block refuses to count."""
    from repro_torch.core import scheduler
    x = torch.randn(1024, device=card)
    y = torch.empty_like(x)

    def fn(v):
        y.copy_(v + 1.0)
        return y * 2.0

    with scheduler.keeping_topology():
        g = scheduler.CapturedGraph(fn, static=(x.clone(),))
    assert g.node_counts() == {"KERNEL": 2, "MEMCPY": 1}
    g.static[0].copy_(x * 3.0)
    assert torch.equal(g.replay(), fn(x * 3.0))
    plain = scheduler.CapturedGraph(fn, static=(x.clone(),))
    with pytest.raises(RuntimeError, match="keeping_topology"):
        plain.node_counts()


def test_masked_append_captured_across_the_full_edge(card):
    """The cache write captured once and replayed past the last position:
    bitwise the CPU's eager writes, the length advancing on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import attention
    from repro_torch.train import serve
    cfg = get_smoke_config("qwen3-8b")
    rt = serve.serve_runtime(cfg, 4, CommConfig(),
                             isp.ShapeSpec("s", 8, 2, "decode"))
    gen = torch.Generator().manual_seed(0)
    shape = (4, 2, 2, cfg.n_kv_heads, cfg.resolved_head_dim)
    news = torch.randn((12, 4, 2, 1) + shape[3:], generator=gen)
    caches = {}
    for dev in ("cpu", card):
        c = attention.KVCache(k=torch.zeros(shape, device=dev),
                              v=torch.zeros(shape, device=dev),
                              length=torch.full((), 3, dtype=torch.long,
                                                device=dev))
        new = torch.zeros_like(news[0], device=dev)

        def step():
            out = attention.append_to_cache(c, new, -new, rt)
            c.length.copy_(out.length)
        if dev == "cpu":
            for i in range(len(news)):
                new.copy_(news[i])
                step()
        else:
            new.copy_(news[0])
            step()                                       # warm-up
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            for i in range(1, len(news)):
                new.copy_(news[i])
                graph.replay()
        caches[str(dev)] = c
    a, b = caches["cpu"], caches[str(card)]
    assert int(b.length) == 3 + len(news) > 8
    assert torch.equal(a.k, b.k.cpu()) and torch.equal(a.v, b.v.cpu())


@pytest.mark.parametrize("arch,S", [("qwen3-8b", 24), ("mamba2-130m", 32),
                                    ("zamba2-7b", 32)])
def test_captured_smoke_serving_is_bitwise_eager(card, arch, S):
    """The smoke config in float32 at tp = 4: the captured prefill's replay
    and 5 captured decode steps (a warm-up, then four replays of one graph)
    bitwise equal to the eager builders, every state buffer too (the
    hybrid family's SSM states and KV caches alike); the kernels' launches
    counted from the replays (one per layer per prefill run); each replay
    one ``captured=True`` span."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec, sharding, transformer
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import serve
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    tp, B, GEN = 4, 4, 5
    params = sharding.shard_params(transformer.init_model(0, cfg, tp, card),
                                   cfg, tp)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
    runs = {}
    obs_trace.configure("1")
    try:
        for captured in (False, True):
            _, pre = serve.build_serve_fn(
                cfg, tp, CommConfig(), isp.ShapeSpec("s", S, B, "prefill"),
                cache_capacity=S + GEN, device=card, captured=captured)
            rt, step = serve.build_serve_fn(
                cfg, tp, CommConfig(), isp.ShapeSpec("s", S + GEN, B,
                                                     "decode"),
                device=card, captured=captured)
            before = _launches()
            st = pre(params, {"tokens": toks})
            if captured:
                st = pre(params, {"tokens": toks})       # the replay
                assert pre.graph.replays == 1
            launched = tuple(a - b for a, b in zip(_launches(), before))
            first = [t.clone() for t in serve._state_buffers(st)]
            out = []
            for _ in range(GEN):
                nxt = dec.greedy_tokens(st, rt)
                st = step(params, nxt, st)
                out += [nxt] + [t.clone() for t in serve._state_buffers(st)]
            runs[captured] = (first, out, launched, step)
        spans = [e for e in obs_trace.events()
                 if e.get("name") in ("serve.prefill", "serve.decode")]
    finally:
        obs_trace.configure("0")
    (fe, oe, le, _), (fc, oc, lc, step_c) = runs[False], runs[True]
    assert le == _prefill_launches(cfg)
    assert lc == tuple(2 * n for n in _prefill_launches(cfg))
    assert all(torch.equal(a, b) for a, b in zip(fe + oe, fc + oc))
    (g,) = step_c.graphs.values()
    assert g.replays == GEN - 1
    assert len(spans) == 1 + GEN - 1
    assert all(e["args"].get("captured") is True for e in spans)


def test_auto_serving_on_the_card(card, tmp_path):
    """comm="auto" from a TuneDB of the card's key picks per phase and is
    bitwise the captured serving with the resolved configs."""
    from repro_torch import tune
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec, sharding, transformer
    from repro_torch.train import serve
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"),
                              dtype=torch.float32)
    tp, B, S, GEN = 4, 4, 16, 3
    shapes = {"prefill": isp.ShapeSpec("s", S, B, "prefill"),
              "decode": isp.ShapeSpec("s", S + GEN, B, "decode")}
    wins = {"prefill": {"scheduling": "overlapped", "chunk_bytes": 1 << 16},
            "decode_step": {"mode": "buffered"}}
    rows = []
    for shp in shapes.values():
        msg = serve.serve_msg_bytes(cfg, shp)
        for consumer, win in wins.items():
            for i, c in enumerate((win, {"scheduling": "host"})):
                rows.append(tune.TuneEntry(
                    topo=tune.topology_key(tp, card),
                    collective="all_reduce", msg_bytes=msg,
                    config=tune.config_to_dict(tune.config_from_dict(c)),
                    us_per_call=10.0, e2e_us=10.0 + i, consumer=consumer))
    path = tmp_path / "db.json"
    tune.TuneDB(rows).save(path)
    params = sharding.shard_params(transformer.init_model(0, cfg, tp, card),
                                   cfg, tp)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S))
    resolved = {k: serve.resolve_serve_comm(cfg, tp, "auto", shp,
                                            tune_db_path=path)
                for k, shp in shapes.items()}
    assert resolved["prefill"] != resolved["decode"]
    runs = []
    for comms in ({k: "auto" for k in shapes}, resolved):
        _, pre = serve.build_serve_fn(cfg, tp, comms["prefill"],
                                      shapes["prefill"],
                                      cache_capacity=S + GEN,
                                      tune_db_path=path)
        rt, step = serve.build_serve_fn(cfg, tp, comms["decode"],
                                        shapes["decode"], tune_db_path=path)
        st = pre(params, {"tokens": toks})
        out = [st.last_logits.clone()]
        for _ in range(GEN):
            nxt = dec.greedy_tokens(st, rt)
            st = step(params, nxt, st)
            out += [nxt, st.last_logits.clone()]
        runs.append(out)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_plan_cache_bypass_captures_on_the_card(card, monkeypatch):
    """Under REPRO_PLAN_CACHE=0 a decode step still captures (the device
    index tensors are pinned, built by the warm-up) and replays bitwise
    the cached build's steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec, sharding, transformer
    from repro_torch.train import serve
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"),
                              dtype=torch.float32)
    comm = CommConfig(algorithm="ring", chunk_bytes=1024)
    params = sharding.shard_params(transformer.init_model(2, cfg, 4, card),
                                   cfg, 4)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 8))

    def serve_once():
        _, pre = serve.build_serve_fn(cfg, 4, comm,
                                      isp.ShapeSpec("s", 8, 2, "prefill"),
                                      cache_capacity=12)
        rt, step = serve.build_serve_fn(cfg, 4, comm,
                                        isp.ShapeSpec("s", 12, 2, "decode"))
        st = pre(params, {"tokens": toks})
        out = []
        for _ in range(3):
            st = step(params, dec.greedy_tokens(st, rt), st)
            out.append(st.last_logits.clone())
        return out

    cached = serve_once()
    monkeypatch.setenv("REPRO_PLAN_CACHE", "0")
    bypassed = serve_once()
    assert all(torch.equal(a, b) for a, b in zip(cached, bypassed))


# ----------------------------------------------------------------------
# Training: the flash backward kernel and a train step on the card
# ----------------------------------------------------------------------

# (N, S, T, H, KV, d, causal, window, softcap): GQA, ragged and cross
# lengths, window, softcap, every head dim of the backward kernel; then the
# wgmma route's edges (bf16; f32 takes the FMA route): lengths no multiple
# of its 64- and 128-row tiles, S != T both ways (causal with S < T leaves
# whole kv tiles unseen), GQA rep 1, 2 and 4, window, softcap, rows without
# keys, d 32 (padded to 64), 64 and 128, and more work items than SMs in
# both of its kernels
FLASH_BWD_CASES = [(2, 100, 100, 4, 2, 64, True, None, None),
                   (2, 64, 64, 4, 4, 128, True, None, None),
                   (1, 70, 90, 4, 2, 32, False, None, None),
                   (1, 150, 70, 4, 1, 16, True, None, None),
                   (2, 128, 128, 4, 2, 64, True, 16, None),
                   (2, 96, 96, 2, 1, 64, True, None, 30.0),
                   (1, 64, 64, 2, 1, 256, True, None, None),
                   (1, 130, 130, 8, 2, 128, True, 37, 5.0),
                   (2, 200, 200, 8, 8, 128, True, None, None),
                   (1, 333, 129, 8, 4, 128, True, None, None),
                   (2, 77, 301, 8, 2, 64, False, None, None),
                   (1, 100, 257, 4, 2, 128, True, None, None),
                   (1, 260, 260, 8, 2, 128, True, 50, 3.0),
                   (2, 190, 190, 4, 1, 64, False, None, 5.0),
                   (1, 150, 70, 4, 2, 32, True, 20, None),
                   (16, 600, 600, 8, 4, 64, True, None, None),
                   (2, 200, 200, 8, 8, 112, True, None, None)]
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_inputs(case, dtype, dev):
    N, S, T, H, KV, d = case[:6]
    g = torch.Generator(device=dev).manual_seed(sum(case[:6]))
    q = torch.randn((N, S, H, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((N, T, KV, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    dout = torch.randn((N, S, H, d), generator=g, device=dev).to(dtype)
    return q, k, v, dout


def _assert_grads_close(got, want, dtype):
    tol = FLASH_BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= tol + tol * b.float().abs()).all()), (
            name, diff.max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain(card, case, dtype):
    """dq, dk, dv of the backward kernel against the plain backward
    (autograd through the plain version) within tol + tol |plain|, and two
    runs bitwise equal (no atomics)."""
    kw = dict(zip(("causal", "window", "softcap"), case[6:]))
    q, k, v, dout = _bwd_inputs(case, dtype, card)
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    _, want_lse = fa_ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    got = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    _assert_grads_close(got, want, dtype)
    for name, a, c in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, c), name


def test_flash_autograd_launches_the_backward_kernel(card):
    """Autograd through ``flash_attention`` on the card: the forward (with
    its log-sum-exp) and the backward kernel launch once each, the backward
    on the wgmma route (bf16, d 64); a forward without a gradient writes no
    log-sum-exp and gives the same output."""
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn((2, 64, 4, 64), generator=g, device=card,
                    dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn((2, 64, 2, 64), generator=g, device=card,
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    f0, b0 = fa_ops.launches, fa_ops.bwd_launches
    r0 = dict(fa_ops.bwd_route_launches)
    out = fa_ops.flash_attention(q, k, v)
    out.float().square().sum().backward()
    assert (fa_ops.launches - f0, fa_ops.bwd_launches - b0) == (1, 1)
    assert fa_ops.bwd_route_launches == {
        r: n + (r == "wgmma") for r, n in r0.items()}
    with torch.no_grad():
        plain = fa_ops.flash_attention(q, k, v)
    assert torch.equal(plain, out.detach())
    want = fa_ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                          2 * out.detach())
    for a, b in zip((q.grad, k.grad, v.grad), want):
        assert bool(((a.float() - b.float()).abs()
                     <= 2e-2 + 2e-2 * b.float().abs()).all())


# (N, S, T, H, KV, d, causal, window, softcap) on the wgmma route at d 256
# (bf16; its own dQ and dK/dV kernels): a window with a softcap, lengths no
# multiple of the 128-row q item, the 64-row kv item or the 32-row key
# tile, S != T both ways, GQA rep 1, 2 and 4, a padded head dim (192 ->
# 256), and more work items than SMs in both kernels (gemma3-1b's heads and
# window)
WGMMA_256_BWD_CASES = [(1, 260, 260, 4, 1, 256, True, 50, 3.0),
                       (2, 333, 129, 4, 4, 256, True, None, None),
                       (2, 77, 301, 8, 2, 256, False, None, None),
                       (1, 100, 257, 4, 2, 256, True, None, None),
                       (3, 130, 130, 4, 1, 192, True, 37, None),
                       (2, 190, 190, 4, 1, 256, False, None, 5.0),
                       (16, 600, 600, 4, 1, 256, True, 512, None)]


@pytest.mark.parametrize("case", WGMMA_256_BWD_CASES)
def test_flash_wgmma_backward_at_d256_matches_plain(card, case):
    """The wgmma backward at d 256 against the plain backward within 2e-2 +
    2e-2 |plain|, one launch on the wgmma route, two runs bitwise equal."""
    kw = dict(zip(("causal", "window", "softcap"), case[6:]))
    assert fa_ops.bwd_route(torch.bfloat16, case[5]) == ("wgmma", 256)
    q, k, v, dout = _bwd_inputs(case, torch.bfloat16, card)
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    r0 = fa_ops.bwd_route_launches["wgmma"]
    got = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    assert fa_ops.bwd_route_launches["wgmma"] == r0 + 2
    want = fa_ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    _assert_grads_close(got, want, torch.bfloat16)
    for name, a, c in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, c), name


# (dtype, head dim) -> the route the backward takes (ops.bwd_route)
FLASH_BWD_ROUTES = [(torch.bfloat16, 128, "wgmma"),
                    (torch.bfloat16, 64, "wgmma"),
                    (torch.bfloat16, 32, "wgmma"),
                    (torch.bfloat16, 256, "wgmma"),
                    (torch.float32, 128, "fma")]


@pytest.mark.parametrize("dtype,d,route", FLASH_BWD_ROUTES)
def test_flash_backward_takes_its_route(card, dtype, d, route):
    """Each call counts one backward launch, on its route's counter only,
    and agrees with the plain backward; the fp32-FMA kernels run bf16 too
    when asked (the old kernel, timed beside the new)."""
    case = (2, 150, 150, 4, 2, d, True, None, None)
    q, k, v, dout = _bwd_inputs(case, dtype, card)
    out, lse = fa_ops.flash_attention_lse(q, k, v)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, dout)
    assert fa_ops.bwd_route(dtype, d)[0] == route
    dp = fa_ops.bwd_route(torch.float32, d)[1]
    fma = ("fma", dp, dp)
    for took, run in (
            (route, lambda: fa_ops.flash_attention_bwd(q, k, v, out, dout,
                                                       lse)),
            ("fma", lambda: fa_ops._backward(q, k, v, out, dout, lse, fma,
                                             True, None, None))):
        b0, r0 = fa_ops.bwd_launches, dict(fa_ops.bwd_route_launches)
        got = run()
        torch.cuda.synchronize()
        assert fa_ops.bwd_launches == b0 + 1
        assert fa_ops.bwd_route_launches == {
            r: n + (r == took) for r, n in r0.items()}
        _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_backward_reads_strided_views_in_place(card, d):
    """bf16 q/k/v as views of one fused (N, S, 3, H, d) projection and a
    cotangent that is a view too: the wgmma route reads them through their
    strides (TMA) and agrees with the plain backward; an expanded cotangent
    (stride 0) is copied first."""
    qkv = torch.randn(2, 150, 3, 4, d, device=card).bfloat16()
    q, k, v = qkv.unbind(2)
    k, v = k[:, :, :2], v[:, :, :2]
    douts = torch.randn(2, 150, 2, 4, d, device=card).bfloat16()
    kw = dict(window=40, softcap=4.0)
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    for dout in (douts[:, :, 1], douts[0, 0, 0, 0].expand(2, 150, 4, d)):
        assert fa_ops._rows_aligned(dout) == (dout.stride(0) != 0)
        got = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        want = fa_ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        _assert_grads_close(got, want, torch.bfloat16)


# (N, S, T, H, KV, d, causal, window, softcap, d_v) on the d_qk 192 / d_v
# 128 route (bf16: MLA's head dims read in place, or (160, 96) padded to
# them): lengths no multiple of 64 or 128, S != T both ways, q heads over kv
# heads at rep 1, 2 and 4, a window, softcaps, and more work items than SMs
# (deepseek-v3's 32 heads a rank)
MLA_ROUTE_CASES = [(2, 200, 200, 8, 8, 192, True, None, None, 128),
                   (1, 333, 129, 8, 4, 192, True, None, None, 128),
                   (2, 77, 301, 8, 2, 192, False, None, None, 128),
                   (1, 260, 260, 4, 1, 192, True, 50, 3.0, 128),
                   (3, 130, 130, 4, 2, 160, True, 37, None, 96),
                   (2, 190, 190, 4, 4, 192, False, None, 5.0, 128),
                   (4, 513, 513, 32, 32, 192, True, None, None, 128)]


def _mla_inputs(case, dev):
    """bf16 q, k, v (v of head dim d_v) and a cotangent of the output."""
    N, S, T, H, KV, d = case[:6]
    dv = case[9]
    g = torch.Generator(device=dev).manual_seed(sum(case[:6]) + dv)
    return tuple(torch.randn(shape, generator=g, device=dev).bfloat16()
                 for shape in ((N, S, H, d), (N, T, KV, d), (N, T, KV, dv),
                               (N, S, H, dv)))


@pytest.mark.parametrize("case", MLA_ROUTE_CASES)
def test_flash_mla_route_forward_matches_plain(card, case):
    """The d_qk 192 / d_v 128 forward (one launch on its route) against the
    plain version within 2e-2 + 2e-2 |plain|, an output of v's head dim and
    the plain version's log-sum-exp."""
    kw = dict(zip(("causal", "window", "softcap"), case[6:9]))
    assert fa_ops.route(torch.bfloat16, case[5], case[9]) == (
        "wgmma192", 192, 128)
    q, k, v, _ = _mla_inputs(case, card)
    r0 = fa_ops.route_launches["wgmma192"]
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.route_launches["wgmma192"] == r0 + 1
    want, want_lse = fa_ref.flash_attention_ref(q, k, v, return_lse=True,
                                                **kw)
    assert out.shape == want.shape == q.shape[:3] + (case[9],)
    want = want.float()
    assert ((out.float() - want).abs() <= 2e-2 + 2e-2 * want.abs()).all()
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", MLA_ROUTE_CASES)
def test_flash_mla_route_backward_matches_plain(card, case):
    """The d_qk 192 / d_v 128 backward (launches on its route) against the
    plain backward within 2e-2 + 2e-2 |plain|, dv of v's head dim, two runs
    bitwise equal."""
    kw = dict(zip(("causal", "window", "softcap"), case[6:9]))
    q, k, v, dout = _mla_inputs(case, card)
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    r0 = fa_ops.bwd_route_launches["wgmma192"]
    got = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    assert fa_ops.bwd_route_launches["wgmma192"] == r0 + 2
    want = fa_ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    _assert_grads_close(got, want, torch.bfloat16)
    for name, a, c in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, c), name


def test_flash_mla_route_reads_strided_views_in_place(card):
    """q and k as views of one fused (N, S, 2, H, 192) projection, v and the
    cotangent as 128 columns of wider tensors: every stride a multiple of
    16 bytes, so both directions read them in place on the d_qk 192 / d_v
    128 route (autograd included) and agree with the plain version."""
    qk = torch.randn(2, 150, 2, 4, 192, device=card).bfloat16()
    q, k = qk.unbind(2)
    v = torch.randn(2, 150, 4, 256, device=card).bfloat16()[..., :128]
    dout = torch.randn(2, 150, 4, 256, device=card).bfloat16()[..., 128:]
    assert all(fa_ops._rows_aligned(t) and not t.is_contiguous()
               for t in (q, k, v, dout))
    kw = dict(window=40, softcap=4.0)
    f0 = fa_ops.route_launches["wgmma192"]
    b0 = fa_ops.bwd_route_launches["wgmma192"]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, **kw)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fa_ops.route_launches["wgmma192"] == f0 + 1
    assert fa_ops.bwd_route_launches["wgmma192"] == b0 + 1
    want = fa_ref.flash_attention_ref(q, k, v, **kw).float()
    assert ((out.detach().float() - want).abs()
            <= 2e-2 + 2e-2 * want.abs()).all()
    _assert_grads_close(tuple(t.grad for t in leaves),
                        fa_ref.flash_attention_bwd_ref(q, k, v, dout, **kw),
                        torch.bfloat16)


# sha256 of the wgmma forward's output and log-sum-exp on numpy-seeded bf16
# inputs (every row sees a key), as the forward kernel gave them before its
# tensor maps moved into csrc/tma_map.cuh (read from the earlier kernel on
# an NVIDIA H100 80GB HBM3): the move must leave every bit as it was
FLASH_FWD_DIGESTS = {
    (2, 300, 300, 8, 2, 128, True, None, None):
        "b2502fcf1234d1ab8d1b3d6ea0f01f61e45eb7d50ea5bb38f7ca4f673564ff04",
    (1, 200, 333, 4, 4, 64, False, 50, 5.0):
        "de5b5aa68caf47a2e89d002e234e5c0cdded22408b7df6ff6ba9235a5869690c",
    (2, 190, 190, 8, 2, 32, True, None, None):
        "e88e53e28eae44c61f5c9e8fd0a08a69fc75a564ea944aa6d45f5f760de04d5f",
}


def flash_forward_digest(case, dev) -> str:
    """sha256 of ``flash_attention_lse``'s output and log-sum-exp, and of
    ``flash_attention``'s output (which must equal the former), for bf16
    inputs made from a numpy seed."""
    import hashlib
    N, S, T, H, KV, d = case[:6]
    kw = dict(zip(("causal", "window", "softcap"), case[6:]))
    rng = np.random.RandomState(1234)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .bfloat16().to(dev)
               for shape in ((N, S, H, d), (N, T, KV, d), (N, T, KV, d)))
    out, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(fa_ops.flash_attention(q, k, v, **kw), out)
    h = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes())
    h.update(lse.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("case", list(FLASH_FWD_DIGESTS))
def test_flash_forward_is_bitwise_what_it_was(card, case):
    assert flash_forward_digest(case, card) == FLASH_FWD_DIGESTS[case]


def test_group_gather_holds_its_output_once(card):
    """A data-group all-gather on a (data=2, model=4) stack (the ZeRO-1
    update's): ``groups`` writes each group's result into the one output,
    so the call's peak stays under 1.75x the output (the output, one
    group's result and its concatenated message: 1.375x here)."""
    from repro_torch.launch import mesh as mesh_mod
    data = Communicator.from_mesh(mesh_mod.make_test_mesh(2, 4),
                                  ("data", "model")).split("data")
    x = torch.randn(8, 1 << 22, device=card)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    out = collectives.all_gather(x, data, CommConfig(), axis=0, tiled=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    assert out.shape == (8, 2 << 22)
    assert peak < 1.75 * out.numel() * out.element_size(), peak
    for d in range(2):
        assert torch.equal(out.view(2, 4, -1)[d],
                           torch.cat((x[:4], x[4:]), dim=1))


# (R, B, S, H, G, P, N, chunk): G = 1 and G > 1, P and N that are no
# multiple of 16 (the wrapper pads 12 -> 16, 20 -> 24), a single chunk, a
# chunk that is no multiple of 16; mamba2-130m's training head is held in
# float64 below (its decay's cumulative sums reach ~1e3, where two right
# f32 orders differ by more than 1e-4)
SSD_BWD_SHAPES = [
    (1, 1, 32, 2, 1, 8, 8, 16),
    (2, 1, 64, 3, 1, 16, 8, 16),
    (1, 2, 48, 2, 1, 12, 20, 16),
    (1, 1, 64, 4, 2, 32, 16, 64),
    (2, 1, 120, 6, 3, 24, 40, 40),
    (1, 1, 256, 4, 1, 64, 64, 128),
]
# the kernel vs autograd of the plain version, tol + tol |plain|: 1e-4 in
# f32 (the forward's bound); bf16 inputs make both compute in f32 from the
# same values, but dx, dB and dC leave in bf16, where two f32 results a
# rounding apart may round one bf16 step apart (2^-7 of |plain| at most)
SSD_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 2**-7)}


def _ssd_bwd_inputs(shape, dtype, card, steep=False):
    R, B, S, H, G, P, N, chunk = shape
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=card)
    if steep:   # the model's decay: dt = softplus(N(0, 1)), A to -16
        dt = torch.nn.functional.softplus(rnd(R, B, S, H))
        a = -torch.linspace(1.0, 16.0, R * H, device=card).view(R, H)
    else:
        dt, a = rnd(R, B, S, H).abs() * 0.1 + 0.01, -(rnd(R, H).abs() + 0.5)
    return ((rnd(R, B, S, H, P).to(dtype), dt, a,
             rnd(R, B, S, G, N).to(dtype), rnd(R, B, S, G, N).to(dtype)),
            rnd(R, B, S, H, P), rnd(R, B, H, N, P))


def _ssd_grads(fn, inp, chunk, dy, dh):
    """(dx, ddt, dA, dB, dC) of <y, dy> + <h_final, dh> through ``fn``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inp]
    y, h = fn(*leaves, chunk)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_backward_matches_plain(card, shape, dtype):
    """The backward kernel against autograd of the plain version, with and
    without a cotangent of h_final: every gradient within the bound, two
    runs bitwise equal, one backward launch a call."""
    inp, dy, dh = _ssd_bwd_inputs(shape, dtype, card)
    atol, rtol = SSD_BWD_TOL[dtype]
    for cot in (None, dh):
        before = ssd_ops.bwd_launches
        got = _ssd_grads(ssd_ops.ssd_chunked, inp, shape[-1], dy, cot)
        again = _ssd_grads(ssd_ops.ssd_chunked, inp, shape[-1], dy, cot)
        torch.cuda.synchronize()
        assert ssd_ops.bwd_launches == before + 2
        want = _ssd_grads(ssd_ref.ssd_chunked_ref, inp, shape[-1], dy, cot)
        for name, g, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, again,
                                 want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, a), f"{name}: two runs differ"
            err = (g.float() - w.float()).abs()
            assert (err <= atol + rtol * w.float().abs()).all(), (
                name, err.max().item())


@pytest.mark.parametrize("steep", [True, False], ids=["steep", "shallow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_against_float64(card, dtype, steep):
    """4 chunks of the training head under the model's steep decay and the
    unit shapes' shallow one: against the plain backward in float64, each
    gradient errs at most twice as much as the f32 plain backward plus 1e-6
    of its max, the forward's gate."""
    shape = (2, 2, 512, 6, 1, 64, 128, 128)
    inp, dy, dh = _ssd_bwd_inputs(shape, dtype, card, steep=steep)
    got = _ssd_grads(ssd_ops.ssd_chunked, inp, 128, dy, dh)
    plain = _ssd_grads(ssd_ref.ssd_chunked_ref, inp, 128, dy, dh)
    exact = _ssd_grads(ssd_ref.ssd_chunked_ref,
                       [t.double() for t in inp], 128, dy.double(),
                       dh.double())
    for name, g, p, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, plain,
                             exact):
        err_k = (g.double() - e).abs().max().item()
        err_p = (p.double() - e).abs().max().item()
        assert err_k <= 2 * err_p + 1e-6 * e.abs().max().item(), (
            name, err_k, err_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_raises_and_never_falls_back(card, monkeypatch, dtype):
    """The backward on the card runs the kernel or raises, on both routes
    (f32, and bf16's wgmma kernels): with the plain version made to raise
    it still answers; a library that does not build, or a launch that
    fails, raises."""
    shape = SSD_BWD_SHAPES[1]
    inp, dy, _ = _ssd_bwd_inputs(shape, dtype, card)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ssd_ref, "ssd_chunked_ref", refuse)
    grads = _ssd_grads(ssd_ops.ssd_chunked, inp, shape[-1], dy, None)
    assert all(torch.isfinite(g).all() for g in grads)

    class Broken:
        def __init__(self, fail_build):
            self.fail_build = fail_build

        def load(self):
            if self.fail_build:
                raise RuntimeError("nvcc failed")
            return self

        def ssd_scan_bwd_launch(self, *args):
            return 1   # cudaErrorInvalidValue
    for fail_build, match in ((True, "nvcc"), (False, "launch failed")):
        monkeypatch.setattr(ssd_ops, "BWD_LIBRARY", Broken(fail_build))
        before = ssd_ops.bwd_launches
        with pytest.raises(RuntimeError, match=match):
            _ssd_grads(ssd_ops.ssd_chunked, inp, shape[-1], dy, None)
        assert ssd_ops.bwd_launches == before


def test_train_steps_on_the_card_match_the_cpu(card):
    """Three AdamW steps of the smoke config (f32) on a (2, 2) stack, ZeRO-1,
    on the card against the CPU port: losses within 5e-4, the first step's
    gradients within 1e-4 of each leaf's max|grad|, parameters within 8e-3
    (``tests/test_torch_train.py``'s bounds); two card runs bitwise equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.models import sharding
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"),
                              dtype=torch.float32)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (4, 32)),
             "labels": rng.randint(0, cfg.vocab_size, (4, 32))}
    oc = adamw.OptConfig(lr=1e-2, warmup_steps=1, total_steps=100,
                         zero1=True)
    full = None
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", card), ("card2", card)):
        sess = setup.build_session(cfg, mesh_mod.make_test_mesh(2, 2),
                                   CommConfig(), oc=oc, device=dev)
        if full is None:
            full = setup.global_params(sess)
        sess.params = setup.stacked_params(sess, full)
        stacked = setup.shard_batch(sess, batch)
        _, _, grads = ts.make_loss_and_grad(sess.rt)(sess.params, stacked)
        grads = sharding.unshard_params(grads, cfg, 2)
        step = setup.make_sharded_train_step(sess)
        p, o, losses = sess.params, sess.opt_state, []
        for _ in range(3):
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
        runs[name] = (losses, grads, setup.global_params(sess, p))
    np.testing.assert_allclose(runs["card"][0], runs["cpu"][0], atol=5e-4,
                               rtol=0)
    for (n, a), (_, b) in zip(adamw.leaves_with_names(runs["card"][1]),
                              adamw.leaves_with_names(runs["cpu"][1])):
        err = float((a.cpu() - b).abs().max() / (b.abs().max() + 1e-12))
        assert err < 1e-4, (n, err)
    for (n, a), (_, b) in zip(adamw.leaves_with_names(runs["card"][2]),
                              adamw.leaves_with_names(runs["cpu"][2])):
        err = float((a.cpu() - b).abs().max() / (b.abs().max() + 1e-9))
        assert err < 8e-3, (n, err)
    assert runs["card"][0] == runs["card2"][0]
