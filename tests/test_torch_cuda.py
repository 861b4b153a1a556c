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
source rank's block."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import collectives
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG,
                                     CommConfig, Compression, Scheduling)
from repro_torch.kernels.quant import ops as quant_ops, ref as quant_ref
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
