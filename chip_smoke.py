#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises and the script
exits non-zero:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, the build of every kernel from this checkout's sources (each
   kernel's ``-Xptxas -v`` registers and spills), and ``cuobjdump -sass``
   of the flash library, which must hold HGMMA (wgmma) and UTMALDG (TMA)
   instructions;
2. every kernel held against its plain PyTorch version on the card, at the
   test shapes and at the main paths' full-size shapes (``swe_step`` with
   and without the boundary row list; ``quantize``/``dequantize`` at blocks
   256 and 1024, f32 and bf16), and timed with CUDA events beside its
   bound;
3. the main path at full size — the bight mesh at 312,000 target elements
   (270,886 elements) on 48 stacked ranks — under the fused, overlapped and
   host-scheduled configurations for 200 steps (20-step segments): final
   states bitwise equal, mass drift, finiteness, and the kernel launch
   counts; then one fused run with the plain version, against the kernel run,
   and a profile of one fused and one overlapped segment (device time by
   kernel, ``swe_step``'s passes among them);
4. routing: the 1696-element mesh on a 2x4 torus (8 ranks) and the full size
   on a 6x8 torus (48 ranks), each bitwise equal to its flat run;
5. the int8 wire (the ``quantize``/``dequantize`` kernels, checked
   against their plain version and timed in phase 2): the ZeRO-1 gradient
   sync of mamba2-130m's 128,915,904 f32 gradients over 8 ranks (ring
   reduce-scatter + all-gather, and ring all-reduce) on the NONE, BF16 and
   INT8 wires; the autotuner sweep (sendrecv and the 4-neighbor exchange at
   48 ranks, the ring collectives over the full axes at 8 ranks, the Eq. 1
   fit); and ``comm_cfg="auto"`` at full size from that TuneDB, flat and on
   a 6x8 torus, bitwise equal to the runs with the selected configs given
   explicitly;
6. the reliable wire and the elastic runtime at full size: fused,
   overlapped and host with 512 B wire chunks (a 1,104 B halo round is 3
   chunks) under BEST_EFFORT and GUARANTEED on a clean wire and GUARANTEED
   under two seeded fault schedules, 200 steps each in 20-step segments
   (a new runner build, and new delivery-plan draws, per segment): every
   final state bitwise equal to the lossless run, the wire counters still
   on a clean wire and moving under faults, µs/step per cell; one
   profiled fused segment per cell, the clean GUARANTEED one launching
   BEST_EFFORT's kernels and a faulted one the clean count plus its extra
   slots' permutes; the JAX package's 30-cell parity matrix on the card
   against the CPU; the int8 ring all-reduce (8 ranks, 1 MiB) under faults
   bitwise equal to the clean run, and an int8 sendrecv whose recovery
   rounds launch the quant kernels once per slot; the elastic runtime
   (``run_swe_elastic``) on the 6x8 torus for 60 steps from the sweep's
   TuneDB, fault-free, rank 17 lost at step 20 (twice) and a degraded link
   with chunk loss: final digests equal to the fault-free run, same-seed
   digest streams equal, no sweep, the expected recoveries with their wall
   times, device memory flat; and a sendrecv sweep at 48 ranks, 1 MiB, on
   a clean and a lossy (0.05) wire, its two winners printed;
7. the LM serving path: the flash-attention kernel (bf16 at d 64 and 128:
   the wgmma + TMA kernel) against its plain version at the serving shape
   (bf16, N = 16, S = T = 1024, 8 q heads over 2 kv heads, d = 128, causal)
   and on a grid of small shapes (window, softcap, ragged and cross
   lengths, f32), timed beside its plain version,
   ``scaled_dot_product_attention`` and its bound, with the card's SM clock
   sampled beside the timing; then qwen3-8b at full
   width (36 layers, d_model 4096, vocab 151,936, bf16, tp = 4 stacked,
   random weights from seed 0) serving 8 requests in waves of 4 with
   1024-token prompts through ``examples/serve_lm_torch.py``, one wave's
   prefill through the kernel against the same prefill through the plain
   version, one prefill and one decode step profiled by kernel, the
   overlapped row-parallel combine against the whole matmul + all-reduce,
   and the smoke config in f32 on the card against the CPU;
8. the SSM serving path: the SSD chunked-scan kernel against its plain
   version at test_ssd_scan_sweep's shapes (f32) and at the serving shape
   (tp 4 x batch 8 x 6 heads, 2048 tokens, head dim 64, state 128, chunk
   128; bf16 and f32, against the plain version in float64), timed beside
   its plain version and its bound, its three passes profiled by kernel
   (before phase 3, beside the other kernels); then mamba2-130m at full
   width (24 layers, d_model 768,
   vocab 50,280, bf16, tp = 4 stacked, random weights from seed 0) serving
   16 requests in waves of 8 with 2048-token prompts through
   ``examples/serve_lm_torch.py``, one wave's logits through the kernel
   against the plain version and against two faults planted in the plain
   version, one prefill and one decode step profiled by kernel, and the
   smoke config in f32 on the card against the CPU;
9. a ``kernels:`` line, the kernel table as one JSON line, and as the
   last line ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one, or when the repository
is missing beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ATOL_KERNEL = 1e-5      # tests/test_kernels.py::test_swe_step_sweep
ATOL_PLAIN_RUN = 1e-4   # tests/test_swe.py partition/mode parity bound
MASS_DRIFT = 5e-3       # tests/test_swe.py::test_mass_conservation_multidevice
STEPS, N_INNER = 200, 20
FULL_ELEMENTS, FULL_RANKS = 312000, 48
TIMED_RUNS = 60
SLEEP_CYCLES = 4_000_000   # ~2 ms at the H100's clock
COURANT = 0.4
# Device-memory bandwidth by card (NVIDIA data sheets); the H100 SXM figure
# is the default.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100 80GB HBM3": 3.35e12}
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_bandwidth(name: str) -> float:
    for key, bw in HBM_BYTES_PER_S.items():
        if key in name:
            return bw
    return HBM_BYTES_PER_S["H100 80GB HBM3"]


def smi_sample(tag: str) -> None:
    """The card's name, power limit and SM clock now (``nvidia-smi``),
    printed beside a timing."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"[{tag}] nvidia-smi: {out.splitlines()[0] if out else 'no answer'}")


# ----------------------------------------------------------------------
# Kernel inputs, bounds and timing
# ----------------------------------------------------------------------

def random_inputs(P, E, H, seed, device):
    """Seeded kernel inputs: positive depths, small momenta, every edge
    type, neighbour indices over [state | halo]."""
    rng = np.random.RandomState(seed)
    st = np.abs(rng.randn(P, E, 3)) * 0.1 + np.array([1.0, 0, 0])
    hl = np.abs(rng.randn(P, H, 3)) * 0.1 + np.array([1.0, 0, 0])
    nrm = rng.randn(P, E, 3, 2) * 0.01
    nidx = rng.randint(0, E + H, (P, E, 3))
    et = rng.randint(0, 4, (P, E, 3))
    area = np.abs(rng.randn(P, E)) * 1e-3 + 1e-4
    valid = (rng.rand(P, E) > 0.05).astype(np.float64)
    rows = rng.randint(0, E, (P, max(1, E // 7)))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    args = [f32(st), f32(hl), f32(nrm), i32(nidx), i32(et), f32(area),
            f32(valid), torch.ones((), dtype=torch.float32, device=device)]
    return args, i32(rows)


def kernel_bytes(args, rows) -> int:
    """Bytes the function must move for these inputs: each input byte it
    needs read once, each output byte written once.  Rows listed twice are
    updated once; land and sea edges read no neighbour index or row; only
    the referenced rows of ``[state | halo]`` are read."""
    state, halo, _, neigh_idx, edge_type = args[:5]
    P, E = state.shape[:2]
    ext = E + halo.shape[1]
    dev = state.device
    if rows is None:
        own = torch.arange(P * E, device=dev)
    else:
        own = torch.unique((torch.arange(P, device=dev).view(P, 1) * E
                            + rows.long()).reshape(-1))
    p, e = own // E, own % E
    nidx = neigh_idx.reshape(P * E, 3)[own].long()
    reads_nb = (edge_type.reshape(P * E, 3)[own] != 1) & (
        edge_type.reshape(P * E, 3)[own] != 2)
    ext_rows = (p.unsqueeze(1) * ext + nidx)[reads_nb]
    ext_read = torch.unique(torch.cat([p * ext + e, ext_rows])).numel()
    per_row = 24 + 12 + 4 + 4 + 12   # normals, edge_type, area, valid, out
    nbytes = (ext_read * 12 + own.numel() * per_row
              + int(reads_nb.sum().item()) * 4 + 4)   # + h_sea
    if rows is not None:
        nbytes += rows.numel() * 4
    return nbytes


def time_ms(fn, flush) -> float:
    """Median of TIMED_RUNS CUDA-event timings of ``fn``, with the L2 cache
    flushed before each run (the main path reads these arrays cold).  A
    sleep kernel ahead of each run lets the host enqueue the flush and the
    timed launch before the card reaches them, so the events time the
    device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
# Main path helpers
# ----------------------------------------------------------------------

def stable_dt(sim) -> float:
    """COURANT times the smallest area/perimeter over the fastest initial
    gravity wave: the explicit Rusanov update's stability limit."""
    edge = np.linalg.norm(sim.mesh.normals, axis=-1).sum(axis=1)
    c = np.sqrt(9.81 * sim.pm.state0[..., 0].max())
    return float(COURANT * (sim.mesh.area / edge).min() / c)


def mass(sim, state) -> float:
    s = state.detach().cpu().numpy().astype(np.float64)
    return float(np.sum(s[..., 0] * sim.pm.area * sim.pm.valid))


def run_fused(driver, sim, update=None):
    """Build the segment runner (captures its graph) and run STEPS steps;
    returns (state, microseconds per step of the replays)."""
    run = driver.make_sim_runner(sim, N_INNER, update=update)
    torch.cuda.synchronize()
    state, t = sim.state, 0.0
    t0 = time.perf_counter()
    for _ in range(STEPS // N_INNER):
        state = run(state, t)
        t += N_INNER * sim.swe.dt
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) / STEPS * 1e6


def profile_segment(driver, sim, step_us: float, label: str) -> None:
    """Device time by kernel over one replayed segment of ``sim``'s schedule:
    where a step's time goes on the card, the top eight kernels and every
    ``swe_step`` kernel.  The busy share is taken against ``step_us``, the
    unprofiled step time (the profiler slows the host down)."""
    from torch.profiler import ProfilerActivity, profile
    run = driver.make_sim_runner(sim, N_INNER)
    state = run(sim.state, 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(state, N_INNER * sim.swe.dt)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / N_INNER
    log(f"[profile] {label} segment: {len(rows)} kernel names, device busy "
        f"{busy:.1f} us/step of the {step_us:.1f} us/step measured above "
        f"({100 * busy / step_us:.1f} %)")
    for us, count, key in [r for i, r in enumerate(rows)
                           if i < 8 or "swe_" in r[2]]:
        log(f"[profile]   {us / N_INNER:8.2f} us/step  {count / N_INNER:5.1f}"
            f"/step  {key[:70]}")


def run_host(driver, sim):
    runner = driver.make_host_scheduled_runner(sim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = runner.run(sim.state, 0.0, STEPS)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / STEPS * 1e6
    check(runner.dispatches == 2 * STEPS,
          f"host runner dispatched {runner.dispatches}, want {2 * STEPS}")
    return state, us

# ----------------------------------------------------------------------
# The int8 wire: kernels, gradient sync, sweep, autotuned SWE
# ----------------------------------------------------------------------

QUANT_LENGTHS = (1, 255, 1000, 4097, 65536)   # per rank, 3 ranks
# mamba2-130m's parameter count (the leaf total of its JAX init) over 8
# data-parallel ranks: the ZeRO-1 gradient sync's stacked f32 gradient
GRAD_PARAMS, GRAD_RANKS = 128_915_904, 8
GRAD_TIMED_RUNS = 3
SWEEP_P2P_RANKS, SWEEP_RING_RANKS = 48, 8


def build_all(libraries) -> None:
    """Build every kernel library at once: one nvcc per source, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.load(), libraries.values()))
    for name, lib in libraries.items():
        log(f"[build] {name}: nvcc {lib.seconds:.2f} s")
        for line in lib.log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
                log(f"[build]   {_kernel_name(entry)}:")
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):
                log(f"[build]     {line.strip()}")


def ptxas_summary(build_log: str) -> dict:
    """Each kernel's ``-Xptxas -v`` registers and spill bytes, by name."""
    import re
    out, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1] if "'" in line else line)
            out[name] = {}
        elif name is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                m = re.search(pat, line)
                if m:
                    out[name][key] = int(m.group(1))
    return out


def _kernel_name(mangled: str) -> str:
    """The kernel's name and template arguments out of its mangled name
    (enough to tell the instantiations apart in the build log)."""
    import re
    m = re.search(r"\d+([a-z][a-z_]*_kernel)(I[^E]*E)?", mangled)
    return (m.group(1) + (m.group(2) or "")) if m else mangled


def sass_counts(library, opcodes) -> dict:
    """How many of each opcode ``cuobjdump -sass`` finds in the built
    library: proof of which instructions the kernels run."""
    from repro_torch.kernels import _build
    so = library.build_dir / f"lib{library.source.stem}-{library.digest()}.so"
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    return {op: sum(op in line for line in sass.splitlines())
            for op in opcodes}


def quant_bytes(P: int, n: int, block: int, itemsize: int,
                kind: str) -> int:
    """Bytes a quantize (or dequantize) call must move: each input byte read
    once, each output byte written once.  Quantize reads P*n values and
    writes every code of its blocks (the padded tail too) and one f32 scale
    per block; dequantize reads the P*n codes it needs and the scales and
    writes P*n values."""
    nb = -(-n // block)
    if kind == "quantize":
        return P * n * itemsize + P * nb * block + P * nb * 4
    return P * n + P * nb * 4 + P * n * itemsize


def check_quant(qops, qref, x, block) -> tuple[int, float]:
    """Kernels vs plain version on ``x``: scales bitwise, codes within one
    step, dequantized values bitwise for the same codes, and the round trip
    within 0.51 of the block's scale.  Returns the largest code difference
    and the largest dequantize difference."""
    q, s = qops.quantize(x, block)
    qr, sr = qref.quantize(x, block)
    P, n = x.shape[0], x[0].numel()
    check(torch.equal(s, sr), f"quantize scales differ (block {block}, "
          f"{tuple(x.shape)} {x.dtype})")
    codes = int((q.int() - qr.int()).abs().max().item()) if q.numel() else 0
    check(codes <= 1, f"quantize codes differ by {codes}")
    deq = 0.0
    for dt in (torch.float32, torch.bfloat16):
        d = qops.dequantize(q, s, tuple(x.shape), dt)
        dr = qref.dequantize(q, s, tuple(x.shape), dt)
        deq = max(deq, (d.float() - dr.float()).abs().max().item())
    check(deq == 0.0, f"dequantize differs from its plain version by {deq}")
    err = (qops.dequantize(q, s, tuple(x.shape), torch.float32)
           - x.float()).abs().reshape(P, -1)
    bound = 0.51 * s.expand(-1, -1, block).reshape(P, -1)[:, :n]
    check(bool((err <= bound).all()), "quantize round trip over 0.51 scale")
    return codes, deq


def phase_quant_kernels(dev, flush, bw) -> dict:
    """The int8 kernels against their plain version at the test shapes and
    at the gradient sync's full-size ring step, then timed at the main
    path's shape (block 256, f32)."""
    import torch.nn.functional as F
    from repro_torch.kernels.quant import ops as qops, ref as qref
    gen = torch.Generator(device=dev).manual_seed(2)
    seg = GRAD_PARAMS // GRAD_RANKS
    full = torch.randn((GRAD_RANKS, seg), generator=gen, device=dev) * 1e-3
    max_code, max_deq = 0, 0.0
    for block in (256, 1024):
        for dt in (torch.float32, torch.bfloat16):
            for n in QUANT_LENGTHS:
                x = (torch.randn((3, n), generator=gen, device=dev)
                     * torch.tensor([[0.5], [3.0], [40.0]], device=dev))
                c, d = check_quant(qops, qref, x.to(dt), block)
                max_code, max_deq = max(max_code, c), max(max_deq, d)
            c, d = check_quant(qops, qref, full.to(dt), block)
            max_code, max_deq = max(max_code, c), max(max_deq, d)
            log(f"[quant] block {block} {str(dt)[6:]}: test shapes and "
                f"{tuple(full.shape)} agree (codes within {c}, scales "
                f"bitwise, dequantize bitwise)")
    # How CUDA PyTorch divides by a Python scalar (the reason the plain
    # version divides tensor by tensor): scales of this input that a
    # reciprocal multiply rounds away from the IEEE amax / 127.
    amax = F.pad(full, (0, (-seg) % 256)).reshape(GRAD_RANKS, -1, 256) \
        .abs().amax(2)
    off = int(((amax / 127.0) != (amax / amax.new_full((), 127.0))).sum())
    log(f"[quant] amax / 127.0 (Python scalar) differs from the IEEE "
        f"division in {off} of {amax.numel()} scales of this input")
    q, s = qops.quantize(full, 256)
    shape = tuple(full.shape)
    cases = {"quantize": (lambda: qops.quantize(full, 256),
                          lambda: qref.quantize(full, 256)),
             "dequantize": (lambda: qops.dequantize(q, s, shape,
                                                    torch.float32),
                            lambda: qref.dequantize(q, s, shape,
                                                    torch.float32))}
    out = {}
    for name, (kern, plain) in cases.items():
        nbytes = quant_bytes(GRAD_RANKS, seg, 256, 4, name)
        k_ms, p_ms = time_ms(kern, flush), time_ms(plain, flush)
        out[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=nbytes / bw * 1e3,
                         bound_by="bytes", nbytes=nbytes,
                         max_abs_err=float(max_code if name == "quantize"
                                           else max_deq))
        log(f"[quant] {name} at {shape} block 256: kernel {k_ms * 1e3:.2f} "
            f"us, plain {p_ms * 1e3:.2f} us, bound {nbytes / bw * 1e6:.2f} "
            f"us ({nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s, bytes); "
            f"library call: none")
    return out


def time_cuda(fn, runs: int = GRAD_TIMED_RUNS) -> float:
    """Median ms of ``fn`` over ``runs`` CUDA-event timings after one warm
    run (for calls long enough that launch overhead does not count)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def with_plain_int8_wire(fn):
    """``fn()`` with the wire's int8 encode and decode taken from the plain
    version (``kernels/quant/ref.py``) instead of the kernels, on the same
    card: the same inputs, the same ring, the same reducer order."""
    from repro_torch.core import plugins
    from repro_torch.kernels.quant import ref as qref
    kernels = plugins.quant_ops
    plugins.quant_ops = qref
    try:
        return fn()
    finally:
        plugins.quant_ops = kernels


def phase_grad_sync(dev) -> dict:
    """The ZeRO-1 data-parallel gradient sync at full width: ring
    reduce-scatter then ring all-gather of mamba2-130m's f32 gradient over
    8 ranks, and the ring all-reduce, on the NONE, BF16 and INT8 wires.

    Gates: NONE within 1e-6 * sum_r |x_r| of ``x.sum(0)`` per element;
    BF16 within one bf16 rounding (2^-8 relative, 2^-9 plus the f32 sums'
    rounding) of ``sum_r |x_r|`` per element per hop; INT8 bitwise equal to
    the same ring run on the card through the plain quantizer, which
    tests/test_torch_quant.py holds bitwise to the JAX package's, plus one
    quantisation step (<= sum_r max|x_r| / 127) per hop as a sanity bound.
    Returns the INT8 run's kernel launches."""
    from repro_torch.core import collectives
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.config import CommConfig, Compression
    from repro_torch.kernels.quant import ops as qops
    comm = Communicator(("x",), (GRAD_RANKS,))
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = torch.randn((GRAD_RANKS, GRAD_PARAMS), generator=gen,
                        device=dev) * 1e-3
    exact = grads.sum(0)
    absum = grads.abs().sum(0)
    carried = grads.abs().amax(1).sum().item()   # bounds every carried sum
    hops = 2 * (GRAD_RANKS - 1)                  # rs + ag, or one all-reduce

    def zero1(cfg):
        seg = collectives.reduce_scatter(grads, comm, cfg)
        return collectives.all_gather(seg, comm, cfg)

    def run_all(cfg):
        return {"reduce_scatter+all_gather": zero1(cfg),
                "all_reduce": collectives.all_reduce(grads, comm, cfg)}

    launches, results = {}, {}
    for wire in ("none", "bf16", "int8"):
        cfg = CommConfig(algorithm="ring", compression=Compression(wire))
        qops.launches.update(quantize=0, dequantize=0)
        outs = run_all(cfg)
        torch.cuda.synchronize()
        if wire == "int8":
            launches = dict(qops.launches)
            check(launches == {"quantize": 2 * hops, "dequantize": 2 * hops},
                  f"int8 gradient sync launched {launches}, want "
                  f"{2 * hops} of each kernel")
            plain = with_plain_int8_wire(lambda: run_all(cfg))
            for k, out in outs.items():
                check(torch.equal(out, plain[k]),
                      f"int8 {k} differs from the plain int8 wire: max "
                      f"|kernel - plain| "
                      f"{(out - plain[k]).abs().max().item()}")
            log("[gradsync] int8 wire through the kernels is bitwise equal "
                "to the plain int8 wire on the same card, both collectives")
            del plain
        ms = {k: time_cuda(lambda k=k: zero1(cfg) if k.startswith("reduce")
                           else collectives.all_reduce(grads, comm, cfg))
              for k in outs}
        for k, out in outs.items():
            check(tuple(out.shape) == tuple(grads.shape)
                  and bool(torch.isfinite(out).all()), f"{wire} {k} shape")
            err = (out - exact).abs()
            if wire == "none":
                check(bool((err <= 1e-6 * absum).all()),
                      f"none {k} disagrees with x.sum(0)")
                results[k] = out
                bound = 0.0
            elif wire == "bf16":
                # one bf16 rounding of a partial sum (|p| <= sum_r |x_r|)
                # per hop, per element
                lim = hops * 2.0 ** -8 * absum
                check(bool((err <= lim).all()),
                      f"bf16 {k}: error over hops * 2^-8 * sum_r |x_r|")
                check(bool(((out - results[k]).abs() <= lim).all()),
                      f"bf16 {k} disagrees with the NONE wire")
                bound = lim.max().item()
                share = (err / lim).max().item()
                log(f"[gradsync] bf16 {k}: worst element at "
                    f"{100 * share:.2f} % of its own limit hops * 2^-8 * "
                    f"sum_r |x_r|")
                del lim
            else:
                # sanity bound; the gate is the bitwise check above
                bound = hops * carried / 127.0
                check(err.max().item() <= bound,
                      f"int8 {k}: error {err.max().item()} over {bound}")
                check((out - results[k]).abs().max().item() <= bound,
                      f"int8 {k} disagrees with the NONE wire")
            log(f"[gradsync] {wire} {k} on ({GRAD_RANKS}, {GRAD_PARAMS}) "
                f"f32: {ms[k]:.3f} ms; max|out - x.sum(0)| "
                f"{err.max().item():.3e} (bound {bound:.3e}), rms "
                f"{err.pow(2).mean().sqrt().item():.3e}")
            del err
        del outs
    log(f"[gradsync] int8 wire kernel launches: quantize "
        f"{launches['quantize']}, dequantize {launches['dequantize']}")
    profile_device_time("gradsync", lambda: collectives.all_reduce(
        grads, comm, CommConfig(algorithm="ring",
                                compression=Compression.INT8)))
    return launches


def profile_device_time(tag: str, fn) -> None:
    """Device time by kernel over one call of ``fn`` (already warm), and
    the card's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] profile: {len(rows)} kernel names, "
        f"{sum(r[1] for r in rows)} launches, device busy "
        f"{busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms profiled wall time")
    for us, count, key in rows[:8]:
        log(f"[{tag}]   {us / 1e3:8.3f} ms  {count:5d} launches  {key[:70]}")


def summarize_sweep(db, topo, collectives, sizes) -> None:
    for coll in collectives:
        for size in sizes:
            best = db.best(coll, size, topo)
            if best is None:
                continue
            c = best.config
            log(f"[sweep] {topo} {coll} {size} B: {best.us_per_call:.2f} us "
                f"({c['mode']}/{c['scheduling']}/{c['transport']}/"
                f"w{c['window']}/{c['chunk_bytes']}B/{c['compression']}/"
                f"{c['algorithm']})")


def phase_sweep(dev, db_path) -> None:
    """The autotuner: sendrecv and the 4-neighbor exchange at 48 ranks over
    the fast axes, and the ring collectives at 8 ranks over the full axes
    at 1 MiB (every int8 ring candidate); the Eq. 1 fit on the 48-rank
    sendrecv points.  Saves the TuneDB to ``db_path``."""
    from repro_torch import tune
    from repro_torch.tune import sweep
    from repro_torch.kernels.quant import ops as qops
    t0 = time.perf_counter()
    db = tune.TuneDB()
    p2p = ("sendrecv", "multi_neighbor")
    ring = ("all_reduce", "reduce_scatter", "all_gather")
    stats = {}
    sweep.run_sweep(SWEEP_P2P_RANKS, collectives=p2p,
                    sizes=sweep.FULL_SIZES, fast=True, db=db, device=dev,
                    stats=stats)
    log(f"[sweep] {SWEEP_P2P_RANKS} ranks: {sweep.sweep_summary(stats)}")
    qops.launches.update(quantize=0, dequantize=0)
    stats = {}
    sweep.run_sweep(SWEEP_RING_RANKS, collectives=ring, sizes=(1 << 20,),
                    db=db, device=dev, stats=stats)
    log(f"[sweep] {SWEEP_RING_RANKS} ranks: {sweep.sweep_summary(stats)}")
    n_int8 = sum(1 for e in db.entries if e.config["compression"] == "int8")
    check(n_int8 == 3 * sum(1 for c in tune.enumerate_configs("all_reduce")
                            if c.compression.value == "int8"),
          f"the sweep measured {n_int8} int8 ring candidates")
    check(qops.launches["quantize"] > 0 and qops.launches["dequantize"] > 0,
          "the int8 ring candidates never launched the kernels")
    check(all(math.isfinite(e.us_per_call) and e.us_per_call > 0
              for e in db.entries), "a sweep entry is not a positive time")
    log(f"[sweep] int8 candidates: {n_int8}; kernel launches (captured "
        f"once per graph): quantize {qops.launches['quantize']}, dequantize "
        f"{qops.launches['dequantize']}")
    summarize_sweep(db, tune.topology_key(SWEEP_P2P_RANKS, dev), p2p,
                    sweep.FULL_SIZES)
    topo8 = tune.topology_key(SWEEP_RING_RANKS, dev)
    summarize_sweep(db, topo8, ring, (1 << 20,))
    for coll in ring:
        for wire in ("none", "bf16", "int8"):
            best = min((e for e in db.candidates(coll, topo8)
                        if e.config["compression"] == wire
                        and e.config["algorithm"] == "ring"),
                       key=lambda e: e.us_per_call)
            log(f"[sweep] {coll} 1 MiB best ring/{wire}: "
                f"{best.us_per_call:.2f} us ({best.config['scheduling']})")
    cal = tune.calibrate_from_db(db, tune.topology_key(SWEEP_P2P_RANKS, dev))
    log(f"[sweep] Eq. 1 fit on {SWEEP_P2P_RANKS}-rank sendrecv: "
        f"{cal.summary()}")
    db.save(db_path)
    log(f"[sweep] {len(db)} entries in {time.perf_counter() - t0:.1f} s")


def phase_auto(driver, sim, db_path, dev) -> int:
    """comm_cfg="auto" at full size from the sweep's TuneDB, flat and on a
    6x8 torus (per-round configs): each run bitwise equal to the same run
    with the selected configs given explicitly.  Returns swe_step
    launches."""
    from repro_torch import tune
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.config import Scheduling
    from repro_torch.core.topology import TorusSpec
    from repro_torch.kernels.swe_step import ops as swe_ops
    t0 = time.perf_counter()
    auto = driver.build_simulation(FULL_ELEMENTS, FULL_RANKS, "auto",
                                   device=dev, tune_db_path=db_path)
    auto.swe = sim.swe
    pm = sim.pm
    halo_bytes = int(pm.s_max) * 12
    spec = TorusSpec.parse("6x8")
    db = tune.TuneDB.load(db_path)
    topo = tune.topology_key(FULL_RANKS, dev)
    flat = Communicator(("data",), (FULL_RANKS,))
    want = tune.select_config(
        "multi_neighbor", halo_bytes, db=db, topo=topo,
        hops=flat.max_hops([e for r in pm.rounds for e in r]), torus="")
    check(auto.comm_cfg == want, f"auto picked {auto.comm_cfg}, the TuneDB "
          f"says {want}")
    cfg_t, rounds_t = driver._resolve_comm_cfg("auto", pm, spec, dev,
                                              db_path, "latency")
    torus = Communicator(("data",), (FULL_RANKS,), topo=spec)
    explicit_rounds = [dataclasses.replace(tune.select_config(
        "multi_neighbor", halo_bytes, db=db, topo=topo,
        hops=max(1, torus.max_hops(r)), torus=spec.name),
        scheduling=cfg_t.scheduling) for r in pm.rounds]
    if rounds_t is not None:
        check(rounds_t == explicit_rounds, "per-round configs differ")
    runs = {
        "flat": (auto, dataclasses.replace(sim, comm_cfg=want)),
        "6x8 torus": (
            dataclasses.replace(auto, topology=spec, comm_cfg=cfg_t,
                                round_cfgs=rounds_t),
            dataclasses.replace(sim, topology=spec, comm_cfg=cfg_t,
                                round_cfgs=(None if rounds_t is None
                                            else explicit_rounds)))}
    swe_ops.launches = 0
    for label, (a, e) in runs.items():
        states = []
        for s in (a, e):
            if s.comm_cfg.scheduling == Scheduling.HOST:
                states.append(run_host(driver, s)[0])
            else:
                states.append(run_fused(driver, s)[0])
        check(torch.equal(*states), f"auto ({label}) differs from the run "
              f"with its configs given explicitly")
        check(bool(torch.isfinite(states[0]).all()), f"auto ({label}) NaN")
        c = a.comm_cfg
        log(f"[auto] {label}: {c.mode.value}/{c.scheduling.value}/"
            f"{c.transport.value}/w{c.window}/{c.chunk_bytes}B, per-round "
            f"configs {'none' if a.round_cfgs is None else len(set(a.round_cfgs))}"
            f"; bitwise equal to the explicit run over {STEPS} steps")
    launched = swe_ops.launches
    check(launched > 0, "the autotuned runs never launched swe_step")
    log(f"[auto] {time.perf_counter() - t0:.1f} s; swe_step launches "
        f"{launched}")
    return launched


# ----------------------------------------------------------------------
# The reliable wire and the elastic runtime
# ----------------------------------------------------------------------

# The smallest chunk CommConfig takes: a 1,104 B halo round is 3 chunks.
WIRE_CHUNK = 512
ELASTIC_STEPS, ELASTIC_SEGMENT = 60, 20
MATRIX_N = 8 * 128
INT8_RANKS, INT8_ELEMS, INT8_CHUNK = 8, (1 << 20) // 4, 1 << 16


def wire_cells():
    """The reliability cells: (reliability, fault schedule or None)."""
    from repro_torch.core.config import Reliability
    from repro_torch.core.reliable import WireFaults
    return {"best_effort": (Reliability.BEST_EFFORT, None),
            "guaranteed": (Reliability.GUARANTEED, None),
            "guaranteed+mixed": (Reliability.GUARANTEED, WireFaults(
                seed=5, drop=0.05, dup=0.02, reorder=0.1)),
            "guaranteed+drop": (Reliability.GUARANTEED,
                                WireFaults(seed=5, drop=0.2))}


def faults_name(f) -> str:
    """A fault schedule's rates, for the log."""
    if f is None:
        return "a clean wire"
    return (f"WireFaults(seed={f.seed}, drop={f.drop}, dup={f.dup}, "
            f"reorder={f.reorder})")


def kernel_counts(fn) -> dict:
    """Kernel launches by name over one profiled call of ``fn`` (graph
    replays included)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}


def segment_runner(driver, sim):
    """One runner build: a callable advancing N_INNER steps, and its
    delivery-plan tape."""
    if sim.comm_cfg.scheduling.value == "host":
        runner = driver.make_host_scheduled_runner(sim)
        return (lambda state, t: runner.run(state, t, N_INNER)[0]), \
            runner.tape
    run = driver.make_sim_runner(sim, N_INNER)
    return run, run.tape


def run_wire_cell(driver, sim, faults):
    """STEPS steps in N_INNER-step segments, each segment a new runner
    build under ``faults`` (the messages of every build draw anew, as the
    elastic runtime's segments do).  Each build runs its segment once
    untimed (a graph's first replay uploads it; a host runner's first step
    draws its plans), then again timed, and the timed result goes on.
    Returns the final state, µs per step of the timed runs, each build's
    extra slots and the wire counter deltas."""
    from repro_torch.core import reliable
    state, t, run_s, extra = sim.state, 0.0, 0.0, []
    before = reliable.wire_counters()
    with reliable.inject(faults):
        for _ in range(STEPS // N_INNER):
            run, tape = segment_runner(driver, sim)
            run(state, t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = run(state, t)
            torch.cuda.synchronize()
            run_s += time.perf_counter() - t0
            extra.append(tape.extra_slots)
            t += N_INNER * sim.swe.dt
            del run
    after = reliable.wire_counters()
    return state, run_s / STEPS * 1e6, extra, {
        k: after[k] - before[k] for k in after}


def phase_reliable_wire(driver, sim, want_state) -> None:
    """The reliable wire on the main path at full size: fused, overlapped
    and host under four reliability cells, each run bitwise equal to the
    lossless one; kernel counts of one profiled fused segment per cell."""
    from repro_torch.core import reliable
    from repro_torch.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG,
                                         CommConfig)
    t_phase = time.perf_counter()
    modes = {"fused": CommConfig(chunk_bytes=WIRE_CHUNK),
             "overlapped": dataclasses.replace(OVERLAPPED_CONFIG,
                                               chunk_bytes=WIRE_CHUNK),
             "host": dataclasses.replace(BASELINE_CONFIG,
                                         chunk_bytes=WIRE_CHUNK)}
    for mode, base in modes.items():
        for cell, (rel, faults) in wire_cells().items():
            msim = dataclasses.replace(
                sim, comm_cfg=dataclasses.replace(base, reliability=rel))
            state, us, extra, wire = run_wire_cell(driver, msim, faults)
            check(torch.equal(state, want_state),
                  f"{mode} {cell}: final state differs from the lossless "
                  f"run")
            if faults is None:
                check(not any(wire.values()), f"{mode} {cell}: wire "
                      f"counters moved on a clean wire: {wire}")
            else:
                check(wire["retransmits"] > 0,
                      f"{mode} {cell}: no retransmit: {wire}")
                check(faults.dup == 0 or wire["dup_dropped"] > 0,
                      f"{mode} {cell}: no duplicate dropped: {wire}")
            log(f"[wire] {mode} {cell}: {us:.1f} us/step over {STEPS} "
                f"steps; extra slots per build {extra} (sum "
                f"{sum(extra)}); wire {wire}; bitwise equal to the "
                f"lossless run")
    # one profiled fused segment per cell: the clean GUARANTEED program is
    # the BEST_EFFORT one, and a faulted build adds its extra slots'
    # permutes and nothing else
    counts, extras = {}, {}
    for cell, (rel, faults) in wire_cells().items():
        msim = dataclasses.replace(sim, comm_cfg=dataclasses.replace(
            modes["fused"], reliability=rel))
        with reliable.inject(faults):
            for _ in range(STEPS // N_INNER):   # builds, as run_wire_cell
                run, tape = segment_runner(driver, msim)
                state = run(msim.state, 0.0)    # its plans are drawn now
                if tape.extra_slots or faults is None:
                    break
        counts[cell] = kernel_counts(lambda: run(state, N_INNER *
                                                 msim.swe.dt))
        extras[cell] = tape.extra_slots
    check(counts["guaranteed"] == counts["best_effort"],
          "a clean GUARANTEED segment launches other kernels than "
          "BEST_EFFORT")
    # an extra slot runs one permute: a zero fill, a gather (index_select;
    # the vectorized variant where the chunk view is 16-byte aligned) and
    # a scatter (index_copy_), and nothing else
    clean = counts["best_effort"]
    for cell in ("guaranteed+mixed", "guaranteed+drop"):
        got, n_extra = counts[cell], extras[cell]
        check(n_extra > 0, f"{cell}: no build with extra slots")
        diff = {k: got.get(k, 0) - clean.get(k, 0)
                for k in set(got) | set(clean)}
        diff = {k: v for k, v in diff.items() if v}
        part = {"fill": sum(v for k, v in diff.items()
                            if "FillFunctor<float>" in k),
                "gather": sum(v for k, v in diff.items()
                              if "indexSelect" in k or "gather_kernel" in k),
                "scatter": sum(v for k, v in diff.items()
                               if "index_copy" in k)}
        want = N_INNER * n_extra
        check(part == {"fill": want, "gather": want, "scatter": want}
              and sum(diff.values()) == 3 * want,
              f"{cell}: kernel counts moved by {part} ({diff}), want "
              f"{want} permutes ({N_INNER} steps x {n_extra} extra slots)")
        log(f"[wire] profiled fused segment, {cell}: "
            f"{sum(got.values())} kernels = {sum(clean.values())} clean + "
            f"{N_INNER} steps x {n_extra} extra slots x 3 (fill, gather, "
            f"scatter)")
    log(f"[wire] clean GUARANTEED fused segment: {sum(clean.values())} "
        f"kernels, as BEST_EFFORT; {time.perf_counter() - t_phase:.1f} s")


def phase_reliable_checks(dev) -> int:
    """The JAX package's 30-cell parity matrix on the card against the CPU,
    the int8 ring under faults, and an int8 streamed sendrecv whose
    recovery rounds run the quant kernels.  Returns those kernels'
    launches on the reliable int8 check."""
    import itertools
    from repro_torch.core import collectives, reliable, streaming
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.config import (CommConfig, CommMode, Compression,
                                         Reliability, Scheduling, Transport)
    from repro_torch.kernels.quant import ops as qops
    W = reliable.WireFaults
    faults = {
        "clean": None,
        "drop": W(seed=1, drop_events=frozenset({(0, 0, 0), (0, 2, 0),
                                                 (0, 2, 1)})),
        "reorder": W(seed=1, reorder=0.9),
        "dup": W(seed=1, dup_events=frozenset({(0, 0), (0, 3)})),
        "combined": W(seed=1, drop=0.25, dup=0.2, reorder=0.3,
                      drop_events=frozenset({(0, 0, 0)}),
                      dup_events=frozenset({(0, 0)}))}
    perm = [(i, (i + 1) % 4) for i in range(4)]
    x = (torch.arange(4 * MATRIX_N, dtype=torch.float32)
         .reshape(4, MATRIX_N) * 0.37 + 1.0)

    def run(path, cfg, v):
        if path == "chunked":
            return streaming.chunked_permute(v, perm, cfg)
        if path == "buffered":
            return streaming.buffered_permute(v, perm, cfg)
        carry, msg = streaming.pipelined_consume(
            v, perm, cfg, consume=lambda c, i, m: c + m[:, 0],
            init=v.new_zeros(v.shape[0]))
        return msg + carry[:, None]

    n_cells = 0
    for path, sched, fname in itertools.product(
            ("chunked", "buffered", "pipelined"), ("fused", "overlapped"),
            faults):
        kw = dict(mode=CommMode.STREAMING, scheduling=Scheduling(sched),
                  transport=Transport.UNORDERED, window=2, chunk_bytes=512)
        cfg = CommConfig(reliability=Reliability.GUARANTEED, ack_timeout=1,
                         max_retransmits=4, backoff_base=1, backoff_cap=2,
                         **kw)
        lossless = run(path, CommConfig(**kw), x.to(dev)).cpu()
        outs, deltas = [], []
        for d in ("cpu", dev):
            b = reliable.wire_counters()
            with reliable.inject(faults[fname]):
                outs.append(run(path, cfg, x.to(d)).cpu())
            a = reliable.wire_counters()
            deltas.append({k: a[k] - b[k] for k in a})
        check(torch.equal(outs[1], lossless) and torch.equal(*outs),
              f"parity matrix {path}/{sched}/{fname}: not bitwise")
        check(deltas[0] == deltas[1], f"parity matrix {path}/{sched}/"
              f"{fname}: counters {deltas[1]} on the card, {deltas[0]} on "
              f"the CPU")
        d = deltas[1]
        check((fname != "clean" or not any(d.values()))
              and (fname not in ("drop", "combined") or d["retransmits"])
              and (fname != "dup" or d["dup_dropped"]),
              f"parity matrix {path}/{sched}/{fname}: witness {d}")
        n_cells += 1
    log(f"[wire] parity matrix on the card: {n_cells}/30 cells bitwise "
        f"equal to the lossless run and to the CPU, counters equal")

    comm = Communicator(("x",), (INT8_RANKS,))
    gen = torch.Generator(device=dev).manual_seed(4)
    grads = torch.randn((INT8_RANKS, INT8_ELEMS), generator=gen, device=dev)
    mixed = W(seed=5, drop=0.2, dup=0.02, reorder=0.1)
    ring = CommConfig(algorithm="ring", compression=Compression.INT8,
                      reliability=Reliability.GUARANTEED)
    clean = collectives.all_reduce(grads, comm, ring)
    with reliable.inject(mixed):
        faulted = collectives.all_reduce(grads, comm, ring)
        ids = reliable.message_count()
    check(torch.equal(clean, faulted), "int8 ring under faults differs")
    log(f"[wire] int8 ring all-reduce, {INT8_RANKS} ranks x 1 MiB, under "
        f"{faults_name(mixed)}: bitwise equal to the clean run; message "
        f"ids drawn {ids} "
        f"(the ring's hops take no delivery plan, as in the JAX package)")
    p2p = CommConfig(algorithm="ring", compression=Compression.INT8,
                     chunk_bytes=INT8_CHUNK,
                     reliability=Reliability.GUARANTEED)
    clean = collectives.sendrecv(grads, comm.ring_perm(), comm, p2p)
    torch.cuda.synchronize()
    qops.launches.update(quantize=0, dequantize=0)
    tape = reliable.PlanTape()
    with reliable.inject(mixed), tape.play():
        got = collectives.sendrecv(grads, comm.ring_perm(), comm, p2p)
    torch.cuda.synchronize()
    launches = dict(qops.launches)
    (plan,) = tape.plans
    check(torch.equal(got, clean), "int8 sendrecv under faults differs")
    check(launches == {"quantize": len(plan.slots),
                       "dequantize": plan.n_chunks},
          f"int8 recovery launched {launches}, want one quantize per slot "
          f"({len(plan.slots)}) and one dequantize per chunk "
          f"({plan.n_chunks})")
    log(f"[wire] int8 sendrecv, {INT8_RANKS} ranks x 1 MiB in "
        f"{plan.n_chunks} chunks of {INT8_CHUNK} B under "
        f"{faults_name(mixed)}: "
        f"{len(plan.slots)} slots ({plan.extra_slots} extra, "
        f"{plan.retransmits} retransmits, {plan.dup_dropped} dups "
        f"dropped), bitwise equal to the clean run; kernel launches "
        f"{launches}")
    return launches


def phase_elastic(driver, sim, db_path, dev) -> int:
    """The elastic runtime at full size on the 6x8 torus: fault-free, rank
    17 lost at step 20 (twice), and a degraded link plus chunk loss.
    Returns swe_step's launches over the phase."""
    from repro_torch.kernels.swe_step import ops as swe_ops
    from repro_torch.core.topology import TorusSpec
    from repro_torch.runtime.elastic import run_swe_elastic
    from repro_torch.runtime.faults import DegradationMonitor, FaultSchedule
    t_phase = time.perf_counter()
    spec = TorusSpec.parse("6x8")
    common = dict(comm_cfg="auto", n_steps=ELASTIC_STEPS,
                  segment=ELASTIC_SEGMENT, tune_db_path=db_path,
                  swe=sim.swe, device=dev, mesh=sim.mesh)
    swe_ops.launches = 0
    runs = {"none": run_swe_elastic(FULL_ELEMENTS, FULL_RANKS, spec,
                                    **common)}
    lost = FaultSchedule.parse("rank_lost@20=r17")
    runs["rank_lost"] = run_swe_elastic(FULL_ELEMENTS, FULL_RANKS, spec,
                                        schedule=lost, **common)
    runs["rank_lost again"] = run_swe_elastic(FULL_ELEMENTS, FULL_RANKS,
                                              spec, schedule=lost, **common)
    # hysteresis 1: the 60-step run observes three segment boundaries, so
    # the degraded link (from step 20) confirms at 40 and the lossy wire
    # (from 40) at 60
    runs["degraded+chunk_loss"] = run_swe_elastic(
        FULL_ELEMENTS, FULL_RANKS, spec,
        schedule=FaultSchedule.parse(
            "degraded_link@5=0-1x3.0;chunk_loss@40=0.05d0.02r0.1"),
        monitor=DegradationMonitor(threshold=1.5, hysteresis=1,
                                   cooldown=2 * ELASTIC_SEGMENT), **common)
    launched = swe_ops.launches
    ref = runs["none"]
    want_kinds = {"none": [], "rank_lost": ["rank_lost"],
                  "rank_lost again": ["rank_lost"],
                  "degraded+chunk_loss": ["degraded_link", "lossy_wire"]}
    for label, r in runs.items():
        kinds = [rec.kind for rec in r.recoveries]
        check(kinds == want_kinds[label], f"elastic {label}: recoveries "
              f"{kinds}, want {want_kinds[label]}")
        check(r.final_digest == ref.final_digest, f"elastic {label}: final "
              f"digest differs from the fault-free run")
        check(r.sweep_runs_delta == 0, f"elastic {label}: a sweep ran")
        check(r.steps_run == ELASTIC_STEPS, f"elastic {label}: "
              f"{r.steps_run} steps")
        us = [s * 1e6 / ELASTIC_SEGMENT for s in r.segment_s]
        log(f"[elastic] {label}: partitions {r.n_parts}; segment us/step "
            f"{[round(u, 1) for u in us]}; runner builds "
            f"{[round(b, 3) for b in r.build_s]} s; device MB allocated "
            f"{[round(b / 2**20, 1) for b in r.device_bytes]}; wire "
            f"retransmits {r.wire_retransmits}, dups {r.wire_dup_dropped}, "
            f"timeouts {r.wire_timeouts}")
        steps = [s for s, _ in r.digests]
        for rec in r.recoveries:
            i = len(steps) - 1 - steps[::-1].index(rec.step)
            after = (f"{us[i + 1]:.1f}" if i + 1 < len(us)
                     else "none (the run ends)")
            log(f"[elastic]   {rec.kind}@{rec.step}: {rec.detail}; "
                f"recovery {rec.wall_s:.3f} s; segment before {us[i]:.1f} "
                f"us/step, after {after}; configs changed "
                f"{rec.config_changed()}")
    check(runs["rank_lost"].digests == runs["rank_lost again"].digests,
          "same-seed rank-loss runs give different digest streams")
    check(runs["degraded+chunk_loss"].wire_retransmits > 0,
          "the chunk-loss run retransmitted nothing")
    mem = ref.device_bytes
    check(max(mem) - min(mem) <= 16 << 20, f"device memory grows over the "
          f"fault-free run: {mem}")
    check(launched > 0, "the elastic runs never launched swe_step")
    log(f"[elastic] {len(runs)} runs, final digests equal to the "
        f"fault-free run, same-seed digest streams equal, no sweep; "
        f"swe_step launches {launched}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


def phase_lossy_sweep(dev) -> None:
    """sendrecv at 48 ranks, 1 MiB, on a clean wire and at loss 0.05: the
    two winners (reported, not gated)."""
    from repro_torch import tune
    from repro_torch.tune import sweep
    t0 = time.perf_counter()
    topo = tune.topology_key(SWEEP_P2P_RANKS, dev)
    for loss in (0.0, 0.05):
        db = tune.TuneDB()
        sweep.run_sweep(SWEEP_P2P_RANKS, collectives=("sendrecv",),
                        sizes=(1 << 20,), fast=True, db=db, device=dev,
                        loss_rate=loss)
        best = db.best("sendrecv", 1 << 20, topo)
        c = best.config
        log(f"[sweep] sendrecv {SWEEP_P2P_RANKS} ranks 1 MiB at loss "
            f"{loss}: winner {best.us_per_call:.2f} us ({c['mode']}/"
            f"{c['scheduling']}/{c['transport']}/w{c['window']}/"
            f"{c['chunk_bytes']}B/{c['reliability']}) of {len(db)} "
            f"candidates")
    log(f"[sweep] lossy sweep {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------
# The LM serving path: the flash-attention kernel and qwen3-8b
# ----------------------------------------------------------------------

# tests/test_kernels.py's flash-attention bounds, its atol = rtol form:
# |kernel - plain| <= tol + tol * |plain| per element
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 (tensor cores)
# (N, S, T, H, KV, d, causal, window, softcap): the serving shape, then a
# grid over the options, ragged and cross lengths and every head dim
FLASH_SERVE = (16, 1024, 1024, 8, 2, 128, True, None, None)
FLASH_GRID = [
    (2, 64, 64, 4, 2, 16, True, None, None),
    (2, 100, 77, 4, 4, 32, False, None, None),
    (1, 130, 200, 8, 2, 64, True, 37, None),
    (3, 65, 129, 4, 1, 128, False, None, 5.0),
    (1, 33, 300, 2, 2, 48, True, 17, 5.0),
    (2, 257, 257, 4, 2, 256, True, None, None),
    (1, 150, 70, 2, 2, 16, True, 20, None),
]
SERVE_ARGV = ["--tp", "4", "--batch", "4", "--prompt-len", "1024",
              "--gen", "32", "--requests", "8", "--comm", "static"]
# kernel vs plain prefill logits of one full-width bf16 wave, as a share of
# max|logit|: the two round their attention outputs to bf16 differently
# (summation order), and 36 layers carry that on, to 1.9e-2 to 2.1e-2 on an
# H100; the planted FAULTS move the same logits by 0.37 (causal mask off
# by one) and 1.4 (kv head h % KV), and the phase checks each still does
PREFILL_REL = 5e-2
SMOKE_REL = 1e-4    # tests/test_torch_serve.py's logits bound (f32)


def flash_work(case) -> tuple[int, int]:
    """(FLOPs, bytes) the function must spend on these inputs: 4·d per
    visible (query, key) pair (q·k and p·v) for every (n, head), and q, k,
    v read once and the output written once."""
    from repro_torch.kernels.flash_attention import ref
    N, S, T, H, KV, d, causal, window, _ = case
    pairs = int(ref.visible(S, T, causal, window, "cpu").sum())
    return 4 * d * pairs * N * H, 2 * (2 * N * S * H * d + 2 * N * T * KV * d)


def flash_inputs(case, dtype, gen, dev):
    N, S, T, H, KV, d = case[:6]
    return (torch.randn((N, S, H, d), generator=gen, device=dev).to(dtype),
            torch.randn((N, T, KV, d), generator=gen, device=dev).to(dtype),
            torch.randn((N, T, KV, d), generator=gen, device=dev).to(dtype))


def phase_flash_kernel(dev, flush, bw) -> dict:
    """The flash-attention kernel against its plain version on the grid and
    at the serving shape, then timed at the serving shape beside its plain
    version and scaled_dot_product_attention (the library yardstick)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {}
    for case in FLASH_GRID + [FLASH_SERVE]:
        kw = dict(zip(("causal", "window", "softcap"), case[6:]))
        for dt in (torch.float32, torch.bfloat16):
            if case is FLASH_SERVE and dt == torch.float32:
                continue
            q, k, v = flash_inputs(case, dt, gen, dev)
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            diff = (fa.flash_attention(q, k, v, **kw).float() - want).abs()
            err = diff.max().item()
            tol = FLASH_TOL[dt]
            check(bool((diff <= tol + tol * want.abs()).all()),
                  f"flash_attention {case} {dt}: max|kernel - plain| {err} "
                  f"over {tol} + {tol} |plain|")
            worst[dt] = max(worst.get(dt, 0.0), err)
    log(f"[flash] kernel vs plain on {len(FLASH_GRID)} grid shapes and the "
        f"serving shape: max|err| f32 {worst[torch.float32]:.3e} (tol 3e-5 "
        f"+ 3e-5 |plain|), bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2 + "
        f"2e-2 |plain|)")
    q, k, v = flash_inputs(FLASH_SERVE, torch.bfloat16, gen, dev)
    want = ref.flash_attention_ref(q, k, v).float()
    tol = FLASH_TOL[torch.bfloat16]
    for label, fault in FAULTS.items():
        diff = (fault(q, k, v).float() - want).abs()
        over = (diff > tol + tol * want.abs()).float().mean().item()
        check(over > 0, f"the per-element gate misses the planted fault "
              f"'{label}'")
        log(f"[flash] planted fault '{label}' at the serving shape: "
            f"max|fault - plain| {diff.max().item():.3e}, {100 * over:.2f} % "
            f"of elements over the per-element gate")
    del want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flops, nbytes = flash_work(FLASH_SERVE)
    ops_ms, bytes_ms = flops / BF16_FLOP_PER_S * 1e3, nbytes / bw * 1e3
    smi_sample("flash")
    k_ms = time_ms(lambda: fa.flash_attention(q, k, v), flush)
    p_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v), flush)
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    # the fp32-FMA path at the same shape (f32 inputs: no tensor cores)
    qf, kf, vf = (t.float() for t in (q, k, v))
    f32_ms = time_ms(lambda: fa.flash_attention(qf, kf, vf), flush)
    del qf, kf, vf
    smi_sample("flash")
    out = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               max_abs_err=max(worst.values()))
    log(f"[flash] serving shape {FLASH_SERVE[:6]} bf16 causal (wgmma + "
        f"TMA kernel): kernel "
        f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
        f"scaled_dot_product_attention {l_ms * 1e3:.2f} us, bound "
        f"{out['bound_ms'] * 1e3:.2f} us ({flops / 1e9:.2f} GFLOP at "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB at "
        f"{bw / 1e12:.2f} TB/s: {out['bound_by']}); kernel at "
        f"{100 * out['bound_ms'] / k_ms:.1f} % of its bound; the fp32-FMA "
        f"path on f32 inputs of the same shape {f32_ms * 1e3:.2f} us")
    return out


def load_example(name: str):
    """The example script ``examples/<name>.py`` as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kv_head_mod(q, k, v, **kw):
    """A planted fault: q head h reads kv head h % KV, not h // (H / KV)."""
    from repro_torch.kernels.flash_attention import ref
    rep = q.shape[2] // k.shape[2]
    return ref.flash_attention_ref(q, k.repeat(1, 1, rep, 1),
                                   v.repeat(1, 1, rep, 1), **kw)


def causal_off_by_one(q, k, v, **kw):
    """A planted fault: each query also sees the key after its own."""
    from repro_torch.kernels.flash_attention import ref
    return ref.flash_attention_ref(torch.cat([q[:, :1], q], 1), k, v,
                                   **kw)[:, 1:]


# faults planted in the plain version, to read how far each moves what the
# serving phase's gates compare (not the kernel: no broken copy of it)
FAULTS = {"kv head h % KV": kv_head_mod,
          "causal mask off by one": causal_off_by_one}


def plain_attention(fn, attn=None):
    """``fn()`` with prefill attention through ``attn`` (the kernel's plain
    version by default) on the same card: the same inputs, the same
    model."""
    from repro_torch.models import attention
    from repro_torch.kernels.flash_attention import ref
    import types
    kernel = attention.fa_ops
    attention.fa_ops = types.SimpleNamespace(
        flash_attention=attn or ref.flash_attention_ref)
    try:
        return fn()
    finally:
        attention.fa_ops = kernel


def phase_serve(dev) -> int:
    """qwen3-8b at full width serving 8 requests through the example's
    continuous-batching loop; then one wave's prefill through the kernel
    against the plain version, and the overlapped row-parallel combine at
    the MLP's shape against the whole matmul + all-reduce.  Returns the
    flash-attention launches of the serving run."""
    from repro_torch.core import collectives, streaming
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import input_specs as isp, setup
    from repro_torch.models import decode as dec
    from repro_torch.train import serve as serve_mod
    ex = load_example("serve_lm_torch")
    args = ex.parser().parse_args(SERVE_ARGV)
    cfg = ex.model_config(args)
    comm = ex.COMMS[args.comm]
    t0 = time.perf_counter()
    sess = setup.build_session(cfg, args.tp, comm, seed=args.seed,
                               device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(sess.params))
    log(f"[serve] {cfg.name} full width: {n_params / 1e9:.3f} B stacked "
        f"parameters (tp {args.tp}) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    fa.launches = 0
    out = ex.run(args, log=log, sess=sess)
    launches = fa.launches
    waves = len(out["prefill_ms"])
    check(launches == out["flash_launches"] == cfg.n_layers * waves,
          f"flash-attention launches {launches}, want {cfg.n_layers} x "
          f"{waves} waves")
    check(out["all_logits_finite"], "non-finite logits while serving")
    log(f"[serve] prefill ms per wave {out['prefill_ms']}; median decode "
        f"{out['decode_ms_per_token_median']:.2f} ms per step; "
        f"{out['tokens_per_s']:.2f} generated tokens/s over the run's "
        f"{out['wall_s']:.2f} s ({out['decode_tokens_per_s']:.2f} per s of "
        f"decode time); peak memory "
        f"{out['peak_mem_gb']:.2f} GB; flash-attention launches {launches} "
        f"= {cfg.n_layers} layers x {waves} waves")

    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len))
    capacity = args.prompt_len + args.gen
    _, pre = serve_mod.build_serve_fn(
        cfg, args.tp, comm,
        isp.ShapeSpec("wave", args.prompt_len, args.batch, "prefill"),
        cache_capacity=capacity, device=dev)
    rt, step = serve_mod.build_serve_fn(
        cfg, args.tp, comm,
        isp.ShapeSpec("wave", capacity, args.batch, "decode"), device=dev)
    st = pre(sess.params, {"tokens": toks})
    got = st.last_logits
    want = plain_attention(lambda: pre(sess.params, {"tokens": toks})
                           ).last_logits

    def rel(x):
        return ((x - want).abs().max() / want.abs().max()).item()
    gap = rel(got)
    check(bool(torch.isfinite(got).all()) and gap <= PREFILL_REL,
          f"prefill through the kernel vs the plain version: {gap} of "
          f"max|logit| (bound {PREFILL_REL})")
    log(f"[serve] one wave's prefill through the kernel vs the plain "
        f"version: max|dlogit| {gap:.3e} of max|logit| (bound {PREFILL_REL}),"
        f" rms {((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item():.3e} relative")
    for label, fault in FAULTS.items():
        bad = plain_attention(lambda: pre(sess.params, {"tokens": toks}),
                              fault).last_logits
        check(rel(bad) > PREFILL_REL, f"the prefill gate misses the planted "
              f"fault '{label}': {rel(bad)} of max|logit|")
        log(f"[serve] the same prefill with the planted fault '{label}': "
            f"max|dlogit| {rel(bad):.3e} of max|logit| vs the plain version")
    del got, want, bad

    # where a wave's time goes: one prefill, one decode step
    profile_device_time("serve prefill", lambda: pre(sess.params,
                                                     {"tokens": toks}))
    tok = dec.greedy_tokens(st, rt)
    st = step(sess.params, tok, st)
    profile_device_time("serve decode", lambda: step(sess.params, tok, st))
    del st

    # the streaming row-parallel combine of the MLP at this wave's shape
    gen = torch.Generator(device=dev).manual_seed(4)
    tokens = args.batch * args.prompt_len
    h = torch.randn((args.tp, tokens, cfg.d_ff // args.tp), generator=gen,
                    device=dev).to(cfg.dtype)
    w = sess.params["layers"]["mlp"]["w_down"][0]
    whole = collectives.all_reduce(streaming.matmul_f32(h, w), rt.tp_comm(),
                                   comm).to(cfg.dtype)
    chunked = streaming.overlapped_matmul_allreduce(h, w, rt.tp_comm(), comm)
    check(torch.equal(chunked, whole), f"overlapped combine differs by "
          f"{(chunked.float() - whole.float()).abs().max().item()}")
    log(f"[serve] overlapped matmul + all-reduce ({args.tp}, {tokens}, "
        f"{cfg.d_ff // args.tp}) x w_down vs the whole matmul + all-reduce: "
        f"bitwise equal")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_serve_smoke(dev, arch: str, S: int, GEN: int) -> None:
    """``arch``'s smoke config in f32, tp = 4, on the card and on the CPU
    from the same weights: greedy tokens over GEN decode steps after an
    S-token prompt equal; on the card, decode equals prefill of the
    extended sequence."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.config import CommConfig
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec, sharding, transformer
    from repro_torch.train import serve as serve_mod
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    tp, B = 4, 4
    full = transformer.init_model(0, cfg, tp, "cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
    runs = []
    for where in ("cpu", dev):
        params = sharding.shard_params(full, cfg, tp, where)
        rt, pre = serve_mod.build_serve_fn(
            cfg, tp, CommConfig(), isp.ShapeSpec("s", S, B, "prefill"),
            cache_capacity=S + GEN, device=where)
        _, step = serve_mod.build_serve_fn(
            cfg, tp, CommConfig(), isp.ShapeSpec("s", S + GEN, B, "decode"),
            device=where)
        st = pre(params, {"tokens": toks})
        out = []
        for _ in range(GEN):
            nxt = dec.greedy_tokens(st, rt)
            out.append(nxt.cpu())
            st = step(params, nxt, st)
        runs.append((torch.stack(out, 1), st, params, rt))
    (cpu_toks, cpu_st, _, _), (card_toks, st, params, rt) = runs
    check(torch.equal(cpu_toks, card_toks),
          f"smoke greedy tokens on the card {card_toks.tolist()} differ from "
          f"the CPU's {cpu_toks.tolist()}")
    seq = np.concatenate([toks, card_toks.numpy()], axis=1)
    _, pre = serve_mod.build_serve_fn(
        cfg, tp, CommConfig(), isp.ShapeSpec("s", S + GEN, B, "prefill"),
        device=dev)
    ext = pre(params, {"tokens": seq})
    check(torch.equal(dec.greedy_tokens(st, rt), dec.greedy_tokens(ext, rt)),
          "smoke decode's next token differs from the extended prefill's")
    rel = ((st.last_logits - ext.last_logits).abs().max()
           / ext.last_logits.abs().max()).item()
    rel_cpu = ((st.last_logits.cpu() - cpu_st.last_logits).abs().max()
               / cpu_st.last_logits.abs().max()).item()
    check(rel <= SMOKE_REL and rel_cpu <= SMOKE_REL,
          f"smoke logits: decode vs extended prefill {rel}, card vs CPU "
          f"{rel_cpu} (bound {SMOKE_REL})")
    log(f"[serve] {cfg.name} f32 tp {tp}: greedy tokens over {GEN} decode "
        f"steps after {S} prompt tokens equal on the card and the CPU; "
        f"decode vs prefill of the extended sequence {rel:.2e}, card vs CPU "
        f"{rel_cpu:.2e} of max|logit|")


# ----------------------------------------------------------------------
# The SSM serving path: the SSD scan kernel and mamba2-130m
# ----------------------------------------------------------------------

# tests/test_kernels.py::test_ssd_scan_sweep's bound, its atol = rtol form
SSD_TOL = 1e-4
# (R, B, S, H, P, N, chunk): the three shapes of test_ssd_scan_sweep, then
# mamba2-130m's serving shape (tp 4 x batch 8 x 6 heads per rank, 2048
# tokens in 16 chunks of 128)
SSD_GRID = [(1, 1, 32, 2, 8, 8, 16), (1, 2, 64, 3, 16, 8, 16),
            (1, 1, 128, 4, 32, 16, 32)]
SSD_SERVE = (4, 8, 2048, 6, 64, 128, 128)
# At the serving shape the cumulative decay reaches ~-1.4e3, where f32's
# spacing is ~1e-4: two right summation orders differ at that level, so
# the kernel is held against the plain version run in float64, to at most
# SSD_F64_SLACK times the f32 plain version's own error plus
# SSD_F64_FLOOR * max|y|.
SSD_F64_SLACK, SSD_F64_FLOOR = 2.0, 1e-6
SSM_ARGV = ["--arch", "mamba2-130m", "--tp", "4", "--batch", "8",
            "--prompt-len", "2048", "--gen", "64", "--requests", "16",
            "--comm", "static"]
# kernel vs plain logits of one full-width bf16 wave, as a share of
# max|logit|, over every position, through the served model's first
# SSM_GATE_LAYERS layers.  The random-weight model is chaotic with depth: a
# relative 1e-7 noise on y moves every-position logits by 1.189e-3 of
# max|logit| through one bf16 layer and 7.685e-2 through two, and a 1e-6
# noise the last position of all 24 by 0.7862, so only a shallow cut tells
# rounding from a fault.  The two planted faults move the one-layer logits
# by 0.5014 and 1.719 (examples/ssm_fault_probe_torch.py on the CPU, 2 x
# 512 tokens), and the phase checks that each still exceeds the bound.
SSM_GATE_LAYERS = 1
SSM_LOGITS_REL = 5e-2


def ssd_work(case, itemsize: int) -> tuple[int, int]:
    """(FLOPs, bytes) the scan must spend on these inputs: per chunk, C·Bᵀ
    over the i >= j triangle once per (rank, batch, group), and per head
    W·(dt·x) over the triangle, C·h_prev and the state update Bᵀ·x; x, B,
    C (itemsize), dt and A (f32) read once, y and h_final (f32) written
    once."""
    R, B, S, H, P, N, L = case
    G, nc, tri = 1, S // L, L * (L + 1) // 2
    flops = (R * B * G * nc * 2 * tri * N
             + R * B * H * nc * (2 * tri * P + 4 * L * N * P))
    nbytes = (itemsize * (R * B * S * H * P + 2 * R * B * S * G * N)
              + 4 * (R * B * S * H + R * H + R * B * S * H * P
                     + R * B * H * N * P))
    return flops, nbytes


def ssd_inputs(case, dtype, gen, dev, serving=False):
    """Seeded scan inputs.  The unit shapes take test_ssd_scan_sweep's
    (dt in [0.01, ~0.4], A in -[0.5, ~3]); the serving shape the model's
    (dt = softplus of a unit normal, A = -linspace(1, 16, 24) cut into
    each rank's 6 heads), where the decay is steepest."""
    R, B, S, H, P, N, _ = case
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if serving:
        dt = torch.nn.functional.softplus(rnd(R, B, S, H))
        a = -torch.linspace(1.0, 16.0, R * H, device=dev).view(R, H)
    else:
        dt = rnd(R, B, S, H).abs() * 0.1 + 0.01
        a = -(rnd(R, H).abs() + 0.5)
    return (rnd(R, B, S, H, P).to(dtype), dt, a,
            rnd(R, B, S, 1, N).to(dtype), rnd(R, B, S, 1, N).to(dtype))


def phase_ssd_kernel(dev, flush, bw) -> dict:
    """The SSD scan kernel against its plain version at the unit shapes
    (f32, per element) and at the serving shape (bf16 and f32, against the
    plain version in float64), then timed at the serving shape in bf16
    beside its plain version and its bound (no PyTorch call computes the
    scan: no library time)."""
    from repro_torch.kernels.ssd_scan import ops as ssd, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for case in SSD_GRID:
        inp = ssd_inputs(case, torch.float32, gen, dev)
        got = ssd.ssd_chunked(*inp, case[-1])
        want = ref.ssd_chunked_ref(*inp, case[-1])
        for g, w, what in zip(got, want, ("y", "h_final")):
            diff = (g - w).abs()
            err = diff.max().item()
            check(bool((diff <= SSD_TOL + SSD_TOL * w.abs()).all()),
                  f"ssd_scan {case} {what}: max|kernel - plain| {err} over "
                  f"{SSD_TOL} + {SSD_TOL} |plain|")
            worst = max(worst, err)
    log(f"[ssd] kernel vs plain on {len(SSD_GRID)} unit shapes (f32): "
        f"max|err| {worst:.3e} (tol {SSD_TOL} + {SSD_TOL} |plain|)")
    L = SSD_SERVE[-1]
    for dt in (torch.bfloat16, torch.float32):
        inp = ssd_inputs(SSD_SERVE, dt, gen, dev, serving=True)
        got = ssd.ssd_chunked(*inp, L)
        plain = ref.ssd_chunked_ref(*inp, L)
        exact = ref.ssd_chunked_ref(*(t.double() for t in inp), L)
        for g, p, e, what in zip(got, plain, exact, ("y", "h_final")):
            err_k = (g.double() - e).abs().max().item()
            err_p = (p.double() - e).abs().max().item()
            bound = (SSD_F64_SLACK * err_p
                     + SSD_F64_FLOOR * e.abs().max().item())
            gap = (g - p).abs().max().item()
            check(err_k <= bound, f"ssd_scan serving shape {dt} {what}: "
                  f"kernel off float64 by {err_k}, over {bound} (f32 plain "
                  f"off by {err_p})")
            log(f"[ssd] serving shape {dt} {what}: max|kernel - f64| "
                f"{err_k:.3e}, max|plain f32 - f64| {err_p:.3e} (bound "
                f"{bound:.3e}); max|kernel - plain| {gap:.3e}")
            worst = max(worst, gap)
        del got, plain, exact
    inp = ssd_inputs(SSD_SERVE, torch.bfloat16, gen, dev, serving=True)
    flops, nbytes = ssd_work(SSD_SERVE, 2)
    ops_ms, bytes_ms = flops / BF16_FLOP_PER_S * 1e3, nbytes / bw * 1e3
    smi_sample("ssd")
    k_ms = time_ms(lambda: ssd.ssd_chunked(*inp, L), flush)
    p_ms = time_ms(lambda: ref.ssd_chunked_ref(*inp, L), flush)
    smi_sample("ssd")
    # the call's three kernels (chunk states, hand-off, outputs)
    profile_device_time("ssd", lambda: ssd.ssd_chunked(*inp, L))
    # The kernel skips products whose decays all underflow expf, which the
    # serving shape's steep decay makes common.  At the unit shapes' shallow
    # decay (dt in [0.01, ~0.4], A in -[0.5, ~3]) no decay in a chunk comes
    # near that, nothing is skipped, and the time is the kernel's worst
    # case; the float64 gate holds there too.
    shallow = ssd_inputs(SSD_SERVE, torch.bfloat16, gen, dev)
    got = ssd.ssd_chunked(*shallow, L)
    plain = ref.ssd_chunked_ref(*shallow, L)
    exact = ref.ssd_chunked_ref(*(t.double() for t in shallow), L)
    for g, p, e, what in zip(got, plain, exact, ("y", "h_final")):
        err_k = (g.double() - e).abs().max().item()
        err_p = (p.double() - e).abs().max().item()
        bound = SSD_F64_SLACK * err_p + SSD_F64_FLOOR * e.abs().max().item()
        check(err_k <= bound, f"ssd_scan serving shape, shallow decay, "
              f"{what}: kernel off float64 by {err_k}, over {bound} (f32 "
              f"plain off by {err_p})")
        log(f"[ssd] serving shape, shallow decay, bf16 {what}: max|kernel - "
            f"f64| {err_k:.3e}, max|plain f32 - f64| {err_p:.3e} (bound "
            f"{bound:.3e})")
    del got, plain, exact
    shallow_ms = time_ms(lambda: ssd.ssd_chunked(*shallow, L), flush)
    smi_sample("ssd")
    out = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               max_abs_err=worst)
    log(f"[ssd] serving shape {SSD_SERVE} bf16: kernel {k_ms * 1e3:.2f} us, "
        f"plain {p_ms * 1e3:.2f} us, bound {out['bound_ms'] * 1e3:.2f} us "
        f"({flops / 1e9:.2f} GFLOP at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, "
        f"{nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s: {out['bound_by']});"
        f" kernel at {100 * out['bound_ms'] / k_ms:.1f} % of its bound; "
        f"library call: none; at the shallow decay (no product skipped) "
        f"kernel {shallow_ms * 1e3:.2f} us")
    return out


def phase_serve_ssm(dev) -> int:
    """mamba2-130m at full width serving 16 requests through the example's
    continuous-batching loop; then one wave's logits at every position
    through the served model's first layer(s), through the kernel against
    the plain version and against two faults planted in the plain version;
    the full-depth prefill's last-position gap is printed.  Returns the
    SSD launches of the serving run."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import input_specs as isp, setup
    from repro_torch.models import decode as dec, transformer
    from repro_torch.train import serve as serve_mod
    ex = load_example("serve_lm_torch")
    probe = load_example("ssm_fault_probe_torch")
    args = ex.parser().parse_args(SSM_ARGV)
    cfg = ex.model_config(args)
    comm = ex.COMMS[args.comm]
    t0 = time.perf_counter()
    sess = setup.build_session(cfg, args.tp, comm, seed=args.seed,
                               device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(sess.params))
    log(f"[ssm] {cfg.name} full width: {n_params / 1e6:.1f} M stacked "
        f"parameters (tp {args.tp}) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    ssd.launches = 0
    out = ex.run(args, log=log, sess=sess)
    launches = ssd.launches
    waves = len(out["prefill_ms"])
    check(launches == out["ssd_launches"] == cfg.n_layers * waves,
          f"SSD scan launches {launches}, want {cfg.n_layers} x {waves} "
          f"waves")
    check(out["all_logits_finite"], "non-finite logits while serving")
    log(f"[ssm] prefill ms per wave {out['prefill_ms']}; median decode "
        f"{out['decode_ms_per_token_median']:.2f} ms per step; "
        f"{out['tokens_per_s']:.2f} generated tokens/s over the run's "
        f"{out['wall_s']:.2f} s ({out['decode_tokens_per_s']:.2f} per s of "
        f"decode time); peak memory {out['peak_mem_gb']:.2f} GB; SSD scan "
        f"launches {launches} = {cfg.n_layers} layers x {waves} waves")

    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len))
    shape = isp.ShapeSpec("wave", args.prompt_len, args.batch, "prefill")
    _, pre = serve_mod.build_serve_fn(
        cfg, args.tp, comm, shape,
        cache_capacity=args.prompt_len + args.gen, device=dev)
    rt, step = serve_mod.build_serve_fn(
        cfg, args.tp, comm, isp.ShapeSpec("wave", args.prompt_len
                                          + args.gen, args.batch, "decode"),
        device=dev)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}

    def rel(x, want):
        return ((x - want).abs().max() / want.abs().max()).item()
    # the served model's first layers: the same full-width weights
    cut = dataclasses.replace(cfg, n_layers=SSM_GATE_LAYERS)
    cut_params = dict(sess.params, layers={
        k: v[:SSM_GATE_LAYERS] if torch.is_tensor(v) else
        {kk: vv[:SSM_GATE_LAYERS] for kk, vv in v.items()}
        for k, v in sess.params["layers"].items()})
    cut_rt = serve_mod.serve_runtime(cut, args.tp, comm, shape)
    every = lambda: transformer.forward(cut_params, batch, cut_rt).logits
    got, want = every(), probe.through(every)
    gap = rel(got, want)
    check(bool(torch.isfinite(got).all()) and gap <= SSM_LOGITS_REL,
          f"every position through the kernel vs the plain version: {gap} "
          f"of max|logit| (bound {SSM_LOGITS_REL})")
    del got
    bad = {label: rel(probe.through(every, fault), want)
           for label, fault in probe.FAULTS.items()}
    del want
    last = lambda: pre(sess.params, batch).last_logits
    got, want = last(), probe.through(last)
    check(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    log(f"[ssm] one wave through the kernel vs the plain version: "
        f"max|dlogit| {gap:.3e} of max|logit| over every position through "
        f"the first {SSM_GATE_LAYERS} layer(s) (bound {SSM_LOGITS_REL}); "
        f"{rel(got, want):.3e} at the prefill's last position through all "
        f"{cfg.n_layers} layers (not gated: the random-weight model "
        f"amplifies rounding with depth)")
    del got, want
    for label, moved in bad.items():
        check(moved > SSM_LOGITS_REL, f"the logits gate misses the planted "
              f"fault '{label}': {moved} of max|logit|")
        log(f"[ssm] the same cut with the planted fault '{label}': "
            f"max|dlogit| {moved:.3e} of max|logit|")

    # where a wave's time goes: one prefill, one decode step
    profile_device_time("ssm prefill", lambda: pre(sess.params, batch))
    st = pre(sess.params, batch)
    tok = dec.greedy_tokens(st, rt)
    st = step(sess.params, tok, st)
    profile_device_time("ssm decode", lambda: step(sess.params, tok, st))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG,
                                         CommConfig, Scheduling)
    from repro_torch.core.topology import TorusSpec
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.swe_step import ops as swe_ops, ref as swe_ref
    from repro_torch.swe import driver
    from repro_torch.swe.dg_solver import FLOP_PER_ELEMENT, SWEConfig

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. the card and the build ------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_all({"swe_step": swe_ops.LIBRARY, "quant": quant_ops.LIBRARY,
               "flash_attention": flash_ops.LIBRARY,
               "ssd_scan": ssd_ops.LIBRARY})
    log(f"[build] the four libraries built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    bw = card_bandwidth(name)
    swe_ptxas = ptxas_summary(swe_ops.LIBRARY.log)
    log(f"[build] swe_step registers and spills: {swe_ptxas}")
    sass = sass_counts(flash_ops.LIBRARY, ("HGMMA", "UTMALDG", "HMMA"))
    log(f"[build] cuobjdump -sass of the flash library: {sass}")
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          "the flash library holds no wgmma (HGMMA) or TMA (UTMALDG) "
          "instruction")

    # -- 2. kernel against its plain version ----------------------------
    max_err = 0.0
    for E in (100, 512, 1300):
        args, rows = random_inputs(1, E, 3 * E, E, dev)
        got, want = (swe_ops.swe_step(*args, dt=1e-4),
                     swe_ref.swe_step_ref(*args, dt=1e-4))
        base = torch.rand_like(got)
        got_b = swe_ops.swe_step(*args, dt=1e-4, rows=rows, out=base.clone())
        want_b = swe_ref.swe_step_ref(*args, dt=1e-4, rows=rows,
                                      out=base.clone())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_b = (got_b - want_b).abs().max().item()
        log(f"[kernel] swe_step E={E}: max|kernel-plain| {err:.3e}, with "
            f"row list {err_b:.3e} (atol {ATOL_KERNEL})")
        check(err <= ATOL_KERNEL and err_b <= ATOL_KERNEL,
              f"swe_step disagrees with its plain version at E={E}")
        max_err = max(max_err, err, err_b)

    t0 = time.perf_counter()
    sim = driver.build_simulation(FULL_ELEMENTS, FULL_RANKS, CommConfig(),
                                  device=dev)
    # SWEConfig's default dt (1e-4) suits meshes of a few thousand elements;
    # at full size it is ~26x over the explicit scheme's CFL limit and the
    # state blows up.  Take the Courant-limited step of this mesh instead.
    sim.swe = SWEConfig(dt=stable_dt(sim))
    pm = sim.pm
    log(f"[setup] bight mesh {sim.mesh.n_elements} elements on {pm.n_parts} "
        f"ranks: E_max {pm.e_max}, H_max {pm.h_max}, S_max {pm.s_max}, "
        f"rounds {pm.n_rounds}, N_max {pm.n_max}, B_max "
        f"{pm.boundary_idx.shape[1]}, dt {sim.swe.dt:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    sa = driver._static_args(sim)
    gen = torch.Generator(device=dev).manual_seed(0)
    halo = 1.0 + 0.1 * torch.rand((pm.n_parts, pm.h_max, 3), generator=gen,
                                  device=dev)
    full_args = [sim.state, halo, sa["normals"], sa["neigh_idx"],
                 sa["edge_type"], sa["area"], sa["valid"],
                 torch.ones((), dtype=torch.float32, device=dev)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for label, rows in (("full pass", None),
                        ("boundary rows", sa["boundary_idx"])):
        if rows is None:
            kern = lambda: swe_ops.swe_step(*full_args, dt=1e-4)
            plain = lambda: swe_ref.swe_step_ref(*full_args, dt=1e-4)
        else:
            base = swe_ops.swe_step(*full_args, dt=1e-4)
            out_k, out_p = base.clone(), base.clone()
            kern = lambda: swe_ops.swe_step(*full_args, dt=1e-4, rows=rows,
                                            out=out_k)
            plain = lambda: swe_ref.swe_step_ref(*full_args, dt=1e-4,
                                                 rows=rows, out=out_p)
        err = (kern() - plain()).abs().max().item()
        check(err <= ATOL_KERNEL,
              f"swe_step disagrees with its plain version at full size "
              f"({label}): {err}")
        max_err = max(max_err, err)
        nbytes = kernel_bytes(full_args, rows)
        n_rows = pm.n_parts * (pm.e_max if rows is None else rows.shape[1])
        bound_bytes_ms = nbytes / bw * 1e3
        bound_ops_ms = n_rows * FLOP_PER_ELEMENT / F32_FLOP_PER_S * 1e3
        k_ms, p_ms = time_ms(kern, flush), time_ms(plain, flush)
        timings[label] = dict(ms=k_ms, plain_ms=p_ms,
                              bound_ms=max(bound_bytes_ms, bound_ops_ms),
                              bound_by=("bytes" if bound_bytes_ms
                                        >= bound_ops_ms else "operations"),
                              nbytes=nbytes)
        log(f"[kernel] swe_step {label} at ({pm.n_parts}, {pm.e_max}): "
            f"max|kernel-plain| {err:.3e}; kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, bound {timings[label]['bound_ms'] * 1e3:.2f}"
            f" us ({nbytes / 1e6:.2f} MB at {bw / 1e12:.2f} TB/s, "
            f"{timings[label]['bound_by']}); library call: none")

    quant_timings = phase_quant_kernels(dev, flush, bw)
    flash_timing = phase_flash_kernel(dev, flush, bw)
    ssd_timing = phase_ssd_kernel(dev, flush, bw)

    # -- 3. main path at full size -------------------------------------
    modes = (("fused", CommConfig(), 1 + N_INNER),
             ("overlapped", OVERLAPPED_CONFIG, 2 + 2 * N_INNER),
             ("host", BASELINE_CONFIG, STEPS))
    m0 = mass(sim, sim.state)
    finals, launches_by_mode, step_us = {}, {}, {}
    swe_ops.launches = 0
    for label, cfg, want_launches in modes:
        msim = dataclasses.replace(sim, comm_cfg=cfg)
        before = swe_ops.launches
        if cfg.scheduling == Scheduling.HOST:
            state, us = run_host(driver, msim)
        else:
            state, us = run_fused(driver, msim)
        launches_by_mode[label] = swe_ops.launches - before
        finals[label], step_us[label] = state, us
        drift = (mass(sim, state) - m0) / m0
        log(f"[main] {label}: {us:.1f} us/step over {STEPS} steps; mass drift "
            f"{drift:.3e}; kernel launches {launches_by_mode[label]}")
        check(launches_by_mode[label] == want_launches,
              f"{label}: {launches_by_mode[label]} kernel launches, want "
              f"{want_launches}")
        check(bool(torch.isfinite(state).all()), f"{label}: non-finite state")
        check(abs(drift) < MASS_DRIFT, f"{label}: mass drift {drift}")
    main_launches = swe_ops.launches
    # a graph captures N_INNER steps after one eager warm-up step; the host
    # runner launches every step
    per_step = {label: launches_by_mode[label] / (
        STEPS if label == "host" else N_INNER + 1) for label in step_us}
    log(f"[main] swe_step launches per step: {per_step}")
    for label in ("overlapped", "host"):
        check(torch.equal(finals[label], finals["fused"]),
              f"{label} final state differs from fused")
    log(f"[main] fused, overlapped and host final states bitwise equal; "
        f"swe_step launched {main_launches} times (a captured launch counts "
        f"once; each fused/overlapped graph replays it {N_INNER} or "
        f"{2 * N_INNER} times per segment)")
    plain_state, plain_us = run_fused(driver, sim,
                                      update=swe_ref.swe_step_ref)
    diff = (plain_state - finals["fused"]).abs().max().item()
    log(f"[main] fused with the plain version: {plain_us:.1f} us/step, "
        f"max|plain-kernel| after {STEPS} steps {diff:.3e} "
        f"(atol {ATOL_PLAIN_RUN})")
    check(diff <= ATOL_PLAIN_RUN, "plain-version run disagrees with kernel")

    for label, cfg in (("fused", CommConfig()),
                       ("overlapped", OVERLAPPED_CONFIG)):
        profile_segment(driver, dataclasses.replace(sim, comm_cfg=cfg),
                        step_us[label], label)

    # -- 4. routing ----------------------------------------------------
    small = driver.build_simulation(1696, 8, CommConfig(), device=dev)
    for label, flat_sim, spec, flat_state in (
            ("1696 elements, 2x4 torus", small, "2x4", None),
            (f"{sim.mesh.n_elements} elements, 6x8 torus", sim, "6x8",
             finals["fused"])):
        if flat_state is None:
            flat_state, _ = run_fused(driver, flat_sim)
        torus_sim = dataclasses.replace(flat_sim,
                                        topology=TorusSpec.parse(spec))
        torus_state, us = run_fused(driver, torus_sim)
        check(torch.equal(torus_state, flat_state),
              f"{label}: torus state differs from flat")
        log(f"[routing] {label}: bitwise equal to flat ({us:.1f} us/step)")

    # -- 5. the int8 wire: gradient sync, sweep, autotuned SWE ----------
    quant_launches = phase_grad_sync(dev)
    db_path = Path(__file__).resolve().parent / ".repro_tune" / \
        "chip_smoke_tunedb.json"
    phase_sweep(dev, db_path)
    phase_auto(driver, sim, db_path, dev)

    # -- 6. the reliable wire and the elastic runtime ---------------------
    phase_reliable_wire(driver, sim, finals["fused"])
    reliable_quant = phase_reliable_checks(dev)
    elastic_launches = phase_elastic(driver, sim, db_path, dev)
    phase_lossy_sweep(dev)

    # -- 7. the LM serving path ------------------------------------------
    flash_launches = phase_serve(dev)
    phase_serve_smoke(dev, "qwen3-8b", 24, 4)

    # -- 8. the SSM serving path -----------------------------------------
    ssd_launches = phase_serve_ssm(dev)
    phase_serve_smoke(dev, "mamba2-130m", 16, 16)

    # -- 9. summary ----------------------------------------------------
    log(f"kernels: swe_step launches={main_launches} "
        + " ".join(f"{k}={v}" for k, v in launches_by_mode.items())
        + f"; swe_step launches={elastic_launches} (elastic runs)"
        + " ".join(f"; {k} launches={v} (gradient sync), "
                   f"{reliable_quant[k]} (reliable int8 sendrecv)"
                   for k, v in quant_launches.items())
        + f"; flash_attention launches={flash_launches} (serving)"
        + f"; ssd_scan launches={ssd_launches} (serving)")
    full, boundary = timings["full pass"], timings["boundary rows"]
    rows = [{
        "name": "swe_step", "route": "cuda",
        "source": "src/repro_torch/kernels/swe_step/csrc/swe_step.cu",
        "replaces": "src/repro/kernels/swe_step/swe_step.py:83",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None,
        "boundary_pass": {k: boundary[k] for k in ("ms", "plain_ms",
                                                   "bound_ms", "bound_by")},
        "launches_per_step": per_step, "elastic_launches": elastic_launches,
        "ptxas": swe_ptxas}]
    for kname, line in (("quantize", 34), ("dequantize", 60)):
        t = quant_timings[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/quant/csrc/quant.cu",
            "replaces": f"src/repro/kernels/quant/quant.py:{line}",
            "launches": quant_launches[kname],
            "reliable_int8_launches": reliable_quant[kname],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78",
        "launches": flash_launches, **flash_timing})
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:74",
        "launches": ssd_launches, **ssd_timing})
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
