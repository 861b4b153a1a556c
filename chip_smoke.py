#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises and the script
exits non-zero:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, the build of every kernel from this checkout's sources (each
   kernel's ``-Xptxas -v`` registers and spills), and ``cuobjdump -sass``
   of the flash forward and backward libraries, which must hold HGMMA
   (wgmma) and UTMALDG (TMA) instructions; the backward's wgmma kernels
   must spill nothing and draw no ptxas note of serialised wgmmas; the
   SSD backward's eight kernels must spill nothing, its library must hold
   HGMMA and LDSM (ldmatrix), no atomic, and draw no such note;
2. every kernel held against its plain PyTorch version on the card, at the
   test shapes and at the main paths' full-size shapes (``swe_step`` with
   and without the boundary row list; ``quantize``/``dequantize`` at blocks
   256 and 1024, f32 and bf16), and timed with CUDA events beside its
   bound;
3. the main path at full size — the bight mesh at 312,000 target elements
   (270,886 elements) on 48 stacked ranks — under the fused, overlapped and
   host-scheduled configurations for 200 steps (20-step segments): final
   states bitwise equal, mass drift, finiteness, and the kernel launch
   counts (each graph replay counts its steps' launches: 1 a step fused
   and host, 2 overlapped, after one eager warm-up step per capture); then one fused run with the plain version, against the kernel run,
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
7. the LM serving path: the flash-attention kernel (bf16: the wgmma + TMA
   kernels at d 64/128 and at d 256) against its plain version at the
   serving shape (bf16, N = 16, S = T = 1024, 8 q heads over 2 kv heads, d
   = 128, causal) and on a grid of small shapes (window, softcap, ragged
   and cross lengths, f32), the d <= 128 forward's bits against
   ``tests/test_torch_cuda.py``'s digests, timed beside its plain version,
   ``scaled_dot_product_attention`` and its bound, with the card's SM clock
   sampled beside the timing; then qwen3-8b at full
   width (36 layers, d_model 4096, vocab 151,936, bf16, tp = 4 stacked,
   random weights from seed 0) serving 8 requests in waves of 4 with
   1024-token prompts through ``examples/serve_lm_torch.py``, captured as
   CUDA graphs (the main path) and eager in turn (captured, eager,
   captured, eager: the same greedy tokens, each run's decode ms/step,
   tokens/s and peak memory); one wave captured against eager (the
   prefill's replay and 8 decode replays bitwise equal to the eager steps,
   each graph's kernel, copy and set nodes equal to the eager call's
   launch calls, each mode's device busy share); one wave's prefill through the kernel against the same prefill
   through the plain version; serving under ``comm="auto"`` (a 4-rank e2e
   sweep of all_reduce's three consumer loops at both phases' message
   sizes, one config per phase, each auto-built phase bitwise equal to
   its resolved config); the overlapped row-parallel combine against the
   whole matmul + all-reduce, and the smoke config in f32 on the card
   (captured) against the CPU, decode against the prefill of the extended
   sequence within 1e-4;
8. the SSM serving path: the SSD chunked-scan kernel against its plain
   version at test_ssd_scan_sweep's shapes (f32) and at the serving shape
   (tp 4 x batch 8 x 6 heads, 2048 tokens, head dim 64, state 128, chunk
   128; bf16 and f32, against the plain version in float64), timed beside
   its plain version and its bound, its three passes profiled by kernel
   (before phase 3, beside the other kernels); then mamba2-130m at full
   width (24 layers, d_model 768,
   vocab 50,280, bf16, tp = 4 stacked, random weights from seed 0) serving
   16 requests in waves of 8 with 2048-token prompts through
   ``examples/serve_lm_torch.py``, captured and eager in turn, one wave
   captured against eager, as qwen3's; one wave's logits through the
   kernel against the plain version and against two faults planted in the
   plain version, and the smoke config in f32 on the card against the
   CPU;
9. training: the flash backward kernel (deterministic; bf16 on wgmma fed
   by TMA, at d 256 its own dQ and dK/dV kernels; f32 on fp32 FMA) against
   the plain
   backward (autograd through the plain version) on a grid (window,
   softcap, ragged and cross lengths, GQA rep 1 to 4, f32, d 256) and at
   the training shape (bf16, N = 32, S = T = 1024, 8 q heads over 2 kv
   heads, d 128, causal), two runs bitwise equal, timed beside the
   fp32-FMA route on the same inputs, the plain backward, the backward of
   ``scaled_dot_product_attention`` and its bound, its three kernels
   profiled (before phase 3, beside the other kernels); then qwen3-8b at
   full width and 4 layers (bf16,
   random weights from seed 0, ``(data=2, model=4)`` stacked, ZeRO-1,
   8 x 1024 tokens a step) trained 6 steps through
   ``examples/train_lm_torch.py`` (the loss falls; ms/step, tokens/s and
   peak memory; the flash forward and backward launches per step exact,
   every backward on the wgmma route; the backward's share of one
   profiled step),
   again with the int8 gradient wire (the quant kernels' launches per step
   exact); the first step's loss and gradients through the kernels against
   the plain attention; ``preempt@4`` drained and resumed by a fresh
   process, bitwise equal to the uninterrupted run; ``rank_lost@3=r7``
   re-formed onto ``(data=1, model=4)`` by ``elastic_restore``, re-selected
   from phase 5's TuneDB with no sweep, twice, bitwise equal; and the
   smoke config (f32) trained on the card against the CPU; then the SSD
   scan's backward kernel (deterministic, five kernels a call; bf16 on
   term planes, ldmatrix and wgmma, f32 on its first kernels) against the
   plain backward (autograd through the plain version) at the unit shapes
   (f32 and bf16) and at the training shape (tp 4 x dp 2 x batch 4 = 8 x 4
   sequences, 6 heads, 2048 tokens, head dim 64, state 128, chunk 128;
   bf16 and f32, the model's steep decay and a shallow one, outputs and
   gradients against the plain version in float64), two runs bitwise
   equal, timed beside the
   plain backward and its bound, its kernels profiled (before phase 3,
   beside the other kernels); then mamba2-130m at full width and depth
   (24 layers, bf16, random weights from seed 0, ``(data=2, model=4)``,
   ZeRO-1, 8 x 2048 tokens a step) trained 8 steps through
   ``examples/train_lm_torch.py`` (the loss falls; ms/step, tokens/s and
   peak memory; SSD forward and backward launches per step exact; the
   backward's share of one profiled step); the first step's loss and
   gradients through the SSD kernels against the plain version through the
   first layer (the full-depth gap printed); ``preempt@4`` drained and
   resumed by a fresh process, bitwise equal; and mamba2's smoke config
   (f32) trained on the card against the CPU;
10. the plan store and the pod axis: the sweep CLI (``--fast --ranks 8``,
   sendrecv, all_reduce and hierarchical_all_reduce at 16 KiB and 1 MiB)
   with ``--plan-dir --warm-check`` as a subprocess (rc 0: warm program
   hits and warm <= 0.7 x cold in-process; a fresh process replays every
   plan from disk), its cold, warm and fresh-process seconds; the SWE
   example at its default size twice on one ``--plan-dir`` (equal
   final-state digests, disk hits the second time); the hierarchical
   all-reduce at 1 MiB a rank on ``(inner 4, outer 2)`` against the plain
   sum and the flat ring all-reduce (captured, CUDA events); the SSD
   forward and backward kernels at those meshes' shape (8, 2, 2048, 12, 64,
   128, 128), bf16 under both decays, against the plain version in float64;
   and mamba2-130m at full width and depth, 4 steps on ``(pod 2, data 2,
   model 2)`` against ``(data 4, model 2)`` (bf16, ZeRO-1, 8 x 2048 tokens: step
   1's loss within 1e-6 and gradient norm within 1e-4, later losses within
   1e-2; SSD launches exact; ms/step of both);
11. FSDP, Megatron-SP and remat "dots": where phase 9's qwen3-8b step
   holds its peak, replicated and under FSDP + SP + "dots" (the
   allocator's trace at the peak, by category); qwen3-8b as phase 9
   trains it, 4 steps each under FSDP, FSDP + SP and FSDP + SP + "dots"
   (FSDP's step-1 loss bitwise the replicated run's and its gradient norm
   within 1e-4; SP's step-1 loss within 5e-5 and norm within 1e-4; later
   losses within 1e-2; flash launches exact, every backward on the wgmma
   route; ms/step and peak beside phase 9's); the first step under FSDP +
   SP + "dots" through the kernels against the plain attention; the
   step-1 loss on three batches, replicated, through SP's bf16 combine
   (within 5e-5) and with the combine rounded to 2 mantissa bits (a
   control, beyond 5e-5); ``preempt@2`` under FSDP + SP resumed by a
   fresh process, bitwise; mamba2-130m 4 steps under FSDP (step 1's loss
   within 1e-6, norm within 1e-4; SSD launches exact) and its first step
   through the kernels against the plain scan through the first layer;
12. the rest of the dense family: gemma3-1b at full width and depth (26
   layers: 4 super-blocks of 5 windowed local layers and a global one,
   then 2 trailing local layers; window 512, head dim 256, bf16, tp 4,
   random weights from seed 0) serving 8 requests in waves of 4 x 1024
   tokens through ``examples/serve_lm_torch.py``, captured (flash launches
   exact: one a layer a wave), its prefill logits through the kernel
   against the plain version; gemma3-1b trained 4 steps at ``(data=2,
   model=4)``, ZeRO-1, remat (one unit a super-block) through
   ``examples/train_lm_torch.py`` (flash launches a step exact: 26 + 24
   recomputed forward, 26 backward on the wgmma route; ms/step, peak),
   its first step through the kernels against the plain attention;
   command-r-plus-104b and deepseek-coder-33b (56 heads padded to 64) at
   full width and 4 layers serving one wave of 4 x 1024 tokens, captured,
   the same gates; the three smoke configs (f32) on the card against the
   CPU.  The flash forward and backward are also held against their plain
   versions at gemma3's shapes (bf16, d 256, window 512) in phase 2 and
   timed there at its local (window 512) and global (no window) shapes
   beside SDPA (the window as a boolean mask; ``is_causal`` without one),
   the backward also beside the fp32-FMA route on the same inputs;
13. the moe family: mixtral-8x22b at full width (d_model 6144, 48/8 heads
   of 128, 8 experts top-2 of d_ff 16384, vocab 32,768; bf16, tp 4: 2
   whole experts and 12/2 heads a rank, random weights from seed 0),
   depth cut to 4 layers, serving one wave of 2 x 6144 tokens (past the
   4096-token window) through ``examples/serve_lm_torch.py``, captured
   (flash launches exact: one a layer), its prefill logits through the
   kernel against the plain version; one wave captured against eager (16
   decode steps, tokens and logits bitwise equal) and the (token, expert)
   assignments its prefill's capacity cut dropped; ``moe_block_a2a`` at
   mixtral's width (8 stacked data ranks x 1024 tokens, one layer's expert
   weights) under fused/buffered and overlapped/streaming (ordered and
   unordered, window 2, 512 B chunks), bitwise equal, each timed; the
   smoke config (f32) on the card against the CPU at its own capacity and
   with room for every token, and with a shared expert and a dense head
   layer.  The flash forward is held against its plain version at
   mixtral's prefill shape (8, 6144, 6144, 12/2 heads, d 128, window 4096)
   in phase 2, element by element and each row against its own rms (a
   gate that the window one tile longer or shorter, or no window, must
   break), and timed there beside SDPA (the window as a boolean mask),
   its plain version and its bound;
14. Multi-head Latent Attention: deepseek-v3-671b at full width (d_model
   7168, 128 MLA heads: q_lora 1536, kv_lora 512, q/k head dim 128 + 64, v
   128; 256 experts top-8 of d_ff 2048 and 1 shared, dense d_ff 18432,
   vocab 129,280; bf16, tp 4: 32 heads and 64 whole experts a rank, random
   weights from seed 0), depth cut to 4 layers (its 3 dense head layers and
   one MoE layer), serving one wave of 4 x 1024 tokens through
   ``examples/serve_lm_torch.py``, captured (flash launches exact: one a
   layer), its prefill logits through the kernel against the plain
   version; one wave captured against eager (16 decode steps on the latent
   cache, tokens and logits bitwise equal) and the capacity cut's drops;
   the smoke config (f32) on the card against the CPU at its own capacity
   and with room for every token, and one training step at ``(2, 2)`` (the
   backward's padded-v path).  The flash forward and backward are held
   against their plain versions with v's head dim unlike q's in phase 2
   (small shapes, f32 and bf16, and deepseek-v3's prefill and training
   shapes: bf16, 32/32 heads, d 192, d_v 128, causal, N 16 and 8), each
   row of the forward also against its own rms, and timed there beside
   SDPA (``is_causal``), the plain versions and their bounds;
15. the hybrid family: zamba2-7b at full width and full depth (81 Mamba2
   layers of d_model 3584, state 64, 112 SSD heads of 64, and one
   weight-shared attention block, 32/32 heads of 112 and d_ff 14336, run
   after every group of 6 layers, 13 times a pass; vocab 32,000; bf16, tp
   4: 28 SSD heads and 8/8 attention heads a rank, random weights from
   seed 0), serving one wave of 4 x 1024 tokens through
   ``examples/serve_lm_torch.py``, captured (launches exact: 81 SSD scans
   and 13 flash forwards a wave, all 13 on the d 128 wgmma route); one wave
   captured against eager (16 decode steps, tokens and logits bitwise
   equal); the prefill through both kernels against their plain versions
   at every position through the first group (6 Mamba2 layers and the
   shared block), a gate that planted faults in either kernel's plain
   version must break, and the full-depth gap printed; the smoke config
   (f32) on the card against the CPU, and one training step at ``(2,
   2)``.  The flash forward at zamba2's prefill shape (N 16, 8/8 heads, d
   112) and the SSD scan at its serving shape (state 64) are held against
   their plain versions in phase 2 and timed there (the flash forward as
   wired, on inputs padded to 128 beforehand, and beside SDPA);
16. a ``kernels:`` line, the kernel table as one JSON line, and as the
   last line ``{"ok": true, "device": {...}}``.

It needs one CUDA card and exits non-zero without one, or when the repository
is missing beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS reads this when CUDA starts: the training phase runs under
# deterministic algorithms, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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


def time_ms(fn, flush, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn``, with the L2 cache
    flushed before each run (the main path reads these arrays cold).  A
    sleep kernel ahead of each run lets the host enqueue the flush and the
    timed launch before the card reaches them, so the events time the
    device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
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
    """The kernel's name and template arguments out of its mangled name:
    the last identifier of its nested name (namespaces dropped), then its
    template arguments as mangled (enough to tell instantiations apart)."""
    import re
    rest = re.sub(r"^_ZN?", "", mangled)
    name = mangled
    while (m := re.match(r"\d+", rest)):
        n, rest = int(m.group(0)), rest[len(m.group(0)):]
        name, rest = rest[:n], rest[n:]
    targs = re.match(r"I[^E]*E", rest)
    return name + (targs.group(0) if targs else "")


def sass_counts(library, opcodes) -> dict:
    """How many of each opcode ``cuobjdump -sass`` finds in the built
    library: proof of which instructions the kernels run."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library.path())],
                          capture_output=True,
                          text=True, check=True).stdout
    return {op: sum(op in line for line in sass.splitlines())
            for op in opcodes}


# ptxas' notes that it serialised wgmmas (C7512: too few registers; C7515:
# another instruction wrote a wgmma's registers; C7517: a wait it had to
# insert) or ignored a register hand-over (C7508)
PTXAS_WGMMA_NOTES = ("C7508", "C7512", "C7515", "C7517")


def check_wgmma_build(name: str, library, n: int, pick: str = "wgmma",
                      require=("HGMMA", "UTMALDG"), forbid=()) -> dict:
    """A library's registers and spills by kernel (from its build log,
    which lies beside the library when an earlier process built it) and the
    counts of some opcodes in its SASS: HGMMA (wgmma), UTMALDG (TMA tensor
    load), UBLKCP (bulk copy), HMMA (mma.sync), LDSM (ldmatrix), ATOM and
    RED (atomics).  Fails unless each opcode of ``require`` is there and
    none of ``forbid``, the ``n`` kernels whose names hold ``pick`` ("" for
    every kernel) are there and spill nothing, and ptxas drew no note of
    serialised wgmmas.  Returns the registers and spills."""
    check(bool(library.log), f"the {name} library has no build log")
    regs = ptxas_summary(library.log)
    log(f"[build] {name} registers and spills: {regs}")
    sass = sass_counts(library, ("HGMMA", "UTMALDG", "UBLKCP", "HMMA",
                                 "LDSM", "ATOM", " RED"))
    log(f"[build] cuobjdump -sass of the {name} library: {sass}")
    check(all(sass[op] > 0 for op in require),
          f"the {name} library lacks one of {require}: {sass}")
    check(not any(sass[op] for op in forbid),
          f"the {name} library holds one of {forbid}: {sass}")
    picked = {k: v for k, v in regs.items() if pick in k}
    check(len(picked) == n and all(
        v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0
        for v in picked.values()),
        f"the {name} library's kernels ({n} wanted) spill or are missing: "
        f"{picked}")
    notes = [line.strip() for line in library.log.splitlines()
             if any(code in line for code in PTXAS_WGMMA_NOTES)]
    check(not notes, f"ptxas serialised the {name} library's wgmmas: {notes}")
    return regs


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


# The profiler loses device records: most often the first ones of a
# session, more of them the longer the process has run, now and then many
# more.  A session therefore opens with LEAD_IN tiny spin kernels (left out
# of every count) that take the common loss; counts that must be exact
# come from the host's launch calls or a graph's own topology instead.
LEAD_IN = 256
# The host's launch calls, one per kernel, copy or set on the card.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchCooperativeKernel", "cudaMemcpy",
                "cudaMemset", "cuMemcpy", "cuMemset")


def profiled(fn):
    """One profiled call of ``fn`` (already warm), after the lead-in:
    (the profile, the call's wall time in µs)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def device_rows(prof) -> list:
    """(device µs, count, name) of each kernel, copy or set the profile
    recorded, the lead-in left out."""
    return [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and "spin_kernel" not in e.key]


def profile_device_time(tag: str, fn) -> dict:
    """Device time by kernel over one call of ``fn`` (already warm), and
    the card's busy share of the call's wall time; returns the host's
    launch calls (exact), the device records (the profiler may lose some),
    busy and wall ms."""
    prof, wall_us = profiled(fn)
    rows = sorted(device_rows(prof), reverse=True)
    calls = sum(e.count for e in prof.key_averages()
                if e.key.startswith(LAUNCH_CALLS)) - LEAD_IN
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] profile: {len(rows)} kernel names, "
        f"{sum(r[1] for r in rows)} launches recorded of {calls} launch "
        f"calls, device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
        f"profiled wall time")
    for us, count, key in rows[:8]:
        log(f"[{tag}]   {us / 1e3:8.3f} ms  {count:5d} launches  {key[:70]}")
    return {"launch_calls": calls, "launches": sum(r[1] for r in rows),
            "busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3, "rows": rows}


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


def kernel_counts(fn, graph, tries: int = 5) -> dict:
    """Kernel launches by name over one profiled call of ``fn`` (already
    warm), which replays ``graph`` (captured under
    ``scheduler.keeping_topology()``).  A complete profile holds one device
    record per host launch call plus one per kernel, copy and set node of
    the graph, both counted exactly; the profiler drops records now and
    then (never adds one), so a profile that holds fewer is taken again,
    up to ``tries`` times, and only a complete one is read."""
    nodes = graph.node_counts()
    work = nodes["KERNEL"] + nodes["MEMCPY"] + nodes["MEMSET"]
    for i in range(tries):
        prof, _ = profiled(fn)
        rows = device_rows(prof)
        calls = sum(e.count for e in prof.key_averages()
                    if e.key.startswith(LAUNCH_CALLS)) - LEAD_IN
        recorded = sum(r[1] for r in rows)
        check(recorded <= calls + work, f"the profiler recorded {recorded} "
              f"device ops, more than the {calls} launch calls and {work} "
              f"graph nodes ({dict(nodes)}) of the call")
        if recorded == calls + work:
            return {key: count for _, count, key in rows}
        log(f"[wire] profile {i + 1} recorded {recorded} of {calls} launch "
            f"calls + {work} graph nodes: records dropped, taken again")
    check(False, f"no complete profile in {tries} tries")


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
    from repro_torch.core import reliable, scheduler
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
        with reliable.inject(faults), scheduler.keeping_topology():
            for _ in range(STEPS // N_INNER):   # builds, as run_wire_cell
                run, tape = segment_runner(driver, msim)
                state = run(msim.state, 0.0)    # its plans are drawn now
                if tape.extra_slots or faults is None:
                    break
        counts[cell] = kernel_counts(
            lambda: run(state, N_INNER * msim.swe.dt), run.graph)
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
# gemma3-1b's serving shape: 4 q heads over 1 kv head on every rank (the
# attention replicated at tp 4), d 256, window 512 (its local layers); its
# global layers see the whole causal prefix
FLASH_SERVE_GEMMA3 = (16, 1024, 1024, 4, 1, 256, True, 512, None)
FLASH_SERVE_GEMMA3_GLOBAL = (16, 1024, 1024, 4, 1, 256, True, None, None)
# mixtral-8x22b's prefill shape: a wave of 2 x 6144 tokens on tp 4 (N = 8
# stacked sequences), 12 q heads over 2 kv heads a rank, d 128, window
# 4096; its plain version materialises (8, 12, 6144, 6144) f32 scores
# (14.5 GB), so it is timed over MIXTRAL_PLAIN_RUNS runs
FLASH_SERVE_MIXTRAL = (8, 6144, 6144, 12, 2, 128, True, 4096, None)
MIXTRAL_PLAIN_RUNS = 5
# past the window a row averages 4096 values, so its outputs are ~1.65 /
# sqrt(4096) = 0.026, the size of FLASH_TOL's floor: at this shape each
# (n, query, head) row is also held to its own scale, max|kernel - plain|
# over the head dim within FLASH_ROW_REL of the row's rms(plain).  On an
# H100 the kernel's worst row reads 3.53e-2 to 3.55e-2 (bf16 rounding, rows
# inside and past the window alike); the planted faults, which must each
# break it, read 2.99 to 3.46 (the window one 64-key tile longer), 2.21 to
# 2.41 (one tile shorter) and 4.13 to 6.24 (no window)
FLASH_ROW_REL = 1e-1
FLASH_ROW_FAULTS = {"window + 64": 4096 + 64, "window - 64": 4096 - 64,
                    "no window": None}
# deepseek-v3-671b's prefill shape: a wave of 4 x 1024 tokens on tp 4 (N =
# 16 stacked sequences), 32 heads a rank (MLA folds the shared rope key into
# every head: no GQA), q/k head dim 192 (128 nope + 64 rope), v head dim
# MLA_DV, causal; bf16 takes the kernels' d_qk 192 / d_v 128 route, which
# reads q, k and v in place.  Its training shape takes 8 sequences
FLASH_SERVE_MLA = (16, 1024, 1024, 32, 32, 192, True, None, None)
FLASH_TRAIN_MLA = (8, 1024, 1024, 32, 32, 192, True, None, None)
MLA_DV = 128
# zamba2-7b's prefill shape: a wave of 4 x 1024 tokens on tp 4 (N = 16
# stacked sequences), 8 q heads over 8 kv heads a rank, head dim 112
# (3584 / 32), causal; bf16 zero-pads q, k and v to the d 128 wgmma route
# (three copies, 29.4 MB each, before the kernel reads them)
FLASH_SERVE_ZAMBA2 = (16, 1024, 1024, 8, 8, 112, True, None, None)
# small shapes whose v head dim differs from q's, each in f32 (fp32 FMA) and
# bf16 (wgmma: padded to 64, or the d_qk 192 / d_v 128 route, which pads
# (160, 96) to it): lengths no multiple of 64 or 128, S != T both ways, q
# heads over kv heads at rep 1, 2 and 4, windows and softcaps: (case, v
# head dim)
FLASH_DV_GRID = [((2, 64, 64, 4, 4, 24, True, None, None), 16),
                 ((2, 130, 130, 4, 4, 192, True, None, None), 128),
                 ((1, 100, 77, 4, 2, 48, True, 20, None), 32),
                 ((1, 333, 129, 8, 4, 192, True, None, None), 128),
                 ((2, 77, 301, 4, 1, 160, False, 40, 5.0), 96),
                 ((1, 260, 260, 4, 2, 192, True, 50, 3.0), 128)]
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


def flash_work(case, dv=None) -> tuple[int, int]:
    """(FLOPs, bytes) the function must spend on these inputs: 2·d (q·k)
    and 2·d_v (p·v) per visible (query, key) pair for every (n, head), the
    real head dims (``dv``, v's, defaults to q's d), not the kernel's
    padded ones; q, k, v read once and the output written once."""
    from repro_torch.kernels.flash_attention import ref
    N, S, T, H, KV, d, causal, window, _ = case
    dv = d if dv is None else dv
    pairs = int(ref.visible(S, T, causal, window, "cpu").sum())
    return (2 * (d + dv) * pairs * N * H,
            2 * (N * S * H * (d + dv) + N * T * KV * (d + dv)))


def flash_inputs(case, dtype, gen, dev, dv=None):
    """q, k and v of ``case`` (v of head dim ``dv``, q's d by default)."""
    N, S, T, H, KV, d = case[:6]
    dv = d if dv is None else dv
    return (torch.randn((N, S, H, d), generator=gen, device=dev).to(dtype),
            torch.randn((N, T, KV, d), generator=gen, device=dev).to(dtype),
            torch.randn((N, T, KV, dv), generator=gen, device=dev).to(dtype))


def library_attention(case, q, k, v):
    """``scaled_dot_product_attention`` on ``case``'s inputs (the library
    yardstick; heads-major copies of q, k, v): ``is_causal`` without a
    window, the visible pairs as a boolean mask with one."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref
    S, T, causal, window = case[1], case[2], case[6], case[7]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window is None:
        return (qt, kt, vt), dict(is_causal=causal, enable_gqa=True)
    mask = ref.visible(S, T, causal, window, q.device)
    return (qt, kt, vt), dict(attn_mask=mask, enable_gqa=True)


def work_bound(work, bw) -> dict:
    """``bound_ms`` and ``bound_by`` of ``(FLOPs, bytes)`` on this card: the
    larger of the bf16 tensor-core time and the memory time."""
    flops, nbytes = work
    ops_ms, bytes_ms = flops / BF16_FLOP_PER_S * 1e3, nbytes / bw * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def time_flash_gemma3(dev, flush, bw, gen) -> dict:
    """The forward at gemma3-1b's serving shapes (bf16, d 256: the wgmma +
    TMA kernel's d 256 form), local (window 512) and global (no window):
    kernel and SDPA (the window as a boolean mask; ``is_causal`` without
    one) beside the bound, the plain version at the local shape.  Returns
    the local shape's reading with the global one under ``"global"``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref
    out = {}
    for label, case in (("local", FLASH_SERVE_GEMMA3),
                        ("global", FLASH_SERVE_GEMMA3_GLOBAL)):
        kw = dict(causal=True, window=case[7])
        q, k, v = flash_inputs(case, torch.bfloat16, gen, dev)
        lib_args, lib_kw = library_attention(case, q, k, v)
        res = work_bound(flash_work(case), bw)
        smi_sample(f"flash-gemma3-{label}")
        res.update(
            ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *lib_args, **lib_kw), flush))
        if label == "local":
            res["plain_ms"] = time_ms(
                lambda: ref.flash_attention_ref(q, k, v, **kw), flush)
        log(f"[flash] gemma3-1b serving shape {case[:6]} bf16 causal, "
            f"window {case[7]} ({label}; wgmma + TMA, d 256): kernel "
            f"{res['ms'] * 1e3:.2f} us"
            + (f", plain {res['plain_ms'] * 1e3:.2f} us"
               if "plain_ms" in res else "")
            + f", scaled_dot_product_attention ("
            f"{'window as a boolean mask' if case[7] else 'is_causal'}) "
            f"{res['library_ms'] * 1e3:.2f} us, bound "
            f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}); kernel at "
            f"{100 * res['bound_ms'] / res['ms']:.1f} % of its bound, "
            f"{res['library_ms'] / res['ms']:.2f}x SDPA's speed")
        out[label] = res
        del q, k, v, lib_args
    return dict(out["local"], **{"global": out["global"]})


def flash_mixtral(dev, flush, bw, gen) -> dict:
    """The forward at mixtral-8x22b's prefill shape (bf16, d 128, causal,
    window 4096: the wgmma + TMA kernel, tiles outside the window
    skipped) against its plain version, element by element and row by row
    (FLASH_ROW_REL, which the planted FLASH_ROW_FAULTS must break), then
    timed beside it, SDPA (the window as a boolean mask) and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref
    case = FLASH_SERVE_MIXTRAL
    kw = dict(causal=True, window=case[7])
    q, k, v = flash_inputs(case, torch.bfloat16, gen, dev)
    want = ref.flash_attention_ref(q, k, v, **kw).float()
    diff = (fa.flash_attention(q, k, v, **kw).float() - want).abs()
    tol = FLASH_TOL[torch.bfloat16]
    err = diff.max().item()
    check(bool((diff <= tol + tol * want.abs()).all()),
          f"flash_attention {case} bf16: max|kernel - plain| {err} over "
          f"{tol} + {tol} |plain|")
    rms = want.square().mean(-1).sqrt()

    def row_gap(got):
        return ((got.float() - want).abs().amax(-1) / rms).max().item()
    row = (diff.amax(-1) / rms).max().item()
    check(row <= FLASH_ROW_REL,
          f"flash_attention {case} bf16: a row's max|kernel - plain| {row} "
          f"of its rms(plain) (bound {FLASH_ROW_REL})")
    del diff
    planted = {}
    for label, window in FLASH_ROW_FAULTS.items():
        planted[label] = row_gap(fa.flash_attention(q, k, v, causal=True,
                                                    window=window))
        check(planted[label] > FLASH_ROW_REL,
              f"the row gate misses the planted fault ({label}): "
              f"{planted[label]} of a row's rms")
    del want, rms
    _release()
    lib_args, lib_kw = library_attention(case, q, k, v)
    res = work_bound(flash_work(case), bw)
    smi_sample("flash-mixtral")
    res.update(
        max_abs_err=err, max_row_rel_err=row, planted_row_rel_err=planted,
        ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            *lib_args, **lib_kw), flush),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                         flush, MIXTRAL_PLAIN_RUNS))
    log(f"[flash] mixtral-8x22b prefill shape {case[:6]} bf16 causal, "
        f"window {case[7]} (wgmma + TMA, d 128): max|kernel - plain| "
        f"{err:.3e} (tol 2e-2 + 2e-2 |plain|), a row's max|kernel - plain| "
        f"{row:.3e} of its rms(plain) (bound {FLASH_ROW_REL}; planted "
        + ", ".join(f"{k} {v:.3e}" for k, v in planted.items())
        + f", each over it); kernel {res['ms']:.3f} ms, "
        f"plain {res['plain_ms']:.3f} ms (median of {MIXTRAL_PLAIN_RUNS}), "
        f"scaled_dot_product_attention (window as a boolean mask) "
        f"{res['library_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
        f"({res['bound_by']}); kernel at "
        f"{100 * res['bound_ms'] / res['ms']:.1f} % of its bound, "
        f"{res['library_ms'] / res['ms']:.2f}x SDPA's speed")
    del q, k, v, lib_args
    _release()
    return res


def sdpa_backend(fn, *args, **kw) -> str:
    """Which backend ``scaled_dot_product_attention`` takes on ``args``:
    PyTorch's own choice (``torch._fused_sdp_choice``, where this build has
    it), and the names of the kernels that one profiled call of ``fn`` (the
    call, or its backward) runs, longest first."""
    try:
        from torch.nn.attention import SDPBackend
        choice = SDPBackend(torch._fused_sdp_choice(*args, **kw)).name
    except (AttributeError, ImportError, RuntimeError, TypeError,
            ValueError) as e:
        choice = f"not read ({type(e).__name__})"
    fn()
    prof, _ = profiled(fn)
    names = [key[:60] for _, _, key in sorted(device_rows(prof),
                                              reverse=True)[:3]]
    return f"{choice}; kernels {names}"


def mla_views(gen, dev, d=192, dv=MLA_DV):
    """bf16 q and k as views of one fused (N, S, 2, H, d) projection and v
    as the first d_v columns of a wider tensor: strided views whose every
    stride is a multiple of 16 bytes, which the kernels read in place."""
    N, S, H = 2, 150, 4
    qk = torch.randn((N, S, 2, H, d), generator=gen, device=dev).bfloat16()
    vw = torch.randn((N, S, H, 2 * dv), generator=gen, device=dev).bfloat16()
    return qk[:, :, 0], qk[:, :, 1], vw[..., :dv]


def flash_mla(dev, flush, bw, gen) -> dict:
    """The forward with v's head dim unlike q's: on FLASH_DV_GRID (f32 and
    bf16), on strided views (``mla_views``) and at deepseek-v3's prefill
    shape (bf16, d 192, d_v 128) against its plain version, element by
    element and, at the prefill shape, each row against its own rms
    (FLASH_ROW_REL), every bf16 case of d_qk 129-192 and d_v <= 128 on the
    d_qk 192 / d_v 128 route (its launch counter); then timed there beside
    the d 256 route on the same inputs zero-padded beforehand (the route
    that ran MLA before), SDPA (``is_causal``, which takes a v head dim
    unlike q's; the backend it picks is logged), its plain version and its
    bound (the real head dims' work)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref
    worst = {}
    mla_cases = 0
    for case, dv in FLASH_DV_GRID + [(FLASH_SERVE_MLA, MLA_DV)]:
        kw = dict(zip(("causal", "window", "softcap"), case[6:]))
        for dt in (torch.float32, torch.bfloat16):
            if case == FLASH_SERVE_MLA and dt == torch.float32:
                continue
            q, k, v = flash_inputs(case, dt, gen, dev, dv)
            kind = fa.route(dt, case[5], dv)[0]
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            r0 = fa.route_launches[kind]
            got = fa.flash_attention(q, k, v, **kw)
            check(fa.route_launches[kind] == r0 + 1,
                  f"flash_attention {case} d_v {dv} {dt}: no launch on its "
                  f"route ({kind})")
            mla_cases += kind == "wgmma192"
            check(tuple(got.shape) == tuple(want.shape)
                  == tuple(q.shape[:3]) + (dv,),
                  f"flash_attention {case} d_v {dv}: output "
                  f"{tuple(got.shape)}, want v's head dim")
            diff = (got.float() - want).abs()
            tol = FLASH_TOL[dt]
            err = diff.max().item()
            check(bool((diff <= tol + tol * want.abs()).all()),
                  f"flash_attention {case} d_v {dv} {dt} ({kind} route): "
                  f"max|kernel - plain| {err} over {tol} + {tol} |plain|")
            worst[dt] = max(worst.get(dt, 0.0), err)
    row = (diff.amax(-1) / want.square().mean(-1).sqrt()).max().item()
    check(row <= FLASH_ROW_REL,
          f"flash_attention {FLASH_SERVE_MLA} d_v {MLA_DV} bf16: a row's "
          f"max|kernel - plain| {row} of its rms(plain) (bound "
          f"{FLASH_ROW_REL})")
    check(mla_cases == 1 + sum(d > 128 and dv <= 128
                               for (_, _, _, _, _, d, *_), dv in
                               FLASH_DV_GRID),
          f"the d_qk 192 / d_v 128 route ran {mla_cases} bf16 cases")
    del want, got, diff
    vq, vk, vv = mla_views(gen, dev)
    check(all(fa._rows_aligned(t) and not t.is_contiguous()
              for t in (vq, vk, vv)), "mla_views: not strided TMA views")
    r0 = fa.route_launches["wgmma192"]
    got = fa.flash_attention(vq, vk, vv, window=40, softcap=4.0)
    want = ref.flash_attention_ref(vq, vk, vv, window=40,
                                   softcap=4.0).float()
    tol = FLASH_TOL[torch.bfloat16]
    view_err = (got.float() - want).abs().max().item()
    check(fa.route_launches["wgmma192"] == r0 + 1 and bool(
        ((got.float() - want).abs() <= tol + tol * want.abs()).all()),
          f"flash_attention on strided views (d_qk 192 / d_v 128 route): "
          f"max|kernel - plain| {view_err}")
    worst[torch.bfloat16] = max(worst[torch.bfloat16], view_err)
    del vq, vk, vv, got, want
    _release()
    case = FLASH_SERVE_MLA
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    # the same inputs zero-padded to 256 beforehand: the d 256 route, which
    # ran MLA's shape before the d_qk 192 / d_v 128 route, without the
    # padding copies it then made
    dp = fa.padded_head_dim(q.dtype, case[5])
    qp, kp, vp = (F.pad(t, (0, dp - t.shape[-1])) for t in (q, k, v))
    check(fa.route(q.dtype, dp, dp) == ("wgmma", dp, dp),
          f"the padded inputs take {fa.route(q.dtype, dp, dp)}")
    res = work_bound(flash_work(case, MLA_DV), bw)
    smi_sample("flash-mla")
    res.update(
        max_abs_err=max(worst.values()), max_row_rel_err=row,
        ms=time_ms(lambda: fa.flash_attention(q, k, v), flush),
        d256_prepadded_ms=time_ms(lambda: fa.flash_attention(qp, kp, vp),
                                  flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), flush))
    res["library_backend"] = sdpa_backend(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        qt, kt, vt, is_causal=True)
    flops = flash_work(case, MLA_DV)[0]
    log(f"[flash] v head dim unlike q's on {len(FLASH_DV_GRID)} grid shapes "
        f"(f32, bf16), strided views and deepseek-v3's prefill shape: "
        f"max|kernel - plain| f32 {worst[torch.float32]:.3e} (tol 3e-5 + "
        f"3e-5 |plain|), bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2 + 2e-2 "
        f"|plain|), {mla_cases} bf16 cases and the views on the d_qk 192 / "
        f"d_v 128 route; at the prefill shape a row's max|kernel - plain| "
        f"{row:.3e} of its rms(plain) (bound {FLASH_ROW_REL})")
    log(f"[flash] deepseek-v3-671b prefill shape {case[:6]}, d_v {MLA_DV}, "
        f"bf16 causal (wgmma + TMA, the d_qk 192 / d_v 128 route, read in "
        f"place): kernel {res['ms'] * 1e3:.2f} us; the d 256 route on the "
        f"inputs zero-padded to {dp} beforehand "
        f"{res['d256_prepadded_ms'] * 1e3:.2f} us; plain "
        f"{res['plain_ms'] * 1e3:.2f} us; scaled_dot_product_attention "
        f"(is_causal) {res['library_ms'] * 1e3:.2f} us (backend "
        f"{res['library_backend']}); bound {res['bound_ms'] * 1e3:.2f} us "
        f"({flops / 1e9:.2f} GFLOP, {res['bound_by']}); kernel at "
        f"{100 * res['bound_ms'] / res['ms']:.1f} % of its bound, "
        f"{res['library_ms'] / res['ms']:.2f}x SDPA's speed, "
        f"{res['d256_prepadded_ms'] / res['ms']:.2f}x the padded d 256 "
        f"route's")
    del q, k, v, qt, kt, vt, qp, kp, vp
    _release()
    return res


def flash_zamba2(dev, flush, bw, gen) -> dict:
    """The forward at zamba2-7b's prefill shape (bf16, d 112: zero-padded
    to the d 128 wgmma route by the wrapper) against its plain version,
    element by element and each row against its own rms (FLASH_ROW_REL),
    on the wgmma route by its counter; then timed as wired (the wrapper's
    three padding copies included), on the same inputs zero-padded to 128
    beforehand (the kernel alone), beside SDPA (``is_causal``; the backend
    it picks is logged), its plain version and its bound (the real head
    dim's work)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref
    case = FLASH_SERVE_ZAMBA2
    q, k, v = flash_inputs(case, torch.bfloat16, gen, dev)
    kind, dp, _ = fa.route(q.dtype, case[5], case[5])
    check((kind, dp) == ("wgmma", 128), f"zamba2's d {case[5]} takes "
          f"{kind} at {dp}")
    r0 = fa.route_launches[kind]
    got = fa.flash_attention(q, k, v)
    check(fa.route_launches[kind] == r0 + 1,
          f"flash_attention {case}: no launch on the {kind} route")
    want = ref.flash_attention_ref(q, k, v).float()
    diff = (got.float() - want).abs()
    tol = FLASH_TOL[torch.bfloat16]
    err = diff.max().item()
    row = (diff.amax(-1) / want.square().mean(-1).sqrt()).max().item()
    check(bool((diff <= tol + tol * want.abs()).all()) and row
          <= FLASH_ROW_REL,
          f"flash_attention {case} bf16: max|kernel - plain| {err} over "
          f"{tol} + {tol} |plain|, or a row's {row} of its rms(plain) over "
          f"{FLASH_ROW_REL}")
    del want, diff, got
    # the kernel alone: the same work on inputs padded beforehand (scaled
    # by 1/sqrt(128), not 1/sqrt(112): a timing, not the same function)
    qp, kp, vp = (F.pad(t, (0, dp - case[5])) for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    res = work_bound(flash_work(case), bw)
    smi_sample("flash-zamba2")
    res.update(
        max_abs_err=err, max_row_rel_err=row,
        ms=time_ms(lambda: fa.flash_attention(q, k, v), flush),
        prepadded_ms=time_ms(lambda: fa.flash_attention(qp, kp, vp), flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), flush))
    res["library_backend"] = sdpa_backend(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        qt, kt, vt, is_causal=True)
    flops, nbytes = flash_work(case)
    log(f"[flash] zamba2-7b prefill shape {case[:6]} bf16 causal (the d 128 "
        f"wgmma route, d 112 zero-padded): max|kernel - plain| {err:.3e} "
        f"(tol 2e-2 + 2e-2 |plain|), a row's {row:.3e} of its rms(plain) "
        f"(bound {FLASH_ROW_REL}); as wired (three padding copies) "
        f"{res['ms'] * 1e3:.2f} us, on inputs padded to {dp} beforehand "
        f"{res['prepadded_ms'] * 1e3:.2f} us (the copies "
        f"{(res['ms'] - res['prepadded_ms']) * 1e3:.2f} us, "
        f"{100 * (1 - res['prepadded_ms'] / res['ms']):.1f} % of the call); "
        f"plain {res['plain_ms'] * 1e3:.2f} us; scaled_dot_product_attention "
        f"(is_causal) {res['library_ms'] * 1e3:.2f} us (backend "
        f"{res['library_backend']}); bound {res['bound_ms'] * 1e3:.2f} us "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
        f"{res['bound_by']}); as wired at "
        f"{100 * res['bound_ms'] / res['ms']:.1f} % of its bound and "
        f"{res['library_ms'] / res['ms']:.2f}x SDPA's speed, padded "
        f"beforehand {res['library_ms'] / res['prepadded_ms']:.2f}x")
    del q, k, v, qt, kt, vt, qp, kp, vp
    _release()
    return res


def check_forward_digests() -> None:
    """The d <= 128 wgmma forward's bits against the digests the card tests
    hold it to (its output and log-sum-exp as they were before the kernel
    moved its tensor maps into a shared header): that test, run on the
    card in a subprocess."""
    import re
    root = Path(__file__).resolve().parent
    test = "tests/test_torch_cuda.py::test_flash_forward_is_bitwise_what_it_was"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         test], cwd=root, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    passed = re.match(r"(\d+) passed\b", last)
    check(proc.returncode == 0 and passed is not None
          and "skipped" not in last,
          f"the d <= 128 flash forward's digests: {last} {proc.stderr[-800:]}")
    log(f"[flash] the d <= 128 forward's output and log-sum-exp bitwise as "
        f"they were: {passed.group(1)} digest cases ({test})")


def phase_flash_kernel(dev, flush, bw) -> dict:
    """The flash-attention kernel against its plain version on the grid and
    at the serving shapes (qwen3-8b's, gemma3-1b's), then timed at each
    serving shape beside its plain version and scaled_dot_product_attention
    (the library yardstick)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {}
    for case in FLASH_GRID + [FLASH_SERVE, FLASH_SERVE_GEMMA3]:
        kw = dict(zip(("causal", "window", "softcap"), case[6:]))
        for dt in (torch.float32, torch.bfloat16):
            if case in (FLASH_SERVE, FLASH_SERVE_GEMMA3) \
                    and dt == torch.float32:
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
        f"two serving shapes: max|err| f32 {worst[torch.float32]:.3e} (tol 3e-5 "
        f"+ 3e-5 |plain|), bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2 + "
        f"2e-2 |plain|)")
    check_forward_digests()
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
               **work_bound((flops, nbytes), bw),
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
    out["gemma3_serving"] = time_flash_gemma3(dev, flush, bw, gen)
    out["mixtral_serving"] = flash_mixtral(dev, flush, bw, gen)
    out["deepseek_serving"] = flash_mla(dev, flush, bw, gen)
    out["zamba2_serving"] = flash_zamba2(dev, flush, bw, gen)
    out["max_abs_err"] = max(out["max_abs_err"],
                             out["mixtral_serving"]["max_abs_err"],
                             out["deepseek_serving"]["max_abs_err"],
                             out["zamba2_serving"]["max_abs_err"])
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


SERVE_REPLAYS = 8   # captured decode replays held bitwise against eager


def serve_buffers(st) -> list:
    """A serving state's tensors: the caches, last_logits, length."""
    c = st.caches
    return ([c.k, c.v] if hasattr(c, "k") else [c.conv, c.h]) + [
        st.last_logits, st.length]


def run_serving(ex, args, sess, counter) -> list:
    """The example's serving run four times, captured (the main path: the
    kernel's launch ``counter`` module is zeroed just before and read just
    after), eager, captured, eager: each run's metrics with its launches.
    The eager runs must serve the same greedy tokens as the captured."""
    runs = []
    for eager in (False, True, False, True):
        args.eager = eager
        counter.launches = 0
        out = ex.run(args, log=log if not runs else (lambda *a: None),
                     sess=sess)
        out["launches"] = counter.launches
        out["mode"] = "eager" if eager else "captured"
        runs.append(out)
        check(out["finished"] == runs[0]["finished"],
              f"{out['mode']} serving run {len(runs)} generated other tokens "
              f"than the captured run 1")
    args.eager = False
    for out in runs:
        log(f"[serve-modes] {out['mode']:8s}: median decode "
            f"{out['decode_ms_per_token_median']:.2f} ms/step, "
            f"{out['tokens_per_s']:.2f} generated tokens/s over "
            f"{out['wall_s']:.2f} s ({out['decode_tokens_per_s']:.2f} per s "
            f"of decode time), prefill ms {out['prefill_ms']}, peak memory "
            f"{out['peak_mem_gb']:.2f} GB, {out['launches']} launches of "
            f"{counter.__name__.split('.')[-2]}, {out['decode_graphs']} "
            f"decode graph(s)")
    log("[serve-modes] every run served the same greedy tokens")
    return runs


def check_captured_wave(tag, sess, args, comm, toks, dev) -> dict:
    """One wave at the example's shapes, captured against eager on the
    card: the prefill's replay, handed to a slot state by copy, bitwise
    equal to the eager prefill; SERVE_REPLAYS + 1 captured decode steps
    (the warm-up that captures, then the replays) bitwise equal to as many
    eager steps (tokens and logits at every step, and the final state);
    each graph holding exactly the launches of the eager call (its kernel,
    copy and set nodes against the eager call's launch calls).  Returns
    the profiles."""
    from repro_torch.core import scheduler
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec
    from repro_torch.train import serve as serve_mod
    cfg, S, B, gen = sess.cfg, args.prompt_len, args.batch, args.gen
    fns = {}
    for captured in (False, True):
        _, pre = serve_mod.build_serve_fn(
            cfg, args.tp, comm, isp.ShapeSpec("wave", S, B, "prefill"),
            cache_capacity=S + gen, device=dev, captured=captured)
        rt, step = serve_mod.build_serve_fn(
            cfg, args.tp, comm, isp.ShapeSpec("wave", S + gen, B, "decode"),
            device=dev, captured=captured)
        fns[captured] = (pre, step)
    (pre_e, step_e), (pre_c, step_c) = fns[False], fns[True]
    batch = {"tokens": toks}
    e = pre_e(sess.params, batch)
    with scheduler.keeping_topology():
        pre_c(sess.params, batch)                   # warm-up and capture
    slot = pre_c(sess.params, batch, out=pre_c.new_state(sess.params))
    check(pre_c.graph.replays == 1, f"[{tag}] the prefill replayed "
          f"{pre_c.graph.replays} times, want 1")
    check(all(torch.equal(a, b) for a, b in zip(serve_buffers(e),
                                                  serve_buffers(slot))),
          f"[{tag}] the captured prefill's state differs from the eager one")
    for i in range(SERVE_REPLAYS + 1):
        te, tc = dec.greedy_tokens(e, rt), dec.greedy_tokens(slot, rt)
        check(torch.equal(te, tc), f"[{tag}] decode step {i}: captured "
              f"tokens {tc.tolist()} differ from eager {te.tolist()}")
        e = step_e(sess.params, te, e)
        with scheduler.keeping_topology():
            slot = step_c(sess.params, tc, slot)
        check(torch.equal(e.last_logits, slot.last_logits),
              f"[{tag}] decode step {i}: captured logits differ from eager")
    check(all(torch.equal(a, b) for a, b in zip(serve_buffers(e),
                                                  serve_buffers(slot))),
          f"[{tag}] the captured decode's final state differs from eager")
    (g,) = step_c.graphs.values()
    check(g.replays == SERVE_REPLAYS, f"[{tag}] the decode graph replayed "
          f"{g.replays} times, want {SERVE_REPLAYS}")
    log(f"[{tag}] captured prefill (a replay, handed to a slot by copy) and "
        f"{SERVE_REPLAYS + 1} captured decode steps ({SERVE_REPLAYS} "
        f"replays of one graph) bitwise equal to eager: tokens and logits "
        f"at every step, caches and length")
    # the graphs against the same functions run eagerly on the same static
    # inputs (the copy-in of a call's tokens is not part of a graph)
    g_pre = pre_c.graph
    prof = {
        "prefill eager": profile_device_time(
            f"{tag} prefill eager", lambda: dec.prefill(
                sess.params, {"tokens": g_pre.static[0]}, pre_e.rt,
                pre_e.max_len, out=e)),
        "prefill captured": profile_device_time(
            f"{tag} prefill captured", g_pre.replay),
        "decode eager": profile_device_time(
            f"{tag} decode eager", lambda: dec.decode_step(
                sess.params, g.static[0], e, rt)),
        "decode captured": profile_device_time(
            f"{tag} decode captured", g.replay)}
    for phase, graph in (("prefill", g_pre), ("decode", g)):
        a, b = prof[f"{phase} eager"], prof[f"{phase} captured"]
        nodes = graph.node_counts()
        work = nodes["KERNEL"] + nodes["MEMCPY"] + nodes["MEMSET"]
        check(work == a["launch_calls"],
              f"[{tag}] the {phase} graph holds {work} kernel, copy and set "
              f"nodes ({dict(nodes)}), the eager {phase} made "
              f"{a['launch_calls']} launch calls")
        log(f"[{tag}] {phase}: {work} launches eager and replayed (launch "
            f"calls against graph nodes {dict(nodes)}; the profiler "
            f"recorded {a['launches']} and {b['launches']}); device busy "
            f"{a['busy_ms']:.3f} ms eager, {b['busy_ms']:.3f} ms replayed")
    return prof


def busy_shares(tag, runs, prof) -> None:
    """Each mode's device busy share: the profiled device time of one step
    over the unprofiled step time of the serving runs (the profiler slows
    the host)."""
    for mode in ("captured", "eager"):
        out = next(r for r in runs if r["mode"] == mode)
        dec_ms = out["decode_ms_per_token_median"]
        pre_ms = out["prefill_ms"][-1]
        d, p = prof[f"decode {mode}"], prof[f"prefill {mode}"]
        log(f"[{tag}] {mode}: device busy {d['busy_ms']:.3f} ms of a "
            f"{dec_ms:.3f} ms decode step ({100 * d['busy_ms'] / dec_ms:.1f}"
            f" %), {p['busy_ms']:.3f} ms of a {pre_ms:.3f} ms prefill wave "
            f"({100 * p['busy_ms'] / pre_ms:.1f} %)")


def phase_serve_auto(dev, sess, args, toks) -> None:
    """Serving under ``comm="auto"``: a 4-rank e2e sweep of all_reduce's
    three consumer loops at both phases' message sizes, one config
    resolved per phase, and each auto-built phase's tokens and logits
    bitwise equal to the builders given its resolved config."""
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec
    from repro_torch.train import serve as serve_mod
    from repro_torch.tune import TuneDB, sweep
    cfg, S, B, gen = sess.cfg, args.prompt_len, args.batch, args.gen
    shapes = {"prefill": isp.ShapeSpec("wave", S, B, "prefill"),
              "decode": isp.ShapeSpec("wave", S + gen, B, "decode")}
    sizes = sorted(serve_mod.serve_msg_bytes(cfg, shp)
                   for shp in shapes.values())
    db_path = Path(__file__).resolve().parent / ".repro_tune" / \
        "chip_smoke_serve_tunedb.json"
    t0 = time.perf_counter()
    stats: dict = {}
    db = sweep.run_sweep(n_ranks=args.tp, collectives=("all_reduce",),
                         sizes=sizes, fast=True, objective="e2e",
                         db=TuneDB(), stats=stats, device=dev)
    db.save(db_path)
    check(sweep.CONSUMERS["all_reduce"] == ("row_parallel", "decode_step",
                                           "prefill"), "all_reduce consumers")
    tagged = {e.consumer for e in db.entries}
    check(tagged == set(sweep.CONSUMERS["all_reduce"]),
          f"consumer-tagged entries {sorted(tagged)}")
    log(f"[auto-serve] e2e sweep of all_reduce at {sizes} B on {args.tp} "
        f"ranks: {stats['measured']} candidates, {stats['e2e_measured']} "
        f"consumer loops, {time.perf_counter() - t0:.1f} s")
    resolved = {k: serve_mod.resolve_serve_comm(cfg, args.tp, "auto", shp,
                                                tune_db_path=db_path,
                                                device=dev)
                for k, shp in shapes.items()}
    for k, c in resolved.items():
        msg = serve_mod.serve_msg_bytes(cfg, shapes[k])
        best = db.best("all_reduce", msg, db.entries[0].topo,
                       objective="e2e",
                       consumer=serve_mod.PHASE_CONSUMERS[k])
        log(f"[auto-serve] {k}: {msg} B -> {c.mode.value}/"
            f"{c.scheduling.value}/chunk{c.chunk_bytes}/{c.algorithm} "
            f"({best.e2e_us:.1f} us per consumer iteration)")
    runs = {}
    for label, comms in (("auto", {"prefill": "auto", "decode": "auto"}),
                         ("resolved", resolved)):
        _, pre = serve_mod.build_serve_fn(
            cfg, args.tp, comms["prefill"], shapes["prefill"],
            cache_capacity=S + gen, device=dev, tune_db_path=db_path)
        rt, step = serve_mod.build_serve_fn(
            cfg, args.tp, comms["decode"], shapes["decode"], device=dev,
            tune_db_path=db_path)
        check(rt.comm == resolved["decode"], f"{label} decode comm")
        st = pre(sess.params, {"tokens": toks})
        toks_out, logits = [], [st.last_logits.clone()]
        for _ in range(4):
            nxt = dec.greedy_tokens(st, rt)
            toks_out.append(nxt.cpu())
            st = step(sess.params, nxt, st)
            logits.append(st.last_logits.clone())
        runs[label] = (torch.stack(toks_out, 1), logits)
        del pre, step, st
    (ta, la), (tr, lr) = runs["auto"], runs["resolved"]
    check(torch.equal(ta, tr) and all(torch.equal(a, b)
                                      for a, b in zip(la, lr)),
          "comm='auto' serving differs from its resolved configs")
    distinct = resolved["prefill"] != resolved["decode"]
    log(f"[auto-serve] comm='auto' prefill + 4 decode steps bitwise equal to "
        f"the resolved configs (tokens and logits); the phases chose "
        f"{'distinct' if distinct else 'the same'} configs")


def phase_serve(dev) -> int:
    """qwen3-8b at full width serving 8 requests through the example's
    continuous-batching loop, captured (the main path) and eager in turn;
    one wave captured against eager; one wave's prefill through the
    kernel against the plain version; serving under comm="auto"; and the
    overlapped row-parallel combine at the MLP's shape against the whole
    matmul + all-reduce.  Returns the flash-attention launches of the
    captured serving run."""
    from repro_torch.core import collectives, streaming
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import input_specs as isp, setup
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
    runs = run_serving(ex, args, sess, fa)
    out = runs[0]
    launches = out["launches"]
    waves = len(out["prefill_ms"])
    for run in runs:
        check(run["launches"] == run["flash_launches"]
              == cfg.n_layers * waves,
              f"{run['mode']}: flash-attention launches {run['launches']}, "
              f"want {cfg.n_layers} x {waves} waves")
    check(out["all_logits_finite"], "non-finite logits while serving")
    log(f"[serve] captured: prefill ms per wave {out['prefill_ms']}; median "
        f"decode {out['decode_ms_per_token_median']:.2f} ms per step; "
        f"{out['tokens_per_s']:.2f} generated tokens/s over the run's "
        f"{out['wall_s']:.2f} s ({out['decode_tokens_per_s']:.2f} per s of "
        f"decode time); peak memory "
        f"{out['peak_mem_gb']:.2f} GB; flash-attention launches {launches} "
        f"= {cfg.n_layers} layers x {waves} waves (one warm-up, one replay)")

    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len))
    busy_shares("serve", runs, check_captured_wave("serve", sess, args,
                                                   comm, toks, dev))

    capacity = args.prompt_len + args.gen
    rt, pre = serve_mod.build_serve_fn(
        cfg, args.tp, comm,
        isp.ShapeSpec("wave", args.prompt_len, args.batch, "prefill"),
        cache_capacity=capacity, device=dev, captured=False)
    got = pre(sess.params, {"tokens": toks}).last_logits
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
    del got, want, bad, pre

    phase_serve_auto(dev, sess, args, toks)

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


def phase_serve_smoke(dev, arch: str, S: int, GEN: int, rel=SMOKE_REL,
                      **overrides) -> None:
    """``arch``'s smoke config in f32 (with ``overrides``), tp = 4, on the
    card and on the CPU from the same weights: greedy tokens over GEN
    decode steps after an S-token prompt equal, logits within ``rel`` of
    max|logit|; on the card, decode equals prefill of the extended
    sequence (an MoE config only where its capacity holds every token:
    otherwise the prefill's capacity cut drops tokens that a decode step
    keeps, and the two differ by design)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.config import CommConfig
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec, sharding, transformer
    from repro_torch.train import serve as serve_mod
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                              **overrides)
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
    label = f"{cfg.name}" + "".join(f", {k}={v}" for k, v in
                                    overrides.items())
    rel_cpu = ((st.last_logits.cpu() - cpu_st.last_logits).abs().max()
               / cpu_st.last_logits.abs().max()).item()
    if cfg.family == "moe" and (cfg.capacity_factor * cfg.n_experts_per_tok
                                < cfg.n_experts):
        check(rel_cpu <= rel, f"smoke logits: card vs CPU {rel_cpu} "
              f"(bound {rel})")
        log(f"[serve] {label} f32 tp {tp}: greedy tokens over {GEN} decode "
            f"steps after {S} prompt tokens equal on the card and the CPU "
            f"(capacity cut active); card vs CPU {rel_cpu:.2e} of "
            f"max|logit|")
        return
    seq = np.concatenate([toks, card_toks.numpy()], axis=1)
    _, pre = serve_mod.build_serve_fn(
        cfg, tp, CommConfig(), isp.ShapeSpec("s", S + GEN, B, "prefill"),
        device=dev)
    ext = pre(params, {"tokens": seq})
    check(torch.equal(dec.greedy_tokens(st, rt), dec.greedy_tokens(ext, rt)),
          "smoke decode's next token differs from the extended prefill's")
    rel_ext = ((st.last_logits - ext.last_logits).abs().max()
               / ext.last_logits.abs().max()).item()
    check(rel_ext <= rel and rel_cpu <= rel,
          f"smoke logits: decode vs extended prefill {rel_ext}, card vs CPU "
          f"{rel_cpu} (bound {rel})")
    log(f"[serve] {label} f32 tp {tp}: greedy tokens over {GEN} decode "
        f"steps after {S} prompt tokens equal on the card and the CPU; "
        f"decode vs prefill of the extended sequence {rel_ext:.2e}, card vs "
        f"CPU {rel_cpu:.2e} of max|logit| (bound {rel})")


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
# zamba2-7b's serving shape: tp 4 x batch 4 x 28 heads of 64 a rank, state
# 64, 1024 tokens in 8 chunks of 128 (A = -linspace(1, 16, 112) cut into
# the ranks' heads, as its A_log is drawn)
SSD_SERVE_ZAMBA2 = (4, 4, 1024, 28, 64, 64, 128)
# At the serving shape the cumulative decay reaches ~-1.4e3, where f32's
# spacing is ~1e-4: two right summation orders differ at that level, so
# the kernel is held against the plain version run in float64, to at most
# SSD_F64_SLACK times the f32 plain version's own error plus
# SSD_F64_FLOOR * max|y|.
SSD_F64_SLACK, SSD_F64_FLOOR = 2.0, 1e-6
# the backward in bf16 against the plain backward at the unit shapes: tol +
# 2^-7 |plain| (tests/test_torch_cuda.py's SSD_BWD_TOL: both compute in f32
# from the same values, but dx, dB and dC leave in bf16, where two f32
# results a rounding apart may round one bf16 step apart)
SSD_BWD_BF16_RTOL = 2.0 ** -7
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


def ssd_against_f64(inp, chunk, label) -> float:
    """The scan kernel and its plain version on ``inp`` against the plain
    version in float64: the kernel errs at most SSD_F64_SLACK times the
    f32 plain version plus SSD_F64_FLOOR of max|y| (y and h_final).
    Returns max|kernel - plain|."""
    from repro_torch.kernels.ssd_scan import ops as ssd, ref
    got = ssd.ssd_chunked(*inp, chunk)
    plain = ref.ssd_chunked_ref(*inp, chunk)
    exact = ref.ssd_chunked_ref(*(t.double() for t in inp), chunk)
    worst = 0.0
    for g, p, e, what in zip(got, plain, exact, ("y", "h_final")):
        err_k = (g.double() - e).abs().max().item()
        err_p = (p.double() - e).abs().max().item()
        bound = SSD_F64_SLACK * err_p + SSD_F64_FLOOR * e.abs().max().item()
        gap = (g - p).abs().max().item()
        check(err_k <= bound, f"ssd_scan {label} {what}: kernel off float64 "
              f"by {err_k}, over {bound} (f32 plain off by {err_p})")
        log(f"[ssd] {label} {what}: max|kernel - f64| {err_k:.3e}, "
            f"max|plain f32 - f64| {err_p:.3e} (bound {bound:.3e}); "
            f"max|kernel - plain| {gap:.3e}")
        worst = max(worst, gap)
    return worst


def ssd_zamba2(dev, flush, bw, gen) -> dict:
    """The scan at zamba2-7b's serving shape (state 64), bf16 and f32 under
    its steep decay and bf16 under the shallow one, against the plain
    version in float64 (``ssd_against_f64``); then timed in bf16 at both
    decays beside its plain version and its bound."""
    from repro_torch.kernels.ssd_scan import ops as ssd, ref
    case, L = SSD_SERVE_ZAMBA2, SSD_SERVE_ZAMBA2[-1]
    worst = 0.0
    for dt, serving in ((torch.bfloat16, True), (torch.float32, True),
                        (torch.bfloat16, False)):
        inp = ssd_inputs(case, dt, gen, dev, serving=serving)
        worst = max(worst, ssd_against_f64(
            inp, L, f"zamba2-7b serving shape {dt}, "
            + ("steep" if serving else "shallow") + " decay"))
        del inp
        _release()
    steep = ssd_inputs(case, torch.bfloat16, gen, dev, serving=True)
    shallow = ssd_inputs(case, torch.bfloat16, gen, dev)
    flops, nbytes = ssd_work(case, 2)
    smi_sample("ssd-zamba2")
    out = dict(ms=time_ms(lambda: ssd.ssd_chunked(*steep, L), flush),
               shallow_ms=time_ms(lambda: ssd.ssd_chunked(*shallow, L),
                                  flush),
               plain_ms=time_ms(lambda: ref.ssd_chunked_ref(*steep, L),
                                flush),
               library_ms=None, max_abs_err=worst,
               **work_bound((flops, nbytes), bw))
    log(f"[ssd] zamba2-7b serving shape {case} bf16: kernel "
        f"{out['ms'] * 1e3:.2f} us (steep decay), "
        f"{out['shallow_ms'] * 1e3:.2f} us (shallow: no product skipped), "
        f"plain {out['plain_ms'] * 1e3:.2f} us, bound "
        f"{out['bound_ms'] * 1e3:.2f} us ({flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB: {out['bound_by']}); kernel at "
        f"{100 * out['bound_ms'] / out['ms']:.1f} % of its bound (steep), "
        f"{100 * out['bound_ms'] / out['shallow_ms']:.1f} % (shallow); "
        f"library call: none")
    del steep, shallow
    _release()
    return out


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
        worst = max(worst, ssd_against_f64(inp, L, f"serving shape {dt}"))
    inp = ssd_inputs(SSD_SERVE, torch.bfloat16, gen, dev, serving=True)
    flops, nbytes = ssd_work(SSD_SERVE, 2)
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
    ssd_against_f64(shallow, L, "serving shape, shallow decay, bf16")
    shallow_ms = time_ms(lambda: ssd.ssd_chunked(*shallow, L), flush)
    smi_sample("ssd")
    out = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
               **work_bound((flops, nbytes), bw),
               max_abs_err=worst)
    log(f"[ssd] serving shape {SSD_SERVE} bf16: kernel {k_ms * 1e3:.2f} us, "
        f"plain {p_ms * 1e3:.2f} us, bound {out['bound_ms'] * 1e3:.2f} us "
        f"({flops / 1e9:.2f} GFLOP at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, "
        f"{nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s: {out['bound_by']});"
        f" kernel at {100 * out['bound_ms'] / k_ms:.1f} % of its bound; "
        f"library call: none; at the shallow decay (no product skipped) "
        f"kernel {shallow_ms * 1e3:.2f} us")
    del inp, shallow
    _release()
    out["zamba2_serving"] = ssd_zamba2(dev, flush, bw, gen)
    out["max_abs_err"] = max(worst, out["zamba2_serving"]["max_abs_err"])
    return out


def phase_serve_ssm(dev) -> int:
    """mamba2-130m at full width serving 16 requests through the example's
    continuous-batching loop, captured (the main path) and eager in turn;
    one wave captured against eager; then one wave's logits at every
    position through the served model's first layer(s), through the kernel
    against the plain version and against two faults planted in the plain
    version; the full-depth prefill's last-position gap is printed.
    Returns the SSD launches of the captured serving run."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import input_specs as isp, setup
    from repro_torch.models import transformer
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
    runs = run_serving(ex, args, sess, ssd)
    out = runs[0]
    launches = out["launches"]
    waves = len(out["prefill_ms"])
    for run in runs:
        check(run["launches"] == run["ssd_launches"]
              == cfg.n_layers * waves,
              f"{run['mode']}: SSD scan launches {run['launches']}, want "
              f"{cfg.n_layers} x {waves} waves")
    check(out["all_logits_finite"], "non-finite logits while serving")
    log(f"[ssm] captured: prefill ms per wave {out['prefill_ms']}; median decode "
        f"{out['decode_ms_per_token_median']:.2f} ms per step; "
        f"{out['tokens_per_s']:.2f} generated tokens/s over the run's "
        f"{out['wall_s']:.2f} s ({out['decode_tokens_per_s']:.2f} per s of "
        f"decode time); peak memory {out['peak_mem_gb']:.2f} GB; SSD scan "
        f"launches {launches} = {cfg.n_layers} layers x {waves} waves "
        f"(one warm-up, one replay)")

    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len))
    busy_shares("ssm", runs, check_captured_wave("ssm", sess, args, comm,
                                                 toks, dev))
    shape = isp.ShapeSpec("wave", args.prompt_len, args.batch, "prefill")
    _, pre = serve_mod.build_serve_fn(
        cfg, args.tp, comm, shape,
        cache_capacity=args.prompt_len + args.gen, device=dev,
        captured=False)
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
    return launches


# ----------------------------------------------------------------------
# Training: the flash backward kernel and qwen3-8b at full width
# ----------------------------------------------------------------------

# the forward's bound form, tol + tol |plain|; the backward sums more
# products than the forward's output, so f32 is held to 1e-4
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the training shape: 8 stacked ranks x 4 sequences, 8 q heads over 2 kv
# heads per rank (qwen3-8b at tp 4), 1024 tokens, d 128, causal, bf16
FLASH_TRAIN = (32, 1024, 1024, 8, 2, 128, True, None, None)
# gemma3-1b's training shape: 8 stacked ranks x 4 sequences, 4 q heads over
# 1 kv head, d 256, window 512 (local layers) or none (global)
FLASH_TRAIN_GEMMA3 = (32, 1024, 1024, 4, 1, 256, True, 512, None)
FLASH_TRAIN_GEMMA3_GLOBAL = (32, 1024, 1024, 4, 1, 256, True, None, None)
FLASH_BWD_GRID = [
    (2, 100, 100, 4, 2, 64, True, None, None),
    (1, 130, 200, 8, 2, 64, True, 37, None),
    (3, 65, 129, 4, 1, 128, False, None, 5.0),
    (1, 150, 70, 2, 2, 16, True, 20, None),
    (2, 96, 96, 4, 2, 256, True, None, None),
    (2, 200, 200, 8, 8, 128, True, None, None),
    (1, 333, 129, 8, 4, 128, True, None, None),
]
# qwen3-8b at full width, 4 layers (1.39 B parameters; PERF.md section 4),
# bf16, random weights from seed 0, (data=2, model=4) stacked, ZeRO-1,
# global batch 8 x 1024 tokens of the synthetic corpus; mamba2-130m below
# trains SSM_TRAIN_STEPS (its loss falls slowly: step 4's is above step 1's)
TRAIN_STEPS, SSM_TRAIN_STEPS = 6, 8
TRAIN_ARGV = ["--arch", "qwen3-8b", "--full-size", "--layers", "4", "--dp",
              "2", "--tp", "4", "--seq", "1024", "--batch", "8", "--steps",
              str(TRAIN_STEPS), "--lr", "3e-4", "--seed", "0"]
# tests/test_distributed_parity.py's bounds (smoke config, f32)
TRAIN_GRAD_TOL, TRAIN_LOSS_TOL, TRAIN_PARAM_REL = 1e-4, 5e-4, 8e-3


def flash_bwd_work(case, dv=None) -> tuple[int, int]:
    """(FLOPs, bytes) of the backward on these inputs: five products per
    visible (query, key) pair for every (n, head), S, dQ and dK of 2·d and
    dP and dV of 2·d_v (``dv``, v's head dim, defaults to q's d: 2.5x the
    forward's two); q, k, v, o, dO and the f32 log-sum-exp read once, dq,
    dk, dv written once."""
    from repro_torch.kernels.flash_attention import ref
    N, S, T, H, KV, d, causal, window, _ = case
    dv = d if dv is None else dv
    pairs = int(ref.visible(S, T, causal, window, "cpu").sum())
    rows, rows_v = N * S * H * d, N * S * H * dv
    kv, kv_v = N * T * KV * d, N * T * KV * dv
    return (2 * (3 * d + 2 * dv) * pairs * N * H,
            2 * (rows + 2 * rows_v + kv + kv_v) + 4 * N * H * S
            + 2 * (rows + kv + kv_v))


def phase_flash_bwd_kernel(dev, flush, bw) -> dict:
    """The flash backward kernel against the plain backward (autograd
    through the plain version) on the grid and at the training shape, two
    runs bitwise equal; timed at the training shape on its route (bf16 d
    128: wgmma + TMA) beside the fp32-FMA route on the same inputs, the
    plain backward and scaled_dot_product_attention's backward, and its
    three kernels' device times from one profiled call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = {}
    for case in FLASH_BWD_GRID + [FLASH_TRAIN, FLASH_TRAIN_GEMMA3]:
        kw = dict(zip(("causal", "window", "softcap"), case[6:]))
        for dt in (torch.float32, torch.bfloat16):
            if case in (FLASH_TRAIN, FLASH_TRAIN_GEMMA3) \
                    and dt == torch.float32:
                continue
            q, k, v = flash_inputs(case, dt, gen, dev)
            dout = torch.randn(q.shape, generator=gen, device=dev).to(dt)
            out, lse = fa.flash_attention_lse(q, k, v, **kw)
            got = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            again = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
            tol = FLASH_BWD_TOL[dt]
            route = fa.bwd_route(dt, case[5])[0]
            for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
                diff = (a.float() - b.float()).abs()
                err = diff.max().item()
                check(bool((diff <= tol + tol * b.float().abs()).all()),
                      f"flash_attention_bwd {case} {dt} ({route} route) "
                      f"{name}: max|kernel - plain| {err} over {tol} + "
                      f"{tol} |plain|")
                check(torch.equal(a, c), f"flash_attention_bwd {case} {dt} "
                      f"({route} route) {name}: two runs differ")
                key = (route, dt)
                worst[key] = max(worst.get(key, 0.0), err)
            del got, again, want
    log(f"[flash-bwd] kernel vs plain backward on {len(FLASH_BWD_GRID)} grid "
        f"shapes and the two training shapes: max|err| wgmma route (bf16, d "
        f"64, 128, 256) {worst[('wgmma', torch.bfloat16)]:.3e} (tol 2e-2 + "
        f"2e-2 |plain|), fp32-FMA route (f32) "
        f"{worst[('fma', torch.float32)]:.3e} (tol 1e-4 + 1e-4 |plain|); "
        f"every case bitwise equal over two runs")
    q, k, v = flash_inputs(FLASH_TRAIN, torch.bfloat16, gen, dev)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    out, lse = fa.flash_attention_lse(q, k, v)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    flops, nbytes = flash_bwd_work(FLASH_TRAIN)
    route = fa.bwd_route(torch.bfloat16, FLASH_TRAIN[5])[0]
    smi_sample("flash-bwd")
    k_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse),
                   flush)
    dp = FLASH_TRAIN[5]
    fma_ms = time_ms(lambda: fa._backward(q, k, v, out, dout, lse,
                                          ("fma", dp, dp), True, None, None),
                     flush)
    p_ms = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, dout), flush)
    l_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                               retain_graph=True), flush)
    smi_sample("flash-bwd")
    res = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
               **work_bound((flops, nbytes), bw),
               max_abs_err=max(worst.values()), fma_ms=fma_ms)
    log(f"[flash-bwd] training shape {FLASH_TRAIN[:6]} bf16 causal ({route} "
        f"route: wgmma + TMA): kernel {k_ms * 1e3:.2f} us, the fp32-FMA "
        f"route on the same inputs {fma_ms * 1e3:.2f} us, plain backward "
        f"{p_ms * 1e3:.2f} us, scaled_dot_product_attention's backward "
        f"{l_ms * 1e3:.2f} us, bound {res['bound_ms'] * 1e3:.2f} us "
        f"({flops / 1e9:.2f} GFLOP at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, "
        f"{nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s: {res['bound_by']}); "
        f"kernel at {100 * res['bound_ms'] / k_ms:.2f} % of its bound, "
        f"{l_ms / k_ms:.2f}x SDPA's speed")
    profile_device_time("flash-bwd", lambda: fa.flash_attention_bwd(
        q, k, v, out, dout, lse))
    del q, k, v, out, dout, lse, qt, kt, vt, lib_out, dot
    res["gemma3_training"] = time_flash_bwd_gemma3(dev, flush, bw, gen)
    res["deepseek_training"] = flash_bwd_mla(dev, flush, bw, gen)
    res["max_abs_err"] = max(res["max_abs_err"],
                             res["deepseek_training"]["max_abs_err"])
    return res


def flash_bwd_mla(dev, flush, bw, gen) -> dict:
    """The backward with v's head dim unlike q's (dv of v's shape): on
    FLASH_DV_GRID (f32 on fp32 FMA, bf16 on wgmma: d_qk 129-192 with d_v <=
    128 on the d_qk 192 / d_v 128 route, by its launch counter), on strided
    views (``mla_views``) and at deepseek-v3's training shape (bf16, N 8,
    32/32 heads, d 192, d_v 128) against the plain backward, two runs
    bitwise equal; timed there beside the d 256 route on the operands
    zero-padded beforehand (the route that ran MLA before), SDPA's backward
    (``is_causal``; the backend it picks is logged), the plain backward and
    its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa, ref
    worst = {}
    mla_cases = 0

    def check_grads(label, kind, got, want, again, inputs, tol):
        for name, a, b, c, t in zip(("dq", "dk", "dv"), got, want, again,
                                    inputs):
            check(a.shape == t.shape, f"flash_attention_bwd {label}: {name} "
                  f"{tuple(a.shape)}, want {tuple(t.shape)}")
            diff = (a.float() - b.float()).abs()
            err = diff.max().item()
            check(bool((diff <= tol + tol * b.float().abs()).all()),
                  f"flash_attention_bwd {label} ({kind} route) {name}: "
                  f"max|kernel - plain| {err} over {tol} + {tol} |plain|")
            check(torch.equal(a, c), f"flash_attention_bwd {label} ({kind} "
                  f"route) {name}: two runs differ")
            worst[kind] = max(worst.get(kind, 0.0), err)

    for case, dv in FLASH_DV_GRID + [(FLASH_TRAIN_MLA, MLA_DV)]:
        kw = dict(zip(("causal", "window", "softcap"), case[6:]))
        for dt in (torch.float32, torch.bfloat16):
            if case == FLASH_TRAIN_MLA and dt == torch.float32:
                continue
            q, k, v = flash_inputs(case, dt, gen, dev, dv)
            out, lse = fa.flash_attention_lse(q, k, v, **kw)
            dout = torch.randn(out.shape, generator=gen, device=dev).to(dt)
            kind = fa.route(dt, case[5], dv)[0]
            r0 = fa.bwd_route_launches[kind]
            got = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            again = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            check(fa.bwd_route_launches[kind] == r0 + 2,
                  f"flash_attention_bwd {case} d_v {dv} {dt}: not on its "
                  f"route ({kind})")
            mla_cases += kind == "wgmma192"
            want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
            check_grads(f"{case} d_v {dv} {dt}", kind, got, want, again,
                        (q, k, v), FLASH_BWD_TOL[dt])
            del got, again, want
    check(mla_cases == 1 + sum(d > 128 and dv <= 128
                               for (_, _, _, _, _, d, *_), dv in
                               FLASH_DV_GRID),
          f"the d_qk 192 / d_v 128 backward ran {mla_cases} bf16 cases")
    vq, vk, vv = mla_views(gen, dev)
    kw = dict(window=40, softcap=4.0)
    vout, vlse = fa.flash_attention_lse(vq, vk, vv, **kw)
    vdout = torch.randn(vout.shape[:3] + (2 * MLA_DV,), generator=gen,
                        device=dev).bfloat16()[..., MLA_DV:]
    check(fa._rows_aligned(vdout) and not vdout.is_contiguous(),
          "the strided cotangent is no TMA view")
    r0 = fa.bwd_route_launches["wgmma192"]
    got = fa.flash_attention_bwd(vq, vk, vv, vout, vdout, vlse, **kw)
    again = fa.flash_attention_bwd(vq, vk, vv, vout, vdout, vlse, **kw)
    check(fa.bwd_route_launches["wgmma192"] == r0 + 2,
          "the strided views' backward is not on the d_qk 192 / d_v 128 "
          "route")
    check_grads("on strided views", "wgmma192", got,
                ref.flash_attention_bwd_ref(vq, vk, vv, vdout, **kw), again,
                (vq, vk, vv), FLASH_BWD_TOL[torch.bfloat16])
    del vq, vk, vv, vout, vlse, vdout, got, again
    _release()
    case = FLASH_TRAIN_MLA
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = dout.transpose(1, 2).contiguous()
    # every operand zero-padded to 256 beforehand: the d 256 route, which
    # ran MLA's shape before the d_qk 192 / d_v 128 route, without the
    # padding copies it then made
    dp = fa.bwd_route(q.dtype, case[5])[1]
    padded = [F.pad(t, (0, dp - t.shape[-1])) for t in (q, k, v, out, dout)]
    res = work_bound(flash_bwd_work(case, MLA_DV), bw)
    smi_sample("flash-bwd-mla")
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                          retain_graph=True)
    res.update(
        max_abs_err=max(worst.values()),
        ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse),
                   flush),
        d256_prepadded_ms=time_ms(
            lambda: fa.flash_attention_bwd(*padded, lse), flush),
        library_ms=time_ms(lib_bwd, flush),
        plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, dout),
                         flush))
    res["library_backend"] = sdpa_backend(lib_bwd, qt, kt, vt,
                                          is_causal=True)
    flops = flash_bwd_work(case, MLA_DV)[0]
    log(f"[flash-bwd] v head dim unlike q's on {len(FLASH_DV_GRID)} grid "
        f"shapes, strided views and deepseek-v3's training shape: "
        f"max|kernel - plain| wgmma routes "
        f"{max(worst['wgmma'], worst['wgmma192']):.3e} (d_qk 192 / d_v 128 "
        f"{worst['wgmma192']:.3e}; tol 2e-2 + 2e-2 |plain|), fp32-FMA route "
        f"{worst['fma']:.3e} (tol 1e-4 + 1e-4 |plain|); dv of v's shape, "
        f"{mla_cases} bf16 cases and the views on the d_qk 192 / d_v 128 "
        f"route, every case bitwise equal over two runs")
    log(f"[flash-bwd] deepseek-v3-671b training shape {case[:6]}, d_v "
        f"{MLA_DV}, bf16 causal (the d_qk 192 / d_v 128 route, read in "
        f"place): kernel {res['ms'] * 1e3:.2f} us; the d 256 route on the "
        f"operands zero-padded to {dp} beforehand "
        f"{res['d256_prepadded_ms'] * 1e3:.2f} us; plain backward "
        f"{res['plain_ms'] * 1e3:.2f} us; scaled_dot_product_attention's "
        f"backward (is_causal) {res['library_ms'] * 1e3:.2f} us (backend "
        f"{res['library_backend']}); bound {res['bound_ms'] * 1e3:.2f} us "
        f"({flops / 1e9:.2f} GFLOP, {res['bound_by']}); kernel at "
        f"{100 * res['bound_ms'] / res['ms']:.2f} % of its bound, "
        f"{res['library_ms'] / res['ms']:.2f}x SDPA's speed, "
        f"{res['d256_prepadded_ms'] / res['ms']:.2f}x the padded d 256 "
        f"route's")
    profile_device_time("flash-bwd-mla", lambda: fa.flash_attention_bwd(
        q, k, v, out, dout, lse))
    del q, k, v, out, dout, lse, qt, kt, vt, lib_out, dot, padded
    _release()
    return res


def time_flash_bwd_gemma3(dev, flush, bw, gen) -> dict:
    """The backward at gemma3-1b's training shapes (bf16, d 256: the wgmma
    route), local (window 512) and global (no window): kernel, the
    fp32-FMA route on the same inputs, and SDPA's backward (the window as a
    boolean mask; ``is_causal`` without one) beside the bound, the plain
    backward at the local shape, and the route's three kernels' device
    times from one profiled call of each.  Returns the local shape's
    reading with the global one under ``"global"``."""
    from repro_torch.kernels.flash_attention import ops as fa, ref
    import torch.nn.functional as F
    out = {}
    for label, case in (("local", FLASH_TRAIN_GEMMA3),
                        ("global", FLASH_TRAIN_GEMMA3_GLOBAL)):
        kw = dict(causal=True, window=case[7])
        q, k, v = flash_inputs(case, torch.bfloat16, gen, dev)
        dout = torch.randn(q.shape, generator=gen,
                           device=dev).to(torch.bfloat16)
        out_, lse = fa.flash_attention_lse(q, k, v, **kw)
        (qt, kt, vt), lib_kw = library_attention(case, q, k, v)
        qt, kt, vt = (t.requires_grad_(True) for t in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
        dot = dout.transpose(1, 2).contiguous()
        route = fa.bwd_route(torch.bfloat16, case[5])
        res = work_bound(flash_bwd_work(case), bw)
        smi_sample(f"flash-bwd-gemma3-{label}")
        res.update(
            ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, out_, dout,
                                                      lse, **kw), flush),
            fma_ms=time_ms(lambda: fa._backward(
                q, k, v, out_, dout, lse, ("fma", route[1], route[1]), True,
                case[7], None), flush),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True), flush))
        if label == "local":
            res["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, dout, **kw), flush)
        log(f"[flash-bwd] gemma3-1b training shape {case[:6]} bf16 causal, "
            f"window {case[7]} ({label}; {route[0]} route): kernel "
            f"{res['ms'] * 1e3:.2f} us, the fp32-FMA route on the same "
            f"inputs {res['fma_ms'] * 1e3:.2f} us"
            + (f", plain backward {res['plain_ms'] * 1e3:.2f} us"
               if "plain_ms" in res else "")
            + f", scaled_dot_product_attention's backward ("
            f"{'window as a boolean mask' if case[7] else 'is_causal'}) "
            f"{res['library_ms'] * 1e3:.2f} us, bound "
            f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}); kernel at "
            f"{100 * res['bound_ms'] / res['ms']:.2f} % of its bound, "
            f"{res['library_ms'] / res['ms']:.2f}x SDPA's speed, "
            f"{res['fma_ms'] / res['ms']:.1f}x the fp32-FMA route's")
        profile_device_time(f"flash-bwd-gemma3-{label}",
                            lambda: fa.flash_attention_bwd(
                                q, k, v, out_, dout, lse, **kw))
        out[label] = res
        del q, k, v, dout, out_, lse, qt, kt, vt, lib_out, dot
    return dict(out["local"], **{"global": out["global"]})


def _release():
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _leaf_gap(a_tree, b_tree, floor: float = 0.0) -> float:
    """The largest leaf's max|a - b| / max|b| (or over ``floor``, where that
    is larger)."""
    from repro_torch.optim import adamw
    gap = 0.0
    for (_, a), (_, b) in zip(adamw.leaves_with_names(a_tree),
                              adamw.leaves_with_names(b_tree)):
        a, b = a.float(), b.float().to(a.device)
        gap = max(gap, ((a - b).abs().max()
                        / max(b.abs().max().item() + 1e-12, floor)).item())
    return gap


def drain_and_resume(ex, argv, want, ckpt, tag, dev, at: int = 4) -> None:
    """``preempt@<at>`` through ``ex`` (examples/train_lm_torch.py) with
    ``argv``: the run drains after ``at`` steps (an emergency save of
    params and Adam moments into ``ckpt``), a fresh process resumes it to
    the end, and the joined loss stream must equal ``want``, the
    uninterrupted run's, bitwise."""
    from repro_torch.runtime.faults import FaultInjector, FaultSchedule
    argv = argv + ["--ckpt-dir", str(ckpt), "--ckpt-every", "1000"]
    t0 = time.perf_counter()
    res = ex.run(ex.parser().parse_args(argv), log=lambda *_: None,
                 faults=FaultInjector(FaultSchedule.parse(f"preempt@{at}")))
    part1 = res["history"]
    del res
    _release()
    drain_s = time.perf_counter() - t0
    check(len(part1) == at, f"[{tag}] preempt@{at} drained after "
          f"{len(part1)} steps")
    gib = 2.0**30
    free = torch.cuda.mem_get_info(dev)[0] / gib
    log(f"[{tag}] before the resume: this process holds "
        f"{torch.cuda.memory_reserved(dev) / gib:.2f} GiB reserved, the card "
        f"{free:.2f} GiB free")
    t0 = time.perf_counter()
    out = ckpt.parent / f"{ckpt.name}_resumed.json"
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "examples"
                             / "train_lm_torch.py"), *argv, "--resume",
         "--json", str(out)], capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                            / "src")))
    resume_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"[{tag}] the resumed process failed:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    resumed = json.loads(out.read_text())
    part2 = resumed["history"]
    check(part1 + part2 == want,
          f"[{tag}] drain + resume {part1 + part2} differs from the "
          f"uninterrupted run {want}")
    log(f"[{tag}] preempt@{at}: drained after {at} steps ({drain_s:.1f} s "
        f"with the emergency save of params and Adam moments); a fresh "
        f"process resumed and trained {len(part2)} more ({resume_s:.1f} s, "
        f"peak "
        f"{resumed['peak_bytes'] / 1e9:.2f} GB); the joined stream is "
        f"bitwise equal to the uninterrupted run")


def phase_train(dev, db_path) -> dict:
    """qwen3-8b training at full width through ``examples/train_lm_torch.py``
    (the main path: the flash kernels' counts are zeroed just before it and
    read just after), the int8 gradient wire, kernel vs plain attention on
    the first step, a drain with a fresh-process resume, rank loss with an
    elastic re-selection, and the smoke config against the CPU."""
    import tempfile
    from repro_torch.core.config import CommConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.obs import metrics as obs_metrics, trace as obs_trace
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault_tolerance as ft
    from repro_torch.runtime.faults import (FaultInjector, FaultSchedule,
                                            RankLostError)
    from repro_torch.train import loop as loop_mod, train_step as ts

    ex = load_example("train_lm_torch")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    quiet = lambda *_: None  # noqa: E731
    args = ex.parser().parse_args(TRAIN_ARGV)
    cfg = ex.model_config(args)
    L = cfg.n_layers
    tokens = args.batch * args.seq

    step_ms = load_example("train_ab_torch").step_ms

    # -- the main path, then the int8 gradient wire -----------------------
    # a full-width step gathers 10 GB tensors: each run starts from an
    # empty cache, as a fresh process does, so that what fits does not
    # depend on the phases before it
    gib = 2.0**30
    held = torch.cuda.memory_reserved(dev) / gib
    out = {}
    for wire in ("same", "int8"):
        _release()
        if wire == "same":
            log(f"[train] this process held {held:.2f} GiB reserved before "
                f"its cache was emptied, "
                f"{torch.cuda.memory_reserved(dev) / gib:.2f} GiB after "
                f"({torch.cuda.memory_allocated(dev) / gib:.2f} GiB "
                f"allocated)")
        # one async checkpoint, at the end of the main run: the card's
        # disk takes ~45 GiB of writes a call, and a full-width drain of
        # params and Adam moments below is 17 GB
        a = ex.parser().parse_args(
            TRAIN_ARGV + ["--grad-comm", wire, "--ckpt-dir", str(root / wire),
                          "--ckpt-every", str(TRAIN_STEPS if wire == "same"
                                              else 1000)])
        obs_trace.configure("1")
        fa.launches = fa.bwd_launches = 0
        for kname in fa.bwd_route_launches:
            fa.bwd_route_launches[kname] = 0
        for kname in qops.launches:
            qops.launches[kname] = 0
        res = ex.run(a, log=log)
        counts = dict(fwd=fa.launches, bwd=fa.bwd_launches,
                      bwd_wgmma=fa.bwd_route_launches["wgmma"],
                      **{k: v for k, v in qops.launches.items()})
        ms, n_spans = step_ms(obs_trace.events())
        obs_trace.configure("0")
        hist = res["history"]
        del res["session"]
        _release()
        check(len(hist) == TRAIN_STEPS and n_spans == TRAIN_STEPS,
              f"training ({wire}): {len(hist)} steps, {n_spans} spans")
        check(all(math.isfinite(x) for x in hist) and hist[-1] < hist[0],
              f"training ({wire}): loss {hist}")
        check(counts["fwd"] == TRAIN_STEPS * L * 2
              and counts["bwd"] == counts["bwd_wgmma"] == TRAIN_STEPS * L,
              f"training ({wire}): flash launches {counts}, want "
              f"{TRAIN_STEPS * L * 2} forward (remat recomputes each block) "
              f"and {TRAIN_STEPS * L} backward, all on the wgmma route")
        # the int8 ring: one hop each way per data group (dp 2): tp groups
        # x (reduce-scatter + all-gather) quantize and dequantize per step
        want_q = 0 if wire == "same" else TRAIN_STEPS * args.tp * 2
        check(counts["quantize"] == want_q and counts["dequantize"] == want_q,
              f"training ({wire}): quant launches {counts}, want {want_q}")
        out[wire] = dict(history=hist, norms=res["grad_norms"], ms=ms,
                         counts=counts,
                         peak=res["peak_bytes"], seconds=res["seconds"])
        log(f"[train] qwen3-8b {L} layers, (data=2, model=4), ZeRO-1, grad "
            f"wire {wire}: loss {hist[0]:.4f} -> {hist[-1]:.4f} over "
            f"{len(hist)} steps; {ms:.1f} ms/step (median of steps 2-"
            f"{TRAIN_STEPS}), {tokens / ms * 1e3:.0f} tokens/s; peak "
            f"{res['peak_bytes'] / 1e9:.2f} GB; {res['seconds']:.1f} s in "
            f"all; launches per step: flash forward "
            f"{counts['fwd'] // TRAIN_STEPS}, backward "
            f"{counts['bwd'] // TRAIN_STEPS} (wgmma route "
            f"{counts['bwd_wgmma'] // TRAIN_STEPS}), quantize "
            f"{counts['quantize'] // TRAIN_STEPS}, dequantize "
            f"{counts['dequantize'] // TRAIN_STEPS}")
    check(out["same"]["peak"] < 60e9, f"peak {out['same']['peak']} over 60 GB")
    log(f"[train] loss gap int8 vs exact wire after {TRAIN_STEPS} steps: "
        f"{abs(out['int8']['history'][-1] - out['same']['history'][-1]):.3e}")

    # -- the first step through the kernel and through the plain version --
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                         zero1=True)
    mesh = mesh_mod.make_test_mesh(args.dp, args.tp)
    from repro_torch.data.pipeline import SyntheticLM
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    sess = setup.build_session(cfg, mesh, CommConfig(), oc=oc, seed=0,
                               device=dev)
    # where a step's device time goes: one profiled step after a warm one
    step = setup.make_sharded_train_step(sess)
    src = SyntheticLM(data)
    p, o, _ = step(sess.params, sess.opt_state, src.batch_at(0))
    prof = profile_device_time("train", lambda: step(p, o, src.batch_at(1)))
    bwd_ms = sum(us for us, _, key in prof["rows"]
                 if "flash_bwd" in key) / 1e3
    log(f"[train] one profiled step: the card busy "
        f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f} % of its wall time; "
        f"the flash backward's kernels {bwd_ms:.3f} ms of it "
        f"({100 * bwd_ms / prof['busy_ms']:.1f} % of the busy time)")
    # whether the host or the card sets the step: the host's time to
    # enqueue one unprofiled step, and how long the card runs on after it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(p, o, src.batch_at(2))
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[train] one unprofiled step: the host enqueued it in "
        f"{(t1 - t0) * 1e3:.1f} ms and the card finished "
        f"{(t2 - t1) * 1e3:.1f} ms later")
    del p, o, step
    sess.opt_state = None
    _release()
    stacked = setup.shard_batch(sess, src.batch_at(0))
    lg = ts.make_loss_and_grad(sess.rt)
    from repro_torch.device import deterministic
    with deterministic():
        loss_k, _, g_k = lg(sess.params, stacked)
        loss_p, _, g_p = plain_attention(lambda: lg(sess.params, stacked))
    gap_loss = (loss_k - loss_p).abs().max().item()
    gap_grad = _leaf_gap(g_k, g_p)
    log(f"[train] first step through the kernels vs the plain attention: "
        f"loss {loss_k[0].item():.6f} vs {loss_p[0].item():.6f} (gap "
        f"{gap_loss:.3e}); gradients: largest leaf gap {gap_grad:.3e} of "
        f"its max|grad|")
    check(gap_loss < 1e-2 * abs(loss_p[0].item()),
          f"first-step loss through the kernels {loss_k} vs plain {loss_p}")
    del sess, g_k, g_p, lg, stacked
    _release()

    # -- preemption: drain at step 4, a fresh process resumes -------------
    drain_and_resume(ex, TRAIN_ARGV, out["same"]["history"], root / "preempt",
                     "train", dev)

    # -- rank loss: elastic re-selection onto (data=1, model=4) -----------
    reg = obs_metrics.registry()
    sweeps0 = reg.counter("sweep.runs").value
    resel0 = reg.counter("tune.model_reselects", collective="all_reduce").value
    comm = CommConfig()
    streams = []
    for run in (1, 2):
        ck = root / f"rank_lost_{run}"
        sess = setup.build_session(cfg, mesh, comm, oc=oc, seed=0, device=dev)
        t0 = time.perf_counter()
        try:
            loop_mod.train(sess, data, loop_mod.LoopConfig(
                n_steps=TRAIN_STEPS, ckpt_every=1000, ckpt_dir=str(ck),
                log_every=1000), log=quiet,
                faults=FaultInjector(FaultSchedule.parse("rank_lost@3=r7")))
            check(False, "rank_lost@3=r7 never fired")
        except RankLostError as e:
            check(e.rank == 7 and e.step == 3, f"rank loss {e}")
        del sess
        _release()
        t1 = time.perf_counter()
        sess2, start = ft.elastic_restore(
            ck, cfg, mesh_mod.make_test_mesh(1, args.tp), comm, oc,
            reselect=True, tune_db_path=db_path, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(start == 3, f"elastic restore at step {start}")
        hist = loop_mod.train(sess2, data, loop_mod.LoopConfig(
            n_steps=3, ckpt_every=1000, log_every=1000), log=quiet)
        c = sess2.rt.comm
        streams.append((c, hist))
        log(f"[train] rank_lost@3=r7 (run {run}): 3 steps + emergency save "
            f"of the params "
            f"{t1 - t0:.1f} s, elastic restore onto (data=1, model="
            f"{args.tp}) {t2 - t1:.1f} s, re-selected "
            f"{c.mode.value}/{c.scheduling.value}/{c.chunk_bytes} B chunks; "
            f"losses after {hist}")
        del sess2
        _release()
    check(streams[0] == streams[1], f"two same-seed faulted runs differ: "
          f"{streams}")
    check(reg.counter("sweep.runs").value == sweeps0,
          "a sweep ran during the elastic restore")
    check(reg.counter("tune.model_reselects", collective="all_reduce").value
          >= resel0 + 2, "the elastic restore did not re-select")
    log("[train] rank loss: both faulted runs bitwise equal; no sweep; "
        "tune.model_reselects moved")

    # -- the smoke config (f32) on the card against the CPU ----------------
    train_smoke_vs_cpu(dev, "qwen3-8b", dict(lr=1e-2, warmup_steps=1,
                                             total_steps=100), TRAIN_GRAD_TOL)
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# Training mamba2-130m: the SSD backward kernel and the model at full width
# ----------------------------------------------------------------------

# the training shape: 8 stacked ranks x 4 sequences (dp 2 x tp 4, batch 8),
# 6 heads per rank, 2048 tokens in 16 chunks of 128, head dim 64, state 128
SSD_TRAIN = (8, 4, 2048, 6, 64, 128, 128)
# mamba2-130m at full width and depth, bf16, random weights from seed 0,
# (data=2, model=4) stacked, ZeRO-1, 8 x 2048 tokens of the synthetic corpus
# a step: the Mamba2 paper's context
SSM_TRAIN_ARGV = ["--arch", "mamba2-130m", "--full-size", "--layers", "24",
                  "--dp", "2", "--tp", "4", "--seq", "2048", "--batch", "8",
                  "--steps", str(SSM_TRAIN_STEPS), "--lr", "3e-4", "--seed",
                  "0"]
# the first step's loss and every gradient leaf, through the kernels
# against the plain version, through the model's first SSM_GATE_LAYERS
# layer(s) of the same full-width weights (random-weight mamba2 is chaotic
# with depth: the full-depth gap is printed, not gated): the loss within
# 1e-2 of itself (qwen3's gate), each leaf within 5e-2 of its max|grad|
# (the serving gate's share; the bf16 model rounds y, B and C to bf16, so
# an f32-level difference in the scan moves elements by a bf16 step)
SSM_TRAIN_LOSS_REL, SSM_TRAIN_GRAD_REL = 1e-2, 5e-2
# mamba2's smoke config (f32) on the card against the CPU, the bounds of
# tests/test_torch_train_ssm.py: the JAX package's mamba2 gradient bound
# (tests/test_distributed_parity.py), and 3 AdamW steps at Adam eps 1 with
# a leaf that starts at zero held against 3 lr (why: that file's OC)
SSM_SMOKE_GRAD_TOL = 2e-3
SSM_SMOKE_OC = dict(lr=1e-2, warmup_steps=1, total_steps=100, eps=1.0)


def ssd_bwd_work(case, itemsize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the scan's backward on these inputs: per chunk,
    C·Bᵀ over the i >= j triangle once per (rank, batch, group); per head
    dy·xᵀ, (C·Bᵀ o D)ᵀ·dy (dx), Zᵀ·C (dB) and Z·B (dC) over the triangle, and
    five N x P products over the chunk (Cᵀ·dy for the hand-off, C·h and
    dy·hᵀ, B·g and x·gᵀ); x, B, C (itemsize), dt, A and dy (f32) read once,
    dx, dB, dC (itemsize), ddt and dA (f32) written once."""
    R, B, S, H, P, N, L = case
    G, nc, tri = 1, S // L, L * (L + 1) // 2
    flops = (R * B * G * nc * 2 * tri * N
             + R * B * H * nc * (4 * tri * (P + N) + 10 * L * N * P))
    rows, bc = R * B * S * H, R * B * S * G * N
    nbytes = (itemsize * 2 * (rows * P + 2 * bc)
              + 4 * (2 * rows + 2 * R * H + rows * P))
    return flops, nbytes


def _ssd_outs_grads(fn, inp, chunk, dy, dh=None):
    """(y, h_final, dx, ddt, dA, dB, dC) of ``<y, dy> + <h_final, dh>``
    through ``fn``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inp]
    y, h = fn(*leaves, chunk)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    return (y.detach(), h.detach()) + torch.autograd.grad(loss, leaves)


SSD_OUT_NAMES = ("y", "h_final", "dx", "ddt", "dA", "dB", "dC")


def ssd_f64_gate(case, dtype, steep, gen, dev, tag) -> dict:
    """The SSD forward and backward kernels at ``case`` against the plain
    version run in float64: y, h_final and the five gradients of ``<y,
    dy>``, each within SSD_F64_SLACK times the f32 plain version's own error
    plus SSD_F64_FLOOR of its largest value; two runs bitwise equal.
    ``steep`` takes the model's decay, else the unit shapes' shallow one.
    Returns max|kernel - f32 plain| by name."""
    from repro_torch.kernels.ssd_scan import ops as ssd, ref
    L = case[-1]
    decay = "steep" if steep else "shallow"
    inp = ssd_inputs(case, dtype, gen, dev, serving=steep)
    dy = torch.randn(inp[0].shape, generator=gen, device=dev)
    got = _ssd_outs_grads(ssd.ssd_chunked, inp, L, dy)
    again = _ssd_outs_grads(ssd.ssd_chunked, inp, L, dy)
    plain = _ssd_outs_grads(ref.ssd_chunked_ref, inp, L, dy)
    exact = _ssd_outs_grads(ref.ssd_chunked_ref, [t.double() for t in inp],
                            L, dy.double())
    gaps = {}
    for name, g, a, p, e in zip(SSD_OUT_NAMES, got, again, plain, exact):
        err_k = (g.double() - e).abs().max().item()
        err_p = (p.double() - e).abs().max().item()
        bound = SSD_F64_SLACK * err_p + SSD_F64_FLOOR * e.abs().max().item()
        check(err_k <= bound, f"ssd {tag} {case} {dtype} {decay} {name}: "
              f"kernel off float64 by {err_k}, over {bound} (f32 plain off "
              f"by {err_p})")
        check(torch.equal(g, a), f"ssd {tag} {case} {dtype} {decay} {name}: "
              f"two runs differ")
        log(f"[ssd-bwd] {tag} {dtype} {decay} decay {name}: max|kernel - "
            f"f64| {err_k:.3e}, max|plain f32 - f64| {err_p:.3e} (bound "
            f"{bound:.3e})")
        gaps[name] = (g.float() - p.float()).abs().max().item()
    del got, again, plain, exact
    _release()
    return gaps


def phase_ssd_bwd_kernel(dev, flush, bw) -> dict:
    """The SSD backward kernel against the plain backward (autograd of the
    plain version) at the unit shapes (f32, the mma.sync route, and bf16,
    the wgmma route; per element, with and without a cotangent of h_final)
    and at the training shape (bf16 and f32, under the model's steep decay
    and a shallow one, the forward's outputs and the gradients against the
    plain version in float64: :func:`ssd_f64_gate`), two runs bitwise
    equal; timed at the training shape in bf16 beside the plain
    backward and its bound (no PyTorch call computes the scan's gradient),
    its five kernels profiled.  ~13 s of the script's time; the bf16 unit
    shapes add under a second."""
    from repro_torch.kernels.ssd_scan import ops as ssd, ref
    gen = torch.Generator(device=dev).manual_seed(6)
    names = SSD_OUT_NAMES[2:]
    worst = 0.0
    for dtype, rtol in ((torch.float32, SSD_TOL),
                        (torch.bfloat16, SSD_BWD_BF16_RTOL)):
        unit = 0.0
        for case in SSD_GRID:
            inp = ssd_inputs(case, dtype, gen, dev)
            dy = torch.randn(inp[0].shape, generator=gen, device=dev)
            R, B, _, H, P, N, L = case
            dh = torch.randn((R, B, H, N, P), generator=gen, device=dev)
            for cot in (None, dh):
                got, again, want = (
                    _ssd_outs_grads(fn, inp, L, dy, cot)[2:]
                    for fn in (ssd.ssd_chunked, ssd.ssd_chunked,
                               ref.ssd_chunked_ref))
                for name, g, a, w in zip(names, got, again, want):
                    diff = (g.float() - w.float()).abs()
                    err = diff.max().item()
                    check(bool((diff <= SSD_TOL + rtol * w.float().abs())
                               .all()),
                          f"ssd backward {case} {dtype} {name}: max|kernel "
                          f"- plain| {err} over {SSD_TOL} + {rtol} |plain|")
                    check(torch.equal(g, a), f"ssd backward {case} {dtype} "
                          f"{name}: two runs differ")
                    unit = max(unit, err)
        log(f"[ssd-bwd] kernel vs plain backward on {len(SSD_GRID)} unit "
            f"shapes ({dtype}, with and without a cotangent of h_final): "
            f"max|err| {unit:.3e} (tol {SSD_TOL} + {rtol} |plain|); two runs "
            f"bitwise equal")
        worst = max(worst, unit)
    L = SSD_TRAIN[-1]
    for dtype in (torch.bfloat16, torch.float32):
        for steep in (True, False):
            gaps = ssd_f64_gate(SSD_TRAIN, dtype, steep, gen, dev,
                                "training shape")
            worst = max([worst] + [gaps[n] for n in names])
    times = {}
    for decay, steep in (("steep", True), ("shallow", False)):
        inp = ssd_inputs(SSD_TRAIN, torch.bfloat16, gen, dev, serving=steep)
        dy = torch.randn(inp[0].shape, generator=gen, device=dev)
        _, _, states, cum = ssd._forward(*inp, L, keep=True)
        bwd = lambda: ssd._backward(*inp, states, cum, L, dy, None)  # noqa
        smi_sample("ssd-bwd")
        times[decay] = time_ms(bwd, flush)
        if steep:
            leaves = [t.detach().clone().requires_grad_(True) for t in inp]
            y, _ = ref.ssd_chunked_ref(*leaves, L)
            times["plain"] = time_ms(lambda: torch.autograd.grad(
                y, leaves, dy, retain_graph=True), flush)
            del y, leaves
            profile_device_time("ssd-bwd", bwd)
        smi_sample("ssd-bwd")
        del states, cum
        _release()
    flops, nbytes = ssd_bwd_work(SSD_TRAIN, 2)
    out = dict(ms=times["steep"], plain_ms=times["plain"], library_ms=None,
               **work_bound((flops, nbytes), bw),
               max_abs_err=worst, shallow_ms=times["shallow"])
    log(f"[ssd-bwd] training shape {SSD_TRAIN} bf16, steep decay: kernel "
        f"{out['ms'] * 1e3:.2f} us, plain backward {out['plain_ms'] * 1e3:.2f}"
        f" us, bound {out['bound_ms'] * 1e3:.2f} us ({flops / 1e9:.2f} GFLOP "
        f"at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB at "
        f"{bw / 1e12:.2f} TB/s: {out['bound_by']}); kernel at "
        f"{100 * out['bound_ms'] / out['ms']:.1f} % of its bound; library "
        f"call: none; at the shallow decay (no product skipped) kernel "
        f"{out['shallow_ms'] * 1e3:.2f} us")
    return out


def train_smoke_vs_cpu(dev, arch, oc_kw, grad_tol, param_floor=0.0) -> None:
    """``arch``'s smoke config (f32) on a (2, 2) stack, ZeRO-1: the first
    step's gradients and 3 AdamW steps on the card against the CPU, within
    ``grad_tol`` of each leaf's max|grad|, TRAIN_LOSS_TOL on the losses and
    TRAIN_PARAM_REL of each leaf's max|param| (or ``param_floor``, where
    that is larger)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.config import CommConfig
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.models import sharding
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    scfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, scfg.vocab_size, (4, 32)),
             "labels": rng.randint(0, scfg.vocab_size, (4, 32))}
    soc = adamw.OptConfig(zero1=True, **oc_kw)
    runs, full = {}, None
    for where in ("cpu", dev):
        s = setup.build_session(scfg, mesh_mod.make_test_mesh(2, 2),
                                CommConfig(), oc=soc, device=where)
        full = setup.global_params(s) if full is None else full
        s.params = setup.stacked_params(s, full)
        _, _, g = ts.make_loss_and_grad(s.rt)(s.params,
                                              setup.shard_batch(s, batch))
        step = setup.make_sharded_train_step(s)
        p, o, losses = s.params, s.opt_state, []
        for _ in range(3):
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
        runs[str(where)] = (losses, sharding.unshard_params(g, scfg, 2),
                            setup.global_params(s, p))
    (lc, gc_, pc), (lk, gk, pk) = runs["cpu"], runs[str(dev)]
    gap_g = _leaf_gap(gk, gc_)
    gap_p = _leaf_gap(pk, pc, param_floor)
    gap_l = max(abs(a - b) for a, b in zip(lk, lc))
    check(gap_g < grad_tol and gap_l < TRAIN_LOSS_TOL
          and gap_p < TRAIN_PARAM_REL,
          f"{arch} smoke training on the card vs the CPU: grad {gap_g}, loss "
          f"{gap_l}, params {gap_p}")
    log(f"[train] {arch} smoke config (f32, (2, 2), ZeRO-1) on the card vs "
        f"the CPU: first-step gradients {gap_g:.3e} of max|grad| (tol "
        f"{grad_tol}), losses {gap_l:.3e} (tol {TRAIN_LOSS_TOL}), params "
        f"after 3 steps {gap_p:.3e} (tol {TRAIN_PARAM_REL})")


def phase_train_ssm(dev) -> dict:
    """mamba2-130m training at full width and depth through
    ``examples/train_lm_torch.py`` (the main path: the SSD kernels' counts
    are zeroed just before it and read just after), the backward's share
    of one profiled step, kernel vs plain SSD on the first step through the
    first SSM_GATE_LAYERS layer(s), preemption with a fresh-process resume,
    and the smoke config against the CPU."""
    import tempfile
    from repro_torch.core.config import CommConfig
    from repro_torch.data.pipeline import SyntheticLM, DataConfig
    from repro_torch.device import deterministic
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.models.common import Runtime
    from repro_torch.obs import trace as obs_trace
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    ex = load_example("train_lm_torch")
    probe = load_example("ssm_fault_probe_torch")
    step_ms = load_example("train_ab_torch").step_ms
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_ssm_"))
    args = ex.parser().parse_args(SSM_TRAIN_ARGV)
    cfg = ex.model_config(args)
    L, tokens = cfg.n_layers, args.batch * args.seq

    # -- the main path ----------------------------------------------------
    _release()
    obs_trace.configure("1")
    ssd.launches = ssd.bwd_launches = 0
    res = ex.run(ex.parser().parse_args(
        SSM_TRAIN_ARGV + ["--ckpt-dir", str(root / "main"),
                          "--ckpt-every", "1000"]), log=log)
    counts = dict(fwd=ssd.launches, bwd=ssd.bwd_launches)
    ms, n_spans = step_ms(obs_trace.events())
    obs_trace.configure("0")
    hist = res["history"]
    del res["session"]
    _release()
    check(len(hist) == SSM_TRAIN_STEPS and n_spans == SSM_TRAIN_STEPS,
          f"mamba2 training: {len(hist)} steps, {n_spans} spans")
    check(all(math.isfinite(x) for x in hist) and hist[-1] < hist[0],
          f"mamba2 training: loss {hist}")
    check(counts["fwd"] == SSM_TRAIN_STEPS * L * 2
          and counts["bwd"] == SSM_TRAIN_STEPS * L,
          f"mamba2 training: SSD launches {counts}, want "
          f"{SSM_TRAIN_STEPS * L * 2} forward (remat recomputes each block) "
          f"and {SSM_TRAIN_STEPS * L} backward")
    out = dict(history=hist, norms=res["grad_norms"], ms=ms, counts=counts,
               peak=res["peak_bytes"])
    log(f"[train-ssm] mamba2-130m {L} layers, (data=2, model=4), ZeRO-1, "
        f"8 x {args.seq} tokens: loss {hist[0]:.4f} -> {hist[-1]:.4f} over "
        f"{len(hist)} steps; {ms:.1f} ms/step (median of steps 2-"
        f"{SSM_TRAIN_STEPS}), {tokens / ms * 1e3:.0f} tokens/s; peak "
        f"{res['peak_bytes'] / 1e9:.2f} GB; {res['seconds']:.1f} s in all; "
        f"SSD launches per step: forward "
        f"{counts['fwd'] // SSM_TRAIN_STEPS}, backward "
        f"{counts['bwd'] // SSM_TRAIN_STEPS}")

    # -- where a step's device time goes: one profiled step after a warm one
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                         zero1=True)
    mesh = mesh_mod.make_test_mesh(args.dp, args.tp)
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                 global_batch=args.batch))
    sess = setup.build_session(cfg, mesh, CommConfig(), oc=oc, seed=0,
                               device=dev)
    step = setup.make_sharded_train_step(sess)
    p, o, _ = step(sess.params, sess.opt_state, src.batch_at(0))
    prof = profile_device_time("train-ssm", lambda: step(p, o,
                                                         src.batch_at(1)))
    bwd_ms = sum(us for us, _, key in prof["rows"] if "ssd_bwd" in key) / 1e3
    fwd_ms = sum(us for us, _, key in prof["rows"]
                 if "ssd_" in key and "ssd_bwd" not in key) / 1e3
    out.update(busy_ms=prof["busy_ms"], bwd_ms=bwd_ms, fwd_ms=fwd_ms)
    log(f"[train-ssm] one profiled step: the card busy "
        f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f} % of its wall time; "
        f"the SSD backward's kernels {bwd_ms:.3f} ms of it "
        f"({100 * bwd_ms / prof['busy_ms']:.1f} % of the busy time), the "
        f"forward's {fwd_ms:.3f} ms")
    del p, o, step
    sess.opt_state = None
    _release()

    # -- the first step through the kernels and through the plain version --
    stacked = setup.shard_batch(sess, src.batch_at(0))
    cut = dataclasses.replace(cfg, n_layers=SSM_GATE_LAYERS)
    cut_params = dict(sess.params, layers={
        k: v[:SSM_GATE_LAYERS] if torch.is_tensor(v) else
        {kk: vv[:SSM_GATE_LAYERS] for kk, vv in v.items()}
        for k, v in sess.params["layers"].items()})
    gaps = {}
    for label, rt, params in (
            ("cut", Runtime(cfg=cut, mesh=sess.rt.mesh, comm=sess.rt.comm),
             cut_params),
            ("full", sess.rt, sess.params)):
        lg = ts.make_loss_and_grad(rt)
        with deterministic():
            loss_k, _, g_k = lg(params, stacked)
            loss_p, _, g_p = probe.through(lambda: lg(params, stacked))
        gaps[label] = ((loss_k - loss_p).abs().max().item()
                       / abs(loss_p[0].item()), _leaf_gap(g_k, g_p),
                       loss_k[0].item(), loss_p[0].item())
        del g_k, g_p, lg
        _release()
    cl, cg, lk, lp = gaps["cut"]
    log(f"[train-ssm] first step through the SSD kernels vs the plain "
        f"version, the first {SSM_GATE_LAYERS} layer(s): loss {lk:.6f} vs "
        f"{lp:.6f} ({cl:.3e} of it; bound {SSM_TRAIN_LOSS_REL}), largest "
        f"gradient leaf gap {cg:.3e} of its max|grad| (bound "
        f"{SSM_TRAIN_GRAD_REL}); all {L} layers (not gated): loss "
        f"{gaps['full'][0]:.3e}, gradients {gaps['full'][1]:.3e}")
    check(cl <= SSM_TRAIN_LOSS_REL and cg <= SSM_TRAIN_GRAD_REL,
          f"mamba2 first step through the kernels vs plain: loss {cl}, "
          f"gradients {cg}")
    out["gate"] = gaps
    del sess, stacked, cut_params
    _release()

    # -- preemption: drain at step 4, a fresh process resumes -------------
    drain_and_resume(ex, SSM_TRAIN_ARGV, hist, root / "preempt", "train-ssm",
                     dev)

    # -- the smoke config (f32) on the card against the CPU ----------------
    train_smoke_vs_cpu(dev, "mamba2-130m", SSM_SMOKE_OC, SSM_SMOKE_GRAD_TOL,
                       param_floor=3 * SSM_SMOKE_OC["lr"])
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# The disk plan store and the pod axis
# ----------------------------------------------------------------------

# the sweep CLI's plan-store check: cold, then warm in the same process
# (program hits, warm <= 0.7 x cold), then a fresh process that must replay
# every plan from disk
PLAN_SWEEP_ARGV = ["--fast", "--ranks", "8", "--collectives",
                   "sendrecv,all_reduce,hierarchical_all_reduce", "--sizes",
                   "small", "--warm-check", "--device", "cuda"]
# hierarchical_all_reduce on (inner 4, outer 2): 1 MiB of f32 a rank,
# against the float64 sum (the f32 sums' rounding, 8 rows of randn)
HIER_BYTES = 1 << 20
HIER_ATOL = 1e-5
HIER_RUNS = 30
# mamba2-130m at full width and depth on (pod 2, data 2, model 2) against
# (data 4, model 2): 8 stacked ranks, bf16, ZeRO-1, remat, 8 x 2048 tokens
# a step, the exact wire.  Both meshes have tp 2 and give each data rank
# the same rows: the step-1 forward is the same, so its loss agrees within
# 1e-6 of itself and its gradient norm (the same mean gradient, summed in
# another order) within 1e-4; later steps within 1e-2 (random-weight mamba2
# amplifies rounding with depth, ROADMAP.md Queue 3)
POD_STEPS = 4
POD_LOSS1_REL, POD_NORM1_REL, POD_LOSS_REL = 1e-6, 1e-4, 1e-2
# the SSD kernels' shape on both of those meshes (8 ranks, 8 rows over dp 4,
# 24 heads over tp 2), which no other phase holds against the plain
# version: held there in bf16 under both decays by ssd_f64_gate, since the
# yardstick run launches the same kernels at the same shape
SSD_POD = (8, 2, 2048, 12, 64, 128, 128)


def _run_script(argv, env=None, timeout=600) -> str:
    """``python argv`` from the repository root; its stdout, or a failed
    check with its tail."""
    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, *argv], capture_output=True, text=True,
        timeout=timeout, cwd=str(root),
        env=dict(os.environ, PYTHONPATH=str(root / "src"), **(env or {})))
    check(proc.returncode == 0,
          f"{' '.join(argv[:3])} exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def _line(text: str, prefix: str) -> str:
    return next(l for l in text.splitlines() if l.startswith(prefix))


def phase_plans_and_pods(dev) -> dict:
    """The plan store: the sweep CLI's ``--plan-dir --warm-check`` (cold,
    warm and fresh-process seconds, the child's disk counts) and the SWE
    example run twice on one ``--plan-dir`` (equal final-state digests,
    disk hits the second time); the pod axis: ``hierarchical_all_reduce``
    at 1 MiB on 8 ranks against the plain sum and the flat ring all-reduce,
    and mamba2-130m's steps on ``(pod 2, data 2, model 2)`` against ``(data
    4, model 2)`` (the SSD kernels first held against the plain version at
    those meshes' shape, :data:`SSD_POD`; their counts zeroed just before
    the pod run and read just after).  Returns those counts and the step times."""
    import re
    import shutil
    import tempfile
    from repro_torch.core import collectives
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.config import CommConfig
    from repro_torch.data.pipeline import SyntheticLM, DataConfig
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.optim import adamw
    from repro_torch.tune import sweep

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_plans_"))

    # -- the sweep's plan store and warm checks ---------------------------
    out = _run_script(["-m", "repro_torch.tune.sweep", *PLAN_SWEEP_ARGV,
                       "--plan-dir", str(root / "sweep"),
                       "--out", str(root / "db.json")])
    warm = _line(out, "plan-cache warm check")
    cross = _line(out, "plan-store cross-process check")
    cold_s, warm_s = (float(v) for v in re.findall(r"([\d.]+)s", warm)[:2])
    fresh_s = float(re.findall(r"([\d.]+)s", cross)[1])
    hits, misses, corrupt = (int(v) for v in re.findall(
        r"(\d+) disk hits / (\d+) misses / (\d+) corrupt", cross)[0])
    check(hits > 0 and misses == 0 and corrupt == 0,
          f"the fresh-process sweep's disk counts: {cross}")
    log(f"[plans] sweep (8 ranks, sendrecv, all_reduce, "
        f"hierarchical_all_reduce, 16 KiB and 1 MiB, fast axes): cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s ({warm_s / cold_s:.3f} of "
        f"cold, bar 0.7), fresh process {fresh_s:.3f} s "
        f"({fresh_s / cold_s:.3f} of cold, no bar); the child's disk: "
        f"{hits} hits, {misses} misses, {corrupt} corrupt; "
        f"{_line(out, 'warm sweep wall clock').split(' — ')[1]}")

    # -- the SWE example twice on one plan directory ------------------------
    runs = []
    for i in range(2):
        text = _run_script(["examples/swe_simulation_torch.py",
                            "--plan-dir", str(root / "swe")])
        digest = _line(text, "final state digest").split()[-1]
        disk = re.findall(r"plan store: (\d+) disk hits / (\d+) misses / "
                          r"(\d+) writes", text)[0]
        runs.append((digest, [int(v) for v in disk],
                     _line(text, "ran ").split(", ")[1]))
    (d1, (_, m1, w1), us1), (d2, (h2, m2, _), us2) = runs
    check(d1 == d2, f"the SWE example's final states differ: {d1}, {d2}")
    check(w1 > 0 and h2 > 0 and m2 == 0,
          f"the SWE example's plan store: first run {runs[0][1]}, second "
          f"{runs[1][1]} (hits, misses, writes)")
    log(f"[plans] SWE example (2000 elements, 8 ranks, 200 steps) twice on "
        f"one --plan-dir: digest {d1} both times; first run {m1} disk "
        f"misses, {w1} writes ({us1}); second run {h2} disk hits, {m2} "
        f"misses ({us2})")

    # -- hierarchical_all_reduce at 1 MiB on 8 ranks ------------------------
    io = sweep._BenchMesh(("inner", "outer"), (4, 2))
    inner, outer = (Communicator.from_mesh(io, "inner"),
                    Communicator.from_mesh(io, "outer"))
    flat = Communicator.from_mesh(sweep._BenchMesh(("x",), (8,)), "x")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((8, HIER_BYTES // 4), generator=gen, device=dev)
    want = x.double().sum(0).float()
    hier = {}
    for algo in ("ring", "native"):
        cfg = CommConfig(algorithm=algo)
        for label, fn in (
                ("hierarchical", lambda: collectives.hierarchical_all_reduce(
                    x, inner, outer, cfg)),
                ("flat", lambda: collectives.all_reduce(x, flat, cfg))):
            y = fn()
            err = (y - want).abs().max().item()
            check(err <= HIER_ATOL, f"{label} {algo} all-reduce vs the plain "
                  f"sum: {err}")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            hier[f"{label} {algo}"] = (time_cuda(graph.replay, HIER_RUNS),
                                       err)
            del graph
    log("[pods] all-reduce of 1 MiB a rank on 8 ranks, captured, median of "
        f"{HIER_RUNS} (CUDA events), hierarchical on (inner 4, outer 2) "
        "against the flat ring: "
        + "; ".join(f"{k} {ms * 1e3:.2f} us (max|y - sum| {e:.2e})"
                    for k, (ms, e) in hier.items()))
    _release()

    # -- mamba2-130m on (pod, data, model) against (data, model) ------------
    ex = load_example("train_lm_torch")
    args = ex.parser().parse_args(SSM_TRAIN_ARGV)
    cfg = ex.model_config(args)
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                 global_batch=args.batch))
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=20, total_steps=POD_STEPS,
                         zero1=True)
    L = cfg.n_layers
    meshes = (("flat", mesh_mod.make_test_mesh(4, 2)),
              ("pod", mesh_mod.make_test_mesh(2, 2, pod=2)))
    for label, mesh in meshes:
        shape = (mesh.n_ranks, args.batch // mesh.dp, args.seq,
                 ssm_dims(cfg, mesh.tp)[0], cfg.ssm_head_dim, cfg.ssm_state,
                 cfg.ssm_chunk)
        check(shape == SSD_POD, f"the {label} mesh's SSD shape {shape}, "
              f"gated at {SSD_POD}")
    gen = torch.Generator(device=dev).manual_seed(7)
    for steep in (True, False):
        ssd_f64_gate(SSD_POD, torch.bfloat16, steep, gen, dev, "pod shape")
    res = {}
    for label, mesh in meshes:
        sess = setup.build_session(cfg, mesh, CommConfig(), oc=oc, seed=0,
                                   device=dev)
        step = setup.make_sharded_train_step(sess)
        p, o = sess.params, sess.opt_state
        losses, norms, ms = [], [], []
        if label == "pod":
            ssd.launches = ssd.bwd_launches = 0
        for i in range(POD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = step(p, o, src.batch_at(i))
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
        if label == "pod":
            counts = dict(fwd=ssd.launches, bwd=ssd.bwd_launches)
            glob = adamw.global_slices(o["m_slice"], sess.rt)
            rows = o["m_slice"].view(2, 4, -1)
            check(torch.equal(rows[0], rows[1]),
                  "the pods' ZeRO-1 slices differ")
            check(tuple(glob.shape) == (2, 2, o["m_slice"].shape[1]),
                  f"the pod session's global slices {tuple(glob.shape)}")
        res[label] = dict(losses=losses, norms=norms,
                          ms=statistics.median(ms[1:]))
        del p, o, step, sess
        _release()
    a, b = res["pod"], res["flat"]
    rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"])]
    norm1 = abs(a["norms"][0] - b["norms"][0]) / b["norms"][0]
    check(all(math.isfinite(v) for v in a["losses"] + b["losses"]),
          f"non-finite losses: pod {a['losses']}, flat {b['losses']}")
    check(rel[0] <= POD_LOSS1_REL and norm1 <= POD_NORM1_REL
          and max(rel[1:]) <= POD_LOSS_REL,
          f"pod vs flat mamba2 steps: losses {rel}, step-1 norm {norm1}")
    check(counts["fwd"] == POD_STEPS * L * 2
          and counts["bwd"] == POD_STEPS * L,
          f"pod-mesh SSD launches {counts}, want {POD_STEPS * L * 2} forward "
          f"and {POD_STEPS * L} backward")
    log(f"[pods] mamba2-130m {L} layers, ZeRO-1, 8 x {args.seq} tokens, "
        f"{POD_STEPS} steps: (pod 2, data 2, model 2) {a['ms']:.1f} ms/step "
        f"against (data 4, model 2) {b['ms']:.1f} (median of steps 2-"
        f"{POD_STEPS}); losses pod {[round(v, 6) for v in a['losses']]}, "
        f"flat {[round(v, 6) for v in b['losses']]} (step 1 {rel[0]:.2e} "
        f"of itself, bound {POD_LOSS1_REL}; later {max(rel[1:]):.2e}, bound "
        f"{POD_LOSS_REL}); step-1 gradient norm {a['norms'][0]:.6g} against "
        f"{b['norms'][0]:.6g} ({norm1:.2e}, bound {POD_NORM1_REL}); SSD "
        f"launches on the pod mesh: forward {counts['fwd']}, backward "
        f"{counts['bwd']}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[pods] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, ms=a["ms"], flat_ms=b["ms"], hier=hier)


# ----------------------------------------------------------------------
# FSDP, Megatron-SP and remat "dots" on the training path
# ----------------------------------------------------------------------

# allocations no training step makes, each allocated and freed at once:
# where they stand in the allocator's trace marks the ends of the forward,
# the cross-entropy, the backward and the model-axis gradient sum
PEAK_MARKS = tuple((7 << 20) + k * 512 for k in (3, 5, 7, 9))
PEAK_PARTS = ("stored weights", "gradients", "ZeRO-1 moments",
              "f32 flat gradient and delta vectors", "saved activations",
              "logits and cross-entropy", "backward temporaries", "other")
# qwen3-8b as phase 9 trains it (TRAIN_ARGV), 4 steps a run, in three
# runs, against phase 9's replicated run on the same weights (its first 4
# steps: with 20 warm-up steps the schedule does not depend on the run's
# length); mamba2-130m as phase 9 trains it (SSM_TRAIN_ARGV), 4 steps
# under FSDP, against phase 9's mamba2 run
FSDP_STEPS = 4
FSDP_RUNS = (("fsdp", ["--fsdp"]),
             ("fsdp+sp", ["--fsdp", "--seq-parallel"]),
             ("fsdp+sp+dots", ["--fsdp", "--seq-parallel",
                               "--remat-policy", "dots"]))
# Under FSDP the step-1 loss is bitwise the replicated run's (each layer's
# gathered weights are the replicated ones: the same products in the same
# order) and its gradient norm within 1e-4 of itself (the FSDP leaves'
# squares summed in another order); later losses within 1e-2 (phase 10's
# bounds); mamba2 under FSDP (SP is a no-op for it): step 1's loss within
# 1e-6 and its norm within 1e-4.
# Under SP, with or without "dots", the norm within 1e-4 and the step-1
# loss within SP_LOSS1_REL of itself, a bound set from readings on the
# H100: SP's combine carries the partial sums in the activation dtype, as
# the JAX package's does, and their bf16 rounding moved the step-1 loss
# 5.54e-06 of itself in training, 7.3e-06 to 2.2e-05 on the corpus's
# first SP_GATE_BATCHES batches; rounded to SP_CONTROL_BITS mantissa bits
# (the control), 1.5e-04 to 4.4e-04.  The phase reads both on those
# batches and checks that the bound parts them.
FSDP_NORM1_REL = 1e-4
SSM_LOSS1_REL = 1e-6
SP_LOSS1_REL, SP_NORM1_REL = 5e-5, 1e-4
SP_CONTROL_BITS, SP_GATE_BATCHES = 2, 3
FSDP_LOSS_REL = 1e-2
# preempt@2 under FSDP + SP; a fresh process resumes to step 4
FSDP_DRAIN_AT = 2


def coarse_sp_combine(fn, bits: int = SP_CONTROL_BITS):
    """``fn()`` with SP's combine fed its partial sums rounded to ``bits``
    mantissa bits (to nearest, ties away from zero): a planted loss of
    precision on the wire, for the step-1 gate to reject."""
    from repro_torch.models import layers
    scatter_sum = layers.scatter_sum
    drop = 23 - bits

    def coarse(x, comm, cfg, axis=0):
        b = x.float().view(torch.int32)
        b = (b + (1 << (drop - 1))) & -(1 << drop)
        return scatter_sum(b.view(torch.float32).to(x.dtype), comm, cfg,
                           axis)
    layers.scatter_sum = coarse
    try:
        return fn()
    finally:
        layers.scatter_sum = scatter_sum


def _with_steps(argv, n: int) -> list:
    i = argv.index("--steps")
    return argv[:i + 1] + [str(n)] + argv[i + 2:]


def _tree_bytes(tree) -> int:
    from repro_torch.optim import adamw
    return sum(t.numel() * t.element_size()
               for _, t in adamw.leaves_with_names(tree) if torch.is_tensor(t))


def peak_breakdown(dev, extra=()) -> dict:
    """Where phase 9's qwen3-8b step (TRAIN_ARGV: 4 layers, (2, 4),
    ZeRO-1, 8 x 1024 tokens; replicated, or as the training example's
    ``extra`` flags say) holds its peak: one step after a warm
    one, run as ``train_step.make_train_step`` runs it (``loss_fn`` taken
    apart into the forward and the cross-entropy), with the allocator's
    trace on (no stacks: gathering them in the backward's thread fails);
    the trace replayed to the peak, and every block live there put in a
    category by the phase that allocated it (marker allocations split
    them), whether it outlives the backward (the gradients) or the step
    (the new parameters), and, for the logits, its address.  Blocks live
    before the step: the parameters and the ZeRO-1 moments (the FSDP
    leaves' too), by their tensors' sizes, and the rest."""
    from repro_torch.core.config import CommConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import deterministic
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.models import layers, transformer
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    ex = load_example("train_lm_torch")
    args = ex.parser().parse_args(TRAIN_ARGV + list(extra))
    cfg = ex.model_config(args)
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                         zero1=True)
    _release()
    sess = setup.build_session(cfg, mesh_mod.make_test_mesh(args.dp, args.tp),
                               CommConfig(), oc=oc, seed=0, device=dev,
                               fsdp=args.fsdp,
                               seq_parallel=args.seq_parallel)
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq, global_batch=args.batch))
    step = setup.make_sharded_train_step(sess)
    p, o, _ = step(sess.params, sess.opt_state, src.batch_at(0))
    sess.params = sess.opt_state = None
    del step
    _release()
    rt = sess.rt
    stacked = setup.shard_batch(sess, src.batch_at(1))
    w_bytes, m_bytes = _tree_bytes(p), _tree_bytes(o)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def mark(k):
        torch.empty(PEAK_MARKS[k], dtype=torch.uint8, device=dev)
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             context=None)
    try:
        with deterministic():
            leaves = [t.detach().requires_grad_(True)
                      for _, t in adamw.leaves_with_names(p)]
            with torch.enable_grad():
                logits = transformer.forward(adamw._unflatten(p, leaves),
                                             stacked, rt, train=True).logits
                logits_addr = logits.untyped_storage().data_ptr()
                mark(0)
                loss = layers.cross_entropy_vocab_sharded(
                    logits, stacked["labels"], rt)
                mark(1)
                del logits
                grads = torch.autograd.grad(loss.sum(), leaves)
            del leaves, loss
            mark(2)
            grads = ts.grad_model_sync(adamw._unflatten(p, list(grads)),
                                       sess.mask, rt)
            mark(3)
            p2, o2, _ = adamw.apply_updates(p, grads, o, oc, rt,
                                            rt.fsdp_plan, sess.ms_mask,
                                            donate=True)
            del grads
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated(dev)
    trace = snap["device_traces"][dev.index or 0]
    # a block leaves memory_allocated when it is freed (requested)
    freed = ("free_requested" if any(e["action"] == "free_requested"
                                     for e in trace) else "free_completed")
    recs, by_addr, marks = [], {}, []
    cur, best, best_i, pre_freed, at_best = base, base, -1, 0, 0
    for e in trace:
        if e["action"] == "alloc":
            i = len(recs)
            recs.append({"size": e["size"], "free": math.inf,
                         "logits": e["addr"] == logits_addr
                         and not marks})
            by_addr[e["addr"]] = i
            cur += e["size"]
            if len(marks) < len(PEAK_MARKS) and \
                    e["size"] == PEAK_MARKS[len(marks)]:
                marks.append(i)
            if cur > best:
                best, best_i, at_best = cur, i, pre_freed
        elif e["action"] == freed:
            i = by_addr.pop(e["addr"], None)
            if i is None:
                pre_freed += e["size"]
            else:
                recs[i]["free"] = len(recs)
            cur -= e["size"]
    check(len(marks) == len(PEAK_MARKS),
          f"peak breakdown: marks {marks} in the trace")
    fwd_end, ce_end, bwd_end, sync_end = marks
    parts = dict.fromkeys(PEAK_PARTS, 0)
    parts["stored weights"] += w_bytes
    parts["ZeRO-1 moments"] += m_bytes
    parts["other"] += base - w_bytes - m_bytes - at_best
    for i, r in enumerate(recs[:best_i + 1]):
        if r["free"] <= best_i:
            continue
        if r["logits"] or fwd_end < i < ce_end:
            key = "logits and cross-entropy"
        elif i < fwd_end:
            key = "saved activations"
        elif i < bwd_end:
            key = "gradients" if r["free"] > bwd_end else \
                "backward temporaries"
        elif i < sync_end:
            key = "gradients"
        elif r["free"] == math.inf:
            key = "stored weights"
        else:
            key = "f32 flat gradient and delta vectors"
        parts[key] += r["size"]
    where = ("forward" if best_i < fwd_end else "cross-entropy"
             if best_i < ce_end else "backward" if best_i < bwd_end
             else "gradient sum" if best_i < sync_end else "update")
    del p, o, p2, o2, stacked, sess, snap, trace, recs
    _release()
    gb = 1e9
    log(f"[peak] qwen3-8b {cfg.n_layers} layers, (data=2, model=4), "
        f"ZeRO-1, {' '.join(extra) or 'replicated'}, 8 x {args.seq} "
        f"tokens: the step's "
        f"peak {best / gb:.2f} GB in the {where} (max_memory_allocated "
        f"{peak / gb:.2f} GB); live there: "
        + ", ".join(f"{k} {v / gb:.2f} GB" for k, v in parts.items()))
    return dict(peak=best, max_allocated=peak, where=where, parts=parts)


def _train_run(ex, argv, root, counters, steps: int = None) -> dict:
    """One run of ``ex`` (examples/train_lm_torch.py) with ``argv`` for
    ``steps`` steps (FSDP_STEPS by default), the main path: the kernels'
    counts zeroed just before it (``counters`` zeroes them and returns
    them) and read just after; its losses, gradient norms, ms/step, peak
    and counts."""
    steps = FSDP_STEPS if steps is None else steps
    from repro_torch.obs import trace as obs_trace
    step_ms = load_example("train_ab_torch").step_ms
    _release()
    obs_trace.configure("1")
    counters(reset=True)
    res = ex.run(ex.parser().parse_args(
        argv + ["--ckpt-dir", str(root), "--ckpt-every", "1000"]),
        log=lambda *_: None)
    counts = counters()
    ms, n_spans = step_ms(obs_trace.events())
    obs_trace.configure("0")
    del res["session"]
    _release()
    hist = res["history"]
    check(len(hist) == steps and n_spans == steps
          and all(math.isfinite(x) for x in hist),
          f"{argv}: {len(hist)} steps, {n_spans} spans, losses {hist}")
    return dict(history=hist, norms=res["grad_norms"], ms=ms,
                peak=res["peak_bytes"], counts=counts,
                seconds=res["seconds"])


def _against(tag, run, ref, loss1_rel, norm1_rel, later_rel=None) -> str:
    """Gate ``run``'s step-1 loss and gradient norm (and, with
    ``later_rel``, its later losses) against ``ref``'s first steps; the
    gaps as text.  ``loss1_rel`` 0 asks for the same bits."""
    n = len(run["history"])
    rel = [abs(a - b) / abs(b) for a, b in zip(run["history"],
                                               ref["history"][:n])]
    norm1 = abs(run["norms"][0] - ref["norms"][0]) / ref["norms"][0]
    if loss1_rel == 0:
        check(run["history"][0] == ref["history"][0],
              f"[{tag}] step-1 loss {run['history'][0]!r} is not the "
              f"replicated run's {ref['history'][0]!r}")
    check(rel[0] <= loss1_rel and norm1 <= norm1_rel,
          f"[{tag}] step 1 against the replicated run: loss {rel[0]}, "
          f"norm {norm1}")
    if later_rel is not None:
        check(max(rel[1:]) <= later_rel,
              f"[{tag}] later losses against the replicated run: {rel}")
    return (f"step-1 loss {run['history'][0]:.6f} against "
            f"{ref['history'][0]:.6f} ({rel[0]:.2e} of it), gradient norm "
            f"{run['norms'][0]:.6g} against {ref['norms'][0]:.6g} "
            f"({norm1:.2e}); later losses within {max(rel[1:]):.2e}")


def phase_fsdp(dev, train, train_ssm) -> dict:
    """Where the qwen3-8b step's peak lies, replicated and under FSDP + SP
    + "dots" (:func:`peak_breakdown`); qwen3-8b trained 4 steps through
    ``examples/train_lm_torch.py`` under FSDP, FSDP + SP and FSDP + SP +
    "dots" against phase 9's replicated run (``train``), the flash
    kernels' launches exact; the first step's loss and gradients under
    FSDP + SP + "dots" through the kernels against the plain attention;
    ``preempt@2`` under FSDP + SP resumed by a fresh process, bitwise; and
    mamba2-130m 4 steps under FSDP against phase 9's run (``train_ssm``),
    SSD launches exact, its first step through the kernels against the
    plain scan through the first layer(s).  Returns the launch counts."""
    import shutil
    import tempfile
    from repro_torch.core.config import CommConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import deterministic
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fsdp_"))
    ex = load_example("train_lm_torch")
    probe = load_example("ssm_fault_probe_torch")
    gb = 1e9

    # -- where the step's peak lies: replicated, and FSDP + SP + "dots" ----
    breakdown = {"replicated": peak_breakdown(dev),
                 "fsdp+sp+dots": peak_breakdown(dev, FSDP_RUNS[-1][1])}

    # -- qwen3-8b under FSDP, FSDP + SP, FSDP + SP + "dots" ----------------
    argv = _with_steps(TRAIN_ARGV, FSDP_STEPS)
    args = ex.parser().parse_args(argv)
    L = ex.model_config(args).n_layers
    ref = train["same"]
    runs = {}
    for label, extra in FSDP_RUNS:
        run = _train_run(ex, argv + extra, root / label, flash_counts)
        c = run["counts"]
        check(c["fwd"] == FSDP_STEPS * L * 2
              and c["bwd"] == c["bwd_wgmma"] == FSDP_STEPS * L,
              f"[fsdp] {label}: flash launches {c}, want "
              f"{FSDP_STEPS * L * 2} forward and {FSDP_STEPS * L} "
              f"backward, all on the wgmma route")
        gaps = _against(label, run, ref, 0 if label == "fsdp"
                        else SP_LOSS1_REL, FSDP_NORM1_REL if label == "fsdp"
                        else SP_NORM1_REL, FSDP_LOSS_REL)
        runs[label] = run
        log(f"[fsdp] qwen3-8b {L} layers, (data=2, model=4), ZeRO-1, "
            f"{label}: {run['ms']:.1f} ms/step (median of steps 2-"
            f"{FSDP_STEPS}; replicated {ref['ms']:.1f} in phase 9), peak "
            f"{run['peak'] / gb:.2f} GB (replicated "
            f"{ref['peak'] / gb:.2f}); {gaps}; flash launches per step: "
            f"forward {c['fwd'] // FSDP_STEPS}, backward "
            f"{c['bwd'] // FSDP_STEPS} (wgmma {c['bwd_wgmma'] // FSDP_STEPS})")

    # -- the first step through the kernels and the plain attention --------
    cfg = dataclasses.replace(ex.model_config(args), remat_policy="dots")
    mesh = mesh_mod.make_test_mesh(args.dp, args.tp)
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                 global_batch=args.batch))
    _release()
    sess = setup.build_session(cfg, mesh, CommConfig(), seed=0, device=dev,
                               fsdp=True, seq_parallel=True)
    stacked = setup.shard_batch(sess, src.batch_at(0))
    lg = ts.make_loss_and_grad(sess.rt)
    with deterministic():
        loss_k, _, g_k = lg(sess.params, stacked)
        loss_p, _, g_p = plain_attention(lambda: lg(sess.params, stacked))
    gap_loss = (loss_k - loss_p).abs().max().item()
    gap_grad = _leaf_gap(g_k, g_p)
    check(gap_loss < 1e-2 * abs(loss_p[0].item()),
          f"[fsdp] first-step loss through the kernels {loss_k} vs plain "
          f"{loss_p}")
    log(f"[fsdp] first step under FSDP + SP + dots through the kernels vs "
        f"the plain attention: loss {loss_k[0].item():.6f} vs "
        f"{loss_p[0].item():.6f} (gap {gap_loss:.3e}); gradients: largest "
        f"leaf gap {gap_grad:.3e} of its max|grad|")
    del g_k, g_p, stacked, lg
    _release()

    # -- SP's step-1 gate against its readings: the loss of replicated
    # weights, of SP's bf16 combine and of its control, forward only ------
    rep = setup.build_session(dataclasses.replace(cfg, remat_policy="full"),
                              mesh, CommConfig(), seed=0, device=dev)
    gaps = []
    with torch.no_grad(), deterministic():
        for b in range(SP_GATE_BATCHES):
            batch = src.batch_at(b)
            want = transformer.loss_fn(rep.params, setup.shard_batch(
                rep, batch), rep.rt)[0][0].item()
            st = setup.shard_batch(sess, batch)
            sp_loss = transformer.loss_fn(sess.params, st,
                                          sess.rt)[0][0].item()
            ctl = coarse_sp_combine(lambda: transformer.loss_fn(
                sess.params, st, sess.rt)[0][0].item())
            gaps.append((abs(sp_loss - want) / abs(want),
                         abs(ctl - want) / abs(want)))
    log(f"[fsdp] step-1 loss against the replicated one, batches 0-"
        f"{SP_GATE_BATCHES - 1}: SP's bf16 combine "
        f"{', '.join(f'{a:.3e}' for a, _ in gaps)} of it; the combine at "
        f"{SP_CONTROL_BITS} mantissa bits "
        f"{', '.join(f'{c:.3e}' for _, c in gaps)} (gate {SP_LOSS1_REL})")
    check(max(a for a, _ in gaps) <= SP_LOSS1_REL
          < min(c for _, c in gaps),
          f"[fsdp] SP's step-1 gate {SP_LOSS1_REL} does not part the bf16 "
          f"combine from its {SP_CONTROL_BITS}-bit control: {gaps}")
    del sess, rep
    _release()

    # -- preemption under FSDP + SP: drain at step 2, a fresh process resumes
    drain_and_resume(ex, argv + ["--fsdp", "--seq-parallel"],
                     runs["fsdp+sp"]["history"], root / "preempt", "fsdp",
                     dev, at=FSDP_DRAIN_AT)

    # -- mamba2-130m under FSDP ---------------------------------------------
    def ssd_counts(reset=False):
        if reset:
            ssd.launches = ssd.bwd_launches = 0
        return dict(fwd=ssd.launches, bwd=ssd.bwd_launches)

    sargv = _with_steps(SSM_TRAIN_ARGV, FSDP_STEPS)
    sargs = ex.parser().parse_args(sargv)
    scfg = ex.model_config(sargs)
    ssm_run = _train_run(ex, sargv + ["--fsdp"], root / "ssm", ssd_counts)
    c = ssm_run["counts"]
    SL = scfg.n_layers
    check(c["fwd"] == FSDP_STEPS * SL * 2 and c["bwd"] == FSDP_STEPS * SL,
          f"[fsdp-ssm] SSD launches {c}, want {FSDP_STEPS * SL * 2} forward "
          f"and {FSDP_STEPS * SL} backward")
    gaps = _against("fsdp-ssm", ssm_run, train_ssm, SSM_LOSS1_REL,
                    FSDP_NORM1_REL)
    log(f"[fsdp-ssm] mamba2-130m {SL} layers, (data=2, model=4), ZeRO-1, "
        f"FSDP, 8 x {sargs.seq} tokens: {ssm_run['ms']:.1f} ms/step "
        f"(median of steps 2-{FSDP_STEPS}; replicated "
        f"{train_ssm['ms']:.1f} in phase 9), peak "
        f"{ssm_run['peak'] / gb:.2f} GB (replicated "
        f"{train_ssm['peak'] / gb:.2f}); {gaps}; SSD launches per step: "
        f"forward {c['fwd'] // FSDP_STEPS}, backward "
        f"{c['bwd'] // FSDP_STEPS}")
    cut = dataclasses.replace(scfg, n_layers=SSM_GATE_LAYERS)
    sess = setup.build_session(cut, mesh, CommConfig(), seed=0, device=dev,
                               fsdp=True)
    ssrc = SyntheticLM(DataConfig(vocab_size=scfg.vocab_size,
                                  seq_len=sargs.seq,
                                  global_batch=sargs.batch))
    stacked = setup.shard_batch(sess, ssrc.batch_at(0))
    lg = ts.make_loss_and_grad(sess.rt)
    with deterministic():
        loss_k, _, g_k = lg(sess.params, stacked)
        loss_p, _, g_p = probe.through(lambda: lg(sess.params, stacked))
    cl = (loss_k - loss_p).abs().max().item() / abs(loss_p[0].item())
    cg = _leaf_gap(g_k, g_p)
    check(cl <= SSM_TRAIN_LOSS_REL and cg <= SSM_TRAIN_GRAD_REL,
          f"[fsdp-ssm] first step through the kernels vs plain: loss {cl}, "
          f"gradients {cg}")
    log(f"[fsdp-ssm] first step under FSDP through the SSD kernels vs the "
        f"plain scan, the first {SSM_GATE_LAYERS} layer(s): loss "
        f"{loss_k[0].item():.6f} vs {loss_p[0].item():.6f} ({cl:.3e} of "
        f"it; bound {SSM_TRAIN_LOSS_REL}), largest gradient leaf gap "
        f"{cg:.3e} (bound {SSM_TRAIN_GRAD_REL})")
    del sess, stacked, lg, g_k, g_p
    _release()
    shutil.rmtree(root, ignore_errors=True)
    log(f"[fsdp] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(breakdown=breakdown, runs=runs, ssm=ssm_run)


# ----------------------------------------------------------------------
# The rest of the dense family: gemma3-1b's local/global attention served
# and trained, command-r-plus-104b and deepseek-coder-33b served
# ----------------------------------------------------------------------

# gemma3-1b at full width and depth (26 layers: 4 super-blocks of 5 local
# layers and a global one, then 2 trailing local layers; bf16, random
# weights from seed 0, tp 4), 8 requests in waves of 4 x 1024-token prompts
# and up to 32 generated tokens: prompt and decode both pass the 512 window
GEMMA3_SERVE_ARGV = ["--tp", "4", "--batch", "4", "--prompt-len", "1024",
                     "--gen", "32", "--requests", "8", "--comm", "static"]
# gemma3-1b trained at full width and depth, (data=2, model=4), ZeRO-1,
# remat (one unit per super-block), 8 x 1024 tokens a step
GEMMA3_TRAIN_STEPS = 4
GEMMA3_TRAIN_ARGV = ["--arch", "gemma3-1b", "--full-size", "--layers", "26",
                     "--dp", "2", "--tp", "4", "--seq", "1024", "--batch",
                     "8", "--steps", str(GEMMA3_TRAIN_STEPS), "--lr", "3e-4",
                     "--seed", "0"]
# command-r-plus-104b and deepseek-coder-33b at full width, depth cut to
# WIDE_LAYERS (64 command-r layers of ~3.1 GB do not fit one card, and 4
# keep the phase in its time): one wave of 4 x 1024 tokens, up to 16
# decode steps
WIDE_LAYERS = 4
WIDE_SERVE_ARGV = ["--layers", str(WIDE_LAYERS), "--tp", "4", "--batch",
                   "4", "--prompt-len", "1024", "--gen", "16", "--requests",
                   "4", "--comm", "static"]


def flash_counts(reset: bool = False) -> dict:
    """The flash kernels' launch counts, forward and backward, in all and
    by route (zeroed first with ``reset``)."""
    from repro_torch.kernels.flash_attention import ops as fa
    if reset:
        fa.launches = fa.bwd_launches = 0
        for counter in (fa.route_launches, fa.bwd_route_launches):
            for k in counter:
                counter[k] = 0
    return dict(fwd=fa.launches, bwd=fa.bwd_launches,
                **{f"fwd_{k}": v for k, v in fa.route_launches.items()},
                **{f"bwd_{k}": v for k, v in fa.bwd_route_launches.items()})


def serve_dense(dev, arch: str, argv: list) -> dict:
    """``arch`` served through ``examples/serve_lm_torch.py`` with
    ``argv``, captured (the main path: the flash counts zeroed just before
    it and read just after; one launch a layer a prefill wave), then one
    wave's prefill logits through the kernel against the plain version
    (PREFILL_REL of max|logit|).  Lines are tagged by the family."""
    from repro_torch.configs import get_config
    from repro_torch.launch import input_specs as isp, setup
    from repro_torch.models import transformer
    from repro_torch.train import serve as serve_mod
    ex = load_example("serve_lm_torch")
    args = ex.parser().parse_args(["--arch", arch] + argv)
    cfg = ex.model_config(args)
    comm = ex.COMMS[args.comm]
    tag = "mla" if cfg.use_mla else cfg.family
    _release()
    t0 = time.perf_counter()
    sess = setup.build_session(cfg, args.tp, comm, seed=args.seed,
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gb = 1e9
    # the stored bytes of one layer of each kind (the dense head and the
    # MoE layers of the moe family), all ranks' shards
    kind_bytes = {}
    for p, _ in transformer.attention_layers(sess.params, cfg):
        kind_bytes.setdefault("MoE" if "moe" in p else "dense", sum(
            t.numel() * t.element_size() for t in _leaves(p)) / gb)
    full = get_config(arch)
    n_dense = full.n_dense_layers if full.family == "moe" else full.n_layers
    counts = {"dense": n_dense, "MoE": full.n_layers - n_dense}
    cut = ("full depth" if cfg.n_layers == full.n_layers else
           f"depth cut {full.n_layers} -> {cfg.n_layers} layers ("
           + " and ".join(f"{counts[k]} {k} x {b:.2f} GB"
                          for k, b in kind_bytes.items() if counts[k])
           + f" of bf16 layer weights do not fit one 80 GB card beside the "
           f"rest; {cfg.n_layers} keep the phase in its time)")
    attn = (f"{cfg.n_heads} heads of MLA (q_lora {cfg.q_lora_rank}, kv_lora "
            f"{cfg.kv_lora_rank}, q/k head dim {cfg.qk_nope_dim} + "
            f"{cfg.qk_rope_dim}, v {cfg.v_head_dim})" if cfg.use_mla else
            f"{cfg.n_heads} q heads"
            + (f" padded to {cfg.padded_heads}" if cfg.padded_heads else "")
            + f" over {cfg.n_kv_heads} kv, head dim {cfg.resolved_head_dim}")
    log(f"[{tag}] {arch}: full width (d_model {cfg.d_model}, {attn}, "
        f"d_ff {cfg.d_ff}, "
        + (f"{cfg.n_experts} experts top-{cfg.n_experts_per_tok} of d_ff "
           f"{cfg.moe_d_ff or cfg.d_ff}"
           + (f" + {cfg.n_shared_experts} shared" if cfg.n_shared_experts
              else "") + f", {cfg.n_dense_layers} dense head layers, "
           if cfg.n_experts else "")
        + f"vocab {cfg.vocab_size}), {cut}; bf16 weights "
        f"from seed {args.seed} initialised on the card in {init_s:.1f} s")
    flash_counts(reset=True)
    out = ex.run(args, log=lambda *_: None, sess=sess)
    counts = flash_counts()
    launches = counts["fwd"]
    waves = len(out["prefill_ms"])
    check(launches == out["flash_launches"] == cfg.n_layers * waves,
          f"[{tag}] {arch}: flash launches {launches}, want {cfg.n_layers} "
          f"x {waves} waves")
    check(out["all_logits_finite"], f"[{tag}] {arch}: non-finite logits")
    log(f"[{tag}] {arch} served captured: {out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']:.2f} s; "
        f"prefill ms per wave {[round(m, 2) for m in out['prefill_ms']]}; "
        f"median decode {out['decode_ms_per_token_median']:.2f} ms/step over "
        f"{out['decode_steps']} steps; peak {out['peak_mem_gb']:.2f} GB; "
        f"flash launches {launches} = {cfg.n_layers} layers x {waves} "
        f"wave(s)")
    _release()     # the serving run's graphs, before the plain prefill
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (args.batch, args.prompt_len))
    _, pre = serve_mod.build_serve_fn(
        cfg, args.tp, comm,
        isp.ShapeSpec("wave", args.prompt_len, args.batch, "prefill"),
        cache_capacity=args.prompt_len + args.gen, device=dev,
        captured=False)
    got = pre(sess.params, {"tokens": toks}).last_logits.clone()
    want = plain_attention(lambda: pre(sess.params, {"tokens": toks})
                           ).last_logits
    gap = ((got - want).abs().max() / want.abs().max()).item()
    check(bool(torch.isfinite(got).all()) and gap <= PREFILL_REL,
          f"[{tag}] {arch}: prefill through the kernel vs the plain version "
          f"{gap} of max|logit| (bound {PREFILL_REL})")
    log(f"[{tag}] {arch}: one wave's prefill through the kernel vs the plain"
        f" version: max|dlogit| {gap:.3e} of max|logit| (bound "
        f"{PREFILL_REL})")
    del pre, got, want, sess
    _release()
    return dict(launches=launches, waves=waves, gap=gap, counts=counts,
                prefill_ms=out["prefill_ms"],
                decode_ms=out["decode_ms_per_token_median"],
                peak_gb=out["peak_mem_gb"])


def train_gemma3(dev) -> dict:
    """gemma3-1b trained through ``examples/train_lm_torch.py`` (the main
    path, counts zeroed just before and read just after): flash launches a
    step exact (forward: every layer once, each super-block's six again
    in its recomputation; backward: every layer once, on the wgmma
    route), ms/step and peak; then the first step's loss and gradients
    through the kernels against the plain attention (phase 9's gate)."""
    import shutil
    import tempfile
    from repro_torch.core.config import CommConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import deterministic
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts
    ex = load_example("train_lm_torch")
    args = ex.parser().parse_args(GEMMA3_TRAIN_ARGV)
    cfg = ex.model_config(args)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_gemma3_"))
    nb, nt = transformer.local_global_counts(cfg)
    r = cfg.local_global_ratio
    run = _train_run(ex, GEMMA3_TRAIN_ARGV, root, flash_counts,
                     GEMMA3_TRAIN_STEPS)
    shutil.rmtree(root, ignore_errors=True)
    c, n = run["counts"], GEMMA3_TRAIN_STEPS
    want_fwd = cfg.n_layers + nb * (r + 1)
    check(c["fwd"] == n * want_fwd and c["bwd"] == c["bwd_wgmma"]
          == n * cfg.n_layers,
          f"[gemma3] training: flash launches {c}, want {n} x {want_fwd} "
          f"forward ({cfg.n_layers} layers and the {nb} super-blocks' "
          f"{nb * (r + 1)} recomputed; the {nt} trailing layers are not) "
          f"and {n} x {cfg.n_layers} backward, all on the wgmma route")
    tokens = args.batch * args.seq
    hist = run["history"]
    log(f"[gemma3] trained {cfg.n_layers} layers ({nb} super-blocks of {r} "
        f"local + 1 global, {nt} trailing), (data=2, model=4), ZeRO-1, "
        f"remat: loss {hist[0]:.4f} -> {hist[-1]:.4f} over {n} steps; "
        f"{run['ms']:.1f} ms/step (median of steps 2-{n}), "
        f"{tokens / run['ms'] * 1e3:.0f} tokens/s; peak "
        f"{run['peak'] / 1e9:.2f} GB; flash launches per step: forward "
        f"{c['fwd'] // n} = {cfg.n_layers} + {nb} x {r + 1} recomputed, "
        f"backward {c['bwd'] // n} (wgmma route {c['bwd_wgmma'] // n})")
    mesh = mesh_mod.make_test_mesh(args.dp, args.tp)
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                 global_batch=args.batch))
    _release()
    sess = setup.build_session(cfg, mesh, CommConfig(), seed=0, device=dev)
    stacked = setup.shard_batch(sess, src.batch_at(0))
    lg = ts.make_loss_and_grad(sess.rt)
    with deterministic():
        loss_k, _, g_k = lg(sess.params, stacked)
        loss_p, _, g_p = plain_attention(lambda: lg(sess.params, stacked))
    gap_loss = (loss_k - loss_p).abs().max().item()
    gap_grad = _leaf_gap(g_k, g_p)
    check(gap_loss < 1e-2 * abs(loss_p[0].item()),
          f"[gemma3] first-step loss through the kernels {loss_k} vs plain "
          f"{loss_p}")
    log(f"[gemma3] first step through the kernels vs the plain attention: "
        f"loss {loss_k[0].item():.6f} vs {loss_p[0].item():.6f} (gap "
        f"{gap_loss:.3e}, bound 1e-2 of it); gradients: largest leaf gap "
        f"{gap_grad:.3e} of its max|grad|")
    del sess, g_k, g_p, lg, stacked
    _release()
    return dict(run, gap_loss=gap_loss, gap_grad=gap_grad)


def phase_dense_family(dev) -> dict:
    """gemma3-1b served at full width and depth and trained; command-r-plus-
    104b and deepseek-coder-33b served at full width and cut depth; the
    three smoke configs on the card against the CPU.  Returns the flash
    launch counts."""
    out = {"gemma3-1b": serve_dense(dev, "gemma3-1b", GEMMA3_SERVE_ARGV)}
    out["gemma3-1b training"] = train_gemma3(dev)
    for arch in ("command-r-plus-104b", "deepseek-coder-33b"):
        out[arch] = serve_dense(dev, arch, WIDE_SERVE_ARGV)
    # gemma3's smoke prompt and decode pass its 16-token window
    phase_serve_smoke(dev, "gemma3-1b", 24, 8)
    phase_serve_smoke(dev, "command-r-plus-104b", 24, 4)
    phase_serve_smoke(dev, "deepseek-coder-33b", 24, 4)
    return out


# ----------------------------------------------------------------------
# The moe family: mixtral-8x22b served, moe_block_a2a at its width
# ----------------------------------------------------------------------

# mixtral-8x22b at full width (bf16, random weights from seed 0, tp 4: 2
# whole experts and 12/2 heads a rank), depth cut to MIXTRAL_LAYERS (56
# layers of ~5.0 GB do not fit one card): one wave of 2 x 6144 tokens, past
# the 4096-token window, then up to 16 decode steps
MIXTRAL_LAYERS = 4
MIXTRAL_SERVE_ARGV = ["--layers", str(MIXTRAL_LAYERS), "--tp", "4",
                      "--batch", "2", "--prompt-len", "6144", "--gen", "16",
                      "--requests", "2", "--comm", "static"]
MIXTRAL_DECODE_STEPS = 16
# moe_block_a2a at mixtral's width: 8 stacked data ranks (one expert a
# rank), 1024 tokens a rank, one layer's expert weights
A2A_RANKS, A2A_TOKENS, A2A_RUNS = 8, 1024, 5


def wave_drops(params, toks, rt, dev) -> tuple[list, list]:
    """The (token, expert) assignments the capacity cut drops in a prefill
    wave of ``toks``, by MoE layer (:func:`moe.dropped` of each MoE block's
    input, the layers run eagerly as the prefill runs them), and each MoE
    layer's largest expert load (tokens routed to one expert)."""
    from repro_torch.models import layers, moe, transformer
    cfg = rt.cfg
    t = torch.as_tensor(toks, device=dev)
    x = layers.embed(params["embed"], t, rt)
    pos = transformer.positions_for(t)
    out, loads = [], []
    with torch.no_grad():
        for p, window in transformer.attention_layers(params, cfg):
            h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + transformer.attend(p["attn"], h, pos, rt, window=window)
            h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
            if "moe" in p:
                out.append(int(moe.dropped(p["moe"], h, cfg)[0]))
                gates, _ = moe._route(p["moe"], h.flatten(1, 2), cfg)
                loads.append(int((gates[0] > 0).sum(0).max()))
                x = x + moe.moe_block(p["moe"], h, rt)[0]
            else:
                x = x + layers.mlp(p["mlp"], h, rt, cfg.mlp_type)
    return out, loads


def captured_against_eager(sess, args, comm, toks, gen: int, tag: str,
                           dev, profile: bool = False) -> dict:
    """One wave of ``toks`` at the serving example's shapes (``args``) on
    ``sess``, captured against eager: ``gen`` decode steps (the warm-up
    that captures, then replays), tokens and logits bitwise equal at every
    step.  Returns the time of a replay of the captured prefill
    (``replay_ms``) and, with ``profile``, the device time by kernel of
    one prefill replay and one decode replay (``profiles``)."""
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec
    from repro_torch.train import serve as serve_mod
    cfg, S, B = sess.cfg, args.prompt_len, args.batch
    runs, res = {}, {}
    for captured in (False, True):
        rt, pre = serve_mod.build_serve_fn(
            cfg, args.tp, comm, isp.ShapeSpec("wave", S, B, "prefill"),
            cache_capacity=S + gen, device=dev, captured=captured)
        _, step = serve_mod.build_serve_fn(
            cfg, args.tp, comm, isp.ShapeSpec("wave", S + gen, B, "decode"),
            device=dev, captured=captured)
        st = pre(sess.params, {"tokens": toks})
        if captured:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = pre(sess.params, {"tokens": toks})
            torch.cuda.synchronize()
            res["replay_ms"] = (time.perf_counter() - t0) * 1e3
        out = []
        for _ in range(gen):
            nxt = dec.greedy_tokens(st, rt)
            st = step(sess.params, nxt, st)
            out.append((nxt.clone(), st.last_logits.clone()))
        runs[captured] = out
        if captured and profile:
            (g,) = step.graphs.values()
            res["profiles"] = {
                "prefill": profile_device_time(f"{tag} prefill replay",
                                               pre.graph.replay),
                "decode": profile_device_time(f"{tag} decode replay",
                                              g.replay)}
        del pre, step, st
        _release()
    for i, ((te, le), (tc, lc)) in enumerate(zip(runs[False], runs[True])):
        check(torch.equal(te, tc), f"[{tag}] decode step {i}: captured "
              f"tokens {tc.tolist()} differ from eager {te.tolist()}")
        check(torch.equal(le, lc), f"[{tag}] decode step {i}: captured "
              f"logits differ from eager")
    return res


def moe_waves(dev, arch: str, argv: list, gen: int, tag: str) -> dict:
    """One wave at the serving example's shapes for ``arch`` (``argv``) on a
    session built as the example builds it, captured against eager
    (:func:`captured_against_eager`); the wave's (token, expert)
    assignments that the capacity cut dropped, counted by
    :func:`wave_drops`."""
    from repro_torch.launch import input_specs as isp, setup
    from repro_torch.models import moe
    from repro_torch.train import serve as serve_mod
    ex = load_example("serve_lm_torch")
    args = ex.parser().parse_args(["--arch", arch] + argv)
    cfg = ex.model_config(args)
    comm = ex.COMMS[args.comm]
    sess = setup.build_session(cfg, args.tp, comm, seed=args.seed,
                               device=dev)
    S, B = args.prompt_len, args.batch
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S))
    rt = serve_mod.serve_runtime(cfg, args.tp, comm,
                                 isp.ShapeSpec("wave", S, B, "prefill"))
    n_drop, loads = wave_drops(sess.params, toks, rt, dev)
    replay_ms = captured_against_eager(sess, args, comm, toks, gen, tag,
                                       dev)["replay_ms"]
    del sess
    _release()
    T = B * S
    log(f"[{tag}] {cfg.name}: {gen} captured decode steps (one graph, "
        f"{gen - 1} replays) bitwise equal to eager, tokens and logits; the "
        f"wave's {T} tokens x top-{cfg.n_experts_per_tok} = "
        f"{T * cfg.n_experts_per_tok} assignments a layer at capacity "
        f"{moe.capacity(cfg, T)} an expert (a mean load of "
        f"{T * cfg.n_experts_per_tok / cfg.n_experts:g}; the largest load "
        f"by MoE layer {loads}): dropped {n_drop} by MoE layer "
        f"({sum(n_drop)} in all); a replay of the captured prefill "
        f"{replay_ms:.1f} ms")
    return dict(dropped=n_drop, max_load=loads, decode_steps=gen,
                prefill_replay_ms=replay_ms)


def phase_moe_a2a(dev) -> dict:
    """``moe_block_a2a`` at mixtral's width (bf16): A2A_RANKS stacked data
    ranks, A2A_TOKENS tokens a rank, one layer's expert weights (seed 0,
    replicated: each rank applies its tree's first expert, as the JAX
    package's block does); fused/buffered against overlapped/streaming
    under ordered and unordered transport (window 2, 512 B chunks):
    outputs and aux bitwise equal; each schedule timed with CUDA events."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import (CommConfig, CommMode, Scheduling,
                                         Transport)
    from repro_torch.models import moe
    from repro_torch.models.common import MeshContext, Runtime
    cfg = get_config("mixtral-8x22b")
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = moe.init_moe(gen, cfg, cfg.dtype, dev, 1)
    params = {k: v.unsqueeze(0).expand(A2A_RANKS, *v.shape)
              for k, v in layer.items()}
    x = torch.randn((A2A_RANKS, A2A_TOKENS, cfg.d_model), generator=gen,
                    device=dev).to(cfg.dtype)
    scheds = {"fused/buffered": CommConfig(mode=CommMode.BUFFERED,
                                           scheduling=Scheduling.FUSED)}
    for t in (Transport.ORDERED, Transport.UNORDERED):
        scheds[f"overlapped/streaming/{t.value}"] = CommConfig(
            mode=CommMode.STREAMING, scheduling=Scheduling.OVERLAPPED,
            transport=t, window=2, chunk_bytes=512)
    outs, ms = {}, {}
    for label, comm in scheds.items():
        rt = Runtime(cfg=cfg, mesh=MeshContext.stacked(1, A2A_RANKS),
                     comm=comm)
        with torch.no_grad():
            outs[label] = moe.moe_block_a2a(params, x, rt)
            times = []
            for _ in range(A2A_RUNS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                moe.moe_block_a2a(params, x, rt)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
        ms[label] = statistics.median(times)
    y, aux = outs["fused/buffered"]
    check(bool(torch.isfinite(y).all()), "[moe-a2a] non-finite output")
    for label, (y2, aux2) in outs.items():
        check(torch.equal(y2, y) and torch.equal(aux2, aux),
              f"[moe-a2a] {label} differs from fused/buffered")
    cap = max(8, int(cfg.capacity_factor * A2A_TOKENS
                     * cfg.n_experts_per_tok / cfg.n_experts))
    log(f"[moe-a2a] moe_block_a2a at mixtral's width: {A2A_RANKS} stacked "
        f"data ranks x {A2A_TOKENS} tokens, one expert a rank, capacity "
        f"{cap}; every schedule bitwise equal to fused/buffered (outputs "
        f"and aux); ms a call (median of {A2A_RUNS}, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    del params, layer, x, outs, y
    _release()
    return ms


def phase_moe_family(dev) -> dict:
    """mixtral-8x22b served at full width and cut depth, with one wave
    captured against eager; ``moe_block_a2a`` at its width; the smoke
    config and a shared-expert, dense-head variant (f32) on the card
    against the CPU.  Returns mixtral's serving reading."""
    out = serve_dense(dev, "mixtral-8x22b", MIXTRAL_SERVE_ARGV)
    out.update(moe_waves(dev, "mixtral-8x22b", MIXTRAL_SERVE_ARGV,
                         MIXTRAL_DECODE_STEPS, "moe"))
    check(out["launches"] == MIXTRAL_LAYERS,
          f"[moe] flash launches {out['launches']}, want {MIXTRAL_LAYERS}")
    log(f"[moe] mixtral-8x22b served: prefill {out['prefill_ms'][0]:.1f} ms "
        f"(the first wave, with its capture; a replay "
        f"{out['prefill_replay_ms']:.1f} ms), decode "
        f"{out['decode_ms']:.2f} ms/step, peak {out['peak_gb']:.2f} GB, "
        f"flash launches {out['launches']}")
    out["a2a_ms"] = phase_moe_a2a(dev)
    # the smoke config at its own capacity (tokens drop), and with room for
    # every token, where decode must equal the prefill of the extended
    # sequence; then the shared expert and a dense head layer
    phase_serve_smoke(dev, "mixtral-8x22b", 24, 16)
    phase_serve_smoke(dev, "mixtral-8x22b", 24, 16, capacity_factor=2.0)
    phase_serve_smoke(dev, "mixtral-8x22b", 24, 16, capacity_factor=2.0,
                      n_shared_experts=1, n_dense_layers=1)
    return out


# ----------------------------------------------------------------------
# Multi-head Latent Attention: deepseek-v3-671b served
# ----------------------------------------------------------------------

# deepseek-v3-671b at full width (bf16, random weights from seed 0, tp 4:
# 32 heads and 64 whole experts a rank), depth cut to DEEPSEEK_LAYERS (61
# layers, ~1.34 TB of bf16 weights, do not fit one card; 4 keep the
# config's 3 dense head layers and one MoE layer, ~28 GB): one wave of 4 x
# 1024 tokens, then DEEPSEEK_DECODE_STEPS decode steps
DEEPSEEK_LAYERS = 4
DEEPSEEK_SERVE_ARGV = ["--layers", str(DEEPSEEK_LAYERS), "--tp", "4",
                       "--batch", "4", "--prompt-len", "1024", "--gen", "16",
                       "--requests", "4", "--comm", "static"]
DEEPSEEK_DECODE_STEPS = 16
# the smoke config's one training step on the card against the CPU: the
# loss within MLA_STEP_LOSS_TOL, the gradients within TRAIN_GRAD_TOL of each
# leaf's max|grad|
MLA_STEP_LOSS_TOL = 1e-5


def train_step_vs_cpu(dev, arch: str, grad_tol: float = TRAIN_GRAD_TOL
                      ) -> dict:
    """``arch``'s smoke config (f32) on a ``(2, 2)`` stack: one training
    step's loss and gradients (every rank's) on the card against the CPU
    from the same weights and batch (the loss within MLA_STEP_LOSS_TOL, the
    gradients within ``grad_tol`` of each leaf's max|grad|); the card's
    step runs the flash forward and backward kernels, and the SSD scan's
    in the hybrid family (counts zeroed just before it and read just after:
    one of each a layer of its kind, the flash backward on the fp32-FMA
    route, v padded as q)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.config import CommConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import mesh as mesh_mod, setup
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    scfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    if scfg.use_mla:
        d, dv = scfg.qk_nope_dim + scfg.qk_rope_dim, scfg.v_head_dim
    else:
        d = dv = scfg.resolved_head_dim
    hybrid = scfg.family == "hybrid"
    n_attn = (transformer.hybrid_counts(scfg)[0] if hybrid
              else scfg.n_layers)
    n_ssd = scfg.n_layers if hybrid else 0
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, scfg.vocab_size, (4, 32)),
             "labels": rng.randint(0, scfg.vocab_size, (4, 32))}
    runs, full, counts = {}, None, None
    for where in ("cpu", dev):
        s = setup.build_session(scfg, mesh_mod.make_test_mesh(2, 2),
                                CommConfig(), oc=adamw.OptConfig(zero1=False),
                                device=where)
        full = setup.global_params(s) if full is None else full
        s.params = setup.stacked_params(s, full)
        lg = ts.make_loss_and_grad(s.rt)
        stacked = setup.shard_batch(s, batch)
        if where == "cpu":
            runs["cpu"] = lg(s.params, stacked)
            continue
        flash_counts(reset=True)
        ssd.launches = ssd.bwd_launches = 0
        runs["card"] = lg(s.params, stacked)
        counts = dict(flash_counts(), ssd_fwd=ssd.launches,
                      ssd_bwd=ssd.bwd_launches)
    (loss_c, _, g_c), (loss_k, _, g_k) = runs["cpu"], runs["card"]
    gap_l = (loss_k.cpu() - loss_c).abs().max().item()
    gap_g = _leaf_gap(g_k, g_c)
    check(counts["fwd"] == counts["bwd"] == counts["bwd_fma"] == n_attn
          and counts["ssd_fwd"] == counts["ssd_bwd"] == n_ssd,
          f"{arch} smoke training step on the card: launches {counts}, "
          f"want {n_attn} flash forward and backward (on the fp32-FMA "
          f"route) and {n_ssd} SSD scans both ways")
    check(gap_l < MLA_STEP_LOSS_TOL and gap_g < grad_tol,
          f"{arch} smoke training step on the card vs the CPU: loss {gap_l} "
          f"(tol {MLA_STEP_LOSS_TOL}), gradients {gap_g} of max|grad| (tol "
          f"{grad_tol})")
    log(f"[train] {arch} smoke config (f32, (2, 2)) one step on the card vs "
        f"the CPU: loss {gap_l:.3e} (tol {MLA_STEP_LOSS_TOL}), gradients "
        f"{gap_g:.3e} of each leaf's max|grad| (tol {grad_tol}); flash "
        f"launches forward {counts['fwd']}, backward {counts['bwd']} (fp32 "
        f"FMA, d {d} and d_v {dv} padded to "
        f"{fa.bwd_route(scfg.dtype, max(d, dv))[1]})"
        + (f"; SSD scan launches forward {counts['ssd_fwd']}, backward "
           f"{counts['ssd_bwd']}" if n_ssd else ""))
    return dict(loss_gap=gap_l, grad_gap=gap_g, counts=counts)


def phase_mla(dev) -> dict:
    """deepseek-v3-671b served at full width and cut depth through
    ``examples/serve_lm_torch.py`` (flash launches exact: one a layer a
    wave; the prefill through the kernel against the plain attention), one
    wave captured against eager; the smoke config (f32) on the card against
    the CPU, at its own capacity and with room for every token (decode
    against the prefill of the extended sequence), and one training step
    at ``(2, 2)``.  Returns deepseek-v3's serving reading."""
    out = serve_dense(dev, "deepseek-v3-671b", DEEPSEEK_SERVE_ARGV)
    out.update(moe_waves(dev, "deepseek-v3-671b", DEEPSEEK_SERVE_ARGV,
                         DEEPSEEK_DECODE_STEPS, "mla"))
    check(out["launches"] == DEEPSEEK_LAYERS
          == out["counts"]["fwd_wgmma192"],
          f"[mla] flash launches {out['launches']}, on the d_qk 192 / d_v 128 "
          f"route {out['counts']['fwd_wgmma192']}, want {DEEPSEEK_LAYERS} "
          f"each")
    log(f"[mla] deepseek-v3-671b served: prefill {out['prefill_ms'][0]:.1f} "
        f"ms (the wave, with its capture; a replay "
        f"{out['prefill_replay_ms']:.1f} ms), decode {out['decode_ms']:.2f} "
        f"ms/step, peak {out['peak_gb']:.2f} GB, flash launches "
        f"{out['launches']} (on the d_qk 192 / d_v 128 route "
        f"{out['counts']['fwd_wgmma192']}), dropped by the capacity cut "
        f"{out['dropped']}")
    # at its own capacity (tokens drop), and with room for every token (E /
    # k = 4), where decode must equal the prefill of the extended sequence
    phase_serve_smoke(dev, "deepseek-v3-671b", 24, 16)
    phase_serve_smoke(dev, "deepseek-v3-671b", 24, 16, capacity_factor=4.0)
    out["training_step"] = train_step_vs_cpu(dev, "deepseek-v3-671b")
    return out


# ----------------------------------------------------------------------
# The hybrid family: zamba2-7b served at full width and depth
# ----------------------------------------------------------------------

# zamba2-7b at full width and depth (bf16, random weights from seed 0, tp
# 4: 28 SSD heads and 8/8 attention heads a rank; 6.66 B parameters, 13.3
# GB, fit one card whole): one wave of 4 x 1024 tokens (8 SSD chunks of
# 128), then up to 16 decode steps
ZAMBA2_SERVE_ARGV = ["--arch", "zamba2-7b", "--tp", "4", "--batch", "4",
                     "--prompt-len", "1024", "--gen", "16", "--requests",
                     "4", "--comm", "static"]
ZAMBA2_DECODE_STEPS = 16
# kernel vs plain logits of one full-width bf16 wave at every position, as
# a share of max|logit|, through the served weights' first Mamba2 layers
# and then the shared block (a cut of HYBRID_GATE_DEPTH layers, its one
# group): the gate; the deeper cuts of HYBRID_DEPTHS are printed beside it.
# The random-weight model is chaotic with depth: on an H100 the kernels
# read 3.7e-3, 0.13, 0.63 and 0.87 through 1, 2, 3 and 6 layers, and a
# 1e-7 noise on the plain scan's y moves the same logits by 3.8e-3, 0.13,
# 0.29 and 0.84; the planted faults move the one-layer cut by 0.61 to 1.75
HYBRID_GATE_REL = 5e-2
HYBRID_GATE_DEPTH = 1
HYBRID_DEPTHS = (1, 2, 3, 6)
# the smoke config's training step on the card against the CPU: the
# gradients within tests/test_torch_hybrid.py's bound (the random-weight
# smoke model's f32 gradients move by up to 5.5e-2 of a leaf's max under
# one ulp of noise, examples/hybrid_noise_probe_torch.py)
HYBRID_STEP_GRAD_TOL = 1e-1
# the smoke config served (f32) on the card against the CPU: logits within
# tests/test_torch_hybrid.py's serving bound (its port against the JAX
# package reads 2.3e-4 of max, the JAX package's own tp 1 against tp 4
# 1.8e-4; SMOKE_REL, 1e-4, holds the better-conditioned families)
HYBRID_SMOKE_REL = 1e-3


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def hybrid_gate(sess, args, comm, dev) -> dict:
    """One wave's logits through both kernels against their plain versions
    (the SSD scan's and the flash kernel's) on the served weights, at every
    position through a cut of the model: the first ``j`` Mamba2 layers,
    then the shared block (one group of ``j``), for each ``j`` of
    HYBRID_DEPTHS; the cut of HYBRID_GATE_DEPTH layers gated at
    HYBRID_GATE_REL of max|logit|, with faults planted in either plain
    version (the SSD scan's inter-chunk term dropped or its decay mask
    strict; attention's causal mask off by one), each of which must break
    the gate; beside each cut, how far a rounding-sized perturbation of
    the plain scan's y moves the same logits; the full-depth prefill's last
    position printed beside it."""
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import transformer
    from repro_torch.train import serve as serve_mod
    probe = load_example("ssm_fault_probe_torch")
    cfg, S, B = sess.cfg, args.prompt_len, args.batch
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S))
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    shape = isp.ShapeSpec("wave", S, B, "prefill")

    def plain(fn, scan=None, attn=None):
        return plain_attention(lambda: probe.through(fn, scan), attn)

    def rel(x, want):
        return ((x - want).abs().max() / want.abs().max()).item()

    def cut(j):
        """The served weights' first ``j`` Mamba2 layers as one group, the
        shared block after them: every position's logits."""
        c = dataclasses.replace(cfg, n_layers=j, hybrid_attn_every=j)
        params = {k: v for k, v in sess.params.items() if k != "trailing"}
        params["groups"] = _tree_map(lambda t: t[:1, :j],
                                     sess.params["groups"])
        rt = serve_mod.serve_runtime(c, args.tp, comm, shape)
        return lambda: transformer.forward(params, batch, rt).logits
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    noise_gen = torch.Generator(device=dev).manual_seed(0)

    def noisy_scan(*inp):
        """The plain scan with y times 1 + 1e-7 N(0, 1): a rounding's
        worth of difference, the size of two summation orders'."""
        y, h = ssd_ref.ssd_chunked_ref(*inp)
        return y * (1 + 1e-7 * torch.randn(y.shape, generator=noise_gen,
                                           device=y.device)), h
    gaps, noise, faults, finite = {}, {}, {}, True
    with torch.no_grad():
        for j in HYBRID_DEPTHS:
            every = cut(j)
            got, want = every(), plain(every)
            gaps[j] = rel(got, want)
            noise[j] = rel(plain(every, scan=noisy_scan), want)
            finite &= bool(torch.isfinite(got).all())
            del got
            if j == HYBRID_GATE_DEPTH:
                faults = {f"SSD scan: {label}":
                          rel(plain(every, scan=fault), want)
                          for label, fault in probe.FAULTS.items()}
                faults["attention: causal mask off by one"] = rel(
                    plain(every, attn=causal_off_by_one), want)
            del want
        _, pre = serve_mod.build_serve_fn(
            cfg, args.tp, comm, shape, cache_capacity=S + args.gen,
            device=dev, captured=False)
        last = lambda: pre(sess.params, batch).last_logits
        got = last().clone()
        full_gap = rel(got, plain(last))
        finite &= bool(torch.isfinite(got).all())
        del got, pre
    _release()
    gap = gaps[HYBRID_GATE_DEPTH]
    log(f"[hybrid] one wave through both kernels vs their plain versions, "
        f"max|dlogit| as a share of max|logit| over every position through "
        f"the first j Mamba2 layers and the shared block: "
        + ", ".join(f"j={j} {g:.3e}" for j, g in gaps.items())
        + f" (j={HYBRID_GATE_DEPTH} gated, bound {HYBRID_GATE_REL}); the "
        f"plain versions with y of every scan times 1 + 1e-7 N(0, 1) against "
        f"them: " + ", ".join(f"j={j} {g:.3e}" for j, g in noise.items())
        + f"; planted "
        f"in the plain versions at j={HYBRID_GATE_DEPTH}: "
        + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
        + f"; {full_gap:.3e} at the prefill's last position through all "
        f"{cfg.n_layers} layers and {transformer.hybrid_counts(cfg)[0]} "
        f"shared-block runs (not gated: the random-weight model amplifies "
        f"rounding with depth)")
    check(finite, "[hybrid] non-finite prefill logits")
    check(gap <= HYBRID_GATE_REL,
          f"[hybrid] every position through {HYBRID_GATE_DEPTH} Mamba2 "
          f"layer(s) and the shared block, kernels vs plain: {gap} of "
          f"max|logit| (bound {HYBRID_GATE_REL})")
    for label, moved in faults.items():
        check(moved > HYBRID_GATE_REL, f"[hybrid] the logits gate misses "
              f"the planted fault '{label}': {moved} of max|logit|")
    return dict(gap=gap, depth_gaps=gaps, noise_gaps=noise, faults=faults,
                full_depth_gap=full_gap)


def serve_hybrid(dev) -> dict:
    """zamba2-7b served at full width and depth through
    ``examples/serve_lm_torch.py``, captured (the main path: the kernels'
    counts zeroed just before it and read just after: one SSD scan a
    Mamba2 layer and one flash forward a shared-block run a wave, every
    flash launch on the d 128 wgmma route); one wave captured against
    eager; the kernel-vs-plain gate (:func:`hybrid_gate`)."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import setup
    from repro_torch.models import transformer
    ex = load_example("serve_lm_torch")
    args = ex.parser().parse_args(ZAMBA2_SERVE_ARGV)
    cfg = ex.model_config(args)
    comm = ex.COMMS[args.comm]
    ng, nt = transformer.hybrid_counts(cfg)
    _release()
    t0 = time.perf_counter()
    sess = setup.build_session(cfg, args.tp, comm, seed=args.seed,
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stored = sum(t.numel() * t.element_size() for t in _leaves(sess.params))
    log(f"[hybrid] {cfg.name}: full width and depth ({cfg.n_layers} Mamba2 "
        f"layers of d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, in {ng} groups of "
        f"{cfg.hybrid_attn_every} and {nt} trailing; one shared attention "
        f"block, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim} and d_ff {cfg.d_ff}, after every group; "
        f"vocab {cfg.vocab_size}): {cfg.param_count():,} parameters, "
        f"{stored / 1e9:.2f} GB of stacked bf16 weights (tp {args.tp}) "
        f"from seed {args.seed} initialised on the card in {init_s:.1f} s")
    flash_counts(reset=True)
    ssd.launches = 0
    out = ex.run(args, log=lambda *_: None, sess=sess)
    counts = dict(flash_counts(), ssd=ssd.launches)
    waves = len(out["prefill_ms"])
    check(counts["ssd"] == out["ssd_launches"] == cfg.n_layers * waves,
          f"[hybrid] SSD scan launches {counts['ssd']}, want {cfg.n_layers} "
          f"x {waves} waves")
    check(counts["fwd"] == out["flash_launches"] == counts["fwd_wgmma"]
          == ng * waves, f"[hybrid] flash launches {counts}, want {ng} x "
          f"{waves} waves, all on the wgmma route")
    check(out["all_logits_finite"], "[hybrid] non-finite logits")
    log(f"[hybrid] {cfg.name} served captured: {out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']:.2f} s; prefill "
        f"ms per wave {[round(m, 2) for m in out['prefill_ms']]} (with the "
        f"wave's capture); median decode "
        f"{out['decode_ms_per_token_median']:.2f} ms/step over "
        f"{out['decode_steps']} steps; peak {out['peak_mem_gb']:.2f} GB; "
        f"launches: SSD scan {counts['ssd']} = {cfg.n_layers} x {waves} "
        f"wave(s), flash {counts['fwd']} = {ng} x {waves} (d 128 wgmma "
        f"route {counts['fwd_wgmma']})")
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size,
                                            (args.batch, args.prompt_len))
    waves_out = captured_against_eager(sess, args, comm, toks,
                                       ZAMBA2_DECODE_STEPS, "hybrid", dev,
                                       profile=True)
    replay_ms, prof = waves_out["replay_ms"], waves_out["profiles"]
    log(f"[hybrid] {ZAMBA2_DECODE_STEPS} captured decode steps (one graph, "
        f"{ZAMBA2_DECODE_STEPS - 1} replays) bitwise equal to eager, tokens "
        f"and logits; a replay of the captured prefill {replay_ms:.1f} ms "
        f"(device busy {prof['prefill']['busy_ms']:.1f} ms of it profiled), "
        f"a decode replay's device busy {prof['decode']['busy_ms']:.2f} ms "
        f"of {out['decode_ms_per_token_median']:.2f} ms/step")
    gate = hybrid_gate(sess, args, comm, dev)
    del sess
    _release()
    return dict(ssd=counts["ssd"], flash=counts["fwd"],
                flash_wgmma=counts["fwd_wgmma"], waves=waves,
                prefill_ms=out["prefill_ms"], prefill_replay_ms=replay_ms,
                prefill_busy_ms=prof["prefill"]["busy_ms"],
                decode_busy_ms=prof["decode"]["busy_ms"],
                decode_ms=out["decode_ms_per_token_median"],
                peak_gb=out["peak_mem_gb"], **gate)


def phase_hybrid(dev) -> dict:
    """zamba2-7b served at full width and depth (:func:`serve_hybrid`); the
    smoke config (f32) on the card against the CPU (decode against the
    prefill of the extended sequence), and one training step at ``(2,
    2)``.  Returns zamba2's serving reading."""
    out = serve_hybrid(dev)
    phase_serve_smoke(dev, "zamba2-7b", 32, 16, rel=HYBRID_SMOKE_REL)
    out["training_step"] = train_step_vs_cpu(dev, "zamba2-7b",
                                             HYBRID_STEP_GRAD_TOL)
    return out


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

    def lap(phase: str) -> None:
        log(f"[time] phase {phase} ends at "
            f"{time.perf_counter() - t_start:.1f} s")

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
               "flash_attention_bwd": flash_ops.BWD_LIBRARY,
               "ssd_scan": ssd_ops.LIBRARY,
               "ssd_scan_bwd": ssd_ops.BWD_LIBRARY})
    log(f"[build] the six libraries built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    bw = card_bandwidth(name)
    swe_ptxas = ptxas_summary(swe_ops.LIBRARY.log)
    log(f"[build] swe_step registers and spills: {swe_ptxas}")
    # the forward's wgmma kernel at d 64 and 128, its d 256 form and its
    # d_qk 192 / d_v 128 form; the backward's dQ and dK/dV kernels at each
    check_wgmma_build("flash forward", flash_ops.LIBRARY, 4)
    check_wgmma_build("flash backward", flash_ops.BWD_LIBRARY, 8)
    # all eight of the SSD backward's kernels: the f32 route's U, grads
    # and ddt, the bf16 route's, and the shared hand-off and dA
    ssd_bwd_ptxas = check_wgmma_build(
        "SSD backward", ssd_ops.BWD_LIBRARY, 8, pick="",
        require=("HGMMA", "LDSM"), forbid=("ATOM", " RED"))

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
    flash_bwd_timing = phase_flash_bwd_kernel(dev, flush, bw)
    ssd_bwd_timing = phase_ssd_bwd_kernel(dev, flush, bw)
    _release()
    lap("2")

    # -- 3. main path at full size -------------------------------------
    # (label, config, swe_step launches of the eager warm-up step that
    # builds a segment's graph, launches per step): the counter counts the
    # graph's replays, every step's launches
    modes = (("fused", CommConfig(), 1, 1),
             ("overlapped", OVERLAPPED_CONFIG, 2, 2),
             ("host", BASELINE_CONFIG, 0, 1))
    m0 = mass(sim, sim.state)
    finals, launches_by_mode, step_us = {}, {}, {}
    swe_ops.launches = 0
    for label, cfg, warm_launches, per_step_launches in modes:
        want_launches = warm_launches + per_step_launches * STEPS
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
    per_step = {label: (launches_by_mode[label] - warm) / STEPS
                for label, _, warm, _ in modes}
    log(f"[main] swe_step launches per step: {per_step}")
    for label in ("overlapped", "host"):
        check(torch.equal(finals[label], finals["fused"]),
              f"{label} final state differs from fused")
    log(f"[main] fused, overlapped and host final states bitwise equal; "
        f"swe_step launched {main_launches} times (each replay of a "
        f"{N_INNER}-step graph counts its {N_INNER} or {2 * N_INNER} "
        f"launches; one eager warm-up step before each capture)")
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

    lap("3")

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

    lap("4")

    # -- 5. the int8 wire: gradient sync, sweep, autotuned SWE ----------
    quant_launches = phase_grad_sync(dev)
    db_path = Path(__file__).resolve().parent / ".repro_tune" / \
        "chip_smoke_tunedb.json"
    phase_sweep(dev, db_path)
    phase_auto(driver, sim, db_path, dev)
    lap("5")

    # -- 6. the reliable wire and the elastic runtime ---------------------
    phase_reliable_wire(driver, sim, finals["fused"])
    reliable_quant = phase_reliable_checks(dev)
    elastic_launches = phase_elastic(driver, sim, db_path, dev)
    phase_lossy_sweep(dev)
    lap("6")

    # -- 7. the LM serving path ------------------------------------------
    flash_launches = phase_serve(dev)
    phase_serve_smoke(dev, "qwen3-8b", 24, 4)
    lap("7")

    # -- 8. the SSM serving path -----------------------------------------
    ssd_launches = phase_serve_ssm(dev)
    phase_serve_smoke(dev, "mamba2-130m", 16, 16)
    lap("8")

    # -- 9. training ---------------------------------------------------
    train = phase_train(dev, db_path)
    train_counts = train["same"]["counts"]
    train_ssm = phase_train_ssm(dev)
    ssm_counts = train_ssm["counts"]
    lap("9")

    # -- 10. the plan store and the pod axis ------------------------------
    pods = phase_plans_and_pods(dev)
    pod_counts = pods["counts"]
    lap("10")

    # -- 11. FSDP, Megatron-SP and remat "dots" ---------------------------
    fsdp = phase_fsdp(dev, train, train_ssm)
    fsdp_counts = {k: r["counts"] for k, r in fsdp["runs"].items()}
    fsdp_ssm_counts = fsdp["ssm"]["counts"]
    lap("11")

    # -- 12. the rest of the dense family ---------------------------------
    dense = phase_dense_family(dev)
    gemma3_train = dense.pop("gemma3-1b training")["counts"]
    lap("12")

    # -- 13. the moe family -------------------------------------------
    mixtral = phase_moe_family(dev)
    lap("13")

    # -- 14. Multi-head Latent Attention ----------------------------------
    deepseek = phase_mla(dev)
    lap("14")

    # -- 15. the hybrid family --------------------------------------------
    zamba2 = phase_hybrid(dev)
    zamba2_train = zamba2["training_step"]["counts"]
    lap("15")

    # -- 16. summary ---------------------------------------------------
    log(f"kernels: swe_step launches={main_launches} "
        + " ".join(f"{k}={v}" for k, v in launches_by_mode.items())
        + f"; swe_step launches={elastic_launches} (elastic runs)"
        + " ".join(f"; {k} launches={v} (gradient sync), "
                   f"{reliable_quant[k]} (reliable int8 sendrecv)"
                   for k, v in quant_launches.items())
        + f"; flash_attention launches={flash_launches} (serving)"
        + f"; ssd_scan launches={ssd_launches} (serving)"
        + f"; flash_attention launches={train_counts['fwd']} (training), "
        f"flash_attention_bwd launches={train_counts['bwd']} (training, "
        f"{train_counts['bwd_wgmma']} on the wgmma route)"
        + "".join(f"; {k} launches={train['int8']['counts'][k]} (training, "
                  f"int8 gradient wire)" for k in ("quantize", "dequantize"))
        + f"; ssd_scan launches={ssm_counts['fwd']} (mamba2 training), "
        f"ssd_scan_bwd launches={ssm_counts['bwd']} (mamba2 training)"
        + f"; ssd_scan launches={pod_counts['fwd']} (pod-mesh training), "
        f"ssd_scan_bwd launches={pod_counts['bwd']} (pod-mesh training)"
        + "".join(f"; flash_attention launches={c['fwd']} ({k} training), "
                  f"flash_attention_bwd launches={c['bwd']} ({k} training, "
                  f"{c['bwd_wgmma']} on the wgmma route)"
                  for k, c in fsdp_counts.items())
        + f"; ssd_scan launches={fsdp_ssm_counts['fwd']} (FSDP mamba2 "
        f"training), ssd_scan_bwd launches={fsdp_ssm_counts['bwd']} (FSDP "
        f"mamba2 training)"
        + "".join(f"; flash_attention launches={d['launches']} ({k} "
                  f"serving)" for k, d in dense.items())
        + f"; flash_attention launches={gemma3_train['fwd']} (gemma3-1b "
        f"training), flash_attention_bwd launches={gemma3_train['bwd']} "
        f"(gemma3-1b training, {gemma3_train['bwd_wgmma']} on the wgmma "
        f"route)"
        + f"; flash_attention launches={mixtral['launches']} (mixtral-8x22b "
        f"serving)"
        + f"; flash_attention launches={deepseek['launches']} "
        f"(deepseek-v3-671b serving)"
        + f"; flash_attention launches="
        f"{deepseek['training_step']['counts']['fwd']}, flash_attention_bwd "
        f"launches={deepseek['training_step']['counts']['bwd']} "
        f"(deepseek-v3 smoke training step, fp32-FMA route)"
        + f"; ssd_scan launches={zamba2['ssd']}, flash_attention launches="
        f"{zamba2['flash']} ({zamba2['flash_wgmma']} on the wgmma route; "
        f"zamba2-7b serving)"
        + f"; ssd_scan launches={zamba2_train['ssd_fwd']}, ssd_scan_bwd "
        f"launches={zamba2_train['ssd_bwd']}, flash_attention launches="
        f"{zamba2_train['fwd']}, flash_attention_bwd launches="
        f"{zamba2_train['bwd']} (zamba2 smoke training step)")
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
        "launches": flash_launches,
        "training_launches": train_counts["fwd"],
        "fsdp_training_launches": {k: c["fwd"]
                                   for k, c in fsdp_counts.items()},
        "dense_family_serving_launches": {k: d["launches"]
                                          for k, d in dense.items()},
        "gemma3_training_launches": gemma3_train["fwd"],
        "moe_serving_launches": {"mixtral-8x22b": mixtral["launches"],
                                 "deepseek-v3-671b": deepseek["launches"]},
        "mla_serving_wgmma192_launches": deepseek["counts"]["fwd_wgmma192"],
        "mla_smoke_training_launches":
            deepseek["training_step"]["counts"]["fwd"],
        "hybrid_serving_launches": zamba2["flash"],
        "hybrid_serving_wgmma_launches": zamba2["flash_wgmma"],
        "hybrid_smoke_training_launches": zamba2_train["fwd"],
        "routes": {"bf16, d 64 and 128": "wgmma + TMA "
                   "(flash_attention_wgmma_kernel)",
                   "bf16, d 256": "wgmma + TMA, a producer warpgroup "
                   "(flash_attention_wgmma256_kernel)",
                   "bf16, d_qk 192 and d_v 128": "wgmma + TMA, a producer "
                   "warpgroup, read in place "
                   "(flash_attention_wgmma192_kernel)",
                   "f32": "fp32 FMA (flash_attention_kernel)"},
        **flash_timing})
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:74",
        "launches": ssd_launches, "training_launches": ssm_counts["fwd"],
        "pod_training_launches": pod_counts["fwd"],
        "fsdp_training_launches": fsdp_ssm_counts["fwd"],
        "hybrid_serving_launches": zamba2["ssd"],
        "hybrid_smoke_training_launches": zamba2_train["ssd_fwd"],
        **ssd_timing})
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:78"
                    " (its gradient; the JAX package differentiates its jnp "
                    "reference, having no backward kernel)",
        "launches": train_counts["bwd"],
        "wgmma_launches": train_counts["bwd_wgmma"],
        "fsdp_training_launches": {k: c["bwd"]
                                   for k, c in fsdp_counts.items()},
        "gemma3_training_launches": gemma3_train["bwd"],
        "gemma3_wgmma_launches": gemma3_train["bwd_wgmma"],
        "mla_smoke_training_launches":
            deepseek["training_step"]["counts"]["bwd"],
        "hybrid_smoke_training_launches": zamba2_train["bwd"],
        "routes": {"bf16, d 64 and 128": "wgmma + TMA (flash_bwd_stats, "
                   "flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma)",
                   "bf16, d 256": "wgmma + TMA (flash_bwd_stats, "
                   "flash_bwd_dq_wgmma256, flash_bwd_dkdv_wgmma256)",
                   "bf16, d_qk 192 and d_v 128": "wgmma + TMA, read in place "
                   "(flash_bwd_stats at 128, flash_bwd_dq_wgmma192, "
                   "flash_bwd_dkdv_wgmma192)",
                   "f32": "fp32 FMA (flash_bwd_delta, flash_bwd_dq, "
                   "flash_bwd_dkdv)"},
        **flash_bwd_timing})
    rows.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:74 (its "
                    "gradient; the JAX package differentiates its jnp "
                    "reference, src/repro/models/ssm.py:72, having no "
                    "backward kernel)",
        "launches": ssm_counts["bwd"],
        "pod_training_launches": pod_counts["bwd"],
        "fsdp_training_launches": fsdp_ssm_counts["bwd"],
        "hybrid_smoke_training_launches": zamba2_train["ssd_bwd"],
        "ptxas": ssd_bwd_ptxas,
        **ssd_bwd_timing})
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
