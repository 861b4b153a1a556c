"""Continuous-batching LM serving on the PyTorch port: waves of requests
arriving mid-flight, greedy decode on the sequence-sharded KV cache (dense
and moe families), the fixed-size SSM state (ssm family) or both (hybrid
family), all tensor-parallel ranks stacked on one CUDA card.

Requests arrive on a seeded schedule while earlier waves are still
decoding.  Waiting requests are admitted in fixed-shape waves; each wave
is prefilled at the prompt length into KV caches that cover prompt +
generation (or into the SSM state), and active waves then decode
round-robin, one token per step, retiring as their (per-request, variable)
generation targets complete.  Prefill attention runs the hand-written CUDA
flash-attention kernel, and the ssm and hybrid families' prefill the
hand-written CUDA SSD chunked-scan kernel; the row-parallel combines, the
vocab-sharded embedding and sampling, the K/V all-gather and the decode
LSE combine run through ACCL-X collectives under ``--comm``.

On the card every prefill wave and every decode step is a captured CUDA
graph (``--eager`` runs the same steps eagerly).  Each of the
``--max-active`` wave slots owns one static decode state, and so one
decode graph; a wave's prefill is handed to its slot by a device copy.
The greedy token of each step is read on the host, outside the graphs.

``--comm auto`` resolves one CommConfig per phase from the TuneDB
(``--tune-db``, ranked by ``--objective``): prefill and decode are
distinct consumers of the sweep, so they may pick different configs.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py            # card
      PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-130m \
          --prompt-len 2048 --batch 8
      PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma3-1b \
          --prompt-len 1024                # 5:1 local/global, window 512
      PYTHONPATH=src python examples/serve_lm_torch.py \
          --arch command-r-plus-104b --layers 4 --prompt-len 1024
      PYTHONPATH=src python examples/serve_lm_torch.py \
          --arch mixtral-8x22b --layers 4 --tp 4 --batch 2 \
          --prompt-len 6144 --gen 16 --requests 2   # 8 experts, top-2
      PYTHONPATH=src python examples/serve_lm_torch.py \
          --arch deepseek-v3-671b --layers 4 --tp 4 --batch 4 \
          --prompt-len 1024 --gen 16 --requests 4   # MLA, 256 experts
      PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-7b \
          --tp 4 --batch 4 --prompt-len 1024 --gen 16 --requests 4
                                  # 81 Mamba2 layers + a shared attention block
      PYTHONPATH=src python examples/serve_lm_torch.py --smoke --device cpu
      PYTHONPATH=src python examples/serve_lm_torch.py --smoke --device cpu \
          --comm auto --tune-db db.json --expect-plan-hits

Without ``--smoke`` the model is the full-width configuration (bf16,
random weights from ``--seed``), ``--layers`` deep when given (a 104B
model does not fit one card: command-r-plus-104b's layers are ~3.1 GB
each, mixtral-8x22b's ~5.0 GB; deepseek-v3-671b's 3 dense head layers
~1.2 GB each and its MoE layers ~23 GB each).  ``--layers N`` keeps the
config's dense head layers (deepseek-v3-671b's 3) and cuts the MoE layers
after them.  ``--arch`` takes every registered architecture whose family
the port runs.  The ssm and hybrid families' ``--prompt-len`` must
be a multiple of their chunk (``ssm_chunk``: 128 at full width, 16 in the
smoke configs): the SSD scan takes whole chunks, and no padding is done.
zamba2-7b runs at full width and depth on one card (13.3 GB of bf16
weights).
"""
import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import plans
from repro_torch.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG,
                                     CommConfig)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import input_specs as isp, setup
from repro_torch.models import decode as dec
from repro_torch.models.transformer import require_ported_family
from repro_torch.train import serve as serve_mod

COMMS = {"static": CommConfig(), "baseline": BASELINE_CONFIG,
         "overlapped": OVERLAPPED_CONFIG, "auto": "auto"}


def cfg_str(c: CommConfig) -> str:
    return (f"{c.mode.value}/{c.scheduling.value}/{c.transport.value}"
            f"/chunk{c.chunk_bytes}/{c.algorithm}")


@dataclasses.dataclass
class Request:
    rid: int
    arrival: int              # decode-step tick the request arrives at
    prompt: np.ndarray        # (prompt_len,) int32
    gen_target: int           # tokens to generate (variable per request)


@dataclasses.dataclass
class Wave:
    wid: int
    requests: list            # Request per slot (tail slots may repeat)
    valid: list               # bool per slot (False = tail padding)
    slot: int = 0             # the static state this wave decodes in
    state: object = None
    steps: int = 0
    tokens: list = dataclasses.field(default_factory=list)  # (B,) per step


def ported_archs() -> list[str]:
    """The registered architectures whose family the port runs."""
    out = []
    for arch in list_archs():
        try:
            require_ported_family(get_config(arch))
        except NotImplementedError:
            continue
        out.append(arch)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ported_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config in float32")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                    "config's)")
    ap.add_argument("--tp", type=int, default=4,
                    help="tensor-parallel ranks, stacked on the device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--batch", type=int, default=4,
                    help="wave size (fixed serving shape)")
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=32,
                    help="max tokens per request (each request draws a "
                    "target in [gen/2, gen])")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrival-every", type=int, default=3,
                    help="a new request arrives every N decode steps")
    ap.add_argument("--max-active", type=int, default=2,
                    help="concurrent waves in flight (one static decode "
                    "state, and one decode graph, per slot)")
    ap.add_argument("--comm", default="static", choices=sorted(COMMS),
                    help="a named CommConfig, or 'auto' (per-phase TuneDB "
                    "selection)")
    ap.add_argument("--tune-db", default=None,
                    help="TuneDB path for --comm auto")
    ap.add_argument("--objective", default="e2e",
                    choices=("latency", "e2e"))
    ap.add_argument("--eager", action="store_true",
                    help="run prefill and decode eagerly on the card "
                    "instead of as CUDA graphs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--expect-phase-distinct", action="store_true",
                    help="exit non-zero unless prefill and decode resolved "
                    "DIFFERENT CommConfigs (a guard for per-phase auto)")
    ap.add_argument("--expect-plan-hits", action="store_true",
                    help="exit non-zero unless the CommPlan cache recorded "
                    "hits while serving")
    return ap


def model_config(args):
    if args.smoke:
        cfg = dataclasses.replace(get_smoke_config(args.arch),
                                  dtype=torch.float32)
    else:
        cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=args.layers,
            n_dense_layers=min(cfg.n_dense_layers, args.layers))
    return cfg


def run(args, log=print, sess=None) -> dict:
    """Serve ``args.requests`` requests; returns the run's metrics.
    ``sess`` is a session built earlier for ``model_config(args)`` (one is
    built from ``args.seed`` otherwise)."""
    cfg = model_config(args)
    if cfg.family in ("ssm", "hybrid") and args.prompt_len % cfg.ssm_chunk:
        raise ValueError(f"--prompt-len {args.prompt_len} is not a multiple "
                         f"of {cfg.name}'s SSD chunk {cfg.ssm_chunk}")
    comm = COMMS[args.comm]
    if sess is None:
        sess = setup.build_session(
            cfg, args.tp, CommConfig() if comm == "auto" else comm,
            seed=args.seed, device=args.device)
    dev = sess.params["final_norm"].device
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    max_len = args.prompt_len + args.gen
    shape_p = isp.ShapeSpec("serve", args.prompt_len, args.batch, "prefill")
    shape_d = isp.ShapeSpec("serve", max_len, args.batch, "decode")
    tuned = dict(tune_db_path=args.tune_db, objective=args.objective,
                 captured=not args.eager)
    rt_p, prefill_fn = serve_mod.build_serve_fn(
        cfg, args.tp, comm, shape_p,
        cache_capacity=serve_mod.cache_len(cfg, shape_d), device=dev,
        **tuned)
    rt, decode_fn = serve_mod.build_serve_fn(cfg, args.tp, comm, shape_d,
                                             device=dev, **tuned)
    graphs = dev.type == "cuda" and not args.eager
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}, tp {args.tp} on {dev}, "
        + ("captured (CUDA graphs)" if graphs else "eager"))
    log(f"[prefill] comm: {cfg_str(rt_p.comm)}")
    log(f"[decode]  comm: {cfg_str(rt.comm)}")
    distinct = rt_p.comm != rt.comm
    if distinct:
        log("phase-distinct configs selected")
    plans.reset_stats()

    rng = np.random.RandomState(args.seed)
    reqs = [Request(rid=r, arrival=r * args.arrival_every,
                    prompt=rng.randint(0, cfg.vocab_size,
                                       args.prompt_len).astype(np.int32),
                    gen_target=int(rng.randint(max(1, args.gen // 2),
                                               args.gen + 1)))
            for r in range(args.requests)]
    pending = list(reqs)          # not yet arrived
    waiting: list = []            # arrived, not yet admitted to a wave
    active: list = []             # waves in flight
    finished: dict = {}           # rid -> list of generated token ids
    prefill_ms: list = []
    decode_ms: list = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = (fa_ops.launches, ssd_ops.launches)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    slots = [None] * args.max_active       # the wave in each slot
    states: list = []                      # each slot's static state
    tick = wid = rr = 0
    t_run = time.perf_counter()
    while pending or waiting or active:
        while pending and pending[0].arrival <= tick:
            waiting.append(pending.pop(0))
        if len(active) < args.max_active and waiting and (
                len(waiting) >= args.batch or not pending):
            members = waiting[:args.batch]
            del waiting[:len(members)]
            valid = [True] * len(members)
            while len(members) < args.batch:     # tail wave: pad + mask
                members.append(members[-1])
                valid.append(False)
            slot = next(i for i, w in enumerate(slots) if w is None)
            wave = Wave(wid=wid, requests=members, valid=valid, slot=slot)
            wid += 1
            if wave.slot >= len(states):
                states.append(prefill_fn.new_state(sess.params))
            slots[slot] = wave
            toks = np.stack([r.prompt for r in members])
            sync()
            t0 = time.perf_counter()
            wave.state = prefill_fn(sess.params, {"tokens": toks},
                                    out=states[slot])
            sync()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            finite &= torch.isfinite(wave.state.last_logits).all()
            log(f"[prefill] wave {wave.wid}: {sum(valid)} reqs x "
                f"{args.prompt_len} tok, {prefill_ms[-1]:.1f} ms "
                f"({len(active) + 1} wave(s) in flight)")
            active.append(wave)
            continue
        if not active:
            tick += 1             # idle: nothing admitted, wait for arrivals
            continue
        wave = active[rr % len(active)]
        t0 = time.perf_counter()
        tok = dec.greedy_tokens(wave.state, rt)
        wave.state = decode_fn(sess.params, tok, wave.state)
        sync()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= torch.isfinite(wave.state.last_logits).all()
        wave.tokens.append(tok.cpu().numpy())
        wave.steps += 1
        tick += 1
        need = max(r.gen_target for r, v in zip(wave.requests, wave.valid)
                   if v)
        if wave.steps >= need:
            gen = np.stack(wave.tokens, 1)       # (B, steps)
            for i, (r, v) in enumerate(zip(wave.requests, wave.valid)):
                if v and r.rid not in finished:
                    finished[r.rid] = gen[i, :r.gen_target].tolist()
            active.remove(wave)
            slots[wave.slot] = None
            log(f"[decode]  wave {wave.wid}: retired after {wave.steps} "
                f"steps ({len(active)} wave(s) remain)")
        rr += 1
    wall = time.perf_counter() - t_run
    if sorted(finished) != [r.rid for r in reqs]:
        raise RuntimeError("dropped requests")
    gen_tokens = sum(len(v) for v in finished.values())
    out = {
        "requests": len(finished), "generated_tokens": gen_tokens,
        "wall_s": wall, "prefill_ms": prefill_ms,
        "decode_steps": len(decode_ms),
        "decode_ms_per_token_median": float(np.median(decode_ms)),
        "tokens_per_s": gen_tokens / wall,
        "decode_tokens_per_s": gen_tokens / max(sum(decode_ms) / 1e3, 1e-9),
        "flash_launches": fa_ops.launches - launches0[0],
        "ssd_launches": ssd_ops.launches - launches0[1],
        "all_logits_finite": bool(finite),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        "captured": graphs,
        "decode_graphs": len(decode_fn.graphs),
        "comm_prefill": rt_p.comm, "comm_decode": rt.comm,
        "phase_distinct": distinct,
        "plan_stats": plans.cache_stats(),
        "finished": finished,
    }
    log(f"served {len(finished)}/{args.requests} requests, {gen_tokens} "
        f"tokens in {wall:.2f} s: {out['tokens_per_s']:.2f} generated "
        f"tokens/s")
    log(f"[decode]  {len(decode_ms)} steps, median "
        f"{out['decode_ms_per_token_median']:.2f} ms/step (one token per "
        f"request of the wave), {out['decode_tokens_per_s']:.2f} tokens/s of "
        f"decode time")
    log(f"[prefill] {len(prefill_ms)} waves: "
        + ", ".join(f"{m:.1f}" for m in prefill_ms) + " ms; kernel launches: "
        f"flash attention {out['flash_launches']}, SSD scan "
        f"{out['ssd_launches']}"
        + (f"; peak memory {out['peak_mem_gb']:.2f} GB"
           if out["peak_mem_gb"] is not None else ""))
    st = out["plan_stats"]
    log(f"plans cache: {st['plan_hits']} plan hits / {st['plan_misses']} "
        f"misses while serving; {out['decode_graphs']} decode graph(s)")
    for rid in sorted(finished)[:2]:
        log(f"  req{rid}: {finished[rid][:12]}")
    if not out["all_logits_finite"]:
        raise RuntimeError("non-finite logits")
    return out


def main():
    args = parser().parse_args()
    out = run(args)
    if args.expect_phase_distinct and not out["phase_distinct"]:
        print("EXPECT-PHASE-DISTINCT FAILED: prefill and decode resolved "
              "the same CommConfig", file=sys.stderr)
        return 2
    if args.expect_plan_hits and out["plan_stats"]["plan_hits"] <= 0:
        print("EXPECT-PLAN-HITS FAILED: the serving run recorded zero "
              "CommPlan cache hits", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
