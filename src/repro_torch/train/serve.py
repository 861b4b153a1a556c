"""Serving entry points: prefill and decode_step builders on stacked
tensor-parallel ranks.

Used by ``examples/serve_lm_torch.py`` (continuous-batching serving with
greedy sampling), ``chip_smoke.py`` and the tests.

On the card each built function runs as captured programs, the
counterpart of the JAX package's ``jax.jit``: a prefill is one CUDA graph
per (wave shape, cache capacity), a decode step one graph per (batch,
capacity) and static state, replayed for every step
(:class:`repro_torch.core.scheduler.CapturedGraph`).  A graph reads its
inputs by address, so:

- the prefill graph writes into a static state the built function owns;
  ``prefill_fn(params, batch)`` returns it (valid until the next prefill),
  and ``prefill_fn(params, batch, out=state)`` hands the wave to
  ``state`` by a device copy (a qwen3-8b wave's caches are 0.62 GB, a
  small share of the wave's ~0.3 s prefill; a prefill graph per state
  would cost a capture and its memory pool per state);
- the decode function captures one graph per state it is given (the
  state's buffers are the graph's static input and output) and replays it
  on every later step of that state: a continuous-batching server keeps one
  state per active wave slot (``prefill_fn.new_state``) and so one decode
  graph per slot.

The call that captures a graph returns the result of its eager warm-up;
later calls replay.  A capture that fails raises: there is no eager
fallback on the card.  ``captured=False`` asks for the eager path (the CPU
always runs it).

``comm="auto"`` resolves a *per-phase* CommConfig from the TuneDB: prefill
and decode are distinct tuned consumers (``sweep.CONSUMERS['all_reduce']``)
with opposite cost structures — decode's tiny latency-bound per-token
combines vs prefill's throughput-bound bulk reduces — so the two phases
can select different configs from the same measurements
(``select_config(consumer=..., objective="e2e")``).
"""
from __future__ import annotations

import torch

from repro_torch.core.config import CommConfig
from repro_torch.core.scheduler import CapturedGraph
from repro_torch.device import resolve_device
from repro_torch.launch import input_specs as isp
from repro_torch.models import attention, mla
from repro_torch.models import decode as dec
from repro_torch.models.common import MeshContext, ModelConfig, Runtime

# Which sweep consumer loop stands in for each serving phase when
# ``comm="auto"`` resolves a config (the per-phase half of the tuned path).
PHASE_CONSUMERS = {"prefill": "prefill", "decode": "decode_step"}


def cache_len(cfg: ModelConfig, shape: isp.ShapeSpec) -> int:
    if cfg.family == "vlm":
        return shape.seq_len + cfg.num_patches
    return shape.seq_len


def serve_msg_bytes(cfg: ModelConfig, shape: isp.ShapeSpec) -> int:
    """Dominant TP-collective message size of a serving phase (bytes):
    both phases' per-layer combine carries (tokens, d_model) f32
    partials; decode moves one token per sequence, prefill the whole
    prompt."""
    tokens = shape.global_batch
    if shape.kind == "prefill":
        tokens *= shape.seq_len
    return 4 * cfg.d_model * tokens


def resolve_serve_comm(cfg: ModelConfig, tp: int, comm,
                       shape: isp.ShapeSpec, tune_db_path=None,
                       objective: str = "e2e", device=None) -> CommConfig:
    """Per-phase ``comm="auto"`` resolution for the serving path.

    A concrete ``CommConfig`` passes through untouched.  ``"auto"`` asks
    the autotuner for this phase's consumer loop (``PHASE_CONSUMERS``) at
    this phase's message size on ``tp`` ranks of ``device``'s platform (the
    card unless another is named), ranking by the measured consumer-loop
    time (``objective="e2e"``)."""
    if isinstance(comm, CommConfig):
        return comm
    from repro_torch.core.collectives import resolve_config
    consumer = PHASE_CONSUMERS.get(shape.kind, "decode_step")
    return resolve_config(comm, "all_reduce", serve_msg_bytes(cfg, shape),
                          n_ranks=tp, db_path=tune_db_path,
                          objective=objective, consumer=consumer,
                          device=device)


def serve_runtime(cfg: ModelConfig, tp: int, comm, shape: isp.ShapeSpec,
                  tune_db_path=None, objective: str = "e2e",
                  device=None) -> Runtime:
    comm = resolve_serve_comm(cfg, tp, comm, shape, tune_db_path=tune_db_path,
                              objective=objective, device=device)
    return Runtime(cfg=cfg, mesh=MeshContext.stacked(tp), comm=comm,
                   seq_axes=isp.decode_seq_axes(shape))


def _tokens(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.long, device=device)


def _state_buffers(state: dec.ServeState) -> list[torch.Tensor]:
    """Every buffer of a state that a captured prefill or decode writes:
    the caches (the hybrid family's SSM states and KV caches alike), the
    last logits and the length."""
    c = state.caches
    if isinstance(c, attention.KVCache):
        caches = [c.k, c.v]
    elif isinstance(c, mla.MLACache):
        caches = [c.ckv, c.k_rope]
    elif isinstance(c, dec.HybridCache):
        caches = [c.ssm.conv, c.ssm.h, c.attn.k, c.attn.v]
    else:
        caches = [c.conv, c.h]
    return caches + [state.last_logits, state.length]


class _Prefill:
    """``fn(params, batch, out=None) -> ServeState`` (see the module
    docstring)."""

    def __init__(self, rt: Runtime, shape: isp.ShapeSpec, max_len: int,
                 device: torch.device, captured: bool):
        self.rt, self.shape, self.max_len = rt, shape, max_len
        self.device = device
        self.captured = captured and device.type == "cuda"
        self.graph: CapturedGraph | None = None
        self.params = None        # the parameters the graph reads

    def new_state(self, params, device=None) -> dec.ServeState:
        """A zero state of this builder's shapes, for ``out=``."""
        return dec.init_state(params, self.rt, self.shape.global_batch,
                              self.max_len, device)

    def __call__(self, params, batch, out: dec.ServeState | None = None
                 ) -> dec.ServeState:
        B, S = self.shape.global_batch, self.shape.seq_len
        tokens = _tokens(batch["tokens"], self.device)
        if tuple(tokens.shape) != (B, S):
            raise ValueError(f"prefill built for tokens of {(B, S)}, got "
                             f"{tuple(tokens.shape)}")
        if out is not None:
            want = _state_buffers(self.new_state(params, "meta"))
            for got, ref in zip(_state_buffers(out), want):
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    raise ValueError(f"out= holds {tuple(got.shape)} "
                                     f"{got.dtype} where this prefill "
                                     f"writes {tuple(ref.shape)} {ref.dtype}")
        if not self.captured:
            return dec.prefill(params, {"tokens": tokens}, self.rt,
                               self.max_len, out=out)
        if self.graph is None or self.params is not params:
            st = self.new_state(params)
            rt, max_len = self.rt, self.max_len   # no cycle through self
            self.graph = CapturedGraph(
                lambda tok: dec.prefill(params, {"tokens": tok}, rt,
                                        max_len, out=st),
                static=(tokens.clone(),), span="serve.prefill")
            self.params = params
        else:
            self.graph.static[0].copy_(tokens)
            self.graph.replay()
        if out is None:
            return self.graph.out
        for d, s in zip(_state_buffers(out), _state_buffers(self.graph.out)):
            d.copy_(s)
        return out


class _Decode:
    """``fn(params, token, state) -> ServeState`` (see the module
    docstring)."""

    def __init__(self, rt: Runtime, batch: int, check_caches,
                 device: torch.device, captured: bool):
        self.rt, self.batch, self.check_caches = rt, batch, check_caches
        self.device = device
        self.captured = captured and device.type == "cuda"
        self.graphs: dict[tuple, CapturedGraph] = {}
        self._pool = None

    def __call__(self, params, token, state: dec.ServeState
                 ) -> dec.ServeState:
        token = _tokens(token, self.device)
        if tuple(token.shape) != (self.batch,):
            raise ValueError(f"decode built for tokens of {(self.batch,)}, "
                             f"got {tuple(token.shape)}")
        self.check_caches(state.caches)
        if not self.captured:
            return dec.decode_step(params, token, state, self.rt)
        key = (id(params),) + tuple(t.data_ptr()
                                    for t in _state_buffers(state))
        g = self.graphs.get(key)
        if g is None:
            rt = self.rt                           # no cycle through self
            # the decode graphs share one pool: every result they keep
            # lives in the states, outside it
            g = CapturedGraph(
                lambda tok: dec.decode_step(params, tok, state, rt),
                static=(token.clone(),), pool=self._pool,
                span="serve.decode")
            self._pool = g.pool
            self.graphs[key] = g
            return g.warm
        g.static[0].copy_(token)
        return g.replay()


def build_serve_fn(cfg: ModelConfig, tp: int, comm, shape: isp.ShapeSpec,
                   cache_capacity: int | None = None, device=None,
                   tune_db_path=None, objective: str = "e2e",
                   captured: bool = True):
    """Returns ``(rt, fn)`` for serving on ``tp`` stacked ranks on the
    device (the card unless ``device`` names another):

    - prefill kind: ``fn(params, batch, out=None) -> ServeState``,
      ``batch["tokens"]`` of exactly ``(global_batch, seq_len)``;
      ``fn.new_state(params)`` allocates a state for ``out``;
    - decode kind: ``fn(params, token, state) -> ServeState``, ``token``
      ``(global_batch,)``, on KV or latent caches of ``cache_len(cfg,
      shape)`` positions (dense, moe), on the fixed-size SSM state (ssm),
      or on both (hybrid: every Mamba2 layer's state and the shared
      block's KV cache of each group), updated in place.

    ``comm`` may be a concrete ``CommConfig`` or ``"auto"`` (per-phase
    TuneDB selection at ``tune_db_path`` by ``objective``; the resolved
    config is ``rt.comm``).  ``captured`` (the default) runs the card's
    path as CUDA graphs; the CPU runs eagerly.

    ``cache_capacity`` (prefill only) decouples the KV-cache capacity from
    the prompt length: the caches a prefill returns cover
    ``cache_capacity`` positions (prompt + planned generation).  Defaults
    to ``cache_len(cfg, shape)``.  The ssm family's state does not depend
    on it, as in the JAX package's prefill."""
    dev = resolve_device(device)
    rt = serve_runtime(cfg, tp, comm, shape, tune_db_path=tune_db_path,
                       objective=objective, device=dev)
    B = shape.global_batch

    if shape.kind == "prefill":
        min_len = cache_len(cfg, shape)
        max_len = cache_capacity if cache_capacity is not None else min_len
        if max_len < min_len:
            raise ValueError(
                f"cache_capacity={max_len} is smaller than the prefill "
                f"shape needs ({min_len}: prompt"
                + (" + patch prefix" if cfg.family == "vlm" else "") + ")")
        return rt, _Prefill(rt, shape, max_len, dev, captured)

    if cache_capacity is not None:
        raise ValueError("cache_capacity applies to the prefill builder; "
                         "a decode ShapeSpec's seq_len IS the capacity")

    capacity = -(-cache_len(cfg, shape) // rt.sp_size)

    def check_ssm(states):
        # a fixed-size state: the sequence length does not enter it
        want = isp.ssm_state_abstract(cfg, B, tp, cfg.n_layers)
        for got, ref in zip(states, want):
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise ValueError(
                    f"decode built for SSM states of {tuple(ref.shape)} "
                    f"{ref.dtype}, got {tuple(got.shape)} {got.dtype}")

    def check_kv(caches):
        got = (caches.seq_shard if isinstance(caches, mla.MLACache)
               else caches.k.shape[3])
        if got != capacity:
            raise ValueError(f"decode built for caches of {capacity} "
                             f"positions per shard, got {got}")

    if cfg.family == "ssm":
        check_caches = check_ssm
    elif cfg.family == "hybrid":
        def check_caches(caches):
            check_ssm(caches.ssm)
            check_kv(caches.attn)
    else:
        check_caches = check_kv
    return rt, _Decode(rt, B, check_caches, dev, captured)
