"""``core/scheduler.py`` and the in-memory plan-cache API of
``core/plans.py``, on the CPU, against the JAX package's ``core/scheduler.py``
(in this process: its runners run on one device).

The runners' card path (one CUDA graph per fused step) is held in
``tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import scheduler as jax_scheduler
from repro.core.config import V5E, CommConfig as JaxCommConfig
from repro.core.config import Scheduling as JaxScheduling

from repro_torch.core import plans, scheduler, streaming
from repro_torch.core.config import (H100, BASELINE_CONFIG, CommConfig,
                                     Scheduling)
from repro_torch.models import layers


def _phases(mod):
    return [mod.Phase("a", lambda c: c * 2.0),
            mod.Phase("comm", lambda c: c + 1.0, is_comm=True),
            mod.Phase("b", lambda c: c ** 2)]


def test_scheduler_runners_equivalent():
    """Host-scheduled and fused runners produce identical numerics, and the
    JAX package's runners the same values; the host runner pays one
    dispatch per phase (the paper's l_k accounting)."""
    x = np.arange(8.0, dtype=np.float32)
    host = scheduler.HostScheduledRunner(_phases(scheduler))
    fused = scheduler.FusedRunner(_phases(scheduler))
    out_h = host.run_step(torch.from_numpy(x))
    out_f = fused.run_step(torch.from_numpy(x))
    assert torch.equal(out_h, out_f)
    want = jax_scheduler.FusedRunner(_phases(jax_scheduler)).run_step(
        jnp.asarray(x))
    np.testing.assert_array_equal(out_f.numpy(), np.asarray(want))
    assert host.dispatch_count == 3
    assert fused.dispatch_count == 1
    assert host.modeled_dispatch_overhead() > fused.modeled_dispatch_overhead()


def test_modeled_dispatch_overhead_is_the_reference_formula():
    """The same formulas on the port's HardwareSpec: the JAX package's
    runners given a spec with the H100's two dispatch costs agree."""
    hw = dataclasses.replace(V5E, host_dispatch=H100.host_dispatch,
                             fused_dispatch=H100.fused_dispatch)
    phases = _phases(scheduler)
    for cls in ("HostScheduledRunner", "FusedRunner"):
        got = getattr(scheduler, cls)(phases).modeled_dispatch_overhead()
        want = getattr(jax_scheduler, cls)(
            _phases(jax_scheduler), hw).modeled_dispatch_overhead()
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("sched", list(Scheduling))
def test_make_runner_picks_by_scheduling(sched):
    cfg = CommConfig(scheduling=sched)
    got = scheduler.make_runner(_phases(scheduler), cfg)
    want = jax_scheduler.make_runner(
        _phases(jax_scheduler),
        JaxCommConfig(scheduling=JaxScheduling(sched.value)))
    assert type(got).__name__ == type(want).__name__


def test_runners_take_tensor_trees_on_the_cpu():
    """A (tensor, dict) carry through both runners: equal, and the fused
    runner runs eagerly on the CPU (no graph)."""
    phases = [scheduler.Phase("mm", lambda c: (c[0] @ c[1]["w"], c[1])),
              scheduler.Phase("comm", lambda c: (c[0] + 1.0, c[1]),
                              is_comm=True)]
    rng = np.random.RandomState(0)
    carry = (torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
             {"w": torch.from_numpy(rng.randn(8, 8).astype(np.float32))})
    host = scheduler.make_runner(phases, BASELINE_CONFIG)
    fused = scheduler.make_runner(phases, CommConfig())
    a, b = host.run_step(carry), fused.run_step(carry)
    assert torch.equal(a[0], b[0]) and a[1]["w"] is carry[1]["w"]
    assert fused._graph is None and (host.dispatch_count,
                                     fused.dispatch_count) == (2, 1)


def test_measure_dispatch_overhead():
    assert scheduler.measure_dispatch_overhead(20, device="cpu") > 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):      # the card, or raise
            scheduler.measure_dispatch_overhead(2)


# A CUDA graph's DOT dump (``cudaGraphDebugDotPrint``, verbose) cut to its
# node and edge lines: a kernel, a device-to-device copy, and a nested
# child graph's kernel.
_DOT = """digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 2) | _ZN2at6native29vectorized_elementwise_kernel}
}"];

"graph_1_node_1"[style="solid" shape="record" label="{
MEMCPY
| {kind | DtoD (DEVICE to DEVICE)}
}"];

"graph_1_node_2"[style="solid" shape="record" label="{EMPTY
| {ID | 2 (topoId: 0)}
}"];
subgraph cluster_2 {
"graph_2_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 0) | spin_kernel}
}"];
}
"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
"graph_1_node_1" -> "graph_1_node_2" [headlabel=0];
}
}
"""


def test_dot_node_types_counts_nodes_not_edges():
    assert scheduler.dot_node_types(_DOT) == {"KERNEL": 2, "MEMCPY": 1,
                                              "EMPTY": 1}
    assert scheduler.dot_node_types("digraph dot {\n}\n") == {}


def test_capture_counters_take_every_dict_entry(monkeypatch):
    """What a capture subtracts and a replay adds back covers every kernel
    counter, each entry of a dict counter too (quant's by kernel, flash's
    by route): launches made while a graph is captured, read as the
    difference of two readings, come off all of them and go back on."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.quant import ops as qops
    monkeypatch.setattr(fa, "launches", 5)
    monkeypatch.setattr(fa, "route_launches",
                        {"wgmma": 1, "wgmma192": 2, "fma": 0})
    monkeypatch.setattr(qops, "launches", {"quantize": 3, "dequantize": 4})
    before = scheduler._read_counts()
    fa.launches += 4
    fa.route_launches["wgmma192"] += 4
    qops.launches["dequantize"] += 1
    after = scheduler._read_counts()
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    assert sorted(map(str, delta.values())) == ["1", "4", "4"]
    scheduler._add_counts(delta, -1)
    assert (fa.launches, fa.route_launches, qops.launches) == (
        5, {"wgmma": 1, "wgmma192": 2, "fma": 0},
        {"quantize": 3, "dequantize": 4})
    scheduler._add_counts(delta)
    scheduler._add_counts(delta)
    assert (fa.launches, fa.route_launches["wgmma192"],
            qops.launches["dequantize"]) == (13, 10, 6)


def test_keeping_topology_is_scoped():
    assert not scheduler._KEEP_TOPOLOGY
    with pytest.raises(KeyError):
        with scheduler.keeping_topology():
            assert scheduler._KEEP_TOPOLOGY
            with scheduler.keeping_topology():
                pass
            assert scheduler._KEEP_TOPOLOGY
            raise KeyError("leaves the block")
    assert not scheduler._KEEP_TOPOLOGY


# ----------------------------------------------------------------------
# plans: cache_stats / clear_cache / reset_stats / REPRO_PLAN_CACHE=0
# ----------------------------------------------------------------------

def test_cache_stats_count_hits_and_misses():
    plans.reset_stats()
    assert plans.cache_stats()["plan_hits"] == 0
    cfg = CommConfig(chunk_bytes=4096)
    a = plans.chunk_plan((1000,), torch.float32, cfg)
    b = plans.chunk_plan((1000,), torch.float32, cfg)
    st = plans.cache_stats()
    assert a is b and st["plan_hits"] >= 1 and st["size"] >= 1
    assert set(st) == {"plan_hits", "plan_misses", "program_hits",
                       "program_misses", "size", "pinned", "disk_hits",
                       "disk_misses", "disk_writes", "disk_corrupt"}
    plans.clear_cache()
    assert plans.cache_stats()["size"] == 0
    c = plans.chunk_plan((1000,), torch.float32, cfg)
    assert c == a and c is not a          # re-derived, the same plan
    assert plans.cache_stats()["plan_misses"] > st["plan_misses"]


def test_bypass_rederives_plans_but_keeps_device_tensors(monkeypatch):
    """``REPRO_PLAN_CACHE=0`` re-derives every plan (equal values, new
    objects, no entries), while the pinned device index tensors a captured
    graph reads by address are still built once and survive
    ``clear_cache``."""
    cfg = CommConfig(chunk_bytes=4096)
    freqs = layers.rope_frequencies(16, 1e4, torch.device("cpu"))
    src, _ = streaming._perm_index(((0, 1), (1, 0)), torch.device("cpu"))
    monkeypatch.setenv("REPRO_PLAN_CACHE", "0")
    assert not plans.cache_enabled()
    size = plans.cache_stats()["size"]
    a = plans.chunk_plan((777,), torch.float32, cfg)
    b = plans.chunk_plan((777,), torch.float32, cfg)
    assert a == b and a is not b
    assert plans.cache_stats()["size"] == size
    plans.clear_cache()
    assert layers.rope_frequencies(16, 1e4, torch.device("cpu")) is freqs
    assert streaming._perm_index(((0, 1), (1, 0)),
                                 torch.device("cpu"))[0] is src
    monkeypatch.delenv("REPRO_PLAN_CACHE")
    assert plans.cache_enabled()


def test_bypass_serves_bitwise_the_cached_path(monkeypatch):
    """One prefill + two decode steps of the qwen3 smoke config under the
    ring config (chunk plans, ring shifts, rope tables): the same logits
    with and without the plan cache."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import input_specs as isp
    from repro_torch.models import decode as dec, sharding, transformer
    from repro_torch.train import serve
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"),
                              dtype=torch.float32)
    comm = CommConfig(algorithm="ring", chunk_bytes=1024)
    params = sharding.shard_params(
        transformer.init_model(0, cfg, 2, "cpu"), cfg, 2)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))

    def serve_once():
        _, pre = serve.build_serve_fn(cfg, 2, comm,
                                      isp.ShapeSpec("s", 8, 2, "prefill"),
                                      cache_capacity=10, device="cpu")
        rt, step = serve.build_serve_fn(cfg, 2, comm,
                                        isp.ShapeSpec("s", 10, 2, "decode"),
                                        device="cpu")
        st = pre(params, {"tokens": toks})
        out = [st.last_logits.clone()]
        for _ in range(2):
            st = step(params, dec.greedy_tokens(st, rt), st)
            out.append(st.last_logits.clone())
        return out

    cached = serve_once()
    monkeypatch.setenv("REPRO_PLAN_CACHE", "0")
    plans.reset_stats()
    bypassed = serve_once()
    assert plans.cache_stats()["plan_misses"] > 0
    assert all(torch.equal(a, b) for a, b in zip(cached, bypassed))
