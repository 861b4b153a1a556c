"""Serving under ``comm="auto"`` on the CPU: the sweep's three all_reduce
consumer loops against the JAX package's, and the per-phase selection
against the JAX package's ``resolve_serve_comm``.

- Consumer loops (``row_parallel``, ``decode_step``, ``prefill``): three
  chained iterations from a seeded input on 4 and 8 ranks under four
  configs, held against the JAX package's ``_build_consumer_op`` run under
  ``shard_map`` (one 8-device JAX subprocess), within f32 1e-5 absolute
  (every output is a tanh).
- Selection: one hand-written TuneDB holds consumer-tagged entries under
  both packages' topology keys; per phase the port and the JAX package pick
  the same config, by e2e and by latency, and ``build_session``'s
  ``row_parallel`` lookup too.
- ``comm="auto"`` serving (qwen3 smoke config, float32) is bitwise the
  serving built with the configs it resolved to."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.launch import input_specs as jax_isp
from repro.train import serve as jax_serve
from repro.tune import sweep as jax_sweep
from repro import tune as jax_tune

from repro_torch import tune
from repro_torch.configs import get_smoke_config
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import CommConfig, OPTIMIZED_CONFIG
from repro_torch.launch import input_specs as isp, setup
from repro_torch.models import decode as dec
from repro_torch.train import serve
from repro_torch.tune import sweep

CONSUMERS = ("row_parallel", "decode_step", "prefill")
RANKS = (4, 8)
MSG = 4096
ITERS = 3
ATOL = 1e-5
CONFIGS = {"default": {},
           "overlapped": {"scheduling": "overlapped"},
           "baseline": {"mode": "buffered", "scheduling": "host"},
           "streaming-ring": {"mode": "streaming", "algorithm": "ring",
                              "chunk_bytes": 1 << 16}}

JAX_CODE = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core.communicator import Communicator
from repro.tune import sweep
from repro.tune.space import config_from_dict

spec = json.loads(SPEC)
inp = dict(np.load(spec["inputs"]))
out = {}
for n in spec["ranks"]:
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    comm = Communicator(("x",), (n,))
    for consumer in spec["consumers"]:
        for name, kw in spec["configs"].items():
            op, _ = sweep._build_consumer_op(
                "all_reduce", comm, config_from_dict(kw), spec["msg"],
                consumer=consumer)

            def body(xs, op=op):
                x = xs[0]
                for _ in range(spec["iters"]):
                    x = op(x)
                return x[None]
            prog = jax.jit(compat.shard_map(body, mesh=mesh,
                                            in_specs=P("x"),
                                            out_specs=P("x"),
                                            check_vma=False))
            x = inp[f"{n}/{consumer}"]
            out[f"{n}/{consumer}/{name}"] = np.asarray(prog(x))
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


def _input(n, consumer):
    _, shape = sweep._build_consumer_op(
        "all_reduce", Communicator(("x",), (n,)), CommConfig(), MSG,
        consumer=consumer, device="cpu")
    rng = np.random.RandomState(n * 10 + CONSUMERS.index(consumer))
    return rng.randn(n, *shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("consumer_ref")
    np.savez(d / "inputs.npz", **{f"{n}/{c}": _input(n, c)
                                  for n in RANKS for c in CONSUMERS})
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "ranks": list(RANKS), "consumers": list(CONSUMERS),
            "configs": CONFIGS, "msg": MSG, "iters": ITERS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX REF OK" in out
    return dict(np.load(d / "ref.npz"))


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("consumer", CONSUMERS)
@pytest.mark.parametrize("n", RANKS)
def test_consumer_loop_matches_reference(ref, n, consumer, name):
    cfg = tune.config_from_dict(CONFIGS[name])
    op, shape = sweep._build_consumer_op(
        "all_reduce", Communicator(("x",), (n,)), cfg, MSG,
        consumer=consumer, device="cpu")
    x = torch.from_numpy(_input(n, consumer))
    for _ in range(ITERS):
        x = op(x)
    want = ref[f"{n}/{consumer}/{name}"]
    assert tuple(x.shape) == want.shape == (n,) + tuple(shape)
    err = float(np.abs(x.numpy() - want).max())
    assert err <= ATOL, f"max err {err}"


@pytest.mark.parametrize("consumer", CONSUMERS + (None,))
@pytest.mark.parametrize("msg", (1 << 10, 1 << 16, 1 << 26))
def test_consumer_geometry_and_flops_match_reference(consumer, msg):
    assert sweep.CONSUMERS["all_reduce"] == jax_sweep.CONSUMERS["all_reduce"]
    assert sweep.consumer_flops("all_reduce", msg, consumer) == \
        jax_sweep.consumer_flops("all_reduce", msg, consumer)
    if consumer is not None:
        _, got = sweep._build_consumer_op(
            "all_reduce", Communicator(("x",), (4,)), CommConfig(), msg,
            consumer=consumer, device="cpu")
        _, want = jax_sweep._build_consumer_op(
            "all_reduce", object(), None, msg, consumer=consumer)
        assert tuple(got) == tuple(want)


# ----------------------------------------------------------------------
# Per-phase selection
# ----------------------------------------------------------------------

CFG = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=torch.float32)
TP, B, S, GEN = 4, 4, 24, 4
SHAPES = {"prefill": ("s", S, B, "prefill"),
          "decode": ("s", S + GEN, B, "decode")}
WINNERS = {"prefill": {"mode": "streaming", "scheduling": "overlapped",
                       "chunk_bytes": 1 << 16},
           "decode_step": {"mode": "buffered", "scheduling": "fused"},
           "row_parallel": {"mode": "streaming", "algorithm": "ring"}}
LOSERS = [{}, {"mode": "buffered", "scheduling": "host"}]


class _Dev:
    platform = "cpu"


class _Mesh:
    """The JAX package's selection reads only the devices' platform and
    count."""

    def __init__(self, n):
        self.devices = np.array([_Dev()] * n, dtype=object)


def _db_entries(module, topo):
    """Consumer-tagged all_reduce entries at both phases' message sizes and
    the session's nominal size: each consumer's own winner has the lowest
    e2e time, and every config the same bare latency but the losers."""
    sizes = [serve.serve_msg_bytes(CFG, isp.ShapeSpec(*s))
             for s in SHAPES.values()] + [4 * CFG.d_model * 1024]
    rows = []
    for msg in sizes:
        for consumer, win in WINNERS.items():
            for i, cfg in enumerate([win] + LOSERS):
                rows.append(module.TuneEntry(
                    topo=topo, collective="all_reduce", msg_bytes=msg,
                    config=module.config_to_dict(
                        module.config_from_dict(cfg)),
                    us_per_call=10.0 + 5 * (i == 0), gbps=1.0,
                    e2e_us=20.0 + 3 * i, consumer=consumer))
    return rows


@pytest.fixture(scope="module")
def db_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_auto") / "tunedb.json"
    entries = (_db_entries(tune, "torch-cpu:4")
               + _db_entries(jax_tune, "cpu:4"))
    tune.TuneDB(entries).save(path)
    return path


@pytest.mark.parametrize("objective", ("e2e", "latency"))
@pytest.mark.parametrize("phase", list(SHAPES))
def test_resolve_serve_comm_matches_reference(db_path, phase, objective):
    got = serve.resolve_serve_comm(CFG, TP, "auto",
                                   isp.ShapeSpec(*SHAPES[phase]),
                                   tune_db_path=db_path, objective=objective,
                                   device="cpu")
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-8b"))
    want = jax_serve.resolve_serve_comm(jcfg, _Mesh(TP), "auto",
                                        jax_isp.ShapeSpec(*SHAPES[phase]),
                                        tune_db_path=db_path,
                                        objective=objective)
    assert tune.config_to_dict(got) == jax_tune.config_to_dict(want)
    if objective == "e2e":
        assert got == tune.config_from_dict(
            WINNERS[serve.PHASE_CONSUMERS[phase]])
    # a concrete config passes through; a cold TuneDB gives the fallback
    assert serve.resolve_serve_comm(CFG, TP, got,
                                    isp.ShapeSpec(*SHAPES[phase])) is got
    assert serve.resolve_serve_comm(
        CFG, TP, "auto", isp.ShapeSpec(*SHAPES[phase]),
        tune_db_path=db_path.parent / "cold.json",
        device="cpu") == OPTIMIZED_CONFIG


def test_build_session_auto_resolves_the_row_parallel_consumer(db_path):
    from repro.core.collectives import resolve_config as jax_resolve
    sess = setup.build_session(CFG, TP, "auto", device="cpu",
                               tune_db_path=db_path, objective="e2e")
    want = jax_resolve("auto", "all_reduce", 4 * CFG.d_model * 1024,
                       mesh=_Mesh(TP), db_path=db_path, objective="e2e",
                       consumer="row_parallel")
    assert tune.config_to_dict(sess.rt.comm) == \
        jax_tune.config_to_dict(want)
    assert sess.rt.comm == tune.config_from_dict(WINNERS["row_parallel"])


def _serve(params, comms, db_path):
    _, pre = serve.build_serve_fn(CFG, TP, comms["prefill"],
                                  isp.ShapeSpec(*SHAPES["prefill"]),
                                  cache_capacity=S + GEN, device="cpu",
                                  tune_db_path=db_path)
    rt, step = serve.build_serve_fn(CFG, TP, comms["decode"],
                                    isp.ShapeSpec(*SHAPES["decode"]),
                                    device="cpu", tune_db_path=db_path)
    toks = np.random.RandomState(0).randint(0, CFG.vocab_size, (B, S))
    st = pre(params, {"tokens": toks})
    out = [st.last_logits.clone()]
    for _ in range(GEN):
        nxt = dec.greedy_tokens(st, rt)
        st = step(params, nxt, st)
        out += [nxt, st.last_logits.clone()]
    return rt, out


def test_auto_serving_is_bitwise_its_resolved_configs(db_path):
    sess = setup.build_session(CFG, TP, CommConfig(), device="cpu")
    resolved = {k: serve.resolve_serve_comm(
        CFG, TP, "auto", isp.ShapeSpec(*SHAPES[k]), tune_db_path=db_path,
        device="cpu") for k in SHAPES}
    assert resolved["prefill"] != resolved["decode"]     # phase-distinct
    rt_a, auto = _serve(sess.params, {k: "auto" for k in SHAPES}, db_path)
    rt_r, fixed = _serve(sess.params, resolved, db_path)
    assert rt_a.comm == rt_r.comm == resolved["decode"]
    assert all(torch.equal(a, b) for a, b in zip(auto, fixed))
