"""The pod axis of the port against the JAX package's, on the CPU:
``hierarchical_all_reduce`` on a ``(pod=2, data=4)`` mesh and on a
torus-placed inner communicator (the twins of
``tests/test_core_collectives.py::test_hierarchical_all_reduce_multipod``
and ``tests/test_topology.py::test_torus_parity_a2a_hierarchical_and_
cache_bypass``); its search space; one ZeRO-1 AdamW step of the qwen3 and
mamba2 smoke configs (float32) on ``(pod 2, data 2, model 2)`` (the twin
of ``tests/test_distributed_parity.py``'s multipod step); the ZeRO-1 slice
layout under pods, and a pod-mesh checkpoint.

The JAX side runs once, in one 8-device subprocess, its meshes built as
``Mesh(np.array(jax.devices()).reshape(...), names)``.  The port takes the
JAX package's initial parameters through ``sharding.from_reference``.

Tolerances: the hierarchical all-reduce within 1e-5 (rtol and atol: the
two packages sum eight f32 rows in other orders); the train step's loss
within 1e-5, and its gradient norm, its first moments (the clipped
gradient slices, in the JAX package's global ``(tp, dp, k)`` layout) and
each parameter leaf's change within the gradient bounds the port's tests
already use, of their largest value: 1e-4 for qwen3
(``tests/test_torch_train.py``), 2e-3 for mamba2
(``tests/test_torch_train_ssm.py``).  The step runs at Adam eps 1, where
the first step's change is ``lr (g / (|g| + 1) + wd p)``, linear in the
gradient's error (at eps 1e-8 it is ``lr sign(g)``, and noise-level
elements flip; ``tests/test_torch_train_ssm.py`` says more).  The pod
mesh's step against the port's own ``(data 4, model 2)`` step: the same
mean gradient over the same four data ranks, summed in another order, held
to the same gradient bounds (that reassociation alone moves a leaf's change
by up to 3.9e-5 of its largest for qwen3's ``w_up``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro import tune as jax_tune

from repro_torch import tune
from repro_torch.checkpoint.checkpointer import Checkpointer, emergency_save
from repro_torch.configs import get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import CommConfig
from repro_torch.core.topology import TorusSpec
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.models import sharding
from repro_torch.optim import adamw
from repro_torch.tune import sweep

HIER_TOL = 1e-5
GRAD_TOL = {"qwen3-8b": 1e-4, "mamba2-130m": 2e-3}
LOSS_TOL = 1e-5
ARCHS = tuple(GRAD_TOL)
OC = dict(lr=1e-2, warmup_steps=1, total_steps=100, eps=1.0)
B, S = 4, 32
# per-rank message shapes: 33 and 3 x 11 do not divide over the 4 inner
# ranks (padded), 64 does
SHAPES = [(33,), (64,), (3, 11)]
# exact wires (the bf16 wire's rounding has its own bound in
# tests/test_torch_collectives.py)
CFGS = [{}, {"algorithm": "ring", "chunk_bytes": 512},
        {"mode": "buffered"}, {"scheduling": "host", "algorithm": "ring"}]

JAX_CODE = """
import dataclasses, json
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.configs.registry import get_smoke_config
from repro.core import collectives
from repro.core.communicator import Communicator
from repro.core.config import CommConfig
from repro.core.topology import TorusSpec
from repro.launch import setup
from repro.optim import adamw
from repro.tune import config_from_dict

spec = json.loads(SPEC)
inp = np.load(spec["inputs"])
devs = np.array(jax.devices())
out = {}

def hier(mesh, axes, inner, outer, cfg, x):
    fn = compat.shard_map(
        lambda xs: collectives.hierarchical_all_reduce(
            xs[0], inner, outer, cfg)[None],
        mesh=mesh, in_specs=P(axes), out_specs=P(axes), check_vma=False)
    return np.asarray(jax.jit(fn)(x))

pod = Mesh(devs.reshape(2, 4), ("pod", "data"))
ci = Communicator.from_mesh(pod, "data")
co = Communicator.from_mesh(pod, "pod")
io = Mesh(devs.reshape(4, 2), ("inner", "outer"))
inner_torus = Communicator.from_mesh(io, "inner").with_topology(
    TorusSpec((2, 2)))
outer = Communicator.from_mesh(io, "outer")
for s, shape in enumerate(spec["shapes"]):
    x = inp[f"x{s}"]
    for c, d in enumerate(spec["cfgs"]):
        cfg = config_from_dict(d)
        out[f"hier/{s}/{c}"] = hier(pod, ("pod", "data"), ci, co, cfg, x)
        out[f"torus/{s}/{c}"] = hier(io, ("inner", "outer"), inner_torus,
                                     outer, cfg, x)

batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
bspec = {"tokens": P(("pod", "data")), "labels": P(("pod", "data"))}
mesh = Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))

def flat(tree, prefix):
    return {prefix + "/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}

for arch in spec["archs"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    oc = adamw.OptConfig(zero1=True, **spec["oc"])
    sess = setup.build_session(cfg, mesh, CommConfig(), oc=oc)
    out.update(flat(sess.params, f"{arch}/param0/"))
    step = setup.make_sharded_train_step(sess, donate=False)(bspec)
    p, o, m = step(sess.params, sess.opt_state, batch)
    out.update(flat(p, f"{arch}/param1/"))
    out[f"{arch}/loss"] = np.asarray(m["loss"])
    out[f"{arch}/grad_norm"] = np.asarray(m["grad_norm"])
    out[f"{arch}/m_slice"] = np.asarray(jax.device_get(o["m_slice"]))
np.savez(spec["out"], **out)
print("JAX POD OK", len(out))
"""


def _inputs():
    rng = np.random.RandomState(3)
    out = {f"x{s}": rng.randn(8, *shape).astype(np.float32)
           for s, shape in enumerate(SHAPES)}
    vocab = get_smoke_config("qwen3-8b").vocab_size
    assert vocab == get_smoke_config("mamba2-130m").vocab_size
    out["tokens"] = rng.randint(0, vocab, (B, S)).astype(np.int32)
    out["labels"] = rng.randint(0, vocab, (B, S)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod_ref")
    np.savez(d / "inputs.npz", **_inputs())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "shapes": SHAPES, "cfgs": CFGS, "archs": ARCHS, "oc": OC}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX POD OK" in out
    return dict(np.load(d / "ref.npz"))


def _tree(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _leaves(tree):
    return [("/".join(n), t) for n, t in adamw.leaves_with_names(tree)]


# ----------------------------------------------------------------------
# hierarchical_all_reduce
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s", range(len(SHAPES)))
def test_hierarchical_all_reduce_matches_jax(ref, s):
    """On ``(pod 2, data 4)`` (inner = data, outer = pod) and on ``(inner 4,
    outer 2)`` with the inner groups placed on a 2x2 torus, under four
    configs: the JAX package's result within 1e-5, the plain sum within
    1e-5, and the torus run bitwise equal to the flat one."""
    x = torch.from_numpy(_inputs()[f"x{s}"])
    pod = sweep._BenchMesh(("pod", "data"), (2, 4))
    ci, co = (Communicator.from_mesh(pod, "data"),
              Communicator.from_mesh(pod, "pod"))
    io = sweep._BenchMesh(("inner", "outer"), (4, 2))
    inner = Communicator.from_mesh(io, "inner")
    inner_torus = dataclasses.replace(inner, topo=TorusSpec((2, 2)))
    outer = Communicator.from_mesh(io, "outer")
    total = x.double().sum(0).float().expand_as(x).numpy()
    for c, d in enumerate(CFGS):
        cfg = tune.config_from_dict(d)
        got = collectives.hierarchical_all_reduce(x, ci, co, cfg)
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), ref[f"hier/{s}/{c}"],
                                   rtol=HIER_TOL, atol=HIER_TOL)
        np.testing.assert_allclose(got.numpy(), total, rtol=HIER_TOL,
                                   atol=HIER_TOL)
        flat = collectives.hierarchical_all_reduce(x, inner, outer, cfg)
        torus = collectives.hierarchical_all_reduce(x, inner_torus, outer,
                                                    cfg)
        assert torch.equal(flat, torus), d
        np.testing.assert_allclose(torus.numpy(), ref[f"torus/{s}/{c}"],
                                   rtol=HIER_TOL, atol=HIER_TOL)


def test_hierarchical_search_space_matches_jax():
    for fast in (True, False):
        for objective in ("latency", "e2e"):
            got = [tune.config_to_dict(c) for c in tune.enumerate_configs(
                "hierarchical_all_reduce", fast=fast, objective=objective)]
            want = [jax_tune.config_to_dict(c)
                    for c in jax_tune.enumerate_configs(
                        "hierarchical_all_reduce", fast=fast,
                        objective=objective)]
            assert got == want
    assert "hierarchical_all_reduce" in sweep.SWEEPABLE


def test_hierarchical_sweep_skips_odd_rank_counts():
    logs = []
    db = sweep.run_sweep(5, collectives=("hierarchical_all_reduce",),
                         sizes=(1024,), fast=True, device="cpu",
                         log=logs.append, timer=lambda *a, **kw: 1e-6)
    assert len(db) == 0 and any("skipped" in line for line in logs)


# ----------------------------------------------------------------------
# Meshes
# ----------------------------------------------------------------------

def test_pod_meshes():
    m = mesh_mod.make_test_mesh(2, 2, pod=2)
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    assert (m.dp, m.tp, m.n_ranks) == (4, 2, 8)
    p = mesh_mod.make_production_mesh(multi_pod=True)
    assert p.shape == {"pod": 2, "data": 16, "model": 16}
    assert p.n_ranks == 512
    rt = setup.build_session(get_smoke_config("qwen3-8b"), m, CommConfig(),
                             device="cpu").rt
    dp = rt.dp_comm()
    assert (dp.axis_names, dp.size, dp.n_groups) == (("pod", "data"), 4, 2)
    assert rt.tp_comm().n_groups == 4


# ----------------------------------------------------------------------
# A ZeRO-1 step on (pod, data, model)
# ----------------------------------------------------------------------

def _session(ref, arch, mesh):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    sess = setup.build_session(cfg, mesh, CommConfig(),
                               oc=adamw.OptConfig(zero1=True, **OC),
                               device="cpu")
    sess.params = sharding.from_reference(
        _tree(ref, f"{arch}/param0/"), cfg, mesh.tp, "cpu", dp=mesh.dp)
    return sess


def _step(sess):
    inp = _inputs()
    batch = {"tokens": inp["tokens"], "labels": inp["labels"]}
    step = setup.make_sharded_train_step(sess, donate=False)
    p, o, m = step(sess.params, sess.opt_state, batch)
    return p, o, m


def _change_errors(start, got, want) -> dict:
    """Each leaf's change over the step against another run's, over the
    other's largest change."""
    out = {}
    for (n, p0), (_, g), (_, w) in zip(_leaves(start), _leaves(got),
                                       _leaves(want)):
        p0, g, w = (torch.as_tensor(np.asarray(t)) for t in (p0, g, w))
        assert tuple(g.shape) == tuple(w.shape), n
        moved = float((w - p0).abs().max())
        assert moved > 0, n
        out[n] = float(((g - p0) - (w - p0)).abs().max()) / moved
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_pod_step_matches_jax(ref, arch):
    sess = _session(ref, arch, mesh_mod.make_test_mesh(2, 2, pod=2))
    p, o, m = _step(sess)
    tol = GRAD_TOL[arch]
    assert abs(float(m["loss"]) - float(ref[f"{arch}/loss"])) < LOSS_TOL
    want_norm = float(ref[f"{arch}/grad_norm"])
    assert abs(float(m["grad_norm"]) - want_norm) < tol * want_norm
    glob = setup.global_opt_state(sess, o)["m_slice"].numpy()
    want = ref[f"{arch}/m_slice"]
    assert glob.shape == want.shape == (2, 2, o["m_slice"].shape[1])
    assert np.abs(glob - want).max() < tol * np.abs(want).max()
    errs = _change_errors(_tree(ref, f"{arch}/param0/"),
                          setup.global_params(sess, p),
                          _tree(ref, f"{arch}/param1/"))
    assert max(errs.values()) < tol, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_step_equals_the_flat_data_step(ref, arch):
    """The same mean gradient over the same four data ranks: ``(pod 2, data
    2, model 2)`` against ``(data 4, model 2)``; each pod's ZeRO-1 slices
    equal, bit for bit."""
    pod = _session(ref, arch, mesh_mod.make_test_mesh(2, 2, pod=2))
    flat = _session(ref, arch, mesh_mod.make_test_mesh(4, 2))
    p_pod, o_pod, m_pod = _step(pod)
    p_flat, _, m_flat = _step(flat)
    assert abs(float(m_pod["loss"]) - float(m_flat["loss"])) < LOSS_TOL
    errs = _change_errors(setup.global_params(flat),
                          setup.global_params(pod, p_pod),
                          setup.global_params(flat, p_flat))
    assert max(errs.values()) < GRAD_TOL[arch], errs
    for key in ("m_slice", "v_slice"):
        rows = o_pod[key].view(2, 4, -1)
        assert torch.equal(rows[0], rows[1]), key


def test_zero1_slices_round_trip_under_pods():
    """``global_slices`` and ``stacked_slices`` are each other's inverse on
    ``(pod 2, data 2, model 2)``: stacked rows ``(P, k)``, pod-replicated,
    to the global ``(tp, dp, k)`` and back."""
    rt = setup.build_session(get_smoke_config("qwen3-8b"),
                             mesh_mod.make_test_mesh(2, 2, pod=2),
                             CommConfig(), device="cpu").rt
    glob = torch.randn(2, 2, 5)
    stacked = adamw.stacked_slices(glob, rt)
    assert stacked.shape == (8, 5)
    assert torch.equal(stacked[:4], stacked[4:])        # one copy a pod
    # row p holds data rank (p // tp) % dp of model shard p % tp
    for p in range(8):
        assert torch.equal(stacked[p], glob[p % 2, (p // 2) % 2])
    assert torch.equal(adamw.global_slices(stacked, rt), glob)
    assert torch.equal(adamw.stacked_slices(
        adamw.global_slices(stacked, rt), rt), stacked)


def test_pod_mesh_checkpoint_round_trips(ref, tmp_path):
    """A pod-mesh session's params and ZeRO-1 state after a step leave in
    the JAX package's global layout and come back exactly."""
    sess = _session(ref, "qwen3-8b", mesh_mod.make_test_mesh(2, 2, pod=2))
    sess.params, sess.opt_state, _ = _step(sess)
    glob = setup.global_opt_state(sess)
    assert tuple(glob["m_slice"].shape) == (
        2, 2, sess.opt_state["m_slice"].shape[1])
    emergency_save(tmp_path, 1, setup.global_params(sess), opt_state=glob)
    params = Checkpointer(tmp_path).restore(
        1, setup.global_params(sess),
        reshard=lambda t: setup.stacked_params(sess, t))
    state = Checkpointer(tmp_path / "opt").restore(
        1, glob, reshard=lambda t: setup.stacked_opt_state(sess, t))
    for (n, a), (_, b) in zip(adamw.leaves_with_names(params),
                              adamw.leaves_with_names(sess.params)):
        assert torch.equal(a, b), n
    for key in ("m_slice", "v_slice"):
        assert torch.equal(state[key], sess.opt_state[key]), key
    assert int(state["step"]) == 1
