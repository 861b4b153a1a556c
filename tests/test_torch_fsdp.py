"""FSDP in the port (per-layer ZeRO-3 gather over the data axis) against
the JAX package's, on the CPU.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:n]).reshape(...), names)``): the FSDP plan
codes and the PartitionSpecs of qwen3-8b and mamba2-130m, smoke and full
width, at ``(2, 4)`` and ``(2, 2)`` (shapes only, ``jax.eval_shape``);
one step's gradients under FSDP at ``(2, 4)`` (model-synced, the mean over
the data ranks); and 3 ZeRO-1 AdamW steps with FSDP at ``(2, 4)`` and on
``(pod 2, data 2, model 2)``.  The port takes the JAX package's
parameters through ``sharding.from_reference`` on the same meshes,
stacked.  The plain route, whose data all-reduce would sum different
slices of an FSDP leaf (the JAX package's does), is refused.

Tolerances, the JAX package's own (``tests/test_distributed_parity.py``):
gradients within 1e-4 (qwen3) and 2e-3 (mamba2) of each leaf's
max|grad|; after 3 steps the loss within 5e-4 and every parameter leaf,
and the FSDP leaves' moments ``m_fsdp``/``v_fsdp``, within 8e-3 of its
max (mamba2 at Adam eps 1, a leaf that starts at zero held against 3 lr,
and its moments after the first step, where the two packages' runs have
not yet parted: ``tests/test_torch_train_ssm.py`` says why).  The
gather's custom gradient is held to hand-derived cotangents, exactly;
checkpoints and the elastic restore bit for bit.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.config import CommConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.models import sharding
from repro_torch.models.common import MeshContext, Runtime
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.faults import FaultInjector, FaultSchedule
from repro_torch.train import loop as loop_mod, train_step as ts

ARCHS = ("qwen3-8b", "mamba2-130m")
GRAD_TOL = {"qwen3-8b": 1e-4, "mamba2-130m": 2e-3}
LOSS_TOL, PARAM_REL = 5e-4, 8e-3
OC = {"qwen3-8b": dict(lr=1e-2, warmup_steps=1, total_steps=100),
      "mamba2-130m": dict(lr=1e-2, warmup_steps=1, total_steps=100,
                          eps=1.0)}
B, S, STEPS = 4, 32, 3
PLAN_MESHES = [(2, 4), (2, 2)]
# (arch, mesh axes' sizes, zero1)
STEP_CASES = [("qwen3-8b", (2, 4), True), ("mamba2-130m", (2, 4), True),
              ("qwen3-8b", (2, 2, 2), True), ("mamba2-130m", (2, 2, 2), True)]


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)


JAX_CODE = """
import dataclasses, functools, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.configs.registry import get_config, get_smoke_config
from repro.core import collectives
from repro.core.config import CommConfig
from repro.launch import setup
from repro.models import sharding, transformer
from repro.models.common import MeshContext
from repro.optim import adamw
from repro.train import train_step as ts

spec = json.loads(SPEC)
inp = np.load(spec["inputs"])
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
devs = np.array(jax.devices())
out = {}

def name(path):
    return "/".join(str(p.key) for p in path)

def flat(tree, prefix):
    return {prefix + name(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}

def entry(e):
    return list(e) if isinstance(e, tuple) else e

plans = {}
for arch in spec["archs"]:
    for width in ("smoke", "full"):
        cfg = get_smoke_config(arch) if width == "smoke" else get_config(arch)
        for dp, tp in spec["plan_meshes"]:
            mc = MeshContext(model_size=tp, data_sizes=(dp,))
            shapes = jax.eval_shape(functools.partial(
                transformer.init_model, cfg=cfg, tp=tp),
                jax.random.PRNGKey(0))
            codes = jax.tree.leaves(sharding.build_fsdp_plan(shapes, cfg, mc))
            specs = jax.tree.leaves(sharding.param_specs(shapes, cfg, mc,
                                                         fsdp=True),
                                    is_leaf=lambda x: isinstance(x, P))
            plans[f"{arch}/{width}/{dp}x{tp}"] = {
                name(path): {"shape": list(s.shape), "code": int(c),
                             "spec": [entry(e) for e in sp]}
                for (path, s), c, sp in zip(
                    jax.tree_util.tree_flatten_with_path(shapes)[0], codes,
                    specs)}
json.dump(plans, open(spec["plans"], "w"))

def mesh_of(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                         "model")
    return Mesh(devs[:int(np.prod(shape))].reshape(shape), names)

def bspec_of(mesh):
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return {"tokens": P(axes), "labels": P(axes)}

for arch in spec["archs"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    mesh = mesh_of((2, 4))
    sess = setup.build_session(cfg, mesh, CommConfig(),
                               oc=adamw.OptConfig(zero1=False), fsdp=True)
    out.update(flat(sess.params, f"{arch}/param/"))
    rt = sess.rt
    lg = ts.make_loss_and_grad(rt)

    def f(p, b, rt=rt, mask=sess.mask):
        loss, _, g = lg(p, b)
        g = ts.grad_model_sync(g, mask, rt)
        # FSDP leaves leave the gather's transpose summed over data
        g = jax.tree.map(lambda x, c: x / rt.mesh.dp if c >= 0 else
                         collectives.all_reduce(x, rt.dp_comm(), rt.comm)
                         / rt.mesh.dp, g, rt.fsdp_plan)
        return collectives.all_reduce(loss, rt.dp_comm(),
                                      rt.comm) / rt.mesh.dp, g
    fn = jax.jit(compat.shard_map(f, mesh=mesh,
                                  in_specs=(sess.param_spec, bspec_of(mesh)),
                                  out_specs=(P(), sess.param_spec),
                                  check_vma=False))
    loss, g = fn(sess.params, batch)
    out[f"{arch}/grad_loss"] = np.asarray(loss)
    out.update(flat(g, f"{arch}/grad/"))

for arch, shape, zero1 in spec["step_cases"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    mesh = mesh_of(tuple(shape))
    oc = adamw.OptConfig(zero1=zero1, **spec["oc"][arch])
    sess = setup.build_session(cfg, mesh, CommConfig(), oc=oc, fsdp=True)
    key = f"step/{arch}/{'x'.join(map(str, shape))}/{int(zero1)}/"
    out.update(flat(sess.params, key + "param0/"))
    step = setup.make_sharded_train_step(sess, donate=False)(bspec_of(mesh))
    p, o = sess.params, sess.opt_state
    losses = []
    for i in range(spec["steps"]):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
        if zero1 and i in (0, spec["steps"] - 1):
            for k in ("m_fsdp", "v_fsdp"):
                out.update(flat(o[k], key + f"{k}/{i + 1}/"))
    out[key + "losses"] = np.asarray(losses)
    out.update(flat(p, key + "param/"))
np.savez(spec["out"], **out)
print("JAX FSDP OK", len(out))
"""


def _batch():
    rng = np.random.RandomState(0)
    vocab = get_smoke_config("qwen3-8b").vocab_size
    assert vocab == get_smoke_config("mamba2-130m").vocab_size
    return {"tokens": rng.randint(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.randint(0, vocab, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_ref")
    np.savez(d / "inputs.npz", **_batch())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "plans": str(d / "plans.json"), "archs": ARCHS,
            "plan_meshes": PLAN_MESHES, "step_cases": STEP_CASES, "oc": OC,
            "steps": STEPS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX FSDP OK" in out
    res = dict(np.load(d / "ref.npz"))
    res["plans"] = json.loads((d / "plans.json").read_text())
    return res


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


def _mesh(shape):
    if len(shape) == 3:
        return mesh_mod.make_test_mesh(shape[1], shape[2], pod=shape[0])
    return mesh_mod.make_test_mesh(*shape)


def _session(ref, arch, mesh, prefix, zero1=True, **kw):
    cfg = _cfg(arch)
    sess = setup.build_session(cfg, mesh, CommConfig(),
                               oc=adamw.OptConfig(zero1=zero1, **OC[arch]),
                               device="cpu", fsdp=True, **kw)
    sess.params = sharding.from_reference(
        _tree(ref, prefix), cfg, mesh.tp, "cpu", dp=mesh.dp,
        fsdp_dp=mesh.data_sizes[-1])
    return sess


def _max_rel(got, want, floor=0.0) -> dict:
    out = {}
    for (n, g), (_, w) in zip(_leaves(got), _leaves(want)):
        w = torch.as_tensor(np.asarray(w))
        assert tuple(g.shape) == tuple(w.shape), n
        out[n] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                  floor, 1e-12)
    return out


# ----------------------------------------------------------------------
# The plan and the specs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("dp,tp", PLAN_MESHES)
def test_fsdp_plan_and_specs_match_jax(ref, arch, width, dp, tp):
    """``build_fsdp_plan``'s codes and ``param_specs(fsdp=True)`` equal the
    JAX package's, leaf for leaf, from shapes alone (meta tensors)."""
    want = ref["plans"][f"{arch}/{width}/{dp}x{tp}"]
    cfg = get_smoke_config(arch) if width == "smoke" else get_config(arch)
    shapes = _tree({k: torch.empty(v["shape"], device="meta")
                    for k, v in want.items()}, "")
    mesh = MeshContext.stacked(tp, dp)
    plan = dict(_leaves(sharding.build_fsdp_plan(shapes, cfg, mesh)))
    specs = dict(_leaves(sharding.param_specs(shapes, cfg, mesh, fsdp=True)))
    assert set(plan) == set(want)
    for n, w in want.items():
        assert plan[n] == w["code"], n
        assert specs[n] == tuple(tuple(e) if isinstance(e, list) else e
                                 for e in w["spec"]), n
    assert any(c >= 0 for c in plan.values())


def test_fsdp_layout_round_trips():
    """Row ``p`` of an FSDP leaf holds data rank ``(p // tp) % dp``'s slice
    of model shard ``p % tp`` (pods hold copies); ``unshard_params`` is the
    inverse of ``shard_params``."""
    cfg = get_smoke_config("qwen3-8b")
    mesh = mesh_mod.make_test_mesh(2, 2, pod=2)
    g = torch.Generator().manual_seed(0)
    D, F = cfg.d_model, cfg.d_ff
    full = {"layers": {"mlp": {"w_up": torch.randn(2, D, F, generator=g),
                               "w_down": torch.randn(2, F, D, generator=g)},
                       "ln1": torch.randn(2, D, generator=g)},
            "final_norm": torch.randn(D, generator=g)}
    plan = sharding.build_fsdp_plan(full, cfg, mesh)
    assert plan["layers"]["mlp"] == {"w_up": 2, "w_down": 2}
    assert plan["layers"]["ln1"] == plan["final_norm"] == -1
    st = sharding.shard_params(full, cfg, 2, dp=4, fsdp_dp=2)
    up, down = st["layers"]["mlp"]["w_up"], st["layers"]["mlp"]["w_down"]
    assert up.shape == (2, 8, D // 2, F // 2)
    assert down.shape == (2, 8, F // 4, D)
    for p in range(8):
        m, d = p % 2, (p // 2) % 2
        assert torch.equal(up[:, p], full["layers"]["mlp"]["w_up"][
            :, d * D // 2:(d + 1) * D // 2, m * F // 2:(m + 1) * F // 2])
        # ("model", "data"): model shards first, each cut over data
        k = m * 2 + d
        assert torch.equal(down[:, p], full["layers"]["mlp"]["w_down"][
            :, k * F // 4:(k + 1) * F // 4])
    back = sharding.unshard_params(st, cfg, 2, plan, 2)
    for (n, a), (_, b) in zip(_leaves(back), _leaves(full)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2)])
def test_fsdp_gather_cotangents_are_exact(shape):
    """``apply_fsdp``: row ``p`` gets the concatenation over its data group
    (the last data axis) of the shards, along the planned dim; the
    backward gives each shard the sum over its data group of the
    cotangent's slice it contributed, exactly."""
    cfg = _cfg("qwen3-8b")
    mesh = _mesh(shape)
    rt = Runtime(cfg=cfg, mesh=mesh, comm=CommConfig())
    P, tp, dp = mesh.n_ranks, mesh.tp, mesh.data_sizes[-1]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(P, 3, 5, 2, generator=g, requires_grad=True)
    ct = torch.randn(P, 3, 10, 2, generator=g)
    y = sharding.apply_fsdp({"w": x}, {"w": 103}, rt)["w"]
    (dx,) = torch.autograd.grad(y, x, ct)
    xd, want_dx = x.detach(), torch.zeros_like(x)
    for p in range(P):
        base = p - ((p // tp) % dp) * tp             # data rank 0 of p's group
        group = [base + d * tp for d in range(dp)]
        assert torch.equal(y[p].detach(), torch.cat([xd[q] for q in group],
                                                    dim=1))
        d = (p // tp) % dp
        want_dx[p] = sum(ct[q][:, d * 5:(d + 1) * 5] for q in group)
    assert torch.equal(dx, want_dx)
    # no FSDP on a one-rank data axis
    one = Runtime(cfg=cfg, mesh=mesh_mod.make_test_mesh(1, 4),
                  comm=CommConfig())
    assert sharding.apply_fsdp({"w": x}, {"w": 103}, one)["w"] is x


# ----------------------------------------------------------------------
# Gradients and steps against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_grads_match_jax(ref, arch):
    """One step's gradients under FSDP at (2, 4), model-synced and the mean
    over the data ranks (FSDP leaves divided by dp, the rest all-reduced
    first), against the JAX package's."""
    mesh = mesh_mod.make_test_mesh(2, 4)
    sess = _session(ref, arch, mesh, f"{arch}/param/")
    rt = sess.rt
    loss, _, grads = ts.make_loss_and_grad(rt)(
        sess.params, setup.shard_batch(sess, _batch()))
    grads = ts.grad_model_sync(grads, sess.mask, rt)
    dpf = torch.tensor(2.0)
    grads = adamw._unflatten(grads, [
        g / dpf if sharding._code(rt.fsdp_plan, n) >= 0 else
        adamw.leaf_all_reduce(g, n, rt.dp_comm(), rt.comm) / dpf
        for n, g in adamw.leaves_with_names(grads)])
    loss = collectives.all_reduce(loss, rt.dp_comm(), rt.comm) / dpf
    assert abs(float(loss[0]) - float(ref[f"{arch}/grad_loss"])) < 1e-5
    errs = _max_rel(setup.global_params(sess, grads),
                    _tree(ref, f"{arch}/grad/"))
    assert max(errs.values()) < GRAD_TOL[arch], errs


@pytest.mark.parametrize("arch,shape,zero1", STEP_CASES)
def test_fsdp_steps_match_jax(ref, arch, shape, zero1):
    """Three AdamW steps with FSDP on the JAX package's mesh: the losses
    within 5e-4, every parameter leaf within 8e-3 of its max, and under
    ZeRO-1 the FSDP leaves' moments within 8e-3 of theirs."""
    key = f"step/{arch}/{'x'.join(map(str, shape))}/{int(zero1)}/"
    sess = _session(ref, arch, _mesh(shape), key + "param0/", zero1=zero1)
    step = setup.make_sharded_train_step(sess, donate=False)
    # the moments are held after the last step for qwen3; mamba2's runs
    # part after the first (its gradient norm is 12.06 to 12.67 at step 2
    # on either package, tests/test_torch_train_ssm.py), so its moments,
    # gradient sums, are held after step 1
    at = STEPS if arch == "qwen3-8b" else 1
    p, o, losses = sess.params, sess.opt_state, []
    for i in range(STEPS):
        p, o, m = step(p, o, _batch())
        losses.append(float(m["loss"]))
        if i + 1 == at and zero1:
            glob = setup.global_opt_state(sess, o)
            for k in ("m_fsdp", "v_fsdp"):
                want = _tree(ref, key + f"{k}/{at}/")
                assert [n for n, _ in _leaves(glob[k])] == [
                    n for n, _ in _leaves(want)]
                errs = _max_rel(glob[k], want)
                assert max(errs.values()) < PARAM_REL, (k, errs)
    np.testing.assert_allclose(losses, ref[key + "losses"], atol=LOSS_TOL,
                               rtol=0)
    assert losses[-1] < losses[0]
    floor = STEPS * OC[arch]["lr"] if arch == "mamba2-130m" else 0.0
    errs = _max_rel(setup.global_params(sess, p), _tree(ref, key + "param/"),
                    floor)
    assert max(errs.values()) < PARAM_REL, errs
    if zero1:
        if len(shape) == 3:
            for k in ("m_fsdp", "v_fsdp"):
                for n, t in adamw.leaves_with_names(o[k]):
                    rows = t.movedim(1, 0).reshape(2, 4, -1)
                    assert torch.equal(rows[0], rows[1]), (k, n)


def test_fsdp_refuses_the_plain_route():
    """The plain route all-reduces every gradient over the data axis, which
    on a data-sharded FSDP leaf adds different slices' gradients: the
    session and the update refuse it.  At ``(1, 4)`` the plan shards
    nothing over data and the plain route builds."""
    cfg = _cfg("qwen3-8b")
    plain = adamw.OptConfig(zero1=False, **OC["qwen3-8b"])
    with pytest.raises(ValueError, match="ZeRO-1"):
        setup.build_session(cfg, _mesh((2, 4)), CommConfig(), oc=plain,
                            device="cpu", fsdp=True)
    sess = setup.build_session(cfg, _mesh((1, 4)), CommConfig(), oc=plain,
                               device="cpu", fsdp=True)
    assert all(c == -1 for _, c in adamw.leaves_with_names(sess.rt.fsdp_plan))
    assert "m" in sess.opt_state
    sess = setup.build_session(cfg, _mesh((2, 4)), CommConfig(),
                               device="cpu", fsdp=True)
    state = adamw.init_state(sess.params, plain, sess.rt)
    with pytest.raises(ValueError, match="ZeRO-1"):
        adamw.apply_updates(sess.params, sess.params, state, plain, sess.rt,
                            fsdp_plan=sess.rt.fsdp_plan)


# ----------------------------------------------------------------------
# Checkpoints, drain and resume, elastic restore
# ----------------------------------------------------------------------

def test_fsdp_checkpoint_equals_the_replicated_one(tmp_path):
    """An FSDP session saves full arrays in the JAX package's format: the
    same file as a replicated session's on the same weights; and
    ``elastic_restore(fsdp=True)`` onto (1, 4), where the plan is all -1,
    restores them bit for bit."""
    cfg = _cfg("qwen3-8b")
    oc = adamw.OptConfig(zero1=True, **OC["qwen3-8b"])
    mesh = mesh_mod.make_test_mesh(2, 4)
    fs = setup.build_session(cfg, mesh, CommConfig(), oc=oc, fsdp=True,
                             device="cpu")
    rep = setup.build_session(cfg, mesh, CommConfig(), oc=oc, device="cpu")
    Checkpointer(tmp_path / "fsdp").save(0, setup.global_params(fs))
    Checkpointer(tmp_path / "rep").save(0, setup.global_params(rep))
    with np.load(tmp_path / "fsdp" / "ckpt_00000000.npz") as a, \
            np.load(tmp_path / "rep" / "ckpt_00000000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for n in a.files:
            assert np.array_equal(a[n], b[n]), n
    # the stored shards are smaller than the replicated ones
    wq = fs.params["layers"]["attn"]["wq"]
    assert wq.shape[2] * 2 == rep.params["layers"]["attn"]["wq"].shape[2]
    sess, step = ft.elastic_restore(tmp_path / "fsdp", cfg,
                                    mesh_mod.make_test_mesh(1, 4),
                                    CommConfig(), oc, fsdp=True,
                                    device="cpu")
    assert step == 0
    assert all(c == -1 for _, c in adamw.leaves_with_names(
        sess.rt.fsdp_plan))
    for (n, a), (_, b) in zip(adamw.leaves_with_names(
            setup.global_params(sess)), adamw.leaves_with_names(
            setup.global_params(fs))):
        assert torch.equal(a, b), n


def test_fsdp_drain_and_resume_is_bitwise(tmp_path):
    """``preempt@2`` under FSDP + SP at (2, 4), ZeRO-1: the drain saves the
    params, the ZeRO-1 slices and the FSDP moments; a new session resumes
    from them and the joined loss stream is bitwise equal to the
    uninterrupted run's."""
    cfg = _cfg("qwen3-8b")
    oc = adamw.OptConfig(zero1=True, **OC["qwen3-8b"])
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)

    def fresh():
        return setup.build_session(cfg, mesh_mod.make_test_mesh(2, 4),
                                   CommConfig(), oc=oc, fsdp=True,
                                   seq_parallel=True, device="cpu")

    def loop(n, ck=None):
        return loop_mod.LoopConfig(n_steps=n, ckpt_every=100,
                                   ckpt_dir=None if ck is None else str(ck),
                                   log_every=100)
    want = loop_mod.train(fresh(), data, loop(4), log=lambda *_: None)
    ck = tmp_path / "ck"
    part1 = loop_mod.train(fresh(), data, loop(4, ck), log=lambda *_: None,
                           faults=FaultInjector(FaultSchedule.parse(
                               "preempt@2")))
    assert len(part1) == 2
    with np.load(ck / "opt" / "ckpt_00000002.npz") as z:
        assert any(n.startswith("m_fsdp/layers/") for n in z.files)
    sess, start = ft.resume_session(ck, fresh())
    assert start == 2
    part2 = loop_mod.train(sess, data, loop(2), log=lambda *_: None)
    assert part1 + part2 == want, (part1 + part2, want)
