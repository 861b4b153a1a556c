"""The port's training path (qwen3 smoke config, float32) against the JAX
package's, on the CPU.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:n]).reshape(dp, tp), ("data", "model"))``):
it initialises the parameters, takes one step's gradients at ``(1, 1)``
and ``(2, 4)`` (model-synced and averaged over the data axis, as plain
AdamW consumes them), and runs 3 AdamW steps on one seeded batch at
``(1, 1)``, ``(2, 4)`` and ``(2, 2)`` with ZeRO-1 on and off, and with
``accum_steps=2``.  The port takes the same parameters through
``sharding.from_reference`` on the same meshes, stacked.

Tolerances, the JAX package's own (``tests/test_distributed_parity.py``):
gradients within 1e-4 of each leaf's max|grad| (its ``GRAD_TOL``); after 3
steps the loss within 5e-4 and every parameter leaf within 8e-3 of its
max|param|.  The stacked layouts are held to the single-rank run with the
same bounds, and the collectives' custom gradients to hand-derived
cotangents, exactly.
"""
import ast
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import REPO, run_multidevice

from repro_torch.configs import get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import (OVERLAPPED_CONFIG, CommConfig,
                                     Compression)
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.models import layers, sharding
from repro_torch.models.common import MeshContext, Runtime
from repro_torch.optim import adamw

CFG = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=torch.float32)
OC = dict(lr=1e-2, warmup_steps=1, total_steps=100)
B, S, STEPS = 4, 32, 3
GRAD_TOL = 1e-4
LOSS_TOL, PARAM_REL = 5e-4, 8e-3
GRAD_MESHES = [(1, 1), (2, 4)]
# (dp, tp, zero1, accum_steps)
STEP_CASES = [(1, 1, False, 1), (1, 1, True, 1), (2, 4, False, 1),
              (2, 4, True, 1), (2, 2, False, 1), (2, 2, True, 1),
              (1, 1, False, 2), (2, 2, True, 2)]

JAX_CODE = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.configs.registry import get_smoke_config
from repro.core import collectives
from repro.core.config import CommConfig
from repro.launch import setup
from repro.optim import adamw
from repro.train import train_step as ts

spec = json.loads(SPEC)
cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=jnp.float32)
inp = np.load(spec["inputs"])
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
bspec = {"tokens": P(("data",)), "labels": P(("data",))}

def mesh_of(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))

def flat(tree, prefix):
    return {prefix + "/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}

out = {}
for dp, tp in spec["grad_meshes"]:
    sess = setup.build_session(cfg, mesh_of(dp, tp), CommConfig(),
                               oc=adamw.OptConfig(zero1=False))
    if (dp, tp) == (1, 1):
        out.update(flat(sess.params, "param/"))
    rt = sess.rt
    lg = ts.make_loss_and_grad(rt)

    def f(p, b, rt=rt, mask=sess.mask):
        loss, _, g = lg(p, b)
        g = ts.grad_model_sync(g, mask, rt)
        if rt.mesh.dp > 1:
            g = jax.tree.map(lambda x: collectives.all_reduce(
                x, rt.dp_comm(), rt.comm) / rt.mesh.dp, g)
            loss = collectives.all_reduce(loss, rt.dp_comm(),
                                          rt.comm) / rt.mesh.dp
        return loss, g
    fn = jax.jit(compat.shard_map(f, mesh=sess.mesh,
                                  in_specs=(sess.param_spec, bspec),
                                  out_specs=(P(), sess.param_spec),
                                  check_vma=False))
    loss, g = fn(sess.params, batch)
    out[f"grad_loss/{dp}x{tp}"] = np.asarray(loss)
    out.update(flat(g, f"grad/{dp}x{tp}/"))
for dp, tp, zero1, accum in spec["step_cases"]:
    oc = adamw.OptConfig(zero1=zero1, **spec["oc"])
    sess = setup.build_session(cfg, mesh_of(dp, tp), CommConfig(), oc=oc)
    step = setup.make_sharded_train_step(sess, accum_steps=accum,
                                         donate=False)(bspec)
    p, o = sess.params, sess.opt_state
    losses = []
    for _ in range(spec["steps"]):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    key = f"step/{dp}x{tp}/{int(zero1)}/{accum}/"
    out[key + "losses"] = np.asarray(losses)
    out.update(flat(p, key + "param/"))
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


def _batch():
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)}


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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_ref")
    np.savez(d / "inputs.npz", **_batch())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "grad_meshes": GRAD_MESHES, "step_cases": STEP_CASES,
            "oc": OC, "steps": STEPS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX REF OK" in out
    return dict(np.load(d / "ref.npz"))


def _session(ref, dp, tp, **oc):
    sess = setup.build_session(CFG, mesh_mod.make_test_mesh(dp, tp),
                               CommConfig(), oc=adamw.OptConfig(**oc),
                               device="cpu")
    sess.params = sharding.from_reference(_tree(ref, "param/"), CFG, tp,
                                          "cpu", dp=dp)
    return sess


def _leaves(tree):
    return [(("/".join(n)), t) for n, t in adamw.leaves_with_names(tree)]


def _run_steps(sess, accum=1, steps=STEPS):
    step = setup.make_sharded_train_step(sess, accum_steps=accum)
    p, o = sess.params, sess.opt_state
    losses = []
    for _ in range(steps):
        p, o, m = step(p, o, _batch())
        losses.append(float(m["loss"]))
    return losses, setup.global_params(sess, p)


def _assert_params_close(got, want):
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        w = torch.as_tensor(np.asarray(w))
        assert tuple(g.shape) == tuple(w.shape), name
        err = float((g - w).abs().max() / (w.abs().max() + 1e-9))
        assert err < PARAM_REL, (name, err)


@pytest.mark.parametrize("dp,tp", GRAD_MESHES)
def test_grads_match_jax(ref, dp, tp):
    """One step's gradients (model-synced, averaged over data) against the
    JAX package's, each leaf within 1e-4 of its max|grad|."""
    sess = _session(ref, dp, tp, zero1=False)
    stacked = setup.shard_batch(sess, _batch())
    from repro_torch.train import train_step as ts
    loss, _, grads = ts.make_loss_and_grad(sess.rt)(sess.params, stacked)
    grads = ts.grad_model_sync(grads, sess.mask, sess.rt)
    if dp > 1:
        grads = adamw._unflatten(grads, [
            adamw.leaf_all_reduce(g, n, sess.rt.dp_comm(), sess.rt.comm) / dp
            for n, g in adamw.leaves_with_names(grads)])
        loss = collectives.all_reduce(loss, sess.rt.dp_comm(),
                                      sess.rt.comm) / dp
    assert abs(float(loss[0]) - float(ref[f"grad_loss/{dp}x{tp}"])) < 1e-5
    got = sharding.unshard_params(grads, CFG, tp)
    want = _tree(ref, f"grad/{dp}x{tp}/")
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        err = float(np.max(np.abs(g.numpy() - w)) / (np.abs(w).max() + 1e-12))
        assert err < GRAD_TOL, (name, err)


@pytest.mark.parametrize("dp,tp,zero1,accum", STEP_CASES)
def test_adamw_steps_match_jax(ref, dp, tp, zero1, accum):
    """Three AdamW steps on the same mesh as the JAX package: losses within
    5e-4, parameters within 8e-3 of each leaf's max."""
    sess = _session(ref, dp, tp, zero1=zero1, **OC)
    losses, params = _run_steps(sess, accum)
    key = f"step/{dp}x{tp}/{int(zero1)}/{accum}/"
    np.testing.assert_allclose(losses, ref[key + "losses"], atol=LOSS_TOL,
                               rtol=0)
    _assert_params_close(params, _tree(ref, key + "param/"))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("dp,tp", [(2, 4), (2, 2), (1, 4), (4, 1), (4, 2)])
def test_stacked_layouts_agree_with_one_rank(ref, dp, tp):
    """Every stacked (data, model) layout, ZeRO-1 on, against the
    single-rank run of the port, within the same bounds."""
    base_l, base_p = _run_steps(_session(ref, 1, 1, zero1=True, **OC))
    losses, params = _run_steps(_session(ref, dp, tp, zero1=True, **OC))
    np.testing.assert_allclose(losses, base_l, atol=LOSS_TOL, rtol=0)
    _assert_params_close(params, base_p)


# the int8 wire rounds every gradient element to one of 255 codes of its
# block's scale (~0.4 % of the block's max): the losses of 3 steps at lr
# 1e-2 move by ~1e-3, ten times less than they fall.  The parameters are
# not compared: Adam's first steps move every element with a nonzero
# gradient by ~lr whatever its size, and the wire rounds the smallest to 0
INT8_LOSS_TOL = 5e-3
INT8_NORM_REL = 1e-2


def test_zero1_int8_wire_trains():
    """ZeRO-1 over the int8 ring wire (the quant kernels' plain version
    here) at (2, 2): every step's loss within 5e-3 of the exact wire's, the
    global gradient norm (taken after the wire) within 1 %, and the loss
    falls."""
    batch = _batch()
    out = {}
    for name, gc in (("exact", None), ("int8", CommConfig(
            algorithm="ring", compression=Compression.INT8))):
        sess = setup.build_session(
            CFG, mesh_mod.make_test_mesh(2, 2), CommConfig(),
            oc=adamw.OptConfig(zero1=True, grad_comm=gc, **OC), device="cpu")
        step = setup.make_sharded_train_step(sess)
        p, o = sess.params, sess.opt_state
        losses, norms = [], []
        for _ in range(STEPS):
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = (losses, norms)
    np.testing.assert_allclose(out["int8"][0], out["exact"][0],
                               atol=INT8_LOSS_TOL, rtol=0)
    np.testing.assert_allclose(out["int8"][1], out["exact"][1],
                               rtol=INT8_NORM_REL)
    assert out["int8"][0][-1] < out["int8"][0][0] - 0.5


def test_overlapped_combine_differentiates_like_the_buffered_one():
    """The chunked overlapped row-parallel combine under autograd gives the
    buffered combine's loss and gradients, bitwise on the CPU."""
    from repro_torch.train import train_step as ts
    grads = {}
    for name, comm in (("buffered", CommConfig(mode="buffered")),
                       ("overlapped", OVERLAPPED_CONFIG)):
        sess = setup.build_session(CFG, mesh_mod.make_test_mesh(2, 4), comm,
                                   oc=adamw.OptConfig(zero1=False),
                                   device="cpu")
        stacked = setup.shard_batch(sess, _batch())
        loss, _, g = ts.make_loss_and_grad(sess.rt)(sess.params, stacked)
        grads[name] = (loss, adamw.leaves_with_names(g))
    assert torch.equal(grads["buffered"][0], grads["overlapped"][0])
    for (n, a), (_, b) in zip(grads["buffered"][1], grads["overlapped"][1]):
        assert torch.equal(a, b), n


def _rt(dp, tp, comm=CommConfig()):
    return Runtime(cfg=CFG, mesh=MeshContext.stacked(tp, dp), comm=comm)


@pytest.mark.parametrize("comm", [CommConfig(), CommConfig(algorithm="ring")],
                         ids=["native", "ring"])
def test_all_reduce_backward_is_the_identity(comm):
    """``out_p = sum_{q in group} x_q``: the cotangent passes through
    unchanged (replicated-output semantics), on a (2, 4) stack's model
    groups, for the native and the ring algorithm."""
    rt = _rt(2, 4, comm)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 3, 5, generator=g, requires_grad=True)
    ct = torch.randn(8, 3, 5, generator=g)
    out = collectives.all_reduce(x, rt.tp_comm(), comm)
    groups = x.detach().view(2, 4, 3, 5).sum(1, keepdim=True)
    torch.testing.assert_close(out.detach().view(2, 4, 3, 5),
                               groups.expand(2, 4, 3, 5))
    (dx,) = torch.autograd.grad(out, x, ct)
    assert torch.equal(dx, ct)


def test_tp_grad_sum_backward_sums_over_the_model_group():
    """Megatron's f: identity forward; the backward is each model group's
    sum of the cotangents, on every row of the group."""
    rt = _rt(2, 4)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 6, generator=g, requires_grad=True)
    ct = torch.randn(8, 6, generator=g)
    y = layers.tp_grad_sum(x, rt)
    assert torch.equal(y.detach(), x.detach())
    (dx,) = torch.autograd.grad(y, x, ct)
    want = ct.view(2, 4, 6).sum(1, keepdim=True).expand(2, 4, 6)
    torch.testing.assert_close(dx, want.reshape(8, 6))
    # disabled, or tp 1: the identity in both directions
    (dx1,) = torch.autograd.grad(layers.tp_grad_sum(x, rt, False), x, ct)
    assert torch.equal(dx1, ct)


def test_communicator_split_and_groups():
    """``from_mesh``/``split`` of a (data=2, model=4) stack: model groups are
    4 contiguous rows, data groups rows strided by 4; every collective acts
    on each group alone."""
    mesh = mesh_mod.make_test_mesh(2, 4)
    world = Communicator.from_mesh(mesh, ("data", "model"))
    assert world.size == 8 and world.n_groups == 1
    model, data = world.split("model"), world.split("data")
    assert (model.size, model.n_groups, data.size, data.n_groups) == (4, 2,
                                                                      2, 4)
    assert model.rank().tolist() == [0, 1, 2, 3, 0, 1, 2, 3]
    assert data.rank().tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    assert Communicator.from_mesh(mesh, "model") == model
    x = torch.arange(8 * 4, dtype=torch.float32).view(8, 4)
    cfg = CommConfig()
    rs = collectives.reduce_scatter(x, data, cfg)
    xv = x.view(2, 4, 4)
    want = (xv[0] + xv[1]).view(4, 2, 2)                 # (model, seg, k)
    assert torch.equal(rs.view(2, 4, 2), want.transpose(0, 1))
    ag = collectives.all_gather(rs, data, cfg, axis=0, tiled=True)
    assert torch.equal(ag.view(2, 4, 4)[0], (xv[0] + xv[1]))
    assert torch.equal(ag.view(2, 4, 4)[1], (xv[0] + xv[1]))
    ring = CommConfig(algorithm="ring")
    assert torch.equal(collectives.reduce_scatter(x, data, ring), rs)
    # a one-group mesh keeps the plain communicator (serving's)
    one = MeshContext.stacked(4)
    assert Communicator.from_mesh(one, "model") == Communicator(("model",),
                                                                (4,))


@pytest.mark.parametrize("axis", ["data", "model"])
def test_communicator_groups_put_results_on_their_rows(axis):
    """``groups`` puts each group's result on that group's rows, exactly as
    stacking the results (then the stacks) did, and autograd passes through
    it the same: ``fn`` gathers its group's rows to every rank of it, so
    the result is wider than the input."""
    mesh = mesh_mod.make_test_mesh(2, 4)
    comm = Communicator.from_mesh(mesh, ("data", "model")).split(axis)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 3, generator=g, requires_grad=True)

    def fn(v, c):
        return 2.0 * v.reshape(1, -1).expand(v.shape[0], -1)

    outer, n, inner = comm._layout()
    xv = x.reshape(outer, n, inner, 3)
    want = torch.stack([torch.stack([fn(xv[o, :, i], None)
                                     for i in range(inner)], dim=1)
                        for o in range(outer)]).reshape(8, 3 * n)
    got = comm.groups(x, fn)
    assert torch.equal(got, want)
    ct = torch.randn(got.shape, generator=g)
    (dg,), (dw,) = (torch.autograd.grad(t, x, ct) for t in (got, want))
    assert torch.equal(dg, dw)


def test_launch_mesh_constructors():
    m = mesh_mod.make_test_mesh(2, 4)
    assert (m.dp, m.tp, m.n_ranks, m.axis_names) == (2, 4, 8,
                                                     ("data", "model"))
    assert m.shape == {"data": 2, "model": 4}
    assert MeshContext.from_mesh(m) == m
    assert mesh_mod.make_production_mesh().n_ranks == 256
    pod = mesh_mod.make_test_mesh(2, 2, pod=2)
    assert pod.axis_names == ("pod", "data", "model")
    assert (pod.dp, pod.tp, pod.n_ranks) == (4, 2, 8)
    assert MeshContext.from_mesh(pod) == pod
    # FSDP builds, with the JAX package's plan (shapes only, in-process)
    import functools
    import jax
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.models import sharding as jax_sharding, transformer as jax_tf
    from repro.models.common import MeshContext as JaxMesh
    sess = setup.build_session(CFG, m, CommConfig(), oc=adamw.OptConfig(),
                               fsdp=True, device="cpu")
    jcfg = jax_smoke("qwen3-8b")
    shapes = jax.eval_shape(functools.partial(jax_tf.init_model, cfg=jcfg,
                                              tp=4), jax.random.PRNGKey(0))
    want = jax_sharding.build_fsdp_plan(shapes, jcfg, JaxMesh(
        model_size=4, data_sizes=(2,)))
    assert sess.rt.fsdp_plan == jax.tree_util.tree_map(int, want)
    assert any(c >= 0 for _, c in adamw.leaves_with_names(sess.rt.fsdp_plan))


def test_ssd_scan_autograd_on_the_cpu_is_the_plain_version():
    """On CPU tensors the SSD wrapper differentiates its plain version."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref
    g = torch.Generator().manual_seed(0)
    R, Bt, S_, H, P, N, chunk = 1, 1, 16, 2, 4, 4, 8
    x = torch.randn(R, Bt, S_, H, P, generator=g, requires_grad=True)
    dt = torch.rand(R, Bt, S_, H, generator=g)
    A = -torch.rand(R, H, generator=g)
    Bm = torch.randn(R, Bt, S_, 1, N, generator=g)
    Cm = torch.randn(R, Bt, S_, 1, N, generator=g)
    y, _ = ssd_ops.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    (dx,) = torch.autograd.grad(y.sum(), x)
    x2 = x.detach().requires_grad_(True)
    y2, _ = ssd_ref.ssd_chunked_ref(x2, dt, A, Bm, Cm, chunk)
    (dx2,) = torch.autograd.grad(y2.sum(), x2)
    assert torch.equal(dx, dx2)


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  "examples/train_lm_torch.py",
                                  "examples/swe_ab_torch.py"])
def test_scripts_import_no_jax_and_no_reference_package(path):
    """The card's scripts import nothing of JAX or of the JAX package (the
    port's modules are checked by ``test_torch_swe``)."""
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
