"""Megatron-SP and remat policy "dots" in the port against the JAX
package's, on the CPU.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))``):
qwen3's smoke config (float32) at ``(2, 4)`` under ``seq_parallel`` and
under ``seq_parallel`` with FSDP: one step's gradients (model-synced, the
mean over the data ranks) and 3 ZeRO-1 AdamW steps.  The port takes the
JAX package's parameters through ``sharding.from_reference``.

Tolerances, the JAX package's own (``tests/test_distributed_parity.py``):
gradients within 1e-4 of each leaf's max|grad|; after 3 steps the loss
within 5e-4 and every parameter leaf within 8e-3 of its max.  The four
SP functions are held to hand-derived cotangents exactly (integer-valued
inputs, so every sum is exact in any order); "dots" to "full" and to no
remat bit for bit.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from helpers import run_multidevice

from repro_torch.configs import get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.config import CommConfig
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.models import attention, layers, sharding, transformer
from repro_torch.models.common import MeshContext, Runtime
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

CFG = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=torch.float32)
OC = dict(lr=1e-2, warmup_steps=1, total_steps=100)
B, S, STEPS = 4, 32, 3
GRAD_TOL, LOSS_TOL, PARAM_REL = 1e-4, 5e-4, 8e-3
MODES = {"sp": dict(seq_parallel=True),
         "sp_fsdp": dict(seq_parallel=True, fsdp=True)}

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
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}

def flat(tree, prefix):
    return {prefix + "/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}

for mode, kw in spec["modes"].items():
    sess = setup.build_session(cfg, mesh, CommConfig(),
                               oc=adamw.OptConfig(zero1=True, **spec["oc"]),
                               **kw)
    out.update(flat(sess.params, f"{mode}/param0/"))
    rt = sess.rt
    lg = ts.make_loss_and_grad(rt)
    plan = rt.fsdp_plan or jax.tree.map(lambda _: -1, sess.params)

    def f(p, b, rt=rt, mask=sess.mask, plan=plan):
        loss, _, g = lg(p, b)
        g = ts.grad_model_sync(g, mask, rt)
        g = jax.tree.map(lambda x, c: x / rt.mesh.dp if c >= 0 else
                         collectives.all_reduce(x, rt.dp_comm(), rt.comm)
                         / rt.mesh.dp, g, plan)
        return collectives.all_reduce(loss, rt.dp_comm(),
                                      rt.comm) / rt.mesh.dp, g
    fn = jax.jit(compat.shard_map(f, mesh=mesh,
                                  in_specs=(sess.param_spec, bspec),
                                  out_specs=(P(), sess.param_spec),
                                  check_vma=False))
    loss, g = fn(sess.params, batch)
    out[f"{mode}/grad_loss"] = np.asarray(loss)
    out.update(flat(g, f"{mode}/grad/"))
    step = setup.make_sharded_train_step(sess, donate=False)(bspec)
    p, o = sess.params, sess.opt_state
    losses = []
    for _ in range(spec["steps"]):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    out[f"{mode}/losses"] = np.asarray(losses)
    out.update(flat(p, f"{mode}/param/"))
np.savez(spec["out"], **out)
print("JAX SP OK", len(out))
"""


def _batch():
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp_ref")
    np.savez(d / "inputs.npz", **_batch())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "modes": MODES, "oc": OC, "steps": STEPS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX SP OK" in out
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


def _session(ref, mode):
    mesh = mesh_mod.make_test_mesh(2, 4)
    sess = setup.build_session(CFG, mesh, CommConfig(),
                               oc=adamw.OptConfig(zero1=True, **OC),
                               device="cpu", **MODES[mode])
    sess.params = sharding.from_reference(
        _tree(ref, f"{mode}/param0/"), CFG, 4, "cpu", dp=2,
        fsdp_dp=2 if MODES[mode].get("fsdp") else 1)
    return sess


def _max_rel(got, want) -> dict:
    out = {}
    for (n, g), (_, w) in zip(_leaves(got), _leaves(want)):
        w = torch.as_tensor(np.asarray(w))
        assert tuple(g.shape) == tuple(w.shape), n
        out[n] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                  1e-12)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_sp_grads_match_jax(ref, mode):
    """One step's gradients at (2, 4) under SP (and FSDP), model-synced
    (the block norms summed over the model axis) and the mean over the
    data ranks, against the JAX package's."""
    sess = _session(ref, mode)
    rt = sess.rt
    assert transformer.use_seq_parallel(rt, S)
    loss, _, grads = ts.make_loss_and_grad(rt)(
        sess.params, setup.shard_batch(sess, _batch()))
    grads = ts.grad_model_sync(grads, sess.mask, rt)
    dpf = torch.tensor(2.0)
    grads = adamw._unflatten(grads, [
        g / dpf if sharding._code(rt.fsdp_plan, n) >= 0 else
        adamw.leaf_all_reduce(g, n, rt.dp_comm(), rt.comm) / dpf
        for n, g in adamw.leaves_with_names(grads)])
    loss = collectives.all_reduce(loss, rt.dp_comm(), rt.comm) / dpf
    assert abs(float(loss[0]) - float(ref[f"{mode}/grad_loss"])) < 1e-5
    errs = _max_rel(setup.global_params(sess, grads),
                    _tree(ref, f"{mode}/grad/"))
    assert max(errs.values()) < GRAD_TOL, errs


@pytest.mark.parametrize("mode", list(MODES))
def test_sp_steps_match_jax(ref, mode):
    """Three ZeRO-1 AdamW steps at (2, 4) under SP (and FSDP): losses
    within 5e-4, parameters within 8e-3 of each leaf's max."""
    sess = _session(ref, mode)
    step = setup.make_sharded_train_step(sess, donate=False)
    p, o, losses = sess.params, sess.opt_state, []
    for _ in range(STEPS):
        p, o, m = step(p, o, _batch())
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref[f"{mode}/losses"], atol=LOSS_TOL,
                               rtol=0)
    assert losses[-1] < losses[0]
    errs = _max_rel(setup.global_params(sess, p), _tree(ref,
                                                        f"{mode}/param/"))
    assert max(errs.values()) < PARAM_REL, errs


# ----------------------------------------------------------------------
# The four SP functions against hand-derived cotangents
# ----------------------------------------------------------------------

def _ints(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-8, 9, shape, generator=g).float()


@pytest.mark.parametrize("fn", ["sp_shard_seq", "sp_all_gather",
                                "sp_unshard_seq", "sp_reduce_scatter"])
def test_sp_functions_give_the_jax_cotangents(fn):
    """On a (2, 4) stack, sequence length 8 (2 a model rank):
    ``sp_shard_seq`` slices, its backward all-gathers; ``sp_all_gather``
    all-gathers, its backward sums the cotangents' slices over the model
    group; ``sp_unshard_seq`` all-gathers, its backward slices;
    ``sp_reduce_scatter`` sums the slices, its backward all-gathers."""
    rt = Runtime(cfg=CFG, mesh=MeshContext.stacked(4, 2), comm=CommConfig())
    L, n = 2, 4
    full = fn in ("sp_shard_seq", "sp_reduce_scatter")
    x = _ints((8, 2, 8 if full else L, 3), 0).requires_grad_(True)
    y = getattr(layers, fn)(x, rt)
    ct = _ints(tuple(y.shape), 1)
    (dx,) = torch.autograd.grad(y, x, ct)
    xd = x.detach()

    def group(p):
        return [p - p % n + q for q in range(n)]

    def piece(t, p):
        m = p % n
        return t[:, m * L:(m + 1) * L]
    for p in range(8):
        if fn == "sp_shard_seq":
            want_y, want_dx = piece(xd[p], p), torch.cat(
                [ct[q] for q in group(p)], dim=1)
        elif fn == "sp_all_gather":
            want_y = torch.cat([xd[q] for q in group(p)], dim=1)
            want_dx = sum(piece(ct[q], p) for q in group(p))
        elif fn == "sp_unshard_seq":
            want_y = torch.cat([xd[q] for q in group(p)], dim=1)
            want_dx = piece(ct[p], p)
        else:
            want_y = sum(piece(xd[q], p) for q in group(p))
            want_dx = torch.cat([ct[q] for q in group(p)], dim=1)
        assert torch.equal(y[p].detach(), want_y), p
        assert torch.equal(dx[p], want_dx), p


def test_sp_applies_where_the_jax_package_applies_it():
    """SP runs only for the dense family, with q heads sharded and the
    sequence divisible by tp; elsewhere the plain block runs (no error);
    the gradient mask sums the block norms exactly when it runs, as the
    JAX package's does (shapes only, in-process)."""
    import jax
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.models import sharding as jax_sharding, transformer as jax_tf

    mesh = mesh_mod.make_test_mesh(2, 4)
    for arch in ("qwen3-8b", "mamba2-130m"):
        cfg = get_smoke_config(arch)
        rt = Runtime(cfg=cfg, mesh=mesh, comm=CommConfig(),
                     seq_parallel=True)
        assert transformer.use_seq_parallel(rt, 32) == (arch == "qwen3-8b")
        jcfg = jax_smoke(arch)
        shapes = jax.eval_shape(functools.partial(
            jax_tf.init_model, cfg=jcfg, tp=4), jax.random.PRNGKey(0))
        for sp in (False, True):
            want = jax_sharding.grad_model_sum_mask(shapes, jcfg, 4,
                                                    seq_parallel=sp)
            got = sharding.grad_model_sum_mask(
                transformer.init_model(0, cfg, 4, "cpu"), cfg, 4,
                seq_parallel=sp)
            assert got == jax.tree_util.tree_map(int, want), (arch, sp)
    rt = Runtime(cfg=CFG, mesh=mesh, comm=CommConfig(), seq_parallel=True)
    assert not transformer.use_seq_parallel(rt, 30)       # 30 % 4
    assert not transformer.use_seq_parallel(
        dataclasses.replace(rt, seq_parallel=False), 32)
    one = Runtime(cfg=CFG, mesh=mesh_mod.make_test_mesh(8, 1),
                  comm=CommConfig(), seq_parallel=True)
    assert not transformer.use_seq_parallel(one, 32)
    assert attention.attn_dims(CFG, 4).q_sharded


# ----------------------------------------------------------------------
# Remat policy "dots"
# ----------------------------------------------------------------------

class _CountWeightProducts(TorchDispatchMode):
    """Counts the matmuls issued under ``layers.weight_product``."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if layers.in_weight_product() and func.overloadpacket in (
                torch.ops.aten.bmm, torch.ops.aten.mm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads(arch, remat, policy, counter=None):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                              remat=remat, remat_policy=policy)
    kw = (dict(fsdp=True, seq_parallel=True) if arch == "qwen3-8b"
          else dict(fsdp=True))
    sess = setup.build_session(cfg, mesh_mod.make_test_mesh(2, 4),
                               CommConfig(), oc=adamw.OptConfig(),
                               device="cpu", **kw)
    stacked = setup.shard_batch(sess, _batch())
    leaves = [p.detach().requires_grad_(True)
              for _, p in adamw.leaves_with_names(sess.params)]
    tracked = adamw._unflatten(sess.params, leaves)
    with torch.enable_grad():
        loss, _ = transformer.loss_fn(tracked, stacked, sess.rt)
        if counter is None:
            grads = torch.autograd.grad(loss.sum(), leaves)
        else:
            with counter:
                grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-130m"])
def test_remat_dots_is_bitwise_full_and_none(arch, monkeypatch):
    """Remat "dots" (qwen3 under FSDP + SP, mamba2 under FSDP, at (2, 4))
    gives the loss and gradients of "full" and of no remat, bit for bit;
    the attention or SSD core runs again in the backward under both
    policies (the kernels stay recomputed), and under "dots" the backward
    recomputes no weight product (each is served from what the forward
    kept), where "full" recomputes them."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    mod, name = ((fa_ops, "flash_attention") if arch == "qwen3-8b"
                 else (ssd_ops, "ssd_chunked"))
    calls = {"n": 0}
    real = getattr(mod, name)

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(mod, name, counted)
    n_layers = get_smoke_config(arch).n_layers
    runs, recomputed = {}, {}
    for label, remat, policy in (("none", False, "full"),
                                 ("full", True, "full"),
                                 ("dots", True, "dots")):
        calls["n"] = 0
        counter = _CountWeightProducts()
        runs[label] = _grads(arch, remat, policy, counter)
        recomputed[label] = counter.n
        assert calls["n"] == n_layers * (1 if label == "none" else 2), label
    for label in ("full", "dots"):
        assert torch.equal(runs[label][0], runs["none"][0]), label
        for a, b in zip(runs[label][1], runs["none"][1]):
            assert torch.equal(a, b), label
    assert recomputed["none"] == recomputed["dots"] == 0, recomputed
    assert recomputed["full"] >= 4 * n_layers, recomputed
