"""The port's training path for the ssm family (mamba2's smoke config,
float32) against the JAX package's, on the CPU: the twin of
``tests/test_torch_train.py`` for qwen3.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:n]).reshape(dp, tp), ("data", "model"))``):
it initialises the parameters, takes one step's gradients at ``(1, 1)``,
``(2, 4)`` (8 heads, 2 per rank: sharded) and, with ``ssm_head_dim=64``,
at ``(1, 4)`` (2 heads do not divide over 4 ranks: every rank computes
them, replicated), and runs 3 AdamW steps on one seeded batch at ``(1,
1)`` and ``(2, 4)`` with ZeRO-1 on and off.  The port takes the same
parameters through ``sharding.from_reference`` on the same meshes,
stacked, and differentiates through the SSD scan's plain version (its
CUDA backward kernel is held against that on the card).

Tolerances, the JAX package's own (``tests/test_distributed_parity.py``):
gradients within 2e-3 of each leaf's max|grad|, its ``GRAD_TOL`` for
mamba2-130m ("SSD exp-path fp32 noise": qwen3's is 1e-4); after 3 steps the
loss within 5e-4 and every parameter leaf within 8e-3 of its max|param|
(at Adam eps 1, and for a leaf that starts at zero of 3 lr: see ``OC``);
and each leaf's change over the first step within 8e-3 of the JAX
package's change, so that a leaf left un-updated or a ZeRO-1 slice written
at the wrong offset fails (``test_adamw_step_check_catches_planted_faults``
plants both).  The change is held on the first step only: from the same
start the runs part after it (the global gradient norm is 9.1284 to 9.1296
at step 1 on either package and mesh, 12.06 to 12.67 at step 2, 5.64 to
6.93 at step 3), and after 3 steps even the JAX package's (1, 1) and (2, 4)
changes differ by up to 5 % of a leaf's largest change (dt_bias).
The noise is the model's, not a package's: against the port in float64,
the JAX package's f32 gradients sit 2.2e-4 to 7.0e-4 of each leaf's max
away, and the port's own f32 gradients 2.4e-4 to 5.1e-4 (embed, A_log and
every other leaf, at (1, 1)).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro_torch.configs import get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.config import CommConfig
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.models import sharding, ssm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

SMOKE = dataclasses.replace(get_smoke_config("mamba2-130m"),
                            dtype=torch.float32)
CFGS = {"sharded": SMOKE,
        "replicated": dataclasses.replace(SMOKE, ssm_head_dim=64)}
# test_torch_train.py's schedule with Adam's eps at 1 (the default is
# 1e-8).  Two f32 implementations of this model differ by ~2e-4 of each
# gradient leaf's max (both sit 2e-4 to 7e-4 from a float64 run), and at
# eps 1e-8 Adam's first steps move every element by +-lr on its gradient's
# sign: elements at that noise floor flip (one element of w_x after one
# step: the port's gradient 9.8e-8, the JAX package's -5.8e-7, leaf max
# 0.15), and after 3 steps the JAX package's own (1, 1) and (2, 4) runs sit
# up to 0.5 of a leaf's max apart (tests/test_distributed_parity.py asserts
# no post-optimizer parity for the ssm family for that reason).  At eps 1
# the update is the bias-corrected momentum over (sqrt(v) + 1): the same
# moments, weight decay, clipping and ZeRO-1 sharding, with noise moving a
# parameter by lr x noise instead of +-lr.  A leaf that starts at zero (the
# norms, dt_bias) is held to PARAM_REL of the most Adam can move it in the
# run, STEPS x lr, when that exceeds its max: after 3 steps its max is ~1e-4
# and the JAX package's own two meshes differ by up to 5e-2 of it
OC = dict(lr=1e-2, warmup_steps=1, total_steps=100, eps=1.0)
B, S, STEPS = 4, 32, 3
GRAD_TOL = 2e-3
LOSS_TOL, PARAM_REL = 5e-4, 8e-3
# (config, dp, tp)
GRAD_CASES = [("sharded", 1, 1), ("sharded", 2, 4), ("replicated", 1, 4)]
# (dp, tp, zero1), sharded heads
STEP_CASES = [(1, 1, False), (1, 1, True), (2, 4, False), (2, 4, True)]

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
smoke = dataclasses.replace(get_smoke_config("mamba2-130m"),
                            dtype=jnp.float32)
cfgs = {"sharded": smoke,
        "replicated": dataclasses.replace(smoke, ssm_head_dim=64)}
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
for name, dp, tp in spec["grad_cases"]:
    sess = setup.build_session(cfgs[name], mesh_of(dp, tp), CommConfig(),
                               oc=adamw.OptConfig(zero1=False))
    if (dp, tp) == (1, 1) or name == "replicated":
        out.update(flat(sess.params, f"param/{name}/"))
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
    key = f"{name}/{dp}x{tp}"
    out[f"grad_loss/{key}"] = np.asarray(loss)
    out.update(flat(g, f"grad/{key}/"))
for dp, tp, zero1 in spec["step_cases"]:
    oc = adamw.OptConfig(zero1=zero1, **spec["oc"])
    sess = setup.build_session(smoke, mesh_of(dp, tp), CommConfig(), oc=oc)
    step = setup.make_sharded_train_step(sess, donate=False)(bspec)
    p, o = sess.params, sess.opt_state
    losses = []
    key = f"step/{dp}x{tp}/{int(zero1)}/"
    for i in range(spec["steps"]):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            out.update(flat(p, key + "param1/"))
    out[key + "losses"] = np.asarray(losses)
    out.update(flat(p, key + "param/"))
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


def _batch():
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, SMOKE.vocab_size, (B, S)).astype(
                np.int32),
            "labels": rng.randint(0, SMOKE.vocab_size, (B, S)).astype(
                np.int32)}


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
    d = tmp_path_factory.mktemp("train_ssm_ref")
    np.savez(d / "inputs.npz", **_batch())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "grad_cases": GRAD_CASES, "step_cases": STEP_CASES, "oc": OC,
            "steps": STEPS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX REF OK" in out
    return dict(np.load(d / "ref.npz"))


def _session(ref, name, dp, tp, **oc):
    cfg = CFGS[name]
    sess = setup.build_session(cfg, mesh_mod.make_test_mesh(dp, tp),
                               CommConfig(), oc=adamw.OptConfig(**oc),
                               device="cpu")
    sess.params = sharding.from_reference(_tree(ref, f"param/{name}/"), cfg,
                                          tp, "cpu", dp=dp)
    return sess


def _leaves(tree):
    return [("/".join(n), t) for n, t in adamw.leaves_with_names(tree)]


@pytest.mark.parametrize("name,dp,tp", GRAD_CASES)
def test_grads_match_jax(ref, name, dp, tp):
    """One step's gradients (model-synced, averaged over data) against the
    JAX package's, each leaf within GRAD_TOL (2e-3) of its max|grad|:
    heads sharded over the model axis, and replicated on every rank."""
    cfg = CFGS[name]
    assert ssm.ssm_dims(cfg, tp)[1] == (name == "sharded" and tp > 1)
    sess = _session(ref, name, dp, tp, zero1=False)
    stacked = setup.shard_batch(sess, _batch())
    loss, _, grads = ts.make_loss_and_grad(sess.rt)(sess.params, stacked)
    grads = ts.grad_model_sync(grads, sess.mask, sess.rt)
    if dp > 1:
        grads = adamw._unflatten(grads, [
            adamw.leaf_all_reduce(g, n, sess.rt.dp_comm(), sess.rt.comm) / dp
            for n, g in adamw.leaves_with_names(grads)])
        loss = collectives.all_reduce(loss, sess.rt.dp_comm(),
                                      sess.rt.comm) / dp
    key = f"{name}/{dp}x{tp}"
    assert abs(float(loss[0]) - float(ref[f"grad_loss/{key}"])) < 1e-5
    got = sharding.unshard_params(grads, cfg, tp)
    want = _tree(ref, f"grad/{key}/")
    assert len(_leaves(got)) == len(_leaves(want))
    for (n, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert tuple(g.shape) == tuple(np.shape(w)), n
        err = float(np.max(np.abs(g.numpy() - w)) / (np.abs(w).max() + 1e-12))
        assert err < GRAD_TOL, (n, err)


def _run_steps(ref, dp, tp, zero1):
    """STEPS AdamW steps of the port from the JAX package's initial
    parameters: (losses, global parameters after the first step, after the
    last)."""
    sess = _session(ref, "sharded", dp, tp, zero1=zero1, **OC)
    step = setup.make_sharded_train_step(sess)
    p, o = sess.params, sess.opt_state
    losses, first = [], None
    for _ in range(STEPS):
        p, o, m = step(p, o, _batch())
        losses.append(float(m["loss"]))
        if first is None:
            first = adamw.tree_map(torch.clone, setup.global_params(sess, p))
    return losses, first, setup.global_params(sess, p)


def _step1_change_errors(ref, key, first) -> dict:
    """Each leaf's change over the first step against the JAX package's,
    both from the same start: max|(p_1 - p_0) - (w_1 - w_0)| over
    max|w_1 - w_0|."""
    start = _leaves(_tree(ref, "param/sharded/"))
    want = _leaves(_tree(ref, key + "param1/"))
    got = _leaves(first)
    assert [n for n, _ in got] == [n for n, _ in want] == \
        [n for n, _ in start]
    out = {}
    for (n, g), (_, w), (_, p0) in zip(got, want, start):
        w, p0 = torch.as_tensor(np.asarray(w)), torch.as_tensor(
            np.asarray(p0))
        assert tuple(g.shape) == tuple(w.shape), n
        moved = float((w - p0).abs().max())
        assert moved > 0, n                 # every leaf moves in one step
        out[n] = float((g - w).abs().max()) / moved
    return out


def _step_errors(ref, dp, tp, zero1, runs) -> dict:
    """What the step comparison finds wrong in ``runs`` (a
    :func:`_run_steps` result): the losses, the leaves whose first-step
    change or final value is out of bounds."""
    losses, first, last = runs
    key = f"step/{dp}x{tp}/{int(zero1)}/"
    bad = {}
    loss_err = float(np.max(np.abs(np.asarray(losses)
                                   - ref[key + "losses"])))
    if not loss_err < LOSS_TOL:
        bad["losses"] = loss_err
    for n, e in _step1_change_errors(ref, key, first).items():
        if not e < PARAM_REL:
            bad["step 1 change of " + n] = e
    for (n, g), (_, w) in zip(_leaves(last),
                              _leaves(_tree(ref, key + "param/"))):
        w = torch.as_tensor(np.asarray(w))
        assert tuple(g.shape) == tuple(w.shape), n
        scale = max(float(w.abs().max()), STEPS * OC["lr"])
        err = float((g - w).abs().max()) / scale
        if not err < PARAM_REL:
            bad["after the last step, " + n] = err
    return bad


@pytest.mark.parametrize("dp,tp,zero1", STEP_CASES)
def test_adamw_steps_match_jax(ref, dp, tp, zero1):
    """Three AdamW steps on the same mesh as the JAX package, ZeRO-1 on and
    off: losses within 5e-4; each parameter leaf's change over the first
    step within 8e-3 of the JAX package's change (its max over the leaf),
    and after the last step within 8e-3 of the leaf's max."""
    runs = _run_steps(ref, dp, tp, zero1)
    assert not _step_errors(ref, dp, tp, zero1, runs)
    assert runs[0][-1] < runs[0][0]


def _skip_one_leaf(monkeypatch):
    """Planted fault: ZeRO-1 writes the embedding back un-updated."""
    from_rows = adamw.from_rows

    def skipping(x, p, names):
        return p if names[0] == "embed" else from_rows(x, p, names)
    monkeypatch.setattr(adamw, "from_rows", skipping)
    return "step 1 change of embed/table"


def _rotate_zero1_shards(monkeypatch):
    """Planted fault: ZeRO-1's gather of the updated slices puts each data
    rank's slice at the next rank's offset."""
    all_gather = collectives.all_gather

    def rotated(x, *a, **kw):
        return all_gather(x, *a, **kw).roll(x.shape[1], dims=1)
    monkeypatch.setattr(adamw.collectives, "all_gather", rotated)
    return None


@pytest.mark.parametrize("plant", [_skip_one_leaf, _rotate_zero1_shards],
                         ids=["leaf_not_updated", "zero1_shards_rotated"])
def test_adamw_step_check_catches_planted_faults(ref, monkeypatch, plant):
    """The step comparison fails on a planted fault at (2, 4) with ZeRO-1:
    one leaf left un-updated, or the data ranks' updated slices written at
    each other's offsets."""
    want = plant(monkeypatch)
    bad = _step_errors(ref, 2, 4, True, _run_steps(ref, 2, 4, True))
    assert bad and (want is None or want in bad), bad
