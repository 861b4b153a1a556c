"""The hybrid family in the port — zamba2-7b's config, the weight-shared
attention block after every group of Mamba2 layers, its sharding, its
serving state — against the JAX package, on the CPU, in float32.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:n]).reshape(dp, tp), ("data",
"model"))``): zamba2-7b's configs, full and smoke, field by field; forward
logits and loss at tp 1 and 4 for the smoke config (5 Mamba2 layers in 2
groups of 2, each followed by the shared block, then 1 trailing layer);
one step's gradients at ``(2, 4)``; the gradient model-sum mask, the TP
specs and the FSDP plan codes of the full and smoke trees (shapes only);
and serving at tp 1 and 4: a 32-token prompt (two SSD chunks of 16: the
scan takes whole chunks in both packages) and 16 greedy decode steps.  The
port takes the same parameters through ``sharding.from_reference``.

Tolerances, set from readings (the random-weight smoke model is
ill-conditioned in float32: its gated per-head norms amplify a rounding
into much larger gradient changes, as the JAX package's own zamba2 bound
of 8e-2 between its tp 1 and tp 4 gradients says):

- forward logits within 1e-3 of max|logit|, the loss within 1e-5: the
  port against the JAX package reads 2.2e-4 (tp 1) and 3.2e-4 (tp 4) of
  max|logit|, the JAX package's own tp 1 against tp 4 on the same weights
  1.6e-4;
- gradients at ``(2, 4)`` within 1e-1 of each leaf's max|grad|: the port
  against the JAX package reads 3.3e-2 (``groups/ssm/ssm/A_log``), the
  JAX package's own tp 1 against tp 4 1.35e-2, and the port's float32
  gradients against its float64 ones 2.9e-2 to 5.5e-2 under one ulp of
  noise at every norm input (``examples/hybrid_noise_probe_torch.py``), so
  two float32 implementations may sit ~1e-1 apart.  mamba2's 2e-3
  (``tests/test_torch_train_ssm.py``) does not hold here.  What the loose
  bound cannot see, the float64 check sees: the port's float64 gradients
  at ``(2, 4)`` equal its ``(1, 1)`` ones within 1e-9 of each leaf's max
  (7.0e-11 read), the shared block's uses summed and every model-axis sum
  in place;
- FSDP against replicated inside the port after two ZeRO-1 AdamW steps
  (Adam eps 1, as ``tests/test_torch_fsdp.py`` runs mamba2): losses within
  5e-4, parameters within 8e-3 of each leaf's max (or of 2 lr for a leaf
  that starts at zero);
- serving logits, SSM states and KV caches within 1e-3 of their max: the
  port against the JAX package reads up to 2.3e-4 (the shared block's K
  caches), the JAX package's own tp 1 against tp 4 1.8e-4; greedy tokens
  equal.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro.configs.registry import get_config as jax_get_config

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.config import CommConfig
from repro_torch.launch import input_specs as isp, mesh as mesh_mod, setup
from repro_torch.models import decode as dec, sharding, ssm, transformer
from repro_torch.models.common import MeshContext, Runtime
from repro_torch.optim import adamw
from repro_torch.train import serve, train_step as ts

ARCH = "zamba2-7b"
TPS = (1, 4)
B, S = 4, 48
SERVE_S, GEN = 32, 16
LOGIT_REL, LOSS_TOL, GRAD_TOL, SERVE_REL = 1e-3, 1e-5, 1e-1, 1e-3
F64_TOL = 1e-9
STEP_LOSS_TOL, PARAM_REL, DECODE_REL = 5e-4, 8e-3, 1e-4
# zamba2-7b's parameter count, the JAX package's ModelConfig.param_count()
ZAMBA2_PARAMS = 6_661_489_744


def _cfg(**kw):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32,
                               **kw)


JAX_CODE = """
import dataclasses, functools, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.configs.registry import get_config, get_smoke_config
from repro.core import collectives
from repro.core.config import CommConfig
from repro.launch import input_specs as isp, setup
from repro.models import sharding, transformer
from repro.models.common import MeshContext
from repro.optim import adamw
from repro.train import serve as serve_mod, train_step as ts

spec = json.loads(SPEC)
inp = np.load(spec["inputs"])
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
devs = np.array(jax.devices())
out, meta = {}, {"configs": {}, "trees": {}}
cfg = dataclasses.replace(get_smoke_config(spec["arch"]), dtype=jnp.float32)

def mesh_of(dp, tp):
    return Mesh(devs[:dp * tp].reshape(dp, tp), ("data", "model"))

def name(path):
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)

def flat(tree, prefix):
    return {prefix + name(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}

def init(tp):
    return jax.device_get(jax.jit(functools.partial(
        transformer.init_model, cfg=cfg, tp=tp))(jax.random.PRNGKey(0)))

for width, c in (("full", get_config(spec["arch"])),
                 ("smoke", get_smoke_config(spec["arch"]))):
    d = dataclasses.asdict(c)
    d["dtype"] = jnp.dtype(d["dtype"]).name
    meta["configs"][width] = d

# forward and loss
for tp in spec["tps"]:
    params = init(tp)
    out.update(flat(params, f"param/{tp}/"))
    s = setup.build_session(cfg, mesh_of(1, tp), CommConfig(),
                            concrete=False)
    rt = s.rt

    def f(p, b, rt=rt):
        fo = transformer.forward(p, b, rt, train=False)
        loss, _ = transformer.loss_fn(p, b, rt)
        return fo.logits, loss
    fn = jax.jit(compat.shard_map(
        f, mesh=s.mesh, in_specs=(s.param_spec, {"tokens": P(),
                                                 "labels": P()}),
        out_specs=(P(None, None, "model"), P()), check_vma=False))
    logits, loss = fn(params, batch)
    out[f"logits/{tp}"] = np.asarray(logits)
    out[f"loss/{tp}"] = np.asarray(loss)

# one step's gradients at (2, 4)
params = init(4)
sess = setup.build_session(cfg, mesh_of(2, 4), CommConfig(),
                           oc=adamw.OptConfig(zero1=False), concrete=False)
rt = sess.rt
lg = ts.make_loss_and_grad(rt)
bspec = {"tokens": P(("data",)), "labels": P(("data",))}

def g_fn(p, b, rt=rt, mask=sess.mask):
    loss, _, g = lg(p, b)
    g = ts.grad_model_sync(g, mask, rt)
    g = jax.tree.map(lambda x: collectives.all_reduce(
        x, rt.dp_comm(), rt.comm) / rt.mesh.dp, g)
    return collectives.all_reduce(loss, rt.dp_comm(), rt.comm) / rt.mesh.dp, g
fn = jax.jit(compat.shard_map(g_fn, mesh=sess.mesh,
                              in_specs=(sess.param_spec, bspec),
                              out_specs=(P(), sess.param_spec),
                              check_vma=False))
loss, g = fn(params, batch)
out["grad_loss"] = np.asarray(loss)
out.update(flat(g, "grad/"))

# the model-sum mask, the TP specs and the FSDP plan codes, from shapes
for width in ("smoke", "full"):
    c = (get_smoke_config if width == "smoke" else get_config)(spec["arch"])
    shapes = jax.eval_shape(functools.partial(
        transformer.init_model, cfg=c, tp=4), jax.random.PRNGKey(0))
    mc = MeshContext(model_size=4, data_sizes=(2,))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    mask = jax.tree.leaves(sharding.grad_model_sum_mask(shapes, c, 4))
    specs = jax.tree.leaves(sharding.param_specs(shapes, c, mc),
                            is_leaf=lambda s: isinstance(s, P))
    codes = jax.tree.leaves(sharding.build_fsdp_plan(shapes, c, mc))
    meta["trees"][width] = {
        name(path): {"shape": list(s.shape), "mask": int(m),
                     "spec": [list(e) if isinstance(e, tuple) else e
                              for e in sp], "code": int(cd)}
        for (path, s), m, sp, cd in zip(paths, mask, specs, codes)}
json.dump(meta, open(spec["meta"], "w"))

# serving
prompt = inp["prompt"]
Bp, Sp = prompt.shape
gen = spec["gen"]
for tp in spec["tps"]:
    params = init(tp)
    mesh = mesh_of(1, tp)
    _, pre_fn, _ = serve_mod.build_serve_fn(
        cfg, mesh, CommConfig(), isp.ShapeSpec("s", Sp, Bp, "prefill"),
        cache_capacity=Sp + gen)
    _, dec_fn, _ = serve_mod.build_serve_fn(
        cfg, mesh, CommConfig(), isp.ShapeSpec("s", Sp + gen, Bp, "decode"))
    st = pre_fn(params, {"tokens": jnp.asarray(prompt)})
    key = f"serve/{tp}/"
    out[key + "prefill_logits"] = np.asarray(st.last_logits)
    out.update(flat(st.caches, key + "prefill_cache/"))
    toks = []
    for _ in range(gen):
        nxt = np.asarray(jnp.argmax(st.last_logits, -1)).astype(np.int32)
        toks.append(nxt)
        st = dec_fn(params, jnp.asarray(nxt), st)
    out[key + "tokens"] = np.stack(toks, 1)
    out[key + "decode_logits"] = np.asarray(st.last_logits)
    out.update(flat(st.caches, key + "decode_cache/"))
np.savez(spec["out"], **out)
print("JAX HYBRID OK", len(out))
"""


def _inputs():
    rng = np.random.RandomState(0)
    cfg = _cfg()
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "prompt": rng.randint(0, cfg.vocab_size,
                                  (B, SERVE_S)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("hybrid_ref")
    np.savez(d / "inputs.npz", **_inputs())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "meta": str(d / "meta.json"), "arch": ARCH, "tps": TPS,
            "gen": GEN}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX HYBRID OK" in out
    res = dict(np.load(d / "ref.npz"))
    res.update(json.loads((d / "meta.json").read_text()))
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


def _max_rel(got, want) -> dict:
    out = {}
    for (n, g), (m, w) in zip(_leaves(got), _leaves(want)):
        assert n == m
        w = torch.as_tensor(np.asarray(w))
        assert tuple(g.shape) == tuple(w.shape), n
        out[n] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                  1e-12)
    return out


def _probe():
    """``examples/hybrid_noise_probe_torch.py`` as a module."""
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "examples"
            / "hybrid_noise_probe_torch.py")
    spec = importlib.util.spec_from_file_location("hybrid_noise_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(ref, cfg, tp):
    return sharding.from_reference(_tree(ref, f"param/{tp}/"), cfg, tp,
                                   "cpu")


def _batch():
    return {k: torch.as_tensor(v).long() for k, v in _inputs().items()
            if k in ("tokens", "labels")}


# ----------------------------------------------------------------------
# Configs and the family
# ----------------------------------------------------------------------

@pytest.mark.parametrize("width", ["full", "smoke"])
def test_configs_match_jax(ref, width):
    """The port's copy of zamba2-7b's config equals the JAX package's,
    field by field (dtype by name), and the port runs it."""
    cfg = (get_config if width == "full" else get_smoke_config)(ARCH)
    got = dataclasses.asdict(cfg)
    got["dtype"] = str(got["dtype"]).removeprefix("torch.")
    assert got == ref["configs"][width]
    transformer.require_ported_family(cfg)


def test_param_count_matches_jax():
    """``ModelConfig.param_count`` of zamba2-7b equals the JAX package's
    (81 Mamba2 layers, one shared block with its ``2·D x D`` input
    projection, the embedding)."""
    assert get_config(ARCH).param_count() \
        == jax_get_config(ARCH).param_count() == ZAMBA2_PARAMS


def test_init_model_builds_the_jax_layout():
    """``init_model`` gives the JAX package's hybrid tree: ``groups/ssm``
    leaves ``(n_groups, k, ...)``, ``trailing`` ``(n_layers % k, ...)``
    and ``shared_attn = {proj_in (2D, D), block}``; ``ssm_layers`` lists
    the 5 Mamba2 layers in layer order as views."""
    cfg = _cfg()
    params = transformer.init_model(0, cfg, 4, "cpu")
    assert sorted(params) == ["embed", "final_norm", "groups",
                              "shared_attn", "trailing"]
    assert transformer.hybrid_counts(cfg) == (2, 1)
    assert params["groups"]["ssm"]["ssm"]["w_x"].shape == (2, 2, 64, 128)
    assert params["trailing"]["ln"].shape == (1, 64)
    assert params["shared_attn"]["proj_in"].shape == (128, 64)
    assert sorted(params["shared_attn"]["block"]) == ["attn", "ln1", "ln2",
                                                      "mlp"]
    views = transformer.ssm_layers(params, cfg)
    assert len(views) == cfg.n_layers
    assert views[3]["ssm"]["w_x"].data_ptr() \
        == params["groups"]["ssm"]["ssm"]["w_x"][1, 1].data_ptr()
    assert views[4]["ln"].data_ptr() == params["trailing"]["ln"].data_ptr()


@pytest.mark.parametrize("family,mla", [("vlm", False), ("audio", False),
                                        ("hybrid", True)])
def test_other_families_still_raise(family, mla):
    """The VLM and audio families, and MLA outside the moe family, still
    raise ``NotImplementedError`` on the hybrid's config."""
    cfg = dataclasses.replace(_cfg(), family=family, use_mla=mla)
    with pytest.raises(NotImplementedError):
        transformer.require_ported_family(cfg)


# ----------------------------------------------------------------------
# The model against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tp", TPS)
def test_forward_matches_jax(ref, tp):
    """Forward logits (vocab shards concatenated) at tp 1 and 4 against the
    JAX package's, within 1e-3 of max|logit|, the loss within 1e-5."""
    cfg = _cfg()
    params = _params(ref, cfg, tp)
    rt = Runtime(cfg=cfg, mesh=MeshContext.stacked(tp), comm=CommConfig())
    with torch.no_grad():
        logits = transformer.forward(params, _batch(), rt).logits
        loss, _ = transformer.loss_fn(params, _batch(), rt)
    logits = torch.cat(logits.unbind(0), dim=-1).numpy()
    want = ref[f"logits/{tp}"]
    assert logits.shape == want.shape
    _close(logits, want, "forward logits", LOGIT_REL)
    assert abs(float(loss[0]) - float(ref[f"loss/{tp}"])) < LOSS_TOL


def test_grads_match_jax(ref):
    """One step's gradients at ``(2, 4)`` (model-synced, averaged over the
    data ranks) against the JAX package's, each leaf within 1e-1 of its
    max|grad|: the shared block's weights summed over both groups' uses,
    ``proj_in`` among them, and the embedding, which reaches the loss
    through the stack and through every shared block's input.  No hybrid
    leaf takes a model-axis sum beyond the ssm rules' (the mask is the
    JAX package's, ``test_mask_specs_and_fsdp_plan_match_jax``)."""
    cfg = _cfg()
    sess = setup.build_session(cfg, mesh_mod.make_test_mesh(2, 4),
                               CommConfig(), oc=adamw.OptConfig(zero1=False),
                               device="cpu")
    sess.params = sharding.from_reference(_tree(ref, "param/4/"), cfg, 4,
                                          "cpu", dp=2)
    rt = sess.rt
    loss, _, grads = ts.make_loss_and_grad(rt)(
        sess.params, setup.shard_batch(sess, _inputs()))
    grads = ts.grad_model_sync(grads, sess.mask, rt)
    grads = adamw._unflatten(grads, [
        adamw.leaf_all_reduce(g, n, rt.dp_comm(), rt.comm) / 2
        for n, g in adamw.leaves_with_names(grads)])
    loss = collectives.all_reduce(loss, rt.dp_comm(), rt.comm) / 2
    assert abs(float(loss[0]) - float(ref["grad_loss"])) < LOSS_TOL
    errs = _max_rel(setup.global_params(sess, grads), _tree(ref, "grad/"))
    assert max(errs.values()) < GRAD_TOL, errs
    for leaf in ("shared_attn/proj_in", "shared_attn/block/attn/wq",
                 "shared_attn/block/mlp/w_down", "embed/table",
                 "groups/ssm/ssm/w_B", "trailing/ssm/A_log"):
        assert leaf in errs


def test_float64_grads_are_the_same_on_every_mesh():
    """In float64 (``examples/hybrid_noise_probe_torch.py``'s
    ``float64_model``) the port's gradients at ``(2, 4)`` equal its ``(1,
    1)`` ones within 1e-9 of each leaf's max|grad|, and its logits too:
    without rounding noise, the shared block's gradients summed over both
    groups' uses, the embedding's over the stack and every shared-block
    input, and every model-axis sum leave nothing of the mesh in the
    result."""
    probe = _probe()
    cfg = _cfg()
    full = transformer.init_model(0, cfg, 1, "cpu")
    runs = []
    with probe.float64_model():
        for dp, tp in ((1, 1), (2, 4)):
            runs.append(probe.run(cfg, full, _inputs(), dp, tp, "cpu",
                                  f64=True))
    (g11, l11), (g24, l24) = runs
    assert all(t.dtype == torch.float64 for t in g24.values())
    worst, leaf = probe.gap(g24, g11)
    assert worst < F64_TOL, (leaf, worst)
    assert probe.rel(l24, l11) < F64_TOL
    assert "shared_attn/proj_in" in g24 and "embed/table" in g24


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_mask_specs_and_fsdp_plan_match_jax(ref, width):
    """``grad_model_sum_mask`` at tp 4, ``param_specs`` and the FSDP plan
    codes at ``(2, 4)`` equal the JAX package's on zamba2-7b's tree
    (shapes only): ``groups/ssm`` leaves with two stack dims, ``proj_in``
    replicated, the shared block never FSDP-cut."""
    want = ref["trees"][width]
    cfg = (get_smoke_config if width == "smoke" else get_config)(ARCH)
    shapes = _tree({k: torch.empty(v["shape"], device="meta")
                    for k, v in want.items()}, "")
    mc = MeshContext.stacked(4, 2)
    mask = dict(_leaves(sharding.grad_model_sum_mask(shapes, cfg, 4)))
    specs = dict(_leaves(sharding.param_specs(shapes, cfg, mc)))
    codes = dict(_leaves(sharding.build_fsdp_plan(shapes, cfg, mc)))
    assert mask == {n: w["mask"] for n, w in want.items()}
    assert {n: [list(e) if isinstance(e, tuple) else e for e in s]
            for n, s in specs.items()} == {n: w["spec"]
                                           for n, w in want.items()}
    assert codes == {n: w["code"] for n, w in want.items()}
    assert specs["shared_attn/proj_in"] == (None, None)
    assert specs["groups/ssm/ssm/w_x"] == (None, None, None, "model")
    assert all(c == -1 for n, c in codes.items()
               if n.startswith("shared_attn/"))


def test_fsdp_steps_equal_the_replicated_steps():
    """Under FSDP at ``(2, 4)`` the group and trailing Mamba2 leaves are
    cut over the data ranks and gathered inside the recomputed group unit
    (the shared block, closed over, is not): two ZeRO-1 AdamW steps train
    as the replicated session's do (losses within 5e-4, every parameter
    within 8e-3 of its leaf's max, or of 2 lr for a leaf that starts at
    zero; Adam eps 1, as mamba2's FSDP steps run)."""
    cfg = _cfg(remat=True)
    mesh = mesh_mod.make_test_mesh(2, 4)
    oc = adamw.OptConfig(zero1=True, lr=1e-2, warmup_steps=1,
                         total_steps=100, eps=1.0)
    out = {}
    for fsdp in (False, True):
        sess = setup.build_session(cfg, mesh, CommConfig(), device="cpu",
                                   fsdp=fsdp, oc=oc)
        step = setup.make_sharded_train_step(sess, donate=False)
        p, o, losses = sess.params, sess.opt_state, []
        for _ in range(2):
            p, o, m = step(p, o, _inputs())
            losses.append(float(m["loss"]))
        out[fsdp] = losses, setup.global_params(sess, p)
    plan = sess.rt.fsdp_plan
    assert plan["groups"]["ssm"]["ssm"]["w_x"] >= 0
    assert plan["trailing"]["ssm"]["w_x"] >= 0
    assert plan["shared_attn"]["proj_in"] == -1
    np.testing.assert_allclose(out[True][0], out[False][0],
                               atol=STEP_LOSS_TOL, rtol=0)
    for (n, a), (_, b) in zip(_leaves(out[True][1]), _leaves(out[False][1])):
        scale = max(float(b.abs().max()), 2 * oc.lr)
        assert float((a - b).abs().max()) <= PARAM_REL * scale, n


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

def _global_kv(c: torch.Tensor) -> np.ndarray:
    """``(G, P, B, S_shard, KV, hd)`` -> ``(G, B, S, KV, hd)``."""
    G, P, Bc, Ls = c.shape[:4]
    return c.permute(0, 2, 1, 3, 4, 5).reshape(
        G, Bc, P * Ls, *c.shape[4:]).numpy()


def _global_state(t: torch.Tensor, head_axis: int) -> np.ndarray:
    """A stacked SSM state leaf ``(L, P, B, ...)`` -> the JAX package's
    global ``(L, B, ...)``: the rank shards concatenated along the head
    axis (the smoke config's 8 heads shard at tp 4)."""
    return torch.cat(t.unbind(1), dim=head_axis).numpy()


def _port_serve(params, cfg, tp, prompt):
    _, pre = serve.build_serve_fn(cfg, tp, CommConfig(),
                                  isp.ShapeSpec("s", SERVE_S, B, "prefill"),
                                  cache_capacity=SERVE_S + GEN, device="cpu")
    rt, step = serve.build_serve_fn(
        cfg, tp, CommConfig(), isp.ShapeSpec("s", SERVE_S + GEN, B,
                                             "decode"), device="cpu")
    st = pre(params, {"tokens": prompt})
    assert isinstance(st.caches, dec.HybridCache)
    assert st.caches.attn.length is st.length
    first = (st.last_logits.clone(),) + tuple(
        t.clone() for t in serve._state_buffers(st)[:4])
    toks = []
    for _ in range(GEN):
        nxt = dec.greedy_tokens(st, rt)
        toks.append(nxt)
        st = step(params, nxt, st)
    return first, torch.stack(toks, 1), st, rt


def _close(got, want, what, rel=SERVE_REL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} over {tol}"


@pytest.mark.parametrize("tp", TPS)
def test_serving_matches_jax(ref, tp):
    """Prefill (32 tokens) and 16 greedy decode steps at tp 1 and 4 against
    the JAX package's: logits within 1e-3 of their max, greedy tokens
    equal, and the port's layer-order SSM states and per-group KV caches
    equal to the JAX package's nested ``{"groups": {"ssm", "attn"},
    "trailing"}`` caches within 1e-3 of their max."""
    cfg = _cfg()
    ng, nt = transformer.hybrid_counts(cfg)
    k = cfg.hybrid_attn_every
    (logits, *bufs), toks, st, _ = _port_serve(_params(ref, cfg, tp), cfg,
                                               tp, _inputs()["prompt"])
    key = f"serve/{tp}/"
    _close(torch.cat(logits.unbind(0), -1).numpy(),
           ref[key + "prefill_logits"], "prefill logits")
    np.testing.assert_array_equal(toks.numpy(), ref[key + "tokens"])
    _close(torch.cat(st.last_logits.unbind(0), -1).numpy(),
           ref[key + "decode_logits"], "decode logits")
    for when, (conv, h, kc, vc) in (("prefill", bufs),
                                    ("decode", serve._state_buffers(st)[:4])):
        want = _tree(ref, key + f"{when}_cache/")
        assert sorted(want) == ["groups", "trailing"]
        for name, got in (("conv", _global_state(conv, 3)),
                          ("h", _global_state(h, 2))):
            g = got[:ng * k].reshape((ng, k) + got.shape[1:])
            _close(g, want["groups"]["ssm"][name], f"{when} groups {name}")
            _close(got[ng * k:], want["trailing"][name],
                   f"{when} trailing {name}")
        assert nt == 1
        for name, got in (("k", kc), ("v", vc)):
            _close(_global_kv(got), want["groups"]["attn"][name],
                   f"{when} shared-block {name}")


def test_decode_equals_prefill_of_the_extended_sequence():
    """Inside the port at tp 4: after 16 decode steps, the last logits
    equal those of a prefill of the prompt and the generated tokens
    (within 1e-4 of their max: one package, one rounding), the SSM states
    and the shared block's KV caches too: decode's recurrence and one-token
    attention are the prefill's chunked scan and causal attention."""
    cfg = _cfg()
    params = sharding.shard_params(transformer.init_model(0, cfg, 4, "cpu"),
                                   cfg, 4)
    prompt = _inputs()["prompt"]
    _, toks, st, rt = _port_serve(params, cfg, 4, prompt)
    seq = np.concatenate([prompt, toks.numpy()], axis=1)
    _, pre = serve.build_serve_fn(cfg, 4, CommConfig(),
                                  isp.ShapeSpec("s", seq.shape[1], B,
                                                "prefill"), device="cpu")
    ext = pre(params, {"tokens": seq})
    _close(st.last_logits.numpy(), ext.last_logits.numpy(),
           "decode vs extended prefill", DECODE_REL)
    assert torch.equal(dec.greedy_tokens(st, rt), dec.greedy_tokens(ext, rt))
    for got, want, what in zip(serve._state_buffers(st),
                               serve._state_buffers(ext),
                               ("conv", "h", "k", "v")):
        _close(got.numpy(), want.numpy(), f"decode vs extended prefill "
               f"{what}", DECODE_REL)


def test_state_buffers_and_check_caches_on_meta_tensors():
    """The hybrid state on meta tensors (``input_specs``): every buffer
    of it listed by ``serve._state_buffers`` (81 layers' conv and SSD
    states, 13 groups' K and V, the logits, the length), so that a
    captured prefill or decode writes them all; the decode builder checks
    both parts."""
    full = get_config(ARCH)
    want = isp.hybrid_state_abstract(full, 4, 4, 1040, 4)
    assert want.ssm.conv.shape == (81, 4, 4, 3, 1792)
    assert want.ssm.h.shape == (81, 4, 4, 28, 64, 64)
    assert want.ssm.h.dtype == torch.float32
    assert want.attn.k.shape == (13, 4, 4, 260, 32, 112)
    assert want.attn.k.dtype == torch.bfloat16
    cfg = _cfg()
    rt, step = serve.build_serve_fn(
        cfg, 4, CommConfig(), isp.ShapeSpec("s", SERVE_S + GEN, B,
                                            "decode"), device="cpu")
    st = dec.init_state({"final_norm": torch.empty(0, device="meta"),
                         "embed": {"table": torch.empty(
                             (4, cfg.vocab_size // 4, cfg.d_model),
                             device="meta")}},
                        rt, B, SERVE_S + GEN, device="meta")
    bufs = serve._state_buffers(st)
    assert [tuple(t.shape) for t in bufs] == [
        (5, 4, B, 3, 32), (5, 4, B, 2, 16, 16), (2, 4, B, 12, 4, 16),
        (2, 4, B, 12, 4, 16), (4, B, cfg.vocab_size // 4), ()]
    assert st.caches.attn.length is st.length
    step.check_caches(st.caches)
    for bad in (st.caches._replace(ssm=ssm.SSMState(
                    st.caches.ssm.conv, st.caches.ssm.h[:, :, :, :1])),
                st.caches._replace(attn=st.caches.attn._replace(
                    k=st.caches.attn.k[:, :, :, :6]))):
        with pytest.raises(ValueError):
            step.check_caches(bad)
