"""Multi-head Latent Attention in the port — ``models/mla.py``, deepseek-v3's
config and the flash wrapper's v head dim unlike q's — against the JAX
package, on the CPU, in float32.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:n]).reshape(dp, tp), ("data",
"model"))``): deepseek-v3's configs, full and smoke, field by field;
``mla_attention`` alone at tp 1 and 4 (output and latents); forward logits
and loss at tp 1 and 4 for the smoke config (an MoE stack with a dense head
layer, a shared expert and MLA in every layer); one step's gradients at
``(2, 4)``; the gradient model-sum mask, the TP specs and the FSDP plan
codes of the full and smoke trees (shapes only); and serving at tp 1 and
4: a 24-token prompt and 16 greedy decode steps.  The port takes the same
parameters through ``sharding.from_reference``.  The flash wrapper with
``d_v != d`` is held against the JAX package's
``flash_attention_reference`` and ``jax.grad`` of it in this process.

Tolerances: the flash wrapper within 3e-5, its gradients within 1e-4
(``tests/test_kernels.py``'s f32 bounds); ``mla_attention``'s output and
latents, logits and loss within 1e-5 (absolute); gradients within 1e-4 of
each leaf's max|grad| (``tests/test_distributed_parity.py``'s
``GRAD_TOL``); serving logits and latent caches within 1e-4 of their max
(``tests/test_torch_serve.py``), greedy tokens equal.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import run_multidevice

from repro.configs.registry import get_config as jax_get_config
from repro.kernels.flash_attention import ops as jax_fa

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.config import CommConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import input_specs as isp, mesh as mesh_mod, setup
from repro_torch.models import decode as dec, mla, sharding, transformer
from repro_torch.models.common import MeshContext, ModelConfig, Runtime
from repro_torch.optim import adamw
from repro_torch.train import serve, train_step as ts

ARCH = "deepseek-v3-671b"
TPS = (1, 4)
B, S = 4, 48
SERVE_S, GEN = 24, 16
FLASH_TOL, GRAD_FLASH_TOL = 3e-5, 1e-4
ATTN_TOL, LOGIT_TOL, GRAD_TOL, SERVE_REL = 1e-5, 1e-5, 1e-4, 1e-4
# the leaves MLA stores replicated and uses shard-wise: their gradients
# are summed over the model axis
MLA_SUMMED = ("w_dq", "w_dkv", "w_kr", "q_norm", "kv_norm")


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
from repro.models import mla, sharding, transformer
from repro.models.common import MeshContext, Runtime
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

# mla_attention alone
x = jnp.asarray(inp["attn_x"])
pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None], x.shape[:2])
p = mla.init_mla(jax.random.PRNGKey(1), cfg, jnp.float32)
out.update(flat(p, "attn/param/"))
for tp in spec["tps"]:
    mc = MeshContext(model_size=tp, data_sizes=(1,))
    rt = Runtime(cfg=cfg, mesh=mc, comm=CommConfig())
    pspec = sharding.param_specs({"attn": p}, cfg, mc)["attn"]
    f = jax.jit(compat.shard_map(
        lambda pp, v, q, rt=rt: mla.mla_attention(pp, v, q, rt,
                                                  return_latents=True),
        mesh=mesh_of(1, tp), in_specs=(pspec, P(), P()),
        out_specs=(P(), (P(), P())), check_vma=False))
    y, (ckv, kr) = f(p, x, pos)
    out[f"attn/{tp}/y"] = np.asarray(y)
    out[f"attn/{tp}/ckv"] = np.asarray(ckv)
    out[f"attn/{tp}/k_rope"] = np.asarray(kr)

# forward and loss
for tp in spec["tps"]:
    params = init(tp)
    out.update(flat(params, f"param/{tp}/"))
    s = setup.build_session(cfg, mesh_of(1, tp), CommConfig(),
                            concrete=False)
    rt = s.rt

    def f(p, b, rt=rt):
        fo = transformer.forward(p, b, rt, train=False)
        loss, parts = transformer.loss_fn(p, b, rt)
        return fo.logits, loss, parts["aux"]
    fn = jax.jit(compat.shard_map(
        f, mesh=s.mesh, in_specs=(s.param_spec, {"tokens": P(),
                                                 "labels": P()}),
        out_specs=(P(None, None, "model"), P(), P()), check_vma=False))
    logits, loss, aux = fn(params, batch)
    out[f"logits/{tp}"] = np.asarray(logits)
    out[f"loss/{tp}"] = np.asarray(loss)
    out[f"aux/{tp}"] = np.asarray(aux)

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
print("JAX MLA OK", len(out))
"""


def _inputs():
    rng = np.random.RandomState(0)
    cfg = _cfg()
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "prompt": rng.randint(0, cfg.vocab_size,
                                  (B, SERVE_S)).astype(np.int32),
            "attn_x": rng.randn(2, 16, cfg.d_model).astype(np.float32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("mla_ref")
    np.savez(d / "inputs.npz", **_inputs())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "meta": str(d / "meta.json"), "arch": ARCH, "tps": TPS,
            "gen": GEN}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX MLA OK" in out
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


def _runtime(cfg, tp):
    return Runtime(cfg=cfg, mesh=MeshContext.stacked(tp), comm=CommConfig())


def _params(ref, cfg, tp):
    return sharding.from_reference(_tree(ref, f"param/{tp}/"), cfg, tp,
                                   "cpu")


# ----------------------------------------------------------------------
# Configs and families
# ----------------------------------------------------------------------

@pytest.mark.parametrize("width", ["full", "smoke"])
def test_configs_match_jax(ref, width):
    """The port's copy of deepseek-v3's config equals the JAX package's,
    field by field (dtype by name), and the port runs it."""
    cfg = (get_config if width == "full" else get_smoke_config)(ARCH)
    got = dataclasses.asdict(cfg)
    got["dtype"] = str(got["dtype"]).removeprefix("torch.")
    assert got == ref["configs"][width]
    transformer.require_ported_family(cfg)


@pytest.mark.parametrize("arch", ["zamba2-7b", "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2"])
def test_other_families_still_raise(arch):
    """The VLM and audio families still raise ``NotImplementedError``, and
    the hybrid family (zamba2-7b, ported since) is admitted (each the JAX
    package's config, in the port's ModelConfig)."""
    d = dataclasses.asdict(jax_get_config(arch))
    d["dtype"] = torch.bfloat16
    if d["family"] == "hybrid":
        transformer.require_ported_family(ModelConfig(**d))
        return
    with pytest.raises(NotImplementedError):
        transformer.require_ported_family(ModelConfig(**d))


# ----------------------------------------------------------------------
# The flash wrapper with a v head dim unlike q's
# ----------------------------------------------------------------------

def _flash_inputs(seed=0, N=2, S=40, T=40, H=4, KV=2, d=24, dv=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, S, H, d).astype(np.float32),
            rng.randn(N, T, KV, d).astype(np.float32),
            rng.randn(N, T, KV, dv).astype(np.float32),
            rng.randn(N, S, H, dv).astype(np.float32))


@pytest.mark.parametrize("window", [None, 9])
def test_flash_with_v_head_dim_unlike_q_matches_jax(window):
    """q/k head dim 24, v 16, causal (and windowed): the port's wrapper
    returns v's head dim, within 3e-5 of the JAX package's reference, and
    its gradients (dv of v's shape) within 1e-4 of ``jax.grad`` of it; the
    log-sum-exp form returns the same output."""
    q, k, v, dout = _flash_inputs()
    kw = dict(causal=True, window=window)
    want, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention_reference(
        a, b, c, **kw), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    got = fa_ops.flash_attention(tq, tk, tv, **kw)
    assert tuple(got.shape) == q.shape[:3] + (v.shape[3],)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    got.backward(torch.as_tensor(dout))
    for t, g in zip((tq, tk, tv), grads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_FLASH_TOL, rtol=GRAD_FLASH_TOL)
    out, lse = fa_ops.flash_attention_lse(*(torch.as_tensor(t)
                                            for t in (q, k, v)), **kw)
    assert torch.equal(out, got.detach()) and lse.shape == (2, 4, 40)
    bwd = fa_ops.flash_attention_bwd(
        *(torch.as_tensor(t) for t in (q, k, v)), out,
        torch.as_tensor(dout), lse, **kw)
    for t, g in zip((tq, tk, tv), bwd):
        assert torch.equal(g, t.grad)


@pytest.mark.parametrize("case", ["leading dims", "head dim over 256",
                                  "k head dim"])
def test_flash_check_refuses_misfit_v(case):
    """``_check`` takes v ``(N, T, KV, d_v)`` only with k's leading dims,
    ``d_v <= 256``, and k's head dim equal to q's."""
    q, k, v, _ = _flash_inputs()
    q, k, v = (torch.as_tensor(t) for t in (q, k, v))
    if case == "leading dims":
        v = v[:, :-1]
    elif case == "head dim over 256":
        v = torch.zeros(v.shape[:3] + (257,))
    else:
        k = k[..., :16]
    with pytest.raises(ValueError, match="do not fit"):
        fa_ops.flash_attention(q, k, v)


# ----------------------------------------------------------------------
# The module against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tp", TPS)
def test_mla_attention_matches_jax(ref, tp):
    """``mla_attention`` alone at tp 1 and 4: output and latents ``(ckv,
    k_rope)`` within 1e-5 of the JAX package's, the same on every rank."""
    cfg = _cfg()
    params = sharding.from_reference({"attn": _tree(ref, "attn/param/")},
                                     cfg, tp, "cpu")["attn"]
    x0 = _inputs()["attn_x"]
    x = torch.as_tensor(x0).unsqueeze(0).expand(tp, *x0.shape)
    pos = transformer.positions_for(torch.zeros(x0.shape[:2]))
    with torch.no_grad():
        y, (ckv, kr) = mla.mla_attention(params, x, pos, _runtime(cfg, tp),
                                         return_latents=True)
    for name, got in (("y", y), ("ckv", ckv), ("k_rope", kr)):
        assert torch.equal(got, got[:1].expand_as(got)), name
        want = ref[f"attn/{tp}/{name}"]
        assert got.shape[1:] == want.shape, name
        assert float(np.abs(got[0].numpy() - want).max()) < ATTN_TOL, name


def _batch():
    return {k: torch.as_tensor(v).long() for k, v in _inputs().items()
            if k in ("tokens", "labels")}


@pytest.mark.parametrize("tp", TPS)
def test_forward_matches_jax(ref, tp):
    """Forward logits (vocab shards concatenated), the loss ``ce + 0.01 ·
    aux`` and the aux at tp 1 and 4 against the JAX package's, within
    1e-5."""
    cfg = _cfg()
    params = _params(ref, cfg, tp)
    rt = _runtime(cfg, tp)
    with torch.no_grad():
        logits = transformer.forward(params, _batch(), rt).logits
        loss, parts = transformer.loss_fn(params, _batch(), rt)
    logits = torch.cat(logits.unbind(0), dim=-1).numpy()
    want = ref[f"logits/{tp}"]
    assert logits.shape == want.shape
    assert float(np.abs(logits - want).max()) < LOGIT_TOL
    assert abs(float(loss[0]) - float(ref[f"loss/{tp}"])) < LOGIT_TOL
    assert abs(float(parts["aux"][0]) - float(ref[f"aux/{tp}"])) < LOGIT_TOL
    assert torch.equal(loss, parts["ce"] + 0.01 * parts["aux"])


def test_grads_match_jax(ref):
    """One step's gradients at ``(2, 4)`` (model-synced, averaged over the
    data ranks) against the JAX package's, each leaf within 1e-4 of its
    max|grad|: MLA's down-projections and norms, stored replicated and used
    shard-wise (summed over the model axis), among them, in the dense head
    layer and the MoE layers."""
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
    assert abs(float(loss[0]) - float(ref["grad_loss"])) < LOGIT_TOL
    errs = _max_rel(setup.global_params(sess, grads), _tree(ref, "grad/"))
    assert max(errs.values()) < GRAD_TOL, errs
    for stack in ("dense_layers", "layers"):
        for leaf in MLA_SUMMED:
            assert f"{stack}/attn/{leaf}" in errs


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_mask_specs_and_fsdp_plan_match_jax(ref, width):
    """``grad_model_sum_mask`` at tp 4, ``param_specs`` and the FSDP plan
    codes at ``(2, 4)`` equal the JAX package's on deepseek-v3's tree
    (shapes only): MLA's down-projections and norms summed over the model
    axis, ``w_uq``/``w_uk``/``w_uv`` column- and ``wo`` row-sharded."""
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
    for leaf in MLA_SUMMED:
        assert mask[f"layers/attn/{leaf}"] == 1
    assert specs["layers/attn/wo"] == (None, "model", None)
    assert specs["layers/attn/w_uk"] == (None, None, "model")


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

def _global_cache(c: torch.Tensor) -> np.ndarray:
    """``(L, P, B, S_shard, ·)`` -> ``(L, B, S, ·)``."""
    L, P, Bc, Ls = c.shape[:4]
    return c.permute(0, 2, 1, 3, 4).reshape(L, Bc, P * Ls,
                                            c.shape[4]).numpy()


def _port_serve(params, cfg, tp, prompt):
    _, pre = serve.build_serve_fn(cfg, tp, CommConfig(),
                                  isp.ShapeSpec("s", SERVE_S, B, "prefill"),
                                  cache_capacity=SERVE_S + GEN, device="cpu")
    rt, step = serve.build_serve_fn(
        cfg, tp, CommConfig(), isp.ShapeSpec("s", SERVE_S + GEN, B,
                                             "decode"), device="cpu")
    st = pre(params, {"tokens": prompt})
    assert isinstance(st.caches, mla.MLACache)
    assert st.caches.length is st.length
    first = (st.last_logits.clone(), st.caches.ckv.clone(),
             st.caches.k_rope.clone())
    toks = []
    for _ in range(GEN):
        nxt = dec.greedy_tokens(st, rt)
        toks.append(nxt)
        st = step(params, nxt, st)
    return first, torch.stack(toks, 1), st, rt


def _close(got, want, what, rel=SERVE_REL):
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} over {tol}"


@pytest.mark.parametrize("tp", TPS)
def test_serving_matches_jax(ref, tp):
    """Prefill (24 tokens) and 16 greedy decode steps at tp 1 and 4 against
    the JAX package's: logits within 1e-4 of their max, greedy tokens
    equal, and the port's one layer-order latent cache (the dense head,
    then the MoE layers) equal to the JAX package's ``{"dense", "moe"}``
    latent caches within 1e-4 of their max."""
    cfg = _cfg()
    (logits, ckv, kr), toks, st, _ = _port_serve(_params(ref, cfg, tp), cfg,
                                                 tp, _inputs()["prompt"])
    key = f"serve/{tp}/"
    _close(torch.cat(logits.unbind(0), -1).numpy(),
           ref[key + "prefill_logits"], "prefill logits")
    np.testing.assert_array_equal(toks.numpy(), ref[key + "tokens"])
    _close(torch.cat(st.last_logits.unbind(0), -1).numpy(),
           ref[key + "decode_logits"], "decode logits")
    nd = cfg.n_dense_layers
    for when, c_ckv, c_kr in (("prefill", ckv, kr),
                              ("decode", st.caches.ckv, st.caches.k_rope)):
        want = _tree(ref, key + f"{when}_cache/")
        assert sorted(want) == ["dense", "moe"]
        for name, got in (("ckv", _global_cache(c_ckv)),
                          ("k_rope", _global_cache(c_kr))):
            for part, g in (("dense", got[:nd]), ("moe", got[nd:])):
                w = want[part][name]
                assert g.shape == w.shape, (when, name, part)
                _close(g, w, f"{when} {part} {name}")


def test_decode_equals_prefill_of_the_extended_sequence():
    """Inside the port at tp 4: after 16 decode steps, the last logits
    equal those of a prefill of the prompt and the generated tokens
    (within 1e-4 of their max), with room for every token
    (``capacity_factor`` ``E / k`` = 4): the absorbed latent decode is the
    decompressed prefill's attention."""
    cfg = _cfg(capacity_factor=4.0)
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
           "decode vs extended prefill")
    assert torch.equal(dec.greedy_tokens(st, rt), dec.greedy_tokens(ext, rt))
