"""The moe family in the port — mixtral-8x22b, ``models/moe.py`` and the
sweep's ``moe_loop`` consumer — against the JAX package, on the CPU, in
float32.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:n]).reshape(dp, tp), ("data", "model"))``):
mixtral's configs, full and smoke, field by field; ``moe_block`` alone at
tp 1, 4 and 8 (8 ranks over the smoke config's 4 experts: ``tp_inner``
2, the real EP x TP form), on three inputs: random tokens, the same at
``capacity_factor`` 0.5 (tokens drop), and repeated tokens at 0.5 with
two experts' router columns equal (gates tie, in the expert choice and at
the capacity cut); ``moe_block_a2a`` at dp 2 and 4 on replicated
parameters; forward logits and loss at tp 1 and 4 for the smoke config
and a variant with a shared expert and a dense head layer (each tree
built at its tp: the expert layout depends on it, the values do not);
one step's gradients at ``(2, 4)`` on the variant; mixtral's FSDP plan
codes (full and smoke, shapes only); and serving (the smoke config at
tp 1 and 4, the variant at tp 4): a 24-token prompt and 16 greedy decode
steps, past the smoke config's 32-token window.  The port takes the same
parameters through ``sharding.from_reference``.

Tolerances: the block's output within 1e-5 and its aux within 1e-6;
logits and loss within 1e-5 (absolute); gradients within 1e-4 of each
leaf's max|grad| (``tests/test_distributed_parity.py``'s ``GRAD_TOL``);
serving logits and caches within 1e-4 of their max
(``tests/test_torch_serve.py``), greedy tokens equal.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from helpers import run_multidevice

from repro.models import moe as jax_moe
from repro.models.common import ModelConfig as JaxModelConfig
from repro.tune import sweep as jax_sweep

from repro_torch import tune
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import collectives
from repro_torch.core.config import (CommConfig, CommMode, Scheduling,
                                     Transport)
from repro_torch.launch import input_specs as isp, mesh as mesh_mod, setup
from repro_torch.models import decode as dec, moe, sharding, transformer
from repro_torch.models.common import MeshContext, ModelConfig, Runtime
from repro_torch.optim import adamw
from repro_torch.train import serve, train_step as ts
from repro_torch.tune import sweep

ARCH = "mixtral-8x22b"
CASES = ("smoke", "shared")
# one step's gradients against the JAX package: the variant, whose tree
# holds every leaf kind of the smoke config's and a dense head and a
# shared expert besides
GRAD_CASE = "shared"
TPS = (1, 4)
BLOCK_TPS = (1, 4, 8)
BLOCK_CASES = ("random", "drop", "ties")
A2A_DPS = (2, 4)
# serving against the JAX package: the smoke config at tp 1 and 4, the
# shared-expert, dense-head variant at tp 4
SERVE_CASES = (("smoke", 1), ("smoke", 4), ("shared", 4))
B, S = 4, 48
BLOCK_B, BLOCK_S = 2, 16
SERVE_S, GEN = 24, 16
BLOCK_TOL, AUX_TOL, LOGIT_TOL, GRAD_TOL, SERVE_REL = 1e-5, 1e-6, 1e-5, \
    1e-4, 1e-4
# the a2a variant's model (tests/test_overlap.py::test_moe_a2a_parity_bitwise)
A2A_CFG = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=4,
               n_kv_heads=4, d_ff=64, vocab_size=128, n_experts=4,
               n_experts_per_tok=2)
A2A_TOKENS = 64


def _cfg(case="smoke", capacity_factor=None):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32)
    if case == "shared":
        cfg = dataclasses.replace(cfg, n_shared_experts=1, n_dense_layers=1)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def _block_cf(case):
    return None if case == "random" else 0.5


JAX_CODE = """
import dataclasses, functools, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.configs.registry import get_config, get_smoke_config
from repro.core import collectives
from repro.core.config import CommConfig
from repro.launch import input_specs as isp, setup
from repro.models import moe, sharding, transformer
from repro.models.common import MeshContext, ModelConfig, Runtime
from repro.optim import adamw
from repro.train import serve as serve_mod, train_step as ts

spec = json.loads(SPEC)
inp = np.load(spec["inputs"])
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
devs = np.array(jax.devices())
out, configs = {}, {}

def mesh_of(dp, tp):
    return Mesh(devs[:dp * tp].reshape(dp, tp), ("data", "model"))

def name(path):
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)

def flat(tree, prefix):
    return {prefix + name(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}

def cfg_of(case, cf=None):
    cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                              dtype=jnp.float32)
    if case == "shared":
        cfg = dataclasses.replace(cfg, n_shared_experts=1, n_dense_layers=1)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    return cfg

for width, c in (("full", get_config(spec["arch"])),
                 ("smoke", get_smoke_config(spec["arch"]))):
    d = dataclasses.asdict(c)
    d["dtype"] = jnp.dtype(d["dtype"]).name
    configs[width] = d
json.dump(configs, open(spec["configs"], "w"))

# moe_block alone
for case, cf in spec["block_cases"].items():
    cfg = cfg_of("smoke", cf)
    x = jnp.asarray(inp[f"block_x/{case}"])
    for tp in spec["block_tps"]:
        p = moe.init_moe(jax.random.PRNGKey(1), cfg, jnp.float32, tp)
        if case == "ties":
            p["router"] = p["router"].at[:, 2].set(p["router"][:, 1])
        out.update(flat(p, f"block/{case}/{tp}/param/"))
        mc = MeshContext(model_size=tp, data_sizes=(1,))
        rt = Runtime(cfg=cfg, mesh=mc, comm=CommConfig())
        pspec = sharding.param_specs({"moe": p}, cfg, mc)["moe"]
        f = jax.jit(compat.shard_map(
            lambda pp, v, rt=rt: moe.moe_block(pp, v, rt),
            mesh=mesh_of(1, tp), in_specs=(pspec, P()),
            out_specs=(P(), P()), check_vma=False))
        y, aux = f(p, x)
        out[f"block/{case}/{tp}/y"] = np.asarray(y)
        out[f"block/{case}/{tp}/aux"] = np.asarray(aux)

# moe_block_a2a on replicated parameters (a tp=1 tree)
acfg = ModelConfig(**spec["a2a_cfg"])
ap = moe.init_moe(jax.random.PRNGKey(0), acfg, jnp.float32, tp=1)
out.update(flat(ap, "a2a/param/"))
xs = jnp.asarray(inp["a2a_x"])
for dp in spec["a2a_dps"]:
    rt = Runtime(cfg=acfg, mesh=MeshContext(data_axes=("data",),
                                             model_size=1,
                                             data_sizes=(dp,)),
                 comm=CommConfig())
    def blk(v, pp, rt=rt):
        y, aux = moe.moe_block_a2a(pp, v, rt)
        return y, aux[None]
    f = jax.jit(compat.shard_map(
        blk, mesh=Mesh(devs[:dp], ("data",)), in_specs=(P("data"), P()),
        out_specs=(P("data"), P("data")), check_vma=False))
    y, aux = f(xs, ap)
    out[f"a2a/{dp}/y"] = np.asarray(y)
    out[f"a2a/{dp}/aux"] = np.asarray(aux)

# forward, loss and gradients
bspec = {"tokens": P(("data",)), "labels": P(("data",))}
for case in spec["cases"]:
    cfg = cfg_of(case)
    for tp in spec["tps"]:
        params = jax.device_get(jax.jit(functools.partial(
            transformer.init_model, cfg=cfg, tp=tp))(jax.random.PRNGKey(0)))
        out.update(flat(params, f"{case}/param/{tp}/"))
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
        out[f"{case}/logits/{tp}"] = np.asarray(logits)
        out[f"{case}/loss/{tp}"] = np.asarray(loss)
        out[f"{case}/aux/{tp}"] = np.asarray(aux)
    if case != spec["grad_case"]:
        continue
    params = jax.device_get(jax.jit(functools.partial(
        transformer.init_model, cfg=cfg, tp=4))(jax.random.PRNGKey(0)))
    sess = setup.build_session(cfg, mesh_of(2, 4), CommConfig(),
                               oc=adamw.OptConfig(zero1=False),
                               concrete=False)
    rt = sess.rt
    lg = ts.make_loss_and_grad(rt)

    def g_fn(p, b, rt=rt, mask=sess.mask):
        loss, _, g = lg(p, b)
        g = ts.grad_model_sync(g, mask, rt)
        g = jax.tree.map(lambda x: collectives.all_reduce(
            x, rt.dp_comm(), rt.comm) / rt.mesh.dp, g)
        return collectives.all_reduce(loss, rt.dp_comm(),
                                      rt.comm) / rt.mesh.dp, g
    fn = jax.jit(compat.shard_map(g_fn, mesh=sess.mesh,
                                  in_specs=(sess.param_spec, bspec),
                                  out_specs=(P(), sess.param_spec),
                                  check_vma=False))
    loss, g = fn(params, batch)
    out[f"{case}/grad_loss"] = np.asarray(loss)
    out.update(flat(g, f"{case}/grad/"))

plans = {}
for width in ("smoke", "full"):
    cfg = (get_smoke_config if width == "smoke" else get_config)(spec["arch"])
    mc = MeshContext(model_size=4, data_sizes=(2,))
    shapes = jax.eval_shape(functools.partial(
        transformer.init_model, cfg=cfg, tp=4), jax.random.PRNGKey(0))
    codes = jax.tree.leaves(sharding.build_fsdp_plan(shapes, cfg, mc))
    plans[width] = {name(path): {"shape": list(s.shape), "code": int(c)}
                    for (path, s), c in zip(
                        jax.tree_util.tree_flatten_with_path(shapes)[0],
                        codes)}
json.dump(plans, open(spec["plans"], "w"))

prompt = inp["prompt"]
Bp, Sp = prompt.shape
gen = spec["gen"]
for case, tp in spec["serve_cases"]:
    cfg = cfg_of(case)
    params = jax.device_get(jax.jit(functools.partial(
        transformer.init_model, cfg=cfg, tp=tp))(jax.random.PRNGKey(0)))
    mesh = mesh_of(1, tp)
    _, pre_fn, _ = serve_mod.build_serve_fn(
        cfg, mesh, CommConfig(), isp.ShapeSpec("s", Sp, Bp, "prefill"),
        cache_capacity=Sp + gen)
    _, dec_fn, _ = serve_mod.build_serve_fn(
        cfg, mesh, CommConfig(),
        isp.ShapeSpec("s", Sp + gen, Bp, "decode"))
    st = pre_fn(params, {"tokens": jnp.asarray(prompt)})
    key = f"serve/{case}/{tp}/"
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
print("JAX MOE OK", len(out))
"""


def _inputs():
    rng = np.random.RandomState(0)
    cfg = _cfg()
    D = cfg.d_model
    uniq = rng.randn(BLOCK_B * BLOCK_S // 4, D).astype(np.float32)
    ties = np.tile(uniq, (4, 1)).reshape(BLOCK_B, BLOCK_S, D)
    x = rng.randn(BLOCK_B, BLOCK_S, D).astype(np.float32)
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "prompt": rng.randint(0, cfg.vocab_size,
                                  (B, SERVE_S)).astype(np.int32),
            "block_x/random": x, "block_x/drop": x, "block_x/ties": ties,
            "a2a_x": rng.randn(A2A_TOKENS, A2A_CFG["d_model"]
                               ).astype(np.float32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ref")
    np.savez(d / "inputs.npz", **_inputs())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "configs": str(d / "configs.json"), "plans": str(d / "plans.json"),
            "arch": ARCH, "cases": CASES, "tps": TPS, "grad_case": GRAD_CASE,
            "block_tps": BLOCK_TPS,
            "block_cases": {c: _block_cf(c) for c in BLOCK_CASES},
            "a2a_cfg": A2A_CFG, "a2a_dps": A2A_DPS, "gen": GEN,
            "serve_cases": SERVE_CASES}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX MOE OK" in out
    res = dict(np.load(d / "ref.npz"))
    res["configs"] = json.loads((d / "configs.json").read_text())
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


def _max_rel(got, want) -> dict:
    out = {}
    for (n, g), (m, w) in zip(_leaves(got), _leaves(want)):
        assert n == m
        w = torch.as_tensor(np.asarray(w))
        assert tuple(g.shape) == tuple(w.shape), n
        out[n] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                  1e-12)
    return out


def _runtime(cfg, tp, dp=1, comm=None):
    return Runtime(cfg=cfg, mesh=MeshContext.stacked(tp, dp),
                   comm=comm or CommConfig())


def _stack_rows(x, P):
    return torch.as_tensor(x).unsqueeze(0).expand(P, *x.shape)


# ----------------------------------------------------------------------
# Configs, the layout and the weight carrier
# ----------------------------------------------------------------------

@pytest.mark.parametrize("width", ["full", "smoke"])
def test_configs_match_jax(ref, width):
    """The port's copy of mixtral's config equals the JAX package's, field
    by field (dtype by name), and the family runs in the port."""
    cfg = (get_config if width == "full" else get_smoke_config)(ARCH)
    got = dataclasses.asdict(cfg)
    got["dtype"] = str(got["dtype"]).removeprefix("torch.")
    assert got == ref["configs"][width]
    transformer.require_ported_family(cfg)


@pytest.mark.parametrize("family,mla", [("dense", True), ("hybrid", False),
                                        ("vlm", False), ("audio", False)])
def test_unported_families_still_raise(family, mla):
    """MLA outside the moe family (deepseek-v3's attention runs in the moe
    family only) and the VLM and audio families still raise
    ``NotImplementedError``; the hybrid family (ported since) without MLA
    is admitted."""
    cfg = dataclasses.replace(_cfg(), family=family, use_mla=mla)
    if family == "hybrid" and not mla:
        transformer.require_ported_family(cfg)
        return
    with pytest.raises(NotImplementedError):
        transformer.require_ported_family(cfg)


@pytest.mark.parametrize("E,tp", [(8, 1), (8, 2), (8, 4), (8, 8), (8, 16),
                                  (4, 8), (256, 16), (8, 3), (6, 4)])
def test_moe_layout_matches_jax(E, tp):
    """``moe_layout`` gives the JAX package's ``(e_loc, tp_inner)``, and
    raises where it raises."""
    cfg = dataclasses.replace(_cfg(), n_experts=E)
    jcfg = JaxModelConfig(name="m", family="moe", n_layers=1, d_model=8,
                          n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8,
                          n_experts=E, n_experts_per_tok=2)
    try:
        want = jax_moe.moe_layout(jcfg, tp)
    except ValueError:
        with pytest.raises(ValueError):
            moe.moe_layout(cfg, tp)
        return
    assert moe.moe_layout(cfg, tp) == want


@pytest.mark.parametrize("tp", TPS)
def test_from_reference_round_trips_the_moe_tree(ref, tp):
    """The JAX package's tree at tp in (expert leaves ``(L, tp, e_loc, D,
    F)``), the port's stacked shards out (``(L, P, 1, e_loc, D, F)``), and
    back: equal; the port's own ``init_model`` builds the same tree; a
    tree built at another tp is refused."""
    cfg = _cfg("shared")
    np_params = _tree(ref, f"shared/param/{tp}/")
    params = sharding.from_reference(np_params, cfg, tp, "cpu")
    e_loc, _ = moe.moe_layout(cfg, tp)
    assert params["layers"]["moe"]["w_gate"].shape == (
        1, tp, 1, e_loc, cfg.d_model, cfg.moe_d_ff)
    assert params["dense_layers"]["mlp"]["w_up"].shape[:2] == (1, tp)
    back = sharding.unshard_params(params, cfg, tp)
    assert [n for n, _ in _leaves(back)] == [n for n, _ in
                                             _leaves(np_params)]
    for (n, a), (_, b) in zip(_leaves(back), _leaves(np_params)):
        assert np.array_equal(a.numpy(), b), n
    own = transformer.init_model(0, cfg, tp, "cpu")
    assert [(n, tuple(t.shape)) for n, t in _leaves(own)] == [
        (n, tuple(np.shape(t))) for n, t in _leaves(np_params)]
    other = _tree(ref, f"shared/param/{5 - tp}/")
    with pytest.raises(ValueError, match="expert stack built at tp"):
        sharding.from_reference(other, cfg, tp, "cpu")


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_mixtral_fsdp_plan_matches_jax(ref, width):
    """``build_fsdp_plan``'s codes on mixtral's tree equal the JAX
    package's at ``(2, 4)``, from shapes alone (the expert leaves' FSDP
    dim is ``D``)."""
    want = ref["plans"][width]
    cfg = (get_smoke_config if width == "smoke" else get_config)(ARCH)
    shapes = _tree({k: torch.empty(v["shape"], device="meta")
                    for k, v in want.items()}, "")
    plan = dict(_leaves(sharding.build_fsdp_plan(
        shapes, cfg, MeshContext.stacked(4, 2))))
    assert plan == {n: w["code"] for n, w in want.items()}
    assert plan["layers/moe/w_gate"] == plan["layers/moe/w_up"] == 204


def test_router_gradient_is_summed_over_the_model_axis():
    """The router is stored replicated and each rank back-propagates its
    own experts' gates: its gradient is summed over the model axis."""
    cfg = _cfg()
    full = transformer.init_model(0, cfg, 4, "cpu")
    mask = dict(_leaves(sharding.grad_model_sum_mask(full, cfg, 4)))
    assert mask["layers/moe/router"] == 1
    assert mask["layers/moe/w_gate"] == 0
    assert all(v == 0 for v in sharding.grad_model_sum_mask(
        full, cfg, 1)["layers"]["moe"].values())


# ----------------------------------------------------------------------
# The blocks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", BLOCK_CASES)
@pytest.mark.parametrize("tp", BLOCK_TPS)
def test_moe_block_matches_jax(ref, case, tp):
    """``moe_block`` at tp 1, 4 and 8 (``tp_inner`` 2) against the JAX
    package's: out within 1e-5, aux within 1e-6, on random tokens, with
    tokens dropped at capacity, and with tied gates."""
    cfg = _cfg(capacity_factor=_block_cf(case))
    params = sharding.from_reference(
        {"moe": _tree(ref, f"block/{case}/{tp}/param/")}, cfg, tp, "cpu")
    x = _stack_rows(_inputs()[f"block_x/{case}"], tp)
    rt = _runtime(cfg, tp)
    with torch.no_grad():
        y, aux = moe.moe_block(params["moe"], x, rt)
    assert torch.equal(y, y[:1].expand_as(y))
    assert torch.equal(aux, aux[:1].expand_as(aux))
    want = ref[f"block/{case}/{tp}/y"]
    assert float(np.abs(y[0].numpy() - want).max()) < BLOCK_TOL
    assert abs(float(aux[0]) - float(ref[f"block/{case}/{tp}/aux"])) < AUX_TOL
    if case != "random":
        assert int(moe.dropped(params["moe"], x, cfg)[0]) > 0


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_dropped_counts_what_the_capacity_cut_leaves_out(ref, case):
    """``moe.dropped`` against the block itself, at tp 1: with room for
    every token (``capacity_factor`` ``E / k``) it counts nothing, and a
    token's output moves between that block and the cut one only where
    one of its assignments was dropped (no more tokens than the count,
    and some where the count is not 0)."""
    cfg = _cfg(capacity_factor=_block_cf(case))
    room = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.n_experts_per_tok)
    params = sharding.from_reference(
        {"moe": _tree(ref, f"block/{case}/1/param/")}, cfg, 1, "cpu")["moe"]
    x = _stack_rows(_inputs()[f"block_x/{case}"], 1)
    with torch.no_grad():
        y_cut, _ = moe.moe_block(params, x, _runtime(cfg, 1))
        y_all, _ = moe.moe_block(params, x, _runtime(room, 1))
    n = int(moe.dropped(params, x, cfg)[0])
    assert int(moe.dropped(params, x, room)[0]) == 0
    moved = int(((y_cut - y_all).abs().amax(-1) > BLOCK_TOL).sum())
    assert moved <= n and (moved > 0) == (n > 0), (moved, n)
    if case != "random":
        assert n > 0


@pytest.mark.parametrize("k", [1, 3, 5])
def test_top_k_ties_follow_the_lower_index(k):
    """The port's top-k picks what ``lax.top_k`` picks: among equal values
    the lower index first (the expert choice and the capacity cut both
    take it)."""
    v = np.array([[0.5, 0.75, 0.75, 0.25, 0.75], [0.0, 0.0, 1.0, 0.0, 0.5]],
                 np.float32)
    vals, idx = moe._top_k(torch.as_tensor(v), k)
    jvals, jidx = jax.lax.top_k(v, k)
    assert idx.tolist() == np.asarray(jidx).tolist()
    assert vals.tolist() == np.asarray(jvals).tolist()


A2A_CFGS = [("fused", CommConfig(mode=CommMode.BUFFERED,
                                 scheduling=Scheduling.FUSED))] + [
    (f"overlapped/{t.value}", CommConfig(
        mode=CommMode.STREAMING, scheduling=Scheduling.OVERLAPPED,
        transport=t, window=2, chunk_bytes=512))
    for t in (Transport.ORDERED, Transport.UNORDERED)]


@pytest.mark.parametrize("dp", A2A_DPS)
def test_moe_block_a2a_matches_jax_and_is_bitwise_across_schedules(ref, dp):
    """``moe_block_a2a`` on stacked data ranks: the fused all-to-all's
    output within 1e-5 of the JAX package's (aux within 1e-6), and the
    overlapped streaming schedules under both transports bitwise equal to
    it.  Replicated parameters: every rank applies experts ``0 .. e_loc -
    1`` of its tree, as the JAX package does."""
    cfg = ModelConfig(**A2A_CFG, dtype=torch.float32)
    params = sharding.shard_params(
        {"moe": {k: torch.as_tensor(v) for k, v in
                 _tree(ref, "a2a/param/").items()}}, cfg, 1, dp=dp)["moe"]
    xs = torch.as_tensor(_inputs()["a2a_x"]).reshape(dp, -1,
                                                     cfg.d_model)
    outs = {}
    for label, comm in A2A_CFGS:
        with torch.no_grad():
            outs[label] = moe.moe_block_a2a(params, xs,
                                            _runtime(cfg, 1, dp, comm))
    y, aux = outs["fused"]
    want = ref[f"a2a/{dp}/y"]
    assert float(np.abs(y.reshape(-1, cfg.d_model).numpy() - want).max()) \
        < BLOCK_TOL
    np.testing.assert_allclose(aux.numpy(), ref[f"a2a/{dp}/aux"],
                               atol=AUX_TOL, rtol=0)
    for label, (y2, aux2) in outs.items():
        assert torch.equal(y2, y) and torch.equal(aux2, aux), label


# ----------------------------------------------------------------------
# Forward, loss and gradients
# ----------------------------------------------------------------------

def _batch():
    return {k: torch.as_tensor(v).long() for k, v in _inputs().items()
            if k in ("tokens", "labels")}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tp", TPS)
def test_forward_matches_jax(ref, case, tp):
    """Forward logits (vocab shards concatenated), the loss ``ce + 0.01 ·
    aux`` and the aux at tp 1 and 4 against the JAX package's, within
    1e-5."""
    cfg = _cfg(case)
    params = sharding.from_reference(_tree(ref, f"{case}/param/{tp}/"), cfg,
                                     tp, "cpu")
    rt = _runtime(cfg, tp)
    with torch.no_grad():
        logits = transformer.forward(params, _batch(), rt).logits
        loss, parts = transformer.loss_fn(params, _batch(), rt)
    logits = torch.cat(logits.unbind(0), dim=-1).numpy()
    want = ref[f"{case}/logits/{tp}"]
    assert logits.shape == want.shape
    assert float(np.abs(logits - want).max()) < LOGIT_TOL
    assert torch.equal(loss, loss[:1].expand_as(loss))
    assert abs(float(loss[0]) - float(ref[f"{case}/loss/{tp}"])) < LOGIT_TOL
    assert abs(float(parts["aux"][0]) - float(ref[f"{case}/aux/{tp}"])) \
        < LOGIT_TOL
    assert torch.equal(loss, parts["ce"] + 0.01 * parts["aux"])


def test_grads_match_jax(ref):
    """One step's gradients at ``(2, 4)`` (model-synced, averaged over the
    data ranks) against the JAX package's, each leaf within 1e-4 of its
    max|grad|, on the shared-expert, dense-head variant (every leaf kind
    of the smoke config and the dense head's and shared expert's): the
    router's (summed over the model axis, its aux path scaled by 1/tp)
    and the embedding's (through the block's *f* operator, and the shared
    expert's own) among them."""
    case = GRAD_CASE
    cfg = _cfg(case)
    sess = setup.build_session(cfg, mesh_mod.make_test_mesh(2, 4),
                               CommConfig(), oc=adamw.OptConfig(zero1=False),
                               device="cpu")
    sess.params = sharding.from_reference(_tree(ref, f"{case}/param/4/"),
                                          cfg, 4, "cpu", dp=2)
    rt = sess.rt
    loss, _, grads = ts.make_loss_and_grad(rt)(
        sess.params, setup.shard_batch(sess, _inputs()))
    grads = ts.grad_model_sync(grads, sess.mask, rt)
    grads = adamw._unflatten(grads, [
        adamw.leaf_all_reduce(g, n, rt.dp_comm(), rt.comm) / 2
        for n, g in adamw.leaves_with_names(grads)])
    loss = collectives.all_reduce(loss, rt.dp_comm(), rt.comm) / 2
    assert abs(float(loss[0]) - float(ref[f"{case}/grad_loss"])) < LOGIT_TOL
    errs = _max_rel(setup.global_params(sess, grads),
                    _tree(ref, f"{case}/grad/"))
    assert max(errs.values()) < GRAD_TOL, errs
    assert "layers/moe/router" in errs


def test_fsdp_steps_equal_the_replicated_steps():
    """Under FSDP at ``(2, 4)`` the expert leaves are cut over the data
    ranks on ``D`` and gathered inside the recomputed unit: two ZeRO-1
    AdamW steps train as the replicated session's do (losses within 5e-4,
    every parameter within 8e-3 of its leaf's max, the bounds of
    ``tests/test_torch_dense_family.py``)."""
    cfg = dataclasses.replace(_cfg("shared"), remat=True)
    mesh = mesh_mod.make_test_mesh(2, 4)
    out = {}
    for fsdp in (False, True):
        sess = setup.build_session(
            cfg, mesh, CommConfig(), device="cpu", fsdp=fsdp,
            oc=adamw.OptConfig(zero1=True, lr=1e-2, warmup_steps=1,
                               total_steps=100))
        step = setup.make_sharded_train_step(sess, donate=False)
        p, o, losses = sess.params, sess.opt_state, []
        for _ in range(2):
            p, o, m = step(p, o, _inputs())
            losses.append(float(m["loss"]))
        out[fsdp] = losses, setup.global_params(sess, p)
    assert sess.rt.fsdp_plan["layers"]["moe"]["w_down"] == 204
    np.testing.assert_allclose(out[True][0], out[False][0], atol=5e-4,
                               rtol=0)
    errs = _max_rel(out[True][1], out[False][1])
    assert max(errs.values()) < 8e-3, errs


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

def _global_cache(c: torch.Tensor) -> np.ndarray:
    """``(L, P, B, S_shard, KV, hd)`` -> ``(L, B, S, KV, hd)``."""
    L, P, Bc, Ls = c.shape[:4]
    return c.permute(0, 2, 1, 3, 4, 5).reshape(
        L, Bc, P * Ls, *c.shape[4:]).numpy()


def _port_serve(params, cfg, tp, prompt, gen=GEN):
    _, pre = serve.build_serve_fn(cfg, tp, CommConfig(),
                                  isp.ShapeSpec("s", SERVE_S, B, "prefill"),
                                  cache_capacity=SERVE_S + GEN, device="cpu")
    rt, step = serve.build_serve_fn(
        cfg, tp, CommConfig(), isp.ShapeSpec("s", SERVE_S + GEN, B,
                                             "decode"), device="cpu")
    st = pre(params, {"tokens": prompt})
    first = (st.last_logits.clone(), st.caches.k.clone(),
             st.caches.v.clone())
    toks = []
    for _ in range(gen):
        nxt = dec.greedy_tokens(st, rt)
        toks.append(nxt)
        st = step(params, nxt, st)
    return first, torch.stack(toks, 1), st, rt


def _close(got, want, what, rel=SERVE_REL):
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} over {tol}"


@pytest.mark.parametrize("case,tp", SERVE_CASES)
def test_serving_matches_jax(ref, case, tp):
    """Prefill (24 tokens) and 16 greedy decode steps, past the 32-token
    window, at tp 1 and 4 against the JAX package's: logits within 1e-4 of
    their max, greedy tokens equal, and the port's one layer-order cache
    (the dense head, then the MoE layers) equal to the JAX package's
    ``{"dense", "moe"}`` caches within 1e-4 of their max."""
    cfg = _cfg(case)
    params = sharding.from_reference(_tree(ref, f"{case}/param/{tp}/"), cfg,
                                     tp, "cpu")
    (logits, k, v), toks, st, _ = _port_serve(params, cfg, tp,
                                              _inputs()["prompt"])
    key = f"serve/{case}/{tp}/"
    _close(torch.cat(logits.unbind(0), -1).numpy(),
           ref[key + "prefill_logits"], "prefill logits")
    np.testing.assert_array_equal(toks.numpy(), ref[key + "tokens"])
    _close(torch.cat(st.last_logits.unbind(0), -1).numpy(),
           ref[key + "decode_logits"], "decode logits")
    nd = cfg.n_dense_layers
    for when, kk, vv in (("prefill", k, v),
                         ("decode", st.caches.k, st.caches.v)):
        want = _tree(ref, key + f"{when}_cache/")
        for name, got in (("k", _global_cache(kk)), ("v", _global_cache(vv))):
            parts = [("moe", got[nd:])] + ([("dense", got[:nd])] if nd
                                           else [])
            assert sorted(want) == sorted(p for p, _ in parts)
            for part, g in parts:
                w = want[part][name]
                assert g.shape == w.shape, (when, name, part)
                _close(g, w, f"{when} {part} {name}")


@pytest.mark.parametrize("case", CASES)
def test_decode_equals_prefill_of_the_extended_sequence(case):
    """Inside the port at tp 4: after 16 decode steps, the last logits
    equal those of a prefill of the prompt and the generated tokens
    (within 1e-4 of their max), past the window.  Both run with room for
    every token (``capacity_factor`` ``E / k``): at the default 1.25 the
    160-token prefill's capacity cut drops tokens that a 4-token decode
    step keeps, so the two are different functions."""
    cfg = dataclasses.replace(_cfg(case), capacity_factor=2.0)
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


# ----------------------------------------------------------------------
# The sweep's moe_loop consumer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("msg_bytes", [1 << 10, 1 << 14, 1 << 20])
def test_moe_loop_consumer_matches_jax(msg_bytes):
    assert sweep.CONSUMERS == jax_sweep.CONSUMERS
    assert sweep.CONSUMERS["all_to_all"] == ("moe_loop",)
    assert (sweep._MOE_D, sweep._MOE_FF) == (jax_sweep._MOE_D,
                                             jax_sweep._MOE_FF)
    for consumer in (None, "moe_loop"):
        assert sweep.consumer_flops("all_to_all", msg_bytes, consumer) == \
            jax_sweep.consumer_flops("all_to_all", msg_bytes, consumer) > 0


def test_moe_all_to_all_e2e_sweep_selects_measured_best():
    """An e2e all_to_all sweep on 8 stacked CPU ranks records the
    moe_loop consumer's time for every candidate, and
    ``select_config(objective="e2e")`` returns the measured best."""
    stats = {}
    db = tune.run_sweep(8, collectives=("all_to_all",), sizes=(16384,),
                        fast=True, max_configs=5, reps=1, inner=2,
                        device="cpu", objective="e2e", stats=stats)
    ents = [e for e in db.entries if e.collective == "all_to_all"]
    assert ents and all(e.e2e_us > 0.0 and e.consumer == "moe_loop"
                        for e in ents), stats
    assert stats["e2e_measured"] == len(ents), stats
    cfg = tune.select_config("all_to_all", 16384, db=db, topo=ents[0].topo,
                             objective="e2e")
    # the measured best: the fastest loop, or among loops within NEAR_TIE
    # of it the one with the lowest measured p95 (the DB's tie rule)
    fastest = min(ents, key=lambda e: e.e2e_us)
    near = [e for e in ents
            if e.e2e_us <= fastest.e2e_us * (1.0 + tune.TuneDB.NEAR_TIE)]
    tails = [e for e in near if e.p95_us > 0.0]
    want = (min(tails, key=lambda e: (e.p95_us, e.e2e_us))
            if len(near) > 1 and tails else fastest)
    assert cfg == want.comm_config
