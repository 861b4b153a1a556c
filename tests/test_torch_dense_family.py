"""The rest of the dense family in the port — command-r-plus-104b,
deepseek-coder-33b (padded heads) and gemma3-1b (5:1 local/global
attention) — against the JAX package, on the CPU, in their smoke configs
and float32.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:n]).reshape(dp, tp), ("data", "model"))``):
each arch's configs, full and smoke, field by field; its parameters
(``init_model`` at tp 4: padded head counts are config-level, so the tree
is the same at every tp); forward logits and loss at tp 1 and 4;
one step's gradients at ``(2, 4)`` (model-synced, the mean over the data
ranks); gemma3's FSDP plan codes (full and smoke, shapes only); 3 ZeRO-1
AdamW steps of gemma3 at ``(2, 4)``; and gemma3 serving at tp 1 and 4 (on
the steps' initial parameters): a 24-token prompt prefilled into caches
of 32 positions and 8 greedy decode steps, past the smoke config's
16-token window.  A gemma3 variant with
``shard_attn="replicate"`` (the full config's layout: attention computed
on every rank, no combine) joins the forward and gradient cases.  The port
takes the same parameters through ``sharding.from_reference``.

Tolerances: logits and loss within 1e-5 (absolute); gradients within 1e-4
of each leaf's max|grad| and the 3-step losses within 5e-4, parameters
within 8e-3 of each leaf's max (``tests/test_distributed_parity.py``'s
``GRAD_TOL`` and ``tests/test_torch_train.py``'s bounds); serving logits
and caches within 1e-4 of their max (``tests/test_torch_serve.py``),
greedy tokens equal.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import collectives
from repro_torch.core.config import CommConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import input_specs as isp, mesh as mesh_mod, setup
from repro_torch.models import decode as dec, sharding, transformer
from repro_torch.models.common import MeshContext, Runtime
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.faults import FaultInjector, FaultSchedule
from repro_torch.train import loop as loop_mod, serve, train_step as ts

ARCHS = ("command-r-plus-104b", "deepseek-coder-33b", "gemma3-1b")
# forward and gradient cases: the three archs, and gemma3 with the full
# config's replicated attention
CASES = ARCHS + ("gemma3-1b/replicate",)
TPS = (1, 4)
OC = dict(lr=1e-2, warmup_steps=1, total_steps=100)
B, S, STEPS = 4, 32, 3
SERVE_S, GEN = 24, 8
LOGIT_TOL, GRAD_TOL, LOSS_TOL, PARAM_REL, SERVE_REL = 1e-5, 1e-4, 5e-4, \
    8e-3, 1e-4


def _cfg(case):
    arch, _, variant = case.partition("/")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    if variant:
        cfg = dataclasses.replace(cfg, shard_attn="replicate")
    return cfg


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

def cfg_of(case):
    arch, _, variant = case.partition("/")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    if variant:
        cfg = dataclasses.replace(cfg, shard_attn="replicate")
    return cfg

for arch in spec["archs"]:
    for width, c in (("full", get_config(arch)),
                     ("smoke", get_smoke_config(arch))):
        d = dataclasses.asdict(c)
        d["dtype"] = jnp.dtype(d["dtype"]).name
        configs[f"{arch}/{width}"] = d
json.dump(configs, open(spec["configs"], "w"))

bspec = {"tokens": P(("data",)), "labels": P(("data",))}
for case in spec["cases"]:
    cfg = cfg_of(case)
    sess = setup.build_session(cfg, mesh_of(2, 4), CommConfig(),
                               oc=adamw.OptConfig(zero1=False),
                               concrete=False)
    params = jax.device_get(jax.jit(functools.partial(
        transformer.init_model, cfg=cfg, tp=4))(jax.random.PRNGKey(0)))
    out.update(flat(params, f"{case}/param/"))
    for tp in spec["tps"]:
        s = setup.build_session(cfg, mesh_of(1, tp), CommConfig(),
                                concrete=False)
        rt = s.rt

        def f(p, b, rt=rt):
            logits = transformer.forward(p, b, rt, train=False).logits
            loss, _ = transformer.loss_fn(p, b, rt)
            return logits, loss
        fn = jax.jit(compat.shard_map(
            f, mesh=s.mesh, in_specs=(s.param_spec, {"tokens": P(),
                                                     "labels": P()}),
            out_specs=(P(None, None, "model"), P()), check_vma=False))
        logits, loss = fn(params, batch)
        out[f"{case}/logits/{tp}"] = np.asarray(logits)
        out[f"{case}/loss/{tp}"] = np.asarray(loss)
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
    cfg = (get_smoke_config if width == "smoke" else get_config)("gemma3-1b")
    mc = MeshContext(model_size=4, data_sizes=(2,))
    shapes = jax.eval_shape(functools.partial(
        transformer.init_model, cfg=cfg, tp=4), jax.random.PRNGKey(0))
    codes = jax.tree.leaves(sharding.build_fsdp_plan(shapes, cfg, mc))
    plans[width] = {name(path): {"shape": list(s.shape), "code": int(c)}
                    for (path, s), c in zip(
                        jax.tree_util.tree_flatten_with_path(shapes)[0],
                        codes)}
json.dump(plans, open(spec["plans"], "w"))

cfg = cfg_of("gemma3-1b")
oc = adamw.OptConfig(zero1=True, **spec["oc"])
sess = setup.build_session(cfg, mesh_of(2, 4), CommConfig(), oc=oc)
out.update(flat(sess.params, "step/param0/"))
step = setup.make_sharded_train_step(sess, donate=False)(bspec)
p, o = sess.params, sess.opt_state
losses = []
for _ in range(spec["steps"]):
    p, o, m = step(p, o, batch)
    losses.append(float(m["loss"]))
out["step/losses"] = np.asarray(losses)
out.update(flat(p, "step/param/"))

params = jax.device_get(sess.params)     # step/param0
prompt = np.load(spec["inputs"])["prompt"]
Bp, Sp = prompt.shape
gen = spec["gen"]
for tp in spec["tps"]:
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
print("JAX DENSE FAMILY OK", len(out))
"""


def _batch():
    rng = np.random.RandomState(0)
    vocab = get_smoke_config("gemma3-1b").vocab_size
    assert all(get_smoke_config(a).vocab_size == vocab for a in ARCHS)
    return {"tokens": rng.randint(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.randint(0, vocab, (B, S)).astype(np.int32),
            "prompt": rng.randint(0, vocab, (B, SERVE_S)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense_family_ref")
    np.savez(d / "inputs.npz", **_batch())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "configs": str(d / "configs.json"), "plans": str(d / "plans.json"),
            "archs": ARCHS, "cases": CASES, "tps": TPS, "oc": OC,
            "steps": STEPS, "gen": GEN}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX DENSE FAMILY OK" in out
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


def _runtime(cfg, tp):
    return Runtime(cfg=cfg, mesh=MeshContext.stacked(tp), comm=CommConfig())


# ----------------------------------------------------------------------
# Configs and the weight carrier
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("width", ["full", "smoke"])
def test_configs_match_jax(ref, arch, width):
    """The port's copy of each config equals the JAX package's, field by
    field (dtype by name), and the family runs in the port."""
    cfg = (get_config if width == "full" else get_smoke_config)(arch)
    want = ref["configs"][f"{arch}/{width}"]
    got = dataclasses.asdict(cfg)
    got["dtype"] = str(got["dtype"]).removeprefix("torch.")
    assert got == want
    transformer.require_ported_family(cfg)


def test_list_archs_names_the_ported_archs():
    assert list_archs() == sorted(ARCHS + ("deepseek-v3-671b", "mamba2-130m",
                                           "mixtral-8x22b", "qwen3-8b",
                                           "zamba2-7b"))


@pytest.mark.parametrize("tp,dp,fsdp_dp", [(4, 1, 1), (4, 2, 2)])
def test_from_reference_round_trips_the_gemma3_tree(ref, tp, dp, fsdp_dp):
    """The JAX package's gemma3 tree (``blocks/{local,global}``,
    ``trailing``) in, the port's stacked shards out (``local`` leaves
    ``(n_blocks, r, P, ...)``), and back: equal; the port's own
    ``init_model`` builds the same tree."""
    cfg = _cfg("gemma3-1b")
    np_params = _tree(ref, "gemma3-1b/param/")
    mesh = mesh_mod.make_test_mesh(dp, tp)
    plan = (sharding.build_fsdp_plan(np_params, cfg, mesh)
            if fsdp_dp > 1 else None)
    params = sharding.from_reference(np_params, cfg, tp, "cpu", dp=dp,
                                     fsdp_dp=fsdp_dp)
    nb, nt = transformer.local_global_counts(cfg)
    assert (nb, nt) == (2, 2)
    wq = params["blocks"]["local"]["attn"]["wq"]
    assert wq.shape[:3] == (nb, cfg.local_global_ratio, dp * tp)
    assert params["trailing"]["ln1"].shape == (nt, dp * tp, cfg.d_model)
    back = sharding.unshard_params(params, cfg, tp, plan, fsdp_dp)
    names = [n for n, _ in _leaves(back)]
    assert names == [n for n, _ in _leaves(np_params)]
    for (n, a), (_, b) in zip(_leaves(back), _leaves(np_params)):
        assert np.array_equal(a.numpy(), b), n
    own = transformer.init_model(0, cfg, tp, "cpu")
    assert [(n, tuple(t.shape)) for n, t in _leaves(own)] == [
        (n, tuple(np.shape(t))) for n, t in _leaves(np_params)]


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_gemma3_fsdp_plan_matches_jax(ref, width):
    """``build_fsdp_plan``'s codes on the gemma3 tree equal the JAX
    package's at ``(2, 4)``, from shapes alone (two stack dims under
    ``blocks/local``)."""
    want = ref["plans"][width]
    cfg = (get_smoke_config if width == "smoke" else get_config)("gemma3-1b")
    shapes = _tree({k: torch.empty(v["shape"], device="meta")
                    for k, v in want.items()}, "")
    plan = dict(_leaves(sharding.build_fsdp_plan(
        shapes, cfg, MeshContext.stacked(4, 2))))
    assert plan == {n: w["code"] for n, w in want.items()}
    assert plan["blocks/local/mlp/w_up"] >= 0


# ----------------------------------------------------------------------
# Forward, gradients and steps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tp", TPS)
def test_forward_matches_jax(ref, case, tp):
    """Forward logits (vocab shards concatenated) and the loss at tp 1 and
    4 against the JAX package's, within 1e-5."""
    cfg = _cfg(case)
    params = sharding.from_reference(_tree(ref, f"{case}/param/"), cfg, tp,
                                     "cpu")
    rt = _runtime(cfg, tp)
    batch = {k: torch.as_tensor(v).long()
             for k, v in _batch().items() if k != "prompt"}
    with torch.no_grad():
        logits = transformer.forward(params, batch, rt).logits
        loss, _ = transformer.loss_fn(params, batch, rt)
    logits = torch.cat(logits.unbind(0), dim=-1).numpy()
    want = ref[f"{case}/logits/{tp}"]
    assert logits.shape == want.shape
    assert float(np.abs(logits - want).max()) < LOGIT_TOL
    assert torch.equal(loss, loss[:1].expand_as(loss))
    assert abs(float(loss[0]) - float(ref[f"{case}/loss/{tp}"])) < LOGIT_TOL


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax(ref, case):
    """One step's gradients at ``(2, 4)`` (model-synced, averaged over the
    data ranks) against the JAX package's, each leaf within 1e-4 of its
    max|grad|."""
    cfg = _cfg(case)
    sess = setup.build_session(cfg, mesh_mod.make_test_mesh(2, 4),
                               CommConfig(), oc=adamw.OptConfig(zero1=False),
                               device="cpu")
    sess.params = sharding.from_reference(_tree(ref, f"{case}/param/"), cfg,
                                          4, "cpu", dp=2)
    rt = sess.rt
    loss, _, grads = ts.make_loss_and_grad(rt)(
        sess.params, setup.shard_batch(sess, _batch()))
    grads = ts.grad_model_sync(grads, sess.mask, rt)
    grads = adamw._unflatten(grads, [
        adamw.leaf_all_reduce(g, n, rt.dp_comm(), rt.comm) / 2
        for n, g in adamw.leaves_with_names(grads)])
    loss = collectives.all_reduce(loss, rt.dp_comm(), rt.comm) / 2
    assert abs(float(loss[0]) - float(ref[f"{case}/grad_loss"])) < LOGIT_TOL
    errs = _max_rel(setup.global_params(sess, grads),
                    _tree(ref, f"{case}/grad/"))
    assert max(errs.values()) < GRAD_TOL, errs


def _gemma3_session(ref, **kw):
    cfg = _cfg("gemma3-1b")
    mesh = mesh_mod.make_test_mesh(2, 4)
    sess = setup.build_session(cfg, mesh, CommConfig(),
                               oc=adamw.OptConfig(zero1=True, **OC),
                               device="cpu", **kw)
    sess.params = sharding.from_reference(
        _tree(ref, "step/param0/"), cfg, 4, "cpu", dp=2,
        fsdp_dp=2 if kw.get("fsdp") else 1)
    return sess


def _steps(sess, steps=STEPS):
    step = setup.make_sharded_train_step(sess, donate=False)
    p, o, losses = sess.params, sess.opt_state, []
    for _ in range(steps):
        p, o, m = step(p, o, _batch())
        losses.append(float(m["loss"]))
    return losses, setup.global_params(sess, p)


@pytest.fixture(scope="module")
def gemma3_steps(ref):
    return _steps(_gemma3_session(ref))


def test_gemma3_adamw_steps_match_jax(ref, gemma3_steps):
    """Three ZeRO-1 AdamW steps of gemma3 at ``(2, 4)``: the losses within
    5e-4 and every parameter leaf within 8e-3 of its max, against the JAX
    package's."""
    losses, params = gemma3_steps
    np.testing.assert_allclose(losses, ref["step/losses"], atol=LOSS_TOL,
                               rtol=0)
    assert losses[-1] < losses[0]
    errs = _max_rel(params, _tree(ref, "step/param/"))
    assert max(errs.values()) < PARAM_REL, errs


@pytest.mark.parametrize("layout", ["fsdp", "seq_parallel"])
def test_gemma3_layouts_equal_the_replicated_run(ref, gemma3_steps, layout):
    """FSDP at ``(2, 4)`` (the ``local`` leaves gathered with their inner
    layer dim) trains as the replicated run does, within the same bounds;
    ``seq_parallel=True`` is inactive under local/global attention (the
    stack runs the plain block, as in the JAX package): the same steps,
    bitwise, and no norm summed over the model axis."""
    sess = _gemma3_session(ref, **{layout: True})
    if layout == "fsdp":
        codes = dict(_leaves(sess.rt.fsdp_plan))
        assert codes["blocks/local/attn/wq"] >= 0
        assert codes["trailing/mlp/w_down"] >= 0
    else:
        assert sess.mask == _gemma3_session(ref).mask
    losses, params = _steps(sess)
    base_losses, base = gemma3_steps
    if layout == "seq_parallel":
        assert losses == base_losses
        for (n, a), (_, b) in zip(_leaves(params), _leaves(base)):
            assert torch.equal(a, b), n
        return
    np.testing.assert_allclose(losses, base_losses, atol=LOSS_TOL, rtol=0)
    errs = _max_rel(params, base)
    assert max(errs.values()) < PARAM_REL, errs


def test_gemma3_checkpoint_restore_and_resume(ref, tmp_path):
    """A gemma3 checkpoint holds the JAX package's leaf names (its
    ``flatten_with_path`` of the same tree); an FSDP session's checkpoint
    restores onto ``(1, 4)`` bit for bit; ``preempt@2`` at ``(2, 4)``,
    ZeRO-1 (slices over leaves with two stack dims), resumes bitwise."""
    cfg = _cfg("gemma3-1b")
    oc = adamw.OptConfig(zero1=True, **OC)
    fs = _gemma3_session(ref, fsdp=True)
    Checkpointer(tmp_path / "fsdp").save(0, setup.global_params(fs))
    with np.load(tmp_path / "fsdp" / "ckpt_00000000.npz") as z:
        assert sorted(z.files) == sorted(
            k[len("step/param0/"):] for k in ref
            if k.startswith("step/param0/"))
    sess, step = ft.elastic_restore(tmp_path / "fsdp", cfg,
                                    mesh_mod.make_test_mesh(1, 4),
                                    CommConfig(), oc, device="cpu")
    assert step == 0
    for (n, a), (_, b) in zip(_leaves(setup.global_params(sess)),
                              _leaves(setup.global_params(fs))):
        assert torch.equal(a, b), n
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)

    def fresh():
        return setup.build_session(cfg, mesh_mod.make_test_mesh(2, 4),
                                   CommConfig(), oc=oc, device="cpu")

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
    sess, start = ft.resume_session(ck, fresh())
    assert start == 2
    part2 = loop_mod.train(sess, data, loop(2), log=lambda *_: None)
    assert part1 + part2 == want, (part1 + part2, want)


def test_gemma3_remat_units_are_super_blocks(monkeypatch):
    """With remat on, training recomputes one unit per super-block and
    none for the trailing layers (the JAX package's remat placement)."""
    cfg = dataclasses.replace(_cfg("gemma3-1b"), remat=True)
    params = sharding.shard_params(transformer.init_model(0, cfg, 4, "cpu"),
                                   cfg, 4)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counted(fn, *args, **kw):
        calls.append(1)
        return real(fn, *args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    batch = {k: torch.as_tensor(v).long()
             for k, v in _batch().items() if k != "prompt"}
    rt = _runtime(cfg, 4)
    out = transformer.forward(params, batch, rt, train=True).logits
    assert len(calls) == transformer.local_global_counts(cfg)[0] == 2
    calls.clear()
    with torch.no_grad():
        assert torch.equal(transformer.forward(params, batch, rt).logits,
                           out.detach())
    assert not calls


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

def _nested(c: torch.Tensor, cfg) -> dict:
    """The port's layer-order cache ``(L, P, B, S_shard, KV, hd)`` on the
    JAX package's nested layout, global over the sequence shards:
    ``blocks/local (nb, r, B, S, KV, hd)``, ``blocks/global (nb, ...)``,
    ``trailing (nt, ...)``."""
    L, P, Bc, Ls = c.shape[:4]
    g = c.permute(0, 2, 1, 3, 4, 5).reshape(L, Bc, P * Ls, *c.shape[4:])
    r = cfg.local_global_ratio
    nb, nt = transformer.local_global_counts(cfg)
    blocks = g[:nb * (r + 1)].reshape(nb, r + 1, *g.shape[1:])
    return {"blocks": {"local": blocks[:, :r].numpy(),
                       "global": blocks[:, r].numpy()},
            "trailing": g[nb * (r + 1):].numpy()}


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


@pytest.mark.parametrize("tp", TPS)
def test_gemma3_serving_matches_jax(ref, tp):
    """gemma3 prefill (24 tokens, past the 16-token window) and 8 greedy
    decode steps at tp 1 and 4 against the JAX package's: logits within
    1e-4 of their max, greedy tokens equal, and the port's one layer-order
    cache, mapped onto the JAX package's nested caches, equal to them
    within 1e-4 of their max (the positions past the written ones zero on
    both sides)."""
    cfg = _cfg("gemma3-1b")
    params = sharding.from_reference(_tree(ref, "step/param0/"), cfg, tp,
                                     "cpu")
    (logits, k, v), toks, st, _ = _port_serve(params, cfg, tp,
                                              _batch()["prompt"])
    key = f"serve/{tp}/"
    _close(torch.cat(logits.unbind(0), -1).numpy(),
           ref[key + "prefill_logits"], "prefill logits")
    np.testing.assert_array_equal(toks.numpy(), ref[key + "tokens"])
    _close(torch.cat(st.last_logits.unbind(0), -1).numpy(),
           ref[key + "decode_logits"], "decode logits")
    for when, kk, vv in (("prefill", k, v),
                         ("decode", st.caches.k, st.caches.v)):
        want = _tree(ref, key + f"{when}_cache/")
        for name, got in (("k", _nested(kk, cfg)), ("v", _nested(vv, cfg))):
            for part in ("blocks/local", "blocks/global", "trailing"):
                w = want
                g = got
                for p in part.split("/"):
                    w, g = w[p], g[p]
                w = w[name]
                assert g.shape == w.shape, (when, name, part)
                _close(g, w, f"{when} {part} {name}")
                filled = SERVE_S if when == "prefill" else SERVE_S + GEN
                assert not np.any(g[..., filled:, :, :]) and \
                    not np.any(w[..., filled:, :, :])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_prefill_of_the_extended_sequence(arch):
    """Inside the port at tp 4: after 8 decode steps, the last logits equal
    those of a prefill of the prompt and the generated tokens (within
    1e-4 of their max), for each arch (gemma3's window passed)."""
    cfg = _cfg(arch)
    params = sharding.shard_params(transformer.init_model(0, cfg, 4, "cpu"),
                                   cfg, 4)
    prompt = _batch()["prompt"]
    _, toks, st, rt = _port_serve(params, cfg, 4, prompt)
    seq = np.concatenate([prompt, toks.numpy()], axis=1)
    _, pre = serve.build_serve_fn(cfg, 4, CommConfig(),
                                  isp.ShapeSpec("s", seq.shape[1], B,
                                                "prefill"), device="cpu")
    ext = pre(params, {"tokens": seq})
    _close(st.last_logits.numpy(), ext.last_logits.numpy(),
           "decode vs extended prefill")
    assert torch.equal(dec.greedy_tokens(st, rt), dec.greedy_tokens(ext, rt))
