"""The port's SSM serving path (mamba2's smoke config, float32) against the
JAX package's ``train/serve.py::build_serve_fn``, on the CPU.

The JAX side runs once, in one 4-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("data", "model"))``):
for two configurations — the smoke config (8 SSD heads of 16: heads shard
at tp 2 and 4) and the same with ``ssm_head_dim=64`` (2 heads: ``2 % 4``,
so the layer computes replicated at tp 4) — it initialises the parameters,
then for each tp and for ``CommConfig()`` and ``BASELINE_CONFIG`` prefills
a seeded (4, 32) prompt and decodes 4 greedy tokens.  The port takes the
same parameters through ``sharding.from_reference``.

Tolerances:

- logits: ``1e-4 * max|logit|`` (both sides compute in float32; the
  summation orders of the matmuls, the combines and the SSD scan's
  cumulative decay differ);
- the per-layer conv and SSD states: ``1e-4 * max|state|`` elementwise;
- greedy tokens: equal;
- within the port, decode ≡ prefill of the extended sequence (16 prompt +
  16 decoded tokens): logits and states within ``1e-4 * max``."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import transformer as jax_transformer

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.config import BASELINE_CONFIG, CommConfig
from repro_torch.launch import input_specs as isp
from repro_torch.models import decode as dec, sharding, ssm, transformer
from repro_torch.train import serve

SMOKE = dataclasses.replace(get_smoke_config("mamba2-130m"),
                            dtype=torch.float32)
CFGS = {"sharded": SMOKE,
        "replicated": dataclasses.replace(SMOKE, ssm_head_dim=64)}
RUNS = [("sharded", 1), ("sharded", 2), ("sharded", 4), ("replicated", 4)]
COMMS = {"default": CommConfig(), "baseline": BASELINE_CONFIG}
B, S, GEN = 4, 32, 4
REL = 1e-4

JAX_CODE = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.registry import get_smoke_config
from repro.core.config import BASELINE_CONFIG, CommConfig
from repro.launch import input_specs as isp, setup
from repro.train import serve as serve_mod

spec = json.loads(SPEC)
smoke = dataclasses.replace(get_smoke_config("mamba2-130m"),
                            dtype=jnp.float32)
CFGS = {"sharded": smoke,
        "replicated": dataclasses.replace(smoke, ssm_head_dim=64)}
COMMS = {"default": CommConfig(), "baseline": BASELINE_CONFIG}

def mesh_of(tp):
    return Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))

tokens = np.load(spec["inputs"])["tokens"]
B, S = tokens.shape
gen = spec["gen"]
out = {}
for cname, cfg in CFGS.items():
    sess = setup.build_session(cfg, mesh_of(4), CommConfig(), concrete=True)
    params = jax.device_get(sess.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[cname + "/param/" + "/".join(str(p.key) for p in path)] = (
            np.asarray(leaf))
    for cn, tp in spec["runs"]:
        if cn != cname:
            continue
        for name in spec["comms"]:
            mesh, comm = mesh_of(tp), COMMS[name]
            _, pre_fn, _ = serve_mod.build_serve_fn(
                cfg, mesh, comm, isp.ShapeSpec("s", S, B, "prefill"),
                cache_capacity=S + gen)
            _, dec_fn, _ = serve_mod.build_serve_fn(
                cfg, mesh, comm, isp.ShapeSpec("s", S + gen, B, "decode"))
            st = pre_fn(params, {"tokens": jnp.asarray(tokens)})
            key = f"{cname}/{tp}/{name}/"
            out[key + "prefill_logits"] = np.asarray(st.last_logits)
            out[key + "prefill_conv"] = np.asarray(st.caches.conv)
            out[key + "prefill_h"] = np.asarray(st.caches.h)
            toks = []
            for _ in range(gen):
                nxt = np.asarray(jnp.argmax(st.last_logits, -1)
                                 ).astype(np.int32)
                toks.append(nxt)
                st = dec_fn(params, jnp.asarray(nxt), st)
            out[key + "tokens"] = np.stack(toks, 1)
            out[key + "decode_logits"] = np.asarray(st.last_logits)
            out[key + "decode_conv"] = np.asarray(st.caches.conv)
            out[key + "decode_h"] = np.asarray(st.caches.h)
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


def _tokens(n=S, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, SMOKE.vocab_size, (B, n)).astype(np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_ssm_ref")
    np.savez(d / "inputs.npz", tokens=_tokens())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "runs": RUNS, "comms": list(COMMS), "gen": GEN}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=4)
    assert "JAX REF OK" in out
    return dict(np.load(d / "ref.npz"))


def _np_params(ref, cname):
    tree = {}
    prefix = cname + "/param/"
    for key, val in ref.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _full_logits(logits):
    """(P, B, V/tp) vocab-sharded -> the global (B, V)."""
    return torch.cat(logits.unbind(0), dim=-1).numpy()


def _global_state(t, cfg, tp, head_axis):
    """A stacked state leaf ``(L, P, B, ...)`` -> the JAX package's global
    ``(L, B, ...)``: the rank shards concatenated along ``head_axis`` (of
    the global leaf) when heads shard, else rank 0's (every rank's)
    replica."""
    if ssm.ssm_dims(cfg, tp)[1]:
        return torch.cat(t.unbind(1), dim=head_axis).numpy()
    for r in range(1, tp):
        assert torch.equal(t[:, r], t[:, 0])
    return t[:, 0].numpy()


def _states(caches, cfg, tp):
    return (_global_state(caches.conv, cfg, tp, 3),
            _global_state(caches.h, cfg, tp, 2))


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = REL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} over {tol}"


def _builders(cfg, tp, comm, prompt, gen):
    _, pre = serve.build_serve_fn(cfg, tp, comm,
                                  isp.ShapeSpec("s", prompt, B, "prefill"),
                                  cache_capacity=prompt + gen, device="cpu")
    rt, decf = serve.build_serve_fn(cfg, tp, comm,
                                    isp.ShapeSpec("s", prompt + gen, B,
                                                  "decode"), device="cpu")
    return rt, pre, decf


def _serve(params, cfg, tp, comm, tokens, gen=GEN):
    """Prefill + ``gen`` greedy decode steps; returns (copies of the
    prefill state's logits and states, tokens, final state)."""
    rt, pre, decf = _builders(cfg, tp, comm, tokens.shape[1], gen)
    st = pre(params, {"tokens": tokens})
    first = (st.last_logits.clone(), st.caches.conv.clone(),
             st.caches.h.clone())
    toks = []
    for _ in range(gen):
        nxt = dec.greedy_tokens(st, rt)
        toks.append(nxt)
        st = decf(params, nxt, st)
    return first, torch.stack(toks, 1).numpy(), st


@pytest.fixture(scope="module")
def port(ref):
    out = {}
    for cname, tp in RUNS:
        cfg = CFGS[cname]
        params = sharding.from_reference(_np_params(ref, cname), cfg, tp,
                                         "cpu")
        for name, comm in COMMS.items():
            out[cname, tp, name] = _serve(params, cfg, tp, comm, _tokens())
    return out


CASES = [(c, tp, n) for c, tp in RUNS for n in COMMS]


@pytest.mark.parametrize("cname,tp,name", CASES)
def test_prefill_matches_jax(ref, port, cname, tp, name):
    cfg = CFGS[cname]
    (logits, conv, h), _, _ = port[cname, tp, name]
    key = f"{cname}/{tp}/{name}/"
    _close(_full_logits(logits), ref[key + "prefill_logits"],
           "prefill logits")
    got_conv, got_h = _states(ssm.SSMState(conv, h), cfg, tp)
    _close(got_conv, ref[key + "prefill_conv"], "prefill conv state")
    _close(got_h, ref[key + "prefill_h"], "prefill SSD state")


@pytest.mark.parametrize("cname,tp,name", CASES)
def test_greedy_decode_matches_jax(ref, port, cname, tp, name):
    cfg = CFGS[cname]
    _, toks, st = port[cname, tp, name]
    key = f"{cname}/{tp}/{name}/"
    assert np.array_equal(toks, ref[key + "tokens"])
    _close(_full_logits(st.last_logits), ref[key + "decode_logits"],
           "decode logits")
    got_conv, got_h = _states(st.caches, cfg, tp)
    _close(got_conv, ref[key + "decode_conv"], "decode conv state")
    _close(got_h, ref[key + "decode_h"], "decode SSD state")


def test_both_ssm_layouts_are_reached():
    """Heads shard at tp 2 and 4 in the smoke config and at tp 4 at full
    width (24 heads, 6 per rank); 2 heads at tp 4 compute replicated."""
    assert ssm.ssm_dims(CFGS["sharded"], 2) == (4, True)
    assert ssm.ssm_dims(CFGS["sharded"], 4) == (2, True)
    assert ssm.ssm_dims(CFGS["replicated"], 4) == (2, False)
    assert ssm.ssm_dims(get_config("mamba2-130m"), 4) == (6, True)


@pytest.mark.parametrize("tp", (1, 2, 4))
def test_decode_equals_prefill_of_the_extended_sequence(tp):
    """16 prompt tokens and 16 greedy decode steps == prefilling the 32
    tokens at once: the same next token, logits and states."""
    cfg, comm, n = SMOKE, CommConfig(), 16
    params = sharding.shard_params(
        transformer.init_model(0, cfg, tp, "cpu"), cfg, tp)
    tokens = _tokens(n, seed=1)
    _, toks, st = _serve(params, cfg, tp, comm, tokens, gen=n)
    rt, pre, _ = _builders(cfg, tp, comm, 2 * n, 0)
    full = pre(params, {"tokens": np.concatenate([tokens, toks], axis=1)})
    assert torch.equal(dec.greedy_tokens(st, rt), dec.greedy_tokens(full, rt))
    _close(_full_logits(st.last_logits), _full_logits(full.last_logits),
           "logits")
    for a, b, what in zip(st.caches, full.caches, ("conv", "SSD")):
        _close(a.numpy(), b.numpy(), f"{what} state")


@pytest.mark.parametrize("tp", (1, 2))
def test_from_reference_keeps_each_leafs_float_type(tp):
    """Under a bf16 config the JAX package keeps ``A_log``, ``D`` and
    ``dt_bias`` in float32: so does ``from_reference``, with the values
    unrounded; the other leaves come in bf16, bitwise."""
    cfg_j = jax_smoke_config("mamba2-130m")
    cfg_t = get_smoke_config("mamba2-130m")
    assert cfg_t.dtype == torch.bfloat16
    np_params = jax.device_get(jax_transformer.init_model(
        jax.random.PRNGKey(0), cfg_j, tp))
    params = sharding.from_reference(np_params, cfg_t, tp, "cpu")
    back = sharding.unshard_params(params, cfg_t)
    f32 = ("A_log", "D", "dt_bias")
    for name, leaf in back["layers"]["ssm"].items():
        want = np_params["layers"]["ssm"][name]
        assert leaf.dtype == (torch.float32 if name in f32
                              else torch.bfloat16), name
        assert np.array_equal(leaf.float().numpy(),
                              np.asarray(want, np.float32)), name
    assert back["embed"]["table"].dtype == torch.bfloat16


def test_decode_builder_checks_the_state():
    """The decode builder holds the SSM state to its fixed shape, whatever
    the sequence length; the prefill builder ignores the KV capacity."""
    params = sharding.shard_params(
        transformer.init_model(0, SMOKE, 2, "cpu"), SMOKE, 2)
    rt, pre, decf = _builders(SMOKE, 2, CommConfig(), S, GEN)
    st = pre(params, {"tokens": _tokens()})
    want = isp.ssm_state_abstract(SMOKE, B, 2, SMOKE.n_layers)
    assert st.caches.conv.shape == want.conv.shape
    assert st.caches.h.shape == want.h.shape
    assert st.caches.h.dtype == torch.float32
    bad = st._replace(caches=ssm.SSMState(st.caches.conv,
                                          st.caches.h[:, :, :, :1]))
    with pytest.raises(ValueError):
        decf(params, torch.zeros(B, dtype=torch.long), bad)
    _, pre_short = serve.build_serve_fn(
        SMOKE, 2, CommConfig(), isp.ShapeSpec("s", 24, B, "prefill"),
        device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):   # 24 % 16
        pre_short(params, {"tokens": _tokens(24)})


@pytest.mark.parametrize("tp", (2, 4))
def test_forward_logits_end_with_the_prefills(tp):
    """``transformer.forward``'s ssm branch runs the prefill's layers: its
    last position's logits are the prefill's, bitwise."""
    params = sharding.shard_params(
        transformer.init_model(0, SMOKE, tp, "cpu"), SMOKE, tp)
    rt, pre, _ = _builders(SMOKE, tp, CommConfig(), S, GEN)
    tokens = _tokens()
    full = transformer.forward(params, {"tokens": torch.as_tensor(tokens)},
                               rt).logits
    assert full.shape[:3] == (tp, B, S)
    st = pre(params, {"tokens": tokens})
    assert torch.equal(full[:, :, -1], st.last_logits)
