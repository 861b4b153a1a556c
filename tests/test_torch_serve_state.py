"""The serving state's cache position as a device tensor (what lets a
decode step be captured as one CUDA graph), on the CPU.

- The masked cache write (every row computes owner and offset from the
  0-d ``length`` tensor and writes only where it owns the position) is
  bitwise equal to the host-indexed write it replaced, for tp 1, 2 and 4
  (``sp_size == 1`` and sequence-sharded), at the first position, around a
  shard boundary, at the last position before the cache is full and at the
  first positions past it.
- Decoding past a full cache (qwen3 smoke config, float32) matches the JAX
  package's ``build_serve_fn``: prompt 24 into caches of 26 positions
  (28 at tp 4: 4 shards of 7), then 6 greedy steps.  One 4-device JAX
  subprocess.  Tolerances as in ``tests/test_torch_serve.py``: logits and
  caches ``1e-4 * max|.|``, greedy tokens equal.
- ``prefill(out=)``, the hand-off of a captured prefill's wave to a slot
  state, is bitwise the prefill into a fresh state."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro_torch.configs import get_smoke_config
from repro_torch.core.config import CommConfig
from repro_torch.launch import input_specs as isp
from repro_torch.models import attention, decode as dec, sharding
from repro_torch.models import transformer
from repro_torch.train import serve

CFG = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=torch.float32)
B, S, CAP, STEPS = 4, 24, 26, 6
TPS = (1, 2, 4)
REL = 1e-4

JAX_CODE = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.registry import get_smoke_config
from repro.core.config import CommConfig
from repro.launch import input_specs as isp, setup
from repro.train import serve as serve_mod

spec = json.loads(SPEC)
cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=jnp.float32)

def mesh_of(tp):
    return Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))

sess = setup.build_session(cfg, mesh_of(4), CommConfig(), concrete=True)
params = jax.device_get(sess.params)
out = {}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["param/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
tokens = np.load(spec["inputs"])["tokens"]
B, S = tokens.shape
cap, steps = spec["cap"], spec["steps"]
for tp in spec["tps"]:
    mesh = mesh_of(tp)
    _, pre_fn, _ = serve_mod.build_serve_fn(
        cfg, mesh, CommConfig(), isp.ShapeSpec("s", S, B, "prefill"),
        cache_capacity=cap)
    _, dec_fn, _ = serve_mod.build_serve_fn(
        cfg, mesh, CommConfig(), isp.ShapeSpec("s", cap, B, "decode"))
    st = pre_fn(params, {"tokens": jnp.asarray(tokens)})
    toks, logits = [], []
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(st.last_logits, -1)).astype(np.int32)
        toks.append(nxt)
        st = dec_fn(params, jnp.asarray(nxt), st)
        logits.append(np.asarray(st.last_logits))
    out[f"{tp}/tokens"] = np.stack(toks, 1)
    out[f"{tp}/logits"] = np.stack(logits, 0)
    out[f"{tp}/k"] = np.asarray(st.caches.k)
    out[f"{tp}/v"] = np.asarray(st.caches.v)
    out[f"{tp}/length"] = np.asarray(st.length)
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


def _tokens():
    rng = np.random.RandomState(3)
    return rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_state_ref")
    np.savez(d / "inputs.npz", tokens=_tokens())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "tps": list(TPS), "cap": CAP, "steps": STEPS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=4)
    assert "JAX REF OK" in out
    return dict(np.load(d / "ref.npz"))


def _np_params(ref):
    tree = {}
    for key, val in ref.items():
        if not key.startswith("param/"):
            continue
        node = tree
        *path, leaf = key.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _close(got, want, what):
    tol = REL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} over {tol}"


def _global_cache(c):
    L, P, Bc, Ls = c.shape[:4]
    return c.permute(0, 2, 1, 3, 4, 5).reshape(L, Bc, P * Ls,
                                                *c.shape[4:]).numpy()


@pytest.mark.parametrize("tp", TPS)
def test_decode_past_a_full_cache_matches_jax(ref, tp):
    params = sharding.from_reference(_np_params(ref), CFG, tp, "cpu")
    _, pre = serve.build_serve_fn(CFG, tp, CommConfig(),
                                  isp.ShapeSpec("s", S, B, "prefill"),
                                  cache_capacity=CAP, device="cpu")
    rt, step = serve.build_serve_fn(CFG, tp, CommConfig(),
                                    isp.ShapeSpec("s", CAP, B, "decode"),
                                    device="cpu")
    st = pre(params, {"tokens": _tokens()})
    toks, logits = [], []
    for _ in range(STEPS):
        nxt = dec.greedy_tokens(st, rt)
        toks.append(nxt)
        st = step(params, nxt, st)
        logits.append(torch.cat(st.last_logits.unbind(0), -1).numpy())
    full = st.caches.k.shape[3] * tp
    assert int(st.length) == S + STEPS > full    # decoded past a full cache
    assert int(st.length) == int(ref[f"{tp}/length"])
    assert np.array_equal(torch.stack(toks, 1).numpy(), ref[f"{tp}/tokens"])
    for i in range(STEPS):
        _close(logits[i], ref[f"{tp}/logits"][i], f"step {i} logits")
    for got, what in ((st.caches.k, "k"), (st.caches.v, "v")):
        _close(_global_cache(got), ref[f"{tp}/{what}"], f"cache {what}")


def _host_indexed_append(cache, k_new, v_new, sp_size, tp):
    """The write the masked one replaced: owner and offset on the host."""
    L = cache.seq_shard
    owner, off = divmod(int(cache.length), L)
    if sp_size == 1:
        rows = slice(None) if owner == 0 else None
    else:
        rows = owner if owner < tp else None
    if rows is not None:
        cache.k[rows, :, off] = k_new[rows, :, 0].to(cache.k.dtype)
        cache.v[rows, :, off] = v_new[rows, :, 0].to(cache.v.dtype)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("where", ("first", "shard_end", "shard_start",
                                   "last", "full", "past_full"))
def test_masked_append_is_the_host_indexed_write(tp, where):
    rt = serve.serve_runtime(CFG, tp, CommConfig(),
                             isp.ShapeSpec("s", CAP, B, "decode"))
    L = -(-CAP // rt.sp_size)
    cap = L * rt.sp_size
    pos = {"first": 0, "shard_end": L - 1, "shard_start": min(L, cap - 1),
           "last": cap - 1, "full": cap, "past_full": cap + 3}[where]
    gen = torch.Generator().manual_seed(tp * 100 + pos)
    shape = (tp, B, L, CFG.n_kv_heads, CFG.resolved_head_dim)
    k, v = (torch.randn(shape, generator=gen) for _ in range(2))
    k_new, v_new = (torch.randn((tp, B, 1) + shape[3:], generator=gen)
                    for _ in range(2))
    length = torch.tensor(pos, dtype=torch.long)
    want = attention.KVCache(k=k.clone(), v=v.clone(), length=length)
    _host_indexed_append(want, k_new, v_new, rt.sp_size, tp)
    got = attention.append_to_cache(
        attention.KVCache(k=k.clone(), v=v.clone(), length=length),
        k_new, v_new, rt)
    assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)
    assert got.length.dim() == 0 and int(got.length) == pos + 1
    wrote = not torch.equal(got.k, k)
    assert wrote == (pos < cap)       # nothing is written once full


def _params(tp):
    return sharding.shard_params(transformer.init_model(1, CFG, tp, "cpu"),
                                 CFG, tp)


@pytest.mark.parametrize("tp", (1, 4))
def test_prefill_out_hands_the_wave_to_a_state(tp):
    """``prefill(out=state)``, the hand-off of a captured prefill's wave to
    a slot state, is bitwise the prefill into a fresh state, and decoding
    either advances it alike; the cache position is one 0-d long tensor
    shared by the state and its caches."""
    params = _params(tp)
    rt, pre = serve.build_serve_fn(CFG, tp, CommConfig(),
                                   isp.ShapeSpec("s", S, B, "prefill"),
                                   cache_capacity=CAP, device="cpu")
    st = pre(params, {"tokens": _tokens()})
    slot = pre.new_state(params)
    assert int(slot.length) == 0 and slot.caches.length is slot.length
    got = pre(params, {"tokens": _tokens()}, out=slot)
    assert got is slot
    for a, b in ((st.caches.k, slot.caches.k), (st.caches.v, slot.caches.v),
                 (st.last_logits, slot.last_logits), (st.length, slot.length)):
        assert torch.equal(a, b)
    assert st.length.dtype == torch.long and st.length.dim() == 0
    assert st.caches.length is st.length
    tok = dec.greedy_tokens(st, rt)
    assert dec.decode_step(params, tok, st, rt) is st
    assert dec.decode_step(params, tok, slot, rt) is slot
    assert int(slot.length) == S + 1
    assert torch.equal(st.last_logits, slot.last_logits)
    assert torch.equal(st.caches.k, slot.caches.k)


def test_prefill_out_checks_its_shapes():
    params = _params(2)
    _, pre = serve.build_serve_fn(CFG, 2, CommConfig(),
                                  isp.ShapeSpec("s", S, B, "prefill"),
                                  cache_capacity=CAP, device="cpu")
    _, other = serve.build_serve_fn(CFG, 2, CommConfig(),
                                    isp.ShapeSpec("s", S, B, "prefill"),
                                    cache_capacity=CAP + 8, device="cpu")
    with pytest.raises(ValueError):
        pre(params, {"tokens": _tokens()}, out=other.new_state(params))
    meta = pre.new_state(params, "meta")
    assert meta.caches.k.device.type == "meta"
