"""The port's LM serving path (qwen3 smoke config, float32) against the JAX
package's ``train/serve.py::build_serve_fn``, on the CPU.

The JAX side runs once, in one 4-device subprocess (meshes built as
``Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("data", "model"))``):
it initialises the parameters, then for tp in {1, 2, 4} and three
CommConfigs (the default streaming one, ``BASELINE_CONFIG`` and the
default with ring collectives) prefills a seeded (4, 24) prompt into caches
of 28 positions and decodes 4 greedy tokens.  The port takes the same
parameters through ``sharding.from_reference``.

Tolerances:

- logits: ``1e-4 * max|logit|`` (both sides compute in float32; the
  summation orders of the matmuls, the psum / ``sum(0)`` combines, the
  softmax and the LSE combine differ);
- KV caches: ``1e-4 * max|cache|`` elementwise, and the positions past the
  written ones exactly zero on both sides (a token written by the wrong
  owner shows as a misplaced row);
- greedy tokens: equal.

Within the port, every config gives bitwise-equal prefills (the row-parallel
combine is the same native sum in each; embedding rows and K/V gathers move
values only), and the overlapped matmul + all-reduce is bitwise equal to
the whole matmul + all-reduce on the CPU."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import collectives, streaming
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import (BASELINE_CONFIG, OPTIMIZED_CONFIG,
                                     CommConfig, Transport)
from repro_torch.launch import input_specs as isp
from repro_torch.models import attention, decode as dec, layers, sharding
from repro_torch.models import transformer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import serve

CFG = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=torch.float32)
B, S, GEN = 4, 24, 4
TPS = (1, 2, 4)
COMMS = {"default": CommConfig(), "baseline": BASELINE_CONFIG,
         "ring": CommConfig(algorithm="ring")}
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
cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=jnp.float32)
COMMS = {"default": CommConfig(), "baseline": BASELINE_CONFIG,
         "ring": CommConfig(algorithm="ring")}

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
gen = spec["gen"]
for tp in spec["tps"]:
    for name in spec["comms"]:
        mesh, comm = mesh_of(tp), COMMS[name]
        _, pre_fn, _ = serve_mod.build_serve_fn(
            cfg, mesh, comm, isp.ShapeSpec("s", S, B, "prefill"),
            cache_capacity=S + gen)
        _, dec_fn, _ = serve_mod.build_serve_fn(
            cfg, mesh, comm, isp.ShapeSpec("s", S + gen, B, "decode"))
        st = pre_fn(params, {"tokens": jnp.asarray(tokens)})
        key = f"{tp}/{name}/"
        out[key + "prefill_logits"] = np.asarray(st.last_logits)
        out[key + "prefill_k"] = np.asarray(st.caches.k)
        out[key + "prefill_v"] = np.asarray(st.caches.v)
        toks = []
        for _ in range(gen):
            nxt = np.asarray(jnp.argmax(st.last_logits, -1)).astype(np.int32)
            toks.append(nxt)
            st = dec_fn(params, jnp.asarray(nxt), st)
        out[key + "tokens"] = np.stack(toks, 1)
        out[key + "decode_logits"] = np.asarray(st.last_logits)
        out[key + "decode_k"] = np.asarray(st.caches.k)
        out[key + "decode_v"] = np.asarray(st.caches.v)
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


def _tokens():
    rng = np.random.RandomState(0)
    return rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_ref")
    np.savez(d / "inputs.npz", tokens=_tokens())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "tps": list(TPS), "comms": list(COMMS), "gen": GEN}
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


def _full_logits(st):
    """(P, B, V/tp) vocab-sharded -> the global (B, V)."""
    return torch.cat(st.last_logits.unbind(0), dim=-1).numpy()


def _global_cache(c):
    """(L, P, B, S_shard, KV, hd) -> the global (L, B, P·S_shard, KV, hd)
    (the sequence shards of the JAX package's out_specs, concatenated)."""
    L, P, Bc, Ls = c.shape[:4]
    return c.permute(0, 2, 1, 3, 4, 5).reshape(L, Bc, P * Ls,
                                                *c.shape[4:]).numpy()


def _close(got, want, what):
    tol = REL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} over {tol}"


def _serve(params, tp, comm, tokens, gen=GEN):
    """Prefill + ``gen`` greedy decode steps through the builders; returns
    (prefill state's copies, tokens, final state)."""
    _, pre = serve.build_serve_fn(CFG, tp, comm,
                                  isp.ShapeSpec("s", S, B, "prefill"),
                                  cache_capacity=S + GEN, device="cpu")
    rt, decf = serve.build_serve_fn(CFG, tp, comm,
                                    isp.ShapeSpec("s", S + GEN, B, "decode"),
                                    device="cpu")
    st = pre(params, {"tokens": tokens})
    first = (st.last_logits.clone(), st.caches.k.clone(),
             st.caches.v.clone())
    toks = []
    for _ in range(gen):
        nxt = dec.greedy_tokens(st, rt)
        toks.append(nxt)
        st = decf(params, nxt, st)
    return first, torch.stack(toks, 1).numpy(), st


@pytest.fixture(scope="module")
def port(ref):
    np_params = _np_params(ref)
    out = {}
    for tp in TPS:
        params = sharding.from_reference(np_params, CFG, tp, "cpu")
        for name, comm in COMMS.items():
            out[tp, name] = _serve(params, tp, comm, _tokens())
    return out


@pytest.mark.parametrize("tp", TPS)
def test_from_reference_round_trip(ref, tp):
    """JAX parameters in, the port's stacked shards out, and back: equal;
    each shard is the JAX package's slice for its rank."""
    np_params = _np_params(ref)
    params = sharding.from_reference(np_params, CFG, tp, "cpu")
    back = sharding.unshard_params(params, CFG)
    flat = {}

    def walk(a, b, path=()):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k], path + (k,))
        else:
            flat["/".join(path)] = (a, b)
    walk(np_params, back)
    for name, (want, got) in flat.items():
        assert np.array_equal(got.numpy(), want), name
    wq = params["layers"]["attn"]["wq"]          # (L, tp, D, H*hd/tp)
    w = np_params["layers"]["attn"]["wq"]
    cols = w.shape[-1] // tp
    for r in range(tp):
        assert np.array_equal(wq[:, r].numpy(), w[..., r * cols:(r + 1) * cols])
    table = params["embed"]["table"]
    assert tuple(table.shape) == (tp, CFG.vocab_size // tp, CFG.d_model)


@pytest.mark.parametrize("name", list(COMMS))
@pytest.mark.parametrize("tp", TPS)
def test_prefill_matches_jax(ref, port, tp, name):
    (logits, k, v), _, _ = port[tp, name]
    key = f"{tp}/{name}/"
    _close(torch.cat(logits.unbind(0), -1).numpy(),
           ref[key + "prefill_logits"], "prefill logits")
    for got, what in ((k, "k"), (v, "v")):
        want = ref[key + f"prefill_{what}"]
        g = _global_cache(got)
        assert g.shape == want.shape
        _close(g, want, f"prefill cache {what}")
        # positions S.. are unwritten: zero on both sides
        assert not g[:, :, S:].any() and not want[:, :, S:].any()


@pytest.mark.parametrize("name", list(COMMS))
@pytest.mark.parametrize("tp", TPS)
def test_greedy_decode_matches_jax(ref, port, tp, name):
    _, toks, st = port[tp, name]
    key = f"{tp}/{name}/"
    assert np.array_equal(toks, ref[key + "tokens"])
    _close(_full_logits(st), ref[key + "decode_logits"], "decode logits")
    for got, what in ((st.caches.k, "k"), (st.caches.v, "v")):
        want = ref[key + f"decode_{what}"]
        g = _global_cache(got)
        _close(g, want, f"decode cache {what}")
        assert not g[:, :, S + GEN:].any()
        # every decoded position was written by its owner
        assert (np.abs(g[:, :, S:S + GEN]).max(axis=(0, 3, 4)) > 0).all()


@pytest.mark.parametrize("tp", TPS)
def test_decode_equals_prefill_of_the_extended_sequence(tp):
    """Greedy-decoding 4 tokens == prefilling the extended sequence: the
    same next token, logits and caches (tests/test_serving.py's check)."""
    comm = CommConfig()
    params = sharding.shard_params(
        transformer.init_model(0, CFG, tp, "cpu"), CFG, tp)
    tokens = _tokens()
    _, toks, st = _serve(params, tp, comm, tokens)
    seq = np.concatenate([tokens, toks], axis=1)
    rt, pre = serve.build_serve_fn(CFG, tp, comm,
                                   isp.ShapeSpec("s", S + GEN, B, "prefill"),
                                   device="cpu")
    full = pre(params, {"tokens": seq})
    assert torch.equal(dec.greedy_tokens(st, rt), dec.greedy_tokens(full, rt))
    _close(_full_logits(st), _full_logits(full), "logits")
    _close(st.caches.k.numpy(), full.caches.k.numpy(), "cache k")
    _close(st.caches.v.numpy(), full.caches.v.numpy(), "cache v")


@pytest.mark.parametrize("tp", (2, 4))
def test_comm_configs_are_bitwise_equal_within_the_port(port, tp):
    """Prefills are bitwise equal under every config; decode too between
    the native configs, and under the ring config it picks the same tokens
    (its LSE sum runs in ring order)."""
    base = port[tp, "default"]
    for name in ("baseline", "ring"):
        other = port[tp, name]
        for a, b in zip(base[0], other[0]):
            assert torch.equal(a, b), name
        assert np.array_equal(base[1], other[1]), name
    assert torch.equal(base[2].last_logits, port[tp, "baseline"][2].last_logits)
    assert torch.equal(base[2].caches.k, port[tp, "baseline"][2].caches.k)


@pytest.mark.parametrize("cfg", [
    CommConfig(chunk_bytes=512),
    CommConfig(chunk_bytes=512, transport=Transport.ORDERED, window=2),
    CommConfig(chunk_bytes=1024, algorithm="ring"),
])
def test_overlapped_matmul_allreduce_is_bitwise_the_whole_product(cfg):
    rng = np.random.RandomState(5)
    h = torch.from_numpy(rng.randn(4, 96, 32).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 32, 64).astype(np.float32))
    comm = Communicator(("model",), (4,))
    want = collectives.all_reduce(streaming.matmul_f32(h, w), comm,
                                  CommConfig())
    got = streaming.overlapped_matmul_allreduce(h, w, comm, cfg)
    assert torch.equal(got, want)
    for n in (1, 3, 8):
        assert torch.equal(streaming.overlapped_matmul_allreduce(
            h, w, comm, cfg, n_chunks=n), want)


def _counts():
    reg = obs_metrics.registry()
    return {op: reg.counter("comm.collectives", kind="all_reduce",
                            op=op).value for op in ("max", "sum", "min")}


@pytest.mark.parametrize("tp", (2, 4))
def test_lse_combine_is_two_all_reduces_per_layer(tp):
    """One decode step under the buffered baseline: per layer, the LSE
    combine's max and sum plus the two row-parallel combines; one more sum
    for the vocab-sharded embedding."""
    params = sharding.shard_params(
        transformer.init_model(0, CFG, tp, "cpu"), CFG, tp)
    _, pre = serve.build_serve_fn(CFG, tp, BASELINE_CONFIG,
                                  isp.ShapeSpec("s", S, B, "prefill"),
                                  cache_capacity=S + 1, device="cpu")
    rt, decf = serve.build_serve_fn(CFG, tp, BASELINE_CONFIG,
                                    isp.ShapeSpec("s", S + 1, B, "decode"),
                                    device="cpu")
    st = pre(params, {"tokens": _tokens()})
    before = _counts()
    decf(params, torch.zeros(B, dtype=torch.long), st)
    after = _counts()
    L = CFG.n_layers
    assert after["max"] - before["max"] == L
    assert after["sum"] - before["sum"] == 1 + L + 2 * L
    assert after["min"] == before["min"]


@pytest.mark.parametrize("cfg", [CommConfig(), CommConfig(algorithm="ring")])
def test_greedy_sampling_over_sharded_vocab(cfg):
    """The all-reduce max of the local maxima, then the all-reduce min of
    the int32 candidates (through the ring's reducers too): the global
    argmax, the lowest index among equal maxima."""
    tp, V = 4, 64
    rt = serve.serve_runtime(dataclasses.replace(CFG, vocab_size=V), tp,
                             cfg, isp.ShapeSpec("s", 8, 3, "decode"))
    rng = np.random.RandomState(2)
    full = rng.randn(3, V).astype(np.float32)
    full[1, [5, 40]] = 9.0     # a tie across shards: index 5 wins
    full[2, [33, 34]] = 9.0    # a tie within a shard: index 33 wins
    logits = torch.from_numpy(full).reshape(3, tp, V // tp).transpose(0, 1)
    got = layers.greedy_sample_vocab_sharded(logits.contiguous(), rt)
    assert got.dtype == torch.int32
    want = torch.from_numpy(full.argmax(-1)).to(torch.int32)
    for r in range(tp):
        assert torch.equal(got[r], want)
    assert want[1] == 5 and want[2] == 33


def test_both_gqa_layouts_are_reached():
    """kv heads sharded (smoke tp=2, full width tp=4: 8 q over 2 kv heads
    per rank) and replicated with a per-rank kv slice (smoke tp=4)."""
    assert attention.attn_dims(CFG, 2).kv_sharded
    d4 = attention.attn_dims(CFG, 4)
    assert d4.q_sharded and not d4.kv_sharded
    full = attention.attn_dims(get_config("qwen3-8b"), 4)
    assert full.kv_sharded and full.local_heads == 8 and full.local_kv == 2


def test_builders_check_their_arguments(tmp_path):
    prompt = isp.ShapeSpec("s", S, B, "prefill")
    gen = isp.ShapeSpec("s", S + GEN, B, "decode")
    with pytest.raises(ValueError):
        serve.build_serve_fn(CFG, 2, CommConfig(), prompt,
                             cache_capacity=S - 1, device="cpu")
    with pytest.raises(ValueError):
        serve.build_serve_fn(CFG, 2, CommConfig(), gen, cache_capacity=S,
                             device="cpu")
    # "auto" on a cold TuneDB falls back to the paper's optimized config
    rt, _ = serve.build_serve_fn(CFG, 2, "auto", prompt, device="cpu",
                                 tune_db_path=tmp_path / "cold.json")
    assert rt.comm == OPTIMIZED_CONFIG
    params = sharding.shard_params(
        transformer.init_model(0, CFG, 2, "cpu"), CFG, 2)
    _, pre = serve.build_serve_fn(CFG, 2, CommConfig(), prompt,
                                  device="cpu")
    with pytest.raises(ValueError):
        pre(params, {"tokens": _tokens()[:, :S - 1]})
    st = pre(params, {"tokens": _tokens()})
    _, decf = serve.build_serve_fn(CFG, 2, CommConfig(), gen, device="cpu")
    with pytest.raises(ValueError):     # caches hold S, not S + GEN
        decf(params, torch.zeros(B, dtype=torch.long), st)
    assert serve.cache_len(CFG, gen) == S + GEN
    assert serve.serve_msg_bytes(CFG, prompt) == 4 * CFG.d_model * B * S
