"""The port's stacked-rank point-to-point engine against the JAX package.

The JAX side runs once, in one 16-device subprocess (the 4x4 torus needs 16
ranks), compiling each group of cases into one program and handing the
results back as ``.npz``; the port runs here on CPU tensors.  Tolerances: the NONE and BF16 wire formats
only move (and round) values, so they must be bitwise equal; the INT8 format
may differ by one quantisation step (the two sides round ``x/scale`` after
divisions that can differ in the last bit)."""
import itertools
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro_torch.core import config, collectives
from repro_torch.core.communicator import Communicator
from repro_torch.core.topology import TorusSpec

N = 8
PAYLOAD = (N, 700)            # 2800 B per rank: 6 chunks at 512, 2 at 2048
MODES = ("streaming", "buffered")
TRANSPORTS = ("ordered", "unordered")
CHUNKS = (512, 2048)
COMPRESSIONS = ("none", "bf16", "int8")
ROUNDS = [[(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4)],
          [(1, 0), (2, 1), (3, 2), (0, 3), (5, 4), (6, 5), (7, 6), (4, 7)],
          [(0, 4), (4, 0), (1, 5), (5, 1), (2, 6), (6, 2)],
          [(3, 7), (7, 3)]]
S_MAX = 77                    # per-round rows: 924 B per rank and round
MN_CONFIGS = {
    "fused": {},
    "fused_buffered": {"mode": "buffered"},
    "fused_ordered_512": {"transport": "ordered", "chunk_bytes": 512,
                          "window": 1},
    "overlapped": {"scheduling": "overlapped"},
    "overlapped_ordered_512": {"scheduling": "overlapped",
                               "transport": "ordered", "chunk_bytes": 512,
                               "window": 1},
    "overlapped_buffered": {"scheduling": "overlapped", "mode": "buffered"},
}
TORI = ("2x4", "4x4")
ROUTE_CONFIGS = {"streaming_ordered_512": {"transport": "ordered",
                                          "chunk_bytes": 512, "window": 2},
                 "buffered": {"mode": "buffered"}}

SENDRECV_CASES = list(itertools.product(MODES, TRANSPORTS, CHUNKS,
                                        COMPRESSIONS))


def _sendrecv_kw(mode, tr, chunk, comp):
    kw = {"mode": mode, "transport": tr, "chunk_bytes": chunk, "window": 2,
          "compression": comp}
    if comp == "int8":
        kw["algorithm"] = "ring"
    return kw


def _route_patterns(text):
    spec = TorusSpec.parse(text)
    n = spec.n_ranks
    pats = {f"hop{d}": spec.hop_perm(d) for d in range(1, spec.diameter + 1)}
    rng = np.random.RandomState(n)
    pats["irregular"] = [(int(s), int(d))
                         for s, d in enumerate(rng.permutation(n)) if s != d]
    return pats


def _inputs():
    rng = np.random.RandomState(1)
    return {"x": rng.randn(*PAYLOAD).astype(np.float32),
            "mn": rng.randn(N, len(ROUNDS), S_MAX, 3).astype(np.float32),
            "x16": rng.randn(16, 300).astype(np.float32)}


JAX_CODE = """
import json
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core import config, collectives
from repro.core.communicator import Communicator
from repro.core.topology import TorusSpec

spec = json.loads(SPEC)
inp = dict(np.load(spec["inputs"]))
ENUMS = {"mode": "CommMode", "scheduling": "Scheduling",
         "transport": "Transport", "compression": "Compression"}
def cfg(kw):
    return config.CommConfig(**{k: getattr(config, ENUMS[k])(v)
                                if k in ENUMS else v for k, v in kw.items()})

def run(n, fns, x, per=1):
    # every case of a group in ONE compiled program; each fn maps the
    # per-rank x to a tuple of `per` arrays
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    def body(xs):
        return tuple(r[None] for fn in fns for r in fn(xs[0]))
    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=P("x"),
                                 out_specs=(P("x"),) * (per * len(fns)),
                                 check_vma=False))
    return [np.asarray(o) for o in f(x)]

out = {}
comm8 = Communicator(("x",), (8,))
ring = comm8.ring_perm()
keys = list(spec["sendrecv"])
res = run(8, [lambda x, c=cfg(spec["sendrecv"][k]):
              (collectives.sendrecv(x, ring, comm8, c),) for k in keys],
          inp["x"])
out.update({"sr/" + k: r for k, r in zip(keys, res)})

rounds = spec["rounds"]
def mn(kw):
    c = cfg(kw)
    def fn(pay):
        payloads = [pay[r] for r in range(len(rounds))]
        if kw.get("scheduling") == "overlapped":
            carry, rec = collectives.multi_neighbor_exchange(
                payloads, rounds, comm8, c,
                consume=lambda a, r, m: jnp.concatenate([a, m.reshape(-1)]),
                init=jnp.zeros((0,), jnp.float32),
                chunk_consume=lambda a, r, i, ch: jnp.concatenate([a, ch]),
                chunk_align=3)
        else:
            rec = collectives.multi_neighbor_exchange(payloads, rounds,
                                                      comm8, c)
            carry = jnp.zeros((1,), jnp.float32)
        return jnp.stack(rec), carry
    return fn
keys = list(spec["mn"])
res = run(8, [mn(spec["mn"][k]) for k in keys], inp["mn"], per=2)
for i, k in enumerate(keys):
    out["mn/" + k], out["mnc/" + k] = res[2 * i], res[2 * i + 1]

for text, pats in spec["routes"].items():
    tspec = TorusSpec.parse(text)
    n = tspec.n_ranks
    comm = Communicator(("x",), (n,), topo=tspec)
    cases = [(pn, ck) for pn in pats for ck in spec["route_cfgs"]]
    res = run(n, [lambda x, perm=pats[pn], c=cfg(spec["route_cfgs"][ck]):
                  (collectives.sendrecv(x, perm, comm, c),)
                  for pn, ck in cases], inp["x16"][:n])
    out.update({f"rt/{text}/{pn}/{ck}": r for (pn, ck), r in zip(cases, res)})
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("exchange_ref")
    np.savez(d / "inputs.npz", **_inputs())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "sendrecv": {"/".join(map(str, c)): _sendrecv_kw(*c)
                         for c in SENDRECV_CASES},
            "rounds": ROUNDS, "mn": MN_CONFIGS,
            "routes": {t: _route_patterns(t) for t in TORI},
            "route_cfgs": ROUTE_CONFIGS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=16)
    assert "JAX REF OK" in out
    return dict(np.load(d / "ref.npz")), _inputs()


def _cfg(**kw):
    enums = {"mode": config.CommMode, "scheduling": config.Scheduling,
             "transport": config.Transport,
             "compression": config.Compression}
    return config.CommConfig(**{k: enums[k](v) if k in enums else v
                                for k, v in kw.items()})


@pytest.mark.parametrize("mode,tr,chunk,comp", SENDRECV_CASES)
def test_sendrecv_matches_reference(ref, mode, tr, chunk, comp):
    want_all, inp = ref
    want = want_all[f"sr/{mode}/{tr}/{chunk}/{comp}"]
    comm = Communicator(("x",), (N,))
    x = torch.from_numpy(inp["x"])
    got = collectives.sendrecv(x, comm.ring_perm(), comm,
                               _cfg(**_sendrecv_kw(mode, tr, chunk,
                                                   comp))).numpy()
    if comp == "int8":
        # one quantisation step of the coarsest block of the source rank
        step = np.abs(inp["x"]).max(axis=1, keepdims=True) / 127.0
        step = np.roll(step, 1, axis=0)
        assert (np.abs(got - want) <= step * 1.0001).all()
        assert np.abs(got - np.roll(inp["x"], 1, axis=0)).max() <= step.max()
    else:
        assert np.array_equal(got, want)
        if comp == "none":
            assert np.array_equal(got, np.roll(inp["x"], 1, axis=0))


@pytest.mark.parametrize("key", list(MN_CONFIGS))
def test_multi_neighbor_exchange_matches_reference(ref, key):
    want_all, inp = ref
    cfg = _cfg(**MN_CONFIGS[key])
    comm = Communicator(("x",), (N,))
    pay = torch.from_numpy(inp["mn"])
    payloads = [pay[:, r] for r in range(len(ROUNDS))]
    if cfg.scheduling == config.Scheduling.OVERLAPPED:
        carry, rec = collectives.multi_neighbor_exchange(
            payloads, ROUNDS, comm, cfg,
            consume=lambda a, r, m: torch.cat([a, m.reshape(N, -1)], 1),
            init=torch.zeros((N, 0)),
            chunk_consume=lambda a, r, i, ch: torch.cat([a, ch], 1),
            chunk_align=3)
        assert np.array_equal(carry.numpy(), want_all[f"mnc/{key}"])
    else:
        rec = collectives.multi_neighbor_exchange(payloads, ROUNDS, comm, cfg)
    got = torch.stack(rec, 1).numpy()
    assert np.array_equal(got, want_all[f"mn/{key}"])
    # oracle: round r delivers rank s's payload to rank d, zeros elsewhere
    for r, perm in enumerate(ROUNDS):
        want = np.zeros_like(inp["mn"][:, r])
        for s, d in perm:
            want[d] = inp["mn"][s, r]
        assert np.array_equal(got[:, r], want)


@pytest.mark.parametrize("text,ckey", list(itertools.product(
    TORI, ROUTE_CONFIGS)))
def test_multi_hop_routing_matches_reference(ref, text, ckey):
    want_all, inp = ref
    spec = TorusSpec.parse(text)
    n = spec.n_ranks
    comm = Communicator(("x",), (n,), topo=spec)
    flat = Communicator(("x",), (n,))
    x = torch.from_numpy(inp["x16"][:n])
    cfg = _cfg(**ROUTE_CONFIGS[ckey])
    for pname, perm in _route_patterns(text).items():
        got = collectives.sendrecv(x, perm, comm, cfg)
        assert np.array_equal(got.numpy(),
                              want_all[f"rt/{text}/{pname}/{ckey}"]), pname
        # routing is value-preserving: equal to the direct permute
        assert torch.equal(got, collectives.sendrecv(x, perm, flat, cfg))
