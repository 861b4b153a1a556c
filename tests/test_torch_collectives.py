"""The port's collectives against the JAX package on 8 stacked ranks.

The JAX side runs once, in one 8-device subprocess (meshes built as
``Mesh(np.array(jax.devices()), ("x",))``), compiling each group of cases
into one program; the port runs here on CPU tensors.

Tolerances:

- ring NONE and BF16: bitwise equal — the same reducer runs in the same
  order on the same values (bf16 inputs accumulate in f32 on both sides);
- native sums (``psum``, ``psum_scatter``): ``|got - want| <= 1e-6 *
  sum_r |x_r|`` per element, because the summation order differs; native
  max/min, gathers, broadcasts and all-to-alls move values only: bitwise;
  a native sum on the bf16 wire: ``n * 2**-8 * sum_r |x_r|`` (each side
  rounds its own partial sums to bf16);
- INT8 (ring only): every value a hop carries is bounded by ``S = sum_r
  max|x_r|`` (sums) or ``max_r max|x_r|`` (max/min, gathers,
  broadcasts); ``hops`` = 2(n-1) for all-reduce and broadcast, n-1 for
  reduce-scatter and all-gather.  Against JAX: ``hops * 2**-21 * S``.
  The same f32 reducer runs in the same order on both sides, and the
  plain quantizer is bitwise equal to eager ``quantize_int8``
  (tests/test_torch_quant.py), but XLA compiles the ring's ``amax /
  127.0`` as ``amax * f32(1/127)``, so a JAX scale can be 1 ulp off the
  port's IEEE quotient: each re-encoding hop may then differ by a few f32
  roundings of the carried value.  A code that flipped at a rounding tie
  would differ by one step of its block (``amax / 127``) and fail this
  bound; none does on these inputs.  Against the exact result: one
  quantisation step per hop, ``hops * S / 127``.
"""
import json

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro_torch.core import collectives, config
from repro_torch.core.communicator import Communicator
from repro_torch.core.topology import TorusSpec

N = 8
COMPS = ("none", "bf16", "int8")
RING_OPS = {"none": ("sum", "max", "min", "prod"),
            "bf16": ("sum", "max", "min", "prod"),
            "int8": ("sum", "max", "min")}
DTYPES = ("f32", "bf16")
A2A_CFGS = {
    "fused": {},
    "fused_bf16": {"compression": "bf16"},
    "chunked_unordered": {"scheduling": "overlapped", "chunk_bytes": 512},
    "chunked_ordered": {"scheduling": "overlapped", "chunk_bytes": 512,
                        "transport": "ordered", "window": 2},
    "chunked_bf16": {"scheduling": "overlapped", "chunk_bytes": 512,
                     "compression": "bf16"},
}


def _ring_kw(comp):
    return {"algorithm": "ring", "compression": comp}


def _cases():
    """name -> (kind, config kwargs, extra).  Kinds: ar (all_reduce), ag
    (all_gather), rs (reduce_scatter), bc (broadcast), a2a (all_to_all)."""
    c = {}
    for comp in COMPS:
        kw = _ring_kw(comp)
        for dt in DTYPES:
            for op in RING_OPS[comp]:
                c[f"ring/ar/{comp}/{op}/{dt}"] = ("ar", kw, {"op": op,
                                                             "dt": dt})
                c[f"ring/rs/{comp}/{op}/{dt}"] = ("rs", kw, {"op": op,
                                                             "dt": dt})
            for tiled in (True, False):
                c[f"ring/ag/{comp}/{tiled}/{dt}"] = ("ag", kw, {
                    "tiled": tiled, "dt": dt})
            c[f"ring/bc/{comp}/{dt}"] = ("bc", kw, {"dt": dt})
    nat = {"algorithm": "native"}
    for op in ("sum", "max", "min"):
        c[f"native/ar/none/{op}/f32"] = ("ar", nat, {"op": op, "dt": "f32"})
    c["native/ar/bf16/sum/f32"] = ("ar", dict(nat, compression="bf16"),
                                   {"op": "sum", "dt": "f32"})
    for tiled in (True, False):
        for axis in (0, 1):
            c[f"native/ag/{tiled}/{axis}"] = ("ag", nat, {
                "tiled": tiled, "axis": axis, "dt": "f32", "2d": True})
    c["native/rs/none/sum/f32"] = ("rs", nat, {"op": "sum", "dt": "f32"})
    c["native/bc/none/f32"] = ("bc", nat, {"dt": "f32"})
    for name, kw in A2A_CFGS.items():
        for split, concat in ((0, 0), (1, 0)):
            c[f"a2a/{name}/{split}{concat}"] = ("a2a", kw, {
                "split": split, "concat": concat})
    return c


CASES = _cases()
TORUS_CASES = {f"torus/ar/{comp}/sum/f32": ("ar", _ring_kw(comp),
                                            {"op": "sum", "dt": "f32"})
               for comp in COMPS}


def _inputs():
    rng = np.random.RandomState(3)
    x = (rng.randn(N, 100) * np.linspace(0.5, 4, N)[:, None]).astype(
        np.float32)
    # exact in bf16, so both sides start from the same bf16 values
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    xs = torch.from_numpy(rng.randn(N, 24, 5).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    return {"x": x, "x2": x.reshape(N, 10, 10), "xs": xs,
            "a2a": rng.randn(N, 16, 40).astype(np.float32)}


JAX_CODE = """
import json
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
DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}

def fn_for(kind, kw, ex, comm):
    c = cfg(kw)
    def f(v):
        v = v.astype(DT[ex.get("dt", "f32")])
        if kind == "ar":
            y = collectives.all_reduce(v, comm, c, op=ex["op"])
        elif kind == "rs":
            y = collectives.reduce_scatter(v, comm, c, op=ex["op"])
        elif kind == "ag":
            y = collectives.all_gather(v, comm, c, axis=ex.get("axis", 0),
                                       tiled=ex["tiled"])
        elif kind == "bc":
            y = collectives.broadcast(v, 3, comm, c)
        else:
            y = collectives.all_to_all(v, comm, c, split_axis=ex["split"],
                                       concat_axis=ex["concat"])
        return y.astype(jnp.float32)
    return f

def run(comm, names, cases, key):
    mesh = Mesh(np.array(jax.devices()[:comm.size]), ("x",))
    fns = [fn_for(*cases[n], comm) for n in names]
    def body(xs):
        return tuple(f(xs[0])[None] for f in fns)
    prog = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=P("x"),
                                    out_specs=(P("x"),) * len(fns),
                                    check_vma=False))
    return dict(zip(names, (np.asarray(o) for o in prog(inp[key]))))

def input_key(kind, ex):
    if kind == "rs":
        return "xs"
    if kind == "a2a":
        return "a2a"
    return "x2" if ex.get("2d") else "x"

out = {}
comm = Communicator(("x",), (8,))
cases = spec["cases"]
groups = {}
for n, (kind, kw, ex) in cases.items():
    groups.setdefault(input_key(kind, ex), []).append(n)
for key, names in groups.items():
    out.update(run(comm, names, cases, key))
torus = Communicator(("x",), (8,), topo=TorusSpec.parse("2x4"))
out.update(run(torus, list(spec["torus"]), spec["torus"], "x"))
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives_ref")
    np.savez(d / "inputs.npz", **_inputs())
    spec = {"inputs": str(d / "inputs.npz"), "out": str(d / "ref.npz"),
            "cases": CASES, "torus": TORUS_CASES}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=N)
    assert "JAX REF OK" in out
    return dict(np.load(d / "ref.npz")), _inputs()


def _cfg(kw):
    enums = {"mode": config.CommMode, "scheduling": config.Scheduling,
             "transport": config.Transport,
             "compression": config.Compression}
    return config.CommConfig(**{k: enums[k](v) if k in enums else v
                                for k, v in kw.items()})


def _run_port(kind, kw, ex, comm, inp):
    key = ("xs" if kind == "rs" else "a2a" if kind == "a2a"
           else "x2" if ex.get("2d") else "x")
    x = torch.from_numpy(inp[key])
    if ex.get("dt") == "bf16":
        x = x.to(torch.bfloat16)
    c = _cfg(kw)
    if kind == "ar":
        y = collectives.all_reduce(x, comm, c, op=ex["op"])
    elif kind == "rs":
        y = collectives.reduce_scatter(x, comm, c, op=ex["op"])
    elif kind == "ag":
        y = collectives.all_gather(x, comm, c, axis=ex.get("axis", 0),
                                   tiled=ex["tiled"])
    elif kind == "bc":
        y = collectives.broadcast(x, 3, comm, c)
    else:
        y = collectives.all_to_all(x, comm, c, split_axis=ex["split"],
                                   concat_axis=ex["concat"])
    assert y.dtype == x.dtype
    return y.float().numpy(), inp[key]


def _exact(kind, ex, x):
    """The collective's exact result per rank, in float64."""
    x = x.astype(np.float64)
    if kind == "bc":
        return np.broadcast_to(x[3], x.shape)
    red = {"sum": np.sum, "max": np.max, "min": np.min,
           "prod": np.prod}[ex.get("op", "sum")]
    if kind == "ar":
        return np.broadcast_to(red(x, axis=0), x.shape)
    if kind == "rs":
        return red(x, axis=0).reshape((N, -1) + x.shape[2:])
    if kind == "ag":
        full = x.reshape(-1) if ex["tiled"] else x
        return np.broadcast_to(full, (N,) + full.shape)
    raise AssertionError(kind)


def _check(name, kind, kw, ex, got, want, x):
    comp = kw.get("compression", "none")
    if kw.get("algorithm") == "ring" and comp == "int8":
        hops = {"ar": 2 * (N - 1), "bc": 2 * (N - 1), "rs": N - 1,
                "ag": N - 1}[kind]
        per_rank_max = np.abs(x.reshape(N, -1)).max(axis=1)
        carried = (per_rank_max.sum() if ex.get("op", "sum") == "sum"
                   and kind in ("ar", "rs") else per_rank_max.max())
        assert np.abs(got - want).max() <= hops * 2.0 ** -21 * carried, \
            name
        bound = hops * carried / 127.0
        exact = _exact(kind, ex, x)
        assert np.abs(got - exact).max() <= bound, name
    elif kw.get("algorithm") == "native" and kind in ("ar", "rs") \
            and ex["op"] == "sum":
        scale = np.abs(x).sum(axis=0)
        scale = (np.broadcast_to(scale, x.shape) if kind == "ar"
                 else scale.reshape(got.shape))
        tol = N * 2.0 ** -8 if comp == "bf16" else 1e-6
        assert (np.abs(got - want) <= tol * scale).all(), name
    else:
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("name", list(CASES))
def test_collective_matches_reference(ref, name):
    want_all, inp = ref
    kind, kw, ex = CASES[name]
    got, x = _run_port(kind, kw, ex, Communicator(("x",), (N,)), inp)
    _check(name, kind, kw, ex, got, want_all[name], x)
    if kind != "a2a" and not ex.get("2d") and ex.get("op") != "prod" \
            and kw.get("compression", "none") == "none" \
            and ex.get("dt") == "f32":
        np.testing.assert_allclose(got, _exact(kind, ex, x), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(TORUS_CASES))
def test_ring_on_a_torus_matches_reference(ref, name):
    """The rank ring's wrap edges are multi-hop on a 2x4 torus and get
    routed; values equal the JAX package's and the flat run's."""
    want_all, inp = ref
    kind, kw, ex = TORUS_CASES[name]
    torus = Communicator(("x",), (N,), topo=TorusSpec.parse("2x4"))
    got, x = _run_port(kind, kw, ex, torus, inp)
    _check(name, kind, kw, ex, got, want_all[name], x)
    flat, _ = _run_port(kind, kw, ex, Communicator(("x",), (N,)), inp)
    assert np.array_equal(got, flat)


def test_all_to_all_is_a_block_transpose():
    """Rank j's block s of the (split 0, concat 0) all-to-all is rank s's
    block j — pure data movement, fused or chunked."""
    x = torch.from_numpy(_inputs()["a2a"])
    comm = Communicator(("x",), (N,))
    rows = x.shape[1] // N
    for kw in A2A_CFGS.values():
        if kw.get("compression"):
            continue
        y = collectives.all_to_all(x, comm, _cfg(kw))
        for j in range(N):
            for s in range(N):
                assert torch.equal(y[j, s * rows:(s + 1) * rows],
                                   x[s, j * rows:(j + 1) * rows])


def test_native_prod_and_int8_native_are_rejected():
    comm = Communicator(("x",), (N,))
    x = torch.ones(N, 4)
    with pytest.raises(ValueError):
        collectives.all_reduce(x, comm, config.CommConfig(), op="prod")
    with pytest.raises(ValueError):
        config.CommConfig(compression=config.Compression.INT8)
    with pytest.raises(ValueError):
        collectives.all_reduce(x, comm, config.CommConfig(
            algorithm="ring", enable_arithmetic_plugin=False))
