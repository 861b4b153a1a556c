"""The port's host-side substrate against the JAX package, exact equality:
CommConfig validation, chunk plans, edge rounds, torus routing, and the
shallow-water mesh generator and partitioner."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import plans as ref_plans, topology as ref_topology
from repro.core import config as ref_config
from repro.core.communicator import Communicator as RefCommunicator
from repro.swe import mesh_gen as ref_mesh_gen, partition as ref_partition
from repro.swe.dg_solver import initial_state as ref_initial_state

from repro_torch.core import config, plans, topology
from repro_torch.core.communicator import Communicator
from repro_torch.swe import dg_solver, mesh_gen, partition

ENUM_FIELDS = {"mode": "CommMode", "scheduling": "Scheduling",
               "transport": "Transport", "compression": "Compression",
               "reliability": "Reliability"}


def _cfg(module, **kw):
    """A CommConfig of `module` from plain values (enum fields by value)."""
    kw = {k: getattr(module, ENUM_FIELDS[k])(v) if k in ENUM_FIELDS else v
          for k, v in kw.items()}
    return module.CommConfig(**kw)


CONFIG_KWARGS = [
    {},
    {"compression": "int8"},
    {"compression": "int8", "algorithm": "ring"},
    {"compression": "bf16"},
    {"compression": "bf16", "enable_compression_plugin": False},
    {"compression": "none", "enable_compression_plugin": False},
    {"window": 0}, {"window": 1},
    {"chunk_bytes": 511}, {"chunk_bytes": 512},
    {"ack_timeout": 0}, {"max_retransmits": 0},
    {"backoff_base": -1}, {"backoff_base": 3, "backoff_cap": 2},
    {"backoff_base": 2, "backoff_cap": 2},
    {"reliability": "guaranteed", "max_retransmits": 1},
    {"scheduling": "overlapped", "transport": "ordered", "window": 3},
    {"mode": "buffered", "scheduling": "host"},
]


@pytest.mark.parametrize("kw", CONFIG_KWARGS, ids=lambda kw: repr(kw))
def test_commconfig_rejects_what_reference_rejects(kw):
    def outcome(module):
        try:
            return dataclasses.asdict(_cfg(module, **kw))
        except ValueError:
            return "ValueError"
    ref, port = outcome(ref_config), outcome(config)
    if ref == "ValueError":
        assert port == "ValueError"
    else:
        norm = lambda d: {k: getattr(v, "value", v) for k, v in d.items()}
        assert norm(port) == norm(ref)


def test_named_configs_match():
    for name in ("BASELINE_CONFIG", "OPTIMIZED_CONFIG", "OVERLAPPED_CONFIG",
                 "MINIMAL_CONFIG"):
        # the schema stamp included: both packages key one config alike
        ref = ref_plans._cfg_key(getattr(ref_config, name))
        assert plans._cfg_key(getattr(config, name)) == ref, name


CHUNK_CONFIGS = [{}, {"chunk_bytes": 512, "transport": "ordered", "window": 1},
                 {"chunk_bytes": 2048, "transport": "ordered", "window": 2},
                 {"chunk_bytes": 512, "max_chunks": 4}]
SHAPES = [(1,), (130,), (77, 3), (251, 3), (5644, 3), (8, 1024)]


@pytest.mark.parametrize("cfg_kw", CHUNK_CONFIGS, ids=lambda kw: repr(kw))
def test_chunk_plan_matches(cfg_kw):
    ref_cfg, cfg = _cfg(ref_config, **cfg_kw), _cfg(config, **cfg_kw)
    for shape, (np_dt, t_dt), align, eq in itertools.product(
            SHAPES, [(np.float32, torch.float32), (np.int8, torch.int8)],
            (1, 3), (False, True)):
        a = ref_plans.chunk_plan(shape, np_dt, ref_cfg, align=align,
                                 equal_split=eq)
        b = plans.chunk_plan(shape, t_dt, cfg, align=align, equal_split=eq)
        assert (b.n_chunks, b.chunk_elems, b.ack_of) == (
            a.n_chunks, a.chunk_elems, a.ack_of), (shape, align, eq)


@pytest.mark.parametrize("seed", range(4))
def test_edge_rounds_match(seed):
    rng = np.random.RandomState(seed)
    n = 8 + 8 * seed
    edges = sorted({(int(s), int(d)) for s, d in rng.randint(0, n, (3 * n, 2))
                    if s != d})
    assert plans.edge_rounds(edges) == ref_plans.edge_rounds(edges)


def _routed_key(rp):
    if isinstance(rp, tuple):
        return rp
    return (rp.edges, tuple((b.rounds, b.dests) for b in rp.batches),
            rp.max_hops)


def _patterns(spec):
    n = spec.n_ranks
    pats = [spec.hop_perm(d) for d in range(1, spec.diameter + 1)]
    pats.append([(i, (i + 1) % n) for i in range(n)])
    rng = np.random.RandomState(n)
    pats.append([(int(s), int(d)) for s, d in enumerate(rng.permutation(n))
                 if s != d])
    return pats


@pytest.mark.parametrize("text", ["2x4", "4x4", "4x4:snake"])
def test_route_rounds_and_routed_perm_match(text):
    ref_spec = ref_topology.TorusSpec.parse(text)
    spec = topology.TorusSpec.parse(text)
    assert spec.key() == ref_spec.key() and spec.name == ref_spec.name
    n = spec.n_ranks
    ref_comm = RefCommunicator(("x",), (n,), topo=ref_spec)
    comm = Communicator(("x",), (n,), topo=spec)
    for perm in _patterns(spec):
        assert _routed_key(topology.route_rounds(spec, perm)) == _routed_key(
            ref_topology.route_rounds(ref_spec, perm))
        assert _routed_key(topology.routed_perm(comm, perm)) == _routed_key(
            ref_topology.routed_perm(ref_comm, perm))
        assert comm.max_hops(perm) == ref_comm.max_hops(perm)


MESH_CASES = [(500, 1), (500, 2), (500, 4), (500, 8), (1696, 8), (20000, 2)]


@pytest.mark.parametrize("n_elements,n_parts", MESH_CASES)
def test_mesh_and_partition_match(n_elements, n_parts):
    ref_mesh = ref_mesh_gen.generate_bight_mesh(n_elements, seed=0)
    mesh = mesh_gen.generate_bight_mesh(n_elements, seed=0)
    for f in dataclasses.fields(ref_mesh):
        a, b = getattr(ref_mesh, f.name), getattr(mesh, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    ref_pm = ref_partition.partition_mesh(ref_mesh, n_parts,
                                          ref_initial_state(ref_mesh))
    pm = partition.partition_mesh(mesh, n_parts, dg_solver.initial_state(mesh))
    for f in dataclasses.fields(ref_pm):
        a, b = getattr(ref_pm, f.name), getattr(pm, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
