"""The port's latency model and autotuner against the JAX package.

Everything here is pure Python and numpy on both sides, so JAX runs in this
process, except the SWE driver's ``comm_cfg="auto"``, which needs an
8-device mesh: one subprocess.  Configurations and TuneDBs cross between
the packages as JSON (``config_to_dict``/``config_from_dict`` and the TuneDB
file), never as objects.

Tolerances: none — every number is computed by the same arithmetic in the
same order on both sides, so outputs, fitted constants and candidate lists
are equal, and the same deterministic timer gives equal sweeps.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from helpers import run_multidevice

from repro.core import latmodel as jax_latmodel
from repro.core.config import V5E
from repro.core.topology import TorusSpec as JaxTorusSpec
from repro import tune as jax_tune
from repro.tune import sweep as jax_sweep

from repro_torch.core import latmodel
from repro_torch.core.config import (H100, OPTIMIZED_CONFIG, CommConfig,
                                     HardwareSpec)
from repro_torch.core.topology import TorusSpec
from repro_torch import tune
from repro_torch.tune import sweep
from repro_torch.swe import driver

# The JAX package's TPU v5e field values, as test data for the port's spec.
HW = HardwareSpec(**{f.name: getattr(V5E, f.name)
                     for f in dataclasses.fields(HardwareSpec)})


def _to_jax(cfg):
    return jax_tune.config_from_dict(json.loads(json.dumps(
        tune.config_to_dict(cfg))))


def _model_configs():
    out = []
    for d in ({}, {"mode": "buffered"}, {"scheduling": "host"},
              {"scheduling": "overlapped"}, {"chunk_bytes": 1 << 16},
              {"compression": "int8", "algorithm": "ring"},
              {"compression": "bf16"},
              {"reliability": "guaranteed", "window": 8},
              {"mode": "buffered", "reliability": "guaranteed"}):
        out.append(tune.config_from_dict(d))
    return out


# ----------------------------------------------------------------------
# latmodel
# ----------------------------------------------------------------------

def test_hardware_specs():
    # The port keeps the JAX spec's fields that the latency model reads, in
    # the same order; the cross-card and memory-size fields wait for the
    # slices that read them.
    names = [f.name for f in dataclasses.fields(HardwareSpec)]
    assert names == [n for n in dataclasses.asdict(V5E)
                     if n not in ("dcn_bw", "dcn_latency", "vmem_bytes",
                                  "hbm_bytes")]
    assert H100.hbm_bw == 3.35e12 and H100.peak_flops == 989e12
    spec, jspec = TorusSpec.parse("2x4"), JaxTorusSpec.parse("2x4")
    jhw = dataclasses.asdict(jspec.hardware(V5E))
    assert dataclasses.asdict(spec.hardware(HW)) == {n: jhw[n] for n in names}
    assert spec.hardware().name == "torus-2x4"


@pytest.mark.parametrize("cfg", _model_configs(),
                         ids=lambda c: "-".join(
                             f"{k}={v}" for k, v in tune.config_to_dict(
                                 c).items()
                             if v != tune.config_to_dict(CommConfig())[k])
                         or "default")
def test_latmodel_matches_reference(cfg):
    jcfg = _to_jax(cfg)
    for size in (64, 1104, 1 << 16, 3 << 20):
        assert latmodel.wire_bytes(size, cfg) == \
            jax_latmodel.wire_bytes(size, jcfg)
        assert latmodel.n_commands(size, cfg) == \
            jax_latmodel.n_commands(size, jcfg)
        assert latmodel.l_m(size, HW) == jax_latmodel.l_m(size, V5E)
        for hops in (1, 3):
            assert latmodel.l_c(size, cfg, HW, hops) == \
                jax_latmodel.l_c(size, jcfg, V5E, hops)
            for loss in (0.0, 0.05):
                assert latmodel.pingping_latency(size, cfg, HW, hops, loss) \
                    == jax_latmodel.pingping_latency(size, jcfg, V5E, hops,
                                                     loss)
                assert latmodel.effective_bandwidth(size, cfg, HW, hops,
                                                    loss) == \
                    jax_latmodel.effective_bandwidth(size, jcfg, V5E, hops,
                                                     loss)
                assert latmodel.e2e_consumer_latency(
                    size, cfg, 3e-6, HW, hops, loss) == \
                    jax_latmodel.e2e_consumer_latency(size, jcfg, 3e-6, V5E,
                                                      hops, loss)
    assert latmodel.l_k(cfg, HW) == jax_latmodel.l_k(jcfg, V5E)
    assert latmodel.overlap_fraction(cfg) == jax_latmodel.overlap_fraction(
        jcfg)
    assert latmodel.expected_retransmit_factor(cfg, 0.1) == \
        jax_latmodel.expected_retransmit_factor(jcfg, 0.1)
    w = dict(e_total=270886, e_core=5000, e_send=400, e_recv=400, d_ext=0,
             l_pipe=100, n_max=6, flop_per_element=260.0, freq=256e6,
             msg_bytes=1104)
    pw, jw = latmodel.SWEWorkload(**w), jax_latmodel.SWEWorkload(**w)
    for f in ("eq3_l_comm", "eq2_throughput", "eq2_throughput_overlap",
              "stall_fraction", "stall_fraction_overlap"):
        assert getattr(latmodel, f)(pw, cfg, HW, 2) == \
            getattr(jax_latmodel, f)(jw, jcfg, V5E, 2), f


def test_roofline_and_peak_bandwidth_match_reference():
    assert latmodel.buffered_peak_bw(HW) == jax_latmodel.buffered_peak_bw(
        V5E)
    a = latmodel.roofline_terms(1e12, 1e9, 1e8, 4, HW)
    b = jax_latmodel.roofline_terms(1e12, 1e9, 1e8, 4, V5E)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.dominant, a.bound_s, a.roofline_fraction) == (
        b.dominant, b.bound_s, b.roofline_fraction)


# ----------------------------------------------------------------------
# space
# ----------------------------------------------------------------------

@pytest.mark.parametrize("collective", (None,) + sweep.SWEEPABLE)
@pytest.mark.parametrize("fast", (True, False))
def test_enumerate_configs_matches_reference(collective, fast):
    objectives = ["latency"]
    if collective in sweep.CONSUMERS or collective in ("sendrecv", None):
        objectives.append("e2e")
    for objective in objectives:
        got = [tune.config_to_dict(c) for c in tune.enumerate_configs(
            collective, fast=fast, objective=objective)]
        want = [jax_tune.config_to_dict(c) for c in jax_tune.enumerate_configs(
            collective, fast=fast, objective=objective)]
        assert got == want
    assert tune.space_size() == jax_tune.space_size()


def test_candidate_counts():
    counts = {c: len(tune.enumerate_configs(c)) for c in sweep.SWEEPABLE}
    assert counts == {"sendrecv": 32, "all_reduce": 160, "all_gather": 160,
                      "reduce_scatter": 160, "multi_neighbor": 44,
                      "all_to_all": 20}


# ----------------------------------------------------------------------
# TuneDB and select_config
# ----------------------------------------------------------------------

def _entries(module, topo, torus=""):
    """An engineered set of entries in ``module``'s TuneEntry type."""
    jumbo = {"chunk_bytes": 1 << 20}
    small = {"chunk_bytes": 1 << 16, "transport": "ordered", "window": 8}
    int8 = {"algorithm": "ring", "compression": "int8"}
    rows = [("multi_neighbor", 1024, jumbo, 10.0, 1, 0.0),
            ("multi_neighbor", 1024, small, 12.0, 1, 0.0),
            ("multi_neighbor", 1024, jumbo, 40.0, 2, 0.0),
            ("multi_neighbor", 1024, small, 20.0, 2, 0.0),
            ("multi_neighbor", 1 << 16, small, 30.0, 3, 25.0),
            ("all_reduce", 1 << 20, int8, 50.0, 2, 0.0),
            ("all_reduce", 1 << 20, jumbo, 49.0, 2, 0.0),
            ("all_reduce", 1 << 14, jumbo, 9.0, 2, 0.0)]
    return [module.TuneEntry(topo=topo, collective=c, msg_bytes=m,
                             config=module.config_to_dict(
                                 module.config_from_dict(cfg)),
                             us_per_call=us, hops=h, torus=torus,
                             p95_us=p95, gbps=m / us / 1e3)
            for c, m, cfg, us, h, p95 in rows]


QUERIES = [("multi_neighbor", 1024, 1), ("multi_neighbor", 1024, 2),
           ("multi_neighbor", 2000, 3), ("multi_neighbor", 1 << 16, None),
           ("all_reduce", 1 << 20, 2), ("all_reduce", 1 << 19, None),
           ("all_reduce", 1 << 12, None), ("sendrecv", 1024, None)]


def test_tunedb_files_cross_between_packages(tmp_path):
    jdb = jax_tune.TuneDB(_entries(jax_tune, "cpu:8", "2x4"))
    pdb = tune.TuneDB(_entries(tune, "torch-cpu:8", "2x4"))
    jpath = jdb.save(tmp_path / "jax.json")
    ppath = pdb.save(tmp_path / "port.json")
    from_jax, from_port = tune.TuneDB.load(jpath), jax_tune.TuneDB.load(ppath)
    assert [dataclasses.asdict(e) for e in from_jax.entries] == \
        [dataclasses.asdict(e) for e in jdb.entries]
    assert [dataclasses.asdict(e) for e in from_port.entries] == \
        [dataclasses.asdict(e) for e in pdb.entries]
    # one shared file: each package answers from its own entries only
    shared = tune.TuneDB(from_jax.entries + pdb.entries)
    shared.save(tmp_path / "shared.json")
    for coll, size, hops in QUERIES:
        for objective in ("latency", "e2e"):
            kw = dict(hops=hops, objective=objective, torus="2x4")
            got = tune.select_config(coll, size, path=tmp_path / "shared.json",
                                     topo="torch-cpu:8", **kw)
            want = jax_tune.select_config(coll, size,
                                          path=tmp_path / "shared.json",
                                          topo="cpu:8", **kw)
            assert tune.config_to_dict(got) == jax_tune.config_to_dict(want)
            assert got == tune.select_config(coll, size, db=pdb,
                                             topo="torch-cpu:8", **kw)


def test_select_config_never_answers_from_the_other_package(tmp_path):
    jdb = jax_tune.TuneDB(_entries(jax_tune, "cpu:8"))
    jdb.save(tmp_path / "jax.json")
    for coll, size, hops in QUERIES:
        assert tune.select_config(coll, size, path=tmp_path / "jax.json",
                                  topo="torch-cpu:8", hops=hops) \
            == OPTIMIZED_CONFIG
        assert tune.select_config(coll, size, path=tmp_path / "jax.json",
                                  topo="torch-cuda:8", hops=hops) \
            == OPTIMIZED_CONFIG
    assert tune.topology_key(8, "cpu") == "torch-cpu:8"
    assert tune.topology_key(48, "cuda") == "torch-cuda:48"
    assert jax_tune.topology_key(n_devices=8) == "cpu:8"


def test_communicator_auto_config_keys_on_size_and_device(tmp_path):
    from repro_torch.core.communicator import Communicator
    db = tune.TuneDB(_entries(tune, "torch-cpu:8"))
    db.save(tmp_path / "db.json")
    comm = Communicator(("x",), (8,))
    assert comm.auto_config("all_reduce", 1 << 20, tmp_path / "db.json",
                            device="cpu") == tune.config_from_dict(
                                {"chunk_bytes": 1 << 20})
    assert Communicator(("x",), (4,)).auto_config(
        "all_reduce", 1 << 20, tmp_path / "db.json", device="cpu") == \
        tune.config_from_dict({"chunk_bytes": 1 << 20})   # relaxed count
    assert comm.auto_config("all_reduce", 1 << 20, tmp_path / "db.json",
                            device="cuda") == OPTIMIZED_CONFIG


# ----------------------------------------------------------------------
# calibrate and prune
# ----------------------------------------------------------------------

def _measurements(module_cfg, hop_list):
    hw = dataclasses.replace(HW, host_dispatch=21e-6, fused_dispatch=1.3e-6,
                             ici_latency=2.5e-6, ici_hop_latency=0.7e-6,
                             ici_bw=80e9, hbm_bw=1e12)
    meas = []
    rng = np.random.RandomState(0)
    for cfg in _model_configs():
        for size in (1024, 1 << 14, 1 << 17, 1 << 20):
            for hops in hop_list:
                t = latmodel.pingping_latency(size, cfg, hw, hops)
                t *= 1.0 + 0.05 * rng.randn()
                meas.append((module_cfg(cfg), size, t, hops))
    return meas


@pytest.mark.parametrize("hop_list", [(1,), (1, 2, 3)])
def test_fit_latency_model_matches_reference(hop_list):
    from repro.tune.calibrate import fit_latency_model as jax_fit
    got = tune.fit_latency_model(_measurements(lambda c: c, hop_list))
    want = jax_fit(_measurements(_to_jax, hop_list))
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    if len(hop_list) == 1:
        # a one-distance fit keeps each package's card default
        assert g.pop("hop_latency") == H100.ici_hop_latency
        assert w.pop("hop_latency") == V5E.ici_hop_latency
    assert g == w
    assert got.summary() == want.summary() or len(hop_list) == 1


@pytest.mark.parametrize("objective", ("latency", "e2e"))
@pytest.mark.parametrize("collective", ("sendrecv", "all_reduce",
                                        "multi_neighbor", "all_to_all"))
def test_prune_candidates_matches_reference(collective, objective):
    from repro.tune.calibrate import fit_latency_model as jax_fit
    from repro.tune.prune import prune_candidates as jax_prune
    cal = tune.fit_latency_model(_measurements(lambda c: c, (1, 2)))
    jcal = jax_fit(_measurements(_to_jax, (1, 2)))
    cands = tune.enumerate_configs(collective)
    jcands = [_to_jax(c) for c in cands]
    for size in (1024, 1 << 20):
        for hops in (1, 3):
            kw = dict(ratio=1.5, collective=collective, objective=objective,
                      compute_s=2e-6, hops=hops)
            kept, skipped = tune.prune_candidates(cands, size, cal, **kw)
            jkept, jskipped = jax_prune(jcands, size, jcal, **kw)
            assert [tune.config_to_dict(c) for c in kept] == \
                [jax_tune.config_to_dict(c) for c in jkept]
            assert len(skipped) == len(jskipped)
            assert kept and len(kept) + len(skipped) == len(cands)


# ----------------------------------------------------------------------
# run_sweep with a deterministic timer
# ----------------------------------------------------------------------

class _FakeDev:
    platform = "cpu"


class _FakeDevs:
    def __init__(self, n):
        self.shape = (n,)
        self.size = n
        self.flat = [_FakeDev()] * n


class _FakeMesh:
    """Just enough mesh surface for the JAX package's run_sweep with an
    injected timer (no program is built)."""

    def __init__(self, n):
        self.axis_names = ("x",)
        self.devices = _FakeDevs(n)
        self.shape = {"x": n}


def _model_seconds(latm, hw, msg_bytes, cfg, hops, per_dev_shape):
    if per_dev_shape is not None:    # a consumer loop: 12 flop per element
        return latm.e2e_consumer_latency(msg_bytes, cfg,
                                         3.0 * msg_bytes / 1e12, hw, hops)
    return latm.pingping_latency(msg_bytes, cfg, hw, hops)


def _timers(hop_sweep: bool):
    """The same model timer for both packages' run_sweep: the JAX package
    hands its timer the hop distance in ``cache_key[3]`` (0 = the pattern's
    own), the port as ``hops``."""
    def port(op, n, msg_bytes, cfg, per_dev_shape=None, hops=1, **_):
        return _model_seconds(latmodel, HW, msg_bytes, cfg,
                              hops if hop_sweep else 1, per_dev_shape)

    def jax(op, mesh, msg_bytes, cfg, per_dev_shape=None, cache_key=None,
            **_):
        return _model_seconds(jax_latmodel, V5E, msg_bytes, cfg,
                              cache_key[3] or 1, per_dev_shape)

    return port, jax


SWEEP_CASES = {
    "fast-all": dict(collectives=sweep.SWEEPABLE, sizes=(1024, 1 << 20),
                     fast=True),
    "full-ring-1MiB": dict(collectives=("all_reduce", "reduce_scatter",
                                        "all_gather"), sizes=(1 << 20,)),
    "pruned": dict(collectives=("sendrecv", "all_reduce", "all_to_all"),
                   sizes=(1 << 14, 1 << 20), prune=True, prune_ratio=1.5),
    "e2e": dict(collectives=("multi_neighbor",), sizes=(1104, 1 << 17),
                objective="e2e"),
    "torus-hops": dict(collectives=("sendrecv", "multi_neighbor"),
                       sizes=(1 << 20,), fast=True, hop_distances=(1, 2, 3)),
}


def _entry_view(e):
    d = dataclasses.asdict(e)
    d.pop("topo")
    d.pop("loss")
    return d


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_run_sweep_matches_reference(case, monkeypatch):
    # A one-distance Eq. 1 fit (the pruned sweep's seed) prices the hops at
    # the card's default hop latency: give the port the JAX package's, as
    # HW gives it the rest of V5E's values.
    from repro_torch.tune import calibrate
    monkeypatch.setattr(calibrate.CalibrationResult, "hop_latency",
                        V5E.ici_hop_latency)
    kw = dict(SWEEP_CASES[case])
    hop_sweep = "hop_distances" in kw
    port_timer, jax_timer = _timers(hop_sweep)
    topo_kw = {}
    if hop_sweep:
        topo_kw = dict(topology=TorusSpec.parse("2x4"))
        jtopo = dict(topology=JaxTorusSpec.parse("2x4"))
    else:
        jtopo = {}
    stats, jstats = {}, {}
    db = tune.run_sweep(8, timer=port_timer, device="cpu", stats=stats,
                        **topo_kw, **kw)
    jdb = jax_sweep.run_sweep(_FakeMesh(8), timer=jax_timer, stats=jstats,
                              **jtopo, **kw)
    assert [_entry_view(e) for e in db.entries] == \
        [_entry_view(e) for e in jdb.entries]
    assert {e.topo for e in db.entries} == {"torch-cpu:8"}
    for k in ("total", "measured", "pruned", "e2e_measured"):
        assert stats[k] == jstats[k], k
    assert stats["measured"] > 0
    for coll in kw["collectives"]:
        for size in kw["sizes"]:
            for hops in ({e.hops for e in db.entries
                          if e.collective == coll} or {None}):
                for objective in ("latency", "e2e"):
                    got = tune.select_config(coll, size, db=db,
                                             topo="torch-cpu:8", hops=hops,
                                             objective=objective)
                    want = jax_tune.select_config(coll, size, db=jdb,
                                                  topo="cpu:8", hops=hops,
                                                  objective=objective)
                    assert tune.config_to_dict(got) == \
                        jax_tune.config_to_dict(want)


def test_sweep_times_ops_on_the_cpu_and_records_tails(tmp_path):
    """The real timer on the plain path: every candidate runs, its
    per-rep samples give a p95, and the fit runs on the result."""
    stats = {}
    db = tune.run_sweep(8, collectives=("sendrecv", "all_reduce",
                                        "multi_neighbor"),
                        sizes=(1024,), fast=True, device="cpu", stats=stats,
                        objective="e2e", reps=2, inner=2)
    assert stats["measured"] == len(tune.enumerate_configs(
        "sendrecv", fast=True)) + len(tune.enumerate_configs(
            "all_reduce", fast=True)) + len(tune.enumerate_configs(
                "multi_neighbor", fast=True, objective="e2e"))
    assert all(e.us_per_call > 0 and e.p95_us > 0 for e in db.entries)
    assert all(e.e2e_us > 0 for e in db.entries
               if e.collective == "multi_neighbor")
    assert "sweep wall clock" in sweep.sweep_summary(stats)


def test_sweep_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "db.json"
    assert sweep.main(["--device", "cpu", "--fast", "--collectives",
                       "sendrecv,all_reduce", "--sizes", "1024,65536",
                       "--out", str(out), "--calibrate"]) == 0
    text = capsys.readouterr().out
    assert "calibrated:" in text and "wrote" in text
    db = tune.TuneDB.load(out)
    assert {e.topo for e in db.entries} == {"torch-cpu:8"}
    assert {e.collective for e in db.entries} == {"sendrecv", "all_reduce"}


def test_sweep_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.run_sweep(8, collectives=("sendrecv",), sizes=(1024,),
                       fast=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["--fast", "--collectives", "sendrecv"])
    with pytest.raises(ValueError):
        tune.run_sweep(8, collectives=("sendrecv",), sizes=(1024,),
                       hop_distances=(1,), device="cpu")


# ----------------------------------------------------------------------
# The SWE driver's comm_cfg="auto"
# ----------------------------------------------------------------------

AUTO_ELEMENTS = 1696

JAX_AUTO = """
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.topology import TorusSpec
from repro.swe import driver
from repro.swe.partition import partition_mesh
from repro.tune import config_to_dict

spec = json.loads(SPEC)
mesh = Mesh(np.array(jax.devices()), ("data",))
out = {}
for name, torus in spec["cases"].items():
    sim = driver.build_simulation(spec["elements"], mesh, "auto",
                                  tune_db_path=spec["db"],
                                  topology=TorusSpec.parse(torus)
                                  if torus else None)
    out[name] = {"cfg": config_to_dict(sim.comm_cfg),
                 "rounds": None if sim.round_cfgs is None
                 else [config_to_dict(c) for c in sim.round_cfgs],
                 "halo_bytes": int(sim.pm.s_max) * 12,
                 "hops": [max(1, max((TorusSpec.parse(torus).hops(s, d)
                                      for s, d in r), default=0))
                          for r in sim.pm.rounds] if torus else None}
print("AUTO " + json.dumps(out))
"""

AUTO_CASES = {"flat": "", "torus": "2x4"}


def test_build_simulation_auto_matches_reference(tmp_path):
    """An engineered TuneDB whose winner depends on the hop distance: the
    port's driver picks the JAX driver's representative config and the same
    per-round configs, from its own (torch-cpu) entries."""
    jumbo = {"chunk_bytes": 1 << 20}
    small = {"chunk_bytes": 1 << 16}
    ordered = {"transport": "ordered", "window": 8, "chunk_bytes": 1 << 16}
    rows = [(1, jumbo, 10.0), (1, small, 12.0), (2, jumbo, 40.0),
            (2, small, 20.0), (3, ordered, 15.0), (3, small, 18.0),
            (4, jumbo, 30.0), (4, ordered, 31.0)]
    entries = []
    for module, topo in ((jax_tune, "cpu:8"), (tune, "torch-cpu:8")):
        for torus in ("", "2x4"):
            for msg in (1024, 1 << 14):
                for hops, cfg, us in rows:
                    bonus = 0.5 if torus else 0.0
                    entries.append(dataclasses.asdict(module.TuneEntry(
                        topo=topo, collective="multi_neighbor",
                        msg_bytes=msg, config=module.config_to_dict(
                            module.config_from_dict(cfg)),
                        us_per_call=us + bonus, hops=hops, torus=torus)))
    db_path = tmp_path / "tunedb.json"
    db_path.write_text(json.dumps({"version": 1, "entries": entries}))
    spec = {"elements": AUTO_ELEMENTS, "db": str(db_path),
            "cases": AUTO_CASES}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_AUTO, n_devices=8)
    want = json.loads(out.split("AUTO ", 1)[1])
    distinct = False
    for name, torus in AUTO_CASES.items():
        sim = driver.build_simulation(
            AUTO_ELEMENTS, 8, "auto", device="cpu", tune_db_path=db_path,
            topology=TorusSpec.parse(torus) if torus else None)
        assert tune.config_to_dict(sim.comm_cfg) == want[name]["cfg"], name
        got_rounds = (None if sim.round_cfgs is None
                      else [tune.config_to_dict(c) for c in sim.round_cfgs])
        assert got_rounds == want[name]["rounds"], name
        distinct |= got_rounds is not None and len(
            {json.dumps(r, sort_keys=True) for r in got_rounds}) > 1
    assert distinct, "the torus case must select distinct per-round configs"


def test_build_workload_matches_reference_formula():
    sim = driver.build_simulation(AUTO_ELEMENTS, 8, CommConfig(),
                                  device="cpu")
    w = driver.build_workload(sim)
    pm = sim.pm
    crit = int(np.argmax(pm.n_send + pm.n_neighbors * 1000))
    assert (w.e_total, w.e_core, w.e_send, w.n_max, w.msg_bytes) == (
        sim.mesh.n_elements, int(pm.n_core[crit]), int(pm.n_send[crit]),
        pm.n_max, int(pm.s_max) * 12)
    assert math.isfinite(latmodel.eq2_throughput(w, CommConfig()))


# ----------------------------------------------------------------------
# The lossy wire: loss-aware selection, pruning and sweeps
# ----------------------------------------------------------------------

def _loss_db(module, topo):
    """Jumbo frames measured on a clean wire, small GUARANTEED segments on
    a lossy one (the JAX package's test_select_config_prefers_matching_loss
    entries, plus a second lossy rate)."""
    rows = [({"chunk_bytes": 1 << 20}, 50.0, 0.0),
            ({"chunk_bytes": 4096, "reliability": "guaranteed"}, 80.0,
             0.05),
            ({"chunk_bytes": 1 << 16, "reliability": "guaranteed"}, 70.0,
             0.2)]
    return module.TuneDB([module.TuneEntry(
        topo=topo, collective="all_reduce", msg_bytes=1 << 20,
        config=module.config_to_dict(module.config_from_dict(cfg)),
        us_per_call=us, loss=loss) for cfg, us, loss in rows])


def test_select_config_prefers_matching_loss():
    db = _loss_db(tune, "torch-cpu:8")
    jdb = _loss_db(jax_tune, "cpu:8")
    clean = tune.select_config("all_reduce", 1 << 20, db=db,
                               topo="torch-cpu:8")
    assert clean.chunk_bytes == 1 << 20
    lossy = tune.select_config("all_reduce", 1 << 20, db=db,
                               topo="torch-cpu:8", loss=0.05)
    assert lossy.chunk_bytes == 4096
    assert lossy.reliability.value == "guaranteed"
    for loss in (None, 0.0, 0.05, 0.08, 0.15, 0.5):
        got = tune.select_config("all_reduce", 1 << 20, db=db,
                                 topo="torch-cpu:8", loss=loss)
        want = jax_tune.select_config("all_reduce", 1 << 20, db=jdb,
                                      topo="cpu:8", loss=loss)
        assert tune.config_to_dict(got) == jax_tune.config_to_dict(want)
        assert [dataclasses.asdict(e)["us_per_call"] for e in
                db.candidates("all_reduce", "torch-cpu:8", loss=loss)] == \
            [e.us_per_call for e in jdb.candidates("all_reduce", "cpu:8",
                                                   loss=loss)]


@pytest.mark.parametrize("loss", (0.05, 0.2))
def test_prune_candidates_with_loss_matches_reference(loss):
    from repro.tune.calibrate import fit_latency_model as jax_fit
    from repro.tune.prune import prune_candidates as jax_prune
    cal = tune.fit_latency_model(_measurements(lambda c: c, (1, 2)))
    jcal = jax_fit(_measurements(_to_jax, (1, 2)))
    cands = [dataclasses.replace(
        c, reliability=tune.config_from_dict(
            {"reliability": "guaranteed"}).reliability)
        for c in tune.enumerate_configs("sendrecv")]
    jcands = [_to_jax(c) for c in cands]
    for size in (1024, 1 << 20):
        kept, skipped = tune.prune_candidates(cands, size, cal, ratio=1.5,
                                              collective="sendrecv",
                                              loss=loss)
        jkept, jskipped = jax_prune(jcands, size, jcal, ratio=1.5,
                                    collective="sendrecv", loss=loss)
        assert [tune.config_to_dict(c) for c in kept] == \
            [jax_tune.config_to_dict(c) for c in jkept]
        assert len(skipped) == len(jskipped)
        assert tune.predicted_latency(cands[0], size, cal, "sendrecv",
                                      loss=loss) > \
            tune.predicted_latency(cands[0], size, cal, "sendrecv")


def test_run_sweep_loss_rate_matches_reference(monkeypatch):
    """The same loss-priced model timer in both packages' lossy sweeps:
    equal entries (TuneEntry.loss included), GUARANTEED candidates only."""
    from repro_torch.tune import calibrate
    monkeypatch.setattr(calibrate.CalibrationResult, "hop_latency",
                        V5E.ici_hop_latency)
    loss = 0.05

    def port(op, n, msg_bytes, cfg, per_dev_shape=None, hops=1, **_):
        return latmodel.pingping_latency(msg_bytes, cfg, HW, 1, loss=loss)

    def jax(op, mesh, msg_bytes, cfg, per_dev_shape=None, cache_key=None,
            **_):
        return jax_latmodel.pingping_latency(msg_bytes, cfg, V5E, 1,
                                             loss=loss)

    kw = dict(collectives=("sendrecv", "multi_neighbor"),
              sizes=(1 << 14, 1 << 20), fast=True, prune=True,
              prune_ratio=1.5, loss_rate=loss)
    stats, jstats = {}, {}
    db = tune.run_sweep(8, timer=port, device="cpu", stats=stats, **kw)
    jdb = jax_sweep.run_sweep(_FakeMesh(8), timer=jax, stats=jstats, **kw)
    view = lambda e: {k: v for k, v in dataclasses.asdict(e).items()
                      if k != "topo"}
    assert [view(e) for e in db.entries] == [view(e) for e in jdb.entries]
    for k in ("total", "measured", "pruned"):
        assert stats[k] == jstats[k], k
    lossy = [e for e in db.entries if e.loss == loss]
    assert lossy and all(e.config["reliability"] == "guaranteed"
                         for e in lossy)
    for coll in kw["collectives"]:
        for size in kw["sizes"]:
            got = tune.select_config(coll, size, db=db, topo="torch-cpu:8",
                                     loss=loss)
            assert got.reliability.value == "guaranteed"


def test_run_sweep_lossy_wire_on_the_cpu():
    """The real timer under seeded chunk loss on the plain path: every
    entry records the rate, every candidate is GUARANTEED, and the
    injected drops really reached the wire (retransmits counted)."""
    from repro_torch.core import reliable
    before = reliable.wire_counters()
    db = tune.run_sweep(8, collectives=("sendrecv",), sizes=(1 << 20,),
                        fast=True, device="cpu", loss_rate=0.2, reps=1,
                        inner=2)
    after = reliable.wire_counters()
    assert db.entries and {e.loss for e in db.entries} == {0.2}
    assert all(e.config["reliability"] == "guaranteed" for e in db.entries)
    assert len(db.entries) == len({json.dumps(e.config, sort_keys=True)
                                   for e in db.entries})
    assert after["retransmits"] > before["retransmits"]
    best = db.best("sendrecv", 1 << 20, "torch-cpu:8")
    assert best.config["reliability"] == "guaranteed"
    with pytest.raises(ValueError, match="loss_rate"):
        tune.run_sweep(8, collectives=("sendrecv",), sizes=(1024,),
                       device="cpu", loss_rate=1.0)
