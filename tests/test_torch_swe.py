"""The port's shallow-water main path against the JAX package.

The JAX reference runs once, in one 8-device subprocess that batches every
case and hands the final states back as ``.npz``; the port runs here on CPU
tensors (``device="cpu"``).  Tolerance against the reference after 20
steps: atol 1e-5 in float32 (the kernels' bound, ``tests/test_kernels.py``);
the two sides differ only in the order and fusion of float32 operations.
Inside the port every schedule, and flat vs torus, is bitwise equal."""
import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import REPO, run_multidevice

from repro_torch.core import plans
from repro_torch.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG,
                                     CommConfig, Scheduling, Transport)
from repro_torch.core.topology import TorusSpec
from repro_torch.swe import driver
from repro_torch.swe.partition import _rcb

ATOL = 1e-5
STEPS = 20
ELEMENTS = 500
PARTS = (1, 2, 4, 8)
# the torus each partition count is placed on (2x4 routes multi-hop edges)
TORUS = {1: "1x1", 2: "1x2", 4: "2x2", 8: "2x4"}
CONFIGS = {"fused": CommConfig(), "overlapped": OVERLAPPED_CONFIG,
           "host": BASELINE_CONFIG}
# rounds of 77 rows (924 B per rank) over 512 B chunks: 2 chunks, one ack link
MULTICHUNK = {"fused": CommConfig(chunk_bytes=512,
                                  transport=Transport.ORDERED, window=1),
              "overlapped": CommConfig(chunk_bytes=512,
                                       transport=Transport.ORDERED, window=1,
                                       scheduling=Scheduling.OVERLAPPED)}
MULTICHUNK_ELEMENTS, MULTICHUNK_PARTS = 20000, 2

CASES = list(itertools.product(PARTS, (False, True), CONFIGS))

JAX_CODE = """
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.config import (BASELINE_CONFIG, OVERLAPPED_CONFIG, CommConfig,
                               Scheduling, Transport)
from repro.core.topology import TorusSpec
from repro.swe import driver

spec = json.loads(SPEC)
CONFIGS = {"fused": CommConfig(), "overlapped": OVERLAPPED_CONFIG,
           "host": BASELINE_CONFIG}
MULTICHUNK = {"fused": CommConfig(chunk_bytes=512,
                                  transport=Transport.ORDERED, window=1),
              "overlapped": CommConfig(chunk_bytes=512,
                                       transport=Transport.ORDERED, window=1,
                                       scheduling=Scheduling.OVERLAPPED)}

def run(n_elements, parts, cfg, torus, steps):
    mesh = Mesh(np.array(jax.devices()[:parts]), ("data",))
    topo = TorusSpec.parse(torus) if torus else None
    sim = driver.build_simulation(n_elements, mesh, cfg, topology=topo)
    if cfg.scheduling == Scheduling.HOST:
        state, _ = driver.make_host_scheduled_runner(sim).run(
            sim.state, 0.0, steps)
    else:
        state = driver.make_sim_runner(sim, steps)(sim.state, 0.0)
    return sim, np.asarray(state)

out = {}
for parts, torus, name in spec["cases"]:
    sim, state = run(spec["elements"], parts, CONFIGS[name], torus,
                     spec["steps"])
    out[f"{parts}/{torus}/{name}"] = state
    if parts == 8 and not torus and name == "fused":
        out["digest8"] = np.array(driver.state_digest(sim, state))
        for f in ("state0", "area", "normals", "neigh_idx", "edge_type",
                  "valid", "send_idx", "send_mask", "recv_slot", "n_core",
                  "n_send", "n_neighbors", "boundary_idx", "n_boundary"):
            out["pm8/" + f] = getattr(sim.pm, f)
        for f in ("n_parts", "e_max", "h_max", "s_max", "n_rounds"):
            out["pm8/" + f] = np.array(getattr(sim.pm, f))
        out["pm8/rounds"] = np.array(json.dumps(sim.pm.rounds))
for name, cfg in MULTICHUNK.items():
    _, state = run(spec["mc_elements"], spec["mc_parts"], cfg, "",
                   spec["steps"])
    out["mc/" + name] = state
np.savez(spec["out"], **out)
print("JAX REF OK", len(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("swe_ref") / "ref.npz"
    spec = {"out": str(path), "elements": ELEMENTS, "steps": STEPS,
            "cases": [(p, TORUS[p] if t else "", n) for p, t, n in CASES],
            "mc_elements": MULTICHUNK_ELEMENTS, "mc_parts": MULTICHUNK_PARTS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX REF OK" in out
    return dict(np.load(path))


def _run(sim, steps=STEPS):
    if sim.comm_cfg.scheduling == Scheduling.HOST:
        runner = driver.make_host_scheduled_runner(sim)
        state, _ = runner.run(sim.state, 0.0, steps)
        assert runner.dispatches == 2 * steps
        return state
    return driver.make_sim_runner(sim, steps)(sim.state, 0.0)


@functools.lru_cache(maxsize=None)
def _port_state(parts, torus, name):
    topo = TorusSpec.parse(TORUS[parts]) if torus else None
    sim = driver.build_simulation(ELEMENTS, parts, CONFIGS[name],
                                  topology=topo, device="cpu")
    return _run(sim).numpy()


@pytest.mark.parametrize("parts,torus,name", CASES)
def test_state_matches_reference(ref, parts, torus, name):
    want = ref[f"{parts}/{TORUS[parts] if torus else ''}/{name}"]
    got = _port_state(parts, torus, name)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("parts", PARTS)
def test_schedules_and_torus_bitwise_equal(parts):
    base = _port_state(parts, False, "fused")
    for torus, name in itertools.product((False, True), CONFIGS):
        assert np.array_equal(_port_state(parts, torus, name), base), (
            torus, name)


@pytest.mark.parametrize("name", list(MULTICHUNK))
def test_multichunk_rounds_match_reference(ref, name):
    cfg = MULTICHUNK[name]
    sim = driver.build_simulation(MULTICHUNK_ELEMENTS, MULTICHUNK_PARTS, cfg,
                                  device="cpu")
    # the rounds really span several wire chunks under both layouts
    for eq in (True, False):
        plan = plans.chunk_plan((sim.pm.s_max, 3), torch.float32, cfg,
                                align=1 if eq else 3, equal_split=eq)
        assert plan.n_chunks > 1 and plan.ack_of[1] == 0, plan
    got = _run(sim).numpy()
    np.testing.assert_allclose(got, ref["mc/" + name], atol=ATOL, rtol=0)
    other = dataclasses.replace(sim, comm_cfg=CommConfig())
    assert np.array_equal(got, _run(other).numpy())


def test_from_reference_partition_and_digest(ref):
    arrays = {k[len("pm8/"):]: v for k, v in ref.items()
              if k.startswith("pm8/")}
    arrays["rounds"] = json.loads(str(arrays["rounds"]))
    sim = driver.from_reference(arrays, CommConfig(), device="cpu")
    got = _run(sim).numpy()
    assert np.array_equal(got, _port_state(8, False, "fused"))
    np.testing.assert_allclose(got, ref["8//fused"], atol=ATOL, rtol=0)
    own = driver.build_simulation(ELEMENTS, 8, CommConfig(), device="cpu")
    assert driver.state_digest(own, ref["8//fused"]) == str(ref["digest8"])


def test_flatten_state_matches_elementwise_loop():
    sim = driver.build_simulation(ELEMENTS, 4, CommConfig(), device="cpu")
    s = np.random.RandomState(0).randn(*sim.state.shape).astype(np.float32)
    part = _rcb(sim.mesh.centroids, 4)
    counts = np.zeros(4, int)
    want = np.zeros((sim.mesh.n_elements, 3), np.float32)
    for e in range(sim.mesh.n_elements):
        want[e] = s[part[e], counts[part[e]]]
        counts[part[e]] += 1
    assert np.array_equal(driver.flatten_state(sim, torch.from_numpy(s)), want)


def test_mass_conservation():
    sim = driver.build_simulation(600, 8, CommConfig(), device="cpu")
    area = torch.from_numpy(sim.pm.area)
    valid = torch.from_numpy(sim.pm.valid).double()
    m0 = float(torch.sum(sim.state[..., 0].double() * area * valid))
    s = driver.make_sim_runner(sim, 50)(sim.state, 0.0)
    m1 = float(torch.sum(s[..., 0].double() * area * valid))
    assert abs(m1 - m0) / m0 < 5e-3, (m0, m1)
    assert torch.isfinite(s).all()


def test_host_runner_counts_two_dispatches_per_step():
    sim = driver.build_simulation(ELEMENTS, 2, BASELINE_CONFIG, device="cpu")
    runner = driver.make_host_scheduled_runner(sim)
    _, t = runner.run(sim.state, 0.0, 7)
    assert runner.dispatches == 14
    assert t == pytest.approx(7 * sim.swe.dt)


def test_port_imports_no_jax_and_no_reference_package():
    code = """
import importlib, pathlib, sys
src = pathlib.Path("src")
names = sorted(".".join(p.with_suffix("").relative_to(src).parts).replace(
    ".__init__", "") for p in (src / "repro_torch").rglob("*.py"))
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
assert "repro_torch.swe.driver" in names and len(names) >= 15, names
print("CLEAN", len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(REPO), timeout=120,
                          env=dict(os.environ,
                                   PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr
    assert "CLEAN" in proc.stdout


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.build_simulation(ELEMENTS, 2, CommConfig())
    with pytest.raises(NotImplementedError):
        driver.build_simulation(ELEMENTS, 2, "auto", device="cpu")


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bound_accounting():
    """The bytes chip_smoke.py divides by the card's bandwidth: every input
    row the kernel needs once, neighbours only for interior/remote edges,
    duplicate rows of a row list once."""
    cs = _chip_smoke()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    state, halo = torch.zeros(1, 2, 3), torch.zeros(1, 1, 3)
    neigh = i32([[[1, 2, 0], [0, 0, 0]]])
    etype = i32([[[0, 3, 1], [2, 1, 0]]])
    args = [state, halo, None, neigh, etype]
    # rows {0, 1} + [state|halo] rows {0, 1, 2}: 3 x 12 B read, 2 x 56 B
    # per-row inputs and output, 3 neighbour indices, h_sea
    assert cs.kernel_bytes(args, None) == 3 * 12 + 2 * 56 + 3 * 4 + 4
    # row 1 listed twice: rows {1} + its neighbour {0}, one index, the list
    assert cs.kernel_bytes(args, i32([[1, 1]])) == (2 * 12 + 56 + 4 + 4
                                                    + 2 * 4)


def test_chip_smoke_stable_dt_is_the_courant_limit():
    cs = _chip_smoke()
    sim = driver.build_simulation(1696, 8, CommConfig(), device="cpu")
    edge = np.linalg.norm(sim.mesh.normals, axis=-1).sum(axis=1)
    limit = (sim.mesh.area / edge).min() / np.sqrt(9.81 * 1.3)
    assert cs.stable_dt(sim) == pytest.approx(cs.COURANT * limit, rel=1e-3)
    assert cs.stable_dt(sim) > sim.swe.dt    # 1e-4 is stable at this size
