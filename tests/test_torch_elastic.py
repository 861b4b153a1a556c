"""The port's elastic SWE runtime (``repro_torch.runtime.elastic``) against
the JAX package's, on the CPU.

The JAX side runs once, in one 8-device subprocess: ``run_swe_elastic`` on
the 4x2 torus over the split TuneDB of ``tests/test_faults.py`` (the same
entries under each package's topology keys), fault-free and under rank
loss, a degraded link and chunk loss.  It hands back each report and the
final global-order state.  The port must give the same steps, partition
counts, recoveries (kind, step, whether and to what the configs changed),
no sweep, the same ``wire.*`` counters, and a final state within 1e-5
(float32; ``tests/test_torch_swe.py``'s bound).  Inside the port, two
same-seed runs give equal digest streams, and every faulted run's final
digest equals the fault-free run's."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO, run_multidevice

from repro_torch.core.config import CommConfig
from repro_torch.core.topology import TorusSpec
from repro_torch.runtime.elastic import run_swe_elastic
from repro_torch.runtime.faults import DegradationMonitor, FaultSchedule
from repro_torch.swe import driver

ATOL = 1e-5
TORUS = "4x2"
# name: (elements, comm, steps, segment, schedule, monitor hysteresis,
#        the fault-free case it must end equal to)
CASES = {
    "none": (300, "auto", 30, 10, None, None, "none"),
    "rank_lost": (300, "auto", 30, 10, "rank_lost@10=r5", None, "none"),
    "none_seg5": (300, "auto", 30, 5, None, None, "none_seg5"),
    "degraded_link": (300, "auto", 30, 5, "degraded_link@2=0-1x3.0", 2,
                      "none_seg5"),
    # 16,000 elements: 564 B halo rounds, two 512 B chunks each, so the
    # reorder and duplicate faults have chunks to act on; three segments
    # let the default monitor (hysteresis 3) confirm the lossy wire
    "none_16k": (16000, "chunk512", 15, 5, None, None, "none_16k"),
    "chunk_loss": (16000, "chunk512", 15, 5, "chunk_loss@0=0.05d0.02r0.1",
                   None, "none_16k"),
}
FAULTED = [k for k, c in CASES.items() if c[4] is not None]

JAX_CODE = """
import dataclasses, json
import numpy as np
from repro.core import latmodel
from repro.core.config import CommConfig, CommMode, V5E
from repro.core.topology import TorusSpec
from repro.runtime.elastic import run_swe_elastic
from repro.runtime.faults import DegradationMonitor, FaultSchedule
from repro.swe import driver
from repro.tune.db import TuneDB, TuneEntry
from repro.tune.space import config_to_dict

spec = json.loads(SPEC)
buf = CommConfig(mode=CommMode.BUFFERED)
s4k = CommConfig(mode=CommMode.STREAMING, chunk_bytes=4096)
s1k = CommConfig(mode=CommMode.STREAMING, chunk_bytes=1024)
hw = dataclasses.replace(V5E, host_dispatch=50e-6, fused_dispatch=2e-6,
                         ici_latency=5e-6, ici_bw=0.25e9, hbm_bw=20e9,
                         ici_hop_latency=20e-6)
db = TuneDB()
for topo in ("cpu:8", "cpu:7", "cpu:4"):
    for cfg in (buf, s4k, s1k):
        for size in (4096, 16384, 65536, 1 << 20):
            for hops in (1, 3):
                sec = latmodel.pingping_latency(size, cfg, hw, hops=hops)
                db.add(TuneEntry(topo=topo, collective="sendrecv",
                                 msg_bytes=size, config=config_to_dict(cfg),
                                 us_per_call=sec * 1e6, hops=hops))
    for coll in ("multi_neighbor", "all_reduce"):
        for cfg, us in ((buf, 1.0), (s4k, 100.0), (s1k, 100.0)):
            for size in (256, 4096, 65536, 1 << 20):
                for hops in (1, 2, 3):
                    db.add(TuneEntry(topo=topo, collective=coll,
                                     msg_bytes=size,
                                     config=config_to_dict(cfg),
                                     us_per_call=us, hops=hops))
db.save(spec["db"])

last = {}
_digest = driver.state_digest
def recording_digest(sim, state):
    last["state"] = driver.flatten_state(sim, state)
    return _digest(sim, state)
driver.state_digest = recording_digest

COMMS = {"auto": "auto", "chunk512": CommConfig(chunk_bytes=512)}
reports, states = {}, {}
for name, (el, comm, steps, seg, sched, hyst, _) in spec["cases"].items():
    mon = (DegradationMonitor(threshold=1.5, hysteresis=hyst, cooldown=100)
           if hyst else None)
    r = run_swe_elastic(el, 8, TorusSpec.parse(spec["torus"]),
                        comm_cfg=COMMS[comm], n_steps=steps, segment=seg,
                        schedule=FaultSchedule.parse(sched) if sched else None,
                        tune_db_path=spec["db"], monitor=mon)
    reports[name] = json.loads(r.to_json())
    states[name] = last["state"]
np.savez(spec["out"], **states)
with open(spec["reports"], "w") as f:
    json.dump(reports, f)
print("JAX REF OK", len(reports))
"""


def _comm(key):
    return {"auto": "auto", "chunk512": CommConfig(chunk_bytes=512)}[key]


def _run(name, db_path):
    el, comm, steps, seg, sched, hyst, _ = CASES[name]
    mon = (DegradationMonitor(threshold=1.5, hysteresis=hyst, cooldown=100)
           if hyst else None)
    return run_swe_elastic(
        el, 8, TorusSpec.parse(TORUS), comm_cfg=_comm(comm), n_steps=steps,
        segment=seg, schedule=FaultSchedule.parse(sched) if sched else None,
        tune_db_path=db_path, monitor=mon, device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic_ref")
    spec = {"cases": CASES, "torus": TORUS, "db": str(d / "jax_db.json"),
            "out": str(d / "states.npz"), "reports": str(d / "reports.json")}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX REF OK" in out
    raw = json.loads((d / "jax_db.json").read_text())
    for e in raw["entries"]:
        e["topo"] = "torch-" + e["topo"]
    db_path = d / "port_db.json"
    db_path.write_text(json.dumps(raw))
    # the port's runs: every case, and each faulted one twice
    final = {}
    runs = {}
    for name in CASES:
        runs[name] = _run(name, db_path)
        state = []
        digest = driver.state_digest

        def keep(sim, st, _state=state):
            _state.append(driver.flatten_state(sim, st))
            return digest(sim, st)
        driver.state_digest = keep
        try:
            again = _run(name, db_path)
        finally:
            driver.state_digest = digest
        final[name] = (again, state[-1])
    return dict(jax=json.loads((d / "reports.json").read_text()),
                jax_states=dict(np.load(d / "states.npz")),
                runs=runs, again=final, db=db_path, dir=d)


@pytest.mark.parametrize("name", list(CASES))
def test_report_matches_reference(ref, name):
    got = json.loads(ref["runs"][name].to_json())
    want = ref["jax"][name]
    for key in ("steps_run", "n_parts", "sweep_runs_delta",
                "wire_retransmits", "wire_dup_dropped", "wire_timeouts",
                "drained"):
        assert got[key] == want[key], key
    assert len(got["digests"]) == len(want["digests"])
    assert [(r["kind"], r["step"]) for r in got["recoveries"]] == \
        [(r["kind"], r["step"]) for r in want["recoveries"]]
    for g, w in zip(got["recoveries"], want["recoveries"]):
        assert g["configs_after"] == w["configs_after"]
        assert (g["configs_before"] != g["configs_after"]) == \
            (w["configs_before"] != w["configs_after"])
    np.testing.assert_allclose(ref["again"][name][1],
                               ref["jax_states"][name], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", FAULTED)
def test_faulted_run_is_deterministic_and_exact(ref, name):
    first, (second, _) = ref["runs"][name], ref["again"][name]
    assert first.recoveries, name
    assert first.digests == second.digests
    assert first.final_digest == second.final_digest
    assert first.final_digest == ref["runs"][CASES[name][6]].final_digest
    assert first.sweep_runs_delta == 0
    if name == "chunk_loss":
        assert first.wire_retransmits > 0 and first.wire_timeouts > 0
    else:
        assert first.wire_retransmits == 0


def test_cli_kill_and_resume(ref):
    d = ref["dir"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base = [sys.executable, "-m", "repro_torch.runtime.elastic",
            "--device", "cpu", "--elements", "300", "--steps", "30",
            "--segment", "10", "--topology", TORUS,
            "--tune-db", str(ref["db"])]
    clean = subprocess.run(base + ["--json", str(d / "clean.json")],
                           capture_output=True, text=True, env=env,
                           cwd=str(REPO), timeout=300)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    faulted = subprocess.run(
        base + ["--schedule", "rank_lost@10=r5", "--check-against",
                str(d / "clean.json"), "--expect-recovery"],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300)
    assert faulted.returncode == 0, faulted.stdout + faulted.stderr
    assert "final digest matches reference" in faulted.stdout
    assert "[rank_lost@10]" in faulted.stdout
