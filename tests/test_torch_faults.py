"""The port's fault schedules, injector, degradation monitor, torus
degradation helpers and model re-selection against the JAX package.

Everything here is host-side Python, so the comparison is exact: the JAX
side runs once, in one subprocess, over the same cases (schedule strings,
generator seeds, a shared sample stream, torus shapes, the split TuneDB of
``tests/test_faults.py``) and hands its answers back as JSON."""
import json

import pytest

from helpers import run_multidevice

from repro_torch.core.communicator import Communicator
from repro_torch.core.config import OPTIMIZED_CONFIG, CommConfig, CommMode
from repro_torch.core.topology import TorusSpec, route_rounds
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import fault_tolerance
from repro_torch.runtime.faults import (DegradationMonitor, FaultInjector,
                                        FaultSchedule, RankLostError)
from repro_torch.tune.db import TuneDB
from repro_torch.tune.elastic import model_reselect, reselect_round_configs
from repro_torch.tune.space import config_to_dict

GOOD = [
    "degraded_link@5=0-1x3.0;rank_lost@10=r5;straggler@7=r2x4.0;preempt@30",
    "chunk_loss@5=0.05", "chunk_loss@0=0.05d0.02r0.1",
    "chunk_loss@3=0.1r0.2", "chunk_loss@3=0d0.3", "rank_lost@0=7",
    " straggler@1=r0x1.0 ; degraded_link@2=3-2x1.5 ;",
    "preempt@4;preempt@2;rank_lost@2=r1",
]
BAD = [
    "bogus@1", "rank_lost", "rank_lost@=r1", "rank_lost@-1=r1",
    "rank_lost@1=rr5", "rank_lost@1=r-1", "rank_lost@1=", "preempt@3=x",
    "degraded_link@1=0-1", "degraded_link@1=0x2", "degraded_link@1=1-1x2",
    "degraded_link@1=0-1x0.5", "straggler@1=r2", "straggler@1=r2x0.9",
    "chunk_loss@1=", "chunk_loss@1=1.5", "chunk_loss@1=0", "chunk_loss@1=abc",
    "chunk_loss@1=0.1dxx", "rank_lost@1=r2;rank_lost@1=r2",
]
GENERATE = [
    dict(seed=0, n_steps=30, n_ranks=8),
    dict(seed=7, n_steps=100, torus="4x2", degraded_links=2, rank_losses=1,
         stragglers=2, preempts=1),
    dict(seed=123, n_steps=60, torus="6x8:snake", degraded_links=3,
         rank_losses=2, stragglers=0),
    dict(seed=5, n_steps=5, n_ranks=3, preempts=2),
]
INJECT_SCHEDULE = ("degraded_link@2=0-1x3.0;straggler@4=r1x3.0;"
                   "chunk_loss@6=0.05d0.02r0.1;degraded_link@9=1-2x2.0;"
                   "chunk_loss@12=0.2;preempt@13;degraded_link@14=0-1x2.0;"
                   "rank_lost@18=r5")
INJECT_STEPS = [0, 1, 3, 5, 7, 10, 12, 13, 15, 20]


def sample_stream():
    """A shared per-observation stream for the monitor: per-edge latencies
    (two edges degrade for a while, one flickers) and registry
    increments (traffic by hop, retransmits, stragglers)."""
    edges = [(0, 1), (1, 2), (2, 3), (0, 4)]
    stream = []
    for step in range(40):
        lat = {e: 1.0 + 0.01 * ((step * 7 + i) % 5)
               for i, e in enumerate(edges)}
        if 5 <= step < 15:
            lat[(0, 1)] = 3.0
        if step % 3 == 0:
            lat[(2, 3)] = 2.0
        if 20 <= step < 30:
            lat[(1, 2)] = 1.8
        stream.append({"step": step,
                       "lat": [[list(e), v] for e, v in lat.items()],
                       "traffic": {"1": 0 if 25 <= step < 28 else 100,
                                   "2": 50},
                       "retransmits": 3 if 8 <= step < 16 else 0,
                       "stragglers": 1 if step in (9, 10) else 0})
    return stream


RESELECT = [
    dict(collective="multi_neighbor", msg_bytes=1104, hops=1),
    dict(collective="multi_neighbor", msg_bytes=1104, hops=3),
    dict(collective="multi_neighbor", msg_bytes=65536, hops=2,
         link_slowdown=3.0),
    dict(collective="multi_neighbor", msg_bytes=1104, hops=1, loss=0.05),
    dict(collective="all_reduce", msg_bytes=1 << 20, hops=1, loss=0.2),
    dict(collective="all_reduce", msg_bytes=4096, hops=2, objective="e2e",
         compute_s=1e-4),
    dict(collective="sendrecv", msg_bytes=16384, hops=1, topo="8"),
]
ROUND_PATTERNS = {
    "ring": [[(i, (i + 1) % 8) for i in range(8)],
             [((i + 1) % 8, i) for i in range(8)]],
    "mixed": [[(0, 1), (1, 0), (2, 3), (3, 2)], [(0, 5), (5, 0)],
              [(4, 7), (7, 4), (1, 6), (6, 1)]],
}
ROUND_CASES = [("ring", "4x2", None, 0.0), ("mixed", "4x2", None, 0.0),
               ("mixed", "4x2", (0, 1, 3.0), 0.0),
               ("mixed", "2x4", (1, 2, 2.0), 0.05)]
ROUTE_CASES = [("4x4", [(0, 1, 3.0)], False), ("4x4", [(0, 1, 3.0)], True),
               ("4x4", [(0, 4, 2.5), (5, 6, 4.0)], True),
               ("2x4", [(1, 2, 2.0)], False)]

JAX_CODE = """
import json, dataclasses
from repro.core import latmodel
from repro.core.communicator import Communicator
from repro.core.config import CommConfig, CommMode, V5E, OPTIMIZED_CONFIG
from repro.core.topology import TorusSpec, route_rounds
from repro.obs import metrics as obs_metrics
from repro.runtime.faults import (DegradationMonitor, FaultInjector,
                                  FaultSchedule, RankLostError)
from repro.tune.db import TuneDB, TuneEntry
from repro.tune.elastic import model_reselect, reselect_round_configs
from repro.tune.space import config_to_dict

spec = json.loads(SPEC)
out = {"parse": [], "bad": [], "generate": [], "inject": [], "samples": [],
       "monitor": [], "shrink": [], "routes": [], "reselect": [],
       "rounds": []}
for text in spec["good"]:
    out["parse"].append(FaultSchedule.parse(text).to_json())
for text in spec["bad"]:
    try:
        FaultSchedule.parse(text)
        out["bad"].append(None)
    except ValueError as e:
        out["bad"].append(str(e))
for g in spec["generate"]:
    g = dict(g)
    torus = g.pop("torus", None)
    if torus:
        g["spec"] = TorusSpec.parse(torus)
    out["generate"].append(FaultSchedule.generate(**g).to_json())

class Guard:
    n = 0
    def request(self):
        Guard.n += 1
sched = FaultSchedule.parse(spec["inject"])
sched = FaultSchedule(events=sched.events, seed=11)
slept = []
inj = FaultInjector(sched, base_step_s=0.5, sleep=slept.append)
for step in spec["inject_steps"]:
    try:
        fired = [repr(e) for e in inj.poll(step, guard=Guard())]
        lost = None
    except RankLostError as e:
        fired, lost = None, [e.rank, e.step]
    wf = inj.wire_faults()
    out["inject"].append([step, fired, lost,
                          sorted([list(k), v] for k, v in
                                 inj.active_slowdowns.items()),
                          list(slept), Guard.n, repr(wf),
                          inj.straggler_delay_s(step)])
    out["samples"].append(sorted(
        [list(k), v] for k, v in inj.edge_latency_samples(
            step, [(0, 1), (2, 1), (5, 4), (3, 7)]).items()))
spec8 = TorusSpec.parse("2x4")
out["degrade"] = repr(inj.degrade_spec(spec8))

reg = obs_metrics.Registry()
mon = DegradationMonitor(threshold=1.5, hysteresis=2, cooldown=6,
                         registry=reg)
for obs in spec["stream"]:
    for h, v in obs["traffic"].items():
        reg.counter("comm.edge_bytes", hops=int(h)).inc(v)
    reg.counter("wire.retransmits").inc(obs["retransmits"])
    reg.counter("watchdog.stragglers").inc(obs["stragglers"])
    conf = mon.observe(obs["step"], {tuple(e): v for e, v in obs["lat"]},
                       require_traffic=obs["step"] >= 20)
    out["monitor"].append([[list(c) for c in conf], mon.wire_confirmed,
                           mon.last_straggler_delta,
                           mon.last_retransmit_delta,
                           mon.baseline((0, 1)), mon.baseline((2, 3))])
big = TorusSpec.parse("6x8:snake")
for n in range(1, 49):
    s = big.shrink(n)
    out["shrink"].append([list(s.shape), s.per_hop_ns, s.bisection_gbps])
for torus, slows, reroute in spec["routes"]:
    s = TorusSpec.parse(torus)
    for a, b, f in slows:
        s = s.with_link_slowdown(a, b, f)
    s = s.with_reroute(reroute)
    n = s.n_ranks
    res = [list(s.degraded_links), repr(s.without_degradations())]
    for d in range(1, s.diameter + 1):
        rp = route_rounds(s, s.hop_perm(d))
        res.append([[[list(map(list, r)) for r in b.rounds], list(b.dests)]
                    for b in rp.batches])
    out["routes"].append(res)

def build_split_db(topos):
    buf = CommConfig(mode=CommMode.BUFFERED)
    s4k = CommConfig(mode=CommMode.STREAMING, chunk_bytes=4096)
    s1k = CommConfig(mode=CommMode.STREAMING, chunk_bytes=1024)
    hw = dataclasses.replace(V5E, host_dispatch=50e-6, fused_dispatch=2e-6,
                             ici_latency=5e-6, ici_bw=0.25e9, hbm_bw=20e9,
                             ici_hop_latency=20e-6)
    db = TuneDB()
    for topo in topos:
        for cfg in (buf, s4k, s1k):
            for size in (4096, 16384, 65536, 1 << 20):
                for hops in (1, 3):
                    sec = latmodel.pingping_latency(size, cfg, hw, hops=hops)
                    db.add(TuneEntry(topo=topo, collective="sendrecv",
                                     msg_bytes=size,
                                     config=config_to_dict(cfg),
                                     us_per_call=sec * 1e6, hops=hops))
        for coll in ("multi_neighbor", "all_reduce"):
            for cfg, us in ((buf, 1.0), (s4k, 100.0), (s1k, 100.0)):
                for size in (256, 4096, 65536, 1 << 20):
                    for hops in (1, 2, 3):
                        db.add(TuneEntry(topo=topo, collective=coll,
                                         msg_bytes=size,
                                         config=config_to_dict(cfg),
                                         us_per_call=us, hops=hops))
    return db

db = build_split_db(("cpu:8", "cpu:7", "cpu:4"))
db.save(spec["db_out"])
fb = CommConfig(mode=CommMode.STREAMING, chunk_bytes=8192)
for case in spec["reselect"]:
    kw = dict(case)
    if "topo" in kw:
        kw["topo"] = "cpu:" + kw["topo"]
    c = model_reselect(db=db, fallback=fb, **kw)
    cold = model_reselect(db=TuneDB(), fallback=fb, **kw)
    out["reselect"].append([config_to_dict(c), config_to_dict(cold)])
for pattern, torus, slow, loss in spec["round_cases"]:
    s = TorusSpec.parse(torus)
    if slow:
        s = s.with_link_slowdown(*slow)
    comm = Communicator(("data",), (8,), topo=s)
    rep, rcfgs = reselect_round_configs(spec["patterns"][pattern], comm,
                                        1104, db=db, loss=loss, fallback=fb)
    out["rounds"].append([config_to_dict(rep), None if rcfgs is None
                          else [config_to_dict(c) for c in rcfgs]])
print("JAX REF", json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("faults_ref")
    spec = {"good": GOOD, "bad": BAD, "generate": GENERATE,
            "inject": INJECT_SCHEDULE, "inject_steps": INJECT_STEPS,
            "stream": sample_stream(), "routes": ROUTE_CASES,
            "reselect": RESELECT, "round_cases": ROUND_CASES,
            "patterns": ROUND_PATTERNS, "db_out": str(d / "jax_db.json")}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=1)
    line = next(l for l in out.splitlines() if l.startswith("JAX REF "))
    want = json.loads(line[len("JAX REF "):])
    # the same DB under the port's topology keys ("cpu:8" -> "torch-cpu:8")
    raw = json.loads((d / "jax_db.json").read_text())
    for e in raw["entries"]:
        e["topo"] = "torch-" + e["topo"]
    (d / "port_db.json").write_text(json.dumps(raw))
    want["db"] = TuneDB.load(d / "port_db.json")
    return want


def test_parse_and_json_match_reference(ref):
    for text, want in zip(GOOD, ref["parse"]):
        sched = FaultSchedule.parse(text)
        assert sched.to_json() == want, text
        assert FaultSchedule.from_json(want).to_json() == want


def test_malformed_items_raise_the_reference_errors(ref):
    for text, want in zip(BAD, ref["bad"]):
        assert want is not None, text
        with pytest.raises(ValueError) as e:
            FaultSchedule.parse(text)
        assert str(e.value) == want


def test_generate_matches_reference(ref, tmp_path):
    for g, want in zip(GENERATE, ref["generate"]):
        g = dict(g)
        torus = g.pop("torus", None)
        if torus:
            g["spec"] = TorusSpec.parse(torus)
        sched = FaultSchedule.generate(**g)
        assert sched.to_json() == want
        path = sched.save(tmp_path / "s.json")
        assert FaultSchedule.load(path).to_json() == want


def test_injector_matches_reference(ref):
    class Guard:
        n = 0

        def request(self):
            Guard.n += 1

    sched = FaultSchedule.parse(INJECT_SCHEDULE)
    sched = FaultSchedule(events=sched.events, seed=11)
    slept = []
    inj = FaultInjector(sched, base_step_s=0.5, sleep=slept.append)
    for step, want, want_samples in zip(INJECT_STEPS, ref["inject"],
                                        ref["samples"]):
        try:
            fired = [repr(e) for e in inj.poll(step, guard=Guard())]
            lost = None
        except RankLostError as e:
            fired, lost = None, [e.rank, e.step]
        got = [step, fired, lost,
               sorted([list(k), v] for k, v in inj.active_slowdowns.items()),
               list(slept), Guard.n, repr(inj.wire_faults()),
               inj.straggler_delay_s(step)]
        assert got == want, step
        assert sorted([list(k), v] for k, v in inj.edge_latency_samples(
            step, [(0, 1), (2, 1), (5, 4), (3, 7)]).items()) == want_samples
    assert repr(inj.degrade_spec(TorusSpec.parse("2x4"))) == ref["degrade"]


def test_monitor_decisions_match_reference(ref):
    reg = obs_metrics.Registry()
    mon = DegradationMonitor(threshold=1.5, hysteresis=2, cooldown=6,
                             registry=reg)
    for obs, want in zip(sample_stream(), ref["monitor"]):
        for h, v in obs["traffic"].items():
            reg.counter("comm.edge_bytes", hops=int(h)).inc(v)
        reg.counter("wire.retransmits").inc(obs["retransmits"])
        reg.counter("watchdog.stragglers").inc(obs["stragglers"])
        conf = mon.observe(obs["step"],
                           {tuple(e): v for e, v in obs["lat"]},
                           require_traffic=obs["step"] >= 20)
        got = [[list(c) for c in conf], mon.wire_confirmed,
               mon.last_straggler_delta, mon.last_retransmit_delta,
               mon.baseline((0, 1)), mon.baseline((2, 3))]
        assert got == want, obs["step"]
    assert mon.confirmed and mon.wire_confirmations >= 1


def test_shrink_matches_reference(ref):
    big = TorusSpec.parse("6x8:snake")
    for n, want in zip(range(1, 49), ref["shrink"]):
        s = big.shrink(n)
        assert [list(s.shape), s.per_hop_ns, s.bisection_gbps] == want
        assert fault_tolerance.survivor_topology(big, n) == (
            big if n == 48 else s)
    with pytest.raises(ValueError):
        big.shrink(49)
    assert fault_tolerance.survivor_topology(None, 3) is None


def test_degraded_routes_match_reference(ref):
    for (torus, slows, reroute), want in zip(ROUTE_CASES, ref["routes"]):
        s = TorusSpec.parse(torus)
        for a, b, f in slows:
            s = s.with_link_slowdown(a, b, f)
        s = s.with_reroute(reroute)
        got = [list(map(list, s.degraded_links)),
               repr(s.without_degradations())]
        for d in range(1, s.diameter + 1):
            rp = route_rounds(s, s.hop_perm(d))
            got.append([[[list(map(list, r)) for r in b.rounds],
                         list(b.dests)] for b in rp.batches])
        assert got == want, (torus, slows, reroute)
    s = TorusSpec.parse("4x4").with_link_slowdown(0, 1, 3.0)
    assert s.with_link_slowdown(1, 0, 1.0).link_slowdowns is None
    with pytest.raises(ValueError):
        s.with_link_slowdown(0, 1, 0.5)


def test_model_reselect_matches_reference(ref):
    db = ref["db"]
    fb = CommConfig(mode=CommMode.STREAMING, chunk_bytes=8192)
    reg = obs_metrics.registry()
    runs0 = reg.counter("sweep.runs").value
    cold0 = reg.counter("tune.reselect_cold_fallbacks").value
    for case, (want, want_cold) in zip(RESELECT, ref["reselect"]):
        kw = dict(case)
        if "topo" in kw:
            kw["topo"] = "torch-cpu:" + kw["topo"]
        assert config_to_dict(model_reselect(db=db, fallback=fb, **kw)) \
            == want, case
        cold = model_reselect(db=TuneDB(), fallback=fb, **kw)
        assert config_to_dict(cold) == want_cold, case
    # a cold DB falls back (the lossy ones hardened) and never sweeps
    assert reg.counter("tune.reselect_cold_fallbacks").value \
        == cold0 + len(RESELECT)
    assert reg.counter("sweep.runs").value == runs0
    assert model_reselect("multi_neighbor", 1104, db=TuneDB()) \
        == OPTIMIZED_CONFIG


def test_reselect_round_configs_match_reference(ref):
    db = ref["db"]
    fb = CommConfig(mode=CommMode.STREAMING, chunk_bytes=8192)
    for (pattern, torus, slow, loss), want in zip(ROUND_CASES,
                                                  ref["rounds"]):
        s = TorusSpec.parse(torus)
        if slow:
            s = s.with_link_slowdown(*slow)
        comm = Communicator(("data",), (8,), topo=s)
        rep, rcfgs = reselect_round_configs(ROUND_PATTERNS[pattern], comm,
                                            1104, db=db, loss=loss,
                                            fallback=fb)
        got = [config_to_dict(rep), None if rcfgs is None
               else [config_to_dict(c) for c in rcfgs]]
        assert got == want, (pattern, torus, slow, loss)


def test_watchdog_and_guard(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(fault_tolerance.time, "perf_counter",
                        lambda: clock[0])
    wd = fault_tolerance.StepWatchdog(k=3.0, warmup=3, window=8,
                                      max_events=2)
    reg = obs_metrics.registry()
    before = reg.counter("watchdog.stragglers").value
    for i, dur in enumerate((1.0, 1.1, 0.9, 1.0, 1.05, 9.0)):
        wd.start_step(i)
        clock[0] += dur
        wd.end_step()
    assert [e.step for e in wd.events] == [5]
    assert reg.counter("watchdog.stragglers").value == before + 1
    assert wd.end_step() is None               # start mark consumed
    assert wd.median_step == 1.025
    guard = fault_tolerance.PreemptionGuard(signals=())
    with guard:
        assert not guard.preempted
        guard.request()
    assert guard.preempted
