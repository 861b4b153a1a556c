"""The port's reliable wire (``repro_torch.core.reliable`` and the streaming
engine's recovery branch) against the JAX package.

The JAX side runs once, in one 8-device subprocess, and hands back the
delivery plans of a grid of fault patterns, the seeded fault outcomes, the
30-cell parity matrix (values and ``wire.*`` counter deltas) and SWE runs
under ``GUARANTEED`` + faults (the plans each runner build draws, message
ids per build, counter deltas, states).  Tolerances: plans, outcomes,
counters and message ids are equal; the parity matrix's values are bitwise
equal (the wire only moves values); SWE states agree within 1e-5 (float32,
``tests/test_torch_swe.py``'s bound) and, inside the port, bitwise with the
lossless ``BEST_EFFORT`` run."""
import itertools
import json

import numpy as np
import pytest
import torch

from helpers import require_hypothesis, run_multidevice

from repro_torch.core import reliable, streaming
from repro_torch.core.config import (CommConfig, CommMode, Reliability,
                                     Scheduling, Transport)
from repro_torch.swe import driver

ATOL = 1e-5
KNOBS = dict(window=4, ack_timeout=2, max_retransmits=4, backoff_base=1,
             backoff_cap=4)


def _hand_cases():
    """The JAX package's hand cases (``tests/test_reliable.py``)."""
    k = dict(KNOBS)
    return [
        dict(n=6, drops=[], dups=[], order=None, knobs=k),
        dict(n=4, drops=[(1, 0)], dups=[], order=None, knobs=k),
        dict(n=4, drops=[], dups=[2], order=None, knobs=k),
        dict(n=8, drops=[(1, 0), (4, 0), (0, 0)], dups=[0, 1, 3],
             order=[0, 2, 1, 3, 4, 5, 6, 7],
             knobs=dict(k, window=2, ack_timeout=1, backoff_cap=2)),
        dict(n=5, drops=[], dups=[], order=[4, 3, 2, 1, 0], knobs=k),
        dict(n=2, drops=[(0, a) for a in range(6)], dups=[], order=None,
             knobs=k),                                   # undeliverable
        dict(n=3, drops=[(0, 0)], dups=[], order=None,
             knobs=dict(k, window=1)),
    ]


def _grid_cases():
    """Seeded drops (contiguous failed attempts within the cap), dups and
    orders over the protocol knobs."""
    rng = np.random.RandomState(7)
    cases = []
    for n, window, ack, max_rt, base, cap in itertools.product(
            (1, 2, 5, 9), (1, 2, 4), (1, 3), (1, 4), (0, 1), (2, 8)):
        drops = []
        for seq in range(n):
            drops += [(seq, a) for a in range(rng.randint(0, max_rt + 1))]
        dups = sorted(int(s) for s in np.flatnonzero(rng.rand(n) < 0.3))
        order = [int(v) for v in rng.permutation(n)]
        cases.append(dict(n=n, drops=drops, dups=dups, order=order,
                          knobs=dict(window=window, ack_timeout=ack,
                                     max_retransmits=max_rt,
                                     backoff_base=base,
                                     backoff_cap=max(cap, base))))
    return cases


PLAN_CASES = _hand_cases() + _grid_cases()
OUTCOME_CASES = [
    (seed, msg, rates, n, mr)
    for i, (seed, msg) in enumerate(itertools.product((0, 3, 17, 1234, 99),
                                                      range(10)))
    for rates, n, mr in [(
        [dict(drop=0.3, dup=0.1, reorder=0.2), dict(drop=0.9),
         dict(dup=0.5), dict(reorder=0.6),
         dict(drop=0.05, dup=0.02, reorder=0.1)][i % 5],
        (1, 4, 6, 11)[i % 4], (1, 3, 4)[i % 3])]]

# ---- the parity matrix: the JAX package's test_reliable_parity_matrix ----
MATRIX_PATHS = ("chunked", "buffered", "pipelined")
MATRIX_SCHEDS = ("fused", "overlapped")
MATRIX_FAULTS = ("clean", "drop", "reorder", "dup", "combined")
MATRIX = list(itertools.product(MATRIX_PATHS, MATRIX_SCHEDS, MATRIX_FAULTS))
MATRIX_N = 8 * 128


def matrix_faults(name):
    return {
        "clean": None,
        "drop": reliable.WireFaults(seed=1, drop_events=frozenset(
            {(0, 0, 0), (0, 2, 0), (0, 2, 1)})),
        "reorder": reliable.WireFaults(seed=1, reorder=0.9),
        "dup": reliable.WireFaults(seed=1, dup_events=frozenset(
            {(0, 0), (0, 3)})),
        "combined": reliable.WireFaults(seed=1, drop=0.25, dup=0.2,
                                        reorder=0.3,
                                        drop_events=frozenset({(0, 0, 0)}),
                                        dup_events=frozenset({(0, 0)})),
    }[name]


def matrix_configs(sched):
    s = Scheduling(sched)
    base = CommConfig(mode=CommMode.STREAMING, scheduling=s,
                      transport=Transport.UNORDERED, window=2,
                      chunk_bytes=512)
    guaranteed = CommConfig(mode=CommMode.STREAMING, scheduling=s,
                            transport=Transport.UNORDERED, window=2,
                            chunk_bytes=512,
                            reliability=Reliability.GUARANTEED,
                            ack_timeout=1, max_retransmits=4,
                            backoff_base=1, backoff_cap=2)
    return base, guaranteed


def matrix_run(path, cfg, x):
    """One message along the 4-rank ring through ``path`` (the JAX
    package's matrix bodies, stacked; the pipelined consumer folds each
    chunk's first element, so the fold order shows in the float sum and
    both packages do the same f32 additions)."""
    perm = [(i, (i + 1) % 4) for i in range(4)]
    if path == "chunked":
        return streaming.chunked_permute(x, perm, cfg)
    if path == "buffered":
        return streaming.buffered_permute(x, perm, cfg)
    carry, msg = streaming.pipelined_consume(
        x, perm, cfg, consume=lambda c, i, m: c + m[:, 0],
        init=x.new_zeros(x.shape[0]))
    return msg + carry[:, None]


# ---- SWE under faults: (elements, scheduling, fault rates) ----
SWE_FAULTS = {"drop": dict(seed=3, drop=0.3),
              "mixed": dict(seed=5, drop=0.2, dup=0.2, reorder=0.3)}
SWE_CASES = [(300, s, "drop") for s in ("fused", "overlapped", "host")] + [
    (16000, s, "mixed") for s in ("fused", "overlapped", "host")]
SWE_STEPS = 2      # per runner call; two calls of build A, one of build B


JAX_CODE = """
import itertools, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core import reliable, streaming
from repro.core.config import (CommConfig, CommMode, Reliability,
                               Scheduling, Transport)
from repro.swe import driver

spec = json.loads(SPEC)
out = {}

def plan_json(p):
    if p is None:
        return None
    return [p.n_chunks, [[s.seq, s.action, s.attempt] for s in p.slots],
            p.retransmits, p.dup_dropped, p.timeouts, p.backoff_holds]

plans = []
for c in spec["plans"]:
    try:
        plans.append(plan_json(reliable.simulate_delivery(
            c["n"], drops=frozenset(tuple(d) for d in c["drops"]),
            dups=frozenset(c["dups"]), order=c["order"], **c["knobs"])))
    except ValueError as e:
        plans.append(["ValueError", str(e)])
outcomes = []
for seed, msg, rates, n, mr in spec["outcomes"]:
    d, u, o = reliable.WireFaults(seed=seed, **rates).outcomes(msg, n, mr)
    outcomes.append([sorted(list(v) for v in d), sorted(u), list(o)])
meta = {"plans": plans, "outcomes": outcomes, "matrix": {}, "swe": {}}

FAULTS = {
    "clean": None,
    "drop": reliable.WireFaults(seed=1, drop_events=frozenset(
        {(0, 0, 0), (0, 2, 0), (0, 2, 1)})),
    "reorder": reliable.WireFaults(seed=1, reorder=0.9),
    "dup": reliable.WireFaults(seed=1, dup_events=frozenset(
        {(0, 0), (0, 3)})),
    "combined": reliable.WireFaults(seed=1, drop=0.25, dup=0.2,
                                    reorder=0.3,
                                    drop_events=frozenset({(0, 0, 0)}),
                                    dup_events=frozenset({(0, 0)})),
}
mesh4 = Mesh(np.array(jax.devices()[:4]), ("x",))
perm = [(i, (i + 1) % 4) for i in range(4)]
N = spec["matrix_n"]
x = jnp.arange(4 * N, dtype=jnp.float32).reshape(4, N) * 0.37 + 1.0

def run(path, cfg):
    if path == "chunked":
        body = lambda v: streaming.chunked_permute(v[0], perm, "x", cfg)[None]
    elif path == "buffered":
        body = lambda v: streaming.buffered_permute(v[0], perm, "x",
                                                    cfg)[None]
    else:
        def body(v):
            carry, msg = streaming.pipelined_consume(
                v[0], perm, "x", cfg,
                consume=lambda c, i, m: c + m[0],
                init=jnp.float32(0.0))
            return (msg + carry)[None]
    f = jax.jit(compat.shard_map(body, mesh=mesh4, in_specs=P("x"),
                                 out_specs=P("x"), check_vma=False))
    return np.asarray(f(x))

for path, sched, fname in spec["matrix"]:
    s = Scheduling(sched)
    cfg = CommConfig(mode=CommMode.STREAMING, scheduling=s,
                     transport=Transport.UNORDERED, window=2,
                     chunk_bytes=512, reliability=Reliability.GUARANTEED,
                     ack_timeout=1, max_retransmits=4, backoff_base=1,
                     backoff_cap=2)
    before = reliable.wire_counters()
    with reliable.inject(FAULTS[fname]):
        got = run(path, cfg)
    after = reliable.wire_counters()
    key = f"{path}/{sched}/{fname}"
    out["m/" + key] = got
    meta["matrix"][key] = {k: after[k] - before[k] for k in after}

# SWE: record every plan_for answer (the plans each build draws)
drawn = []
_plan_for = reliable.plan_for
def recording_plan_for(cfg, n):
    p = _plan_for(cfg, n)
    drawn.append([n, plan_json(p)])
    return p
reliable.plan_for = recording_plan_for
mesh8 = Mesh(np.array(jax.devices()[:8]), ("data",))
for elements, sched, fname in spec["swe"]:
    cfg = CommConfig(chunk_bytes=512, scheduling=Scheduling(sched),
                     reliability=Reliability.GUARANTEED)
    sim = driver.build_simulation(elements, mesh8, cfg)
    steps, dt = spec["swe_steps"], sim.swe.dt
    key = f"{elements}/{sched}/{fname}"
    ids, builds = [], []
    before = reliable.wire_counters()
    with reliable.inject(reliable.WireFaults(**spec["swe_faults"][fname])):
        if sched == "host":
            a = driver.make_host_scheduled_runner(sim)
            del drawn[:]
            s1, t = a.run(sim.state, 0.0, steps)
            ids.append(reliable._MSG_COUNTER)
            s2, t = a.run(s1, t, steps)
            ids.append(reliable._MSG_COUNTER)
            builds.append(list(drawn))
            b = driver.make_host_scheduled_runner(sim)
            del drawn[:]
            s3, t = b.run(s2, t, steps)
            ids.append(reliable._MSG_COUNTER)
        else:
            a = driver.make_sim_runner(sim, steps)
            del drawn[:]
            s1 = a(sim.state, 0.0)
            ids.append(reliable._MSG_COUNTER)
            s2 = a(s1, steps * dt)
            ids.append(reliable._MSG_COUNTER)
            builds.append(list(drawn))
            b = driver.make_sim_runner(sim, steps)
            del drawn[:]
            s3 = b(s2, 2 * steps * dt)
            ids.append(reliable._MSG_COUNTER)
        builds.append(list(drawn))
    after = reliable.wire_counters()
    meta["swe"][key] = {"ids": ids, "builds": builds,
                        "wire": {k: after[k] - before[k] for k in after}}
    for i, st in enumerate((s1, s2, s3)):
        out[f"swe/{key}/{i}"] = np.asarray(st)
np.savez(spec["out"], **out)
with open(spec["meta"], "w") as f:
    json.dump(meta, f)
print("JAX REF OK", len(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("reliable_ref")
    spec = {"out": str(d / "ref.npz"), "meta": str(d / "meta.json"),
            "plans": PLAN_CASES, "outcomes": OUTCOME_CASES,
            "matrix": MATRIX, "matrix_n": MATRIX_N,
            "swe": SWE_CASES, "swe_faults": SWE_FAULTS,
            "swe_steps": SWE_STEPS}
    out = run_multidevice(f"SPEC = {json.dumps(json.dumps(spec))}\n"
                          + JAX_CODE, n_devices=8)
    assert "JAX REF OK" in out
    return dict(np.load(d / "ref.npz")), json.loads((d / "meta.json")
                                                    .read_text())


def plan_json(p):
    if p is None:
        return None
    return [p.n_chunks, [[s.seq, s.action, s.attempt] for s in p.slots],
            p.retransmits, p.dup_dropped, p.timeouts, p.backoff_holds]


# ----------------------------------------------------------------------
# Protocol: plans and fault outcomes equal the JAX package's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("group", range(4))
def test_delivery_plans_match_reference(ref, group):
    want = ref[1]["plans"]
    for i in range(group, len(PLAN_CASES), 4):
        c = PLAN_CASES[i]
        try:
            got = plan_json(reliable.simulate_delivery(
                c["n"], drops=frozenset(tuple(d) for d in c["drops"]),
                dups=frozenset(c["dups"]), order=c["order"], **c["knobs"]))
        except ValueError as e:
            got = ["ValueError", str(e)]
        assert got == want[i], c


def test_hand_cases_keep_their_properties():
    """The JAX package's hand-case assertions, on the port."""
    plan = reliable.simulate_delivery(4, drops=[(1, 0)], **KNOBS)
    assert plan.retransmits == plan.timeouts == 1
    assert plan.backoff_holds >= 1 and plan.extra_slots > 0
    assert sorted(plan.delivered_seqs()) == list(range(4))
    plan = reliable.simulate_delivery(5, order=(4, 3, 2, 1, 0), **KNOBS)
    assert plan.delivered_seqs() == [4, 3, 2, 1, 0]
    with pytest.raises(ValueError, match="undeliverable"):
        reliable.simulate_delivery(2, drops=[(0, a) for a in range(6)],
                                   **KNOBS)
    with pytest.raises(ValueError):
        reliable.simulate_delivery(3, order=(0, 0, 2), **KNOBS)
    with pytest.raises(ValueError):
        reliable.backoff_holds(0, 1, 4)
    with pytest.raises(ValueError, match="rate"):
        reliable.WireFaults(drop=1.0)


def test_wire_fault_outcomes_match_reference(ref):
    want = ref[1]["outcomes"]
    assert len(OUTCOME_CASES) == 50
    for (seed, msg, rates, n, mr), w in zip(OUTCOME_CASES, want):
        d, u, o = reliable.WireFaults(seed=seed, **rates).outcomes(msg, n, mr)
        assert [sorted(list(v) for v in d), sorted(u), list(o)] == w


def test_plan_for_fast_path_and_best_effort_guard():
    cfg = CommConfig(reliability=Reliability.GUARANTEED)
    assert reliable.plan_for(cfg, 4) is None          # no faults injected
    faults = reliable.WireFaults(seed=0, drop_events=frozenset({(0, 0, 0)}))
    with reliable.inject(faults):
        plan = reliable.plan_for(cfg, 4)
        assert plan is not None and plan.retransmits == 1
    with reliable.inject(faults):
        with pytest.raises(ValueError, match="BEST_EFFORT"):
            reliable.plan_for(CommConfig(), 4)
    assert reliable.active() is None                  # context restored


def test_property_delivery_identity_under_faults():
    require_hypothesis()
    from hypothesis import given, settings, strategies as st

    @st.composite
    def fault_case(draw):
        n = draw(st.integers(1, 12))
        max_rt = draw(st.integers(1, 4))
        drops = set()
        for seq in range(n):
            k = draw(st.integers(0, max_rt))
            drops.update((seq, a) for a in range(k))
        dups = draw(st.sets(st.integers(0, n - 1), max_size=n))
        order = draw(st.permutations(list(range(n))))
        window = draw(st.integers(1, 8))
        return n, max_rt, drops, dups, tuple(order), window

    @given(fault_case())
    @settings(max_examples=120, deadline=None)
    def check(case):
        n, max_rt, drops, dups, order, window = case
        plan = reliable.simulate_delivery(
            n, window=window, ack_timeout=2, max_retransmits=max_rt,
            backoff_base=1, backoff_cap=4, drops=frozenset(drops),
            dups=frozenset(dups), order=order)
        delivered = plan.delivered_seqs()
        assert sorted(delivered) == list(range(n))    # exactly once
        assert plan.retransmits == sum(
            1 for s in plan.slots if s.attempt > 0
            and s.action in (reliable.DELIVER, reliable.LOST))
        assert plan.extra_slots == len(plan.slots) - n

    check()


def test_property_backoff_monotone_capped():
    require_hypothesis()
    from hypothesis import given, settings, strategies as st

    @given(st.integers(1, 16), st.integers(0, 8), st.integers(0, 64))
    @settings(max_examples=200, deadline=None)
    def check(attempt, base, cap):
        cap = max(cap, base)
        h = reliable.backoff_holds(attempt, base, cap)
        assert 0 <= h <= cap
        if attempt > 1:
            assert h >= reliable.backoff_holds(attempt - 1, base, cap)

    check()


# ----------------------------------------------------------------------
# The 30-cell parity matrix
# ----------------------------------------------------------------------

@pytest.mark.parametrize("path,sched,fname", MATRIX)
def test_parity_matrix_matches_reference(ref, path, sched, fname):
    arrays, meta = ref
    x = (torch.arange(4 * MATRIX_N, dtype=torch.float32)
         .reshape(4, MATRIX_N) * 0.37 + 1.0)
    base, cfg = matrix_configs(sched)
    want_clean = matrix_run(path, base, x)
    before = reliable.wire_counters()
    with reliable.inject(matrix_faults(fname)):
        got = matrix_run(path, cfg, x)
    after = reliable.wire_counters()
    delta = {k: after[k] - before[k] for k in after}
    key = f"{path}/{sched}/{fname}"
    assert torch.equal(got, want_clean), key
    assert np.array_equal(got.numpy(), arrays["m/" + key]), key
    assert delta == meta["matrix"][key], key
    # the witnesses: recovery fired where a fault hit, silent when clean
    if fname == "clean":
        assert not any(delta.values())
    elif fname in ("drop", "combined"):
        assert delta["retransmits"] > 0
    elif fname == "dup":
        assert delta["dup_dropped"] > 0


# ----------------------------------------------------------------------
# The SWE step under GUARANTEED + faults
# ----------------------------------------------------------------------

def _swe_run(sim, sched, steps):
    """Build A runs twice, build B once, as the JAX side does: returns the
    three states, message ids after each call, and each build's tape."""
    dt = sim.swe.dt
    ids = []
    if sched == "host":
        a = driver.make_host_scheduled_runner(sim)
        s1, t = a.run(sim.state, 0.0, steps)
        ids.append(reliable.message_count())
        s2, t = a.run(s1, t, steps)
        ids.append(reliable.message_count())
        b = driver.make_host_scheduled_runner(sim)
        s3, t = b.run(s2, t, steps)
    else:
        a = driver.make_sim_runner(sim, steps)
        s1 = a(sim.state, 0.0)
        ids.append(reliable.message_count())
        s2 = a(s1, steps * dt)
        ids.append(reliable.message_count())
        b = driver.make_sim_runner(sim, steps)
        s3 = b(s2, 2 * steps * dt)
    ids.append(reliable.message_count())
    return (s1, s2, s3), ids, (a.tape, b.tape)


@pytest.mark.parametrize("elements,sched,fname", SWE_CASES)
def test_swe_under_faults_matches_reference(ref, elements, sched, fname):
    arrays, meta = ref
    want = meta["swe"][f"{elements}/{sched}/{fname}"]
    cfg = CommConfig(chunk_bytes=512, scheduling=Scheduling(sched),
                     reliability=Reliability.GUARANTEED)
    sim = driver.build_simulation(elements, 8, cfg, device="cpu")
    clean, _, _ = _swe_run(sim, sched, SWE_STEPS)
    before = reliable.wire_counters()
    with reliable.inject(reliable.WireFaults(**SWE_FAULTS[fname])):
        states, ids, tapes = _swe_run(sim, sched, SWE_STEPS)
    after = reliable.wire_counters()
    # one build draws as many ids, and the same plans, as one JAX trace
    assert ids == want["ids"]
    for tape, build in zip(tapes, want["builds"]):
        assert [[n, plan_json(p)] for n, p in tape.entries] == build
    assert {k: after[k] - before[k] for k in after} == want["wire"]
    assert any(p is not None for p in tapes[0].plans)
    if elements == 300 and sched == "fused":
        assert ids[0] == 5 == sim.pm.n_rounds   # one id per exchange round
    for i, (got, lossless) in enumerate(zip(states, clean)):
        assert torch.equal(got, lossless), i       # recovery is exact
        np.testing.assert_allclose(
            got.numpy(), arrays[f"swe/{elements}/{sched}/{fname}/{i}"],
            rtol=0, atol=ATOL)


def _count_wire(monkeypatch):
    calls = {"permute": 0, "encode": 0}
    permute, encode = streaming._permute, streaming.plugins.wire_encode

    def counted_permute(*a, **k):
        calls["permute"] += 1
        return permute(*a, **k)

    def counted_encode(*a, **k):
        calls["encode"] += 1
        return encode(*a, **k)

    monkeypatch.setattr(streaming, "_permute", counted_permute)
    monkeypatch.setattr(streaming.plugins, "wire_encode", counted_encode)
    return calls


@pytest.mark.parametrize("sched", ["fused", "overlapped", "host"])
def test_guaranteed_on_a_clean_wire_runs_the_best_effort_program(
        monkeypatch, sched):
    """GUARANTEED with no fault context, and under a lossy context whose
    messages all come out clean, issues exactly the BEST_EFFORT permutes
    and encodes and gives a bitwise-equal state; BEST_EFFORT under faults
    raises the JAX package's ValueError."""
    calls = _count_wire(monkeypatch)
    results = {}
    late = reliable.WireFaults(drop_events=frozenset({(999, 0, 0)}))
    for label, rel, faults in (("best_effort", Reliability.BEST_EFFORT, None),
                               ("guaranteed", Reliability.GUARANTEED, None),
                               ("clean_messages", Reliability.GUARANTEED,
                                late)):
        cfg = CommConfig(chunk_bytes=512, scheduling=Scheduling(sched),
                         reliability=rel)
        sim = driver.build_simulation(300, 8, cfg, device="cpu")
        calls.update(permute=0, encode=0)
        with reliable.inject(faults):
            states, _, tapes = _swe_run(sim, sched, 2)
        assert not tapes[0].plans
        results[label] = (states[-1], dict(calls))
    ref_state, ref_calls = results["best_effort"]
    assert ref_calls["permute"] > 0
    for label, (state, got_calls) in results.items():
        assert torch.equal(state, ref_state), label
        assert got_calls == ref_calls, label
    cfg = CommConfig(chunk_bytes=512, scheduling=Scheduling(sched))
    sim = driver.build_simulation(300, 8, cfg, device="cpu")
    with reliable.inject(reliable.WireFaults(seed=3, drop=0.3)):
        with pytest.raises(ValueError, match="BEST_EFFORT"):
            _swe_run(sim, sched, 2)


def test_recovery_rounds_are_real_permutes(monkeypatch):
    """Every slot of a drawn plan runs one permute: the faulted fused step
    issues the clean count plus the plans' extra slots per step."""
    calls = _count_wire(monkeypatch)
    cfg = CommConfig(chunk_bytes=512, reliability=Reliability.GUARANTEED)
    sim = driver.build_simulation(16000, 8, cfg, device="cpu")
    run = driver.make_sim_runner(sim, 4)
    run(sim.state, 0.0)
    clean = calls["permute"]
    with reliable.inject(reliable.WireFaults(**SWE_FAULTS["mixed"])):
        run = driver.make_sim_runner(sim, 4)
        calls["permute"] = 0
        run(sim.state, 0.0)
    assert run.tape.extra_slots > 0
    assert calls["permute"] == clean + 4 * run.tape.extra_slots


def test_trace_report_reads_the_wire_slots(tmp_path, capsys):
    """A faulted message's ``wire.slot`` spans, exported as a Chrome trace,
    come back from ``python -m repro_torch.obs.report`` by action."""
    from repro_torch.obs import report, trace as obs_trace
    path = tmp_path / "trace.json"
    obs_trace.configure(f"chrome:{path}")
    try:
        base, cfg = matrix_configs("fused")
        x = torch.arange(4 * MATRIX_N, dtype=torch.float32).reshape(4, -1)
        with reliable.inject(matrix_faults("combined")):
            matrix_run("chunked", cfg, x)
        obs_trace.flush()
    finally:
        obs_trace.configure("0")
    agg = report.summarize(report.load_trace(str(path)))
    slots = agg["wire_slots"]
    assert {"deliver", "lost", "dup", "hold"} <= set(slots)
    assert slots["deliver"]["count"] == 8    # 4 KiB in 512 B chunks
    assert report.main([str(path)]) == 0
    assert "reliable-wire slots by action" in capsys.readouterr().out
