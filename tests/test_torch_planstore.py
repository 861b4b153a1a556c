"""The port's disk plan store against the JAX package's, on the CPU: the
twins of ``tests/test_planstore.py`` (canonical keys, memory-only keys,
each kind's round trip, corrupt, stale and mismatched entries as counted
misses, ``REPRO_PLAN_DIR``/``configure``, inert without a directory, two
concurrent writer processes); one on-disk format for both packages (the
same key gives the same canonical JSON and entry file name, and an entry
written by either package reads back in the other to the same value); the
twin of ``tests/test_plans.py::test_disk_store_cross_process_warm_start_
bitwise`` (a fresh process on a populated store replays plans from disk,
and a sendrecv plus a ring all-reduce are bitwise equal warm, cold and
with the cache bypassed); and the sweep's program memo and cross-process
warm check.

The JAX package's store runs in this process on plain keys (no mesh, no
device); the port's fresh-process runs need no JAX.  Tolerances: none —
every comparison is exact.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from helpers import REPO

from repro.core import planstore as jax_planstore
from repro.core import plans as jax_plans
from repro.core import reliable as jax_reliable

from repro_torch.core import planstore, plans, reliable
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import CommConfig, Reliability, Transport
from repro_torch.tune import sweep


@pytest.fixture
def disk_store(tmp_path, monkeypatch):
    """The plan cache with the store on a fresh directory, fully undone."""
    monkeypatch.delenv(planstore.ENV_VAR, raising=False)
    planstore.configure(str(tmp_path))
    plans.clear_cache()
    plans.reset_stats()
    yield planstore.active()
    planstore.configure(None)
    plans.clear_cache()
    plans.reset_stats()


def _single_entry(tmp_path):
    return next((tmp_path / "plans").glob("*.json"))


# ----------------------------------------------------------------------
# Keys
# ----------------------------------------------------------------------

def test_cfg_key_is_stable_json_primitives():
    key = plans._cfg_key(CommConfig())
    assert key[0] == plans.CFG_KEY_SCHEMA == jax_plans.CFG_KEY_SCHEMA
    for name, value in key[1:]:
        assert isinstance(name, str)
        assert value is None or isinstance(value, (bool, int, float, str))
    assert plans._cfg_key(CommConfig()) == key
    canon = planstore.canonical_key(key)
    json.loads(canon)
    assert plans._cfg_key(CommConfig(transport=Transport.ORDERED)) != key
    assert plans._cfg_key(None) == ()


def test_canonical_key_rejects_non_primitives():
    class Weird:
        pass

    with pytest.raises(TypeError):
        planstore.canonical_key(("a", Weird()))
    with pytest.raises(TypeError):
        planstore.canonical_key(("a", torch.float32))
    a = planstore.canonical_key((1, ("x", 2.5), None, True))
    b = planstore.canonical_key((1, ("x", 2.5), True, None))
    assert a != b


def test_non_serializable_keys_stay_memory_only(tmp_path):
    """put never raises: a non-canonical key (a torch dtype, a device) or
    an unencodable value returns False and writes nothing."""
    store = planstore.PlanStore(tmp_path)
    for key in (("a", torch.float32), ("a", torch.device("cpu"))):
        assert store.put("ring", key, (1, 2)) is False
        assert store.get("ring", key) is planstore.MISSING
    assert store.put("plan", ("k",), object()) is False
    assert store.entry_count() == 0


@pytest.mark.parametrize("kind,key", [
    ("ring", (8, 1)),
    ("chunks", (130, "torch.float32", 512, 64, True, 2, 1, False)),
    ("plan", ("sendrecv", (("x",), (8,), None),
              plans._cfg_key(CommConfig()), (130,), "torch.float32", 1,
              (((0, 1), (1, 0)),))),
    ("wire", (3, 4, 2, 8, 1, 8, ((1, 0),), (), (0, 1, 2)))])
def test_keys_and_file_names_match_the_jax_package(tmp_path, kind, key):
    """One key gives byte-equal canonical JSON and the same entry file in
    both packages' stores, whatever the key's value."""
    assert planstore.canonical_key(key) == jax_planstore.canonical_key(key)
    canon = planstore.canonical_key(key)
    assert (planstore.PlanStore(tmp_path)._entry_path(kind, canon).name
            == jax_planstore.PlanStore(tmp_path)._entry_path(kind,
                                                            canon).name)
    assert planstore.SCHEMA_VERSION == jax_planstore.SCHEMA_VERSION
    assert planstore.DISK_KINDS == jax_planstore.DISK_KINDS
    assert planstore.ENV_VAR == jax_planstore.ENV_VAR


# ----------------------------------------------------------------------
# Round trips, and one format for both packages
# ----------------------------------------------------------------------

def _values():
    """A value of every kind, in each package's own types."""
    ring = tuple((i, (i + 1) % 8) for i in range(8))
    rounds = (((0, 1), (2, 3)), ((1, 2),))
    ack = (-1, -1, 0, 1)
    drops = frozenset({(1, 0)})
    port_wire = reliable.simulate_delivery(
        4, window=2, ack_timeout=2, max_retransmits=8, backoff_base=1,
        backoff_cap=8, drops=drops)
    jax_wire = jax_reliable.simulate_delivery(
        4, window=2, ack_timeout=2, max_retransmits=8, backoff_base=1,
        backoff_cap=8, drops=drops)
    return {
        "ring": (ring, ring), "rounds": (rounds, rounds),
        "perm": (((0, 1), (1, 0)), ((0, 1), (1, 0))),
        "chunks": (plans.ChunkPlan(4, 33, ack),
                   jax_plans.ChunkPlan(4, 33, ack)),
        "wire": (port_wire, jax_wire)}


@pytest.mark.parametrize("kind", ["ring", "rounds", "perm", "chunks",
                                  "wire"])
def test_each_kind_round_trips_and_crosses_packages(tmp_path, kind):
    """Each kind comes back as the value the in-memory cache stores; an
    entry the port writes reads back in the JAX package's store as that
    package's equal value, and the other way round, byte for byte."""
    port_value, jax_value = _values()[kind]
    key = ("t", kind, 8)
    planstore.reset_disk_stats()
    store = planstore.PlanStore(tmp_path / "port")
    assert store.get(kind, key) is planstore.MISSING
    assert store.put(kind, key, port_value)
    got = store.get(kind, key)
    assert got == port_value and type(got) is type(port_value)
    assert planstore.disk_stats() == {"disk_hits": 1, "disk_misses": 1,
                                      "disk_writes": 1, "disk_corrupt": 0}
    assert jax_planstore.PlanStore(tmp_path / "port").get(
        kind, key) == jax_value
    jstore = jax_planstore.PlanStore(tmp_path / "jax")
    assert jstore.put(kind, key, jax_value)
    assert planstore.PlanStore(tmp_path / "jax").get(kind, key) == port_value
    assert (_single_entry(tmp_path / "port").read_bytes()
            == _single_entry(tmp_path / "jax").read_bytes())


def test_comm_plan_reads_in_both_packages(tmp_path):
    """The port's aggregate plan keeps the JAX package's fields: its rounds
    as ``perms`` (and ``rounds``), no ring and no extras."""
    comm = Communicator(("x",), (8,))
    cfg = CommConfig(chunk_bytes=512)
    perm = tuple(comm.ring_perm())
    key = ("sendrecv", plans._comm_key(comm), plans._cfg_key(cfg), (130,),
           "torch.float32", 1, (perm,))
    value = plans.CommPlan(collective="sendrecv", comm_key=key[1],
                           cfg_key=key[2], shape=(130,),
                           dtype="torch.float32",
                           chunks=plans.ChunkPlan(2, 65, (-1, -1)),
                           perms=(perm,))
    store = planstore.PlanStore(tmp_path)
    assert store.put("plan", key, value)
    assert store.get("plan", key) == value
    ref = jax_planstore.PlanStore(tmp_path).get("plan", key)
    assert ref is not jax_planstore.MISSING
    assert (ref.perms, ref.rounds, ref.ring, ref.extra) == ((perm,),
                                                            (perm,), (), ())
    assert ref.chunks == jax_plans.ChunkPlan(2, 65, (-1, -1))


def test_plans_persist_through_the_memo(disk_store):
    """The real path: the plan builders persist on a miss; a cleared
    in-memory cache rebuilds the identical value from disk, the disk hit
    counting as a plan hit."""
    cfg = CommConfig(chunk_bytes=2048, transport=Transport.ORDERED, window=2)
    comm = Communicator(("x",), (8,))
    rounds = [comm.ring_perm()]

    def build():
        return (plans.chunk_plan((1024,), torch.float32, cfg),
                plans.get_plan("sendrecv", comm, cfg, (1024,),
                               torch.float32, rounds),
                reliable.delivery_plan(3, dataclasses.replace(
                    cfg, reliability=Reliability.GUARANTEED),
                    frozenset({(1, 0)}), frozenset(), (0, 1, 2)),
                plans.ring_perm(8, 2))

    first = build()
    st = plans.cache_stats()
    assert st["disk_writes"] >= 4 and st["disk_hits"] == 0
    plans.clear_cache()
    hits = st["plan_hits"]
    second = build()
    st = plans.cache_stats()
    assert second == first
    assert all(a is not b for a, b in zip(first, second))
    assert st["disk_hits"] >= 4 and st["plan_hits"] > hits
    assert st["disk_corrupt"] == 0


# ----------------------------------------------------------------------
# Corrupt, stale and mismatched entries: a counted miss, never a crash
# ----------------------------------------------------------------------

def _tamper_truncate(path):
    path.write_text(path.read_text()[:11])


def _tamper_schema(path):
    entry = json.loads(path.read_text())
    entry["schema"] = planstore.SCHEMA_VERSION + 1
    path.write_text(json.dumps(entry))


def _tamper_key(path):
    entry = json.loads(path.read_text())
    entry["key"] = ["k", 2]
    path.write_text(json.dumps(entry))


def _tamper_value(path):
    entry = json.loads(path.read_text())
    entry["value"] = {"n_chunks": "four"}
    path.write_text(json.dumps(entry))


@pytest.mark.parametrize("tamper", [_tamper_truncate, _tamper_schema,
                                    _tamper_key, _tamper_value],
                         ids=["truncated", "stale_schema", "key_mismatch",
                              "undecodable"])
def test_bad_entry_is_a_counted_miss_and_is_rebuilt(tmp_path, tamper):
    planstore.reset_disk_stats()
    store = planstore.PlanStore(tmp_path)
    key, value = ("k", 1), plans.ChunkPlan(2, 8, (-1, 0))
    assert store.put("chunks", key, value)
    path = _single_entry(tmp_path)
    tamper(path)
    assert store.get("chunks", key) is planstore.MISSING
    st = planstore.disk_stats()
    assert st["disk_corrupt"] == 1 and st["disk_misses"] == 1
    assert not path.exists()
    assert store.put("chunks", key, value)
    assert store.get("chunks", key) == value


# ----------------------------------------------------------------------
# Activation
# ----------------------------------------------------------------------

def test_env_and_configure_control(tmp_path, monkeypatch):
    monkeypatch.delenv(planstore.ENV_VAR, raising=False)
    planstore.configure(None)
    assert planstore.active() is None
    monkeypatch.setenv(planstore.ENV_VAR, str(tmp_path / "via-env"))
    st = planstore.active()
    assert st is not None and st.root == tmp_path / "via-env"
    assert planstore.configure("") is None          # disabled despite env
    assert planstore.active() is None
    assert planstore.configure(tmp_path / "explicit") == tmp_path / "explicit"
    planstore.configure(None)                       # back to the env
    assert planstore.active().root == tmp_path / "via-env"
    monkeypatch.delenv(planstore.ENV_VAR)
    assert planstore.active() is None


def test_inert_without_directory(monkeypatch):
    monkeypatch.delenv(planstore.ENV_VAR, raising=False)
    planstore.configure(None)
    plans.clear_cache()
    plans.reset_stats()
    plans.chunk_plan((64,), torch.float32, CommConfig())
    st = plans.cache_stats()
    assert (st["disk_hits"], st["disk_misses"], st["disk_writes"]) == \
        (0, 0, 0)
    assert st["plan_misses"] == 1


def test_two_process_concurrent_writes_leave_valid_store(tmp_path):
    """Two processes writing the same keys both exit cleanly and leave
    every entry readable and no temp file behind."""
    code = """
import sys
from repro_torch.core import planstore
store = planstore.PlanStore(sys.argv[1])
ring = tuple((j, (j + 1) % 8) for j in range(8))
for rep in range(3):
    for i in range(20):
        assert store.put("ring", ("race", i), ring)
        got = store.get("ring", ("race", i))
        assert got is planstore.MISSING or got == ring
print("WRITER OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"writer failed\n{out}\n{err}"
        assert "WRITER OK" in out
    store = planstore.PlanStore(tmp_path)
    ring = tuple((j, (j + 1) % 8) for j in range(8))
    for i in range(20):
        assert store.get("ring", ("race", i)) == ring
    assert not list((tmp_path / "plans").glob("*.tmp"))
    assert store.entry_count() == 20
    store.clear()
    assert store.entry_count() == 0


# ----------------------------------------------------------------------
# A fresh process warm-starts, bitwise
# ----------------------------------------------------------------------

_DISK_PARITY_CODE = """
import dataclasses, hashlib
import numpy as np, torch
from repro_torch.core import collectives, plans
from repro_torch.core.communicator import Communicator
from repro_torch.core.config import (CommConfig, CommMode, Scheduling,
                                     Transport)

plans.reset_stats()
comm = Communicator(("x",), (8,))
x = torch.from_numpy(np.random.RandomState(0).randn(8, 130).astype(
    np.float32))
cfg = CommConfig(mode=CommMode.STREAMING, scheduling=Scheduling.FUSED,
                 transport=Transport.ORDERED, chunk_bytes=512, window=2)
rcfg = dataclasses.replace(cfg, algorithm="ring")
outs = [collectives.sendrecv(x, comm.ring_perm(), comm, cfg),
        collectives.all_reduce(x, comm, rcfg)]
digest = hashlib.sha256(b"".join(o.numpy().tobytes()
                                 for o in outs)).hexdigest()
st = plans.cache_stats()
print("DIGEST", digest)
print("DISK", st["disk_hits"], st["disk_misses"], st["disk_writes"])
"""


def _parity_run(env):
    proc = subprocess.run([sys.executable, "-c", _DISK_PARITY_CODE],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(l.split(" ", 1) for l in proc.stdout.splitlines()
                 if l.startswith(("DIGEST", "DISK")))
    hits, misses, writes = (int(v) for v in lines["DISK"].split())
    return lines["DIGEST"], hits, misses, writes


def test_disk_store_cross_process_warm_start_bitwise(tmp_path):
    """A fresh process pointed at a populated REPRO_PLAN_DIR replays every
    plan from disk and gives bit-identical collective results — equal to a
    run with the cache bypassed entirely."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env[planstore.ENV_VAR] = str(tmp_path / "store")
    cold, cold_hits, cold_misses, cold_writes = _parity_run(env)
    assert cold_hits == 0 and cold_writes > 0 and cold_misses == cold_writes
    warm, warm_hits, warm_misses, warm_writes = _parity_run(env)
    assert warm_hits == cold_writes and warm_misses == warm_writes == 0
    assert warm == cold
    env["REPRO_PLAN_CACHE"] = "0"
    bypass, bypass_hits, _, bypass_writes = _parity_run(env)
    assert bypass_hits == 0 and bypass_writes == 0
    assert bypass == cold


# ----------------------------------------------------------------------
# The sweep's program memo and warm checks
# ----------------------------------------------------------------------

def _model_timer(op, n, msg_bytes, cfg, per_dev_shape=None, **_):
    return 1e-6 * (1 + msg_bytes / 1e6) * (2 if cfg.mode.value ==
                                           "buffered" else 1)


def test_warm_sweep_replays_every_program(monkeypatch):
    """A warm run_sweep in one process answers every candidate from the
    program memo the cold run kept and builds no op twice; the same timer
    gives the same entries.  The warm run keeps nothing: a third run builds
    every op again."""
    built = []
    build_op, build_consumer_op = sweep._build_op, sweep._build_consumer_op

    def counting(*a, **kw):
        built.append(("op",) + a[:1])
        return build_op(*a, **kw)

    def counting_consumer(*a, **kw):
        built.append(("consumer",) + a[:1])
        return build_consumer_op(*a, **kw)

    monkeypatch.setattr(sweep, "_build_op", counting)
    monkeypatch.setattr(sweep, "_build_consumer_op", counting_consumer)
    plans.clear_cache()
    kw = dict(collectives=("sendrecv", "all_reduce", "multi_neighbor",
                           "hierarchical_all_reduce"), sizes=(1024, 1 << 16),
              fast=True, objective="e2e", timer=_model_timer, device="cpu")
    cold, warm = {}, {}
    db_cold = sweep.run_sweep(8, stats=cold, keep_programs=True, **kw)
    n_built = len(built)
    db_warm = sweep.run_sweep(8, stats=warm, **kw)
    assert len(built) == n_built > 0                # nothing built twice
    assert cold["program_hits"] == 0
    assert cold["program_misses"] == n_built
    assert warm["program_hits"] == n_built and warm["program_misses"] == 0
    assert [dataclasses.asdict(e) for e in db_warm.entries] == \
        [dataclasses.asdict(e) for e in db_cold.entries]
    assert "program hits" in sweep.sweep_summary(warm)
    third: dict = {}
    sweep.run_sweep(8, stats=third, **kw)
    assert third["program_hits"] == 0 and len(built) == 2 * n_built
    plans.clear_cache()


def test_bench_ops_leave_their_input_unwritten():
    """The captured programs on the card share one zero input per shape:
    no benchmark op may write the tensor it is given."""
    comm = Communicator(("x",), (8,))
    mesh = sweep._BenchMesh(("inner", "outer"), (4, 2))
    subcomms = (Communicator.from_mesh(mesh, "inner"),
                Communicator.from_mesh(mesh, "outer"))
    x = torch.randn(8, 256)
    for coll in sweep.SWEEPABLE:
        for cfg in sweep.tune_space.enumerate_configs(coll, fast=True):
            before = x.clone()
            sweep._build_op(coll, comm, cfg, subcomms=subcomms)(x)
            assert torch.equal(x, before), (coll, cfg)
    for coll, consumers in sweep.CONSUMERS.items():
        for consumer in consumers:
            op, shape = sweep._build_consumer_op(
                coll, comm, CommConfig(), 4096, consumer=consumer,
                device="cpu")
            h = torch.randn((8,) + tuple(shape))
            before = h.clone()
            op(h)
            assert torch.equal(h, before), (coll, consumer)


def test_sweep_cli_plan_dir_and_fresh_process_check(tmp_path, capsys,
                                                    monkeypatch):
    """``--plan-dir`` populates the store; the fresh-process half of
    ``--warm-check`` then reruns the sweep in a child that replays every
    plan from disk (hits > 0, no miss, nothing corrupt)."""
    monkeypatch.delenv(planstore.ENV_VAR, raising=False)
    plans.clear_cache()
    argv = ["--device", "cpu", "--fast", "--collectives",
            "sendrecv,hierarchical_all_reduce", "--sizes", "1024",
            "--out", str(tmp_path / "db.json"), "--plan-dir",
            str(tmp_path / "plans")]
    try:
        assert sweep.main(argv) == 0
        assert planstore.active().entry_count() > 0
        assert sweep._cross_process_warm_check(argv, 1.0) == 0
    finally:
        os.environ.pop(planstore.ENV_VAR, None)
        plans.clear_cache()
    out = capsys.readouterr().out
    assert "plan store:" in out
    line = next(l for l in out.splitlines()
                if l.startswith("plan-store cross-process check"))
    assert "0 misses / 0 corrupt" in line
    # a store whose entries were all corrupted fails the child's check
    for p in (tmp_path / "plans" / "plans").glob("*.json"):
        p.write_text("{")
    monkeypatch.setenv(planstore.ENV_VAR, str(tmp_path / "plans"))
    assert sweep._cross_process_warm_check(argv, 1.0) == 5
