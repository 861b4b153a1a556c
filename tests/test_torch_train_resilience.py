"""The port's LM training under faults, on the CPU — the counterparts of the
JAX package's ``test_faults.py::test_preemption_drain_then_fresh_process_
resumes`` and ``::test_lm_rank_loss_elastic_reselect`` and of
``test_substrates.py::test_elastic_restore_reshards`` and
``::test_preemption_guard_drains_training``.

- A ``preempt@4`` drain saves params and Adam moments; a fresh process
  resumes, and the joined loss stream is bitwise equal to the
  uninterrupted run.
- ``rank_lost@3=r7`` on a ``(8, 1)`` mesh: the loop saves the last
  completed step and raises; ``elastic_restore`` re-forms on ``(4, 1)``
  with a CommConfig re-selected by the Eq. 1 model from a split TuneDB (a
  different config; no sweep), and two same-seed faulted runs give
  bitwise-equal loss streams.
- ``elastic_restore`` from ``(2, 4)`` to ``(2, 2)`` carries the params
  exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from helpers import REPO

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import latmodel
from repro_torch.core.config import H100, CommConfig, CommMode
from repro_torch.core.topology import TorusSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.faults import (FaultInjector, FaultSchedule,
                                        RankLostError)
from repro_torch.train import loop as loop_mod
from repro_torch.tune.db import TuneDB, TuneEntry
from repro_torch.tune.space import config_to_dict

CFG = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=torch.float32)


def _quiet(*_):
    pass


TRAIN_COMMON = """
import dataclasses, json, sys, torch
from repro_torch.configs import get_smoke_config
from repro_torch.core.config import CommConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as mesh_mod, setup
from repro_torch.optim import adamw
from repro_torch.train import loop as loop_mod

cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype=torch.float32)
oc = adamw.OptConfig(lr=1e-3, zero1=False)
data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)

def fresh_session():
    return setup.build_session(cfg, mesh_mod.make_test_mesh(1, 1),
                               CommConfig(), oc=oc, device="cpu")
"""


def _loop(n, ckpt_dir=None):
    return loop_mod.LoopConfig(n_steps=n, ckpt_every=100, ckpt_dir=ckpt_dir,
                               log_every=100)


def test_preemption_drain_then_fresh_process_resumes(tmp_path):
    """``preempt@4`` drains params + Adam moments at the step-4 boundary; a
    fresh process resumes there and the joined stream is bitwise equal to
    the uninterrupted one."""
    ns: dict = {}
    exec(TRAIN_COMMON, ns)
    ck = tmp_path / "ck"
    ref = loop_mod.train(ns["fresh_session"](), ns["data"], _loop(8),
                         log=_quiet)
    inj = FaultInjector(FaultSchedule.parse("preempt@4"))
    part1 = loop_mod.train(ns["fresh_session"](), ns["data"],
                           _loop(8, str(ck)), log=_quiet, faults=inj)
    assert len(part1) == 4
    assert Checkpointer(ck).latest_step() == 4
    assert Checkpointer(ck / "opt").latest_step() == 4
    code = TRAIN_COMMON + f"""
from repro_torch.runtime.fault_tolerance import resume_session
sess, start = resume_session({str(ck)!r}, fresh_session())
assert start == 4
part2 = loop_mod.train(sess, data, loop_mod.LoopConfig(
    n_steps=4, ckpt_every=100, log_every=100), log=lambda *_: None)
print("PART2", json.dumps(part2))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(REPO), timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    part2 = json.loads(proc.stdout.split("PART2", 1)[1])
    assert part1 + part2 == ref, (part1 + part2, ref)


def _split_db(path, topos):
    """The JAX package's split TuneDB (``test_faults.py``), keyed for the
    port: Eq. 1-consistent sendrecv calibration points, and measured
    all_reduce rows on which buffered wins every lookup."""
    buf = CommConfig(mode=CommMode.BUFFERED)
    s4k = CommConfig(mode=CommMode.STREAMING, chunk_bytes=4096)
    s1k = CommConfig(mode=CommMode.STREAMING, chunk_bytes=1024)
    hw = dataclasses.replace(H100, host_dispatch=50e-6, fused_dispatch=2e-6,
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
        for cfg, us in ((buf, 1.0), (s4k, 100.0), (s1k, 100.0)):
            for size in (256, 4096, 65536, 1 << 20):
                for hops in (1, 2, 3):
                    db.add(TuneEntry(topo=topo, collective="all_reduce",
                                     msg_bytes=size,
                                     config=config_to_dict(cfg),
                                     us_per_call=us, hops=hops))
    db.save(path)


def test_rank_loss_elastic_reselect(tmp_path):
    """``rank_lost@3=r7`` mid-train: the emergency checkpoint holds step 3,
    ``elastic_restore`` re-forms on the survivors with a model-re-selected
    CommConfig (no sweep), and the faulted flow is bitwise reproducible."""
    db_path = tmp_path / "tunedb.json"
    _split_db(db_path, ("torch-cpu:8", "torch-cpu:7", "torch-cpu:4"))
    oc = adamw.OptConfig(lr=1e-3, zero1=False)
    comm = CommConfig(mode=CommMode.BUFFERED)
    data = DataConfig(vocab_size=CFG.vocab_size, seq_len=32, global_batch=8)
    topo = TorusSpec.parse("4x2")
    reg = obs_metrics.registry()
    sweeps0 = reg.counter("sweep.runs").value
    resel0 = reg.counter("tune.model_reselects", collective="all_reduce").value

    def faulted_run(ckpt_dir):
        sess = setup.build_session(CFG, mesh_mod.make_test_mesh(8, 1), comm,
                                   oc=oc, device="cpu")
        inj = FaultInjector(FaultSchedule.parse("rank_lost@3=r7"))
        try:
            loop_mod.train(sess, data, _loop(10, ckpt_dir), log=_quiet,
                           faults=inj)
            raise AssertionError("rank loss never fired")
        except RankLostError as e:
            assert e.rank == 7 and e.step == 3
        assert Checkpointer(ckpt_dir).latest_step() == 3
        sess2, start = ft.elastic_restore(
            ckpt_dir, CFG, mesh_mod.make_test_mesh(4, 1), comm, oc,
            reselect=True, tune_db_path=db_path, topology=topo,
            device="cpu")
        assert start == 3 and int(sess2.opt_state["step"]) == 3
        hist = loop_mod.train(sess2, data, _loop(3), log=_quiet)
        return sess2.rt.comm, hist

    cc1, h1 = faulted_run(str(tmp_path / "ck1"))
    cc2, h2 = faulted_run(str(tmp_path / "ck2"))
    assert cc1.mode != comm.mode, (cc1, comm)
    assert cc1 == cc2
    assert reg.counter("tune.model_reselects",
                       collective="all_reduce").value >= resel0 + 2
    assert reg.counter("sweep.runs").value == sweeps0
    assert h1 == h2, (h1, h2)
    assert all(np.isfinite(h1))


def test_elastic_restore_reshards(tmp_path):
    """Train on (2, 4), checkpoint, re-form on (2, 2): params carried
    exactly, the step counter too, and training goes on."""
    oc = adamw.OptConfig(lr=1e-3, zero1=True)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, CFG.vocab_size, (4, 32)),
             "labels": rng.randint(0, CFG.vocab_size, (4, 32))}
    sess = setup.build_session(CFG, mesh_mod.make_test_mesh(2, 4),
                               CommConfig(), oc=oc, device="cpu")
    step = setup.make_sharded_train_step(sess, donate=False)
    p, o = sess.params, sess.opt_state
    for _ in range(3):
        p, o, m = step(p, o, batch)
    Checkpointer(tmp_path).save(3, setup.global_params(sess, p))
    sess2, start = ft.elastic_restore(tmp_path, CFG,
                                      mesh_mod.make_test_mesh(2, 2),
                                      CommConfig(), oc, device="cpu")
    assert start == 3 and int(sess2.opt_state["step"]) == 3
    for (n, a), (_, b) in zip(
            adamw.leaves_with_names(setup.global_params(sess, p)),
            adamw.leaves_with_names(setup.global_params(sess2))):
        assert torch.equal(a, b), n
    step2 = setup.make_sharded_train_step(sess2, donate=False)
    _, _, m2 = step2(sess2.params, sess2.opt_state, batch)
    assert np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m["loss"]) + 0.5


def test_preemption_guard_drains_training(tmp_path):
    """A software-triggered preemption: the loop checkpoints and stops
    early."""
    sess = setup.build_session(CFG, mesh_mod.make_test_mesh(1, 1),
                               CommConfig(),
                               oc=adamw.OptConfig(lr=1e-3, zero1=False),
                               device="cpu")
    state = {"n": 0}

    class Probe(ft.PreemptionGuard):
        @property
        def preempted(self):
            state["n"] += 1
            return state["n"] > 3

    real = loop_mod.PreemptionGuard
    loop_mod.PreemptionGuard = Probe
    try:
        hist = loop_mod.train(
            sess, DataConfig(vocab_size=CFG.vocab_size, seq_len=32,
                             global_batch=4),
            _loop(50, str(tmp_path)), log=_quiet)
    finally:
        loop_mod.PreemptionGuard = real
    assert len(hist) <= 5
    assert Checkpointer(tmp_path).latest_step() is not None
    assert sess.params is not None and sess.opt_state is not None
