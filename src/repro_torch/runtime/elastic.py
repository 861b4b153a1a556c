"""Elastic SWE runtime (PyTorch port): run a simulation through a fault
schedule and keep the answer.

The segment loop (:func:`run_swe_elastic`) is the paper's latency story
told under failure: every ``segment`` steps it snapshots the
**global-order** state (:func:`repro_torch.swe.driver.flatten_state`, which
restores onto any partition count), polls the
:class:`~repro_torch.runtime.faults.FaultInjector`, feeds edge telemetry to
the :class:`~repro_torch.runtime.faults.DegradationMonitor`, and reacts:

- **DEGRADED_LINK fires** -> the wire slows down *physically*
  (``TorusSpec.link_slowdowns`` inserts hold rounds into the routed
  permutes), but routes and configs stay put until the monitor confirms.
- **Monitor confirms an edge** (hysteresis met) -> re-route around it
  (``with_reroute``) and re-select per-round configs from the calibrated
  Eq. 1 model (:func:`repro_torch.tune.elastic.reselect_round_configs`).
  No sweep runs — the report carries the ``sweep.runs`` delta as witness.
- **CHUNK_LOSS fires** -> the chunk-level
  :class:`~repro_torch.core.reliable.WireFaults` schedule is injected and
  the configs are promoted to guaranteed delivery; a confirmed retransmit
  streak re-selects with the Eq. 1 loss surcharge.
- **RANK_LOST fires** -> the run unwinds to the last segment snapshot,
  re-forms ``n - 1`` stacked partitions on the survivors' sub-torus
  (``TorusSpec.shrink``), model-re-selects configs for the new fabric, and
  replays from the snapshot.

Everything about recovery is deterministic, so two same-seed runs produce
bitwise-identical digest streams, and the final digest matches the
no-fault run (routing, hold rounds, recovery rounds and repartitioning are
all value-preserving).

Each segment builds a new runner (on the card: a new captured graph) under
the active fault context, as the JAX package traces a new program per
segment; the runner draws its delivery plans at its first call.

``python -m repro_torch.runtime.elastic`` runs a schedule and emits a JSON
report (digest stream, recoveries, re-selections, sweep delta), optionally
diffing the final digest against a no-fault run's report.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import reliable
from repro_torch.core.config import Reliability
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime.faults import (DegradationMonitor, FaultInjector,
                                        FaultSchedule, RankLostError,
                                        _torus_links)
from repro_torch.swe.dg_solver import SWEConfig


@dataclasses.dataclass
class Recovery:
    """One recovery action taken mid-run."""
    step: int
    kind: str                  # "rank_lost" | "degraded_link" | "lossy_wire"
    detail: str
    wall_s: float
    configs_before: list
    configs_after: list

    def config_changed(self) -> bool:
        return self.configs_before != self.configs_after


@dataclasses.dataclass
class ElasticReport:
    """What a faulted run produced — the kill-and-resume comparison
    payload.  ``build_s``, ``segment_s`` and ``device_bytes`` are the
    port's additions: each segment's runner build (on the card: warm-up
    step and graph capture) and run, in wall seconds with the device
    synchronized, and the device memory allocated after it (0 on the
    CPU)."""
    digests: list            # (step, sha256) after every segment
    final_digest: str
    steps_run: int
    n_parts: list            # partition count per segment
    recoveries: list         # list[Recovery]
    sweep_runs_delta: int    # MUST be 0: no sweep during recovery
    drained: bool = False
    # Reliable-wire deltas over the run (0 on a clean wire; > 0 is the
    # witness that chunk-loss recovery actually fired).
    wire_retransmits: int = 0
    wire_dup_dropped: int = 0
    wire_timeouts: int = 0
    build_s: list = dataclasses.field(default_factory=list)
    segment_s: list = dataclasses.field(default_factory=list)
    device_bytes: list = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=1, sort_keys=True)


def _sim_configs(sim) -> list:
    """The run's effective per-round configs as comparable primitives."""
    from repro_torch.tune.space import config_to_dict
    cfgs = sim.round_cfgs if sim.round_cfgs else [sim.comm_cfg]
    return [sorted(config_to_dict(c).items()) for c in cfgs]


def _physical_edges(spec) -> list:
    """Rank pairs of every physical link on ``spec`` (telemetry targets)."""
    if spec is None:
        return []
    return [(spec.rank_at(a), spec.rank_at(b))
            for a, b in _torus_links(spec.shape)]


def _guaranteed(rep, rcfgs):
    """``(rep, rcfgs)`` promoted to guaranteed delivery."""
    rep = dataclasses.replace(rep, reliability=Reliability.GUARANTEED)
    rcfgs = ([dataclasses.replace(c, reliability=Reliability.GUARANTEED)
              for c in rcfgs] if rcfgs else None)
    return rep, rcfgs


def reselect_swe(pm, topology, db, objective: str, fallback,
                 loss: float = 0.0):
    """Model-based per-round selection for an SWE exchange pattern on
    ``topology`` — the recovery-time twin of ``build_simulation``'s
    measured selection.  Returns ``(representative_cfg, round_cfgs)``.
    ``loss`` > 0 prices candidates for a lossy wire (guaranteed delivery
    with the Eq. 1 retransmit surcharge)."""
    from repro_torch.core.communicator import Communicator
    from repro_torch.tune.elastic import reselect_round_configs
    halo_bytes = int(pm.s_max) * 3 * 4
    comm = Communicator(("data",), (pm.n_parts,), topo=topology)
    return reselect_round_configs(pm.rounds, comm, halo_bytes, db=db,
                                  objective=objective, loss=loss,
                                  fallback=fallback)


def run_swe_elastic(n_elements: int, n_parts: int, topology,
                    comm_cfg="auto", n_steps: int = 30, segment: int = 10,
                    schedule: Optional[FaultSchedule] = None,
                    tune_db_path=None, objective: str = "latency",
                    monitor: Optional[DegradationMonitor] = None,
                    guard=None, seed: int = 0,
                    base_step_s: float = 0.0,
                    swe: SWEConfig = SWEConfig(), device=None,
                    mesh=None, log=lambda s: None) -> ElasticReport:
    """Run the SWE simulation for ``n_steps`` on ``n_parts`` stacked
    partitions of ``device`` (default: the card) under a fault schedule.

    See the module docstring for the recovery semantics.  ``monitor=None``
    installs a default :class:`DegradationMonitor` (hysteresis 3, cooldown
    2 segments); ``schedule=None`` runs fault-free (the reference run).
    ``swe`` sets the time step and forcing (a full-size mesh needs a
    Courant-limited ``dt``; the default 1e-4 suits small meshes).  ``mesh``
    is the already generated ``generate_bight_mesh(n_elements, seed)``,
    for callers that run several schedules on one mesh.
    """
    from repro_torch.swe import driver
    from repro_torch.tune.db import TuneDB

    reg = obs_metrics.registry()
    sweep_runs0 = reg.counter("sweep.runs").value
    schedule = schedule or FaultSchedule()
    injector = FaultInjector(schedule, base_step_s=base_step_s)
    monitor = monitor or DegradationMonitor(threshold=1.5, hysteresis=3,
                                            cooldown=2 * segment)
    # Evidence starts with this run: the monitor's first registry read
    # would otherwise count every retransmit the process saw before it.
    monitor.registry_deltas()
    db = TuneDB.load(tune_db_path)

    sim = driver.build_simulation(n_elements, n_parts, comm_cfg, swe=swe,
                                  seed=seed, topology=topology,
                                  device=device, tune_db_path=tune_db_path,
                                  objective=objective, mesh=mesh)
    mesh, device = sim.mesh, sim.device
    fallback_cfg = sim.comm_cfg       # recovery's cold-DB fallback
    believed_spec = topology          # what routing/selection assumes
    state, t = sim.state, 0.0

    digests: list = []
    n_parts_hist: list = []
    recoveries: list = []
    build_s: list = []
    segment_s: list = []
    device_bytes: list = []
    drained = False

    # Reliable-wire bookkeeping: counter baseline for the report deltas,
    # the currently injected WireFaults (None = clean wire), and the
    # per-build counter delta later builds re-charge (see the segment loop).
    wire0 = reliable.wire_counters()
    wire_stack = contextlib.ExitStack()
    active_wire = None
    last_build_delta: dict = {}

    # Segment-boundary snapshot (global order) — the in-memory checkpoint
    # rank-loss recovery unwinds to.
    snap_state = driver.flatten_state(sim, state)
    snap_step, snap_t = 0, 0.0

    # Seed the monitor's per-edge baselines from the healthy fabric (before
    # any event fires): a fault active at a monitor's FIRST sample of an
    # edge would otherwise become that edge's "normal".
    if topology is not None:
        monitor.observe(0, injector.edge_latency_samples(
            0, _physical_edges(topology)))

    def rebuild(spec, parts, initial_global, rep_cfg, round_cfgs):
        s = driver.build_simulation(n_elements, parts, rep_cfg, swe=swe,
                                    seed=seed, topology=spec,
                                    initial_state=initial_global,
                                    device=device, mesh=mesh)
        s.round_cfgs = round_cfgs
        return s

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step = 0
    try:
        while step < n_steps:
            n_inner = min(segment, n_steps - step)
            try:
                fired = injector.poll(step, guard=guard)
            except RankLostError as e:
                # --- rank-loss recovery: survivors re-form from the snapshot
                t0 = time.perf_counter()
                before = _sim_configs(sim)
                survivors = sim.pm.n_parts - 1
                if survivors < 1:
                    raise
                new_topo = (believed_spec.shrink(survivors)
                            if believed_spec is not None else None)
                sim = rebuild(new_topo, survivors, snap_state, fallback_cfg,
                              None)
                sim.comm_cfg, sim.round_cfgs = reselect_swe(
                    sim.pm, new_topo, db, objective, fallback_cfg)
                believed_spec = new_topo
                injector.active_slowdowns.clear()   # dead rank's fabric is gone
                state, t = sim.state, snap_t
                step = snap_step
                recoveries.append(Recovery(
                    step=e.step, kind="rank_lost",
                    detail=f"rank {e.rank} lost; {survivors} survivors on "
                           f"{new_topo.name if new_topo else 'flat'}",
                    wall_s=time.perf_counter() - t0,
                    configs_before=before, configs_after=_sim_configs(sim)))
                log(f"[elastic] rank {e.rank} lost at step {e.step}: resumed "
                    f"from step {snap_step} on {survivors} partitions")
                continue

            if guard is not None and guard.preempted:
                drained = True
                break

            if any(ev.kind == "degraded_link" for ev in fired):
                # Wire-layer injection: physics change, belief doesn't.  The
                # degraded spec's routed plans carry the hold rounds; routes
                # and configs stay what the healthy fabric chose.
                phys = injector.degrade_spec(
                    believed_spec.without_degradations()
                    if believed_spec is not None else None)
                if phys is not None:
                    sim = rebuild(phys, sim.pm.n_parts,
                                  driver.flatten_state(sim, state),
                                  sim.comm_cfg, sim.round_cfgs)
                    state = sim.state
                    log(f"[elastic] degraded links now "
                        f"{dict(injector.active_slowdowns)}")

            wf = injector.wire_faults()
            if wf != active_wire:
                # chunk_loss fired (or escalated): inject the chunk-level
                # schedule and promote the run's configs to guaranteed
                # delivery — best-effort messages cannot survive a dropping
                # wire.
                wire_stack.close()
                wire_stack = contextlib.ExitStack()
                if wf is not None:
                    wire_stack.enter_context(reliable.inject(wf))
                active_wire = wf
                last_build_delta = {}
                if wf is not None and wf.lossy():
                    rep, rcfgs = _guaranteed(sim.comm_cfg, sim.round_cfgs)
                    if (rep, rcfgs) != (sim.comm_cfg, sim.round_cfgs):
                        sim = rebuild(sim.topology, sim.pm.n_parts,
                                      driver.flatten_state(sim, state),
                                      rep, rcfgs)
                        state = sim.state
                    log(f"[elastic] chunk loss active (drop={wf.drop:.1%}): "
                        f"wire promoted to guaranteed delivery")

            t_build = time.perf_counter()
            seg_wire = reliable.wire_counters()
            run = driver.make_sim_runner(sim, n_inner)
            sync()
            t_seg = time.perf_counter()
            state = run(state, t)
            sync()
            del run   # the segment's graph and its memory pool go with it
            build_s.append(t_seg - t_build)
            segment_s.append(time.perf_counter() - t_seg)
            device_bytes.append(torch.cuda.memory_allocated(device)
                                if device.type == "cuda" else 0)
            if active_wire is not None:
                # A runner records its plans' wire.* counts once, at its
                # first call (the JAX package: once per trace).  Its later
                # steps still EXECUTE those recovery rounds, so a build that
                # drew no new faulted message re-charges the last drawn
                # delta — that steady per-observation signal is what the
                # monitor's retransmit streak detects.
                now = reliable.wire_counters()
                delta = {k: now[k] - seg_wire[k] for k in seg_wire}
                if any(delta.values()):
                    last_build_delta = delta
                elif last_build_delta:
                    for k, v in last_build_delta.items():
                        if v:
                            reg.counter(f"wire.{k}").inc(v)
            t += sim.swe.dt * n_inner
            step += n_inner

            # Segment boundary: snapshot + digest + telemetry -> monitor.
            snap_state = driver.flatten_state(sim, state)
            snap_step, snap_t = step, t
            digests.append((step, driver.state_digest(sim, state)))
            n_parts_hist.append(sim.pm.n_parts)

            spec_now = sim.topology
            if spec_now is not None:
                samples = injector.edge_latency_samples(
                    step, _physical_edges(spec_now))
                confirmed = monitor.observe(step, samples)
                if confirmed:
                    # --- degraded-but-alive recovery: re-route + re-select
                    t0 = time.perf_counter()
                    before = _sim_configs(sim)
                    believed = (believed_spec.without_degradations()
                                if believed_spec is not None else None)
                    for (a, b) in sorted(monitor.confirmed):
                        f = injector.active_slowdowns.get((a, b), 1.0)
                        if f > 1.0 and believed is not None:
                            believed = believed.with_link_slowdown(a, b, f)
                    phys = (believed.with_reroute(True)
                            if believed is not None else None)
                    rep, rcfgs = reselect_swe(sim.pm, phys, db, objective,
                                              fallback_cfg)
                    sim = rebuild(phys, sim.pm.n_parts, snap_state, rep,
                                  rcfgs)
                    believed_spec = phys
                    state = sim.state
                    recoveries.append(Recovery(
                        step=step, kind="degraded_link",
                        detail=f"confirmed {sorted(confirmed)}; rerouted + "
                               f"model-reselected",
                        wall_s=time.perf_counter() - t0,
                        configs_before=before,
                        configs_after=_sim_configs(sim)))
                    log(f"[elastic] degradation confirmed on "
                        f"{sorted(confirmed)}: rerouted and re-selected")
                if monitor.wire_confirmed:
                    # --- lossy-wire recovery: the retransmit streak
                    # confirmed a dropping wire; re-select with the Eq. 1
                    # loss surcharge (no sweep runs).
                    t0 = time.perf_counter()
                    before = _sim_configs(sim)
                    loss_est = (active_wire.drop
                                if active_wire is not None else 0.0)
                    rep, rcfgs = _guaranteed(*reselect_swe(
                        sim.pm, spec_now, db, objective, fallback_cfg,
                        loss=loss_est))
                    sim = rebuild(spec_now, sim.pm.n_parts, snap_state, rep,
                                  rcfgs)
                    state = sim.state
                    recoveries.append(Recovery(
                        step=step, kind="lossy_wire",
                        detail=f"retransmit streak confirmed (last delta "
                               f"{monitor.last_retransmit_delta}); "
                               f"loss-aware model re-selection at "
                               f"loss={loss_est:g}",
                        wall_s=time.perf_counter() - t0,
                        configs_before=before,
                        configs_after=_sim_configs(sim)))
                    log(f"[elastic] lossy wire confirmed at step {step}: "
                        f"re-selected for loss={loss_est:g}")
    finally:
        wire_stack.close()
    wire1 = reliable.wire_counters()
    return ElasticReport(
        digests=digests, final_digest=driver.state_digest(sim, state),
        steps_run=step, n_parts=n_parts_hist, recoveries=recoveries,
        sweep_runs_delta=reg.counter("sweep.runs").value - sweep_runs0,
        drained=drained,
        wire_retransmits=int(wire1["retransmits"] - wire0["retransmits"]),
        wire_dup_dropped=int(wire1["dup_dropped"] - wire0["dup_dropped"]),
        wire_timeouts=int(wire1["timeouts"] - wire0["timeouts"]),
        build_s=build_s, segment_s=segment_s, device_bytes=device_bytes)


# ----------------------------------------------------------------------
# CLI — the kill-and-resume smoke
# ----------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.elastic",
        description="Run the SWE simulation under a fault schedule")
    p.add_argument("--devices", type=int, default=8,
                   help="partitions (stacked ranks on one device)")
    p.add_argument("--topology", default="4x2",
                   help="TorusSpec, e.g. 4x2 or 4x4:snake")
    p.add_argument("--elements", type=int, default=400)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--segment", type=int, default=10)
    p.add_argument("--schedule", default=None,
                   help="compact schedule, e.g. 'rank_lost@10=r5'")
    p.add_argument("--schedule-file", default=None,
                   help="JSON FaultSchedule file (overrides --schedule)")
    p.add_argument("--tune-db", default=None)
    p.add_argument("--objective", default="latency",
                   choices=("latency", "e2e"))
    p.add_argument("--json", default=None, help="write the report here")
    p.add_argument("--check-against", default=None,
                   help="reference report JSON; fail unless final digests "
                        "match")
    p.add_argument("--expect-recovery", action="store_true",
                   help="fail unless >=1 recovery happened (and no sweep "
                        "ran during it)")
    p.add_argument("--chunk-loss", type=float, default=0.0,
                   help="wire chunk-drop probability from step 0 "
                        "(shorthand for a chunk_loss@0 schedule event)")
    p.add_argument("--chunk-dup", type=float, default=0.0,
                   help="wire chunk-duplicate probability from step 0")
    p.add_argument("--chunk-reorder", type=float, default=0.0,
                   help="wire chunk-reorder probability from step 0")
    p.add_argument("--expect-retransmits", action="store_true",
                   help="fail unless the run retransmitted at least one "
                        "chunk (the chaos smoke's recovery witness)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from repro_torch.core.topology import TorusSpec
    topology = TorusSpec.parse(args.topology) if args.topology else None
    schedule = None
    if args.schedule_file:
        schedule = FaultSchedule.load(args.schedule_file)
    elif args.schedule:
        schedule = FaultSchedule.parse(args.schedule)
    if args.chunk_loss or args.chunk_dup or args.chunk_reorder:
        from repro_torch.runtime.faults import ChunkLoss
        ev = ChunkLoss(0, drop=args.chunk_loss, dup=args.chunk_dup,
                       reorder=args.chunk_reorder)
        schedule = FaultSchedule(
            events=(schedule.events if schedule else ()) + (ev,),
            seed=schedule.seed if schedule else None)

    report = run_swe_elastic(
        args.elements, args.devices, topology, n_steps=args.steps,
        segment=args.segment, schedule=schedule, tune_db_path=args.tune_db,
        objective=args.objective, device=args.device, log=print)

    print(f"steps_run={report.steps_run} final={report.final_digest[:16]} "
          f"recoveries={len(report.recoveries)} "
          f"sweep_runs_delta={report.sweep_runs_delta} "
          f"wire_retransmits={report.wire_retransmits}")
    for r in report.recoveries:
        print(f"  [{r.kind}@{r.step}] {r.detail} "
              f"({r.wall_s*1e3:.0f}ms, config_changed={r.config_changed()})")

    if args.json:
        Path(args.json).write_text(report.to_json())
    rc = 0
    if args.expect_recovery:
        if not report.recoveries:
            print("FAIL: expected at least one recovery, saw none")
            rc = 1
        if report.sweep_runs_delta != 0:
            print(f"FAIL: {report.sweep_runs_delta} sweep(s) ran during "
                  f"the faulted run — recovery must be model-based")
            rc = 1
    has_chunk_loss = (schedule is not None
                      and any(ev.kind == "chunk_loss"
                              for ev in schedule.events))
    if args.expect_retransmits and report.wire_retransmits <= 0:
        print("FAIL: expected chunk retransmissions, wire_retransmits=0 "
              "(chunk-loss injection never reached the wire)")
        rc = 1
    if not has_chunk_loss and report.wire_retransmits != 0:
        print(f"FAIL: {report.wire_retransmits} retransmission(s) on a "
              f"clean wire — the zero-fault fast path must be overhead-free")
        rc = 1
    if args.check_against:
        ref = json.loads(Path(args.check_against).read_text())
        if ref["final_digest"] != report.final_digest:
            print(f"FAIL: final digest {report.final_digest[:16]} != "
                  f"reference {ref['final_digest'][:16]}")
            rc = 1
        else:
            print("final digest matches reference")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
