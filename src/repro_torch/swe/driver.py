"""Shallow-water simulation driver on one card (PyTorch port).

All partitions run in one process as the leading rank dimension of the
state.  Three execution modes, mirroring the paper's §3.1/§5 scheduling
comparison:

- **fused** ("PL scheduling"): a whole ``n_inner``-step segment — halo
  exchange + element update, step after step — is captured once as a CUDA
  graph and replayed with ONE launch per segment (the JAX package's
  ``lax.scan`` single dispatch).  ``t`` lives in a device tensor advanced
  inside the graph, as in the scan carry.
- **overlapped** (§5): fused, plus the step's exchange runs on a second
  stream while the interior elements update; only the boundary pass waits
  for it (the split lives in ``dg_solver.make_step_fn``).
- **host** ("MPI+PCIe baseline"): each step is two phases issued from the
  host — the payload gather, then the full step — with a host sync after
  each, paying 2·l_k per step like the paper's baseline.

On CPU tensors (the tests) fused and overlapped run the same step eagerly in
a plain loop, with no graph.  Entry points run on the card unless the caller
passes ``device="cpu"``; with no card and no explicit device they raise.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core import latmodel
from repro_torch.core.config import CommConfig, Scheduling
from repro_torch.core.scheduler import CapturedGraph
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.swe import dg_solver
from repro_torch.swe.dg_solver import SWEConfig, make_step_fn
from repro_torch.swe.mesh_gen import Mesh as SweMesh, generate_bight_mesh
from repro_torch.swe.partition import PartitionedMesh, _rcb, partition_mesh


@dataclasses.dataclass
class Simulation:
    mesh: Optional[SweMesh]   # None when built from a reference partition
    pm: PartitionedMesh
    comm_cfg: CommConfig
    swe: SWEConfig
    state: torch.Tensor       # (P, E_max, 3) float32 on `device`
    device: torch.device
    # Virtual torus the partitions are placed on (multi-hop exchange edges
    # route through intermediate partitions); None = flat.
    topology: object = None            # TorusSpec | None
    round_cfgs: Optional[list] = None  # per exchange round, serial paths only


def flatten_state(sim: Simulation, state) -> np.ndarray:
    """Partitioned ``(P, E_max, 3)`` state -> global element order
    ``(E, 3)``.  The RCB partition is a pure function of (mesh, n_parts), so
    the same mesh flattens identically from any partition count."""
    s = (state.detach().cpu().numpy() if isinstance(state, torch.Tensor)
         else np.asarray(state))
    part = _rcb(sim.mesh.centroids, sim.pm.n_parts)
    vals = np.zeros((sim.mesh.n_elements, 3), s.dtype)
    for p in range(sim.pm.n_parts):
        ids = np.flatnonzero(part == p)   # local order = global order
        vals[ids] = s[p, :len(ids)]
    return vals


def state_digest(sim: Simulation, state) -> str:
    """sha256 of the global-order state."""
    return hashlib.sha256(
        np.ascontiguousarray(flatten_state(sim, state)).tobytes()).hexdigest()


def _select_round_configs(rounds, comm, halo_bytes: int, device,
                          tune_db_path=None, objective: str = "latency"):
    """Per-edge hop-aware selection: one autotuned config per exchange
    round.  Each round's worst-case hop distance is looked up in the TuneDB
    (preferring measurements taken on the same virtual placement) and the
    hop-matched winner returned — a 1-hop round no longer pays the
    transport tuned for the 3-hop round (the paper's per-edge result)."""
    from repro_torch.tune import TuneDB, select_config, topology_key
    topo = topology_key(comm.size, device)
    torus = comm.topo.name if comm.topo is not None else ""
    db = TuneDB.load(tune_db_path)   # one read for all rounds
    return [select_config("multi_neighbor", halo_bytes, topo=topo, db=db,
                          hops=max(1, comm.max_hops(perm)),
                          objective=objective, torus=torus)
            for perm in rounds]


def _resolve_comm_cfg(comm_cfg, pm: PartitionedMesh, topology, device,
                      tune_db_path, objective: str):
    """``(comm_cfg, round_cfgs)`` for a simulation: a ``CommConfig`` as
    given, or ``"auto"`` through the TuneDB of ``device``'s platform.

    ``"auto"`` picks the fastest measured multi-neighbor config at the
    largest per-round halo message and the pattern's worst-case hop
    distance.  On a virtual torus every round is then tuned at its own hop
    distance (serial schedules only: the double-buffered overlapped engine
    pipelines all rounds under one config), with its scheduling unified
    with the representative's so the step structure stays coherent."""
    if isinstance(comm_cfg, CommConfig):
        return comm_cfg, None
    from repro_torch.core.collectives import resolve_config
    from repro_torch.core.communicator import Communicator
    halo_bytes = int(pm.s_max) * 3 * 4   # (h, hu, hv) f32 per halo element
    comm = Communicator(("data",), (pm.n_parts,), topo=topology)
    edges = [e for r in pm.rounds for e in r]
    hops = comm.max_hops(edges) if edges else None
    comm_cfg = resolve_config(comm_cfg, "multi_neighbor", halo_bytes,
                              n_ranks=pm.n_parts, db_path=tune_db_path,
                              hops=hops, objective=objective,
                              torus=topology.name if topology else "",
                              device=device)
    if (not pm.rounds or topology is None
            or comm_cfg.scheduling == Scheduling.OVERLAPPED):
        return comm_cfg, None
    per_round = [dataclasses.replace(c, scheduling=comm_cfg.scheduling)
                 for c in _select_round_configs(pm.rounds, comm, halo_bytes,
                                                device, tune_db_path,
                                                objective)]
    return comm_cfg, (per_round if any(c != comm_cfg for c in per_round)
                      else None)


def build_simulation(n_elements: int, n_parts: int, comm_cfg,
                     swe: SWEConfig = SWEConfig(), seed: int = 0,
                     topology=None,
                     initial_state: Optional[np.ndarray] = None,
                     device=None, tune_db_path=None,
                     objective: str = "latency",
                     mesh: Optional[SweMesh] = None) -> Simulation:
    """Generate the bight mesh, partition it over ``n_parts`` stacked ranks
    and place the initial state on ``device`` (default: the card).

    ``comm_cfg`` is a :class:`CommConfig` or ``"auto"``: the autotuner's
    fastest measured config for this partitioning's halo exchange on
    ``device``'s platform (``OPTIMIZED_CONFIG`` on a cold cache);
    ``objective="e2e"`` ranks by the measured halo-fold consumer loop.
    ``topology`` (a :class:`~repro_torch.core.topology.TorusSpec`) places
    the partitions on a virtual multi-hop torus; with ``"auto"`` every
    exchange round is then tuned at its own hop distance
    (``Simulation.round_cfgs``).  ``initial_state`` (global ``(E, 3)``)
    seeds the partitions instead of the t=0 hump.  ``mesh`` is the
    already generated ``generate_bight_mesh(n_elements, seed)`` (the
    elastic runtime's rebuilds reuse it instead of generating it again)."""
    device = resolve_device(device)
    if mesh is None:
        mesh = generate_bight_mesh(n_elements, seed=seed)
    if initial_state is None:
        initial_state = dg_solver.initial_state(mesh)
    pm = partition_mesh(mesh, n_parts, np.asarray(initial_state))
    comm_cfg, round_cfgs = _resolve_comm_cfg(comm_cfg, pm, topology, device,
                                             tune_db_path, objective)
    state = torch.from_numpy(pm.state0.astype(np.float32)).to(device)
    return Simulation(mesh=mesh, pm=pm, comm_cfg=comm_cfg, swe=swe,
                      state=state, device=device, topology=topology,
                      round_cfgs=round_cfgs)


def from_reference(arrays: Mapping, comm_cfg: CommConfig,
                   swe: SWEConfig = SWEConfig(), topology=None,
                   device=None) -> Simulation:
    """Build a :class:`Simulation` from another implementation's partition:
    ``arrays`` maps every :class:`PartitionedMesh` field (``rounds`` as a
    sequence of ``(src, dst)`` edge lists, the rest as numbers or numpy
    arrays) to its value.  The state starts from ``state0``."""
    if not isinstance(comm_cfg, CommConfig):
        raise TypeError(f"from_reference takes a CommConfig, got "
                        f"{comm_cfg!r}")
    device = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(PartitionedMesh):
        v = arrays[f.name]
        if f.name == "rounds":
            v = tuple(tuple((int(s), int(d)) for s, d in r) for r in v)
        elif np.ndim(v) == 0:
            v = int(v)
        else:
            v = np.asarray(v)
        fields[f.name] = v
    pm = PartitionedMesh(**fields)
    state = torch.from_numpy(np.asarray(pm.state0, np.float32)).to(device)
    return Simulation(mesh=None, pm=pm, comm_cfg=comm_cfg, swe=swe,
                      state=state, device=device, topology=topology)


def _static_args(sim: Simulation) -> dict:
    """The step's per-partition constants on the simulation's device, index
    ranges checked once on the host."""
    pm = sim.pm
    e_ext = pm.e_max + pm.h_max
    for name, a, lo, hi in (("neigh_idx", pm.neigh_idx, 0, e_ext),
                            ("boundary_idx", pm.boundary_idx, 0, pm.e_max),
                            ("send_idx", pm.send_idx, 0, pm.e_max),
                            ("recv_slot", pm.recv_slot, -1, pm.h_max)):
        a = np.asarray(a)
        if a.size and (a.min() < lo or a.max() >= hi):
            raise ValueError(f"{name} holds indices outside [{lo}, {hi})")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=sim.device, dtype=dtype)

    return dict(
        area=put(pm.area, torch.float32),
        normals=put(pm.normals, torch.float32),
        neigh_idx=put(pm.neigh_idx, torch.int32),
        edge_type=put(pm.edge_type, torch.int32),
        valid=put(pm.valid, torch.float32),
        send_idx=put(pm.send_idx, torch.int64),
        send_mask=put(pm.send_mask, torch.float32),
        recv_slot=put(pm.recv_slot, torch.int64),
        boundary_idx=put(pm.boundary_idx, torch.int32),
    )


def make_sim_runner(sim: Simulation, n_inner: int = 10, update=None):
    """Fused/overlapped runner: ``run(state, t)`` advances ``n_inner`` steps
    from time ``t`` and returns the new state.

    On the card the segment is captured once, here, as one CUDA graph
    (after one warm-up step that builds the kernel and fills the plan
    caches) and every ``run`` replays it with one launch.  ``update``
    replaces the element update, as in :func:`dg_solver.make_step_fn`.
    The runner's ``tape`` holds the delivery plans its first step drew
    under a wire fault schedule; every later step, capture and replay
    runs the same plans."""
    step = make_step_fn(sim.pm, sim.comm_cfg, sim.swe,
                        topology=sim.topology, round_cfgs=sim.round_cfgs,
                        update=update)
    args = _static_args(sim)
    dt = sim.swe.dt
    scheduling = sim.comm_cfg.scheduling.value

    def advance(state, t):
        for _ in range(n_inner):
            state = step(state, t, **args)
            t = t + dt      # float32 on the device, as the scan carry
        return state

    if sim.device.type != "cuda":
        def run(state, t):
            with obs_trace.span("swe.segment", cat="driver", steps=n_inner,
                                scheduling=scheduling):
                return advance(state, torch.tensor(t, dtype=torch.float32,
                                                   device=sim.device))
        run.tape = step.tape
        return run

    return _GraphSegment(sim, step, args, advance, n_inner, scheduling)


class _GraphSegment:
    """An ``n_inner``-step segment captured as one CUDA graph
    (:class:`~repro_torch.core.scheduler.CapturedGraph`, after one eager
    step that builds the kernel and fills the plan caches: no host-to-device
    copy may happen during capture).  The graph reads its inputs through
    fixed addresses, so this object keeps every tensor it reads alive: the
    step's constants, and the static state and time that each call refills
    (the wire's index tensors live in the process-long plan cache).  The
    kernels' ``launches`` and the ``comm.*``/``wire.*`` counters count each
    replay, not the capture."""

    def __init__(self, sim, step, args, advance, n_inner, scheduling):
        self.args, self.step, self.tape = args, step, step.tape
        self.n_inner, self.scheduling = n_inner, scheduling
        static = (sim.state.clone(),
                  torch.zeros((), dtype=torch.float32, device=sim.device))
        with torch.cuda.device(sim.device):
            self.graph = CapturedGraph(
                advance, static, span="swe.graph",
                warm=lambda state, t: step(state, t, **args))

    def __call__(self, state, t):
        # Host span: the replay is asynchronous, so it covers the launch,
        # not completion — callers that need completion time synchronize.
        with obs_trace.span("swe.segment", cat="driver", steps=self.n_inner,
                            scheduling=self.scheduling):
            state_in, t_in = self.graph.static
            state_in.copy_(state)
            t_in.fill_(t)
            return self.graph.replay().clone()


class HostScheduledRunner:
    """Paper baseline: two host-issued phases per step — the payload gather
    (what the paper's communication kernel stages for the host), then the
    full step — with a host sync after each (2 dispatches per step)."""

    def __init__(self, sim: Simulation):
        self.sim = sim
        self.dispatches = 0
        self._step = make_step_fn(sim.pm, sim.comm_cfg, sim.swe,
                                  topology=sim.topology,
                                  round_cfgs=sim.round_cfgs)
        self.tape = self._step.tape
        self._args = _static_args(sim)

    def _sync(self) -> None:
        if self.sim.device.type == "cuda":
            torch.cuda.synchronize(self.sim.device)

    def run(self, state, t, n_steps: int):
        for i in range(n_steps):
            with obs_trace.span("swe.host_step", cat="driver", step=i,
                                dispatches=2):
                dg_solver.halo_payloads(state, self._args["send_idx"],
                                        self._args["send_mask"])
                self._sync()                  # host round-trip (l_k)
                state = self._step(
                    state, torch.tensor(t, dtype=torch.float32,
                                        device=self.sim.device),
                    **self._args)
                self._sync()
            self.dispatches += 2
            t += self.sim.swe.dt
        return state, t


def make_host_scheduled_runner(sim: Simulation) -> HostScheduledRunner:
    """The paper-baseline runner (see :class:`HostScheduledRunner`)."""
    return HostScheduledRunner(sim)


def build_workload(sim: Simulation, freq: float = 256e6
                   ) -> latmodel.SWEWorkload:
    """Eq. 2/3 workload descriptor from the partition statistics."""
    pm = sim.pm
    # critical partition: largest sent/received element count
    crit = int(np.argmax(pm.n_send + pm.n_neighbors * 1000))
    return latmodel.SWEWorkload(
        e_total=sim.mesh.n_elements,
        e_core=int(pm.n_core[crit]),
        e_send=int(pm.n_send[crit]),
        e_recv=int(pm.n_send[crit]),
        d_ext=0,
        l_pipe=100,
        n_max=pm.n_max,
        flop_per_element=dg_solver.FLOP_PER_ELEMENT,
        freq=freq,
        msg_bytes=int(pm.s_max * 3 * 4))
