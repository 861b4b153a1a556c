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

from repro_torch.core.config import CommConfig
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


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when no card is present and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


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


def _check_comm_cfg(comm_cfg) -> None:
    if not isinstance(comm_cfg, CommConfig):
        raise NotImplementedError(
            f"comm_cfg must be a CommConfig; {comm_cfg!r} (autotuned "
            f"selection) is not ported yet")


def build_simulation(n_elements: int, n_parts: int, comm_cfg: CommConfig,
                     swe: SWEConfig = SWEConfig(), seed: int = 0,
                     topology=None,
                     initial_state: Optional[np.ndarray] = None,
                     device=None) -> Simulation:
    """Generate the bight mesh, partition it over ``n_parts`` stacked ranks
    and place the initial state on ``device`` (default: the card).

    ``topology`` (a :class:`~repro_torch.core.topology.TorusSpec`) places
    the partitions on a virtual multi-hop torus.  ``initial_state`` (global
    ``(E, 3)``) seeds the partitions instead of the t=0 hump."""
    _check_comm_cfg(comm_cfg)
    device = resolve_device(device)
    mesh = generate_bight_mesh(n_elements, seed=seed)
    if initial_state is None:
        initial_state = dg_solver.initial_state(mesh)
    pm = partition_mesh(mesh, n_parts, np.asarray(initial_state))
    state = torch.from_numpy(pm.state0.astype(np.float32)).to(device)
    return Simulation(mesh=mesh, pm=pm, comm_cfg=comm_cfg, swe=swe,
                      state=state, device=device, topology=topology)


def from_reference(arrays: Mapping, comm_cfg: CommConfig,
                   swe: SWEConfig = SWEConfig(), topology=None,
                   device=None) -> Simulation:
    """Build a :class:`Simulation` from another implementation's partition:
    ``arrays`` maps every :class:`PartitionedMesh` field (``rounds`` as a
    sequence of ``(src, dst)`` edge lists, the rest as numbers or numpy
    arrays) to its value.  The state starts from ``state0``."""
    _check_comm_cfg(comm_cfg)
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
    replaces the element update, as in :func:`dg_solver.make_step_fn`."""
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
        return run

    return _GraphSegment(sim, step, args, advance, n_inner, scheduling)


class _GraphSegment:
    """An ``n_inner``-step segment captured as one CUDA graph.  The graph
    reads its inputs through fixed addresses, so this object keeps every
    tensor it reads alive: the step's constants and the static input buffers
    that each call refills (the wire's index tensors live in the
    process-long plan cache)."""

    def __init__(self, sim, step, args, advance, n_inner, scheduling):
        self.args, self.step = args, step
        self.n_inner, self.scheduling = n_inner, scheduling
        self.state_in = sim.state.clone()
        self.t_in = torch.zeros((), dtype=torch.float32, device=sim.device)
        # One eager step first: builds the kernel and fills the plan caches
        # (no host-to-device copy may happen during capture).
        warm = torch.cuda.Stream(sim.device)
        warm.wait_stream(torch.cuda.current_stream(sim.device))
        with torch.cuda.stream(warm):
            step(self.state_in, self.t_in, **args)
        torch.cuda.current_stream(sim.device).wait_stream(warm)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.state_out = advance(self.state_in, self.t_in)

    def __call__(self, state, t):
        # Host span: the replay is asynchronous, so it covers the launch,
        # not completion — callers that need completion time synchronize.
        with obs_trace.span("swe.segment", cat="driver", steps=self.n_inner,
                            scheduling=self.scheduling):
            self.state_in.copy_(state)
            self.t_in.fill_(t)
            self.graph.replay()
            return self.state_out.clone()


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
