"""Communication scheduling — host-scheduled vs. fused (device) execution.

The paper's central latency lever: scheduling a communication command from
the host costs a kernel invocation (~30 µs through XRT), while a control
kernel in PL issues it in sub-µs.  On one GPU the same dichotomy exists
between

- **host scheduling**: each phase of a step (compute / comm / compute) is
  launched eagerly from Python and the host synchronizes with the card
  between phases.  Every phase pays the host's launch and sync latency.
- **fused scheduling**: the entire step is captured as ONE CUDA graph and
  replayed; the card runs every launch of the step from one host call (the
  "custom control kernel" of Fig. 1b).

Both runners execute the same phase list and produce identical numerics —
the difference is dispatch count, which the latency model converts to time.

:class:`CapturedGraph` holds the capture mechanics both this module and the
serving path (:mod:`repro_torch.train.serve`) use: static inputs, the
warm-up before capture, the graph's memory pool, the replay, and the
counters of what a replay runs.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib
import os
import re
import tempfile
import time
import warnings
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.config import CommConfig, H100, HardwareSpec, Scheduling
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class Phase:
    """One schedulable unit: a pure function carry -> carry."""
    name: str
    fn: Callable[[Any], Any]
    is_comm: bool = False


# ----------------------------------------------------------------------
# Counters under a graph
# ----------------------------------------------------------------------

# The kernels' launch counters: (module, attribute), an int or a dict of
# ints (by kernel or by route), every entry of which is counted.
_KERNEL_COUNTERS = (
    ("repro_torch.kernels.swe_step.ops", "launches"),
    ("repro_torch.kernels.quant.ops", "launches"),
    ("repro_torch.kernels.flash_attention.ops", "launches"),
    ("repro_torch.kernels.flash_attention.ops", "route_launches"),
    ("repro_torch.kernels.ssd_scan.ops", "launches"),
)
# Registry counters a replay runs again: the collectives' and the wire's.
_COUNTER_PREFIXES = ("comm.", "wire.")


def _read_counts() -> dict:
    out: dict = {}
    for mod, attr in _KERNEL_COUNTERS:
        c = getattr(importlib.import_module(mod), attr)
        if isinstance(c, dict):
            out.update({(mod, attr, key): v for key, v in c.items()})
        else:
            out[mod, attr, None] = c
    for c in obs_metrics.registry().counters(_COUNTER_PREFIXES):
        out[c] = c.value
    return out


def _add_counts(delta: dict, sign: int = 1) -> None:
    for k, d in delta.items():
        if isinstance(k, obs_metrics.Counter):
            k.inc(sign * d)
            continue
        mod, attr, key = k
        m = importlib.import_module(mod)
        if key is None:
            setattr(m, attr, getattr(m, attr) + sign * d)
        else:
            getattr(m, attr)[key] += sign * d


# ----------------------------------------------------------------------
# Capture
# ----------------------------------------------------------------------

def _tree_map(f, tree):
    """``f`` on every tensor of a tensor / tuple / list / dict tree."""
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(f, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(f, v) for v in tree)
    return tree


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


_KEEP_TOPOLOGY = False


@contextlib.contextmanager
def keeping_topology():
    """Captures made inside this block keep their graph's topology
    (``torch.cuda.CUDAGraph(keep_graph=True)``: the graph is instantiated
    at its first replay), so :meth:`CapturedGraph.node_counts` can read
    what a replay launches."""
    global _KEEP_TOPOLOGY
    was, _KEEP_TOPOLOGY = _KEEP_TOPOLOGY, True
    try:
        yield
    finally:
        _KEEP_TOPOLOGY = was


# A node declaration of ``cudaGraphDebugDotPrint``'s output; its type
# (KERNEL, MEMCPY, MEMSET, EMPTY, ...) is the first word of its label.
_DOT_NODE = re.compile(
    r'^"graph_\d+_node_\d+"\[[^\n]*?label="\{\s*([A-Z_]+)', re.M)


def dot_node_types(dot: str) -> collections.Counter:
    """The nodes of a CUDA graph's DOT dump, counted by type."""
    return collections.Counter(_DOT_NODE.findall(dot))


class CapturedGraph:
    """``fn(*static)`` captured as one CUDA graph on the current device.

    A graph reads its inputs by address: the caller refills ``static`` (the
    tensors ``fn`` reads) in place before each :meth:`replay`, and ``out``
    (what ``fn`` returned during the capture) holds the result until the
    next replay.  This object keeps both alive.

    Construction runs ``fn(*static)`` once eagerly, on a side stream (the
    warm-up: it builds the kernels and fills the plan caches, so that no
    host-to-device copy happens during the capture), or ``warm(*static)``
    when given (a cheaper call that does the same: one step of a segment);
    its result is ``warm``, the answer of the call that built the graph.
    Then it
    captures ``fn(*static)`` into ``pool`` (a handle from another graph's
    ``pool``, which is safe where no graph's result must outlive another's
    replay; a private pool when ``None``).  A capture that fails raises.

    Python counts a launch when it issues it, so the capture adds one
    step's worth to the kernels' ``launches`` counters and to the
    ``comm.*``/``wire.*`` counters without running anything.  That delta is
    taken back after the capture and added again by every replay, which
    emits one span ``span`` with ``captured=True``: the counters count
    what ran.
    """

    def __init__(self, fn: Callable, static: Sequence = (), pool=None,
                 span: str = "graph", warm: Callable | None = None):
        self.fn, self.static, self.span = fn, tuple(static), span
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm = (fn if warm is None else warm)(*self.static)
        main.wait_stream(side)
        # the warm-up's result is read on the caller's stream
        _tree_map(lambda t: t.record_stream(main), warm)
        self.warm = warm
        self.kept = _KEEP_TOPOLOGY
        self.graph = torch.cuda.CUDAGraph(keep_graph=self.kept)
        # A dead reference cycle that holds a CUDA object (another graph, a
        # pool's tensors) and is collected during the capture would make a
        # CUDA call that invalidates it: collect first, then keep the
        # collector off until the capture ends.
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        before = _read_counts()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn(*self.static)
        finally:
            if was_enabled:
                gc.enable()
        after = _read_counts()
        self.counts = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
        _add_counts(self.counts, -1)
        self.replays = 0

    @property
    def pool(self):
        return self.graph.pool()

    def node_counts(self) -> collections.Counter:
        """The graph's nodes by type (``KERNEL``, ``MEMCPY``, ``MEMSET``,
        ...), read from its DOT dump: exactly what one replay launches.
        Needs a capture made under :func:`keeping_topology`."""
        if not self.kept:
            raise RuntimeError("this graph was captured outside "
                               "keeping_topology(): its topology is gone")
        with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
            warnings.simplefilter("ignore")      # debug_dump's own notices
            path = os.path.join(d, "graph.dot")
            self.graph.debug_dump(path)
            with open(path) as f:
                return dot_node_types(f.read())

    def replay(self):
        """Run the graph once (asynchronously) and return ``out``."""
        with obs_trace.span(self.span, cat="graph", captured=True):
            self.graph.replay()
        _add_counts(self.counts)
        self.replays += 1
        return self.out


# ----------------------------------------------------------------------
# Runners
# ----------------------------------------------------------------------

def _on_cuda(tree) -> bool:
    return any(t.is_cuda for t in _leaves(tree))


class HostScheduledRunner:
    """One eager launch sequence (= one host dispatch) per phase, the host
    waiting for the card between phases — the MPI+PCIe-style baseline.

    ``dispatch_count`` feeds the model: step latency includes
    n_dispatches · l_k on top of device time.
    """

    def __init__(self, phases: Sequence[Phase], hw: HardwareSpec = H100):
        self.phases = list(phases)
        self.hw = hw
        self.dispatch_count = 0

    def run_step(self, carry):
        for p in self.phases:
            carry = p.fn(carry)
            if _on_cuda(carry):
                torch.cuda.synchronize()   # host waits between phases
            self.dispatch_count += 1
        return carry

    def modeled_dispatch_overhead(self) -> float:
        return len(self.phases) * self.hw.host_dispatch


class FusedRunner:
    """All phases captured as one CUDA graph — the PL-scheduled analogue.

    On the card the first step (and any step whose carry changes shape or
    dtype) runs the phases eagerly as the warm-up and captures them; every
    other step copies the carry into the graph's static input and replays.
    On the CPU the phases run eagerly.  ``dispatch_count`` counts steps.
    """

    def __init__(self, phases: Sequence[Phase], hw: HardwareSpec = H100):
        self.phases = list(phases)
        self.hw = hw
        self.dispatch_count = 0
        self._graph: CapturedGraph | None = None
        self._sig = None
        fns = [p.fn for p in self.phases]

        def fused(carry):       # holds no reference to self: no cycle
            for f in fns:
                carry = f(carry)
            return carry
        self._fused = fused

    def run_step(self, carry):
        self.dispatch_count += 1
        if not _on_cuda(carry):
            return self._fused(carry)
        sig = [(t.shape, t.dtype, t.device) for t in _leaves(carry)]
        if self._graph is None or sig != self._sig:
            static = _tree_map(torch.clone, carry)
            self._graph = CapturedGraph(self._fused, (static,),
                                        span="scheduler.fused")
            self._sig = sig
            return _tree_map(torch.clone, self._graph.warm)
        (static,) = self._graph.static
        for dst, src in zip(_leaves(static), _leaves(carry)):
            dst.copy_(src)
        return _tree_map(torch.clone, self._graph.replay())

    def modeled_dispatch_overhead(self) -> float:
        n_comm = sum(1 for p in self.phases if p.is_comm)
        return self.hw.host_dispatch + n_comm * self.hw.fused_dispatch


def make_runner(phases: Sequence[Phase], cfg: CommConfig,
                hw: HardwareSpec = H100):
    if cfg.scheduling == Scheduling.HOST:
        return HostScheduledRunner(phases, hw)
    return FusedRunner(phases, hw)


def measure_dispatch_overhead(n: int = 200, device=None) -> float:
    """Calibrate this host's per-dispatch cost (the l_k measurement of
    §3.4): seconds per launch of ``n`` tiny launches on ``device`` (the
    card unless another is named), ending in a synchronize."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    x = torch.zeros((8,), dtype=torch.float32, device=dev)
    x = x + 1          # warm up
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        x = x + 1
    sync()
    return (time.perf_counter() - t0) / n
