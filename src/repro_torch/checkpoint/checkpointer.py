"""Checkpoints with async save, emergency save, and reshard-on-restore
(elastic scaling) — the JAX package's on-disk format.

Format: one ``ckpt_%08d.npz`` per step holding every leaf of an
*unsharded* tree under its ``/``-joined key path (bf16 widened to f32), a
``manifest_%08d.json`` and a terminal ``ckpt_%08d.COMMIT`` marker, each
written atomically (unique tmp + rename), in that order.  A checkpoint
written by the JAX package's ``Checkpointer`` restores here and the other
way round.  The caller passes global arrays (``launch.setup.global_params``
of a session's stacked shards); ``restore(..., reshard=...)`` puts them
back on a session's stacked layout (``launch.setup.stacked_params``) — the
recovery path after losing ranks and re-forming a smaller mesh.

- ``AsyncCheckpointer.save`` snapshots device tensors to host, then writes
  on a background thread (training continues immediately).
- ``emergency_save`` is synchronous and minimal (the preemption drain); it
  can carry the optimizer state under ``<directory>/opt`` so that a
  same-mesh resume continues with the exact Adam moments.
- ``latest_step`` skips a torn step (an array file without its ``COMMIT``
  marker), counting it once in ``ckpt.skipped_partial``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics


def _flatten_with_names(tree, prefix: tuple = ()):
    """``(names, leaves)`` in sorted-key order (``jax.tree.flatten``'s)."""
    if isinstance(tree, dict):
        names, leaves = [], []
        for k in sorted(tree):
            n, l = _flatten_with_names(tree[k], prefix + (str(k),))
            names += n
            leaves += l
        return names, leaves
    return ["/".join(prefix)], [tree]


def _unflatten_like(like, values: dict, prefix: tuple = ()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, values, prefix + (str(k),))
                for k, v in like.items()}
    return values["/".join(prefix)]


def _to_numpy_storable(a) -> np.ndarray:
    """A host copy (never a view of a CPU tensor: the async save writes it
    while training goes on); npz cannot store bfloat16: widen it to
    float32."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            return a.float().cpu().numpy()
        return a.cpu().numpy().copy() if a.device.type == "cpu" \
            else a.cpu().numpy()
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiub?" or str(arr.dtype) == "bfloat16":
        return arr.astype(np.float32)
    return arr


class Checkpointer:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # torn steps already counted by this instance
        self._counted_partial: set[int] = set()

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.npz"

    def _commit_path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.COMMIT"

    def _write_payload(self, step: int, names, host, extra: Optional[dict]):
        """npz, then manifest, then the COMMIT marker — each atomically,
        in that order, so the marker implies the whole step is durable."""
        tag = f"{os.getpid()}.{threading.get_ident()}"
        tmp = self._path(step).with_suffix(f".{tag}.tmp.npz")
        np.savez(tmp, **{n: a for n, a in zip(names, host)})
        os.replace(tmp, self._path(step))
        manifest = {"step": step, "names": names,
                    "time": time.time(), **(extra or {})}
        mtmp = self.dir / f"manifest_{step:08d}.{tag}.tmp"
        mtmp.write_text(json.dumps(manifest))
        os.replace(mtmp, self.dir / f"manifest_{step:08d}.json")
        ctmp = self._commit_path(step).with_suffix(f".{tag}.ctmp")
        ctmp.write_text(json.dumps({"step": step, "time": time.time()}))
        os.replace(ctmp, self._commit_path(step))

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        names, leaves = _flatten_with_names(tree)
        host = [_to_numpy_storable(l) for l in leaves]
        self._write_payload(step, names, host, extra)

    def latest_step(self) -> Optional[int]:
        """Newest committed step; a step without its ``COMMIT`` marker is
        skipped (counted once per instance in ``ckpt.skipped_partial``)."""
        steps = set()
        for p in self.dir.glob("ckpt_*.npz"):
            try:
                steps.add(int(p.stem.split("_")[1]))
            except ValueError:
                continue   # a leaked tmp file, not a checkpoint
        for step in sorted(steps, reverse=True):
            if self._commit_path(step).exists():
                return step
            if step not in self._counted_partial:
                self._counted_partial.add(step)
                obs_metrics.registry().counter("ckpt.skipped_partial").inc()
        return None

    def restore(self, step: int, like: Any,
                reshard: Optional[Callable[[Any], Any]] = None) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors or
        arrays giving names and dtypes): tensors on each ``like`` tensor's
        device in its dtype (cast there), else CPU tensors; ``reshard``
        then maps the full tree onto a layout (the elastic-recovery path).
        Names in the file that ``like`` lacks (a drained optimizer state)
        are ignored."""
        with np.load(self._path(step)) as data:
            names, leaves = _flatten_with_names(like)
            out = {}
            for n, leaf in zip(names, leaves):
                arr = data[n]
                if isinstance(leaf, torch.Tensor):
                    arr = torch.from_numpy(arr).to(leaf.device).to(leaf.dtype)
                else:
                    if hasattr(leaf, "dtype"):
                        arr = arr.astype(leaf.dtype)
                    arr = torch.from_numpy(arr)
                out[n] = arr
        tree = _unflatten_like(like, out)
        return reshard(tree) if reshard is not None else tree


class AsyncCheckpointer(Checkpointer):
    """Snapshot to host synchronously, write on a background thread."""

    def __init__(self, directory):
        super().__init__(directory)
        self._thread: Optional[threading.Thread] = None
        self.pending = 0
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        names, leaves = _flatten_with_names(tree)
        host = [_to_numpy_storable(l) for l in leaves]   # synchronous
        with self._lock:
            self.pending += 1

        def _write():
            try:
                self._write_payload(step, names, host, extra)
            finally:
                with self._lock:
                    self.pending -= 1

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()


def emergency_save(directory, step: int, tree: Any, opt_state: Any = None):
    """Synchronous minimal-latency save for preemption handlers; with
    ``opt_state`` the optimizer state rides along under
    ``<directory>/opt``, so a same-mesh resume is bitwise-continuous."""
    ck = Checkpointer(directory)
    ck.save(step, tree, extra={"emergency": True})
    if opt_state is not None:
        Checkpointer(Path(directory) / "opt").save(
            step, opt_state, extra={"emergency": True})
    return ck._path(step)
