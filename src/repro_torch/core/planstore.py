"""Disk-backed plan store — warm starts across processes (PyTorch port).

The in-process :mod:`repro_torch.core.plans` cache reproduces the ACCL+
resident plan store, but every new CLI invocation, test job and serving
replica starts cold and re-derives every schedule.  This module is the
persistence layer that closes that gap: a versioned, crash-safe, shared
directory of plan entries keyed by the same value scheme the in-memory
cache uses, in the JAX package's layout and schema
(``src/repro/core/planstore.py``), so the two packages' stores read alike.

- **Plan entries** (chunk layouts, edge-color rounds, ring and neighbor
  perms, delivery plans, the aggregate :class:`~repro_torch.core.plans.
  CommPlan`) serialize to one small JSON file each under
  ``<dir>/plans/<kind>-<sha256[:32]>.json``.  Keys are canonicalized to
  pure JSON primitives (``plans._cfg_key`` stamps a schema version and
  folds enum members to their string values) and hashed into the file
  name; the full key is stored in the entry and checked on read, so a hash
  collision or a recycled file can never answer the wrong lookup.
- **Programs stay in memory.**  The JAX package also persists its traced
  programs (serialized XLA executables and JAX's compilation cache), to
  spare a fresh process the trace and the compile.  The port has no
  counterpart, by design: a captured CUDA graph cannot be serialized, so
  the ``"program"`` kind (``plans.captured_program``) lives in memory
  only; the compiled kernel libraries already persist on disk, named by a
  hash of their sources, through ``kernels/_build.py``; and there is no
  trace or XLA compile for a store to skip.

Durability contract:

- **Atomic writes** — entries are written to a unique temp file in the same
  directory and ``os.replace``d into place; a reader never observes a torn
  entry, and two processes racing the same key both land a valid file.
- **Corrupt/stale entries are misses, never crashes** — unparseable JSON, a
  schema-version mismatch, a key mismatch or an undecodable value all count
  ``plans.disk_misses`` (and ``plans.disk_corrupt``), best-effort unlink
  the bad file, and let the caller rebuild and overwrite.
- **Versioning** — every entry embeds :data:`SCHEMA_VERSION`; bumping it (or
  the ``plans._cfg_key`` schema stamp) invalidates the whole store in place.

Activation: set ``REPRO_PLAN_DIR=/path`` (read lazily, so a subprocess
inherits it) or call :func:`configure` (the ``--plan-dir`` CLI flags).
When no directory is configured the module is inert and the plan cache is
memory-only.

Counters (in the :mod:`repro_torch.obs.metrics` registry):
``plans.disk_hits``, ``plans.disk_misses``, ``plans.disk_writes``,
``plans.disk_corrupt``.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Any, Optional

from repro_torch.obs import metrics as obs_metrics

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_PLAN_DIR"

# plans._memo kinds whose values serialize to JSON and persist here
# ("program" is absent: see the module docstring).
DISK_KINDS = frozenset({"chunks", "rounds", "ring", "perm", "plan", "wire"})

#: Sentinel returned by :meth:`PlanStore.get` when no usable entry exists
#: (distinct from a legitimately cached ``None`` value).
MISSING = object()

_LOCK = threading.RLock()
_OVERRIDE: Optional[str] = None      # configure() override; None = env rules
_EXPLICIT = False                    # configure() was called (even with "")
_STORES: dict[str, "PlanStore"] = {}

_DISK_STAT_NAMES = ("disk_hits", "disk_misses", "disk_writes", "disk_corrupt")
_DISK_STATS = {k: obs_metrics.registry().counter(f"plans.{k}")
               for k in _DISK_STAT_NAMES}


def configure(path: os.PathLike | str | None) -> Optional[Path]:
    """Explicitly set the store directory (CLI ``--plan-dir``).

    ``path=None`` clears the override so ``REPRO_PLAN_DIR`` governs again;
    ``path=""`` disables the store even when the env var is set.  Returns
    the resolved directory (None when disabled)."""
    global _OVERRIDE, _EXPLICIT
    with _LOCK:
        _OVERRIDE = str(path) if path is not None else None
        _EXPLICIT = path is not None
    store = active()
    return store.root if store is not None else None


def plan_dir() -> Optional[Path]:
    """The configured store directory: explicit :func:`configure` override
    first, then ``REPRO_PLAN_DIR``; None when neither is set."""
    with _LOCK:
        if _EXPLICIT:
            return Path(_OVERRIDE) if _OVERRIDE else None
    env = os.environ.get(ENV_VAR, "")
    return Path(env) if env else None


def active() -> Optional["PlanStore"]:
    """The live :class:`PlanStore` for the configured directory, or None
    when persistence is off."""
    d = plan_dir()
    if d is None:
        return None
    with _LOCK:
        store = _STORES.get(str(d))
        if store is None:
            store = _STORES[str(d)] = PlanStore(d)
    return store


def disk_stats() -> dict:
    """Current ``plans.disk_*`` counter values."""
    return {k: int(c.value) for k, c in _DISK_STATS.items()}


def reset_disk_stats() -> None:
    for c in _DISK_STATS.values():
        c.reset()


# ----------------------------------------------------------------------
# Key canonicalization
# ----------------------------------------------------------------------

def canonical_key(key: Any) -> str:
    """Deterministic JSON encoding of a plan key.

    Keys are nested tuples of JSON primitives; tuples become lists.
    Anything else raises ``TypeError`` — the caller treats the key as
    non-persistable and stays memory-only rather than writing a lossy
    entry."""
    return json.dumps(_jsonable_key(key), separators=(",", ":"),
                      allow_nan=False)


def _jsonable_key(obj: Any) -> Any:
    if isinstance(obj, (list, tuple)):
        return [_jsonable_key(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"non-serializable plan-key component: {obj!r} "
                    f"({type(obj).__name__})")


def _tuplify(obj: Any) -> Any:
    """Inverse of :func:`_jsonable_key` for values: JSON lists back to the
    tuples the in-memory cache stores."""
    if isinstance(obj, list):
        return tuple(_tuplify(v) for v in obj)
    return obj


# ----------------------------------------------------------------------
# Value (de)serialization per kind
# ----------------------------------------------------------------------

def _encode_value(kind: str, value: Any) -> Any:
    if kind == "chunks":
        return {"n_chunks": value.n_chunks, "chunk_elems": value.chunk_elems,
                "ack_of": list(value.ack_of)}
    if kind == "wire":
        return {"n_chunks": value.n_chunks,
                "slots": [[s.seq, s.action, s.attempt] for s in value.slots],
                "retransmits": value.retransmits,
                "dup_dropped": value.dup_dropped,
                "timeouts": value.timeouts,
                "backoff_holds": value.backoff_holds}
    if kind == "plan":
        # The JAX package's CommPlan fields: the port's plan keeps its
        # rounds as ``perms`` (they are the same tuples there) and has no
        # ring or extras.
        chunks = None
        if value.chunks is not None:
            chunks = _encode_value("chunks", value.chunks)
        return {"collective": value.collective,
                "comm_key": _jsonable_key(value.comm_key),
                "cfg_key": _jsonable_key(value.cfg_key),
                "shape": list(value.shape), "dtype": value.dtype,
                "chunks": chunks, "rounds": _jsonable_key(value.perms),
                "perms": _jsonable_key(value.perms),
                "ring": [], "extra": []}
    # rounds / ring / perm: nested tuples of ints
    return _jsonable_key(value)


def _decode_value(kind: str, payload: Any) -> Any:
    from repro_torch.core import plans
    if kind == "chunks":
        return plans.ChunkPlan(n_chunks=int(payload["n_chunks"]),
                               chunk_elems=int(payload["chunk_elems"]),
                               ack_of=tuple(int(a) for a in payload["ack_of"]))
    if kind == "wire":
        from repro_torch.core import reliable
        return reliable.DeliveryPlan(
            n_chunks=int(payload["n_chunks"]),
            slots=tuple(reliable.Slot(int(s), str(a), int(k))
                        for s, a, k in payload["slots"]),
            retransmits=int(payload["retransmits"]),
            dup_dropped=int(payload["dup_dropped"]),
            timeouts=int(payload["timeouts"]),
            backoff_holds=int(payload["backoff_holds"]))
    if kind == "plan":
        chunks = (None if payload["chunks"] is None
                  else _decode_value("chunks", payload["chunks"]))
        return plans.CommPlan(
            collective=payload["collective"],
            comm_key=_tuplify(payload["comm_key"]),
            cfg_key=_tuplify(payload["cfg_key"]),
            shape=tuple(int(s) for s in payload["shape"]),
            dtype=payload["dtype"], chunks=chunks,
            perms=_tuplify(payload["perms"]))
    return _tuplify(payload)


# ----------------------------------------------------------------------
# The store
# ----------------------------------------------------------------------

class PlanStore:
    """One plan directory of JSON entries.

    Thread-safe within a process; cross-process safety comes from atomic
    replace-on-write — concurrent writers of one key both produce a valid
    file, readers see old or new, never torn."""

    def __init__(self, root: os.PathLike | str):
        self.root = Path(root)
        self.plans_path = self.root / "plans"

    def _entry_path(self, kind: str, canon: str) -> Path:
        digest = hashlib.sha256(
            f"{kind}\x00{canon}".encode()).hexdigest()[:32]
        return self.plans_path / f"{kind}-{digest}.json"

    def get(self, kind: str, key: Any) -> Any:
        """The stored value for ``(kind, key)``, or :data:`MISSING`.

        Every failure mode — absent file, torn/corrupt JSON, schema-version
        mismatch, key mismatch, undecodable value — is a miss: the bad file
        is best-effort removed and the caller rebuilds and overwrites."""
        try:
            canon = canonical_key(key)
        except TypeError:
            return MISSING
        path = self._entry_path(kind, canon)
        try:
            raw = path.read_text()
        except (OSError, UnicodeDecodeError):
            _DISK_STATS["disk_misses"].inc()
            return MISSING
        try:
            entry = json.loads(raw)
            if (entry.get("schema") != SCHEMA_VERSION
                    or entry.get("kind") != kind
                    or entry.get("key") != json.loads(canon)):
                raise ValueError("stale or mismatched entry")
            value = _decode_value(kind, entry["value"])
        except Exception:  # noqa: BLE001 — any bad entry is a rebuildable miss
            _DISK_STATS["disk_corrupt"].inc()
            _DISK_STATS["disk_misses"].inc()
            try:
                path.unlink()
            except OSError:
                pass
            return MISSING
        _DISK_STATS["disk_hits"].inc()
        return value

    def put(self, kind: str, key: Any, value: Any) -> bool:
        """Persist ``value`` under ``(kind, key)`` atomically (a unique temp
        file, then ``os.replace``).  Returns False — without raising — when
        the key or value is not serializable or the filesystem refuses:
        persistence is an optimization, never a failure source."""
        try:
            canon = canonical_key(key)
            payload = {"schema": SCHEMA_VERSION, "kind": kind,
                       "key": json.loads(canon),
                       "value": _encode_value(kind, value)}
            blob = json.dumps(payload, separators=(",", ":"),
                              allow_nan=False)
        except (TypeError, ValueError, AttributeError):
            return False
        path = self._entry_path(kind, canon)
        tmp = path.with_name(
            f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            self.plans_path.mkdir(parents=True, exist_ok=True)
            tmp.write_text(blob)
            os.replace(tmp, path)
        except OSError:
            try:
                tmp.unlink()
            except OSError:
                pass
            return False
        _DISK_STATS["disk_writes"].inc()
        return True

    def entry_count(self) -> int:
        try:
            return sum(1 for _ in self.plans_path.glob("*.json"))
        except OSError:
            return 0

    def clear(self) -> None:
        """Delete every plan entry."""
        try:
            for p in self.plans_path.glob("*.json"):
                try:
                    p.unlink()
                except OSError:
                    pass
        except OSError:
            pass
