"""Model-based config re-selection for the elastic runtime — no cold resweep.

When the fabric changes under a running job (a rank dies and the survivors
re-form on a smaller torus; a link degrades and routes lengthen), the
previously selected CommConfigs are stale: they were measured at hop
distances and link costs that no longer exist.  The paper's answer to "which
config is fastest *here*?" is a sweep — but a sweep mid-recovery costs
seconds to minutes of wall clock exactly when the job is down.  This module
is the cheap path: **extrapolate the calibrated Eq. 1 model over the TuneDB**
instead of re-measuring.

:func:`model_reselect` fits the Eq. 1 constants from the DB's existing
measurements (:func:`repro_torch.tune.prune.calibration_from_db` →
``fit_latency_model``), then re-ranks every config the DB has *ever measured*
for the collective at the **new** hop distance / link slowdown, and returns
the predicted winner.  No microbenchmark runs; the only inputs are the fitted
constants and the new fabric's geometry.  Recovery-time selection is
milliseconds instead of a resweep, and tests assert ``sweep.runs`` stays flat
across it.

A degraded link is priced by scaling the calibration's wire constants
(``link_bw / slowdown``, ``hop_latency * slowdown``): the model then reorders
candidates the same way the physical hold-round emulation slows them down.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.config import (CommConfig, OPTIMIZED_CONFIG, Reliability,
                               Scheduling)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.tune.calibrate import CalibrationResult
from repro_torch.tune.db import TuneDB, select_config
from repro_torch.tune.prune import (calibration_from_db, predicted_e2e,
                              predicted_latency)
from repro_torch.tune.space import config_from_dict


def degraded_calibration(calibration: CalibrationResult,
                         slowdown: float) -> CalibrationResult:
    """The calibrated substrate with one link's slowdown priced in: wire
    bandwidth divided and per-hop latency multiplied by ``slowdown``."""
    s = max(1.0, float(slowdown))
    if s == 1.0:
        return calibration
    return dataclasses.replace(calibration,
                               link_bw=calibration.link_bw / s,
                               hop_latency=calibration.hop_latency * s)


def _measured_configs(db: TuneDB, collective: str) -> list[CommConfig]:
    """Every distinct config the DB has measured for ``collective`` (any
    size / hop distance / torus) — the re-selection candidate set.  Only
    measured configs are candidates: the model interpolates constants, not
    trust — a config nobody ever ran should not win on extrapolation alone."""
    seen: dict[tuple, CommConfig] = {}
    for e in db.entries:
        if e.collective != collective:
            continue
        key = tuple(sorted(e.config.items()))
        if key not in seen:
            seen[key] = config_from_dict(e.config)
    return list(seen.values())


def model_reselect(collective: str, msg_bytes: int, *,
                   db: TuneDB,
                   hops: int = 1,
                   objective: str = "latency",
                   compute_s: float = 0.0,
                   link_slowdown: float = 1.0,
                   loss: float = 0.0,
                   calibration: Optional[CalibrationResult] = None,
                   topo: Optional[str] = None,
                   fallback: CommConfig = OPTIMIZED_CONFIG) -> CommConfig:
    """Re-select a config for a fabric the sweep never measured.

    Fits (or reuses) the Eq. 1 calibration from ``db``, prices every config
    the DB measured for ``collective`` at the new ``hops`` / ``msg_bytes`` /
    ``link_slowdown``, and returns the predicted winner.  Falls back to the
    measured :func:`~repro_torch.tune.db.select_config` lookup when the DB is too
    cold to calibrate (< 2 points) — still no sweep, just nearest-measured.

    ``objective="e2e"`` ranks by the consumer-loop prediction with
    ``compute_s`` of hideable compute (Eq. 2), mirroring the sweep's own
    ``--objective e2e``.

    ``loss`` > 0 re-selects for a LOSSY wire: every candidate is promoted
    to ``Reliability.GUARANTEED`` (best-effort delivery cannot survive
    chunk loss) and priced with the Eq. 1 retransmit surcharge — which is
    what flips the winner from jumbo frames to small segments when the
    fabric starts dropping chunks.  Measured-DB fallbacks prefer entries
    swept at a matching loss rate.
    """
    if objective not in ("latency", "e2e"):
        raise ValueError(f"objective must be 'latency' or 'e2e', "
                         f"got {objective!r}")
    reg = obs_metrics.registry()
    reg.counter("tune.model_reselects", collective=collective).inc()
    if calibration is None:
        calibration = calibration_from_db(db, topo)
    loss = max(0.0, float(loss))
    loss_pref = loss if loss > 0.0 else None
    if calibration is None:
        # Cold DB: nothing to fit.  Nearest-measured lookup (or the paper's
        # OPTIMIZED_CONFIG on a fully cold cache) — never a sweep.
        reg.counter("tune.reselect_cold_fallbacks").inc()
        return _harden(select_config(collective, msg_bytes, db=db, topo=topo,
                                     hops=hops, objective=objective,
                                     loss=loss_pref, fallback=fallback), loss)
    cands = _measured_configs(db, collective)
    if loss > 0.0:
        promoted, seen = [], set()
        for c in cands:
            g = dataclasses.replace(c, reliability=Reliability.GUARANTEED)
            if g not in seen:
                seen.add(g)
                promoted.append(g)
        cands = promoted
    if not cands:
        reg.counter("tune.reselect_cold_fallbacks").inc()
        return _harden(select_config(collective, msg_bytes, db=db, topo=topo,
                                     hops=hops, objective=objective,
                                     loss=loss_pref, fallback=fallback), loss)
    cal = degraded_calibration(calibration, link_slowdown)
    hops = max(1, int(hops))
    if objective == "e2e":
        preds = [predicted_e2e(c, msg_bytes, cal, compute_s, collective,
                               hops=hops, loss=loss) for c in cands]
    else:
        preds = [predicted_latency(c, msg_bytes, cal, collective, hops=hops,
                                   loss=loss) for c in cands]
    return cands[min(range(len(cands)), key=preds.__getitem__)]


def _harden(cfg: CommConfig, loss: float) -> CommConfig:
    """Promote a fallback-selected config to guaranteed delivery when the
    wire is lossy — the selection layer must never hand a best-effort
    config to a fabric that drops chunks."""
    if loss > 0.0 and cfg.reliability != Reliability.GUARANTEED:
        return dataclasses.replace(cfg, reliability=Reliability.GUARANTEED)
    return cfg


def reselect_round_configs(rounds: Sequence[Sequence[tuple]], comm,
                           msg_bytes: int, *,
                           db: TuneDB,
                           objective: str = "latency",
                           compute_s: float = 0.0,
                           loss: float = 0.0,
                           calibration: Optional[CalibrationResult] = None,
                           topo: Optional[str] = None,
                           fallback: CommConfig = OPTIMIZED_CONFIG
                           ) -> tuple[CommConfig, Optional[list[CommConfig]]]:
    """Model-reselect a whole exchange pattern on a new/degraded fabric.

    The elastic twin of the SWE driver's per-round selection: one config per
    exchange round at that round's worst-case hop distance **and** worst
    traversed link slowdown (degraded hops re-rank candidates the same way
    longer routes do), all priced by the calibrated model.  Returns
    ``(representative_cfg, round_cfgs-or-None)`` with the same conventions as
    ``build_simulation``: the representative is the worst-hop round's winner,
    per-round configs share its scheduling discipline, and ``None`` means the
    uniform config is already right for every round.
    """
    spec = getattr(comm, "topo", None)
    if calibration is None:
        calibration = calibration_from_db(db, topo)

    def round_slowdown(perm) -> float:
        if spec is None or not getattr(spec, "link_slowdowns", None):
            return 1.0
        from repro_torch.core.topology import route
        worst = 1.0
        for s, d in perm:
            if s == d:
                continue
            path = route(spec, int(s), int(d))
            for i in range(len(path) - 1):
                worst = max(worst, spec.link_slowdown(path[i], path[i + 1]))
        return worst

    per_round = []
    worst_key = (0, 1.0)
    for perm in rounds:
        hops = max(1, comm.max_hops(perm))
        slow = round_slowdown(perm)
        cfg = model_reselect("multi_neighbor", msg_bytes, db=db, hops=hops,
                             objective=objective, compute_s=compute_s,
                             link_slowdown=slow, loss=loss,
                             calibration=calibration,
                             topo=topo, fallback=fallback)
        per_round.append(cfg)
        worst_key = max(worst_key, (hops, slow))

    if not per_round:
        rep = model_reselect("multi_neighbor", msg_bytes, db=db, hops=1,
                             objective=objective, compute_s=compute_s,
                             loss=loss, calibration=calibration, topo=topo,
                             fallback=fallback)
        return rep, None
    # Representative = the worst (hops, slowdown) round's winner; unify
    # scheduling so the step keeps one discipline (as build_simulation does).
    worst_i = max(range(len(rounds)),
                  key=lambda i: (max(1, comm.max_hops(rounds[i])),
                                 round_slowdown(rounds[i])))
    rep = per_round[worst_i]
    if rep.scheduling == Scheduling.OVERLAPPED:
        # The double-buffered engine pipelines all rounds under one config.
        return rep, None
    per_round = [dataclasses.replace(c, scheduling=rep.scheduling)
                 for c in per_round]
    if all(c == rep for c in per_round):
        return rep, None
    return rep, per_round
