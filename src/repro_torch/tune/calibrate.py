"""Fit the Eq. 1 latency-model constants from sweep measurements.

The paper calibrates its model (l_k = 30 us XRT dispatch, 12.5 GB/s QSFP
link, global-memory staging cost) by measuring the running system; this module
does the same for whatever substrate the sweep ran on.  The pingping model
(at hop distance h, with wire chunks pipelining across the route — see
:func:`repro_torch.core.latmodel.pingping_latency`)

    buffered : t = 2*l_k + l0 + (h-1)*l_hop + h*wire/bw + 2*msg/bw_mem
    streaming: t = n*l_k + l0 + (h-1)*l_hop + (n+h-1)*(wire/n)/bw

is linear in the unknowns (l_k_host, l_k_fused, l0, 1/bw, 2/bw_mem, l_hop),
so a least-squares fit over the measured (config, size, seconds[, hops])
points recovers them directly.  The per-hop term is only resolvable when the
sweep measured more than one hop distance (the ``--hop-distances`` axis on a
virtual torus); a single-distance sweep keeps the hardware default.
``CalibrationResult.to_hardware_spec`` rebuilds a ``HardwareSpec`` whose
Eq. 1-3 predictions track the measured substrate, and ``model_vs_measured``
reports the residuals per point.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import latmodel
from repro_torch.core.config import (CommConfig, CommMode, H100,
                                     HardwareSpec, Scheduling)

# One measurement point: (config, message bytes, measured seconds per op)
# with an optional trailing hop distance (defaults to 1 — a direct link).
Measurement = tuple


def _point(m: Measurement) -> tuple[CommConfig, int, float, int]:
    cfg, size, sec = m[0], m[1], m[2]
    hops = int(m[3]) if len(m) > 3 else 1
    return cfg, size, sec, hops


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Fitted Eq. 1 constants for the measured substrate."""
    l_k_host: float       # s per host-scheduled dispatch (paper: ~30 us XRT)
    l_k_fused: float      # s per in-program issue (paper: sub-us PL)
    link_latency: float   # s base latency per message (l0)
    link_bw: float        # B/s effective wire bandwidth
    staging_bw: float     # B/s effective staging (HBM write+read) bandwidth
    n_points: int         # measurements used
    rms_rel_err: float    # fit quality over those points
    # Per-extra-hop latency (the paper's direct-link vs switch delta); fitted
    # only when the measurements span > 1 hop distance, else the default.
    hop_latency: float = H100.ici_hop_latency

    def to_hardware_spec(self, base: HardwareSpec = H100,
                         name: str = "calibrated") -> HardwareSpec:
        """A HardwareSpec whose latmodel predictions match the measurements."""
        return dataclasses.replace(
            base, name=name,
            host_dispatch=self.l_k_host, fused_dispatch=self.l_k_fused,
            ici_latency=self.link_latency, ici_bw=self.link_bw,
            hbm_bw=self.staging_bw, ici_hop_latency=self.hop_latency)

    def summary(self) -> str:
        return ("calibrated: "
                f"l_k(host)={self.l_k_host*1e6:.1f}us "
                f"l_k(fused)={self.l_k_fused*1e6:.2f}us "
                f"link_lat={self.link_latency*1e6:.2f}us "
                f"hop_lat={self.hop_latency*1e6:.2f}us "
                f"link_bw={self.link_bw/1e9:.2f}GB/s "
                f"staging_bw={self.staging_bw/1e9:.2f}GB/s "
                f"(n={self.n_points}, rms_rel_err={self.rms_rel_err:.2f})")


def _design_row(cfg: CommConfig, msg_bytes: int, hops: int = 1) -> np.ndarray:
    """Coefficients of [l_k_host, l_k_fused, l0, 1/bw, 2/bw_mem, l_hop].

    The command count is ``latmodel.n_commands``: 2 for buffered (staging
    write + read-back), one per wire chunk for streaming — and the wire
    coefficient carries the route term (store-and-forward re-serialization
    for buffered, chunk wormholing for streaming) — keeping the fit
    consistent with the hop-aware ``pingping_latency`` so the pruning
    model's predictions live on the same surface the constants were fitted
    on."""
    h = max(1, int(hops))
    n_k = latmodel.n_commands(msg_bytes, cfg)
    host = n_k if cfg.scheduling == Scheduling.HOST else 0.0
    # overlapped is device-scheduled like fused: same in-program issue cost
    fused = n_k if cfg.scheduling != Scheduling.HOST else 0.0
    wire = latmodel.wire_bytes(msg_bytes, cfg)
    if cfg.mode == CommMode.BUFFERED:
        wire = h * wire
        staging = float(msg_bytes)
    else:
        wire = (n_k + h - 1) * (wire / n_k)
        staging = 0.0
    return np.array([host, fused, 1.0, wire, staging, float(h - 1)])


def fit_latency_model(measurements: Sequence[Measurement]) -> CalibrationResult:
    """Least-squares fit of the Eq. 1 constants; raises on an empty input."""
    if not measurements:
        raise ValueError("no measurements to calibrate from")
    points = [_point(m) for m in measurements]
    A = np.stack([_design_row(cfg, size, hops)
                  for cfg, size, _, hops in points])
    t = np.array([sec for _, _, sec, _ in points], dtype=np.float64)
    multi_hop = len({h for _, _, _, h in points}) > 1
    hop_offset = np.zeros_like(t)
    if not multi_hop:
        # The hop column is the constant h-1 — collinear with l0, so a
        # single-distance sweep can't resolve it.  Price the hops at the
        # retained default instead (any residual lands in l0), so predicting
        # at hops=h doesn't add the default on top of an l0 that already
        # absorbed the hop cost.
        h0 = max(1, points[0][3])
        hop_offset += (h0 - 1) * CalibrationResult.hop_latency
        A = A[:, :5]
    coef, *_ = np.linalg.lstsq(A, t - hop_offset, rcond=None)
    coef = np.maximum(coef, 0.0)   # latencies/inverse-bandwidths are physical
    pred = A @ coef + hop_offset
    rel = (pred - t) / np.maximum(t, 1e-12)
    # A zero inverse-bandwidth coefficient means the size term was not
    # resolvable from these points (overhead-dominated substrate): report the
    # bandwidth as infinite, which latmodel handles (size/inf == 0).
    return CalibrationResult(
        l_k_host=float(coef[0]), l_k_fused=float(coef[1]),
        link_latency=float(coef[2]),
        link_bw=float(1.0 / coef[3]) if coef[3] > 0 else float("inf"),
        staging_bw=float(2.0 / coef[4]) if coef[4] > 0 else float("inf"),
        n_points=len(points),
        rms_rel_err=float(np.sqrt(np.mean(rel ** 2))),
        hop_latency=(float(coef[5]) if multi_hop
                     else CalibrationResult.hop_latency))


def measurements_from_db(db, topo: str | None = None,
                         collective: str = "sendrecv") -> list[Measurement]:
    """Pingpong-style points from a TuneDB (the Eq. 1 calibration set).
    Each entry's measured hop distance rides along, so a hop-distance sweep
    resolves the per-hop constant."""
    return [(e.comm_config, e.msg_bytes, e.us_per_call * 1e-6, e.hops)
            for e in db.candidates(collective, topo)]


def calibrate_from_db(db, topo: str | None = None,
                      collective: str = "sendrecv") -> CalibrationResult:
    return fit_latency_model(measurements_from_db(db, topo, collective))


def model_vs_measured(result: CalibrationResult, db,
                      topo: str | None = None,
                      collective: str = "sendrecv") -> list[str]:
    """Human-readable modeled-vs-measured report rows."""
    hw = result.to_hardware_spec()
    rows = []
    for cfg, size, sec, hops in (
            _point(m) for m in measurements_from_db(db, topo, collective)):
        modeled = latmodel.pingping_latency(size, cfg, hw, hops=hops)
        rows.append(
            f"{collective} {size:>8d}B h{hops} {cfg.mode.value:9s}/"
            f"{cfg.scheduling.value:5s} measured={sec*1e6:9.1f}us "
            f"modeled={modeled*1e6:9.1f}us ratio={modeled/max(sec,1e-12):5.2f}")
    return rows
