"""Model-guided sweep pruning — the paper's calibrated-model search.

The paper does not measure its whole configuration space blindly: the Eq. 1
latency model, calibrated against a handful of measurements, ranks the
candidates and only the plausible ones are benchmarked.  This module closes
that loop for the autotuner: given a :class:`~repro_torch.tune.calibrate.
CalibrationResult` fitted on this substrate, :func:`prune_candidates` drops
every candidate the model predicts to be more than ``ratio``× slower than
the predicted incumbent, cutting full-sweep wall clock while keeping every
config that could plausibly win within measurement noise.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core import latmodel
from repro_torch.core.config import CommConfig, CommMode, Scheduling
from repro_torch.tune.calibrate import CalibrationResult, calibrate_from_db

# Default pruning aggressiveness: skip configs the model ranks > 2x off the
# predicted incumbent.  2x leaves ample headroom for the fit's residuals
# (rms_rel_err is typically well under 0.5 on a clean sweep).
DEFAULT_RATIO = 2.0

# Collectives whose streaming implementation splits the message into wire
# chunks, each an independently scheduled command (chunked_permute /
# pipelined_consume; all_to_all only tiles under overlapped scheduling).
# Ring/native reduction collectives move whole segments — no chunk term.
_CHUNKED_STREAMING = frozenset({"sendrecv", "multi_neighbor"})


def predicted_latency(cfg: CommConfig, msg_bytes: int,
                      calibration: CalibrationResult,
                      collective: str | None = None,
                      hops: int = 1, loss: float = 0.0) -> float:
    """Eq. 1 prediction (seconds) for one candidate on the calibrated
    substrate.

    The chunk-aware ``pingping_latency`` charges one scheduled command per
    wire chunk — what ranks a 64 KiB-segment config far off a jumbo-segment
    incumbent at multi-MiB messages (the paper's segmentation/jumbo-frame
    finding).  Collectives that never split the wire (ring/native reduction
    collectives; all_to_all outside overlapped scheduling) are predicted at
    a single command regardless of ``chunk_bytes``.  ``hops`` is the edge's
    torus hop distance: the route term re-serializes buffered messages per
    hop and wormholes streaming chunks, which is what reorders candidates
    between direct links and routed edges.  ``loss`` is the expected
    chunk-loss rate of the wire: GUARANTEED candidates are surcharged by
    :func:`~repro_torch.core.latmodel.expected_retransmit_factor`, which is
    what lets the pruner rank small segments above jumbo frames on lossy
    links.
    """
    import dataclasses
    hw = calibration.to_hardware_spec()
    chunked = (collective in _CHUNKED_STREAMING
               and cfg.mode == CommMode.STREAMING) or (
        collective == "all_to_all"
        and cfg.mode == CommMode.STREAMING
        and cfg.scheduling == Scheduling.OVERLAPPED)
    if not chunked and cfg.mode == CommMode.STREAMING:
        cfg = dataclasses.replace(cfg, max_chunks=1)
    return latmodel.pingping_latency(msg_bytes, cfg, hw, hops=hops,
                                     loss=loss)


def predicted_e2e(cfg: CommConfig, msg_bytes: int,
                  calibration: CalibrationResult, compute_s: float,
                  collective: str | None = None,
                  hops: int = 1, loss: float = 0.0) -> float:
    """End-to-end consumer-loop prediction (seconds per iteration): the
    overlap-aware Eq. 2 term applied to the consumer, on the calibrated
    substrate.

    ``compute_s`` is the hideable per-iteration compute (the row_parallel
    matmul, the halo interior update).  The overlapped schedule hides the
    calibrated comm latency behind it (``max``), the fused/host schedules
    expose part or all of it — which is what reorders candidates relative
    to :func:`predicted_latency` and lets the sweep prune on the ``e2e``
    objective without measuring every consumer loop.

    Chunking mirrors what the consumer actually executes: all_reduce's
    row_parallel consumer (the JAX package's; the port's comes with its LM
    path) routes EVERY streaming-mode all_reduce through the chunked
    ``overlapped_matmul_allreduce`` (not just overlapped scheduling), so a
    streaming candidate is always priced per wire chunk — otherwise the
    pruner would rank candidates against a program the e2e sweep never
    runs.
    """
    import dataclasses
    hw = calibration.to_hardware_spec()
    chunked = cfg.mode == CommMode.STREAMING and (
        collective in _CHUNKED_STREAMING
        or collective == "all_reduce"
        or cfg.scheduling == Scheduling.OVERLAPPED)
    if not chunked and cfg.mode == CommMode.STREAMING:
        cfg = dataclasses.replace(cfg, max_chunks=1)
    return latmodel.e2e_consumer_latency(msg_bytes, cfg, compute_s, hw,
                                         hops=hops, loss=loss)


def prune_candidates(cands: Sequence[CommConfig], msg_bytes: int,
                     calibration: CalibrationResult,
                     ratio: float = DEFAULT_RATIO,
                     collective: str | None = None,
                     objective: str = "latency",
                     compute_s: float = 0.0,
                     hops: int = 1,
                     loss: float = 0.0
                     ) -> tuple[list[CommConfig], list[CommConfig]]:
    """Split candidates into (measure, skip) by calibrated model ranking.

    A candidate is skipped when the model predicts it to be more than
    ``ratio``× slower than the best predicted candidate (the incumbent).
    The incumbent itself is always kept, so the pruned sweep can never
    select a config the exhaustive sweep would not also have measured.
    ``objective="e2e"`` ranks by :func:`predicted_e2e` (consumer loop with
    ``compute_s`` of hideable compute) instead of bare Eq. 1 latency.
    ``hops`` prices the candidates at the hop distance the sweep is about
    to measure them at (the per-edge axis of a torus sweep); ``loss``
    prices them on a wire losing that share of chunk transmissions.
    """
    if not cands:
        return [], []
    if objective == "e2e":
        preds = [predicted_e2e(c, msg_bytes, calibration, compute_s,
                               collective, hops=hops, loss=loss)
                 for c in cands]
    else:
        preds = [predicted_latency(c, msg_bytes, calibration, collective,
                                   hops=hops, loss=loss) for c in cands]
    best = min(preds)
    kept, skipped = [], []
    for cfg, pred in zip(cands, preds):
        (kept if pred <= ratio * best else skipped).append(cfg)
    return kept, skipped


def calibration_from_db(db, topo: str | None = None
                        ) -> CalibrationResult | None:
    """Fit the Eq. 1 constants from a TuneDB's sendrecv measurements, or
    ``None`` when the DB holds none for this topology (cold cache — the
    sweep then seeds its own calibration set first)."""
    try:
        result = calibrate_from_db(db, topo)
    except ValueError:
        return None
    return result if result.n_points >= 2 else None
