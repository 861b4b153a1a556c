"""ACCL-X autotuner (PyTorch port) — measured configuration-space search
for CommConfig.

The paper's method: sweep the communication framework's configuration space
with synthetic microbenchmarks, calibrate the latency model against the
measurements, and use the findings to configure the application.

- :mod:`repro_torch.tune.space`     — enumerate valid ``CommConfig``
  candidates (the JAX package's candidate lists).
- :mod:`repro_torch.tune.sweep`     — measured microbenchmarks per
  collective and message size on stacked ranks;
  ``python -m repro_torch.tune.sweep``.
- :mod:`repro_torch.tune.calibrate` — fit the Eq. 1 constants from sweep
  measurements; model-vs-measured report.
- :mod:`repro_torch.tune.prune`     — model-guided pruning of the sweep.
- :mod:`repro_torch.tune.db`        — the persistent ``TuneDB`` JSON store
  (the JAX package's format) and ``select_config``, behind
  ``comm_cfg="auto"``.
"""
from repro_torch.tune.space import (config_from_dict, config_to_dict,
                                    enumerate_configs, space_size)
from repro_torch.tune.db import (TuneDB, TuneEntry, default_db_path,
                                 select_config, topology_key)
from repro_torch.tune.calibrate import (CalibrationResult, calibrate_from_db,
                                        fit_latency_model, model_vs_measured)
from repro_torch.tune.prune import (calibration_from_db, predicted_e2e,
                                    predicted_latency, prune_candidates)


def run_sweep(*args, **kwargs):
    """Lazy forward to :func:`repro_torch.tune.sweep.run_sweep` (keeps
    ``python -m repro_torch.tune.sweep`` free of a double-import warning)."""
    from repro_torch.tune.sweep import run_sweep as _run_sweep
    return _run_sweep(*args, **kwargs)


__all__ = [
    "CalibrationResult", "TuneDB", "TuneEntry", "calibrate_from_db",
    "calibration_from_db", "config_from_dict", "config_to_dict",
    "default_db_path", "enumerate_configs", "fit_latency_model",
    "model_vs_measured", "predicted_e2e", "predicted_latency",
    "prune_candidates", "run_sweep", "select_config", "space_size",
    "topology_key",
]
