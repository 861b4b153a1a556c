"""Resilience runtime of the PyTorch port.

- :mod:`repro_torch.runtime.faults`          — seeded fault schedules, the
  injector and the degradation monitor.
- :mod:`repro_torch.runtime.fault_tolerance` — step watchdog, preemption
  guard, the survivors' torus.
- :mod:`repro_torch.runtime.elastic`         — the elastic SWE runtime and
  its kill-and-resume CLI (``python -m repro_torch.runtime.elastic``).
"""
