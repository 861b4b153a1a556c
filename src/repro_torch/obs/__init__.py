"""ACCL-X observability for the PyTorch port: comm-event tracing + metrics.

- :mod:`repro_torch.obs.trace`   — low-overhead span tracer (``REPRO_TRACE``
  env gate, thread-safe ring buffer, Chrome ``trace_event`` export).
- :mod:`repro_torch.obs.metrics` — always-on registry of counters, gauges and
  fixed-bucket latency histograms (plan-cache hit/miss, bytes per edge,
  rounds per exchange).

Span and counter names are those of the JAX package (``swe.exchange``,
``wire.chunk``, ``comm.exchange_rounds``, ...).
"""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import registry
from repro_torch.obs.trace import configure, enabled, events, flush, instant, span

__all__ = ["configure", "enabled", "events", "flush", "instant", "metrics",
           "registry", "span", "trace"]
