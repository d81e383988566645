"""Observability: structured spans, a metrics registry and a crash flight
recorder (the port of ``gradaccum_tpu/obs/``, its training half).

- ``trace`` — span tracer emitting Chrome/Perfetto trace-event JSON with
  logical (``args.seq``) and clock (``ts``) timestamps; deterministic mode
  produces byte-identical traces under a logical clock.
- ``metrics`` — counters/gauges/histograms with JSON snapshots and
  Prometheus text export, bridging to the TensorBoard ``EventWriter``.
- ``flight`` — the tracer's ring dumped to ``model_dir/flightrec/`` on a
  crash or a SIGTERM drain.

All three are host-side (no device syncs) and a strict no-op under
``GRADACCUM_OBS=0``. JAX's ``slo``, ``sentinel`` and ``telemetry`` belong to
the serving stack and are not ported yet (ROADMAP.md).
"""

from gradaccum_tpu_torch.obs.flight import FlightRecorder
from gradaccum_tpu_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from gradaccum_tpu_torch.obs.trace import (
    NULL,
    NullTracer,
    Tracer,
    get_tracer,
    installed,
    obs_enabled,
    set_tracer,
)

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL",
    "NullTracer",
    "Tracer",
    "get_tracer",
    "installed",
    "obs_enabled",
    "set_tracer",
]
