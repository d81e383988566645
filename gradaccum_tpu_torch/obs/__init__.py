"""Observability: structured spans, a metrics registry, a crash flight
recorder and the live ops plane (the port of ``gradaccum_tpu/obs/``).

- ``trace`` — span tracer emitting Chrome/Perfetto trace-event JSON with
  logical (``args.seq``) and clock (``ts``) timestamps; deterministic mode
  produces byte-identical traces under a logical clock.
- ``metrics`` — counters/gauges/histograms with JSON snapshots and
  Prometheus text export, bridging to the TensorBoard ``EventWriter``.
- ``flight`` — the tracer's ring dumped to ``model_dir/flightrec/`` on a
  crash or a SIGTERM drain.

All three are host-side (no device syncs) and a strict no-op under
``GRADACCUM_OBS=0``. The live ops plane stands on them:

- ``telemetry`` — embedded HTTP endpoints (``/metrics``, ``/healthz``,
  ``/readyz``, ``/varz``, ``/trace``, ``/slo``, ``/sentinel``), off by
  default, stdlib only;
- ``slo`` — sliding-window objectives evaluated as multi-window burn-rate
  alerts, deterministic under a logical clock;
- ``sentinel`` — rolling-baseline anomaly detection (latency cliffs,
  heartbeat leases, loss-scale storms, draft, preemption and tier rates)
  wired to pluggable remediation (``resilience/remediation.py``).

``examples/slo_check.py`` replays SLO specs against recorded traces;
``examples/bench_slo.py`` measures the ops plane's per-tick cost.
"""

from gradaccum_tpu_torch.obs.flight import FlightRecorder
from gradaccum_tpu_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from gradaccum_tpu_torch.obs.sentinel import Anomaly, Sentinel
from gradaccum_tpu_torch.obs.slo import (
    Objective,
    SLOEvaluator,
    default_serving_objectives,
    default_training_objectives,
)
from gradaccum_tpu_torch.obs.telemetry import TelemetryServer
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
    "Anomaly",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL",
    "NullTracer",
    "Objective",
    "SLOEvaluator",
    "Sentinel",
    "TelemetryServer",
    "Tracer",
    "default_serving_objectives",
    "default_training_objectives",
    "get_tracer",
    "installed",
    "obs_enabled",
    "set_tracer",
]
