"""Telemetry: metrics registry, Prometheus exposition, request tracing, the
flight recorder, the phase clock, the device-memory ledger and SLOs.

Counterpart of ``kubernetesclustercapacity_tpu/telemetry/``, for the
capacity service.  Every layer of the service records counters, gauges
and latency histograms into a :class:`~.metrics.MetricsRegistry`, whose
``snapshot()`` rides the service's ``info`` op; :mod:`.tracing` and
:mod:`.tracectx` carry per-request trace and span ids through the
protocol envelope; :mod:`.flightrec` keeps the last requests for
post-incident dumps; :mod:`.phases` splits each request's latency into
named phases; :mod:`.memledger` books the device tensors the service
keeps resident; :mod:`.compilewatch` splits each kernel label's first
dispatch (its build or load) from the steady state; :mod:`.exposition`
serves the registry as Prometheus text with ``/healthz``;
:mod:`.process` adds the process gauges; :mod:`.hostmem` attributes the
process's resident memory to its set-up milestones and to each route's
first dispatch; :mod:`.slo` turns the request metrics into error-budget
burn rates; :mod:`.profiler` samples every
thread's stack joined to the live phase table; :mod:`.traceview` stitches
per-process span logs into one trace tree and its critical path.

Hot-path rule: all instrumentation lives on the host around kernel
dispatch, and the dispatch-side hooks honor :func:`~.metrics.enabled` so
telemetry can be switched off entirely (``KCCAP_TELEMETRY=0``).
"""

from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS_S,
    REGISTRY,
    SUB_MS_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    enabled,
)
from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (  # noqa: F401
    MetricsServer,
    render_text,
    start_metrics_server,
)
from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (  # noqa: F401
    Span,
    TraceLog,
    new_span_id,
    new_trace_id,
)
from kubernetesclustercapacity_tpu_torch.telemetry.flightrec import (  # noqa: F401
    FlightRecorder,
    args_digest,
    result_digest,
)
from kubernetesclustercapacity_tpu_torch.telemetry.phases import (  # noqa: F401
    NULL_CLOCK,
    PHASES,
    PhaseClock,
    new_clock,
)

# NOTE: .slo is a deliberate non-export, as in the JAX package — it rides
# the timeline's alert machine; consumers import
# kubernetesclustercapacity_tpu_torch.telemetry.slo directly.
