"""Serving observability (the port's copy of ``repro.obs``): the metrics
registry, the request-lifecycle event log, the per-step audit records, and
the latency/throughput report and Chrome trace built from a dump. The
modules are pure Python; the port keeps its own copy so that it imports
nothing of the reference package.

* ``repro_torch.obs.schema`` — the ONE metric/event vocabulary (names,
  labels, histogram boundaries, step-record fields), equal to the
  reference's. The registry and the event log are schema-strict; a name
  outside the schema raises at the call site.
* ``repro_torch.obs.metrics`` — dependency-free ``MetricsRegistry``
  (monotone counters, gauges, fixed-boundary histograms) with
  Prometheus-text and JSON exporters.
* ``repro_torch.obs.events`` — bounded structured event log: every request
  span point carries the monotone step index and a timestamp.
* ``repro_torch.obs.observer`` — ``Observability``, the facade the engine
  holds (registry + events + rolling per-step audit records); ``NullObs``
  is the disabled twin for overhead A/Bs.
* ``repro_torch.obs.trace`` — Chrome trace-event (Perfetto-loadable)
  export of the step timeline segmented by config and dp row.
* ``repro_torch.obs.report`` — TTFT/TPOT/queue/E2E percentiles and the
  latency-vs-throughput tables, from a dump.
"""
from . import schema
from .events import EventLog
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, \
    merge_snapshots
from .observer import Observability, NullObs
from .report import build_report, format_report, latency_throughput_table
from .trace import chrome_trace, write_chrome_trace

__all__ = ["schema", "EventLog", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "merge_snapshots", "Observability", "NullObs",
           "build_report", "format_report", "latency_throughput_table",
           "chrome_trace", "write_chrome_trace"]
