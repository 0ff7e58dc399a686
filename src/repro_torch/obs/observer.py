"""``Observability``: the one instrumentation surface an emitter holds.

Bundles the schema-strict :class:`~repro_torch.obs.metrics.MetricsRegistry`,
the :class:`~repro_torch.obs.events.EventLog`, and the rolling window of
per-step audit records. ``ShiftEngine`` drives exactly this object, as the
reference's emitters drive theirs, which keeps one metric schema.

``record_step`` is the single source of truth for per-step bookkeeping:
each record carries the monotone step index and the duration *inside* the
record (so rolling-window trimming can never desynchronize a ``step_times``
list from a ``step_log`` list again), and the standard counters/histograms
(steps_total{config}, token totals, step_seconds, ...) are derived from the
record right there instead of being maintained in parallel at call sites.

``NullObs`` is the disabled twin — same API, no recording — used for the
instrumented-vs-uninstrumented overhead A/B (``obs.overhead_ratio``).
"""
from __future__ import annotations

import json
import time
from typing import List, Optional

from . import schema
from .events import EventLog
from .metrics import MetricsRegistry

DEFAULT_STEP_WINDOW = 1024


class Observability:
    def __init__(self, source: str, window: int = DEFAULT_STEP_WINDOW,
                 now=time.monotonic, event_cap: int = 65536):
        self.source = source          # "engine" | "sim" (stamped in dumps)
        self.window = window
        self.now = now
        self.registry = MetricsRegistry()
        self.events = EventLog(cap=event_cap)
        self.step_records: List[dict] = []
        self.enabled = True
        # cluster replica id (None standalone). Set once by the Router via
        # the engine facade; stamped centrally on every step record and
        # event so no call site needs to thread it through.
        self.replica: Optional[int] = None

    # ------------------------------------------------------------- steps
    def record_step(self, rec: dict) -> dict:
        """Append one per-iteration audit record (schema-checked) and
        derive the standard step metrics from it."""
        if self.replica is not None:
            rec.setdefault("replica", self.replica)
        schema.check_step_record(rec)
        self.step_records.append(rec)
        if len(self.step_records) > self.window:
            del self.step_records[:len(self.step_records) - self.window]
        reg = self.registry
        cfgname = rec["config"]
        if cfgname is None:
            reg.counter("steps_idle_total").inc()
        else:
            reg.counter("steps_total", config=cfgname).inc()
        n_pre, n_dec = rec["prefill_tokens"], rec["decode_tokens"]
        if n_pre:
            reg.counter("tokens_prefill_total").inc(n_pre)
        if n_dec:
            reg.counter("tokens_decode_total").inc(n_dec)
        if rec["attn_ctx_tokens"]:
            reg.counter("attn_ctx_tokens_total").inc(rec["attn_ctx_tokens"])
        if rec["ready_decodes"] and not n_dec:
            reg.counter("decode_starved_steps_total").inc()
        reg.histogram("step_seconds").observe(rec["dur_s"])
        if n_pre or n_dec:
            reg.histogram("step_tokens").observe(n_pre + n_dec)
        return rec

    # ------------------------------------------------------------ events
    def emit(self, kind: str, *, step: int, ts: Optional[float] = None,
             rid: Optional[int] = None, **attrs) -> Optional[dict]:
        if self.replica is not None:
            attrs.setdefault("replica", self.replica)
        return self.events.emit(kind, step=step,
                                ts=self.now() if ts is None else ts,
                                rid=rid, **attrs)

    # ------------------------------------------------- metric call-throughs
    # Emitters record through these (not registry directly) so a disabled
    # NullObs is fully inert at every call site.
    def inc(self, name: str, amount: float = 1.0, **labels):
        self.registry.counter(name, **labels).inc(amount)

    def observe(self, name: str, value: float, **labels):
        self.registry.histogram(name, **labels).observe(value)

    def set_gauge(self, name: str, value: float, **labels):
        self.registry.gauge(name, **labels).set(value)

    def set_gauge_max(self, name: str, value: float, **labels):
        self.registry.gauge(name, **labels).set_max(value)

    # ----------------------------------------------------------- export
    def dump(self) -> dict:
        """The full observability state as one JSON-able dict — the input
        format of ``repro_torch.obs.report`` and ``repro_torch.obs.trace``."""
        return {"schema_version": schema.SCHEMA_VERSION,
                "source": self.source,
                "metrics": self.registry.snapshot(),
                "events": [dict(e) for e in self.events.events],
                "events_dropped": self.events.dropped,
                "steps": [dict(r) for r in self.step_records]}

    def write_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=1, sort_keys=True)

    def write_prometheus(self, path: str):
        with open(path, "w") as f:
            f.write(self.registry.to_prometheus())

    # ---------------------------------------------------------- snapshot
    def state_dict(self) -> dict:
        return {"source": self.source, "window": self.window,
                "registry": self.registry.state_dict(),
                "events": self.events.state_dict(),
                "steps": [dict(r) for r in self.step_records]}

    def load_state(self, state: dict):
        self.source = state["source"]
        self.window = state["window"]
        self.registry.load_state(state["registry"])
        self.events.load_state(state["events"])
        self.step_records = [dict(r) for r in state["steps"]]
        return self


class NullObs(Observability):
    """Disabled observability: same surface, records nothing. The engine
    behind it behaves identically (scheduling never reads obs state); the
    wall-time delta against the real thing is ``obs.overhead_ratio``."""

    def __init__(self, source: str = "null", now=time.monotonic):
        super().__init__(source, window=0, now=now, event_cap=1)
        self.enabled = False

    def record_step(self, rec: dict) -> dict:
        return rec

    def emit(self, kind: str, *, step: int, ts: Optional[float] = None,
             rid: Optional[int] = None, **attrs) -> Optional[dict]:
        return None

    def inc(self, name: str, amount: float = 1.0, **labels):
        pass

    def observe(self, name: str, value: float, **labels):
        pass

    def set_gauge(self, name: str, value: float, **labels):
        pass

    def set_gauge_max(self, name: str, value: float, **labels):
        pass

    def state_dict(self):
        return None
