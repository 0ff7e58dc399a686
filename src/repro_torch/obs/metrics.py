"""Dependency-free metrics registry: counters, gauges, fixed-boundary
histograms, with Prometheus-text and JSON exporters.

The registry is schema-strict: metric names, kinds, and label keys must be
declared in ``repro_torch.obs.schema`` — that is what keeps every
emitter on one vocabulary instead of several drifting ones. Values are
host-side python scalars; recording is a dict lookup + add, cheap enough
for per-iteration call sites (``obs.overhead_ratio`` measures it).

All state round-trips through ``state_dict``/``load_state`` so an engine
snapshot carries its monotone counters across a restore.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Tuple

from . import schema


def _label_key(labels: dict) -> Tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotone counter. ``inc`` with a negative amount raises — a counter
    that can go down is a gauge."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels, self.value = name, dict(labels), 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += amount


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels, self.value = name, dict(labels), 0.0

    def set(self, value: float):
        self.value = float(value)

    def set_max(self, value: float):
        """Peak-tracking convenience (e.g. ``shared_blocks_peak``)."""
        self.value = max(self.value, float(value))


class Histogram:
    """Fixed-boundary histogram (boundaries come from the schema, shared
    by every emitter so percentile tables line up across emitters)."""
    __slots__ = ("name", "labels", "bounds", "buckets", "sum", "count")

    def __init__(self, name: str, labels: dict, bounds):
        self.name, self.labels = name, dict(labels)
        self.bounds = tuple(float(b) for b in bounds)
        self.buckets = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        v = float(value)
        self.buckets[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1


class MetricsRegistry:
    """Schema-strict registry. ``counter``/``gauge``/``histogram`` create
    on first use and return the live instrument; exporters walk whatever
    exists (a metric never touched is simply absent from the output)."""

    def __init__(self):
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._histograms: Dict[Tuple, Histogram] = {}

    # ------------------------------------------------------------ create
    @staticmethod
    def _check(table: dict, kind: str, name: str, labels: dict):
        if name not in table:
            raise ValueError(
                f"{kind} {name!r} is not declared in repro_torch.obs.schema")
        declared = table[name][1]
        if tuple(sorted(labels)) != tuple(sorted(declared)):
            raise ValueError(
                f"{kind} {name!r} declares labels {declared}, got "
                f"{tuple(sorted(labels))}")
        if "config" in labels and labels["config"] not in schema.CONFIGS:
            raise ValueError(f"unknown config label {labels['config']!r}")
        if "seam" in labels and labels["seam"] not in schema.SEAMS:
            raise ValueError(f"unknown seam label {labels['seam']!r}")

    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            self._check(schema.COUNTERS, "counter", name, labels)
            c = self._counters[key] = Counter(name, labels)
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            self._check(schema.GAUGES, "gauge", name, labels)
            g = self._gauges[key] = Gauge(name, labels)
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            self._check(schema.HISTOGRAMS, "histogram", name, labels)
            h = self._histograms[key] = Histogram(
                name, labels, schema.HISTOGRAMS[name][2])
        return h

    # ------------------------------------------------------------- query
    def counter_value(self, name: str, **labels) -> float:
        """Current value, 0 if never incremented (does not create)."""
        c = self._counters.get((name, _label_key(labels)))
        return c.value if c is not None else 0.0

    def counter_total(self, name: str) -> float:
        """Sum over all label sets of ``name``."""
        return sum(c.value for c in self._counters.values()
                   if c.name == name)

    def gauge_value(self, name: str, **labels) -> float:
        g = self._gauges.get((name, _label_key(labels)))
        return g.value if g is not None else 0.0

    def histogram_sum(self, name: str, **labels) -> float:
        h = self._histograms.get((name, _label_key(labels)))
        return h.sum if h is not None else 0.0

    def emitted_names(self) -> dict:
        """{"counters": set, "gauges": set, "histograms": set} of metric
        names actually touched — what the schema-conformance test audits."""
        return {"counters": {c.name for c in self._counters.values()},
                "gauges": {g.name for g in self._gauges.values()},
                "histograms": {h.name for h in self._histograms.values()}}

    # --------------------------------------------------------- exporters
    def snapshot(self) -> dict:
        """JSON-able snapshot of every live instrument."""
        return {
            "counters": [
                {"name": c.name, "labels": c.labels, "value": c.value}
                for c in self._ordered(self._counters)],
            "gauges": [
                {"name": g.name, "labels": g.labels, "value": g.value}
                for g in self._ordered(self._gauges)],
            "histograms": [
                {"name": h.name, "labels": h.labels,
                 "bounds": list(h.bounds), "buckets": list(h.buckets),
                 "sum": h.sum, "count": h.count}
                for h in self._ordered(self._histograms)],
        }

    @staticmethod
    def _ordered(table: dict):
        return [table[k] for k in sorted(table, key=repr)]

    def to_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4)."""
        out = []

        def fmt_labels(labels: dict, extra=()):
            items = sorted(labels.items()) + list(extra)
            if not items:
                return ""
            body = ",".join(f'{k}="{v}"' for k, v in items)
            return "{" + body + "}"

        def num(v: float) -> str:
            f = float(v)
            return str(int(f)) if f == int(f) else repr(f)

        def header(name, kind, help_table):
            full = schema.PROM_PREFIX + name
            out.append(f"# HELP {full} {help_table[name][0]}")
            out.append(f"# TYPE {full} {kind}")
            return full

        for name in sorted({c.name for c in self._counters.values()}):
            full = header(name, "counter", schema.COUNTERS)
            for c in self._ordered(self._counters):
                if c.name == name:
                    out.append(f"{full}{fmt_labels(c.labels)} {num(c.value)}")
        for name in sorted({g.name for g in self._gauges.values()}):
            full = header(name, "gauge", schema.GAUGES)
            for g in self._ordered(self._gauges):
                if g.name == name:
                    out.append(f"{full}{fmt_labels(g.labels)} {num(g.value)}")
        for name in sorted({h.name for h in self._histograms.values()}):
            full = header(name, "histogram", schema.HISTOGRAMS)
            for h in self._ordered(self._histograms):
                if h.name != name:
                    continue
                acc = 0
                for bound, n in zip(h.bounds, h.buckets):
                    acc += n
                    out.append(f"{full}_bucket"
                               f"{fmt_labels(h.labels, [('le', num(bound))])}"
                               f" {acc}")
                acc += h.buckets[-1]
                out.append(f"{full}_bucket"
                           f"{fmt_labels(h.labels, [('le', '+Inf')])} {acc}")
                out.append(f"{full}_sum{fmt_labels(h.labels)} {num(h.sum)}")
                out.append(f"{full}_count{fmt_labels(h.labels)} {h.count}")
        return "\n".join(out) + ("\n" if out else "")

    # ---------------------------------------------------------- snapshot
    def state_dict(self) -> dict:
        return self.snapshot()

    def load_state(self, state: dict):
        """Rebuild instruments from ``state_dict``. Existing state is
        replaced — restore happens before any new recording."""
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()
        for c in state.get("counters", []):
            self.counter(c["name"], **c["labels"]).value = float(c["value"])
        for g in state.get("gauges", []):
            self.gauge(g["name"], **g["labels"]).value = float(g["value"])
        for h in state.get("histograms", []):
            hist = self.histogram(h["name"], **h["labels"])
            if tuple(h["bounds"]) != hist.bounds:
                raise ValueError(
                    f"histogram {h['name']!r} bounds changed since the "
                    "snapshot was taken — buckets cannot be restored")
            hist.buckets = list(h["buckets"])
            hist.sum = float(h["sum"])
            hist.count = int(h["count"])
        return self


def merge_snapshots(snaps) -> dict:
    """Merge per-replica registry snapshots into one cluster view:
    counters and histograms (same schema bounds everywhere) add; gauges
    add too — they are cluster totals (queue depth, active requests, free
    blocks) — except ``*_peak`` gauges, which take the max (a per-replica
    peak summed across replicas is not a peak of anything). The result is
    itself a valid ``MetricsRegistry.load_state`` input, which is how the
    Router renders Prometheus text for the merged view."""
    reg = MetricsRegistry()
    for snap in snaps:
        for c in snap.get("counters", []):
            reg.counter(c["name"], **c["labels"]).inc(float(c["value"]))
        for g in snap.get("gauges", []):
            gauge = reg.gauge(g["name"], **g["labels"])
            if g["name"].endswith("_peak"):
                gauge.set_max(float(g["value"]))
            else:
                gauge.set(gauge.value + float(g["value"]))
        for h in snap.get("histograms", []):
            hist = reg.histogram(h["name"], **h["labels"])
            if tuple(h["bounds"]) != hist.bounds:
                raise ValueError(
                    f"histogram {h['name']!r} bounds differ across "
                    "replicas — snapshots cannot be merged")
            hist.buckets = [a + b for a, b in zip(hist.buckets,
                                                  h["buckets"])]
            hist.sum += float(h["sum"])
            hist.count += int(h["count"])
    return reg.snapshot()
