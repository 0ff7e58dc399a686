"""Chrome trace-event export (load in Perfetto / chrome://tracing).

Converts an observability dump (``Observability.dump()`` or its JSON) into
the Trace Event Format: the step timeline as complete ("X") events on one
lane per chosen config (base / shift / idle — the SP<->TP flips are visible
as lane changes), request lifecycles as async ("b"/"e") spans on one lane
per dp row / replica with instant ("i") marks for every span point in
between, and engine-scoped instants (COW flushes, prefix evictions,
snapshot/restore) on their own lane.

Timestamps are normalized so the earliest record is t=0; the exported unit
is microseconds as the format requires.
"""
from __future__ import annotations

import json

# lane (tid) layout inside pid 0
_STEP_TIDS = {"base": 1, "shift": 2, "sp": 3, "tp": 4, "dp": 5, None: 6}
_ENGINE_TID = 15          # rid-less instants (cow_flush, snapshot, ...)
_ROW_TID0 = 16            # request lane for dp row r is _ROW_TID0 + r

# span-point kinds rendered as instants inside a request's async span
_SPAN_INSTANTS = ("routed", "admitted", "prefix_hit", "prefill_chunk",
                  "first_token", "preempted")


def chrome_trace(dump: dict) -> dict:
    """Build the ``{"traceEvents": [...]}`` document from a dump dict."""
    steps = dump.get("steps", [])
    events = dump.get("events", [])
    t_vals = [r["t_start"] for r in steps] + [e["ts"] for e in events]
    t0 = min(t_vals) if t_vals else 0.0

    def us(t: float) -> float:
        return (t - t0) * 1e6

    out = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": f"repro {dump.get('source', '?')}"}}]
    seen_tids = {}

    def lane(tid: int, name: str):
        if tid not in seen_tids:
            seen_tids[tid] = name
            out.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": tid, "args": {"name": name}})
        return tid

    # ------------------------------------------------- step timeline lanes
    for rec in steps:
        cfgname = rec["config"]
        tid = lane(_STEP_TIDS.get(cfgname, 6),
                   f"steps:{cfgname or 'idle'}")
        out.append({"ph": "X", "name": cfgname or "idle",
                    "cat": "step", "ts": us(rec["t_start"]),
                    "dur": max(rec["dur_s"], 0.0) * 1e6,
                    "pid": 0, "tid": tid, "args": dict(rec)})

    # ------------------------------------------------ request span lanes
    # resolve each request's dp row from its routed/admitted events (row
    # -1 = never routed, e.g. the dense fallback)
    rows = {}
    for e in events:
        if e["rid"] is not None and e.get("row") is not None:
            rows.setdefault(e["rid"], e["row"])
    open_spans = set()
    for e in events:
        rid = e["rid"]
        if rid is None:
            tid = lane(_ENGINE_TID, "engine events")
            out.append({"ph": "i", "name": e["kind"], "cat": "engine",
                        "ts": us(e["ts"]), "pid": 0, "tid": tid, "s": "t",
                        "args": dict(e)})
            continue
        row = rows.get(rid, -1)
        tid = lane(_ROW_TID0 + 1 + row, f"requests:row{row}"
                   if row >= 0 else "requests")
        ident = str(rid)
        if rid not in open_spans:
            open_spans.add(rid)
            out.append({"ph": "b", "name": f"req {rid}", "cat": "request",
                        "id": ident, "ts": us(e["ts"]), "pid": 0,
                        "tid": tid, "args": {"rid": rid}})
        if e["kind"] == "finish":
            open_spans.discard(rid)
            out.append({"ph": "e", "name": f"req {rid}", "cat": "request",
                        "id": ident, "ts": us(e["ts"]), "pid": 0,
                        "tid": tid, "args": dict(e)})
        elif e["kind"] in _SPAN_INSTANTS:
            out.append({"ph": "i", "name": e["kind"], "cat": "request",
                        "ts": us(e["ts"]), "pid": 0, "tid": tid, "s": "t",
                        "args": dict(e)})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, dump: dict):
    with open(path, "w") as f:
        json.dump(chrome_trace(dump), f, indent=1)
