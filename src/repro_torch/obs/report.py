"""Latency/throughput reporting over observability dumps.

Consumes the dump format (``Observability.dump()``, as the engine emits
it and as the reference's emitters do, one schema) and computes
the paper's evaluation observables: TTFT / TPOT / queue-time / end-to-end
percentiles, combined token throughput, and the per-config (base/shift)
step breakdown + timeline segments that make Algorithm-2 flips explainable
from a trace alone. Everything is derived with pure-python arithmetic over
the recorded events, so two same-seed deterministic runs produce
bitwise-identical reports.

CLI (``python -m repro_torch.obs`` is the same entry without runpy's
double-import warning)::

    python -m repro_torch.obs dump.json            # text tables
    python -m repro_torch.obs dump.json --json     # machine-readable

``latency_throughput_table`` combines several labeled reports into the
paper-style latency-vs-throughput table (one row per run/config sweep
point).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Sequence, Tuple

PERCENTILES = (50, 90, 99)


def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile (numpy's default method), pure
    python for bitwise-reproducible reports."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    rank = (len(s) - 1) * (p / 100.0)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return float(s[lo])
    return float(s[lo]) + (rank - lo) * (float(s[hi]) - float(s[lo]))


def _dist(xs: List[float]) -> dict:
    d = {"n": len(xs),
         "mean": (sum(xs) / len(xs)) if xs else float("nan")}
    for p in PERCENTILES:
        d[f"p{p}"] = percentile(xs, p)
    return d


def _counter(dump: dict, name: str) -> float:
    return sum(c["value"] for c in dump["metrics"].get("counters", [])
               if c["name"] == name)


def build_report(dump: dict) -> dict:
    """Aggregate one dump into the evaluation observables."""
    events = dump.get("events", [])
    steps = dump.get("steps", [])
    by_kind: Dict[str, List[dict]] = {}
    for e in events:
        by_kind.setdefault(e["kind"], []).append(e)

    finishes = by_kind.get("finish", [])
    latency = {
        "ttft_s": _dist([e["ttft_s"] for e in by_kind.get("first_token", [])
                         if e.get("ttft_s") is not None]),
        "tpot_s": _dist([e["tpot_s"] for e in finishes
                         if e.get("tpot_s") is not None]),
        "queue_s": _dist([e["queue_s"] for e in by_kind.get("admitted", [])
                          if e.get("queue_s") is not None]),
        "e2e_s": _dist([e["e2e_s"] for e in finishes
                        if e.get("e2e_s") is not None]),
    }

    t_vals = ([r["t_start"] for r in steps]
              + [r["t_start"] + r["dur_s"] for r in steps]
              + [e["ts"] for e in events])
    duration = (max(t_vals) - min(t_vals)) if t_vals else 0.0
    pre = _counter(dump, "tokens_prefill_total")
    dec = _counter(dump, "tokens_decode_total")
    saved = _counter(dump, "prefix_tokens_saved_total")
    throughput = {
        "prefill_tokens": pre, "decode_tokens": dec,
        "prefix_tokens_saved": saved,
        "total_tokens": pre + dec,
        "duration_s": duration,
        "tokens_per_s": (pre + dec) / duration if duration > 0
        else float("nan"),
    }

    # per-config step breakdown (from the retained step-record window)
    by_config: Dict[str, dict] = {}
    for r in steps:
        key = r["config"] or "idle"
        c = by_config.setdefault(key, {"steps": 0, "time_s": 0.0,
                                       "prefill_tokens": 0,
                                       "decode_tokens": 0,
                                       "attn_ctx_tokens": 0})
        c["steps"] += 1
        c["time_s"] += r["dur_s"]
        c["prefill_tokens"] += r["prefill_tokens"]
        c["decode_tokens"] += r["decode_tokens"]
        c["attn_ctx_tokens"] += r["attn_ctx_tokens"]
    for c in by_config.values():
        tok = c["prefill_tokens"] + c["decode_tokens"]
        c["tokens_per_s"] = tok / c["time_s"] if c["time_s"] > 0 \
            else float("nan")

    # config timeline: contiguous same-config segments over the monotone
    # step index (the base<->shift flip history, joinable with events via
    # the step field either carries)
    timeline: List[dict] = []
    for r in steps:
        key = r["config"] or "idle"
        if timeline and timeline[-1]["config"] == key \
                and timeline[-1]["end_step"] + 1 == r["step"]:
            seg = timeline[-1]
            seg["end_step"] = r["step"]
            seg["steps"] += 1
            seg["tokens"] += r["prefill_tokens"] + r["decode_tokens"]
        else:
            timeline.append({"config": key, "start_step": r["step"],
                             "end_step": r["step"], "steps": 1,
                             "tokens": r["prefill_tokens"]
                             + r["decode_tokens"]})

    return {
        "source": dump.get("source", "?"),
        "requests": {
            "arrived": _counter(dump, "requests_arrived_total"),
            "admitted": _counter(dump, "requests_admitted_total"),
            "finished": _counter(dump, "requests_finished_total"),
            "preempted": _counter(dump, "requests_preempted_total"),
        },
        "latency": latency,
        "throughput": throughput,
        "steps": {"recorded": len(steps), "by_config": by_config},
        "config_timeline": timeline,
    }


def _fmt_ms(v: float) -> str:
    return "      -" if v != v else f"{v * 1e3:7.2f}"


def format_report(rep: dict) -> str:
    """Human-readable text rendering of ``build_report`` output."""
    lines = [f"== observability report ({rep['source']}) =="]
    rq = rep["requests"]
    lines.append(f"requests: {rq['arrived']:.0f} arrived, "
                 f"{rq['admitted']:.0f} admitted, "
                 f"{rq['finished']:.0f} finished, "
                 f"{rq['preempted']:.0f} preempted")
    lines.append("latency (ms)          p50      p90      p99     mean    n")
    for key, label in (("ttft_s", "TTFT"), ("tpot_s", "TPOT"),
                       ("queue_s", "queue"), ("e2e_s", "E2E")):
        d = rep["latency"][key]
        lines.append(f"  {label:8s}      {_fmt_ms(d['p50'])}  "
                     f"{_fmt_ms(d['p90'])}  {_fmt_ms(d['p99'])}  "
                     f"{_fmt_ms(d['mean'])}  {d['n']:4d}")
    tp = rep["throughput"]
    lines.append(f"throughput: {tp['total_tokens']:.0f} tokens "
                 f"({tp['prefill_tokens']:.0f} prefill + "
                 f"{tp['decode_tokens']:.0f} decode, "
                 f"{tp['prefix_tokens_saved']:.0f} prefix-cached) in "
                 f"{tp['duration_s']:.3f}s = {tp['tokens_per_s']:.1f} tok/s")
    lines.append("steps by config:   steps     time_s   prefill    decode"
                 "   tok/s")
    for key in sorted(rep["steps"]["by_config"]):
        c = rep["steps"]["by_config"][key]
        lines.append(f"  {key:12s} {c['steps']:7d} {c['time_s']:10.4f} "
                     f"{c['prefill_tokens']:9d} {c['decode_tokens']:9d} "
                     f"{c['tokens_per_s']:7.1f}")
    segs = rep["config_timeline"]
    if segs:
        shown = segs[:20]
        body = " ".join(f"{s['config']}[{s['start_step']}"
                        f"-{s['end_step']}]" for s in shown)
        more = "" if len(segs) <= 20 else f" ... +{len(segs) - 20} segments"
        lines.append(f"config timeline: {body}{more}")
    return "\n".join(lines)


def latency_throughput_table(
        rows: Sequence[Tuple[str, dict]]) -> List[dict]:
    """Paper-style latency-vs-throughput table from labeled reports
    (``rows`` = [(label, report), ...] — e.g. one row per strategy or per
    traffic level). Returns JSON-able row dicts."""
    out = []
    for label, rep in rows:
        lat, tp = rep["latency"], rep["throughput"]
        out.append({
            "label": label,
            "ttft_p50_ms": lat["ttft_s"]["p50"] * 1e3,
            "ttft_p99_ms": lat["ttft_s"]["p99"] * 1e3,
            "tpot_p50_ms": lat["tpot_s"]["p50"] * 1e3,
            "tpot_p99_ms": lat["tpot_s"]["p99"] * 1e3,
            "queue_p99_ms": lat["queue_s"]["p99"] * 1e3,
            "e2e_p50_s": lat["e2e_s"]["p50"],
            "tokens_per_s": tp["tokens_per_s"],
        })
    return out


def format_table(rows: List[dict]) -> str:
    head = (f"{'label':16s} {'ttft_p50':>9s} {'ttft_p99':>9s} "
            f"{'tpot_p50':>9s} {'tpot_p99':>9s} {'tok/s':>9s}")
    lines = [head]
    for r in rows:
        lines.append(f"{r['label']:16s} {r['ttft_p50_ms']:9.2f} "
                     f"{r['ttft_p99_ms']:9.2f} {r['tpot_p50_ms']:9.2f} "
                     f"{r['tpot_p99_ms']:9.2f} {r['tokens_per_s']:9.1f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="latency/throughput report from an observability dump")
    ap.add_argument("dump", nargs="+",
                    help="dump JSON path(s) (Observability.dump / "
                         "serve.py --metrics-out)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report(s) as JSON instead of text")
    args = ap.parse_args(argv)
    reports = []
    for path in args.dump:
        try:
            with open(path) as f:
                dump = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"report: cannot load {path}: {e}", file=sys.stderr)
            return 2
        reports.append((path, build_report(dump)))
    if args.json:
        print(json.dumps({p: r for p, r in reports}, indent=1,
                         sort_keys=True))
        return 0
    for path, rep in reports:
        print(f"--- {path}")
        print(format_report(rep))
    if len(reports) > 1:
        print("--- latency vs throughput")
        print(format_table(latency_throughput_table(reports)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
