"""Elastic reshard policy A/B on the serving simulator (the port's copy of
``repro.sim.elastic``: the pricing only).

The engine's ``reshard()`` (``repro_torch.engine.ShiftEngine.reshard``)
swaps the layout between iterations; this module prices WHEN to do that
on a trace: windows of high offered load run the throughput-optimal dp
factorization (many narrow replicas), low-load windows run the
latency-optimal merged configuration (one wide tensor-parallel group), and
every switch charges a reshard pause (weight re-placement + pool re-pour —
seconds, not the minutes a restart costs). ``reshard_policy_ab`` compares the elastic
policy against both static deployments on the same trace, extending the
paper's latency-vs-throughput tradeoff claim to elastic meshes: a
bimodal trace should see elastic match dp throughput in its bursts and
approach merged-TP latency in its valleys, minus the pause tax.

Everything is deterministic: window boundaries come from arrival times,
the load rule is a pure threshold, and each window runs the ordinary
:func:`repro_torch.sim.simulate` under its chosen strategy.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .simulator import simulate

# strategy names as costmodel.Strategy spells them: "dp" = replica-per-
# chip-group throughput mode, "tp" = one merged tensor-parallel group
# (the shift config's pure-TP latency mode)
HIGH_LOAD_STRATEGY = "dp"
LOW_LOAD_STRATEGY = "tp"


def _windows(trace: Sequence, window_s: float) -> List[list]:
    """Split a trace (tuples starting ``(t, n_in, n_out, ...)``) into
    contiguous arrival-time windows. Empty windows are dropped (they
    carry no work and no reshard decision)."""
    if not trace:
        return []
    out: List[list] = []
    horizon = max(t[0] for t in trace)
    n = int(horizon // window_s) + 1
    buckets: List[list] = [[] for _ in range(n)]
    for tr in trace:
        buckets[int(tr[0] // window_s)].append(tr)
    for b in buckets:
        if b:
            out.append(sorted(b, key=lambda tr: tr[0]))
    return out


def _offered_load(window: Sequence, window_s: float) -> float:
    return sum(tr[1] + tr[2] for tr in window) / window_s


def simulate_elastic(cfg, trace, *, hw=None, n_chips: int = 8,
                     window_s: float = 10.0,
                     high_load_tok_s: float = 2000.0,
                     reshard_pause_s: float = 0.25,
                     start_strategy: Optional[str] = None,
                     **kw) -> dict:
    """Run ``trace`` under the elastic reshard policy.

    Per arrival-time window of ``window_s``: offered load (prompt +
    output tokens per second) at or above ``high_load_tok_s`` runs the
    ``dp`` factorization, below it the merged ``tp`` one; a strategy
    change between consecutive windows counts one reshard and charges
    ``reshard_pause_s`` of serving pause. Returns the pooled metrics
    dict plus the reshard audit (``reshards``, ``reshard_pause_s``,
    ``window_strategies``)."""
    windows = _windows(trace, window_s)
    strategies = [HIGH_LOAD_STRATEGY
                  if _offered_load(w, window_s) >= high_load_tok_s
                  else LOW_LOAD_STRATEGY for w in windows]
    reshards = sum(1 for a, b in zip(strategies, strategies[1:])
                   if a != b)
    if (start_strategy is not None and strategies
            and strategies[0] != start_strategy):
        reshards += 1
    results = []
    for w, strat in zip(windows, strategies):
        base = w[0][0]
        rebased = [(tr[0] - base, *tr[1:]) for tr in w]
        results.append(simulate(cfg, rebased, strat, hw=hw,
                                n_chips=n_chips, **kw))
    pause = reshards * reshard_pause_s
    n_done = sum(r["n_done"] for r in results)

    def pooled(key):
        # weighted mean of per-window percentiles — an approximation (the
        # exact pooled percentile would need per-request samples), good
        # enough for a policy A/B on the same windowing
        num = sum(r[key] * r["n_done"] for r in results
                  if r["n_done"] and r[key] == r[key])       # skip NaN
        den = sum(r["n_done"] for r in results
                  if r["n_done"] and r[key] == r[key])
        return num / den if den else float("nan")

    return {
        "strategy": "elastic",
        "n_done": n_done,
        "reshards": reshards,
        "reshard_pause_s": pause,
        "window_strategies": strategies,
        "windows": len(windows),
        "ttft_p50_ms": pooled("ttft_p50_ms"),
        "ttft_p99_ms": pooled("ttft_p99_ms"),
        "tpot_p50_ms": pooled("tpot_p50_ms"),
        "completion_p50_s": pooled("completion_p50_s"),
        "peak_tput_tok_s": max((r["peak_tput_tok_s"] for r in results),
                               default=0.0),
        "avg_tput_tok_s": (sum(r["avg_tput_tok_s"] for r in results)
                           / len(results) if results else 0.0),
        "per_window": results,
    }


def reshard_policy_ab(cfg, trace, *, hw=None, n_chips: int = 8,
                      window_s: float = 10.0,
                      high_load_tok_s: float = 2000.0,
                      reshard_pause_s: float = 0.25, **kw) -> dict:
    """The latency-vs-throughput claim, extended to elastic meshes: the
    same trace under (a) the elastic reshard policy, (b) static dp, and
    (c) static merged TP. Returns ``{"elastic": ..., "static_dp": ...,
    "static_tp": ...}`` — each the ordinary metrics dict."""
    return {
        "elastic": simulate_elastic(
            cfg, trace, hw=hw, n_chips=n_chips, window_s=window_s,
            high_load_tok_s=high_load_tok_s,
            reshard_pause_s=reshard_pause_s, **kw),
        "static_dp": simulate(cfg, trace, HIGH_LOAD_STRATEGY, hw=hw,
                              n_chips=n_chips, **kw),
        "static_tp": simulate(cfg, trace, LOW_LOAD_STRATEGY, hw=hw,
                              n_chips=n_chips, **kw),
    }
