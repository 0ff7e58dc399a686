"""The ONE metric/event vocabulary for serving observability (the port's
copy of ``repro.obs.schema``; its tables equal the reference's, including
the names that only later slices emit: faults, cluster, reshard).

The engine registers metrics and emits lifecycle events strictly from this
module, so its dumps feed the same consumers (``repro_torch.obs.report``,
the Chrome-trace exporter) as the reference's emitters' do, without
translation. The registry enforces it: creating a metric whose name, kind,
or label keys are not declared here raises.
"""
from __future__ import annotations

SCHEMA_VERSION = 1

# metric name prefix in the Prometheus exposition (not in the in-process
# names — those stay short for call sites)
PROM_PREFIX = "repro_"

# ``config`` label values: the engine's two compiled configs (base = SP,TP;
# shift = pure TP) plus the simulator's fixed single-strategy runs.
CONFIGS = ("base", "shift", "sp", "tp", "dp")

# --------------------------------------------------------------- counters
# name -> (help, label keys)
COUNTERS = {
    "requests_arrived_total":
        ("Requests submitted to the scheduler", ()),
    "requests_admitted_total":
        ("Requests granted a slot (per admission, re-admissions count)", ()),
    "requests_finished_total":
        ("Requests that produced their final token", ()),
    "requests_preempted_total":
        ("Requests evicted back to the queue under memory pressure", ()),
    "steps_total":
        ("Engine iterations that did work, by chosen config", ("config",)),
    "steps_idle_total":
        ("Engine iterations that made no progress", ()),
    "tokens_prefill_total":
        ("Prompt tokens computed (prefix-cached tokens excluded)", ()),
    "tokens_decode_total":
        ("Decode tokens sampled", ()),
    "attn_ctx_tokens_total":
        ("Summed per-row KV context attended (work-proportionality "
         "witness)", ()),
    "decode_starved_steps_total":
        ("Iterations with ready decodes but zero decode progress", ()),
    "prefix_hits_total":
        ("Admissions that mapped >= 1 cached prefix block", ()),
    "prefix_misses_total":
        ("Admissions that mapped no cached prefix block", ()),
    "prefix_tokens_saved_total":
        ("Prefill tokens served from the prefix cache", ()),
    "prefix_evictions_total":
        ("Cached prefix blocks reclaimed under memory pressure", ()),
    "cow_copies_total":
        ("Copy-on-write physical block copies applied", ()),
    # ------------------------------------------------- fault tolerance
    "requests_timeout_total":
        ("Requests terminated because their deadline passed", ()),
    "requests_cancelled_total":
        ("Requests terminated by an explicit cancel()", ()),
    "requests_shed_total":
        ("Requests rejected or evicted by the bounded admission queue", ()),
    "requests_failed_total":
        ("Requests quarantined after repeatedly killing the step", ()),
    "faults_injected_total":
        ("Deterministic faults fired from a FaultPlan, by seam", ("seam",)),
    "retries_total":
        ("Recompute/backoff retries scheduled after a failed step", ()),
    "failed_steps_total":
        ("Engine iterations that failed (poisoned or raised forward)", ()),
    "straggler_steps_total":
        ("Iterations the StragglerWatchdog flagged as abnormally slow", ()),
    "snapshots_total":
        ("Engine state snapshots captured (auto or explicit)", ()),
    "recoveries_total":
        ("Successful recover() restores from a retained snapshot", ()),
    # ------------------------------------------------- cluster serving
    "requests_migrated_total":
        ("Live requests migrated off this replica (counted at the "
         "source)", ()),
    "migration_blocks_total":
        ("KV blocks received through live migration (counted at the "
         "destination)", ()),
    # ------------------------------------------------ elastic resharding
    "reshards_total":
        ("Completed deployment reshards (layout swaps) on this engine", ()),
    "reshard_blocks_moved_total":
        ("KV blocks re-poured into the new pool layout by reshards", ()),
    # ---------------------------------------------- speculative decoding
    "spec_proposed_total":
        ("Speculative draft tokens batched as verify queries", ()),
    "spec_accepted_total":
        ("Draft tokens accepted and delivered (excludes each row's "
         "always-sampled bonus token)", ()),
    "spec_rollback_blocks_total":
        ("KV blocks unmapped when rolling back rejected drafts", ()),
}

# ``seam`` label values: the named injection points of the fault plan —
# allocator OOM on ensure/COW, poisoned forward step, dp-row routing
# failure, snapshot corruption, and the harness-level crash drill.
SEAMS = ("alloc", "forward", "route", "snapshot", "crash")

# ----------------------------------------------------------------- gauges
GAUGES = {
    "queue_depth": ("Requests waiting for a slot", ()),
    "active_requests": ("Requests holding a slot", ()),
    "free_blocks": ("Free KV blocks across all dp rows", ()),
    "shared_blocks_peak": ("Peak resident shared-prefix blocks", ()),
}

# ------------------------------------------------------------- histograms
# Latency boundaries span sub-ms engine steps to minutes-long completions;
# identical for every latency histogram so percentile tables line up.
LATENCY_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
TOKEN_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# name -> (help, label keys, bucket boundaries)
HISTOGRAMS = {
    "ttft_seconds": ("Time to first token", (), LATENCY_BOUNDS),
    "tpot_seconds": ("Time per output token after the first", (),
                     LATENCY_BOUNDS),
    "queue_seconds": ("Arrival to (each) admission", (), LATENCY_BOUNDS),
    "e2e_seconds": ("Arrival to final token", (), LATENCY_BOUNDS),
    "step_seconds": ("Engine iteration wall time", (), LATENCY_BOUNDS),
    "step_tokens": ("Batched tokens per iteration", (), TOKEN_BOUNDS),
    # per spec decode row: accepted draft tokens (0 = drafts all rejected,
    # k = full acceptance). Small integer-aligned buckets — the acceptance
    # histogram the ROADMAP's spec-decode item calls for.
    "spec_accepted_per_row": ("Accepted draft tokens per verify row", (),
                              (0, 1, 2, 3, 4, 6, 8, 12, 16)),
}

# ------------------------------------------------------- lifecycle events
# Request-lifecycle span points + engine-level instants. ``rid`` is the
# request id for request-scoped kinds, None for engine-scoped ones.
EVENTS = (
    "queued",        # request entered the scheduler queue
    "routed",        # request assigned to a dp row / replica
    "admitted",      # request granted a slot (attrs carry the prefix match)
    "prefix_hit",    # admission mapped cached prefix blocks
    "prefix_evict",  # cached prefix blocks reclaimed (engine-scoped)
    "prefill_chunk",  # one prefill chunk computed for the request
    "first_token",   # first output token sampled
    "preempted",     # request evicted back to the queue
    "cow_flush",     # batched copy-on-write copies applied (engine-scoped)
    "finish",        # final token sampled (attrs carry the span summary)
    "snapshot",      # engine state captured
    "restore",       # engine state restored
    # ------------------------------------------------- fault tolerance
    "timeout",       # request terminated: deadline passed
    "cancelled",     # request terminated: explicit cancel()
    "shed",          # request terminated: bounded-queue shed policy
    "fault_injected",  # a FaultPlan fault fired (attrs carry seam/kind)
    "retry",         # request scheduled for recompute/backoff retry
    "quarantined",   # request terminated: killed the step too many times
    "recovered",     # engine state recovered from a retained snapshot
    "straggler",     # watchdog flagged this step as abnormally slow
    # ------------------------------------------------- cluster serving
    "migrate_out",   # live request extracted+released from this replica
    "migrate_in",    # live request admitted with migrated KV blocks
    # ------------------------------------------------ elastic resharding
    "reshard_scheduled",  # swap planned; admissions pause for the lead steps
    "reshard_begin",  # deployment swap starting (attrs: old/new/kind)
    "reshard_end",    # deployment swap complete (attrs carry the report)
)

# ------------------------------------------------------ step audit record
# One record per engine iteration — the single source of truth the rolling
# ``step_log``/``step_times``/``config_trace`` views derive from, carrying
# the monotone step index and duration INSIDE the record so entries can be
# joined after any amount of window trimming. ``config`` is None for idle
# steps. The audit fields (n_tokens/ctx_tokens/ctx_max/n_rows/threshold)
# are exactly what the shift policy saw, so base<->shift flips are
# explainable from the trace alone.
STEP_REQUIRED = ("step", "t_start", "dur_s", "config", "prefill_tokens",
                 "decode_tokens", "ready_decodes", "attn_ctx_tokens")
STEP_OPTIONAL = ("n_tokens", "ctx_tokens", "ctx_max", "n_rows", "threshold",
                 "paged_disabled_reason", "replica", "failed",
                 # speculative decoding: draft queries batched this step
                 # (also what the policy saw) and how many were accepted;
                 # decode_tokens counts DELIVERED tokens, so with drafts
                 # accepted it exceeds the step's decode-row count
                 "spec_tokens", "spec_proposed", "spec_accepted")

# counters every emitter must emit (the shared core of the schema; an
# emitter may additionally emit any other declared metric)
CORE_COUNTERS = ("steps_total", "tokens_prefill_total", "tokens_decode_total",
                 "attn_ctx_tokens_total", "requests_arrived_total",
                 "requests_admitted_total", "requests_finished_total")


def check_step_record(rec: dict):
    """Validate a step record against the schema (raises on violation)."""
    missing = [k for k in STEP_REQUIRED if k not in rec]
    if missing:
        raise ValueError(f"step record missing required fields {missing}")
    unknown = [k for k in rec
               if k not in STEP_REQUIRED and k not in STEP_OPTIONAL]
    if unknown:
        raise ValueError(f"step record has undeclared fields {unknown}")
    if rec["config"] is not None and rec["config"] not in CONFIGS:
        raise ValueError(f"unknown config label {rec['config']!r}")


def check_event_kind(kind: str):
    if kind not in EVENTS:
        raise ValueError(f"unknown event kind {kind!r} (schema: {EVENTS})")
