"""Serving entry point of the port:
``PYTHONPATH=src python -m repro_torch.launch.serve``.

Serves the architecture at full width in bf16 on the card by default
(qwen3-8b: 36 layers, d_model 4096), with random weights drawn from a
seeded ``torch.Generator``; the workload and engine defaults are those of
``repro.launch.serve``. The CLI serves through the mixed paged iteration
(the reference CLI's default); ``--arch mamba2-1.3b``, whose SSD layers
do not page, falls back to the serialized iteration (a prefill step, else
a decode step) on the dense contiguous cache. ``build_engine(...,
paged=False, mixed=False)`` builds that iteration for any arch, and
``mixed=False`` alone the serialized iteration on the paged pool.
``--reduced`` and ``--device cpu`` run the test-size model on the CPU with
the kernels' plain versions.

``--prefix-cache`` turns on the prefix cache (with copy-on-write),
``--shared-prefix N`` prepends the same N tokens ``1000 .. 1000+N-1`` to
every prompt (a system prompt), and ``--spec-k K`` verifies up to K draft
tokens per decode row (``--spec-ngram``: the longest n-gram the drafter
matches), as the reference CLI's flags do.

``build_engine(..., dp=, sp=, tp=, groups=)`` builds one rank of the Shift
Parallelism deployment: the base model on ``Layout(dp, sp, tp)`` and the
shift model on its ``to_shift()`` (one model while sp·tp is 1), over this
rank's row's paged pool or, with ``paged=False`` and for mamba2-1.3b, its
dense cache, with any iteration, inside a rank of
``launch.mesh.run_ranks`` (which builds the ``groups``). As in the reference, the CLI has a flag for dp
only: ``--dp N`` serves with N data-parallel rows, one process per row
spawned through ``run_ranks`` over ``--backend`` (``gloo`` or ``nccl``; no
default above one process). Every rank serves the same requests; the
parent prints rank 0's report, with the row each request was routed to,
after checking that every rank's streams are equal.

At exit the CLI prints the observability report (TTFT, TPOT, queue and
end-to-end percentiles, tokens/s, steps by config) of the engine's dump;
``--metrics-out PATH`` writes the dump as JSON and the Prometheus text
beside it (``PATH`` with ``.prom``), ``--trace-out PATH`` a Chrome trace
(load it in ui.perfetto.dev); under ``--dp`` rank 0 writes them.
``--deadline-s``, ``--max-queue`` and ``--shed-policy`` set the engine's
``FaultConfig``: a request past its deadline ends ``timeout``, and the
queue beyond ``--max-queue`` waiting requests is shed by the policy. The
workload is queued before the first step, so ``--max-queue 2`` keeps two
requests and sheds the rest: the newest under ``reject-newest``, the
oldest under ``evict-longest-queued``.

``--adaptive`` picks each step's config with ``AdaptivePolicy``, the
roofline cost model (``repro_torch.sim.CostModel``, H100 data-sheet
constants) priced at the layout's (sp, tp), or at (2, 2) when sp·tp is 1
(one rank, or dp rows alone), as the reference CLI prices it; without it
the threshold policy decides. ``--arch`` takes qwen3-8b (the default),
qwen2-7b, qwen2-1.5b, internlm2-1.8b, mamba2-1.3b and the paper's
evaluation models that fit one card in bf16: qwen-32b (64 layers,
d_model 5120) and the Mixture-of-Experts qwen-30b-a3b (48 layers, d_model
2048, 128 experts, top-8; ``--adaptive`` prices its routed experts
through the cost model's MoE branch). ``llama-70b`` and the MoE
llama4-17b-16e (215.5 GB) are configs of the cost model and the
simulator, and llama4-17b-16e runs at ``--reduced`` size. So do
deepseek-v3-671b (multi-head latent attention, three dense prefix layers,
256 experts; 1342 GB in bf16), which falls back to the serialized
iteration on the dense latent cache (MLA does not page; the summary prints
the reason), and llama4-maverick-400b-a17b (dense and MoE layers
interleaved; 801 GB). ``--arch recurrentgemma-9b`` (38 layers: 12 x
(RG-LRU, RG-LRU, local attention) and two RG-LRU layers, d_model 4096,
19.3 GB in bf16) fits one card; its RG-LRU state and local rings do not
page, so it falls back to the serialized iteration on the dense cache as
mamba2 does. ``--arch whisper-small`` (12 encoder and 12 decoder layers,
d_model 768, 0.56 GB in bf16) takes that fallback too, at any ``--dp``
(its cross caches do not page), and runs its encoder over zero frames in
every prefill step; ``--arch internvl2-2b`` (24 layers, d_model 2048, 3.8
GB) serves through the mixed paged engine with zero image embeddings over
its first 256 positions. At full depth a model that does not fit the card
raises before it allocates, naming its size; ``--dp 2 --backend gloo``
serves the pod-scale MoE archs with their experts spread across the dp
rows.

``--fault-seed S`` serves under the seeded fault storm ``random_plan(S,
--fault-steps, p_alloc=p_forward=p_route=--p-fault, dp=--dp)``; under
``--dp`` every rank builds the same plan from the seed. Streams under it
equal those without it, except for requests a fault quarantines (reason
``failed``). ``--auto-snapshot-every N`` keeps the engine's snapshot ring
(the summary prints how many snapshots it holds). ``--metrics-refresh-s
S`` (with ``--metrics-out``) rewrites the Prometheus text every S seconds
while serving (``serve_loop``), not only at exit.

``build_cluster(arch, replicas, routing=, rebalance_every=, faults=,
**kw)`` builds N engine replicas over ONE weight set behind a
``repro_torch.cluster.Router`` (each replica steps a pool of its own; a
``faults`` plan applies to replica 0 only, as in the reference). The CLI's
``--replicas N`` serves the workload through it under ``--routing``
(``affinity``, ``round-robin``, ``least-loaded``) and prints the
reference's cluster summary; ``--metrics-out`` then writes the Router's
merged dump. The replicas run in one process at world size 1.

``--reshard-demo`` is the reference's elastic resharding demo on two
ranks (``run_ranks`` over ``--backend``): a (2, 1, 1) engine reshards
mid-decode to (1, 1, 2) (dp merge, wider TP) and back, and every stream
must equal a static (2, 1, 1) run's; it prints ``PASS`` and exits 0, or
``FAIL`` and exits 1. The port's reshard keeps the world size (its ranks
are processes), so both layouts run on the same two ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import time

import torch
import torch.distributed as dist

from repro_torch.cluster import ROUTING_POLICIES, Router
from repro_torch.configs import get_config
from repro_torch.core.policy import (DEFAULT_SHIFT_THRESHOLD, AdaptivePolicy,
                                     ThresholdPolicy)
from repro_torch.engine import EngineConfig, Request, ShiftEngine
from repro_torch.engine.api import FaultConfig, PrefixConfig
from repro_torch.ft import random_plan
# the launch counters, read and reset by callers of the entry point
from repro_torch.kernels.ops import (launch_counts,  # noqa: F401
                                     reset_launch_counts)
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import Model
from repro_torch.obs import build_report, format_report, write_chrome_trace
from repro_torch.parallel import Groups, Layout
from repro_torch.sim import CostModel
from repro_torch.spec import SpecConfig

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
WEIGHT_SEED = 0
DP_TIMEOUT_S = 1800                # bounds a --dp job's collectives and wall


def build_engine(arch: str = "qwen3-8b", *, faults=None,
                 **kw) -> ShiftEngine:
    """``build_stack``'s model with random weights (``torch.Generator`` seeded
    0) and the engine with the reference CLI's settings by default: 8 slots,
    s_max 256, chunk 64 (``slots``, ``s_max``, ``chunk``, ``threshold``);
    ``paged``/``mixed`` go to ``EngineConfig`` (None: paged and mixed when
    every layer pages, else the serialized dense engine), and so do
    ``prefix_cache`` (``PrefixConfig``), ``spec_k``/``spec_ngram``
    (``SpecConfig(k, ngram_max)``) and ``deadline_s``/``max_queue``/
    ``shed_policy``/``auto_snapshot_every`` (``FaultConfig``); ``faults`` (a
    ``FaultPlan``) goes to the engine. ``adaptive`` gives the engine
    ``adaptive_policy(cfg, sp, tp)`` instead of the threshold policy. With
    ``dp·sp·tp`` > 1 (the counterpart of the reference's ``_build_stack(dp=,
    sp=, tp=, mesh=)``): this rank's base model on ``Layout(dp, sp, tp)`` and,
    with ``sp·tp`` > 1, a shift model on its ``to_shift()``, both drawn from
    the same seed (every dp row the same shards), over the ranks' ``groups``;
    ``num_blocks`` is then per dp row. The model checks the device before it
    allocates anything."""
    models, ecfg, policy = build_stack(arch, **kw)
    return ShiftEngine(models[0], ecfg,
                       shift=models[1] if len(models) > 1 else None,
                       policy=policy, faults=faults)


def build_cluster(arch: str, replicas: int, *, routing="affinity",
                  rebalance_every=8, faults=None, **kw) -> Router:
    """N engine replicas over ONE weight set (``build_stack(arch, **kw)``,
    the ``build_engine`` settings) behind a ``Router``: every replica is a
    ``ShiftEngine`` on the same models, with a pool and step tables of its
    own. ``faults`` (a ``FaultPlan``) applies to replica 0 only: the
    migration drills need a healthy destination."""
    models, ecfg, policy = build_stack(arch, **kw)
    engines = [ShiftEngine(models[0], ecfg,
                           shift=models[1] if len(models) > 1 else None,
                           policy=policy, faults=faults if i == 0 else None)
               for i in range(replicas)]
    return Router(engines, routing=routing, rebalance_every=rebalance_every)


def build_stack(arch: str = "qwen3-8b", *, reduced=False, device="cuda",
                dtype=torch.bfloat16, slots=8, s_max=256, chunk=64,
                threshold=DEFAULT_SHIFT_THRESHOLD, adaptive=False,
                block_size=16, num_blocks=0, paged=None, mixed=None,
                prefix_cache=False, spec_k=0, spec_ngram=3,
                deadline_s=None, max_queue=0, shed_policy="reject-newest",
                auto_snapshot_every=0, dp=1, sp=1, tp=1,
                groups: Groups = None):
    """``build_engine``'s models (the base, and the shift one with
    ``sp·tp`` > 1), engine config and policy, for engines to share."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    lay = Layout(dp=dp, sp=sp, tp=tp)
    models = []
    for layout in ((lay, lay.to_shift()) if lay.G > 1 else (lay,)):
        model = Model(cfg, device=device, dtype=dtype, lay=layout,
                      groups=groups)
        model.init_params(
            torch.Generator(device=model.device).manual_seed(WEIGHT_SEED))
        models.append(model)
    ecfg = EngineConfig(max_slots=slots, s_max=s_max, prefill_chunk=chunk,
                        threshold=threshold, block_size=block_size,
                        num_blocks=num_blocks, paged=paged, mixed=mixed,
                        prefix=PrefixConfig(enabled=prefix_cache),
                        fault=FaultConfig(
                            deadline_s=deadline_s, max_queue=max_queue,
                            shed_policy=shed_policy,
                            auto_snapshot_every=auto_snapshot_every),
                        spec=SpecConfig(k=spec_k, ngram_max=spec_ngram))
    policy = (adaptive_policy(cfg, sp, tp) if adaptive
              else ThresholdPolicy(threshold))
    return models, ecfg, policy


def adaptive_policy(cfg, sp=1, tp=1) -> AdaptivePolicy:
    """``--adaptive``'s policy: the cost model of ``cfg`` (H100 constants)
    pricing base as sp and shift as tp over the layout's ``sp·tp`` ranks, or
    over (2, 2) when ``sp·tp`` is 1, the reference CLI's default grid."""
    if sp * tp == 1:
        sp, tp = 2, 2
    return AdaptivePolicy(CostModel(cfg), sp, tp)


def workload(n_requests: int, max_new: int, shared_prefix: int = 0):
    """The reference CLI's requests: prompt i is ``range(1, 20 + 3i)``,
    after the ``shared_prefix`` tokens ``1000 .. 1000+shared_prefix-1``."""
    t = time.monotonic()
    system = list(range(1000, 1000 + shared_prefix))
    return [Request(i, system + list(range(1, 20 + 3 * i)),
                    max_new_tokens=max_new, arrival=t)
            for i in range(n_requests)]


def _is_idle(client) -> bool:
    if isinstance(client, Router):
        return all(st.queue_depth == 0 and st.active == 0
                   for st in (e.stats() for e in client.engines))
    return not client.queue and not client.active


def serve_loop(client, *, refresh_s=0.0, prom_path=None, max_steps=10000,
               now=time.monotonic):
    """Drive ``client`` (an engine or a ``Router``) to idle as
    ``run_until_idle`` does, with a live metrics surface: with
    ``refresh_s`` > 0 and a ``prom_path`` the Prometheus text is rewritten
    every ``refresh_s`` seconds of serving (by ``now``, injectable) and
    once at exit; a Router is polled every iteration (its exactly-once
    delivery check). Returns the number of writes (0 without a
    refresh)."""
    cluster = isinstance(client, Router)
    writer = client.write_prometheus if cluster \
        else client.obs.write_prometheus
    if not (refresh_s and prom_path):
        client.run_until_idle(max_steps)
        return 0
    n_refresh = 0
    last = now()
    for _ in range(max_steps):
        if cluster:
            client.poll()
        progressed = client.step()
        t = now()
        if t - last >= refresh_s:
            writer(prom_path)
            last = t
            n_refresh += 1
        if not progressed and _is_idle(client):
            break
    if cluster:
        client.poll()
    writer(prom_path)                  # the final state is always current
    return n_refresh + 1


def fault_plan(args):
    """The seeded storm of ``--fault-seed`` (None without it): the same
    plan on every rank, as the reference CLI builds it."""
    if args.fault_seed is None:
        return None
    return random_plan(args.fault_seed, args.fault_steps,
                       p_alloc=args.p_fault, p_forward=args.p_fault,
                       p_route=args.p_fault, dp=args.dp)


def print_summary(eng: ShiftEngine, label: str = "", launches: bool = True):
    """The engine's summary, each line after ``label`` (a replica's
    ``[replica i] ``); ``launches`` prints the process-wide kernel launch
    counters too."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _summary(eng, launches)
    for line in out.getvalue().splitlines():
        print(label + line)


def _summary(eng: ShiftEngine, launches: bool):
    st = eng.stats()
    cc = st.config_counts
    print(f"iteration: {'mixed' if eng.mixed else 'serialized'}")
    pol = eng.policy
    if isinstance(pol, AdaptivePolicy):
        n = pol.sp * pol.tp
        print(f"shift policy: AdaptivePolicy, the cost model at "
              f"{pol.cost_model.hw.name} pricing base as sp={n} and shift "
              f"as tp={n}")
    else:
        print(f"shift policy: {pol!r}")
    print(f"configs used: base={cc['base']} shift={cc['shift']}")
    if st.paged:
        print(f"paged cache: {st.dp} dp row(s) x "
              f"{st.blocks_per_row} blocks x {st.block_size} "
              f"tokens, {st.preemptions} preemptions, "
              f"{st.free_blocks} free at exit")
        if st.dp > 1:
            for r, free in enumerate(st.blocks.free_per_row):
                print(f"  row {r}: {free} free blocks")
        if eng.cfg.prefix.enabled:
            p = st.prefix
            print(f"prefix cache: {p.entries} cached blocks, "
                  f"{p.hits} hits / {p.misses} misses, "
                  f"{p.tokens_saved} prefill tokens saved, "
                  f"{p.evictions} evictions, {p.cow_copies} COW copies")
    else:
        print(f"dense cache: {eng.cfg.max_slots} slots x {eng.cfg.s_max} "
              f"positions ({eng.paged_disabled_reason})")
    if eng.cfg.spec.k:
        if eng.spec_disabled_reason:
            print(f"spec decode DISABLED: {eng.spec_disabled_reason}")
        else:
            reg = eng.obs.registry
            prop = int(reg.counter_total("spec_proposed_total"))
            acc = int(reg.counter_total("spec_accepted_total"))
            rate = f" ({acc / prop:.0%} acceptance)" if prop else ""
            print(f"spec decode: k={eng.cfg.spec.k}, {prop} drafted, "
                  f"{acc} accepted{rate}")
    if eng.faults is not None or eng.cfg.auto_snapshot_every:
        reg = eng.obs.registry
        print(f"fault tolerance: {len(eng.faults or [])} faults planned, "
              f"{int(reg.counter_total('faults_injected_total'))} injected, "
              f"{int(reg.counter_total('failed_steps_total'))} failed steps, "
              f"{int(reg.counter_total('retries_total'))} retries, "
              f"{int(reg.counter_total('requests_failed_total'))} "
              f"quarantined; {len(eng.retained_snapshots())} snapshots "
              f"retained (every {eng.cfg.auto_snapshot_every} steps)")
    d = eng.deploy
    if d.world > 1:
        how = (f"shift {d.shift.lay.describe()}, {d.world} ranks over "
               f"{dist.get_backend()}, eager steps (a collective "
               "is not captured in a CUDA graph)")
    elif eng.model.device.type == "cuda":
        how = (f"{d.captures} CUDA graphs captured in "
               f"{d.graphs.capture_s * 1e3:.0f} ms")
    else:
        how = "eager steps on the CPU"
    print(f"deployment: {d.layout.describe()}, {how}")
    if launches:
        print_launches()


def print_launches():
    print("kernel launches: " + " ".join(
        f"{name}={n}" for name, n in launch_counts().items()))


def serve(eng: ShiftEngine, args, write=True):
    """Serve the CLI's workload on ``eng`` and print its report: each
    request's tokens, outcome, TTFT and dp row, ``print_summary``, and the
    observability report; with ``write``, the ``--metrics-out`` and
    ``--trace-out`` files. Returns the requests."""
    reqs = workload(args.requests, args.max_new, args.shared_prefix)
    for r in reqs:
        eng.submit(r)
    prom = (os.path.splitext(args.metrics_out)[0] + ".prom"
            if write and args.metrics_out else None)
    t0 = time.monotonic()
    n_refresh = serve_loop(eng, refresh_s=args.metrics_refresh_s,
                           prom_path=prom)
    dt = time.monotonic() - t0
    if n_refresh:
        print(f"live metrics: {prom} refreshed {n_refresh}x (every "
              f"{args.metrics_refresh_s}s)")
    for r in reqs:
        ttft = (r.first_token_time - r.arrival) if r.first_token_time else -1
        print(f"req {r.rid}: {len(r.generated)} tokens, "
              f"reason={r.finish_reason}, ttft={ttft*1e3:.0f}ms, "
              f"row={r.row}, out={r.generated[:8]}...")
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"{n_tok} tokens in {dt:.2f}s")
    print_summary(eng)
    dump = eng.obs.dump()
    print(format_report(build_report(dump)))
    if write and args.metrics_out:
        eng.obs.write_json(args.metrics_out)
        eng.obs.write_prometheus(prom)
        print(f"metrics written: {args.metrics_out} (JSON), {prom} "
              "(Prometheus text)")
    if write and args.trace_out:
        write_chrome_trace(args.trace_out, dump)
        print(f"chrome trace written: {args.trace_out} "
              f"({len(dump['events'])} events, {len(dump['steps'])} steps)")
    return reqs


def serve_cluster(router: Router, args):
    """Serve the CLI's workload through ``router`` and print the
    reference's cluster report: each request's tokens, outcome, TTFT and
    replica (read through the facade: a migrated request lives on in its
    destination's copy), each replica's summary, the cluster line and the
    observability report of the merged dump; ``--metrics-out`` and
    ``--trace-out`` get the merged dump. Returns the requests."""
    reqs = workload(args.requests, args.max_new, args.shared_prefix)
    for r in reqs:
        router.submit(r)
    prom = (os.path.splitext(args.metrics_out)[0] + ".prom"
            if args.metrics_out else None)
    t0 = time.monotonic()
    n_refresh = serve_loop(router, refresh_s=args.metrics_refresh_s,
                           prom_path=prom)
    dt = time.monotonic() - t0
    if n_refresh:
        print(f"live metrics: {prom} refreshed {n_refresh}x (every "
              f"{args.metrics_refresh_s}s)")
    for r in reqs:
        live = router.request(r.rid) or r
        ttft = (live.first_token_time - live.arrival) \
            if live.first_token_time else -1
        out = router.stream(r.rid)
        print(f"req {r.rid}: {len(out)} tokens, "
              f"reason={live.finish_reason}, ttft={ttft*1e3:.0f}ms, "
              f"replica={router.owner(r.rid)}, out={out[:8]}...")
    n_tok = sum(len(router.stream(r.rid)) for r in reqs)
    print(f"{n_tok} tokens in {dt:.2f}s")
    cs = router.stats()
    for i, eng in enumerate(router.engines):
        print_summary(eng, label=f"[replica {i}] ", launches=False)
    print(f"cluster: {cs.migrations} migrations "
          f"({cs.migrated_blocks} KV blocks moved), "
          f"routing={cs.routing}, {cs.steps} router steps")
    print_launches()
    dump = router.dump()
    print(format_report(build_report(dump)))
    if args.metrics_out:
        router.write_json(args.metrics_out)
        router.write_prometheus(prom)
        print(f"metrics written: {args.metrics_out} (JSON), {prom} "
              "(Prometheus text)")
    if args.trace_out:
        write_chrome_trace(args.trace_out, dump)
        print(f"chrome trace written: {args.trace_out} "
              f"({len(dump['events'])} events, {len(dump['steps'])} steps)")
    return reqs


def _stack_kw(args, groups=None) -> dict:
    return dict(reduced=args.reduced, device=args.device,
                dtype=DTYPES[args.dtype], adaptive=args.adaptive,
                block_size=args.block_size, num_blocks=args.num_blocks,
                prefix_cache=args.prefix_cache, spec_k=args.spec_k,
                spec_ngram=args.spec_ngram, deadline_s=args.deadline_s,
                max_queue=args.max_queue, shed_policy=args.shed_policy,
                auto_snapshot_every=args.auto_snapshot_every, dp=args.dp,
                groups=groups)


def _engine_of(args, groups=None) -> ShiftEngine:
    return build_engine(args.arch, faults=fault_plan(args),
                        **_stack_kw(args, groups))


# the demo's engines: the reference demo's settings
DEMO_KW = dict(slots=4, s_max=64, chunk=8, block_size=8)


def reshard_demo_rank(rank, groups, args) -> dict:
    """One rank of ``--reshard-demo``: a static (2, 1, 1) run, then the
    same requests on a (2, 1, 1) engine that reshards mid-decode to
    (1, 1, 2) and back, on the same weights; both grids' groups are built
    first, in the same order on every rank. Returns the printed report,
    the streams and the pass flag."""
    from repro_torch.ft import DeliveryLog
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        groups_tp = Groups(1, 2)
        lay_dp, lay_tp = Layout(dp=2), Layout(tp=2)
        kw = dict(reduced=args.reduced, device=args.device,
                  dtype=DTYPES[args.dtype], **DEMO_KW)
        models, ecfg, policy = build_stack(args.arch, dp=2, groups=groups,
                                           **kw)

        def reqs():
            return [Request(i, list(range(1, 11 + 2 * i)),
                            max_new_tokens=args.max_new)
                    for i in range(args.requests)]

        print(f"reference: static {lay_dp.describe()} run")
        ref = ShiftEngine(models[0], ecfg, policy=policy)
        ref_reqs = reqs()
        for r in ref_reqs:
            ref.submit(r)
        ref.run_until_idle()
        expect = {r.rid: list(r.generated) for r in ref_reqs}

        eng = ShiftEngine(models[0], ecfg, policy=policy)
        log, rs = DeliveryLog(), reqs()
        for r in rs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
            log.poll(rs)
        walls = []
        for lay, g, what in ((lay_tp, groups_tp, "mid-decode"),
                             (lay_dp, groups, "back")):
            print(f"resharding {what}: {eng.deploy.layout.describe()} -> "
                  f"{lay.describe()}" + (" (dp merge, wider TP)"
                                         if lay is lay_tp else ""))
            t0 = time.monotonic()
            rep = eng.reshard(lay, groups=g)
            walls.append(time.monotonic() - t0)
            print(f"  {rep.delta.kind}: {rep.moved_requests} requests, "
                  f"{rep.blocks_moved} KV blocks re-poured")
            for _ in range(3):
                eng.step()
                log.poll(rs)
        while eng.queue or eng.active:
            eng.step()
            log.poll(rs)              # raises ReplayDivergence
        got = {r.rid: list(r.generated) for r in rs}
        ok = got == expect
        for rid in sorted(got):
            print(f"req {rid}: {len(got[rid])} tokens, "
                  f"bit-identical={got[rid] == expect.get(rid)}")
        eng.drain()
        led = eng.stats().blocks
        print(f"drained: used={led.used} pinned={led.pinned} blocks")
        reg = eng.obs.registry
        print(f"obs: reshards_total={int(reg.counter_total('reshards_total'))}"
              f" reshard_blocks_moved_total="
              f"{int(reg.counter_total('reshard_blocks_moved_total'))}")
        traffic = groups.traffic + groups_tp.traffic
        print(f"reshard: {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; "
              f"reshard_gather "
              f"{traffic.get('reshard_gather_bytes', 0)} bytes in "
              f"{traffic.get('reshard_gather_calls', 0)} calls "
              f"({args.backend}, {args.device})")
        print("PASS: streams bit-identical across grow+shrink" if ok
              else "FAIL: streams diverged after reshard")
    return {"rank": rank, "report": text.getvalue(), "ok": ok,
            "streams": got}


def reshard_demo(args) -> int:
    """``--reshard-demo``: two ranks over ``--backend``; prints rank 0's
    report and returns 0 when every rank's streams equal the static
    run's."""
    res = run_ranks(reshard_demo_rank, 1, 1, dp=2, device=args.device,
                    backend=args.backend, timeout_s=DP_TIMEOUT_S,
                    args=(args,))
    if any(r["streams"] != res[0]["streams"] for r in res):
        raise RuntimeError("the ranks' streams differ")
    print(res[0]["report"], end="")
    return 0 if all(r["ok"] for r in res) else 1


def serve_rank(rank, groups, args) -> dict:
    """One rank of ``--dp``: build this rank's engine, serve (rank 0
    writes the metrics and trace files), and return the printed report,
    the streams and the rows the requests went to."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        reqs = serve(_engine_of(args, groups), args, write=rank == 0)
    return {"rank": rank, "report": text.getvalue(),
            "streams": [r.generated for r in reqs],
            "rows": [r.row for r in reqs]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="the test-size config (2 layers, d_model 64)")
    ap.add_argument("--adaptive", action="store_true",
                    help="pick each step's config by the roofline cost "
                         "model (H100 constants) instead of the threshold")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV block size (tokens)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="physical KV blocks; 0 = no memory pressure. Small "
                         "values force admission control + preemption")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="hash-indexed prefix reuse with copy-on-write")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend the same N tokens to every prompt (a "
                         "system prompt), to exercise --prefix-cache")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: max draft tokens verified "
                         "per decode row (0 = off)")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="longest suffix n-gram the drafter matches")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write the observability dump as JSON to PATH and "
                         "the Prometheus text exposition next to it "
                         "(PATH with a .prom extension)")
    ap.add_argument("--metrics-refresh-s", type=float, default=0.0,
                    help="with --metrics-out: rewrite the .prom exposition "
                         "every S seconds while serving, not just once at "
                         "exit")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write a Chrome trace-event file (load in "
                         "chrome://tracing or ui.perfetto.dev) to PATH")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (seconds past arrival); "
                         "expired requests finish with reason=timeout")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound on requests waiting for a slot; 0 = "
                         "unbounded. Overflow is shed per --shed-policy")
    ap.add_argument("--shed-policy", default="reject-newest",
                    choices=["reject-newest", "evict-longest-queued"])
    ap.add_argument("--auto-snapshot-every", type=int, default=0,
                    help="snapshot the engine every N steps into its "
                         "retained ring (crash recovery)")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="serve under a seeded deterministic fault storm "
                         "(repro_torch.ft.random_plan)")
    ap.add_argument("--fault-steps", type=int, default=64,
                    help="steps covered by the seeded fault storm")
    ap.add_argument("--p-fault", type=float, default=0.05,
                    help="per-step, per-seam fault probability of the "
                         "storm (alloc, forward and route seams)")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel rows: one process per row, each "
                         "with its own paged pool, requests routed by free "
                         "blocks (needs --backend)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="torch.distributed backend of the --dp processes "
                         "(no default: gloo on the CPU or several rows on "
                         "one card, nccl with a card per row)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas over one weight set behind the "
                         "cluster Router (prefix-affinity routing, live KV "
                         "migration); 1 = a bare engine, no Router")
    ap.add_argument("--routing", default="affinity",
                    choices=list(ROUTING_POLICIES),
                    help="Router policy for --replicas > 1")
    ap.add_argument("--reshard-demo", action="store_true",
                    help="elastic resharding demo on two ranks (needs "
                         "--backend): a (2, 1, 1) engine reshards to "
                         "(1, 1, 2) mid-decode and back; its streams must "
                         "equal a static run's")
    args = ap.parse_args(argv)

    if args.metrics_refresh_s and not args.metrics_out:
        ap.error("--metrics-refresh-s requires --metrics-out")
    if args.reshard_demo:
        if args.backend is None:
            ap.error("--reshard-demo runs 2 processes: pass --backend gloo "
                     "or --backend nccl")
        raise SystemExit(reshard_demo(args))
    if args.replicas > 1 and args.dp > 1:
        ap.error("--replicas runs its replicas in one process; --dp spawns "
                 "one process per row: use one of them")
    faults = fault_plan(args)
    if faults is not None:
        print(f"fault plan: seed={args.fault_seed} {len(faults)} faults "
              f"over {args.fault_steps} steps")
    if args.replicas > 1:
        router = build_cluster(args.arch, args.replicas, routing=args.routing,
                               faults=faults, **_stack_kw(args))
        print(f"cluster: {args.replicas} replicas, routing={args.routing}")
        serve_cluster(router, args)
        return
    if args.dp == 1:
        serve(_engine_of(args), args)
        return
    if args.backend is None:
        ap.error(f"--dp {args.dp} runs {args.dp} processes: pass --backend "
                 "gloo or --backend nccl")
    res = run_ranks(serve_rank, 1, 1, dp=args.dp, device=args.device,
                    backend=args.backend, timeout_s=DP_TIMEOUT_S,
                    args=(args,))
    for r in res:
        if r["streams"] != res[0]["streams"] or r["rows"] != res[0]["rows"]:
            raise RuntimeError(f"rank {r['rank']}'s streams or rows differ "
                               "from rank 0's")
    print(res[0]["report"], end="")
    print(f"{args.dp} ranks (one per dp row) over {args.backend}: every "
          "rank's streams are equal")


if __name__ == "__main__":
    main()
