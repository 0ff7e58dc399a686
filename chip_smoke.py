#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``
from the root of a checkout.

Phases (every failure propagates and exits non-zero):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN, so fp32 means fp32;
2. build: the CUDA kernels from the checkout's sources with nvcc (one
   process per source, all started together);
3. the timer's floor (an empty kernel's time), then each kernel against its
   plain PyTorch version on the card at the main paths' shapes (qwen3-8b:
   32 query heads, 8 KV heads, head_dim 128, block 16; RMSNorm at the
   prefill and decode steps' shapes of both models, grouped over mamba2's
   64 SSD heads of 64, and a layer's q and k norms in one launch, bitwise
   equal to two single launches, with the host's µs per wrapper call; flash
   over a 64-token chunk against a dense cache of 2048 and the TPU kernel's
   own case; the ragged kernel also at speculative verify rows (q_len 1-5
   in a C = 8 bucket, contexts up to 2048) and at the prefix path's
   prefill rows past a 48-token cached prefix (C = 32); decode over contexts up to 2048 and over one sequence of 2048,
   beside the ragged kernel on the same K/V; the SSD chunk at mamba2-1.3b's
   serving prefill step, a long prompt, a short chunk and the TPU
   contract's per-(head, chunk) copies), in fp32 and bf16, with its time,
   the plain version's, a PyTorch library call's where one computes the
   same function, and the least time the card could take; for attention
   also the achieved TFLOP/s and the bound's share of the time (for the SSD
   chunk the share, and the bound against the fp32 peak beside the one
   against its inputs' type), and in bf16 two wider cases for the
   tensor-core tiles (ragged prefill chunks of 256 against contexts of
   2048, a flash serving chunk of 256); the padded paged decode also
   against the ragged kernel at C == 1, with its host µs per call;
4. the slice against itself across devices: the engines on reduced
   qwen3-8b at fp32 (mixed, serialized on the paged pool, serialized on the
   dense cache) and on reduced mamba2 (the dense fallback, with two
   requests in flight and more requests than slots) on the card (kernels)
   and on the CPU (plain versions) give equal streams, config counts,
   preemptions and observability dumps (less their time fields and the
   watchdog's flags), and one mixed step's and one dense prefill + decode's
   logits agree within 1e-4; the mixed engine with the prefix cache and
   k=4 speculation, after a 16-token shared prefix, with and without pool
   pressure, gives equal streams, cached tokens, prefix stats, spec counts,
   preemptions and config counts; the fork + COW case (a forked tail
   block copied in place, two continuations decoded) equal streams; and
   the mixed engine under a fixed fault plan (an alloc fault, a ``nan``
   and a ``raise`` forward fault, a route fault; ``quarantine_after`` 10)
   gives the clean run's streams on both devices, with equal outcomes,
   fail counts, failed steps, retries, preemptions, ledgers and dumps;
5. the main paths: ``repro_torch.launch.serve.build_engine`` serving
   qwen3-8b at full width in bf16 (random weights, generator seeded 0)
   with the serve CLI's workload, 6 requests x 16 new tokens, through the
   mixed paged engine, then on the same weights through the serialized
   engine on the paged pool and on the dense cache; then mamba2-1.3b at
   full width through its dense serialized fallback with the same
   workload. Each path runs in turns on one model: the engine's eager step
   tables (built here, explicitly), its graphed ones (every step captured
   once per bucket as a CUDA graph and replayed, as the engine runs), the
   graphed ones again and the eager ones again, each turn a warm-up run
   and a measured run of the workload and a ``torch.profiler`` trace of
   decode steps. Every launch counter is set to 0 before each measured
   run and must equal that path's per-step counts times its steps of each
   kind (a replay adds the launches its capture recorded); the profiler's
   trace must hold each port kernel's launches of a decode step; no
   capture may happen in a measured run or the profiled steps; the
   streams and launch counts of all four turns must be equal; no block
   may leak. Captured entries' full-width logits are held to the eager
   steps' on small caches. Each turn prints its wall ms per decode step,
   TTFT, decode tokens/s, device busy ms per step and busy share, graphs
   captured and capture ms (also as one ``{"graph_turns": ...}`` line).
   The ``mixed_prefix_spec`` path serves the same weights with the prefix
   cache and k=4 drafts, the workload after a 32-token shared prefix (all
   six requests arrive together, so five wait for the first one's
   in-flight prefix and then hit it), on the eager tables, the graphed
   ones and the graphed ones without drafts; each turn a warm-up run, the
   cache emptied, and a measured run: eager and graphed streams and
   launches equal, a prefix hit and an in-flight wait, drafts, no block
   held at exit, launches exact per step, no capture in the measured run;
   it prints the hits, tokens saved, COW copies, drafts, steps saved, wall
   ms per step, TTFT, tokens/s and the graphs by verify width. Counts of
   the engine's registry (configs, drafts) are read as deltas over the
   measured run;
5b. observability and the request lifecycle on the same model: the
   graphed mixed paged engine over the serve workload with obs on, off,
   on and off (``NullObs`` swapped in): equal streams, steps and launches,
   the wall per decode step of each turn and the ratio of on to off
   (``obs.overhead_ratio``); each on-turn's dump must hold together
   (``steps_total{config}`` equal to the configs the policy chose, the
   records' token sums equal to the token counters and the requests'
   tokens, 6 TTFT and E2E observations, each ``finish`` event's ``ttft_s``
   the request's, the records' durations 0.95-1.0 of the run's wall, one
   Chrome-trace "X" event per record), and its report and the median
   ``dur_s`` by config and by kind of step are printed; the graphed
   serialized paged engine the same, in turns with and without its
   prefill step's wait for the device (median prefill and decode
   ``dur_s``, run walls); then the lifecycle drill by hand on a cut pool
   under both shed policies (two requests, a step, four more, a deadline
   moved into the past and a cancel after step 3, ``drain()``, a request
   after it): every request ends with one reason, the reason counters
   match, no block is held and the late request is shed. One
   ``{"obs": ...}`` line;
5c. faults, snapshots and crash recovery on the same model: the graphed
   mixed paged engine under the seeded storm ``random_plan(13, 48,
   p_alloc=p_forward=p_route=0.1)`` with snapshots every 4 steps; the
   uninterrupted run (launches counted from 0: 109 RMSNorm and 36 ragged
   per step whose forward ran), an in-place restore of its step-4
   snapshot (no graph captured, the rest of the run equal bitwise), the
   crash drill (dropped after step 14, a new engine recovers from the
   ring under a ``DeliveryLog``: no divergence, the uninterrupted
   streams bitwise, typed outcomes, no block held) and a corrupted newest
   snapshot (``recover`` falls back to step 8; a direct restore raises
   ``SnapshotError`` and changes nothing). It prints the ms per snapshot
   and restore, the bytes per snapshot, the walls, the failed steps,
   retries, preemptions and steps by config, and how many faulted bf16
   streams equal the clean ones (reported only). One ``{"faults": ...}``
   line;
6. the layouts: four ranks of (sp, tp) = (2, 2), one process each, all on
   the one card with the collectives over gloo (NCCL refuses two ranks on
   one card; ``launch.mesh.run_ranks`` with ``backend="gloo"``): the fp32
   logits of the base and shift models at full width (2 layers) against
   the single-rank model on the same weights (2e-3), then qwen3-8b at full
   width and depth in bf16 through the SPMD engine (base on the grid, shift
   on its ``to_shift()``, one pool per rank) with the serve workload:
   equal streams on every rank, both configs used, no block leaked, 109
   RMSNorm and 36 ragged launches per step and rank (counters, and rank
   0's profiler trace of one base and three shift steps), the shared-block
   invariance on the card's pools; then the prefix cache and k=4 on the
   same models with the 32-token shared prefix: every rank's streams,
   cached tokens, prefix stats and spec counts equal, a hit and drafts, no
   block held at exit, 109 and 36 launches per step; it prints wall ms and
   collective bytes per step by config, one all-reduce's ms on card and
   host tensors, and peak memory per rank. Phase 3 also holds the ragged kernel and the q/k
   pair at a rank's shapes (8 q and 2 kv heads);
7. data parallelism, all on the one card over gloo, after a reckoning of
   the card's memory (the parent holds no model): (dp, sp, tp) = (2, 1, 1),
   two processes each with the whole qwen3-8b at full width and depth in
   bf16 and its row's pool of 65 blocks, serving the serve workload and
   then the prefix + spec workload; every rank's streams equal, both rows
   used, the streams equal to a dp=1 engine's in each rank's process over
   the same weights fed that rank's row's requests, its every step fitted
   to the row's segment of the dp batch (the same inputs after zero
   padding, run at the dp step's shapes), no block held at exit
   (``used == pinned == entries`` per row), 109 and 36 launches per step
   and rank, both ranks' observability dumps equal once the time fields
   are dropped, with a trace lane per dp row; it prints per row the
   requests, hits, tokens saved and free blocks, the TTFT, the wall per
   step by config, the decode tokens/s, the ``dp_all_gather`` bytes and
   calls per step, and rank 0's observability report. Each rank then
   snapshots its shard after step 4 of the serve workload and a new
   engine on the rank restores it: the rest of the run equals the
   uninterrupted run bitwise on both ranks.
   Then (2, 2, 2), eight processes at full width with the depth cut to
   the most layers (at least 8) that fit with 20 % of the free memory
   spare: every rank's streams equal; each row's segment of every step,
   replayed through (1, 2, 2) models, gives the same tokens bitwise; and
   the streams equal a (1, 2, 2) engine's fed each row's routed requests,
   pinned as above to the row's segments and the dp step's config; it
   prints the wall per step by config and the collective bytes by kind.

With no arguments it needs one card. The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
import contextlib
import gc
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12,    # dense tensor cores
              "torch.float32": 67e12}      # fp32 outside the tensor cores
ATTN_TPU = "src/repro/kernels/paged_ragged_attention.py:124"
RMS_TPU = "src/repro/kernels/rmsnorm.py:17"
FLASH_TPU = "src/repro/kernels/flash_attention.py:62"
DECODE_TPU = "src/repro/kernels/decode_attention.py:57"
PAGED_DECODE_TPU = "src/repro/kernels/paged_decode_attention.py:67"
SSD_TPU = "src/repro/kernels/ssd_scan.py:47"
CSRC = "src/repro_torch/kernels/csrc/"
# the decode rows of the ragged kernel's decode case: (context, q_len)
DECODE_ROWS = [(2048, 1), (1536, 1), (1024, 1), (777, 1), (512, 1), (256, 1),
               (100, 1), (1, 1)]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_report(name, log):
    """Print ptxas' registers and spills of each kernel in one library's
    build log, under a short name (kernel<float/bf16, template ints>)."""
    kernel = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            kernel = mangled[-60:]
            k = re.search(r"_kernel(?=[IE])", mangled)
            # the identifier is prefixed by its length, after a hash
            for j in range(k.end() - 1, 0, -1) if k else ():
                digits = re.search(r"\d+$", mangled[:j])
                if digits and any(int(digits.group()[-n:]) == k.end() - j
                                  for n in range(1, len(digits.group()) + 1)):
                    args = mangled[k.end():]
                    args = args[:args.find("EE") + 2] if args[0] == "I" else ""
                    kind = ("float, " if args.startswith("If") else
                            "bf16, " if "bfloat16" in args else "")
                    ints = ", ".join(re.findall(r"Li(\d+)E", args))
                    kernel = f"{mangled[j:k.end()]}<{kind}{ints}>"
                    break
        elif "registers" in line or "spill" in line:
            print(f"  {name}: {kernel}: {line.strip()}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


class Timer:
    """Device time of one call by CUDA events, median over ``iters``. Each
    measured call runs cold in L2 (a 64 MB buffer is rewritten before it)
    and behind a spin kernel, so the host's launch cost stays out of the
    measured interval."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            torch.cuda._sleep(2_000_000)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def compare(torch, what, got, want, tol):
    """Max abs error of ``got`` against ``want``; fails unless finite and
    within ``tol`` (allclose, absolute and relative)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    check(torch.isfinite(g).all(), f"{what}: non-finite output")
    check(torch.allclose(g, w, atol=tol, rtol=tol),
          f"{what}: max abs err {err} > tol {tol}")
    return err


def bound(nbytes, flops, dtype):
    """The least time the card could take, ms, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rates(case, flops):
    """Add an attention case's achieved TFLOP/s (the flops its inputs need
    over its measured time) and its bound share (bound over measured
    time)."""
    case["tflops"] = flops / (case["ms"] * 1e-3) / 1e12
    case["bound_share"] = case["bound_ms"] / case["ms"]
    return case


def attention_case(torch, name, rows, dtype, timer, tol, Hq=32, Hkv=8,
                   C=None):
    """rows: [(ctx, q_len)] of one batch; Hq 32, Hkv 8 (a rank's 8 and 2
    on the layout phase's grid), D 128, bs 16; C query columns per row
    (the longest q_len unless given: the engine pads to a power of two)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_ragged_attention as PRA
    D, bs = 128, 16
    g = Hq // Hkv
    B = len(rows)
    C = C or max(ql for _, ql in rows)
    ctx = torch.tensor([c for c, _ in rows], dtype=torch.int32)
    ql = torch.tensor([q for _, q in rows], dtype=torch.int32)
    nbs = [-(-c // bs) for c, _ in rows]
    nmax = max(nbs)
    gen = torch.Generator(device="cuda").manual_seed(len(rows) * 1000 + C)
    nblocks = sum(nbs) + 1
    perm = torch.randperm(nblocks - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((B, nmax), dtype=torch.int32)
    i = 0
    for b, nb in enumerate(nbs):
        bt[b, :nb] = perm[i:i + nb].cpu()
        i += nb
    q = torch.randn((B, Hkv, g, C, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((nblocks, bs, Hkv, D), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((nblocks, bs, Hkv, D), generator=gen,
                     device="cuda").to(dtype)
    args = (q, kp, vp, bt.cuda(), ql.cuda(), ctx.cuda())

    got = PRA.paged_ragged_attention_cuda(*args)
    torch.cuda.synchronize()
    want = PRA.paged_ragged_attention_plain(*args)
    torch.cuda.synchronize()
    check(torch.isfinite(got.float()).all(), f"attention {name}: non-finite")
    err = 0.0
    for b, (_, n) in enumerate(rows):      # real columns only
        gb, wb = got[b, :, :, :n].float(), want[b, :, :, :n].float()
        err = max(err, (gb - wb).abs().max().item())
        check(torch.allclose(gb, wb, atol=tol, rtol=tol),
              f"attention {name} row {b}: max abs err "
              f"{(gb - wb).abs().max().item()} > tol {tol}")

    # yardstick: SDPA over K/V already gathered dense (gather not timed)
    kd = PRA._paged_gather(kp, args[3]).permute(0, 2, 1, 3)  # [B,Hkv,L,D]
    vd = PRA._paged_gather(vp, args[3]).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    qd = q.reshape(B, Hq, C, D)
    L = kd.shape[2]
    qpos = (ctx - ql)[:, None] + torch.arange(C)[None]
    kpos = torch.arange(L)
    mask = ((kpos[None, None] <= qpos[:, :, None])
            & (kpos[None, None] < ctx[:, None, None]))[:, None].cuda()

    ms = timer(lambda: PRA.paged_ragged_attention_cuda(*args))
    plain_ms = timer(lambda: PRA.paged_ragged_attention_plain(*args), iters=3)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))

    elt = q.element_size()
    kv_bytes = sum(nbs) * bs * Hkv * D * 2 * elt   # live blocks, K and V
    io_bytes = 2 * q.numel() * elt + (bt.numel() + 2 * B) * 4
    flops = sum(4 * D * Hq * min(c - n + j + 1, c)
                for c, n in rows for j in range(n))
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return rates({"case": name, "dtype": str(dtype).replace("torch.", ""),
                  "shape": {"q": list(q.shape), "pool": list(kp.shape),
                            "block_tables": list(bt.shape),
                            "ctx_lens": [c for c, _ in rows],
                            "q_lens": [n for _, n in rows]},
                  "tol": tol, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                 flops)


def host_us(torch, fn, calls=1000):
    """The host's µs per call of ``fn``: ``calls`` calls without a sync,
    timed on the host clock, then one sync (after a few warm-up calls)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def rmsnorm_case(torch, name, N, D, dtype, timer, tol, H=None):
    """Rows [N, D] with scale [D]; with ``H``, grouped: x [N/H, H, D] with
    scale [H, D] (no single PyTorch call computes that)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RMS
    gen = torch.Generator(device="cuda").manual_seed(N + D)
    x = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
    s = torch.randn((H or 1, D), generator=gen, device="cuda").to(dtype)
    if H:
        x = x.reshape(N // H, H, D)
    else:
        s = s[0]
    got = RMS.rmsnorm_cuda(x, s)
    torch.cuda.synchronize()
    want = RMS.rmsnorm_plain(x, s)
    err = compare(torch, f"rmsnorm {name} {dtype}", got, want, tol)
    ms = timer(lambda: RMS.rmsnorm_cuda(x, s))
    plain_ms = timer(lambda: RMS.rmsnorm_plain(x, s))
    library_ms = None if H else timer(
        lambda: F.rms_norm(x, (D,), weight=s, eps=1e-6))
    elt = x.element_size()
    bound_ms, bound_by = bound((2 * N * D + s.numel()) * elt, 4 * N * D,
                               torch.float32)
    return {"case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"x": list(x.shape), "scale": list(s.shape)}, "tol": tol,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "host_us": host_us(torch, lambda: RMS.rmsnorm_cuda(x, s))}


def rmsnorm_pair_case(torch, name, Nq, Nk, D, dtype, timer, tol):
    """A layer's q_norm and k_norm in one launch: q [Nq, D] and k [Nk, D],
    each with its own [D] scale. Must equal two single launches bitwise;
    timed beside them (``singles_ms``)."""
    from repro_torch.kernels import rmsnorm as RMS
    gen = torch.Generator(device="cuda").manual_seed(Nq + Nk + D)
    q = torch.randn((Nq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((Nk, D), generator=gen, device="cuda").to(dtype)
    sq = torch.randn((D,), generator=gen, device="cuda").to(dtype)
    sk = torch.randn((D,), generator=gen, device="cuda").to(dtype)
    before = RMS.launches
    got = RMS.rmsnorm_pair_cuda(q, sq, k, sk)
    torch.cuda.synchronize()
    check(RMS.launches == before + 1, f"rmsnorm pair {name}: "
          f"{RMS.launches - before} launches, want 1")
    singles = (RMS.rmsnorm_cuda(q, sq), RMS.rmsnorm_cuda(k, sk))
    check(all(torch.equal(a, b) for a, b in zip(got, singles)),
          f"rmsnorm pair {name} {dtype}: not bitwise equal to two launches")
    want = RMS.rmsnorm_pair_plain(q, sq, k, sk)
    err = max(compare(torch, f"rmsnorm pair {name} {dtype}", a, b, tol)
              for a, b in zip(got, want))
    pair = lambda: RMS.rmsnorm_pair_cuda(q, sq, k, sk)  # noqa: E731
    ms = timer(pair)
    singles_ms = timer(lambda: (RMS.rmsnorm_cuda(q, sq),
                                RMS.rmsnorm_cuda(k, sk)))
    plain_ms = timer(lambda: RMS.rmsnorm_pair_plain(q, sq, k, sk))
    elt = q.element_size()
    bound_ms, bound_by = bound((2 * (Nq + Nk) * D + 2 * D) * elt,
                               4 * (Nq + Nk) * D, torch.float32)
    return {"case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"q": [Nq, D], "k": [Nk, D], "scales": [[D], [D]]},
            "tol": tol, "max_abs_err": err, "bitwise_equal_to_singles": True,
            "ms": ms, "singles_ms": singles_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "host_us": host_us(torch, pair)}


def flash_case(torch, name, B, Sq, Skv, offsets, causal, dtype, timer, tol,
               Hq=32, Hkv=8, D=128):
    """q [B, Sq, Hq, D] against k, v that are per-layer views [B, Skv, Hkv,
    D] of one cache tensor, as the dense prefill hands them over."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    g = Hq // Hkv
    gen = torch.Generator(device="cuda").manual_seed(B * Sq + Skv)
    q = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda").to(dtype)
    cache = torch.randn((2, B, Skv, Hkv, D), generator=gen,
                        device="cuda").to(dtype)
    k, v = cache[0], cache[1]
    qo = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    got = FA.flash_attention_cuda(q, k, v, qo, causal=causal)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, qo, causal=causal)
    err = compare(torch, f"flash {name} {dtype}", got, want, tol)

    # yardstick: SDPA over K/V already expanded to Hq heads (not timed)
    qs = q.transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    qpos = qo.long()[:, None] + torch.arange(Sq, device="cuda")[None]
    if causal and not any(offsets) and Sq == Skv:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, is_causal=True)
    elif causal:
        mask = (torch.arange(Skv, device="cuda")[None, None]
                <= qpos[:, :, None])[:, None]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=mask)
    else:
        library = lambda: F.scaled_dot_product_attention(qs, ks, vs)  # noqa
    ms = timer(lambda: FA.flash_attention_cuda(q, k, v, qo, causal=causal))
    plain_ms = timer(lambda: FA.flash_attention_plain(q, k, v, qo,
                                                      causal=causal), iters=3)
    library_ms = timer(library)

    elt = q.element_size()
    if causal:      # keys each row's last query sees; per query its own
        live = [min(Skv, o + Sq) for o in offsets]
        pairs = sum(min(Skv, o + i + 1) for o in offsets for i in range(Sq))
    else:
        live = [Skv] * B
        pairs = B * Sq * Skv
    nbytes = (2 * q.numel() * elt + sum(live) * Hkv * D * 2 * elt + 4 * B)
    flops = pairs * Hq * 4 * D
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return rates({"case": name, "dtype": str(dtype).replace("torch.", ""),
                  "shape": {"q": list(q.shape), "kv": list(k.shape),
                            "q_offsets": list(offsets), "causal": causal},
                  "tol": tol, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}, flops)


def decode_case(torch, name, lens, S, dtype, timer, tol, Hq=32, Hkv=8,
                D=128):
    """q [B, Hkv, g, D] against a dense cache [B, S, Hkv, D] read in
    place, masked by lens; also the ragged kernel on the same K/V through
    a block table (``ragged_ms``), both timed in this run."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    B, g = len(lens), Hq // Hkv
    gen = torch.Generator(device="cuda").manual_seed(B * S)
    q = torch.randn((B, Hkv, g, D), generator=gen, device="cuda").to(dtype)
    cache = torch.randn((2, B, S, Hkv, D), generator=gen,
                        device="cuda").to(dtype)
    k, v = cache[0], cache[1]
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = DA.decode_attention_cuda(q, k, v, ln)
    torch.cuda.synchronize()
    want = DA.decode_attention_plain(q, k, v, ln)
    err = compare(torch, f"decode {name} {dtype}", got, want, tol)

    qs = q.reshape(B, Hq, 1, D)
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(S, device="cuda")[None] < ln.long()[:, None])
    mask = mask[:, None, None]
    # the ragged kernel (C == 1) on the same K/V, read as a pool of
    # contiguous blocks of 16 through a table: the same work through a table
    from repro_torch.kernels import paged_ragged_attention as PRA
    bs = 16
    nb = S // bs
    pools = [t.reshape(B * nb, bs, Hkv, D) for t in (k, v)]
    bt = (torch.arange(B * nb, dtype=torch.int32, device="cuda")
          .reshape(B, nb))
    q5 = q[:, :, :, None].contiguous()
    ones = torch.ones_like(ln)
    rag = PRA.paged_ragged_attention_cuda(q5, *pools, bt, ones, ln)
    torch.cuda.synchronize()
    rag_err = compare(torch, f"decode vs ragged {name} {dtype}", got,
                      rag[:, :, :, 0], tol)

    ms = timer(lambda: DA.decode_attention_cuda(q, k, v, ln))
    ragged_ms = timer(lambda: PRA.paged_ragged_attention_cuda(
        q5, *pools, bt, ones, ln))
    plain_ms = timer(lambda: DA.decode_attention_plain(q, k, v, ln), iters=3)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))
    elt = q.element_size()
    nbytes = 2 * q.numel() * elt + sum(lens) * Hkv * D * 2 * elt + 4 * B
    flops = sum(lens) * Hq * 4 * D
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return rates({"case": name, "dtype": str(dtype).replace("torch.", ""),
                  "shape": {"q": list(q.shape), "kv": list(k.shape),
                            "lens": list(lens)},
                  "tol": tol, "max_abs_err": err, "ms": ms,
                  "ragged_ms": ragged_ms, "ragged_max_abs_diff": rag_err,
                  "ragged_bound_share": bound_ms / ragged_ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}, flops)


def paged_decode_case(torch, name, rows, dtype, timer, tol, Hq=32, Hkv=8,
                      D=128, bs=16):
    """The padded walk over the ragged decode case's own rows and table;
    also held against the ragged kernel at C == 1 on the same inputs
    (fp32 within 1e-5), and both timed, with the host's µs per call."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as PDA
    from repro_torch.kernels import paged_ragged_attention as PRA
    B, g = len(rows), Hq // Hkv
    ctx = [c for c, _ in rows]
    nbs = [-(-c // bs) for c in ctx]
    nmax, nblocks = max(nbs), sum(nbs) + 1
    gen = torch.Generator(device="cuda").manual_seed(B * 1000 + 1)
    perm = (torch.randperm(nblocks - 1, generator=gen, device="cuda") + 1).cpu()
    bt = torch.zeros((B, nmax), dtype=torch.int32)
    i = 0
    for b, nb in enumerate(nbs):
        bt[b, :nb] = perm[i:i + nb]
        i += nb
    q = torch.randn((B, Hkv, g, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((nblocks, bs, Hkv, D), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((nblocks, bs, Hkv, D), generator=gen,
                     device="cuda").to(dtype)
    bt, ln = bt.cuda(), torch.tensor(ctx, dtype=torch.int32, device="cuda")
    args = (q, kp, vp, bt, ln)
    got = PDA.paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    want = PDA.paged_decode_attention_plain(*args)
    err = compare(torch, f"paged decode {name} {dtype}", got, want, tol)
    q5 = q[:, :, :, None].contiguous()
    ones = torch.ones_like(ln)
    rag = PRA.paged_ragged_attention_cuda(q5, kp, vp, bt, ones, ln)
    torch.cuda.synchronize()
    rag_tol = 1e-5 if dtype == torch.float32 else tol
    rag_err = compare(torch, f"paged decode vs ragged {name} {dtype}", got,
                      rag[:, :, :, 0], rag_tol)

    kd = PRA._paged_gather(kp, bt).permute(0, 2, 1, 3)       # [B,Hkv,L,D]
    vd = PRA._paged_gather(vp, bt).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    qd = q.reshape(B, Hq, 1, D)
    mask = (torch.arange(kd.shape[2], device="cuda")[None]
            < ln.long()[:, None])[:, None, None]
    ms = timer(lambda: PDA.paged_decode_attention_cuda(*args))
    ragged_ms = timer(lambda: PRA.paged_ragged_attention_cuda(q5, kp, vp, bt,
                                                              ones, ln))
    plain_ms = timer(lambda: PDA.paged_decode_attention_plain(*args), iters=3)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    elt = q.element_size()
    nbytes = (2 * q.numel() * elt + sum(ctx) * Hkv * D * 2 * elt
              + (bt.numel() + B) * 4)
    flops = sum(ctx) * Hq * 4 * D
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return rates({"case": name, "dtype": str(dtype).replace("torch.", ""),
                  "shape": {"q": list(q.shape), "pool": list(kp.shape),
                            "block_tables": list(bt.shape), "lens": ctx},
                  "tol": tol, "max_abs_err": err,
                  "ragged_max_abs_diff": rag_err, "ms": ms,
                  "ragged_ms": ragged_ms,
                  "ragged_bound_share": bound_ms / ragged_ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "host_us": host_us(
                      torch, lambda: PDA.paged_decode_attention_cuda(*args))},
                 flops)


def ssd_chunk_case(torch, name, B, S, H, hd, ds, L, shared, dtype, timer,
                   tol=1e-4):
    """The SSD chunk step. Shared: x, b and c are views of one conv output
    [B, S, H*hd + 2*ds], as ``_ssd_scan`` hands them over (b and c with a
    head stride of 0). Per head: the TPU contract's copies, contiguous [B,
    S, H, *]. Both versions compute in fp32 from the same inputs and return
    fp32, so they agree within ``tol`` in either input type. No single
    PyTorch call computes this function: library_ms is None."""
    from repro_torch.kernels import ssd_scan as SSD
    gen = torch.Generator(device="cuda").manual_seed(B * S + H)
    if shared:
        xc = torch.randn((B, S, H * hd + 2 * ds), generator=gen,
                         device="cuda").to(dtype)
        x = xc[..., :H * hd].reshape(B, S, H, hd)
        b = xc[..., H * hd:H * hd + ds][:, :, None].expand(B, S, H, ds)
        c = xc[..., H * hd + ds:][:, :, None].expand(B, S, H, ds)
    else:
        x = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        b = torch.randn((B, S, H, ds), generator=gen, device="cuda").to(dtype)
        c = torch.randn((B, S, H, ds), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    A = torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    cum = (-dt * A).reshape(B, S // L, L, H).cumsum(2).reshape(B, S, H)
    args = (x, b, c, dt, cum, L)
    got = SSD.ssd_chunk_cuda(*args)
    torch.cuda.synchronize()
    want = SSD.ssd_chunk_plain(*args)
    err = max(compare(torch, f"ssd_chunk {name} {dtype} {part}", g, w, tol)
              for part, g, w in zip(("y", "state", "decay"), got, want))
    ms = timer(lambda: SSD.ssd_chunk_cuda(*args))
    plain_ms = timer(lambda: SSD.ssd_chunk_plain(*args), iters=3)
    nc, elt = S // L, x.element_size()
    bc_heads = 1 if shared else H
    nbytes = (x.numel() * elt + 2 * B * S * bc_heads * ds * elt   # x, b, c
              + 2 * B * S * H * 4                                 # dt, cum
              + B * S * H * (hd + 1) * 4 + B * nc * H * hd * ds * 4)
    tri = L * (L + 1) // 2                  # (t, s) pairs with s <= t
    fmas = B * nc * (bc_heads * tri * ds + H * (tri * hd + L * hd * ds))
    # the products' operations at the peak of the inputs' type (bf16 on
    # the tensor cores, fp32 on the CUDA cores); beside it the bound
    # against the fp32 peak, as stated before the tensor-core instance
    bound_ms, bound_by = bound(nbytes, 2 * fmas, dtype)
    fp32_peak_ms, _ = bound(nbytes, 2 * fmas, torch.float32)
    return {"case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"x": list(x.shape), "bc": [B, S, bc_heads, ds],
                      "chunk": L, "bc_shared": shared},
            "tol": tol, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "bound_at_fp32_peak_ms": fp32_peak_ms}


def kernel_phase(torch):
    timer = Timer(torch)
    # what the timer gives a kernel that does nothing: the floor under every
    # small case below (launch and event latency after the L2 flush)
    print(f"timer floor: an empty kernel (torch.cuda._sleep(0)) measures "
          f"{timer(lambda: torch.cuda._sleep(0), iters=30)} ms")
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    # a mixed batch (C = 64 prefill chunks, one partial, and decode rows)
    # and a pure-decode batch, contexts up to 2048
    mixed = [(64, 64), (2048, 64), (576, 64), (1000, 40),
             (2048, 1), (1024, 1), (17, 1), (1, 1)]
    # speculative verify rows (1 + a draft of up to 4) at decode rows'
    # contexts, in the engine's C = 8 bucket: the tile path, not the C == 1
    # decode split
    verify = [(2048, 5), (1536, 4), (1024, 3), (777, 2), (512, 5), (256, 1),
              (100, 4), (49, 2)]
    # the mixed_prefix_spec path's second step: five prefill rows past a
    # 48-token cached prefix (C = 32) beside the first request's decode row
    prefix_hit = [(52, 1), (54, 6), (57, 9), (60, 12), (63, 15), (66, 18)]
    # the serving chunk against a dense cache of 2048: 8 rows of C = 64 at
    # offsets spread over [0, 1984], the last at the dummy offset s_max - C
    chunk_offsets = [0, 256, 576, 832, 1088, 1344, 1664, 1984]
    cases = {k: [] for k in ("paged_ragged_attention", "rmsnorm",
                             "flash_attention", "decode_attention",
                             "paged_decode_attention", "ssd_chunk")}

    def add(kernel, case):
        cases[kernel].append(case)
        print(kernel, json.dumps(case))

    for dtype in (torch.bfloat16, torch.float32):
        tol = tols[dtype]
        for name, rows in (("mixed", mixed), ("decode", DECODE_ROWS)):
            add("paged_ragged_attention",
                attention_case(torch, name, rows, dtype, timer, tol))
        add("paged_ragged_attention", attention_case(
            torch, "verify, C 8", verify, dtype, timer, tol, C=8))
        add("paged_ragged_attention", attention_case(
            torch, "prefix-hit prefill, C 32", prefix_hit, dtype, timer, tol,
            C=32))
        if dtype == torch.bfloat16:
            # long prefill chunks: the tensor-core tiles at a larger width
            add("paged_ragged_attention", attention_case(
                torch, "long prefill", [(2048, 256)] * 2, dtype, timer, tol))
        # one rank of the layout phase's grid (G = 4): 8 q heads and 2 kv
        # heads, a 4x smaller grid, which plans its own cluster split
        for name, rows in (("mixed, per rank", mixed),
                           ("decode, per rank", DECODE_ROWS)):
            add("paged_ragged_attention", attention_case(
                torch, name, rows, dtype, timer, tol, Hq=32 // 4, Hkv=8 // 4))
        # N = 512: the first serving step's padded token rectangle (8 rows
        # x 64 columns); q_norm/k_norm run over N x 32 (x 8) head rows of
        # 128. A decode step: 8 rows, 256 q and 64 k head rows; mamba2's
        # d_model 2048 and its grouped norm over 64 heads of 64.
        for name, N, D, H in (("hidden", 512, 4096, None),
                              ("heads", 512 * 32, 128, None),
                              ("grouped", 8 * 64 * 64, 64, 64),
                              ("decode hidden", 8, 4096, None),
                              ("decode q heads", 8 * 32, 128, None),
                              ("decode k heads", 8 * 8, 128, None),
                              ("mamba2 decode hidden", 8, 2048, None),
                              ("mamba2 decode grouped", 8 * 64, 64, 64)):
            add("rmsnorm", rmsnorm_case(torch, name, N, D, dtype, timer, tol,
                                        H=H))
        for name, T in (("pair, prefill", 512), ("pair, decode", 8)):
            add("rmsnorm", rmsnorm_pair_case(torch, name, T * 32, T * 8, 128,
                                             dtype, timer, tol))
        # one rank of the layout phase's grid: the pair over 8 q and 2 k
        # heads per token (the first step's 512 tokens, after the
        # exchange; a decode step's 8), ln1/ln2 over its 256 columns
        for name, T in (("pair, prefill, per rank", 512),
                        ("pair, decode, per rank", 8)):
            add("rmsnorm", rmsnorm_pair_case(torch, name, T * 8, T * 2, 128,
                                             dtype, timer, tol))
        add("rmsnorm", rmsnorm_case(torch, "hidden, per sp rank", 256, 4096,
                                    dtype, timer, tol))
        # mamba2-1.3b (64 heads of 64, d_state 128, chunk 64): the serving
        # prefill step (8 rows of 64), a long prompt (32 chunks), a short
        # chunk (S < 64), and the serving step as the TPU contract's
        # per-(head, chunk) copies (no c.b^T shared across heads)
        for name, B, S, H, L, shared in (
                ("serving step", 8, 64, 64, 64, True),
                ("long prompt", 1, 2048, 64, 64, True),
                ("short chunk", 8, 19, 64, 19, True),
                ("TPU contract copies", 8 * 64, 64, 1, 64, False)):
            add("ssd_chunk", ssd_chunk_case(torch, name, B, S, H, 64, 128, L,
                                            shared, dtype, timer))
        add("flash_attention", flash_case(
            torch, "serving chunk", 8, 64, 2048, chunk_offsets, True, dtype,
            timer, tol))
        add("flash_attention", flash_case(
            torch, "TPU contract", 1, 2048, 2048, [0], True, dtype, timer,
            tol))
        add("flash_attention", flash_case(
            torch, "non-causal", 2, 128, 256, [0, 0], False, dtype, timer,
            tol, Hq=8, Hkv=2, D=64))
        if dtype == torch.bfloat16:
            add("flash_attention", flash_case(
                torch, "serving chunk C 256", 8, 256, 2048,
                [0, 256, 512, 768, 1024, 1280, 1536, 1792], True, dtype,
                timer, tol))
        add("decode_attention", decode_case(
            torch, "decode", [c for c, _ in DECODE_ROWS], 2048, dtype, timer,
            tol))
        # one sequence of 2048: 8 (sequence, kv head) pairs for 132 SMs
        add("decode_attention", decode_case(
            torch, "B 1", [2048], 2048, dtype, timer, tol))
        add("paged_decode_attention", paged_decode_case(
            torch, "decode", DECODE_ROWS, dtype, timer, tol))
        torch.cuda.synchronize()
    return cases


# ---------------------------------------------------------------------------
# phase 4: the reduced engine on the card against the same on the CPU
# ---------------------------------------------------------------------------
def cross_device_phase(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch.serve import workload
    from repro_torch.models import Model
    cfg = get_config("qwen3-8b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device="cuda", dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())

    tight = {"num_blocks": 9, "block_size": 8}
    for kw in ({}, tight, {"mixed": False}, {"mixed": False, **tight},
               {"paged": False, "mixed": False}):
        runs = []
        for model in (gpu, cpu):
            eng = ShiftEngine(model, EngineConfig(**kw))
            reqs = workload(6, 16)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            runs.append(([r.generated for r in reqs], eng.config_counts,
                         eng.preemptions,
                         eng.kv.num_free_blocks if eng.paged else None,
                         timeless(eng.obs.dump())))
        check(runs[0][:4] == runs[1][:4], f"reduced engine "
              f"{kw or 'no pressure'}: cuda {runs[0][:4]} != cpu "
              f"{runs[1][:4]}")
        check(runs[0][4] == runs[1][4], f"reduced engine "
              f"{kw or 'no pressure'}: the cuda and cpu obs dumps differ "
              "(time fields dropped)")
        print(f"reduced engine {kw or 'no pressure'}: cuda == cpu (streams, "
              f"obs dumps less time fields), configs {runs[0][1]}, "
              f"{runs[0][2]} preemptions, {len(runs[0][4]['events'])} "
              "events")

    # one mixed step's logits: a prefill row, a decode row, a padding row
    # and a chunk whose padding overhangs the table
    bt = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 0]], np.int32)
    rng = np.random.default_rng(1)
    err = 0.0
    for model in (gpu, cpu):
        model.init_paged_cache(9, 4)
    for ql, off in (([8, 6, 0, 0], [0, 0, 0, 0]), ([1, 4, 0, 5], [8, 6, 0, 0])):
        toks = rng.integers(1, cfg.vocab_size, (4, 8)).astype(np.int32)
        lg = [m.forward_mixed(toks, ql, off, bt, sample=False)[0].cpu()
              for m in (gpu, cpu)]
        err = max(err, (lg[0] - lg[1]).abs().max().item())
        check(torch.allclose(lg[0], lg[1], atol=1e-4, rtol=1e-4),
              f"reduced logits cuda vs cpu: max abs err {err}")
    torch.cuda.synchronize()
    print(f"reduced mixed-step logits cuda vs cpu: max abs err {err} "
          "(tol 1e-4)")

    # one dense prefill (rows at offsets 0 and 5, a dummy row at
    # s_max - C) and two decode steps' logits
    err = 0.0
    for model in (gpu, cpu):
        model.init_cache(3, 32)
    toks = rng.integers(1, cfg.vocab_size, (3, 8)).astype(np.int32)
    lg = [m.prefill(toks, [0, 5, 24])[0].cpu() for m in (gpu, cpu)]
    steps = [lg]
    for lens in ([8, 13, 0], [9, 14, 0]):
        tok = lg[1].argmax(-1).int().numpy() * (np.array(lens) > 0)
        lg = [m.decode(tok, lens, sample=False)[0].cpu() for m in (gpu, cpu)]
        steps.append(lg)
    for a, b in steps:
        err = max(err, (a - b).abs().max().item())
        check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
              f"reduced dense logits cuda vs cpu: max abs err {err}")
    print(f"reduced dense prefill + decode logits cuda vs cpu: max abs err "
          f"{err} (tol 1e-4)")
    prefix_spec_cross_device(torch, gpu, cpu)
    fault_cross_device(torch, gpu, cpu)
    mamba2_cross_device(torch)


def prefix_spec_cross_device(torch, gpu, cpu):
    """The prefix cache and speculation on reduced qwen3-8b at fp32: the
    mixed engine with ``PrefixConfig(enabled=True)`` and ``SpecConfig(k=4)``
    on the workload after a 16-token shared prefix, with and without pool
    pressure, on the card and on the CPU: equal streams, cached tokens,
    prefix stats, spec counts, preemptions and config counts. Then the
    fork + COW case on both devices: a 12-token sequence forked, its
    half-full tail block copied in place for the fork (the copy equal to
    its source bitwise, the pool's addresses kept), and three decode steps
    of different continuations on both rows, with equal streams."""
    import numpy as np
    from repro_torch.cache import PagedKVCache
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.launch.serve import workload
    from repro_torch.spec import SpecConfig
    for kw in ({}, {"num_blocks": 13, "block_size": 8}):
        runs = []
        for model in (gpu, cpu):
            eng = ShiftEngine(model, EngineConfig(
                prefix=PrefixConfig(enabled=True), spec=SpecConfig(k=4), **kw))
            reqs = workload(6, 16, shared_prefix=16)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            led = eng.block_accounting()
            check(led.used == led.pinned == eng.prefix_stats.entries,
                  f"reduced prefix + spec {kw}: blocks held at exit {led}")
            runs.append(([r.generated for r in reqs],
                         [r.cached_tokens for r in reqs],
                         eng.prefix_stats.as_dict(),
                         spec_counts(eng), eng.preemptions,
                         eng.config_counts))
        check(runs[0] == runs[1], f"reduced prefix + spec {kw}: cuda "
              f"{runs[0][1:]} != cpu {runs[1][1:]}")
        _, cached, stats, spec, pre, counts = runs[0]
        check(stats["hits"] > 0 and spec[0] > 0,
              f"reduced prefix + spec {kw}: no hit or no draft")
        print(f"reduced prefix + spec engine {kw or 'no pressure'}: cuda == "
              f"cpu; cached tokens {cached}; prefix {stats}; drafted "
              f"{spec[0]}, accepted {spec[1]}, rollback blocks {spec[2]}; "
              f"{pre} preemptions; configs {counts}")

    prompt = np.random.default_rng(1).integers(
        1, gpu.cfg.vocab_size, 12).tolist()
    streams = []
    for model in (gpu, cpu):
        model.init_paged_cache(8, 8)
        kv = PagedKVCache(8, 8, 2, 4)
        kv.ensure(0, 12)
        bt = np.zeros((2, 4), np.int32)
        bt[0, :2] = kv.seq_blocks(0)
        toks = np.zeros((2, 12), np.int32)
        toks[0] = prompt
        model.prefill(toks, [0, 0], bt)
        kv.fork(0, 1)
        ok, copies = kv.copy_on_write(1, 12, 13)
        check(ok and len(copies) == 1, f"fork + COW: copies {copies}")
        (src, dst), = copies
        addr = model.pool.k.data_ptr()
        model.copy_blocks([src], [dst])
        check(model.pool.k.data_ptr() == addr and all(
            torch.equal(p[:, dst], p[:, src])
            for p in (model.pool.k, model.pool.v)),
            f"fork + COW on {model.device}: the copy is not in place or "
            "differs from its source")
        bt[1, :2] = kv.seq_blocks(1)
        t, lens, out = np.array([7, 11], np.int32), np.array([12, 12]), []
        for _ in range(3):
            t, _ = model.decode(t, lens, bt)
            t = t.cpu().numpy().astype(np.int32)
            out.append(t.tolist())
            lens = lens + 1
        streams.append(out)
    check(streams[0] == streams[1],
          f"fork + COW: cuda {streams[0]} != cpu {streams[1]}")
    print(f"reduced fork + COW (12 tokens, the tail block copied in place): "
          f"cuda == cpu, decode steps of both rows {streams[0]}")


# the reduced fault run's plan: (step, seam, kind); an alloc fault, both
# kinds of forward fault and a route fault on the serve workload
FAULT_PLAN = [(0, "alloc", ""), (3, "forward", "nan"),
              (6, "forward", "raise"), (9, "route", "")]


def fault_cross_device(torch, gpu, cpu):
    """The mixed paged engine on reduced qwen3-8b at fp32 under
    ``FAULT_PLAN`` with ``quarantine_after`` 10 (every request ends OK), on
    the card and on the CPU, beside a clean run on each: the faulted
    streams equal the clean ones on both devices and the card's equal the
    CPU's, with equal outcomes, fail counts, failed steps, retries,
    preemptions, block ledgers and observability dumps (less their time
    fields); two steps failed, every block is free at exit."""
    from repro_torch.engine import EngineConfig, FaultConfig, ShiftEngine
    from repro_torch.ft import Fault, FaultPlan
    from repro_torch.launch.serve import workload
    runs = []
    for model in (gpu, cpu):
        streams = []
        for plan in (None, FaultPlan([Fault(step, seam, kind=kind)
                                      for step, seam, kind in FAULT_PLAN])):
            eng = ShiftEngine(model, EngineConfig(
                fault=FaultConfig(quarantine_after=10)), faults=plan)
            reqs = workload(6, 16)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            streams.append([r.generated for r in reqs])
        reg = eng.obs.registry
        runs.append((streams, [str(r.finish_reason) for r in reqs],
                     [r.fail_count for r in reqs],
                     {name: int(reg.counter_total(name)) for name in (
                         "faults_injected_total", "failed_steps_total",
                         "retries_total")},
                     eng.preemptions, eng.block_accounting().as_dict(),
                     eng.kv.num_blocks, timeless(eng.obs.dump())))
    check(runs[0][:7] == runs[1][:7], f"reduced fault run: cuda "
          f"{runs[0][1:7]} != cpu {runs[1][1:7]}")
    check(runs[0][7] == runs[1][7], "reduced fault run: the cuda and cpu "
          "obs dumps differ (time fields dropped)")
    (clean, faulted), reasons, fails, counters, pre, led, nb, _ = runs[0]
    check(faulted == clean and set(reasons) == {"ok"},
          f"reduced fault run: faulted streams differ from the clean ones "
          f"or a request failed: {reasons}")
    check(counters["faults_injected_total"] == len(FAULT_PLAN)
          and counters["failed_steps_total"] == 2
          and counters["retries_total"] > 0 and pre > 0,
          f"reduced fault run: counters {counters}, {pre} preemptions")
    check(led["used"] == led["pinned"] == 0 and led["free"] == nb - 1,
          f"reduced fault run: blocks held at exit {led}")
    print(f"reduced fault run {FAULT_PLAN}: cuda == cpu == the clean run "
          f"(streams), equal obs dumps less time fields; fail counts "
          f"{fails}; {counters}; {pre} preemptions; ledger {led}")


def mamba2_cross_device(torch):
    """Reduced mamba2 at fp32 through the dense serialized fallback: one
    request alone, two in flight on two slots (each step's dummy rows
    advance the idle slot's SSD state, as in the reference), and the
    workload's 6 requests on 4 slots; then one dense prefill + decode's
    logits (tol 1e-4, fp32 on both sides)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, Request, ShiftEngine
    from repro_torch.launch.serve import workload
    from repro_torch.models import Model
    cfg = get_config("mamba2-1.3b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device="cuda", dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    a, b = list(range(3, 14)), list(range(40, 60))
    for label, slots, prompts in (("one request", 1, [a]),
                                  ("two in flight", 2, [a, b]),
                                  ("6 requests on 4 slots", 4, None)):
        runs = []
        for model in (gpu, cpu):
            eng = ShiftEngine(model, EngineConfig(max_slots=slots, s_max=64,
                                                  prefill_chunk=8))
            check(not eng.paged and not eng.mixed,
                  "mamba2 must fall back to the dense serialized engine")
            reqs = (workload(6, 8) if prompts is None else
                    [Request(i, p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            runs.append(([r.generated for r in reqs], eng.config_counts))
        check(runs[0] == runs[1], f"reduced mamba2 {label}: cuda {runs[0]} "
              f"!= cpu {runs[1]}")
        print(f"reduced mamba2 dense engine, {label}: cuda == cpu, configs "
              f"{runs[0][1]}, streams {runs[0][0][:2]}")
    err = 0.0
    for model in (gpu, cpu):
        model.init_cache(3, 32)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (3, 16)).astype(np.int32)
    lg = [m.prefill(toks, [0, 0, 16])[0].cpu() for m in (gpu, cpu)]
    steps = [lg]
    for lens in ([16, 16, 0], [17, 17, 0]):
        tok = lg[1].argmax(-1).int().numpy() * (np.array(lens) > 0)
        lg = [m.decode(tok, lens, sample=False)[0].cpu() for m in (gpu, cpu)]
        steps.append(lg)
    for g, c in steps:
        err = max(err, (g - c).abs().max().item())
        check(torch.allclose(g, c, atol=1e-4, rtol=1e-4),
              f"reduced mamba2 logits cuda vs cpu: max abs err {err}")
    print(f"reduced mamba2 dense prefill (2 SSD chunks) + decode logits cuda "
          f"vs cpu: max abs err {err} (tol 1e-4)")


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------
def delta(after, before):
    """``after`` less ``before``, key by key (registry totals read before
    and after a measured run)."""
    return {k: after[k] - before.get(k, 0) for k in after}


def spec_counts(eng):
    """Draft tokens verified, accepted and blocks rolled back: the
    engine's registry totals."""
    reg = eng.obs.registry
    return tuple(int(reg.counter_total(name)) for name in (
        "spec_proposed_total", "spec_accepted_total",
        "spec_rollback_blocks_total"))


def fresh_obs(eng, enabled=True):
    """Give ``eng`` a new, empty observability surface (``NullObs`` when
    not ``enabled``), so that a dump covers the run after this call."""
    from repro_torch.obs import NullObs, Observability
    eng.obs = (Observability("engine", window=eng.cfg.obs.window,
                             now=eng.now, event_cap=eng.cfg.obs.event_cap)
               if enabled else NullObs(now=eng.now))
    return eng.obs


def timeless(dump):
    """``dump`` without what reads the wall clock: the records' and
    events' time fields (``ts``, ``t_start``, ``dur_s``, ``arrival`` and
    every ``*_s`` attribute), the sums and buckets of the ``*_seconds``
    histograms, and the watchdog's ``straggler`` events and counter (it
    flags by wall time); the events keep their order, not their ``seq``."""
    def keep(k):
        return k not in ("ts", "t_start", "dur_s", "arrival", "seq") \
            and not k.endswith("_s")

    m = dump["metrics"]
    return {
        "source": dump["source"], "events_dropped": dump["events_dropped"],
        "steps": [{k: v for k, v in r.items() if keep(k)}
                  for r in dump["steps"]],
        "events": [{k: v for k, v in e.items() if keep(k)}
                   for e in dump["events"] if e["kind"] != "straggler"],
        "metrics": {
            "counters": [c for c in m["counters"]
                         if c["name"] != "straggler_steps_total"],
            "gauges": m["gauges"],
            "histograms": [dict(h, sum=None, buckets=None)
                           if h["name"].endswith("_seconds") else h
                           for h in m["histograms"]]}}


def count_steps(eng):
    """Count the engine's productive steps of each kind from here on:
    {"mixed": n, "prefill": n, "decode": n}."""
    kinds = {"mixed": 0, "prefill": 0, "decode": 0}

    def counted(kind, run):
        def wrapper():
            did = run()
            kinds[kind] += int(did)
            return did
        return wrapper

    for kind in kinds:
        name = f"_run_{kind}"
        setattr(eng, name, counted(kind, getattr(eng, name)))
    return kinds


def step_launches(eng, kind):
    """Each kernel's launches in one full-width engine step of ``kind``
    ("mixed", "prefill" or "decode"): ln1, ln2 and the q_norm + k_norm pair
    (one launch) per attention layer, ln1 and the grouped norm per SSD
    layer, and the final norm; one attention per attention layer, by the
    kernel of the step's kind and cache; one SSD chunk launch per SSD layer
    in a prefill step, none in a decode step."""
    kinds = eng.mcfg.layer_kinds
    n_attn, n_ssd = kinds.count("attn"), kinds.count("ssd")
    attention = ("paged_ragged_attention" if eng.paged else
                 "flash_attention" if kind == "prefill" else
                 "decode_attention")
    out = {"rmsnorm": 3 * n_attn + 2 * n_ssd + 1}
    if n_attn:
        out[attention] = n_attn
    if n_ssd and kind != "decode":
        out["ssd_chunk"] = n_ssd
    return out


def port_kernel(name):
    """The port kernel whose launch counter a kernel name in the profiler's
    trace belongs to, or None for any other kernel."""
    for part, kernel in (("paged_ragged_attention", "paged_ragged_attention"),
                         ("flash_attention", "flash_attention"),
                         ("rmsnorm_kernel", "rmsnorm"),
                         ("ssd_chunk", "ssd_chunk")):
        if part in name:
            return kernel
    if "decode_attention" in name:
        # one source, templated on how a key is addressed
        return ("paged_decode_attention" if "PagedKeys" in name
                else "decode_attention")
    return None


def serve_path(torch, eng, label):
    """The main path through ``eng``: a warm-up run of the workload (cuBLAS's
    caches, the kernels' first launches), then the measured run with every launch counter
    set to 0 just before it and read just after. Checks the requests and
    the counters against the per-step counts; returns the requests."""
    from repro_torch.launch import serve
    cfg = eng.mcfg
    for r in serve.workload(6, 16):
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    counts0 = dict(eng.config_counts)
    kinds = count_steps(eng)
    reqs = serve.workload(6, 16)
    captured = eng.deploy.captures
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = serve.launch_counts()
    counts = delta(eng.config_counts, counts0)
    steps = sum(counts.values())
    # the warm-up run stepped through every bucket of the workload, so the
    # measured run only replays
    check(eng.deploy.captures == captured,
          f"{label}: {eng.deploy.captures - captured} captures in the "
          "measured run")

    for r in reqs:
        check(len(r.generated) == 16 and r.finish_reason == "ok",
              f"{label}: request {r.rid}: {len(r.generated)} tokens, "
              f"{r.finish_reason}")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{label}: request {r.rid}: token out of range")
    if eng.paged:
        check(eng.kv.num_free_blocks == eng.kv.num_blocks - 1,
              f"{label}: leaked blocks: {eng.kv.num_free_blocks} free of "
              f"{eng.kv.num_blocks}")
    check(steps == sum(kinds.values()), f"{label}: {steps} steps, {kinds}")
    n_attn = cfg.layer_kinds.count("attn")
    n_ssd = cfg.layer_kinds.count("ssd")
    want = {name: 0 for name in launches}
    for kind, n in kinds.items():
        for name, k in step_launches(eng, kind).items():
            want[name] += n * k
    check(launches == want, f"{label}: launches {launches} over steps "
          f"{kinds}, want {want}")

    ttft = [r.first_token_time - r.arrival for r in reqs]
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    dec_tok = sum(len(r.generated) - 1 for r in reqs)
    stats = {"wall_ms_per_decode_step": (t_last - t_first) / 15 * 1e3,
             "ttft_ms": [t * 1e3 for t in ttft],
             "decode_tokens_per_s": dec_tok / (t_last - t_first)}
    print(f"{label}: served 6 requests x 16 tokens in {wall:.3f} s over "
          f"{steps} steps {kinds}; configs {counts}; "
          f"{eng.preemptions} preemptions"
          + (f"; {eng.kv.num_free_blocks} of {eng.kv.num_blocks} blocks "
             "free at exit" if eng.paged else ""))
    print(f"{label}: TTFT ms: " + ", ".join(f"{t * 1e3:.1f}" for t in ttft))
    print(f"{label}: decode: {dec_tok} tokens in "
          f"{(t_last - t_first) * 1e3:.1f} ms, "
          f"{dec_tok / (t_last - t_first):.1f} tokens/s, "
          f"{(t_last - t_first) / 15 * 1e3:.2f} ms per step")
    print(f"{label}: launches: {json.dumps(launches)}; per step: "
          f"{3 * n_attn + 2 * n_ssd + 1} rmsnorm, {n_attn} attention, "
          f"{n_ssd} ssd_chunk per prefill step and 0 per decode step")
    return reqs, launches, stats


def shared_tokens(reqs, ref):
    """Tokens of each request's stream that agree with ``ref``'s before
    the first difference, summed."""
    n = 0
    for r, q in zip(reqs, ref):
        for a, b in zip(r.generated, q.generated):
            if a != b:
                break
            n += 1
    return n


# eager tables first and last, graphed ones between: a drift of the host
# over the run shows as a difference between the two eager turns
TURNS = (False, True, True, False)


def serve_turns(torch, model, kw, label):
    """One serving path in turns on ``model``: eager, graphed, graphed and
    eager step tables, each on a new engine (``EngineConfig(**kw)``, its
    cache initialised anew) with the same workload. Each turn runs
    ``serve_path`` and then ``profile_decode``. The eager tables are built
    here, explicitly; the engine always builds the graphed ones. Checks
    that the streams and the launch counts of every turn are equal and
    that an eager turn captures nothing. Returns the first graphed turn's
    requests and launches, and every turn's numbers."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.deployment import Deployment
    turns = []
    for graphed in TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        eng = ShiftEngine(model, EngineConfig(**kw))
        if not graphed:
            eng.deploy = Deployment.build(model, model, mixed=eng.mixed,
                                          paged=eng.paged, graphed=False)
        name = f"{label} [{'graphed' if graphed else 'eager'}]"
        reqs, launches, stats = serve_path(torch, eng, name)
        stats.update(profile_decode(torch, eng, label=name))
        stats.update(graphed=graphed, graphs_captured=eng.deploy.captures,
                     capture_ms=(eng.deploy.graphs.capture_s * 1e3
                                 if graphed else 0.0))
        check(graphed or eng.deploy.captures == 0,
              f"{name}: the eager tables captured")
        turns.append((reqs, launches, stats))
        del eng
    streams = [[r.generated for r in reqs] for reqs, _, _ in turns]
    check(all(s == streams[0] for s in streams),
          f"{label}: the graphed and eager streams differ: {streams}")
    check(all(launches == turns[0][1] for _, launches, _ in turns),
          f"{label}: launch counts differ between turns: "
          f"{[launches for _, launches, _ in turns]}")
    for _, _, st in turns:
        print(f"{label} turn: " + json.dumps(st))
    print(f"{label}: eager, graphed, graphed, eager: equal streams and "
          "launch counts; per turn wall ms per decode step "
          + ", ".join(f"{st['wall_ms_per_decode_step']:.2f}"
                      for _, _, st in turns)
          + "; device busy ms per profiled decode step "
          + ", ".join(f"{st['busy_ms_per_step']:.2f} "
                      f"({st['busy_share']:.1%})" for _, _, st in turns))
    first = next(t for t in turns if t[2]["graphed"])
    return first[0], first[1], [st for _, _, st in turns]


def graph_logits_check(torch, model, paged, calls, label):
    """Full-width logits of captured entries against the eager steps, each
    side on a freshly initialised small cache: ``calls`` is a list of
    (step, host arrays), with step "mixed", "prefill" or "decode"; the
    first call of each bucket runs eagerly and captures, later ones
    replay. Fails unless every output is finite and within the kernels'
    bf16 tolerance of the eager one; prints the max abs difference."""
    from repro_torch.engine.deployment import CapturedStep, GraphPool
    steps = {"mixed": lambda *a: model.mixed_step(*a, sample=False),
             "prefill": model.prefill_step,
             "decode": lambda *a: model.decode_step(*a, sample=False)}
    graphs, outs = GraphPool(), []
    for pool in (None, graphs):
        if paged:
            model.init_paged_cache(9, 16)
        else:
            model.init_cache(2, 32)
        entries = {k: CapturedStep(fn, model, paged, pool)
                   for k, fn in steps.items()}
        outs.append([entries[k](*args).clone() for k, args in calls])
        torch.cuda.synchronize()
    err = 0.0
    for (kind, _), want, got in zip(calls, *outs):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{label}: graphed {kind} logits {tuple(got.shape)}")
        err = max(err, (got - want).abs().max().item())
    check(err <= 2e-2, f"{label}: graphed vs eager logits: max abs diff "
          f"{err} > 2e-2")
    print(f"{label}: graphed vs eager logits over {len(calls)} calls "
          f"({graphs.captures} captured, {len(calls) - graphs.captures} "
          f"replayed): max abs diff {err}"
          + (" (bitwise equal)" if err == 0 else ""))
    return err


# the prefix + spec path: the serve workload after a 32-token shared prefix
# (two blocks), with the prefix cache and k=4 drafts
PS_SHARED, PS_K = 32, 4


def count_waits(eng):
    """Count the admissions that wait for an in-flight same-prefix prefill
    from here on: {"waits": n}."""
    n = {"waits": 0}
    wait = eng._wait_for_inflight

    def counted(req, row, matched):
        did = wait(req, row, matched)
        n["waits"] += int(did)
        return did
    eng._wait_for_inflight = counted
    return n


def graphs_by_width(d):
    """CUDA graphs captured so far by verify width, over the deployment's
    distinct entries (on one rank base and shift share each entry)."""
    out, seen = {}, set()
    for (_, n), e in ([(("plain", 1), e) for e in d.forward.values()]
                      + list(d.spec_forward.items())):
        if id(e) not in seen:
            seen.add(id(e))
            out[f"n_last={n}"] = out.get(f"n_last={n}", 0) + len(e.buckets)
    return out


def prefix_spec_path(torch, eng, label):
    """One turn of the prefix + spec path on ``eng``: a warm-up run of the
    workload, then every cached entry evicted, so that the measured run
    starts from a cold cache as the warm-up did and steps through the same
    buckets; the measured run with every launch counter set to 0 just
    before it and read just after. Checks the requests, a prefix hit and an
    in-flight wait in the measured run, drafts when speculating, the blocks
    at exit (none held by a request, the index's pins its entries), no
    capture, and the launches against the per-step counts."""
    from repro_torch.launch import serve
    cfg = eng.mcfg
    waits = count_waits(eng)
    for r in serve.workload(6, 16, shared_prefix=PS_SHARED):
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    eng.prefix.evict(len(eng.prefix))
    check(len(eng.prefix) == 0 and eng.block_accounting().used == 0,
          f"{label}: the cache did not empty: {eng.block_accounting()}")
    before = eng.prefix_stats.as_dict()
    spec0 = spec_counts(eng)
    counts0 = dict(eng.config_counts)
    waits["waits"] = 0
    kinds = count_steps(eng)
    reqs = serve.workload(6, 16, shared_prefix=PS_SHARED)
    captured = eng.deploy.captures
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = serve.launch_counts()
    counts = delta(eng.config_counts, counts0)
    steps = sum(counts.values())
    check(eng.deploy.captures == captured,
          f"{label}: {eng.deploy.captures - captured} captures in the "
          "measured run")
    for r in reqs:
        check(len(r.generated) == 16 and r.finish_reason == "ok"
              and all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{label}: request {r.rid}: {len(r.generated)} tokens, "
              f"{r.finish_reason}")
    after = eng.prefix_stats.as_dict()
    stats = {k: after[k] - before[k] for k in
             ("hits", "misses", "tokens_saved", "evictions", "cow_copies")}
    spec = tuple(a - b for a, b in zip(spec_counts(eng), spec0))
    check(stats["hits"] > 0 and waits["waits"] > 0,
          f"{label}: prefix {stats}, {waits['waits']} in-flight waits")
    check(spec[0] > 0 or not eng.cfg.spec.k, f"{label}: no draft")
    led = eng.block_accounting()
    check(led.used == led.pinned == after["entries"],
          f"{label}: blocks at exit {led}, {after['entries']} entries")
    check(steps == kinds["mixed"], f"{label}: {steps} steps, {kinds}")
    want = {name: 0 for name in launches}
    for name, k in step_launches(eng, "mixed").items():
        want[name] += steps * k
    check(launches == want, f"{label}: launches {launches} over {steps} "
          f"steps, want {want}")
    ttft = [r.first_token_time - r.arrival for r in reqs]
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    dec_tok = sum(len(r.generated) - 1 for r in reqs)
    out = {"steps": steps, "configs": counts,
           "wall_ms_per_step": wall / steps * 1e3,
           "ttft_ms": [t * 1e3 for t in ttft],
           "decode_tokens_per_s": dec_tok / (t_last - t_first),
           "tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
           "prefix": stats, "inflight_waits": waits["waits"],
           "cached_tokens": [r.cached_tokens for r in reqs],
           "spec_proposed": spec[0], "spec_accepted": spec[1],
           "spec_rollback_blocks": spec[2],
           "graphs_by_width": graphs_by_width(eng.deploy)}
    print(f"{label}: served 6 requests x 16 tokens after a {PS_SHARED}-token "
          f"shared prefix in {wall:.3f} s over {steps} steps "
          f"{counts}; prefix {stats}, {waits['waits']} in-flight "
          f"waits, cached tokens {out['cached_tokens']}; drafted {spec[0]}, "
          f"accepted {spec[1]}, rollback blocks {spec[2]}; "
          f"{out['wall_ms_per_step']:.2f} ms per step, TTFT ms "
          + ", ".join(f"{t:.1f}" for t in out["ttft_ms"])
          + f", {out['decode_tokens_per_s']:.1f} decode tokens/s; graphs "
          f"{out['graphs_by_width']}")
    return reqs, launches, out


def prefix_spec_phase(torch, model):
    """The ``mixed_prefix_spec`` path on the served model: the mixed engine
    with the prefix cache and ``k=4`` over the eager tables, then the
    graphed ones (streams and launches equal), then the graphed tables
    without speculation (how many steps the drafts saved, and how far the
    streams agree: bf16 goes through other tile shapes, so for
    information)."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.engine.deployment import Deployment
    from repro_torch.spec import SpecConfig
    turns = []
    for graphed, k in ((False, PS_K), (True, PS_K), (True, 0)):
        gc.collect()
        torch.cuda.empty_cache()
        eng = ShiftEngine(model, EngineConfig(
            prefix=PrefixConfig(enabled=True), spec=SpecConfig(k=k)))
        if not graphed:
            eng.deploy = Deployment.build(model, model, mixed=True,
                                          paged=True, graphed=False)
        name = (f"mixed prefix + spec k={k} "
                f"[{'graphed' if graphed else 'eager'}]")
        reqs, launches, st = prefix_spec_path(torch, eng, name)
        check(graphed or eng.deploy.captures == 0,
              f"{name}: the eager tables captured")
        st.update(graphed=graphed, spec_k=k,
                  graphs_captured=eng.deploy.captures)
        turns.append((reqs, launches, st))
        del eng
    (e_reqs, e_l, e_st), (g_reqs, g_l, g_st), (o_reqs, _, o_st) = turns
    check([r.generated for r in e_reqs] == [r.generated for r in g_reqs]
          and e_l == g_l and e_st["steps"] == g_st["steps"],
          "mixed prefix + spec: the eager and graphed turns differ")
    print(f"mixed prefix + spec: eager == graphed (streams, launches, "
          f"{g_st['steps']} steps); without drafts {o_st['steps']} steps: "
          f"{o_st['steps'] - g_st['steps']} steps saved; "
          f"{shared_tokens(g_reqs, o_reqs)} of 96 tokens agree with the "
          "spec-off stream before their first difference (for information)")
    for _, _, st in turns:
        print("mixed prefix + spec turn: " + json.dumps(st))
    return g_l, [st for _, _, st in turns]


def serving_phase(torch):
    import numpy as np
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    t0 = time.monotonic()
    eng = serve.build_engine("qwen3-8b", device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cfg = eng.mcfg
    print(f"qwen3-8b full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_params() / 1e9:.3f} B params "
          f"({cfg.num_params() * 2 / 1e9:.2f} GB bf16), built in "
          f"{time.monotonic() - t0:.1f} s")
    pool = eng.model.pool
    pool_bytes = 2 * pool.k.numel() * pool.k.element_size()
    print(f"paged pool: {eng.kv.num_blocks} blocks x {eng.cfg.block_size} "
          f"tokens x {cfg.num_layers} layers, {pool_bytes / 1e6:.1f} MB")
    torch.cuda.reset_peak_memory_stats()
    by_path, turns = {}, {}
    model = eng.model
    del eng
    mixed_reqs, by_path["mixed"], turns["mixed"] = serve_turns(
        torch, model, {}, "mixed paged")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the served model's logits on a small mixed batch over free blocks:
    # finite, of the expected shape
    model.init_paged_cache(9, 16)
    bt = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    toks = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    logits, _ = model.forward_mixed(toks, [8, 3], [0, 0], bt, sample=False)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"full-width logits {tuple(logits.shape)} not finite")
    graph_logits_check(torch, model, True, [
        ("mixed", (toks, [8, 3], [0, 0], bt)),
        ("mixed", (toks[:, ::-1].copy(), [1, 1], [8, 3], bt)),
        ("mixed", (toks, [1, 1], [9, 4], bt))], "qwen3-8b mixed")
    by_path["mixed_prefix_spec"], turns["mixed_prefix_spec"] = \
        prefix_spec_phase(torch, model)

    # the serialized iteration on the same weights: the paged pool, then
    # the dense contiguous cache
    for key, label, kw in (("serialized_paged", "serialized paged",
                            {"mixed": False}),
                           ("serialized_dense", "serialized dense",
                            {"paged": False, "mixed": False})):
        if not kw.get("paged", True):
            ser = ShiftEngine(model, EngineConfig(**kw))
            c = ser.model.cache
            print(f"dense cache: {ser.cfg.max_slots} slots x "
                  f"{ser.cfg.s_max} positions x {cfg.num_layers} layers, "
                  f"{2 * c.k.numel() * c.k.element_size() / 1e6:.1f} MB")
            del ser
        reqs, by_path[key], turns[key] = serve_turns(torch, model, kw, label)
        print(f"{label}: {shared_tokens(reqs, mixed_reqs)} of "
              f"{sum(len(r.generated) for r in reqs)} tokens agree with the "
              "mixed stream before their first difference (bf16 through "
              "other kernels; for information)")
        if not kw.get("paged", True):
            toks = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
            model.init_cache(2, 32)
            logits, _ = model.prefill(toks, [0, 24])
            torch.cuda.synchronize()
            check(tuple(logits.shape) == (2, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()),
                  f"full-width dense logits {tuple(logits.shape)} not finite")
            graph_logits_check(torch, model, False, [
                ("prefill", (toks, [0, 0], None)),
                ("prefill", (toks[:, ::-1].copy(), [8, 8], None)),
                ("decode", ([5, 7], [16, 16], None)),
                ("decode", ([9, 3], [17, 17], None))],
                "qwen3-8b dense prefill + decode")
    by_path["mixed_obs"], by_path["serialized_paged_obs"] = \
        obs_phase(torch, model)
    by_path["mixed_faults"] = recovery_phase(torch, model)
    print(f"card: {card_line()}")
    return by_path, turns


# ---------------------------------------------------------------------------
# phase 5b: observability and the request lifecycle on the served model
# ---------------------------------------------------------------------------
OBS_TURNS = (True, False, True, False)     # obs on, off, on, off


def count_configs(eng):
    """Count the configs ``eng``'s policy chooses from here on, apart from
    the registry: {"base": n, "shift": n}."""
    from collections import Counter
    chosen = Counter()
    choose = eng._choose

    def counted(*args, **kw):
        name = choose(*args, **kw)
        chosen[name] += 1
        return name

    eng._choose = counted
    return chosen


def obs_run(torch, eng, chosen):
    """One measured run of the serve workload on ``eng`` (warm, so only
    replays), every launch counter set to 0 just before and read just
    after. Returns the requests, the run's wall (the engine's clock), its
    steps and launches, the configs chosen and the wall per decode step."""
    from repro_torch.launch import serve
    reqs = serve.workload(6, 16)
    chosen.clear()
    captured, step0 = eng.deploy.captures, eng.step_count
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = serve.launch_counts()
    check(eng.deploy.captures == captured, "obs phase: a capture in a "
          "measured run")
    check(all(len(r.generated) == 16 and r.finish_reason == "ok"
              for r in reqs), "obs phase: a request did not finish")
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    return {"reqs": reqs, "wall_s": wall, "steps": eng.step_count - step0,
            "launches": launches, "chosen": dict(chosen),
            "wall_ms_per_decode_step": (t_last - t_first) / 15 * 1e3}


def step_kind(rec):
    if rec["prefill_tokens"] and rec["decode_tokens"]:
        return "mixed"
    return ("prefill" if rec["prefill_tokens"] else
            "decode" if rec["decode_tokens"] else "idle")


def check_dump(run, dump, label, mixed):
    """The dump of a measured run holds together: ``steps_total{config}``
    equals the configs chosen; the records' token sums equal the token
    counters, and these the prompts and the tokens the requests hold (the
    mixed iteration prefills a whole prompt and samples the first token in
    its last chunk; the serialized one leaves each prompt's last token to
    its first decode step); TTFT and E2E counted
    once per request; every ``finish`` event's ``ttft_s`` the request's own;
    the records' durations 0.95-1.0 of the run's wall; the Chrome trace
    round-trips through JSON with one "X" event per record. Returns the
    medians of ``dur_s`` by config and by kind of step, in ms."""
    from statistics import median
    from repro_torch.obs import chrome_trace
    reqs, steps = run["reqs"], dump["steps"]
    counters = {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
                for c in dump["metrics"]["counters"]}
    hists = {h["name"]: h for h in dump["metrics"]["histograms"]}
    by_config = {k: counters.get(("steps_total", (("config", k),)), 0)
                 for k in ("base", "shift")}
    check(by_config == {k: run["chosen"].get(k, 0) for k in by_config},
          f"{label}: steps_total {by_config}, chosen {run['chosen']}")
    pre = sum(r["prefill_tokens"] for r in steps)
    dec = sum(r["decode_tokens"] for r in steps)
    prompts = sum(len(r.prompt) for r in reqs)
    held = sum(len(r.generated) for r in reqs)
    want = (prompts, held - len(reqs)) if mixed \
        else (prompts - len(reqs), held)
    check((pre, dec) == want
          and pre == counters[("tokens_prefill_total", ())]
          and dec == counters[("tokens_decode_total", ())],
          f"{label}: records {pre} prefill + {dec} decode tokens, counters "
          f"{counters.get(('tokens_prefill_total', ()))} + "
          f"{counters.get(('tokens_decode_total', ()))}, want {want}")
    check(hists["ttft_seconds"]["count"] == hists["e2e_seconds"]["count"]
          == len(reqs), f"{label}: TTFT/E2E counts")
    by_rid = {r.rid: r for r in reqs}
    fins = [e for e in dump["events"] if e["kind"] == "finish"]
    check(len(fins) == len(reqs) and all(
        e["ttft_s"] == by_rid[e["rid"]].first_token_time
        - by_rid[e["rid"]].arrival for e in fins),
        f"{label}: finish events' ttft_s differ from the requests'")
    dur = sum(r["dur_s"] for r in steps)
    check(0.95 * run["wall_s"] <= dur <= run["wall_s"],
          f"{label}: records' durations {dur:.4f} s against the run's wall "
          f"{run['wall_s']:.4f} s")
    tr = chrome_trace(dump)
    check(json.loads(json.dumps(tr)) == tr and sum(
        e["ph"] == "X" for e in tr["traceEvents"]) == len(steps),
        f"{label}: the Chrome trace")
    med = {}
    for key, fn in (("config", lambda r: r["config"] or "idle"),
                    ("kind", step_kind)):
        groups = {}
        for r in steps:
            groups.setdefault(fn(r), []).append(r["dur_s"] * 1e3)
        med[key] = {k: {"median_ms": median(v), "steps": len(v)}
                    for k, v in sorted(groups.items())}
    med["records_share_of_wall"] = dur / run["wall_s"]
    return med


def obs_turns(torch, model):
    """The graphed mixed paged engine over the serve workload with obs on,
    off, on and off (the engine's ``obs`` swapped between runs): equal
    streams, steps and launches; the wall per decode step of each turn and
    the ratio of on to off (``obs.overhead_ratio``); each on-turn's dump
    checked (``check_dump``) and its report printed."""
    from statistics import mean
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.obs import build_report, format_report
    eng = ShiftEngine(model, EngineConfig())
    for r in serve.workload(6, 16):             # warm-up: every capture
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    chosen = count_configs(eng)
    runs = []
    for on in OBS_TURNS:
        obs = fresh_obs(eng, on)
        run = obs_run(torch, eng, chosen)
        if on:
            dump = obs.dump()
            run["medians"] = check_dump(run, dump, "obs on", True)
            run["report"] = format_report(build_report(dump))
        runs.append(run)
    first = runs[0]
    for run in runs[1:]:
        check([r.generated for r in run["reqs"]]
              == [r.generated for r in first["reqs"]]
              and run["steps"] == first["steps"]
              and run["launches"] == first["launches"],
              "obs on/off: the turns' streams, steps or launches differ")
    on = [r["wall_ms_per_decode_step"] for r, o in zip(runs, OBS_TURNS) if o]
    off = [r["wall_ms_per_decode_step"] for r, o in zip(runs, OBS_TURNS)
           if not o]
    ratio = mean(on) / mean(off)
    print("obs phase, mixed paged [graphed]: obs on, off, on, off: equal "
          f"streams, {first['steps']} steps and launches each; wall ms per "
          "decode step " + ", ".join(
              f"{r['wall_ms_per_decode_step']:.3f}" for r in runs)
          + f"; on / off (obs.overhead_ratio) {ratio:.4f}; run walls s "
          + ", ".join(f"{r['wall_s']:.4f}" for r in runs))
    print("obs phase, mixed paged: the dump holds together (steps by "
          "config, token sums, 6 TTFT and E2E, ttft_s per finish, records "
          f"{first['medians']['records_share_of_wall']:.4f} of the wall, "
          "one trace event per record); report of the first on-turn:")
    print(first["report"])
    print("obs phase, mixed paged: median dur_s ms by config "
          + json.dumps(first["medians"]["config"]) + "; by kind "
          + json.dumps(first["medians"]["kind"]))
    return eng, {"wall_ms_per_decode_step": [
        r["wall_ms_per_decode_step"] for r in runs],
        "wall_s": [r["wall_s"] for r in runs], "overhead_ratio": ratio,
        "medians": first["medians"], "steps": first["steps"]}, \
        first["launches"]


def serialized_obs_turns(torch, model):
    """The graphed serialized paged engine with obs on, in turns with the
    prefill step's device wait and without it (``_wait_for_device``
    replaced by a no-op): equal streams; each turn's dump checked; the
    median ``dur_s`` of prefill and decode records and the run's wall."""
    from statistics import mean
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.obs import build_report, format_report
    eng = ShiftEngine(model, EngineConfig(mixed=False))
    for r in serve.workload(6, 16):
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    chosen = count_configs(eng)
    runs = []
    for wait in (True, False, True, False):
        if wait:
            eng.__dict__.pop("_wait_for_device", None)
        else:
            eng._wait_for_device = lambda: None
        obs = fresh_obs(eng)
        run = obs_run(torch, eng, chosen)
        dump = obs.dump()
        run["medians"] = check_dump(run, dump, "serialized paged", False)
        run["wait"] = wait
        if not runs:
            run["report"] = format_report(build_report(dump))
        runs.append(run)
    eng.__dict__.pop("_wait_for_device", None)
    check(all([r.generated for r in run["reqs"]]
              == [r.generated for r in runs[0]["reqs"]]
              and run["launches"] == runs[0]["launches"] for run in runs),
          "serialized paged obs turns: streams or launches differ")
    kinds = [r["medians"]["kind"] for r in runs]
    with_wait = mean(r["wall_s"] for r in runs if r["wait"])
    without = mean(r["wall_s"] for r in runs if not r["wait"])
    print("obs phase, serialized paged [graphed]: the dump holds together "
          "in every turn; report of the first turn:")
    print(runs[0]["report"])
    print("obs phase, serialized paged: prefill step waits for the device "
          "on, off, on, off: median prefill dur_s ms "
          + ", ".join(f"{k['prefill']['median_ms']:.3f}" for k in kinds)
          + "; median decode dur_s ms "
          + ", ".join(f"{k['decode']['median_ms']:.3f}" for k in kinds)
          + "; run walls s " + ", ".join(f"{r['wall_s']:.4f}" for r in runs)
          + f"; wall with / without the wait {with_wait / without:.4f}")
    return {"prefill_median_ms": [k["prefill"]["median_ms"] for k in kinds],
            "decode_median_ms": [k["decode"]["median_ms"] for k in kinds],
            "wall_s": [r["wall_s"] for r in runs],
            "wait": [r["wait"] for r in runs],
            "wall_ratio_wait": with_wait / without}, runs[0]["launches"]


LIFECYCLE_BLOCKS = 7        # 6 usable blocks of 16: two prompts and a third


def lifecycle_drill(torch, model, policy):
    """Drive ``step()`` by hand on a graphed mixed paged engine with
    ``FaultConfig(max_queue=2, shed_policy=policy)`` on a pool cut to
    ``LIFECYCLE_BLOCKS``: two requests, one step, four more (they wait for
    blocks; the bound sheds two by the policy); after step 3 a running
    request's deadline is set in the past and another running request is
    cancelled; two more steps, then ``drain()`` and one request after it.
    Every request must end with one reason, the reason counters must
    match, no block may be held, and the late request is shed at once."""
    from repro_torch.engine import (EngineConfig, FaultConfig, Request,
                                    ShiftEngine)
    eng = ShiftEngine(model, EngineConfig(
        num_blocks=LIFECYCLE_BLOCKS,
        fault=FaultConfig(max_queue=2, shed_policy=policy)))
    t = time.monotonic()
    reqs = [Request(i, list(range(1, 20 + 3 * i)), max_new_tokens=16,
                    arrival=t) for i in range(6)]
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()
    for r in reqs[2:]:
        eng.submit(r)
    eng.step()
    eng.step()
    running = [r for r in reqs if r.slot is not None]
    check(len(running) >= 2, f"lifecycle {policy}: {len(running)} running "
          "after step 3")
    running[0].deadline = eng.now() - 1.0
    check(eng.cancel(running[1].rid), f"lifecycle {policy}: cancel refused")
    eng.step()
    eng.step()
    eng.drain()
    eng.submit(Request(99, [1, 2, 3], max_new_tokens=2))
    late = eng.request(99)
    reqs.append(late)
    torch.cuda.synchronize()
    reasons = [str(r.finish_reason) for r in reqs]
    reg = eng.obs.registry
    counted = {reason: int(reg.counter_total(name)) for reason, name in (
        ("timeout", "requests_timeout_total"),
        ("cancelled", "requests_cancelled_total"),
        ("shed", "requests_shed_total"), ("ok", "requests_finished_total"))}
    check(all(r.finish_reason is not None for r in reqs)
          and counted == {k: reasons.count(k) for k in counted}
          and sum(counted.values()) == len(reqs),
          f"lifecycle {policy}: reasons {reasons}, counters {counted}")
    check({"timeout", "cancelled", "shed", "ok"} <= set(reasons)
          and late.finish_reason == "shed",
          f"lifecycle {policy}: reasons {reasons}")
    check(all(len(r.generated) == 16 for r in reqs if r.finish_reason == "ok"),
          f"lifecycle {policy}: an OK request is short")
    led = eng.block_accounting()
    check(led.used == led.pinned == 0, f"lifecycle {policy}: blocks held "
          f"after drain {led}")
    print(f"obs phase, lifecycle {policy}: reasons {reasons} (tokens "
          f"{[len(r.generated) for r in reqs]}), counters {counted}, "
          f"{eng.preemptions} preemptions, {eng.step_count} steps, "
          f"{eng.deploy.captures} graphs; after drain used {led.used} "
          f"pinned {led.pinned}; a request after drain: "
          f"{late.finish_reason}")
    return {"reasons": reasons, "counters": counted,
            "preemptions": eng.preemptions, "steps": eng.step_count}


def obs_phase(torch, model):
    """Observability and the request lifecycle on the served model
    (full-width qwen3-8b, bf16): ``obs_turns``, ``serialized_obs_turns``
    and ``lifecycle_drill`` under both shed policies. Prints one
    ``{"obs": ...}`` line; returns the launches of the first measured run
    of each path."""
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    eng, mixed, mixed_launches = obs_turns(torch, model)
    del eng
    gc.collect()
    ser, ser_launches = serialized_obs_turns(torch, model)
    gc.collect()
    drills = {policy: lifecycle_drill(torch, model, policy)
              for policy in ("reject-newest", "evict-longest-queued")}
    wall = time.monotonic() - t0
    print(json.dumps({"obs": {"mixed": mixed, "serialized_paged": ser,
                              "lifecycle": drills, "phase_wall_s": wall}}))
    print(f"obs phase: {wall:.1f} s in all; card: {card_line()}")
    return mixed_launches, ser_launches


# ---------------------------------------------------------------------------
# phase 5c: faults, snapshots and crash recovery on the served model
# ---------------------------------------------------------------------------
# the storm: random_plan(RECOVERY_SEED, RECOVERY_STEPS, p = 0.1 at the
# alloc, forward and route seams). Scheduling does not depend on the
# tokens, so the schedule is the reduced model's: 21 steps, with a nan
# forward fault at step 2, alloc faults at 11 and 16, a raise at 19 and a
# route fault at 20; one request reaches quarantine_after (3) failures
RECOVERY_SEED, RECOVERY_STEPS, RECOVERY_P = 13, 48, 0.1
SNAPSHOT_EVERY = 4
CRASH_STEP = 14              # the ring then holds the snapshots of 8 and 12


def storm(extra=()):
    from repro_torch.ft import FaultPlan, random_plan
    plan = random_plan(RECOVERY_SEED, RECOVERY_STEPS, p_alloc=RECOVERY_P,
                       p_forward=RECOVERY_P, p_route=RECOVERY_P)
    return FaultPlan(plan.faults + list(extra))


def storm_engine(torch, model, faults):
    from repro_torch.engine import EngineConfig, FaultConfig, ShiftEngine
    gc.collect()
    return ShiftEngine(model, EngineConfig(
        fault=FaultConfig(auto_snapshot_every=SNAPSHOT_EVERY)),
        faults=faults)


def submit_workload(eng):
    from repro_torch.launch import serve
    reqs = serve.workload(6, 16)
    for r in reqs:
        eng.submit(r)
    return reqs


def timed_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def engine_state(torch, eng):
    """What a refused restore must leave as it was."""
    return (eng.step_count, eng.lens.tolist(), [r.rid for r in eng.queue],
            eng.kv.state_dict()["allocators"], eng.model.pool.k[:, 1:].sum(
                dtype=torch.float64).item())


def recovery_phase(torch, model):
    """Faults, snapshots and crash recovery on the graphed mixed paged
    engine over the served model (qwen3-8b, full width, bf16), under the
    seeded storm ``storm()`` with auto-snapshots every
    ``SNAPSHOT_EVERY`` steps, on the serve workload:

    * a clean run and the uninterrupted run under the storm, each on a new
      engine; the latter with every launch counter set to 0 just before it
      and read just after (the 109 RMSNorm and 36 ragged launches of every
      step whose forward ran), three snapshots timed at step 4;
    * restore in place: that engine restores its step-4 snapshot and runs
      to idle again: no graph is captured, and the streams equal its
      uninterrupted ones bitwise;
    * the crash drill: a new engine under the storm, a ``DeliveryLog``
      polled after every step, dropped after ``CRASH_STEP`` steps; a new
      engine ``recover``s from the dropped one's ring and runs to idle:
      no ``ReplayDivergence``, streams equal to the uninterrupted run's
      bitwise, every request with a typed outcome, no block held;
    * a corrupted snapshot: the storm plus a ``snapshot`` fault at step
      12 corrupts the newest capture; ``recover`` falls back to step 8, a
      direct ``restore`` of the corrupt one raises ``SnapshotError`` and
      leaves the engine as it was, and the run ends with the
      uninterrupted streams.

    Prints the ms per snapshot and restore, the bytes per snapshot, the
    walls, the failed steps, retries, preemptions and steps by config, and
    how many faulted streams equal the clean ones (reported only: in bf16
    a stream depends on the batch's bucketed shapes, which the faults
    change). Returns the launches of the uninterrupted run."""
    from repro_torch.ft import DeliveryLog, Fault, SnapshotError
    from repro_torch.launch import serve
    t_phase = time.monotonic()
    out = {}

    eng = storm_engine(torch, model, None)
    t0 = time.monotonic()
    reqs = submit_workload(eng)
    eng.run_until_idle()
    torch.cuda.synchronize()
    out["clean_wall_s"] = time.monotonic() - t0
    clean = [r.generated for r in reqs]
    del eng

    # the uninterrupted run under the storm
    eng = storm_engine(torch, model, storm())
    serve.reset_launch_counts()
    t0 = time.monotonic()
    reqs = submit_workload(eng)
    snap_ms, snap = [], None
    while eng.queue or eng.active:
        eng.step()
        if eng.step_count == SNAPSHOT_EVERY and snap is None:
            for _ in range(3):
                snap, ms = timed_ms(torch, eng.snapshot)
                snap_ms.append(ms)
    torch.cuda.synchronize()
    out["faulted_wall_s"] = time.monotonic() - t0
    launches = serve.launch_counts()
    whole = [r.generated for r in reqs]
    reg = eng.obs.registry
    counters = {name: int(reg.counter_total(name)) for name in (
        "faults_injected_total", "failed_steps_total", "retries_total",
        "requests_failed_total", "snapshots_total")}
    recs = eng.step_log
    ran = sum(1 for rec in recs if rec["config"] is not None
              and rec["attn_ctx_tokens"] > 0)
    check(launches == {k: {"rmsnorm": 109, "paged_ragged_attention": 36
                           }.get(k, 0) * ran for k in launches},
          f"faults phase: launches {launches} over {ran} forward steps")
    check(all(r.finish_reason is not None for r in reqs),
          "faults phase: a request has no outcome")
    check(counters["failed_steps_total"] == 2
          and counters["requests_failed_total"] == 1,
          f"faults phase: counters {counters}, want the reduced schedule's "
          "2 failed steps and 1 quarantined request")
    out.update(counters=counters, steps=eng.step_count,
               configs=dict(eng.config_counts), preemptions=eng.preemptions,
               outcomes=[str(r.finish_reason) for r in reqs],
               snapshot_ms=snap_ms,
               snapshot_bytes=sum(t.numel() * t.element_size()
                                  for t in snap["cache"].values()),
               equal_to_clean=sum(a == b for a, b in zip(whole, clean)))

    # restore in place: the graphs replay, nothing is captured
    captures = eng.deploy.captures
    pool = (model.pool.k.data_ptr(), model.pool.v.data_ptr())
    _, out["restore_ms"] = timed_ms(torch, lambda: eng.restore(snap))
    eng.run_until_idle()
    check([eng.stream(r.rid) for r in reqs] == whole,
          "faults phase: the run after an in-place restore differs from "
          "the uninterrupted run")
    check(eng.deploy.captures == captures
          and (model.pool.k.data_ptr(), model.pool.v.data_ptr()) == pool,
          f"faults phase: the in-place restore captured "
          f"{eng.deploy.captures - captures} graphs or moved the pool")
    out["graphs"] = captures
    del eng, snap

    # the crash drill
    eng = storm_engine(torch, model, storm())
    log = DeliveryLog()
    reqs = submit_workload(eng)
    for _ in range(CRASH_STEP):
        eng.step()
        log.poll(reqs)
    ring = eng.retained_snapshots()
    pre = sum(len(log.delivered(r.rid)) for r in reqs)
    del eng
    t0 = time.monotonic()
    eng = storm_engine(torch, model, storm())
    _, out["recover_ms"] = timed_ms(torch, lambda: eng.recover(ring))
    live = list(eng.queue)
    while eng.queue or eng.active:
        eng.step()
        log.poll(live)                 # raises ReplayDivergence
    torch.cuda.synchronize()
    out["recovered_wall_s"] = time.monotonic() - t0
    check([eng.stream(r.rid) for r in reqs] == whole
          and [log.delivered(r.rid) for r in reqs] == whole,
          "faults phase: the recovered streams differ from the "
          "uninterrupted run's")
    check(all(eng.request(r.rid).finish_reason is not None for r in reqs),
          "faults phase: a recovered request has no outcome")
    led = eng.block_accounting()
    check(led.used == led.pinned == 0, f"faults phase: blocks held {led}")
    out.update(ring=[s["step_count"] for s in ring],
               delivered_before_crash=pre,
               recovered_from=ring[-1]["step_count"],
               recovered_graphs=eng.deploy.captures)
    del eng, ring

    # a corrupted newest snapshot
    eng = storm_engine(torch, model, storm([Fault(12, "snapshot")]))
    reqs = submit_workload(eng)
    for _ in range(CRASH_STEP):
        eng.step()
    ring = eng.retained_snapshots()
    check(ring[-1].get("corrupted") and not ring[0].get("corrupted"),
          "faults phase: the step-12 snapshot was not corrupted")
    del eng
    eng = storm_engine(torch, model, storm())
    eng.recover(ring)
    check(eng.step_count == 8, f"faults phase: recovered to step "
          f"{eng.step_count}, want the older snapshot's 8")
    before = engine_state(torch, eng)
    try:
        eng.restore(ring[-1])
        refused = False
    except SnapshotError as e:
        refused = str(e)
    check(refused and engine_state(torch, eng) == before,
          "faults phase: a corrupt snapshot restored or changed the engine")
    eng.run_until_idle()
    check([eng.stream(r.rid) for r in reqs] == whole,
          "faults phase: the run recovered past the corrupt snapshot "
          "differs from the uninterrupted one")
    out["corrupt_refused"] = refused
    del eng, ring
    out["phase_wall_s"] = time.monotonic() - t_phase

    card = card_line()
    print(f"faults phase: seed {RECOVERY_SEED}, p {RECOVERY_P} at the alloc, "
          f"forward and route seams, snapshots every {SNAPSHOT_EVERY} steps; "
          f"{out['steps']} steps, configs {out['configs']}, counters "
          f"{counters}, {out['preemptions']} preemptions, outcomes "
          f"{out['outcomes']}; card: {card}")
    print(f"faults phase: snapshot of the pool {out['snapshot_bytes']} "
          f"bytes, ms per snapshot "
          + ", ".join(f"{ms:.2f}" for ms in snap_ms)
          + f"; restore in place {out['restore_ms']:.2f} ms (no graph "
          f"captured, streams equal); recover {out['recover_ms']:.2f} ms; "
          f"card: {card}")
    print(f"faults phase: crash after step {CRASH_STEP} ({pre} tokens "
          f"delivered), recovered from step {out['recovered_from']} of ring "
          f"{out['ring']}: streams equal the uninterrupted run's bitwise, "
          f"no replay divergence; walls s, each a new engine with "
          f"snapshots: clean {out['clean_wall_s']:.3f}, "
          f"under the storm {out['faulted_wall_s']:.3f}, recovered engine "
          f"(build, recover, run) {out['recovered_wall_s']:.3f}; "
          f"{out['equal_to_clean']} of 6 faulted streams equal the clean "
          f"ones (bf16, reported only); corrupt newest snapshot refused: "
          f"{refused}; card: {card}")
    print(json.dumps({"faults": out}))
    print(f"faults phase: {out['phase_wall_s']:.1f} s in all; card: {card}")
    return launches


def mamba2_serving_phase(torch):
    """mamba2-1.3b at full width (48 SSD layers, d_model 2048, bf16, random
    weights from a generator seeded 0) through the serve CLI's engine, which
    falls back to the serialized iteration on the dense cache; the same 6 x
    16 workload in turns, eager and graphed; then one small prefill +
    decode's logits, finite and of the expected shape, and the graphed
    entries' logits against the eager steps'."""
    import numpy as np
    from repro_torch.launch import serve
    # the qwen3-8b engines hold their model through reference cycles (the
    # step counters wrap bound methods): collect them so that the peak
    # below is mamba2's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    eng = serve.build_engine("mamba2-1.3b", device="cuda",
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cfg = eng.mcfg
    check(not eng.paged and not eng.mixed and "non-pageable"
          in eng.paged_disabled_reason, "mamba2: not the dense fallback")
    c = eng.model.cache
    state = sum(t.numel() * t.element_size()
                for t in (c.ssm, c.conv_x, c.conv_bc))
    print(f"mamba2-1.3b full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} SSD heads of "
          f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, "
          f"{cfg.num_params() / 1e9:.3f} B params "
          f"({cfg.num_params() * 2 / 1e9:.2f} GB bf16), built in "
          f"{time.monotonic() - t0:.1f} s; dense cache: "
          f"{eng.cfg.max_slots} slots, SSD state {state / 1e6:.1f} MB "
          f"({eng.paged_disabled_reason})")
    model = eng.model
    del eng, c
    _, launches, turns = serve_turns(torch, model, {},
                                     "mamba2 serialized dense")
    print(f"mamba2: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({before / 1e9:.2f} GB allocated before the model was built)")
    toks = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    model.init_cache(2, 32)
    logits, _ = model.prefill(toks, [0, 24])
    nxt, _ = model.decode(logits.argmax(-1), [8, 0], sample=False)
    torch.cuda.synchronize()
    for lg in (logits, nxt):
        check(tuple(lg.shape) == (2, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()),
              f"mamba2 full-width logits {tuple(lg.shape)} not finite")
    graph_logits_check(torch, model, False, [
        ("prefill", (toks, [0, 0], None)),
        ("prefill", (toks[:, ::-1].copy(), [8, 8], None)),
        ("decode", ([5, 7], [16, 16], None)),
        ("decode", ([9, 3], [17, 17], None))], "mamba2 prefill + decode")
    print(f"card: {card_line()}")
    return launches, turns


@contextlib.contextmanager
def profiled(torch):
    """``torch.profiler`` over the CPU and the card for the body of the
    ``with``, after a warm-up cycle that runs one small kernel and that the
    results leave out: a window's first launches can be missing from the
    trace while the profiler starts. The recording window itself opens
    with three such kernels and 20 ms of idle before the body runs (the
    warm-up cycle alone still let an eager window's first RMSNorm launch
    go missing); they are no port kernel, and the body's wall starts
    after them."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(3):
            torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.02)
        yield prof
        torch.cuda.synchronize()
        prof.step()


def device_kernels(prof):
    """(name, device µs, launches) of each kernel in ``prof``'s trace: the
    events on the card, less the span of the profiler's own step
    annotation (``ProfilerStep#n``)."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def profile_decode(torch, eng, steps=4, label=None):
    """Where a full-width decode step's time goes: ``torch.profiler`` over
    ``steps`` decode steps of 6 rows (after their one prefill step, mixed
    or serialized), kernel time by name and the device's busy share of the
    host's wall time. The workload runs once before, so that on graphed
    tables the profiled steps are replays of graphs captured then; checks
    that nothing is captured in the profiled run and that the trace holds
    each port kernel's launches of a decode step, ``steps`` times. The
    profiler adds host time of its own, so the busy share is a floor."""
    from repro_torch.launch import serve
    for r in serve.workload(6, steps + 1):
        eng.submit(r)
    eng.run_until_idle()
    captured = eng.deploy.captures
    for r in serve.workload(6, steps + 1):
        eng.submit(r)
    eng.step()                                  # the prefill step
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    eng.run_until_idle()
    it = label or ("mixed" if eng.mixed else "serialized paged" if eng.paged
                   else "serialized dense")
    check(eng.deploy.captures == captured,
          f"{it}: {eng.deploy.captures - captured} captures in the profile")
    # device-side events only: an operator's row repeats its kernels' time
    rows = device_kernels(prof)
    busy = sum(t for _, t, _ in rows)
    n = sum(c for _, _, c in rows)
    check(busy > 0, "the profiler saw no device time")
    traced = {name: 0 for name in serve.launch_counts()}
    for key, _, c in rows:
        kernel = port_kernel(key)
        if kernel:
            traced[kernel] += c
    want = {name: 0 for name in traced}
    for name, k in step_launches(eng, "mixed" if eng.mixed
                                 else "decode").items():
        want[name] = k * steps
    check(traced == want, f"{it}: the trace holds port kernel launches "
          f"{traced} over {steps} decode steps, want {want}")
    print(f"{it}: profile of {steps} decode steps: wall "
          f"{wall_us / steps / 1e3:.2f} "
          f"ms/step, device busy {busy / steps / 1e3:.2f} ms/step "
          f"({busy / wall_us:.1%}), {n / steps:.0f} kernels/step; port "
          "kernels in the trace per step: " + ", ".join(
              f"{k} {v // steps}" for k, v in traced.items() if v))
    for key, t, c in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {t / steps / 1e3:8.3f} ms/step {c // steps:5d}x  {key[:90]}")
    return {"profile_wall_ms_per_step": wall_us / steps / 1e3,
            "busy_ms_per_step": busy / steps / 1e3,
            "busy_share": busy / wall_us, "kernels_per_step": n / steps,
            "traced_port_launches_per_step": {k: v // steps for k, v
                                              in traced.items() if v}}


# ---------------------------------------------------------------------------
# phase 6: Shift Parallelism's layouts, four ranks on one card over gloo
# ---------------------------------------------------------------------------
LAYOUT_GRID = (2, 2)            # (sp, tp), the reference's mesh122
LAYOUT_CHECK_LAYERS = 2         # the fp32 check's depth (full width)
LAYOUT_TIMEOUT_S = 600


def layout_check_steps():
    """The fp32 check's two mixed steps over 4 rows and blocks of 16:
    prefill chunks (one row empty), then decode rows and a chunk. Returns
    ([(tokens [4, 16], q_lens, offsets)], block tables [4, 2])."""
    import numpy as np
    rng = np.random.default_rng(7)
    toks = [rng.integers(1, 151936, (4, 16)).astype(np.int32)
            for _ in range(2)]
    bt = np.arange(1, 9, dtype=np.int32).reshape(4, 2)
    return [(toks[0], [16, 9, 16, 0], [0, 0, 0, 0]),
            (toks[1], [1, 1, 4, 16], [16, 9, 16, 0])], bt


def layout_single_rank_logits(torch, cfg):
    """The single-rank port model's logits over ``layout_check_steps`` on
    the same weights (generator seeded 0), fp32, on the card."""
    from repro_torch.models import Model
    steps, bt = layout_check_steps()
    model = Model(cfg, device="cuda", dtype=torch.float32)
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    model.init_paged_cache(9, 16)
    out = [model.forward_mixed(t, ql, off, bt, sample=False)[0].cpu()
           for t, ql, off in steps]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def layout_rank(rank, groups, check_cfg):
    """One rank of the layout phase (spawned by ``run_ranks``): the fp32
    check's logits of both configs, then qwen3-8b at full width and depth
    in bf16 served on the base and shift models over one pool. Returns
    numpy results; only the parent prints."""
    import contextlib
    from collections import Counter
    import numpy as np
    import torch
    from repro_torch.core import invariance as INV
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lay = Layout(sp=LAYOUT_GRID[0], tp=LAYOUT_GRID[1])
    out = {"rank": rank, "device": torch.cuda.current_device()}

    # fp32, full width, cut depth: each config's logits on a fresh pool
    steps, bt = layout_check_steps()
    base, shift = (Model(check_cfg, device="cuda", dtype=torch.float32,
                         lay=layout, groups=groups)
                   for layout in (lay, lay.to_shift()))
    for m in (base, shift):
        m.init_params(torch.Generator(device="cuda").manual_seed(0))
    out["fp32"] = {}
    for name, m in (("base", base), ("shift", shift)):
        base.init_paged_cache(9, 16)
        shift.adopt_paged_cache(base)
        out["fp32"][name] = (m.shard.tp_rank, [
            m.forward_mixed(t, ql, off, bt, sample=False)[0].cpu().numpy()
            for t, ql, off in steps])
    del base, shift, m
    gc.collect()
    torch.cuda.empty_cache()

    # bf16, full width and depth: the engine on both configs
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = serve.build_engine("qwen3-8b", device="cuda", dtype=torch.bfloat16,
                             sp=lay.sp, tp=lay.tp, groups=groups)
    torch.cuda.synchronize()
    out["build_s"] = time.monotonic() - t0
    out["param_bytes"] = {
        name: sum(p.numel() * p.element_size()
                  for p in m.params.parameters())
        for name, m in (("base", eng.base), ("shift", eng.shift))}
    pool = eng.base.pool
    out["pool_bytes"] = 2 * pool.k.numel() * pool.k.element_size()
    walls, traffic = timed_forward(torch, eng, groups)
    for r in serve.workload(6, 16):            # warm-up
        eng.submit(r)
    eng.run_until_idle()
    for config in walls:
        walls[config].clear()
        traffic[config].clear()
    counts0 = dict(eng.config_counts)
    reqs = serve.workload(6, 16)
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    out["serve_s"] = time.monotonic() - t0
    out["launches"] = serve.launch_counts()
    out["streams"] = [r.generated for r in reqs]
    out["finish"] = [r.finish_reason for r in reqs]
    out["counts"] = delta(eng.config_counts, counts0)
    out["preemptions"] = eng.preemptions
    out["free"], out["blocks"] = eng.kv.num_free_blocks, eng.kv.num_blocks
    out["walls"] = {k: list(v) for k, v in walls.items()}
    out["traffic"] = {k: dict(v) for k, v in traffic.items()}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.print_summary(eng)
    out["summary"] = text.getvalue()

    # one prefill step (base) and three decode steps (shift) in rank 0's
    # profiler trace
    for r in serve.workload(6, 4):
        eng.submit(r)
    before = dict(eng.config_counts)
    with (profiled(torch) if rank == 0
          else contextlib.nullcontext()) as prof:
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
    out["profiled_configs"] = {k: eng.config_counts[k] - before[k]
                               for k in before}
    eng.run_until_idle()
    if rank == 0:
        traced = Counter()
        busy = 0.0
        for key, t, c in device_kernels(prof):
            busy += t
            kernel = port_kernel(key)
            if kernel:
                traced[kernel] += c
        out["traced"] = dict(traced)
        out["profiled_busy_ms"] = busy / 1e3

    # §3.3.1 on the card's pools: base prefills row 0 into blocks 1 and 2,
    # shift runs row 1, reading them and writing blocks 3 and 4
    toks = np.arange(1, 65, dtype=np.int32).reshape(2, 32)
    bt = np.zeros((2, 4), np.int32)
    bt[0, :2] = (1, 2)
    eng.base.forward_mixed(toks, [32, 0], [0, 0], bt)
    before = INV.snapshot_blocks(eng.base.pool, [1, 2])
    bt[1] = (1, 2, 3, 4)
    eng.shift.forward_mixed(toks[::-1].copy(), [0, 32], [32, 32], bt)
    torch.cuda.synchronize()
    out["invariance"] = INV.verify_paged_invariance(
        eng.base, eng.shift, rank, [1, 2], before)
    out["kv_slots"] = list(INV.kv_slots(eng.base, rank))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()

    # what one collective of the shift decode step costs here: its
    # all-reduce ([8, 1, 4096] bf16) over the four ranks, on a tensor on
    # the card (gloo stages it through the host) and on a host tensor
    group = eng.shift.shard.tp_group.pg
    out["all_reduce_ms"] = {}
    for where in ("cuda", "cpu"):
        x = torch.ones((8, 1, 4096), dtype=torch.bfloat16, device=where)
        for _ in range(3):
            torch.distributed.all_reduce(x, group=group)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            torch.distributed.all_reduce(x, group=group)
        torch.cuda.synchronize()
        out["all_reduce_ms"][where] = (time.perf_counter() - t) / 20 * 1e3

    # the prefix cache and speculation on the same models (a new engine, a
    # new pool): the serve workload after a 32-token shared prefix, k=4
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.spec import SpecConfig
    base, shift = eng.base, eng.shift
    del eng
    gc.collect()
    ps = ShiftEngine(base, EngineConfig(prefix=PrefixConfig(enabled=True),
                                        spec=SpecConfig(k=PS_K)), shift=shift)
    reqs = serve.workload(6, 16, shared_prefix=PS_SHARED)
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        ps.submit(r)
    ps.run_until_idle()
    torch.cuda.synchronize()
    out["prefix_spec"] = {
        "serve_s": time.monotonic() - t0, "launches": serve.launch_counts(),
        "streams": [r.generated for r in reqs],
        "finish": [r.finish_reason for r in reqs],
        "cached": [r.cached_tokens for r in reqs],
        "counts": dict(ps.config_counts), "stats": ps.prefix_stats.as_dict(),
        "spec": spec_counts(ps),
        "ledger": ps.block_accounting().as_dict()}
    return out


def layout_phase(torch):
    """Shift Parallelism's layouts on four ranks of (sp, tp) = (2, 2), one
    process each, all on the one card, with the collectives over gloo
    (NCCL refuses two ranks on one card): the fp32 full-width logits of
    both configs (2 layers) against the single-rank model's, then
    qwen3-8b at full width and depth in bf16 through the SPMD engine with
    the threshold policy. Returns rank 0's launch counts of the measured
    run."""
    import numpy as np
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    sp, tp = LAYOUT_GRID
    cfg = get_config("qwen3-8b")
    check_cfg = replace(cfg, num_layers=LAYOUT_CHECK_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    want = layout_single_rank_logits(torch, check_cfg)
    print(f"layout phase: sp={sp} x tp={tp} = {sp * tp} ranks, one process "
          f"each, all on {torch.cuda.device_count()} card(s): backend "
          "'gloo', because NCCL refuses two ranks of one communicator on "
          "one card; gloo stages the collectives of CUDA tensors through "
          "the host, so the times below are not NVLink times and not a "
          "speed of Shift Parallelism")
    full = cfg.num_params() * 2
    print(f"layout phase: memory reckoned: qwen3-8b bf16 {full / 1e9:.2f} "
          f"GB; per rank the base shard holds 1/{tp} ({full / tp / 1e9:.2f} "
          f"GB) and the shift shard 1/{sp * tp} ({full / (sp * tp) / 1e9:.2f}"
          f" GB): {full * (sp * tp) * (1 / tp + 1 / (sp * tp)) / 1e9:.1f} GB "
          "over the four processes, plus the pool and four CUDA contexts")
    t0 = time.monotonic()
    res = run_ranks(layout_rank, sp, tp, device="cuda", backend="gloo",
                    timeout_s=LAYOUT_TIMEOUT_S, args=(check_cfg,))
    print(f"layout phase: {sp * tp} ranks ran in "
          f"{time.monotonic() - t0:.1f} s")

    # fp32 logits of both configs, assembled by tp rank
    err = 0.0
    for config in ("base", "shift"):
        by_tp = {}
        for r in res:
            tpr, lg = r["fp32"][config]
            if tpr in by_tp:
                check(all(np.array_equal(a, b) for a, b in zip(by_tp[tpr], lg)),
                      f"layout {config}: replicas of tp rank {tpr} differ")
            by_tp[tpr] = lg
        for s, w in enumerate(want):
            got = torch.from_numpy(np.concatenate(
                [by_tp[t][s] for t in range(len(by_tp))], axis=-1))
            err = max(err, compare(torch, f"layout {config} fp32 logits "
                                   f"step {s}", got, w, 2e-3))
    print(f"layout phase: fp32 full-width ({LAYOUT_CHECK_LAYERS} layers) "
          f"logits of base and shift against the single-rank model: max "
          f"abs err {err} (tol 2e-3)")

    r0 = res[0]
    for r in res:
        check(r["streams"] == r0["streams"] and r["counts"] == r0["counts"],
              f"layout: rank {r['rank']}'s streams or configs differ from "
              "rank 0's")
        check(all(f == "ok" for f in r["finish"]) and
              all(len(s) == 16 for s in r["streams"]),
              f"layout: rank {r['rank']}: {r['finish']}")
        check(r["free"] == r["blocks"] - 1,
              f"layout: rank {r['rank']}: {r['free']} of {r['blocks']} "
              "blocks free at exit")
        check(r["invariance"], f"layout: rank {r['rank']}: the shared "
              "blocks changed or the pools differ")
    check(r0["counts"]["base"] > 0 and r0["counts"]["shift"] > 0,
          f"layout: configs used {r0['counts']}")
    steps = sum(r0["counts"].values())
    per_step = {"rmsnorm": 109, "paged_ragged_attention": 36}
    want_launches = {k: per_step.get(k, 0) * steps for k in r0["launches"]}
    for r in res:
        check(r["launches"] == want_launches,
              f"layout: rank {r['rank']}: launches {r['launches']} over "
              f"{steps} steps, want {want_launches}")
    check(r0["profiled_configs"] == {"base": 1, "shift": 3},
          f"layout: profiled steps {r0['profiled_configs']}")
    traced = {k: v for k, v in r0["traced"].items() if v}
    check(traced == {k: 4 * v for k, v in per_step.items()},
          f"layout: rank 0's trace holds {traced} over 4 steps")
    print("layout phase: " + r0["summary"].replace("\n", "; "))
    print(f"layout phase: served 6 requests x 16 tokens on every rank in "
          f"{r0['serve_s']:.2f} s, {steps} steps {r0['counts']}, "
          f"{r0['preemptions']} preemptions, {r0['free']} of {r0['blocks']} "
          f"blocks free at exit; all ranks' streams equal; per rank and step "
          f"{per_step['rmsnorm']} rmsnorm and {per_step['paged_ragged_attention']}"
          f" ragged launches (counters, and rank 0's profiler trace over 1 "
          f"base and 3 shift steps: {traced}; device busy "
          f"{r0['profiled_busy_ms'] / 4:.2f} ms per step)")
    stats = {}
    for config in ("base", "shift"):
        w = r0["walls"][config]
        n = len(w)
        tr = r0["traffic"][config]
        stats[config] = {
            "steps": n, "wall_ms_per_step": sum(w) / n * 1e3,
            "wall_ms": sorted(x * 1e3 for x in w),
            "all_to_all_bytes_per_step":
                tr.get("all_to_all_bytes", 0) / n,
            "all_reduce_bytes_per_step":
                tr.get("all_reduce_bytes", 0) / n,
            "all_gather_bytes_per_step":
                tr.get("all_gather_bytes", 0) / n,
            "collective_calls_per_step": {
                k[:-6]: v / n for k, v in tr.items() if k.endswith("_calls")}}
        print(f"layout phase: {config} steps on rank 0: {n}, wall "
              f"{stats[config]['wall_ms_per_step']:.2f} ms per step; per "
              f"step {stats[config]['all_to_all_bytes_per_step'] / 1e6:.3f} "
              f"MB all-to-all, "
              f"{stats[config]['all_reduce_bytes_per_step'] / 1e6:.3f} MB "
              f"all-reduce, "
              f"{stats[config]['all_gather_bytes_per_step'] / 1e3:.3f} kB "
              f"all-gather (payload handed over by the rank)")
    print("layout phase: one all-reduce of [8, 1, 4096] bf16 over the four "
          "ranks (a shift decode step makes 73), ms per call on ranks 0-3: "
          "card tensors " + ", ".join(f"{r['all_reduce_ms']['cuda']:.3f}"
                                      for r in res)
          + "; host tensors " + ", ".join(f"{r['all_reduce_ms']['cpu']:.3f}"
                                          for r in res))
    for r in res:
        print(f"layout phase: rank {r['rank']} (card {r['device']}): kv "
              f"slots {r['kv_slots']}, params base "
              f"{r['param_bytes']['base'] / 1e9:.2f} GB + shift "
              f"{r['param_bytes']['shift'] / 1e9:.2f} GB, pool "
              f"{r['pool_bytes'] / 1e6:.1f} MB, built in {r['build_s']:.1f} "
              f"s, peak device memory {r['peak_bytes'] / 1e9:.2f} GB")
    ps0 = r0["prefix_spec"]
    for r in res:
        ps = r["prefix_spec"]
        check(all(ps[k] == ps0[k] for k in
                  ("streams", "cached", "counts", "stats", "spec")),
              f"layout prefix + spec: rank {r['rank']} differs from rank 0")
        check(all(f == "ok" for f in ps["finish"])
              and all(len(t) == 16 for t in ps["streams"]),
              f"layout prefix + spec: rank {r['rank']}: {ps['finish']}")
        led = ps["ledger"]
        check(led["used"] == led["pinned"] == ps["stats"]["entries"],
              f"layout prefix + spec: rank {r['rank']}: blocks {led}")
        ps_steps = sum(ps["counts"].values())
        check(ps["launches"] == {k: per_step.get(k, 0) * ps_steps
                                 for k in ps["launches"]},
              f"layout prefix + spec: rank {r['rank']}: launches "
              f"{ps['launches']} over {ps_steps} steps")
    check(ps0["stats"]["hits"] > 0 and ps0["spec"][0] > 0,
          f"layout prefix + spec: prefix {ps0['stats']}, spec {ps0['spec']}")
    print(f"layout phase: prefix + spec (a {PS_SHARED}-token shared prefix, "
          f"k={PS_K}): equal on every rank; {sum(ps0['counts'].values())} "
          f"steps {ps0['counts']} in {ps0['serve_s']:.2f} s; cached tokens "
          f"{ps0['cached']}; prefix {ps0['stats']}; drafted {ps0['spec'][0]}"
          f", accepted {ps0['spec'][1]}, rollback blocks {ps0['spec'][2]}; "
          f"no block held at exit ({ps0['ledger']})")
    print(json.dumps({"layout": {
        "grid": {"sp": sp, "tp": tp}, "backend": "gloo",
        "fp32_max_abs_err": err, "configs": r0["counts"],
        "per_config": stats,
        "all_reduce_ms": [r["all_reduce_ms"] for r in res],
        "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res]}}))
    print(f"card: {card_line()}")
    overhead = max(r["peak_bytes"] - sum(r["param_bytes"].values())
                   for r in res)
    return r0["launches"], ps0["launches"], overhead


DP_TIMEOUT_S = 600
DP_GRID = (2, 2, 2)             # (dp, sp, tp), the reference's mesh222
DP_GRID_MIN_LAYERS = 8
DP_HEADROOM = 0.2               # of the card's free memory, kept free


def one_row_view(model):
    """``model`` (a rank of dp rows with a model group of one, which holds
    the whole model) as the trivial layout's model over the same parameter
    tensors: the layers' computation is the same, only the dp row slicing
    and the DP gather go. A new engine gives it its own pool."""
    import copy
    from repro_torch.parallel import Layout, Shard
    view = copy.copy(model)
    view.lay, view.shard = Layout(), Shard()
    view.pool = view.cache = None
    return view


def timed_forward(torch, eng, groups):
    """Wrap the engine's mixed entries so that each call's wall (after a
    device sync) and the collective traffic it made are kept by config."""
    from collections import Counter
    walls = {"base": [], "shift": []}
    traffic = {"base": Counter(), "shift": Counter()}

    def timed(entry, config):
        def call(*arrays):
            before = Counter(groups.traffic)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = entry(*arrays)
            torch.cuda.synchronize()
            walls[config].append(time.perf_counter() - t)
            traffic[config].update(Counter(groups.traffic) - before)
            return res
        return call

    for config in ("base", "shift"):
        eng.deploy.forward[config] = timed(eng.deploy.forward[config], config)
    return walls, traffic


def dp_measured_run(torch, eng, reqs):
    """Serve ``reqs`` on ``eng`` with every launch counter set to 0 just
    before and read just after. Returns the numbers of the run."""
    from repro_torch.launch import serve
    fresh_obs(eng)              # the dump and the counts cover this run
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    dec_tok = sum(len(r.generated) - 1 for r in reqs)
    kv = eng.kv
    return {"wall_s": wall, "launches": serve.launch_counts(),
            "streams": [r.generated for r in reqs],
            "rows": [r.row for r in reqs],
            "finish": [str(r.finish_reason) for r in reqs],
            "cached": [r.cached_tokens for r in reqs],
            "counts": dict(eng.config_counts),
            "ttft_ms": [(r.first_token_time - r.arrival) * 1e3 for r in reqs],
            "decode_tokens_per_s": dec_tok / (t_last - t_first),
            "stats": eng.prefix_stats.as_dict(),
            "spec": spec_counts(eng),
            "dump": eng.obs.dump(),
            "per_row": [{
                "requests": sum(1 for r in reqs if r.row == row),
                "hits": (eng.prefix_rows[row].stats()["hits"]
                         if eng.prefix_rows else 0),
                "tokens_saved": (eng.prefix_rows[row].stats()["tokens_saved"]
                                 if eng.prefix_rows else 0),
                "free_blocks": kv.row_free_blocks(row),
                "used": kv.allocators[row].num_used,
                "pinned": (len(eng.prefix_rows[row].blocks())
                           if eng.prefix_rows else 0),
                "entries": (len(eng.prefix_rows[row]) if eng.prefix_rows
                            else 0)} for row in range(kv.dp)]}


def fit(a, shape):
    """``a`` zero-padded or cut to ``shape``; None when the cut drops a
    nonzero entry."""
    import numpy as np
    out = np.zeros(shape, a.dtype)
    both = tuple(slice(0, min(n, m)) for n, m in zip(a.shape, shape))
    out[both] = a[both]
    if np.count_nonzero(a) != np.count_nonzero(out):
        return None
    return out


def renamed(a, b):
    """True when block tables ``a`` are ``b`` with the block ids renamed
    one to one (0, the null block, to itself): two pools that served other
    work before hold their free lists in other orders."""
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return (all((x == 0) == (y == 0) for x, y in pairs)
            and len(pairs) == len({x for x, _ in pairs})
            == len({y for _, y in pairs}))


def pin_to_dp_steps(eng, steps, row, dp):
    """Pin a dp=1 engine fed the requests routed to dp row ``row`` to that
    row's segment of a recorded dp run (``recorded_forward``'s steps), so
    that it steps the dp batch's shapes: its k-th mixed step is fitted to
    the k-th recorded step that gave the row work (that step's segment
    width, chunk bucket and table width; only zero padding may be added or
    cut) and runs at that step's config and verify width, and the engine
    reads its own columns of the result. Raises when the fitted inputs
    differ from the segment's (block tables up to a renaming of block ids,
    ``renamed``), i.e. when the dp=1 engine scheduled, placed or mapped
    otherwise than the dp row did. Returns the list of the
    steps it ran and the number of the row's segments, to be compared once
    the engine is idle."""
    import numpy as np
    segs = []
    for config, n_last, arrays, _ in steps:
        seg = arrays[0].shape[0] // dp
        part = [a[row * seg:(row + 1) * seg] for a in arrays]
        if part[1].any():                  # q_lens: the row had work
            segs.append((config, n_last, part))
    ran = []
    forward_at = eng.deploy.forward_at

    def pinned(config, n_last=1):
        def call(*arrays):
            k = len(ran)
            if k >= len(segs):
                raise RuntimeError(f"row {row}'s dp=1 engine takes step {k}; "
                                   f"the dp row took {len(segs)}")
            rec_config, rec_n, want = segs[k]
            got = [fit(a, w.shape) for a, w in zip(arrays, want)]
            if (n_last > rec_n or any(g is None for g in got)
                    or not all(np.array_equal(g, w)
                               for g, w in zip(got[:3], want[:3]))
                    or not renamed(got[3], want[3])):
                raise RuntimeError(
                    f"row {row}'s dp=1 engine, step {k}: inputs "
                    f"{[a.tolist() for a in arrays]} (verify width {n_last}) "
                    f"do not fit the dp row's segment "
                    f"{[w.tolist() for w in want]} (width {rec_n})")
            ran.append(k)
            res = forward_at(rec_config, rec_n)(*got)
            if rec_n > 1:
                res = res[:, rec_n - n_last:]
                if n_last == 1:
                    res = res[:, 0]
            return res
        return call

    eng.deploy.forward_at = pinned
    return ran, len(segs)


def one_row_streams(torch, model, reqs, row, kw, steps):
    """The streams of a dp=1 engine (half the slots, eager tables) over
    ``model``'s weights, fed the requests of ``reqs`` routed to ``row`` and
    pinned to the dp run's ``steps`` (``pin_to_dp_steps``): {rid:
    tokens}."""
    from repro_torch.engine import EngineConfig, Request, ShiftEngine
    from repro_torch.engine.deployment import Deployment
    view = one_row_view(model)
    eng = ShiftEngine(view, EngineConfig(max_slots=4, **kw))
    eng.deploy = Deployment.build(view, view, mixed=True, paged=True,
                                  graphed=False)
    ran, n = pin_to_dp_steps(eng, steps, row, model.lay.dp)
    sub = [Request(r.rid, list(r.prompt), max_new_tokens=r.max_new_tokens)
           for r in reqs if r.row == row]
    for r in sub:
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    if len(ran) != n:
        raise RuntimeError(f"row {row}'s dp=1 engine took {len(ran)} steps; "
                           f"the dp row took {n}")
    return {r.rid: r.generated for r in sub}


def dp_rank(rank, groups):
    """One rank of the (dp, sp, tp) = (2, 1, 1) run (spawned by
    ``run_ranks``): qwen3-8b at full width and depth in bf16, the whole
    model and its row's pool, serving the serve workload and then the
    prefix + spec workload; each beside a dp=1 engine over the same
    weights fed this rank's row's requests at the dp batch's shapes
    (``pin_to_dp_steps``). Returns numpy results; only
    the parent prints."""
    import torch
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.launch import serve
    from repro_torch.spec import SpecConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "device": torch.cuda.current_device()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = serve.build_engine("qwen3-8b", device="cuda", dtype=torch.bfloat16,
                             dp=2, groups=groups)
    torch.cuda.synchronize()
    row = eng.model.shard.dp_rank
    out["row"], out["build_s"] = row, time.monotonic() - t0
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in eng.model.params.parameters())
    pool = eng.model.pool
    out["pool_bytes"] = 2 * pool.k.numel() * pool.k.element_size()
    out["pool_blocks"] = pool.k.shape[1]
    walls, traffic = timed_forward(torch, eng, groups)
    for r in serve.workload(6, 16):            # warm-up
        eng.submit(r)
    eng.run_until_idle()
    for config in walls:
        walls[config].clear()
        traffic[config].clear()
    steps = recorded_forward(eng)
    reqs = serve.workload(6, 16)
    out["plain"] = dp_measured_run(torch, eng, reqs)
    out["plain"]["walls"] = {k: list(v) for k, v in walls.items()}
    out["plain"]["traffic"] = {k: dict(v) for k, v in traffic.items()}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.print_summary(eng)
    out["summary"] = text.getvalue()
    model = eng.model
    del eng
    gc.collect()
    out["plain"]["one_row"] = one_row_streams(torch, model, reqs, row, {},
                                              steps)

    # the prefix cache and k=4 drafts on the same model, a new engine
    ps_kw = {"prefix": PrefixConfig(enabled=True), "spec": SpecConfig(k=PS_K)}
    ps = ShiftEngine(model, EngineConfig(**ps_kw))
    steps = recorded_forward(ps)
    reqs = serve.workload(6, 16, shared_prefix=PS_SHARED)
    out["prefix_spec"] = dp_measured_run(torch, ps, reqs)
    out["prefix_spec"]["traffic"] = dict(groups.traffic)
    del ps
    gc.collect()
    out["prefix_spec"]["one_row"] = one_row_streams(torch, model, reqs, row,
                                                    ps_kw, steps)
    out["snapshot"] = dp_snapshot_run(torch, model)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def dp_snapshot_run(torch, model):
    """One dp rank's snapshot drill: the serve workload on a new engine,
    a snapshot of this rank's shard after step 4, the run to idle; then a
    new engine on this rank restores the snapshot and runs to idle."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    gc.collect()
    eng = ShiftEngine(model, EngineConfig())
    reqs = serve.workload(6, 16)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    snap, snap_ms = timed_ms(torch, eng.snapshot)
    eng.run_until_idle()
    whole = [r.generated for r in reqs]
    del eng
    gc.collect()
    eng = ShiftEngine(model, EngineConfig())
    _, restore_ms = timed_ms(torch, lambda: eng.restore(snap))
    eng.run_until_idle()
    return {"whole": whole, "restored": [eng.stream(r.rid) for r in reqs],
            "rank": snap["rank"], "step": snap["step_count"],
            "bytes": sum(t.numel() * t.element_size()
                         for t in snap["cache"].values()),
            "snapshot_ms": snap_ms, "restore_ms": restore_ms}


def grid_cfg(layers):
    from dataclasses import replace
    from repro_torch.configs import get_config
    return replace(get_config("qwen3-8b"), num_layers=layers)


def grid_models(torch, lay, groups, layers):
    """This rank's base model on ``lay`` and shift model on its
    ``to_shift()``, bf16, drawn from the generator seeded 0."""
    from repro_torch.models import Model
    out = []
    for layout in (lay, lay.to_shift()):
        m = Model(grid_cfg(layers), device="cuda", dtype=torch.bfloat16,
                  lay=layout, groups=groups)
        m.init_params(torch.Generator(device="cuda").manual_seed(0))
        out.append(m)
    return out


def recorded_forward(eng):
    """Wrap the engine's ``forward_at`` so that each mixed step's config,
    verify width, host inputs and the (gathered) tokens it returned are
    kept, in order."""
    steps = []
    forward_at = eng.deploy.forward_at

    def recorded(config, n_last=1):
        entry = forward_at(config, n_last)

        def call(*arrays):
            res = entry(*arrays)
            steps.append((config, n_last, [a.copy() for a in arrays],
                          res.cpu().numpy()))
            return res
        return call

    eng.deploy.forward_at = recorded
    return steps


def dp_grid_rank(rank, groups, layers):
    """One rank of the (2, 2, 2) run: the cut-depth qwen3-8b at full width
    in bf16, base on the grid and shift on its ``to_shift()`` over this
    rank's row's pool, serving the serve workload; the measured run's
    steps (config, inputs, gathered tokens) are kept for the replay."""
    import torch
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    dp, sp, tp = DP_GRID
    base, shift = grid_models(torch, Layout(dp=dp, sp=sp, tp=tp), groups,
                              layers)
    eng = ShiftEngine(base, EngineConfig(), shift=shift)
    walls, traffic = timed_forward(torch, eng, groups)
    for r in serve.workload(6, 16):            # warm-up
        eng.submit(r)
    eng.run_until_idle()
    for config in walls:
        walls[config].clear()
        traffic[config].clear()
    steps = recorded_forward(eng)
    out = dp_measured_run(torch, eng, serve.workload(6, 16))
    out.update(rank=rank, row=base.shard.dp_rank, steps=steps,
               walls={k: list(v) for k, v in walls.items()},
               traffic={k: dict(v) for k, v in traffic.items()},
               param_bytes=sum(p.numel() * p.element_size()
                               for m in (base, shift)
                               for p in m.params.parameters()),
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def grid_split_rank(rank, groups, layers, steps, split):
    """One rank of (1, 2, 2) on the same weights. First the replay: each
    dp row's segment of every recorded (2, 2, 2) step, in order, through
    the (1, 2, 2) model of the step's config on a fresh pool of one row's
    65 blocks; returns per row whether every step's tokens equal the
    segment's gathered tokens bitwise. Then the (1, 2, 2) engine (half the
    slots, a new engine each) fed each row's routed requests, pinned to
    that row's segments (``pin_to_dp_steps``); returns its streams by
    rid."""
    import numpy as np
    import torch
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.parallel import Layout
    dp, sp, tp = DP_GRID
    base, shift = grid_models(torch, Layout(sp=sp, tp=tp), groups, layers)
    replay = []
    for d in range(dp):
        base.init_paged_cache(65, 16)
        shift.adopt_paged_cache(base)
        equal = []
        for config, n_last, (toks, qlen, offs, bt), want in steps:
            seg = toks.shape[0] // dp
            rows = slice(d * seg, (d + 1) * seg)
            m = base if config == "base" else shift
            got, _ = m.forward_mixed(toks[rows], qlen[rows], offs[rows],
                                     bt[rows], n_last=n_last)
            equal.append(bool(np.array_equal(got.cpu().numpy(), want[rows])))
        replay.append(equal)
    streams = {}
    for d, rids in enumerate(split):
        eng = ShiftEngine(base, EngineConfig(max_slots=4), shift=shift)
        ran, n = pin_to_dp_steps(eng, steps, d, dp)
        reqs = [r for r in serve.workload(6, 16) if r.rid in rids]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        if len(ran) != n:
            raise RuntimeError(f"row {d}'s (1, 2, 2) engine took {len(ran)} "
                               f"steps; the dp row took {n}")
        streams.update({r.rid: r.generated for r in reqs})
        del eng
        gc.collect()
    torch.cuda.synchronize()
    return {"replay": replay, "streams": streams}


def per_config(walls, traffic):
    out = {}
    for config, w in walls.items():
        n = len(w)
        if not n:
            continue
        out[config] = {"steps": n, "wall_ms_per_step": sum(w) / n * 1e3,
                       "bytes_per_step": {
                           k[:-6]: v / n for k, v in traffic[config].items()
                           if k.endswith("_bytes")},
                       "calls_per_step": {
                           k[:-6]: v / n for k, v in traffic[config].items()
                           if k.endswith("_calls")}}
    return out


def dp_phase(torch, overhead_bytes):
    """Data parallelism on the one card, every rank its own process and the
    collectives over gloo: (dp, sp, tp) = (2, 1, 1) at full width and
    depth, then (2, 2, 2) at full width with the depth cut to fit.
    ``overhead_bytes`` is a rank's measured peak beyond its parameters in
    the layout phase (its pool, activations and staging). Returns rank 0's
    launch counts of each measured run."""
    import numpy as np
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.obs import build_report, chrome_trace, format_report
    per_step = {"rmsnorm": 109, "paged_ragged_attention": 36}
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"dp phase: the parent still holds {held / 1e9:.2f} "
          "GB on the card")
    free, total = torch.cuda.mem_get_info()
    # what this process holds outside the allocator: its CUDA context
    ctx = total - free - torch.cuda.memory_reserved()
    full = grid_cfg(36).num_params() * 2
    print(f"dp phase: card {total / 1e9:.2f} GB, {free / 1e9:.2f} GB free "
          f"with the parent's context ({ctx / 1e9:.2f} GB) and "
          f"{held / 1e6:.1f} MB allocated by the parent; gloo stages the "
          "collectives through the host, so the walls below are not a speed "
          "of data parallelism")
    print(f"dp phase (2, 1, 1): memory reckoned: 2 ranks x (qwen3-8b bf16 "
          f"{full / 1e9:.2f} GB + a row pool of 65 blocks x 16 tokens x 36 "
          f"layers, {2 * 65 * 16 * 36 * 8 * 128 * 2 / 1e6:.1f} MB, + its "
          f"dp=1 twin's pool, + ~{(overhead_bytes + ctx) / 1e9:.2f} GB "
          f"overhead) = "
          f"{2 * (full + 2 * 2 * 65 * 16 * 36 * 8 * 128 * 2 + overhead_bytes + ctx) / 1e9:.1f}"
          " GB")
    t0 = time.monotonic()
    res = run_ranks(dp_rank, 1, 1, dp=2, device="cuda", backend="gloo",
                    timeout_s=DP_TIMEOUT_S)
    print(f"dp phase (2, 1, 1): 2 ranks ran in {time.monotonic() - t0:.1f} s")
    r0 = res[0]
    for key, label in (("plain", "serve workload"),
                       ("prefix_spec", f"prefix + spec (a {PS_SHARED}-token "
                                       f"shared prefix, k={PS_K})")):
        a = r0[key]
        for r in res:
            b = r[key]
            check(all(b[k] == a[k] for k in ("streams", "rows", "counts",
                                             "stats", "spec", "cached")),
                  f"dp (2, 1, 1) {label}: rank {r['rank']} differs from rank "
                  "0")
            check(all(f == "ok" for f in b["finish"])
                  and all(len(t) == 16 for t in b["streams"]),
                  f"dp (2, 1, 1) {label}: rank {r['rank']}: {b['finish']}")
            for rid, toks in b["one_row"].items():
                check(toks == a["streams"][rid],
                      f"dp (2, 1, 1) {label}: request {rid} of row "
                      f"{r['row']}: {a['streams'][rid]} against the dp=1 "
                      f"engine's {toks}")
            check(sorted(b["one_row"]) == [i for i, row in
                                           enumerate(a["rows"])
                                           if row == r["row"]],
                  f"dp (2, 1, 1) {label}: rank {r['rank']}'s dp=1 engine "
                  "served other requests")
            steps = sum(b["counts"].values())
            check(b["launches"] == {k: per_step.get(k, 0) * steps
                                    for k in b["launches"]},
                  f"dp (2, 1, 1) {label}: rank {r['rank']}: launches "
                  f"{b['launches']} over {steps} steps")
        check(set(a["rows"]) == {0, 1}, f"dp (2, 1, 1) {label}: rows "
              f"{a['rows']}")
        for r in res:
            check(timeless(r[key]["dump"]) == timeless(a["dump"]),
                  f"dp (2, 1, 1) {label}: rank {r['rank']}'s obs dump "
                  "differs from rank 0's (time fields dropped)")
        lanes = {e["args"]["name"] for e in chrome_trace(a["dump"])[
            "traceEvents"] if e["name"] == "thread_name"}
        check({"requests:row0", "requests:row1"} <= lanes,
              f"dp (2, 1, 1) {label}: trace lanes {lanes}")
        for row, pr in enumerate(a["per_row"]):
            check(pr["used"] == pr["pinned"] == pr["entries"],
                  f"dp (2, 1, 1) {label}: row {row} holds blocks: {pr}")
        steps = sum(a["counts"].values())
        print(f"dp phase (2, 1, 1) {label}: equal on both ranks and equal to "
              f"each rank's dp=1 engine fed its row's requests at the dp "
              f"batch's shapes (every step's inputs equal the row's "
              f"segment); rows "
              f"{a['rows']}; {steps} steps {a['counts']} in "
              f"{a['wall_s']:.2f} s; TTFT ms "
              + ", ".join(f"{t:.1f}" for t in a["ttft_ms"])
              + f"; decode {a['decode_tokens_per_s']:.1f} tokens/s; "
              f"launches per step and rank {per_step} (counters)")
        for row, pr in enumerate(a["per_row"]):
            print(f"dp phase (2, 1, 1) {label}: row {row}: "
                  f"{pr['requests']} requests, {pr['hits']} hits, "
                  f"{pr['tokens_saved']} tokens saved, "
                  f"{pr['free_blocks']} free blocks at exit")
    for r in res:
        sn = r["snapshot"]
        check(sn["restored"] == sn["whole"] == r0["snapshot"]["whole"]
              and sn["rank"] == r["rank"] and sn["step"] == 4,
              f"dp (2, 1, 1) snapshot: rank {r['rank']}: the run restored "
              "from step 4 differs from the uninterrupted one")
        print(f"dp phase (2, 1, 1) snapshot: rank {r['rank']} (row "
              f"{r['row']}) snapshot of its shard after step 4, "
              f"{sn['bytes']} bytes in {sn['snapshot_ms']:.2f} ms, restored "
              f"into a new engine in {sn['restore_ms']:.2f} ms: the rest of "
              f"the run equals the uninterrupted one bitwise; card: "
              f"{card_line()}")
    ps = r0["prefix_spec"]
    check(ps["stats"]["hits"] > 0 and ps["spec"][0] > 0,
          f"dp (2, 1, 1) prefix + spec: prefix {ps['stats']}, spec "
          f"{ps['spec']}")
    plain = r0["plain"]
    stats = per_config(plain["walls"], plain["traffic"])
    for config, st in stats.items():
        print(f"dp phase (2, 1, 1): {config} steps on rank 0: {st['steps']}, "
              f"wall {st['wall_ms_per_step']:.2f} ms per step; per step "
              f"{st['bytes_per_step'].get('dp_all_gather', 0):.0f} bytes in "
              f"{st['calls_per_step'].get('dp_all_gather', 0):.0f} "
              "dp_all_gather call(s) (payload handed over by the rank)")
    print("dp phase (2, 1, 1): " + r0["summary"].replace("\n", "; "))
    print("dp phase (2, 1, 1): both ranks' obs dumps equal once the time "
          "fields are dropped, a trace lane per dp row; rank 0's report "
          "of the serve workload:")
    print(format_report(build_report(plain["dump"])))
    for r in res:
        print(f"dp phase (2, 1, 1): rank {r['rank']} (card {r['device']}, row "
              f"{r['row']}): params {r['param_bytes'] / 1e9:.2f} GB, pool "
              f"{r['pool_blocks']} blocks {r['pool_bytes'] / 1e6:.1f} MB, "
              f"built in {r['build_s']:.1f} s, peak device memory "
              f"{r['peak_bytes'] / 1e9:.2f} GB")
    dp211 = {"per_config": stats, "ttft_ms": plain["ttft_ms"],
             "decode_tokens_per_s": plain["decode_tokens_per_s"],
             "wall_s": plain["wall_s"], "rows": plain["rows"],
             "per_row": plain["per_row"],
             "prefix_spec": {k: ps[k] for k in (
                 "wall_s", "counts", "stats", "spec", "per_row", "ttft_ms",
                 "decode_tokens_per_s")},
             "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res]}
    del res
    gc.collect()

    # (2, 2, 2): the depth that fits eight ranks with the headroom
    dp, sp, tp = DP_GRID
    c1, c2 = grid_cfg(1).num_params(), grid_cfg(2).num_params()
    per_layer, fixed = (c2 - c1) * 2, (c1 - (c2 - c1)) * 2
    share = 1 / tp + 1 / (sp * tp)             # base shard + shift shard
    free, _ = torch.cuda.mem_get_info()
    room = (1 - DP_HEADROOM) * free
    n = dp * sp * tp

    def need(layers):
        return n * (share * (fixed + layers * per_layer) + overhead_bytes
                    + ctx)

    layers = max((L for L in range(1, 37) if need(L) <= room), default=0)
    print(f"dp phase (2, 2, 2): memory reckoned: per rank the base shard "
          f"(1/{tp}) and the shift shard (1/{sp * tp}) of "
          f"{fixed / 1e9:.2f} GB (embedding and head) + L x "
          f"{per_layer / 1e9:.3f} GB, + {overhead_bytes / 1e9:.2f} GB "
          f"overhead (measured in the layout phase) + {ctx / 1e9:.2f} GB "
          f"context; {n} ranks need {need(36) / 1e9:.1f} GB at the full 36 "
          f"layers against {room / 1e9:.1f} GB ({1 - DP_HEADROOM:.0%} of "
          f"{free / 1e9:.1f} GB free): depth cut to {layers} layers "
          f"({need(layers) / 1e9:.1f} GB); width kept (d_model 4096, 32 q "
          "and 8 kv heads, vocabulary 151936)")
    check(layers >= DP_GRID_MIN_LAYERS, f"dp (2, 2, 2): {layers} layers fit, "
          f"fewer than {DP_GRID_MIN_LAYERS}")
    t0 = time.monotonic()
    grid = run_ranks(dp_grid_rank, sp, tp, dp=dp, device="cuda",
                     backend="gloo", timeout_s=DP_TIMEOUT_S, args=(layers,))
    t_grid = time.monotonic() - t0
    g0 = grid[0]
    split = [[i for i, row in enumerate(g0["rows"]) if row == d]
             for d in range(dp)]
    t0 = time.monotonic()
    ref = run_ranks(grid_split_rank, sp, tp, device="cuda", backend="gloo",
                    timeout_s=DP_TIMEOUT_S, args=(layers, g0["steps"], split))
    t_ref = time.monotonic() - t0
    per_step_grid = {"rmsnorm": 3 * layers + 1,
                     "paged_ragged_attention": layers}
    for g in grid:
        check(all(g[k] == g0[k] for k in ("streams", "rows", "counts")),
              f"dp (2, 2, 2): rank {g['rank']} differs from rank 0")
        check(len(g["steps"]) == len(g0["steps"]) and all(
            a[:2] == b[:2] and all(np.array_equal(x, y)
                                   for x, y in zip(a[2], b[2]))
            and np.array_equal(a[3], b[3])
            for a, b in zip(g["steps"], g0["steps"])),
            f"dp (2, 2, 2): rank {g['rank']}'s steps differ from rank 0's")
        check(all(f == "ok" for f in g["finish"])
              and all(len(t) == 16 for t in g["streams"]),
              f"dp (2, 2, 2): rank {g['rank']}: {g['finish']}")
        steps = sum(g["counts"].values())
        check(g["launches"] == {k: per_step_grid.get(k, 0) * steps
                                for k in g["launches"]},
              f"dp (2, 2, 2): rank {g['rank']}: launches {g['launches']} "
              f"over {steps} steps")
        check(all(pr["used"] == 0 for pr in g["per_row"]),
              f"dp (2, 2, 2): rank {g['rank']}: blocks held {g['per_row']}")
    for r in ref:
        for d, equal in enumerate(r["replay"]):
            check(len(equal) == len(g0["steps"]) and all(equal),
                  f"dp (2, 2, 2): row {d}'s segments replayed on (1, 2, 2) "
                  f"give other tokens at steps "
                  f"{[i for i, e in enumerate(equal) if not e]}")
        check(r["streams"] == ref[0]["streams"],
              "dp (2, 2, 2): the (1, 2, 2) ranks' streams differ")
    check(sorted(ref[0]["streams"]) == list(range(len(g0["streams"]))),
          f"dp (2, 2, 2): the (1, 2, 2) engines served "
          f"{sorted(ref[0]['streams'])}")
    for rid, toks in ref[0]["streams"].items():
        check(toks == g0["streams"][rid],
              f"dp (2, 2, 2): request {rid} of row {g0['rows'][rid]}: "
              f"{g0['streams'][rid]} against the (1, 2, 2) engine's {toks}")
    check(set(g0["rows"]) == {0, 1} and g0["counts"]["base"] >= 1
          and g0["counts"]["shift"] > 0,
          f"dp (2, 2, 2): rows {g0['rows']}, configs {g0['counts']}")
    gstats = per_config(g0["walls"], g0["traffic"])
    print(f"dp phase (2, 2, 2): {n} ranks ({layers} layers) ran in "
          f"{t_grid:.1f} s, the (1, 2, 2) replay and engines in "
          f"{t_ref:.1f} s; every rank's streams and steps equal; each row's "
          f"segment of all {len(g0['steps'])} steps, replayed through the "
          "(1, 2, 2) models on one row's pool, gives the same tokens "
          f"bitwise; rows {g0['rows']}; {sum(g0['counts'].values())} steps "
          f"{g0['counts']}; launches per step and rank {per_step_grid} "
          "(counters)")
    print("dp phase (2, 2, 2): the streams equal the (1, 2, 2) engine's fed "
          "each row's routed requests at the dp batch's shapes and configs "
          "(every step's inputs equal the row's segment)")
    for config, st in gstats.items():
        print(f"dp phase (2, 2, 2): {config} steps on rank 0: "
              f"{st['steps']}, wall {st['wall_ms_per_step']:.2f} ms per "
              "step; bytes per step by kind "
              + json.dumps({k: round(v) for k, v in
                            st["bytes_per_step"].items()}))
    print(f"dp phase (2, 2, 2): per rank params "
          f"{g0['param_bytes'] / 1e9:.2f} GB, peak device memory "
          + ", ".join(f"{g['peak_bytes'] / 1e9:.2f}" for g in grid) + " GB")
    wall = time.monotonic() - t_phase
    print(json.dumps({"dp": {
        "backend": "gloo", "dp211": dp211,
        "dp222": {"layers": layers, "per_config": gstats,
                  "ttft_ms": g0["ttft_ms"],
                  "decode_tokens_per_s": g0["decode_tokens_per_s"],
                  "wall_s": g0["wall_s"], "rows": g0["rows"],
                  "counts": g0["counts"],
                  "peak_gb_per_rank": [g["peak_bytes"] / 1e9 for g in grid]},
        "phase_wall_s": wall}}))
    print(f"dp phase: {wall:.1f} s in all")
    print(f"card: {card_line()}")
    return (r0["plain"]["launches"], r0["prefix_spec"]["launches"],
            g0["launches"])


def summary(cases, by_path):
    """One entry per kernel; its top-level numbers are its first case (bf16
    at a serving path's shapes), every case is listed under ``cases``.
    ``launches`` sums the main paths' runs, each counted from 0."""
    out = []
    for name, route, source, replaces in (
            ("paged_ragged_attention", "cuda",
             CSRC + "paged_ragged_attention.cu", ATTN_TPU),
            ("rmsnorm", "cuda", CSRC + "rmsnorm.cu", RMS_TPU),
            ("flash_attention", "cuda", CSRC + "flash_attention.cu",
             FLASH_TPU),
            ("decode_attention", "cuda", CSRC + "decode_attention.cu",
             DECODE_TPU),
            ("paged_decode_attention", "cuda", CSRC + "decode_attention.cu",
             PAGED_DECODE_TPU),
            ("ssd_chunk", "cuda", CSRC + "ssd_chunk.cu", SSD_TPU)):
        top = cases[name][0]
        out.append({"name": name, "route": route, "source": source,
                    "replaces": replaces,
                    "launches": sum(p[name] for p in by_path.values()),
                    "launches_by_path": {k: p[name]
                                         for k, p in by_path.items()},
                    "max_abs_err": top["max_abs_err"], "ms": top["ms"],
                    "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
                    "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                    "library_ms": top["library_ms"], "case": top["case"],
                    "dtype": top["dtype"], "shape": top["shape"],
                    "cases": cases[name]})
    return {"kernels": out}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.monotonic()
    logs = build.build_all()
    print(f"built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        ptxas_report(name, log)

    cases = kernel_phase(torch)
    cross_device_phase(torch)
    by_path, turns = serving_phase(torch)
    by_path["mamba2_dense"], turns["mamba2_dense"] = \
        mamba2_serving_phase(torch)
    by_path["layout_sp2_tp2_rank0"], by_path["layout_prefix_spec_rank0"], \
        overhead = layout_phase(torch)
    by_path["dp2_rank0"], by_path["dp2_prefix_spec_rank0"], \
        by_path["dp2_sp2_tp2_rank0"] = dp_phase(torch, overhead)
    print(json.dumps({"graph_turns": turns}))
    print(json.dumps(summary(cases, by_path)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
