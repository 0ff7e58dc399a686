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
   own case; decode over contexts up to 2048 and over one sequence of 2048,
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
   and on the CPU (plain versions) give equal streams, config counts and
   preemptions, and one mixed step's and one dense prefill + decode's
   logits agree within 1e-4;
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
   captured and capture ms (also as one ``{"graph_turns": ...}`` line);
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
   invariance on the card's pools; it prints wall ms and collective bytes
   per step by config, one all-reduce's ms on card and host tensors, and
   peak memory per rank. Phase 3 also holds the ragged kernel and the q/k
   pair at a rank's shapes (8 q and 2 kv heads).

With no arguments it needs one card. The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
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


def attention_case(torch, name, rows, dtype, timer, tol, Hq=32, Hkv=8):
    """rows: [(ctx, q_len)] of one batch; Hq 32, Hkv 8 (a rank's 8 and 2
    on the layout phase's grid), D 128, bs 16."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_ragged_attention as PRA
    D, bs = 128, 16
    g = Hq // Hkv
    B = len(rows)
    C = max(ql for _, ql in rows)
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
                         eng.kv.num_free_blocks if eng.paged else None))
        check(runs[0] == runs[1], f"reduced engine {kw or 'no pressure'}: "
              f"cuda {runs[0]} != cpu {runs[1]}")
        print(f"reduced engine {kw or 'no pressure'}: cuda == cpu, "
              f"configs {runs[0][1]}, {runs[0][2]} preemptions")

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
    mamba2_cross_device(torch)


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
    eng.config_counts = {"base": 0, "shift": 0}
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
    steps = sum(eng.config_counts.values())
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
          f"{steps} steps {kinds}; configs {eng.config_counts}; "
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
    print(f"card: {card_line()}")
    return by_path, turns


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


def profile_decode(torch, eng, steps=4, label=None):
    """Where a full-width decode step's time goes: ``torch.profiler`` over
    ``steps`` decode steps of 6 rows (after their one prefill step, mixed
    or serialized), kernel time by name and the device's busy share of the
    host's wall time. The workload runs once before, so that on graphed
    tables the profiled steps are replays of graphs captured then; checks
    that nothing is captured in the profiled run and that the trace holds
    each port kernel's launches of a decode step, ``steps`` times. The
    profiler adds host time of its own, so the busy share is a floor."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    for r in serve.workload(6, steps + 1):
        eng.submit(r)
    eng.run_until_idle()
    captured = eng.deploy.captures
    for r in serve.workload(6, steps + 1):
        eng.submit(r)
    eng.step()                                  # the prefill step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    for r in serve.workload(6, 16):            # warm-up
        eng.submit(r)
    eng.run_until_idle()
    for config in walls:
        walls[config].clear()
        traffic[config].clear()
    eng.config_counts = {"base": 0, "shift": 0}
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
    out["counts"] = dict(eng.config_counts)
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
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if rank == 0 else contextlib.nullcontext())
    before = dict(eng.config_counts)
    with prof:
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
    out["profiled_configs"] = {k: eng.config_counts[k] - before[k]
                               for k in before}
    eng.run_until_idle()
    if rank == 0:
        traced = Counter()
        busy = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total:
                busy += e.self_device_time_total
                kernel = port_kernel(e.key)
                if kernel:
                    traced[kernel] += e.count
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
    print(json.dumps({"layout": {
        "grid": {"sp": sp, "tp": tp}, "backend": "gloo",
        "fp32_max_abs_err": err, "configs": r0["counts"],
        "per_config": stats,
        "all_reduce_ms": [r["all_reduce_ms"] for r in res],
        "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res]}}))
    print(f"card: {card_line()}")
    return r0["launches"]


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
    by_path["layout_sp2_tp2_rank0"] = layout_phase(torch)
    print(json.dumps({"graph_turns": turns}))
    print(json.dumps(summary(cases, by_path)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
