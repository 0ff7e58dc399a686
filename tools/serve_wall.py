#!/usr/bin/env python3
"""Host time of the port's serving loop, compared across checkouts on one
card: ``python3 tools/serve_wall.py ROOT [ROOT ...]``.

Each ROOT is the root of a checkout of this repository; each is run in a
process of its own, in the order given (give them in turns, e.g. A B B A,
so that a drift of the host over the call shows). A process builds
qwen3-8b at full width through that checkout's
``repro_torch.launch.serve.build_engine`` (random weights, bf16, the mixed
paged engine as that checkout's engine runs it) and serves the serve CLI's
workload (6 requests x 16 new tokens) three times; the first run is a
warm-up. For the two measured runs it prints one JSON line: wall ms per
decode step (as ``chip_smoke.py`` measures it), and the host's µs per
RMSNorm wrapper call and per step inside those calls (the wrappers are
timed on the host clock, without a sync). Needs a card.
"""
import subprocess
import sys
import time
from pathlib import Path

WORKER = r'''
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root + "/src")
import torch
from repro_torch.kernels import rmsnorm as RMS
from repro_torch.launch import serve

host = {"calls": 0, "s": 0.0}


def timed(fn):
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        host["s"] += time.perf_counter() - t0
        host["calls"] += 1
        return out
    return wrapper


for name in ("rmsnorm_cuda", "rmsnorm_pair_cuda"):
    if hasattr(RMS, name):
        setattr(RMS, name, timed(getattr(RMS, name)))
eng = serve.build_engine("qwen3-8b", device="cuda", dtype=torch.bfloat16)
for run in range(3):
    host.update(calls=0, s=0.0)
    steps0 = sum(eng.config_counts.values())
    reqs = serve.workload(6, 16)
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    steps = sum(eng.config_counts.values()) - steps0
    if run:
        print(json.dumps({
            "root": root, "run": run,
            "wall_ms_per_decode_step": (t_last - t_first) / 15 * 1e3,
            "ttft_ms": (t_first - t0) * 1e3, "steps": steps,
            "rmsnorm_calls_per_step": host["calls"] / steps,
            "rmsnorm_host_us_per_call": host["s"] / max(host["calls"], 1) * 1e6,
            "rmsnorm_host_ms_per_step": host["s"] / steps * 1e3}), flush=True)
'''


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    for root in roots:
        t0 = time.monotonic()
        subprocess.run([sys.executable, "-c", WORKER,
                        str(Path(root).resolve())], check=True, timeout=900)
        print(f"{root}: {time.monotonic() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
