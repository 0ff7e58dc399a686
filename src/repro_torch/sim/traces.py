"""Synthetic request traces mirroring the paper's workloads (§4.1.4, §4.2;
the port's copy of ``repro.sim.traces``).

The real Azure-Code / Mooncake traces are not available offline; these
generators reproduce their *described statistics*: Azure-Code = bursty
agentic code completion (long prompts, short outputs, silent/burst phases);
Mooncake = steady conversation traffic (~9 requests every 3 s, medium in,
long out). All deterministic given the seed."""
from __future__ import annotations

import numpy as np


def uniform_trace(n=64, rate=2.0, n_in=4096, n_out=250, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    return [(float(tt), n_in, n_out) for tt in t]


def bursty_trace(n_steady=60, n_burst=4, burst_size=64, span=240.0, seed=0):
    """Steady low-rate interactive stream + periodic high-traffic bursts
    (paper Fig. 7)."""
    rng = np.random.default_rng(seed)
    out = []
    t = np.sort(rng.uniform(0, span, n_steady))
    for tt in t:                      # interactive: short in, medium out
        out.append((float(tt), int(rng.integers(256, 2048)),
                    int(rng.integers(64, 256))))
    for b in range(n_burst):          # batch bursts: big prompt batches
        t0 = span * (b + 0.5) / n_burst
        for _ in range(burst_size):
            out.append((float(t0 + rng.uniform(0, 1.0)),
                        int(rng.integers(2048, 8192)),
                        int(rng.integers(128, 512))))
    return sorted(out)


def azure_code_trace(n=400, span=900.0, seed=1):
    """Agentic code-completion: three prominent bursts, long prompts,
    short outputs (paper Fig. 8a/9)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n // 4):           # background
        out.append((float(rng.uniform(0, span)),
                    int(rng.integers(1024, 8192)), int(rng.integers(16, 128))))
    for b, frac in enumerate((0.15, 0.45, 0.75)):
        for _ in range(n // 4):
            out.append((float(span * frac + rng.exponential(8.0)),
                        int(rng.integers(2048, 16384)),
                        int(rng.integers(16, 128))))
    return sorted(out)


def mooncake_conv_trace(span=900.0, batch=9, every=3.0, seed=2):
    """Steady conversation arrivals: ~9 requests every 3 s, medium input,
    long output (paper Fig. 8b/10)."""
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    while t < span:
        for _ in range(int(rng.poisson(batch))):
            out.append((t + float(rng.uniform(0, every)),
                        int(rng.integers(512, 4096)),
                        int(rng.integers(256, 1024))))
        t += every
    return sorted(out)
