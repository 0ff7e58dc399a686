#!/usr/bin/env python3
"""Where reduced recurrentgemma-9b's fp32 results on the card part from
the CPU's: ``PYTHONPATH=src python3 tools/rg_fp32_drift.py``. Needs a card.

Draws the reduced model's weights on the card from seed 0 (as
``chip_smoke.py``'s ``rg_reduced_check``), copies them to a CPU model and
runs the equivalence inputs' prefill (B 8, S 16, window 8) on both, fp32,
TF32 off. Prints one JSON line each:

- ``layers``: each layer's state after the prefill, card against CPU,
  beside its largest |value| (an RG-LRU layer's ``conv`` tail, which
  holds its last x-branch inputs before any recurrence, and ``h``; the
  local layer's ring K/V);
- ``recur``: for each RG-LRU layer, the recurrence's terms of the card's
  own input to it, recomputed on the CPU from that same input: the gate
  ``r``, the decay ``a = exp(-8 softplus(Λ) r)``, the input scale
  ``s = sqrt(max(1 - a², 1e-6))`` and ``b = s · i · x`` (``_recur``), each
  as the largest relative difference in units of fp32's epsilon, with
  the largest ``a² / (1 - a²)`` of the input: the factor by which ``1 -
  a²`` magnifies a relative difference of ``a``.
"""
import json

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import recurrent as R

EPS = torch.finfo(torch.float32).eps


def rel_eps(got, want):
    """Largest |got - want| / |want| in units of fp32's epsilon."""
    g, w = got.cpu().double(), want.cpu().double()
    return ((g - w).abs() / w.abs().clamp_min(1e-30)).max().item() / EPS


def terms(p, xb):
    """``_recur``'s terms of xb: r, a, s and b."""
    r, _ = R._gates(p, xb)
    a = torch.exp(-R.RGLRU_C * F.softplus(p.lam) * r)
    s = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-6))
    _, b = R._recur(p, xb)
    return {"r": r, "a": a, "s": s, "b": b}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = get_config("recurrentgemma-9b").reduced()
    gpu = Model(small, device="cuda", dtype=torch.float32)
    gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(small, device="cpu", dtype=torch.float32)
    cpu.load_params({k: v.cpu() for k, v in gpu.params.state_dict().items()})
    seen = []                                   # (p, xb) of the card's calls
    recur = R._recur

    def record(p, xb):
        if xb.is_cuda:
            seen.append((p, xb.clone()))
        return recur(p, xb)

    R._recur = record
    toks = (np.arange(8 * 16, dtype=np.int32).reshape(8, 16) * 7) % 256
    for m in (gpu, cpu):
        m.init_cache(8, 32)
        m.prefill(toks, np.zeros(8, np.int32))
    R._recur = recur
    layers = []
    for i, kind in enumerate(small.layer_kinds):
        g, c = gpu.cache.layer(i), cpu.cache.layer(i)
        pairs = ({"conv": (g.conv, c.conv), "h": (g.h, c.h)} if kind == "rglru"
                 else {"ring_k": (g[0], c[0]), "ring_v": (g[1], c[1])})
        layers.append({"layer": i, "kind": kind, **{
            n: {"err": (a.cpu() - b).abs().max().item(),
                "max": b.abs().max().item()} for n, (a, b) in pairs.items()}})
    print(json.dumps({"layers": layers}))
    rows = []
    rg = [i for i, k in enumerate(small.layer_kinds) if k == "rglru"]
    for i, (p, xb) in zip(rg, seen):
        on_card = terms(p, xb)
        on_cpu = terms(cpu.params.layers[i].mix, xb.cpu())
        a = on_cpu["a"].double()
        rows.append({"layer": i, **{n: rel_eps(on_card[n], on_cpu[n])
                                    for n in on_card},
                     "max_a": a.max().item(),
                     "max_a2_over_1_minus_a2": (a * a / (1 - a * a)).max()
                     .item()})
    print(json.dumps({"recur": rows}))


if __name__ == "__main__":
    main()
