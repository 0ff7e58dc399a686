#!/usr/bin/env python3
"""Where reduced mamba2-1.3b's fp32 training gradients part from the
truth, on the CPU and on the card, kernel by kernel:
``PYTHONPATH=src python3 tools/ssd_fp32_drift.py`` (the card runs only
where there is one).

The weights are ``chip_smoke.py``'s ``train_state`` (reduced mamba2-1.3b,
seed 0) and the batch its ``train_batch`` (B 8, S 16). The truth is the
same loss's gradients in fp64: ``tools/moe_fp64_check.py``'s copy of
``src/`` under ``build/fp64/`` (every fp32 cast made fp64) run on the CPU
in a child process. Then, in fp32 (TF32 off), the CPU's gradients and the
card's: with every kernel, and with one kernel at a time swapped for its
plain version (the SSD chunk's forward, its backward, the RMSNorm forward
and its backward) and with all of them swapped. Prints one JSON line: for
each run, the worst leaf's error against the truth as a share of that
leaf's largest entry, the five worst leaves, and the worst error norm as a
share of its leaf's norm. A card run as far from
the truth as the CPU run is fp32 rounding; one far beyond it, a fault.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-1.3b"


def grads(device, dtype, state, batch):
    """(loss, {name: gradient as float64 numpy}) of one ``loss_fn`` call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    m = Model(get_config(ARCH).reduced(), device=device, dtype=dtype)
    m.load_params({k: torch.from_numpy(v).to(dtype) for k, v in
                   state.items()})
    with m.trainable() as named:
        loss = m.loss_fn()(*batch)
        loss.backward()
        out = {k: p.grad.double().cpu().numpy() for k, p in named.items()}
    return float(loss.detach()), out


def fp64_child(path):
    """Runs in the fp64 copy: the truth's loss and gradients to ``path``."""
    import torch
    torch.set_default_dtype(torch.float64)
    data = np.load(path + ".in.npz")
    state = {k[2:]: data[k] for k in data.files if k.startswith("p|")}
    batch = (data["toks"], data["labels"])
    loss, g = grads("cpu", torch.float64, state, batch)
    np.savez(path, loss=loss, **{f"g|{k}": v for k, v in g.items()})


def worst(got, want):
    """The worst leaf's max abs error as a share of its largest entry, the
    five worst leaves so, and the worst error norm as a share of the
    leaf's norm."""
    errs = {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-300))
            for k, w in want.items()}
    norm = max(float(np.linalg.norm(got[k] - w)
                     / max(np.linalg.norm(w), 1e-300))
               for k, w in want.items())
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    return {"worst": top[0][1], "leaves": dict(top), "worst_norm": norm}


def main():
    if "--fp64-child" in sys.argv:
        fp64_child(sys.argv[-1])
        return 0
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as CS
    import moe_fp64_check as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as RMS
    from repro_torch.kernels import rmsnorm_bwd as RMSB
    from repro_torch.kernels import ssd_chunk_bwd as SSDB
    from repro_torch.kernels import ssd_scan as SSD
    state = CS.train_state(torch, ARCH)
    batch = CS.train_batch(get_config(ARCH).reduced().vocab_size)
    dest = ROOT / "build" / "fp64"
    F.make_copy(dest)
    path = str(ROOT / "build" / "ssd_drift_fp64")
    np.savez(path + ".in.npz", toks=batch[0], labels=batch[1],
             **{f"p|{k}": v for k, v in state.items()})
    env = dict(os.environ, PYTHONPATH=str(dest / "src"))
    subprocess.run([sys.executable, str(Path(__file__).resolve()),
                    "--fp64-child", path], env=env, cwd=str(dest),
                   check=True)
    truth = np.load(path + ".npz")
    want = {k[2:]: truth[k] for k in truth.files if k.startswith("g|")}
    out = {"truth_loss": float(truth["loss"])}
    loss, g = grads("cpu", torch.float32, state, batch)
    out["cpu_fp32"] = {"loss": loss, **worst(g, want)}
    if torch.cuda.is_available():
        swaps = {"ssd_chunk": (SSD, "ssd_chunk_cuda", "ssd_chunk_plain"),
                 "ssd_chunk_bwd": (SSDB, "ssd_chunk_bwd_cuda",
                                   "ssd_chunk_bwd_plain"),
                 "rmsnorm": (RMS, "rmsnorm_cuda", "rmsnorm_plain"),
                 "rmsnorm_bwd": (RMSB, "rmsnorm_bwd_cuda",
                                 "rmsnorm_bwd_plain")}
        for label, names in [("kernels", ())] + [
                (f"{k} plain", (k,)) for k in swaps] + [
                ("all plain", tuple(swaps))]:
            saved = {k: getattr(swaps[k][0], swaps[k][1]) for k in names}
            try:
                for k in names:
                    mod, cuda, plain = swaps[k]
                    setattr(mod, cuda, getattr(mod, plain))
                loss, g = grads("cuda", torch.float32, state, batch)
            finally:
                for k, fn in saved.items():
                    setattr(swaps[k][0], swaps[k][1], fn)
            out[f"card_fp32 {label}"] = {"loss": loss, **worst(g, want)}
    out["card"] = CS.card_line() if torch.cuda.is_available() else None
    print(json.dumps({"ssd_fp32_drift": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
