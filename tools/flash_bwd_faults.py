#!/usr/bin/env python3
"""Does ``chip_smoke.py``'s check of the bf16 flash backward fail a wrong
kernel? ``python3 tools/flash_bwd_faults.py``. Needs a card (each copy's
kernels are built with nvcc).

For the unchanged source and for each planted fault below, copies
``src/repro_torch`` into a temporary directory, rewrites one loop bound of
the copy's ``csrc/flash_attention_bwd.cu``, and in a child process with
that copy first on its path runs the bf16 backward at ``chip_smoke.py``'s
training microbatch (B 2, S 2048, Hq 32, Hkv 8, D 128, causal) against the
plain backward. The repository's own files are never changed. Prints one
JSON line per source: for dQ, dK and dV, the max abs error over 2e-2
times the largest entry (the max-abs rule alone, ``rel_compare``) and the
largest row error over 2e-2 (``row_rel_err``, which ``grad_compare`` adds);
a ratio above 1 fails. The unchanged source must pass both; a fault that
passes the row rule means the check is too weak.

Faults (the wgmma kernels, which the bf16 training path runs at D 128;
each shortens a loop bound that the producer warp and the consumer
warpgroups share, so the copy still runs to its end):

- ``dkdv_skip_last_query_tile``: the dK/dV CTA's walk over query tiles
  stops one tile early for every head of the group, so the last 64 queries
  add nothing to any key;
- ``dq_skip_last_key_tile``: the dQ CTA's walk over key tiles stops one
  tile early (under the causal mask, the tile of the diagonal).
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "kernels/csrc/flash_attention_bwd.cu"
# name -> (the kernel the loop is in, the loop's text, the faulty text)
FAULTS = {
    "none": None,
    "dkdv_skip_last_query_tile": (
        "dkdv_wgmma_kernel(",
        "const int ntq = (dm.Sq - i_first + QT - 1) / QT;",
        "const int ntq = (dm.Sq - i_first + QT - 1) / QT - 1;"),
    "dq_skip_last_key_tile": (
        "dq_wgmma_kernel(",
        "ntiles = last < 0 ? 0 : min(ntiles, last / KT + 1);",
        "ntiles = last < 0 ? 0 : min(ntiles, last / KT + 1) - 1;"),
}
TOL = 2e-2


def plant(dst: Path, fault):
    """Copy the package to ``dst/src`` and plant ``fault`` in the copy."""
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault is None:
        return
    path = dst / "src" / "repro_torch" / SOURCE
    text = path.read_text()
    anchor, old, new = fault
    start = text.index(anchor)
    at = text.index(old, start)
    path.write_text(text[:at] + new + text[at + len(old):])


def child():
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FAB
    assert not Path(FAB.__file__).is_relative_to(ROOT), FAB.__file__
    B, S, Hq, Hkv, D = (cs.FLASH_BWD_SHAPE[k]
                        for k in ("B", "S", "Hq", "Hkv", "D"))
    gen = torch.Generator(device="cuda").manual_seed(S + D)   # chip_smoke's
    q, do = (torch.randn((B, S, Hq, D), generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    off = torch.zeros((B,), dtype=torch.int32, device="cuda")
    out, lse = FA.flash_attention_cuda(q, k, v, off, causal=True,
                                       return_lse=True)
    args = (q, k, v, out, lse, do, off)
    got = FAB.flash_attention_bwd_cuda(*args)
    want = FAB.flash_attention_bwd_plain(*args)
    res = {}
    for n, a, w in zip("qkv", got, want):
        err = (a.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        row = cs.row_rel_err(torch, a, w)
        res[f"d{n}"] = {"max_abs_err": err, "largest": top,
                        "max_abs_rule": err / (TOL * top),
                        "row_rule": row / TOL}
    print(json.dumps(res))


def main():
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fault in FAULTS.items():
            dst = Path(tmp) / name
            plant(dst, fault)
            env = dict(os.environ, PYTHONPATH=str(dst / "src"))
            procs[name] = subprocess.Popen(
                [sys.executable, __file__, "--child"], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        bad = []
        for name, p in procs.items():
            out, err = p.communicate(timeout=900)
            if p.returncode != 0:
                print(err[-4000:], file=sys.stderr)
                bad.append(name)
                continue
            res = json.loads(out.strip().splitlines()[-1])
            passes = {rule: all(g[rule] <= 1 for g in res.values())
                      for rule in ("max_abs_rule", "row_rule")}
            print(json.dumps({"source": name, **res, "passes": passes}))
            if passes["row_rule"] != (name == "none") \
                    or (name == "none" and not passes["max_abs_rule"]):
                bad.append(name)
    if bad:
        print(f"flash_bwd_faults: unexpected result for {bad}",
              file=sys.stderr)
        return 1
    print("flash_bwd_faults: the unchanged kernel passes both rules, "
          "every fault fails the row rule")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        sys.exit(main())
