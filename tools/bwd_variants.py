#!/usr/bin/env python3
"""Variants of the two backward kernels of training, timed in turns on the
card: ``python3 tools/bwd_variants.py``. Needs a card (each variant is
built with nvcc).

Each variant below rewrites a few lines of a temporary copy of
``csrc/flash_attention_bwd.cu`` or ``csrc/rmsnorm_bwd.cu`` (the
repository's files are never changed), is held against the plain version
at the training shapes (the row rule of ``chip_smoke.py``'s
``row_rel_err``) and timed beside the unchanged kernel in turns (unchanged,
variants, variants reversed, unchanged; ``chip_smoke.Timer``: cold L2,
median of 10). The flash backward runs at ``chip_smoke.FLASH_BWD_SHAPE``
(bf16, causal) through the wgmma C entry; the RMSNorm backward at a
microbatch's ln rows [4096, 4096] and q/k pair [131072 + 32768, 128] in
bf16. Also prints each flash launch's device time (``torch.profiler``).
One JSON line per kernel.
"""
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# kernel -> variant -> [(text, replacement)] in that kernel's source
VARIANTS = {
    "flash_attention_bwd": {
        "kv_ring_2": [("constexpr int KV_ST = 3;", "constexpr int KV_ST = 2;")],
        "q_ring_3": [("constexpr int Q_ST = 2;", "constexpr int Q_ST = 3;")],
        # warpgroup 1 skips the query tiles that none of its keys sees
        "masked_tiles_skipped": [(
            "      const int j = it / ntq, i0 = i_first + (it - j * ntq) * QT;\n"
            "      const uint32_t q_a",
            "      const int j = it / ntq, i0 = i_first + (it - j * ntq) * QT;\n"
            "      if (causal && kbase > off + i0 + QT - 1) {\n"
            "        __syncwarp();\n"
            "        if (lane == 0) mbar_arrive(empty + 8 * s);\n"
            "        continue;\n"
            "      }\n"
            "      const uint32_t q_a")],
    },
    "rmsnorm_bwd": {
        "one_team_of_256": [(
            "p.threads = std::max(256, std::min(2 * p.team, MAX_TEAM));",
            "p.threads = std::max(256, p.team);")],
        "cached_reads": [(
            "__ldcs(reinterpret_cast<const uint4*>(p));",
            "*reinterpret_cast<const uint4*>(p);")],
    },
}
ENTRY = {"flash_attention_bwd": "flash_attention_bwd_bf16_wgmma",
         "rmsnorm_bwd": "rmsnorm_bwd_bf16"}


def build_variants(tmp):
    """Start nvcc on every variant's copy; returns {kernel: {name: (proc,
    library path)}}."""
    from repro_torch.kernels import build
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    jobs = {}
    for kernel, variants in VARIANTS.items():
        for name, subs in variants.items():
            d = Path(tmp) / name
            shutil.copytree(csrc, d)
            src = (d / f"{kernel}.cu").read_text()
            for a, b in subs:
                assert a in src, (name, a)
                src = src.replace(a, b)
            (d / f"{kernel}.cu").write_text(src)
            so = d / "lib.so"
            proc = subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                 str(d / f"{kernel}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            jobs.setdefault(kernel, {})[name] = (proc, so)
    return jobs


def bind(kernel, jobs, argtypes, base):
    """The unchanged kernel's C entry and every variant's, by name."""
    fns = {"unchanged": base}
    for name, (proc, so) in jobs[kernel].items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), ENTRY[kernel])
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def in_turns(timer, runs):
    """Each run's times, in turns: every run, then every run reversed."""
    t = {n: [] for n in runs}
    for n in list(runs) + list(runs)[::-1]:
        t[n].append(timer(runs[n]))
    return t


def flash(torch, cs, jobs):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FAB
    fns = bind("flash_attention_bwd", jobs, FAB._ARGTYPES,
               FAB._bind("wgmma"))
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
    want = FAB.flash_attention_bwd_plain(q, k, v, out, lse, do, off)
    runs, rows = {}, {}
    for name, fn in fns.items():
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty_like(lse)

        def run(fn=fn, dq=dq, dk=dk, dv=dv, delta=delta):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), off.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), B, S, S, Hq, Hkv, D, 1,
                     float(D ** -0.5), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cudaError_t {err}")
            return dq, dk, dv
        got = run()
        torch.cuda.synchronize()
        rows[name] = max(cs.row_rel_err(torch, a, w)
                         for a, w in zip(got, want))
        cs.check(rows[name] <= cs.ROW_TOLS["torch.bfloat16"],
                 f"flash variant {name}: a row's error {rows[name]}")
        runs[name] = run
    launches = {}
    for name, run in runs.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
        launches[name] = {
            e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0]: e.device_time_total / e.count / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}
    return {"kernel": "flash_attention_bwd", "shape": cs.FLASH_BWD_SHAPE,
            "max_row_rel_err": rows, "ms": in_turns(cs.Timer(torch), runs),
            "launch_ms": launches}


def rmsnorm(torch, cs, jobs):
    from repro_torch.kernels import rmsnorm_bwd as RB
    fns = bind("rmsnorm_bwd", jobs, RB._ARGTYPES, RB._bind(torch.bfloat16))
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    ln = (rnd(4096, 4096), rnd(4096), rnd(4096, 4096))
    pair = (rnd(131072, 128), rnd(128), rnd(131072, 128), rnd(32768, 128),
            rnd(128), rnd(32768, 128))
    res = {"kernel": "rmsnorm_bwd", "shapes": {"ln rows": [4096, 4096],
                                               "q/k pair": [[131072, 128],
                                                            [32768, 128]]}}
    try:
        for case, run, plain in (
                ("ln rows", lambda: RB.rmsnorm_bwd_cuda(*ln),
                 lambda: RB.rmsnorm_bwd_plain(*ln)),
                ("q/k pair", lambda: RB.rmsnorm_pair_bwd_cuda(*pair),
                 lambda: RB.rmsnorm_pair_bwd_plain(*pair))):
            want = plain()
            runs = {}
            for name, fn in fns.items():
                RB._bound[torch.bfloat16] = fn
                err = max(cs.row_rel_err(torch, a, w)
                          for a, w in zip(run(), want))
                cs.check(err <= cs.ROW_TOLS["torch.bfloat16"],
                         f"rmsnorm variant {name} {case}: a row's error {err}")

                def timed(fn=fn):
                    RB._bound[torch.bfloat16] = fn
                    return run()
                runs[name] = timed
            res[case] = in_turns(cs.Timer(torch), runs)
    finally:
        # the wrapper's own kernel again, whatever a variant did
        RB._bound[torch.bfloat16] = fns["unchanged"]
    return res


def main():
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("bwd_variants: no card", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        jobs = build_variants(tmp)
        build.build_all(["flash_attention", "flash_attention_bwd",
                         "rmsnorm_bwd"])
        print(json.dumps(flash(torch, cs, jobs)))
        print(json.dumps(rmsnorm(torch, cs, jobs)))
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
