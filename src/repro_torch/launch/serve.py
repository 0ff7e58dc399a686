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

``build_engine(..., sp=, tp=, groups=)`` builds one rank of the Shift
Parallelism deployment: the base model on ``Layout(sp=sp, tp=tp)`` and the
shift model on its ``to_shift()``, over one paged pool, inside a rank of
``launch.mesh.run_ranks`` (which builds the ``groups``). As in the
reference, the CLI has no flag for them.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.engine import EngineConfig, Request, ShiftEngine
# the launch counters, read and reset by callers of the entry point
from repro_torch.kernels.ops import (launch_counts,  # noqa: F401
                                     reset_launch_counts)
from repro_torch.models import Model
from repro_torch.parallel import Groups, Layout

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
WEIGHT_SEED = 0


def build_engine(arch: str = "qwen3-8b", *, reduced=False, device="cuda",
                 dtype=torch.bfloat16, block_size=16, num_blocks=0,
                 paged=None, mixed=None, sp=1, tp=1,
                 groups: Groups = None) -> ShiftEngine:
    """Model with random weights (``torch.Generator`` seeded 0) and the
    engine with the reference CLI's settings: 8 slots, s_max 256, chunk 64;
    ``paged``/``mixed`` go to ``EngineConfig`` (None: paged and mixed when
    every layer pages, else the serialized dense engine). With ``sp·tp`` >
    1 (the counterpart of the reference's ``_build_stack(sp=, tp=,
    mesh=)``): this rank's base model on ``Layout(sp=sp, tp=tp)`` and shift
    model on its ``to_shift()``, both drawn from the same seed, over the
    grid's ``groups``. The model checks the device before it allocates
    anything."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    lay = Layout(sp=sp, tp=tp)
    models = []
    for layout in ((lay, lay.to_shift()) if lay.world > 1 else (lay,)):
        model = Model(cfg, device=device, dtype=dtype, lay=layout,
                      groups=groups)
        model.init_params(
            torch.Generator(device=model.device).manual_seed(WEIGHT_SEED))
        models.append(model)
    return ShiftEngine(models[0], EngineConfig(block_size=block_size,
                                               num_blocks=num_blocks,
                                               paged=paged, mixed=mixed),
                       shift=models[1] if len(models) > 1 else None)


def workload(n_requests: int, max_new: int):
    """The reference CLI's requests: prompt i is ``range(1, 20 + 3i)``."""
    t = time.monotonic()
    return [Request(i, list(range(1, 20 + 3 * i)), max_new_tokens=max_new,
                    arrival=t) for i in range(n_requests)]


def print_summary(eng: ShiftEngine):
    cc = eng.config_counts
    print(f"iteration: {'mixed' if eng.mixed else 'serialized'}")
    print(f"configs used: base={cc['base']} shift={cc['shift']}")
    if eng.paged:
        print(f"paged cache: 1 dp row(s) x {eng.kv.num_blocks} blocks x "
              f"{eng.cfg.block_size} tokens, {eng.preemptions} preemptions, "
              f"{eng.kv.num_free_blocks} free at exit")
    else:
        print(f"dense cache: {eng.cfg.max_slots} slots x {eng.cfg.s_max} "
              f"positions ({eng.paged_disabled_reason})")
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
    print("kernel launches: " + " ".join(
        f"{name}={n}" for name, n in launch_counts().items()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="the test-size config (2 layers, d_model 64)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV block size (tokens)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="physical KV blocks; 0 = no memory pressure. Small "
                         "values force admission control + preemption")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    eng = build_engine(args.arch, reduced=args.reduced, device=args.device,
                       dtype=DTYPES[args.dtype], block_size=args.block_size,
                       num_blocks=args.num_blocks)
    reqs = workload(args.requests, args.max_new)
    for r in reqs:
        eng.submit(r)
    t0 = time.monotonic()
    eng.run_until_idle()
    dt = time.monotonic() - t0
    for r in reqs:
        ttft = (r.first_token_time - r.arrival) if r.first_token_time else -1
        print(f"req {r.rid}: {len(r.generated)} tokens, "
              f"reason={r.finish_reason}, ttft={ttft*1e3:.0f}ms, "
              f"out={r.generated[:8]}...")
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"{n_tok} tokens in {dt:.2f}s")
    print_summary(eng)


if __name__ == "__main__":
    main()
