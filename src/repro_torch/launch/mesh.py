"""Process meshes of the port (counterpart of ``repro.launch.mesh``'s
``make_test_mesh``): ``run_ranks`` runs one process per rank of an (sp, tp)
grid, as ``shard_map`` runs one program per device of the reference's
``make_mesh((1, sp, tp), ("data", "sp", "tp"))``.

The backend is an argument, never a default or a fallback: ``"gloo"``
runs on the CPU, and also with CUDA tensors, which it stages through the
host (several ranks may then share one card); ``"nccl"`` needs one card per
rank and raises with fewer.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.parallel import Groups


def _rank_main(rank, sp, tp, device, backend, timeout_s, store_path, fn,
               args, results):
    """One rank: join the group, build the grid's process groups, run
    ``fn(rank, groups, *args)`` and post its result (or its traceback)."""
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        world = sp * tp
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, Groups(sp, tp), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:       # the job's boundary: report it to the parent
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, sp: int, tp: int, *, device: str, backend: str,
              timeout_s: float, args=()) -> list:
    """Run ``fn(rank, groups, *args)`` in ``sp*tp`` spawned processes, one
    per rank ``r = i*tp + j``, over a ``FileStore`` in a temporary
    directory, and return every rank's result in rank order. ``fn`` and its
    arguments and results must pickle (``fn`` by import path). ``device``
    ("cpu" or "cuda") sets each rank's card, ``rank % device_count()``;
    ``timeout_s`` bounds each collective and the whole job. Raises the
    first rank's failure (with its traceback) or a timeout, after stopping
    every process."""
    world = sp * tp
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: use 'cpu' or 'cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False")
    if backend == "nccl" and (device != "cuda"
                              or torch.cuda.device_count() < world):
        raise RuntimeError(
            f"backend='nccl' needs one card per rank: {world} ranks, "
            f"{torch.cuda.device_count() if device == 'cuda' else 0} "
            "cards (NCCL refuses two ranks on one card)")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out, deadline = {}, time.monotonic() + timeout_s
    dead_seen = False
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(rank, sp, tp, device, backend, timeout_s,
                  os.path.join(tmp, "store"), fn, args, results))
            for rank in range(world)]
        try:
            for p in procs:
                p.start()
            while len(out) < world:
                try:
                    rank, ok, res = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and not p.is_alive()]
                    # a rank that just exited may have left its result in
                    # the pipe: poll once more before calling it lost
                    if dead and dead_seen:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    dead_seen = bool(dead)
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"ranks {sorted(set(range(world)) - set(out))} "
                            f"gave no result within {timeout_s} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{res}")
                out[rank] = res
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]
