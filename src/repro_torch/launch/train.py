"""Training entry point (counterpart of ``repro.launch.train``; Ulysses
training, where SP comes from): checkpointed and restartable, with ZeRO-1
and optional int8 gradient compression, on one rank.

On the card (the default device)::

    PYTHONPATH=src python -m repro_torch.launch.train --steps 20

and on the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v3-671b --device cpu --steps 4

``--arch`` takes every config that trains (``transformer.check_trainable``):
the dense GQA stacks, the MoE stacks, deepseek-v3-671b (MLA, MoE and the
MTP head) and mamba2-1.3b (SSD, the tied table).

It trains the config's reduced size in fp32, as the reference's does
(its ``--reduced`` is always on). A checkpoint (global
logical arrays, ``training.checkpoint``) is written every ``--ckpt-every``
steps to ``--ckpt`` and resumed from when it exists. Each step's wall time
goes through ``ft.watchdog.StragglerWatchdog``."""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus, TokenBatcher
from repro_torch.ft.watchdog import StragglerWatchdog
from repro_torch.models import Model
from repro_torch.training import Trainer, load_checkpoint, save_checkpoint
from repro_torch.training.checkpoint import checkpoint_exists
from repro_torch.training.optimizer import AdamWConfig

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device, dtype=torch.float32)
    model.init_params(torch.Generator(device=model.device).manual_seed(0))
    tr = Trainer(model, AdamWConfig(lr=1e-3), microbatch=2,
                 grad_compression="int8" if args.compress else "none")
    opt = tr.init_opt_state()
    step0 = 0
    if checkpoint_exists(args.ckpt):
        step0, opt, _ = load_checkpoint(args.ckpt, model)
        if args.compress and "err" not in opt:
            opt["err"] = tr.init_opt_state()["err"]
        print(f"resumed from step {step0}")

    data = TokenBatcher(SyntheticCorpus(cfg.vocab_size), args.batch, args.seq)
    dog = StragglerWatchdog(window=8, factor=3.0)
    try:
        for i in range(step0, args.steps):
            toks, labels = next(data)
            t0 = time.monotonic()
            opt, loss = tr.step(opt, toks, labels)
            loss = float(loss)          # waits for the device
            dt = time.monotonic() - t0
            slow = dog.observe(dt)
            print(f"step {i}: loss={loss:.4f} ({dt * 1e3:.0f}ms, "
                  f"{args.batch * args.seq / dt:.0f} tok/s"
                  f"{' STRAGGLER' if slow else ''})")
            if (i + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt, i + 1, model, opt)
                print(f"checkpoint @ step {i + 1}")
    finally:
        data.close()


if __name__ == "__main__":
    main()
