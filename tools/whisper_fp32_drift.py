#!/usr/bin/env python3
"""How far whisper-small's fp32 results on the card part from the CPU's, by
depth: ``PYTHONPATH=src python3 tools/whisper_fp32_drift.py``. Needs a
card.

For each depth L (L encoder and L decoder layers at full width: d_model
768, 12 heads of 64, 1536 frames), draws the weights on the card from seed
0 (as ``chip_smoke.py``'s ``seeded_init`` does for every whisper phase),
copies them to a CPU model, and runs one prefill step (2 rows of 64
tokens, the engine's zero frames) in fp32 on both, TF32 off: the same
function, summed in another order. Prints one JSON line per depth with the
logits' largest card-against-CPU difference beside their largest |value|
and whether each row's argmax agrees; then one line on how hard the first
encoder layer's attention is at these weights: the share of its softmax
rows whose largest weight exceeds 0.99, and the median gap between the two
largest scores of a row. ``attn_init`` draws q and k at 1/sqrt(12) (the
fan-in its ``dense_init`` reads is the head count), so the scores of
d_model 768 spread far (no q/k norm, no soft cap): a row picks one key,
and rounding that moves a near-tie moves the pick.
"""
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import seeded_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

DEPTHS = (1, 2, 3, 4, 6, 12)
B, C = 2, 64


def drift(layers):
    cfg = dataclasses.replace(get_config("whisper-small"), num_layers=layers,
                              encoder_layers=layers)
    gpu = Model(cfg, device="cuda", dtype=torch.float32)
    seeded_init(torch, gpu, 0)
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.load_params({k: v.cpu() for k, v in gpu.params.state_dict().items()})
    toks = (torch.arange(B * C, dtype=torch.int32).reshape(B, C) * 7) \
        % cfg.vocab_size
    frames = torch.zeros((B, cfg.encoder_seq, cfg.d_model))
    out = []
    for m in (gpu, cpu):
        m.init_cache(B, 256)
        out.append(m.prefill(toks, torch.zeros(B, dtype=torch.int32),
                             enc_frames=frames)[0].cpu())
    g, c = out
    return {"layers": layers, "logits_err": (g - c).abs().max().item(),
            "max_abs": c.abs().max().item(),
            "argmax_equal": (g.argmax(-1) == c.argmax(-1)).tolist()}, gpu


@torch.no_grad()
def hardness(model):
    """The first encoder layer's softmax rows over the engine's zero frames
    (the sinusoid alone), on one row of the batch."""
    cfg, p = model.cfg, model.params
    S = cfg.encoder_seq
    pos = torch.arange(S, device="cuda")
    x = T._sin_pos(pos, cfg.d_model)[None]
    h = p.encoder[0].ln1(x)
    dh = cfg.head_dim
    q = (h @ p.encoder[0].attn.wq).reshape(S, -1, dh).transpose(0, 1)
    k = (h @ p.encoder[0].attn.wk).reshape(S, -1, dh).transpose(0, 1)
    s = q @ k.transpose(1, 2) * dh ** -0.5                  # [H, S, S]
    top = s.topk(2, dim=-1).values
    w = torch.softmax(s, -1).amax(-1)
    return {"encoder_layer0_rows": w.numel(),
            "share_top_weight_above_0.99": (w > 0.99).float().mean().item(),
            "median_top2_gap": (top[..., 0] - top[..., 1]).median().item(),
            "score_std": s.std().item()}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = None
    for layers in DEPTHS:
        row, model = drift(layers)
        print(json.dumps(row), flush=True)
    print(json.dumps({"hardness": hardness(model)}))


if __name__ == "__main__":
    main()
