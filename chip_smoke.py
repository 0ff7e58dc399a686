#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``
from the root of a checkout.

Phases (every failure propagates and exits non-zero):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN, so fp32 means fp32;
2. build: the CUDA kernels from the checkout's sources with nvcc (one
   process per source, all started together);
3. the timer's floor (an empty kernel's time), then each kernel against its
   plain PyTorch version on the card at the main paths' shapes (qwen3-8b:
   32 query heads, 8 KV heads, head_dim 128, block 16; RMSNorm at the
   prefill and decode steps' shapes of both models, grouped over mamba2's
   64 SSD heads of 64, and a layer's q and k norms in one launch, bitwise
   equal to two single launches, with the host's µs per wrapper call; flash
   over a 64-token chunk against a dense cache of 2048 and the TPU kernel's
   own case; the ragged kernel also at speculative verify rows (q_len 1-5
   in a C = 8 bucket, contexts up to 2048) and at the prefix path's
   prefill rows past a 48-token cached prefix (C = 32); decode over contexts up to 2048 and over one sequence of 2048,
   beside the ragged kernel on the same K/V; the SSD chunk at mamba2-1.3b's
   serving prefill step, a long prompt, a short chunk and the TPU
   contract's per-(head, chunk) copies), in fp32 and bf16, with its time,
   the plain version's, a PyTorch library call's where one computes the
   same function, and the least time the card could take; for attention
   also the achieved TFLOP/s and the bound's share of the time (for the SSD
   chunk the share, and the bound against the fp32 peak beside the one
   against its inputs' type), and in bf16 two wider cases for the
   tensor-core tiles (ragged prefill chunks of 256 against contexts of
   2048, a flash serving chunk of 256); the padded paged decode also
   against the ragged kernel at C == 1, with its host µs per call; and
   qwen-32b's shapes: the ragged kernel's mixed and decode batches at 64
   query heads over 8 KV heads (group 8), RMSNorm over rows of 5120 (its
   first serving step's [512, 5120] and a decode step's [8, 5120]; fp32
   rows past 4096 take 8 chunks a lane on 256 lanes) and the q/k pair
   over 64 + 8 heads per token;
4. the slice against itself across devices: the engines on reduced
   qwen3-8b at fp32 (mixed, serialized on the paged pool, serialized on the
   dense cache) and on reduced mamba2 (the dense fallback, with two
   requests in flight and more requests than slots) on the card (kernels)
   and on the CPU (plain versions) give equal streams, config counts,
   preemptions and observability dumps (less their time fields and the
   watchdog's flags), and one mixed step's and one dense prefill + decode's
   logits agree within 1e-4; the mixed engine with the prefix cache and
   k=4 speculation, after a 16-token shared prefix, with and without pool
   pressure, gives equal streams, cached tokens, prefix stats, spec counts,
   preemptions and config counts; the fork + COW case (a forked tail
   block copied in place, two continuations decoded) equal streams; and
   the mixed engine under a fixed fault plan (an alloc fault, a ``nan``
   and a ``raise`` forward fault, a route fault; ``quarantine_after`` 10)
   gives the clean run's streams on both devices, with equal outcomes,
   fail counts, failed steps, retries, preemptions, ledgers and dumps;
   and the mixed engine under ``--adaptive``'s policy (the cost model at
   the H100's numbers over (2, 2)) equal streams, per-step configs (both
   used) and dumps;
5. the main paths: ``repro_torch.launch.serve.build_engine`` serving
   qwen3-8b at full width in bf16 (random weights, generator seeded 0)
   with the serve CLI's workload, 6 requests x 16 new tokens, through the
   mixed paged engine, then on the same weights through the serialized
   engine on the paged pool and on the dense cache; then mamba2-1.3b at
   full width through its dense serialized fallback with the same
   workload. Each path runs in turns on one model: the engine's eager step
   tables (built here, explicitly), its graphed ones (every step captured
   once per bucket as a CUDA graph and replayed, as the engine runs), the
   graphed ones again and the eager ones again, each turn a warm-up run
   and a measured run of the workload and a ``torch.profiler`` trace of
   decode steps. Every launch counter is set to 0 before each measured
   run and must equal that path's per-step counts times its steps of each
   kind (a replay adds the launches its capture recorded); the profiler's
   trace must hold each port kernel's launches of a decode step; no
   capture may happen in a measured run or the profiled steps; the
   streams and launch counts of all four turns must be equal; no block
   may leak. Captured entries' full-width logits are held to the eager
   steps' on small caches. Each turn prints its wall ms per decode step,
   TTFT, decode tokens/s, device busy ms per step and busy share, graphs
   captured and capture ms (also as one ``{"graph_turns": ...}`` line).
   The ``mixed_prefix_spec`` path serves the same weights with the prefix
   cache and k=4 drafts, the workload after a 32-token shared prefix (all
   six requests arrive together, so five wait for the first one's
   in-flight prefix and then hit it), on the eager tables, the graphed
   ones and the graphed ones without drafts; each turn a warm-up run, the
   cache emptied, and a measured run: eager and graphed streams and
   launches equal, a prefix hit and an in-flight wait, drafts, no block
   held at exit, launches exact per step, no capture in the measured run;
   it prints the hits, tokens saved, COW copies, drafts, steps saved, wall
   ms per step, TTFT, tokens/s and the graphs by verify width. Counts of
   the engine's registry (configs, drafts) are read as deltas over the
   measured run;
5b. observability and the request lifecycle on the same model: the
   graphed mixed paged engine over the serve workload with obs on, off,
   on and off (``NullObs`` swapped in): equal streams, steps and launches,
   the wall per decode step of each turn and the ratio of on to off
   (``obs.overhead_ratio``); each on-turn's dump must hold together
   (``steps_total{config}`` equal to the configs the policy chose, the
   records' token sums equal to the token counters and the requests'
   tokens, 6 TTFT and E2E observations, each ``finish`` event's ``ttft_s``
   the request's, the records' durations 0.95-1.0 of the run's wall, one
   Chrome-trace "X" event per record), and its report and the median
   ``dur_s`` by config and by kind of step are printed; the graphed
   serialized paged engine the same, in turns with and without its
   prefill step's wait for the device (median prefill and decode
   ``dur_s``, run walls); then the lifecycle drill by hand on a cut pool
   under both shed policies (two requests, a step, four more, a deadline
   moved into the past and a cancel after step 3, ``drain()``, a request
   after it): every request ends with one reason, the reason counters
   match, no block is held and the late request is shed. One
   ``{"obs": ...}`` line;
5c. faults, snapshots and crash recovery on the same model: the graphed
   mixed paged engine under the seeded storm ``random_plan(13, 48,
   p_alloc=p_forward=p_route=0.1)`` with snapshots every 4 steps; the
   uninterrupted run (launches counted from 0: 109 RMSNorm and 36 ragged
   per step whose forward ran), an in-place restore of its step-4
   snapshot (no graph captured, the rest of the run equal bitwise), the
   crash drill (dropped after step 14, a new engine recovers from the
   ring under a ``DeliveryLog``: no divergence, the uninterrupted
   streams bitwise, typed outcomes, no block held) and a corrupted newest
   snapshot (``recover`` falls back to step 8; a direct restore raises
   ``SnapshotError`` and changes nothing). It prints the ms per snapshot
   and restore, the bytes per snapshot, the walls, the failed steps,
   retries, preemptions and steps by config, and how many faulted bf16
   streams equal the clean ones (reported only). One ``{"faults": ...}``
   line;
   The adaptive turn: the graphed mixed paged engine on the same model
   under ``--adaptive``'s policy (world size 1, priced over (2, 2)): its
   streams equal the threshold turn's bitwise (base and shift are one
   model here), launches exact per step and equal to that turn's, each
   step's config the policy's answer to its recorded facts; it prints the
   steps by config, the host µs per ``use_base`` call (1000 calls, no
   sync) and, beside the measured wall and busy ms per decode step, the
   cost model's prediction at one chip (printed only);
5d. qwen-32b (the paper's Table 4 model: 64 layers, d_model 5120, 64 q
   heads over 8 KV heads) at full width and depth in bf16 on the card,
   after the qwen3-8b and mamba2 models are freed and a reckoning of its
   65.52 GB of weights, the pool, the init temporary and a headroom
   against the free memory (no fit, no run): the serve workload through
   the graphed mixed paged engine under the threshold policy and under
   ``--adaptive``'s, equal streams, 193 RMSNorm and 64 ragged launches
   per step (counters and the profiler's trace of decode steps), no block
   held at exit; TTFT, wall and busy ms per decode step, decode tokens/s
   and the cost model's prediction; then a 2-layer cut at full width in
   fp32, one mixed step's logits on the card against the CPU within 2e-3.
   Then the serving simulator on the paper's bursty trace for llama-70b
   and qwen-32b under dp, tp, sp and shift over 8 chips at the H100 data
   sheet's constants (modeled numbers, not measurements; one
   ``{"simulator": ...}`` line);
5e. the cluster, on the served qwen3-8b (at the end of phase 5): two
   graphed replicas over its ONE weight set behind
   ``repro_torch.cluster.Router`` (each its own pool and graphs, the
   prefix cache on), two turns, the second capturing nothing: the serve
   workload after a 32-token shared prefix under ``affinity`` (on one
   replica, the other prefilling nothing, saving what a lone engine
   saves) and under ``round-robin`` (prefilled on both, saving less); a
   lone request migrated at 4, 8 and 12 tokens (ms per ``migrate`` on the
   host clock after a synchronize, blocks and bytes moved) whose bf16
   stream equals the bare engine's bitwise; a rebalance run under skew;
   launches exact per forward step in every run; then ``drain`` (both
   ledgers ``used == pinned == 0``) and the merged dump (every record
   stamped with its replica, counters equal to the replicas' sums). One
   ``{"cluster": ...}`` line;
6. the layouts: four ranks of (sp, tp) = (2, 2), one process each, all on
   the one card with the collectives over gloo (NCCL refuses two ranks on
   one card; ``launch.mesh.run_ranks`` with ``backend="gloo"``): the fp32
   logits of the base and shift models at full width (2 layers) against
   the single-rank model on the same weights (2e-3), then qwen3-8b at full
   width and depth in bf16 through the SPMD engine (base on the grid, shift
   on its ``to_shift()``, one pool per rank) with the serve workload:
   equal streams on every rank, both configs used, no block leaked, 109
   RMSNorm and 36 ragged launches per step and rank (counters, and rank
   0's profiler trace of one base and three shift steps), the shared-block
   invariance on the card's pools; then the prefix cache and k=4 on the
   same models with the 32-token shared prefix: every rank's streams,
   cached tokens, prefix stats and spec counts equal, a hit and drafts, no
   block held at exit, 109 and 36 launches per step; it prints wall ms and
   collective bytes per step by config, one all-reduce's ms on card and
   host tensors, and peak memory per rank; then the serve workload under
   ``--adaptive``'s policy over the grid: every rank's streams equal to
   those of the threshold run that makes the same per-step configs, each
   step's config the policy's answer to its recorded facts, 109 and 36
   launches per step. Then the serialized iteration on the same models,
   over one paged pool per rank and over one dense cache per rank, and
   mamba2-1.3b at full width and depth in bf16 through its dense fallback
   on the grid (its SSD mixers through the Ulysses exchange): the serve
   workload on every rank, streams equal on every rank, both configs
   used, launches exact per step of each kind and rank (RMSNorm, and
   ragged, or flash in a prefill step and decode in a decode step, or
   the SSD chunk in a prefill step: counters, and rank 0's profiler
   trace of one prefill and three decode steps), no block held, and the
   dense cache's invariance after a base prefill step and a shift decode
   step (one set of tensors, the base step's positions unchanged); it
   prints the wall per step by config and kind, the collective bytes per
   step and the peak memory per rank. Before the bf16 runs, the fp32
   serialized prefill then decode at full width and 2 layers, on the
   dense cache and the paged pool (qwen3-8b) and on the dense cache
   (mamba2-1.3b), base and shift, against the single-rank model on the
   same weights (2e-3). Phase 3 also holds the kernels at a rank's shapes
   on the grid: the ragged kernel and the q/k pair (8 q and 2 kv heads),
   flash over the whole 64-column chunk after the exchange against dense
   caches of 256 and 2048, the dense decode over its dp row's 8 rows,
   the SSD chunk at 16 and 8 heads, and the grouped RMSNorm at 16 and 8
   heads of 64;
7. data parallelism, all on the one card over gloo, after a reckoning of
   the card's memory (the parent holds no model): (dp, sp, tp) = (2, 1, 1),
   two processes each with the whole qwen3-8b at full width and depth in
   bf16 and its row's pool of 65 blocks, serving the serve workload and
   then the prefix + spec workload; every rank's streams equal, both rows
   used, the streams equal to a dp=1 engine's in each rank's process over
   the same weights fed that rank's row's requests, its every step fitted
   to the row's segment of the dp batch (the same inputs after zero
   padding, run at the dp step's shapes), no block held at exit
   (``used == pinned == entries`` per row), 109 and 36 launches per step
   and rank, both ranks' observability dumps equal once the time fields
   are dropped, with a trace lane per dp row; it prints per row the
   requests, hits, tokens saved and free blocks, the TTFT, the wall per
   step by config, the decode tokens/s, the ``dp_all_gather`` bytes and
   calls per step, and rank 0's observability report. Each rank then
   snapshots its shard after step 4 of the serve workload and a new
   engine on the rank restores it: the rest of the run equals the
   uninterrupted run bitwise on both ranks.
   Then (2, 2, 2), eight processes at full width with the depth cut to
   the most layers (at least 8) that fit with 20 % of the free memory
   spare: every rank's streams equal; each row's segment of every step,
   replayed through (1, 2, 2) models, gives the same tokens bitwise; and
   the streams equal a (1, 2, 2) engine's fed each row's routed requests,
   pinned as above to the row's segments and the dp step's config; it
   prints the wall per step by config and the collective bytes by kind;
8. resharding, two processes on the one card over gloo, the parent holding
   nothing: qwen3-8b at full width with the depth cut by a memory
   reckoning (and at most ``RESHARD_MAX_LAYERS``), fp32 then bf16: a
   static (2, 1, 1) run, then the same requests behind a one-replica
   Router through ``schedule_reshard`` to (1, 1, 2) and back mid-decode:
   every rank's streams equal, delivered exactly once, fp32 equal to the
   static run's, bf16's agreement printed; launches exact per step; ms
   per reshard, blocks moved, ``reshard_gather`` and weight bytes. One
   ``{"reshard": ...}`` line.

5g. deepseek-v3-671b (multi-head latent attention, three dense prefix
   layers, 256 experts of 2048) at full width in bf16 on one card, its
   depth cut to the 3 dense prefix layers and 2 of the 58 MoE layers (the
   bytes reckoned per part against the free memory first; random weights,
   each expert drawn from a generator of its own): the serve workload
   through the serialized dense engine (MLA does not page), eager,
   graphed, graphed and eager, equal streams, 21 RMSNorm launches per step
   (ln1, ln2, the q and kv latent norms of every layer, the final norm;
   the attention is plain PyTorch), TTFT, ms per decode step, tokens/s
   and busy ms; then reduced deepseek-v3-671b in fp32, one prefill and one
   decode step's logits on the card against the CPU within 1e-3. Phase 3
   holds RMSNorm at its widths (7168, the q latent 1536, the strided kv
   latent 512 of 576) at a prefill step's 512 rows and a decode step's 8;
9. pod-scale MoE over gloo on the one card: deepseek-v3-671b at full
   width, the depth cut to 1 dense prefix layer and 1 MoE layer (the
   bytes per rank reckoned first), on (sp, tp) = (2, 2) (the latent cache
   sharded over the sequence, the LSE merge over sp; base and shift
   models) and on (dp, sp, tp) = (2, 1, 1) (the experts across the two dp
   rows): the serve workload through the serialized dense engine, every
   rank's streams equal, launches exact, the latent invariance after a
   base prefill step and a shift decode step, and the all-to-all bytes
   per step by config; then reduced deepseek-v3-671b and llama4-17b-16e
   in fp32 on (2, 2, 2), eight ranks, the card against the CPU: the
   equivalence inputs' logits within 1e-3 and the engines' streams
   equal.

5h. recurrentgemma-9b (RG-LRU recurrent blocks and local attention over a
   ring cache with soft-capped scores, MQA of 16 heads of 256 over one KV
   head, GeGLU) at full width and depth in bf16 on one card (19.25 GB;
   the bytes reckoned against the free memory first): the serve workload
   through the serialized dense engine (its layers do not page), eager,
   graphed, graphed and eager, equal streams, 77 RMSNorm launches per
   step (ln1 and ln2 of 38 layers and the final norm; the ring attention
   and the RG-LRU are plain PyTorch), TTFT, ms per decode step, tokens/s,
   busy ms and peak memory; then reduced recurrentgemma-9b in fp32, card
   against CPU: prefill and two decode steps with the ring of 8 rows
   wrapping (logits and every cache tensor within 1e-3) and the dense
   engine's streams with more requests than slots;
9b. recurrentgemma-9b at full width cut to one (rglru, rglru, local)
   pattern and the two suffix layers, in fp32 on (sp, tp) = (2, 2) over
   gloo on the one card (the RG-LRU's branches through the Ulysses
   exchange as channel blocks): the serve workload through the serialized
   dense engine, every rank's streams equal and equal to a one-rank run's
   at the same depth, 11 RMSNorm launches per step, the dense cache's
   invariance on every rank; it prints the base prefill and shift decode
   walls per step with their all-to-all and all-reduce bytes.

5i. whisper-small (12 encoder layers over 1536 frames, 12 decoder layers
   with cross attention, d_model 768, 12 heads of 64 over 12 KV heads,
   LayerNorm, the plain GELU MLP) at full width and depth in bf16 on one
   card: the serve workload through the serialized dense engine (an
   encoder-decoder stack does not page; every prefill step runs the
   encoder over the engine's zero frames and rewrites the cross caches),
   eager, graphed, graphed and eager, equal streams, 36 flash launches per
   prefill step and 24 decode launches per decode step (counters, and the
   profiler's trace of decode steps), no RMSNorm; TTFT, ms per decode
   step, tokens/s, busy ms and peak memory; then reduced whisper-small in
   fp32, card against CPU: prefill with random frames and two decode
   steps (logits and the self and cross caches within 1e-3) and the dense
   engine's streams with more requests than slots;
5j. internvl2-2b (24 GQA layers, 16 q heads over 8 KV heads, the vision
   stub over the first 256 positions) at full width in bf16: the serve
   workload after a 256-token prefix (s_max 512), so that text tokens
   reach the logits, through the mixed paged engine and its zero image
   embeddings, eager, graphed, graphed and eager, equal streams, 49
   RMSNorm and 24 ragged launches per step; then reduced internvl2-2b in
   fp32, card against CPU: a prefill step's logits with random image
   embeddings within 1e-3, and the mixed, serialized paged and serialized
   dense engines' streams, each path on its own;
9c. whisper-small at full width in fp32, cut to 2 encoder and 2 decoder
   layers, on (sp, tp) = (2, 2) over gloo on the one card (at its random
   init fp32 streams of another summation order part with depth:
   ``tools/whisper_fp32_drift.py``; the encoder's frames and each chunk
   through
   the Ulysses exchange, the cross K/V scattered with the KV
   replication): the serve workload through the serialized dense engine,
   every rank's streams equal and equal to a one-rank run's, launches
   exact, the dense cache's invariance on every rank (the cross cache
   included); it prints the base prefill and shift decode walls per step
   with their all-to-all and all-reduce bytes.
   Phase 3 also holds the kernels at these models' shapes: flash over
   whisper's encoder ([8, 1536, 12, 64], non-causal), its cross prefill
   (64 queries over 1536 frames) and its decoder's causal chunk (s_max
   256), the dense decode at group 1 over 1536 frames and over s_max 256,
   and the ragged kernel's mixed and decode batches at internvl2-2b's 16
   q heads over 8 KV heads.
10. training (PR 30): phase 3 also holds the two backward kernels of
   training against their plain backward versions, bf16 then fp32, each
   twice (bitwise equal: no atomics): flash at a microbatch of qwen3-8b
   (B 2 x S 2048, 32 over 8 heads of 128, causal; within 2e-2 / 1e-4 of
   each gradient's largest entry, and each row, one token's and head's
   gradient, within 2e-2 / 1e-3 of its own norm plus 1 % of the rms row
   norm; so is every RMSNorm row), beside SDPA's backward through
   autograd, with the forward's training instance (its log-sum-exp within
   1e-4 of the plain version's) timed beside the serving one; RMSNorm over
   [4096, 4096] (beside ``F.rms_norm``'s backward), the q/k pair [4096 x
   32 + 4096 x 8, 128] in one call and grouped over 64 heads of 64. After
   phase 4, reduced qwen3-8b in fp32 on the card against the CPU: the loss
   (1e-5) and gradients (1e-4 of each leaf's largest entry) of one
   ``Model.loss_fn`` call, three Trainer steps (microbatch 2, remat: the
   losses within 1e-4, the params within 5e-4 outside entries whose
   gradient is below 1e-7). After phase 5j, the main path of training:
   qwen3-8b at full width, its depth cut to a fixed 12 of 36
   (``train_layers`` checks that it fits the card's memory), bf16, six
   Trainer steps of 4 x 2048 synthetic tokens on one fixed batch,
   microbatch 2, remat, lr 3e-4: the loss must fall by more than 0.3, the
   kernel launches per step must be exactly 2L x 2 flash forward,
   3 x L x 2 flash backward (three launches a call), (6L + 1) x 2 RMSNorm
   forward and 2 x (3L + 1) x 2 backward (two a call); one ``{"training": ...}``
   line with ms per step, tokens/s, peak GB, device busy ms per step
   (``torch.profiler`` over a seventh step). After the simulator line,
   reduced qwen3-8b in fp32 on (sp, tp) = (2, 2) over gloo, four ranks on
   the card, each also on the CPU: every rank's loss equals a one-rank
   run's, each rank's card gradients and three step losses equal its CPU
   ones (a rank's gradients are the reference's per-device ones).
11. MoE training (PR 32): phase 3 also holds the two backward kernels at
   qwen-30b-a3b's training shapes in bf16 (flash at B 2 x S 2048, 32 over
   4 heads of 128, with the forward's training instance; RMSNorm over
   [4096, 2048] and the q/k pair [4096 x 32 + 4096 x 4, 128]). The card
   against the CPU and the (2, 2) gloo job of phase 10 also run reduced
   qwen-30b-a3b in fp32 (its 4 experts over sp in the job, the aux loss in
   the loss). After phase 10's main path, with every earlier model freed,
   qwen-30b-a3b at full width (128 experts of 768, top-8, capacity factor
   1.25, 32 over 4 heads with q/k norms), its depth cut to a fixed 4 of 48
   (``train_layers``), bf16, the same six steps: the loss must fall by
   more than 0.3, the aux loss of the trained weights must be finite and
   positive, and the launches per step follow phase 10's formula; one
   ``{"training_moe": ...}`` line with ms per step, tokens/s, peak GB,
   busy ms (a seventh step under ``torch.profiler``), the expert ``bmm``s'
   share of it and the share of routed assignments that capacity drops.

With no arguments it needs one card. The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
import contextlib
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12,    # dense tensor cores
              "torch.float32": 67e12}      # fp32 outside the tensor cores
ATTN_TPU = "src/repro/kernels/paged_ragged_attention.py:124"
RMS_TPU = "src/repro/kernels/rmsnorm.py:17"
FLASH_TPU = "src/repro/kernels/flash_attention.py:62"
DECODE_TPU = "src/repro/kernels/decode_attention.py:57"
PAGED_DECODE_TPU = "src/repro/kernels/paged_decode_attention.py:67"
SSD_TPU = "src/repro/kernels/ssd_scan.py:47"
CSRC = "src/repro_torch/kernels/csrc/"
# the decode rows of the ragged kernel's decode case: (context, q_len)
DECODE_ROWS = [(2048, 1), (1536, 1), (1024, 1), (777, 1), (512, 1), (256, 1),
               (100, 1), (1, 1)]
# a MoE model's serving step: seven decode rows beside a 64-column prefill
# row (C = 64, so each decode row has 63 padding columns)
MOE_MIXED = [(640, 64)] + DECODE_ROWS[:7]
# a whisper decode step's self-attention lengths: the serve workload's
# prompts (19-34 tokens) a few steps in, two idle slots, and s_max
WHISPER_SELF_LENS = [23, 28, 31, 34, 37, 40, 1, 256]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_report(name, log):
    """Print ptxas' registers and spills of each kernel in one library's
    build log, under a short name (kernel<float/bf16, template ints>)."""
    kernel = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            kernel = mangled[-60:]
            k = re.search(r"_kernel(?=[IE])", mangled)
            # the identifier is prefixed by its length, after a hash
            for j in range(k.end() - 1, 0, -1) if k else ():
                digits = re.search(r"\d+$", mangled[:j])
                if digits and any(int(digits.group()[-n:]) == k.end() - j
                                  for n in range(1, len(digits.group()) + 1)):
                    args = mangled[k.end():]
                    args = args[:args.find("EE") + 2] if args[0] == "I" else ""
                    kind = ("float, " if args.startswith("If") else
                            "bf16, " if "bfloat16" in args else "")
                    ints = ", ".join(re.findall(r"Li(\d+)E", args))
                    kernel = f"{mangled[j:k.end()]}<{kind}{ints}>"
                    break
        elif "registers" in line or "spill" in line:
            print(f"  {name}: {kernel}: {line.strip()}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


class Timer:
    """Device time of one call by CUDA events, median over ``iters``. Each
    measured call runs cold in L2 (a 64 MB buffer is rewritten before it)
    and behind a spin kernel, so the host's launch cost stays out of the
    measured interval."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            torch.cuda._sleep(2_000_000)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def compare(torch, what, got, want, tol):
    """Max abs error of ``got`` against ``want``; fails unless finite and
    within ``tol`` (allclose, absolute and relative)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    check(torch.isfinite(g).all(), f"{what}: non-finite output")
    check(torch.allclose(g, w, atol=tol, rtol=tol),
          f"{what}: max abs err {err} > tol {tol}")
    return err


def bound(nbytes, flops, dtype):
    """The least time the card could take, ms, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rates(case, flops):
    """Add an attention case's achieved TFLOP/s (the flops its inputs need
    over its measured time) and its bound share (bound over measured
    time)."""
    case["tflops"] = flops / (case["ms"] * 1e-3) / 1e12
    case["bound_share"] = case["bound_ms"] / case["ms"]
    return case


def attention_case(torch, name, rows, dtype, timer, tol, Hq=32, Hkv=8,
                   C=None, pad_cols=False):
    """rows: [(ctx, q_len)] of one batch; Hq 32, Hkv 8 (a rank's 8 and 2
    on the layout phase's grid), D 128, bs 16; C query columns per row
    (the longest q_len unless given: the engine pads to a power of two).
    With ``pad_cols`` (a MoE model's instance) the padding columns are
    computed and held against the plain version too, the bound counts
    their work, and the kernel is also timed without the option
    (``ms_pad_off``) on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_ragged_attention as PRA
    D, bs = 128, 16
    g = Hq // Hkv
    B = len(rows)
    C = C or max(ql for _, ql in rows)
    ctx = torch.tensor([c for c, _ in rows], dtype=torch.int32)
    ql = torch.tensor([q for _, q in rows], dtype=torch.int32)
    nbs = [-(-c // bs) for c, _ in rows]
    nmax = max(nbs)
    gen = torch.Generator(device="cuda").manual_seed(len(rows) * 1000 + C)
    nblocks = sum(nbs) + 1
    perm = torch.randperm(nblocks - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((B, nmax), dtype=torch.int32)
    i = 0
    for b, nb in enumerate(nbs):
        bt[b, :nb] = perm[i:i + nb].cpu()
        i += nb
    q = torch.randn((B, Hkv, g, C, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((nblocks, bs, Hkv, D), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((nblocks, bs, Hkv, D), generator=gen,
                     device="cuda").to(dtype)
    args = (q, kp, vp, bt.cuda(), ql.cuda(), ctx.cuda())

    got = PRA.paged_ragged_attention_cuda(*args, pad_cols=pad_cols)
    torch.cuda.synchronize()
    want = PRA.paged_ragged_attention_plain(*args)
    torch.cuda.synchronize()
    check(torch.isfinite(got.float()).all(), f"attention {name}: non-finite")
    err = 0.0
    for b, (_, n) in enumerate(rows):      # real columns, or all of them
        n = C if pad_cols else n
        gb, wb = got[b, :, :, :n].float(), want[b, :, :, :n].float()
        err = max(err, (gb - wb).abs().max().item())
        check(torch.allclose(gb, wb, atol=tol, rtol=tol),
              f"attention {name} row {b}: max abs err "
              f"{(gb - wb).abs().max().item()} > tol {tol}")

    # yardstick: SDPA over K/V already gathered dense (gather not timed)
    kd = PRA._paged_gather(kp, args[3]).permute(0, 2, 1, 3)  # [B,Hkv,L,D]
    vd = PRA._paged_gather(vp, args[3]).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    qd = q.reshape(B, Hq, C, D)
    L = kd.shape[2]
    qpos = (ctx - ql)[:, None] + torch.arange(C)[None]
    kpos = torch.arange(L)
    mask = ((kpos[None, None] <= qpos[:, :, None])
            & (kpos[None, None] < ctx[:, None, None]))[:, None].cuda()

    ms = timer(lambda: PRA.paged_ragged_attention_cuda(*args,
                                                       pad_cols=pad_cols))
    extra = {}
    if pad_cols:
        extra = {"pad_cols": True, "ms_pad_off": timer(
            lambda: PRA.paged_ragged_attention_cuda(*args))}
    plain_ms = timer(lambda: PRA.paged_ragged_attention_plain(*args), iters=3)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))

    elt = q.element_size()
    kv_bytes = sum(nbs) * bs * Hkv * D * 2 * elt   # live blocks, K and V
    io_bytes = 2 * q.numel() * elt + (bt.numel() + 2 * B) * 4
    # a real column j sees keys up to its position; a computed padding
    # column sees all of its row's keys
    flops = sum(4 * D * Hq * min(c - n + j + 1, c)
                for c, n in rows for j in range(C if pad_cols else n))
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return rates({"case": name, "dtype": str(dtype).replace("torch.", ""),
                  **extra,
                  "shape": {"q": list(q.shape), "pool": list(kp.shape),
                            "block_tables": list(bt.shape),
                            "ctx_lens": [c for c, _ in rows],
                            "q_lens": [n for _, n in rows]},
                  "tol": tol, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                 flops)


def host_us(torch, fn, calls=1000):
    """The host's µs per call of ``fn``: ``calls`` calls without a sync,
    timed on the host clock, then one sync (after a few warm-up calls)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def rmsnorm_case(torch, name, N, D, dtype, timer, tol, H=None, stride=None):
    """Rows [N, D] with scale [D]; with ``H``, grouped: x [N/H, H, D] with
    scale [H, D] (no single PyTorch call computes that); with ``stride``,
    the rows are the first D of rows of ``stride`` (MLA's kv latent, the
    first 512 of 576)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RMS
    gen = torch.Generator(device="cuda").manual_seed(N + D)
    x = torch.randn((N, stride or D), generator=gen, device="cuda") \
        .to(dtype)[:, :D]
    s = torch.randn((H or 1, D), generator=gen, device="cuda").to(dtype)
    if H:
        x = x.reshape(N // H, H, D)
    else:
        s = s[0]
    got = RMS.rmsnorm_cuda(x, s)
    torch.cuda.synchronize()
    want = RMS.rmsnorm_plain(x, s)
    err = compare(torch, f"rmsnorm {name} {dtype}", got, want, tol)
    ms = timer(lambda: RMS.rmsnorm_cuda(x, s))
    plain_ms = timer(lambda: RMS.rmsnorm_plain(x, s))
    library_ms = None if H else timer(
        lambda: F.rms_norm(x, (D,), weight=s, eps=1e-6))
    elt = x.element_size()
    bound_ms, bound_by = bound((2 * N * D + s.numel()) * elt, 4 * N * D,
                               torch.float32)
    return {"case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"x": list(x.shape), "scale": list(s.shape)}, "tol": tol,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "host_us": host_us(torch, lambda: RMS.rmsnorm_cuda(x, s))}


def rmsnorm_pair_case(torch, name, Nq, Nk, D, dtype, timer, tol):
    """A layer's q_norm and k_norm in one launch: q [Nq, D] and k [Nk, D],
    each with its own [D] scale. Must equal two single launches bitwise;
    timed beside them (``singles_ms``)."""
    from repro_torch.kernels import rmsnorm as RMS
    gen = torch.Generator(device="cuda").manual_seed(Nq + Nk + D)
    q = torch.randn((Nq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((Nk, D), generator=gen, device="cuda").to(dtype)
    sq = torch.randn((D,), generator=gen, device="cuda").to(dtype)
    sk = torch.randn((D,), generator=gen, device="cuda").to(dtype)
    before = RMS.launches
    got = RMS.rmsnorm_pair_cuda(q, sq, k, sk)
    torch.cuda.synchronize()
    check(RMS.launches == before + 1, f"rmsnorm pair {name}: "
          f"{RMS.launches - before} launches, want 1")
    singles = (RMS.rmsnorm_cuda(q, sq), RMS.rmsnorm_cuda(k, sk))
    check(all(torch.equal(a, b) for a, b in zip(got, singles)),
          f"rmsnorm pair {name} {dtype}: not bitwise equal to two launches")
    want = RMS.rmsnorm_pair_plain(q, sq, k, sk)
    err = max(compare(torch, f"rmsnorm pair {name} {dtype}", a, b, tol)
              for a, b in zip(got, want))
    pair = lambda: RMS.rmsnorm_pair_cuda(q, sq, k, sk)  # noqa: E731
    ms = timer(pair)
    singles_ms = timer(lambda: (RMS.rmsnorm_cuda(q, sq),
                                RMS.rmsnorm_cuda(k, sk)))
    plain_ms = timer(lambda: RMS.rmsnorm_pair_plain(q, sq, k, sk))
    elt = q.element_size()
    bound_ms, bound_by = bound((2 * (Nq + Nk) * D + 2 * D) * elt,
                               4 * (Nq + Nk) * D, torch.float32)
    return {"case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"q": [Nq, D], "k": [Nk, D], "scales": [[D], [D]]},
            "tol": tol, "max_abs_err": err, "bitwise_equal_to_singles": True,
            "ms": ms, "singles_ms": singles_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "host_us": host_us(torch, pair)}


def flash_case(torch, name, B, Sq, Skv, offsets, causal, dtype, timer, tol,
               Hq=32, Hkv=8, D=128):
    """q [B, Sq, Hq, D] against k, v that are per-layer views [B, Skv, Hkv,
    D] of one cache tensor, as the dense prefill hands them over."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    g = Hq // Hkv
    gen = torch.Generator(device="cuda").manual_seed(B * Sq + Skv)
    q = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda").to(dtype)
    cache = torch.randn((2, B, Skv, Hkv, D), generator=gen,
                        device="cuda").to(dtype)
    k, v = cache[0], cache[1]
    qo = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    got = FA.flash_attention_cuda(q, k, v, qo, causal=causal)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, qo, causal=causal)
    err = compare(torch, f"flash {name} {dtype}", got, want, tol)

    # yardstick: SDPA over K/V already expanded to Hq heads (not timed)
    qs = q.transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    qpos = qo.long()[:, None] + torch.arange(Sq, device="cuda")[None]
    if causal and not any(offsets) and Sq == Skv:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, is_causal=True)
    elif causal:
        mask = (torch.arange(Skv, device="cuda")[None, None]
                <= qpos[:, :, None])[:, None]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=mask)
    else:
        library = lambda: F.scaled_dot_product_attention(qs, ks, vs)  # noqa
    ms = timer(lambda: FA.flash_attention_cuda(q, k, v, qo, causal=causal))
    plain_ms = timer(lambda: FA.flash_attention_plain(q, k, v, qo,
                                                      causal=causal), iters=3)
    library_ms = timer(library)

    elt = q.element_size()
    if causal:      # keys each row's last query sees; per query its own
        live = [min(Skv, o + Sq) for o in offsets]
        pairs = sum(min(Skv, o + i + 1) for o in offsets for i in range(Sq))
    else:
        live = [Skv] * B
        pairs = B * Sq * Skv
    nbytes = (2 * q.numel() * elt + sum(live) * Hkv * D * 2 * elt + 4 * B)
    flops = pairs * Hq * 4 * D
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return rates({"case": name, "dtype": str(dtype).replace("torch.", ""),
                  "shape": {"q": list(q.shape), "kv": list(k.shape),
                            "q_offsets": list(offsets), "causal": causal},
                  "tol": tol, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}, flops)


def decode_case(torch, name, lens, S, dtype, timer, tol, Hq=32, Hkv=8,
                D=128):
    """q [B, Hkv, g, D] against a dense cache [B, S, Hkv, D] read in
    place, masked by lens; also the ragged kernel on the same K/V through
    a block table (``ragged_ms``), both timed in this run."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    B, g = len(lens), Hq // Hkv
    gen = torch.Generator(device="cuda").manual_seed(B * S)
    q = torch.randn((B, Hkv, g, D), generator=gen, device="cuda").to(dtype)
    cache = torch.randn((2, B, S, Hkv, D), generator=gen,
                        device="cuda").to(dtype)
    k, v = cache[0], cache[1]
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = DA.decode_attention_cuda(q, k, v, ln)
    torch.cuda.synchronize()
    want = DA.decode_attention_plain(q, k, v, ln)
    err = compare(torch, f"decode {name} {dtype}", got, want, tol)

    qs = q.reshape(B, Hq, 1, D)
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(S, device="cuda")[None] < ln.long()[:, None])
    mask = mask[:, None, None]
    # the ragged kernel (C == 1) on the same K/V, read as a pool of
    # contiguous blocks of 16 through a table: the same work through a table
    from repro_torch.kernels import paged_ragged_attention as PRA
    bs = 16
    nb = S // bs
    pools = [t.reshape(B * nb, bs, Hkv, D) for t in (k, v)]
    bt = (torch.arange(B * nb, dtype=torch.int32, device="cuda")
          .reshape(B, nb))
    q5 = q[:, :, :, None].contiguous()
    ones = torch.ones_like(ln)
    rag = PRA.paged_ragged_attention_cuda(q5, *pools, bt, ones, ln)
    torch.cuda.synchronize()
    rag_err = compare(torch, f"decode vs ragged {name} {dtype}", got,
                      rag[:, :, :, 0], tol)

    ms = timer(lambda: DA.decode_attention_cuda(q, k, v, ln))
    ragged_ms = timer(lambda: PRA.paged_ragged_attention_cuda(
        q5, *pools, bt, ones, ln))
    plain_ms = timer(lambda: DA.decode_attention_plain(q, k, v, ln), iters=3)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask))
    elt = q.element_size()
    nbytes = 2 * q.numel() * elt + sum(lens) * Hkv * D * 2 * elt + 4 * B
    flops = sum(lens) * Hq * 4 * D
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return rates({"case": name, "dtype": str(dtype).replace("torch.", ""),
                  "shape": {"q": list(q.shape), "kv": list(k.shape),
                            "lens": list(lens)},
                  "tol": tol, "max_abs_err": err, "ms": ms,
                  "ragged_ms": ragged_ms, "ragged_max_abs_diff": rag_err,
                  "ragged_bound_share": bound_ms / ragged_ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}, flops)


def paged_decode_case(torch, name, rows, dtype, timer, tol, Hq=32, Hkv=8,
                      D=128, bs=16):
    """The padded walk over the ragged decode case's own rows and table;
    also held against the ragged kernel at C == 1 on the same inputs
    (fp32 within 1e-5), and both timed, with the host's µs per call."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as PDA
    from repro_torch.kernels import paged_ragged_attention as PRA
    B, g = len(rows), Hq // Hkv
    ctx = [c for c, _ in rows]
    nbs = [-(-c // bs) for c in ctx]
    nmax, nblocks = max(nbs), sum(nbs) + 1
    gen = torch.Generator(device="cuda").manual_seed(B * 1000 + 1)
    perm = (torch.randperm(nblocks - 1, generator=gen, device="cuda") + 1).cpu()
    bt = torch.zeros((B, nmax), dtype=torch.int32)
    i = 0
    for b, nb in enumerate(nbs):
        bt[b, :nb] = perm[i:i + nb]
        i += nb
    q = torch.randn((B, Hkv, g, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((nblocks, bs, Hkv, D), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((nblocks, bs, Hkv, D), generator=gen,
                     device="cuda").to(dtype)
    bt, ln = bt.cuda(), torch.tensor(ctx, dtype=torch.int32, device="cuda")
    args = (q, kp, vp, bt, ln)
    got = PDA.paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    want = PDA.paged_decode_attention_plain(*args)
    err = compare(torch, f"paged decode {name} {dtype}", got, want, tol)
    q5 = q[:, :, :, None].contiguous()
    ones = torch.ones_like(ln)
    rag = PRA.paged_ragged_attention_cuda(q5, kp, vp, bt, ones, ln)
    torch.cuda.synchronize()
    rag_tol = 1e-5 if dtype == torch.float32 else tol
    rag_err = compare(torch, f"paged decode vs ragged {name} {dtype}", got,
                      rag[:, :, :, 0], rag_tol)

    kd = PRA._paged_gather(kp, bt).permute(0, 2, 1, 3)       # [B,Hkv,L,D]
    vd = PRA._paged_gather(vp, bt).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    qd = q.reshape(B, Hq, 1, D)
    mask = (torch.arange(kd.shape[2], device="cuda")[None]
            < ln.long()[:, None])[:, None, None]
    ms = timer(lambda: PDA.paged_decode_attention_cuda(*args))
    ragged_ms = timer(lambda: PRA.paged_ragged_attention_cuda(q5, kp, vp, bt,
                                                              ones, ln))
    plain_ms = timer(lambda: PDA.paged_decode_attention_plain(*args), iters=3)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    elt = q.element_size()
    nbytes = (2 * q.numel() * elt + sum(ctx) * Hkv * D * 2 * elt
              + (bt.numel() + B) * 4)
    flops = sum(ctx) * Hq * 4 * D
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return rates({"case": name, "dtype": str(dtype).replace("torch.", ""),
                  "shape": {"q": list(q.shape), "pool": list(kp.shape),
                            "block_tables": list(bt.shape), "lens": ctx},
                  "tol": tol, "max_abs_err": err,
                  "ragged_max_abs_diff": rag_err, "ms": ms,
                  "ragged_ms": ragged_ms,
                  "ragged_bound_share": bound_ms / ragged_ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "host_us": host_us(
                      torch, lambda: PDA.paged_decode_attention_cuda(*args))},
                 flops)


def ssd_chunk_case(torch, name, B, S, H, hd, ds, L, shared, dtype, timer,
                   tol=1e-4):
    """The SSD chunk step. Shared: x, b and c are views of one conv output
    [B, S, H*hd + 2*ds], as ``_ssd_scan`` hands them over (b and c with a
    head stride of 0). Per head: the TPU contract's copies, contiguous [B,
    S, H, *]. Both versions compute in fp32 from the same inputs and return
    fp32, so they agree within ``tol`` in either input type. No single
    PyTorch call computes this function: library_ms is None."""
    from repro_torch.kernels import ssd_scan as SSD
    gen = torch.Generator(device="cuda").manual_seed(B * S + H)
    if shared:
        xc = torch.randn((B, S, H * hd + 2 * ds), generator=gen,
                         device="cuda").to(dtype)
        x = xc[..., :H * hd].reshape(B, S, H, hd)
        b = xc[..., H * hd:H * hd + ds][:, :, None].expand(B, S, H, ds)
        c = xc[..., H * hd + ds:][:, :, None].expand(B, S, H, ds)
    else:
        x = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        b = torch.randn((B, S, H, ds), generator=gen, device="cuda").to(dtype)
        c = torch.randn((B, S, H, ds), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    A = torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    cum = (-dt * A).reshape(B, S // L, L, H).cumsum(2).reshape(B, S, H)
    args = (x, b, c, dt, cum, L)
    got = SSD.ssd_chunk_cuda(*args)
    torch.cuda.synchronize()
    want = SSD.ssd_chunk_plain(*args)
    err = max(compare(torch, f"ssd_chunk {name} {dtype} {part}", g, w, tol)
              for part, g, w in zip(("y", "state", "decay"), got, want))
    ms = timer(lambda: SSD.ssd_chunk_cuda(*args))
    plain_ms = timer(lambda: SSD.ssd_chunk_plain(*args), iters=3)
    nc, elt = S // L, x.element_size()
    bc_heads = 1 if shared else H
    nbytes = (x.numel() * elt + 2 * B * S * bc_heads * ds * elt   # x, b, c
              + 2 * B * S * H * 4                                 # dt, cum
              + B * S * H * (hd + 1) * 4 + B * nc * H * hd * ds * 4)
    tri = L * (L + 1) // 2                  # (t, s) pairs with s <= t
    fmas = B * nc * (bc_heads * tri * ds + H * (tri * hd + L * hd * ds))
    # the products' operations at the peak of the inputs' type (bf16 on
    # the tensor cores, fp32 on the CUDA cores); beside it the bound
    # against the fp32 peak, as stated before the tensor-core instance
    bound_ms, bound_by = bound(nbytes, 2 * fmas, dtype)
    fp32_peak_ms, _ = bound(nbytes, 2 * fmas, torch.float32)
    return {"case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"x": list(x.shape), "bc": [B, S, bc_heads, ds],
                      "chunk": L, "bc_shared": shared},
            "tol": tol, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "bound_at_fp32_peak_ms": fp32_peak_ms}


def kernel_phase(torch):
    timer = Timer(torch)
    # what the timer gives a kernel that does nothing: the floor under every
    # small case below (launch and event latency after the L2 flush)
    print(f"timer floor: an empty kernel (torch.cuda._sleep(0)) measures "
          f"{timer(lambda: torch.cuda._sleep(0), iters=30)} ms")
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    # a mixed batch (C = 64 prefill chunks, one partial, and decode rows)
    # and a pure-decode batch, contexts up to 2048
    mixed = [(64, 64), (2048, 64), (576, 64), (1000, 40),
             (2048, 1), (1024, 1), (17, 1), (1, 1)]
    # speculative verify rows (1 + a draft of up to 4) at decode rows'
    # contexts, in the engine's C = 8 bucket: the tile path, not the C == 1
    # decode split
    verify = [(2048, 5), (1536, 4), (1024, 3), (777, 2), (512, 5), (256, 1),
              (100, 4), (49, 2)]
    # the mixed_prefix_spec path's second step: five prefill rows past a
    # 48-token cached prefix (C = 32) beside the first request's decode row
    prefix_hit = [(52, 1), (54, 6), (57, 9), (60, 12), (63, 15), (66, 18)]
    # the serving chunk against a dense cache of 2048: 8 rows of C = 64 at
    # offsets spread over [0, 1984], the last at the dummy offset s_max - C
    chunk_offsets = [0, 256, 576, 832, 1088, 1344, 1664, 1984]
    cases = {k: [] for k in ("paged_ragged_attention", "rmsnorm",
                             "flash_attention", "decode_attention",
                             "paged_decode_attention", "ssd_chunk")}

    def add(kernel, case):
        cases[kernel].append(case)
        print(kernel, json.dumps(case))

    for dtype in (torch.bfloat16, torch.float32):
        tol = tols[dtype]
        for name, rows in (("mixed", mixed), ("decode", DECODE_ROWS)):
            add("paged_ragged_attention",
                attention_case(torch, name, rows, dtype, timer, tol))
        add("paged_ragged_attention", attention_case(
            torch, "verify, C 8", verify, dtype, timer, tol, C=8))
        add("paged_ragged_attention", attention_case(
            torch, "prefix-hit prefill, C 32", prefix_hit, dtype, timer, tol,
            C=32))
        if dtype == torch.bfloat16:
            # long prefill chunks: the tensor-core tiles at a larger width
            add("paged_ragged_attention", attention_case(
                torch, "long prefill", [(2048, 256)] * 2, dtype, timer, tol))
        # one rank of the layout phase's grid (G = 4): 8 q heads and 2 kv
        # heads, a 4x smaller grid, which plans its own cluster split
        for name, rows in (("mixed, per rank", mixed),
                           ("decode, per rank", DECODE_ROWS)):
            add("paged_ragged_attention", attention_case(
                torch, name, rows, dtype, timer, tol, Hq=32 // 4, Hkv=8 // 4))
        # N = 512: the first serving step's padded token rectangle (8 rows
        # x 64 columns); q_norm/k_norm run over N x 32 (x 8) head rows of
        # 128. A decode step: 8 rows, 256 q and 64 k head rows; mamba2's
        # d_model 2048 and its grouped norm over 64 heads of 64.
        for name, N, D, H in (("hidden", 512, 4096, None),
                              ("heads", 512 * 32, 128, None),
                              ("grouped", 8 * 64 * 64, 64, 64),
                              ("decode hidden", 8, 4096, None),
                              ("decode q heads", 8 * 32, 128, None),
                              ("decode k heads", 8 * 8, 128, None),
                              ("mamba2 decode hidden", 8, 2048, None),
                              ("mamba2 decode grouped", 8 * 64, 64, 64)):
            add("rmsnorm", rmsnorm_case(torch, name, N, D, dtype, timer, tol,
                                        H=H))
        for name, T in (("pair, prefill", 512), ("pair, decode", 8)):
            add("rmsnorm", rmsnorm_pair_case(torch, name, T * 32, T * 8, 128,
                                             dtype, timer, tol))
        # one rank of the layout phase's grid: the pair over 8 q and 2 k
        # heads per token (the first step's 512 tokens, after the
        # exchange; a decode step's 8), ln1/ln2 over its 256 columns
        for name, T in (("pair, prefill, per rank", 512),
                        ("pair, decode, per rank", 8)):
            add("rmsnorm", rmsnorm_pair_case(torch, name, T * 8, T * 2, 128,
                                             dtype, timer, tol))
        add("rmsnorm", rmsnorm_case(torch, "hidden, per sp rank", 256, 4096,
                                    dtype, timer, tol))
        # mamba2-1.3b's grouped norm at a rank's heads after the exchange:
        # 16 of its 64 heads on G 4, 8 on G 8; a prefill step's 512 rows
        # (8 x 64) and a decode step's 8
        for hpr in (16, 8):
            for what, rows in (("prefill", 512), ("decode", 8)):
                add("rmsnorm", rmsnorm_case(
                    torch, f"mamba2 grouped, {what}, per rank (G "
                    f"{64 // hpr})", rows * hpr, 64, dtype, timer, tol,
                    H=hpr))
        # qwen-32b (64 q heads over 8 kv heads, d_model 5120): the ragged
        # kernel's mixed and decode batches at group 8 (g·C = 8 rows per
        # (sequence, kv head) in a decode step), the hidden norms of its
        # first serving step and of a decode step (fp32: 8 chunks a lane
        # on 256 lanes), and the q/k pair over 64 + 8 heads
        for name, rows in (("qwen-32b mixed", mixed),
                           ("qwen-32b decode", DECODE_ROWS)):
            add("paged_ragged_attention", attention_case(
                torch, name, rows, dtype, timer, tol, Hq=64, Hkv=8))
        # qwen-30b-a3b (32 q heads over 4 kv heads, d_model 2048): decode
        # rows beside a 64-column prefill row, every padding column
        # computed (the MoE instance), timed with the option on and off;
        # RMSNorm over its rows of 2048 and the q/k pair over 32 + 4 heads
        add("paged_ragged_attention", attention_case(
            torch, "qwen-30b-a3b mixed, padding columns", MOE_MIXED, dtype,
            timer, tol, Hq=32, Hkv=4, C=64, pad_cols=True))
        for name, N in (("qwen-30b-a3b hidden", 512),
                        ("qwen-30b-a3b decode hidden", 8)):
            add("rmsnorm", rmsnorm_case(torch, name, N, 2048, dtype, timer,
                                        tol))
        for name, T in (("qwen-30b-a3b pair, prefill", 512),
                        ("qwen-30b-a3b pair, decode", 8)):
            add("rmsnorm", rmsnorm_pair_case(torch, name, T * 32, T * 4, 128,
                                             dtype, timer, tol))
        for name, N in (("qwen-32b hidden", 512),
                        ("qwen-32b decode hidden", 8)):
            add("rmsnorm", rmsnorm_case(torch, name, N, 5120, dtype, timer,
                                        tol))
        for name, T in (("qwen-32b pair, prefill", 512),
                        ("qwen-32b pair, decode", 8)):
            add("rmsnorm", rmsnorm_pair_case(torch, name, T * 64, T * 8, 128,
                                             dtype, timer, tol))
        # deepseek-v3-671b: d_model 7168 (ln1, ln2, the final norm; fp32
        # takes 8 chunks a lane), MLA's q latent norm over 1536 and its kv
        # latent norm over the first 512 of the latent's 576 (rows strided),
        # at a prefill step's 512 rows (8 x 64) and a decode step's 8
        for name, N, D, stride in (
                ("deepseek hidden", 512, 7168, None),
                ("deepseek decode hidden", 8, 7168, None),
                ("deepseek q latent", 512, 1536, None),
                ("deepseek kv latent, strided", 512, 512, 576),
                ("deepseek decode q latent", 8, 1536, None),
                ("deepseek decode kv latent, strided", 8, 512, 576)):
            add("rmsnorm", rmsnorm_case(torch, name, N, D, dtype, timer, tol,
                                        stride=stride))
        # mamba2-1.3b (64 heads of 64, d_state 128, chunk 64): the serving
        # prefill step (8 rows of 64), a long prompt (32 chunks), a short
        # chunk (S < 64), and the serving step as the TPU contract's
        # per-(head, chunk) copies (no c.b^T shared across heads)
        for name, B, S, H, L, shared in (
                ("serving step", 8, 64, 64, 64, True),
                ("long prompt", 1, 2048, 64, 64, True),
                ("short chunk", 8, 19, 64, 19, True),
                ("TPU contract copies", 8 * 64, 64, 1, 64, False),
                # a rank's heads after the exchange: 16 on G 4, 8 on G 8
                ("serving step, per rank (G 4)", 8, 64, 16, 64, True),
                ("serving step, per rank (G 8)", 8, 64, 8, 64, True)):
            add("ssd_chunk", ssd_chunk_case(torch, name, B, S, H, 64, 128, L,
                                            shared, dtype, timer))
        add("flash_attention", flash_case(
            torch, "serving chunk", 8, 64, 2048, chunk_offsets, True, dtype,
            timer, tol))
        # one rank of the (2, 2) grid: the whole chunk after the exchange at
        # its 8 q and 2 kv heads, over a dense cache of the serve default's
        # s_max 256 (rows at offsets up to the dummy offset s_max - C) and
        # of 2048
        add("flash_attention", flash_case(
            torch, "serving chunk, per rank, s_max 256", 8, 64, 256,
            [0, 32, 64, 96, 128, 160, 192, 192], True, dtype, timer, tol,
            Hq=8, Hkv=2))
        add("flash_attention", flash_case(
            torch, "serving chunk, per rank, s_max 2048", 8, 64, 2048,
            chunk_offsets, True, dtype, timer, tol, Hq=8, Hkv=2))
        add("flash_attention", flash_case(
            torch, "TPU contract", 1, 2048, 2048, [0], True, dtype, timer,
            tol))
        add("flash_attention", flash_case(
            torch, "non-causal", 2, 128, 256, [0, 0], False, dtype, timer,
            tol, Hq=8, Hkv=2, D=64))
        if dtype == torch.bfloat16:
            add("flash_attention", flash_case(
                torch, "serving chunk C 256", 8, 256, 2048,
                [0, 256, 512, 768, 1024, 1280, 1536, 1792], True, dtype,
                timer, tol))
        add("decode_attention", decode_case(
            torch, "decode", [c for c, _ in DECODE_ROWS], 2048, dtype, timer,
            tol))
        # one sequence of 2048: 8 (sequence, kv head) pairs for 132 SMs
        add("decode_attention", decode_case(
            torch, "B 1", [2048], 2048, dtype, timer, tol))
        # one rank of the (2, 2) grid: its dp row's 8 rows after the
        # exchange, at its 8 q and 2 kv heads
        add("decode_attention", decode_case(
            torch, "decode, per rank", [c for c, _ in DECODE_ROWS], 2048,
            dtype, timer, tol, Hq=8, Hkv=2))
        add("paged_decode_attention", paged_decode_case(
            torch, "decode", DECODE_ROWS, dtype, timer, tol))
        # whisper-small (12 heads over 12 KV heads, group 1, D 64) at its
        # serving shapes: the encoder's non-causal flash over 8 slots x
        # 1536 frames, the cross prefill of a 64-token chunk against them,
        # the decoder's causal chunk against its cache of s_max 256, and
        # decode over every row's 1536 frames (cross) and its s_max 256
        # (self)
        wkw = dict(Hq=12, Hkv=12, D=64)
        add("flash_attention", flash_case(
            torch, "whisper encoder", 8, 1536, 1536, [0] * 8, False, dtype,
            timer, tol, **wkw))
        add("flash_attention", flash_case(
            torch, "whisper cross prefill", 8, 64, 1536, [0] * 8, False,
            dtype, timer, tol, **wkw))
        add("flash_attention", flash_case(
            torch, "whisper decoder chunk, s_max 256", 8, 64, 256,
            [0, 32, 64, 96, 128, 160, 192, 192], True, dtype, timer, tol,
            **wkw))
        add("decode_attention", decode_case(
            torch, "whisper cross", [1536] * 8, 1536, dtype, timer, tol,
            **wkw))
        add("decode_attention", decode_case(
            torch, "whisper self, s_max 256", WHISPER_SELF_LENS, 256, dtype,
            timer, tol, **wkw))
        # internvl2-2b (16 q heads over 8 KV heads, group 2, D 128): the
        # ragged kernel's mixed and decode batches
        for name, rows in (("internvl2-2b mixed", mixed),
                           ("internvl2-2b decode", DECODE_ROWS)):
            add("paged_ragged_attention", attention_case(
                torch, name, rows, dtype, timer, tol, Hq=16, Hkv=8))
        torch.cuda.synchronize()
    return cases


# ---------------------------------------------------------------------------
# phase 4: the reduced engine on the card against the same on the CPU
# ---------------------------------------------------------------------------
def cross_device_phase(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch.serve import workload
    from repro_torch.models import Model
    cfg = get_config("qwen3-8b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device="cuda", dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())

    tight = {"num_blocks": 9, "block_size": 8}
    for kw in ({}, tight, {"mixed": False}, {"mixed": False, **tight},
               {"paged": False, "mixed": False}):
        runs = []
        for model in (gpu, cpu):
            eng = ShiftEngine(model, EngineConfig(**kw))
            reqs = workload(6, 16)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            runs.append(([r.generated for r in reqs], eng.config_counts,
                         eng.preemptions,
                         eng.kv.num_free_blocks if eng.paged else None,
                         timeless(eng.obs.dump())))
        check(runs[0][:4] == runs[1][:4], f"reduced engine "
              f"{kw or 'no pressure'}: cuda {runs[0][:4]} != cpu "
              f"{runs[1][:4]}")
        check(runs[0][4] == runs[1][4], f"reduced engine "
              f"{kw or 'no pressure'}: the cuda and cpu obs dumps differ "
              "(time fields dropped)")
        print(f"reduced engine {kw or 'no pressure'}: cuda == cpu (streams, "
              f"obs dumps less time fields), configs {runs[0][1]}, "
              f"{runs[0][2]} preemptions, {len(runs[0][4]['events'])} "
              "events")

    # one mixed step's logits: a prefill row, a decode row, a padding row
    # and a chunk whose padding overhangs the table
    bt = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 0]], np.int32)
    rng = np.random.default_rng(1)
    err = 0.0
    for model in (gpu, cpu):
        model.init_paged_cache(9, 4)
    for ql, off in (([8, 6, 0, 0], [0, 0, 0, 0]), ([1, 4, 0, 5], [8, 6, 0, 0])):
        toks = rng.integers(1, cfg.vocab_size, (4, 8)).astype(np.int32)
        lg = [m.forward_mixed(toks, ql, off, bt, sample=False)[0].cpu()
              for m in (gpu, cpu)]
        err = max(err, (lg[0] - lg[1]).abs().max().item())
        check(torch.allclose(lg[0], lg[1], atol=1e-4, rtol=1e-4),
              f"reduced logits cuda vs cpu: max abs err {err}")
    torch.cuda.synchronize()
    print(f"reduced mixed-step logits cuda vs cpu: max abs err {err} "
          "(tol 1e-4)")

    # one dense prefill (rows at offsets 0 and 5, a dummy row at
    # s_max - C) and two decode steps' logits
    err = 0.0
    for model in (gpu, cpu):
        model.init_cache(3, 32)
    toks = rng.integers(1, cfg.vocab_size, (3, 8)).astype(np.int32)
    lg = [m.prefill(toks, [0, 5, 24])[0].cpu() for m in (gpu, cpu)]
    steps = [lg]
    for lens in ([8, 13, 0], [9, 14, 0]):
        tok = lg[1].argmax(-1).int().numpy() * (np.array(lens) > 0)
        lg = [m.decode(tok, lens, sample=False)[0].cpu() for m in (gpu, cpu)]
        steps.append(lg)
    for a, b in steps:
        err = max(err, (a - b).abs().max().item())
        check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
              f"reduced dense logits cuda vs cpu: max abs err {err}")
    print(f"reduced dense prefill + decode logits cuda vs cpu: max abs err "
          f"{err} (tol 1e-4)")
    prefix_spec_cross_device(torch, gpu, cpu)
    fault_cross_device(torch, gpu, cpu)
    adaptive_cross_device(torch, gpu, cpu)
    mamba2_cross_device(torch)
    moe_cross_device(torch)


def pad_sensitive_prompts(seed=0):
    """Ten random prompts of 2-39 tokens: with chunk 16 most steps carry
    padding columns, which a MoE model routes (at capacity factor 1.25,
    zeroing them changes 7 of qwen-30b-a3b's 100 tokens on the CPU)."""
    import random
    rnd = random.Random(seed)
    return [[rnd.randrange(1, 250) for _ in range(rnd.randrange(2, 40))]
            for _ in range(10)]


def moe_cross_device(torch):
    """Reduced qwen-30b-a3b and llama4-17b-16e in fp32 at capacity factor
    1.25 on the pad-sensitive workload (8 slots, s_max 128, chunk 16, 10
    new tokens): the mixed paged, serialized paged and dense engines give
    the same streams and config counts on the card (kernels; the ragged
    kernel computes the padding columns) as on the CPU (plain versions),
    and the card's paged runs launch the ragged kernel once per layer and
    step."""
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, Request, ShiftEngine
    from repro_torch.kernels import paged_ragged_attention as PRA
    from repro_torch.models import Model
    for arch in ("qwen-30b-a3b", "llama4-17b-16e"):
        cfg = get_config(arch).reduced()
        check(cfg.moe.capacity_factor == 1.25, f"{arch}: {cfg.moe}")
        cpu = Model(cfg, device="cpu", dtype=torch.float32)
        cpu.init_params(torch.Generator().manual_seed(0))
        gpu = Model(cfg, device="cuda", dtype=torch.float32)
        gpu.load_params(cpu.params.state_dict())
        for kw in ({}, {"mixed": False}, {"paged": False, "mixed": False}):
            runs = []
            for model in (gpu, cpu):
                PRA.launches = 0
                eng = ShiftEngine(model, EngineConfig(
                    max_slots=8, s_max=128, prefill_chunk=16, **kw))
                reqs = [Request(i, p, max_new_tokens=10)
                        for i, p in enumerate(pad_sensitive_prompts())]
                for r in reqs:
                    eng.submit(r)
                eng.run_until_idle()
                runs.append(([r.generated for r in reqs], eng.config_counts,
                             PRA.launches))
            label = f"reduced {arch} cf 1.25 {kw or 'mixed'}"
            check(runs[0][:2] == runs[1][:2],
                  f"{label}: cuda {runs[0][:2]} != cpu {runs[1][:2]}")
            steps = sum(runs[0][1].values())
            ragged = steps * cfg.num_layers if kw.get("paged", True) else 0
            check(runs[0][2] == ragged,
                  f"{label}: {runs[0][2]} ragged launches, want {ragged}")
            print(f"{label}: cuda == cpu (10 streams of 10 tokens, "
                  f"{steps} steps, {runs[0][2]} ragged launches)")


def adaptive_cross_device(torch, gpu, cpu):
    """The mixed engine under ``--adaptive``'s policy (``serve.
    adaptive_policy``: the cost model at the H100's numbers over (2, 2)) on
    reduced qwen3-8b at fp32, on the card and on the CPU: equal streams,
    per-step configs (both used) and observability dumps less their time
    fields."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch.serve import adaptive_policy, workload
    runs = []
    for model in (gpu, cpu):
        eng = ShiftEngine(model, EngineConfig(),
                          policy=adaptive_policy(model.cfg))
        reqs = workload(6, 16)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        runs.append(([r.generated for r in reqs], eng.config_counts,
                     [rec["config"] for rec in eng.step_log],
                     timeless(eng.obs.dump())))
    check(runs[0][:3] == runs[1][:3], f"reduced engine, adaptive policy: "
          f"cuda {runs[0][:3]} != cpu {runs[1][:3]}")
    check(runs[0][3] == runs[1][3], "reduced engine, adaptive policy: the "
          "cuda and cpu obs dumps differ (time fields dropped)")
    counts = runs[0][1]
    check(counts["base"] > 0 and counts["shift"] > 0,
          f"reduced engine, adaptive policy: configs {counts}")
    print(f"reduced engine, adaptive policy: cuda == cpu (streams, per-step "
          f"configs, obs dumps less time fields), configs {counts}")


def prefix_spec_cross_device(torch, gpu, cpu):
    """The prefix cache and speculation on reduced qwen3-8b at fp32: the
    mixed engine with ``PrefixConfig(enabled=True)`` and ``SpecConfig(k=4)``
    on the workload after a 16-token shared prefix, with and without pool
    pressure, on the card and on the CPU: equal streams, cached tokens,
    prefix stats, spec counts, preemptions and config counts. Then the
    fork + COW case on both devices: a 12-token sequence forked, its
    half-full tail block copied in place for the fork (the copy equal to
    its source bitwise, the pool's addresses kept), and three decode steps
    of different continuations on both rows, with equal streams."""
    import numpy as np
    from repro_torch.cache import PagedKVCache
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.launch.serve import workload
    from repro_torch.spec import SpecConfig
    for kw in ({}, {"num_blocks": 13, "block_size": 8}):
        runs = []
        for model in (gpu, cpu):
            eng = ShiftEngine(model, EngineConfig(
                prefix=PrefixConfig(enabled=True), spec=SpecConfig(k=4), **kw))
            reqs = workload(6, 16, shared_prefix=16)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            led = eng.block_accounting()
            check(led.used == led.pinned == eng.prefix_stats.entries,
                  f"reduced prefix + spec {kw}: blocks held at exit {led}")
            runs.append(([r.generated for r in reqs],
                         [r.cached_tokens for r in reqs],
                         eng.prefix_stats.as_dict(),
                         spec_counts(eng), eng.preemptions,
                         eng.config_counts))
        check(runs[0] == runs[1], f"reduced prefix + spec {kw}: cuda "
              f"{runs[0][1:]} != cpu {runs[1][1:]}")
        _, cached, stats, spec, pre, counts = runs[0]
        check(stats["hits"] > 0 and spec[0] > 0,
              f"reduced prefix + spec {kw}: no hit or no draft")
        print(f"reduced prefix + spec engine {kw or 'no pressure'}: cuda == "
              f"cpu; cached tokens {cached}; prefix {stats}; drafted "
              f"{spec[0]}, accepted {spec[1]}, rollback blocks {spec[2]}; "
              f"{pre} preemptions; configs {counts}")

    prompt = np.random.default_rng(1).integers(
        1, gpu.cfg.vocab_size, 12).tolist()
    streams = []
    for model in (gpu, cpu):
        model.init_paged_cache(8, 8)
        kv = PagedKVCache(8, 8, 2, 4)
        kv.ensure(0, 12)
        bt = np.zeros((2, 4), np.int32)
        bt[0, :2] = kv.seq_blocks(0)
        toks = np.zeros((2, 12), np.int32)
        toks[0] = prompt
        model.prefill(toks, [0, 0], bt)
        kv.fork(0, 1)
        ok, copies = kv.copy_on_write(1, 12, 13)
        check(ok and len(copies) == 1, f"fork + COW: copies {copies}")
        (src, dst), = copies
        addr = model.pool.k.data_ptr()
        model.copy_blocks([src], [dst])
        check(model.pool.k.data_ptr() == addr and all(
            torch.equal(p[:, dst], p[:, src])
            for p in (model.pool.k, model.pool.v)),
            f"fork + COW on {model.device}: the copy is not in place or "
            "differs from its source")
        bt[1, :2] = kv.seq_blocks(1)
        t, lens, out = np.array([7, 11], np.int32), np.array([12, 12]), []
        for _ in range(3):
            t, _ = model.decode(t, lens, bt)
            t = t.cpu().numpy().astype(np.int32)
            out.append(t.tolist())
            lens = lens + 1
        streams.append(out)
    check(streams[0] == streams[1],
          f"fork + COW: cuda {streams[0]} != cpu {streams[1]}")
    print(f"reduced fork + COW (12 tokens, the tail block copied in place): "
          f"cuda == cpu, decode steps of both rows {streams[0]}")


# the reduced fault run's plan: (step, seam, kind); an alloc fault, both
# kinds of forward fault and a route fault on the serve workload
FAULT_PLAN = [(0, "alloc", ""), (3, "forward", "nan"),
              (6, "forward", "raise"), (9, "route", "")]


def fault_cross_device(torch, gpu, cpu):
    """The mixed paged engine on reduced qwen3-8b at fp32 under
    ``FAULT_PLAN`` with ``quarantine_after`` 10 (every request ends OK), on
    the card and on the CPU, beside a clean run on each: the faulted
    streams equal the clean ones on both devices and the card's equal the
    CPU's, with equal outcomes, fail counts, failed steps, retries,
    preemptions, block ledgers and observability dumps (less their time
    fields); two steps failed, every block is free at exit."""
    from repro_torch.engine import EngineConfig, FaultConfig, ShiftEngine
    from repro_torch.ft import Fault, FaultPlan
    from repro_torch.launch.serve import workload
    runs = []
    for model in (gpu, cpu):
        streams = []
        for plan in (None, FaultPlan([Fault(step, seam, kind=kind)
                                      for step, seam, kind in FAULT_PLAN])):
            eng = ShiftEngine(model, EngineConfig(
                fault=FaultConfig(quarantine_after=10)), faults=plan)
            reqs = workload(6, 16)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            streams.append([r.generated for r in reqs])
        reg = eng.obs.registry
        runs.append((streams, [str(r.finish_reason) for r in reqs],
                     [r.fail_count for r in reqs],
                     {name: int(reg.counter_total(name)) for name in (
                         "faults_injected_total", "failed_steps_total",
                         "retries_total")},
                     eng.preemptions, eng.block_accounting().as_dict(),
                     eng.kv.num_blocks, timeless(eng.obs.dump())))
    check(runs[0][:7] == runs[1][:7], f"reduced fault run: cuda "
          f"{runs[0][1:7]} != cpu {runs[1][1:7]}")
    check(runs[0][7] == runs[1][7], "reduced fault run: the cuda and cpu "
          "obs dumps differ (time fields dropped)")
    (clean, faulted), reasons, fails, counters, pre, led, nb, _ = runs[0]
    check(faulted == clean and set(reasons) == {"ok"},
          f"reduced fault run: faulted streams differ from the clean ones "
          f"or a request failed: {reasons}")
    check(counters["faults_injected_total"] == len(FAULT_PLAN)
          and counters["failed_steps_total"] == 2
          and counters["retries_total"] > 0 and pre > 0,
          f"reduced fault run: counters {counters}, {pre} preemptions")
    check(led["used"] == led["pinned"] == 0 and led["free"] == nb - 1,
          f"reduced fault run: blocks held at exit {led}")
    print(f"reduced fault run {FAULT_PLAN}: cuda == cpu == the clean run "
          f"(streams), equal obs dumps less time fields; fail counts "
          f"{fails}; {counters}; {pre} preemptions; ledger {led}")


def mamba2_cross_device(torch):
    """Reduced mamba2 at fp32 through the dense serialized fallback: one
    request alone, two in flight on two slots (each step's dummy rows
    advance the idle slot's SSD state, as in the reference), and the
    workload's 6 requests on 4 slots; then one dense prefill + decode's
    logits (tol 1e-4, fp32 on both sides)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, Request, ShiftEngine
    from repro_torch.launch.serve import workload
    from repro_torch.models import Model
    cfg = get_config("mamba2-1.3b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device="cuda", dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    a, b = list(range(3, 14)), list(range(40, 60))
    for label, slots, prompts in (("one request", 1, [a]),
                                  ("two in flight", 2, [a, b]),
                                  ("6 requests on 4 slots", 4, None)):
        runs = []
        for model in (gpu, cpu):
            eng = ShiftEngine(model, EngineConfig(max_slots=slots, s_max=64,
                                                  prefill_chunk=8))
            check(not eng.paged and not eng.mixed,
                  "mamba2 must fall back to the dense serialized engine")
            reqs = (workload(6, 8) if prompts is None else
                    [Request(i, p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            runs.append(([r.generated for r in reqs], eng.config_counts))
        check(runs[0] == runs[1], f"reduced mamba2 {label}: cuda {runs[0]} "
              f"!= cpu {runs[1]}")
        print(f"reduced mamba2 dense engine, {label}: cuda == cpu, configs "
              f"{runs[0][1]}, streams {runs[0][0][:2]}")
    err = 0.0
    for model in (gpu, cpu):
        model.init_cache(3, 32)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (3, 16)).astype(np.int32)
    lg = [m.prefill(toks, [0, 0, 16])[0].cpu() for m in (gpu, cpu)]
    steps = [lg]
    for lens in ([16, 16, 0], [17, 17, 0]):
        tok = lg[1].argmax(-1).int().numpy() * (np.array(lens) > 0)
        lg = [m.decode(tok, lens, sample=False)[0].cpu() for m in (gpu, cpu)]
        steps.append(lg)
    for g, c in steps:
        err = max(err, (g - c).abs().max().item())
        check(torch.allclose(g, c, atol=1e-4, rtol=1e-4),
              f"reduced mamba2 logits cuda vs cpu: max abs err {err}")
    print(f"reduced mamba2 dense prefill (2 SSD chunks) + decode logits cuda "
          f"vs cpu: max abs err {err} (tol 1e-4)")


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------
def delta(after, before):
    """``after`` less ``before``, key by key (registry totals read before
    and after a measured run)."""
    return {k: after[k] - before.get(k, 0) for k in after}


def spec_counts(eng):
    """Draft tokens verified, accepted and blocks rolled back: the
    engine's registry totals."""
    reg = eng.obs.registry
    return tuple(int(reg.counter_total(name)) for name in (
        "spec_proposed_total", "spec_accepted_total",
        "spec_rollback_blocks_total"))


def fresh_obs(eng, enabled=True):
    """Give ``eng`` a new, empty observability surface (``NullObs`` when
    not ``enabled``), so that a dump covers the run after this call."""
    from repro_torch.obs import NullObs, Observability
    eng.obs = (Observability("engine", window=eng.cfg.obs.window,
                             now=eng.now, event_cap=eng.cfg.obs.event_cap)
               if enabled else NullObs(now=eng.now))
    return eng.obs


def timeless(dump):
    """``dump`` without what reads the wall clock: the records' and
    events' time fields (``ts``, ``t_start``, ``dur_s``, ``arrival`` and
    every ``*_s`` attribute), the sums and buckets of the ``*_seconds``
    histograms, and the watchdog's ``straggler`` events and counter (it
    flags by wall time); the events keep their order, not their ``seq``."""
    def keep(k):
        return k not in ("ts", "t_start", "dur_s", "arrival", "seq") \
            and not k.endswith("_s")

    m = dump["metrics"]
    return {
        "source": dump["source"], "events_dropped": dump["events_dropped"],
        "steps": [{k: v for k, v in r.items() if keep(k)}
                  for r in dump["steps"]],
        "events": [{k: v for k, v in e.items() if keep(k)}
                   for e in dump["events"] if e["kind"] != "straggler"],
        "metrics": {
            "counters": [c for c in m["counters"]
                         if c["name"] != "straggler_steps_total"],
            "gauges": m["gauges"],
            "histograms": [dict(h, sum=None, buckets=None)
                           if h["name"].endswith("_seconds") else h
                           for h in m["histograms"]]}}


def count_steps(eng):
    """Count the engine's productive steps of each kind from here on:
    {"mixed": n, "prefill": n, "decode": n}."""
    kinds = {"mixed": 0, "prefill": 0, "decode": 0}

    def counted(kind, run):
        def wrapper():
            did = run()
            kinds[kind] += int(did)
            return did
        return wrapper

    for kind in kinds:
        name = f"_run_{kind}"
        setattr(eng, name, counted(kind, getattr(eng, name)))
    return kinds


def step_launches(eng, kind):
    """Each kernel's launches in one full-width engine step of ``kind``
    ("mixed", "prefill" or "decode"): ln1, ln2 and the q_norm + k_norm pair
    (one launch) per attention or MoE layer, ln1 and the grouped norm per SSD
    layer, and the final norm; one attention per attention layer, by the
    kernel of the step's kind and cache; one SSD chunk launch per SSD layer
    in a prefill step, none in a decode step; ln1 and ln2 per layer of
    recurrentgemma's RG-LRU and local layers and nothing else; whisper's
    flash launches (encoder, self and cross attention) in a prefill step and
    decode launches (self and cross) in a decode step, and no RMSNorm."""
    kinds = eng.mcfg.layer_kinds
    if {"rglru", "local"} & set(kinds):
        # ln1 and ln2 of every layer and the final norm; the ring
        # attention and the RG-LRU block are plain
        return {"rmsnorm": 2 * len(kinds) + 1}
    if "dec" in kinds:
        # whisper: LayerNorm is plain; a prefill step's flash launches are
        # the encoder layers' and each decoder layer's self and cross
        # attention, a decode step's decode launches its self and cross
        if kind == "decode":
            return {"decode_attention": 2 * len(kinds)}
        return {"flash_attention": eng.mcfg.encoder_layers + 2 * len(kinds)}
    n_ssd = kinds.count("ssd")
    n_attn = len(kinds) - n_ssd                 # attention and MoE layers
    attention = ("paged_ragged_attention" if eng.paged else
                 "flash_attention" if kind == "prefill" else
                 "decode_attention")
    if eng.mcfg.mla is not None:
        # ln1, ln2 and MLA's q and kv latent norms; the attention is plain
        return {"rmsnorm": 4 * n_attn + 1}
    # ln1 and ln2, and the q/k pair where the config norms q and k
    per_attn = 3 if eng.mcfg.qk_norm else 2
    out = {"rmsnorm": per_attn * n_attn + 2 * n_ssd + 1}
    if n_attn:
        out[attention] = n_attn
    if n_ssd and kind != "decode":
        out["ssd_chunk"] = n_ssd
    return out


def port_kernel(name):
    """The port kernel whose launch counter a kernel name in the profiler's
    trace belongs to, or None for any other kernel."""
    for part, kernel in (("paged_ragged_attention", "paged_ragged_attention"),
                         ("flash_attention", "flash_attention"),
                         ("rmsnorm_kernel", "rmsnorm"),
                         ("ssd_chunk", "ssd_chunk")):
        if part in name:
            return kernel
    if "decode_attention" in name:
        # one source, templated on how a key is addressed
        return ("paged_decode_attention" if "PagedKeys" in name
                else "decode_attention")
    return None


def serve_path(torch, eng, label, workload=None):
    """The main path through ``eng``: a warm-up run of the workload (cuBLAS's
    caches, the kernels' first launches), then the measured run with every launch counter
    set to 0 just before it and read just after. Checks the requests and
    the counters against the per-step counts; returns the requests.
    ``workload(n, max_new)`` makes the requests (the serve CLI's by
    default)."""
    from repro_torch.launch import serve
    workload = workload or serve.workload
    cfg = eng.mcfg
    for r in workload(6, 16):
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    counts0 = dict(eng.config_counts)
    kinds = count_steps(eng)
    reqs = workload(6, 16)
    captured = eng.deploy.captures
    first_step = eng.step_count
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = serve.launch_counts()
    counts = delta(eng.config_counts, counts0)
    steps = sum(counts.values())
    # the warm-up run stepped through every bucket of the workload, so the
    # measured run only replays
    check(eng.deploy.captures == captured,
          f"{label}: {eng.deploy.captures - captured} captures in the "
          "measured run")

    for r in reqs:
        check(len(r.generated) == 16 and r.finish_reason == "ok",
              f"{label}: request {r.rid}: {len(r.generated)} tokens, "
              f"{r.finish_reason}")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{label}: request {r.rid}: token out of range")
    if eng.paged:
        check(eng.kv.num_free_blocks == eng.kv.num_blocks - 1,
              f"{label}: leaked blocks: {eng.kv.num_free_blocks} free of "
              f"{eng.kv.num_blocks}")
    check(steps == sum(kinds.values()), f"{label}: {steps} steps, {kinds}")
    want = {name: 0 for name in launches}
    for kind, n in kinds.items():
        for name, k in step_launches(eng, kind).items():
            want[name] += n * k
    check(launches == want, f"{label}: launches {launches} over steps "
          f"{kinds}, want {want}")

    ttft = [r.first_token_time - r.arrival for r in reqs]
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    dec_tok = sum(len(r.generated) - 1 for r in reqs)
    stats = {"wall_ms_per_decode_step": (t_last - t_first) / 15 * 1e3,
             "ttft_ms": [t * 1e3 for t in ttft],
             "decode_tokens_per_s": dec_tok / (t_last - t_first),
             "configs": counts, "steps": [first_step, eng.step_count]}
    print(f"{label}: served 6 requests x 16 tokens in {wall:.3f} s over "
          f"{steps} steps {kinds}; configs {counts}; "
          f"{eng.preemptions} preemptions"
          + (f"; {eng.kv.num_free_blocks} of {eng.kv.num_blocks} blocks "
             "free at exit" if eng.paged else ""))
    print(f"{label}: TTFT ms: " + ", ".join(f"{t * 1e3:.1f}" for t in ttft))
    print(f"{label}: decode: {dec_tok} tokens in "
          f"{(t_last - t_first) * 1e3:.1f} ms, "
          f"{dec_tok / (t_last - t_first):.1f} tokens/s, "
          f"{(t_last - t_first) / 15 * 1e3:.2f} ms per step")
    print(f"{label}: launches: {json.dumps(launches)}; per step: "
          f"prefill {step_launches(eng, 'prefill')}, decode "
          f"{step_launches(eng, 'decode')}")
    return reqs, launches, stats


def shared_tokens(reqs, ref):
    """Tokens of each request's stream that agree with ``ref``'s before
    the first difference, summed."""
    n = 0
    for r, q in zip(reqs, ref):
        for a, b in zip(r.generated, q.generated):
            if a != b:
                break
            n += 1
    return n


# eager tables first and last, graphed ones between: a drift of the host
# over the run shows as a difference between the two eager turns
TURNS = (False, True, True, False)
# the single-rank serialized paths' bf16 streams (phase 5), by path, that
# the layout phase's serialized runs are reported against
SINGLE_RANK_STREAMS = {}


def serve_turns(torch, model, kw, label, workload=None):
    """One serving path in turns on ``model``: eager, graphed, graphed and
    eager step tables, each on a new engine (``EngineConfig(**kw)``, its
    cache initialised anew) with the same workload. Each turn runs
    ``serve_path`` and then ``profile_decode``. The eager tables are built
    here, explicitly; the engine always builds the graphed ones. Checks
    that the streams and the launch counts of every turn are equal and
    that an eager turn captures nothing. Returns the first graphed turn's
    requests and launches, and every turn's numbers."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.deployment import Deployment
    turns = []
    for graphed in TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        eng = ShiftEngine(model, EngineConfig(**kw))
        if not graphed:
            eng.deploy = Deployment.build(eng.base, eng.shift,
                                          mixed=eng.mixed, paged=eng.paged,
                                          graphed=False)
        name = f"{label} [{'graphed' if graphed else 'eager'}]"
        reqs, launches, stats = serve_path(torch, eng, name, workload)
        stats.update(profile_decode(torch, eng, label=name))
        stats.update(graphed=graphed, graphs_captured=eng.deploy.captures,
                     capture_ms=(eng.deploy.graphs.capture_s * 1e3
                                 if graphed else 0.0))
        check(graphed or eng.deploy.captures == 0,
              f"{name}: the eager tables captured")
        turns.append((reqs, launches, stats))
        del eng
    streams = [[r.generated for r in reqs] for reqs, _, _ in turns]
    check(all(s == streams[0] for s in streams),
          f"{label}: the graphed and eager streams differ: {streams}")
    check(all(launches == turns[0][1] for _, launches, _ in turns),
          f"{label}: launch counts differ between turns: "
          f"{[launches for _, launches, _ in turns]}")
    for _, _, st in turns:
        print(f"{label} turn: " + json.dumps(st))
    print(f"{label}: eager, graphed, graphed, eager: equal streams and "
          "launch counts; per turn wall ms per decode step "
          + ", ".join(f"{st['wall_ms_per_decode_step']:.2f}"
                      for _, _, st in turns)
          + "; device busy ms per profiled decode step "
          + ", ".join(f"{st['busy_ms_per_step']:.2f} "
                      f"({st['busy_share']:.1%})" for _, _, st in turns))
    first = next(t for t in turns if t[2]["graphed"])
    return first[0], first[1], [st for _, _, st in turns]


def graph_logits_check(torch, model, paged, calls, label):
    """Full-width logits of captured entries against the eager steps, each
    side on a freshly initialised small cache: ``calls`` is a list of
    (step, host arrays), with step "mixed", "prefill" or "decode"; the
    first call of each bucket runs eagerly and captures, later ones
    replay. Fails unless every output is finite and within the kernels'
    bf16 tolerance of the eager one; prints the max abs difference."""
    from repro_torch.engine.deployment import CapturedStep, GraphPool
    steps = {"mixed": lambda *a: model.mixed_step(*a, sample=False),
             "prefill": model.prefill_step,
             "decode": lambda *a: model.decode_step(*a, sample=False)}
    graphs, outs = GraphPool(), []
    for pool in (None, graphs):
        if paged:
            model.init_paged_cache(9, 16)
        else:
            model.init_cache(2, 32)
        entries = {k: CapturedStep(fn, model, paged, pool)
                   for k, fn in steps.items()}
        outs.append([entries[k](*args).clone() for k, args in calls])
        torch.cuda.synchronize()
    err = 0.0
    for (kind, _), want, got in zip(calls, *outs):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{label}: graphed {kind} logits {tuple(got.shape)}")
        err = max(err, (got - want).abs().max().item())
    check(err <= 2e-2, f"{label}: graphed vs eager logits: max abs diff "
          f"{err} > 2e-2")
    print(f"{label}: graphed vs eager logits over {len(calls)} calls "
          f"({graphs.captures} captured, {len(calls) - graphs.captures} "
          f"replayed): max abs diff {err}"
          + (" (bitwise equal)" if err == 0 else ""))
    return err


# the prefix + spec path: the serve workload after a 32-token shared prefix
# (two blocks), with the prefix cache and k=4 drafts
PS_SHARED, PS_K = 32, 4


def count_waits(eng):
    """Count the admissions that wait for an in-flight same-prefix prefill
    from here on: {"waits": n}."""
    n = {"waits": 0}
    wait = eng._wait_for_inflight

    def counted(req, row, matched):
        did = wait(req, row, matched)
        n["waits"] += int(did)
        return did
    eng._wait_for_inflight = counted
    return n


def graphs_by_width(d):
    """CUDA graphs captured so far by verify width, over the deployment's
    distinct entries (on one rank base and shift share each entry)."""
    out, seen = {}, set()
    for (_, n), e in ([(("plain", 1), e) for e in d.forward.values()]
                      + list(d.spec_forward.items())):
        if id(e) not in seen:
            seen.add(id(e))
            out[f"n_last={n}"] = out.get(f"n_last={n}", 0) + len(e.buckets)
    return out


def prefix_spec_path(torch, eng, label):
    """One turn of the prefix + spec path on ``eng``: a warm-up run of the
    workload, then every cached entry evicted, so that the measured run
    starts from a cold cache as the warm-up did and steps through the same
    buckets; the measured run with every launch counter set to 0 just
    before it and read just after. Checks the requests, a prefix hit and an
    in-flight wait in the measured run, drafts when speculating, the blocks
    at exit (none held by a request, the index's pins its entries), no
    capture, and the launches against the per-step counts."""
    from repro_torch.launch import serve
    cfg = eng.mcfg
    waits = count_waits(eng)
    for r in serve.workload(6, 16, shared_prefix=PS_SHARED):
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    eng.prefix.evict(len(eng.prefix))
    check(len(eng.prefix) == 0 and eng.block_accounting().used == 0,
          f"{label}: the cache did not empty: {eng.block_accounting()}")
    before = eng.prefix_stats.as_dict()
    spec0 = spec_counts(eng)
    counts0 = dict(eng.config_counts)
    waits["waits"] = 0
    kinds = count_steps(eng)
    reqs = serve.workload(6, 16, shared_prefix=PS_SHARED)
    captured = eng.deploy.captures
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = serve.launch_counts()
    counts = delta(eng.config_counts, counts0)
    steps = sum(counts.values())
    check(eng.deploy.captures == captured,
          f"{label}: {eng.deploy.captures - captured} captures in the "
          "measured run")
    for r in reqs:
        check(len(r.generated) == 16 and r.finish_reason == "ok"
              and all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{label}: request {r.rid}: {len(r.generated)} tokens, "
              f"{r.finish_reason}")
    after = eng.prefix_stats.as_dict()
    stats = {k: after[k] - before[k] for k in
             ("hits", "misses", "tokens_saved", "evictions", "cow_copies")}
    spec = tuple(a - b for a, b in zip(spec_counts(eng), spec0))
    check(stats["hits"] > 0 and waits["waits"] > 0,
          f"{label}: prefix {stats}, {waits['waits']} in-flight waits")
    check(spec[0] > 0 or not eng.cfg.spec.k, f"{label}: no draft")
    led = eng.block_accounting()
    check(led.used == led.pinned == after["entries"],
          f"{label}: blocks at exit {led}, {after['entries']} entries")
    check(steps == kinds["mixed"], f"{label}: {steps} steps, {kinds}")
    want = {name: 0 for name in launches}
    for name, k in step_launches(eng, "mixed").items():
        want[name] += steps * k
    check(launches == want, f"{label}: launches {launches} over {steps} "
          f"steps, want {want}")
    ttft = [r.first_token_time - r.arrival for r in reqs]
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    dec_tok = sum(len(r.generated) - 1 for r in reqs)
    out = {"steps": steps, "configs": counts,
           "wall_ms_per_step": wall / steps * 1e3,
           "ttft_ms": [t * 1e3 for t in ttft],
           "decode_tokens_per_s": dec_tok / (t_last - t_first),
           "tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
           "prefix": stats, "inflight_waits": waits["waits"],
           "cached_tokens": [r.cached_tokens for r in reqs],
           "spec_proposed": spec[0], "spec_accepted": spec[1],
           "spec_rollback_blocks": spec[2],
           "graphs_by_width": graphs_by_width(eng.deploy)}
    print(f"{label}: served 6 requests x 16 tokens after a {PS_SHARED}-token "
          f"shared prefix in {wall:.3f} s over {steps} steps "
          f"{counts}; prefix {stats}, {waits['waits']} in-flight "
          f"waits, cached tokens {out['cached_tokens']}; drafted {spec[0]}, "
          f"accepted {spec[1]}, rollback blocks {spec[2]}; "
          f"{out['wall_ms_per_step']:.2f} ms per step, TTFT ms "
          + ", ".join(f"{t:.1f}" for t in out["ttft_ms"])
          + f", {out['decode_tokens_per_s']:.1f} decode tokens/s; graphs "
          f"{out['graphs_by_width']}")
    return reqs, launches, out


def prefix_spec_phase(torch, model):
    """The ``mixed_prefix_spec`` path on the served model: the mixed engine
    with the prefix cache and ``k=4`` over the eager tables, then the
    graphed ones (streams and launches equal), then the graphed tables
    without speculation (how many steps the drafts saved, and how far the
    streams agree: bf16 goes through other tile shapes, so for
    information)."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.engine.deployment import Deployment
    from repro_torch.spec import SpecConfig
    turns = []
    for graphed, k in ((False, PS_K), (True, PS_K), (True, 0)):
        gc.collect()
        torch.cuda.empty_cache()
        eng = ShiftEngine(model, EngineConfig(
            prefix=PrefixConfig(enabled=True), spec=SpecConfig(k=k)))
        if not graphed:
            eng.deploy = Deployment.build(eng.base, eng.shift, mixed=True,
                                          paged=True, graphed=False)
        name = (f"mixed prefix + spec k={k} "
                f"[{'graphed' if graphed else 'eager'}]")
        reqs, launches, st = prefix_spec_path(torch, eng, name)
        check(graphed or eng.deploy.captures == 0,
              f"{name}: the eager tables captured")
        st.update(graphed=graphed, spec_k=k,
                  graphs_captured=eng.deploy.captures)
        turns.append((reqs, launches, st))
        del eng
    (e_reqs, e_l, e_st), (g_reqs, g_l, g_st), (o_reqs, _, o_st) = turns
    check([r.generated for r in e_reqs] == [r.generated for r in g_reqs]
          and e_l == g_l and e_st["steps"] == g_st["steps"],
          "mixed prefix + spec: the eager and graphed turns differ")
    print(f"mixed prefix + spec: eager == graphed (streams, launches, "
          f"{g_st['steps']} steps); without drafts {o_st['steps']} steps: "
          f"{o_st['steps'] - g_st['steps']} steps saved; "
          f"{shared_tokens(g_reqs, o_reqs)} of 96 tokens agree with the "
          "spec-off stream before their first difference (for information)")
    for _, _, st in turns:
        print("mixed prefix + spec turn: " + json.dumps(st))
    return g_l, [st for _, _, st in turns]


def serving_phase(torch):
    import numpy as np
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    t0 = time.monotonic()
    eng = serve.build_engine("qwen3-8b", device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cfg = eng.mcfg
    print(f"qwen3-8b full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_params() / 1e9:.3f} B params "
          f"({cfg.num_params() * 2 / 1e9:.2f} GB bf16), built in "
          f"{time.monotonic() - t0:.1f} s")
    pool = eng.model.pool
    pool_bytes = 2 * pool.k.numel() * pool.k.element_size()
    print(f"paged pool: {eng.kv.num_blocks} blocks x {eng.cfg.block_size} "
          f"tokens x {cfg.num_layers} layers, {pool_bytes / 1e6:.1f} MB")
    torch.cuda.reset_peak_memory_stats()
    by_path, turns = {}, {}
    model = eng.model
    del eng
    mixed_reqs, by_path["mixed"], turns["mixed"] = serve_turns(
        torch, model, {}, "mixed paged")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the served model's logits on a small mixed batch over free blocks:
    # finite, of the expected shape
    model.init_paged_cache(9, 16)
    bt = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    toks = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    logits, _ = model.forward_mixed(toks, [8, 3], [0, 0], bt, sample=False)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"full-width logits {tuple(logits.shape)} not finite")
    graph_logits_check(torch, model, True, [
        ("mixed", (toks, [8, 3], [0, 0], bt)),
        ("mixed", (toks[:, ::-1].copy(), [1, 1], [8, 3], bt)),
        ("mixed", (toks, [1, 1], [9, 4], bt))], "qwen3-8b mixed")
    by_path["mixed_prefix_spec"], turns["mixed_prefix_spec"] = \
        prefix_spec_phase(torch, model)

    # the serialized iteration on the same weights: the paged pool, then
    # the dense contiguous cache
    for key, label, kw in (("serialized_paged", "serialized paged",
                            {"mixed": False}),
                           ("serialized_dense", "serialized dense",
                            {"paged": False, "mixed": False})):
        if not kw.get("paged", True):
            ser = ShiftEngine(model, EngineConfig(**kw))
            c = ser.model.cache
            print(f"dense cache: {ser.cfg.max_slots} slots x "
                  f"{ser.cfg.s_max} positions x {cfg.num_layers} layers, "
                  f"{2 * c.k.numel() * c.k.element_size() / 1e6:.1f} MB")
            del ser
        reqs, by_path[key], turns[key] = serve_turns(torch, model, kw, label)
        SINGLE_RANK_STREAMS[key] = [list(r.generated) for r in reqs]
        print(f"{label}: {shared_tokens(reqs, mixed_reqs)} of "
              f"{sum(len(r.generated) for r in reqs)} tokens agree with the "
              "mixed stream before their first difference (bf16 through "
              "other kernels; for information)")
        if not kw.get("paged", True):
            toks = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
            model.init_cache(2, 32)
            logits, _ = model.prefill(toks, [0, 24])
            torch.cuda.synchronize()
            check(tuple(logits.shape) == (2, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()),
                  f"full-width dense logits {tuple(logits.shape)} not finite")
            graph_logits_check(torch, model, False, [
                ("prefill", (toks, [0, 0], None)),
                ("prefill", (toks[:, ::-1].copy(), [8, 8], None)),
                ("decode", ([5, 7], [16, 16], None)),
                ("decode", ([9, 3], [17, 17], None))],
                "qwen3-8b dense prefill + decode")
    by_path["mixed_obs"], by_path["serialized_paged_obs"] = \
        obs_phase(torch, model)
    by_path["mixed_faults"] = recovery_phase(torch, model)
    by_path["mixed_adaptive"], turns["mixed_adaptive"] = adaptive_turn(
        torch, model, mixed_reqs, by_path["mixed"], "mixed paged")
    by_path.update(cluster_phase(torch, model))
    print(f"card: {card_line()}")
    return by_path, turns


# ---------------------------------------------------------------------------
# phase 5e: two replicas of the served model behind the cluster Router
# ---------------------------------------------------------------------------
CLUSTER_SHARED = 32             # the cluster workload's shared prefix
LONE_PROMPT = list(range(1, 20))  # the serve workload's request 0
MIGRATE_AT = (4, 8, 12)         # tokens delivered before each migration


def cluster_requests(base, n=6, max_new=16):
    """The serve workload after a ``CLUSTER_SHARED``-token shared prefix,
    with rids ``base ..``: an engine keeps every rid it served (``stream``
    reads it), so each run of the phase takes rids of its own."""
    from repro_torch.launch import serve
    reqs = serve.workload(n, max_new, shared_prefix=CLUSTER_SHARED)
    for r in reqs:
        r.rid += base
    return reqs


def forward_steps(engines):
    """Steps whose forward ran, summed over the replicas."""
    return sum(sum(e.config_counts.values()) for e in engines)


def empty_prefix(engines):
    for e in engines:
        e.prefix.evict(len(e.prefix))


def exact_launches(launches, steps, label):
    """109 RMSNorm and 36 ragged launches per qwen3-8b step whose forward
    ran, and nothing else."""
    want = {k: 0 for k in launches}
    want.update(rmsnorm=109 * steps, paged_ragged_attention=36 * steps)
    check(launches == want, f"{label}: launches {launches} over {steps} "
          f"steps, want {want}")


def cluster_run(torch, engines, routing, reqs, rebalance_every=0):
    """Serve ``reqs`` through a new ``Router`` over ``engines`` (their prefix
    caches emptied first), every launch counter set to 0 just before and
    read just after. Checks every request's 16 tokens (delivered exactly
    once) and the launches per forward step."""
    from repro_torch.cluster import Router
    from repro_torch.launch import serve
    empty_prefix(engines)
    router = Router(engines, routing=routing,
                    rebalance_every=rebalance_every)
    reg = [e.obs.registry for e in engines]
    saved0 = [r.counter_total("prefix_tokens_saved_total") for r in reg]
    pre0 = [r.counter_total("tokens_prefill_total") for r in reg]
    steps0, caps0 = forward_steps(engines), [e.deploy.captures
                                             for e in engines]
    torch.cuda.synchronize()
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        router.submit(r)
    owners = [router.owner(r.rid) for r in reqs]
    router.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = serve.launch_counts()
    steps = forward_steps(engines) - steps0
    label = f"cluster {routing}" + (" + rebalance" if rebalance_every
                                    else "")
    exact_launches(launches, steps, label)
    live = [router.request(r.rid) for r in reqs]
    for r in live:
        check(r.finish_reason == "ok" and len(r.generated) == 16
              and router.delivered(r.rid) == r.generated,
              f"{label}: request {r.rid}: {r.finish_reason}, "
              f"{len(r.generated)} tokens, delivered "
              f"{len(router.delivered(r.rid))}")
    t_first = min(r.first_token_time for r in live)
    t_last = max(r.finish_time for r in live)
    return {"router": router, "owners": owners,
            "streams": [r.generated for r in live],
            "saved": sum(r.counter_total("prefix_tokens_saved_total")
                         for r in reg) - sum(saved0),
            "prefill": [r.counter_total("tokens_prefill_total") - p
                        for r, p in zip(reg, pre0)],
            "router_steps": router.steps, "forward_steps": steps,
            "wall_s": wall, "migrations": router.migrations,
            "migrated_blocks": router.migrated_blocks,
            "wall_ms_per_router_step": wall / router.steps * 1e3,
            "wall_ms_per_decode_step": (t_last - t_first) / 15 * 1e3,
            "captures": [e.deploy.captures - c
                         for e, c in zip(engines, caps0)],
            "launches": launches}


def migration_run(torch, engines, rid, want):
    """One request alone, migrated mid-decode between the replicas at
    ``MIGRATE_AT`` tokens (there and back and there), each ``migrate``
    timed on the host clock after a synchronize; its stream must equal
    ``want`` (the bare engine's) bitwise."""
    from repro_torch.cluster import Router
    from repro_torch.engine import Request
    from repro_torch.launch import serve
    empty_prefix(engines)
    router = Router(engines, routing="least-loaded", rebalance_every=0)
    caps0 = [e.deploy.captures for e in engines]
    steps0 = forward_steps(engines)
    serve.reset_launch_counts()
    router.submit(Request(rid, LONE_PROMPT, max_new_tokens=16))
    ms, blocks = [], []
    for at in MIGRATE_AT:
        while len(router.stream(rid)) < at:
            router.step()
            router.poll()
        src = router.owner(rid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops = router.migrate(rid, 1 - src)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(ops is not None and router.owner(rid) == 1 - src,
              f"cluster migration at {at} tokens: not moved")
        blocks.append(len(ops) - 1)
    router.run_until_idle()
    torch.cuda.synchronize()
    exact_launches(serve.launch_counts(), forward_steps(engines) - steps0,
                   "cluster migration")
    got = router.delivered(rid)
    check(got == want, f"cluster migration: the migrated bf16 stream {got} "
          f"differs from the bare engine's {want}")
    return {"migrate_ms": ms, "blocks": blocks, "stream": got,
            "captures": [e.deploy.captures - c
                         for e, c in zip(engines, caps0)],
            "launches": serve.launch_counts()}


def cluster_turn(torch, engines, base):
    """One turn of the phase on ``engines``: the lone request on replica 0
    alone (the bare engine's stream), then affinity, round-robin, the
    migrations and the rebalance run."""
    from repro_torch.engine import Request
    empty_prefix(engines)
    lone = Request(base, LONE_PROMPT, max_new_tokens=16)
    engines[0].submit(lone)
    engines[0].run_until_idle()
    return {"affinity": cluster_run(torch, engines, "affinity",
                                    cluster_requests(base + 10)),
            "round_robin": cluster_run(torch, engines, "round-robin",
                                       cluster_requests(base + 20)),
            "migration": migration_run(torch, engines, base + 30,
                                       lone.generated),
            "rebalance": cluster_run(torch, engines, "affinity",
                                     cluster_requests(base + 40),
                                     rebalance_every=2)}


def cluster_phase(torch, model):
    """Two graphed replicas of the served model (qwen3-8b, full width,
    bf16) over its ONE weight set behind the ``Router``, each with its own
    pool and graphs, the prefix cache on. Two turns of ``cluster_turn``:
    the first captures every bucket, the second is measured and must
    capture nothing. Checks: affinity prefills the shared prefix on one
    replica only (the other prefills nothing) and saves what a lone engine
    saves; round-robin prefills it on both and saves less; a lone request
    migrated three times mid-decode streams bitwise what the bare engine
    streams; the skewed affinity run rebalances (migrations); launches per
    forward step exact in every run; then ``drain``: both ledgers read
    ``used == pinned == 0``, every event and step record of the merged
    dump carries its replica, and the merged counters equal the sums of
    the replicas'. Returns each measured run's launches; prints one
    ``{"cluster": ...}`` line. Two replicas on one card, stepped by one
    Python thread, are not a speed of a cluster."""
    from repro_torch.engine import EngineConfig, PrefixConfig, ShiftEngine
    cfg = model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    ecfg = EngineConfig(prefix=PrefixConfig(enabled=True))
    weights = sum(p.numel() * p.element_size()
                  for p in model.params.parameters())
    free, _ = torch.cuda.mem_get_info()
    engines = [ShiftEngine(model, ecfg) for _ in range(2)]
    for i, e in enumerate(engines):
        e.set_replica(i)       # every record from the first on is stamped
    pool = engines[0].model.pool
    pool_bytes = 2 * pool.k.numel() * pool.k.element_size()
    block_bytes = pool_bytes // pool.k.shape[1]
    print(f"cluster phase: 2 replicas over one weight set: "
          f"{weights / 1e9:.2f} GB of weights once + 2 pools of "
          f"{pool.k.shape[1]} blocks x {pool_bytes / 1e6:.1f} MB "
          f"({block_bytes} B a block: {cfg.num_layers} layers x K and V x "
          f"16 tokens x {cfg.num_kv_heads} kv heads x {cfg.head_dim} x "
          f"{pool.k.element_size()} B)"
          f" + two graph pools, against {free / 1e9:.2f} GB free before the "
          "pools")
    check(engines[0].base.params is engines[1].base.params is model.params
          and engines[0].model.pool is not engines[1].model.pool
          and all(e.deploy.graphs is not None for e in engines),
          "cluster phase: the replicas do not share the weights, share a "
          "pool or run eager tables")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    warm = cluster_turn(torch, engines, 1000)
    captured = sum(sum(v["captures"]) for v in warm.values())
    print(f"cluster phase: turn 1 (captures {captured} graphs) in "
          f"{time.monotonic() - t0:.1f} s")
    run = cluster_turn(torch, engines, 2000)
    for name in ("affinity", "round_robin", "migration", "rebalance"):
        check(run[name]["captures"] == [0, 0],
              f"cluster {name}: {run[name]['captures']} captures after the "
              "first turn")
    aff, rr, mig, reb = (run[k] for k in ("affinity", "round_robin",
                                          "migration", "rebalance"))
    lone_saved = None
    # the lone engine's saving on the same workload: replica 0 alone
    empty_prefix(engines)
    reg = engines[0].obs.registry
    s0 = reg.counter_total("prefix_tokens_saved_total")
    for r in cluster_requests(3000):
        engines[0].submit(r)
    engines[0].run_until_idle()
    lone_saved = reg.counter_total("prefix_tokens_saved_total") - s0
    check(len(set(aff["owners"])) == 1 and 0 in aff["prefill"]
          and aff["saved"] == lone_saved >= 5 * CLUSTER_SHARED,
          f"cluster affinity: owners {aff['owners']}, prefill per replica "
          f"{aff['prefill']}, saved {aff['saved']} (a lone engine "
          f"{lone_saved})")
    check(set(rr["owners"]) == {0, 1} and min(rr["prefill"]) > 0
          and rr["saved"] < aff["saved"],
          f"cluster round-robin: owners {rr['owners']}, prefill per replica "
          f"{rr['prefill']}, saved {rr['saved']}")
    check(reb["migrations"] >= 1, "cluster rebalance: no migration")
    router = reb["router"]
    router.drain()
    for i, e in enumerate(engines):
        led = e.block_accounting()
        check(led.used == led.pinned == 0,
              f"cluster drain: replica {i} holds blocks: {led}")
    dump = router.dump()
    check(all("replica" in ev for ev in dump["events"])
          and all("replica" in rec for rec in dump["steps"])
          and {rec["replica"] for rec in dump["steps"]} == {0, 1},
          "cluster dump: a record without its replica")
    for c in {c["name"] for c in dump["metrics"]["counters"]}:
        merged = sum(x["value"] for x in dump["metrics"]["counters"]
                     if x["name"] == c)
        check(merged == router.counter_total(c),
              f"cluster dump: merged {c} {merged} != the replicas' sum "
              f"{router.counter_total(c)}")
    moved = [b * block_bytes for b in mig["blocks"]]
    print(f"cluster affinity: all 6 requests on replica "
          f"{aff['owners'][0]}, prefill tokens per replica {aff['prefill']}, "
          f"{aff['saved']:.0f} prefill tokens saved (a lone engine "
          f"{lone_saved:.0f}); wall {aff['wall_ms_per_router_step']:.2f} ms "
          f"per router step, {aff['wall_ms_per_decode_step']:.2f} ms per "
          "decode step")
    print(f"cluster round-robin: owners {rr['owners']}, prefill tokens per "
          f"replica {rr['prefill']}, {rr['saved']:.0f} saved; wall "
          f"{rr['wall_ms_per_router_step']:.2f} ms per router step, "
          f"{rr['wall_ms_per_decode_step']:.2f} ms per decode step (both "
          "replicas step one after the other on one card)")
    print(f"cluster migration: a lone request moved at {MIGRATE_AT} tokens: "
          f"{', '.join(f'{m:.3f}' for m in mig['migrate_ms'])} ms per "
          f"migrate, {mig['blocks']} blocks, "
          f"{', '.join(str(b) for b in moved)} B moved on the card; its bf16 "
          "stream equals the bare engine's bitwise")
    print(f"cluster rebalance: {reb['migrations']} migrations "
          f"({reb['migrated_blocks']} blocks) under skew; drained: both "
          f"ledgers used == pinned == 0; merged dump: "
          f"{len(dump['events'])} events, {len(dump['steps'])} step records, "
          f"counters equal the replicas' sums; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(json.dumps({"cluster": {
        "card": card_line(), "weights_bytes": weights,
        "pool_bytes": pool_bytes, "block_bytes": block_bytes,
        "migrate_ms": mig["migrate_ms"], "migrated_blocks": mig["blocks"],
        "migrated_bytes": moved, **{
            k: {f: run[k][f] for f in (
                "owners", "saved", "prefill", "router_steps",
                "forward_steps", "migrations", "migrated_blocks",
                "wall_ms_per_router_step", "wall_ms_per_decode_step")}
            for k in ("affinity", "round_robin", "rebalance")},
        "lone_saved": lone_saved,
        "peak_bytes": torch.cuda.max_memory_allocated()}}))
    launches = {f"cluster_{k}": run[k]["launches"]
                for k in ("affinity", "round_robin", "migration",
                          "rebalance")}
    del engines, router, warm, run, reb, aff, rr, mig
    gc.collect()
    return launches


# ---------------------------------------------------------------------------
# phase 5, the adaptive turn: --adaptive's policy on the served model
# ---------------------------------------------------------------------------
def predicted_ms(cm, rec):
    """The cost model's time, ms, for one step record's facts at one chip
    (``Strategy("tp", 1)``), at the context profile ``AdaptivePolicy``
    prices (``core.policy.ctx_profile``)."""
    from repro_torch.core.policy import ctx_profile
    from repro_torch.sim import Strategy
    n, npf = rec["n_tokens"], rec["prefill_tokens"]
    ctx, lens = ctx_profile(n, rec["ctx_tokens"], rec["n_rows"],
                            rec["ctx_max"])
    return cm.iteration_time(npf, max(n - npf, 0), ctx, Strategy("tp", 1),
                             ctx_lens=lens,
                             n_spec=rec.get("spec_tokens", 0)) * 1e3


def measured_records(eng, stats):
    """The step records of ``serve_path``'s measured run that chose a
    config."""
    lo, hi = stats["steps"]
    return [r for r in eng.step_log
            if lo <= r["step"] < hi and r["config"] is not None]


def adaptive_turn(torch, model, ref_reqs, ref_launches, label):
    """The graphed mixed paged engine on ``model`` (world size 1) under
    ``--adaptive``'s policy (``serve.adaptive_policy``: the cost model at
    the H100's numbers over (2, 2)), through ``serve_path`` and
    ``profile_decode``: its streams must equal the threshold policy's turn
    bitwise (``ref_reqs``; base and shift are one model at world size 1)
    and its launches that turn's (``ref_launches``), each step's config the
    policy's answer to that step's recorded facts. Prints the steps by
    config, the host µs per ``use_base`` call (1000 calls without a sync)
    and, beside the measured wall and busy ms per decode step, the cost
    model's prediction for the measured decode steps at one chip. Returns
    the launches and the turn's numbers."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    policy = serve.adaptive_policy(model.cfg)
    eng = ShiftEngine(model, EngineConfig(), policy=policy)
    name = f"{label} adaptive [graphed]"
    reqs, launches, stats = serve_path(torch, eng, name)
    recs = measured_records(eng, stats)
    stats.update(profile_decode(torch, eng, label=name))
    check([r.generated for r in reqs] == [r.generated for r in ref_reqs],
          f"{name}: the streams differ from the threshold policy's turn")
    check(launches == ref_launches, f"{name}: launches {launches}, the "
          f"threshold turn's {ref_launches}")
    for rec in recs:
        want = policy.use_base(rec["n_tokens"], rec["prefill_tokens"],
                               ctx_tokens=rec["ctx_tokens"],
                               n_rows=rec["n_rows"], ctx_max=rec["ctx_max"],
                               spec_tokens=rec.get("spec_tokens", 0))
        check(rec["config"] == ("base" if want else "shift"),
              f"{name}: step {rec['step']} ran {rec['config']} against the "
              f"policy's answer for its facts {rec}")
    decode = [r for r in recs if not r["prefill_tokens"]]
    facts = (decode or recs)[0]
    args = (facts["n_tokens"], facts["prefill_tokens"])
    kw = {k: facts[k] for k in ("ctx_tokens", "n_rows", "ctx_max")}
    us = host_us(torch, lambda: policy.use_base(*args, **kw))
    pred = [predicted_ms(policy.cost_model, r) for r in decode]
    stats.update(policy_host_us=us,
                 predicted_ms_per_decode_step=sum(pred) / len(pred),
                 predicted_ms_per_step={str(r["step"]): p for r, p in zip(
                     decode, pred)})
    print(f"{name}: equal streams and launches to the threshold turn; "
          f"steps by config {stats['configs']} (threshold turn: base for "
          f"steps over {serve.DEFAULT_SHIFT_THRESHOLD} tokens); every "
          "step's config is the policy's answer to its recorded facts")
    print(f"{name}: policy host {us:.2f} us per use_base call (1000 calls, "
          f"no sync); decode step: measured wall "
          f"{stats['wall_ms_per_decode_step']:.3f} ms, device busy "
          f"{stats['busy_ms_per_step']:.3f} ms, cost model "
          f"{stats['predicted_ms_per_decode_step']:.3f} ms (Strategy tp 1, "
          "H100 data-sheet constants, model parameters overhead 4 ms, mfu "
          "0.6, bw_eff 0.8; a prediction, printed only)")
    print(f"{name} turn: " + json.dumps(stats))
    del eng
    return launches, [stats]


# ---------------------------------------------------------------------------
# phase 5d: qwen-32b at full width and depth on one card
# ---------------------------------------------------------------------------
QWEN32_CHECK_LAYERS = 2         # the fp32 check's depth (full width)
QWEN32_HEADROOM = 4e9           # activations, logits and CUDA graphs


def qwen32b_phase(torch):
    """The paper's evaluation model (Table 4, qwen-32b: 64 layers, d_model
    5120, 64 q heads over 8 kv heads) at full width and depth in bf16 on
    one card, after a reckoning of its memory against the card's free
    memory (the phase fails if it does not fit): the serve CLI's workload
    through the graphed mixed paged engine under the threshold policy and
    under ``--adaptive``'s, each through ``serve_path`` and
    ``profile_decode`` (193 RMSNorm and 64 ragged launches per step, in
    the counters and the trace; no block held at exit); equal streams;
    TTFT, wall and busy ms per decode step and decode tokens/s beside the
    cost model's prediction. The model is then freed, and a 2-layer cut at
    full width in fp32 gives one mixed step's logits on the card and on
    the CPU (the same weights) within 2e-3, the layout phase's tolerance.
    Returns the launches of both turns and their numbers."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.sim import CostModel
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen-32b")
    ecfg = EngineConfig()
    blocks = ecfg.max_slots * ecfg.s_max // ecfg.block_size + 1
    params = cfg.num_params() * 2
    pool = (2 * cfg.num_layers * blocks * ecfg.block_size * cfg.num_kv_heads
            * cfg.head_dim * 2)
    init = cfg.vocab_size * cfg.d_model * (4 + 2)
    free, total = torch.cuda.mem_get_info()
    need = params + pool + init + QWEN32_HEADROOM
    print(f"qwen-32b phase: memory reckoned: weights {params / 1e9:.2f} GB "
          f"bf16 ({cfg.num_params()} params, "
          f"{cfg.active_params() * 2 / 1e9:.2f} GB in the cost model's "
          f"count), pool {blocks} blocks x {ecfg.block_size} tokens x "
          f"{cfg.num_layers} layers = {pool} B, the largest init temporary "
          f"{init / 1e9:.2f} GB (the embedding in fp32 and bf16), "
          f"{QWEN32_HEADROOM / 1e9:.1f} GB for activations and graphs: "
          f"{need / 1e9:.2f} GB against {free / 1e9:.2f} GB free of "
          f"{total / 1e9:.2f} GB")
    check(need <= free, f"qwen-32b: {need / 1e9:.2f} GB needed, "
          f"{free / 1e9:.2f} GB free")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = serve.build_engine("qwen-32b", device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    held = sum(p.numel() * p.element_size()
               for p in eng.model.params.parameters())
    pool_bytes = 2 * eng.model.pool.k.numel() * eng.model.pool.k.element_size()
    check(held == params and pool_bytes == pool,
          f"qwen-32b: weights {held} B and pool {pool_bytes} B, reckoned "
          f"{params} and {pool}")
    print(f"qwen-32b full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} q heads over {cfg.num_kv_heads} "
          f"kv heads, built in {build_s:.1f} s; peak device memory while "
          f"building {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    per_step = step_launches(eng, "mixed")
    check(per_step == {"rmsnorm": 193, "paged_ragged_attention": 64},
          f"qwen-32b: per-step launches {per_step}")
    model = eng.model
    del eng
    out, launches = {}, {}
    ref = None
    for name, policy in (("threshold", None),
                         ("adaptive", serve.adaptive_policy(cfg))):
        gc.collect()
        torch.cuda.empty_cache()
        eng = ShiftEngine(model, EngineConfig(), policy=policy)
        label = f"qwen-32b mixed paged {name} [graphed]"
        reqs, launches[name], st = serve_path(torch, eng, label)
        recs = measured_records(eng, st)
        st.update(profile_decode(torch, eng, label=label))
        pred = [predicted_ms(CostModel(cfg), r) for r in recs
                if not r["prefill_tokens"]]
        st.update(predicted_ms_per_decode_step=sum(pred) / len(pred),
                  graphs_captured=eng.deploy.captures,
                  capture_ms=eng.deploy.graphs.capture_s * 1e3)
        if ref is None:
            ref = reqs
        else:
            check([r.generated for r in reqs] == [r.generated for r in ref],
                  "qwen-32b: the adaptive turn's streams differ from the "
                  "threshold turn's")
            check(launches[name] == launches["threshold"],
                  f"qwen-32b: launches {launches}")
        led = eng.block_accounting()
        check(led.used == led.pinned == 0, f"qwen-32b {name}: blocks held "
              f"at exit {led}")
        out[name] = st
        print(f"{label}: TTFT ms " + ", ".join(
            f"{t:.1f}" for t in st["ttft_ms"]) + f"; decode step wall "
            f"{st['wall_ms_per_decode_step']:.3f} ms, device busy "
            f"{st['busy_ms_per_step']:.3f} ms ({st['busy_share']:.1%}), "
            f"{st['decode_tokens_per_s']:.1f} decode tokens/s; cost model "
            f"{st['predicted_ms_per_decode_step']:.3f} ms per decode step "
            "(Strategy tp 1, H100 data-sheet constants; printed only); "
            f"steps by config {st['configs']}")
        del eng
    print(f"qwen-32b: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # fp32, full width, 2 layers: one mixed step's logits, card vs CPU
    check_cfg = replace(cfg, num_layers=QWEN32_CHECK_LAYERS)
    steps, bt = layout_check_steps()
    gpu = Model(check_cfg, device="cuda", dtype=torch.float32)
    gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(check_cfg, device="cpu", dtype=torch.float32)
    cpu.load_params({k: v.cpu() for k, v in
                     gpu.params.state_dict().items()})
    err = 0.0
    for m in (gpu, cpu):
        m.init_paged_cache(9, 16)
    for t, ql, off in steps:
        lg = [m.forward_mixed(t, ql, off, bt, sample=False)[0].cpu()
              for m in (gpu, cpu)]
        err = max(err, compare(torch, "qwen-32b fp32 2-layer logits",
                               lg[0], lg[1], 2e-3))
    print(f"qwen-32b fp32 full-width ({QWEN32_CHECK_LAYERS} layers) mixed "
          f"step logits, card against CPU on the same weights: max abs err "
          f"{err} (tol 2e-3)")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.monotonic() - t_phase
    print(json.dumps({"qwen32b": {"build_s": build_s, "turns": out,
                                  "fp32_max_abs_err": err,
                                  "phase_wall_s": wall}}))
    print(f"qwen-32b phase: {wall:.1f} s in all; card: {card_line()}")
    return launches, out


# ---------------------------------------------------------------------------
# phase 5b: observability and the request lifecycle on the served model
# ---------------------------------------------------------------------------
OBS_TURNS = (True, False, True, False)     # obs on, off, on, off


def count_configs(eng):
    """Count the configs ``eng``'s policy chooses from here on, apart from
    the registry: {"base": n, "shift": n}."""
    from collections import Counter
    chosen = Counter()
    choose = eng._choose

    def counted(*args, **kw):
        name = choose(*args, **kw)
        chosen[name] += 1
        return name

    eng._choose = counted
    return chosen


def obs_run(torch, eng, chosen):
    """One measured run of the serve workload on ``eng`` (warm, so only
    replays), every launch counter set to 0 just before and read just
    after. Returns the requests, the run's wall (the engine's clock), its
    steps and launches, the configs chosen and the wall per decode step."""
    from repro_torch.launch import serve
    reqs = serve.workload(6, 16)
    chosen.clear()
    captured, step0 = eng.deploy.captures, eng.step_count
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = serve.launch_counts()
    check(eng.deploy.captures == captured, "obs phase: a capture in a "
          "measured run")
    check(all(len(r.generated) == 16 and r.finish_reason == "ok"
              for r in reqs), "obs phase: a request did not finish")
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    return {"reqs": reqs, "wall_s": wall, "steps": eng.step_count - step0,
            "launches": launches, "chosen": dict(chosen),
            "wall_ms_per_decode_step": (t_last - t_first) / 15 * 1e3}


def step_kind(rec):
    if rec["prefill_tokens"] and rec["decode_tokens"]:
        return "mixed"
    return ("prefill" if rec["prefill_tokens"] else
            "decode" if rec["decode_tokens"] else "idle")


def check_dump(run, dump, label, mixed):
    """The dump of a measured run holds together: ``steps_total{config}``
    equals the configs chosen; the records' token sums equal the token
    counters, and these the prompts and the tokens the requests hold (the
    mixed iteration prefills a whole prompt and samples the first token in
    its last chunk; the serialized one leaves each prompt's last token to
    its first decode step); TTFT and E2E counted
    once per request; every ``finish`` event's ``ttft_s`` the request's own;
    the records' durations 0.95-1.0 of the run's wall; the Chrome trace
    round-trips through JSON with one "X" event per record. Returns the
    medians of ``dur_s`` by config and by kind of step, in ms."""
    from statistics import median
    from repro_torch.obs import chrome_trace
    reqs, steps = run["reqs"], dump["steps"]
    counters = {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
                for c in dump["metrics"]["counters"]}
    hists = {h["name"]: h for h in dump["metrics"]["histograms"]}
    by_config = {k: counters.get(("steps_total", (("config", k),)), 0)
                 for k in ("base", "shift")}
    check(by_config == {k: run["chosen"].get(k, 0) for k in by_config},
          f"{label}: steps_total {by_config}, chosen {run['chosen']}")
    pre = sum(r["prefill_tokens"] for r in steps)
    dec = sum(r["decode_tokens"] for r in steps)
    prompts = sum(len(r.prompt) for r in reqs)
    held = sum(len(r.generated) for r in reqs)
    want = (prompts, held - len(reqs)) if mixed \
        else (prompts - len(reqs), held)
    check((pre, dec) == want
          and pre == counters[("tokens_prefill_total", ())]
          and dec == counters[("tokens_decode_total", ())],
          f"{label}: records {pre} prefill + {dec} decode tokens, counters "
          f"{counters.get(('tokens_prefill_total', ()))} + "
          f"{counters.get(('tokens_decode_total', ()))}, want {want}")
    check(hists["ttft_seconds"]["count"] == hists["e2e_seconds"]["count"]
          == len(reqs), f"{label}: TTFT/E2E counts")
    by_rid = {r.rid: r for r in reqs}
    fins = [e for e in dump["events"] if e["kind"] == "finish"]
    check(len(fins) == len(reqs) and all(
        e["ttft_s"] == by_rid[e["rid"]].first_token_time
        - by_rid[e["rid"]].arrival for e in fins),
        f"{label}: finish events' ttft_s differ from the requests'")
    dur = sum(r["dur_s"] for r in steps)
    check(0.95 * run["wall_s"] <= dur <= run["wall_s"],
          f"{label}: records' durations {dur:.4f} s against the run's wall "
          f"{run['wall_s']:.4f} s")
    tr = chrome_trace(dump)
    check(json.loads(json.dumps(tr)) == tr and sum(
        e["ph"] == "X" for e in tr["traceEvents"]) == len(steps),
        f"{label}: the Chrome trace")
    med = {}
    for key, fn in (("config", lambda r: r["config"] or "idle"),
                    ("kind", step_kind)):
        groups = {}
        for r in steps:
            groups.setdefault(fn(r), []).append(r["dur_s"] * 1e3)
        med[key] = {k: {"median_ms": median(v), "steps": len(v)}
                    for k, v in sorted(groups.items())}
    med["records_share_of_wall"] = dur / run["wall_s"]
    return med


def obs_turns(torch, model):
    """The graphed mixed paged engine over the serve workload with obs on,
    off, on and off (the engine's ``obs`` swapped between runs): equal
    streams, steps and launches; the wall per decode step of each turn and
    the ratio of on to off (``obs.overhead_ratio``); each on-turn's dump
    checked (``check_dump``) and its report printed."""
    from statistics import mean
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.obs import build_report, format_report
    eng = ShiftEngine(model, EngineConfig())
    for r in serve.workload(6, 16):             # warm-up: every capture
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    chosen = count_configs(eng)
    runs = []
    for on in OBS_TURNS:
        obs = fresh_obs(eng, on)
        run = obs_run(torch, eng, chosen)
        if on:
            dump = obs.dump()
            run["medians"] = check_dump(run, dump, "obs on", True)
            run["report"] = format_report(build_report(dump))
        runs.append(run)
    first = runs[0]
    for run in runs[1:]:
        check([r.generated for r in run["reqs"]]
              == [r.generated for r in first["reqs"]]
              and run["steps"] == first["steps"]
              and run["launches"] == first["launches"],
              "obs on/off: the turns' streams, steps or launches differ")
    on = [r["wall_ms_per_decode_step"] for r, o in zip(runs, OBS_TURNS) if o]
    off = [r["wall_ms_per_decode_step"] for r, o in zip(runs, OBS_TURNS)
           if not o]
    ratio = mean(on) / mean(off)
    print("obs phase, mixed paged [graphed]: obs on, off, on, off: equal "
          f"streams, {first['steps']} steps and launches each; wall ms per "
          "decode step " + ", ".join(
              f"{r['wall_ms_per_decode_step']:.3f}" for r in runs)
          + f"; on / off (obs.overhead_ratio) {ratio:.4f}; run walls s "
          + ", ".join(f"{r['wall_s']:.4f}" for r in runs))
    print("obs phase, mixed paged: the dump holds together (steps by "
          "config, token sums, 6 TTFT and E2E, ttft_s per finish, records "
          f"{first['medians']['records_share_of_wall']:.4f} of the wall, "
          "one trace event per record); report of the first on-turn:")
    print(first["report"])
    print("obs phase, mixed paged: median dur_s ms by config "
          + json.dumps(first["medians"]["config"]) + "; by kind "
          + json.dumps(first["medians"]["kind"]))
    return eng, {"wall_ms_per_decode_step": [
        r["wall_ms_per_decode_step"] for r in runs],
        "wall_s": [r["wall_s"] for r in runs], "overhead_ratio": ratio,
        "medians": first["medians"], "steps": first["steps"]}, \
        first["launches"]


def serialized_obs_turns(torch, model):
    """The graphed serialized paged engine with obs on, in turns with the
    prefill step's device wait and without it (``_wait_for_device``
    replaced by a no-op): equal streams; each turn's dump checked; the
    median ``dur_s`` of prefill and decode records and the run's wall."""
    from statistics import mean
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.obs import build_report, format_report
    eng = ShiftEngine(model, EngineConfig(mixed=False))
    for r in serve.workload(6, 16):
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    chosen = count_configs(eng)
    runs = []
    for wait in (True, False, True, False):
        if wait:
            eng.__dict__.pop("_wait_for_device", None)
        else:
            eng._wait_for_device = lambda: None
        obs = fresh_obs(eng)
        run = obs_run(torch, eng, chosen)
        dump = obs.dump()
        run["medians"] = check_dump(run, dump, "serialized paged", False)
        run["wait"] = wait
        if not runs:
            run["report"] = format_report(build_report(dump))
        runs.append(run)
    eng.__dict__.pop("_wait_for_device", None)
    check(all([r.generated for r in run["reqs"]]
              == [r.generated for r in runs[0]["reqs"]]
              and run["launches"] == runs[0]["launches"] for run in runs),
          "serialized paged obs turns: streams or launches differ")
    kinds = [r["medians"]["kind"] for r in runs]
    with_wait = mean(r["wall_s"] for r in runs if r["wait"])
    without = mean(r["wall_s"] for r in runs if not r["wait"])
    print("obs phase, serialized paged [graphed]: the dump holds together "
          "in every turn; report of the first turn:")
    print(runs[0]["report"])
    print("obs phase, serialized paged: prefill step waits for the device "
          "on, off, on, off: median prefill dur_s ms "
          + ", ".join(f"{k['prefill']['median_ms']:.3f}" for k in kinds)
          + "; median decode dur_s ms "
          + ", ".join(f"{k['decode']['median_ms']:.3f}" for k in kinds)
          + "; run walls s " + ", ".join(f"{r['wall_s']:.4f}" for r in runs)
          + f"; wall with / without the wait {with_wait / without:.4f}")
    return {"prefill_median_ms": [k["prefill"]["median_ms"] for k in kinds],
            "decode_median_ms": [k["decode"]["median_ms"] for k in kinds],
            "wall_s": [r["wall_s"] for r in runs],
            "wait": [r["wait"] for r in runs],
            "wall_ratio_wait": with_wait / without}, runs[0]["launches"]


LIFECYCLE_BLOCKS = 7        # 6 usable blocks of 16: two prompts and a third


def lifecycle_drill(torch, model, policy):
    """Drive ``step()`` by hand on a graphed mixed paged engine with
    ``FaultConfig(max_queue=2, shed_policy=policy)`` on a pool cut to
    ``LIFECYCLE_BLOCKS``: two requests, one step, four more (they wait for
    blocks; the bound sheds two by the policy); after step 3 a running
    request's deadline is set in the past and another running request is
    cancelled; two more steps, then ``drain()`` and one request after it.
    Every request must end with one reason, the reason counters must
    match, no block may be held, and the late request is shed at once."""
    from repro_torch.engine import (EngineConfig, FaultConfig, Request,
                                    ShiftEngine)
    eng = ShiftEngine(model, EngineConfig(
        num_blocks=LIFECYCLE_BLOCKS,
        fault=FaultConfig(max_queue=2, shed_policy=policy)))
    t = time.monotonic()
    reqs = [Request(i, list(range(1, 20 + 3 * i)), max_new_tokens=16,
                    arrival=t) for i in range(6)]
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()
    for r in reqs[2:]:
        eng.submit(r)
    eng.step()
    eng.step()
    running = [r for r in reqs if r.slot is not None]
    check(len(running) >= 2, f"lifecycle {policy}: {len(running)} running "
          "after step 3")
    running[0].deadline = eng.now() - 1.0
    check(eng.cancel(running[1].rid), f"lifecycle {policy}: cancel refused")
    eng.step()
    eng.step()
    eng.drain()
    eng.submit(Request(99, [1, 2, 3], max_new_tokens=2))
    late = eng.request(99)
    reqs.append(late)
    torch.cuda.synchronize()
    reasons = [str(r.finish_reason) for r in reqs]
    reg = eng.obs.registry
    counted = {reason: int(reg.counter_total(name)) for reason, name in (
        ("timeout", "requests_timeout_total"),
        ("cancelled", "requests_cancelled_total"),
        ("shed", "requests_shed_total"), ("ok", "requests_finished_total"))}
    check(all(r.finish_reason is not None for r in reqs)
          and counted == {k: reasons.count(k) for k in counted}
          and sum(counted.values()) == len(reqs),
          f"lifecycle {policy}: reasons {reasons}, counters {counted}")
    check({"timeout", "cancelled", "shed", "ok"} <= set(reasons)
          and late.finish_reason == "shed",
          f"lifecycle {policy}: reasons {reasons}")
    check(all(len(r.generated) == 16 for r in reqs if r.finish_reason == "ok"),
          f"lifecycle {policy}: an OK request is short")
    led = eng.block_accounting()
    check(led.used == led.pinned == 0, f"lifecycle {policy}: blocks held "
          f"after drain {led}")
    print(f"obs phase, lifecycle {policy}: reasons {reasons} (tokens "
          f"{[len(r.generated) for r in reqs]}), counters {counted}, "
          f"{eng.preemptions} preemptions, {eng.step_count} steps, "
          f"{eng.deploy.captures} graphs; after drain used {led.used} "
          f"pinned {led.pinned}; a request after drain: "
          f"{late.finish_reason}")
    return {"reasons": reasons, "counters": counted,
            "preemptions": eng.preemptions, "steps": eng.step_count}


def obs_phase(torch, model):
    """Observability and the request lifecycle on the served model
    (full-width qwen3-8b, bf16): ``obs_turns``, ``serialized_obs_turns``
    and ``lifecycle_drill`` under both shed policies. Prints one
    ``{"obs": ...}`` line; returns the launches of the first measured run
    of each path."""
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    eng, mixed, mixed_launches = obs_turns(torch, model)
    del eng
    gc.collect()
    ser, ser_launches = serialized_obs_turns(torch, model)
    gc.collect()
    drills = {policy: lifecycle_drill(torch, model, policy)
              for policy in ("reject-newest", "evict-longest-queued")}
    wall = time.monotonic() - t0
    print(json.dumps({"obs": {"mixed": mixed, "serialized_paged": ser,
                              "lifecycle": drills, "phase_wall_s": wall}}))
    print(f"obs phase: {wall:.1f} s in all; card: {card_line()}")
    return mixed_launches, ser_launches


# ---------------------------------------------------------------------------
# phase 5c: faults, snapshots and crash recovery on the served model
# ---------------------------------------------------------------------------
# the storm: random_plan(RECOVERY_SEED, RECOVERY_STEPS, p = 0.1 at the
# alloc, forward and route seams). Scheduling does not depend on the
# tokens, so the schedule is the reduced model's: 21 steps, with a nan
# forward fault at step 2, alloc faults at 11 and 16, a raise at 19 and a
# route fault at 20; one request reaches quarantine_after (3) failures
RECOVERY_SEED, RECOVERY_STEPS, RECOVERY_P = 13, 48, 0.1
SNAPSHOT_EVERY = 4
CRASH_STEP = 14              # the ring then holds the snapshots of 8 and 12


def storm(extra=()):
    from repro_torch.ft import FaultPlan, random_plan
    plan = random_plan(RECOVERY_SEED, RECOVERY_STEPS, p_alloc=RECOVERY_P,
                       p_forward=RECOVERY_P, p_route=RECOVERY_P)
    return FaultPlan(plan.faults + list(extra))


def storm_engine(torch, model, faults):
    from repro_torch.engine import EngineConfig, FaultConfig, ShiftEngine
    gc.collect()
    return ShiftEngine(model, EngineConfig(
        fault=FaultConfig(auto_snapshot_every=SNAPSHOT_EVERY)),
        faults=faults)


def submit_workload(eng):
    from repro_torch.launch import serve
    reqs = serve.workload(6, 16)
    for r in reqs:
        eng.submit(r)
    return reqs


def timed_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def engine_state(torch, eng):
    """What a refused restore must leave as it was."""
    return (eng.step_count, eng.lens.tolist(), [r.rid for r in eng.queue],
            eng.kv.state_dict()["allocators"], eng.model.pool.k[:, 1:].sum(
                dtype=torch.float64).item())


def recovery_phase(torch, model):
    """Faults, snapshots and crash recovery on the graphed mixed paged
    engine over the served model (qwen3-8b, full width, bf16), under the
    seeded storm ``storm()`` with auto-snapshots every
    ``SNAPSHOT_EVERY`` steps, on the serve workload:

    * a clean run and the uninterrupted run under the storm, each on a new
      engine; the latter with every launch counter set to 0 just before it
      and read just after (the 109 RMSNorm and 36 ragged launches of every
      step whose forward ran), three snapshots timed at step 4;
    * restore in place: that engine restores its step-4 snapshot and runs
      to idle again: no graph is captured, and the streams equal its
      uninterrupted ones bitwise;
    * the crash drill: a new engine under the storm, a ``DeliveryLog``
      polled after every step, dropped after ``CRASH_STEP`` steps; a new
      engine ``recover``s from the dropped one's ring and runs to idle:
      no ``ReplayDivergence``, streams equal to the uninterrupted run's
      bitwise, every request with a typed outcome, no block held;
    * a corrupted snapshot: the storm plus a ``snapshot`` fault at step
      12 corrupts the newest capture; ``recover`` falls back to step 8, a
      direct ``restore`` of the corrupt one raises ``SnapshotError`` and
      leaves the engine as it was, and the run ends with the
      uninterrupted streams.

    Prints the ms per snapshot and restore, the bytes per snapshot, the
    walls, the failed steps, retries, preemptions and steps by config, and
    how many faulted streams equal the clean ones (reported only: in bf16
    a stream depends on the batch's bucketed shapes, which the faults
    change). Returns the launches of the uninterrupted run."""
    from repro_torch.ft import DeliveryLog, Fault, SnapshotError
    from repro_torch.launch import serve
    t_phase = time.monotonic()
    out = {}

    eng = storm_engine(torch, model, None)
    t0 = time.monotonic()
    reqs = submit_workload(eng)
    eng.run_until_idle()
    torch.cuda.synchronize()
    out["clean_wall_s"] = time.monotonic() - t0
    clean = [r.generated for r in reqs]
    del eng

    # the uninterrupted run under the storm
    eng = storm_engine(torch, model, storm())
    serve.reset_launch_counts()
    t0 = time.monotonic()
    reqs = submit_workload(eng)
    snap_ms, snap = [], None
    while eng.queue or eng.active:
        eng.step()
        if eng.step_count == SNAPSHOT_EVERY and snap is None:
            for _ in range(3):
                snap, ms = timed_ms(torch, eng.snapshot)
                snap_ms.append(ms)
    torch.cuda.synchronize()
    out["faulted_wall_s"] = time.monotonic() - t0
    launches = serve.launch_counts()
    whole = [r.generated for r in reqs]
    reg = eng.obs.registry
    counters = {name: int(reg.counter_total(name)) for name in (
        "faults_injected_total", "failed_steps_total", "retries_total",
        "requests_failed_total", "snapshots_total")}
    recs = eng.step_log
    ran = sum(1 for rec in recs if rec["config"] is not None
              and rec["attn_ctx_tokens"] > 0)
    check(launches == {k: {"rmsnorm": 109, "paged_ragged_attention": 36
                           }.get(k, 0) * ran for k in launches},
          f"faults phase: launches {launches} over {ran} forward steps")
    check(all(r.finish_reason is not None for r in reqs),
          "faults phase: a request has no outcome")
    check(counters["failed_steps_total"] == 2
          and counters["requests_failed_total"] == 1,
          f"faults phase: counters {counters}, want the reduced schedule's "
          "2 failed steps and 1 quarantined request")
    out.update(counters=counters, steps=eng.step_count,
               configs=dict(eng.config_counts), preemptions=eng.preemptions,
               outcomes=[str(r.finish_reason) for r in reqs],
               snapshot_ms=snap_ms,
               snapshot_bytes=sum(t.numel() * t.element_size()
                                  for t in snap["cache"].values()),
               equal_to_clean=sum(a == b for a, b in zip(whole, clean)))

    # restore in place: the graphs replay, nothing is captured
    captures = eng.deploy.captures
    pool = (eng.model.pool.k.data_ptr(), eng.model.pool.v.data_ptr())
    _, out["restore_ms"] = timed_ms(torch, lambda: eng.restore(snap))
    eng.run_until_idle()
    check([eng.stream(r.rid) for r in reqs] == whole,
          "faults phase: the run after an in-place restore differs from "
          "the uninterrupted run")
    check(eng.deploy.captures == captures
          and (eng.model.pool.k.data_ptr(),
               eng.model.pool.v.data_ptr()) == pool,
          f"faults phase: the in-place restore captured "
          f"{eng.deploy.captures - captures} graphs or moved the pool")
    out["graphs"] = captures
    del eng, snap

    # the crash drill
    eng = storm_engine(torch, model, storm())
    log = DeliveryLog()
    reqs = submit_workload(eng)
    for _ in range(CRASH_STEP):
        eng.step()
        log.poll(reqs)
    ring = eng.retained_snapshots()
    pre = sum(len(log.delivered(r.rid)) for r in reqs)
    del eng
    t0 = time.monotonic()
    eng = storm_engine(torch, model, storm())
    _, out["recover_ms"] = timed_ms(torch, lambda: eng.recover(ring))
    live = list(eng.queue)
    while eng.queue or eng.active:
        eng.step()
        log.poll(live)                 # raises ReplayDivergence
    torch.cuda.synchronize()
    out["recovered_wall_s"] = time.monotonic() - t0
    check([eng.stream(r.rid) for r in reqs] == whole
          and [log.delivered(r.rid) for r in reqs] == whole,
          "faults phase: the recovered streams differ from the "
          "uninterrupted run's")
    check(all(eng.request(r.rid).finish_reason is not None for r in reqs),
          "faults phase: a recovered request has no outcome")
    led = eng.block_accounting()
    check(led.used == led.pinned == 0, f"faults phase: blocks held {led}")
    out.update(ring=[s["step_count"] for s in ring],
               delivered_before_crash=pre,
               recovered_from=ring[-1]["step_count"],
               recovered_graphs=eng.deploy.captures)
    del eng, ring

    # a corrupted newest snapshot
    eng = storm_engine(torch, model, storm([Fault(12, "snapshot")]))
    reqs = submit_workload(eng)
    for _ in range(CRASH_STEP):
        eng.step()
    ring = eng.retained_snapshots()
    check(ring[-1].get("corrupted") and not ring[0].get("corrupted"),
          "faults phase: the step-12 snapshot was not corrupted")
    del eng
    eng = storm_engine(torch, model, storm())
    eng.recover(ring)
    check(eng.step_count == 8, f"faults phase: recovered to step "
          f"{eng.step_count}, want the older snapshot's 8")
    before = engine_state(torch, eng)
    try:
        eng.restore(ring[-1])
        refused = False
    except SnapshotError as e:
        refused = str(e)
    check(refused and engine_state(torch, eng) == before,
          "faults phase: a corrupt snapshot restored or changed the engine")
    eng.run_until_idle()
    check([eng.stream(r.rid) for r in reqs] == whole,
          "faults phase: the run recovered past the corrupt snapshot "
          "differs from the uninterrupted one")
    out["corrupt_refused"] = refused
    del eng, ring
    out["phase_wall_s"] = time.monotonic() - t_phase

    card = card_line()
    print(f"faults phase: seed {RECOVERY_SEED}, p {RECOVERY_P} at the alloc, "
          f"forward and route seams, snapshots every {SNAPSHOT_EVERY} steps; "
          f"{out['steps']} steps, configs {out['configs']}, counters "
          f"{counters}, {out['preemptions']} preemptions, outcomes "
          f"{out['outcomes']}; card: {card}")
    print(f"faults phase: snapshot of the pool {out['snapshot_bytes']} "
          f"bytes, ms per snapshot "
          + ", ".join(f"{ms:.2f}" for ms in snap_ms)
          + f"; restore in place {out['restore_ms']:.2f} ms (no graph "
          f"captured, streams equal); recover {out['recover_ms']:.2f} ms; "
          f"card: {card}")
    print(f"faults phase: crash after step {CRASH_STEP} ({pre} tokens "
          f"delivered), recovered from step {out['recovered_from']} of ring "
          f"{out['ring']}: streams equal the uninterrupted run's bitwise, "
          f"no replay divergence; walls s, each a new engine with "
          f"snapshots: clean {out['clean_wall_s']:.3f}, "
          f"under the storm {out['faulted_wall_s']:.3f}, recovered engine "
          f"(build, recover, run) {out['recovered_wall_s']:.3f}; "
          f"{out['equal_to_clean']} of 6 faulted streams equal the clean "
          f"ones (bf16, reported only); corrupt newest snapshot refused: "
          f"{refused}; card: {card}")
    print(json.dumps({"faults": out}))
    print(f"faults phase: {out['phase_wall_s']:.1f} s in all; card: {card}")
    return launches


def mamba2_serving_phase(torch):
    """mamba2-1.3b at full width (48 SSD layers, d_model 2048, bf16, random
    weights from a generator seeded 0) through the serve CLI's engine, which
    falls back to the serialized iteration on the dense cache; the same 6 x
    16 workload in turns, eager and graphed; then one small prefill +
    decode's logits, finite and of the expected shape, and the graphed
    entries' logits against the eager steps'."""
    import numpy as np
    from repro_torch.launch import serve
    # the qwen3-8b engines hold their model through reference cycles (the
    # step counters wrap bound methods): collect them so that the peak
    # below is mamba2's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    eng = serve.build_engine("mamba2-1.3b", device="cuda",
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cfg = eng.mcfg
    check(not eng.paged and not eng.mixed and "non-pageable"
          in eng.paged_disabled_reason, "mamba2: not the dense fallback")
    c = eng.model.cache
    state = sum(t.numel() * t.element_size()
                for t in (c.ssm, c.conv_x, c.conv_bc))
    print(f"mamba2-1.3b full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} SSD heads of "
          f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, "
          f"{cfg.num_params() / 1e9:.3f} B params "
          f"({cfg.num_params() * 2 / 1e9:.2f} GB bf16), built in "
          f"{time.monotonic() - t0:.1f} s; dense cache: "
          f"{eng.cfg.max_slots} slots, SSD state {state / 1e6:.1f} MB "
          f"({eng.paged_disabled_reason})")
    model = eng.model
    del eng, c
    reqs, launches, turns = serve_turns(torch, model, {},
                                        "mamba2 serialized dense")
    SINGLE_RANK_STREAMS["mamba2_dense"] = [list(r.generated) for r in reqs]
    print(f"mamba2: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({before / 1e9:.2f} GB allocated before the model was built)")
    toks = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    model.init_cache(2, 32)
    logits, _ = model.prefill(toks, [0, 24])
    nxt, _ = model.decode(logits.argmax(-1), [8, 0], sample=False)
    torch.cuda.synchronize()
    for lg in (logits, nxt):
        check(tuple(lg.shape) == (2, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()),
              f"mamba2 full-width logits {tuple(lg.shape)} not finite")
    graph_logits_check(torch, model, False, [
        ("prefill", (toks, [0, 0], None)),
        ("prefill", (toks[:, ::-1].copy(), [8, 8], None)),
        ("decode", ([5, 7], [16, 16], None)),
        ("decode", ([9, 3], [17, 17], None))], "mamba2 prefill + decode")
    print(f"card: {card_line()}")
    return launches, turns


@contextlib.contextmanager
def profiled(torch):
    """``torch.profiler`` over the CPU and the card for the body of the
    ``with``, after a warm-up cycle that runs one small kernel and that the
    results leave out: a window's first launches can be missing from the
    trace while the profiler starts. The recording window itself opens
    with three such kernels and 20 ms of idle before the body runs (the
    warm-up cycle alone still let an eager window's first RMSNorm launch
    go missing); they are no port kernel, and the body's wall starts
    after them."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(3):
            torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.02)
        yield prof
        torch.cuda.synchronize()
        prof.step()


def device_kernels(prof):
    """(name, device µs, launches) of each kernel in ``prof``'s trace: the
    events on the card, less the span of the profiler's own step
    annotation (``ProfilerStep#n``)."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def profile_decode(torch, eng, steps=4, label=None):
    """Where a full-width decode step's time goes: ``torch.profiler`` over
    ``steps`` decode steps of 6 rows (after their one prefill step, mixed
    or serialized), kernel time by name and the device's busy share of the
    host's wall time. The workload runs once before, so that on graphed
    tables the profiled steps are replays of graphs captured then; checks
    that nothing is captured in the profiled run and that the trace holds
    each port kernel's launches of a decode step, ``steps`` times. The
    profiler adds host time of its own, so the busy share is a floor."""
    from repro_torch.launch import serve
    for r in serve.workload(6, steps + 1):
        eng.submit(r)
    eng.run_until_idle()
    captured = eng.deploy.captures
    for r in serve.workload(6, steps + 1):
        eng.submit(r)
    eng.step()                                  # the prefill step
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    eng.run_until_idle()
    it = label or ("mixed" if eng.mixed else "serialized paged" if eng.paged
                   else "serialized dense")
    check(eng.deploy.captures == captured,
          f"{it}: {eng.deploy.captures - captured} captures in the profile")
    # device-side events only: an operator's row repeats its kernels' time
    rows = device_kernels(prof)
    busy = sum(t for _, t, _ in rows)
    n = sum(c for _, _, c in rows)
    check(busy > 0, "the profiler saw no device time")
    traced = {name: 0 for name in serve.launch_counts()}
    for key, _, c in rows:
        kernel = port_kernel(key)
        if kernel:
            traced[kernel] += c
    want = {name: 0 for name in traced}
    for name, k in step_launches(eng, "mixed" if eng.mixed
                                 else "decode").items():
        want[name] = k * steps
    check(traced == want, f"{it}: the trace holds port kernel launches "
          f"{traced} over {steps} decode steps, want {want}")
    print(f"{it}: profile of {steps} decode steps: wall "
          f"{wall_us / steps / 1e3:.2f} "
          f"ms/step, device busy {busy / steps / 1e3:.2f} ms/step "
          f"({busy / wall_us:.1%}), {n / steps:.0f} kernels/step; port "
          "kernels in the trace per step: " + ", ".join(
              f"{k} {v // steps}" for k, v in traced.items() if v))
    for key, t, c in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {t / steps / 1e3:8.3f} ms/step {c // steps:5d}x  {key[:90]}")
    return {"profile_wall_ms_per_step": wall_us / steps / 1e3,
            "busy_ms_per_step": busy / steps / 1e3,
            "busy_share": busy / wall_us, "kernels_per_step": n / steps,
            "traced_port_launches_per_step": {k: v // steps for k, v
                                              in traced.items() if v}}


# ---------------------------------------------------------------------------
# phase 6: Shift Parallelism's layouts, four ranks on one card over gloo
# ---------------------------------------------------------------------------
LAYOUT_GRID = (2, 2)            # (sp, tp), the reference's mesh122
LAYOUT_CHECK_LAYERS = 2         # the fp32 check's depth (full width)
LAYOUT_TIMEOUT_S = 600


def layout_check_steps():
    """The fp32 check's two mixed steps over 4 rows and blocks of 16:
    prefill chunks (one row empty), then decode rows and a chunk. Returns
    ([(tokens [4, 16], q_lens, offsets)], block tables [4, 2])."""
    import numpy as np
    rng = np.random.default_rng(7)
    toks = [rng.integers(1, 151936, (4, 16)).astype(np.int32)
            for _ in range(2)]
    bt = np.arange(1, 9, dtype=np.int32).reshape(4, 2)
    return [(toks[0], [16, 9, 16, 0], [0, 0, 0, 0]),
            (toks[1], [1, 1, 4, 16], [16, 9, 16, 0])], bt


def mamba2_check_cfg():
    """mamba2-1.3b at full width, cut to the fp32 check's depth."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    return replace(get_config("mamba2-1.3b"), num_layers=LAYOUT_CHECK_LAYERS)


def layout_single_rank_logits(torch, cfg):
    """The single-rank port model's logits over ``layout_check_steps`` on
    the same weights (generator seeded 0), fp32, on the card; beside them
    its ``serial_check_logits``, and mamba2-1.3b's (``mamba2_check_cfg``)."""
    from repro_torch.models import Model
    steps, bt = layout_check_steps()
    model = Model(cfg, device="cuda", dtype=torch.float32)
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    model.init_paged_cache(9, 16)
    out = [model.forward_mixed(t, ql, off, bt, sample=False)[0].cpu()
           for t, ql, off in steps]
    serial = serial_check_logits(torch, model, model)
    del model
    gc.collect()
    mamba = Model(mamba2_check_cfg(), device="cuda", dtype=torch.float32)
    mamba.init_params(torch.Generator(device="cuda").manual_seed(0))
    serial_mamba = serial_check_logits(torch, mamba, mamba)
    del mamba
    gc.collect()
    torch.cuda.empty_cache()
    return out, serial, serial_mamba


def serial_check_inputs(vocab):
    """The fp32 check's serialized steps: a prefill chunk of 16 over 4 rows
    at offset 0, then one decode token per row at position 16; blocks of
    16 for the paged pool. Returns (tokens [4, 16], next tokens [4], block
    tables [4, 2])."""
    import numpy as np
    rng = np.random.default_rng(11)
    return (rng.integers(1, vocab, (4, 16)).astype(np.int32),
            rng.integers(1, vocab, (4,)).astype(np.int32),
            np.arange(1, 9, dtype=np.int32).reshape(4, 2))


def serial_check_logits(torch, base, shift):
    """The fp32 logits of ``serial_check_inputs``' prefill then decode,
    on the dense cache and (for a config that pages) through the paged
    pool, under each config, each on a fresh cache that both models step:
    {(path, config): (sp rank, tp rank, [prefill [B, v_blk], decode
    [B/sp, v_blk]])}. One model on the trivial layout (``base`` is
    ``shift``)."""
    import numpy as np
    toks, nxt, bt = serial_check_inputs(base.cfg.vocab_size)
    offs, lens = np.zeros(4, np.int32), np.full(4, 16, np.int32)
    out = {}
    for path in ("dense", "paged") if base.supports_paged else ("dense",):
        for config, m in (("base", base), ("shift", shift)):
            if path == "dense":
                base.init_cache(4, 64)
                if shift is not base:
                    shift.adopt_cache(base)
            else:
                base.init_paged_cache(9, 16)
                if shift is not base:
                    shift.adopt_paged_cache(base)
            b = bt if path == "paged" else None
            pre, _ = m.prefill(toks, offs, b)
            dec, _ = m.decode(nxt, lens, b, sample=False)
            out[(path, config)] = (m.shard.sp_rank, m.shard.tp_rank,
                                   [pre.cpu().numpy(), dec.cpu().numpy()])
    base.cache = base.pool = shift.cache = shift.pool = None
    return out


def serial_check_compare(torch, res, key, want, label):
    """The ranks' ``serial_check_logits`` (``res[r][key]``) put together,
    prefill logits by tp rank (every sp rank holds the whole batch's, equal
    bitwise), decode logits by sp rank's rows and tp rank's columns,
    against the single-rank model's ``want`` (2e-3). Returns the max abs
    error."""
    import numpy as np
    err = 0.0
    for (path, config) in res[0][key]:
        parts = {}
        for r in res:
            i, j, lg = r[key][(path, config)]
            parts[(i, j)] = lg
        sps = 1 + max(i for i, _ in parts)
        tps = 1 + max(j for _, j in parts)
        for (i, j), lg in parts.items():
            check(np.array_equal(lg[0], parts[(0, j)][0]),
                  f"{label} {path} {config}: sp rank {i}'s prefill logits "
                  "differ from sp rank 0's")
        pre = np.concatenate([parts[(0, j)][0] for j in range(tps)], -1)
        dec = np.concatenate([np.concatenate(
            [parts[(i, j)][1] for j in range(tps)], -1) for i in range(sps)])
        w = want[(path, "base")][2]
        V = w[0].shape[-1]
        for step, got, ref in (("prefill", pre, w[0]), ("decode", dec, w[1])):
            err = max(err, compare(
                torch, f"{label} {path} {config} {step} fp32 logits",
                torch.from_numpy(np.ascontiguousarray(got[:, :V])),
                torch.from_numpy(ref), 2e-3))
    return err


def layout_engine_run(torch, eng, groups, rank, label):
    """The serve workload through an engine above world size 1 (eager): a
    warm-up run, then the measured run (``layout_serve``) with the walls
    and collective traffic of each step by config (and kind, on the
    serialized iteration) and the launches it should make by step kind;
    then one prefill and three decode steps of a second workload in rank
    0's profiler trace (every rank steps them). Returns numpy results."""
    import contextlib
    from collections import Counter
    from repro_torch.launch import serve
    walls, traffic = timed_forward(
        torch, eng, groups,
        kinds=("forward",) if eng.mixed else ("prefill", "decode"))
    for r in serve.workload(6, 16):            # warm-up
        eng.submit(r)
    eng.run_until_idle()
    for key in walls:
        walls[key].clear()
        traffic[key].clear()
    kinds = count_steps(eng)
    out = layout_serve(torch, eng)
    out.update(kinds=dict(kinds), walls={k: list(v) for k, v in walls.items()},
               traffic={k: dict(v) for k, v in traffic.items()},
               want_launches=kind_launches(eng, out["launches"], kinds))
    for r in serve.workload(6, 4):
        eng.submit(r)
    before, kinds0 = dict(eng.config_counts), dict(kinds)
    with (profiled(torch) if rank == 0
          else contextlib.nullcontext()) as prof:
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
    out["profiled_configs"] = delta(eng.config_counts, before)
    traced_kinds = delta(kinds, kinds0)
    eng.run_until_idle()
    if rank == 0:
        traced, busy = Counter(), 0.0
        for key, t, c in device_kernels(prof):
            busy += t
            kernel = port_kernel(key)
            if kernel:
                traced[kernel] += c
        out["traced"] = dict(traced)
        out["traced_want"] = {k: v for k, v in kind_launches(
            eng, traced, traced_kinds).items() if v}
        out["profiled_busy_ms"] = busy / 1e3
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.print_summary(eng)
    out["summary"] = f"{label}: " + text.getvalue()
    return out


def kind_launches(eng, keys, kinds):
    """Each kernel's launches (``keys`` and any the steps make) in
    ``kinds`` ({kind: steps}) of ``eng``'s full-width steps."""
    want = {k: 0 for k in keys}
    for kind, n in kinds.items():
        for k, per in step_launches(eng, kind).items():
            want[k] = want.get(k, 0) + n * per
    return want


def dense_invariance_step(torch, eng, rank):
    """§3.3.1 on the dense cache: a base prefill step of every slot's
    first 64 positions, then a shift decode step at position 64. Both
    configs step one set of tensors at the same KV slots and SSD heads
    (``verify_dense_invariance``); the positions the base step wrote stay
    bitwise as they were under the shift step, which wrote position 64;
    an SSD model's state is the tensor the shift step advanced."""
    import numpy as np
    from repro_torch.core import invariance as INV
    n = eng.cfg.max_slots
    toks = (np.arange(n * 64, dtype=np.int32).reshape(n, 64) % 1000) + 1
    eng.deploy.prefill["base"](toks, np.zeros(n, np.int32), None)
    torch.cuda.synchronize()
    c = eng.base.cache
    before = INV.snapshot_dense(c)
    eng.deploy.decode["shift"](toks[:, 0].copy(), np.full(n, 64, np.int32),
                               None)
    torch.cuda.synchronize()
    ok = INV.verify_dense_invariance(eng.base, eng.shift, rank)
    if c.k is not None:
        ok = ok and torch.equal(c.k[:, :, :64], before["k"][:, :, :64]) \
            and torch.equal(c.v[:, :, :64], before["v"][:, :, :64]) \
            and bool(c.k[:, :, 64].abs().sum() > 0)
    if c.ssm is not None:
        ok = ok and not torch.equal(c.ssm, before["ssm"])
    return bool(ok)


def layout_rank(rank, groups, check_cfg):
    """One rank of the layout phase (spawned by ``run_ranks``): the fp32
    check's logits of both configs, then qwen3-8b at full width and depth
    in bf16 served on the base and shift models over one pool. Returns
    numpy results; only the parent prints."""
    import numpy as np
    import torch
    from repro_torch.core import invariance as INV
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lay = Layout(sp=LAYOUT_GRID[0], tp=LAYOUT_GRID[1])
    out = {"rank": rank, "device": torch.cuda.current_device()}

    # fp32, full width, cut depth: each config's logits on a fresh pool
    steps, bt = layout_check_steps()
    base, shift = (Model(check_cfg, device="cuda", dtype=torch.float32,
                         lay=layout, groups=groups)
                   for layout in (lay, lay.to_shift()))
    for m in (base, shift):
        m.init_params(torch.Generator(device="cuda").manual_seed(0))
    out["fp32"] = {}
    for name, m in (("base", base), ("shift", shift)):
        base.init_paged_cache(9, 16)
        shift.adopt_paged_cache(base)
        out["fp32"][name] = (m.shard.tp_rank, [
            m.forward_mixed(t, ql, off, bt, sample=False)[0].cpu().numpy()
            for t, ql, off in steps])
    # the serialized steps on the dense cache and the paged pool
    out["fp32_serial"] = serial_check_logits(torch, base, shift)
    del base, shift, m
    # mamba2-1.3b's SSD mixers through the Ulysses exchange, fp32, 2 layers
    mcheck = mamba2_check_cfg()
    mb, ms = (Model(mcheck, device="cuda", dtype=torch.float32, lay=layout,
                    groups=groups) for layout in (lay, lay.to_shift()))
    for m in (mb, ms):
        m.init_params(torch.Generator(device="cuda").manual_seed(0))
    out["fp32_mamba2"] = serial_check_logits(torch, mb, ms)
    del mb, ms, m
    gc.collect()
    torch.cuda.empty_cache()

    # bf16, full width and depth: the engine on both configs
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = serve.build_engine("qwen3-8b", device="cuda", dtype=torch.bfloat16,
                             sp=lay.sp, tp=lay.tp, groups=groups)
    torch.cuda.synchronize()
    out["build_s"] = time.monotonic() - t0
    out["param_bytes"] = {
        name: sum(p.numel() * p.element_size()
                  for p in m.params.parameters())
        for name, m in (("base", eng.base), ("shift", eng.shift))}
    pool = eng.base.pool
    out["pool_bytes"] = 2 * pool.k.numel() * pool.k.element_size()
    out.update(layout_engine_run(torch, eng, groups, rank, "layout mixed"))

    # §3.3.1 on the card's pools: base prefills row 0 into blocks 1 and 2,
    # shift runs row 1, reading them and writing blocks 3 and 4
    toks = np.arange(1, 65, dtype=np.int32).reshape(2, 32)
    bt = np.zeros((2, 4), np.int32)
    bt[0, :2] = (1, 2)
    eng.base.forward_mixed(toks, [32, 0], [0, 0], bt)
    before = INV.snapshot_blocks(eng.base.pool, [1, 2])
    bt[1] = (1, 2, 3, 4)
    eng.shift.forward_mixed(toks[::-1].copy(), [0, 32], [32, 32], bt)
    torch.cuda.synchronize()
    out["invariance"] = INV.verify_paged_invariance(
        eng.base, eng.shift, rank, [1, 2], before)
    out["kv_slots"] = list(INV.kv_slots(eng.base, rank))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()

    # what one collective of the shift decode step costs here: its
    # all-reduce ([8, 1, 4096] bf16) over the four ranks, on a tensor on
    # the card (gloo stages it through the host) and on a host tensor
    group = eng.shift.shard.tp_group.pg
    out["all_reduce_ms"] = {}
    for where in ("cuda", "cpu"):
        x = torch.ones((8, 1, 4096), dtype=torch.bfloat16, device=where)
        for _ in range(3):
            torch.distributed.all_reduce(x, group=group)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            torch.distributed.all_reduce(x, group=group)
        torch.cuda.synchronize()
        out["all_reduce_ms"][where] = (time.perf_counter() - t) / 20 * 1e3

    # the prefix cache and speculation on the same models (a new engine, a
    # new pool): the serve workload after a 32-token shared prefix, k=4
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.spec import SpecConfig
    base, shift = eng.base, eng.shift
    del eng
    gc.collect()
    ps = ShiftEngine(base, EngineConfig(prefix=PrefixConfig(enabled=True),
                                        spec=SpecConfig(k=PS_K)), shift=shift)
    reqs = serve.workload(6, 16, shared_prefix=PS_SHARED)
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        ps.submit(r)
    ps.run_until_idle()
    torch.cuda.synchronize()
    out["prefix_spec"] = {
        "serve_s": time.monotonic() - t0, "launches": serve.launch_counts(),
        "streams": [r.generated for r in reqs],
        "finish": [r.finish_reason for r in reqs],
        "cached": [r.cached_tokens for r in reqs],
        "counts": dict(ps.config_counts), "stats": ps.prefix_stats.as_dict(),
        "spec": spec_counts(ps),
        "ledger": ps.block_accounting().as_dict()}
    del ps
    gc.collect()
    from repro_torch.core import ThresholdPolicy
    from repro_torch.launch.serve import adaptive_policy
    def policy_engine(policy):
        return ShiftEngine(base, EngineConfig(), shift=shift, policy=policy)
    out["adaptive"] = a = layout_serve(torch, policy_engine(
        adaptive_policy(base.cfg, lay.sp, lay.tp)))
    # base and shift sum in different orders in bf16, so the adaptive run
    # is held bitwise to the threshold run that makes its per-step configs:
    # base above the batched tokens of its largest shift step
    out["same_configs"] = layout_serve(torch, policy_engine(ThresholdPolicy(
        max((f[0] for c, f in zip(a["configs"], a["facts"]) if c == "shift"),
            default=0))))

    # the serialized iteration on the same models: over one paged pool per
    # rank, and over one dense cache per rank
    torch.cuda.reset_peak_memory_stats()
    for key, kw in (("serial_paged", dict(mixed=False)),
                    ("serial_dense", dict(paged=False, mixed=False))):
        se = ShiftEngine(base, EngineConfig(**kw), shift=shift)
        out[key] = layout_engine_run(torch, se, groups, rank,
                                     f"layout {key}")
        if not se.paged:
            out[key]["invariance"] = dense_invariance_step(torch, se, rank)
        out[key]["peak_bytes"] = torch.cuda.max_memory_allocated()
        del se
        gc.collect()
    del base, shift
    gc.collect()
    torch.cuda.empty_cache()

    # mamba2-1.3b at full width and depth: its dense fallback on the grid
    torch.cuda.reset_peak_memory_stats()
    me = serve.build_engine("mamba2-1.3b", device="cuda",
                            dtype=torch.bfloat16, sp=lay.sp, tp=lay.tp,
                            groups=groups)
    out["mamba2_dense"] = m2 = layout_engine_run(
        torch, me, groups, rank, "layout mamba2_dense")
    m2["reason"] = me.paged_disabled_reason
    m2["invariance"] = dense_invariance_step(torch, me, rank)
    m2["ssd_heads"] = list(INV.ssd_heads(me.base, rank))
    m2["param_bytes"] = sum(p.numel() * p.element_size() for m in
                            (me.base, me.shift)
                            for p in m.params.parameters())
    m2["peak_bytes"] = torch.cuda.max_memory_allocated()
    del me
    gc.collect()
    torch.cuda.empty_cache()
    return out


def layout_serve(torch, eng):
    """Serve the workload on ``eng``, launch counters from 0: the wall, the
    launches, streams and outcomes, this run's per-step configs and facts,
    config counts and preemptions, and the blocks free at exit (``None`` on
    a dense cache)."""
    from repro_torch.launch import serve
    counts0, first, pre0 = dict(eng.config_counts), eng.step_count, \
        eng.preemptions
    reqs = serve.workload(6, 16)
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    recs = [r for r in eng.step_log if r["step"] >= first and r["config"]]
    return {"serve_s": time.monotonic() - t0,
            "launches": serve.launch_counts(),
            "streams": [r.generated for r in reqs],
            "finish": [str(r.finish_reason) for r in reqs],
            "configs": [r["config"] for r in recs],
            "facts": [(r["n_tokens"], r["prefill_tokens"], r["ctx_tokens"],
                       r["n_rows"], r["ctx_max"], r.get("spec_tokens", 0))
                      for r in recs],
            "counts": delta(eng.config_counts, counts0),
            "preemptions": eng.preemptions - pre0,
            "free": eng.kv.num_free_blocks if eng.paged else None,
            "blocks": eng.kv.num_blocks if eng.paged else None}


def layout_phase(torch):
    """Shift Parallelism's layouts on four ranks of (sp, tp) = (2, 2), one
    process each, all on the one card, with the collectives over gloo
    (NCCL refuses two ranks on one card): the fp32 full-width logits of
    both configs (2 layers) against the single-rank model's, then
    qwen3-8b at full width and depth in bf16 through the SPMD engine with
    the threshold policy. Returns rank 0's launch counts of the measured
    run."""
    import numpy as np
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    sp, tp = LAYOUT_GRID
    cfg = get_config("qwen3-8b")
    check_cfg = replace(cfg, num_layers=LAYOUT_CHECK_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    want, want_serial, want_mamba = layout_single_rank_logits(torch,
                                                              check_cfg)
    print(f"layout phase: sp={sp} x tp={tp} = {sp * tp} ranks, one process "
          f"each, all on {torch.cuda.device_count()} card(s): backend "
          "'gloo', because NCCL refuses two ranks of one communicator on "
          "one card; gloo stages the collectives of CUDA tensors through "
          "the host, so the times below are not NVLink times and not a "
          "speed of Shift Parallelism")
    full = cfg.num_params() * 2
    print(f"layout phase: memory reckoned: qwen3-8b bf16 {full / 1e9:.2f} "
          f"GB; per rank the base shard holds 1/{tp} ({full / tp / 1e9:.2f} "
          f"GB) and the shift shard 1/{sp * tp} ({full / (sp * tp) / 1e9:.2f}"
          f" GB): {full * (sp * tp) * (1 / tp + 1 / (sp * tp)) / 1e9:.1f} GB "
          "over the four processes, plus the pool and four CUDA contexts")
    t0 = time.monotonic()
    res = run_ranks(layout_rank, sp, tp, device="cuda", backend="gloo",
                    timeout_s=LAYOUT_TIMEOUT_S, args=(check_cfg,))
    print(f"layout phase: {sp * tp} ranks ran in "
          f"{time.monotonic() - t0:.1f} s")

    # fp32 logits of both configs, assembled by tp rank
    err = 0.0
    for config in ("base", "shift"):
        by_tp = {}
        for r in res:
            tpr, lg = r["fp32"][config]
            if tpr in by_tp:
                check(all(np.array_equal(a, b) for a, b in zip(by_tp[tpr], lg)),
                      f"layout {config}: replicas of tp rank {tpr} differ")
            by_tp[tpr] = lg
        for s, w in enumerate(want):
            got = torch.from_numpy(np.concatenate(
                [by_tp[t][s] for t in range(len(by_tp))], axis=-1))
            err = max(err, compare(torch, f"layout {config} fp32 logits "
                                   f"step {s}", got, w, 2e-3))
    print(f"layout phase: fp32 full-width ({LAYOUT_CHECK_LAYERS} layers) "
          f"logits of base and shift against the single-rank model: max "
          f"abs err {err} (tol 2e-3)")
    serial_err = {
        "qwen3-8b": serial_check_compare(torch, res, "fp32_serial",
                                         want_serial, "layout qwen3-8b"),
        "mamba2-1.3b": serial_check_compare(torch, res, "fp32_mamba2",
                                            want_mamba, "layout mamba2")}
    print(f"layout phase: fp32 full-width ({LAYOUT_CHECK_LAYERS} layers) "
          "serialized prefill then decode, base and shift, against the "
          "single-rank model (tol 2e-3): qwen3-8b on the dense cache and "
          f"the paged pool max abs err {serial_err['qwen3-8b']}; "
          f"mamba2-1.3b on the dense cache {serial_err['mamba2-1.3b']}")

    r0 = res[0]
    for r in res:
        check(r["streams"] == r0["streams"] and r["counts"] == r0["counts"],
              f"layout: rank {r['rank']}'s streams or configs differ from "
              "rank 0's")
        check(all(f == "ok" for f in r["finish"]) and
              all(len(s) == 16 for s in r["streams"]),
              f"layout: rank {r['rank']}: {r['finish']}")
        check(r["free"] == r["blocks"] - 1,
              f"layout: rank {r['rank']}: {r['free']} of {r['blocks']} "
              "blocks free at exit")
        check(r["invariance"], f"layout: rank {r['rank']}: the shared "
              "blocks changed or the pools differ")
    check(r0["counts"]["base"] > 0 and r0["counts"]["shift"] > 0,
          f"layout: configs used {r0['counts']}")
    steps = sum(r0["counts"].values())
    per_step = {"rmsnorm": 109, "paged_ragged_attention": 36}
    want_launches = {k: per_step.get(k, 0) * steps for k in r0["launches"]}
    for r in res:
        check(r["launches"] == want_launches,
              f"layout: rank {r['rank']}: launches {r['launches']} over "
              f"{steps} steps, want {want_launches}")
    check(r0["profiled_configs"] == {"base": 1, "shift": 3},
          f"layout: profiled steps {r0['profiled_configs']}")
    traced = {k: v for k, v in r0["traced"].items() if v}
    check(traced == {k: 4 * v for k, v in per_step.items()},
          f"layout: rank 0's trace holds {traced} over 4 steps")
    print("layout phase: " + r0["summary"].replace("\n", "; "))
    print(f"layout phase: served 6 requests x 16 tokens on every rank in "
          f"{r0['serve_s']:.2f} s, {steps} steps {r0['counts']}, "
          f"{r0['preemptions']} preemptions, {r0['free']} of {r0['blocks']} "
          f"blocks free at exit; all ranks' streams equal; per rank and step "
          f"{per_step['rmsnorm']} rmsnorm and {per_step['paged_ragged_attention']}"
          f" ragged launches (counters, and rank 0's profiler trace over 1 "
          f"base and 3 shift steps: {traced}; device busy "
          f"{r0['profiled_busy_ms'] / 4:.2f} ms per step)")
    stats = {}
    for config in ("base", "shift"):
        w = r0["walls"][config]
        n = len(w)
        tr = r0["traffic"][config]
        stats[config] = {
            "steps": n, "wall_ms_per_step": sum(w) / n * 1e3,
            "wall_ms": sorted(x * 1e3 for x in w),
            "all_to_all_bytes_per_step":
                tr.get("all_to_all_bytes", 0) / n,
            "all_reduce_bytes_per_step":
                tr.get("all_reduce_bytes", 0) / n,
            "all_gather_bytes_per_step":
                tr.get("all_gather_bytes", 0) / n,
            "collective_calls_per_step": {
                k[:-6]: v / n for k, v in tr.items() if k.endswith("_calls")}}
        print(f"layout phase: {config} steps on rank 0: {n}, wall "
              f"{stats[config]['wall_ms_per_step']:.2f} ms per step; per "
              f"step {stats[config]['all_to_all_bytes_per_step'] / 1e6:.3f} "
              f"MB all-to-all, "
              f"{stats[config]['all_reduce_bytes_per_step'] / 1e6:.3f} MB "
              f"all-reduce, "
              f"{stats[config]['all_gather_bytes_per_step'] / 1e3:.3f} kB "
              f"all-gather (payload handed over by the rank)")
    print("layout phase: one all-reduce of [8, 1, 4096] bf16 over the four "
          "ranks (a shift decode step makes 73), ms per call on ranks 0-3: "
          "card tensors " + ", ".join(f"{r['all_reduce_ms']['cuda']:.3f}"
                                      for r in res)
          + "; host tensors " + ", ".join(f"{r['all_reduce_ms']['cpu']:.3f}"
                                          for r in res))
    for r in res:
        print(f"layout phase: rank {r['rank']} (card {r['device']}): kv "
              f"slots {r['kv_slots']}, params base "
              f"{r['param_bytes']['base'] / 1e9:.2f} GB + shift "
              f"{r['param_bytes']['shift'] / 1e9:.2f} GB, pool "
              f"{r['pool_bytes'] / 1e6:.1f} MB, built in {r['build_s']:.1f} "
              f"s, peak device memory {r['peak_bytes'] / 1e9:.2f} GB")
    ps0 = r0["prefix_spec"]
    for r in res:
        ps = r["prefix_spec"]
        check(all(ps[k] == ps0[k] for k in
                  ("streams", "cached", "counts", "stats", "spec")),
              f"layout prefix + spec: rank {r['rank']} differs from rank 0")
        check(all(f == "ok" for f in ps["finish"])
              and all(len(t) == 16 for t in ps["streams"]),
              f"layout prefix + spec: rank {r['rank']}: {ps['finish']}")
        led = ps["ledger"]
        check(led["used"] == led["pinned"] == ps["stats"]["entries"],
              f"layout prefix + spec: rank {r['rank']}: blocks {led}")
        ps_steps = sum(ps["counts"].values())
        check(ps["launches"] == {k: per_step.get(k, 0) * ps_steps
                                 for k in ps["launches"]},
              f"layout prefix + spec: rank {r['rank']}: launches "
              f"{ps['launches']} over {ps_steps} steps")
    check(ps0["stats"]["hits"] > 0 and ps0["spec"][0] > 0,
          f"layout prefix + spec: prefix {ps0['stats']}, spec {ps0['spec']}")
    print(f"layout phase: prefix + spec (a {PS_SHARED}-token shared prefix, "
          f"k={PS_K}): equal on every rank; {sum(ps0['counts'].values())} "
          f"steps {ps0['counts']} in {ps0['serve_s']:.2f} s; cached tokens "
          f"{ps0['cached']}; prefix {ps0['stats']}; drafted {ps0['spec'][0]}"
          f", accepted {ps0['spec'][1]}, rollback blocks {ps0['spec'][2]}; "
          f"no block held at exit ({ps0['ledger']})")
    adaptive = layout_adaptive_check(res, per_step)
    serialized = layout_serialized_check(res)
    print(json.dumps({"layout": {
        "grid": {"sp": sp, "tp": tp}, "backend": "gloo",
        "fp32_max_abs_err": err, "configs": r0["counts"],
        "fp32_serialized_max_abs_err": serial_err,
        "adaptive": adaptive,
        "per_config": stats,
        "serialized": serialized,
        "all_reduce_ms": [r["all_reduce_ms"] for r in res],
        "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res]}}))
    print(f"card: {card_line()}")
    overhead = max(r["peak_bytes"] - sum(r["param_bytes"].values())
                   for r in res)
    return r0["launches"], ps0["launches"], r0["adaptive"]["launches"], \
        overhead, {f"layout_{k}_rank0": r0[k]["launches"]
                   for k in ("serial_paged", "serial_dense", "mamba2_dense")}


def layout_serialized_check(res):
    """The layout phase's serialized runs (qwen3-8b on the paged pool and
    on the dense cache, mamba2-1.3b on its dense fallback): every rank's
    streams and configs equal, both configs used, every request whole,
    launches exact per step of each kind and rank (counters) and in rank
    0's trace of one prefill and three decode steps, no block held, the
    dense cache's invariance after a base and a shift step. Prints the
    wall per step by config and kind on rank 0, the collective bytes per
    step and the peak memory per rank; returns them."""
    out = {}
    for key in ("serial_paged", "serial_dense", "mamba2_dense"):
        r0 = res[0][key]
        for r in res:
            x = r[key]
            check(x["streams"] == r0["streams"]
                  and x["counts"] == r0["counts"],
                  f"layout {key}: rank {r['rank']}'s streams or configs "
                  "differ from rank 0's")
            check(all(f == "ok" for f in x["finish"])
                  and all(len(t) == 16 for t in x["streams"]),
                  f"layout {key}: rank {r['rank']}: {x['finish']}")
            check(x["launches"] == x["want_launches"],
                  f"layout {key}: rank {r['rank']}: launches "
                  f"{x['launches']} over steps {x['kinds']}, want "
                  f"{x['want_launches']}")
            if x["free"] is not None:
                check(x["free"] == x["blocks"] - 1,
                      f"layout {key}: rank {r['rank']}: {x['free']} of "
                      f"{x['blocks']} blocks free at exit")
            if "invariance" in x:
                check(x["invariance"], f"layout {key}: rank {r['rank']}: "
                      "the dense cache's invariance failed")
        check(r0["counts"].get("base", 0) > 0
              and r0["counts"].get("shift", 0) > 0,
              f"layout {key}: configs used {r0['counts']}")
        check(r0["profiled_configs"] == {"base": 1, "shift": 3},
              f"layout {key}: profiled steps {r0['profiled_configs']}")
        traced = {k: v for k, v in r0["traced"].items() if v}
        check(traced == r0["traced_want"],
              f"layout {key}: rank 0's trace holds {traced}, want "
              f"{r0['traced_want']}")
        per = {}
        for k, w in r0["walls"].items():
            if not w:
                continue
            tr = r0["traffic"][k]
            per[k] = {"steps": len(w), "wall_ms_per_step":
                      sum(w) / len(w) * 1e3,
                      "bytes_per_step": {b[:-6]: v / len(w) for b, v in
                                         tr.items() if b.endswith("_bytes")}}
        single = SINGLE_RANK_STREAMS.get(
            {"serial_paged": "serialized_paged",
             "serial_dense": "serialized_dense"}.get(key, key))
        agree = None
        if single is not None:
            agree = 0
            for a, b in zip(r0["streams"], single):
                for x, y in zip(a, b):
                    if x != y:
                        break
                    agree += 1
            print(f"layout phase: {key}: {agree} of "
                  f"{sum(len(t) for t in single)} tokens agree with the "
                  "single-rank run's (phase 5) before their first "
                  "difference (bf16, collectives sum in another order; "
                  "reported only)")
        out[key] = {"configs": r0["counts"], "steps": r0["kinds"],
                    "single_rank_agreeing_tokens": agree,
                    "launches": r0["launches"], "per_config": per,
                    "profiled_busy_ms_per_step": r0["profiled_busy_ms"] / 4,
                    "serve_s": r0["serve_s"],
                    "peak_gb_per_rank": [r[key]["peak_bytes"] / 1e9
                                         for r in res]}
        print("layout phase: " + r0["summary"].replace("\n", "; "))
        print(f"layout phase: {key}: 6 requests x 16 tokens on every rank "
              f"in {r0['serve_s']:.2f} s, steps {r0['kinds']}, configs "
              f"{r0['counts']}; all ranks' streams equal; launches exact per "
              f"step ({r0['launches']}); rank 0's trace over 1 prefill and 3 "
              f"decode steps {traced}, device busy "
              f"{r0['profiled_busy_ms'] / 4:.2f} ms per step; peak GB per "
              "rank " + ", ".join(f"{r[key]['peak_bytes'] / 1e9:.2f}"
                                  for r in res))
        for k, v in per.items():
            print(f"layout phase: {key} {k} steps on rank 0: {v['steps']}, "
                  f"wall {v['wall_ms_per_step']:.2f} ms per step; per step "
                  + ", ".join(f"{b} {n / 1e6:.3f} MB" for b, n in
                              v["bytes_per_step"].items()))
    m = res[0]["mamba2_dense"]
    print(f"layout phase: mamba2_dense: {m['reason']}; rank SSD heads "
          + ", ".join(str(r["mamba2_dense"]["ssd_heads"]) for r in res)
          + f"; params per rank (base + shift) {m['param_bytes'] / 1e9:.2f} "
          "GB")
    return out


# ---------------------------------------------------------------------------
# phase 6b: qwen-30b-a3b's expert parallelism on the layouts
# ---------------------------------------------------------------------------
MOE_LAYOUT_MAX_LAYERS = 12      # the phase's depth at most (its time)
MOE_LAYOUT_HEADROOM = 0.2       # of the card's free memory, kept free


def moe_layout_rank(rank, groups, layers):
    """One rank of the MoE layout run (spawned by ``run_ranks``):
    qwen-30b-a3b at full width and ``layers`` deep in bf16, base on the
    (2, 2) grid (experts over sp with the all-to-all dispatch, their FF
    over tp) and shift on its ``to_shift()`` (experts over the whole model
    group, tokens replicated), over one pool, serving the serve workload
    under the threshold policy. Returns numpy-free results."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace_layers(get_config("qwen-30b-a3b"), layers)
    lay = Layout(sp=LAYOUT_GRID[0], tp=LAYOUT_GRID[1])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    models = []
    for layout in (lay, lay.to_shift()):
        m = Model(cfg, device="cuda", dtype=torch.bfloat16, lay=layout,
                  groups=groups)
        m.init_params(torch.Generator(device="cuda").manual_seed(0))
        models.append(m)
    base, shift = models
    torch.cuda.synchronize()
    out = {"rank": rank, "build_s": time.monotonic() - t0,
           "ep": {name: (m.params.layers[0].ffn.ep_axes,
                         m.params.layers[0].ffn.replicated,
                         tuple(m.params.layers[0].ffn.wi.shape))
                  for name, m in (("base", base), ("shift", shift))},
           "param_bytes": sum(p.numel() * p.element_size()
                              for m in models
                              for p in m.params.parameters())}
    eng = ShiftEngine(base, EngineConfig(), shift=shift)
    walls, traffic = timed_forward(torch, eng, groups)
    reqs = serve.workload(6, 16)
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    out.update(serve_s=time.monotonic() - t0,
               launches=serve.launch_counts(),
               streams=[r.generated for r in reqs],
               finish=[r.finish_reason for r in reqs],
               counts=dict(eng.config_counts),
               free=eng.kv.num_free_blocks, blocks=eng.kv.num_blocks,
               walls={k: list(v) for k, v in walls.items()},
               traffic={k: dict(v) for k, v in traffic.items()},
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def moe_layout_phase(torch):
    """qwen-30b-a3b's expert parallelism on four ranks of (sp, tp) = (2, 2),
    one process each on the one card over gloo, the parent holding
    nothing: full width, the depth cut to what fits with a fifth of the
    free memory spare (at most ``MOE_LAYOUT_MAX_LAYERS``). Base runs the
    a2a EP, shift the replicated EP; every rank's streams equal, both
    configs used, 3L+1 RMSNorm and L ragged launches per step and rank, no
    block held. Prints the all-to-all bytes per step by config. Returns
    rank 0's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    sp, tp = LAYOUT_GRID
    G = sp * tp
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"moe layout phase: the parent still holds "
          f"{held / 1e9:.2f} GB on the card")
    cfg = get_config("qwen-30b-a3b")
    free, total = torch.cuda.mem_get_info()
    vocab = 2 * cfg.vocab_size * cfg.d_model * 2     # table and head, bf16
    per_layer = moe_param_bytes(replace_layers(cfg, 1)) - vocab
    # per rank: the base shard holds 1/tp of the tables and 1/G of the
    # experts, the shift shard 1/G of both; the layer's attention and norms
    # are counted whole for each, an upper bound
    expert = cfg.moe.num_experts * 3 * cfg.d_model * cfg.moe.d_ff_expert * 2
    rank_fixed = vocab / tp + vocab / G + 2e9        # + context, pool, staging
    rank_layer = 2 * expert / G + 2 * (per_layer - expert)
    budget = free * (1 - MOE_LAYOUT_HEADROOM)
    fit = int((budget / G - rank_fixed) // rank_layer)
    layers = min(fit, MOE_LAYOUT_MAX_LAYERS)
    check(layers >= 2, f"moe layout phase: {fit} layers fit")
    print(f"moe layout phase: memory reckoned per rank: the tables "
          f"{(vocab / tp + vocab / G) / 1e9:.2f} GB (base 1/{tp}, shift "
          f"1/{G}) + 2 GB (context, pool, staging) + "
          f"{rank_layer / 1e9:.3f} GB per layer (1/{G} of the experts in "
          f"each config, the attention whole): {fit} layers fit in "
          f"{budget / 1e9:.1f} GB ({1 - MOE_LAYOUT_HEADROOM:.0%} of "
          f"{free / 1e9:.1f} GB free) over {G} ranks; running {layers} "
          f"(at most {MOE_LAYOUT_MAX_LAYERS}, the phase's time)")
    t0 = time.monotonic()
    res = run_ranks(moe_layout_rank, sp, tp, device="cuda", backend="gloo",
                    timeout_s=LAYOUT_TIMEOUT_S, args=(layers,))
    print(f"moe layout phase: {G} ranks ran in {time.monotonic() - t0:.1f} s")
    r0 = res[0]
    per_step = {"rmsnorm": 3 * layers + 1, "paged_ragged_attention": layers}
    steps = sum(r0["counts"].values())
    for r in res:
        check(r["streams"] == r0["streams"] and r["counts"] == r0["counts"],
              f"moe layout: rank {r['rank']}'s streams or configs differ "
              "from rank 0's")
        check(all(f == "ok" for f in r["finish"])
              and all(len(s) == 16 for s in r["streams"]),
              f"moe layout: rank {r['rank']}: {r['finish']}")
        check(r["free"] == r["blocks"] - 1, f"moe layout: rank "
              f"{r['rank']}: {r['free']} of {r['blocks']} blocks free")
        check(r["launches"] == {k: per_step.get(k, 0) * steps
                                for k in r["launches"]},
              f"moe layout: rank {r['rank']}: launches {r['launches']} "
              f"over {steps} steps, want {per_step} per step")
        ffn_loc = cfg.moe.d_ff_expert
        check(r["ep"]["base"][:2] == (("sp",), False)
              and r["ep"]["shift"][:2] == (("tp", "sp"), True)
              and r["ep"]["base"][2] == (cfg.moe.num_experts // sp,
                                         cfg.d_model, ffn_loc // tp)
              and r["ep"]["shift"][2] == (cfg.moe.num_experts // G,
                                          cfg.d_model, ffn_loc),
              f"moe layout: rank {r['rank']}: EP {r['ep']}")
        check(r["traffic"]["base"].get("all_to_all_calls", 0) > 0,
              f"moe layout: rank {r['rank']}: no exchange in base steps")
    check(r0["counts"]["base"] > 0 and r0["counts"]["shift"] > 0,
          f"moe layout: configs used {r0['counts']}")
    stats = {}
    for config in ("base", "shift"):
        n = len(r0["walls"][config])
        tr = r0["traffic"][config]
        stats[config] = {
            "steps": n,
            "wall_ms_per_step": sum(r0["walls"][config]) / n * 1e3,
            "all_to_all_bytes_per_step": tr.get("all_to_all_bytes", 0) / n,
            "all_to_all_calls_per_step": tr.get("all_to_all_calls", 0) / n,
            "all_reduce_bytes_per_step": tr.get("all_reduce_bytes", 0) / n}
        kind = "a2a" if config == "base" else "replicated"
        print(f"moe layout phase: {config} ({kind} EP) steps on rank 0: "
              f"{n}, wall "
              f"{stats[config]['wall_ms_per_step']:.2f} ms per step; per "
              f"step {stats[config]['all_to_all_bytes_per_step'] / 1e6:.3f} "
              f"MB in {stats[config]['all_to_all_calls_per_step']:.0f} "
              f"all-to-all calls (Ulysses and the expert dispatch), "
              f"{stats[config]['all_reduce_bytes_per_step'] / 1e6:.3f} MB "
              "all-reduce (payload handed over by the rank)")
    print(f"moe layout phase: qwen-30b-a3b full width, {layers} layers, "
          f"served 6 requests x 16 tokens on every rank in "
          f"{r0['serve_s']:.2f} s, {steps} steps {r0['counts']}; all "
          f"ranks' streams equal; per rank and step {per_step}; base "
          f"experts {r0['ep']['base']}, shift {r0['ep']['shift']}; peak "
          "device memory per rank "
          + ", ".join(f"{r['peak_bytes'] / 1e9:.2f}" for r in res) + " GB")
    wall = time.monotonic() - t_phase
    print(json.dumps({"moe_layout": {
        "grid": {"sp": sp, "tp": tp}, "backend": "gloo", "layers": layers,
        "layers_fit": fit, "configs": r0["counts"], "per_config": stats,
        "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res],
        "phase_wall_s": wall}}))
    print(f"moe layout phase: {wall:.1f} s in all; card: {card_line()}")
    return r0["launches"]


def layout_adaptive_check(res, per_step):
    """The layout phase's adaptive runs (``--adaptive``'s policy over the
    grid): every rank's streams, configs and facts equal, and the streams
    equal to those of the threshold run that makes the same per-step
    configs; each step's config the port policy's answer to its recorded
    facts; launches exact per step; no block held. Prints the steps by
    config of both runs and, without a limit, how many tokens agree with
    the default threshold run's streams."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import adaptive_policy
    sp, tp = LAYOUT_GRID
    policy = adaptive_policy(get_config("qwen3-8b"), sp, tp)
    a0 = res[0]["adaptive"]
    for r in res:
        a = r["adaptive"]
        check(all(a[k] == a0[k] for k in ("streams", "configs", "facts",
                                          "counts")),
              f"layout adaptive: rank {r['rank']} differs from rank 0")
        check(all(f == "ok" for f in a["finish"])
              and all(len(t) == 16 for t in a["streams"]),
              f"layout adaptive: rank {r['rank']}: {a['finish']}")
        check(a["free"] == a["blocks"] - 1,
              f"layout adaptive: rank {r['rank']}: {a['free']} of "
              f"{a['blocks']} blocks free at exit")
        steps = sum(a["counts"].values())
        check(a["launches"] == {k: per_step.get(k, 0) * steps
                                for k in a["launches"]},
              f"layout adaptive: rank {r['rank']}: launches "
              f"{a['launches']} over {steps} steps")
        for config, (n, npf, ctx, rows, cmax, spec) in zip(a["configs"],
                                                           a["facts"]):
            want = policy.use_base(n, npf, ctx_tokens=ctx, n_rows=rows,
                                   ctx_max=cmax, spec_tokens=spec)
            check(config == ("base" if want else "shift"),
                  f"layout adaptive: rank {r['rank']}: a {config} step "
                  f"against the policy's answer for {(n, npf, ctx, rows)}")
        same = r["same_configs"]
        check(same["configs"] == a["configs"]
              and same["streams"] == a["streams"],
              f"layout adaptive: rank {r['rank']}: the streams differ from "
              f"the threshold run of the same configs ({same['configs']} "
              f"against {a['configs']})")
    agree = sum(next((i for i, (x, y) in enumerate(zip(s, t)) if x != y),
                     min(len(s), len(t)))
                for s, t in zip(a0["streams"], res[0]["streams"]))
    total = sum(len(s) for s in a0["streams"])
    thr = res[0]["same_configs"]
    print(f"layout phase: adaptive policy (the cost model over sp={sp} x "
          f"tp={tp}, H100 data-sheet constants): steps by config "
          f"{a0['counts']} (the threshold run: {res[0]['counts']}); every "
          "rank's streams equal, and equal to those of the threshold run "
          f"that makes the same per-step configs ({thr['counts']}); each "
          "step's config the policy's answer to its recorded facts; "
          f"{per_step['rmsnorm']} rmsnorm and "
          f"{per_step['paged_ragged_attention']} ragged launches per step; "
          f"{agree} of {total} tokens agree with the default threshold "
          f"run's streams before their first difference; served in "
          f"{a0['serve_s']:.2f} s")
    return {"counts": a0["counts"], "threshold_counts": res[0]["counts"],
            "tokens_agreeing_with_threshold_run": [agree, total],
            "serve_s": a0["serve_s"]}



DP_TIMEOUT_S = 600
DP_GRID = (2, 2, 2)             # (dp, sp, tp), the reference's mesh222
DP_GRID_MIN_LAYERS = 8
DP_HEADROOM = 0.2               # of the card's free memory, kept free


def one_row_view(model):
    """``model`` (a rank of dp rows with a model group of one, which holds
    the whole model) as the trivial layout's model over the same parameter
    tensors: the layers' computation is the same, only the dp row slicing
    and the DP gather go. A new engine gives it its own pool."""
    from repro_torch.parallel import Layout, Shard
    view = model.view()
    view.lay, view.shard = Layout(), Shard()
    return view


def timed_forward(torch, eng, groups, kinds=("forward",)):
    """Wrap the engine's entries of the step tables ``kinds`` (the mixed
    ``forward``, or the serialized ``prefill`` and ``decode``) so that each
    call's wall (after a device sync) and the collective traffic it made
    are kept by config (by "config kind" for more than one table)."""
    from collections import Counter
    walls, traffic = {}, {}

    def timed(entry, key):
        def call(*arrays):
            before = Counter(groups.traffic)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = entry(*arrays)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t)
            traffic[key].update(Counter(groups.traffic) - before)
            return res
        return call

    for kind in kinds:
        table = getattr(eng.deploy, kind)
        for config in ("base", "shift"):
            key = config if len(kinds) == 1 else f"{config} {kind}"
            walls[key], traffic[key] = [], Counter()
            table[config] = timed(table[config], key)
    return walls, traffic


def dp_measured_run(torch, eng, reqs):
    """Serve ``reqs`` on ``eng`` with every launch counter set to 0 just
    before and read just after. Returns the numbers of the run."""
    from repro_torch.launch import serve
    fresh_obs(eng)              # the dump and the counts cover this run
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    t_first = max(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    dec_tok = sum(len(r.generated) - 1 for r in reqs)
    kv = eng.kv
    return {"wall_s": wall, "launches": serve.launch_counts(),
            "streams": [r.generated for r in reqs],
            "rows": [r.row for r in reqs],
            "finish": [str(r.finish_reason) for r in reqs],
            "cached": [r.cached_tokens for r in reqs],
            "counts": dict(eng.config_counts),
            "ttft_ms": [(r.first_token_time - r.arrival) * 1e3 for r in reqs],
            "decode_tokens_per_s": dec_tok / (t_last - t_first),
            "stats": eng.prefix_stats.as_dict(),
            "spec": spec_counts(eng),
            "dump": eng.obs.dump(),
            "per_row": [{
                "requests": sum(1 for r in reqs if r.row == row),
                "hits": (eng.prefix_rows[row].stats()["hits"]
                         if eng.prefix_rows else 0),
                "tokens_saved": (eng.prefix_rows[row].stats()["tokens_saved"]
                                 if eng.prefix_rows else 0),
                "free_blocks": kv.row_free_blocks(row),
                "used": kv.allocators[row].num_used,
                "pinned": (len(eng.prefix_rows[row].blocks())
                           if eng.prefix_rows else 0),
                "entries": (len(eng.prefix_rows[row]) if eng.prefix_rows
                            else 0)} for row in range(kv.dp)]}


def fit(a, shape):
    """``a`` zero-padded or cut to ``shape``; None when the cut drops a
    nonzero entry."""
    import numpy as np
    out = np.zeros(shape, a.dtype)
    both = tuple(slice(0, min(n, m)) for n, m in zip(a.shape, shape))
    out[both] = a[both]
    if np.count_nonzero(a) != np.count_nonzero(out):
        return None
    return out


def renamed(a, b):
    """True when block tables ``a`` are ``b`` with the block ids renamed
    one to one (0, the null block, to itself): two pools that served other
    work before hold their free lists in other orders."""
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return (all((x == 0) == (y == 0) for x, y in pairs)
            and len(pairs) == len({x for x, _ in pairs})
            == len({y for _, y in pairs}))


def pin_to_dp_steps(eng, steps, row, dp):
    """Pin a dp=1 engine fed the requests routed to dp row ``row`` to that
    row's segment of a recorded dp run (``recorded_forward``'s steps), so
    that it steps the dp batch's shapes: its k-th mixed step is fitted to
    the k-th recorded step that gave the row work (that step's segment
    width, chunk bucket and table width; only zero padding may be added or
    cut) and runs at that step's config and verify width, and the engine
    reads its own columns of the result. Raises when the fitted inputs
    differ from the segment's (block tables up to a renaming of block ids,
    ``renamed``), i.e. when the dp=1 engine scheduled, placed or mapped
    otherwise than the dp row did. Returns the list of the
    steps it ran and the number of the row's segments, to be compared once
    the engine is idle."""
    import numpy as np
    segs = []
    for config, n_last, arrays, _ in steps:
        seg = arrays[0].shape[0] // dp
        part = [a[row * seg:(row + 1) * seg] for a in arrays]
        if part[1].any():                  # q_lens: the row had work
            segs.append((config, n_last, part))
    ran = []
    forward_at = eng.deploy.forward_at

    def pinned(config, n_last=1):
        def call(*arrays):
            k = len(ran)
            if k >= len(segs):
                raise RuntimeError(f"row {row}'s dp=1 engine takes step {k}; "
                                   f"the dp row took {len(segs)}")
            rec_config, rec_n, want = segs[k]
            got = [fit(a, w.shape) for a, w in zip(arrays, want)]
            if (n_last > rec_n or any(g is None for g in got)
                    or not all(np.array_equal(g, w)
                               for g, w in zip(got[:3], want[:3]))
                    or not renamed(got[3], want[3])):
                raise RuntimeError(
                    f"row {row}'s dp=1 engine, step {k}: inputs "
                    f"{[a.tolist() for a in arrays]} (verify width {n_last}) "
                    f"do not fit the dp row's segment "
                    f"{[w.tolist() for w in want]} (width {rec_n})")
            ran.append(k)
            res = forward_at(rec_config, rec_n)(*got)
            if rec_n > 1:
                res = res[:, rec_n - n_last:]
                if n_last == 1:
                    res = res[:, 0]
            return res
        return call

    eng.deploy.forward_at = pinned
    return ran, len(segs)


def one_row_streams(torch, model, reqs, row, kw, steps):
    """The streams of a dp=1 engine (half the slots, eager tables) over
    ``model``'s weights, fed the requests of ``reqs`` routed to ``row`` and
    pinned to the dp run's ``steps`` (``pin_to_dp_steps``): {rid:
    tokens}."""
    from repro_torch.engine import EngineConfig, Request, ShiftEngine
    from repro_torch.engine.deployment import Deployment
    view = one_row_view(model)
    eng = ShiftEngine(view, EngineConfig(max_slots=4, **kw))
    eng.deploy = Deployment.build(eng.base, eng.shift, mixed=True,
                                  paged=True, graphed=False)
    ran, n = pin_to_dp_steps(eng, steps, row, model.lay.dp)
    sub = [Request(r.rid, list(r.prompt), max_new_tokens=r.max_new_tokens)
           for r in reqs if r.row == row]
    for r in sub:
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    if len(ran) != n:
        raise RuntimeError(f"row {row}'s dp=1 engine took {len(ran)} steps; "
                           f"the dp row took {n}")
    return {r.rid: r.generated for r in sub}


def dp_rank(rank, groups):
    """One rank of the (dp, sp, tp) = (2, 1, 1) run (spawned by
    ``run_ranks``): qwen3-8b at full width and depth in bf16, the whole
    model and its row's pool, serving the serve workload and then the
    prefix + spec workload; each beside a dp=1 engine over the same
    weights fed this rank's row's requests at the dp batch's shapes
    (``pin_to_dp_steps``). Returns numpy results; only
    the parent prints."""
    import torch
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.launch import serve
    from repro_torch.spec import SpecConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "device": torch.cuda.current_device()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = serve.build_engine("qwen3-8b", device="cuda", dtype=torch.bfloat16,
                             dp=2, groups=groups)
    torch.cuda.synchronize()
    row = eng.model.shard.dp_rank
    out["row"], out["build_s"] = row, time.monotonic() - t0
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in eng.model.params.parameters())
    pool = eng.model.pool
    out["pool_bytes"] = 2 * pool.k.numel() * pool.k.element_size()
    out["pool_blocks"] = pool.k.shape[1]
    walls, traffic = timed_forward(torch, eng, groups)
    for r in serve.workload(6, 16):            # warm-up
        eng.submit(r)
    eng.run_until_idle()
    for config in walls:
        walls[config].clear()
        traffic[config].clear()
    steps = recorded_forward(eng)
    reqs = serve.workload(6, 16)
    out["plain"] = dp_measured_run(torch, eng, reqs)
    out["plain"]["walls"] = {k: list(v) for k, v in walls.items()}
    out["plain"]["traffic"] = {k: dict(v) for k, v in traffic.items()}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.print_summary(eng)
    out["summary"] = text.getvalue()
    model = eng.model
    del eng
    gc.collect()
    out["plain"]["one_row"] = one_row_streams(torch, model, reqs, row, {},
                                              steps)

    # the prefix cache and k=4 drafts on the same model, a new engine
    ps_kw = {"prefix": PrefixConfig(enabled=True), "spec": SpecConfig(k=PS_K)}
    ps = ShiftEngine(model, EngineConfig(**ps_kw))
    steps = recorded_forward(ps)
    reqs = serve.workload(6, 16, shared_prefix=PS_SHARED)
    out["prefix_spec"] = dp_measured_run(torch, ps, reqs)
    out["prefix_spec"]["traffic"] = dict(groups.traffic)
    del ps
    gc.collect()
    out["prefix_spec"]["one_row"] = one_row_streams(torch, model, reqs, row,
                                                    ps_kw, steps)
    out["snapshot"] = dp_snapshot_run(torch, model)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def dp_snapshot_run(torch, model):
    """One dp rank's snapshot drill: the serve workload on a new engine,
    a snapshot of this rank's shard after step 4, the run to idle; then a
    new engine on this rank restores the snapshot and runs to idle."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    gc.collect()
    eng = ShiftEngine(model, EngineConfig())
    reqs = serve.workload(6, 16)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    snap, snap_ms = timed_ms(torch, eng.snapshot)
    eng.run_until_idle()
    whole = [r.generated for r in reqs]
    del eng
    gc.collect()
    eng = ShiftEngine(model, EngineConfig())
    _, restore_ms = timed_ms(torch, lambda: eng.restore(snap))
    eng.run_until_idle()
    return {"whole": whole, "restored": [eng.stream(r.rid) for r in reqs],
            "rank": snap["rank"], "step": snap["step_count"],
            "bytes": sum(t.numel() * t.element_size()
                         for t in snap["cache"].values()),
            "snapshot_ms": snap_ms, "restore_ms": restore_ms}


def grid_cfg(layers):
    from dataclasses import replace
    from repro_torch.configs import get_config
    return replace(get_config("qwen3-8b"), num_layers=layers)


def grid_models(torch, lay, groups, layers):
    """This rank's base model on ``lay`` and shift model on its
    ``to_shift()``, bf16, drawn from the generator seeded 0."""
    from repro_torch.models import Model
    out = []
    for layout in (lay, lay.to_shift()):
        m = Model(grid_cfg(layers), device="cuda", dtype=torch.bfloat16,
                  lay=layout, groups=groups)
        m.init_params(torch.Generator(device="cuda").manual_seed(0))
        out.append(m)
    return out


def recorded_forward(eng):
    """Wrap the engine's ``forward_at`` so that each mixed step's config,
    verify width, host inputs and the (gathered) tokens it returned are
    kept, in order."""
    steps = []
    forward_at = eng.deploy.forward_at

    def recorded(config, n_last=1):
        entry = forward_at(config, n_last)

        def call(*arrays):
            res = entry(*arrays)
            steps.append((config, n_last, [a.copy() for a in arrays],
                          res.cpu().numpy()))
            return res
        return call

    eng.deploy.forward_at = recorded
    return steps


def dp_grid_rank(rank, groups, layers):
    """One rank of the (2, 2, 2) run: the cut-depth qwen3-8b at full width
    in bf16, base on the grid and shift on its ``to_shift()`` over this
    rank's row's pool, serving the serve workload; the measured run's
    steps (config, inputs, gathered tokens) are kept for the replay."""
    import torch
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    dp, sp, tp = DP_GRID
    base, shift = grid_models(torch, Layout(dp=dp, sp=sp, tp=tp), groups,
                              layers)
    eng = ShiftEngine(base, EngineConfig(), shift=shift)
    walls, traffic = timed_forward(torch, eng, groups)
    for r in serve.workload(6, 16):            # warm-up
        eng.submit(r)
    eng.run_until_idle()
    for config in walls:
        walls[config].clear()
        traffic[config].clear()
    steps = recorded_forward(eng)
    out = dp_measured_run(torch, eng, serve.workload(6, 16))
    out.update(rank=rank, row=base.shard.dp_rank, steps=steps,
               walls={k: list(v) for k, v in walls.items()},
               traffic={k: dict(v) for k, v in traffic.items()},
               param_bytes=sum(p.numel() * p.element_size()
                               for m in (base, shift)
                               for p in m.params.parameters()),
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def grid_split_rank(rank, groups, layers, steps, split):
    """One rank of (1, 2, 2) on the same weights. First the replay: each
    dp row's segment of every recorded (2, 2, 2) step, in order, through
    the (1, 2, 2) model of the step's config on a fresh pool of one row's
    65 blocks; returns per row whether every step's tokens equal the
    segment's gathered tokens bitwise. Then the (1, 2, 2) engine (half the
    slots, a new engine each) fed each row's routed requests, pinned to
    that row's segments (``pin_to_dp_steps``); returns its streams by
    rid."""
    import numpy as np
    import torch
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.parallel import Layout
    dp, sp, tp = DP_GRID
    base, shift = grid_models(torch, Layout(sp=sp, tp=tp), groups, layers)
    replay = []
    for d in range(dp):
        base.init_paged_cache(65, 16)
        shift.adopt_paged_cache(base)
        equal = []
        for config, n_last, (toks, qlen, offs, bt), want in steps:
            seg = toks.shape[0] // dp
            rows = slice(d * seg, (d + 1) * seg)
            m = base if config == "base" else shift
            got, _ = m.forward_mixed(toks[rows], qlen[rows], offs[rows],
                                     bt[rows], n_last=n_last)
            equal.append(bool(np.array_equal(got.cpu().numpy(), want[rows])))
        replay.append(equal)
    streams = {}
    for d, rids in enumerate(split):
        eng = ShiftEngine(base, EngineConfig(max_slots=4), shift=shift)
        ran, n = pin_to_dp_steps(eng, steps, d, dp)
        reqs = [r for r in serve.workload(6, 16) if r.rid in rids]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        if len(ran) != n:
            raise RuntimeError(f"row {d}'s (1, 2, 2) engine took {len(ran)} "
                               f"steps; the dp row took {n}")
        streams.update({r.rid: r.generated for r in reqs})
        del eng
        gc.collect()
    torch.cuda.synchronize()
    return {"replay": replay, "streams": streams}


def per_config(walls, traffic):
    out = {}
    for config, w in walls.items():
        n = len(w)
        if not n:
            continue
        out[config] = {"steps": n, "wall_ms_per_step": sum(w) / n * 1e3,
                       "bytes_per_step": {
                           k[:-6]: v / n for k, v in traffic[config].items()
                           if k.endswith("_bytes")},
                       "calls_per_step": {
                           k[:-6]: v / n for k, v in traffic[config].items()
                           if k.endswith("_calls")}}
    return out


def dp_phase(torch, overhead_bytes):
    """Data parallelism on the one card, every rank its own process and the
    collectives over gloo: (dp, sp, tp) = (2, 1, 1) at full width and
    depth, then (2, 2, 2) at full width with the depth cut to fit.
    ``overhead_bytes`` is a rank's measured peak beyond its parameters in
    the layout phase (its pool, activations and staging). Returns rank 0's
    launch counts of each measured run."""
    import numpy as np
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.obs import build_report, chrome_trace, format_report
    per_step = {"rmsnorm": 109, "paged_ragged_attention": 36}
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"dp phase: the parent still holds {held / 1e9:.2f} "
          "GB on the card")
    free, total = torch.cuda.mem_get_info()
    # what this process holds outside the allocator: its CUDA context
    ctx = total - free - torch.cuda.memory_reserved()
    full = grid_cfg(36).num_params() * 2
    print(f"dp phase: card {total / 1e9:.2f} GB, {free / 1e9:.2f} GB free "
          f"with the parent's context ({ctx / 1e9:.2f} GB) and "
          f"{held / 1e6:.1f} MB allocated by the parent; gloo stages the "
          "collectives through the host, so the walls below are not a speed "
          "of data parallelism")
    print(f"dp phase (2, 1, 1): memory reckoned: 2 ranks x (qwen3-8b bf16 "
          f"{full / 1e9:.2f} GB + a row pool of 65 blocks x 16 tokens x 36 "
          f"layers, {2 * 65 * 16 * 36 * 8 * 128 * 2 / 1e6:.1f} MB, + its "
          f"dp=1 twin's pool, + ~{(overhead_bytes + ctx) / 1e9:.2f} GB "
          f"overhead) = "
          f"{2 * (full + 2 * 2 * 65 * 16 * 36 * 8 * 128 * 2 + overhead_bytes + ctx) / 1e9:.1f}"
          " GB")
    t0 = time.monotonic()
    res = run_ranks(dp_rank, 1, 1, dp=2, device="cuda", backend="gloo",
                    timeout_s=DP_TIMEOUT_S)
    print(f"dp phase (2, 1, 1): 2 ranks ran in {time.monotonic() - t0:.1f} s")
    r0 = res[0]
    for key, label in (("plain", "serve workload"),
                       ("prefix_spec", f"prefix + spec (a {PS_SHARED}-token "
                                       f"shared prefix, k={PS_K})")):
        a = r0[key]
        for r in res:
            b = r[key]
            check(all(b[k] == a[k] for k in ("streams", "rows", "counts",
                                             "stats", "spec", "cached")),
                  f"dp (2, 1, 1) {label}: rank {r['rank']} differs from rank "
                  "0")
            check(all(f == "ok" for f in b["finish"])
                  and all(len(t) == 16 for t in b["streams"]),
                  f"dp (2, 1, 1) {label}: rank {r['rank']}: {b['finish']}")
            for rid, toks in b["one_row"].items():
                check(toks == a["streams"][rid],
                      f"dp (2, 1, 1) {label}: request {rid} of row "
                      f"{r['row']}: {a['streams'][rid]} against the dp=1 "
                      f"engine's {toks}")
            check(sorted(b["one_row"]) == [i for i, row in
                                           enumerate(a["rows"])
                                           if row == r["row"]],
                  f"dp (2, 1, 1) {label}: rank {r['rank']}'s dp=1 engine "
                  "served other requests")
            steps = sum(b["counts"].values())
            check(b["launches"] == {k: per_step.get(k, 0) * steps
                                    for k in b["launches"]},
                  f"dp (2, 1, 1) {label}: rank {r['rank']}: launches "
                  f"{b['launches']} over {steps} steps")
        check(set(a["rows"]) == {0, 1}, f"dp (2, 1, 1) {label}: rows "
              f"{a['rows']}")
        for r in res:
            check(timeless(r[key]["dump"]) == timeless(a["dump"]),
                  f"dp (2, 1, 1) {label}: rank {r['rank']}'s obs dump "
                  "differs from rank 0's (time fields dropped)")
        lanes = {e["args"]["name"] for e in chrome_trace(a["dump"])[
            "traceEvents"] if e["name"] == "thread_name"}
        check({"requests:row0", "requests:row1"} <= lanes,
              f"dp (2, 1, 1) {label}: trace lanes {lanes}")
        for row, pr in enumerate(a["per_row"]):
            check(pr["used"] == pr["pinned"] == pr["entries"],
                  f"dp (2, 1, 1) {label}: row {row} holds blocks: {pr}")
        steps = sum(a["counts"].values())
        print(f"dp phase (2, 1, 1) {label}: equal on both ranks and equal to "
              f"each rank's dp=1 engine fed its row's requests at the dp "
              f"batch's shapes (every step's inputs equal the row's "
              f"segment); rows "
              f"{a['rows']}; {steps} steps {a['counts']} in "
              f"{a['wall_s']:.2f} s; TTFT ms "
              + ", ".join(f"{t:.1f}" for t in a["ttft_ms"])
              + f"; decode {a['decode_tokens_per_s']:.1f} tokens/s; "
              f"launches per step and rank {per_step} (counters)")
        for row, pr in enumerate(a["per_row"]):
            print(f"dp phase (2, 1, 1) {label}: row {row}: "
                  f"{pr['requests']} requests, {pr['hits']} hits, "
                  f"{pr['tokens_saved']} tokens saved, "
                  f"{pr['free_blocks']} free blocks at exit")
    for r in res:
        sn = r["snapshot"]
        check(sn["restored"] == sn["whole"] == r0["snapshot"]["whole"]
              and sn["rank"] == r["rank"] and sn["step"] == 4,
              f"dp (2, 1, 1) snapshot: rank {r['rank']}: the run restored "
              "from step 4 differs from the uninterrupted one")
        print(f"dp phase (2, 1, 1) snapshot: rank {r['rank']} (row "
              f"{r['row']}) snapshot of its shard after step 4, "
              f"{sn['bytes']} bytes in {sn['snapshot_ms']:.2f} ms, restored "
              f"into a new engine in {sn['restore_ms']:.2f} ms: the rest of "
              f"the run equals the uninterrupted one bitwise; card: "
              f"{card_line()}")
    ps = r0["prefix_spec"]
    check(ps["stats"]["hits"] > 0 and ps["spec"][0] > 0,
          f"dp (2, 1, 1) prefix + spec: prefix {ps['stats']}, spec "
          f"{ps['spec']}")
    plain = r0["plain"]
    stats = per_config(plain["walls"], plain["traffic"])
    for config, st in stats.items():
        print(f"dp phase (2, 1, 1): {config} steps on rank 0: {st['steps']}, "
              f"wall {st['wall_ms_per_step']:.2f} ms per step; per step "
              f"{st['bytes_per_step'].get('dp_all_gather', 0):.0f} bytes in "
              f"{st['calls_per_step'].get('dp_all_gather', 0):.0f} "
              "dp_all_gather call(s) (payload handed over by the rank)")
    print("dp phase (2, 1, 1): " + r0["summary"].replace("\n", "; "))
    print("dp phase (2, 1, 1): both ranks' obs dumps equal once the time "
          "fields are dropped, a trace lane per dp row; rank 0's report "
          "of the serve workload:")
    print(format_report(build_report(plain["dump"])))
    for r in res:
        print(f"dp phase (2, 1, 1): rank {r['rank']} (card {r['device']}, row "
              f"{r['row']}): params {r['param_bytes'] / 1e9:.2f} GB, pool "
              f"{r['pool_blocks']} blocks {r['pool_bytes'] / 1e6:.1f} MB, "
              f"built in {r['build_s']:.1f} s, peak device memory "
              f"{r['peak_bytes'] / 1e9:.2f} GB")
    dp211 = {"per_config": stats, "ttft_ms": plain["ttft_ms"],
             "decode_tokens_per_s": plain["decode_tokens_per_s"],
             "wall_s": plain["wall_s"], "rows": plain["rows"],
             "per_row": plain["per_row"],
             "prefix_spec": {k: ps[k] for k in (
                 "wall_s", "counts", "stats", "spec", "per_row", "ttft_ms",
                 "decode_tokens_per_s")},
             "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res]}
    del res
    gc.collect()

    # (2, 2, 2): the depth that fits eight ranks with the headroom
    dp, sp, tp = DP_GRID
    c1, c2 = grid_cfg(1).num_params(), grid_cfg(2).num_params()
    per_layer, fixed = (c2 - c1) * 2, (c1 - (c2 - c1)) * 2
    share = 1 / tp + 1 / (sp * tp)             # base shard + shift shard
    free, _ = torch.cuda.mem_get_info()
    room = (1 - DP_HEADROOM) * free
    n = dp * sp * tp

    def need(layers):
        return n * (share * (fixed + layers * per_layer) + overhead_bytes
                    + ctx)

    layers = max((L for L in range(1, 37) if need(L) <= room), default=0)
    print(f"dp phase (2, 2, 2): memory reckoned: per rank the base shard "
          f"(1/{tp}) and the shift shard (1/{sp * tp}) of "
          f"{fixed / 1e9:.2f} GB (embedding and head) + L x "
          f"{per_layer / 1e9:.3f} GB, + {overhead_bytes / 1e9:.2f} GB "
          f"overhead (measured in the layout phase) + {ctx / 1e9:.2f} GB "
          f"context; {n} ranks need {need(36) / 1e9:.1f} GB at the full 36 "
          f"layers against {room / 1e9:.1f} GB ({1 - DP_HEADROOM:.0%} of "
          f"{free / 1e9:.1f} GB free): depth cut to {layers} layers "
          f"({need(layers) / 1e9:.1f} GB); width kept (d_model 4096, 32 q "
          "and 8 kv heads, vocabulary 151936)")
    check(layers >= DP_GRID_MIN_LAYERS, f"dp (2, 2, 2): {layers} layers fit, "
          f"fewer than {DP_GRID_MIN_LAYERS}")
    t0 = time.monotonic()
    grid = run_ranks(dp_grid_rank, sp, tp, dp=dp, device="cuda",
                     backend="gloo", timeout_s=DP_TIMEOUT_S, args=(layers,))
    t_grid = time.monotonic() - t0
    g0 = grid[0]
    split = [[i for i, row in enumerate(g0["rows"]) if row == d]
             for d in range(dp)]
    t0 = time.monotonic()
    ref = run_ranks(grid_split_rank, sp, tp, device="cuda", backend="gloo",
                    timeout_s=DP_TIMEOUT_S, args=(layers, g0["steps"], split))
    t_ref = time.monotonic() - t0
    per_step_grid = {"rmsnorm": 3 * layers + 1,
                     "paged_ragged_attention": layers}
    for g in grid:
        check(all(g[k] == g0[k] for k in ("streams", "rows", "counts")),
              f"dp (2, 2, 2): rank {g['rank']} differs from rank 0")
        check(len(g["steps"]) == len(g0["steps"]) and all(
            a[:2] == b[:2] and all(np.array_equal(x, y)
                                   for x, y in zip(a[2], b[2]))
            and np.array_equal(a[3], b[3])
            for a, b in zip(g["steps"], g0["steps"])),
            f"dp (2, 2, 2): rank {g['rank']}'s steps differ from rank 0's")
        check(all(f == "ok" for f in g["finish"])
              and all(len(t) == 16 for t in g["streams"]),
              f"dp (2, 2, 2): rank {g['rank']}: {g['finish']}")
        steps = sum(g["counts"].values())
        check(g["launches"] == {k: per_step_grid.get(k, 0) * steps
                                for k in g["launches"]},
              f"dp (2, 2, 2): rank {g['rank']}: launches {g['launches']} "
              f"over {steps} steps")
        check(all(pr["used"] == 0 for pr in g["per_row"]),
              f"dp (2, 2, 2): rank {g['rank']}: blocks held {g['per_row']}")
    for r in ref:
        for d, equal in enumerate(r["replay"]):
            check(len(equal) == len(g0["steps"]) and all(equal),
                  f"dp (2, 2, 2): row {d}'s segments replayed on (1, 2, 2) "
                  f"give other tokens at steps "
                  f"{[i for i, e in enumerate(equal) if not e]}")
        check(r["streams"] == ref[0]["streams"],
              "dp (2, 2, 2): the (1, 2, 2) ranks' streams differ")
    check(sorted(ref[0]["streams"]) == list(range(len(g0["streams"]))),
          f"dp (2, 2, 2): the (1, 2, 2) engines served "
          f"{sorted(ref[0]['streams'])}")
    for rid, toks in ref[0]["streams"].items():
        check(toks == g0["streams"][rid],
              f"dp (2, 2, 2): request {rid} of row {g0['rows'][rid]}: "
              f"{g0['streams'][rid]} against the (1, 2, 2) engine's {toks}")
    check(set(g0["rows"]) == {0, 1} and g0["counts"]["base"] >= 1
          and g0["counts"]["shift"] > 0,
          f"dp (2, 2, 2): rows {g0['rows']}, configs {g0['counts']}")
    gstats = per_config(g0["walls"], g0["traffic"])
    print(f"dp phase (2, 2, 2): {n} ranks ({layers} layers) ran in "
          f"{t_grid:.1f} s, the (1, 2, 2) replay and engines in "
          f"{t_ref:.1f} s; every rank's streams and steps equal; each row's "
          f"segment of all {len(g0['steps'])} steps, replayed through the "
          "(1, 2, 2) models on one row's pool, gives the same tokens "
          f"bitwise; rows {g0['rows']}; {sum(g0['counts'].values())} steps "
          f"{g0['counts']}; launches per step and rank {per_step_grid} "
          "(counters)")
    print("dp phase (2, 2, 2): the streams equal the (1, 2, 2) engine's fed "
          "each row's routed requests at the dp batch's shapes and configs "
          "(every step's inputs equal the row's segment)")
    for config, st in gstats.items():
        print(f"dp phase (2, 2, 2): {config} steps on rank 0: "
              f"{st['steps']}, wall {st['wall_ms_per_step']:.2f} ms per "
              "step; bytes per step by kind "
              + json.dumps({k: round(v) for k, v in
                            st["bytes_per_step"].items()}))
    print(f"dp phase (2, 2, 2): per rank params "
          f"{g0['param_bytes'] / 1e9:.2f} GB, peak device memory "
          + ", ".join(f"{g['peak_bytes'] / 1e9:.2f}" for g in grid) + " GB")
    wall = time.monotonic() - t_phase
    print(json.dumps({"dp": {
        "backend": "gloo", "dp211": dp211,
        "dp222": {"layers": layers, "per_config": gstats,
                  "ttft_ms": g0["ttft_ms"],
                  "decode_tokens_per_s": g0["decode_tokens_per_s"],
                  "wall_s": g0["wall_s"], "rows": g0["rows"],
                  "counts": g0["counts"],
                  "peak_gb_per_rank": [g["peak_bytes"] / 1e9 for g in grid]},
        "phase_wall_s": wall}}))
    print(f"dp phase: {wall:.1f} s in all")
    print(f"card: {card_line()}")
    return (r0["plain"]["launches"], r0["prefix_spec"]["launches"],
            g0["launches"])


# ---------------------------------------------------------------------------
# phase 8: reshard mid-decode on two ranks
# ---------------------------------------------------------------------------
RESHARD_TIMEOUT_S = 600
RESHARD_MAX_LAYERS = 8          # the phase's depth at most (its time)
RESHARD_NEW = 12                # new tokens per request
RESHARD_KW = dict(max_slots=4, s_max=128, prefill_chunk=64, block_size=16)


def reshard_rank(rank, groups, layers):
    """One of two ranks: qwen3-8b at full width and ``layers`` deep, first
    fp32, then bf16: a static (2, 1, 1) run of 4 requests of the serve
    workload, then the same requests on a (2, 1, 1) engine behind a
    one-replica ``Router`` (its ``DeliveryLog`` polled every step) that
    ``schedule_reshard``s to (1, 1, 2) after 3 steps and back 3 steps after
    that swap. Returns per type the streams, the delivered tokens, the
    static streams, each reshard's wall (host clock after a synchronize),
    report and the traffic it added, the launches of the resharded run
    (counted from 0) and its forward steps, and the peak memory."""
    import torch
    from repro_torch.cluster import Router
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.parallel import Groups, Layout
    groups_tp = Groups(1, 2)
    grids = (groups, groups_tp)
    out = {"rank": rank}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = Model(grid_cfg(layers), device="cuda", dtype=dtype,
                      lay=Layout(dp=2), groups=groups)
        model.init_params(torch.Generator(device="cuda").manual_seed(0))
        ecfg = EngineConfig(**RESHARD_KW)

        def reqs():
            return serve.workload(4, RESHARD_NEW)

        static = ShiftEngine(model, ecfg)
        ref = reqs()
        for r in ref:
            static.submit(r)
        static.run_until_idle()
        del static
        eng = ShiftEngine(model, ecfg)
        # the engine's views hold the weights; a reshard frees them
        del model
        router = Router([eng], rebalance_every=0)
        swaps = []
        reshard = eng.reshard

        def traffic():
            return grids[0].traffic + grids[1].traffic

        def timed(layout, groups=None, row_blocks=0):
            before = traffic()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = reshard(layout, groups=groups, row_blocks=row_blocks)
            torch.cuda.synchronize()
            swaps.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "kind": rep.delta.kind, "requests": rep.moved_requests,
                "blocks": rep.blocks_moved,
                "traffic": dict(traffic() - before)})
            return rep

        eng.reshard = timed
        rs = reqs()
        steps0 = sum(eng.config_counts.values())
        serve.reset_launch_counts()
        for r in rs:
            router.submit(r)
        for lay, g in ((Layout(tp=2), groups_tp), (Layout(dp=2), groups)):
            for _ in range(3):
                router.poll()
                router.step()
            n = len(swaps)
            eng.schedule_reshard(lay, groups=g, lead_steps=1)
            while len(swaps) == n:
                router.poll()
                router.step()
        router.run_until_idle()
        torch.cuda.synchronize()
        out[name] = {
            "streams": [router.stream(r.rid) for r in rs],
            "delivered": [router.delivered(r.rid) for r in rs],
            "static": [r.generated for r in ref], "swaps": swaps,
            "signature": list(eng.deploy.signature),
            "launches": serve.launch_counts(),
            "steps": sum(eng.config_counts.values()) - steps0,
            "paused": eng.last_reshard_report.admission_paused_steps,
            "ledger": eng.block_accounting().as_dict(),
            "peak_bytes": torch.cuda.max_memory_allocated()}
        del eng, router
    return out


def reshard_phase(torch):
    """(2, 1, 1) -> (1, 1, 2) -> (2, 1, 1) mid-decode through
    ``schedule_reshard``, two processes on the one card over gloo, at full
    width with the depth cut by a memory reckoning and
    ``RESHARD_MAX_LAYERS``: the fp32 streams must equal the static (2, 1,
    1) run's, delivered exactly once through a one-replica Router's
    ``DeliveryLog``; bf16's agreement is printed without a limit (changing
    tp changes the order of the logits' sum). Launches exact per step.
    Prints ms per reshard, blocks moved and the ``reshard_gather`` bytes;
    returns rank 0's fp32 launches. Two ranks on one card over gloo are not
    a speed of a reshard across cards."""
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    overhead = 2e9                      # a rank's context, pool, staging
    cfg = grid_cfg(1)
    # the gather of the largest parameter (the embedding): its parts, their
    # concatenation and the new rank's copy
    gather = 3 * cfg.vocab_size * cfg.d_model * 4
    # a rank holds the old and the new model during a swap: its (2, 1, 1)
    # model whole and the (1, 1, 2) half, in fp32
    fit = max(L for L in range(1, 37) if 2 * (
        1.5 * grid_cfg(L).num_params() * 4 + gather + overhead)
        <= 0.8 * free)
    layers = min(fit, RESHARD_MAX_LAYERS)
    print(f"reshard phase: {free / 1e9:.2f} GB free of {total / 1e9:.2f}; a "
          f"rank holds 1.5 x the fp32 model during a swap, "
          f"{gather / 1e9:.2f} GB for the embedding's gather and ~"
          f"{overhead / 1e9:.0f} GB: {fit} layers fit in 80 % of it, run "
          f"at {layers} (full width, d_model {cfg.d_model}; at most "
          f"{RESHARD_MAX_LAYERS} for the run's time)")
    t0 = time.monotonic()
    res = run_ranks(reshard_rank, 1, 1, dp=2, device="cuda",
                    backend="gloo", timeout_s=RESHARD_TIMEOUT_S,
                    args=(layers,))
    print(f"reshard phase: 2 ranks ran in {time.monotonic() - t0:.1f} s")
    per_step = {"rmsnorm": 3 * layers + 1, "paged_ragged_attention": layers}
    out = {}
    for name in ("fp32", "bf16"):
        a = res[0][name]
        for r in res:
            b = r[name]
            check(b["streams"] == a["streams"] and b["static"] == a["static"],
                  f"reshard {name}: rank {r['rank']}'s streams differ from "
                  "rank 0's")
            check(b["delivered"] == b["streams"]
                  and all(len(t) == RESHARD_NEW for t in b["streams"]),
                  f"reshard {name}: rank {r['rank']}: delivered "
                  f"{b['delivered']} against {b['streams']}")
            check([w["kind"] for w in b["swaps"]] == ["grow", "shrink"]
                  and b["signature"] == [2, 1, 1, 1] and b["paused"] == 1,
                  f"reshard {name}: rank {r['rank']}: swaps "
                  f"{[w['kind'] for w in b['swaps']]}, ends on "
                  f"{b['signature']}")
            check(b["ledger"]["used"] == b["ledger"]["pinned"] == 0,
                  f"reshard {name}: rank {r['rank']} holds blocks")
            want = {k: per_step.get(k, 0) * b["steps"] for k in b["launches"]}
            check(b["launches"] == want, f"reshard {name}: rank {r['rank']}"
                  f": launches {b['launches']} over {b['steps']} steps")
        agree = sum(x == y for s, t in zip(a["streams"], a["static"])
                    for x, y in zip(s, t))
        if name == "fp32":
            check(a["streams"] == a["static"],
                  f"reshard fp32: the resharded streams {a['streams']} differ "
                  f"from the static run's {a['static']}")
        for w in a["swaps"]:
            print(f"reshard {name} {w['kind']}: {w['ms']:.1f} ms, "
                  f"{w['requests']} requests, {w['blocks']} blocks moved, "
                  f"reshard_gather "
                  f"{w['traffic'].get('reshard_gather_bytes', 0)} B, weights "
                  f"gathered {w['traffic'].get('reshard_weights_bytes', 0)} B"
                  " (rank 0)")
        print(f"reshard {name}: streams equal on both ranks, delivered "
              f"exactly once; {agree} of "
              f"{sum(len(t) for t in a['static'])} tokens equal the static "
              f"(2, 1, 1) run's ({'must be all' if name == 'fp32' else 'for information'}); "
              f"{a['steps']} steps, launches exact; peak "
              f"{a['peak_bytes'] / 1e9:.2f} GB on rank 0")
        out[name] = {"swaps": a["swaps"], "agree": agree,
                     "tokens": sum(len(t) for t in a["static"]),
                     "steps": a["steps"], "peak_bytes": a["peak_bytes"]}
    print(json.dumps({"reshard": {"card": card_line(), "layers": layers,
                                  "layers_fit": fit, **out}}))
    return res[0]["fp32"]["launches"]


# ---------------------------------------------------------------------------
# phase 5f: qwen-30b-a3b (MoE) at full width and depth on one card
# ---------------------------------------------------------------------------
QWEN30_CHECK_LAYERS = 2         # the fp32 check's depth (full width)
QWEN30_HEADROOM = 4e9           # activations, logits and CUDA graphs


def replace_layers(cfg, layers):
    from dataclasses import replace
    return replace(cfg, num_layers=layers)


def moe_param_bytes(cfg):
    """A MoE model's weight bytes in bf16, its routers in fp32."""
    routers = cfg.num_layers * cfg.d_model * cfg.moe.num_experts
    return cfg.num_params() * 2 + routers * 2


def drop_shares(torch, model):
    """The share of routed assignments that capacity drops, per step of the
    serve workload: an eager engine over ``model`` whose every MoE layer's
    kept mask is summed on the card (``moe.route`` wrapped for this turn
    only) and read after each step. Returns [(prefill tokens, share)], one
    per step that ran the model."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.engine.deployment import Deployment
    from repro_torch.launch import serve
    from repro_torch.models import moe as MOE
    route = MOE.route
    kept = []

    def counted(p, xt):
        out = route(p, xt)
        keep = out[5]
        kept.append(torch.stack([keep.sum(), torch.tensor(
            keep.numel(), device=keep.device)]))
        return out
    eng = ShiftEngine(model, EngineConfig())
    eng.deploy = Deployment.build(eng.base, eng.shift, mixed=eng.mixed,
                                  paged=eng.paged, graphed=False)
    out = []
    MOE.route = counted
    try:
        for r in serve.workload(6, 16):
            eng.submit(r)
        for _ in range(1000):
            kept.clear()
            n = len(eng.step_log)
            did = eng.step()
            if kept:
                k, t = torch.stack(kept).sum(0).tolist()
                rec = eng.step_log[n] if len(eng.step_log) > n else {}
                out.append((rec.get("prefill_tokens", 0), 1 - k / t))
            if not did and not eng.queue and not eng.active:
                break
    finally:
        MOE.route = route
    return out


def qwen30b_phase(torch):
    """The paper's MoE evaluation model (Table 4, qwen-30b-a3b: 48 layers,
    d_model 2048, 32 q heads over 4 kv heads of 128, 128 experts, top-8,
    d_ff_expert 768) at full width and depth in bf16 on one card, after a
    reckoning of its memory against the card's free memory (the phase
    fails if it does not fit): the serve CLI's workload through the graphed
    mixed paged engine in two turns on one engine (``serve_path`` each),
    equal streams and launches, the second turn capturing nothing; 145
    RMSNorm and 48 ragged launches per step (counters, and the profiler's
    trace of decode steps); no block held at exit; TTFT, wall and busy ms
    per decode step, decode tokens/s, peak memory, and the share of routed
    assignments dropped per step (an eager turn; printed only). Then a
    2-layer cut at full width in fp32: one mixed step's logits with
    padding columns on the card against the CPU within 2e-3. Returns the
    launches of the measured turn and its numbers."""
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.sim import CostModel
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen-30b-a3b")
    ecfg = EngineConfig()
    blocks = ecfg.max_slots * ecfg.s_max // ecfg.block_size + 1
    params = moe_param_bytes(cfg)
    pool = (2 * cfg.num_layers * blocks * ecfg.block_size * cfg.num_kv_heads
            * cfg.head_dim * 2)
    init = cfg.vocab_size * cfg.d_model * (4 + 2)
    free, total = torch.cuda.mem_get_info()
    need = params + pool + init + QWEN30_HEADROOM
    expert_bytes = (cfg.num_layers * cfg.moe.num_experts * 3 * cfg.d_model
                    * cfg.moe.d_ff_expert * 2)
    print(f"qwen-30b-a3b phase: memory reckoned: weights {params / 1e9:.2f} "
          f"GB ({cfg.num_params()} params in bf16, the routers in fp32; "
          f"the experts {expert_bytes / 1e9:.2f} GB), pool {blocks} blocks x "
          f"{ecfg.block_size} tokens x {cfg.num_layers} layers = {pool} B, "
          f"the largest init temporary {init / 1e9:.2f} GB (the embedding "
          f"in fp32 and bf16), {QWEN30_HEADROOM / 1e9:.1f} GB for "
          f"activations and graphs: {need / 1e9:.2f} GB against "
          f"{free / 1e9:.2f} GB free of {total / 1e9:.2f} GB")
    check(need <= free, f"qwen-30b-a3b: {need / 1e9:.2f} GB needed, "
          f"{free / 1e9:.2f} GB free")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = serve.build_engine("qwen-30b-a3b", device="cuda",
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    held = sum(p.numel() * p.element_size()
               for p in eng.model.params.parameters())
    pool_bytes = 2 * eng.model.pool.k.numel() * eng.model.pool.k.element_size()
    check(held == params and pool_bytes == pool,
          f"qwen-30b-a3b: weights {held} B and pool {pool_bytes} B, "
          f"reckoned {params} and {pool}")
    build_peak = torch.cuda.max_memory_allocated()
    print(f"qwen-30b-a3b full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} q heads over {cfg.num_kv_heads} "
          f"kv heads, {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of "
          f"d_ff {cfg.moe.d_ff_expert}, capacity factor "
          f"{cfg.moe.capacity_factor}, built in {build_s:.1f} s; peak "
          f"device memory while building {build_peak / 1e9:.2f} GB")
    per_step = step_launches(eng, "mixed")
    check(per_step == {"rmsnorm": 145, "paged_ragged_attention": 48},
          f"qwen-30b-a3b: per-step launches {per_step}")
    label = "qwen-30b-a3b mixed paged [graphed]"
    turns = []
    for turn in (1, 2):
        captured = eng.deploy.captures
        reqs, launches, st = serve_path(torch, eng, f"{label} turn {turn}")
        if turn == 2:
            check(eng.deploy.captures == captured,
                  f"{label}: turn 2 captured "
                  f"{eng.deploy.captures - captured} graphs")
        turns.append((reqs, launches, st))
    check([r.generated for r in turns[0][0]]
          == [r.generated for r in turns[1][0]],
          f"{label}: the two turns' streams differ")
    check(turns[0][1] == turns[1][1], f"{label}: launches "
          f"{turns[0][1]} != {turns[1][1]}")
    reqs, launches, st = turns[1]
    recs = measured_records(eng, st)
    st.update(profile_decode(torch, eng, label=label))
    pred = [predicted_ms(CostModel(cfg), r) for r in recs
            if not r["prefill_tokens"]]
    st.update(predicted_ms_per_decode_step=sum(pred) / len(pred),
              graphs_captured=eng.deploy.captures,
              capture_ms=eng.deploy.graphs.capture_s * 1e3,
              turn1_wall_ms_per_decode_step=turns[0][2][
                  "wall_ms_per_decode_step"])
    led = eng.block_accounting()
    check(led.used == led.pinned == 0, f"qwen-30b-a3b: blocks held at "
          f"exit {led}")
    st["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: TTFT ms " + ", ".join(
        f"{t:.1f}" for t in st["ttft_ms"]) + f"; decode step wall "
        f"{st['wall_ms_per_decode_step']:.3f} ms (turn 1 "
        f"{st['turn1_wall_ms_per_decode_step']:.3f}), device busy "
        f"{st['busy_ms_per_step']:.3f} ms ({st['busy_share']:.1%}), "
        f"{st['decode_tokens_per_s']:.1f} decode tokens/s; cost model "
        f"{st['predicted_ms_per_decode_step']:.3f} ms per decode step "
        "(Strategy tp 1, H100 data-sheet constants; printed only); "
        f"{st['graphs_captured']} graphs captured in "
        f"{st['capture_ms']:.0f} ms; steps by config {st['configs']}; peak "
        f"device memory {st['peak_gb']:.2f} GB")
    model = eng.model
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    shares = drop_shares(torch, model)
    dec = sorted(x for n, x in shares if n == 0)
    pre = [x for n, x in shares if n]
    check(dec and pre, f"qwen-30b-a3b: drop shares {shares}")
    st["drop_share"] = {"prefill_steps": pre,
                        "decode_steps_min": dec[0],
                        "decode_steps_median": dec[len(dec) // 2],
                        "decode_steps_max": dec[-1]}
    print(f"qwen-30b-a3b: share of routed assignments dropped by capacity "
          f"(cf {cfg.moe.capacity_factor}; an eager turn of the serve "
          f"workload, printed only): prefill steps "
          + ", ".join(f"{x:.3f}" for x in pre)
          + f"; {len(dec)} decode steps: min {dec[0]:.3f}, median "
          f"{dec[len(dec) // 2]:.3f}, max {dec[-1]:.3f}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # fp32, full width, 2 layers: one mixed step with padding columns
    check_cfg = replace_layers(cfg, QWEN30_CHECK_LAYERS)
    steps, bt = layout_check_steps()
    gpu = Model(check_cfg, device="cuda", dtype=torch.float32)
    gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(check_cfg, device="cpu", dtype=torch.float32)
    cpu.load_params({k: v.cpu() for k, v in
                     gpu.params.state_dict().items()})
    err = 0.0
    for m in (gpu, cpu):
        m.init_paged_cache(9, 16)
    for t, ql, off in steps:
        lg = [m.forward_mixed(t, ql, off, bt, sample=False)[0].cpu()
              for m in (gpu, cpu)]
        err = max(err, compare(torch, "qwen-30b-a3b fp32 2-layer logits",
                               lg[0], lg[1], 2e-3))
    print(f"qwen-30b-a3b fp32 full-width ({QWEN30_CHECK_LAYERS} layers) "
          f"mixed step logits with padding columns (q_lens "
          f"{[s[1] for s in steps]} of 16 columns), card against CPU on "
          f"the same weights: max abs err {err} (tol 2e-3)")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.monotonic() - t_phase
    print(json.dumps({"qwen30b": {"build_s": build_s, "turn": st,
                                  "fp32_max_abs_err": err,
                                  "phase_wall_s": wall}}))
    print(f"qwen-30b-a3b phase: {wall:.1f} s in all; card: {card_line()}")
    return launches, st


# ---------------------------------------------------------------------------
# phases 5g and 9: deepseek-v3-671b (MLA, pod-scale MoE)
# ---------------------------------------------------------------------------
DEEPSEEK_DEPTH = 5              # its 3 dense prefix layers and 2 MoE layers
DEEPSEEK_HEADROOM = 6e9         # activations, logits and CUDA graphs
DEEPSEEK_LAYOUT_TIMEOUT_S = 600
POD_TIMEOUT_S = 300


def deepseek_cut(layers, prefix):
    """deepseek-v3-671b at full width with ``prefix`` of its dense prefix
    layers and ``layers - prefix`` of its MoE layers."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b")
    return replace(cfg, num_layers=layers,
                   prefix_layers=cfg.prefix_layers[:prefix])


class _NoGroups:
    """Stands for a grid's Groups where only shapes matter (a meta model)."""

    def axes_group(self, axes):
        return None


def rank_param_bytes(torch, cfg, lay, rank, dtype):
    """Bytes of ``rank``'s parameters on ``lay``, by part (the embedding
    and head, the norms, and each layer), counted on the meta device."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import Shard
    sh = Shard(lay, rank, groups=_NoGroups()) if lay.world > 1 else Shard(lay)
    meta = T.Transformer(cfg, lay, dtype, "meta", sh)

    def size(mod):
        return sum(p.numel() * p.element_size() for p in mod.parameters())
    layers = [size(m) for m in meta.layers]
    return {"tables": size(meta) - sum(layers) - size(meta.final_norm),
            "layers": layers, "total": size(meta)}


def seeded_init(torch, model, seed=0):
    """Random weights for a full-width model without a MoE layer's
    canonical expert draws: every other parameter as ``init_params`` draws
    it, one tensor at a time (one
    generator seeded ``seed`` on the card), each expert's matrices from a
    generator of their own (seeded by ``seed``, the layer and the expert)
    and cut to this rank's FF block. No draw depends on the layout, so a
    base and a shift model hold one function; the largest temporary is one
    expert's matrix, where ``init_params`` draws a layer's stack in fp32
    (15 GB for deepseek-v3-671b)."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import dense_init, shard_of
    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = model.params
    with torch.no_grad():
        p.embed.reset_parameters(gen)
        p.final_norm.reset_parameters()
        if hasattr(p, "lm_head"):
            p.lm_head.reset_parameters(gen)
        if hasattr(p, "encoder"):
            for layer in p.encoder:
                layer.reset_parameters(gen)
            p.enc_norm.reset_parameters()
        for i, layer in enumerate(p.layers):
            if layer.kind != "moe":
                # ln1, the attention or mixer, ln2 and the FFN, in turn
                layer.reset_parameters(gen)
                continue
            layer.ln1.reset_parameters()
            layer.attn.reset_parameters(gen)
            layer.ln2.reset_parameters()
            ffn = layer.ffn
            cfg, mo = ffn.cfg, ffn.cfg.moe
            d, ff = cfg.d_model, mo.d_ff_expert
            _, e0, tpr, t = MOE.expert_grid(cfg, ffn.shard.lay,
                                            ffn.shard.rank)
            ffn.router.copy_(dense_init((d, mo.num_experts), gen, f32))
            for k in range(ffn.E_loc):
                e = e0 * ffn.E_loc + k
                g = torch.Generator(device="cuda").manual_seed(
                    (seed * 1000 + i) * 1000 + e)
                for w, shape, dim in ((ffn.wi, (d, ff), 1),
                                      (ffn.wg, (d, ff), 1),
                                      (ffn.wo, (ff, d), 0)):
                    w[k].copy_(shard_of(dense_init(shape, g, f32), dim, tpr,
                                        t).to(w.dtype))
            if mo.num_shared_experts:
                ffs = (mo.d_ff_shared or ff) * mo.num_shared_experts
                n, k = max(ffn.shard.lay.tp, 1), ffn.shard.tp_rank
                for w, shape, dim in ((ffn.shared.wi, (d, ffs), 1),
                                      (ffn.shared.wg, (d, ffs), 1),
                                      (ffn.shared.wo, (ffs, d), 0)):
                    w.copy_(shard_of(dense_init(shape, gen, f32), dim, n,
                                     k).to(w.dtype))
        if hasattr(p, "mtp"):           # drawn last, as init_params does
            p.mtp.reset_parameters(gen)


def deepseek_phase(torch):
    """deepseek-v3-671b at full width in bf16 on one card, its depth cut to
    its 3 dense prefix layers and 2 MoE layers: the bytes reckoned per part
    against the free memory (no fit, no run), ``seeded_init`` weights, the
    serve workload through the serialized dense engine (its automatic
    fallback) in eager, graphed, graphed and eager turns (``serve_turns``:
    equal streams and launches; 21 RMSNorm launches per step by the
    counters and the profiler's trace); then reduced deepseek-v3-671b in
    fp32, card against CPU on the same weights. Returns the first graphed
    turn's launches and every turn's numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = deepseek_cut(DEEPSEEK_DEPTH, 3)
    ecfg = EngineConfig()
    parts = rank_param_bytes(torch, cfg, Layout(), 0, torch.bfloat16)
    latent = (cfg.num_layers * ecfg.max_slots * ecfg.s_max
              * cfg.mla.cache_dim * 2)
    init = cfg.vocab_size * cfg.d_model * (4 + 2)
    free, total = torch.cuda.mem_get_info()
    need = parts["total"] + latent + init + DEEPSEEK_HEADROOM
    print(f"deepseek phase: memory reckoned: weights "
          f"{parts['total'] / 1e9:.2f} GB in bf16 (routers fp32): embedding "
          f"and head {parts['tables'] / 1e9:.2f} GB, layers "
          + ", ".join(f"{b / 1e9:.2f}" for b in parts["layers"])
          + f" GB ({cfg.layer_kinds}); dense latent cache {latent / 1e6:.1f}"
          f" MB; the largest init temporary {init / 1e9:.2f} GB; "
          f"{DEEPSEEK_HEADROOM / 1e9:.0f} GB headroom: {need / 1e9:.2f} GB "
          f"against {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB. Cut: "
          f"{cfg.num_layers} of 61 layers (the 3 dense prefix layers and 2 "
          "of the 58 MoE layers); widths, heads, experts and the "
          "vocabulary whole")
    check(need <= free, f"deepseek: {need / 1e9:.2f} GB needed, "
          f"{free / 1e9:.2f} GB free")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    seeded_init(torch, model, 0)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    held = sum(p.numel() * p.element_size() for p in model.params.parameters())
    check(held == parts["total"], f"deepseek: {held} B held, reckoned "
          f"{parts['total']}")
    eng = ShiftEngine(model, ecfg)
    check(not eng.paged and not eng.mixed and "MLA"
          in eng.paged_disabled_reason, "deepseek: not the dense fallback")
    for kind in ("prefill", "decode"):
        check(step_launches(eng, kind) == {"rmsnorm": 21},
              f"deepseek: per-step launches {step_launches(eng, kind)}")
    print(f"deepseek-v3-671b full width: {cfg.num_layers} layers "
          f"{cfg.layer_kinds}, d_model {cfg.d_model}, {cfg.num_heads} MLA "
          f"heads (q latent {cfg.mla.q_lora_rank}, kv latent "
          f"{cfg.mla.kv_lora_rank} + rope {cfg.mla.qk_rope_head_dim}), "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of d_ff "
          f"{cfg.moe.d_ff_expert} and a shared expert, built in "
          f"{build_s:.1f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB while building; {eng.paged_disabled_reason}")
    del eng
    reqs, launches, turns = serve_turns(torch, model, {},
                                        "deepseek-v3-671b serialized dense")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 at the reduced width: one prefill and one decode step
    small = get_config("deepseek-v3-671b").reduced()
    gpu = Model(small, device="cuda", dtype=torch.float32)
    gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(small, device="cpu", dtype=torch.float32)
    cpu.load_params({k: v.cpu() for k, v in gpu.params.state_dict().items()})
    toks = (np.arange(8 * 16, dtype=np.int32).reshape(8, 16) * 7) % 256
    err = 0.0
    for m in (gpu, cpu):
        m.init_cache(8, 32)
    lg = [m.prefill(toks, np.zeros(8, np.int32))[0].cpu() for m in (gpu, cpu)]
    err = compare(torch, "deepseek reduced fp32 prefill", lg[0], lg[1], 1e-3)
    lg = [m.decode(np.arange(8) % 256, np.full(8, 16), sample=False)[0].cpu()
          for m in (gpu, cpu)]
    err = max(err, compare(torch, "deepseek reduced fp32 decode", lg[0],
                           lg[1], 1e-3))
    lat = compare(torch, "deepseek reduced fp32 latent", gpu.cache.lat.cpu(),
                  cpu.cache.lat, 1e-3)
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    g = next(st for st in turns if st["graphed"])
    print(f"deepseek-v3-671b [graphed]: TTFT ms " + ", ".join(
        f"{t:.1f}" for t in g["ttft_ms"]) + f"; {g['wall_ms_per_decode_step']:.2f}"
        f" ms per decode step, {g['decode_tokens_per_s']:.1f} decode "
        f"tokens/s, device busy {g['busy_ms_per_step']:.2f} ms per profiled "
        f"decode step ({g['busy_share']:.1%}); peak {peak:.2f} GB; reduced "
        f"fp32 card against CPU: logits max abs err {err}, latent {lat} "
        "(tol 1e-3)")
    wall = time.monotonic() - t_phase
    print(json.dumps({"deepseek": {
        "layers": cfg.num_layers, "kinds": list(cfg.layer_kinds),
        "weights_gb": parts["total"] / 1e9, "build_s": build_s,
        "turns": turns, "peak_gb": peak, "fp32_reduced_max_abs_err": err,
        "fp32_reduced_latent_err": lat, "phase_wall_s": wall}}))
    print(f"deepseek phase: {wall:.1f} s in all; card: {card_line()}")
    return launches, turns


def latent_invariance_step(torch, eng, rank):
    """§3.3.1 on the latent cache: a base prefill step of every slot's
    first 64 positions, then a shift decode step at position 64. Both
    configs step one latent tensor and the rank holds one chunk of the
    sequence in both (``verify_dense_invariance``); the positions the base
    step wrote stay bitwise under the shift step, which wrote position 64
    where this rank's chunk holds it."""
    import numpy as np
    from repro_torch.core import invariance as INV
    n = eng.cfg.max_slots
    toks = (np.arange(n * 64, dtype=np.int32).reshape(n, 64) % 1000) + 1
    eng.deploy.prefill["base"](toks, np.zeros(n, np.int32), None)
    torch.cuda.synchronize()
    lat = eng.base.cache.lat
    chunk = INV.latent_chunk(eng.base, rank)
    before = lat.clone()
    eng.deploy.decode["shift"](toks[:, 0].copy(), np.full(n, 64, np.int32),
                               None)
    torch.cuda.synchronize()
    ok = INV.verify_dense_invariance(eng.base, eng.shift, rank)
    written = [p - chunk.start for p in range(64) if p in chunk]
    if written:
        ok = ok and torch.equal(lat[:, :, written], before[:, :, written])
    if 64 in chunk:
        ok = ok and not torch.equal(lat[:, :, 64 - chunk.start],
                                    before[:, :, 64 - chunk.start])
    return bool(ok)


def deepseek_layout_rank(rank, groups, dp, sp, tp):
    """One rank of the pod-scale deepseek run (spawned by ``run_ranks``):
    full width, 1 dense prefix layer and 1 MoE layer, in bf16, base on
    ``Layout(dp, sp, tp)`` and shift on its ``to_shift()`` (one model when
    sp·tp is 1), the ranks building theirs in turn (one init temporary on
    the card at a time), serving the serve workload through the serialized
    dense engine; then the latent invariance step."""
    import torch
    import torch.distributed as dist
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = deepseek_cut(2, 1)
    lay = Layout(dp=dp, sp=sp, tp=tp)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    models = []
    for turn in range(lay.world):
        if turn == rank:
            for layout in ((lay, lay.to_shift()) if lay.G > 1 else (lay,)):
                m = Model(cfg, device="cuda", dtype=torch.bfloat16,
                          lay=layout, groups=groups)
                seeded_init(torch, m, 0)
                models.append(m)
            torch.cuda.synchronize()
            # hand the init temporaries back to the card for the next rank
            torch.cuda.empty_cache()
        dist.barrier()
    out = {"rank": rank, "build_s": time.monotonic() - t0,
           "ep": {name: (m.params.layers[1].ffn.ep_axes,
                         m.params.layers[1].ffn.E_loc)
                  for name, m in zip(("base", "shift"), models)},
           "param_bytes": sum(p.numel() * p.element_size()
                              for m in models
                              for p in m.params.parameters())}
    eng = ShiftEngine(models[0], EngineConfig(),
                      shift=models[1] if len(models) > 1 else None)
    walls, traffic = timed_forward(torch, eng, groups,
                                   kinds=("prefill", "decode"))
    reqs = serve.workload(6, 16)
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    out.update(serve_s=time.monotonic() - t0,
               launches=serve.launch_counts(),
               streams=[r.generated for r in reqs],
               finish=[r.finish_reason for r in reqs],
               counts=dict(eng.config_counts),
               reason=eng.paged_disabled_reason,
               walls={k: list(v) for k, v in walls.items()},
               traffic={k: dict(v) for k, v in traffic.items()},
               invariance=latent_invariance_step(torch, eng, rank),
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def deepseek_layout_phase(torch):
    """deepseek-v3-671b at full width, cut to 1 dense prefix layer and 1 MoE
    layer, over gloo on the one card (the parent holding nothing): on
    (sp, tp) = (2, 2), four ranks (base and shift models each: the latent
    sharded over sp, the LSE merge, the experts over sp in the base config
    and over the model group in the shift config), and on (dp, sp, tp) =
    (2, 1, 1), two ranks (the experts across the dp rows). The bytes per
    rank are reckoned first. Every rank's streams equal, launches exact,
    the latent invariance step holds; prints the wall and the all-to-all
    bytes per step by config and kind. Returns rank 0's launches of each
    run."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.parallel import Layout
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"deepseek layout phase: the parent still holds "
          f"{held / 1e9:.2f} GB on the card")
    cfg = deepseek_cut(2, 1)
    out, summary_ = {}, {}
    for dp, sp, tp in ((1, 2, 2), (2, 1, 1)):
        lay = Layout(dp=dp, sp=sp, tp=tp)
        per_rank = []
        for r in range(lay.world):
            b = rank_param_bytes(torch, cfg, lay, r, torch.bfloat16)
            s = (rank_param_bytes(torch, cfg, lay.to_shift(), r,
                                  torch.bfloat16) if lay.G > 1
                 else {"total": 0, "layers": [0, 0], "tables": 0})
            per_rank.append((b, s))
        free, total = torch.cuda.mem_get_info()
        need = sum(b["total"] + s["total"] + 2e9 for b, s in per_rank) \
            + cfg.vocab_size * cfg.d_model * 6
        b, s = per_rank[0]
        print(f"deepseek layout (dp {dp}, sp {sp}, tp {tp}): memory reckoned "
              f"per rank: base {b['total'] / 1e9:.2f} GB (tables "
              f"{b['tables'] / 1e9:.2f}, prefix layer "
              f"{b['layers'][0] / 1e9:.2f}, MoE layer "
              f"{b['layers'][1] / 1e9:.2f}), shift {s['total'] / 1e9:.2f} GB"
              f" (MoE layer {s['layers'][1] / 1e9:.2f}), + 2 GB (context, "
              f"staging); {lay.world} ranks and one init temporary: "
              f"{need / 1e9:.1f} GB against {free / 1e9:.1f} GB free of "
              f"{total / 1e9:.1f}. Cut: 2 of 61 layers (1 of the 3 dense "
              "prefix layers, 1 of the 58 MoE layers); widths, heads, "
              "experts and the vocabulary whole")
        check(need <= free, f"deepseek layout ({dp}, {sp}, {tp}): "
              f"{need / 1e9:.1f} GB needed, {free / 1e9:.1f} GB free")
        t0 = time.monotonic()
        res = run_ranks(deepseek_layout_rank, sp, tp, dp=dp, device="cuda",
                        backend="gloo", timeout_s=DEEPSEEK_LAYOUT_TIMEOUT_S,
                        args=(dp, sp, tp))
        ran = time.monotonic() - t0
        r0 = res[0]
        steps = sum(r0["counts"].values())
        key = f"dp{dp}_sp{sp}_tp{tp}"
        for r in res:
            check(r["streams"] == r0["streams"] and r["counts"] == r0["counts"],
                  f"deepseek {key}: rank {r['rank']}'s streams or configs "
                  "differ from rank 0's")
            check(all(f == "ok" for f in r["finish"])
                  and all(len(x) == 16 for x in r["streams"]),
                  f"deepseek {key}: rank {r['rank']}: {r['finish']}")
            check(r["launches"] == {k: (9 if k == "rmsnorm" else 0) * steps
                                    for k in r["launches"]},
                  f"deepseek {key}: rank {r['rank']}: launches "
                  f"{r['launches']} over {steps} steps, want 9 RMSNorm a step")
            check(r["invariance"], f"deepseek {key}: rank {r['rank']}: the "
                  "latent invariance step failed")
            check("MLA" in r["reason"], f"deepseek {key}: {r['reason']}")
            check(r["param_bytes"] == sum(x["total"]
                                          for x in per_rank[r["rank"]]),
                  f"deepseek {key}: rank {r['rank']} holds "
                  f"{r['param_bytes']} B, reckoned {per_rank[r['rank']]}")
        if lay.G > 1:
            check(r0["counts"].get("base", 0) > 0
                  and r0["counts"].get("shift", 0) > 0,
                  f"deepseek {key}: configs used {r0['counts']}")
        want_ep = ({"base": (("sp",), 128), "shift": (("tp", "sp"), 64)}
                   if dp == 1 else {"base": (("data",), 128)})
        check({k: tuple(v) for k, v in r0["ep"].items()} ==
              {k: (tuple(a), e) for k, (a, e) in want_ep.items()},
              f"deepseek {key}: EP {r0['ep']}")
        stats = {}
        for k, w in r0["walls"].items():
            if not w:
                continue
            tr = r0["traffic"][k]
            stats[k] = {"steps": len(w),
                        "wall_ms_per_step": sum(w) / len(w) * 1e3,
                        "all_to_all_bytes_per_step":
                            tr.get("all_to_all_bytes", 0) / len(w),
                        "all_reduce_bytes_per_step":
                            tr.get("all_reduce_bytes", 0) / len(w),
                        "all_gather_bytes_per_step":
                            tr.get("all_gather_bytes", 0) / len(w)}
            print(f"deepseek {key} {k}: {len(w)} steps on rank 0, wall "
                  f"{stats[k]['wall_ms_per_step']:.2f} ms per step; per "
                  f"step {stats[k]['all_to_all_bytes_per_step'] / 1e6:.3f} "
                  f"MB all-to-all (the expert dispatch), "
                  f"{stats[k]['all_reduce_bytes_per_step'] / 1e6:.3f} MB "
                  f"all-reduce, "
                  f"{stats[k]['all_gather_bytes_per_step'] / 1e6:.3f} MB "
                  "all-gather (payload handed over by the rank)")
        print(f"deepseek {key}: {lay.world} ranks ran in {ran:.1f} s; served"
              f" 6 requests x 16 tokens in {r0['serve_s']:.2f} s, {steps} "
              f"steps {r0['counts']}; every rank's streams equal; EP "
              f"{r0['ep']}; latent invariance held on every rank; peak per "
              "rank " + ", ".join(f"{r['peak_bytes'] / 1e9:.2f}" for r in res)
              + " GB")
        out[key] = r0["launches"]
        summary_[key] = {"ranks": lay.world, "configs": r0["counts"],
                         "per_config": stats, "serve_s": r0["serve_s"],
                         "ep": r0["ep"], "run_s": ran,
                         "peak_gb_per_rank": [r["peak_bytes"] / 1e9
                                              for r in res]}
    wall = time.monotonic() - t_phase
    print(json.dumps({"deepseek_layout": dict(summary_, phase_wall_s=wall)}))
    print(f"deepseek layout phase: {wall:.1f} s in all; card: {card_line()}")
    return out


def pod_reduced_rank(rank, groups):
    """One rank of (2, 2, 2) (spawned by ``run_ranks``): reduced
    deepseek-v3-671b and llama4-17b-16e in fp32 (capacity factor 4.0), the
    same weights on the CPU and on the card (drawn on the CPU, seeded 0):
    the equivalence inputs' prefill and decode logits of base and shift,
    and the serving engine's streams, on each device."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    lay = Layout(dp=2, sp=2, tp=2)
    toks = (np.arange(8 * 16, dtype=np.int32).reshape(8, 16) * 7) % 256
    out = {"rank": rank}
    for arch in ("deepseek-v3-671b", "llama4-17b-16e"):
        cfg = get_config(arch).reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
        res, states = {}, []
        for device in ("cpu", "cuda"):
            models = []
            for i, layout in enumerate((lay, lay.to_shift())):
                m = Model(cfg, device=device, dtype=torch.float32,
                          lay=layout, groups=groups)
                if device == "cpu":
                    m.init_params(torch.Generator().manual_seed(0))
                    states.append(m.params.state_dict())
                else:
                    m.load_params(states[i])
                models.append(m)
            logits = []
            for m in models:
                m.init_cache(8, 32)
                lg = m.prefill_step(torch.as_tensor(toks, device=device),
                                    torch.zeros(8, dtype=torch.int32,
                                                device=device))
                nx = m.decode_step(torch.arange(8, dtype=torch.int32,
                                                device=device) % 256,
                                   torch.full((8,), 16, dtype=torch.int32,
                                              device=device), sample=False)
                logits.append((lg.cpu(), nx.cpu()))
            eng = ShiftEngine(models[0], EngineConfig(), shift=models[1])
            reqs = serve.workload(6, 8)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            res[device] = {"logits": logits,
                           "streams": [r.generated for r in reqs],
                           "counts": dict(eng.config_counts)}
        err = max(float((a - b).abs().max())
                  for g, c in zip(res["cuda"]["logits"], res["cpu"]["logits"])
                  for a, b in zip(g, c))
        out[arch] = {"err": err, "streams": res["cuda"]["streams"],
                     "cpu_streams": res["cpu"]["streams"],
                     "counts": res["cuda"]["counts"],
                     "cpu_counts": res["cpu"]["counts"]}
    return out


def pod_reduced_phase(torch):
    """Reduced deepseek-v3-671b and llama4-17b-16e in fp32 on (dp, sp, tp) =
    (2, 2, 2), eight ranks over gloo on the one card (their MoE layers'
    experts across the dp rows: over ("data", "sp") in the base config,
    over ("data",) in the shift config), the card against the CPU in
    every rank's process: the logits within 1e-3, every rank's streams
    and configs equal on both devices."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.monotonic()
    res = run_ranks(pod_reduced_rank, 2, 2, dp=2, device="cuda",
                    backend="gloo", timeout_s=POD_TIMEOUT_S)
    out = {}
    for arch in ("deepseek-v3-671b", "llama4-17b-16e"):
        r0 = res[0][arch]
        for r in res:
            a = r[arch]
            check(a["err"] <= 1e-3, f"pod reduced {arch}: rank {r['rank']}: "
                  f"card against CPU max abs err {a['err']}")
            check(a["streams"] == a["cpu_streams"] == r0["streams"]
                  and a["counts"] == a["cpu_counts"] == r0["counts"],
                  f"pod reduced {arch}: rank {r['rank']}: streams or "
                  "configs differ")
        check(r0["counts"].get("base", 0) > 0
              and r0["counts"].get("shift", 0) > 0,
              f"pod reduced {arch}: configs {r0['counts']}")
        out[arch] = {"max_abs_err": max(r[arch]["err"] for r in res),
                     "configs": r0["counts"]}
        print(f"pod reduced {arch} fp32 on (2, 2, 2), 8 ranks: card "
              f"against CPU max abs err {out[arch]['max_abs_err']} (tol "
              f"1e-3); streams and configs {r0['counts']} equal on every "
              "rank and both devices")
    wall = time.monotonic() - t0
    print(json.dumps({"pod_reduced": dict(out, phase_wall_s=wall)}))
    print(f"pod reduced phase: {wall:.1f} s; card: {card_line()}")


# ---------------------------------------------------------------------------
# phase 5h / 9b: recurrentgemma-9b (RG-LRU and local ring attention)
# ---------------------------------------------------------------------------
RG_HEADROOM = 6e9               # activations, logits and CUDA graphs
RG_LAYOUT_DEPTH = 5             # one (rglru, rglru, local) pattern + suffix
RG_LAYOUT_TIMEOUT_S = 600


def rg_cut(layers):
    """recurrentgemma-9b at full width with ``layers`` layers: the pattern
    repeated ``(layers - 2) / 3`` times and its two suffix RG-LRU
    layers."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    return replace(get_config("recurrentgemma-9b"), num_layers=layers)


def rg_reduced_check(torch, device="cuda"):
    """Reduced recurrentgemma-9b in fp32, the card against the CPU on the
    same weights: the equivalence inputs' prefill (16 tokens against a
    window of 8 and a cache of 32 rows) and two decode steps (positions
    16 and 17: the ring wraps), logits and every cache tensor within
    1e-3; then the dense engine with more requests than slots (s_max 64),
    equal streams and configs. Each output's error is printed beside its
    largest magnitude and beside both runs' distance from a CPU run in
    fp64 (where the model keeps fp32, Λ, the gates' decay and ``h``, that
    run does too). Returns the max abs errors of the logits and caches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    small = get_config("recurrentgemma-9b").reduced()
    gpu = Model(small, device=device, dtype=torch.float32)
    gpu.init_params(torch.Generator(device=device).manual_seed(0))
    state = {k: v.cpu() for k, v in gpu.params.state_dict().items()}
    cpu = Model(small, device="cpu", dtype=torch.float32)
    cpu.load_params(state)
    f64 = Model(small, device="cpu", dtype=torch.float64)
    f64.load_params({k: v.double() for k, v in state.items()})
    models = (gpu, cpu, f64)
    toks = (np.arange(8 * 16, dtype=np.int32).reshape(8, 16) * 7) % 256
    for m in models:
        m.init_cache(8, 32)
    check(gpu.cache.ring_k.shape[2] == small.local_window < 32,
          f"reduced recurrentgemma: ring of {gpu.cache.ring_k.shape[2]} rows")

    def drift(what, outs):
        g, c, x = (t.cpu().double() for t in outs)
        err = compare(torch, f"recurrentgemma reduced fp32 {what}", g, c,
                      1e-3)
        top = x.abs().max().item()
        print(f"reduced recurrentgemma fp32 {what} {tuple(g.shape)}: card "
              f"against CPU {err}, max |value| {top} (relative "
              f"{err / top}); card against fp64 "
              f"{(g - x).abs().max().item()}, CPU against fp64 "
              f"{(c - x).abs().max().item()}")
        return err

    err = drift("logits, prefill", [m.prefill(toks, np.zeros(8, np.int32))[0]
                                    for m in models])
    for pos in (16, 17):
        err = max(err, drift(f"logits, decode at {pos}", [
            m.decode(np.arange(8) % 256, np.full(8, pos), sample=False)[0]
            for m in models]))
    cache_err = max(drift(f"cache {name}", [m.cache.tensors()[name]
                                            for m in models])
                    for name in gpu.cache.tensors())
    runs = []
    for m in (gpu, cpu):
        eng = ShiftEngine(m, EngineConfig(max_slots=2, s_max=64,
                                          prefill_chunk=8))
        reqs = serve.workload(5, 12)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        runs.append(([r.generated for r in reqs], dict(eng.config_counts)))
    check(runs[0] == runs[1], f"reduced recurrentgemma dense engine: card "
          f"{runs[0]} != cpu {runs[1]}")
    print(f"reduced recurrentgemma fp32 (window 8, ring wraps): card against "
          f"CPU logits max abs err {err}, caches {cache_err} (tol 1e-3); the "
          f"dense engine (5 requests on 2 slots) equal streams, configs "
          f"{runs[0][1]}")
    del gpu, cpu, f64
    return err, cache_err


def recurrentgemma_phase(torch):
    """recurrentgemma-9b at full width and depth (38 layers: 12 x
    (rglru, rglru, local) and two RG-LRU layers; d_model 4096, MQA of 16
    heads of 256 over one KV head, window 2048, soft cap 30, GeGLU) in
    bf16 on one card: the bytes reckoned against the free memory (no fit,
    no run), ``seeded_init`` weights, the serve workload through the
    serialized dense engine (its automatic fallback: local and RG-LRU
    layers do not page) in eager, graphed, graphed and eager turns
    (``serve_turns``: equal streams and launches; 77 RMSNorm launches per
    step by the counters and the profiler's trace; the ring attention and
    the RG-LRU scan are plain PyTorch); then ``rg_reduced_check``. Returns
    the first graphed turn's launches and every turn's numbers."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = rg_cut(38)
    ecfg = EngineConfig()
    parts = rank_param_bytes(torch, cfg, Layout(), 0, torch.bfloat16)
    kinds = cfg.layer_kinds
    w = cfg.rglru.lru_width
    ring = (kinds.count("local") * 2 * ecfg.max_slots
            * min(ecfg.s_max, cfg.local_window) * cfg.head_dim * 2)
    state = kinds.count("rglru") * ecfg.max_slots * w * (
        4 + (cfg.rglru.conv1d_width - 1) * 2)
    init = cfg.vocab_size * cfg.d_model * (4 + 2)
    free, total = torch.cuda.mem_get_info()
    need = parts["total"] + ring + state + init + RG_HEADROOM
    print(f"recurrentgemma phase: memory reckoned: weights "
          f"{parts['total'] / 1e9:.2f} GB in bf16 (Λ fp32): embedding and "
          f"head {parts['tables'] / 1e9:.2f} GB, an RG-LRU layer "
          f"{parts['layers'][0] / 1e9:.3f} GB, a local layer "
          f"{parts['layers'][2] / 1e9:.3f} GB; rings {ring / 1e6:.1f} MB, "
          f"RG-LRU state {state / 1e6:.1f} MB; the largest init temporary "
          f"{init / 1e9:.2f} GB; {RG_HEADROOM / 1e9:.0f} GB headroom: "
          f"{need / 1e9:.2f} GB against {free / 1e9:.2f} GB free of "
          f"{total / 1e9:.2f} GB; no cut (38 of 38 layers)")
    check(need <= free, f"recurrentgemma: {need / 1e9:.2f} GB needed, "
          f"{free / 1e9:.2f} GB free")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    seeded_init(torch, model, 0)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    held = sum(p.numel() * p.element_size() for p in model.params.parameters())
    check(held == parts["total"], f"recurrentgemma: {held} B held, reckoned "
          f"{parts['total']}")
    eng = ShiftEngine(model, ecfg)
    check(not eng.paged and not eng.mixed and "non-pageable"
          in eng.paged_disabled_reason, "recurrentgemma: not the dense "
          "fallback")
    for kind in ("prefill", "decode"):
        check(step_launches(eng, kind) == {"rmsnorm": 77},
              f"recurrentgemma: per-step launches {step_launches(eng, kind)}")
    rows = eng.model.cache.ring_k.shape[2]
    print(f"recurrentgemma-9b full width: {cfg.num_layers} layers "
          f"({kinds.count('rglru')} RG-LRU, {kinds.count('local')} local), "
          f"d_model {cfg.d_model}, LRU width {w}, {cfg.num_heads} heads of "
          f"{cfg.head_dim} over {cfg.num_kv_heads} KV head, window "
          f"{cfg.local_window} (ring of {rows} rows at s_max {ecfg.s_max}), "
          f"soft cap {cfg.logits_soft_cap}, d_ff {cfg.d_ff} GeGLU; "
          f"{cfg.num_params() / 1e9:.3f} B params, built in {build_s:.1f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB while "
          f"building; {eng.paged_disabled_reason}")
    del eng
    reqs, launches, turns = serve_turns(torch, model, {},
                                        "recurrentgemma-9b serialized dense")
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / sum(turns[1]["configs"].values())
                for k, v in launches.items() if v}
    check(per_step == {"rmsnorm": 77}, f"recurrentgemma: launches per step "
          f"{per_step}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    err, cache_err = rg_reduced_check(torch)
    gc.collect()
    torch.cuda.empty_cache()
    g = next(st for st in turns if st["graphed"])
    print(f"recurrentgemma-9b [graphed]: TTFT ms " + ", ".join(
        f"{t:.1f}" for t in g["ttft_ms"]) + f"; {g['wall_ms_per_decode_step']:.2f}"
        f" ms per decode step, {g['decode_tokens_per_s']:.1f} decode "
        f"tokens/s, device busy {g['busy_ms_per_step']:.2f} ms per profiled "
        f"decode step ({g['busy_share']:.1%}); 77 RMSNorm launches per step; "
        f"peak {peak:.2f} GB")
    wall = time.monotonic() - t_phase
    print(json.dumps({"recurrentgemma": {
        "layers": cfg.num_layers, "weights_gb": parts["total"] / 1e9,
        "build_s": build_s, "turns": turns, "peak_gb": peak,
        "rmsnorm_per_step": 77, "fp32_reduced_max_abs_err": err,
        "fp32_reduced_cache_err": cache_err, "phase_wall_s": wall}}))
    print(f"recurrentgemma phase: {wall:.1f} s in all; card: {card_line()}")
    return launches, turns


def rg_layout_rank(rank, groups, layers):
    """One rank of recurrentgemma-9b on (sp, tp) = (2, 2) (spawned by
    ``run_ranks``): full width with ``layers`` layers in fp32, base on the
    grid and shift on its ``to_shift()``, built in turn (one init
    temporary on the card at a time), serving the serve workload through
    the serialized dense engine with each step's wall and collective
    bytes kept by config and kind; then the dense cache's invariance."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import invariance as INV
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = rg_cut(layers)
    lay = Layout(sp=2, tp=2)
    torch.cuda.reset_peak_memory_stats()
    models = []
    for turn in range(lay.world):
        if turn == rank:
            for layout in (lay, lay.to_shift()):
                m = Model(cfg, device="cuda", dtype=torch.float32,
                          lay=layout, groups=groups)
                seeded_init(torch, m, 0)
                models.append(m)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    eng = ShiftEngine(models[0], EngineConfig(), shift=models[1])
    walls, traffic = timed_forward(torch, eng, groups,
                                   kinds=("prefill", "decode"))
    reqs = serve.workload(6, 16)
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    return {"rank": rank, "serve_s": time.monotonic() - t0,
            "launches": serve.launch_counts(),
            "streams": [r.generated for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "counts": dict(eng.config_counts),
            "walls": {k: list(v) for k, v in walls.items()},
            "traffic": {k: dict(v) for k, v in traffic.items()},
            "invariance": INV.verify_dense_invariance(eng.base, eng.shift,
                                                      rank),
            "channels": list(INV.rglru_channels(eng.base, rank))[::1024],
            "peak_bytes": torch.cuda.max_memory_allocated()}


def rg_single_rank_streams(torch, layers):
    """The serve workload's streams of a one-rank fp32 engine on the same
    weights at the same depth (``seeded_init`` draws the canonical tensors
    whatever the layout)."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    model = Model(rg_cut(layers), device="cuda", dtype=torch.float32)
    seeded_init(torch, model, 0)
    eng = ShiftEngine(model, EngineConfig())
    reqs = serve.workload(6, 16)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    out = [list(r.generated) for r in reqs]
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recurrentgemma_layout_phase(torch):
    """recurrentgemma-9b at full width, cut to one (rglru, rglru, local)
    pattern and the two suffix RG-LRU layers, in fp32 on (sp, tp) = (2, 2)
    over gloo on the one card (the parent holding nothing while the ranks
    run): base (the RG-LRU's x and y branches and the attention's q, k, v
    through the Ulysses all-to-all, sequence for channel blocks or heads)
    and shift models over one dense cache per rank, the serve workload
    through the serialized dense engine. Every rank's streams equal, and
    equal to a one-rank engine's at the same depth on the same weights;
    launches exact (11 RMSNorm a step); the dense cache's invariance on
    every rank. Prints the base prefill and shift decode walls per step
    and their all-to-all and all-reduce bytes. Returns rank 0's
    launches."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.parallel import Layout
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    layers = RG_LAYOUT_DEPTH
    cfg = rg_cut(layers)
    single = rg_single_rank_streams(torch, layers)
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"recurrentgemma layout phase: the parent still "
          f"holds {held / 1e9:.2f} GB on the card")
    lay = Layout(sp=2, tp=2)
    per_rank = [rank_param_bytes(torch, cfg, la, r, torch.float32)["total"]
                for r in range(lay.world) for la in (lay, lay.to_shift())]
    free, total = torch.cuda.mem_get_info()
    need = sum(per_rank) + lay.world * 2e9 + cfg.vocab_size * cfg.d_model * 4
    print(f"recurrentgemma layout (sp 2, tp 2): {cfg.layer_kinds} at full "
          f"width in fp32; memory reckoned: {sum(per_rank) / 1e9:.2f} GB of "
          f"weights over 4 ranks (base and shift), + 2 GB a rank, one init "
          f"temporary: {need / 1e9:.1f} GB against {free / 1e9:.1f} GB free "
          f"of {total / 1e9:.1f}. Cut: {layers} of 38 layers; widths, heads "
          "and the vocabulary whole")
    check(need <= free, f"recurrentgemma layout: {need / 1e9:.1f} GB "
          f"needed, {free / 1e9:.1f} GB free")
    t0 = time.monotonic()
    res = run_ranks(rg_layout_rank, 2, 2, device="cuda", backend="gloo",
                    timeout_s=RG_LAYOUT_TIMEOUT_S, args=(layers,))
    ran = time.monotonic() - t0
    r0 = res[0]
    steps = sum(r0["counts"].values())
    for r in res:
        check(r["streams"] == r0["streams"] and r["counts"] == r0["counts"],
              f"recurrentgemma layout: rank {r['rank']}'s streams or configs "
              "differ from rank 0's")
        check(all(f == "ok" for f in r["finish"])
              and all(len(x) == 16 for x in r["streams"]),
              f"recurrentgemma layout: rank {r['rank']}: {r['finish']}")
        check(r["launches"] == {k: (11 if k == "rmsnorm" else 0) * steps
                                for k in r["launches"]},
              f"recurrentgemma layout: rank {r['rank']}: launches "
              f"{r['launches']} over {steps} steps, want 11 RMSNorm a step")
        check(r["invariance"], f"recurrentgemma layout: rank {r['rank']}: "
              "the dense cache's invariance failed")
    check(r0["counts"].get("base", 0) > 0 and r0["counts"].get("shift", 0) > 0,
          f"recurrentgemma layout: configs used {r0['counts']}")
    check(r0["streams"] == single, "recurrentgemma layout: the (2, 2) "
          f"streams {r0['streams']} differ from the one-rank run's {single}")
    stats = {}
    for k, w in r0["walls"].items():
        if not w:
            continue
        tr = r0["traffic"][k]
        stats[k] = {"steps": len(w), "wall_ms_per_step": sum(w) / len(w) * 1e3,
                    "all_to_all_bytes_per_step":
                        tr.get("all_to_all_bytes", 0) / len(w),
                    "all_reduce_bytes_per_step":
                        tr.get("all_reduce_bytes", 0) / len(w)}
        print(f"recurrentgemma (2, 2) {k}: {len(w)} steps on rank 0, wall "
              f"{stats[k]['wall_ms_per_step']:.2f} ms per step; per step "
              f"{stats[k]['all_to_all_bytes_per_step'] / 1e6:.3f} MB "
              f"all-to-all, {stats[k]['all_reduce_bytes_per_step'] / 1e6:.3f}"
              " MB all-reduce (payload handed over by the rank)")
    print(f"recurrentgemma (2, 2): 4 ranks ran in {ran:.1f} s; served 6 "
          f"requests x 16 tokens in {r0['serve_s']:.2f} s, {steps} steps "
          f"{r0['counts']}; every rank's streams equal and equal to the "
          f"one-rank run's; invariance held on every rank (RG-LRU channel "
          f"blocks from " + ", ".join(str(r["channels"]) for r in res)
          + "); peak per rank " + ", ".join(
              f"{r['peak_bytes'] / 1e9:.2f}" for r in res) + " GB")
    wall = time.monotonic() - t_phase
    print(json.dumps({"recurrentgemma_layout": {
        "layers": layers, "dtype": "fp32", "configs": r0["counts"],
        "per_config": stats, "serve_s": r0["serve_s"], "run_s": ran,
        "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res],
        "phase_wall_s": wall}}))
    print(f"recurrentgemma layout phase: {wall:.1f} s in all; card: "
          f"{card_line()}")
    return r0["launches"]


# ---------------------------------------------------------------------------
# phases 5i, 5j and 9c: whisper-small and internvl2-2b
# ---------------------------------------------------------------------------
WHISPER_LAYOUT_TIMEOUT_S = 600
# the layout phase's depth (encoder and decoder layers each): at whisper's
# random init the attention is near-hard (score std ~63), so fp32 rounding
# of another summation order moves near-ties and the streams part with
# depth (tools/whisper_fp32_drift.py measures it)
WHISPER_LAYOUT_DEPTH = 2
# internvl2-2b's image embeddings cover the first 256 positions: the serve
# workload's prompts after 256 tokens, so that text reaches the logits
VLM_PREFIX = 256
VLM_KW = {"s_max": 512}


def vlm_workload(n, max_new):
    """The serve workload's requests after ``VLM_PREFIX`` tokens (the
    positions internvl2-2b's vision stub replaces; the serve CLI's shared
    prefix ``1000 ..``): prompts of 275-290 tokens."""
    from repro_torch.launch import serve
    return serve.workload(n, max_new, shared_prefix=VLM_PREFIX)


def engine_streams(eng, reqs):
    """Serve ``reqs`` on ``eng``; (streams, config counts, preemptions)."""
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return ([list(r.generated) for r in reqs], dict(eng.config_counts),
            eng.preemptions)


def card_and_cpu(torch, arch):
    """The reduced ``arch`` in fp32 on the card, randomly initialised, and
    on the CPU with the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    small = get_config(arch).reduced()
    gpu = Model(small, device="cuda", dtype=torch.float32)
    gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(small, device="cpu", dtype=torch.float32)
    cpu.load_params({k: v.cpu() for k, v in gpu.params.state_dict().items()})
    return small, gpu, cpu


def whisper_reduced_check(torch):
    """Reduced whisper-small in fp32, the card against the CPU on the same
    weights: the equivalence inputs (8 rows of 16 tokens, random frames of
    16 x 64) through a prefill step and two decode steps, the logits and
    every cache tensor (the self and the cross K/V) within 1e-3; then the
    dense engine with more requests than slots, equal streams and configs.
    Returns the max abs errors of the logits and of the caches."""
    import numpy as np
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    small, gpu, cpu = card_and_cpu(torch, "whisper-small")
    toks = (np.arange(8 * 16, dtype=np.int32).reshape(8, 16) * 7) % 256
    frames = np.random.default_rng(0).standard_normal(
        (8, small.encoder_seq, small.d_model)).astype(np.float32)
    for m in (gpu, cpu):
        m.init_cache(8, 32)
    err = compare(torch, "whisper reduced fp32 prefill logits",
                  *[m.prefill(toks, np.zeros(8, np.int32),
                              enc_frames=frames)[0].cpu() for m in (gpu, cpu)],
                  1e-3)
    for pos in (16, 17):
        err = max(err, compare(
            torch, f"whisper reduced fp32 decode logits at {pos}",
            *[m.decode(np.arange(8) % 256, np.full(8, pos),
                       sample=False)[0].cpu() for m in (gpu, cpu)], 1e-3))
    names = sorted(gpu.cache.tensors())
    check(names == ["cross_k", "cross_v", "k", "v"],
          f"whisper reduced: cache tensors {names}")
    cache_err = max(compare(torch, f"whisper reduced fp32 cache {n}",
                            gpu.cache.tensors()[n].cpu(),
                            cpu.cache.tensors()[n], 1e-3) for n in names)
    runs = [engine_streams(ShiftEngine(m, EngineConfig(
        max_slots=2, s_max=64, prefill_chunk=8)), serve.workload(5, 12))
        for m in (gpu, cpu)]
    check(runs[0] == runs[1], f"reduced whisper dense engine: card "
          f"{runs[0]} != cpu {runs[1]}")
    print(f"reduced whisper-small fp32: card against CPU logits max abs err "
          f"{err}, caches (self and cross) {cache_err} (tol 1e-3); the dense "
          f"engine (5 requests on 2 slots) equal streams, configs "
          f"{runs[0][1]}")
    del gpu, cpu
    return err, cache_err


def whisper_phase(torch):
    """whisper-small at full width and depth (12 encoder layers over 1536
    frames, 12 decoder layers, d_model 768, 12 heads of 64 over 12 KV
    heads, LayerNorm, the plain GELU MLP) in bf16 on one card,
    ``seeded_init`` weights: the serve workload through the serialized
    dense engine (its automatic fallback: an encoder-decoder stack does
    not page; every prefill step runs the encoder over the engine's zero
    frames and rewrites the cross caches), eager, graphed, graphed and
    eager turns (``serve_turns``: equal streams and launches; 36 flash
    launches per prefill step, 24 decode launches per decode step, no
    RMSNorm, by the counters and the profiler's trace); then
    ``whisper_reduced_check``. Returns the first graphed turn's launches
    and every turn's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.models import Model
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("whisper-small")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    seeded_init(torch, model, 0)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    held = sum(p.numel() * p.element_size() for p in model.params.parameters())
    eng = ShiftEngine(model, EngineConfig())
    check(not eng.paged and not eng.mixed and "non-pageable"
          in eng.paged_disabled_reason, "whisper: not the dense fallback")
    want = {"prefill": {"flash_attention": 36}, "decode":
            {"decode_attention": 24}}
    for kind, w in want.items():
        check(step_launches(eng, kind) == w, f"whisper: per-step launches "
              f"{step_launches(eng, kind)}")
    cross = sum(eng.model.cache.tensors()[n].numel() * 2
                for n in ("cross_k", "cross_v"))
    print(f"whisper-small full width: {cfg.encoder_layers} encoder layers "
          f"over {cfg.encoder_seq} frames, {cfg.num_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim} "
          f"over {cfg.num_kv_heads} KV heads; {cfg.num_params() / 1e9:.3f} "
          f"B params ({held / 1e9:.3f} GB bf16), built in {build_s:.1f} s; "
          f"cross caches {cross / 1e9:.3f} GB for {EngineConfig().max_slots}"
          f" slots; {eng.paged_disabled_reason}")
    del eng
    reqs, launches, turns = serve_turns(torch, model, {},
                                        "whisper-small serialized dense")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    gc.collect()
    torch.cuda.empty_cache()
    err, cache_err = whisper_reduced_check(torch)
    gc.collect()
    torch.cuda.empty_cache()
    g = next(st for st in turns if st["graphed"])
    print(f"whisper-small [graphed]: TTFT ms " + ", ".join(
        f"{t:.1f}" for t in g["ttft_ms"]) + f"; "
        f"{g['wall_ms_per_decode_step']:.2f} ms per decode step, "
        f"{g['decode_tokens_per_s']:.1f} decode tokens/s, device busy "
        f"{g['busy_ms_per_step']:.2f} ms per profiled decode step "
        f"({g['busy_share']:.1%}); 36 flash per prefill step, 24 decode per "
        f"decode step, no RMSNorm; peak {peak:.2f} GB")
    wall = time.monotonic() - t_phase
    print(json.dumps({"whisper": {
        "weights_gb": held / 1e9, "cross_cache_gb": cross / 1e9,
        "build_s": build_s, "turns": turns, "peak_gb": peak,
        "launches_per_step": want, "fp32_reduced_max_abs_err": err,
        "fp32_reduced_cache_err": cache_err, "phase_wall_s": wall}}))
    print(f"whisper phase: {wall:.1f} s in all; card: {card_line()}")
    return launches, turns


def internvl2_reduced_check(torch):
    """Reduced internvl2-2b in fp32 (8 image embeddings), the card against
    the CPU on the same weights, each path on its own: the mixed paged,
    serialized paged and serialized dense engines with the serve workload
    (prompts past the stub), equal streams, configs and preemptions; and
    one prefill step with random image embeddings, logits within 1e-3.
    Returns the logits' max abs error."""
    import numpy as np
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    small, gpu, cpu = card_and_cpu(torch, "internvl2-2b")
    fe = np.random.default_rng(0).standard_normal(
        (8, small.frontend_seq, small.d_model)).astype(np.float32)
    toks = (np.arange(8 * 16, dtype=np.int32).reshape(8, 16) * 7) % 256
    for m in (gpu, cpu):
        m.init_cache(8, 32)
    err = compare(torch, "internvl2 reduced fp32 prefill logits",
                  *[m.prefill(toks, np.zeros(8, np.int32),
                              frontend_embeds=fe)[0].cpu()
                    for m in (gpu, cpu)], 1e-3)
    for path, kw in (("mixed", {}), ("serialized paged", {"mixed": False}),
                     ("serialized dense", {"paged": False, "mixed": False})):
        runs = [engine_streams(ShiftEngine(m, EngineConfig(**kw)),
                               serve.workload(6, 8)) for m in (gpu, cpu)]
        check(runs[0] == runs[1], f"reduced internvl2 {path}: card "
              f"{runs[0]} != cpu {runs[1]}")
        print(f"reduced internvl2-2b fp32 {path}: card and CPU equal "
              f"streams, configs {runs[0][1]}, {runs[0][2]} preemptions")
    print(f"reduced internvl2-2b fp32: prefill logits with random image "
          f"embeddings, card against CPU max abs err {err} (tol 1e-3)")
    del gpu, cpu
    return err


def internvl2_phase(torch):
    """internvl2-2b at full width and depth (24 GQA layers, d_model 2048,
    16 q heads over 8 KV heads, the vision stub over the first 256
    positions) in bf16 on one card, ``seeded_init`` weights: the serve
    workload's prompts after 256 tokens (s_max 512), so that text tokens
    reach the logits, through the mixed paged engine and its zero image
    embeddings, eager, graphed, graphed and eager (``serve_turns``: equal
    streams and launches; 49 RMSNorm and 24 ragged launches per step, by
    the counters and the profiler's trace); then
    ``internvl2_reduced_check``. Returns the first graphed turn's
    launches and every turn's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.models import Model
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("internvl2-2b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    seeded_init(torch, model, 0)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    held = sum(p.numel() * p.element_size() for p in model.params.parameters())
    eng = ShiftEngine(model, EngineConfig(**VLM_KW))
    check(eng.paged and eng.mixed, "internvl2: not the mixed paged engine")
    want = {"rmsnorm": 49, "paged_ragged_attention": 24}
    check(step_launches(eng, "mixed") == want, f"internvl2: per-step "
          f"launches {step_launches(eng, 'mixed')}")
    print(f"internvl2-2b full width: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} q heads over {cfg.num_kv_heads} "
          f"KV heads of {cfg.head_dim}, vision stub over {cfg.frontend_seq} "
          f"positions; {cfg.num_params() / 1e9:.3f} B params "
          f"({held / 1e9:.2f} GB bf16), built in {build_s:.1f} s; pool "
          f"{eng.kv.num_blocks} blocks of {eng.cfg.block_size} at s_max "
          f"{eng.cfg.s_max}; prompts of {len(vlm_workload(6, 1)[0].prompt)}"
          f"-{len(vlm_workload(6, 1)[-1].prompt)} tokens")
    del eng
    reqs, launches, turns = serve_turns(torch, model, VLM_KW,
                                        "internvl2-2b mixed paged",
                                        vlm_workload)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    gc.collect()
    torch.cuda.empty_cache()
    err = internvl2_reduced_check(torch)
    gc.collect()
    torch.cuda.empty_cache()
    g = next(st for st in turns if st["graphed"])
    print(f"internvl2-2b [graphed]: TTFT ms " + ", ".join(
        f"{t:.1f}" for t in g["ttft_ms"]) + f"; "
        f"{g['wall_ms_per_decode_step']:.2f} ms per decode step, "
        f"{g['decode_tokens_per_s']:.1f} decode tokens/s, device busy "
        f"{g['busy_ms_per_step']:.2f} ms per profiled decode step "
        f"({g['busy_share']:.1%}); 49 RMSNorm and 24 ragged per step; peak "
        f"{peak:.2f} GB")
    wall = time.monotonic() - t_phase
    print(json.dumps({"internvl2": {
        "weights_gb": held / 1e9, "build_s": build_s, "turns": turns,
        "peak_gb": peak, "launches_per_step": want,
        "fp32_reduced_max_abs_err": err, "phase_wall_s": wall}}))
    print(f"internvl2 phase: {wall:.1f} s in all; card: {card_line()}")
    return launches, turns


def whisper_cut(layers):
    """whisper-small at full width with ``layers`` encoder and decoder
    layers."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    return replace(get_config("whisper-small"), num_layers=layers,
                   encoder_layers=layers)


def whisper_layout_rank(rank, groups, layers):
    """One rank of whisper-small on (sp, tp) = (2, 2) (spawned by
    ``run_ranks``): full width in fp32 with ``layers`` encoder and decoder
    layers, base on the grid and shift on its ``to_shift()``, built in
    turn, serving the serve workload
    through the serialized dense engine with each step's wall and
    collective bytes kept by config and kind, its launches against the
    per-step counts; then the dense cache's invariance, the cross cache
    included."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import invariance as INV
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = whisper_cut(layers)
    lay = Layout(sp=2, tp=2)
    torch.cuda.reset_peak_memory_stats()
    models = []
    for turn in range(lay.world):
        if turn == rank:
            for layout in (lay, lay.to_shift()):
                m = Model(cfg, device="cuda", dtype=torch.float32,
                          lay=layout, groups=groups)
                seeded_init(torch, m, 0)
                models.append(m)
            torch.cuda.synchronize()
        dist.barrier()
    eng = ShiftEngine(models[0], EngineConfig(), shift=models[1])
    walls, traffic = timed_forward(torch, eng, groups,
                                   kinds=("prefill", "decode"))
    kinds = count_steps(eng)
    reqs = serve.workload(6, 16)
    serve.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
        eng.submit(r)
    eng.run_until_idle()
    torch.cuda.synchronize()
    want = {name: 0 for name in serve.launch_counts()}
    for kind, n in kinds.items():
        for name, k in step_launches(eng, kind).items():
            want[name] += n * k
    return {"rank": rank, "serve_s": time.monotonic() - t0,
            "launches": serve.launch_counts(), "want": want,
            "streams": [r.generated for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "counts": dict(eng.config_counts),
            "walls": {k: list(v) for k, v in walls.items()},
            "traffic": {k: dict(v) for k, v in traffic.items()},
            "invariance": INV.verify_dense_invariance(eng.base, eng.shift,
                                                      rank),
            "slots": list(INV.kv_slots(eng.base, rank)),
            "cross_shape": list(eng.base.cache.cross_k.shape),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def whisper_layout_phase(torch, layers=WHISPER_LAYOUT_DEPTH):
    """whisper-small at full width in fp32, cut to ``layers`` encoder and
    decoder layers, on (sp, tp) = (2, 2) over gloo on the one card (the
    parent holding nothing while the ranks run): base (the encoder's
    frames and every chunk through the Ulysses all-to-all, the cross K/V
    scattered with the KV replication) and shift models over one dense
    cache per rank, the serve workload through the serialized dense
    engine. Every rank's streams equal, and equal to a one-rank fp32
    engine's on the same weights; launches exact (3 x ``layers`` flash a
    prefill step, 2 x ``layers`` decode a decode step); the dense cache's
    invariance on every rank, the cross cache included. Prints the base
    prefill and shift decode walls per step and their all-to-all and
    all-reduce bytes. Returns rank 0's launches."""
    from repro_torch.engine import EngineConfig, ShiftEngine
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import Model
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(whisper_cut(layers), device="cuda", dtype=torch.float32)
    seeded_init(torch, model, 0)
    single = engine_streams(ShiftEngine(model, EngineConfig()),
                            serve.workload(6, 16))[0]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"whisper layout phase: the parent still holds "
          f"{held / 1e9:.2f} GB on the card")
    t0 = time.monotonic()
    res = run_ranks(whisper_layout_rank, 2, 2, device="cuda",
                    backend="gloo", timeout_s=WHISPER_LAYOUT_TIMEOUT_S,
                    args=(layers,))
    ran = time.monotonic() - t0
    r0 = res[0]
    steps = sum(r0["counts"].values())
    for r in res:
        check(r["streams"] == r0["streams"] and r["counts"] == r0["counts"],
              f"whisper layout: rank {r['rank']}'s streams or configs "
              "differ from rank 0's")
        check(all(f == "ok" for f in r["finish"])
              and all(len(x) == 16 for x in r["streams"]),
              f"whisper layout: rank {r['rank']}: {r['finish']}")
        check(r["launches"] == r["want"], f"whisper layout: rank "
              f"{r['rank']}: launches {r['launches']}, want {r['want']}")
        check(r["invariance"], f"whisper layout: rank {r['rank']}: the "
              "dense cache's invariance failed")
    check(r0["counts"].get("base", 0) > 0 and r0["counts"].get("shift", 0) > 0,
          f"whisper layout: configs used {r0['counts']}")
    check(r0["streams"] == single, "whisper layout: the (2, 2) streams "
          f"{r0['streams']} differ from the one-rank run's {single}")
    stats = {}
    for k, w in r0["walls"].items():
        if not w:
            continue
        tr = r0["traffic"][k]
        stats[k] = {"steps": len(w), "wall_ms_per_step": sum(w) / len(w) * 1e3,
                    "all_to_all_bytes_per_step":
                        tr.get("all_to_all_bytes", 0) / len(w),
                    "all_reduce_bytes_per_step":
                        tr.get("all_reduce_bytes", 0) / len(w)}
        print(f"whisper (2, 2) {k}: {len(w)} steps on rank 0, wall "
              f"{stats[k]['wall_ms_per_step']:.2f} ms per step; per step "
              f"{stats[k]['all_to_all_bytes_per_step'] / 1e6:.3f} MB "
              f"all-to-all, {stats[k]['all_reduce_bytes_per_step'] / 1e6:.3f}"
              " MB all-reduce (payload handed over by the rank)")
    print(f"whisper (2, 2), {layers} encoder and {layers} decoder layers "
          f"of 12 at full width, fp32: 4 ranks ran in {ran:.1f} s; served 6 "
          f"requests x "
          f"16 tokens in {r0['serve_s']:.2f} s, {steps} steps "
          f"{r0['counts']}; every rank's streams equal and equal to the "
          f"one-rank run's; launches {r0['launches']}; invariance held on "
          f"every rank (kv slots " + ", ".join(str(r["slots"]) for r in res)
          + f", cross cache {r0['cross_shape']} a rank); peak per rank "
          + ", ".join(f"{r['peak_bytes'] / 1e9:.2f}" for r in res) + " GB")
    wall = time.monotonic() - t_phase
    print(json.dumps({"whisper_layout": {
        "layers": layers, "dtype": "fp32", "configs": r0["counts"],
        "per_config": stats,
        "serve_s": r0["serve_s"], "run_s": ran,
        "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res],
        "phase_wall_s": wall}}))
    print(f"whisper layout phase: {wall:.1f} s in all; card: {card_line()}")
    return r0["launches"]


# ---------------------------------------------------------------------------
# training: the backward kernels, qwen3-8b at full width, card against CPU,
# and the (2, 2) layout over gloo
# ---------------------------------------------------------------------------
FLASH_BWD_SHAPE = dict(B=2, S=2048, Hq=32, Hkv=8, D=128)   # a microbatch
MOE_FLASH_BWD_SHAPE = dict(B=2, S=2048, Hq=32, Hkv=4, D=128)
TRAIN_LAYERS = 12          # qwen3-8b's 36 layers cut to 12
MOE_TRAIN_LAYERS = 4       # qwen-30b-a3b's 48 layers cut to 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2048, 2, 6
TRAIN_LR = 3e-4
# a backward kernel's rows against its plain version's (``row_rel_err``):
# bf16 as its max-abs rule; fp32 ten times its 1e-4, since a row that is 0
# in exact arithmetic (dQ of a causal row's first query) keeps fp32
# cancellation noise of ~1e-6, a few 1e-4 of the floor
ROW_TOLS = {"torch.bfloat16": 2e-2, "torch.float32": 1e-3}


def rel_compare(torch, what, got, want, tol):
    """Max abs error of ``got`` against ``want``; fails unless finite and
    within ``tol`` times ``want``'s largest entry (a gradient's scale)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    check(torch.isfinite(g).all(), f"{what}: non-finite output")
    check(err <= tol * max(scale, 1e-30),
          f"{what}: max abs err {err} > {tol} x {scale}")
    return err


def row_rel_err(torch, got, want):
    """The largest error of a row of ``got`` (its last dim: one token's and
    head's gradient) against ``want``'s row, relative to that row's norm
    plus 1 % of the rms row norm (a floor for rows that are 0 in exact
    arithmetic, such as dQ of a causal row's first query). So every row is
    held to its own scale: a row of small gradients (dV of a late key, dQ
    of a late query) is checked as closely as a large one."""
    g, w = (t.float().reshape(-1, t.shape[-1]) for t in (got, want))
    wn = w.norm(dim=1)
    floor = 1e-2 * wn.square().mean().sqrt()
    return ((g - w).norm(dim=1) / (wn + floor)).max().item()


def grad_compare(torch, what, got, want, tol):
    """A gradient against its plain version: within ``tol`` of its largest
    entry (``rel_compare``) and every row within ``ROW_TOLS[dtype]`` of its
    own norm (``row_rel_err``). Returns (max abs error, max row error)."""
    err = rel_compare(torch, what, got, want, tol)
    row = row_rel_err(torch, got, want)
    row_tol = ROW_TOLS[str(got.dtype)]
    check(row <= row_tol, f"{what}: a row's relative error {row} > "
          f"{row_tol}")
    return err, row


def flash_bwd_case(torch, dtype, timer, tol, B, S, Hq, Hkv, D,
                   case="training microbatch"):
    """The flash backward at a training microbatch (causal, zero offsets)
    against its plain version, twice (bitwise equal: no atomics), timed
    beside the plain version and SDPA's backward through autograd over K/V
    expanded to Hq heads; the forward's training instance timed beside
    SDPA's forward on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_attention_bwd as FAB
    gen = torch.Generator(device="cuda").manual_seed(S + D)
    q, do = (torch.randn((B, S, Hq, D), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    off = torch.zeros((B,), dtype=torch.int32, device="cuda")
    out, lse = FA.flash_attention_cuda(q, k, v, off, causal=True,
                                       return_lse=True)
    # the forward's training instance: its log-sum-exp against the plain
    # version's, and its time beside the serving instance's
    _, lse_plain = FA.flash_attention_plain(q, k, v, off, causal=True,
                                            return_lse=True)
    lse_err = rel_compare(torch, f"flash forward lse {dtype}", lse,
                          lse_plain, 1e-4)
    fwd_lse_ms = timer(lambda: FA.flash_attention_cuda(q, k, v, off,
                                                       causal=True,
                                                       return_lse=True))
    fwd_ms = timer(lambda: FA.flash_attention_cuda(q, k, v, off,
                                                   causal=True))
    args = (q, k, v, out, lse, do, off)
    got = FAB.flash_attention_bwd_cuda(*args)
    again = FAB.flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash bwd {dtype}: two runs differ")
    want = FAB.flash_attention_bwd_plain(*args)
    errs = [grad_compare(torch, f"flash bwd d{n} {dtype}", a, b, tol)
            for n, a, b in zip("qkv", got, want)]
    err, row_err = (max(e) for e in zip(*errs))
    ms = timer(lambda: FAB.flash_attention_bwd_cuda(*args))
    plain_ms = timer(lambda: FAB.flash_attention_bwd_plain(*args), iters=3)
    g = Hq // Hkv
    qs = q.transpose(1, 2).detach().clone().requires_grad_(True)
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1).detach().clone() \
        .requires_grad_(True)
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1).detach().clone() \
        .requires_grad_(True)
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    dos = do.transpose(1, 2).contiguous()
    library_ms = timer(lambda: torch.autograd.grad(o, (qs, ks, vs), dos,
                                                   retain_graph=True))
    with torch.no_grad():   # the forward's yardstick: SDPA's forward alone
        library_fwd_ms = timer(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True))
    elt = q.element_size()
    pairs = B * S * (S + 1) // 2
    flops = 5 * 2 * pairs * Hq * D           # S, dP, dV, dQ, dK
    nbytes = (3 * q.numel() + 4 * k.numel()) * elt + 2 * lse.numel() * 4 \
        + q.numel() * elt                    # q, out, dout, dq; k, v, dk, dv
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return rates({"case": case, "dtype":
                  str(dtype).replace("torch.", ""),
                  "shape": {"q": list(q.shape), "kv": list(k.shape),
                            "causal": True}, "tol": tol,
                  "row_tol": ROW_TOLS[str(dtype)],
                  "tol_of": "tol: the largest entry of each gradient; "
                  "row_tol: each row's norm plus 1 % of the rms row norm",
                  "max_abs_err": err, "max_row_rel_err": row_err,
                  "bitwise_repeat": True, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "forward_lse_ms": fwd_lse_ms, "forward_ms": fwd_ms,
                  "forward_library_ms": library_fwd_ms,
                  "lse_max_abs_err": lse_err}, flops)


def rmsnorm_bwd_case(torch, name, dtype, timer, tol, x_shape, s_shape,
                     pair_k=None, row_stride=None):
    """The RMSNorm backward (dx and dscale) against its plain version,
    twice (bitwise equal), timed beside the plain version and, for plain
    rows, ``F.rms_norm``'s backward through autograd. ``pair_k``: the
    k rows of a q/k pair in the same call. ``row_stride``: x is the first
    columns of rows that long, a strided view (MLA's kv latent norm)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm_bwd as RB
    gen = torch.Generator(device="cuda").manual_seed(sum(x_shape))

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    x, dy, s = rnd(x_shape), rnd(x_shape), rnd(s_shape)
    if row_stride is not None:
        x = rnd(x_shape[:-1] + (row_stride,))[..., :x_shape[-1]]
    if pair_k is not None:
        k, dk, sk = rnd(pair_k), rnd(pair_k), rnd(s_shape)
        args = (x, s, dy, k, sk, dk)
        run = lambda: RB.rmsnorm_pair_bwd_cuda(*args)  # noqa: E731
        plain = lambda: RB.rmsnorm_pair_bwd_plain(*args)  # noqa: E731
        n_el = x.numel() + k.numel()
    else:
        args = (x, s, dy)
        run = lambda: RB.rmsnorm_bwd_cuda(*args)  # noqa: E731
        plain = lambda: RB.rmsnorm_bwd_plain(*args)  # noqa: E731
        n_el = x.numel()
    got, again = run(), run()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"rmsnorm bwd {name} {dtype}: two runs differ")
    want = plain()
    errs = [grad_compare(torch, f"rmsnorm bwd {name} {dtype}", a, b, tol)
            for a, b in zip(got, want)]
    err, row_err = (max(e) for e in zip(*errs))
    ms = timer(run)
    plain_ms = timer(plain, iters=3)
    library_ms = None
    if pair_k is None and len(s_shape) == 1:
        xl = x.detach().clone().requires_grad_(True)
        sl = s.detach().clone().requires_grad_(True)
        yl = F.rms_norm(xl, (x_shape[-1],), weight=sl, eps=1e-6)
        library_ms = timer(lambda: torch.autograd.grad(yl, (xl, sl), dy,
                                                       retain_graph=True))
    elt = x.element_size()
    nbytes = (3 * n_el + 4 * s.numel()) * elt
    bound_ms, bound_by = bound(nbytes, 8 * n_el, torch.float32)
    return {"case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"x": list(x_shape), "scale": list(s_shape),
                      **({"k": list(pair_k)} if pair_k else {}),
                      **({"row_stride": row_stride} if row_stride else {})},
            "tol": tol, "row_tol": ROW_TOLS[str(dtype)],
            "tol_of": "tol: the largest entry of dx and of dscale; row_tol: "
            "each row's norm plus 1 % of the rms row norm",
            "max_abs_err": err, "max_row_rel_err": row_err,
            "bitwise_repeat": True, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms}


def ssd_chunk_bwd_case(torch, name, dtype, timer, tol, B, S, H, hd, ds, L):
    """The SSD chunk's backward (dx, db, dc, ddt, dcum) against its plain
    version, twice (bitwise equal: no atomics), on the forward's inputs as
    the model hands them over (x, b and c views of one conv output; dt the
    softplus of a draw, cum its chunked cumsum times -A) and random
    cotangents; timed beside the plain version and beside autograd through
    ``ssd_chunk_plain`` (the gradient the port would take without the
    kernel). No single PyTorch call computes this function: library_ms is
    None."""
    from repro_torch.kernels import ssd_chunk_bwd as SB
    from repro_torch.kernels import ssd_scan as SSD
    gen = torch.Generator(device="cuda").manual_seed(B * S + H + hd)
    xc = torch.randn((B, S, H * hd + 2 * ds), generator=gen,
                     device="cuda").to(dtype)
    x = xc[..., :H * hd].reshape(B, S, H, hd)
    b, c = xc[..., H * hd:H * hd + ds], xc[..., H * hd + ds:]
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    A = torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    cum = (-dt * A).reshape(B, S // L, L, H).cumsum(2).reshape(B, S, H)
    nc = S // L
    dy = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    dst = torch.randn((B, nc, H, hd, ds), generator=gen, device="cuda")
    ddec = torch.randn((B, S, H), generator=gen, device="cuda")
    args = (x, b, c, dt, cum, dy, dst, ddec, L)
    got = SB.ssd_chunk_bwd_cuda(*args)
    again = SB.ssd_chunk_bwd_cuda(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"ssd_chunk bwd {name} {dtype}: two runs differ")
    want = SB.ssd_chunk_bwd_plain(*args)
    errs = [grad_compare(torch, f"ssd_chunk bwd {name} {dtype} d{part}",
                         g, w, tol)
            for part, g, w in zip(("x", "b", "c", "dt", "cum"), got, want)]
    err, row_err = (max(e) for e in zip(*errs))
    ms = timer(lambda: SB.ssd_chunk_bwd_cuda(*args))
    plain_ms = timer(lambda: SB.ssd_chunk_bwd_plain(*args), iters=3)
    ins = [t.detach().clone().requires_grad_(True) for t in (x, b, c, dt,
                                                            cum)]
    per_head = [t[:, :, None].expand(B, S, H, ds) for t in ins[1:3]]
    outs = SSD.ssd_chunk_plain(ins[0], *per_head, ins[3], ins[4], L)
    autograd_ms = timer(lambda: torch.autograd.grad(
        outs, ins, (dy, dst, ddec), retain_graph=True), iters=3)
    del outs, per_head, ins
    elt = x.element_size()
    nbytes = ((x.numel() + 2 * B * S * ds) * elt      # x, b, c
              + 3 * B * S * H * 4                      # dt, cum, ddec
              + 2 * B * S * H * hd * 4                 # dy, dx
              + dst.numel() * 4                        # dS_c
              + 2 * B * S * ds * 4 + 2 * B * S * H * 4)  # db, dc, ddt, dcum
    tri = L * (L + 1) // 2                  # (t, s) pairs with s <= t
    # c·bᵀ once a chunk; per head dM, Mᵀ·dy, b·dS_cᵀ, G·b, Gᵀ·c, (x·w)·dS_c
    fmas = B * nc * (tri * ds + H * (2 * tri * hd + 2 * tri * ds
                                     + 2 * L * hd * ds))
    bound_ms, bound_by = bound(nbytes, 2 * fmas, dtype)
    fp32_peak_ms, _ = bound(nbytes, 2 * fmas, torch.float32)
    return {"case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"x": [B, S, H, hd], "bc": [B, S, ds], "chunk": L},
            "tol": tol, "row_tol": ROW_TOLS[str(dtype)],
            "tol_of": "tol: the largest entry of each gradient; row_tol: "
            "each row's norm plus 1 % of the rms row norm",
            "max_abs_err": err, "max_row_rel_err": row_err,
            "bitwise_repeat": True, "ms": ms, "plain_ms": plain_ms,
            "autograd_plain_ms": autograd_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "bound_at_fp32_peak_ms": fp32_peak_ms,
            "mbytes": nbytes / 1e6, "gflop": 2 * fmas / 1e9}


# the SSD chunk backward's cases: mamba2-1.3b's training microbatch, its
# per-rank heads on (1, 2, 2), one chunk shorter than L, and the reference's
# reduced config (fp32 only)
SSD_BWD_CASES = (("mamba2-1.3b training microbatch", 2, 2048, 64, 64, 128, 64),
                 ("per rank on (1, 2, 2)", 2, 2048, 16, 64, 128, 64),
                 ("one short chunk", 2, 40, 64, 64, 128, 40))
SSD_BWD_REDUCED = ("reduced config", 8, 16, 8, 16, 16, 8)


def backward_kernel_phase(torch, cases):
    """Phase 3's rows of the two backward kernels of training, bf16 first:
    flash at a microbatch of qwen3-8b (B 2 x S 2048, 32 over 8 heads of
    128, causal); RMSNorm over [4096, 4096] (a microbatch's ln rows), the
    q/k pair over its 4096 x 32 q rows and 4096 x 8 k rows of 128 in one
    call, and grouped over 64 heads of 64 (mamba2's norm). Then, in bf16,
    the same at qwen-30b-a3b's training shapes (``MOE_FLASH_BWD_SHAPE``:
    32 over 4 heads; ln rows [4096, 2048]; the pair's 4096 x 32 q rows and
    4096 x 4 k rows)."""
    timer = Timer(torch)
    tols = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    for kernel in ("flash_attention_bwd", "rmsnorm_bwd", "ssd_chunk_bwd"):
        cases[kernel] = []

    def add(kernel, case):
        cases[kernel].append(case)
        print(kernel, json.dumps(case))
    for dtype in (torch.bfloat16, torch.float32):
        tol = tols[dtype]
        add("flash_attention_bwd", flash_bwd_case(torch, dtype, timer, tol,
                                                  **FLASH_BWD_SHAPE))
        add("rmsnorm_bwd", rmsnorm_bwd_case(torch, "ln rows", dtype, timer,
                                            tol, (4096, 4096), (4096,)))
        add("rmsnorm_bwd", rmsnorm_bwd_case(
            torch, "q/k pair", dtype, timer, tol, (4096 * 32, 128), (128,),
            pair_k=(4096 * 8, 128)))
        add("rmsnorm_bwd", rmsnorm_bwd_case(
            torch, "grouped, 64 heads", dtype, timer, tol, (512, 64, 64),
            (64, 64)))
    bf16 = torch.bfloat16
    tol = tols[bf16]
    add("flash_attention_bwd", flash_bwd_case(
        torch, bf16, timer, tol, case="qwen-30b-a3b training microbatch",
        **MOE_FLASH_BWD_SHAPE))
    add("rmsnorm_bwd", rmsnorm_bwd_case(
        torch, "qwen-30b-a3b ln rows", bf16, timer, tol, (4096, 2048),
        (2048,)))
    add("rmsnorm_bwd", rmsnorm_bwd_case(
        torch, "qwen-30b-a3b q/k pair", bf16, timer, tol, (4096 * 32, 128),
        (128,), pair_k=(4096 * 4, 128)))
    # the training rows of deepseek-v3-671b (ln rows of 7168, the q latent
    # of 1536, the kv latent's 512 of 576 columns, a strided view) and of
    # mamba2-1.3b (ln rows of 2048; its grouped norm is the 64-head case)
    add("rmsnorm_bwd", rmsnorm_bwd_case(
        torch, "deepseek-v3-671b ln rows", bf16, timer, tol, (4096, 7168),
        (7168,)))
    add("rmsnorm_bwd", rmsnorm_bwd_case(
        torch, "deepseek-v3-671b q latent", bf16, timer, tol, (4096, 1536),
        (1536,)))
    add("rmsnorm_bwd", rmsnorm_bwd_case(
        torch, "deepseek-v3-671b kv latent, 512 of 576 columns", bf16,
        timer, tol, (4096, 512), (512,), row_stride=576))
    add("rmsnorm_bwd", rmsnorm_bwd_case(
        torch, "mamba2-1.3b ln rows", bf16, timer, tol, (4096, 2048),
        (2048,)))
    for dtype in (torch.bfloat16, torch.float32):
        for shape in SSD_BWD_CASES:
            add("ssd_chunk_bwd", ssd_chunk_bwd_case(torch, shape[0], dtype,
                                                    timer, tols[dtype],
                                                    *shape[1:]))
    add("ssd_chunk_bwd", ssd_chunk_bwd_case(
        torch, SSD_BWD_REDUCED[0], torch.float32, timer,
        tols[torch.float32], *SSD_BWD_REDUCED[1:]))
    torch.cuda.synchronize()


def train_layers(torch, cfg, layers):
    """The depth of ``cfg`` that a training phase runs: the fixed
    ``layers`` (``TRAIN_LAYERS``, 12 of qwen3-8b's 36;
    ``MOE_TRAIN_LAYERS``, 4 of qwen-30b-a3b's 48). The memory reckoning
    only checks that it fits the card: every parameter takes ~16 bytes
    (bf16 weight and gradient, an fp32 gradient sum, fp32 m and v), the LM
    head's fp32 logits and their temporaries about four copies of [B/micro
    x S, V] fp32, plus 4 GB of other activations."""
    free, total = torch.cuda.mem_get_info()
    per_layer = 16 * (replace_layers(cfg, 2).num_params()
                      - replace_layers(cfg, 1).num_params())
    fixed = 16 * replace_layers(cfg, 1).num_params() - per_layer \
        + 4 * 4 * (TRAIN_BATCH // TRAIN_MICRO) * TRAIN_SEQ * cfg.vocab_size \
        + 4e9
    fit = int((free - fixed) // per_layer)
    print(f"training depth of {cfg.name}: the fixed {layers} of "
          f"{cfg.num_layers} layers reckon "
          f"{(fixed + layers * per_layer) / 1e9:.1f} GB; {fit} would fit in "
          f"{free / 1e9:.1f} GB free of {total / 1e9:.1f} GB "
          f"({per_layer / 1e9:.2f} GB a layer, {fixed / 1e9:.1f} GB fixed)")
    check(fit >= layers, f"{layers} layers of {cfg.name} do not fit this "
          f"card's training memory ({fit} do)")
    return layers


def synthetic_batch(vocab):
    """The synthetic corpus's first batch of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` (``repro_torch.data``): (tokens, labels)."""
    from repro_torch.data import SyntheticCorpus, TokenBatcher
    data = TokenBatcher(SyntheticCorpus(vocab), TRAIN_BATCH, TRAIN_SEQ)
    try:
        return next(data)
    finally:
        data.close()


def train_six_steps(torch, model, toks, labels, label, want, rec):
    """``TRAIN_STEPS`` ``Trainer`` steps of ``model`` on one fixed batch
    (microbatch ``TRAIN_MICRO``, remat, AdamW at lr ``TRAIN_LR``), the
    launch counts reset just before and read just after: the loss must
    fall by more than 0.3 and the launches per step equal ``want``. Then
    one more step under ``torch.profiler`` for the device's busy ms and
    the ops' own device ms. Returns (``rec`` with the numbers added, the
    launch counts of the six steps, the ops' device ms)."""
    from repro_torch.kernels import ops
    from repro_torch.training import Trainer
    from repro_torch.training.optimizer import AdamWConfig
    tr = Trainer(model, AdamWConfig(lr=TRAIN_LR), microbatch=TRAIN_MICRO,
                 remat=True)
    opt = tr.init_opt_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.monotonic()
        opt, loss = tr.step(opt, toks, labels)
        losses.append(float(loss))
        walls.append(time.monotonic() - t0)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"training {label}: losses {losses}")
    check(all(map(math.isfinite, losses)), f"{label} losses {losses}")
    check(losses[-1] < losses[0] - 0.3,
          f"{label} loss fell {losses[0] - losses[-1]:.3f} (want > 0.3)")
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items() if n}
    check(per_step == want, f"{label} launches per step {per_step}, want "
          f"{want}")
    with profiled(torch) as prof:
        opt, _ = tr.step(opt, toks, labels)
    busy_ms = sum(us for _, us, _ in device_kernels(prof)) / 1e3
    by_op = ops_device_ms(prof)
    top = dict(list(by_op.items())[:12])
    ms = sum(walls[1:]) / (len(walls) - 1) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec.update({"batch": [TRAIN_BATCH, TRAIN_SEQ], "microbatch": TRAIN_MICRO,
                "remat": True, "lr": TRAIN_LR, "steps": TRAIN_STEPS,
                "losses": losses, "ms_per_step": ms,
                "tokens_per_s": tokens / (ms / 1e3),
                "step_walls_ms": [w * 1e3 for w in walls],
                "max_memory_allocated_gb": peak / 1e9,
                "launches_per_step": per_step,
                "device_busy_ms_per_step": busy_ms,
                "busy_share": busy_ms / ms, "top_ops_device_ms": top})
    print(f"training {label}: {ms:.2f} ms a step, {tokens / (ms / 1e3):.0f} "
          f"tokens/s, busy {busy_ms:.2f} ms, peak {peak / 1e9:.2f} GB; the "
          f"ops' own device ms {top}; card: {card_line()}")
    del tr, opt
    return rec, launches, by_op


def training_phase(torch):
    """The main path of training: qwen3-8b at full width, depth cut to
    ``TRAIN_LAYERS`` (12 of 36; ``train_layers`` checks it fits), bf16
    weights from a seeded generator, the synthetic corpus's batch of 4 x
    2048, six steps (``train_six_steps``). Per microbatch flash runs
    forward twice a layer (remat) and backward once (three launches a
    call); RMSNorm ln1, ln2 and the q/k pair forward twice a layer and the
    final norm once, backward the same once (two launches a call). Returns
    the launch counts of the six steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.kernels import rmsnorm_bwd as RB
    from repro_torch.models import Model
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-8b")
    cfg = replace_layers(cfg, train_layers(torch, cfg, TRAIN_LAYERS))
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.params.parameters())
    L = cfg.num_layers
    want = {"flash_attention": 2 * L * TRAIN_MICRO,
            "flash_attention_bwd": L * TRAIN_MICRO * FAB.LAUNCHES_PER_CALL,
            "rmsnorm": (6 * L + 1) * TRAIN_MICRO,
            "rmsnorm_bwd": (3 * L + 1) * TRAIN_MICRO * RB.LAUNCHES_PER_CALL}
    rec, launches, _ = train_six_steps(
        torch, model, *synthetic_batch(cfg.vocab_size),
        f"qwen3-8b ({L} layers, {n_params / 1e9:.2f}e9 params, bf16)", want,
        {"model": "qwen3-8b", "layers": L, "params": n_params})
    rec["phase_s"] = time.monotonic() - t_phase
    print(json.dumps({"training": rec}))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_probe(torch, model, toks, labels):
    """The aux loss and the capacity drops of ``model``'s current weights
    on the batch: one forward without remat per microbatch, ``no_grad``,
    with ``moe.moe_apply`` and ``moe.route`` wrapped for the call only.
    Returns (the aux loss of each microbatch, the layers' sum; the share of
    routed assignments that capacity drops)."""
    from repro_torch.models import moe as MOE
    apply, route = MOE.moe_apply, MOE.route
    auxes, kept = [], []

    def applied(p, x, train=False):
        out, aux = apply(p, x, train)
        auxes.append(aux)
        return out, aux

    def routed(p, xt):
        out = route(p, xt)
        kept.append(torch.stack([out[5].sum(), torch.tensor(
            out[5].numel(), device=xt.device)]))
        return out
    MOE.moe_apply, MOE.route = applied, routed
    sums = []
    try:
        bs = toks.shape[0] // TRAIN_MICRO
        for i in range(TRAIN_MICRO):
            part = slice(i * bs, (i + 1) * bs)
            auxes.clear()
            with torch.no_grad():
                model.loss_fn(remat=False)(toks[part], labels[part])
            sums.append(float(torch.stack(auxes).sum()))
    finally:
        MOE.moe_apply, MOE.route = apply, route
    k, t = torch.stack(kept).sum(0).tolist()
    return sums, 1 - k / t


def ops_device_ms(prof):
    """The device ms of each CPU op's own kernels in ``prof``'s trace
    (``self_device_time_total``, which splits the busy time among the ops
    without counting a kernel twice; an op's backward calls of itself
    included), most first: {op: ms}."""
    from torch.autograd import DeviceType
    ops = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0
           and not e.key.startswith("ProfilerStep")]
    return dict(sorted(ops, key=lambda kv: -kv[1]))


def moe_training_phase(torch):
    """MoE training on the card: qwen-30b-a3b at full width (d_model 2048,
    32 over 4 heads of 128 with q/k norms, 128 experts of 768, top-8,
    capacity factor 1.25, vocab 151936), depth cut to ``MOE_TRAIN_LAYERS``
    (4 of 48; ``train_layers`` checks it fits), every earlier model freed;
    bf16 weights from a seeded generator, six steps (``train_six_steps``),
    the aux loss in the loss. The aux loss (one forward per microbatch,
    before the steps and after) must be finite and positive. The launches
    per step follow the qwen3-8b phase's formula (q/k norms, remat).
    Prints, besides, the share of the profiled step's busy time in the
    expert ``bmm``s (forward, recompute and backward: the device time of
    ``aten::bmm``'s kernels) and the share of routed assignments that
    capacity drops before the steps and after. Returns the launch counts of
    the six steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.kernels import rmsnorm_bwd as RB
    from repro_torch.models import Model
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen-30b-a3b")
    cfg = replace_layers(cfg, train_layers(torch, cfg, MOE_TRAIN_LAYERS))
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.params.parameters())
    toks, labels = synthetic_batch(cfg.vocab_size)
    auxes0, dropped0 = moe_probe(torch, model, toks, labels)
    mo, L = cfg.moe, cfg.num_layers
    want = {"flash_attention": 2 * L * TRAIN_MICRO,
            "flash_attention_bwd": L * TRAIN_MICRO * FAB.LAUNCHES_PER_CALL,
            "rmsnorm": (6 * L + 1) * TRAIN_MICRO,
            "rmsnorm_bwd": (3 * L + 1) * TRAIN_MICRO * RB.LAUNCHES_PER_CALL}
    rec, launches, by_op = train_six_steps(
        torch, model, toks, labels,
        f"qwen-30b-a3b ({L} layers, {mo.num_experts} experts of "
        f"{mo.d_ff_expert}, top-{mo.top_k}, capacity factor "
        f"{mo.capacity_factor}, {n_params / 1e9:.2f}e9 params, bf16)", want,
        {"model": "qwen-30b-a3b", "layers": L, "params": n_params,
         "experts": mo.num_experts, "top_k": mo.top_k,
         "capacity_factor": mo.capacity_factor})
    auxes, dropped = moe_probe(torch, model, toks, labels)
    check(all(math.isfinite(a) and a > 0 for a in auxes0 + auxes),
          f"MoE aux loss per microbatch {auxes0} before the steps, {auxes} "
          "after: want finite and positive")
    bmm_ms = by_op.get("aten::bmm", 0.0)
    busy_ms = rec["device_busy_ms_per_step"]
    rec.update({"expert_bmm_ms": bmm_ms,
                "expert_bmm_share_of_busy": bmm_ms / busy_ms,
                "aux_loss_per_microbatch": {"before": auxes0,
                                            "after": auxes},
                "dropped_share": {"before": dropped0, "after": dropped},
                "phase_s": time.monotonic() - t_phase})
    print(f"training qwen-30b-a3b: expert bmm {bmm_ms:.2f} ms of the busy "
          f"{busy_ms:.2f}, aux {auxes0} before the steps and {auxes} after, "
          f"routed assignments dropped {dropped0:.4f} before and "
          f"{dropped:.4f} after")
    print(json.dumps({"training_moe": rec}))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mamba2_training_phase(torch):
    """mamba2-1.3b training at full width and full depth (48 SSD layers,
    d_model 2048, 64 heads of 64, d_state 128, chunk 64, the embedding tied
    to the head; ``train_layers`` checks it fits), bf16 weights from a
    seeded generator, every earlier model freed: six steps
    (``train_six_steps``). Per microbatch each layer runs the SSD chunk's
    forward kernel twice (remat) and its backward once (``ssd_chunk_bwd``'s
    LAUNCHES_PER_CALL launches), ln1 and the grouped norm forward twice and
    backward once, and the final norm once each way. Returns the launch
    counts of the six steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm_bwd as RB
    from repro_torch.kernels import ssd_chunk_bwd as SB
    from repro_torch.models import Model
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("mamba2-1.3b")
    L = train_layers(torch, cfg, cfg.num_layers)
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.params.parameters())
    want = {"ssd_chunk": 2 * L * TRAIN_MICRO,
            "ssd_chunk_bwd": L * TRAIN_MICRO * SB.LAUNCHES_PER_CALL,
            "rmsnorm": (4 * L + 1) * TRAIN_MICRO,
            "rmsnorm_bwd": (2 * L + 1) * TRAIN_MICRO * RB.LAUNCHES_PER_CALL}
    rec, launches, _ = train_six_steps(
        torch, model, *synthetic_batch(cfg.vocab_size),
        f"mamba2-1.3b ({L} layers, {n_params / 1e9:.2f}e9 params, bf16)",
        want, {"model": "mamba2-1.3b", "layers": L, "params": n_params})
    rec["phase_s"] = time.monotonic() - t_phase
    print(json.dumps({"training_mamba2": rec}))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def deepseek_train_layers(torch, cfg):
    """The depth of deepseek-v3-671b's training phase: the most of its 3
    dense prefix layers whose training state fits the card beside the MTP
    head (``num_params`` counts it). Reckoned per parameter 14 bytes
    (bf16 weight, fp32 gradient sum, fp32 m and v) and the largest leaf's
    bf16 gradient; the two heads' saved exp of the logits and one head's
    backward (2 + 3 copies of [B/micro x S, V] fp32); MLA's plain attention
    of one layer (remat: one at a time) in its backward: the three tensors
    ``attend`` saves per key chunk (the masked scores, their exp and its
    fp32 copy) over the whole [B/micro, H, S, S] in fp32, and three more of
    one chunk of 1024 keys in flight; and 4 GB of other activations."""
    free, total = torch.cuda.mem_get_info()
    rows = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ
    logits = 5 * 4 * rows * cfg.vocab_size
    scores = 4 * (TRAIN_BATCH // TRAIN_MICRO) * cfg.num_heads * TRAIN_SEQ \
        * (3 * TRAIN_SEQ + 3 * min(TRAIN_SEQ, 1024))
    table = 2 * cfg.vocab_size * cfg.d_model
    fit = 0
    for n in range(1, len(cfg.prefix_layers) + 1):
        need = 14 * deepseek_cut(n, n).num_params() + table + logits \
            + scores + 4e9
        print(f"deepseek training at {n} dense layers and the MTP head: "
              f"{need / 1e9:.1f} GB reckoned against {free / 1e9:.1f} GB free "
              f"of {total / 1e9:.1f} GB")
        if need <= free:
            fit = n
    check(fit >= 1, "deepseek-v3-671b: one dense layer and the MTP head do "
          "not fit this card's training memory")
    return fit


def deepseek_training_phase(torch):
    """deepseek-v3-671b training at full width (d_model 7168, 128 MLA heads,
    q/kv latents 1536/512, vocab 129280) with its MTP head, the depth cut to
    the dense prefix layers that fit (``deepseek_train_layers``; the 256
    experts of 2048 of a MoE layer, ~11.3e9 params, take ~180 GB of training
    state), bf16 weights from a seeded generator, every earlier model freed:
    six steps (``train_six_steps``), both heads' fp32 logits in the loss.
    MLA's attention is plain PyTorch (the reference's is jnp); per
    microbatch each of the layers and the MTP block runs ln1, ln2 and the q
    and kv latent norms forward twice (remat) and backward once, the MTP
    head's norm and the final norm (twice: both heads) once each way.
    Returns the launch counts of the six steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm_bwd as RB
    from repro_torch.models import Model
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    n = deepseek_train_layers(torch, get_config("deepseek-v3-671b"))
    cfg = deepseek_cut(n, n)
    model = Model(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.params.parameters())
    blocks = n + 1                           # the layers and the MTP block
    want = {"rmsnorm": (8 * blocks + 3) * TRAIN_MICRO,
            "rmsnorm_bwd": (4 * blocks + 3) * TRAIN_MICRO
            * RB.LAUNCHES_PER_CALL}
    rec, launches, _ = train_six_steps(
        torch, model, *synthetic_batch(cfg.vocab_size),
        f"deepseek-v3-671b ({n} dense layers of 61 and the MTP head, "
        f"{n_params / 1e9:.2f}e9 params, bf16)", want,
        {"model": "deepseek-v3-671b", "layers": n, "mtp": True,
         "params": n_params})
    rec["phase_s"] = time.monotonic() - t_phase
    print(json.dumps({"training_deepseek": rec}))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


TRAIN_CHECK_ARCHS = ("qwen3-8b", "qwen-30b-a3b")   # reduced, fp32
# the card-against-CPU check's archs: each one's backward kernels, and its
# gradients' tolerance (of each leaf's largest entry). Reduced mamba2-1.3b's
# fp32 gradients lie up to 5.1e-4 of a leaf's largest entry from the fp64
# truth on the CPU itself (``tools/ssd_fp32_drift.py``), so card and CPU
# are held within 2e-3 of each other; the others within 1e-4
TRAIN_CROSS_ARCHS = {"qwen3-8b": (("flash_attention_bwd", "rmsnorm_bwd"),
                                  1e-4),
                     "qwen-30b-a3b": (("flash_attention_bwd", "rmsnorm_bwd"),
                                      1e-4),
                     "deepseek-v3-671b": (("rmsnorm_bwd",), 1e-4),
                     "mamba2-1.3b": (("ssd_chunk_bwd", "rmsnorm_bwd"), 2e-3)}


def train_state(torch, arch, seed=0):
    """``arch``'s reduced trivial-layout state in fp32 from a seeded CPU
    generator, by name."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    m = Model(get_config(arch).reduced(), device="cpu",
              dtype=torch.float32)
    m.init_params(torch.Generator().manual_seed(seed))
    return {k: v.numpy().copy() for k, v in m.params.state_dict().items()}


def train_batch(vocab, B=8, S=16):
    import numpy as np
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:2, -1] = -1
    return toks, labels


def train_run(torch, model, steps=3):
    """The loss and gradients of one ``loss_fn`` call, then ``steps``
    Trainer steps (microbatch 2, remat, lr 1e-3): returns (loss, grads,
    [step losses], params), all on the host (numpy, so that a rank's
    result pickles without shared memory)."""
    from repro_torch.training import Trainer
    from repro_torch.training.optimizer import AdamWConfig
    toks, labels = train_batch(model.cfg.vocab_size)
    with model.trainable() as named:
        loss = model.loss_fn(remat=True)(toks, labels)
        loss.backward()
        grads = {k: p.grad.cpu().numpy() for k, p in named.items()}
    tr = Trainer(model, AdamWConfig(lr=1e-3), microbatch=2, remat=True)
    opt, losses = tr.init_opt_state(), []
    for _ in range(steps):
        opt, lv = tr.step(opt, toks, labels)
        losses.append(float(lv))
    return (float(loss.detach()), grads, losses,
            {k: v.cpu().numpy() for k, v in model.params.state_dict().items()})


def train_close(torch, what, got, want, tol, rel=False, skip=None):
    """Every array of ``got`` within ``tol`` of ``want``'s (times its
    largest entry with ``rel``), outside ``skip``'s entries."""
    import numpy as np
    for name, w in want.items():
        err = np.abs(got[name].astype(np.float64) - w)
        if skip is not None:
            err = err[~skip[name]]
        limit = tol * (np.abs(w).max() if rel else 1.0)
        e = float(err.max()) if err.size else 0.0
        check(e <= limit, f"{what} {name}: max abs err {e} > {limit}")


def train_cross_device(torch):
    """Card against CPU in fp32 (TF32 off) on reduced qwen3-8b, reduced
    qwen-30b-a3b (4 experts, top-2, capacity factor 1.25; the aux loss in
    the loss), reduced deepseek-v3-671b (MLA, a dense and two MoE layers
    with shared experts, the MTP head) and reduced mamba2-1.3b (SSD, the
    tied table): the loss (1e-5) and the gradients (of each leaf's largest
    entry: 1e-4, mamba2-1.3b 2e-3, ``TRAIN_CROSS_ARCHS``) of one
    ``loss_fn`` call, then three Trainer steps with
    microbatch 2 and remat: the losses (1e-4) and the params (5e-4,
    outside the entries whose gradient on the CPU is below 1e-7). The card
    runs each arch's backward kernels, the CPU none."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    for arch, (kernels, grad_tol) in TRAIN_CROSS_ARCHS.items():
        t0 = time.monotonic()
        cfg = get_config(arch).reduced()
        state = train_state(torch, arch)
        runs = {}
        for dev in ("cuda", "cpu"):
            m = Model(cfg, device=dev, dtype=torch.float32)
            m.load_params(state)
            before = ops.launch_counts()
            runs[dev] = train_run(torch, m)
            runs[dev + "_launches"] = delta(ops.launch_counts(), before)
        (lg, gg, sg, pg), (lc, gc_, sc, pc) = runs["cuda"], runs["cpu"]
        what = f"train {arch} card vs CPU"
        check(abs(lg - lc) <= 1e-5, f"{what} loss {lg} vs {lc}")
        train_close(torch, f"{what} grad", gg, gc_, grad_tol, rel=True)
        check(max(abs(a - b) for a, b in zip(sg, sc)) <= 1e-4,
              f"{what} step losses {sg} vs {sc}")
        train_close(torch, f"{what} params", pg, pc, 5e-4,
                    skip={k: abs(g) < 1e-7 for k, g in gc_.items()})
        check(all(runs["cuda_launches"].get(k, 0) > 0 for k in kernels)
              and not any(runs["cpu_launches"].values()),
              f"{what} launches {runs['cuda_launches']}, on the CPU "
              f"{runs['cpu_launches']}")
        print(f"training card vs CPU (reduced {arch}, fp32): loss {lg:.7f} "
              f"vs {lc:.7f}, step losses {sg} vs {sc}; "
              f"{time.monotonic() - t0:.1f} s")


def train_layout_rank(rank, groups, states):
    """One rank of reduced qwen3-8b and of reduced qwen-30b-a3b (its 4
    experts over sp, the a2a path) on (sp, tp) = (2, 2) in fp32:
    ``train_run`` on the card, then on the CPU over the same gloo groups
    (gloo takes either), so one job holds both."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_state
    from repro_torch.models import Model
    from repro_torch.parallel import Layout
    lay = Layout(sp=2, tp=2)
    out = {}
    for arch, state in zip(TRAIN_CHECK_ARCHS, states):
        cfg = get_config(arch).reduced()
        for device in ("cuda", "cpu"):
            m = Model(cfg, device=device, dtype=torch.float32, lay=lay,
                      groups=groups)
            m.load_params(shard_state(state, cfg, lay, rank))
            before = dict(groups.traffic)
            loss, grads, losses, _ = train_run(torch, m)
            out[arch, device] = {"loss": loss, "grads": grads,
                                 "losses": losses,
                                 "traffic": delta(dict(groups.traffic),
                                                  before)}
    return out


def train_layout_phase(torch):
    """Reduced qwen3-8b and reduced qwen-30b-a3b in fp32 on (sp, tp) = (2,
    2) over gloo: four ranks on the one card, each also running the same on
    the CPU. Every rank's loss equals the other ranks' and its CPU run's
    (1e-5), and for qwen3-8b a one-rank run's (and its step losses the
    other ranks'); qwen-30b-a3b's does not
    (printed only): each sp rank routes its own tokens with a capacity
    from its own token count, and the aux loss is the ranks' mean, as in
    the reference. Each rank's card gradients equal its CPU gradients (1e-4
    of each leaf's largest entry: the reference's per-device gradients,
    ROADMAP Queue 3), and so do its three Trainer steps' losses (1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import Model
    t0 = time.monotonic()
    states = [train_state(torch, arch) for arch in TRAIN_CHECK_ARCHS]
    want = {}
    for arch, state in zip(TRAIN_CHECK_ARCHS, states):
        one = Model(get_config(arch).reduced(), device="cuda",
                    dtype=torch.float32)
        one.load_params(state)
        toks, labels = train_batch(one.cfg.vocab_size)
        with torch.no_grad():
            want[arch] = float(one.loss_fn()(toks, labels))
        del one
    res = run_ranks(train_layout_rank, 2, 2, device="cuda", backend="gloo",
                    timeout_s=300, args=(states,))
    for arch in TRAIN_CHECK_ARCHS:
        for r, out in enumerate(res):
            g, c = out[arch, "cuda"], out[arch, "cpu"]
            what = f"train layout {arch} rank {r}"
            check(abs(g["loss"] - c["loss"]) <= 1e-5,
                  f"{what}: loss {g['loss']} vs CPU {c['loss']}")
            check(abs(g["loss"] - res[0][arch, "cuda"]["loss"]) <= 1e-6,
                  f"{what}: losses differ between ranks")
            if arch == "qwen3-8b":
                check(abs(g["loss"] - want[arch]) <= 1e-5,
                      f"{what}: loss {g['loss']} vs one rank {want[arch]}")
                check(g["losses"] == res[0][arch, "cuda"]["losses"],
                      f"{what}: step losses differ between ranks")
            check(max(abs(a - b) for a, b in zip(g["losses"], c["losses"]))
                  <= 1e-4, f"{what}: {g['losses']} vs CPU {c['losses']}")
            train_close(torch, f"{what} grad", g["grads"], c["grads"], 1e-4,
                        rel=True)
        r0 = res[0][arch, "cuda"]
        print(f"training {arch} (sp, tp) = (2, 2) over gloo on the card: "
              f"loss {r0['loss']:.7f} (CPU {res[0][arch, 'cpu']['loss']:.7f},"
              f" one rank {want[arch]:.7f}), step "
              f"losses {r0['losses']} (CPU {res[0][arch, 'cpu']['losses']});"
              f" rank 0 traffic on the card {r0['traffic']}")
    print(f"training layout phase: {time.monotonic() - t0:.1f} s")


def simulator_line():
    """The serving simulator (``repro_torch.sim.simulate``, host code) on
    the paper's bursty trace for llama-70b and qwen-32b under dp, tp, sp
    and shift over 8 chips, priced at the H100 data sheet's constants:
    modeled numbers, not measurements. Prints the TTFT and TPOT p50 and the
    peak tokens/s as one ``{"simulator": ...}`` line."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import H100
    from repro_torch.sim import bursty_trace, simulate
    t0 = time.monotonic()
    out = {}
    for arch in ("llama-70b", "qwen-32b"):
        out[arch] = {}
        for strategy in ("dp", "tp", "sp", "shift"):
            r = simulate(get_config(arch), bursty_trace(), strategy, hw=H100,
                         n_chips=8)
            check(r["n_done"] == len(bursty_trace()),
                  f"simulator {arch} {strategy}: {r['outcomes']}")
            out[arch][strategy] = {k: r[k] for k in (
                "ttft_p50_ms", "tpot_p50_ms", "peak_tput_tok_s")}
            print(f"simulator (modeled, H100 data sheet constants) {arch} "
                  f"{strategy} n 8: TTFT p50 {r['ttft_p50_ms']:.1f} ms, "
                  f"TPOT p50 {r['tpot_p50_ms']:.2f} ms, peak "
                  f"{r['peak_tput_tok_s']:.0f} tokens/s")
    print(json.dumps({"simulator": {
        "label": "modeled, H100 data sheet constants", "trace":
        "bursty_trace()", "n_chips": 8, "results": out,
        "host_s": time.monotonic() - t0}}))


def summary(cases, by_path):
    """One entry per kernel; its top-level numbers are its first case (bf16
    at a serving path's shapes), every case is listed under ``cases``.
    ``launches`` sums the main paths' runs, each counted from 0."""
    out = []
    for name, route, source, replaces in (
            ("paged_ragged_attention", "cuda",
             CSRC + "paged_ragged_attention.cu", ATTN_TPU),
            ("rmsnorm", "cuda", CSRC + "rmsnorm.cu", RMS_TPU),
            ("flash_attention", "cuda", CSRC + "flash_attention.cu",
             FLASH_TPU),
            ("decode_attention", "cuda", CSRC + "decode_attention.cu",
             DECODE_TPU),
            ("paged_decode_attention", "cuda", CSRC + "decode_attention.cu",
             PAGED_DECODE_TPU),
            ("ssd_chunk", "cuda", CSRC + "ssd_chunk.cu", SSD_TPU),
            ("flash_attention_bwd", "cuda", CSRC + "flash_attention_bwd.cu",
             FLASH_TPU),
            ("rmsnorm_bwd", "cuda", CSRC + "rmsnorm_bwd.cu", RMS_TPU),
            ("ssd_chunk_bwd", "cuda", CSRC + "ssd_chunk_bwd.cu", SSD_TPU)):
        top = cases[name][0]
        out.append({"name": name, "route": route, "source": source,
                    "replaces": replaces,
                    "launches": sum(p.get(name, 0)
                                    for p in by_path.values()),
                    "launches_by_path": {k: p.get(name, 0)
                                         for k, p in by_path.items()},
                    "max_abs_err": top["max_abs_err"], "ms": top["ms"],
                    "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
                    "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                    "library_ms": top["library_ms"], "case": top["case"],
                    "dtype": top["dtype"], "shape": top["shape"],
                    "cases": cases[name]})
    return {"kernels": out}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.monotonic()
    logs = build.build_all()
    print(f"built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        ptxas_report(name, log)

    cases = kernel_phase(torch)
    backward_kernel_phase(torch, cases)
    cross_device_phase(torch)
    train_cross_device(torch)
    by_path, turns = serving_phase(torch)
    by_path["mamba2_dense"], turns["mamba2_dense"] = \
        mamba2_serving_phase(torch)
    q32, turns["qwen32b"] = qwen32b_phase(torch)
    by_path["qwen32b_threshold"] = q32["threshold"]
    by_path["qwen32b_adaptive"] = q32["adaptive"]
    by_path["qwen30b_a3b"], turns["qwen30b_a3b"] = qwen30b_phase(torch)
    by_path["deepseek_dense"], turns["deepseek_dense"] = \
        deepseek_phase(torch)
    by_path["recurrentgemma_dense"], turns["recurrentgemma_dense"] = \
        recurrentgemma_phase(torch)
    by_path["whisper_dense"], turns["whisper_dense"] = whisper_phase(torch)
    by_path["internvl2_mixed"], turns["internvl2_mixed"] = \
        internvl2_phase(torch)
    by_path["training"] = training_phase(torch)
    by_path["training_moe"] = moe_training_phase(torch)
    by_path["training_mamba2"] = mamba2_training_phase(torch)
    by_path["training_deepseek"] = deepseek_training_phase(torch)
    simulator_line()
    train_layout_phase(torch)
    by_path["layout_sp2_tp2_rank0"], by_path["layout_prefix_spec_rank0"], \
        by_path["layout_adaptive_rank0"], overhead, serialized = \
        layout_phase(torch)
    by_path.update(serialized)
    by_path["moe_layout_sp2_tp2_rank0"] = moe_layout_phase(torch)
    by_path["dp2_rank0"], by_path["dp2_prefix_spec_rank0"], \
        by_path["dp2_sp2_tp2_rank0"] = dp_phase(torch, overhead)
    by_path["reshard_fp32_rank0"] = reshard_phase(torch)
    for key, launches in deepseek_layout_phase(torch).items():
        by_path[f"deepseek_{key}_rank0"] = launches
    by_path["recurrentgemma_sp2_tp2_rank0"] = \
        recurrentgemma_layout_phase(torch)
    by_path["whisper_sp2_tp2_rank0"] = whisper_layout_phase(torch)
    pod_reduced_phase(torch)
    print(json.dumps({"graph_turns": turns}))
    print(json.dumps(summary(cases, by_path)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
