"""Public model API (counterpart of ``repro.models.model``): a ``Model``
bundles the config, the layout, this process's shard of the parameters on
one device and its caches (the paged KV pool, for configs whose layers all
page: attention and MoE layers; and the dense contiguous cache with KV and
SSD state), and exposes
the mixed paged step and the serialized prefill and decode steps.
``view()`` gives a ``Model`` over the same parameters with caches of its
own: each engine steps its own view, so engines built on one model share
its weights and nothing else.

Above world size 1 a ``Model`` is one rank of an SPMD program, one process
per rank as ``shard_map`` runs one program per device: its steps take the
same host inputs on every rank (the whole batch) and cut them as the
reference's ``in_specs`` do. A dp rank steps its contiguous segment of
rows through its row's own cache; an sp rank its contiguous columns of a
prefill chunk (``P(dp, sp)``), or its contiguous segment of its row's
decode rows (``P((dp, sp))``, the batch sharded over dp×sp). Every step
runs on every layout, over the paged pool or the dense cache, and an SSD
layer's mixer runs the Ulysses exchange as an attention layer does. The
sampled tokens are gathered over SP and DP, so that every rank returns
the whole batch's tokens. A MoE layer's experts are sharded over its EP
group (``models.moe.ep_group``), which for a pod-scale config spans the dp
rows: its all-to-all then runs across rows, which every rank enters on
every step. An MLA config's latent cache is sharded over the grid's sp
(``models.mla``), the same chunk in the base and the shift config."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel import Groups, Layout, Shard
from repro_torch.parallel.collectives import all_gather_if
from .attention import get_plan
from .moe import POD_SCALE_ARCHS
from . import transformer as T


class Model:
    """A decoder (dense GQA or MLA attention, with gated MLPs or MoE FFNs,
    mamba2's SSD layers, recurrentgemma's RG-LRU and local attention
    layers, internvl2's vision stub ahead of GQA layers, or whisper's
    encoder-decoder stack) on one device.
    ``device`` defaults to ``"cuda"`` and raises without a card; the CPU
    runs only when asked for. ``lay`` is the layout (the trivial one by
    default); above world size 1, ``groups`` are the grid's process groups
    (``launch.mesh.run_ranks`` builds them) and the model holds the calling
    rank's shard. The parameters are allocated, not initialised: call
    ``init_params`` with a ``torch.Generator`` or ``load_params`` with a
    converted state (``convert.shard_state`` above world size 1)."""

    def __init__(self, cfg, device="cuda", dtype=torch.bfloat16,
                 lay: Layout = Layout(), groups: Optional[Groups] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lay = lay
        self.shard = Shard.of(lay, groups)
        self.plan = get_plan(cfg, lay)
        self.dtype = dtype
        if self.device.type == "cuda":
            self._check_fits(cfg, lay, dtype)
        self.params = T.Transformer(cfg, lay, dtype, self.device, self.shard)
        self.pool: Optional[T.PagedPool] = None
        self.cache: Optional[T.DenseCache] = None

    def _check_fits(self, cfg, lay, dtype):
        """Raise, naming the size, when this rank's parameters (counted on
        the meta device) exceed the card's free memory: deepseek-v3-671b
        and llama4-maverick-400b-a17b at full depth, llama-70b, and
        llama4-17b-16e hold more than one card."""
        meta = T.Transformer(cfg, lay, dtype, "meta", self.shard)
        need = sum(p.numel() * p.element_size() for p in meta.parameters())
        free, total = torch.cuda.mem_get_info(self.device)
        if need > free:
            raise ValueError(
                f"{cfg.name} ({cfg.num_layers} layers, d_model "
                f"{cfg.d_model}) holds {need / 1e9:.2f} GB of {dtype} "
                f"weights on this rank; the card has {free / 1e9:.2f} GB "
                f"free of {total / 1e9:.2f} GB: serve it reduced, with its "
                "depth cut, or over more ranks")

    @property
    def pod_scale(self) -> bool:
        """The reference's ``POD_SCALE_ARCHS``: the EP group of such a
        config may take the dp axes."""
        return self.cfg.name in POD_SCALE_ARCHS

    def view(self) -> "Model":
        """A ``Model`` over the same parameters, layout, shard, head plan,
        type and device, with no cache of its own yet: each engine steps a
        view whose pool it initialised, so that engines built on one model
        share its weights and nothing else."""
        v = Model.__new__(Model)
        v.__dict__.update(self.__dict__)
        v.pool = v.cache = None
        return v

    def _dp_rows(self, n: int) -> slice:
        """This rank's contiguous segment of an ``n``-row batch: dp row d
        steps rows ``[d*n/dp, (d+1)*n/dp)``."""
        dp = self.lay.dp
        if n % dp:
            raise ValueError(f"batch of {n} rows does not split over "
                             f"dp={dp}")
        seg = n // dp
        d = self.shard.dp_rank
        return slice(d * seg, (d + 1) * seg)

    def _sp_part(self, n: int, what: str) -> slice:
        """This sp rank's contiguous part of ``n`` (a prefill chunk's
        columns, or a decode step's rows of its dp row); raises where the
        reference's ``shard_map`` refuses an axis that does not split."""
        sp = self.lay.sp
        if n % sp:
            raise ValueError(f"{what} of {n} does not split over sp={sp}")
        part = n // sp
        i = self.shard.sp_rank
        return slice(i * part, (i + 1) * part)

    def _dp_gather(self, tokens):
        """The rows' sampled tokens of every dp rank, in row order (the
        tokens themselves for one row)."""
        return all_gather_if(tokens, self.shard.dp_group, "dp_all_gather")

    # ------------------------------------------------------------ params
    def init_params(self, generator: torch.Generator):
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        T.init_params(self.params, generator)

    @torch.no_grad()
    def load_params(self, state: dict):
        """Copy a state (name -> array, e.g. from ``convert.from_jax_params``)
        into the parameters, casting to the model's type; every parameter
        must be present."""
        self.params.load_state_dict(
            {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v)) for k, v in state.items()}, strict=True)

    # ------------------------------------------------------------ training
    @contextmanager
    def trainable(self):
        """Turn gradients on for every parameter for the block's length
        (serving keeps them off: ``requires_grad=False``), and off again
        after it, the parameters' ``.grad`` cleared. Yields the parameters
        by name."""
        named = dict(self.params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        try:
            yield named
        finally:
            for p in named.values():
                p.requires_grad_(False)
                p.grad = None

    def local_batch(self, a):
        """This rank's part of a global [B, S] training batch (tokens or
        labels, an array or a tensor), as the reference's ``P(dp, sp)``
        cuts it: its dp row's B/dp rows and its sp rank's S/sp columns, as
        int32 on the model's device."""
        a = self._ints(a)
        rows = self._dp_rows(a.shape[0])
        return a[rows, self._sp_part(a.shape[1], "a sequence")]

    def loss_fn(self, remat: bool = True):
        """The training loss (counterpart of ``loss_fn``): a function of
        the global batch ``(tokens, labels)`` [B, S] (the same on every
        rank) that returns the mean nll, a 0-d fp32 tensor equal on every
        rank, with the MoE layers' aux loss and DeepSeek-V3's MTP term
        added as the reference adds them. Differentiable in the parameters
        inside ``trainable()``; its gradients are this rank's, the
        reference's per-device ones. GQA and MLA stacks with dense or MoE
        FFNs (and the MTP head) and SSD stacks train
        (``transformer.check_trainable`` raises for the rest)."""
        T.check_trainable(self.cfg)

        def loss(tokens, labels):
            return T.loss_body(self.params, self.local_batch(tokens),
                               self.local_batch(labels), self.cfg,
                               remat=remat)
        return loss

    # -------------------------------------------------------- paged cache
    @property
    def supports_paged(self) -> bool:
        """True when every cached layer is GQA attention (``attn`` or
        ``moe``), whose [block_size, kv_slots, Dh] block layout pages. MLA
        layers keep a latent sharded over the sequence, local layers a
        ring, SSD and RG-LRU layers recurrent state per sequence, and an
        encoder-decoder stack its cross cache, so their configs keep the
        contiguous cache (the reference's reason)."""
        return (self.cfg.mla is None and not self.cfg.encoder_layers
                and all(k in ("attn", "moe") for k in self.cfg.layer_kinds))

    def _require_paged(self):
        if not self.supports_paged:
            raise ValueError(
                f"{self.cfg.name} has layer kinds {set(self.cfg.layer_kinds)}"
                f"{' with MLA' if self.cfg.mla is not None else ''}: only "
                "GQA attention layers page; use the dense cache")

    def init_paged_cache(self, num_blocks: int, block_size: int) -> T.PagedPool:
        """Zeroed block pools of every layer (block 0 is the null block):
        this rank's own dp row's pool of ``num_blocks`` blocks. Raises for
        a config that does not page."""
        self._require_paged()
        self.pool = T.init_paged_cache(self.cfg, self.lay, num_blocks,
                                       block_size, self.dtype, self.device)
        return self.pool

    def adopt_paged_cache(self, other: "Model") -> T.PagedPool:
        """Step ``other``'s pool tensors themselves, not a copy: the shift
        model adopts the base model's pool, so that the two configs hold
        identical bytes and a switch moves none (paper §3.3.1). Both must be
        the same rank of the same grid, with the same head plan (an
        engine's base and shift views)."""
        self._require_paged()
        if other.pool is None:
            raise RuntimeError("the other model has no paged pool yet")
        self._check_peer(other, "adopt_paged_cache")
        self.pool = other.pool
        return self.pool

    # -------------------------------------------------------- dense cache
    def init_cache(self, batch: int, s_max: int) -> T.DenseCache:
        """Zeroed dense caches of a ``batch``-row batch, this rank's shard:
        its dp row's ``batch/dp`` rows at its heads, K and V ``[n_attn,
        batch/dp, s_max, kv_per_rank, Dh]`` for attention layers, a ring
        of ``min(s_max, local_window)`` rows for local layers and
        recurrent state for SSD and RG-LRU layers. A batch that does not split over
        dp gets ``batch // dp`` rows, and every step raises, as the
        reference's ``shard_map`` refuses it."""
        self.cache = T.init_cache(self.cfg, self.lay, batch // self.lay.dp,
                                  s_max, self.dtype, self.device)
        return self.cache

    def adopt_cache(self, other: "Model") -> T.DenseCache:
        """Step ``other``'s dense cache tensors themselves, as
        ``adopt_paged_cache`` does the pool: the shift model adopts the
        base model's, so that a switch moves no byte of KV or recurrent
        state.
        Both must be the same rank of the same grid (an engine's base and
        shift views)."""
        if other.cache is None:
            raise RuntimeError("the other model has no dense cache yet")
        self._check_peer(other, "adopt_cache")
        self.cache = other.cache
        return self.cache

    def _check_peer(self, other: "Model", what: str):
        if (other.cfg != self.cfg or other.lay.grid != self.lay.grid
                or other.lay.dp != self.lay.dp
                or other.shard.rank != self.shard.rank
                or other.plan.kv_per_rank != self.plan.kv_per_rank
                or other.dtype != self.dtype or other.device != self.device):
            raise ValueError(f"{what}: the models differ in config, grid, "
                             "rank, kv slots, type or device")

    def _ints(self, a):
        """Host conversion: an array (or tensor) -> int32 on the model's
        device; None stays None."""
        return None if a is None else torch.as_tensor(
            a, dtype=torch.int32, device=self.device)

    def _floats(self, a):
        """Host conversion of the frontend inputs: an array (or tensor) ->
        the model's type on its device; None stays None."""
        return None if a is None else torch.as_tensor(
            a, dtype=self.dtype, device=self.device)

    def _frontend(self, rows, frontend_embeds, enc_frames):
        """This rank's part of the frontend inputs, as the reference's
        ``in_specs`` cut them: its dp rows of the image embeddings
        (``P(dp, None, None)``), and its dp rows and contiguous sp part of
        the encoder's frames (``P(dp, seq, None)``)."""
        if frontend_embeds is not None:
            frontend_embeds = frontend_embeds[rows]
        if enc_frames is not None:
            enc_frames = enc_frames[rows]
            enc_frames = enc_frames[:, self._sp_part(enc_frames.shape[1],
                                                     "the encoder frames")]
        return frontend_embeds, enc_frames

    def _step_cache(self, block_tables):
        """The paged pool when a step carries block tables, else the dense
        cache; raises if that cache was not initialised."""
        cache = self.pool if block_tables is not None else self.cache
        if cache is None:
            raise RuntimeError(
                "init_paged_cache() before a step with block tables"
                if block_tables is not None
                else "init_cache() before a dense prefill or decode")
        return cache

    # ------------------------------------------------- device-only steps
    # The steps below take int32 tensors already on the model's device,
    # make no host sync and branch only on shapes and the config, so that
    # a step can be captured as a CUDA graph (``engine.deployment``); the
    # cache they step is updated in place.
    def prefill_step(self, tokens, offsets, block_tables=None,
                     frontend_embeds=None, enc_frames=None):
        """``prefill`` on device tensors, over the paged pool with block
        tables, else the dense cache. ``tokens`` [B, C] is the whole batch,
        the same on every rank: a dp rank steps its B/dp rows and an sp
        rank its contiguous C/sp columns (the reference's ``P(dp, sp)``).
        ``frontend_embeds`` [B, frontend_seq, d] (the vision stub's) and
        ``enc_frames`` [B, S_enc, d] (the encoder's) are the whole batch's
        too, cut by ``_frontend``. Returns the chunk's last column's fp32
        logits, this rank's rows' and this tp rank's vocabulary columns
        ([B/dp, v_blk]; [B, V] on the trivial layout)."""
        rows = self._dp_rows(tokens.shape[0])
        tokens, offsets = tokens[rows], offsets[rows]
        if block_tables is not None:
            block_tables = block_tables[rows]
        tokens = tokens[:, self._sp_part(tokens.shape[1], "a chunk")]
        frontend_embeds, enc_frames = self._frontend(rows, frontend_embeds,
                                                     enc_frames)
        return T.prefill_body(self.params, self._step_cache(block_tables),
                              tokens, offsets, self.cfg,
                              block_tables=block_tables,
                              frontend_embeds=frontend_embeds,
                              enc_frames=enc_frames)

    def decode_step(self, tokens, lens, block_tables=None, sample=True):
        """``decode`` on device tensors, where ``prefill_step`` runs.
        ``tokens`` and ``lens`` [B] are the whole batch: a dp rank keeps
        its row's B/dp rows (their ``lens`` and tables), and an sp rank
        steps its contiguous segment of them (the reference's batch
        sharded over dp×sp). Returns the next tokens [B], gathered over SP
        and DP, or with ``sample=False`` the segment's fp32 logits
        ([B/(dp·sp), v_blk], this tp rank's vocabulary columns; [B, V] on
        the trivial layout)."""
        rows = self._dp_rows(tokens.shape[0])
        tokens, lens = tokens[rows], lens[rows]
        if block_tables is not None:
            block_tables = block_tables[rows]
        tokens = tokens[self._sp_part(tokens.shape[0], "a dp row's batch")]
        logits = T.decode_body(self.params, self._step_cache(block_tables),
                               tokens, lens, self.cfg,
                               block_tables=block_tables)
        if not sample:
            return logits
        return self._dp_gather(T.greedy_body(logits, self.shard))

    def mixed_step(self, tokens, q_lens, offsets, block_tables,
                   frontend_embeds=None, sample=True, n_last: int = 1):
        """``forward_mixed`` on device tensors; returns the next tokens [B],
        or the newest token's fp32 logits (this tp rank's vocabulary
        columns, [B, v_blk]) with ``sample=False``; with ``n_last`` > 1
        each row's last ``n_last`` columns' ([B, n_last], [B, n_last,
        v_blk]). ``tokens`` [B, C] is the whole batch, the same on every
        rank; a dp rank steps its contiguous B/dp rows and an sp rank its
        contiguous C/sp columns, as the reference's ``shard_map`` hands
        them over, and its B/dp rows of ``frontend_embeds`` [B,
        frontend_seq, d]. The tokens are gathered over DP, so every rank
        returns all B rows'; the logits are this rank's B/dp rows' only."""
        self._require_paged()
        if self.pool is None:
            raise RuntimeError("init_paged_cache() before forward_mixed()")
        cols = self._sp_part(tokens.shape[1], "a chunk")
        rows = self._dp_rows(tokens.shape[0])
        tokens, q_lens = tokens[rows, cols], q_lens[rows]
        offsets, block_tables = offsets[rows], block_tables[rows]
        frontend_embeds, _ = self._frontend(rows, frontend_embeds, None)
        out = T.mixed_body(self.params, self.pool, tokens, q_lens, offsets,
                           block_tables, self.cfg, sample=sample,
                           n_last=n_last, frontend_embeds=frontend_embeds)
        return self._dp_gather(out) if sample else out

    # ------------------------------------------------------------- step
    def prefill(self, tokens, offsets, block_tables=None,
                frontend_embeds=None, enc_frames=None):
        """One chunked-prefill step (counterpart of ``prefill_fn``):
        ``tokens`` [B, S] written at positions ``offsets`` [B] .., into the
        dense cache, or with ``block_tables`` [B, nmax] through the paged
        pool; the vision stub's ``frontend_embeds`` [B, frontend_seq, d]
        and the encoder's ``enc_frames`` [B, S_enc, d] move to the model's
        device and type. Returns ``(last-column logits [B, V] fp32,
        cache)`` (above world size 1 this rank's part of the logits, as
        ``prefill_step``); the cache is updated in place."""
        logits = self.prefill_step(self._ints(tokens), self._ints(offsets),
                                   self._ints(block_tables),
                                   self._floats(frontend_embeds),
                                   self._floats(enc_frames))
        return logits, self._step_cache(block_tables)

    def decode(self, tokens, lens, block_tables=None, sample: bool = True):
        """One decode step (counterpart of ``decode_fn``): ``tokens`` [B]
        written at positions ``lens`` [B], into the dense cache or through
        the paged pool with ``block_tables``. Returns ``(next_tokens [B],
        cache)``, or the fp32 logits in place of the tokens with
        ``sample=False`` ([B, V]; above world size 1 this rank's part, as
        ``decode_step``)."""
        out = self.decode_step(self._ints(tokens), self._ints(lens),
                               self._ints(block_tables), sample=sample)
        return out, self._step_cache(block_tables)

    def forward_mixed(self, tokens, q_lens, offsets, block_tables,
                      frontend_embeds=None, sample: bool = True,
                      n_last: int = 1):
        """Unified mixed-batch step over the paged pool: chunked-prefill rows
        (q_len up to the chunk width) and decode rows (q_len == 1) in one
        pass (under dp each rank steps its segment of rows, as
        ``mixed_step``). ``tokens`` [B, C], ``q_lens``/``offsets`` [B] and
        ``block_tables`` [B, nmax] (arrays or tensors) move to the model's
        device as int32. Returns ``(next_tokens [B], pool)``, or the newest
        token's fp32 logits [B, V] (this tp rank's columns [B, v_blk] above
        world size 1) in place of the tokens with ``sample=False``; the pool
        is updated in place. ``n_last`` > 1 is the speculative verify width:
        each row's last ``n_last`` columns' tokens [B, n_last] (logits [B,
        n_last, V]). ``frontend_embeds`` [B, frontend_seq, d] are the
        vision stub's. Raises for a config that does not page."""
        out = self.mixed_step(self._ints(tokens), self._ints(q_lens),
                              self._ints(offsets), self._ints(block_tables),
                              self._floats(frontend_embeds), sample=sample,
                              n_last=n_last)
        return out, self.pool

    @torch.no_grad()
    def copy_blocks(self, src, dst):
        """The copy-on-write data plane: ``pool[dst[i]] = pool[src[i]]`` for
        K and V of every layer, in row-local ids of this rank's pool, in
        place (a CUDA graph that steps the pool
        keeps its addresses). One gather of every source, then one scatter,
        so a block that is one pair's destination and another's source
        gives the latter its bytes from before the copy."""
        if self.pool is None:
            raise RuntimeError("init_paged_cache() before copy_blocks()")
        src, dst = self._ints(src).long(), self._ints(dst).long()
        for pool in (self.pool.k, self.pool.v):
            pool.index_copy_(1, dst, pool.index_select(1, src))
