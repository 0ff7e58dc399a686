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
same host inputs on every rank and run the layout's collectives over the
process groups it was given. With dp rows a step takes the whole batch,
steps its dp rank's contiguous segment of rows through its row's own
paged pool, and all-gathers the sampled tokens over the DP group, so that
every rank returns the whole batch's tokens. The mixed paged step runs on
every layout; the serialized steps on the paged pool run while the model
group is one rank (dp rows alone); the dense cache and SSD layers run only
the trivial layout (ROADMAP Queue 1 item 2). A MoE layer's experts are
sharded over its EP group (``models.moe.ep_group``) within a dp row; a
pod-scale config whose EP group would span dp rows raises."""
from __future__ import annotations

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
    """A decoder (dense GQA, GQA with MoE FFNs, or mamba2's SSD layers) on
    one device.
    ``device`` defaults to ``"cuda"`` and raises without a card; the CPU
    runs only when asked for. ``lay`` is the layout (the trivial one by
    default); above world size 1, ``groups`` are the grid's process groups
    (``launch.mesh.run_ranks`` builds them) and the model holds the calling
    rank's shard. The parameters are allocated, not initialised: call
    ``init_params`` with a ``torch.Generator`` or ``load_params`` with a
    converted state (``convert.shard_state`` above world size 1)."""

    def __init__(self, cfg, device="cuda", dtype=torch.bfloat16,
                 lay: Layout = Layout(), groups: Optional[Groups] = None):
        if lay.world > 1 and any(k not in ("attn", "moe")
                                 for k in cfg.layer_kinds):
            raise NotImplementedError(
                f"{cfg.name} on {lay.describe()}: SSD layers run only the "
                "trivial layout (their Ulysses exchange is ROADMAP Queue 1 "
                "item 2)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lay = lay
        self.shard = Shard.of(lay, groups)
        self.plan = get_plan(cfg, lay)
        self.dtype = dtype
        self.params = T.Transformer(cfg, lay, dtype, self.device, self.shard)
        self.pool: Optional[T.PagedPool] = None
        self.cache: Optional[T.DenseCache] = None

    @property
    def pod_scale(self) -> bool:
        """The reference's ``POD_SCALE_ARCHS``: the EP group of such a
        config may take the dp axes (above one dp row the port raises)."""
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

    def _trivial_only(self, what: str, paged: bool = False):
        """Raise for a serialized step or the dense cache on a layout they
        do not run: the dense cache needs world size 1, a serialized step
        on the paged pool a model group of one."""
        if (self.lay.G if paged else self.lay.world) > 1:
            raise NotImplementedError(
                f"{what} on {self.lay.describe()}: the serialized steps run "
                "on the paged pool with a model group of one, the dense "
                "cache only on the trivial layout (ROADMAP Queue 1 item 2); "
                "the mixed paged step runs every layout")

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

    # -------------------------------------------------------- paged cache
    @property
    def supports_paged(self) -> bool:
        """True when every cached layer is GQA attention (``attn`` or
        ``moe``), whose [block_size, kv_slots, Dh] block layout pages. SSD
        layers keep recurrent state per sequence, so their configs keep the
        contiguous cache."""
        return all(k in ("attn", "moe") for k in self.cfg.layer_kinds)

    def _require_paged(self):
        if not self.supports_paged:
            raise ValueError(
                f"{self.cfg.name} has layer kinds {set(self.cfg.layer_kinds)}"
                ": only attention layers page; use the dense cache")

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
        if (other.cfg != self.cfg or other.lay.grid != self.lay.grid
                or other.shard.rank != self.shard.rank
                or other.plan.kv_per_rank != self.plan.kv_per_rank
                or other.dtype != self.dtype or other.device != self.device):
            raise ValueError("adopt_paged_cache: the models differ in config, "
                             "grid, rank, kv slots, type or device")
        self.pool = other.pool
        return self.pool

    # -------------------------------------------------------- dense cache
    def init_cache(self, batch: int, s_max: int) -> T.DenseCache:
        """Zeroed dense caches: K and V ``[n_attn, batch, s_max, kv_slots,
        Dh]`` for attention layers, recurrent state for SSD layers. The
        trivial layout only."""
        self._trivial_only("the dense cache")
        self.cache = T.init_cache(self.cfg, self.lay, batch, s_max,
                                  self.dtype, self.device)
        return self.cache

    def _ints(self, a):
        """Host conversion: an array (or tensor) -> int32 on the model's
        device; None stays None."""
        return None if a is None else torch.as_tensor(
            a, dtype=torch.int32, device=self.device)

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
    def prefill_step(self, tokens, offsets, block_tables=None):
        """``prefill`` on device tensors; returns the last column's fp32
        logits [B, V] (under dp this rank's rows' only). The paged pool
        with a model group of one, or the dense cache on the trivial
        layout."""
        paged = block_tables is not None
        self._trivial_only("prefill_step", paged)
        if paged:
            rows = self._dp_rows(tokens.shape[0])
            tokens, offsets = tokens[rows], offsets[rows]
            block_tables = block_tables[rows]
        return T.prefill_body(self.params, self._step_cache(block_tables),
                              tokens, offsets, self.cfg,
                              block_tables=block_tables)

    def decode_step(self, tokens, lens, block_tables=None, sample=True):
        """``decode`` on device tensors; returns the next tokens [B] (under
        dp gathered from every row), or the fp32 logits with
        ``sample=False`` ([B, V]; under dp this rank's rows' only). Where
        ``prefill_step`` runs."""
        paged = block_tables is not None
        self._trivial_only("decode_step", paged)
        if paged:
            rows = self._dp_rows(tokens.shape[0])
            tokens, lens = tokens[rows], lens[rows]
            block_tables = block_tables[rows]
        logits = T.decode_body(self.params, self._step_cache(block_tables),
                               tokens, lens, self.cfg,
                               block_tables=block_tables)
        return self._dp_gather(T.greedy_body(logits)) if sample else logits

    def mixed_step(self, tokens, q_lens, offsets, block_tables, sample=True,
                   n_last: int = 1):
        """``forward_mixed`` on device tensors; returns the next tokens [B],
        or the newest token's fp32 logits (this tp rank's vocabulary
        columns, [B, v_blk]) with ``sample=False``; with ``n_last`` > 1
        each row's last ``n_last`` columns' ([B, n_last], [B, n_last,
        v_blk]). ``tokens`` [B, C] is the whole batch, the same on every
        rank; a dp rank steps its contiguous B/dp rows and an sp rank its
        contiguous C/sp columns, as the reference's ``shard_map`` hands
        them over. The tokens are gathered over DP, so every rank returns
        all B rows'; the logits are this rank's B/dp rows' only."""
        self._require_paged()
        if self.pool is None:
            raise RuntimeError("init_paged_cache() before forward_mixed()")
        sp = self.lay.sp
        if tokens.shape[1] % sp:
            raise ValueError(f"chunk of {tokens.shape[1]} columns does not "
                             f"split over sp={sp}")
        rows = self._dp_rows(tokens.shape[0])
        tokens, q_lens = tokens[rows], q_lens[rows]
        offsets, block_tables = offsets[rows], block_tables[rows]
        if sp > 1:
            c = tokens.shape[1] // sp
            tokens = tokens[:, self.shard.sp_rank * c:][:, :c]
        out = T.mixed_body(self.params, self.pool, tokens, q_lens, offsets,
                           block_tables, self.cfg, sample=sample,
                           n_last=n_last)
        return self._dp_gather(out) if sample else out

    # ------------------------------------------------------------- step
    def prefill(self, tokens, offsets, block_tables=None):
        """One chunked-prefill step (counterpart of ``prefill_fn``):
        ``tokens`` [B, S] written at positions ``offsets`` [B] .., into the
        dense cache, or with ``block_tables`` [B, nmax] through the paged
        pool. Returns ``(last-column logits [B, V] fp32, cache)``; the
        cache is updated in place."""
        logits = self.prefill_step(self._ints(tokens), self._ints(offsets),
                                   self._ints(block_tables))
        return logits, self._step_cache(block_tables)

    def decode(self, tokens, lens, block_tables=None, sample: bool = True):
        """One decode step (counterpart of ``decode_fn``): ``tokens`` [B]
        written at positions ``lens`` [B], into the dense cache or through
        the paged pool with ``block_tables``. Returns ``(next_tokens [B],
        cache)``, or the fp32 logits [B, V] in place of the tokens with
        ``sample=False``."""
        out = self.decode_step(self._ints(tokens), self._ints(lens),
                               self._ints(block_tables), sample=sample)
        return out, self._step_cache(block_tables)

    def forward_mixed(self, tokens, q_lens, offsets, block_tables,
                      sample: bool = True, n_last: int = 1):
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
        n_last, V]). Raises for a config that does not page."""
        out = self.mixed_step(self._ints(tokens), self._ints(q_lens),
                              self._ints(offsets), self._ints(block_tables),
                              sample=sample, n_last=n_last)
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
