"""The engine's execution state (counterpart of
``repro.engine.deployment``).

A :class:`Deployment` owns what depends on the parallel layout: the base
(SP×TP) and shift (pure TP) ``Model`` views and the step tables, ``forward``
for the mixed iteration, or ``prefill`` and ``decode`` for the serialized
one, each keyed ``"base"``/``"shift"``. ``ShiftEngine`` holds one and runs
every step through it.

The reference compiles each entry with ``jax.jit`` once per config and
bucketed shape. The port's counterpart is :class:`CapturedStep`: on the
card, each bucket's step is captured once as a CUDA graph and replayed
from then on, so one replay launches the ~2000 kernels of a full-width
step that Python would otherwise launch one by one. On the CPU an entry
runs its step eagerly.

On the trivial layout base and shift are one ``Model`` and one program,
and the two entries of a table are one object that shares its graphs.
Above world size 1 they are two models, the base on the SP×TP layout and
the shift on its ``to_shift()``, over one pool, and each has its entry.
There every entry runs eagerly: its steps call collectives, and a gloo
collective cannot be captured in a CUDA graph (capturing NCCL across cards
is ROADMAP Queue 1 item 2). Asking for graphs there raises. ``reshard``
comes later.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.parallel import Layout


class GraphPool:
    """What the graphs of one deployment share: one device memory pool
    (made at the first capture), and the count and host time of the
    captures."""

    def __init__(self):
        self.handle = None
        self.captures = 0
        self.capture_s = 0.0

    def pool(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


class _Bucket:
    """One bucket of a captured entry: pinned host staging and static int32
    device buffers for each input (None where the step takes None), the
    graph, its static output, and the kernel launches of one replay."""

    def __init__(self, shapes, device):
        self.host = [None if s is None else
                     torch.empty(s, dtype=torch.int32, pin_memory=True)
                     for s in shapes]
        self.inputs = [None if s is None else
                       torch.empty(s, dtype=torch.int32, device=device)
                       for s in shapes]
        self.staged = torch.cuda.Event()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}

    def load(self, arrays):
        """Copy the host arrays into the static buffers through the pinned
        staging, ordered before the work that follows on this stream."""
        # the last call's copies may still read the staging: wait for them
        # (they were queued before that call's step, so this waits for no
        # step)
        self.staged.synchronize()
        for host, dev, a in zip(self.host, self.inputs, arrays):
            if host is not None:
                host.numpy()[...] = a
                dev.copy_(host, non_blocking=True)
        self.staged.record()

    def capture(self, step: Callable, pool):
        """Capture ``step`` over the static buffers. A capture executes
        nothing: the kernel wrappers run and count their launches, which
        become the launches each replay adds, and the counters are set back
        to what they were."""
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            output = step(*self.inputs)
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        ops.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph, self.output = graph, output

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return self.output


class CapturedStep:
    """One entry of a step table: a ``Model``'s device-only step
    (``mixed_step``, ``prefill_step`` or ``decode_step``) behind the host
    conversion of its inputs. A call takes host int arrays, None where the
    step takes None (the block tables of a dense step), and returns the
    step's output on the model's device.

    On the CPU, and on the card when ``graphs`` is None (the eager
    counterpart that tests compare against), it converts the arrays and
    runs the step. Otherwise each bucket (the shapes of the call's inputs)
    is captured once as a CUDA graph: the first call of a bucket copies its
    arrays into the bucket's static buffers and runs the step eagerly over
    them, which is that call's real step and loads every kernel that the
    capture records; then the step is captured, which executes nothing, so
    a step that writes the cache in place still runs exactly once per call.
    Every later call of the bucket copies its arrays into the buffers and
    replays. A replay's output is the graph's static output: it holds until
    the next call of any entry that shares the pool. A failed capture or
    replay raises; nothing falls back to the eager step."""

    def __init__(self, step: Callable, model: Model, paged: bool,
                 graphs: Optional[GraphPool]):
        self.step = step
        self.model = model
        self.paged = paged
        self.graphs = graphs
        self.buckets: Dict[tuple, _Bucket] = {}
        self._cache = None

    def _check_cache(self):
        """The graphs hold the addresses of the cache they step: refuse to
        run them once the model's cache was replaced (``init_cache`` or
        ``init_paged_cache`` after the first capture)."""
        cache = self.model.pool if self.paged else self.model.cache
        if self._cache is None:
            self._cache = weakref.ref(cache)
        elif self._cache() is not cache:
            raise RuntimeError(
                "the model's cache was re-initialised after this entry "
                "captured its steps; build a new Deployment (a new engine)")

    def __call__(self, *arrays) -> torch.Tensor:
        model = self.model
        if self.graphs is None or model.device.type != "cuda":
            return self.step(*map(model._ints, arrays))
        self._check_cache()
        key = tuple(None if a is None else tuple(np.shape(a))
                    for a in arrays)
        bucket = self.buckets.get(key)
        if bucket is not None:
            bucket.load(arrays)
            return bucket.replay()
        bucket = _Bucket(key, model.device)
        bucket.load(arrays)
        out = self.step(*bucket.inputs)
        t0 = time.perf_counter()
        bucket.capture(self.step, self.graphs.pool())
        self.graphs.capture_s += time.perf_counter() - t0
        self.graphs.captures += 1
        self.buckets[key] = bucket
        return out


@dataclass
class Deployment:
    """Layout-dependent execution state, swappable as one value.

    ``forward`` is the mixed-batch table ({config -> entry}) and is ``None``
    when the engine runs the serialized iteration, in which case
    ``prefill``/``decode`` carry the 2×2 table instead. ``graphs`` is what
    the entries' CUDA graphs share; None builds eager tables (those that
    tests compare the graphed ones against, and every table above world
    size 1)."""

    base: Model
    shift: Model
    mixed: bool
    paged: bool
    graphs: Optional[GraphPool] = None
    forward: Optional[dict] = None
    prefill: Optional[dict] = None
    decode: Optional[dict] = None

    # ------------------------------------------------------------ identity
    @property
    def p_base(self):
        return self.base.params

    @property
    def p_shift(self):
        return self.shift.params

    @property
    def layout(self) -> Layout:
        return self.base.lay

    @property
    def dp(self) -> int:
        return max(self.base.lay.dp, 1)

    @property
    def signature(self) -> Tuple[int, int, int, int]:
        return self.base.lay.signature

    @property
    def world(self) -> int:
        """Ranks of the deployment (one process each)."""
        return self.base.lay.world

    @property
    def captures(self) -> int:
        """CUDA graphs captured so far (0 on the CPU and when eager)."""
        return self.graphs.captures if self.graphs else 0

    # ------------------------------------------------------------ factory
    @classmethod
    def build(cls, model_base: Model, model_shift: Model, *, mixed: bool,
              paged: bool, graphed: Optional[bool] = None) -> "Deployment":
        """The step tables of ``model_base`` and ``model_shift`` (one model
        on the trivial layout; above it the base and its ``to_shift()``).
        ``graphed``: None captures CUDA graphs on the card at world size 1
        and runs eagerly above it; True above world size 1 raises."""
        world = model_base.lay.world
        if model_shift is not model_base and (
                model_shift.lay != model_base.lay.to_shift()
                or model_shift.shard.rank != model_base.shard.rank):
            raise ValueError(
                f"shift model on {model_shift.lay.describe()}, want "
                f"{model_base.lay.to_shift().describe()} on the base's rank")
        if graphed and world > 1:
            raise ValueError(
                f"graphed=True at world size {world}: the steps call "
                "collectives, which a CUDA graph cannot capture over gloo "
                "(NCCL capture across cards is ROADMAP Queue 1 item 2)")
        if graphed is None:
            graphed = world == 1
        d = cls(base=model_base, shift=model_shift, mixed=mixed, paged=paged,
                graphs=GraphPool() if graphed else None)
        d._compile()
        return d

    def _compile(self):
        def entry(model, step):
            return CapturedStep(getattr(model, step), model, self.paged,
                                self.graphs)

        def table(step):
            base = entry(self.base, step)
            # one model, one program: base and shift share the entry
            return {"base": base, "shift": base if self.shift is self.base
                    else entry(self.shift, step)}

        if self.mixed:
            # one program per config covers prefill chunks and decode rows
            self.forward = table("mixed_step")
        else:
            self.prefill = table("prefill_step")
            self.decode = table("decode_step")

    # -------------------------------------------------------- spec verify
    def forward_at(self, config: str, n_last: int = 1):
        """The mixed forward entry for ``config`` ("base" | "shift")."""
        if self.forward is None:
            raise ValueError("forward_at requires the mixed step table")
        if n_last > 1:
            raise NotImplementedError(
                f"n_last={n_last}: the speculative verify forward is not "
                "ported yet (ROADMAP Queue 1 item 3)")
        return self.forward[config]
