"""The port's RMSNorm beyond its plain version (``test_torch_kernels.py``
holds that against the reference):

* the kernel's launch plan covers every (row, column) exactly once, for
  every row width and head count the port's configs reach, full and
  reduced, plus D 100 as the odd case, and N from 1 to 16384, alone and as
  the q/k pair's two segments; its lanes and chunks per row do not depend
  on N;
* the q/k pair (``ops.rmsnorm_pair``) on the CPU is two ``ops.rmsnorm``
  calls, bitwise, and matches the reference's ``layers.rmsnorm`` on q and on
  k within ``test_torch_kernels.py``'s tolerances;
* the model's attention layers take their q and k norms through the pair,
  one call per layer;
* the wrappers refuse what the kernel does not take before any launch.

The kernel itself is held to its plain version on the card in
``test_torch_cuda.py``. Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as RMS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from test_torch_kernels import _bf16_ulps  # noqa: E402


def _widths():
    """(D, H) of every norm the port's configs run, full and reduced: the
    hidden norms (d_model, H 1), the q/k norms (head_dim, H 1) and the SSD
    mixer's grouped norm (its head_dim over its heads)."""
    out = set()
    for cfg in ARCHS:
        for c in (cfg, cfg.reduced()):
            out.add((c.d_model, 1))
            if c.ssm is None:
                out.add((c.head_dim, 1))
            else:
                out.add((c.ssm.head_dim, c.ssm.n_heads(c.d_model)))
    return sorted(out)


WIDTHS = _widths() + [(100, 1)]
ROWS = [1, 2, 3, 5, 7, 8, 31, 64, 100, 255, 256, 511, 512, 1000, 4097, 16384]


def test_widths_span_the_configs_and_the_odd_case():
    """The configs reach the widths the plan is written for."""
    ds = {d for d, _ in WIDTHS}
    assert {8192, 5120, 4096, 3584, 2048, 1536, 128, 64, 16, 100} <= ds
    assert (64, 64) in WIDTHS and (16, 8) in WIDTHS


def _cover(plan, N, D):
    """How often the plan's launch takes each (row, lane) of [N, D] and each
    column, by the kernel's own indexing (csrc/rmsnorm.cu): thread t of CTA
    blk takes row blk * (threads // lanes) + t // lanes as lane t % lanes,
    and lane l takes chunks l + k * lanes (k < cpl) below D // vec, each of
    vec columns, in every row. Every (row, column) is taken once if every
    (row, lane) is and every column is."""
    rows_per_cta = plan.threads // plan.lanes
    t = np.arange(plan.threads)
    row = np.arange(plan.grid)[:, None] * rows_per_cta + t // plan.lanes
    lane = np.broadcast_to(t % plan.lanes, row.shape)
    live = row < N
    # every row is taken by one group, and each group holds every lane once
    pairs = np.bincount((row[live] * plan.lanes + lane[live]).ravel(),
                        minlength=N * plan.lanes).reshape(N, plan.lanes)
    nchunks = D // plan.vec
    c = np.arange(plan.lanes)[:, None] + np.arange(plan.cpl)[None] * plan.lanes
    chunks = c[c < nchunks]
    hits = np.bincount((chunks[:, None] * plan.vec
                        + np.arange(plan.vec)[None]).ravel(), minlength=D)
    return pairs, hits


@pytest.mark.parametrize("D,H", WIDTHS)
def test_launch_plan_covers_every_cell_once(D, H):
    """For fp32 and bf16, 16-byte chunks and single elements, and N rows
    (rounded up to a multiple of H for a grouped norm): each column belongs
    to exactly one lane, each (row, lane) to exactly one thread, and the
    plan keeps the kernel's limits (its C entry refuses any other)."""
    for elt in (4, 2):
        for vec in (True, False):
            if vec and (D * elt) % 16:
                continue
            for n in ROWS:
                N = -(-n // H) * H
                p = RMS.launch_plan(N, D, elt, vec)
                assert p.vec == (16 // elt if vec else 1)
                assert p.lanes & (p.lanes - 1) == 0
                assert p.cpl in ((1, 2, 4, 8) if vec
                                 else (1, 2, 4, 8, 16, 32))
                # the (lanes, chunks) pairs the kernel is built for: one
                # chunk on fewer than 32 lanes, the most on more than 32,
                # and twice that on 256 lanes for the longest rows
                most = 4 if vec else 16
                if p.lanes == RMS.MAX_THREADS:
                    assert p.cpl in (most, 2 * most)
                elif p.lanes != 32:
                    assert p.cpl == (1 if p.lanes < 32 else most)
                assert p.threads % 32 == 0 and p.threads <= RMS.MAX_THREADS
                assert p.threads % p.lanes == 0
                assert p.lanes * p.cpl * p.vec >= D
                pairs, hits = _cover(p, N, D)
                assert (pairs == 1).all(), (D, elt, vec, N, p)
                assert (hits == 1).all(), (D, elt, vec, N, p)
                # the grid holds no CTA without a row
                assert (p.grid - 1) * (p.threads // p.lanes) < N


@pytest.mark.parametrize("D,H", WIDTHS)
def test_lanes_and_chunks_do_not_depend_on_the_row_count(D, H):
    """A row's reduction order (lanes per row, chunks per lane) is the same
    at every batch size, so one token's norm is bitwise the same in a
    decode step and in a prefill step; only the CTA size and grid follow
    the row count."""
    for elt in (4, 2):
        for vec in (True, False):
            if vec and (D * elt) % 16:
                continue
            seen = {RMS.launch_plan(-(-n // H) * H, D, elt, vec)[:3]
                    for n in ROWS}
            assert len(seen) == 1, (D, elt, vec, seen)


@pytest.mark.parametrize("nq,nk", [(256, 64), (16384, 4096), (32, 16),
                                   (1, 1), (20000, 3)])
@pytest.mark.parametrize("D", [128, 16, 100])
def test_pair_launch_covers_both_segments_as_alone(nq, nk, D):
    """The pair's launch, as the wrapper makes it: one plan for both
    segments' rows together, and for each segment its own run of CTAs of
    that plan's size. Each segment is covered once, with the lanes and
    chunks per lane of its own single launch (so it is reduced bitwise as
    alone)."""
    for elt in (4, 2):
        for vec in (True, False):
            if vec and (D * elt) % 16:
                continue
            p = RMS.launch_plan(nq + nk, D, elt, vec)
            for n in (nq, nk):
                seg = p._replace(grid=-(-n // (p.threads // p.lanes)))
                alone = RMS.launch_plan(n, D, elt, vec)
                assert seg[:3] == alone[:3]
                pairs, hits = _cover(seg, n, D)
                assert (pairs == 1).all() and (hits == 1).all()
                assert (seg.grid - 1) * (p.threads // p.lanes) < n


def test_launch_plan_refuses_what_the_kernel_cannot_cover():
    with pytest.raises(ValueError, match="chunks"):
        RMS.launch_plan(4, 100, 2, vec=True)   # 200 bytes: no 16-byte chunks
    with pytest.raises(ValueError, match="threads"):
        RMS.launch_plan(4, 8193, 4, vec=False)   # 8193 elements: 512 lanes
    with pytest.raises(ValueError, match="threads"):
        RMS.launch_plan(4, 8196, 4, vec=True)    # 2049 chunks: 512 lanes


def test_launch_plan_fits_the_rows_to_the_card():
    """One lane per 16-byte chunk up to 32 chunks, up to 4 chunks per lane
    beyond (16 single elements); few rows take CTAs as small as a warp (or
    one row), spread over the SMs."""
    P = RMS.Plan
    assert RMS.launch_plan(16384, 128, 2) == P(8, 16, 1, 256, 1024)
    assert RMS.launch_plan(32768, 64, 2) == P(8, 8, 1, 256, 1024)
    assert RMS.launch_plan(512, 4096, 2) == P(8, 128, 4, 256, 256)
    assert RMS.launch_plan(256, 128, 2) == P(8, 16, 1, 32, 128)
    assert RMS.launch_plan(8, 4096, 2) == P(8, 128, 4, 128, 8)
    assert RMS.launch_plan(8, 2048, 2) == P(8, 64, 4, 64, 8)
    assert RMS.launch_plan(20480, 128, 2) == P(8, 16, 1, 256, 1280)
    assert RMS.launch_plan(20480, 128, 4) == P(4, 32, 1, 256, 2560)
    assert RMS.launch_plan(8, 4096, 4, vec=False) == P(1, 256, 16, 256, 8)
    # fp32 rows past 4096 elements (qwen-32b's 5120, llama-70b's 8192): a
    # CTA of 256 lanes per row, 8 chunks a lane (32 single elements)
    assert RMS.launch_plan(512, 5120, 4) == P(4, 256, 8, 256, 512)
    assert RMS.launch_plan(8, 8192, 4) == P(4, 256, 8, 256, 8)
    assert RMS.launch_plan(8, 5120, 4, vec=False) == P(1, 256, 32, 256, 8)
    assert RMS.launch_plan(8, 5120, 2) == P(8, 256, 4, 256, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape_q,shape_k", [
    ((2, 3, 4, 16), (2, 3, 2, 16)),       # reduced: [B, S, H, head_dim]
    ((1, 5, 32, 128), (1, 5, 8, 128)),    # qwen3-8b's heads
    ((4, 100), (0, 100)),                 # an empty k
])
def test_pair_is_two_rmsnorms_bitwise(dtype, shape_q, shape_k):
    rng = np.random.default_rng(sum(shape_q) + sum(shape_k))
    D = shape_q[-1]
    q, k = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 3)
            .to(dtype) for s in (shape_q, shape_k))
    sq, sk = (torch.from_numpy(rng.standard_normal((D,), dtype=np.float32))
              .to(dtype) for _ in range(2))
    before = RMS.launches
    gq, gk = ops.rmsnorm_pair(q, sq, k, sk, 1e-6)
    assert RMS.launches == before
    assert gq.shape == q.shape and gk.shape == k.shape
    assert torch.equal(gq, ops.rmsnorm(q, sq, 1e-6))
    assert torch.equal(gk, ops.rmsnorm(k, sk, 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_matches_reference_rmsnorm(dtype):
    """q and k of the pair against ``layers.rmsnorm`` of the reference: fp32
    at 1e-6, bf16 within one ulp and equal in all but 1 % of elements, the
    tolerances of ``test_torch_kernels.py``'s single-norm tests."""
    rng = np.random.default_rng(7)
    q32 = rng.standard_normal((3, 8, 4, 64), dtype=np.float32) * 3
    k32 = rng.standard_normal((3, 8, 2, 64), dtype=np.float32) * 3
    sq32, sk32 = (rng.standard_normal((64,), dtype=np.float32)
                  for _ in range(2))
    q, k, sq, sk = (torch.from_numpy(a).to(dtype)
                    for a in (q32, k32, sq32, sk32))
    got = ops.rmsnorm_pair(q, sq, k, sk, 1e-6)
    jt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for g, x, s in zip(got, (q, k), (sq, sk)):
        sj, xj = (jnp.asarray(t.float().numpy()).astype(jt) for t in (s, x))
        ref = jax_rmsnorm({"scale": sj}, xj)
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-6,
                                       rtol=1e-6)
        else:
            want = torch.from_numpy(
                np.array(ref.astype(jnp.float32))).bfloat16()
            ulps = _bf16_ulps(g, want)
            assert int(ulps.max()) <= 1
            assert int((ulps > 0).sum()) <= max(1, g.numel() // 100)


def test_attention_layers_norm_q_and_k_through_the_pair(monkeypatch):
    """A reduced qwen3-8b forward calls the pair once per attention layer
    (qk_norm set) and a single norm for everything else; a config without
    qk_norm never calls it."""
    calls = {"pair": 0}
    plain = RMS.rmsnorm_pair_plain

    def counted(*a):
        calls["pair"] += 1
        return plain(*a)

    monkeypatch.setattr(RMS, "rmsnorm_pair_plain", counted)
    from repro_torch.configs import get_config
    for name, want in (("qwen3-8b", True), ("qwen2-1.5b", False)):
        cfg = get_config(name).reduced()
        assert cfg.qk_norm == want
        model = Model(cfg, device="cpu", dtype=torch.float32)
        model.init_params(torch.Generator().manual_seed(0))
        model.init_cache(2, 16)
        calls["pair"] = 0
        toks = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
        model.prefill(toks, [0, 0])
        assert calls["pair"] == (cfg.num_layers if want else 0)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """Refused with an error before any launch, so this runs without a
    card: another dtype, a scale of the wrong shape or type, CPU tensors,
    and a pair whose q and k differ in D."""
    before = RMS.launches
    x = torch.zeros((4, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        RMS.rmsnorm_cuda(x.half(), torch.zeros(8).half())
    with pytest.raises(ValueError, match="scale"):
        RMS.rmsnorm_cuda(x, torch.zeros(7))
    with pytest.raises(ValueError, match="scale"):
        RMS.rmsnorm_cuda(x, torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA device"):
        RMS.rmsnorm_cuda(x, torch.zeros(8))
    with pytest.raises(ValueError, match="must share"):
        RMS.rmsnorm_pair_cuda(x, torch.zeros(8), torch.zeros((4, 16)),
                              torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA device"):
        RMS.rmsnorm_pair_cuda(x, torch.zeros(8), x, torch.zeros(8))
    assert RMS.launches == before
