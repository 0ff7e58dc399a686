"""The port's hand-written kernels against their plain PyTorch versions, on
the card. The CUDA kernels have no CPU mode, so every test here but those
that stop before a launch is marked ``cuda`` and skips without a card. This file
imports neither jax nor the reference package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

It also holds the eight-case paged-attention grid and the flash and decode
cases that ``test_torch_kernels.py`` runs against the reference on the CPU,
and the SSD chunk cases of ``test_torch_ssd.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine import EngineConfig, Request, ShiftEngine  # noqa: E402
from repro_torch.engine.deployment import (CapturedStep, Deployment,  # noqa: E402
                                           GraphPool)
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PDA  # noqa: E402
from repro_torch.kernels import paged_ragged_attention as PRA  # noqa: E402
from repro_torch.kernels import rmsnorm as RMS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch.serve import workload  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def paged_case(B, C, Hq, Hkv, D, bs, nmax, ctx, ql, seed=0):
    """numpy twin of ``test_workprop_attention._setup``: q [B, C, Hq, D],
    a pool and tables mapping ceil(ctx/bs) scattered blocks per row, capped
    at the table width; unmapped entries are the null block."""
    ctx = np.asarray(ctx, np.int32)
    ql = np.asarray(ql, np.int32)
    nbs = [min(-(-int(c) // bs), nmax) for c in ctx]
    nblocks = sum(nbs) + 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, Hq, D), dtype=np.float32)
    kp = rng.standard_normal((nblocks, bs, Hkv, D), dtype=np.float32)
    vp = rng.standard_normal((nblocks, bs, Hkv, D), dtype=np.float32)
    phys = rng.permutation(np.arange(1, nblocks))
    bt = np.zeros((B, nmax), np.int32)
    pi = 0
    for b, nb in enumerate(nbs):
        bt[b, :nb] = phys[pi:pi + nb]
        pi += nb
    return q, kp, vp, bt, ql, ctx


CASES = [
    # B, C, Hq, Hkv, D, bs, nmax, ctx, ql, window, soft_cap
    (4, 8, 8, 2, 64, 16, 8, [40, 8, 33, 0], [8, 8, 1, 0], 0, 0.0),   # GQA 4:1
    (3, 4, 4, 4, 32, 8, 6, [8, 9, 31], [4, 2, 3], 0, 0.0),           # MHA, tails
    (3, 1, 8, 1, 64, 16, 16, [1, 17, 200], [1, 1, 1], 0, 0.0),       # MQA decode
    (4, 8, 8, 2, 64, 16, 8, [40, 8, 33, 16], [8, 8, 1, 4], 12, 0.0),  # window
    (3, 4, 4, 2, 32, 8, 8, [30, 64, 5], [4, 4, 2], 7, 0.0),          # window tails
    (4, 8, 8, 2, 64, 16, 8, [40, 8, 33, 0], [8, 8, 1, 0], 0, 30.0),  # soft cap
    (3, 4, 4, 2, 32, 8, 8, [30, 64, 5], [4, 4, 2], 9, 20.0),         # both
    # ctx past the table (padding overhang): positions beyond nmax*bs absent
    (2, 8, 4, 2, 32, 8, 4, [36, 20], [8, 8], 0, 0.0),
]
PARAMS = "B,C,Hq,Hkv,D,bs,nmax,ctx,ql,window,cap"

# the plain versions and the kernels sum in another order: fp32 agrees to
# ~1e-6 relative; bf16 outputs differ by at most an ulp or two (2^-7 rel.)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def test_cpu_tensors_never_reach_a_kernel():
    """The kernels' entry points refuse CPU tensors instead of carrying on."""
    q, kp, vp, bt, ql, ctx = paged_case(*CASES[0][:9])
    with pytest.raises(ValueError, match="must lie on"):
        PRA.paged_ragged_attention_cuda(
            torch.from_numpy(q).reshape(4, 2, 4, 8, 64), torch.from_numpy(kp),
            torch.from_numpy(vp), torch.from_numpy(bt), torch.from_numpy(ql),
            torch.from_numpy(ctx))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(PARAMS, CASES)
def test_cuda_attention_matches_plain(cuda, dtype, B, C, Hq, Hkv, D, bs,
                                      nmax, ctx, ql, window, cap):
    q, kp, vp, bt, qla, ctxa = paged_case(B, C, Hq, Hkv, D, bs, nmax, ctx, ql)
    g = Hq // Hkv
    args = [torch.from_numpy(q).transpose(1, 2).reshape(B, Hkv, g, C, D)
            .contiguous().to(cuda, dtype),
            torch.from_numpy(kp).to(cuda, dtype),
            torch.from_numpy(vp).to(cuda, dtype),
            *(torch.from_numpy(a).to(cuda) for a in (bt, qla, ctxa))]
    before = PRA.launches
    got = PRA.paged_ragged_attention_cuda(*args, window=window, soft_cap=cap)
    torch.cuda.synchronize()
    assert PRA.launches == before + 1
    want = PRA.paged_ragged_attention_plain(*args, window=window,
                                            soft_cap=cap)
    assert torch.isfinite(got.float()).all()      # padding columns too
    got = got.float().reshape(B, Hq, C, D).transpose(1, 2)
    want = want.float().reshape(B, Hq, C, D).transpose(1, 2)
    for b in range(B):
        n = int(ql[b])
        torch.testing.assert_close(got[b, :n], want[b, :n], atol=TOL[dtype],
                                   rtol=TOL[dtype])
        if int(ctx[b]) == 0:
            assert not got[b].any()               # empty rows give zeros


# The tiles of the ragged kernel: rows per (sequence, kv head) that are not
# a multiple of 16 (g * q_len 5, 6, 12), padding columns, empty rows, bs 8,
# 16 and 32, D 32 to 256, window and soft cap, long rows crossing many key
# tiles, decode batches whose tiles split the keys across warps (at most 16
# live rows: four ways; at most 32: two ways), small grids whose tiles split
# the keys across a cluster of CTAs, and a grid large enough for no split
RAGGED_TILE_CASES = [
    (2, 1, 5, 1, 64, 16, 8, [100, 7], [1, 1], 0, 0.0),              # 5 rows
    (3, 4, 6, 1, 128, 8, 16, [120, 5, 0], [1, 3, 0], 0, 0.0),       # 6, 18
    (2, 3, 8, 2, 32, 32, 4, [97, 3], [3, 2], 0, 0.0),               # 12 rows
    (2, 6, 4, 1, 64, 8, 20, [150, 40], [6, 5], 0, 0.0),             # 2-way
    (2, 8, 4, 2, 256, 16, 8, [100, 30], [8, 5], 0, 0.0),            # D 256
    (3, 16, 16, 4, 64, 32, 8, [250, 33, 16], [16, 16, 9], 50, 0.0),  # bs 32
    (2, 64, 8, 2, 128, 16, 80, [1200, 640], [64, 50], 200, 30.0),   # both
    (2, 64, 32, 8, 128, 16, 72, [1100, 1024], [64, 17], 0, 0.0),    # long
    (8, 1, 32, 8, 128, 16, 128, [2000, 1500, 1, 0, 513, 64, 1024, 2048],
     [1] * 8, 0, 0.0),                                              # decode
    (4, 1, 16, 2, 256, 8, 40, [300, 17, 8, 1], [1] * 4, 0, 50.0),   # decode
    (3, 128, 32, 8, 128, 16, 72, [300, 1100, 700], [128, 100, 60], 0,
     0.0),                                                          # no split
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(PARAMS, RAGGED_TILE_CASES)
def test_cuda_ragged_tiles_match_plain(cuda, dtype, B, C, Hq, Hkv, D, bs,
                                       nmax, ctx, ql, window, cap):
    """One launch per call; real columns within TOL of the plain version;
    padding columns and rows with ctx == 0 come back as zeros."""
    q, kp, vp, bt, qla, ctxa = paged_case(B, C, Hq, Hkv, D, bs, nmax, ctx, ql,
                                          seed=B + C + D)
    g = Hq // Hkv
    args = [torch.from_numpy(q).transpose(1, 2).reshape(B, Hkv, g, C, D)
            .contiguous().to(cuda, dtype),
            torch.from_numpy(kp).to(cuda, dtype),
            torch.from_numpy(vp).to(cuda, dtype),
            *(torch.from_numpy(a).to(cuda) for a in (bt, qla, ctxa))]
    before = PRA.launches
    got = PRA.paged_ragged_attention_cuda(*args, window=window, soft_cap=cap)
    torch.cuda.synchronize()
    assert PRA.launches == before + 1
    want = PRA.paged_ragged_attention_plain(*args, window=window,
                                            soft_cap=cap)
    for b in range(B):
        n = int(ql[b]) if int(ctx[b]) else 0
        torch.testing.assert_close(got[b, :, :, :n].float(),
                                   want[b, :, :, :n].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert not got[b, :, :, n:].any()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Refused with a ValueError before any launch: a bf16 head dim that is
    not a multiple of 16 (the tensor cores' depth; also the SSD chunk's hd
    and ds), an fp32 one that is not a multiple of 4, and a head dim over
    256. Checked before the device, so this runs without a card too."""
    before = (PRA.launches, FA.launches, DA.launches, PDA.launches,
              SSD.launches)
    for dtype, D in ((torch.bfloat16, 24), (torch.float32, 6),
                     (torch.bfloat16, 272)):
        q = torch.zeros((1, 1, 2, 3, D), dtype=dtype)
        pool = torch.zeros((2, 8, 1, D), dtype=dtype)
        i32 = torch.zeros((1, 2), dtype=torch.int32)
        with pytest.raises(ValueError, match="head dim"):
            PRA.paged_ragged_attention_cuda(q, pool, pool, i32, i32[0, :1],
                                            i32[0, :1])
    for dtype, D in ((torch.bfloat16, 24), (torch.float32, 12),
                     (torch.float32, 264)):
        q = torch.zeros((1, 3, 2, D), dtype=dtype)
        kv = torch.zeros((1, 5, 1, D), dtype=dtype)
        with pytest.raises(ValueError, match="D %"):
            FA.flash_attention_cuda(q, kv, kv, torch.zeros(1, dtype=torch.int32))
    # the dense decode's bf16 tile: the tensor cores' depth of 16
    q = torch.zeros((1, 1, 4, 24), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 1, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        DA.decode_attention_cuda(q, kv, kv, torch.ones(1, dtype=torch.int32))
    # the padded paged decode's bf16 tile: the same depth of 16
    pool = torch.zeros((2, 8, 1, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        PDA.paged_decode_attention_cuda(q, pool, pool,
                                        torch.ones((1, 2), dtype=torch.int32),
                                        torch.ones(1, dtype=torch.int32))
    # the SSD chunk's bf16 tiles: hd and ds multiples of 16
    for hd, ds in ((24, 16), (16, 24)):
        x = torch.zeros((1, 8, 2, hd), dtype=torch.bfloat16)
        bc = torch.zeros((1, 8, 2, ds), dtype=torch.bfloat16)
        f = torch.zeros((1, 8, 2))
        with pytest.raises(ValueError, match="hd"):
            SSD.ssd_chunk_cuda(x, bc, bc, f, f, 8)
    assert (PRA.launches, FA.launches, DA.launches, PDA.launches,
            SSD.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D", [
    (37, 4096), (200, 128), (5, 100), (3, 16),
    # a decode step's rows: qwen3-8b's hidden, q and k heads; mamba2's hidden
    (8, 4096), (256, 128), (64, 128), (8, 2048),
])
def test_cuda_rmsnorm_matches_plain(cuda, dtype, N, D):
    g = torch.Generator(device=cuda).manual_seed(N + D)
    x = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    s = torch.randn((D,), generator=g, device=cuda).to(dtype)
    before = RMS.launches
    got = RMS.rmsnorm_cuda(x, s)
    torch.cuda.synchronize()
    assert RMS.launches == before + 1
    torch.testing.assert_close(got.float(), RMS.rmsnorm_plain(x, s).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D", [(37, 4096), (200, 128), (9, 64)])
def test_cuda_rmsnorm_unaligned_rows_match_plain(cuda, dtype, N, D):
    """Rows 2 elements apart from 16-byte alignment (a view into a wider
    buffer, one element in) take the scalar instance."""
    g = torch.Generator(device=cuda).manual_seed(N * D)
    buf = torch.randn((N, D + 2), generator=g, device=cuda).to(dtype)
    x = buf[:, 1:D + 1]
    s = torch.randn((D,), generator=g, device=cuda).to(dtype)
    got = RMS.rmsnorm_cuda(x, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), RMS.rmsnorm_plain(x, s).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_shape,k_shape", [
    ((8, 1, 32, 128), (8, 1, 8, 128)),       # qwen3-8b, a decode step
    ((8, 64, 32, 128), (8, 64, 8, 128)),     # qwen3-8b, a prefill step
    ((2, 8, 4, 16), (2, 8, 2, 16)),          # reduced, head_dim 16
    ((3, 100), (0, 100)),                    # an empty k, D 100
])
def test_cuda_rmsnorm_pair_equals_two_launches(cuda, dtype, q_shape,
                                               k_shape):
    """q_norm and k_norm in one launch: bitwise equal to two single
    launches (the same plan per row), the launch count rising by 1."""
    g = torch.Generator(device=cuda).manual_seed(sum(q_shape) + sum(k_shape))
    D = q_shape[-1]
    q = torch.randn(q_shape, generator=g, device=cuda).to(dtype)
    k = torch.randn(k_shape, generator=g, device=cuda).to(dtype)
    sq = torch.randn((D,), generator=g, device=cuda).to(dtype)
    sk = torch.randn((D,), generator=g, device=cuda).to(dtype)
    before = RMS.launches
    gq, gk = RMS.rmsnorm_pair_cuda(q, sq, k, sk)
    torch.cuda.synchronize()
    assert RMS.launches == before + 1
    assert torch.equal(gq, RMS.rmsnorm_cuda(q, sq))
    if k.numel():
        assert torch.equal(gk, RMS.rmsnorm_cuda(k, sk))
    assert gk.shape == k.shape
    for got, want in zip((gq, gk), RMS.rmsnorm_pair_plain(q, sq, k, sk)):
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])


def dense_case(B, Sq, Skv, Hq, Hkv, D, seed=0):
    """q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D] from a seed."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32)
                 for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, q_offsets: the four TPU-contract
    # cases of tests/test_kernels.py, then chunks against a longer cache
    (1, 128, 128, 4, 2, 64, True, None),
    (2, 256, 256, 4, 1, 128, True, None),
    (1, 128, 256, 2, 2, 64, False, None),
    (1, 256, 256, 8, 2, 128, True, None),
    (3, 64, 200, 32, 8, 128, True, [0, 70, 136]),
    (2, 5, 33, 6, 1, 16, True, [3, 28]),
]
# The tiles of the flash kernel: query rows that do not fill the row tile,
# g 1 and g 8, non-zero offsets, non-causal, D 16 to 256, and shapes with
# CTAs enough for the 8-warp (128-row) tile
FLASH_TILE_CASES = [
    (2, 100, 300, 4, 4, 64, True, [0, 150]),
    (2, 37, 500, 16, 2, 128, True, [0, 400]),
    (1, 70, 190, 8, 2, 256, False, [0]),
    (3, 33, 65, 2, 2, 16, False, [0, 5, 9]),
    (4, 512, 512, 32, 4, 32, True, None),
    (1, 1024, 1536, 32, 8, 128, True, [512]),
]
DECODE_CASES = [  # B, S, Hq, Hkv, D (S need not tile)
    (4, 512, 8, 2, 64), (2, 1024, 4, 4, 128), (8, 512, 16, 1, 64),
    (3, 100, 32, 8, 128),
]
# The edges of the bf16 tensor-core tile, in both types where fp32 takes
# them: one 2048-token row (B * Hkv = 8: the largest cluster split), lens
# 1 and lens == S in one batch, S not a multiple of the 64-key tile, g 1, 8
# and 20 (two row tiles), and bf16 head dims 16 to 256
DECODE_TILE_CASES = [  # B, S, Hq, Hkv, D, lens, dtypes
    (1, 2048, 32, 8, 128, [2048], "both"),
    (3, 640, 16, 4, 128, [1, 640, 333], "both"),
    (4, 200, 8, 8, 64, [200, 1, 77, 129], "both"),
    (2, 1000, 64, 8, 128, [1000, 999], "both"),
    (2, 130, 40, 2, 64, [130, 64], "both"),
    (2, 300, 32, 8, 256, [300, 45], "bf16"),
    (2, 96, 8, 2, 32, [96, 3], "both"),
    (2, 70, 4, 2, 16, [70, 9], "both"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,offs",
                         FLASH_CASES + FLASH_TILE_CASES)
def test_cuda_flash_matches_plain(cuda, dtype, B, Sq, Skv, Hq, Hkv, D,
                                  causal, offs):
    """The kernel reads k and v through strides: they are handed in as a
    slice of a larger cache, as the model's per-layer view is."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in dense_case(B, Sq, Skv, Hq, Hkv, D))
    cache = torch.zeros((2, B, Skv, Hkv, D), dtype=dtype, device=cuda)
    cache[0], cache[1] = k, v
    qo = torch.tensor(offs or [0] * B, dtype=torch.int32, device=cuda)
    before = FA.launches
    got = FA.flash_attention_cuda(q, cache[0], cache[1], qo, causal=causal)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, qo, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", DECODE_CASES)
def test_cuda_decode_matches_plain(cuda, dtype, B, S, Hq, Hkv, D):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in dense_case(B, 1, S, Hq, Hkv, D, seed=S))
    q = q.reshape(B, Hkv, Hq // Hkv, D)
    lens = torch.from_numpy(np.random.default_rng(S).integers(
        1, S + 1, (B,)).astype(np.int32)).to(cuda)
    before = DA.launches
    got = DA.decode_attention_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    assert DA.launches == before + 1
    want = DA.decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,S,Hq,Hkv,D,lens", [
    (dtype, *case[:6]) for case in DECODE_TILE_CASES
    for dtype in (torch.float32, torch.bfloat16)
    if case[6] == "both" or dtype == torch.bfloat16])
def test_cuda_decode_tiles_match_plain(cuda, dtype, B, S, Hq, Hkv, D, lens):
    """The cache is handed in as per-layer views of one tensor, as the model
    holds it."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in dense_case(B, 1, S, Hq, Hkv, D, seed=S + D))
    q = q.reshape(B, Hkv, Hq // Hkv, D)
    cache = torch.stack([k, v])
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = DA.launches
    got = DA.decode_attention_cuda(q, cache[0], cache[1], ln)
    torch.cuda.synchronize()
    assert DA.launches == before + 1
    want = DA.decode_attention_plain(q, k, v, ln)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,bs,nmax,ctx", [
    (4, 8, 2, 64, 16, 8, [40, 8, 100, 128]),
    (3, 16, 1, 64, 16, 16, [1, 17, 200]),
    (2, 32, 8, 128, 16, 64, [1000, 33]),
])
def test_cuda_paged_decode_matches_plain_and_ragged(cuda, dtype, B, Hq, Hkv,
                                                    D, bs, nmax, ctx):
    """The padded walk against its plain version, and against the ragged
    kernel at C == 1 on the same inputs (the reference's
    ``test_ragged_kernel_decode_degenerates_to_padded``); poisoned null
    block and table tails must not matter."""
    q, kp, vp, bt, ql, lens = paged_case(B, 1, Hq, Hkv, D, bs, nmax, ctx,
                                         [1] * B)
    kp[0], vp[0] = 99.0, -99.0
    g = Hq // Hkv
    q4 = torch.from_numpy(q).reshape(B, Hkv, g, D).to(cuda, dtype)
    kp, vp = (torch.from_numpy(a).to(cuda, dtype) for a in (kp, vp))
    bt, ql, lens = (torch.from_numpy(a).to(cuda) for a in (bt, ql, lens))
    before = PDA.launches
    got = PDA.paged_decode_attention_cuda(q4, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert PDA.launches == before + 1
    want = PDA.paged_decode_attention_plain(q4, kp, vp, bt, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    rag = PRA.paged_ragged_attention_cuda(q4[:, :, :, None].contiguous(), kp,
                                          vp, bt, ql, lens)[:, :, :, 0]
    tol = 1e-5 if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), rag.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,bs,nmax,ctx", [
    (4, 32, 8, 128, 16, 64, [1, 70, 130, 300]),   # lens far short of nmax*bs
    (3, 8, 2, 64, 24, 20, [5, 100, 200]),         # bs 24 does not divide 64
    (2, 16, 4, 128, 40, 12, [1, 333]),            # bs 40, one key
    (2, 4, 1, 32, 7, 30, [64, 129]),              # bs 7, D 32
])
def test_cuda_paged_decode_stops_at_lens(cuda, dtype, B, Hq, Hkv, D, bs,
                                         nmax, ctx):
    """Tables longer than their rows: the poisoned null block (the odd
    rows' table tails) and one more poisoned block (every tail entry of the
    even rows) must not matter, in the bf16 walk that stops at lens and the
    fp32 walk over every block; against the plain version and the ragged
    kernel at C == 1."""
    q, kp, vp, bt, ql, lens = paged_case(B, 1, Hq, Hkv, D, bs, nmax, ctx,
                                         [1] * B)
    poison = kp.shape[0]
    kp = np.concatenate([kp, np.full_like(kp[:1], 99.0)])
    vp = np.concatenate([vp, np.full_like(vp[:1], -99.0)])
    kp[0], vp[0] = 99.0, -99.0
    for b, c in enumerate(ctx):   # even rows: tails at the poisoned block
        if b % 2 == 0:
            bt[b, -(-c // bs):] = poison
    g = Hq // Hkv
    q4 = torch.from_numpy(q).reshape(B, Hkv, g, D).to(cuda, dtype)
    kp, vp = (torch.from_numpy(a).to(cuda, dtype) for a in (kp, vp))
    bt, ql, lens = (torch.from_numpy(a).to(cuda) for a in (bt, ql, lens))
    before = PDA.launches
    got = PDA.paged_decode_attention_cuda(q4, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert PDA.launches == before + 1
    assert torch.isfinite(got.float()).all()
    want = PDA.paged_decode_attention_plain(q4, kp, vp, bt, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    rag = PRA.paged_ragged_attention_cuda(q4[:, :, :, None].contiguous(), kp,
                                          vp, bt, ql, lens)[:, :, :, 0]
    tol = 1e-5 if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), rag.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(cuda):
    """Reduced qwen3-8b at fp32: the engine on the card (kernels) and on the
    CPU (plain versions) give equal streams under pool pressure, and the
    card's run went through both kernels."""
    cfg = get_config("qwen3-8b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda, dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    runs = []
    for model in (gpu, cpu):
        PRA.launches = RMS.launches = 0
        eng = ShiftEngine(model, EngineConfig(num_blocks=9, block_size=8))
        reqs = workload(6, 8)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        runs.append(([r.generated for r in reqs], eng.config_counts,
                     eng.preemptions, eng.kv.num_free_blocks,
                     PRA.launches, RMS.launches))
    steps = sum(runs[0][1].values())
    assert runs[0][:4] == runs[1][:4]
    # RMSNorm per step: ln1, ln2 and the q/k pair per layer, the final norm
    assert runs[0][4:] == (steps * cfg.num_layers,
                           steps * (3 * cfg.num_layers + 1))
    assert runs[1][4:] == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"mixed": False},
                                {"mixed": False, "num_blocks": 9,
                                 "block_size": 8},
                                {"paged": False, "mixed": False}],
                         ids=["serialized", "serialized-tight-pool", "dense"])
def test_cuda_serialized_engine_matches_cpu_engine(cuda, kw):
    """The serialized iteration, on the paged pool and on the dense cache:
    equal streams, config counts and preemptions on the card and the CPU,
    and the card's run went through its kernels: per step one attention
    launch per layer (ragged on the pool; flash for a dense prefill,
    decode for a dense decode) and 3 * layers + 1 RMSNorm launches (ln1,
    ln2 and the q/k pair per layer, the final norm)."""
    cfg = get_config("qwen3-8b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda, dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    runs, counts = [], []
    for model in (gpu, cpu):
        for mod in (PRA, RMS, FA, DA, PDA):
            mod.launches = 0
        eng = ShiftEngine(model, EngineConfig(**kw))
        reqs = workload(6, 8)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        runs.append(([r.generated for r in reqs], eng.config_counts,
                     eng.preemptions))
        counts.append((PRA.launches, FA.launches, DA.launches, PDA.launches,
                       RMS.launches))
    assert runs[0] == runs[1]
    assert counts[1] == (0, 0, 0, 0, 0)
    steps = sum(runs[0][1].values())
    pra, fa, da, pda, rms = counts[0]
    assert rms == steps * (3 * cfg.num_layers + 1) and pda == 0
    if kw.get("paged", True):
        assert (pra, fa, da) == (steps * cfg.num_layers, 0, 0)
    else:
        assert pra == 0 and fa > 0 and da > 0
        assert fa + da == steps * cfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,D", [(37, 8, 16), (64, 64, 64), (5, 3, 100),
                                   (8, 64, 64)])
def test_cuda_grouped_rmsnorm_matches_plain(cuda, dtype, N, H, D):
    """The SSD mixer's per-head norm: x [N, H, D] with scale [H, D]."""
    g = torch.Generator(device=cuda).manual_seed(N + H + D)
    x = torch.randn((N, H, D), generator=g, device=cuda).to(dtype)
    s = torch.randn((H, D), generator=g, device=cuda).to(dtype)
    before = RMS.launches
    got = RMS.rmsnorm_cuda(x, s)
    torch.cuda.synchronize()
    assert RMS.launches == before + 1
    torch.testing.assert_close(got.float(), RMS.rmsnorm_plain(x, s).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def ssd_case(B, S, H, hd, ds, L, shared, dtype, device, seed=0, scale=1.0):
    """x [B, S, H, hd]; b, c [B, S, H, ds], shared by the heads through a
    head stride of 0 (the model's layout) or per head (the TPU contract's
    copies), all three times ``scale``; dt = softplus(normal), cum its
    within-chunk cumsum of -dt·A."""
    rng = np.random.default_rng(seed)
    bh = 1 if shared else H
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32) * scale
    b = rng.standard_normal((B, S, bh, ds), dtype=np.float32) * 0.3 * scale
    c = rng.standard_normal((B, S, bh, ds), dtype=np.float32) * 0.3 * scale
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)))
    A = np.exp(rng.standard_normal((H,), dtype=np.float32) * 0.5)
    cum = np.cumsum((-dt * A).reshape(B, S // L, L, H), axis=2,
                    dtype=np.float32).reshape(B, S, H)
    x, b, c = (torch.from_numpy(a).to(device, dtype) for a in (x, b, c))
    if shared:
        b, c = b.expand(B, S, H, ds), c.expand(B, S, H, ds)
    return (x, b, c, torch.from_numpy(dt).to(device),
            torch.from_numpy(cum).to(device))


SSD_CASES = [
    # B, S, H, hd, ds, L, shared, scale: the serving prefill step of
    # mamba2-1.3b, a long prompt, a short prefill (S < chunk: one chunk of
    # S), the reduced model, and the TPU contract's per-(head, chunk)
    # copies; chunks padded to the tensor cores' 16 rows (L 8, 19: two
    # chunks), hd 16 / ds 16 per head; inputs at 8x their scale, where the
    # bf16 instance's products would miss 1e-4 with a two-part split of
    # their fp32 operands (tests/test_torch_ssd.py) and fp32 sums still
    # hold it (at the serving width they do not: 8x is tested narrower)
    (8, 64, 64, 64, 128, 64, True, 1.0),
    (1, 2048, 64, 64, 128, 64, True, 1.0),
    (2, 19, 8, 64, 128, 19, True, 1.0),
    (2, 16, 8, 16, 16, 8, True, 1.0),
    (6, 64, 1, 32, 16, 64, False, 1.0),
    (2, 128, 1, 64, 32, 128, False, 1.0),
    (3, 64, 4, 64, 128, 32, False, 1.0),
    (1, 38, 8, 64, 128, 19, True, 1.0),
    (4, 32, 2, 16, 16, 16, False, 1.0),
    (2, 16, 8, 16, 16, 8, True, 8.0),
    (3, 40, 4, 32, 32, 8, True, 8.0),
    (2, 128, 1, 64, 32, 128, False, 8.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,ds,L,shared,scale", SSD_CASES)
def test_cuda_ssd_chunk_matches_plain(cuda, dtype, B, S, H, hd, ds, L,
                                      shared, scale):
    """The kernel against its plain version on the same inputs; both compute
    in fp32 from the same (fp32 or bf16) inputs and differ only in the order
    of their sums (and, in bf16, by the three-part split of the fp32
    operands, ~2^-27 of each), so fp32 outputs agree within 1e-4 in either
    type. x is handed in as a slice of a wider tensor, as the model's view
    of the conv output is."""
    x, b, c, dt, cum = ssd_case(B, S, H, hd, ds, L, shared, dtype, cuda,
                                scale=scale)
    wide = torch.zeros((B, S, H, hd + 8), dtype=dtype, device=cuda)
    wide[..., :hd] = x
    before = SSD.launches
    got = SSD.ssd_chunk_cuda(wide[..., :hd], b, c, dt, cum, L)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    want = SSD.ssd_chunk_plain(x, b, c, dt, cum, L)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_ssd_chunk_refuses_what_it_does_not_take(cuda):
    x, b, c, dt, cum = ssd_case(1, 16, 2, 16, 16, 8, True, torch.float32,
                                cuda)
    with pytest.raises(ValueError, match="chunk"):
        SSD.ssd_chunk_cuda(x, b, c, dt, cum, 5)          # does not divide S
    with pytest.raises(ValueError, match="hd"):
        SSD.ssd_chunk_cuda(x[..., :6], b, c, dt, cum, 8)
    with pytest.raises(ValueError, match="must lie on"):
        SSD.ssd_chunk_cuda(x, b.cpu(), c, dt, cum, 8)


@pytest.mark.cuda
def test_cuda_mamba2_engine_matches_cpu_engine(cuda):
    """Reduced mamba2 at fp32 on the dense serialized engine (the automatic
    fallback): equal streams and config counts on the card and the CPU,
    with more requests than slots; the card's run went through its kernels,
    one SSD chunk launch per layer per prefill step and none in a decode
    step, and 2 * layers + 1 RMSNorm launches per step (ln1 and the grouped
    norm of each layer, and the final norm)."""
    cfg = get_config("mamba2-1.3b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda, dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    runs, counts = [], []
    for model in (gpu, cpu):
        SSD.launches = RMS.launches = 0
        eng = ShiftEngine(model, EngineConfig(max_slots=4))
        assert not eng.paged
        prefill_steps = [0]
        run_prefill = eng._run_prefill

        def counted():
            did = run_prefill()
            prefill_steps[0] += int(did)
            return did
        eng._run_prefill = counted
        reqs = workload(6, 8)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        runs.append(([r.generated for r in reqs], eng.config_counts))
        counts.append((SSD.launches, RMS.launches, prefill_steps[0]))
    assert runs[0] == runs[1]
    steps = sum(runs[0][1].values())
    assert counts[0][:2] == (counts[0][2] * cfg.num_layers,
                             steps * (2 * cfg.num_layers + 1))
    assert counts[1][:2] == (0, 0)


# ---------------------------------------------------------------------------
# the Deployment: each step captured once per bucket as a CUDA graph
# ---------------------------------------------------------------------------
def twin_models(cuda, arch, dtype):
    """Two models on the card with the same weights (reduced config)."""
    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    twins = []
    for _ in range(2):
        m = Model(cfg, device=cuda, dtype=dtype)
        m.load_params(cpu.params.state_dict())
        twins.append(m)
    return twins


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(1, 256, shape).astype(np.int32)


BT = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
# each entry kind: (arch, paged cache, the model's step, its calls). The
# first three calls share a bucket; a fourth, where the step has another
# shape, opens a second one. Prefill steps return logits, so the logits of
# the mixed and decode steps are taken with sample=False.
ENTRY_KINDS = {
    "mixed": ("qwen3-8b", True, lambda m: (lambda *a: m.mixed_step(
        *a, sample=False)), [
        (_tokens((2, 8), 1), [8, 5], [0, 0], BT),
        (_tokens((2, 8), 2), [1, 1], [8, 5], BT),
        (_tokens((2, 8), 3), [3, 1], [9, 6], BT),
        (_tokens((2, 1), 4), [1, 1], [12, 7], BT[:, :2])]),
    "paged-prefill": ("qwen3-8b", True, lambda m: m.prefill_step, [
        (_tokens((2, 8), 1), [0, 0], BT), (_tokens((2, 8), 2), [8, 8], BT),
        (_tokens((2, 8), 3), [16, 16], BT),
        (_tokens((2, 4), 4), [24, 24], BT)]),
    "paged-decode": ("qwen3-8b", True, lambda m: (lambda *a: m.decode_step(
        *a, sample=False)), [
        (_tokens((2,), 1), [0, 3], BT), (_tokens((2,), 2), [1, 4], BT),
        (_tokens((2,), 3), [2, 5], BT), (_tokens((2,), 4), [3, 6], BT[:, :2])]),
    "dense-prefill": ("qwen3-8b", False, lambda m: m.prefill_step, [
        (_tokens((2, 8), 1), [0, 0], None), (_tokens((2, 8), 2), [8, 8], None),
        (_tokens((2, 8), 3), [16, 16], None),
        (_tokens((2, 4), 4), [24, 24], None)]),
    "dense-decode": ("qwen3-8b", False, lambda m: (lambda *a: m.decode_step(
        *a, sample=False)), [
        (_tokens((2,), 1), [0, 3], None), (_tokens((2,), 2), [1, 4], None),
        (_tokens((2,), 3), [2, 5], None)]),
    "mamba2-prefill": ("mamba2-1.3b", False, lambda m: m.prefill_step, [
        (_tokens((2, 8), 1), [0, 0], None), (_tokens((2, 8), 2), [8, 8], None),
        (_tokens((2, 8), 3), [16, 16], None),
        (_tokens((2, 16), 4), [24, 24], None)]),
    "mamba2-decode": ("mamba2-1.3b", False, lambda m: (
        lambda *a: m.decode_step(*a, sample=False)), [
        (_tokens((2,), 1), [0, 3], None), (_tokens((2,), 2), [1, 4], None),
        (_tokens((2,), 3), [2, 5], None)]),
}


def _cache_tensors(model, paged):
    if paged:
        return {"k": model.pool.k, "v": model.pool.v}
    c = model.cache
    return {n: getattr(c, n) for n in ("k", "v", "ssm", "conv_x", "conv_bc")
            if getattr(c, n) is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(ENTRY_KINDS))
def test_cuda_graphed_entry_matches_eager(cuda, dtype, kind):
    """A captured entry against the eager step on twin models, call by
    call: equal outputs and caches (the first call of a bucket runs the
    step once, eagerly, and its capture executes nothing: a prefill step
    on a fresh mamba2 cache leaves the SSD and conv state of one eager
    step), one capture per bucket, and the launch counters after the
    replays equal to the eager steps' counts."""
    arch, paged, step_of, calls = ENTRY_KINDS[kind]
    twins = twin_models(cuda, arch, dtype)
    for m in twins:
        if paged:
            m.init_paged_cache(17, 8)
        else:
            m.init_cache(2, 64)
    eager, graphed = twins
    entry = CapturedStep(step_of(graphed), graphed, paged, GraphPool())
    tol = TOL[dtype]
    counts = []
    for model in twins:
        ops.reset_launch_counts()
        outs = []
        for i, args in enumerate(calls):
            if model is eager:
                out = step_of(model)(*map(model._ints, args))
            else:
                out = entry(*args)
                assert entry.graphs.captures == (1 if i < 3 else 2)
                assert len(entry.buckets) == entry.graphs.captures
            torch.cuda.synchronize()
            outs.append((out.clone(), {n: t.clone() for n, t in
                                       _cache_tensors(model, paged).items()}))
        counts.append(ops.launch_counts())
        if model is eager:
            want = outs
    for (got, got_cache), (exp, exp_cache) in zip(outs, want):
        assert got.shape == exp.shape and torch.isfinite(got).all()
        torch.testing.assert_close(got, exp, atol=tol, rtol=tol)
        assert got_cache.keys() == exp_cache.keys()
        for n in got_cache:
            torch.testing.assert_close(got_cache[n].float(),
                                       exp_cache[n].float(), atol=tol,
                                       rtol=tol)
    assert counts[0] == counts[1]
    assert sum(counts[0].values()) > 0


@pytest.mark.cuda
def test_cuda_graphed_entry_refuses_a_replaced_cache(cuda):
    """The graphs hold the cache's addresses: after ``init_paged_cache``
    the entry raises instead of replaying into freed memory."""
    model = twin_models(cuda, "qwen3-8b", torch.float32)[0]
    model.init_paged_cache(17, 8)
    entry = CapturedStep(model.mixed_step, model, True, GraphPool())
    args = ENTRY_KINDS["mixed"][3][0]
    entry(*args)
    entry(*args)
    model.init_paged_cache(17, 8)
    with pytest.raises(RuntimeError, match="re-initialised"):
        entry(*args)


def _serve(eng, prompts, n_new):
    reqs = [Request(i, list(p), max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(len(r.generated) == n_new for r in reqs)
    return [r.generated for r in reqs]


A_PROMPT, B_PROMPT = list(range(3, 14)), list(range(40, 60))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,kw,prompts", [
    ("qwen3-8b", {"num_blocks": 9, "block_size": 8}, None),
    ("qwen3-8b", {"mixed": False}, None),
    ("qwen3-8b", {"paged": False, "mixed": False}, None),
    ("mamba2-1.3b", {"max_slots": 2, "s_max": 64, "prefill_chunk": 8},
     [A_PROMPT, B_PROMPT]),
    ("mamba2-1.3b", {"max_slots": 2, "s_max": 64, "prefill_chunk": 8},
     [list(range(1, 10 + 3 * i)) for i in range(5)])],
    ids=["mixed-tight-pool", "serialized-paged", "dense",
         "mamba2-two-in-flight", "mamba2-more-than-slots"])
def test_cuda_graphed_engine_matches_eager_engine(cuda, dtype, arch, kw,
                                                  prompts):
    """The engine's graphed tables against the eager ones on twin models:
    equal streams, config counts, preemptions and launch counts over two
    runs of the workload, and the second run of the graphed engine captures
    nothing (every bucket it steps through was captured in the first). The
    mamba2 cases are ``test_torch_ssd.py``'s two-in-flight and
    more-than-slots workloads: their streams depend on the dummy rows' SSD
    state, so a step run twice would show."""
    prompts = prompts or [list(range(1, 20 + 3 * i)) for i in range(6)]
    results = []
    for graphed, model in zip((False, True), twin_models(cuda, arch, dtype)):
        eng = ShiftEngine(model, EngineConfig(**kw))
        if not graphed:
            eng.deploy = Deployment.build(model, model, mixed=eng.mixed,
                                          paged=eng.paged, graphed=False)
        ops.reset_launch_counts()
        runs, captures = [], []
        for _ in range(2):
            runs.append(_serve(eng, prompts, 6))
            captures.append(eng.deploy.captures)
        results.append((runs, eng.config_counts, eng.preemptions,
                        ops.launch_counts()))
        if graphed:
            assert captures[0] > 0 and captures[1] == captures[0]
        else:
            assert captures == [0, 0]
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# the layouts: four ranks on the one card, collectives over gloo
# ---------------------------------------------------------------------------
def _layout_engine_rank(rank, groups, state, kw):
    """One rank of the SPMD engine on reduced qwen3-8b at fp32 on the card:
    base on (sp, tp) = (2, 2), shift on its ``to_shift()``, one pool."""
    from repro_torch.convert import shard_state
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-8b").reduced()
    lay = Layout(sp=2, tp=2)
    base, shift = (Model(cfg, device="cuda", dtype=torch.float32, lay=layout,
                         groups=groups) for layout in (lay, lay.to_shift()))
    for m in (base, shift):
        m.load_params(shard_state(state, cfg, m.lay, rank))
    eng = ShiftEngine(base, EngineConfig(**kw), shift=shift)
    ops.reset_launch_counts()
    reqs = workload(6, 8)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return ([r.generated for r in reqs], dict(eng.config_counts),
            eng.preemptions, eng.kv.num_free_blocks, ops.launch_counts())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"num_blocks": 9, "block_size": 8}],
                         ids=["no-pressure", "tight-pool"])
def test_cuda_layout_engine_matches_cpu_engine(cuda, kw):
    """The SPMD engine on four ranks sharing the card (gloo; NCCL refuses
    two ranks on one card): every rank's streams, config counts,
    preemptions and free blocks equal the one-rank engine's on the CPU with
    the same weights, and every rank launched 3 * layers + 1 RMSNorm and
    one ragged attention per layer per step."""
    from repro_torch.launch.mesh import run_ranks
    cfg = get_config("qwen3-8b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in cpu.params.state_dict().items()}
    eng = ShiftEngine(cpu, EngineConfig(**kw))
    reqs = workload(6, 8)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    want = ([r.generated for r in reqs], eng.config_counts, eng.preemptions,
            eng.kv.num_free_blocks)
    ranks = run_ranks(_layout_engine_rank, 2, 2, device="cuda",
                      backend="gloo", timeout_s=300, args=(state, kw))
    steps = sum(want[1].values())
    for streams, counts, preempt, free, launches in ranks:
        assert (streams, counts, preempt, free) == want
        assert launches["rmsnorm"] == steps * (3 * cfg.num_layers + 1)
        assert launches["paged_ragged_attention"] == steps * cfg.num_layers
    assert want[1]["base"] > 0 and want[1]["shift"] > 0
    with pytest.raises(RuntimeError, match="one card per rank"):
        run_ranks(_layout_engine_rank, 2, 2, device="cuda", backend="nccl",
                  timeout_s=60, args=(state, kw))
