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
    # GQA 8:1 with D 128 (qwen-32b's and llama-70b's group), mixed and decode
    (4, 8, 16, 2, 128, 16, 8, [40, 8, 100, 17], [8, 8, 1, 1], 0, 0.0),
    (3, 1, 16, 2, 128, 16, 16, [1, 130, 256], [1, 1, 1], 0, 0.0),
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(PARAMS, [c for c in CASES + RAGGED_TILE_CASES
                                  if not c[9]])
def test_cuda_ragged_padding_columns_match_plain(cuda, dtype, B, C, Hq, Hkv,
                                                 D, bs, nmax, ctx, ql, window,
                                                 cap):
    """``pad_cols=True`` (a MoE model's ragged attention): every column,
    padding columns included, within TOL of the plain version, which
    computes each padding column over its row's keys; rows with ctx == 0
    give zeros. The cases without a window (no MoE config has one)."""
    q, kp, vp, bt, qla, ctxa = paged_case(B, C, Hq, Hkv, D, bs, nmax, ctx, ql,
                                          seed=B + C + D + 1)
    g = Hq // Hkv
    args = [torch.from_numpy(q).transpose(1, 2).reshape(B, Hkv, g, C, D)
            .contiguous().to(cuda, dtype),
            torch.from_numpy(kp).to(cuda, dtype),
            torch.from_numpy(vp).to(cuda, dtype),
            *(torch.from_numpy(a).to(cuda) for a in (bt, qla, ctxa))]
    before = PRA.launches
    got = PRA.paged_ragged_attention_cuda(*args, soft_cap=cap, pad_cols=True)
    torch.cuda.synchronize()
    assert PRA.launches == before + 1
    want = PRA.paged_ragged_attention_plain(*args, soft_cap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    for b in range(B):
        if int(ctx[b]) == 0:
            assert not got[b].any()
        elif int(ql[b]) < C:
            assert got[b, :, :, int(ql[b]):].any()   # computed, not zeroed


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
    # qwen-32b's hidden rows (prefill, decode) and llama-70b's: fp32 past
    # 4096 elements takes 8 chunks a lane on 256 lanes
    (512, 5120), (8, 5120), (8, 8192), (3, 8192),
    # deepseek-v3-671b: d_model 7168, MLA's q latent 1536 and kv latent 512
    (512, 7168), (8, 7168), (512, 1536), (8, 1536), (512, 512), (8, 512),
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
@pytest.mark.parametrize("N,D", [(37, 4096), (200, 128), (9, 64),
                                 (9, 5120), (2, 8192)])
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
    ((8, 1, 64, 128), (8, 1, 8, 128)),       # qwen-32b, a decode step
    ((8, 64, 64, 128), (8, 64, 8, 128)),     # qwen-32b, a prefill step
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
    # whisper-small at D 64, group 1 (12 over 12 heads), non-causal: the
    # encoder over its 1536 frames, the cross prefill of a 64-token chunk
    # against them, and the decoder's causal chunk against its cache
    (2, 1536, 1536, 12, 12, 64, False, None),
    (8, 64, 1536, 12, 12, 64, False, None),
    (8, 64, 256, 12, 12, 64, True, [0, 16, 64, 192, 0, 3, 100, 150]),
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
    # whisper-small's decode at group 1, D 64: the cross attention over all
    # 1536 frames of every row, and the self-attention over s_max 256
    (8, 1536, 12, 12, 64, [1536] * 8, "both"),
    (8, 256, 12, 12, 64, [1, 20, 34, 50, 256, 7, 128, 129], "both"),
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


def _moe_pair(cuda, name, cap=1.25):
    import dataclasses
    cfg = get_config(name).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cap))
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda, dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    return cfg, cpu, gpu


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen-30b-a3b", "llama4-17b-16e"])
def test_cuda_moe_apply_matches_cpu(cuda, name):
    """Reduced MoE layers at fp32, cf 1.25: the same routing, kept mask and
    slots on the card as on the CPU, outputs within 1e-5."""
    from repro_torch.models import moe as MOE
    cfg, cpu, gpu = _moe_pair(cuda, name)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    for layer in range(cfg.num_layers):
        a, b = cpu.params.layers[layer].ffn, gpu.params.layers[layer].ffn
        want = MOE.route(a, x.reshape(-1, cfg.d_model))
        got = MOE.route(b, x.reshape(-1, cfg.d_model).to(cuda))
        for i in (2, 4, 5):                        # sel, slot, keep
            assert torch.equal(got[i].cpu(), want[i])
        torch.testing.assert_close(MOE.moe_apply(b, x.to(cuda))[0].cpu(),
                                   MOE.moe_apply(a, x)[0], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen-30b-a3b", "llama4-17b-16e"])
@pytest.mark.parametrize("kw", [{}, {"mixed": False},
                                {"paged": False, "mixed": False}],
                         ids=["mixed", "serialized", "dense"])
def test_cuda_moe_engine_matches_cpu_engine(cuda, name, kw):
    """Reduced MoE models at fp32, cf 1.25, on the pad-sensitive workload
    (10 random prompts, chunk 16, 10 new tokens): equal streams on the card
    and the CPU on every path, the card's mixed run through the ragged
    kernel with its padding columns computed."""
    import random
    cfg, cpu, gpu = _moe_pair(cuda, name)
    rnd = random.Random(0)
    prompts = [[rnd.randrange(1, 250) for _ in range(rnd.randrange(2, 40))]
               for _ in range(10)]
    runs = []
    for model in (gpu, cpu):
        PRA.launches = 0
        eng = ShiftEngine(model, EngineConfig(max_slots=8, s_max=128,
                                              prefill_chunk=16, **kw))
        reqs = [Request(i, p, max_new_tokens=10)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        runs.append(([r.generated for r in reqs], eng.config_counts,
                     PRA.launches))
    assert runs[0][:2] == runs[1][:2]
    steps = sum(runs[0][1].values())
    assert runs[0][2] == (steps * cfg.num_layers if kw.get("paged", True)
                          else 0)


@pytest.mark.cuda
def test_cuda_adaptive_engine_matches_cpu_engine(cuda):
    """Reduced qwen3-8b at fp32 under ``--adaptive``'s policy (the cost
    model over (2, 2)): the card and the CPU give equal streams, per-step
    configs (both used) and preemptions, mixed and under pool pressure."""
    from repro_torch.launch.serve import adaptive_policy
    cfg = get_config("qwen3-8b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda, dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    for kw in ({}, {"num_blocks": 9, "block_size": 8}):
        runs = []
        for model in (gpu, cpu):
            eng = ShiftEngine(model, EngineConfig(**kw),
                              policy=adaptive_policy(cfg))
            reqs = workload(6, 8)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            runs.append(([r.generated for r in reqs],
                         [r["config"] for r in eng.step_log],
                         eng.config_counts, eng.preemptions))
        assert runs[0] == runs[1]
        assert runs[0][2]["base"] > 0 and runs[0][2]["shift"] > 0


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


@pytest.mark.cuda
def test_cuda_recurrentgemma_engine_matches_cpu_engine(cuda):
    """Reduced recurrentgemma-9b at fp32 on the dense serialized engine
    (the automatic fallback), with more requests than slots and a window
    of 8 under an s_max of 64, so that the local layer's ring wraps:
    equal streams and config counts on the card and the CPU, and the
    card's run went through RMSNorm, 2 * layers + 1 launches per step (ln1
    and ln2 of each layer, and the final norm); the ring attention and the
    RG-LRU scan are plain PyTorch."""
    cfg = get_config("recurrentgemma-9b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda, dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    runs, counts = [], []
    for model in (gpu, cpu):
        ops.reset_launch_counts()
        eng = ShiftEngine(model, EngineConfig(max_slots=2, s_max=64,
                                              prefill_chunk=8))
        assert not eng.paged and not eng.mixed
        reqs = workload(5, 12)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        runs.append(([r.generated for r in reqs], eng.config_counts))
        counts.append(ops.launch_counts())
    assert runs[0] == runs[1]
    steps = sum(runs[0][1].values())
    assert counts[0]["rmsnorm"] == steps * (2 * cfg.num_layers + 1)
    assert sum(counts[0].values()) == counts[0]["rmsnorm"]
    assert not any(counts[1].values())


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
    # the local layer's ring of 8 rows wraps from the second call on
    "recurrentgemma-prefill": ("recurrentgemma-9b", False,
                               lambda m: m.prefill_step, [
        (_tokens((2, 8), 1), [0, 0], None), (_tokens((2, 8), 2), [8, 8], None),
        (_tokens((2, 8), 3), [16, 16], None),
        (_tokens((2, 16), 4), [24, 24], None)]),
    "recurrentgemma-decode": ("recurrentgemma-9b", False, lambda m: (
        lambda *a: m.decode_step(*a, sample=False)), [
        (_tokens((2,), 1), [0, 13], None), (_tokens((2,), 2), [1, 14], None),
        (_tokens((2,), 3), [2, 15], None)]),
}


# whisper's prefill takes the encoder's frames, internvl2's steps the image
# embeddings: float tensors on the card, another draw each call, which a
# captured entry copies into its bucket's static buffers
def _frames(cuda, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(cuda)


def _frontend_kinds(cuda):
    """The entry kinds of whisper-small (reduced: 16 frames of d 64) and
    internvl2-2b (8 image embeddings), as ``ENTRY_KINDS``."""
    return {
        "whisper-prefill": ("whisper-small", False, lambda m: m.prefill_step, [
            (_tokens((2, 8), 1), [0, 0], None, None,
             _frames(cuda, (2, 16, 64), 1)),
            (_tokens((2, 8), 2), [8, 8], None, None,
             _frames(cuda, (2, 16, 64), 2)),
            (_tokens((2, 8), 3), [16, 16], None, None,
             _frames(cuda, (2, 16, 64), 3)),
            (_tokens((2, 16), 4), [24, 24], None, None,
             _frames(cuda, (2, 16, 64), 4))]),
        "whisper-decode": ("whisper-small", False, lambda m: (
            lambda *a: m.decode_step(*a, sample=False)), [
            (_tokens((2,), 1), [0, 3], None), (_tokens((2,), 2), [1, 4], None),
            (_tokens((2,), 3), [2, 5], None)]),
        "internvl2-mixed": ("internvl2-2b", True, lambda m: (
            lambda *a: m.mixed_step(*a, sample=False)), [
            (_tokens((2, 8), 1), [8, 5], [0, 0], BT,
             _frames(cuda, (2, 8, 64), 1)),
            (_tokens((2, 8), 2), [1, 1], [8, 5], BT,
             _frames(cuda, (2, 8, 64), 2)),
            (_tokens((2, 8), 3), [3, 1], [9, 6], BT,
             _frames(cuda, (2, 8, 64), 3)),
            (_tokens((2, 1), 4), [1, 1], [12, 7], BT[:, :2],
             _frames(cuda, (2, 8, 64), 4))]),
    }


def _eager_inputs(model, args):
    """An eager step's inputs: the host ints as int32, the frontend tensors
    in the model's type, on its device."""
    return [model._floats(a) if isinstance(a, torch.Tensor)
            and a.is_floating_point() else model._ints(a) for a in args]


def _cache_tensors(model, paged):
    if paged:
        return {"k": model.pool.k, "v": model.pool.v}
    return model.cache.tensors()


FRONTEND_KINDS = ("whisper-prefill", "whisper-decode", "internvl2-mixed")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(ENTRY_KINDS) + list(FRONTEND_KINDS))
def test_cuda_graphed_entry_matches_eager(cuda, dtype, kind):
    """A captured entry against the eager step on twin models, call by
    call: equal outputs and caches (the first call of a bucket runs the
    step once, eagerly, and its capture executes nothing: a prefill step
    on a fresh mamba2 cache leaves the SSD and conv state of one eager
    step), one capture per bucket, and the launch counters after the
    replays equal to the eager steps' counts. Whisper's prefill entry holds
    the whole encoder and rewrites the cross cache from each call's
    frames; internvl2's mixed entry reads each call's image embeddings."""
    kinds = dict(ENTRY_KINDS, **_frontend_kinds(cuda))
    arch, paged, step_of, calls = kinds[kind]
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
                out = step_of(model)(*_eager_inputs(model, args))
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
def test_cuda_whisper_engine_matches_cpu_engine(cuda):
    """Reduced whisper-small at fp32 on the dense serialized engine (the
    automatic fallback), more requests than slots: equal streams, config
    counts and preemptions on the card and the CPU, and the card's run went
    through its kernels: per prefill step one flash launch per encoder
    layer and two per decoder layer (its causal self-attention and the
    cross attention), per decode step two decode launches per decoder layer
    (self and cross), and no RMSNorm (LayerNorm is plain PyTorch)."""
    cfg = get_config("whisper-small").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda, dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    runs, counts = [], []
    for model in (gpu, cpu):
        ops.reset_launch_counts()
        eng = ShiftEngine(model, EngineConfig(max_slots=4, s_max=64,
                                              prefill_chunk=8))
        assert not eng.paged and not eng.mixed
        reqs = workload(6, 8)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        log = eng.step_log
        runs.append(([r.generated for r in reqs], eng.config_counts,
                     eng.preemptions))
        counts.append((ops.launch_counts(),
                       sum(rec["prefill_tokens"] > 0 for rec in log),
                       sum(rec["decode_tokens"] > 0 for rec in log)))
    assert runs[0] == runs[1]
    got, n_pre, n_dec = counts[0]
    L, E = cfg.num_layers, cfg.encoder_layers
    assert n_pre > 0 and n_dec > 0
    assert got["flash_attention"] == n_pre * (E + 2 * L)
    assert got["decode_attention"] == n_dec * 2 * L
    assert sum(got.values()) == got["flash_attention"] \
        + got["decode_attention"]
    assert not any(counts[1][0].values())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"mixed": False},
                                {"paged": False, "mixed": False}],
                         ids=["mixed", "serialized", "dense"])
def test_cuda_internvl2_engine_matches_cpu_engine(cuda, kw):
    """Reduced internvl2-2b at fp32 with the serve workload under its 8
    image embeddings (the engine's zeros): on each path, equal streams,
    config counts and preemptions on the card and the CPU; the card's run
    went through the ragged kernel on the paged pool (flash and decode on
    the dense cache), one launch per layer per step, and 2 * layers + 1
    RMSNorm launches per step."""
    cfg = get_config("internvl2-2b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda, dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    runs, counts = [], []
    for model in (gpu, cpu):
        ops.reset_launch_counts()
        eng = ShiftEngine(model, EngineConfig(**kw))
        reqs = workload(6, 8)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        runs.append(([r.generated for r in reqs], eng.config_counts,
                     eng.preemptions))
        counts.append(ops.launch_counts())
    assert runs[0] == runs[1]
    steps = sum(runs[0][1].values())
    got, L = counts[0], cfg.num_layers
    assert got["rmsnorm"] == steps * (2 * L + 1)
    attn = ("paged_ragged_attention",) if kw.get("paged", True) else (
        "flash_attention", "decode_attention")
    assert sum(got[k] for k in attn) == steps * L
    assert sum(got.values()) == got["rmsnorm"] + steps * L
    assert not any(counts[1].values())


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
# the pad-sensitive MoE workload (``tests/test_torch_moe.py``): chunk 16
MOE_KW = {"max_slots": 8, "s_max": 128, "prefill_chunk": 16}


def _pad_prompts(seed=0):
    import random
    rnd = random.Random(seed)
    return [[rnd.randrange(1, 250) for _ in range(rnd.randrange(2, 40))]
            for _ in range(10)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,kw,prompts", [
    ("qwen3-8b", {"num_blocks": 9, "block_size": 8}, None),
    ("qwen3-8b", {"mixed": False}, None),
    ("qwen3-8b", {"paged": False, "mixed": False}, None),
    ("mamba2-1.3b", {"max_slots": 2, "s_max": 64, "prefill_chunk": 8},
     [A_PROMPT, B_PROMPT]),
    ("mamba2-1.3b", {"max_slots": 2, "s_max": 64, "prefill_chunk": 8},
     [list(range(1, 10 + 3 * i)) for i in range(5)]),
    ("qwen-30b-a3b", MOE_KW, _pad_prompts()),
    ("llama4-17b-16e", MOE_KW, _pad_prompts()),
    ("recurrentgemma-9b", {"max_slots": 2, "s_max": 64, "prefill_chunk": 8},
     [list(range(1, 10 + 3 * i)) for i in range(5)])],
    ids=["mixed-tight-pool", "serialized-paged", "dense",
         "mamba2-two-in-flight", "mamba2-more-than-slots",
         "moe-qwen-30b-a3b-pad", "moe-llama4-17b-16e-pad",
         "recurrentgemma-more-than-slots"])
def test_cuda_graphed_engine_matches_eager_engine(cuda, dtype, arch, kw,
                                                  prompts):
    """The engine's graphed tables against the eager ones on twin models:
    equal streams, config counts, preemptions and launch counts over two
    runs of the workload, and the second run of the graphed engine captures
    nothing (every bucket it steps through was captured in the first). The
    mamba2 cases are ``test_torch_ssd.py``'s two-in-flight and
    more-than-slots workloads: their streams depend on the dummy rows' SSD
    state, so a step run twice would show. The MoE cases route every
    column of a step (capacity 1.25): a replayed dispatch that kept stale
    slots would show."""
    prompts = prompts or [list(range(1, 20 + 3 * i)) for i in range(6)]
    results = []
    for graphed, model in zip((False, True), twin_models(cuda, arch, dtype)):
        eng = ShiftEngine(model, EngineConfig(**kw))
        if not graphed:
            eng.deploy = Deployment.build(eng.base, eng.shift,
                                          mixed=eng.mixed, paged=eng.paged,
                                          graphed=False)
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
# the prefix cache, copy-on-write and the speculative verify
# ---------------------------------------------------------------------------
# verify-sized rows in one bucket (C 8): prefill chunks, then rows of 1 to
# 5 columns at a decode row's offset
VERIFY_CALLS = [(_tokens((2, 8), 1), [8, 5], [0, 0], BT),
                (_tokens((2, 8), 2), [3, 1], [8, 5], BT),
                (_tokens((2, 8), 3), [5, 2], [11, 6], BT)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_last", [2, 4, 8])
def test_cuda_graphed_verify_entry_matches_eager(cuda, dtype, n_last):
    """A verify step of width ``n_last`` captured once and replayed,
    against the eager ``mixed_step(n_last=...)`` on a twin model: logits
    [B, n_last, V] and pools bitwise equal, call by call; and the
    deployment's lazily built entry of that width gives the logits'
    argmax."""
    import functools
    twins = twin_models(cuda, "qwen3-8b", dtype)
    for m in twins:
        m.init_paged_cache(17, 8)
    eager, graphed = twins
    entry = CapturedStep(functools.partial(graphed.mixed_step, sample=False,
                                           n_last=n_last),
                         graphed, True, GraphPool())
    for args in VERIFY_CALLS:
        want = eager.mixed_step(*map(eager._ints, args), sample=False,
                                n_last=n_last)
        got = entry(*args)
        torch.cuda.synchronize()
        assert entry.graphs.captures == 1
        assert got.shape == want.shape == (2, n_last, eager.cfg.vocab_size)
        assert torch.equal(got, want)
        for a, b in ((eager.pool.k, graphed.pool.k),
                     (eager.pool.v, graphed.pool.v)):
            assert torch.equal(a, b)
    for m in twins:
        m.init_paged_cache(17, 8)
    d = Deployment.build(graphed, graphed, mixed=True, paged=True)
    tok_entry = d.forward_at("shift", n_last)
    assert d.forward_at("base", n_last) is tok_entry
    for args in VERIFY_CALLS:
        want = eager.mixed_step(*map(eager._ints, args), sample=False,
                                n_last=n_last)
        assert torch.equal(tok_entry(*args), want.argmax(-1))
    assert d.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_copy_blocks_matches_cpu(cuda, dtype):
    """The COW copy in place on the card equals the CPU's bitwise, with a
    pair whose destination is another pair's source."""
    cfg = get_config("qwen3-8b").reduced()
    pools = []
    for dev in ("cpu", cuda):
        m = Model(cfg, device=dev, dtype=dtype)
        pool = m.init_paged_cache(8, 8)
        g = torch.Generator().manual_seed(3)
        for t in (pool.k, pool.v):
            t.copy_(torch.randn(t.shape, generator=g).to(dtype))
        before = pool.k.cpu()
        addr = (pool.k.data_ptr(), pool.v.data_ptr())
        m.copy_blocks([3, 5, 1], [5, 6, 2])
        assert (pool.k.data_ptr(), pool.v.data_ptr()) == addr
        pools.append((pool.k.cpu(), pool.v.cpu()))
    for a, b in zip(*pools):
        assert torch.equal(a, b)
    # block 6 got block 5's bytes from before block 5 was overwritten
    assert torch.equal(pools[1][0][:, 6], before[:, 5])
    assert torch.equal(pools[1][0][:, 5], before[:, 3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefix_spec_engine_graphed_matches_eager(cuda, dtype):
    """The engine with the prefix cache and k=4 on the serve workload after
    a 16-token shared prefix: the graphed tables (every verify width
    captured per bucket) against the eager ones on twin models, over two
    runs: equal streams, cached tokens, prefix stats, spec counts, config
    counts and launch counts."""
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.spec import SpecConfig
    results = []
    for graphed, model in zip((False, True),
                              twin_models(cuda, "qwen3-8b", dtype)):
        eng = ShiftEngine(model, EngineConfig(
            prefix=PrefixConfig(enabled=True), spec=SpecConfig(k=4)))
        if not graphed:
            eng.deploy = Deployment.build(eng.base, eng.shift, mixed=True,
                                          paged=True, graphed=False)
        ops.reset_launch_counts()
        runs = []
        for _ in range(2):
            reqs = workload(6, 8, shared_prefix=16)
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            runs.append(([r.generated for r in reqs],
                         [r.cached_tokens for r in reqs]))
        results.append((runs, eng.prefix_stats.as_dict(),
                        (eng.obs.registry.counter_total("spec_proposed_total"),
                         eng.obs.registry.counter_total("spec_accepted_total")),
                        eng.config_counts, ops.launch_counts()))
        assert (eng.deploy.captures > 0) == graphed
        if graphed:
            assert any(n > 1 for _, n in eng.deploy.spec_forward)
    assert results[0] == results[1]
    assert results[0][1]["hits"] > 0 and results[0][2][0] > 0


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


# ---------------------------------------------------------------------------
# data parallelism: two rows, two ranks on the one card over gloo
# ---------------------------------------------------------------------------
def _dp_engine_rank(rank, groups, device, state, kw):
    """One rank of the dp=2 engine on reduced qwen3-8b at fp32 with the
    weights ``state``: its own row's pool, the serve workload with the
    prefix cache."""
    from repro_torch.engine.api import PrefixConfig
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(get_config("qwen3-8b").reduced(), device=device,
                  dtype=torch.float32, lay=Layout(dp=2), groups=groups)
    model.load_params(state)
    eng = ShiftEngine(model, EngineConfig(prefix=PrefixConfig(enabled=True),
                                          **kw))
    ops.reset_launch_counts()
    reqs = workload(6, 8, shared_prefix=16)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return ([r.generated for r in reqs], [r.row for r in reqs],
            dict(eng.config_counts), eng.prefix_stats.as_dict(),
            eng.block_accounting().as_dict(), ops.launch_counts())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"mixed": False}],
                         ids=["mixed", "serialized"])
def test_cuda_dp_engine_matches_cpu_engine(cuda, kw):
    """The dp=2 engine with two ranks sharing the card (gloo) against the
    same engine's two ranks on the CPU: equal streams, rows, config counts,
    prefix stats and block ledgers on every rank, both rows used, and each
    card rank launched 3 * layers + 1 RMSNorm and one ragged attention per
    layer per step."""
    from repro_torch.launch.mesh import run_ranks
    cfg = get_config("qwen3-8b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in cpu.params.state_dict().items()}
    got = run_ranks(_dp_engine_rank, 1, 1, dp=2, device="cuda",
                    backend="gloo", timeout_s=300, args=("cuda", state, kw))
    want = run_ranks(_dp_engine_rank, 1, 1, dp=2, device="cpu",
                     backend="gloo", timeout_s=300, args=("cpu", state, kw))
    for g, w in zip(got, want):
        assert g[:5] == w[:5] == want[0][:5]
    streams, rows, counts, _, ledger, launches = got[0]
    assert set(rows) == {0, 1} and all(len(s) == 8 for s in streams)
    assert ledger["used"] == ledger["pinned"]
    steps = sum(counts.values())
    for g in got:
        assert g[5]["rmsnorm"] == steps * (3 * cfg.num_layers + 1)
        assert g[5]["paged_ragged_attention"] == steps * cfg.num_layers


# ---------------------------------------------------------------------------
# fault injection, snapshots and crash recovery on the card
# ---------------------------------------------------------------------------
# an alloc fault, both kinds of forward fault and a route fault
FT_PLAN = [(0, "alloc", ""), (3, "forward", "nan"), (8, "forward", "raise"),
           (5, "route", "")]


def _plan(extra=()):
    from repro_torch.ft import Fault, FaultPlan
    return FaultPlan([Fault(s, seam, kind=k) for s, seam, k in
                      FT_PLAN + list(extra)])


def _ft_engine(model, plan, **fault_kw):
    from repro_torch.engine import FaultConfig
    return ShiftEngine(model, EngineConfig(
        num_blocks=17, block_size=8,
        fault=FaultConfig(quarantine_after=10, **fault_kw)), faults=plan)


def _crash_drill(model, crash_step=7):
    """Serve the workload under ``FT_PLAN`` with snapshots every 3 steps,
    drop the engine after ``crash_step`` steps, recover a fresh one from
    the ring and drive it to idle under a ``DeliveryLog``. Returns the
    streams and the delivered tokens."""
    from repro_torch.ft import DeliveryLog
    eng = _ft_engine(model, _plan(), auto_snapshot_every=3)
    log = DeliveryLog()
    reqs = workload(6, 8)
    for r in reqs:
        eng.submit(r)
    for _ in range(crash_step):
        eng.step()
        log.poll(reqs)
    ring = eng.retained_snapshots()
    del eng
    eng = _ft_engine(model, _plan(), auto_snapshot_every=3)
    eng.recover(ring)
    live = list(eng.queue)
    while eng.queue or eng.active:
        eng.step()
        log.poll(live)                 # raises ReplayDivergence
    assert all(eng.request(r.rid).finish_reason == "ok" for r in reqs)
    led = eng.block_accounting()
    assert led.used == led.pinned == 0
    return ([eng.stream(r.rid) for r in reqs],
            [log.delivered(r.rid) for r in reqs])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_crash_drill_matches_uninterrupted(cuda, dtype):
    """The graphed mixed paged engine under a fixed plan: a crash after
    step 7 and a recovery from the ring give the uninterrupted faulted
    run's streams bitwise (restored state replays the same steps at the
    same shapes); in fp32 they also equal the clean run's and the CPU's
    drill."""
    model = twin_models(cuda, "qwen3-8b", dtype)[0]
    eng = _ft_engine(model, _plan())
    reqs = workload(6, 8)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert eng.obs.registry.counter_total("failed_steps_total") == 2
    whole = [r.generated for r in reqs]
    del eng
    streams, delivered = _crash_drill(model)
    assert streams == delivered == whole
    if dtype == torch.float32:
        clean = ShiftEngine(model, EngineConfig(num_blocks=17, block_size=8))
        assert _serve(clean, [r.prompt for r in workload(6, 8)], 8) == whole
        cfg = get_config("qwen3-8b").reduced()
        cpu = Model(cfg, device="cpu", dtype=torch.float32)
        cpu.init_params(torch.Generator().manual_seed(0))
        assert _crash_drill(cpu)[0] == whole


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_restore_in_place_replays_graphs(cuda, dtype):
    """A graphed engine restores its own snapshot of step 4 in place: no
    graph is captured by the restore or the rest of the run, the pool
    tensors are the same objects, and the rest of the run equals the run
    without the restore, bitwise. A snapshot corrupted by the plan's
    ``snapshot`` fault is refused and leaves the engine as it was."""
    from repro_torch.ft import SnapshotError
    model = twin_models(cuda, "qwen3-8b", dtype)[0]
    eng = _ft_engine(model, _plan())
    reqs = workload(6, 8)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    eng.run_until_idle()
    whole = [eng.stream(r.rid) for r in reqs]
    pool = (eng.model.pool.k, eng.model.pool.v)
    captures = eng.deploy.captures
    assert captures > 0
    eng.restore(snap)
    assert eng.step_count == 4 and eng.deploy.captures == captures
    eng.run_until_idle()
    assert [eng.stream(r.rid) for r in reqs] == whole
    assert eng.deploy.captures == captures
    assert eng.model.pool.k is pool[0] and eng.model.pool.v is pool[1]
    # a snapshot fault at step 4 corrupts a capture taken there
    eng.restore(snap)
    eng.faults = _plan([(4, "snapshot", "")])
    bad = eng.snapshot()
    assert bad.get("corrupted")
    before = (eng.step_count, eng.lens.tolist(), eng.model.pool.k.clone())
    with pytest.raises(SnapshotError):
        eng.restore(bad)
    assert (eng.step_count, eng.lens.tolist()) == before[:2]
    assert torch.equal(eng.model.pool.k, before[2])
    eng.run_until_idle()
    assert [eng.stream(r.rid) for r in reqs] == whole


# ---------------------------------------------------------------------------
# cluster replicas on one model, live migration
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_two_graphed_replicas_on_one_model(cuda, dtype):
    """Two graphed engines on ONE model, stepped in turns: each captures
    its own graphs over its own pool (the weights are the model's) and
    replays them, interleaved, with the streams of a lone graphed engine
    on a twin model per workload, over two runs (the second captures
    nothing)."""
    model, twin = twin_models(cuda, "qwen3-8b", dtype)
    prompts = [[list(range(1, 20 + 3 * i)) for i in range(3)],
               [list(range(40, 50 + 2 * i)) for i in range(3)]]
    want = [_serve(ShiftEngine(twin, EngineConfig()), p, 8) for p in prompts]
    engs = [ShiftEngine(model, EngineConfig()) for _ in range(2)]
    assert engs[0].base.pool is not engs[1].base.pool
    assert engs[0].base.params is engs[1].base.params is model.params
    for run in range(2):
        captures = [e.deploy.captures for e in engs]
        reqs = [[Request(i, list(p), max_new_tokens=8)
                 for i, p in enumerate(ps)] for ps in prompts]
        for e, rs in zip(engs, reqs):
            for r in rs:
                e.submit(r)
        while any(e.queue for e in engs):
            for e in engs:
                e.step()
        assert [[r.generated for r in rs] for rs in reqs] == want
        if run:
            assert [e.deploy.captures for e in engs] == captures
    assert all(e.deploy.captures > 0 for e in engs)
    assert engs[0].deploy.graphs is not engs[1].deploy.graphs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_migration_writes_in_place_and_replays(cuda, dtype):
    """A request migrated mid-decode between two graphed replicas of one
    model: the payload is a copy on the card, ``write_blocks`` writes the
    destination's pool in place (its tensors and addresses unchanged, the
    blocks equal the source's), the destination's graphs replay after it
    with no new capture once warm, and the stream equals an unmigrated
    engine's bitwise (bf16 too: the destination steps the same one-row
    bucket)."""
    from repro_torch.cluster import Router
    model = twin_models(cuda, "qwen3-8b", dtype)[0]
    prompt = list(range(1, 40))
    bare = ShiftEngine(model, EngineConfig())
    want = _serve(bare, [prompt], 12)[0]
    router = Router([ShiftEngine(model, EngineConfig()) for _ in range(2)],
                    routing="least-loaded", rebalance_every=0)
    for eng in router.engines:               # warm every bucket of a lone row
        _serve(eng, [prompt], 12)
    captures = [e.deploy.captures for e in router.engines]
    # a rid neither replica served (an engine keeps every rid it served,
    # and a migration to one that knows the rid aborts)
    rid = 100
    router.submit(Request(rid, prompt, max_new_tokens=12))
    while len(router.stream(rid)) < 4:
        router.step()
        router.poll()
    src = router.owner(rid)
    dst = router.engines[1 - src]
    export = router.engines[src].extract_request(rid)
    assert export["payload"]["k"].device.type == "cuda"
    pool = (dst.model.pool.k, dst.model.pool.v)
    addr = [t.data_ptr() for t in pool]
    ops = router.migrate(rid, 1 - src)
    assert ops is not None and router.owner(rid) == 1 - src
    dst_ids = [o.dst_block for o in ops[1:]]
    assert dst.model.pool.k is pool[0] and dst.model.pool.v is pool[1]
    assert [t.data_ptr() for t in pool] == addr
    for t, name in ((pool[0], "k"), (pool[1], "v")):
        assert torch.equal(t[:, dst_ids], export["payload"][name])
    router.run_until_idle()
    assert router.delivered(rid) == want
    assert [e.deploy.captures for e in router.engines] == captures
    led = dst.block_accounting()
    assert led.used == led.pinned == 0


# ---------------------------------------------------------------------------
# one rank of the (sp, tp) = (2, 2) grid: the kernels at its shapes
# ---------------------------------------------------------------------------
PER_RANK_CASES = [
    # kind, shape: flash over the whole 64-column chunk after the exchange
    # at 8 q and 2 kv heads against dense caches of 256 and 2048 (rows at
    # offsets up to the dummy offset s_max - C); the dense decode over the
    # dp row's 8 rows; the SSD chunk at 16 and 8 heads (mamba2-1.3b on G 4
    # and G 8, b and c shared); its grouped norm at 16 and 8 heads of 64
    ("flash", (8, 64, 256, [0, 32, 64, 96, 128, 160, 192, 192])),
    ("flash", (8, 64, 2048, [0, 256, 576, 832, 1088, 1344, 1664, 1984])),
    ("decode", (8, 2048)),
    ("ssd", 16),
    ("ssd", 8),
    ("grouped", (512, 16)),
    ("grouped", (512, 8)),
    ("grouped", (8, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", PER_RANK_CASES)
def test_cuda_per_rank_kernels_match_plain(cuda, dtype, kind, shape):
    """The kernels that the serialized steps and the SSD mixer launch on a
    rank of the (2, 2) grid, at its shapes, against their plain versions
    (1e-4 in fp32, 2e-2 in bf16; the SSD chunk's fp32 outputs 1e-4)."""
    tol = TOL[dtype]
    if kind == "flash":
        B, C, S, offs = shape
        q, k, v = (torch.from_numpy(a).to(cuda, dtype)
                   for a in dense_case(B, C, S, 8, 2, 128, seed=S))
        qo = torch.tensor(offs, dtype=torch.int32, device=cuda)
        got = FA.flash_attention_cuda(q, k, v, qo, causal=True)
        want = FA.flash_attention_plain(q, k, v, qo, causal=True)
    elif kind == "decode":
        B, S = shape
        q, k, v = (torch.from_numpy(a).to(cuda, dtype)
                   for a in dense_case(B, 1, S, 8, 2, 128, seed=S))
        q = q.reshape(B, 2, 4, 128)
        lens = torch.tensor([2048, 1536, 1024, 777, 512, 256, 100, 1],
                            dtype=torch.int32, device=cuda)
        got = DA.decode_attention_cuda(q, k, v, lens)
        want = DA.decode_attention_plain(q, k, v, lens)
    elif kind == "ssd":
        args = ssd_case(8, 64, shape, 64, 128, 64, True, dtype, cuda)
        for g, w in zip(SSD.ssd_chunk_cuda(*args, 64),
                        SSD.ssd_chunk_plain(*args, 64)):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        return
    else:
        rows, H = shape
        g = torch.Generator(device=cuda).manual_seed(rows + H)
        x = torch.randn((rows, H, 64), generator=g, device=cuda).to(dtype)
        s = torch.randn((H, 64), generator=g, device=cuda).to(dtype)
        got, want = RMS.rmsnorm_cuda(x, s), RMS.rmsnorm_plain(x, s)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _layout_serialized_rank(rank, groups, device, arch, kw):
    """One rank of a (2, 2) engine over the reduced ``arch`` (fp32, the
    CPU generator's weights on either device), serving the workload: its
    streams, configs and kernel launches."""
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, lay = get_config(arch).reduced(), Layout(sp=2, tp=2)
    base, shift = (Model(cfg, device=device, dtype=torch.float32, lay=la,
                         groups=groups) for la in (lay, lay.to_shift()))
    for m in (base, shift):
        drawn = Model(cfg, device="cpu", dtype=torch.float32, lay=m.lay,
                      groups=groups)
        drawn.init_params(torch.Generator().manual_seed(0))
        m.load_params(drawn.params.state_dict())
    ops.reset_launch_counts()
    eng = ShiftEngine(base, EngineConfig(threshold=16, **kw), shift=shift)
    reqs = workload(6, 8)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"streams": [r.generated for r in reqs],
            "counts": dict(eng.config_counts),
            "launches": ops.launch_counts()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("qwen3-8b", {"mixed": False}),
    ("qwen3-8b", {"paged": False, "mixed": False}),
    ("mamba2-1.3b", {})], ids=["serialized-paged", "dense", "mamba2-dense"])
def test_cuda_layout_serialized_engine_matches_cpu(cuda, arch, kw):
    """The serialized engines on the (2, 2) grid, four ranks on the one
    card over gloo, against the same four ranks on the CPU: equal streams
    and configs on every rank, both configs used, and the card's ranks
    went through the kernels (the CPU's through none)."""
    from repro_torch.launch import mesh
    card, cpu = (mesh.run_ranks(_layout_serialized_rank, 2, 2, device=dev,
                                backend="gloo", timeout_s=300,
                                args=(dev, arch, kw))
                 for dev in ("cuda", "cpu"))
    for a, b in zip(card, cpu):
        assert a["streams"] == b["streams"] == cpu[0]["streams"]
        assert a["counts"] == b["counts"]
        assert not any(b["launches"].values())
        assert a["launches"]["rmsnorm"] > 0
    assert cpu[0]["counts"]["base"] > 0 and cpu[0]["counts"]["shift"] > 0
    attention = ("paged_ragged_attention" if kw.get("paged", True)
                 and arch != "mamba2-1.3b" else None)
    if attention:
        assert card[0]["launches"][attention] > 0
    elif arch == "mamba2-1.3b":
        assert card[0]["launches"]["ssd_chunk"] > 0
    else:
        assert card[0]["launches"]["flash_attention"] > 0
        assert card[0]["launches"]["decode_attention"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [512, 8, 3])
def test_cuda_mla_kv_latent_norm_matches_plain(cuda, dtype, rows):
    """MLA's kv latent norm reads the first 512 of each latent row of 576
    (a strided view, as ``models.mla._latent`` hands it over)."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    lat = torch.randn((2, rows, 576), generator=g, device=cuda).to(dtype)
    s = torch.randn((512,), generator=g, device=cuda).to(dtype)
    x = lat[..., :512]
    assert not x.is_contiguous()
    got = RMS.rmsnorm_cuda(x, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), RMS.rmsnorm_plain(x, s).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _pod_engine_rank(rank, groups, device, arch):
    """One rank of a (2, 2, 2) engine over the reduced ``arch`` (fp32, the
    CPU generator's weights on either device), serving the workload: its
    streams, configs and kernel launches. A pod-scale config: its experts
    spread across the dp rows."""
    import dataclasses
    from repro_torch.parallel import Layout
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    lay = Layout(dp=2, sp=2, tp=2)
    base, shift = (Model(cfg, device=device, dtype=torch.float32, lay=la,
                         groups=groups) for la in (lay, lay.to_shift()))
    for m in (base, shift):
        drawn = Model(cfg, device="cpu", dtype=torch.float32, lay=m.lay,
                      groups=groups)
        drawn.init_params(torch.Generator().manual_seed(0))
        m.load_params(drawn.params.state_dict())
    ops.reset_launch_counts()
    groups.traffic.clear()
    eng = ShiftEngine(base, EngineConfig(threshold=16), shift=shift)
    reqs = workload(6, 8)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"streams": [r.generated for r in reqs],
            "counts": dict(eng.config_counts),
            "launches": ops.launch_counts(),
            "ep": base.params.layers[-1].ffn.ep_axes,
            "a2a": groups.traffic.get("all_to_all_bytes", 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "llama4-17b-16e"])
def test_cuda_pod_scale_engine_matches_cpu(cuda, arch):
    """Reduced pod-scale MoE engines on (2, 2, 2), eight ranks on the one
    card over gloo, against the same eight ranks on the CPU: equal streams
    and configs on every rank, both configs used, the experts over
    ("data", "sp") with the all-to-all across rows, and the card's ranks
    went through the kernels (RMSNorm; llama4's ragged attention)."""
    from repro_torch.launch import mesh
    card, cpu = (mesh.run_ranks(_pod_engine_rank, 2, 2, dp=2, device=dev,
                                backend="gloo", timeout_s=300,
                                args=(dev, arch))
                 for dev in ("cuda", "cpu"))
    for a, b in zip(card, cpu):
        assert a["streams"] == b["streams"] == cpu[0]["streams"]
        assert a["counts"] == b["counts"]
        assert a["ep"] == b["ep"] == ("data", "sp")
        assert a["a2a"] > 0 and b["a2a"] > 0
        assert not any(b["launches"].values())
        assert a["launches"]["rmsnorm"] > 0
    assert cpu[0]["counts"]["base"] > 0 and cpu[0]["counts"]["shift"] > 0
    if arch == "llama4-17b-16e":
        assert card[0]["launches"]["paged_ragged_attention"] > 0


# ---------------------------------------------------------------------------
# training: the two backward kernels and a Trainer step, card against CPU
# ---------------------------------------------------------------------------
def _grad_close(got, want, tol):
    """A backward kernel's gradient against its plain version: within
    ``tol`` of its largest entry, and every row (last dim: one token's and
    head's gradient) within 2e-2 (bf16) or 1e-3 (fp32: a row that is 0 in
    exact arithmetic keeps cancellation noise) of its own norm plus 1 % of
    the rms row norm, so that rows of small gradients are held to their
    own scale."""
    g, w = (t.float().reshape(-1, t.shape[-1]) for t in (got, want))
    assert got.shape == want.shape
    assert (g - w).abs().max().item() <= tol * w.abs().max().item()
    wn = w.norm(dim=1)
    floor = 1e-2 * wn.square().mean().sqrt()
    row_tol = 2e-2 if got.dtype == torch.bfloat16 else 1e-3
    assert ((g - w).norm(dim=1) / (wn + floor)).max().item() <= row_tol


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    """The flash backward refuses a bf16 head dim that is not a multiple of
    16 and an fp32 one that is not a multiple of 4, the RMSNorm backward a
    mismatched dy and a record wider than ``MAX_CHUNKS`` (the most a team
    of lanes holds), before any launch (so this runs without a card too)."""
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.kernels import rmsnorm_bwd as RB
    before = (FAB.launches, RB.launches)
    for dtype, D in ((torch.bfloat16, 24), (torch.float32, 6)):
        q = torch.zeros((1, 3, 2, D), dtype=dtype)
        kv = torch.zeros((1, 3, 1, D), dtype=dtype)
        lse = torch.zeros((1, 2, 3))
        with pytest.raises(ValueError, match="D %"):
            FAB.flash_attention_bwd_cuda(q, kv, kv, q, lse, q,
                                         torch.zeros(1, dtype=torch.int32))
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="do not match"):
        RB.rmsnorm_bwd_cuda(x, torch.ones(8), torch.zeros((4, 4)))
    # a record past MAX_CHUNKS: bf16 rows of 8193 (scalar reads) and 65544
    # (16-byte chunks), a grouped fp32 record of 4 x 8196, and a pair of
    # fp32 heads of 32772; records of exactly MAX_CHUNKS pass the check
    for shape, scale_shape, dtype in (((2, 8193), (8193,), torch.bfloat16),
                                      ((1, 65544), (65544,), torch.bfloat16),
                                      ((1, 4, 8196), (4, 8196), torch.float32),
                                      ((1, 32772), (32772,), torch.float32)):
        x = torch.zeros(shape, dtype=dtype)
        s = torch.ones(scale_shape, dtype=dtype)
        with pytest.raises(ValueError, match="more than the 8192"):
            if len(shape) == 2 and dtype == torch.float32:
                RB.rmsnorm_pair_bwd_cuda(x, s, x, x, s, x)
            else:
                RB.rmsnorm_bwd_cuda(x, s, x)
    for shape, dtype in (((2, 8192), torch.bfloat16), ((1, 65536), torch.bfloat16),
                         ((1, 32768), torch.float32)):
        x = torch.zeros(shape, dtype=dtype)
        with pytest.raises(ValueError, match="one CUDA device"):
            RB.rmsnorm_bwd_cuda(x, torch.ones(shape[-1:], dtype=dtype), x)
    assert (FAB.launches, RB.launches) == before


SSD_BWD_SHAPES = [(2, 2048, 64, 64, 128, 64), (2, 2048, 16, 64, 128, 64),
                  (2, 40, 64, 64, 128, 40), (8, 16, 8, 16, 16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,ds,L", SSD_BWD_SHAPES,
                         ids=["microbatch", "per-rank", "short", "reduced"])
def test_cuda_ssd_chunk_bwd_matches_plain(cuda, dtype, B, S, H, hd, ds, L):
    """The SSD chunk backward (``csrc/ssd_chunk_bwd.cu``) against its plain
    version on the forward's inputs as the model hands them over (x, b, c
    views of one conv output): mamba2-1.3b's training microbatch, its
    per-rank heads on (1, 2, 2), one chunk shorter than L, the reduced
    config; each gradient by ``_grad_close`` (2e-2 bf16, 1e-4 fp32), two
    runs bitwise equal, two launches a call."""
    from repro_torch.kernels import ssd_chunk_bwd as SB
    if dtype == torch.bfloat16 and hd < 64:
        pytest.skip("the reduced config trains in fp32")
    gen = torch.Generator(device="cuda").manual_seed(S + H)
    xc = torch.randn((B, S, H * hd + 2 * ds), generator=gen,
                     device="cuda").to(dtype)
    x = xc[..., :H * hd].reshape(B, S, H, hd)
    b, c = xc[..., H * hd:H * hd + ds], xc[..., H * hd + ds:]
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    A = torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    cum = (-dt * A).reshape(B, S // L, L, H).cumsum(2).reshape(B, S, H)
    dy = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    dst = torch.randn((B, S // L, H, hd, ds), generator=gen, device="cuda")
    ddec = torch.randn((B, S, H), generator=gen, device="cuda")
    args = (x, b, c, dt, cum, dy, dst, ddec, L)
    before = SB.launches
    got = SB.ssd_chunk_bwd_cuda(*args)
    again = SB.ssd_chunk_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert SB.launches == before + 2 * SB.LAUNCHES_PER_CALL
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, SB.ssd_chunk_bwd_plain(*args)):
        _grad_close(g, w, tol)


def test_ssd_chunk_bwd_wrapper_refuses_what_the_kernel_does_not_take():
    """The SSD chunk backward's wrapper refuses, naming the limit, a chunk
    over 64 positions, a head or state dim that is not a multiple of 4, a
    head dim over 64 or a state dim over 128 (the CTA's register tiles),
    per-head b and c, a dS_c of the wrong shape and CPU tensors, before any
    launch (so this runs without a card too)."""
    from repro_torch.kernels import ssd_chunk_bwd as SB

    def args(B=1, S=8, H=2, hd=8, ds=8, L=8, bdim=3, nc=None):
        x = torch.zeros((B, S, H, hd))
        b = torch.zeros((B, S, ds) if bdim == 3 else (B, S, H, ds))
        f = torch.zeros((B, S, H))
        dst = torch.zeros((B, nc or S // L, H, hd, ds))
        return (x, b, b, f, f, x, dst, f, L)
    before = SB.launches
    for kw, match in (({"S": 128, "L": 128}, "chunk 128"),
                      ({"hd": 6}, "multiples of 4"),
                      ({"ds": 6}, "multiples of 4"),
                      ({"ds": 132}, "ds <= 128"),
                      ({"hd": 68}, "hd <= 64"),
                      ({"bdim": 4}, r"b, c \[B,S,ds\]"),
                      ({"nc": 2}, "dst must be float32"),
                      ({}, "must lie on")):
        with pytest.raises(ValueError, match=match):
            SB.ssd_chunk_bwd_cuda(*args(**kw))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        a = list(args())
        a[0] = a[0].double()
        SB.ssd_chunk_bwd_cuda(*a)
    # mamba2-1.3b's shapes pass the shape checks (then meet the CPU check)
    with pytest.raises(ValueError, match="must lie on"):
        SB.ssd_chunk_bwd_cuda(*args(B=1, S=64, H=2, hd=64, ds=128, L=64))
    assert SB.launches == before


def test_backward_designs_by_type_and_shape():
    """The flash backward's kernels are chosen by type and shape alone
    (``design``): bf16 at D 64 and 128 with any group up to 64 takes the
    wgmma kernels, every other bf16 D the mma.sync ones, fp32 the CUDA
    cores; each design has its C entry and is three launches a call (delta,
    dK/dV, dQ), as ``LAUNCHES_PER_CALL`` counts (the cuda tests count the
    launches of every design). The RMSNorm backward cuts a segment into
    whole positions, at most ``CTAS`` CTAs covering every row, two launches
    a call. Runs without a card."""
    from repro_torch.kernels import flash_attention_bwd as FAB
    from repro_torch.kernels import rmsnorm_bwd as RB
    for g in (1, 2, 4, 6, 7, 8, 64):
        for D in (64, 128):
            assert FAB.design(torch.bfloat16, D, g) == "wgmma"
        for D in (16, 32, 48, 96, 112, 160, 256):
            assert FAB.design(torch.bfloat16, D, g) == "mma"
        for D in (4, 64, 100, 128, 256):
            assert FAB.design(torch.float32, D, g) == "fp32"
    assert set(FAB.DESIGNS) == set(FAB._C_FUNCS)
    assert FAB.LAUNCHES_PER_CALL == 3 and RB.LAUNCHES_PER_CALL == 2
    for n, H in ((4096, 1), (131072, 1), (37, 1), (1, 1), (512 * 64, 64),
                 (35 * 3, 3)):
        rows, blocks = RB.rows_per_cta(n, H)
        assert rows % H == 0 and blocks <= RB.CTAS
        assert blocks * rows >= n > (blocks - 1) * rows
    assert RB.rows_per_cta(0) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Skv,Hq,Hkv,D,causal,offsets", [
    (2, 70, 70, 4, 2, 16, True, (0, 0)),
    (1, 33, 33, 6, 2, 64, False, (0,)),
    (2, 300, 300, 8, 2, 128, True, (0, 0)),
    (1, 129, 129, 32, 8, 128, True, (0,)),
    (2, 100, 164, 8, 2, 64, True, (64, 30)),
    (2, 90, 200, 28, 4, 128, True, (110, 7)),
    (2, 70, 70, 4, 2, 96, True, (0, 0)),
    (1, 80, 80, 4, 2, 256, True, (0,))])
def test_cuda_flash_backward_matches_plain(cuda, dtype, B, S, Skv, Hq, Hkv,
                                           D, causal, offsets):
    """dQ, dK, dV of the kernel against the plain backward over the
    forward kernel's log-sum-exp (which matches the plain forward's),
    within 1e-4 (fp32) or 2e-2 (bf16) of each gradient's largest entry and
    of each row's norm (``_grad_close``); two runs are bitwise equal (no
    atomics), three launches a call. Every design is reached: bf16 D 64
    and 128 on the wgmma kernels (with Sq not a multiple of 64, nonzero
    offsets, Skv > Sq, a group of 7), D 16, 96 and 256 on the mma.sync
    ones, fp32 on the CUDA cores."""
    from repro_torch.kernels import flash_attention_bwd as FAB
    gen = torch.Generator(device="cuda").manual_seed(S)
    q, do = (torch.randn((B, S, Hq, D), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Skv, Hkv, D), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    out, lse = FA.flash_attention_cuda(q, k, v, off, causal=causal,
                                       return_lse=True)
    _, lse_p = FA.flash_attention_plain(q, k, v, off, causal=causal,
                                        return_lse=True)
    assert (lse - lse_p).abs().max().item() < 1e-4
    before = FAB.launches
    got = FAB.flash_attention_bwd_cuda(q, k, v, out, lse, do, off,
                                       causal=causal)
    again = FAB.flash_attention_bwd_cuda(q, k, v, out, lse, do, off,
                                         causal=causal)
    torch.cuda.synchronize()
    assert FAB.launches == before + 2 * FAB.LAUNCHES_PER_CALL == before + 6
    want = FAB.flash_attention_bwd_plain(q, k, v, out, lse, do, off,
                                         causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _grad_close(a, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["rows", "grouped", "pair", "long rows",
                                  "d_model 3584", "d_model 8192",
                                  "pair, training", "odd D",
                                  "grouped, D 96"])
def test_cuda_rmsnorm_backward_matches_plain(cuda, dtype, case):
    """dx and dscale of the kernel against the plain backward, within
    1e-4 (fp32) or 2e-2 (bf16) of their largest entries and of each row's
    norm (``_grad_close``), bitwise equal over two runs (the dscale
    partials are summed in a fixed order), two launches a call: narrow
    rows, grouped heads, d_model rows (a CTA per row), the q/k pair (also
    at a 256-token microbatch of qwen3-8b's heads), a D that is not a
    multiple of 8 (scalar reads) and grouped heads of 96 (each head's sums
    through shared memory)."""
    from repro_torch.kernels import rmsnorm_bwd as RB
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if case.startswith("pair"):
        n, hq, hk = (96, 4, 1) if case == "pair" else (256, 32, 8)
        args = (rnd(n, hq, 128), rnd(128), rnd(n, hq, 128), rnd(n, hk, 128),
                rnd(128), rnd(n, hk, 128))
        run, plain = RB.rmsnorm_pair_bwd_cuda, RB.rmsnorm_pair_bwd_plain
    else:
        shape, sshape = {"rows": ((37, 64), (64,)),
                         "grouped": ((5, 7, 3, 32), (3, 32)),
                         "long rows": ((600, 5120), (5120,)),
                         "d_model 3584": ((64, 3584), (3584,)),
                         "d_model 8192": ((32, 8192), (8192,)),
                         "odd D": ((50, 102), (102,)),
                         "grouped, D 96": ((9, 5, 96), (5, 96))}[case]
        args = (rnd(*shape), rnd(*sshape), rnd(*shape))
        run, plain = RB.rmsnorm_bwd_cuda, RB.rmsnorm_bwd_plain
    before = RB.launches
    got, again = run(*args), run(*args)
    torch.cuda.synchronize()
    assert RB.launches == before + 2 * RB.LAUNCHES_PER_CALL == before + 4
    want = plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _grad_close(a, w, tol)


@pytest.mark.cuda
def test_cuda_training_matches_cpu(cuda):
    """Reduced qwen3-8b in fp32: the loss and gradients of one call and
    two Trainer steps (microbatch 2, remat) on the card equal the CPU's,
    and the card's backward went through both backward kernels."""
    from repro_torch.training import Trainer
    from repro_torch.training.optimizer import AdamWConfig
    cfg = get_config("qwen3-8b").reduced()
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device="cuda", dtype=torch.float32)
    gpu.load_params(cpu.params.state_dict())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (8, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    res = {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        ops.reset_launch_counts()
        with m.trainable() as named:
            loss = m.loss_fn()(toks, labels)
            loss.backward()
            grads = {k: p.grad.cpu() for k, p in named.items()}
        tr = Trainer(m, AdamWConfig(lr=1e-3), microbatch=2)
        opt = tr.init_opt_state()
        for _ in range(2):
            opt, _ = tr.step(opt, toks, labels)
        res[name] = (float(loss), grads, {k: v.cpu() for k, v in
                                          m.params.state_dict().items()},
                     ops.launch_counts())
    (lc, gc, pc, nc), (lg, gg, pg, ng) = res["cpu"], res["gpu"]
    assert abs(lc - lg) <= 1e-5
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= 1e-4 * gc[k].abs().max()
        keep = gc[k].abs() >= 1e-7
        assert (pg[k] - pc[k]).abs()[keep].max() <= 5e-4
    assert not any(nc.values())
    assert ng["flash_attention_bwd"] > 0 and ng["rmsnorm_bwd"] > 0
