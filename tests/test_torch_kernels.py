"""The port's kernel modules against the reference's (``repro.kernels``).

* the plain PyTorch attention against the bit-exact jnp mirror of the
  Pallas kernel on the eight-case grid of ``test_workprop_attention.py``
  (GQA/MHA/MQA, windows, soft cap, empty rows, tails, ctx past the table);
* the port's gather oracle against the reference's gather backend;
* the plain RMSNorm against ``layers.rmsnorm`` and the Pallas
  ``rmsnorm_kernel`` (interpret mode);
* the plain flash, decode and padded paged decode attention against the
  reference's ``ops`` (the Pallas kernels in interpret mode), its oracles
  and ``attention_math.attend``;
* the dispatch: CPU tensors take the plain versions and count no launch.

Each hand-written kernel is held to its plain version on the card in
``test_torch_cuda.py``.

Inputs are made from a seed with numpy and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.ops import KernelConfig  # noqa: E402
from repro.models.attention_math import attend  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PDA  # noqa: E402
from repro_torch.kernels import paged_ragged_attention as PRA  # noqa: E402
from test_torch_cuda import (CASES, DECODE_CASES, FLASH_CASES,  # noqa: E402
                             PARAMS, dense_case, paged_case)




def _both(backend, B, C, Hq, Hkv, D, bs, nmax, ctx, ql, window, cap):
    q, kp, vp, bt, qla, ctxa = paged_case(B, C, Hq, Hkv, D, bs, nmax, ctx, ql)
    want = np.asarray(rops.paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(qla), jnp.asarray(ctxa), window=window, soft_cap=cap,
        kcfg=KernelConfig(backend)))
    return q, kp, vp, bt, qla, ctxa, want


@pytest.mark.parametrize(PARAMS, CASES)
def test_plain_attention_matches_mirror(B, C, Hq, Hkv, D, bs, nmax, ctx, ql,
                                        window, cap):
    """Through the port's dispatch on CPU tensors (the plain version) vs
    the reference's mirror, real columns only, fp32 at 1e-5: the same
    algorithm, with sums taken in another order."""
    q, kp, vp, bt, qla, ctxa, want = _both("reference", B, C, Hq, Hkv, D, bs,
                                           nmax, ctx, ql, window, cap)
    before = PRA.launches
    got = ops.paged_ragged_attend(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(qla), torch.from_numpy(ctxa),
        window=window, soft_cap=cap).numpy()
    assert PRA.launches == before          # CPU tensors never launch
    assert np.isfinite(got).all()          # padding columns stay finite
    for b in range(B):
        n = int(ql[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize(PARAMS, CASES)
def test_gather_oracle_matches_repro_gather(B, C, Hq, Hkv, D, bs, nmax, ctx,
                                            ql, window, cap):
    """The port's materialized-gather oracle (with the clip of out-of-range
    table ids) vs the reference's ``gather`` backend, fp32 at 1e-5."""
    q, kp, vp, bt, qla, ctxa, want = _both("gather", B, C, Hq, Hkv, D, bs,
                                           nmax, ctx, ql, window, cap)
    g = Hq // Hkv
    q5 = torch.from_numpy(q).transpose(1, 2).reshape(B, Hkv, g, C, D)
    got = PRA.paged_ragged_attention_gather(
        q5, torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(bt),
        torch.from_numpy(qla), torch.from_numpy(ctxa), window=window,
        soft_cap=cap)
    got = got.reshape(B, Hq, C, D).transpose(1, 2).numpy()
    for b in range(B):
        n = int(ql[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=1e-5)


def _bf16_ulps(a, b):
    """Distance in bf16 ulps between two bf16 tensors (as ordered ints)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("N,D", [(24, 64), (96, 16)])
def test_plain_rmsnorm_matches_reference_fp32(N, D):
    """fp32: the plain version vs ``layers.rmsnorm`` and the Pallas kernel
    in interpret mode, at 1e-6."""
    rng = np.random.default_rng(N + D)
    x = rng.standard_normal((N, D), dtype=np.float32) * 3
    s = rng.standard_normal((D,), dtype=np.float32)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    ref = np.asarray(jax_rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x)))
    pal = np.asarray(rops.rmsnorm(jnp.asarray(x), jnp.asarray(s)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, pal, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("N,D", [(24, 64), (96, 16)])
def test_plain_rmsnorm_matches_reference_bf16(N, D):
    """bf16: within one bf16 ulp of the reference, and equal in all but a
    few elements (on these inputs every element is equal; at [2000, 128]
    2 of 256000 elements differ by one ulp, at [512, 4096] none). Both
    compute the normalised row in fp32 and round it to
    bf16, then take the bf16 product with the scale, which is rounded
    correctly on both sides. Only the fp32 reciprocal square root and the
    order of the mean's sum differ (by an fp32 ulp or so), and that moves
    the bf16 rounding of the normalised value only when it lies within an
    fp32 ulp of a rounding boundary: one bf16 ulp, rarely."""
    rng = np.random.default_rng(N * D)
    x32 = rng.standard_normal((N, D), dtype=np.float32) * 3
    s32 = rng.standard_normal((D,), dtype=np.float32)
    x = torch.from_numpy(x32).bfloat16()
    s = torch.from_numpy(s32).bfloat16()
    got = ops.rmsnorm(x, s)
    assert got.dtype == torch.bfloat16
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    sj = jnp.asarray(s.float().numpy()).astype(jnp.bfloat16)
    for ref in (jax_rmsnorm({"scale": sj}, xj), rops.rmsnorm(xj, sj)):
        want = torch.from_numpy(np.array(ref.astype(jnp.float32))).bfloat16()
        ulps = _bf16_ulps(got, want)
        assert int(ulps.max()) <= 1
        assert int((ulps > 0).sum()) <= max(1, got.numel() // 100)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,offs", FLASH_CASES[:4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_pallas(B, Sq, Skv, Hq, Hkv, D, causal, offs,
                                   dtype):
    """The TPU-contract cases of ``tests/test_kernels.py`` (q_offsets 0):
    the plain version vs ``repro.kernels.ops.flash_attention`` (the Pallas
    kernel in interpret mode) at 2e-5 in fp32; in bf16 both round the same
    bf16 inputs and p to bf16, and differ by the sum order, within 2e-2."""
    q, k, v = dense_case(B, Sq, Skv, Hq, Hkv, D, seed=Sq + Hq + D)
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    want = rops.flash_attention(
        *(jnp.asarray(t.float().numpy()).astype(dtype) for t in tq),
        causal=causal)
    before = FA.launches
    got = ops.flash_attention(*tq, causal=causal)
    assert FA.launches == before
    assert got.dtype == tq[0].dtype and got.shape == (B, Sq, Hq, D)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,offs", FLASH_CASES[4:])
def test_plain_flash_offsets_match_attend(B, Sq, Skv, Hq, Hkv, D, causal,
                                          offs):
    """Chunks at per-row offsets against a whole cache row: the plain
    version vs ``attention_math.attend`` with the dense prefill's
    positions and ``kv_len = offsets + Sq``, fp32 at 1e-5 (``attend``
    scales q before the dot, the kernel the scores after it)."""
    q, k, v = dense_case(B, Sq, Skv, Hq, Hkv, D, seed=7)
    off = np.asarray(offs, np.int32)
    pos = off[:, None] + np.arange(Sq, dtype=np.int32)[None]
    want = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(pos), jnp.arange(Skv), causal=True,
                  kv_len=jnp.asarray(off + Sq))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              q_offsets=torch.from_numpy(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# decode attention, contiguous and padded paged
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,Hq,Hkv,D", DECODE_CASES[:3])
def test_plain_decode_matches_pallas(B, S, Hq, Hkv, D):
    """The cases of ``tests/test_kernels.py``: the plain version vs
    ``repro.kernels.ops.decode_attention`` (interpret mode), fp32 at
    2e-5."""
    q, k, v = dense_case(B, 1, S, Hq, Hkv, D, seed=S + Hq)
    lens = np.random.default_rng(S).integers(1, S, (B,)).astype(np.int32)
    want = rops.decode_attention(*map(jnp.asarray, (q, k, v, lens)))
    before = DA.launches
    got = ops.decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    assert DA.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("valid_len", [1, 37, 256, 511])
def test_plain_decode_ignores_tokens_past_lens(valid_len):
    """``tests/test_kernels.py``'s property: poisoning K/V past ``lens``
    changes nothing (fp32, 1e-6)."""
    q, k, v = dense_case(1, 1, 512, 2, 1, 64, seed=7)
    lens = torch.tensor([valid_len], dtype=torch.int32)
    out1 = ops.decode_attention(*map(torch.from_numpy, (q, k, v)), lens)
    k[:, valid_len:], v[:, valid_len:] = 99.0, -99.0
    out2 = ops.decode_attention(*map(torch.from_numpy, (q, k, v)), lens)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


@pytest.mark.parametrize("B,Hq,Hkv,D,bs,nmax,ctx", [
    (4, 8, 2, 64, 16, 16, [200, 8, 256, 17]),
    (2, 4, 4, 128, 32, 16, [511, 300]),
    (3, 16, 1, 64, 16, 8, [1, 100, 128]),
])
def test_plain_paged_decode_matches_reference(B, Hq, Hkv, D, bs, nmax, ctx):
    """The plain padded walk, with a poisoned null block behind the table
    tails, vs ``repro.kernels.ops.paged_decode_attention`` (interpret mode)
    and the reference's gather oracle ``paged_decode_attention_ref`` at
    1e-4 (as ``tests/test_paged_cache.py`` holds them), and vs the port's
    plain ragged attention at C == 1 within 1e-6."""
    q, kp, vp, bt, ql, lens = paged_case(B, 1, Hq, Hkv, D, bs, nmax, ctx,
                                         [1] * B, seed=B + D)
    kp[0], vp[0] = 99.0, -99.0                     # the null block
    g = Hq // Hkv
    want = rops.paged_decode_attention(*map(jnp.asarray,
                                            (q, kp, vp, bt, lens)))
    oracle = rref.paged_decode_attention_ref(
        jnp.asarray(q.reshape(B, Hkv, g, D)), *map(jnp.asarray,
                                                    (kp, vp, bt, lens)))
    before = PDA.launches
    got = ops.paged_decode_attention(*map(torch.from_numpy,
                                          (q, kp, vp, bt, lens)))
    assert PDA.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy().reshape(B, Hkv, g, D),
                               np.asarray(oracle), atol=1e-4, rtol=1e-4)
    rag = ops.paged_ragged_attend(*map(torch.from_numpy,
                                       (q, kp, vp, bt, ql, lens)))
    np.testing.assert_allclose(got.numpy(), rag.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_dispatch_rejects_other_devices():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.rmsnorm(x, torch.zeros((8,), device="meta"))
