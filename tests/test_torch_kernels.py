"""The port's kernel modules against the reference's (``repro.kernels``).

* the plain PyTorch attention against the bit-exact jnp mirror of the
  Pallas kernel on the eight-case grid of ``test_workprop_attention.py``
  (GQA/MHA/MQA, windows, soft cap, empty rows, tails, ctx past the table);
* the port's gather oracle against the reference's gather backend;
* the plain RMSNorm against ``layers.rmsnorm`` and the Pallas
  ``rmsnorm_kernel`` (interpret mode);
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
from repro.kernels.ops import KernelConfig  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_ragged_attention as PRA  # noqa: E402
from test_torch_cuda import CASES, PARAMS, paged_case  # noqa: E402




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


def test_dispatch_rejects_other_devices():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.rmsnorm(x, torch.zeros((8,), device="meta"))
