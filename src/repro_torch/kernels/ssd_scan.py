"""Mamba-2 SSD intra-chunk step: the Hopper kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/ssd_chunk.cu``, CUDA C++ for sm_90a) replaces the Pallas
TPU kernel ``repro.kernels.ssd_scan.ssd_chunk_kernel`` and serves every SSD
prefill (``models.ssd._ssd_scan``). Per (batch row, chunk of L positions,
head), in fp32:

* ``y_intra [L, hd] = ((c·bᵀ) ⊙ exp(cum_t − cum_s) ⊙ dt_s, lower
  triangle)·x``
* ``S_c [hd, ds] = (x ⊙ exp(cum_{L-1} − cum)·dt)ᵀ·b``, the chunk's state
  contribution
* ``decay_in [L] = exp(cum)``

Bytes bound it on the H100: at mamba2-1.3b's serving prefill step (B 8,
S 64, H 64, hd 64, ds 128) it moves ~30 MB (~9 µs at 3.35 TB/s), mostly
the fp32 y and S_c it writes. One CTA per (row, chunk, group of heads)
forms c·bᵀ once for the group. With bf16 inputs all three products run on
the tensor cores (``mma.sync``), the fp32 operands of the last two split
into three bf16 parts so that the sums keep 1e-4; with fp32 inputs they
run on the CUDA cores (the source note says more).

Shapes (both functions): x ``[B, S, H, hd]``, b/c ``[B, S, H, ds]`` (a head
stride of 0 shares one group's b and c across the heads), dt/cum ``[B, S,
H]`` fp32, S a multiple of ``chunk`` (= L). Returns fp32 ``(y [B, S, H,
hd], S_c [B, S/L, H, hd, ds], decay_in [B, S, H])``. The TPU kernel's
contract, x ``[N, L, hd]`` per (head, chunk), is the case B = N, S = L,
H = 1.
"""
from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel since the count was last set to 0
launches = 0

MAX_L, MAX_HD, MAX_DS = 128, 128, 256
SMEM_LIMIT = 232448      # bytes of shared memory a block can use on Hopper


def ssd_chunk_plain(x, b, c, dt, cum, chunk):
    """Plain PyTorch version: the TPU kernel's arithmetic per chunk and
    head, vectorised over rows, chunks and heads. The upper triangle is
    ``exp(-1e30) = 0``, as in the TPU kernel."""
    B, S, H, hd = x.shape
    ds = b.shape[-1]
    L = chunk
    nc = S // L
    xf = x.float().reshape(B, nc, L, H, hd)
    bf = b.float().reshape(B, nc, L, H, ds)
    cf = c.float().reshape(B, nc, L, H, ds)
    dtf = dt.float().reshape(B, nc, L, H)
    cumf = cum.float().reshape(B, nc, L, H)
    cb = torch.einsum("bctHn,bcsHn->bcHts", cf, bf)
    decay = (cumf[:, :, :, None, :] - cumf[:, :, None, :, :]) \
        .permute(0, 1, 4, 2, 3)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    sc = cb * torch.exp(torch.where(tri, decay, -1e30)) \
        * dtf.permute(0, 1, 3, 2)[:, :, :, None, :]
    y = torch.einsum("bcHts,bcsHp->bctHp", sc, xf)
    w = torch.exp(cumf[:, :, -1:] - cumf) * dtf
    st = torch.einsum("bctHp,bctHn->bcHpn", xf * w[..., None], bf)
    return y.reshape(B, S, H, hd), st, torch.exp(cumf).reshape(B, S, H)


_C_FUNCS = {torch.float32: "ssd_chunk_f32", torch.bfloat16: "ssd_chunk_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib():
    from .build import load
    return load("ssd_chunk")


def _bind(dtype):
    fn = getattr(_lib(), _C_FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(L, hd, ds, dtype):
    """Dynamic shared memory of one CTA, in bytes (the kernel's own rule)."""
    fn = _lib().ssd_chunk_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(L, hd, ds, int(dtype == torch.bfloat16))


def ssd_chunk_cuda(x, b, c, dt, cum, chunk):
    """Launch the CUDA kernel on PyTorch's current stream. x, b, c in fp32
    or bf16 (one type) on one CUDA device, any strides with a contiguous
    last dim, hd ≤ 128 and ds ≤ 256, multiples of 16 in bf16 (the tensor
    cores' depth) and of 4 and 8 in fp32; dt, cum fp32 contiguous;
    ``chunk`` ≤ 128 dividing S. Raises on anything else and when the launch
    fails."""
    global launches
    if x.dtype not in _C_FUNCS:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape \
            or b.shape[:3] != x.shape[:3]:
        raise ValueError("want x [B,S,H,hd] and b, c [B,S,H,ds], got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, S, H, hd = x.shape
    ds = b.shape[-1]
    for name, t in (("dt", dt), ("cum", cum)):
        if t.shape != (B, S, H) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [{B}, {S}, "
                             f"{H}], got {tuple(t.shape)} {t.dtype}")
    if not 0 < chunk <= MAX_L or S % chunk:
        raise ValueError(f"chunk {chunk}: want 0 < chunk <= {MAX_L} dividing "
                         f"S = {S}")
    hm, dm = (16, 16) if x.dtype == torch.bfloat16 else (4, 8)
    if hd % hm or hd > MAX_HD or ds % dm or ds > MAX_DS:
        raise ValueError(f"hd {hd}, ds {ds}: want hd % {hm} == 0, hd <= "
                         f"{MAX_HD}, ds % {dm} == 0, ds <= {MAX_DS} in "
                         f"{x.dtype}")
    if B > 65535 or S // chunk > 65535:
        raise ValueError(f"B {B}, {S // chunk} chunks: at most 65535 each")
    for name, t in (("x", x), ("b", b), ("c", c), ("dt", dt), ("cum", cum)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}, not {t.device}")
        if name in ("b", "c") and t.dtype != x.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != x dtype {x.dtype}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=x.device)
    st = torch.empty((B, S // chunk, H, hd, ds), dtype=torch.float32,
                     device=x.device)
    dec = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, st.zero_(), dec
    with torch.cuda.device(x.device):
        need = smem_bytes(chunk, hd, ds, x.dtype)
        if need > SMEM_LIMIT:
            raise ValueError(f"chunk {chunk}, hd {hd}, ds {ds} need {need} "
                             f"bytes of shared memory, over {SMEM_LIMIT}")
        strides = (ctypes.c_longlong * 9)(*(s for t in (x, b, c)
                                            for s in t.stride()[:3]))
        fn = _bind(x.dtype)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
                 cum.data_ptr(), y.data_ptr(), st.data_ptr(), dec.data_ptr(),
                 ctypes.addressof(strides), B, S, H, hd, ds, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: cudaError_t {err}")
    launches += 1
    return y, st, dec
