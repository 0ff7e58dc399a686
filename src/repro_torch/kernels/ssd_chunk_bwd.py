"""The backward of the Mamba-2 SSD intra-chunk step: the Hopper kernel's
wrapper and its plain PyTorch version.

Training runs every SSD layer's intra-chunk step through the chunk kernel
(``ssd_scan.py``), so that kernel needs a gradient: ``ops.SSDChunk`` is the
``torch.autograd.Function`` whose backward is this. The reference needs
none (its ``_ssd_scan`` is jnp, and ``jax.grad`` goes through it); the port
routes the step through its kernel, whose function the TPU's
``ssd_chunk_kernel`` defines. Per (batch row, chunk of L positions, head),
with t, s < L:

* ``E_ts = exp(cum_t - cum_s)`` for s <= t, else 0; ``K = c·bᵀ``;
  ``M = K ⊙ E ⊙ dt_s``; ``w_s = exp(cum_{L-1} - cum_s)·dt_s``;
* forward: ``y = M·x``, ``S_c = (x ⊙ w)ᵀ·b``, ``dec = exp(cum)``;
* backward, given dy, dS_c and ddec: ``dM = dy·xᵀ`` on the lower
  triangle; ``dx = Mᵀ·dy + w ⊙ (b·dS_cᵀ)``; ``G = dM ⊙ E ⊙ dt_s``,
  ``dc = G·b``, ``db = Gᵀ·c + (x ⊙ w)·dS_c``, both summed over the heads
  that share the group; ``ddt_s = Σ_t (dM ⊙ K ⊙ E)_ts + u_s·exp(cum_{L-1}
  - cum_s)`` with ``u_s = Σ_p x_sp (b·dS_cᵀ)_sp``; ``dcum_t = Σ_s (dM ⊙
  M)_ts - Σ_t' (dM ⊙ M)_t't - u_t·w_t + ddec_t·dec_t``, plus ``Σ_s u_s·w_s``
  at t = L-1.

Autograd carries dcum through the cumsum and the log decay ``-dt·A`` to dt
and A, outside the kernel.

The kernel (``csrc/ssd_chunk_bwd.cu``, CUDA C++ for sm_90a) takes one CTA
per (row, chunk, group of heads); it forms c·bᵀ once for the group, keeps
the group's db and dc in registers across its heads (each thread a tile of
them, as of each product), and writes them as one partial per group; a
second launch sums the partials over the groups in a fixed order. No atomics, so two runs are bitwise equal. Every product runs
on the CUDA cores in fp32, for bf16 and fp32 inputs alike (the source's
header says why and what is left).

Shapes (both functions): x ``[B, S, H, hd]``; b, c ``[B, S, ds]`` (the one
group every head shares); dt, cum ``[B, S, H]`` fp32; dy ``[B, S, H, hd]``,
dS_c ``[B, S/L, H, hd, ds]`` and ddec ``[B, S, H]``, the cotangents of
``ssd_chunk``'s outputs. Returns ``(dx [B, S, H, hd], db, dc [B, S, ds],
ddt, dcum [B, S, H])``, in fp32 (fp64 for fp64 inputs to the plain
version).
"""
from __future__ import annotations

import ctypes

import torch

# kernel launches of the CUDA backward since the count was last set to 0:
# LAUNCHES_PER_CALL a call (the chunks, then the group sum of db and dc)
launches = 0
LAUNCHES_PER_CALL = 2

# a CTA's 256 threads take register tiles of 4 rows by 4 columns (the
# [L, L] and [L, hd] products) or by 2 float4 columns (db and dc), 16 lanes
# a dimension: the kernel's limits
MAX_L, MAX_HD, MAX_DS = 64, 64, 128


def _acc(dtype):
    """The arithmetic type: fp64 for fp64 inputs, fp32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def ssd_chunk_bwd_plain(x, b, c, dt, cum, dy, dst, ddec, chunk):
    """Plain PyTorch version, vectorised over rows, chunks and heads as
    ``ssd_chunk_plain`` is; the formulas of the module's docstring."""
    f = _acc(x.dtype)
    B, S, H, hd = x.shape
    ds = b.shape[-1]
    L = chunk
    nc = S // L
    xf = x.to(f).reshape(B, nc, L, H, hd)
    bf = b.to(f).reshape(B, nc, L, ds)
    cf = c.to(f).reshape(B, nc, L, ds)
    dtf = dt.to(f).reshape(B, nc, L, H)
    cumf = cum.to(f).reshape(B, nc, L, H)
    dyf = dy.to(f).reshape(B, nc, L, H, hd)
    dsf = dst.to(f)                                     # [B, nc, H, hd, ds]
    ddf = ddec.to(f).reshape(B, nc, L, H)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    K = torch.einsum("bctn,bcsn->bcts", cf, bf)[:, :, None]  # [B,nc,1,t,s]
    ch = cumf.permute(0, 1, 3, 2)                       # [B, nc, H, L]
    E = torch.where(tri, torch.exp(ch[..., :, None] - ch[..., None, :]), 0.0)
    dts = dtf.permute(0, 1, 3, 2)[..., None, :]         # dt_s [B,nc,H,1,s]
    M = K * E * dts
    dM = torch.where(tri, torch.einsum("bcthp,bcshp->bchts", dyf, xf), 0.0)
    w = torch.exp(cumf[:, :, -1:] - cumf) * dtf         # [B, nc, L, H]
    bd = torch.einsum("bcsn,bchpn->bcshp", bf, dsf)     # b·dS_cᵀ
    dx = torch.einsum("bchts,bcthp->bcshp", M, dyf) + w[..., None] * bd
    G = dM * E * dts
    dc = torch.einsum("bchts,bcsn->bctn", G, bf)
    db = torch.einsum("bchts,bctn->bcsn", G, cf) \
        + torch.einsum("bcshp,bchpn->bcsn", xf * w[..., None], dsf)
    R = dM * K * E
    u = (xf * bd).sum(-1)                               # [B, nc, L, H]
    ddt = R.sum(-2).permute(0, 1, 3, 2) \
        + u * torch.exp(cumf[:, :, -1:] - cumf)
    Q = R * dts
    dcum = (Q.sum(-1) - Q.sum(-2)).permute(0, 1, 3, 2) - u * w \
        + ddf * torch.exp(cumf)
    dcum[:, :, -1] += (u * w).sum(2)
    return (dx.reshape(B, S, H, hd), db.reshape(B, S, ds),
            dc.reshape(B, S, ds), ddt.reshape(B, S, H),
            dcum.reshape(B, S, H))


_C_FUNCS = {torch.float32: "ssd_chunk_bwd_f32",
            torch.bfloat16: "ssd_chunk_bwd_bf16"}
# x, b, c, dt, cum, dy, dst, ddec, dx, db, dc, ddt, dcum, partials,
# strides, B, S, H, hd, ds, L, heads per CTA, stream
_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_bound = {}


def _lib():
    from .build import load
    return load("ssd_chunk_bwd")


def _bind(dtype):
    fn = _bound.get(dtype)
    if fn is None:
        fn = getattr(_lib(), _C_FUNCS[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound[dtype] = fn
    return fn


def heads_per_cta(B, nc, H, sms):
    """Heads a CTA takes (its group): the largest of 8, 4, 2 that still
    gives every one of ``sms`` SMs a CTA, else 1 (the kernel's rule)."""
    for cand in (8, 4, 2):
        if B * nc * -(-H // cand) >= sms:
            return cand
    return 1


def _check(x, b, c, dt, cum, dy, dst, ddec, chunk):
    """The wrapper's contract; raises naming the limit."""
    if x.dtype not in _C_FUNCS:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if x.dim() != 4 or b.dim() != 3 or b.shape != c.shape \
            or b.shape[:2] != x.shape[:2]:
        raise ValueError("want x [B,S,H,hd] and b, c [B,S,ds], got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, S, H, hd = x.shape
    ds = b.shape[-1]
    if not 0 < chunk <= MAX_L or S % chunk:
        raise ValueError(f"chunk {chunk}: want 0 < chunk <= {MAX_L} dividing "
                         f"S = {S}")
    if hd % 4 or ds % 4 or hd > MAX_HD or ds > MAX_DS:
        raise ValueError(f"hd {hd}, ds {ds}: want multiples of 4, hd <= "
                         f"{MAX_HD}, ds <= {MAX_DS}")
    if B > 65535 or S // chunk > 65535:
        raise ValueError(f"B {B}, {S // chunk} chunks: at most 65535 each")
    shapes = {"dt": (B, S, H), "cum": (B, S, H), "dy": (B, S, H, hd),
              "dst": (B, S // chunk, H, hd, ds), "ddec": (B, S, H)}
    named = (("x", x), ("b", b), ("c", c), ("dt", dt), ("cum", cum),
             ("dy", dy), ("dst", dst), ("ddec", ddec))
    for name, t in named:
        if name in ("b", "c") and t.dtype != x.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != x dtype {x.dtype}")
        if name in shapes and (tuple(t.shape) != shapes[name]
                               or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 {list(shapes[name])}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    for name, t in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}, not {t.device}")


def ssd_chunk_bwd_cuda(x, b, c, dt, cum, dy, dst, ddec, chunk):
    """Launch the CUDA backward on PyTorch's current stream. x, b, c in
    fp32 or bf16 (one type) with any strides of a contiguous last dim;
    dt, cum, dy, dst, ddec fp32 (copied when not contiguous); chunk <= 64
    dividing S, hd <= 64 and ds <= 128, multiples of 4. Raises on anything
    else and when a launch fails."""
    global launches
    _check(x, b, c, dt, cum, dy, dst, ddec, chunk)
    B, S, H, hd = x.shape
    ds = b.shape[-1]
    dt, cum, dy, dst, ddec = (t.contiguous() for t in
                              (dt, cum, dy, dst, ddec))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((B, S, H, hd), **f32)
    db = torch.empty((B, S, ds), **f32)
    dc = torch.empty((B, S, ds), **f32)
    ddt = torch.empty((B, S, H), **f32)
    dcum = torch.empty((B, S, H), **f32)
    if dx.numel() == 0:
        return dx, db.zero_(), dc.zero_(), ddt, dcum
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        hpc = heads_per_cta(B, S // chunk, H, sms)
        groups = -(-H // hpc)
        part = torch.empty((2, groups, B, S, ds), **f32)
        strides = (ctypes.c_longlong * 7)(x.stride(0), x.stride(1),
                                          x.stride(2), b.stride(0),
                                          b.stride(1), c.stride(0),
                                          c.stride(1))
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(x.dtype)(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            cum.data_ptr(), dy.data_ptr(), dst.data_ptr(), ddec.data_ptr(),
            dx.data_ptr(), db.data_ptr(), dc.data_ptr(), ddt.data_ptr(),
            dcum.data_ptr(), part.data_ptr(), ctypes.addressof(strides), B, S,
            H, hd, ds, chunk, hpc, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel launch failed: cudaError_t "
                           f"{err}")
    launches += LAUNCHES_PER_CALL
    return dx, db, dc, ddt, dcum
