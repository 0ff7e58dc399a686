"""The backward of RMSNorm: the Hopper kernel's wrapper and its plain
PyTorch version.

Training runs every norm through the RMSNorm kernel (``rmsnorm.py``), so
that kernel needs a gradient: ``ops.RMSNorm`` and ``ops.RMSNormPair`` are
the ``torch.autograd.Function``s whose backward is this. The kernel
(``csrc/rmsnorm_bwd.cu``, CUDA C++ for sm_90a) computes, per row in fp32
with ``xh = x * r`` and ``r = rsqrt(mean(x^2) + eps)``::

    dx     = r * (s * dy - xh * mean(xh * s * dy))
    dscale = sum over rows of dy * xh      (per head for a grouped scale)

for plain rows, grouped heads (scale [H, D], row i takes row i mod H) and
a layer's q/k pair in one call, as the forward does. It replaces no TPU
kernel of its own (the reference differentiates its jnp ``rmsnorm``).

What bounds it on the H100: bytes (x and dy read, dx written). So the
first launch reads each row once with 16-byte vectors (scalars where D is
not a multiple of 16 bytes), keeps it in registers, reduces the row's two
sums across its lanes, writes dx, and sums dy * xh of its columns over the
CTA's rows in registers, one fp32 partial row per CTA; the second sums
the partials over the CTAs in a fixed order, many CTAs over the columns.
No atomics, so two runs give bitwise equal gradients. The kernel chooses
how a row spreads over the lanes from D and the type; the wrapper chooses
the rows per CTA (``_segment``).
"""
from __future__ import annotations

import ctypes

import torch

# kernel launches of the CUDA backward since the count was last set to 0:
# LAUNCHES_PER_CALL a call (dx and the dscale partials, then their sum)
launches = 0
LAUNCHES_PER_CALL = 2

H100_SMS = 132
CTAS = 2 * H100_SMS             # CTAs a segment is cut into, at most
# 16-byte chunks (or values, when D is not a multiple of 16 bytes) of a
# record (a plain row, or one position's H rows of a grouped norm) that one
# team of lanes holds in registers: MAX_TEAM * MAX_CPL in csrc/rmsnorm_bwd.cu
MAX_CHUNKS = 8192


def rmsnorm_bwd_plain(x, scale, dy, eps=1e-6):
    """Plain PyTorch version in fp32: ``(dx, dscale)`` of ``rmsnorm_plain``
    for the cotangent ``dy``, the cast before the product taken as the
    identity; dx in x's type, dscale in the scale's."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xh = xf * r
    sdy = scale.float() * dyf
    dx = r * (sdy - xh * (xh * sdy).mean(-1, keepdim=True))
    lead = x.dim() - scale.dim()
    dscale = (dyf * xh).sum(dim=tuple(range(lead))) if lead else dyf * xh
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_pair_bwd_plain(q, q_scale, dq, k, k_scale, dk, eps=1e-6):
    """Plain version of the pair: two ``rmsnorm_bwd_plain`` calls. Returns
    (dq_in, dq_scale, dk_in, dk_scale)."""
    return (*rmsnorm_bwd_plain(q, q_scale, dq, eps),
            *rmsnorm_bwd_plain(k, k_scale, dk, eps))


_C_FUNCS = {torch.float32: "rmsnorm_bwd_f32",
            torch.bfloat16: "rmsnorm_bwd_bf16"}
# x, dy, scale, dx, partial, dscale, n, h, rows, blocks (segment a); the
# same without h (segment b); D, eps, stream
_SEG_A = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3
_SEG_B = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 2
_ARGTYPES = _SEG_A + _SEG_B + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_bound = {}


def _bind(dtype):
    fn = _bound.get(dtype)
    if fn is None:
        from .build import load
        fn = getattr(load("rmsnorm_bwd"), _C_FUNCS[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound[dtype] = fn
    return fn


def rows_per_cta(n, H=1):
    """(rows per CTA, CTAs) for n rows of a norm with H heads per position:
    whole positions per CTA (a multiple of H), as few as give at most
    ``CTAS`` CTAs."""
    rows = H * max(1, -(-(n // H) // CTAS))
    return rows, (-(-n // rows) if n else 0)


def _segment(name, x, scale, dy, grouped):
    """A segment's tensors after the checks: (x, dy, scale, dx, partial,
    dscale, n, h, rows per CTA, CTAs); a record of more than ``MAX_CHUNKS``
    chunks is refused. x and dy are made contiguous (and copied
    when their data does not start on 16 bytes, which the vector reads
    need). Rows per CTA from ``rows_per_cta``: at most ``CTAS`` CTAs, so
    that one wave fills the card while the fp32 partials (one row of H * D
    per CTA) stay a few percent of the bytes read."""
    if x.dtype not in _C_FUNCS:
        raise TypeError(f"{name} dtype {x.dtype}: the kernel takes float32 "
                        "or bfloat16")
    D = x.shape[-1]
    H = x.shape[-2] if grouped and scale.dim() == 2 and x.dim() >= 2 else 1
    if scale.shape not in ((D,), (H, D)) or scale.dtype != x.dtype \
            or dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{name} {tuple(x.shape)} {x.dtype}: scale "
                         f"{tuple(scale.shape)} {scale.dtype} and dy "
                         f"{tuple(dy.shape)} {dy.dtype} do not match")
    vec = 16 // x.element_size()
    chunks = H * D // (vec if D % vec == 0 else 1)
    if chunks > MAX_CHUNKS:
        raise ValueError(f"{name} {tuple(x.shape)} {x.dtype}: a record of "
                         f"{H} x {D} values is {chunks} chunks, more than "
                         f"the {MAX_CHUNKS} the kernel holds in registers")
    for t in (x, scale, dy):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}, its scale and dy must lie on one CUDA "
                             "device")
    x, dy, scale = (t.contiguous() for t in (x, dy, scale))
    x, dy = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dy))
    n = x.numel() // D if D else 0
    rows, blocks = rows_per_cta(n, H)
    partial = torch.empty((max(blocks, 1), H * D), dtype=torch.float32,
                          device=x.device)
    return (x, dy, scale, torch.empty_like(x), partial,
            torch.empty_like(scale), n, H, rows, blocks)


def _launch(eps, D, a, b=None):
    global launches
    xa, dya, sa, dxa, pa, dsa, na, ha, ra, ba = a
    if b is None:
        args_b = (None,) * 6 + (0, 1, 0)
    else:
        xb, dyb, sb, dxb, pb, dsb, nb, _, rb, bb = b
        args_b = (xb.data_ptr(), dyb.data_ptr(), sb.data_ptr(),
                  dxb.data_ptr(), pb.data_ptr(), dsb.data_ptr(), nb, rb, bb)
    fn = _bind(xa.dtype)
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xa.data_ptr(), dya.data_ptr(), sa.data_ptr(), dxa.data_ptr(),
                 pa.data_ptr(), dsa.data_ptr(), na, ha, ra, ba, *args_b, D,
                 float(eps), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: cudaError_t "
                           f"{err}")
    launches += LAUNCHES_PER_CALL


def rmsnorm_bwd_cuda(x, scale, dy, eps=1e-6):
    """Launch the CUDA backward over the rows of ``x`` ([..., D]; scale
    [D], or [H, D] for x [..., H, D]). Returns (dx, dscale)."""
    seg = _segment("x", x, scale, dy, grouped=True)
    if seg[6] == 0:
        return seg[3], seg[5].zero_()
    _launch(eps, x.shape[-1], seg)
    return seg[3].view(x.shape), seg[5]


def rmsnorm_pair_bwd_cuda(q, q_scale, dq, k, k_scale, dk, eps=1e-6):
    """One call of the CUDA backward over the rows of q then those of k
    (a layer's q_norm and k_norm, each with its own [D] scale). Returns
    (dq_in, dq_scale, dk_in, dk_scale)."""
    if k.dtype != q.dtype or k.shape[-1] != q.shape[-1]:
        raise ValueError("q and k must share D and type")
    a = _segment("q", q, q_scale, dq, grouped=False)
    b = _segment("k", k, k_scale, dk, grouped=False)
    if a[6] == 0 or b[6] == 0:
        # an empty segment: each side alone
        return (*rmsnorm_bwd_cuda(q, q_scale, dq, eps),
                *rmsnorm_bwd_cuda(k, k_scale, dk, eps))
    _launch(eps, q.shape[-1], a, b)
    return a[3].view(q.shape), a[5], b[3].view(k.shape), b[5]
