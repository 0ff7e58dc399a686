"""RMSNorm: the Hopper kernel's wrapper, its launch plan and its plain
PyTorch version.

The kernel (``csrc/rmsnorm.cu``, CUDA C++ for sm_90a) replaces the Pallas
TPU kernel ``repro.kernels.rmsnorm.rmsnorm_kernel`` and serves every
``layers.rmsnorm`` call of the model (ln1 and ln2 per attention layer, ln1
and the grouped per-head norm per SSD layer, and the final norm) and, in
one launch per attention layer, its q_norm and k_norm (``rmsnorm_pair``).
It computes ``(x·rsqrt(mean(x²)+eps))`` in fp32, casts to x's type, then
multiplies by scale: the cast comes first, as in the reference, and bf16
parity depends on that order. The scale is ``[D]``, or ``[H, D]`` for the
SSD mixer's grouped norm over x ``[..., H, D]``: row r of x then takes
scale row r mod H.

What bounds it on the H100: bytes, 2·N·D elements (x in, y out) plus the
scale; at the decode step's few KB, launch and memory latency. The launch
plan (``launch_plan``) gives each row a power-of-two group of lanes that
read its 16-byte chunks side by side, several rows per warp at D 64 or 128,
from D alone (a row's result does not depend on the batch), and sizes the
CTAs so that the grid fills the card.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

# launches of the CUDA kernel since the count was last set to 0
launches = 0

MAX_THREADS = 256             # the kernel's __launch_bounds__
H100_SMS = 132


class Plan(NamedTuple):
    """How the kernel covers N rows of D: a chunk is ``vec`` elements (16
    bytes, or 1 in the scalar instance); row ``blk * (threads // lanes) + t
    // lanes`` of CTA ``blk`` belongs to threads t of one group of ``lanes``,
    and lane ``t % lanes`` takes its chunks ``lane + k * lanes`` for k <
    ``cpl`` that are below ``D // vec``."""
    vec: int
    lanes: int
    cpl: int
    threads: int
    grid: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=1024)
def launch_plan(n_rows: int, D: int, elt: int, vec: bool = True) -> Plan:
    """The launch plan for ``n_rows`` rows of ``D`` elements of ``elt``
    bytes: 16-byte chunks if ``vec`` (D·elt a multiple of 16 and aligned
    tensors), else single elements.

    * Lanes per row and chunks per lane, from D and the chunk alone, so
      that a row is reduced in the same order at every batch size: a row
      of at most 32 chunks takes one chunk per lane on the next power of
      two of lanes (bf16: 16 lanes at D 128, 8 at D 64, so a warp takes 2
      or 4 rows); a longer row takes a warp, or as many warps as keep each
      lane at 4 chunks or fewer (16 single elements); a row longer than
      256 such lanes hold (fp32 past 4096 elements: qwen-32b's 5120,
      llama-70b's 8192) takes 256 lanes of 8 chunks (32 single elements).
    * CTAs, from the row count: 256 threads (or one row), halved (down to
      one warp, or one row) while the grid would leave some SM without a
      CTA."""
    v = 16 // elt if vec else 1
    if D <= 0 or D % v:
        raise ValueError(f"D {D} is not a whole number of {v}-element chunks")
    chunks, max_cpl = D // v, 4 if vec else 16
    lanes = _pow2_at_least(chunks) if chunks <= 32 else 32
    while _ceil(chunks, lanes) > max_cpl and lanes < MAX_THREADS:
        lanes *= 2
    if _ceil(chunks, lanes) > max_cpl:
        max_cpl *= 2                    # the longest rows: a CTA per row
    if _ceil(chunks, lanes) > max_cpl:
        raise ValueError(f"D {D}: a row of {chunks} chunks needs more than "
                         f"{MAX_THREADS} threads of {max_cpl} chunks")
    cpl = _pow2_at_least(_ceil(chunks, lanes))
    threads = max(256, lanes)
    while threads > max(lanes, 32) \
            and _ceil(n_rows, threads // lanes) < H100_SMS:
        threads //= 2
    return Plan(v, lanes, cpl, threads, max(1, _ceil(n_rows, threads // lanes)))


def rmsnorm_plain(x, scale, eps=1e-6):
    """Plain PyTorch version: ``layers.rmsnorm`` of the reference."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rmsnorm_pair_plain(q, q_scale, k, k_scale, eps=1e-6):
    """Plain version of the pair: two ``rmsnorm_plain`` calls."""
    return rmsnorm_plain(q, q_scale, eps), rmsnorm_plain(k, k_scale, eps)


_C_FUNCS = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_SEG = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2   # x, out, scale, n, stride
# segment a (+ h, blocks), segment b (+ blocks), D, eps, vec, lanes, cpl,
# threads, stream
_ARGTYPES = (_SEG + [ctypes.c_int] * 2 + _SEG + [ctypes.c_int]
             + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
_bound = {}


def _bind(dtype):
    fn = _bound.get(dtype)
    if fn is None:
        from .build import load
        fn = getattr(load("rmsnorm"), _C_FUNCS[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound[dtype] = fn
    return fn


def _rows(name, x, scale, grouped):
    """After the checks: x's rows as (x or an [N, D] view of it, N, row
    stride) and the scale's row count H (1 unless grouped). A contiguous x
    is taken as it is (no view is built: each costs host time)."""
    if x.dtype not in _C_FUNCS:
        raise TypeError(f"{name} dtype {x.dtype}: the kernel takes float32 "
                        "or bfloat16")
    D = x.shape[-1]
    H = x.shape[-2] if grouped and scale.dim() == 2 and x.dim() >= 2 else 1
    if scale.shape not in ((D,), (H, D)) or scale.dtype != x.dtype:
        raise ValueError(f"scale of {name} must be [{D}]"
                         + (f" or [{H}, {D}]" if grouped else "")
                         + f" of {x.dtype} for {tuple(x.shape)}, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if not x.is_cuda or scale.get_device() != x.get_device():
        raise ValueError(f"{name} ({x.device}) and its scale ({scale.device}) "
                         "must lie on one CUDA device")
    if not scale.is_contiguous():
        raise ValueError(f"scale of {name} must be contiguous")
    if x.is_contiguous():
        return x, x.numel() // D if D else 0, D, H
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dimension")
    return x2, x2.shape[0], x2.stride(0), H


def _launch(eps, D, *segs):
    """One launch over one or two segments of rows, each (x, N, row
    stride, out, scale, H): out contiguous, scale [H, D] (H 1 in the second
    segment). Empty segments are dropped. Both segments take one plan, for
    their rows together, and each its own run of CTAs. Kept lean: the
    serving step calls it 109 times (qwen3-8b) on a host-bound path."""
    global launches
    segs = [s for s in segs if s[1]]
    if not segs:
        return
    (x0, n0, st0, y0, s0, h0), *rest = segs
    x1, n1, st1, y1, s1, _ = rest[0] if rest else (None, 0, 0, None, None, 1)
    ptrs = (x0.data_ptr(), y0.data_ptr(), s0.data_ptr())
    ptrs1 = (x1.data_ptr(), y1.data_ptr(), s1.data_ptr()) if n1 else (0, 0, 0)
    elt = x0.element_size()
    v = 16 // elt
    vec = (D % v == 0 and st0 % v == 0 and st1 % v == 0
           and not any(a % 16 for a in ptrs + ptrs1))
    p = launch_plan(n0 + n1, D, elt, vec)
    rows_per_cta = p.threads // p.lanes
    args = (*ptrs, n0, st0, h0, _ceil(n0, rows_per_cta), *ptrs1, n1, st1,
            _ceil(n1, rows_per_cta), D, eps, vec, p.lanes, p.cpl, p.threads)
    fn = _bind(x0.dtype)
    dev = x0.get_device()
    # the raw handle of PyTorch's current stream (as Triton's launcher
    # takes it), without building a Stream object
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError_t {err}")
    launches += 1


def rmsnorm_cuda(x, scale, eps=1e-6):
    """Launch the CUDA kernel on PyTorch's current stream over the rows of
    ``x`` ([..., D]); ``scale`` is [D], or [H, D] for x [..., H, D], of x's
    type, on x's device. Raises on inputs it does not take and when the
    launch fails."""
    x2, n, st, H = _rows("x", x, scale, grouped=True)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch(float(eps), x.shape[-1], (x2, n, st, y, scale, H))
    return y


def rmsnorm_pair_cuda(q, q_scale, k, k_scale, eps=1e-6):
    """One launch of the CUDA kernel over the rows of ``q`` then those of
    ``k`` (both [..., D] of one type and D, on one device), each with its
    own [D] scale: a layer's q_norm and k_norm. Returns (q', k')."""
    if k.dtype != q.dtype or k.shape[-1] != q.shape[-1] \
            or k.get_device() != q.get_device():
        raise ValueError(f"q {tuple(q.shape)} {q.dtype} on {q.device} and k "
                         f"{tuple(k.shape)} {k.dtype} on {k.device} must share "
                         "D, type and device")
    q2, nq, sq, _ = _rows("q", q, q_scale, grouped=False)
    k2, nk, sk, _ = _rows("k", k, k_scale, grouped=False)
    yq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    yk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    _launch(float(eps), q.shape[-1], (q2, nq, sq, yq, q_scale, 1),
            (k2, nk, sk, yk, k_scale, 1))
    return yq, yk
