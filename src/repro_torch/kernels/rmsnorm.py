"""RMSNorm: the Triton kernel's wrapper and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``repro.kernels.rmsnorm.
rmsnorm_kernel`` and serves every ``layers.rmsnorm`` call of the model
(ln1, ln2, q_norm, k_norm per attention layer, ln1 and the grouped per-head
norm per SSD layer, and the final norm). It computes
``(x·rsqrt(mean(x²)+eps))`` in fp32, casts to x's type, then multiplies by
scale: the cast comes first, as in the reference, and bf16 parity depends
on that order. The scale is ``[D]``, or ``[H, D]`` for the SSD mixer's
grouped norm over x ``[..., H, D]``: row r of x then takes scale row r mod H.

What bounds it on the H100: bytes, 2·N·D elements (x in, y out) plus the
scale; a few flops per element and no tensor cores. One program per row
loads the row once into registers at a masked power-of-two width (up to
4096 and beyond), reduces it, and writes it once, so it moves the minimum
bytes. Triton is imported at first launch, never at import.
"""
from __future__ import annotations

import torch

# launches of the Triton kernel since the count was last set to 0
launches = 0

_jit = None
tl = None       # triton.language, bound at first launch


def _rmsnorm_rows(X, S, Y, D, H, stride_x, stride_y, eps,
                  BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(X + row * stride_x + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / D
    y = (x * tl.rsqrt(var + eps)).to(Y.dtype.element_ty)
    s = tl.load(S + (row % H) * D + cols, mask=mask, other=0.0)
    # the product of two values of x's type, rounded once to that type
    out = (y.to(tl.float32) * s.to(tl.float32)).to(Y.dtype.element_ty)
    tl.store(Y + row * stride_y + cols, out, mask=mask)


def _kernel():
    global _jit, tl
    if _jit is None:
        import triton
        import triton.language as tl
        _jit = triton.jit(_rmsnorm_rows)
    return _jit


def rmsnorm_plain(x, scale, eps=1e-6):
    """Plain PyTorch version: ``layers.rmsnorm`` of the reference."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rmsnorm_cuda(x, scale, eps=1e-6):
    """Launch the Triton kernel on PyTorch's current stream over the rows
    of ``x`` ([..., D]); ``scale`` is [D], or [H, D] for x [..., H, D], of
    x's type, on x's device."""
    global launches
    import triton
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    D = x.shape[-1]
    H = x.shape[-2] if scale.dim() == 2 and x.dim() >= 2 else 1
    if scale.shape not in ((D,), (H, D)) or scale.dtype != x.dtype:
        raise ValueError(f"scale must be [{D}] or [{H}, {D}] of {x.dtype} "
                         f"for x {tuple(x.shape)}, got {tuple(scale.shape)} "
                         f"{scale.dtype}")
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"x ({x.device}) and scale ({scale.device}) must lie "
                         "on one CUDA device")
    if not scale.is_contiguous():
        raise ValueError("scale must be contiguous")
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        raise ValueError("x must be contiguous in its last dimension")
    y = torch.empty((x2.shape[0], D), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y.reshape(x.shape)
    block = triton.next_power_of_2(D)
    with torch.cuda.device(x.device):
        _kernel()[(x2.shape[0],)](x2, scale, y, D, H, x2.stride(0),
                                  y.stride(0), float(eps), BLOCK=block,
                                  num_warps=min(max(block // 256, 1), 16))
    launches += 1
    return y.reshape(x.shape)
