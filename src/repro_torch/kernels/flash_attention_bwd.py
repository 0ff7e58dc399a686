"""The backward of flash (prefill) GQA attention: the Hopper kernel's
wrapper and its plain PyTorch version.

Training runs attention through the flash kernel (``flash_attention.py``),
so that kernel needs a gradient: ``ops.FlashAttention`` is the
``torch.autograd.Function`` whose forward saves the rows' log-sum-exp and
whose backward is this. The kernel (``csrc/flash_attention_bwd.cu``, CUDA
C++ for sm_90a) follows FlashAttention-2 over the saved fp32 log-sum-exp in
three launches (delta = rowsum(dO * O); dK and dV per key tile, the
group's g heads summed in the CTA; dQ per query tile). It replaces no TPU
kernel of its own (the reference differentiates its jnp attention); the
source note says more. No atomics: two runs give bitwise equal gradients.

What bounds it on the H100: operations (five products of Sq x Skv x D per
head; the kernel computes seven, since dQ's launch recomputes S and dP to
need no atomics). ``design`` picks the kernels by type and shape alone:

- ``"wgmma"``: bf16 with D 64 or 128 (every trainable arch), any group up
  to 64: warpgroup products (``wgmma``) on tiles that TMA brings into
  shared memory through an ``mbarrier`` ring, a producer warp feeding
  consumer warpgroups (``csrc/hopper.cuh``);
- ``"mma"``: every other bf16 D (a multiple of 16 up to 256): ``mma.sync``
  over ``cp.async`` tiles (``csrc/mma_attention_tile.cuh``);
- ``"fp32"``: fp32 on the CUDA cores (the 1e-4 contract TF32 would miss).

Shapes: q, out, dout ``[B, Sq, Hq, D]``, k, v ``[B, Skv, Hkv, D]``, lse
fp32 ``[B, Hq, Sq]``, q_offsets int32 ``[B]``; returns ``(dq, dk, dv)`` in
the inputs' types.
"""
from __future__ import annotations

import ctypes

import torch

from .flash_attention import NEG_INF

# kernel launches of the CUDA backward since the count was last set to 0:
# LAUNCHES_PER_CALL a call in every design (delta, dK/dV, dQ)
launches = 0
LAUNCHES_PER_CALL = 3
DESIGNS = ("wgmma", "mma", "fp32")


def design(dtype, D, g) -> str:
    """The kernels a call of this type, head dim D and group size g (Hq /
    Hkv) launches: one of ``DESIGNS`` (see the module note). Chosen by type
    and shape alone, never on a failure."""
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if D in (64, 128) and g <= 64 else "mma"


def flash_attention_bwd_plain(q, k, v, out, lse, dout, q_offsets, *,
                              causal=True):
    """Plain PyTorch version in fp32: P recomputed with the forward's
    convention (the score scaled after the dot, ``p = exp(s - lse)``,
    masked keys 0), ``dS = P (dP - rowsum(dO O))``, and P and dS rounded to
    the inputs' type before their products, as the kernel rounds them."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    scale = D ** -0.5

    def heads(t):                                   # [B, Hkv, g, Sq, D]
        return t.float().reshape(B, Sq, Hkv, g, D).permute(0, 2, 3, 1, 4)

    qf, of, dof = heads(q), heads(out), heads(dout)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, Skv, D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale   # [B,Hkv,g,Sq,Skv]
    if causal:
        qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=dev)[None]
        kpos = torch.arange(Skv, device=dev)
        msk = kpos[None, None] <= qpos[:, :, None]           # [B, Sq, Skv]
        s = torch.where(msk[:, None, None], s, NEG_INF)
    p = torch.exp(s - lse.reshape(B, Hkv, g, Sq)[..., None])
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof).sum(2)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(2) * scale
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


_C_FUNCS = {"fp32": "flash_attention_bwd_f32",
            "mma": "flash_attention_bwd_bf16",
            "wgmma": "flash_attention_bwd_bf16_wgmma"}
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                         ctypes.c_void_p]
_bound = {}


def _bind(kind):
    fn = _bound.get(kind)
    if fn is None:
        from .build import load
        fn = getattr(load("flash_attention_bwd"), _C_FUNCS[kind])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound[kind] = fn
    return fn


def _aligned(t):
    """t itself, or a copy when its data does not start on 16 bytes (the
    vector reads and TMA need it; a fresh allocation always does)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, q_offsets, *,
                             causal=True):
    """Launch the CUDA backward on PyTorch's current stream: q, k, v, out,
    dout in fp32 or bf16 on one CUDA device (made contiguous here), ``D <=
    256`` (a multiple of 4 in fp32, of 16 in bf16), ``Hq / Hkv <= 64``; lse
    fp32 [B, Hq, Sq]. The kernels are ``design``'s. Raises on anything else
    and when a launch fails."""
    global launches
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}")
    step = 16 if q.dtype == torch.bfloat16 else 4
    if Hq % Hkv or Hq // Hkv > 64 or D % step or D > 256:
        raise ValueError(f"Hq {Hq}, Hkv {Hkv}, D {D}: want Hq % Hkv == 0, "
                         f"Hq / Hkv <= 64, D % {step} == 0 and D <= 256")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [{B}, {Hq}, {Sq}]")
    if q_offsets.shape != (B,) or q_offsets.dtype != torch.int32:
        raise ValueError(f"q_offsets must be int32 [{B}]")
    ts = [t.contiguous() for t in (q, k, v, out, dout, lse, q_offsets)]
    for name, t in zip(("q", "k", "v", "out", "dout", "lse", "q_offsets"),
                       ts):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, not {t.device}")
        if name in ("k", "v", "out", "dout") and t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    q, k, v, out, dout, lse, q_offsets = ts
    kind = design(q.dtype, D, Hq // Hkv)
    if kind != "fp32":
        q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    fn = _bind(kind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 q_offsets.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
                 float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError_t {err}")
    launches += LAUNCHES_PER_CALL
    return dq, dk, dv
