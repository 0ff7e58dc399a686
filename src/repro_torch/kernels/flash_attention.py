"""Flash (prefill) GQA attention: the Hopper kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for sm_90a) replaces the
Pallas TPU kernel ``repro.kernels.flash_attention.flash_attention_kernel``
and serves the dense prefill (``models.attention.attn_prefill``): a chunk of
queries against its whole cache row, read in place. Operations bound it
for long sequences, bytes for a short chunk against a long cache. One CTA
per (sequence·kv head, tile of query positions) carries the tile's
positions times the group's heads, so each K/V tile is staged in shared
memory once for the whole group. Two instances: bf16 on the tensor cores
(``mma.sync``, K/V staged by ``cp.async`` in a two-stage ring), fp32 on
the CUDA cores (its 1e-4 contract rules out TF32); the source note says
more.

Shapes (both functions): q ``[B, Sq, Hq, D]``, k/v ``[B, Skv, Hkv, D]``,
``Hq % Hkv == 0`` (query head n reads kv head ``n // g``); q_offsets ``[B]``
int32, the global position of each row's first query. With ``causal``,
query i of row b sees keys ``kpos <= q_offsets[b] + i``; with q_offsets all
zero this is the TPU kernel's mask. Returns ``[B, Sq, Hq, D]`` in q's type.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def flash_attention_plain(q, k, v, q_offsets, *, causal=True, bk=128,
                          return_lse=False):
    """Plain PyTorch version: the TPU kernel's online softmax over key
    tiles of ``bk`` in fp32, vectorised over rows, heads and queries. Scores
    are scaled after the dot (as the kernel does, not q before it) and p is
    rounded to v's type before the PV product. With ``return_lse`` it also
    returns each row's log-sum-exp of the scaled scores, fp32 [B, Hq, Sq],
    which the backward reads."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    scale = D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, g, D).permute(0, 2, 3, 1, 4)  # [B,Hkv,g,Sq,D]
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=dev)[None]
    m = torch.full((B, Hkv, g, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=torch.float32, device=dev)
    for k0 in range(0, Skv, bk):
        kt = k[:, k0:k0 + bk].float().permute(0, 2, 3, 1)[:, :, None]  # [B,Hkv,1,D,n]
        vt = v[:, k0:k0 + bk].permute(0, 2, 1, 3)[:, :, None]          # [B,Hkv,1,n,D]
        s = torch.matmul(qf, kt) * scale                              # [B,Hkv,g,Sq,n]
        if causal:
            kpos = k0 + torch.arange(kt.shape[-1], device=dev)
            msk = kpos[None, None] <= qpos[:, :, None]                # [B,Sq,n]
            s = torch.where(msk[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    out = acc / l.clamp(min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l.clamp(min=1e-30)))[..., 0].reshape(B, Hq, Sq)
    return out, lse


_C_FUNCS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                        ctypes.c_void_p]


def _bind(dtype):
    from .build import load
    fn = getattr(load("flash_attention"), _C_FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_vectors(name, t):
    """The kernels read 16-byte vectors along the head dim: it must be
    contiguous, and the base and the other strides 16-byte aligned."""
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 \
            or any(s % vec for s in t.stride()[:-1]):
        raise ValueError(f"{name} must have a contiguous head dim and "
                         f"16-byte aligned rows (strides {t.stride()})")


def flash_attention_cuda(q, k, v, q_offsets, *, causal=True,
                         return_lse=False):
    """Launch the CUDA kernel on PyTorch's current stream. q, k, v in fp32
    or bf16 on one CUDA device, any strides with a contiguous head dim
    (``D <= 256``, a multiple of 8 in fp32 and of 16 in bf16, the tensor
    cores' depth; ``Hq / Hkv <= 64``), k and v with equal strides;
    q_offsets int32 ``[B]``. With ``return_lse`` the kernel's training
    instance also writes each row's log-sum-exp, fp32 [B, Hq, Sq], and
    ``(out, lse)`` is returned; without it the serving instance runs.
    Raises on anything else and when the launch fails."""
    global launches
    if q.dtype not in _C_FUNCS:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError("want q [B,Sq,Hq,D] and k, v [B,Skv,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    step = 16 if q.dtype == torch.bfloat16 else 8
    if Hq % Hkv or Hq // Hkv > 64 or D % step or D > 256:
        raise ValueError(f"Hq {Hq}, Hkv {Hkv}, D {D}: want Hq % Hkv == 0, "
                         f"Hq / Hkv <= 64, D % {step} == 0 and D <= 256 "
                         f"for {q.dtype}")
    if k.stride() != v.stride():
        raise ValueError(f"k and v strides differ: {k.stride()}, {v.stride()}")
    if q_offsets.shape != (B,) or q_offsets.dtype != torch.int32:
        raise ValueError(f"q_offsets must be int32 [{B}]")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_offsets", q_offsets)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, not {t.device}")
        if name != "q_offsets":
            if t.dtype != q.dtype:
                raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
            check_vectors(name, t)
    if not q_offsets.is_contiguous():
        raise ValueError("q_offsets must be contiguous")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or Skv == 0:
        if return_lse:
            return out.zero_(), lse.fill_(-1e30)
        return out.zero_()
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, out)
                                        for s in t.stride()[:3]))
    fn = _bind(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 q_offsets.data_ptr(), ctypes.addressof(strides), B, Sq, Skv,
                 Hq, Hkv, D, int(bool(causal)), float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return (out, lse) if return_lse else out
