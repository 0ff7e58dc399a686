"""GQA decode attention against a contiguous cache: the Hopper kernel's
wrapper and its plain PyTorch version.

The kernel (``csrc/decode_attention.cu``, CUDA C++ for sm_90a, shared with
the padded paged decode) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_kernel`` and serves the
dense decode (``models.attention.attn_decode``). It is bound by bytes: each
live K/V element is read once per (sequence, kv head) while the group's g
queries stay in shared memory. In bf16 it runs on the tensor cores
(``mma.sync``): the 64-key tiles of one (sequence, kv head) come through a
``cp.async`` ring, split across 4 warps and across a thread-block cluster
of up to 8 CTAs when the batch is small, and the partial softmax states
merge exactly through distributed shared memory. In fp32 it stays on the
CUDA cores, its warps splitting the key range. Tiles past ``lens`` are
skipped.

Shapes (both functions): q ``[B, Hkv, g, D]``; k/v ``[B, S, Hkv, D]``, the
model's cache layout, read in place; lens ``[B]`` int32, the valid length
including the newly written token. Contract: ``lens >= 1`` (the model
passes ``lens + 1``); at 0 the TPU kernel returns the mean of all values,
the CUDA kernel zeros. Returns ``[B, Hkv, g, D]`` in q's type.
"""
from __future__ import annotations

import ctypes

import torch

from .flash_attention import check_vectors

NEG_INF = -1e30

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def decode_attention_plain(q, k, v, lens, *, bk=512):
    """Plain PyTorch version: the TPU kernel's online softmax over key
    tiles of ``bk`` (all of them, masked by ``kpos < lens``) in fp32, with p
    rounded to v's type before the PV product."""
    B, Hkv, g, D = q.shape
    S = k.shape[1]
    dev = q.device
    scale = D ** -0.5
    qf = q.float()
    ln = lens.long()
    m = torch.full((B, Hkv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, D), dtype=torch.float32, device=dev)
    for k0 in range(0, S, bk):
        kt = k[:, k0:k0 + bk].float().permute(0, 2, 3, 1)   # [B,Hkv,D,n]
        vt = v[:, k0:k0 + bk].permute(0, 2, 1, 3)           # [B,Hkv,n,D]
        s = torch.matmul(qf, kt) * scale                    # [B,Hkv,g,n]
        kpos = k0 + torch.arange(kt.shape[-1], device=dev)
        s = torch.where((kpos[None] < ln[:, None])[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


_C_FUNCS = {torch.float32: "decode_attention_f32",
            torch.bfloat16: "decode_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                        ctypes.c_void_p]


def _bind(dtype):
    from .build import load
    fn = getattr(load("decode_attention"), _C_FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_decode_inputs(q, kv, lens, extra=()):
    """Checks shared by both decode wrappers: q [B, Hkv, g, D] and the
    key/value tensors of q's type (fp32 or bf16) on q's CUDA device,
    contiguous, int32 tensors beside them; ``D`` a multiple of 16 in bf16
    (the tensor cores' depth) or of 8 in fp32, and ``D <= 256`` (``<= 128``
    in fp32, for the tiles to fit in shared memory)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if q.dim() != 4 or lens.shape != (q.shape[0],):
        raise ValueError(f"want q [B,Hkv,g,D] and lens [B], got "
                         f"{tuple(q.shape)}, {tuple(lens.shape)}")
    D = q.shape[3]
    d_multiple = 16 if q.dtype == torch.bfloat16 else 8
    if D % d_multiple or D > (128 if q.dtype == torch.float32 else 256):
        raise ValueError(f"head dim {D}: want D % {d_multiple} == 0 and "
                         "D <= 256 (<= 128 in float32)")
    for name, t in (("q", q), *kv, ("lens", lens), *extra):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, not {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in kv:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        check_vectors(name, t)
    check_vectors("q", q)
    for name, t in (("lens", lens), *extra):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")


def decode_attention_cuda(q, k, v, lens):
    """Launch the CUDA kernel on PyTorch's current stream. Raises on inputs
    it does not take (``check_decode_inputs``) and when the launch fails."""
    global launches
    check_decode_inputs(q, (("k", k), ("v", v)), lens)
    B, Hkv, g, D = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[2:] != (Hkv, D):
        raise ValueError(f"want k, v [B,S,Hkv,D] = [{B},S,{Hkv},{D}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _bind(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lens.data_ptr(), B, k.shape[1], Hkv, g, D, float(D ** -0.5),
                 stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
