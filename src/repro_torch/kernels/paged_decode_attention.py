"""Padded paged GQA decode attention: the Hopper kernel's wrapper and its
plain PyTorch version.

The kernel (the paged instance of ``csrc/decode_attention.cu``) replaces
the Pallas TPU kernel
``repro.kernels.paged_decode_attention.paged_decode_attention_kernel``: the
decode recurrence streamed through the block table, masked by ``lens``. The
TPU kernel walks ALL ``nmax`` blocks of every sequence; that padded walk is
what makes it the baseline against which the ragged kernel
(``paged_ragged_attention``, which reads only a row's live blocks) is held
at ``C == 1``, and the serving path runs the ragged kernel. The reference's
benchmark of padded against ragged stays in ``repro``. Here, in bf16, the
kernel is the dense decode's tensor-core tile (``mma.sync``, a ``cp.async``
ring, the key walk split over a thread-block cluster) gathering each 64-key
tile's rows through the table, and it skips tiles past ``lens``: exact for
``lens >= 1``, since a wholly masked tile adds ``exp(NEG_INF - m) = 0``. In
fp32 it stays on the CUDA cores and walks every block.

Shapes (both functions): q ``[B, Hkv, g, D]``; k_pool/v_pool
``[num_blocks, bs, Hkv, D]``; block_tables ``[B, nmax]`` int32 (0 = the null
block); lens ``[B]`` int32 >= 1, including the newly written token.
Returns ``[B, Hkv, g, D]`` in q's type.
"""
from __future__ import annotations

import ctypes

import torch

from .decode_attention import check_decode_inputs

NEG_INF = -1e30

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lens):
    """Plain PyTorch version: the TPU kernel's grid over every block of the
    table, one online-softmax step per block in fp32, masked by
    ``kpos < lens``, p rounded to the value type before the PV product."""
    B, Hkv, g, D = q.shape
    bs = k_pool.shape[1]
    nmax = block_tables.shape[1]
    dev = q.device
    scale = D ** -0.5
    qf = q.float()
    bt = block_tables.long()
    ln = lens.long()
    m = torch.full((B, Hkv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, D), dtype=torch.float32, device=dev)
    for ib in range(nmax):
        blk = bt[:, ib]
        kt = k_pool[blk].float().permute(0, 2, 3, 1)        # [B,Hkv,D,bs]
        vt = v_pool[blk].permute(0, 2, 1, 3)                # [B,Hkv,bs,D]
        s = torch.matmul(qf, kt) * scale                    # [B,Hkv,g,bs]
        kpos = ib * bs + torch.arange(bs, device=dev)
        s = torch.where((kpos[None] < ln[:, None])[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v_pool.dtype).float(), vt.float())
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


_C_FUNCS = {torch.float32: "paged_decode_attention_f32",
            torch.bfloat16: "paged_decode_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                        ctypes.c_void_p]


def _bind(dtype):
    from .build import load
    fn = getattr(load("decode_attention"), _C_FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, lens):
    """Launch the CUDA kernel on PyTorch's current stream. Raises on inputs
    it does not take (``check_decode_inputs``) and when the launch fails."""
    global launches
    check_decode_inputs(q, (("k_pool", k_pool), ("v_pool", v_pool)), lens,
                        (("block_tables", block_tables),))
    B, Hkv, g, D = q.shape
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or k_pool.shape[2:] != (Hkv, D):
        raise ValueError(f"want pools [nb,bs,{Hkv},{D}], got "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"want block_tables [{B}, nmax], got "
                         f"{tuple(block_tables.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _bind(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), block_tables.data_ptr(), lens.data_ptr(), B,
                 Hkv, g, D, k_pool.shape[1], block_tables.shape[1],
                 float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
