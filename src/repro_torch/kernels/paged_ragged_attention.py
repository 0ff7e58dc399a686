"""Work-proportional ragged paged GQA attention: the Hopper kernel's
wrapper, its plain PyTorch version, and the materialized-gather oracle.

The kernel (``csrc/paged_ragged_attention.cu``, CUDA C++ for sm_90a)
replaces the Pallas TPU kernel
``repro.kernels.paged_ragged_attention.paged_ragged_attention_kernel``. It is
bound by bytes on the H100: the live K/V blocks, q and out. One CTA per
(sequence·kv head, tile of up to 64 query rows, position-major) stages each
64-key tile once in shared memory for all its rows, so the query group is
broadcast and KV is never expanded; skipped blocks, key tiles past the
tile's last query and tiles of padding columns are never read. Two
instances: bf16 on the tensor cores (``mma.sync``, ``cp.async`` ring; the
warps of a decode tile split the keys and merge), fp32 on the CUDA cores.
The source note in the ``.cu`` file says more.

Shapes (all three functions): q ``[B, Hkv, g, C, D]``, C ragged query
columns per sequence (column c sits at global position
``ctx_lens[b] - q_lens[b] + c``; columns >= q_lens[b] are padding, their
output finite but unspecified); k_pool/v_pool ``[num_blocks, bs, Hkv, D]``;
block_tables ``[B, nmax]`` (0 = null block); q_lens/ctx_lens ``[B]``.
ctx_lens may exceed ``nmax*bs`` when padding columns overhang the table:
positions past the table are absent. Returns ``[B, Hkv, g, C, D]`` in q's
type.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def _window_lo_block(ctx, q_len, bs, window):
    """First block holding an in-window key for the earliest real column
    (global position ``ctx - q_len``); blocks below it are masked for every
    real column, so skipping them is exact."""
    return (ctx - q_len - window + 1).clamp(min=0) // bs


def paged_ragged_attention_plain(q, k_pool, v_pool, block_tables, q_lens,
                                 ctx_lens, *, window=0, soft_cap=0.0):
    """Plain PyTorch version of the kernel: the same block loop, skip rule,
    masks and online softmax in fp32, vectorised over sequences, heads and
    query rows. A skipped block leaves the state unchanged through
    ``torch.where`` (the reference's ``lax.cond``); products take bf16
    inputs exactly in fp32, and p is rounded to the value type before the
    PV sum, as the TPU kernel does."""
    B, Hkv, g, C, D = q.shape
    bs = k_pool.shape[1]
    nmax = block_tables.shape[1]
    dev = q.device
    scale = D ** -0.5
    bt = block_tables.long()
    ql = q_lens.long()
    ctx = ctx_lens.long()
    R = g * C
    qf = q.reshape(B, Hkv, R, D).float()
    nblk = ((ctx + bs - 1) // bs).clamp(1, nmax)
    lo = _window_lo_block(ctx, ql, bs, window) if window \
        else torch.zeros_like(ctx)
    # row r of the flattened [g*C] axis is ragged column r % C
    qpos = (ctx - ql)[:, None] + (torch.arange(R, device=dev) % C)[None]
    m = torch.full((B, Hkv, R, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, R, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, R, D), dtype=torch.float32, device=dev)
    for ib in range(nmax):
        live = (ib < nblk) & (ctx > 0) & (ib >= lo)                  # [B]
        if not bool(live.any()):
            continue
        blk = bt[:, ib]
        k = k_pool[blk].permute(0, 2, 1, 3).float()                  # [B,Hkv,bs,D]
        v = v_pool[blk].permute(0, 2, 1, 3)
        s = torch.matmul(qf, k.transpose(-1, -2)) * scale            # [B,Hkv,R,bs]
        if soft_cap:
            s = soft_cap * torch.tanh(s / soft_cap)
        kpos = ib * bs + torch.arange(bs, device=dev)
        msk = (kpos[None, None] <= qpos[:, :, None]) \
            & (kpos[None, None] < ctx[:, None, None])                # [B,R,bs]
        if window:
            msk &= kpos[None, None] > qpos[:, :, None] - window
        s = torch.where(msk[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1, keepdim=True)
        acc_new = acc * corr + torch.matmul(p.to(v.dtype).float(), v.float())
        sel = live[:, None, None, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel, acc_new, acc)
    out = acc / l.clamp(min=1e-30)
    return out.to(q.dtype).reshape(B, Hkv, g, C, D)


def _paged_gather(pool, block_tables):
    """Logical contiguous view ``[B, nmax*bs, Hkv, D]`` of each sequence's
    blocks. Out-of-range table ids clamp to the last physical block
    (deterministic data that the length mask hides)."""
    B, nmax = block_tables.shape
    ids = block_tables.long().clamp(0, pool.shape[0] - 1)
    return pool[ids].reshape(B, nmax * pool.shape[1], pool.shape[2],
                             pool.shape[3])


def paged_ragged_attention_gather(q, k_pool, v_pool, block_tables, q_lens,
                                  ctx_lens, *, window=0, soft_cap=0.0):
    """Oracle: gather every sequence's blocks into a contiguous view and
    run dense masked attention over all ``nmax*bs`` positions in fp32. The
    O(B·nmax) path the kernel replaces, kept for tests only. Rows with
    ``ctx == 0`` give zeros, as the kernel defines them."""
    B, Hkv, g, C, D = q.shape
    kg = _paged_gather(k_pool, block_tables).float()      # [B, L, Hkv, D]
    vg = _paged_gather(v_pool, block_tables)
    L = kg.shape[1]
    dev = q.device
    ql = q_lens.long()
    ctx = ctx_lens.long()
    qs = (q.float() * D ** -0.5).reshape(B, Hkv, g * C, D)
    s = torch.matmul(qs, kg.permute(0, 2, 3, 1))           # [B,Hkv,gC,L]
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    qpos = (ctx - ql)[:, None] + torch.arange(C, device=dev)[None]   # [B,C]
    kpos = torch.arange(L, device=dev)
    msk = (kpos[None, None] < ctx[:, None, None]) \
        & (kpos[None, None] <= qpos[:, :, None])                     # [B,C,L]
    if window:
        msk &= kpos[None, None] > qpos[:, :, None] - window
    msk = msk[:, None, None].expand(B, Hkv, g, C, L).reshape(B, Hkv, g * C, L)
    s = torch.where(msk, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(vg.dtype).float(), vg.permute(0, 2, 1, 3).float())
    out = torch.where((ctx > 0)[:, None, None, None], out, 0.0)
    return out.to(q.dtype).reshape(B, Hkv, g, C, D)


_C_FUNCS = {torch.float32: "paged_ragged_attention_f32",
            torch.bfloat16: "paged_ragged_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def _bind(dtype):
    from .build import load
    fn = getattr(load("paged_ragged_attention"), _C_FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def paged_ragged_attention_cuda(q, k_pool, v_pool, block_tables, q_lens,
                                ctx_lens, *, window=0, soft_cap=0.0):
    """Launch the CUDA kernel on PyTorch's current stream. Takes q and the
    pools in fp32 or bf16, contiguous and 16-byte aligned, on one CUDA
    device, with ``D <= 256`` a multiple of 4 in fp32 and of 16 in bf16
    (the tensor cores' depth); the int inputs as int32. Raises on anything
    else and when the launch fails. Padding columns (``c >= q_lens[b]``)
    come back as zeros."""
    global launches
    if q.dtype not in _C_FUNCS:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if q.dim() != 5 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError("want q [B,Hkv,g,C,D] and pools [nb,bs,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, Hkv, g, C, D = q.shape
    bs = k_pool.shape[1]
    if k_pool.shape[2:] != (Hkv, D):
        raise ValueError(f"pool heads/dim {tuple(k_pool.shape[2:])} != "
                         f"q's {(Hkv, D)}")
    step = 16 if q.dtype == torch.bfloat16 else 4
    if D > 256 or D % step:
        raise ValueError(f"head dim {D}: want D <= 256 and D % {step} == 0 "
                         f"for {q.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or q_lens.shape != (B,) or ctx_lens.shape != (B,):
        raise ValueError("want block_tables [B, nmax], q_lens and ctx_lens "
                         f"[B] with B={B}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "q_lens": q_lens,
               "ctx_lens": ctx_lens}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, not {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("q", "k_pool", "v_pool") and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name in ("block_tables", "q_lens", "ctx_lens") \
                and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _bind(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), block_tables.data_ptr(), q_lens.data_ptr(),
                 ctx_lens.data_ptr(), B, Hkv, g, C, D, bs,
                 block_tables.shape[1], int(window), float(soft_cap),
                 float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"paged_ragged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
