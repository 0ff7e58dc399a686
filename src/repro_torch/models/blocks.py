"""Pre-norm residual blocks (counterpart of ``repro.models.blocks``) for the
port's layer kinds: ``"attn"`` (attention + the MLP of ``cfg.act``),
``"local"`` (the same with sliding-window attention over a ring cache of
``min(s_max, local_window)`` rows), ``"moe"`` (the attention + the
Mixture-of-Experts FFN), ``"rglru"`` (the RG-LRU mixer + the MLP),
``"ssd"`` (the Mamba-2 mixer alone, no ln2 and no FFN), and whisper's
``"enc"`` (non-causal rope-free self-attention with no cache + the MLP)
and ``"dec"`` (rope-free causal self-attention on the dense cache, then
``lnx`` and cross attention over the encoder's output, + the MLP). The
norms are ``cfg.norm``'s (RMSNorm, or LayerNorm with a bias). A config
with ``mla`` takes multi-head latent attention (``models.mla``) in place
of GQA attention in the ``attn`` and ``moe`` kinds; its layers keep the
dense latent cache and never page. Only ``attn`` and ``moe`` layers of
GQA attention page."""
from __future__ import annotations

from torch import nn

from repro_torch.parallel import Layout, Shard
from . import attention as A
from . import mla as M
from . import moe as MOE
from . import recurrent as R
from . import ssd as S
from .layers import MLP, make_norm, mlp_apply


def _attention(cfg, lay, dtype, device, shard):
    """The attention half: MLA for a config with ``mla``, else GQA."""
    cls = M.MLA if cfg.mla is not None else A.Attention
    return cls(cfg, lay, dtype, device, shard)


class Block(nn.Module):
    kind = "attn"

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        shard = shard or Shard(lay)
        self.ln1 = make_norm(cfg, dtype, device)
        self.attn = _attention(cfg, lay, dtype, device, shard)
        self.ln2 = make_norm(cfg, dtype, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype, device, shard, cfg.act)

    def reset_parameters(self, generator):
        self.ln1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.ln2.reset_parameters()
        self.ffn.reset_parameters(generator)


class LocalBlock(Block):
    """GQA attention over a sliding window of ``cfg.local_window`` keys
    (the ring cache) and the MLP."""
    kind = "local"

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        if cfg.mla is not None:
            raise NotImplementedError("a local layer with MLA")
        super().__init__(cfg, lay, dtype, device, shard)


class RGLRUBlock(nn.Module):
    """The RG-LRU mixer and the MLP, each behind its own norm."""
    kind = "rglru"

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        shard = shard or Shard(lay)
        self.ln1 = make_norm(cfg, dtype, device)
        self.mix = R.RGLRU(cfg, lay, dtype, device, shard)
        self.ln2 = make_norm(cfg, dtype, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype, device, shard, cfg.act)

    def reset_parameters(self, generator):
        self.ln1.reset_parameters()
        self.mix.reset_parameters(generator)
        self.ln2.reset_parameters()
        self.ffn.reset_parameters(generator)


class MoEBlock(Block):
    """The attention block's attention half and the MoE FFN."""
    kind = "moe"

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        nn.Module.__init__(self)
        shard = shard or Shard(lay)
        self.ln1 = make_norm(cfg, dtype, device)
        self.attn = _attention(cfg, lay, dtype, device, shard)
        self.ln2 = make_norm(cfg, dtype, device)
        self.ffn = MOE.MoE(cfg, lay, dtype, device, shard)


class SSDBlock(nn.Module):
    kind = "ssd"

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__()
        self.ln1 = make_norm(cfg, dtype, device)
        self.mix = S.SSD(cfg, lay, dtype, device, shard or Shard(lay))

    def reset_parameters(self, generator):
        self.ln1.reset_parameters()
        self.mix.reset_parameters(generator)


class EncBlock(Block):
    """A whisper encoder layer: non-causal rope-free self-attention over
    the rank's frames (no cache) and the MLP."""
    kind = "enc"


class DecBlock(Block):
    """A whisper decoder layer: rope-free causal self-attention on the
    dense cache, then ``lnx`` and cross attention (``cross``, a second
    attention's parameters) over the encoder's output, then the MLP."""
    kind = "dec"

    def __init__(self, cfg, lay: Layout, dtype, device, shard: Shard = None):
        super().__init__(cfg, lay, dtype, device, shard)
        self.lnx = make_norm(cfg, dtype, device)
        self.cross = A.Attention(cfg, lay, dtype, device, self.attn.shard)

    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        self.lnx.reset_parameters()
        self.cross.reset_parameters(generator)


BLOCKS = {"attn": Block, "local": LocalBlock, "moe": MoEBlock,
          "rglru": RGLRUBlock, "ssd": SSDBlock, "enc": EncBlock,
          "dec": DecBlock}


def _ffn(p, h2):
    """The FFN half: the MoE layer's routed experts, or the MLP.
    h2: [B, S, d]."""
    if p.kind == "moe":
        return MOE.moe_apply(p.ffn, h2)[0]
    return mlp_apply(p.ffn, h2)


def block_paged_cache_init(kind, cfg, lay: Layout, num_blocks: int,
                           block_size: int):
    """Shape of one layer's K (and V) block pool. Only GQA attention layers
    (``attn`` and ``moe``) page; SSD and RG-LRU layers keep per-sequence
    recurrent state, a local layer a ring and an MLA layer a latent, so a
    config with one keeps the contiguous cache."""
    if kind in ("attn", "moe") and cfg.mla is None:
        return A.paged_cache_init(cfg, lay, num_blocks, block_size)
    raise ValueError(f"layer kind {kind!r} does not support a paged cache")


def block_encode(p, x, cfg):
    """One encoder layer. x: [B, S_loc, d], the rank's frames."""
    x = x + A.enc_attn(p.attn, p.ln1(x), cfg)
    return x + _ffn(p, p.ln2(x))


def block_prefill(p, x, cache, ctx, cfg):
    """x: [B, S, d]; ctx: dict(positions, offsets, q_lens, block_tables,
    enc_out). One layer of a prefill-shaped step, dispatched by the
    layer's kind as the reference's ``block_prefill``. An attention
    layer's ``cache`` is its (K, V) pools or dense caches: ``q_lens`` ->
    the mixed paged step, block tables alone -> the paged chunked prefill,
    neither -> the dense cache. A local layer's is its ring (K, V). A
    decoder layer's is its self (K, V) and its cross (K, V), which it
    rewrites from ``enc_out`` (the reference's ``init_cross``, set in
    every prefill step). An SSD layer's is its ``SSDState``, an RG-LRU
    layer's its ``RGLRUState``, an MLA layer's its latent cache. The cache
    is updated in place."""
    h = p.ln1(x)
    if p.kind == "dec":
        k_cache, v_cache, cross_k, cross_v = cache
        x = x + A.attn_prefill(p.attn, h, k_cache, v_cache, ctx["offsets"],
                               cfg, rope=False)
        hx = p.lnx(x)
        A.cross_kv_prefill(p.cross, ctx["enc_out"], cross_k, cross_v, cfg)
        x = x + A.cross_attend(p.cross, hx, cross_k, cross_v, cfg)
        return x + _ffn(p, p.ln2(x))
    if p.kind == "ssd":
        return x + S.ssd_prefill(p.mix, h, cache, cfg)
    if p.kind == "rglru":
        x = x + R.rglru_prefill(p.mix, h, cache, cfg)
        return x + _ffn(p, p.ln2(x))
    if p.kind == "local":
        x = x + A.attn_prefill(p.attn, h, *cache, ctx["offsets"], cfg,
                               window=cfg.local_window)
        return x + _ffn(p, p.ln2(x))
    if cfg.mla is not None:
        x = x + M.mla_prefill(p.attn, h, cache, ctx["offsets"], cfg)
        return x + _ffn(p, p.ln2(x))
    k_cache, v_cache = cache
    if ctx.get("q_lens") is not None:
        a = A.paged_attn_mixed(p.attn, h, k_cache, v_cache, ctx["positions"],
                               ctx["offsets"], ctx["q_lens"],
                               ctx["block_tables"], cfg)
    elif ctx.get("block_tables") is not None:
        a = A.paged_attn_prefill(p.attn, h, k_cache, v_cache,
                                 ctx["positions"], ctx["offsets"],
                                 ctx["block_tables"], cfg)
    else:
        a = A.attn_prefill(p.attn, h, k_cache, v_cache, ctx["offsets"], cfg)
    x = x + a
    return x + _ffn(p, p.ln2(x))


def block_train(p, x, pos, cfg):
    """One layer of training's forward (the reference's ``block_prefill``
    with ``train=True`` and no cache). x: [B, S_loc, d]; pos [B, S] the
    chunk's global positions. Returns (x, aux): an ``attn`` layer's FFN is
    the dense MLP and its aux 0.0; a ``moe`` layer's is ``moe_apply`` with
    ``train=True`` (the routed and the shared experts) and its aux the
    load-balance loss; a config with ``mla`` attends through MLA
    (``mla_train``), else through GQA attention; an ``ssd`` layer is the
    mixer alone (``ssd_train``; no ln2, no FFN) and its aux 0.0.
    ``transformer.check_trainable`` names the kinds that do not train."""
    if p.kind == "ssd":
        return x + S.ssd_train(p.mix, p.ln1(x), cfg), 0.0
    if cfg.mla is not None:
        x = x + M.mla_train(p.attn, p.ln1(x), cfg)
    else:
        x = x + A.attn_train(p.attn, p.ln1(x), pos, cfg)
    if p.kind == "moe":
        f, aux = MOE.moe_apply(p.ffn, p.ln2(x), train=True)
        return x + f, aux
    return x + mlp_apply(p.ffn, p.ln2(x)), 0.0


def block_decode(p, x, cache, ctx, cfg):
    """x: [B_loc, d], this rank's segment of its dp row's batch; ctx:
    dict(lens, block_tables), the row's. One layer of a decode step: an
    SSD or RG-LRU layer steps its state; a local layer its ring; a decoder
    layer its self cache, then attends its cross cache; an attention layer
    attends through the block table when there is one, else against the
    dense cache."""
    h = p.ln1(x)
    if p.kind == "dec":
        k_cache, v_cache, cross_k, cross_v = cache
        x = x + A.attn_decode(p.attn, h, k_cache, v_cache, ctx["lens"], cfg,
                              rope=False)
        x = x + A.cross_attend_decode(p.cross, p.lnx(x), cross_k, cross_v,
                                      cfg)
        return _decode_ffn(p, x)
    if p.kind == "ssd":
        return x + S.ssd_decode(p.mix, h, cache, cfg)
    if p.kind == "rglru":
        return _decode_ffn(p, x + R.rglru_decode(p.mix, h, cache, cfg))
    if p.kind == "local":
        a = A.attn_decode(p.attn, h, *cache, ctx["lens"], cfg,
                          window=cfg.local_window)
        return _decode_ffn(p, x + a)
    if cfg.mla is not None:
        a = M.mla_decode(p.attn, h, cache, ctx["lens"], cfg)
        return _decode_ffn(p, x + a)
    k_cache, v_cache = cache
    if ctx.get("block_tables") is not None:
        a = A.paged_attn_decode(p.attn, h, k_cache, v_cache, ctx["lens"],
                                ctx["block_tables"], cfg)
    else:
        a = A.attn_decode(p.attn, h, k_cache, v_cache, ctx["lens"], cfg)
    return _decode_ffn(p, x + a)


def _decode_ffn(p, x):
    """A decode step's FFN half. x: [B_loc, d]."""
    h2 = p.ln2(x)
    if p.kind == "moe":
        # one token per row: the reference routes [B, 1, d]
        return x + MOE.moe_apply(p.ffn, h2[:, None, :])[0][:, 0]
    return x + mlp_apply(p.ffn, h2)
