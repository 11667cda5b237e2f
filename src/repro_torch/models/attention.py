"""GQA and multi-head latent attention: the float KV cache, the chunked
schedule (exact and on the amm datapath) and the flash lowerings.

Counterpart of ``repro.models.attention``:
``attn_table``, ``chunked_attention`` (the online-softmax block schedule,
its score and value products optionally through ``amm_dot``),
``decode_attention``, ``_cache_put`` (scalar and per-slot ``(B,)``
positions), ``flash_amm_chunked_equiv``, and the routing of
``attention``.  The projections and the attention products run in f32
through ``torch.einsum`` (TF32 pinned off), as the reference leaves them
to XLA.

Routing of the cacheless call (train and prefill without a cache), as
in the reference: ``use_pallas`` with amm inactive takes the exact flash
kernel (``kernels.flash_attention.flash_attention``), with an active
Booth-family amm the flash-amm kernel (``flash_attention_amm``); a call
beyond ``_FLASH_SEQ_CAP`` or an amm without a dot-form lowering falls
back to the chunked path with a ``FlashFallbackWarning``.  Both flash
calls are ``torch.autograd.Function``s whose backward runs in plain
PyTorch (the reference has no backward kernel): the exact one
differentiates the plain exact blockwise attention, the amm one the
flash-amm plain version, fed the approximate products the kernel kept
(the reference's straight-through schedule at the flash tiles).

The int-code KV cache (``serve.kv_cache``): ``code_cache_update``
quantizes each written row against its block's first-touch frozen
scale, ``code_cache_dequant`` expands a leaf back to f32 (prefill rides
the chunked schedule on it), and ``decode_attention_codes`` contracts the
cached codes directly, the score and value products of every (slot,
kv-head) slice in one ``bbm_dot_coded_batched`` launch each.

DeepSeek-V3's multi-head latent attention (``mla_table``,
``mla_attention``) caches the compressed latent with its decoupled rope
key, (B, S, kv_lora + rope) per layer: as bf16 floats, or as the
``lat_codes``/``lat_scale`` code cache (one scale per block of positions;
the code cache's helpers with a head axis of 1), dequantized at read.
K and V are re-expanded from the latent at every call (the reference's
naive formulation); decode runs ``decode_attention`` and prefill
``chunked_attention`` over them, both with ``amm`` (the score and value
products on ``amm_dot``), never the flash kernels.

The port writes the caches in place: ``attention`` updates the given
``cache`` tensors and returns the same dict, where the reference returns
new arrays.
"""
from __future__ import annotations

import sys
import warnings
from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention import (FLASH_AMM_BK, FLASH_AMM_BQ,
                                       flash_amm_operands, flash_amm_plain,
                                       flash_attention,
                                       flash_attention_amm,
                                       flash_attention_plain)
from ..kernels.bbm_matmul import bbm_dot_coded_batched
from ..kernels.ref import amm_quantize_slices
from .common import Spec, amm_dot, apply_rope, rmsnorm

__all__ = ["attn_table", "mla_table", "attention", "mla_attention",
           "chunked_attention",
           "code_cache_dequant", "code_cache_update", "decode_attention",
           "decode_attention_codes", "flash_amm_chunked_equiv",
           "FlashFallbackWarning", "reset_flash_fallback_dedup", "NEG_INF"]

NEG_INF = -1e30

# flash-path sequence cap: above it the chunked path is taken instead.
# Module-level so tests can lower it to exercise the fallback warning.
_FLASH_SEQ_CAP = 32768


class FlashFallbackWarning(UserWarning):
    """A ``use_pallas`` attention call fell back to the chunked path."""


# (reason, caller file, caller line) sites that already warned
_seen_fallbacks: set = set()


def reset_flash_fallback_dedup() -> None:
    """Forget which fallback sites have warned (tests, a new run)."""
    _seen_fallbacks.clear()


def _flash_fallback(reason: str, **ctx) -> None:
    f = sys._getframe(2)     # the user call site stacklevel=3 attributes to
    site = (reason, f.f_code.co_filename, f.f_lineno)
    if site in _seen_fallbacks:
        return
    _seen_fallbacks.add(site)
    detail = ", ".join(f"{k}={v}" for k, v in ctx.items())
    warnings.warn(FlashFallbackWarning(
        f"use_pallas requested but attention fell back to the chunked "
        f"path: {reason} ({detail})"), stacklevel=3)


def attn_table(cfg: ArchConfig) -> Dict[str, Spec]:
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    t = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = Spec((h, hd), ("heads", "head_dim"), "zeros")
        t["bk"] = Spec((kv, hd), ("kv_heads", "head_dim"), "zeros")
        t["bv"] = Spec((kv, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        t["q_norm"] = Spec((hd,), ("head_dim",), "ones")
        t["k_norm"] = Spec((hd,), ("head_dim",), "ones")
    return t


def mla_table(cfg: ArchConfig) -> Dict[str, Spec]:
    d, h = cfg.d_model, cfg.n_heads
    qk_n, qk_r, v_hd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": Spec((d, cfg.q_lora_rank), ("embed", "q_latent")),
        "q_a_norm": Spec((cfg.q_lora_rank,), ("q_latent",), "ones"),
        "wq_b": Spec((cfg.q_lora_rank, h, qk_n + qk_r),
                     ("q_latent", "heads", "head_dim")),
        "w_dkv": Spec((d, cfg.kv_lora_rank + qk_r), ("embed", "kv_latent")),
        "kv_norm": Spec((cfg.kv_lora_rank,), ("kv_latent",), "ones"),
        "w_uk": Spec((cfg.kv_lora_rank, h, qk_n),
                     ("kv_latent", "heads", "head_dim")),
        "w_uv": Spec((cfg.kv_lora_rank, h, v_hd),
                     ("kv_latent", "heads", "head_dim")),
        "wo": Spec((h, v_hd, d), ("heads", "head_dim", "embed")),
    }


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    if not n:
        return t
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))


def chunked_attention(q, k, v, *, causal: bool, q_offset=0, bq: int = 512,
                      bk: int = 1024, kv_len=None, amm=None,
                      amm_oracle: bool = False):
    """Online-softmax blockwise attention, the reference's schedule.

    q: (B, Sq, H, D), k/v: (B, Skv, KV, D) with H a multiple of KV (GQA:
    the query heads are folded by group).  q_offset: global position of
    q[0] (causal masking against a cache); kv_len: number of valid KV
    positions.  Blocks of ``bq`` queries run one after another, each
    scanning the KV blocks of ``bk`` in order with the running max, sum
    and accumulator in f32.  ``amm``: an ``AmmRuntime`` whose score and
    value products go through ``amm_dot``, one pair of scales per
    (batch, kv-head) block; ``amm_oracle`` forms them through the closed
    forms.  Returns (B, Sq, H, D) in q's dtype.
    """
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    dv = v.shape[-1]
    groups = h // kvh
    bq = min(bq, sq)
    bk = min(bk, skv)
    nq, nk = -(-sq // bq), -(-skv // bk)
    q = _pad_seq(q, nq * bq - sq)
    k = _pad_seq(k, nk * bk - skv)
    v = _pad_seq(v, nk * bk - skv)
    if kv_len is None:
        kv_len = skv
    dev = q.device
    qb = q.reshape(b, nq, bq, h, d).permute(1, 0, 3, 2, 4)    # (nq,B,H,bq,D)
    kb = k.reshape(b, nk, bk, kvh, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, bk, kvh, dv).permute(1, 0, 3, 2, 4)
    scale = 1.0 / (d ** 0.5)
    outs = []
    for qi in range(nq):
        qg = (qb[qi].to(torch.float32) * scale).reshape(b, kvh, groups * bq,
                                                         d)
        m = torch.full((b, kvh, groups * bq, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, groups * bq, 1), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, kvh, groups * bq, dv), dtype=torch.float32,
                          device=dev)
        qpos = q_offset + qi * bq + torch.arange(bq, device=dev)
        for ki in range(nk):
            if amm is not None:
                s = amm_dot(qg, kb[ki].to(torch.float32).transpose(-1, -2),
                            amm, oracle=amm_oracle)
            else:
                s = torch.einsum("bgqd,bgkd->bgqk", qg,
                                 kb[ki].to(torch.float32))
            s4 = s.reshape(b, kvh, groups, bq, bk)
            kpos = ki * bk + torch.arange(bk, device=dev)
            live = (kpos < kv_len)[None, :]
            if causal:
                live = live & (qpos[:, None] >= kpos[None, :])
            s = torch.where(live, s4, NEG_INF).reshape(b, kvh, groups * bq,
                                                       bk)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if amm is not None:
                pv = amm_dot(p, vb[ki].to(torch.float32), amm,
                             oracle=amm_oracle)
            else:
                pv = torch.einsum("bgqk,bgkd->bgqd", p,
                                  vb[ki].to(torch.float32))
            acc = acc * alpha + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)
        outs.append(out.reshape(b, h, bq, dv))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, nq * bq, h, dv)
    return out[:, :sq].to(q.dtype)


def flash_amm_chunked_equiv(q, k, v, amm, *, causal: bool = True):
    """The chunked-amm run that flash-amm computes: (B, H, S, D) operands
    with matched head counts, the chunked schedule at the flash tile
    sizes (quantization is per block, so the blocking is part of the
    function)."""
    out = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            bq=FLASH_AMM_BQ, bk=FLASH_AMM_BK, amm=amm)
    return out.transpose(1, 2)


def _exact_vjp(q, k, v, g, causal: bool):
    """Gradients of the plain exact blockwise attention at the flash
    tiles with respect to (q, k, v), for the output gradient ``g``."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_plain(qd, kd, vd, causal=causal,
                                    bq=FLASH_AMM_BQ, bk=FLASH_AMM_BK)
        return torch.autograd.grad(out, (qd, kd, vd), g)


class _FlashExact(torch.autograd.Function):
    """The exact flash kernel forward; backward through the plain exact
    attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        return (*_exact_vjp(*ctx.saved_tensors, g, ctx.causal), None)


class _FlashAmmSTE(torch.autograd.Function):
    """Flash-amm forward with the reference's straight-through gradient
    (its ``custom_vjp`` over ``flash_amm_chunked_equiv``): autograd of the
    plain version fed the approximate products the forward kept, so each
    tile's scores are ``exact + (approx - exact).detach()``, its P V
    product ``pe + (approx - pe).detach()``, the softmax's Jacobian is
    taken where the forward took it, and the backward forms no
    Broken-Booth product."""

    @staticmethod
    def forward(ctx, q, k, v, amm, causal):
        wl, vbl, kind = amm.attn_lowering
        out, res = flash_attention_amm(q, k, v, wl=wl, vbl=vbl, kind=kind,
                                       causal=causal, residuals=True)
        ctx.save_for_backward(q, k, v, res["s"], res["pv"])
        ctx.lowering, ctx.causal = (wl, vbl, kind), causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, s, pv = ctx.saved_tensors
        wl, vbl, kind = ctx.lowering
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            ops = flash_amm_operands(qd, kd, vd, wl=wl)
            out = flash_amm_plain(ops, wl=wl, vbl=vbl, kind=kind,
                                  causal=ctx.causal,
                                  residuals_in={"s": s, "pv": pv})
            b, h, sq, d = ops["shape"]
            out = out[:, :sq].reshape(b, h, sq, d)
            grads = torch.autograd.grad(out, (qd, kd, vd), g)
        return (*grads, None, None)


def _flash_amm_ste(amm, causal, q, k, v):
    """Flash-amm with the straight-through gradient (the reference's
    ``custom_vjp`` of the same name)."""
    return _FlashAmmSTE.apply(q, k, v, amm, causal)


def decode_attention(q, k_cache, v_cache, kv_len, *, amm=None,
                     amm_oracle: bool = False, amm_ste: bool = True):
    """Single-position attention against a float cache.

    q: (B, 1, H, D); caches: (B, S, KV, D); kv_len: valid length, a
    scalar or a (B,) per-slot tensor (continuous batching).  ``amm``: the
    score and value products through ``amm_dot``, each (slot, kv-head)
    slice quantized over the whole cache slice on every call;
    ``amm_oracle`` forms them on the closed forms, ``amm_ste=False``
    returns the approximate forward without the straight-through sum.
    """
    b, _, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    dv = v_cache.shape[-1]
    groups = h // kvh
    qf = q.to(torch.float32).reshape(b, kvh, groups, d) / (d ** 0.5)
    if amm is not None:
        sc = amm_dot(qf, k_cache.to(torch.float32).permute(0, 2, 3, 1), amm,
                     oracle=amm_oracle, ste=amm_ste)         # (B, KV, g, S)
    else:
        sc = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(torch.float32))
    kvl = torch.as_tensor(kv_len, device=q.device)
    if kvl.ndim == 1:
        kvl = kvl[:, None, None, None]
    live = torch.arange(s, device=q.device)[None, None, None, :] < kvl
    p = torch.softmax(torch.where(live, sc, NEG_INF), dim=-1)
    if amm is not None:
        out = amm_dot(p, v_cache.to(torch.float32).permute(0, 2, 1, 3), amm,
                      oracle=amm_oracle, ste=amm_ste)        # (B, KV, g, Dv)
    else:
        out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, dv).to(q.dtype)


# ------------------------------------------------------- int-code KV cache
def code_cache_update(codes, scales, x, pos, *, wl: int):
    """Write new K/V rows into an int-code cache leaf as frozen codes, in
    place; returns (codes, scales).

    codes: (B, S, KV, hd); scales: (B, nb, KV) f32 with nb * block == S,
    0.0 marking a never-written block; x: (B, s, KV, hd) float rows; pos:
    scalar or (B,) per-slot positions.  Per slot, the rows touch at most
    ``ceil(s / block) + 1`` blocks from ``pos // block`` on; the first
    write touching a block fixes its per-kv-head scale from that write's
    rows in it, in ``amm_quantize``'s expression (``max|v| * (1/lim)``
    floored at 1e-12; so a block's first one-shot write freezes the scale
    ``amm_quantize`` derives for the same values), and every later write
    into the block quantizes, and clips to ``[-lim-1, lim]``, against the
    frozen scale.  As in the reference, the blocks are accounted from the
    unclamped ``pos`` while the codes land at the start clamped to ``S -
    s`` (``dynamic_update_slice``'s rule).
    """
    lim = 2 ** (wl - 1) - 1
    bsz, s_max = codes.shape[0], codes.shape[1]
    nb, kvh = scales.shape[1], scales.shape[2]
    block = s_max // nb
    vf = x.to(torch.float32)
    s_new = vf.shape[1]
    dev = codes.device
    p = torch.as_tensor(pos, device=dev).to(torch.int64)
    p = p.expand(bsz) if p.ndim == 0 else p
    rows = torch.arange(bsz, device=dev)
    b0 = torch.div(p, block, rounding_mode="floor")
    in_blk = torch.arange(block, device=dev)
    blk_scales = []
    for t in range(-(-s_new // block) + 1):   # worst-case misaligned span
        bi = b0 + t
        rel = (bi * block - p)[:, None] + in_blk[None, :]  # block -> x rows
        m = (rel >= 0) & (rel < s_new)
        vals = vf[rows[:, None], rel.clamp(0, s_new - 1)].abs() \
            * m[:, :, None, None]
        cand = torch.clamp_min(torch.amax(vals, dim=(1, 3)) * (1.0 / lim),
                               1e-12)                             # (B, KV)
        bic = bi.clamp(0, nb - 1)
        old = scales[rows, bic]
        sc = torch.where(old > 0.0, old, cand)
        keep = m.any(dim=1) & (bi < nb)
        scales[rows, bic] = torch.where(keep[:, None], sc, old)
        blk_scales.append(sc)
    per_blk = torch.stack(blk_scales, dim=1)               # (B, n_touch, KV)
    at = torch.arange(s_new, device=dev)
    tok_blk = torch.div(p[:, None] + at[None, :], block,
                        rounding_mode="floor") - b0[:, None]
    sc_tok = torch.gather(per_blk, 1, tok_blk[..., None].expand(-1, -1, kvh))
    q = torch.clamp(torch.round(vf / sc_tok[..., None]), -lim - 1, lim)
    start = p.clamp(0, s_max - s_new)
    codes[rows[:, None], start[:, None] + at[None, :]] = q.to(codes.dtype)
    return codes, scales


def _live(kv_len, b: int, s: int, device) -> tuple:
    """((B,) int64 valid lengths, (B, S) live mask) of a scalar or (B,)
    ``kv_len``."""
    kvl = torch.as_tensor(kv_len, device=device).to(torch.int64)
    kvl = kvl.reshape(-1).expand(b)
    return kvl, torch.arange(s, device=device)[None, :] < kvl[:, None]


def code_cache_dequant(codes, scales, kv_len=None):
    """An int-code cache leaf as f32 values: codes (B, S, KV, hd) times
    their blocks' scales (B, nb, KV); positions at or past ``kv_len``
    (scalar or (B,)) are zeros (a reused slot may hold stale codes under
    a frozen scale)."""
    b, s = codes.shape[0], codes.shape[1]
    block = s // scales.shape[1]
    sc = torch.repeat_interleave(scales, block, dim=1)          # (B, S, KV)
    out = codes.to(torch.float32) * sc[..., None]
    if kv_len is not None:
        _, live = _live(kv_len, b, s, codes.device)
        out = torch.where(live[:, :, None, None], out, 0.0)
    return out


def decode_attention_codes(q, cache, kv_len, *, amm,
                           amm_oracle: bool = False):
    """Single-position attention straight from the int-code KV cache.

    q: (B, 1, H, D); cache: one layer of the code cache, {"k_codes",
    "k_scale", "v_codes", "v_scale"} shaped as in ``code_cache_update``;
    kv_len: scalar or (B,).  Only q and the softmax probabilities are
    quantized per call (each (slot, kv-head) slice with its own scale);
    the cached codes go into the datapath as they are: the score product
    with per-column K scales (each position's block scale), the value
    product descaled per K-block before the f32 add in block order.  The
    value is the approximate forward alone (no straight-through sum).
    Codes at or past ``kv_len`` read as zero before either contraction:
    the softmax gives them weight 0.0, hence P codes 0, but under kind 1
    a zero P code times a negative-row V code is not 0.  On the card
    each product is one ``bbm_dot_coded_batched`` launch over every slice,
    reading the cache's codes and scales in place.  ``amm_oracle`` forms
    each slice's products on the closed forms (``amm_coded_ref``,
    ``amm_coded_kblocks_ref``).  Returns (B, 1, H, Dv) in q's dtype.
    """
    if amm is None or not amm.attn_active or amm.attn_lowering is None:
        raise ValueError("int-code KV cache decode requires an active "
                         "Booth-family bitexact amm attention lowering "
                         "(mode='bitexact', Booth-family mul, apply_to "
                         "'attn' or 'all')")
    wl, vbl, kind = amm.attn_lowering
    kc, vc = cache["k_codes"], cache["v_codes"]
    ks, vs = cache["k_scale"], cache["v_scale"]
    b, s, kvh, d = kc.shape
    dv = vc.shape[-1]
    block = s // ks.shape[1]
    h = q.shape[2]
    groups = h // kvh
    qf = q.to(torch.float32).reshape(b, kvh, groups, d) / (d ** 0.5)
    kvl, live = _live(kv_len, b, s, q.device)
    if amm_oracle:
        from ..kernels.ref import amm_coded_kblocks_ref, amm_coded_ref
        spec = amm.spec
        out = torch.empty((b, kvh, groups, dv), dtype=torch.float32,
                          device=q.device)
        for i in range(b):
            for j in range(kvh):
                kt = torch.where(live[i][None, :],
                                 kc[i, :, j].to(torch.int32).T, 0)
                sc = amm_coded_ref(qf[i, j], kt,
                                   ks[i, :, j].repeat_interleave(block),
                                   spec)
                pr = torch.softmax(torch.where(live[i][None, :], sc,
                                               NEG_INF), dim=-1)
                vv = torch.where(live[i][:, None],
                                 vc[i, :, j].to(torch.int32), 0)
                out[i, j] = amm_coded_kblocks_ref(pr, vv, vs[i, :, j], spec,
                                                  block=block)
    else:
        aq, s_a = amm_quantize_slices(qf, wl)
        sc = bbm_dot_coded_batched(aq.contiguous(), s_a,
                                   kc.permute(0, 2, 3, 1),
                                   ks.permute(0, 2, 1), wl=wl, vbl=vbl,
                                   kind=kind, block=block, per="column",
                                   live=kvl)                 # (B, KV, g, S)
        pr = torch.softmax(torch.where(live[:, None, None, :], sc, NEG_INF),
                           dim=-1)
        pq, s_p = amm_quantize_slices(pr, wl)
        out = bbm_dot_coded_batched(pq.contiguous(), s_p,
                                    vc.permute(0, 2, 1, 3),
                                    vs.permute(0, 2, 1), wl=wl, vbl=vbl,
                                    kind=kind, block=block, per="kblock",
                                    live=kvl)                # (B, KV, g, Dv)
    return out.reshape(b, 1, h, dv).to(q.dtype)


def _cache_put(buf: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` (B, s, ...) into ``buf`` (B, S, ...) at the decode
    position(s), in place: a scalar ``pos`` is one front for every row,
    a (B,) tensor one position per slot (s == 1).  The start is clamped
    so the update fits, as ``dynamic_update_slice`` clamps it."""
    s_max, s = buf.shape[1], new.shape[1]
    p = torch.as_tensor(pos, device=buf.device)
    if p.ndim == 0:
        start = min(max(int(p), 0), s_max - s)
        buf[:, start:start + s] = new
        return
    p = torch.clamp(p.to(torch.int64), 0, s_max - s)
    buf[torch.arange(buf.shape[0], device=buf.device), p] = new[:, 0]


def _cache_len(cache, pos, s: int, device):
    """The valid length after a cached call of ``s`` positions at ``pos``:
    an int for a scalar position, a (B,) tensor for per-slot ones (which
    only a one-token decode may take); None without a cache."""
    if cache is None:
        return None
    if torch.as_tensor(pos).ndim == 1:
        if s > 1:
            raise ValueError("multi-token prefill needs a scalar position; "
                             "per-slot position vectors are decode-only")
        return torch.as_tensor(pos, device=device) + s
    return int(pos) + s


def _require_lowering(amm) -> None:
    if amm is None or amm.attn_lowering is None:
        raise ValueError("int-code KV cache requires an active "
                         "Booth-family bitexact amm attention lowering")


def attention(p, x, cfg: ArchConfig, *, positions, cache=None, pos=None,
              causal: bool = True, kv=None, use_pallas: bool = False,
              amm=None):
    """GQA attention.  x: (B, S, d_model).

    cache: optional {"k", "v"} (B, S_max, KV, D) float cache, or one
    layer of the int-code cache {"k_codes", "k_scale", "v_codes",
    "v_scale"}, written in place at ``pos`` (a scalar, or a (B,) per-slot
    tensor for one-token decode).  The code cache needs an active
    Booth-family amm lowering: its decode contracts the codes
    (``decode_attention_codes``), its prefill dequantizes once and takes
    the chunked schedule.  kv: optional external (k, v)
    (cross-attention).  Returns (out, cache).
    """
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if kv is None:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    else:
        k, v = kv
    if cfg.qkv_bias:
        q = q + p["bq"]
        if kv is None:
            k = k + p["bk"]
            v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    if kv is None:
        k = apply_rope(k, positions, cfg.rope_theta)

    kv_len = _cache_len(cache, pos, s, x.device)
    if cache is not None and "k_codes" in cache:
        _require_lowering(amm)
        wl = amm.attn_lowering[0]
        code_cache_update(cache["k_codes"], cache["k_scale"], k, pos, wl=wl)
        code_cache_update(cache["v_codes"], cache["v_scale"], v, pos, wl=wl)
        if s == 1:
            out = decode_attention_codes(q, cache, kv_len, amm=amm)
        else:
            kk = code_cache_dequant(cache["k_codes"], cache["k_scale"],
                                    kv_len=kv_len)
            vv = code_cache_dequant(cache["v_codes"], cache["v_scale"],
                                    kv_len=kv_len)
            out = chunked_attention(q, kk, vv, causal=causal,
                                    q_offset=int(pos), kv_len=kv_len,
                                    amm=amm)
    elif cache is not None:
        _cache_put(cache["k"], k.to(cache["k"].dtype), pos)
        _cache_put(cache["v"], v.to(cache["v"].dtype), pos)
        if s == 1:
            out = decode_attention(q, cache["k"], cache["v"], kv_len,
                                   amm=amm)
        else:
            out = chunked_attention(q, cache["k"], cache["v"], causal=causal,
                                    q_offset=int(pos), kv_len=kv_len,
                                    amm=amm)
    elif use_pallas and s <= _FLASH_SEQ_CAP and (
            amm is None or amm.attn_lowering is not None):
        groups = q.shape[2] // k.shape[2]
        qt = q.transpose(1, 2)
        kt = torch.repeat_interleave(k, groups, dim=2).transpose(1, 2)
        vt = torch.repeat_interleave(v, groups, dim=2).transpose(1, 2)
        if amm is None:
            out = _FlashExact.apply(qt, kt, vt, causal)
        else:
            out = _flash_amm_ste(amm, causal, qt, kt, vt)
        out = out.transpose(1, 2)
    else:
        if use_pallas:
            if s > _FLASH_SEQ_CAP:
                _flash_fallback(
                    "sequence length exceeds the flash cap",
                    shape=tuple(x.shape), seq=s, cap=_FLASH_SEQ_CAP,
                    amm="inactive" if amm is None else
                    f"{amm.cfg.mul}/wl={amm.cfg.wl}")
            else:
                _flash_fallback(
                    "amm family has no flash lowering",
                    shape=tuple(x.shape), seq=s,
                    amm=f"{amm.cfg.mul}/mode={amm.cfg.mode}")
        out = chunked_attention(q, k, v, causal=causal, amm=amm)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def _expand_f32(a: torch.Tensor, w: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, a, w)`` with both operands promoted to their common
    dtype, as ``jnp.einsum`` promotes a bf16 cache against f32 weights."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.einsum(eq, a.to(dt), w.to(dt))


def mla_attention(p, x, cfg: ArchConfig, *, positions, cache=None, pos=None,
                  amm=None):
    """DeepSeek-V3 multi-head latent attention.  x: (B, S, d_model).

    Queries take the low-rank path (``wq_a``, its rmsnorm, ``wq_b``);
    keys and values come from the compressed latent (``w_dkv``: the
    kv_lora part rmsnormed, the decoupled rope key rotated), re-expanded
    per head by ``w_uk`` and ``w_uv`` at every call; the head dims are
    nope + rope for the scores and v_head_dim for the values, and the
    softmax scale is (nope + rope) ** -0.5.

    cache: None; one layer of the float cache {"latent"} (B, S_max,
    kv_lora + rope), written in place at ``pos``; or one layer of the
    code cache {"lat_codes" (B, S_max, kv_lora + rope), "lat_scale" (B,
    nb)}, the latent quantized at write (``code_cache_update`` with a
    head axis of 1) and dequantized at read, which needs an active
    Booth-family amm lowering.  A cached call of one token decodes
    (``decode_attention``), a longer one takes the chunked schedule at
    ``q_offset=pos``; ``amm`` sends both products through ``amm_dot``.
    Returns (out, cache).
    """
    b, s, _ = x.shape
    nope, kvr = cfg.qk_nope_dim, cfg.kv_lora_rank
    q_lat = rmsnorm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["wq_b"])
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)

    latent = x @ p["w_dkv"]                          # (B, S, kv_lora+rope)
    c_kv = rmsnorm(latent[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(latent[..., None, kvr:], positions, cfg.rope_theta)
    lat_cat = torch.cat([c_kv, k_rope[..., 0, :].to(c_kv.dtype)], dim=-1)

    kv_len = _cache_len(cache, pos, s, x.device)
    if cache is not None and "lat_codes" in cache:
        _require_lowering(amm)
        lc = cache["lat_codes"][:, :, None, :]       # views: written in
        ls = cache["lat_scale"][..., None]           # place through them
        code_cache_update(lc, ls, lat_cat[:, :, None, :], pos,
                          wl=amm.attn_lowering[0])
        lat_all = code_cache_dequant(lc, ls, kv_len=kv_len)[:, :, 0, :]
    elif cache is not None:
        _cache_put(cache["latent"], lat_cat.to(cache["latent"].dtype), pos)
        lat_all = cache["latent"]
    else:
        lat_all = lat_cat
        kv_len = s

    c_all = lat_all[..., :kvr]
    k_nope = _expand_f32(c_all, p["w_uk"], "bsr,rhk->bshk")
    v_all = _expand_f32(c_all, p["w_uv"], "bsr,rhk->bshk")
    kr_all = lat_all[..., None, kvr:].to(k_nope.dtype)
    k_full = torch.cat([k_nope, kr_all.expand(
        k_nope.shape[:3] + (kr_all.shape[-1],))], dim=-1)
    if cache is not None and s == 1:
        out = decode_attention(q_full, k_full, v_all, kv_len, amm=amm)
    elif cache is not None:
        out = chunked_attention(q_full, k_full, v_all, causal=True,
                                q_offset=int(pos), kv_len=kv_len, amm=amm)
    else:
        out = chunked_attention(q_full, k_full, v_all, causal=True, amm=amm)
    y = torch.einsum("bshk,hkd->bsd", out.to(p["wo"].dtype), p["wo"])
    return y, cache
