"""GQA attention with a float KV cache, amm off.

Counterpart of the float-cache half of ``repro.models.attention``:
``attn_table``, ``chunked_attention`` (the online-softmax block
schedule), ``decode_attention`` (one position against the cache),
``_cache_put`` (scalar and per-slot ``(B,)`` positions) and the routing
in ``attention`` for the cache branches and the cacheless chunked branch.
The projections and the attention products run in f32 through
``torch.einsum`` (TF32 pinned off), as the reference leaves them to XLA.

Not ported here: the int-code cache branch and the attention-side amm
products (ROADMAP slice 3), and the ``use_pallas`` flash branch, whose
TPU kernels ``_attn_kernel`` and ``_attn_amm_kernel`` are ROADMAP B4 and
B3.  Each raises ``NotImplementedError`` where the reference would take
it.

The port writes the cache in place: ``attention`` updates the given
``cache`` tensors and returns the same dict, where the reference returns
new arrays.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from .common import Spec, apply_rope, rmsnorm

__all__ = ["attn_table", "attention", "chunked_attention",
           "decode_attention", "NEG_INF"]

NEG_INF = -1e30

_CODES = ("the int-code KV cache is ROADMAP slice 3 (A6, with the "
          "bitexact datapath)")
_FLASH = ("the flash-attention kernels _attn_kernel and _attn_amm_kernel "
          "are ROADMAP B4 and B3; the cacheless lm_apply with use_pallas "
          "reaches them")


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


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    if not n:
        return t
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))


def chunked_attention(q, k, v, *, causal: bool, q_offset=0, bq: int = 512,
                      bk: int = 1024, kv_len=None, amm=None):
    """Online-softmax blockwise attention, the reference's schedule.

    q: (B, Sq, H, D), k/v: (B, Skv, KV, D) with H a multiple of KV (GQA:
    the query heads are folded by group).  q_offset: global position of
    q[0] (causal masking against a cache); kv_len: number of valid KV
    positions.  Blocks of ``bq`` queries run one after another, each
    scanning the KV blocks of ``bk`` in order with the running max, sum
    and accumulator in f32.  Returns (B, Sq, H, D) in q's dtype.
    """
    if amm is not None:
        raise NotImplementedError(f"attention-side amm: {_CODES}")
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
            pv = torch.einsum("bgqk,bgkd->bgqd", p, vb[ki].to(torch.float32))
            acc = acc * alpha + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)
        outs.append(out.reshape(b, h, bq, dv))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, nq * bq, h, dv)
    return out[:, :sq].to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, *, amm=None):
    """Single-position attention against a float cache.

    q: (B, 1, H, D); caches: (B, S, KV, D); kv_len: valid length, a
    scalar or a (B,) per-slot tensor (continuous batching).
    """
    if amm is not None:
        raise NotImplementedError(f"attention-side amm: {_CODES}")
    b, _, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    dv = v_cache.shape[-1]
    groups = h // kvh
    qf = q.to(torch.float32).reshape(b, kvh, groups, d) / (d ** 0.5)
    sc = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(torch.float32))
    kvl = torch.as_tensor(kv_len, device=q.device)
    if kvl.ndim == 1:
        kvl = kvl[:, None, None, None]
    live = torch.arange(s, device=q.device)[None, None, None, :] < kvl
    p = torch.softmax(torch.where(live, sc, NEG_INF), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
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


def attention(p, x, cfg: ArchConfig, *, positions, cache=None, pos=None,
              causal: bool = True, kv=None, use_pallas: bool = False,
              amm=None):
    """GQA attention.  x: (B, S, d_model).

    cache: optional {"k", "v"} (B, S_max, KV, D) float cache, written in
    place at ``pos`` (a scalar, or a (B,) per-slot tensor for one-token
    decode).  kv: optional external (k, v) (cross-attention).  Returns
    (out, cache).
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

    if cache is not None and s > 1 and torch.as_tensor(pos).ndim == 1:
        raise ValueError("multi-token prefill needs a scalar position; "
                         "per-slot position vectors are decode-only")
    if cache is not None and "k_codes" in cache:
        raise NotImplementedError(_CODES)
    if cache is not None:
        _cache_put(cache["k"], k.to(cache["k"].dtype), pos)
        _cache_put(cache["v"], v.to(cache["v"].dtype), pos)
        kv_len = torch.as_tensor(pos, device=x.device) + s \
            if torch.as_tensor(pos).ndim == 1 else int(pos) + s
        if s == 1:
            out = decode_attention(q, cache["k"], cache["v"], kv_len,
                                   amm=amm)
        else:
            out = chunked_attention(q, cache["k"], cache["v"], causal=causal,
                                    q_offset=int(pos), kv_len=kv_len,
                                    amm=amm)
    elif use_pallas:
        raise NotImplementedError(_FLASH)
    else:
        out = chunked_attention(q, k, v, causal=causal, amm=amm)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache
