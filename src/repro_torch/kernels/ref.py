"""Closed-form oracles for the port's kernels, and the amm quantizer
(``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from ..core.bbm import bbm_type0, bbm_type1
from ..core.faults import apply_acc_fault
from ..core.multipliers import MulSpec
from ..core.multipliers import mul as core_mul
from ..device import pin_fp32
from .booth_rows import (amm_chunk_len, bbm_rows_product_precoded,
                         booth_precode_faulty, split_signed)
from .normal import noise_consts, normal_draw

__all__ = ["AMM_BOOTH_KINDS", "amm_approx_ref", "amm_attention_ref",
           "amm_coded_kblocks_ref", "amm_coded_ref",
           "amm_decode_attention_codes_ref", "amm_decode_attention_ref",
           "amm_dense_ref", "amm_dot_ref", "amm_effective_vbl",
           "amm_faulty_ref", "amm_flash_attention_ref", "amm_quantize",
           "amm_quantize_slices", "amm_scale", "attention_ref",
           "bbm_matmul_ref", "fir_bank_ref", "quant_matmul_ref"]

# Booth-family specs and their closed-form truncation kind; every other
# multiplier family has no dot-form lowering
AMM_BOOTH_KINDS = {"booth": 0, "bbm0": 0, "bbm1": 1}


def amm_effective_vbl(spec: MulSpec) -> int:
    """VBL the accumulation scale is derived from (exact booth: 0)."""
    return 0 if spec.name == "booth" else spec.param


def amm_scale(v, wl: int) -> torch.Tensor:
    """The dynamic quantization scale of ``amm_quantize``: a 0-dim f32
    tensor on ``v``'s device, ``max|v| * (1/lim)`` floored at 1e-12."""
    lim = 2 ** (wl - 1) - 1
    vf = torch.as_tensor(v).to(torch.float32)
    # max|v| in one reduction that writes no |v| (the infinity norm: the
    # same maximum, NaN propagating); then multiply by the reciprocal
    # constant, as the reference writes it (XLA turns a division by a
    # constant into this multiply inside compiled programs); the division
    # by the runtime scale stays true
    vmax = torch.linalg.vector_norm(vf, ord=float("inf"))
    return torch.clamp_min(vmax * (1.0 / lim), 1e-12)


def amm_quantize(v, wl: int):
    """(int32 codes, f32 dynamic scale): the amm quantizer.

    Codes are ``clip(round(v / s), -lim - 1, lim)`` with ``lim =
    2^(wl-1) - 1`` and ``s = amm_scale(v, wl)``, computed in float32
    whatever v's dtype (bf16 cannot hold the wl = 16 bound 32767: its
    nearest value 32768 would wrap to -32768 in the Booth decode), with a
    true division by the runtime scale and rounding half to even.
    """
    lim = 2 ** (wl - 1) - 1
    vf = torch.as_tensor(v).to(torch.float32)
    s = amm_scale(vf, wl)
    codes = torch.clamp(torch.round(vf / s), -lim - 1, lim)
    return codes.to(torch.int32), s


def amm_quantize_slices(v, wl: int):
    """``amm_quantize`` of every (M, K) slice over the last two axes at
    once: (int32 codes, f32 scales of the leading shape), each slice's
    scale in ``amm_scale``'s expression (its own maximum, times 1/lim,
    floored at 1e-12), so each slice's codes and scale are bit-equal to
    ``amm_quantize`` of that slice alone."""
    lim = 2 ** (wl - 1) - 1
    vf = torch.as_tensor(v).to(torch.float32)
    vmax = torch.linalg.vector_norm(vf, ord=float("inf"), dim=(-2, -1))
    s = torch.clamp_min(vmax * (1.0 / lim), 1e-12)
    codes = torch.clamp(torch.round(vf / s[..., None, None]), -lim - 1, lim)
    return codes.to(torch.int32), s


def quant_matmul_ref(x, w, s_x, s_w, mu, sigma, *, wl: int = 16,
                     key=None) -> torch.Tensor:
    """Quantize -> one exact f32 matmul -> noise -> descale.

    With a ``core.prng`` key and non-zero moments the noise is
    ``jax.random.normal(key, acc.shape)``'s, drawn by ``normal_draw``
    (the kernel on the card) and folded into the accumulator as the
    reference's ``acc + mu*K + sigma*sqrt(K)*z`` compiles:
    ``fma(f32(f32(sigma*sqrt(K)) * f32(sqrt 2)), erf_inv(u), acc +
    f32(mu*K))``.  The scales are cast to f32 first, as the kernel
    receives them.
    """
    pin_fp32()
    lim = float(2 ** (wl - 1))
    s_x = torch.as_tensor(s_x, dtype=torch.float32, device=x.device)
    s_w = torch.as_tensor(s_w, dtype=torch.float32, device=x.device)
    xq = torch.clamp(torch.round(x / s_x), -lim, lim - 1)
    wq = torch.clamp(torch.round(w / s_w), -lim, lim - 1)
    acc = xq @ wq
    if key is not None and (mu != 0.0 or sigma != 0.0):
        c1, c2 = noise_consts(mu, sigma, x.shape[-1])
        normal_draw(key, acc.shape, acc=acc, c1=c1, c2=c2)
    return acc * (s_x * s_w)


def bbm_matmul_ref(x, w, *, wl: int, vbl: int, kind: int = 0,
                   shift: int = 0):
    """out[m,n] = sum_k (bbm(x[m,k], w[k,n]) >> shift), int32
    accumulation, on the closed forms over the (M, K, N) grid."""
    fn = bbm_type0 if kind == 0 else bbm_type1
    prod = fn(x[:, :, None], w[None, :, :], wl, vbl)
    if shift:
        prod = prod >> shift
    return torch.sum(prod, dim=1, dtype=torch.int32)


def fir_bank_ref(x, w, *, wl: int, vbl: int, kind: int = 0, shift: int = 0):
    """y[c,n] = sum_k (bbm(x[c,n-k], h[c,k]) >> shift), zero initial state.

    x: (C, N) codes, w: (C, taps) codes; built on the closed forms in
    ``core.bbm`` over the materialized (C, N, taps) window.
    """
    fn = bbm_type0 if kind == 0 else bbm_type1
    n = x.shape[1]
    taps = w.shape[1]
    xp = torch.nn.functional.pad(x, (taps - 1, 0))
    # win[c, n, k] = x[c, n - k] (zeros before the signal starts)
    idx = (torch.arange(n, device=x.device)[:, None] + (taps - 1)
           - torch.arange(taps, device=x.device)[None, :])
    win = xp[:, idx]
    prod = fn(win, w[:, None, :], wl, vbl)
    if shift:
        prod = prod >> shift
    return torch.sum(prod, dim=-1, dtype=torch.int32)


def _chunked_yq(prod: torch.Tensor, wl: int, vbl: int) -> torch.Tensor:
    """Products (..., K, N) / 2^vbl summed int32 per K-chunk of
    ``amm_chunk_len``, the chunk partials added in f32 in chunk order,
    times 2^vbl: the dot form's reduction, on the closed forms."""
    scaled = prod >> vbl                      # exact: divisible by 2^vbl
    k = prod.shape[-2]
    chunk = amm_chunk_len(wl, vbl)
    yq = None
    for lo in range(0, k, chunk):
        part = torch.sum(scaled[..., lo:lo + chunk, :], dim=-2,
                         dtype=torch.int32).to(torch.float32)
        yq = part if yq is None else yq + part
    return yq * float(1 << vbl)


def amm_approx_ref(x, w, spec: MulSpec):
    """Scalar outer-product oracle of ``amm_dense`` mode="bitexact".

    Quantizes both operands (``amm_quantize``), forms every scalar product
    through the closed forms of ``core.multipliers`` over the whole
    (..., K, N) grid (which is why this is the oracle and not the
    datapath), reduces, then descales.  Booth-family products are divided
    by 2^vbl, summed int32 per K-chunk and the chunks combined in f32 in
    order (the dot form's reduction); the other families (bam, kulkarni,
    etm), which have no dot lowering and take this path in bitexact mode,
    keep the reference's float32 sum of the products.  x: (..., K), w:
    (K, N).
    """
    wl = spec.wl
    xq, s_x = amm_quantize(x, wl)
    wq, s_w = amm_quantize(w, wl)
    prod = core_mul(spec)(xq[..., :, None], wq[None, :, :])  # (..., K, N)
    if spec.name in AMM_BOOTH_KINDS:
        yq = _chunked_yq(prod, wl, amm_effective_vbl(spec))
    else:
        yq = torch.sum(prod.to(torch.float32), dim=-2)
    return (yq * (s_x * s_w)).to(x.dtype)


def amm_faulty_ref(x, w, spec: MulSpec, fault=None):
    """Scalar oracle of the fault-injected datapath,
    ``bbm_matmul_dynamic(..., fault=)``.

    Quantizes both operands, decodes and faults ``w``'s digit planes
    (``booth_precode_faulty``: the masks depend only on the spec and the
    (wl//2, K, N) plane shape), forms every product over the (M, K, N)
    grid from the planes, divides by 2^vbl (exact for any planes in the
    decode domain), sums int32 per K-chunk with the same per-chunk
    accumulator upsets (``apply_acc_fault``, folded by the chunk index),
    combines the chunks in f32 in order, rescales and descales.
    Booth-family specs only.  x: (M, K), w: (K, N).
    """
    if spec.name not in AMM_BOOTH_KINDS:
        raise ValueError(f"fault injection needs a Booth-family spec, "
                         f"not {spec.name!r}")
    wl = spec.wl
    vbl = amm_effective_vbl(spec)
    kind = AMM_BOOTH_KINDS[spec.name]
    xq, s_x = amm_quantize(x, wl)
    wq, s_w = amm_quantize(w, wl)
    mag, neg = booth_precode_faulty(wq, wl, fault, vbl=vbl)
    _, x_s = split_signed(xq, wl)
    prod = bbm_rows_product_precoded(x_s[..., :, None], mag, neg, wl=wl,
                                     vbl=vbl, kind=kind)     # (M, K, N)
    scaled = prod >> vbl
    k = x.shape[-1]
    chunk = amm_chunk_len(wl, vbl)
    yq = torch.zeros(scaled.shape[:-2] + scaled.shape[-1:],
                     dtype=torch.float32, device=scaled.device)
    for ci, lo in enumerate(range(0, k, chunk)):
        part = torch.sum(scaled[..., lo:lo + chunk, :], dim=-2,
                         dtype=torch.int32)
        yq = yq + apply_acc_fault(part, fault, ci).to(torch.float32)
    yq = yq * float(1 << vbl)
    return (yq * (s_x * s_w)).to(x.dtype)


def _coded_yq_ref(aq, b_codes, spec: MulSpec) -> torch.Tensor:
    """Closed-form contraction of two code grids, chunk-scheduled: the
    products through ``core.multipliers``, divided by 2^vbl, summed int32
    per K-chunk, the chunks added in f32 in order, times 2^vbl (the
    full-product-scale accumulator of the codes-in oracles)."""
    prod = core_mul(spec)(aq[..., :, None], b_codes[None, :, :])
    return _chunked_yq(prod, spec.wl, amm_effective_vbl(spec))


def amm_coded_ref(a, b_codes, s_b, spec: MulSpec):
    """Scalar oracle of ``bbm_matmul.bbm_matmul_coded``: ``a`` (M, K)
    float quantized per call, ``b_codes`` (K, N) codes with a scalar or
    per-column (N,) scale ``s_b``; descale ``yq * (s_a * s_b)``."""
    if spec.name not in AMM_BOOTH_KINDS:
        raise ValueError(f"no codes-in lowering for family {spec.name!r}")
    aq, s_a = amm_quantize(a, spec.wl)
    yq = _coded_yq_ref(aq, torch.as_tensor(b_codes).to(torch.int32), spec)
    s_b = torch.as_tensor(s_b, dtype=torch.float32, device=yq.device)
    if s_b.ndim == 1:
        s_b = s_b[None, :]
    return (yq * (s_a * s_b)).to(a.dtype)


def amm_coded_kblocks_ref(a, b_codes, s_b, spec: MulSpec, *, block: int):
    """Scalar oracle of ``bbm_matmul.bbm_matmul_coded_kblocks``: each
    K-block of ``block`` rows contracted on the closed forms, descaled by
    ``s_a * s_b[j]``, the blocks added in f32 in block order."""
    if spec.name not in AMM_BOOTH_KINDS:
        raise ValueError(f"no codes-in lowering for family {spec.name!r}")
    kk = b_codes.shape[0]
    if kk % block:
        raise ValueError(f"K={kk} not a multiple of block={block}")
    aq, s_a = amm_quantize(a, spec.wl)
    b_codes = torch.as_tensor(b_codes).to(torch.int32)
    acc = None
    for bi, lo in enumerate(range(0, kk, block)):
        yq = _coded_yq_ref(aq[..., lo:lo + block], b_codes[lo:lo + block],
                           spec)
        part = yq * (s_a * s_b[bi])
        acc = part if acc is None else acc + part
    return acc.to(a.dtype)


def amm_dense_ref(x, w, spec: MulSpec):
    """The bitexact ``amm_dense`` oracle with the straight-through sum
    ``exact + (approx - exact)`` as the layer writes it."""
    pin_fp32()
    exact = x @ w
    return exact + (amm_approx_ref(x, w, spec) - exact)


def amm_dot_ref(a, b, spec: MulSpec):
    """Oracle of ``bbm_matmul_dynamic`` batched over the shared leading
    axes: every (M, K) x (K, N) slice quantized with its own scales."""
    if a.ndim != b.ndim:
        raise ValueError(f"operand ranks differ: {a.shape} vs {b.shape}")
    lead = a.shape[:-2]
    a2 = a.reshape((-1,) + a.shape[-2:])
    b2 = b.reshape((-1,) + b.shape[-2:])
    out = [amm_approx_ref(a2[i], b2[i], spec) for i in range(a2.shape[0])]
    return torch.stack(out).reshape(lead + out[0].shape)


def _attn_runtime(spec: MulSpec):
    """AmmRuntime carrying ``spec`` with attention routing on."""
    from ..configs.base import AmmConfig
    from ..models.common import AmmRuntime
    if spec.name not in AMM_BOOTH_KINDS:
        raise ValueError(f"no attention lowering for family {spec.name!r}")
    return AmmRuntime(AmmConfig(mode="bitexact", mul=spec.name, wl=spec.wl,
                                param=spec.param, apply_to="all"))


def amm_attention_ref(q, k, v, spec: MulSpec, *, causal: bool = True,
                      q_offset=0, bq: int = 512, bk: int = 1024,
                      kv_len=None):
    """Attention oracle of the approximate datapath: the schedule of
    ``models.attention.chunked_attention`` with every score and value
    product through the closed forms (``amm_dot_ref``).  q: (B, Sq, H,
    D), k/v: (B, Skv, KV, D)."""
    from ..models.attention import chunked_attention
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                             bq=bq, bk=bk, kv_len=kv_len,
                             amm=_attn_runtime(spec), amm_oracle=True)


def amm_flash_attention_ref(q, k, v, spec: MulSpec, *, causal: bool = True):
    """Oracle of ``flash_attention_amm``: ``amm_attention_ref`` at the
    flash tile sizes, in the kernel's (B, H, S, D) layout (matched head
    counts)."""
    from .flash_attention import FLASH_AMM_BK, FLASH_AMM_BQ
    out = amm_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), spec, causal=causal,
                            bq=FLASH_AMM_BQ, bk=FLASH_AMM_BK)
    return out.transpose(1, 2)


def amm_decode_attention_ref(q, k_cache, v_cache, kv_len, spec: MulSpec, *,
                             ste: bool = True):
    """Oracle of single-position amm attention against a float cache:
    ``models.attention.decode_attention``'s schedule with every product
    on the closed forms; ``ste=False`` gives the approximate forward
    alone."""
    from ..models.attention import decode_attention
    return decode_attention(q, k_cache, v_cache, kv_len,
                            amm=_attn_runtime(spec), amm_oracle=True,
                            amm_ste=ste)


def amm_decode_attention_codes_ref(q, cache, kv_len, spec: MulSpec):
    """Oracle of ``models.attention.decode_attention_codes``: the same
    schedule with the products through ``amm_coded_ref`` and
    ``amm_coded_kblocks_ref``; ``cache`` is one layer of the int-code
    cache."""
    from ..models.attention import decode_attention_codes
    return decode_attention_codes(q, cache, kv_len, amm=_attn_runtime(spec),
                                  amm_oracle=True)


def attention_ref(q, k, v, *, causal: bool = True):
    """Naive softmax attention, f32 internals.  q, k, v: (B, H, S, D)."""
    pin_fp32()
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=s.device).tril(diagonal=skv - sq)
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
