"""The int-code KV cache and slot surgery on the layer-stacked caches
(``repro.serve.kv_cache``).

The int-code cache holds, in place of bf16 K/V values, the wl-bit codes
the approximate datapath would derive anyway, frozen at write time
(``models.attention.code_cache_update``), plus one f32 scale per (layer,
slot, seq-block, kv-head); decode contracts the codes directly
(``models.attention.decode_attention_codes``).  Layout (dense/GQA)::

    k_codes, v_codes: (layers, batch, max_len, kv_heads, head_dim)  intN
    k_scale, v_scale: (layers, batch, n_blocks, kv_heads)           f32

with ``n_blocks = max_len // block`` and intN = int8 for wl <= 8, int16
for wl <= 16.  MLA (DeepSeek-V3) caches the compressed latent instead,
one scale per (layer, slot, seq-block)::

    lat_codes: (layers, batch, max_len, kv_lora + rope)  intN
    lat_scale: (layers, batch, n_blocks)                 f32

A scale of 0.0 marks a never-written block (real scales are floored at
1e-12); the first write touching a block freezes its scale.

The continuous scheduler addresses one slot of the batch axis at a time:
admission resets it, prefill runs on a batch-1 slice and writes it back.
Every helper takes a matching dict of batch-axis indices (``ax_tree``),
derived once from the cache's logical axes, and walks any dict of
leaves, float or code.  ``slot_take`` returns a copy (a prefill that
fails midway leaves the cache as it was); ``slot_put`` and
``reset_slot`` write in place and return the cache they were given.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device

__all__ = ["KV_BLOCK", "batch_axis_tree", "cache_nbytes",
           "code_cache_logical_axes", "code_dtype", "float_cache_nbytes",
           "init_code_cache", "memory_report", "reset_slot", "slot_put",
           "slot_take"]

# default seq-block granularity of the frozen scales
KV_BLOCK = 16


def code_dtype(wl: int) -> torch.dtype:
    """Narrowest signed integer dtype holding wl-bit codes."""
    if wl <= 8:
        return torch.int8
    if wl <= 16:
        return torch.int16
    raise ValueError(f"wl={wl} exceeds the 16-bit code envelope")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "vlm", "audio", "moe") \
            or cfg.is_encoder_decoder:
        raise ValueError(f"int-code KV cache supports dense/GQA and MLA "
                         f"decode caches, not family {cfg.family!r}"
                         + (" (encoder-decoder)" if cfg.is_encoder_decoder
                            else ""))


def _code_shapes(cfg: ArchConfig, batch: int, max_len: int, wl: int,
                 block: int) -> Dict[str, tuple]:
    """{leaf: (shape, dtype)} of the code cache."""
    if max_len % block:
        raise ValueError(f"max_len={max_len} not a multiple of the scale "
                         f"block {block}")
    _check_family(cfg)
    n, nb = cfg.n_layers, max_len // block
    if cfg.use_mla:
        lat = cfg.kv_lora_rank + cfg.qk_rope_dim
        return {"lat_codes": ((n, batch, max_len, lat), code_dtype(wl)),
                "lat_scale": ((n, batch, nb), torch.float32)}
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    codes = ((n, batch, max_len, kv, hd), code_dtype(wl))
    scales = ((n, batch, nb, kv), torch.float32)
    return {"k_codes": codes, "v_codes": codes, "k_scale": scales,
            "v_scale": scales}


def init_code_cache(cfg: ArchConfig, batch: int, max_len: int, *, wl: int,
                    block: int = KV_BLOCK, device=None) -> Dict[str, Any]:
    """Zeroed int-code decode cache for one full model (layer-stacked),
    on ``device`` (the GPU unless told otherwise).

    Zero codes and zero scales are the empty state: zero codes contribute
    nothing under either Broken-Booth kind, and 0.0 marks every block as
    never written.
    """
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in _code_shapes(cfg, batch, max_len, wl,
                                               block).items()}


def code_cache_logical_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """Logical axis names per code-cache leaf."""
    _check_family(cfg)
    if cfg.use_mla:
        return {"lat_codes": ("layers", "batch", "seq_model", "kv_latent"),
                "lat_scale": ("layers", "batch", "blocks")}
    kvax = ("layers", "batch", "seq", "kv_heads", "head_dim")
    scax = ("layers", "batch", "blocks", "kv_heads")
    return {"k_codes": kvax, "v_codes": kvax,
            "k_scale": scax, "v_scale": scax}


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def cache_nbytes(cache) -> int:
    """Total bytes of a cache dict (tensors, nested dicts)."""
    return sum(cache_nbytes(c) if isinstance(c, dict)
               else c.numel() * c.element_size() for c in cache.values())


def float_cache_nbytes(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16) -> int:
    """Bytes of the float cache the code cache replaces (no allocation):
    k and v, (layers, batch, max_len, kv_heads, head_dim) each, or MLA's
    latent, (layers, batch, max_len, kv_lora + rope)."""
    if cfg.use_mla:
        return _nbytes((cfg.n_layers, batch, max_len,
                        cfg.kv_lora_rank + cfg.qk_rope_dim), dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return 2 * _nbytes(shape, dtype)


def memory_report(cfg: ArchConfig, batch: int, max_len: int, *, wl: int,
                  block: int = KV_BLOCK) -> Dict[str, Any]:
    """Code-vs-bf16 cache byte accounting (no allocation)."""
    shapes = _code_shapes(cfg, batch, max_len, wl, block)
    code = sum(_nbytes(*v) for k, v in shapes.items()
               if k.endswith("_codes"))
    scale = sum(_nbytes(*v) for k, v in shapes.items()
                if k.endswith("_scale"))
    bf16 = float_cache_nbytes(cfg, batch, max_len)
    return {"code_bytes": code, "scale_bytes": scale, "bf16_bytes": bf16,
            "ratio_codes": bf16 / code,
            "ratio_total": bf16 / (code + scale),
            "scale_overhead": scale / code}


def batch_axis_tree(axes: Dict[str, Any]) -> Dict[str, Any]:
    """Map a logical-axes dict to per-leaf batch-axis indices."""
    return {k: (batch_axis_tree(v) if isinstance(v, dict)
                else v.index("batch")) for k, v in axes.items()}


def slot_take(cache, ax_tree, i: int):
    """Batch-1 copy of slot ``i`` from every leaf (shape kept)."""
    return {k: (slot_take(c, ax_tree[k], i) if isinstance(c, dict)
                else c.narrow(ax_tree[k], i, 1).clone())
            for k, c in cache.items()}


def slot_put(cache, ax_tree, sub, i: int):
    """Write a batch-1 slice back into slot ``i`` of every leaf."""
    for k, c in cache.items():
        if isinstance(c, dict):
            slot_put(c, ax_tree[k], sub[k], i)
        else:
            c.narrow(ax_tree[k], i, 1).copy_(sub[k])
    return cache


def reset_slot(cache, ax_tree, i: int):
    """Zero slot ``i`` in every leaf: zero is the empty state of both
    cache kinds (zeroed codes contribute nothing, and zeroed block scales
    re-arm first-touch freezing)."""
    for k, c in cache.items():
        if isinstance(c, dict):
            reset_slot(c, ax_tree[k], i)
        else:
            c.narrow(ax_tree[k], i, 1).zero_()
    return cache
