"""Decoder-only LM, dense family: [attention + gated MLP] x L.

Counterpart of the dense half of ``repro.models.transformer``:
``ModelRuntime``, ``lm_table``/``lm_init``, ``init_cache`` and
``lm_apply`` in train, prefill and decode modes.  The reference scans
its layers with ``jax.lax.scan``; here a Python loop walks the
layer-stacked parameters.  The residual stream is bf16 and the float
cache bf16, as in the reference.

The bitexact datapath's weight side is precoded once for fixed weights
(``lm_amm_planes``, ``ModelRuntime.build_planes``) and threaded through
``lm_apply(amm_planes=)``; the caches are the float cache
(``init_cache``) or the int-code cache (``serve.kv_cache``), which the
attention layer tells apart by their leaves.

The noise follows the reference's key chain: ``lm_apply`` starts from
``jax.random.key(rng)`` (``rng`` defaults to 0, as the reference's
serving path never passes one), splits it once per layer, and the
layer's ``amm_dense`` calls share the layer key (the plain noise branch
draws from it; the fused kernel takes ``randint(layer key)`` as its
seed).  ``core.prng`` computes both on the host, cached.

The other families (MoE, SSM, hybrid, encoder-decoder, VLM) are ROADMAP
item A12 and raise ``NotImplementedError``.  ``lm_loss`` is the training
loss of the cacheless train mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..core.prng import layer_keys
from ..device import pin_fp32, resolve_device
from .attention import attention, attn_table
from .common import (AmmRuntime, Spec, cross_entropy_loss, init_params,
                     rmsnorm)
from .moe import mlp_apply, mlp_table

__all__ = ["ModelRuntime", "lm_table", "lm_init", "lm_apply", "lm_loss",
           "lm_amm_planes", "init_cache"]


@dataclasses.dataclass(frozen=True)
class ModelRuntime:
    """Static knobs threaded through apply.

    ``use_pallas_attention`` (the reference's name) sends the cacheless
    forward's attention through the flash kernels: the exact one, or the
    flash-amm one when attention is amm-active.  The reference's other
    knobs (remat, head sharding, causal skipping, bf16 probabilities) are
    performance levers of its TPU build and are not carried over.
    """
    amm: AmmRuntime
    use_pallas_attention: bool = False

    @staticmethod
    def build(cfg: ArchConfig, use_pallas: bool = False,
              device=None) -> "ModelRuntime":
        """``device``: where noise mode characterizes its multiplier
        (None: the GPU, raising without one; "cpu")."""
        return ModelRuntime(AmmRuntime.build(cfg.amm, device), use_pallas)

    def build_planes(self, cfg: ArchConfig, params):
        """``lm_amm_planes`` of these weights under this runtime's amm
        (None when nothing is cached)."""
        return lm_amm_planes(cfg, self.amm, params)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.is_encoder_decoder or cfg.use_mla:
        raise NotImplementedError(
            f"model family {cfg.family!r} of {cfg.name!r} is not ported yet "
            f"(ROADMAP item A12); the dense family is")


def _stack(table: Dict, n: int) -> Dict:
    """Prefix every Spec with a stacked 'layers' axis."""
    if isinstance(table, Spec):
        return Spec((n,) + table.shape, ("layers",) + table.axes, table.init,
                    table.scale)
    return {k: _stack(v, n) for k, v in table.items()}


def lm_table(cfg: ArchConfig) -> Dict[str, Any]:
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab
    t: Dict[str, Any] = {
        "embed": Spec((v, d), ("vocab", "embed"), "normal", 0.01),
        "final_norm": Spec((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = Spec((d, v), ("embed", "vocab"), "normal", 0.01)
    layer = {"attn_norm": Spec((d,), ("embed",), "ones"),
             "attn": attn_table(cfg),
             "mlp_norm": Spec((d,), ("embed",), "ones"),
             "mlp": mlp_table(d, cfg.d_ff)}
    t["layers"] = _stack(layer, cfg.n_layers)
    return t


def lm_init(cfg: ArchConfig, seed: int = 0, *, device=None,
            dtype=torch.float32):
    """Random parameters on ``device`` (the GPU unless told otherwise),
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_params(lm_table(cfg), gen, device=dev, dtype=dtype)


def lm_amm_planes(cfg: ArchConfig, amm: AmmRuntime, params):
    """The precode cache of every weight ``amm_dense`` approximates: for
    the dense family ``{"layers": {"mlp": {"w_gate", "w_up", "w_down"}}}``,
    each an ``AmmRuntime.precode`` entry of the layer stack (codes (L, K,
    N), one scale per layer), sliced per layer by ``lm_apply``.  None
    when the mode caches nothing (not bitexact, or a non-Booth family) or
    when no MLP product is approximated (``apply_to="attn"``)."""
    if not (amm.cacheable and amm.mlp_active):
        return None
    _check_family(cfg)
    mlp = params["layers"]["mlp"]
    return {"layers": {"mlp": {k: amm.precode(mlp[k])
                               for k in ("w_gate", "w_up", "w_down")}}}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Layer-stacked float KV cache: k, v (L, B, max_len, KV, head_dim)."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _attn_block(p, h, cfg, rt, *, positions, cache=None, pos=None):
    amm = rt.amm if rt.amm.attn_active else None
    y, new_cache = attention(p["attn"], rmsnorm(h, p["attn_norm"],
                                                cfg.norm_eps),
                             cfg, positions=positions, cache=cache, pos=pos,
                             use_pallas=rt.use_pallas_attention, amm=amm)
    return h + y.to(h.dtype), new_cache


def _dense_block(p, h, cfg, rt, key, *, positions, cache=None, pos=None,
                 planes=None):
    h, new_cache = _attn_block(p, h, cfg, rt, positions=positions,
                               cache=cache, pos=pos)
    y = mlp_apply(p["mlp"], rmsnorm(h, p["mlp_norm"], cfg.norm_eps), rt.amm,
                  key, planes=(planes or {}).get("mlp"))
    return h + y.to(h.dtype), new_cache


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def lm_apply(params, cfg: ArchConfig, rt: ModelRuntime, tokens, *,
             mode: str = "train", caches=None, pos=None,
             rng=None, amm_planes=None):
    """Forward pass.

    tokens: (B, S) integer tokens (S == 1 to decode against caches).
    caches: optional ``init_cache`` dict or int-code cache
    (``serve.kv_cache.init_code_cache``), updated in place at ``pos`` (a
    scalar, or a (B,) per-slot vector under continuous batching) and
    returned; without caches the attention is the cacheless causal
    schedule (train and prefill), or the flash kernels with
    ``rt.use_pallas_attention``.  rng: the key the noise seeds derive
    from, as an int seed (``jax.random.key(rng)``; default 0) or a
    ``core.prng`` key.  amm_planes: an optional ``lm_amm_planes`` cache,
    bit-identical to none.
    Returns (logits f32 (B, S, vocab), aux losses, caches).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_family(cfg)
    pin_fp32()
    embed = params["embed"]
    dev = embed.device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.int64)
    root = rng if isinstance(rng, tuple) else (0 if rng is None else int(rng))
    keys = layer_keys(root, cfg.n_layers)
    h = embed[tokens].to(torch.bfloat16)
    b, s = tokens.shape
    off = torch.as_tensor(0 if pos is None else pos, device=dev).to(
        torch.int32)
    if off.ndim == 1:
        off = off[:, None]
    positions = (torch.arange(s, dtype=torch.int32, device=dev)[None, :]
                 + off) * torch.ones((b, 1), dtype=torch.int32, device=dev)
    planes = (amm_planes or {}).get("layers")
    for i in range(cfg.n_layers):
        # the layer's leaves, float ({"k", "v"}) or code ({"k_codes",
        # "k_scale", "v_codes", "v_scale"}): attention routes on the keys
        cache_l = None if caches is None else _layer(caches, i)
        h, _ = _dense_block(_layer(params["layers"], i), h, cfg, rt,
                            keys[i], positions=positions, cache=cache_l,
                            pos=pos, planes=None if planes is None
                            else _layer(planes, i))
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    head = embed.T if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ head.to(h.dtype)).to(torch.float32)
    new_caches = caches if caches is not None else {}
    return logits, {"moe_aux": 0.0}, new_caches


def lm_loss(params, cfg: ArchConfig, rt: ModelRuntime, tokens, labels, *,
            rng=None, moe_aux_weight: float = 1e-2):
    """Training loss: next-token cross entropy (with the z-loss) plus the
    MoE auxiliary loss, which the dense family leaves at 0.  Returns
    (total, {"ce", "moe_aux"})."""
    logits, aux, _ = lm_apply(params, cfg, rt, tokens, mode="train",
                              rng=rng)
    labels = torch.as_tensor(labels, device=logits.device)
    loss = cross_entropy_loss(logits, labels)
    total = loss + moe_aux_weight * aux["moe_aux"]
    return total, {"ce": loss, "moe_aux": aux["moe_aux"]}
