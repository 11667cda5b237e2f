"""The LM over the dense, VLM, MoE, SSM, hybrid and encoder-decoder
families:

  * dense / vlm: [attention + gated MLP] x L (a VLM's image tokens are
    ordinary vocabulary entries);
  * moe:         a dense prefix then [attention + MoE] x L, with GQA or
                 multi-head latent attention (DeepSeek-V3);
  * ssm:         [Mamba2] x L;
  * hybrid:      groups of ``shared_attn_every`` Mamba2 layers, each
                 group followed by one weight-shared attention + MLP
                 block (Zamba2), whose KV cache is stacked per group;
  * encdec:      an encoder of [attention + gated MLP] x n_encoder_layers
                 over precomputed frame embeddings, then a decoder of
                 [self-attention + cross-attention + gated MLP] x L
                 (Whisper; the audio frontend is a stub).

Counterpart of ``repro.models.transformer``: ``ModelRuntime``,
``lm_table``/``lm_init``, ``init_cache``, ``lm_amm_planes`` and
``lm_apply`` in train, prefill and decode modes.
The reference scans its layers with ``jax.lax.scan``; here a Python loop
walks the layer-stacked parameters.  A MoE model's first
``first_k_dense`` layers are a list of unstacked dense layers
(``"dense_prefix"``), run first; its caches stay stacked over all
layers, prefix first.  The residual stream is bf16 and the float cache
bf16, as in the reference.

The attention caches are written in place; the SSM leaves (``ssm``, f32,
and ``conv``) are returned as new tensors, as the reference returns
them: the conv state comes back f32 whatever the cache held (the bf16
history is promoted by the f32 projection), so a cache's ``conv`` leaf
changes dtype with its first decode, and a caller rebinds the caches it
gets back (ROADMAP C12).

The encoder-decoder family follows the reference's quirks: every call
needs ``encoder_embeds`` and runs the whole encoder again, decode
included; the cross-attention reads that call's f32 keys and values and
writes their bf16 casts into the ``xk``/``xv`` cache leaves, which
nothing reads (ROADMAP C15).  The encoder's self-attention is causal
(C13), every encoder layer's MLP takes the root key (C14), and the
cross-attention takes the chunked schedule whatever
``use_pallas_attention`` says (C16): only the encoder's and the
decoder's self-attention can run on the flash kernels.

The bitexact datapath's weight side is precoded once for fixed weights
(``lm_amm_planes``, ``ModelRuntime.build_planes``) and threaded through
``lm_apply(amm_planes=)``; the caches are the float cache
(``init_cache``) or the int-code cache (``serve.kv_cache``), which the
attention layer tells apart by their leaves.  The encoder-decoder family
caches no planes: its MLPs precode their weights in every call, as the
reference's do.

The noise follows the reference's key chain: ``lm_apply`` starts from
``jax.random.key(rng)`` (``rng`` defaults to 0, as the reference's
serving path never passes one), splits it once per layer (a MoE model's
prefix first, then its stack from the carried key), and the layer's
``amm_dense`` calls share the layer key (the plain noise branch draws
from it; the fused kernel takes ``randint(layer key)`` as its seed).
``core.prng`` computes both on the host, cached.

In the hybrid, the shared block of each group takes the group's key: one
split of the chain per group, after its Mamba2 layers, which take none.
In the encoder-decoder family the decoder's layers split the chain from
the root key; the encoder's layers take the root key itself.

``lm_loss`` is the training loss of the cacheless train mode, with the
MoE family's load-balance term and DeepSeek-V3's MTP block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..core import prng
from ..core.prng import layer_keys
from ..device import pin_fp32, resolve_device
from .attention import (_expand_f32, attention, attn_table, mla_attention,
                        mla_table)
from .common import (AmmRuntime, Spec, apply_rope, cross_entropy_loss,
                     init_params, param_logical_axes, rmsnorm)
from .mamba2 import mamba_apply, mamba_table
from .moe import mlp_apply, mlp_table, moe_apply, moe_table

__all__ = ["ModelRuntime", "lm_table", "lm_init", "lm_apply", "lm_loss",
           "lm_amm_planes", "lm_logical_axes", "init_cache"]


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


def _family(cfg: ArchConfig) -> str:
    """The stack ``cfg`` runs: "dense" (a VLM's stack, and an audio
    config's without an encoder, are the dense one), "encdec" (the dense
    and audio families with ``is_encoder_decoder``), "moe", "ssm" or
    "hybrid"."""
    if cfg.family in ("dense", "vlm", "audio") and not cfg.use_mla:
        return "encdec" if cfg.is_encoder_decoder else "dense"
    if cfg.family in ("moe", "ssm", "hybrid"):
        return cfg.family
    raise ValueError(
        f"model family {cfg.family!r} of {cfg.name!r} (use_mla="
        f"{cfg.use_mla}) is not one the reference's registry runs: the "
        f"dense, VLM, audio, MoE, SSM and hybrid families are")


def _stack(table: Dict, n: int) -> Dict:
    """Prefix every Spec with a stacked 'layers' axis."""
    if isinstance(table, Spec):
        return Spec((n,) + table.shape, ("layers",) + table.axes, table.init,
                    table.scale)
    return {k: _stack(v, n) for k, v in table.items()}


def _attn_block_table(cfg: ArchConfig) -> Dict[str, Any]:
    return {"attn_norm": Spec((cfg.d_model,), ("embed",), "ones"),
            "attn": mla_table(cfg) if cfg.use_mla else attn_table(cfg)}


def _dense_layer_table(cfg: ArchConfig) -> Dict[str, Any]:
    t = _attn_block_table(cfg)
    t["mlp_norm"] = Spec((cfg.d_model,), ("embed",), "ones")
    t["mlp"] = mlp_table(cfg.d_model, cfg.d_ff)
    return t


def _moe_layer_table(cfg: ArchConfig) -> Dict[str, Any]:
    t = _attn_block_table(cfg)
    t["mlp_norm"] = Spec((cfg.d_model,), ("embed",), "ones")
    t["moe"] = moe_table(cfg)
    return t


def _ssm_layer_table(cfg: ArchConfig) -> Dict[str, Any]:
    return {"norm": Spec((cfg.d_model,), ("embed",), "ones"),
            "mamba": mamba_table(cfg)}


def _groups(cfg: ArchConfig) -> int:
    """A hybrid's number of (Mamba2 group, shared block) pairs."""
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of shared_attn_every "
                         f"{cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


def lm_table(cfg: ArchConfig) -> Dict[str, Any]:
    family = _family(cfg)
    d, v = cfg.d_model, cfg.vocab
    t: Dict[str, Any] = {
        "embed": Spec((v, d), ("vocab", "embed"), "normal", 0.01),
        "final_norm": Spec((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = Spec((d, v), ("embed", "vocab"), "normal", 0.01)
    if family == "dense":
        t["layers"] = _stack(_dense_layer_table(cfg), cfg.n_layers)
        return t
    if family == "encdec":
        t["encoder"] = {
            "layers": _stack(_dense_layer_table(cfg), cfg.n_encoder_layers),
            "norm": Spec((d,), ("embed",), "ones")}
        dec = _dense_layer_table(cfg)
        dec["xattn_norm"] = Spec((d,), ("embed",), "ones")
        dec["xattn"] = attn_table(cfg)
        t["layers"] = _stack(dec, cfg.n_layers)
        return t
    if family == "ssm":
        t["layers"] = _stack(_ssm_layer_table(cfg), cfg.n_layers)
        return t
    if family == "hybrid":                        # (groups, per, ...)
        t["layers"] = _stack(_stack(_ssm_layer_table(cfg),
                                    cfg.shared_attn_every), _groups(cfg))
        t["shared_block"] = _dense_layer_table(cfg)
        return t
    t["dense_prefix"] = [_dense_layer_table(cfg)
                         for _ in range(cfg.first_k_dense)]
    t["layers"] = _stack(_moe_layer_table(cfg),
                         cfg.n_layers - cfg.first_k_dense)
    if cfg.mtp_depth:
        # the multi-token-prediction block (serving never reads it; its
        # loss term is lm_loss's)
        mtp = _moe_layer_table(cfg)
        mtp["proj"] = Spec((2 * d, d), (None, "embed"))
        mtp["norm"] = Spec((d,), ("embed",), "ones")
        t["mtp"] = mtp
    return t


def lm_init(cfg: ArchConfig, seed: int = 0, *, device=None,
            dtype=torch.float32):
    """Random parameters on ``device`` (the GPU unless told otherwise),
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_params(lm_table(cfg), gen, device=dev, dtype=dtype)


def lm_logical_axes(cfg: ArchConfig):
    """``lm_table``'s tree of logical axis tuples."""
    return param_logical_axes(lm_table(cfg))


def lm_amm_planes(cfg: ArchConfig, amm: AmmRuntime, params):
    """The precode cache of every weight ``amm_dense`` approximates: for
    the dense family ``{"layers": {"mlp": {"w_gate", "w_up", "w_down"}}}``,
    each an ``AmmRuntime.precode`` entry of the layer stack (codes (L, K,
    N), one scale per layer), sliced per layer by ``lm_apply``; for the
    MoE family ``{"dense_prefix": [{"mlp": ...} per prefix layer]}`` and,
    with a shared expert, ``"layers": {"moe": {"shared": ...}}`` stacked
    (the routed experts are not approximated); for the hybrid
    ``{"shared_block": {"mlp": ...}}``, once for every group.  None when
    the mode caches nothing (not bitexact, or a non-Booth family), when
    no MLP product is approximated (``apply_to="attn"``), for the SSM
    family, which has no approximated product, and for the
    encoder-decoder family, whose MLPs precode their weights in every
    call, as the reference's do."""
    if not (amm.cacheable and amm.mlp_active):
        return None
    family = _family(cfg)
    if family in ("ssm", "encdec"):
        return None

    def mlp(p):
        return {k: amm.precode(p[k]) for k in ("w_gate", "w_up", "w_down")}
    if family == "dense":
        return {"layers": {"mlp": mlp(params["layers"]["mlp"])}}
    if family == "hybrid":
        return {"shared_block": {"mlp": mlp(params["shared_block"]["mlp"])}}
    planes = {"dense_prefix": [{"mlp": mlp(p["mlp"])}
                               for p in params["dense_prefix"]]}
    if cfg.n_shared_experts:
        planes["layers"] = {"moe": {"shared": mlp(
            params["layers"]["moe"]["shared"])}}
    return planes


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Layer-stacked decode caches: k, v (L, B, max_len, KV, head_dim);
    with MLA the compressed latent, (L, B, max_len, kv_lora + rope); for
    the SSM family the scan state ``ssm`` (L, B, H, P, N) f32 and the
    conv history ``conv`` (L, B, conv - 1, conv_dim) in ``dtype``; for the
    hybrid the same with (groups, per) for L, and k, v stacked over the
    groups (one shared-block call each); for the encoder-decoder family
    k, v and the cross-attention's ``xk``, ``xv`` (L, B, encoder_len, KV,
    head_dim)."""
    family = _family(cfg)
    dev = resolve_device(device)
    if family in ("ssm", "hybrid"):
        lead = ((cfg.n_layers,) if family == "ssm"
                else (_groups(cfg), cfg.shared_attn_every))
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        c = {"ssm": torch.zeros(lead + (batch, cfg.ssm_heads,
                                        cfg.ssm_headdim, cfg.ssm_state),
                                dtype=torch.float32, device=dev),
             "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                                 dtype=dtype, device=dev)}
        if family == "hybrid":
            shape = (_groups(cfg), batch, max_len, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            c["k"] = torch.zeros(shape, dtype=dtype, device=dev)
            c["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        return c
    if cfg.use_mla:
        return {"latent": torch.zeros(
            (cfg.n_layers, batch, max_len,
             cfg.kv_lora_rank + cfg.qk_rope_dim), dtype=dtype, device=dev)}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
         "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if family == "encdec":
        xshape = (cfg.n_layers, batch, cfg.encoder_len, cfg.n_kv_heads,
                  cfg.resolved_head_dim)
        c["xk"] = torch.zeros(xshape, dtype=dtype, device=dev)
        c["xv"] = torch.zeros(xshape, dtype=dtype, device=dev)
    return c


def _attn_block(p, h, cfg, rt, *, positions, cache=None, pos=None):
    amm = rt.amm if rt.amm.attn_active else None
    x = rmsnorm(h, p["attn_norm"], cfg.norm_eps)
    if cfg.use_mla:        # never the flash kernels, as in the reference
        y, new_cache = mla_attention(p["attn"], x, cfg, positions=positions,
                                     cache=cache, pos=pos, amm=amm)
    else:
        y, new_cache = attention(p["attn"], x, cfg, positions=positions,
                                 cache=cache, pos=pos,
                                 use_pallas=rt.use_pallas_attention, amm=amm)
    return h + y.to(h.dtype), new_cache


def _dense_block(p, h, cfg, rt, key, *, positions, cache=None, pos=None,
                 planes=None):
    h, new_cache = _attn_block(p, h, cfg, rt, positions=positions,
                               cache=cache, pos=pos)
    y = mlp_apply(p["mlp"], rmsnorm(h, p["mlp_norm"], cfg.norm_eps), rt.amm,
                  key, planes=(planes or {}).get("mlp"))
    return h + y.to(h.dtype), new_cache


def _moe_block(p, h, cfg, rt, key, *, positions, cache=None, pos=None,
               planes=None):
    h, new_cache = _attn_block(p, h, cfg, rt, positions=positions,
                               cache=cache, pos=pos)
    y, aux = moe_apply(p["moe"], rmsnorm(h, p["mlp_norm"], cfg.norm_eps),
                       cfg, amm=rt.amm, key=key,
                       planes=(planes or {}).get("moe"))
    return h + y.to(h.dtype), new_cache, aux


def _ssm_block(p, h, cfg, *, state=None, conv_state=None):
    y, new_states = mamba_apply(p["mamba"], rmsnorm(h, p["norm"],
                                                    cfg.norm_eps),
                                cfg, state=state, conv_state=conv_state)
    return h + y.to(h.dtype), new_states


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def lm_apply(params, cfg: ArchConfig, rt: ModelRuntime, tokens, *,
             mode: str = "train", caches=None, pos=None,
             rng=None, encoder_embeds=None, amm_planes=None):
    """Forward pass.

    tokens: (B, S) integer tokens (S == 1 to decode against caches).
    caches: optional ``init_cache`` dict or int-code cache
    (``serve.kv_cache.init_code_cache``; MLA's latent caches for
    deepseek-v3), stacked over all layers (a MoE model's dense prefix
    first), its attention leaves updated in place at ``pos`` (a
    scalar, or a (B,) per-slot vector under continuous batching); the
    returned dict holds them and, for the SSM and hybrid families, the
    new ``ssm`` and ``conv`` leaves (new tensors, conv f32: rebind the
    caches to what comes back).  A multi-token call against SSM state
    prefills from the empty state.  Without caches the attention is the
    cacheless causal schedule (train and prefill), or the flash kernels
    with ``rt.use_pallas_attention``.  rng: the key the noise seeds derive
    from, as an int seed (``jax.random.key(rng)``; default 0) or a
    ``core.prng`` key.  encoder_embeds: (B, encoder_len, d_model) frame
    embeddings, which the encoder-decoder family needs in every call
    (``ValueError`` without them; the reference asserts) and the other
    families ignore.  amm_planes: an optional ``lm_amm_planes`` cache,
    bit-identical to none.
    Returns (logits f32 (B, S, vocab), aux losses, caches).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    family = _family(cfg)
    pin_fp32()
    embed = params["embed"]
    dev = embed.device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.int64)
    root = rng if isinstance(rng, tuple) else (0 if rng is None else int(rng))
    h = embed[tokens].to(torch.bfloat16)
    b, s = tokens.shape
    off = torch.as_tensor(0 if pos is None else pos, device=dev).to(
        torch.int32)
    if off.ndim == 1:
        off = off[:, None]
    positions = (torch.arange(s, dtype=torch.int32, device=dev)[None, :]
                 + off) * torch.ones((b, 1), dtype=torch.int32, device=dev)
    aux = {"moe_aux": 0.0}
    if family == "ssm":
        h, new_caches = _ssm_stack(params["layers"], h, cfg, caches)
    elif family == "hybrid":
        h, new_caches = _hybrid_stack(params, h, cfg, rt, caches, root,
                                      amm_planes, positions=positions,
                                      pos=pos)
    elif family == "encdec":
        if encoder_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                             f"lm_apply needs encoder_embeds (B, "
                             f"{cfg.encoder_len}, {cfg.d_model})")
        enc_out = _encoder(params["encoder"], encoder_embeds, cfg, rt, root,
                           b, h.dtype)
        h = _decoder_stack(params["layers"], h, enc_out, cfg, rt, caches,
                           root, positions=positions, pos=pos)
        new_caches = caches if caches is not None else {}
    else:
        h, aux["moe_aux"] = _attn_stack(params, h, cfg, rt, caches, root,
                                        amm_planes, positions=positions,
                                        pos=pos)
        new_caches = caches if caches is not None else {}
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    head = embed.T if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ head.to(h.dtype)).to(torch.float32)
    return logits, aux, new_caches


def _ssm_layers(p_stack, h, cfg, n: int, ssm=None, conv=None):
    """``n`` layer-stacked Mamba2 layers, with their states stacked the
    same way (``ssm``, ``conv``) or None; returns (h, [new ssm states],
    [new conv states])."""
    new_s, new_c = [], []
    for i in range(n):
        h, (ns, nc) = _ssm_block(_layer(p_stack, i), h, cfg,
                                 state=None if ssm is None else ssm[i],
                                 conv_state=None if conv is None else conv[i])
        new_s.append(ns)
        new_c.append(nc)
    return h, new_s, new_c


def _ssm_stack(p_stack, h, cfg, caches):
    """The SSM family's stack; returns (h, the new ``{"ssm", "conv"}``
    leaves, or {} without caches)."""
    if caches is None:
        return _ssm_layers(p_stack, h, cfg, cfg.n_layers)[0], {}
    h, new_s, new_c = _ssm_layers(p_stack, h, cfg, cfg.n_layers,
                                  caches["ssm"], caches["conv"])
    return h, {"ssm": torch.stack(new_s), "conv": torch.stack(new_c)}


def _hybrid_stack(params, h, cfg, rt, caches, root, amm_planes, *,
                  positions, pos):
    """The hybrid's groups: ``shared_attn_every`` Mamba2 layers, then the
    shared block on the group's key and its slice of the k, v caches.
    Returns (h, the caches with new ``ssm`` and ``conv`` leaves, or {})."""
    groups, per = _groups(cfg), cfg.shared_attn_every
    keys = layer_keys(root, groups)
    shared = params["shared_block"]
    planes = (amm_planes or {}).get("shared_block")
    new_s, new_c = [], []
    for g in range(groups):
        states = ((None, None) if caches is None
                  else (caches["ssm"][g], caches["conv"][g]))
        h, ns, nc = _ssm_layers(_layer(params["layers"], g), h, cfg, per,
                                *states)
        new_s += ns
        new_c += nc
        cache_g = (None if caches is None
                   else {"k": caches["k"][g], "v": caches["v"][g]})
        h, _ = _dense_block(shared, h, cfg, rt, keys[g], positions=positions,
                            cache=cache_g, pos=pos, planes=planes)
    if caches is None:
        return h, {}
    lead = (groups, per)
    return h, dict(caches,
                   ssm=torch.stack(new_s).reshape(lead + new_s[0].shape),
                   conv=torch.stack(new_c).reshape(lead + new_c[0].shape))


def _encoder(p_enc, embeds, cfg, rt, root, b: int, dtype):
    """The encoder stack over the frame embeddings, cast to the residual
    stream's dtype, then its final norm.  As in the reference, its
    self-attention is causal (``_attn_block`` without ``causal=False``:
    ROADMAP C13) and every layer's MLP takes the root key unsplit (C14)."""
    dev = p_enc["norm"].device
    e = torch.as_tensor(embeds, device=dev).to(dtype)
    epos = _positions(e.shape[1], b, dev)
    key = tuple(root) if isinstance(root, tuple) else prng.key(root)
    for i in range(cfg.n_encoder_layers):
        p_l = _layer(p_enc["layers"], i)
        e, _ = _attn_block(p_l, e, cfg, rt, positions=epos)
        y = mlp_apply(p_l["mlp"], rmsnorm(e, p_l["mlp_norm"], cfg.norm_eps),
                      rt.amm, key)
        e = e + y.to(e.dtype)
    return rmsnorm(e, p_enc["norm"], cfg.norm_eps)


def _positions(s: int, b: int, dev) -> torch.Tensor:
    """Positions 0..s-1 for each of ``b`` rows, (b, s) int32."""
    return (torch.arange(s, dtype=torch.int32, device=dev)[None, :]
            * torch.ones((b, 1), dtype=torch.int32, device=dev))


def _cross_kv(p, enc_out, enc_pos, cfg):
    """The cross-attention's keys and values from the encoder output, as
    the reference forms them: ``wk`` and ``wv`` products in the operands'
    common dtype, ``bk`` added under ``qkv_bias`` (``bv`` never), rope at
    the encoder positions on the keys alone."""
    ek = _expand_f32(enc_out, p["wk"], "bsd,dhk->bshk")
    ev = _expand_f32(enc_out, p["wv"], "bsd,dhk->bshk")
    if cfg.qkv_bias:
        ek = ek + p["bk"]
    return apply_rope(ek, enc_pos, cfg.rope_theta), ev


def _decoder_stack(p_stack, h, enc_out, cfg, rt, caches, root, *, positions,
                   pos):
    """The decoder: per layer self-attention (on the ``k``/``v`` caches
    when given), cross-attention over this call's encoder output
    (non-causal, the chunked schedule: ROADMAP C16) and the MLP on the
    layer's key.  With caches, the cross keys and values are written
    into ``xk``/``xv`` as their casts, which nothing reads (C15)."""
    keys = layer_keys(root, cfg.n_layers)
    xamm = rt.amm if rt.amm.attn_active else None
    enc_pos = _positions(enc_out.shape[1], h.shape[0], h.device)
    for i in range(cfg.n_layers):
        p_l = _layer(p_stack, i)
        cache_self = (None if caches is None
                      else {"k": caches["k"][i], "v": caches["v"][i]})
        h, _ = _attn_block(p_l, h, cfg, rt, positions=positions,
                           cache=cache_self, pos=pos)
        ek, ev = _cross_kv(p_l["xattn"], enc_out, enc_pos, cfg)
        xn, _ = attention(p_l["xattn"],
                          rmsnorm(h, p_l["xattn_norm"], cfg.norm_eps), cfg,
                          positions=positions, kv=(ek, ev), causal=False,
                          amm=xamm)
        h = h + xn.to(h.dtype)
        y = mlp_apply(p_l["mlp"], rmsnorm(h, p_l["mlp_norm"], cfg.norm_eps),
                      rt.amm, keys[i])
        if caches is not None:
            caches["xk"][i].copy_(ek.detach())
            caches["xv"][i].copy_(ev.detach())
        h = h + y.to(h.dtype)
    return h


def _attn_stack(params, h, cfg, rt, caches, root, amm_planes, *, positions,
                pos):
    """The dense and MoE stacks; returns (h, the MoE auxiliary loss)."""
    family = _family(cfg)
    keys = layer_keys(root, cfg.n_layers)
    planes = (amm_planes or {}).get("layers")
    # the layer's cache leaves, float ({"k", "v"} or {"latent"}) or code
    # ({"k_codes", ...} or {"lat_codes", "lat_scale"}): attention routes
    # on the keys.  A MoE model's prefix takes the first cache layers.
    prefix = params.get("dense_prefix", [])
    prefix_planes = (amm_planes or {}).get("dense_prefix")
    for i, p_l in enumerate(prefix):
        h, _ = _dense_block(p_l, h, cfg, rt, keys[i], positions=positions,
                            cache=None if caches is None
                            else _layer(caches, i), pos=pos,
                            planes=prefix_planes[i] if prefix_planes
                            else None)
    aux_total = 0.0
    if family == "moe":
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(cfg.n_layers - len(prefix)):
        i = len(prefix) + j
        cache_l = None if caches is None else _layer(caches, i)
        planes_l = None if planes is None else _layer(planes, j)
        if family == "dense":
            h, _ = _dense_block(_layer(params["layers"], j), h, cfg, rt,
                                keys[i], positions=positions, cache=cache_l,
                                pos=pos, planes=planes_l)
        else:
            h, _, aux = _moe_block(_layer(params["layers"], j), h, cfg, rt,
                                   keys[i], positions=positions,
                                   cache=cache_l, pos=pos, planes=planes_l)
            aux_total = aux_total + aux
    return h, aux_total


def lm_loss(params, cfg: ArchConfig, rt: ModelRuntime, tokens, labels, *,
            rng=None, encoder_embeds=None, moe_aux_weight: float = 1e-2,
            mtp_weight: float = 0.1):
    """Training loss: next-token cross entropy (with the z-loss), plus
    ``moe_aux_weight`` times the MoE family's summed Switch load-balance
    loss (0 for the other families), plus, with a multi-token-prediction
    block (``cfg.mtp_depth`` and ``params["mtp"]``), ``mtp_weight`` times
    its cross entropy.  Returns (total, {"ce", "moe_aux"} and "mtp" with
    the block).  ``encoder_embeds``: the encoder-decoder family's frame
    embeddings (``lm_apply``'s).

    The MTP block follows the reference line by line, which reads the
    token embeddings where DeepSeek-V3's reads the main stack's last
    hidden state (ROADMAP C17): its input is ``rmsnorm(embed[tokens])``
    beside ``embed[labels]`` (both bf16) times ``proj``, an f32 residual
    through one MoE block keyed by ``rng`` (``key(1)`` without one; the
    block's own load-balance term is dropped), the final norm and the
    head in f32, and the cross entropy against the labels rolled by one
    more position, the last position left out."""
    logits, aux, _ = lm_apply(params, cfg, rt, tokens, mode="train",
                              rng=rng, encoder_embeds=encoder_embeds)
    labels = torch.as_tensor(labels, device=logits.device).to(torch.int64)
    loss = cross_entropy_loss(logits, labels)
    total = loss + moe_aux_weight * aux["moe_aux"]
    metrics = {"ce": loss, "moe_aux": aux["moe_aux"]}
    if cfg.mtp_depth and "mtp" in params:
        p_m, embed = params["mtp"], params["embed"]
        toks = torch.as_tensor(tokens, device=embed.device).to(torch.int64)
        h_in = embed[toks].to(torch.bfloat16)
        emb_next = embed[labels].to(torch.bfloat16)
        normed = rmsnorm(h_in, p_m["norm"], cfg.norm_eps)
        h_m = torch.cat([normed, emb_next.to(normed.dtype)],
                        dim=-1) @ p_m["proj"]
        b, s = toks.shape
        positions = torch.arange(s, dtype=torch.int32, device=embed.device
                                 )[None, :] * torch.ones(
            (b, 1), dtype=torch.int32, device=embed.device)
        if rng is None:
            mtp_key = prng.key(1)
        else:
            mtp_key = tuple(rng) if isinstance(rng, tuple) \
                else prng.key(int(rng))
        h_m, _, _ = _moe_block(p_m, h_m, cfg, rt, mtp_key,
                               positions=positions)
        head = embed.T if cfg.tie_embeddings else params["lm_head"]
        logits_m = (rmsnorm(h_m, params["final_norm"], cfg.norm_eps)
                    @ head.to(h_m.dtype)).to(torch.float32)
        labels2 = torch.roll(labels, -1, dims=-1)
        mtp_loss = cross_entropy_loss(logits_m[:, :-1], labels2[:, :-1])
        total = total + mtp_weight * mtp_loss
        metrics["mtp"] = mtp_loss
    return total, metrics
