"""Shared model machinery: the parameter table, norms, RoPE, and the
paper's approximate-matmul (``amm``) layer.

Counterpart of ``repro.models.common``.  Parameters are declared once as
``Spec`` entries (shape, logical axes, init) and materialized by
``init_params`` with an explicit ``torch.Generator``: PyTorch cannot
reproduce ``jax.random``'s normals, so weights that must equal the
reference's come across through numpy instead (``convert``).

The amm layer has its three modes: "off", "noise" (the fused
``quant_matmul`` kernel with ``use_pallas``; else an f32 matmul of the
codes and ``jax.random.normal``'s draws from the layer key, added in the
``normal_draw`` kernel), "bitexact" (the Broken-Booth dot form, the
``bbm_dot_scaled`` kernel on the card, optionally on weight codes
precoded once by ``AmmRuntime.precode``; the non-Booth families take the
scalar oracle), and the attention-side ``amm_dot`` (every slice in one
``bbm_dot_coded_batched`` launch).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import AmmConfig
from ..core.multipliers import MulSpec
from ..core.noise import make_noise_model
from ..core.prng import key_seed
from ..device import pin_fp32
from ..kernels.bbm_matmul import bbm_dot_coded_batched, bbm_dot_scaled
from ..kernels.normal import noise_consts, normal_draw
from ..kernels.ops import quant_matmul
from ..kernels.ref import (AMM_BOOTH_KINDS, amm_approx_ref,
                           amm_effective_vbl, amm_quantize,
                           amm_quantize_slices, amm_scale)

__all__ = ["Spec", "init_params", "param_logical_axes", "rmsnorm",
           "rope_freqs", "apply_rope", "amm_dense", "amm_dot", "AmmRuntime",
           "cross_entropy_loss"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter tensor."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | small
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def _init_one(spec: Spec, generator, device, dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    scale = spec.scale if spec.init == "normal" else 1e-3
    out = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                      device=device)
    # scaled in place: a full-width expert stack is 15 GB in f32
    return out.mul_(scale).to(dtype)


def init_params(table: Dict[str, Any], generator: torch.Generator, *,
                device, dtype=torch.float32):
    """Materialize a nested dict of ``Spec`` into tensors on ``device``.

    Leaves are drawn in sorted-key order (the reference's tree order) from
    ``generator``, which must live on ``device``.
    """
    if isinstance(table, Spec):
        return _init_one(table, generator, device, dtype)
    if isinstance(table, dict):
        return {k: init_params(table[k], generator, device=device,
                               dtype=dtype) for k in sorted(table)}
    return [init_params(t, generator, device=device, dtype=dtype)
            for t in table]


def param_logical_axes(table: Dict[str, Any]):
    """The same tree with each ``Spec`` replaced by its logical axis
    tuple (mapped to mesh axes by ``parallel.logical``)."""
    if isinstance(table, Spec):
        return table.axes
    if isinstance(table, dict):
        return {k: param_logical_axes(table[k]) for k in sorted(table)}
    return [param_logical_axes(t) for t in table]


# ---------------------------------------------------------------- numerics
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """The reference's rmsnorm: the variance in f32, the normalized value
    rounded to x's dtype, then the weight (type promotion as in JAX)."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1,
                     keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)              # (d/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ----------------------------------------------------- approximate matmul
@dataclasses.dataclass(frozen=True)
class AmmRuntime:
    """Resolved runtime for an AmmConfig: the noise moments from the
    characterization cache, as Python floats."""
    cfg: AmmConfig
    mu: float = 0.0
    sigma: float = 0.0

    @staticmethod
    def build(cfg: AmmConfig, device=None) -> "AmmRuntime":
        """Noise mode characterizes the multiplier on ``device`` (None:
        the GPU, raising without one; "cpu"), once per process."""
        if cfg.mode != "noise":
            return AmmRuntime(cfg)
        spec = MulSpec(cfg.mul, cfg.wl, cfg.param)
        nm = make_noise_model(spec, sample=1 << 18, device=device)
        return AmmRuntime(cfg, mu=float(nm.mean), sigma=float(np.sqrt(nm.var)))

    @property
    def spec(self) -> MulSpec:
        return MulSpec(self.cfg.mul, self.cfg.wl, self.cfg.param)

    @property
    def cacheable(self) -> bool:
        """Does mode="bitexact" run the precodable dot-form datapath?"""
        return (self.cfg.mode == "bitexact"
                and self.cfg.mul in AMM_BOOTH_KINDS)

    @property
    def mlp_active(self) -> bool:
        """Do the MLP (weight-side) matmuls route through amm?"""
        return (self.cfg.mode != "off"
                and self.cfg.apply_to in ("mlp", "all"))

    @property
    def attn_active(self) -> bool:
        """Do the attention score/value products route through amm?

        Only the bitexact Booth-family datapath has an attention lowering;
        noise mode keeps attention exact even under apply_to="all".
        """
        return (self.cfg.mode == "bitexact"
                and self.cfg.mul in AMM_BOOTH_KINDS
                and self.cfg.apply_to in ("attn", "all"))

    @property
    def attn_lowering(self):
        """``(wl, vbl, kind)`` of the Booth-family dot-form lowering, the
        parameters of every bitexact attention product (``amm_dot`` and
        the flash-amm kernel), or None without one."""
        kind = AMM_BOOTH_KINDS.get(self.cfg.mul)
        if kind is None or self.cfg.mode != "bitexact":
            return None
        return (self.cfg.wl, amm_effective_vbl(self.spec), kind)

    def precode(self, w):
        """The per-weight cache entry of the bitexact datapath for a (K, N)
        weight, or a layer stack (L, K, N) of them: ``{"codes", "s_w"}``,
        the int32 wl-bit codes and the dynamic scale of each (K, N) slice
        (``amm_quantize``'s bits), or None when nothing is cacheable.  The
        reference caches the codes' digit planes; the port's kernel
        decodes the digits itself, so it caches what the kernel takes."""
        if not self.cacheable:
            return None
        codes, s_w = amm_quantize_slices(w, self.cfg.wl)
        return {"codes": codes.contiguous(), "s_w": s_w}


def _amm_bitexact_approx(x, w, rt: AmmRuntime, planes=None):
    """Forward value of mode="bitexact": the dot-form Broken-Booth matmul.

    Quantize x to codes (flattened to (M, K)), contract against the
    weight's codes on the datapath (``bbm_dot_scaled``: the kernel on the
    card, the plain dot form on the CPU), descale.  Non-Booth families
    have no dot lowering and take the scalar oracle.  ``planes``: an
    optional ``AmmRuntime.precode(w)`` entry.
    """
    cfg = rt.cfg
    kind = AMM_BOOTH_KINDS.get(cfg.mul)
    if kind is None:
        return amm_approx_ref(x, w, rt.spec)
    xq, s_x = amm_quantize(x, cfg.wl)
    if planes is None:
        planes = rt.precode(w)
    yq = bbm_dot_scaled(xq.reshape(-1, x.shape[-1]).contiguous(),
                        planes["codes"], wl=cfg.wl,
                        vbl=amm_effective_vbl(rt.spec), kind=kind)
    yq = yq.reshape(x.shape[:-1] + (w.shape[-1],))
    return (yq * (s_x * planes["s_w"])).to(x.dtype)


def amm_dense(x: torch.Tensor, w: torch.Tensor, rt: AmmRuntime, key=None,
              planes=None) -> torch.Tensor:
    """Matmul over the last axis of x with the paper's technique applied.

    x: (..., K), w: (K, N).  ``key``: the reference's key (a
    ``core.prng`` key), or None for no noise (mu = sigma = 0, seed 0).
    The fused kernel takes the int32 seed the reference draws from it
    (``prng.key_seed``); the plain noise branch draws from the key.

    Straight-through as in the reference: ``exact + (approx -
    exact).detach()``, which is not bitwise ``approx`` in f32, so it is
    kept as written.  Noise mode with ``use_pallas`` runs the fused
    ``quant_matmul`` kernel on the activation block flattened to
    (M, K), with the scales of ``amm_quantize`` (device scalars); without
    it, the codes' product ``yq`` in f32 (a plain matmul), then
    ``jax.random.normal(key, yq.shape)``'s draws folded in by one
    ``normal_draw`` launch as ``yq + mu*K + sigma*sqrt(K)*z`` compiles.
    Bitexact mode computes its forward value without a graph
    (``_amm_bitexact_approx``); ``planes``: an optional
    ``AmmRuntime.precode(w)`` entry, bit-identical to none.
    """
    pin_fp32()
    cfg = rt.cfg
    exact = x @ w
    if cfg.mode == "off":
        return exact
    if cfg.mode == "noise":
        if cfg.use_pallas:
            noisy = key is not None
            seed = key_seed((int(key[0]), int(key[1]))) if noisy else 0
            s_x = amm_scale(x, cfg.wl)
            s_w = amm_scale(w, cfg.wl)
            yq = quant_matmul(
                x.detach().reshape(-1, x.shape[-1]).to(torch.float32)
                .contiguous(),
                w.detach().to(torch.float32).contiguous(), s_x, s_w,
                rt.mu if noisy else 0.0, rt.sigma if noisy else 0.0,
                wl=cfg.wl, seed=seed)
            approx = yq.reshape(x.shape[:-1] + (w.shape[-1],)).to(x.dtype)
            return exact + (approx - exact).detach()
        with torch.no_grad():
            xq, s_x = amm_quantize(x.detach(), cfg.wl)
            wq, s_w = amm_quantize(w.detach(), cfg.wl)
            yq = xq.to(torch.float32) @ wq.to(torch.float32)
            if key is not None and (rt.mu != 0.0 or rt.sigma != 0.0):
                c1, c2 = noise_consts(rt.mu, rt.sigma, x.shape[-1])
                normal_draw(key, yq.shape, acc=yq, c1=c1, c2=c2)
            approx = (yq * (s_x * s_w)).to(x.dtype)
        return exact + (approx - exact).detach()
    if cfg.mode == "bitexact":
        with torch.no_grad():
            approx = _amm_bitexact_approx(x.detach(), w.detach(), rt,
                                          planes=planes)
        return exact + (approx - exact).detach()
    raise ValueError(f"unknown amm mode {cfg.mode!r}")


def amm_dot(a, b, rt: AmmRuntime, *, oracle: bool = False, ste: bool = True):
    """Both-operands-dynamic approximate matmul, the attention-side
    ``amm_dense``: contracts a's last axis against b's second-to-last,
    batched over matching leading axes, every (M, K) x (K, N) slice
    quantized with its own pair of scales (``bbm_matmul_dynamic`` of each
    slice): the slices' scales in one batched pass
    (``amm_quantize_slices``), every slice's product in one
    ``bbm_dot_coded_batched`` launch with the descale ``yq * (s_a * s_b)``
    in its epilogue.

    Straight-through: ``exact + (approx - exact).detach()``.  ``oracle``
    forms the products through the closed forms (``amm_dot_ref``);
    ``ste=False`` returns the approximate product itself.  Without a
    dot-form lowering this is the exact product.
    """
    pin_fp32()
    lowering = rt.attn_lowering
    if lowering is None:
        return a @ b
    with torch.no_grad():
        if oracle:
            from ..kernels.ref import amm_dot_ref
            approx = amm_dot_ref(a.detach(), b.detach(), rt.spec)
        else:
            wl, vbl, kind = lowering
            m, n = a.shape[-2], b.shape[-1]
            aq, s_a = amm_quantize_slices(
                a.detach().reshape((-1, 1) + a.shape[-2:]), wl)
            bq, s_b = amm_quantize_slices(
                b.detach().reshape((-1, 1) + b.shape[-2:]), wl)
            approx = bbm_dot_coded_batched(
                aq.contiguous(), s_a, bq, s_b[..., None], wl=wl, vbl=vbl,
                kind=kind, block=n, per="column")
            approx = approx.reshape(a.shape[:-2] + (m, n)).to(a.dtype)
    if not ste:
        return approx
    exact = a @ b
    return exact + (approx - exact).detach()


# ------------------------------------------------------------------- loss
def cross_entropy_loss(logits, labels, *, z_loss: float = 1e-4):
    """Mean token cross entropy (f32 logsumexp) plus the z-loss."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss
