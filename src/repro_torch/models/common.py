"""Shared model machinery: the parameter table, norms, RoPE, and the
paper's approximate-matmul (``amm``) layer.

Counterpart of ``repro.models.common``.  Parameters are declared once as
``Spec`` entries (shape, logical axes, init) and materialized by
``init_params`` with an explicit ``torch.Generator``: PyTorch cannot
reproduce ``jax.random``'s normals, so weights that must equal the
reference's come across through numpy instead (``convert``).

What this slice ports of the amm layer: modes "off" and "noise".  Mode
"bitexact", ``amm_dot`` (attention-side amm) and the plain noise branch
with a key and non-zero moments (it draws with ``jax.random.normal``)
raise ``NotImplementedError`` naming the slice that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import AmmConfig
from ..core.multipliers import MulSpec
from ..core.noise import make_noise_model
from ..device import pin_fp32
from ..kernels.ops import quant_matmul
from ..kernels.ref import amm_quantize, amm_scale

__all__ = ["Spec", "init_params", "rmsnorm", "rope_freqs", "apply_rope",
           "amm_dense", "amm_dot", "AmmRuntime"]

_BITEXACT = ("the bitexact Broken-Booth datapath is ROADMAP slice 3 "
             "(A4/A5, the _dot_scaled hand kernel B2)")


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
    return (out * scale).to(dtype)


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
    def build(cfg: AmmConfig) -> "AmmRuntime":
        if cfg.mode == "bitexact":
            raise NotImplementedError(f"amm mode 'bitexact': {_BITEXACT}")
        if cfg.mode != "noise":
            return AmmRuntime(cfg)
        spec = MulSpec(cfg.mul, cfg.wl, cfg.param)
        nm = make_noise_model(spec, sample=1 << 18)
        return AmmRuntime(cfg, mu=float(nm.mean), sigma=float(np.sqrt(nm.var)))

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
                and self.cfg.mul in ("booth", "bbm0", "bbm1")
                and self.cfg.apply_to in ("attn", "all"))


def amm_dense(x: torch.Tensor, w: torch.Tensor, rt: AmmRuntime,
              seed: Optional[int] = None) -> torch.Tensor:
    """Matmul over the last axis of x with the paper's technique applied.

    x: (..., K), w: (K, N).  ``seed`` stands for the reference's ``key``:
    the int32 noise seed the reference draws from it (``core.prng``), or
    None for no key (then no noise: mu = sigma = 0, seed 0).

    Straight-through as in the reference: ``exact + (approx -
    exact).detach()``, which is not bitwise ``approx`` in f32, so it is
    kept as written.  Noise mode with ``use_pallas`` runs the fused
    ``quant_matmul`` kernel on the activation block flattened to
    (M, K), with the scales of ``amm_quantize`` (device scalars).
    """
    pin_fp32()
    cfg = rt.cfg
    exact = x @ w
    if cfg.mode == "off":
        return exact
    if cfg.mode == "noise":
        noisy = seed is not None
        if cfg.use_pallas:
            s_x = amm_scale(x, cfg.wl)
            s_w = amm_scale(w, cfg.wl)
            yq = quant_matmul(
                x.detach().reshape(-1, x.shape[-1]).to(torch.float32)
                .contiguous(),
                w.detach().to(torch.float32).contiguous(), s_x, s_w,
                rt.mu if noisy else 0.0, rt.sigma if noisy else 0.0,
                wl=cfg.wl, seed=seed if noisy else 0)
            approx = yq.reshape(x.shape[:-1] + (w.shape[-1],)).to(x.dtype)
            return exact + (approx - exact).detach()
        if noisy and (rt.mu != 0.0 or rt.sigma != 0.0):
            raise NotImplementedError(
                "noise mode without use_pallas draws its keyed noise with "
                "jax.random.normal, whose bits are not ported "
                "(ROADMAP A10); use use_pallas=True")
        xq, s_x = amm_quantize(x, cfg.wl)
        wq, s_w = amm_quantize(w, cfg.wl)
        yq = xq.to(torch.float32) @ wq.to(torch.float32)
        approx = (yq * (s_x * s_w)).to(x.dtype)
        return exact + (approx - exact).detach()
    if cfg.mode == "bitexact":
        raise NotImplementedError(f"amm mode 'bitexact': {_BITEXACT}")
    raise ValueError(f"unknown amm mode {cfg.mode!r}")


def amm_dot(a, b, rt: AmmRuntime, *, oracle: bool = False, ste: bool = True):
    """The attention-side amm product (both operands dynamic): its only
    lowering is the bitexact datapath, not ported yet."""
    raise NotImplementedError(f"amm_dot: {_BITEXACT}")
