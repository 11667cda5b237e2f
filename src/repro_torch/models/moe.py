"""The gated MLP (``repro.models.moe``: ``mlp_table`` and ``mlp_apply``).

The reference keeps the dense gated MLP beside its Mixture-of-Experts
block; the MoE dispatch itself is ROADMAP item A12.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import Spec, amm_dense

__all__ = ["mlp_table", "mlp_apply"]


def mlp_table(d_model: int, d_ff: int, prefix_axes=("embed", "mlp")) -> Dict:
    a_in, a_out = prefix_axes
    return {
        "w_gate": Spec((d_model, d_ff), (a_in, a_out)),
        "w_up": Spec((d_model, d_ff), (a_in, a_out)),
        "w_down": Spec((d_ff, d_model), (a_out, a_in)),
    }


def mlp_apply(p, x: torch.Tensor, amm=None, key=None,
              planes=None) -> torch.Tensor:
    """Gated MLP, ``silu(x @ w_gate) * (x @ w_up) @ w_down``.

    With ``amm.mlp_active`` each of the three products goes through
    ``amm_dense`` with the layer's ``key`` (the reference passes the same
    key to all three, so gate and up draw alike).
    ``planes``: the optional per-weight precode cache ``{"w_gate", "w_up",
    "w_down"}`` of ``AmmRuntime.precode`` entries (bitexact mode).
    """
    if amm is not None and amm.mlp_active:
        pl = planes or {}
        g = amm_dense(x, p["w_gate"], amm, key, planes=pl.get("w_gate"))
        u = amm_dense(x, p["w_up"], amm, key, planes=pl.get("w_up"))
        return amm_dense(F.silu(g) * u, p["w_down"], amm, key,
                         planes=pl.get("w_down"))
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
