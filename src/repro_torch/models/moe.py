"""The gated MLP and the Mixture-of-Experts block with sort-based capacity
dispatch (``repro.models.moe``).

Dispatch is the reference's dropping formulation: each token goes to its
top-k experts, each expert takes at most ``capacity`` tokens
(``max(int(capacity_factor * k * T / E), 1)``), and a decision past an
expert's capacity loses that expert's contribution.  It is built from a
stable sort, a bincount and scatters only (no (T, E, C) one-hot tensor).

The router is DeepSeek-V3's: sigmoid affinities in f32, top-k (ties to
the lower expert index, as ``jax.lax.top_k`` orders them), weights
normalized over the k, and a Switch-style load-balance loss.  The routed
experts run as three batched f32 products over (E, C, d) (TF32 pinned
off); they are not approximated, as in the reference.  The shared expert
is a gated MLP on the flattened (B*S, d) tokens through ``amm_dense``
with the layer key.

``moe_apply`` is ``moe_route``, then ``moe_combine``, plus the shared
expert.  The pieces are public for the checks alone, which hold one
side's routing against another's: ``chip_smoke.py``'s card-against-CPU
check (a layer's routing recomputed from the card's input, the CPU's
experts combined on the card's routing) and the CPU tests' route logs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import pin_fp32
from .common import Spec, amm_dense

__all__ = ["mlp_table", "mlp_apply", "moe_table", "moe_apply", "moe_route",
           "moe_capacity", "moe_combine"]


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


def moe_table(cfg: ArchConfig) -> Dict[str, Spec]:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    t = {
        "router": Spec((d, e), ("embed", "experts"), "normal", 0.006),
        "w_gate": Spec((e, d, ff), ("experts", "embed", "expert_mlp")),
        "w_up": Spec((e, d, ff), ("experts", "embed", "expert_mlp")),
        "w_down": Spec((e, ff, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        t["shared"] = mlp_table(d, ff * cfg.n_shared_experts)
    return t


def _dispatch(expert_ids: torch.Tensor, top_k: int, n_tokens: int,
              n_experts: int, capacity: int):
    """Gather indices from flat (T*k,) routing decisions.

    Returns (slot_token, token_slot), int32:
      slot_token: (E*C,) the token feeding each expert slot (T = pad);
      token_slot: (T*k,) the slot each decision landed in (E*C = dropped).
    Decisions are sorted by expert, stably (token order within an
    expert); a decision's rank within its expert past ``capacity`` is
    dropped: its slot index is the out-of-range E*C, which the scatter
    into ``slot_token`` leaves out (the reference's ``mode="drop"``).
    """
    dev = expert_ids.device
    ids = expert_ids.to(torch.int64)
    tk = ids.shape[0]
    order = torch.argsort(ids, stable=True)                    # (T*k,)
    sorted_e = ids[order]
    counts = torch.bincount(ids, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts                   # (E,)
    rank = torch.arange(tk, device=dev) - starts[sorted_e]
    keep = rank < capacity
    nc = n_experts * capacity
    slot = sorted_e * capacity + torch.clamp(rank, max=capacity - 1)
    oob = torch.where(keep, slot, nc)
    slot_token = torch.full((nc,), n_tokens, dtype=torch.int32, device=dev)
    slot_token[oob[keep]] = torch.div(order[keep], top_k,
                                      rounding_mode="floor").to(torch.int32)
    token_slot = torch.full((tk,), nc, dtype=torch.int32, device=dev)
    token_slot[order] = oob.to(torch.int32)
    return slot_token, token_slot


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index first (``jax.lax.top_k``'s order): a stable descending
    sort keeps equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, xf: torch.Tensor, cfg: ArchConfig):
    """The router on flattened tokens xf (T, d): (logits (T, E) f32,
    normalized gate weights (T, k) f32, expert indices (T, k) int64, the
    Switch load-balance loss, an f32 scalar)."""
    pin_fp32()
    e, k = cfg.n_experts, cfg.top_k
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.sigmoid(logits)
    gate_vals, gate_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    sprobs = torch.softmax(logits, dim=-1)
    frac_routed = torch.mean(F.one_hot(gate_idx[:, 0], e).to(torch.float32),
                             dim=0)
    aux = e * torch.sum(frac_routed * torch.mean(sprobs, dim=0))
    return logits, gate_vals, gate_idx, aux


def moe_capacity(cfg: ArchConfig, b: int, s: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert for a (B, S) call: ``max(int(capacity_factor * k *
    T / E), 1)`` with T = B*S; a decode call (S == 1) takes
    ``capacity_factor = E / k``, so capacity == T and nothing drops."""
    e, k = cfg.n_experts, cfg.top_k
    if s == 1:
        capacity_factor = e / k
    return max(int(capacity_factor * k * (b * s) / e), 1)


def moe_combine(p, xf: torch.Tensor, gate_vals: torch.Tensor,
                gate_idx: torch.Tensor, cfg: ArchConfig,
                capacity: int) -> torch.Tensor:
    """The routed experts' output (T, d) for given routing decisions:
    dispatch into (E, C, d), three batched products, gather back, and the
    gate-weighted sum over each token's k decisions."""
    pin_fp32()
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    slot_token, token_slot = _dispatch(gate_idx.reshape(-1), k, t, e,
                                       capacity)
    xg = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = xg[slot_token.to(torch.int64)].reshape(e, capacity, d)
    w_gate, w_up, w_down = (p[n].to(xe.dtype)
                            for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h.to(xe.dtype), w_down)                      # (E, C, d)
    yflat = torch.cat([ye.reshape(e * capacity, d),
                       ye.new_zeros((1, d))], dim=0)
    per_decision = yflat[token_slot.to(torch.int64)].reshape(t, k, d)
    return torch.einsum("tkd,tk->td", per_decision,
                        gate_vals.to(per_decision.dtype))


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, *,
              capacity_factor: float = 1.25, amm=None, key=None,
              planes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss).

    A decode call (S == 1) runs dropless (``moe_capacity``).  ``amm``,
    ``key`` and ``planes`` (``{"shared": {...}}``, the precode cache of
    the shared expert) reach the shared expert alone.
    """
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    _, gate_vals, gate_idx, aux = moe_route(p, xf, cfg)
    y = moe_combine(p, xf, gate_vals, gate_idx, cfg,
                    moe_capacity(cfg, b, s, capacity_factor))
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], xf, amm, key,
                          planes=(planes or {}).get("shared"))
    return y.reshape(b, s, d), aux
