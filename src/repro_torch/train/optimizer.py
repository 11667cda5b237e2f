"""Optimizers (AdamW, Adafactor-lite) and the warmup-cosine schedule.

Counterpart of ``repro.train.optimizer`` on parameter trees of tensors
(nested dicts and lists, leaves in sorted-key order as JAX flattens
them).  The
update is functional, as the reference's: ``apply_updates`` returns new
parameter and state tensors.  The scalars (step, learning rate, bias
corrections) are f32 tensors computed with the reference's expressions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

__all__ = ["OptConfig", "OptState", "init_opt", "apply_updates",
           "warmup_cosine", "global_norm", "clip_by_global_norm",
           "tree_leaves", "tree_map", "tree_unflatten"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10000


class OptState(NamedTuple):
    step: torch.Tensor           # 0-dim int32
    m: Any
    v: Any


def tree_leaves(tree) -> list:
    """Leaves of a nested dict (sorted keys) / tuple / list tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure (dicts in sorted-key order, lists,
    tuples, ``NamedTuple``s) holding ``leaves`` in ``tree_leaves``'
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)
    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts and lists: a MoE
    model's ``dense_prefix`` is a list of layers) and the matching nodes
    of ``rest``; a node of ``rest`` under a leaf of ``tree`` is passed
    whole (Adafactor's factored (row, col) pairs)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def init_opt(params, cfg: OptConfig) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,  # noqa
                                  device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    if cfg.kind == "adafactor":
        # factored second moment: row/col accumulators for >= 2-D params
        def fac(p):
            if p.dim() >= 2:
                return (torch.zeros(p.shape[:-1], dtype=cfg.state_dtype,
                                    device=p.device),
                        torch.zeros(p.shape[:-2] + p.shape[-1:],
                                    dtype=cfg.state_dtype, device=p.device))
            return zeros(p)
        return OptState(step, tree_map(zeros, params), tree_map(fac, params))
    return OptState(step, tree_map(zeros, params), tree_map(zeros, params))


def warmup_cosine(cfg: OptConfig):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                    0.1 + 0.9 * cos)
    return sched


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def apply_updates(params, grads, state: OptState, cfg: OptConfig
                  ) -> Tuple[Any, OptState, dict]:
    """One optimizer step.  Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = warmup_cosine(cfg)(step)
    t = step.to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32,  # noqa: E731
                                 device=t.device)
    bc1 = 1 - torch.pow(f32(cfg.b1), t)
    bc2 = 1 - torch.pow(f32(cfg.b2), t)
    sd = cfg.state_dtype

    def decay(p32, u):
        return p32 - lr * u - lr * cfg.weight_decay * p32

    if cfg.kind == "adafactor":
        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            if p.dim() >= 2:
                vr, vc = v
                vr32 = (cfg.b2 * vr.to(torch.float32)
                        + (1 - cfg.b2) * torch.mean(g32 * g32, dim=-1))
                vc32 = (cfg.b2 * vc.to(torch.float32)
                        + (1 - cfg.b2) * torch.mean(g32 * g32, dim=-2))
                rms = torch.sqrt(
                    vr32[..., :, None] * vc32[..., None, :]
                    / torch.clamp_min(torch.mean(vr32, dim=-1, keepdim=True)
                                      [..., None], 1e-30))
                u = g32 / torch.clamp_min(torch.sqrt(rms), cfg.eps)
                new_v = (vr32.to(sd), vc32.to(sd))
            else:
                v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g32 * g32
                u = g32 / (torch.sqrt(v32 / bc2) + cfg.eps)
                new_v = v32.to(sd)
            m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * u
            newp = decay(p.to(torch.float32), m32 / bc1)
            return newp.to(p.dtype), m32.to(sd), new_v
    else:
        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
            v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g32 * g32
            u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            newp = decay(p.to(torch.float32), u)
            return newp.to(p.dtype), m32.to(sd), v32.to(sd)

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda r: r[i], out)  # noqa: E731
    return pick(0), OptState(step, pick(1), pick(2)), {"lr": lr,
                                                      "gnorm": gnorm}
