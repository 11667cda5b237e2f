"""The train step: microbatched loss and gradients, then the update.

Counterpart of ``repro.train.trainstep`` on one device: the body of the
reference's jitted ``step`` without its mesh and shardings (those are
ROADMAP item A13, the parallel half).  Gradients come from autograd
through ``lm_loss``; the kernels' forward values enter it through the
straight-through rule, so no gradient passes through a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core import prng
from ..models import ModelRuntime, lm_loss
from .optimizer import OptConfig, apply_updates, tree_leaves, tree_map

__all__ = ["TrainConfig", "loss_and_grads", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    param_dtype: Any = torch.float32


def _key(rng) -> prng.Key:
    if isinstance(rng, tuple):
        return rng
    return prng.key(0 if rng is None else int(rng))


def _value_and_grad(params, cfg, rt, tokens, labels, key, enc):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = lm_loss(leaves, cfg, rt, tokens, labels, rng=key,
                            encoder_embeds=enc)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), grads, {k: torch.as_tensor(v).detach()
                                  for k, v in metrics.items()}


def loss_and_grads(params, cfg: ArchConfig, rt: ModelRuntime, tokens,
                   labels, rng, *, microbatches: int = 1,
                   encoder_embeds=None):
    """Mean loss and gradients over ``microbatches`` equal slices of the
    batch, each with its own key (``prng.split(rng, microbatches)``) and
    its slice of ``encoder_embeds`` (an encoder-decoder model's frame
    embeddings), the gradients summed in f32 and scaled once, as the
    reference's scan.  Returns (loss, grads, metrics of the last
    microbatch)."""
    if microbatches == 1:
        return _value_and_grad(params, cfg, rt, tokens, labels, rng,
                               encoder_embeds)
    b = tokens.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} "
                         f"microbatches")
    mb = b // microbatches
    keys = prng.split(_key(rng), microbatches)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
    grad_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    metrics = {}
    for i in range(microbatches):
        sl = slice(i * mb, (i + 1) * mb)
        loss, grads, metrics = _value_and_grad(
            params, cfg, rt, tokens[sl], labels[sl], keys[i],
            None if encoder_embeds is None else encoder_embeds[sl])
        grad_acc = tree_map(lambda a, g: a + g.to(a.dtype), grad_acc, grads)
        loss_sum = loss_sum + loss
    inv = 1.0 / microbatches
    return loss_sum * inv, tree_map(lambda g: g * inv, grad_acc), metrics


def make_train_step(cfg: ArchConfig, rt: ModelRuntime, tc: TrainConfig):
    """``step(params, opt_state, tokens, labels, rng, encoder_embeds=None)
    -> (params, opt_state, metrics)`` on the device the parameters live
    on; ``encoder_embeds``: an encoder-decoder model's frame
    embeddings."""
    def step(params, opt_state, tokens, labels, rng, encoder_embeds=None):
        loss, grads, metrics = loss_and_grads(
            params, cfg, rt, tokens, labels, rng,
            microbatches=tc.microbatches, encoder_embeds=encoder_embeds)
        new_params, new_opt, opt_metrics = apply_updates(
            params, grads, opt_state, tc.opt)
        return new_params, new_opt, dict(metrics, **opt_metrics, loss=loss)
    return step
