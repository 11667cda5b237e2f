"""The train step: microbatched loss and gradients, then the update;
the train state laid out on a mesh.

Counterpart of ``repro.train.trainstep``.  ``make_train_step`` is the
body of the reference's jitted ``step`` on one device; the sharded step
on a mesh is ROADMAP item A13b.  ``train_step_shardings`` and
``init_train_state`` lay parameters and optimizer state out by the
logical rules (``parallel.logical``) as DTensors on a ``DeviceMesh``.
Gradients come from autograd through ``lm_loss``; the kernels' forward
values enter it through the straight-through rule, so no gradient passes
through a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core import prng
from ..device import resolve_device
from ..models import (ModelRuntime, lm_init, lm_logical_axes, lm_loss,
                      lm_table)
from ..parallel.logical import (OPT_RULES, OPT_RULES_MULTIPOD, RULES,
                                RULES_MULTIPOD, NamedSharding, PartitionSpec,
                                batch_pspec, device_put, is_multipod,
                                tree_shardings)
from .optimizer import (OptConfig, OptState, apply_updates, init_opt,
                        tree_leaves, tree_map)

__all__ = ["TrainConfig", "loss_and_grads", "make_train_step",
           "train_step_shardings", "init_train_state"]


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


def train_step_shardings(cfg: ArchConfig, mesh, global_batch=None):
    """(param_shardings, opt_shardings, batch_sharding) on ``mesh``:
    parameters by ``RULES`` (``RULES_MULTIPOD`` with a pod axis), the
    optimizer's moments by ``OPT_RULES*``, each dimension checked against
    ``lm_table``'s shapes; the batch by ``batch_pspec``."""
    axes = lm_logical_axes(cfg)
    table = lm_table(cfg)
    mp = is_multipod(mesh)
    p_sh = tree_shardings(axes, mesh, RULES_MULTIPOD if mp else RULES,
                          shapes_tree=table)
    o_sh = tree_shardings(axes, mesh,
                          OPT_RULES_MULTIPOD if mp else OPT_RULES,
                          shapes_tree=table)
    return p_sh, o_sh, NamedSharding(mesh, batch_pspec(mesh, global_batch))


def init_train_state(cfg: ArchConfig, tc: TrainConfig, mesh, seed: int = 0):
    """``lm_init(cfg, seed)`` and ``init_opt`` on the mesh's device, laid
    out by ``train_step_shardings`` (the step replicated): (params,
    OptState) of DTensors."""
    p_sh, o_sh, _ = train_step_shardings(cfg, mesh)
    params = lm_init(cfg, seed, device=resolve_device(mesh.device_type),
                     dtype=tc.param_dtype)
    opt = init_opt(params, tc.opt)
    return device_put(params, p_sh), OptState(
        device_put(opt.step, NamedSharding(mesh, PartitionSpec())),
        device_put(opt.m, o_sh), device_put(opt.v, o_sh))
