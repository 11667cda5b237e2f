"""Fault-tolerant training loop (``repro.train.loop``).

Periodic async checkpoints, resume from the newest complete checkpoint,
step-level retry (a failure restores the last checkpoint and replays: the
data pipeline gives the same batches), and a straggler monitor.  Each
step's key is ``fold_in(rng, step)``, the reference's, so noise-mode
seeds match it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from ..core import prng
from . import checkpoint as ckpt

__all__ = ["LoopConfig", "StragglerMonitor", "train_loop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    max_retries: int = 3
    log_every: int = 10


class StragglerMonitor:
    """Flags steps whose wall time is a z-score outlier vs the EMA."""

    def __init__(self, alpha: float = 0.05, z_thresh: float = 3.0):
        self.alpha = alpha
        self.z = z_thresh
        self.mean = None
        self.var = 0.0
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        z = (dt - self.mean) / max(np.sqrt(self.var), 1e-6)
        slow = bool(self.var > 0 and z > self.z)
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if slow:
            self.flagged += 1
        return slow


# the step's loss terms a history entry carries beside its loss: the cross
# entropy, the MoE load-balance term and the MTP head's cross entropy
_METRICS = ("ce", "moe_aux", "mtp")


def train_loop(step_fn: Callable, params, opt_state, data_iter,
               cfg: LoopConfig, *, rng,
               failure_hook: Optional[Callable[[int], None]] = None,
               log_fn: Callable[[str], None] = print):
    """Run the loop with checkpoint/restart fault tolerance.

    step_fn(params, opt, tokens, labels, key) -> (params, opt, metrics);
    data_iter(start) yields (tokens, labels, step); rng: a ``core.prng``
    key.  failure_hook(step): test injection point, raising inside it
    simulates a node failure at that step; a failure restores the last
    checkpoint, or the initial state when there is none yet.  Returns
    (params, opt_state, history): a dict per step with its step, loss,
    seconds (``dt``), straggler flag, and the loss terms among ``ce``,
    ``moe_aux`` and ``mtp`` that its metrics hold.
    """
    state_tree = {"params": params, "opt": opt_state}
    restored, at = ckpt.restore(state_tree, cfg.ckpt_dir)
    start = 0
    if restored is not None:
        params, opt_state = restored["params"], restored["opt"]
        start = at + 1
        log_fn(f"[loop] resumed from checkpoint step {at}")

    monitor = StragglerMonitor()
    history = []
    step = start
    retries = 0
    data = iter(data_iter(start))
    while step < cfg.total_steps:
        tokens, labels, data_step = next(data)
        if data_step != step:
            raise RuntimeError(f"data pipeline out of sync: step {step}, "
                               f"batch {data_step}")
        t0 = time.perf_counter()
        try:
            if failure_hook is not None:
                failure_hook(step)
            key = prng.fold_in(rng, step)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 tokens, labels, key)
            loss = float(metrics["loss"])     # waits for the device
        except Exception as e:  # noqa: BLE001 -- node failure semantics
            retries += 1
            if retries > cfg.max_retries:
                raise
            log_fn(f"[loop] step {step} failed ({type(e).__name__}: {e}); "
                   f"restoring last checkpoint (retry {retries})")
            ckpt.wait_pending()         # a write in flight is the newest
            restored, at = ckpt.restore(state_tree, cfg.ckpt_dir)
            if restored is not None:
                params, opt_state = restored["params"], restored["opt"]
                step = at + 1
            else:
                params, opt_state = state_tree["params"], state_tree["opt"]
                step = 0
            data = iter(data_iter(step))
            continue
        dt = time.perf_counter() - t0
        slow = monitor.observe(dt)
        if slow:
            log_fn(f"[loop] step {step}: straggler flagged ({dt*1e3:.1f} ms)")
        history.append(dict({"step": step, "loss": loss, "dt": dt,
                             "straggler": slow},
                            **{k: float(metrics[k]) for k in _METRICS
                               if k in metrics}))
        if step % cfg.log_every == 0:
            log_fn(f"[loop] step {step} loss {loss:.4f} ({dt*1e3:.1f} ms)")
        if cfg.ckpt_every and step % cfg.ckpt_every == 0 and step > start:
            ckpt.save_async({"params": params, "opt": opt_state}, step,
                            cfg.ckpt_dir, keep=cfg.keep)
        step += 1
    ckpt.wait_pending()
    ckpt.save({"params": params, "opt": opt_state}, cfg.total_steps - 1,
              cfg.ckpt_dir, keep=cfg.keep)
    return params, opt_state, history
