"""Slot surgery on the layer-stacked KV cache (``repro.serve.kv_cache``).

The continuous scheduler addresses one slot of the batch axis at a time:
admission resets it, prefill runs on a batch-1 slice and writes it back.
Every helper takes a matching dict of batch-axis indices (``ax_tree``),
derived once from the cache's logical axes.  This slice ports the float
cache; the int-code cache (``init_code_cache``, ``memory_report``) is
bitexact serving, ROADMAP slice 5.

``slot_take`` returns a copy (a prefill that fails midway leaves the
cache as it was); ``slot_put`` and ``reset_slot`` write in place and
return the cache they were given.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["batch_axis_tree", "reset_slot", "slot_put", "slot_take"]


def batch_axis_tree(axes: Dict[str, Any]) -> Dict[str, Any]:
    """Map a logical-axes dict to per-leaf batch-axis indices."""
    return {k: (batch_axis_tree(v) if isinstance(v, dict)
                else v.index("batch")) for k, v in axes.items()}


def slot_take(cache, ax_tree, i: int):
    """Batch-1 copy of slot ``i`` from every leaf (shape kept)."""
    return {k: (slot_take(c, ax_tree[k], i) if isinstance(c, dict)
                else c.narrow(ax_tree[k], i, 1).clone())
            for k, c in cache.items()}


def slot_put(cache, ax_tree, sub, i: int):
    """Write a batch-1 slice back into slot ``i`` of every leaf."""
    for k, c in cache.items():
        if isinstance(c, dict):
            slot_put(c, ax_tree[k], sub[k], i)
        else:
            c.narrow(ax_tree[k], i, 1).copy_(sub[k])
    return cache


def reset_slot(cache, ax_tree, i: int):
    """Zero slot ``i`` in every leaf: zero is the empty float cache."""
    for k, c in cache.items():
        if isinstance(c, dict):
            reset_slot(c, ax_tree[k], i)
        else:
            c.narrow(ax_tree[k], i, 1).zero_()
    return cache
