"""Checkpoints: a manifest plus one ``.npy`` per leaf, an async writer,
and restore of the newest complete step.

Counterpart of ``repro.train.checkpoint`` on trees of tensors (nested
dicts in sorted-key order, tuples and ``OptState`` in order).  Layout:

    <dir>/step_000000123/
        MANIFEST.json        {step, leaves, shapes, dtypes, done: true}
        leaf_00000.npy ...

The step directory is written under a ``.tmp`` name and renamed once its
manifest (``done`` last) is on disk, so a crash mid-write leaves the
previous checkpoint as the newest complete one.  bf16 leaves are stored
as their 16-bit patterns (numpy has no bf16).  Restoring onto another
mesh (the reference's ``shardings``) is the parallel item, ROADMAP A13.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from .optimizer import tree_leaves

__all__ = ["save", "save_async", "wait_pending", "restore", "latest_step",
           "gc_old"]


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_host(t) -> np.ndarray:
    """(array to save, logical dtype name) of one leaf."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))     # 0-d stays 0-d
    return t.to(torch.as_tensor(like).device)


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(x, it) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, it) for x in like)
    return next(it)


def _write(host, step: int, ckpt_dir: str, keep: int) -> str:
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    names = []
    for i, (arr, _) in enumerate(host):
        np.save(os.path.join(tmp, _leaf_name(i)), arr)
        names.append(_leaf_name(i))
    manifest = {"step": step, "leaves": names,
                "shapes": [list(a.shape) for a, _ in host],
                "dtypes": [dt for _, dt in host], "done": True}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    gc_old(ckpt_dir, keep=keep)
    return d


def save(tree, step: int, ckpt_dir: str, *, keep: int = 3) -> str:
    """Synchronous checkpoint write.  Returns the step directory."""
    return _write([_to_host(x) for x in tree_leaves(tree)], step, ckpt_dir,
                  keep)


_pending: list = []
_pending_lock = threading.Lock()


def save_async(tree, step: int, ckpt_dir: str, *, keep: int = 3):
    """Checkpoint on a writer thread; the leaves are copied to the host on
    the caller's thread first, so the snapshot is consistent."""
    host = [_to_host(x) for x in tree_leaves(tree)]
    t = threading.Thread(target=_write, args=(host, step, ckpt_dir, keep),
                         daemon=True)
    t.start()
    with _pending_lock:
        _pending.append(t)
    return t


def wait_pending() -> None:
    with _pending_lock:
        threads = list(_pending)
        _pending.clear()
    for t in threads:
        t.join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step whose manifest says it is complete, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        mf = os.path.join(ckpt_dir, name, "MANIFEST.json")
        if not os.path.exists(mf):
            continue
        try:
            with open(mf) as f:
                done = json.load(f).get("done")
        except (json.JSONDecodeError, OSError):
            continue
        if done:
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore(tree_like, ckpt_dir: str, *, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``, each leaf on the
    device of its counterpart there.  Returns (tree, step), or (None,
    None) when there is nothing to restore."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    likes = tree_leaves(tree_like)
    if len(likes) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint {d} holds {len(manifest['leaves'])} "
                         f"leaves, the model {len(likes)}")
    leaves = [_from_host(np.load(os.path.join(d, n)), dt, like)
              for n, dt, like in zip(manifest["leaves"], manifest["dtypes"],
                                     likes)]
    return _unflatten(tree_like, iter(leaves)), step


def gc_old(ckpt_dir: str, *, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for m in
                   (re.fullmatch(r"step_(\d+)", n)
                    for n in os.listdir(ckpt_dir)) if m)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
