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
as their 16-bit patterns (numpy has no bf16).

DTensor leaves are gathered on every rank (``save`` and ``save_async``
are collective then) and rank 0 writes.  ``restore(shardings=)`` lays
the host arrays out on the given mesh's shardings whatever mesh wrote
them (the elastic path); the training loop's rescale is ROADMAP A13b.
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
import torch.distributed as dist

from .optimizer import tree_leaves, tree_unflatten

__all__ = ["save", "save_async", "wait_pending", "restore", "latest_step",
           "gc_old"]


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _to_host(t) -> np.ndarray:
    """(array to save, logical dtype name) of one leaf; a DTensor is
    gathered first."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The saved array as a tensor on the host."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))     # 0-d stays 0-d


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
    """Synchronous checkpoint write (rank 0's; every rank returns once it
    is on disk).  Returns the step directory."""
    host = [_to_host(x) for x in tree_leaves(tree)]
    if _rank() == 0:
        d = _write(host, step, ckpt_dir, keep)
    else:
        d = os.path.join(ckpt_dir, f"step_{step:09d}")
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return d


_pending: list = []
_pending_lock = threading.Lock()


def save_async(tree, step: int, ckpt_dir: str, *, keep: int = 3):
    """Checkpoint on a writer thread; the leaves are copied to the host on
    the caller's thread first, so the snapshot is consistent.  Returns the
    thread, or None on a rank other than 0 (which writes nothing)."""
    host = [_to_host(x) for x in tree_leaves(tree)]
    if _rank() != 0:
        return None
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


def restore(tree_like, ckpt_dir: str, *, step: Optional[int] = None,
            shardings=None):
    """Restore into the structure of ``tree_like``, each leaf on the
    device of its counterpart there, or, with ``shardings`` (a matching
    tree of ``parallel.logical.NamedSharding``), laid out as a DTensor on
    its sharding's mesh, whatever mesh wrote the checkpoint.  Returns
    (tree, step), or (None, None) when there is nothing to restore."""
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
    saved = list(zip(manifest["leaves"], manifest["dtypes"]))

    def load(i: int) -> torch.Tensor:
        return _from_host(np.load(os.path.join(d, saved[i][0])), saved[i][1])
    if shardings is None:
        leaves = [load(i).to(torch.as_tensor(like).device)
                  for i, like in enumerate(likes)]
    else:
        from ..parallel.logical import device_put
        places = tree_leaves(shardings)
        if len(places) != len(likes):
            raise ValueError(f"{len(places)} shardings for {len(likes)} "
                             f"leaves")
        leaves = [device_put(load(i), sh) for i, sh in enumerate(places)]
    return tree_unflatten(tree_like, leaves), step


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
