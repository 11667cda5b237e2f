"""Logical-axis sharding rules on a torch ``DeviceMesh`` (MaxText-style).

Counterpart of ``repro.parallel.logical``.  Every parameter and
activation axis carries a *logical* name; the rules map logical names to
mesh axes.  The rule tables are the reference's, literally:

  RULES                single-pod (data, model)
  RULES_MULTIPOD       two-pod (pod, data, model): batch gains the pod
                       axis, parameters stay pod-replicated
  OPT_RULES(_MULTIPOD) optimizer-state rules: identical except that
                       "embed" also shards over the pod axis

A spec is a ``PartitionSpec``: per tensor dimension a mesh-axis name, a
tuple of names, or None.  It compares equal to the reference's by value.
A ``NamedSharding`` pairs a spec with a mesh; ``placements`` gives the
DTensor placements (``Shard(d)`` on every mesh dimension that names
tensor dimension d, ``Replicate()`` on the rest), and ``device_put`` lays
a tree of tensors out on a tree of shardings with ``distribute_tensor``.
The rules read a mesh's dimension names and sizes: a ``DeviceMesh``, or
any object with ``mesh_dim_names`` and ``shape`` (a shape-only mesh for
checking a layout without the devices).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..train.optimizer import tree_map

__all__ = ["RULES", "RULES_MULTIPOD", "OPT_RULES", "OPT_RULES_MULTIPOD",
           "PartitionSpec", "NamedSharding", "spec_to_pspec",
           "tree_shardings", "logical_sharding", "batch_pspec",
           "is_multipod", "placements", "device_put"]

RULES: Dict[Optional[str], Any] = {
    "batch": "data",
    "seq": None,
    "embed": "data",          # FSDP: weight embed axis sharded over data
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",       # expert parallelism
    "expert_mlp": None,
    "vocab": "model",
    "q_latent": "model",
    "kv_latent": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    None: None,
}

RULES_MULTIPOD = dict(RULES, batch=("pod", "data"))
OPT_RULES = dict(RULES)
OPT_RULES_MULTIPOD = dict(RULES_MULTIPOD, embed=("pod", "data"))

# When a primary axis cannot shard (non-divisible, e.g. grok's 8 experts on
# a 16-way model axis), a fallback logical axis of the same spec may claim
# the freed mesh axis: TP-experts instead of EP.
FALLBACK_RULES: Dict[str, Any] = {
    "expert_mlp": "model",
}


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh-axis name, a tuple of names (split
    major to minor), or None (replicated).  A one-name tuple is stored as
    the name, as the reference's spec stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a shape-only mesh."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions have no names")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def is_multipod(mesh) -> bool:
    return "pod" in mesh.mesh_dim_names


def spec_to_pspec(axes: Tuple[Optional[str], ...], rules: Dict,
                  shape: Optional[Tuple[int, ...]] = None,
                  mesh=None) -> PartitionSpec:
    """Resolve logical axes to a ``PartitionSpec``.

    When ``shape`` and ``mesh`` are given, every candidate mesh axis must
    evenly divide its dimension; non-divisible axes are dropped
    (replicated), so one rule set serves qwen2's 14 heads and a batch of 1
    on a 16 x 16 mesh, and no shard is ever uneven.
    """
    sizes = _axis_sizes(mesh) if shape is not None and mesh is not None \
        else None
    entries = []
    used = set()
    for i, a in enumerate(axes):
        r = rules.get(a, None)
        if r is None:
            entries.append(None)
            continue
        rr = tuple(r) if isinstance(r, (tuple, list)) else (r,)
        # a mesh axis may appear only once per spec; later dims fall back
        # to replication (e.g. (experts->model, embed->data, mlp->None))
        rr = tuple(x for x in rr if x not in used)
        if sizes is not None:
            keep = []
            rem = shape[i]
            for ax in rr:
                if rem % sizes[ax] == 0:
                    keep.append(ax)
                    rem //= sizes[ax]
            rr = tuple(keep)
        used.update(rr)
        entries.append(rr if len(rr) > 1 else (rr[0] if rr else None))
    # second pass: fallback axes may claim mesh axes freed by non-divisible
    # primaries (e.g. expert_mlp takes "model" when 8 experts can't)
    for i, a in enumerate(axes):
        fb = FALLBACK_RULES.get(a)
        if fb is None or entries[i] is not None or fb in used:
            continue
        if sizes is not None and shape[i] % sizes[fb] != 0:
            continue
        entries[i] = fb
        used.add(fb)
    return PartitionSpec(*entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: Any
    spec: PartitionSpec


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh
    dimension.  A tensor dimension split over several mesh axes splits
    major to minor in the spec's order, as the reference's does; DTensor
    splits in mesh-dimension order, so the spec's order must be the
    mesh's."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(ax) for ax in axes]
        if dims != sorted(dims):
            raise ValueError(f"dimension {d} splits over {axes}, against "
                             f"the mesh's order {tuple(names)}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def tree_shardings(axes_tree, mesh, rules: Optional[Dict] = None,
                   shapes_tree=None):
    """Map a tree of logical-axis tuples to ``NamedSharding``s.

    shapes_tree: an optional matching tree of objects with ``.shape``
    (``Spec`` entries or tensors) enabling the divisibility check.
    """
    if rules is None:
        rules = RULES_MULTIPOD if is_multipod(mesh) else RULES
    if shapes_tree is None:
        return tree_map(lambda axes: NamedSharding(
            mesh, spec_to_pspec(axes, rules)), axes_tree)
    return tree_map(lambda axes, s: NamedSharding(
        mesh, spec_to_pspec(axes, rules, tuple(s.shape), mesh)),
        axes_tree, shapes_tree)


def logical_sharding(mesh, *axes, rules: Optional[Dict] = None,
                     shape=None) -> NamedSharding:
    if rules is None:
        rules = RULES_MULTIPOD if is_multipod(mesh) else RULES
    return NamedSharding(mesh, spec_to_pspec(tuple(axes), rules, shape,
                                             mesh))


def batch_pspec(mesh, batch: Optional[int] = None) -> PartitionSpec:
    axes = ("pod", "data") if is_multipod(mesh) else ("data",)
    if batch is not None:
        sizes = _axis_sizes(mesh)
        keep = []
        rem = batch
        for ax in axes:
            if rem % sizes[ax] == 0:
                keep.append(ax)
                rem //= sizes[ax]
        axes = tuple(keep)
    if not axes:
        return PartitionSpec(None)
    return PartitionSpec(axes if len(axes) > 1 else axes[0])


def _put(t: torch.Tensor, sharding: NamedSharding):
    from torch.distributed.tensor import distribute_tensor
    t = torch.as_tensor(t)
    sizes = _axis_sizes(sharding.mesh)
    if len(sharding.spec) > t.dim():
        raise ValueError(f"spec {sharding.spec} has more dimensions than "
                         f"the tensor's {tuple(t.shape)}")
    for d, entry in enumerate(sharding.spec):
        n = 1
        for ax in (entry if isinstance(entry, tuple) else
                   (() if entry is None else (entry,))):
            n *= sizes[ax]
        if t.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                             f"split evenly over {entry} ({n} ways)")
    return distribute_tensor(t, sharding.mesh,
                             placements(sharding.spec, sharding.mesh))


def device_put(tree, shardings):
    """Lay each tensor of ``tree`` out on its ``NamedSharding`` in the
    matching tree (or on one sharding for every leaf) as a DTensor on the
    sharding's mesh; returns the same structure.  Every shard must be
    even (``spec_to_pspec`` with shapes drops what does not divide)."""
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda t: _put(t, shardings), tree)
    return tree_map(_put, tree, shardings)
