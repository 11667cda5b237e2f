"""Compressed gradient all-reduce with error feedback.

Counterpart of ``repro.parallel.compress``, bit for bit.  Two codecs,
both with error feedback (the residual of one step is added back before
the next quantization, so compression error does not bias the
trajectory):

  "int8"    blockwise-scaled int8: per block of ``BLOCK`` values one scale
            (max |x| / 127, shared over the axis by a MAX all-reduce),
            codes rounded half to even and clipped to +-127, then summed
            over the axis as int32
  "bf16"    the values rounded to bf16, summed over the axis in f32

The reference's docstring promises "4x reduction over fp32 on the wire"
for int8, but its codes cross the wire as int32, as many bytes as f32
(ROADMAP C18); the port copies the bits, so it moves the same bytes.
The collectives are ``torch.distributed`` all-reduces over the mesh
axis's sub-group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import prng
from ..train.optimizer import tree_leaves, tree_unflatten

__all__ = ["BLOCK", "compress_decompress", "compressed_allreduce",
           "allreduce_ref"]

BLOCK = 256


def _div(a: torch.Tensor, k) -> torch.Tensor:
    """``a / k`` correctly rounded on every device: CUDA divides by a
    Python number as a product with its rounded reciprocal, so ``k`` goes
    in as a tensor on ``a``'s device."""
    return a / torch.tensor(k, dtype=a.dtype, device=a.device)


def _block_scale(x2d: torch.Tensor) -> torch.Tensor:
    s = _div(torch.amax(torch.abs(x2d), dim=-1, keepdim=True), 127.0)
    return torch.clamp(s, min=1e-12)


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` zero-padded to whole blocks, (blocks, BLOCK)."""
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def _unblock(x2d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x2d.reshape(-1)[:like.numel()].reshape(like.shape)


def compress_decompress(g: torch.Tensor, codec: str, key=None):
    """One round trip through the codec (for error-feedback bookkeeping).
    ``key``: a ``core.prng`` key adding ``jax.random.uniform``'s draws
    minus 0.5 before the int8 rounding (stochastic rounding)."""
    if codec == "bf16":
        return g.to(torch.bfloat16).to(g.dtype)
    if codec == "int8":
        fp = _blocks(g.reshape(-1))
        s = _block_scale(fp)
        scaled = fp / s
        if key is not None:
            scaled = scaled + (prng.uniform(key, scaled.shape,
                                            device=g.device) - 0.5)
        q = torch.clamp(torch.round(scaled), -127, 127)
        out = q.to(torch.int8).to(torch.float32) * s
        return _unblock(out, g).to(g.dtype)
    raise ValueError(codec)


def allreduce_ref(gs_stacked: torch.Tensor, codec: str) -> torch.Tensor:
    """Mean over a stacked leading "device" axis, each shard compressed
    before the sum."""
    comp = torch.stack([compress_decompress(g, codec) for g in gs_stacked])
    return torch.mean(comp, dim=0)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def _per_shard(g, e, codec: str, group, n: int):
    g_fb = g + e
    if codec == "int8":
        fp = _blocks(g_fb.reshape(-1))
        # one scale per block, shared over the axis, so the int8 sums
        # decode exactly: sum(q_i) * s / n == mean
        s = _all_reduce(_block_scale(fp), dist.ReduceOp.MAX, group)
        q = torch.clamp(torch.round(fp / s), -127, 127).to(torch.int8)
        qsum = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        mean = _unblock(_div(qsum.to(torch.float32) * s, n), g).to(g.dtype)
        sent = _unblock(q.to(torch.float32) * s, g)
    elif codec == "bf16":
        comp = g_fb.to(torch.bfloat16)
        total = _all_reduce(comp.to(torch.float32), dist.ReduceOp.SUM, group)
        mean = _div(total, n).to(g.dtype)
        sent = comp.to(torch.float32)
    else:
        raise ValueError(codec)
    return mean, (g_fb - sent).to(e.dtype)


def compressed_allreduce(grads, mesh, codec: str = "int8",
                         axis: str = "data", error_buf=None):
    """All-reduce-mean ``grads`` over mesh axis ``axis`` with on-the-wire
    compression.  Returns (mean_grads, new_error_buf).

    Each leaf is the rank's block (its leading dimension owned per shard
    of ``axis``), or a DTensor sharded that way, whose local block is
    used; the results come back in the same form.  ``error_buf``
    (default zeros) matches ``grads``.
    """
    from torch.distributed.tensor import DTensor
    leaves_g = tree_leaves(grads)
    leaves_e = (tree_leaves(error_buf) if error_buf is not None
                else [None] * len(leaves_g))
    if len(leaves_e) != len(leaves_g):
        raise ValueError(f"error_buf has {len(leaves_e)} leaves, grads "
                         f"{len(leaves_g)}")
    group = mesh.get_group(axis)
    n = mesh.size(list(mesh.mesh_dim_names).index(axis))

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    means, errs = [], []
    for g, e in zip(leaves_g, leaves_e):
        gl = local(g)
        el = torch.zeros_like(gl) if e is None else local(e)
        m, e2 = _per_shard(gl, el, codec, group, n)
        if isinstance(g, DTensor):
            m = DTensor.from_local(m, g.device_mesh, g.placements,
                                   run_check=False, shape=g.shape,
                                   stride=g.stride())
            e2 = DTensor.from_local(e2, g.device_mesh, g.placements,
                                    run_check=False, shape=g.shape,
                                    stride=g.stride())
        means.append(m)
        errs.append(e2)
    return tree_unflatten(grads, means), tree_unflatten(grads, errs)
