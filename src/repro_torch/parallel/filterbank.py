"""Channel-sharded Broken-Booth FIR filterbank over a ``DeviceMesh``.

Counterpart of ``repro.parallel.filterbank``.  Channels are embarrassingly
parallel: y[c] depends only on x[c] and h[c].  ``sharded_filterbank``
gives each rank its block of channels along a mesh axis (x on its
dimension 0, the digit planes on their dimension 1) and runs the
single-device datapath on the block: ``fir_bbm_bank_precoded``, the
filterbank kernels (``fir_bank_rows`` / ``fir_bank_dot``) on the card and
their plain versions on the CPU.  No collective runs: the sharding is the
decomposition.

The tap bank is decoded into its radix-4 digit planes once per call, or
once per bank lifetime with ``precode_filterbank``.  The accumulate form
is chosen per shard (``fir_kernel.auto_form`` on the block's shape and
device), so a bank above the dot form's budget on one rank can take the
dot form on each of several; the bits are the same either way.

Everything is integer-code level: (C, N) int32 wl-bit signal codes in,
(C, N) int32 accumulator values out, as a DTensor sharded on the channel
axis whose ``full_tensor()`` is the unsharded result.  Where the reference
takes ``bc``, ``bt`` and ``use_kernel``, the route here follows the
tensors' device, which must be the mesh's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.booth_rows import booth_precode, resolve_form
from ..kernels.fir_kernel import _check_envelope, fir_bbm_bank_precoded

__all__ = ["precode_filterbank", "sharded_filterbank"]


def precode_filterbank(h, *, wl: int, channels: int | None = None):
    """Decode a (C, taps) tap bank once -> (hmag, hneg) digit planes.

    h: (C, taps) int32 codes, or (taps,) to share one bank across
    ``channels`` rows; the planes are on ``h``'s device (a numpy bank:
    the CPU).  They feed ``sharded_filterbank(h_planes=...)`` across any
    number of calls that reuse the bank.
    """
    h = torch.as_tensor(h)
    if h.dim() == 1:
        if channels is None:
            raise ValueError("channels is required to broadcast a shared "
                             "(taps,) bank")
        h = h[None, :].expand(channels, h.shape[0])
    return booth_precode(h, wl)


def _on_mesh(t, dev: torch.device, what: str) -> torch.Tensor:
    """``t`` as int32 on the mesh's device: numpy arrays are copied there,
    a tensor elsewhere is refused."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t))
        return t.to(device=dev, dtype=torch.int32)
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, the mesh on {dev}")
    return t.to(torch.int32)


def _shard(x, hmag, hneg, i: int, n: int, *, wl: int, vbl: int, kind: int,
           shift: int, form):
    """Block ``i`` of ``n`` along the channels: what rank ``i`` of an
    ``n``-way axis computes."""
    per = x.shape[0] // n
    sl = slice(i * per, (i + 1) * per)
    return fir_bbm_bank_precoded(x[sl], hmag[:, sl], hneg[:, sl], wl=wl,
                                 vbl=vbl, kind=kind, shift=shift, form=form)


def sharded_filterbank(x, h, mesh, *, wl: int, vbl: int, kind: int = 0,
                       shift: int = 0, axis: str = "data", h_planes=None,
                       form: str | None = None):
    """Filterbank over ``mesh`` with channels sharded on mesh axis ``axis``.

    x: (C, N) int32 codes, h: (C, taps) int32 codes (or (taps,) shared),
    as tensors on the mesh's device or numpy arrays.  C must divide by the
    axis size; pad channels first if it does not.  ``form`` pins the
    accumulate form ("rows"/"dot"; None: auto, per shard).  ``h_planes``
    takes the digit planes from ``precode_filterbank``.  Returns a DTensor
    (C, N) int32 sharded on dimension 0 over ``axis``, replicated over the
    other mesh axes.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dev = resolve_device(mesh.device_type)
    x = _on_mesh(x, dev, "x")
    h = _on_mesh(h, dev, "h")
    if h.dim() == 1:
        h = h[None, :].expand(x.shape[0], h.shape[0])
    _check_envelope(h.shape[1], wl, shift)
    names = list(mesh.mesh_dim_names)
    dim = names.index(axis)
    n_shards = mesh.size(dim)
    if x.shape[0] % n_shards:
        raise ValueError(f"channels={x.shape[0]} not divisible by "
                         f"mesh axis {axis!r} of size {n_shards}")
    resolve_form(form)
    if h_planes is None:
        h_planes = booth_precode(h, wl)
    hmag, hneg = (_on_mesh(p, dev, "h_planes") for p in h_planes)
    if hmag.shape[1] != x.shape[0]:
        raise ValueError(f"h_planes cover {hmag.shape[1]} channels, "
                         f"x has {x.shape[0]}")
    out = _shard(x, hmag, hneg, mesh.get_local_rank(dim), n_shards, wl=wl,
                 vbl=vbl, kind=kind, shift=shift, form=form)
    place = [Replicate()] * len(names)
    place[dim] = Shard(0)
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=tuple(x.shape), stride=(x.shape[1], 1))
