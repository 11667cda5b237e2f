"""Carry the reference's parameters across to the port, through numpy.

Two kinds: the FIR tap banks (the arrays of a reference ``PrecodedBank``:
real taps, int64 codes, digit planes) become the port's bank; the LM's
parameter tree (``repro.models.lm_init``'s nested dict, layer-stacked,
as numpy arrays) becomes the port's tree.  Both packages then compute on
the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.multipliers import MulSpec
from .device import resolve_device
from .dsp.fir import PrecodedBank

__all__ = ["lm_params_from_numpy", "opt_state_from_numpy",
           "precoded_bank_from_numpy"]


def precoded_bank_from_numpy(h_real, hq, mag, neg, spec, *,
                             device=None) -> PrecodedBank:
    """A ``PrecodedBank`` holding the given arrays as they are.

    h_real: (B, taps) float64 real taps; hq: (B, taps) int64 codes;
    mag, neg: (wl//2, B, taps) digit planes, or both ``None`` for specs
    without planes.  ``spec`` is any object with the ``MulSpec`` fields
    (the reference's own spec works).  Nothing is re-quantized or
    re-decoded.
    """
    spec = MulSpec(spec.name, spec.wl, spec.param, spec.hbl)
    h_real = np.atleast_2d(np.asarray(h_real, np.float64))
    hq = np.asarray(hq, np.int64).reshape(h_real.shape)
    bank = object.__new__(PrecodedBank)
    bank.spec = spec
    bank.device = resolve_device(device)
    bank.h_real = h_real
    bank.hq = hq
    bank._planes = None
    if (mag is None) != (neg is None):
        raise ValueError("pass both digit planes or neither")
    if mag is not None:
        shape = (spec.wl // 2,) + hq.shape
        planes = tuple(np.asarray(p) for p in (mag, neg))
        if any(p.shape != shape for p in planes):
            raise ValueError(f"digit planes must be {shape}, got "
                             f"{[p.shape for p in planes]}")
        bank._planes = tuple(
            torch.from_numpy(p.astype(np.int32)).to(bank.device)
            for p in planes)
    return bank


def lm_params_from_numpy(tree, *, device=None, dtype=torch.float32):
    """The port's LM parameters from the reference's tree as numpy.

    ``tree`` is ``repro.models.lm_init``'s nested dict with every leaf
    turned into a numpy array (e.g. ``jax.tree.map(np.asarray, params)``);
    the keys, the lists (a MoE model's ``dense_prefix``) and the
    layer-stacked shapes (a hybrid's (groups, per, ...) Mamba2 stack and
    its ``shared_block``) are the port's own, so the tree is copied leaf
    for leaf onto ``device`` (the GPU unless told otherwise).
    """
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device=dev, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_numpy(v, device=dev, dtype=dtype)
                for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(
        device=dev, dtype=dtype)


def opt_state_from_numpy(state, *, device=None):
    """The port's ``OptState`` from the reference's, as numpy arrays.

    ``state`` is ``repro.train.optimizer.OptState`` (or any (step, m, v)
    triple) with every leaf a numpy array (``jax.tree.map(np.asarray,
    state)``); the moments keep their dtypes and tree (Adafactor's
    factored (row, col) pairs stay pairs), so both packages can take one
    step from the same state.
    """
    from .train.optimizer import OptState
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(conv(v) for v in tree)
        return torch.from_numpy(np.array(tree)).to(dev)
    step, m, v = state
    return OptState(torch.from_numpy(np.array(step, np.int32)).to(dev),
                    conv(m), conv(v))
