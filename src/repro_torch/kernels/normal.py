"""``jax.random.normal`` bit for bit: the normal-draw kernel.

The reference draws its keyed noise with ``jax.random.normal(key, shape,
float32)``: the plain noise branch of ``amm_dense``
(``repro/models/common.py:264``), ``core.noise.inject_dot_error`` and
keyed ``kernels.ref.quant_matmul_ref``.  One hand-written CUDA kernel
(``csrc/normal.cu``) draws the same bits: Threefry-2x32 on each
element's flat index, the uniform, XLA's log1p and ErfInv32, times
sqrt(2), with every fused multiply-add where XLA:CPU fuses one.
``core.prng.normal_plain`` is the same function in plain PyTorch.

``normal_draw`` runs the plain version for CPU tensors only; on a CUDA
device it launches the kernel or raises, and counts its launches in
``normal_draw.launches``.  With ``acc`` it writes the noise epilogue
``acc + c1 + c2 * z`` into ``acc`` in place, in the same pass, rounded
as XLA compiles it inside a program: ``c2 * sqrt(2)`` folded into one
float32 constant and its product with ``erf_inv(u)`` fused into the last
add (``prng.normal_plain``).
"""
from __future__ import annotations

import contextlib

import torch

from ..core import prng
from ..device import resolve_device

__all__ = ["noise_consts", "normal_bits", "normal_draw"]


_ORDERS = {"acc": 1, "noise": 2}


def noise_consts(mu: float, sigma: float, k: int) -> tuple:
    """The epilogue's ``(c1, c2)`` for a K-term dot product, as the
    reference writes ``acc + mu * K + sigma * sqrt(K) * z``: both products
    in Python floats, each rounded once to float32 where it meets the
    float32 accumulator."""
    return float(mu) * k, float(sigma) * (k ** 0.5)


def _stream_ctx(dev: torch.device):
    return contextlib.nullcontext() \
        if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)


def _launch(out: torch.Tensor, k, mode: int, c1: float,
            c2s: float) -> None:
    from ._build import library
    lib = library("normal")
    dev = out.device
    with _stream_ctx(dev):
        err = lib.normal_launch(out.data_ptr(), out.numel(),
                                int(k[0]) & 0xFFFFFFFF,
                                int(k[1]) & 0xFFFFFFFF, mode, c1, c2s,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"normal_draw failed: CUDA error {err} "
                           f"({lib.normal_error_string(err).decode()})")


def normal_draw(k, shape, *, device=None, acc=None, c1: float = 0.0,
                c2: float = 0.0, order: str = "acc") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` on ``device`` (None: the
    GPU, raising without one; "cpu": the plain version).

    k: a ``core.prng`` key (two uint32 words).  With ``acc`` (a
    contiguous float32 tensor of ``shape``, whose device is taken) the
    draw is not returned but folded into ``acc`` in place as ``acc + c1
    + c2 * z`` (``prng.normal_plain``'s ``order``: "acc" forms ``acc +
    c1`` first, "noise" forms ``c1 + c2 * z`` first), and ``acc`` is
    returned.
    """
    if order not in _ORDERS:
        raise ValueError(f"unknown order {order!r}")
    shape = tuple(int(d) for d in shape)
    if acc is not None:
        if acc.dtype != torch.float32 or not acc.is_contiguous() \
                or tuple(acc.shape) != shape:
            raise ValueError(f"acc must be a contiguous float32 tensor of "
                             f"shape {shape}, got {acc.dtype} "
                             f"{tuple(acc.shape)}")
        dev = acc.device
    else:
        dev = resolve_device(device)
    if dev.type != "cuda":
        if acc is None:
            return prng.normal_plain(k, shape)
        return acc.copy_(prng.normal_plain(k, shape, acc=acc, c1=c1, c2=c2,
                                           order=order))
    out = acc if acc is not None else torch.empty(shape, dtype=torch.float32,
                                                  device=dev)
    if out.numel() == 0:
        return out
    _launch(out, k, 0 if acc is None else _ORDERS[order], float(c1),
            prng.folded_scale(c2))
    normal_draw.launches += 1
    return out


normal_draw.launches = 0


def normal_bits(bits: torch.Tensor) -> torch.Tensor:
    """The transform alone: ``jax.random.normal``'s value of each uint32
    in ``bits`` (an int32 or int64 tensor of uint32 values), on the
    kernel for a CUDA tensor (uncounted: a check of the kernel's
    arithmetic), ``prng.normal_from_bits`` on the CPU."""
    if not bits.is_cuda:
        return prng.normal_from_bits(bits)
    if bits.dtype == torch.int32:
        b32 = bits.contiguous()
    else:
        b = bits.to(torch.int64) & 0xFFFFFFFF
        b32 = torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)
    out = torch.empty(b32.shape, dtype=torch.float32, device=bits.device)
    from ._build import library
    lib = library("normal")
    with _stream_ctx(bits.device):
        err = lib.normal_bits_launch(
            b32.data_ptr(), out.data_ptr(), b32.numel(),
            torch.cuda.current_stream(bits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"normal_bits failed: CUDA error {err} "
                           f"({lib.normal_error_string(err).decode()})")
    return out
