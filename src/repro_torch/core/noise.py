"""Statistical error-injection model (paper section II.B).

Counterpart of ``repro.core.noise``: the multiplier's output error is
modelled as additive white noise, so a length-K dot product on the
approximate hardware carries an error of about Normal(K * mu, K *
sigma^2), with (mu, sigma^2) the per-product moments from
``errstats.characterize``.  ``inject_dot_error`` adds that error to an
exact integer-domain product with ``jax.random.normal``'s draws (the
``normal_draw`` kernel on the card); the fused ``quant_matmul`` kernel
draws its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .errstats import ErrorStats, characterize
from .multipliers import MulSpec
from .prng import normal

__all__ = ["NoiseModel", "make_noise_model", "inject_dot_error"]

_CACHE: dict = {}


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Calibrated additive-error model for one multiplier spec."""
    spec: MulSpec
    mean: float           # per-product error mean (int domain)
    var: float            # per-product error variance (int domain)

    def dot_moments(self, k: int) -> tuple:
        """(mean, std) of the error of a K-term dot product."""
        return k * self.mean, float(np.sqrt(k * self.var))


def make_noise_model(spec: MulSpec, *, sample: int = 1 << 20,
                     stats: Optional[ErrorStats] = None,
                     device=None) -> NoiseModel:
    """Characterize (cached per process) and wrap as a NoiseModel.

    ``device``: where ``characterize`` computes the error vectors (None:
    the GPU, raising without one; "cpu").  Both give the same floats, so
    the cache is keyed on the spec and the sample alone.
    """
    key = (spec, sample)
    if key not in _CACHE:
        st = stats or characterize(spec, sample=sample, device=device)
        _CACHE[key] = NoiseModel(spec=spec, mean=st.mean, var=st.var)
    return _CACHE[key]


def inject_dot_error(y_int, key, model: NoiseModel, k: int,
                     amp_scale: float = 1.0) -> torch.Tensor:
    """Add calibrated accumulated error to an exact int-domain product.

    y_int: the exact dot products (a float32 tensor; the result is on its
    device); key: a ``core.prng`` key; k: the dot-product length;
    amp_scale: the operand-magnitude correction factor (a number).

    The reference's ``y + (mu + sigma * normal(key, y.shape))`` with its
    roundings inside a compiled program: ``mu = mean * k * amp_scale`` in
    Python floats, then float32; ``sigma = sqrt(max(var * k, 0))`` in
    float32 (``jnp.sqrt`` of a float32), times ``amp_scale`` in float32;
    ``sigma * sqrt(2)`` folded to one float32 constant whose product with
    ``erf_inv(u)`` fuses into the add of ``mu`` (``prng.normal``'s
    ``order="noise"``).  Called op by op outside a program, the reference
    rounds ``sigma * z`` on its own instead, which moves the last bit of
    some elements.
    """
    amp = float(amp_scale)
    y = torch.as_tensor(y_int).to(torch.float32).contiguous().clone()
    mu = model.mean * k * amp
    sigma = float(np.sqrt(np.float32(max(model.var * k, 0.0)))
                  * np.float32(amp))
    return normal(key, y.shape, acc=y, c1=mu, c2=sigma, order="noise")
