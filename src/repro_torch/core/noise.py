"""Statistical error-injection model (paper section II.B).

Counterpart of ``repro.core.noise``'s ``NoiseModel`` and
``make_noise_model``: the multiplier's output error is modelled as
additive white noise, so a length-K dot product on the approximate
hardware carries an error of about Normal(K * mu, K * sigma^2), with
(mu, sigma^2) the per-product moments from ``errstats.characterize``.
The noise itself is drawn inside the ``quant_matmul`` kernel.  The
reference's ``inject_dot_error`` draws with ``jax.random.normal``, whose
bits the port does not reproduce yet; it is ROADMAP item A10.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .errstats import ErrorStats, characterize
from .multipliers import MulSpec

__all__ = ["NoiseModel", "make_noise_model"]

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
                     stats: Optional[ErrorStats] = None) -> NoiseModel:
    """Characterize (cached per process) and wrap as a NoiseModel."""
    key = (spec, sample)
    if key not in _CACHE:
        st = stats or characterize(spec, sample=sample)
        _CACHE[key] = NoiseModel(spec=spec, mean=st.mean, var=st.var)
    return _CACHE[key]
