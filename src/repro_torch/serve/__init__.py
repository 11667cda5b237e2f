"""Serving layer: the LM scheduler and the batched FIR filterbank engine."""
from .engine import (FilterbankEngine, FilterRequest, Request, Scheduler,
                     cache_logical_axes, make_serve_fns)

__all__ = ["FilterbankEngine", "FilterRequest", "Request", "Scheduler",
           "cache_logical_axes", "make_serve_fns"]
