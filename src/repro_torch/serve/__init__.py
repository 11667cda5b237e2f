"""Serving layer: the batched FIR filterbank engine."""
from .engine import FilterbankEngine, FilterRequest

__all__ = ["FilterbankEngine", "FilterRequest"]
