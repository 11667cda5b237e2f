"""The batched codes-in entry's card checks, shared by the ``cuda`` tests of
``tests/test_torch_coded_mma.py`` (which skip on a machine without a card)
and of ``tests/test_torch_isolation.py`` (the port test file that imports
no jax, which the GPU machine runs with ``-m cuda``).

Each check builds ``chip_smoke.py``'s operands from a seed and runs its
``coded_route_check``: one ``bbm_dot_coded_batched`` call on the card,
its route (read off ``.mma_launches``) held to ``bbm_coded_route``, the
output and, on a tensor-core point, the CUDA-core kernel's through its C
entry equal (``torch.equal``) to ``bbm_dot_coded_batched_plain`` on CPU
copies, and at a CUDA-core point a forced tensor-core launch refused.
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import torch

tb = importlib.import_module("repro_torch.kernels.bbm_matmul")
DEV = "cuda"          # the checks' device

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _route(args, kw, what) -> str:
    return chip_smoke.coded_route_check(torch, tb, args, kw, what)


def check_decode(kind: int, wl: int = 16, vbl: int = 13) -> None:
    """The score and value launches at the main path's shapes (8 slots,
    S 512, 2 kv heads of 7 query heads, d 64; ragged lengths with 1 and
    S, stale codes, never-written blocks) on the tensor cores."""
    ops = chip_smoke.coded_operands(torch, np.random.default_rng(kind),
                                    DEV, s=512, wl=wl)
    for name, (a, s_a, b, s_b, per) in chip_smoke.coded_calls(ops).items():
        kw = dict(wl=wl, vbl=vbl, kind=kind, block=16, per=per,
                  live=ops["live"])
        assert _route((a, s_a, b, s_b), kw, name) == "mma"


def check_prefill(kind: int) -> None:
    """``amm_dot``'s prefill pair (per column, block = N) on the tensor
    cores."""
    calls = chip_smoke.prefill_operands(torch, np.random.default_rng(2),
                                        DEV)
    for name, (a, s_a, b, s_b, per) in calls.items():
        kw = dict(wl=16, vbl=13, kind=kind, block=b.shape[-1], per=per)
        assert _route((a, s_a, b, s_b), kw, name) == "mma"


def check_tile_points() -> None:
    """Where the rule says "tile" (chunks of 7 at WL 16 / VBL 3, K-blocks
    of 1) the CUDA-core kernel runs."""
    ops = chip_smoke.coded_operands(torch, np.random.default_rng(3),
                                    DEV, s=64, wl=16)
    calls = chip_smoke.coded_calls(ops)
    for (wl, vbl), name, block in (((16, 3), "qk", 16), ((16, 3), "pv", 16),
                                   ((16, 13), "pv", 1)):
        a, s_a, b, s_b, per = calls[name]
        if block == 1:
            s_b = torch.ones((*b.shape[:2], b.shape[2]), device=DEV)
        kw = dict(wl=wl, vbl=vbl, kind=0, block=block, per=per,
                  live=ops["live"])
        assert _route((a, s_a, b, s_b), kw, name) == "tile"


CARD_CHECKS = {"decode-bbm0": lambda: check_decode(0),
               "decode-bbm1": lambda: check_decode(1),
               "decode-wl8": lambda: check_decode(1, wl=8, vbl=5),
               "prefill-bbm0": lambda: check_prefill(0),
               "prefill-bbm1": lambda: check_prefill(1),
               "tile-points": check_tile_points}
