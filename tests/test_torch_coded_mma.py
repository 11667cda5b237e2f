"""The tensor-core route of the batched codes-in entry against the JAX
package.

``bbm_dot_coded_batched`` (decode attention on the int-code KV cache,
``amm_dot``) takes the int8 tensor-core kernel of
``csrc/bbm_coded_mma.cuh`` where ``bbm_coded_route`` says "mma", else the
CUDA-core ``bbm_coded_kernel``.  ``bbm_dot_coded_mma_emulated`` forms the
new route's arithmetic in plain PyTorch: ``bbm_mma_operands``' byte
products per K-chunk (per K-block's chunks under ``per="kblock"``), the
``lo + 256 hi`` partial modulo 2^32, the f32 chunk adds and the descale in
the kernel's order.  Here it must equal ``bbm_dot_coded_batched_plain``
with ``torch.equal`` on every case the rule sends to "mma" (both kinds,
ragged ``live`` with 1 and S among the lengths, stale codes past it,
never-written blocks' zero scales, int8 codes at WL 8, chunk boundaries
inside a step's reach, ragged steps, rows and columns), and the
reference's ``bbm_matmul_coded`` / ``bbm_matmul_coded_kblocks`` on a few
slices.  Also: the route rule's table, the hook's refusals, and the
``cuda`` cases (``tests/torch_coded_card.py``), which skip without a card.
"""
from __future__ import annotations

import importlib

import jax  # noqa: F401  (the reference, on the CPU, under _want_slices)
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro_torch.kernels.booth_rows import amm_chunk_len
from repro_torch.kernels.ref import amm_quantize_slices
from test_torch_kv_codes import BLOCK, KINDS, POINTS, _cache_slices, \
    _want_slices
from torch_coded_card import CARD_CHECKS

pytest_plugins = ["port_first"]

jb = importlib.import_module("repro.kernels.bbm_matmul")
tb = importlib.import_module("repro_torch.kernels.bbm_matmul")

# bbm_coded_route over POINTS, per mode and block (1, 16, and N = 48)
ROUTES = {
    ("bbm0", 8, 5): {"column": ("mma", "mma", "mma"),
                     "kblock": ("tile", "mma", "mma")},
    ("bbm1", 8, 7): {"column": ("mma", "mma", "mma"),
                     "kblock": ("tile", "mma", "mma")},
    ("bbm0", 16, 13): {"column": ("mma", "mma", "mma"),
                       "kblock": ("tile", "mma", "mma")},
    ("bbm1", 16, 15): {"column": ("mma", "mma", "mma"),
                       "kblock": ("tile", "mma", "mma")},
    ("bbm0", 16, 3): {"column": ("tile", "tile", "tile"),
                      "kblock": ("tile", "tile", "tile")},
}
MMA_POINTS = [p for p in POINTS if ROUTES[p]["column"][0] == "mma"]


@pytest.mark.parametrize("point", POINTS)
@pytest.mark.parametrize("per", ["column", "kblock"])
def test_route_rule_table(point, per):
    mul, wl, vbl = point
    got = tuple(tb.bbm_coded_route(wl, vbl, KINDS[mul], per, block)
                for block in (1, 16, 48))
    assert got == ROUTES[point][per]
    # the rule is the kind-blind conjunction of its three conditions
    for block in (1, 15, 16, 17, 48):
        want = tb._mma_refusal(wl, vbl, None) is None \
            and amm_chunk_len(wl, vbl) >= tb.CODED_K_STEP \
            and (per == "column" or block >= tb.CODED_K_STEP)
        for kind in (0, 1):
            assert tb.bbm_coded_route(wl, vbl, kind, per, block) == (
                "mma" if want else "tile")


def test_route_rule_refuses_bad_arguments():
    with pytest.raises(ValueError, match="kind"):
        tb.bbm_coded_route(16, 13, 2, "column", 16)
    with pytest.raises(ValueError, match="per"):
        tb.bbm_coded_route(16, 13, 0, "row", 16)
    assert tb.CODED_K_STEP == 16


def _batched(codes, scales, kv_len, a, per):
    """(a codes, s_a, b view, s_b view, live) as decode_attention_codes
    hands them to the batched entry."""
    tc, ts = torch.from_numpy(codes), torch.from_numpy(scales)
    wl = 8 if codes.dtype == np.int8 else 16
    aq, s_a = amm_quantize_slices(torch.from_numpy(a), wl)
    view = tc.permute(0, 2, 3, 1) if per == "column" \
        else tc.permute(0, 2, 1, 3)
    return aq.contiguous(), s_a, view, ts.permute(0, 2, 1), \
        torch.from_numpy(kv_len)


def _decode_a(codes, kv_len, per, seed=4):
    b, s, kvh, d = codes.shape
    rng = np.random.default_rng(seed)
    if per == "column":
        return rng.standard_normal((b, kvh, 7, d)).astype(np.float32)
    p = rng.uniform(0, 1, (b, kvh, 7, s)).astype(np.float32)
    return p * (np.arange(s)[None, :] < kv_len[:, None])[:, None, None, :]


@pytest.mark.parametrize("mul,wl,vbl", MMA_POINTS)
@pytest.mark.parametrize("per", ["column", "kblock"])
def test_emulation_equals_plain_over_every_kv_len(mul, wl, vbl, per):
    """S = 48 slots, slot i live for i + 1 positions (1 and S among
    them), stale codes past it, never-written blocks' zero scales; int8
    codes at WL 8."""
    codes, scales, kv_len = _cache_slices(wl)
    a, s_a, b, s_b, live = _batched(codes, scales, kv_len,
                                    _decode_a(codes, kv_len, per), per)
    kw = dict(wl=wl, vbl=vbl, kind=KINDS[mul], block=BLOCK, per=per,
              live=live)
    assert tb.bbm_coded_route(wl, vbl, KINDS[mul], per, BLOCK) == "mma"
    got = tb.bbm_dot_coded_mma_emulated(a, s_a, b, s_b, **kw)
    assert torch.equal(got, tb.bbm_dot_coded_batched_plain(a, s_a, b, s_b,
                                                           **kw))
    assert torch.equal(got, tb.bbm_dot_coded_batched(a, s_a, b, s_b, **kw))


@pytest.mark.parametrize("mul,wl,vbl", MMA_POINTS)
@pytest.mark.parametrize("per", ["column", "kblock"])
def test_emulation_matches_jax_on_slices(mul, wl, vbl, per):
    """Four slots (lengths 1, 2, 17 and S) of the cache, against the
    reference's codes-in products vmapped over the slices."""
    codes, scales, kv_len = _cache_slices(wl)
    pick = [0, 1, 16, 47]
    codes, scales, kv_len = codes[pick], scales[pick], kv_len[pick]
    a_np = _decode_a(codes, kv_len, per)
    kw = dict(wl=wl, vbl=vbl, kind=KINDS[mul])
    fn = (lambda x, c, sb: jb.bbm_matmul_coded(x, c, sb, **kw)) \
        if per == "column" else \
        (lambda x, c, sb: jb.bbm_matmul_coded_kblocks(x, c, sb, block=BLOCK,
                                                      **kw))
    want = _want_slices(fn, a_np, codes, scales, kv_len, per)
    a, s_a, b, s_b, live = _batched(codes, scales, kv_len, a_np, per)
    got = tb.bbm_dot_coded_mma_emulated(a, s_a, b, s_b, block=BLOCK,
                                        per=per, live=live, **kw)
    assert_array_equal(got.numpy(), want)


def _dense(wl, bt, m, k, n, *, dtype, transposed, seed=0):
    """Random slices as amm_dot quantizes them: a (bt, 1, m, k) codes, b
    (bt, 1, k, n) codes of ``dtype`` (a transposed view of (n, k) storage
    when ``transposed``), envelope-edge codes in the first rows."""
    rng = np.random.default_rng(seed)
    lim = 2 ** (wl - 1) - 1
    a, s_a = amm_quantize_slices(torch.from_numpy(rng.standard_normal(
        (bt, 1, m, k)).astype(np.float32)), wl)
    shape = (bt, 1, n, k) if transposed else (bt, 1, k, n)
    b = torch.from_numpy(rng.integers(-lim - 1, lim + 1, shape)).to(dtype)
    b[..., 0, :] = -lim - 1
    b[..., 1, :] = lim
    return a.contiguous(), s_a, b.transpose(-1, -2) if transposed else b


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("case", ["column-crossing", "kblock-crossing",
                                  "ragged-steps", "wide-m"])
def test_emulation_equals_plain_at_the_edges(kind, case):
    """WL 16 / VBL 9's chunk of 511 products inside K = 1100 (per column
    with block = N as amm_dot calls it, on a transposed int32 view; per
    K-block with blocks of 550, two chunks each); K-blocks of 24 (a full
    step and a half one) over 9 ragged rows; M = 17 (three n8 tiles)."""
    rng = np.random.default_rng(kind)
    wl, vbl = (16, 9) if "crossing" in case else (16, 13)
    if case == "column-crossing":
        a, s_a, b = _dense(wl, 2, 7, 1100, 5, dtype=torch.int32,
                           transposed=True)
        kw = dict(block=5, per="column", live=None)
        s_b = torch.from_numpy(rng.uniform(1e-3, 1, (2, 1, 1)).astype(
            np.float32))
    else:
        k, n, m, block = {"kblock-crossing": (1100, 5, 7, 550),
                          "ragged-steps": (48, 9, 7, 24),
                          "wide-m": (48, 40, 17, 16)}[case]
        a, s_a, b = _dense(wl, 3, m, k, n, dtype=torch.int16,
                           transposed=False)
        per = "column" if case == "wide-m" else "kblock"
        j = -(-n // block) if per == "column" else k // block
        s_b = torch.from_numpy(rng.uniform(1e-3, 1, (3, 1, j)).astype(
            np.float32))
        live = torch.tensor([1, (n if per == "column" else k) // 2 + 3,
                             10 ** 6])
        kw = dict(block=block, per=per, live=live)
    kw.update(wl=wl, vbl=vbl, kind=kind)
    assert tb.bbm_coded_route(wl, vbl, kind, kw["per"], kw["block"]) == "mma"
    got = tb.bbm_dot_coded_mma_emulated(a, s_a, b, s_b, **kw)
    assert torch.equal(got, tb.bbm_dot_coded_batched_plain(a, s_a, b, s_b,
                                                           **kw))


@pytest.mark.parametrize("mul,wl,vbl", MMA_POINTS)
def test_emulation_with_unit_scales_is_bbm_dot_scaled(mul, wl, vbl):
    """Unit scales leave yq: ``bbm_dot_scaled`` of each slice."""
    a, s_a, b = _dense(wl, 2, 7, 40, 9, dtype=torch.int32, transposed=False)
    kind = KINDS[mul]
    ones = torch.ones((2, 1, 9))
    got = tb.bbm_dot_coded_mma_emulated(a, torch.ones_like(s_a), b, ones,
                                        wl=wl, vbl=vbl, kind=kind, block=1)
    for i in range(2):
        assert torch.equal(got[i, 0], tb.bbm_dot_scaled(
            a[i, 0], b[i, 0].contiguous(), wl=wl, vbl=vbl, kind=kind))


def test_emulation_and_hook_refuse_what_mma_cannot_compute():
    a, s_a, b = _dense(16, 2, 7, 48, 9, dtype=torch.int16, transposed=False)
    col = torch.ones((2, 1, 1))
    for wl, vbl, per, block, s_b in ((16, 3, "column", 16, col),
                                     (16, 13, "kblock", 1,
                                      torch.ones((2, 1, 48)))):
        kw = dict(wl=wl, vbl=vbl, kind=0, block=block, per=per)
        with pytest.raises(ValueError, match="tensor-core route"):
            tb.bbm_dot_coded_mma_emulated(a, s_a, b, s_b, **kw)
        with pytest.raises(ValueError, match="cannot compute"):
            tb._coded_launch("mma", a, s_a, b, s_b, **kw)
    # the hook takes CUDA tensors only: the CPU's route is the plain version
    with pytest.raises(ValueError, match="CUDA"):
        tb._coded_launch("tile", a, s_a, b, col, wl=16, vbl=13, kind=0,
                         block=16, per="column")
    with pytest.raises(ValueError, match="route"):
        tb._coded_launch("wgmma", a, s_a, b, col, wl=16, vbl=13, kind=0,
                         block=16, per="column")


def test_the_kernel_reads_plain_integer_strides():
    """The wrapper passes b's four and s_b's three element strides as
    plain integers (no host tensors a call): the C signatures say so."""
    import ctypes

    from repro_torch.kernels import _build
    sig = _build._SIGNATURES["bbm_dot"]
    for name in ("bbm_dot_coded_batched_launch", "bbm_dot_coded_mma_launch"):
        args = sig[name][0]
        assert args[4:8] == [ctypes.c_longlong] * 4
        assert args[9:12] == [ctypes.c_longlong] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("check", sorted(CARD_CHECKS))
def test_coded_mma_on_the_card(check):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    CARD_CHECKS[check]()
