"""The port's int-code KV cache and its codes-in products against the JAX
package's, bit for bit.

The cache writes are integer codes against f32 scales computed in the
reference's expression order, so the port must equal the reference
exactly: ``code_cache_update`` (a one-shot write, a block-misaligned one,
later writes clipped into a frozen block, per-slot positions, the clamp
at the cap), ``code_cache_dequant``, the codes-in products
``bbm_matmul_coded`` and ``bbm_matmul_coded_kblocks`` and their oracles,
and the batched entry ``bbm_dot_coded_batched`` (here its plain version:
the tensors are on the CPU) for every ``kv_len`` from 1 to S, over stale
codes past it and never-written blocks.

``decode_attention_codes`` passes a softmax between its two products,
and ``jax.nn.softmax`` and ``torch.softmax`` may round the last bit of a
probability differently, which can move a P code.  So it is held bit for
bit from the seam (the reference's probabilities fed to both value
products, the score products compared before the softmax) and end to
end within ``_decode_bound``, derived below; against its own oracle it
is bit-equal.  ``lm_amm_planes`` equals the per-call precode.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.configs import get_arch as j_get
from repro.configs import reduced as j_reduced
from repro.configs.base import AmmConfig as JAmm
from repro.core.multipliers import MulSpec as JSpec
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import lm_amm_planes as j_planes
from repro.models import lm_init as j_init
from repro.serve import kv_cache as j_kv
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.multipliers import MulSpec as TSpec
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.booth_rows import booth_precode
from repro_torch.models import ModelRuntime as TRT
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import lm_amm_planes as t_planes
from repro_torch.models import lm_apply as t_apply
from repro_torch.serve import kv_cache as t_kv

pytest_plugins = ["port_first"]

jb = importlib.import_module("repro.kernels.bbm_matmul")
j_ref = importlib.import_module("repro.kernels.ref")
tb = importlib.import_module("repro_torch.kernels.bbm_matmul")

BLOCK = 16
KINDS = {"bbm0": 0, "bbm1": 1}
# both kinds at both word-length ends, and (16, 3), whose chunk of 7
# products is shorter than a scale block
POINTS = [("bbm0", 8, 5), ("bbm1", 8, 7), ("bbm0", 16, 13),
          ("bbm1", 16, 15), ("bbm0", 16, 3)]


def _rts(mul, wl, vbl, apply_to="attn"):
    kw = dict(mode="bitexact", mul=mul, wl=wl, param=vbl, apply_to=apply_to)
    return (j_common.AmmRuntime.build(JAmm(**kw)),
            t_common.AmmRuntime.build(TAmm(**kw)))


# ------------------------------------------------------------ the cache
def _write(codes, scales, x, pos, wl):
    """One write on both sides; returns the new (codes, scales) pairs."""
    (jc, tc), (js, ts) = codes, scales
    jc, js = j_attn.code_cache_update(jc, js, jnp.asarray(x),
                                      jnp.asarray(pos), wl=wl)
    t_attn.code_cache_update(tc, ts, torch.from_numpy(x),
                             torch.as_tensor(pos), wl=wl)
    assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_array_equal(ts.numpy(), np.asarray(js))
    return (jc, tc), (js, ts)


def _empty(b, s, kv, hd, wl):
    dt = t_kv.code_dtype(wl)
    jdt = j_kv.code_dtype(wl)
    codes = (jnp.zeros((b, s, kv, hd), jdt), torch.zeros((b, s, kv, hd),
                                                          dtype=dt))
    scales = (jnp.zeros((b, s // BLOCK, kv), jnp.float32),
              torch.zeros((b, s // BLOCK, kv)))
    return codes, scales


# (writes: [(pos, length, amplitude)]) per case; S = 48 (three blocks)
WRITES = {
    "one-shot": [(0, 32, 1.0)],
    "misaligned": [(5, 20, 1.0), (25, 9, 0.5)],
    "clipped-into-frozen": [(0, 3, 0.01), (3, 10, 4.0), (13, 1, 9.0)],
    "clamped-at-cap": [(0, 40, 1.0), (45, 5, 2.0)],
}


@pytest.mark.parametrize("case", sorted(WRITES))
@pytest.mark.parametrize("wl", [8, 16])
def test_code_cache_writes_match_jax(case, wl):
    rng = np.random.default_rng(sorted(WRITES).index(case))
    codes, scales = _empty(2, 48, 2, 8, wl)
    for pos, n, amp in WRITES[case]:
        x = (amp * rng.standard_normal((2, n, 2, 8))).astype(np.float32)
        codes, scales = _write(codes, scales, x, pos, wl)
    lim = 2 ** (wl - 1) - 1
    assert int(codes[1].abs().max()) <= lim + 1
    if case == "clipped-into-frozen":
        # the late, larger rows clip against the first write's scale
        assert int(codes[1][:, 3:14].abs().max()) >= lim


@pytest.mark.parametrize("wl", [8, 16])
def test_code_cache_slot_positions_match_jax(wl):
    """(B,) positions, one token a slot, as continuous decode writes."""
    rng = np.random.default_rng(5)
    codes, scales = _empty(4, 48, 2, 8, wl)
    for step in range(3):
        pos = np.array([0, 15, 16, 31], np.int32) + step
        x = rng.standard_normal((4, 1, 2, 8)).astype(np.float32)
        codes, scales = _write(codes, scales, x * (1 + step), pos, wl)
    # a first-touch scale equals amm_quantize's on a one-shot write
    x = rng.standard_normal((1, BLOCK, 2, 8)).astype(np.float32)
    c, s = _empty(1, 48, 2, 8, wl)
    (_, tc), (_, ts) = _write(c, s, x, 0, wl)
    for h in range(2):
        codes_h, s_h = t_ref.amm_quantize(torch.from_numpy(x[0, :, h]), wl)
        assert ts[0, 0, h] == s_h
        assert_array_equal(tc[0, :BLOCK, h].to(torch.int32).numpy(),
                           codes_h.numpy())


@pytest.mark.parametrize("kv_len", [None, 7, 48, "per-slot"])
def test_code_cache_dequant_matches_jax(kv_len):
    rng = np.random.default_rng(1)
    codes, scales = _empty(3, 48, 2, 8, 16)
    x = rng.standard_normal((3, 30, 2, 8)).astype(np.float32)
    (jc, tc), (js, ts) = _write(codes, scales, x, 4, 16)
    if kv_len == "per-slot":
        kv_len = np.array([1, 20, 34], np.int32)
    want = j_attn.code_cache_dequant(jc, js, None if kv_len is None
                                     else jnp.asarray(kv_len))
    got = t_attn.code_cache_dequant(tc, ts, None if kv_len is None
                                    else torch.as_tensor(kv_len))
    assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wl", [8, 16])
def test_code_cache_layout_and_memory_match_jax(wl):
    cfg_j = j_reduced(j_get("qwen2-0.5b"))
    cfg_t = t_reduced(t_get("qwen2-0.5b"))
    want = j_kv.init_code_cache(cfg_j, 3, 64, wl=wl)
    got = t_kv.init_code_cache(cfg_t, 3, 64, wl=wl, device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].element_size() == want[k].dtype.itemsize
        assert not got[k].any()
    assert t_kv.code_cache_logical_axes(cfg_t) \
        == j_kv.code_cache_logical_axes(cfg_j)
    assert t_kv.cache_nbytes(got) == j_kv.cache_nbytes(want)
    assert t_kv.float_cache_nbytes(cfg_t, 3, 64) \
        == j_kv.float_cache_nbytes(cfg_j, 3, 64)
    assert t_kv.memory_report(cfg_t, 3, 64, wl=wl) \
        == j_kv.memory_report(cfg_j, 3, 64, wl=wl)
    with pytest.raises(ValueError, match="multiple"):
        t_kv.init_code_cache(cfg_t, 1, 40, wl=wl, device="cpu")


def test_code_cache_slot_surgery():
    """reset/take/put walk the code leaves: the batch axis at 1, and a
    zeroed slot's scales are 0.0 again (first touch re-armed)."""
    cfg = t_reduced(t_get("qwen2-0.5b"))
    cache = t_kv.init_code_cache(cfg, 3, 32, wl=16, device="cpu")
    bax = t_kv.batch_axis_tree(t_kv.code_cache_logical_axes(cfg))
    assert set(bax.values()) == {1}
    for v in cache.values():
        v.fill_(3)
    sub = t_kv.slot_take(cache, bax, 1)
    assert all(v.shape[1] == 1 for v in sub.values())
    t_kv.reset_slot(cache, bax, 1)
    assert not any(bool(v[:, 1].any()) for v in cache.values())
    assert all(bool((v[:, 0] == 3).all()) for v in cache.values())
    t_kv.slot_put(cache, bax, sub, 1)
    assert all(bool((v == 3).all()) for v in cache.values())


# ------------------------------------------------------ codes-in products
def _operands(wl, m=7, k=48, n=9, seed=0):
    rng = np.random.default_rng(seed)
    lim = 2 ** (wl - 1) - 1
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[0, 0] = 40.0                            # an envelope edge
    b = rng.integers(-lim - 1, lim + 1, (k, n)).astype(np.int32)
    b[:, 0], b[0, :] = lim, -lim - 1
    return a, b


@pytest.mark.parametrize("mul,wl,vbl", POINTS)
def test_coded_products_match_jax(mul, wl, vbl):
    a, b = _operands(wl)
    kind = KINDS[mul]
    s_col = np.random.default_rng(2).uniform(1e-3, 1.0, 9).astype(
        np.float32)
    s_blk = np.array([0.25, 1e-12, 3.0], np.float32)
    jspec, tspec = JSpec(mul, wl, vbl), TSpec(mul, wl, vbl)
    kw = dict(wl=wl, vbl=vbl, kind=kind)
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    for s_b in (np.float32(0.5), s_col):
        want = jb.bbm_matmul_coded(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(s_b), **kw)
        got = tb.bbm_matmul_coded(ta, tb_, torch.as_tensor(s_b), **kw)
        assert_array_equal(got.numpy(), np.asarray(want))
        oracle = t_ref.amm_coded_ref(ta, tb_, torch.as_tensor(s_b), tspec)
        assert_array_equal(oracle.numpy(), np.asarray(want))
        assert_array_equal(
            oracle.numpy(),
            np.asarray(j_ref.amm_coded_ref(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(s_b), jspec)))
    want = jb.bbm_matmul_coded_kblocks(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(s_blk), block=BLOCK, **kw)
    got = tb.bbm_matmul_coded_kblocks(ta, tb_, torch.from_numpy(s_blk),
                                      block=BLOCK, **kw)
    assert_array_equal(got.numpy(), np.asarray(want))
    oracle = t_ref.amm_coded_kblocks_ref(ta, tb_, torch.from_numpy(s_blk),
                                         tspec, block=BLOCK)
    assert_array_equal(oracle.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="multiple"):
        tb.bbm_matmul_coded_kblocks(ta[:, :40], tb_[:40],
                                    torch.from_numpy(s_blk), block=BLOCK,
                                    **kw)


def _cache_slices(wl, s=48, kvh=2, d=8, seed=3):
    """A decode batch of S slots, slot i live for i + 1 positions, over a
    cache whose positions past that hold stale codes and whose blocks
    past it are partly never written (scale 0.0)."""
    rng = np.random.default_rng(seed)
    lim = 2 ** (wl - 1) - 1
    b = s
    codes = rng.integers(-lim - 1, lim + 1, (b, s, kvh, d)).astype(
        np.int16 if wl > 8 else np.int8)
    scales = rng.uniform(1e-3, 0.1, (b, s // BLOCK, kvh)).astype(np.float32)
    kv_len = np.arange(1, b + 1, dtype=np.int32)
    for i, n in enumerate(kv_len):
        first_dead = -(-int(n) // BLOCK)
        scales[i, first_dead + (i % 2):] = 0.0      # never written
    return codes, scales, kv_len


def _want_slices(fn, a, codes, scales, kv_len, per):
    """The reference's codes-in product of every (slot, head) slice on
    its masked codes, the scales as ``decode_attention_codes`` hands
    them, vmapped over the slices as that function does."""
    s = codes.shape[1]
    live = np.arange(s)[None, :] < kv_len[:, None]              # (B, S)
    c = jnp.asarray(codes.astype(np.int32)).transpose(0, 2, 1, 3)
    sc = jnp.asarray(scales).transpose(0, 2, 1)                # (B, KV, nb)
    if per == "column":
        c = jnp.where(live[:, None, None, :], c.swapaxes(-1, -2), 0)
        sc = jnp.repeat(sc, BLOCK, axis=-1)
    else:
        c = jnp.where(live[:, None, :, None], c, 0)
    return np.asarray(jax.vmap(jax.vmap(fn))(jnp.asarray(a), c, sc))


@pytest.mark.parametrize("mul,wl,vbl", POINTS)
def test_batched_entry_matches_jax_for_every_kv_len(mul, wl, vbl):
    codes, scales, kv_len = _cache_slices(wl)
    b, s, kvh, d = codes.shape
    kind = KINDS[mul]
    kw = dict(wl=wl, vbl=vbl, kind=kind)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, kvh, 7, d)).astype(np.float32)
    p = rng.uniform(0, 1, (b, kvh, 7, s)).astype(np.float32)
    p *= (np.arange(s)[None, :] < kv_len[:, None])[:, None, None, :]
    tc, ts = torch.from_numpy(codes), torch.from_numpy(scales)
    live = torch.from_numpy(kv_len)
    for a, per, fn, view, sview in (
            (q, "column", jb.bbm_matmul_coded, tc.permute(0, 2, 3, 1),
             ts.permute(0, 2, 1)),
            (p, "kblock", lambda x, c, sb: jb.bbm_matmul_coded_kblocks(
                x, c, sb, block=BLOCK, **kw), tc.permute(0, 2, 1, 3),
             ts.permute(0, 2, 1))):
        jfn = (lambda x, c, sb: fn(x, c, sb, **kw)) if per == "column" \
            else fn
        want = _want_slices(jfn, a, codes, scales, kv_len, per)
        aq, s_a = t_ref.amm_quantize_slices(torch.from_numpy(a), wl)
        got = tb.bbm_dot_coded_batched(aq, s_a, view, sview, block=BLOCK,
                                       per=per, live=live, **kw)
        assert_array_equal(got.numpy(), want)
        plain = tb.bbm_dot_coded_batched_plain(aq, s_a, view, sview,
                                               block=BLOCK, per=per,
                                               live=live, **kw)
        assert_array_equal(plain.numpy(), want)
    # unit scales leave yq: bbm_dot_scaled of each slice
    aq, s_a = t_ref.amm_quantize_slices(torch.from_numpy(q), wl)
    yq = tb.bbm_dot_coded_batched(aq, torch.ones_like(s_a),
                                  tc.permute(0, 2, 3, 1),
                                  torch.ones((b, kvh, s)), block=1, **kw)
    assert_array_equal(yq[5, 1].numpy(), tb.bbm_dot_scaled(
        aq[5, 1].contiguous(), tc[5, :, 1].to(torch.int32).T.contiguous(),
        **kw).numpy())


def test_batched_entry_refuses_bad_operands():
    a = torch.zeros((2, 1, 7, 32), dtype=torch.int32)
    s_a = torch.ones((2, 1))
    b = torch.zeros((2, 1, 32, 8), dtype=torch.int16)
    kw = dict(wl=16, vbl=13, kind=0)
    with pytest.raises(ValueError, match="multiple"):
        tb.bbm_dot_coded_batched(a, s_a, b, torch.ones((2, 1, 2)),
                                 block=12, per="kblock", **kw)
    with pytest.raises(ValueError, match="s_b"):
        tb.bbm_dot_coded_batched(a, s_a, b, torch.ones((2, 1, 3)),
                                 block=16, per="kblock", **kw)
    with pytest.raises(ValueError, match="live"):
        tb.bbm_dot_coded_batched(a, s_a, b, torch.ones((2, 1, 8)), block=1,
                                 live=torch.ones(3), **kw)
    with pytest.raises(ValueError, match="s_b"):
        tb.bbm_dot_coded_batched(a, s_a, b, None, block=1, **kw)
    with pytest.raises(ValueError, match="int32"):
        tb.bbm_dot_coded_batched(a.float(), s_a, b, torch.ones((2, 1, 8)),
                                 block=1, **kw)


# ------------------------------------------------------- decode attention
def _layer_cache(wl, b=4, s=48, kvh=2, d=8, seed=6):
    """One layer of a code cache written through ``code_cache_update`` on
    both sides: slot i holds a prompt of 3 + 9 i tokens over stale codes
    (a reused slot), its later blocks never written."""
    rng = np.random.default_rng(seed)
    stale = rng.integers(-100, 100, (b, s, kvh, d))
    kv_len = np.array([3 + 9 * i for i in range(b)], np.int32)
    j_cache, t_cache = {}, {}
    for side in ("k", "v"):
        codes, scales = _empty(b, s, kvh, d, wl)
        jc = codes[0] + jnp.asarray(stale, codes[0].dtype)
        tc = codes[1] + torch.from_numpy(stale).to(codes[1].dtype)
        js, ts = scales
        for i in range(b):
            x = rng.standard_normal((1, int(kv_len[i]), kvh, d)).astype(
                np.float32)
            c_i, s_i = j_attn.code_cache_update(
                jc[i:i + 1], js[i:i + 1], jnp.asarray(x), 0, wl=wl)
            jc, js = jc.at[i:i + 1].set(c_i), js.at[i:i + 1].set(s_i)
            t_attn.code_cache_update(tc[i:i + 1], ts[i:i + 1],
                                     torch.from_numpy(x), 0, wl=wl)
        j_cache[f"{side}_codes"], j_cache[f"{side}_scale"] = jc, js
        t_cache[f"{side}_codes"], t_cache[f"{side}_scale"] = tc, ts
    for k in j_cache:
        assert_array_equal(t_cache[k].numpy(), np.asarray(j_cache[k]))
    return j_cache, t_cache, kv_len


def _decode_bound(moved, pq, s_p, t_cache, vbl):
    """|port - reference| of one decode attention output row when the two
    softmaxes give P codes ``pq`` that differ by at most one in ``moved``
    (per row) positions.  One Broken-Booth product moves by at most |v| +
    2^(vbl + 2) when its P code moves by one (the step of p*v plus the
    truncations of both products), so a moved code moves the output by at
    most that times s_p and the largest V block scale.  Every part of the
    ordered block sum is at most ``mag`` (the same product bound over all
    of the row's codes) in size; the P scale may differ by a few ulps
    (max p rounded differently) and each of the at most 8 block adds may
    round once more, 2^-20 of ``mag`` in all."""
    v = t_cache["v_codes"].double().abs().amax(dim=(1, 3))       # (B, KV)
    sv = t_cache["v_scale"].double().amax(dim=1)                 # (B, KV)
    step = ((v + 2.0 ** (vbl + 2)) * s_p.double() * sv)[..., None]
    mag = step * pq.double().abs().sum(-1)
    return step * moved + 2.0 ** -20 * mag                  # (B, KV, g)


@pytest.mark.parametrize("mul,wl,vbl", POINTS)
def test_decode_attention_codes_matches_jax(mul, wl, vbl):
    jrt, trt = _rts(mul, wl, vbl)
    j_cache, t_cache, kv_len = _layer_cache(wl)
    b, s, kvh, d = t_cache["k_codes"].shape
    block = BLOCK
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, 1, 2 * kvh, d)).astype(np.float32)
    kw = dict(wl=wl, vbl=vbl, kind=KINDS[mul])
    # the score products before the softmax: bit for bit
    qf = torch.from_numpy(q).reshape(b, kvh, 2, d) / (d ** 0.5)
    aq, s_a = t_ref.amm_quantize_slices(qf, wl)
    live = torch.from_numpy(kv_len)
    sc = tb.bbm_dot_coded_batched(
        aq, s_a, t_cache["k_codes"].permute(0, 2, 3, 1),
        t_cache["k_scale"].permute(0, 2, 1), block=block, per="column",
        live=live, **kw)
    kc, ks = np.asarray(j_cache["k_codes"]), np.asarray(j_cache["k_scale"])
    want_sc = _want_slices(lambda x, c, sb: jb.bbm_matmul_coded(x, c, sb,
                                                                **kw),
                           qf.numpy(), kc, ks, kv_len, "column")
    assert_array_equal(sc.numpy(), want_sc)
    # the value products from the seam: the reference's probabilities
    livem = np.arange(s)[None, :] < kv_len[:, None]
    pr = np.asarray(jax.nn.softmax(jnp.where(
        livem[:, None, None, :], jnp.asarray(want_sc), j_attn.NEG_INF),
        axis=-1))
    pq, s_p = t_ref.amm_quantize_slices(torch.from_numpy(pr), wl)
    pv = tb.bbm_dot_coded_batched(
        pq, s_p, t_cache["v_codes"].permute(0, 2, 1, 3),
        t_cache["v_scale"].permute(0, 2, 1), block=block, per="kblock",
        live=live, **kw)
    want_pv = _want_slices(lambda x, c, sb: jb.bbm_matmul_coded_kblocks(
        x, c, sb, block=block, **kw), pr, np.asarray(j_cache["v_codes"]),
        np.asarray(j_cache["v_scale"]), kv_len, "kblock")
    assert_array_equal(pv.numpy(), want_pv)
    # end to end, within the bound of the P codes the softmaxes move
    want = np.asarray(j_attn.decode_attention_codes(
        jnp.asarray(q), j_cache, jnp.asarray(kv_len), amm=jrt))
    got = t_attn.decode_attention_codes(torch.from_numpy(q), t_cache,
                                        live, amm=trt)
    t_pr = torch.softmax(torch.where(torch.from_numpy(livem)[:, None, None],
                                     sc, t_attn.NEG_INF), dim=-1)
    tq, _ = t_ref.amm_quantize_slices(t_pr, wl)
    moved = (tq - pq).abs()
    assert int(moved.max()) <= 1
    assert s // BLOCK <= 8
    bound = _decode_bound(moved.sum(-1).double(), pq, s_p, t_cache, vbl)
    err = np.abs(got.double().numpy() - want.astype(np.float64))
    assert (err <= bound.reshape(b, 1, 2 * kvh, 1).numpy()).all()
    # the port against its own oracle: bit for bit
    oracle = t_ref.amm_decode_attention_codes_ref(
        torch.from_numpy(q), t_cache, live, TSpec(mul, wl, vbl))
    assert_array_equal(got.numpy(), oracle.numpy())
    with pytest.raises(ValueError, match="lowering"):
        t_attn.decode_attention_codes(torch.from_numpy(q), t_cache, live,
                                      amm=None)


@pytest.mark.parametrize("mul,wl,vbl", POINTS[:3])
def test_decode_attention_float_cache_matches_jax(mul, wl, vbl):
    """amm decode against a float cache (each slice requantized over the
    whole cache slice): the score products and, from the seam of the
    reference's probabilities, the value products equal the reference's
    bit for bit; the port's approximate forward equals its oracle."""
    jrt, trt = _rts(mul, wl, vbl)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    kv_len = np.array([5, 32], np.int32)
    qf = (q.reshape(2, 2, 2, 8) / np.float32(8 ** 0.5)).astype(np.float32)
    kt = k.transpose(0, 2, 3, 1).copy()
    vt = v.transpose(0, 2, 1, 3).copy()
    sc = j_common.amm_dot(jnp.asarray(qf), jnp.asarray(kt), jrt, ste=False)
    got = t_common.amm_dot(torch.from_numpy(qf), torch.from_numpy(kt), trt,
                           ste=False)
    assert_array_equal(got.numpy(), np.asarray(sc))
    live = np.arange(32)[None, :] < kv_len[:, None]
    pr = jax.nn.softmax(jnp.where(live[:, None, None, :], sc,
                                  j_attn.NEG_INF), axis=-1)
    want = j_common.amm_dot(pr, jnp.asarray(vt), jrt, ste=False)
    got = t_common.amm_dot(torch.from_numpy(np.asarray(pr)),
                           torch.from_numpy(vt), trt, ste=False)
    assert_array_equal(got.numpy(), np.asarray(want))
    got = t_attn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(kv_len), amm=trt,
                                  amm_ste=False)
    oracle = t_ref.amm_decode_attention_ref(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(kv_len),
        TSpec(mul, wl, vbl), ste=False)
    assert_array_equal(got.numpy(), oracle.numpy())


# ----------------------------------------------------------- weight planes
def _lm(apply_to="all", mode="bitexact"):
    amm = dict(mode=mode, mul="bbm0", wl=16, param=13, apply_to=apply_to)
    j_cfg = dataclasses.replace(j_reduced(j_get("qwen2-0.5b")),
                                amm=JAmm(**amm))
    t_cfg = dataclasses.replace(t_reduced(t_get("qwen2-0.5b")),
                                amm=TAmm(**amm))
    jp = j_init(j_cfg, jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return j_cfg, jp, t_cfg, tp


def test_lm_amm_planes_equal_the_per_call_precode():
    j_cfg, jp, t_cfg, tp = _lm()
    jrt = j_common.AmmRuntime.build(j_cfg.amm)
    rt = TRT.build(t_cfg)
    planes = t_planes(t_cfg, rt.amm, tp)
    assert rt.build_planes(t_cfg, tp).keys() == planes.keys()
    want = j_planes(j_cfg, jrt, jp)["layers"]["mlp"]
    for name, entry in planes["layers"]["mlp"].items():
        w = tp["layers"]["mlp"][name]
        for i in range(t_cfg.n_layers):
            one = rt.amm.precode(w[i])
            assert torch.equal(entry["codes"][i], one["codes"])
            assert torch.equal(entry["s_w"][i], one["s_w"])
            mag, neg = booth_precode(entry["codes"][i], 16)
            assert_array_equal(mag.numpy(), np.asarray(want[name]["mag"][i]))
            assert_array_equal(neg.numpy(), np.asarray(want[name]["neg"][i]))
        assert_array_equal(entry["s_w"].numpy(),
                           np.asarray(want[name]["s_w"]))
    tokens = torch.from_numpy(np.arange(12).reshape(2, 6) % t_cfg.vocab)
    plain, _, _ = t_apply(tp, t_cfg, rt, tokens, mode="prefill")
    cached, _, _ = t_apply(tp, t_cfg, rt, tokens, mode="prefill",
                           amm_planes=planes)
    assert torch.equal(plain, cached)
    for apply_to, mode in (("attn", "bitexact"), ("all", "noise"),
                           ("all", "off")):
        _, _, cfg2, tp2 = _lm(apply_to, mode)
        assert t_planes(cfg2, TRT.build(cfg2, device="cpu").amm,
                        tp2) is None
