"""Forward parity of the port's dense LM with the JAX package's, on
``reduced(qwen2-0.5b)`` with the reference's ``lm_init`` weights carried
across through numpy (``convert.lm_params_from_numpy``).

Tolerances.  The attention kernels compute in f32 on both sides and
differ in summation order only: 1e-5 relative to the largest value,
about 100 ulps of f32 at these widths.  Whole forwards keep the
reference's bf16 residual stream: a last-bit difference upstream can
flip one bf16 rounding (2^-8 relative) of a residual element, so the
logits are held to 2^-6 of their largest magnitude, four such flips.
The MLP seam is compared bit for bit on the activations the reference
itself fed its three ``quant_matmul`` calls, captured from its run.
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
from repro.models import ModelRuntime as JRT
from repro.models import attention as j_attn
from repro.models import init_cache as j_cache
from repro.models import lm_apply as j_apply
from repro.models import lm_init as j_init
from repro.models import moe as j_moe
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import prng
from repro_torch.models import ModelRuntime as TRT
from repro_torch.models import attention as t_attn
from repro_torch.models import init_cache as t_cache
from repro_torch.models import lm_apply as t_apply
from repro_torch.models import moe as t_moe

pytest_plugins = ["port_first"]

j_ops = importlib.import_module("repro.kernels.ops")
t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")

ATTN_RTOL = 1e-5
LOGIT_RTOL = 2.0 ** -6
NOISE = dict(mode="noise", mul="bbm0", wl=16, param=13, use_pallas=True)
# the served setting (bbm0, WL 16, VBL 13) moves these logits by less than
# the bf16 tolerance; WL 8, VBL 5 moves them by a fifth of their size, so
# its parity shows that the noise path itself agrees
AMMS = {"off": dict(NOISE, mode="off"), "noise16": NOISE,
        "noise8": dict(NOISE, wl=8, param=5)}


def _cfgs(**amm):
    j = dataclasses.replace(j_reduced(j_get("qwen2-0.5b")), amm=JAmm(**amm))
    t = dataclasses.replace(t_reduced(t_get("qwen2-0.5b")), amm=TAmm(**amm))
    return j, t


@pytest.fixture(scope="module")
def params():
    j_cfg, _ = _cfgs()
    jp = j_init(j_cfg, jax.random.key(0))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


# -------------------------------------------------------------- attention
def _qkv(b, sq, skv, h=4, kv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32))


@pytest.mark.parametrize("sq,skv,bq,bk,q_offset,kv_len", [
    (24, 24, 8, 16, 0, None), (10, 40, 4, 16, 30, 40), (5, 32, 512, 1024,
                                                        3, 8)])
def test_chunked_attention(sq, skv, bq, bk, q_offset, kv_len):
    q, k, v = _qkv(2, sq, skv)
    kw = dict(causal=True, q_offset=q_offset, bq=bq, bk=bk, kv_len=kv_len)
    want = j_attn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = t_attn.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got.numpy(), want, ATTN_RTOL)


@pytest.mark.parametrize("kv_len", [7, "per-slot"])
def test_decode_attention(kv_len):
    q, k, v = _qkv(3, 1, 20, seed=1)
    kvl = np.array([1, 9, 20], np.int32) if kv_len == "per-slot" else kv_len
    want = j_attn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                   kv_len=jnp.asarray(kvl))
    got = t_attn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                  kv_len=torch.as_tensor(kvl))
    _close(got.numpy(), want, ATTN_RTOL)


# ------------------------------------------------------------ lm_apply
@pytest.fixture(scope="module")
def forwards(params):
    """JAX's logits of one train forward, a prefill through the cache and
    two per-slot decode steps, in modes off and noise."""
    jp, _ = params
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 12)).astype(np.int32)
    nxt = rng.integers(0, 512, (2, 2, 1)).astype(np.int32)
    out = {}
    for mode, amm in AMMS.items():
        j_cfg, _ = _cfgs(**amm)
        rt = JRT.build(j_cfg)
        logits = {"train": np.asarray(j_apply(jp, j_cfg, rt,
                                              jnp.asarray(toks))[0])}
        c = j_cache(j_cfg, 2, 32)
        lg, _, c = j_apply(jp, j_cfg, rt, jnp.asarray(toks), mode="decode",
                           caches=c, pos=jnp.int32(0))
        logits["prefill"] = np.asarray(lg)
        for i in range(2):
            pos = jnp.asarray([12 + i, 12 + i], jnp.int32)
            lg, _, c = j_apply(jp, j_cfg, rt, jnp.asarray(nxt[i]),
                               mode="decode", caches=c, pos=pos)
            logits[f"decode{i}"] = np.asarray(lg)
        out[mode] = logits
    return toks, nxt, out


@pytest.mark.parametrize("mode", sorted(AMMS))
def test_lm_apply_train_prefill_decode(params, forwards, mode):
    _, tp = params
    toks, nxt, want = forwards
    _, t_cfg = _cfgs(**AMMS[mode])
    rt = TRT.build(t_cfg, device="cpu")
    got = {"train": t_apply(tp, t_cfg, rt, torch.from_numpy(toks))[0]}
    c = t_cache(t_cfg, 2, 32, device="cpu")
    got["prefill"], _, c = t_apply(tp, t_cfg, rt, torch.from_numpy(toks),
                                   mode="decode", caches=c, pos=0)
    for i in range(2):
        got[f"decode{i}"], _, c = t_apply(
            tp, t_cfg, rt, torch.from_numpy(nxt[i]), mode="decode", caches=c,
            pos=torch.tensor([12 + i, 12 + i], dtype=torch.int32))
    for name, logits in got.items():
        assert logits.dtype == torch.float32
        _close(logits.numpy(), want[mode][name], LOGIT_RTOL)
    assert c["k"].dtype == torch.bfloat16


def test_noise_moves_the_logits(forwards):
    """Noise mode is not exact mode: the injected error is far above the
    comparison tolerance."""
    _, _, want = forwards
    gap = np.abs(want["noise8"]["train"] - want["off"]["train"]).max()
    assert gap > 4 * LOGIT_RTOL * np.abs(want["off"]["train"]).max()


# --------------------------------------------------------- the MLP seam
@pytest.mark.parametrize("keyed", [False, True])
def test_mlp_seam_on_captured_activations(params, keyed, monkeypatch):
    """wl = 8: each of the three kernel calls of ``mlp_apply`` is fed the
    reference's own operands (captured from its run); without a key the
    port's output equals the reference kernel's bit for bit, with a key
    (the noise on) it is within the derived bound.  The MLP's output, whose
    straight-through sums use each side's own f32 exact products, is held
    to the f32 tolerance."""
    jp, tp = params
    amm = dict(NOISE, wl=8, param=5)
    j_cfg, t_cfg = _cfgs(**amm)
    jrt, trt = JRT.build(j_cfg).amm, TRT.build(t_cfg, device="cpu").amm
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, j_cfg.d_model)).astype(np.float32)
    calls = []
    real = j_ops.quant_matmul

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, np.asarray(out)))
        return out
    monkeypatch.setattr(j_ops, "quant_matmul", spy)
    p0j = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    p0t = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    key = jax.random.split(jax.random.key(0))[1] if keyed else None
    tkey = prng.layer_keys(0, 1)[0] if keyed else None
    seed = prng.layer_seeds(0, 1)[0] if keyed else None
    want = np.asarray(j_moe.mlp_apply(p0j, jnp.asarray(x), jrt, key))
    assert len(calls) == 3
    for (xa, wa, sx, sw, mu, sigma), kw, out in calls:
        xa, wa = (torch.from_numpy(np.asarray(a)) for a in (xa, wa))
        sx, sw = float(sx), float(sw)
        assert int(kw["seed"]) == (seed if keyed else 0)
        got = t_qm.quant_matmul(xa, wa, sx, sw, mu, sigma, wl=8,
                                seed=int(kw["seed"])).numpy()
        if keyed:
            tol = t_qm.quant_matmul_tolerance(
                xa, wa, torch.tensor(sx), torch.tensor(sw), mu, sigma, wl=8)
            assert (np.abs(got.astype(np.float64) - out)
                    <= tol.numpy()).all()
        else:
            assert_array_equal(got, out)
    got = t_moe.mlp_apply(p0t, torch.from_numpy(x), trt, tkey).numpy()
    _close(got, want, ATTN_RTOL)
