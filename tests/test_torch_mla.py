"""The port's multi-head latent attention, its caches and its serving,
against the JAX package's, on ``reduced(deepseek-v3-671b)``: weights and
inputs drawn in numpy from fixed seeds and handed to both sides.

Tolerances.
* ``mla_attention`` without a cache: 1e-5 of the output's largest
  magnitude (f32 on both sides, sums in another order; as
  ``tests/test_torch_lm.py``'s attention).
* Through the bf16 latent cache: 2^-7 of the largest.  A latent element
  whose f32 value the two frameworks round apart (a last bit) can land on
  the other side of a bf16 rounding, which moves it by 2^-8 of itself.
* On the amm datapath (bitexact bbm0 WL 16 / VBL 13, attention only):
  2^-7 as well; a moved float rounding can move one quantization code of
  q, P or the re-expanded K/V (2^-15 of its range) on top.
* The latent code cache: codes and scales bit-equal given the same
  latent (the write seam, fed one array), codes written at an earlier
  step untouched by later ones; end to end the codes within one step and
  the scales within 2^-20 relative, from latents a last bit apart.
* Serving: ``tests/test_torch_serve_bitexact.py``'s teacher forcing and
  2^-6 on the logits, with the MoE routing held by
  ``torch_moe_routes.RouteLedger`` (a near-tie flip leaves the rest of
  its slot's request out, counted).
"""
from __future__ import annotations

import dataclasses

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
from repro.models import lm_amm_planes as j_planes
from repro.models import lm_apply as j_apply
from repro.models import lm_table as j_table
from repro.serve import engine as j_engine
from repro.serve import kv_cache as j_kv
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as t_launch
from repro_torch.models import ModelRuntime as TRT
from repro_torch.models import attention as t_attn
from repro_torch.models import init_cache as t_cache
from repro_torch.serve import engine as t_engine
from repro_torch.serve import kv_cache as t_kv
from torch_moe_routes import RouteLedger, captured_routes, grid, numpy_params

pytest_plugins = ["port_first"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side on one thread: these forwards are small, and the
    suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ATTN_RTOL = 1e-5
CACHE_RTOL = 2.0 ** -7
LOGIT_RTOL = 2.0 ** -6
ARCH = "deepseek-v3-671b"
BITEXACT = dict(mode="bitexact", mul="bbm0", wl=16, param=13)
B, S, MAX_LEN = 2, 6, 32


def _cfgs(**amm):
    j_cfg, t_cfg = j_reduced(j_get(ARCH)), t_reduced(t_get(ARCH))
    if amm:
        j_cfg = dataclasses.replace(j_cfg, amm=JAmm(**amm))
        t_cfg = dataclasses.replace(t_cfg, amm=TAmm(**amm))
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def attn():
    """MLA weights and inputs: (reference params, port params, x, the next
    token's x)."""
    j_cfg, _ = _cfgs()
    tree = numpy_params(j_attn.mla_table(j_cfg), seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, j_cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, j_cfg.d_model)).astype(np.float32)
    return (jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(tree, device="cpu"), x, x1)


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _positions(b, s, pos):
    off = np.broadcast_to(np.asarray(pos), (b,))
    return (off[:, None] + np.arange(s)[None, :]).astype(np.int32)


def _run(attn, cache_kind, amm):
    """Prefill S tokens at 0, then one decode step at per-slot positions,
    on both sides: [(want y, got y, want cache, got cache)] per call."""
    jp, tp, x, x1 = attn
    j_cfg, t_cfg = _cfgs(**(amm or {}))
    j_rt = JRT.build(j_cfg).amm if amm else None
    t_rt = TRT.build(t_cfg).amm if amm else None
    if cache_kind == "codes":
        jc = {k: v[0] for k, v in j_kv.init_code_cache(
            j_cfg, B, MAX_LEN, wl=16).items()}
        tc = {k: v[0] for k, v in t_kv.init_code_cache(
            t_cfg, B, MAX_LEN, wl=16, device="cpu").items()}
    else:
        jc = {"latent": j_cache(j_cfg, B, MAX_LEN)["latent"][0]}
        tc = {"latent": t_cache(t_cfg, B, MAX_LEN, device="cpu")["latent"][0]}
    fn = jax.jit(lambda p, v, q, c, pos: j_attn.mla_attention(
        p, v, j_cfg, positions=q, cache=c, pos=pos, amm=j_rt))
    out = []
    for xs, pos in ((x, 0), (x1, np.full(B, S, np.int32))):
        q = _positions(B, xs.shape[1], pos)
        jy, jc = fn(jp, jnp.asarray(xs), jnp.asarray(q), jc,
                    jnp.asarray(pos, jnp.int32))
        ty, tc = t_attn.mla_attention(
            tp, torch.from_numpy(xs), t_cfg, positions=torch.from_numpy(q),
            cache=tc, pos=torch.from_numpy(np.asarray(pos)) if np.ndim(pos)
            else pos, amm=t_rt)
        out.append((np.asarray(jy), ty.numpy(),
                    {k: np.asarray(v) for k, v in jc.items()},
                    {k: v.clone() for k, v in tc.items()}))
    return out


def test_mla_attention_without_a_cache(attn):
    jp, tp, x, _ = attn
    j_cfg, t_cfg = _cfgs()
    q = _positions(B, S, 0)
    want, _ = jax.jit(lambda p, v, pos: j_attn.mla_attention(
        p, v, j_cfg, positions=pos))(jp, jnp.asarray(x), jnp.asarray(q))
    got, cache = t_attn.mla_attention(tp, torch.from_numpy(x), t_cfg,
                                      positions=torch.from_numpy(q))
    assert cache is None and got.shape == (B, S, t_cfg.d_model)
    _close(got.numpy(), want, ATTN_RTOL)


@pytest.mark.parametrize("amm", [None, dict(BITEXACT, apply_to="attn")],
                         ids=["exact", "amm"])
def test_mla_attention_through_the_float_latent_cache(attn, amm):
    for jy, ty, jc, tc in _run(attn, "float", amm):
        _close(ty, jy, CACHE_RTOL)
        assert tc["latent"].dtype == torch.bfloat16
        _close(tc["latent"].float().numpy(),
               jc["latent"].astype(np.float32), 2.0 ** -8)


def test_mla_attention_through_the_latent_code_cache(attn):
    calls = _run(attn, "codes", dict(BITEXACT, apply_to="attn"))
    for jy, ty, jc, tc in calls:
        _close(ty, jy, CACHE_RTOL)
        assert tc["lat_codes"].dtype == torch.int16
        assert np.abs(tc["lat_codes"].numpy().astype(np.int64)
                      - jc["lat_codes"].astype(np.int64)).max() <= 1
        _close(tc["lat_scale"].numpy(), jc["lat_scale"], 2.0 ** -20)
    # the prefill's rows keep their codes through the decode step
    (_, _, _, first), (_, _, _, second) = calls
    assert torch.equal(first["lat_codes"][:, :S], second["lat_codes"][:, :S])
    assert bool((second["lat_codes"][:, S] != 0).any())


_j_code_write = jax.jit(lambda c, sc, v, p: j_attn.code_cache_update(
    c, sc, v, p, wl=16))


@pytest.mark.parametrize("pos", [0, 13, "per-slot"])
def test_latent_code_write_is_the_reference_bit_for_bit(pos):
    """The write seam fed one latent: codes and first-touch block scales
    bit-equal (the MLA layout, a head axis of 1), two writes in a row, the
    second against the first's frozen scales."""
    j_cfg, t_cfg = _cfgs()
    lat = t_cfg.kv_lora_rank + t_cfg.qk_rope_dim
    rng = np.random.default_rng(7)
    jc = {k: v[0] for k, v in j_kv.init_code_cache(j_cfg, B, MAX_LEN,
                                                   wl=16).items()}
    tc = {k: v[0] for k, v in t_kv.init_code_cache(
        t_cfg, B, MAX_LEN, wl=16, device="cpu").items()}
    for step, s in enumerate((5, 1)):
        new = rng.standard_normal((B, s, lat)).astype(np.float32)
        p = np.array([3, 17], np.int32) + step * 5 if pos == "per-slot" \
            and s == 1 else (pos if pos != "per-slot" else 3) + step * 5
        lc, ls = _j_code_write(
            jc["lat_codes"][:, :, None, :], jc["lat_scale"][..., None],
            jnp.asarray(new)[:, :, None, :], jnp.asarray(p))
        jc = {"lat_codes": lc[:, :, 0, :], "lat_scale": ls[..., 0]}
        before = tc["lat_codes"].clone()
        t_attn.code_cache_update(tc["lat_codes"][:, :, None, :],
                                 tc["lat_scale"][..., None],
                                 torch.from_numpy(new)[:, :, None, :],
                                 torch.as_tensor(p), wl=16)
        assert_array_equal(tc["lat_codes"].numpy(),
                           np.asarray(jc["lat_codes"]))
        assert_array_equal(tc["lat_scale"].numpy(),
                           np.asarray(jc["lat_scale"]))
        if step:
            changed = (before != tc["lat_codes"]).any(-1)
            assert int(changed.sum()) <= B       # one new row a slot


def test_mla_refusals(attn):
    _, tp, x, _ = attn
    _, t_cfg = _cfgs()
    tc = {"latent": t_cache(t_cfg, B, MAX_LEN, device="cpu")["latent"][0]}
    q = torch.from_numpy(_positions(B, S, 0))
    with pytest.raises(ValueError, match="scalar position"):
        t_attn.mla_attention(tp, torch.from_numpy(x), t_cfg, positions=q,
                             cache=tc, pos=torch.zeros(B, dtype=torch.int32))
    codes = {k: v[0] for k, v in t_kv.init_code_cache(
        t_cfg, B, MAX_LEN, wl=16, device="cpu").items()}
    with pytest.raises(ValueError, match="int-code KV cache requires"):
        t_attn.mla_attention(tp, torch.from_numpy(x), t_cfg, positions=q,
                             cache=codes, pos=0)


# ------------------------------------------------------- caches, axes
@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b"])
def test_cache_layouts_match_the_reference(arch):
    j_cfg, t_cfg = j_reduced(j_get(arch)), t_reduced(t_get(arch))
    for wl in (8, 16):
        want = j_kv.init_code_cache(j_cfg, 3, 32, wl=wl)
        got = t_kv.init_code_cache(t_cfg, 3, 32, wl=wl, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()}
        assert t_kv.memory_report(t_cfg, 3, 32, wl=wl) \
            == j_kv.memory_report(j_cfg, 3, 32, wl=wl)
    assert t_kv.code_cache_logical_axes(t_cfg) \
        == j_kv.code_cache_logical_axes(j_cfg)
    assert t_kv.float_cache_nbytes(t_cfg, 3, 32) \
        == j_kv.float_cache_nbytes(j_cfg, 3, 32)
    want_f = j_cache(j_cfg, 3, 32)
    got_f = t_cache(t_cfg, 3, 32, device="cpu")
    assert {k: tuple(v.shape) for k, v in want_f.items()} \
        == {k: tuple(v.shape) for k, v in got_f.items()}
    for codes in (False, True):
        assert t_engine.cache_logical_axes(t_cfg, kv_codes=codes) \
            == j_engine.cache_logical_axes(j_cfg, kv_codes=codes)


# ------------------------------------------------------------ serving
# (step, prompt, max_new): one prompt length, so the reference compiles
# one prefill program
ARRIVALS = [(0, [5, 9, 2, 4], 4), (0, [7, 1, 3, 8], 3),
            (1, [11, 12, 13, 2], 2), (2, [3, 3, 3, 3], 3)]
SLOTS = 3


def _drive(sched, request_cls, cap=500):
    reqs, t, idx = [], 0, 0
    while True:
        while idx < len(ARRIVALS) and ARRIVALS[idx][0] <= t:
            _, prompt, max_new = ARRIVALS[idx]
            reqs.append(request_cls(rid=idx, prompt=list(prompt),
                                    max_new=max_new))
            sched.submit(reqs[-1])
            idx += 1
        n = sched.step()
        t += 1
        if n == 0 and idx >= len(ARRIVALS) and not sched.queue:
            return sched, reqs
        assert t < cap, "the scheduler failed to terminate"


def test_bitexact_kv_codes_scheduler_matches_the_reference():
    """The continuous Scheduler from the latent code cache, bitexact on
    every product (``apply_to="all"``: MLA's score and value products,
    the dense prefix's MLP and the shared expert, each side with its
    launcher's precoded weight planes), against the reference's serve
    bodies under a plain ``jax.jit`` (ROADMAP C7), teacher-forced.  This
    is deepseek-v3's bitexact ``lm_apply`` at prefill and decode."""
    amm = dict(BITEXACT, apply_to="all")
    j_cfg, t_cfg = _cfgs(**amm)
    tree = numpy_params(j_table(j_cfg), seed=0)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = lm_params_from_numpy(tree, device="cpu")
    rt = JRT.build(j_cfg)
    planes = jax.jit(lambda p: j_planes(j_cfg, rt.amm, p))(jp)

    @jax.jit
    def prefill_j(p, t, c):
        logits, _, c = j_apply(p, j_cfg, rt, t, mode="decode", caches=c,
                               pos=jnp.int32(0), amm_planes=planes)
        return logits[:, -1], c

    @jax.jit
    def decode_j(p, t, c, q):
        logits, _, c = j_apply(p, j_cfg, rt, t, mode="decode", caches=c,
                               pos=q, amm_planes=planes)
        return logits[:, -1], c
    log = []
    with captured_routes() as routes:
        j_sched = j_engine.Scheduler(
            j_cfg, rt, jp, SLOTS, MAX_LEN,
            decode_fn=lambda *a: _logged(log, "decode", decode_j(*a)),
            prefill_fn=lambda *a: _logged(log, "prefill", prefill_j(*a)),
            continuous=True, kv_codes=True)
        j_sched, j_reqs = _drive(j_sched, j_engine.Request)
        jax.effects_barrier()
        want_routes = list(routes["ref"])

    trt = TRT.build(t_cfg)
    prefill_t, decode_t = t_engine.make_serve_fns(
        t_cfg, trt, kv_codes=True, amm_planes=trt.build_planes(t_cfg, tp))
    calls = []

    def forced(kind, logits, rows, positions):
        want_kind, want = log[len(calls)]
        assert kind == want_kind
        calls.append((kind, want, logits.numpy(), rows, positions))
        return torch.from_numpy(want.copy())
    sched = t_engine.Scheduler(
        t_cfg, trt, tp, SLOTS, MAX_LEN, continuous=True, kv_codes=True,
        device="cpu",
        prefill_fn=lambda p, t, c: _forced_prefill(forced, sched, prefill_t,
                                                   p, t, c),
        decode_fn=lambda p, t, c, q: _forced_decode(forced, decode_t,
                                                    p, t, c, q))
    with captured_routes() as routes:
        sched, reqs = _drive(sched, t_engine.Request)
        got_routes = list(routes["port"])
    assert len(calls) == len(log)
    assert sched.stats == dict(j_sched.stats)
    assert [(r.out, r.done, r.error) for r in reqs] \
        == [(r.out, r.done, r.error) for r in j_reqs]
    # every call's MoE layer through one ledger per slot, then its logits
    n_moe = t_cfg.n_layers - t_cfg.first_k_dense
    assert len(want_routes) == len(got_routes) == n_moe * len(calls)
    ledger = RouteLedger(LOGIT_RTOL)
    compared = 0
    for c, (kind, want, got, rows, positions) in enumerate(calls):
        if kind == "prefill":
            ledger.reset(rows[0])                  # a new request's slot
        for j in range(n_moe):
            ledger.layer(want_routes[c * n_moe + j],
                         got_routes[c * n_moe + j], rows, positions,
                         t_cfg.top_k)
        last = np.array([i for i, r in enumerate(rows)
                         if i == len(rows) - 1 or rows[i + 1] != r])
        ok = ledger.clean(rows[last], positions[last])
        if ok.any():
            _close(got[ok], want[ok], LOGIT_RTOL)
        compared += int(ok.sum())
    assert ledger.flips <= 1, ledger.flips
    assert compared >= len(calls)


def _logged(log, kind, out):
    logits, caches = out
    log.append((kind, np.asarray(logits)))
    return logits, caches


def _forced_prefill(forced, sched, fn, p, t, c):
    """A prefill on the slot ``sched`` is admitting (the one whose request
    holds no token yet)."""
    logits, c = fn(p, t, c)
    slot = next(i for i, r in enumerate(sched.slots)
                if r is not None and not r.out)
    s = t.shape[1]
    return forced("prefill", logits, np.full(s, slot), np.arange(s)), c


def _forced_decode(forced, fn, p, t, c, q):
    logits, c = fn(p, t, c, q)
    b = t.shape[0]
    return forced("decode", logits, np.arange(b), q.numpy().copy()), c


@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b"])
@pytest.mark.parametrize("flags", [
    ["--amm", "noise"], ["--amm", "noise", "--amm-pallas"],
    ["--amm", "bitexact", "--amm-attn", "--kv-codes", "--continuous"]],
    ids=["noise", "noise-fused", "bitexact-kv-codes"])
def test_launcher_serves_the_moe_family(arch, flags, capsys):
    steps = t_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-new", "3",
                           "--max-len", "32"] + flags)
    assert steps > 0
    assert "3 requests" in capsys.readouterr().out
