"""The port's MoE family against the JAX package's, on ``reduced()``
configs: the dispatch, the router, ``moe_apply`` (with and without a
shared expert, with drops and dropless), ``lm_apply`` of reduced
deepseek-v3 and grok-1 in every amm mode, ``lm_amm_planes``' tree, the
registry, and the remaining dense configs (A7).

Inputs and weights are drawn in numpy from fixed seeds and handed to both
sides (the reference's ``lm_table`` gives the shapes and inits).

Tolerances.
* ``_dispatch``: bit for bit, drops included.
* ``moe_apply`` on the same input: the router logits within 1e-5 of
  their largest (f32 products of K = 64 terms in another order); the
  output within 2^-12 of its largest (the shared expert's quantized
  activations can move by one code of 2^-15 of their range where a float
  rounding lands on a code boundary, and the routed products reorder f32
  sums); the aux loss within 1e-6 relative.
* ``lm_apply`` (both archs in every amm mode): the bf16 residual
  stream of ``tests/test_torch_lm.py``, logits within 2^-6 of their largest, the router logits of every MoE
  layer likewise.  A token whose top-k set differs must sit at a near-tie
  that the two sides' affinities explain, and the rest of its sequence
  is then left out of the comparison (``torch_moe_routes.RouteLedger``);
  the flips are counted and bounded, never skipped silently.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from numpy.testing import assert_array_equal

from repro.configs import get_arch as j_get
from repro.configs import reduced as j_reduced
from repro.configs.base import AmmConfig as JAmm
from repro.models import ModelRuntime as JRT
from repro.models import init_cache as j_cache
from repro.models import lm_amm_planes as j_planes
from repro.models import lm_apply as j_apply
from repro.models import lm_table as j_table
from repro.models import moe as j_moe
from repro_torch.configs import ARCH_NAMES, get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import prng
from repro_torch.kernels.booth_rows import booth_precode
from repro_torch.models import ModelRuntime as TRT
from repro_torch.models import init_cache as t_cache
from repro_torch.models import lm_apply as t_apply
from repro_torch.models import lm_loss as t_loss
from repro_torch.models import moe as t_moe
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

LOGIT_RTOL = 2.0 ** -6
ROUTER_RTOL = 1e-5
MOE_RTOL = 2.0 ** -12
BASE = dict(mul="bbm0", wl=16, param=13)
AMMS = {"off": dict(BASE, mode="off"),
        "noise": dict(BASE, mode="noise"),
        "noise_fused": dict(BASE, mode="noise", use_pallas=True),
        "bitexact": dict(BASE, mode="bitexact", apply_to="all")}
MOE_ARCHS = ("deepseek-v3-671b", "grok-1-314b")
B, S, MAX_LEN, DECODES = 2, 12, 32, 2


def _cfgs(arch, amm=None):
    j_cfg, t_cfg = j_reduced(j_get(arch)), t_reduced(t_get(arch))
    if amm is not None:
        j_cfg = dataclasses.replace(j_cfg, amm=JAmm(**amm))
        t_cfg = dataclasses.replace(t_cfg, amm=TAmm(**amm))
    return j_cfg, t_cfg


_WEIGHTS = {}


def _weights(arch):
    """(reference tree, port tree) of reduced ``arch``, once a module."""
    if arch not in _WEIGHTS:
        j_cfg, _ = _cfgs(arch)
        tree = numpy_params(j_table(j_cfg), seed=0)
        _WEIGHTS[arch] = (jax.tree.map(jnp.asarray, tree),
                          lm_params_from_numpy(tree, device="cpu"))
    return _WEIGHTS[arch]


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


# --------------------------------------------------------------- dispatch
@given(t=st.integers(1, 48), e=st.integers(2, 16), k=st.integers(1, 4),
       factor=st.sampled_from([0.25, 0.5, 1.0, 1.25, "dropless"]),
       seed=st.integers(0, 2 ** 16))
@example(t=24, e=8, k=2, factor=1.25, seed=0)        # drops
@example(t=8, e=16, k=4, factor="dropless", seed=1)
@settings(max_examples=4, deadline=None)
def test_dispatch_is_the_reference_bit_for_bit(t, e, k, factor, seed):
    k = min(k, e)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, e, t * k).astype(np.int32)
    cap = t if factor == "dropless" else max(int(factor * k * t / e), 1)
    want = jax.jit(j_moe._dispatch, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(ids), k, t, e, cap)
    got = t_moe._dispatch(torch.from_numpy(ids), k, t, e, cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert_array_equal(g.numpy(), np.asarray(w))


def test_capacity_is_the_reference_expression():
    """``max(int(capacity_factor * k * T / E), 1)``, and decode dropless."""
    _, cfg = _cfgs("deepseek-v3-671b")
    e, k = cfg.n_experts, cfg.top_k
    for b, s in ((1, 1), (8, 1), (2, 12), (1, 3), (1, 128)):
        want = max(int((e / k if s == 1 else 1.25) * k * (b * s) / e), 1)
        assert t_moe.moe_capacity(cfg, b, s) == want
    assert t_moe.moe_capacity(cfg, 8, 1) == 8           # capacity == T
    full = t_get("deepseek-v3-671b")
    assert t_moe.moe_capacity(full, 8, 1) == 8
    assert t_moe.moe_capacity(full, 1, 128) == 5        # 1.25 * 8 * 128 / 256


def test_top_k_orders_ties_as_jax():
    probs = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5],
                      [0.2, 0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.3, 0.7, 0.7, 0.1, 0.7, 0.7]], np.float32)
    for k in (1, 2, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = t_moe._top_k(torch.from_numpy(probs), k)
        assert_array_equal(gi.numpy(), np.asarray(wi))
        assert_array_equal(gv.numpy(), np.asarray(wv))


# ---------------------------------------------------------------- moe_apply
def _moe_layer(arch):
    jw, tw = _weights(arch)
    return (jax.tree.map(lambda a: a[0], jw["layers"]["moe"]),
            {k: (v[0] if not isinstance(v, dict)
                 else {n: u[0] for n, u in v.items()})
             for k, v in tw["layers"]["moe"].items()})


def _moe_parity(arch, shape, amm=None, seed=1):
    """moe_apply on the same input on both sides: (want y, got y, want
    aux, got aux), the router held by a ``RouteLedger``."""
    j_cfg, t_cfg = _cfgs(arch, amm)
    jp, tp = _moe_layer(arch)
    x = np.random.default_rng(seed).standard_normal(
        shape + (t_cfg.d_model,)).astype(np.float32)
    j_rt = None if amm is None else JRT.build(j_cfg).amm
    t_rt = None if amm is None else TRT.build(t_cfg, device="cpu").amm
    want, w_aux = jax.jit(lambda p, v: j_moe.moe_apply(
        p, v, j_cfg, amm=j_rt, key=jax.random.key(3)))(jp, jnp.asarray(x))
    got, g_aux = t_moe.moe_apply(tp, torch.from_numpy(x), t_cfg, amm=t_rt,
                                 key=prng.key(3))
    xf = x.reshape(-1, t_cfg.d_model)
    ref_lg = xf @ np.asarray(jp["router"])
    port_lg = t_moe.moe_route(tp, torch.from_numpy(xf), t_cfg)[0].numpy()
    ledger = RouteLedger(ROUTER_RTOL)
    rows, pos = grid(shape[0], shape[1])
    ledger.layer(ref_lg, port_lg, rows, pos, t_cfg.top_k)
    return np.asarray(want), got.numpy(), float(w_aux), float(g_aux), ledger


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shape", [(2, 12), (8, 1)], ids=["prefill",
                                                          "decode"])
def test_moe_apply_matches_the_reference(arch, shape):
    """Prefill (capacity drops: C = 7 of 24 tokens x 2 decisions over 8
    experts) and decode (dropless)."""
    want, got, w_aux, g_aux, ledger = _moe_parity(arch, shape)
    assert ledger.flips == 0
    assert got.shape == want.shape == shape + (64,)
    _close(got, want, MOE_RTOL)
    assert abs(g_aux - w_aux) <= 1e-6 * abs(w_aux)
    _, t_cfg = _cfgs(arch)
    cap = t_moe.moe_capacity(t_cfg, *shape)
    assert (cap < shape[0] * shape[1]) == (shape[1] > 1)


@pytest.mark.parametrize("branch", ["noise", "noise_fused"])
def test_shared_expert_on_the_amm_datapath(branch):
    """deepseek-v3's shared expert through ``amm_dense`` on the flattened
    (B*S, d) tokens of a prefill, its noise drawn at (B*S, N), not (B, S,
    N), from the layer key.  (Its bitexact product is held by ``lm_apply``'s
    bitexact train forward and the kv-codes Scheduler.)"""
    shape = (2, 12)
    want, got, w_aux, g_aux, ledger = _moe_parity(
        "deepseek-v3-671b", shape, AMMS[branch])
    assert ledger.flips == 0
    _close(got, want, MOE_RTOL)
    assert abs(g_aux - w_aux) <= 1e-6 * abs(w_aux)
    _, t_cfg = _cfgs("deepseek-v3-671b")
    x = np.random.default_rng(1).standard_normal(
        shape + (t_cfg.d_model,)).astype(np.float32)
    exact, _ = t_moe.moe_apply(_moe_layer("deepseek-v3-671b")[1],
                               torch.from_numpy(x), t_cfg)
    assert np.abs(got - exact.numpy()).max() > 0      # the branch acted


# ---------------------------------------------------------------- lm_apply
_REFS = {}


def _reference(arch, amm_name, mode):
    """The reference's logits and router logs of reduced ``arch``: a train
    forward ("train"), or a prefill then ``DECODES`` per-slot decode steps
    through the float cache ("serve"), each program one ``jax.jit``."""
    key = (arch, amm_name, mode)
    if key in _REFS:
        return _REFS[key]
    j_cfg, _ = _cfgs(arch, AMMS[amm_name])
    jp, _ = _weights(arch)
    rt = JRT.build(j_cfg)
    toks, nxt = _tokens()
    with captured_routes() as log:
        if mode == "train":
            train = jax.jit(lambda p, t: j_apply(p, j_cfg, rt, t)[0])
            logits = [np.asarray(train(jp, jnp.asarray(toks)))]
        else:
            prefill = jax.jit(lambda p, t, c: j_apply(
                p, j_cfg, rt, t, mode="decode", caches=c,
                pos=jnp.int32(0))[::2])
            decode = jax.jit(lambda p, t, c, q: j_apply(
                p, j_cfg, rt, t, mode="decode", caches=c, pos=q)[::2])
            lg, c = prefill(jp, jnp.asarray(toks),
                            j_cache(j_cfg, B, MAX_LEN))
            logits = [np.asarray(lg)]
            for i in range(DECODES):
                lg, c = decode(jp, jnp.asarray(nxt[i]), c,
                               jnp.full((B,), S + i, jnp.int32))
                logits.append(np.asarray(lg))
        jax.effects_barrier()
    _REFS[key] = (logits, list(log["ref"]))
    return _REFS[key]


def _tokens():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 512, (B, S)).astype(np.int32),
            rng.integers(0, 512, (DECODES, B, 1)).astype(np.int32))


def _held(cfg, want_logits, got_logits, want_routes, got_routes, calls):
    """Hold a sequence of lm_apply calls (each ``(b, s, pos)``) to the
    reference: every MoE layer's router through one ``RouteLedger``, then
    each call's logits at the positions no flip has reached."""
    ledger = RouteLedger(LOGIT_RTOL)
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert len(want_routes) == len(got_routes) == n_moe * len(calls)
    compared = 0
    for c, ((b, s, pos), want, got) in enumerate(zip(calls, want_logits,
                                                     got_logits)):
        rows, positions = grid(b, s, pos)
        for j in range(n_moe):
            ledger.layer(want_routes[c * n_moe + j],
                         got_routes[c * n_moe + j], rows, positions,
                         cfg.top_k)
        ok = ledger.clean(rows, positions).reshape(b, s)
        want = np.asarray(want).reshape(b, s, -1)
        got = np.asarray(got).reshape(b, s, -1)
        if ok.any():
            _close(got[ok], want[ok], LOGIT_RTOL)
        compared += int(ok.sum())
    return ledger, compared


# (arch, amm, mode): every amm mode of both archs in a train forward, and
# a serve run (prefill, then per-slot decode steps) once per amm family:
# noise serves on the fused kernel (its plain branch is held at prefill
# by the train forward and ``test_shared_expert_on_the_amm_datapath``),
# and deepseek-v3's bitexact serve is the kv-codes Scheduler of
# ``tests/test_torch_mla.py`` (``apply_to="all"``, the same lm_apply
# calls on the latent code cache): each reference program takes seconds
# to trace and compile.  grok-1 has neither a dense prefix nor a shared expert: its noise
# modes leave every product exact, and its bitexact mode takes the GQA
# attention products (inside the MoE branch) onto the amm datapath.
LM_CASES = [("deepseek-v3-671b", "off", "train"),
            ("deepseek-v3-671b", "off", "serve"),
            ("deepseek-v3-671b", "noise", "train"),
            ("deepseek-v3-671b", "noise_fused", "serve"),
            ("deepseek-v3-671b", "bitexact", "train"),
            ("grok-1-314b", "off", "train"),
            ("grok-1-314b", "off", "serve"),
            ("grok-1-314b", "noise", "train"),
            ("grok-1-314b", "bitexact", "train")]


@pytest.mark.parametrize("arch,amm,mode", LM_CASES,
                         ids=[f"{m}-{a}-{n}" for a, n, m in LM_CASES])
def test_lm_apply_matches_the_reference(arch, amm, mode):
    want, want_routes = _reference(arch, amm, mode)
    _, t_cfg = _cfgs(arch, AMMS[amm])
    _, tp = _weights(arch)
    rt = TRT.build(t_cfg, device="cpu")
    toks, nxt = _tokens()
    with captured_routes() as log:
        if mode == "train":
            logits, aux, _ = t_apply(tp, t_cfg, rt, torch.from_numpy(toks))
            got = [logits]
            calls = [(B, S, 0)]
            assert float(aux["moe_aux"]) > 0
        else:
            c = t_cache(t_cfg, B, MAX_LEN, device="cpu")
            lg, _, c = t_apply(tp, t_cfg, rt, torch.from_numpy(toks),
                               mode="decode", caches=c, pos=0)
            got = [lg]
            for i in range(DECODES):
                lg, _, c = t_apply(tp, t_cfg, rt, torch.from_numpy(nxt[i]),
                                   mode="decode", caches=c,
                                   pos=torch.full((B,), S + i))
                got.append(lg)
            calls = [(B, S, 0)] + [(B, 1, S + i) for i in range(DECODES)]
    ledger, compared = _held(t_cfg, want, [g.numpy() for g in got],
                             want_routes, log["port"], calls)
    # a flip leaves out the rest of one sequence; most positions compare
    assert ledger.flips <= 1, ledger.flips
    total = sum(b * s for b, s, _ in calls)
    assert compared >= total // 2, (compared, total)
    if AMMS[amm]["mode"] != "off":
        assert rt.amm.mlp_active or rt.amm.attn_lowering is not None


def test_noise_keys_follow_the_reference_chain():
    """The prefix consumes the first splits of ``key(0)`` and the MoE
    stack continues from the carried key: one chain over all layers,
    ``core.prng.layer_keys``."""
    j_cfg, t_cfg = _cfgs("deepseek-v3-671b")
    rng = jax.random.key(0)
    want = []
    for _ in range(j_cfg.first_k_dense):
        rng, sub = jax.random.split(rng)
        want.append(sub)
    key = rng
    for _ in range(j_cfg.n_layers - j_cfg.first_k_dense):
        key, sub = jax.random.split(key)
        want.append(sub)
    got = prng.layer_keys(0, t_cfg.n_layers)
    assert [tuple(int(v) for v in jax.random.key_data(k)) for k in want] \
        == [tuple(k) for k in got]


# ------------------------------------------------------------ planes, tree
def test_lm_amm_planes_tree_matches_the_reference():
    for arch in MOE_ARCHS:
        j_cfg, t_cfg = _cfgs(arch, AMMS["bitexact"])
        jw, tw = _weights(arch)
        # under jit (bit-equal to the launcher's eager build, in a third
        # of its time)
        amm = JRT.build(j_cfg).amm
        want = jax.jit(lambda p: j_planes(j_cfg, amm, p))(jw)
        got = TRT.build(t_cfg).build_planes(t_cfg, tw)
        assert jax.tree.structure(jax.tree.map(
            lambda _: 0, want, is_leaf=lambda v: isinstance(v, dict)
            and "s_w" in v)) == jax.tree.structure(jax.tree.map(
                lambda _: 0, got, is_leaf=lambda v: isinstance(v, dict)
                and "s_w" in v))
        pairs = [(gp["mlp"][n], wp["mlp"][n])
                 for gp, wp in zip(got["dense_prefix"], want["dense_prefix"])
                 for n in ("w_gate", "w_up", "w_down")]
        if t_cfg.n_shared_experts:
            g_sh = got["layers"]["moe"]["shared"]
            w_sh = want["layers"]["moe"]["shared"]
            for name in ("w_gate", "w_up", "w_down"):
                for i in range(t_cfg.n_layers - t_cfg.first_k_dense):
                    pairs.append(({"codes": g_sh[name]["codes"][i],
                                   "s_w": g_sh[name]["s_w"][i]},
                                  jax.tree.map(lambda a: a[i],
                                               w_sh[name])))
        else:
            assert got == {"dense_prefix": []}
        for g, w in pairs:
            mag, neg = booth_precode(g["codes"], 16)
            assert_array_equal(mag.numpy(), np.asarray(w["mag"]))
            assert_array_equal(neg.numpy(), np.asarray(w["neg"]))
            assert_array_equal(g["s_w"].numpy(), np.asarray(w["s_w"]))
    # the port's lm_table keeps the reference's tree (the MTP block too)
    for arch in MOE_ARCHS:
        j_cfg, t_cfg = _cfgs(arch)
        shapes = jax.tree.map(lambda v: tuple(v.shape), _weights(arch)[0])
        from repro_torch.models import lm_table as t_table
        t_shapes = jax.tree.map(lambda s: tuple(s.shape), t_table(t_cfg),
                                is_leaf=lambda v: hasattr(v, "axes"))
        assert t_shapes == shapes


# ------------------------------------------------------------- registry
def test_registry_ports_the_moe_and_dense_configs(tmp_path):
    for name in ("deepseek-v3-671b", "grok-1-314b", "qwen1.5-110b",
                 "llama3.2-3b", "yi-34b", "qwen2-0.5b", "mamba2-370m",
                 "zamba2-2.7b", "chameleon-34b", "whisper-base"):
        want = dataclasses.asdict(j_get(name))
        got = dataclasses.asdict(t_get(name))
        assert got == want, name
        assert dataclasses.asdict(t_reduced(t_get(name))) \
            == dataclasses.asdict(j_reduced(j_get(name))), name
    assert "whisper-base" in ARCH_NAMES
    assert t_get("whisper-base").is_encoder_decoder
    _, t_cfg = _cfgs("deepseek-v3-671b")
    tp = _weights("deepseek-v3-671b")[1]
    toks = torch.zeros((1, 4), dtype=torch.int64)
    # the MoE family trains: the loss has its load-balance and MTP terms,
    # and the launcher takes a step of either MoE arch
    total, metrics = t_loss(tp, t_cfg, TRT.build(t_cfg), toks, toks)
    assert set(metrics) == {"ce", "moe_aux", "mtp"}
    assert all(bool(torch.isfinite(v)) for v in (total, *metrics.values()))
    from repro_torch.launch import train as t_train
    for arch in MOE_ARCHS:
        hist = t_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "1", "--batch", "2", "--seq", "8",
                             "--ckpt-dir", str(tmp_path / arch)])
        assert [h["step"] for h in hist] == [0]
        assert np.isfinite(hist[0]["loss"]) and "moe_aux" in hist[0]
    # the audio family is ported: without an encoder it is the dense
    # stack, with one the encoder-decoder stack, which needs embeddings
    from repro_torch.models import lm_table as t_table
    for fam in ("audio",):
        cfg = dataclasses.replace(t_cfg, family=fam, use_mla=False)
        assert set(t_table(cfg)) == {"embed", "final_norm", "lm_head",
                                     "layers"}
        w_cfg = t_reduced(t_get("whisper-base"))
        assert w_cfg.family == fam
        assert {"encoder", "layers"} <= set(t_table(w_cfg))
        with pytest.raises(ValueError, match="encoder_embeds"):
            t_apply({"embed": torch.zeros((w_cfg.vocab, w_cfg.d_model))},
                    w_cfg, TRT.build(w_cfg), toks)


# ------------------------------------------------------ A7: dense configs
_DENSE = ("qwen1.5-110b", "llama3.2-3b", "yi-34b")


@pytest.mark.parametrize("arch", _DENSE)
@pytest.mark.parametrize("amm", ["off", "bitexact"])
def test_dense_configs_match_the_reference(arch, amm):
    """A prefill through the float cache and one per-slot decode step."""
    amm_cfg = dict(BASE, mode=amm)
    j_cfg, t_cfg = _cfgs(arch, amm_cfg)
    tree = numpy_params(j_table(j_cfg), seed=2)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = lm_params_from_numpy(tree, device="cpu")
    toks, nxt = _tokens()
    rt = JRT.build(j_cfg)

    @jax.jit
    def ref(p, t, n):
        lg, _, c = j_apply(p, j_cfg, rt, t, mode="decode",
                           caches=j_cache(j_cfg, B, MAX_LEN),
                           pos=jnp.int32(0))
        lg2, _, _ = j_apply(p, j_cfg, rt, n, mode="decode", caches=c,
                            pos=jnp.full((B,), S, jnp.int32))
        return lg, lg2
    want = ref(jp, jnp.asarray(toks), jnp.asarray(nxt[0]))
    trt = TRT.build(t_cfg)
    c = t_cache(t_cfg, B, MAX_LEN, device="cpu")
    lg, _, c = t_apply(tp, t_cfg, trt, torch.from_numpy(toks),
                       mode="decode", caches=c, pos=0)
    lg2, _, _ = t_apply(tp, t_cfg, trt, torch.from_numpy(nxt[0]),
                        mode="decode", caches=c, pos=torch.full((B,), S))
    for g, w in zip((lg, lg2), want):
        _close(g.numpy(), w, LOGIT_RTOL)
