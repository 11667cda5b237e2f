"""Training the MoE family: the port against the JAX package on reduced
deepseek-v3 (a dense prefix layer, one MoE layer with a shared expert,
multi-head latent attention, the MTP block) and reduced grok-1 (two MoE
layers, GQA, no shared expert).

Covered: ``loss_and_grads`` (``lm_loss``: the cross entropy, 1e-2 x the
Switch load-balance term, 0.1 x the MTP head's cross entropy) and every
gradient leaf against the reference's unsharded ``loss_and_grads`` under
``jax.jit`` in off, noise (WL 8 / VBL 5) and bitexact (WL 8 / VBL 5,
apply_to="all": the MLP products and the attention products, MLA's on
the chunked schedule); the reference's MTP quirk the port copies (ROADMAP C17); two
steps of the training launcher against the reference's steps run
unsharded (its sharded step fails, C2), with the loss terms in the
history; the flash kernels' plain versions at head dims 80 (zamba2) and
128 (grok-1 and the dense configs) against the reference (the amm one
against ``flash_amm_chunked_equiv``: the reference's Pallas flash-amm
does not trace under jax 0.9.0, C1); the envelope guards.

Routing.  The jitted reference and the port round the bf16 residual
stream differently, which can flip a token's top-k set where its k-th
and (k+1)-th affinities nearly tie (``torch_moe_routes``).  A flip moves
the token's whole contribution from one expert's gradient to another's.
So the port's router logits are first held to the reference's by
``RouteLedger`` (a differing decision accepted only at a near-tie the
logits' difference explains), and then every MoE call of the port takes
the reference's top-k decisions of the same call, with gate weights
from its own router, so that the gradients compare on one routing.

Tolerances.  Router logits within 2^-6 of their largest (the bf16
residual stream, as in ``tests/test_torch_moe.py``); the loss and each
loss term within 2^-12 of its value; each gradient leaf within 2^-5 of
its largest element, as in ``tests/test_torch_train.py``, and within
2^-4 in the WL 8 amm cases: there a float rounding that carries an
operand across a code boundary moves its product by 2^-7 of the block's
scale (2^-15 at WL 16), twice the bf16 stream's 2^-8, and the gradients
are taken at those forward values; the flash plain versions within
``flash_tolerance`` and by ``flash_amm_compare``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get
from repro.configs import reduced as j_reduced
from repro.configs.base import AmmConfig as JAmm
from repro.core import guards as j_guards
from repro.data import pipeline as j_pipe
from repro.kernels import ops as j_ops
from repro.models import ModelRuntime as JRT
from repro.models import attention as j_attn
from repro.models import lm_init as j_init
from repro.models import lm_loss as j_loss
from repro.models import lm_table as j_table
from repro.models import transformer as j_tr
from repro.train import optimizer as j_opt
from repro.train import trainstep as j_step
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import guards as t_guards
from repro_torch.core import prng
from repro_torch.launch import train as t_train_launch
from repro_torch.models import ModelRuntime as TRT
from repro_torch.models import lm_loss as t_loss
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr
from repro_torch.train import optimizer as t_opt
from repro_torch.train import trainstep as t_step
from test_torch_flash import (_as_skipped, _compare, _jax_amm_dot_records,
                              _qkv, _t)
from torch_amm_capture import chunked_residuals
from torch_moe_routes import RouteLedger, grid, numpy_params

pytest_plugins = ["port_first"]

tf = importlib.import_module("repro_torch.kernels.flash_attention")

ROUTER_RTOL = 2.0 ** -6
LOSS_RTOL = 2.0 ** -12
GRAD_RTOL = 2.0 ** -5
GRAD_RTOL_WL8 = 2.0 ** -4
BASE = dict(mul="bbm0", wl=16, param=13)
W8 = dict(mul="bbm0", wl=8, param=5)
AMMS = {"off": dict(BASE, mode="off"),
        "noise8": dict(W8, mode="noise"),
        "bitexact8": dict(W8, mode="bitexact", apply_to="all")}
B, S = 2, 16
# grok-1 has no shared expert and no dense layer: only its attention has
# products the amm datapath takes, and its noise case runs nothing
# through amm_dense (test_grok_has_no_amm_product_outside_attention)
CASES = [(arch, amm) for arch in ("deepseek-v3-671b", "grok-1-314b")
         for amm in AMMS]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, amm="off"):
    j_cfg, t_cfg = j_reduced(j_get(arch)), t_reduced(t_get(arch))
    return (dataclasses.replace(j_cfg, amm=JAmm(**AMMS[amm])),
            dataclasses.replace(t_cfg, amm=TAmm(**AMMS[amm])))


_WEIGHTS = {}


def _weights(arch):
    """(reference tree, port tree) of reduced ``arch``, once a module."""
    if arch not in _WEIGHTS:
        j_cfg, _ = _cfgs(arch)
        tree = numpy_params(j_table(j_cfg), seed=0)
        _WEIGHTS[arch] = (jax.tree.map(jnp.asarray, tree),
                          lm_params_from_numpy(tree, device="cpu"))
    return _WEIGHTS[arch]


def _batch(cfg, batch=B, seq=S, step=0):
    dc = j_pipe.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    return j_pipe.global_batch(dc, step)


_GRAD_FNS = {}
# the router logits of the reference's MoE calls since the last clear
_SINK: list = []


def _route_spy(orig):
    """The reference's ``moe_apply`` with its router logits sent to
    ``_SINK`` by an ordered callback, which a cached compile keeps."""
    def spy(p, x, cfg, **kw):
        lg = x.reshape(-1, x.shape[-1]).astype(jnp.float32) \
            @ p["router"].astype(jnp.float32)
        jax.debug.callback(lambda v: _SINK.append(np.asarray(v)), lg,
                           ordered=True)
        return orig(p, x, cfg, **kw)
    return spy


def _j_loss_and_grads(arch, amm, *args):
    """The reference's unsharded ``loss_and_grads`` jitted (once per arch
    and amm mode: the launcher's test reuses the compile) and run on
    ``args``: (its outputs, the router logits of its MoE calls)."""
    if (arch, amm) not in _GRAD_FNS:
        j_cfg, _ = _cfgs(arch, amm)
        j_rt = JRT.build(j_cfg)
        _GRAD_FNS[arch, amm] = jax.jit(
            lambda p, t, l, k: j_step.loss_and_grads(p, j_cfg, j_rt, t, l,
                                                     k))
    orig = j_tr.moe_apply
    j_tr.moe_apply = _route_spy(orig)
    _SINK.clear()
    try:
        out = _GRAD_FNS[arch, amm](*args)
        jax.block_until_ready(out)
        jax.effects_barrier()
    finally:
        j_tr.moe_apply = orig
    return out, list(_SINK)


@contextlib.contextmanager
def _reference_routing(ref_logits):
    """Within: each MoE call of the port (its layers, then the MTP block)
    records its router logits in the yielded list and takes the top-k
    decisions the reference took in the same call, ranked from the
    reference's logits; the gate weights are the port's own affinities
    at those experts."""
    port_logits, calls = [], iter(ref_logits)
    orig_apply, orig_top = t_tr.moe_apply, t_moe._top_k

    def apply(p, x, cfg, **kw):
        xf = x.detach().reshape(-1, x.shape[-1]).to(torch.float32)
        port_logits.append((xf @ p["router"].detach().to(torch.float32))
                           .numpy())
        return orig_apply(p, x, cfg, **kw)

    def top_k(probs, k):
        ref = torch.sigmoid(torch.tensor(next(calls)))
        _, idx = orig_top(ref, k)
        return probs.gather(-1, idx), idx

    t_tr.moe_apply, t_moe._top_k = apply, top_k
    try:
        yield port_logits
    finally:
        t_tr.moe_apply, t_moe._top_k = orig_apply, orig_top
    assert next(calls, None) is None, "the port made fewer MoE calls"


def _hold_routes(ref_logits, port_logits, cfg, b=B, s=S) -> int:
    """Every MoE call's router logits held by ``RouteLedger``; returns
    the flips it accepted."""
    assert len(ref_logits) == len(port_logits) > 0
    rows, pos = grid(b, s)
    flips = 0
    for ref, port in zip(ref_logits, port_logits):
        ledger = RouteLedger(ROUTER_RTOL)
        ledger.layer(ref, port, rows, pos, cfg.top_k)
        flips += ledger.flips
    return flips


def _hold_grads(got, want, rtol=GRAD_RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.isfinite(g.double().numpy()).all()
        err = np.abs(g.double().numpy() - w).max()
        assert err <= rtol * np.abs(w).max(), (err, np.abs(w).max())


def _close(got, want, rtol=LOSS_RTOL):
    got, want = float(got), float(want)
    assert np.isfinite(got) and abs(got - want) <= rtol * abs(want), (
        got, want)


# ------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch,amm", CASES)
def test_loss_and_grads_match_the_reference(arch, amm):
    """``loss_and_grads`` of the port against the reference's: the total,
    the loss terms (``ce``, ``moe_aux`` and, for deepseek-v3, ``mtp``)
    and every gradient leaf, the router's, the routed and shared
    experts', MLA's and the MTP block's among them, on the reference's
    routing after the port's own was held to it."""
    j_cfg, t_cfg = _cfgs(arch, amm)
    jp, tp = _weights(arch)
    toks, labels = _batch(t_cfg)
    (j_l, j_g, j_m), routes = _j_loss_and_grads(
        arch, amm, jp, jnp.asarray(toks), jnp.asarray(labels),
        jax.random.key(1))
    t_rt = TRT.build(t_cfg, device="cpu")
    with _reference_routing(routes) as port_logits:
        t_l, t_g, t_m = t_step.loss_and_grads(
            tp, t_cfg, t_rt, torch.from_numpy(toks),
            torch.from_numpy(labels), prng.key(1))
    _hold_routes(routes, port_logits, t_cfg)
    want_terms = {"ce", "moe_aux"} | ({"mtp"} if t_cfg.mtp_depth else set())
    assert set(t_m) == set(j_m) == want_terms
    _close(t_l, j_l)
    for name in want_terms:
        _close(t_m[name], j_m[name])
    _hold_grads(t_opt.tree_leaves(t_g), jax.tree.leaves(j_g),
                GRAD_RTOL if amm == "off" else GRAD_RTOL_WL8)
    # the Switch term reaches the router through the softmax alone, and
    # the experts that took tokens get gradients
    assert float(t_g["layers"]["moe"]["router"].abs().max()) > 0
    assert float(t_g["layers"]["moe"]["w_down"].abs().max()) > 0
    if t_cfg.mtp_depth:
        assert float(t_g["mtp"]["proj"].abs().max()) > 0


def test_grok_has_no_amm_product_outside_attention():
    """grok-1's noise case is its exact one bit for bit on the port: no
    dense layer and no shared expert, so nothing reaches ``amm_dense``."""
    _, t_off = _cfgs("grok-1-314b", "off")
    _, t_noise = _cfgs("grok-1-314b", "noise8")
    _, tp = _weights("grok-1-314b")
    toks, labels = (torch.from_numpy(a) for a in _batch(t_off))
    a = t_loss(tp, t_off, TRT.build(t_off, device="cpu"), toks, labels,
               rng=prng.key(1))
    b = t_loss(tp, t_noise, TRT.build(t_noise, device="cpu"), toks, labels,
               rng=prng.key(1))
    assert torch.equal(a[0], b[0])


# ----------------------------------------------------------------- C17
def test_c17_the_mtp_block_reads_the_token_embeddings():
    """ROADMAP C17: the reference's MTP block takes ``rmsnorm(embed[tokens])``
    beside ``embed[labels]``, where DeepSeek-V3's takes the main stack's
    last hidden state.  So scaling every weight of the main stack (the
    dense prefix and the MoE layers) changes the cross entropy and
    leaves the MTP term bit for bit, on both sides; on the port the MTP
    term's gradient reaches no main-stack weight; the two sides' MTP
    terms agree."""
    arch = "deepseek-v3-671b"
    j_cfg, t_cfg = _cfgs(arch)
    jp, tp = _weights(arch)
    toks, labels = _batch(t_cfg)
    jl = jax.jit(lambda p: j_loss(p, j_cfg, JRT.build(j_cfg),
                                  jnp.asarray(toks), jnp.asarray(labels),
                                  rng=jax.random.key(1))[1])
    j_scaled = dict(jp, layers=jax.tree.map(lambda a: a * 3, jp["layers"]),
                    dense_prefix=jax.tree.map(lambda a: a * 3,
                                              jp["dense_prefix"]))
    j_a, j_b = jl(jp), jl(j_scaled)
    assert float(j_a["ce"]) != float(j_b["ce"])
    assert np.array_equal(np.asarray(j_a["mtp"]), np.asarray(j_b["mtp"]))
    t_rt = TRT.build(t_cfg, device="cpu")
    scaled = dict(tp, layers=t_opt.tree_map(lambda a: a * 3, tp["layers"]),
                  dense_prefix=t_opt.tree_map(lambda a: a * 3,
                                              tp["dense_prefix"]))
    run = lambda p: t_loss(p, t_cfg, t_rt, torch.from_numpy(toks),  # noqa
                           torch.from_numpy(labels), rng=prng.key(1))[1]
    t_a, t_b = run(tp), run(scaled)
    assert float(t_a["ce"]) != float(t_b["ce"])
    assert torch.equal(t_a["mtp"], t_b["mtp"])
    _close(t_a["mtp"], j_a["mtp"])
    leaves = t_opt.tree_map(lambda a: a.detach().requires_grad_(), tp)
    _, m = t_loss(leaves, t_cfg, t_rt, torch.from_numpy(toks),
                  torch.from_numpy(labels), rng=prng.key(1))
    main = t_opt.tree_leaves({"layers": leaves["layers"],
                              "dense_prefix": leaves["dense_prefix"]})
    grads = torch.autograd.grad(m["mtp"], main, allow_unused=True)
    assert all(g is None or not g.any() for g in grads)
    assert torch.autograd.grad(m["mtp"], leaves["mtp"]["proj"])[0].any()


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "grok-1-314b"])
def test_launcher_steps_match_the_reference(arch, tmp_path, monkeypatch):
    """Two steps of ``launch.train --arch <moe> --reduced`` on the CPU from
    the reference launcher's initial weights (``lm_init`` at key 0),
    against the reference launcher's steps run unsharded (ROADMAP C2):
    the same batches, keys ``fold_in(key(42), step)`` and AdamW updates,
    each step's routing held and then shared as in
    ``test_loss_and_grads_match_the_reference``.  The history carries
    each step's loss terms."""
    steps = 2
    j_cfg, t_cfg = _cfgs(arch)
    jp = j_init(j_cfg, jax.random.key(0))
    npp = jax.tree.map(np.asarray, jp)
    oc = j_opt.OptConfig(lr=3e-4, total_steps=steps)
    opt = j_opt.init_opt(jp, oc)
    upd = jax.jit(lambda p, g, o: j_opt.apply_updates(p, g, o, oc))
    want, terms, routes = [], [], []
    for step in range(steps):
        toks, labels = _batch(j_cfg, step=step)
        (loss, grads, m), r = _j_loss_and_grads(
            arch, "off", jp, jnp.asarray(toks), jnp.asarray(labels),
            jax.random.fold_in(jax.random.key(42), step))
        jp, opt, _ = upd(jp, grads, opt)
        want.append(float(loss))
        terms.append({k: float(v) for k, v in m.items()})
        routes += r
    monkeypatch.setattr(t_train_launch, "lm_init",
                        lambda cfg, seed, **kw: lm_params_from_numpy(
                            npp, device="cpu"))
    with _reference_routing(routes) as port_logits:
        hist = t_train_launch.main([
            "--arch", arch, "--reduced", "--device", "cpu", "--steps",
            str(steps), "--batch", str(B), "--seq", str(S), "--ckpt-dir",
            str(tmp_path / "ck")])
    _hold_routes(routes, port_logits, t_cfg)
    assert [h["step"] for h in hist] == list(range(steps))
    for h, w, m in zip(hist, want, terms):
        _close(h["loss"], w)
        assert set(m) <= set(h)
        for name, v in m.items():
            _close(h[name], v)
    assert ("mtp" in hist[0]) == bool(t_cfg.mtp_depth)


# ---------------------------------------------- flash at head dims 80, 128
@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_exact_flash_plain_matches_the_reference_at_new_head_dims(d, causal):
    """The exact flash wrapper's plain version against the reference's
    ``flash_attention`` at head dims 80 and 128, within
    ``flash_tolerance``; the kernel's head dims include both."""
    assert {80, 128} <= set(tf._HEAD_DIMS)
    q, k, v = _qkv(sq=40, skv=40, d=d)
    tq, tk, tv = _t(q, k, v)
    got = tf.flash_attention(tq, tk, tv, causal=causal, bq=16, bk=16)
    want = j_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=causal, bq=16, bk=16)
    tol = tf.flash_tolerance(tq, tk, tv).numpy()
    err = np.abs(got.double().numpy() - np.asarray(want, np.float64))
    assert (err <= tol).all(), (err.max(), tol.min())


@pytest.mark.parametrize("d", [80, 128])
def test_amm_flash_plain_matches_the_reference_at_new_head_dims(d):
    """The flash-amm wrapper's plain version at head dims 80 and 128, two
    tiles of 128 and a ragged tail (150 positions), causal, against the
    reference's ``flash_amm_chunked_equiv`` (the chunked schedule at the
    flash tiles), held by ``flash_amm_compare``: every tile's score
    products bit-equal, P's codes within float rounding, the P V
    products bit-equal where they agree, the output within the bound
    (the reference's dead tiles as the port's schedule leaves them,
    ``_as_skipped``)."""
    q, k, v = _qkv(sq=150, skv=150, d=d)
    j_cfg, _ = _cfgs("grok-1-314b")
    jrt = JRT.build(dataclasses.replace(
        j_cfg, amm=JAmm(**dict(BASE, mode="bitexact", apply_to="attn")))).amm
    with _jax_amm_dot_records() as jrecs:
        want = j_attn.flash_amm_chunked_equiv(
            *(jnp.asarray(a) for a in (q, k, v)), jrt, causal=True)
    _, ref, q_pos = chunked_residuals(jrecs, (1, 150, 2, d, 150, 2),
                                      np.asarray(want).transpose(0, 2, 1, 3),
                                      wl=16, bq=tf.FLASH_AMM_BQ,
                                      bk=tf.FLASH_AMM_BK)
    tq, tk, tv = _t(q, k, v)
    got, res = tf.flash_attention_amm(tq, tk, tv, wl=16, vbl=13, kind=0,
                                      causal=True, residuals=True)
    ops = tf.flash_amm_operands(tq, tk, tv, wl=16)
    _compare(ops, dict(res, out=got.reshape(2, 150, d)),
             _as_skipped(ops, dict(ref, out=ref["out"][:, :150]), kind=0,
                         causal=True), wl=16, vbl=13, causal=True,
             q_pos=q_pos)


# --------------------------------------------------------------- guards
def _trip(fn, *args):
    with pytest.raises(Exception) as e:
        fn(*args)
    return e


@pytest.mark.parametrize("guard", ["code_range_check", "scaled_bound_check",
                                   "checkify_call"])
def test_guards_trip_and_pass_as_the_reference(guard):
    """Each envelope guard trips with the reference's message (a
    ``ValueError``, as the reference's ``JaxRuntimeError`` is) and passes
    inside its envelope; ``checkify_call`` defers the verdicts until its
    function returns, raises the first that tripped, and returns the
    function's output when none did."""
    edge = np.arange(-128, 128)
    if guard == "code_range_check":
        cases = [(np.array([3, 128]), 8, "kv codes"),
                 (np.array([-129]), 8, "codes")]
        for codes, wl, what in cases:
            want = _trip(j_guards.code_range_check, jnp.asarray(codes), wl,
                         what)
            got = _trip(t_guards.code_range_check, torch.from_numpy(codes),
                        wl, what)
            assert got.type is t_guards.GuardError
            assert isinstance(got.value, ValueError)
            assert str(got.value) == str(want.value)
        t_guards.code_range_check(torch.from_numpy(edge), 8)
    elif guard == "scaled_bound_check":
        want = _trip(j_guards.scaled_bound_check, jnp.asarray([1, -200]),
                     100)
        got = _trip(t_guards.scaled_bound_check, torch.tensor([1, -200]),
                    100)
        assert str(got.value) == str(want.value)
        t_guards.scaled_bound_check(torch.tensor([1, -100]), 100)
    else:
        def body(check, codes, acc):
            check.code_range_check(codes, 8)
            check.scaled_bound_check(acc, 100)
            return codes * 2
        ran = []

        def t_body(codes, acc):
            out = body(t_guards, codes, acc)
            ran.append(True)          # the function ran to its end
            return out
        bad_codes, bad_acc = np.array([1, 200]), np.array([1, -200])
        for codes, acc in ((bad_codes, bad_acc), (edge, bad_acc)):
            want = _trip(j_guards.checkify_call,
                         lambda c, a: body(j_guards, c, a),
                         jnp.asarray(codes), jnp.asarray(acc))
            got = _trip(t_guards.checkify_call, t_body,
                        torch.from_numpy(codes), torch.from_numpy(acc))
            assert str(got.value) == str(want.value)
        assert ran == [True, True]
        out = t_guards.checkify_call(t_body, torch.from_numpy(edge),
                                     torch.tensor([100]))
        assert torch.equal(out, torch.from_numpy(edge) * 2)
