"""The port's encoder-decoder family (whisper-base) against the JAX
package's, on ``reduced(whisper-base)``: 2 encoder and 2 decoder layers,
d_model 64, ``encoder_len`` 32.

Weights are drawn in numpy from a fixed seed (the reference's
``lm_table`` gives the shapes and inits; the attention's query and key
projections are scaled up so that the softmax is far from uniform) and
handed to both sides through ``convert.lm_params_from_numpy``; the frame
embeddings are seeded normal draws in numpy.

Covered: ``lm_apply`` in train mode in every amm mode the family runs,
``make_serve_fns``' prefill and decode with the ``k``, ``v``, ``xk`` and
``xv`` leaves, ``lm_loss`` and its gradients (the encoder's included),
``loss_and_grads`` with microbatches, the launcher's zero embeddings,
two steps of the training launcher, the reference's quirks the port
copies (ROADMAP C13-C16), the refusals, the flash kernels' plain versions
at Sq != Skv, and the converter's encoder subtree.

Tolerances.  Logits within 2^-6 of their largest magnitude and cache
leaves within 2^-6 of theirs: the bf16 residual stream, where a
last-place difference upstream flips a bf16 rounding (2^-8 of an
element), as in ``tests/test_torch_lm.py``.  The loss within 2^-12 of its
value and each gradient leaf within 2^-5 of its largest element, as in
``tests/test_torch_train.py``.  The noise cases run at WL 8 / VBL 5,
where the noise moves the logits by far more than the tolerance, so
they hold the noise draws and keys themselves.  Where the reference
promises bits (an all-zero encoder, the cross cache nothing reads), the
comparison is bit for bit.
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
from repro.data import pipeline as j_pipe
from repro.kernels import ops as j_ops
from repro.models import attention as j_attn
from repro.models import ModelRuntime as JRT
from repro.models import init_cache as j_cache
from repro.models import lm_amm_planes as j_planes
from repro.models import lm_apply as j_apply
from repro.models import lm_init as j_init
from repro.models import lm_table as j_table
from repro.serve import engine as j_engine
from repro.serve import kv_cache as j_kv
from repro.train import optimizer as j_opt
from repro.train import trainstep as j_step
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import prng
from repro_torch.launch import serve as t_serve_launch
from repro_torch.launch import train as t_train_launch
from repro_torch.models import ModelRuntime as TRT
from repro_torch.models import attention as t_attn
from repro_torch.models import init_cache as t_cache
from repro_torch.models import lm_apply as t_apply
from repro_torch.models import lm_loss as t_loss
from repro_torch.models import lm_table as t_table
from repro_torch.models import transformer as t_tr
from repro_torch.serve import engine as t_engine
from repro_torch.serve import kv_cache as t_kv
from repro_torch.train import optimizer as t_opt
from repro_torch.train import trainstep as t_step
from torch_amm_capture import chunked_residuals, port_amm_dot_records
from torch_moe_routes import numpy_params

pytest_plugins = ["port_first"]

tf = importlib.import_module("repro_torch.kernels.flash_attention")

ARCH = "whisper-base"
LOGIT_RTOL = 2.0 ** -6
LOSS_RTOL = 2.0 ** -12
GRAD_RTOL = 2.0 ** -5
BASE = dict(mul="bbm0", wl=16, param=13)
NOISE8 = dict(mul="bbm0", wl=8, param=5, mode="noise")
AMMS = {"off": dict(BASE, mode="off"),
        "noise": NOISE8,
        "noise_fused": dict(NOISE8, use_pallas=True),
        "bitexact": dict(BASE, mode="bitexact", apply_to="all"),
        "bitexact8": dict(NOISE8, mode="bitexact", apply_to="all")}
B, S, MAX_LEN, DECODES = 2, 12, 24, 4
QK_SCALE = 4.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(amm=None):
    j_cfg, t_cfg = j_reduced(j_get(ARCH)), t_reduced(t_get(ARCH))
    if amm is not None:
        j_cfg = dataclasses.replace(j_cfg, amm=JAmm(**amm))
        t_cfg = dataclasses.replace(t_cfg, amm=TAmm(**amm))
    return j_cfg, t_cfg


def _tree(seed=0):
    """numpy weights of reduced whisper-base, every ``wq`` and ``wk``
    (self- and cross-attention, encoder and decoder) scaled up."""
    j_cfg, _ = _cfgs()
    tree = numpy_params(j_table(j_cfg), seed=seed)

    def scale(t):
        for k, v in t.items():
            if isinstance(v, dict):
                scale(v)
            elif k in ("wq", "wk"):
                t[k] = v * np.float32(QK_SCALE)
    scale(tree)
    return tree


_WEIGHTS = {}


def _weights():
    if not _WEIGHTS:
        tree = _tree()
        _WEIGHTS["w"] = (jax.tree.map(jnp.asarray, tree),
                         lm_params_from_numpy(tree, device="cpu"))
    return _WEIGHTS["w"]


def _embeds(seed=7, b=B):
    _, t_cfg = _cfgs()
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t_cfg.encoder_len, t_cfg.d_model)) \
        .astype(np.float32)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (B, S)).astype(np.int32),
            rng.integers(0, 512, (DECODES, B, 1)).astype(np.int32))


def _close(got, want, rtol=LOGIT_RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _rts(j_cfg, t_cfg, use_pallas=False):
    return (JRT.build(j_cfg, use_pallas=use_pallas),
            TRT.build(t_cfg, use_pallas=use_pallas, device="cpu"))


# ------------------------------------------------------------- lm_apply
@pytest.mark.parametrize("amm", ["off", "noise", "noise_fused", "bitexact"])
def test_lm_apply_matches_the_reference(amm):
    """Train mode, the encoder over seeded embeddings: the plain noise
    branch, the fused kernel's plain version and bitexact with
    apply_to="all" (every attention product, the cross-attention's
    included, on the amm datapath, the weights precoded in the call)."""
    j_cfg, t_cfg = _cfgs(AMMS[amm])
    jp, tp = _weights()
    j_rt, t_rt = _rts(j_cfg, t_cfg)
    toks, _ = _tokens()
    enc = _embeds()
    want = jax.jit(lambda p, t, e: j_apply(p, j_cfg, j_rt, t,
                                           encoder_embeds=e)[0])(
        jp, jnp.asarray(toks), jnp.asarray(enc))
    got = t_apply(tp, t_cfg, t_rt, torch.from_numpy(toks),
                  encoder_embeds=torch.from_numpy(enc))[0]
    _close(got.numpy(), want)
    if amm == "noise":
        # the noise is far above the tolerance: these logits hold it
        _, off_cfg = _cfgs(AMMS["off"])
        off = t_apply(tp, off_cfg, TRT.build(off_cfg, device="cpu"),
                      torch.from_numpy(toks),
                      encoder_embeds=torch.from_numpy(enc))[0]
        assert float((off - got).abs().max()) > 8 * LOGIT_RTOL * float(
            got.abs().max())


def test_no_weight_planes_for_the_family():
    """bitexact caches no weight planes for an encoder-decoder model, on
    either side: its MLPs precode their weights in every call."""
    j_cfg, t_cfg = _cfgs(AMMS["bitexact"])
    jp, tp = _weights()
    j_rt, t_rt = _rts(j_cfg, t_cfg)
    assert j_planes(j_cfg, j_rt.amm, jp) is None
    assert t_rt.build_planes(t_cfg, tp) is None


# -------------------------------------------------------------- serving
_SERVE_FNS = {}


def _reference_serve(amm, jp, toks, nxt, enc, caches=None):
    """The bodies of the reference's ``make_serve_fns`` (its sharded
    wrapper fails under jax 0.9.0, ROADMAP C7), jitted once per amm mode:
    a prefill of ``toks`` then one decode per row of ``nxt``, every call
    given ``enc``."""
    j_cfg, _ = _cfgs(AMMS[amm])
    if amm not in _SERVE_FNS:
        j_rt = JRT.build(j_cfg)

        @jax.jit
        def run(p, t, n, e, c):
            lg, _, c = j_apply(p, j_cfg, j_rt, t, mode="decode", caches=c,
                               pos=jnp.int32(0), encoder_embeds=e)
            out = [lg[:, -1]]
            for i in range(n.shape[0]):
                lg, _, c = j_apply(p, j_cfg, j_rt, n[i], mode="decode",
                                   caches=c, pos=jnp.int32(S + i),
                                   encoder_embeds=e)
                out.append(lg[:, -1])
            return out, c
        _SERVE_FNS[amm] = run
    if caches is None:
        caches = j_cache(j_cfg, B, MAX_LEN)
    return _SERVE_FNS[amm](jp, jnp.asarray(toks), jnp.asarray(nxt),
                           jnp.asarray(enc), caches)


def _port_serve(t_cfg, t_rt, tp, toks, nxt, enc, caches=None):
    prefill, decode = t_engine.make_serve_fns(t_cfg, t_rt)
    c = caches if caches is not None else t_cache(t_cfg, B, MAX_LEN,
                                                  device="cpu")
    e = torch.from_numpy(enc)
    lg, c = prefill(tp, torch.from_numpy(toks), c, e)
    out = [lg]
    for i in range(nxt.shape[0]):
        lg, c = decode(tp, torch.from_numpy(nxt[i]), c, S + i, e)
        out.append(lg)
    return out, c


def test_serve_fns_match_the_reference():
    """A prefill of 12 tokens and 4 decode calls through
    ``make_serve_fns``, the embeddings passed to every call: the logits
    of each call and the four cache leaves after the last.  Exact: the
    noise and bitexact datapaths' serving calls are the train mode's
    products at other lengths (above) and the cross-attention's one-row
    route is held below; the reference's compile of five of them would
    cost more than this file's whole budget."""
    amm = "off"
    j_cfg, t_cfg = _cfgs(AMMS[amm])
    jp, tp = _weights()
    _, t_rt = _rts(j_cfg, t_cfg)
    toks, nxt = _tokens()
    enc = _embeds()
    want, j_c = _reference_serve(amm, jp, toks, nxt, enc)
    got, c = _port_serve(t_cfg, t_rt, tp, toks, nxt, enc)
    assert len(got) == len(want) == 1 + DECODES
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert sorted(c) == sorted(j_c) == ["k", "v", "xk", "xv"]
    for k in c:
        assert tuple(c[k].shape) == j_c[k].shape, k
        assert c[k].dtype == torch.bfloat16 and j_c[k].dtype == jnp.bfloat16
        _close(c[k].float().numpy(), np.asarray(j_c[k], np.float32))
    # the self-attention cache holds the 16 written positions only
    assert not c["k"][:, :, S + DECODES:].any()
    assert t_engine.cache_logical_axes(t_cfg) == {
        k: tuple(v) for k, v in j_engine.cache_logical_axes(j_cfg).items()}


# ------------------------------------------------------------- training
_GRAD_FNS = {}


def _j_loss_and_grads(amm, microbatches):
    """The reference's unsharded ``loss_and_grads`` jitted, once per amm
    mode and microbatch count (the launcher's test reuses the compile)."""
    if (amm, microbatches) not in _GRAD_FNS:
        j_cfg, _ = _cfgs(AMMS[amm])
        j_rt = JRT.build(j_cfg)
        _GRAD_FNS[amm, microbatches] = jax.jit(
            lambda p, t, l, k, e: j_step.loss_and_grads(
                p, j_cfg, j_rt, t, l, k, microbatches=microbatches,
                encoder_embeds=e))
    return _GRAD_FNS[amm, microbatches]


def _batch(cfg, batch=B, seq=16, step=0):
    dc = j_pipe.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    return j_pipe.global_batch(dc, step)


def _hold_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        err = np.abs(g.double().numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (err, np.abs(w).max())


@pytest.mark.parametrize("amm,microbatches", [("off", 1), ("bitexact8", 2)])
def test_loss_and_grads_match_the_reference(amm, microbatches):
    """``loss_and_grads`` (``lm_loss`` and autograd) against the
    reference's unsharded one: the loss and every gradient leaf, the
    encoder's included.  With 2 microbatches each takes its slice of the
    embeddings: the first the launcher's zeros (an all-zero encoder, its
    tiles at the quantizer's floor scale), the second seeded ones.
    Bitexact at WL 8 / VBL 5, which moves the loss far more than WL 16
    and compiles in half the time on the reference's side."""
    j_cfg, t_cfg = _cfgs(AMMS[amm])
    jp, tp = _weights()
    j_rt, t_rt = _rts(j_cfg, t_cfg)
    toks, labels = _batch(t_cfg)
    enc = _embeds(seed=11)
    if microbatches == 2:
        enc[:B // 2] = 0.0
    j_l, j_g, _ = _j_loss_and_grads(amm, microbatches)(
        jp, jnp.asarray(toks), jnp.asarray(labels), jax.random.key(1),
        jnp.asarray(enc))
    t_l, t_g, metrics = t_step.loss_and_grads(
        tp, t_cfg, t_rt, torch.from_numpy(toks), torch.from_numpy(labels),
        prng.key(1), microbatches=microbatches,
        encoder_embeds=torch.from_numpy(enc))
    j_l = float(j_l)
    assert abs(float(t_l) - j_l) <= LOSS_RTOL * abs(j_l)
    assert np.isfinite(float(metrics["ce"]))
    _hold_grads(t_opt.tree_leaves(t_g), jax.tree.leaves(j_g))
    assert all(float(g.abs().max()) > 0
               for g in t_opt.tree_leaves(t_g["encoder"]))


def test_zero_embeddings_zero_the_encoder():
    """The launcher's zero embeddings through bitexact WL 16 with
    apply_to="all": rmsnorm of 0 is 0, so every encoder product has all-
    zero operands (tiles at the quantizer's 1e-12 floor scale) and comes
    out exactly 0; the cross keys and values written to the cache are 0
    bit for bit, and so is every encoder gradient, the exact products'
    and the straight-through sums' alike."""
    _, t_cfg = _cfgs(AMMS["bitexact"])
    _, tp = _weights()
    t_rt = TRT.build(t_cfg, use_pallas=True, device="cpu")
    zeros = torch.zeros((B, t_cfg.encoder_len, t_cfg.d_model))
    toks, labels = (torch.from_numpy(a) for a in _batch(t_cfg))
    out = t_tr._encoder(tp["encoder"], zeros, t_cfg, t_rt, 0, B,
                        torch.bfloat16)
    assert out.dtype == torch.float32 and not out.any()
    cache = t_cache(t_cfg, B, MAX_LEN, device="cpu")
    cache["xk"].fill_(1.0)
    cache["xv"].fill_(1.0)
    prefill, _ = t_engine.make_serve_fns(t_cfg, t_rt)
    lg, cache = prefill(tp, toks[:, :S], cache, zeros)
    assert torch.isfinite(lg).all()
    assert not cache["xk"].any() and not cache["xv"].any()
    loss, grads, _ = t_step.loss_and_grads(tp, t_cfg, t_rt, toks, labels,
                                           prng.key(1), encoder_embeds=zeros)
    assert np.isfinite(float(loss))
    assert not any(bool(g.any()) for g in t_opt.tree_leaves(
        grads["encoder"]))
    assert float(grads["layers"]["xattn"]["wq"].abs().max()) == 0.0
    assert float(grads["layers"]["attn"]["wq"].abs().max()) > 0


def test_flash_and_chunked_paths_agree_in_the_port():
    """With ``use_pallas`` the encoder's and the decoder's self-attention
    run on the flash routes (the cross-attention stays chunked: ROADMAP
    C16); the losses equal the chunked path's within the loss tolerance,
    exact and bitexact."""
    jp, tp = _weights()
    enc = torch.from_numpy(_embeds())
    for amm in ("off", "bitexact"):
        _, t_cfg = _cfgs(AMMS[amm])
        toks, labels = (torch.from_numpy(a) for a in _batch(t_cfg, seq=24))
        flash, _ = t_loss(tp, t_cfg, TRT.build(t_cfg, use_pallas=True),
                          toks, labels, encoder_embeds=enc)
        chunk, _ = t_loss(tp, t_cfg, TRT.build(t_cfg), toks, labels,
                          encoder_embeds=enc)
        assert abs(float(flash) - float(chunk)) <= LOSS_RTOL * float(chunk)


def test_launcher_losses_match_the_reference(tmp_path, monkeypatch):
    """Two steps of ``launch.train --arch whisper-base --reduced`` on the
    CPU, fed the reference launcher's zero embeddings,
    from the reference launcher's initial weights (``lm_init`` at key 0),
    against the reference launcher's steps run unsharded (its sharded
    step fails under jax 0.9.0, ROADMAP C2): the same batches, keys
    ``fold_in(key(42), step)`` and AdamW updates."""
    steps, batch, seq = 2, 2, 16
    j_cfg, t_cfg = _cfgs(AMMS["off"])
    jp = j_init(j_cfg, jax.random.key(0))
    npp = jax.tree.map(np.asarray, jp)
    monkeypatch.setattr(t_train_launch, "lm_init",
                        lambda cfg, seed, **kw: lm_params_from_numpy(
                            npp, device="cpu"))
    hist = t_train_launch.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
        str(steps), "--batch", str(batch), "--seq", str(seq), "--ckpt-dir",
        str(tmp_path / "ck")])
    oc = j_opt.OptConfig(lr=3e-4, total_steps=steps)
    opt = j_opt.init_opt(jp, oc)
    lg = _j_loss_and_grads("off", 1)
    upd = jax.jit(lambda p, g, o: j_opt.apply_updates(p, g, o, oc))
    zeros = jnp.zeros((batch, j_cfg.encoder_len, j_cfg.d_model), jnp.float32)
    want = []
    for step in range(steps):
        toks, labels = _batch(j_cfg, batch, seq, step)
        loss, grads, _ = lg(jp, jnp.asarray(toks), jnp.asarray(labels),
                            jax.random.fold_in(jax.random.key(42), step),
                            zeros)
        jp, opt, _ = upd(jp, grads, opt)
        want.append(float(loss))
    assert [h["step"] for h in hist] == list(range(steps))
    for h, w in zip(hist, want):
        assert abs(h["loss"] - w) <= LOSS_RTOL * abs(w), (h["loss"], w)


@pytest.mark.parametrize("amm", ["off", "bitexact"])
@pytest.mark.parametrize("sq", [1, S])
def test_cross_attention_routes_match_the_reference(sq, amm):
    """The decoder's cross-attention call (the encoder's keys and values
    given, not causal, no cache) against the reference's at the full
    encoder length: 1,500 keys in two KV blocks of 1,024, the second
    padded, for one query row (a decode call) and a prefill, exact and
    with both products on the amm datapath.  Exact attention is f32 on
    both sides in another summation order: 1e-5 of the largest output,
    as in ``tests/test_torch_lm.py``; on the amm datapath both sides
    quantize the same operands, and a P code that float rounding moves
    by one step moves the output by 2^-15 of a block's largest
    probability times |v|: 2^-10 of the largest output."""
    j_cfg, t_cfg = _cfgs(AMMS[amm])
    jp, tp = _weights()
    rng = np.random.default_rng(17)
    e, kvh, hd = 1500, t_cfg.n_kv_heads, t_cfg.resolved_head_dim
    x = rng.standard_normal((B, sq, t_cfg.d_model)).astype(np.float32)
    ek, ev = (rng.standard_normal((B, e, kvh, hd)).astype(np.float32)
              for _ in range(2))
    pos = (np.arange(sq, dtype=np.int32)[None, :] + S) * np.ones(
        (B, 1), np.int32)
    j_amm = JRT.build(j_cfg).amm if amm == "bitexact" else None
    t_amm = TRT.build(t_cfg).amm if amm == "bitexact" else None
    jx = jax.tree.map(lambda a: a[0], jp["layers"]["xattn"])
    want = jax.jit(lambda p, a, k, v, q: j_attn.attention(
        p, a, j_cfg, positions=q, kv=(k, v), causal=False, amm=j_amm)[0])(
        jx, *(jnp.asarray(a) for a in (x, ek, ev, pos)))
    tx = {k: v[0] for k, v in tp["layers"]["xattn"].items()}
    got = t_attn.attention(
        tx, torch.from_numpy(x), t_cfg, positions=torch.from_numpy(pos),
        kv=(torch.from_numpy(ek), torch.from_numpy(ev)), causal=False,
        amm=t_amm)[0]
    _close(got.numpy(), want, 1e-5 if amm == "off" else 2.0 ** -10)


# ------------------------------------------------- the reference's quirks
def test_c13_the_encoder_is_causal():
    """ROADMAP C13: the encoder's self-attention is causal on both sides,
    so a change to the last frame leaves every earlier position's cross
    keys and values (the ``xk``/``xv`` leaves, bf16 casts of the encoder
    output's projections) bit for bit as they were, and moves the last."""
    j_cfg, t_cfg = _cfgs(AMMS["off"])
    jp, tp = _weights()
    j_rt, t_rt = _rts(j_cfg, t_cfg)
    toks, nxt = _tokens()
    enc = _embeds()
    moved = enc.copy()
    moved[:, -1] += 1.0
    leaves = []
    for e in (enc, moved):
        _, j_c = _reference_serve("off", jp, toks, nxt[:0], e)
        _, c = _port_serve(t_cfg, t_rt, tp, toks, nxt[:0], e)
        leaves.append(({k: np.asarray(j_c[k], np.float32)
                        for k in ("xk", "xv")},
                       {k: c[k].float().numpy() for k in ("xk", "xv")}))
    for side in (0, 1):
        a, b = leaves[0][side], leaves[1][side]
        for k in ("xk", "xv"):
            assert_array_equal(a[k][:, :, :-1], b[k][:, :, :-1])
            assert np.abs(a[k][:, :, -1] - b[k][:, :, -1]).max() > 0


def test_c14_encoder_mlps_take_the_root_key(monkeypatch):
    """ROADMAP C14: every encoder layer's MLP takes the root key unsplit;
    the decoder's layers split the chain from the same root."""
    _, t_cfg = _cfgs(AMMS["noise"])
    _, tp = _weights()
    seen = []
    orig = t_tr.mlp_apply

    def spy(p, x, amm, key, **kw):
        seen.append(tuple(int(v) for v in key))
        return orig(p, x, amm, key, **kw)
    monkeypatch.setattr(t_tr, "mlp_apply", spy)
    t_apply(tp, t_cfg, TRT.build(t_cfg, device="cpu"),
            torch.zeros((1, 4), dtype=torch.int64),
            encoder_embeds=torch.from_numpy(_embeds(b=1)), rng=3)
    root = jax.random.key(3)
    want = [tuple(int(v) for v in jax.random.key_data(root))] \
        * t_cfg.n_encoder_layers
    rng = root
    for _ in range(t_cfg.n_layers):
        rng, sub = jax.random.split(rng)
        want.append(tuple(int(v) for v in jax.random.key_data(sub)))
    assert seen == want


def test_c15_every_call_recomputes_the_encoder():
    """ROADMAP C15: the cached cross keys and values are never read.  A
    decode call given other embeddings than its prefill serves those;
    garbage in the ``xk``/``xv`` leaves changes no logit bit, and every
    call overwrites them with its own values' casts, on both sides.
    Without embeddings the port raises ``ValueError`` where the
    reference asserts."""
    j_cfg, t_cfg = _cfgs(AMMS["off"])
    jp, tp = _weights()
    j_rt, t_rt = _rts(j_cfg, t_cfg)
    toks, nxt = _tokens()
    enc = _embeds()
    junk = np.random.default_rng(5).standard_normal(
        (t_cfg.n_layers, B, t_cfg.encoder_len, t_cfg.n_kv_heads,
         t_cfg.resolved_head_dim)).astype(np.float32)
    j_base = j_cache(j_cfg, B, MAX_LEN)
    j_junk = dict(j_base, xk=jnp.asarray(junk, jnp.bfloat16),
                  xv=jnp.asarray(-junk, jnp.bfloat16))
    t_junk = t_cache(t_cfg, B, MAX_LEN, device="cpu")
    t_junk["xk"].copy_(torch.from_numpy(junk))
    t_junk["xv"].copy_(torch.from_numpy(-junk))
    want, j_c = _reference_serve("off", jp, toks, nxt[:1], enc)
    want_j, j_cj = _reference_serve("off", jp, toks, nxt[:1], enc, j_junk)
    got, c = _port_serve(t_cfg, t_rt, tp, toks, nxt[:1], enc)
    got_j, cj = _port_serve(t_cfg, t_rt, tp, toks, nxt[:1], enc, t_junk)
    for a, b in zip(want, want_j):
        assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(got, got_j):
        assert torch.equal(a, b)
    for k in ("xk", "xv"):
        assert_array_equal(np.asarray(j_c[k], np.float32),
                           np.asarray(j_cj[k], np.float32))
        assert torch.equal(c[k], cj[k])
    # a decode call with other embeddings than its prefill serves them
    other = _embeds(seed=8)
    prefill, decode = t_engine.make_serve_fns(t_cfg, t_rt)
    cache = t_cache(t_cfg, B, MAX_LEN, device="cpu")
    prefill(tp, torch.from_numpy(toks), cache, torch.from_numpy(enc))
    snap = {k: v.clone() for k, v in cache.items()}
    lg_same, _ = decode(tp, torch.from_numpy(nxt[0]), cache, S,
                        torch.from_numpy(enc))
    xk_same = cache["xk"].clone()
    cache = snap
    lg_other, _ = decode(tp, torch.from_numpy(nxt[0]), cache, S,
                         torch.from_numpy(other))
    assert float((lg_same - lg_other).abs().max()) > 0
    assert not torch.equal(cache["xk"], xk_same)
    assert torch.equal(lg_same, got[1])
    with pytest.raises(ValueError, match="encoder_embeds"):
        t_apply(tp, t_cfg, t_rt, torch.from_numpy(toks))
    with pytest.raises(AssertionError):
        j_apply(jp, j_cfg, j_rt, jnp.asarray(toks))


def test_c16_cross_attention_takes_the_chunked_schedule(monkeypatch):
    """ROADMAP C16: the reference calls the cross-attention without
    ``use_pallas``, so with the flash kernels on, a forward launches them
    for the encoder's and the decoder's self-attention only (causal), and
    the cross-attention's products run on the chunked schedule."""
    _, t_cfg = _cfgs(AMMS["off"])
    _, tp = _weights()
    calls = []
    orig = t_attn._FlashExact.apply

    def spy(q, k, v, causal):
        calls.append((q.shape[2], k.shape[2], causal))
        return orig(q, k, v, causal)
    monkeypatch.setattr(t_attn._FlashExact, "apply", spy)
    t_apply(tp, t_cfg, TRT.build(t_cfg, use_pallas=True),
            torch.zeros((1, 8), dtype=torch.int64),
            encoder_embeds=torch.from_numpy(_embeds(b=1)))
    e = t_cfg.encoder_len
    assert calls == [(e, e, True)] * t_cfg.n_encoder_layers \
        + [(8, 8, True)] * t_cfg.n_layers


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("what", ["scheduler", "code_cache", "launcher"])
def test_the_family_is_refused_where_the_reference_cannot_serve_it(
        what, capsys):
    """The Scheduler (the reference's passes no embeddings), the int-code
    cache (as the reference's refuses it) and the serve launcher (the
    reference's reaches lm_apply's assert) refuse whisper-base."""
    j_cfg, t_cfg = _cfgs(AMMS["bitexact"])
    if what == "scheduler":
        _, tp = _weights()
        with pytest.raises(ValueError, match="make_serve_fns"):
            t_engine.Scheduler(t_cfg, TRT.build(t_cfg), tp, 2, 16,
                               device="cpu")
    elif what == "code_cache":
        with pytest.raises(ValueError, match="encoder-decoder"):
            t_kv.init_code_cache(t_cfg, 2, 16, wl=16, device="cpu")
        with pytest.raises(ValueError, match="encoder-decoder"):
            j_kv.init_code_cache(j_cfg, 2, 16, wl=16)
    else:
        with pytest.raises(SystemExit):
            t_serve_launch.main(["--arch", ARCH, "--reduced", "--device",
                                 "cpu"])
        assert "encoder-decoder" in capsys.readouterr().err


# ------------------------------------------- flash plain versions, Sq != Skv
def _qkv(sq, skv, d=16, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, sq, d)).astype(np.float32) * 2
    k = rng.standard_normal((1, 2, skv, d)).astype(np.float32) * 2
    v = rng.standard_normal((1, 2, skv, d)).astype(np.float32)
    return q, k, v


# the reduced cross shapes (12 queries and one against 32 keys) and a
# ragged key length (37 = 2 x 16 + 5 at the exact test's 16-key tiles,
# 150 = 128 + 22 at the amm kernel's 128, as 1500 = 11 x 128 + 92)
CROSS = [(12, 32), (1, 32)]


@pytest.mark.parametrize("sq,skv", CROSS + [(12, 37)])
def test_exact_flash_plain_matches_the_reference_at_cross_shapes(sq, skv):
    q, k, v = _qkv(sq, skv)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tf.flash_attention(tq, tk, tv, causal=False, bq=16, bk=16)
    want = j_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=False, bq=16, bk=16)
    tol = tf.flash_tolerance(tq, tk, tv).numpy()
    err = np.abs(got.double().numpy() - np.asarray(want, np.float64))
    assert (err <= tol).all(), (err.max(), tol.min())
    # and the port's attention routes the same cross call (kv given,
    # non-causal) through the flash wrapper and the chunked schedule alike
    chunk = t_attn.chunked_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                     tv.transpose(1, 2), causal=False)
    err = np.abs(chunk.transpose(1, 2).double().numpy() - got.double().numpy())
    assert (err <= tol).all()


@pytest.mark.parametrize("sq,skv", CROSS + [(12, 150)])
def test_amm_flash_plain_matches_the_chunked_path_at_cross_shapes(sq, skv):
    """The flash-amm plain version against the chunked schedule at the
    flash tiles, non-causal at Sq != Skv, held by ``flash_amm_compare``
    (the reference's Pallas flash-amm does not trace under jax 0.9.0,
    ROADMAP C1)."""
    q, k, v = _qkv(sq, skv)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    rt = TRT.build(_cfgs(AMMS["bitexact"])[1], device="cpu").amm
    flash, res = tf.flash_attention_amm(tq, tk, tv, wl=16, vbl=13, kind=0,
                                        causal=False, residuals=True)
    with port_amm_dot_records() as recs:
        chunked = t_attn.flash_amm_chunked_equiv(tq, tk, tv, rt,
                                                 causal=False)
    _, run, _ = chunked_residuals(recs, (1, sq, 2, 16, skv, 2),
                                  chunked.transpose(1, 2), wl=16,
                                  bq=tf.FLASH_AMM_BQ, bk=tf.FLASH_AMM_BK)
    ops = tf.flash_amm_operands(tq, tk, tv, wl=16)
    rep = tf.flash_amm_compare(
        ops, dict(res, out=flash.reshape(2, sq, 16)),
        dict(run, out=run["out"][:, :sq]), wl=16, vbl=13, causal=False)
    assert rep["ok"], rep


# ------------------------------------------------------------ converter
def test_converter_carries_the_encoder_and_the_cross_attention():
    """``lm_params_from_numpy`` keeps the reference's ``encoder`` subtree
    and each decoder layer's ``xattn``/``xattn_norm`` leaf for leaf, in
    the port's own ``lm_table`` shapes."""
    tree = _tree(seed=5)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = lm_params_from_numpy(tree, device="cpu")
    _, t_cfg = _cfgs()
    shapes = jax.tree.map(lambda s: tuple(s.shape), t_table(t_cfg),
                          is_leaf=lambda v: hasattr(v, "axes"))
    assert jax.tree.map(lambda v: tuple(v.shape), tp) == shapes
    assert jax.tree.structure(jax.tree.map(lambda v: 0, tp)) \
        == jax.tree.structure(jax.tree.map(lambda v: 0, jp))
    enc = tp["encoder"]
    assert enc["layers"]["attn"]["wq"].shape[0] == t_cfg.n_encoder_layers
    for (path, got), want in zip(
            jax.tree_util.tree_leaves_with_path(enc),
            jax.tree.leaves(jp["encoder"])):
        assert got.dtype == torch.float32, path
        assert_array_equal(got.numpy(), np.asarray(want))
    for k in ("wq", "wk", "wv", "wo"):
        assert_array_equal(tp["layers"]["xattn"][k].numpy(),
                           np.asarray(jp["layers"]["xattn"][k]))
    assert_array_equal(tp["layers"]["xattn_norm"].numpy(),
                       np.asarray(jp["layers"]["xattn_norm"]))
    assert not np.array_equal(tp["layers"]["xattn"]["wk"].numpy(),
                              tp["layers"]["attn"]["wk"].numpy())
