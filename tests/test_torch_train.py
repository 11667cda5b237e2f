"""The port's trainer against the JAX package's, on reduced qwen2 with the
reference's ``lm_init`` weights carried across through numpy.

* ``lm_loss`` and its gradients for the two training settings the chip
  runs: T1, bitexact bbm0 WL 16 VBL 13 on the MLPs and attention with
  flash attention (the flash-amm path), and T2, amm off with flash
  attention (the exact flash path), both against JAX's unsharded
  ``loss_and_grads`` (the reference's ``make_train_step`` fails under
  jax 0.9.0, ROADMAP C2).  jax.grad cannot pass through the interpreted
  exact-flash ``pallas_call`` (ROADMAP C8), so T2's reference is its
  chunked path, whose gradient is the same function's;
* ``apply_updates`` (AdamW and Adafactor) from the same ``OptState``;
* ``global_batch`` bit for bit;
* checkpoints (save, restore, the newest complete step, gc) and the
  loop's resume and retry.

Tolerances.  The forward keeps the reference's bf16 residual stream: a
last-place difference upstream (f32 sums in another order) can flip one
bf16 rounding, 2^-8 of an element, and the flips add up over the layers.
The loss, a mean over many tokens, is held to 2^-12 of its value; each
gradient leaf to 2^-5 of its largest element (a flipped residual element
moves the gradients of everything downstream of it).  The optimizer is
f32 elementwise on equal inputs, with the clipping norm summed in
another order: 2^-20 of each leaf's largest element.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get
from repro.configs import reduced as j_reduced
from repro.configs.base import AmmConfig as JAmm
from repro.data import pipeline as j_pipe
from repro.models import ModelRuntime as JRT
from repro.models import lm_init as j_init
from repro.train import optimizer as j_opt
from repro.train import trainstep as j_step
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.core import prng
from repro_torch.data import pipeline as t_pipe
from repro_torch.models import ModelRuntime as TRT
from repro_torch.models import lm_init as t_init
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import optimizer as t_opt
from repro_torch.train import trainstep as t_step
from repro_torch.train.loop import LoopConfig, train_loop

pytest_plugins = ["port_first"]

LOSS_RTOL = 2.0 ** -12
GRAD_RTOL = 2.0 ** -5
OPT_RTOL = 2.0 ** -20
T1 = dict(mode="bitexact", mul="bbm0", wl=16, param=13, apply_to="all")
T2 = dict(mode="off", mul="bbm0", wl=16, param=13, apply_to="mlp")


def _cfgs(**amm):
    j = dataclasses.replace(j_reduced(j_get("qwen2-0.5b")), amm=JAmm(**amm))
    t = dataclasses.replace(t_reduced(t_get("qwen2-0.5b")), amm=TAmm(**amm))
    return j, t


@pytest.fixture(scope="module")
def params():
    j_cfg, _ = _cfgs(**T2)
    jp = j_init(j_cfg, jax.random.key(0))
    return jp, jax.tree.map(np.asarray, jp)


def _batch(cfg, batch=2, seq=136):
    dc = j_pipe.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    return j_pipe.global_batch(dc, 0)


def _leaves(tree):
    return t_opt.tree_leaves(tree)


@pytest.mark.parametrize("setting,microbatches",
                         [("T1", 1), ("T2", 1), ("T1", 2)])
def test_loss_and_grads_match_jax(params, setting, microbatches):
    amm = T1 if setting == "T1" else T2
    j_cfg, t_cfg = _cfgs(**amm)
    jp, npp = params
    toks, labels = _batch(t_cfg)
    # T2's reference runs the chunked path (no gradient through the
    # interpreted exact-flash pallas_call); T1's runs flash-amm, whose
    # custom_vjp is the straight-through chunked gradient
    j_rt = JRT.build(j_cfg, use_pallas=setting == "T1")
    t_rt = TRT.build(t_cfg, use_pallas=True)
    j_loss, j_grads, _ = j_step.loss_and_grads(
        jp, j_cfg, j_rt, jnp.asarray(toks), jnp.asarray(labels),
        jax.random.key(1), microbatches=microbatches)
    tp = lm_params_from_numpy(npp, device="cpu")
    t_loss, t_grads, metrics = t_step.loss_and_grads(
        tp, t_cfg, t_rt, torch.from_numpy(toks), torch.from_numpy(labels),
        prng.key(1), microbatches=microbatches)
    j_loss = float(j_loss)
    assert abs(float(t_loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    assert np.isfinite(float(metrics["ce"]))
    want = jax.tree.leaves(j_grads)
    got = _leaves(t_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        err = np.abs(g.double().numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (err, np.abs(w).max())


def test_flash_and_chunked_paths_agree_in_the_port(params):
    """The port's flash routes compute the chunked routes' losses (T1
    bitexact: at the flash tiles; T2 exact)."""
    _, npp = params
    for amm in (T1, T2):
        _, t_cfg = _cfgs(**amm)
        toks, labels = _batch(t_cfg, seq=40)
        tp = lm_params_from_numpy(npp, device="cpu")
        from repro_torch.models import lm_loss
        flash, _ = lm_loss(tp, t_cfg, TRT.build(t_cfg, use_pallas=True),
                           torch.from_numpy(toks), torch.from_numpy(labels))
        chunk, _ = lm_loss(tp, t_cfg, TRT.build(t_cfg),
                           torch.from_numpy(toks), torch.from_numpy(labels))
        assert abs(float(flash) - float(chunk)) <= LOSS_RTOL * float(chunk)


# --------------------------------------------------------------- optimizer
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((6,)).astype(np.float32),
                  "d": rng.standard_normal((7, 2)).astype(np.float32)}}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_updates_match_jax(kind):
    kw = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=10,
              clip_norm=0.5)
    j_cfg, t_cfg = j_opt.OptConfig(**kw), t_opt.OptConfig(**kw)
    p, g1, g2 = _tree(0), _tree(1), _tree(2)
    jp = jax.tree.map(jnp.asarray, p)
    js = j_opt.init_opt(jp, j_cfg)
    # one step in JAX, carry its state across, then one step in each
    jp, js, _ = j_opt.apply_updates(jp, jax.tree.map(jnp.asarray, g1), js,
                                    j_cfg)
    tp = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict)
              else {kk: torch.from_numpy(np.array(vv))
                    for kk, vv in v.items()}) for k, v in jp.items()}
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jp, js, jm = j_opt.apply_updates(jp, jax.tree.map(jnp.asarray, g2), js,
                                     j_cfg)
    tg = {k: (torch.from_numpy(v) if not isinstance(v, dict)
              else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in g2.items()}
    tp, ts, tm = t_opt.apply_updates(tp, tg, ts, t_cfg)
    assert int(ts.step) == int(js.step) == 2
    for name in ("lr", "gnorm"):
        assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-6)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for g, w in zip(_leaves(got), jax.tree.leaves(w_ := want)):
            w = np.asarray(w, np.float64)
            assert np.abs(g.double().numpy() - w).max() \
                <= OPT_RTOL * max(np.abs(w).max(), 1e-30), w_.keys()


def test_schedule_and_norms_match_jax():
    cfg_kw = dict(lr=3e-4, warmup_steps=5, total_steps=20)
    j_s = j_opt.warmup_cosine(j_opt.OptConfig(**cfg_kw))
    t_s = t_opt.warmup_cosine(t_opt.OptConfig(**cfg_kw))
    for step in (0, 1, 4, 5, 6, 13, 20, 25):
        assert float(t_s(torch.tensor(step, dtype=torch.int32))) \
            == pytest.approx(float(j_s(jnp.int32(step))), rel=1e-6)
    g = _tree(3)
    tg = jax.tree.map(torch.from_numpy, g)
    assert float(t_opt.global_norm(tg)) == pytest.approx(
        float(j_opt.global_norm(jax.tree.map(jnp.asarray, g))), rel=1e-6)
    clipped, gn = t_opt.clip_by_global_norm(tg, 1.0)
    assert float(t_opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("step", [0, 3, 17])
def test_global_batch_bitwise(step):
    kw = dict(vocab=151936, seq_len=64, global_batch=4, seed=5)
    jt, jl = j_pipe.global_batch(j_pipe.DataConfig(**kw), step)
    tt, tl = t_pipe.global_batch(t_pipe.DataConfig(**kw), step)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    jit = j_pipe.batches(j_pipe.DataConfig(**kw), step, host_id=1,
                         n_hosts=2)
    tit = t_pipe.batches(t_pipe.DataConfig(**kw), step, host_id=1,
                         n_hosts=2)
    for (a, b, s), (c, d, u) in zip([next(jit)], [next(tit)]):
        np.testing.assert_array_equal(a, c)
        assert s == u == step


# ------------------------------------------------------------- checkpoints
def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((3, 4), generator=g),
              "h": torch.randn((5,), generator=g).to(torch.bfloat16)}
    opt = t_opt.init_opt(params, t_opt.OptConfig(kind="adafactor"))
    return {"params": params, "opt": opt}


def test_checkpoint_roundtrip_latest_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    state = _state()
    for step in range(5):
        t_ckpt.save(state, step, d, keep=3)
    assert sorted(os.listdir(d)) == [f"step_{s:09d}" for s in (2, 3, 4)]
    # an incomplete newer step (no manifest) is not restored
    os.makedirs(os.path.join(d, f"step_{9:09d}"))
    with open(os.path.join(d, f"step_{9:09d}", "leaf_00000.npy"), "w"):
        pass
    assert t_ckpt.latest_step(d) == 4
    got, step = t_ckpt.restore(_state(seed=1), d)
    assert step == 4
    want = t_opt.tree_leaves(state)
    back = t_opt.tree_leaves(got)
    assert len(back) == len(want)
    for a, b in zip(back, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(got["opt"], t_opt.OptState)
    with open(os.path.join(d, f"step_{4:09d}", "MANIFEST.json")) as f:
        assert json.load(f)["dtypes"][0] == "int32"
    assert t_ckpt.restore(state, str(tmp_path / "none")) == (None, None)
    t_ckpt.save_async(state, 7, d)
    t_ckpt.wait_pending()
    assert t_ckpt.latest_step(d) == 7
    with pytest.raises(ValueError, match="leaves"):
        t_ckpt.restore({"params": state["params"]}, d)


def _toy_loop(tmp_path, total, fail_at=None, ckpt_every=2):
    """A loop over a pure step: params w += step + sum(tokens), with the
    reference's data pipeline; returns (final w, history, log)."""
    dc = t_pipe.DataConfig(vocab=50, seq_len=8, global_batch=2)

    def data_iter(start):
        for toks, labels, step in t_pipe.batches(dc, start):
            yield torch.from_numpy(toks), torch.from_numpy(labels), step

    def step_fn(p, o, toks, labels, key):
        w = p["w"] + float(toks.sum()) + key[1] % 7
        return {"w": w}, o, {"loss": w.sum()}

    failed = []

    def hook(step):
        if step == fail_at and not failed:
            failed.append(step)
            raise RuntimeError("injected node failure")
    log = []
    params = {"w": torch.zeros(3)}
    opt = t_opt.init_opt(params, t_opt.OptConfig())
    lc = LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                    ckpt_dir=str(tmp_path / "loop"), log_every=1)
    p, _, hist = train_loop(step_fn, params, opt, data_iter, lc,
                            rng=prng.key(42), failure_hook=hook,
                            log_fn=log.append)
    return p["w"], hist, log


def test_loop_recovers_from_injected_failure(tmp_path):
    clean, _, _ = _toy_loop(tmp_path / "a", 6)
    got, hist, log = _toy_loop(tmp_path / "b", 6, fail_at=3)
    assert torch.equal(got, clean)
    assert any("failed" in line for line in log)
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 5]


def test_loop_resumes_from_checkpoint(tmp_path):
    full, _, _ = _toy_loop(tmp_path / "a", 6)
    _toy_loop(tmp_path / "b", 4)
    got, hist, log = _toy_loop(tmp_path / "b", 6)
    assert any("resumed from checkpoint step 3" in line for line in log)
    assert [h["step"] for h in hist] == [4, 5]
    assert torch.equal(got, full)


def test_loop_keys_are_the_references():
    """Each step's key, ``fold_in(key(42), step)``, and the per-layer
    noise seeds ``lm_apply`` draws from it, equal to JAX's."""
    k = prng.key(42)
    for step in (0, 1, 9):
        jkey = jax.random.fold_in(jax.random.key(42), step)
        want = np.asarray(jax.random.key_data(jkey))
        assert prng.fold_in(k, step) == tuple(int(x) for x in want)
        seeds = []
        for _ in range(3):
            jkey, sub = jax.random.split(jkey)
            seeds.append(int(jax.random.randint(sub, (), 0, 2 ** 31 - 1,
                                                jnp.int32)))
        assert list(prng.layer_seeds(prng.fold_in(k, step), 3)) == seeds


# ---------------------------------------------------------------- launcher
def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as t_launch
    argv = ["--reduced", "--device", "cpu", "--amm", "bitexact",
            "--amm-attn", "--flash-attn", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "ck")]
    hist = t_launch.main(argv + ["--steps", "2"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    hist = t_launch.main(argv + ["--steps", "3"])
    assert [h["step"] for h in hist] == [2]
    assert "resumed from checkpoint step 1" in capsys.readouterr().out


@pytest.mark.parametrize("flags,err", [
    (["--mesh-data", "2"], NotImplementedError),
    (["--mesh-model", "4"], NotImplementedError),
    (["--amm-attn", "attn"], SystemExit),
    (["--amm", "noise", "--wl", "18"], SystemExit),
])
def test_launcher_refuses_what_it_cannot_run(flags, err, tmp_path):
    from repro_torch.launch import train as t_launch
    with pytest.raises(err, match="A13" if err is NotImplementedError
                       else None):
        t_launch.main(["--reduced", "--device", "cpu", "--steps", "1",
                       "--ckpt-dir", str(tmp_path)] + flags)


def test_port_params_init_on_the_requested_device():
    _, t_cfg = _cfgs(**T1)
    p = t_init(t_cfg, 0, device="cpu")
    assert all(x.device.type == "cpu" for x in _leaves(p))
