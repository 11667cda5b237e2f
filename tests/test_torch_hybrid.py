"""The port's SSM (mamba2), hybrid (zamba2) and VLM (chameleon) families
against the JAX package's, on ``reduced()`` configs: ``lm_apply``
cacheless and through the caches in the amm modes each family serves in,
``lm_amm_planes``' tree, the hybrid's noise keys, the continuous and
flush ``Scheduler``, the converter's nested tree, the launcher and the
registry.

Weights are drawn in numpy from fixed seeds (the reference's
``lm_table`` gives the shapes and inits; the Mamba2 leaves that init to
constants, ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b``, are drawn
too) and handed to both sides.

Tolerances.  Logits within 2^-6 of their largest magnitude: the bf16
residual stream of ``tests/test_torch_lm.py``.  Under the Scheduler the
port is teacher-forced on the reference's logits, as in
``tests/test_torch_scheduler.py``; its own greedy token must equal the
reference's wherever the reference's top-2 gap exceeds twice that.
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
from repro.models import init_cache as j_cache
from repro.models import lm_amm_planes as j_planes
from repro.models import lm_apply as j_apply
from repro.models import lm_table as j_table
from repro.serve import engine as j_engine
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import prng
from repro_torch.kernels.booth_rows import booth_precode
from repro_torch.launch import serve as t_launch
from repro_torch.models import ModelRuntime as TRT
from repro_torch.models import init_cache as t_cache
from repro_torch.models import lm_apply as t_apply
from repro_torch.models import lm_table as t_table
from repro_torch.serve import engine as t_engine
from torch_moe_routes import numpy_params

pytest_plugins = ["port_first"]

LOGIT_RTOL = 2.0 ** -6
BASE = dict(mul="bbm0", wl=16, param=13)
AMMS = {"off": dict(BASE, mode="off"),
        "noise": dict(BASE, mode="noise"),
        "noise_fused": dict(BASE, mode="noise", use_pallas=True),
        "bitexact": dict(BASE, mode="bitexact", apply_to="all")}
SSM, HYBRID, VLM = "mamba2-370m", "zamba2-2.7b", "chameleon-34b"
# two chunks of the reduced ssm_chunk 16, so the inter-chunk recurrence
# runs inside lm_apply
B, S, MAX_LEN, DECODES = 2, 32, 48, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, amm=None):
    j_cfg, t_cfg = j_reduced(j_get(arch)), t_reduced(t_get(arch))
    if amm is not None:
        j_cfg = dataclasses.replace(j_cfg, amm=JAmm(**amm))
        t_cfg = dataclasses.replace(t_cfg, amm=TAmm(**amm))
    return j_cfg, t_cfg


_DRAWN = {"a_log": 0.5, "dt_bias": 0.5, "d_skip": 1.0, "conv_b": 0.1}


def _tree(arch, seed=0):
    """numpy weights of reduced ``arch``, the Mamba2 constants drawn."""
    j_cfg, _ = _cfgs(arch)
    tree = numpy_params(j_table(j_cfg), seed=seed)
    rng = np.random.default_rng(seed + 100)

    def draw(t):
        for k, v in t.items():
            if isinstance(v, dict):
                draw(v)
            elif k in _DRAWN:
                t[k] = (v + rng.standard_normal(v.shape) * _DRAWN[k]).astype(
                    np.float32)
    draw(tree)
    return tree


_WEIGHTS = {}


def _weights(arch):
    if arch not in _WEIGHTS:
        tree = _tree(arch)
        _WEIGHTS[arch] = (jax.tree.map(jnp.asarray, tree),
                          lm_params_from_numpy(tree, device="cpu"))
    return _WEIGHTS[arch]


def _close(got, want, rtol=LOGIT_RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _tokens():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 512, (B, S)).astype(np.int32),
            rng.integers(0, 512, (DECODES, B, 1)).astype(np.int32))


def _planes(arch, amm_name, j_cfg, t_cfg, jp, tp):
    if AMMS[amm_name]["mode"] != "bitexact":
        return None, None
    amm = JRT.build(j_cfg).amm
    return (jax.jit(lambda p: j_planes(j_cfg, amm, p))(jp),
            TRT.build(t_cfg).build_planes(t_cfg, tp))


# (arch, amm, mode): each family cacheless ("train") and through its
# caches ("serve": a prefill of S tokens, then DECODES per-slot decode
# steps); zamba2 in every amm mode (its shared block's MLP on the plain
# noise branch, the fused kernel, and bitexact with apply_to="all", its
# attention products on the amm datapath, from precoded weight planes);
# chameleon (qk_norm) off and in noise mode.  mamba2 has no approximated
# product: its noise modes are held bit-equal to off below.
LM_CASES = [(SSM, "off", "train"), (SSM, "off", "serve"),
            (HYBRID, "off", "train"), (HYBRID, "off", "serve"),
            (HYBRID, "noise", "train"), (HYBRID, "noise_fused", "serve"),
            (HYBRID, "bitexact", "serve"),
            (VLM, "off", "serve"), (VLM, "noise", "train")]


@pytest.mark.parametrize("arch,amm,mode", LM_CASES,
                         ids=[f"{m}-{a}-{n}" for a, n, m in LM_CASES])
def test_lm_apply_matches_the_reference(arch, amm, mode):
    j_cfg, t_cfg = _cfgs(arch, AMMS[amm])
    jp, tp = _weights(arch)
    j_pl, t_pl = _planes(arch, amm, j_cfg, t_cfg, jp, tp)
    j_rt, t_rt = JRT.build(j_cfg), TRT.build(t_cfg, device="cpu")
    toks, nxt = _tokens()
    if mode == "train":
        want = [jax.jit(lambda p, t: j_apply(p, j_cfg, j_rt, t)[0])(
            jp, jnp.asarray(toks))]
        got = [t_apply(tp, t_cfg, t_rt, torch.from_numpy(toks))[0]]
    else:
        @jax.jit
        def ref(p, t, n):
            lg, _, c = j_apply(p, j_cfg, j_rt, t, mode="decode",
                               caches=j_cache(j_cfg, B, MAX_LEN),
                               pos=jnp.int32(0), amm_planes=j_pl)
            out = [lg]
            for i in range(DECODES):
                lg, _, c = j_apply(p, j_cfg, j_rt, n[i], mode="decode",
                                   caches=c, amm_planes=j_pl,
                                   pos=jnp.full((B,), S + i, jnp.int32))
                out.append(lg)
            return out, c
        want, j_c = ref(jp, jnp.asarray(toks), jnp.asarray(nxt))
        c = t_cache(t_cfg, B, MAX_LEN, device="cpu")
        lg, _, c = t_apply(tp, t_cfg, t_rt, torch.from_numpy(toks),
                           mode="decode", caches=c, pos=0, amm_planes=t_pl)
        got = [lg]
        for i in range(DECODES):
            lg, _, c = t_apply(tp, t_cfg, t_rt, torch.from_numpy(nxt[i]),
                               mode="decode", caches=c, amm_planes=t_pl,
                               pos=torch.full((B,), S + i))
            got.append(lg)
        assert sorted(c) == sorted(j_c)
        for k in c:
            assert c[k].shape == j_c[k].shape, k
            assert str(c[k].dtype).split(".")[-1] == str(j_c[k].dtype), k
        if "ssm" in c:
            _close(c["ssm"].numpy(), j_c["ssm"], 1e-3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_noise_leaves_mamba2_exact():
    """The SSM family has no amm product: every noise mode's logits are
    its off logits, bit for bit, on the port's side."""
    _, tp = _weights(SSM)
    toks = torch.from_numpy(_tokens()[0])
    outs = []
    for amm in ("off", "noise", "noise_fused"):
        _, t_cfg = _cfgs(SSM, AMMS[amm])
        outs.append(t_apply(tp, t_cfg, TRT.build(t_cfg, device="cpu"),
                            toks)[0])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_hybrid_noise_keys_follow_the_group_chain(monkeypatch):
    """The shared block takes one split of the chain per group, after the
    group's Mamba2 layers; the Mamba2 layers take none."""
    import repro_torch.models.transformer as t_tr
    _, t_cfg = _cfgs(HYBRID, AMMS["noise"])
    t_cfg = dataclasses.replace(t_cfg, n_layers=6)        # three groups
    rng = jax.random.key(0)
    want = []
    for _ in range(t_cfg.n_layers // t_cfg.shared_attn_every):
        rng, sub = jax.random.split(rng)
        want.append(tuple(int(v) for v in jax.random.key_data(sub)))
    seen = []
    orig = t_tr.mlp_apply

    def spy(p, x, amm, key, **kw):
        seen.append(tuple(int(v) for v in key))
        return orig(p, x, amm, key, **kw)
    monkeypatch.setattr(t_tr, "mlp_apply", spy)
    tree = numpy_params(t_table(t_cfg), seed=3)
    tp = lm_params_from_numpy(tree, device="cpu")
    t_apply(tp, t_cfg, TRT.build(t_cfg, device="cpu"),
            torch.zeros((1, 4), dtype=torch.int64))
    assert seen == want
    assert list(prng.layer_keys(0, 3)) == want


def test_lm_amm_planes_tree_matches_the_reference():
    """zamba2's shared block precoded once; the SSM family caches
    nothing; chameleon's planes are the dense stack's."""
    for arch in (HYBRID, SSM, VLM):
        j_cfg, t_cfg = _cfgs(arch, AMMS["bitexact"])
        jp, tp = _weights(arch)
        want, got = _planes(arch, "bitexact", j_cfg, t_cfg, jp, tp)
        if arch == SSM:
            assert want is None and got is None
            continue
        if arch == HYBRID:
            assert set(got) == set(want) == {"shared_block"}
            pairs = [(got["shared_block"]["mlp"][n],
                      want["shared_block"]["mlp"][n])
                     for n in ("w_gate", "w_up", "w_down")]
        else:
            assert set(got) == set(want) == {"layers"}
            pairs = [({"codes": got["layers"]["mlp"][n]["codes"][i],
                       "s_w": got["layers"]["mlp"][n]["s_w"][i]},
                      jax.tree.map(lambda a: a[i],
                                   want["layers"]["mlp"][n]))
                     for n in ("w_gate", "w_up", "w_down")
                     for i in range(t_cfg.n_layers)]
        for g, w in pairs:
            mag, neg = booth_precode(g["codes"], 16)
            assert_array_equal(mag.numpy(), np.asarray(w["mag"]))
            assert_array_equal(neg.numpy(), np.asarray(w["neg"]))
            assert_array_equal(g["s_w"].numpy(), np.asarray(w["s_w"]))


def test_converter_carries_the_nested_hybrid_tree():
    """``lm_params_from_numpy`` keeps zamba2's (groups, per, ...) stack and
    its shared block, every Mamba2 leaf equal to the reference's; the
    tree is the port's own ``lm_table``."""
    tree = _tree(HYBRID, seed=5)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = lm_params_from_numpy(tree, device="cpu")
    _, t_cfg = _cfgs(HYBRID)
    shapes = jax.tree.map(lambda s: tuple(s.shape), t_table(t_cfg),
                          is_leaf=lambda v: hasattr(v, "axes"))
    assert jax.tree.map(lambda v: tuple(v.shape), tp) == shapes
    assert jax.tree.structure(jax.tree.map(lambda v: 0, tp)) \
        == jax.tree.structure(jax.tree.map(lambda v: 0, jp))
    groups, per = t_cfg.n_layers // t_cfg.shared_attn_every, \
        t_cfg.shared_attn_every
    mamba = tp["layers"]["mamba"]
    for k in ("a_log", "dt_bias", "d_skip", "conv_w", "conv_b", "in_proj",
              "out_proj", "norm_w"):
        assert mamba[k].shape[:2] == (groups, per)
        assert mamba[k].dtype == torch.float32
        assert_array_equal(mamba[k].numpy(),
                           np.asarray(jp["layers"]["mamba"][k]))
    assert np.std(mamba["a_log"].numpy()) > 0       # drawn, not the init
    for k, v in tp["shared_block"]["mlp"].items():
        assert_array_equal(v.numpy(), np.asarray(jp["shared_block"]["mlp"][k]))


# ------------------------------------------------------------- Scheduler
# the prompts: within one chunk, one chunk, two chunks, and a ragged 24
# (over one chunk of 16 and not a multiple of it), which the reference's
# prefill fails (ROADMAP C11)
ARRIVALS = [(0, 8, 3), (0, 16, 3), (1, 32, 2), (2, 24, 3), (3, 8, 2)]
SLOTS, SCHED_LEN = 2, 48


def _prompts():
    rng = np.random.default_rng(9)
    return [(t, rng.integers(0, 512, n).tolist(), m) for t, n, m in ARRIVALS]


def _drive(sched, request_cls, dtypes, cap=200):
    reqs, t, idx = [], 0, 0
    arrivals = _prompts()
    while True:
        while idx < len(arrivals) and arrivals[idx][0] <= t:
            _, prompt, max_new = arrivals[idx]
            reqs.append(request_cls(rid=idx, prompt=list(prompt),
                                    max_new=max_new))
            sched.submit(reqs[-1])
            idx += 1
        n = sched.step()
        dtypes.append(str(sched.caches["conv"].dtype).split(".")[-1])
        t += 1
        if n == 0 and idx >= len(arrivals) and not sched.queue:
            return reqs
        assert t < cap, "the scheduler failed to terminate"


def _reference_run(arch, continuous):
    j_cfg, _ = _cfgs(arch)
    jp, _ = _weights(arch)
    rt = JRT.build(j_cfg)

    @jax.jit
    def prefill_j(p, t, c):
        logits, _, c = j_apply(p, j_cfg, rt, t, mode="decode", caches=c,
                               pos=jnp.int32(0))
        return logits[:, -1], c

    @jax.jit
    def decode_j(p, t, c, q):
        logits, _, c = j_apply(p, j_cfg, rt, t, mode="decode", caches=c,
                               pos=q)
        return logits[:, -1], c
    log = []

    def logged(kind, c, out):
        log.append((kind, np.asarray(out[0]), str(c["conv"].dtype)))
        return out
    sched = j_engine.Scheduler(
        j_cfg, rt, jp, SLOTS, SCHED_LEN,
        decode_fn=lambda p, t, c, q: logged("decode", c,
                                            decode_j(p, t, c, q)),
        prefill_fn=((lambda p, t, c: logged("prefill", c,
                                            prefill_j(p, t, c)))
                    if continuous else None),
        continuous=continuous)
    dtypes = []
    reqs = _drive(sched, j_engine.Request, dtypes)
    return log, reqs, dict(sched.stats), dtypes


@pytest.mark.parametrize("arch,continuous", [(SSM, True), (HYBRID, True),
                                             (HYBRID, False)],
                         ids=["mamba2-continuous", "zamba2-continuous",
                              "zamba2-flush"])
def test_scheduler_matches_the_reference(arch, continuous):
    """The same arrivals through both schedulers, the port teacher-forced:
    the same calls, streams, stats and failed request (the ragged prompt,
    in continuous mode), and the conv leaf's dtype, as each call gets it
    and after every step, equal to the reference's: bf16 until the first
    decode returns it f32, so the first admission's prefill state is
    rounded to bf16 (ROADMAP C12)."""
    log, j_reqs, j_stats, j_dtypes = _reference_run(arch, continuous)
    _, t_cfg = _cfgs(arch)
    _, tp = _weights(arch)
    rt = TRT.build(t_cfg, device="cpu")
    prefill_t, decode_t = t_engine.make_serve_fns(t_cfg, rt)
    state = {"i": 0, "clear": 0}

    def forced(kind, c, logits):
        want_kind, want, conv_dtype = log[state["i"]]
        state["i"] += 1
        assert kind == want_kind
        assert str(c["conv"].dtype).split(".")[-1] == conv_dtype
        got = logits.numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= LOGIT_RTOL * scale
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_RTOL * scale
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()
        state["clear"] += int(clear.sum())
        return torch.from_numpy(want.copy())

    def prefill(p, t, c):
        dtype_in = {"conv": c["conv"]}
        logits, c = prefill_t(p, t, c)
        return forced("prefill", dtype_in, logits), c

    def decode(p, t, c, q):
        dtype_in = {"conv": c["conv"]}
        logits, c = decode_t(p, t, c, q)
        return forced("decode", dtype_in, logits), c
    sched = t_engine.Scheduler(t_cfg, rt, tp, SLOTS, SCHED_LEN,
                               decode_fn=decode,
                               prefill_fn=prefill if continuous else None,
                               continuous=continuous, device="cpu")
    dtypes = []
    reqs = _drive(sched, t_engine.Request, dtypes)
    assert state["i"] == len(log)
    assert state["clear"] > len(log) // 2
    assert sched.stats == j_stats
    assert [(r.out, r.done) for r in reqs] \
        == [(r.out, r.done) for r in j_reqs]
    failed = [r.rid for r in reqs if r.error]
    assert failed == [r.rid for r in j_reqs if r.error]
    if continuous:
        assert failed == [3]                     # the ragged 24-token prompt
        assert all(r.error.startswith("prefill failed")
                   for r in reqs + j_reqs if r.error)
    else:
        assert failed == []
    assert dtypes == j_dtypes
    ins = [conv for _, _, conv in log]
    first = ins.index("float32")
    assert first == (2 if continuous else 1)   # the first prefill, decode
    assert set(ins[:first]) == {"bfloat16"} and set(ins[first:]) \
        == {"float32"}


# -------------------------------------------------- launcher, registry
@pytest.mark.parametrize("arch,flags", [
    (SSM, ["--amm", "noise", "--continuous"]),
    (HYBRID, ["--amm", "noise", "--amm-pallas", "--continuous"]),
    (HYBRID, ["--amm", "bitexact", "--amm-attn"])],
    ids=["mamba2-noise", "zamba2-noise-fused", "zamba2-bitexact-flush"])
def test_launcher_serves_the_ssm_and_hybrid_families(arch, flags, capsys):
    steps = t_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-new", "3",
                           "--max-len", "32"] + flags)
    assert steps > 0
    assert "3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_launcher_refuses_kv_codes_for_state_space_families(arch):
    """As the reference refuses it: the int-code cache holds attention
    K/V of the dense and MLA layouts only."""
    with pytest.raises(ValueError, match="int-code KV cache"):
        t_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "1", "--max-new", "1", "--amm",
                       "bitexact", "--amm-attn", "--kv-codes",
                       "--continuous"])
    j_cfg, _ = _cfgs(arch, AMMS["bitexact"])
    from repro.serve.kv_cache import init_code_cache
    with pytest.raises(ValueError, match="int-code KV cache"):
        init_code_cache(j_cfg, 1, 16, wl=16)


def test_registry_ports_the_ssm_hybrid_and_vlm_configs():
    for name in (SSM, HYBRID, VLM):
        assert name in ARCH_NAMES
        assert dataclasses.asdict(t_get(name)) \
            == dataclasses.asdict(j_get(name)), name
        assert dataclasses.asdict(t_reduced(t_get(name))) \
            == dataclasses.asdict(j_reduced(j_get(name))), name
        shapes = jax.tree.map(lambda s: tuple(s.shape), j_table(
            j_reduced(j_get(name))), is_leaf=lambda v: hasattr(v, "axes"))
        assert jax.tree.map(lambda s: tuple(s.shape), t_table(
            t_reduced(t_get(name))), is_leaf=lambda v: hasattr(v, "axes")) \
            == shapes, name
