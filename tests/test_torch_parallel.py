"""The port's parallel layer against the JAX package's, on the CPU.

* the logical rules: ``spec_to_pspec``, ``tree_shardings`` (through
  ``train_step_shardings``), ``batch_pspec`` and ``logical_sharding``
  equal the reference's for every registered config's full-width
  ``lm_table``, on shape-only meshes (16, 16), (2, 16, 16), (4, 2) and
  (1, 1) (the reference on ``AbstractMesh``); the DTensor placements and
  the refusal of an uneven shard;
* ``compress_decompress`` (int8 with and without a key, bf16) and
  ``allreduce_ref`` bit for bit on ragged lengths; the int8 and bf16
  ``compressed_allreduce`` on a 1-rank gloo mesh against the reference
  on one device;
* ``sharded_filterbank`` on a 1-rank gloo mesh against ``fir_bank_ref``
  over wl {8, 12, 16}, both kinds, forms rows, dot and None, with the
  reference's refusals and messages;
* multi-rank: the reference once on four forced host devices (a
  subprocess) and the port once on four gloo ranks
  (``tests/torch_parallel_ranks.py``), side by side, compared by mesh
  coordinate: the compressed all-reduce on (4, 1) and (2, 2), the
  sharded filterbank, the carried state's layout on (2, 2) and (2, 2, 1),
  a checkpoint written on (2, 2) and read on (4, 1) and (1, 1), and the
  reference's checkpoint read by the port.

Tolerances: none but one.  The int8 path sums int32 codes and every
other step is elementwise f32 in the reference's order, so it is held bit
for bit.  The bf16 path sums f32 values in the collective's order; two
ranks' sums commute, so they are held bit for bit, and four ranks' within
2 * gamma_3 * sum|x_i| / 4 (gamma_3 = 3u / (1 - 3u), u = 2^-24: three f32
adds in any order on either side).
"""
from __future__ import annotations

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES as J_NAMES
from repro.configs import get_arch as j_get
from repro.kernels import ref as j_kref
from repro.parallel import compress as j_comp
from repro.parallel import filterbank as j_fb
from repro.parallel import logical as j_log
from repro.train import trainstep as j_step
from repro_torch.configs import ARCH_NAMES as T_NAMES
from repro_torch.configs import get_arch as t_get
from repro_torch.core import prng
from repro_torch.kernels.fir_kernel import min_safe_shift
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import compress as t_comp
from repro_torch.parallel import filterbank as t_fb
from repro_torch.parallel import logical as t_log
from repro_torch.train import trainstep as t_step

pytest_plugins = ["port_first"]

ROOT = Path(__file__).resolve().parents[1]
# the integer oracle, jitted (bit-equal to its eager calls, and compiled
# once a shape instead of once an operation)
fir_ref = jax.jit(j_kref.fir_bank_ref,
                  static_argnames=("wl", "vbl", "kind", "shift"))
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2)),
          "1x1": (("data", "model"), (1, 1))}


def _meshes(tag):
    """(the reference's AbstractMesh, the port's shape-only mesh)."""
    names, shape = MESHES[tag]
    return (AbstractMesh(shape, names),
            types.SimpleNamespace(mesh_dim_names=names, shape=shape))


def _specs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


def _t_specs(tree):
    from repro_torch.train.optimizer import tree_leaves
    return [tuple(s.spec) for s in tree_leaves(tree)]


# ------------------------------------------------------------ the rules
def test_rule_tables_are_the_reference_s():
    for name in ("RULES", "RULES_MULTIPOD", "OPT_RULES",
                 "OPT_RULES_MULTIPOD", "FALLBACK_RULES"):
        assert getattr(t_log, name) == getattr(j_log, name), name
    assert T_NAMES == J_NAMES


@pytest.mark.parametrize("axes", [
    ("embed", "mlp"), ("vocab", "embed"), ("layers", "embed", "heads"),
    ("experts", "embed", "expert_mlp"), ("heads", "kv_heads"),
    ("batch", "seq"), ("layers", "experts", "expert_mlp", "embed"),
    ("q_latent", "kv_latent"), ("ssm_inner", "ssm_state", None)])
def test_spec_to_pspec_matches_reference(axes):
    for rules in ("RULES", "RULES_MULTIPOD", "OPT_RULES_MULTIPOD"):
        want = j_log.spec_to_pspec(axes, getattr(j_log, rules))
        got = t_log.spec_to_pspec(axes, getattr(t_log, rules))
        assert got == want and tuple(got) == tuple(want), (rules, got, want)
    # with shapes: 14 heads, 8 experts on a 16-way axis, a batch of 1
    jm, tm = _meshes("2x16x16")
    for shape in ((896, 14), (8, 896, 4864), (1, 64), (32, 64), (64, 64)):
        shape = shape + (16,) * (len(axes) - len(shape))
        shape = shape[:len(axes)]
        for rules in ("RULES", "RULES_MULTIPOD", "OPT_RULES_MULTIPOD"):
            want = j_log.spec_to_pspec(axes, getattr(j_log, rules), shape, jm)
            got = t_log.spec_to_pspec(axes, getattr(t_log, rules), shape,
                                      tm)
            assert tuple(got) == tuple(want), (rules, shape, got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_NAMES))
def test_train_step_shardings_match_reference(arch, mesh):
    """Parameters under RULES*, moments under OPT_RULES*, the batch, for
    the config's full-width table (qwen2's 14 heads, grok-1's 8 experts
    falling back to expert_mlp, a batch of 1)."""
    jm, tm = _meshes(mesh)
    jcfg, tcfg = j_get(arch), t_get(arch)
    from repro.models import lm_logical_axes as j_axes
    from repro_torch.models import lm_logical_axes as t_axes
    assert jax.tree.leaves(j_axes(jcfg), is_leaf=lambda x: isinstance(
        x, tuple)) == jax.tree.leaves(t_axes(tcfg), is_leaf=lambda x:
                                      isinstance(x, tuple))
    for batch in (None, 1, 2, 32, 512):
        jp, jo, jb = j_step.train_step_shardings(jcfg, jm, batch)
        tp, to, tb = t_step.train_step_shardings(tcfg, tm, batch)
        assert _t_specs(tp) == _specs(jp)
        assert _t_specs(to) == _specs(jo)
        assert tuple(tb.spec) == tuple(jb.spec)
        assert t_log.batch_pspec(tm, batch) == j_log.batch_pspec(jm, batch)
    got = t_log.logical_sharding(tm, "embed", "heads", shape=(896, 14))
    assert tuple(got.spec) == tuple(j_log.logical_sharding(
        jm, "embed", "heads", shape=(896, 14)).spec)


def test_placements_split_in_the_mesh_s_order():
    from torch.distributed.tensor import Replicate, Shard
    _, tm = _meshes("2x16x16")
    spec = t_log.PartitionSpec(("pod", "data"), "model")
    assert t_log.placements(spec, tm) == (Shard(0), Shard(0), Shard(1))
    assert t_log.placements(t_log.PartitionSpec(None, "data"), tm) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="against the mesh's order"):
        t_log.placements(t_log.PartitionSpec(("data", "pod")), tm)
    assert t_log.PartitionSpec(("data",)) == ("data",)


def test_device_put_refuses_an_uneven_shard():
    mesh = make_host_mesh(device="cpu")
    fake = t_log.NamedSharding(types.SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(2, 1)),
        t_log.PartitionSpec("data"))
    with pytest.raises(ValueError, match="does not split evenly"):
        t_log._put(torch.zeros(3, 4), fake)
    one = t_log.NamedSharding(mesh, t_log.PartitionSpec("data", "model"))
    out = t_log.device_put({"a": [torch.ones(3, 4)]}, {"a": [one]})
    assert torch.equal(out["a"][0].full_tensor(), torch.ones(3, 4))


# ------------------------------------------------------- the compressor
RAGGED = (1, 200, 255, 257, 1000, (3, 77))


def _grad(rng, shape):
    g = rng.standard_normal(shape).astype(np.float32)
    g[..., :3] *= 1e3           # blocks with a wide range
    return g


@pytest.mark.parametrize("codec,key", [("int8", None), ("int8", 7),
                                       ("bf16", None)])
def test_compress_decompress_matches_reference(codec, key):
    rng = np.random.default_rng(0)
    for shape in RAGGED:
        g = _grad(rng, shape)
        jk = None if key is None else jax.random.key(key)
        tk = None if key is None else prng.key(key)
        want = np.asarray(j_comp.compress_decompress(jnp.asarray(g), codec,
                                                     key=jk))
        got = t_comp.compress_decompress(torch.from_numpy(g), codec, key=tk)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        t_comp.compress_decompress(torch.zeros(3), "fp8")


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_allreduce_ref_matches_reference(codec):
    rng = np.random.default_rng(1)
    for n in (257, 1000):
        gs = _grad(rng, (4, n))
        want = np.asarray(j_comp.allreduce_ref(jnp.asarray(gs), codec))
        got = t_comp.allreduce_ref(torch.from_numpy(gs), codec)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_compressed_allreduce_one_rank_matches_reference(codec):
    rng = np.random.default_rng(2)
    g = {"w": _grad(rng, (3, 100)), "b": [_grad(rng, (257,))]}
    e = {"w": 1e-3 * _grad(rng, (3, 100)), "b": [np.zeros(257, np.float32)]}
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jm, je = j_comp.compressed_allreduce(
        jax.tree.map(jnp.asarray, g), jmesh, codec, error_buf=jax.tree.map(
            jnp.asarray, e))
    mesh = make_host_mesh(device="cpu")
    tt = lambda tree: {"w": torch.from_numpy(tree["w"]),  # noqa: E731
                       "b": [torch.from_numpy(tree["b"][0])]}
    tm, te = t_comp.compressed_allreduce(tt(g), mesh, codec,
                                         error_buf=tt(e))
    for got, want in ((tm, jm), (te, je)):
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"][0].numpy(),
                                      np.asarray(want["b"][0]))
    # without an error buffer: zeros
    tm2, _ = t_comp.compressed_allreduce(tt(g), mesh, codec)
    np.testing.assert_array_equal(tm2["w"].numpy(),
                                  t_comp.compress_decompress(
                                      torch.from_numpy(g["w"]),
                                      codec).numpy())


# ----------------------------------------------- the sharded filterbank
FB_POINTS = ((8, 5), (12, 9), (16, 13))


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("wl,vbl", FB_POINTS)
def test_sharded_filterbank_one_rank_matches_reference(wl, vbl, kind):
    rng = np.random.default_rng(wl + kind)
    taps = 11
    shift = min_safe_shift(taps, wl)
    x = rng.integers(0, 1 << wl, (4, 150)).astype(np.int32)
    h = rng.integers(0, 1 << wl, (4, taps)).astype(np.int32)
    kw = dict(wl=wl, vbl=vbl, kind=kind, shift=shift)
    want = np.asarray(fir_ref(jnp.asarray(x), jnp.asarray(h),
                                          **kw))
    mesh = make_host_mesh(device="cpu")
    for form in ("rows", "dot", None):
        got = t_fb.sharded_filterbank(x, h, mesh, form=form, **kw)
        assert tuple(got.shape) == x.shape
        np.testing.assert_array_equal(got.full_tensor().numpy(), want,
                                      err_msg=str(form))


def test_sharded_filterbank_shared_bank_matches_reference():
    """A (taps,) bank shared by every channel, decoded once by
    ``precode_filterbank``."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 16, (4, 150)).astype(np.int32)
    h = rng.integers(0, 1 << 16, (31,)).astype(np.int32)
    kw = dict(wl=16, vbl=13, kind=0, shift=5)
    want = np.asarray(fir_ref(
        jnp.asarray(x), jnp.broadcast_to(jnp.asarray(h), (4, 31)), **kw))
    mesh = make_host_mesh(device="cpu")
    planes = t_fb.precode_filterbank(h, wl=16, channels=4)
    for h_planes in (None, planes):
        got = t_fb.sharded_filterbank(x, h, mesh, h_planes=h_planes, **kw)
        np.testing.assert_array_equal(got.to_local().numpy(), want)


def _same_refusal(j_call, t_call):
    with pytest.raises(ValueError) as jerr:
        j_call()
    with pytest.raises(ValueError) as terr:
        t_call()
    assert str(terr.value) == str(jerr.value)


def test_sharded_filterbank_refuses_as_the_reference():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 16, (4, 64)).astype(np.int32)
    h = rng.integers(0, 1 << 16, (4, 31)).astype(np.int32)
    jmesh = jax.make_mesh((1,), ("data",))
    mesh = make_host_mesh(device="cpu")
    kw = dict(wl=16, vbl=13)
    # the int32 envelope (31 taps at wl 16 need shift 5)
    _same_refusal(
        lambda: j_fb.sharded_filterbank(jnp.asarray(x), jnp.asarray(h),
                                        jmesh, shift=4, **kw),
        lambda: t_fb.sharded_filterbank(x, h, mesh, shift=4, **kw))
    # digit planes of another channel count
    jp = j_fb.precode_filterbank(jnp.asarray(h[:2]), wl=16)
    tp = t_fb.precode_filterbank(h[:2], wl=16)
    _same_refusal(
        lambda: j_fb.sharded_filterbank(jnp.asarray(x), jnp.asarray(h),
                                        jmesh, shift=5, h_planes=jp, **kw),
        lambda: t_fb.sharded_filterbank(x, h, mesh, shift=5, h_planes=tp,
                                        **kw))
    # an unknown form, on every path
    _same_refusal(
        lambda: j_fb.sharded_filterbank(jnp.asarray(x), jnp.asarray(h),
                                        jmesh, shift=5, form="cols", **kw),
        lambda: t_fb.sharded_filterbank(x, h, mesh, shift=5, form="cols",
                                        **kw))
    # a shared bank needs its channel count
    _same_refusal(lambda: j_fb.precode_filterbank(jnp.asarray(h[0]), wl=16),
                  lambda: t_fb.precode_filterbank(h[0], wl=16))
    # a tensor on another device than the mesh's
    with pytest.raises(ValueError, match="the mesh on"):
        t_fb.sharded_filterbank(torch.from_numpy(x).to("meta"), h, mesh,
                                shift=5, **kw)


# ---------------------------------------------------------- multi-rank
REF_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.models
from repro.configs import get_arch, reduced
from repro.parallel.compress import compressed_allreduce
from repro.parallel.filterbank import sharded_filterbank
from repro.train import checkpoint as ckpt
from repro.train.trainstep import (TrainConfig, init_train_state,
                                   train_step_shardings)

out = Path(sys.argv[1])
CONFIGS = ("qwen2-0.5b", "grok-1-314b", "deepseek-v3-671b")
# the parameters, written first: the port's ranks carry them across, and
# init_train_state lays the same ones out (its lm_init returns them:
# seeded numpy draws of lm_table's shapes, where jax.random would spend
# seconds compiling and the layout is what is compared)
from repro.models.common import Spec
rng = np.random.default_rng(0)
init = {}
for name in CONFIGS:
    init[name] = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        repro.models.lm_table(reduced(get_arch(name))),
        is_leaf=lambda x: isinstance(x, Spec))
    with open(out / f"state_{name}.pkl", "wb") as f:
        pickle.dump(init[name], f)
(out / "state.ready").touch()
repro.models.lm_init = lambda cfg, key, dtype=None: jax.tree.map(
    jnp.asarray, init[next(n for n in CONFIGS
                           if reduced(get_arch(n)) == cfg)])

res = {}
def blocks(name, arr, mesh):
    for sh in arr.addressable_shards:
        c = np.argwhere(mesh.devices == sh.device)[0]
        res[f"{name}@{','.join(str(int(v)) for v in c)}"] = np.asarray(
            sh.data)

inp = np.load(out / "inputs.npz")
names = sorted({k.split(".")[1] for k in inp.files if k.startswith("g.")})
meshes = {"4x1": jax.make_mesh((4, 1), ("data", "model")),
          "2x2": jax.make_mesh((2, 2), ("data", "model")),
          "2x2x1": jax.make_mesh((2, 2, 1), ("pod", "data", "model"))}
for codec in ("int8", "bf16"):
    for tag in ("4x1", "2x2"):
        mesh = meshes[tag]
        g = {k: jnp.asarray(inp[f"g.{k}"]) for k in names}
        e = {k: jnp.asarray(inp[f"e.{k}"]) for k in names}
        # called eagerly, as the reference's tests call it: under jit XLA
        # contracts g + e - q * s into a fused multiply-add
        mean, err = compressed_allreduce(g, mesh, codec, error_buf=e)
        for k in names:
            blocks(f"ar/{codec}/{tag}/mean/{k}", mean[k], mesh)
            blocks(f"ar/{codec}/{tag}/err/{k}", err[k], mesh)

y = jax.jit(sharded_filterbank, static_argnums=2,
            static_argnames=("wl", "vbl", "kind"))(
    jnp.asarray(inp["fb.x"]), jnp.asarray(inp["fb.h"]), meshes["4x1"],
    wl=12, vbl=9, kind=1)
blocks("fb", y, meshes["4x1"])
try:
    sharded_filterbank(jnp.asarray(inp["fb.x"][:6]),
                       jnp.asarray(inp["fb.h"][:6]), meshes["4x1"], wl=12,
                       vbl=9, kind=1)
    res["fb_refused"] = np.array("")
except ValueError as err:
    res["fb_refused"] = np.array(str(err))

tc = TrainConfig()
for name in CONFIGS:
    cfg = reduced(get_arch(name))
    for tag in ("2x2", "2x2x1") + (("4x1",) if name == CONFIGS[0] else ()):
        state = init_train_state(cfg, tc, meshes[tag], jax.random.key(0))
        for i, leaf in enumerate(jax.tree.leaves(state)):
            blocks(f"state/{name}/{tag}/{i}", leaf, meshes[tag])
        if name == CONFIGS[0] and tag == "2x2":
            ckpt.save(state, 5, str(out / "ref_ckpt"))
        if tag == "2x2x1":
            # the parameters on the moments' shardings: "embed" split over
            # ("pod", "data"), pod major
            _, o_sh, _ = train_step_shardings(cfg, meshes[tag])
            moved = jax.device_put(jax.tree.map(jnp.asarray, init[name]),
                                   o_sh)
            for i, leaf in enumerate(jax.tree.leaves(moved)):
                blocks(f"optlayout/{name}/{i}", leaf, meshes[tag])
np.savez(out / "ref.npz", **res)
"""


def _inputs(out: Path) -> dict:
    rng = np.random.default_rng(11)
    arrays = {}
    for k, shape in (("w", (8, 100)), ("c", (8, 3, 43))):
        arrays[f"g.{k}"] = _grad(rng, shape)
        arrays[f"e.{k}"] = (1e-2 * rng.standard_normal(shape)).astype(
            np.float32)
    arrays["fb.x"] = rng.integers(0, 1 << 12, (8, 256)).astype(np.int32)
    arrays["fb.h"] = rng.integers(0, 1 << 12, (8, 31)).astype(np.int32)
    np.savez(out / "inputs.npz", **arrays)
    return arrays


def _bf16_sum_bound(arrays, k: str) -> np.ndarray:
    """2 gamma_3 sum|x_i| / 4 per element of a (4, 1) block: the bf16
    codes of the four ranks' g + e, as each side sums them."""
    g = arrays[f"g.{k}"] + arrays[f"e.{k}"]
    codes = torch.from_numpy(g).to(torch.bfloat16).to(torch.float32).numpy()
    per = codes.reshape((4, -1) + codes.shape[1:])
    u = 2.0 ** -24
    return 2 * (3 * u / (1 - 3 * u)) * np.abs(per).astype(np.float64).sum(
        0) / 4


def _restored_equal(tree, numpy_tree) -> bool:
    from repro_torch.train.optimizer import tree_leaves
    got = [t.full_tensor().numpy() for t in tree_leaves(tree)]
    return len(got) == len(numpy_tree) and all(
        np.array_equal(a, b) for a, b in zip(got, numpy_tree))


def test_multi_rank_parity(tmp_path):
    """The reference on four host devices and the port on four gloo ranks,
    run side by side once, compared by mesh coordinate."""
    arrays = _inputs(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(tmp_path)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    port_env = {k: v for k, v in env.items() if k != "JAX_PLATFORMS"}
    port = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                 "torch_parallel_ranks.py"),
                             str(tmp_path)], env=port_env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        _, ref_err = ref.communicate(timeout=300)
        _, port_err = port.communicate(timeout=300)
    finally:
        for p in (ref, port):
            if p.poll() is None:
                p.kill()
    assert ref.returncode == 0, ref_err[-3000:]
    assert port.returncode == 0, port_err[-3000:]
    want = dict(np.load(tmp_path / "ref.npz"))
    got = {}
    for r in range(4):
        got.update(np.load(tmp_path / f"port_rank{r}.npz"))

    # every block of the reference has its counterpart at its coordinate
    # (its (4, 1) layout is the restored checkpoint's, below)
    keyed = sorted(k for k in want if "@" in k
                   and not k.startswith("state/qwen2-0.5b/4x1/"))
    assert keyed and all(k in got for k in keyed), sorted(
        set(keyed) - set(got))[:5]
    for k in keyed:
        if k.startswith("ar/bf16/4x1/mean/"):
            name = k.split("/")[4].split("@")[0]
            diff = np.abs(got[k].astype(np.float64) - want[k])
            bound = _bf16_sum_bound(arrays, name)
            assert diff.shape == bound.shape and (diff <= bound).all(), k
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert str(got["fb_refused"]) == str(want["fb_refused"]) != ""
    assert bool(got["init_equal"])
    assert sum(k.startswith("state/") for k in keyed) > 4 * 2 * 3 * 13
    np.testing.assert_array_equal(
        got["fb_full"], np.asarray(fir_ref(
            jnp.asarray(arrays["fb.x"]), jnp.asarray(arrays["fb.h"]), wl=12,
            vbl=9, kind=1)))
    # the (2, 2) checkpoint read on (4, 1) is the reference's (4, 1) layout
    restored = [k for k in got if k.startswith("restored/4x1/")]
    assert len(restored) == 4 * (3 * 14 + 1)
    for k in restored:
        np.testing.assert_array_equal(
            got[k], want[k.replace("restored/4x1/",
                                   "state/qwen2-0.5b/4x1/")], err_msg=k)

    # (1, 1): the port's checkpoint and the reference's, read here
    import pickle
    from repro_torch.configs import reduced
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.trainstep import TrainConfig, init_train_state
    cfg = reduced(t_get("qwen2-0.5b"))
    mesh = make_host_mesh(4, 2, device="cpu")        # a world of one
    assert tuple(mesh.shape) == (1, 1)
    like = init_train_state(cfg, TrainConfig(), mesh, seed=1)
    p_sh, o_sh, _ = t_step.train_step_shardings(cfg, mesh)
    rep = t_log.NamedSharding(mesh, t_log.PartitionSpec())
    with open(tmp_path / "state_qwen2-0.5b.pkl", "rb") as f:
        params = jax.tree.leaves(pickle.load(f))
    assert len(params) == 14
    for d, step in (("port_ckpt", 7), ("ref_ckpt", 5)):
        tree, at = ckpt.restore(like, str(tmp_path / d),
                                shardings=(p_sh, OptState(rep, o_sh, o_sh)))
        assert at == step
        assert _restored_equal(tree[0], params), d
        assert int(tree[1].step.full_tensor()) == 0
        assert _restored_equal(tree[1].m, [np.zeros_like(p) for p in params])
