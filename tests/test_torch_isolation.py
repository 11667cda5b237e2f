"""The port stands alone and runs on the GPU unless told otherwise.

* no module of ``src/repro_torch`` and no line of ``chip_smoke.py``
  imports ``jax`` or the JAX package ``repro`` (an AST scan, then every
  module imported in a fresh interpreter where both are blocked);
* the entry points default to the GPU and raise without one;
* the kernel wrappers refuse operands their kernels do not take;
* the kernels' build directory is git-ignored;
* the port's tests are collected ahead of the reference suite
  (``tests/port_first.py``).

Tests marked ``cuda`` need an NVIDIA GPU and skip without one.
"""
from __future__ import annotations

import ast
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.multipliers import MulSpec
from repro_torch.dsp import fir as t_fir
from repro_torch.kernels import _build
from repro_torch.kernels import booth_rows as t_rows
from repro_torch.kernels import fir_kernel as t_fk
from repro_torch.kernels import ops as t_ops
from repro_torch.serve import FilterbankEngine
from torch_coded_card import CARD_CHECKS

pytest_plugins = ["port_first"]

SPEC = MulSpec("bbm0", 16, 13)
ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_port_file_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 15
    rel = {p.relative_to(ROOT).as_posix() for p in files}
    for part in ("train/optimizer.py", "train/trainstep.py",
                 "train/checkpoint.py", "train/loop.py", "data/pipeline.py",
                 "launch/train.py", "kernels/bbm_matmul.py",
                 "kernels/flash_attention.py", "core/faults.py",
                 "core/noise.py", "core/errstats.py", "core/bam.py",
                 "core/kulkarni.py", "core/etm.py", "core/ref_sim.py",
                 "core/hwmodel.py"):
        assert f"src/repro_torch/{part}" in rel, part
    for path in ("src/repro_torch/kernels/normal.py",
                 "src/repro_torch/core/prng.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/configs/deepseek_v3_671b.py",
                 "src/repro_torch/configs/grok1_314b.py",
                 "src/repro_torch/configs/qwen1_5_110b.py",
                 "src/repro_torch/configs/llama3_2_3b.py",
                 "src/repro_torch/configs/yi_34b.py"):
        assert path in rel, path
    bad = [(p.relative_to(ROOT).as_posix(), root) for p in files
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert bad == []


def test_port_tests_are_collected_first(request):
    """The port's files come first and the reference suite keeps its own
    order behind them (see ``tests/port_first.py``)."""
    names = [item.path.name for item in request.session.items]
    is_port = [n.startswith("test_torch_") for n in names]
    assert is_port == sorted(is_port, reverse=True)
    rest = [n for n, port in zip(names, is_port) if not port]
    assert rest == sorted(rest)


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


def test_every_module_imports_with_jax_and_reference_blocked():
    names = _module_names()
    assert "repro_torch.serve.engine" in names and len(names) > 15
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._LIBS == {}, 'importing built a kernel'\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


# ------------------------------------------------------ the device rule
@contextlib.contextmanager
def _no_gpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        yield


@pytest.mark.parametrize("entry", ["fir_apply", "PrecodedBank",
                                   "FilterbankEngine", "fir_filterbank",
                                   "fir_filterbank_precoded",
                                   "run_filter_case", "bbm_matmul",
                                   "bbm_matmul_precoded", "plane_fault_mask",
                                   "random_bits", "uniform", "bernoulli",
                                   "normal", "normal_draw", "characterize",
                                   "error_histogram", "make_host_mesh",
                                   "sharded_filterbank",
                                   "init_train_state"])
def test_entry_points_default_to_the_gpu(entry):
    h = t_fir.design_lowpass()
    x = np.ones((2, 64))
    codes = np.ones((2, 64), np.int32)
    planes = np.zeros((8, 2, 31), np.int32)
    from repro_torch.core import prng
    from repro_torch.core.errstats import characterize, error_histogram
    from repro_torch.core.faults import FaultSpec, plane_fault_mask
    from repro_torch.dsp.testbed import run_filter_case
    from repro_torch.kernels.normal import normal_draw
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharded_filterbank
    from repro_torch.train.trainstep import TrainConfig, init_train_state
    from repro_torch.configs import get_arch, reduced
    tiny = reduced(get_arch("qwen2-0.5b"), layers=1, d_model=16, vocab=32)
    calls = {
        "fir_apply": lambda **kw: t_fir.fir_apply(x, h, SPEC, **kw),
        "PrecodedBank": lambda **kw: t_fir.PrecodedBank(h, SPEC, **kw),
        "FilterbankEngine": lambda **kw: FilterbankEngine(h, SPEC, **kw),
        "fir_filterbank": lambda **kw: t_ops.fir_filterbank(
            codes, codes[:, :31], wl=16, vbl=13, shift=5, **kw),
        "fir_filterbank_precoded": lambda **kw: t_ops.fir_filterbank_precoded(
            codes, planes, planes, wl=16, vbl=13, shift=5, **kw),
        "run_filter_case": lambda **kw: run_filter_case(SPEC, **kw),
        "bbm_matmul": lambda **kw: t_ops.bbm_matmul(
            codes[:, :31], codes[:, :31].T, wl=16, vbl=13, shift=15, **kw),
        "bbm_matmul_precoded": lambda **kw: t_ops.bbm_matmul_precoded(
            codes, np.zeros((8, 64, 4), np.int32),
            np.zeros((8, 64, 4), np.int32), wl=16, vbl=13, shift=15, **kw),
        "plane_fault_mask": lambda **kw: plane_fault_mask(
            FaultSpec(p=0.5), (8, 4, 3), 1, **kw),
        "random_bits": lambda **kw: prng.random_bits(prng.key(1), (5,), **kw),
        "uniform": lambda **kw: prng.uniform(prng.key(1), (5,), **kw),
        "bernoulli": lambda **kw: prng.bernoulli(prng.key(1), 0.5, (5,),
                                                 **kw),
        "normal": lambda **kw: prng.normal(prng.key(1), (5,), **kw),
        "normal_draw": lambda **kw: normal_draw(prng.key(1), (2, 3), **kw),
        "characterize": lambda **kw: characterize(MulSpec("bam", 4, 2),
                                                  **kw),
        "error_histogram": lambda **kw: error_histogram(
            MulSpec("etm", 4, 1), bins=9, **kw),
        "make_host_mesh": lambda **kw: make_host_mesh(2, 1, **kw),
        "sharded_filterbank": lambda **kw: sharded_filterbank(
            codes, codes[:, :31], make_host_mesh(**kw), wl=16, vbl=13,
            shift=5),
        "init_train_state": lambda **kw: init_train_state(
            tiny, TrainConfig(), make_host_mesh(**kw), 0),
    }
    with _no_gpu():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry](device="cuda")
        calls[entry](device="cpu")      # the plain versions need no card


def _tiny_lm():
    import dataclasses
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import AmmConfig
    return dataclasses.replace(
        reduced(get_arch("qwen2-0.5b"), layers=1, d_model=16, vocab=32),
        amm=AmmConfig(mode="noise", use_pallas=True))


@pytest.mark.parametrize("entry", ["lm_init", "init_cache", "Scheduler",
                                   "lm_params_from_numpy", "launch.serve",
                                   "launch.train", "opt_state_from_numpy"])
def test_lm_entry_points_default_to_the_gpu(entry, tmp_path):
    from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
    from repro_torch.launch import serve as t_launch
    from repro_torch.launch import train as t_train
    from repro_torch.models import ModelRuntime, init_cache, lm_init
    from repro_torch.serve import Scheduler
    cfg = _tiny_lm()

    def sched(**kw):
        dev = kw.get("device", "cuda")
        params = lm_init(cfg, device="cpu" if dev == "cpu" else None)
        rt = ModelRuntime.build(cfg, device="cpu" if dev == "cpu" else None)
        return Scheduler(cfg, rt, params, 2, 8, **kw)

    def launch(**kw):
        argv = ["--reduced", "--requests", "1", "--max-new", "1",
                "--amm", "noise", "--amm-pallas"]
        dev = kw.get("device")
        return t_launch.main(argv + ([] if dev is None
                                     else ["--device", dev]))

    def train(**kw):
        argv = ["--reduced", "--steps", "1", "--batch", "1", "--seq", "8",
                "--amm", "bitexact", "--amm-attn", "--flash-attn",
                "--ckpt-dir", str(tmp_path / "ck")]
        dev = kw.get("device")
        return t_train.main(argv + ([] if dev is None
                                    else ["--device", dev]))
    zeros = np.zeros((2,), np.float32)
    calls = {
        "lm_init": lambda **kw: lm_init(cfg, **kw),
        "init_cache": lambda **kw: init_cache(cfg, 2, 8, **kw),
        "Scheduler": sched,
        "lm_params_from_numpy": lambda **kw: lm_params_from_numpy(
            {"embed": np.ones((4, 2), np.float32)}, **kw),
        "launch.serve": launch,
        "launch.train": train,
        "opt_state_from_numpy": lambda **kw: opt_state_from_numpy(
            (np.int32(0), {"w": zeros}, {"w": zeros}), **kw),
    }
    with _no_gpu():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry](device="cuda")
        calls[entry](device="cpu")      # the plain versions need no card


def test_tf32_is_off_on_the_f32_paths():
    """The port's f32 paths pin TF32 off (matmul and cuDNN), whatever the
    caller set: the entry points call ``device.pin_fp32``."""
    import dataclasses
    from repro_torch.configs.base import AmmConfig
    from repro_torch.core import prng
    from repro_torch.kernels import quant_matmul
    from repro_torch.kernels.bbm_matmul import bbm_dot_scaled
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_amm)
    from repro_torch.kernels.ref import quant_matmul_ref
    from repro_torch.models import (ModelRuntime, amm_dense, init_cache,
                                    lm_apply, lm_init, lm_loss)
    from repro_torch.serve import Scheduler
    cfg = _tiny_lm()
    rt = ModelRuntime.build(cfg, device="cpu")
    params = lm_init(cfg, device="cpu")
    x, w = torch.ones((2, 16)), torch.ones((16, 4))
    bcfg = dataclasses.replace(cfg, amm=AmmConfig(
        mode="bitexact", apply_to="all"))
    brt = ModelRuntime.build(bcfg, use_pallas=True)
    codes = torch.ones((4, 70), dtype=torch.int32)
    qkv = torch.ones((1, 1, 8, 16))
    toks = torch.ones((1, 3), dtype=torch.int64)
    runs = {
        "lm_apply": lambda: lm_apply(params, cfg, rt, torch.ones(
            (1, 3), dtype=torch.int64), mode="decode",
            caches=init_cache(cfg, 1, 8, device="cpu"), pos=0),
        "amm_dense": lambda: amm_dense(x, w, rt.amm, prng.key(5)),
        "quant_matmul": lambda: quant_matmul(x, w, 0.1, 0.1),
        "quant_matmul_ref": lambda: quant_matmul_ref(x, w, 0.1, 0.1, 0.0,
                                                     0.0),
        "Scheduler": lambda: Scheduler(cfg, rt, params, 1, 8,
                                       device="cpu"),
        "lm_loss": lambda: lm_loss(params, bcfg, brt, toks, toks),
        "bbm_dot_scaled": lambda: bbm_dot_scaled(codes, codes.t()
                                                 .contiguous(), wl=16,
                                                 vbl=13, kind=0),
        "flash_attention": lambda: flash_attention(qkv, qkv, qkv),
        "flash_attention_amm": lambda: flash_attention_amm(
            qkv, qkv, qkv, wl=16, vbl=13, kind=0),
    }
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    try:
        for name, run in runs.items():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            run()
            assert not torch.backends.cuda.matmul.allow_tf32, name
            assert not torch.backends.cudnn.allow_tf32, name
            assert torch.get_float32_matmul_precision() == "highest", name
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]


def test_unported_parts_name_their_roadmap_item(tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as t_launch
    from repro_torch.launch import train as t_train
    from repro_torch.models import ModelRuntime
    from repro_torch.models.attention import attention, attn_table
    from repro_torch.models.common import AmmRuntime
    from repro_torch.configs.base import AmmConfig
    # the encoder-decoder family is ported: get_arch returns whisper-base
    whisper = get_arch("whisper-base")
    assert whisper.is_encoder_decoder and whisper.encoder_len == 1500
    with pytest.raises(KeyError):
        get_arch("whisper-tiny")
    # --kv-codes takes the reference's parse-time rules (bitexact, a Booth
    # family, --amm-attn): each missing piece is an argparse error
    for flag in (["--kv-codes"], ["--kv-codes", "--amm", "bitexact"],
                 ["--kv-codes", "--amm", "bitexact", "--amm-attn", "--mul",
                  "kulkarni", "--vbl", "2"]):
        with pytest.raises(SystemExit):
            t_launch.main(["--reduced", "--device", "cpu"] + flag)
    with pytest.raises(NotImplementedError, match="A13"):
        t_train.main(["--reduced", "--device", "cpu", "--mesh-data", "2",
                      "--ckpt-dir", str(tmp_path)])
    cfg = _tiny_lm()
    x = torch.ones((1, 1, 16))
    p = {k: torch.ones(v.shape) for k, v in attn_table(cfg).items()}
    amm = AmmRuntime.build(AmmConfig(mode="bitexact", apply_to="all"))
    shape = (1, 4, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    # amm attention against a float cache decodes (bitexact serving)
    y, _ = attention(p, x, cfg, positions=torch.zeros((1, 1)), cache=cache,
                     pos=0, amm=amm)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    # the int-code cache needs an active Booth-family attention lowering
    with pytest.raises(ValueError, match="int-code KV cache requires"):
        attention(p, x, cfg, positions=torch.zeros((1, 1)),
                  cache={"k_codes": None}, pos=0)
    assert ModelRuntime.build(cfg, device="cpu").amm.mlp_active


def test_bank_and_call_must_share_a_device():
    bank = t_fir.PrecodedBank(t_fir.design_lowpass(), SPEC, device="cpu")
    with _no_gpu():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_fir.fir_apply(np.ones(64), bank)
        with pytest.raises(ValueError, match="device"):
            t_fir.fir_apply(np.ones(64), bank, device="meta")


# ------------------------------------------------- the wrappers' checks
def _operands(device="cpu", c=2, n=100, taps=31, wl=16):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 1 << wl, (c, n)).astype(np.int32))
    h = torch.from_numpy(rng.integers(0, 1 << wl, (c, taps)).astype(np.int32))
    hm, hn = t_rows.booth_precode(h, wl)
    return x.to(device), hm.to(device), hn.to(device)


def _bad_operands(x, hm, hn):
    """{label: (x, hm, hn, kwargs, error)} the wrappers must refuse."""
    kw = dict(wl=16, vbl=13, kind=0, shift=5)
    return {
        "dtype": (x.to(torch.int64), hm, hn, kw, TypeError),
        "float": (x.float(), hm, hn, kw, TypeError),
        "plane dtype": (x, hm.to(torch.int16), hn, kw, TypeError),
        "contiguity": (x.t().contiguous().t(), hm, hn, kw, ValueError),
        "plane contiguity": (x, hm.transpose(1, 2).contiguous()
                             .transpose(1, 2), hn, kw, ValueError),
        "x rank": (x[0], hm, hn, kw, ValueError),
        "plane rows": (x, hm[:7], hn[:7], kw, ValueError),
        "plane channels": (x, hm[:, :1], hn[:, :1], kw, ValueError),
        "plane mismatch": (x, hm, hn[:, :, :30].contiguous(), kw,
                           ValueError),
        "envelope": (x, hm, hn, dict(kw, shift=4), ValueError),
        "word length": (x, hm, hn, dict(kw, wl=18), ValueError),
    }


BAD = ["dtype", "float", "plane dtype", "contiguity", "plane contiguity",
       "x rank", "plane rows", "plane channels", "plane mismatch",
       "envelope", "word length"]


@pytest.mark.parametrize("wrapper", ["fir_bank_rows", "fir_bank_dot"])
@pytest.mark.parametrize("case", BAD)
def test_wrappers_refuse_bad_operands(wrapper, case):
    x, hm, hn, kw, err = _bad_operands(*_operands())[case]
    fn = getattr(t_fk, wrapper)
    before = fn.launches
    with pytest.raises(err):
        fn(x, hm, hn, **kw)
    assert fn.launches == before


def test_wrappers_run_plain_versions_on_cpu_without_counting():
    x, hm, hn = _operands()
    kw = dict(wl=16, vbl=13, kind=1, shift=5)
    before = (t_fk.fir_bank_rows.launches, t_fk.fir_bank_dot.launches)
    rows = t_fk.fir_bank_rows(x, hm, hn, **kw)
    dot = t_fk.fir_bank_dot(x, hm, hn, **kw)
    assert torch.equal(rows, t_fk.fir_bank_rows_plain(x, hm, hn, **kw))
    assert torch.equal(dot, rows)
    assert (t_fk.fir_bank_rows.launches, t_fk.fir_bank_dot.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["fir_bank_rows", "fir_bank_dot"])
def test_wrappers_refuse_bad_cuda_tensors(wrapper):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    fn = getattr(t_fk, wrapper)
    bad = _bad_operands(*_operands("cuda"))
    assert sorted(bad) == sorted(BAD)
    for x, hm, hn, kw, err in bad.values():
        with pytest.raises(err):
            fn(x, hm, hn, **kw)
    x, hm, hn = _operands("cuda")
    with pytest.raises(ValueError):
        fn(x, hm.cpu(), hn.cpu(), wl=16, vbl=13, kind=0, shift=5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [0, 1])
def test_kernels_equal_plain_versions_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, hm, hn = _operands("cuda", c=5, n=1500)
    kw = dict(wl=16, vbl=13, kind=kind, shift=5)
    want = t_fk.fir_bank_rows_plain(x, hm, hn, **kw)
    before = t_fk.fir_bank_rows.launches + t_fk.fir_bank_dot.launches
    assert torch.equal(t_fk.fir_bank_rows(x, hm, hn, **kw), want)
    assert torch.equal(t_fk.fir_bank_dot(x, hm, hn, **kw), want)
    torch.cuda.synchronize()
    assert t_fk.fir_bank_rows.launches + t_fk.fir_bank_dot.launches \
        == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mma", "cuda-core"])
@pytest.mark.parametrize("kind", [0, 1])
def test_fir_routes_equal_plain_versions_on_the_card(route, kind):
    """Both FIR wrappers forced onto each route: the tensor cores' split
    schedule (few tiles) and tiled one (70 channels), shifts up to vbl
    (and past it on the CUDA cores), each call counted once, the
    tensor-core share in ``mma_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for c, n in ((3, 1), (2, 4097), (70, 600)):
        x, hm, hn = _operands("cuda", c=c, n=n)
        for shift in (5, 13, 15):
            if route == "mma" and shift > 13:
                continue
            kw = dict(wl=16, vbl=13, kind=kind, shift=shift)
            want = t_fk.fir_bank_rows_plain(x, hm, hn, **kw)
            for name in ("fir_bank_rows", "fir_bank_dot"):
                fn, hook = getattr(t_fk, name), getattr(t_fk, f"_{name}_on")
                before = (fn.launches, fn.mma_launches)
                got = hook(route, x, hm, hn, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, c, n, shift)
                assert (fn.launches, fn.mma_launches) == (
                    before[0] + 1, before[1] + (route == "mma"))


@pytest.mark.cuda
def test_fir_rule_takes_the_tensor_cores_on_the_card():
    """The public wrappers take the rule's route: the tensor cores at
    shift <= vbl (faulted planes too), the CUDA cores past it; a forced
    tensor-core call past it raises and counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core.faults import FaultSpec, apply_plane_faults
    x, hm, hn = _operands("cuda", c=4, n=3000)
    fm, fn_ = apply_plane_faults(hm, hn, FaultSpec(
        target="plane", model="flip", p=0.05, lane="all", seed=3), vbl=13)
    for planes in ((hm, hn), (fm.contiguous(), fn_.contiguous())):
        for shift, mma in ((5, 1), (15, 0)):
            kw = dict(wl=16, vbl=13, kind=1, shift=shift)
            want = t_fk.fir_bank_rows_plain(x, *planes, **kw)
            for fn in (t_fk.fir_bank_rows, t_fk.fir_bank_dot):
                before = (fn.launches, fn.mma_launches)
                got = fn(x, *planes, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
                assert (fn.launches, fn.mma_launches) == (
                    before[0] + 1, before[1] + mma)
    before = (t_fk.fir_bank_rows.launches, t_fk.fir_bank_rows.mma_launches)
    with pytest.raises(ValueError, match="no contraction form"):
        t_fk._fir_bank_rows_on("mma", x, hm, hn, wl=16, vbl=13, shift=15)
    assert (t_fk.fir_bank_rows.launches,
            t_fk.fir_bank_rows.mma_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("wl", [8, 16])
def test_kernel_within_bound_of_plain_version_on_the_card(wl):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    from repro_torch.kernels.ref import amm_scale
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 896)).astype(
        np.float32)).cuda()
    w = torch.from_numpy((0.02 * rng.standard_normal((896, 200))).astype(
        np.float32)).cuda()
    mu, sigma = -18779.225471496582, 6859.595897768407
    sx, sw = amm_scale(x, wl), amm_scale(w, wl)
    before = t_qm.quant_matmul.launches
    got = t_qm.quant_matmul(x, w, sx, sw, mu, sigma, wl=wl, seed=3)
    want = t_qm.quant_matmul_plain(x, w, sx, sw, mu, sigma, wl=wl,
                                   seed=3, bm=128, bk=512, bn=128)
    tol = t_qm.quant_matmul_tolerance(x, w, sx, sw, mu, sigma, wl=wl)
    torch.cuda.synchronize()
    assert bool(((got.double() - want.double()).abs() <= tol).all())
    assert t_qm.quant_matmul.launches == before + 1
    w1, w2 = t_qm.hash_words(8, 200, 3, bm=8, bn=128)
    p1, p2 = t_qm.hash_words_plain(8, 200, 3, bm=8, bn=128, device="cuda")
    assert torch.equal(w1, p1) and torch.equal(w2, p2)


def _qm_operands(m, k, n, wl, seed=0):
    from repro_torch.kernels.ref import amm_scale
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.standard_normal((k, n))).astype(
        np.float32))
    x, w = x.cuda(), w.cuda()
    return x, w, amm_scale(x, wl), amm_scale(w, wl)


def _unaligned(t):
    """A contiguous view of t's values 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    off = next(i for i in range(1, 4) if (buf.data_ptr() + 4 * i) % 16)
    view = buf[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 7, 8, 9, 64, 65, 256])
@pytest.mark.parametrize("layout", ["aligned", "unaligned x"])
def test_quant_matmul_routes_on_the_card(m, layout):
    """Both routes around the decode threshold (64 rows), N = 130 (the
    scalar-load variants) and an x view off a 16-byte boundary: bit-equal
    to the plain version at wl 8 without noise, within the derived bound
    at wl 16 with noise; one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    assert t_qm.quant_matmul_plan(m, 896, 130).route == \
        ("decode" if m <= t_qm.DECODE_MAX_M else "tiled")
    for wl, mu, sigma in ((8, 0.0, 0.0),
                          (16, -18779.225471496582, 6859.595897768407)):
        x, w, sx, sw = _qm_operands(m, 896, 130, wl, seed=m)
        if layout == "unaligned x":
            x = _unaligned(x)
        before = t_qm.quant_matmul.launches
        got = t_qm.quant_matmul(x, w, sx, sw, mu, sigma, wl=wl, seed=3)
        want = t_qm.quant_matmul_plain(x, w, sx, sw, mu, sigma, wl=wl,
                                       seed=3, bm=128, bk=512, bn=128)
        tol = t_qm.quant_matmul_tolerance(x, w, sx, sw, mu, sigma, wl=wl)
        torch.cuda.synchronize()
        assert t_qm.quant_matmul.launches == before + 1
        if wl == 8:
            assert not tol.any() and torch.equal(got, want)
        else:
            assert bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 200])
def test_quant_matmul_carries_nan_and_inf_on_the_card(m):
    """A NaN in x spreads over its output row and one in w over its
    column, as the plain version's NaN codes do (the tiled route keeps
    them by flags, shared over its ranks at M = 200: integer codes hold
    no NaN); an infinity clips to the extreme code; every other output
    within the derived bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    x, w, sx, sw = _qm_operands(m, 896, 130, 16, seed=4)
    x[1, 5], x[2, 7], x[3, 600] = float("nan"), float("inf"), -float("inf")
    w[9, 3], w[700, 100] = float("nan"), float("inf")
    mu, sigma = -18779.225471496582, 6859.595897768407
    got = t_qm.quant_matmul(x, w, sx, sw, mu, sigma, wl=16, seed=3)
    want = t_qm.quant_matmul_plain(x, w, sx, sw, mu, sigma, wl=16, seed=3,
                                   bm=128, bk=512, bn=128)
    tol = t_qm.quant_matmul_tolerance(x, w, sx, sw, mu, sigma, wl=16)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert bool(nan[1].all()) and bool(nan[:, 3].all())
    assert int(nan.sum()) == 130 + m - 1
    assert torch.equal(torch.isnan(got), nan)
    err = (got.double() - want.double()).abs()
    assert bool((err[~nan] <= tol[~nan]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bk", [(256, 896, 4864, 512),
                                      (256, 4864, 896, 512),
                                      (100, 300, 70, 100)])
def test_tiled_route_is_its_emulation_bit_for_bit_on_the_card(m, k, n, bk):
    """The int8 tensor-core route forms each chunk partial as the exact
    sum rounded once: without noise it equals ``quant_matmul_emulated``
    bit for bit at every word length."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    plan = t_qm.quant_matmul_plan(m, k, n, bk)
    assert plan.route == "tiled"       # the route the wrapper takes
    for wl in (8, 12, 16):
        x, w, sx, sw = _qm_operands(m, k, n, wl, seed=wl)
        got = t_qm.quant_matmul(x, w, sx, sw, 0.0, 0.0, wl=wl, seed=3,
                                bk=bk)
        want = t_qm.quant_matmul_emulated(x, w, sx, sw, 0.0, 0.0, wl=wl,
                                          seed=3, bk=bk, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_quantizer_is_the_true_division_on_the_card():
    """The kernel's quotient (a reciprocal and two exact corrections)
    equals __fdiv_rn over every dividend significand, and its codes
    equal the CPU's true division over random float32 bit patterns."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    rng = np.random.default_rng(5)
    s = (1.0 + rng.random(64)) * np.exp2(rng.integers(-38, 38, 64))
    assert t_qm.quotient_mismatches(torch.tensor(
        s, dtype=torch.float32).cuda()) == 0
    bits = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(
        np.uint32)
    v = torch.from_numpy(bits.view(np.float32).copy())
    for scale in (2.7e-6, 1.0, 2.0 ** -39, 0.0):
        st = torch.tensor(scale, dtype=torch.float32)
        got = t_qm.quant_codes(v.cuda(), st.cuda(), 16).cpu()
        want = t_qm.quant_codes(v, st, 16)
        assert torch.equal(torch.nan_to_num(got, nan=0.5),
                           torch.nan_to_num(want, nan=0.5))


@pytest.mark.cuda
def test_amm_scale_in_one_pass_on_the_card():
    """The infinity-norm reduction is max|v| on the card too, NaN and
    infinities included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels.ref import amm_scale
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.standard_normal((64, 4864)).astype(
        np.float32)).cuda()
    for case in ("random", "zeros", "inf", "nan"):
        v = torch.zeros_like(base) if case == "zeros" else base.clone()
        if case in ("inf", "nan"):
            v[7, 99] = float(case)
        for dtype in (torch.float32, torch.bfloat16):
            vd = v.to(dtype)
            want = torch.clamp_min(torch.amax(torch.abs(vd.float()))
                                   * (1.0 / 32767), 1e-12)
            got = amm_scale(vd, 16)
            assert torch.equal(got, want) or (
                case == "nan" and bool(torch.isnan(got)) and bool(
                    torch.isnan(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("wl,vbl,kind", [(8, 5, 1), (12, 7, 0), (16, 13, 0),
                                         (16, 13, 1), (16, 0, 0)])
def test_bbm_dot_kernel_equals_plain_version_on_the_card(wl, vbl, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_bm = importlib.import_module("repro_torch.kernels.bbm_matmul")
    rng = np.random.default_rng(wl + vbl)
    lim = 1 << (wl - 1)
    for m, k, n in ((7, 50, 9), (70, t_rows.amm_chunk_len(wl, vbl) + 1, 65)):
        k = min(k, 3000)
        x = torch.from_numpy(rng.integers(-lim, lim, (m, k)).astype(
            np.int32)).cuda()
        w = torch.from_numpy(rng.integers(-lim, lim, (k, n)).astype(
            np.int32)).cuda()
        x[0], w[:, 0] = lim - 1, -lim
        before = t_bm.bbm_dot_scaled.launches
        got = t_bm.bbm_dot_scaled(x, w, wl=wl, vbl=vbl, kind=kind)
        # the plain version on the card needs an f32 envelope; without
        # one it runs on CPU copies
        on = "cuda" if t_rows.f32_exact_chunk_len(wl, vbl) else "cpu"
        want = t_bm.bbm_dot_scaled_plain(x.to(on), w.to(on), wl=wl, vbl=vbl,
                                         kind=kind)
        torch.cuda.synchronize()
        assert torch.equal(got.to(on), want)
        assert t_bm.bbm_dot_scaled.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_within_bound_of_plain_versions_on_the_card(causal):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_fa = importlib.import_module("repro_torch.kernels.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 3, 200, 64), generator=g, device="cuda")
               for _ in range(3))
    before = (t_fa.flash_attention.launches,
              t_fa.flash_attention_amm.launches)
    got = t_fa.flash_attention(q, k, v, causal=causal)
    want = t_fa.flash_attention_plain(q, k, v, causal=causal)
    assert bool(((got.double() - want.double()).abs()
                 <= t_fa.flash_tolerance(q, k, v)).all())
    for kind in (0, 1):
        got, res = t_fa.flash_attention_amm(q, k, v, wl=16, vbl=13,
                                            kind=kind, causal=causal,
                                            residuals=True)
        ops = t_fa.flash_amm_operands(q, k, v, wl=16)
        want, wres = t_fa.flash_amm_plain(ops, wl=16, vbl=13, kind=kind,
                                          causal=causal, residuals=True)
        rep = t_fa.flash_amm_compare(
            ops, dict(res, out=got.reshape(6, 200, 64)),
            dict(wres, out=want[:, :200]), wl=16, vbl=13, causal=causal)
        assert rep["ok"], rep
    assert (t_fa.flash_attention.launches,
            t_fa.flash_attention_amm.launches) == (before[0] + 1,
                                                   before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads,kv,d", [(32, 32, 80), (48, 8, 128)])
def test_flash_kernels_at_head_dims_80_and_128_on_the_card(heads, kv, d,
                                                           causal):
    """Both flash kernels at zamba2's head dim (80) and grok-1's (128,
    48 / 8 heads, the KV heads repeated as ``attention`` repeats them), a
    ragged 200 positions, within their bounds of their plain versions;
    one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_fa = importlib.import_module("repro_torch.kernels.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((1, 200, heads, d), generator=g, device="cuda")
    k, v = (torch.repeat_interleave(
        torch.randn((1, 200, kv, d), generator=g, device="cuda"),
        heads // kv, dim=2).transpose(1, 2) for _ in range(2))
    q = q.transpose(1, 2)
    before = (t_fa.flash_attention.launches,
              t_fa.flash_attention_amm.launches)
    got = t_fa.flash_attention(q, k, v, causal=causal)
    want = t_fa.flash_attention_plain(q, k, v, causal=causal)
    assert bool(((got.double() - want.double()).abs()
                 <= t_fa.flash_tolerance(q, k, v)).all())
    got, res = t_fa.flash_attention_amm(q, k, v, wl=16, vbl=13, kind=0,
                                        causal=causal, residuals=True)
    ops = t_fa.flash_amm_operands(q, k, v, wl=16)
    want, wres = t_fa.flash_amm_plain(ops, wl=16, vbl=13, kind=0,
                                      causal=causal, residuals=True)
    rep = t_fa.flash_amm_compare(
        ops, dict(res, out=got.reshape(heads, 200, d)),
        dict(wres, out=want[:, :200]), wl=16, vbl=13, causal=causal)
    assert rep["ok"], rep
    assert (t_fa.flash_attention.launches,
            t_fa.flash_attention_amm.launches) == (before[0] + 1,
                                                   before[1] + 1)


@pytest.mark.cuda
def test_chunked_amm_attention_on_the_card_matches_the_cpu():
    """The chunked amm path (no flash) runs every block's products on the
    batched ``bbm_dot_coded_batched`` kernel, one launch per product over
    all (batch, kv-head) slices; the card agrees with the CPU by
    ``flash_amm_compare`` (same codes, float sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    from repro_torch.configs.base import AmmConfig
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.common import AmmRuntime
    t_bm = importlib.import_module("repro_torch.kernels.bbm_matmul")
    t_fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rt = AmmRuntime.build(AmmConfig(mode="bitexact", mul="bbm1", wl=16,
                                    param=13, apply_to="all"))
    g = torch.Generator().manual_seed(1)
    q = torch.randn((1, 40, 4, 64), generator=g)
    k, v = (torch.randn((1, 40, 2, 64), generator=g) for _ in range(2))
    before = (t_bm.bbm_dot_scaled.launches,
              t_bm.bbm_dot_coded_batched.launches)
    got = chunked_attention(q.cuda(), k.cuda(), v.cuda(), causal=True,
                            bq=16, bk=16, amm=rt)
    torch.cuda.synchronize()
    # 3 x 3 block pairs, 2 products each, both (batch, kv-head) slices in
    # one launch
    assert (t_bm.bbm_dot_scaled.launches,
            t_bm.bbm_dot_coded_batched.launches) == (before[0],
                                                     before[1] + 18)
    from torch_amm_capture import chunked_residuals, port_amm_dot_records
    runs = []
    for dev in ("cuda", "cpu"):
        with port_amm_dot_records() as recs:
            out = chunked_attention(q.to(dev), k.to(dev), v.to(dev),
                                    causal=True, bq=16, bk=16, amm=rt)
        recs = [tuple(t.cpu() for t in rec) for rec in recs]
        runs.append(chunked_residuals(recs, (1, 40, 4, 64, 40, 2), out.cpu(),
                                      wl=16, bq=16, bk=16))
        if dev == "cuda":
            assert torch.equal(out, got)     # the records change nothing
    (ops, card, q_pos), (_, cpu, _) = runs
    rep = t_fa.flash_amm_compare(ops, card, cpu, wl=16, vbl=13, causal=True,
                                 q_pos=q_pos)
    assert rep["ok"], rep


@pytest.mark.cuda
def test_flash_amm_gradient_on_the_card_matches_the_cpu():
    """The straight-through backward from the kernel's residuals against
    the same backward from the plain version's: 2^-8 of the largest
    gradient (the residual P V products differ where a P code moves,
    within the flash-amm bound, and f32 sums run in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.configs.base import AmmConfig
    from repro_torch.models.attention import _flash_amm_ste
    from repro_torch.models.common import AmmRuntime
    rt = AmmRuntime.build(AmmConfig(mode="bitexact", mul="bbm0", wl=16,
                                    param=13, apply_to="all"))
    g = torch.Generator().manual_seed(2)
    qkv = [torch.randn((1, 2, 200, 64), generator=g) for _ in range(3)]
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in qkv]
        loss = torch.sum(torch.square(_flash_amm_ste(rt, True, *leaves)))
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 2.0 ** -8 * scale


# ------------------------------------------- the matmul wrappers' checks
MATMUL_WRAPPERS = ["bbm_matmul_rows", "bbm_matmul_dot", "bbm_dot_planes"]


def _tb():
    import importlib
    return importlib.import_module("repro_torch.kernels.bbm_matmul")


def _matmul_operands(device="cpu", m=9, k=40, n=70, wl=16, seed=0):
    rng = np.random.default_rng(seed)
    lim = 1 << (wl - 1)
    x = torch.from_numpy(rng.integers(-lim, lim, (m, k)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-lim, lim, (k, n)).astype(np.int32))
    x[0], w[:, 0] = -lim, -lim
    hm, hn = t_rows.booth_precode(w, wl)
    return x.to(device), hm.to(device), hn.to(device)


def _bad_matmul_operands(wrapper, x, hm, hn):
    """{label: (x, hm, hn, kwargs, error)} a matmul wrapper must refuse."""
    kw = dict(wl=16, vbl=13, kind=0)
    if wrapper != "bbm_dot_planes":
        kw["shift"] = 15
    bad = {
        "dtype": (x.to(torch.int64), hm, hn, kw, TypeError),
        "float": (x.float(), hm, hn, kw, TypeError),
        "plane dtype": (x, hm.to(torch.int16), hn, kw, TypeError),
        "contiguity": (x.t().contiguous().t(), hm, hn, kw, ValueError),
        "plane contiguity": (x, hm.transpose(1, 2).contiguous()
                             .transpose(1, 2), hn, kw, ValueError),
        "x rank": (x[0], hm, hn, kw, ValueError),
        "plane rows": (x, hm[:7], hn[:7], kw, ValueError),
        "plane depth": (x, hm[:, :-1].contiguous(), hn[:, :-1].contiguous(),
                        kw, ValueError),
        "plane mismatch": (x, hm, hn[:, :, :30].contiguous(), kw,
                           ValueError),
        "word length": (x, hm, hn, dict(kw, wl=18), ValueError),
        "kind": (x, hm, hn, dict(kw, kind=2), ValueError),
    }
    if wrapper == "bbm_dot_planes":
        bad["vbl"] = (x, hm, hn, dict(kw, vbl=16), ValueError)
    else:
        bad["envelope"] = (x, hm, hn, dict(kw, shift=1), ValueError)
    return bad


MATMUL_BAD = ["dtype", "float", "plane dtype", "contiguity",
              "plane contiguity", "x rank", "plane rows", "plane depth",
              "plane mismatch", "word length", "kind", "limit"]


@pytest.mark.parametrize("wrapper", MATMUL_WRAPPERS)
@pytest.mark.parametrize("case", MATMUL_BAD)
def test_matmul_wrappers_refuse_bad_operands(wrapper, case):
    bad = _bad_matmul_operands(wrapper, *_matmul_operands())
    if case == "limit":          # the envelope, or vbl for the f32 entry
        (case,) = set(bad) - set(MATMUL_BAD)
    x, hm, hn, kw, err = bad[case]
    fn = getattr(_tb(), wrapper)
    before = fn.launches
    with pytest.raises(err):
        fn(x, hm, hn, **kw)
    assert fn.launches == before


@pytest.mark.parametrize("wrapper", MATMUL_WRAPPERS)
@pytest.mark.parametrize("wl,vbl,shift", [(16, 13, 15), (12, 7, 9)])
def test_matmul_wrappers_run_plain_versions_on_cpu_without_counting(
        wrapper, wl, vbl, shift):
    tb = _tb()
    x, hm, hn = _matmul_operands(wl=wl)
    kw = dict(wl=wl, vbl=vbl, kind=1)
    if wrapper != "bbm_dot_planes":
        kw["shift"] = shift
    fn = getattr(tb, wrapper)
    before = fn.launches
    assert torch.equal(fn(x, hm, hn, **kw),
                       getattr(tb, wrapper + "_plain")(x, hm, hn, **kw))
    assert fn.launches == before


@pytest.mark.parametrize("wrapper", ["bbm_matmul_rows", "bbm_matmul_dot"])
@pytest.mark.parametrize("mkn", [(0, 5, 4), (3, 0, 4), (3, 5, 0)])
def test_matmul_launcher_counts_nothing_when_nothing_launches(wrapper, mkn):
    """An empty output or K = 0 returns before the library is reached and
    adds nothing to the count (meta tensors stand in for CUDA ones)."""
    tb = _tb()
    fn = getattr(tb, wrapper)
    m, k, n = mkn
    x = torch.zeros((m, k), dtype=torch.int32, device="meta")
    planes = torch.zeros((8, k, n), dtype=torch.int32, device="meta")
    before = fn.launches
    out = tb._launch_matmul(fn, x, planes, planes, wl=16, vbl=13, kind=0,
                            shift=15)
    assert tuple(out.shape) == (m, n) and out.dtype == torch.int32
    assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", MATMUL_WRAPPERS)
def test_matmul_wrappers_refuse_bad_cuda_tensors(wrapper):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    fn = getattr(_tb(), wrapper)
    bad = _bad_matmul_operands(wrapper, *_matmul_operands("cuda"))
    assert len(bad) == len(MATMUL_BAD)
    before = fn.launches
    for x, hm, hn, kw, err in bad.values():
        with pytest.raises(err):
            fn(x, hm, hn, **kw)
    x, hm, hn = _matmul_operands("cuda")
    with pytest.raises(ValueError):
        fn(x, hm.cpu(), hn.cpu(), wl=16, vbl=13, kind=0)
    assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", MATMUL_WRAPPERS)
def test_matmul_wrappers_count_no_launch_for_empty_work_on_the_card(wrapper):
    """M = 0, N = 0 or K = 0 on the card: the right empty or zero result,
    no launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    fn = getattr(_tb(), wrapper)
    kw = dict(wl=16, vbl=13, kind=0)
    if wrapper != "bbm_dot_planes":
        kw["shift"] = 15
    before = fn.launches
    for m, k, n in ((0, 5, 4), (3, 0, 4), (3, 5, 0)):
        x = torch.zeros((m, k), dtype=torch.int32, device="cuda")
        planes = torch.zeros((8, k, n), dtype=torch.int32, device="cuda")
        out = fn(x, planes, planes, **kw)
        assert tuple(out.shape) == (m, n)
        assert int(torch.count_nonzero(out)) == 0
    assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [0, 1])
def test_matmul_kernels_equal_plain_versions_on_the_card(kind):
    """``bbm_matmul_rows`` and ``bbm_matmul_dot`` on clean and faulted
    planes, ragged shapes, shifts below, at and above vbl."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core.faults import FaultSpec, apply_plane_faults
    tb = _tb()
    x, hm, hn = _matmul_operands("cuda", m=70, k=37, n=130)
    before = (tb.bbm_matmul_rows.launches, tb.bbm_matmul_dot.launches)
    cases = 0
    for fault in (None, FaultSpec(p=0.1, seed=3)):
        fm, fn = (t.contiguous() for t in apply_plane_faults(hm, hn, fault,
                                                             vbl=13))
        for shift in (12, 13, 15):
            kw = dict(wl=16, vbl=13, kind=kind, shift=shift)
            want = tb.bbm_matmul_rows_plain(x, fm, fn, **kw)
            assert torch.equal(tb.bbm_matmul_rows(x, fm, fn, **kw), want)
            assert torch.equal(tb.bbm_matmul_dot(x, fm, fn, **kw), want)
            assert torch.equal(tb.bbm_matmul_dot_plain(x, fm, fn, **kw),
                               want)
            cases += 1
    torch.cuda.synchronize()
    assert (tb.bbm_matmul_rows.launches, tb.bbm_matmul_dot.launches) == (
        before[0] + cases, before[1] + cases)


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["plane", "acc"])
def test_faulted_datapath_on_the_card_equals_the_plain_version(target):
    """``bbm_matmul_dynamic(fault=)`` launches the planes-in kernel and
    equals the CPU port (the plain version) bit for bit, at bbm0 and at
    exact Booth (a chunk of one product, a key per product)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core.faults import FaultSpec
    tb = _tb()
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((4, 70)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((70, 8)).astype(np.float32))
    fault = FaultSpec(target=target, p=0.3, bit=10, seed=9)
    for vbl in (13, 0):
        before = tb.bbm_dot_planes.launches
        got = tb.bbm_matmul_dynamic(a.cuda(), b.cuda(), wl=16, vbl=vbl,
                                    fault=fault)
        want = tb.bbm_matmul_dynamic(a, b, wl=16, vbl=vbl, fault=fault)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert tb.bbm_dot_planes.launches == before + 1


# --------------------------------------------------------------- the build
def test_build_directory_is_git_ignored():
    ignored = [ln.strip().rstrip("/") for ln in
               (ROOT / ".gitignore").read_text().splitlines()
               if ln.strip() and not ln.startswith("#")]
    rel = _build.BUILD_DIR.relative_to(ROOT).as_posix()
    assert any(rel == p or rel.startswith(p + "/") for p in ignored), rel
    assert "chiprun_out" in ignored
    for name in ("fir_bank", "quant_matmul", "bbm_dot", "bbm_matmul",
                 "flash_attention", "flash_attention_wide"):
        assert _build.SOURCES[name].is_file()
        assert _build.SOURCES[name].relative_to(PKG).as_posix() \
            == f"kernels/csrc/{name}.cu"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ------------------------------- the routes of the contracted dot form
@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mma", "tile"])
@pytest.mark.parametrize("wl,vbl,kind", [(8, 5, 0), (12, 7, 1), (16, 13, 0),
                                         (16, 13, 1)])
def test_bbm_dot_routes_equal_plain_versions_on_the_card(route, wl, vbl,
                                                         kind):
    """Each route of ``bbm_dot_scaled`` and of ``bbm_dot_planes`` (clean,
    plane-faulted and accumulator-faulted planes), forced, bit-equal to
    the plain version on ragged shapes, K one past a chunk where the
    chunk is short; ``mma_launches`` counts the tensor-core launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core.faults import FaultSpec, apply_plane_faults
    tb = _tb()
    rng = np.random.default_rng(wl + vbl + kind)
    lim = 1 << (wl - 1)
    chunk = t_rows.amm_chunk_len(wl, vbl)
    for m, k, n in ((7, 50, 9), (130, 97, 131),
                    (5, chunk + 1 if chunk < 40_000 else 45, 7)):
        x = torch.from_numpy(rng.integers(-lim, lim, (m, k)).astype(
            np.int32)).cuda()
        w = torch.from_numpy(rng.integers(-lim, lim, (k, n)).astype(
            np.int32)).cuda()
        x[0], w[:, 0] = lim - 1, -lim
        before = (tb.bbm_dot_scaled.launches, tb.bbm_dot_scaled.mma_launches)
        got = tb._bbm_dot_scaled_on(route, x, w, wl=wl, vbl=vbl, kind=kind)
        want = tb.bbm_dot_scaled_plain(x, w, wl=wl, vbl=vbl, kind=kind)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert (tb.bbm_dot_scaled.launches, tb.bbm_dot_scaled.mma_launches) \
            == (before[0] + 1, before[1] + (route == "mma"))
        hm, hn = t_rows.booth_precode(w, wl)
        for fault in (None, FaultSpec(target="plane", p=0.1, seed=k),
                      FaultSpec(target="acc", p=0.1, bit=11, seed=k)):
            fm, fn = (t.contiguous() for t in apply_plane_faults(
                hm, hn, fault, vbl=vbl))
            acc = fault if fault is not None and fault.target == "acc" \
                else None
            got = tb._bbm_dot_planes_on(route, x, fm, fn, wl=wl, vbl=vbl,
                                        kind=kind, fault=acc)
            want = tb.bbm_dot_planes_plain(x, fm, fn, wl=wl, vbl=vbl,
                                           kind=kind, fault=acc)
            torch.cuda.synchronize()
            assert torch.equal(got, want), fault


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mma", "tile"])
@pytest.mark.parametrize("kind", [0, 1])
def test_bbm_matmul_dot_routes_equal_plain_versions_on_the_card(route, kind):
    """``bbm_matmul_dot`` forced onto each route at shifts up to vbl, on
    clean and faulted planes, bit-equal to the plain rows form; the
    tile alone at shift > vbl."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core.faults import FaultSpec, apply_plane_faults
    tb = _tb()
    x, hm, hn = _matmul_operands("cuda", m=130, k=37, n=131)
    for fault in (None, FaultSpec(p=0.1, seed=5)):
        fm, fn = (t.contiguous() for t in apply_plane_faults(hm, hn, fault,
                                                             vbl=13))
        for shift in (12, 13, 15):
            kw = dict(wl=16, vbl=13, kind=kind, shift=shift)
            if shift > 13 and route == "mma":
                continue
            before = tb.bbm_matmul_dot.mma_launches
            got = tb._bbm_matmul_dot_on(route, x, fm, fn, **kw)
            want = tb.bbm_matmul_rows_plain(x, fm, fn, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (fault, shift)
            assert tb.bbm_matmul_dot.mma_launches == before + (
                route == "mma")


@pytest.mark.cuda
def test_the_tensor_cores_refuse_what_they_cannot_compute_on_the_card():
    """Forced onto the tensor cores, a call whose x and bq both take two
    bytes, or ``bbm_matmul_dot`` at shift > vbl, raises before any
    launch; the rule sends both to the tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tb = _tb()
    x, hm, hn = _matmul_operands("cuda", m=9, k=40, n=70)
    w = torch.zeros((40, 70), dtype=torch.int32, device="cuda")
    before = (tb.bbm_dot_scaled.launches, tb.bbm_matmul_dot.launches)
    with pytest.raises(ValueError, match="third significance"):
        tb._bbm_dot_scaled_on("mma", x, w, wl=16, vbl=3, kind=0)
    with pytest.raises(ValueError, match="no contraction form"):
        tb._bbm_matmul_dot_on("mma", x, hm, hn, wl=16, vbl=13, shift=15)
    assert (tb.bbm_dot_scaled.launches, tb.bbm_matmul_dot.launches) == before
    assert tb.bbm_dot_route(16, 3, 0) == "tile"
    assert tb.bbm_dot_route(16, 13, 0, shift=15) == "tile"


# ------------------------------------- the batched codes-in entry (slice 5)
def _coded_operands(device, *, wl=16, b=4, kvh=2, g=7, d=64, s=96, seed=3):
    """Decode attention's two coded products over a code cache of S
    positions: ragged lengths (1 and S among them) over stale codes, and
    never-written (0.0) blocks past the live ones of every other slot."""
    from repro_torch.kernels.ref import amm_quantize_slices
    rng = np.random.default_rng(seed)
    lim = 2 ** (wl - 1) - 1
    dt = torch.int16 if wl > 8 else torch.int8
    kv_len = np.array([1, 37, 50, s][:b], np.int64)
    codes = {side: torch.from_numpy(rng.integers(
        -lim - 1, lim + 1, (b, s, kvh, d))).to(dt) for side in "kv"}
    scales = {}
    for side in "kv":
        sc = rng.uniform(1e-3, 0.1, (b, s // 16, kvh)).astype(np.float32)
        for i in range(1, b, 2):
            sc[i, -(-int(kv_len[i]) // 16):] = 0.0
        scales[side] = torch.from_numpy(sc)
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, d)).astype(
        np.float32))
    p = torch.from_numpy(rng.uniform(0, 1, (b, kvh, g, s)).astype(
        np.float32))
    aq, s_a = amm_quantize_slices(q, wl)
    pq, s_p = amm_quantize_slices(p, wl)
    calls = {"qk": (aq, s_a, codes["k"].permute(0, 2, 3, 1),
                    scales["k"].permute(0, 2, 1), "column"),
             "pv": (pq, s_p, codes["v"].permute(0, 2, 1, 3),
                    scales["v"].permute(0, 2, 1), "kblock")}
    live = torch.from_numpy(kv_len)
    move = lambda t: t.to(device)  # noqa: E731
    return ({k: tuple(move(t) if isinstance(t, torch.Tensor) else t
                      for t in v) for k, v in calls.items()}, move(live))


def test_coded_batched_runs_its_plain_version_on_cpu_without_counting():
    import importlib
    t_bm = importlib.import_module("repro_torch.kernels.bbm_matmul")
    calls, live = _coded_operands("cpu", s=48)
    before = t_bm.bbm_dot_coded_batched.launches
    for a, s_a, b, s_b, per in calls.values():
        kw = dict(wl=16, vbl=13, kind=1, block=16, per=per, live=live)
        assert torch.equal(t_bm.bbm_dot_coded_batched(a, s_a, b, s_b, **kw),
                           t_bm.bbm_dot_coded_batched_plain(a, s_a, b, s_b,
                                                            **kw))
    assert t_bm.bbm_dot_coded_batched.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("wl,vbl,kind", [(16, 13, 0), (16, 13, 1),
                                         (16, 3, 0), (8, 5, 1)])
def test_coded_batched_equals_plain_version_on_the_card(wl, vbl, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    t_bm = importlib.import_module("repro_torch.kernels.bbm_matmul")
    calls, live = _coded_operands("cuda", wl=wl)
    before = t_bm.bbm_dot_coded_batched.launches
    for a, s_a, b, s_b, per in calls.values():
        kw = dict(wl=wl, vbl=vbl, kind=kind, block=16, per=per)
        got = t_bm.bbm_dot_coded_batched(a, s_a, b, s_b, live=live, **kw)
        want = t_bm.bbm_dot_coded_batched_plain(
            a.cpu(), s_a.cpu(), b.cpu(), s_b.cpu(), live=live.cpu(), **kw)
        assert torch.equal(got.cpu(), want)
        # unit scales leave yq: bbm_dot_scaled of each slice
        unit = dict(wl=wl, vbl=vbl, kind=kind, block=1)
        ones_a = torch.ones_like(s_a)
        ones_b = torch.ones((*b.shape[:2], b.shape[3]), device=b.device)
        yq = t_bm.bbm_dot_coded_batched(a, ones_a, b, ones_b, **unit)
        assert torch.equal(yq.cpu(), t_bm.bbm_dot_coded_batched_plain(
            a.cpu(), ones_a.cpu(), b.cpu(), ones_b.cpu(), **unit))
        assert torch.equal(yq[1, 0].cpu(), t_bm.bbm_dot_scaled_plain(
            a[1, 0].cpu(), b[1, 0].cpu().to(torch.int32).contiguous(),
            wl=wl, vbl=vbl, kind=kind))
    torch.cuda.synchronize()
    assert t_bm.bbm_dot_coded_batched.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("check", sorted(CARD_CHECKS))
def test_coded_batched_routes_on_the_card(check):
    """The tensor-core route at the main path's decode shapes and at
    ``amm_dot``'s prefill pair, and the CUDA-core route where the rule
    sends it (``tests/torch_coded_card.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    CARD_CHECKS[check]()


@pytest.mark.cuda
def test_decode_attention_codes_on_the_card_equals_the_cpu():
    """The whole code-domain decode (quantizers, softmax, both launches)
    on the card against the CPU port.  The products are integer and
    descale alike; only the softmax's last bits may differ, moving a P
    code by one, which moves a value product by at most |v| + 2^(vbl +
    2) (the step of p*v plus both truncations) times s_p and the largest
    V block scale: at most S such moves a row, and 2^-20 more for the P
    scale's rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.configs.base import AmmConfig
    from repro_torch.models.attention import decode_attention_codes
    from repro_torch.models.common import AmmRuntime
    amm = AmmRuntime.build(AmmConfig(mode="bitexact", mul="bbm0", wl=16,
                                     param=13, apply_to="attn"))
    calls, live = _coded_operands("cpu")
    cache = {"k_codes": calls["qk"][2].permute(0, 3, 1, 2),
             "k_scale": calls["qk"][3].permute(0, 2, 1),
             "v_codes": calls["pv"][2].permute(0, 2, 1, 3),
             "v_scale": calls["pv"][3].permute(0, 2, 1)}
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 1, 14, 64)).astype(np.float32))
    want = decode_attention_codes(q, cache, live, amm=amm)
    got = decode_attention_codes(q.cuda(), {k: v.cuda() for k, v in
                                            cache.items()}, live.cuda(),
                                 amm=amm)
    b, s = cache["v_codes"].shape[:2]
    lim = 2 ** 15 - 1                     # s_p = max p / lim <= 1 / lim
    v = cache["v_codes"].double().abs().amax(dim=(1, 3))        # (B, KV)
    sv = cache["v_scale"].double().amax(dim=1)
    bound = s * (v + 2.0 ** (13 + 2)) / lim * sv * (1 + 2.0 ** -20)
    err = (got.cpu() - want).double().abs().reshape(b, 2, 7, 64)
    assert (err.amax(dim=(2, 3)) <= bound).all()


# ------------------------------------------------- the normal-draw kernel
NORMAL_SHAPES = [(7,), (3, 5, 11), (8, 1, 4864), (2, 300, 1000)]


def test_normal_draw_runs_its_plain_version_on_cpu_without_counting():
    from repro_torch.core import prng
    from repro_torch.kernels.normal import normal_draw
    before = normal_draw.launches
    z = normal_draw(prng.key(4), (3, 5), device="cpu")
    assert torch.equal(z, prng.normal_plain(prng.key(4), (3, 5)))
    acc = torch.ones((3, 5))
    normal_draw(prng.key(4), (3, 5), acc=acc, c1=2.0, c2=3.0)
    assert normal_draw.launches == before
    with pytest.raises(ValueError, match="contiguous float32"):
        normal_draw(prng.key(4), (3, 5), acc=torch.ones((5, 3)).T)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NORMAL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_normal_kernel_equals_plain_version_on_the_card(shape):
    """Every bit, the draw and both epilogues, one counted launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import prng
    from repro_torch.kernels.normal import normal_draw
    gen = torch.Generator().manual_seed(len(shape))
    acc = torch.randn(shape, generator=gen) * 1e5
    for k in (prng.key(0), prng.split(prng.key(7))[1], (0xFFFFFFFF, 3)):
        before = normal_draw.launches
        got = normal_draw(k, shape)
        assert got.is_cuda and normal_draw.launches == before + 1
        want = prng.normal_plain(k, shape)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        for order in ("acc", "noise"):
            dev_acc = acc.cuda()
            out = normal_draw(k, shape, acc=dev_acc, c1=-3.7e3, c2=1.2e4,
                              order=order)
            assert out.data_ptr() == dev_acc.data_ptr()
            want = prng.normal_plain(k, shape, acc=acc, c1=-3.7e3,
                                     c2=1.2e4, order=order)
            assert torch.equal(out.cpu().view(torch.int32),
                               want.view(torch.int32)), order
    assert normal_draw(prng.key(1), (0, 3)).numel() == 0


@pytest.mark.cuda
def test_normal_transform_on_the_card_all_2_23():
    """The kernel's arithmetic from given bits, over every uniform."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import prng
    from repro_torch.kernels.normal import normal_bits
    bits = torch.arange(1 << 23, dtype=torch.int64) << 9 | 0x155
    got = normal_bits(bits.cuda()).cpu()
    want = prng.normal_from_bits(bits)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
