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
                                   "run_filter_case"])
def test_entry_points_default_to_the_gpu(entry):
    h = t_fir.design_lowpass()
    x = np.ones((2, 64))
    codes = np.ones((2, 64), np.int32)
    planes = np.zeros((8, 2, 31), np.int32)
    from repro_torch.dsp.testbed import run_filter_case
    calls = {
        "fir_apply": lambda **kw: t_fir.fir_apply(x, h, SPEC, **kw),
        "PrecodedBank": lambda **kw: t_fir.PrecodedBank(h, SPEC, **kw),
        "FilterbankEngine": lambda **kw: FilterbankEngine(h, SPEC, **kw),
        "fir_filterbank": lambda **kw: t_ops.fir_filterbank(
            codes, codes[:, :31], wl=16, vbl=13, shift=5, **kw),
        "fir_filterbank_precoded": lambda **kw: t_ops.fir_filterbank_precoded(
            codes, planes, planes, wl=16, vbl=13, shift=5, **kw),
        "run_filter_case": lambda **kw: run_filter_case(SPEC, **kw),
    }
    with _no_gpu():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry](device="cuda")
        calls[entry](device="cpu")      # the plain versions need no card


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


# --------------------------------------------------------------- the build
def test_build_directory_is_git_ignored():
    ignored = [ln.strip().rstrip("/") for ln in
               (ROOT / ".gitignore").read_text().splitlines()
               if ln.strip() and not ln.startswith("#")]
    rel = _build.BUILD_DIR.relative_to(ROOT).as_posix()
    assert any(rel == p or rel.startswith(p + "/") for p in ignored), rel
    assert "chiprun_out" in ignored
    assert _build.SOURCES["fir_bank"].is_file()
    assert _build.SOURCES["fir_bank"].relative_to(PKG).as_posix() \
        == "kernels/csrc/fir_bank.cu"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
