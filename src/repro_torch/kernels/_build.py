"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each source under ``csrc/`` compiles into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [<the source's own flags>]
         -o <lib>.so csrc/<name>.cu

The flash library of head dims 80 and 128, the slowest source with ten
heavy kernels, alone adds ``-split-compile=0`` (its kernels optimized on
every core); ``chip_smoke.py`` prints the whole build's time.

Libraries land in ``build/repro_torch_kernels/`` at the repository root
(git-ignored), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing compiles at
import time: ``library(name)`` builds on first use, and ``build_all()``
starts one nvcc per unbuilt source, all at once, for callers that want
the whole build up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"fir_bank": CSRC / "fir_bank.cu",
           "quant_matmul": CSRC / "quant_matmul.cu",
           "bbm_dot": CSRC / "bbm_dot.cu",
           "bbm_matmul": CSRC / "bbm_matmul.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "flash_attention_wide": CSRC / "flash_attention_wide.cu",
           "normal": CSRC / "normal.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source beside NVCC_FLAGS
SOURCE_FLAGS = {"flash_attention_wide": ["-split-compile=0"]}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
# C signatures of every exported function, per library
_SIGNATURES = {
    "fir_bank": {
        "fir_bank_rows_launch": ([_P, _P, _P, _P] + [_I] * 7 + [_P], _I),
        "fir_bank_dot_launch": ([_P] * 5 + [_I] * 7 + [_P], _I),
        "fir_bank_mma_launch": ([_P, _P, _P, _P] + [_I] * 7 + [_P], _I),
        "fir_bank_error_string": ([_I], ctypes.c_char_p),
    },
    "quant_matmul": {
        "quant_matmul_launch": ([_P] * 5 + [_I] * 7 + [_U, _F, _F]
                                + [_I] * 4 + [_P], _I),
        "qm_hash_words_launch": ([_P, _P] + [_I] * 4 + [_U, _P], _I),
        "qm_quotient_check_launch": ([_P, _I, _P, _P], _I),
        "qm_codes_launch": ([_P, _P, _P, ctypes.c_longlong, _I, _P], _I),
        "quant_matmul_error_string": ([_I], ctypes.c_char_p),
    },
    "bbm_dot": {
        "bbm_dot_scaled_launch": ([_P] * 3 + [_I] * 8 + [_P], _I),
        "bbm_dot_planes_launch": ([_P] * 4 + [_F, _I, _P] + [_I] * 8 + [_P],
                                  _I),
        "bbm_dot_scaled_mma_launch": ([_P] * 3 + [_I] * 7 + [_P], _I),
        "bbm_dot_planes_mma_launch": ([_P] * 5 + [_F, _I, _P] + [_I] * 7
                                      + [_P], _I),
        "bbm_dot_coded_batched_launch": ([_P] * 3 + [_I] + [_L] * 4 + [_P]
                                         + [_L] * 3 + [_P] * 2 + [_I] * 12
                                         + [_P], _I),
        "bbm_dot_coded_mma_launch": ([_P] * 3 + [_I] + [_L] * 4 + [_P]
                                     + [_L] * 3 + [_P] * 2 + [_I] * 11
                                     + [_P], _I),
        "bbm_empty_launch": ([_P], _I),
        "bbm_dot_error_string": ([_I], ctypes.c_char_p),
    },
    "bbm_matmul": {
        "bbm_matmul_rows_launch": ([_P] * 4 + [_I] * 7 + [_P], _I),
        "bbm_matmul_dot_launch": ([_P] * 4 + [_I] * 8 + [_P], _I),
        "bbm_matmul_dot_mma_launch": ([_P] * 5 + [_I] * 7 + [_P], _I),
        "bbm_matmul_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention": {
        "flash_attention_launch": ([_P] * 4 + [_I] * 5 + [_F, _I, _P], _I),
        "flash_attention_amm_launch": ([_P] * 14 + [_I] * 13 + [_F, _I, _P],
                                       _I),
        "flash_attention_error_string": ([_I], ctypes.c_char_p),
    },
    "normal": {
        "normal_launch": ([_P, _L, _U, _U, _I, _F, _F, _P], _I),
        "normal_bits_launch": ([_P, _P, _L, _P], _I),
        "normal_error_string": ([_I], ctypes.c_char_p),
    },
}

# the head dims 80 and 128 of the flash kernels: the same entry points
_SIGNATURES["flash_attention_wide"] = _SIGNATURES["flash_attention"]

_LIBS: dict = {}
_LOCK = threading.Lock()
BUILD_LOGS: dict = {}      # name -> nvcc's stderr (ptxas register report)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in src/repro_torch/kernels/csrc")


def _flags(name: str) -> list:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every unbuilt library in parallel; returns {name: path}.

    One nvcc process per source, all started before any is waited on.
    Raises with nvcc's output when a compile fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    jobs = {}
    for n in names:
        if paths[n].is_file():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *_flags(n), "-o", tmp, str(SOURCES[n])]
        jobs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True))
    failed = []
    for n, (tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])     # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib
