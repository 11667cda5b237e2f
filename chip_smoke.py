#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, and imports nothing of JAX or
of the JAX package.  Phases, each of which fails the run:

  1. build: compiles every kernel from ``src/repro_torch/kernels/csrc``
     (nvcc, sm_90a) and prints the card and the build time;
  2. sweep: each kernel against its plain PyTorch version on the card,
     with ``torch.equal`` (zero tolerance: the datapath is integer), over
     wl in {8, 12, 16}, vbl in {0, 5, 13, 15}, both Broken-Booth kinds,
     shifts {0, the minimal safe shift, > vbl}, ragged channel counts and
     lengths;
  3. main path: ``FilterbankEngine`` at the paper's operating point
     (bbm0, WL = 16, VBL = 13, 31 taps, shift 5) serves flush A, 64
     requests x 65,536 samples (one 64-channel dispatch above the
     auto-form budget: the rows kernel), and flush B, 16 requests of
     4,096-8,192 samples (the dot kernel).  Launch counts are zeroed just
     before and read just after; both kernels must have launched, nothing
     may be quarantined, and 8 sampled channels of each flush must equal,
     bit for bit, the same requests served on the CPU;
  4. the paper's penalty through the kernels: exact Booth minus bbm0 at
     VBL = 15 on the 30-tap testbed, which must be 0.4 +- 0.15 dB;
  5. timing: where each flush's time goes, stage by stage, and each
     kernel and its plain version at the main path's shapes.

The line before the last is a JSON object with every kernel's launches,
error, time, plain time and bound; the last line is the run's verdict.
Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Bound rates of one H100 SXM at its 700 W limit.  Memory: 3.35 TB/s (the
# data sheet).  int32 ALU: the data sheet's 67 TFLOP/s float32 counts an
# FMA as 2 operations on 128 FP32 lanes per SM; an SM has half as many
# INT32 lanes, so int32 issue peaks at 67e12 / 2 / 2 operations per second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

SOURCE = "src/repro_torch/kernels/csrc/fir_bank.cu"
REPLACES = {"fir_bank_rows": "src/repro/kernels/fir_kernel.py:106",
            "fir_bank_dot": "src/repro/kernels/fir_kernel.py:136"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", log))
    if not regs:
        return "ptxas: no report"
    return (f"ptxas: {len(regs)} kernels, registers {min(regs)}..{max(regs)}"
            f", spill stores {spills} bytes")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls between CUDA events (warm).

    Covers the host's share too when the host cannot keep the card busy.
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn):
    """``fn()`` and its wall time in ms, the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def kernel_device_ms(torch, fn, reps: int, kernel: str):
    """Mean device time of one launch of the CUDA kernel whose name holds
    ``kernel``, from torch.profiler's trace of ``reps`` warm calls; None
    when the trace shows no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            t = getattr(ev, "device_time_total", None)
            total_us += t if t is not None else ev.cuda_time_total
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def sweep(torch, fk, booth_precode, dev) -> int:
    """Each kernel == its plain version on the card; returns the case count."""
    rng = np.random.default_rng(1)
    taps = 31
    shapes = [(5, 1500), (1, 7), (3, 513), (70, 600)]
    cases = 0
    for wl in (8, 12, 16):
        lo = fk.min_safe_shift(taps, wl)
        for vbl in (0, 5, 13, 15):
            for kind in (0, 1):
                for shift in sorted({lo, max(lo, vbl + 2)}
                                     | ({0} if lo == 0 else set())):
                    c, n = shapes[cases % len(shapes)]
                    x = torch.from_numpy(rng.integers(
                        0, 1 << wl, (c, n)).astype(np.int32)).to(dev)
                    h = torch.from_numpy(rng.integers(
                        0, 1 << wl, (c, taps)).astype(np.int32)).to(dev)
                    hm, hn = (p.contiguous() for p in booth_precode(h, wl))
                    kw = dict(wl=wl, vbl=vbl, kind=kind, shift=shift)
                    want = fk.fir_bank_rows_plain(x, hm, hn, **kw)
                    got = {"fir_bank_rows": fk.fir_bank_rows(x, hm, hn, **kw),
                           "fir_bank_dot": fk.fir_bank_dot(x, hm, hn, **kw),
                           "fir_bank_dot_plain":
                               fk.fir_bank_dot_plain(x, hm, hn, **kw)}
                    torch.cuda.synchronize()
                    for name, y in got.items():
                        if not torch.equal(y, want):
                            bad = int((y != want).sum())
                            fail(f"{name} != plain rows at wl={wl} vbl={vbl} "
                                 f"kind={kind} shift={shift} C={c} N={n}: "
                                 f"{bad} elements differ")
                    cases += 1
    return cases


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    try:
        from repro_torch.configs.fir30 import SPEC_APPROX, WL
        from repro_torch.core.multipliers import MulSpec
        from repro_torch.dsp import fir as dfir
        from repro_torch.dsp import (FIR_DELAY, design_lowpass,
                                     make_filterbank_signals, make_signals,
                                     run_filter_case, snr_db)
        from repro_torch.kernels import _build
        from repro_torch.kernels import fir_kernel as fk
        from repro_torch.kernels.booth_rows import (booth_precode,
                                                    num_corr_rows)
        from repro_torch.serve import FilterbankEngine, FilterRequest
    except ImportError as e:
        fail(f"the port is not importable beside this script ({e})")
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    _build.build_all()
    _build.library("fir_bank")
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOGS.items():
        print(f"{name} {ptxas_summary(log)}")

    # ---------------------------------------------------------------- sweep
    t0 = time.perf_counter()
    cases = sweep(torch, fk, booth_precode, dev)
    print(f"sweep: {cases} cases, fir_bank_rows, fir_bank_dot and the plain "
          f"dot form all bit-equal to the plain rows form "
          f"({time.perf_counter() - t0:.1f} s)")

    # ------------------------------------------------------------ main path
    taps_banks = np.stack([design_lowpass(), design_lowpass(stop_weight=0.5)])
    spec = SPEC_APPROX                      # bbm0, WL = 16, VBL = 13
    taps = taps_banks.shape[1]
    shift = fk.min_safe_shift(taps, WL)
    if (taps, shift) != (31, 5):
        fail(f"fir30 operating point moved: taps={taps} shift={shift}")
    eng = FilterbankEngine(taps_banks, spec, backend="cuda", max_channels=64)
    cpu_eng = FilterbankEngine(taps_banks, spec, backend="cuda",
                               max_channels=64, device="cpu")
    rng = np.random.default_rng(0)
    sigs_a = make_filterbank_signals(64, n=65536, seed=0)
    lens_b = rng.integers(4096, 8193, 16)
    sigs_b = [make_signals(n=int(n), seed=1000 + i)
              for i, n in enumerate(lens_b)]
    flushes = {"A": sigs_a, "B": sigs_b}

    counts = {}
    served = {}
    fk.fir_bank_rows.launches = 0
    fk.fir_bank_dot.launches = 0
    for tag, sigs in flushes.items():
        before = (fk.fir_bank_rows.launches, fk.fir_bank_dot.launches)
        rids = [eng.submit(s.x, bank=c % 2) for c, s in enumerate(sigs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.flush()
        dt = time.perf_counter() - t0
        counts[tag] = (fk.fir_bank_rows.launches - before[0],
                       fk.fir_bank_dot.launches - before[1])
        served[tag] = (rids, out, dt)
    launches = {"fir_bank_rows": fk.fir_bank_rows.launches,
                "fir_bank_dot": fk.fir_bank_dot.launches}
    if eng.failed or eng.stats["quarantined"]:
        fail(f"the engine quarantined requests: {eng.failed}")
    if counts["A"][0] < 1 or counts["B"][1] < 1:
        fail(f"a kernel of the main path never launched: {counts}")
    for tag, sigs in flushes.items():
        rids, out, dt = served[tag]
        if sorted(out) != sorted(rids):
            fail(f"flush {tag} served {len(out)} of {len(rids)} requests")
        for rid, s in zip(rids, sigs):
            if out[rid].shape != s.x.shape or not np.isfinite(out[rid]).all():
                fail(f"flush {tag} request {rid}: bad output")
        pick = sorted(rng.choice(len(sigs), 8, replace=False).tolist())
        cpu_rids = [cpu_eng.submit(sigs[c].x, bank=c % 2) for c in pick]
        cpu_out = cpu_eng.flush()
        for c, crid in zip(pick, cpu_rids):
            if not np.array_equal(out[rids[c]], cpu_out[crid]):
                fail(f"flush {tag} channel {c} differs from the CPU engine")
        snr = np.mean([snr_db(s.d1, out[r], FIR_DELAY)
                       for r, s in zip(rids, sigs)])
        samples = sum(len(s.x) for s in sigs)
        print(f"flush {tag}: {len(sigs)} requests, {samples} samples, "
              f"{dt * 1e3:.3f} ms, {samples / dt:.6g} samples/s, launches "
              f"rows={counts[tag][0]} dot={counts[tag][1]}, mean SNR "
              f"{snr:.6f} dB, 8 sampled channels bit-equal to the CPU "
              f"engine")

    # -------------------------------------------------------- paper penalty
    sig = make_signals(n=1 << 13, seed=0)
    base = run_filter_case(MulSpec("booth", WL, 0), sig, backend="cuda")
    prop = run_filter_case(MulSpec("bbm0", WL, 15), sig, backend="cuda")
    penalty = base - prop
    print(f"paper penalty (30-tap FIR, booth - bbm0 VBL=15, through the "
          f"kernels): {base:.6f} - {prop:.6f} = {penalty:.6f} dB")
    if not abs(penalty - 0.4) <= 0.15:
        fail(f"penalty {penalty} dB outside 0.4 +- 0.15")

    # --------------------------------------------------------------- timing
    vbl, kind = spec.param, 0
    kernels = []
    for name, tag in (("fir_bank_rows", "A"), ("fir_bank_dot", "B")):
        # the flush's own dispatch, stage by stage (one warm run each):
        # padded batch -> host codes -> card -> kernel -> host -> reals
        sigs = flushes[tag]
        st = {}
        x, st["stack"] = wall_ms(torch, lambda: eng._stack(
            [FilterRequest(0, s.x) for s in sigs]))
        amp = dfir._amp(x)
        codes, st["quantize"] = wall_ms(torch, lambda: dfir._codes32(
            dfir._quantize64(x * dfir._amp(x), WL), WL))
        (hm, hn), st["bank"] = wall_ms(torch, lambda: eng.bank.take(
            [c % 2 for c in range(len(sigs))]).planes)
        xc, st["to_device"] = wall_ms(torch, lambda: dfir._to_device(codes,
                                                                     dev))
        kern = getattr(fk, name)
        kw = dict(wl=WL, vbl=vbl, kind=kind, shift=shift)
        y_k, st["kernel"] = wall_ms(torch, lambda: kern(xc, hm, hn, **kw))
        acc, st["to_host"] = wall_ms(torch, lambda: dfir._to_host(y_k))
        _, st["descale"] = wall_ms(torch, lambda: dfir._descale(
            acc, WL, shift, amp))
        print(f"flush {tag} stages, ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items())
            + f"; sum {sum(st.values()):.3f} of the flush's "
            f"{served[tag][2] * 1e3:.3f}")
        c, n = xc.shape
        if fk.auto_form(None, c, n, taps, dev) != name.split("_")[-1]:
            fail(f"flush {tag} shape does not select {name}")
        plain = getattr(fk, name + "_plain")
        y_p = plain(xc, hm, hn, **kw)
        torch.cuda.synchronize()
        err = int((y_k.to(torch.int64) - y_p.to(torch.int64)).abs().max())
        call_ms = cuda_ms(torch, lambda: kern(xc, hm, hn, **kw), 20)
        dev_ms = kernel_device_ms(torch, lambda: kern(xc, hm, hn, **kw), 20,
                                  name + "_kernel")
        ms = call_ms if dev_ms is None else dev_ms
        plain_ms = cuda_ms(torch, lambda: plain(xc, hm, hn, **kw), 3)
        rows = WL // 2 if name == "fir_bank_rows" \
            else 1 + num_corr_rows(WL, vbl)
        ops = c * n * taps * rows
        nbytes = 4 * c * n * 2 + 4 * hm.numel() * 2
        t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None})
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.6f} ms"
        print(f"{name} at ({c}, {n}) x {taps} taps: kernel {dev_txt} on "
              f"the device (profiler), wrapper call {call_ms:.6f} ms "
              f"(CUDA events), plain {plain_ms:.6f} ms, bound "
              f"{max(t_ops, t_bytes) * 1e3:.6f} ms ({ops} int32 ops, "
              f"{nbytes} bytes)")
        if err != 0:
            fail(f"{name} differs from its plain version at the main "
                 f"path's shape (max abs error {err})")

    print(f"gpu: {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
