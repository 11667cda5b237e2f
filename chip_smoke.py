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
     kernel and its plain version at the main path's shapes;
  6. quant_matmul sweep: the kernel against its plain version on the
     card over wl in {8, 12, 16}, no noise and bbm0's noise, M in
     {1, 8, 200}, K in {64, 512, 896, 4864}, N in {896, 4864, 130}:
     ``torch.equal`` where every chunk partial is an exact integer and
     there is no noise, ``quant_matmul_tolerance`` (a derived bound)
     elsewhere; the hash's uniforms bit-equal;
  7. LM main path: qwen2-0.5b at full width (random weights from a seeded
     generator, on the card) in noise mode (bbm0, WL 16, VBL 13, the
     fused kernel) served by the continuous ``Scheduler``: 8 slots,
     max_len 512, 32 requests with prompts of 32-256 tokens and 64 new
     tokens each.  The launch count is zeroed just before and read just
     after; it must be 72 (3 MLP products x 24 layers) per ``lm_apply``
     call (decode steps plus prefills), nothing may fail, every logit
     must be finite, and the 144 kernel calls of the first step (one
     prefill, one decode) must match the plain version on their own
     inputs;
  8. the card against the CPU: two requests served by the port on the
     CPU, teacher-forced on the card's tokens, match the card's logits
     at every step;
  9. LM timing: tokens/s, decode-step ms, the card's idle share of a
     decode step (torch.profiler), and quant_matmul at the decode and a
     prefill shape against its bound, its plain version and f32
     ``torch.matmul`` as a yardstick.

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
            "fir_bank_dot": "src/repro/kernels/fir_kernel.py:136",
            "quant_matmul": "src/repro/kernels/quant_matmul.py:69"}
QM_SOURCE = "src/repro_torch/kernels/csrc/quant_matmul.cu"
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
QM_KERNELS = ("qm_partial_kernel", "qm_finish_kernel")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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


def kernel_device_ms(torch, fn, reps: int, kernel):
    """Mean device time per call of ``fn`` spent in the CUDA kernels whose
    names hold ``kernel`` (a string or a tuple of strings), from
    torch.profiler's trace of ``reps`` warm calls; None when the trace
    shows no device time for them."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            t = getattr(ev, "device_time_total", None)
            total_us += t if t is not None else ev.cuda_time_total
    return total_us / reps / 1e3 if total_us > 0 else None


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


# ------------------------------------------------------------ quant_matmul
def qm_sweep(torch, qm, amm_scale, dev, mu: float, sigma: float) -> tuple:
    """The kernel against its plain version on the card; returns (cases,
    bit-equal cases, worst ratio of error to bound)."""
    rng = np.random.default_rng(2)
    cases = equal = 0
    worst = 0.0
    for wl in (8, 12, 16):
        for noisy in (False, True):
            for m in (1, 8, 200):
                for k in (64, 512, 896, 4864):
                    for n in (896, 4864, 130):
                        x = torch.from_numpy(rng.standard_normal(
                            (m, k)).astype(np.float32)).to(dev)
                        w = torch.from_numpy((0.02 * rng.standard_normal(
                            (k, n))).astype(np.float32)).to(dev)
                        sx, sw = amm_scale(x, wl), amm_scale(w, wl)
                        mu_, sig_ = (mu, sigma) if noisy else (0.0, 0.0)
                        seed = int(rng.integers(0, 2 ** 31 - 1))
                        got = qm.quant_matmul(x, w, sx, sw, mu_, sig_,
                                              wl=wl, seed=seed)
                        want = qm.quant_matmul_plain(
                            x, w, sx, sw, mu_, sig_, wl=wl, seed=seed,
                            bm=128, bk=512, bn=128)
                        tol = qm.quant_matmul_tolerance(
                            x, w, sx, sw, mu_, sig_, wl=wl)
                        torch.cuda.synchronize()
                        err = (got.double() - want.double()).abs()
                        if not torch.isfinite(got).all():
                            fail(f"quant_matmul not finite at wl={wl} "
                                 f"M={m} K={k} N={n}")
                        if bool((tol == 0).all()):
                            if not torch.equal(got, want):
                                fail(f"quant_matmul != plain at wl={wl} "
                                     f"M={m} K={k} N={n} noise={noisy}: "
                                     f"{int((got != want).sum())} elements"
                                     f" differ where the sums are exact")
                        elif bool((err > tol).any()):
                            fail(f"quant_matmul off its plain version by "
                                 f"{float(err.max())} (bound "
                                 f"{float(tol.max())}) at wl={wl} M={m} "
                                 f"K={k} N={n} noise={noisy}")
                        else:
                            worst = max(worst, float(
                                (err / tol.clamp_min(1e-300)).max()))
                        equal += int(torch.equal(got, want))
                        cases += 1
    for m, n, bm, bn in ((8, 4864, 8, 128), (200, 130, 128, 128),
                         (1, 896, 1, 128), (300, 300, 64, 32)):
        seed = int(rng.integers(0, 2 ** 31 - 1))
        got = qm.hash_words(m, n, seed, bm=bm, bn=bn, device=dev)
        want = qm.hash_words_plain(m, n, seed, bm=bm, bn=bn, device=dev)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"the hash's uniforms differ at ({m}, {n}) tiles "
                 f"({bm}, {bn})")
    return cases, equal, worst


def qm_bound_ms(m: int, k: int, n: int) -> tuple:
    """(bound ms, what bounds it) of one quant_matmul call: x, w read
    once and out written once in f32 over 3.35 TB/s, against 2*M*K*N
    float32 operations over 67 TFLOP/s."""
    t_bytes = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lm_config():
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import AmmConfig
    return dataclasses.replace(get_arch("qwen2-0.5b"), amm=AmmConfig(
        mode="noise", mul="bbm0", wl=16, param=13, apply_to="mlp",
        use_pallas=True))


class Recorder:
    """Wraps the serve functions: counts the ``lm_apply`` calls, keeps a
    device-side count of non-finite logits, and optionally each call's
    (kind, tokens, position, logits) for a replay."""

    def __init__(self, torch, fns, keep: bool):
        self.torch, self.keep = torch, keep
        self.prefill_fn, self.decode_fn = fns
        self.calls = 0
        self.bad = None
        self.log = []

    def _note(self, kind, tokens, pos, logits):
        self.calls += 1
        nbad = (~self.torch.isfinite(logits)).sum()
        self.bad = nbad if self.bad is None else self.bad + nbad
        if self.keep:
            self.log.append((kind, tokens.cpu(), pos, logits.float().cpu()))

    def prefill(self, p, t, c):
        logits, c = self.prefill_fn(p, t, c)
        self._note("prefill", t, 0, logits)
        return logits, c

    def decode(self, p, t, c, q):
        logits, c = self.decode_fn(p, t, c, q)
        self._note("decode", t, q, logits)
        return logits, c


def lm_main_path(torch, dev, cfg, rt, params, qm) -> dict:
    """Serve the workload through the continuous Scheduler; check it."""
    from repro_torch.serve import Request, Scheduler, make_serve_fns
    rng = np.random.default_rng(3)
    rec = Recorder(torch, make_serve_fns(cfg, rt), keep=False)
    sched = Scheduler(cfg, rt, params, 8, 512, decode_fn=rec.decode,
                      prefill_fn=rec.prefill, continuous=True, device=dev)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(32, 257))).tolist(), max_new=64)
        for i in range(32)]
    for r in reqs:
        sched.submit(r)
    step_ms = []
    qm.quant_matmul.launches = 0
    qm.quant_matmul.capture = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        pre = sched.stats["prefills"]
        ts = time.perf_counter()
        n = sched.step()
        if qm.quant_matmul.capture is not None:
            captured, qm.quant_matmul.capture = qm.quant_matmul.capture, None
        if not n:
            break
        if sched.stats["prefills"] == pre:      # a pure decode step
            step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qm.quant_matmul.launches
    st = sched.stats
    calls = st["steps"] + st["prefills"]
    per_call = 3 * cfg.n_layers
    if rec.calls != calls:
        fail(f"the Scheduler made {rec.calls} lm_apply calls, its stats "
             f"say {calls}")
    if launches != per_call * calls:
        fail(f"quant_matmul launched {launches} times for {calls} lm_apply "
             f"calls ({st['steps']} decode steps + {st['prefills']} "
             f"prefills): expected {per_call * calls}")
    if st["failed"] or st["deadline_expired"] or st["completed"] != len(reqs):
        fail(f"the Scheduler did not serve every request: {st}")
    if any(r.error or len(r.out) != 64 for r in reqs):
        fail("a request ended early or failed")
    if int(rec.bad) != 0:
        fail(f"{int(rec.bad)} non-finite logits on the main path")
    # the first step's kernel calls against the plain version
    ms = sorted({c["x"].shape[0] for c in captured})
    if len(captured) != 2 * per_call or ms[0] != 8 or len(ms) != 2:
        fail(f"the first step captured {len(captured)} calls at M={ms}, "
             f"expected {per_call} of a prefill and {per_call} at M=8")
    worst, max_err = 0.0, 0.0
    for c in captured:
        kw = {k: c[k] for k in ("mu", "sigma", "wl", "seed", "bm", "bk",
                                "bn")}
        want = qm.quant_matmul_plain(c["x"], c["w"], c["s_x"], c["s_w"],
                                     **kw)
        tol = qm.quant_matmul_tolerance(c["x"], c["w"], c["s_x"], c["s_w"],
                                        c["mu"], c["sigma"], wl=c["wl"],
                                        bk=c["bk"])
        err = (c["out"].double() - want.double()).abs()
        if bool((err > tol).any()):
            fail(f"a main-path quant_matmul call at {tuple(c['x'].shape)} x "
                 f"{tuple(c['w'].shape)} is off its plain version by "
                 f"{float(err.max())}")
        worst = max(worst, float((err / tol.clamp_min(1e-300)).max()))
        max_err = max(max_err, float(err.max()))
    tokens = sum(len(r.out) for r in reqs)
    step_ms.sort()
    return {"stats": st, "launches": launches, "calls": calls,
            "tokens": tokens, "wall_s": wall, "step_ms": step_ms,
            "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "capture_worst": worst, "capture_err": max_err,
            "prefill_m": ms[1]}


# bf16 residual stream: a rounding that flips one residual element moves
# it by 2^-8 of its size, and such flips accumulate over the 24 layers;
# the card and the CPU may differ by 1/32 of the logits' largest
# magnitude at any step
LOGIT_RTOL = 2.0 ** -5


def lm_cpu_check(torch, dev, cfg, rt, params) -> dict:
    """Two requests on the card, then on the CPU port teacher-forced on
    the card's tokens: every step's logits within ``LOGIT_RTOL``."""
    from repro_torch.serve import Request, Scheduler, make_serve_fns
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (32, 40)]
    rec = Recorder(torch, make_serve_fns(cfg, rt), keep=True)
    card = Scheduler(cfg, rt, params, 8, 64, decode_fn=rec.decode,
                     prefill_fn=rec.prefill, continuous=True, device=dev)
    for i, p in enumerate(prompts):
        card.submit(Request(rid=i, prompt=p, max_new=8))
    while card.step():
        pass
    def to_cpu(tree):
        return {k: to_cpu(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree.cpu()
    cpu_params = to_cpu(params)
    fns = make_serve_fns(cfg, rt)
    state = {"i": 0, "worst": 0.0, "flips": 0, "checked": 0}

    def forced(kind, logits):
        want_kind, _, _, want = rec.log[state["i"]]
        state["i"] += 1
        if kind != want_kind:
            fail(f"the CPU replay made a {kind} where the card made a "
                 f"{want_kind}")
        got = logits.float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        state["worst"] = max(state["worst"], err / scale)
        if err > LOGIT_RTOL * scale:
            fail(f"CPU logits off the card's by {err} (scale {scale}) at "
                 f"call {state['i']}")
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_RTOL * scale
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        state["checked"] += int(clear.sum())
        state["flips"] += int((clear & ~same).sum())
        return want            # teacher forcing: the card's tokens

    def prefill(p, t, c):
        logits, c = fns[0](p, t, c)
        return forced("prefill", logits), c

    def decode(p, t, c, q):
        logits, c = fns[1](p, t, c, q)
        return forced("decode", logits), c

    cpu = Scheduler(cfg, rt, cpu_params, 8, 64, decode_fn=decode,
                    prefill_fn=prefill, continuous=True, device="cpu")
    for i, p in enumerate(prompts):
        cpu.submit(Request(rid=i, prompt=p, max_new=8))
    while cpu.step():
        pass
    if state["i"] != len(rec.log) or cpu.stats != card.stats:
        fail(f"the CPU replay made {state['i']} calls of the card's "
             f"{len(rec.log)}; stats {cpu.stats} vs {card.stats}")
    if state["flips"]:
        fail(f"{state['flips']} greedy tokens differ between the CPU and "
             f"the card where the top-2 gap exceeds the tolerance")
    return {"calls": len(rec.log), "worst": state["worst"],
            "checked": state["checked"]}


def lm_timing(torch, dev, cfg, rt, params, qm, amm_scale) -> tuple:
    """quant_matmul at the main path's shapes, and a profiled decode
    window; returns (kernel entry fields, printed lines)."""
    from repro_torch.serve import Request, Scheduler
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    lines, rows = [], []
    shapes = ((8, cfg.d_model, cfg.d_ff), (8, cfg.d_ff, cfg.d_model),
              (256, cfg.d_model, cfg.d_ff))
    mlp = params["layers"]["mlp"]
    w_of = {(cfg.d_model, cfg.d_ff): mlp["w_gate"],
            (cfg.d_ff, cfg.d_model): mlp["w_down"]}
    for m, k, n in shapes:
        # each call takes the next layer's weight, as a decode step does:
        # the 24 weights (418 MB) overflow the 50 MB L2, so every call
        # reads its weight from device memory
        x = torch.randn((m, k), generator=gen, device=dev)
        sx = amm_scale(x, 16)
        ws = [(w, amm_scale(w, 16)) for w in w_of[(k, n)]]
        turn = [0]

        def operands():
            w, sw = ws[turn[0] % len(ws)]
            turn[0] += 1
            return (x, w, sx, sw, rt.amm.mu, rt.amm.sigma)

        def run():
            return qm.quant_matmul(*operands(), wl=16, seed=7)

        def plain():
            return qm.quant_matmul_plain(*operands(), wl=16, seed=7,
                                         bm=128, bk=512, bn=128)

        def library():
            return x @ operands()[1]
        reps = 2 * len(ws)
        dev_ms = kernel_device_ms(torch, run, reps, QM_KERNELS)
        call_ms = cuda_ms(torch, run, reps)
        plain_ms = cuda_ms(torch, plain, 5)
        lib_ms = cuda_ms(torch, library, reps)
        turn[0] = 0
        got = run()
        turn[0] = 0
        err = float((got.double() - plain().double()).abs().max())
        bound, by = qm_bound_ms(m, k, n)
        rows.append((m, k, n, dev_ms, call_ms, plain_ms, bound, by, err,
                     lib_ms))
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.6f} ms"
        lines.append(
            f"quant_matmul at ({m}, {k}) x ({k}, {n}), weights from device "
            f"memory: kernel {dev_txt} on the device (profiler, both "
            f"launches), wrapper call {call_ms:.6f} ms (CUDA events), plain "
            f"{plain_ms:.6f} ms, bound {bound:.6f} ms ({by}), max abs error "
            f"vs plain {err}; yardstick f32 torch.matmul {lib_ms:.6f} ms")
    # a profiled window of 5 pure decode steps with 8 residents
    sched = Scheduler(cfg, rt, params, 8, 512, continuous=True, device=dev)
    rng = np.random.default_rng(6)
    for i in range(8):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, 64).tolist(), max_new=40))
    for _ in range(10):
        sched.step()                 # admit all 8 and warm up
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, qm_us, launches, by_kernel = 0.0, 0.0, 0, []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = t if t is not None else ev.self_cuda_time_total
        if t <= 0:
            continue
        busy_us += t
        launches += ev.count
        by_kernel.append((t, ev.count, ev.key))
        if any(q in ev.key for q in QM_KERNELS):
            qm_us += t
    if sched.stats["prefills"] != 8:
        fail("the profiled window admitted a prefill")
    idle = 1.0 - busy_us / 1e3 / wall_ms
    lines.append(
        f"decode window (5 steps, 8 residents, profiled): {wall_ms / 5:.3f} "
        f"ms per step, device busy {busy_us / 5e3:.3f} ms per step "
        f"(quant_matmul {qm_us / 5e3:.3f} ms), idle share {idle:.4f}, "
        f"{launches / 5:.0f} device operations per step")
    for t, count, key in sorted(by_kernel, reverse=True)[:10]:
        lines.append(f"  decode step device time: {t / 5e3:.4f} ms in "
                     f"{count / 5:.0f} launches of {key[:90]}")
    return rows, lines, idle


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
    for name in _build.SOURCES:
        _build.library(name)
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

    # ---------------------------------------------------- quant_matmul sweep
    import importlib
    qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    from repro_torch.kernels.ref import amm_scale
    from repro_torch.models import ModelRuntime, lm_init
    cfg = lm_config()
    rt = ModelRuntime.build(cfg)
    t0 = time.perf_counter()
    cases, equal, worst = qm_sweep(torch, qm, amm_scale, dev, rt.amm.mu,
                                   rt.amm.sigma)
    print(f"quant_matmul sweep: {cases} cases within the derived bound of "
          f"the plain version, {equal} of them bit-equal (all with exact "
          f"chunk sums and no noise among them), worst error/bound "
          f"{worst:.3g}; the hash's uniforms bit-equal "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---------------------------------------------------- LM main path
    t0 = time.perf_counter()
    params = lm_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(params))
    print(f"lm: {cfg.name} at full width, {n_params} parameters (f32, "
          f"seeded on the card in {time.perf_counter() - t0:.2f} s); amm "
          f"noise bbm0 WL={cfg.amm.wl} VBL={cfg.amm.param}, mu={rt.amm.mu!r}, "
          f"sigma={rt.amm.sigma!r}")
    res = lm_main_path(torch, dev, cfg, rt, params, qm)
    st = res["stats"]
    steps = res["step_ms"]
    print(f"lm main path: {len(steps)} pure decode steps of "
          f"{st['steps']}, {st['prefills']} prefills, {res['tokens']} "
          f"tokens generated ({res['prompt_tokens']} prompt tokens) in "
          f"{res['wall_s']:.3f} s: {res['tokens'] / res['wall_s']:.6g} "
          f"generated tokens/s; decode step ms p50 "
          f"{steps[len(steps) // 2]:.3f}, p90 "
          f"{steps[int(len(steps) * 0.9)]:.3f}; quant_matmul launches "
          f"{res['launches']} = 72 x {res['calls']} lm_apply calls; nothing "
          f"failed; all logits finite; the first step's 144 kernel calls "
          f"(a prefill at M={res['prefill_m']} and a decode at M=8) within "
          f"the bound of the plain version (worst error/bound "
          f"{res['capture_worst']:.3g}, max abs error "
          f"{res['capture_err']!r})")
    t0 = time.perf_counter()
    chk = lm_cpu_check(torch, dev, cfg, rt, params)
    print(f"lm card vs CPU: {chk['calls']} lm_apply calls of two requests "
          f"replayed on the CPU port, teacher-forced: worst |logit error| "
          f"/ max|logit| {chk['worst']:.4g} (tolerance {LOGIT_RTOL}), "
          f"greedy tokens equal at all {chk['checked']} clear rows "
          f"({time.perf_counter() - t0:.1f} s)")
    rows, lines, idle = lm_timing(torch, dev, cfg, rt, params, qm,
                                  amm_scale)
    for line in lines:
        print(line)
    # the JSON entry: one launch of a decode step on average (gate and up
    # at (8, 896) x (896, 4864), down at (8, 4864) x (4864, 896))
    (_, _, _, d_gu, c_gu, p_gu, b_gu, by, _, _), \
        (_, _, _, d_dn, c_dn, p_dn, b_dn, _, _, _) = rows[0], rows[1]
    mix = lambda a, b: (2 * a + b) / 3  # noqa: E731
    kernels.append({
        "name": "quant_matmul", "route": "cuda", "source": QM_SOURCE,
        "replaces": REPLACES["quant_matmul"], "launches": res["launches"],
        "max_abs_err": res["capture_err"],
        "ms": mix(c_gu, c_dn) if d_gu is None or d_dn is None
        else mix(d_gu, d_dn),
        "plain_ms": mix(p_gu, p_dn), "bound_ms": mix(b_gu, b_dn),
        "bound_by": by, "library_ms": None})

    print(f"gpu: {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
