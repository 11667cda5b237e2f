#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, and imports nothing of JAX or
of the JAX package.  Phases, each of which fails the run:

  1. build: compiles every kernel from ``src/repro_torch/kernels/csrc``
     (nvcc, sm_90a) and prints the card, the build time and each
     library's (and each flash kernel's) registers and spills;
  2. sweep: both FIR wrappers on each route they can take (forced
     through the private hooks: the CUDA-core kernels everywhere, the
     int8 tensor cores of ``csrc/fir_mma.cuh`` where ``fir_bank_route``
     allows them) against the plain rows form on the card, with
     ``torch.equal`` (zero tolerance: the datapath is integer), over wl
     in {8, 12, 16}, vbl in {0, 5, 13, 15}, both Broken-Booth kinds,
     shifts {0, the minimal safe shift, > vbl}, ragged channel counts and
     lengths (both of the tensor cores' schedules);
  3. main path: ``FilterbankEngine`` at the paper's operating point
     (bbm0, WL = 16, VBL = 13, 31 taps, shift 5) serves flush A, 64
     requests x 65,536 samples (one 64-channel dispatch above the
     auto-form budget: ``fir_bank_rows``), and flush B, 16 requests of
     4,096-8,192 samples (``fir_bank_dot``).  Launch counts are zeroed
     just before and read just after; each flush must launch its wrapper
     once, on the tensor-core route, nothing may be quarantined, and 8
     sampled channels of each flush must equal, bit for bit, the same
     requests served on the CPU;
  4. the paper's penalty through the kernels: exact Booth minus bbm0 at
     VBL = 15 on the 30-tap testbed, which must be 0.4 +- 0.15 dB;
  5. timing: where each flush's time goes, stage by stage, and each
     wrapper at the main path's shapes on its tensor-core route (both
     kinds) and on the CUDA-core route, against the bound (at shift <=
     vbl the contracted dot form's int8 byte products against the bytes,
     ``fir_bound_ms``), its plain version, and one f32
     ``F.conv1d(groups=C)`` at the same (C, N, taps) as a yardstick;
  6. quant_matmul sweep: the kernel against its plain version on the
     card over wl in {8, 12, 16}, no noise and bbm0's noise, M in
     {1, 8, 200}, K in {64, 512, 896, 4864}, N in {896, 4864, 130}:
     ``torch.equal`` where every chunk partial is an exact integer and
     there is no noise, ``quant_matmul_tolerance`` (a derived bound)
     elsewhere; the hash's uniforms bit-equal; then the route edges (M in
     {1, 7, 8, 9, 16, 17, 64, 65, 256} at qwen2-0.5b's two MLP shapes,
     the decode threshold being 64), x or w
     views 4 bytes off a 16-byte boundary, and each route forced at the
     other's shapes and at odd chunkings (bk 100, 32, and 32,768 rows,
     the longest chunk the tiled route's int32 sums hold; a longer one
     must be refused), the tiled route bit-equal to
     ``quant_matmul_emulated`` without noise;
  7. LM main path: qwen2-0.5b at full width (random weights from a seeded
     generator, on the card) in noise mode (bbm0, WL 16, VBL 13, the
     fused kernel) served by the continuous ``Scheduler``: 8 slots,
     max_len 512, 32 requests with prompts of 32-256 tokens and 32 new
     tokens each.  The launch count is zeroed just before and read just
     after; it must be 72 (3 MLP products x 24 layers) per ``lm_apply``
     call (decode steps plus prefills), nothing may fail, every logit
     must be finite, and the 144 kernel calls of the first step (one
     prefill, one decode) must match the plain version on their own
     inputs;
  8. the card against the CPU: two requests served by the port on the
     CPU, teacher-forced on the card's tokens, match the card's logits
     at every step;
  9. LM timing: tokens/s, decode-step ms, quant_matmul at the decode and
     a prefill shape against its bound, its plain version, f32
     ``torch.matmul`` as a yardstick and its time before the redesign
     (quoted from PERF.md's kernel table); both routes timed around the
     decode threshold, each call on the next layer's weight (read from
     device memory, as on the main path); the wrapper's host time per
     call; a decode window
     (torch.profiler): device busy time, device operations and idle share
     per step, and from a second window with the host traced too, the
     host's time per step by operation;
 10. training sweeps: ``bbm_dot_scaled`` bit-equal to its plain version
     on each route (the int8 tensor cores where the operating point
     allows them, the CUDA-core tile everywhere, and the rule's own pick)
     over wl in {8, 12, 16}, both kinds, K one below, at and one past
     ``amm_chunk_len``, envelope-edge operands (the plain version on CPU
     copies where the operating point has no f32 envelope), and the
     planes-in ``bbm_dot_planes`` on clean, plane-faulted and
     accumulator-faulted operands on each route;
     ``flash_attention`` within ``flash_tolerance`` of its plain version
     and ``flash_attention_amm`` held against its plain version by
     ``flash_amm_compare`` (score products bit-equal, P's codes and tile
     scales within what float rounding moves, P V products bit-equal
     where P's codes agree, the output within the bound of the codes
     that moved) at S in {128, 384, 512} (d 64) and a ragged S = 200 at
     d in {16, 32, 64}, causal and not, both kinds; the amm kernel with
     a valid KV length (200, 300) below the padded 512; kind 1's dead
     tiles computed at S = 512 causal; and the amm kernel bit-equal
     outright where P is one-hot; then a precision control: the exact
     kernel's error against float64 attention within 16 times its plain
     version's, where 1xTF32 score products, and 3xTF32 ones short of a
     cross term, err beyond that limit;
 11. training T1: ``python -m repro_torch.launch.train --amm bitexact
     --mul bbm0 --wl 16 --vbl 13 --amm-attn --flash-attn`` through its
     ``main``: full-width qwen2-0.5b (24 layers, random weights), batch
     4 x seq 512 from the data pipeline, AdamW, 3 steps; exactly 72
     ``bbm_dot_scaled`` launches per step, all 72 on the tensor-core
     route, and 24 ``flash_attention_amm``, none of the other kernels,
     every loss finite;
 12. training T2: ``--amm off --flash-attn``, the same sizes: exactly 24
     ``flash_attention`` launches per step;
 13. the card against the CPU: a 2-layer cut at full width, one sequence
     of 256 tokens, T1's settings: the loss within 2^-12 of the CPU
     port's, every gradient leaf within 2^-5 of its largest element, the
     first MLP product's ``_amm_bitexact_approx`` bit-equal;
 14. training timing: step ms, tokens/s, device ms per kernel per step
     and the idle share of a step (torch.profiler over T1's and T2's
     last steps), and each new kernel at its main-path shapes against
     its bound, its plain version and, for ``flash_attention``,
     ``scaled_dot_product_attention`` on the same f32 operands (a
     yardstick only); each flash kernel beside its time before the
     redesign (quoted from PERF.md's kernel table), with the live tiles
     it launched against the full grid; ``bbm_dot_scaled`` on both
     routes at both MLP shapes (kind 0; kind 1 at the first), against
     the bound of the contracted dot form's int8 byte products
     (``dot_scaled_bound_ms``), its time before the redesign, and one
     ``torch._int_mm`` int8 product at the same (M, K, N) as a yardstick
     of the card's int8 rate (not the same function, never called by
     the port);
 15. B1 sweep: ``bbm_matmul_rows`` and ``bbm_matmul_dot`` (on each
     route it can take) bit-equal to their plain versions over wl in {8,
     12, 16}, vbl in {0, 5, 13, 15} below wl, both kinds, shifts {the
     minimal safe one (0 where the envelope allows), <= vbl, > vbl},
     ragged M, K and N, the most negative codes, and one faulted-plane
     case per lane;
 16. the public matmul API at qwen2-0.5b's MLP shape (2048, 896) x (896,
     4864), WL 16 / VBL 13, both kinds (launch counts zeroed just before,
     read just after): ``ops.bbm_matmul(shift=15)`` must launch
     ``bbm_matmul_rows`` once and ``bbm_matmul_dot`` never (the auto
     rule), shift 13 ``bbm_matmul_dot`` on the tensor-core route, whose
     output ``form="rows"`` repeats bit for bit, both equal to the plain
     versions on 64 sampled rows; bbm0 clean, with plane and with
     accumulator flips at p = 1e-3 through ``bbm_matmul_scaled`` (the
     planes-in ``bbm_dot_planes``, on the tensor-core route) bit-equal to
     its plain version;
 17. the fault study of ``benchmarks/robustness.py`` on the card: its
     gate (the faulted datapath bit-equal to ``amm_faulty_ref``, the
     disabled spec to the unfaulted datapath), its matmul resilience
     curves bit-equal to the CPU port, the FIR SNR-vs-plane-fault curve
     through ``FilterbankEngine`` at fir30 (8 channels bit-equal to the
     CPU port), and poison ejection on the card's engine;
 18. B1 timing: each new kernel and ``bbm_dot_scaled`` at the full shape
     against its bound (int8 byte products for the contracted forms,
     int32 issue for ``bbm_matmul_rows``) and its plain version; the
     CUDA-core routes' instructions per product in their compiled inner
     loops, the FIR rows kernel's among them.

 19. slice 5, bitexact serving from the int-code KV cache: the batched
     codes-in entry ``bbm_dot_coded_batched`` bit-equal to its plain
     version (CPU copies) on both routes (``bbm_coded_route``: the int8
     tensor cores of ``csrc/bbm_coded_mma.cuh``, and the CUDA-core
     ``bbm_coded_kernel`` where the rule takes it and, through its C
     entry, where it does not) on both products of decode attention (the
     score product with per-column K scales, the value product with
     per-block V scales and the ordered block add), both kinds, S 16-512,
     ragged lengths over stale codes and never-written blocks, a chunk
     shorter than a block, int8 codes, unit scales, and ``amm_dot``'s
     prefill pair; the CUDA-core route's own path (decode attention on
     the code cache at WL 16 / VBL 3, its counts zeroed before); then
     full-width
     qwen2-0.5b bitexact (bbm0 WL 16 VBL 13, ``apply_to="all"``,
     ``kv_codes``) through the continuous ``Scheduler``: 8 slots,
     max_len 512, 32 requests of 32-256 prompt tokens and 32 new tokens
     each, the weights precoded once; the counts zeroed just before and
     every ``lm_apply`` call held to exactly 72 ``bbm_dot_scaled`` and 48
     ``bbm_dot_coded_batched`` launches, prefills and decodes alike;
     nothing failed, every logit finite; decode p50 / p90 and tokens/s;
     the code cache's bytes against bf16 (``memory_report``); a 2-layer
     cut at full width served on the card and teacher-forced on the CPU
     port (logits within ``LOGIT_RTOL``); each coded launch of a decode
     step at the main path's lengths and of the prefill pair on both
     routes (device ms, plain ms, bound, an empty kernel's launch, an f32
     ``torch.bmm`` yardstick) and ``bbm_dot_scaled`` at the decode
     shapes (8, 896) x (896, 4864) and (8, 4864) x (4864, 896); a
     profiled decode window (idle share, device operations, host time,
     no CUDA-core coded launch).

 20. slice 6, the normal draw: ``normal_bits`` (the kernel's transform
     from given bits) bit-equal to its plain version over all 2^23
     uniforms, and ``normal_draw`` bit-equal at the plain noise branch's
     shapes ((8, 1, 4864), (8, 1, 896), (1, 256, 4864), (1, 256, 896)) for
     three keys, the draw and both epilogues; the kernel per launch at the
     decode and a prefill shape against its bound, its plain version on
     the card and ``torch.randn`` (not the same function);
 21. noise serving on the plain branch: full-width qwen2-0.5b in noise
     mode (bbm0, WL 16, VBL 13) without the fused kernel through the
     continuous ``Scheduler`` (8 slots, max_len 512, 24 requests of
     32-256 prompt tokens and 32 new tokens); the counts zeroed just
     before and read just after: 72 ``normal_draw`` launches per
     ``lm_apply`` call and no ``quant_matmul``; nothing failed, every logit
     finite; decode p50 / p90 and tokens/s beside the fused kernel's path
     of phase 7; 10^7 draws' mean and std against N(0, 1); two requests
     replayed on the CPU port on a 6-layer cut (logits within
     ``LOGIT_RTOL``); a profiled
     decode window (idle share; no ``quant_matmul`` kernel in it);
 22. the paper's tables: Table I at WL 12 over all 2^24 pairs on the
     card, equal to the CPU port's floats, beside the paper's values; Fig.
     2's histogram (equal to the CPU port's); Figs. 5/6's sampled MSEs and
     the model's average PDPs for the five families; Tables II/III from
     the hardware model; Fig. 8's SNR against VBL and Table IV through
     ``fir_apply`` on the card (the filterbank kernels; phase 4 keeps the
     0.4 +- 0.15 dB gate).
 23. slice 7, the MoE family and multi-head latent attention:
     deepseek-v3 at full width (d_model 7168, 128 heads, q_lora 1536,
     kv_lora 512, rope 64, nope 128, v 128, vocab 129,280, dense d_ff
     18,432, 256 routed experts of width 2,048, top-8, one shared), cut
     to 2 layers (the dense prefix layer and one MoE layer) without the
     MTP head, 13.94 G parameters (55.8 GB in f32) built once and served
     twice through the continuous ``Scheduler`` (8 slots, max_len 512,
     16 requests of 32-128 prompt tokens and 32 new ones): (a) noise
     mode (bbm0 WL 16 VBL 13) on the fused kernel from the float latent
     cache, every ``lm_apply`` call exactly 6 ``quant_matmul`` launches
     (the prefix MLP and the shared expert); (b) bitexact
     (``apply_to="all"``) from the latent code cache, every call 6
     ``bbm_dot_scaled`` and 4 ``bbm_dot_coded_batched`` launches a
     decode (the prefill counts predicted from the lengths); the counts
     zeroed before each run; nothing failed, every logit finite; the
     first step's kernel calls held against their plain versions on their
     own inputs; the peak allocated bytes; the card against the CPU port
     with the routed experts cut to 16 (two requests, a prefill and two
     decode steps each): the MoE layer from the card's input (router
     logits, ``_dispatch``, the output from the card's routing; near-ties
     counted) and the teacher-forced logits; the routed experts' products
     at a decode step against the bytes of every expert's weights; a
     profiled decode window of each mode; and each kernel at the new
     shapes (``quant_matmul`` and ``bbm_dot_scaled`` at (8, 7168) x
     (7168, 18432) and (8, 18432) x (18432, 7168), the batched coded
     entry at MLA's decode shapes) against its bound, its plain version
     and an f32 PyTorch product.
 24. slice 8, the SSM and hybrid families: mamba2-370m and zamba2-2.7b at
     full width and depth through the continuous ``Scheduler`` (zamba2 in
     noise on the fused kernel and bitexact on the float cache),
     chameleon-34b cut to 2 layers, each call's launches held, decode
     windows, the SSD's share, depth-cut CPU replays and the kernels at
     the new shapes (``ssm_phase``).
 25. slice 9, the encoder-decoder family (``whisper_phase``):
     whisper-base at full width and depth (6 + 6 layers, 109,749,248
     parameters) served through ``make_serve_fns`` (the ``Scheduler``
     cannot serve it): a static batch of 8 prompts of 16 tokens, 32 new
     each, max_len 448, seeded frame embeddings (8, 1500, 512) in every
     call, in noise on the fused kernel (36 ``quant_matmul`` a call), on
     the plain branch (36 ``normal_draw``) and bitexact with
     ``apply_to="all"`` on the float cache (36 ``bbm_dot_scaled`` and
     108 ``bbm_dot_coded_batched``); every call's launches held, the first
     call's kernel calls against their plain versions, decode p50 / p90,
     tokens/s, idle share and the recomputed encoder's share of a step
     (ROADMAP C15); two sequences replayed on the CPU port (exact mode);
     training through ``launch.train --arch whisper-base`` on the
     launcher's zero embeddings, 3 steps each of T1 (36
     ``bbm_dot_scaled``, 12 ``flash_attention_amm``, 24 coded a step: the
     cross-attention stays chunked, C16) and T2 (12 ``flash_attention``),
     one step on seeded embeddings, a 2 + 2 layer card-vs-CPU loss; both
     flash kernels and their gradients at whisper's shapes (Sq != Skv,
     one query against 1,500 keys, all-zero K and V); each kernel at the
     encoder's shapes against its bound and a PyTorch call.
 26. slice 10, training the MoE family (``moe_train_phase``): both flash
     kernels at head dims 80 and 128 against their plain versions at
     every such config's training shape (4 x 512, GQA repeated as
     ``attention`` repeats it; causal and not, a ragged 200, a cross
     shape; 3xTF32 against float64) and timed beside
     ``scaled_dot_product_attention``; grok-1-314b at full width cut to
     1 layer (6.53 G parameters) through ``loss_and_grads`` in T1 (one
     ``flash_attention_amm`` a call at head dim 128) and T2 (one
     ``flash_attention``), the peak printed; the launcher's loop on
     grok-1 cut to 2 routed experts and a 16,384 vocabulary (AdamW's
     functional update holds about ten copies of the parameters): 3
     steps and the final checkpoint; deepseek-v3-671b at full width cut to 2 layers and 16
     routed experts with its MTP block, T1 (exactly 9 ``bbm_dot_scaled``
     and 6 ``bbm_dot_coded_batched`` a call) and T2 (none), its ce,
     moe_aux and mtp; both against the CPU port on 2-layer cuts (T2, 64
     tokens, the CPU on the card's routing); deepseek-v3's T1 kernel
     calls at their training shapes against their bounds.
 27. slice 11, the parallel layer (``parallel_phase``) on a world-1
     NCCL mesh from ``make_host_mesh`` (failing unless the backend is
     NCCL): ``sharded_filterbank`` at flush A's operands, exactly one
     ``fir_bank_rows`` on the tensor cores, equal to the unsharded call
     and, on 8 sampled channels, to the plain version on the CPU; the
     per-shard body on 4 blocks of 16 channels, exactly 4
     ``fir_bank_dot`` on the tensor cores (the auto form per shard),
     each block equal to its rows; ``compressed_allreduce`` with both
     codecs over qwen2-0.5b's full-width parameter shapes, sampled
     leaves bit-equal to the plain per-leaf formula on CPU copies, its ms
     and the bytes each collective moved (ROADMAP C18);
     ``init_train_state`` for qwen2-0.5b at full width, bit-equal to
     ``lm_init`` + ``init_opt``, saved and restored with ``shardings=``
     bit for bit, the peak and the seconds.  One card cannot hold two
     NCCL ranks, so the multi-rank arithmetic is the CPU tests' (gloo).

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
FIR_MMA_SOURCE = "src/repro_torch/kernels/csrc/fir_mma.cuh"
# profiler names of the FIR routes' kernels: the tensor cores' (both
# wrappers), the CUDA-core rows and dot kernels
FIR_KERNELS = {"mma": "fir_mma_kernel",
               "fir_bank_rows": "fir_bank_rows_kernel",
               "fir_bank_dot": "fir_bank_dot_kernel"}
REPLACES = {"fir_bank_rows": "src/repro/kernels/fir_kernel.py:106",
            "fir_bank_dot": "src/repro/kernels/fir_kernel.py:136",
            "quant_matmul": "src/repro/kernels/quant_matmul.py:69",
            "bbm_dot_scaled": "src/repro/kernels/bbm_matmul.py:112",
            "flash_attention": "src/repro/kernels/flash_attention.py:65",
            "flash_attention_amm":
                "src/repro/kernels/flash_attention.py:209",
            "normal_draw": "src/repro/models/common.py:264"}
MMA_SOURCE = "src/repro_torch/kernels/csrc/bbm_mma.cuh"
WIDE_FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wide.cuh"
TRAIN_SOURCES = {
    "bbm_dot_scaled": MMA_SOURCE,
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cuh",
    "flash_attention_amm": "src/repro_torch/kernels/csrc/flash_attention.cuh"}
# profiler (demangled) names: the tensor-core route's kernel (and the
# planes' packing pass), the tile's kernel
MMA_KERNEL = "bbm_mma::bbm_mma_kernel"
MMA_PACK = "bbm_pack_triplets_kernel"
TRAIN_KERNELS = {"bbm_dot_scaled": (MMA_KERNEL, "bbm_dot_kernel"),
                 "flash_attention": ("flash_exact_kernel",
                                     "flash_exact_wgmma_kernel"),
                 "flash_attention_amm": ("flash_amm_kernel",
                                         "flash_amm_mma_kernel",
                                         "flash_amm_tile_kernel")}
QM_SOURCE = "src/repro_torch/kernels/csrc/quant_matmul.cu"
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12          # TF32 on the tensor cores, dense
INT8_OPS_PER_S = 1979e12         # int8 on the tensor cores, dense
QM_KERNELS = ("qm_decode_kernel", "qm_tiled_kernel")


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
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


def ptxas_kernels(log: str) -> list:
    """(kernel, registers, spill store bytes) of every entry function in
    an ``nvcc -Xptxas -v`` log, the kernel named by its template (for
    example ``flash_exact_kernel<64>``)."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"\d([a-z_]+_kernel)I((?:L[ib]\d+E)+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if name and regs:
            args = ", ".join(re.findall(r"L[ib](\d+)E", name.group(2)))
            out.append((f"{name.group(1)}<{args}>",
                        int(regs.group(1)),
                        int(spill.group(1)) if spill else 0))
    return out


def mma_ptxas(log: str):
    """(registers, spill store bytes) of the tensor-core kernel in an
    ``nvcc -Xptxas -v`` log, or None."""
    for block in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        if "bbm_mma_kernel" in block.splitlines()[0] and regs:
            spill = re.search(r"(\d+) bytes spill stores", block)
            return int(regs.group(1)), int(spill.group(1)) if spill else 0
    return None


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


def kernel_device_ms(torch, fn, reps: int, kernel, per_call=None,
                     per_launch=False):
    """Mean device time per call of ``fn`` spent in the CUDA kernels whose
    names hold ``kernel`` (a string or a tuple of strings), from
    torch.profiler's trace of ``reps`` warm calls; None when the trace
    shows no device time for them, or, given ``per_call`` (the kernel
    launches of one call), when it holds another number of launches (a
    trace can lose the records of bare ctypes launches).  ``per_launch``
    gives the mean over the launches the trace holds instead, which a
    lost record does not bias (for a call of one launch)."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            t = getattr(ev, "self_device_time_total", None)
            t = t if t is not None else ev.self_cuda_time_total
            if not t:
                t = getattr(ev, "device_time_total", None) or 0.0
            total_us += t
            count += ev.count
    if per_launch:
        return total_us / count / 1e3 if total_us > 0 and count else None
    if per_call is not None and count != per_call * reps:
        return None
    return total_us / reps / 1e3 if total_us > 0 else None


def launch_ms(torch, fn, reps: int, kernel) -> tuple:
    """(device ms per launch, how it was measured) of ``fn``, one launch
    of the kernels named ``kernel`` a call: the profiler's mean over the
    launches its trace holds, tried three times (a trace can hold no
    record of bare ctypes launches); else CUDA events around ``reps``
    calls queued behind a spin kernel, so that the host's enqueue time
    hides behind the spin (each launch then also counts the device's gap
    to the next)."""
    for _ in range(3):
        t = kernel_device_ms(torch, fn, reps, kernel, per_launch=True)
        if t is not None:
            return t, "profiler"
    return spin_ms(torch, fn, reps), "events behind a spin"


def spin_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` between CUDA events around ``reps`` calls
    queued behind a spin kernel, so that the host's enqueue time hides
    behind the spin (each call then also counts the device's gap to the
    next)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)           # ~25 ms: the queue fills first
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep(torch, fk, booth_precode, dev) -> tuple:
    """Both wrappers on each route they can take (through the private
    hooks) and the plain dot form == the plain rows form on the card;
    returns (cases, calls on the tensor-core route)."""
    rng = np.random.default_rng(1)
    taps = 31
    # ragged; (70, 600) fills the SMs (the tensor cores' tiled schedule),
    # the others take its split schedule; (2, 4097) crosses a tile
    shapes = [(5, 1500), (1, 7), (3, 513), (70, 600), (2, 4097)]
    cases = mma = 0
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
                    routes = ["cuda-core"] + (
                        ["mma"] if fk.fir_bank_route(wl, vbl, kind, shift,
                                                     taps) == "mma" else [])
                    got = {"fir_bank_dot_plain":
                               fk.fir_bank_dot_plain(x, hm, hn, **kw)}
                    for route in routes:
                        got[f"fir_bank_rows ({route})"] = \
                            fk._fir_bank_rows_on(route, x, hm, hn, **kw)
                        got[f"fir_bank_dot ({route})"] = \
                            fk._fir_bank_dot_on(route, x, hm, hn, **kw)
                    mma += 2 * (len(routes) - 1)
                    torch.cuda.synchronize()
                    for name, y in got.items():
                        if not torch.equal(y, want):
                            bad = int((y != want).sum())
                            fail(f"{name} != plain rows at wl={wl} vbl={vbl} "
                                 f"kind={kind} shift={shift} C={c} N={n}: "
                                 f"{bad} elements differ")
                    cases += 1
    return cases, mma


# ------------------------------------------------------------ quant_matmul
def qm_check(torch, qm, got, want, tol, what: str) -> tuple:
    """(bit-equal, error / bound) of one kernel output against its plain
    version: ``torch.equal`` where the bound is zero, else within it;
    fails the run otherwise."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail(f"quant_matmul not finite at {what}")
    err = (got.double() - want.double()).abs()
    if bool((tol == 0).all()):
        if not torch.equal(got, want):
            fail(f"quant_matmul != plain at {what}: "
                 f"{int((got != want).sum())} elements differ where the "
                 f"sums are exact")
        return True, 0.0
    if bool((err > tol).any()):
        fail(f"quant_matmul off its plain version by {float(err.max())} "
             f"(bound {float(tol.max())}) at {what}")
    return torch.equal(got, want), float((err / tol.clamp_min(1e-300)).max())


def qm_operands(torch, rng, dev, m, k, n, wl):
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev)
    w = torch.from_numpy((0.02 * rng.standard_normal((k, n))).astype(
        np.float32)).to(dev)
    from repro_torch.kernels.ref import amm_scale
    return x, w, amm_scale(x, wl), amm_scale(w, wl)


def unaligned(torch, t):
    """A contiguous view of ``t``'s values whose data pointer is 4 bytes
    past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    off = next(i for i in range(1, 4)
               if (buf.data_ptr() + 4 * i) % 16 != 0)
    view = buf[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def qm_sweep(torch, qm, dev, mu: float, sigma: float) -> tuple:
    """The kernel against its plain version on the card; returns (cases,
    bit-equal cases, worst ratio of error to bound, edge cases)."""
    rng = np.random.default_rng(2)
    cases = equal = 0
    worst = 0.0
    for wl in (8, 12, 16):
        for noisy in (False, True):
            for m in (1, 8, 200):
                for k in (64, 512, 896, 4864):
                    for n in (896, 4864, 130):
                        x, w, sx, sw = qm_operands(torch, rng, dev, m, k, n,
                                                   wl)
                        mu_, sig_ = (mu, sigma) if noisy else (0.0, 0.0)
                        seed = int(rng.integers(0, 2 ** 31 - 1))
                        got = qm.quant_matmul(x, w, sx, sw, mu_, sig_,
                                              wl=wl, seed=seed)
                        want = qm.quant_matmul_plain(
                            x, w, sx, sw, mu_, sig_, wl=wl, seed=seed,
                            bm=128, bk=512, bn=128)
                        tol = qm.quant_matmul_tolerance(
                            x, w, sx, sw, mu_, sig_, wl=wl)
                        eq, r = qm_check(torch, qm, got, want, tol,
                                         f"wl={wl} M={m} K={k} N={n} "
                                         f"noise={noisy}")
                        equal += int(eq)
                        worst = max(worst, r)
                        cases += 1
    for m, n, bm, bn in ((8, 4864, 8, 128), (200, 130, 128, 128),
                         (1, 896, 1, 128), (300, 300, 64, 32)):
        seed = int(rng.integers(0, 2 ** 31 - 1))
        got = qm.hash_words(m, n, seed, bm=bm, bn=bn, device=dev)
        want = qm.hash_words_plain(m, n, seed, bm=bm, bn=bn, device=dev)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"the hash's uniforms differ at ({m}, {n}) tiles "
                 f"({bm}, {bn})")
    edges = qm_edges(torch, qm, dev, rng, mu, sigma)
    edges.update(qm_quantizer_check(torch, qm, dev, rng))
    return cases, equal, worst, edges


def qm_quantizer_check(torch, qm, dev, rng) -> dict:
    """The kernel's quantizer (an exact quotient without a division per
    element) against the true division: its quotient bit-equal to
    ``__fdiv_rn`` over every dividend significand for 16,384 random
    divisor significands and the edge ones, at exponents across its fast
    range; its codes bit-equal to the CPU's ``_codes`` on 2^24 random
    float32 bit patterns (every exponent, zeros, subnormals, infinities,
    NaN) at scales inside and outside that range, wl 8 and 16."""
    sig = np.concatenate([
        1.0 + rng.random(16384),
        [1.0, np.nextafter(np.float32(1), np.float32(2)),
         np.nextafter(np.float32(2), np.float32(1)), 1.5, np.sqrt(2.0)]])
    exps = rng.integers(-38, 38, sig.size)
    divisors = (sig * np.exp2(exps)).astype(np.float32)
    divisors[::2] *= -1
    bad = qm.quotient_mismatches(torch.from_numpy(divisors).to(dev))
    if bad:
        fail(f"the kernel's quotient differs from __fdiv_rn in {bad} cases")
    bits = rng.integers(0, 2 ** 32, 1 << 24, dtype=np.uint64).astype(
        np.uint32)
    v = torch.from_numpy(bits.view(np.float32).copy())
    v[:4] = torch.tensor([0.0, -0.0, float("inf"), float("nan")])
    scales = (2.7e-6, 1.2e-4, 1.0, 2.0 ** -38, 2.0 ** 38, 2.0 ** -39,
              2.0 ** 39, 1e-12, 1e-30, 3e38, 0.0)
    cases = 0
    vd = v.to(dev)
    for s in scales:
        for wl in (8, 16):
            st = torch.tensor(s, dtype=torch.float32)
            got = qm.quant_codes(vd, st.to(dev), wl).cpu()
            want = qm.quant_codes(v, st, wl)
            if not torch.equal(torch.nan_to_num(got, nan=0.5),
                               torch.nan_to_num(want, nan=0.5)):
                fail(f"the kernel's codes differ from the CPU's at scale "
                     f"{s} wl {wl}: {int((got != want).sum())} values")
            cases += 1
    return {"divisors": int(divisors.size), "code_scales": cases}


# the route edges: the rows on each side of a decode row group (8, 16)
# and of the decode threshold (64), M = 1 (with K = 4864 too), a prefill;
# (M, K, N) at qwen2-0.5b's MLP shapes
QM_EDGE_MS = (1, 7, 8, 9, 16, 17, 64, 65, 256)
QM_EDGE_KN = ((896, 4864), (4864, 896))


def qm_edges(torch, qm, dev, rng, mu: float, sigma: float) -> dict:
    """The kernel at the route edges, with unaligned operands and ragged
    N, forced onto each route, against the plain version; the tiled route
    without noise bit-equal to ``quant_matmul_emulated`` (each chunk
    partial its exact sum rounded once) at every wl; counts by kind."""
    from repro_torch.kernels.ref import amm_scale
    out = {"edges": 0, "unaligned": 0, "forced": 0, "tiled_bitwise": 0}

    def one(x, w, sx, sw, wl, noisy, what, plan=None, kw=None):
        kw = kw or {}
        mu_, sig_ = (mu, sigma) if noisy else (0.0, 0.0)
        seed = int(rng.integers(0, 2 ** 31 - 1))
        if plan is None:
            got = qm.quant_matmul(x, w, sx, sw, mu_, sig_, wl=wl, seed=seed,
                                  **kw)
        else:
            m, k = x.shape
            n = w.shape[1]
            bk = min(kw.get("bk", 512), k)
            got = torch.empty((m, n), dtype=torch.float32, device=dev)
            qm._launch(x, w, sx, sw, got, mu_, sig_, wl=wl, seed=seed,
                       bm=min(128, m), bk=bk, bn=min(128, n), plan=plan)
        full = dict(bm=128, bk=512, bn=128)
        full.update(kw)
        want = qm.quant_matmul_plain(x, w, sx, sw, mu_, sig_, wl=wl,
                                     seed=seed, **full)
        tol = qm.quant_matmul_tolerance(x, w, sx, sw, mu_, sig_, wl=wl,
                                        bk=full["bk"])
        qm_check(torch, qm, got, want, tol, what)
        return got, seed

    for m in QM_EDGE_MS:
        for k, n in QM_EDGE_KN:
            for wl in (8, 16):
                x, w, sx, sw = qm_operands(torch, rng, dev, m, k, n, wl)
                for noisy in (False, True):
                    one(x, w, sx, sw, wl, noisy,
                        f"edge M={m} K={k} N={n} wl={wl} noise={noisy}")
                    out["edges"] += 1
    # unaligned views and N = 130 (the scalar-load variants), both routes
    for m in (8, 200):
        for k, n in ((896, 130), (4864, 896), (100, 64)):
            x, w, sx, sw = qm_operands(torch, rng, dev, m, k, n, 16)
            for xv, wv, tag in ((unaligned(torch, x), w, "x"),
                                (x, unaligned(torch, w), "w")):
                one(xv, wv, sx, sw, 16, True,
                    f"unaligned {tag} M={m} K={k} N={n}")
                out["unaligned"] += 1
    # each route forced at the other's shapes; odd K chunks (bk = 100:
    # not a multiple of 4; bk = 32: many chunks a rank); the longest
    # chunk the tiled route's int32 sums hold, and one row more refused
    x, w, sx, sw = qm_operands(torch, rng, dev, 4, qm.MAX_CHUNK + 1, 64, 16)
    try:
        qm.quant_matmul(x, w, sx, sw, wl=16, bk=qm.MAX_CHUNK + 1)
    except ValueError:
        pass
    else:
        fail(f"quant_matmul took a K chunk of {qm.MAX_CHUNK + 1} rows")
    for m, k, n, bk in ((32, 896, 4864, 512), (8, 4864, 896, 512),
                        (64, 4864, 896, 512), (8, 896, 4864, 100),
                        (9, 4864, 130, 32), (130, 32768, 64, 32768),
                        (8, 32768, 64, 32768), (200, 4864, 130, 512)):
        x, w, _, _ = qm_operands(torch, rng, dev, m, k, n, 16)
        plans = {p.route: p for p in (qm.quant_matmul_plan(
            m, k, n, min(bk, k), max_m) for max_m in (0, 1 << 30))}
        for plan in plans.values():
            for wl in (8, 16):
                sx, sw = amm_scale(x, wl), amm_scale(w, wl)
                got, seed = one(x, w, sx, sw, wl, False,
                                f"{plan.route} forced M={m} K={k} N={n} "
                                f"bk={bk} wl={wl}", plan=plan,
                                kw={"bk": bk})
                out["forced"] += 1
                if plan.route == "tiled":
                    want = qm.quant_matmul_emulated(
                        x, w, sx, sw, 0.0, 0.0, wl=wl, seed=seed,
                        bm=min(128, m), bk=min(bk, k), bn=min(128, n),
                        plan=plan)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fail(f"the tiled route != its emulation at M={m} "
                             f"K={k} N={n} bk={bk} wl={wl}: "
                             f"{int((got != want).sum())} elements differ")
                    out["tiled_bitwise"] += 1
    return out


def qm_bound_ms(m: int, k: int, n: int, wl: int = 16) -> tuple:
    """(bound ms, what bounds it) of one quant_matmul call: x, w read
    once and out written once in f32 over 3.35 TB/s, against the fewest
    operations the function admits.  Its products are exact integer
    products of wl-bit codes, so the int8 tensor cores can form them:
    one 8-bit product per code pair at wl <= 8, four (the byte split)
    above, 2*M*K*N operations each over 1,979 TOP/s.  The quantizer's
    4 float32 operations per input element (divide, round, two clips)
    go over 67 TFLOP/s on their own pipe; the bound is the largest of
    the three times."""
    t_bytes = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    t_ops = (1 if wl <= 8 else 4) * 2 * m * k * n / INT8_OPS_PER_S
    t_quant = 4 * (m * k + k * n) / F32_OPS_PER_S
    t = max(t_bytes, t_ops, t_quant)
    return t * 1e3, ("bytes" if t == t_bytes else "operations")


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
    (kind, tokens, position, logits) for a replay, and with
    ``keep_caches`` a CPU copy of the caches each call was handed
    (``cache_log``)."""

    def __init__(self, torch, fns, keep: bool, keep_caches: bool = False):
        self.torch, self.keep = torch, keep
        self.prefill_fn, self.decode_fn = fns
        self.calls = 0
        self.bad = None
        self.log = []
        self.keep_caches = keep_caches
        self.cache_log = []

    def _take(self, c):
        if self.keep_caches:
            self.cache_log.append({k: v.to("cpu", copy=True)
                                   for k, v in c.items()})

    def _note(self, kind, tokens, pos, logits):
        self.calls += 1
        nbad = (~self.torch.isfinite(logits)).sum()
        self.bad = nbad if self.bad is None else self.bad + nbad
        if self.keep:
            self.log.append((kind, tokens.cpu(), pos, logits.float().cpu()))

    def prefill(self, p, t, c):
        self._take(c)
        logits, c = self.prefill_fn(p, t, c)
        self._note("prefill", t, 0, logits)
        return logits, c

    def decode(self, p, t, c, q):
        self._take(c)
        logits, c = self.decode_fn(p, t, c, q)
        self._note("decode", t, q, logits)
        return logits, c


class KernelCapture:
    """While ``calls`` is a list, every call the model makes through
    ``models.common``'s names of the kernel wrappers is appended to it as
    (wrapper name, args, kwargs, output); ``close()`` (or leaving a
    ``with`` block) restores the names."""

    NAMES = ("quant_matmul", "bbm_dot_scaled", "bbm_dot_coded_batched")

    def __init__(self, common):
        self.common, self.calls = common, None
        self.orig = {n: getattr(common, n) for n in self.NAMES}
        for n, f in self.orig.items():
            setattr(common, n, self._wrap(n, f))

    def _wrap(self, name, f):
        def call(*args, **kw):
            out = f(*args, **kw)
            if self.calls is not None:
                self.calls.append((name, args, kw, out))
            return out
        return call

    def take(self) -> list:
        """The calls recorded so far; recording stops."""
        calls, self.calls = self.calls, None
        return calls

    def close(self):
        for n, f in self.orig.items():
            setattr(self.common, n, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def qm_capture_check(torch, qm, calls) -> tuple:
    """The recorded ``quant_matmul`` calls (``KernelCapture``) against the
    plain version on their own inputs, within ``quant_matmul_tolerance``;
    returns (calls, worst error / bound, max abs error)."""
    import inspect
    sig = inspect.signature(qm.quant_matmul)
    worst, max_err, n = 0.0, 0.0, 0
    for name, args, kw, out in calls:
        if name != "quant_matmul":
            continue
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        c = a.arguments
        want = qm.quant_matmul_plain(
            c["x"], c["w"], c["s_x"], c["s_w"], c["mu"], c["sigma"],
            **{k: c[k] for k in ("wl", "seed", "bm", "bk", "bn")})
        tol = qm.quant_matmul_tolerance(c["x"], c["w"], c["s_x"], c["s_w"],
                                        c["mu"], c["sigma"], wl=c["wl"],
                                        bk=c["bk"])
        err = (out.double() - want.double()).abs()
        if bool((err > tol).any()):
            fail(f"a main-path quant_matmul call at {tuple(c['x'].shape)} x "
                 f"{tuple(c['w'].shape)} is off its plain version by "
                 f"{float(err.max())}")
        worst = max(worst, float((err / tol.clamp_min(1e-300)).max()))
        max_err = max(max_err, float(err.max()))
        n += 1
    return n, worst, max_err


# new tokens a request in qwen2-0.5b's serving runs (noise fused, bitexact
# from the code cache, noise plain): the decode loops are host-bound, and
# their length is the smoke's largest cost on a slow host
SERVE_NEW = 32


def lm_main_path(torch, dev, cfg, rt, params, qm) -> dict:
    """Serve the workload through the continuous Scheduler; check it."""
    from repro_torch.serve import Request, Scheduler, make_serve_fns
    rng = np.random.default_rng(3)
    rec = Recorder(torch, make_serve_fns(cfg, rt), keep=False)
    sched = Scheduler(cfg, rt, params, 8, 512, decode_fn=rec.decode,
                      prefill_fn=rec.prefill, continuous=True, device=dev)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(32, 257))).tolist(),
        max_new=SERVE_NEW)
        for i in range(32)]
    for r in reqs:
        sched.submit(r)
    step_ms = []
    import repro_torch.models.common as common
    with KernelCapture(common) as cap:
        qm.quant_matmul.launches = 0
        cap.calls = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            pre = sched.stats["prefills"]
            ts = time.perf_counter()
            n = sched.step()
            if cap.calls is not None:
                captured = cap.take()
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
    if any(r.error or len(r.out) != SERVE_NEW for r in reqs):
        fail("a request ended early or failed")
    if int(rec.bad) != 0:
        fail(f"{int(rec.bad)} non-finite logits on the main path")
    # the first step's kernel calls against the plain version
    ms = sorted({args[0].shape[0] for name, args, _, _ in captured
                 if name == "quant_matmul"})
    n_qm, worst, max_err = qm_capture_check(torch, qm, captured)
    if n_qm != len(captured) or n_qm != 2 * per_call or ms[0] != 8 \
            or len(ms) != 2:
        fail(f"the first step captured {len(captured)} calls ({n_qm} "
             f"quant_matmul) at M={ms}, expected {per_call} quant_matmul "
             f"of a prefill and {per_call} at M=8")
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


def lm_cpu_check(torch, dev, cfg, rt, params, kv_codes=False,
                 state_forced=False) -> dict:
    """Two requests on the card, then on the CPU port teacher-forced on
    the card's tokens: every step's logits within ``LOGIT_RTOL``.  Each
    side's step functions carry its own weight planes (bitexact mode);
    ``kv_codes``: both serve from the int-code KV cache.
    ``state_forced``: each CPU call also starts from the caches the card's
    call was handed (a recurrent state carries the rounding of every
    earlier call into the next, and a deep SSM stack amplifies it), so
    every call is held from the same input."""
    from repro_torch.serve import Request, Scheduler, make_serve_fns
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (32, 40)]
    rec = Recorder(torch, make_serve_fns(
        cfg, rt, amm_planes=rt.build_planes(cfg, params),
        kv_codes=kv_codes), keep=True, keep_caches=state_forced)
    card = Scheduler(cfg, rt, params, 8, 64, decode_fn=rec.decode,
                     prefill_fn=rec.prefill, continuous=True,
                     kv_codes=kv_codes, device=dev)
    for i, p in enumerate(prompts):
        card.submit(Request(rid=i, prompt=p, max_new=8))
    while card.step():
        pass
    cpu_params = _to_cpu(params)
    fns = make_serve_fns(cfg, rt, amm_planes=rt.build_planes(cfg, cpu_params),
                         kv_codes=kv_codes)
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

    def card_caches(c):
        if not state_forced:
            return c
        return {k: v.clone() for k, v in rec.cache_log[state["i"]].items()}

    def prefill(p, t, c):
        logits, c = fns[0](p, t, card_caches(c))
        return forced("prefill", logits), c

    def decode(p, t, c, q):
        logits, c = fns[1](p, t, card_caches(c), q)
        return forced("decode", logits), c

    cpu = Scheduler(cfg, rt, cpu_params, 8, 64, decode_fn=decode,
                    prefill_fn=prefill, continuous=True, kv_codes=kv_codes,
                    device="cpu")
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


# quant_matmul before its redesign at lm_timing's shapes, device ms:
# PERF.md's kernel table (an NVIDIA H100 80GB HBM3 at 700.00 W), quoted,
# not measured here
QM_BEFORE_MS = {(8, 896, 4864): 0.084673, (8, 4864, 896): 0.084167,
                (256, 896, 4864): 0.162091}
QM_ROUTE_MS = (8, 16, 32, 48, 64, 80, 96, 128)   # rows timed on both routes


def qm_route_times(torch, qm, dev, rt, params) -> list:
    """Device ms of each route, forced, at (M, 896) x (896, 4864) and
    (M, 4864) x (4864, 896) for M in ``QM_ROUTE_MS``, each call on the
    next layer's weight as on the main path (the 24 weights overflow the
    L2, so each is read from device memory): where the decode route stops
    winning sets ``DECODE_MAX_M``."""
    from repro_torch.kernels.ref import amm_scale
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    mlp = params["layers"]["mlp"]
    lines = []
    for name, (k, n) in (("w_gate", (896, 4864)), ("w_down", (4864, 896))):
        ws = [(w, amm_scale(w, 16)) for w in mlp[name]]
        row = []
        for m in QM_ROUTE_MS:
            x = torch.randn((m, k), generator=gen, device=dev)
            sx = amm_scale(x, 16)
            out = torch.empty((m, n), device=dev)
            times = {}
            for max_m in (1 << 30, 0):
                plan = qm.quant_matmul_plan(m, k, n, 512, max_m)
                turn = [0]

                def fn():
                    w, sw = ws[turn[0] % len(ws)]
                    turn[0] += 1
                    qm._launch(x, w, sx, sw, out, rt.amm.mu, rt.amm.sigma,
                               wl=16, seed=7, bm=min(128, m), bk=512,
                               bn=min(128, n), plan=plan)
                times[plan.route] = launch_ms(torch, fn, 2 * len(ws),
                                              QM_KERNELS)
            row.append(f"M={m} " + " ".join(
                f"{r} {t:.6f}" + ("" if how == "profiler" else f" ({how})")
                for r, (t, how) in times.items()))
        lines.append(f"quant_matmul routes at (M, {k}) x ({k}, {n}), device "
                     f"ms (profiler unless marked; weights from device "
                     f"memory): " + ", ".join(row)
                     + f"; the plan's threshold DECODE_MAX_M = "
                     f"{qm.DECODE_MAX_M}")
    return lines


def qm_host_us(torch, qm, dev, cfg, rt, params) -> str:
    """The wrapper's host time per call at the decode shape: 1,000 calls
    without a sync (the card keeps up), against its bare launch."""
    from repro_torch.kernels.ref import amm_scale
    w = params["layers"]["mlp"]["w_gate"][0]
    x = torch.randn((8, cfg.d_model), device=dev)
    sx, sw = amm_scale(x, 16), amm_scale(w, 16)
    out = torch.empty((8, cfg.d_ff), device=dev)
    plan = qm.quant_matmul_plan(8, cfg.d_model, cfg.d_ff, 512)
    calls = {
        "wrapper": lambda: qm.quant_matmul(x, w, sx, sw, rt.amm.mu,
                                           rt.amm.sigma, wl=16, seed=7),
        "bare launch": lambda: qm._launch(
            x, w, sx, sw, out, rt.amm.mu, rt.amm.sigma, wl=16, seed=7,
            bm=8, bk=512, bn=128, plan=plan)}
    got = {}
    for name, fn in calls.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        got[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    return (f"quant_matmul host time at (8, {cfg.d_model}) x ({cfg.d_model}, "
            f"{cfg.d_ff}), 1,000 calls without a sync: wrapper "
            f"{got['wrapper']:.3f} us per call, its bare ctypes launch "
            f"{got['bare launch']:.3f} us")


def decode_window(torch, sched, name: str, kernels, prefills: int,
                  steps: int = 5, forbid=(), stats=None) -> tuple:
    """A profiled window of ``steps`` pure decode steps of ``sched``
    (device time only), then 2 more with the host's operations traced
    too; returns (printed lines, the window's idle share).  ``kernels``:
    the profiler names of the ``name`` wrapper's kernels, whose share is
    reported apart; ``prefills``: the scheduler's prefills so far, which
    the window must not add to; ``forbid``: kernel names that must not
    run in the window; ``stats``: a dict that gets the window's device
    busy and wall ms per step."""
    from torch.profiler import ProfilerActivity, profile
    lines = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, k_us, k_n, launches, by_kernel = 0.0, 0.0, 0, 0, []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = t if t is not None else ev.self_cuda_time_total
        if t <= 0:
            continue
        busy_us += t
        launches += ev.count
        by_kernel.append((t, ev.count, ev.key))
        if any(q in ev.key for q in kernels):
            k_us += t
            k_n += ev.count
        if any(q in ev.key for q in forbid):
            fail(f"{ev.key[:90]} ran in the decode window")
    idle = 1.0 - busy_us / 1e3 / wall_ms
    if stats is not None:
        stats.update(busy_ms=busy_us / steps / 1e3, wall_ms=wall_ms / steps)
    lines.append(
        f"decode window ({steps} steps, {sched.stats['steps']} so far, "
        f"profiled): {wall_ms / steps:.3f} ms per step, device busy "
        f"{busy_us / steps / 1e3:.3f} ms per step ({name} "
        f"{k_us / steps / 1e3:.3f} ms in {k_n / steps:.0f} launches), idle "
        f"share {idle:.4f}, {launches / steps:.0f} device operations per "
        f"step")
    for t, count, key in sorted(by_kernel, reverse=True)[:10]:
        lines.append(f"  decode step device time: {t / steps / 1e3:.4f} ms "
                     f"in {count / steps:.0f} launches of {key[:90]}")
    host_steps = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(host_steps):
            sched.step()
        torch.cuda.synchronize()
        host_wall = (time.perf_counter() - t0) * 1e3 / host_steps
    if sched.stats["prefills"] != prefills:
        fail("a profiled decode window admitted a prefill")
    ops = sorted(((ev.self_cpu_time_total, ev.count, ev.key)
                  for ev in prof.key_averages()
                  if ev.self_cpu_time_total > 0), reverse=True)
    in_ops = sum(t for t, _, _ in ops) / 1e3 / host_steps
    lines.append(
        f"decode host account ({host_steps} steps, host and device "
        f"profiled): {host_wall:.3f} ms per step with the profiler's own "
        f"cost, {in_ops:.3f} ms of it inside torch operations (self CPU), "
        f"{sum(c for _, c, _ in ops) / host_steps:.0f} host operations per "
        f"step; the rest is Python between them")
    for t, count, key in ops[:12]:
        lines.append(f"  decode step host time: {t / 1e3 / host_steps:.4f} "
                     f"ms self CPU in {count / host_steps:.0f} calls of "
                     f"{key[:70]}")
    return lines, idle


def lm_timing(torch, dev, cfg, rt, params, qm, amm_scale) -> tuple:
    """quant_matmul at the main path's shapes, both routes around the
    threshold, the wrapper's host time, and a profiled decode window
    with its host-side account; returns (kernel rows, printed lines, the
    window's idle share)."""
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
        dev_ms, how = launch_ms(torch, run, reps, QM_KERNELS)
        call_ms = cuda_ms(torch, run, reps)
        plain_ms = cuda_ms(torch, plain, 5)
        lib_ms = cuda_ms(torch, library, reps)
        turn[0] = 0
        got = run()
        turn[0] = 0
        err = float((got.double() - plain().double()).abs().max())
        bound, by = qm_bound_ms(m, k, n)
        rows.append((m, k, n, dev_ms, call_ms, plain_ms, bound, by, err,
                     lib_ms, how))
        route = qm.quant_matmul_plan(m, k, n, 512).route
        dev_txt = f"{dev_ms:.6f} ms"
        lines.append(
            f"quant_matmul at ({m}, {k}) x ({k}, {n}), {route} route, "
            f"weights from device memory: kernel {dev_txt} on the device "
            f"({how}, mean of the launches, one a call), wrapper call "
            f"{call_ms:.6f} ms "
            f"(CUDA events), plain {plain_ms:.6f} ms, bound {bound:.6f} ms "
            f"({by}), max abs error vs plain {err}; yardstick f32 "
            f"torch.matmul {lib_ms:.6f} ms")
        ms = dev_ms
        before = QM_BEFORE_MS[(m, k, n)]
        lines.append(
            f"quant_matmul redesigned: {ms:.6f} ms against {before:.6f} ms "
            f"before the redesign at ({m}, {k}) x ({k}, {n}) (before / now "
            f"{before / ms:.2f}; before: PERF.md's kernel table, an NVIDIA "
            f"H100 80GB HBM3 at 700.00 W), bound {bound:.6f} ms ({by}; "
            f"bound / time {bound / ms:.4f}), the f32 torch.matmul "
            f"yardstick {lib_ms:.6f} ms (now / yardstick "
            f"{ms / lib_ms:.3f})")
    lines += qm_route_times(torch, qm, dev, rt, params)
    lines.append(qm_host_us(torch, qm, dev, cfg, rt, params))
    # a profiled window of 5 pure decode steps with 8 residents, then 2
    # more with the host's operations traced too
    sched = Scheduler(cfg, rt, params, 8, 512, continuous=True, device=dev)
    rng = np.random.default_rng(6)
    for i in range(8):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, 64).tolist(), max_new=40))
    for _ in range(10):
        sched.step()                 # admit all 8 and warm up
    win_lines, idle = decode_window(torch, sched, "quant_matmul",
                                    QM_KERNELS, prefills=8)
    lines += win_lines
    return rows, lines, idle


# ---------------------------------------------------------------- training
def train_modules():
    import importlib
    return (importlib.import_module("repro_torch.kernels.bbm_matmul"),
            importlib.import_module("repro_torch.kernels.flash_attention"))


def b2_routes(tb, wl: int, vbl: int, shift=None) -> list:
    """Every route a call at (wl, vbl, shift) can take, and None (the
    rule's own pick)."""
    routes = [None, "tile"]
    if tb._mma_refusal(wl, vbl, shift) is None:
        routes.append("mma")
    return routes


def routed(tb, name: str, route):
    """The public wrapper ``name`` for ``route`` None (the rule's pick),
    else the module's private hook that forces ``route``."""
    if route is None:
        return getattr(tb, name)
    hook = getattr(tb, f"_{name}_on")
    return lambda *a, **kw: hook(route, *a, **kw)


def b2_sweep(torch, tb, dev) -> tuple:
    """bbm_dot_scaled == its plain version, bit for bit, on each route;
    then bbm_dot_planes on clean, plane-faulted and accumulator-faulted
    planes on each route.  The plain version runs on the card where the
    operating point has an f32 envelope, else on CPU copies (torch has no
    int32 matmul on the card).  Returns (cases, tensor-core cases)."""
    from repro_torch.core.faults import FaultSpec, apply_plane_faults
    from repro_torch.kernels.booth_rows import (amm_chunk_len, booth_precode,
                                                f32_exact_chunk_len)
    rng = np.random.default_rng(7)
    cases = mma = 0
    for wl, vbl in ((8, 5), (12, 7), (16, 13), (16, 3), (16, 0)):
        c = amm_chunk_len(wl, vbl)
        lim = 1 << (wl - 1)
        on = dev if f32_exact_chunk_len(wl, vbl) else "cpu"
        for kind in (0, 1):
            for k in sorted({max(1, c - 1), c, c + 1}):
                m, n = (3, 5) if k > 100_000 else (37, 70)
                x = rng.integers(-lim, lim, (m, k)).astype(np.int32)
                w = rng.integers(-lim, lim, (k, n)).astype(np.int32)
                x[0], x[1] = lim - 1, -lim              # envelope edges
                w[:, 0], w[:, 1] = lim - 1, -lim
                x, w = (torch.from_numpy(a).to(dev) for a in (x, w))
                want = tb.bbm_dot_scaled_plain(x.to(on), w.to(on), wl=wl,
                                               vbl=vbl, kind=kind)
                for route in b2_routes(tb, wl, vbl):
                    before = tb.bbm_dot_scaled.mma_launches
                    got = routed(tb, "bbm_dot_scaled", route)(
                        x, w, wl=wl, vbl=vbl, kind=kind)
                    torch.cuda.synchronize()
                    took = "mma" if tb.bbm_dot_scaled.mma_launches > before \
                        else "tile"
                    if took != (route or tb.bbm_dot_route(wl, vbl, kind)):
                        fail(f"bbm_dot_scaled route {route} at wl={wl} "
                             f"vbl={vbl} launched the {took} route")
                    if not torch.equal(got.to(on), want):
                        fail(f"bbm_dot_scaled ({took} route) != plain at "
                             f"wl={wl} vbl={vbl} kind={kind} K={k}: "
                             f"{int((got.to(on) != want).sum())} elements "
                             f"differ")
                    cases += 1
                    mma += took == "mma"
            # the planes-in entry, one past the chunk where it is short
            k = min(c + 1, 20_000)
            x = torch.from_numpy(rng.integers(-lim, lim, (37, k)).astype(
                np.int32)).to(dev)
            w = torch.from_numpy(rng.integers(-lim, lim, (k, 70)).astype(
                np.int32)).to(dev)
            hm, hn = booth_precode(w, wl)
            for fault in (None, FaultSpec(target="plane", p=0.05, seed=k),
                          FaultSpec(target="acc", p=0.05, bit=9, seed=k)):
                fm, fn = (t.contiguous() for t in apply_plane_faults(
                    hm, hn, fault, vbl=vbl))
                acc = fault if fault is not None and fault.target == "acc" \
                    else None
                want = tb.bbm_dot_planes_plain(
                    x.to(on), fm.to(on), fn.to(on), wl=wl, vbl=vbl,
                    kind=kind, fault=acc)
                for route in b2_routes(tb, wl, vbl):
                    got = routed(tb, "bbm_dot_planes", route)(
                        x, fm, fn, wl=wl, vbl=vbl, kind=kind, fault=acc)
                    torch.cuda.synchronize()
                    if not torch.equal(got.to(on), want):
                        fail(f"bbm_dot_planes (route {route}) != plain at "
                             f"wl={wl} vbl={vbl} kind={kind} K={k} under "
                             f"{fault}")
                    cases += 1
                    mma += route == "mma"
    return cases, mma


def flash_amm_check(torch, tf, q, k, v, *, kind, causal, what,
                    want_res=False, wl=16, vbl=13, plain_cpu=False):
    """The amm kernel against its plain version on the same inputs, held
    by ``flash_amm_compare``: score products bit-equal, P's codes and
    scales within what float rounding moves, P V products bit-equal where
    P's codes agree, the output within the bound of the codes that moved.
    ``plain_cpu``: the plain version run on CPU copies of the operands
    (an operating point with no f32 envelope: its int32 contraction runs
    on the CPU only), the wrapper and the operands on the card as
    always.  Returns the report (and the kernel's residuals with
    ``want_res``)."""
    b, h, s_len, d = q.shape
    ops = tf.flash_amm_operands(q, k, v, wl=wl)
    got, res = tf.flash_attention_amm(q, k, v, wl=wl, vbl=vbl, kind=kind,
                                      causal=causal, residuals=True)
    if plain_cpu:
        cpu = lambda tree: {  # noqa: E731
            n: t.cpu() if torch.is_tensor(t) else t for n, t in tree.items()}
        ops, res, got = cpu(ops), cpu(res), got.cpu()
    want, wres = tf.flash_amm_plain(ops, wl=wl, vbl=vbl, kind=kind,
                                    causal=causal, residuals=True)
    rep = tf.flash_amm_compare(
        ops, dict(res, out=got.reshape(b * h, s_len, d)),
        dict(wres, out=want[:, :s_len]), wl=wl, vbl=vbl, causal=causal)
    if not rep["ok"]:
        fail(f"flash_attention_amm disagrees with its plain version {what} "
             f"kind={kind} wl={wl} vbl={vbl}: {rep}")
    return (rep, res) if want_res else rep


def flash_exact_check(torch, tf, q, k, v, *, causal, what) -> float:
    """The exact kernel within ``flash_tolerance`` of its plain version on
    the same inputs; returns the worst error / bound."""
    got = tf.flash_attention(q, k, v, causal=causal)
    want = tf.flash_attention_plain(q, k, v, causal=causal)
    tol = tf.flash_tolerance(q, k, v)
    err = (got.double() - want.double()).abs()
    if not bool((err <= tol).all()):
        fail(f"flash_attention off its plain version by {float(err.max())} "
             f"{what}")
    return float((err / tol).max())


def flash_amm_kv_len_check(torch, tf, q, k, v, *, kv_len, kind, causal):
    """The amm kernel with a valid KV length below the padded one (the
    tiles from ``kv_len`` on dead for every row) against its plain version
    on the same operands, by ``flash_amm_compare``."""
    ops = dict(tf.flash_amm_operands(q, k, v, wl=16), skv=kv_len)
    got, res = tf._amm_launch(ops, wl=16, vbl=13, kind=kind, causal=causal,
                              residuals=True)
    want, wres = tf.flash_amm_plain(ops, wl=16, vbl=13, kind=kind,
                                    causal=causal, residuals=True)
    rep = tf.flash_amm_compare(ops, dict(res, out=got), dict(wres, out=want),
                               wl=16, vbl=13, causal=causal)
    if not rep["ok"]:
        fail(f"flash_attention_amm disagrees with its plain version at "
             f"kv_len={kv_len} of {k.shape[2]} causal={causal} kind={kind}: "
             f"{rep}")
    return rep


# the flash sweep's cross-attention shapes (Sq, Skv): non-square, and a
# ragged key length
FLASH_CROSS = ((128, 384), (200, 300))


def flash_sweep(torch, tf, dev) -> tuple:
    """Both flash kernels within their bounds of their plain versions
    (the amm kernel through ``flash_amm_check``) at S in {128, 384, 512}
    (d 64), a ragged S = 200 at d in {16, 32, 64}, causal and not, at
    Sq != Skv (``FLASH_CROSS``, not causal), and
    the amm kernel with a valid KV length below the padded one; kind 1's
    dead tiles computed (their P V products not 0) at S = 512 causal; the
    whole amm output bit-equal where P is one-hot.  Returns (cases, worst
    error / bound of each kernel, codes moved / codes)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    cases, worst = 0, {"flash_attention": 0.0, "flash_attention_amm": 0.0}
    moved = [0, 0]

    def note(rep):
        worst["flash_attention_amm"] = max(worst["flash_attention_amm"],
                                           rep["worst_ratio"])
        moved[0] += rep["codes_moved"]
        moved[1] += rep["codes"]

    shapes = [(4, 14, s_len, 64) for s_len in (128, 384, 512)] + [
        (2, 6, 200, d) for d in (16, 32, 64)]
    for shape in shapes:
        for causal in (True, False):
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(3))
            what = f"at {shape} causal={causal}"
            worst["flash_attention"] = max(
                worst["flash_attention"],
                flash_exact_check(torch, tf, q, k, v, causal=causal,
                                  what=what))
            cases += 1
            for kind in (0, 1):
                rep, res = flash_amm_check(torch, tf, q, k, v, kind=kind,
                                           causal=causal, what=what,
                                           want_res=True)
                note(rep)
                cases += 1
                if kind == 1 and causal and shape[2] == 512:
                    # tile 3 is dead for q-block 0: kind 1 computes it
                    if not bool((res["pv"][:, 3, :128] != 0).any()):
                        fail("kind 1's dead tiles were not computed")
    # Sq != Skv (cross-attention): a non-square case and a ragged key
    # length (300 = 2 x 128 + 44 for the amm kernel's tiles, 4 x 64 + 44
    # for the exact kernel's), both non-causal
    for sq, skv in FLASH_CROSS:
        q = torch.randn((2, 6, sq, 64), generator=gen, device=dev)
        k, v = (torch.randn((2, 6, skv, 64), generator=gen, device=dev)
                for _ in range(2))
        what = f"at q {tuple(q.shape)} against {skv} keys, not causal"
        worst["flash_attention"] = max(
            worst["flash_attention"],
            flash_exact_check(torch, tf, q, k, v, causal=False, what=what))
        cases += 1
        for kind in (0, 1):
            note(flash_amm_check(torch, tf, q, k, v, kind=kind, causal=False,
                                 what=what))
            cases += 1
    # valid KV length below the padded one: whole tiles dead for every row
    q, k, v = (torch.randn((2, 6, 512, 64), generator=gen, device=dev)
               for _ in range(3))
    for kv_len in (200, 300):
        for causal in (True, False):
            for kind in (0, 1):
                note(flash_amm_kv_len_check(torch, tf, q, k, v,
                                            kv_len=kv_len, kind=kind,
                                            causal=causal))
                cases += 1
    # one-hot P (scores 125 apart): the whole output is integer-exact
    s_len = 256
    q = torch.zeros((1, 2, s_len, 64), device=dev)
    k = torch.zeros((1, 2, s_len, 64), device=dev)
    idx = torch.arange(s_len, device=dev)
    q[:, :, idx, idx % 64] = 1000.0
    k[:, :, idx[:64], idx[:64]] = 1.0
    v = torch.randn((1, 2, s_len, 64), generator=gen, device=dev)
    ops = tf.flash_amm_operands(q, k, v, wl=16)
    for kind in (0, 1):
        got, res = tf.flash_attention_amm(q, k, v, wl=16, vbl=13, kind=kind,
                                          causal=False, residuals=True)
        want, wres = tf.flash_amm_plain(ops, wl=16, vbl=13, kind=kind,
                                        causal=False, residuals=True)
        if not (torch.equal(got, want.reshape(q.shape))
                and torch.equal(res["pv"], wres["pv"])):
            fail(f"flash_attention_amm differs from its plain version "
                 f"where P is one-hot (kind={kind})")
        cases += 1
    return cases, worst, moved


# the exact kernel's largest error against float64 attention may be at
# most this many times its plain version's (f32 matmuls, no TF32)
PRECISION_FACTOR = 16.0


def tf32_round(torch, x):
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def attention_f64(torch, q, k, v):
    """Causal softmax attention over (B, H, S, D), dense, in float64."""
    q, k, v = (t.double() for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s_len = s.shape[-1]
    dead = torch.ones((s_len, s_len), dtype=torch.bool,
                      device=s.device).triu(1)
    return torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1) @ v


def flash_precision_control(torch, tf, dev) -> list:
    """Whether a score product below f32 precision would be caught.  At
    the main path's shape and a ragged S = 200 at d 32 and 16 (causal),
    the exact kernel's largest error against float64 attention must be
    within ``PRECISION_FACTOR`` times its plain version's, and three
    lower-precision score products must err beyond that limit: 1xTF32
    (both operands rounded to TF32) and 3xTF32 without one of its cross
    terms (hi*hi + hi*lo = tf32(q) k, hi*hi + lo*hi = q tf32(k)), each
    evaluated in float64 with that rounding as its only error, so with
    less error than a kernel of that arithmetic would have.  Returns one
    reading per shape: (shape, kernel error, plain error, limit, the
    controls' errors)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    readings = []
    for shape in ((TRAIN_BATCH, 14, TRAIN_SEQ, 64), (2, 6, 200, 32),
                  (2, 6, 200, 16)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        ref = attention_f64(torch, q, k, v)
        err = lambda out: float((out.double() - ref).abs().max())  # noqa
        e_kernel = err(tf.flash_attention(q, k, v, causal=True))
        e_plain = err(tf.flash_attention_plain(q, k, v, causal=True))
        limit = PRECISION_FACTOR * e_plain
        qt, kt = tf32_round(torch, q), tf32_round(torch, k)
        controls = {"1xTF32": err(attention_f64(torch, qt, kt, v)),
                    "3xTF32 less lo*hi": err(attention_f64(torch, qt, k, v)),
                    "3xTF32 less hi*lo": err(attention_f64(torch, q, kt, v))}
        if not e_kernel <= limit:
            fail(f"flash_attention errs {e_kernel} against float64 at "
                 f"{shape}, beyond {PRECISION_FACTOR} x its plain "
                 f"version's {e_plain}")
        for name, e in controls.items():
            if not e > limit:
                fail(f"a {name} score product errs {e} against float64 at "
                     f"{shape}, within the limit {limit}: the check could "
                     f"not tell it from f32")
        readings.append((shape, e_kernel, e_plain, limit, controls))
    return readings


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
T1_FLAGS = ["--amm", "bitexact", "--mul", "bbm0", "--wl", "16", "--vbl",
            "13", "--amm-attn", "--flash-attn"]
T2_FLAGS = ["--amm", "off", "--flash-attn"]


class MmaLaunches:
    """A wrapper's tensor-core launches (``mma_launches``) under the
    ``launches`` name that ``train_run`` zeroes and reads."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.mma_launches

    @launches.setter
    def launches(self, value):
        self.fn.mma_launches = value


def train_run(torch, flags, counters, batch: int = TRAIN_BATCH,
              seq: int = TRAIN_SEQ) -> dict:
    """One run of the training launcher's ``main`` at full width, ``batch``
    x ``seq``; the launch counts of every kernel per step, the steps' wall
    times, and a torch.profiler breakdown of the last step."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    import repro_torch.launch.train as launch
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps, prof_box = [], {}
    make = launch.make_train_step

    def counted_make(cfg, rt, tc):
        step = make(cfg, rt, tc)

        def counted(params, opt, tokens, labels, key, **kw):
            before = {n: f.launches for n, f in counters.items()}
            last = len(steps) == TRAIN_STEPS - 1
            prof = profile(activities=[ProfilerActivity.CUDA]) if last \
                else None
            torch.cuda.synchronize()
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            out = step(params, opt, tokens, labels, key, **kw)
            loss = float(out[2]["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
                prof_box["prof"], prof_box["wall"] = prof, wall
            steps.append({"wall": wall, "loss": loss, "launches": {
                n: f.launches - before[n] for n, f in counters.items()}})
            return out
        return counted

    for f in counters.values():
        f.launches = 0
    launch.make_train_step = counted_make
    try:
        t0 = time.perf_counter()
        hist = launch.main(flags + [
            "--batch", str(batch), "--seq", str(seq), "--steps",
            str(TRAIN_STEPS), "--ckpt-dir", str(ckpt)])
        run_s = time.perf_counter() - t0
    finally:
        launch.make_train_step = make
        shutil.rmtree(ckpt, ignore_errors=True)
    totals = {n: f.launches for n, f in counters.items()}
    busy, by_kernel = 0.0, []
    for ev in prof_box["prof"].key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = t if t is not None else ev.self_cuda_time_total
        if t > 0:
            busy += t
            by_kernel.append((t / 1e3, ev.count, ev.key))
    return {"hist": hist, "steps": steps, "totals": totals, "run_s": run_s,
            "busy_ms": busy / 1e3, "prof_wall_ms": prof_box["wall"] * 1e3,
            "by_kernel": sorted(by_kernel, reverse=True)}


def check_train_run(name, res, want_per_step) -> None:
    hist = res["hist"]
    if len(hist) != TRAIN_STEPS or len(res["steps"]) != TRAIN_STEPS:
        fail(f"{name}: {len(hist)} steps recorded of {TRAIN_STEPS}")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"{name}: a loss is not finite: {[h['loss'] for h in hist]}")
    for i, st in enumerate(res["steps"]):
        if st["launches"] != want_per_step:
            fail(f"{name}: step {i} launched {st['launches']}, expected "
                 f"{want_per_step}")
    want_total = {n: TRAIN_STEPS * c for n, c in want_per_step.items()}
    if res["totals"] != want_total:
        fail(f"{name}: the run launched {res['totals']}, expected "
             f"{want_total}")


# bf16 residual stream over 2 layers: last-place differences of the f32
# products flip bf16 roundings (2^-8 of an element); the mean loss over
# 256 tokens moves far less than one flip, a gradient leaf by a few flips
# of its largest element (tests/test_torch_train.py holds the port to JAX
# at the same bounds)
TRAIN_LOSS_RTOL = 2.0 ** -12
TRAIN_GRAD_RTOL = 2.0 ** -5


def train_cpu_check(torch, dev) -> dict:
    """A 2-layer cut of qwen2-0.5b at full width, one sequence of 256
    tokens, T1's settings: the card's loss and gradients against the CPU
    port's, and the first MLP product's approximate value bit for bit."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import AmmConfig
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models import ModelRuntime, common, lm_init
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainstep import loss_and_grads
    cfg = dataclasses.replace(get_arch("qwen2-0.5b"), n_layers=2,
                              amm=AmmConfig(mode="bitexact", mul="bbm0",
                                            wl=16, param=13, apply_to="all"))
    rt = ModelRuntime.build(cfg, use_pallas=True)
    params = lm_init(cfg, 1, device=dev)
    toks, labels = global_batch(DataConfig(vocab=cfg.vocab, seq_len=256,
                                           global_batch=1), 0)
    captured = []
    approx = common._amm_bitexact_approx

    def first(x, w, rt_, planes=None):
        out = approx(x, w, rt_, planes=planes)
        if not captured:
            captured.append((x, w, out))
        return out
    common._amm_bitexact_approx = first
    try:
        card, card_g, _ = loss_and_grads(
            params, cfg, rt, torch.from_numpy(toks).to(dev),
            torch.from_numpy(labels).to(dev), None)
        card = float(card)
    finally:
        common._amm_bitexact_approx = approx
    cpu_params = _to_cpu(params)
    t0 = time.perf_counter()
    cpu, cpu_g, _ = loss_and_grads(cpu_params, cfg, rt,
                                   torch.from_numpy(toks),
                                   torch.from_numpy(labels), None)
    cpu = float(cpu)
    cpu_s = time.perf_counter() - t0
    if not (np.isfinite(card) and abs(card - cpu) <= TRAIN_LOSS_RTOL
            * abs(cpu)):
        fail(f"the card's loss {card!r} is off the CPU port's {cpu!r}")
    worst = 0.0
    for g, w in zip(tree_leaves(card_g), tree_leaves(cpu_g)):
        ratio = float((g.cpu().double() - w.double()).abs().max()
                      / w.double().abs().max().clamp_min(1e-30))
        if not ratio <= TRAIN_GRAD_RTOL:
            fail(f"a gradient leaf {tuple(w.shape)} on the card is off the "
                 f"CPU port's by {ratio} of its largest element")
        worst = max(worst, ratio)
    x, w, out = captured[0]
    want = approx(x.cpu(), w.cpu(), rt.amm)
    if not torch.equal(out.cpu(), want):
        fail("the first MLP product's _amm_bitexact_approx differs between "
             "the card and the CPU")
    return {"card": card, "cpu": cpu, "cpu_s": cpu_s, "grad_worst": worst,
            "shape": (tuple(x.shape), tuple(w.shape))}


def _signed_bytes(bits: int) -> int:
    """Bytes of a two's-complement value of ``bits`` + 1 bits: one s8,
    or a u8 and an s8."""
    return 1 if bits <= 7 else 2


def onehot_byte_products(wl: int, vbl: int, kind: int) -> int:
    """int8 byte products per code product of the contracted dot form as
    the reference contracts it (``_dot_scaled``): x's bytes against bq's
    (s8, or u8 + s8) and against each truncated row's digit (one s8),
    and each row's residue ``(v (x mod 2^m_r) - s) mod 2^m_r``
    (ceil(m_r / 8) u8 bytes) against one indicator byte per (digit, sign)
    branch: 4 at kind 0, 5 at kind 1.  56 and 66 at wl 16 / vbl 13."""
    from repro_torch.kernels.booth_rows import num_corr_rows
    rows = num_corr_rows(wl, vbl)
    xb = _signed_bytes(wl - 1)
    bq = sum(2 << (2 * r - vbl) for r in range(rows, wl // 2))
    bqb = 1 if bq <= 127 else 2
    residue = sum(-(-(vbl - 2 * r) // 8) for r in range(rows))
    return xb * bqb + xb * rows + (5 if kind else 4) * residue


def floor_split_byte_products(wl: int, vbl: int, kind: int) -> int:
    """int8 byte products per code product of the floor-split form the
    tensor-core kernel contracts (``csrc/bbm_mma.cuh``): x's bytes
    against bq's, each truncated row's ``x >> m_r`` bytes against d_r
    and its bit m_r - 1 against ``[d_r = 2] - [d_r = -2]``, then two
    indicator planes a row at kind 0, one ones plane against ``-sum
    neg_r`` at kind 1.  34 and 21 at wl 16 / vbl 13."""
    from repro_torch.kernels.booth_rows import num_corr_rows
    rows = num_corr_rows(wl, vbl)
    bq = sum(2 << (2 * r - vbl) for r in range(rows, wl // 2))
    bqb = 1 if bq <= 127 else 2
    shifted = sum(_signed_bytes(wl - 1 - (vbl - 2 * r)) for r in range(rows))
    return (_signed_bytes(wl - 1) * bqb + shifted + rows
            + (2 * rows if kind == 0 else int(rows > 0)))


def dot_byte_products(wl: int, vbl: int, kind: int) -> int:
    """The fewest int8 byte products per code product among the exact
    forms of the contracted dot form known here (the reference's one-hot
    contraction, the kernel's floor split): 34 and 21 at wl 16 / vbl
    13, the floor split's."""
    return min(onehot_byte_products(wl, vbl, kind),
               floor_split_byte_products(wl, vbl, kind))


def code_bytes(wl: int) -> int:
    """The fewest bytes a wl-bit code can move in: 1 at wl <= 8, 2 at
    wl <= 16."""
    return -(-wl // 8)


def dot_scaled_bound_ms(m: int, k: int, n: int, wl: int = 16, vbl: int = 13,
                        kind: int = 0, weight_bytes=None) -> tuple:
    """(bound ms, what bounds it) of one contracted dot-form call
    (``bbm_dot_scaled``, ``bbm_dot_planes``, ``bbm_matmul_dot`` at shift
    <= vbl): its int8 byte products (``dot_byte_products``, 2 operations
    each) over the int8 tensor-core peak, against the x codes and the
    weight operand read once (``weight_bytes``, default the weight's
    codes) and the 4-byte output written once over 3.35 TB/s.  A wl-bit
    code needs ``code_bytes(wl)`` bytes, whatever the int32 it is held
    in."""
    t_ops = 2 * dot_byte_products(wl, vbl, kind) * m * k * n \
        / INT8_OPS_PER_S
    cb = code_bytes(wl)
    wb = cb * k * n if weight_bytes is None else weight_bytes
    t_bytes = (cb * m * k + 4 * m * n + wb) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fir_bound_ms(name: str, c: int, n: int, taps: int, *, wl: int, vbl: int,
                 kind: int, shift: int) -> tuple:
    """(bound ms, what bounds it, the operations' ms) of one filterbank
    call on (c, n) int32 codes and ``taps`` taps: x read once, y written
    once and the digit planes read once over 3.35 TB/s, against the
    operations.  At shift <= vbl every product is 2^vbl M and the tap sum
    is a contraction: the fewest exact form's int8 byte products a tap
    product (``dot_byte_products``), 2 operations each, over the int8
    tensor-core peak.  At shift > vbl each product floors before the sum:
    the CUDA-core kernel's int32 count (a row evaluation per Booth row in
    ``fir_bank_rows``, a multiply-add for x bq and per truncated row in
    ``fir_bank_dot``) over int32 issue."""
    from repro_torch.kernels.booth_rows import num_corr_rows
    products = c * n * taps
    if shift <= vbl:
        t_ops = 2 * dot_byte_products(wl, vbl, kind) * products \
            / INT8_OPS_PER_S
    else:
        rows = wl // 2 if name == "fir_bank_rows" \
            else 1 + num_corr_rows(wl, vbl)
        t_ops = products * rows / INT32_OPS_PER_S
    t_bytes = (4 * 2 * c * n + 4 * 2 * (wl // 2) * c * taps) \
        / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", t_ops * 1e3)


def conv1d_ms(torch, c: int, n: int, taps: int, dev) -> float:
    """One f32 depthwise ``F.conv1d(groups=C)`` at the filterbank's (C, N,
    taps), TF32 off: a yardstick of the card's rate for a C-channel FIR,
    not the same function (never called by the port)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, c, n + taps - 1), device=dev, generator=gen)
    w = torch.randn((c, 1, taps), device=dev, generator=gen)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return spin_ms(torch, lambda: F.conv1d(x, w, groups=c), 20)


# the fewest keys at which the exact kernels' error model
# (csrc/flash_attention_wide.cuh) admits 3xTF32 for P V inside
# flash_tolerance's sum term (kernels/flash_attention.py keeps the same
# constant for its route rule)
PV_3XTF32_MIN_SKV = 26


def flash_bound_ms(pairs: int, d: int, skv: int, amm=None) -> float:
    """Operations bound (ms) of one flash call over ``pairs`` live
    (query, key) pairs (the causal triangle counted, not the full grid)
    and ``d`` head dims, for KV length ``skv``.  The exact function, at
    the least arithmetic its f32 contract admits: from
    ``PV_3XTF32_MIN_SKV`` keys on both products in 3xTF32, 3 x 4 pairs d
    TF32 operations over 495 TFLOP/s; below it the score product so and
    P V's 2 pairs d f32 operations over 67 TFLOP/s, on different pipes,
    so the larger.  The amm function (``amm`` = (wl, vbl, kind)): its two
    f32 products, 4 pairs d operations, beside its 2 pairs d Broken-Booth
    products, which where ``bbm_dot_route`` says "mma" are the contracted
    form's ``dot_byte_products`` int8 byte products (2 operations each)
    over the int8 tensor-core peak, else ``1 + 3 R`` int32 instructions
    over the int32 peak; the larger, since they run on different pipes.
    The caller compares it with the bytes of its shapes (q, k, v, out in
    f32, codes)."""
    if amm is None:
        if skv >= PV_3XTF32_MIN_SKV:
            return 12 * pairs * d / TF32_OPS_PER_S * 1e3
        return max(6 * pairs * d / TF32_OPS_PER_S,
                   2 * pairs * d / F32_OPS_PER_S) * 1e3
    from repro_torch.kernels.bbm_matmul import bbm_dot_route
    from repro_torch.kernels.booth_rows import num_corr_rows
    wl, vbl, kind = amm
    t_f32 = 4 * pairs * d / F32_OPS_PER_S
    if bbm_dot_route(wl, vbl, kind) == "mma":
        t_int = 2 * 2 * pairs * d * dot_byte_products(wl, vbl, kind) \
            / INT8_OPS_PER_S
    else:
        t_int = 2 * pairs * d * (1 + 3 * num_corr_rows(wl, vbl)) \
            / INT32_OPS_PER_S
    return max(t_f32, t_int) * 1e3


# the redesigned flash kernels' ms before the redesign, as PERF.md's kernel
# table records them (an NVIDIA H100 80GB HBM3 at 700.00 W), at (4, 14,
# 512, 64) causal
FLASH_BEFORE_MS = {"flash_attention": 0.237485,
                   "flash_attention_amm": 5.544544}
# the kernels' tiles (csrc/flash_attention.cuh): exact 64 x 64, amm 128 x 128
FLASH_TILES = {"flash_attention": (64, 64), "flash_attention_amm": (128, 128)}
# bbm_dot_scaled on the CUDA-core tile before the redesign (PERF.md's
# kernel table, PR 14 call 2, CUDA events)
B2_BEFORE_MS = {(2048, 896, 4864): 15.095584, (2048, 4864, 896): 17.864314}


def flash_raw_ms(torch, q, k, v, reps: int = 50,
                 causal: bool = True) -> float:
    """ms per launch of the exact flash kernel alone, between CUDA events
    over back-to-back launches through its C entry point, on the P V
    route of ``flash_exact_route``: the wrapper's host work (checks,
    layout, about 20 us of Python) exceeds the kernel's time, so timing
    wrapper calls measures the host."""
    from repro_torch.kernels.flash_attention import (_EXACT_ROUTES,
                                                     _library,
                                                     flash_exact_route)
    b, h, s_len, d = q.shape
    lib = _library(d)
    skv = k.shape[2]
    rt = _EXACT_ROUTES[flash_exact_route(d, skv)]
    qc = q.reshape(b * h, s_len, d).contiguous()
    kc, vc = (t.reshape(b * h, skv, d).contiguous() for t in (k, v))
    out = torch.empty_like(qc)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (qc, kc, vc, out)]

    def launch():
        err = lib.flash_attention_launch(*ptrs, b * h, s_len, skv, d,
                                         int(causal), 1.0 / d ** 0.5, rt,
                                         stream)
        if err:
            fail(f"flash_attention_launch returned {err}")
    return cuda_ms(torch, launch, reps)


def train_timing(torch, dev, tb, tf) -> tuple:
    """Each new kernel at the main path's shapes: device ms (profiler;
    for the exact flash kernel its bare launch between CUDA events),
    wrapper ms, plain ms, bound, max abs error against the plain
    version, and SDPA beside the exact flash kernel."""
    rng = np.random.default_rng(9)
    lines, entries = [], {}
    b2 = []
    for m, k, n in ((TRAIN_BATCH * TRAIN_SEQ, 896, 4864),
                    (TRAIN_BATCH * TRAIN_SEQ, 4864, 896)):
        x = torch.from_numpy(rng.integers(-32768, 32768, (m, k)).astype(
            np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(-32768, 32768, (k, n)).astype(
            np.int32)).to(dev)
        # the card's int8 rate on the same (M, K, N): one int8 product
        # (the second operand column-major, cuBLASLt's int8 layout)
        a8 = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev)
        b8 = torch.randint(-128, 128, (n, k), dtype=torch.int8,
                           device=dev).t()
        int_mm_ms = cuda_ms(torch, lambda: torch._int_mm(a8, b8), 10)
        for kind in ((0, 1) if k == 896 else (0,)):
            route = tb.bbm_dot_route(16, 13, kind)
            run = lambda: tb.bbm_dot_scaled(  # noqa: E731
                x, w, wl=16, vbl=13, kind=kind)
            tile = lambda: tb._bbm_dot_scaled_on(  # noqa: E731
                "tile", x, w, wl=16, vbl=13, kind=kind)
            plain = lambda: tb.bbm_dot_scaled_plain(  # noqa: E731
                x, w, wl=16, vbl=13, kind=kind)
            # one launch a call: the profiler's mean per launch where its
            # trace holds the bare ctypes launches, else CUDA events
            ms, how = launch_ms(torch, run, 5, TRAIN_KERNELS[
                "bbm_dot_scaled"])
            call_ms = cuda_ms(torch, run, 5)
            tile_ms = cuda_ms(torch, tile, 2)
            plain_ms = cuda_ms(torch, plain, 1)
            want = plain()
            err = float((run() - want).abs().max())
            if err != 0 or not torch.equal(tile(), want):
                fail(f"bbm_dot_scaled differs from its plain version at "
                     f"({m}, {k}) x ({k}, {n}) kind {kind}")
            bound, by = dot_scaled_bound_ms(m, k, n, kind=kind)
            before = B2_BEFORE_MS.get((m, k, n)) if kind == 0 else None
            if kind == 0:
                b2.append((ms, plain_ms, bound, by, err, tile_ms, int_mm_ms,
                           how))
            lines.append(
                f"bbm_dot_scaled at ({m}, {k}) x ({k}, {n}), wl 16 vbl 13 "
                f"kind {kind}, {route} route: kernel {ms:.6f} ms ({how}), "
                f"wrapper call {call_ms:.6f} ms (events), the CUDA-core "
                f"tile route {tile_ms:.6f} ms (events, same card)"
                + ("" if before is None else
                   f", {before} ms before the redesign (PERF.md's kernel "
                   f"table, an NVIDIA H100 80GB HBM3 at 700.00 W)")
                + f", plain {plain_ms:.6f} ms, bound {bound:.6f} ms ({by}; "
                f"{dot_byte_products(16, 13, kind)} int8 byte products a "
                f"code product; bound / time {bound / ms:.4g}), max abs "
                f"error {err}; yardstick torch._int_mm ({m}, {k}) x ({k}, "
                f"{n}) int8 {int_mm_ms:.6f} ms = "
                f"{2 * m * k * n / int_mm_ms / 1e9:.6g} TOP/s")
    # a step's mix: gate and up at the first shape, down at the second
    mix = lambda a, b: (2 * a + b) / 3  # noqa: E731
    entries["bbm_dot_scaled"] = dict(
        max_abs_err=max(b2[0][4], b2[1][4]), ms=mix(b2[0][0], b2[1][0]),
        plain_ms=mix(b2[0][1], b2[1][1]), bound_ms=mix(b2[0][2], b2[1][2]),
        bound_by=b2[0][3], library_ms=None,
        tile_route_ms=mix(b2[0][5], b2[1][5]),
        int_mm_yardstick_ms=mix(b2[0][6], b2[1][6]),
        timed_by=b2[0][7] if b2[0][7] == b2[1][7]
        else f"{b2[0][7]}, {b2[1][7]}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    bh = TRAIN_BATCH * 14
    q, k, v = (torch.randn((TRAIN_BATCH, 14, TRAIN_SEQ, 64), generator=gen,
                           device=dev) for _ in range(3))
    pairs = bh * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    for name in ("flash_attention", "flash_attention_amm"):
        if name == "flash_attention":
            run = lambda: tf.flash_attention(q, k, v, causal=True)  # noqa
            plain = lambda: tf.flash_attention_plain(  # noqa: E731
                q, k, v, causal=True)
            tol = tf.flash_tolerance(q, k, v)
            t_ops = flash_bound_ms(pairs, 64, TRAIN_SEQ)
            nbytes = 16 * bh * TRAIN_SEQ * 64    # f32 q k v out
        else:
            run = lambda: tf.flash_attention_amm(  # noqa: E731
                q, k, v, wl=16, vbl=13, kind=0, causal=True)
            plain = lambda: tf.flash_amm_plain(  # noqa: E731
                tf.flash_amm_operands(q, k, v, wl=16), wl=16, vbl=13,
                kind=0, causal=True).reshape(q.shape)
            t_ops = flash_bound_ms(pairs, 64, TRAIN_SEQ, amm=(16, 13, 0))
            nbytes = 22 * bh * TRAIN_SEQ * 64    # f32 q k v out, int16 codes
        dev_ms = kernel_device_ms(torch, run, 20, TRAIN_KERNELS[name],
                                  per_call=1)
        call_ms = cuda_ms(torch, run, 5)
        plain_ms = cuda_ms(torch, plain, 2)
        raw_ms = flash_raw_ms(torch, q, k, v) \
            if name == "flash_attention" else None
        if name == "flash_attention":
            err_t = (run().double() - plain().double()).abs()
            if not bool((err_t <= tol).all()):
                fail(f"{name} off its plain version at the main path's "
                     f"shape")
            err, tol_txt = float(err_t.max()), f"{float(tol.min()):.4g}"
        else:
            rep = flash_amm_check(torch, tf, q, k, v, kind=0, causal=True,
                                  what="at the main path's shape")
            err = rep["max_err"]
            tol_txt = (f"{rep['max_bound']:.4g}; {rep['codes_moved']} of "
                       f"{rep['codes']} P codes moved, by at most "
                       f"{rep['max_code_step']}")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        lib_ms = None
        if name == "flash_attention":
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True),
                             20)
        # the exact kernel: always its bare launch (the profiler's
        # reading, printed beside it, can lose ctypes launches)
        ms = raw_ms if raw_ms is not None else \
            dev_ms if dev_ms is not None else call_ms
        entries[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.6f} ms"
        lib_txt = "" if lib_ms is None else \
            f"; yardstick scaled_dot_product_attention {lib_ms:.6f} ms"
        if raw_ms is not None:
            lib_txt += f"; the kernel alone {raw_ms:.6f} ms (CUDA events)"
        lines.append(f"{name} at ({TRAIN_BATCH}, 14, {TRAIN_SEQ}, 64) "
                     f"causal: kernel {dev_txt} on the device (profiler), "
                     f"wrapper call {call_ms:.6f} ms, plain {plain_ms:.6f} "
                     f"ms, bound {bound:.6f} ms ({by}), max abs error {err} "
                     f"(bound of the difference {tol_txt})"
                     f"{lib_txt}")
        bm, bn = FLASH_TILES[name]
        live = sum(tf.live_kv_tiles(TRAIN_SEQ, TRAIN_SEQ, bm, bn,
                                    causal=True)) * bh
        full = -(-TRAIN_SEQ // bm) * -(-TRAIN_SEQ // bn) * bh
        lines.append(f"{name} redesigned: {ms:.6f} ms against "
                     f"{FLASH_BEFORE_MS[name]} ms before the redesign "
                     f"(before / now {FLASH_BEFORE_MS[name] / ms:.4g}; "
                     f"before: PERF.md's kernel table, an NVIDIA H100 80GB "
                     f"HBM3 at 700.00 W), bound {bound:.6f} ms "
                     f"({by}; bound / time {bound / ms:.4g})"
                     + ("" if lib_ms is None else
                        f", scaled_dot_product_attention {lib_ms:.6f} ms")
                     + f"; {live} live {bm} x {bn} tiles launched of the "
                     f"full grid's {full}")
    return entries, lines


def report_train_run(name, res, counters) -> None:
    steps = res["steps"]
    st_ms = [s["wall"] * 1e3 for s in steps]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    idle = 1.0 - res["busy_ms"] / res["prof_wall_ms"]
    print(f"{name}: {TRAIN_STEPS} steps of {tokens} tokens, losses "
          f"{[round(s['loss'], 6) for s in steps]}, step ms "
          f"{[round(t, 3) for t in st_ms]}; unprofiled step "
          f"{st_ms[1]:.3f} ms = {tokens / st_ms[1] * 1e3:.6g} tokens/s; "
          f"launches per step {steps[0]['launches']}; whole run with "
          f"set-up and the final checkpoint {res['run_s']:.2f} s")
    print(f"{name} profiled step: {res['prof_wall_ms']:.3f} ms wall, device "
          f"busy {res['busy_ms']:.3f} ms, idle share {idle:.4f}")
    for t, count, key in res["by_kernel"][:8]:
        print(f"  {name} step device time: {t:.4f} ms in {count} launches "
              f"of {key[:90]}")
    for kname, parts in TRAIN_KERNELS.items():
        t = sum(ms for ms, _, key in res["by_kernel"]
                if any(p in key for p in parts))
        if t:
            print(f"  {name}: {kname} {t:.4f} device ms per step")


# ------------------------------------------- slice 4: B1 and the faults
B1_SHAPE = (2048, 896, 4864)          # qwen2-0.5b's MLP product at T1's M
FAULT_RATES = [0.0, 1e-4, 1e-3, 1e-2, 1e-1]     # benchmarks/robustness.py
B1_SOURCE = "src/repro_torch/kernels/csrc/bbm_matmul.cu"
B1_REPLACES = {"bbm_matmul_rows": "src/repro/kernels/bbm_matmul.py:400",
               "bbm_matmul_dot": "src/repro/kernels/bbm_matmul.py:161",
               "bbm_dot_planes": "src/repro/kernels/bbm_matmul.py:112"}
# on the B1 main path bbm_matmul_dot (shift 13) and bbm_dot_planes take
# the tensor-core route
B1_SOURCES = {"bbm_matmul_rows": B1_SOURCE, "bbm_matmul_dot": MMA_SOURCE,
              "bbm_dot_planes": MMA_SOURCE}
# profiler names, both routes (the planes-in mma route packs first)
B1_KERNELS = {"bbm_matmul_rows": "bbm_matmul_rows_kernel",
              "bbm_matmul_dot": ("bbm_matmul_dot_kernel", MMA_KERNEL,
                                 MMA_PACK),
              "bbm_dot_planes": ("bbm_dot_planes_kernel", MMA_KERNEL,
                                 MMA_PACK),
              "bbm_dot_scaled": TRAIN_KERNELS["bbm_dot_scaled"]}


def b1_check(torch, tb, x, hm, hn, kw, what) -> None:
    """Both B1 kernels == the plain rows form, and the plain dot form too
    (on CPU copies where the operating point has no f32 envelope)."""
    from repro_torch.kernels.booth_rows import f32_exact_chunk_len
    want = tb.bbm_matmul_rows_plain(x, hm, hn, **kw)
    got = {"bbm_matmul_rows": tb.bbm_matmul_rows(x, hm, hn, **kw)}
    for route in b2_routes(tb, kw["wl"], kw["vbl"], kw["shift"]):
        got[f"bbm_matmul_dot (route {route})"] = routed(
            tb, "bbm_matmul_dot", route)(x, hm, hn, **kw)
    on = x.device if f32_exact_chunk_len(kw["wl"], kw["vbl"]) else "cpu"
    got["bbm_matmul_dot_plain"] = tb.bbm_matmul_dot_plain(
        x.to(on), hm.to(on), hn.to(on), **kw)
    torch.cuda.synchronize()
    for name, y in got.items():
        if not torch.equal(y.to(want.device), want):
            fail(f"{name} != plain rows {what} {kw}: "
                 f"{int((y.to(want.device) != want).sum())} elements differ")


def b1_sweep(torch, tb, dev) -> int:
    """The B1 kernels (``bbm_matmul_dot`` on each route it can take)
    against their plain versions over wl, vbl, kind, shift, ragged
    shapes, the most negative codes and one faulted-plane case per lane;
    returns the case count."""
    from repro_torch.core.faults import FaultSpec, apply_plane_faults
    from repro_torch.kernels.booth_rows import booth_precode
    rng = np.random.default_rng(11)
    shapes = [(70, 37, 130), (1, 200, 65), (129, 65, 3), (5, 1000, 64)]
    cases = 0

    def operands(m, k, n, wl):
        lim = 1 << (wl - 1)
        x = rng.integers(-lim, lim, (m, k)).astype(np.int32)
        w = rng.integers(-lim, lim, (k, n)).astype(np.int32)
        x[0], x[-1], w[:, 0], w[:, -1] = -lim, lim - 1, -lim, lim - 1
        x, w = (torch.from_numpy(a).to(dev) for a in (x, w))
        return x, *(t.contiguous() for t in booth_precode(w, wl))

    for wl in (8, 12, 16):
        for vbl in (v for v in (0, 5, 13, 15) if v < wl):
            for kind in (0, 1):
                m, k, n = shapes[cases % len(shapes)]
                lo = 0
                while k * 2 ** max(2 * wl - 1 - lo, 0) >= 2 ** 31:
                    lo += 1
                for shift in sorted({lo, max(lo, vbl), max(lo, vbl + 2)}):
                    x, hm, hn = operands(m, k, n, wl)
                    b1_check(torch, tb, x, hm, hn, dict(
                        wl=wl, vbl=vbl, kind=kind, shift=shift),
                        f"at ({m}, {k}) x ({k}, {n})")
                    cases += 1
    for lane in ("mag_lo", "mag_hi", "neg", "all"):
        for kind in (0, 1):
            x, hm, hn = operands(70, 300, 130, 16)
            fm, fn = (t.contiguous() for t in apply_plane_faults(
                hm, hn, FaultSpec(p=0.05, lane=lane, seed=cases), vbl=13))
            if torch.equal(fm, hm) and torch.equal(fn, hn):
                fail(f"the {lane} fault changed no plane")
            b1_check(torch, tb, x, fm, fn, dict(wl=16, vbl=13, kind=kind,
                                                shift=15),
                     f"on {lane}-faulted planes")
            cases += 1
    return cases


def b1_full_size(torch, tb, ops, dev) -> dict:
    """The public API at qwen2-0.5b's MLP shape, WL 16 / VBL 13, both
    kinds: the auto form's launches, rows == dot at shift 13, and both
    == their plain versions on 64 sampled rows."""
    from repro_torch.kernels.booth_rows import booth_precode
    m, k, n = B1_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    x = torch.randint(-32768, 32768, (m, k), generator=gen, device=dev,
                      dtype=torch.int32)
    w = torch.randint(-32768, 32768, (k, n), generator=gen, device=dev,
                      dtype=torch.int32)
    x[0], w[:, 0] = -32768, -32768
    hm, hn = booth_precode(w, 16)
    idx = torch.from_numpy(np.sort(np.random.default_rng(13).choice(
        m, 64, replace=False))).to(dev)
    idx[0] = 0
    outs = {}
    for kind in (0, 1):
        kw = dict(wl=16, vbl=13, kind=kind)
        before = (tb.bbm_matmul_rows.launches, tb.bbm_matmul_dot.launches)
        y15 = ops.bbm_matmul(x, w, shift=15, **kw)
        torch.cuda.synchronize()
        after = (tb.bbm_matmul_rows.launches, tb.bbm_matmul_dot.launches)
        if (after[0] - before[0], after[1] - before[1]) != (1, 0):
            fail(f"ops.bbm_matmul(shift=15) at {B1_SHAPE} launched rows "
                 f"{after[0] - before[0]}, dot {after[1] - before[1]} "
                 f"times: the auto rule must pick the rows kernel once")
        mma = tb.bbm_matmul_dot.mma_launches
        y13 = ops.bbm_matmul(x, w, shift=13, **kw)
        torch.cuda.synchronize()
        if tb.bbm_matmul_dot.launches - after[1] != 1 \
                or tb.bbm_matmul_dot.mma_launches - mma != 1:
            fail("ops.bbm_matmul(shift=13) did not launch bbm_matmul_dot on "
                 "the tensor-core route")
        y13r = ops.bbm_matmul(x, w, shift=13, form="rows", **kw)
        if not torch.equal(y13, y13r):
            fail(f"rows and dot forms differ at shift 13 kind={kind}")
        xs = x[idx].contiguous()
        for y, shift, plain in ((y15, 15, tb.bbm_matmul_rows_plain),
                                (y13, 13, tb.bbm_matmul_dot_plain)):
            want = plain(xs, hm, hn, shift=shift, **kw)
            if not torch.equal(y[idx], want):
                fail(f"{plain.__name__} differs on the sampled rows at "
                     f"shift {shift} kind={kind}")
        outs[kind] = (y15, y13)
    return {"x": x, "w": w, "hm": hm, "hn": hn, "outs": outs}


def fault_gate(torch, tb, dev) -> int:
    """``gate_fault_equality`` on the card: the datapath under each fault
    bit-equal to ``amm_faulty_ref``; the disabled spec bit-equal to the
    unfaulted datapath.  Returns the case count."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.multipliers import MulSpec
    from repro_torch.kernels.ref import amm_approx_ref, amm_faulty_ref
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 70)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((70, 8)).astype(np.float32))
    faults = [None,
              FaultSpec(target="plane", model="flip", p=0.05, seed=3),
              FaultSpec(target="plane", model="stuck1", p=0.05,
                        lane="mag_lo", seed=5),
              FaultSpec(target="acc", model="flip", p=0.3, bit=10, seed=9)]
    cases = 0
    for spec in (MulSpec("bbm0", 16, 13), MulSpec("booth", 16, 0)):
        vbl = 0 if spec.name == "booth" else spec.param
        base = amm_approx_ref(x, w, spec)
        for f in faults:
            got = tb.bbm_matmul_dynamic(x.to(dev), w.to(dev), wl=spec.wl,
                                        vbl=vbl, kind=0, fault=f).cpu()
            if not torch.equal(got, amm_faulty_ref(x, w, spec, fault=f)):
                fail(f"the faulted datapath on the card != amm_faulty_ref "
                     f"for {spec} {f}")
            if f is None:
                off = tb.bbm_matmul_dynamic(
                    x.to(dev), w.to(dev), wl=spec.wl, vbl=vbl, kind=0,
                    fault=FaultSpec(p=0.0)).cpu()
                if not (torch.equal(got, base) and torch.equal(off, base)):
                    fail(f"a disabled fault is not the unfaulted datapath "
                         f"for {spec}")
            cases += 1
    return cases


def fault_curves(torch, tb, dev) -> dict:
    """``matmul_resilience``'s curves (m = n = 32, K = 192, seed 11, plane
    flips on every lane and accumulator flips at bit 12, both specs) on
    the card, each product bit-equal to the CPU port; returns the relative
    errors."""
    from repro_torch.core.faults import FaultSpec
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 192)).astype(np.float32)
    w = rng.standard_normal((192, 32)).astype(np.float32)
    exact = x @ w
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    curves = {}
    for name, vbl in (("bbm0", 13), ("booth", 0)):
        for target, kw in (("plane", {"lane": "all"}), ("acc", {"bit": 12})):
            curve = []
            for p in FAULT_RATES:
                f = FaultSpec(target=target, model="flip", p=p, seed=11,
                              **kw) if p else None
                got = tb.bbm_matmul_dynamic(tx.to(dev), tw.to(dev), wl=16,
                                            vbl=vbl, kind=0, fault=f).cpu()
                want = tb.bbm_matmul_dynamic(tx, tw, wl=16, vbl=vbl, kind=0,
                                             fault=f)
                if not torch.equal(got, want):
                    fail(f"the {name} {target} curve at p={p} differs from "
                         f"the CPU port")
                curve.append(float(np.linalg.norm(got.numpy() - exact)
                                   / np.linalg.norm(exact)))
            curves[f"{name}_{target}"] = curve
    return curves


def fault_full_size(torch, tb, full) -> None:
    """bbm0 at the full shape, clean, with plane flips and with
    accumulator flips at p = 1e-3: ``bbm_matmul_scaled`` (the planes-in
    kernel, on the tensor-core route) bit-equal to the plain version on
    the same planes, the faulted sums different from the clean ones."""
    from repro_torch.core.faults import FaultSpec, apply_plane_faults
    x, hm, hn = full["x"], full["hm"], full["hn"]
    mma = tb.bbm_dot_planes.mma_launches
    clean = tb.bbm_matmul_scaled(x, hm, hn, wl=16, vbl=13, kind=0)
    torch.cuda.synchronize()
    if tb.bbm_dot_planes.mma_launches - mma != 1:
        fail("bbm_matmul_scaled at the B1 shape did not launch the "
             "tensor-core route")
    if not torch.equal(clean, tb.bbm_dot_planes_plain(x, hm, hn, wl=16,
                                                      vbl=13, kind=0)):
        fail(f"the clean datapath at {B1_SHAPE} differs from its plain "
             f"version")
    for f in (FaultSpec(target="plane", p=1e-3, seed=11),
              FaultSpec(target="acc", p=1e-3, bit=12, seed=11)):
        got = tb.bbm_matmul_scaled(x, hm, hn, wl=16, vbl=13, kind=0,
                                   fault=f)
        fm, fn = apply_plane_faults(hm, hn, f, vbl=13)
        want = tb.bbm_dot_planes_plain(x, fm, fn, wl=16, vbl=13, kind=0,
                                       fault=f if f.target == "acc"
                                       else None)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"the faulted datapath at {B1_SHAPE} differs from its "
                 f"plain version under {f}")
        if torch.equal(got, clean):
            fail(f"{f} changed nothing at {B1_SHAPE}")


def fir_fault_curve(torch, taps_banks, dev) -> dict:
    """The FIR SNR-vs-plane-fault curve through ``FilterbankEngine`` at
    fir30 on the card (bbm0 VBL 13 and exact Booth, 8 channels, the
    engine's cached planes faulted as ``benchmarks/robustness.py`` does),
    every channel bit-equal to the CPU port's engine; returns the mean
    SNR per rate."""
    from repro_torch.core.faults import FaultSpec, apply_plane_faults
    from repro_torch.core.multipliers import MulSpec
    from repro_torch.dsp import FIR_DELAY, make_filterbank_signals, snr_db
    from repro_torch.serve import FilterbankEngine
    sigs = make_filterbank_signals(8, n=1 << 12)
    curves = {}
    for spec in (MulSpec("bbm0", 16, 13), MulSpec("booth", 16, 0)):
        vbl = 0 if spec.name == "booth" else spec.param
        curve = []
        for p in FAULT_RATES:
            f = FaultSpec(target="plane", model="flip", p=p, lane="all",
                          seed=7) if p else None
            outs = []
            for device in (dev, "cpu"):
                eng = FilterbankEngine(taps_banks, spec, device=device)
                eng.bank._planes = apply_plane_faults(*eng.bank.planes, f,
                                                      vbl=vbl)
                rids = [eng.submit(s.x, bank=c % 2)
                        for c, s in enumerate(sigs)]
                out = eng.flush()
                if eng.failed:
                    fail(f"the faulted engine quarantined {eng.failed}")
                outs.append([out[r] for r in rids])
            if not all(np.array_equal(a, b) for a, b in zip(*outs)):
                fail(f"the faulted FIR on the card differs from the CPU port "
                     f"for {spec} at p={p}")
            curve.append(float(np.mean([snr_db(s.d1, y, FIR_DELAY)
                                        for s, y in zip(sigs, outs[0])])))
        curves[spec.name] = curve
    return curves


def poison_gate(dev) -> None:
    """``gate_poison_ejection`` on the card's engine: a poison request is
    quarantined alone, its neighbours are served, the queue drains."""
    from repro_torch.core.multipliers import MulSpec
    from repro_torch.dsp import design_lowpass
    from repro_torch.serve import FilterbankEngine
    rng = np.random.default_rng(2)
    eng = FilterbankEngine(design_lowpass(), MulSpec("bbm0", 16, 13),
                           max_channels=8, max_retries=1, device=dev)
    sigs = [rng.standard_normal(128) for _ in range(5)]
    poison = sigs[2]
    inner = eng._apply

    def flaky(x, h, spec, **kw):
        for row in np.asarray(x):
            if np.array_equal(row[:len(poison)], poison):
                raise RuntimeError("injected poison")
        return inner(x, h, spec, **kw)

    eng._apply = flaky
    rids = [eng.submit(s) for s in sigs]
    out = eng.flush()
    if not (set(out) == set(rids) - {rids[2]} and rids[2] in eng.failed
            and not eng._pending and eng.flush() == {}):
        fail(f"poison ejection on the card: served {sorted(out)}, failed "
             f"{eng.failed}")


# int32 operations per product, the fewest any form of the Broken-Booth
# product needs at (wl, vbl, shift), whichever kernel computes it: the
# int32 operations per product of a form that floors each product before
# the K sum (shift > vbl, bbm_matmul_rows): the folded dot form's
# multiply-add for x*bq and, per truncated row, a multiply, a floor shift
# and an add (1 + 3 R, bbm_dot.cuh), plus the per-product shift and add.
# The rows kernel's own loop (select, negate, floor and shift-add for each
# of the wl/2 Booth rows) needs more; it is not the bound of the function.
def b1_ops_per_product(rows: int) -> int:
    return 1 + 3 * rows + 2


# each kernel's instantiation at WL 16 / kind 0, by its mangled name
SASS_KERNELS = {"bbm_matmul_rows": ("bbm_matmul", "rows_kernelILi8ELi0E"),
                "bbm_matmul_dot": ("bbm_matmul", "dot_kernelILi0E"),
                "bbm_dot_planes": ("bbm_dot", "planes_kernelILi0ELb0E"),
                "bbm_dot_scaled": ("bbm_dot", "bbm_dot_kernelILi0E")}


def sass_per_product(lib: Path, kernel: str, per_load: float = 2.0):
    """Instructions per product in the innermost loop of ``kernel`` (a
    part of its mangled name) in ``cuobjdump -sass`` of ``lib``: the
    longest backward branch with no barrier inside, ``per_load`` products
    for each shared-memory load in it (the tiles: 8 loads per k step, 4 of
    x and 4 of the weight, for 16 products; the FIR rows kernel: per tap a
    digit word and 2 samples for 2 products).  None where cuobjdump or the
    loop is missing."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    body = next((f for f in text.split("Function : ")[1:]
                 if kernel in f.splitlines()[0]), None)
    if body is None:
        return None
    ins = [(int(a, 16), t) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = []
    for pc, t in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) < pc:
            span = [u for a, u in ins if int(m.group(1), 16) <= a <= pc]
            if len(span) > len(best) and not any("BAR" in u for u in span):
                best = span
    loads = sum(1 for u in best if "LDS" in u)
    return len(best) / (per_load * loads) if loads else None


def b1_timing(torch, tb, full) -> tuple:
    """Each new kernel at the full shape (and ``bbm_dot_scaled`` beside
    them), each on the route its rule takes (the tensor cores but for
    ``bbm_matmul_rows``): ms (CUDA events; the profiler where it sees the
    launches), plain ms, bound; returns (entries, lines)."""
    from repro_torch.kernels.booth_rows import num_corr_rows
    m, k, n = B1_SHAPE
    x, w, hm, hn = full["x"], full["w"], full["hm"], full["hn"]
    rows = num_corr_rows(16, 13)
    runs = {
        "bbm_matmul_rows": (
            lambda: tb.bbm_matmul_rows(x, hm, hn, wl=16, vbl=13, kind=0,
                                       shift=15),
            lambda: tb.bbm_matmul_rows_plain(x, hm, hn, wl=16, vbl=13,
                                             kind=0, shift=15)),
        "bbm_matmul_dot": (
            lambda: tb.bbm_matmul_dot(x, hm, hn, wl=16, vbl=13, kind=0,
                                      shift=13),
            lambda: tb.bbm_matmul_dot_plain(x, hm, hn, wl=16, vbl=13,
                                            kind=0, shift=13)),
        "bbm_dot_planes": (
            lambda: tb.bbm_dot_planes(x, hm, hn, wl=16, vbl=13, kind=0),
            lambda: tb.bbm_dot_planes_plain(x, hm, hn, wl=16, vbl=13,
                                            kind=0)),
        "bbm_dot_scaled": (
            lambda: tb.bbm_dot_scaled(x, w, wl=16, vbl=13, kind=0),
            lambda: tb.bbm_dot_scaled_plain(x, w, wl=16, vbl=13, kind=0)),
    }
    # kernel launches a call on the routes these calls take (the
    # planes-in tensor-core calls pack the planes first): a trace that
    # lost any of their records reads "not measured" and CUDA events stand
    launches = {"bbm_matmul_rows": 1, "bbm_matmul_dot": 2,
                "bbm_dot_planes": 2, "bbm_dot_scaled": 1}
    entries, lines = {}, []
    for name, (run, plain) in runs.items():
        dev_ms = kernel_device_ms(torch, run, 5, B1_KERNELS[name],
                                  per_call=launches[name])
        call_ms = cuda_ms(torch, run, 5)
        plain_ms = cuda_ms(torch, plain, 1)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        if err != 0:
            fail(f"{name} differs from its plain version at {B1_SHAPE}")
        wbytes = 4 * (k * n if name == "bbm_dot_scaled"
                      else hm.numel() * 2)
        if name == "bbm_matmul_rows":
            # a per-product floor (shift 15 > vbl): no contraction form
            per_product = b1_ops_per_product(rows)
            t_ops = m * k * n * per_product / INT32_OPS_PER_S
            t_bytes = (4 * (m * k + m * n) + wbytes) / HBM_BYTES_PER_S
            bound = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            what = f"{per_product} int32 ops per product"
        else:
            bound, by = dot_scaled_bound_ms(m, k, n, weight_bytes=wbytes)
            what = (f"{dot_byte_products(16, 13, 0)} int8 byte products "
                    f"per product")
        ms = call_ms if dev_ms is None else dev_ms
        entries[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=None)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.6f} ms"
        lines.append(f"{name} at ({m}, {k}) x ({k}, {n}), wl 16 vbl 13: "
                     f"kernel {dev_txt} on the device (profiler), wrapper "
                     f"call {call_ms:.6f} ms (CUDA events), plain "
                     f"{plain_ms:.6f} ms, bound {bound:.6f} ms ({by}; "
                     f"{what}; bound / time {bound / ms:.4g}), max abs "
                     f"error {err}")
    return entries, lines


# ------------------------------------------------ slice 5: bitexact serving
CODED_SOURCE = "src/repro_torch/kernels/csrc/bbm_coded_mma.cuh"
CODED_KERNEL = "bbm_coded_mma_kernel"            # the tensor-core route
CODED_TILE_SOURCE = "src/repro_torch/kernels/csrc/bbm_dot.cu"
CODED_TILE_KERNEL = "bbm_coded_kernel"           # the CUDA-core route
CODED_REPLACES = "src/repro/kernels/bbm_matmul.py:112"
EMPTY_KERNEL = "bbm_empty_kernel"
# the CUDA-core kernel's earlier record on the main path's decode launches
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6), which the tensor-core route
# is held against
CODED_BEFORE_MS = {"qk": 0.020090, "pv": 0.054154}
PREFILL_G, PREFILL_LEN = 7 * 128, 512    # amm_dot's prefill pair
KV_BLOCK = 16
SERVE_SLOTS, SERVE_LEN, SERVE_KV, SERVE_G, SERVE_D = 8, 512, 2, 7, 64


def bitexact_config(layers=None):
    """qwen2-0.5b at full width, bitexact bbm0 WL 16 / VBL 13 on the MLPs
    and the attention products (``--amm bitexact --amm-attn``)."""
    import dataclasses
    from repro_torch.configs.base import AmmConfig
    cfg = dataclasses.replace(lm_config(), amm=AmmConfig(
        mode="bitexact", mul="bbm0", wl=16, param=13, apply_to="all"))
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def coded_operands(torch, rng, dev, *, s: int, wl: int, b=SERVE_SLOTS,
                   kvh=SERVE_KV, g=SERVE_G, d=SERVE_D, kv_len=None) -> dict:
    """Both coded products' operands of one decode step over a code cache
    of S positions: random cached codes (stale past each slot's length),
    block scales, zeroed (never written) past the live blocks of every
    other slot, ragged lengths (1 and S among them) unless given; q and
    the probabilities quantized per (slot, kv-head) slice."""
    from repro_torch.kernels.ref import amm_quantize_slices
    lim = 2 ** (wl - 1) - 1
    dt = torch.int16 if wl > 8 else torch.int8
    if kv_len is None:
        kv_len = rng.integers(1, s + 1, b)
        kv_len[0], kv_len[-1] = 1, s
    kv_len = np.asarray(kv_len, np.int64)
    ops = {}
    for side in ("k", "v"):
        ops[side] = torch.from_numpy(rng.integers(
            -lim - 1, lim + 1, (b, s, kvh, d))).to(dt).to(dev)
        sc = rng.uniform(1e-3, 0.1, (b, s // KV_BLOCK, kvh)).astype(
            np.float32)
        for i in range(1, b, 2):
            sc[i, -(-int(kv_len[i]) // KV_BLOCK):] = 0.0
        ops[side + "_scale"] = torch.from_numpy(sc).to(dev)
    live = np.arange(s)[None, :] < kv_len[:, None]
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32) / 8.0
    p = rng.exponential(1.0, (b, kvh, g, s)) * live[:, None, None, :]
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    ops["aq"], ops["s_a"] = amm_quantize_slices(torch.from_numpy(q).to(dev),
                                                wl)
    ops["pq"], ops["s_p"] = amm_quantize_slices(torch.from_numpy(p).to(dev),
                                                wl)
    ops["live"] = torch.from_numpy(kv_len).to(dev)
    ops["kv_len"] = kv_len
    return ops


def coded_calls(ops) -> dict:
    """{product: (a, s_a, b view, s_b view, per)} of decode attention on
    the code cache, the views those ``decode_attention_codes`` takes."""
    return {"qk": (ops["aq"], ops["s_a"], ops["k"].permute(0, 2, 3, 1),
                   ops["k_scale"].permute(0, 2, 1), "column"),
            "pv": (ops["pq"], ops["s_p"], ops["v"].permute(0, 2, 1, 3),
                   ops["v_scale"].permute(0, 2, 1), "kblock")}


def prefill_operands(torch, rng, dev, *, wl=16, bt=SERVE_KV,
                     m=PREFILL_G, skv=PREFILL_LEN, d=SERVE_D) -> dict:
    """``amm_dot``'s prefill pair as ``chunked_attention`` hands it over
    (one q block of 128 positions times the 7 query heads of a kv head,
    the 512-position cache): the scores against a transposed view of the
    keys, the probabilities against the values, each slice quantized
    with its own scales, per column with block = N."""
    from repro_torch.kernels.ref import amm_quantize_slices
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    p = torch.from_numpy(rng.uniform(0, 1, (bt, 1, m, skv)).astype(
        np.float32)).to(dev)
    out = {}
    for name, x, y in (("qk prefill", f(bt, 1, m, d) / 8.0,
                        f(bt, 1, skv, d).transpose(-1, -2)),
                       ("pv prefill", p, f(bt, 1, skv, d))):
        aq, s_a = amm_quantize_slices(x, wl)
        bq, s_b = amm_quantize_slices(y, wl)
        out[name] = (aq.contiguous(), s_a, bq, s_b[..., None], "column")
    return out


def coded_route_check(torch, tb, args, kw, what: str) -> str:
    """One batched call through the public wrapper, its route read off
    ``mma_launches`` and held to ``bbm_coded_route``; the output, and on
    a tensor-core point the CUDA-core kernel's through its C entry, equal
    to the plain version on CPU copies (``torch.equal``); at a CUDA-core
    point a forced tensor-core launch refused.  Returns the rule's route."""
    kw = dict({"per": "column", "live": None}, **kw)
    rule = tb.bbm_coded_route(kw["wl"], kw["vbl"], kw["kind"], kw["per"],
                              kw["block"])
    before = tb.bbm_dot_coded_batched.mma_launches
    got = tb.bbm_dot_coded_batched(*args, **kw)
    if tb.bbm_dot_coded_batched.mma_launches - before != (rule == "mma"):
        fail(f"bbm_dot_coded_batched ({what}) did not take the rule's "
             f"route {rule}")
    cpu = dict(kw, live=None if kw["live"] is None else kw["live"].cpu())
    want = tb.bbm_dot_coded_batched_plain(*[t.cpu() for t in args], **cpu)
    outs = {rule: got}
    if rule == "mma":
        outs["tile"] = tb._coded_launch("tile", *args, **kw)[0]
    else:
        try:
            tb._coded_launch("mma", *args, **kw)
            fail(f"the tensor-core route ran at a CUDA-core point ({what})")
        except ValueError:
            pass
    for route, out in outs.items():
        if not torch.equal(out.cpu(), want):
            fail(f"bbm_dot_coded_batched ({what}, route {route}) differs "
                 f"from its plain version by "
                 f"{float((out.cpu() - want).abs().max())}")
    return rule


def coded_sweep(torch, tb, dev) -> tuple:
    """``bbm_dot_coded_batched`` bit-equal to its plain version (on CPU
    copies) on both routes (``coded_route_check``) over both products,
    both kinds, S 16-512, the WL 16 points of the main path and of a
    chunk shorter than a block, int8 codes at WL 8, unit scales (the raw
    sums, ``bbm_dot_scaled`` of each slice), and ``amm_dot``'s prefill
    pair.  Returns (cases, {route: cases})."""
    rng = np.random.default_rng(11)
    routes = {"mma": 0, "tile": 0}
    for wl, vbl, kind, sizes in ((16, 13, 0, (16, 48, 128, 512)),
                                 (16, 13, 1, (16, 48, 128, 512)),
                                 (16, 3, 0, (48, 128)), (8, 5, 1, (64,))):
        for s in sizes:
            ops = coded_operands(torch, rng, dev, s=s, wl=wl)
            kw = dict(wl=wl, vbl=vbl, kind=kind)
            for name, (a, s_a, b, s_b, per) in coded_calls(ops).items():
                ones = (torch.ones_like(s_a),
                        torch.ones((*b.shape[:2], b.shape[3]), device=dev))
                for descale in (True, False) if s == 48 else (True,):
                    args = (a, s_a, b, s_b) if descale \
                        else (a, ones[0], b, ones[1])
                    extra = dict(block=KV_BLOCK, per=per, live=ops["live"]) \
                        if descale else dict(block=1)
                    routes[coded_route_check(
                        torch, tb, args, dict(kw, **extra),
                        f"{name}, S={s}, wl={wl} vbl={vbl} kind={kind}, "
                        f"descale={descale}")] += 1
    for kind in (0, 1):
        for name, (a, s_a, b, s_b, per) in prefill_operands(
                torch, rng, dev).items():
            routes[coded_route_check(
                torch, tb, (a, s_a, b, s_b),
                dict(wl=16, vbl=13, kind=kind, block=b.shape[-1], per=per),
                f"{name}, kind={kind}")] += 1
    return sum(routes.values()), routes


def coded_tile_path(torch, tb, dev) -> dict:
    """The CUDA-core route's own path: ``decode_attention_codes`` (the
    code cache's decode step) at bbm0 WL 16 / VBL 3, whose chunks of 7
    products the tensor cores do not take, at the main path's cache
    shapes; the counts zeroed just before, read just after (2 launches,
    none on the tensor cores), the output finite."""
    from repro_torch.configs.base import AmmConfig
    from repro_torch.models.attention import decode_attention_codes
    from repro_torch.models.common import AmmRuntime
    amm = AmmRuntime.build(AmmConfig(mode="bitexact", mul="bbm0", wl=16,
                                     param=3, apply_to="attn"))
    ops = coded_operands(torch, np.random.default_rng(14), dev,
                         s=SERVE_LEN, wl=16)
    cache = {"k_codes": ops["k"], "k_scale": ops["k_scale"],
             "v_codes": ops["v"], "v_scale": ops["v_scale"]}
    q = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (SERVE_SLOTS, 1, SERVE_KV * SERVE_G, SERVE_D)).astype(
        np.float32)).to(dev)
    fn = tb.bbm_dot_coded_batched
    fn.launches = fn.mma_launches = 0
    out = decode_attention_codes(q, cache, ops["live"], amm=amm)
    torch.cuda.synchronize()
    got = {"launches": fn.launches, "mma_launches": fn.mma_launches}
    if got != {"launches": 2, "mma_launches": 0}:
        fail(f"decode attention at WL 16 / VBL 3 launched {got}, expected "
             f"2 launches of the CUDA-core route")
    if not bool(torch.isfinite(out).all()):
        fail("decode attention at WL 16 / VBL 3 gave non-finite values")
    return got


class LaunchRecorder(Recorder):
    """A ``Recorder`` that also holds every ``lm_apply`` call's launches of
    each counted wrapper to ``want`` (a dict, or a function of the call's
    kind and tokens giving one); ``start()`` zeroes the counts."""

    def __init__(self, torch, fns, counters: dict, want: dict):
        super().__init__(torch, fns, keep=False)
        self.counters, self.want = counters, want
        self.kinds = set()

    def start(self):
        for f in self.counters.values():
            f.launches = 0
        self.last = {n: 0 for n in self.counters}

    def _note(self, kind, tokens, pos, logits):
        super()._note(kind, tokens, pos, logits)
        now = {n: f.launches for n, f in self.counters.items()}
        got = {n: now[n] - self.last[n] for n in now}
        self.last = now
        want = self.want(kind, tokens) if callable(self.want) else self.want
        if got != want:
            fail(f"an lm_apply {kind} call launched {got}, expected {want}")
        self.kinds.add(kind)


def serve_bitexact(torch, dev, cfg, params, tb) -> dict:
    """The bitexact kv-codes workload through the continuous Scheduler:
    8 slots, max_len 512, 32 requests of 32-256 prompt tokens and
    ``SERVE_NEW`` new tokens each; every call's launches checked."""
    from repro_torch.models import ModelRuntime
    from repro_torch.serve import Request, Scheduler, make_serve_fns
    rt = ModelRuntime.build(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planes = rt.build_planes(cfg, params)
    torch.cuda.synchronize()
    planes_s = time.perf_counter() - t0
    layers = cfg.n_layers
    rec = LaunchRecorder(
        torch, make_serve_fns(cfg, rt, amm_planes=planes, kv_codes=True),
        {"bbm_dot_scaled": tb.bbm_dot_scaled,
         "bbm_dot_coded_batched": tb.bbm_dot_coded_batched},
        {"bbm_dot_scaled": 3 * layers, "bbm_dot_coded_batched": 2 * layers})
    sched = Scheduler(cfg, rt, params, SERVE_SLOTS, SERVE_LEN,
                      decode_fn=rec.decode, prefill_fn=rec.prefill,
                      continuous=True, kv_codes=True, device=dev)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(32, 257))).tolist(),
        max_new=SERVE_NEW)
        for i in range(32)]
    for r in reqs:
        sched.submit(r)
    step_ms, lens = [], None
    rec.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        pre = sched.stats["prefills"]
        ts = time.perf_counter()
        n = sched.step()
        if not n:
            break
        if sched.stats["prefills"] == pre:      # a pure decode step
            step_ms.append((time.perf_counter() - ts) * 1e3)
            if lens is None and all(s is not None for s in sched.slots):
                lens = sched.pos.copy()         # a full decode batch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sched.stats
    calls = st["steps"] + st["prefills"]
    if rec.calls != calls or rec.kinds != {"prefill", "decode"}:
        fail(f"the Scheduler made {rec.calls} lm_apply calls ({rec.kinds}),"
             f" its stats say {calls}")
    if st["failed"] or st["deadline_expired"] or st["completed"] != len(reqs):
        fail(f"the Scheduler did not serve every request: {st}")
    if any(r.error or len(r.out) != SERVE_NEW for r in reqs):
        fail("a request ended early or failed")
    if int(rec.bad) != 0:
        fail(f"{int(rec.bad)} non-finite logits on the bitexact path")
    step_ms.sort()
    return {"stats": st, "calls": calls, "wall_s": wall, "step_ms": step_ms,
            "tokens": sum(len(r.out) for r in reqs),
            "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "launches": {n: f.launches for n, f in rec.counters.items()},
            "planes": planes, "planes_s": planes_s, "lens": lens, "rt": rt}


def first_layers(params, n: int):
    """The parameters of an ``n``-layer cut: the first n of every stacked
    layer leaf (views)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    return dict(params, layers=cut(params["layers"]))


def coded_bound_ms(ops, per: str, wl=16, vbl=13, kind=0) -> tuple:
    """(bound ms, what bounds it) of one batched coded launch on this
    run's data: the bytes it must move (a's codes at ``code_bytes(wl)``
    and scales, the live cached codes and their block scales, the int32
    lengths, the f32 output) over 3.35 TB/s, against its live products at
    the contracted dot form's fewest int8 byte products
    (``dot_byte_products``, 2 operations each) over the int8 tensor-core
    peak."""
    b, s_max, kvh, d = ops["k"].shape
    bt, m = b * kvh, ops["aq"].shape[2]
    live = int(np.sum(ops["kv_len"])) * kvh             # slice positions
    blocks = int(np.sum(-(-ops["kv_len"] // KV_BLOCK))) * kvh
    # a: q's codes (M, d) a slice, or P's live columns; out: (M, S) scores
    # or (M, d) values a slice
    a_elems, n_out = (bt * m * d, s_max) if per == "column" \
        else (m * live, d)
    nbytes = (code_bytes(wl) * a_elems + 4 * bt
              + ops["k"].element_size() * live * d
              + 4 * blocks + 4 * b + 4 * bt * m * n_out)
    return _bound(nbytes, m * live * d, wl, vbl, kind)


def dense_coded_bound_ms(bt: int, m: int, k: int, n: int, wl=16, vbl=13,
                         kind=0) -> tuple:
    """(bound ms, what bounds it) of a batched coded launch with nothing
    past a live length (``amm_dot``'s calls): a's and b's codes at
    ``code_bytes(wl)``, a scale each a slice, the f32 output, against
    bt m k n products at the fewest int8 byte products."""
    cb = code_bytes(wl)
    nbytes = cb * bt * (m * k + k * n) + 8 * bt + 4 * bt * m * n
    return _bound(nbytes, bt * m * k * n, wl, vbl, kind)


def _bound(nbytes: int, products: int, wl: int, vbl: int,
           kind: int) -> tuple:
    t_ops = 2 * dot_byte_products(wl, vbl, kind) * products / INT8_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def coded_timing(torch, tb, dev, lens) -> tuple:
    """The batched entry's two launches of a decode step at the main
    path's shapes and its slots' lengths, and ``amm_dot``'s prefill pair:
    device ms of the tensor-core kernel (the public wrapper) and of the
    CUDA-core kernel on the same operands (its C entry), plain ms (on the
    card), bound, and one f32 ``torch.bmm`` of the same (Bt, M, K) x (Bt,
    K, N) as a yardstick (exact products, not the same function); then
    an empty kernel's launch, the floor under every time here."""
    rng = np.random.default_rng(12)
    ops = coded_operands(torch, rng, dev, s=SERVE_LEN, wl=16, kv_len=lens)
    calls = {name: (call, dict(block=KV_BLOCK, live=ops["live"]),
                    coded_bound_ms(ops, call[4]))
             for name, call in coded_calls(ops).items()}
    for name, call in prefill_operands(torch, rng, dev).items():
        bt, m, k = call[0].shape[0] * call[0].shape[1], *call[0].shape[2:]
        calls[name] = (call, dict(block=call[2].shape[-1], live=None),
                       dense_coded_bound_ms(bt, m, k, call[2].shape[-1]))
    rows, lines = {}, []
    for name, ((a, s_a, b, s_b, per), extra, (bound, by)) in calls.items():
        kw = dict(wl=16, vbl=13, kind=0, per=per, **extra)
        run = lambda: tb.bbm_dot_coded_batched(  # noqa: E731
            a, s_a, b, s_b, **kw)
        tile = lambda: tb._coded_launch(  # noqa: E731
            "tile", a, s_a, b, s_b, **kw)[0]
        plain = lambda: tb.bbm_dot_coded_batched_plain(  # noqa: E731
            a, s_a, b, s_b, **kw)
        ms, how = launch_ms(torch, run, 50, CODED_KERNEL)
        tile_ms, tile_how = launch_ms(torch, tile, 50, CODED_TILE_KERNEL)
        call_ms = cuda_ms(torch, run, 50)
        plain_ms = cuda_ms(torch, plain, 3)
        want = plain()
        err = float((run() - want).abs().max())
        tile_err = float((tile() - want).abs().max())
        if err != 0 or tile_err != 0:
            fail(f"bbm_dot_coded_batched ({name}) differs from its plain "
                 f"version on the card by {err} (tensor cores), "
                 f"{tile_err} (CUDA cores)")
        af = a.reshape(-1, *a.shape[2:]).float()
        bf = b.reshape(-1, *b.shape[2:]).float().contiguous()
        bmm_ms = cuda_ms(torch, lambda: torch.bmm(af, bf), 50)
        rows[name] = dict(ms=ms, how=how, tile_ms=tile_ms,
                          tile_how=tile_how, plain_ms=plain_ms, bound=bound,
                          by=by, bmm_ms=bmm_ms, err=err, tile_err=tile_err)
        before = CODED_BEFORE_MS.get(name)
        shown_lens = "" if extra["live"] is None \
            else f", lengths {list(map(int, lens))}"
        record = "" if before is None \
            else f"; its earlier record {before:.6f} ms"
        lines.append(
            f"bbm_dot_coded_batched {name} ({a.shape[0] * a.shape[1]} "
            f"slices of ({a.shape[2]}, {a.shape[3]}) x ({b.shape[2]}, "
            f"{b.shape[3]}), per={per}{shown_lens}): tensor cores "
            f"{ms:.6f} ms ({how}), CUDA-core kernel {tile_ms:.6f} ms "
            f"({tile_how}; {tile_ms / ms:.3g}x the tensor cores' time"
            f"{record}), wrapper call {call_ms:.6f} ms (CUDA events), plain "
            f"{plain_ms:.6f} ms, bound {bound:.6f} ms ({by}; bound / time "
            f"{bound / ms:.4g}), f32 torch.bmm yardstick {bmm_ms:.6f} ms; "
            f"both routes bit-equal to the plain version")
    from repro_torch.kernels._build import library
    lib = library("bbm_dot")
    stream = torch.cuda.current_stream(dev).cuda_stream
    empty_ms, empty_how = launch_ms(
        torch, lambda: lib.bbm_empty_launch(stream), 50, EMPTY_KERNEL)
    lines.append(f"an empty kernel (1 block of 32 threads): {empty_ms:.6f} "
                 f"ms a launch ({empty_how}), the floor beside every bound "
                 f"above")
    return rows, lines, empty_ms


def b2_decode_timing(torch, tb, dev, planes, params) -> tuple:
    """``bbm_dot_scaled`` at the decode step's two MLP shapes, each call on
    the next layer's precoded weight codes (cold in L2, as on the main
    path): device ms, plain ms, bound, and the f32 ``torch.matmul`` of the
    same shape on the layer's float weight as a yardstick."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    mlp = planes["layers"]["mlp"]
    rows, lines = [], []
    for name, key in (("gate/up", "w_gate"), ("down", "w_down")):
        codes = mlp[key]["codes"]                 # (L, K, N) int32
        weights = params["layers"]["mlp"][key]    # (L, K, N) f32
        k, n = codes.shape[1:]
        x = torch.randint(-32768, 32768, (8, k), generator=gen,
                          device=dev, dtype=torch.int32)
        turn = [0]

        def w():
            turn[0] += 1
            return codes[turn[0] % codes.shape[0]]
        run = lambda: tb.bbm_dot_scaled(  # noqa: E731
            x, w(), wl=16, vbl=13, kind=0)
        plain = lambda: tb.bbm_dot_scaled_plain(  # noqa: E731
            x, w(), wl=16, vbl=13, kind=0)
        ms, how = launch_ms(torch, run, 2 * codes.shape[0],
                            TRAIN_KERNELS["bbm_dot_scaled"])
        plain_ms = cuda_ms(torch, plain, 3)
        xf = x.float()
        lib_ms = cuda_ms(torch, lambda: xf @ weights[turn[0] % len(weights)],
                         2 * codes.shape[0])
        turn[0] = 0
        got = run()
        turn[0] = 0
        err = float((got - plain()).abs().max())
        if err != 0:
            fail(f"bbm_dot_scaled at the decode shape (8, {k}) x ({k}, {n}) "
                 f"differs from its plain version by {err}")
        bound, by = dot_scaled_bound_ms(8, k, n)
        rows.append(dict(ms=ms, how=how, plain_ms=plain_ms, bound=bound,
                         by=by, lib_ms=lib_ms, err=err))
        lines.append(
            f"bbm_dot_scaled at the decode {name} shape (8, {k}) x ({k}, "
            f"{n}), weights from device memory: kernel {ms:.6f} ms ({how}), "
            f"plain {plain_ms:.6f} ms, bound {bound:.6f} ms ({by}; bound / "
            f"time {bound / ms:.4g}), f32 torch.matmul yardstick {lib_ms:.6f} "
            f"ms; bit-equal to the plain version")
    return rows, lines


# ------------------------------------- slice 6: noise mode's normal draw
NORMAL_SOURCE = "src/repro_torch/kernels/csrc/normal.cu"
# jax.random.normal, the XLA op the reference's plain noise branch draws
# with (also at src/repro/core/noise.py:75 and src/repro/kernels/ref.py:389)
NORMAL_REPLACES = REPLACES["normal_draw"]
NORMAL_KERNEL = "normal_kernel"
# the plain noise branch's draws: yq of the MLP products at a decode step
# (8 slots) and at a prefill of 256 tokens (a batch-1 slot slice)
NORMAL_SHAPES = ((8, 1, 4864), (8, 1, 896), (1, 256, 4864), (1, 256, 896))
NORMAL_TIMED = (("decode", (8, 1, 4864), 896), ("prefill", (1, 256, 4864),
                                                 896))
NORMAL_MOMENT_N = 10_000_000
# the plain noise branch's CPU replay runs on this many of the 24 layers
NOISE_CPU_LAYERS = 6
# operations an element takes, counted from csrc/normal.cu: integer ops
# (Threefry-2x32: 20 rounds of add, rotate, xor; 5 key injections of 2
# adds, since ks[(g + 2) % 3] + g + 1 depends on the key alone and is
# formed outside the element loop; the 2 counter words, 2 initial adds,
# the xor of the words; the uniform's shift and or) and float32 ops (an
# FMA counts 2, a division or square root 1) per path: the uniform and
# -u*u; log1p's rational branch (|u*u| < sqrt(2) - 1) or log(1 + y);
# ErfInv32 (the sqrt branch where w >= 5 adds one); the draw's
# * sqrt(2) or the epilogue's add and FMA
NORMAL_INT_OPS = 20 * 3 + 5 * 2 + 2 + 2 + 1 + 2
NORMAL_F32_OPS = {"uniform": 5, "log1p_small": 31, "log1p_large": 37,
                  "erfinv": 21, "sqrt": 1, "draw": 1, "epilogue": 3}


def normal_bound_ms(prng, k, shape, epilogue: bool) -> tuple:
    """(bound ms, what bounds it) of one draw over ``shape``: the bytes
    (each output written once; the epilogue's accumulator read once more)
    over the memory rate, against the operations: the integer ops at the
    int32 rate or the float32 ops at the float32 rate, whichever takes
    longer (the two pipes issue side by side), each element's path
    counted from this run's data (its uniform)."""
    import torch
    n = int(np.prod(shape))
    bits = prng.random_bits(k, shape, "cpu")
    mant = (((bits & 0xFFFFFFFF) >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) * 2.0 - 3.0             # 2 f - 1, near lo
    y = (u * u).double()
    small = int((y < 2 ** 0.5 - 1).sum())
    w_ge5 = int((-torch.log1p(-y) >= 5).sum())
    f32 = n * (NORMAL_F32_OPS["uniform"] + NORMAL_F32_OPS["erfinv"]) \
        + small * NORMAL_F32_OPS["log1p_small"] \
        + (n - small) * NORMAL_F32_OPS["log1p_large"] \
        + w_ge5 * NORMAL_F32_OPS["sqrt"] \
        + n * NORMAL_F32_OPS["epilogue" if epilogue else "draw"]
    t_ops = max(n * NORMAL_INT_OPS / INT32_OPS_PER_S, f32 / F32_OPS_PER_S)
    t_bytes = (8 if epilogue else 4) * n / HBM_BYTES_PER_S
    t = max(t_ops, t_bytes)
    return t * 1e3, ("bytes" if t == t_bytes else "operations")


def normal_sweep(torch, nm, prng, dev, mu: float, sigma: float) -> dict:
    """The normal-draw kernel against its plain version (on the CPU), bit
    for bit: the transform from bits over all 2^23 uniforms; then the
    draw and both epilogues at the main path's shapes for several keys."""
    n = 1 << 23
    bits = (torch.arange(n, dtype=torch.int64) << 9) | 0x1AB
    got = nm.normal_bits(bits.to(dev)).cpu()
    want = prng.normal_from_bits(bits)
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if bad:
        first = int(torch.nonzero(got.view(torch.int32)
                                  != want.view(torch.int32))[0])
        fail(f"normal_bits differs from its plain version on {bad} of the "
             f"2^23 uniforms, first at bits {int(bits[first]):#x}")
    keys = [prng.layer_keys(0, 24)[0], prng.split(prng.key(5))[1],
            (0xFFFFFFFF, 0x12345678)]
    gen = torch.Generator().manual_seed(21)
    cases, err = 0, 0.0
    for shape in NORMAL_SHAPES:
        k_len = 4864 if shape[-1] == 896 else 896
        c1, c2 = nm.noise_consts(mu, sigma, k_len)
        acc = torch.randn(shape, generator=gen) * 1e9
        for k in keys:
            runs = [(None, nm.normal_draw(k, shape, device=dev),
                     prng.normal_plain(k, shape))]
            for order in ("acc", "noise"):
                runs.append((order, nm.normal_draw(
                    k, shape, acc=acc.to(dev, copy=True), c1=c1, c2=c2,
                    order=order),
                    prng.normal_plain(k, shape, acc=acc, c1=c1, c2=c2,
                                      order=order)))
            for order, g, w in runs:
                g = g.cpu()
                err = max(err, float((g.double() - w.double()).abs().max()))
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    fail(f"normal_draw differs from its plain version at "
                         f"{shape}, key {k}, epilogue {order}")
                cases += 1
    return {"uniforms": n, "cases": cases, "max_abs_err": err}


def normal_timing(torch, nm, prng, dev, mu: float, sigma: float) -> list:
    """The kernel per launch at a decode and a prefill shape (the draw and
    the epilogue), its bound, its plain version on the card and
    ``torch.randn`` at the same shape (not the same function)."""
    rows = []
    k = prng.layer_keys(0, 24)[0]
    for name, shape, k_len in NORMAL_TIMED:
        c1, c2 = nm.noise_consts(mu, sigma, k_len)
        acc = torch.randn(shape, device=dev)
        ms, how = launch_ms(torch, lambda: nm.normal_draw(k, shape,
                                                          device=dev),
                            200, NORMAL_KERNEL)
        epi_ms, epi_how = launch_ms(torch, lambda: nm.normal_draw(
            k, shape, acc=acc, c1=c1, c2=c2), 200, NORMAL_KERNEL)
        plain_ms = cuda_ms(torch, lambda: prng.normal_plain(
            k, shape, acc=acc, c1=c1, c2=c2), 5)
        lib_ms, lib_how = launch_ms(torch, lambda: torch.randn(
            shape, device=dev), 200, ("distribution", "normal_kernel"))
        bound, by = normal_bound_ms(prng, k, shape, False)
        epi_bound, epi_by = normal_bound_ms(prng, k, shape, True)
        rows.append(dict(name=name, shape=shape, ms=ms, how=how,
                         epi_ms=epi_ms, epi_how=epi_how, plain_ms=plain_ms,
                         lib_ms=lib_ms, lib_how=lib_how, bound=bound, by=by,
                         epi_bound=epi_bound, epi_by=epi_by))
    return rows


def noise_plain_config():
    """The main path's noise setting on the plain branch: no fused
    kernel, the layer keys' jax.random.normal draws."""
    import dataclasses
    cfg = lm_config()
    return dataclasses.replace(cfg, amm=dataclasses.replace(
        cfg.amm, use_pallas=False))


def noise_plain_path(torch, dev, cfg, rt, params, nm, qm) -> dict:
    """Serve 24 requests through the continuous Scheduler in noise mode on
    the plain branch; every lm_apply call must launch the normal-draw
    kernel 72 times (3 MLP products x 24 layers) and quant_matmul never."""
    from repro_torch.serve import Request, Scheduler, make_serve_fns
    rng = np.random.default_rng(7)
    rec = Recorder(torch, make_serve_fns(cfg, rt), keep=False)
    sched = Scheduler(cfg, rt, params, 8, 512, decode_fn=rec.decode,
                      prefill_fn=rec.prefill, continuous=True, device=dev)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(32, 257))).tolist(),
        max_new=SERVE_NEW)
        for i in range(24)]
    for r in reqs:
        sched.submit(r)
    step_ms = []
    nm.normal_draw.launches = 0
    qm.quant_matmul.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        pre = sched.stats["prefills"]
        ts = time.perf_counter()
        if not sched.step():
            break
        if sched.stats["prefills"] == pre:      # a pure decode step
            step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nm.normal_draw.launches
    st = sched.stats
    calls = st["steps"] + st["prefills"]
    if rec.calls != calls:
        fail(f"the Scheduler made {rec.calls} lm_apply calls, its stats "
             f"say {calls}")
    if launches != 3 * cfg.n_layers * calls or qm.quant_matmul.launches:
        fail(f"normal_draw launched {launches} times for {calls} lm_apply "
             f"calls (expected {3 * cfg.n_layers * calls}), quant_matmul "
             f"{qm.quant_matmul.launches} (expected 0)")
    if st["failed"] or st["deadline_expired"] or st["completed"] != len(reqs):
        fail(f"the Scheduler did not serve every request: {st}")
    if any(r.error or len(r.out) != SERVE_NEW for r in reqs):
        fail("a request ended early or failed")
    if int(rec.bad) != 0:
        fail(f"{int(rec.bad)} non-finite logits on the plain noise branch")
    step_ms.sort()
    return {"stats": st, "launches": launches, "calls": calls,
            "tokens": sum(len(r.out) for r in reqs), "wall_s": wall,
            "step_ms": step_ms,
            "prompt_tokens": sum(len(r.prompt) for r in reqs)}


def normal_moments(torch, nm, prng, dev) -> tuple:
    """Mean and standard deviation of ``NORMAL_MOMENT_N`` draws of the
    kernel, against N(0, 1): five standard errors each."""
    z = nm.normal_draw(prng.key(2024), (NORMAL_MOMENT_N,),
                       device=dev).double()
    mean, std = float(z.mean()), float(z.std())
    if abs(mean) > 5 / NORMAL_MOMENT_N ** 0.5 \
            or abs(std - 1) > 5 / (2 * NORMAL_MOMENT_N) ** 0.5:
        fail(f"{NORMAL_MOMENT_N} normal draws have mean {mean!r} and std "
             f"{std!r}, off N(0, 1)")
    return mean, std


def paper_tables(torch, dev) -> list:
    """The paper's claim set on the card: Table I exhaustive (equal to the
    CPU port's floats), Fig. 2's histogram (equal to the CPU port's),
    Figs. 5/6's sampled MSE and average PDP for the five families, Tables
    II/III from the hardware model, Fig. 8's SNR against VBL and Table IV
    through ``fir_apply`` on the card (the filterbank kernels)."""
    from repro_torch.core import errstats as te
    from repro_torch.core import hwmodel as hw
    from repro_torch.core.multipliers import MulSpec
    from repro_torch.dsp import make_signals, run_filter_case
    lines = []
    t0 = time.perf_counter()
    worst = 0.0
    for vbl, (pm, pmse, pprob, pmin) in te.PAPER_TABLE1.items():
        spec = MulSpec("bbm0", 12, vbl)
        st = te.characterize(spec, device=dev)
        if st != te.characterize(spec, device="cpu") or st.n != 1 << 24:
            fail(f"Table I at VBL {vbl}: the card's ErrorStats differ from "
                 f"the CPU port's")
        worst = max(worst, abs(st.mse - pmse) / pmse,
                    abs(st.mean - pm) / abs(pm))
        lines.append(f"Table I WL 12 VBL {vbl} (2^24 pairs on the card, "
                     f"equal to the CPU port): mean {float(st.mean)!r} "
                     f"(paper {pm}), MSE {float(st.mse)!r} ({pmse}), "
                     f"P(err != 0) {float(st.prob)!r} ({pprob}), min "
                     f"{float(st.min)!r} ({pmin}), max {float(st.max)!r}")
    lines.append(f"Table I: largest relative delta of mean and MSE against "
                 f"the paper {worst:.4g} ({time.perf_counter() - t0:.1f} s)")
    spec = MulSpec("bbm0", 10, 9)
    centers, pct = te.error_histogram(spec, bins=41, device=dev)
    c_cpu, p_cpu = te.error_histogram(spec, bins=41, device="cpu")
    if not (np.array_equal(centers, c_cpu) and np.array_equal(pct, p_cpu)):
        fail("Fig. 2's histogram on the card differs from the CPU port's")
    lines.append(f"Fig. 2 (bbm0 WL 10 VBL 9, 41 bins, equal to the CPU "
                 f"port): negative mass {float(pct[centers < 0].sum())!r} "
                 f"%, bins above 0.1 % {int((pct > 0.1).sum())}, peak "
                 f"{float(pct.max())!r} % at {float(centers[pct.argmax()])!r}"
                 f" x 2^19")
    sweeps = {"bbm0": [MulSpec("bbm0", 12, v) for v in (1, 3, 5, 7, 9, 11)],
              "bbm1": [MulSpec("bbm1", 12, v) for v in (1, 3, 5, 7, 9, 11)],
              "bam": [MulSpec("bam", 12, v) for v in (3, 6, 9, 12, 15)],
              "kulkarni": [MulSpec("kulkarni", 12, k)
                           for k in (5, 9, 13, 17, 21)],
              "etm": [MulSpec("etm", 12, sp) for sp in (3, 5, 7, 9)]}
    for name, specs in sweeps.items():
        pts = []
        for sp in specs:
            st = te.characterize(sp, exhaustive=False, sample=1 << 18,
                                 device=dev)
            pts.append(f"{sp.param}: MSE {st.mse:.6g} PDP "
                       f"{hw.pdp_avg(sp):.6g}")
        lines.append(f"Figs. 5/6 {name} WL 12 (2^18 sampled pairs on the "
                     f"card; PDP from the hardware model): " + ", ".join(pts))
    rows = []
    for wl in (4, 8, 12, 16):
        p0, p1 = (hw.power(MulSpec("bbm0", wl, v)) for v in (0, wl - 1))
        a0, a1 = (hw.area(MulSpec("bbm0", wl, v)) for v in (0, wl - 1))
        rows.append(f"WL {wl}: power -{100 * (1 - p1 / p0):.4g} % (paper "
                    f"{hw.PAPER_POWER_REDUCTION[wl]}), area "
                    f"-{100 * (1 - a1 / a0):.4g} % (paper "
                    f"{hw.PAPER_AREA_REDUCTION[wl]})")
    lines.append("Tables II/III (VBL = WL - 1, the hardware model): "
                 + "; ".join(rows))
    sig = make_signals()
    dbl = run_filter_case(None, sig)
    snrs = {v: run_filter_case(MulSpec("bbm0", 16, v), sig, backend="cuda",
                               device=dev)
            for v in (0, 3, 5, 7, 9, 11, 13, 15)}
    op = max(v for v, snr in snrs.items() if snr >= dbl - 0.45)
    lines.append(f"Fig. 8 (30-tap FIR, bbm0 WL 16, through the filterbank "
                 f"kernels): double precision {dbl:.4f} dB (paper 25.7); "
                 f"SNR by VBL " + ", ".join(f"{v}: {snr:.4f}" for v, snr
                                            in snrs.items())
                 + f"; operating VBL within 0.45 dB {op} (paper 13)")
    cases = [("WL=16,VBL=0", 16, 0), ("WL=16,VBL=13", 16, 13),
             ("WL=16,VBL=15", 16, 15), ("WL=14,VBL=0", 14, 0)]
    t4 = []
    for label, wl, vbl in cases:
        spec = MulSpec("booth" if vbl == 0 else "bbm0", wl, vbl)
        t4.append((label, run_filter_case(spec, sig, backend="cuda",
                                          device=dev),
                   hw.fir_power(wl, vbl), hw.fir_area(wl, vbl)))
    base = t4[0]
    parts = []
    for label, snr, pw, ar in t4:
        ps, asv = 100 * (1 - pw / base[2]), 100 * (1 - ar / base[3])
        parts.append(f"{label}: SNR {snr:.4f} dB, {pw:.4g} mW, "
                     f"{ar:.4g} um^2, power saving {ps:.4g} %, QUAP "
                     f"{hw.quap(snr, max(asv, 0.0), max(ps, 0.0)):.4g}")
    lines.append("Table IV (SNR through the filterbank kernels; power and "
                 "area from the model; the paper: 17.1 % power at VBL 13, "
                 "0.35 dB): " + "; ".join(parts))
    return lines


# ------------------- slice 7: deepseek-v3, MoE and multi-head latent attention
DS_SLOTS, DS_LEN = 8, 512
DS_REQUESTS, DS_NEW = 16, 32
DS_PROMPT = (32, 129)            # prompt lengths drawn from 32..128
DS_NOISE = dict(mode="noise", mul="bbm0", wl=16, param=13, apply_to="mlp",
                use_pallas=True)
DS_BITEXACT = dict(mode="bitexact", mul="bbm0", wl=16, param=13,
                   apply_to="all")
# the card-against-CPU check: the routed experts cut to 16, bitexact
# attention on the latent code cache, the MLPs exact (the CPU's plain dot
# form at d_ff 18432 would take minutes; the kernels' own checks hold B2)
DS_CPU_EXPERTS, DS_CPU_LEN = 16, 64
DS_CPU_AMM = dict(DS_BITEXACT, apply_to="attn")
# the MoE layer's output from the card's input and routing: f32 products
# of K = 7168 and 2048 terms summed in another order, then a weighted sum
# of 8; 2^-12 of the largest element is about 250 times what such sums
# move by at these widths
DS_LAYER_RTOL = 2.0 ** -12
# the first step's B2 calls, held against the plain version: this many
# sampled columns of each bbm_dot_scaled call (a column depends on its own
# weight column alone), this many slices of each batched coded call
DS_SAMPLE_COLS, DS_SAMPLE_SLICES = 512, 32
# the plain versions at the full decode shapes run in blocks of this many
# weight columns or slices (their digit planes take 32 bytes a code)
DS_PLAIN_COLS, DS_PLAIN_SLICES = 1024, 128


def deepseek_config(amm: dict, layers: int = 2, experts=None):
    """deepseek-v3-671b at full width (d_model 7168, 128 heads, q_lora
    1536, kv_lora 512, rope 64, nope 128, v 128, vocab 129,280, dense
    d_ff 18,432, 256 routed experts of width 2,048, top-8, 1 shared),
    cut to ``layers`` (the first dense, the rest MoE) and without the MTP
    head, which serving never reads; ``experts`` cuts the routed
    experts."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import AmmConfig
    kw = dict(n_layers=layers, first_k_dense=1, mtp_depth=0,
              amm=AmmConfig(**amm))
    if experts is not None:
        kw["n_experts"] = experts
    return dataclasses.replace(get_arch("deepseek-v3-671b"), **kw)


def ds_coded_per_call(cfg, kind: str, s: int, max_len: int) -> int:
    """``bbm_dot_coded_batched`` launches an ``lm_apply`` call makes with
    MLA's products on the amm datapath, as the code takes them: a decode
    one score and one value launch a layer (``decode_attention``'s two
    ``amm_dot`` calls); a prefill of ``s`` tokens against the cache one
    pair a layer for every (q block, KV block) of the chunked schedule,
    bq = min(512, s), bk = min(1024, max_len), over the whole cache."""
    if kind == "decode":
        return 2 * cfg.n_layers
    bq, bk = min(512, s), min(1024, max_len)
    return 2 * cfg.n_layers * (-(-s // bq)) * (-(-max_len // bk))


def ds_b2_capture_check(torch, tb, calls, rng, *, cols=DS_SAMPLE_COLS,
                        slices=DS_SAMPLE_SLICES, coded_on="cpu") -> tuple:
    """The first step's B2 calls against their plain versions on their own
    inputs: ``cols`` sampled columns of each ``bbm_dot_scaled`` call (the
    plain version on the card), ``slices`` sampled slices of each batched
    coded call (on copies on ``coded_on``); bit for bit.  Returns (calls
    checked, max abs error)."""
    worst = 0.0
    for name, args, kw, out in calls:
        if name == "bbm_dot_scaled":
            x, w = args
            n = w.shape[1]
            pick = torch.as_tensor(np.sort(rng.choice(
                n, min(cols, n), replace=False)), device=w.device)
            want = tb.bbm_dot_scaled_plain(x, w[:, pick].contiguous(), **kw)
            got = out[:, pick]
        elif name == "bbm_dot_coded_batched":
            a, s_a, b, s_b = args
            sl = torch.as_tensor(np.sort(rng.choice(
                a.shape[0], min(slices, a.shape[0]), replace=False)),
                device=a.device)
            kw = {k: (v[sl].to(coded_on) if torch.is_tensor(v) else v)
                  for k, v in kw.items()}
            want = tb.bbm_dot_coded_batched_plain(
                *(t[sl].to(coded_on) for t in (a, s_a, b, s_b)), **kw)
            got = out[sl]
        err = float((got.to(want.device) - want).abs().max())
        if err != 0:
            fail(f"a first-step {name} call at {tuple(args[0].shape)} x "
                 f"{tuple(args[1].shape)} differs from its plain version "
                 f"by {err}")
        worst = max(worst, err)
    return len(calls), worst


def ds_prompts(cfg, seed: int = 21) -> list:
    """deepseek-v3's traffic: ``DS_REQUESTS`` prompts of ``DS_PROMPT``
    tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, int(rng.integers(*DS_PROMPT))).tolist()
            for _ in range(DS_REQUESTS)]


def ds_serve(torch, dev, cfg, rt, params, counters, want, *, kv_codes,
             first_step, prompts=None) -> dict:
    """Serve ``prompts`` (``ds_prompts`` by default), ``DS_NEW`` new
    tokens each, through the continuous Scheduler (``DS_SLOTS`` slots,
    max_len ``DS_LEN``), every ``lm_apply`` call's launches held to
    ``want``.  ``first_step`` is a pair of functions, called just before
    and just after the first step (the kernel captures), or None."""
    from repro_torch.serve import Request, Scheduler, make_serve_fns
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planes = rt.build_planes(cfg, params)
    torch.cuda.synchronize()
    planes_s = time.perf_counter() - t0
    rec = LaunchRecorder(torch, make_serve_fns(
        cfg, rt, amm_planes=planes, kv_codes=kv_codes), counters, want)
    sched = Scheduler(cfg, rt, params, DS_SLOTS, DS_LEN,
                      decode_fn=rec.decode, prefill_fn=rec.prefill,
                      continuous=True, kv_codes=kv_codes, device=dev)
    reqs = [Request(rid=i, prompt=list(p), max_new=DS_NEW)
            for i, p in enumerate(prompts or ds_prompts(cfg))]
    for r in reqs:
        sched.submit(r)
    step_ms, prefill_ms = [], []
    rec.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if first_step is not None:
        first_step[0]()
    while True:
        pre = sched.stats["prefills"]
        ts = time.perf_counter()
        n = sched.step()
        if sched.stats["steps"] == 1 and first_step is not None:
            torch.cuda.synchronize()
            first_step[1]()
            first_step = None
        if not n:
            break
        (prefill_ms if sched.stats["prefills"] != pre else step_ms).append(
            (time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sched.stats
    calls = st["steps"] + st["prefills"]
    if rec.calls != calls or rec.kinds != {"prefill", "decode"}:
        fail(f"the Scheduler made {rec.calls} lm_apply calls ({rec.kinds}),"
             f" its stats say {calls}")
    if st["failed"] or st["deadline_expired"] or st["completed"] != len(reqs):
        fail(f"the Scheduler did not serve every request: {st}")
    if any(r.error or len(r.out) != DS_NEW for r in reqs):
        fail("a request ended early or failed")
    if int(rec.bad) != 0:
        fail(f"{int(rec.bad)} non-finite logits serving {cfg.name}")
    step_ms.sort()
    return {"stats": st, "calls": calls, "wall_s": wall, "step_ms": step_ms,
            "prefill_ms": sorted(prefill_ms),
            "tokens": sum(len(r.out) for r in reqs),
            "prompt_lens": sorted({len(r.prompt) for r in reqs}),
            "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "launches": {n: f.launches for n, f in counters.items()},
            "planes": planes, "planes_s": planes_s}


def ds_serve_line(name: str, res: dict, per_call: str,
                  arch: str = "deepseek-v3") -> str:
    st, steps = res["stats"], res["step_ms"]
    return (f"{arch} {name}: {DS_SLOTS} slots, max_len {DS_LEN}, "
            f"{len(steps)} pure decode steps of {st['steps']}, "
            f"{st['prefills']} prefills, {res['tokens']} tokens generated "
            f"({res['prompt_tokens']} prompt tokens) in {res['wall_s']:.3f} "
            f"s: {res['tokens'] / res['wall_s']:.6g} generated tokens/s; "
            f"decode step ms p50 {steps[len(steps) // 2]:.3f}, p90 "
            f"{steps[int(len(steps) * 0.9)]:.3f}; a step with a prefill "
            f"p50 {res['prefill_ms'][len(res['prefill_ms']) // 2]:.3f}; "
            f"launches {res['launches']} over {res['calls']} lm_apply calls, "
            f"each call as predicted ({per_call}); nothing failed; all "
            f"logits finite; weight planes {res['planes_s']:.3f} s")


def ds_cut_experts(params, n: int):
    """The parameters with the routed experts cut to the first ``n``
    (views): the router's columns and the expert stacks."""
    moe = params["layers"]["moe"]
    cut = dict(moe, router=moe["router"][..., :n], w_gate=moe["w_gate"][:, :n],
               w_up=moe["w_up"][:, :n], w_down=moe["w_down"][:, :n])
    return dict(params, layers=dict(params["layers"], moe=cut))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


class MoeRecorder:
    """Wraps ``models.transformer``'s ``moe_apply`` while on: each MoE
    layer call's flattened input and output, and its routing recomputed
    from the same input on the same device (router logits, gate weights,
    experts, capacity, ``_dispatch``'s two outputs), kept on the CPU."""

    def __init__(self, tr, moe):
        self.tr, self.moe, self.log = tr, moe, []
        self.orig = tr.moe_apply
        tr.moe_apply = self._call

    def _call(self, p, x, cfg, **kw):
        y, aux = self.orig(p, x, cfg, **kw)
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        lg, gv, gi, _ = self.moe.moe_route(p, xf, cfg)
        cap = self.moe.moe_capacity(cfg, b, s)
        st, ts = self.moe._dispatch(gi.reshape(-1), cfg.top_k, b * s,
                                    cfg.n_experts, cap)
        self.log.append(dict(x=xf.cpu(), y=y.reshape(b * s, d).cpu(),
                             logits=lg.cpu(), vals=gv.cpu(), idx=gi.cpu(),
                             cap=cap, dispatch=(st.cpu(), ts.cpu())))
        return y, aux

    def close(self):
        self.tr.moe_apply = self.orig


class RouteLedger:
    """Per serving slot, the first position a routing flip has reached;
    the positions before it may be compared.

    ``layer(ref, got, rows, positions, k)`` takes one MoE layer call's
    router logits on both sides, token t at (rows[t], positions[t]).  A
    comparable token's logits must agree within ``rtol`` of the largest,
    ``scale``: a fault upstream of the router fails here.  A top-k set
    can then differ only where the affinities moved by half the
    reference's gap between its k-th and (k+1)-th affinity, and they move
    by at most a quarter of the logits' move, so only a near-tie (gap
    below ``rtol * scale / 2``) flips.  A flip is counted, its gap kept,
    and its slot marked from that position on.  ``reset(slot)`` starts a
    new request there."""

    def __init__(self, rtol: float):
        self.rtol = rtol
        self.first = {}
        self.flips = 0
        self.tokens = 0
        self.gaps = []

    def reset(self, row) -> None:
        self.first.pop(row, None)

    def clean(self, rows, positions) -> np.ndarray:
        return np.array([p < self.first.get(r, np.inf)
                         for r, p in zip(rows, positions)], bool)

    def layer(self, ref, got, rows, positions, k: int) -> None:
        ok = self.clean(rows, positions)
        ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
        if not ok.any():
            return
        err = np.abs(ref - got)[ok].max()
        scale = np.abs(ref[ok]).max()
        if err > self.rtol * scale:
            fail(f"router logits off the card's by {err} (largest {scale}) "
                 f"where no routing flip has reached")
        pr, pg = 1 / (1 + np.exp(-ref)), 1 / (1 + np.exp(-got))
        order = np.argsort(-pr, axis=-1, kind="stable")
        want = np.sort(order[:, :k], axis=-1)
        have = np.sort(np.argsort(-pg, axis=-1, kind="stable")[:, :k],
                       axis=-1)
        srt = np.take_along_axis(pr, order, axis=-1)
        for t in np.flatnonzero(ok):
            self.tokens += 1
            if (want[t] != have[t]).any():
                self.flips += 1
                self.gaps.append(float(srt[t, k - 1] - srt[t, k]))
                self.first[rows[t]] = min(self.first.get(rows[t], np.inf),
                                          positions[t])


def ds_cpu_check(torch, dev, params) -> dict:
    """Two requests (a prefill and two decode steps each) on the card and
    on the CPU port, ``DS_CPU_EXPERTS`` routed experts, bitexact attention
    from the latent code cache.  Layer by layer from the card's MoE input:
    the CPU's router logits within twice the f32 summation error's scale,
    sqrt(K) u sum|x_k w_k| (rounding errors of K terms summed in any order
    grow as their square root; the worst case, K u sum|x_k w_k|, is 85
    times wider at K = 7168),
    the CPU's experts equal to the card's at every token whose gap between
    the k-th and (k+1)-th affinity exceeds twice the affinities' tolerance
    (the others are near-ties, counted and reported), ``_dispatch``'s
    outputs on the card's decisions equal on both devices
    (``torch.equal``), and the layer output from the card's routing within
    ``DS_LAYER_RTOL``.  Then the CPU serves the same
    requests teacher-forced on the card's logits, its MoE layers held to
    the card's by a ``RouteLedger``: router logits within ``LOGIT_RTOL``
    (so a differing top-k set can only be a near-tie: counted, and the
    rest of that slot's request left out), and the logits within
    ``LOGIT_RTOL`` at every position no flip has reached."""
    import repro_torch.models.moe as moe
    import repro_torch.models.transformer as tr
    from repro_torch.models import ModelRuntime
    from repro_torch.models.moe import mlp_apply
    from repro_torch.serve import Request, Scheduler, make_serve_fns
    cfg = deepseek_config(DS_CPU_AMM, experts=DS_CPU_EXPERTS)
    rt = ModelRuntime.build(cfg)
    card_params = ds_cut_experts(params, DS_CPU_EXPERTS)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (24, 32)]
    state = {"i": 0, "moe": 0, "worst": 0.0, "compared": 0}

    def serve(p, device, fns):
        sched = Scheduler(cfg, rt, p, 2, DS_CPU_LEN, decode_fn=fns[1],
                          prefill_fn=fns[0], continuous=True, kv_codes=True,
                          device=device)
        state["sched"] = sched
        for i, pr in enumerate(prompts):
            sched.submit(Request(rid=i, prompt=pr, max_new=3))
        while sched.step():
            pass
        return sched.stats

    card_rec = MoeRecorder(tr, moe)
    try:
        rec = Recorder(torch, make_serve_fns(cfg, rt, kv_codes=True),
                       keep=True)
        card_stats = serve(card_params, dev, (rec.prefill, rec.decode))
        torch.cuda.synchronize()
    finally:
        card_rec.close()
    t0 = time.perf_counter()
    cpu_params = _to_cpu(card_params)
    copy_s = time.perf_counter() - t0
    n_moe = cfg.n_layers - cfg.first_k_dense
    cpu_moe = [{n: (v[j] if not isinstance(v, dict)
                    else {m: w[j] for m, w in v.items()})
                for n, v in cpu_params["layers"]["moe"].items()}
               for j in range(n_moe)]
    k, u = cfg.top_k, 2.0 ** -24
    ties, tokens, worst_lg, worst_y = 0, 0, 0.0, 0.0
    for i, c in enumerate(card_rec.log):
        p_cpu = cpu_moe[i % n_moe]
        x = c["x"]
        lg, _, idx, _ = moe.moe_route(p_cpu, x, cfg)
        bound = 2 * x.shape[1] ** 0.5 * u * (
            x.double().abs() @ p_cpu["router"].double().abs())
        d_lg = (lg.double() - c["logits"].double()).abs()
        if bool((d_lg > bound).any()):
            fail(f"router logits off the card's by {float(d_lg.max())} "
                 f"beyond twice the f32 summation error's scale")
        worst_lg = max(worst_lg, float((d_lg / bound).max()))
        aff = torch.sort(torch.sigmoid(c["logits"].double()), dim=-1,
                         descending=True).values
        tol_aff = bound.max(dim=-1).values / 4 + 2.0 ** -22
        near = (aff[:, k - 1] - aff[:, k]) <= 2 * tol_aff
        ties += int(near.sum())
        tokens += int(near.numel())
        if not torch.equal(torch.sort(idx[~near], -1).values,
                           torch.sort(c["idx"][~near], -1).values):
            fail("the CPU routed a token away from the card's experts where "
                 "no near-tie explains it")
        disp = moe._dispatch(c["idx"].reshape(-1), k, x.shape[0],
                             cfg.n_experts, c["cap"])
        if not all(torch.equal(a, b) for a, b in zip(disp, c["dispatch"])):
            fail("_dispatch's outputs on the card's decisions differ between "
                 "the CPU and the card")
        y = moe.moe_combine(p_cpu, x, c["vals"], c["idx"], cfg, c["cap"])
        y = y + mlp_apply(p_cpu["shared"], x)
        err = float((y - c["y"]).abs().max())
        scale = float(c["y"].abs().max())
        worst_y = max(worst_y, err / scale)
        if err > DS_LAYER_RTOL * scale:
            fail(f"the MoE layer's output on the CPU is off the card's by "
                 f"{err} (scale {scale}) from the card's input and routing")
    # the CPU serves the same requests, teacher-forced on the card's logits
    cpu_rec = MoeRecorder(tr, moe)
    ledger = RouteLedger(LOGIT_RTOL)
    fns = make_serve_fns(cfg, rt, kv_codes=True)

    def forced(kind, logits, rows, positions):
        """Hold this call's MoE layers to the card's, then its logits (the
        last position of each row) wherever no flip has reached."""
        want_kind, _, _, want = rec.log[state["i"]]
        state["i"] += 1
        if kind != want_kind:
            fail(f"the CPU made a {kind} where the card made a {want_kind}")
        if kind == "prefill":
            ledger.reset(rows[0])
        for j in range(state["moe"], len(cpu_rec.log)):
            ledger.layer(card_rec.log[j]["logits"], cpu_rec.log[j]["logits"],
                         rows, positions, k)
        state["moe"] = len(cpu_rec.log)
        last = np.array([i for i in range(len(rows))
                         if i == len(rows) - 1 or rows[i + 1] != rows[i]])
        ok = torch.from_numpy(ledger.clean(rows[last], positions[last]))
        if bool(ok.any()):
            got, ref = logits.float()[ok], want[ok]
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            state["worst"] = max(state["worst"], err / scale)
            if err > LOGIT_RTOL * scale:
                fail(f"CPU {kind} logits off the card's by {err} (largest "
                     f"{scale}) where no routing flip has reached")
            state["compared"] += int(ok.sum())
        return want

    def prefill(p, t, c):
        logits, c = fns[0](p, t, c)
        slot = next(i for i, r in enumerate(state["sched"].slots)
                    if r is not None and not r.out)
        s = t.shape[1]
        return forced("prefill", logits, np.full(s, slot),
                      np.arange(s)), c

    def decode(p, t, c, q):
        logits, c = fns[1](p, t, c, q)
        b = t.shape[0]
        return forced("decode", logits, np.arange(b),
                      np.broadcast_to(np.asarray(torch.as_tensor(q).cpu()),
                                      (b,))), c
    try:
        t0 = time.perf_counter()
        cpu_stats = serve(cpu_params, "cpu", (prefill, decode))
        cpu_s = time.perf_counter() - t0
    finally:
        cpu_rec.close()
    if cpu_stats != card_stats or state["i"] != len(rec.log) \
            or len(cpu_rec.log) != len(card_rec.log):
        fail(f"the CPU replay made {state['i']} calls of the card's "
             f"{len(rec.log)}; stats {cpu_stats} vs {card_stats}")
    if state["compared"] == 0:
        fail("routing flips left no logits of the CPU replay to compare")
    return {"calls": len(rec.log), "layers": len(card_rec.log),
            "tokens": tokens, "ties": ties, "worst_logits": worst_lg,
            "worst_y": worst_y, "worst": state["worst"],
            "moved": ledger.flips, "replay_tokens": ledger.tokens,
            "flip_gap": max(ledger.gaps, default=0.0),
            "compared": state["compared"], "copy_s": copy_s, "cpu_s": cpu_s}


def ds_expert_timing(torch, dev, cfg, params) -> str:
    """The routed experts of one dropless decode step (8 tokens, capacity
    8, all 256 experts): the three batched products at (E, 8, d) against
    the bound of reading every expert's weights once, and the whole
    ``moe_combine`` (dispatch, products, combine)."""
    from repro_torch.models.moe import moe_combine, moe_route
    p = {k: (v[0] if not isinstance(v, dict) else v)
         for k, v in params["layers"]["moe"].items()}
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    xe = torch.randn((e, DS_SLOTS, d), generator=gen, device=dev)
    h = torch.randn((e, DS_SLOTS, ff), generator=gen, device=dev)

    def products():
        torch.bmm(xe, p["w_gate"])
        torch.bmm(xe, p["w_up"])
        torch.bmm(h, p["w_down"])
    bmm_ms = cuda_ms(torch, products, 5)
    xf = torch.randn((DS_SLOTS, d), generator=gen, device=dev)
    _, gv, gi, _ = moe_route(p, xf, cfg)
    combine_ms = cuda_ms(torch, lambda: moe_combine(p, xf, gv, gi, cfg,
                                                    DS_SLOTS), 5)
    nbytes = 3 * e * d * ff * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return (f"deepseek-v3 routed experts at a decode step (8 tokens, "
            f"capacity 8, {e} experts, dropless): the three f32 torch.bmm "
            f"products {bmm_ms:.3f} ms (CUDA events), reading every expert's "
            f"weights, {nbytes / 1e9:.2f} GB, bound {bound:.3f} ms (bytes; "
            f"bound / time {bound / bmm_ms:.4g}); moe_combine with its "
            f"dispatch and combine {combine_ms:.3f} ms")


def ds_kernel_timing(torch, dev, tb, qm, cfg, rt_noise, params, planes,
                     launches) -> tuple:
    """deepseek-v3's kernels at its new shapes (``kernel_shape_timing``):
    the dense MLP's decode shapes (8, 7168) x (7168, 18432) and (8, 18432)
    x (18432, 7168) on the prefix layer's weights (528 MB each, read from
    device memory), and MLA's decode shapes (8 slots x 128 heads: scores
    (1, 192) x (192, 512), values (1, 512) x (512, 128))."""
    qk_d = cfg.qk_nope_dim + cfg.qk_rope_dim
    return kernel_shape_timing(
        torch, dev, tb, qm, rt_noise, params["dense_prefix"][0]["mlp"],
        planes["dense_prefix"][0]["mlp"],
        (DS_SLOTS * cfg.n_heads, {"qk": (qk_d, DS_LEN),
                                  "pv": (DS_LEN, cfg.v_head_dim)}),
        launches, "deepseek-v3 decode", "MLA decode")


def kernel_shape_timing(torch, dev, tb, qm, rt_noise, mlp, codes, coded,
                        launches, tag: str, coded_tag: str = "") -> tuple:
    """Each kernel of a path at its shapes: ``quant_matmul`` and (with
    ``codes``, the layer's precoded planes) ``bbm_dot_scaled`` at an MLP's
    decode shapes, 8 rows against ``mlp``'s w_gate and w_down as the path
    holds them; with ``coded`` = (slices, {name: (k, n)}),
    ``bbm_dot_coded_batched`` at the attention's decode score and value
    shapes: device ms, plain ms, bound, one f32 PyTorch product of the
    same shapes as a yardstick.  ``launches``: each kernel's count from
    the path's run.  Returns (printed lines, kernel JSON entries)."""
    from repro_torch.kernels.ref import amm_quantize_slices, amm_scale
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    lines, rows = [], {"quant_matmul": [], "bbm_dot_scaled": [],
                       "bbm_dot_coded_batched": []}
    for key in ("w_gate", "w_down"):
        w = mlp[key]
        k, n = w.shape
        x = torch.randn((8, k), generator=gen, device=dev)
        sx, sw = amm_scale(x, 16), amm_scale(w, 16)
        mu, sigma = rt_noise.amm.mu, rt_noise.amm.sigma
        run = lambda: qm.quant_matmul(x, w, sx, sw, mu, sigma,  # noqa: E731
                                      wl=16, seed=7)
        plain = lambda: qm.quant_matmul_plain(  # noqa: E731
            x, w, sx, sw, mu, sigma, wl=16, seed=7, bm=128, bk=512, bn=128)
        ms, how = launch_ms(torch, run, 20, QM_KERNELS)
        plain_ms = cuda_ms(torch, plain, 2)
        lib_ms = cuda_ms(torch, lambda: x @ w, 20)
        got, want = run(), plain()
        tol = qm.quant_matmul_tolerance(x, w, sx, sw, mu, sigma, wl=16,
                                        bk=512)
        err = (got.double() - want.double()).abs()
        if bool((err > tol).any()):
            fail(f"quant_matmul at (8, {k}) x ({k}, {n}) is off its plain "
                 f"version beyond the bound")
        bound, by = qm_bound_ms(8, k, n)
        rows["quant_matmul"].append(dict(
            ms=ms, how=how, plain_ms=plain_ms, bound=bound, by=by,
            lib_ms=lib_ms, err=float(err.max())))
        route = qm.quant_matmul_plan(8, k, n, 512).route
        lines.append(
            f"quant_matmul at (8, {k}) x ({k}, {n}), {route} "
            f"route: {ms:.6f} ms ({how}), plain {plain_ms:.6f} ms, bound "
            f"{bound:.6f} ms ({by}; bound / time {bound / ms:.4g}), f32 "
            f"x @ w yardstick {lib_ms:.6f} ms, max abs error vs plain "
            f"{float(err.max())!r} within quant_matmul_tolerance")
        if codes is None:
            continue
        wc = codes[key]["codes"]
        xc = torch.randint(-32768, 32768, (8, k), generator=gen, device=dev,
                           dtype=torch.int32)
        run = lambda: tb.bbm_dot_scaled(xc, wc, wl=16, vbl=13,  # noqa: E731
                                        kind=0)
        # the plain version over blocks of DS_PLAIN_COLS columns (each
        # column depends on its own weight column alone): one call would
        # hold 17 GB of digit planes beside the 56 GB of weights
        plain = lambda: torch.cat([  # noqa: E731
            tb.bbm_dot_scaled_plain(xc, wc[:, j:j + DS_PLAIN_COLS]
                                    .contiguous(), wl=16, vbl=13, kind=0)
            for j in range(0, n, DS_PLAIN_COLS)], dim=1)
        ms, how = launch_ms(torch, run, 20, TRAIN_KERNELS["bbm_dot_scaled"])
        got = run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max())
        del want
        if err != 0:
            fail(f"bbm_dot_scaled at (8, {k}) x ({k}, {n}) differs from its "
                 f"plain version by {err}")
        xf = xc.float()
        lib_ms = cuda_ms(torch, lambda: xf @ w, 20)
        bound, by = dot_scaled_bound_ms(8, k, n)
        rows["bbm_dot_scaled"].append(dict(
            ms=ms, how=how, plain_ms=plain_ms, bound=bound, by=by,
            lib_ms=lib_ms, err=err))
        lines.append(
            f"bbm_dot_scaled at (8, {k}) x ({k}, {n}), route "
            f"{tb.bbm_dot_route(16, 13, 0)}: {ms:.6f} ms ({how}), plain "
            f"{plain_ms:.3f} ms (host clock, in {DS_PLAIN_COLS}-column "
            f"blocks), bound {bound:.6f} ms "
            f"({by}; bound / time {bound / ms:.4g}), f32 x @ w yardstick "
            f"{lib_ms:.6f} ms; bit-equal to the plain version")
    bt, shapes = coded if coded is not None else (0, {})
    for name, (k, n) in shapes.items():
        a = torch.randn((bt, 1, 1, k), generator=gen, device=dev)
        if name == "pv":
            a = torch.softmax(a * 4, dim=-1)
        b = torch.randn((bt, 1, k, n), generator=gen, device=dev)
        aq, s_a = amm_quantize_slices(a, 16)
        bq, s_b = amm_quantize_slices(b, 16)
        ops = (aq.contiguous(), s_a, bq, s_b[..., None])
        kw = dict(wl=16, vbl=13, kind=0, block=n, per="column")
        run = lambda: tb.bbm_dot_coded_batched(*ops, **kw)  # noqa: E731
        # the plain version over blocks of DS_PLAIN_SLICES slices (one call
        # would hold 13 GB of digit planes)
        plain = lambda: torch.cat([  # noqa: E731
            tb.bbm_dot_coded_batched_plain(
                *(t[j:j + DS_PLAIN_SLICES] for t in ops), **kw)
            for j in range(0, bt, DS_PLAIN_SLICES)])
        ms, how = launch_ms(torch, run, 50, CODED_KERNEL)
        plain_ms = cuda_ms(torch, plain, 1)
        err = float((run() - plain()).abs().max())
        if err != 0:
            fail(f"bbm_dot_coded_batched at {coded_tag} {name} differs from "
                 f"its plain version by {err}")
        af = a.reshape(bt, 1, k)
        bf = b.reshape(bt, k, n)
        lib_ms = cuda_ms(torch, lambda: torch.bmm(af, bf), 50)
        bound, by = dense_coded_bound_ms(bt, 1, k, n)
        route = tb.bbm_coded_route(16, 13, 0, "column", n)
        rows["bbm_dot_coded_batched"].append(dict(
            ms=ms, how=how, plain_ms=plain_ms, bound=bound, by=by,
            lib_ms=lib_ms, err=err))
        lines.append(
            f"bbm_dot_coded_batched at {coded_tag} {name} ({bt} slices of "
            f"(1, {k}) x ({k}, {n}), route {route}): {ms:.6f} ms ({how}), "
            f"plain {plain_ms:.6f} ms (in {DS_PLAIN_SLICES}-slice blocks), "
            f"bound {bound:.6f} ms ({by}; bound / time {bound / ms:.4g}), "
            f"f32 torch.bmm yardstick {lib_ms:.6f} ms; bit-equal to the "
            f"plain version")
    entries = []
    names = {"quant_matmul": (f"quant_matmul ({tag})", QM_SOURCE,
                              REPLACES["quant_matmul"]),
             "bbm_dot_scaled": (f"bbm_dot_scaled ({tag})", MMA_SOURCE,
                                REPLACES["bbm_dot_scaled"]),
             "bbm_dot_coded_batched": (f"bbm_dot_coded_batched ({coded_tag})",
                                       CODED_SOURCE, CODED_REPLACES)}
    for key, (name, source, replaces) in names.items():
        r = rows[key]
        if not r:
            continue
        mean = lambda f: sum(x[f] for x in r) / len(r)  # noqa: E731
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(x["err"] for x in r), "ms": mean("ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound"),
            "bound_by": r[0]["by"], "library_ms": None,
            "matmul_ms": mean("lib_ms"),
            "timed_by": ", ".join(sorted({x["how"] for x in r})),
            "per_shape": [{k2: x[k2] for k2 in ("ms", "bound", "plain_ms",
                                                  "lib_ms")} for x in r]})
    return lines, entries


def ds_window(torch, dev, cfg, rt, params, kv_codes, name, kernels,
              forbid=(), stats=None) -> list:
    """A profiled decode window of ``cfg`` with 8 residents (64-token
    prompts), after 10 warm steps: ``decode_window``'s lines and idle
    share (``forbid``: kernels that must not run there)."""
    from repro_torch.serve import Request, Scheduler
    sched = Scheduler(cfg, rt, params, DS_SLOTS, DS_LEN, continuous=True,
                      kv_codes=kv_codes, device=dev)
    rng = np.random.default_rng(24)
    for i in range(DS_SLOTS):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, 64).tolist(), max_new=40))
    for _ in range(10):
        sched.step()
    lines, idle = decode_window(torch, sched, name, kernels,
                                prefills=DS_SLOTS, forbid=forbid,
                                stats=stats)
    return lines, idle


def deepseek_phase(torch, dev, tb, qm, nm, card: str) -> tuple:
    """Slice 7: deepseek-v3 at full width (2 layers), served in noise
    mode on the fused kernel from the float latent cache and bitexact from
    the latent code cache; returns (printed lines, kernel entries)."""
    import repro_torch.models.common as common
    from repro_torch.models import ModelRuntime, lm_init
    lines = []
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg_n = deepseek_config(DS_NOISE)
    cfg_b = deepseek_config(DS_BITEXACT)
    t0 = time.perf_counter()
    params = lm_init(cfg_n, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(params))
    lines.append(
        f"deepseek-v3 at full width, n_layers 2 (first_k_dense 1, one MoE "
        f"layer), mtp_depth 0: {n_params} parameters, "
        f"{4 * n_params / 1e9:.2f} GB in f32, seeded on the card in "
        f"{time.perf_counter() - t0:.2f} s ({base / 1e9:.2f} GB allocated "
        f"before)")
    counters = {"quant_matmul": qm.quant_matmul,
                "bbm_dot_scaled": tb.bbm_dot_scaled,
                "bbm_dot_coded_batched": tb.bbm_dot_coded_batched,
                "normal_draw": nm.normal_draw}
    per_layer_mlp = 3 * (cfg_n.first_k_dense + (cfg_n.n_layers
                                                - cfg_n.first_k_dense)
                         * min(cfg_n.n_shared_experts, 1))

    # (a) noise mode on the fused kernel, the float latent cache
    rt_n = ModelRuntime.build(cfg_n)
    want_n = {"quant_matmul": per_layer_mlp, "bbm_dot_scaled": 0,
              "bbm_dot_coded_batched": 0, "normal_draw": 0}
    captured = {}
    with KernelCapture(common) as cap:
        res_n = ds_serve(
            torch, dev, cfg_n, rt_n, params, counters, want_n,
            kv_codes=False, first_step=(
                lambda: setattr(cap, "calls", []),
                lambda: captured.__setitem__("qm", cap.take())))
    n_qm, qm_worst, qm_err = qm_capture_check(torch, qm, captured.pop("qm"))
    if n_qm != 2 * per_layer_mlp:
        fail(f"the first step captured {n_qm} quant_matmul calls, expected "
             f"{per_layer_mlp} of a prefill and {per_layer_mlp} of a decode")
    lines.append(ds_serve_line(
        "noise (bbm0 WL 16 VBL 13, the fused kernel, float latent cache)",
        res_n, f"{per_layer_mlp} quant_matmul: 3 for the prefix MLP, 3 for "
        f"the shared expert"))
    lines.append(f"deepseek-v3 noise: the first step's {n_qm} quant_matmul "
                 f"calls within the bound of the plain version (worst "
                 f"error/bound {qm_worst:.3g}, max abs error {qm_err!r})")

    # (b) bitexact from the latent code cache
    rt_b = ModelRuntime.build(cfg_b)
    prefill_counts = {}

    def want_b(kind, tokens):
        s = tokens.shape[1]
        coded = ds_coded_per_call(cfg_b, kind, s, DS_LEN)
        if kind == "prefill":
            prefill_counts[s] = coded
        return {"quant_matmul": 0, "bbm_dot_scaled": per_layer_mlp,
                "bbm_dot_coded_batched": coded, "normal_draw": 0}
    with KernelCapture(common) as cap:
        res_b = ds_serve(
            torch, dev, cfg_b, rt_b, params, counters, want_b, kv_codes=True,
            first_step=(lambda: setattr(cap, "calls", []),
                        lambda: captured.__setitem__("b2", cap.take())))
    n_b2, b2_err = ds_b2_capture_check(torch, tb, captured.pop("b2"),
                                       np.random.default_rng(25))
    lines.append(ds_serve_line(
        "bitexact kv-codes (bbm0 WL 16 VBL 13, apply_to=all, latent code "
        "cache)", res_b,
        f"{per_layer_mlp} bbm_dot_scaled; bbm_dot_coded_batched "
        f"{ds_coded_per_call(cfg_b, 'decode', 1, DS_LEN)} a decode (scores "
        f"and values x 2 layers) and, a prefill, by prompt length "
        f"{dict(sorted(prefill_counts.items()))}"))
    lines.append(f"deepseek-v3 bitexact: the first step's {n_b2} B2 calls "
                 f"(bbm_dot_scaled on {DS_SAMPLE_COLS} sampled columns each, "
                 f"bbm_dot_coded_batched on {DS_SAMPLE_SLICES} sampled "
                 f"slices each) bit-equal to their plain versions "
                 f"(max abs error {b2_err!r})")
    from repro_torch.serve.kv_cache import memory_report
    rep = memory_report(cfg_b, DS_SLOTS, DS_LEN, wl=16)
    lines.append(
        f"deepseek-v3 latent code cache at {DS_SLOTS} slots x {DS_LEN} "
        f"positions, WL 16: codes {rep['code_bytes']} B, scales "
        f"{rep['scale_bytes']} B, bf16 latent cache {rep['bf16_bytes']} B "
        f"(ratio_total {rep['ratio_total']!r})")
    torch.cuda.synchronize()
    lines.append(f"deepseek-v3 peak allocated on the card: "
                 f"{torch.cuda.max_memory_allocated(dev)} B "
                 f"({torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB)")

    # card against the CPU
    chk = ds_cpu_check(torch, dev, params)
    lines.append(
        f"deepseek-v3 card vs CPU ({DS_CPU_EXPERTS} routed experts, bitexact "
        f"attention from the latent code cache, MLPs exact; two requests of "
        f"a prefill and two decode steps each, {chk['calls']} lm_apply "
        f"calls): {chk['layers']} MoE layer calls from the card's input: "
        f"router logits within {chk['worst_logits']:.3g} of twice the f32 "
        f"summation error's scale; {chk['ties']} near-ties in {chk['tokens']} "
        f"tokens; _dispatch's outputs equal; the layer output from the card's "
        f"routing within {chk['worst_y']:.4g} of its largest (tolerance "
        f"{DS_LAYER_RTOL}); the CPU's own teacher-forced run: router "
        f"logits within {LOGIT_RTOL} of the card's on {chk['replay_tokens']} "
        f"tokens, {chk['moved']} routed elsewhere at a near-tie (largest "
        f"affinity gap {chk['flip_gap']:.3g}; the rest of that slot left "
        f"out), the logits "
        f"of {chk['compared']} rows within {chk['worst']:.4g} of the card's "
        f"largest (tolerance {LOGIT_RTOL}); host copy {chk['copy_s']:.1f} "
        f"s, CPU {chk['cpu_s']:.1f} s)")

    # where a decode step's time goes, and the kernels at the new shapes
    lines.append(ds_expert_timing(torch, dev, cfg_b, params))
    win, idle_b = ds_window(torch, dev, cfg_b, rt_b, params, True,
                            "bbm_dot_scaled", TRAIN_KERNELS["bbm_dot_scaled"])
    lines += ["deepseek-v3 bitexact " + line.lstrip() for line in win]
    win, idle_n = ds_window(torch, dev, cfg_n, rt_n, params, False,
                            "quant_matmul", QM_KERNELS)
    lines += ["deepseek-v3 noise " + line.lstrip() for line in win]
    launches = {"quant_matmul": res_n["launches"]["quant_matmul"],
                "bbm_dot_scaled": res_b["launches"]["bbm_dot_scaled"],
                "bbm_dot_coded_batched":
                    res_b["launches"]["bbm_dot_coded_batched"]}
    k_lines, entries = ds_kernel_timing(torch, dev, tb, qm, cfg_b, rt_n,
                                        params, res_b["planes"], launches)
    lines += k_lines
    for e in entries:
        e["idle_share"] = idle_n if e["name"].startswith("quant") else idle_b
    lines.append(f"deepseek-v3 phase on {card}")
    return lines, entries


# -------------- slice 8: mamba2-370m (SSM), zamba2-2.7b (hybrid), chameleon
# the SSM and hybrid traffic: DS_SLOTS slots, max_len DS_LEN, DS_NEW new
# tokens a request; SSM_REQUESTS prompts of DS_PROMPT tokens (one
# ssm_chunk of 128 or less), SSM_LONG of them exactly two chunks, so the
# chunked scan's inter-chunk recurrence runs at full width
SSM_REQUESTS, SSM_LONG = 24, 4
VLM_LAYERS, VLM_REQUESTS = 2, 8
# its CPU replay on one of the two layers: the plain fused kernel on the
# CPU at (8192, 22016) products took most of the phase
VLM_CPU_LAYERS = 1
# the card-against-CPU replays run on depth cuts of the served weights:
# a one-rounding change of the bf16 residual stream moves a random
# 48-54-layer stack's logits by about LOGIT_RTOL on its own (at full
# depth an NVIDIA H100 and the CPU differed by 0.0327 and 0.0323 of the
# largest logit), so each check keeps qwen2's 24 blocks or fewer: mamba2
# 24 of its 48 layers, zamba2 2 of its 9 groups (12 Mamba2 layers and
# 2 shared-block calls)
SSM_CPU_LAYERS, HYBRID_CPU_GROUPS = 24, 2
PORT_KERNELS = QM_KERNELS + TRAIN_KERNELS["bbm_dot_scaled"] + (
    CODED_KERNEL, CODED_TILE_KERNEL, NORMAL_KERNEL)


def ssm_config(name: str, amm: dict, layers=None):
    """``name`` at full width under ``amm``, cut to ``layers`` if given."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import AmmConfig
    cfg = dataclasses.replace(get_arch(name), amm=AmmConfig(**amm))
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def ssm_prompts(cfg, seed: int = 41) -> list:
    """``SSM_REQUESTS`` prompts: of DS_PROMPT tokens, every sixth of
    2 * ssm_chunk tokens (``SSM_LONG`` of them)."""
    rng = np.random.default_rng(seed)
    every = SSM_REQUESTS // SSM_LONG
    lens = [2 * cfg.ssm_chunk if i % every == every - 1
            else int(rng.integers(*DS_PROMPT)) for i in range(SSM_REQUESTS)]
    return [rng.integers(0, cfg.vocab, n).tolist() for n in lens]


def ssd_timing(torch, dev, cfg, busy_ms: float, step_ms: float) -> list:
    """The SSD scan at the served shapes: one ``ssd_decode_step`` at 8
    slots, its device time summed over its kernels (the profiler; the
    state read and written once bounds it) and its time a call between
    CUDA events (the host's launches included), times the Mamba2 layers
    of a decode step, as a share of the profiled window's device-busy
    and wall time per step; one ``ssd_chunked`` of a 2-chunk prompt."""
    from repro_torch.models.mamba2 import ssd_chunked, ssd_decode_step
    h, p, n, g = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_groups
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    b = DS_SLOTS
    a = -torch.exp(rnd(h) * 0.5)
    d = rnd(h)
    state = rnd(b, h, p, n)
    args = (state, rnd(b, h, p), torch.rand((b, h), generator=gen,
                                            device=dev) * 0.1, a,
            rnd(b, h, n), rnd(b, h, n), d)
    ms = kernel_device_ms(torch, lambda: ssd_decode_step(*args), 20, "")
    if ms is None:
        fail("the profiler recorded no device time for ssd_decode_step")
    call_ms = cuda_ms(torch, lambda: ssd_decode_step(*args), 50)
    nbytes = 4 * (2 * b * h * p * n + 2 * b * h * p + b * h + 2 * b * h * n)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    per_step = ms * cfg.n_layers
    lines = [
        f"{cfg.name} SSD decode update (ssd_decode_step, plain PyTorch) at "
        f"{b} slots x {h} heads x ({p}, {n}): {ms:.6f} ms of device time a "
        f"layer (profiler, all its kernels), {call_ms:.6f} ms a call "
        f"(CUDA events, the host's launches included), bound "
        f"{bound:.6f} ms (bytes: the state read and written once, {nbytes} "
        f"B; bound / device time {bound / ms:.4g}); x {cfg.n_layers} "
        f"layers = {per_step:.4f} ms of device time a decode step, "
        f"{per_step / busy_ms:.4f} of the window's device-busy time "
        f"({busy_ms:.4f} ms), {per_step / step_ms:.4f} of its wall time "
        f"({step_ms:.4f} ms)"]
    q = cfg.ssm_chunk
    args = (rnd(1, 2 * q, h, p), torch.rand((1, 2 * q, h), generator=gen,
                                            device=dev) * 0.1, a,
            rnd(1, 2 * q, g, n), rnd(1, 2 * q, g, n), d)
    ms = kernel_device_ms(torch, lambda: ssd_chunked(*args, chunk=q), 10,
                          "") or float("nan")
    call_ms = cuda_ms(torch, lambda: ssd_chunked(*args, chunk=q), 10)
    lines.append(f"{cfg.name} SSD chunked scan (ssd_chunked) of a "
                 f"{2 * q}-token prompt (two chunks of {q}): {ms:.6f} ms of "
                 f"device time a layer (profiler), {call_ms:.6f} ms a call "
                 f"(CUDA events)")
    return lines


def ssm_phase(torch, dev, tb, qm, nm, card: str) -> tuple:
    """Slice 8: mamba2-370m and zamba2-2.7b at full width and full depth,
    served through the continuous Scheduler (zamba2 in noise mode on the
    fused kernel and bitexact with apply_to="all" on the float cache),
    then chameleon-34b at full width cut to ``VLM_LAYERS`` layers; returns
    (printed lines, kernel entries)."""
    import dataclasses
    import gc

    import repro_torch.models.common as common
    from repro_torch.models import ModelRuntime, lm_init
    lines, entries = [], []
    counters = {"quant_matmul": qm.quant_matmul,
                "bbm_dot_scaled": tb.bbm_dot_scaled,
                "bbm_dot_coded_batched": tb.bbm_dot_coded_batched,
                "normal_draw": nm.normal_draw}
    none = {k: 0 for k in counters}
    t_lap = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        lines.append(f"  ({what}: {now - t_lap[0]:.1f} s)")
        t_lap[0] = now

    def init(cfg, what):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = lm_init(cfg, 0, device=dev)
        torch.cuda.synchronize()
        n = sum(v.numel() for v in _leaves(params))
        lines.append(f"{cfg.name} at full width, {what}: {n} parameters, "
                     f"{4 * n / 1e9:.2f} GB in f32, seeded on the card in "
                     f"{time.perf_counter() - t0:.2f} s")
        return params

    def window(cfg, rt, params, name, kernels, forbid=()):
        stats = {}
        win, idle = ds_window(torch, dev, cfg, rt, params, False, name,
                              kernels, forbid=forbid, stats=stats)
        lines.extend(f"{cfg.name} {rt.amm.cfg.mode} " + ln.lstrip()
                     for ln in win)
        return idle, stats

    # (a) mamba2-370m: no amm product, so no kernel of the port runs
    cfg = ssm_config("mamba2-370m", DS_NOISE)
    params = init(cfg, f"all {cfg.n_layers} layers")
    rt = ModelRuntime.build(cfg)
    res = ds_serve(torch, dev, cfg, rt, params, counters, none,
                   kv_codes=False, first_step=None, prompts=ssm_prompts(cfg))
    lines.append(ds_serve_line(
        "noise (bbm0 WL 16 VBL 13, fused; no product is approximated)", res,
        "no launch of any port kernel", arch=cfg.name))
    lines.append(f"{cfg.name} prompt lengths {res['prompt_lens']}; peak "
                 f"allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
                 f" GB")
    lap("mamba2 served")
    idle, st = window(cfg, rt, params, "none", (), forbid=PORT_KERNELS)
    lines += ssd_timing(torch, dev, cfg, st["busy_ms"], st["wall_ms"])
    lap("mamba2 window and SSD timing")
    cut = dataclasses.replace(cfg, n_layers=SSM_CPU_LAYERS)
    chk = lm_cpu_check(torch, dev, cut, rt, first_layers(params,
                                                         SSM_CPU_LAYERS),
                       state_forced=True)
    lines.append(f"{cfg.name} card vs CPU port, cut to {SSM_CPU_LAYERS} "
                 f"layers: {chk['calls']} calls "
                 f"teacher-forced from the card's tokens and caches, logits "
                 f"within {chk['worst']:.4g} of the card's largest "
                 f"(tolerance {LOGIT_RTOL}), "
                 f"{chk['checked']} greedy tokens decided and equal")
    lap("mamba2 card vs CPU")
    del params, res
    gc.collect()

    # (b) zamba2-2.7b, noise on the fused kernel, then bitexact
    cfg_n = ssm_config("zamba2-2.7b", DS_NOISE)
    cfg_b = ssm_config("zamba2-2.7b", DS_BITEXACT)
    groups = cfg_n.n_layers // cfg_n.shared_attn_every
    params = init(cfg_n, f"all {cfg_n.n_layers} layers ({groups} groups of "
                         f"{cfg_n.shared_attn_every} Mamba2 layers, each "
                         f"followed by the one shared attention + MLP block)")
    prompts = ssm_prompts(cfg_n)
    rt_n = ModelRuntime.build(cfg_n)
    want_n = dict(none, quant_matmul=3 * groups)
    captured = {}
    with KernelCapture(common) as cap:
        res_n = ds_serve(
            torch, dev, cfg_n, rt_n, params, counters, want_n,
            kv_codes=False, prompts=prompts,
            first_step=(lambda: setattr(cap, "calls", []),
                        lambda: captured.__setitem__("qm", cap.take())))
    lines.append(ds_serve_line(
        "noise (bbm0 WL 16 VBL 13, the fused kernel)", res_n,
        f"{3 * groups} quant_matmul: the shared block's MLP x {groups} "
        f"groups", arch=cfg_n.name))
    n_qm, qm_worst, qm_err = qm_capture_check(torch, qm, captured.pop("qm"))
    if n_qm != 2 * 3 * groups:
        fail(f"zamba2's first step captured {n_qm} quant_matmul calls")
    lines.append(f"{cfg_n.name} noise: the first step's {n_qm} quant_matmul "
                 f"calls within the bound of the plain version (worst "
                 f"error/bound {qm_worst:.3g}, max abs error {qm_err!r})")
    rt_b = ModelRuntime.build(cfg_b)

    def want_b(kind, tokens):
        s = tokens.shape[1]
        coded = 2 * groups * (-(-s // min(512, s))) * (-(-DS_LEN // min(
            1024, DS_LEN)))
        return dict(none, bbm_dot_scaled=3 * groups,
                    bbm_dot_coded_batched=coded)
    with KernelCapture(common) as cap:
        res_b = ds_serve(
            torch, dev, cfg_b, rt_b, params, counters, want_b,
            kv_codes=False, prompts=prompts,
            first_step=(lambda: setattr(cap, "calls", []),
                        lambda: captured.__setitem__("b2", cap.take())))
    lines.append(ds_serve_line(
        "bitexact (bbm0 WL 16 VBL 13, apply_to=all, float cache)", res_b,
        f"{3 * groups} bbm_dot_scaled and {2 * groups} bbm_dot_coded_batched"
        f" (scores and values x {groups} groups), prefill and decode alike",
        arch=cfg_b.name))
    n_b2, b2_err = ds_b2_capture_check(torch, tb, captured.pop("b2"),
                                       np.random.default_rng(45))
    lines.append(f"{cfg_b.name} bitexact: the first step's {n_b2} B2 calls "
                 f"bit-equal to their plain versions on sampled columns and "
                 f"slices (max abs error {b2_err!r})")
    if [r for r in (res_n, res_b) if r["tokens"] != SSM_REQUESTS * DS_NEW]:
        fail("zamba2 did not generate every token")
    lines.append(f"{cfg_n.name} prompt lengths {res_n['prompt_lens']}; peak "
                 f"allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
                 f" GB")
    lap("zamba2 served twice, first steps checked")
    idle_n, st = window(cfg_n, rt_n, params, "quant_matmul", QM_KERNELS)
    lines += ssd_timing(torch, dev, cfg_n, st["busy_ms"], st["wall_ms"])
    idle_b, _ = window(cfg_b, rt_b, params, "bbm_dot_scaled",
                       TRAIN_KERNELS["bbm_dot_scaled"])
    lap("zamba2 windows and SSD timing")
    cut = dataclasses.replace(cfg_n, n_layers=HYBRID_CPU_GROUPS
                              * cfg_n.shared_attn_every)
    chk = lm_cpu_check(torch, dev, cut, rt_n,
                       first_layers(params, HYBRID_CPU_GROUPS),
                       state_forced=True)
    lines.append(f"{cfg_n.name} noise card vs CPU port, cut to "
                 f"{HYBRID_CPU_GROUPS} groups: {chk['calls']} "
                 f"calls teacher-forced from the card's tokens and caches, "
                 f"logits within {chk['worst']:.4g} of the card's largest "
                 f"(tolerance {LOGIT_RTOL}), "
                 f"{chk['checked']} greedy tokens decided and equal")
    hd = cfg_b.resolved_head_dim
    launches = {"quant_matmul": res_n["launches"]["quant_matmul"],
                "bbm_dot_scaled": res_b["launches"]["bbm_dot_scaled"],
                "bbm_dot_coded_batched":
                    res_b["launches"]["bbm_dot_coded_batched"]}
    k_lines, k_entries = kernel_shape_timing(
        torch, dev, tb, qm, rt_n, params["shared_block"]["mlp"],
        res_b["planes"]["shared_block"]["mlp"],
        (DS_SLOTS * cfg_b.n_heads, {"qk": (hd, DS_LEN), "pv": (DS_LEN, hd)}),
        launches, "zamba2 decode", "zamba2 decode attention")
    lines += k_lines
    lap("zamba2 card vs CPU and kernel timing")
    for e in k_entries:
        e["idle_share"] = idle_n if e["name"].startswith("quant") else idle_b
    entries += k_entries
    del params, res_n, res_b
    gc.collect()

    # (c) chameleon-34b, full width cut to VLM_LAYERS layers, noise fused
    cfg = ssm_config("chameleon-34b", DS_NOISE, layers=VLM_LAYERS)
    params = init(cfg, f"cut to {VLM_LAYERS} of 48 layers")
    rt = ModelRuntime.build(cfg)
    res = ds_serve(torch, dev, cfg, rt, params, counters,
                   dict(none, quant_matmul=3 * VLM_LAYERS), kv_codes=False,
                   first_step=None, prompts=ssm_prompts(cfg)[:VLM_REQUESTS])
    lines.append(ds_serve_line(
        "noise (bbm0 WL 16 VBL 13, the fused kernel, qk_norm)", res,
        f"{3 * VLM_LAYERS} quant_matmul", arch=cfg.name))
    idle, _ = window(cfg, rt, params, "quant_matmul", QM_KERNELS)
    chk = lm_cpu_check(torch, dev, dataclasses.replace(
        cfg, n_layers=VLM_CPU_LAYERS), rt, first_layers(params,
                                                        VLM_CPU_LAYERS))
    lines.append(f"{cfg.name} card vs CPU port (cut to {VLM_CPU_LAYERS} "
                 f"layer): {chk['calls']} calls "
                 f"teacher-forced, logits within {chk['worst']:.4g} of the "
                 f"card's largest (tolerance {LOGIT_RTOL}), "
                 f"{chk['checked']} greedy tokens decided and equal")
    k_lines, k_entries = kernel_shape_timing(
        torch, dev, tb, qm, rt,
        {k: v[0] for k, v in params["layers"]["mlp"].items()}, None, None,
        {"quant_matmul": res["launches"]["quant_matmul"]},
        "chameleon decode")
    lines += k_lines
    lap("chameleon")
    for e in k_entries:
        e["idle_share"] = idle
    entries += k_entries
    del params, res
    gc.collect()
    lines.append(f"slice 8 phase on {card}")
    return lines, entries


# ------------------------------------------------------------- slice 9
# whisper-base served: a static batch of 8 prompts of 16 tokens, 32 new
# tokens each, through make_serve_fns (the Scheduler cannot serve an
# encoder-decoder model), max_len 448 (Whisper's text context), seeded
# normal frame embeddings (8, 1500, 512) passed to every call
WH_BATCH, WH_PROMPT, WH_NEW, WH_LEN = 8, 16, 32, 448
# the card against the CPU: two sequences, a prefill and 2 decodes, in
# exact mode (the plain versions of the fused kernel and of B2 on the CPU
# would take minutes at the encoder's 3,000 rows; the first call's
# kernel checks hold the kernels)
WH_CPU_SEQS, WH_CPU_DECODES = 2, 2
# training through launch.train: batch 4 x seq 256, TRAIN_STEPS steps
WH_TRAIN_BATCH, WH_TRAIN_SEQ = 4, 256
WH_T1 = ["--arch", "whisper-base", "--amm", "bitexact", "--mul", "bbm0",
         "--wl", "16", "--vbl", "13", "--amm-attn", "--flash-attn"]
WH_T2 = ["--arch", "whisper-base", "--amm", "off", "--flash-attn"]
# the training check against the CPU: 2 encoder + 2 decoder layers at
# full width, one sequence of WH_TRAIN_SEQ tokens, T2's settings (for the
# same reason as the serving check)
WH_CPU_LAYERS = 2
# the first call's batched coded calls held against the plain version on
# this many sampled slices each, its bbm_dot_scaled calls on this many
# sampled columns (both plain versions on the card: 512 x 1,024 slices
# take seconds each on the CPU)
WH_SAMPLE_SLICES, WH_SAMPLE_COLS = 4, 256
# the flash kernels' gradients against float64 attention (f32 sums of
# up to 1,500 terms err by about 1e-5 of the largest gradient)
WH_FLASH_GRAD_RTOL = 2.0 ** -12
WH_MODES = {"noise": DS_NOISE,
            "noise plain": dict(DS_NOISE, use_pallas=False),
            "bitexact": DS_BITEXACT}


def whisper_config(amm: dict, layers=None):
    """whisper-base at full width (d_model 512, 8 heads x 64, d_ff 2048,
    vocab 51,865, encoder_len 1,500) under ``amm``, its 6 encoder and 6
    decoder layers each cut to ``layers`` if given."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import AmmConfig
    cfg = dataclasses.replace(get_arch("whisper-base"), amm=AmmConfig(**amm))
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=layers)


def wh_blocks(sq: int, skv: int) -> int:
    """(q block, KV block) pairs of ``chunked_attention`` at its default
    tiles: bq = min(512, Sq), bk = min(1024, Skv)."""
    return -(-sq // min(512, sq)) * -(-skv // min(1024, skv))


def wh_coded_per_call(cfg, s: int, max_len: int) -> int:
    """``bbm_dot_coded_batched`` launches of one ``lm_apply`` call with
    every attention product on the amm datapath (apply_to="all", float
    cache), two (scores, values) for each block pair: the encoder's
    self-attention over ``encoder_len`` positions in the chunked
    schedule; the decoder's self-attention, a decode's
    ``decode_attention`` (one pair) or a prefill of ``s`` tokens in the
    chunked schedule against the ``max_len`` cache; its cross-attention,
    ``s`` queries against ``encoder_len`` keys in the chunked schedule."""
    e = cfg.encoder_len
    self_pairs = 1 if s == 1 else wh_blocks(s, max_len)
    return 2 * (cfg.n_encoder_layers * wh_blocks(e, e)
                + cfg.n_layers * (self_pairs + wh_blocks(s, e)))


def wh_want(cfg, mode: str, counters):
    """The launches every ``lm_apply`` call of ``mode`` makes, as a
    function of the call's token count: noise 3 ``quant_matmul`` per
    layer (encoder and decoder), its plain branch 3 ``normal_draw``,
    bitexact 3 ``bbm_dot_scaled`` and ``wh_coded_per_call``."""
    mlp = 3 * (cfg.n_encoder_layers + cfg.n_layers)
    none = {k: 0 for k in counters}

    def want(s: int) -> dict:
        if mode == "noise":
            return dict(none, quant_matmul=mlp)
        if mode == "noise plain":
            return dict(none, normal_draw=mlp)
        return dict(none, bbm_dot_scaled=mlp,
                    bbm_dot_coded_batched=wh_coded_per_call(cfg, s, WH_LEN))
    return want


class StaticBatch:
    """A static batch served through ``make_serve_fns``: ``prefill()``
    writes the prompts at position 0, each ``step()`` decodes one token
    for every sequence at their common position (greedy, from the last
    call's logits, or the given tokens), the frame embeddings passed to
    every call.  ``stats`` counts the calls as the Scheduler's do (for
    ``decode_window``).  ``want``: a function of a call's token count
    giving each counted wrapper's launches, held at every call; ``log``:
    keep each call's (kind, tokens, logits) on the CPU."""

    def __init__(self, torch, cfg, rt, params, enc, prompts, *,
                 counters=None, want=None, log=False):
        from repro_torch.models import init_cache
        from repro_torch.serve import make_serve_fns
        self.torch, self.params, self.enc = torch, params, enc
        self.prefill_fn, self.decode_fn = make_serve_fns(
            cfg, rt, amm_planes=rt.build_planes(cfg, params))
        dev = params["embed"].device
        self.caches = init_cache(cfg, len(prompts), WH_LEN, device=dev)
        self.prompt = torch.as_tensor(np.asarray(prompts), device=dev)
        self.counters, self.want = counters or {}, want
        self.last = {n: f.launches for n, f in self.counters.items()}
        self.stats = {"steps": 0, "prefills": 0}
        self.log = [] if log else None
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.out, self.pos, self.next = [], 0, None

    def _note(self, kind, tokens, logits):
        self.bad += (~self.torch.isfinite(logits)).sum()
        if self.log is not None:
            self.log.append((kind, tokens.cpu(), logits.float().cpu()))
        if self.want is not None:
            now = {n: f.launches for n, f in self.counters.items()}
            got = {n: now[n] - self.last[n] for n in now}
            self.last = now
            want = self.want(tokens.shape[1])
            if got != want:
                fail(f"a whisper {kind} call of {tokens.shape[1]} tokens "
                     f"launched {got}, expected {want}")
        self.next = self.torch.argmax(logits, dim=-1)[:, None]
        self.out.append(self.next)
        return logits

    def prefill(self):
        logits, self.caches = self.prefill_fn(self.params, self.prompt,
                                              self.caches, self.enc)
        self.pos = self.prompt.shape[1]
        self.stats["prefills"] += 1
        return self._note("prefill", self.prompt, logits)

    def step(self, tokens=None):
        tokens = self.next if tokens is None else tokens
        logits, self.caches = self.decode_fn(self.params, tokens,
                                             self.caches, self.pos, self.enc)
        self.pos += 1
        self.stats["steps"] += 1
        return self._note("decode", tokens, logits)


class NormalCapture:
    """While ``on``, every ``normal_draw`` call ``models.common`` makes
    keeps its key, shape, keywords, a copy of its accumulator taken
    before the call, and its output; ``check()`` holds each against the
    plain version on the card, bit for bit.  ``close()`` (or leaving a
    ``with`` block) restores the name."""

    def __init__(self, common):
        self.common, self.calls, self.on = common, [], False
        self.orig = common.normal_draw
        common.normal_draw = self._call

    def _call(self, k, shape, **kw):
        if not self.on:
            return self.orig(k, shape, **kw)
        acc = kw.get("acc")
        before = None if acc is None else acc.clone()
        out = self.orig(k, shape, **kw)
        self.calls.append((k, tuple(shape), before, kw, out))
        return out

    def check(self, torch, prng) -> tuple:
        """(calls checked, max abs error); fails on any differing bit."""
        worst = 0.0
        for k, shape, acc, kw, out in self.calls:
            want = prng.normal_plain(
                k, shape, acc=acc, c1=kw.get("c1", 0.0),
                c2=kw.get("c2", 0.0), order=kw.get("order", "acc"))
            if not torch.equal(out.view(torch.int32),
                               want.to(out.device).view(torch.int32)):
                fail(f"a first-call normal_draw at {shape} differs from its "
                     f"plain version")
            worst = max(worst, float((out.double() - want.double())
                                     .abs().max()))
        return len(self.calls), worst

    def close(self):
        self.common.normal_draw = self.orig

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wh_serve(torch, cfg, rt, params, enc, prompts, counters, want, *,
             capture=None) -> dict:
    """Serve ``prompts`` as one static batch: a prefill, then ``WH_NEW - 1``
    decode steps (``WH_NEW`` new tokens each), every call's launches held
    to ``want`` (the counts zeroed just before).  ``capture``: a pair of
    functions called just before and just after the prefill (the kernel
    captures)."""
    for f in counters.values():
        f.launches = 0
    sb = StaticBatch(torch, cfg, rt, params, enc, prompts,
                     counters=counters, want=want)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if capture is not None:
        capture[0]()
    sb.prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if capture is not None:
        capture[1]()
    steps = []
    for _ in range(WH_NEW - 1):
        ts = time.perf_counter()
        sb.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    if int(sb.bad):
        fail(f"{int(sb.bad)} non-finite logits serving {cfg.name}")
    new = torch.cat(sb.out, dim=1)
    if tuple(new.shape) != (len(prompts), WH_NEW):
        fail(f"whisper generated {tuple(new.shape)} tokens")
    return {"step_ms": sorted(steps), "prefill_ms": prefill_ms,
            "wall_s": wall, "tokens": new.numel(), "calls": 1 + len(steps),
            "launches": {n: f.launches for n, f in counters.items()},
            "batch": sb}


def wh_encoder_ms(torch, cfg, rt, params, enc, reps: int = 5) -> float:
    """Median wall ms of the encoder alone (``_encoder``: the 6 layers
    over the 8 x 1,500 frames and the final norm), as every decode step
    recomputes it (ROADMAP C15)."""
    from repro_torch.models.transformer import _encoder
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _encoder(params["encoder"], enc, cfg, rt, 0, enc.shape[0],
                 torch.bfloat16)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[reps // 2]


def wh_cpu_serve_check(torch, params, enc, prompts) -> dict:
    """Two sequences served on the card in exact mode, then on the CPU
    port teacher-forced on the card's tokens: every call's logits within
    ``LOGIT_RTOL`` of the card's largest."""
    from repro_torch.models import ModelRuntime
    cfg = whisper_config(dict(mode="off"))
    rt = ModelRuntime.build(cfg)
    n = WH_CPU_SEQS
    card = StaticBatch(torch, cfg, rt, params, enc[:n], prompts[:n], log=True)
    card.prefill()
    for _ in range(WH_CPU_DECODES):
        card.step()
    t0 = time.perf_counter()
    cpu = StaticBatch(torch, cfg, rt, _to_cpu(params), enc[:n].cpu(),
                      prompts[:n])
    worst = 0.0
    for kind, tokens, want in card.log:
        got = cpu.prefill() if kind == "prefill" else cpu.step(tokens)
        err = float((got.float() - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if err > LOGIT_RTOL * scale:
            fail(f"whisper's CPU logits off the card's by {err} (scale "
                 f"{scale}) at a {kind} call")
    if int(cpu.bad):
        fail("non-finite logits in whisper's CPU replay")
    return {"calls": len(card.log), "worst": worst,
            "cpu_s": time.perf_counter() - t0}


def wh_train_step(torch, dev, counters) -> dict:
    """One step of ``make_train_step`` (T1's settings: bitexact with
    apply_to="all" and the flash kernels) on seeded frame embeddings, so
    that the encoder's kernels see live data; the launches of the step."""
    from repro_torch.core import prng
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models import ModelRuntime, lm_init
    from repro_torch.train.optimizer import OptConfig, init_opt
    from repro_torch.train.trainstep import TrainConfig, make_train_step
    cfg = whisper_config(DS_BITEXACT)
    rt = ModelRuntime.build(cfg, use_pallas=True)
    params = lm_init(cfg, 2, device=dev)
    tc = TrainConfig(opt=OptConfig(total_steps=1))
    opt = init_opt(params, tc.opt)
    toks, labels = global_batch(DataConfig(
        vocab=cfg.vocab, seq_len=WH_TRAIN_SEQ, global_batch=WH_TRAIN_BATCH),
        0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(91)
    enc = torch.randn((WH_TRAIN_BATCH, cfg.encoder_len, cfg.d_model),
                      generator=gen, device=dev)
    step = make_train_step(cfg, rt, tc)
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, metrics = step(params, opt, torch.from_numpy(toks).to(dev),
                         torch.from_numpy(labels).to(dev), prng.key(42),
                         encoder_embeds=enc)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    return {"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {n: f.launches for n, f in counters.items()}}


def wh_train_cpu_check(torch, dev) -> dict:
    """A 2 + 2 layer cut of whisper-base at full width, one sequence of
    ``WH_TRAIN_SEQ`` tokens and seeded frame embeddings, T2's settings (amm
    off, the flash kernels): the card's loss and gradients against the
    CPU port's."""
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models import ModelRuntime, lm_init
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainstep import loss_and_grads
    cfg = whisper_config(dict(mode="off"), layers=WH_CPU_LAYERS)
    rt = ModelRuntime.build(cfg, use_pallas=True)
    params = lm_init(cfg, 3, device=dev)
    toks, labels = global_batch(DataConfig(
        vocab=cfg.vocab, seq_len=WH_TRAIN_SEQ, global_batch=1), 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(92)
    enc = torch.randn((1, cfg.encoder_len, cfg.d_model), generator=gen,
                      device=dev)
    card, card_g, _ = loss_and_grads(
        params, cfg, rt, torch.from_numpy(toks).to(dev),
        torch.from_numpy(labels).to(dev), None, encoder_embeds=enc)
    card = float(card)
    t0 = time.perf_counter()
    cpu, cpu_g, _ = loss_and_grads(
        _to_cpu(params), cfg, rt, torch.from_numpy(toks),
        torch.from_numpy(labels), None, encoder_embeds=enc.cpu())
    cpu = float(cpu)
    cpu_s = time.perf_counter() - t0
    if not (np.isfinite(card) and abs(card - cpu) <= TRAIN_LOSS_RTOL
            * abs(cpu)):
        fail(f"whisper's loss on the card {card!r} is off the CPU port's "
             f"{cpu!r}")
    worst = 0.0
    for g, w in zip(tree_leaves(card_g), tree_leaves(cpu_g)):
        ratio = float((g.cpu().double() - w.double()).abs().max()
                      / w.double().abs().max().clamp_min(1e-30))
        if not ratio <= TRAIN_GRAD_RTOL:
            fail(f"a whisper gradient leaf {tuple(w.shape)} on the card is "
                 f"off the CPU port's by {ratio} of its largest element")
        worst = max(worst, ratio)
    return {"card": card, "cpu": cpu, "cpu_s": cpu_s, "grad_worst": worst}


def wh_flash_operands(torch, gen, dev, cfg, sq: int, skv: int,
                      zero_kv=False):
    """(B, H, S, D) operands of whisper's attention at training batch."""
    h, d = cfg.n_heads, cfg.resolved_head_dim
    q = torch.randn((WH_TRAIN_BATCH, h, sq, d), generator=gen, device=dev)
    k, v = (torch.randn((WH_TRAIN_BATCH, h, skv, d), generator=gen,
                        device=dev) for _ in range(2))
    if zero_kv:
        k.zero_()
        v.zero_()
    return q, k, v


def wh_flash_cases(cfg) -> tuple:
    """whisper's attention shapes, (name, Sq, Skv, causal, all-zero K and
    V): the encoder's self-attention, the training cross-attention, a
    decode step's cross-attention (one query against the frames), and the
    launcher's zero embeddings (K and V all 0: every amm tile at the
    quantizer's floor scale)."""
    e = cfg.encoder_len
    return (("encoder self-attention", e, e, True, False),
            ("cross-attention", WH_TRAIN_SEQ, e, False, False),
            ("decode cross-attention", 1, e, False, False),
            ("zero K and V", WH_TRAIN_SEQ, e, False, True),
            ("zero K and V, encoder", e, e, True, True))


def wh_flash_checks(torch, tf, attn, dev, cfg, amm) -> list:
    """Both flash kernels against their plain versions at whisper's
    shapes (``wh_flash_cases``): the exact one within ``flash_tolerance``, the
    amm one by ``flash_amm_compare`` (both kinds); then the gradients: the
    exact kernel's (its plain backward) within ``WH_FLASH_GRAD_RTOL`` of
    float64 attention's, and the amm kernel's straight-through gradient
    from the kernel's residuals against the same from its plain
    version's, within the same bound."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(93)
    lines = []
    for name, sq, skv, causal, zero in wh_flash_cases(cfg):
        q, k, v = wh_flash_operands(torch, gen, dev, cfg, sq, skv, zero)
        what = f"at whisper's {name} {tuple(q.shape)} x {skv} keys"
        ratio = flash_exact_check(torch, tf, q, k, v, causal=causal,
                                  what=what)
        if ratio != ratio:
            # K and V all 0: the bound is 0 and every error was 0 (a
            # nonzero one would have failed the check), so 0/0 reads 0
            ratio = 0.0
        reps = [flash_amm_check(torch, tf, q, k, v, kind=kind,
                                causal=causal, what=what)
                for kind in (0, 1)]
        g = torch.randn(q.shape, generator=gen, device=dev)
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        got = torch.autograd.grad(attn._FlashExact.apply(qd, kd, vd, causal),
                                  (qd, kd, vd), g)
        q64, k64, v64 = (t.detach().double().requires_grad_()
                         for t in (q, k, v))
        ref = torch.nn.functional.scaled_dot_product_attention(
            q64, k64, v64, is_causal=causal)
        want = torch.autograd.grad(ref, (q64, k64, v64), g.double())
        e_ratio = max(float((a.double() - b).abs().max()
                            / b.abs().max().clamp_min(1e-30))
                      for a, b in zip(got, want) if bool(b.any()))
        if not e_ratio <= WH_FLASH_GRAD_RTOL:
            fail(f"flash_attention's gradient {what} is off float64 "
                 f"attention's by {e_ratio} of its largest element")
        got = torch.autograd.grad(attn._flash_amm_ste(amm, causal, qd, kd,
                                                      vd), (qd, kd, vd), g)
        kernel = attn.flash_attention_amm

        def plain(q_, k_, v_, *, wl, vbl, kind, causal, residuals):
            ops = tf.flash_amm_operands(q_, k_, v_, wl=wl)
            out, res = tf.flash_amm_plain(ops, wl=wl, vbl=vbl, kind=kind,
                                          causal=causal, residuals=True)
            b, h, s_len, d = ops["shape"]
            return out[:, :s_len].reshape(b, h, s_len, d), res
        attn.flash_attention_amm = plain
        try:
            want = torch.autograd.grad(attn._flash_amm_ste(
                amm, causal, qd, kd, vd), (qd, kd, vd), g)
        finally:
            attn.flash_attention_amm = kernel
        a_ratio = max(float((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-30))
                      for a, b in zip(got, want) if bool(b.any()))
        if not a_ratio <= WH_FLASH_GRAD_RTOL:
            fail(f"flash_attention_amm's gradient {what} from the kernel's "
                 f"residuals is off the plain version's by {a_ratio}")
        lines.append(
            f"whisper flash check, {name} ({tuple(q.shape)} x {skv} keys, "
            f"causal={causal}): flash_attention within its bound (worst "
            f"error/bound {ratio:.3g}), its gradient within {e_ratio:.3g} of "
            f"float64 attention's largest element; flash_attention_amm by "
            f"flash_amm_compare at kinds 0 and 1 (worst ratio "
            f"{max(r['worst_ratio'] for r in reps):.3g}, "
            f"{sum(r['codes_moved'] for r in reps)} of "
            f"{sum(r['codes'] for r in reps)} P codes moved), its "
            f"straight-through gradient within {a_ratio:.3g} of the plain "
            f"version's (tolerance {WH_FLASH_GRAD_RTOL})")
        del q, k, v, qd, kd, vd, q64, k64, v64, got, want, g
    return lines


def wh_kernel_timing(torch, dev, tb, tf, qm, nm, prng, cfg, rt_noise,
                     rt_bx, params, launches) -> tuple:
    """Each kernel at whisper's new shapes: ``quant_matmul`` and
    ``bbm_dot_scaled`` at the encoder's MLP products (8 x 1,500 = 12,000
    rows against the first encoder layer's w_gate and w_down),
    ``normal_draw`` with its epilogue at the encoder's widest product,
    ``bbm_dot_coded_batched`` at the encoder's chunked pair (64 slices of
    (512, 64) x (64, 1024) and (512, 1024) x (1024, 64)), both flash
    kernels at the encoder's self-attention and the training
    cross-attention: device ms, plain ms, bound and one PyTorch call
    (the same function for the exact flash kernel:
    ``scaled_dot_product_attention``; a yardstick otherwise).  Returns
    (printed lines, kernel JSON entries)."""
    from repro_torch.kernels.ref import amm_scale
    gen = torch.Generator(device=dev)
    gen.manual_seed(94)
    rows = WH_BATCH * cfg.encoder_len
    mlp = {k: v[0] for k, v in params["encoder"]["layers"]["mlp"].items()}
    lines, entries = [], []

    def entry(name, source, replaces, n, err, ms, plain_ms, bound, by,
              lib_ms, how, **extra):
        entries.append(dict({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms, "timed_by": how}, **extra))

    qm_rows, b2_rows = [], []
    for key in ("w_gate", "w_down"):
        w = mlp[key]
        k, n = w.shape
        x = torch.randn((rows, k), generator=gen, device=dev)
        sx, sw = amm_scale(x, 16), amm_scale(w, 16)
        mu, sigma = rt_noise.amm.mu, rt_noise.amm.sigma
        run = lambda: qm.quant_matmul(x, w, sx, sw, mu, sigma,  # noqa: E731
                                      wl=16, seed=7)
        plain = lambda: qm.quant_matmul_plain(  # noqa: E731
            x, w, sx, sw, mu, sigma, wl=16, seed=7, bm=128, bk=512, bn=128)
        ms, how = launch_ms(torch, run, 20, QM_KERNELS)
        plain_ms = cuda_ms(torch, plain, 2)
        lib_ms = cuda_ms(torch, lambda: x @ w, 20)
        tol = qm.quant_matmul_tolerance(x, w, sx, sw, mu, sigma, wl=16,
                                        bk=512)
        err = (run().double() - plain().double()).abs()
        if bool((err > tol).any()):
            fail(f"quant_matmul at ({rows}, {k}) x ({k}, {n}) is off its "
                 f"plain version beyond the bound")
        bound, by = qm_bound_ms(rows, k, n)
        route = qm.quant_matmul_plan(rows, k, n, 512).route
        qm_rows.append(dict(ms=ms, plain_ms=plain_ms, bound=bound, by=by,
                            lib_ms=lib_ms, err=float(err.max()), how=how))
        lines.append(f"quant_matmul at whisper's encoder ({rows}, {k}) x "
                     f"({k}, {n}), {route} route: {ms:.6f} ms ({how}), plain "
                     f"{plain_ms:.6f} ms, bound {bound:.6f} ms ({by}; bound "
                     f"/ time {bound / ms:.4g}), f32 x @ w yardstick "
                     f"{lib_ms:.6f} ms, within quant_matmul_tolerance")
        wc = rt_bx.amm.precode(w)["codes"]
        xc = torch.randint(-32768, 32768, (rows, k), generator=gen,
                           device=dev, dtype=torch.int32)
        run = lambda: tb.bbm_dot_scaled(xc, wc, wl=16, vbl=13,  # noqa: E731
                                        kind=0)
        ms, how = launch_ms(torch, run, 20, TRAIN_KERNELS["bbm_dot_scaled"])
        got = run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = torch.cat([tb.bbm_dot_scaled_plain(
            xc, wc[:, j:j + DS_PLAIN_COLS].contiguous(), wl=16, vbl=13,
            kind=0) for j in range(0, n, DS_PLAIN_COLS)], dim=1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max())
        del want
        if err != 0:
            fail(f"bbm_dot_scaled at ({rows}, {k}) x ({k}, {n}) differs from "
                 f"its plain version by {err}")
        xf = xc.float()
        lib_ms = cuda_ms(torch, lambda: xf @ w, 20)
        bound, by = dot_scaled_bound_ms(rows, k, n)
        b2_rows.append(dict(ms=ms, plain_ms=plain_ms, bound=bound, by=by,
                            lib_ms=lib_ms, err=err, how=how))
        lines.append(f"bbm_dot_scaled at whisper's encoder ({rows}, {k}) x "
                     f"({k}, {n}), route {tb.bbm_dot_route(16, 13, 0)}: "
                     f"{ms:.6f} ms ({how}), plain {plain_ms:.3f} ms (host "
                     f"clock, in {DS_PLAIN_COLS}-column blocks), bound "
                     f"{bound:.6f} ms ({by}; bound / time {bound / ms:.4g}), "
                     f"f32 x @ w yardstick {lib_ms:.6f} ms; bit-equal")
    for name, r, src, rep, n in (
            ("quant_matmul", qm_rows, QM_SOURCE, REPLACES["quant_matmul"],
             launches["quant_matmul"]),
            ("bbm_dot_scaled", b2_rows, MMA_SOURCE,
             REPLACES["bbm_dot_scaled"], launches["bbm_dot_scaled"])):
        mean = lambda f: sum(x[f] for x in r) / len(r)  # noqa: E731
        entry(f"{name} (whisper encoder)", src, rep, n,
              max(x["err"] for x in r), mean("ms"), mean("plain_ms"),
              mean("bound"), r[0]["by"], None,
              ", ".join(sorted({x["how"] for x in r})),
              matmul_ms=mean("lib_ms"))
    # normal_draw with its epilogue at the encoder's widest product
    shape = (WH_BATCH, cfg.encoder_len, cfg.d_ff)
    k = prng.layer_keys(0, cfg.n_layers)[0]
    c1, c2 = nm.noise_consts(rt_noise.amm.mu, rt_noise.amm.sigma,
                             cfg.d_model)
    acc = torch.randn(shape, generator=gen, device=dev)
    ms, how = launch_ms(torch, lambda: nm.normal_draw(
        k, shape, acc=acc, c1=c1, c2=c2), 20, NORMAL_KERNEL)
    plain_ms = cuda_ms(torch, lambda: prng.normal_plain(
        k, shape, acc=acc, c1=c1, c2=c2), 3)
    got = nm.normal_draw(k, shape, acc=acc.clone(), c1=c1, c2=c2)
    want = prng.normal_plain(k, shape, acc=acc, c1=c1, c2=c2)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"normal_draw at {shape} differs from its plain version")
    randn_ms, randn_how = launch_ms(torch, lambda: torch.randn(
        shape, device=dev), 20, ("distribution", "normal_kernel"))
    bound, by = normal_bound_ms(prng, k, shape, True)
    entry("normal_draw (whisper encoder)", NORMAL_SOURCE, NORMAL_REPLACES,
          launches["normal_draw"], 0.0, ms, plain_ms, bound, by, None, how,
          randn_ms=randn_ms)
    lines.append(f"normal_draw with its epilogue at whisper's encoder "
                 f"{shape}: {ms:.6f} ms ({how}), plain {plain_ms:.6f} ms, "
                 f"bound {bound:.6f} ms ({by}; bound / time "
                 f"{bound / ms:.4g}), torch.randn {randn_ms:.6f} ms "
                 f"({randn_how}; not the same function); bit-equal")
    del acc, got, want
    # the batched coded entry at the encoder's chunked pair
    rng = np.random.default_rng(95)
    bt = WH_BATCH * cfg.n_kv_heads
    e = cfg.encoder_len
    coded = []
    for name, (a, s_a, b, s_b, per) in prefill_operands(
            torch, rng, dev, bt=bt, m=min(512, e), skv=min(1024, e),
            d=cfg.resolved_head_dim).items():
        kw = dict(wl=16, vbl=13, kind=0, per=per, block=b.shape[-1])
        run = lambda: tb.bbm_dot_coded_batched(  # noqa: E731
            a, s_a, b, s_b, **kw)
        ms, how = launch_ms(torch, run, 20, CODED_KERNEL)
        plain_ms = cuda_ms(torch, lambda: tb.bbm_dot_coded_batched_plain(
            a, s_a, b, s_b, **kw), 2)
        err = float((run() - tb.bbm_dot_coded_batched_plain(
            a, s_a, b, s_b, **kw)).abs().max())
        if err != 0:
            fail(f"bbm_dot_coded_batched at whisper's encoder {name} "
                 f"differs from its plain version by {err}")
        m_, k_ = a.shape[2:]
        n_ = b.shape[-1]
        af = a.reshape(bt, m_, k_).float()
        bf = b.reshape(bt, k_, n_).float().contiguous()
        bmm_ms = cuda_ms(torch, lambda: torch.bmm(af, bf), 20)
        bound, by = dense_coded_bound_ms(bt, m_, k_, n_)
        coded.append(dict(ms=ms, plain_ms=plain_ms, bound=bound, by=by,
                          lib_ms=bmm_ms, err=err, how=how))
        lines.append(f"bbm_dot_coded_batched at whisper's encoder {name} "
                     f"({bt} slices of ({m_}, {k_}) x ({k_}, {n_}), route "
                     f"{tb.bbm_coded_route(16, 13, 0, per, n_)}): {ms:.6f} "
                     f"ms ({how}), plain {plain_ms:.6f} ms, bound "
                     f"{bound:.6f} ms ({by}; bound / time {bound / ms:.4g}), "
                     f"f32 torch.bmm yardstick {bmm_ms:.6f} ms; bit-equal")
    mean = lambda f: sum(x[f] for x in coded) / len(coded)  # noqa: E731
    entry("bbm_dot_coded_batched (whisper encoder)", CODED_SOURCE,
          CODED_REPLACES, launches["bbm_dot_coded_batched"],
          max(x["err"] for x in coded), mean("ms"), mean("plain_ms"),
          mean("bound"), coded[0]["by"], None,
          ", ".join(sorted({x["how"] for x in coded})), bmm_ms=mean("lib_ms"))
    # both flash kernels at the encoder's and the cross-attention's shapes
    for name, sq, skv, causal, _ in wh_flash_cases(cfg)[:2]:
        q, k_, v = wh_flash_operands(torch, gen, dev, cfg, sq, skv)
        for kern in ("flash_attention", "flash_attention_amm"):
            r = flash_kernel_timing(torch, tf, kern, q, k_, v, causal,
                                    f"at whisper's {name}")
            if causal:      # the cross shape is a check: no main-path launch
                entry(f"{kern} (whisper {name})", TRAIN_SOURCES[kern],
                      REPLACES[kern], launches[kern], r["err"], r["ms"],
                      r["plain_ms"], r["bound"], r["by"], r["lib_ms"],
                      r["how"])
            lines.append(
                f"{kern} at whisper's {name} ({tuple(q.shape)} x {skv} keys, "
                f"causal={causal}): {r['ms']:.6f} ms ({r['how']}), plain "
                f"{r['plain_ms']:.6f} ms, bound {r['bound']:.6f} ms "
                f"({r['by']}; bound / time {r['bound'] / r['ms']:.4g}), max "
                f"abs error {r['err']!r}"
                + ("" if r["lib_ms"] is None else
                   f", scaled_dot_product_attention {r['lib_ms']:.6f} ms"))
        del q, k_, v
    return lines, entries


def whisper_phase(torch, dev, tb, tf, qm, nm, card: str) -> tuple:
    """Slice 9: whisper-base at full width and depth served through
    ``make_serve_fns`` (noise on the fused kernel, noise on the plain
    branch, bitexact with apply_to="all" on the float cache) and trained
    through ``launch.train`` (T1's and T2's settings on the launcher's
    zero embeddings, then one step on seeded embeddings); the card
    against the CPU; the flash kernels at whisper's shapes; the kernels
    at the new shapes.  Returns (printed lines, kernel entries)."""
    import repro_torch.models.attention as attn
    import repro_torch.models.common as common
    from repro_torch.core import prng
    from repro_torch.models import ModelRuntime, lm_init
    lines, entries = [], []
    counters = {"quant_matmul": qm.quant_matmul,
                "bbm_dot_scaled": tb.bbm_dot_scaled,
                "bbm_dot_coded_batched": tb.bbm_dot_coded_batched,
                "normal_draw": nm.normal_draw,
                "flash_attention": tf.flash_attention,
                "flash_attention_amm": tf.flash_attention_amm}
    t_lap = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        lines.append(f"  ({what}: {now - t_lap[0]:.1f} s)")
        t_lap[0] = now

    cfg = whisper_config(DS_NOISE)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_enc = sum(v.numel() for v in _leaves(params["encoder"]))
    n_all = sum(v.numel() for v in _leaves(params))
    lines.append(f"{cfg.name} at full width and depth ({cfg.n_encoder_layers}"
                 f" encoder + {cfg.n_layers} decoder layers): {n_all} "
                 f"parameters ({n_enc} in the encoder), "
                 f"{4 * n_all / 1e9:.2f} GB in f32, seeded on the card")
    gen = torch.Generator(device=dev)
    gen.manual_seed(90)
    enc = torch.randn((WH_BATCH, cfg.encoder_len, cfg.d_model),
                      generator=gen, device=dev)
    rng = np.random.default_rng(90)
    prompts = rng.integers(0, cfg.vocab, (WH_BATCH, WH_PROMPT)).tolist()

    # serving, three modes; the first call's kernel calls checked
    served, rts = {}, {}
    for mode, amm in WH_MODES.items():
        cfg_m = whisper_config(amm)
        rt = rts[mode] = ModelRuntime.build(cfg_m)
        want = wh_want(cfg_m, mode, counters)
        with KernelCapture(common) as cap, NormalCapture(common) as ncap:
            box = {}

            def start():
                cap.calls, ncap.on = [], True

            def stop():
                ncap.on = False
                box["calls"] = cap.take()
            res = wh_serve(torch, cfg_m, rt, params, enc, prompts, counters,
                           want, capture=(start, stop))
            captured = box["calls"]
            if mode == "noise":
                n_chk, worst, err = qm_capture_check(torch, qm, captured)
                chk = (f"{n_chk} quant_matmul calls within the bound of the "
                       f"plain version (worst error/bound {worst:.3g}, max "
                       f"abs error {err!r})")
            elif mode == "noise plain":
                n_chk, err = ncap.check(torch, prng)
                chk = (f"{n_chk} normal_draw calls bit-equal to the plain "
                       f"version (max abs error {err!r})")
            else:
                n_chk, err = ds_b2_capture_check(
                    torch, tb, captured, np.random.default_rng(96),
                    cols=WH_SAMPLE_COLS, slices=WH_SAMPLE_SLICES,
                    coded_on=dev)
                chk = (f"{n_chk} B2 calls bit-equal to their plain versions "
                       f"on sampled columns and slices (max abs error "
                       f"{err!r})")
        per_call = want(WH_PROMPT)
        if n_chk != sum(per_call.values()):
            fail(f"whisper {mode}: the first call's capture checked {n_chk} "
                 f"calls of {per_call}")
        res["check"], res["err"] = chk, err
        enc_ms = wh_encoder_ms(torch, cfg_m, rt, params, enc)
        steps = res["step_ms"]
        p50, p90 = steps[len(steps) // 2], steps[int(len(steps) * 0.9)]
        res.update(p50=p50, p90=p90, enc_ms=enc_ms)
        lines.append(
            f"{cfg.name} {mode} ({amm}): {WH_BATCH} sequences, prompts of "
            f"{WH_PROMPT}, max_len {WH_LEN}: a prefill "
            f"({res['prefill_ms']:.3f} ms, the first call's capture in it) "
            f"and {len(steps)} decode steps, {res['tokens']} tokens "
            f"generated in {res['wall_s']:.3f} s: "
            f"{res['tokens'] / res['wall_s']:.6g} generated tokens/s; decode "
            f"step ms p50 {p50:.3f}, p90 {p90:.3f}; launches "
            f"{ {k: v for k, v in res['launches'].items() if v} } over "
            f"{res['calls']} lm_apply calls, each call as predicted "
            f"({ {k: v for k, v in per_call.items() if v} } a prefill, "
            f"{ {k: v for k, v in want(1).items() if v} } a decode); all "
            f"logits finite; the first call's {chk}; the encoder alone "
            f"{enc_ms:.3f} ms, {enc_ms / p50:.4f} of a decode step (every "
            f"call recomputes it: ROADMAP C15)")
        kern = {"noise": ("quant_matmul", QM_KERNELS),
                "noise plain": ("normal_draw", (NORMAL_KERNEL,)),
                "bitexact": ("bbm_dot_scaled",
                             TRAIN_KERNELS["bbm_dot_scaled"])}[mode]
        forbid = {"noise": (NORMAL_KERNEL,) + TRAIN_KERNELS["bbm_dot_scaled"],
                  "noise plain": QM_KERNELS
                  + TRAIN_KERNELS["bbm_dot_scaled"],
                  "bitexact": QM_KERNELS + (NORMAL_KERNEL,)}[mode]
        res["batch"].want = None      # the timing runs launched more
        win, idle = decode_window(torch, res["batch"], kern[0], kern[1],
                                  prefills=1, forbid=forbid)
        res["idle"] = idle
        lines.extend(f"{cfg.name} {mode} " + ln.lstrip() for ln in win)
        res.pop("batch")
        served[mode] = res
        lap(f"whisper {mode} served")
    chk = wh_cpu_serve_check(torch, params, enc, prompts)
    lines.append(f"{cfg.name} card vs CPU port (exact, {WH_CPU_SEQS} "
                 f"sequences, full depth): {chk['calls']} calls teacher-forced"
                 f" from the card's tokens, logits within {chk['worst']:.4g} "
                 f"of the card's largest (tolerance {LOGIT_RTOL}; CPU "
                 f"{chk['cpu_s']:.1f} s)")
    lap("whisper card vs CPU (serving)")

    # training: the launcher on its zero embeddings, then live embeddings
    tcount = dict(counters, **{"bbm_dot_scaled (tensor cores)":
                               MmaLaunches(tb.bbm_dot_scaled)})
    mlp = 3 * (cfg.n_encoder_layers + cfg.n_layers)
    flash_calls = cfg.n_encoder_layers + cfg.n_layers
    none = {k: 0 for k in tcount}
    want_t1 = dict(none, bbm_dot_scaled=mlp, flash_attention_amm=flash_calls,
                   bbm_dot_coded_batched=2 * cfg.n_layers * wh_blocks(
                       WH_TRAIN_SEQ, cfg.encoder_len),
                   **{"bbm_dot_scaled (tensor cores)": mlp})
    want_t2 = dict(none, flash_attention=flash_calls)
    t1 = train_run(torch, WH_T1, tcount, batch=WH_TRAIN_BATCH,
                   seq=WH_TRAIN_SEQ)
    check_train_run("whisper T1", t1, want_t1)
    t2 = train_run(torch, WH_T2, tcount, batch=WH_TRAIN_BATCH,
                   seq=WH_TRAIN_SEQ)
    check_train_run("whisper T2", t2, want_t2)
    for name, res in (("T1 (bitexact, --amm-attn --flash-attn)", t1),
                      ("T2 (amm off, --flash-attn)", t2)):
        walls = sorted(st["wall"] for st in res["steps"][1:])
        tok = WH_TRAIN_BATCH * WH_TRAIN_SEQ
        lines.append(
            f"{cfg.name} training {name}, batch {WH_TRAIN_BATCH} x seq "
            f"{WH_TRAIN_SEQ}, the launcher's zero frame embeddings: losses "
            f"{[round(h['loss'], 6) for h in res['hist']]}, step ms "
            f"{[round(st['wall'] * 1e3, 3) for st in res['steps']]} "
            f"({tok / walls[0]:.6g} trained tokens/s at the fastest later "
            f"step); launches a step "
            f"{ {k: v for k, v in res['steps'][0]['launches'].items() if v} }"
            f" as predicted; the last step profiled: device busy "
            f"{res['busy_ms']:.3f} ms of {res['prof_wall_ms']:.3f} ms (idle "
            f"share {1 - res['busy_ms'] / res['prof_wall_ms']:.4f})")
        for t, count, key in res["by_kernel"][:6]:
            lines.append(f"  whisper train step device time: {t:.4f} ms in "
                         f"{count} launches of {key[:90]}")
    live = wh_train_step(torch, dev, counters)
    want_live = {k: v for k, v in want_t1.items() if k in counters}
    if live["launches"] != want_live or not np.isfinite(live["loss"]):
        fail(f"whisper's step on seeded embeddings launched "
             f"{live['launches']} (expected {want_live}), loss "
             f"{live['loss']!r}")
    lines.append(f"{cfg.name} one make_train_step step on seeded frame "
                 f"embeddings (T1's settings): loss {live['loss']!r}, "
                 f"{live['ms']:.3f} ms, launches as predicted")
    chk = wh_train_cpu_check(torch, dev)
    lines.append(f"{cfg.name} train card vs CPU ({WH_CPU_LAYERS} + "
                 f"{WH_CPU_LAYERS} layers, full width, {WH_TRAIN_SEQ} tokens, "
                 f"seeded embeddings, T2): loss {chk['card']!r} on the card, "
                 f"{chk['cpu']!r} on the CPU (tolerance {TRAIN_LOSS_RTOL} "
                 f"relative); every gradient leaf within "
                 f"{chk['grad_worst']:.3g} of its largest element (tolerance "
                 f"{TRAIN_GRAD_RTOL}; CPU {chk['cpu_s']:.1f} s)")
    lap("whisper trained")

    lines += wh_flash_checks(torch, tf, attn, dev, cfg, rts["bitexact"].amm)
    lap("whisper flash checks")
    launches = {"quant_matmul": served["noise"]["launches"]["quant_matmul"],
                "normal_draw":
                    served["noise plain"]["launches"]["normal_draw"],
                "bbm_dot_scaled":
                    served["bitexact"]["launches"]["bbm_dot_scaled"],
                "bbm_dot_coded_batched":
                    served["bitexact"]["launches"]["bbm_dot_coded_batched"],
                "flash_attention": t2["totals"]["flash_attention"],
                "flash_attention_amm": t1["totals"]["flash_attention_amm"]}
    k_lines, k_entries = wh_kernel_timing(
        torch, dev, tb, tf, qm, nm, prng, cfg, rts["noise"], rts["bitexact"],
        params, launches)
    lines += k_lines
    idle = {"quant_matmul": served["noise"]["idle"],
            "normal_draw": served["noise plain"]["idle"],
            "bbm_dot": served["bitexact"]["idle"],
            "flash_attention_amm":
                1 - t1["busy_ms"] / t1["prof_wall_ms"],
            "flash_attention": 1 - t2["busy_ms"] / t2["prof_wall_ms"]}
    for e in k_entries:
        key = next((k for k in sorted(idle, key=len, reverse=True)
                    if e["name"].startswith(k)), None)
        if key is not None:
            e["idle_share"] = idle[key]
    entries += k_entries
    lap("whisper kernels at the new shapes")
    lines.append(f"{cfg.name} peak allocated "
                 f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del params, enc
    lines.append(f"slice 9 phase on {card}")
    return lines, entries


def flash_amm_route_ms(torch, tf, q, k, v, route=None,
                       causal: bool = True) -> tuple:
    """(device ms, how measured) of one amm kernel launch at kind 0, wl
    16, vbl 13 on operands formed beforehand (``flash_amm_operands``: the
    quantization is the wrapper's, not the kernel's), on ``route`` ("mma"
    or "tile", forced through ``_amm_launch``; None: the rule's): the
    profiler's reading, else CUDA events around the launch."""
    ops = tf.flash_amm_operands(q, k, v, wl=16)
    run = lambda: tf._amm_launch(ops, wl=16, vbl=13, kind=0,  # noqa: E731
                                 causal=causal, route=route)
    ms = kernel_device_ms(torch, run, 5, TRAIN_KERNELS["flash_attention_amm"],
                          per_call=1)
    if ms is None:
        return cuda_ms(torch, run, 5), "CUDA events, the launch alone"
    return ms, "profiler"


def flash_kernel_timing(torch, tf, kern: str, q, k, v, causal: bool,
                        what: str) -> dict:
    """One flash kernel on (B, H, Sq, D) operands against Skv keys: its
    device ms (the exact kernel by its C entry between CUDA events; the
    amm kernel by ``flash_amm_route_ms``, its operands formed before), its
    plain version's ms, ``scaled_dot_product_attention``'s beside the
    exact one, the max abs error against the plain version (the amm
    kernel held by ``flash_amm_check``), and the bound: the operations
    over the live (query, key) pairs against the bytes of q, k, v and the
    output, in f32, and the amm kernel's int16 codes."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bh = b * h
    pairs = bh * (sq * (sq + 1) // 2 if causal else sq * skv)
    if kern == "flash_attention":
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = flash_raw_ms(torch, q, k, v, causal=causal)
        how = "CUDA events, the kernel's C entry"
        plain_ms = cuda_ms(torch, lambda: tf.flash_attention_plain(
            q, k, v, causal=causal), 3)
        lib_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=causal), 20)
        err = float((tf.flash_attention(q, k, v, causal=causal)
                     - tf.flash_attention_plain(q, k, v, causal=causal))
                    .abs().max())
        t_ops = flash_bound_ms(pairs, d, skv)
        nbytes = 4 * d * bh * (2 * sq + 2 * skv)
    else:
        ms, how = flash_amm_route_ms(torch, tf, q, k, v, causal=causal)
        plain_ms = cuda_ms(torch, lambda: tf.flash_amm_plain(
            tf.flash_amm_operands(q, k, v, wl=16), wl=16, vbl=13, kind=0,
            causal=causal), 2)
        lib_ms = None
        err = flash_amm_check(torch, tf, q, k, v, kind=0, causal=causal,
                              what=what)["max_err"]
        t_ops = flash_bound_ms(pairs, d, skv, amm=(16, 13, 0))
        nbytes = 4 * d * bh * (2 * sq + 2 * skv) \
            + 2 * d * bh * (sq + 2 * skv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(ms=ms, how=how, plain_ms=plain_ms, lib_ms=lib_ms, err=err,
                bound=max(t_ops, t_bytes),
                by="operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------ slice 10
# the flash kernels' new head dims, at the training shapes (batch 4 x 512)
HD_BATCH, HD_SEQ = 4, 512
HD_DIMS = (80, 128)
HD_RAGGED = 200                   # a ragged query and key length
HD_SHORT_KV = 20                  # below PV_3XTF32_MIN_SKV: the FFMA P V
HD_TILE_VBL = 3                   # wl 16 / vbl 3: the amm "tile" route
# the wide kernels' ms before their redesign (PERF.md's kernel table, PR
# 26 call 7, an NVIDIA H100 80GB HBM3 at 700.00 W): (exact, amm) at each
# config's (4, H, 512, D) causal shape; the amm times are of the wrapper
# with its quantization, so they print beside the new ones and go on no
# kernels line
HD_BEFORE_MS = {"grok-1-314b": (0.554449, 21.476349),
                "llama3.2-3b": (0.281333, 11.386592),
                "yi-34b": (0.644632, 24.473795),
                "qwen1.5-110b": (0.732156, 28.582788),
                "chameleon-34b": (0.736502, 28.57995),
                "zamba2-2.7b": (0.288981, 9.319193)}


def hd_flash_configs() -> list:
    """(name, heads, kv heads, head dim) of every registered config whose
    attention can take the flash kernels at a head dim of ``HD_DIMS``
    (MLA never takes them)."""
    from repro_torch.configs import ARCH_NAMES, get_arch
    out = []
    for name in ARCH_NAMES:
        cfg = get_arch(name)
        if not cfg.use_mla and cfg.n_heads \
                and cfg.resolved_head_dim in HD_DIMS:
            out.append((name, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim))
    return out


def hd_operands(torch, gen, dev, heads: int, kv: int, d: int, sq: int,
                skv: int):
    """q (B, H, Sq, D) and k, v (B, H, Skv, D) drawn as (B, S, heads, D)
    and (B, S, kv, D), the KV heads repeated over their query groups as
    ``models.attention.attention`` repeats them before a flash call."""
    q = torch.randn((HD_BATCH, sq, heads, d), generator=gen, device=dev)
    k, v = (torch.randn((HD_BATCH, skv, kv, d), generator=gen, device=dev)
            for _ in range(2))
    groups = heads // kv
    rep = lambda t: torch.repeat_interleave(t, groups, dim=2)  # noqa: E731
    return q.transpose(1, 2), rep(k).transpose(1, 2), rep(v).transpose(1, 2)


def attention_f64_p_tf32(torch, q, k, v):
    """``attention_f64`` with P rounded to TF32 before P V: a P V product
    that lost P's low TF32 part, with that rounding as its only error."""
    q, k, v = (t.double() for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s_len = s.shape[-1]
    dead = torch.ones((s_len, s_len), dtype=torch.bool,
                      device=s.device).triu(1)
    p = torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1)
    return tf32_round(torch, p.float()).double() @ v


def route_counts(tf) -> dict:
    """Each flash wrapper's launches per route so far."""
    fa, fm = tf.flash_attention, tf.flash_attention_amm
    return {"flash_attention": {"tf32": fa.mma_launches,
                                "ffma": fa.launches - fa.mma_launches},
            "flash_attention_amm": {"mma": fm.mma_launches,
                                    "tile": fm.launches - fm.mma_launches}}


def hd_flash_phase(torch, dev, tf) -> tuple:
    """Both flash kernels at head dims 80 and 128 against their plain
    versions (``flash_tolerance``; ``flash_amm_compare``) at every such
    config's training shape, causal and not, kind 0 (kind 1 at the first
    config of each head dim), a ragged Sq = Skv = 200, a cross shape
    (Sq 200 against 512 keys, not causal) and a short KV length
    (``HD_SHORT_KV`` keys, the exact kernel's FFMA P V route), and the
    amm kernel's CUDA-core route (wl 16 / vbl 3) at the ragged shape of
    head dim 128; the exact kernel's error against float64 attention
    within ``PRECISION_FACTOR`` times its plain version's, and a score
    product or a P V below f32 precision beyond that limit; each config's
    causal shape timed against its bound, its plain version,
    ``scaled_dot_product_attention`` and the time before the redesign,
    and at grok-1's the amm kernel's CUDA-core route on the same inputs.
    Returns (lines, kernel entries, checked cases, launches per
    route)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(100)
    lines, timed = [], {"flash_attention": [], "flash_attention_amm": []}
    cases, first = 0, set()
    worst = {"flash_attention": 0.0, "flash_attention_amm": 0.0}
    moved = [0, 0]
    for f in (tf.flash_attention, tf.flash_attention_amm):
        f.launches = f.mma_launches = 0
    for name, heads, kv, d in hd_flash_configs():
        shapes = [(HD_SEQ, HD_SEQ, True), (HD_SEQ, HD_SEQ, False)]
        if d not in first:
            shapes += [(HD_RAGGED, HD_RAGGED, True),
                       (HD_RAGGED, HD_RAGGED, False),
                       (HD_RAGGED, HD_SEQ, False),
                       (HD_RAGGED, HD_SHORT_KV, False)]
        for sq, skv, causal in shapes:
            q, k, v = hd_operands(torch, gen, dev, heads, kv, d, sq, skv)
            what = (f"at {name}'s {tuple(q.shape)} x {skv} keys "
                    f"causal={causal}")
            worst["flash_attention"] = max(
                worst["flash_attention"],
                flash_exact_check(torch, tf, q, k, v, causal=causal,
                                  what=what))
            cases += 1
            for kind in ((0, 1) if d not in first and sq == HD_SEQ
                         else (0,)):
                rep = flash_amm_check(torch, tf, q, k, v, kind=kind,
                                      causal=causal, what=what)
                worst["flash_attention_amm"] = max(
                    worst["flash_attention_amm"], rep["worst_ratio"])
                moved[0] += rep["codes_moved"]
                moved[1] += rep["codes"]
                cases += 1
            if d == max(HD_DIMS) and d not in first \
                    and (sq, skv, causal) == (HD_RAGGED, HD_RAGGED, False):
                # the CUDA-core route (chunks of 7 products at wl 16 / vbl
                # 3) on one batch row's first 4 heads, its plain version
                # on the CPU
                cut = [t[:1, :4].contiguous() for t in (q, k, v)]
                rep = flash_amm_check(torch, tf, *cut, kind=0,
                                      causal=causal,
                                      what=f"{what} (1 x 4 heads)",
                                      vbl=HD_TILE_VBL, plain_cpu=True)
                worst["flash_attention_amm"] = max(
                    worst["flash_attention_amm"], rep["worst_ratio"])
                cases += 1
            if d not in first and sq == skv == HD_SEQ and causal:
                # 3xTF32 at this head dim: the kernel's error against
                # float64 within PRECISION_FACTOR times its plain version's,
                # and each product below f32 precision beyond it
                want = attention_f64(torch, q, k, v)
                err = lambda out: float(  # noqa: E731
                    (out.double() - want).abs().max())
                e_k = err(tf.flash_attention(q, k, v))
                e_p = err(tf.flash_attention_plain(q, k, v))
                limit = PRECISION_FACTOR * e_p
                if not e_k <= limit:
                    fail(f"flash_attention's error against float64 {e_k!r} "
                         f"{what} exceeds {PRECISION_FACTOR} x its plain "
                         f"version's {e_p!r}")
                qt, kt = tf32_round(torch, q), tf32_round(torch, k)
                controls = {
                    "1xTF32 scores": err(attention_f64(torch, qt, kt, v)),
                    "V in TF32": err(attention_f64(
                        torch, q, k, tf32_round(torch, v))),
                    "P in TF32": err(attention_f64_p_tf32(torch, q, k, v))}
                for c_name, e in controls.items():
                    if not e > limit:
                        fail(f"a product with {c_name} errs {e!r} {what}, "
                             f"within the limit {limit!r}: the check could "
                             f"not tell it from f32")
                lines.append(
                    f"flash_attention precision {what}: max error against "
                    f"float64 {e_k!r}, plain version (f32) {e_p!r}, limit "
                    f"{PRECISION_FACTOR} x plain; controls beyond it "
                    + ", ".join(f"{c} {e:.4g}" for c, e in controls.items()))
            if sq == skv == HD_SEQ and causal:
                for kern in timed:
                    r = flash_kernel_timing(torch, tf, kern, q, k, v, True,
                                            what)
                    before = HD_BEFORE_MS[name][kern == "flash_attention_amm"]
                    row = dict(config=name, shape=list(q.shape), ms=r["ms"],
                               plain_ms=r["plain_ms"], bound_ms=r["bound"],
                               bound_by=r["by"], library_ms=r["lib_ms"],
                               timed_by=r["how"], max_abs_err=r["err"])
                    extra = ""
                    if kern == "flash_attention_amm" \
                            and name == "grok-1-314b":
                        t_ms, t_how = flash_amm_route_ms(torch, tf, q, k, v,
                                                         "tile")
                        row.update(tile_route_ms=t_ms, tile_timed_by=t_how)
                        extra = (f", the CUDA-core route on the same inputs "
                                 f"{t_ms:.6f} ms ({t_how})")
                    timed[kern].append(row)
                    lines.append(
                        f"{kern} at {name}'s training shape {tuple(q.shape)} "
                        f"causal ({heads} / {kv} heads, head dim {d}): "
                        f"{r['ms']:.6f} ms ({r['how']}), before the redesign "
                        f"{before} ms (PERF.md, PR 26"
                        + (", the wrapper with its quantization"
                           if kern == "flash_attention_amm" else "")
                        + f"), plain {r['plain_ms']:.6f} ms, "
                        f"bound {r['bound']:.6f} ms ({r['by']}; bound / time "
                        f"{r['bound'] / r['ms']:.4g}), max abs error "
                        f"{r['err']!r}"
                        + ("" if r["lib_ms"] is None else
                           f", scaled_dot_product_attention "
                           f"{r['lib_ms']:.6f} ms (time / SDPA "
                           f"{r['ms'] / r['lib_ms']:.4g})") + extra)
            del q, k, v
        first.add(d)
    routes = route_counts(tf)
    for kern, want in (("flash_attention", ("tf32", "ffma")),
                       ("flash_attention_amm", ("mma", "tile"))):
        missing = [r for r in want if not routes[kern][r]]
        if missing:
            fail(f"{kern}'s routes {missing} never ran at head dims "
                 f"{HD_DIMS}: {routes[kern]}")
    lines.insert(0, f"flash kernels at head dims {HD_DIMS}: {cases} cases "
                    f"over {[c[0] for c in hd_flash_configs()]} within their "
                    f"bounds (worst error/bound: flash_attention "
                    f"{worst['flash_attention']:.3g}, flash_attention_amm "
                    f"{worst['flash_attention_amm']:.3g}; {moved[0]} of "
                    f"{moved[1]} P codes moved by float rounding); launches "
                    f"per route {routes}")
    return lines, timed, cases, routes


# the training phase of slice 10: full width, T1's and T2's settings
MT_T1 = dict(mode="bitexact", mul="bbm0", wl=16, param=13, apply_to="all")
MT_T2 = dict(mode="off")
MT_LOOP_STEPS, MT_LOOP_EXPERTS, MT_LOOP_VOCAB = 3, 2, 16384
MT_DS_EXPERTS = 16
MT_CPU_LAYERS, MT_CPU_SEQ = 2, 64


def grok_config(amm: dict, layers: int = 1, experts=None, vocab=None):
    """grok-1-314b at full width (d_model 6144, 48 query and 8 KV heads of
    128, 8 experts of width 32,768, top-2, vocab 131,072), cut to
    ``layers``; ``experts`` and ``vocab`` cut its width (the loop's)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import AmmConfig
    kw = dict(n_layers=layers, amm=AmmConfig(**amm))
    if experts is not None:
        kw["n_experts"] = experts
    if vocab is not None:
        kw["vocab"] = vocab
    return dataclasses.replace(get_arch("grok-1-314b"), **kw)


def ds_train_config(amm: dict, layers: int = 2, experts=MT_DS_EXPERTS):
    """deepseek-v3-671b at full width with its MTP block, cut to
    ``layers`` (the first dense, the rest MoE) and ``experts`` routed
    experts (top-8 kept)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import AmmConfig
    return dataclasses.replace(get_arch("deepseek-v3-671b"), n_layers=layers,
                               first_k_dense=1, n_experts=experts,
                               amm=AmmConfig(**amm))


def mt_batch(torch, dev, cfg, batch: int = TRAIN_BATCH,
             seq: int = TRAIN_SEQ):
    from repro_torch.data.pipeline import DataConfig, global_batch
    toks, labels = global_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                           global_batch=batch), 0)
    return (torch.from_numpy(toks).to(dev), torch.from_numpy(labels).to(dev))


def mt_loss_and_grads(torch, dev, cfg, params, counters, *, capture=None,
                      keep_grads=False) -> dict:
    """``loss_and_grads`` of ``cfg`` at batch 4 x 512 on the card, twice
    (the second timed warm); each call's launches of every counted
    kernel (and, in ``mma``, of those with a tensor-core route on it),
    the loss terms, the peak allocated bytes.  Fails on a non-finite
    loss, term or gradient.  ``capture``: a ``KernelCapture`` that
    records the first call's kernel calls."""
    from repro_torch.core import prng
    from repro_torch.models import ModelRuntime
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainstep import loss_and_grads
    rt = ModelRuntime.build(cfg, use_pallas=True)
    toks, labels = mt_batch(torch, dev, cfg)
    out = {"launches": [], "mma": [], "ms": []}
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(2):
        if capture is not None and i == 0:
            capture.calls = []
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, metrics = loss_and_grads(params, cfg, rt, toks, labels,
                                              prng.key(42))
        loss = float(loss)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append({n: f.launches for n, f in counters.items()})
        out["mma"].append(mma_counts(counters))
        if capture is not None and i == 0:
            out["calls"] = capture.take()
        terms = {k: float(v) for k, v in metrics.items()}
        if not (np.isfinite(loss) and all(np.isfinite(v)
                                          for v in terms.values())):
            fail(f"{cfg.name}: a non-finite loss {loss!r} or term {terms}")
        bad = sum(int((~torch.isfinite(g)).sum()) for g in tree_leaves(grads))
        if bad:
            fail(f"{cfg.name}: {bad} non-finite gradient elements")
        out["loss"], out["terms"] = loss, terms
        if keep_grads and i == 1:
            out["grads"] = grads
        del grads
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def zero_counts(counters) -> None:
    """Every wrapper's launches, and its tensor-core launches where it
    counts them, set to 0."""
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "mma_launches"):
            f.mma_launches = 0


def mma_counts(counters) -> dict:
    """The tensor-core launches of each wrapper that counts them."""
    return {n: f.mma_launches for n, f in counters.items()
            if hasattr(f, "mma_launches")}


def main_routes(res: dict, kern: str) -> dict:
    """A flash kernel's launches per route over ``res``'s calls of
    ``mt_loss_and_grads``, as its wrapper counted them."""
    total = sum(c[kern] for c in res["launches"])
    mma = sum(c[kern] for c in res["mma"])
    names = ("tf32", "ffma") if kern == "flash_attention" \
        else ("mma", "tile")
    return {names[0]: mma, names[1]: total - mma}


def mt_check_launches(name: str, res: dict, want: dict) -> None:
    for i, got in enumerate(res["launches"]):
        if got != want:
            fail(f"{name}: loss_and_grads call {i} launched {got}, "
                 f"predicted {want}")


class ForcedRoutes:
    """While on, each MoE call of ``models.transformer`` records its router
    logits (f32, on the CPU) and its top-k decisions; given ``use``, a
    list of decisions from another run, the calls take those in order
    instead (gate weights from their own router), so two runs compare
    on one routing."""

    def __init__(self, torch, use=None):
        import repro_torch.models.moe as moe
        import repro_torch.models.transformer as tr
        self.torch, self.moe, self.tr = torch, moe, tr
        self.logits, self.idx = [], []
        self.use = None if use is None else iter(use)
        self.orig_apply, self.orig_top = tr.moe_apply, moe._top_k
        tr.moe_apply, moe._top_k = self._apply, self._top_k

    def _apply(self, p, x, cfg, **kw):
        xf = x.detach().reshape(-1, x.shape[-1]).float()
        self.logits.append((xf @ p["router"].detach().float()).cpu())
        return self.orig_apply(p, x, cfg, **kw)

    def _top_k(self, probs, k):
        vals, idx = self.orig_top(probs, k)
        if self.use is not None:
            idx = next(self.use).to(probs.device)
            vals = probs.gather(-1, idx)
        self.idx.append(idx.cpu())
        return vals, idx

    def close(self):
        self.tr.moe_apply, self.moe._top_k = self.orig_apply, self.orig_top


def mt_cpu_check(torch, dev, cfg, seed: int) -> dict:
    """The card against the CPU port on ``cfg`` (a depth cut at full width,
    T2's settings: the exact flash kernel where the config takes it), one
    sequence of ``MT_CPU_SEQ`` tokens: the card's router logits held by a
    ``RouteLedger`` against the CPU's, the CPU run on the card's top-k
    decisions; the loss and each term within ``TRAIN_LOSS_RTOL``, each
    gradient leaf within ``TRAIN_GRAD_RTOL`` of its largest element."""
    from repro_torch.core import prng
    from repro_torch.models import ModelRuntime, lm_init
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainstep import loss_and_grads
    rt = ModelRuntime.build(cfg, use_pallas=True)
    params = lm_init(cfg, seed, device=dev)
    toks, labels = mt_batch(torch, dev, cfg, 1, MT_CPU_SEQ)
    rec = ForcedRoutes(torch)
    try:
        card, card_g, card_m = loss_and_grads(params, cfg, rt, toks, labels,
                                              prng.key(7))
        card = float(card)
    finally:
        rec.close()
    cpu_params = _to_cpu(params)
    del params
    t0 = time.perf_counter()
    forced = ForcedRoutes(torch, use=rec.idx)
    try:
        cpu, cpu_g, cpu_m = loss_and_grads(cpu_params, cfg, rt, toks.cpu(),
                                           labels.cpu(), prng.key(7))
        cpu = float(cpu)
    finally:
        forced.close()
    cpu_s = time.perf_counter() - t0
    ledger = RouteLedger(LOGIT_RTOL)
    rows, pos = np.zeros(MT_CPU_SEQ, int), np.arange(MT_CPU_SEQ)
    for a, b in zip(rec.logits, forced.logits):
        ledger.layer(a.numpy(), b.numpy(), rows, pos, cfg.top_k)
    if not (np.isfinite(card) and abs(card - cpu) <= TRAIN_LOSS_RTOL
            * abs(cpu)):
        fail(f"{cfg.name}: the card's loss {card!r} is off the CPU port's "
             f"{cpu!r}")
    for k, v in cpu_m.items():
        if not abs(float(card_m[k]) - float(v)) <= TRAIN_LOSS_RTOL \
                * abs(float(v)):
            fail(f"{cfg.name}: the card's {k} {float(card_m[k])!r} is off "
                 f"the CPU port's {float(v)!r}")
    worst = 0.0
    for g, w in zip(tree_leaves(card_g), tree_leaves(cpu_g)):
        # on the card, in f32: its rounding of the difference is far below
        # the tolerance, and float64 copies of the embedding's 0.9 G
        # elements on the host cost minutes
        w = w.to(dev)
        ratio = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        if not ratio <= TRAIN_GRAD_RTOL:
            fail(f"{cfg.name}: a gradient leaf {tuple(w.shape)} on the card "
                 f"is off the CPU port's by {ratio} of its largest element")
        worst = max(worst, ratio)
    return {"card": card, "cpu": cpu, "cpu_s": cpu_s, "grad_worst": worst,
            "terms": {k: (float(card_m[k]), float(v))
                      for k, v in cpu_m.items()},
            "flips": ledger.flips, "tokens": ledger.tokens}


def mt_loop(torch, counters) -> dict:
    """``launch.train.main`` on grok-1 cut to 1 layer, ``MT_LOOP_EXPERTS``
    routed experts and a vocabulary of ``MT_LOOP_VOCAB`` (its config
    handed in through the launcher's ``get_arch``), T1's flags, batch 4 x
    512, ``MT_LOOP_STEPS`` steps and the final checkpoint (18.5 GB of
    parameters and AdamW's moments; the periodic one and the restore are
    the CPU tests').  Each step's launches and wall, the history, the
    checkpoint's step."""
    import shutil
    import repro_torch.launch.train as launch
    from repro_torch.train import checkpoint
    cfg = grok_config(MT_T1, experts=MT_LOOP_EXPERTS, vocab=MT_LOOP_VOCAB)
    ckpt = ROOT / "build" / "chip_smoke_moe_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps = []
    make, get_arch = launch.make_train_step, launch.get_arch

    def counted_make(cfg_, rt, tc):
        step = make(cfg_, rt, tc)

        def counted(*args, **kw):
            zero_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args, **kw)
            float(out[2]["loss"])
            torch.cuda.synchronize()
            steps.append({"wall": time.perf_counter() - t0, "launches": {
                n: f.launches for n, f in counters.items()},
                "mma": mma_counts(counters)})
            return out
        return counted

    launch.make_train_step = counted_make
    launch.get_arch = lambda name: cfg
    flags = T1_FLAGS + ["--arch", "grok-1-314b", "--batch", str(TRAIN_BATCH),
                        "--seq", str(TRAIN_SEQ), "--ckpt-dir", str(ckpt),
                        "--ckpt-every", "0", "--steps", str(MT_LOOP_STEPS)]
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = launch.main(flags)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        at = checkpoint.latest_step(str(ckpt))
    finally:
        launch.make_train_step, launch.get_arch = make, get_arch
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"cfg": cfg, "hist": hist, "steps": steps, "run_s": run_s,
            "peak_gb": peak, "ckpt_step": at}


def mt_kernel_timing(torch, tb, calls, launches) -> tuple:
    """deepseek-v3's T1 kernel calls at their training shapes: each
    distinct (kernel, shape) of the recorded calls on its own inputs,
    device ms (``launch_ms``), its plain version on a sample
    (``DS_SAMPLE_COLS`` columns, ``DS_SAMPLE_SLICES`` slices, on the card)
    bit-equal, timed on that sample, the bound of the whole call, an f32
    PyTorch product of the same shapes as a yardstick.  Returns (lines,
    kernel entries)."""
    rng = np.random.default_rng(101)
    seen, rows = set(), {"bbm_dot_scaled": [], "bbm_dot_coded_batched": []}
    lines = []
    for name, args, kw, out in calls:
        shape = (name, tuple(args[0].shape), tuple(args[2 if name
                 == "bbm_dot_coded_batched" else 1].shape))
        if shape in seen:
            continue
        seen.add(shape)
        if name == "bbm_dot_scaled":
            x, w = args
            m, k = x.shape
            n = w.shape[1]
            run = lambda: tb.bbm_dot_scaled(x, w, **kw)  # noqa: E731
            ms, how = launch_ms(torch, run, 5, TRAIN_KERNELS[name])
            pick = torch.as_tensor(np.sort(rng.choice(
                n, min(DS_SAMPLE_COLS, n), replace=False)), device=w.device)
            ws = w[:, pick].contiguous()
            plain = lambda: tb.bbm_dot_scaled_plain(x, ws, **kw)  # noqa
            want = plain()
            err = float((out[:, pick] - want).abs().max())
            plain_ms = cuda_ms(torch, plain, 1)
            xf, wf = x.float(), w.float()
            lib_ms = cuda_ms(torch, lambda: xf @ wf, 5)
            bound, by = dot_scaled_bound_ms(m, k, n)
            what = f"({m}, {k}) x ({k}, {n})"
            sample = f"{len(pick)} of {n} columns"
        else:
            a, s_a, b, s_b = args
            bt, _, m, k = a.shape
            n = b.shape[-1]
            run = lambda: tb.bbm_dot_coded_batched(  # noqa: E731
                a, s_a, b, s_b, **kw)
            ms, how = launch_ms(torch, run, 5, CODED_KERNEL)
            sl = torch.as_tensor(np.sort(rng.choice(
                bt, min(DS_SAMPLE_SLICES, bt), replace=False)),
                device=a.device)
            kw_s = {k_: (v[sl] if torch.is_tensor(v) else v)
                    for k_, v in kw.items()}
            plain = lambda: tb.bbm_dot_coded_batched_plain(  # noqa: E731
                *(t[sl] for t in (a, s_a, b, s_b)), **kw_s)
            want = plain()
            err = float((out[sl] - want).abs().max())
            plain_ms = cuda_ms(torch, plain, 1)
            af = a.float().reshape(bt, m, k)
            bf = b.float().reshape(bt, k, n)
            lib_ms = cuda_ms(torch, lambda: torch.bmm(af, bf), 5)
            bound, by = dense_coded_bound_ms(bt, m, k, n)
            what = f"{bt} slices of ({m}, {k}) x ({k}, {n})"
            sample = f"{len(sl)} of {bt} slices"
        if err != 0:
            fail(f"{name} at deepseek-v3's training shape {what} differs "
                 f"from its plain version by {err}")
        rows[name].append(dict(what=what, ms=ms, how=how, plain_ms=plain_ms,
                               sample=sample, bound=bound, by=by,
                               lib_ms=lib_ms, err=err))
        lines.append(
            f"{name} at deepseek-v3's T1 training shape {what}: {ms:.6f} ms "
            f"({how}), bound {bound:.6f} ms ({by}; bound / time "
            f"{bound / ms:.4g}), plain version on {sample} {plain_ms:.6f} ms "
            f"(bit-equal there), f32 PyTorch product of the same shapes "
            f"{lib_ms:.6f} ms (a yardstick, not the same function)")
    entries = []
    for name, src in (("bbm_dot_scaled", MMA_SOURCE),
                      ("bbm_dot_coded_batched", CODED_SOURCE)):
        r = rows[name]
        mean = lambda f: sum(x[f] for x in r) / len(r)  # noqa: E731
        entries.append({
            "name": f"{name} (deepseek-v3 T1 training)", "route": "cuda",
            "source": src, "replaces": REPLACES["bbm_dot_scaled"]
            if name == "bbm_dot_scaled" else CODED_REPLACES,
            "launches": launches[name], "max_abs_err": max(x["err"]
                                                            for x in r),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "plain_on": "a sample of each call: " + "; ".join(
                x["sample"] for x in r),
            "bound_ms": mean("bound"), "bound_by": r[0]["by"],
            "library_ms": None, "matmul_ms": mean("lib_ms"),
            "timed_by": ", ".join(sorted({x["how"] for x in r})),
            "per_shape": [{k2: x[k2] for k2 in ("what", "ms", "bound",
                                                  "plain_ms", "lib_ms")}
                          for x in r]})
    return lines, entries


def moe_train_phase(torch, dev, tb, tf, qm, nm) -> tuple:
    """Slice 10: the flash kernels at head dims 80 and 128
    (``hd_flash_phase``); grok-1 at full width cut to 1 layer through
    ``loss_and_grads`` in T1 (``flash_attention_amm`` at head dim 128) and
    T2 (``flash_attention``); the launcher's loop on grok-1 cut in width
    (``mt_loop``); deepseek-v3 at full width cut to 2 layers and 16 routed
    experts with its MTP block, T1 and T2; the card against the CPU port
    on 2-layer cuts; deepseek-v3's T1 kernels at their training shapes.
    Returns (printed lines, kernel entries)."""
    import gc
    import repro_torch.models.common as common
    from repro_torch.models import lm_init
    lines, entries = [], []
    counters = {"quant_matmul": qm.quant_matmul,
                "normal_draw": nm.normal_draw,
                "bbm_dot_scaled": tb.bbm_dot_scaled,
                "bbm_dot_coded_batched": tb.bbm_dot_coded_batched,
                "flash_attention": tf.flash_attention,
                "flash_attention_amm": tf.flash_attention_amm}
    t_lap = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        lines.append(f"  ({what}: {now - t_lap[0]:.1f} s)")
        t_lap[0] = now

    def predicted(**kw):
        return dict({n: 0 for n in counters}, **kw)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def rule(tag, cfg):
        """The flash kernel a grok-1 call of ``tag`` takes and the route
        its wrapper's rule gives it (T1: bbm0, kind 0)."""
        d = cfg.resolved_head_dim
        if tag == "T1":
            return "flash_attention_amm", tf.flash_amm_route(
                d, MT_T1["wl"], MT_T1["param"], 0)
        return "flash_attention", tf.flash_exact_route(d, TRAIN_SEQ)

    def check_routes(what, tag, cfg, res):
        kern, route = rule(tag, cfg)
        got = main_routes(res, kern)
        if got[route] != sum(got.values()):
            fail(f"{what}: {kern} launched {got} per route, predicted all "
                 f"on {route!r}")
        return f"{kern} per route {got} as its rule gives"

    hd_lines, timed, _, hd_routes = hd_flash_phase(torch, dev, tf)
    lines += hd_lines
    lap("flash kernels at head dims 80 and 128")

    # grok-1 at full width, 1 layer: T1 and T2
    runs = {}
    for tag, amm in (("T1", MT_T1), ("T2", MT_T2)):
        cfg = grok_config(amm)
        free()
        params = lm_init(cfg, 0, device=dev)
        n_params = sum(v.numel() for v in _leaves(params))
        res = mt_loss_and_grads(torch, dev, cfg, params, counters)
        del params
        want = predicted(**({"flash_attention_amm": cfg.n_layers}
                            if tag == "T1" else
                            {"flash_attention": cfg.n_layers}))
        mt_check_launches(f"grok-1 {tag}", res, want)
        by_route = check_routes(f"grok-1 {tag}", tag, cfg, res)
        runs[tag] = res
        lines.append(
            f"grok-1-314b at full width cut to {cfg.n_layers} layer "
            f"({n_params} parameters, {4 * n_params / 1e9:.2f} GB in f32), "
            f"{tag} ({'bitexact bbm0 WL 16 VBL 13 apply_to=all, ' if tag == 'T1' else 'amm off, '}"
            f"the flash kernels), loss_and_grads at {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}: loss {res['loss']!r}, terms {res['terms']}, "
            f"{res['ms'][0]:.1f} ms cold and {res['ms'][1]:.1f} ms warm, "
            f"launches per call {res['launches'][0]} as predicted "
            f"({by_route} over both calls), peak {res['peak_gb']:.2f} GB "
            f"allocated")
    lap("grok-1 T1 and T2")

    # the launcher's loop on grok-1 cut in width
    free()
    loop = mt_loop(torch, counters)
    cfg = loop["cfg"]
    hist = loop["hist"]
    if [h["step"] for h in hist] != list(range(MT_LOOP_STEPS)) \
            or len(loop["steps"]) != MT_LOOP_STEPS:
        fail(f"the grok-1 loop ran {[h['step'] for h in hist]}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["moe_aux"])
               for h in hist):
        fail(f"the grok-1 loop's history is not finite: {hist}")
    want = predicted(flash_attention_amm=cfg.n_layers)
    for i, st in enumerate(loop["steps"]):
        if st["launches"] != want:
            fail(f"grok-1 loop step {i} launched {st['launches']}, "
                 f"predicted {want}")
    by_route = check_routes("the grok-1 loop", "T1", cfg, {
        n: [st[n] for st in loop["steps"]] for n in ("launches", "mma")})
    if loop["ckpt_step"] != MT_LOOP_STEPS - 1:
        fail(f"the loop's checkpoint holds step {loop['ckpt_step']}")
    lines.append(
        f"grok-1-314b through launch.train (T1 flags), cut to 1 layer, "
        f"{cfg.n_experts} routed experts (of 8) and a vocabulary of "
        f"{cfg.vocab} (of 131,072): {MT_LOOP_STEPS} steps at {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, losses {[round(h['loss'], 6) for h in hist]}, "
        f"moe_aux {[round(h['moe_aux'], 6) for h in hist]}, step walls "
        f"{[round(st['wall'] * 1e3, 1) for st in loop['steps']]} ms, "
        f"launches per step {want['flash_attention_amm']} "
        f"flash_attention_amm as predicted ({by_route} over the steps), "
        f"run {loop['run_s']:.1f} s with "
        f"its final checkpoint (step {loop['ckpt_step']}), peak "
        f"{loop['peak_gb']:.2f} GB")
    del loop
    lap("the grok-1 loop")

    # deepseek-v3 at full width, 2 layers, 16 routed experts, the MTP block
    ds = {}
    for tag, amm in (("T1", MT_T1), ("T2", MT_T2)):
        cfg = ds_train_config(amm)
        free()
        params = lm_init(cfg, 0, device=dev)
        n_params = sum(v.numel() for v in _leaves(params))
        cap = KernelCapture(common) if tag == "T1" else None
        try:
            res = mt_loss_and_grads(torch, dev, cfg, params, counters,
                                    capture=cap)
        finally:
            if cap is not None:
                cap.close()
        del params
        # MLA on the chunked schedule: one (q block, KV block) pair at 512
        # tokens, a score and a value product in each of the three
        # attention layers (the dense one, the MoE one, the MTP block's);
        # the dense MLP and the two shared experts on bbm_dot_scaled
        want = predicted(bbm_dot_scaled=9, bbm_dot_coded_batched=6) \
            if tag == "T1" else predicted()
        mt_check_launches(f"deepseek-v3 {tag}", res, want)
        ds[tag] = res
        lines.append(
            f"deepseek-v3-671b at full width cut to {cfg.n_layers} layers "
            f"(1 dense, 1 MoE) with the MTP block and {cfg.n_experts} routed "
            f"experts (of 256; top-{cfg.top_k}), {n_params} parameters "
            f"({4 * n_params / 1e9:.2f} GB in f32), {tag}, loss_and_grads at "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss {res['loss']!r}, ce "
            f"{res['terms']['ce']!r}, moe_aux {res['terms']['moe_aux']!r}, "
            f"mtp {res['terms']['mtp']!r}, {res['ms'][0]:.1f} ms cold and "
            f"{res['ms'][1]:.1f} ms warm, launches per call "
            f"{ {k: v for k, v in res['launches'][0].items() if v} } as "
            f"predicted, peak {res['peak_gb']:.2f} GB allocated")
    lap("deepseek-v3 T1 and T2")

    # the card against the CPU port on 2-layer cuts (T2)
    free()
    for name, cfg, seed in (
            ("grok-1-314b", grok_config(MT_T2, layers=MT_CPU_LAYERS,
                                        experts=MT_LOOP_EXPERTS), 3),
            ("deepseek-v3-671b", ds_train_config(MT_T2), 4)):
        chk = mt_cpu_check(torch, dev, cfg, seed)
        free()
        lines.append(
            f"{name} card vs CPU ({cfg.n_layers} layers at full width, "
            f"{cfg.n_experts} routed experts, 1 x {MT_CPU_SEQ} tokens, T2): "
            f"loss {chk['card']!r} on the card, {chk['cpu']!r} on the CPU "
            f"(tolerance {TRAIN_LOSS_RTOL} relative), terms (card, CPU) "
            f"{chk['terms']}; router logits within {LOGIT_RTOL} of their "
            f"largest, {chk['flips']} top-k flips at near-ties of "
            f"{chk['tokens']} token decisions (the CPU ran the card's "
            f"routing); every gradient leaf within {chk['grad_worst']:.3g} of "
            f"its largest element (tolerance {TRAIN_GRAD_RTOL}; CPU "
            f"{chk['cpu_s']:.1f} s)")
    lap("card against CPU")

    # the kernels at the training shapes
    k_lines, k_entries = mt_kernel_timing(torch, tb, ds["T1"]["calls"],
                                          ds["T1"]["launches"][0])
    lines += k_lines
    entries += k_entries
    del ds
    free()
    for kern, run in (("flash_attention", runs["T2"]),
                      ("flash_attention_amm", runs["T1"])):
        rows = timed[kern]
        main = next(r for r in rows if r["config"] == "grok-1-314b")
        entries.append({
            "name": f"{kern} (head dim 128, grok-1 training)", "route": "cuda",
            "source": WIDE_FLASH_SOURCE, "replaces": REPLACES[kern],
            "launches": run["launches"][0][kern] + run["launches"][1][kern],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "timed_by": main["timed_by"],
            "routes": {"main path": main_routes(run, kern),
                       "launches at head dims 80 and 128": hd_routes[kern]},
            "per_config": rows})
    lap("kernel timing")
    return lines, entries


# ------------------------------------------------ slice 11: the parallel layer
PAR_SHARDS = 4           # (b): flush A's bank in 4 blocks of 16 channels
PAR_SEED = 27
PAR_ERR_SCALE = 1e-3     # the error buffer's draws, beside unit gradients
WIRE = {"int8": "C18: the int8 codes cross as int32",
        "bf16": "the bf16 codes cross as f32"}


def par_flush_a(torch, dev):
    """Flush A's operands as the engine dispatches them: 64 x 65,536 wl-16
    codes of ``make_filterbank_signals(64, seed=0)``, the fir30 banks
    alternating over the channels (their int32 codes and digit planes)."""
    from repro_torch.configs.fir30 import SPEC_APPROX, WL
    from repro_torch.dsp import design_lowpass, make_filterbank_signals
    from repro_torch.dsp import fir as dfir
    banks = dfir.PrecodedBank(np.stack([design_lowpass(), design_lowpass(
        stop_weight=0.5)]), SPEC_APPROX, device=dev).take(
            [c % 2 for c in range(64)])
    x = np.stack([s.x for s in make_filterbank_signals(64, n=65536, seed=0)])
    xc = dfir._to_device(dfir._codes32(dfir._quantize64(
        x * dfir._amp(x), WL), WL), dev)
    h = dfir._to_device(dfir._codes32(banks.hq, WL), dev)
    return xc, h, banks.planes


def par_filterbank(torch, fk, mesh, dev) -> tuple:
    """(a) ``sharded_filterbank`` on the world-1 mesh at flush A's operands
    (one ``fir_bank_rows`` on the tensor cores, the output equal to the
    unsharded call and 8 sampled channels to the plain version on the
    CPU); (b) the per-shard body on 4 blocks of 16 channels (4
    ``fir_bank_dot`` on the tensor cores, each block equal to its rows of
    (a)).  Returns (lines, kernel entries)."""
    from repro_torch.configs.fir30 import WL
    from repro_torch.parallel import filterbank
    xc, h, (hm, hn) = par_flush_a(torch, dev)
    c, n = xc.shape
    taps = hm.shape[2]
    shift = fk.min_safe_shift(taps, WL)
    kw = dict(wl=WL, vbl=13, kind=0, shift=shift)
    if fk.fir_bank_route(WL, 13, 0, shift, taps) != "mma":
        fail("flush A's operating point does not take the tensor cores")
    wrappers = {"fir_bank_rows": fk.fir_bank_rows,
                "fir_bank_dot": fk.fir_bank_dot}

    def counted(fn):
        for f in wrappers.values():
            f.launches = f.mma_launches = 0
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: {"mma": f.mma_launches,
                         "cuda-core": f.launches - f.mma_launches}
                     for k, f in wrappers.items()}

    def sharded():
        return filterbank.sharded_filterbank(xc, h, mesh, h_planes=(hm, hn),
                                             **kw)
    y, a_routes = counted(sharded)
    want = {"fir_bank_rows": {"mma": 1, "cuda-core": 0},
            "fir_bank_dot": {"mma": 0, "cuda-core": 0}}
    if a_routes != want:
        fail(f"sharded_filterbank launched {a_routes}, predicted {want}")
    y = y.to_local()
    whole = fk.fir_bbm_bank_precoded(xc, hm, hn, **kw)
    if tuple(y.shape) != (c, n) or not torch.equal(y, whole):
        fail("sharded_filterbank differs from the unsharded call")
    pick = sorted(np.random.default_rng(PAR_SEED).choice(
        c, 8, replace=False).tolist())
    cpu = fk.fir_bank_rows_plain(xc[pick].cpu(), hm[:, pick].cpu(),
                                 hn[:, pick].cpu(), **kw)
    err_a = int((y[pick].cpu().to(torch.int64) - cpu).abs().max())
    if err_a:
        fail(f"sharded_filterbank's sampled channels differ from the plain "
             f"version on the CPU (max abs error {err_a})")

    def blocks():
        return [filterbank._shard(xc, hm, hn, i, PAR_SHARDS, form=None, **kw)
                for i in range(PAR_SHARDS)]
    parts, b_routes = counted(blocks)
    want = {"fir_bank_rows": {"mma": 0, "cuda-core": 0},
            "fir_bank_dot": {"mma": PAR_SHARDS, "cuda-core": 0}}
    if b_routes != want:
        fail(f"the per-shard body on {PAR_SHARDS} blocks launched "
             f"{b_routes}, predicted {want}")
    per = c // PAR_SHARDS
    err_b = max(int((part.to(torch.int64) - y[i * per:(i + 1) * per]).abs()
                    .max()) for i, part in enumerate(parts))
    if err_b:
        fail(f"a block differs from its rows of the sharded call (max abs "
             f"error {err_b})")

    # timing: the entry point, the unsharded call, each kernel alone
    sh_ms = cuda_ms(torch, sharded, 20)
    whole_ms = cuda_ms(torch, lambda: fk.fir_bbm_bank_precoded(
        xc, hm, hn, **kw), 20)
    blk = (xc[:per].contiguous(), hm[:, :per].contiguous(),
           hn[:, :per].contiguous())
    entries, lines = [], []
    for name, args, routes, err, what in (
            ("fir_bank_rows", (xc, hm, hn), a_routes, err_a,
             "sharded_filterbank, flush A on a 1 x 1 mesh"),
            ("fir_bank_dot", blk, b_routes, err_b,
             f"the per-shard body, flush A in {PAR_SHARDS} blocks")):
        kern = wrappers[name]
        plain = getattr(fk, name + "_plain")
        cc, nn = args[0].shape
        ms, how = launch_ms(torch, lambda: kern(*args, **kw), 20,
                            FIR_KERNELS["mma"])
        plain_ms = cuda_ms(torch, lambda: plain(*args, **kw), 2)
        bound, by, _ = fir_bound_ms(name, cc, nn, taps, **kw)
        entries.append({
            "name": f"{name} ({what})", "route": "cuda",
            "source": FIR_MMA_SOURCE, "replaces": REPLACES[name],
            "launches": sum(routes[name].values()), "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "timed_by": how,
            "launches_by_route": routes[name]})
        lines.append(
            f"{name} at ({cc}, {nn}) x {taps} taps ({what}): launches on "
            f"the path per route {routes[name]}, {ms:.6f} ms "
            f"({how}), plain {plain_ms:.6f} ms, bound {bound:.6f} ms ({by}), "
            f"bound / time {bound / ms:.4g}")
    lines.insert(0, (
        f"sharded_filterbank (flush A: {c} x {n} codes, {taps} taps, wl 16 "
        f"vbl 13 shift {shift}) on the world-1 NCCL mesh: launches per "
        f"route {a_routes}, torch.equal to the unsharded call, 8 sampled "
        f"channels equal to the plain rows form on the CPU; {sh_ms:.6f} ms "
        f"a call against the unsharded {whole_ms:.6f} (CUDA events); its "
        f"{PAR_SHARDS}-way decomposition (the per-shard body on 16-channel "
        f"blocks, auto form per shard) launched {b_routes}, each block "
        f"torch.equal to its rows"))
    return lines, entries


def par_compressor(torch, mesh, dev, cfg) -> list:
    """(c) ``compressed_allreduce`` with both codecs over ``cfg``'s
    full-width parameter shapes (every ``lm_table`` leaf), gradients and a
    non-zero error buffer drawn from a seeded generator on the card: each
    codec's ms and the bytes each collective moved (C18), sampled leaves
    bit-equal to the plain per-leaf formula on CPU copies."""
    import torch.distributed as dist
    from repro_torch.models import lm_table
    from repro_torch.parallel import compress
    from repro_torch.train.optimizer import tree_leaves, tree_map
    gen = torch.Generator(device=dev)
    gen.manual_seed(PAR_SEED)
    table = lm_table(cfg)
    grads = tree_map(lambda s: torch.randn(s.shape, generator=gen,
                                           device=dev), table)
    errs = tree_map(lambda s: torch.randn(
        s.shape, generator=gen, device=dev).mul_(PAR_ERR_SCALE), table)
    g_leaves, e_leaves = tree_leaves(grads), tree_leaves(errs)
    numel = sum(g.numel() for g in g_leaves)
    sample = sorted({0, len(g_leaves) // 2, len(g_leaves) - 1})
    wire = []
    orig = compress._all_reduce

    def recorded(t, op, group):
        wire.append(("max" if op == dist.ReduceOp.MAX else "sum",
                     t.numel() * t.element_size()))
        return orig(t, op, group)

    lines = []
    compress._all_reduce = recorded
    try:
        for codec in ("int8", "bf16"):
            compress.compressed_allreduce(grads, mesh, codec,
                                          error_buf=errs)     # warm
            wire.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, new_e = compress.compressed_allreduce(grads, mesh, codec,
                                                        error_buf=errs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            by_op = {}
            for op, b in wire:
                by_op[op] = by_op.get(op, 0) + b
            m_leaves, ne_leaves = tree_leaves(mean), tree_leaves(new_e)
            for i in sample:
                g_fb = g_leaves[i].cpu() + e_leaves[i].cpu()
                sent = compress.compress_decompress(g_fb, codec)
                if not (torch.equal(m_leaves[i].cpu(), sent)
                        and torch.equal(ne_leaves[i].cpu(), g_fb - sent)):
                    fail(f"compressed_allreduce {codec}: leaf {i} "
                         f"{tuple(g_leaves[i].shape)} differs from the plain "
                         f"formula on the CPU")
                if not torch.isfinite(m_leaves[i]).all():
                    fail(f"compressed_allreduce {codec}: leaf {i} not finite")
            del mean, new_e, m_leaves, ne_leaves
            lines.append(
                f"compressed_allreduce {codec} over {cfg.name}'s "
                f"{len(g_leaves)} full-width leaves ({numel} f32 values): "
                f"{ms:.3f} ms (host clock, warm, one rank); {len(wire)} "
                f"all-reduces moved {sum(b for _, b in wire)} bytes "
                f"({by_op}) against {4 * numel} for the f32 values "
                f"themselves ({WIRE[codec]}); leaves "
                f"{sample} bit-equal to compress_decompress of g + e on the "
                f"CPU, and their error feedback")
    finally:
        compress._all_reduce = orig
    return lines


def par_train_state(torch, mesh, dev, cfg) -> list:
    """(d) ``init_train_state`` for ``cfg`` at full width on the 1 x 1
    mesh, bit-equal to ``lm_init`` + ``init_opt``; a checkpoint saved and
    restored with ``shardings=``, bit-equal; the peak and the seconds."""
    import shutil
    from repro_torch.models import lm_init
    from repro_torch.parallel.logical import NamedSharding, PartitionSpec
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import OptState, init_opt, tree_leaves
    from repro_torch.train.trainstep import (TrainConfig, init_train_state,
                                             train_step_shardings)
    from torch.distributed.tensor import DTensor
    tc = TrainConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, mesh, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(state)
    if not all(isinstance(t, DTensor) for t in leaves):
        fail("init_train_state returned a leaf that is not a DTensor")
    params = lm_init(cfg, 0, device=dev)
    plain = tree_leaves((params, init_opt(params, tc.opt)))
    if len(plain) != len(leaves) or not all(
            torch.equal(a.to_local(), b) for a, b in zip(leaves, plain)):
        fail("init_train_state differs from lm_init + init_opt")
    del params, plain
    ckpt = ROOT / "build" / "chip_smoke_parallel_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    p_sh, o_sh, _ = train_step_shardings(cfg, mesh)
    rep = NamedSharding(mesh, PartitionSpec())
    try:
        t0 = time.perf_counter()
        checkpoint.save(state, 1, str(ckpt))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, at = checkpoint.restore(state, str(ckpt), shardings=(
            p_sh, OptState(rep, o_sh, o_sh)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in ckpt.rglob("*.npy"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    got = tree_leaves(back)
    if at != 1 or not all(
            isinstance(b, DTensor) and b.placements == a.placements
            and torch.equal(b.to_local(), a.to_local())
            for a, b in zip(leaves, got)):
        fail("the restored train state differs from the saved one")
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in tree_leaves(state[0]))
    return [
        f"init_train_state {cfg.name} at full width ({n_params} parameters, "
        f"{len(leaves)} leaves with AdamW's moments) on the 1 x 1 card "
        f"mesh: {init_s:.2f} s, bit-equal to lm_init + init_opt; checkpoint "
        f"of {nbytes} bytes saved in {save_s:.2f} s (warm page cache) and "
        f"restored with shardings= in {restore_s:.2f} s, bit-equal with the "
        f"same placements; peak {peak:.2f} GB allocated"]


def parallel_phase(torch, fk) -> tuple:
    """Slice 11, the parallel layer: a world-1 NCCL mesh from
    ``make_host_mesh`` (failing unless the backend is NCCL), then (a) and
    (b) ``par_filterbank``, (c) ``par_compressor`` and (d)
    ``par_train_state`` on qwen2-0.5b at full width.  The card machine has
    one GPU, so the multi-rank arithmetic is the CPU tests' (gloo).
    Returns (printed lines, kernel entries)."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh
    lines, entries = [], []
    t_lap = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        lines.append(f"  ({what}: {now - t_lap[0]:.1f} s)")
        t_lap[0] = now

    mesh = make_host_mesh()
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            fail(f"the host mesh's backend is {backend!r}, not NCCL")
        dev = resolve_device(mesh.device_type)
        lines.append(f"host mesh {mesh} on backend {backend}, world size "
                     f"{dist.get_world_size()}")
        f_lines, entries = par_filterbank(torch, fk, mesh, dev)
        lines += f_lines
        lap("sharded filterbank")
        cfg = get_arch("qwen2-0.5b")
        lines += par_compressor(torch, mesh, dev, cfg)
        lap("compressed all-reduce")
        lines += par_train_state(torch, mesh, dev, cfg)
        lap("train state")
    finally:
        dist.destroy_process_group()
    return lines, entries


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
    mma = {lib: mma_ptxas(_build.BUILD_LOGS.get(lib, ""))
           for lib in ("bbm_dot", "bbm_matmul")}
    print("bbm_mma_kernel in each library (registers, spill stores): "
          + ", ".join(f"{lib} " + ("no report" if r is None else
                                   f"{r[0]} regs {r[1]} B")
                      for lib, r in mma.items()))
    flash = ptxas_kernels(_build.BUILD_LOGS.get("flash_attention", "")
                          + _build.BUILD_LOGS.get("flash_attention_wide", ""))
    print("flash_attention per kernel (registers, spill stores): " + (
        ", ".join(f"{k} {r} regs {sp} B" for k, r, sp in flash)
        or "no report"))

    # ---------------------------------------------------------------- sweep
    t0 = time.perf_counter()
    cases, mma_calls = sweep(torch, fk, booth_precode, dev)
    print(f"sweep: {cases} cases, fir_bank_rows and fir_bank_dot on the "
          f"CUDA-core route in each and on the tensor-core route in "
          f"{mma_calls // 2} (shift <= vbl, the bytes and the band fitting), "
          f"and the plain dot form, all bit-equal to the plain rows form "
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
    fir_wrappers = {"fir_bank_rows": fk.fir_bank_rows,
                    "fir_bank_dot": fk.fir_bank_dot}

    def fir_counts():
        """{wrapper: (launches, tensor-core launches)}"""
        return {n: (f.launches, f.mma_launches)
                for n, f in fir_wrappers.items()}

    for f in fir_wrappers.values():
        f.launches = f.mma_launches = 0
    for tag, sigs in flushes.items():
        before = fir_counts()
        rids = [eng.submit(s.x, bank=c % 2) for c, s in enumerate(sigs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.flush()
        dt = time.perf_counter() - t0
        counts[tag] = {n: (a - before[n][0], m - before[n][1])
                       for n, (a, m) in fir_counts().items()}
        served[tag] = (rids, out, dt)
    launches = {n: a for n, (a, _) in fir_counts().items()}
    by_route = {n: {"mma": m, "cuda-core": a - m}
                for n, (a, m) in fir_counts().items()}
    if eng.failed or eng.stats["quarantined"]:
        fail(f"the engine quarantined requests: {eng.failed}")
    # each flush is one dispatch: flush A the rows form (above the
    # auto-form budget), flush B the dot form, both on the tensor cores
    want = {"A": {"fir_bank_rows": (1, 1), "fir_bank_dot": (0, 0)},
            "B": {"fir_bank_rows": (0, 0), "fir_bank_dot": (1, 1)}}
    if counts != want:
        fail(f"the main path's launches (all, tensor-core) {counts}, "
             f"expected {want}")
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
        cnt = counts[tag]
        print(f"flush {tag}: {len(sigs)} requests, {samples} samples, "
              f"{dt * 1e3:.3f} ms, {samples / dt:.6g} samples/s, launches "
              + ", ".join(f"{n} {a} (tensor cores {m}, CUDA cores {a - m})"
                          for n, (a, m) in cnt.items())
              + f", mean SNR {snr:.6f} dB, 8 sampled channels bit-equal to "
              f"the CPU engine")

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
        if fk.fir_bank_route(WL, vbl, kind, shift, taps) != "mma":
            fail(f"flush {tag} does not take the tensor-core route")
        plain = getattr(fk, name + "_plain")
        hook = getattr(fk, f"_{name}_on")
        y_p = plain(xc, hm, hn, **kw)
        torch.cuda.synchronize()
        err = int((y_k.to(torch.int64) - y_p.to(torch.int64)).abs().max())
        if err != 0:
            fail(f"{name} differs from its plain version at the main "
                 f"path's shape (max abs error {err})")
        call_ms = cuda_ms(torch, lambda: kern(xc, hm, hn, **kw), 20)
        ms, how = launch_ms(torch, lambda: kern(xc, hm, hn, **kw), 20,
                            FIR_KERNELS["mma"])
        kw1 = dict(kw, kind=1)
        ms1, how1 = launch_ms(torch, lambda: kern(xc, hm, hn, **kw1), 20,
                              FIR_KERNELS["mma"])
        cc_ms, cc_how = launch_ms(
            torch, lambda: hook("cuda-core", xc, hm, hn, **kw), 20,
            FIR_KERNELS[name])
        plain_ms = cuda_ms(torch, lambda: plain(xc, hm, hn, **kw), 3)
        conv_ms = conv1d_ms(torch, c, n, taps, dev)
        bound, by, ops_ms = fir_bound_ms(name, c, n, taps, wl=WL, vbl=vbl,
                                         kind=kind, shift=shift)
        bound1, _, ops1_ms = fir_bound_ms(name, c, n, taps, wl=WL, vbl=vbl,
                                          kind=1, shift=shift)
        cc_bound, cc_by, _ = fir_bound_ms(name, c, n, taps, wl=WL, vbl=vbl,
                                          kind=kind, shift=vbl + 1)
        kernels.append({
            "name": name, "route": "cuda", "source": FIR_MMA_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "timed_by": how, "launches_by_route": by_route[name],
            "cuda_core_ms": cc_ms})
        print(f"{name} at ({c}, {n}) x {taps} taps (flush {tag}), wl 16 "
              f"vbl 13 shift 5: the tensor-core route (fir_mma_kernel) "
              f"{ms:.6f} ms ({how}; kind 1 {ms1:.6f} ms, {how1}), wrapper "
              f"call {call_ms:.6f} ms (CUDA events); bound {bound:.6f} ms "
              f"({by}; the {dot_byte_products(WL, vbl, kind)} int8 byte "
              f"products a tap product take {ops_ms:.6f} ms, "
              f"{ops1_ms:.6f} at kind 1), bound / time {bound / ms:.4g} "
              f"(kind 1 {bound1 / ms1:.4g}); the CUDA-core route "
              f"({FIR_KERNELS[name]}) {cc_ms:.6f} ms ({cc_how}), its int32 "
              f"count {cc_bound:.6f} ms ({cc_by}); plain {plain_ms:.6f} ms; "
              f"f32 F.conv1d(groups=C) at the same (C, N, taps) "
              f"{conv_ms:.6f} ms (a yardstick, not the same function)")

    # ---------------------------------------------------- quant_matmul sweep
    import importlib
    qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    from repro_torch.kernels.ref import amm_scale
    from repro_torch.models import ModelRuntime, lm_init
    cfg = lm_config()
    rt = ModelRuntime.build(cfg)
    t0 = time.perf_counter()
    cases, equal, worst, edges = qm_sweep(torch, qm, dev, rt.amm.mu,
                                          rt.amm.sigma)
    print(f"quant_matmul sweep: {cases} cases within the derived bound of "
          f"the plain version, {equal} of them bit-equal (all with exact "
          f"chunk sums and no noise among them), worst error/bound "
          f"{worst:.3g}; the hash's uniforms bit-equal; route edges "
          f"M={QM_EDGE_MS} at (K, N)={QM_EDGE_KN}: {edges['edges']} cases, "
          f"unaligned x or w views: {edges['unaligned']}, each route "
          f"forced (bk 512, 100, 32, 32768; 32769 refused): "
          f"{edges['forced']}, all within "
          f"the bound; the tiled route bit-equal to quant_matmul_emulated "
          f"in {edges['tiled_bitwise']} of them; the kernel's quotient "
          f"bit-equal to __fdiv_rn over every dividend significand for "
          f"{edges['divisors']} divisors, its codes bit-equal to the CPU's "
          f"on 2^24 random float32 values at {edges['code_scales']} "
          f"(scale, wl) pairs ({time.perf_counter() - t0:.1f} s)")

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
    pallas_p50, pallas_p90 = steps[len(steps) // 2], \
        steps[int(len(steps) * 0.9)]
    pallas_tps = res["tokens"] / res["wall_s"]
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
    (_, _, _, d_gu, _, p_gu, b_gu, by, _, _, how_gu), \
        (_, _, _, d_dn, _, p_dn, b_dn, _, _, _, how_dn) = rows[0], rows[1]
    mix = lambda a, b: (2 * a + b) / 3  # noqa: E731
    kernels.append({
        "name": "quant_matmul", "route": "cuda", "source": QM_SOURCE,
        "replaces": REPLACES["quant_matmul"], "launches": res["launches"],
        "max_abs_err": res["capture_err"], "ms": mix(d_gu, d_dn),
        "plain_ms": mix(p_gu, p_dn), "bound_ms": mix(b_gu, b_dn),
        "bound_by": by, "library_ms": None,
        "timed_by": how_gu if how_gu == how_dn else f"{how_gu}, {how_dn}"})

    # ------------------------------------------------------------ training
    tb, tf = train_modules()
    t0 = time.perf_counter()
    b2_cases, b2_mma = b2_sweep(torch, tb, dev)
    fl_cases, fl_worst, moved = flash_sweep(torch, tf, dev)
    print(f"training sweeps: bbm_dot_scaled and bbm_dot_planes {b2_cases} "
          f"cases bit-equal to their plain versions ({b2_mma} on the "
          f"tensor-core route, the rest on the CUDA-core tile); flash "
          f"kernels {fl_cases} cases within their "
          f"bounds (worst error/bound: flash_attention "
          f"{fl_worst['flash_attention']:.3g}, flash_attention_amm "
          f"{fl_worst['flash_attention_amm']:.3g}; {moved[0]} of {moved[1]} "
          f"P codes moved by float rounding), score products bit-equal, P V "
          f"products bit-equal where P's codes agree, one-hot outputs "
          f"bit-equal ({time.perf_counter() - t0:.1f} s)")
    for shape, e_k, e_p, lim, ctl in flash_precision_control(torch, tf, dev):
        print(f"flash_attention precision at {shape} causal, max error "
              f"against float64: kernel {e_k!r}, plain version (f32) "
              f"{e_p!r}, limit {lim!r} ({PRECISION_FACTOR} x plain); "
              f"controls beyond it: "
              + ", ".join(f"{n} {e!r}" for n, e in ctl.items()))
    counters = {"bbm_dot_scaled": tb.bbm_dot_scaled,
                "bbm_dot_scaled (tensor cores)":
                    MmaLaunches(tb.bbm_dot_scaled),
                "flash_attention": tf.flash_attention,
                "flash_attention_amm": tf.flash_attention_amm,
                "quant_matmul": qm.quant_matmul}
    layers = 24
    t1 = train_run(torch, T1_FLAGS, counters)
    check_train_run("T1", t1, {"bbm_dot_scaled": 3 * layers,
                               "bbm_dot_scaled (tensor cores)": 3 * layers,
                               "flash_attention": 0,
                               "flash_attention_amm": layers,
                               "quant_matmul": 0})
    report_train_run("T1 (bitexact bbm0 WL 16 VBL 13, --amm-attn "
                     "--flash-attn)", t1, counters)
    t2 = train_run(torch, T2_FLAGS, counters)
    check_train_run("T2", t2, {"bbm_dot_scaled": 0,
                               "bbm_dot_scaled (tensor cores)": 0,
                               "flash_attention": layers,
                               "flash_attention_amm": 0, "quant_matmul": 0})
    report_train_run("T2 (amm off, --flash-attn)", t2, counters)
    chk = train_cpu_check(torch, dev)
    print(f"train card vs CPU (2 layers, full width, 256 tokens, T1): loss "
          f"{chk['card']!r} on the card, {chk['cpu']!r} on the CPU "
          f"(tolerance {TRAIN_LOSS_RTOL} relative); every gradient leaf "
          f"within {chk['grad_worst']:.3g} of its largest element "
          f"(tolerance {TRAIN_GRAD_RTOL}; CPU {chk['cpu_s']:.1f} s); the "
          f"first MLP product {chk['shape']} bit-equal")
    entries, lines = train_timing(torch, dev, tb, tf)
    for line in lines:
        print(line)
    runs = {"bbm_dot_scaled": t1, "flash_attention_amm": t1,
            "flash_attention": t2}
    for name in ("bbm_dot_scaled", "flash_attention", "flash_attention_amm"):
        kernels.append(dict({"name": name, "route": "cuda",
                             "source": TRAIN_SOURCES[name],
                             "replaces": REPLACES[name],
                             "launches": runs[name]["totals"][name]},
                            **entries[name]))

    # ------------------------------------------- slice 4: B1 and the faults
    ops = importlib.import_module("repro_torch.kernels.ops")
    t0 = time.perf_counter()
    b1_cases = b1_sweep(torch, tb, dev)
    print(f"B1 sweep: {b1_cases} cases, bbm_matmul_rows, bbm_matmul_dot and "
          f"the plain dot form all bit-equal to the plain rows form "
          f"({time.perf_counter() - t0:.1f} s)")
    b1_counters = {"bbm_matmul_rows": tb.bbm_matmul_rows,
                   "bbm_matmul_dot": tb.bbm_matmul_dot,
                   "bbm_dot_planes": tb.bbm_dot_planes}
    for f in b1_counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    full = b1_full_size(torch, tb, ops, dev)
    fault_full_size(torch, tb, full)
    b1_launches = {name: f.launches for name, f in b1_counters.items()}
    if min(b1_launches.values()) < 1:
        fail(f"a kernel of the B1 main path never launched: {b1_launches}")
    print(f"B1 main path at {B1_SHAPE}, wl 16 vbl 13, both kinds: "
          f"ops.bbm_matmul(shift=15) auto form launched bbm_matmul_rows once "
          f"and bbm_matmul_dot never per call; shift 13 launched "
          f"bbm_matmul_dot, form='rows' bit-equal; both equal to their "
          f"plain versions on 64 sampled rows; bbm0 plane and accumulator "
          f"flips at p=1e-3 bit-equal to the plain version; launches "
          f"{b1_launches} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    gate_cases = fault_gate(torch, tb, dev)
    curves = fault_curves(torch, tb, dev)
    fir_curves = fir_fault_curve(torch, taps_banks, dev)
    poison_gate(dev)
    print(f"fault gate: {gate_cases} cases bit-equal to amm_faulty_ref on "
          f"the card, the disabled spec bit-equal to the unfaulted "
          f"datapath; poison ejection on the card's engine holds "
          f"({time.perf_counter() - t0:.1f} s)")
    for name, curve in curves.items():
        print(f"matmul resilience {name} (rates {FAULT_RATES}), bit-equal "
              f"to the CPU port: relative errors {curve}")
    for name, curve in fir_curves.items():
        print(f"FIR resilience {name} through FilterbankEngine on the card "
              f"(8 channels bit-equal to the CPU port): mean SNR dB {curve}")
    entries, lines = b1_timing(torch, tb, full)
    for line in lines:
        print(line)
    paths = _build.build_all(["bbm_matmul", "bbm_dot", "fir_bank"])
    counts = {name: sass_per_product(paths[lib], part)
              for name, (lib, part) in SASS_KERNELS.items()}
    counts["fir_bank_rows (CUDA-core route)"] = sass_per_product(
        paths["fir_bank"], "fir_bank_rows_kernelILi8ELi0E", per_load=2 / 3)
    print("the CUDA-core routes' compiled inner loops at wl 16, kind 0 "
          "(cuobjdump -sass), instructions per product: " + ", ".join(
              f"{name} " + ("not measured" if c is None else f"{c:.4g}")
              for name, c in counts.items()))
    for name in b1_counters:
        kernels.append(dict({"name": name, "route": "cuda",
                             "source": B1_SOURCES[name],
                             "replaces": B1_REPLACES[name],
                             "launches": b1_launches[name]},
                            **entries[name]))

    # --------------------------------- slice 5: bitexact kv-codes serving
    from repro_torch.serve.kv_cache import memory_report
    t0 = time.perf_counter()
    coded_cases, coded_routes = coded_sweep(torch, tb, dev)
    print(f"coded sweep: {coded_cases} cases ({coded_routes['mma']} on the "
          f"tensor cores, also bit-equal on the CUDA-core kernel through its "
          f"C entry; {coded_routes['tile']} on the CUDA-core route, where "
          f"the tensor cores refuse), bbm_dot_coded_batched bit-equal to "
          f"its plain version (CPU copies): the score and value products, "
          f"bbm0 and bbm1 at WL 16 / VBL 13, S 16-512, bbm0 at VBL 3 (chunks "
          f"of 7 inside a block), int8 codes at WL 8, ragged lengths over "
          f"stale codes and never-written blocks, unit scales, and amm_dot's "
          f"prefill pair (2 slices of ({PREFILL_G}, 64) x (64, "
          f"{PREFILL_LEN}) and ({PREFILL_G}, {PREFILL_LEN}) x "
          f"({PREFILL_LEN}, 64)) ({time.perf_counter() - t0:.1f} s)")
    tile_path = coded_tile_path(torch, tb, dev)
    print(f"the CUDA-core coded route's path: decode attention on the code "
          f"cache at bbm0 WL 16 / VBL 3 ({SERVE_SLOTS} slots x {SERVE_LEN} "
          f"positions): {tile_path}, output finite")
    bx_cfg = bitexact_config()
    res = serve_bitexact(torch, dev, bx_cfg, params, tb)
    st, steps = res["stats"], res["step_ms"]
    print(f"bitexact kv-codes serving: {bx_cfg.name} at full width, bbm0 "
          f"WL 16 VBL 13 apply_to=all, {SERVE_SLOTS} slots, max_len "
          f"{SERVE_LEN}: {len(steps)} pure decode steps of {st['steps']}, "
          f"{st['prefills']} prefills, {res['tokens']} tokens generated "
          f"({res['prompt_tokens']} prompt tokens) in {res['wall_s']:.3f} "
          f"s: {res['tokens'] / res['wall_s']:.6g} generated tokens/s; "
          f"decode step ms p50 {steps[len(steps) // 2]:.3f}, p90 "
          f"{steps[int(len(steps) * 0.9)]:.3f}; launches {res['launches']} "
          f"= (72, 48) x {res['calls']} lm_apply calls, each call checked "
          f"(prefills and decodes); nothing failed; all logits finite; "
          f"weight planes built once in {res['planes_s']:.3f} s")
    rep = memory_report(bx_cfg, SERVE_SLOTS, SERVE_LEN, wl=16)
    print(f"code cache at {SERVE_SLOTS} slots x {SERVE_LEN} positions, WL "
          f"16: codes {rep['code_bytes']} B, scales {rep['scale_bytes']} "
          f"B, bf16 cache {rep['bf16_bytes']} B: ratio_codes "
          f"{rep['ratio_codes']!r}, ratio_total {rep['ratio_total']!r}, "
          f"scale_overhead {rep['scale_overhead']!r}")
    t0 = time.perf_counter()
    cut = bitexact_config(layers=2)
    chk = lm_cpu_check(torch, dev, cut, res["rt"], first_layers(params, 2),
                       kv_codes=True)
    print(f"bitexact card vs CPU (2 layers, full width, kv codes): "
          f"{chk['calls']} lm_apply calls of two requests replayed on the "
          f"CPU port, teacher-forced: worst |logit error| / max|logit| "
          f"{chk['worst']:.4g} (tolerance {LOGIT_RTOL}), greedy tokens "
          f"equal at all {chk['checked']} clear rows "
          f"({time.perf_counter() - t0:.1f} s)")
    coded_rows, lines, empty_ms = coded_timing(torch, tb, dev, res["lens"])
    b2_rows, b2_lines = b2_decode_timing(torch, tb, dev, res["planes"],
                                         params)
    for line in lines + b2_lines:
        print(line)
    from repro_torch.serve import Request, Scheduler
    sched = Scheduler(bx_cfg, res["rt"], params, SERVE_SLOTS, SERVE_LEN,
                      continuous=True, kv_codes=True, device=dev)
    rng = np.random.default_rng(6)
    for i in range(SERVE_SLOTS):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, bx_cfg.vocab, 64).tolist(), max_new=40))
    for _ in range(10):
        sched.step()                 # admit all 8 and warm up
    win, idle = decode_window(torch, sched, "bbm_dot_coded_batched",
                              (CODED_KERNEL,), prefills=SERVE_SLOTS,
                              forbid=(CODED_TILE_KERNEL,))
    for line in win:
        print("bitexact " + line.lstrip())
    mean = lambda key, rows: sum(r[key] for r in rows) / len(rows)  # noqa
    decode = [coded_rows["qk"], coded_rows["pv"]]
    per_launch = lambda key: {k: {"ms": r[key], "bound_ms": r["bound"]}  # noqa
                              for k, r in coded_rows.items()}
    kernels.append({
        "name": "bbm_dot_coded_batched", "route": "cuda",
        "source": CODED_SOURCE, "replaces": CODED_REPLACES,
        "launches": res["launches"]["bbm_dot_coded_batched"],
        "max_abs_err": max(r["err"] for r in coded_rows.values()),
        "ms": mean("ms", decode), "plain_ms": mean("plain_ms", decode),
        "bound_ms": mean("bound", decode),
        "bound_by": coded_rows["qk"]["by"], "library_ms": None,
        "bmm_ms": mean("bmm_ms", decode), "empty_kernel_ms": empty_ms,
        "timed_by": ", ".join(sorted({r["how"] for r in decode})),
        "per_launch": per_launch("ms"), "idle_share": idle})
    kernels.append({
        "name": "bbm_dot_coded_batched (CUDA-core route)", "route": "cuda",
        "source": CODED_TILE_SOURCE, "replaces": CODED_REPLACES,
        "launches": tile_path["launches"],
        "launches_on": "decode attention on the code cache at WL 16 / VBL "
                       "3 (the rule's CUDA-core points)",
        "max_abs_err": max(r["tile_err"] for r in coded_rows.values()),
        "ms": mean("tile_ms", decode), "plain_ms": mean("plain_ms", decode),
        "bound_ms": mean("bound", decode),
        "bound_by": coded_rows["qk"]["by"], "library_ms": None,
        "timed_by": ", ".join(sorted({r["tile_how"] for r in decode})),
        "per_launch": per_launch("tile_ms")})
    mix = lambda key: (2 * b2_rows[0][key] + b2_rows[1][key]) / 3  # noqa
    kernels.append({
        "name": "bbm_dot_scaled (bitexact decode)", "route": "cuda",
        "source": MMA_SOURCE, "replaces": REPLACES["bbm_dot_scaled"],
        "launches": res["launches"]["bbm_dot_scaled"],
        "max_abs_err": max(r["err"] for r in b2_rows),
        "ms": mix("ms"), "plain_ms": mix("plain_ms"),
        "bound_ms": mix("bound"), "bound_by": b2_rows[0]["by"],
        "library_ms": None, "matmul_ms": mix("lib_ms"),
        "timed_by": ", ".join(sorted({r["how"] for r in b2_rows}))})

    # ------------------- slice 6: noise mode's plain branch, the paper
    nm = importlib.import_module("repro_torch.kernels.normal")
    from repro_torch.core import prng
    t0 = time.perf_counter()
    sw = normal_sweep(torch, nm, prng, dev, rt.amm.mu, rt.amm.sigma)
    print(f"normal draw: normal_bits bit-equal to its plain version over "
          f"all {sw['uniforms']} uniforms; normal_draw bit-equal in "
          f"{sw['cases']} cases (shapes {NORMAL_SHAPES}, three keys, the "
          f"draw and both epilogues) ({time.perf_counter() - t0:.1f} s)")
    n_rows = normal_timing(torch, nm, prng, dev, rt.amm.mu, rt.amm.sigma)
    for r in n_rows:
        print(f"normal_draw at {r['shape']} ({r['name']}): {r['ms']:.6f} ms "
              f"({r['how']}), bound {r['bound']:.6f} ms ({r['by']}), bound "
              f"/ time {r['bound'] / r['ms']:.4g}; with the epilogue "
              f"{r['epi_ms']:.6f} ms ({r['epi_how']}), bound "
              f"{r['epi_bound']:.6f} ms ({r['epi_by']}); plain version "
              f"(with the epilogue) on the card {r['plain_ms']:.6f} ms; "
              f"torch.randn at the same "
              f"shape {r['lib_ms']:.6f} ms ({r['lib_how']}; not the same "
              f"function)")
    p_cfg = noise_plain_config()
    p_rt = ModelRuntime.build(p_cfg)
    res_p = noise_plain_path(torch, dev, p_cfg, p_rt, params, nm, qm)
    mean, std = normal_moments(torch, nm, prng, dev)
    steps = res_p["step_ms"]
    p50, p90 = steps[len(steps) // 2], steps[int(len(steps) * 0.9)]
    st = res_p["stats"]
    print(f"noise serving, plain branch: {p_cfg.name} at full width, bbm0 "
          f"WL 16 VBL 13 without the fused kernel, 8 slots: {len(steps)} "
          f"pure decode steps of {st['steps']}, {st['prefills']} prefills, "
          f"{res_p['tokens']} tokens generated ({res_p['prompt_tokens']} "
          f"prompt tokens) in {res_p['wall_s']:.3f} s: "
          f"{res_p['tokens'] / res_p['wall_s']:.6g} generated tokens/s; "
          f"decode step ms p50 {p50:.3f}, p90 {p90:.3f} (the fused kernel's "
          f"path above, this run: p50 {pallas_p50:.3f}, p90 "
          f"{pallas_p90:.3f}, {pallas_tps:.6g} tokens/s); normal_draw "
          f"launches {res_p['launches']} = 72 x {res_p['calls']} lm_apply "
          f"calls, quant_matmul 0; nothing failed; all logits finite; "
          f"{NORMAL_MOMENT_N} draws: mean {mean!r}, std {std!r}")
    t0 = time.perf_counter()
    # the replay on a depth cut: the CPU's plain normal draw emulates each
    # fused multiply-add exactly, in float64, and dominated the phase
    import dataclasses
    chk = lm_cpu_check(torch, dev, dataclasses.replace(
        p_cfg, n_layers=NOISE_CPU_LAYERS), p_rt,
        first_layers(params, NOISE_CPU_LAYERS))
    print(f"noise plain branch card vs CPU (cut to {NOISE_CPU_LAYERS} "
          f"layers): {chk['calls']} lm_apply calls "
          f"of two requests replayed on the CPU port, teacher-forced: worst "
          f"|logit error| / max|logit| {chk['worst']:.4g} (tolerance "
          f"{LOGIT_RTOL}), greedy tokens equal at all {chk['checked']} "
          f"clear rows ({time.perf_counter() - t0:.1f} s)")
    sched = Scheduler(p_cfg, p_rt, params, SERVE_SLOTS, SERVE_LEN,
                      continuous=True, device=dev)
    rng = np.random.default_rng(8)
    for i in range(SERVE_SLOTS):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, p_cfg.vocab, 64).tolist(), max_new=40))
    for _ in range(10):
        sched.step()                 # admit all 8 and warm up
    win, n_idle = decode_window(torch, sched, "normal_draw",
                                (NORMAL_KERNEL,), prefills=SERVE_SLOTS,
                                forbid=QM_KERNELS)
    for line in win:
        print("noise plain " + line.lstrip())
    t0 = time.perf_counter()
    for line in paper_tables(torch, dev):
        print(line)
    print(f"paper tables: {time.perf_counter() - t0:.1f} s")
    dec = n_rows[0]
    kernels.append({
        "name": "normal_draw", "route": "cuda", "source": NORMAL_SOURCE,
        "replaces": NORMAL_REPLACES, "replaces_op": "jax.random.normal",
        "launches": res_p["launches"], "max_abs_err": sw["max_abs_err"],
        "ms": dec["epi_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["epi_bound"], "bound_by": dec["epi_by"],
        "library_ms": None, "randn_ms": dec["lib_ms"],
        "timed_by": dec["epi_how"], "draw_ms": dec["ms"],
        "draw_bound_ms": dec["bound"],
        "prefill": {k: n_rows[1][k] for k in ("ms", "epi_ms", "plain_ms",
                                              "lib_ms", "bound",
                                              "epi_bound")},
        "idle_share": n_idle})

    # --------------------- slice 7: deepseek-v3 (MoE, latent attention)
    # the earlier paths' models and caches go first: the full-width
    # deepseek-v3 cut takes 56 GB of the card's 80
    del params, res, res_p, sched, full
    import gc
    gc.collect()
    t0 = time.perf_counter()
    lines, entries = deepseek_phase(torch, dev, tb, qm, nm, gpu_line())
    for line in lines:
        print(line)
    print(f"deepseek-v3 phase: {time.perf_counter() - t0:.1f} s")
    kernels += entries

    # ------ slice 8: mamba2-370m, zamba2-2.7b (SSM, hybrid), chameleon-34b
    # after the deepseek-v3 phase has freed its 56 GB
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines, entries = ssm_phase(torch, dev, tb, qm, nm, gpu_line())
    for line in lines:
        print(line)
    print(f"slice 8 phase: {time.perf_counter() - t0:.1f} s")
    kernels += entries

    # ---------------------- slice 9: whisper-base (the encoder-decoder)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines, entries = whisper_phase(torch, dev, tb, tf, qm, nm, gpu_line())
    for line in lines:
        print(line)
    print(f"slice 9 phase: {time.perf_counter() - t0:.1f} s")
    kernels += entries

    # ------------- slice 10: training the MoE family, head dims 80 and 128
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines, entries = moe_train_phase(torch, dev, tb, tf, qm, nm)
    for line in lines:
        print(line)
    print(f"slice 10 phase: {time.perf_counter() - t0:.1f} s")
    kernels += entries

    # ------------------------------------ slice 11: the parallel layer
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines, entries = parallel_phase(torch, fk)
    for line in lines:
        print(line)
    print(f"slice 11 phase: {time.perf_counter() - t0:.1f} s")
    kernels += entries

    print(f"gpu: {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
