"""Serving launcher: batched greedy decoding with the slot scheduler.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced \
        --requests 6 --max-new 16 --amm noise [--amm-pallas]

    python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced \
        --amm bitexact --amm-attn --kv-codes --continuous

    python -m repro_torch.launch.serve --arch zamba2-2.7b --reduced \
        --amm noise --amm-pallas --continuous

Counterpart of ``repro.launch.serve`` with the same flags.  It runs on
the GPU (``--device cpu`` runs the kernels' plain versions).  The
parameters are random, from a seeded generator.

``--amm noise`` quantizes every MLP product to WL-bit codes and adds the
calibrated noise of the multiplier ``--mul`` at ``--vbl`` (characterized
on the device at start-up): bare, as the reference's default noise path,
an f32 matmul of the codes and ``jax.random.normal``'s draws from each
layer's key (the ``normal_draw`` kernel); with ``--amm-pallas``, the
fused ``quant_matmul`` kernel and its counter-hash noise.
``--amm bitexact`` serves through the Broken-Booth datapath
(the ``bbm_dot_scaled`` kernel), its weight codes precoded once here and
carried by the step functions; ``--amm-attn`` widens it to the attention
score and value products (bare: MLPs and attention; ``attn``: attention
only).  ``--kv-codes`` stores the KV cache as WL-bit codes plus
per-block f32 scales, decoded straight from the codes
(``bbm_dot_coded_batched``); it needs ``--amm bitexact``, a Booth-family
``--mul`` and ``--amm-attn``.  ``--continuous`` switches the Scheduler
to continuous batching.  The SSM (``mamba2-370m``) and hybrid
(``zamba2-2.7b``) archs serve from their scan and conv state (and the
hybrid's shared-block KV cache); ``--kv-codes`` is refused for them, as
the reference refuses it (the code cache holds attention K/V only), and
a continuous-mode prompt longer than ``ssm_chunk`` that is not a
multiple of it fails its request, as in the reference (ROADMAP C11).
The reference's ``--flash-attn`` is left out: under the Scheduler every
call carries a cache, so it changes nothing there (ROADMAP C3).
``--arch whisper-base`` is refused: an encoder-decoder model needs its
frame embeddings in every call, which the Scheduler does not pass (the
reference's launcher reaches ``lm_apply``'s assert); serve it through
``serve.make_serve_fns`` with ``encoder_embeds``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from ..configs import ARCH_NAMES, get_arch, reduced
from ..configs.base import AmmConfig
from ..device import resolve_device
from ..models import ModelRuntime, lm_init
from ..serve.engine import Request, Scheduler, make_serve_fns
from . import (add_amm_attn_arg, resolve_amm_apply_to, validate_amm_args,
               validate_serve_flags)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve random-weight LM requests with the slot "
                    "scheduler, on the GPU unless --device cpu.",
        epilog="The reference's --flash-attn is left out: under the "
               "Scheduler every call carries a KV cache, so the flag "
               "changes nothing there (ROADMAP C3).")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--amm", choices=["off", "noise", "bitexact"],
                    default="off")
    ap.add_argument("--mul", default="bbm0")
    ap.add_argument("--wl", type=int, default=16)
    ap.add_argument("--vbl", type=int, default=13)
    ap.add_argument("--amm-pallas", action="store_true",
                    help="mode=noise: the fused quant_matmul CUDA kernel")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: per-step admission into "
                         "free slots, per-request eviction, prefill on "
                         "batch-1 slot slices")
    ap.add_argument("--kv-codes", action="store_true",
                    help="store the KV cache as wl-bit int codes + "
                         "per-block f32 scales; needs --amm bitexact with "
                         "a Booth-family --mul and --amm-attn")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    add_amm_attn_arg(ap)
    args = ap.parse_args(argv)
    apply_to = resolve_amm_apply_to(ap, args)
    validate_amm_args(ap, args)
    validate_serve_flags(ap, args)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if cfg.is_encoder_decoder:
        ap.error(f"--arch {args.arch} is an encoder-decoder model: every "
                 f"call needs its frame embeddings, which the Scheduler "
                 f"does not pass (the reference's launcher fails lm_apply's "
                 f"assert on it); serve it through make_serve_fns with "
                 f"encoder_embeds")
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(
        cfg, amm=AmmConfig(mode=args.amm, mul=args.mul, wl=args.wl,
                           param=args.vbl, use_pallas=args.amm_pallas,
                           apply_to=apply_to))
    rt = ModelRuntime.build(cfg, device=dev)
    params = lm_init(cfg, 0, device=dev)
    # the bitexact weight precode happens once, here; the step functions
    # carry it, so every token after pays the contractions only
    planes = rt.build_planes(cfg, params)
    prefill_fn, decode_fn = make_serve_fns(cfg, rt, amm_planes=planes,
                                           kv_codes=args.kv_codes)
    sched = Scheduler(cfg, rt, params, args.slots, args.max_len,
                      decode_fn=decode_fn,
                      prefill_fn=prefill_fn if args.continuous else None,
                      continuous=args.continuous, kv_codes=args.kv_codes,
                      device=dev)

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
        sched.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    t0 = time.perf_counter()
    steps = 0
    while sched.step():
        steps += 1
    dt = time.perf_counter() - t0
    print(f"[serve] {args.requests} requests in {steps} decode steps, "
          f"{dt:.2f}s on {dev}")
    return steps


if __name__ == "__main__":
    main()
