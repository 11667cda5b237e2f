"""Training launcher: the fault-tolerant loop on one device.

    python -m repro_torch.launch.train --reduced --device cpu \
        --amm bitexact --amm-attn --flash-attn --steps 2

Counterpart of ``repro.launch.train`` with the same flags.  It runs on
the GPU (``--device cpu`` runs the kernels' plain versions).  ``--amm
bitexact`` puts every MLP product on the Broken-Booth dot form (the
``bbm_dot_scaled`` kernel); ``--amm-attn`` adds the attention products,
which with ``--flash-attn`` run in the ``flash_attention_amm`` kernel;
``--flash-attn`` alone runs the exact ``flash_attention`` kernel;
``--amm noise`` quantizes every MLP product and adds the multiplier's
calibrated noise: bare, an f32 matmul of the codes and
``jax.random.normal``'s draws from each step's and layer's key (the
``normal_draw`` kernel), with ``--amm-pallas`` the fused
``quant_matmul`` kernel.  The
parameters are random, from a seeded generator.  Data and checkpoints as
in the reference: the deterministic synthetic pipeline, a checkpoint
directory that the loop resumes from (pass a fresh ``--ckpt-dir`` to
start over).  An encoder-decoder arch (``whisper-base``) is fed the
reference's frame embeddings: zeros, f32, (batch, encoder_len, d_model),
at every step.  A MoE arch (grok-1-314b, deepseek-v3-671b) trains on
``lm_loss``'s load-balance term and, for deepseek-v3, its MTP block.  A
mesh other than 1 x 1 is the sharded step, ROADMAP A13b.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile

import torch

from ..configs import ARCH_NAMES, get_arch, reduced
from ..configs.base import AmmConfig
from ..core import prng
from ..data.pipeline import DataConfig, batches
from ..device import resolve_device
from ..models import ModelRuntime, lm_init
from ..train.loop import LoopConfig, train_loop
from ..train.optimizer import OptConfig, init_opt
from ..train.trainstep import TrainConfig, make_train_step
from . import add_amm_attn_arg, resolve_amm_apply_to, validate_amm_args

_MESH = "a sharded train step is ROADMAP item A13b"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a random-weight LM with the fault-tolerant "
                    "loop, on the GPU unless --device cpu.")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--amm", choices=["off", "noise", "bitexact"],
                    default="off")
    ap.add_argument("--mul", default="bbm0")
    ap.add_argument("--wl", type=int, default=16)
    ap.add_argument("--vbl", type=int, default=13)
    ap.add_argument("--amm-pallas", action="store_true",
                    help="mode=noise: the fused quant_matmul CUDA kernel; "
                         "mode=bitexact needs no flag")
    ap.add_argument("--flash-attn", action="store_true",
                    help="attention through the flash kernels (exact, or "
                         "flash-amm when --amm-attn makes attention "
                         "amm-active); the exact kernel's gradient is the "
                         "exact blockwise attention's, and with --amm-attn "
                         "the backward is the reference's straight-through "
                         "gradient of the chunked schedule at the flash "
                         "tiles")
    add_amm_attn_arg(ap)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    apply_to = resolve_amm_apply_to(ap, args)
    validate_amm_args(ap, args)
    if (args.mesh_data, args.mesh_model) != (1, 1):
        raise NotImplementedError(f"--mesh-data {args.mesh_data} "
                                  f"--mesh-model {args.mesh_model}: {_MESH}")
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(
        cfg, amm=AmmConfig(mode=args.amm, mul=args.mul, wl=args.wl,
                           param=args.vbl, use_pallas=args.amm_pallas,
                           apply_to=apply_to))
    rt = ModelRuntime.build(cfg, use_pallas=args.flash_attn, device=dev)
    tc = TrainConfig(microbatches=args.microbatches,
                     opt=OptConfig(lr=args.lr, total_steps=args.steps))
    step_fn = make_train_step(cfg, rt, tc)
    params = lm_init(cfg, 0, device=dev, dtype=tc.param_dtype)
    opt = init_opt(params, tc.opt)

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    lc = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir)
    if cfg.is_encoder_decoder:
        enc = torch.zeros((args.batch, cfg.encoder_len, cfg.d_model),
                          dtype=torch.float32, device=dev)
        step_fn = functools.partial(step_fn, encoder_embeds=enc)

    def data_iter(start):
        for toks, labels, step in batches(dc, start):
            yield (torch.from_numpy(toks).to(dev),
                   torch.from_numpy(labels).to(dev), step)

    params, opt, hist = train_loop(step_fn, params, opt, data_iter, lc,
                                   rng=prng.key(42))
    if hist:
        print(f"[train] done: {len(hist)} steps on {dev}, final loss "
              f"{hist[-1]['loss']:.4f}, stragglers flagged: "
              f"{sum(h['straggler'] for h in hist)}")
    else:
        print(f"[train] nothing to do: {args.ckpt_dir} already holds step "
              f"{args.steps - 1}")
    return hist


if __name__ == "__main__":
    main()
