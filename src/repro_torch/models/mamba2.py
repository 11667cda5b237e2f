"""Mamba2 SSD (state-space duality) block, chunked matmul formulation.

Counterpart of ``repro.models.mamba2`` (Dao & Gu, arXiv:2405.21060):
within a chunk of length Q the output is an attention-like masked
product; across chunks a (H, P, N) state is carried by a linear
recurrence, here a loop over the chunks where the reference scans them.
``ssd_reference`` is the sequential per-step oracle and
``ssd_decode_step`` the one-token serving update.

Shapes: x (B, L, H, P) values; dt (B, L, H) positive step sizes;
A (H,) negative decay rates; B_, C_ (B, L, G, N) in/out projections
(G groups broadcast over H); D (H,) skip.

The dtypes are the reference's: the projections are f32 products (the
block's input is the rmsnorm of the bf16 residual stream, promoted by
the f32 norm weight), the scan runs in f32, and ``y`` is cast to the
block input's dtype before its gate.  The scan is plain
PyTorch on every device: the reference's is XLA, not a kernel.

A prompt longer than ``ssm_chunk`` must be a multiple of it, as in the
reference, which asserts it (ROADMAP C11); ``ssd_chunked`` raises
``ValueError`` there.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..device import pin_fp32
from .common import Spec, rmsnorm

__all__ = ["mamba_table", "mamba_apply", "mamba_decode_step",
           "ssd_chunked", "ssd_reference", "ssd_decode_step"]


# ------------------------------------------------------------------ params
def mamba_table(cfg: ArchConfig) -> Dict[str, Spec]:
    d, di = cfg.d_model, cfg.d_inner
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * g * n
    return {
        "in_proj": Spec((d, 2 * di + 2 * g * n + h), ("embed", "ssm_inner")),
        "conv_w": Spec((cfg.ssm_conv, conv_dim), ("conv", "ssm_inner"),
                       "normal", 0.2),
        "conv_b": Spec((conv_dim,), ("ssm_inner",), "zeros"),
        "a_log": Spec((h,), ("ssm_heads",), "ones"),
        "dt_bias": Spec((h,), ("ssm_heads",), "zeros"),
        "d_skip": Spec((h,), ("ssm_heads",), "ones"),
        "norm_w": Spec((di,), ("ssm_inner",), "ones"),
        "out_proj": Spec((di, d), ("ssm_inner", "embed")),
    }


# ------------------------------------------------------------------- SSD
def ssd_chunked(x, dt, A, B_, C_, D, *, chunk: int):
    """Chunked SSD scan.  Returns (y, final_state (B, H, P, N)).

    The sequence must be at most one chunk or a whole number of them."""
    b, l, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    nc = l // q
    rep = h // g

    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    br = torch.repeat_interleave(B_.reshape(b, nc, q, g, n), rep, dim=3)
    cr = torch.repeat_interleave(C_.reshape(b, nc, q, g, n), rep, dim=3)

    dA = dtr * A                                               # (b,nc,q,h)
    cum = torch.cumsum(dA, dim=2)                              # within chunk

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j.  Above the
    # diagonal exp overflows to inf, so it is selected away, not masked
    # by a product (inf * 0 is NaN)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (b,nc,q,q,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = torch.where(mask[None, None, :, :, None], torch.exp(li),
                       torch.zeros((), dtype=li.dtype, device=x.device))
    scores = torch.einsum("bcihn,bcjhn->bcijh", cr, br)
    w = scores * lmat * dtr[:, :, None, :, :]                  # dt_j weight
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xr)

    # chunk states: S_c = sum_j exp(cumQ - cum_j) dt_j B_j (x) x_j
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)             # (b,nc,q,h)
    sb = br * (decay_end * dtr)[..., None]
    s_c = torch.einsum("bcjhn,bcjhp->bchpn", sb, xr)           # (b,nc,h,p,n)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (b,nc,h)

    # inter-chunk recurrence: each chunk sees the state before it
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + s_c[:, c]
    h_prev = torch.stack(prev, dim=1)                          # (b,nc,h,p,n)

    # inter-chunk output: C_i . (h_prev * decay_to_i)
    dec_in = torch.exp(cum)
    y_inter = torch.einsum("bcihn,bchpn->bcihp", cr * dec_in[..., None],
                           h_prev)

    y = (y_intra + y_inter).reshape(b, l, h, p)
    y = y + x * D[None, None, :, None]
    return y, hstate


def ssd_reference(x, dt, A, B_, C_, D):
    """Sequential per-step oracle: h_t = h_{t-1} exp(dt_t A) + dt_t B_t x_t."""
    b, l, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    rep = h // g
    br = torch.repeat_interleave(B_, rep, dim=2)
    cr = torch.repeat_interleave(C_, rep, dim=2)
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        dec = torch.exp(dt[:, t] * A)                          # (b,h)
        hstate = (hstate * dec[..., None, None]
                  + torch.einsum("bhn,bhp->bhpn",
                                 br[:, t] * dt[:, t, :, None], x[:, t]))
        ys.append(torch.einsum("bhn,bhpn->bhp", cr[:, t], hstate))
    y = torch.stack(ys, dim=1)
    return y + x * D[None, None, :, None]


def ssd_decode_step(state, xt, dtt, A, bt, ct, D):
    """One-token state update.  state (B,H,P,N) -> (y_t, new_state)."""
    dec = torch.exp(dtt * A)
    new = (state * dec[..., None, None]
           + torch.einsum("bhn,bhp->bhpn", bt * dtt[..., None], xt))
    y = torch.einsum("bhn,bhpn->bhp", ct, new) + xt * D[None, :, None]
    return y, new


# ------------------------------------------------------------ full block
def _silu(v):
    """``jax.nn.silu``: v * sigmoid(v)."""
    return v * torch.sigmoid(v)


def _softplus(v):
    """``jax.nn.softplus``: logaddexp(v, 0), without torch's threshold."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _causal_conv(xbc, w, b_, conv_state=None):
    """Depthwise causal conv over (B, L, C) with kernel (K, C).

    conv_state: (B, K-1, C) history for decode; returns (y, new_state),
    the new state in the promoted dtype of the history and the input (a
    bf16 history and an f32 input give f32, as in the reference)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([conv_state, xbc], dim=1)
    new_state = pad[:, -(k - 1):] if k > 1 else None
    y = sum(pad[:, i:i + xbc.shape[1]] * w[i] for i in range(k))
    return _silu(y + b_), new_state


def _split_proj(proj, cfg: ArchConfig):
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * g * n]
    dt_raw = proj[..., -h:]
    return z, xbc, dt_raw


def mamba_apply(p, x, cfg: ArchConfig, *, state=None, conv_state=None):
    """Full Mamba2 block.  x: (B, S, d_model).

    Training and prefill: no state, the chunked scan from zero (a
    multi-token call with a state is a prefill into an empty cache, as in
    the reference).  Decode: pass (state, conv_state) with S == 1.
    Returns (y, (new_state, new_conv_state)), both new tensors.
    """
    pin_fp32()
    b, s, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_headdim
    if state is not None and s > 1:
        state, conv_state = None, None
    proj = x @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc[..., :di].reshape(b, s, h, pdim)
    b_ = xbc[..., di:di + g * n].reshape(b, s, g, n)
    c_ = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = _softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["a_log"].to(torch.float32))
    f32 = torch.float32
    if state is None:
        y, new_state = ssd_chunked(xs.to(f32), dt.to(f32), A, b_.to(f32),
                                   c_.to(f32), p["d_skip"].to(f32),
                                   chunk=min(cfg.ssm_chunk, s))
    else:
        rep = h // g
        bt = torch.repeat_interleave(b_[:, 0], rep, dim=1)
        ct = torch.repeat_interleave(c_[:, 0], rep, dim=1)
        y1, new_state = ssd_decode_step(
            state, xs[:, 0].to(f32), dt[:, 0].to(f32), A, bt.to(f32),
            ct.to(f32), p["d_skip"].to(f32))
        y = y1[:, None]
    y = y.reshape(b, s, di).to(x.dtype)
    # gated RMSNorm (mamba2 style)
    y = rmsnorm(y * _silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], (new_state, new_conv)


def mamba_decode_step(p, x, cfg, state, conv_state):
    return mamba_apply(p, x, cfg, state=state, conv_state=conv_state)
