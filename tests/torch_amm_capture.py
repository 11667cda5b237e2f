"""What a chunked amm attention run formed, in the layout of
``flash_attention_amm``'s residuals, for ``flash_amm_compare``.

``chunked_attention(amm=...)`` calls ``amm_dot`` twice per (q-block,
kv-block) step, in order: the score product ``qg @ k^T`` and the value
product ``p @ v``, each on (batch, kv-head) slices with the query heads
of a group folded into the rows.  A record of each call's operands and
approximate product is enough to rebuild every tile's approximate scores,
P's codes and scale (P is quantized per slice, as ``amm_dot`` does), and
approximate P V product.  Torch only: the records may come from the port
(``port_amm_dot_records``) or, as numpy arrays, from the reference.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels.flash_attention import quantize_blocks
from repro_torch.models import attention as t_attn


@contextlib.contextmanager
def port_amm_dot_records():
    """Record (a, b, approximate product) of every ``amm_dot`` call the
    port's ``chunked_attention`` makes; the calls return what they
    would."""
    recs = []
    orig = t_attn.amm_dot

    def spy(a, b, rt, *, oracle=False, ste=True):
        approx = orig(a, b, rt, oracle=oracle, ste=False)
        recs.append((a.detach().clone(), b.detach().clone(), approx))
        return orig(a, b, rt, oracle=oracle, ste=ste)

    t_attn.amm_dot = spy
    try:
        yield recs
    finally:
        t_attn.amm_dot = orig


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def chunked_residuals(recs, shape, out, *, wl: int, bq: int, bk: int,
                      kv_len=None):
    """(ops, run, q_pos) for ``flash_amm_compare`` from one chunked run.

    shape: (B, Sq, H, D, Skv, KV), the run's operand shapes; out: its
    (B, Sq, H, D) output.  Rows are (batch*kv-head, q-block, group, row);
    a P tile is the ``groups * bq`` rows of one (q-block, kv-block).
    """
    b, sq, h, d, skv, kvh = shape
    groups = h // kvh
    bq, bk = min(bq, sq), min(bk, skv)
    nq, nk = -(-sq // bq), -(-skv // bk)
    g, rq = b * kvh, groups * bq
    recs = [tuple(_t(x) for x in rec) for rec in recs]
    if len(recs) != 2 * nq * nk:
        raise ValueError(f"{len(recs)} amm_dot calls, expected {2 * nq * nk}")
    score = lambda qi, kj: recs[2 * (qi * nk + kj)]           # noqa: E731
    value = lambda qi, kj: recs[2 * (qi * nk + kj) + 1]       # noqa: E731
    qf = torch.cat([score(qi, 0)[0].reshape(g, rq, d) for qi in range(nq)],
                   dim=1)
    kf = torch.cat([score(0, kj)[1].transpose(-1, -2).reshape(g, bk, d)
                    for kj in range(nk)], dim=1)
    vf = torch.cat([value(0, kj)[1].reshape(g, bk, -1) for kj in range(nk)],
                   dim=1)
    dv = vf.shape[-1]
    vc, vs = quantize_blocks(vf.reshape(g, nk, bk, dv), wl)
    dev = qf.device
    s = torch.zeros((g, nq * rq, nk * bk), device=dev)
    pc = torch.zeros((g, nq * rq, nk * bk), dtype=torch.int16, device=dev)
    ps = torch.zeros((g, nq, nk), device=dev)
    pv = torch.zeros((g, nk, nq * rq, dv), device=dev)
    for qi in range(nq):
        rows = slice(qi * rq, (qi + 1) * rq)
        for kj in range(nk):
            cols = slice(kj * bk, (kj + 1) * bk)
            s[:, rows, cols] = score(qi, kj)[2].reshape(g, rq, bk)
            p, _, approx = value(qi, kj)
            codes, scale = quantize_blocks(p.reshape(g, rq, bk), wl)
            pc[:, rows, cols] = codes.to(torch.int16)
            ps[:, qi, kj] = scale.reshape(g)
            pv[:, kj, rows] = approx.reshape(g, rq, dv)
    q_pos = (torch.arange(nq)[:, None, None] * bq
             + torch.zeros(groups, dtype=torch.int64)[None, :, None]
             + torch.arange(bq)[None, None, :]).reshape(-1)
    out = torch.nn.functional.pad(_t(out).to(dev), (0, 0, 0, 0, 0,
                                                    nq * bq - sq))
    out = out.reshape(b, nq, bq, kvh, groups, dv).permute(
        0, 3, 1, 4, 2, 5).reshape(g, nq * rq, dv)
    ops = {"qf": qf, "kf": kf, "vf": vf,
           "vc": vc.reshape(g, nk * bk, dv), "vs": vs.reshape(g, nk),
           "bq": rq, "bk": bk, "skv": skv if kv_len is None else kv_len}
    return ops, {"out": out, "s": s, "pc": pc, "ps": ps, "pv": pv}, q_pos
