"""Helpers of the MoE parity tests: seeded numpy weights, and the routing
each side took, so a logit comparison can tell a routing flip at a
near-tie from a fault.

Why.  Both sides keep a bf16 residual stream: a last-bit difference
upstream can flip one bf16 rounding of a residual element (2^-8 of it),
which moves a router logit by far less than the logits' spread but by
more than the gap between the k-th and the (k+1)-th affinity of a token
that sits at a near-tie.  Such a token then goes to another expert on
one side, and its output, and every later position of its sequence
(through attention and the cache), differ by whole expert outputs.
``RouteLedger`` holds every MoE layer's router logits to a tolerance,
accepts a differing top-k set only where the two sides' affinities
differ by at least the gap that separates the sets on the reference's
side (a flip the perturbation explains), and marks the rest of that
sequence as not comparable.  Everything else is compared as usual; the
number of flips is returned, never hidden.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

import repro.models.transformer as j_tr
import repro_torch.models.transformer as t_tr
from repro_torch.models.moe import moe_route


def numpy_params(table, seed: int):
    """A parameter tree of the reference's ``Spec`` table (``lm_table``),
    drawn in numpy from ``seed`` with the table's inits and scales, in
    sorted-key order."""
    rng = np.random.default_rng(seed)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [draw(v) for v in t]
        if t.init == "zeros":
            return np.zeros(t.shape, np.float32)
        if t.init == "ones":
            return np.ones(t.shape, np.float32)
        scale = t.scale if t.init == "normal" else 1e-3
        return (rng.standard_normal(t.shape) * scale).astype(np.float32)
    return draw(table)


@contextlib.contextmanager
def captured_routes():
    """Within: every MoE layer call of either side's ``lm_apply`` records
    its router logits (T, E) f32 as numpy, in call order, in
    ``log["ref"]`` and ``log["port"]``.  The reference's record is an
    ordered ``jax.debug.callback``, so it also fires inside ``jax.jit``
    and the layer scan (for functions traced within)."""
    log = {"ref": [], "port": []}
    j_orig, t_orig = j_tr.moe_apply, t_tr.moe_apply

    def j_wrap(p, x, cfg, **kw):
        lg = x.reshape(-1, x.shape[-1]).astype(jnp.float32) \
            @ p["router"].astype(jnp.float32)
        jax.debug.callback(lambda v: log["ref"].append(np.asarray(v)), lg,
                           ordered=True)
        return j_orig(p, x, cfg, **kw)

    def t_wrap(p, x, cfg, **kw):
        lg = moe_route(p, x.reshape(-1, x.shape[-1]), cfg)[0]
        log["port"].append(lg.detach().cpu().numpy())
        return t_orig(p, x, cfg, **kw)
    j_tr.moe_apply, t_tr.moe_apply = j_wrap, t_wrap
    try:
        yield log
    finally:
        j_tr.moe_apply, t_tr.moe_apply = j_orig, t_orig


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v.astype(np.float64)))


class RouteLedger:
    """Per sequence (a batch row or a serving slot), the first position a
    routing flip has reached; positions before it are comparable.

    ``layer(ref, port, rows, positions, k)`` takes one MoE layer call's
    router logits on both sides, token t at (rows[t], positions[t]):
    comparable tokens' logits must agree within ``rtol`` of the largest,
    and their top-k sets must agree unless the two sides' affinities on
    that token differ by at least the reference's gap between its k-th
    and (k+1)-th affinity; such a flip is counted and its sequence marked
    from that position on (for the layers after this one and every later
    call).  ``clean(rows, positions)`` says which positions may still be
    compared."""

    def __init__(self, rtol: float):
        self.rtol = rtol
        self.first = {}
        self.flips = 0
        self.tokens = 0

    def reset(self, row) -> None:
        self.first.pop(row, None)

    def clean(self, rows, positions) -> np.ndarray:
        return np.array([p < self.first.get(r, np.inf)
                         for r, p in zip(rows, positions)], bool)

    def layer(self, ref, port, rows, positions, k: int) -> None:
        ok = self.clean(rows, positions)
        ref, port = np.asarray(ref), np.asarray(port)
        assert ref.shape == port.shape == (len(rows), ref.shape[1])
        if not ok.any():
            return
        err = np.abs(ref - port)[ok].max()
        scale = np.abs(ref[ok]).max()
        assert err <= self.rtol * scale, (err, scale)
        pr, pp = _sigmoid(ref), _sigmoid(port)
        # the reference's order: descending, ties to the lower index
        order = np.argsort(-pr, axis=-1, kind="stable")
        want = np.sort(order[:, :k], axis=-1)
        got = np.sort(np.argsort(-pp, axis=-1, kind="stable")[:, :k],
                      axis=-1)
        srt = np.take_along_axis(pr, order, axis=-1)
        gap = srt[:, k - 1] - srt[:, k] if pr.shape[1] > k \
            else np.full(len(rows), np.inf)
        moved = np.abs(pr - pp).max(axis=-1)
        new = {}
        for t in np.flatnonzero(ok):
            self.tokens += 1
            if (want[t] == got[t]).all():
                continue
            assert gap[t] <= 2 * moved[t], (
                f"token {t}: top-{k} {want[t]} vs {got[t]} at a gap of "
                f"{gap[t]} that affinities moved by {moved[t]} cannot flip")
            self.flips += 1
            r = rows[t]
            new[r] = min(new.get(r, np.inf), positions[t])
        for r, p in new.items():
            self.first[r] = min(self.first.get(r, np.inf), p)


def grid(b: int, s: int, pos=0):
    """(rows, positions) of a (B, S) call's flattened tokens at ``pos``
    (a scalar or per-row)."""
    off = np.broadcast_to(np.asarray(pos), (b,))
    rows = np.repeat(np.arange(b), s)
    return rows, (off[:, None] + np.arange(s)[None, :]).reshape(-1)
