"""Dot-level reference simulators (python ints, arbitrary precision).

Counterpart of ``repro.core.ref_sim``, the same functions.  They build
the partial-product dot diagram of each multiplier literally, row by
row and bit by bit with hardware sign-extension semantics, apply the
breaking/nullification to individual dots, and sum columns: the oracles
the port's closed forms (``core.bbm``, ``core.bam``, ``core.kulkarni``)
are tested against, and the big-int path for unsigned word lengths whose
products overflow int32.

Slow and scalar on purpose.
"""
from __future__ import annotations

__all__ = [
    "booth_rows_ref",
    "bbm_ref",
    "bam_ref",
    "kulkarni_ref",
]


def _signed(x: int, wl: int) -> int:
    x &= (1 << wl) - 1
    return x - (1 << wl) if x >= (1 << (wl - 1)) else x


def booth_rows_ref(a: int, b: int, wl: int):
    """Radix-4 Booth rows of the dot diagram as (row_bits, neg, shift) lists.

    row_bits is the value of the row *without* the S increment, represented
    as an infinite-precision two's-complement integer (sign extension
    implicit); for negative rows this is the one's complement -(mag*A)-1.
    """
    assert wl % 2 == 0
    a_s = _signed(a, wl)
    bu = b & ((1 << wl) - 1)
    rows = []
    prev = 0
    for i in range(wl // 2):
        b0 = (bu >> (2 * i)) & 1
        b1 = (bu >> (2 * i + 1)) & 1
        bm1 = prev
        prev = b1
        d = -2 * b1 + b0 + bm1
        neg = b1
        mag = abs(d)
        ones_comp = -(mag * a_s) - 1 if neg else mag * a_s
        rows.append((ones_comp, neg, 2 * i))
    return rows


def _floor_clear(x: int, m: int) -> int:
    """Zero the low m bits of an infinite two's-complement integer."""
    return (x >> m) << m


def bbm_ref(a: int, b: int, wl: int, vbl: int, kind: int) -> int:
    """Dot-level Broken-Booth product (python ints)."""
    rows = booth_rows_ref(a, b, wl)
    total = 0
    for ones_comp, neg, shift in rows:
        m = max(0, vbl - shift)
        if kind == 0:
            # two's complement formed first (+1 folded in), then broken
            full = ones_comp + 1 if neg else ones_comp
            total += _floor_clear(full, m) << shift
        elif kind == 1:
            # broken first; S dot at column `shift` dropped if shift < vbl
            t = _floor_clear(ones_comp, m)
            s = neg if m == 0 else 0
            total += (t + s) << shift
        else:
            raise ValueError(kind)
    return total


def bam_ref(a: int, b: int, wl: int, vbl: int, hbl: int = 0) -> int:
    """Dot-level BAM product (unsigned)."""
    au = a & ((1 << wl) - 1)
    bu = b & ((1 << wl) - 1)
    total = 0
    for i in range(wl):          # rows
        if i < hbl:
            continue
        if not (bu >> i) & 1:
            continue
        for j in range(wl):      # dots
            if i + j < vbl:
                continue
            if (au >> j) & 1:
                total += 1 << (i + j)
    return total


def _m2x2(x: int, y: int, approx: bool) -> int:
    if approx and x == 3 and y == 3:
        return 7
    return x * y


def kulkarni_ref(a: int, b: int, wl: int, k: int = 0) -> int:
    """Block-level Kulkarni product (unsigned) with the paper's K line."""
    assert wl % 2 == 0
    n = wl // 2
    au = a & ((1 << wl) - 1)
    bu = b & ((1 << wl) - 1)
    total = 0
    for i in range(n):
        for j in range(n):
            ai = (au >> (2 * i)) & 3
            bj = (bu >> (2 * j)) & 3
            col = 2 * (i + j)
            total += _m2x2(ai, bj, col + 3 < k) << col
    return total
