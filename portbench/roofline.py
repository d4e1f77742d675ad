"""The card's peaks and the work that a kernel's job needs, counted from shapes.

A roofline share is the least time the card could take for the work the
mathematics needs, over the time the kernel took. The work is counted from
the problem's shapes, never from the passes an implementation makes:

- operations: 2 flops for each multiply-add (8 for a complex one), only
  the entries that a mask keeps;
- bytes: every input read once and every output written once.

The least time is the larger of operations over ``PEAK_FLOPS`` and bytes
over ``PEAK_BYTES``. ``PEAK_FLOPS`` is the card's published TF32 tensor
rate: no method that gives f32-accurate products runs faster on an H100,
so a share read against it cannot pass 100% for any implementation of the
same work.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK_FLOPS = 495e12      # TF32 tensor cores
PEAK_BYTES = 3.35e12     # HBM3


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)

    def bound(self) -> str:
        """Which bound binds: "compute" or "memory"."""
        return "compute" if self.flops / PEAK_FLOPS >= self.bytes / PEAK_BYTES else "memory"


def _flops_per_fma(is_complex: bool) -> int:
    return 8 if is_complex else 2


def lower_pairs(m: int) -> int:
    """Entries (r, c) with r >= c of an m x m matrix."""
    return m * (m + 1) // 2


def masked_update(rows, cols, k: int, keep, elem_bytes: int = 4,
                  is_complex: bool = False) -> Work:
    """C[i, j] -= sum_l X[i, l] Y[l, j] on the entries ``keep(rows[i],
    cols[j])`` keeps, C (len(rows), len(cols)), X (len(rows), k) and
    Y (k, len(cols)) read once, the kept entries of C written once. An
    entry-by-entry count, for small shapes (the tests hold the closed forms
    below to it)."""
    kept = sum(1 for r in rows for c in cols if keep(r, c))
    flops = _flops_per_fma(is_complex) * k * kept
    nbytes = elem_bytes * (2 * kept + k * (len(rows) + len(cols)))
    return Work(flops, nbytes)


def cholesky_trailing(n: int, nb: int, elem_bytes: int = 4, is_complex: bool = False) -> Work:
    """The trailing (staircase) updates that a tiled Cholesky of an n x n
    matrix with tiles of nb needs, either triangle: after each tile column
    kt of width w, the stored triangle of the rest (m = n - (kt+1)*nb rows
    and columns, the diagonal tiles' triangles included) takes a rank-w
    update. Bytes: the stored triangle below the first tile read and
    written once, each solved panel (m x w) read once."""
    flops = 0
    panel = 0
    for kt in range(-(-n // nb)):
        w = min(nb, n - kt * nb)
        m = max(0, n - (kt + 1) * nb)
        flops += _flops_per_fma(is_complex) * w * lower_pairs(m)
        panel += m * w
    m0 = max(0, n - nb)
    return Work(flops, elem_bytes * (2 * lower_pairs(m0) + panel))


def band_chase(n: int, b: int, elem_bytes: int = 4, is_complex: bool = False) -> Work:
    """The bulge chase from band b to tridiagonal (stage 2), counted as a
    lower bound: sweeps s = 0..n-3, chases c with first row
    i0 = s + 1 + c*b < n; each chase's reflector (length l = min(b, n - i0))
    updates its l x l Hermitian block from both sides (2l^2 multiply-adds),
    the r x l block below it from the right (r = min(b, n - i0 - b), 2rl),
    and, after the first chase of a sweep, the l x (b - 1) bulge columns
    from the left (2l(b-1)). Bytes: the band (n x (b + 1)) read and written
    once, each reflector and its tau written once."""
    fma = 0
    refl = 0
    for s in range(max(n - 2, 0)):
        c = 0
        while s + 1 + c * b < n:
            i0 = s + 1 + c * b
            ln = min(b, n - i0)
            r = max(0, min(b, n - i0 - b))
            fma += 2 * ln * ln + 2 * r * ln + (2 * ln * (b - 1) if c else 0)
            refl += ln + 1
            c += 1
    band = n * (b + 1)
    return Work(fma * _flops_per_fma(is_complex), elem_bytes * (2 * band + refl))
