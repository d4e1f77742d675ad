"""The one generator of the benchmark's inputs.

A cell's traffic is a closed loop of calls on one matrix: the next call
starts when the previous one has returned and the card is synchronized.
The matrix is made on the device from ``--seed`` by a ``torch.Generator``
on that device, in one draw and a blocked symmetrization, from the
parameters of the cell's file:

    A = (R + R^H) / 2 + diag_shift_sqrt_n * sqrt(n) * I,  R uniform in [-1, 1]

``diag_shift_sqrt_n = 0`` is DLA-Future's random Hermitian matrix (its
eigensolver miniapps' input). DLA-Future's Cholesky miniapp adds 2n to the
diagonal; with that shift all the trailing updates together move an entry
of the factor by some 1e-8 of its largest entry, at f32's rounding, so a
check of the factor could not see a skipped one. A shift of 2 sqrt(n) keeps the matrix positive definite
(the spectrum of (R + R^H)/2 lies within about 0.82 sqrt(n) of 0, so the
condition number is about 2.4) while the updates move the factor at the
scale of its own entries. Same seed, same matrix: every draw is on the
device's generator, in the same order, at the same sizes.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "complex64": torch.complex64, "complex128": torch.complex128}
# rows/columns of the blocks the symmetrization works through (a 4096^2
# f32 temporary is 64 MiB)
SYM_BLOCK = 4096


def make_matrix(params: dict, seed: int, device) -> torch.Tensor:
    """The cell's input matrix: ``params`` gives ``n``, ``dtype`` and
    ``diag_shift_sqrt_n``."""
    n = int(params["n"])
    dtype = DTYPES[params["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    real = torch.float32 if dtype in (torch.float32, torch.complex64) else torch.float64
    r = torch.rand((n, n), generator=gen, dtype=real, device=device).mul_(2).sub_(1)
    if dtype.is_complex:
        im = torch.rand((n, n), generator=gen, dtype=real, device=device).mul_(2).sub_(1)
        r = torch.complex(r, im)
        del im
    for i0 in range(0, n, SYM_BLOCK):
        i1 = min(i0 + SYM_BLOCK, n)
        for j0 in range(i0, n, SYM_BLOCK):
            j1 = min(j0 + SYM_BLOCK, n)
            upper, lower = r[i0:i1, j0:j1], r[j0:j1, i0:i1]
            t = (upper + lower.mH) / 2
            upper.copy_(t)
            lower.copy_(t.mH)
    shift = float(params.get("diag_shift_sqrt_n", 0.0)) * math.sqrt(n)
    if shift:
        r.diagonal().add_(shift)
    return r


def sample_index(seed: int, sample_calls: int) -> int:
    """Which call of the window the output check judges: drawn from the
    seed among the first ``sample_calls``, which every window holds."""
    return int(torch.randint(sample_calls, (1,),
                             generator=torch.Generator().manual_seed(int(seed) % 2**63 + 1)))
