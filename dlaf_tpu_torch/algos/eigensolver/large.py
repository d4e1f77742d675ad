"""Memory-planned local eigensolver for contract-scale problems.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.large`.
``eigh_large`` runs the five stages of :func:`driver.eigh` (reference
``Eigensolver<B,D,T>::call``, ``eigensolver/eigensolver/impl.h:38-95``) as
separate steps with a plan for device memory. The JAX plan was made for a
16 GB chip (the reflector record re-chased in sweep chunks, a j-chunked top
merge, a raw record layout); this one is derived for the 80 GB of an H100.
At n = 32768 f32, band 128 one n x n buffer is 4 GiB:

  1. reduction_to_band: the hermitian working copy ``packed`` (``a`` is
     read, not written) and one n^2 product temporary per panel;
  2. strips from ``packed`` (O(n b)); one chase (kernel K3 on the card)
     gives (d, e) and, with ``rec_chunks == 1``, the whole reflector
     record: (n - 1) x 256 x 128 f32 = 4.3 GB, kept for stage 4, so nothing
     is chased twice;
  3. tridiagonal D&C: its top merge holds about five n^2 tables;
  4. stage-2 back-transform on the 1-row-SHIFTED eigenvector buffer
     (n + 2b rows), in place, through the streaming kernels K4 and K5
     (:mod:`dlaf_tpu_torch.ops.kernels.bt_apply`) for f32 with
     group size == band; the record is dropped right after;
  5. stage-1 back-transform.

With ``rec_chunks > 1`` stage 2 records nothing and stage 4 re-chases the
band once per sweep chunk, in descending chunk order, recording only that
chunk (K3's ``sweep_lo``/``sweep_chunk``): a chunked record is bit-equal to
the same rows of the full one, so both plans apply the same reflectors.
Complex input takes the cooked grouped apply with the phases of the real
tridiagonal folded into the eigenvectors, as in the JAX function.
"""
from __future__ import annotations

import contextlib

import torch

from ... import spans
from ...ops.kernels import _build
from ...ops.kernels.band2tridiag import band_to_tridiag_strips_kernel, chaser_feasible
from ...ops.kernels.bt_apply import bt_apply_feasible
from ...tune import get_tune_parameters
from .band_strips import band_to_tridiag_strips, packed_to_strips
from .bt import bt_band_to_tridiag, bt_reduction_to_band
from .driver import _phase_normalize, get_band_size
from .red2band import reduction_to_band
from .tridiag_dc import tridiag_eigh

# the largest device memory allocated during each stage of the last
# eigh_large(timers=True) call on a CUDA tensor, in bytes (empty otherwise)
stage_peak_bytes: dict[str, int] = {}


def _use_shifted_apply(b: int, gsz: int, dtype) -> bool:
    """Whether stage 4 takes the streaming apply (K4/K5 on the card, their
    plain versions on the CPU): f32, group size == band and a band the
    kernels take. The device does not enter."""
    return dtype == torch.float32 and gsz == b and bt_apply_feasible(b, dtype)


def _chase(strips, n: int, b: int, sweep_lo: int, sweep_chunk: int):
    """One full bulge chase over strip storage, recording only sweeps
    [sweep_lo, sweep_lo + sweep_chunk): kernel K3 on a CUDA tensor it takes,
    the plain strip chase on other CUDA tensors (f64, complex128), K3's
    plain version on the CPU. Returns (d, e, vs, taus), the record cooked
    (unit heads, zeros where no chase runs)."""
    if _build.on_cuda(strips) and not chaser_feasible(b, strips.dtype):
        return band_to_tridiag_strips(strips, n, b, sweep_lo, sweep_chunk)
    return band_to_tridiag_strips_kernel(strips, n, b, sweep_lo, sweep_chunk)


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def eigh_large(a, band: int | None = None, rec_chunks: int = 1, timers: bool = False):
    """Eigendecomposition of hermitian ``a`` (lower triangle referenced),
    staged for a small peak of device memory. ``a`` is not written.

    Returns (w, v), or (w, v, stage_seconds) with ``timers``, as
    :func:`driver.eigh` does (eigenvalues ascending, eigenvectors in
    columns). Each stage is a span ``eigh_large.<stage>`` of the recorder
    (:mod:`dlaf_tpu_torch.spans`), stage 4's re-chases and applies spans
    inside it; ``timers`` records them whether or not the recorder is on,
    ends each with a synchronization and returns their seconds, and, on a
    CUDA tensor, :data:`stage_peak_bytes` holds each stage's peak of
    allocated memory. Needs n divisible by the band and n > band (general
    shapes go through ``driver.eigh``).
    """
    tune = get_tune_parameters()
    n = a.shape[0]
    b = band or get_band_size(tune.default_block_size)
    gsz = tune.bt_band_to_tridiag_hh_apply_group_size
    if n % b or n <= b:
        raise ValueError(f"eigh_large needs n % band == 0 and n > band "
                         f"(n={n}, band={b}); use driver.eigh")
    if rec_chunks < 1:
        raise ValueError(f"rec_chunks must be >= 1, got {rec_chunks}")
    cplx = a.is_complex()
    nsweeps = n - 2
    # chunk length: a multiple of the WY group size, so that the chunked
    # application reproduces the unchunked descending order exactly
    per_chunk = -(-nsweeps // rec_chunks)
    chunk = -(-per_chunk // gsz) * gsz
    nchunks = -(-nsweeps // chunk)
    on_card = a.device.type == "cuda"
    if timers:
        stage_peak_bytes.clear()

    @contextlib.contextmanager
    def stage(name, part=False):
        """The span ``eigh_large.<name>``; with ``timers`` it ends with a
        synchronization and, on the card, a stage (not a ``part`` of stage
        4, whose peak is stage 4's) records its peak of allocated memory."""
        if timers and on_card and not part:
            torch.cuda.reset_peak_memory_stats(a.device)
        with spans.span(f"eigh_large.{name}"):
            yield
            if timers:
                _sync(a)
        if timers and on_card and not part:
            stage_peak_bytes[name] = torch.cuda.max_memory_allocated(a.device)

    with spans.collect() if timers else contextlib.nullcontext([]) as recs:
        # ---- stage 1: reduction to band -----------------------------------
        with stage("stage1_red2band"):
            packed, taus1 = reduction_to_band(a, b)

        # ---- stage 2: strips + one chase -> (d, e) [+ the whole record] ---
        with stage("stage2_band2tridiag"):
            strips = packed_to_strips(packed, b)
            if nchunks == 1:
                d, e, vs, taus2 = _chase(strips, n, b, 0, chunk)
            else:   # record nothing: a one-group record past the last sweep
                d, e, _, _ = _chase(strips, n, b, nsweeps + 1, gsz)

        # ---- stage 3: tridiagonal D&C ---------------------------------------
        # complex input: the phase similarity makes the subdiagonal real; the
        # eigenvectors map back with the phases in stage 4
        with stage("stage3_tridiag_dc"):
            e, phases = _phase_normalize(e, a.dtype)
            w, q = tridiag_eigh(d, e, tune.laed4_max_iter)
            del d, e

        # ---- stage 4: stage-2 back-transform --------------------------------
        with stage("stage4_bt_band2tridiag"):
            shifted = not cplx and _use_shifted_apply(b, gsz, q.dtype)
            if shifted:
                # buffer row r = E row r + 1, and 2b zero rows under the last window
                buf = q.new_zeros((n + 2 * b, n))
                buf[:n - 1] = q[1:]
                row0 = q[:1].clone()
            else:
                buf = q.new_zeros((n + b + gsz - 1, n), dtype=a.dtype)
                buf[:n] = phases[:, None] * q.to(a.dtype) if cplx else q
            del q, phases
            for ci in range(nchunks - 1, -1, -1):        # descending sweep order
                lo = ci * chunk
                if nchunks > 1:
                    with stage("stage4a_rechase", part=True):
                        _, _, vs, taus2 = _chase(strips, n, b, lo, chunk)
                with stage("stage4b_apply", part=True):
                    bt_band_to_tridiag(buf, vs, taus2, b, group_size=gsz, sweep_lo=lo,
                                       prepadded=not shifted, shifted=shifted)
                del vs, taus2
            del strips
            if shifted:
                q = torch.cat([row0, buf[:n - 1]])
                del row0
            else:
                q = buf[:n]
            del buf

        # ---- stage 5: stage-1 back-transform ---------------------------------
        with stage("stage5_bt_red2band"):
            q = bt_reduction_to_band(q, packed, taus1, b)
            del packed, taus1
    if timers:
        stage_s = dict.fromkeys(("stage4a_rechase", "stage4b_apply"), 0.0)
        for r in recs:
            if r.name.startswith("eigh_large."):
                key = r.name[len("eigh_large."):]
                stage_s[key] = stage_s.get(key, 0.0) + r.seconds
        return w, q, stage_s
    return w, q


def eigvalsh_large(a, band: int | None = None):
    """Eigenvalues only at contract scale: stages 1-3 of the plan, the chase
    recording nothing. ``a`` is not written."""
    tune = get_tune_parameters()
    n = a.shape[0]
    b = band or get_band_size(tune.default_block_size)
    if n % b or n <= b:
        raise ValueError(f"eigvalsh_large needs n % band == 0 and n > band "
                         f"(n={n}, band={b})")
    gsz = tune.bt_band_to_tridiag_hh_apply_group_size
    packed, _ = reduction_to_band(a, b)
    strips = packed_to_strips(packed, b)
    del packed
    d, e, _, _ = _chase(strips, n, b, n - 1, gsz)
    del strips
    # eigenvalues of T equal those of the phase-similar real tridiagonal
    e, _ = _phase_normalize(e, a.dtype)
    w, _ = tridiag_eigh(d, e, tune.laed4_max_iter)
    return w
