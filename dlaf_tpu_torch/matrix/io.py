"""Checkpoint / debug-dump I/O for (distributed) matrices.

Counterpart of :mod:`dlaf_tpu.matrix.io`, file for file: the port reads
what the JAX package writes and the other way round. The analog of the
reference's HDF5 subsystem (``matrix/hdf5.h:1-308``,
used for debug dumps gated by tune flags and miniapp reference inputs), with
the same named-dataset contract (``/input``, ``/evals``, ``/evecs``, ...).

Two interchangeable containers, selected by file extension:

- ``.h5`` / ``.hdf5``: real HDF5 via h5py, **bit-compatible with the
  reference's on-disk layout** (``matrix/hdf5.h:200-219``): every dataset is
  3-D ``(cols, rows, c)`` with ``c = 1`` for real and ``c = 2`` for complex
  (re/im planes, ``hdf5_datatype<T>::dims``) — files written by DLA-Future
  miniapps load here and vice versa;
- anything else: numpy ``.npz`` (same dataset names, host-friendly; the
  port stores the arrays without deflating them).

``h5py`` is imported only where an HDF5 file is opened. Tensors are
written from the host (a ``DistMatrix`` is gathered first: collective).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

_H5_EXTS = (".h5", ".hdf5")


def _h5_encode(arr: np.ndarray) -> np.ndarray:
    """Matrix (m, n) [or vector (m,)] -> reference dataset layout
    (cols, rows, c)."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]  # reference stores eigenvalues as an (n, 1) matrix
    if np.iscomplexobj(arr):
        planes = np.stack([arr.real, arr.imag], axis=-1)
    else:
        planes = arr[..., None]
    return np.ascontiguousarray(planes.transpose(1, 0, 2))


def _h5_decode(ds: np.ndarray) -> np.ndarray:
    """Reference dataset layout (cols, rows, c) -> matrix (rows, cols)."""
    ds = np.asarray(ds)
    assert ds.ndim == 3 and ds.shape[2] in (1, 2), ds.shape
    if ds.shape[2] == 2:
        c = np.complex64 if ds.dtype == np.float32 else np.complex128
        out = (ds[..., 0] + 1j * ds[..., 1]).astype(c)
    else:
        out = ds[..., 0]
    out = out.T
    return out[:, 0] if out.shape[1] == 1 else out


class MatrixFile:
    """Write/read named matrices (reference ``FileHDF5::write/read``)."""

    def __init__(self, path: str):
        ext = os.path.splitext(path)[1].lower()
        if ext in _H5_EXTS:
            self.backend = "hdf5"
            self.path = path
        else:
            self.backend = "npz"
            self.path = path if ext == ".npz" else path + ".npz"

    def write(self, **datasets) -> None:
        """Write (or replace) each named dataset: numpy arrays, tensors or
        DistMatrix (every rank of its grid calls; rank 0 writes)."""
        arrays = {}
        writes = True
        for k, v in datasets.items():
            if hasattr(v, "to_global"):
                # gathered on every rank of its grid (collective); rank 0 writes
                writes = writes and (v.grid.size == 1 or v.grid.rank == 0)
                v = v.to_global()
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            arrays[k] = np.asarray(v)
        if not writes:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        if self.backend == "hdf5":
            import h5py
            with h5py.File(self.path, "a") as f:
                for k, v in arrays.items():
                    if k in f:
                        del f[k]
                    f.create_dataset(k, data=_h5_encode(v))
            return
        existing = self.read_all() if os.path.exists(self.path) else {}
        existing.update({k.lstrip("/"): v for k, v in arrays.items()})
        # stored, not deflated (the JAX package deflates; np.load reads
        # both): deflating random floats saves little and took 30 s for
        # an 8192 x 8192 f32 input and its eigenvectors
        np.savez(self.path, **existing)

    def read(self, name: str) -> np.ndarray:
        if self.backend == "hdf5":
            import h5py
            with h5py.File(self.path, "r") as f:
                return _h5_decode(f[name][...])
        with np.load(self.path) as f:
            return f[name.lstrip("/")]

    def read_all(self) -> Dict[str, np.ndarray]:
        if self.backend == "hdf5":
            import h5py
            out = {}
            with h5py.File(self.path, "r") as f:
                def visit(name, obj):
                    if isinstance(obj, h5py.Dataset):
                        out[name] = _h5_decode(obj[...])
                f.visititems(visit)
            return out
        with np.load(self.path) as f:
            return {k: f[k] for k in f.files}

    def read_dist(self, name: str, nb: int, grid, device=None):
        """Read a dataset and scatter it onto a grid as a DistMatrix
        (reference ``FileHDF5::read(dataset, blocksize, grid, {0, 0})``):
        every rank reads the file and keeps its shard (``from_global``), on
        ``device`` (default: the rank's card, ``cuda:{rank % device_count}``)."""
        from ..comm.launch import rank_device
        from .dist_matrix import DistMatrix
        dev = rank_device("cuda", grid.rank) if device is None else device
        return DistMatrix.from_global(torch.from_numpy(np.ascontiguousarray(self.read(name))), nb,
                                      grid, device=dev)


def debug_dump(tag: str, **datasets) -> None:
    """Debug dump gated by tune flags (reference tune.h:29-57 +
    factorization/cholesky/impl.h:196-207 dump calls)."""
    from ..tune import get_tune_parameters
    t = get_tune_parameters()
    if not (t.debug_dump_cholesky_data or t.debug_dump_eigensolver_data):
        return
    MatrixFile(os.path.join(t.debug_dump_path, tag)).write(**datasets)
