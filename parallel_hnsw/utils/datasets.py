"""ANN-benchmark dataset loaders (fvecs/bvecs/ivecs) over the native mmap IO.

These feed BASELINE.md's benchmark configs (SIFT1M, GloVe, DEEP) when dataset
files are present; a pure-numpy fallback keeps the loaders usable without the
native library.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def _native():
    try:
        from parallel_hnsw.native import load_vecio

        return load_vecio()
    except Exception:
        return None


def read_vecs(
    path: str, start: int = 0, count: int = -1, n_threads: int = 8
) -> np.ndarray:
    """Read an fvecs (.fvecs), bvecs (.bvecs) or ivecs (.ivecs) file.

    Returns float32 [n, dim] for fvecs/bvecs, int32 [n, dim] for ivecs.
    """
    ext = os.path.splitext(path)[1].lower()
    elt = 1 if ext == ".bvecs" else 4
    lib = _native()
    if lib is not None:
        import ctypes

        vf = lib.vecio_open(path.encode(), elt)
        if not vf:
            raise IOError(f"cannot open {path}")
        try:
            total = lib.vecio_count(vf)
            dim = lib.vecio_dim(vf)
            n = total - start if count < 0 else min(count, total - start)
            if ext == ".ivecs":
                out = np.empty((n, dim), np.int32)
                rc = lib.vecio_read_i32(
                    vf, start, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads
                )
            else:
                out = np.empty((n, dim), np.float32)
                rc = lib.vecio_read_f32(
                    vf, start, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads
                )
            if rc != 0:
                raise IOError(f"read failed for {path}")
            return out
        finally:
            lib.vecio_close(vf)
    # numpy fallback
    return _read_vecs_numpy(path, ext, elt, start, count)


def _read_vecs_numpy(path, ext, elt, start, count):
    with open(path, "rb") as f:
        dim = int(np.fromfile(f, np.int32, 1)[0])
    row_dtype = np.uint8 if elt == 1 else (np.int32 if ext == ".ivecs" else np.float32)
    stride = 4 + dim * elt
    size = os.path.getsize(path)
    total = size // stride
    n = total - start if count < 0 else min(count, total - start)
    raw = np.fromfile(path, np.uint8, count=n * stride, offset=start * stride)
    raw = raw.reshape(n, stride)[:, 4:]
    out = raw.view(row_dtype).reshape(n, dim)
    if ext == ".ivecs":
        return out.astype(np.int32)
    return out.astype(np.float32)


def vector_chunks(path: str, chunk_size: int = 100_000) -> Iterator[np.ndarray]:
    """Streaming chunked ingestion (the reference's VectorSelector::
    vector_chunks seam, src/pq.rs:133-137)."""
    ext = os.path.splitext(path)[1].lower()
    elt = 1 if ext == ".bvecs" else 4
    with open(path, "rb") as f:
        dim = int(np.fromfile(f, np.int32, 1)[0])
    stride = 4 + dim * elt
    total = os.path.getsize(path) // stride
    for start in range(0, total, chunk_size):
        yield read_vecs(path, start, min(chunk_size, total - start))
