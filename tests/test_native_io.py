"""Native vecio tests: fvecs/bvecs/ivecs round-trips, native vs numpy parity."""

import numpy as np
import pytest

from parallel_hnsw.utils import datasets


def write_vecs(path, arr, elt):
    n, d = arr.shape
    with open(path, "wb") as f:
        for row in arr:
            np.asarray([d], np.int32).tofile(f)
            if elt == 1:
                row.astype(np.uint8).tofile(f)
            else:
                row.tofile(f)


@pytest.fixture
def fvecs(tmp_path):
    arr = np.random.default_rng(0).normal(size=(100, 24)).astype(np.float32)
    p = tmp_path / "x.fvecs"
    write_vecs(p, arr, 4)
    return str(p), arr


def test_native_compiles():
    from parallel_hnsw.native import load_vecio

    lib = load_vecio()
    assert lib is not None


def test_fvecs_read(fvecs):
    path, arr = fvecs
    out = datasets.read_vecs(path)
    np.testing.assert_allclose(out, arr)


def test_fvecs_slice(fvecs):
    path, arr = fvecs
    out = datasets.read_vecs(path, start=10, count=5)
    np.testing.assert_allclose(out, arr[10:15])


def test_bvecs_read(tmp_path):
    arr = np.random.default_rng(1).integers(0, 256, (50, 8)).astype(np.uint8)
    p = tmp_path / "x.bvecs"
    write_vecs(p, arr, 1)
    out = datasets.read_vecs(str(p))
    np.testing.assert_allclose(out, arr.astype(np.float32))


def test_ivecs_read(tmp_path):
    arr = np.random.default_rng(2).integers(0, 1000, (30, 10)).astype(np.int32)
    p = tmp_path / "gt.ivecs"
    write_vecs(p, arr, 4)
    out = datasets.read_vecs(str(p))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, arr)


def test_native_matches_numpy(fvecs):
    path, arr = fvecs
    nat = datasets.read_vecs(path)
    fallback = datasets._read_vecs_numpy(path, ".fvecs", 4, 0, -1)
    np.testing.assert_array_equal(nat, fallback)


def test_vector_chunks(fvecs):
    path, arr = fvecs
    chunks = list(datasets.vector_chunks(path, chunk_size=30))
    assert [len(c) for c in chunks] == [30, 30, 30, 10]
    np.testing.assert_allclose(np.concatenate(chunks), arr)
