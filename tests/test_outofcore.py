"""Out-of-core ingestion: memmap-backed corpora that never materialize on
device (or in host RAM) as a whole.

The reference streams vectors from an arbitrary user store through its
``VectorSelector``/``VectorStore`` seam (src/pq.rs:133-142, used at
:325-334); these tests drive the array equivalent end-to-end on the
8-virtual-device CPU mesh: a ``MemmapSource`` corpus on disk is quantized in
streamed chunks (per shard, on the shard's own device), searched through the
full distributed program, and exact-reranked by gathering only the candidate
rows from disk.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.constants import EMPTY_ID
from parallel_hnsw.graph import MemmapSource, open_memmap_source
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import (
    BuildParams,
    OptimizationParams,
    PqBuildParams,
    SearchParams,
)
from parallel_hnsw.parallel import ShardedQuantizedHnsw, default_mesh
from parallel_hnsw.utils.data import random_unit_corpus

BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)
PQP = PqBuildParams(
    centroids=BP,
    hnsw=BP,
    quantized_search=SearchParams(
        number_of_candidates=32, upper_layer_candidate_count=32
    ),
)


def _write_memmap(tmp_path, count, dim, seed):
    """A unit-vector corpus written to disk; returns its MemmapSource."""
    src = random_unit_corpus(count, dim, seed=seed)
    path = tmp_path / "corpus.f32"
    arr = np.asarray(src.vectors, np.float32)
    arr.tofile(path)
    return open_memmap_source(str(path), dim), arr


def test_open_memmap_source(tmp_path):
    mm, arr = _write_memmap(tmp_path, 64, 8, seed=1)
    assert mm.count == 64 and mm.dim == 8
    np.testing.assert_array_equal(np.asarray(mm.vectors), arr)
    # chunk iteration covers every row in order, bounded chunks
    got = np.concatenate(list(mm.chunks(chunk_size=10)))
    np.testing.assert_array_equal(got, arr)
    # subset iteration fetches exactly the requested rows
    ids = np.asarray([3, 1, 60, 60])
    got = np.concatenate(list(mm.chunks(chunk_size=3, ids=ids)))
    np.testing.assert_array_equal(got, arr[ids])


def test_memmap_source_get_outside_jit(tmp_path):
    from parallel_hnsw.graph import source_get

    mm, arr = _write_memmap(tmp_path, 32, 8, seed=2)
    out = np.asarray(source_get(mm, jnp.asarray([[0, 5], [31, 2]])))
    np.testing.assert_allclose(out, arr[[[0, 5], [31, 2]]], atol=1e-7)


def test_quantized_hnsw_from_memmap(tmp_path):
    """Single-index PQ build streaming straight from disk."""
    from parallel_hnsw.pq import QuantizedHnsw

    mm, arr = _write_memmap(tmp_path, 300, 16, seed=23)
    q = QuantizedHnsw.new(
        number_of_centroids=64,
        full_source=mm,
        dsub=4,
        metric=Metric.EUCLIDEAN,
        pqp=PQP,
        seed=3,
        exact_quantize=True,
        chunk_size=64,  # force multiple streamed chunks
    )
    assert isinstance(q.full_source, MemmapSource)
    queries = jnp.asarray(arr[:48])
    ids, dists = q.search(queries, exact_quantize=True)
    hits = (np.asarray(ids[:, 0]) == np.arange(48)).mean()
    assert hits >= 0.9, hits
    # the exact rerank gathered true full-precision rows from disk
    d0 = np.asarray(dists[:, 0])
    assert np.all(np.abs(d0[np.asarray(ids[:, 0]) == np.arange(48)]) < 1e-4)
    ids2, _ = q.search_exact(queries, k=5, rerank=True)
    hits2 = (np.asarray(ids2[:, 0]) == np.arange(48)).mean()
    assert hits2 >= 0.95, hits2


@pytest.fixture(scope="module")
def ooc(tmp_path_factory):
    """Out-of-core sharded PQ index over an 8-shard mesh.

    The corpus (f32 on disk) is larger than the bytes the index is allowed
    to keep resident: codes are u16 at dsub=4, an 8x compression, and
    ``full_stacked`` must never exist."""
    tmp_path = tmp_path_factory.mktemp("ooc")
    mm, arr = _write_memmap(tmp_path, 410, 16, seed=13)  # ragged → padding
    sq = ShardedQuantizedHnsw.new(
        number_of_centroids=64,
        full_source=mm,
        dsub=4,
        metric=Metric.EUCLIDEAN,
        mesh=default_mesh(),
        pqp=PQP,
        seed=3,
        exact_quantize=True,
        chunk_size=16,  # each shard streams its rows in several chunks
        improve=False,  # graph quality is not under test; keeps CI fast
    )
    return mm, arr, sq


def test_out_of_core_never_materializes_f32(ooc):
    mm, arr, sq = ooc
    assert sq.full_stacked is None
    assert sq.full_host is mm
    # resident vector state is codes only: u16 x nsub per row
    codes = sq.sharded.source_stacked.codes
    assert codes.dtype == jnp.uint16
    f32_bytes = arr.nbytes
    code_bytes = codes.size * 2
    assert code_bytes < f32_bytes / 2


def test_out_of_core_search_self_hit(ooc):
    mm, arr, sq = ooc
    queries = jnp.asarray(arr[:64])
    ids, dists = sq.search(queries, k=5, exact_quantize=True)
    got = np.asarray(ids)
    valid = got[got != EMPTY_ID]
    assert valid.size > 0 and valid.max() < mm.count
    hits = (got[:, 0] == np.arange(64)).mean()
    assert hits >= 0.9, hits
    # distances are exact full-precision (host-gathered rows) after rerank
    d0 = np.asarray(dists[:, 0])
    assert np.all(np.abs(d0[got[:, 0] == np.arange(64)]) < 1e-4)


def test_out_of_core_flat_scan(ooc):
    mm, arr, sq = ooc
    queries = jnp.asarray(arr[:32])
    ids, _ = sq.search_exact(queries, k=5, fast=False)
    hits = (np.asarray(ids[:, 0]) == np.arange(32)).mean()
    assert hits >= 0.95, hits


def test_search_exact_in_core_matches_out_of_core(tmp_path):
    """In-core ``search_exact`` must rerank against the resident f32 vectors
    (in-shard, pre-merge) and return the SAME ids and exact distances as the
    out-of-core path's disk-gather rerank on the same corpus (reference
    rerank contract: src/pq.rs:346-364)."""
    mm, arr = _write_memmap(tmp_path, 250, 16, seed=11)
    dense = random_unit_corpus(250, 16, seed=11)
    mesh = default_mesh()
    kw = dict(
        number_of_centroids=48, dsub=4, metric=Metric.EUCLIDEAN, mesh=mesh,
        pqp=PQP, seed=3, exact_quantize=True, chunk_size=16, improve=False,
    )
    ooc_idx = ShardedQuantizedHnsw.new(full_source=mm, **kw)
    inc_idx = ShardedQuantizedHnsw.new(full_source=dense, **kw)
    assert inc_idx.full_stacked is not None
    queries = jnp.asarray(arr[:40])
    # oversample*k >= corpus: both candidate sets cover every row, so both
    # paths must return the exact brute-force answer — any code-distance
    # leak in either rerank breaks the equality
    i_in, d_in = inc_idx.search_exact(queries, k=5, fast=False, oversample=64)
    i_out, d_out = ooc_idx.search_exact(queries, k=5, fast=False, oversample=64)
    np.testing.assert_array_equal(np.asarray(i_in), np.asarray(i_out))
    np.testing.assert_allclose(np.asarray(d_in), np.asarray(d_out), atol=1e-5)
    from parallel_hnsw.analysis import brute_force_knn
    from parallel_hnsw.graph import DenseSource

    gt_ids, gt_d = brute_force_knn(
        DenseSource(vectors=jnp.asarray(arr)), queries, Metric.EUCLIDEAN, 5
    )
    np.testing.assert_array_equal(np.asarray(i_in), np.asarray(gt_ids))
    # distances are true f32 (self-distance ~0), not code reconstructions
    np.testing.assert_allclose(np.asarray(d_in), np.asarray(gt_d), atol=1e-5)


def test_out_of_core_matches_in_core_codes(tmp_path):
    """Per-shard streamed quantization assigns the same codes as the in-core
    single-device path (same codebook, same rows)."""
    mm, arr = _write_memmap(tmp_path, 72, 16, seed=7)
    dense = random_unit_corpus(72, 16, seed=7)
    mesh = default_mesh()
    kw = dict(
        number_of_centroids=32, dsub=4, metric=Metric.EUCLIDEAN, mesh=mesh,
        pqp=PQP, seed=3, exact_quantize=True, chunk_size=4, improve=False,
    )
    a = ShardedQuantizedHnsw.new(full_source=mm, **kw)
    b = ShardedQuantizedHnsw.new(full_source=dense, **kw)
    np.testing.assert_array_equal(
        np.asarray(a.sharded.source_stacked.codes),
        np.asarray(b.sharded.source_stacked.codes),
    )
    np.testing.assert_array_equal(
        np.asarray(a.sharded.global_ids), np.asarray(b.sharded.global_ids)
    )


def test_out_of_core_roundtrip(tmp_path, ooc):
    from parallel_hnsw.io import (
        deserialize_sharded_quantized_hnsw,
        serialize_sharded_quantized_hnsw,
    )

    mm, arr, sq = ooc
    serialize_sharded_quantized_hnsw(sq, tmp_path / "sq")
    meta = json.loads((tmp_path / "sq" / "meta").read_text())
    assert meta["out_of_core"] is True
    assert "full_path" in meta  # memmap filename recorded as reload hint
    # reload via the recorded hint
    back = deserialize_sharded_quantized_hnsw(tmp_path / "sq", sq.sharded.mesh)
    q = jnp.asarray(arr[:16])
    i1, d1 = sq.search(q, k=5, exact_quantize=True)
    i2, d2 = back.search(q, k=5, exact_quantize=True)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-6)
    # explicit full_source override also works
    back2 = deserialize_sharded_quantized_hnsw(
        tmp_path / "sq", sq.sharded.mesh, full_source=mm
    )
    i3, _ = back2.search(q, k=5, exact_quantize=True)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i3))


def test_scan_only_build(tmp_path):
    """build_graphs=False: no shard graphs are built (the config-5 serving
    shape — the flat code scan is the engine), flat
    scans and the serialize round-trip work, graph paths raise."""
    from parallel_hnsw.io import (
        deserialize_sharded_hnsw,
        serialize_sharded_hnsw,
    )
    from parallel_hnsw.parallel import ShardedHnsw

    mm, arr = _write_memmap(tmp_path, 96, 8, seed=9)
    mesh = default_mesh()
    sq = ShardedQuantizedHnsw.new(
        number_of_centroids=16, full_source=mm, dsub=4,
        metric=Metric.EUCLIDEAN, mesh=mesh, pqp=PQP, seed=3,
        exact_quantize=True, chunk_size=8, build_graphs=False,
    )
    assert sq.full_stacked is None
    assert sq.sharded.layers_stacked == []
    q = jnp.asarray(arr[:24])
    ids, _ = sq.search_exact(q, k=3, fast=False, oversample=8)
    assert float((np.asarray(ids)[:, 0] == np.arange(24)).mean()) == 1.0
    with pytest.raises(ValueError, match="scan-only"):
        sq.sharded.search(q)
    with pytest.raises(ValueError, match="scan-only"):
        sq.sharded.improve_index()

    # dense scan-only + persistence round-trip
    src = random_unit_corpus(64, 8, seed=4)
    sh = ShardedHnsw.generate(
        src, mesh, metric=Metric.NORMALIZED_COSINE, build_graphs=False
    )
    i1, _ = sh.search_exact(src.vectors[:16], k=3)
    serialize_sharded_hnsw(sh, tmp_path / "scan_only")
    back = deserialize_sharded_hnsw(tmp_path / "scan_only", mesh)
    assert back.layers_stacked == []
    i2, _ = back.search_exact(src.vectors[:16], k=3)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_sharded_per_subspace(tmp_path):
    """Sharded per-subspace PQ (classic product quantization; the codebook
    layout) works on
    the mesh in BOTH residency modes: the quantizer is a SubspaceQuantizer
    (no centroid graph), the [nsub, K, dsub] codebook flows through the
    stacked PqSource, streamed out-of-core codes match the in-core ones,
    search/search_exact answer correctly, and the nested serialization
    round-trips the subspace quantizer."""
    from parallel_hnsw.io import (
        deserialize_sharded_quantized_hnsw,
        serialize_sharded_quantized_hnsw,
    )
    from parallel_hnsw.pq import SubspaceQuantizer

    mm, arr = _write_memmap(tmp_path, 230, 16, seed=21)
    dense = random_unit_corpus(230, 16, seed=21)
    mesh = default_mesh()
    kw = dict(
        number_of_centroids=32, dsub=4, metric=Metric.EUCLIDEAN, mesh=mesh,
        pqp=PQP, seed=3, chunk_size=16, improve=False, per_subspace=True,
    )
    ooc_idx = ShardedQuantizedHnsw.new(full_source=mm, **kw)
    inc_idx = ShardedQuantizedHnsw.new(full_source=dense, **kw)

    for idx in (ooc_idx, inc_idx):
        assert isinstance(idx.quantizer, SubspaceQuantizer)
        assert idx.quantizer.codebooks.shape == (4, 32, 4)
        assert idx.sharded.source_stacked.codebook.ndim == 3
    assert ooc_idx.full_stacked is None
    assert inc_idx.full_stacked is not None

    # streamed per-shard quantization == in-core quantization, same books
    np.testing.assert_array_equal(
        np.asarray(ooc_idx.sharded.source_stacked.codes),
        np.asarray(inc_idx.sharded.source_stacked.codes),
    )

    queries = jnp.asarray(arr[:40])
    # oversample*k covers the corpus: both reranks must return exact truth
    i_in, d_in = inc_idx.search_exact(queries, k=5, fast=False, oversample=64)
    i_out, d_out = ooc_idx.search_exact(queries, k=5, fast=False, oversample=64)
    np.testing.assert_array_equal(np.asarray(i_in), np.asarray(i_out))
    np.testing.assert_allclose(np.asarray(d_in), np.asarray(d_out), atol=1e-5)
    assert float((np.asarray(i_in)[:, 0] == np.arange(40)).mean()) == 1.0

    # graph traversal path (code graphs over the 3-D codebook source)
    ids, _ = ooc_idx.search(queries, k=5)
    hits = float((np.asarray(ids)[:, 0] == np.arange(40)).mean())
    assert hits >= 0.9, hits

    # nested serialization round-trips the subspace quantizer
    serialize_sharded_quantized_hnsw(ooc_idx, tmp_path / "sq_sub")
    qmeta = json.loads(
        (tmp_path / "sq_sub" / "quantizer" / "pq_build_parameters.json").read_text()
    )
    assert qmeta["quantizer_kind"] == "subspace"
    back = deserialize_sharded_quantized_hnsw(
        tmp_path / "sq_sub", mesh, full_source=mm
    )
    assert isinstance(back.quantizer, SubspaceQuantizer)
    i2, _ = back.search_exact(queries, k=5, fast=False, oversample=64)
    np.testing.assert_array_equal(np.asarray(i_out), np.asarray(i2))
