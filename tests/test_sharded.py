"""Sharded multi-device tests on the 8-virtual-CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.analysis import brute_force_knn
from parallel_hnsw.constants import EMPTY_ID
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw.parallel import ShardedHnsw, default_mesh
from parallel_hnsw.utils.data import random_unit_corpus

BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.fixture(scope="module")
def sharded():
    source = random_unit_corpus(410, 16, seed=13)  # not divisible by 8 → padding
    mesh = default_mesh()
    sh = ShardedHnsw.generate(source, mesh, BP, Metric.NORMALIZED_COSINE, seed=0)
    return source, sh


def test_sharded_recall_vs_bruteforce(sharded):
    source, sh = sharded
    queries = source.vectors
    ids, dists = sh.search(queries, k=10)
    gt_ids, _ = brute_force_knn(source, queries, Metric.NORMALIZED_COSINE, 1)
    got_top = np.asarray(ids[:, 0])
    want_top = np.asarray(gt_ids[:, 0])
    recall = (got_top == want_top).mean()
    assert recall >= 0.97, recall


def test_sharded_no_padding_leak(sharded):
    source, sh = sharded
    ids, dists = sh.search(source.vectors[:16], k=50)
    got = np.asarray(ids)
    valid = got[got != EMPTY_ID]
    assert valid.min() >= 0 and valid.max() < source.count


def test_sharded_sorted_and_unique(sharded):
    source, sh = sharded
    ids, dists = sh.search(source.vectors[:8], k=20)
    d = np.asarray(dists)
    i = np.asarray(ids)
    for row_i, row_d in zip(i, d):
        fin = np.isfinite(row_d)
        assert np.all(np.diff(row_d[fin]) >= -1e-6)
        real = row_i[row_i != EMPTY_ID]
        assert len(np.unique(real)) == len(real)


def test_sharded_pq_source():
    # PQ-compressed shards: per-shard code arrays + replicated codebook —
    # the BASELINE 100M-config layout at toy scale
    import jax.numpy as jnp
    from parallel_hnsw.graph import PqSource
    from parallel_hnsw.pq import HnswQuantizer, QuantizedHnsw, random_centroids

    source = random_unit_corpus(200, 16, seed=21)
    book = random_centroids(source.vectors, 64, 4, seed=0)
    # quantize the corpus exactly
    from parallel_hnsw.ops.distance import pairwise_distance

    subs = np.asarray(source.vectors).reshape(-1, 4)
    d = np.asarray(
        pairwise_distance(jnp.asarray(subs), jnp.asarray(book), Metric.SQUARED_EUCLIDEAN)
    )
    codes = d.argmin(axis=1).reshape(200, 4).astype(np.int32)
    pq = PqSource(codes=jnp.asarray(codes), codebook=jnp.asarray(book))

    mesh = default_mesh()
    sh = ShardedHnsw.generate(pq, mesh, BP, Metric.EUCLIDEAN, seed=0)
    queries = source.vectors[:32]
    ids, dists = sh.search(queries, k=5)
    got = np.asarray(ids)
    valid = got[got != EMPTY_ID]
    assert valid.size > 0 and valid.max() < 200
    # reconstructed self should usually be findable
    hits = (got[:, 0] == np.arange(32)).mean()
    assert hits > 0.5, hits


def test_sharded_stochastic_recall(sharded):
    source, sh = sharded
    r = sh.stochastic_recall()
    assert 0.9 <= r <= 1.0, r


def test_sharded_roundtrip(tmp_path, sharded):
    from parallel_hnsw.io import deserialize_sharded_hnsw, serialize_sharded_hnsw

    source, sh = sharded
    serialize_sharded_hnsw(sh, tmp_path / "sh")
    back = deserialize_sharded_hnsw(tmp_path / "sh", sh.mesh)
    assert back.n_shards == sh.n_shards
    np.testing.assert_array_equal(np.asarray(back.global_ids), np.asarray(sh.global_ids))
    q = source.vectors[:16]
    i1, d1 = sh.search(q, k=10)
    i2, d2 = back.search(q, k=10)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-6)


@pytest.fixture(scope="module")
def sharded_pq():
    from parallel_hnsw.params import PqBuildParams
    from parallel_hnsw.parallel import ShardedQuantizedHnsw

    source = random_unit_corpus(300, 16, seed=23)
    pqp = PqBuildParams(
        centroids=BP, hnsw=BP,
        quantized_search=SearchParams(number_of_candidates=32, upper_layer_candidate_count=32),
    )
    sq = ShardedQuantizedHnsw.new(
        number_of_centroids=64,
        full_source=source,
        dsub=4,
        metric=Metric.EUCLIDEAN,
        mesh=default_mesh(),
        pqp=pqp,
        seed=3,
        exact_quantize=True,
    )
    return source, sq


def test_sharded_pq_build_and_search(sharded_pq):
    source, sq = sharded_pq
    queries = source.vectors[:64]
    ids, dists = sq.search(queries, k=5, exact_quantize=True)
    got = np.asarray(ids)
    valid = got[got != EMPTY_ID]
    assert valid.size > 0 and valid.max() < source.count
    # exact in-shard rerank: self-recall@1 should be high
    hits = (got[:, 0] == np.arange(64)).mean()
    assert hits >= 0.9, hits
    # distances are the exact full-precision ones after rerank
    d0 = np.asarray(dists[:, 0])
    hit_rows = got[:, 0] == np.arange(64)
    assert np.all(np.abs(d0[hit_rows]) < 1e-4)


def test_sharded_pq_roundtrip(tmp_path, sharded_pq):
    from parallel_hnsw.io import (
        deserialize_sharded_quantized_hnsw,
        serialize_sharded_quantized_hnsw,
    )

    source, sq = sharded_pq
    serialize_sharded_quantized_hnsw(sq, tmp_path / "sq")
    back = deserialize_sharded_quantized_hnsw(tmp_path / "sq", sq.sharded.mesh)
    q = source.vectors[:16]
    i1, d1 = sq.search(q, k=5, exact_quantize=True)
    i2, d2 = back.search(q, k=5, exact_quantize=True)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-6)


def test_sharded_flat_scan_exact_and_fast(sharded):
    """ShardedHnsw.search_exact: per-shard flat scans + cross-shard merge find the
    true nearest neighbors across the whole sharded corpus."""
    source, sh = sharded
    queries = source.vectors[:24]
    gt, _ = brute_force_knn(source, queries, sh.metric, 5)
    gt = np.asarray(gt)
    for fast in (False, True):
        ids, dists = sh.search_exact(queries, k=5, fast=fast)
        got = np.asarray(ids[:, :5])
        recall = np.mean([len(np.intersect1d(got[i], gt[i])) for i in range(24)]) / 5
        assert recall >= 0.99, (fast, recall)
        # self-hit at distance ~0
        assert (got[:, 0] == np.arange(24)).mean() >= 0.95


def test_parallel_build_matches_sequential():
    """Overlapped (threaded) shard builds produce byte-identical stacks to
    the sequential path: per-shard determinism is (seed + shard)-only."""
    source = random_unit_corpus(300, 16, seed=21)
    mesh = default_mesh()
    a = ShardedHnsw.generate(
        source, mesh, BP, Metric.NORMALIZED_COSINE, seed=3, parallel_build=True
    )
    b = ShardedHnsw.generate(
        source, mesh, BP, Metric.NORMALIZED_COSINE, seed=3, parallel_build=False
    )
    assert len(a.layers_stacked) == len(b.layers_stacked)
    for la, lb in zip(a.layers_stacked, b.layers_stacked):
        np.testing.assert_array_equal(np.asarray(la.nodes), np.asarray(lb.nodes))
        np.testing.assert_array_equal(
            np.asarray(la.neighbors), np.asarray(lb.neighbors)
        )
    np.testing.assert_array_equal(
        np.asarray(a.global_ids), np.asarray(b.global_ids)
    )
