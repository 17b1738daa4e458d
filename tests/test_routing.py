"""Routing-vector traversal: the array realization of the reference's declared
PartialDistance intent (src/pq.rs:24-27) — compact bf16 hop scoring + exact
final rerank (parallel_hnsw/routing.py)."""

import jax.numpy as jnp
import numpy as np

from parallel_hnsw.analysis import brute_force_knn
from parallel_hnsw.constants import EMPTY_ID
from parallel_hnsw.graph import DenseSource
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric, pairwise_distance
from parallel_hnsw.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw.routing import (
    build_routing,
    exact_rerank,
    random_orthonormal,
    route_metric,
    route_queries,
)
from parallel_hnsw.utils.data import random_unit_corpus

BP = BuildParams(optimization=OptimizationParams(recall_proportion=0.5))
SP = SearchParams(number_of_candidates=48, upper_layer_candidate_count=48)


def lowrank_unit_corpus(count, dim, rank=48, centers=24, seed=0, noise=0.02):
    """Clustered vectors on a low-rank subspace of a high ambient dimension —
    the realistic embedding shape (transformer embeddings have sharply
    decaying spectra).  Isotropic full-dimension noise is the pathology where
    NO reduced representation (projection or PQ) can rank-order neighbors;
    routing targets spectrally-concentrated
    corpora, with ambient noise bounded by the exact rerank's oversample."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.normal(size=(dim, rank)))
    c = rng.normal(size=(centers, rank))
    z = c[rng.integers(0, centers, count)] + 0.25 * rng.normal(size=(count, rank))
    pts = z @ basis.T + noise * rng.normal(size=(count, dim))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    return DenseSource(vectors=jnp.asarray(pts.astype(np.float32)))


def _recall_at_10(ids, gt):
    got = np.asarray(ids[:, :10])
    inter = [len(np.intersect1d(got[i], gt[i])) for i in range(len(gt))]
    return float(np.mean(inter) / 10.0)


def test_random_orthonormal_is_orthonormal():
    p = np.asarray(random_orthonormal(64, 16, seed=3))
    np.testing.assert_allclose(p.T @ p, np.eye(16), atol=1e-5)


def test_route_metric_mapping():
    assert route_metric(Metric.EUCLIDEAN) is Metric.SQUARED_EUCLIDEAN
    assert route_metric(Metric.COSINE) is Metric.COSINE
    assert route_metric(Metric.DOT) is Metric.DOT


def test_build_routing_shapes_and_norms():
    src = random_unit_corpus(300, 64, seed=0)
    cache = build_routing(src, Metric.COSINE, dr=16, seed=1)
    assert cache.rows.shape == (300, 16)
    assert cache.rows.dtype == jnp.bfloat16
    # cosine-family rows are re-normalized after projection
    norms = np.linalg.norm(np.asarray(cache.rows, np.float32), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=0.05)
    # dr=None: cast-only cache at full width
    cast = build_routing(src, Metric.COSINE, dr=None)
    assert cast.projection is None
    assert cast.rows.shape == (300, 64)


def test_routed_search_recall_with_exact_rerank():
    src = lowrank_unit_corpus(2000, 512, rank=48, seed=5)
    hnsw = Hnsw.generate(src, None, BP, Metric.COSINE, seed=0)
    queries = src.vectors[:128]
    gt, _ = brute_force_knn(src, queries, Metric.COSINE, 10)
    gt = np.asarray(gt)

    base_ids, base_d = hnsw.search(queries, SP)
    base_recall = _recall_at_10(base_ids, gt)
    assert base_recall >= 0.95

    hnsw.enable_routing(dr=128, seed=0)
    r_ids, r_d = hnsw.search(queries, SP)
    # exact rerank restores full-precision distances for returned ids
    cand = np.asarray(src.vectors)[np.clip(np.asarray(r_ids[:, :10]), 0, 1999)]
    want = 1.0 - np.einsum("qd,qkd->qk", np.asarray(queries), cand)
    np.testing.assert_allclose(np.asarray(r_d[:, :10]), want, atol=1e-4)
    # routing trades recall for hop bandwidth at equal ef; the contract is
    # oversample-then-rerank: a wider routed queue recovers the recall while
    # each hop still moves 8x less data (dr=128 bf16 vs 512-d f32)
    assert _recall_at_10(r_ids, gt) >= 0.5
    wide = SP.replace(number_of_candidates=192, upper_layer_candidate_count=100)
    w_ids, _ = hnsw.search(queries, wide)
    assert _recall_at_10(w_ids, gt) >= base_recall - 0.05
    # self-queries: the zero-distance match survives any projection
    s_ids, _ = hnsw.search(src.vectors[:64], SP)
    assert float(np.mean(np.asarray(s_ids[:, 0]) == np.arange(64))) == 1.0

    # cast-only (bf16, no projection) routing should match unrouted closely
    hnsw.enable_routing(dr=None)
    c_ids, _ = hnsw.search(queries, SP)
    assert _recall_at_10(c_ids, gt) >= base_recall - 0.02

    # routed=False forces the exact traversal path even with a cache built
    f_ids, _ = hnsw.search(queries, SP, routed=False)
    np.testing.assert_array_equal(np.asarray(f_ids), np.asarray(base_ids))


def test_routed_search_euclidean():
    rng = np.random.default_rng(11)
    basis, _ = np.linalg.qr(rng.normal(size=(48, 12)))
    c = rng.normal(size=(20, 12)) * 3.0
    z = c[rng.integers(0, 20, 1500)] + rng.normal(size=(1500, 12))
    vecs = jnp.asarray((z @ basis.T).astype(np.float32))
    src = DenseSource(vectors=vecs)
    hnsw = Hnsw.generate(src, None, BP, Metric.EUCLIDEAN, seed=0)
    queries = vecs[:96]
    gt, _ = brute_force_knn(src, queries, Metric.EUCLIDEAN, 10)
    hnsw.enable_routing(dr=24, seed=2)
    assert hnsw._routing.metric is Metric.SQUARED_EUCLIDEAN
    ids, dists = hnsw.search(queries, SP)
    assert _recall_at_10(ids, np.asarray(gt)) >= 0.9
    # reranked distances are true euclidean (not the routed squared form)
    top = np.asarray(src.vectors)[np.clip(np.asarray(ids[:, 0]), 0, 1499)]
    want = np.linalg.norm(np.asarray(queries) - top, axis=-1)
    np.testing.assert_allclose(np.asarray(dists[:, 0]), want, rtol=1e-4, atol=1e-4)


def test_exact_rerank_sorts_and_masks_empty():
    src = random_unit_corpus(100, 32, seed=9)
    queries = src.vectors[:4]
    ids = jnp.asarray(
        [[5, 17, EMPTY_ID, 3]] * 4, jnp.int32
    )
    r_ids, r_d = exact_rerank(src, Metric.COSINE, queries, ids)
    d = np.asarray(r_d)
    assert np.all(np.diff(d, axis=-1) >= -1e-7)  # ascending
    assert np.all(np.asarray(r_ids)[:, -1] == EMPTY_ID)  # EMPTY sinks to tail
    want = np.asarray(
        pairwise_distance(queries, src.vectors[jnp.asarray([3, 5, 17])], Metric.COSINE)
    )
    np.testing.assert_allclose(np.sort(d[:, :3], axis=-1), np.sort(want, axis=-1), atol=1e-5)


def test_route_queries_matches_row_transform():
    src = random_unit_corpus(200, 64, seed=1)
    cache = build_routing(src, Metric.COSINE, dr=16, seed=4)
    rq = np.asarray(route_queries(cache, src.vectors[:8], Metric.COSINE))
    rows = np.asarray(cache.rows[:8], np.float32)
    # same transform applied to identical inputs (up to bf16 row rounding)
    np.testing.assert_allclose(rq, rows, atol=0.01)
