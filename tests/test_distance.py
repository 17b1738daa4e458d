"""Distance-kernel golden tests against the reference metric formulas
(cosine src/lib.rs:1985-1991; normalized src/bigvec.rs:47-53; euclidean
src/lib.rs:2431-2437)."""

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.ops.distance import (
    Metric,
    batched_distance,
    distance_one,
    pairwise_distance,
)

RNG = np.random.default_rng(42)


def _unit(n, d):
    x = RNG.uniform(-1, 1, size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_cosine_pairwise_matches_reference_formula():
    x = _unit(7, 16)
    y = _unit(9, 16)
    got = np.asarray(pairwise_distance(jnp.asarray(x), jnp.asarray(y), Metric.COSINE))
    want = 1.0 - x @ y.T
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_normalized_cosine():
    x = _unit(4, 8)
    y = _unit(5, 8)
    got = np.asarray(pairwise_distance(jnp.asarray(x), jnp.asarray(y), Metric.NORMALIZED_COSINE))
    want = (1.0 - x @ y.T) / 2.0
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_euclidean():
    x = RNG.uniform(-1, 1, size=(6, 12)).astype(np.float32)
    y = RNG.uniform(-1, 1, size=(3, 12)).astype(np.float32)
    got = np.asarray(pairwise_distance(jnp.asarray(x), jnp.asarray(y), Metric.EUCLIDEAN))
    want = np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "metric,nq,nc,d",
    [(m, 70, 130, 32) for m in Metric] + [(Metric.EUCLIDEAN, 1, 3, 7)],
    ids=[m.value for m in Metric] + ["unaligned-1x7-3x7"],
)
def test_pairwise_distance_matches_float64(metric, nq, nc, d):
    """``pairwise_distance`` at exact precision against NumPy float64, for
    every metric and an unaligned shape."""
    x = RNG.normal(size=(nq, d)).astype(np.float32)
    y = RNG.normal(size=(nc, d)).astype(np.float32)
    got = np.asarray(pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric))
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    dots = x64 @ y64.T
    sq = ((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)
    want = {
        Metric.COSINE: 1.0 - dots,
        Metric.NORMALIZED_COSINE: (1.0 - dots) / 2.0,
        Metric.DOT: -dots,
        Metric.SQUARED_EUCLIDEAN: sq,
        Metric.EUCLIDEAN: np.sqrt(sq),
    }[metric]
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


def test_batched_matches_pairwise():
    q = _unit(5, 16)
    cands = _unit(5 * 7, 16).reshape(5, 7, 16)
    for metric in Metric:
        got = np.asarray(batched_distance(jnp.asarray(q), jnp.asarray(cands), metric))
        want = np.stack(
            [
                np.asarray(pairwise_distance(jnp.asarray(q[i : i + 1]), jnp.asarray(cands[i]), metric))[0]
                for i in range(5)
            ]
        )
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_distance_one():
    a = _unit(4, 8)
    b = _unit(4, 8)
    got = np.asarray(distance_one(jnp.asarray(a), jnp.asarray(b), Metric.COSINE))
    want = 1.0 - np.sum(a * b, axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_self_distance_is_zero():
    a = _unit(3, 8)
    for metric in (Metric.COSINE, Metric.NORMALIZED_COSINE, Metric.EUCLIDEAN, Metric.SQUARED_EUCLIDEAN):
        got = np.asarray(distance_one(jnp.asarray(a), jnp.asarray(a), metric))
        np.testing.assert_allclose(got, 0.0, atol=1e-5)


def test_fast_flat_knn_matches_exact_scan():
    """bf16 scan + oversampled exact rerank must reproduce the exact scan's
    top-k (ids and full-precision distances), including across corpus-block
    merges."""
    import jax

    from parallel_hnsw.analysis import brute_force_knn, fast_flat_knn
    from parallel_hnsw.graph import DenseSource

    vecs = _unit(500, 32)
    src = DenseSource(vectors=jnp.asarray(vecs))
    queries = jnp.asarray(_unit(37, 32))
    for metric in (Metric.COSINE, Metric.EUCLIDEAN):
        gt_ids, gt_d = brute_force_knn(src, queries, metric, 10)
        ids, d = fast_flat_knn(
            src, queries, metric, 10, oversample=4, query_block=16, corpus_block=128
        )
        assert ids.shape == (37, 10)
        np.testing.assert_array_equal(np.asarray(ids), np.asarray(gt_ids))
        np.testing.assert_allclose(np.asarray(d), np.asarray(gt_d), atol=1e-5)


def test_fast_flat_knn_folded_mode_high_recall():
    """scan_mode='folded' (the fused fold; its chunked XLA route on CPU)
    keeps near-exact recall via oversample + rerank despite the coarser
    n_slots*128-class fold."""
    from parallel_hnsw.analysis import brute_force_knn, fast_flat_knn
    from parallel_hnsw.graph import DenseSource

    vecs = _unit(5000, 32)
    src = DenseSource(vectors=jnp.asarray(vecs))
    queries = jnp.asarray(_unit(64, 32))
    gt_ids, _ = brute_force_knn(src, queries, Metric.EUCLIDEAN, 10)
    ids, d = fast_flat_knn(
        src, queries, Metric.EUCLIDEAN, 10, oversample=8, scan_mode="folded"
    )
    got, gt = np.asarray(ids), np.asarray(gt_ids)
    recall = np.mean(
        [len(np.intersect1d(got[i], gt[i])) for i in range(64)]
    ) / 10.0
    assert recall >= 0.97, recall
    assert np.all(np.diff(np.asarray(d), axis=1) >= -1e-6)


def test_select_scan_mode_matches_measured_frontier():
    """scan_mode='auto' follows the frontier measured on the H100: the
    exhaustive scan below FOLD_MIN_ROWS, the fused fold from there on."""
    from parallel_hnsw.analysis import FOLD_MIN_ROWS, select_scan_mode

    assert select_scan_mode(10_000) == "exhaustive"
    assert select_scan_mode(FOLD_MIN_ROWS - 1) == "exhaustive"
    assert select_scan_mode(FOLD_MIN_ROWS) == "folded"
    assert select_scan_mode(8_388_608) == "folded"


def test_brute_force_knn_matches_float64_within_epsilon():
    """The exact scan's distances are within the self-match epsilon of
    NumPy float64 on norms where the dot-product expansion alone is not
    (clustered rows with |x|^2 ~ 130)."""
    from parallel_hnsw.analysis import brute_force_knn
    from parallel_hnsw.constants import MATCH_EPSILON
    from parallel_hnsw.utils.data import clustered_corpus

    allv = np.asarray(clustered_corpus(3100, 128, centers=16, seed=3).vectors)
    base, q = allv[:3000], allv[3000:]
    from parallel_hnsw.graph import DenseSource

    ids, d = brute_force_knn(
        DenseSource(vectors=jnp.asarray(base)), jnp.asarray(q),
        Metric.EUCLIDEAN, 10,
    )
    ids, d = np.asarray(ids), np.asarray(d)
    b64, q64 = base.astype(np.float64), q.astype(np.float64)
    d64 = np.sqrt(((q64[:, None, :] - b64[None, :, :]) ** 2).sum(-1))
    want = np.argsort(d64, axis=1, kind="stable")[:, :10]
    got_d64 = np.take_along_axis(d64, ids, axis=1)
    assert np.max(np.abs(d - got_d64)) <= MATCH_EPSILON
    want_d64 = np.take_along_axis(d64, want, axis=1)
    assert np.all((ids == want) | (np.abs(got_d64 - want_d64) <= MATCH_EPSILON))


def test_hnsw_search_exact_fast_path():
    from parallel_hnsw.graph import DenseSource
    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.params import BuildParams

    vecs = _unit(300, 16)
    src = DenseSource(vectors=jnp.asarray(vecs))
    idx = Hnsw([], src, Metric.COSINE, BuildParams())
    ids_exact, _ = idx.search_exact(jnp.asarray(vecs[:8]), k=5)
    ids_fast, _ = idx.search_exact(jnp.asarray(vecs[:8]), k=5, fast=True)
    np.testing.assert_array_equal(np.asarray(ids_fast), np.asarray(ids_exact))
