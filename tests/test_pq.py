"""PQ tests mirroring the reference's fixture zoo (src/pq.rs:479-979):
quantize/reconstruct round-trip, centroid-graph recall, end-to-end recall,
ADC consistency, k-means."""

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.graph import PqSource, reconstruct, source_get
from parallel_hnsw.ops.distance import Metric, pairwise_distance
from parallel_hnsw.params import (
    BuildParams,
    OptimizationParams,
    PqBuildParams,
    SearchParams,
)
from parallel_hnsw.pq import (
    QuantizedHnsw,
    adc_lut,
    adc_scan,
    kmeans_centroids,
    random_centroids,
)
from parallel_hnsw.utils.data import random_unit_corpus

SMALL_BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)
PQP = PqBuildParams(
    centroids=SMALL_BP, hnsw=SMALL_BP, quantized_search=SearchParams(number_of_candidates=32, upper_layer_candidate_count=32)
)


def test_random_centroids_dedup_shape():
    src = random_unit_corpus(50, 16)
    cents = random_centroids(src.vectors, 32, 4, seed=0)
    assert cents.shape[1] == 4
    assert cents.shape[0] <= 32
    # no duplicate rows
    assert len(np.unique(cents, axis=0)) == len(cents)


def test_kmeans_reduces_distortion():
    src = random_unit_corpus(200, 16)
    subs = np.asarray(src.vectors).reshape(-1, 4)
    rand = random_centroids(src.vectors, 16, 4, seed=0)
    km = kmeans_centroids(src.vectors, 16, 4, iters=8, seed=0)

    def distortion(cents):
        d = np.asarray(
            pairwise_distance(jnp.asarray(subs), jnp.asarray(cents), Metric.SQUARED_EUCLIDEAN)
        )
        return d.min(axis=1).mean()

    assert distortion(km) <= distortion(rand) * 1.05


def test_reconstruct_shared_codebook():
    book = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    codes = jnp.asarray([[0, 3], [7, 1]], jnp.int32)
    out = np.asarray(reconstruct(jnp.asarray(book), codes))
    np.testing.assert_allclose(out[0], np.concatenate([book[0], book[3]]))
    np.testing.assert_allclose(out[1], np.concatenate([book[7], book[1]]))


@pytest.fixture(scope="module")
def small_pq():
    # reference: test_small_pq (src/pq.rs:865-919): 16 = 4x4
    src = random_unit_corpus(300, 16, seed=11)
    return QuantizedHnsw.new(
        number_of_centroids=64,
        full_source=src,
        dsub=4,
        metric=Metric.EUCLIDEAN,
        pqp=PQP,
        seed=4,
        exact_quantize=True,
    ), src


def test_quantize_reconstruct_roundtrip(small_pq):
    q, src = small_pq
    vecs = src.vectors[:20]
    codes = q.quantizer.quantize(vecs, exact=True)
    recon = q.quantizer.reconstruct(codes)
    # reconstruction error bounded (random codebook of 64 on unit vectors)
    err = np.linalg.norm(np.asarray(recon) - np.asarray(vecs), axis=-1)
    assert err.mean() < 1.0


def test_pq_source_distance_uses_reconstruction(small_pq):
    q, src = small_pq
    pq_src = q.hnsw.source
    assert isinstance(pq_src, PqSource)
    got = np.asarray(source_get(pq_src, jnp.asarray([0, 1], jnp.int32)))
    want = np.asarray(q.quantizer.reconstruct(pq_src.codes[:2]))
    np.testing.assert_allclose(got, want)


def test_pq_search_with_rerank_recall(small_pq):
    q, src = small_pq
    ids, dists = q.search(src.vectors, rerank=True, exact_quantize=True)
    hits = np.asarray(ids[:, 0]) == np.arange(src.count)
    recall = hits.mean()
    assert recall >= 0.9, recall
    # reranked distances are exact full-precision distances, ascending over
    # the finite (non-padding) prefix (inf-padding replaced to avoid inf-inf)
    d = np.asarray(dists)
    capped = np.where(np.isfinite(d), d, 1e30)
    diffs = np.diff(capped, axis=-1)
    assert np.all(diffs >= -1e-6)


def test_adc_matches_reconstructed_distance(small_pq):
    q, src = small_pq
    pq_src = q.hnsw.source
    queries = src.vectors[:8]
    lut = adc_lut(queries, pq_src.codebook, Metric.EUCLIDEAN)
    got = np.asarray(adc_scan(lut, pq_src.codes[:50], Metric.EUCLIDEAN))
    recon = np.asarray(source_get(pq_src, jnp.arange(50)))
    want = np.asarray(
        pairwise_distance(queries, jnp.asarray(recon), Metric.EUCLIDEAN)
    )
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_adc_matches_cosine(small_pq):
    q, src = small_pq
    pq_src = q.hnsw.source
    queries = src.vectors[:4]
    lut = adc_lut(queries, pq_src.codebook, Metric.COSINE)
    got = np.asarray(adc_scan(lut, pq_src.codes[:20], Metric.COSINE))
    recon = np.asarray(source_get(pq_src, jnp.arange(20)))
    want = np.asarray(pairwise_distance(queries, jnp.asarray(recon), Metric.COSINE))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_adc_flat_scan_search(small_pq):
    q, src = small_pq
    ids, dists = q.search_exact(src.vectors, k=10, rerank=True)
    hits = np.asarray(ids[:, 0]) == np.arange(src.count)
    assert hits.mean() >= 0.9, hits.mean()


def test_adc_flat_scan_matches_reconstruction_ranking(small_pq):
    q, src = small_pq
    # without rerank, the flat ADC scan must equal brute force over the
    # reconstructed corpus
    from parallel_hnsw.analysis import brute_force_knn

    ids, dists = q.search_exact(src.vectors[:20], k=5, rerank=False)
    gt_ids, gt_d = brute_force_knn(q.hnsw.source, src.vectors[:20], Metric.EUCLIDEAN, 5)
    np.testing.assert_allclose(
        np.sort(np.asarray(dists), -1), np.sort(np.asarray(gt_d), -1), atol=1e-4
    )


def test_flat_scan_oversampled_rerank_matches_manual(small_pq):
    """Regression for a bug where rerank kept only k scan survivors:
    scan at oversample*k, exact-rerank, cut to k must equal the manual
    pipeline (scan(rerank=False, k=oversample*k) -> exact rerank -> top-k)."""
    q, src = small_pq
    queries = src.vectors[:16]
    k, oversample = 5, 4
    ids, dists = q.search_exact(queries, k=k, rerank=True, oversample=oversample)

    # manual: widened code scan, then exact full-precision rerank
    wide_ids, _ = q.search_exact(queries, k=k * oversample, rerank=False)
    cand = np.asarray(source_get(src, jnp.asarray(wide_ids)))
    d_exact = np.einsum("qcd,qcd->qc", cand - np.asarray(queries)[:, None, :],
                        cand - np.asarray(queries)[:, None, :]) ** 0.5
    order = np.argsort(d_exact, axis=-1, kind="stable")[:, :k]
    want_ids = np.take_along_axis(np.asarray(wide_ids), order, -1)
    want_d = np.take_along_axis(d_exact, order, -1)

    np.testing.assert_allclose(np.asarray(dists), want_d, atol=1e-5)
    # ids may differ only where distances tie
    mism = np.asarray(ids) != want_ids
    assert np.all(np.isclose(np.asarray(dists)[mism], want_d[mism], atol=1e-5))


def test_flat_scan_rerank_recall_matches_exact_scan(small_pq):
    """bf16 fast-scan + oversampled exact rerank must not lose recall vs the
    exact-precision scan."""
    from parallel_hnsw.analysis import brute_force_knn

    q, src = small_pq
    queries = src.vectors[:32]
    k = 5
    gt_ids, _ = brute_force_knn(src, queries, Metric.EUCLIDEAN, k)

    def recall(ids):
        hits = 0
        for row, gt in zip(np.asarray(ids), np.asarray(gt_ids)):
            hits += len(set(row.tolist()) & set(gt.tolist()))
        return hits / gt_ids.size

    r_fast = recall(q.search_exact(queries, k=k, rerank=True)[0])
    # exact scan over codes + rerank has the same survivors at equal width
    r_exact = recall(q.search_exact(queries, k=k, rerank=True, oversample=1)[0])
    assert r_fast >= r_exact - 1e-9


def test_unique_rows_device_matches_np_unique():
    from parallel_hnsw.pq import unique_rows_device

    rng = np.random.default_rng(4)
    base = rng.normal(size=(200, 4)).astype(np.float32)
    dup = np.concatenate([base, base[:77], base[13:14]])  # many exact dups
    rng.shuffle(dup)
    got = unique_rows_device(jnp.asarray(dup), seed=1)
    want = np.unique(dup, axis=0)
    got_sorted = got[np.lexsort(got.T[::-1])]
    np.testing.assert_array_equal(got_sorted, want)


def test_quantize_binned_matches_exact():
    from parallel_hnsw.pq import quantize_binned
    from parallel_hnsw.analysis import blocked_topk_pairwise

    rng = np.random.default_rng(9)
    subs = jnp.asarray(rng.normal(size=(3000, 4)).astype(np.float32))
    cents = jnp.asarray(rng.normal(size=(1500, 4)).astype(np.float32))
    fast = np.asarray(quantize_binned(subs, cents, Metric.SQUARED_EUCLIDEAN, block=1024))
    ids, _ = blocked_topk_pairwise(subs, cents, Metric.SQUARED_EUCLIDEAN, 1)
    exact = np.asarray(ids[:, 0])
    agree = (fast == exact).mean()
    assert agree >= 0.99, agree  # double-collision misses only


def test_quantizer_fast_path_end_to_end():
    """HnswQuantizer.quantize(fast=True) codes reconstruct as well as exact."""
    from parallel_hnsw.graph import reconstruct as _recon
    from parallel_hnsw.pq import HnswQuantizer
    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.graph import DenseSource

    src = random_unit_corpus(300, 16, seed=2)
    cents = random_centroids(src.vectors, 128, 4, seed=0)
    chnsw = Hnsw.generate(
        DenseSource(vectors=jnp.asarray(cents)), None, SMALL_BP,
        Metric.SQUARED_EUCLIDEAN, seed=0,
    )
    quant = HnswQuantizer(chnsw, 4, PQP)
    c_exact = quant.quantize(src.vectors, exact=True)
    c_fast = quant.quantize(src.vectors, fast=True)
    agree = (np.asarray(c_exact) == np.asarray(c_fast)).mean()
    assert agree >= 0.99, agree


def test_quantize_binned_chunk_boundaries():
    """Blocked dispatch (block < n) returns the same codes as one block."""
    from parallel_hnsw.pq import quantize_binned

    rng = np.random.default_rng(12)
    subs = jnp.asarray(rng.normal(size=(1000, 4)).astype(np.float32))
    cents = jnp.asarray(rng.normal(size=(300, 4)).astype(np.float32))
    one = np.asarray(quantize_binned(subs, cents, Metric.SQUARED_EUCLIDEAN, block=4096))
    many = np.asarray(quantize_binned(subs, cents, Metric.SQUARED_EUCLIDEAN, block=256))
    np.testing.assert_array_equal(one, many)


# ---------------------------------------------------------------------------
# Per-subspace codebooks (classic PQ; a capability beyond the reference's
# shared codebook, src/pq.rs:261-285)


def _shifted_corpus(n=400, dim=16, dsub=4, seed=7):
    """Corpus whose subspaces have different offsets, so a per-subspace
    codebook has a real capacity advantage over a shared one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    for j in range(dim // dsub):
        x[:, j * dsub : (j + 1) * dsub] += 3.0 * j
    return x


def test_per_subspace_centroids_shape():
    from parallel_hnsw.pq import per_subspace_centroids

    x = _shifted_corpus()
    books = per_subspace_centroids(x, 32, 4, seed=0)
    assert books.shape == (4, 32, 4)
    assert books.dtype == np.float32


def test_subspace_quantizer_beats_shared_codebook():
    """Equal K, identical code bytes: per-subspace codebooks must reconstruct
    strictly better than the shared codebook when subspace distributions
    differ (the capacity argument for classic PQ)."""
    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.graph import DenseSource
    from parallel_hnsw.pq import (
        HnswQuantizer,
        SubspaceQuantizer,
        kmeans_centroids,
        per_subspace_centroids,
    )

    x = _shifted_corpus()
    k, dsub = 16, 4
    shared = kmeans_centroids(x, k, dsub, iters=8, seed=0)
    chnsw = Hnsw.generate(
        DenseSource(vectors=jnp.asarray(shared)), None, SMALL_BP,
        Metric.SQUARED_EUCLIDEAN, seed=0,
    )
    q_shared = HnswQuantizer(chnsw, 4, PQP)
    books = per_subspace_centroids(x, k, dsub, seed=0, iters=8)
    q_sub = SubspaceQuantizer(jnp.asarray(books), Metric.EUCLIDEAN, PQP)

    xs = jnp.asarray(x)

    def mse(q):
        recon = np.asarray(q.reconstruct(q.quantize(xs, exact=True)))
        return ((recon - x) ** 2).mean()

    assert mse(q_sub) < mse(q_shared) * 0.5, (mse(q_sub), mse(q_shared))


def test_subspace_quantizer_fast_matches_exact():
    # n must exceed K so the codebooks hold DISTINCT centroids — tiling
    # duplicates would make exact/binned tie-breaks diverge harmlessly
    from parallel_hnsw.pq import SubspaceQuantizer, per_subspace_centroids

    # zero-mean data: the bf16 scan's resolution is relative to vector
    # magnitude, so large per-subspace offsets would drown the ~0.1-scale
    # nearest-centroid gaps in cancellation (true of every fast-scan path,
    # not specific to SubspaceQuantizer)
    x = np.random.default_rng(8).normal(size=(6000, 16)).astype(np.float32)
    books = per_subspace_centroids(x, 4096, 4, seed=1, use_kmeans=False)
    assert all(len(np.unique(b, axis=0)) == 4096 for b in books)
    q = SubspaceQuantizer(jnp.asarray(books), Metric.EUCLIDEAN, PQP)
    c_exact = np.asarray(q.quantize(jnp.asarray(x), exact=True))
    c_fast = np.asarray(q.quantize(jnp.asarray(x), fast=True))
    # at K=4096 in 4-d, many centroids are near-ties the bf16 scan cannot
    # order — codes may differ, but the RECONSTRUCTION quality must match
    # (that is the quantizer contract; cf. test_quantize_binned_matches_exact
    # for the low-tie regime where codes agree outright)
    e_exact = ((np.asarray(q.reconstruct(jnp.asarray(c_exact))) - x) ** 2).sum(-1)
    e_fast = ((np.asarray(q.reconstruct(jnp.asarray(c_fast))) - x) ** 2).sum(-1)
    assert e_fast.mean() <= e_exact.mean() * 1.02, (e_fast.mean(), e_exact.mean())


@pytest.fixture(scope="module")
def subspace_pq():
    src = random_unit_corpus(300, 16, seed=21)
    return QuantizedHnsw.new(
        number_of_centroids=64,
        full_source=src,
        dsub=4,
        metric=Metric.EUCLIDEAN,
        pqp=PQP,
        seed=4,
        per_subspace=True,
        use_kmeans=True,
    ), src


def test_per_subspace_end_to_end_search(subspace_pq):
    q, src = subspace_pq
    from parallel_hnsw.pq import SubspaceQuantizer

    assert isinstance(q.quantizer, SubspaceQuantizer)
    assert q.centroid_hnsw() is None  # no centroid graph in this mode
    ids, dists = q.search(src.vectors, rerank=True)
    hits = np.asarray(ids[:, 0]) == np.arange(src.count)
    assert hits.mean() >= 0.9, hits.mean()


def test_per_subspace_flat_scan_adc(subspace_pq):
    """search_exact's ADC path must accept the [nsub, K, dsub] codebook."""
    q, src = subspace_pq
    ids, dists = q.search_exact(src.vectors[:64], k=10, rerank=True)
    hits = np.asarray(ids[:, 0]) == np.arange(64)
    assert hits.mean() >= 0.9, hits.mean()


def test_per_subspace_reconstruction_beats_shared(subspace_pq):
    """On the same corpus/K/dsub, the per-subspace index's code
    reconstructions are at least as good as the shared-codebook index's."""
    q_sub, src = subspace_pq
    q_shared = QuantizedHnsw.new(
        number_of_centroids=64, full_source=src, dsub=4,
        metric=Metric.EUCLIDEAN, pqp=PQP, seed=4, exact_quantize=True,
        use_kmeans=True,
    )
    x = np.asarray(src.vectors)

    def mse(q):
        recon = np.asarray(
            q.quantizer.reconstruct(q.quantizer.quantize(src.vectors, exact=True))
        )
        return ((recon - x) ** 2).mean()

    assert mse(q_sub) <= mse(q_shared) * 1.05


def test_kmeans_big_matches_plain_path():
    """The blocked binned-argmin + segment-sum k-means (the K=65,535 path)
    converges to the same centroids as the plain jitted loop on the same
    init (assignments are near-exact, so drift is collision-only)."""
    from parallel_hnsw.pq import _kmeans_big, _kmeans_jit

    rng = np.random.default_rng(3)
    subs = jnp.asarray(rng.normal(size=(4000, 4)).astype(np.float32))
    init = np.asarray(subs)[rng.permutation(4000)[:64]]
    a = np.asarray(_kmeans_jit(subs, jnp.asarray(init), 64, 4))
    b = np.asarray(_kmeans_big(subs, jnp.asarray(init), 64, 4, block=1024))

    def distortion(cents):
        d = np.asarray(
            pairwise_distance(subs, jnp.asarray(cents), Metric.SQUARED_EUCLIDEAN)
        )
        return d.min(axis=1).mean()

    np.testing.assert_allclose(distortion(b), distortion(a), rtol=0.02)
