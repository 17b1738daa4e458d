"""Neighbor-major hop slabs: result parity, routing composition,
invalidation on graph mutation."""

import jax.numpy as jnp
import numpy as np

from parallel_hnsw.graph import DenseSource
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams, OptimizationParams
from parallel_hnsw.utils.data import random_unit_corpus

BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)


def _index(n=600, d=16, seed=5):
    source = random_unit_corpus(n, d, seed=seed)
    return source, Hnsw.generate(source, None, BP, Metric.COSINE, seed=0)


def test_slab_search_matches_plain_exactly():
    """Full-precision slabs are a pure memory-layout change: identical
    (ids, dists) to the per-candidate gather hop."""
    source, h = _index()
    queries = source.vectors[:64]
    ids0, d0 = h.search(queries)
    h.enable_hop_slabs()
    assert h._hop_slabs is not None and not h._hop_slabs.routed
    ids1, d1 = h.search(queries)
    np.testing.assert_array_equal(np.asarray(ids0), np.asarray(ids1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), atol=0)


def test_slab_over_routing_rows_keeps_recall():
    """bf16 routed slabs + exact rerank: same contract as plain routing."""
    source, h = _index()
    queries = source.vectors[:64]
    gt, _ = h.search(queries)
    gt = np.asarray(gt[:, :5])
    h.enable_routing(dr=None)
    h.enable_hop_slabs()
    assert h._hop_slabs.routed
    ids, _ = h.search(queries)
    got = np.asarray(ids[:, :5])
    recall = np.mean([len(np.intersect1d(got[i], gt[i])) for i in range(64)]) / 5
    assert recall >= 0.95, recall


def test_mutation_invalidates_slabs():
    _, h = _index(n=300)
    h.enable_hop_slabs()
    assert h._hop_slabs is not None
    h.improve_neighbors()
    assert h._hop_slabs is None  # derived state dropped on graph change


def test_slab_memory_budget_enforced():
    import pytest

    _, h = _index(n=300)
    with pytest.raises(ValueError, match="budget"):
        h.enable_hop_slabs(byte_budget=1024)


def test_pq_code_graph_with_routed_slabs():
    """Slabs on the PQ code graph: same rerank contract, recall holds."""
    from parallel_hnsw.params import PqBuildParams
    from parallel_hnsw.pq import QuantizedHnsw

    source = random_unit_corpus(800, 32, seed=9)
    q = QuantizedHnsw.new(
        number_of_centroids=64,
        full_source=source,
        dsub=8,
        metric=Metric.COSINE,
        pqp=PqBuildParams(centroids=BP, hnsw=BP),
        seed=0,
        exact_quantize=True,
    )
    queries = source.vectors[:48]
    base_ids, _ = q.search(queries)
    q.enable_routing(dr=None)
    q.enable_hop_slabs()
    slab_ids, _ = q.search(queries)
    a, b = np.asarray(base_ids[:, 0]), np.asarray(slab_ids[:, 0])
    assert (a == b).mean() >= 0.95, (a == b).mean()
