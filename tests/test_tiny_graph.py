"""End-to-end search over the reference's golden 9-vector graph.

The graph is host-built to exactly match the expected neighbors slab from the
reference's ``test_generation`` (reference: src/lib.rs:2070-2152), and
search results are checked against ``test_nearness_search``
(src/lib.rs:2046-2068) including exact distances.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.constants import EMPTY_ID, MATCH_EPSILON
from parallel_hnsw.graph import DenseSource, make_layer
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import SearchParams
from parallel_hnsw.search import search

R = 1.0 / math.sqrt(2.0)
SILLY_DATA = np.array(
    [
        [1.0, 0.0, 0.0],  # 0
        [0.0, 1.0, 0.0],  # 1
        [0.0, 0.0, 1.0],  # 2
        [R, R, 0.0],  # 3
        [0.5773, 0.5773, 0.5773],  # 4
        [-1.0, 0.0, 0.0],  # 5
        [0.0, -1.0, 0.0],  # 6
        [0.0, 0.0, -1.0],  # 7
        [0.0, R, R],  # 8
    ],
    dtype=np.float32,
)

# Golden bottom-layer slab from reference test_generation (src/lib.rs:2090-2151),
# 9 rows x 6 neighbors.
GOLDEN_NEIGHBORS = np.array(
    [
        [3, 4, 1, 2, 6, 7],
        [3, 8, 4, 0, 2, 5],
        [8, 4, 0, 1, 3, 5],
        [4, 0, 1, 8, 2, 7],
        [3, 8, 0, 1, 2, 5],
        [1, 2, 6, 8, 4, 3],
        [0, 2, 5, 7, 4, 3],
        [0, 1, 3, 6, 4, 8],
        [4, 1, 2, 3, 0, 5],
    ],
    dtype=np.int32,
)


def golden_layers():
    top = make_layer([0], [[EMPTY_ID, EMPTY_ID, EMPTY_ID]])
    bottom = make_layer(np.arange(9, dtype=np.int32), GOLDEN_NEIGHBORS)
    return [top, bottom]


@pytest.fixture(scope="module")
def setup():
    return golden_layers(), DenseSource(jnp.asarray(SILLY_DATA)), SearchParams()


def test_nearness_search_parity(setup):
    layers, source, sp = setup
    query = jnp.asarray([[0.0, R, R]], jnp.float32)
    ids, dists = search(layers, source, Metric.COSINE, query, sp)
    want = [
        (8, 5.9604645e-8),
        (4, 0.1835745),
        (1, 0.29289323),
        (2, 0.29289323),
        (3, 0.5),
        (0, 1.0),
        (5, 1.0),
        (6, 1.7071068),
        (7, 1.7071068),
    ]
    got_ids = np.asarray(ids[0][: len(want)])
    got_dists = np.asarray(dists[0][: len(want)])
    np.testing.assert_array_equal(got_ids, [w[0] for w in want])
    np.testing.assert_allclose(got_dists, [w[1] for w in want], atol=1e-6)
    # everything after is empty
    assert np.all(np.asarray(ids[0][len(want) :]) == EMPTY_ID)


def test_every_vector_finds_itself(setup):
    # reference: test_search (src/lib.rs:2154-2164)
    layers, source, sp = setup
    queries = jnp.asarray(SILLY_DATA)
    ids, dists = search(layers, source, Metric.COSINE, queries, sp)
    top_ids = np.asarray(ids[:, 0])
    top_dists = np.asarray(dists[:, 0])
    np.testing.assert_array_equal(top_ids, np.arange(9))
    # vector 4 ([0.5773]*3) is not exactly unit-norm, so its self-distance is
    # ~1.7e-4 — the same value the reference's fp32 arithmetic produces.
    assert np.all(top_dists < 1e-3)


def test_exclude_self(setup):
    layers, source, sp = setup
    queries = jnp.asarray(SILLY_DATA)
    exclude = jnp.arange(9, dtype=jnp.int32)
    ids, dists = search(layers, source, Metric.COSINE, queries, sp, exclude=exclude)
    got = np.asarray(ids)
    for i in range(9):
        assert i not in got[i], f"query {i} still returned itself"


def test_beam_width_one_matches_wide(setup):
    layers, source, sp = setup
    queries = jnp.asarray(SILLY_DATA)
    ids1, _ = search(layers, source, Metric.COSINE, queries, sp.replace(beam_width=1))
    ids4, _ = search(layers, source, Metric.COSINE, queries, sp.replace(beam_width=4))
    # on this tiny graph with ef=300, both must find the full sorted set
    np.testing.assert_array_equal(np.asarray(ids1), np.asarray(ids4))


def test_query_chunking(setup):
    layers, source, sp = setup
    queries = jnp.asarray(SILLY_DATA)
    ids_a, _ = search(layers, source, Metric.COSINE, queries, sp)
    ids_b, _ = search(layers, source, Metric.COSINE, queries, sp, query_block=4)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))


def test_adaptive_host_path_matches_lockstep(setup):
    """The host-driven convergence-tail compaction path (search_host) runs the
    same hop math in retiring chunks; results must equal the lockstep program
    (the adaptive path must be covered or deleted)."""
    layers, source, sp = setup
    queries = jnp.asarray(SILLY_DATA)
    ids_a, d_a = search(layers, source, Metric.COSINE, queries, sp)
    ids_b, d_b = search(layers, source, Metric.COSINE, queries, sp, adaptive=True)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
    np.testing.assert_allclose(np.asarray(d_a), np.asarray(d_b), atol=1e-6)


def test_adaptive_host_path_larger_graph():
    """Adaptive vs lockstep on a built graph with stragglers (mixed
    convergence times) — exercises the compaction/retire logic itself."""
    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.params import BuildParams, OptimizationParams
    from parallel_hnsw.utils.data import random_unit_corpus

    src = random_unit_corpus(600, 16, seed=3)
    hnsw = Hnsw.generate(
        src, None, BuildParams(optimization=OptimizationParams(recall_proportion=0.5)),
        Metric.COSINE, seed=0,
    )
    sp = SearchParams(number_of_candidates=24, upper_layer_candidate_count=24)
    q = src.vectors[:128]
    ids_a, _ = search(hnsw.layers, src, Metric.COSINE, q, sp)
    ids_b, _ = search(hnsw.layers, src, Metric.COSINE, q, sp, adaptive=True)
    got_a, got_b = np.asarray(ids_a[:, :10]), np.asarray(ids_b[:, :10])
    # identical top-10 sets for every query (order ties can differ only at
    # equal distance; (dist, id) lex sort makes order deterministic too)
    np.testing.assert_array_equal(got_a, got_b)
