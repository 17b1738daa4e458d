"""All-pairs self-similarity golden tests (knn / threshold_nn) and graph
diagnostics, ported from the reference (src/lib.rs:2358-2420, 279-548)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw import analysis
from parallel_hnsw.constants import EMPTY_ID
from parallel_hnsw.graph import DenseSource, make_layer
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams, OptimizationParams

R = 1.0 / math.sqrt(2.0)
DATA = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [R, R, 0.0],
        [0.5773, 0.5773, 0.5773],
        [-1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0],
        [0.0, R, R],
    ],
    dtype=np.float32,
)

BP = BuildParams(
    order=6,
    neighborhood_size=3,
    zero_layer_neighborhood_size=6,
    optimization=OptimizationParams(recall_proportion=1.0),
)


@pytest.fixture(scope="module")
def hnsw():
    source = DenseSource(jnp.asarray(DATA))
    return Hnsw.generate(source, jnp.arange(9), BP, Metric.COSINE, seed=1)


def test_knn_golden(hnsw):
    # reference: test_knn (src/lib.rs:2358-2377), k=1, probe_depth=1
    vec_ids, nn_ids, nn_d = hnsw.knn(1, probe_depth=1)
    want = {0: (3, 0.29289323), 1: (3, 0.29289323), 2: (8, 0.29289323),
            3: (4, 0.1835745), 4: (3, 0.1835745), 5: (1, 1.0),
            6: (0, 1.0), 7: (0, 1.0), 8: (4, 0.1835745)}
    for i, v in enumerate(vec_ids.tolist()):
        wid, wd = want[v]
        assert nn_ids[i, 0] == wid, (v, nn_ids[i], wid)
        np.testing.assert_allclose(nn_d[i, 0], wd, atol=1e-6)


def test_threshold_nn_golden(hnsw):
    # reference: test_threshold_nn (src/lib.rs:2379-2420), threshold=0.3
    vec_ids, nn_ids, nn_d = hnsw.threshold_nn(0.3, probe_depth=1)
    want = {
        0: [(3, 0.29289323)],
        1: [(3, 0.29289323), (8, 0.29289323)],
        2: [(8, 0.29289323)],
        3: [(4, 0.1835745), (0, 0.29289323), (1, 0.29289323)],
        4: [(3, 0.1835745), (8, 0.1835745)],
        5: [],
        6: [],
        7: [],
        8: [(4, 0.1835745), (1, 0.29289323), (2, 0.29289323)],
    }
    for i, v in enumerate(vec_ids.tolist()):
        got = [
            (int(nn_ids[i, j]), float(nn_d[i, j]))
            for j in range(nn_ids.shape[1])
            if nn_ids[i, j] != EMPTY_ID
        ]
        expect = want[v]
        assert [g[0] for g in got] == [w[0] for w in expect], (v, got, expect)
        np.testing.assert_allclose(
            [g[1] for g in got], [w[1] for w in expect], atol=1e-6
        )


def test_node_distances_reachability(hnsw):
    bottom = hnsw.layers[-1]
    supers = hnsw.supers_for_layer(0)
    hops, isum = analysis.node_distances(bottom, jnp.asarray(supers, jnp.int32))
    # graph achieved full recall → everything reachable from the supers
    assert np.all(hops < np.iinfo(np.int32).max)
    assert np.all(isum < np.iinfo(np.int32).max)
    # deterministic across runs (reference: test_supers, src/lib.rs:2194-2215)
    hops2, isum2 = analysis.node_distances(bottom, jnp.asarray(supers, jnp.int32))
    np.testing.assert_array_equal(hops, hops2)
    np.testing.assert_array_equal(isum, isum2)


def test_unreachable_bfs_detects_disconnected():
    # a node with no incoming edges is BFS-unreachable
    nb = np.array(
        [[1, EMPTY_ID], [0, EMPTY_ID], [EMPTY_ID, EMPTY_ID]], dtype=np.int32
    )
    layer = make_layer([10, 20, 30], nb)
    hops, _ = analysis.node_distances(layer, jnp.asarray([10], jnp.int32))
    assert hops[2] == np.iinfo(np.int32).max
    promote = analysis.discover_nodes_to_promote(layer, jnp.asarray([10], jnp.int32))
    assert promote.tolist() == [2]


def test_reachables_and_reverse(hnsw):
    bottom = hnsw.layers[-1]
    res = analysis.reachables_from(bottom, 0, list(range(9)))
    reached = {n for n, _ in res}
    assert len(reached) >= 5  # dense little graph
    rev = analysis.reverse_get_neighbors(bottom, 4)
    nb = np.asarray(bottom.neighbors)
    for r in rev:
        assert 4 in nb[r]


def test_group_nodes_by_vectors(hnsw):
    bottom = hnsw.layers[-1]
    part = analysis.group_nodes_by_vectors(
        bottom, hnsw.source, Metric.COSINE, jnp.asarray([0, 1], jnp.int32)
    )
    # vector 0 belongs to super 0's group; vector 1 to super 1's
    assert part[0] == 0 and part[1] == 1


def test_multi_node_distances(hnsw):
    bottom = hnsw.layers[-1]
    supers = jnp.asarray(hnsw.supers_for_layer(0), jnp.int32)
    sup_idx, hops, isum = analysis.multi_node_distances(bottom, supers, k=2)
    n = bottom.node_count
    assert sup_idx.shape == (n, min(2, len(supers)))
    # the closest (by hops) super of a reachable node has finite distances
    assert (hops[:, 0] < np.iinfo(np.int32).max).all()


def test_node_distances_from_closest_super(hnsw):
    bottom = hnsw.layers[-1]
    supers = jnp.asarray(hnsw.supers_for_layer(0), jnp.int32)
    hops, isum = analysis.node_distances_from_closest_super(
        bottom, hnsw.source, Metric.COSINE, supers
    )
    # super nodes are distance 0 from themselves
    nodes = np.asarray(bottom.nodes)
    for s in np.asarray(supers):
        pos = int(np.searchsorted(nodes, s))
        assert hops[pos] == 0
    not_conn = analysis.nodes_not_connected_to_super(
        bottom, hnsw.source, Metric.COSINE, supers
    )
    assert len(not_conn) == 0  # fully-repaired tiny graph


def test_threshold_nn_dense_cluster_per_node_doubling():
    """One tight cluster used to force a whole-corpus re-scan per doubling;
    doublings must now retire covered nodes and only
    re-search the cluster, with output semantics unchanged."""
    rng = np.random.default_rng(7)
    sparse = rng.normal(size=(48, 4)).astype(np.float32)
    sparse /= np.linalg.norm(sparse, axis=1, keepdims=True)
    center = sparse[0]
    cluster = center[None, :] + rng.normal(scale=1e-3, size=(12, 4)).astype(np.float32)
    cluster /= np.linalg.norm(cluster, axis=1, keepdims=True)
    data = np.concatenate([sparse, cluster]).astype(np.float32)

    source = DenseSource(jnp.asarray(data))
    bp = BuildParams(
        order=6,
        neighborhood_size=4,
        zero_layer_neighborhood_size=8,
        optimization=OptimizationParams(recall_proportion=1.0),
    )
    h = Hnsw.generate(source, jnp.arange(len(data)), bp, Metric.COSINE, seed=2)

    threshold = 1e-4
    vec_ids, nn_ids, nn_d = h.threshold_nn(threshold, probe_depth=4,
                                           initial_search_depth=4)
    # ground truth: cosine distances under the threshold
    dots = data @ data.T
    gt = 1.0 - dots
    for i, v in enumerate(vec_ids.tolist()):
        want = set(np.nonzero((gt[v] < threshold))[0].tolist()) - {v}
        got = set(int(x) for x in nn_ids[i] if x != EMPTY_ID)
        assert got == want, (v, got, want)
