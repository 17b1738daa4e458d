"""Bulk construction tests: ladder math golden values and raw-build recall."""

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.analysis import first_hit_recall
from parallel_hnsw.build import (
    calculate_partitions,
    calculate_partitions_from_bottom,
    generate,
    generate_layer,
)
from parallel_hnsw.constants import EMPTY_ID
from parallel_hnsw.graph import assert_layer_invariants
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams
from parallel_hnsw.utils.data import random_unit_corpus
import jax


def test_partitions_single_entry():
    # reference: test_partitions_with_single_entry (src/lib.rs:2300-2304)
    assert len(calculate_partitions(1, 24)) == 1


def test_partitions_ladder():
    assert calculate_partitions_from_bottom(1000, 2) == [
        1000, 500, 250, 125, 62, 31, 15, 7, 3, 1,
    ]
    assert calculate_partitions(9, 6) == [1, 9]
    parts = calculate_partitions(10000, 12)
    assert parts == [5, 69, 833, 10000]


def test_generate_layer_top_brute_force():
    source = random_unit_corpus(40, 16)
    key = jax.random.PRNGKey(0)
    layer = generate_layer(
        key, jnp.arange(40), 6, [], source, Metric.NORMALIZED_COSINE,
        BuildParams().initial_partition_search,
    )
    nb = np.asarray(layer.neighbors)
    assert nb.shape == (40, 6)
    # every node has at least one neighbor and no self links
    for i in range(40):
        row = nb[i][nb[i] != EMPTY_ID]
        assert len(row) > 0
        assert i not in row
        assert len(set(row.tolist())) == len(row)


def test_generate_small_stack():
    source = random_unit_corpus(500, 32)
    bp = BuildParams()
    layers = generate(source, jnp.arange(500), bp, Metric.NORMALIZED_COSINE, seed=7)
    assert [l.node_count for l in layers] == [3, 41, 500]
    assert_layer_invariants(layers)
    # bottom layer uses the zero-layer neighborhood size
    assert layers[-1].neighborhood_size == bp.zero_layer_neighborhood_size
    assert layers[0].neighborhood_size == bp.neighborhood_size


@pytest.mark.slow
def test_raw_build_recall():
    source = random_unit_corpus(2000, 64)
    bp = BuildParams()
    layers = generate(source, jnp.arange(2000), bp, Metric.NORMALIZED_COSINE, seed=3)
    recall = first_hit_recall(layers, source, Metric.NORMALIZED_COSINE, bp.optimization.search)
    # raw build without the improvement loop; the reference's ≥0.9 gate
    # (src/lib.rs:2217-2224) applies after improve_index runs inside generate.
    assert recall >= 0.8, f"raw recall {recall}"


def test_build_deterministic():
    # same seed → bit-identical graphs (the reference gets per-node
    # reproducibility from seeded per-task RNG, src/lib.rs:729-731; here the
    # whole build is one deterministic program)
    source = random_unit_corpus(300, 16)
    bp = BuildParams()
    a = generate(source, jnp.arange(300), bp, Metric.NORMALIZED_COSINE, seed=9)
    b = generate(source, jnp.arange(300), bp, Metric.NORMALIZED_COSINE, seed=9)
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(la.nodes), np.asarray(lb.nodes))
        np.testing.assert_array_equal(np.asarray(la.neighbors), np.asarray(lb.neighbors))


def test_euclidean_build_and_search():
    # reference: test_euclidean (src/lib.rs:2449-2460) at test scale —
    # unnormalized vectors, true L2 metric
    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.utils.data import random_corpus

    source = random_corpus(800, 32, seed=13)
    bp = BuildParams()
    hnsw = Hnsw.generate(source, None, bp, Metric.EUCLIDEAN, seed=13)
    recall = first_hit_recall(hnsw.layers, source, Metric.EUCLIDEAN, bp.optimization.search)
    assert recall >= 0.95, recall


def test_neighborhood_order_sweep():
    """reference: test_neighborhood_order (src/lib.rs:2306-2343) at test
    scale — the order parameter shapes the ladder, and every order builds a
    searchable graph."""
    source = random_unit_corpus(700, 24, seed=21)
    ladder_counts = {}
    for order in (6, 12, 24):
        bp = BuildParams(order=order)
        layers = generate(source, jnp.arange(700), bp, Metric.NORMALIZED_COSINE, seed=4)
        recall = first_hit_recall(
            layers, source, Metric.NORMALIZED_COSINE, bp.optimization.search
        )
        assert recall >= 0.8, f"order={order} recall {recall}"
        ladder_counts[order] = [l.node_count for l in layers]
    # different orders genuinely produce different ladders
    assert ladder_counts[6] != ladder_counts[24]
