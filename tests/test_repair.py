"""Self-repair tests: the improve/promote loop heals broken graphs.

Mirrors the reference's broken-graph fixture (make_broken_hnsw,
reference: src/lib.rs:2017-2044) and test_tiny_index_improvement
(src/lib.rs:2287-2298).
"""

import math

import jax.numpy as jnp
import numpy as np

from parallel_hnsw.constants import EMPTY_ID
from parallel_hnsw.graph import DenseSource, Layer
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams, OptimizationParams, SearchParams

R = 1.0 / math.sqrt(2.0)
DATA10 = np.array(
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
        [R, 0.0, R],  # the extra vector the broken fixture disconnects
    ],
    dtype=np.float32,
)

BP = BuildParams(
    order=6,
    neighborhood_size=3,
    zero_layer_neighborhood_size=6,
    optimization=OptimizationParams(recall_proportion=1.0),
)


def build_simple():
    source = DenseSource(jnp.asarray(DATA10))
    return Hnsw.generate(
        source, jnp.arange(9), BP, Metric.COSINE, seed=1, improve=True
    )


def test_tiny_generate_full_recall():
    hnsw = build_simple()
    hnsw.assert_invariants()
    assert hnsw.vector_count == 9
    recall = hnsw.stochastic_recall()
    assert recall == 1.0, recall


def test_broken_graph_repair():
    hnsw = build_simple()
    # break it: append vector 9 to the bottom layer with no links
    bottom = hnsw.layers[-1]
    nodes = jnp.concatenate([bottom.nodes, jnp.asarray([9], jnp.int32)])
    neighbors = jnp.concatenate(
        [bottom.neighbors, jnp.full((1, bottom.neighborhood_size), EMPTY_ID, jnp.int32)]
    )
    hnsw.layers[-1] = Layer(nodes=nodes, neighbors=neighbors)

    unreachable = hnsw.discover_unreachable_vectors(hnsw.layer_count - 1)
    assert 9 in unreachable.tolist()

    recall = hnsw.improve_index()
    assert recall == 1.0, recall
    hnsw.assert_invariants()
    # vector 9 is now findable
    ids, dists = hnsw.search(jnp.asarray(DATA10[9:10]))
    assert int(ids[0, 0]) == 9
    assert float(dists[0, 0]) < 1e-5


def test_extend_layer_remap():
    hnsw = build_simple()
    before = {tuple(np.asarray(l.nodes).tolist()) for l in hnsw.layers}
    # extend the layer above the bottom (layer_id counts from bottom)
    if hnsw.layer_count >= 2:
        target_from_bottom = 1
        target = hnsw.get_layer(target_from_bottom)
        missing = sorted(
            set(range(9)) - set(np.asarray(target.nodes).tolist())
        )
        if missing:
            hnsw.extend_layer(target_from_bottom, np.asarray(missing[:2]))
            hnsw.assert_invariants()
            after = hnsw.get_layer(target_from_bottom)
            assert after.node_count == target.node_count + min(2, len(missing))
