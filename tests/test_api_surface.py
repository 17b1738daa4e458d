"""API-surface smoke test: every public method of the parity surface runs.

Guards against signature drift while the framework evolves; deep semantics
are covered by the dedicated suites.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw import (
    BuildParams,
    DenseSource,
    Hnsw,
    Metric,
    OptimizationParams,
    SearchParams,
)
from parallel_hnsw.utils.data import make_random_hnsw, random_unit_corpus

BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)


@pytest.fixture(scope="module")
def hnsw():
    source = random_unit_corpus(120, 16, seed=2)
    return Hnsw.generate(source, None, BP, Metric.NORMALIZED_COSINE, seed=2)


def test_accessors(hnsw):
    assert hnsw.layer_count >= 1
    assert hnsw.vector_count == 120
    assert len(hnsw) == 120
    assert 0 <= hnsw.entry_vector < 120
    assert hnsw.get_layer(0) is hnsw.layers[-1]
    assert hnsw.get_layer_from_top(0) is hnsw.layers[0]
    assert hnsw.get_layer_from_top(99) is None
    assert len(hnsw.all_vectors()) == 120
    assert len(hnsw.supers_for_layer(0)) >= 1


def test_search_variants(hnsw):
    q = hnsw.source.vectors[:5]
    ids, dists = hnsw.search(q)
    assert ids.shape == dists.shape
    ids2, d2, stats = hnsw.search_instrumented(q)
    assert stats["hops"] > 0 and stats["distance_evaluations"] > 0
    assert stats["last_improvement_hop"].shape == (5,)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ids2))
    su_ids, _ = hnsw.search_upto(q, upto_layer_from_top=1)
    assert su_ids.shape[0] == 5
    # default = full depth: same results as search() (src/lib.rs:654-665 —
    # search() IS search_layers over the whole stack)
    full_ids, _ = hnsw.search_upto(q)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(full_ids))
    # 0 layers has no entry point; the reference panics (src/search.rs:9-11),
    # we raise
    with pytest.raises(ValueError):
        hnsw.search_upto(q, upto_layer_from_top=0)
    with pytest.raises(ValueError):
        hnsw.search_upto(q, upto_layer_from_top=hnsw.layer_count + 1)
    si_ids, _ = hnsw.search_ids(jnp.arange(5), exclude_self=True)
    for i in range(5):
        assert i not in np.asarray(si_ids[i])
    ex_ids, ex_d = hnsw.search_exact(q, k=3)
    np.testing.assert_array_equal(np.asarray(ex_ids[:, 0]), np.arange(5))


def test_quality_and_repair(hnsw):
    assert 0.0 <= hnsw.stochastic_recall() <= 1.0
    assert 0.0 <= hnsw.stochastic_recall_at(0) <= 1.0
    unreachable = hnsw.discover_unreachable_vectors(hnsw.layer_count - 1)
    assert isinstance(unreachable, np.ndarray)
    hops, isum = hnsw.node_distances_for_layer(0)
    assert hops.shape == (120,)
    promote = hnsw.discover_nodes_to_promote(0)
    assert isinstance(promote, np.ndarray)
    reach = hnsw.reachables_from_node_for_layer(hnsw.layer_count - 1, 0, [0, 1, 2])
    assert reach[0][0] == 0
    hnsw.assert_invariants()


def test_selfsim(hnsw):
    vec_ids, nn_ids, nn_d = hnsw.knn(3, probe_depth=1)
    assert nn_ids.shape == (120, 3)
    vec_ids, nn_ids, nn_d = hnsw.threshold_nn(0.4, probe_depth=1)
    assert nn_ids.shape[0] == 120


def test_make_random_hnsw():
    h = make_random_hnsw(60, 8, bp=BP, seed=1)
    assert h.vector_count == 60


def test_progress_events_and_checkpoint(tmp_path):
    from parallel_hnsw import CallbackProgressMonitor
    from parallel_hnsw.io import deserialize_hnsw

    events = []
    mon = CallbackProgressMonitor(on_update=events.append)
    source = random_unit_corpus(80, 8, seed=5)
    h = Hnsw.generate(
        source, None, BP, Metric.NORMALIZED_COSINE, seed=5,
        progress=mon, checkpoint_dir=str(tmp_path / "ckpt"),
    )
    kinds = {e["type"] for e in events}
    assert "layer_built" in kinds and "improved" in kinds
    loaded = deserialize_hnsw(tmp_path / "ckpt", source=source)
    assert loaded.layer_count == h.layer_count


def test_cancellation():
    from parallel_hnsw import CallbackProgressMonitor, Interrupt

    mon = CallbackProgressMonitor(is_cancelled=lambda: True)
    source = random_unit_corpus(80, 8, seed=5)
    with pytest.raises(Interrupt):
        Hnsw.generate(source, None, BP, Metric.NORMALIZED_COSINE, progress=mon)


def test_custom_source_registration():
    # the Comparator-trait seam: user storage via @source_get.register
    from typing import NamedTuple

    import jax

    from parallel_hnsw.graph import source_get

    class ScaledSource(NamedTuple):
        vectors: jax.Array
        scale: float

        @property
        def dim(self):
            return self.vectors.shape[1]

        @property
        def count(self):
            return self.vectors.shape[0]

    @source_get.register
    def _(source: ScaledSource, ids):
        safe = jnp.clip(ids, 0, source.vectors.shape[0] - 1)
        return jnp.take(source.vectors, safe, axis=0) * source.scale

    base = random_unit_corpus(90, 8, seed=3)
    src = ScaledSource(vectors=base.vectors, scale=1.0)
    h = Hnsw.generate(src, None, BP, Metric.NORMALIZED_COSINE, seed=3)
    ids, _ = h.search(base.vectors[:4])
    np.testing.assert_array_equal(np.asarray(ids[:, 0]), np.arange(4))
