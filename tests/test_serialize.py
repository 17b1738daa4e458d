"""Persistence round-trip tests (reference format: src/serialize.rs)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.graph import DenseSource, PqSource
from parallel_hnsw.index import Hnsw
from parallel_hnsw.io import (
    IndexNotFound,
    deserialize_hnsw,
    deserialize_source,
    serialize_hnsw,
    serialize_source,
)
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams, OptimizationParams
from parallel_hnsw.utils.data import random_unit_corpus


def build(count=120, dim=8):
    source = random_unit_corpus(count, dim)
    bp = BuildParams(
        order=6,
        neighborhood_size=4,
        zero_layer_neighborhood_size=8,
        optimization=OptimizationParams(recall_proportion=1.0),
    )
    return Hnsw.generate(source, None, bp, Metric.NORMALIZED_COSINE, seed=2)


def test_round_trip(tmp_path):
    hnsw = build()
    serialize_hnsw(hnsw, tmp_path / "idx")
    loaded = deserialize_hnsw(tmp_path / "idx")
    assert loaded.layer_count == hnsw.layer_count
    assert loaded.metric == hnsw.metric
    assert loaded.build_parameters == hnsw.build_parameters
    for a, b in zip(hnsw.layers, loaded.layers):
        np.testing.assert_array_equal(np.asarray(a.nodes), np.asarray(b.nodes))
        np.testing.assert_array_equal(np.asarray(a.neighbors), np.asarray(b.neighbors))
    np.testing.assert_array_equal(
        np.asarray(hnsw.source.vectors), np.asarray(loaded.source.vectors)
    )
    # identical search results
    q = hnsw.source.vectors[:5]
    i1, d1 = hnsw.search(q)
    i2, d2 = loaded.search(q)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_missing_comparator(tmp_path):
    hnsw = build()
    serialize_hnsw(hnsw, tmp_path / "idx", store_source=False)
    with pytest.raises(IndexNotFound):
        deserialize_hnsw(tmp_path / "idx")
    # but works with an externally supplied source
    loaded = deserialize_hnsw(tmp_path / "idx", source=hnsw.source)
    assert loaded.layer_count == hnsw.layer_count


def test_layer_files_numbered_from_bottom(tmp_path):
    hnsw = build()
    serialize_hnsw(hnsw, tmp_path / "idx")
    # bottom layer is layer.*.0 like the reference (serialize.rs:66-67)
    meta0 = json.loads((tmp_path / "idx" / "layer.meta.0").read_text())
    assert meta0["node_count"] == hnsw.vector_count


def test_pq_source_round_trip(tmp_path):
    codes = jnp.asarray(np.random.default_rng(0).integers(0, 16, (30, 4)), jnp.int32)
    book = jnp.asarray(np.random.default_rng(1).normal(size=(4, 16, 2)), jnp.float32)
    src = PqSource(codes=codes, codebook=book)
    serialize_source(src, tmp_path / "pq")
    loaded = deserialize_source(tmp_path / "pq")
    assert isinstance(loaded, PqSource)
    np.testing.assert_array_equal(np.asarray(loaded.codes), np.asarray(codes))
    np.testing.assert_array_equal(np.asarray(loaded.codebook), np.asarray(book))


def test_quantized_round_trip(tmp_path):
    from parallel_hnsw.io import deserialize_quantized_hnsw, serialize_quantized_hnsw
    from parallel_hnsw.params import PqBuildParams, SearchParams
    from parallel_hnsw.pq import QuantizedHnsw

    bp = BuildParams(
        order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
        optimization=OptimizationParams(recall_proportion=1.0),
    )
    pqp = PqBuildParams(centroids=bp, hnsw=bp, quantized_search=SearchParams())
    src = random_unit_corpus(150, 8, seed=9)
    q = QuantizedHnsw.new(32, src, 4, Metric.EUCLIDEAN, pqp, seed=1, exact_quantize=True)
    serialize_quantized_hnsw(q, tmp_path / "pq_idx")
    loaded = deserialize_quantized_hnsw(tmp_path / "pq_idx")
    assert loaded.vector_count == q.vector_count
    assert loaded.quantizer.nsub == q.quantizer.nsub
    i1, _ = q.search(src.vectors[:10], exact_quantize=True)
    i2, _ = loaded.search(src.vectors[:10], exact_quantize=True)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_generate_resumes_from_partial_checkpoint(tmp_path):
    """A mid-build ladder checkpoint (upper rungs only) is resumed: the
    stored stack becomes the ladder prefix and only larger rungs are built."""
    source = random_unit_corpus(300, 8)
    bp = BuildParams(
        order=6,
        neighborhood_size=4,
        zero_layer_neighborhood_size=8,
        optimization=OptimizationParams(recall_proportion=1.0),
    )
    full = Hnsw.generate(source, None, bp, Metric.NORMALIZED_COSINE, seed=2)
    assert full.layer_count >= 2

    # simulate a crash after the first rungs: checkpoint only the upper stack
    # (with the build-identity meta a real mid-build checkpoint carries)
    partial = Hnsw(full.layers[:-1], source, full.metric, bp)
    ckpt = tmp_path / "ckpt"
    serialize_hnsw(
        partial, ckpt, store_source=False,
        extra_meta={"build_seed": 2, "corpus_count": 300},
    )

    resumed = Hnsw.generate(
        source, None, bp, Metric.NORMALIZED_COSINE, seed=2,
        checkpoint_dir=str(ckpt),
    )
    # the checkpointed prefix is preserved as ladder rungs and the bottom
    # rung covers the whole corpus
    assert resumed.layer_count >= full.layer_count
    assert resumed.layers[-1].node_count == 300
    counts = [l.node_count for l in resumed.layers]
    assert counts[: partial.layer_count] == [l.node_count for l in partial.layers]
    # and the resumed index searches fine
    ids, _ = resumed.search(source.vectors[:16])
    assert (np.asarray(ids[:, 0]) == np.arange(16)).mean() >= 0.9


def test_resume_rejects_mismatched_checkpoint(tmp_path):
    """A checkpoint from a different seed/corpus must NOT be spliced in —
    generate ignores it and rebuilds (guard against silently resuming the
    wrong build)."""
    source = random_unit_corpus(300, 8)
    bp = BuildParams(
        order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
        optimization=OptimizationParams(recall_proportion=1.0),
    )
    full = Hnsw.generate(source, None, bp, Metric.NORMALIZED_COSINE, seed=2)
    ckpt = tmp_path / "ckpt"
    serialize_hnsw(
        Hnsw(full.layers[:-1], source, full.metric, bp), ckpt, store_source=False,
        extra_meta={"build_seed": 99, "corpus_count": 300},  # wrong seed
    )
    rebuilt = Hnsw.generate(
        source, None, bp, Metric.NORMALIZED_COSINE, seed=2,
        checkpoint_dir=str(ckpt),
    )
    # rebuilt from scratch: same result as an uninterrupted same-seed build
    assert rebuilt.layer_count == full.layer_count
    for la, lb in zip(rebuilt.layers, full.layers):
        np.testing.assert_array_equal(np.asarray(la.nodes), np.asarray(lb.nodes))


def test_per_subspace_quantized_round_trip(tmp_path):
    """SubspaceQuantizer indexes persist: codebooks dump raw under
    quantizer/ with a quantizer_kind tag (no centroid graph to store)."""
    from parallel_hnsw.io import (
        deserialize_quantized_hnsw,
        serialize_quantized_hnsw,
    )
    from parallel_hnsw.params import PqBuildParams, SearchParams
    from parallel_hnsw.pq import QuantizedHnsw, SubspaceQuantizer

    bp = BuildParams(
        order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
        optimization=OptimizationParams(recall_proportion=1.0),
    )
    pqp = PqBuildParams(centroids=bp, hnsw=bp, quantized_search=SearchParams())
    src = random_unit_corpus(150, 8, seed=9)
    q = QuantizedHnsw.new(
        32, src, 4, Metric.EUCLIDEAN, pqp, seed=1, per_subspace=True,
        use_kmeans=True,
    )
    serialize_quantized_hnsw(q, tmp_path / "pq_sub_idx")
    loaded = deserialize_quantized_hnsw(tmp_path / "pq_sub_idx")
    assert isinstance(loaded.quantizer, SubspaceQuantizer)
    assert loaded.quantizer.metric == q.quantizer.metric
    np.testing.assert_array_equal(
        np.asarray(loaded.quantizer.codebooks), np.asarray(q.quantizer.codebooks)
    )
    i1, d1 = q.search(src.vectors[:10])
    i2, d2 = loaded.search(src.vectors[:10])
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-6)
