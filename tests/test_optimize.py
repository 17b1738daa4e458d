"""Optimization-loop tests: relinking improves recall toward 1.0."""

import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.analysis import first_hit_recall
from parallel_hnsw.build import generate
from parallel_hnsw.graph import assert_layer_invariants
from parallel_hnsw.optimize import (
    improve_neighbors,
    link_layer_to_better_neighbors,
    stochastic_recall,
)
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams
from parallel_hnsw.utils.data import random_unit_corpus

METRIC = Metric.NORMALIZED_COSINE


def build_small(count=600, dim=16, seed=5):
    source = random_unit_corpus(count, dim)
    bp = BuildParams()
    layers = generate(source, jnp.arange(count), bp, METRIC, seed=seed)
    return source, bp, layers


def test_relink_improves_or_keeps_recall():
    source, bp, layers = build_small()
    op = bp.optimization.replace(recall_proportion=1.0)
    before = stochastic_recall(layers, source, METRIC, op)
    layers2, changed, _ = link_layer_to_better_neighbors(
        layers, len(layers) - 1, source, METRIC, op.search
    )
    after = stochastic_recall(layers2, source, METRIC, op)
    assert after >= before - 0.02, (before, after)
    assert_layer_invariants(layers2)


def test_improve_neighbors_reaches_high_recall():
    # 16-dim random corpus is hard for a raw build; the improvement loop must
    # lift recall (reference gate: src/lib.rs:2228-2229 reaches 1.0)
    source, bp, layers = build_small()
    op = bp.optimization.replace(recall_proportion=1.0)
    layers, recall = improve_neighbors(layers, source, METRIC, op)
    assert recall >= 0.95, recall
    full = first_hit_recall(layers, source, METRIC, op.search)
    assert full >= 0.95, full


def test_interrupt_cancels_improve_index():
    """A monitor raising Interrupt stops improve_index mid-loop (reference
    threads &mut dyn ProgressMonitor through, src/lib.rs:1551-1554)."""
    from parallel_hnsw.progress import Interrupt, ProgressMonitor

    class CountdownMonitor(ProgressMonitor):
        def __init__(self, n):
            self.n = n
            self.calls = 0

        def alive(self):
            self.calls += 1
            if self.calls > self.n:
                raise Interrupt()

    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.params import OptimizationParams

    bp = BuildParams(
        order=6,
        neighborhood_size=4,
        zero_layer_neighborhood_size=8,
        optimization=OptimizationParams(recall_proportion=1.0),
    )
    src = random_unit_corpus(120, 8, seed=3)
    hnsw = Hnsw.generate(src, None, bp, Metric.COSINE, seed=0, improve=False)
    mon = CountdownMonitor(1)
    with pytest.raises(Interrupt):
        hnsw.improve_index(progress=mon)
    assert mon.calls >= 2  # polled more than once before tripping


def test_fast_blocked_topk_matches_exact():
    """The million-row fast tier (bf16 scan + approx_min_k + exact rerank)
    must reproduce the exact blocked top-k, including diagonal exclusion
    across block boundaries and when k_scan exceeds a block."""
    from parallel_hnsw.analysis import blocked_topk_pairwise

    source = random_unit_corpus(700, 24, seed=9)
    feats = source.vectors
    for k, rb, cb in ((10, 128, 256), (6, 256, 64)):
        gt_i, gt_d = blocked_topk_pairwise(
            feats, feats, METRIC, k, row_block=rb, col_block=cb,
            exclude_diag_offset=0,
        )
        f_i, f_d = blocked_topk_pairwise(
            feats, feats, METRIC, k, row_block=rb, col_block=cb,
            exclude_diag_offset=0, fast=True, oversample=4,
        )
        np.testing.assert_array_equal(np.asarray(f_i), np.asarray(gt_i))
        np.testing.assert_allclose(np.asarray(f_d), np.asarray(gt_d), atol=1e-5)
        # self-exclusion holds through the rerank
        assert not (np.asarray(f_i) == np.arange(700)[:, None]).any()


def test_fast_relink_tier_matches_exact_relink():
    """Above the exact threshold but under the fast threshold, relink must
    use the fast scan tier and produce the same edges as the exact tier."""
    source, bp, layers = build_small(count=500)
    exact_layers, _, tier = link_layer_to_better_neighbors(
        layers, len(layers) - 1, source, METRIC, bp.optimization.search,
        exact_threshold=1 << 20,
    )
    assert tier == "exact"
    fast_layers, _, tier = link_layer_to_better_neighbors(
        layers, len(layers) - 1, source, METRIC, bp.optimization.search,
        exact_threshold=1, fast_threshold=1 << 20,
    )
    assert tier == "fast"
    np.testing.assert_array_equal(
        np.asarray(fast_layers[-1].neighbors), np.asarray(exact_layers[-1].neighbors)
    )
    assert_layer_invariants(fast_layers)
