"""Recall parity against an executable model of the reference's search.

BASELINE.md's gate: "Recall@k parity with the Rust reference at equal memory
on identical graphs (same M/ef)".  The Rust toolchain is absent, so
``tests/ref_model.py`` reimplements the reference's serial query path
faithfully (priority_queue.rs / lib.rs closest_nodes / search.rs
search_layers); this suite (1) validates the model against the reference's
own golden search expectations, then (2) sweeps ef on graphs built by THIS
framework and asserts the batched engine's recall@k is >= the reference
semantics' recall@k on the identical graph.
"""

import math

import jax.numpy as jnp
import numpy as np

from parallel_hnsw.analysis import brute_force_knn
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw.utils.data import random_unit_corpus

from tests.ref_model import search_layers as ref_search_layers
from tests.test_tiny_graph import R, SILLY_DATA, golden_layers


def _np_layers(layers):
    return [(np.asarray(l.nodes), np.asarray(l.neighbors)) for l in layers]


def _cosine_dist_to(data):
    def make(q):
        def dist_to(vec_id: int) -> float:
            return float(1.0 - np.dot(q, data[vec_id]))

        return dist_to

    return make


def test_model_reproduces_reference_golden_search():
    """The NumPy model must reproduce test_nearness_search
    (reference: src/lib.rs:2046-2068) on the golden graph."""
    data = SILLY_DATA.astype(np.float64)
    make = _cosine_dist_to(data)
    got = ref_search_layers(
        _np_layers(golden_layers()),
        make(np.array([0.0, R, R])),
        number_of_candidates=300,
        upper_layer_candidate_count=100,
        probe_depth=2,
    )
    want_ids = [8, 4, 1, 2, 3, 0, 5, 6, 7]
    assert [i for i, _ in got] == want_ids
    want_d = [0.0, 0.1835745, 0.29289323, 0.29289323, 0.5, 1.0, 1.0, 1.7071068, 1.7071068]
    np.testing.assert_allclose([d for _, d in got], want_d, atol=1e-6)


def test_recall_parity_on_identical_graph():
    """ef sweep on one graph: batched engine recall@10 >= reference-semantics
    recall@10 at every operating point (same M, same ef, same probe_depth)."""
    count, dim, k = 600, 16, 10
    source = random_unit_corpus(count, dim, seed=13)
    bp = BuildParams(optimization=OptimizationParams(recall_proportion=0.2))
    index = Hnsw.generate(source, None, bp, Metric.COSINE, seed=1)

    data = np.asarray(source.vectors).astype(np.float64)
    np_layers = _np_layers(index.layers)
    make = _cosine_dist_to(data)

    n_q = 64
    queries = source.vectors[:n_q]
    gt = np.asarray(brute_force_knn(source, queries, Metric.COSINE, k)[0])

    for ef in (12, 24, 48):
        sp = SearchParams(
            number_of_candidates=ef,
            upper_layer_candidate_count=min(ef, 24),
            probe_depth=2,
        )
        ids, _ = index.search(queries, sp)
        ours = np.asarray(ids[:, :k])

        ref_hits = our_hits = 0
        for qi in range(n_q):
            ref = ref_search_layers(
                np_layers,
                make(data[qi]),
                number_of_candidates=ef,
                upper_layer_candidate_count=min(ef, 24),
                probe_depth=2,
            )
            ref_ids = [i for i, _ in ref][:k]
            ref_hits += len(np.intersect1d(ref_ids, gt[qi]))
            our_hits += len(np.intersect1d(ours[qi], gt[qi]))
        ref_recall = ref_hits / (n_q * k)
        our_recall = our_hits / (n_q * k)
        # parity or better, with a 2% tolerance for traversal-order ties
        assert our_recall >= ref_recall - 0.02, (ef, our_recall, ref_recall)


import os

import pytest


@pytest.mark.skipif(
    not os.environ.get("PHNSW_SLOW"),
    reason="slow (~10+ min on the CPU mesh): set PHNSW_SLOW=1",
)
def test_recall_parity_at_scale():
    """Close the visited-list question at >=100k —
    the engine's queue-bounded lockstep exploration must match or beat the
    reference's unbounded visit-list semantics on an identical large graph."""
    count, dim, k, n_q = 100_000, 32, 10, 96
    source = random_unit_corpus(count, dim, seed=17)
    bp = BuildParams(optimization=OptimizationParams(recall_proportion=0.01))
    index = Hnsw.generate(source, None, bp, Metric.COSINE, seed=1, improve=False)

    data = np.asarray(source.vectors).astype(np.float64)
    np_layers = _np_layers(index.layers)
    make = _cosine_dist_to(data)

    rng = np.random.default_rng(5)
    q_idx = rng.permutation(count)[:n_q]
    queries = source.vectors[jnp.asarray(q_idx)]
    gt = np.asarray(brute_force_knn(source, queries, Metric.COSINE, k)[0])

    for ef in (24, 100):
        sp = SearchParams(
            number_of_candidates=ef,
            upper_layer_candidate_count=min(ef, 100),
            probe_depth=2,
        )
        ids, _ = index.search(queries, sp, query_block=96)
        ours = np.asarray(ids[:, :k])
        ref_hits = our_hits = 0
        for qi in range(n_q):
            ref = ref_search_layers(
                np_layers,
                make(data[q_idx[qi]]),
                number_of_candidates=ef,
                upper_layer_candidate_count=min(ef, 100),
                probe_depth=2,
            )
            ref_ids = [i for i, _ in ref][:k]
            ref_hits += len(np.intersect1d(ref_ids, gt[qi]))
            our_hits += len(np.intersect1d(ours[qi], gt[qi]))
        ref_recall = ref_hits / (n_q * k)
        our_recall = our_hits / (n_q * k)
        assert our_recall >= ref_recall - 0.02, (ef, our_recall, ref_recall)
