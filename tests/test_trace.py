"""Tracing subsystem: per-phase timers wired through build/improve (SURVEY §5
upgrade over the reference's eprintln narration, src/lib.rs:687-874)."""

import jax.numpy as jnp
import numpy as np

from parallel_hnsw.graph import DenseSource
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import BuildParams, OptimizationParams
from parallel_hnsw.utils.trace import TRACER, Tracer


def test_tracer_nesting_and_summary():
    t = Tracer(enabled=True)
    with t.span("outer", n=2):
        with t.span("inner"):
            pass
        with t.span("inner"):
            pass
    assert [e.name for e in t.events] == ["inner", "inner", "outer"]
    assert t.events[0].depth == 1 and t.events[2].depth == 0
    summary = t.summary()
    assert summary["inner"]["calls"] == 2
    assert t.events[2].counters == {"n": 2}
    assert "outer" in t.format_summary()


def test_tracer_disabled_records_nothing():
    t = Tracer(enabled=False)
    with t.span("x"):
        pass
    t.count("y")
    assert t.events == []


def test_build_emits_phase_events():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    src = DenseSource(vectors=jnp.asarray(vecs))
    bp = BuildParams(optimization=OptimizationParams(recall_proportion=0.5))

    TRACER.enabled = True
    TRACER.events.clear()
    try:
        index = Hnsw.generate(src, None, bp, Metric.COSINE, seed=0)
        index.improve_neighbors()  # force at least one relink sweep
        names = {e.name for e in TRACER.events}
    finally:
        TRACER.enabled = False
        TRACER.events.clear()
    assert "generate_layer" in names
    assert "improve_index" in names
    assert "relink_layer" in names
    assert "stochastic_recall" in names
