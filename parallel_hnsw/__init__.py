"""parallel_hnsw — a batch-parallel HNSW framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
terminusdb-labs/parallel-hnsw: bulk batched graph construction over a geometric
layer ladder, batched beam-search queries, a recall-driven improve/promote
self-repair loop, product quantization with ADC tables and exact rerank,
all-pairs kNN / threshold similarity, directory persistence, and multi-chip
sharded search over a device mesh.

Quick start::

    import jax.numpy as jnp
    from parallel_hnsw import Hnsw, Metric, BuildParams
    from parallel_hnsw.graph import DenseSource

    source = DenseSource(vectors=my_unit_vectors)        # [N, D] f32
    hnsw = Hnsw.generate(source, metric=Metric.COSINE)   # bulk build + improve
    ids, dists = hnsw.search(queries)                    # batched beam search
"""

from parallel_hnsw.constants import EMPTY_DIST, EMPTY_ID, MATCH_EPSILON
from parallel_hnsw.graph import (
    DenseSource,
    Layer,
    MemmapSource,
    PqSource,
    open_memmap_source,
)
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import (
    BuildParams,
    OptimizationParams,
    PqBuildParams,
    SearchParams,
)
from parallel_hnsw.pq import HnswQuantizer, QuantizedHnsw, SubspaceQuantizer
from parallel_hnsw.progress import CallbackProgressMonitor, Interrupt, ProgressMonitor

__version__ = "0.2.0"

__all__ = [
    "EMPTY_DIST",
    "EMPTY_ID",
    "MATCH_EPSILON",
    "BuildParams",
    "OptimizationParams",
    "PqBuildParams",
    "SearchParams",
    "Metric",
    "Hnsw",
    "Layer",
    "DenseSource",
    "PqSource",
    "ProgressMonitor",
    "CallbackProgressMonitor",
    "Interrupt",
    "QuantizedHnsw",
    "HnswQuantizer",
    "SubspaceQuantizer",
]
