"""Routing vectors: compact hop-scoring representation for graph traversal.

The reference declares a ``PartialDistance`` trait for cheap partial scoring
during traversal but never implements it (reference: src/pq.rs:24-27).
A literal ADC realization (per-candidate LUT lookups) would make the hop
issue one gather per (candidate, subspace) LUT element, while a full-K LUT
per query block is storage-infeasible at the reference's 65,535-centroid
codebooks ([Q, nsub, 65536] floats).

This module keeps the hop at ONE gather per candidate and shrinks the bytes
under that gather instead: project the corpus once to a narrow routing matrix ``[N, dr]`` in bfloat16 (a random orthonormal
Johnson-Lindenstrauss projection preserves distance *order* well enough to
steer traversal), score every hop against routing rows (8-48x less gather
bandwidth than full-width f32 rows, and an equally narrower hop matmul), and
restore exact ranking with one full-precision rerank of the final candidate
queue — the same oversample-then-rerank contract as the fast flat scans.

``dr=None`` skips the projection and just casts to bf16 — halved traffic with
near-exact routing, for corpora whose dimension is already small.

Guidance (from an earlier accelerator; not measured on the GPU): at narrow
dimensions shrinking rows buys little and the projection only costs recall —
use ``dr=None`` (recall-neutral) or no routing below ~512-d.  Projection can
pay off only where the gather is
bandwidth-bound (wide rows) AND the corpus is spectrally concentrated (low
effective rank), e.g. transformer embeddings at 1536-d; on full-rank noise
no reduced representation can rank-order neighbors (the same limit PQ hits
on uniform random corpora).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from parallel_hnsw.constants import EMPTY_ID
from parallel_hnsw.graph import Source, gather_features, source_effective_width
from parallel_hnsw.ops.distance import Metric, batched_distance
from parallel_hnsw.ops.queues import sort_queue


class RoutingCache(NamedTuple):
    """Derived (recomputable) traversal acceleration state."""

    projection: Optional[jax.Array]  # [D, dr] f32 orthonormal, or None
    rows: jax.Array  # [N, dr] bf16 routing rows
    metric: Metric  # metric evaluated in routed space


def route_metric(metric: Metric) -> Metric:
    """Metric evaluated during routed traversal.

    EUCLIDEAN drops the final sqrt: squared distances are order-equivalent
    and cheaper.  Every other metric keeps its form (cosine-family rows are
    re-normalized after projection so dots stay cosines).
    """
    metric = Metric(metric)
    if metric is Metric.EUCLIDEAN:
        return Metric.SQUARED_EUCLIDEAN
    return metric


def random_orthonormal(dim: int, dr: int, seed: int = 0) -> jax.Array:
    """Random orthonormal ``[dim, dr]`` projection (QR of a gaussian)."""
    assert dr <= dim, f"routing dim {dr} exceeds source dim {dim}"
    g = jax.random.normal(jax.random.PRNGKey(seed), (dim, dr), jnp.float32)
    q, _ = jnp.linalg.qr(g)
    return q


def _transform(
    feats: jax.Array, projection: Optional[jax.Array], metric: Metric
) -> jax.Array:
    if projection is not None:
        feats = jnp.asarray(feats, jnp.float32) @ projection
    if Metric(metric) in (Metric.COSINE, Metric.NORMALIZED_COSINE):
        norm = jnp.linalg.norm(feats, axis=-1, keepdims=True)
        feats = feats / jnp.maximum(norm, 1e-12)
    return feats


def build_routing(
    source: Source,
    metric: Metric,
    dr: Optional[int] = 64,
    seed: int = 0,
    block: int = 131072,
) -> RoutingCache:
    """Project (or just bf16-cast) a source into a routing cache, streamed in
    row blocks so PQ sources decode transiently."""
    metric = Metric(metric)
    dim = source.dim
    projection = None
    if dr is not None and dr < dim:
        projection = random_orthonormal(dim, dr, seed)
    ids = jnp.arange(source.count, dtype=jnp.int32)
    outs = []
    for start in range(0, source.count, block):
        feats = gather_features(source, ids[start : start + block], block=16384)
        outs.append(_transform(feats, projection, metric).astype(jnp.bfloat16))
    return RoutingCache(
        projection=projection,
        rows=jnp.concatenate(outs) if len(outs) > 1 else outs[0],
        metric=route_metric(metric),
    )


def route_queries(cache: RoutingCache, queries: jax.Array, metric: Metric) -> jax.Array:
    """Apply the cache's transform to queries (kept f32 for stable ordering)."""
    return _transform(queries, cache.projection, metric)


def exact_rerank(
    source: Source,
    metric: Metric,
    queries: jax.Array,  # [Q, D] original (unprojected) queries
    ids: jax.Array,  # [Q, ef] vector ids, EMPTY-padded
    block_budget: int = 1 << 30,
) -> Tuple[jax.Array, jax.Array]:
    """Full-precision rescore + (dist, id) resort of candidate queues.

    Shared by routed graph search and the PQ pipeline (reference rerank
    contract: src/pq.rs:354-363).  Blocked over queries so the gathered
    ``[qb, ef, width]`` block honors the memory budget.
    """
    from parallel_hnsw.graph import is_host_source, source_get

    ef = ids.shape[1]
    width = source_effective_width(source)
    qb = max(16, block_budget // max(1, ef * width * 4))
    host = is_host_source(source)
    out_i, out_d = [], []
    for qs in range(0, queries.shape[0], qb):
        q = queries[qs : qs + qb]
        block_ids = ids[qs : qs + qb]
        if host:
            # out-of-core: gather candidate rows on host (memmap fancy index)
            # and ship only the [qb, ef, D] block — the full corpus never
            # touches the device (reference seam: src/pq.rs:133-142)
            cand = source_get(source, block_ids)
            r_ids, r_d = _rerank_gathered_jit(Metric(metric), q, block_ids, cand)
        else:
            r_ids, r_d = _rerank_block_jit(source, Metric(metric), q, block_ids)
        out_i.append(r_ids)
        out_d.append(r_d)
    if len(out_i) == 1:
        return out_i[0], out_d[0]
    return jnp.concatenate(out_i), jnp.concatenate(out_d)


@functools.partial(jax.jit, static_argnames=("metric",))
def _rerank_gathered_jit(metric: Metric, queries, ids, cand):
    d = batched_distance(queries, cand, metric)
    d = jnp.where(ids == EMPTY_ID, jnp.inf, d)
    return sort_queue(ids, d)


@functools.partial(jax.jit, static_argnames=("metric",))
def _rerank_block_jit(source, metric: Metric, queries, ids):
    from parallel_hnsw.graph import source_get

    safe = jnp.clip(ids, 0, source.count - 1)
    cand = source_get(source, safe)
    d = batched_distance(queries, cand, metric)
    d = jnp.where(ids == EMPTY_ID, jnp.inf, d)
    return sort_queue(ids, d)


# ---------------------------------------------------------------------------
# Neighbor-major hop slabs


class HopSlabs(NamedTuple):
    """Per-layer neighbor-major feature slabs for gather-light traversal.

    ``slabs[i][n, j]`` holds the (routing-space) features of
    ``layers[i].neighbors[n, j]`` — one slab row per node packs all M
    neighbor feature rows, so the hop issues ONE row gather per expanded
    node instead of M per-candidate gathers: it trades M-fold feature
    duplication in device memory for an ~M-fold cut in gather count.  Derived (recomputable) state: any layer
    mutation invalidates it.

    ``routed`` records whether rows live in a routing cache's space (score
    with routed queries + exact final rerank) or in the source's native
    space (results bit-identical to the plain hop when f32).
    """

    slabs: Tuple[jax.Array, ...]  # per layer [N_padded, M, width]
    routed: bool


def build_hop_slabs(
    layers,
    source: Source,
    metric: Metric,
    routing: Optional[RoutingCache] = None,
    byte_budget: int = 4 << 30,
    block: int = 1 << 20,
) -> HopSlabs:
    """Materialize neighbor-feature slabs for every layer (padded to the
    same node buckets ``search`` uses, so jitted programs match).

    With ``routing`` given, slab rows are the cache's bf16 (optionally
    projected) rows — the memory knob for large corpora: slab bytes are
    ``sum(N_i * M_i) * width * itemsize``.  Raises if the total exceeds
    ``byte_budget``.
    """
    from parallel_hnsw.graph import node_to_vec, pad_layer

    rows = routing.rows if routing is not None else None
    width = int(rows.shape[1]) if rows is not None else source_effective_width(source)
    itemsize = 2 if rows is not None else 4
    padded = [pad_layer(l) for l in layers]
    total = sum(p.neighbors.size * width * itemsize for p in padded)
    if total > byte_budget:
        raise ValueError(
            f"hop slabs need {total / 1e9:.2f} GB (> budget "
            f"{byte_budget / 1e9:.2f} GB); enable_routing with a smaller dr "
            "or raise byte_budget"
        )
    slabs = []
    for pl in padded:
        n, m = pl.neighbors.shape
        flat = pl.neighbors.reshape(-1)
        vids = node_to_vec(pl.nodes, flat)
        safe = jnp.clip(vids, 0, (rows.shape[0] if rows is not None else source.count) - 1)
        outs = []
        for start in range(0, safe.shape[0], block):
            chunk = safe[start : start + block]
            if rows is not None:
                outs.append(jnp.take(rows, chunk, axis=0))
            else:
                outs.append(gather_features(source, chunk, block=16384))
        feats = jnp.concatenate(outs) if len(outs) > 1 else outs[0]
        slabs.append(feats.reshape(n, m, feats.shape[-1]))
    return HopSlabs(slabs=tuple(slabs), routed=routing is not None)
