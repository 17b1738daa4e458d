"""Bulk batch-parallel graph construction.

Reference algorithm (reference: src/lib.rs:675-893): layer sizes form a
geometric ladder (``calculate_partitions``, src/lib.rs:1883-1899); each layer
is built in one shot by (1) seeding every node with a search over the stack
above (or brute force for the first layer, src/search.rs:13-71), (2) grouping
nodes by nearest "super", (3) drawing an exponentially-distributed random
candidate pool across the node's seed partitions (``choose_n``,
src/lib.rs:1854-1881), (4) keeping the best M by distance, and (5)
symmetrizing with reverse edges.

Batched re-design: every phase is a batched array program — seeds come from
one vmapped beam search, partitioning is an argsort + searchsorted membership
structure, random pools come from ``jax.random`` with per-node determinism,
row selection is a masked per-row sort, and symmetrization is the lock-free
segmented top-M rebuild in :mod:`parallel_hnsw.ops.segment`.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parallel_hnsw.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw.graph import (
    Layer,
    Source,
    node_to_vec,
    source_get,
    vec_to_node,
)
from parallel_hnsw.ops.distance import Metric, batched_distance, pairwise_distance
from parallel_hnsw.ops.queues import sort_queue, dedup_sorted
from parallel_hnsw.ops.segment import symmetrize
from parallel_hnsw.params import BuildParams, SearchParams
from parallel_hnsw.search import search


# ---------------------------------------------------------------------------
# Layer-size ladder (reference: src/lib.rs:1883-1899). float32 math mirrored.


def calculate_partitions_from_bottom(total_size: int, order: int) -> List[int]:
    layer_count = max(
        1, int(math.ceil(np.log(np.float32(total_size)) / np.log(np.float32(order))))
    )
    partitions = []
    size = total_size
    for _ in range(layer_count):
        partitions.append(size)
        size //= order
    return partitions


def calculate_partitions(total_size: int, order: int) -> List[int]:
    return list(reversed(calculate_partitions_from_bottom(total_size, order)))


# ---------------------------------------------------------------------------
# generate_layer


@functools.partial(jax.jit, static_argnames=("n", "c"))
def _candidate_pool(key, seed_nodes, n: int, c: int):
    """Per-node random candidate picks across seed partitions.

    Mirrors the partition-group + ``choose_n`` structure of the reference
    (src/lib.rs:711-746): partition of a node = its nearest seed; a node's
    pool is drawn from the partition groups of its seeds with an Exp(1)
    partition choice, uniform within the partition.
    """
    s = seed_nodes.shape[1]
    part = seed_nodes[:, 0]  # [N] partition key (EMPTY for seedless nodes)
    order = jnp.argsort(part, stable=True).astype(ID_DTYPE)  # node ids sorted by partition
    sorted_part = jnp.take(part, order)

    starts = jnp.searchsorted(sorted_part, seed_nodes, side="left").astype(ID_DTYPE)
    ends = jnp.searchsorted(sorted_part, seed_nodes, side="right").astype(ID_DTYPE)
    counts = jnp.where(seed_nodes != EMPTY_ID, ends - starts, 0)
    nonempty = counts > 0  # [N, S]
    n_nonempty = jnp.sum(nonempty.astype(jnp.int32), axis=-1)  # [N]

    own_start = jnp.searchsorted(sorted_part, part, side="left").astype(ID_DTYPE)
    own_end = jnp.searchsorted(sorted_part, part, side="right").astype(ID_DTYPE)
    own_count = own_end - own_start

    k1, k2 = jax.random.split(key)
    u_exp = jax.random.uniform(k1, (n, c), minval=1e-7, maxval=1.0)
    u_mem = jax.random.uniform(k2, (n, c))
    # Exp(1) partition index, reset to 0 when out of range (reference:
    # src/lib.rs:1869-1872)
    j = jnp.floor(-jnp.log(u_exp)).astype(jnp.int32)
    j = jnp.where(j >= n_nonempty[:, None], 0, j)

    # map j to the j-th non-empty seed partition
    csum = jnp.cumsum(nonempty.astype(jnp.int32), axis=-1)  # [N, S]
    match = (csum[:, None, :] == (j[:, :, None] + 1)) & nonempty[:, None, :]
    sel_s = jnp.argmax(match, axis=-1)  # [N, C]

    take = lambda arr: jnp.take_along_axis(arr, sel_s, axis=-1)
    start_j = take(starts)
    count_j = take(counts)
    has_any = (n_nonempty > 0)[:, None]
    start_j = jnp.where(has_any, start_j, own_start[:, None])
    count_j = jnp.where(has_any, count_j, own_count[:, None])

    u = jnp.floor(u_mem * count_j.astype(jnp.float32)).astype(jnp.int32)
    u = jnp.clip(u, 0, jnp.maximum(count_j - 1, 0))
    pick_pos = jnp.clip(start_j + u, 0, n - 1)
    cand = jnp.take(order, pick_pos)
    cand = jnp.where(count_j > 0, cand, EMPTY_ID).astype(ID_DTYPE)
    return cand


@functools.partial(jax.jit, static_argnames=("metric", "m", "offset"))
def _build_rows_block(
    vs,  # [N] full sorted vector ids (for id mapping)
    vs_block,  # [B] this block's vector ids
    seed_nodes,  # [B, S] node ids
    seed_dists,  # [B, S]
    cand,  # [B, C] node ids (random pool)
    source,
    metric: Metric,
    m: int,
    offset: int,
):
    """Distance-sort each node's (seeds ∪ pool), dedup, drop self, take M
    (reference: src/lib.rs:748-786).  One node block; blocks bound the
    gathered ``[B, C, D]`` working set for huge layers."""
    b = vs_block.shape[0]
    own_vecs = source_get(source, vs_block)  # [B, D]
    cand_vec_ids = node_to_vec(vs, cand)
    cand_vecs = source_get(source, cand_vec_ids)  # [B, C, D]
    d = batched_distance(own_vecs, cand_vecs, metric)
    # mask empty picks and picks that landed on node-bucket padding rows
    cand = jnp.where(cand_vec_ids == EMPTY_ID, EMPTY_ID, cand)
    d = jnp.where(cand != EMPTY_ID, d, EMPTY_DIST)

    all_ids = jnp.concatenate([seed_nodes, cand], axis=-1)
    all_d = jnp.concatenate([seed_dists, d], axis=-1)
    self_node = offset + jnp.arange(b, dtype=ID_DTYPE)[:, None]
    is_self = all_ids == self_node
    all_ids = jnp.where(is_self, EMPTY_ID, all_ids)
    all_d = jnp.where(is_self, EMPTY_DIST, all_d)

    s_ids, s_d = sort_queue(all_ids, all_d)
    u_ids, u_d = dedup_sorted(s_ids, s_d)
    # padding rows (vs == EMPTY) emit no edges
    row_valid = (vs_block != EMPTY_ID)[:, None]
    u_ids = jnp.where(row_valid, u_ids, EMPTY_ID)
    u_d = jnp.where(row_valid, u_d, EMPTY_DIST)
    return u_ids[:, :m], u_d[:, :m]


def _build_rows(vs, seed_nodes, seed_dists, cand, source, metric, m, node_block):
    n = vs.shape[0]
    if n <= node_block:
        return _build_rows_block(
            vs, vs, seed_nodes, seed_dists, cand, source, metric, m, 0
        )
    outs_i, outs_d = [], []
    for start in range(0, n, node_block):
        stop = min(start + node_block, n)
        ids, d = _build_rows_block(
            vs,
            vs[start:stop],
            seed_nodes[start:stop],
            seed_dists[start:stop],
            cand[start:stop],
            source,
            metric,
            m,
            start,
        )
        outs_i.append(ids)
        outs_d.append(d)
    return jnp.concatenate(outs_i), jnp.concatenate(outs_d)


def _auto_node_block(c: int, eff_width: int, budget_bytes: int = 2 << 30) -> int:
    """Node-block size bounding the gathered [block, c, width] f32 working set
    (width = effective vector width, see source_effective_width)."""
    block = budget_bytes // max(1, c * eff_width * 4)
    return int(max(64, min(16384, block)))


def _seed_top_layer(
    vs: jax.Array, source: Source, metric: Metric, m: int, noc: int
) -> Tuple[jax.Array, jax.Array]:
    """Brute-force seeds when there is no stack above (reference:
    ``compare_all``, src/search.rs:13-30).  Seed width is widened to ~2M so
    small top layers get near-exact rows like the reference's full scan."""
    n = vs.shape[0]
    s = min(n - 1, max(noc, 2 * m + 8))
    vecs = source_get(source, vs)
    d = pairwise_distance(vecs, vecs, metric)
    d = d.at[jnp.arange(n), jnp.arange(n)].set(EMPTY_DIST)
    neg_d, idx = jax.lax.top_k(-d, s)
    return idx.astype(ID_DTYPE), -neg_d


def generate_layer(
    key: jax.Array,
    vs: jax.Array,  # [N] vector ids (will be sorted)
    neighborhood_size: int,
    stack: Sequence[Layer],
    source: Source,
    metric: Metric,
    initial_partition_search: SearchParams,
    node_block: int = 0,
    exact_seed_threshold: int = 131072,
) -> Layer:
    """Build one layer in bulk (reference: Hnsw::generate_layer,
    src/lib.rs:675-823).  ``node_block`` bounds per-launch HBM working sets
    for huge layers; 0 = auto from a byte budget (the dominant buffer is the
    gathered ``[block, 5M, D]`` candidate block)."""
    vs = jnp.sort(jnp.asarray(vs, ID_DTYPE))
    n = int(vs.shape[0])
    m = neighborhood_size
    if node_block <= 0:
        from parallel_hnsw.graph import source_effective_width

        node_block = _auto_node_block(m * 5, source_effective_width(source))

    if n == 1:
        return Layer(nodes=vs, neighbors=jnp.full((1, m), EMPTY_ID, dtype=ID_DTYPE))

    if len(stack) == 0:
        seed_nodes, seed_dists = _seed_top_layer(
            vs, source, metric, m, initial_partition_search.number_of_candidates
        )
    else:
        noc = initial_partition_search.number_of_candidates
        from parallel_hnsw.graph import gather_features

        # blocked feature gathers bound the PQ reconstruction
        queries = gather_features(source, vs)
        bottom = stack[-1]
        if 0 < exact_seed_threshold and bottom.node_count <= exact_seed_threshold:
            # exact seeds: nearest stack-bottom vectors by a blocked scan
            # (the graph search's result set is exactly "nearest among the
            # deepest stack layer", which one matrix product computes)
            from parallel_hnsw.analysis import blocked_topk_pairwise

            corpus_feats = gather_features(source, bottom.nodes)
            top_i, top_d = blocked_topk_pairwise(
                queries, corpus_feats, metric, noc + 1, row_block=node_block
            )
            res_ids = node_to_vec(bottom.nodes, top_i)
            drop = res_ids == vs[:, None]
            res_ids = jnp.where(drop, EMPTY_ID, res_ids)
            top_d = jnp.where(drop, EMPTY_DIST, top_d)
            res_ids, res_dists = sort_queue(res_ids, top_d)
        else:
            res_ids, res_dists = search(
                list(stack),
                source,
                metric,
                queries,
                initial_partition_search,
                exclude=vs,
                query_block=node_block,
            )
        seed_nodes = vec_to_node(vs, res_ids[:, :noc])
        seed_dists = jnp.where(
            seed_nodes == EMPTY_ID, EMPTY_DIST, res_dists[:, :noc]
        )

    c = m * 5
    cand = _candidate_pool(key, seed_nodes, n, c)
    fwd_ids, fwd_d = _build_rows(
        vs, seed_nodes, seed_dists, cand, source, metric, m, node_block
    )
    neighbors, _ = symmetrize(fwd_ids, fwd_d)
    return Layer(nodes=vs, neighbors=neighbors)


# ---------------------------------------------------------------------------
# Full ladder build


def generate(
    source: Source,
    vector_ids: jax.Array,
    bp: BuildParams,
    metric: Metric,
    seed: int = 0,
    improver=None,
    initial_layers: "List[Layer] | None" = None,
) -> List[Layer]:
    """Build the full layer stack top-down (reference: Hnsw::generate,
    src/lib.rs:825-893).

    ``improver(layers) -> layers`` is invoked after every layer (the reference
    calls ``improve_index`` there, src/lib.rs:876); the index-level wrapper
    wires in the optimization loop to avoid a module cycle.

    ``initial_layers``: resume a partially-built ladder (e.g. from a mid-build
    checkpoint): the given stack is kept as-is and construction continues with
    the remaining (strictly larger) ladder rungs.  No reference analogue —
    the reference's generate is a single uninterruptible call.
    """
    rng = np.random.default_rng(seed)
    vs = np.asarray(vector_ids, dtype=np.int64).copy()
    total = len(vs)
    assert total > 0
    rng.shuffle(vs)

    key = jax.random.PRNGKey(seed)
    partitions = calculate_partitions(total, bp.order)
    layers: List[Layer] = []
    i = 0
    if initial_layers:
        layers = list(initial_layers)
        built = [l.node_count for l in layers]
        if built[-1] > total:
            raise ValueError(
                f"checkpoint bottom layer ({built[-1]} nodes) exceeds the "
                f"corpus ({total}) — wrong checkpoint for this build"
            )
        # splice the checkpointed stack in as the ladder prefix (promotions
        # may have inserted rungs the ladder math didn't predict — same
        # refresh rule as below)
        partitions = built + [p for p in partitions if p > built[-1]]
        i = len(built)
    while i != len(partitions):
        layer_count = len(partitions)
        length = partitions[i]
        level = layer_count - i - 1
        slice_length = min(length, total)
        m = bp.zero_layer_neighborhood_size if level == 0 else bp.neighborhood_size
        # per-rung key derived from the rung SIZE, not from split history:
        # rung sizes strictly increase down the ladder (promotion-inserted
        # rungs included), so keys are unique within a build, and a resumed
        # build reproduces the exact keys an uninterrupted build would use
        sub = jax.random.fold_in(key, slice_length)
        from parallel_hnsw.utils.trace import TRACER

        with TRACER.span("generate_layer", level=level, nodes=slice_length):
            layer = generate_layer(
                sub,
                jnp.asarray(vs[:slice_length], ID_DTYPE),
                m,
                layers,
                source,
                metric,
                bp.initial_partition_search,
                exact_seed_threshold=bp.exact_seed_threshold,
            )
        layers.append(layer)
        if improver is not None:
            old_count = len(layers)
            layers = improver(layers)
            delta = len(layers) - old_count
            if delta > 0:
                # promotion grew the stack: refresh the ladder (reference:
                # src/lib.rs:879-887)
                suffix = partitions[i + 1 :]
                partitions = [l.node_count for l in layers] + suffix
                i += delta
        i += 1
    return layers
