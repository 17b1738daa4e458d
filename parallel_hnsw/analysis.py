"""Graph analysis / diagnostics + recall measurement.

Reference diagnostics (reference: src/lib.rs:279-548): lock-free parallel
BFS distance maps from super-nodes (``node_distances``), reachability scans,
argmin partitioning, promotion discovery.  Here the BFS is a masked
frontier iteration with scatter-min edge relaxation inside ``lax.while_loop``;
the atomics disappear.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parallel_hnsw.constants import EMPTY_ID, ID_DTYPE, MATRIX_BYTE_BUDGET
from parallel_hnsw.graph import Layer, Source, source_get, vec_to_node
from parallel_hnsw.ops.distance import Metric, batched_distance, pairwise_distance
from parallel_hnsw.params import SearchParams
from parallel_hnsw.search import search


def brute_force_knn(
    source: Source, queries: jax.Array, metric: Metric, k: int, query_block: int = 4096
):
    """Exact top-k by full pairwise distances. Returns (ids, dists).

    Delegates to :func:`blocked_topk_pairwise` in its refined exact mode,
    which bounds the live distance matrix (corpus AND query blocked) so
    million-row corpora scan within the byte budget."""
    from parallel_hnsw.graph import materialize_source

    vecs = materialize_source(source)
    return blocked_topk_pairwise(
        queries, vecs, metric, k, row_block=query_block, refine=True
    )


# Corpus size from which ``fast_flat_knn(scan_mode="auto")`` uses the fused
# fold instead of the exhaustive scan: the smaller of the two sizes at which
# ``chip_smoke.py`` times both on the card (200k and 1M rows; CHANGES.md has
# the H100 numbers).  Below it the exhaustive scan keeps exact-scan recall.
FOLD_MIN_ROWS = 200_000


def select_scan_mode(n: int) -> str:
    """Scan engine for ``fast_flat_knn(scan_mode="auto")``: the exhaustive
    scan below ``FOLD_MIN_ROWS`` rows (exact-id parity with the exact
    scan), the fused fold from there on."""
    return "folded" if n >= FOLD_MIN_ROWS else "exhaustive"


@functools.partial(jax.jit, static_argnames=("metric", "kk", "mode"))
def _scan_block(q, vecs, offset, metric, kk, mode):
    """One fast-scan block: its top ``kk`` (ids offset to corpus rows)."""
    from parallel_hnsw.ops.pallas_scan import folded_scan

    if mode == "folded":
        bd, bc = folded_scan(q, vecs, metric)
        dd, pos = jax.lax.approx_min_k(bd, min(kk, bd.shape[-1]))
        ids = jnp.take_along_axis(bc, pos, axis=-1) + offset
        # padding classes carry inf: mark their ids EMPTY so the rerank
        # excludes them (their gathers would otherwise clip to real rows)
        ids = jnp.where(jnp.isfinite(dd), ids, EMPTY_ID)
        return ids.astype(ID_DTYPE), dd
    d = pairwise_distance(q, vecs, metric, exact=False)
    dd, idx = jax.lax.approx_min_k(d, kk)
    return (idx + offset).astype(ID_DTYPE), dd


@functools.partial(jax.jit, static_argnames=("k_scan",))
def _merge_topk(ids_a, d_a, ids_b, d_b, k_scan):
    ids = jnp.concatenate([ids_a, ids_b], axis=-1)
    d = jnp.concatenate([d_a, d_b], axis=-1)
    d, ids = jax.lax.sort((d, ids), num_keys=2)
    return ids[:, :k_scan], d[:, :k_scan]


@functools.partial(jax.jit, static_argnames=("metric", "k"))
def _rerank_candidates(q, cand_ids, vecs_cand, metric, k):
    """Exact distances of gathered candidates, EMPTY ids last, cut to k."""
    d = batched_distance(q, vecs_cand, metric)
    d = jnp.where(cand_ids == EMPTY_ID, jnp.inf, d)
    d, ids = jax.lax.sort((d, cand_ids), num_keys=2)
    return ids[:, :k], d[:, :k]


def fast_flat_knn(
    source: Source,
    queries: jax.Array,
    metric: Metric,
    k: int,
    oversample: int = 4,
    query_block: int = 4096,
    corpus_block: int = 1 << 19,
    scan_mode: str = "auto",
):
    """Top-k by fast-precision flat scan + exact rerank. Returns (ids, dists).

    The speed engine for dense corpora: bf16 scans keep ``oversample * k``
    survivors, and a full-precision rerank restores exact ordering.

    ``scan_mode``:

    * ``"exhaustive"``: blocked bf16 distance matrices, each cut to its
      top ``oversample * k`` (recall == exact scan; the regression test
      asserts it);
    * ``"folded"``: the fused fold (:mod:`parallel_hnsw.ops.pallas_scan`),
      which reduces every distance tile to per-class minima before
      anything is written, so the top-k input is a fixed
      ``[Q, n_slots * 128]`` slab and a dense corpus is one scan block;
    * ``"auto"``: :func:`select_scan_mode`.

    The reference has no analogue (its only engine is graph traversal,
    `benches/bench.rs:54-63`).
    """
    from parallel_hnsw.graph import DenseSource

    mode = select_scan_mode(source.count) if scan_mode == "auto" else scan_mode
    if mode not in ("exhaustive", "folded"):
        raise ValueError(f"unknown scan_mode {scan_mode!r}")

    k_scan = max(k, k * oversample)
    n = source.count
    if mode == "folded" and isinstance(source, DenseSource):
        # the fold bounds its own memory: a dense corpus is one scan block
        corpus_block = n
    elif mode == "exhaustive":
        # bound the live [query_block, corpus_block] f32 distance matrix
        corpus_block = max(
            4096, min(corpus_block, MATRIX_BYTE_BUDGET // (query_block * 4))
        )
    all_ids = jnp.arange(n)
    out_i, out_d = [], []
    for qs in range(0, queries.shape[0], query_block):
        q = queries[qs : qs + query_block]
        best_i = best_d = None
        for cs in range(0, n, corpus_block):
            if cs == 0 and corpus_block >= n and hasattr(source, "vectors"):
                vecs = source.vectors  # whole-corpus block: skip the gather
            else:
                vecs = source_get(source, all_ids[cs : cs + corpus_block])
            kk = min(k_scan, vecs.shape[0])
            idx, dd = _scan_block(q, vecs, cs, metric, kk, mode)
            if best_i is None:
                best_i, best_d = idx, dd
            else:
                best_i, best_d = _merge_topk(best_i, best_d, idx, dd, k_scan)
        # bound the [rows, k_scan, D] rerank gather to the byte budget
        # (the exact [Q, ef, D] gather OOMed at 10k x 300 x 1536 pre-budget)
        width = getattr(source, "dim", queries.shape[-1])
        rb = max(64, MATRIX_BYTE_BUDGET // max(1, k_scan * width * 4))
        for rs in range(0, q.shape[0], rb):
            cand = source_get(source, best_i[rs : rs + rb])
            r_ids, r_d = _rerank_candidates(
                q[rs : rs + rb], best_i[rs : rs + rb], cand, metric, k
            )
            out_i.append(r_ids)
            out_d.append(r_d)
    return jnp.concatenate(out_i), jnp.concatenate(out_d)


def first_hit_recall(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    sp: SearchParams,
    query_block: int = 0,
) -> float:
    """Fraction of corpus vectors that retrieve themselves as the top result
    (reference: do_test_recall, src/lib.rs:2166-2192)."""
    queries = source_get(source, jnp.arange(source.count))
    ids, _ = search(layers, source, metric, queries, sp, query_block=query_block)
    hits = np.asarray(ids[:, 0]) == np.arange(source.count)
    return float(hits.mean())


# ---------------------------------------------------------------------------
# BFS distance maps (reference: node_distances, src/lib.rs:425-489)

INF_I32 = jnp.iinfo(jnp.int32).max


def node_distances(layer: Layer, supers: jax.Array) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node (hops, index_sum) distance to the nearest super-node.

    The reference runs a lock-free parallel BFS with atomic CAS on hops and
    fetch-min on index_sum (src/lib.rs:425-489; index_sum = sum of
    (neighbor-slot position + 1) along the path).  Here both relax to a
    fixpoint via scatter-min frontier iterations — deterministic where the
    reference's index_sum depends on scheduling.

    Returns numpy ``(hops [N], index_sum [N])`` with INT32_MAX = unreachable.
    """
    n, m = layer.neighbors.shape
    super_nodes = vec_to_node(layer.nodes, jnp.asarray(supers, ID_DTYPE))
    hops0 = jnp.full((n,), INF_I32, jnp.int32)
    isum0 = jnp.full((n,), INF_I32, jnp.int32)
    safe_supers = jnp.clip(super_nodes, 0, n - 1)
    valid = super_nodes != EMPTY_ID
    hops0 = hops0.at[safe_supers].min(jnp.where(valid, 0, INF_I32))
    isum0 = isum0.at[safe_supers].min(jnp.where(valid, 0, INF_I32))

    src = jnp.broadcast_to(jnp.arange(n, dtype=ID_DTYPE)[:, None], (n, m)).reshape(-1)
    dst = layer.neighbors.reshape(-1)
    pos_cost = jnp.broadcast_to(
        jnp.arange(1, m + 1, dtype=jnp.int32)[None, :], (n, m)
    ).reshape(-1)
    edge_ok = dst != EMPTY_ID
    dst_safe = jnp.where(edge_ok, dst, n)  # out-of-bounds drops

    def body(state):
        hops, isum, _ = state
        cand_h = jnp.where(
            (hops[src] < INF_I32) & edge_ok, hops[src] + 1, INF_I32
        )
        cand_s = jnp.where(
            (isum[src] < INF_I32) & edge_ok, isum[src] + pos_cost, INF_I32
        )
        new_h = hops.at[dst_safe].min(cand_h, mode="drop")
        new_s = isum.at[dst_safe].min(cand_s, mode="drop")
        changed = jnp.any(new_h != hops) | jnp.any(new_s != isum)
        return new_h, new_s, changed

    def cond(state):
        return state[2]

    hops, isum, _ = jax.lax.while_loop(
        cond, body, (hops0, isum0, jnp.asarray(True))
    )
    return np.asarray(hops), np.asarray(isum)


def nodes_unreachable_from_all_supers(layer: Layer, supers: jax.Array) -> np.ndarray:
    """Node ids unreachable from every super."""
    hops, _ = node_distances(layer, supers)
    return np.nonzero(hops == np.iinfo(np.int32).max)[0].astype(np.int32)


def per_super_node_distances(
    layer: Layer, supers: jax.Array, chunk: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(super, node) BFS distances ``(hops [S, N], index_sum [S, N])``.

    The batched generalization of the reference's labeled multi-source BFS
    (multi_node_distances, src/lib.rs:323-383): each super floods the layer
    independently; supers are processed in chunks of ``chunk`` sources, each
    chunk one vectorized scatter-min fixpoint.
    """
    n, m = layer.neighbors.shape
    supers = jnp.asarray(supers, ID_DTYPE)
    s_total = int(supers.shape[0])
    super_nodes = vec_to_node(layer.nodes, supers)

    src = jnp.broadcast_to(jnp.arange(n, dtype=ID_DTYPE)[:, None], (n, m)).reshape(-1)
    dst = layer.neighbors.reshape(-1)
    pos_cost = jnp.broadcast_to(
        jnp.arange(1, m + 1, dtype=jnp.int32)[None, :], (n, m)
    ).reshape(-1)
    edge_ok = dst != EMPTY_ID
    dst_safe = jnp.where(edge_ok, dst, n)

    out_h = np.full((s_total, n), INF_I32, np.int32)
    out_s = np.full((s_total, n), INF_I32, np.int32)

    def run_chunk(chunk_nodes):
        s = chunk_nodes.shape[0]
        hops0 = jnp.full((s, n), INF_I32, jnp.int32)
        isum0 = jnp.full((s, n), INF_I32, jnp.int32)
        rows = jnp.arange(s)
        safe = jnp.clip(chunk_nodes, 0, n - 1)
        ok = chunk_nodes != EMPTY_ID
        hops0 = hops0.at[rows, safe].min(jnp.where(ok, 0, INF_I32))
        isum0 = isum0.at[rows, safe].min(jnp.where(ok, 0, INF_I32))

        def body(state):
            hops, isum, _ = state
            cand_h = jnp.where(
                (hops[:, src] < INF_I32) & edge_ok[None, :], hops[:, src] + 1, INF_I32
            )
            cand_s = jnp.where(
                (isum[:, src] < INF_I32) & edge_ok[None, :],
                isum[:, src] + pos_cost[None, :],
                INF_I32,
            )
            new_h = hops.at[:, dst_safe].min(cand_h, mode="drop")
            new_s = isum.at[:, dst_safe].min(cand_s, mode="drop")
            changed = jnp.any(new_h != hops) | jnp.any(new_s != isum)
            return new_h, new_s, changed

        h, s_, _ = jax.lax.while_loop(
            lambda st: st[2], body, (hops0, isum0, jnp.asarray(True))
        )
        return np.asarray(h), np.asarray(s_)

    for start in range(0, s_total, chunk):
        stop = min(start + chunk, s_total)
        h, s_ = run_chunk(super_nodes[start:stop])
        out_h[start:stop] = h
        out_s[start:stop] = s_
    return out_h, out_s


def multi_node_distances(
    layer: Layer, supers: jax.Array, k: int = 5, chunk: int = 64
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per node, the ``k`` supers with the smallest (hops, index_sum) BFS
    distance (reference: multi_node_distances::<5>, src/lib.rs:323-383 —
    deterministic where the reference records discovery order).

    Returns ``(super_idx [N, k], hops [N, k], index_sum [N, k])`` with -1 /
    INT32_MAX padding for unreached entries.
    """
    hops, isum = per_super_node_distances(layer, supers, chunk)
    order = np.lexsort((isum, hops), axis=0)[:k]  # [k, N]
    top_h = np.take_along_axis(hops, order, axis=0).T
    top_s = np.take_along_axis(isum, order, axis=0).T
    sup_idx = order.T.astype(np.int32)
    sup_idx = np.where(top_h == np.iinfo(np.int32).max, -1, sup_idx)
    return sup_idx, top_h, top_s


def node_distances_from_closest_super(
    layer: Layer, source: Source, metric: Metric, supers: jax.Array, chunk: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """BFS distance of every node from its *geometrically closest* super
    (reference: node_distances_from_closest_super, src/lib.rs:385-412)."""
    part = group_nodes_by_vectors(layer, source, metric, supers)  # [N] super idx
    hops, isum = per_super_node_distances(layer, supers, chunk)
    n = layer.node_count
    return hops[part, np.arange(n)], isum[part, np.arange(n)]


def nodes_not_connected_to_super(
    layer: Layer, source: Source, metric: Metric, supers: jax.Array
) -> np.ndarray:
    """Node ids not reachable from their closest super (reference:
    nodes_not_connected_to_super, src/lib.rs:414-422)."""
    hops, _ = node_distances_from_closest_super(layer, source, metric, supers)
    return np.nonzero(hops == np.iinfo(np.int32).max)[0].astype(np.int32)


def discover_nodes_to_promote(layer: Layer, supers: jax.Array) -> np.ndarray:
    """Unreachable nodes ordered worst-first (reference: src/lib.rs:510-536):
    sort by descending index_sum, then descending hops, then node id; keep the
    BFS-unreachable prefix."""
    hops, isum = node_distances(layer, supers)
    order = np.lexsort((np.arange(len(hops)), -hops.astype(np.int64), -isum.astype(np.int64)))
    unreachable = hops[order] == np.iinfo(np.int32).max
    return order[unreachable].astype(np.int32)


def reachables_from(layer: Layer, node: int, check: Sequence[int]) -> list:
    """DFS reachability restricted to ``check`` (reference: src/lib.rs:491-508).
    Returns [(node, path_cost)] in discovery order."""
    neighbors = np.asarray(layer.neighbors)
    remaining = set(int(c) for c in check)
    result = [(int(node), 0)]
    stack = [(int(node), 0)]
    while stack:
        cur, dist = stack.pop()
        for ix, nb in enumerate(neighbors[cur]):
            nb = int(nb)
            if nb != EMPTY_ID and nb in remaining:
                remaining.discard(nb)
                nd = dist + ix + 1
                stack.append((nb, nd))
                result.append((nb, nd))
    return result


def group_nodes_by_vectors(
    layer: Layer, source: Source, metric: Metric, vectors: jax.Array
) -> np.ndarray:
    """Partition nodes by nearest vector in ``vectors`` (reference:
    group_nodes_by_vectors, src/lib.rs:279-321).  Returns, per node, the index
    into ``vectors`` of its closest super."""
    node_feats = source_get(source, layer.nodes)
    super_feats = source_get(source, jnp.asarray(vectors, ID_DTYPE))
    d = pairwise_distance(node_feats, super_feats, metric)
    return np.asarray(jnp.argmin(d, axis=-1))


def reverse_get_neighbors(layer: Layer, node: int) -> np.ndarray:
    """All nodes whose row contains ``node`` (reference: src/lib.rs:538-548)."""
    neighbors = np.asarray(layer.neighbors)
    return np.nonzero((neighbors == int(node)).any(axis=1))[0].astype(np.int32)


@functools.partial(
    jax.jit, static_argnames=("metric", "k", "row_off_is_none", "fast")
)
def _topk_block(q, c, col_off, row_off, metric, k, row_off_is_none, fast):
    """Top ``k`` of one ``[rows, cols]`` distance block, optionally with the
    diagonal (row_off + i, i) masked."""
    d = pairwise_distance(q, c, metric, exact=not fast)
    if not row_off_is_none:
        rows = jnp.arange(q.shape[0])[:, None] + row_off
        cols = jnp.arange(c.shape[0])[None, :] + col_off
        d = jnp.where(rows == cols, jnp.inf, d)
    kk = min(k, c.shape[0])
    if fast:
        dd, idx = jax.lax.approx_min_k(d, kk)
        return (idx + col_off).astype(ID_DTYPE), dd
    neg_d, idx = jax.lax.top_k(-d, kk)
    return (idx + col_off).astype(ID_DTYPE), -neg_d


@functools.partial(jax.jit, static_argnames=("metric", "k", "row_off_is_none"))
def _rerank_block(q, cand_ids, cand_feats, row_off, metric, k, row_off_is_none):
    d = batched_distance(q, cand_feats, metric)
    if not row_off_is_none:
        # when k_scan >= n the diag-masked entry survives the scan;
        # keep it excluded through the rerank
        rows = jnp.arange(q.shape[0])[:, None] + row_off
        d = jnp.where(cand_ids == rows, jnp.inf, d)
    s_d, s_i = jax.lax.sort((d, cand_ids), num_keys=2)
    return s_i[:, :k], s_d[:, :k]


def blocked_topk_pairwise(
    queries: jax.Array,  # [Q, D]
    corpus_feats: jax.Array,  # [N, D]
    metric: Metric,
    k: int,
    row_block: int = 4096,
    col_block: int = 1 << 16,
    exclude_diag_offset: "int | None" = None,
    fast: bool = False,
    oversample: int = 4,
    refine: bool = False,
):
    """Top-k by blocked pairwise distances with streaming merge.

    Bounds the live distance matrix to ``[row_block, col_block]``.  When
    ``exclude_diag_offset`` is set, entry (i, exclude_diag_offset + i) is
    masked (self-exclusion for within-corpus queries).  Returns (ids, dists)
    ``[Q, k]`` sorted ascending.

    ``fast=True`` is the million-row mode (used by the exact build paths
    above the fp32 threshold): scan blocks at default precision (bf16
    products on the GPU) with an ``approx_min_k`` reduction, keep
    ``oversample * k`` survivors, then restore exact ordering with a
    full-precision rerank of the survivors before cutting to ``k``.

    ``refine=True`` (exact mode) keeps ``2 * k`` survivors of the
    ``HIGHEST``-precision scan and reranks them with the difference form of
    the metric: the scan's ``|x|^2 + |y|^2 - 2 x.y`` expansion loses about
    1e-5 to cancellation at |x|^2 ~ 100, more than the self-match epsilon.
    """
    n = corpus_feats.shape[0]
    k = min(k, n)
    if fast:
        k_scan = min(k * oversample, n)
    else:
        k_scan = min(2 * k, n) if refine else k
    # bound the live [row_block, col_block] f32 matrix (see MATRIX_BYTE_BUDGET)
    col_eff = min(col_block, n)
    row_block = max(256, min(row_block, MATRIX_BYTE_BUDGET // (col_eff * 4)))

    out_i, out_d = [], []
    for rs in range(0, queries.shape[0], row_block):
        q = queries[rs : rs + row_block]
        best_i, best_d = None, None
        for cs in range(0, n, col_block):
            c = corpus_feats[cs : cs + col_block]
            idx, dd = _topk_block(
                q,
                c,
                cs,
                (exclude_diag_offset + rs) if exclude_diag_offset is not None else 0,
                metric,
                k_scan,
                exclude_diag_offset is None,
                fast,
            )
            if best_i is None:
                best_i, best_d = idx, dd
            else:
                cat_i = jnp.concatenate([best_i, idx], axis=-1)
                cat_d = jnp.concatenate([best_d, dd], axis=-1)
                s_d, s_i = jax.lax.sort((cat_d, cat_i), num_keys=2)
                best_i, best_d = s_i[:, :k_scan], s_d[:, :k_scan]
        if fast or refine:
            # bound the [rows, k_scan, D] rerank gather like the scan blocks
            width = corpus_feats.shape[-1]
            rb = max(64, MATRIX_BYTE_BUDGET // max(1, k_scan * width * 4))
            rr_i, rr_d = [], []
            for ss in range(0, q.shape[0], rb):
                ri, rd = _rerank_block(
                    q[ss : ss + rb],
                    best_i[ss : ss + rb],
                    jnp.take(corpus_feats, best_i[ss : ss + rb], axis=0),
                    (exclude_diag_offset + rs + ss)
                    if exclude_diag_offset is not None
                    else 0,
                    metric,
                    k,
                    exclude_diag_offset is None,
                )
                rr_i.append(ri)
                rr_d.append(rd)
            best_i = jnp.concatenate(rr_i)
            best_d = jnp.concatenate(rr_d)
        out_i.append(best_i)
        out_d.append(best_d)
    return jnp.concatenate(out_i), jnp.concatenate(out_d)
