"""Structural self-repair: unreachable discovery, promotion, layer extension.

Reference (reference: src/lib.rs:1002-1427): nodes that cannot find
themselves by search ("unreachable", src/lib.rs:1002-1037) are promoted into
higher layers — either by extending existing layers with an index remap
(``extend_layer``, src/lib.rs:1039-1068) or by regenerating a new top stack
(``promote_at_layer``, src/lib.rs:1273-1427).  Candidate selection histograms
unreachables' neighbors and greedily picks high-count nodes not covered by an
already-picked node's hypersphere (src/lib.rs:1176-1271).

Split: the heavy phases (self-search of every node, radius
searches, pairwise cover distances, row remaps) are batched device programs;
the small combinatorial ladder/splice logic stays host-side, exactly
mirroring the reference's control flow.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parallel_hnsw.build import calculate_partitions_from_bottom
from parallel_hnsw.constants import EMPTY_ID, ID_DTYPE, MATCH_EPSILON
from parallel_hnsw.graph import Layer, Source, source_get
from parallel_hnsw.ops.distance import Metric, pairwise_distance
from parallel_hnsw.params import BuildParams, SearchParams
from parallel_hnsw.search import search


def match_within_epsilon(ids: np.ndarray, dists: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Batched reference semantics (src/search.rs:173-187): target found among
    results whose distance is < epsilon (results are sorted ascending)."""
    return np.any((ids == targets[:, None]) & (np.abs(dists) < MATCH_EPSILON), axis=-1)


def discover_unreachable_vectors(
    layers: Sequence[Layer],
    layer_id_from_top: int,
    source: Source,
    metric: Metric,
    sp: SearchParams,
    query_block: int = 0,
) -> np.ndarray:
    """Vector ids in layer ``layer_id_from_top`` that cannot find themselves
    searching the sub-stack, and are not in the layer above
    (reference: src/lib.rs:1002-1037)."""
    stack = list(layers[: layer_id_from_top + 1])
    layer = stack[-1]
    nodes = np.asarray(layer.nodes)
    queries = source_get(source, layer.nodes)
    ids, dists = search(stack, source, metric, queries, sp, query_block=query_block)
    found = match_within_epsilon(np.asarray(ids), np.asarray(dists), nodes)
    if layer_id_from_top > 0:
        above = np.asarray(layers[layer_id_from_top - 1].nodes)
        in_above = np.isin(nodes, above)
    else:
        in_above = np.zeros_like(found)
    return nodes[~found & ~in_above]


def _discover_order_from_top(layers: Sequence[Layer], v: int) -> int:
    return int(_discover_orders_from_top(layers, np.asarray([v]))[0])


def _discover_orders_from_top(layers: Sequence[Layer], vecs: np.ndarray) -> np.ndarray:
    """Vectorized order lookup: for each vector id, the index of the topmost
    layer containing it — one searchsorted per layer instead of a per-vector
    stack walk (reference walks per vector, src/lib.rs:1167-1174)."""
    orders = np.full(len(vecs), -1, dtype=np.int64)
    for i, l in enumerate(layers):
        nodes = np.asarray(l.nodes)
        pos = np.searchsorted(nodes, vecs)
        found = (pos < len(nodes)) & (nodes[np.clip(pos, 0, len(nodes) - 1)] == vecs)
        orders = np.where((orders < 0) & found, i, orders)
    if np.any(orders < 0):
        missing = vecs[orders < 0]
        raise ValueError(f"vector {missing[0]} does not exist in hnsw")
    return orders


def filter_promotion_candidates(
    layers: Sequence[Layer],
    layer_from_top: int,
    vecs: np.ndarray,
    source: Source,
    metric: Metric,
    sp: SearchParams,
) -> List[Tuple[int, np.ndarray]]:
    """Histogram + greedy hypersphere cover (reference: src/lib.rs:1176-1271).

    Batched: order lookup is one searchsorted per layer, the neighbor
    histogram is a vectorized ``np.unique`` count; only the small greedy
    cover remains a host loop."""
    if layer_from_top == 0:
        return []
    vecs = np.sort(np.asarray(vecs))
    orders = _discover_orders_from_top(layers, vecs)

    result: List[Tuple[int, np.ndarray]] = []
    for order in np.unique(orders):
        order = int(order)
        if order == 0:
            continue
        sel = vecs[orders == order]
        layer = layers[order]
        nodes = np.asarray(layer.nodes)
        node_idx = np.searchsorted(nodes, sel)
        rows = np.asarray(layer.neighbors)[node_idx]  # [k, M]
        flat = rows[rows != EMPTY_ID]
        # count only neighbors that are themselves unreachable (vecs is sorted)
        nbr_vecs = nodes[flat]
        counted = flat[np.isin(nbr_vecs, vecs)]
        uniq, counts = np.unique(counted, return_counts=True)
        # pop-highest-count-first, node id breaking ties (deterministic)
        order_ix = np.lexsort((uniq, -counts))
        cand_nodes = uniq[order_ix]
        cand_vecs = nodes[cand_nodes].astype(np.int64)
        if len(cand_vecs) == 0:
            result.append((order, cand_vecs))
            continue

        # batched radius search: nearest distance in the stack above
        # (reference: search_upto + result[0].1, src/lib.rs:1255-1260)
        queries = source_get(source, jnp.asarray(cand_vecs, ID_DTYPE))
        r_ids, r_dists = search(list(layers[:layer_from_top]), source, metric, queries, sp)
        radii = np.asarray(r_dists[:, 0])

        # greedy hypersphere cover, blocked: the full [k, k] candidate
        # distance matrix OOMs at tens of thousands of candidates (config-5
        # scale), so compute one [picked_so_far, B] cross block + one [B, B]
        # in-block matrix per column block instead
        cand_feats = source_get(source, jnp.asarray(cand_vecs, ID_DTYPE))
        picked: List[int] = []
        block = 4096
        k_cand = len(cand_vecs)
        for bs in range(0, k_cand, block):
            be = min(bs + block, k_cand)
            feats_b = cand_feats[bs:be]
            in_block = np.asarray(pairwise_distance(feats_b, feats_b, metric))
            prior = np.asarray(picked, dtype=np.int64)  # all < bs by construction
            if prior.size:
                cross = np.asarray(
                    pairwise_distance(
                        cand_feats[jnp.asarray(prior, ID_DTYPE)], feats_b, metric
                    )
                )
                prior_radii = radii[prior]
            block_picks: List[int] = []
            for bi in range(be - bs):
                if prior.size and bool(np.any(cross[:, bi] < prior_radii)):
                    continue
                if block_picks and bool(
                    np.any(
                        in_block[np.asarray(block_picks), bi]
                        < radii[bs + np.asarray(block_picks)]
                    )
                ):
                    continue
                block_picks.append(bi)
            picked.extend(bs + b for b in block_picks)
        result.append((order, cand_vecs[picked]))
    return result


def extend_layer(layers: List[Layer], layer_id: int, vecs: np.ndarray) -> List[Layer]:
    """Insert vectors into an existing layer by sorted-merge index remap
    (reference: extend_layer + generate_node_maps, src/lib.rs:1039-1068,
    1727-1812).  ``layer_id`` counts from the *bottom* like the reference."""
    layer_id_from_top = len(layers) - layer_id - 1
    layer = layers[layer_id_from_top]
    old_nodes = np.asarray(layer.nodes)
    vecs = np.sort(np.asarray(vecs))
    if len(vecs) == 0:
        return layers
    if np.intersect1d(old_nodes, vecs).size:
        raise ValueError("tried to insert vector that already exists in this layer")

    new_nodes = np.sort(np.concatenate([old_nodes, vecs]))
    old_pos = np.searchsorted(new_nodes, old_nodes)  # old node id -> new node id

    old_neighbors = np.asarray(layer.neighbors)
    n_new, m = len(new_nodes), old_neighbors.shape[1]
    remapped = np.where(
        old_neighbors != EMPTY_ID,
        np.take(old_pos, np.clip(old_neighbors, 0, len(old_nodes) - 1)),
        EMPTY_ID,
    ).astype(np.int32)
    new_neighbors = np.full((n_new, m), EMPTY_ID, dtype=np.int32)
    new_neighbors[old_pos] = remapped

    out = list(layers)
    out[layer_id_from_top] = Layer(
        nodes=jnp.asarray(new_nodes, ID_DTYPE), neighbors=jnp.asarray(new_neighbors)
    )
    return out


# generate_fn(vector_ids, bp) -> List[Layer]; provided by the index layer to
# regenerate top stacks (the reference recursively calls Hnsw::generate,
# src/lib.rs:1319,1382).
GenerateFn = Callable[[np.ndarray, BuildParams], List[Layer]]


def promote_at_layer(
    layers: List[Layer],
    layer_from_top: int,
    bp: BuildParams,
    source: Source,
    metric: Metric,
    generate_fn: GenerateFn,
    log: Optional[Callable[[str], None]] = None,
    monitor=None,
) -> Tuple[List[Layer], bool]:
    """Reference: promote_at_layer (src/lib.rs:1273-1427); the monitor is
    polled between phases (reference threads it, src/lib.rs:1276)."""
    from parallel_hnsw.progress import ensure_monitor
    from parallel_hnsw.utils.trace import TRACER

    monitor = ensure_monitor(monitor)
    say = log or (lambda s: None)
    monitor.alive()
    with TRACER.span("discover_unreachable", layer_from_top=float(layer_from_top)):
        vecs = discover_unreachable_vectors(
            layers, layer_from_top, source, metric, bp.optimization.search
        )
    if len(vecs) == 0:
        return layers, False
    max_proportion = bp.optimization.promotion_proportion
    if max_proportion < 1.0:
        vecs = vecs[: int(len(vecs) * max_proportion)]
        if len(vecs) == 0:
            return layers, False
    say(f"promoting {len(vecs)} unreachable vectors at layer_from_top={layer_from_top}")

    monitor.alive()
    order_vecs = filter_promotion_candidates(
        layers, layer_from_top, vecs, source, metric, bp.optimization.search
    )
    for order, ovecs in order_vecs:
        if len(ovecs) == 0:
            continue
        monitor.alive()
        say(f"promotion of {len(ovecs)} vecs into order {order}")
        # sizes of the stack strictly above the order layer, bottom-first
        sizes = [l.node_count for l in layers[:order]]
        sizes.reverse()
        new_sizes = calculate_partitions_from_bottom(sizes[0] + len(ovecs), bp.order)
        if len(new_sizes) < len(sizes):
            new_sizes.extend([0] * (len(sizes) - len(new_sizes)))
        retop_upto = len(new_sizes) - len(sizes)
        new_sizes = new_sizes[: len(sizes)]
        promotion_sizes = [max(0, s1 - s2) for s1, s2 in zip(new_sizes, sizes)]

        if retop_upto != 0:
            # the ladder grew: regenerate a whole new top stack including some
            # promotions (reference: src/lib.rs:1360-1399)
            retop_index = len(promotion_sizes) - retop_upto
            promotion_into_top = promotion_sizes[retop_index]
            promotion_sizes = promotion_sizes[:retop_index]
            top_vecs = np.asarray(layers[retop_upto - 1].nodes)
            top_vecs = np.unique(
                np.concatenate([top_vecs, ovecs[:promotion_into_top]])
            )
            new_bp = bp.replace(zero_layer_neighborhood_size=bp.neighborhood_size)
            new_top = generate_fn(top_vecs, new_bp)
            say(f"generated {len(new_top)} new top layers (and extending)")
            layers = list(new_top) + list(layers[retop_upto:])
            offset = len(new_top)
        else:
            offset = 0

        promotion_sizes.reverse()
        for i, size in enumerate(promotion_sizes):
            current_lft = offset + i
            layer = layers[current_lft]
            layer_nodes = np.asarray(layer.nodes)
            candidates = ovecs[~np.isin(ovecs, layer_nodes)][:size]
            if len(candidates) == 0:
                continue
            current_from_bottom = len(layers) - current_lft - 1
            layers = extend_layer(layers, current_from_bottom, np.asarray(candidates))
    return layers, True


def _contains(sorted_arr: np.ndarray, v: int) -> bool:
    j = np.searchsorted(sorted_arr, v)
    return j < len(sorted_arr) and sorted_arr[j] == v
