"""Search-based graph optimization: relinking + stochastic recall + drivers.

Reference (reference: src/lib.rs:1070-1686): every node self-searches the
stack and inserts itself into the rows of its best matches under per-row
RwLocks (``link_nodes_in_layer_to_better_neighbors``, src/lib.rs:1084-1154);
*stochastic recall* — the fraction of sampled nodes that can find themselves —
is both the convergence criterion and the user-visible quality metric
(src/lib.rs:1463-1505); ``improve_neighbors_upto`` / ``improve_index[_at]``
loop until recall stops improving (src/lib.rs:1507-1686).

As arrays: relinking is one batched self-search of all N nodes plus a
lock-free segmented top-M row rebuild (double-buffered — the reference's
"pseudo layer" snapshot, src/lib.rs:1097-1100, is implicit in functional
arrays).  Recall is one vmapped self-search of the sample.  The outer loops
stay host-side, launching jitted programs.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parallel_hnsw.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw.graph import Layer, Source, node_to_vec, source_get, vec_to_node
from parallel_hnsw.ops.distance import Metric, batched_distance
from parallel_hnsw.ops.segment import rebuild_rows

# Cap on the [N, D] feature slab a fast scan relink may materialize; layers
# larger than this fall back to blocked graph-search relinks.  Sized for a
# 16 GB device, not measured on the GPU.
FAST_RELINK_BYTE_BUDGET = 2 << 30
from parallel_hnsw.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw.progress import ProgressMonitor, ensure_monitor
from parallel_hnsw.search import search, search_stack


@functools.partial(
    jax.jit, static_argnames=("metric", "sp", "stack_count", "match_count")
)
def _relink_layer_jit(
    stack_flat: Tuple[jax.Array, ...],  # layers[0..=lft] nodes/neighbors pairs
    source: Source,
    metric: Metric,
    sp: SearchParams,
    stack_count: int,
    match_count: int,
):
    """Batched relink of the deepest layer in ``stack_flat``.

    Equivalent to link_nodes_in_layer_to_better_neighbors (src/lib.rs:1084-1154):
    every node self-searches the stack (excluding itself), then inserts itself
    into the rows of its top ``match_count`` matches; rows keep their best M.
    """
    layers = [
        Layer(stack_flat[2 * i], stack_flat[2 * i + 1]) for i in range(stack_count)
    ]
    layer = layers[-1]
    nodes, neighbors = layer.nodes, layer.neighbors
    n, m = neighbors.shape

    valid = nodes != EMPTY_ID  # padding rows must not emit edges
    queries = source_get(source, nodes)
    res_ids, res_d, _, _, _ = search_stack(layers, source, metric, queries, sp, exclude=nodes)
    match_nodes = vec_to_node(nodes, res_ids[:, :match_count])  # [N, K]
    match_nodes = jnp.where(valid[:, None], match_nodes, EMPTY_ID)
    match_d = jnp.where(match_nodes == EMPTY_ID, EMPTY_DIST, res_d[:, :match_count])

    # recompute current row distances (rows store ids only — the reference
    # recomputes them during the locked scan, src/lib.rs:1128-1132)
    row_vecs = source_get(source, node_to_vec(nodes, neighbors))
    own = source_get(source, nodes)
    row_d = batched_distance(own, row_vecs, metric)
    row_d = jnp.where(neighbors != EMPTY_ID, row_d, EMPTY_DIST)

    self_ids = jnp.broadcast_to(jnp.arange(n, dtype=ID_DTYPE)[:, None], (n, m))
    match_src = jnp.broadcast_to(
        jnp.arange(n, dtype=ID_DTYPE)[:, None], match_nodes.shape
    )

    all_dst = jnp.concatenate([self_ids.reshape(-1), match_nodes.reshape(-1)])
    all_src = jnp.concatenate([neighbors.reshape(-1), match_src.reshape(-1)])
    all_d = jnp.concatenate([row_d.reshape(-1), match_d.reshape(-1)])

    new_neighbors, _ = rebuild_rows(n, m, all_dst, all_src, all_d)
    changed = jnp.sum(jnp.any(new_neighbors != neighbors, axis=-1).astype(jnp.int32))
    return new_neighbors, changed


def _flatten_stack(layers: Sequence[Layer]) -> Tuple[jax.Array, ...]:
    from parallel_hnsw.graph import pad_layer

    flat: List[jax.Array] = []
    for l in layers:
        pl = pad_layer(l)
        flat.extend([pl.nodes, pl.neighbors])
    return tuple(flat)


@functools.partial(jax.jit, static_argnames=("metric",))
def _row_dists_jit(nodes, neighbors_block, block_nodes, source, metric: Metric):
    row_vecs = source_get(source, node_to_vec(nodes, neighbors_block))
    own = source_get(source, block_nodes)
    row_d = batched_distance(own, row_vecs, metric)
    return jnp.where(neighbors_block != EMPTY_ID, row_d, EMPTY_DIST)


_rebuild_jit = jax.jit(rebuild_rows, static_argnums=(0, 1))


def _relink_layer_blocked(
    layers: List[Layer],
    source: Source,
    metric: Metric,
    sp: SearchParams,
    match_count: int,
    node_block: int,
):
    """Memory-bounded relink for huge layers: self-search and row-distance
    recomputation run in node blocks; the lock-free row rebuild runs once."""
    from parallel_hnsw.search import search as _search_host

    layer = layers[-1]
    nodes, neighbors = layer.nodes, layer.neighbors
    n, m = neighbors.shape

    match_nodes_parts, match_d_parts, row_d_parts = [], [], []
    from parallel_hnsw.graph import gather_features

    for start in range(0, n, node_block):
        stop = min(start + node_block, n)
        block_nodes = nodes[start:stop]
        queries = gather_features(source, block_nodes)
        res_ids, res_d = _search_host(
            layers, source, metric, queries, sp, exclude=block_nodes
        )
        mn = vec_to_node(nodes, res_ids[:, :match_count])
        mn = jnp.where((block_nodes != EMPTY_ID)[:, None], mn, EMPTY_ID)
        md = jnp.where(mn == EMPTY_ID, EMPTY_DIST, res_d[:, :match_count])
        match_nodes_parts.append(mn)
        match_d_parts.append(md)
        row_d_parts.append(
            _row_dists_jit(nodes, neighbors[start:stop], block_nodes, source, metric)
        )
    match_nodes = jnp.concatenate(match_nodes_parts)
    match_d = jnp.concatenate(match_d_parts)
    row_d = jnp.concatenate(row_d_parts)

    self_ids = jnp.broadcast_to(jnp.arange(n, dtype=ID_DTYPE)[:, None], (n, m))
    match_src = jnp.broadcast_to(
        jnp.arange(n, dtype=ID_DTYPE)[:, None], match_nodes.shape
    )
    all_dst = jnp.concatenate([self_ids.reshape(-1), match_nodes.reshape(-1)])
    all_src = jnp.concatenate([neighbors.reshape(-1), match_src.reshape(-1)])
    all_d = jnp.concatenate([row_d.reshape(-1), match_d.reshape(-1)])
    new_neighbors, _ = _rebuild_jit(n, m, all_dst, all_src, all_d)
    changed = int(
        jnp.sum(jnp.any(new_neighbors != neighbors, axis=-1).astype(jnp.int32))
    )
    return new_neighbors, changed


def _relink_layer_exact(
    layer: Layer,
    source: Source,
    metric: Metric,
    match_count: int,
    node_block: int,
    fast: bool = False,
):
    """Exact relink: matches are the true nearest neighbors within the layer,
    computed by blocked brute force — one matrix product per block, and
    strictly better edges than the reference's approximate matches.

    ``fast=True`` is the million-row tier: bf16 scan + approx_min_k +
    exact rerank of the oversampled survivors (see blocked_topk_pairwise);
    match distances stay full-precision either way."""
    from parallel_hnsw.analysis import blocked_topk_pairwise

    nodes, neighbors = layer.nodes, layer.neighbors
    n, m = neighbors.shape
    from parallel_hnsw.graph import gather_features

    feats = gather_features(source, nodes)
    match_nodes, match_d = blocked_topk_pairwise(
        feats, feats, metric, match_count, row_block=4096, exclude_diag_offset=0,
        fast=fast,
    )
    row_d_parts = []
    for start in range(0, n, node_block):
        stop = min(start + node_block, n)
        row_d_parts.append(
            _row_dists_jit(
                nodes, neighbors[start:stop], nodes[start:stop], source, metric
            )
        )
    row_d = jnp.concatenate(row_d_parts)

    self_ids = jnp.broadcast_to(jnp.arange(n, dtype=ID_DTYPE)[:, None], (n, m))
    match_src = jnp.broadcast_to(
        jnp.arange(n, dtype=ID_DTYPE)[:, None], match_nodes.shape
    )
    all_dst = jnp.concatenate([self_ids.reshape(-1), match_nodes.reshape(-1)])
    all_src = jnp.concatenate([neighbors.reshape(-1), match_src.reshape(-1)])
    all_d = jnp.concatenate([row_d.reshape(-1), match_d.reshape(-1)])
    new_neighbors, _ = _rebuild_jit(n, m, all_dst, all_src, all_d)
    changed = int(
        jnp.sum(jnp.any(new_neighbors != neighbors, axis=-1).astype(jnp.int32))
    )
    return new_neighbors, changed


def link_layer_to_better_neighbors(
    layers: List[Layer],
    layer_from_top: int,
    source: Source,
    metric: Metric,
    sp: SearchParams,
    node_block: int = 0,
    exact_threshold: int = 131072,
    fast_threshold: int = 2_000_000,
) -> Tuple[List[Layer], int]:
    """Relink one layer; returns the updated stack and #rows changed.
    ``node_block`` 0 = auto from a byte budget on the [block, M, D] row
    gather.  Tiering: exact scan matches up to ``exact_threshold`` nodes,
    fast scan matches (bf16 + rerank) up to ``fast_threshold`` when the
    feature slab fits the byte budget, blocked graph search beyond.

    Returns ``(layers, changed, tier)`` where ``tier`` names the relink path
    taken (``"exact"``/``"fast"``/``"blocked"``/``"jit"``).  The exact/fast
    tiers are **idempotent**: their match set is the true top-k of a
    scan — a pure function of (nodes, source), independent of the current
    rows — and a fixed-capacity best-m union is idempotent over a fixed
    added set, so re-running them on their own output provably changes
    nothing.  Callers use that to skip confirmation sweeps."""
    stack = layers[: layer_from_top + 1]
    if node_block <= 0:
        from parallel_hnsw.build import _auto_node_block

        node_block = _auto_node_block(stack[-1].neighborhood_size, source.dim)
    # match_count = neighborhood size of the *index*, not of this layer
    # (reference: self.neighborhood_size(), src/lib.rs:1093)
    match_count = min(stack[-1].neighborhood_size, sp.number_of_candidates)
    if 0 < stack[-1].node_count <= exact_threshold:
        new_neighbors, changed = _relink_layer_exact(
            stack[-1], source, metric, match_count, node_block
        )
        if changed == 0:  # identity-preserving: callers detect no-ops by id()
            return list(layers), 0, "exact"
        out = list(layers)
        out[layer_from_top] = Layer(nodes=stack[-1].nodes, neighbors=new_neighbors)
        return out, changed, "exact"
    from parallel_hnsw.graph import source_effective_width

    feat_bytes = stack[-1].node_count * source_effective_width(source) * 4
    if (
        fast_threshold
        and 0 < stack[-1].node_count <= fast_threshold
        and feat_bytes <= FAST_RELINK_BYTE_BUDGET
    ):
        new_neighbors, changed = _relink_layer_exact(
            stack[-1], source, metric, match_count, node_block, fast=True
        )
        if changed == 0:
            return list(layers), 0, "fast"
        out = list(layers)
        out[layer_from_top] = Layer(nodes=stack[-1].nodes, neighbors=new_neighbors)
        return out, changed, "fast"
    if stack[-1].node_count > node_block:
        from parallel_hnsw.graph import pad_layer

        padded_stack = [pad_layer(l) for l in stack[:-1]] + [stack[-1]]
        new_neighbors, changed = _relink_layer_blocked(
            padded_stack, source, metric, sp, match_count, node_block
        )
        if changed == 0:
            return list(layers), 0, "blocked"
        new_layer = Layer(nodes=stack[-1].nodes, neighbors=new_neighbors)
        out = list(layers)
        out[layer_from_top] = new_layer
        return out, changed, "blocked"
    new_neighbors, changed = _relink_layer_jit(
        _flatten_stack(stack), source, metric, sp, len(stack), match_count
    )
    changed = int(changed)
    if changed == 0:
        return list(layers), 0, "jit"
    # strip node-bucket padding rows back off
    new_layer = Layer(
        nodes=stack[-1].nodes, neighbors=new_neighbors[: stack[-1].node_count]
    )
    out = list(layers)
    out[layer_from_top] = new_layer
    return out, changed, "jit"


def stochastic_recall_at(
    layers: Sequence[Layer],
    at: int,
    source: Source,
    metric: Metric,
    op: OptimizationParams,
    seed: int = 42,
) -> float:
    """Sampled self-findability of layer ``at``-from-top's nodes via a full
    search (reference: stochastic_recall_at, src/lib.rs:1463-1499)."""
    from parallel_hnsw.utils.trace import TRACER

    layer = layers[at]
    total = layer.node_count
    selection = max(1, int(total * op.recall_proportion))
    if selection >= total:
        sample = layer.nodes
    else:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(total)[:selection]
        sample = jnp.take(layer.nodes, jnp.asarray(idx, ID_DTYPE))
    with TRACER.span("stochastic_recall", queries=float(selection), at=float(at)):
        queries = source_get(source, sample)
        ids, _ = search(list(layers), source, metric, queries, op.search)
        found = np.any(np.asarray(ids) == np.asarray(sample)[:, None], axis=-1)
    return float(found.mean())


def stochastic_recall(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    op: OptimizationParams,
    seed: int = 42,
) -> float:
    assert len(layers) > 0
    return stochastic_recall_at(layers, len(layers) - 1, source, metric, op, seed)


def improve_neighbors_upto(
    layers: List[Layer],
    upto: int,
    source: Source,
    metric: Metric,
    op: OptimizationParams,
    last_recall: Optional[float] = None,
    log: Optional[Callable[[str], None]] = None,
    monitor: Optional[ProgressMonitor] = None,
) -> Tuple[List[Layer], float]:
    """Relink layers 0..upto until recall stops improving (reference:
    improve_neighbors_upto, src/lib.rs:1515-1544).  The monitor is polled
    once per relink sweep so a long repair is cancellable (reference threads
    ``&mut dyn ProgressMonitor`` through, src/lib.rs:1551-1554)."""
    assert 1 <= upto <= len(layers)
    monitor = ensure_monitor(monitor)
    last = last_recall if last_recall is not None else 0.0
    # only recall values measured in THIS loop are known to describe the
    # current graph; the caller's value may predate a mutation
    have_measured = False
    improvement = 1.0
    from parallel_hnsw.utils.trace import TRACER

    while improvement >= op.neighborhood_threshold and last < 1.0:
        total_changed = 0
        all_idempotent = True
        for lft in range(upto):
            monitor.alive()
            with TRACER.span("relink_layer", layer_from_top=lft):
                layers, changed, tier = link_layer_to_better_neighbors(
                    layers, lft, source, metric, op.search,
                    exact_threshold=op.exact_relink_threshold,
                    fast_threshold=op.fast_relink_threshold,
                )
            total_changed += changed
            all_idempotent &= tier in ("exact", "fast")
            TRACER.count("relinked", rows=float(changed))
            if log:
                log(f"layer {lft}: relinked {changed} ({tier})")
        if total_changed == 0 and have_measured:
            # no row changed, so the (deterministic, seed-42) recall measure
            # would repeat ``last`` exactly and the loop would exit with
            # improvement 0 — skip the redundant search
            break
        recall = stochastic_recall_at(layers, upto - 1, source, metric, op)
        improvement = recall - last
        last = recall
        have_measured = True
        if log:
            log(f"recall at {upto}/{len(layers)}: {recall} (improvement {improvement})")
        if all_idempotent:
            # every layer took an exact/fast scan relink, which is idempotent
            # (see link_layer_to_better_neighbors): a second sweep provably
            # changes no rows and the re-measure repeats ``recall``, so the
            # loop would exit with improvement 0 — stop here
            break
    return layers, last


def improve_neighbors(
    layers: List[Layer],
    source: Source,
    metric: Metric,
    op: OptimizationParams,
    last_recall: Optional[float] = None,
    monitor: Optional[ProgressMonitor] = None,
) -> Tuple[List[Layer], float]:
    return improve_neighbors_upto(
        layers, len(layers), source, metric, op, last_recall, monitor=monitor
    )


# A promoter callback has signature
#   promoter(layers, layer_from_top, bp) -> (layers, did_promote: bool)
Promoter = Callable[[List[Layer], int, BuildParams], Tuple[List[Layer], bool]]


def improve_index_at(
    layers: List[Layer],
    layer_from_top: int,
    bp: BuildParams,
    source: Source,
    metric: Metric,
    last_recall: Optional[float] = None,
    promoter: Optional[Promoter] = None,
    log: Optional[Callable[[str], None]] = None,
    monitor: Optional[ProgressMonitor] = None,
) -> Tuple[List[Layer], float, int]:
    """Reference: improve_index_at (src/lib.rs:1546-1603)."""
    op = bp.optimization
    monitor = ensure_monitor(monitor)
    recall = (
        last_recall
        if last_recall is not None
        else stochastic_recall_at(layers, layer_from_top, source, metric, op)
    )
    improvement = 1.0
    bailout = 1
    while improvement >= op.promotion_threshold and recall < 1.0 and bailout != 0:
        last = recall
        current = 0
        while current <= layer_from_top and bailout != 0:
            monitor.alive()
            layer_count = len(layers)
            layers, recall = improve_neighbors_upto(
                layers, current + 1, source, metric, op, None, log, monitor
            )
            if recall == 1.0:
                current += 1
                continue
            if promoter is not None:
                layers, promoted = promoter(layers, current, bp)
                if promoted:
                    delta = len(layers) - layer_count
                    assert delta >= 0
                    current += delta
                    layer_from_top += delta
                    layers, recall = improve_neighbors_upto(
                        layers, current + 1, source, metric, op, recall, log, monitor
                    )
            current += 1
        bailout -= 1
        improvement = recall - last
    return layers, recall, layer_from_top


def improve_index(
    layers: List[Layer],
    bp: BuildParams,
    source: Source,
    metric: Metric,
    last_recall: Optional[float] = None,
    promoter: Optional[Promoter] = None,
    log: Optional[Callable[[str], None]] = None,
    monitor: Optional[ProgressMonitor] = None,
) -> Tuple[List[Layer], float]:
    """Reference: improve_index (src/lib.rs:1664-1686).

    The reference eagerly measures stochastic recall here and then passes
    ``None`` to every ``improve_index_at`` call (src/lib.rs:1671-1680), so the
    eager value is only ever used as a fallback return for an empty stack —
    which is asserted away.  We skip that wasted full-stack search and let the
    first ``improve_index_at`` measure lazily; control flow is identical.
    """
    monitor = ensure_monitor(monitor)
    assert len(layers) > 0
    recall = last_recall if last_recall is not None else 0.0
    layer_from_top = 0
    while layer_from_top < len(layers):
        monitor.alive()
        layers, recall, layer_from_top = improve_index_at(
            layers, layer_from_top, bp, source, metric, None, promoter, log, monitor
        )
        layer_from_top += 1
    return layers, recall
