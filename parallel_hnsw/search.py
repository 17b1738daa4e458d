"""Batched beam search over the layer stack — the query engine.

Reference hot loop (`Layer::closest_nodes`, reference: src/lib.rs:175-248):
pop nearest unvisited node, gather its neighbor row, compute distances, merge
into a sorted candidate queue; give up after ``probe_depth`` non-improving
pops.  Multi-layer descent in ``search_layers`` (src/search.rs:84-140).

Batched re-design: thousands of queries run in lockstep inside one jitted
program.  Per query the state is a fixed-capacity sorted candidate queue with
an "expanded" bit per slot; one *hop* expands the ``beam_width`` nearest
unexpanded candidates, gathers their neighbor rows, computes all distances as
one batched contraction, and merges via masked sort.  Data-dependent
termination (``did_something`` / ``probe_depth``) becomes a per-query
convergence mask inside ``lax.while_loop``; the loop exits when every query in
the batch has converged.  Zero host round-trips per hop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from parallel_hnsw.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw.graph import Layer, Source, node_to_vec, source_get, vec_to_node
from parallel_hnsw.ops.distance import Metric, batched_distance, distance_one
from parallel_hnsw.ops.queues import (
    empty_queue,
    merge_queue,
    merge_queue_with_flags,
    sort_queue,
)
from parallel_hnsw.params import SearchParams


class LayerSearchState(NamedTuple):
    ids: jax.Array  # [Q, cap] node ids, (dist,id)-sorted
    dists: jax.Array  # [Q, cap]
    expanded: jax.Array  # [Q, cap] int32 0/1
    probes: jax.Array  # [Q] remaining non-improving hops
    done: jax.Array  # [Q] bool
    hops: jax.Array  # scalar int32
    evals: jax.Array  # scalar int32 — total distance evaluations (instrumentation)
    improve_hop: jax.Array  # [Q] hop index of the last head-improving merge —
    # the batched analogue of the reference's index_sum instrumentation
    # (src/lib.rs:190-229, search_layers_instrumented)


def _auto_max_hops(cap: int, max_hops: int) -> int:
    return max_hops if max_hops > 0 else cap


def _layer_step_fns(
    layer: Layer,
    source: Source,
    metric: Metric,
    queries: jax.Array,
    cap: int,
    beam_width: int,
    max_hops: int,
    slab=None,
):
    """Build the (cond, body) of the per-layer expansion loop; shared by the
    one-shot in-jit search and the resumable host-driven advance.

    ``slab`` is an optional neighbor-major feature slab ``[N, M, dr]``
    (``slab[n, j]`` = features of ``layer.neighbors[n, j]``): the hop then
    issues ONE row gather per expanded node instead of M per-candidate
    gathers: packing the M neighbor feature rows into one slab row cuts the
    hop's gather count by ~M at the price of M-fold feature duplication in
    device memory (see
    ``routing.build_hop_slabs`` for the memory budget / projection options).
    """
    q_count = queries.shape[0]
    n, m = layer.neighbors.shape
    b = min(beam_width, cap)

    slot_pos = jnp.arange(cap, dtype=jnp.int32)

    def cond(state: LayerSearchState) -> jax.Array:
        return (state.hops < max_hops) & jnp.any(~state.done)

    def body(state: LayerSearchState) -> LayerSearchState:
        ids, dists, expanded, probes, done, hops, evals, improve_hop = state
        prev_head = ids[:, 0]
        # --- select up to `b` nearest unexpanded slots per query
        frontier = (expanded == 0) & (ids != EMPTY_ID) & ~done[:, None]
        rank = jnp.where(frontier, slot_pos[None, :], cap)
        neg_rank, sel_slots = jax.lax.top_k(-rank, b)  # [Q, b] smallest ranks
        sel_valid = neg_rank > -cap
        sel_nodes = jnp.take_along_axis(ids, sel_slots, axis=-1)  # [Q, b]

        # mark selected slots expanded
        expanded = expanded.at[jnp.arange(q_count)[:, None], sel_slots].set(
            jnp.where(sel_valid, 1, jnp.take_along_axis(expanded, sel_slots, axis=-1))
        )

        # --- gather neighbor rows [Q, b, M]
        safe_nodes = jnp.clip(sel_nodes, 0, n - 1)
        rows = jnp.take(layer.neighbors, safe_nodes, axis=0)
        rows = jnp.where(sel_valid[..., None], rows, EMPTY_ID)
        flat_nodes = rows.reshape(q_count, b * m)
        valid = flat_nodes != EMPTY_ID

        # --- distances to the query (one batched contraction)
        if slab is not None:
            # one slab row per expanded node carries all M neighbor features;
            # invalid slots are masked below via flat_nodes == EMPTY_ID
            cand_vecs = jnp.take(slab, safe_nodes, axis=0).reshape(
                q_count, b * m, slab.shape[-1]
            )
        else:
            cand_vecs = source_get(source, node_to_vec(layer.nodes, flat_nodes))
        d = batched_distance(queries, cand_vecs, metric)
        d = jnp.where(valid, d, EMPTY_DIST)
        flat_ids = jnp.where(valid, flat_nodes, EMPTY_ID)
        evals = evals + jnp.sum(valid.astype(jnp.int32))

        # --- merge into queues (a full two-key sort of queue + candidates)
        ids, dists, expanded, changed = merge_queue_with_flags(
            ids, dists, expanded, flat_ids, d
        )

        # --- termination accounting (reference: probe_depth decrement on
        # non-improving rounds, src/lib.rs:233-238)
        probes = jnp.where(~done & ~changed, probes - 1, probes)
        newly_done = (probes <= 0) | ~jnp.any(
            (expanded == 0) & (ids != EMPTY_ID), axis=-1
        )
        done = done | newly_done
        head_improved = (ids[:, 0] != prev_head) & ~state.done
        improve_hop = jnp.where(head_improved, hops + 1, improve_hop)
        return LayerSearchState(
            ids, dists, expanded, probes, done, hops + 1, evals, improve_hop
        )

    return cond, body


def search_one_layer(
    layer: Layer,
    source: Source,
    metric: Metric,
    queries: jax.Array,  # [Q, D]
    init_ids: jax.Array,  # [Q, cap] node ids
    init_dists: jax.Array,  # [Q, cap]
    *,
    probe_depth: int,
    beam_width: int,
    max_hops: int,
    slab=None,
) -> LayerSearchState:
    """Expand candidate queues inside one layer until convergence.

    Equivalent of `Layer::closest_nodes` (src/lib.rs:175-248), batched.
    """
    q_count, cap = init_ids.shape
    max_hops = _auto_max_hops(cap, max_hops)
    cond, body = _layer_step_fns(
        layer, source, metric, queries, cap, beam_width, max_hops, slab=slab
    )
    init = LayerSearchState(
        ids=init_ids,
        dists=init_dists,
        expanded=jnp.zeros((q_count, cap), dtype=jnp.int32),
        probes=jnp.full((q_count,), probe_depth, dtype=jnp.int32),
        done=~jnp.any(init_ids != EMPTY_ID, axis=-1),
        hops=jnp.zeros((), jnp.int32),
        evals=jnp.zeros((), jnp.int32),
        improve_hop=jnp.zeros((q_count,), jnp.int32),
    )
    return jax.lax.while_loop(cond, body, init)


@functools.partial(
    jax.jit, static_argnames=("metric", "beam_width", "chunk_hops", "probe_depth")
)
def _advance_layer_jit(
    nodes,
    neighbors,
    source,
    queries,
    ids,
    dists,
    expanded,
    probes,
    done,
    metric: Metric,
    beam_width: int,
    chunk_hops: int,
    probe_depth: int,
):
    """Run up to ``chunk_hops`` expansion hops from a resumable state."""
    layer = Layer(nodes, neighbors)
    cap = ids.shape[-1]
    cond, body = _layer_step_fns(
        layer, source, metric, queries, cap, beam_width, chunk_hops
    )
    state = LayerSearchState(
        ids,
        dists,
        expanded,
        probes,
        done,
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((ids.shape[0],), jnp.int32),
    )
    return jax.lax.while_loop(cond, body, state)


def _host_layer_search(
    layer: Layer,
    source: Source,
    metric: Metric,
    queries: jax.Array,
    init_ids: jax.Array,
    init_dists: jax.Array,
    sp: SearchParams,
    chunk_hops: int = 16,
):
    """Host-driven layer search with convergence-tail compaction.

    The in-jit while loop runs the whole batch in lockstep until the SLOWEST
    query converges — typically ~5x more hops than the median needs.  Here the
    loop is chunked: every ``chunk_hops`` hops, converged queries retire to the
    output and the remainder is compacted into a smaller (bucketed) batch, so
    stragglers stop taxing the finished majority.
    """
    q = queries.shape[0]
    cap = init_ids.shape[-1]
    max_hops = _auto_max_hops(cap, sp.max_hops)

    out_ids = jnp.full((q, cap), EMPTY_ID, ID_DTYPE)
    out_dists = jnp.full((q, cap), EMPTY_DIST, jnp.float32)

    import numpy as np

    active = np.arange(q)
    act_queries = queries
    ids, dists = init_ids, init_dists
    expanded = jnp.zeros((q, cap), jnp.int32)
    probes = jnp.full((q,), sp.probe_depth, jnp.int32)
    done = ~jnp.any(init_ids != EMPTY_ID, axis=-1)
    hops_used = 0

    while True:
        state = _advance_layer_jit(
            layer.nodes,
            layer.neighbors,
            source,
            act_queries,
            ids,
            dists,
            expanded,
            probes,
            done,
            metric,
            sp.beam_width,
            chunk_hops,
            sp.probe_depth,
        )
        hops_used += int(state.hops)
        n_act = len(active)
        done_np = np.asarray(state.done)[:n_act]
        if hops_used >= max_hops:
            done_np = np.ones_like(done_np)
        fin = np.nonzero(done_np)[0]
        if len(fin):
            fin_j = jnp.asarray(fin, ID_DTYPE)
            out_ids = out_ids.at[jnp.asarray(active[fin], ID_DTYPE)].set(
                jnp.take(state.ids, fin_j, axis=0)
            )
            out_dists = out_dists.at[jnp.asarray(active[fin], ID_DTYPE)].set(
                jnp.take(state.dists, fin_j, axis=0)
            )
        keep = np.nonzero(~done_np)[0]
        if len(keep) == 0:
            break
        active = active[keep]
        b = _query_bucket(len(keep))
        pad = b - len(keep)
        keep_j = jnp.asarray(keep, ID_DTYPE)

        def take_pad(arr, fill, dtype=None):
            sub = jnp.take(arr, keep_j, axis=0)
            if pad:
                pad_block = jnp.full((pad,) + sub.shape[1:], fill, sub.dtype)
                sub = jnp.concatenate([sub, pad_block])
            return sub

        act_queries = take_pad(act_queries[:n_act], 0.0)
        ids = take_pad(state.ids[:n_act], EMPTY_ID)
        dists = take_pad(state.dists[:n_act], EMPTY_DIST)
        expanded = take_pad(state.expanded[:n_act], 0)
        probes = take_pad(state.probes[:n_act], 0)
        done = take_pad(state.done[:n_act], True)
    return out_ids, out_dists


def _entry_seed(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: jax.Array,
    cap: int,
) -> Tuple[jax.Array, jax.Array]:
    """Seed the candidate queue with the entry vector — the first node of the
    top layer (reference: src/search.rs:9-11,101-111)."""
    q_count = queries.shape[0]
    entry_vec = layers[0].nodes[0]
    ev = source_get(source, entry_vec[None])[0]  # [D]
    d = distance_one(queries, jnp.broadcast_to(ev, queries.shape), metric)
    ids, dists = empty_queue(cap, (q_count,))
    ids = ids.at[:, 0].set(entry_vec)
    dists = dists.at[:, 0].set(d)
    return ids, dists


def search_stack(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: jax.Array,  # [Q, D]
    sp: SearchParams,
    exclude: Optional[jax.Array] = None,  # [Q] vector ids to drop from results
    slabs=None,  # optional per-layer neighbor-major feature slabs
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Descend the layer stack (reference: search_layers, src/search.rs:84-140).

    Returns ``(vector_ids [Q, noc], dists [Q, noc], hops, evals)`` sorted
    ascending by ``(dist, id)`` with EMPTY padding.
    """
    noc = sp.number_of_candidates
    ulcc = sp.upper_layer_candidate_count
    q_count = queries.shape[0]

    cand_ids, cand_dists = _entry_seed(layers, source, metric, queries, noc)
    total_hops = jnp.zeros((), jnp.int32)
    total_evals = jnp.zeros((), jnp.int32)
    bottom_improve_hop = jnp.zeros((q_count,), jnp.int32)

    for i, layer in enumerate(layers):
        is_bottom = i == len(layers) - 1 or len(layers) == 1
        out_count = noc if is_bottom else ulcc

        node_ids = vec_to_node(layer.nodes, cand_ids)
        node_dists = jnp.where(node_ids == EMPTY_ID, EMPTY_DIST, cand_dists)
        # queue for this layer at full capacity (reference uses the carried
        # queue's capacity, src/lib.rs:264)
        init_ids, init_dists = merge_queue(
            *empty_queue(noc, (q_count,)), node_ids, node_dists
        )[:2]

        state = search_one_layer(
            layer,
            source,
            metric,
            queries,
            init_ids,
            init_dists,
            probe_depth=sp.probe_depth,
            beam_width=sp.beam_width,
            max_hops=sp.max_hops,
            slab=slabs[i] if slabs is not None else None,
        )
        total_hops = total_hops + state.hops
        total_evals = total_evals + state.evals
        if is_bottom:
            bottom_improve_hop = state.improve_hop

        found_vecs = node_to_vec(layer.nodes, state.ids)
        found_dists = state.dists
        if exclude is not None:
            drop = found_vecs == exclude[:, None]
            found_vecs = jnp.where(drop, EMPTY_ID, found_vecs)
            found_dists = jnp.where(drop, EMPTY_DIST, found_dists)
        # keep only the best `out_count` from this layer (reference: take(
        # candidate_count), src/lib.rs:273)
        if out_count < noc:
            found_vecs = found_vecs[:, :out_count]
            found_dists = found_dists[:, :out_count]

        cand_ids, cand_dists, _ = merge_queue(cand_ids, cand_dists, found_vecs, found_dists)

    if exclude is not None:
        # the entry seed bypasses the per-layer filter (the reference leaks it
        # too and re-filters at call sites, e.g. src/search.rs:78-82); drop it
        # from the final result for a clean exclusion contract.
        drop = cand_ids == exclude[:, None]
        cand_ids = jnp.where(drop, EMPTY_ID, cand_ids)
        cand_dists = jnp.where(drop, EMPTY_DIST, cand_dists)
        cand_ids, cand_dists = sort_queue(cand_ids, cand_dists)

    return cand_ids, cand_dists, total_hops, total_evals, bottom_improve_hop


@functools.partial(jax.jit, static_argnames=())
def _enter_layer_jit(nodes, cand_ids, cand_dists):
    node_ids = vec_to_node(nodes, cand_ids)
    node_dists = jnp.where(node_ids == EMPTY_ID, EMPTY_DIST, cand_dists)
    q = cand_ids.shape[0]
    cap = cand_ids.shape[1]
    init_ids, init_dists, _ = merge_queue(
        *empty_queue(cap, (q,)), node_ids, node_dists
    )
    return init_ids, init_dists


@functools.partial(jax.jit, static_argnames=("out_count", "has_exclude"))
def _exit_layer_jit(
    nodes, found_ids, found_dists, cand_ids, cand_dists, exclude, out_count: int,
    has_exclude: bool,
):
    found_vecs = node_to_vec(nodes, found_ids)
    fd = found_dists
    if has_exclude:
        drop = found_vecs == exclude[:, None]
        found_vecs = jnp.where(drop, EMPTY_ID, found_vecs)
        fd = jnp.where(drop, EMPTY_DIST, fd)
    if out_count < found_vecs.shape[-1]:
        found_vecs = found_vecs[:, :out_count]
        fd = fd[:, :out_count]
    out_ids, out_dists, _ = merge_queue(cand_ids, cand_dists, found_vecs, fd)
    return out_ids, out_dists


@functools.partial(jax.jit, static_argnames=("has_exclude",))
def _final_exclude_jit(cand_ids, cand_dists, exclude, has_exclude: bool):
    if has_exclude:
        drop = cand_ids == exclude[:, None]
        cand_ids = jnp.where(drop, EMPTY_ID, cand_ids)
        cand_dists = jnp.where(drop, EMPTY_DIST, cand_dists)
        cand_ids, cand_dists = sort_queue(cand_ids, cand_dists)
    return cand_ids, cand_dists


def search_host(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: jax.Array,
    sp: SearchParams,
    exclude: Optional[jax.Array] = None,
    chunk_hops: int = 16,
) -> Tuple[jax.Array, jax.Array]:
    """Host-driven layer-stack descent with convergence-tail compaction.

    Same semantics as :func:`search_stack`; the layer loop runs on the host so
    each layer's expansion can retire converged queries between hop chunks.
    """
    from parallel_hnsw.graph import pad_layer

    noc = sp.number_of_candidates
    ulcc = sp.upper_layer_candidate_count
    padded = [pad_layer(l) for l in layers]

    cand_ids, cand_dists = _entry_seed(padded, source, metric, queries, noc)
    for i, layer in enumerate(padded):
        is_bottom = i == len(padded) - 1 or len(padded) == 1
        out_count = noc if is_bottom else ulcc
        init_ids, init_dists = _enter_layer_jit(layer.nodes, cand_ids, cand_dists)
        found_ids, found_dists = _host_layer_search(
            layer, source, metric, queries, init_ids, init_dists, sp, chunk_hops
        )
        cand_ids, cand_dists = _exit_layer_jit(
            layer.nodes,
            found_ids,
            found_dists,
            cand_ids,
            cand_dists,
            exclude if exclude is not None else jnp.zeros((queries.shape[0],), ID_DTYPE),
            out_count,
            exclude is not None,
        )
    return _final_exclude_jit(
        cand_ids,
        cand_dists,
        exclude if exclude is not None else jnp.zeros((queries.shape[0],), ID_DTYPE),
        exclude is not None,
    )


@functools.partial(
    jax.jit, static_argnames=("metric", "sp", "layer_count")
)
def _search_stack_jit(
    layers_flat,
    source,
    metric: Metric,
    queries,
    sp: SearchParams,
    exclude,
    layer_count: int,
    slabs=None,
):
    layers = [Layer(*layers_flat[2 * i : 2 * i + 2]) for i in range(layer_count)]
    return search_stack(layers, source, metric, queries, sp, exclude, slabs=slabs)


def auto_query_block(source: Source, sp: SearchParams, max_m: int, budget_bytes: int = 2 << 30) -> int:
    """Query-block size bounding the per-hop gathered candidate block
    ``[Q, beam*M, width]`` where width is the effective vector width (see
    ``graph.source_effective_width``)."""
    from parallel_hnsw.graph import source_effective_width

    eff = source_effective_width(source)
    qb = budget_bytes // max(1, sp.beam_width * max_m * eff * 4)
    return int(max(64, min(8192, qb)))


def _query_bucket(q: int) -> int:
    """Round a query count up to a shape bucket (1-2-3 x powers of two) so
    varying batch sizes reuse compiled programs."""
    if q <= 16:
        return 16
    p = 16
    while True:
        for b in (p, p + p // 2):  # 16, 24, 32, 48, 64, 96, ...
            if q <= b:
                return b
        p *= 2


def _run_block(
    flat, source, metric, queries, sp, exclude, layer_count, layers=None,
    slabs=None,
):
    q = queries.shape[0]
    b = _query_bucket(q)
    if b != q:
        pad = b - q
        queries = jnp.concatenate([queries, jnp.zeros((pad, queries.shape[1]), queries.dtype)])
        if exclude is not None:
            exclude = jnp.concatenate([exclude, jnp.full((pad,), EMPTY_ID, ID_DTYPE)])
    if layers is not None:
        ids, dists = search_host(layers, source, metric, queries, sp, exclude)
    else:
        ids, dists, hops, evals, improve_hop = _search_stack_jit(
            flat, source, metric, queries, sp, exclude, layer_count, slabs
        )
    return ids[:q], dists[:q]


def search(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: jax.Array,
    sp: SearchParams,
    exclude: Optional[jax.Array] = None,
    query_block: int = 0,
    adaptive: bool = False,
    slabs=None,
) -> Tuple[jax.Array, jax.Array]:
    """Multi-layer search with optional host-side query chunking.

    ``query_block`` bounds device memory for huge query batches (the gathered
    candidate block is ``[Q, beam*M, D]``); 0 = single launch.  ``adaptive``
    enables the host-driven convergence-tail compaction path (not measured
    on the GPU); the default is the single fully-jitted lockstep program.

    Layers are padded to node-count buckets and queries to batch buckets so
    drifting shapes (promotions, recall samples) reuse compiled programs.
    """
    from parallel_hnsw.graph import pad_layer

    if layers and query_block <= 0:
        # bound the per-hop gathered candidate block by memory budget
        max_m = max(l.neighborhood_size for l in layers)
        query_block = auto_query_block(source, sp, max_m)

    flat = []
    for i, l in enumerate(layers):
        pl = pad_layer(l)
        flat.extend([pl.nodes, pl.neighbors])
        if slabs is not None and slabs[i].shape[:2] != pl.neighbors.shape:
            raise ValueError(
                f"hop slab {i} shape {slabs[i].shape[:2]} does not match the "
                f"padded layer {pl.neighbors.shape} — rebuild the slabs "
                "(the graph changed since enable_hop_slabs)"
            )
    flat = tuple(flat)
    if slabs is not None:
        slabs = tuple(slabs)
    adaptive_layers = list(layers) if adaptive else None

    if query_block <= 0 or queries.shape[0] <= query_block:
        return _run_block(
            flat, source, metric, queries, sp, exclude, len(layers),
            adaptive_layers, slabs,
        )

    outs = []
    for start in range(0, queries.shape[0], query_block):
        stop = min(start + query_block, queries.shape[0])
        ex = exclude[start:stop] if exclude is not None else None
        outs.append(
            _run_block(
                flat, source, metric, queries[start:stop], sp, ex, len(layers),
                adaptive_layers, slabs,
            )
        )
    ids = jnp.concatenate([o[0] for o in outs], axis=0)
    dists = jnp.concatenate([o[1] for o in outs], axis=0)
    return ids, dists


def search_instrumented(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: jax.Array,
    sp: SearchParams,
    exclude: Optional[jax.Array] = None,
):
    """Search with instrumentation (reference: search_layers_instrumented /
    Hnsw::search_instrumented, src/search.rs:93-140, src/lib.rs:667-673).

    Returns ``(ids, dists, stats)`` where stats carries the total hop count,
    total distance evaluations, and the per-query hop index of the last
    head-improving merge in the bottom layer (the analogue of the reference's
    ``index_distance``).
    """
    from parallel_hnsw.graph import pad_layer

    flat = []
    for l in layers:
        pl = pad_layer(l)
        flat.extend([pl.nodes, pl.neighbors])
    q = queries.shape[0]
    b = _query_bucket(q)
    if b != q:
        pad = b - q
        queries = jnp.concatenate(
            [queries, jnp.zeros((pad, queries.shape[1]), queries.dtype)]
        )
        if exclude is not None:
            exclude = jnp.concatenate([exclude, jnp.full((pad,), EMPTY_ID, ID_DTYPE)])
    ids, dists, hops, evals, improve_hop = _search_stack_jit(
        tuple(flat), source, metric, queries, sp, exclude, len(layers)
    )
    stats = {
        "hops": int(hops),
        "distance_evaluations": int(evals),
        "last_improvement_hop": improve_hop[:q],
    }
    return ids[:q], dists[:q], stats
