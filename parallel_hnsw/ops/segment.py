"""Segmented top-M neighbor-row rebuild.

The reference symmetrizes a freshly built layer by wrapping every neighbor row
in a ``RwLock<PriorityQueue>`` and concurrently inserting reverse edges
(reference: src/lib.rs:789-815); relinking likewise shift-inserts into
locked rows (src/lib.rs:1123-1147).  Since a fixed-capacity sorted insert only
ever drops the current worst element, the final row contents equal the
best-M of the union of all inserted edges — independent of insertion order.

The array form is lock-free: emit all candidate edges as
``(dst, src, dist)`` triples, globally sort, dedup ``(dst, src)`` pairs, rank
within each ``dst`` segment, keep ranks < M, and scatter into a fresh
``[N, M]`` slab.  Deterministic where the reference is scheduling-dependent.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from parallel_hnsw.constants import DIST_DTYPE, EMPTY_DIST, EMPTY_ID, ID_DTYPE


# Cap on a single flat lax.sort's element count (a cap carried over from a
# 16 GB device, not measured on the GPU).  Larger edge lists are folded
# through bounded chunks and merged row-wise below.
MAX_SORT_ELEMENTS = 8 << 20


def rebuild_rows(
    n_rows: int,
    m: int,
    dst: jax.Array,  # [E] int32 row ids (EMPTY_ID = invalid)
    src: jax.Array,  # [E] int32 neighbor node ids
    dist: jax.Array,  # [E] f32
) -> Tuple[jax.Array, jax.Array]:
    """Keep the best ``m`` unique ``src`` per ``dst`` row, sorted by
    ``(dist, src)``.  Returns ``(neighbors [n_rows, m], dists [n_rows, m])``
    with EMPTY padding.

    Edge lists beyond MAX_SORT_ELEMENTS are processed as a fold: each chunk
    rebuilds a partial ``[n_rows, m]`` slab (bounded flat sort), and slabs
    merge row-wise with dedup-by-src-keep-min — mathematically identical to
    the single-shot rebuild because a fixed-capacity best-m union is
    associative."""
    e = dst.shape[0]
    if e <= MAX_SORT_ELEMENTS:
        return _rebuild_rows_flat(n_rows, m, dst, src, dist)
    acc_i = acc_d = None
    for s in range(0, e, MAX_SORT_ELEMENTS):
        pi, pd = _rebuild_rows_flat(
            n_rows, m, dst[s : s + MAX_SORT_ELEMENTS],
            src[s : s + MAX_SORT_ELEMENTS], dist[s : s + MAX_SORT_ELEMENTS],
        )
        if acc_i is None:
            acc_i, acc_d = pi, pd
        else:
            acc_i, acc_d = _merge_slabs(acc_i, acc_d, pi, pd, m)
    return acc_i, acc_d


@functools.partial(jax.jit, static_argnums=(4,))
def _merge_slabs(a_i, a_d, b_i, b_d, m: int) -> Tuple[jax.Array, jax.Array]:
    """Row-wise best-m merge of two (dist, src)-sorted EMPTY-padded slabs,
    dedup by src keeping the smaller distance (robust to fp-path skew)."""
    cat_i = jnp.concatenate([a_i, b_i], axis=-1)
    cat_d = jnp.concatenate([a_d, b_d], axis=-1)
    # group by src: (src, dist) lex sort puts duplicates adjacent, best first
    i1, d1 = jax.lax.sort((cat_i, cat_d), dimension=-1, num_keys=2, is_stable=True)
    dup = jnp.concatenate(
        [
            jnp.zeros(i1.shape[:-1] + (1,), bool),
            (i1[..., 1:] == i1[..., :-1]) & (i1[..., 1:] != EMPTY_ID),
        ],
        axis=-1,
    )
    i1 = jnp.where(dup, EMPTY_ID, i1)
    d1 = jnp.where(dup, EMPTY_DIST, d1)
    # rank by (dist, src)
    d2, i2 = jax.lax.sort((d1, i1), dimension=-1, num_keys=2, is_stable=True)
    return i2[..., :m], d2[..., :m]


# one program per shape: run eagerly, each of its two dozen ops is a compile
# of its own at every new edge count
@functools.partial(jax.jit, static_argnums=(0, 1))
def _rebuild_rows_flat(
    n_rows: int,
    m: int,
    dst: jax.Array,
    src: jax.Array,
    dist: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    # drop self-edges and invalid entries
    invalid = (dst == src) | (dst == EMPTY_ID) | (src == EMPTY_ID) | ~jnp.isfinite(dist)
    dst = jnp.where(invalid, EMPTY_ID, dst)
    src = jnp.where(invalid, EMPTY_ID, src)
    dist = jnp.where(invalid, EMPTY_DIST, dist)

    # pass 1: sort by (dst, src, dist); mark later duplicates of (dst, src)
    dst1, src1, dist1 = jax.lax.sort((dst, src, dist), num_keys=3, is_stable=True)
    dup = (
        (dst1[1:] == dst1[:-1]) & (src1[1:] == src1[:-1]) & (dst1[1:] != EMPTY_ID)
    )
    dup = jnp.concatenate([jnp.zeros((1,), bool), dup])
    dst1 = jnp.where(dup, EMPTY_ID, dst1)
    src1 = jnp.where(dup, EMPTY_ID, src1)
    dist1 = jnp.where(dup, EMPTY_DIST, dist1)

    # pass 2: sort by (dst, dist, src) — row-major best-first
    dst2, dist2, src2 = jax.lax.sort((dst1, dist1, src1), num_keys=3, is_stable=True)

    # rank within each dst segment
    e = dst2.shape[0]
    seg_start = jnp.searchsorted(dst2, dst2, side="left")
    rank = jnp.arange(e, dtype=ID_DTYPE) - seg_start.astype(ID_DTYPE)

    keep = (rank < m) & (dst2 != EMPTY_ID)
    rows = jnp.where(keep, dst2, n_rows)  # out-of-bounds → dropped
    cols = jnp.where(keep, rank, 0)

    neighbors = jnp.full((n_rows, m), EMPTY_ID, dtype=ID_DTYPE)
    dists = jnp.full((n_rows, m), EMPTY_DIST, dtype=DIST_DTYPE)
    neighbors = neighbors.at[rows, cols].set(src2, mode="drop")
    dists = dists.at[rows, cols].set(dist2, mode="drop")
    return neighbors, dists


def symmetrize(
    neighbors: jax.Array,  # [N, M] node-id rows (EMPTY-padded)
    dists: jax.Array,  # [N, M] matching distances
) -> Tuple[jax.Array, jax.Array]:
    """Make neighborhoods bidirectional (reference: src/lib.rs:795-815).

    Final row r = best-M of {r's forward edges} ∪ {reverse edges (s, r, d) for
    every forward edge (r in s's row)}.
    """
    n, m = neighbors.shape
    row_ids = jnp.broadcast_to(
        jnp.arange(n, dtype=ID_DTYPE)[:, None], (n, m)
    )
    fwd_dst = row_ids.reshape(-1)
    fwd_src = neighbors.reshape(-1)
    fwd_d = dists.reshape(-1)
    # reverse edges: (neighbor, node, d)
    all_dst = jnp.concatenate([fwd_dst, fwd_src])
    all_src = jnp.concatenate([fwd_src, fwd_dst])
    all_d = jnp.concatenate([fwd_d, fwd_d])
    return rebuild_rows(n, m, all_dst, all_src, all_d)
