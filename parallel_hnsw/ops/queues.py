"""Masked sorted-array candidate queues.

The reference keeps per-query candidates in a fixed-capacity *sorted array*
ordered by ascending ``(distance, id)`` with ``(!0, f32::MAX)`` in empty slots
(reference: src/priority_queue.rs:28-196).  Insertion is binary search +
shift; ``merge`` reports whether anything changed, which drives search
termination (priority_queue.rs:109-144).

The array form keeps the same invariant — ``(ids, dists)`` arrays
sorted ascending by ``(dist, id)`` with ``(EMPTY_ID, +inf)`` padding — but
implements *batched* insertion as: concatenate, lexicographic sort, adjacent
dedup, truncate.  "Did anything change" becomes an any-change reduction.
All ops work on the last axis and broadcast over arbitrary leading batch dims,
so one call merges thousands of queues at once.

Duplicate suppression matches the reference: the reference's ``insert_at``
walks entries with *exactly equal priority* and refuses to re-insert an id that
is already present at that priority (priority_queue.rs:70-100).  Under a stable
``(dist, id)`` sort equal ``(dist, id)`` pairs are adjacent, so adjacent-dedup
reproduces that semantics (for a fixed query an id always maps to one distance,
so duplicates always carry equal priorities).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from parallel_hnsw.constants import DIST_DTYPE, EMPTY_DIST, EMPTY_ID, ID_DTYPE


def empty_queue(capacity: int, batch_shape: Tuple[int, ...] = ()) -> Tuple[jax.Array, jax.Array]:
    """A queue of ``capacity`` empty slots (reference: PriorityQueue::new)."""
    shape = batch_shape + (capacity,)
    ids = jnp.full(shape, EMPTY_ID, dtype=ID_DTYPE)
    dists = jnp.full(shape, EMPTY_DIST, dtype=DIST_DTYPE)
    return ids, dists


def queue_len(dists: jax.Array) -> jax.Array:
    """Number of live entries (reference: len() = partition_point over MAX,
    priority_queue.rs:56-59)."""
    return jnp.sum(jnp.isfinite(dists), axis=-1)


def sort_queue(ids: jax.Array, dists: jax.Array, *payload: jax.Array):
    """Sort ascending by ``(dist, id)``; payload arrays are permuted along."""
    out = jax.lax.sort((dists, ids) + tuple(payload), dimension=-1, num_keys=2, is_stable=True)
    return (out[1], out[0]) + tuple(out[2:])


def _mark_adjacent_dups(ids: jax.Array, dists: jax.Array, *payload: jax.Array):
    """Empty out later duplicates of an id among adjacent equal entries."""
    prev = jnp.roll(ids, 1, axis=-1)
    first_col = jnp.zeros(ids.shape[:-1] + (1,), dtype=bool)
    dup = jnp.concatenate(
        [first_col, (ids[..., 1:] == prev[..., 1:]) & (ids[..., 1:] != EMPTY_ID)], axis=-1
    )
    ids = jnp.where(dup, EMPTY_ID, ids)
    dists = jnp.where(dup, EMPTY_DIST, dists)
    return (ids, dists) + tuple(payload)


def dedup_sorted(ids: jax.Array, dists: jax.Array, *payload: jax.Array):
    """Dedup a (dist, id)-sorted queue, compacting empties to the tail."""
    marked = _mark_adjacent_dups(ids, dists, *payload)
    return sort_queue(*marked)


def merge_queue(
    ids: jax.Array,
    dists: jax.Array,
    new_ids: jax.Array,
    new_dists: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Merge ``(new_ids, new_dists)`` into sorted queues of fixed capacity.

    Equivalent to the reference's PriorityQueue::merge (priority_queue.rs:109-144):
    entries that land beyond capacity fall off; returns ``changed`` — whether the
    retained contents differ (the reference's ``did_something``).

    Invalid new entries must be masked as ``(EMPTY_ID, +inf)`` by the caller.
    """
    cap = ids.shape[-1]
    all_ids = jnp.concatenate([ids, new_ids], axis=-1)
    all_dists = jnp.concatenate([dists, new_dists], axis=-1)
    s_ids, s_dists = sort_queue(all_ids, all_dists)
    d_ids, d_dists = dedup_sorted(s_ids, s_dists)
    out_ids = d_ids[..., :cap]
    out_dists = d_dists[..., :cap]
    changed = jnp.any(out_ids != ids, axis=-1)
    return out_ids, out_dists, changed


def merge_queue_with_flags(
    ids: jax.Array,
    dists: jax.Array,
    flags: jax.Array,
    new_ids: jax.Array,
    new_dists: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Like :func:`merge_queue` but carries a per-slot payload flag (e.g. the
    "already expanded" bit of beam search).  New entries enter with flag=0.

    The stable sort keeps a pre-existing entry *before* a freshly merged
    duplicate with equal ``(dist, id)``, so dedup retains the existing flag.
    """
    cap = ids.shape[-1]
    zero_flags = jnp.zeros(new_ids.shape, dtype=flags.dtype)
    all_ids = jnp.concatenate([ids, new_ids], axis=-1)
    all_dists = jnp.concatenate([dists, new_dists], axis=-1)
    all_flags = jnp.concatenate([flags, zero_flags], axis=-1)
    s_ids, s_dists, s_flags = sort_queue(all_ids, all_dists, all_flags)
    d_ids, d_dists, d_flags = dedup_sorted(s_ids, s_dists, s_flags)
    out_ids = d_ids[..., :cap]
    out_dists = d_dists[..., :cap]
    out_flags = d_flags[..., :cap]
    changed = jnp.any(out_ids != ids, axis=-1)
    return out_ids, out_dists, out_flags, changed
