"""Golden tests for candidate-queue ops, ported from the reference's
priority_queue.rs unit tests (reference: src/priority_queue.rs:225-440)."""

import jax.numpy as jnp
import numpy as np

from parallel_hnsw.constants import EMPTY_DIST, EMPTY_ID
from parallel_hnsw.ops.queues import (
    dedup_sorted,
    empty_queue,
    merge_queue,
    merge_queue_with_flags,
    queue_len,
    sort_queue,
)

E = EMPTY_ID
INF = EMPTY_DIST


def q(ids, dists):
    return jnp.asarray(ids, jnp.int32), jnp.asarray(dists, jnp.float32)


def merge1(ids, dists, new_ids, new_dists):
    i, d = q(ids, dists)
    ni, nd = q(new_ids, new_dists)
    return merge_queue(i, d, ni, nd)


def test_insert_at_beginning():
    # reference: fixed_length_insertion "At beginning" (priority_queue.rs:231-237)
    ids, dists, changed = merge1([0, 3, E], [0.1, 1.2, INF], [4], [0.01])
    np.testing.assert_array_equal(ids, [4, 0, 3])
    np.testing.assert_allclose(dists, [0.01, 0.1, 1.2])
    assert bool(changed)


def test_insert_into_empty():
    ids, dists, changed = merge1([E, E, E], [INF, INF, INF], [4], [0.01])
    np.testing.assert_array_equal(ids, [4, E, E])
    np.testing.assert_allclose(dists, [0.01, INF, INF])
    assert bool(changed)


def test_insert_no_double_count():
    ids, dists, changed = merge1([4, E, E], [0.01, INF, INF], [4], [0.01])
    np.testing.assert_array_equal(ids, [4, E, E])
    assert not bool(changed)


def test_insert_push_off_end():
    ids, dists, changed = merge1([1, 2, 3], [0.1, 0.2, 0.4], [4], [0.3])
    np.testing.assert_array_equal(ids, [1, 2, 4])
    np.testing.assert_allclose(dists, [0.1, 0.2, 0.3])
    assert bool(changed)


def test_insert_past_end():
    ids, dists, changed = merge1([1, 2, 3], [0.1, 0.2, 0.3], [4], [0.4])
    np.testing.assert_array_equal(ids, [1, 2, 3])
    assert not bool(changed)


def test_interleaved_merge():
    # reference: fixed_length_merge (priority_queue.rs:287-300)
    ids, dists, changed = merge1([0, 2, 4], [0.0, 0.2, 0.4], [1, 3, 5], [0.1, 0.3, 0.5])
    np.testing.assert_array_equal(ids, [0, 1, 2])
    np.testing.assert_allclose(dists, [0.0, 0.1, 0.2])
    assert bool(changed)


def test_useless_merge_not_did_something():
    # reference: useless_merge (priority_queue.rs:312-326)
    ids, dists, changed = merge1([0, 3, 5], [0.0, 0.3, 0.5], [6, 7, 8], [0.6, 0.7, 0.8])
    np.testing.assert_array_equal(ids, [0, 3, 5])
    assert not bool(changed)


def test_productive_merge():
    ids, dists, changed = merge1([0, 3, 5], [0.0, 0.3, 0.5], [1, 2, 4], [0.1, 0.2, 0.4])
    np.testing.assert_array_equal(ids, [0, 1, 2])
    np.testing.assert_allclose(dists, [0.0, 0.1, 0.2])
    assert bool(changed)


def test_repeated_merge_dedups_equal_priorities():
    # reference: repeated_merge (priority_queue.rs:344-356)
    ids, dists, changed = merge1([0, 3, 5], [0.0, 0.0, 0.0], [0, 4, 3], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(ids, [0, 3, 4])
    np.testing.assert_allclose(dists, [0.0, 0.0, 0.0])
    assert bool(changed)


def test_merge_with_empty_slots():
    # reference: merge_with_empty (priority_queue.rs:359-371)
    ids, dists, changed = merge1([0, 3, E], [0.0, 1.2, INF], [0, 3, 4], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(ids, [0, 3, 4])
    np.testing.assert_allclose(dists, [0.0, 0.0, 0.0])
    assert bool(changed)


def test_lots_of_zeros():
    # reference: lots_of_zeros (priority_queue.rs:374-439)
    ids, dists, changed = merge1(
        [0] + [E] * 8,
        [0.0] + [INF] * 8,
        [3, 4, 1, 2, 6, 7],
        [0.29289323, 0.4227, 1.0, 1.0, 1.0, 1.0],
    )
    np.testing.assert_array_equal(ids, [0, 3, 4, 1, 2, 6, 7, E, E])
    np.testing.assert_allclose(dists, [0.0, 0.29289323, 0.4227, 1.0, 1.0, 1.0, 1.0, INF, INF])
    assert bool(changed)


def test_queue_len():
    i, d = q([0, 3, E], [0.1, 1.2, INF])
    assert int(queue_len(d)) == 2
    i, d = empty_queue(5)
    assert int(queue_len(d)) == 0


def test_batched_merge():
    ids = jnp.asarray([[0, 3, 5], [0, 2, 4]], jnp.int32)
    dists = jnp.asarray([[0.0, 0.3, 0.5], [0.0, 0.2, 0.4]], jnp.float32)
    new_ids = jnp.asarray([[6, 7, 8], [1, 3, 5]], jnp.int32)
    new_dists = jnp.asarray([[0.6, 0.7, 0.8], [0.1, 0.3, 0.5]], jnp.float32)
    out_ids, out_dists, changed = merge_queue(ids, dists, new_ids, new_dists)
    np.testing.assert_array_equal(out_ids, [[0, 3, 5], [0, 1, 2]])
    np.testing.assert_array_equal(np.asarray(changed), [False, True])


def test_flags_preserved_across_merge():
    ids = jnp.asarray([0, 3, 5], jnp.int32)
    dists = jnp.asarray([0.0, 0.3, 0.5], jnp.float32)
    flags = jnp.asarray([1, 1, 0], jnp.int32)
    # re-merge id 0 (already expanded) plus a fresh id 1
    new_ids = jnp.asarray([0, 1], jnp.int32)
    new_dists = jnp.asarray([0.0, 0.1], jnp.float32)
    out_ids, out_dists, out_flags, changed = merge_queue_with_flags(
        ids, dists, flags, new_ids, new_dists
    )
    np.testing.assert_array_equal(out_ids, [0, 1, 3])
    np.testing.assert_array_equal(out_flags, [1, 0, 1])
    assert bool(changed)


def test_sort_and_dedup():
    i, d = q([5, 1, 5, E], [0.5, 0.1, 0.5, INF])
    si, sd = sort_queue(i, d)
    np.testing.assert_array_equal(si, [1, 5, 5, E])
    di, dd = dedup_sorted(si, sd)
    np.testing.assert_array_equal(di, [1, 5, E, E])


def test_chunked_rebuild_rows_matches_flat(monkeypatch):
    """The folded (chunked) rebuild must reproduce the single-shot rebuild
    exactly — including cross-chunk duplicate (dst, src) edges with skewed
    fp distances (dedup keeps the min)."""
    import numpy as np

    from parallel_hnsw.ops import segment

    rng = np.random.default_rng(7)
    n, m, e = 50, 4, 4000
    dst = rng.integers(0, n, size=e).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    dist = rng.uniform(0, 1, size=e).astype(np.float32)
    # inject duplicates with slightly different distances across the array
    dst[e // 2 :] = dst[: e // 2]
    src[e // 2 :] = src[: e // 2]
    dist[e // 2 :] = dist[: e // 2] + rng.uniform(0, 1e-3, size=e // 2).astype(
        np.float32
    )

    args = (jnp.asarray(dst), jnp.asarray(src), jnp.asarray(dist))
    flat_i, flat_d = segment._rebuild_rows_flat(n, m, *args)
    monkeypatch.setattr(segment, "MAX_SORT_ELEMENTS", 512)
    fold_i, fold_d = segment.rebuild_rows(n, m, *args)
    np.testing.assert_array_equal(np.asarray(fold_i), np.asarray(flat_i))
    np.testing.assert_allclose(np.asarray(fold_d), np.asarray(flat_d))
