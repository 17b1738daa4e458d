"""Executable NumPy model of the reference's serial search.

A faithful reimplementation of the Rust reference's query path — fixed-
capacity sorted priority queue (priority_queue.rs:28-199), serial best-first
``closest_nodes`` with probe_depth (lib.rs:175-248), per-layer
``closest_vectors`` (lib.rs:250-277), and the layer-descent driver
``search_layers`` (search.rs:84-140) — used by the recall-parity suite to
compare the batched engine against reference semantics on IDENTICAL graphs
(BASELINE.md's "recall@k parity at equal memory on identical graphs" gate).

Only test-scale performance; everything is plain Python/NumPy on purpose so
it stays a transparent model of the Rust, not a second production engine.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

EMPTY = np.iinfo(np.int32).max


class RefQueue:
    """Fixed-capacity sorted (dist, id) queue (priority_queue.rs)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.ids: List[int] = []
        self.dists: List[float] = []

    def items(self) -> List[Tuple[int, float]]:
        return list(zip(self.ids, self.dists))

    def first(self) -> Optional[Tuple[int, float]]:
        return (self.ids[0], self.dists[0]) if self.ids else None

    def merge_pairs(self, pairs: List[Tuple[int, float]]) -> bool:
        """Best-capacity merge with dedup; returns did_something
        (priority_queue.rs:109-153)."""
        merged = {}
        for i, d in list(zip(self.ids, self.dists)) + [
            (int(i), float(d)) for i, d in pairs
        ]:
            if i == EMPTY:
                continue
            if i not in merged or d < merged[i]:
                merged[i] = d
        ranked = sorted(merged.items(), key=lambda t: (t[1], t[0]))[: self.capacity]
        new_ids = [i for i, _ in ranked]
        new_dists = [d for _, d in ranked]
        changed = new_ids != self.ids
        self.ids, self.dists = new_ids, new_dists
        return changed


def closest_nodes(
    nodes: np.ndarray,  # [N] sorted vector ids
    neighbors: np.ndarray,  # [N, M] node ids, EMPTY-padded
    dist_to: Callable[[int], float],  # vector id -> distance to query
    queue: RefQueue,  # node-id queue, pre-seeded
    probe_depth: int,
) -> None:
    """Serial best-first expansion (lib.rs:175-248)."""
    visit = sorted(queue.items(), key=lambda t: (-t[1], -t[0]))
    visited = set(queue.ids)
    while visit:
        next_node = visit.pop()[0]
        fresh = []
        for nb in neighbors[next_node]:
            nb = int(nb)
            if nb == EMPTY or nb in visited:
                continue
            fresh.append((nb, dist_to(int(nodes[nb]))))
        fresh.sort(key=lambda t: (t[1], t[0]))
        visited.update(n for n, _ in fresh)
        visit.extend((n, d) for n, d in fresh)
        did_something = queue.merge_pairs(fresh)
        if not did_something:
            probe_depth -= 1
            if probe_depth == 0:
                break
        visit.sort(key=lambda t: (-t[1], -t[0]))


def closest_vectors(
    nodes: np.ndarray,
    neighbors: np.ndarray,
    dist_to: Callable[[int], float],
    candidates: RefQueue,  # vector-id queue from the layer above
    candidate_count: int,
    probe_depth: int,
) -> List[Tuple[int, float]]:
    """lib.rs:250-277: vector queue -> node queue -> expand -> vector pairs."""
    node_of = {int(v): i for i, v in enumerate(nodes)}
    queue = RefQueue(candidates.capacity)
    queue.merge_pairs(
        [(node_of[int(v)], d) for v, d in candidates.items() if int(v) in node_of]
    )
    closest_nodes(nodes, neighbors, dist_to, queue, probe_depth)
    return [(int(nodes[n]), d) for n, d in queue.items()][:candidate_count]


def search_layers(
    layers: List[Tuple[np.ndarray, np.ndarray]],  # [(nodes, neighbors)] top→bottom
    dist_to: Callable[[int], float],
    number_of_candidates: int,
    upper_layer_candidate_count: int,
    probe_depth: int,
) -> List[Tuple[int, float]]:
    """search.rs:84-140: descend the stack, merging per-layer results."""
    entry_vector = int(layers[0][0][0])
    candidates = RefQueue(number_of_candidates)
    candidates.merge_pairs([(entry_vector, dist_to(entry_vector))])
    for i, (nodes, neighbors) in enumerate(layers):
        cc = (
            number_of_candidates
            if len(layers) == 1 or i == len(layers) - 1
            else upper_layer_candidate_count
        )
        closest = closest_vectors(
            nodes, neighbors, dist_to, candidates, cc, probe_depth
        )
        candidates.merge_pairs(closest)
    return candidates.items()
