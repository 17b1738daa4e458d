from parallel_hnsw.ops.queues import (
    empty_queue,
    queue_len,
    sort_queue,
    dedup_sorted,
    merge_queue,
    merge_queue_with_flags,
)
from parallel_hnsw.ops.distance import (
    Metric,
    pairwise_distance,
    batched_distance,
    distance_one,
)

__all__ = [
    "empty_queue",
    "queue_len",
    "sort_queue",
    "dedup_sorted",
    "merge_queue",
    "merge_queue_with_flags",
    "Metric",
    "pairwise_distance",
    "batched_distance",
    "distance_one",
]
