from parallel_hnsw.parallel.sharded import (
    ShardedHnsw,
    ShardedQuantizedHnsw,
    default_mesh,
)

__all__ = ["ShardedHnsw", "ShardedQuantizedHnsw", "default_mesh"]
