"""Index model families.

The reference's "model zoo" is its index types: the plain layered graph
(``Hnsw``), the two-level product-quantized index (``QuantizedHnsw``), and —
not in the reference — the mesh-sharded corpus index (``ShardedHnsw``).
"""

from parallel_hnsw.index import Hnsw
from parallel_hnsw.pq import HnswQuantizer, QuantizedHnsw
from parallel_hnsw.parallel.sharded import ShardedHnsw

__all__ = ["Hnsw", "HnswQuantizer", "QuantizedHnsw", "ShardedHnsw"]
