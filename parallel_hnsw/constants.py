"""Core id/sentinel conventions for the batch-parallel HNSW framework.

The reference (parallel-hnsw) uses ``usize`` ids with ``!0`` (usize::MAX) as the
universal "empty" sentinel (reference: src/types.rs:3-38) and ``f32::MAX``
as the empty priority (reference: src/priority_queue.rs:162-167).

On the accelerator everything is a dense int32/float32 array, so:

* ids (both vector ids and node ids) are ``int32``
* the empty id sentinel is ``EMPTY_ID = 2**31 - 1`` (int32 max) so that empty
  slots sort *after* every real id under an ascending ``(distance, id)`` sort
* the empty distance sentinel is ``+inf`` so empty slots sort last
"""

from __future__ import annotations

import jax.numpy as jnp

# int32 max: sorts after every valid id; analogous to the reference's `!0`.
EMPTY_ID: int = 2**31 - 1

# f32 +inf: sorts after every valid distance; the reference uses f32::MAX.
EMPTY_DIST: float = float("inf")

ID_DTYPE = jnp.int32
DIST_DTYPE = jnp.float32

# Epsilon used by self-match tests (reference: src/search.rs:173-187).
MATCH_EPSILON: float = 1e-5

# Cap on any transient [rows, cols] f32 distance matrix a blocked scan may
# materialize in device memory.  A cap, not a measured optimum: it was sized
# for a 16 GB device and has not been re-derived on the GPU (not measured on
# the card).
MATRIX_BYTE_BUDGET: int = 512 << 20
