"""Graph data model: dense device arrays instead of pointer-chasing.

Reference layout (reference: src/lib.rs:85-159): a layer is a sorted
``nodes: Vec<VectorId>`` plus a flat ``neighbors`` slab of
``node_count x neighborhood_size`` NodeIds, ``!0``-padded per row.

Array layout: per layer

* ``nodes  [N]    int32`` — sorted vector ids (ascending)
* ``neighbors [N, M] int32`` — node-id rows, ``EMPTY_ID``-padded

plus a *vector source* — the storage half of the reference's ``Comparator``
trait (src/lib.rs:53-74).  A source is a pytree that can gather feature
vectors for ids; the metric half lives in :mod:`parallel_hnsw.ops.distance`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Union

import jax
import jax.numpy as jnp

from parallel_hnsw.constants import EMPTY_ID, ID_DTYPE


class Layer(NamedTuple):
    """One graph level. ``neighbors.shape == (len(nodes), M)``."""

    nodes: jax.Array  # [N] int32, sorted vector ids
    neighbors: jax.Array  # [N, M] int32 node ids, EMPTY_ID-padded

    @property
    def node_count(self) -> int:
        return self.nodes.shape[0]

    @property
    def neighborhood_size(self) -> int:
        return self.neighbors.shape[1]


class DenseSource(NamedTuple):
    """All vectors resident in HBM as one ``[V, D]`` array."""

    vectors: jax.Array  # [V, D] float

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def count(self) -> int:
        return self.vectors.shape[0]


class PqSource(NamedTuple):
    """PQ-compressed vectors: per-id codes plus a codebook.

    The codebook is either shared across subspaces, ``[K, Dsub]`` (the
    reference's design — one centroid HNSW serves every subspace,
    src/pq.rs:29-82), or per-subspace ``[Q, K, Dsub]`` (classic PQ).
    ``get`` reconstructs full vectors by codebook gather — the array form
    of the reference's reconstructing quantized comparator (src/pq.rs:585-600).
    """

    codes: jax.Array  # [V, Q] integer centroid ids per subspace (uint16 for
    # K <= 65536 — the reference's u16 codes, src/pq.rs:20 — or int32)
    codebook: jax.Array  # [K, Dsub] shared or [Q, K, Dsub] per-subspace

    @property
    def dim(self) -> int:
        if self.codebook.ndim == 2:
            return self.codes.shape[1] * self.codebook.shape[1]
        return self.codebook.shape[0] * self.codebook.shape[2]

    @property
    def count(self) -> int:
        return self.codes.shape[0]


class MemmapSource(NamedTuple):
    """Host-resident dense vectors (``np.memmap`` or ``np.ndarray``) that are
    NEVER materialized on device as a whole.

    The out-of-core ingestion seam (reference: ``VectorSelector`` /
    ``VectorStore``, src/pq.rs:133-142 — the reference streams chunks from an
    arbitrary store at src/pq.rs:325-334).  Consumers move data host→device
    in bounded chunks: :meth:`chunks` for quantization / scans,
    :func:`source_get` (host gather) for rerank row fetches.  Must not be
    passed into jitted code — it is storage, not a compute operand.
    """

    vectors: "np.memmap | np.ndarray"  # host [V, D] float32

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def count(self) -> int:
        return self.vectors.shape[0]

    def chunks(self, chunk_size: int = 100_000, ids=None):
        """Yield host f32 chunks (optionally of a row subset) for streamed
        host→device ingestion.  ``ids`` may be any integer array; rows are
        fetched in ``chunk_size`` batches so peak host memory stays bounded
        by one chunk regardless of corpus size."""
        import numpy as np

        if ids is None:
            for start in range(0, self.count, chunk_size):
                yield np.asarray(self.vectors[start : start + chunk_size])
        else:
            ids = np.asarray(ids)
            for start in range(0, len(ids), chunk_size):
                yield np.asarray(self.vectors[ids[start : start + chunk_size]])


def open_memmap_source(path: str, dim: int, dtype="float32") -> MemmapSource:
    """Open a raw row-major ``[*, dim]`` file as a MemmapSource."""
    import numpy as np

    mm = np.memmap(path, dtype=dtype, mode="r")
    count = mm.shape[0] // dim
    return MemmapSource(vectors=mm.reshape(count, dim))


def is_host_source(source) -> bool:
    """True when the source's storage lives on host (out-of-core path)."""
    return isinstance(source, MemmapSource)


Source = Union[DenseSource, PqSource, MemmapSource]


@functools.singledispatch
def source_get(source, ids: jax.Array) -> jax.Array:
    """Gather feature vectors for ``ids`` (any shape) -> ``[*ids.shape, D]``.

    Ids must be pre-clipped/masked by the caller; EMPTY_ID gathers garbage
    (callers mask distances of invalid slots to +inf instead).

    The extensibility seam matching the reference's user-implementable
    ``Comparator`` trait (src/lib.rs:53-74): register a custom storage with
    ``@source_get.register`` on a pytree type exposing ``dim``/``count``.
    """
    raise TypeError(f"unknown source type {type(source)}")


@source_get.register
def _(source: DenseSource, ids: jax.Array) -> jax.Array:
    safe = jnp.clip(ids, 0, source.vectors.shape[0] - 1)
    return jnp.take(source.vectors, safe, axis=0)


@source_get.register
def _(source: MemmapSource, ids: jax.Array) -> jax.Array:
    """Host gather → one bounded device transfer.  Valid OUTSIDE jit only
    (storage lives on host); jitted callers must gather via a device-resident
    source instead."""
    import numpy as np

    idx = np.clip(np.asarray(ids), 0, source.count - 1)
    flat = source.vectors[idx.ravel()]
    return jnp.asarray(flat.reshape(idx.shape + (source.dim,)), jnp.float32)


@source_get.register
def _(source: PqSource, ids: jax.Array) -> jax.Array:
    safe = jnp.clip(ids, 0, source.codes.shape[0] - 1)
    codes = jnp.take(source.codes, safe, axis=0).astype(jnp.int32)  # [*, Q]
    return reconstruct(source.codebook, codes)


def reconstruct(codebook: jax.Array, codes: jax.Array) -> jax.Array:
    """Decode PQ codes ``[*, Q]`` -> vectors ``[*, Q*Dsub]`` by centroid gather
    (reference: Quantizer::reconstruct, src/pq.rs:73-81).  Accepts a shared
    ``[K, Dsub]`` or per-subspace ``[Q, K, Dsub]`` codebook."""
    nsub = codes.shape[-1]
    codes = codes.astype(jnp.int32)
    if codebook.ndim == 2:
        k, dsub = codebook.shape
        safe = jnp.clip(codes, 0, k - 1)
        sub = jnp.take(codebook, safe, axis=0)  # [*, Q, Dsub]
        return sub.reshape(codes.shape[:-1] + (nsub * dsub,))
    nsub_b, k, dsub = codebook.shape
    assert nsub_b == nsub
    safe = jnp.clip(codes, 0, k - 1)
    flat = safe.reshape(-1, nsub)  # [B, Q]
    q_idx = jnp.arange(nsub)[None, :]  # [1, Q]
    sub = codebook[q_idx, flat]  # [B, Q, Dsub]
    return sub.reshape(codes.shape[:-1] + (nsub * dsub,))


def source_effective_width(source) -> int:
    """Values per vector that a gather of ``source`` rows materializes (the
    f32 width used for block-size budgeting): ``nsub * dsub`` for a PQ
    reconstruction, ``dim`` for dense rows."""
    if isinstance(source, PqSource):
        if source.codebook.ndim == 2:
            return source.codes.shape[1] * source.codebook.shape[1]
        nsub, _, dsub = source.codebook.shape
        return nsub * dsub
    return source.dim


def materialize_source(source, block: int = 16384) -> jax.Array:
    """Densify a source to f32 ``[N, D]`` in row blocks (bounds the padded
    reconstruction gather for PQ sources).  A DenseSource is returned as-is —
    no copy (a full-corpus identity gather doubled HBM at 10M x 96)."""
    if isinstance(source, DenseSource):
        return source.vectors
    return gather_features(source, jnp.arange(source.count, dtype=ID_DTYPE), block)


def gather_features(source, ids: jax.Array, block: int = 8192) -> jax.Array:
    """source_get in row blocks for 1-D id arrays — bounds the
    reconstruction gather of PQ sources ([block*nsub, dsub])."""
    n = ids.shape[0]
    if n <= block:
        return source_get(source, ids)
    outs = []
    for start in range(0, n, block):
        outs.append(source_get(source, ids[start : start + block]))
    return jnp.concatenate(outs)


@jax.jit
def vec_to_node(nodes: jax.Array, vids: jax.Array) -> jax.Array:
    """Map vector ids to node ids via binary search on the sorted ``nodes``.

    Reference: ``Layer::get_node`` (src/lib.rs:129-131).  Unknown / EMPTY ids
    map to EMPTY_ID.
    """
    n = nodes.shape[0]
    pos = jnp.searchsorted(nodes, vids)
    safe = jnp.clip(pos, 0, n - 1)
    found = (pos < n) & (jnp.take(nodes, safe) == vids) & (vids != EMPTY_ID)
    return jnp.where(found, pos, EMPTY_ID).astype(ID_DTYPE)


@jax.jit
def node_to_vec(nodes: jax.Array, nids: jax.Array) -> jax.Array:
    """Map node ids back to vector ids (reference: Layer::get_vector)."""
    n = nodes.shape[0]
    safe = jnp.clip(nids, 0, n - 1)
    out = jnp.take(nodes, safe)
    return jnp.where(nids == EMPTY_ID, EMPTY_ID, out).astype(ID_DTYPE)


def node_bucket(n: int) -> int:
    """Round a node count up to a shape bucket (1x / 1.5x powers of two) so
    layers whose sizes drift (promotions, different corpora) reuse compiled
    programs.  Padding rows hold EMPTY nodes with all-EMPTY neighbor rows —
    unreachable by construction, so search treats them as inert."""
    if n <= 16:
        return 16
    p = 16
    while True:
        for b in (p, p + p // 2):
            if n <= b:
                return b
        p *= 2


def pad_layer(layer: Layer, bucket: int | None = None) -> Layer:
    """Pad a layer's arrays up to a node bucket with EMPTY sentinels."""
    n, m = layer.neighbors.shape
    b = bucket if bucket is not None else node_bucket(n)
    if b == n:
        return layer
    pad = b - n
    nodes = jnp.concatenate([layer.nodes, jnp.full((pad,), EMPTY_ID, ID_DTYPE)])
    neighbors = jnp.concatenate(
        [layer.neighbors, jnp.full((pad, m), EMPTY_ID, ID_DTYPE)]
    )
    return Layer(nodes=nodes, neighbors=neighbors)


def valid_node_count(nodes) -> int:
    """Number of real (non-padding) nodes in a possibly padded nodes array."""
    import numpy as np

    arr = np.asarray(nodes)
    return int(np.searchsorted(arr, EMPTY_ID))


def make_layer(nodes, neighbors) -> Layer:
    return Layer(
        nodes=jnp.asarray(nodes, ID_DTYPE), neighbors=jnp.asarray(neighbors, ID_DTYPE)
    )


def assert_layer_invariants(layers: Sequence[Layer]) -> None:
    """Host-side invariant check (reference: src/search.rs:142-171): layer
    nodes strictly ascending, and every node present in the layer below."""
    import numpy as np

    for i in range(len(layers)):
        nodes = np.asarray(layers[i].nodes)
        if not np.all(np.diff(nodes) > 0):
            raise AssertionError(f"layer {i} nodes not strictly ascending")
        if i + 1 < len(layers):
            below = np.asarray(layers[i + 1].nodes)
            missing = np.setdiff1d(nodes, below)
            if missing.size:
                raise AssertionError(
                    f"layer {i} nodes missing from layer {i+1}: {missing[:10]}"
                )
