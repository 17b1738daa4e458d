"""Product quantization: two-level index with exact rerank.

Reference (reference: src/pq.rs): an ``HnswQuantizer`` is an HNSW over a
*shared* codebook of sub-vector centroids (src/pq.rs:29-82); ``quantize`` runs
one centroid-graph search per sub-vector (src/pq.rs:61-71); the
``QuantizedHnsw`` builds a second HNSW over the codes where every comparison
reconstructs both vectors from centroids (src/pq.rs:585-600), and ``search``
quantizes the query, searches the code graph, then exact-reranks with the
full-precision vectors (src/pq.rs:346-364).  Centroids come from random
sub-vector sampling (src/pq.rs:261-285) with a latent k-means path
(src/pq.rs:215-259).

As arrays: quantization is a batched search (or exact blocked argmin), k-means
is a jitted Lloyd's loop of matrix products, reconstruction is a codebook
gather, and the
ADC path (the reference's never-implemented ``PartialDistance``,
src/pq.rs:24-27) is realized as a per-query ``[nsub, K]`` lookup table whose
row-sums score whole candidate blocks.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parallel_hnsw.constants import EMPTY_ID, ID_DTYPE
from parallel_hnsw.graph import (
    DenseSource,
    MemmapSource,
    PqSource,
    reconstruct,
)
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric, pairwise_distance
from parallel_hnsw.params import (
    BuildParams,
    OptimizationParams,
    PqBuildParams,
    SearchParams,
)
from parallel_hnsw.progress import ProgressMonitor, ensure_monitor


# ---------------------------------------------------------------------------
# Centroid selection


def _hash_sort_dedup(subs: jax.Array, key: jax.Array):
    """Sort rows by a gaussian-projection hash; mark adjacent duplicates.

    ``np.unique(axis=0)`` (a void-view lexsort) takes minutes on one host
    core at the 65,535-centroid config's 1.5M sub-vectors; sorting one
    random projection on the device and dropping adjacent equal rows takes
    one sort.  Identical rows hash identically so they sort
    adjacent; a hash tie between *different* rows (probability ~0 for a
    gaussian projection over f32) would at worst retain a duplicate, which
    the reference's sampling tolerates anyway.  Returns ``(sorted_rows,
    dup_mask)`` with ``dup_mask[i]`` true iff row i equals row i-1."""
    h = subs @ jax.random.normal(key, (subs.shape[1],), jnp.float32)
    order = jnp.argsort(h)
    s = jnp.take(subs, order, axis=0)
    hs = jnp.take(h, order)
    dup = jnp.concatenate(
        [
            jnp.zeros((1,), bool),
            (hs[1:] == hs[:-1]) & jnp.all(s[1:] == s[:-1], axis=-1),
        ]
    )
    return s, dup


def unique_rows_device(subs: jax.Array, seed: int = 0) -> np.ndarray:
    """Row dedup on device (see ``_hash_sort_dedup``); rows return sorted
    by their hash, which is deterministic for a fixed seed."""
    s, dup = _hash_sort_dedup(jnp.asarray(subs), jax.random.PRNGKey(seed))
    return np.asarray(s)[~np.asarray(dup)]


def random_centroids(
    vectors: jax.Array, n_centroids: int, dsub: int, seed: int = 0
) -> np.ndarray:
    """Sample vectors, split into sub-vectors, dedup, shuffle, truncate
    (reference: random_centroids, src/pq.rs:261-285).  Returns ``[K, dsub]``.

    Everything runs on device (a host path would read back the corpus for
    ``np.unique(axis=0)`` and a shuffle); only the final ``[K, dsub]`` slab
    is read back.  Dedup is ``_hash_sort_dedup``.

    Host arrays (``np.memmap`` out-of-core corpora) are sampled host-side:
    only the ``[sample, dim]`` slab crosses to the device, never the corpus."""
    count, dim = vectors.shape
    assert dim % dsub == 0
    rng = np.random.default_rng(seed)
    sel = rng.permutation(count)[: min(n_centroids, count)]
    if isinstance(vectors, (np.ndarray, np.memmap)):
        sel.sort()  # sequential-ish memmap reads
        subs = jnp.asarray(np.asarray(vectors[sel]), jnp.float32).reshape(-1, dsub)
    else:
        vectors = jnp.asarray(vectors)
        subs = jnp.take(vectors, jnp.asarray(sel, jnp.int32), axis=0).reshape(
            -1, dsub
        )
    key = jax.random.PRNGKey(seed)
    s, dup = _hash_sort_dedup(subs, key)
    # random shuffle with duplicates sunk to the tail, then truncate: the
    # first min(K, n_unique) rows are unique and uniformly ordered
    rnd = jax.random.uniform(jax.random.fold_in(key, 1), (s.shape[0],))
    perm = jnp.argsort(dup.astype(jnp.float32) + rnd)
    n_unique = int(jnp.sum(~dup))
    k = min(n_centroids, n_unique)
    out = jnp.take(s, perm[:k], axis=0)
    return np.asarray(out, np.float32)


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def _kmeans_jit(data: jax.Array, init: jax.Array, k: int, iters: int):
    def step(carry, _):
        centroids = carry
        d = pairwise_distance(data, centroids, Metric.SQUARED_EUCLIDEAN)
        assign = jnp.argmin(d, axis=-1)
        one_hot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
        sums = one_hot.T @ data
        counts = one_hot.sum(axis=0)[:, None]
        new_centroids = jnp.where(counts > 0, sums / jnp.maximum(counts, 1), centroids)
        return new_centroids, None

    out, _ = jax.lax.scan(step, init, None, length=iters)
    return out


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(1, 2))
def _kmeans_accumulate(data, sums, counts, assign, k: int):
    sums = sums + jax.ops.segment_sum(data, assign, num_segments=k)
    counts = counts + jax.ops.segment_sum(
        jnp.ones((data.shape[0],), jnp.float32), assign, num_segments=k
    )
    return sums, counts


def _kmeans_big(subs: jax.Array, init: jax.Array, k: int, iters: int,
                block: int = 1 << 21) -> jax.Array:
    """Lloyd's k-means at large K without the ``[N, K]`` distance matrix:
    assignment via the fused binned-scan argmin (``quantize_binned`` — exact
    rerank of per-class survivors), update via segment sums.  Makes
    K=65,535 trainable (the ``[2M, 65535]`` f32 matrix the plain path would
    materialize is 512 GB)."""
    centroids = jnp.asarray(init, jnp.float32)
    for _ in range(iters):
        sums = jnp.zeros((k, subs.shape[1]), jnp.float32)
        counts = jnp.zeros((k,), jnp.float32)
        for start in range(0, subs.shape[0], block):
            chunk = subs[start : start + block]
            assign = quantize_binned(
                chunk, centroids, Metric.SQUARED_EUCLIDEAN, block=block
            )
            sums, counts = _kmeans_accumulate(chunk, sums, counts, assign, k)
        centroids = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts, 1)[:, None], centroids
        )
    return centroids


def kmeans_centroids(
    vectors: jax.Array,
    n_centroids: int,
    dsub: int,
    iters: int = 5,
    seed: int = 42,
    sample: Optional[int] = None,
) -> np.ndarray:
    """Lloyd's k-means over sub-vectors (the reference's latent
    linfa path: 1 run, <=5 iterations, seed 42; src/pq.rs:215-259).

    Above a ``[N, K]`` assignment-matrix budget the plain jitted loop is
    swapped for the blocked binned-argmin + segment-sum formulation
    (``_kmeans_big``) — K=65,535 over millions of sub-vectors trains in
    minutes instead of needing a 100s-of-GB intermediate."""
    on_device = not isinstance(vectors, (np.ndarray, np.memmap))
    # memmap stays on disk / device arrays stay on device; reshape is a view
    subs = vectors.reshape(-1, dsub) if on_device else vectors.reshape(-1, dsub)
    if sample is not None and sample < len(subs):
        rng = np.random.default_rng(seed)
        if len(subs) > 50_000_000:
            # out-of-core scale: a full permutation array would itself be
            # tens of GB; sample with replacement instead (collision odds
            # are negligible at these ratios)
            sel = np.sort(rng.integers(0, len(subs), sample))
        else:
            sel = rng.permutation(len(subs))[:sample]
        if on_device:
            subs = jnp.take(subs, jnp.asarray(sel), axis=0)
        else:
            subs = np.asarray(subs[sel])
    k = min(n_centroids, len(subs))
    rng = np.random.default_rng(seed)
    if len(subs) > 50_000_000:
        isel = np.sort(rng.integers(0, len(subs), k * 4))[:: 4][:k]
    else:
        isel = rng.permutation(len(subs))[:k]
    init = jnp.take(subs, jnp.asarray(isel), axis=0) if on_device else subs[isel]
    if len(subs) * k > (1 << 31):  # [N, K] f32 would exceed ~8 GB
        out = _kmeans_big(jnp.asarray(subs), jnp.asarray(init), k, iters)
    else:
        out = _kmeans_jit(jnp.asarray(subs), jnp.asarray(init), k, iters)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Quantizer


class HnswQuantizer:
    """HNSW over a shared sub-vector codebook (reference: src/pq.rs:29-82)."""

    def __init__(self, centroid_hnsw: Hnsw, nsub: int, pq_params: PqBuildParams):
        self.hnsw = centroid_hnsw
        self.nsub = nsub
        self.pq_params = pq_params

    @property
    def centroids(self) -> jax.Array:
        return self.hnsw.source.vectors  # [K, dsub]

    @property
    def dsub(self) -> int:
        return int(self.centroids.shape[1])

    def quantize(
        self, vecs: jax.Array, exact: bool = False, fast: bool = False
    ) -> jax.Array:
        """``[B, SIZE] -> [B, nsub] int32`` codes.  Graph-search per sub-vector
        like the reference (src/pq.rs:61-71), exact blocked argmin
        (``exact``), or the fused binned-scan argmin (``fast``) — the
        bulk-quantization path for huge corpora: the exact scan materializes
        a ``[block, K]`` distance matrix per block (bound by writing it to
        device memory), while the binned scan reduces each tile to
        per-class minima before anything is written, and an
        exact rerank of the top candidates restores the true argmin except
        for vanishing double-collision cases."""
        b = vecs.shape[0]
        subs = vecs.reshape(b * self.nsub, self.dsub)
        if fast:
            codes = quantize_binned(subs, self.centroids, self.hnsw.metric)
        elif exact:
            from parallel_hnsw.analysis import blocked_topk_pairwise

            ids, _ = blocked_topk_pairwise(
                subs, self.centroids, self.hnsw.metric, 1, row_block=8192
            )
            codes = ids[:, 0]
        else:
            sp = self.pq_params.quantized_search
            ids, _ = self.hnsw.search(subs, sp, query_block=65536)
            codes = ids[:, 0]
        return codes.reshape(b, self.nsub).astype(ID_DTYPE)

    def reconstruct(self, codes: jax.Array) -> jax.Array:
        """``[B, nsub] -> [B, SIZE]`` (reference: src/pq.rs:73-81)."""
        return reconstruct(self.centroids, codes)


@functools.partial(jax.jit, static_argnames=("metric", "kk"))
def _quantize_binned_block(subs, centroids, metric: Metric, kk: int):
    from parallel_hnsw.ops.distance import batched_distance
    from parallel_hnsw.ops.pallas_scan import binned_scan

    bd, bc = binned_scan(subs, centroids, metric)
    _, pos = jax.lax.approx_min_k(bd, kk)
    cand = jnp.take_along_axis(bc, pos, axis=-1)  # [B, kk] centroid ids
    cand_feats = jnp.take(centroids, cand, axis=0)  # [B, kk, dsub]
    d = batched_distance(subs, cand_feats, metric)  # exact rerank
    best = jnp.argmin(d, axis=-1)
    return jnp.take_along_axis(cand, best[:, None], axis=-1)[:, 0]


def quantize_binned(
    subs: jax.Array,
    centroids: jax.Array,
    metric: Metric,
    block: int = 1 << 18,
    kk: int = 8,
) -> jax.Array:
    """Near-exact sub-vector argmin via the fused binned-scan kernel + exact
    rerank of the per-class survivors (see HnswQuantizer.quantize)."""
    kk = min(kk, centroids.shape[0])
    outs = []
    for start in range(0, subs.shape[0], block):
        outs.append(
            _quantize_binned_block(
                subs[start : start + block], centroids, Metric(metric), kk
            )
        )
    return jnp.concatenate(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Per-subspace quantizer — classic PQ (nsub independent codebooks)


def per_subspace_centroids(
    vectors,
    n_centroids: int,
    dsub: int,
    seed: int = 0,
    use_kmeans: bool = True,
    iters: int = 5,
    sample: Optional[int] = None,
) -> np.ndarray:
    """Train one ``[K, dsub]`` codebook per subspace -> ``[nsub, K, dsub]``.

    The reference trains a single SHARED codebook over all sub-vectors
    (src/pq.rs:261-285) — cheap, but every subspace competes for the same K
    cells.  Classic product quantization gives each subspace its own
    codebook: nsub-fold more effective codebook capacity at equal K and
    identical code bytes.  Subspaces with fewer than K unique rows pad by
    tiling (harmless duplicates, as the reference's sampling tolerates)."""
    dim = vectors.shape[1]
    assert dim % dsub == 0
    nsub = dim // dsub
    books = np.empty((nsub, n_centroids, dsub), np.float32)
    for j in range(nsub):
        col = vectors[:, j * dsub : (j + 1) * dsub]
        if use_kmeans:
            cb = kmeans_centroids(
                col, n_centroids, dsub, iters=iters, seed=seed + j, sample=sample
            )
        else:
            cb = random_centroids(col, n_centroids, dsub, seed=seed + j)
        if len(cb) < n_centroids:  # fewer unique rows than K: tile
            reps = -(-n_centroids // len(cb))
            cb = np.tile(cb, (reps, 1))[:n_centroids]
        books[j] = cb
    return books


class SubspaceQuantizer:
    """Per-subspace PQ quantizer: ``codebooks [nsub, K, dsub]``.

    The array counterpart of the reference's ``Quantizer`` trait
    (src/pq.rs:15-27) for the classic-PQ layout the reference never ships
    (its HnswQuantizer shares one codebook across subspaces,
    src/pq.rs:29-82).  Quantization is an exact (or binned) argmin per
    subspace — no centroid graph is needed because each subspace's K
    centroids scan in one blocked pass."""

    def __init__(self, codebooks: jax.Array, metric: Metric, pq_params: PqBuildParams):
        self.codebooks = jnp.asarray(codebooks, jnp.float32)  # [nsub, K, dsub]
        self.metric = Metric(metric)
        self.pq_params = pq_params

    @property
    def nsub(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def dsub(self) -> int:
        return int(self.codebooks.shape[2])

    @property
    def n_centroids(self) -> int:
        return int(self.codebooks.shape[1])

    @property
    def centroids(self) -> jax.Array:
        return self.codebooks

    def quantize(
        self, vecs: jax.Array, exact: bool = False, fast: bool = False
    ) -> jax.Array:
        """``[B, SIZE] -> [B, nsub] int32`` codes, each subspace against its
        own codebook.  ``fast`` uses the fused binned-scan argmin per
        subspace (the bulk path at K=65,535); otherwise an exact blocked
        argmin (``exact`` is accepted for signature parity — both
        non-``fast`` paths are exact here, there is no graph tier).

        Assignment always minimizes SQUARED_EUCLIDEAN sub-vector error —
        the reconstruction-error objective — regardless of the index
        metric: a scale-invariant metric (cosine) on a sub-vector would
        pick arbitrarily mis-scaled centroids, and minimizing L2
        reconstruction error is what minimizes distance distortion for
        every supported metric."""
        del exact  # both non-fast paths are the exact blocked argmin
        b = vecs.shape[0]
        am = Metric.SQUARED_EUCLIDEAN
        cols = []
        for j in range(self.nsub):
            sub = vecs[:, j * self.dsub : (j + 1) * self.dsub]
            cb = self.codebooks[j]
            if fast and self.n_centroids >= 4096:
                c = quantize_binned(sub, cb, am)
            else:
                from parallel_hnsw.analysis import blocked_topk_pairwise

                ids, _ = blocked_topk_pairwise(sub, cb, am, 1, row_block=8192)
                c = ids[:, 0]
            cols.append(c)
        return jnp.stack(cols, axis=1).reshape(b, self.nsub).astype(ID_DTYPE)

    def reconstruct(self, codes: jax.Array) -> jax.Array:
        """``[B, nsub] -> [B, SIZE]`` via the per-subspace codebook gather."""
        return reconstruct(self.codebooks, codes)


# ---------------------------------------------------------------------------
# ADC lookup tables — the reference's PartialDistance made real


def adc_lut(queries: jax.Array, codebook: jax.Array, metric: Metric) -> jax.Array:
    """Per-query partial-distance tables ``[Q, nsub, K]``.

    For dot-family metrics the partial is the negated sub-dot; for euclidean
    the partial is the squared sub-distance.  :func:`adc_finish` maps summed
    partials back to the metric's distance.
    """
    metric = Metric(metric)
    q, size = queries.shape
    if codebook.ndim == 2:
        k, dsub = codebook.shape
        nsub = size // dsub
        subs = queries.reshape(q * nsub, dsub)
        if metric in (Metric.COSINE, Metric.NORMALIZED_COSINE, Metric.DOT):
            lut = -jax.lax.dot_general(
                subs, codebook, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            lut = pairwise_distance(subs, codebook, Metric.SQUARED_EUCLIDEAN)
        return lut.reshape(q, nsub, k)
    # per-subspace codebook [nsub, K, dsub]
    nsub, k, dsub = codebook.shape
    subs = queries.reshape(q, nsub, dsub)
    if metric in (Metric.COSINE, Metric.NORMALIZED_COSINE, Metric.DOT):
        return -jnp.einsum(
            "qnd,nkd->qnk", subs, codebook,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    diff = subs[:, :, None, :] - codebook[None]
    return jnp.sum(diff * diff, axis=-1)


def adc_finish(partial_sums: jax.Array, metric: Metric) -> jax.Array:
    metric = Metric(metric)
    if metric is Metric.COSINE:
        return 1.0 + partial_sums
    if metric is Metric.NORMALIZED_COSINE:
        return (1.0 + partial_sums) / 2.0
    if metric is Metric.DOT:
        return partial_sums
    if metric is Metric.SQUARED_EUCLIDEAN:
        return partial_sums
    return jnp.sqrt(jnp.maximum(partial_sums, 0.0))


@functools.partial(jax.jit, static_argnames=("metric",))
def adc_scan(lut: jax.Array, codes: jax.Array, metric: Metric) -> jax.Array:
    """Score all stored codes against per-query LUTs: ``[Q, nsub, K] x
    [N, nsub] -> [Q, N]`` via gather + subspace sum on the VPU."""
    codes = codes.astype(jnp.int32)
    # lut[q, i, codes[n, i]] summed over i
    gathered = jnp.take_along_axis(
        lut[:, None, :, :],  # [Q, 1, nsub, K]
        codes[None, :, :, None],  # [1, N, nsub, 1]
        axis=-1,
    )[..., 0]  # [Q, N, nsub]
    return adc_finish(gathered.sum(-1), metric)


# ---------------------------------------------------------------------------
# QuantizedHnsw


class QuantizedHnsw:
    """Two-level PQ index (reference: QuantizedHnsw, src/pq.rs:120-411)."""

    def __init__(
        self,
        quantizer: HnswQuantizer,
        hnsw: Hnsw,
        full_source: DenseSource,
    ):
        self.quantizer = quantizer
        self.hnsw = hnsw  # graph over PqSource codes
        self.full_source = full_source

    # constructor (reference: QuantizedHnsw::new, src/pq.rs:287-344)
    #
    # ``full_source`` may be a DenseSource (HBM-resident) or a MemmapSource
    # (out-of-core): centroid sampling, the streamed chunk quantization below,
    # and the exact rerank all read host chunks/rows without ever
    # materializing the f32 corpus on device (the reference's
    # VectorSelector/VectorStore streaming seam, src/pq.rs:133-142,325-334).
    @classmethod
    def new(
        cls,
        number_of_centroids: int,
        full_source: "DenseSource | MemmapSource",
        dsub: int,
        metric: Metric,
        pqp: Optional[PqBuildParams] = None,
        seed: int = 0,
        use_kmeans: bool = False,
        exact_quantize: bool = False,
        fast_quantize: bool = False,
        chunk_size: int = 100_000,
        code_dtype=None,
        per_subspace: bool = False,
        kmeans_sample: Optional[int] = None,
        progress: Optional[ProgressMonitor] = None,
        verbose: bool = False,
        improve: bool = True,
    ) -> "QuantizedHnsw":
        pqp = pqp or PqBuildParams()
        monitor = ensure_monitor(progress)
        monitor.update({"type": "pq"})

        dim = full_source.dim
        assert dim % dsub == 0
        nsub = dim // dsub

        from parallel_hnsw.utils.trace import TRACER

        if per_subspace:
            # classic PQ: one codebook per subspace (nsub-fold more
            # effective capacity at equal K and identical code bytes); no
            # centroid graph — quantization is a per-subspace argmin
            with TRACER.span("pq_subspace_centroids", n=number_of_centroids):
                books = per_subspace_centroids(
                    full_source.vectors, number_of_centroids, dsub, seed=seed,
                    use_kmeans=use_kmeans, sample=kmeans_sample,
                )
            monitor.alive()
            quantizer = SubspaceQuantizer(books, metric, pqp)
            centroids = books
        else:
            with TRACER.span("pq_centroids", n=number_of_centroids):
                if use_kmeans:
                    centroids = kmeans_centroids(
                        full_source.vectors, number_of_centroids, dsub,
                        seed=seed, sample=kmeans_sample,
                    )
                else:
                    centroids = random_centroids(
                        full_source.vectors, number_of_centroids, dsub, seed=seed
                    )
            monitor.alive()

            centroid_source = DenseSource(vectors=jnp.asarray(centroids))
            with TRACER.span("pq_centroid_graph"):
                centroid_hnsw = Hnsw.generate(
                    centroid_source, None, pqp.centroids, metric, seed=seed,
                    progress=monitor, verbose=verbose,
                )
                centroid_hnsw.improve_index(pqp.centroids, progress=monitor)
            quantizer = HnswQuantizer(centroid_hnsw, nsub, pqp)

        # quantize the corpus in streaming chunks (reference: vector_chunks,
        # src/pq.rs:325-334)
        codes = []
        n = full_source.count
        with TRACER.span("pq_quantize", n=n):
            for start in range(0, n, chunk_size):
                monitor.alive()
                chunk = full_source.vectors[start : start + chunk_size]
                codes.append(
                    quantizer.quantize(
                        chunk, exact=exact_quantize, fast=fast_quantize
                    )
                )
        if code_dtype is None:
            # reference parity: u16 codes when the codebook fits (src/pq.rs:20)
            n_cent = centroids.shape[1] if centroids.ndim == 3 else len(centroids)
            code_dtype = jnp.uint16 if n_cent <= 65536 else jnp.int32
        pq_source = PqSource(
            codes=jnp.concatenate(codes).astype(code_dtype),
            codebook=jnp.asarray(centroids),
        )

        with TRACER.span("pq_code_graph", n=n):
            # ``improve`` gates the code graph's improve loop, as on
            # ShardedQuantizedHnsw.new
            hnsw = Hnsw.generate(
                pq_source, None, pqp.hnsw, metric, seed=seed, improve=improve,
                progress=monitor, verbose=verbose,
            )
        return cls(quantizer, hnsw, full_source)

    @property
    def vector_count(self) -> int:
        return self.hnsw.vector_count

    def centroid_hnsw(self) -> Optional[Hnsw]:
        """The centroid graph (shared-codebook quantizer only; a
        per-subspace :class:`SubspaceQuantizer` scans its codebooks
        directly and has no graph)."""
        return getattr(self.quantizer, "hnsw", None)

    def search(
        self,
        queries: jax.Array,
        sp: Optional[SearchParams] = None,
        rerank: bool = True,
        exact_quantize: bool = False,
        query_block: int = 0,
    ) -> Tuple[jax.Array, jax.Array]:
        """Quantize the query, search the code graph, exact-rerank
        (reference: src/pq.rs:346-364)."""
        sp = sp or self.hnsw.build_parameters.optimization.search
        if query_block <= 0:
            # the code-graph hop reconstructs [Q, beam*M, SIZE] candidate
            # vectors; bound the block so high-dim PQ stays in device memory
            from parallel_hnsw.graph import source_effective_width

            eff = source_effective_width(self.hnsw.source)
            query_block = max(64, min(8192, (2 << 30) // (sp.beam_width * 48 * eff * 4)))
        qcodes = self.quantizer.quantize(queries, exact=exact_quantize)
        qrecon = self.quantizer.reconstruct(qcodes)
        # when this method reranks against the full vectors anyway, a routed
        # code-graph traversal can skip its own intermediate rerank
        ids, dists = self.hnsw.search(
            qrecon, sp, query_block=query_block, rerank_routed=not rerank
        )
        if not rerank:
            return ids, dists
        return self._rerank(queries, ids)

    def enable_routing(self, dr: Optional[int] = 64, seed: int = 0) -> None:
        """Routing-accelerated code-graph traversal (see
        :mod:`parallel_hnsw.routing`): hop scoring moves from per-hop
        code reconstruction to narrow bf16 routing rows."""
        self.hnsw.enable_routing(dr=dr, seed=seed)

    def enable_hop_slabs(self, byte_budget: int = 4 << 30) -> None:
        """Neighbor-major hop slabs for the code graph (one gather per
        expanded node instead of M per-candidate reconstructions — see
        :class:`parallel_hnsw.routing.HopSlabs`).  Call
        :meth:`enable_routing` first to shrink the slab (bf16 / projected
        rows); the final exact rerank is unchanged."""
        self.hnsw.enable_hop_slabs(byte_budget=byte_budget)

    def _rerank(self, queries, ids, block_budget: int = 1 << 30):
        """Exact rerank of every returned candidate with the full-precision
        vectors, resorted by (distance, id) (reference: src/pq.rs:354-363)."""
        from parallel_hnsw.routing import exact_rerank

        return exact_rerank(
            self.full_source, self.hnsw.metric, queries, ids, block_budget
        )

    def search_exact(
        self,
        queries: jax.Array,
        k: int = 10,
        rerank: bool = True,
        code_block: int = 1 << 16,
        query_block: int = 4096,
        oversample: int = 4,
    ) -> Tuple[jax.Array, jax.Array]:
        """Flat scan over all codes + optional exact rerank.

        Scores the whole compressed corpus without graph traversal, as
        blocked reconstruct-then-matmul: codes stay compressed at rest; each
        code block is transiently decoded ([block, D]) and contracted against
        the query block — mathematically identical to ADC LUT summation
        (validated against :func:`adc_scan`) but gather-light.

        When ``rerank=True`` the fast (reduced-precision) scan keeps
        ``oversample * k`` survivors per query so that true neighbors the
        low-precision pass mis-ranks are still recovered by the exact
        full-precision rerank, which then cuts back to ``k``.
        """
        pq_src = self.hnsw.source
        assert isinstance(pq_src, PqSource)
        metric = self.hnsw.metric
        n = pq_src.count

        # scan precision: reduced-precision products, and the exact rerank
        # restores full-precision ordering of the survivors.  Large corpora
        # additionally use the fused binned-scan kernel on the reconstructed
        # block — the per-tile congruence-class reduce that removes the
        # materialize+top_k bottleneck (analysis.fast_flat_knn's scheme;
        # collisions are covered by the oversample + rerank).
        from parallel_hnsw.analysis import FOLD_MIN_ROWS

        binned = rerank and n >= FOLD_MIN_ROWS

        @functools.partial(jax.jit, static_argnames=("k",))
        def score_block(q, codes, codebook, offset, k):
            feats = reconstruct(codebook, codes)
            if binned:
                from parallel_hnsw.ops.pallas_scan import binned_scan

                bd, bc = binned_scan(q, feats, metric)
                dd, pos = jax.lax.approx_min_k(bd, k)
                idx = jnp.take_along_axis(bc, pos, axis=-1) + offset
                idx = jnp.where(jnp.isfinite(dd), idx, EMPTY_ID)
                return idx.astype(ID_DTYPE), dd
            d = pairwise_distance(q, feats, metric, exact=not rerank)
            if rerank:
                # approx_min_k: a partial reduce; misses are
                # covered by the oversample + exact rerank (same scheme as
                # analysis.fast_flat_knn)
                dd, idx = jax.lax.approx_min_k(d, k)
                return (idx + offset).astype(ID_DTYPE), dd
            neg_d, idx = jax.lax.top_k(-d, k)
            return (idx + offset).astype(ID_DTYPE), -neg_d

        k_scan = k * oversample if rerank else k
        if binned:
            code_block = max(code_block, 1 << 19)
        out_i, out_d = [], []
        for qs in range(0, queries.shape[0], query_block):
            q = queries[qs : qs + query_block]
            best_i, best_d = None, None
            for cs in range(0, n, code_block):
                codes = pq_src.codes[cs : cs + code_block]
                kk = min(k_scan, codes.shape[0])
                idx, dd = score_block(q, codes, pq_src.codebook, cs, kk)
                if best_i is None:
                    best_i, best_d = idx, dd
                else:
                    best_i = jnp.concatenate([best_i, idx], axis=-1)
                    best_d = jnp.concatenate([best_d, dd], axis=-1)
                    bd, bi = jax.lax.sort((best_d, best_i), num_keys=2)
                    best_i, best_d = bi[:, :k_scan], bd[:, :k_scan]
            out_i.append(best_i)
            out_d.append(best_d)
        ids = jnp.concatenate(out_i)
        dists = jnp.concatenate(out_d)
        if rerank:
            ids, dists = self._rerank(queries, ids)
        return ids[:, :k], dists[:, :k]

    # delegates (reference: src/pq.rs:366-410)
    def improve_index(self, bp: Optional[BuildParams] = None, last_recall=None) -> float:
        return self.hnsw.improve_index(bp, last_recall)

    def improve_neighbors(self, op: Optional[OptimizationParams] = None, last_recall=None) -> float:
        return self.hnsw.improve_neighbors(op, last_recall)

    def promote_at_layer(self, layer_from_top: int, bp: Optional[BuildParams] = None) -> bool:
        return self.hnsw.promote_at_layer(layer_from_top, bp)

    def stochastic_recall(self, op: Optional[OptimizationParams] = None) -> float:
        return self.hnsw.stochastic_recall(op)

    def threshold_nn(self, threshold: float, probe_depth: int = 2, initial_search_depth=None):
        return self.hnsw.threshold_nn(threshold, probe_depth, initial_search_depth)

    def zero_neighborhood_size(self) -> int:
        return self.hnsw.build_parameters.zero_layer_neighborhood_size

    def build_parameters_for_improve_index(self) -> BuildParams:
        return self.hnsw.build_parameters
