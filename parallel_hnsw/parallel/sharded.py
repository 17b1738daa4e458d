"""Multi-device sharded index: SPMD search over a device mesh.

The reference is a single-process shared-memory library (rayon threads,
reference: Cargo.toml:19) — it has no distributed story.  Here the
scale-out axis is *corpus size*: the corpus is sharded across a
``jax.sharding.Mesh`` axis, each device owns a full HNSW over its shard, and a
query fans out to every shard's batched beam search followed by a cross-shard
top-k merge (``all_gather`` of per-shard candidate queues).  Build is
embarrassingly parallel per shard; no cross-shard pointer chasing ever
happens, so collectives run once per query batch rather than once per
hop.  Supports dense and PQ-compressed shards (BASELINE.md's 100M x 768-d
PQ-sharded configuration is this layout: per-shard code arrays + a replicated
codebook).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parallel_hnsw.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw.graph import DenseSource, Layer, PqSource, Source, source_get
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.ops.queues import sort_queue
from parallel_hnsw.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw.search import search_stack


def default_mesh(n_devices: Optional[int] = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _build_threads(n_tasks: int) -> int:
    """Worker-thread cap for overlapped shard work: one thread per shard up
    to a host-core-scaled bound (threads mostly wait on device dispatch, so
    a few per core; a 1-core CI host still exercises real concurrency
    without thrashing the compiler)."""
    import os

    return max(1, min(n_tasks, 4 * (os.cpu_count() or 1)))


# -- source stacking helpers (dense + PQ) ------------------------------------


def _take_rows_source(source: Source, ids: np.ndarray) -> Source:
    if isinstance(source, DenseSource):
        return DenseSource(vectors=jnp.asarray(np.asarray(source.vectors)[ids]))
    if isinstance(source, PqSource):
        return PqSource(
            codes=jnp.asarray(np.asarray(source.codes)[ids]), codebook=source.codebook
        )
    raise TypeError(type(source))


def _stack_sources(sources: Sequence[Source]) -> Source:
    if isinstance(sources[0], DenseSource):
        return DenseSource(vectors=jnp.stack([s.vectors for s in sources]))
    if isinstance(sources[0], PqSource):
        # codebook is shared/replicated across shards
        return PqSource(
            codes=jnp.stack([s.codes for s in sources]), codebook=sources[0].codebook
        )
    raise TypeError(type(sources[0]))


def _source_specs(source: Source, ax: str):
    if isinstance(source, DenseSource):
        return DenseSource(vectors=P(ax, None, None))
    if isinstance(source, PqSource):
        return PqSource(codes=P(ax, None, None), codebook=P())
    raise TypeError(type(source))


def _unstack_source(stacked: Source) -> Source:
    """Inside shard_map: drop the local leading shard dim (1)."""
    if isinstance(stacked, DenseSource):
        return DenseSource(vectors=stacked.vectors[0])
    if isinstance(stacked, PqSource):
        return PqSource(codes=stacked.codes[0], codebook=stacked.codebook)
    raise TypeError(type(stacked))


def _take_one_shard_source(stacked: Source, s: int) -> Source:
    if isinstance(stacked, DenseSource):
        return DenseSource(vectors=stacked.vectors[s])
    if isinstance(stacked, PqSource):
        return PqSource(codes=stacked.codes[s], codebook=stacked.codebook)
    raise TypeError(type(stacked))


def _gather_stacked_vectors(stacked: Source, s_idx: jax.Array, i_idx: jax.Array) -> jax.Array:
    """Gather full-precision vectors at (shard, local) positions from a
    stacked source (reconstructing for PQ)."""
    if isinstance(stacked, DenseSource):
        return stacked.vectors[s_idx, i_idx]
    from parallel_hnsw.graph import reconstruct

    codes = stacked.codes[s_idx, i_idx].astype(jnp.int32)
    return reconstruct(stacked.codebook, codes)


class ShardedHnsw:
    """A corpus sharded over a mesh axis, one HNSW per shard.

    ``layers_stacked``: per ladder level, (nodes [S, N], neighbors [S, N, M]).
    ``source_stacked``: shard-major vector source (dense [S, N, D] or PQ codes
    [S, N, Q] + replicated codebook); ``global_ids``: [S, N] mapping local ids
    to corpus ids (EMPTY_ID on padding rows).
    """

    def __init__(
        self,
        mesh: Mesh,
        layers_stacked: List[Layer],
        source_stacked: Source,
        global_ids: jax.Array,
        metric: Metric,
        build_parameters: Optional[BuildParams] = None,
    ):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.layers_stacked = layers_stacked
        self.source_stacked = source_stacked
        self.global_ids = global_ids
        self.metric = Metric(metric)
        self.build_parameters = build_parameters or BuildParams()

    # -- construction --------------------------------------------------------

    @classmethod
    def generate(
        cls,
        source: Source,
        mesh: Mesh,
        bp: Optional[BuildParams] = None,
        metric: Metric = Metric.COSINE,
        seed: int = 0,
        improve: bool = True,
        verbose: bool = False,
        parallel_build: bool = True,
        build_graphs: bool = True,
    ) -> "ShardedHnsw":
        """Partition the corpus round-robin over shards and build one HNSW per
        shard, each on its own device.  Shard builds run on concurrent host
        threads (``parallel_build``): JAX dispatch is thread-safe and each
        thread pins its own device via ``jax.default_device``, so per-shard
        device programs overlap across the mesh instead of serializing at the
        host's readback points.  Shard results are deterministic per
        (seed + shard) regardless of scheduling.  Ragged shards are padded by
        repeating the last row; padding rows get EMPTY global ids and are
        masked from results."""
        n_shards = mesh.devices.size
        count = source.count
        per = -(-count // n_shards)  # ceil

        shard_gids = np.full((n_shards, per), EMPTY_ID, np.int32)
        shard_sources: List[Source] = [None] * n_shards
        for s in range(n_shards):
            ids = np.arange(s, count, n_shards)
            real = len(ids)
            if per - real:
                ids = np.concatenate([ids, np.repeat(ids[-1:], per - real)])
            shard_gids[s, :real] = ids[:real]
            shard_sources[s] = _take_rows_source(source, ids)
        return cls.from_shard_sources(
            shard_sources, shard_gids, mesh, bp, metric, seed=seed,
            improve=improve, verbose=verbose, parallel_build=parallel_build,
            build_graphs=build_graphs,
        )

    @classmethod
    def from_shard_sources(
        cls,
        shard_sources: Sequence[Source],
        shard_gids: np.ndarray,  # [S, per] global ids, EMPTY_ID on padding
        mesh: Mesh,
        bp: Optional[BuildParams] = None,
        metric: Metric = Metric.COSINE,
        seed: int = 0,
        improve: bool = True,
        verbose: bool = False,
        parallel_build: bool = True,
        build_graphs: bool = True,
    ) -> "ShardedHnsw":
        """Build one HNSW per pre-partitioned shard source, each on its own
        mesh device, then stack + place.  The seam that lets out-of-core
        ingestion quantize/partition shard rows itself (streaming from disk)
        and hand device-resident per-shard sources straight to the builder.

        ``build_graphs=False`` produces a **scan-only** index: shard sources
        are stacked and placed but no per-shard graphs are built —
        :meth:`search_exact` (the per-shard flat scan + cross-shard merge)
        is the only query engine.  This is the production shape of the
        100M PQ-sharded config, whose serving engine is the flat code scan
        where a multi-million-node code graph would
        cost hours of build for an engine that never walks it."""
        bp = bp or BuildParams()
        n_shards = mesh.devices.size
        assert len(shard_sources) == n_shards
        if not build_graphs:
            out = cls(
                mesh,
                [],
                _stack_sources(shard_sources),
                jnp.asarray(shard_gids),
                metric,
                bp,
            )
            out.place()
            return out
        devices = list(mesh.devices.flat)

        def build_one(s: int) -> Tuple[Source, Hnsw]:
            sub_source = shard_sources[s]
            real = int((shard_gids[s] != EMPTY_ID).sum())
            # local vector ids are 0..per (padding rows are duplicates of the
            # last real vector: harmless graph members, masked at query time)
            local_ids = jnp.arange(real, dtype=ID_DTYPE)
            with jax.default_device(devices[s]):
                h = Hnsw.generate(
                    sub_source, local_ids, bp, metric, seed=seed + s,
                    improve=improve, verbose=verbose,
                )
            return sub_source, h

        if parallel_build and n_shards > 1:
            from concurrent.futures import ThreadPoolExecutor

            # warm-one-then-fan-out: shard 0 builds alone and compiles every
            # build program; the remaining shards then overlap on worker
            # threads.  Executables are per device, so theirs come from the
            # persistent cache when it is on (utils/cache.py; its key leaves
            # out the device on the GPU) and are compiled again otherwise.
            results = [build_one(0)]
            with ThreadPoolExecutor(max_workers=_build_threads(n_shards - 1)) as ex:
                results += list(ex.map(build_one, range(1, n_shards)))
        else:
            results = [build_one(s) for s in range(n_shards)]
        shard_sources: List[Source] = [r[0] for r in results]
        shard_hnsws: List[Hnsw] = [r[1] for r in results]

        layer_counts = {h.layer_count for h in shard_hnsws}
        if len(layer_counts) != 1:
            # promotions may skew ladders between shards; pad missing top
            # levels by replicating each shard's current top.
            max_lc = max(layer_counts)
            for h in shard_hnsws:
                while h.layer_count < max_lc:
                    h.layers.insert(0, h.layers[0])
        # equalize per-level shapes across shards by padding nodes/neighbors
        stacked: List[Layer] = []
        for lvl in range(shard_hnsws[0].layer_count):
            n_max = max(h.layers[lvl].node_count for h in shard_hnsws)
            m_max = max(h.layers[lvl].neighborhood_size for h in shard_hnsws)
            nodes = np.full((n_shards, n_max), EMPTY_ID, np.int32)
            neigh = np.full((n_shards, n_max, m_max), EMPTY_ID, np.int32)
            for s, h in enumerate(shard_hnsws):
                l = h.layers[lvl]
                nodes[s, : l.node_count] = np.asarray(l.nodes)
                neigh[s, : l.node_count, : l.neighborhood_size] = np.asarray(
                    l.neighbors
                )
            stacked.append(
                Layer(nodes=jnp.asarray(nodes), neighbors=jnp.asarray(neigh))
            )

        out = cls(
            mesh,
            stacked,
            _stack_sources(shard_sources),
            jnp.asarray(shard_gids),
            metric,
            bp,
        )
        out.place()
        return out

    def place(self) -> None:
        """Shard the stacked arrays over the mesh axis."""
        ax = self.axis

        def put(x, spec):
            return jax.device_put(x, NamedSharding(self.mesh, spec))

        self.source_stacked = jax.tree_util.tree_map(
            put, self.source_stacked, _source_specs(self.source_stacked, ax)
        )
        self.global_ids = put(self.global_ids, P(ax, None))
        self.layers_stacked = [
            Layer(
                nodes=put(l.nodes, P(ax, None)),
                neighbors=put(l.neighbors, P(ax, None, None)),
            )
            for l in self.layers_stacked
        ]

    # -- query ---------------------------------------------------------------

    def search(
        self, queries: jax.Array, sp: Optional[SearchParams] = None, k: Optional[int] = None
    ) -> Tuple[jax.Array, jax.Array]:
        """Fan out to every shard, merge top-k across shards."""
        if not self.layers_stacked:
            raise ValueError(
                "scan-only sharded index (build_graphs=False) has no shard "
                "graphs; query it with search_exact()"
            )
        sp = sp or self.build_parameters.optimization.search
        k = k or sp.number_of_candidates
        flat = []
        for l in self.layers_stacked:
            flat.extend([l.nodes, l.neighbors])
        return _sharded_search_jit(
            self.mesh,
            self.axis,
            tuple(flat),
            self.source_stacked,
            self.global_ids,
            queries,
            self.metric,
            sp,
            len(self.layers_stacked),
            k,
        )

    def search_exact(
        self,
        queries: jax.Array,
        k: int = 10,
        fast: bool = False,
        oversample: int = 4,
    ) -> Tuple[jax.Array, jax.Array]:
        """Flat-scan the whole sharded corpus: every shard scans its slice
        concurrently (exact scan, or the fused binned scan + in-shard
        exact rerank when ``fast``), then a cross-shard all_gather top-k
        merge.  The mesh-scale counterpart of
        :meth:`Hnsw.search_exact` — the production serving path for the
        100M PQ-sharded config when graph traversal isn't needed."""
        return _sharded_flat_jit(
            self.mesh,
            self.axis,
            self.source_stacked,
            self.global_ids,
            queries,
            self.metric,
            k,
            fast,
            oversample,
        )

    # -- shard round-trip (improve / persistence) -----------------------------

    @property
    def n_shards(self) -> int:
        return int(self.mesh.devices.size)

    @property
    def vector_count(self) -> int:
        return int(np.sum(np.asarray(self.global_ids) != EMPTY_ID))

    def _shard_hnsw(self, s: int) -> Hnsw:
        """Materialize shard ``s`` as a standalone per-device Hnsw (padding
        rows stripped; zero layers for a scan-only index)."""
        layers = []
        for l in self.layers_stacked:
            nodes = np.asarray(l.nodes[s])
            real = int(np.searchsorted(nodes, np.int32(EMPTY_ID)))
            if real == 0:  # replicated-top padding level for this shard
                real = 1
            layers.append(
                Layer(
                    nodes=jnp.asarray(nodes[:real], ID_DTYPE),
                    neighbors=jnp.asarray(np.asarray(l.neighbors[s])[:real]),
                )
            )
        source = _take_one_shard_source(self.source_stacked, s)
        return Hnsw(layers, source, self.metric, self.build_parameters)

    def _restack_from_hnsws(
        self, shard_hnsws: List["Hnsw"], keep_levels: Optional[set] = None
    ) -> None:
        """Re-stack per-shard graphs into mesh-sharded slabs.  ``keep_levels``
        (level indices whose per-shard arrays are unchanged) reuse the
        existing device-resident stacked arrays instead of round-tripping
        through host NumPy — device_put of an already-placed array is a
        no-op, so unchanged levels never leave the devices."""
        n_shards = len(shard_hnsws)
        max_lc = max(h.layer_count for h in shard_hnsws)
        for h in shard_hnsws:
            while h.layer_count < max_lc:
                h.layers.insert(0, h.layers[0])
        stacked: List[Layer] = []
        for lvl in range(max_lc):
            if (
                keep_levels is not None
                and lvl in keep_levels
                and lvl < len(self.layers_stacked)
            ):
                stacked.append(self.layers_stacked[lvl])
                continue
            n_max = max(h.layers[lvl].node_count for h in shard_hnsws)
            m_max = max(h.layers[lvl].neighborhood_size for h in shard_hnsws)
            nodes = np.full((n_shards, n_max), EMPTY_ID, np.int32)
            neigh = np.full((n_shards, n_max, m_max), EMPTY_ID, np.int32)
            for s, h in enumerate(shard_hnsws):
                l = h.layers[lvl]
                nodes[s, : l.node_count] = np.asarray(l.nodes)
                neigh[s, : l.node_count, : l.neighborhood_size] = np.asarray(l.neighbors)
            stacked.append(Layer(nodes=jnp.asarray(nodes), neighbors=jnp.asarray(neigh)))
        self.layers_stacked = stacked
        self.place()

    def improve_index(
        self,
        bp: Optional[BuildParams] = None,
        progress=None,
        parallel: bool = True,
    ) -> float:
        """Per-shard improve_index (shards are independent graphs; the
        reference's improve loop applies shard-locally).  Shard improves run
        on concurrent host threads, one per device (``parallel``); only
        levels some shard actually changed are re-stacked — relinks that
        change nothing preserve array identity (see
        link_layer_to_better_neighbors), so a converged index costs zero
        host round-trips here.  Returns the minimum shard recall."""
        if not self.layers_stacked:
            raise ValueError(
                "scan-only sharded index (build_graphs=False) has no shard "
                "graphs to improve; rebuild with build_graphs=True"
            )
        bp = bp or self.build_parameters
        devices = list(self.mesh.devices.flat)
        hnsws = [self._shard_hnsw(s) for s in range(self.n_shards)]
        before = [
            (h.layer_count, [id(l.neighbors) for l in h.layers]) for h in hnsws
        ]

        def improve_one(s: int) -> float:
            with jax.default_device(devices[s]):
                return hnsws[s].improve_index(bp, progress=progress)

        if parallel and self.n_shards > 1:
            from concurrent.futures import ThreadPoolExecutor

            # shard 0 first to warm the (shape-shared) improve programs,
            # then overlap the rest
            recalls = [improve_one(0)]
            with ThreadPoolExecutor(
                max_workers=_build_threads(self.n_shards - 1)
            ) as ex:
                recalls += list(ex.map(improve_one, range(1, self.n_shards)))
        else:
            recalls = [improve_one(s) for s in range(self.n_shards)]

        counts_changed = any(h.layer_count != b[0] for h, b in zip(hnsws, before))
        if counts_changed:
            # promotions skew ladders / extend lower levels — full restack
            self._restack_from_hnsws(hnsws)
        else:
            changed_levels = {
                lvl
                for h, b in zip(hnsws, before)
                for lvl in range(h.layer_count)
                if id(h.layers[lvl].neighbors) != b[1][lvl]
            }
            if changed_levels:
                keep = set(range(len(self.layers_stacked))) - changed_levels
                self._restack_from_hnsws(hnsws, keep_levels=keep)
        return float(min(recalls))

    def stochastic_recall(self, op: Optional[OptimizationParams] = None, seed: int = 42) -> float:
        """Sampled self-findability across the whole sharded corpus
        (reference: stochastic_recall, src/lib.rs:1501-1505, applied to the
        distributed index)."""
        op = op or self.build_parameters.optimization
        gids = np.asarray(self.global_ids)
        s_idx, i_idx = np.nonzero(gids != EMPTY_ID)
        total = len(s_idx)
        selection = max(1, int(total * op.recall_proportion))
        rng = np.random.default_rng(seed)
        pick = rng.permutation(total)[:selection]
        s_sel = jnp.asarray(s_idx[pick]), jnp.asarray(i_idx[pick])
        queries = _gather_stacked_vectors(self.source_stacked, *s_sel)
        want = gids[s_idx[pick], i_idx[pick]]
        ids, _ = self.search(queries, op.search, k=op.search.number_of_candidates)
        found = np.any(np.asarray(ids) == want[:, None], axis=-1)
        return float(found.mean())


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "metric", "sp", "layer_count", "k"),
)
def _sharded_search_jit(
    mesh: Mesh,
    axis: str,
    layers_flat: Tuple[jax.Array, ...],
    source_stacked: Source,
    global_ids: jax.Array,
    queries: jax.Array,
    metric: Metric,
    sp: SearchParams,
    layer_count: int,
    k: int,
):
    ax = axis

    def per_shard(layers_flat, source_stacked, global_ids, queries):
        # leading shard dim is 1 inside shard_map
        layers = [
            Layer(layers_flat[2 * i][0], layers_flat[2 * i + 1][0])
            for i in range(layer_count)
        ]
        local = _unstack_source(source_stacked)
        gids = global_ids[0]
        ids, dists, _, _, _ = search_stack(layers, local, metric, queries, sp)
        # local → global ids; padding rows map to EMPTY and are dropped
        safe = jnp.clip(ids, 0, gids.shape[0] - 1)
        g = jnp.where(ids == EMPTY_ID, EMPTY_ID, jnp.take(gids, safe))
        dists = jnp.where(g == EMPTY_ID, EMPTY_DIST, dists)
        g, dists = sort_queue(g, dists)
        g = g[:, :k]
        dists = dists[:, :k]
        # cross-shard top-k merge: all_gather candidate queues
        all_g = jax.lax.all_gather(g, ax)  # [S, Q, k]
        all_d = jax.lax.all_gather(dists, ax)
        s, q, kk = all_g.shape
        all_g = jnp.moveaxis(all_g, 0, 1).reshape(q, s * kk)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(q, s * kk)
        m_ids, m_d = sort_queue(all_g, all_d)
        return m_ids[:, :k], m_d[:, :k]

    specs = []
    for _ in range(layer_count):
        specs.extend([P(ax, None), P(ax, None, None)])
    fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            tuple(specs),
            _source_specs(source_stacked, ax),
            P(ax, None),
            P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(layers_flat, source_stacked, global_ids, queries)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "metric", "sp", "layer_count", "k", "oversample"),
)
def _sharded_pq_search_jit(
    mesh: Mesh,
    axis: str,
    layers_flat: Tuple[jax.Array, ...],
    source_stacked: Source,  # PQ codes per shard + replicated codebook
    full_stacked: jax.Array,  # [S, N, D] full-precision shard vectors
    global_ids: jax.Array,
    qrecon: jax.Array,  # reconstructed queries (code-graph search input)
    qraw: jax.Array,  # raw queries (exact rerank input)
    metric: Metric,
    sp: SearchParams,
    layer_count: int,
    k: int,
    oversample: int,
):
    """PQ-sharded search: per-shard code-graph search, *in-shard* exact rerank
    against the shard's full-precision vectors (full vectors never leave their
    shard — only reranked top-k queues cross devices), then cross-shard merge."""
    ax = axis

    def per_shard(layers_flat, source_stacked, full_stacked, global_ids, qrecon, qraw):
        from parallel_hnsw.ops.distance import batched_distance

        layers = [
            Layer(layers_flat[2 * i][0], layers_flat[2 * i + 1][0])
            for i in range(layer_count)
        ]
        local = _unstack_source(source_stacked)
        full = full_stacked[0]  # [N, D]
        gids = global_ids[0]
        ids, dists, _, _, _ = search_stack(layers, local, metric, qrecon, sp)
        # in-shard exact rerank of the oversampled survivors
        kk = min(k * oversample, ids.shape[1])
        cand_ids = ids[:, :kk]
        safe = jnp.clip(cand_ids, 0, full.shape[0] - 1)
        cand_vecs = jnp.take(full, safe, axis=0)  # [Q, kk, D]
        d = batched_distance(qraw, cand_vecs, metric)
        d = jnp.where(cand_ids == EMPTY_ID, EMPTY_DIST, d)
        r_ids, r_d = sort_queue(cand_ids, d)
        r_ids, r_d = r_ids[:, :k], r_d[:, :k]
        # local → global, drop padding
        safe_g = jnp.clip(r_ids, 0, gids.shape[0] - 1)
        g = jnp.where(r_ids == EMPTY_ID, EMPTY_ID, jnp.take(gids, safe_g))
        r_d = jnp.where(g == EMPTY_ID, EMPTY_DIST, r_d)
        g, r_d = sort_queue(g, r_d)
        # cross-shard top-k merge
        all_g = jax.lax.all_gather(g, ax)
        all_d = jax.lax.all_gather(r_d, ax)
        s, q, kq = all_g.shape
        all_g = jnp.moveaxis(all_g, 0, 1).reshape(q, s * kq)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(q, s * kq)
        m_ids, m_d = sort_queue(all_g, all_d)
        return m_ids[:, :k], m_d[:, :k]

    specs = []
    for _ in range(layer_count):
        specs.extend([P(ax, None), P(ax, None, None)])
    fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            tuple(specs),
            _source_specs(source_stacked, ax),
            P(ax, None, None),
            P(ax, None),
            P(),
            P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(layers_flat, source_stacked, full_stacked, global_ids, qrecon, qraw)


class ShardedQuantizedHnsw:
    """PQ-compressed sharded index — the BASELINE.md 100M-config layout.

    A single quantizer (HNSW over a shared codebook, trained on a corpus
    sample) is replicated; PQ codes and full-precision vectors are sharded
    over the mesh axis; each shard carries its own code graph.  Search
    quantizes the query, fans out to every shard's code-graph beam search,
    exact-reranks *inside* the shard (reference: QuantizedHnsw::search rerank,
    src/pq.rs:346-364 — here the rerank happens before the cross-shard merge so full
    vectors never cross devices), and merges top-k across shards.

    Out-of-core mode (``full_source`` a :class:`MemmapSource`): full-precision
    vectors stay ON DISK — the reference's streaming ``VectorSelector`` /
    ``VectorStore`` seam (src/pq.rs:133-142, used at :325-334) taken to its
    conclusion.  Each shard quantizes its own rows in streamed chunks on its
    own device (only codes persist in HBM, 1/(2*dsub)th the f32 bytes at u16),
    search merges *code-exact* top-(oversample*k) across shards, and the final
    exact rerank gathers just ``[Q, oversample*k]`` rows from the memmap.  At
    BASELINE config 5 (100M x 768-d f32 = 307 GB) the resident footprint is
    codes only: 100M x 96 u16 = 19.2 GB across the mesh.
    """

    def __init__(
        self,
        quantizer,
        sharded: ShardedHnsw,
        full_stacked: Optional[jax.Array] = None,  # [S, N, D] (in-core mode)
        full_host: Optional[Source] = None,  # MemmapSource (out-of-core mode)
    ):
        assert (full_stacked is None) != (full_host is None)
        self.quantizer = quantizer
        self.sharded = sharded
        self.full_stacked = full_stacked
        self.full_host = full_host

    @classmethod
    def new(
        cls,
        number_of_centroids: int,
        full_source: Source,
        dsub: int,
        metric: Metric,
        mesh: Mesh,
        pqp=None,
        seed: int = 0,
        use_kmeans: bool = False,
        exact_quantize: bool = False,
        fast_quantize: bool = False,
        chunk_size: int = 100_000,
        improve: bool = True,
        verbose: bool = False,
        build_graphs: bool = True,
        per_subspace: bool = False,
    ) -> "ShardedQuantizedHnsw":
        from parallel_hnsw.graph import is_host_source
        from parallel_hnsw.params import PqBuildParams
        from parallel_hnsw.pq import (
            HnswQuantizer,
            SubspaceQuantizer,
            kmeans_centroids,
            per_subspace_centroids,
            random_centroids,
        )

        pqp = pqp or PqBuildParams()
        dim = full_source.dim
        assert dim % dsub == 0
        nsub = dim // dsub
        out_of_core = is_host_source(full_source)

        if per_subspace:
            # classic PQ: one trained [K, dsub] codebook per subspace —
            # nsub-fold more codebook capacity at identical code bytes (the
            # classic PQ layout);
            # no centroid graph, quantization is a per-subspace argmin
            kw = {"sample": 4_000_000} if out_of_core else {}
            centroids = per_subspace_centroids(
                full_source.vectors, number_of_centroids, dsub, seed=seed,
                use_kmeans=use_kmeans, **kw
            )
            quantizer = SubspaceQuantizer(centroids, metric, pqp)
            centroid_source = None
        else:
            picker = kmeans_centroids if use_kmeans else random_centroids
            kw = {"sample": 4_000_000} if use_kmeans and out_of_core else {}
            centroids = picker(
                full_source.vectors, number_of_centroids, dsub, seed=seed, **kw
            )
            centroid_source = DenseSource(vectors=jnp.asarray(centroids))
            centroid_hnsw = Hnsw.generate(
                centroid_source, None, pqp.centroids, metric, seed=seed,
                verbose=verbose,
            )
            centroid_hnsw.improve_index(pqp.centroids)
            quantizer = HnswQuantizer(centroid_hnsw, nsub, pqp)
        n_cent = centroids.shape[1] if centroids.ndim == 3 else len(centroids)
        code_dtype = jnp.uint16 if n_cent <= 65536 else jnp.int32

        n_shards = mesh.devices.size
        count = full_source.count
        per = -(-count // n_shards)
        devices = list(mesh.devices.flat)

        if out_of_core:
            # Round-robin partition FIRST; each shard streams its own rows
            # from disk and quantizes them on its own device against a
            # per-device codebook replica — the f32 corpus never exists in
            # HBM or host RAM as a whole.
            shard_gids = np.full((n_shards, per), EMPTY_ID, np.int32)
            shard_sources: List[Source] = [None] * n_shards

            def quantize_shard(s: int) -> None:
                from parallel_hnsw.utils.trace import TRACER

                ids = np.arange(s, count, n_shards)
                real = len(ids)
                if per - real:
                    ids = np.concatenate([ids, np.repeat(ids[-1:], per - real)])
                shard_gids[s, :real] = ids[:real]
                dev = devices[s]
                if per_subspace:
                    # per-device codebook replicas: quantize on the shard's
                    # own device against its own [nsub, K, dsub] copy
                    cb = jax.device_put(quantizer.codebooks, dev)
                    qdev = SubspaceQuantizer(cb, metric, pqp)
                else:
                    cb = jax.device_put(centroid_source.vectors, dev)
                chunks = []
                with TRACER.span(
                    "ooc_ingest_shard", rows=real,
                    bytes=real * dim * full_source.vectors.itemsize,
                ), jax.default_device(dev):
                    for chunk in full_source.chunks(chunk_size, ids=ids):
                        if per_subspace:
                            c = qdev.quantize(
                                jnp.asarray(chunk), fast=fast_quantize
                            )
                        elif fast_quantize:
                            from parallel_hnsw.pq import quantize_binned

                            subs = jnp.asarray(chunk).reshape(-1, dsub)
                            c = quantize_binned(subs, cb, metric)
                            c = c.reshape(len(chunk), nsub)
                        elif exact_quantize:
                            from parallel_hnsw.analysis import (
                                blocked_topk_pairwise,
                            )

                            subs = jnp.asarray(chunk).reshape(-1, dsub)
                            ids_c, _ = blocked_topk_pairwise(
                                subs, cb, metric, 1, row_block=8192
                            )
                            c = ids_c[:, 0].reshape(len(chunk), nsub)
                        else:
                            # graph-path quantize runs on the centroid
                            # graph's own device (it is not replicated)
                            c = quantizer.quantize(jnp.asarray(chunk))
                            c = c.reshape(len(chunk), nsub)
                        chunks.append(np.asarray(c.astype(code_dtype)))
                # codes stay as host arrays: the per-shard graph build (and
                # the final place()) converts them under the shard's own
                # default_device, so nothing gets committed to device 0
                shard_sources[s] = PqSource(
                    codes=np.concatenate(chunks), codebook=cb
                )

            if n_shards > 1:
                from concurrent.futures import ThreadPoolExecutor

                quantize_shard(0)  # warm the jitted programs once
                with ThreadPoolExecutor(
                    max_workers=_build_threads(n_shards - 1)
                ) as ex:
                    list(ex.map(quantize_shard, range(1, n_shards)))
            else:
                quantize_shard(0)

            sharded = ShardedHnsw.from_shard_sources(
                shard_sources, shard_gids, mesh, pqp.hnsw, metric, seed=seed,
                improve=improve, verbose=verbose, build_graphs=build_graphs,
            )
            return cls(quantizer, sharded, full_host=full_source)

        codes = []
        for start in range(0, count, chunk_size):
            chunk = full_source.vectors[start : start + chunk_size]
            codes.append(
                quantizer.quantize(chunk, exact=exact_quantize, fast=fast_quantize)
            )
        pq_source = PqSource(
            codes=jnp.concatenate(codes).astype(code_dtype),
            codebook=jnp.asarray(centroids),
        )

        sharded = ShardedHnsw.generate(
            pq_source, mesh, pqp.hnsw, metric, seed=seed, improve=improve,
            verbose=verbose, build_graphs=build_graphs,
        )
        # stack the full-precision vectors shard-major with the same
        # round-robin partition + last-row padding as ShardedHnsw.generate
        vecs = np.asarray(full_source.vectors)
        full = np.zeros((n_shards, per, dim), np.float32)
        for s in range(n_shards):
            ids = np.arange(s, count, n_shards)
            if per - len(ids):
                ids = np.concatenate([ids, np.repeat(ids[-1:], per - len(ids))])
            full[s] = vecs[ids]
        ax = sharded.axis
        full_stacked = jax.device_put(
            jnp.asarray(full), NamedSharding(mesh, P(ax, None, None))
        )
        return cls(quantizer, sharded, full_stacked)

    def search(
        self,
        queries: jax.Array,
        sp: Optional[SearchParams] = None,
        k: int = 10,
        oversample: int = 4,
        exact_quantize: bool = False,
    ) -> Tuple[jax.Array, jax.Array]:
        sh = self.sharded
        sp = sp or sh.build_parameters.optimization.search
        qcodes = self.quantizer.quantize(queries, exact=exact_quantize)
        qrecon = self.quantizer.reconstruct(qcodes)
        if self.full_stacked is None:
            # out-of-core: merge code-exact candidates across shards, then one
            # host-side exact rerank gathers [Q, oversample*k] rows from disk
            ids, _dists = sh.search(qrecon, sp, k=oversample * k)
            ids, dists = self._host_rerank(queries, ids)
            return ids[:, :k], dists[:, :k]
        flat = []
        for l in sh.layers_stacked:
            flat.extend([l.nodes, l.neighbors])
        return _sharded_pq_search_jit(
            sh.mesh,
            sh.axis,
            tuple(flat),
            sh.source_stacked,
            self.full_stacked,
            sh.global_ids,
            qrecon,
            queries,
            sh.metric,
            sp,
            len(sh.layers_stacked),
            k,
            oversample,
        )

    def search_exact(
        self,
        queries: jax.Array,
        k: int = 10,
        oversample: int = 4,
        fast: bool = True,
    ) -> Tuple[jax.Array, jax.Array]:
        """Flat scan over every shard's codes + exact full-precision rerank.

        In-core: each shard reranks its oversampled code-scan survivors
        against its resident f32 vectors BEFORE the cross-shard merge
        (``_sharded_pq_exact_jit``); out-of-core: code-exact candidates merge
        across shards first, then one host rerank gathers rows from the memmap.
        Both paths return true f32 distances (reference rerank contract:
        src/pq.rs:346-364)."""
        sh = self.sharded
        if self.full_stacked is None:
            ids, dists = sh.search_exact(queries, k=oversample * k, fast=fast)
            ids, dists = self._host_rerank(queries, ids)
            return ids[:, :k], dists[:, :k]
        return _sharded_pq_exact_jit(
            sh.mesh,
            sh.axis,
            sh.source_stacked,
            self.full_stacked,
            sh.global_ids,
            queries,
            sh.metric,
            k,
            fast,
            oversample,
        )

    def _host_rerank(self, queries, ids):
        from parallel_hnsw.routing import exact_rerank

        return exact_rerank(self.full_host, self.sharded.metric, queries, ids)

    def stochastic_recall(self, op: Optional[OptimizationParams] = None, seed: int = 42) -> float:
        return self.sharded.stochastic_recall(op, seed)

    def improve_index(self, bp: Optional[BuildParams] = None) -> float:
        return self.sharded.improve_index(bp)


def _shard_flat_scan(local, queries, metric, k_scan, fast):
    """One shard's blocked flat scan over its local source.  Returns
    ``(best_i, best_d)`` — local row ids + scan-precision distances, width
    ``k_scan``.  Shared by the dense and PQ sharded exact-scan kernels."""
    from parallel_hnsw.ops.distance import pairwise_distance
    from parallel_hnsw.ops.pallas_scan import binned_scan

    n_s = local.count
    from parallel_hnsw.analysis import FOLD_MIN_ROWS

    binned = fast and n_s >= FOLD_MIN_ROWS
    blk = 1 << 19
    all_local = jnp.arange(n_s)
    best_i = best_d = None
    for cs in range(0, n_s, blk):
        vecs = source_get(local, all_local[cs : cs + blk])
        kk = min(k_scan, vecs.shape[0])
        if binned:
            bd, bc = binned_scan(queries, vecs, metric)
            dd, pos = jax.lax.approx_min_k(bd, kk)
            idx = jnp.take_along_axis(bc, pos, axis=-1) + cs
            idx = jnp.where(jnp.isfinite(dd), idx, EMPTY_ID).astype(ID_DTYPE)
        elif fast:
            d = pairwise_distance(queries, vecs, metric, exact=False)
            dd, idx = jax.lax.approx_min_k(d, kk)
            idx = (idx + cs).astype(ID_DTYPE)
        else:
            d = pairwise_distance(queries, vecs, metric)
            neg_d, idx = jax.lax.top_k(-d, kk)
            dd = -neg_d
            idx = (idx + cs).astype(ID_DTYPE)
        if best_i is None:
            best_i, best_d = idx, dd
        else:
            ci = jnp.concatenate([best_i, idx], axis=-1)
            cd = jnp.concatenate([best_d, dd], axis=-1)
            cd, ci = jax.lax.sort((cd, ci), num_keys=2)
            best_i, best_d = ci[:, :k_scan], cd[:, :k_scan]
    return best_i, best_d


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "metric", "k", "fast", "oversample"),
)
def _sharded_pq_exact_jit(
    mesh: Mesh,
    axis: str,
    source_stacked: Source,  # PQ codes per shard + replicated codebook
    full_stacked: jax.Array,  # [S, N, D] full-precision shard vectors
    global_ids: jax.Array,
    queries: jax.Array,
    metric: Metric,
    k: int,
    fast: bool,
    oversample: int,
):
    """In-core PQ-sharded exact scan: each shard flat-scans its CODES, then
    exact-reranks the oversampled survivors against its resident
    full-precision vectors BEFORE the cross-shard merge — so the merged queue carries
    true f32 distances, matching :meth:`QuantizedHnsw.search_exact`'s rerank
    contract (reference: src/pq.rs:346-364) and the out-of-core path's
    disk-gather rerank.  Full vectors never cross chips."""
    ax = axis

    def per_shard(source_stacked, full_stacked, global_ids, queries):
        from parallel_hnsw.ops.distance import batched_distance
        from parallel_hnsw.ops.queues import dedup_sorted

        local = _unstack_source(source_stacked)
        full = full_stacked[0]  # [N, D]
        gids = global_ids[0]
        n_s = local.count
        k_scan = min(k * oversample, n_s)
        best_i, _ = _shard_flat_scan(local, queries, metric, k_scan, fast)
        # in-shard exact rerank against FULL-PRECISION vectors (not codes)
        safe = jnp.clip(best_i, 0, full.shape[0] - 1)
        cand = jnp.take(full, safe, axis=0)  # [Q, k_scan, D]
        d = batched_distance(queries, cand, metric)
        d = jnp.where(best_i == EMPTY_ID, EMPTY_DIST, d)
        d, best_i = jax.lax.sort((d, best_i), num_keys=2)
        # local -> global ids (padding rows repeat real ids; dedup at merge)
        safe = jnp.clip(best_i, 0, gids.shape[0] - 1)
        g = jnp.where(best_i == EMPTY_ID, EMPTY_ID, jnp.take(gids, safe))
        d = jnp.where(g == EMPTY_ID, EMPTY_DIST, d)
        g, d = sort_queue(g, d)
        g, d = g[:, :k], d[:, :k]
        all_g = jax.lax.all_gather(g, ax)  # [S, Q, k]
        all_d = jax.lax.all_gather(d, ax)
        s_, q_, kk_ = all_g.shape
        all_g = jnp.moveaxis(all_g, 0, 1).reshape(q_, s_ * kk_)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(q_, s_ * kk_)
        m_ids, m_d = sort_queue(all_g, all_d)
        m_ids, m_d = dedup_sorted(m_ids, m_d)
        return m_ids[:, :k], m_d[:, :k]

    fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            _source_specs(source_stacked, ax),
            P(ax, None, None),
            P(ax, None),
            P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(source_stacked, full_stacked, global_ids, queries)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "metric", "k", "fast", "oversample"),
)
def _sharded_flat_jit(
    mesh: Mesh,
    axis: str,
    source_stacked: Source,
    global_ids: jax.Array,
    queries: jax.Array,
    metric: Metric,
    k: int,
    fast: bool,
    oversample: int,
):
    ax = axis

    def per_shard(source_stacked, global_ids, queries):
        from parallel_hnsw.ops.distance import batched_distance
        from parallel_hnsw.ops.queues import dedup_sorted

        local = _unstack_source(source_stacked)
        gids = global_ids[0]
        n_s = local.count
        k_scan = min(k * oversample, n_s) if fast else min(k, n_s)
        best_i, best_d = _shard_flat_scan(local, queries, metric, k_scan, fast)
        if fast:
            # in-shard exact rerank of the oversampled survivors
            safe = jnp.clip(best_i, 0, n_s - 1)
            cand = source_get(local, safe)
            d = batched_distance(queries, cand, metric)
            d = jnp.where(best_i == EMPTY_ID, jnp.inf, d)
            d, best_i = jax.lax.sort((d, best_i), num_keys=2)
            best_d = d
        # local -> global ids (padding rows repeat real ids; dedup at merge)
        safe = jnp.clip(best_i, 0, gids.shape[0] - 1)
        g = jnp.where(best_i == EMPTY_ID, EMPTY_ID, jnp.take(gids, safe))
        best_d = jnp.where(g == EMPTY_ID, EMPTY_DIST, best_d)
        g, best_d = sort_queue(g, best_d)
        g, best_d = g[:, :k], best_d[:, :k]
        all_g = jax.lax.all_gather(g, ax)  # [S, Q, k]
        all_d = jax.lax.all_gather(best_d, ax)
        s_, q_, kk_ = all_g.shape
        all_g = jnp.moveaxis(all_g, 0, 1).reshape(q_, s_ * kk_)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(q_, s_ * kk_)
        m_ids, m_d = sort_queue(all_g, all_d)
        m_ids, m_d = dedup_sorted(m_ids, m_d)
        return m_ids[:, :k], m_d[:, :k]

    fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            _source_specs(source_stacked, ax),
            P(ax, None),
            P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(source_stacked, global_ids, queries)

