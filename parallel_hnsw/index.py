"""The Hnsw index: user-facing API tying build/search/optimize/promote together.

API parity with the reference's ``Hnsw<C>`` (reference: src/lib.rs:585-1686):
generate, search[_upto,_instrumented], knn, threshold_nn, improve_index,
improve_neighbors, promote_at_layer, stochastic_recall[_at],
discover_unreachable_vectors, extend_layer, plus persistence in
:mod:`parallel_hnsw.io`.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parallel_hnsw import build as _build
from parallel_hnsw import optimize as _optimize
from parallel_hnsw import promote as _promote
from parallel_hnsw.constants import EMPTY_ID, ID_DTYPE
from parallel_hnsw.graph import (
    Layer,
    Source,
    assert_layer_invariants,
    source_get,
)
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.ops.queues import empty_queue
from parallel_hnsw.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw.progress import ProgressMonitor, ensure_monitor
from parallel_hnsw.search import search as _search
from parallel_hnsw.search import search_one_layer


class Hnsw:
    """A layered similarity graph over a vector source.

    ``layers`` are ordered top→bottom like the reference.  All mutation
    (improve/promote/extend) rebinds ``self.layers`` — arrays are immutable.
    """

    def __init__(
        self,
        layers: List[Layer],
        source: Source,
        metric: Metric,
        build_parameters: Optional[BuildParams] = None,
        verbose: bool = False,
    ):
        self.layers = list(layers)
        self.source = source
        self.metric = Metric(metric)
        self.build_parameters = build_parameters or BuildParams()
        self.verbose = verbose
        self._dense_cache = None
        self._routing = None
        self._hop_slabs = None

    # -- construction --------------------------------------------------------

    @classmethod
    def generate(
        cls,
        source: Source,
        vector_ids: Optional[jax.Array] = None,
        bp: Optional[BuildParams] = None,
        metric: Metric = Metric.COSINE,
        seed: int = 0,
        improve: bool = True,
        progress: Optional[ProgressMonitor] = None,
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
    ) -> "Hnsw":
        """Full ladder build (reference: Hnsw::generate, src/lib.rs:825-893),
        running ``improve_index`` after every layer like the reference.

        ``checkpoint_dir``: persist the stack after every ladder layer (the
        reference only has whole-index persistence; mid-build checkpoints make
        long builds resumable/inspectable).  If the directory already holds a
        partial ladder checkpoint, the build RESUMES from it: the stored stack
        becomes the ladder prefix and only the remaining larger rungs are
        built.  Structured phase updates flow through the progress monitor.
        """
        import os as _os
        import time as _time

        bp = bp or BuildParams()
        monitor = ensure_monitor(progress)
        if vector_ids is None:
            vector_ids = jnp.arange(source.count, dtype=ID_DTYPE)
        self_ref = cls([], source, metric, bp, verbose)
        t_start = _time.time()

        ckpt_meta = {
            "build_seed": seed,
            "corpus_count": int(source.count),
        }
        initial_layers = None
        if checkpoint_dir is not None and _os.path.exists(
            _os.path.join(checkpoint_dir, "meta")
        ):
            from parallel_hnsw.io import deserialize_hnsw, read_index_meta
            from parallel_hnsw.params import params_to_dict

            meta = read_index_meta(checkpoint_dir)
            compatible = (
                meta.get("build_seed") == seed
                and meta.get("corpus_count") == int(source.count)
                and meta.get("metric") == metric.value
                and meta.get("build_parameters") == params_to_dict(bp)
            )
            if not compatible:
                self_ref._log(
                    "checkpoint is from a different build (seed/corpus/metric/"
                    "params mismatch) — ignoring it and rebuilding from scratch"
                )
            else:
                prev = deserialize_hnsw(checkpoint_dir, source=source)
                if prev.layers and prev.layers[-1].node_count <= source.count:
                    initial_layers = prev.layers
                    self_ref._log(
                        f"resuming from checkpoint: {len(initial_layers)} layers, "
                        f"bottom {initial_layers[-1].node_count}"
                    )

        def improver(layers: List[Layer]) -> List[Layer]:
            monitor.update(
                {
                    "type": "layer_built",
                    "layers": [l.node_count for l in layers],
                    "seconds": round(_time.time() - t_start, 1),
                }
            )
            if checkpoint_dir is not None:
                from parallel_hnsw.io import serialize_hnsw

                self_ref.layers = layers
                serialize_hnsw(
                    self_ref, checkpoint_dir, store_source=False,
                    extra_meta=ckpt_meta,
                )
            if not improve:
                return layers
            monitor.alive()
            self_ref.layers = layers
            from parallel_hnsw.utils.trace import TRACER

            with monitor.keep_alive():  # scope guard, reference: keepalive!
                with TRACER.span("improve_index", layers=len(layers)):
                    recall = self_ref.improve_index(bp, progress=monitor)
            monitor.update(
                {
                    "type": "improved",
                    "recall": recall,
                    "seconds": round(_time.time() - t_start, 1),
                }
            )
            return self_ref.layers

        build_source = self_ref.compute_source  # densified for PQ (same distances)
        layers = _build.generate(
            build_source, vector_ids, bp, metric, seed, improver,
            initial_layers=initial_layers,
        )
        self_ref.layers = layers
        if improve and bp.final_relink_sweeps > 0:
            from parallel_hnsw.utils.trace import TRACER

            for _ in range(bp.final_relink_sweeps):
                monitor.alive()
                with TRACER.span("final_relink_sweep"):
                    for lft in range(self_ref.layer_count):
                        self_ref.layers, _, _ = _optimize.link_layer_to_better_neighbors(
                            self_ref.layers, lft, build_source, metric,
                            bp.optimization.search,
                            exact_threshold=bp.optimization.exact_relink_threshold,
                            fast_threshold=bp.optimization.fast_relink_threshold,
                        )
            monitor.update(
                {"type": "final_relink", "seconds": round(_time.time() - t_start, 1)}
            )
        if checkpoint_dir is not None:
            from parallel_hnsw.io import serialize_hnsw

            serialize_hnsw(
                self_ref, checkpoint_dir, store_source=False, extra_meta=ckpt_meta
            )
        return self_ref

    # Densified compute cache: PQ reconstruction is deterministic, so when
    # the decoded corpus fits in HBM every compute phase can run against a
    # dense copy — identical distances, ~100x fewer gathers per hop (each
    # candidate costs 1 row gather instead of 1 + nsub sub-row gathers).
    DENSIFY_BUDGET_BYTES = 4 << 30

    @property
    def compute_source(self) -> Source:
        from parallel_hnsw.graph import DenseSource, PqSource, materialize_source

        if not isinstance(self.source, PqSource):
            return self.source
        if self.source.count * self.source.dim * 4 > self.DENSIFY_BUDGET_BYTES:
            return self.source
        if (
            self._dense_cache is None
            or self._dense_cache.count != self.source.count
        ):
            self._dense_cache = DenseSource(
                vectors=materialize_source(self.source)
            )
        return self._dense_cache

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[hnsw] {msg}", flush=True)

    # -- accessors (reference: src/lib.rs:591-651) ---------------------------

    @property
    def layer_count(self) -> int:
        return len(self.layers)

    def get_layer(self, i: int) -> Optional[Layer]:
        """i counts from the bottom (reference: get_layer, src/lib.rs:604-606)."""
        return self.get_layer_from_top(self.layer_count - i - 1)

    def get_layer_from_top(self, i: int) -> Optional[Layer]:
        return self.layers[i] if 0 <= i < self.layer_count else None

    @property
    def vector_count(self) -> int:
        return self.layers[-1].node_count if self.layers else 0

    def __len__(self) -> int:
        return self.vector_count

    @property
    def entry_vector(self) -> int:
        return int(self.layers[0].nodes[0])

    def all_vectors(self) -> np.ndarray:
        return np.asarray(self.layers[-1].nodes)

    def supers_for_layer(self, layer_id: int) -> np.ndarray:
        """reference: supers_for_layer (src/lib.rs:977-984); layer_id from bottom."""
        if self.layer_count == layer_id + 1:
            return np.asarray(self.get_layer(layer_id).nodes[:1])
        return np.asarray(self.get_layer(layer_id + 1).nodes)

    # -- search --------------------------------------------------------------

    def enable_routing(self, dr: Optional[int] = 64, seed: int = 0) -> None:
        """Build a routing cache for accelerated traversal (see
        :mod:`parallel_hnsw.routing`): hops score against narrow bf16
        rows; :meth:`search` restores exact ranking with a full-precision
        rerank.  Derived state — recompute after deserialization."""
        from parallel_hnsw import routing as _routing

        self._routing = _routing.build_routing(
            self.compute_source, self.metric, dr=dr, seed=seed
        )

    def disable_routing(self) -> None:
        self._routing = None

    def enable_hop_slabs(self, byte_budget: int = 4 << 30) -> None:
        """Materialize neighbor-major feature slabs so each hop issues one
        row gather per expanded node instead of M per-candidate gathers (see
        :class:`parallel_hnsw.routing.HopSlabs`).  Built over the
        routing cache when :meth:`enable_routing` ran first (bf16/projected
        rows — the memory knob), else over the full-precision source
        (results identical to the plain hop).  Derived state: any graph
        mutation (improve/promote/extend) drops it — call again after."""
        from parallel_hnsw import routing as _routing

        self._hop_slabs = _routing.build_hop_slabs(
            self.layers, self.compute_source, self.metric,
            routing=self._routing, byte_budget=byte_budget,
        )

    def disable_hop_slabs(self) -> None:
        self._hop_slabs = None

    def _invalidate_hop_slabs(self) -> None:
        self._hop_slabs = None

    def search(
        self,
        queries: jax.Array,
        sp: Optional[SearchParams] = None,
        exclude: Optional[jax.Array] = None,
        query_block: int = 0,
        routed: Optional[bool] = None,
        rerank_routed: bool = True,
    ) -> Tuple[jax.Array, jax.Array]:
        """Batched multi-layer search. ``queries [Q, D]`` →
        ``(vector_ids [Q, ef], dists [Q, ef])``.

        ``routed`` selects traversal over the routing cache (default: use it
        whenever :meth:`enable_routing` built one); ``rerank_routed=False``
        skips the final exact rerank (for callers that rerank themselves,
        e.g. the PQ pipeline) — routed distances are then approximate.
        """
        sp = sp or self.build_parameters.optimization.search
        if routed is None:
            routed = self._routing is not None
        slabs = self._hop_slabs.slabs if self._hop_slabs is not None else None
        if routed and self._routing is not None:
            from parallel_hnsw import routing as _routing
            from parallel_hnsw.graph import DenseSource

            cache = self._routing
            rq = _routing.route_queries(cache, queries, self.metric)
            ids, dists = _search(
                self.layers, DenseSource(vectors=cache.rows), cache.metric,
                rq, sp, exclude, query_block,
                slabs=slabs if (slabs and self._hop_slabs.routed) else None,
            )
            if not rerank_routed:
                return ids, dists
            return _routing.exact_rerank(
                self.compute_source, self.metric, queries, ids
            )
        if slabs is not None and self._hop_slabs.routed:
            slabs = None  # routed-space slabs can't score raw queries
        return _search(
            self.layers, self.compute_source, self.metric, queries, sp, exclude,
            query_block, slabs=slabs,
        )

    def search_instrumented(
        self,
        queries: jax.Array,
        sp: Optional[SearchParams] = None,
        exclude: Optional[jax.Array] = None,
    ):
        """Batched search returning (ids, dists, stats) with hop counts,
        distance-eval counts and per-query last-improvement hop (reference:
        Hnsw::search_instrumented, src/lib.rs:667-673)."""
        from parallel_hnsw.search import search_instrumented as _si

        sp = sp or self.build_parameters.optimization.search
        return _si(self.layers, self.compute_source, self.metric, queries, sp, exclude)

    def search_upto(
        self,
        queries: jax.Array,
        sp: Optional[SearchParams] = None,
        upto_layer_from_top: Optional[int] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        """Search only the top ``upto_layer_from_top`` layers of the stack
        (reference: Hnsw::search_upto, src/lib.rs:654-661 — searches
        ``layers[..upto_layer_from_top]``).

        ``upto_layer_from_top`` must be in ``[1, layer_count]``; ``None``
        (default) searches the full stack, same as :meth:`search`.  The
        reference's 0 case indexes an empty slice and panics
        (src/search.rs:9-11); here it raises ``ValueError`` instead.
        """
        sp = sp or self.build_parameters.optimization.search
        if upto_layer_from_top is None:
            upto_layer_from_top = len(self.layers)
        if not 1 <= upto_layer_from_top <= len(self.layers):
            raise ValueError(
                f"upto_layer_from_top must be in [1, {len(self.layers)}], "
                f"got {upto_layer_from_top} (0 layers has no entry point)"
            )
        return _search(
            self.layers[:upto_layer_from_top], self.compute_source, self.metric, queries, sp
        )

    def search_exact(
        self,
        queries: jax.Array,
        k: int = 10,
        query_block: int = 4096,
        fast: bool = False,
        oversample: int = 4,
    ):
        """Exact top-k by a full flat scan (no graph traversal).

        A brute-force distance matrix can beat graph traversal for corpora
        up to the low millions; this is the baseline the graph path is
        measured against.

        ``fast=True`` scans in bf16 (:func:`analysis.fast_flat_knn`),
        keeping ``oversample * k`` survivors, then restores
        exact ordering with a full-precision rerank before cutting to ``k``
        (same scheme as :meth:`QuantizedHnsw.search_exact`)."""
        from parallel_hnsw.analysis import brute_force_knn, fast_flat_knn

        if fast:
            return fast_flat_knn(
                self.compute_source, queries, self.metric, k, oversample, query_block
            )
        return brute_force_knn(self.compute_source, queries, self.metric, k, query_block)

    def search_ids(self, vector_ids, sp=None, exclude_self: bool = False):
        """Search with stored vectors as queries (AbstractVector::Stored)."""
        vector_ids = jnp.asarray(vector_ids, ID_DTYPE)
        queries = source_get(self.compute_source, vector_ids)
        exclude = vector_ids if exclude_self else None
        return self.search(queries, sp, exclude=exclude)

    # -- self-similarity (reference: knn/threshold_nn, src/lib.rs:905-962) ---

    def knn(
        self, k: int, probe_depth: int = 2, query_block: int = 0
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All-pairs k-nearest-neighbors over the bottom layer.

        Returns ``(vector_ids [N], neighbor_ids [N, k], dists [N, k])``.
        """
        layer = self.layers[-1]
        n = layer.node_count
        eff_factor = 3
        cap = k * eff_factor
        sp = SearchParams(
            number_of_candidates=cap,
            upper_layer_candidate_count=cap,
            probe_depth=probe_depth,
        )
        ids_list, d_list = [], []
        block = query_block if query_block > 0 else n
        for start in range(0, n, block):
            stop = min(start + block, n)
            nids, nd = self._bottom_layer_self_search(start, stop, cap, sp)
            ids_list.append(nids)
            d_list.append(nd)
        node_ids = np.concatenate(ids_list)
        dists = np.concatenate(d_list)
        # drop self, take k (reference: src/lib.rs:920-925)
        self_col = np.arange(n)[:, None]
        mask = node_ids == self_col
        dists = np.where(mask, np.inf, dists)
        node_ids = np.where(mask, EMPTY_ID, node_ids)
        order = np.argsort(dists, axis=-1, kind="stable")[:, :k]
        node_ids = np.take_along_axis(node_ids, order, -1)
        dists = np.take_along_axis(dists, order, -1)
        vec_ids = np.where(
            node_ids == EMPTY_ID, EMPTY_ID, np.asarray(layer.nodes)[np.clip(node_ids, 0, n - 1)]
        )
        return np.asarray(layer.nodes), vec_ids, dists

    def _bottom_layer_self_search(self, start: int, stop: int, cap: int, sp: SearchParams):
        return self._bottom_layer_self_search_idx(np.arange(start, stop), cap, sp)

    def _bottom_layer_self_search_idx(self, node_idx: np.ndarray, cap: int, sp: SearchParams):
        """Self-search of the given bottom-layer node indices at queue
        capacity ``cap``.  The batch is padded to a query bucket (duplicating
        the first index) so shrinking remainders reuse compiled programs."""
        from parallel_hnsw.search import _query_bucket

        layer = self.layers[-1]
        q = len(node_idx)
        b = _query_bucket(q)
        padded_idx = np.concatenate([node_idx, np.full(b - q, node_idx[0])]) if b != q else node_idx
        idx_j = jnp.asarray(padded_idx, ID_DTYPE)
        queries = source_get(self.compute_source, jnp.take(layer.nodes, idx_j))
        init_ids, init_dists = empty_queue(cap, (b,))
        init_ids = init_ids.at[:, 0].set(idx_j)
        init_dists = init_dists.at[:, 0].set(0.0)
        state = _bottom_search_jit(
            layer,
            self.compute_source,
            self.metric,
            queries,
            init_ids,
            init_dists,
            sp.probe_depth,
            sp.beam_width,
            sp.max_hops,
        )
        return np.asarray(state.ids)[:q], np.asarray(state.dists)[:q]

    def threshold_nn(
        self,
        threshold: float,
        probe_depth: int = 2,
        initial_search_depth: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All neighbors within ``threshold`` distance, growing the queue by
        doubling until covered (reference: threshold_nn, src/lib.rs:930-962).

        Returns ``(vector_ids [N], neighbor_ids [N, cap], dists [N, cap])``
        where entries at distance >= threshold are EMPTY-padded.
        """
        layer = self.layers[-1]
        n = layer.node_count
        cap = initial_search_depth or self.build_parameters.zero_layer_neighborhood_size
        sp = SearchParams(probe_depth=probe_depth)
        # per-node doubling (reference semantics, src/lib.rs:946-952): nodes
        # whose queue already covers the threshold retire each round; only the
        # uncovered remainder re-searches at doubled capacity, so one dense
        # straggler never forces a whole-corpus re-scan.
        active = np.arange(n)
        done_rounds = []  # (node_idx, node_ids, dists) per retired batch
        while True:
            ids_r, d_r = self._bottom_layer_self_search_idx(
                active, cap,
                sp.replace(number_of_candidates=cap, upper_layer_candidate_count=cap),
            )
            last = np.where(
                np.isfinite(d_r).any(-1),
                np.max(np.where(np.isfinite(d_r), d_r, -np.inf), axis=-1),
                0.0,
            )
            full = np.isfinite(d_r).all(axis=-1)
            uncovered = (last < threshold) & full
            keep = np.nonzero(~uncovered)[0]
            if len(keep):
                done_rounds.append((active[keep], ids_r[keep], d_r[keep]))
            active = active[np.nonzero(uncovered)[0]]
            if len(active) == 0:
                break
            cap *= 2
        # assemble at the widest capacity reached
        max_cap = max(r[1].shape[1] for r in done_rounds)
        node_ids = np.full((n, max_cap), EMPTY_ID, np.int32)
        dists = np.full((n, max_cap), np.inf, np.float32)
        for idx, ids_r, d_r in done_rounds:
            node_ids[idx, : ids_r.shape[1]] = ids_r
            dists[idx, : d_r.shape[1]] = d_r
        # mask out self and entries beyond the threshold
        self_col = np.arange(n)[:, None]
        bad = (node_ids == self_col) | (dists >= threshold)
        node_ids = np.where(bad, EMPTY_ID, node_ids)
        dists = np.where(bad, np.inf, dists)
        order = np.argsort(dists, axis=-1, kind="stable")
        node_ids = np.take_along_axis(node_ids, order, -1)
        dists = np.take_along_axis(dists, order, -1)
        vec_ids = np.where(
            node_ids == EMPTY_ID,
            EMPTY_ID,
            np.asarray(layer.nodes)[np.clip(node_ids, 0, n - 1)],
        )
        return np.asarray(layer.nodes), vec_ids, dists

    # -- optimization (reference: src/lib.rs:1463-1686) ----------------------

    def stochastic_recall_at(self, at: int, op: Optional[OptimizationParams] = None) -> float:
        op = op or self.build_parameters.optimization
        return _optimize.stochastic_recall_at(self.layers, at, self.compute_source, self.metric, op)

    def stochastic_recall(self, op: Optional[OptimizationParams] = None) -> float:
        op = op or self.build_parameters.optimization
        return _optimize.stochastic_recall(self.layers, self.compute_source, self.metric, op)

    def improve_neighbors(
        self,
        op: Optional[OptimizationParams] = None,
        last_recall: Optional[float] = None,
        progress: Optional[ProgressMonitor] = None,
    ) -> float:
        op = op or self.build_parameters.optimization
        self.layers, recall = _optimize.improve_neighbors(
            self.layers, self.compute_source, self.metric, op, last_recall,
            monitor=progress,
        )
        self._invalidate_hop_slabs()
        return recall

    def _promoter(self, layers: List[Layer], lft: int, bp: BuildParams, monitor=None):
        def generate_fn(vecs: np.ndarray, new_bp: BuildParams) -> List[Layer]:
            # the ephemeral top-stack rebuild can use the densified compute
            # source directly (only its layers are spliced back)
            sub = Hnsw.generate(
                self.compute_source,
                jnp.asarray(vecs, ID_DTYPE),
                new_bp,
                self.metric,
                improve=True,
                verbose=self.verbose,
            )
            return sub.layers

        return _promote.promote_at_layer(
            layers, lft, bp, self.compute_source, self.metric, generate_fn,
            log=self._log if self.verbose else None, monitor=monitor,
        )

    def promote_at_layer(self, layer_from_top: int, bp: Optional[BuildParams] = None) -> bool:
        bp = bp or self.build_parameters
        self.layers, promoted = self._promoter(self.layers, layer_from_top, bp)
        self._invalidate_hop_slabs()
        return promoted

    def improve_index(
        self,
        bp: Optional[BuildParams] = None,
        last_recall: Optional[float] = None,
        progress: Optional[ProgressMonitor] = None,
    ) -> float:
        bp = bp or self.build_parameters
        monitor = ensure_monitor(progress)

        def promoter(layers, lft, bpp):
            monitor.alive()
            return self._promoter(layers, lft, bpp, monitor=monitor)

        self.layers, recall = _optimize.improve_index(
            self.layers,
            bp,
            self.compute_source,
            self.metric,
            last_recall,
            promoter,
            log=self._log if self.verbose else None,
            monitor=monitor,
        )
        self._invalidate_hop_slabs()
        return recall

    # -- diagnostics (reference: src/lib.rs:279-548, 977-1000) ---------------

    def node_distances_for_layer(self, layer_id: int):
        """BFS (hops, index_sum) per node of a from-bottom layer id
        (reference: node_distances_for_layer, src/lib.rs:986-990)."""
        from parallel_hnsw import analysis

        layer = self.get_layer(layer_id)
        supers = self.supers_for_layer(layer_id)
        return analysis.node_distances(layer, jnp.asarray(supers, ID_DTYPE))

    def discover_nodes_to_promote(self, layer_id: int) -> np.ndarray:
        from parallel_hnsw import analysis

        layer = self.get_layer(layer_id)
        supers = self.supers_for_layer(layer_id)
        return analysis.discover_nodes_to_promote(layer, jnp.asarray(supers, ID_DTYPE))

    def reachables_from_node_for_layer(self, layer_id_from_top: int, node: int, check):
        from parallel_hnsw import analysis

        return analysis.reachables_from(self.layers[layer_id_from_top], node, check)

    # -- repair plumbing -----------------------------------------------------

    def discover_unreachable_vectors(
        self, layer_id_from_top: int, sp: Optional[SearchParams] = None
    ) -> np.ndarray:
        sp = sp or self.build_parameters.optimization.search
        return _promote.discover_unreachable_vectors(
            self.layers, layer_id_from_top, self.compute_source, self.metric, sp
        )

    def extend_layer(self, layer_id: int, vecs: np.ndarray) -> None:
        self.layers = _promote.extend_layer(self.layers, layer_id, vecs)
        self._invalidate_hop_slabs()

    def assert_invariants(self) -> None:
        assert_layer_invariants(self.layers)


@functools.partial(jax.jit, static_argnames=("metric", "probe_depth", "beam_width", "max_hops"))
def _bottom_search_jit(
    layer: Layer,
    source: Source,
    metric: Metric,
    queries,
    init_ids,
    init_dists,
    probe_depth: int,
    beam_width: int,
    max_hops: int,
):
    return search_one_layer(
        layer,
        source,
        metric,
        queries,
        init_ids,
        init_dists,
        probe_depth=probe_depth,
        beam_width=beam_width,
        max_hops=max_hops,
    )
