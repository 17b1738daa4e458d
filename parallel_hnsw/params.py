"""Build/search/optimization parameters.

Field names and defaults mirror the reference exactly for recall parity
(reference: src/parameters.rs:3-71).  All dataclasses are frozen and
hashable so they can be passed as static jit arguments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class SearchParams:
    """Mirrors SearchParameters (src/parameters.rs:3-18)."""

    number_of_candidates: int = 300  # ef at the bottom layer
    upper_layer_candidate_count: int = 300  # ef above the bottom layer
    probe_depth: int = 2  # extra non-improving expansion rounds

    # Execution knobs (do not affect the logical operating point): how many
    # frontier nodes are expanded per hop per query. 1 is the faithful greedy
    # order; >1 trades a few extra distance evals for fewer sequential hops.
    beam_width: int = 4
    # hard safety cap on hops inside the jitted while loop.
    max_hops: int = 0  # 0 = auto (derived from queue capacity)

    def replace(self, **kw: Any) -> "SearchParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class OptimizationParams:
    """Mirrors OptimizationParameters (src/parameters.rs:20-39)."""

    promotion_threshold: float = 0.01
    neighborhood_threshold: float = 0.01
    recall_proportion: float = 0.1
    promotion_proportion: float = 1.0
    search: SearchParams = field(default_factory=SearchParams)
    # Extension: layers at or below this node count compute relink matches by
    # exact blocked brute force instead of graph search, which yields
    # true-nearest edges. 0 disables.
    exact_relink_threshold: int = 131072
    # Extension, million-row tier: above exact_relink_threshold but at or
    # below this count (and within the byte budget), relink matches come from
    # the fast scan — bf16 blocks + approx_min_k + exact rerank of
    # oversampled survivors. 0 disables.
    fast_relink_threshold: int = 2_000_000

    def replace(self, **kw: Any) -> "OptimizationParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class BuildParams:
    """Mirrors BuildParameters (src/parameters.rs:41-64)."""

    order: int = 12
    zero_layer_neighborhood_size: int = 48
    neighborhood_size: int = 24
    optimization: OptimizationParams = field(default_factory=OptimizationParams)
    initial_partition_search: SearchParams = field(
        default_factory=lambda: SearchParams(
            number_of_candidates=6, upper_layer_candidate_count=6, probe_depth=2
        )
    )
    # Extension: stacks whose bottom layer is at or below this node count
    # compute initial-partition seeds by exact blocked brute force instead of
    # graph search during generate_layer. 0 disables.
    exact_seed_threshold: int = 131072
    # Extension (not in the reference): unconditional relink sweeps at the
    # end of generate.  The reference's improve loop exits as soon as sampled
    # *self*-recall hits 1.0 (src/lib.rs:1565), which leaves true-neighbor
    # quality on the table; one forced sweep lifts recall@10 from ~0.94 to
    # ~0.999 on random corpora at equal search cost.  0 restores reference
    # control flow exactly.
    final_relink_sweeps: int = 1

    def replace(self, **kw: Any) -> "BuildParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PqBuildParams:
    """Mirrors PqBuildParameters (src/parameters.rs:66-71)."""

    centroids: BuildParams = field(default_factory=BuildParams)
    hnsw: BuildParams = field(default_factory=BuildParams)
    quantized_search: SearchParams = field(default_factory=SearchParams)

    def replace(self, **kw: Any) -> "PqBuildParams":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# (De)serialization helpers: parameters are persisted inside index metadata
# like the reference persists BuildParameters in `meta` (src/serialize.rs:27-31).


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def params_to_dict(p: Any) -> Dict[str, Any]:
    return _to_dict(p)


def search_params_from_dict(d: Dict[str, Any]) -> SearchParams:
    return SearchParams(**d)


def optimization_params_from_dict(d: Dict[str, Any]) -> OptimizationParams:
    d = dict(d)
    d["search"] = search_params_from_dict(d["search"])
    return OptimizationParams(**d)


def build_params_from_dict(d: Dict[str, Any]) -> BuildParams:
    d = dict(d)
    d["optimization"] = optimization_params_from_dict(d["optimization"])
    d["initial_partition_search"] = search_params_from_dict(d["initial_partition_search"])
    return BuildParams(**d)


def pq_build_params_from_dict(d: Dict[str, Any]) -> PqBuildParams:
    d = dict(d)
    d["centroids"] = build_params_from_dict(d["centroids"])
    d["hnsw"] = build_params_from_dict(d["hnsw"])
    d["quantized_search"] = search_params_from_dict(d["quantized_search"])
    return PqBuildParams(**d)
