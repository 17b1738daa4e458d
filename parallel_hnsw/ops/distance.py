"""Distance metrics, batched as matrix products.

The reference funnels every distance through a user-supplied
``Comparator::compare_raw`` (reference: src/lib.rs:53-74).  Metrics that
appear in the reference:

* cosine ``1 - dot``            (src/lib.rs:1985-1991, SillyComparator)
* normalized cosine ``(1-dot)/2`` (src/bigvec.rs:47-53, BigComparator)
* euclidean ``sqrt(sum((a-b)^2))`` (src/lib.rs:2431-2437, Comparator32)

Here a metric is a static enum + dense arrays; the two compute shapes are:

* :func:`pairwise_distance` — ``[Q, D] x [C, D] -> [Q, C]`` one big matmul
  (brute-force top-layer init, k-means, exact rerank).
* :func:`batched_distance` — ``[..., D] x [..., C, D] -> [..., C]`` per-query
  gathered candidate blocks (the beam-search hot path).
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

# Full f32 products for every exact path.  Distances feed the reference's 1e-5
# self-match epsilon (src/search.rs:173-187); on the GPU an f32 product at
# DEFAULT precision runs in TF32 (10-bit mantissa, ~1e-3 relative error), which
# would break recall accounting.  Fast paths pass ``exact=False`` and repair
# their ordering with an exact rerank.
_PRECISION = jax.lax.Precision.HIGHEST


class Metric(str, enum.Enum):
    """Distance kinds. str-valued for easy JSON persistence."""

    COSINE = "cosine"  # 1 - dot        (unit vectors assumed)
    NORMALIZED_COSINE = "normalized_cosine"  # (1 - dot) / 2  (unit vectors assumed)
    EUCLIDEAN = "euclidean"  # sqrt(sum sq)
    SQUARED_EUCLIDEAN = "squared_euclidean"  # sum sq
    DOT = "dot"  # -dot (maximum inner product as a minimized distance)


def _finish_dot(dots: jax.Array, metric: Metric) -> jax.Array:
    if metric is Metric.COSINE:
        return 1.0 - dots
    if metric is Metric.NORMALIZED_COSINE:
        return (1.0 - dots) / 2.0
    if metric is Metric.DOT:
        return -dots
    raise ValueError(f"not a dot-based metric: {metric}")


def _is_dot_based(metric: Metric) -> bool:
    return metric in (Metric.COSINE, Metric.NORMALIZED_COSINE, Metric.DOT)


def pairwise_distance(
    x: jax.Array, y: jax.Array, metric: Metric, exact: bool = True
) -> jax.Array:
    """``[Q, D] x [C, D] -> [Q, C]`` distances; one matmul.

    ``exact=False`` drops to default precision (TF32 for f32 operands on the
    GPU, bf16 for bf16 operands) — the fast-scan mode whose misrankings an
    exact rerank later repairs.  Norms are always summed in f32.
    """
    metric = Metric(metric)
    precision = _PRECISION if exact else jax.lax.Precision.DEFAULT
    if _is_dot_based(metric):
        dots = jax.lax.dot_general(
            x,
            y,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision,
        )
        return _finish_dot(dots, metric)
    # euclidean family: ||x||^2 + ||y||^2 - 2 x.y
    dots = jax.lax.dot_general(
        x,
        y,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    xf, yf = x.astype(jnp.float32), y.astype(jnp.float32)
    x2 = jnp.sum(xf * xf, axis=-1, keepdims=True)
    y2 = jnp.sum(yf * yf, axis=-1)[None, :]
    sq = jnp.maximum(x2 + y2 - 2.0 * dots, 0.0)
    if metric is Metric.SQUARED_EUCLIDEAN:
        return sq
    return jnp.sqrt(sq)


def batched_distance(q: jax.Array, cands: jax.Array, metric: Metric) -> jax.Array:
    """``[..., D] x [..., C, D] -> [..., C]`` distances (per-query candidates)."""
    metric = Metric(metric)
    if _is_dot_based(metric):
        dots = jnp.einsum(
            "...d,...cd->...c",
            q,
            cands,
            preferred_element_type=jnp.float32,
            precision=_PRECISION,
        )
        return _finish_dot(dots, metric)
    diff = cands - q[..., None, :]
    sq = jnp.sum(diff * diff, axis=-1)
    if metric is Metric.SQUARED_EUCLIDEAN:
        return sq
    return jnp.sqrt(sq)


def distance_one(a: jax.Array, b: jax.Array, metric: Metric) -> jax.Array:
    """``[..., D] x [..., D] -> [...]`` elementwise-paired distances."""
    metric = Metric(metric)
    if _is_dot_based(metric):
        dots = jnp.sum(a * b, axis=-1)
        return _finish_dot(dots, metric)
    diff = a - b
    sq = jnp.sum(diff * diff, axis=-1)
    if metric is Metric.SQUARED_EUCLIDEAN:
        return sq
    return jnp.sqrt(sq)
