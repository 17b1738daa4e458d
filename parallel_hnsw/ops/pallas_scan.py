"""Fused flat scan: pairwise distances reduced to per-class minima.

The flat-scan engines are bound by the ``[Q, C]`` f32 distance matrix, not by
the matrix product: at D=128 the product does about 256 flop per 4-byte
output element, far below the ridge point of a GPU's tensor cores, so
writing the matrix to device memory and reading it back for a top-k costs
more than computing it.  The scan here never writes it.  Every output column
is a *class* of corpus columns, and only the class minimum (with its column)
leaves the kernel:

* the corpus is cut into ``n_slots`` contiguous *slots* of ``slot_cols``
  columns (a whole number of ``tile_c`` tiles);
* within a slot, column ``col`` belongs to lane ``col % 128``;
* output column ``s * 128 + lane`` holds the minimum over slot ``s``'s
  columns in that lane.

A binned scan is the same fold with one tile per slot.  A true neighbor is
lost only when a strictly closer row shares its slot and lane; callers keep
``oversample * k`` survivors and rerank them exactly.

Routes, one per platform (:func:`scan_route`):

Both routes take bf16 operands and accumulate in f32; callers rerank the
survivors exactly.

* ``gpu``: :func:`triton_folded_scan`, one Pallas kernel through Triton.
  The grid is (query tiles, slots); each block walks its slot in chunks of
  128 columns in a ``fori_loop``, carrying the running minimum and argmin of
  its ``[block_q, 128]`` tile in registers.
* elsewhere: :func:`chunked_folded_scan`, plain XLA over corpus chunks whose
  distance block stays under a byte cap.

:func:`xla_binned_scan` and :func:`xla_folded_scan` are the unchunked plain
references in f32 that the tests compare both routes with (on bf16-rounded
inputs).

No reference analogue (the reference has no flat-scan engine).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from parallel_hnsw.constants import MATRIX_BYTE_BUDGET
from parallel_hnsw.ops.distance import Metric, pairwise_distance

LANES = 128

# Corpus tile of the fold: a slot is a whole number of these.  Every caller
# uses this geometry; the tests shrink it to reach several slots cheaply.
TILE_C = 4096

# Triton launch parameters: the fastest of a sweep over block_q {64, 128,
# 256} x num_warps {4, 8} x num_stages {2, 3, 4} on an H100 (400 W limit) at
# Q=4096, 1M x 128 bf16, n_slots=32 (see CHANGES.md).
BLOCK_Q = 128
NUM_WARPS = 8
NUM_STAGES = 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def fold_geometry(c: int, tile_c: int, n_slots: int):
    """``(n_slots, slot_cols)`` for a ``c``-column corpus: slots are whole
    runs of ``tile_c`` tiles, at most ``n_slots`` of them."""
    n_c_tiles = max(1, -(-c // tile_c))
    n_slots = min(n_slots, n_c_tiles)
    n_jj = -(-n_c_tiles // n_slots)
    return n_slots, n_jj * tile_c


def _surrogate_scale(metric: Metric) -> float:
    return 2.0 if metric in (Metric.EUCLIDEAN, Metric.SQUARED_EUCLIDEAN) else 1.0


def _column_bias(y: jax.Array, metric: Metric, c: int) -> jax.Array:
    """Per-column additive term of the surrogate ``w - scale * x.y``: the
    squared norms for L2 metrics, ``+inf`` on padding columns."""
    cp = y.shape[0]
    if metric in (Metric.EUCLIDEAN, Metric.SQUARED_EUCLIDEAN):
        yf = y.astype(jnp.float32)
        w = jnp.sum(yf * yf, axis=-1)
    else:
        w = jnp.zeros((cp,), jnp.float32)
    return jnp.where(jnp.arange(cp) < c, w, jnp.inf)


def _surrogate_to_distance(t: jax.Array, x: jax.Array, metric: Metric) -> jax.Array:
    """Monotone map from the reduced surrogate to the metric's distance;
    padding classes (``+inf``) stay ``+inf``."""
    if metric is Metric.COSINE:
        d = 1.0 + t
    elif metric is Metric.NORMALIZED_COSINE:
        d = 0.5 + 0.5 * t
    elif metric is Metric.DOT:
        d = t
    else:
        xf = x.astype(jnp.float32)
        d = jnp.maximum(jnp.sum(xf * xf, axis=-1, keepdims=True) + t, 0.0)
        if metric is Metric.EUCLIDEAN:
            d = jnp.sqrt(d)
    return jnp.where(jnp.isinf(t), jnp.inf, d)


def _fold_kernel(x_ref, y_ref, w_ref, outt_ref, outi_ref, *, scale, slot_cols):
    """One ``(query tile, slot)`` block: stream the slot's corpus in chunks
    of 128 columns and keep, per lane, the first column reaching the
    minimum surrogate ``w - scale * x.y``."""
    x = x_ref[...]  # [BQ, Dp]
    bq = x.shape[0]
    base = pl.program_id(1) * slot_cols
    lane = jnp.arange(LANES, dtype=jnp.int32)

    def body(j, carry):
        best_t, best_i = carry
        off = pl.multiple_of(j * LANES, LANES)
        y = y_ref[pl.ds(off, LANES), :]  # [128, Dp]
        w = w_ref[pl.ds(off, LANES)]  # [128]
        dots = pl.dot(x, y, trans_b=True)  # bf16 operands, f32 accumulation
        t = w[None, :] - scale * dots
        better = t < best_t
        col = base + off + lane
        return (
            jnp.where(better, t, best_t),
            jnp.where(better, col[None, :], best_i),
        )

    init = (
        jnp.full((bq, LANES), jnp.inf, jnp.float32),
        jnp.broadcast_to(base + lane[None, :], (bq, LANES)),
    )
    best_t, best_i = jax.lax.fori_loop(0, slot_cols // LANES, body, init)
    outt_ref[...] = best_t
    outi_ref[...] = best_i


@functools.partial(
    jax.jit,
    static_argnames=("metric", "tile_c", "n_slots", "block_q", "interpret"),
)
def triton_folded_scan(
    x: jax.Array,
    y: jax.Array,
    metric: Metric,
    tile_c: int = TILE_C,
    n_slots: int = 32,
    block_q: int = BLOCK_Q,
    interpret: bool = False,
):
    """``[Q, D] x [C, D] -> (dists, cols)`` of shape ``[Q, n_slots' * 128]``
    through the Triton kernel (``n_slots' = min(n_slots, ceil(C/tile_c))``).

    Operands are cast to bf16; the product accumulates in f32.  Q pads to
    ``block_q``, D to a power of two of at least 16 (zeros leave every
    distance unchanged), C to the slot geometry (padding columns carry
    ``+inf``)."""
    metric = Metric(metric)
    x = x.astype(jnp.bfloat16)
    y = y.astype(jnp.bfloat16)
    q, d = x.shape
    c = y.shape[0]
    n_slots, slot_cols = fold_geometry(c, tile_c, n_slots)
    cp = n_slots * slot_cols
    dp = max(16, _next_pow2(d))
    bq = min(block_q, max(16, _next_pow2(q)))
    qp = _round_up(q, bq)
    xp = jnp.pad(x, ((0, qp - q), (0, dp - d)))
    yp = jnp.pad(y, ((0, cp - c), (0, dp - d)))
    w = _column_bias(yp, metric, c)

    outt, outi = pl.pallas_call(
        functools.partial(
            _fold_kernel, scale=_surrogate_scale(metric), slot_cols=slot_cols
        ),
        out_shape=(
            jax.ShapeDtypeStruct((qp, n_slots * LANES), jnp.float32),
            jax.ShapeDtypeStruct((qp, n_slots * LANES), jnp.int32),
        ),
        grid=(qp // bq, n_slots),
        in_specs=[
            pl.BlockSpec((bq, dp), lambda i, s: (i, 0)),
            pl.BlockSpec((slot_cols, dp), lambda i, s: (s, 0)),
            pl.BlockSpec((slot_cols,), lambda i, s: (s,)),
        ],
        out_specs=(
            pl.BlockSpec((bq, LANES), lambda i, s: (i, s)),
            pl.BlockSpec((bq, LANES), lambda i, s: (i, s)),
        ),
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        backend="triton",
        interpret=interpret,
        name="folded_scan",
    )(xp, yp, w)
    return _surrogate_to_distance(outt[:q], x, metric), outi[:q]


def _class_min(d: jax.Array, group: int):
    """``[Q, R * group * 128] -> [Q, R, 128]`` minima (and positions within
    each run's columns) over columns of equal lane."""
    q = d.shape[0]
    d4 = d.reshape(q, -1, group, LANES)
    g = jnp.argmin(d4, axis=2).astype(jnp.int32)
    return jnp.min(d4, axis=2), g * LANES + jnp.arange(LANES, dtype=jnp.int32)


def chunked_folded_scan(
    x: jax.Array,
    y: jax.Array,
    metric: Metric,
    tile_c: int = TILE_C,
    n_slots: int = 32,
    block_bytes: int = MATRIX_BYTE_BUDGET,
):
    """The fold in plain XLA on bf16 operands, same output as
    :func:`xla_folded_scan`, with no live distance block above
    ``block_bytes``.

    A step covers whole slots when one slot's ``[Q, slot_cols]`` block fits
    the cap; otherwise it covers an aligned part of one slot and folds into
    that slot's running minimum (strict ``<``: the first column wins ties,
    as in the reference)."""
    metric = Metric(metric)
    x = x.astype(jnp.bfloat16)
    y = y.astype(jnp.bfloat16)
    q = x.shape[0]
    c = y.shape[0]
    n_slots, slot_cols = fold_geometry(c, tile_c, n_slots)
    max_cols = max(LANES, (block_bytes // (4 * max(q, 1))) // LANES * LANES)
    if max_cols >= slot_cols:
        step = slot_cols * min(n_slots, max_cols // slot_cols)
    else:
        units = slot_cols // LANES
        step = LANES * max(
            u for u in range(1, max_cols // LANES + 1) if units % u == 0
        )

    lane = jnp.arange(LANES, dtype=jnp.int32)

    def step_min(c0, group):
        """Per-lane minima of the step at ``c0`` over runs of ``group * 128``
        columns, with their corpus columns: ``[Q, runs, 128]`` each."""
        runs = step // (group * LANES)
        base = c0 + (jnp.arange(runs, dtype=jnp.int32) * group * LANES)
        yb = y[c0 : c0 + step]
        if yb.shape[0] == 0:
            # all padding: emit the result directly (XLA would constant-fold
            # a reduce of a constant block, for minutes at real widths)
            return (
                jnp.full((q, runs, LANES), jnp.inf, jnp.float32),
                jnp.broadcast_to(base[None, :, None] + lane, (q, runs, LANES)),
            )
        d = pairwise_distance(x, yb, metric, exact=False)
        if yb.shape[0] < step:
            pad = jnp.full((q, step - yb.shape[0]), jnp.inf, jnp.float32)
            d = jnp.concatenate([d, pad], axis=-1)
        md, pos = _class_min(d, group)
        return md, base[None, :, None] + pos

    outs_d, outs_i = [], []
    acc_d = acc_i = None
    for c0 in range(0, n_slots * slot_cols, step):
        if step >= slot_cols:
            md, col = step_min(c0, slot_cols // LANES)
            outs_d.append(md.reshape(q, -1))
            outs_i.append(col.reshape(q, -1))
            continue
        md, col = step_min(c0, step // LANES)
        md, col = md[:, 0], col[:, 0]
        if c0 % slot_cols == 0:
            acc_d, acc_i = md, col
        else:
            better = md < acc_d
            acc_d = jnp.where(better, md, acc_d)
            acc_i = jnp.where(better, col, acc_i)
        if (c0 + step) % slot_cols == 0:
            outs_d.append(acc_d)
            outs_i.append(acc_i)
    width = n_slots * LANES  # a last whole-slot step may run past the end
    return (
        jnp.concatenate(outs_d, axis=-1)[:, :width],
        jnp.concatenate(outs_i, axis=-1)[:, :width],
    )


def xla_folded_scan(
    x: jax.Array,
    y: jax.Array,
    metric: Metric,
    tile_c: int = TILE_C,
    n_slots: int = 32,
):
    """Plain reference of the fold (materializes ``[Q, C]``; tests only)."""
    bin_d, cols = xla_binned_scan(x, y, metric, tile_c=tile_c)
    q = x.shape[0]
    n_c_tiles = bin_d.shape[1] // LANES
    n_slots = min(n_slots, n_c_tiles)
    n_jj = (n_c_tiles + n_slots - 1) // n_slots
    pad_tiles = n_slots * n_jj - n_c_tiles
    if pad_tiles:
        bin_d = jnp.concatenate(
            [bin_d, jnp.full((q, pad_tiles * LANES), jnp.inf, jnp.float32)], axis=1
        )
        cols = jnp.concatenate(
            [cols, jnp.zeros((q, pad_tiles * LANES), jnp.int32)], axis=1
        )
    d4 = bin_d.reshape(q, n_slots, n_jj, LANES)
    c4 = cols.reshape(q, n_slots, n_jj, LANES)
    jj_best = jnp.argmin(d4, axis=2)
    out_d = jnp.take_along_axis(d4, jj_best[:, :, None, :], axis=2)[:, :, 0, :]
    out_i = jnp.take_along_axis(c4, jj_best[:, :, None, :], axis=2)[:, :, 0, :]
    return out_d.reshape(q, -1), out_i.reshape(q, -1)


def xla_binned_scan(x: jax.Array, y: jax.Array, metric: Metric, tile_c: int = TILE_C):
    """Plain reference of the binned scan (one tile per slot), f32 at
    ``Precision.HIGHEST``."""
    q, _ = x.shape
    c, _ = y.shape
    cp = _round_up(c, tile_c)
    d = pairwise_distance(x, y, metric)
    if cp != c:
        d = jnp.concatenate(
            [d, jnp.full((q, cp - c), jnp.inf, jnp.float32)], axis=-1
        )
    n_tiles = cp // tile_c
    groups = tile_c // LANES
    d4 = d.reshape(q, n_tiles, groups, LANES)
    bin_d = jnp.min(d4, axis=2)  # [Q, n_tiles, 128]
    g_idx = jnp.argmin(d4, axis=2).astype(jnp.int32)
    lane = jnp.arange(LANES, dtype=jnp.int32)[None, None, :]
    tile_base = (jnp.arange(n_tiles, dtype=jnp.int32) * tile_c)[None, :, None]
    cols = tile_base + g_idx * LANES + lane
    return bin_d.reshape(q, -1), cols.reshape(q, -1)


def scan_route(platform: str) -> str:
    """The one route the fused scan takes on ``platform``."""
    return "triton" if platform == "gpu" else "xla"


def _platform(x) -> str:
    """Platform of ``x``'s device, or of the default device for tracers."""
    if isinstance(x, jax.Array) and not isinstance(x, jax.core.Tracer):
        return next(iter(x.devices())).platform
    dd = jax.config.jax_default_device
    if dd is not None and not isinstance(dd, str):
        return dd.platform
    return jax.default_backend()


def folded_scan(x, y, metric, n_slots: int = 32):
    """The fused scan on this platform's route, on bf16 operands.  Output
    is ``[Q, n_slots' * 128]`` whatever the corpus size; callers rerank the
    survivors exactly."""
    metric = Metric(metric)
    if scan_route(_platform(x)) == "triton":
        return triton_folded_scan(x, y, metric, n_slots=n_slots)
    return chunked_folded_scan(x, y, metric, n_slots=n_slots)


def binned_scan(x, y, metric):
    """The fold with one ``TILE_C`` tile per slot: output width
    ``ceil(C / TILE_C) * 128``."""
    return folded_scan(x, y, metric, n_slots=max(1, -(-y.shape[0] // TILE_C)))
