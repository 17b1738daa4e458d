"""Fused flat scan: class semantics, the Triton kernel (interpret mode), the
chunked XLA route, and the choice between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_hnsw.ops.distance import Metric, pairwise_distance
from parallel_hnsw.ops.pallas_scan import (
    LANES,
    TILE_C,
    chunked_folded_scan,
    fold_geometry,
    folded_scan,
    scan_route,
    triton_folded_scan,
    xla_binned_scan,
    xla_folded_scan,
)

RNG = np.random.default_rng(3)


def _unit(n, d):
    x = RNG.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _bf16(a):
    """``a`` rounded to bf16 and back: the inputs both routes scan."""
    return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)


def _numpy_binned(d, tile_c):
    q, c = d.shape
    cp = ((c + tile_c - 1) // tile_c) * tile_c
    if cp != c:
        d = np.concatenate([d, np.full((q, cp - c), np.inf, np.float32)], axis=-1)
    n_tiles = cp // tile_c
    groups = tile_c // LANES
    d4 = d.reshape(q, n_tiles, groups, LANES)
    bin_d = d4.min(axis=2)
    g = d4.argmin(axis=2)
    lane = np.arange(LANES)[None, None, :]
    base = (np.arange(n_tiles) * tile_c)[None, :, None]
    cols = base + g * LANES + lane
    return bin_d.reshape(q, -1), cols.reshape(q, -1)


def _assert_same_fold(got, ref, atol=1e-5):
    """Equal distances everywhere (inf where the reference is inf) and equal
    columns wherever the class holds a real row."""
    gd, gc = (np.asarray(a) for a in got)
    rd, rc = (np.asarray(a) for a in ref)
    assert gd.shape == rd.shape and gc.shape == rc.shape
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], rd[fin], atol=atol)
    np.testing.assert_array_equal(gc[fin], rc[fin])


@pytest.mark.parametrize("c", [512, 700])
def test_xla_binned_scan_matches_numpy(c):
    x = jnp.asarray(_unit(24, 16))
    y = jnp.asarray(_unit(c, 16))
    d = np.asarray(pairwise_distance(x, y, Metric.EUCLIDEAN))
    want_d, want_c = _numpy_binned(d, 256)
    got_d, got_c = xla_binned_scan(x, y, Metric.EUCLIDEAN, tile_c=256)
    np.testing.assert_allclose(np.asarray(got_d), want_d, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got_c), want_c)
    # every reported column's distance matches the full matrix
    qq, bb = np.nonzero(np.isfinite(np.asarray(got_d)))
    np.testing.assert_allclose(
        np.asarray(got_d)[qq, bb], d[qq, np.asarray(got_c)[qq, bb]], atol=1e-6
    )


def test_pallas_interpret_matches_xla():
    """The binned scan is the fold with one tile per slot: the Triton
    kernel at ``n_slots = n_tiles`` reproduces ``xla_binned_scan``."""
    x = _bf16(_unit(16, 8))
    y = _bf16(_unit(300, 8))
    for metric in (Metric.COSINE, Metric.EUCLIDEAN):
        ref = xla_binned_scan(x, y, metric, tile_c=256)
        got = triton_folded_scan(
            x, y, metric, tile_c=256, n_slots=2, block_q=16, interpret=True
        )
        _assert_same_fold(got, ref)


def test_folded_scan_interpret_matches_xla_fold():
    """The kernel's slot minima == the XLA fold over per-tile bins,
    including the non-divisible tail (padding slots stay +inf)."""
    x = _bf16(_unit(16, 8))
    y = _bf16(_unit(1500, 8))  # 6 tiles of 256 -> n_slots=4 needs pad
    for metric in (Metric.COSINE, Metric.EUCLIDEAN, Metric.DOT):
        ref = xla_folded_scan(x, y, metric, tile_c=256, n_slots=4)
        got = triton_folded_scan(
            x, y, metric, tile_c=256, n_slots=4, block_q=16, interpret=True
        )
        _assert_same_fold(got, ref)


def test_folded_scan_true_neighbors_survive():
    """Every query's true nearest neighbor appears in its folded slab (it is
    the min of whatever class its column folds into)."""
    x = _bf16(_unit(24, 16))
    y = _bf16(_unit(3000, 16))
    gt = np.asarray(
        jnp.argmin(pairwise_distance(x, y, Metric.EUCLIDEAN), axis=-1)
    )
    _, cols = triton_folded_scan(
        x, y, Metric.EUCLIDEAN, tile_c=256, n_slots=8, block_q=16,
        interpret=True,
    )
    cols = np.asarray(cols)
    assert all(gt[i] in cols[i] for i in range(24))


@pytest.mark.parametrize(
    "q,c,d", [(5, 700, 7), (40, 1024, 20), (16, 130, 16)],
    ids=["tiny-q-odd-d", "q-over-block", "c-under-tile"],
)
def test_triton_wrapper_pads_q_c_and_d(q, c, d):
    """Q pads to the query block, D to a power of two >= 16 and C to the
    slot geometry; none of it changes the result or its shape."""
    x = _bf16(RNG.normal(size=(q, d)).astype(np.float32))
    y = _bf16(RNG.normal(size=(c, d)).astype(np.float32))
    ref = xla_folded_scan(x, y, Metric.SQUARED_EUCLIDEAN, tile_c=256, n_slots=3)
    got = triton_folded_scan(
        x, y, Metric.SQUARED_EUCLIDEAN, tile_c=256, n_slots=3, block_q=32,
        interpret=True,
    )
    n_slots, _ = fold_geometry(c, 256, 3)
    assert got[0].shape == (q, n_slots * LANES)
    _assert_same_fold(got, ref, atol=1e-4)


def test_triton_kernel_bf16_operands():
    """The fast scan's bf16 operands: f32 accumulation, distances within
    bf16 rounding of the f32 reference on the same rounded inputs."""
    x = jnp.asarray(_unit(16, 32)).astype(jnp.bfloat16)
    y = jnp.asarray(_unit(600, 32)).astype(jnp.bfloat16)
    ref = xla_folded_scan(
        x.astype(jnp.float32), y.astype(jnp.float32), Metric.EUCLIDEAN,
        tile_c=256, n_slots=2,
    )
    got = triton_folded_scan(
        x, y, Metric.EUCLIDEAN, tile_c=256, n_slots=2, block_q=16,
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), atol=1e-3)


def test_binned_topk_with_rerank_reaches_full_recall():
    """bins + oversampled exact rerank recover the true top-k (statistical:
    oversample covers the rare congruence-class collisions)."""
    from parallel_hnsw.ops.distance import batched_distance

    x = jnp.asarray(_unit(32, 16))
    y = jnp.asarray(_unit(2000, 16))
    k, oversample = 5, 8
    gt = np.asarray(
        jnp.argsort(pairwise_distance(x, y, Metric.EUCLIDEAN), axis=-1)[:, :k]
    )
    bin_d, bin_c = xla_binned_scan(x, y, Metric.EUCLIDEAN, tile_c=256)
    _, pos = jax.lax.top_k(-bin_d, k * oversample)
    cand = jnp.take_along_axis(bin_c, pos, axis=-1)
    d = batched_distance(x, jnp.take(y, cand, axis=0), Metric.EUCLIDEAN)
    d, cand = jax.lax.sort((d, cand), num_keys=2)
    got = np.asarray(cand[:, :k])
    recall = np.mean([len(np.intersect1d(got[i], gt[i])) for i in range(32)]) / k
    assert recall >= 0.99, recall


def test_xla_folded_scan_matches_numpy_fold():
    """xla_folded_scan == a straight numpy fold over per-tile bins."""
    x = jnp.asarray(_unit(12, 8))
    y = jnp.asarray(_unit(900, 8))  # 4 tiles of 256 (padded), n_slots=2
    d = np.asarray(pairwise_distance(x, y, Metric.EUCLIDEAN))
    bin_d, cols = _numpy_binned(d, 256)
    n_slots, n_jj = 2, 2
    d4 = bin_d.reshape(12, n_slots, n_jj, LANES)
    c4 = cols.reshape(12, n_slots, n_jj, LANES)
    jj = d4.argmin(axis=2)
    want_d = np.take_along_axis(d4, jj[:, :, None, :], axis=2)[:, :, 0, :].reshape(12, -1)
    want_c = np.take_along_axis(c4, jj[:, :, None, :], axis=2)[:, :, 0, :].reshape(12, -1)
    got_d, got_c = xla_folded_scan(x, y, Metric.EUCLIDEAN, tile_c=256, n_slots=2)
    np.testing.assert_allclose(np.asarray(got_d), want_d, atol=1e-6)
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.asarray(got_c)[fin], want_c[fin])


def _largest_intermediate_bytes(fn, *args):
    """Bytes of the largest array any equation of ``fn``'s jaxpr produces."""
    biggest = 0
    for eqn in jax.make_jaxpr(fn)(*args).eqns:
        for v in eqn.outvars:
            aval = v.aval
            biggest = max(biggest, int(np.prod(aval.shape)) * aval.dtype.itemsize)
    return biggest


@pytest.mark.parametrize(
    "cap_cols", [2048, 512, 128], ids=["whole-slots", "half-slot", "one-lane-group"]
)
def test_chunked_fold_stays_under_cap(cap_cols):
    """The XLA route chunks the corpus: same result as the unchunked
    reference, and no live block above the byte cap (a slot here spans
    1024 columns, so the two smaller caps fold within a slot)."""
    q = 8
    x = _bf16(_unit(q, 8))
    y = _bf16(_unit(3000, 8))  # 12 tiles of 256 -> 3 slots of 1024
    cap = q * cap_cols * 4
    ref = xla_folded_scan(x, y, Metric.EUCLIDEAN, tile_c=256, n_slots=3)

    def run(a, b):
        return chunked_folded_scan(
            a, b, Metric.EUCLIDEAN, tile_c=256, n_slots=3, block_bytes=cap
        )

    _assert_same_fold(run(x, y), ref, atol=1e-6)
    assert _largest_intermediate_bytes(run, x, y) <= max(cap, y.size * 4)
    unchunked = _largest_intermediate_bytes(
        lambda a, b: xla_folded_scan(a, b, Metric.EUCLIDEAN, tile_c=256,
                                     n_slots=3), x, y)
    assert unchunked > cap


def test_scan_route_one_per_platform():
    assert scan_route("gpu") == "triton"
    assert scan_route("cpu") == "xla"
    # off the GPU, folded_scan is the chunked XLA fold at TILE_C
    x = _bf16(_unit(8, 16))
    y = _bf16(_unit(9000, 16))  # 3 tiles of TILE_C -> 2 slots, one padded
    got = folded_scan(x, y, Metric.COSINE, n_slots=2)
    ref = xla_folded_scan(x, y, Metric.COSINE, tile_c=TILE_C, n_slots=2)
    _assert_same_fold(got, ref, atol=1e-6)


@pytest.mark.gpu
def test_triton_fold_compiled_on_gpu_matches_reference(gpu):
    """The kernel as compiled for the card, against the plain reference on
    the same bf16-rounded inputs."""
    with jax.default_device(gpu):
        x = _bf16(_unit(300, 128))
        y = _bf16(_unit(50_000, 128))
        got = triton_folded_scan(x, y, Metric.EUCLIDEAN, n_slots=8)
        ref = xla_folded_scan(x, y, Metric.EUCLIDEAN, n_slots=8)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                                   atol=1e-3)
