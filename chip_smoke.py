"""Smoke run of the index on an NVIDIA GPU, through the library's entry points.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the sharded phase only

One card, at SIFT1M shape (1,000,000 x 128 float32, Euclidean; a seeded
clustered corpus with 10,000 held-out queries from the same seed):

* device: JAX's devices, and the card's name and power limit from
  ``nvidia-smi``.  Exits non-zero when JAX finds no GPU.
* corpus: the corpus and the exact ground truth at ``Precision.HIGHEST``.
* graph: ``Hnsw.generate`` with the default ``BuildParams`` and, by default,
  ``improve=False`` (a cut: see CHANGES.md; ``--improve`` runs the loop),
  then ``Hnsw.search`` at k=10 at rising ef until recall@10 reaches 0.95.
  The build runs twice in one process: the second, with every program
  already compiled, is the run time; the first minus the second is compile
  and first use.  The programs that took longest to compile are listed.
* scan: ``Hnsw.search_exact`` exact and fast.  The exact scan matches NumPy
  float64 on 1,000 queries (distances within 1e-5, ids equal up to ties
  within that bound); the fast scan's recall@10 is within 0.002 of the same
  path run on the host CPU.
* kernels: the fused fold (``ops.pallas_scan``) compiled for the card, its
  memory analysis, one comparison with a plain reference, its median time
  beside the plain XLA fold, and the fast scan end to end at 200k and 1M
  rows three ways: the exhaustive scan, the fold through the kernel, and
  the fold through the plain XLA route.
* pq: ``QuantizedHnsw.new(per_subspace=True)`` on 100,000 x 96 (code graph
  built without the improve loop, a cut), one search.

Four cards: ``ShardedHnsw.generate`` over 4 x 250,000 rows of the same
corpus on ``default_mesh()`` (same improve setting), ``search`` and
``search_exact`` (exact, and fast through the kernel) at k=10 checked
against one card's brute force, where each shard landed, and each card's
peak memory.

Any failed check raises, and the script exits non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROWS = 1_000_000  # SIFT1M's base set
N_QUERIES = 10_000  # SIFT1M's query set
DIM = 128
K = 10
EFS = (64, 128, 256, 512)
SEED = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def recall_at(got, gt, k: int = K) -> float:
    got, gt = np.asarray(got)[:, :k], np.asarray(gt)[:, :k]
    hits = [len(np.intersect1d(got[i], gt[i])) for i in range(len(gt))]
    return float(np.mean(hits)) / k


def timed(fn, *args, repeats: int = 1):
    """(result, median seconds) of ``fn(*args)`` after one warm-up call,
    each timing ending in ``block_until_ready``."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


class CompileClock:
    """JAX's own trace, lower and compile events while the clock is
    installed.  Their sum is an upper bound on compile time: a jit traced
    inside another reports its own trace event inside the outer one's."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )
    BACKEND = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.backend = []  # (program, seconds) per backend compile
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, fun_name: str = "?",
                  **_) -> None:
        if event in self.EVENTS:
            self.seconds += duration
        if event == self.BACKEND:
            self.backend.append((fun_name, duration))

    def mark(self):
        return self.seconds, len(self.backend)

    def report(self, name: str, mark, top: int = 10) -> None:
        """Log the events since ``mark``: their sum, the backend compiles
        (a persistent-cache hit counts as one, at its load time) and the
        programs that took longest."""
        secs, n = mark
        per = {}
        for fun, d in self.backend[n:]:
            c, t = per.get(fun, (0, 0.0))
            per[fun] = (c + 1, t + d)
        total = sum(t for _, t in per.values())
        log(f"{name} compile: events {self.seconds - secs:.1f}s (upper bound), "
            f"backend {total:.1f}s in {len(self.backend) - n} compiles of "
            f"{len(per)} programs; longest: " + ", ".join(
                f"{fun} x{c} {t:.1f}s" for fun, (c, t) in
                sorted(per.items(), key=lambda kv: -kv[1][1])[:top]))


def make_corpus(rows: int, n_queries: int, seed: int):
    from parallel_hnsw.graph import DenseSource
    from parallel_hnsw.utils.data import clustered_corpus

    allv = clustered_corpus(rows + n_queries, DIM, seed=seed).vectors
    return DenseSource(vectors=allv[:rows]), allv[rows:]


def ground_truth(source, queries):
    from parallel_hnsw.analysis import brute_force_knn
    from parallel_hnsw.ops.distance import Metric

    (ids, dists), secs = timed(
        lambda: brute_force_knn(source, queries, Metric.EUCLIDEAN, K)
    )
    log(f"ground truth: brute_force_knn HIGHEST {queries.shape[0]} queries "
        f"in {secs:.3f}s")
    return np.asarray(ids), np.asarray(dists)


def phase_graph(source, queries, gt, improve: bool, clock: CompileClock):
    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.ops.distance import Metric
    from parallel_hnsw.params import BuildParams

    import jax

    def build():
        t0 = time.perf_counter()
        index = Hnsw.generate(source, None, BuildParams(), Metric.EUCLIDEAN,
                              seed=0, improve=improve)
        jax.block_until_ready(index.layers[-1].neighbors)
        return index, time.perf_counter() - t0

    mark = clock.mark()
    index, first = build()
    clock.report("graph build", mark)
    again, run = build()
    same = all(np.array_equal(np.asarray(a.neighbors), np.asarray(b.neighbors))
               for a, b in zip(index.layers, again.layers))
    del again
    log(f"graph build: rows={source.count} improve={improve} first "
        f"{first:.1f}s, second (compiled, the run time) {run:.1f}s, "
        f"first - second (compile and first use) {first - run:.1f}s, "
        f"same graph both times: {same}; "
        f"layers={[l.node_count for l in index.layers]}")
    sweep_ef("graph search", lambda sp: index.search(queries, sp),
             index.build_parameters.optimization.search, gt)
    return index


def sweep_ef(name, search, sp0, gt, efs=EFS):
    """Search at rising ef until recall@10 reaches 0.95; raises if it never
    does."""
    for ef in efs:
        sp = sp0.replace(number_of_candidates=ef, upper_layer_candidate_count=ef)
        (ids, _), secs = timed(lambda: search(sp))
        r = recall_at(ids, gt)
        log(f"{name}: ef={ef} recall@10={r:.4f} "
            f"qps={gt.shape[0] / secs:.0f} ({secs:.3f}s)")
        if r >= 0.95:
            return
    raise AssertionError(f"{name}: recall@10 < 0.95 at every ef in {efs}")


def check_exact(source, queries, ids, dists, n_check: int = 1000):
    """Exact-scan ids and distances against NumPy float64."""
    from parallel_hnsw.constants import MATCH_EPSILON

    base = np.asarray(source.vectors, np.float64)
    b2 = np.sum(base * base, axis=1)
    q = np.asarray(queries[:n_check], np.float64)
    ids, dists = np.asarray(ids[:n_check]), np.asarray(dists[:n_check])
    worst_d = 0.0
    for s in range(0, n_check, 50):
        qb = q[s : s + 50]
        d2 = b2[None, :] + np.sum(qb * qb, axis=1)[:, None] - 2.0 * qb @ base.T
        part = np.argpartition(d2, K, axis=1)[:, :K]
        for r in range(qb.shape[0]):
            want = part[r][np.argsort(d2[r, part[r]], kind="stable")]
            d64 = np.sqrt(np.maximum(d2[r], 0.0))
            got_i = ids[s + r]
            worst_d = max(worst_d, float(np.max(np.abs(dists[s + r] - d64[got_i]))))
            tie = np.abs(d64[got_i] - d64[want]) <= MATCH_EPSILON
            if not np.all((got_i == want) | tie):
                raise AssertionError(f"exact scan ids differ at query {s + r}")
    if worst_d > MATCH_EPSILON:
        raise AssertionError(f"exact scan distance error {worst_d:.2e} > 1e-5")
    log(f"exact scan vs NumPy float64 on {n_check} queries: ids equal up to "
        f"ties, max |dist error| = {worst_d:.2e}")


def phase_scan(index, source, queries, gt):
    import jax

    (ids, dists), secs = timed(lambda: index.search_exact(queries, k=K))
    log(f"scan exact: recall@10={recall_at(ids, gt):.4f} "
        f"qps={queries.shape[0] / secs:.0f} ({secs:.3f}s)")
    check_exact(source, queries, ids, dists)

    (f_ids, _), secs = timed(lambda: index.search_exact(queries, k=K, fast=True),
                             repeats=3)
    r_gpu = recall_at(f_ids, gt)
    log(f"scan fast: recall@10={r_gpu:.4f} qps={queries.shape[0] / secs:.0f} "
        f"({secs:.3f}s median of 3)")

    # the same fast path on the host CPU, on a 1,000-query subsample
    from parallel_hnsw.analysis import fast_flat_knn
    from parallel_hnsw.graph import DenseSource
    from parallel_hnsw.ops.distance import Metric

    cpu = jax.devices("cpu")[0]
    n_sub = 1000
    with jax.default_device(cpu):
        src_cpu = DenseSource(vectors=jax.device_put(source.vectors, cpu))
        q_cpu = jax.device_put(queries[:n_sub], cpu)
        c_ids, _ = fast_flat_knn(src_cpu, q_cpu, Metric.EUCLIDEAN, K)
    r_cpu = recall_at(c_ids, gt[:n_sub])
    r_sub = recall_at(f_ids[:n_sub], gt[:n_sub])
    log(f"scan fast on {n_sub} queries: gpu recall@10={r_sub:.4f} "
        f"cpu recall@10={r_cpu:.4f}")
    if abs(r_sub - r_cpu) > 0.002:
        raise AssertionError(f"fast-scan recall differs from the CPU's: "
                             f"{r_sub:.4f} vs {r_cpu:.4f}")


def phase_kernels(source, queries):
    import jax
    import jax.numpy as jnp

    from parallel_hnsw.ops.distance import Metric, pairwise_distance
    from parallel_hnsw.ops import pallas_scan as ps

    metric = Metric.EUCLIDEAN
    y16 = source.vectors.astype(jnp.bfloat16)
    nq = min(4096, queries.shape[0])
    q16 = queries[:nq].astype(jnp.bfloat16)
    tile_c, n_slots = 4096, 32

    fold = jax.jit(ps.triton_folded_scan, static_argnames=("metric", "tile_c",
                                                           "n_slots"))
    compiled = fold.lower(q16, y16, metric, tile_c=tile_c,
                          n_slots=n_slots).compile()
    log(f"kernel folded_scan [{nq},{DIM}]x[{source.count},{DIM}] bf16: "
        f"memory_analysis={compiled.memory_analysis()}")

    # one comparison with the plain reference on 256 queries: per class
    # (slot, lane) the best and second-best surrogate-space distance
    nc = min(256, nq)
    got_d, got_i = fold(q16[:nc], y16, metric, tile_c=tile_c, n_slots=n_slots)
    slots, slot_cols = ps.fold_geometry(source.count, tile_c, n_slots)
    d = pairwise_distance(q16[:nc].astype(jnp.float32),
                          y16.astype(jnp.float32), metric)
    d = jnp.pad(d, ((0, 0), (0, slots * slot_cols - source.count)),
                constant_values=jnp.inf)
    d4 = d.reshape(nc, slots, slot_cols // ps.LANES, ps.LANES)
    top2 = -jax.lax.top_k(-jnp.moveaxis(d4, 2, 3), 2)[0]  # [nc, S, 128, 2]
    best = np.asarray(top2[..., 0]).reshape(nc, -1)
    second = np.asarray(top2[..., 1]).reshape(nc, -1)
    ref_i = np.asarray(jnp.argmin(d4, axis=2))  # [nc, S, 128]
    ref_col = (np.arange(slots)[None, :, None] * slot_cols
               + ref_i * ps.LANES + np.arange(ps.LANES)[None, None, :])
    got_d = np.asarray(got_d)
    real = np.isfinite(best)  # classes holding at least one corpus row
    if not np.array_equal(np.isfinite(got_d), real):
        raise AssertionError("fused fold: padding classes differ")
    err = float(np.max(np.abs(got_d[real] - best[real])))
    with np.errstate(invalid="ignore"):  # inf - inf in one-row classes
        sure = real & ~(second - best <= 1e-3)  # best and second best apart
    same = np.asarray(got_i)[sure] == ref_col.reshape(nc, -1)[sure]
    log(f"kernel folded_scan vs reference ({nc} queries): max |d| error "
        f"{err:.2e} over {real.sum()} classes, ids equal on "
        f"{same.mean():.6f} of {sure.sum()} classes with a gap > 1e-3")
    if not err <= 1e-3 or not same.all():
        raise AssertionError("fused fold disagrees with its reference")
    del d, d4, top2

    # end to end: the fast scan three ways.  The kernel replaces the plain
    # XLA fold (same classes, same bf16 operands); the exhaustive scan is a
    # different algorithm with its own top-k cost and recall.
    from unittest import mock

    from parallel_hnsw.analysis import brute_force_knn, fast_flat_knn
    from parallel_hnsw.graph import DenseSource

    def e2e(src, gt, label, mode):
        (ids, _), t = timed(lambda: fast_flat_knn(src, queries, metric, K,
                                                  scan_mode=mode), repeats=3)
        log(f"fast_flat_knn rows={src.count} {label}: recall@10="
            f"{recall_at(ids, gt):.4f} qps={queries.shape[0] / t:.0f} "
            f"({t:.4f}s median of 3)")

    for rows in (200_000, source.count):
        src = DenseSource(vectors=source.vectors[:rows])
        gt, _ = brute_force_knn(src, queries, metric, K)
        e2e(src, gt, "exhaustive scan", "exhaustive")
        e2e(src, gt, "fold, kernel route", "folded")
        # the same fold on the plain XLA route (chunked_folded_scan)
        jax.clear_caches()
        with mock.patch.object(ps, "scan_route", lambda platform: "xla"):
            e2e(src, gt, "fold, plain XLA route", "folded")
        jax.clear_caches()

    plain = jax.jit(ps.chunked_folded_scan,
                    static_argnames=("metric", "tile_c", "n_slots"))
    for rows in (100_000, source.count):
        yy = y16[:rows]
        _, t_k = timed(lambda: fold(q16, yy, metric, tile_c=tile_c,
                                    n_slots=n_slots), repeats=5)
        _, t_x = timed(lambda: plain(q16, yy, metric, tile_c=tile_c,
                                     n_slots=n_slots), repeats=5)
        flops = 2.0 * nq * yy.shape[0] * DIM
        log(f"kernel folded_scan Q={nq} C={yy.shape[0]}: triton {t_k * 1e3:.3f}ms "
            f"({flops / t_k / 1e12:.1f} TFLOP/s), plain XLA chunked fold "
            f"{t_x * 1e3:.3f}ms ({flops / t_x / 1e12:.1f} TFLOP/s), "
            f"median of 5")

    # XLA's plain pairwise product at the full width, bf16 and f32 HIGHEST
    q32 = queries[:nq]
    for name, a, b, exact, peak in (
        ("bf16", q16, y16, False, 989e12),
        ("f32 HIGHEST", q32, source.vectors, True, 67e12),
    ):
        pw = jax.jit(lambda x, y: pairwise_distance(x, y, metric, exact=exact))
        out, t = timed(lambda: pw(a, b), repeats=3)
        del out
        flops = 2.0 * nq * source.count * DIM
        out_bytes = 4.0 * nq * source.count
        log(f"xla pairwise_distance {name} [{nq},{DIM}]x[{source.count},{DIM}]: "
            f"{t * 1e3:.3f}ms, {flops / t / 1e12:.1f} TFLOP/s = "
            f"{flops / t / peak:.3f} of the {peak / 1e12:.0f} TFLOP/s peak; "
            f"output write {out_bytes / t / 1e12:.2f} TB/s = "
            f"{out_bytes / t / 3.35e12:.3f} of 3.35 TB/s")


def phase_pq(seed: int, n: int = 100_000):
    from parallel_hnsw.analysis import brute_force_knn
    from parallel_hnsw.ops.distance import Metric
    from parallel_hnsw.params import PqBuildParams
    from parallel_hnsw.pq import QuantizedHnsw
    from parallel_hnsw.utils.data import clustered_corpus

    import jax

    dim = 96
    allv = clustered_corpus(n + 1000, dim, seed=seed + 1).vectors
    from parallel_hnsw.graph import DenseSource

    source, queries = DenseSource(vectors=allv[:n]), allv[n:]
    t0 = time.perf_counter()
    index = QuantizedHnsw.new(4096, source, 4, Metric.EUCLIDEAN, PqBuildParams(),
                              seed=0, per_subspace=True, fast_quantize=True,
                              improve=False)
    build = time.perf_counter() - t0
    ids, dists = jax.block_until_ready(index.search(queries))
    gt, _ = brute_force_knn(source, queries, Metric.EUCLIDEAN, K)
    ids, dists = np.asarray(ids), np.asarray(dists)
    if ids.shape[0] != queries.shape[0] or not np.isfinite(dists[:, :K]).all():
        raise AssertionError("pq search returned a malformed result")
    log(f"pq: {n}x{dim} per-subspace 24x4096 build {build:.1f}s, search "
        f"recall@10={recall_at(ids, gt):.4f}")


def phase_sharded(rows: int, n_queries: int, seed: int, improve: bool,
                  clock: CompileClock):
    import jax

    from parallel_hnsw.ops.distance import Metric
    from parallel_hnsw.params import BuildParams
    from parallel_hnsw.parallel import ShardedHnsw, default_mesh

    mesh = default_mesh()
    source, queries = make_corpus(rows, n_queries, seed)
    with jax.default_device(jax.devices()[0]):
        gt, _ = ground_truth(source, queries)
    mark = clock.mark()
    t0 = time.perf_counter()
    sharded = ShardedHnsw.generate(source, mesh, BuildParams(), Metric.EUCLIDEAN,
                                   seed=0, improve=improve)
    jax.block_until_ready(sharded.layers_stacked[-1].neighbors)
    log(f"sharded build: {mesh.devices.size} x {rows // mesh.devices.size} rows "
        f"improve={improve} in {time.perf_counter() - t0:.1f}s")
    clock.report("sharded build", mark)
    for shard in sharded.source_stacked.vectors.addressable_shards:
        log(f"shard {shard.index[0].start} vectors {shard.data.shape} on "
            f"{shard.device}")
    sweep_ef("sharded search", lambda sp: sharded.search(queries, sp, k=K),
             sharded.build_parameters.optimization.search, gt, efs=EFS[1:])
    for fast in (False, True):
        (ids, _), secs = timed(lambda: sharded.search_exact(queries, k=K,
                                                            fast=fast))
        r = recall_at(ids, gt)
        log(f"sharded search_exact fast={fast}: recall@10={r:.4f} "
            f"qps={queries.shape[0] / secs:.0f} ({secs:.3f}s)")
        if r < (0.95 if fast else 0.999):
            raise AssertionError(f"sharded search_exact fast={fast} recall "
                                 f"{r:.4f} below its floor")
    for d in jax.devices():
        stats = d.memory_stats() or {}
        log(f"device {d.id} peak_bytes_in_use="
            f"{stats.get('peak_bytes_in_use', 'not reported')} "
            f"bytes_in_use={stats.get('bytes_in_use', 'not reported')}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, choices=(1, 4), default=1)
    p.add_argument("--improve", action="store_true",
                   help="run the improve loop in every graph build")
    args = p.parse_args()

    import jax

    devices = jax.devices()
    log(f"devices: {devices}")
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX reports platform {devices[0].platform!r}",
              file=sys.stderr)
        sys.exit(2)
    if len(devices) < args.devices:
        print(f"need {args.devices} GPUs, JAX reports {len(devices)}",
              file=sys.stderr)
        sys.exit(2)
    log(f"device_kind: {devices[0].device_kind}")
    log(f"nvidia-smi name, power.limit: {card_line()}")
    log(f"JAX {jax.__version__}, JAX_COMPILATION_CACHE_DIR="
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR')}")

    from parallel_hnsw.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    clock = CompileClock()
    t_start = time.perf_counter()

    if args.devices == 4:
        phase_sharded(ROWS, N_QUERIES, SEED, args.improve, clock)
    else:
        source, queries = make_corpus(ROWS, N_QUERIES, SEED)
        gt, _ = ground_truth(source, queries)
        index = phase_graph(source, queries, gt, args.improve, clock)
        phase_scan(index, source, queries, gt)
        phase_kernels(source, queries)
        phase_pq(SEED)
    log(f"total {time.perf_counter() - t_start:.1f}s (compile events "
        f"{clock.seconds:.1f}s, an upper bound)")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
