"""Benchmark harness for one NVIDIA GPU.

Default workload: the reference's own bench (benches/bench.rs:54-63): build a
graph over ~10k random 100-d unit vectors with the cosine metric, then measure
batched query throughput at the default operating point (ef=300).

Prints the device (JAX's platform, kind and count, and the card's name and
power limit from ``nvidia-smi``) on stderr, then ONE JSON line on stdout:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}.
Exits non-zero when JAX finds no GPU.

Other workloads: ``--mode pq`` (PQ codebook + code graph + rerank),
``--mode sharded`` (mesh-sharded search), ``--mode exact`` (exact flat scan),
``--dataset x.fvecs`` (a real dataset via the native loader).

``vs_baseline`` divides by REF_SINGLE_CORE_QPS, a host-CPU measurement:
native/ref_model.c is a single-core C port of the reference's build and query
pipeline (semantics sources in its header; the query path mirrors
tests/ref_model.py, which reproduces the reference's own golden search
expectations).  The C model is strictly faster per operation than the Rust
(binary heap vs a full visit-queue re-sort per pop, lib.rs:242-244;
generation-stamped arrays vs HashSet), so its throughput is an upper bound on
the reference's.  Run `python scripts/ref_c_bench.py` to reproduce.

Build throughput is timed on a SECOND build (same shapes, compiled programs
cached in process), so the recorded number measures the pipeline, not
compilation; the first build's time is reported alongside on stderr.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Host-CPU numbers (one core, native/ref_model.c via scripts/ref_c_bench.py),
# 10k x 100 cosine, reference defaults.  The reference's recall@10 saturates
# at 0.9246 at its ef=300 default (it never reaches the 0.95 floor on this
# workload), so its best-recall operating point IS the denominator.
REF_SINGLE_CORE_QPS = 580.3  # ef=300/pd=2, recall@10=0.9246 (its maximum)
REF_SINGLE_CORE_BUILD_VPS = 399.5  # full generate incl. per-rung improve


def device_info() -> dict:
    """JAX's device and the card's name and power limit; exits with code 2
    when JAX finds no GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX reports platform {devices[0].platform!r}",
              file=sys.stderr)
        raise SystemExit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": card,
    }
    print(f"# device: {info}", file=sys.stderr)
    return info


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--count", type=int, default=10_000)
    p.add_argument("--dim", type=int, default=100)
    p.add_argument(
        "--mode", choices=["dense", "pq", "sharded", "exact"], default="dense"
    )
    p.add_argument("--dataset", type=str, default=None, help="fvecs corpus path")
    p.add_argument(
        "--no-improve",
        dest="improve",
        action="store_false",
        help="skip improve_index / relink during build",
    )
    p.add_argument("--probe-depth", type=int, default=8)
    p.add_argument("--query-block", type=int, default=2048)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument(
        "--fixed-op",
        action="store_true",
        help="skip the operating-point selection and bench at the reference "
        "default (ef=300) only",
    )
    p.add_argument(
        "--recall-floor",
        type=float,
        default=0.95,
        help="recall@10 floor for the operating-point selection",
    )
    args = p.parse_args()

    device = device_info()

    from parallel_hnsw.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from parallel_hnsw.analysis import brute_force_knn
    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.ops.distance import Metric
    from parallel_hnsw.params import BuildParams
    from parallel_hnsw.utils.data import random_unit_corpus

    metric = Metric.NORMALIZED_COSINE
    if args.dataset:
        from parallel_hnsw.graph import DenseSource
        from parallel_hnsw.utils.datasets import read_vecs

        vecs = read_vecs(args.dataset, count=args.count if args.count else -1)
        source = DenseSource(vectors=jnp.asarray(vecs))
        args.count, args.dim = vecs.shape
        metric = Metric.EUCLIDEAN  # SIFT-style datasets are L2
    else:
        source = random_unit_corpus(args.count, args.dim, seed=42)
    bp = BuildParams()
    sp = bp.optimization.search.replace(probe_depth=args.probe_depth)
    queries = source.vectors

    if args.mode == "pq":
        from parallel_hnsw.params import PqBuildParams
        from parallel_hnsw.pq import QuantizedHnsw

        dsub = 4 if args.dim % 4 == 0 else 5
        t0 = time.time()
        index = QuantizedHnsw.new(
            min(4096, args.count), source, dsub, metric, PqBuildParams(),
            seed=0, exact_quantize=True,
        )
        build_s = time.time() - t0
        search_fn = lambda q: index.search(q, sp, exact_quantize=True)
        tag = f"PQ({index.quantizer.nsub}x{dsub})"
    elif args.mode == "sharded":
        from parallel_hnsw.parallel import ShardedHnsw, default_mesh

        t0 = time.time()
        index = ShardedHnsw.generate(source, default_mesh(), bp, metric, seed=0,
                                     improve=args.improve)
        build_s = time.time() - t0
        search_fn = lambda q: index.search(q, sp, k=sp.number_of_candidates)
        tag = f"sharded x{default_mesh().devices.size}"
    elif args.mode == "exact":
        build_s = float("nan")  # no index build
        search_fn = lambda q: brute_force_knn(source, q, metric, 10, args.query_block)
        tag = "exact scan"
    else:
        # the first build compiles every program; the SECOND build, at
        # identical bucketed shapes, measures the pipeline itself
        t0 = time.time()
        index = Hnsw.generate(source, None, bp, metric, seed=0, improve=args.improve)
        cold_s = time.time() - t0
        t0 = time.time()
        index = Hnsw.generate(source, None, bp, metric, seed=0, improve=args.improve)
        jax.block_until_ready(index.layers[-1].neighbors)
        build_s = time.time() - t0
        print(
            f"# build first (incl. compiles): {cold_s:.1f}s; second: {build_s:.1f}s",
            file=sys.stderr,
        )
        search_fn = lambda q: index.search(q, sp, query_block=args.query_block)
        tag = "dense"
    build_rate = args.count / build_s

    # ground truth for recall@10 on a query subsample
    q_eval = queries[: min(args.count, 10_000)]
    gt_ids, _ = brute_force_knn(source, q_eval, metric, 10)
    gt = np.asarray(gt_ids)

    def measure(fn):
        """(recall@10, QPS from the median of ``repeats`` timed calls, each
        ending in ``block_until_ready``) after one warm-up call."""
        ids, _ = jax.block_until_ready(fn(q_eval))
        got = np.asarray(ids[:, :10])
        inter = np.asarray(
            [len(np.intersect1d(got[i], gt[i])) for i in range(len(gt))]
        )
        recall = float(inter.mean() / 10.0)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(q_eval))
            times.append(time.perf_counter() - t0)
        return recall, len(gt) / float(np.median(times))

    recall_at_10, qps = measure(search_fn)

    if args.mode == "dense" and not args.fixed_op:
        # Operating-point selection: bench the graph at progressively cheaper
        # (ef, probe_depth) points and keep the fastest one that clears the
        # recall floor.  The ef=300 reference-default number above remains
        # the parity anchor.
        passing = []
        for ef, pd in ((100, 2), (60, 2), (40, 2), (24, 2), (16, 2), (12, 1), (10, 1)):
            sp_try = sp.replace(
                number_of_candidates=ef,
                upper_layer_candidate_count=min(ef, sp.upper_layer_candidate_count),
                probe_depth=pd,
            )
            r, q_ = measure(lambda qq: index.search(qq, sp_try, query_block=args.query_block))
            print(f"# op point ef={ef} pd={pd}: recall@10={r:.4f} qps={q_:.0f}",
                  file=sys.stderr)
            if r < args.recall_floor:
                break
            passing.append(sp_try)
            if q_ > qps:
                recall_at_10, qps, sp = r, q_, sp_try

        # Hop-slab variants at the cheapest passing points: f32 slabs
        # (byte-identical results) and bf16 routing rows + slabs (an exact
        # full-precision rerank restores ordering).  Keep whichever wins at
        # or above the recall floor.  Any failure is a failed benchmark.
        def try_variant(tag_name, enable):
            nonlocal recall_at_10, qps, sp, tag
            t0 = time.time()
            enable()
            print(f"# {tag_name} built in {time.time() - t0:.1f}s", file=sys.stderr)
            for sp_try in passing[-2:]:
                r, q_ = measure(
                    lambda qq: index.search(qq, sp_try, query_block=args.query_block)
                )
                print(
                    f"# {tag_name} op point ef={sp_try.number_of_candidates} "
                    f"pd={sp_try.probe_depth}: recall@10={r:.4f} qps={q_:.0f}",
                    file=sys.stderr,
                )
                if r >= args.recall_floor and q_ > qps:
                    recall_at_10, qps, sp = r, q_, sp_try
                    tag = tag_name

        try_variant("dense+slabs", index.enable_hop_slabs)
        try_variant(
            "dense+routed_slabs",
            lambda: (index.enable_routing(dr=None), index.enable_hop_slabs()),
        )
        if tag != "dense+routed_slabs":
            index.disable_routing()
            if tag == "dense+slabs":
                index.enable_hop_slabs()
            else:
                index.disable_hop_slabs()

    build_note = (
        "no build" if build_s != build_s else f"{build_s:.1f}s ({build_rate:.0f} vec/s)"
    )
    print(
        f"# build: {build_note} improve={args.improve}; recall@10={recall_at_10:.4f}",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": (
                    f"QPS/GPU, {tag} ({args.count}x{args.dim}, "
                    f"ef={sp.number_of_candidates}, recall@10={recall_at_10:.4f}"
                    + (
                        ""
                        if build_s != build_s
                        else f", build={build_rate:.0f} vec/s = "
                        f"{build_rate / REF_SINGLE_CORE_BUILD_VPS:.1f}x ref"
                    )
                    + ")"
                ),
                "value": round(qps, 1),
                "unit": "qps",
                "vs_baseline": round(qps / REF_SINGLE_CORE_QPS, 2),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
