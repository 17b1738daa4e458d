"""Measure the reference baseline on the host CPU via the C model.

Compiles native/ref_model.c (a single-core port of the Rust reference's build
and query pipeline — see its header for the semantics sources), dumps the SAME
corpus bench.py uses (random_unit_corpus seed 42), runs build + query
measurements, and prints the JSON lines the C binary emits.  These are the
host-CPU numbers behind bench.py's REF_SINGLE_CORE_* denominators.

Usage: python scripts/ref_c_bench.py [--count 10000] [--dim 100] [--mode all]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--count", type=int, default=10_000)
    p.add_argument("--dim", type=int, default=100)
    p.add_argument("--mode", choices=["build", "query", "all"], default="all")
    p.add_argument("--order", type=int, default=12)
    args = p.parse_args()

    # CPU-side corpus dump: this script never touches an accelerator
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from parallel_hnsw.utils.data import random_unit_corpus

    source = random_unit_corpus(args.count, args.dim, seed=42)
    corpus = np.asarray(source.vectors, dtype=np.float32)
    work = tempfile.mkdtemp(prefix="ref_model_")
    corpus_path = str(pathlib.Path(work) / "corpus.f32")
    corpus.tofile(corpus_path)

    binary = str(pathlib.Path(work) / "ref_model")
    subprocess.run(
        ["gcc", "-O3", "-march=native", "-o", binary,
         str(REPO / "native" / "ref_model.c"), "-lm"],
        check=True,
    )
    proc = subprocess.run(
        [binary, corpus_path, str(args.count), str(args.dim), args.mode,
         str(args.order)],
        stdout=sys.stdout,
        stderr=sys.stderr,
        check=True,
    )
    del proc


if __name__ == "__main__":
    main()
