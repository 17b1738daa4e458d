"""Synthetic corpus generation (reference: src/bigvec.rs:9-65).

The reference generates per-vector seeded random unit vectors
(``StdRng::seed_from_u64(42 + i)``, src/bigvec.rs:26) with a normalized-cosine
comparator.  Here the corpus is one jitted ``jax.random`` program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from parallel_hnsw.graph import DenseSource


def random_unit_corpus(count: int, dim: int, seed: int = 42) -> DenseSource:
    """Uniform[-1,1) vectors normalized to unit length (src/bigvec.rs:59-65)."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.uniform(key, (count, dim), minval=-1.0, maxval=1.0)
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    return DenseSource(vectors=x.astype(jnp.float32))


def random_corpus(count: int, dim: int, seed: int = 42) -> DenseSource:
    """Unnormalized Uniform[-1,1) vectors (reference: random_vec,
    src/lib.rs:2443-2447, used by the euclidean test)."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.uniform(key, (count, dim), minval=-1.0, maxval=1.0)
    return DenseSource(vectors=x.astype(jnp.float32))


def clustered_corpus(
    count: int,
    dim: int,
    centers: int = 1024,
    sigma: float = 0.35,
    seed: int = 7,
    normalize: bool = False,
) -> DenseSource:
    """Mixture-of-Gaussians corpus: ``centers`` standard-normal centers,
    each row a random center plus ``sigma`` Gaussian noise.  A stand-in for
    real embedding datasets, which are clustered (uniform random vectors at
    96-128 dimensions have concentrated distances).  Rows are drawn in
    chunks of 500k, each chunk from its own folded key, so a prefix of the
    corpus does not depend on ``count``."""
    k_centers, k_noise = jax.random.split(jax.random.PRNGKey(seed))
    c = jax.random.normal(k_centers, (centers, dim), jnp.float32)
    if normalize:
        c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
    chunks = []
    per = 500_000
    for i in range(0, count, per):
        kk1, kk2, k_noise = jax.random.split(jax.random.fold_in(k_noise, i), 3)
        m = min(per, count - i)
        which = jax.random.randint(kk1, (m,), 0, centers)
        pts = c[which] + sigma * jax.random.normal(kk2, (m, dim), jnp.float32)
        if normalize:
            pts = pts / jnp.linalg.norm(pts, axis=-1, keepdims=True)
        chunks.append(pts)
    return DenseSource(vectors=jnp.concatenate(chunks))


def make_random_hnsw(count: int, dim: int, seed: int = 42, bp=None, **kw):
    """Convenience mirroring the reference's bigvec::make_random_hnsw
    (src/bigvec.rs:9-36): seeded random unit corpus + normalized-cosine build."""
    from parallel_hnsw.index import Hnsw
    from parallel_hnsw.ops.distance import Metric
    from parallel_hnsw.params import BuildParams

    source = random_unit_corpus(count, dim, seed)
    return Hnsw.generate(source, None, bp or BuildParams(), Metric.NORMALIZED_COSINE, **kw)
