"""Batched Lloyd k-means in pure JAX.

Used for PQ codebook training: all M sub-space codebooks are trained *simultaneously*
via ``vmap`` (one k-means per subspace), so the whole fit is a single XLA program of
large matmuls instead of the reference's per-subspace scipy loops
(nanopq contract: SURVEY.md section 2.4).

Determinism: initialization is a fixed-key ``jax.random.permutation`` pick of data
points (the device analog of the reference's ``mt19937(0)`` shuffle-pick,
/root/reference/src/pqkmeans.cpp:177-191), so repeated fits with the same key are
bit-reproducible — a property the reference's test suite relies on (SURVEY.md section 4).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

# Distance/assignment matmuls use HIGHEST precision: codebook training happens once,
# and f32 matmuls keep parity with the reference's float accumulation.
_PREC = lax.Precision.HIGHEST


def _pairwise_sqdist(x, centers):
    """Squared L2 distances (N, K) between rows of x (N, D) and centers (K, D)."""
    xsq = jnp.sum(x * x, axis=-1, keepdims=True)  # (N, 1)
    csq = jnp.sum(centers * centers, axis=-1)  # (K,)
    cross = jnp.dot(x, centers.T, precision=_PREC)  # (N, K)
    return xsq - 2.0 * cross + csq[None, :]


def assign(x, centers):
    """Nearest-center assignment. Returns (assignments (N,), sq distances (N,))."""
    d = _pairwise_sqdist(x, centers)
    idx = jnp.argmin(d, axis=-1)
    return idx, jnp.take_along_axis(d, idx[:, None], axis=-1)[:, 0]


def _lloyd_step(x, centers):
    """One Lloyd iteration. Empty clusters keep their previous center."""
    k = centers.shape[0]
    idx, _ = assign(x, centers)
    onehot = jax.nn.one_hot(idx, k, dtype=x.dtype)  # (N, K)
    counts = jnp.sum(onehot, axis=0)  # (K,)
    sums = jnp.dot(onehot.T, x, precision=_PREC)  # (K, D)
    new_centers = jnp.where(
        counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], centers
    )
    return new_centers


@partial(jax.jit, static_argnames=("k", "iters"))
def kmeans_fit(key, x, k, iters=20):
    """Fit k-means on x (N, D) f32. Returns (centers (K, D), assignments (N,)).

    Init picks k distinct random rows (fixed key -> deterministic).
    """
    n = x.shape[0]
    pick = jax.random.permutation(key, n)[:k]
    centers0 = x[pick]

    def body(centers, _):
        return _lloyd_step(x, centers), None

    centers, _ = lax.scan(body, centers0, None, length=iters)
    idx, _ = assign(x, centers)
    return centers, idx


@partial(jax.jit, static_argnames=("k", "iters"))
def kmeans_fit_batched(key, x, k, iters=20):
    """Fit B independent k-means problems at once.

    x: (B, N, D) -> centers (B, K, D), assignments (B, N).
    This is how all M PQ sub-space codebooks are trained in one XLA program.
    """
    keys = jax.random.split(key, x.shape[0])
    return jax.vmap(lambda kk, xx: kmeans_fit(kk, xx, k=k, iters=iters))(keys, x)
