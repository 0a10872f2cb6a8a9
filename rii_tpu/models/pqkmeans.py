"""PQk-means: k-means directly on PQ codes, re-derived as matmuls.

The reference (/root/reference/src/pqkmeans.cpp) clusters uint8 PQ codes with
(a) assignment by "symmetric distance" = sum of M lookups into precomputed
(Ks, Ks) codeword distance matrices, and (b) center update by "sparse voting"
over per-subspace frequency histograms.

Both steps have exact decoded-domain identities, which is how this module maps
them onto matmuls:

(a) SymmetricDistance(c1, c2) = sum_m ||cw_m[c1_m] - cw_m[c2_m]||^2
                              = ||decode(c1) - decode(c2)||^2
    -> assignment is a dense (B, D) x (D, K) GEMM + argmin.

(b) sparse voting: vote_m[j] = sum_{p in cluster} ||cw_m[p_m] - cw_m[j]||^2
                 = const - 2 <s_m, cw_m[j]> + n * ||cw_m[j]||^2
    where s_m = sum of the cluster's decoded sub-vectors. So the center update
    needs only per-cluster decoded sums (a segment-sum) and one
    (K, M, Ds) x (M, Ds, Ks) contraction + argmin — identical argmin result.

Semantics preserved from the reference:
- iters total passes; the center update is skipped on the last pass
  (src/pqkmeans.cpp:110-124), so returned assignments correspond to the
  returned centers.
- empty clusters keep their previous center code (src/pqkmeans.cpp:115-120).
- init = random pick of K distinct input codes with a fixed seed
  (src/pqkmeans.cpp:177-191); first-index tie-breaking via argmin.

Codes stay uint8 in memory; blocks are decoded on the fly (one-hot matmul), so
nothing is ever materialized at (N, D) scale.

Deterministic reduction structure: center statistics (decoded sums / counts)
are accumulated in a fixed two-level order — sequentially within each of
``_CANON_GROUPS`` contiguous block groups, then sequentially over the group
partials. The distributed fit (parallel/build.py) assigns whole groups to mesh
devices and combines the all-gathered group partials with the SAME sequential
combine, so a mesh reconfigure is bit-identical to the single-device one
whenever the device count divides _CANON_GROUPS (f32 addition is not
associative; identical structure, not just identical math, is required).
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from rii_tpu.ops.decode import onehot_decode

_PREC = lax.Precision.HIGHEST
_CANON_GROUPS = 8  # canonical reduction-group count (see module docstring)


def _pow2_at_least(n, lo):
    v = lo
    while v < n:
        v *= 2
    return v


def _assign_blocks(codewords, codes_blocks, weights_blocks, centers_codes, collect):
    """One assignment pass over all blocks.

    Returns (assigns (nb, B), errors (nb, B), sums (K, D), counts (K,)).
    sums/counts are zeros when collect=False.
    """
    k = centers_codes.shape[0]
    d = codewords.shape[0] * codewords.shape[2]
    centers_dec = onehot_decode(centers_codes, codewords)  # (K, D)
    csq = jnp.sum(centers_dec * centers_dec, axis=-1)  # (K,)

    def body(carry, args):
        sums, counts = carry
        codes_b, w_b = args
        dec_b = onehot_decode(codes_b, codewords)  # (B, D)
        bsq = jnp.sum(dec_b * dec_b, axis=-1)
        dist = csq[None, :] - 2.0 * jnp.dot(dec_b, centers_dec.T, precision=_PREC)
        a_b = jnp.argmin(dist, axis=-1).astype(jnp.int32)
        e_b = jnp.min(dist, axis=-1) + bsq
        if collect:
            sums = sums + jax.ops.segment_sum(dec_b * w_b[:, None], a_b, num_segments=k)
            counts = counts + jax.ops.segment_sum(w_b, a_b, num_segments=k)
        return (sums, counts), (a_b, e_b)

    init = (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32))
    (sums, counts), (assigns, errors) = lax.scan(body, init, (codes_blocks, weights_blocks))
    return assigns, errors, sums, counts


def _update_centers(codewords, centers_codes, sums, counts):
    """Sparse-voting center update in decoded space (exact argmin equivalence)."""
    m, ks, ds = codewords.shape
    k = centers_codes.shape[0]
    cnorms = jnp.sum(codewords * codewords, axis=-1)  # (M, Ks)
    sums_r = sums.reshape(k, m, ds)
    cross = jnp.einsum("kmd,mjd->kmj", sums_r, codewords, precision=_PREC)  # (K, M, Ks)
    score = counts[:, None, None] * cnorms[None, :, :] - 2.0 * cross
    new_codes = jnp.argmin(score, axis=-1).astype(jnp.int32)  # (K, M)
    return jnp.where(counts[:, None] > 0, new_codes, centers_codes)


def _group_stats(codewords, codes_gb, weights_gb, centers):
    """Per-group center stats: scan each group's blocks sequentially.

    codes_gb: (G, nb_l, B, M); returns (sums_g (G, K, D), counts_g (G, K)).
    """
    def g_body(_, args):
        cb, wb = args  # (nb_l, B, M), (nb_l, B)
        _, _, s, c = _assign_blocks(codewords, cb, wb, centers, collect=True)
        return 0, (s, c)

    _, (sums_g, counts_g) = lax.scan(g_body, 0, (codes_gb, weights_gb))
    return sums_g, counts_g


def _combine_group_stats(sums_g, counts_g):
    """Sequential (left-associated) sum over group partials — the ONE combine
    order shared by the single-device and mesh fits (bit-identity contract)."""
    def body(carry, x):
        s, c = carry
        sg, cg = x
        return (s + sg, c + cg), 0

    init = (jnp.zeros_like(sums_g[0]), jnp.zeros_like(counts_g[0]))
    (sums, counts), _ = lax.scan(body, init, (sums_g, counts_g))
    return sums, counts


def _assign_groups(codewords, codes_gb, weights_gb, centers):
    """Assignment-only pass over grouped blocks: (G, nb_l, B) assigns/errors."""
    def g_body(_, args):
        cb, wb = args
        a, e, _, _ = _assign_blocks(codewords, cb, wb, centers, collect=False)
        return 0, (a, e)

    _, (assigns, errors) = lax.scan(g_body, 0, (codes_gb, weights_gb))
    return assigns, errors


@partial(jax.jit, static_argnames=("iters",))
def _fit(codewords, codes_gb, weights_gb, centers0, iters):
    centers = centers0
    for _ in range(iters - 1):
        sums_g, counts_g = _group_stats(codewords, codes_gb, weights_gb, centers)
        sums, counts = _combine_group_stats(sums_g, counts_g)
        centers = _update_centers(codewords, centers, sums, counts)
    assigns, errors = _assign_groups(codewords, codes_gb, weights_gb, centers)
    return centers, assigns, errors


@jax.jit
def _predict(codewords, codes_blocks, centers_codes):
    # weights only matter for center updates (collect=True); assignment is
    # row-independent, so predict skips the (N,) f32 weights H2D entirely
    w = jnp.zeros(codes_blocks.shape[:2], jnp.float32)
    assigns, _, _, _ = _assign_blocks(
        codewords, codes_blocks, w, centers_codes, collect=False)
    if centers_codes.shape[0] <= 65535:
        # smallest-dtype D2H: uint16 halves the transfer; the caller widens
        # to int32 on host
        assigns = assigns.astype(jnp.uint16)
    return assigns


def _pad_blocks(codes, block, n_blocks=None, weights=True):
    """(N, M) -> codes_blocks (nb, B, M) int32, weights (nb, B) f32.

    Padding rows carry weight 0 (a +0.0 contribution leaves f32 sums bitwise
    unchanged); n_blocks forces extra all-padding blocks so nb is divisible by
    the group/device count. Codes ship as uint8 — one_hot consumes them
    directly, and int32 would cost 4x the H2D transfer. weights=False
    skips the weights upload (predict never reads them).
    """
    n, m = codes.shape
    nb = -(-n // block)
    if n_blocks is not None:
        assert n_blocks >= nb
        nb = n_blocks
    npad = nb * block
    cb = np.zeros((npad, m), dtype=np.uint8)
    cb[:n] = codes
    if not weights:
        return jnp.asarray(cb.reshape(nb, block, m)), None
    w = np.zeros((npad,), dtype=np.float32)
    w[:n] = 1.0
    return (jnp.asarray(cb.reshape(nb, block, m)),
            jnp.asarray(w.reshape(nb, block)))


def fit_layout(n, block=4096, groups=_CANON_GROUPS):
    """The (blk, nb) grouped-block layout for an n-row fit. Shared by the
    single-device fit and parallel/build.py's mesh fit (the layouts must be
    identical for the results to be)."""
    blk = min(block, _pow2_at_least(-(-n // groups), 32))
    nb_raw = -(-n // blk)
    nb = -(-nb_raw // groups) * groups
    return blk, nb


def pqkmeans_fit(codewords, codes, k, iters=5, seed=0, block=4096, verbose=False):
    """Cluster PQ codes into k centers (which are themselves PQ codes).

    Args:
        codewords: (M, Ks, Ds) float32 numpy/jax array.
        codes: (N, M) uint8 numpy array.
        k: number of clusters; k <= N required.
        iters: total passes (last pass assigns only, like the reference).
        seed: init seed (deterministic random pick of k input codes).

    Returns:
        (centers (k, M) uint8 numpy, assignments (N,) int32 numpy).
    """
    codes = np.asarray(codes)
    n = codes.shape[0]
    assert 1 <= k <= n, (k, n)
    assert iters >= 1
    pick = np.random.RandomState(seed).permutation(n)[:k]
    centers0 = jnp.asarray(codes[pick].astype(np.int32))
    cw = jnp.asarray(codewords, dtype=jnp.float32)
    g = _CANON_GROUPS
    blk, nb = fit_layout(n, block=block, groups=g)
    codes_blocks, weights_blocks = _pad_blocks(codes, blk, n_blocks=nb)
    codes_gb = codes_blocks.reshape(g, nb // g, blk, -1)
    weights_gb = weights_blocks.reshape(g, nb // g, blk)
    centers, assigns, errors = _fit(cw, codes_gb, weights_gb, centers0, int(iters))
    if verbose:
        err = float(np.asarray(errors).reshape(-1)[:n].mean())
        print(f"pqkmeans: k={k}, N={n}, iters={iters}, mean err {err:.6f}")
    return (np.asarray(centers, dtype=np.uint8),
            np.asarray(assigns).reshape(-1)[:n].astype(np.int32))


def predict_upload(codes, block=4096):
    """Dispatch the (async) H2D upload of the blocked codes for a later
    :func:`pqkmeans_predict_device` call. Reconfigure issues this BEFORE the
    clustering fit so the 256 MB-class transfer (N=32M, M=8) overlaps the
    fit's device time instead of serializing after it."""
    codes = np.asarray(codes)
    n = codes.shape[0]
    blk = min(block, _pow2_at_least(max(n, 1), 256))
    codes_blocks, _ = _pad_blocks(codes, blk, weights=False)
    return codes_blocks, n


def pqkmeans_predict_device(codewords, centers, codes_blocks, n):
    """Predict over pre-uploaded blocked codes (see predict_upload)."""
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    cw = jnp.asarray(codewords, dtype=jnp.float32)
    centers_j = jnp.asarray(np.asarray(centers).astype(np.int32))
    assigns = _predict(cw, codes_blocks, centers_j)
    return np.asarray(assigns).reshape(-1)[:n].astype(np.int32)


def pqkmeans_predict(codewords, centers, codes, block=4096):
    """Assign each PQ code to its nearest center (symmetric distance argmin).

    The batched equivalent of UpdatePostingLists' predict_one loop
    (/root/reference/src/rii.h:335-359).
    """
    codes_blocks, n = predict_upload(codes, block=block)
    return pqkmeans_predict_device(codewords, centers, codes_blocks, n)
