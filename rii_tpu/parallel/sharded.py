"""Sharded kernels via shard_map: per-shard scan + all-gather top-k merge,
and a distributed PQk-means step (psum-reduced center statistics).

This replaces the reference's OpenMP parallel-for over database points
(/root/reference/src/rii.h:213, /root/reference/src/pqkmeans.cpp:88) with SPMD
over a device mesh: XLA inserts the collectives.
"""

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from rii_tpu.ops.decode import onehot_decode
from rii_tpu.ops.scan import linear_scan_topk
from rii_tpu.parallel.mesh import DATA_AXIS

_PREC = lax.Precision.HIGHEST


def make_sharded_linear_scan(mesh, topk, block=8192, axis_name=DATA_AXIS):
    """Build a jitted sharded linear ADC scan.

    Returned fn(queries, codes_sh, norms_sh, codewords) -> (dists, ids) with
    *global* ids; queries/codewords replicated, codes/norms row-sharded.
    Per-shard local top-k, then an all-gather of (ndev, Q, k) candidates and a
    replicated final top-k — the collective is O(ndev * Q * k), independent of N.
    """
    ndev = mesh.shape[axis_name]

    def _local(queries, codes_l, norms_l, codewords):
        shard_cap = codes_l.shape[0]
        blk = min(block, shard_cap)
        d_l, i_l = linear_scan_topk(
            queries, codes_l, norms_l, codewords, topk=topk, block=blk)
        my = lax.axis_index(axis_name)
        gids = jnp.where(i_l >= 0, i_l + my * shard_cap, -1)
        # gather all shards' candidates, merge with a replicated exact top-k
        d_all = lax.all_gather(d_l, axis_name)  # (ndev, Q, k)
        g_all = lax.all_gather(gids, axis_name)
        q_n = queries.shape[0]
        d_flat = jnp.swapaxes(d_all, 0, 1).reshape(q_n, ndev * topk)
        g_flat = jnp.swapaxes(g_all, 0, 1).reshape(q_n, ndev * topk)
        neg, pos = lax.top_k(-d_flat, topk)
        ids = jnp.take_along_axis(g_flat, pos, axis=1)
        return -neg, ids

    fn = shard_map(
        _local,
        mesh=mesh,
        in_specs=(P(), P(axis_name, None), P(axis_name), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_pqkmeans_step(mesh, k, axis_name=DATA_AXIS):
    """Build one distributed PQk-means iteration over row-sharded codes.

    fn(codes_sh (Ncap, M) int32, weights_sh (Ncap,), centers (k, M) int32,
       codewords) -> (new_centers (k, M) int32, assignments (Ncap,) int32)

    Assignment is computed per shard (decoded-domain GEMM + argmin); decoded
    cluster sums/counts are psum-reduced over the mesh; the sparse-voting
    center update runs replicated. Exactly the reference's iteration
    (/root/reference/src/pqkmeans.cpp:74-131) with OpenMP -> mesh + psum.
    """

    def _local(codes_l, weights_l, centers, codewords):
        centers_dec = onehot_decode(centers, codewords)  # (k, D)
        csq = jnp.sum(centers_dec * centers_dec, axis=-1)
        dec = onehot_decode(codes_l, codewords)  # (n_l, D)
        dist = csq[None, :] - 2.0 * jnp.dot(dec, centers_dec.T, precision=_PREC)
        assign_l = jnp.argmin(dist, axis=-1).astype(jnp.int32)
        sums_l = jax.ops.segment_sum(dec * weights_l[:, None], assign_l, num_segments=k)
        counts_l = jax.ops.segment_sum(weights_l, assign_l, num_segments=k)
        sums = lax.psum(sums_l, axis_name)  # (k, D) replicated
        counts = lax.psum(counts_l, axis_name)

        m, ks, ds = codewords.shape
        cnorms = jnp.sum(codewords * codewords, axis=-1)  # (M, Ks)
        cross = jnp.einsum("kmd,mjd->kmj", sums.reshape(k, m, ds), codewords,
                           precision=_PREC)
        score = counts[:, None, None] * cnorms[None, :, :] - 2.0 * cross
        new_codes = jnp.argmin(score, axis=-1).astype(jnp.int32)
        new_centers = jnp.where(counts[:, None] > 0, new_codes, centers)
        return new_centers, assign_l

    fn = shard_map(
        _local,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P(), P()),
        out_specs=(P(), P(axis_name)),
    )
    return jax.jit(fn)
