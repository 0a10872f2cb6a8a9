"""Fused bf16 replica scan for NVIDIA GPUs (Pallas, Triton route).

The XLA linear scan over the decoded replica (ops/scan.linear_scan_topk_decoded)
writes a (Q, block) f32 score matrix to device memory and then runs a top-k
over it: at Q=1024 and N=1M that is 4 GB of scores against a 256 MB replica.
This kernel keeps the scores in registers. Each program loads a (BQ, D) query
tile and walks 128-row tiles of the row-major (cap, D) bf16 replica:

    cross (BQ, 128) = q_tile @ dec_tile^T          [tensor cores, f32 acc]
    scores          = norms_tile - 2 * cross
    key (BQ,)       = min over the tile of the packed (score, lane) key

so only Q x N/128 f32 keys (32 MB at the shape above) reach device memory.
The packed key replaces the low 7 mantissa bits of the f32 score by the
in-tile lane: bit-clearing is monotone on each sign half and the 127-ulp lane
never crosses a 128-ulp bucket, so one min yields both the tile minimum (at
2^-16 relative precision) and its slot. The cross-tile merge and the exact
f32 rescore stay plain JAX (ops/scan._merge_packed_keys,
ops/scan._exact_rescore_codes).

A tile reports one candidate, so results match an exact top-k unless two of
the true top-k share a 128-slot tile: the same accuracy class as
``lax.approx_max_k(recall_target~=0.99)``; the overfetched exact rescore
repairs it within the pool.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from rii_tpu.ops.scan import (
    _PACK_CLAMP,
    _TILE,
    _exact_rescore_codes,
    _merge_packed_keys,
)

_TILES_PER_PROGRAM = 16  # 2048 replica rows per program
_MAX_GRID_Y = 65535      # CUDA limit on the second launch-grid dimension


def kernel_supports(d):
    """The Triton route loads power-of-two tiles only: D must be one."""
    return d >= 16 and d & (d - 1) == 0


def _query_block(qn):
    """Rows of the query tile: a power of two in [16, 128] (tensor-core M)."""
    bq = 16
    while bq < min(qn, 128):
        bq *= 2
    return bq


def _keys_kernel(q_ref, dec_ref, nrm_ref, key_ref, *, tiles):
    q = q_ref[...]  # (BQ, D) bf16
    bq = q.shape[0]
    lane = lax.broadcasted_iota(jnp.int32, (bq, _TILE), 1)
    col = lax.broadcasted_iota(jnp.int32, (bq, tiles), 1)

    def body(t, acc):
        rows = pl.ds(t * _TILE, _TILE)
        dec = dec_ref[rows, :]  # (TILE, D) bf16
        cross = pl.dot(q, dec, trans_b=True)  # (BQ, TILE) f32
        scores = nrm_ref[rows][None, :] - 2.0 * cross
        bits = lax.bitcast_convert_type(
            jnp.minimum(scores, jnp.float32(_PACK_CLAMP)), jnp.int32)
        key = lax.bitcast_convert_type((bits & jnp.int32(~0x7F)) | lane,
                                       jnp.float32)
        # column t of the (BQ, tiles) key block, kept in registers
        return jnp.where(col == t, jnp.min(key, axis=1)[:, None], acc)

    key_ref[...] = lax.fori_loop(
        0, tiles, body, jnp.full((bq, tiles), _PACK_CLAMP, jnp.float32))


def replica_keys(queries, decoded, norms, interpret=False):
    """Packed per-128-slot min keys (Q, cap/128) f32 of the scores
    ``norms - 2 q.dec`` (without ||q||^2).

    queries: (Q, D) f32; decoded: (cap, D) bf16, cap % 128 == 0;
    norms: (cap,) f32, +inf on padded or masked slots.
    """
    cap, d = decoded.shape
    qn = queries.shape[0]
    assert cap % _TILE == 0 and kernel_supports(d), (cap, d)
    nt = cap // _TILE
    tiles = math.gcd(_TILES_PER_PROGRAM, nt)
    while nt // tiles > _MAX_GRID_Y:
        tiles *= 2
    assert nt % tiles == 0, (nt, tiles)
    bq = _query_block(qn)
    qp = -(-qn // bq) * bq
    qb = queries.astype(jnp.bfloat16)
    if qp != qn:
        qb = jnp.pad(qb, ((0, qp - qn), (0, 0)))
    keys = pl.pallas_call(
        partial(_keys_kernel, tiles=tiles),
        # query blocks vary fastest, so programs that share a replica chunk
        # run together and re-read it from L2
        grid=(qp // bq, nt // tiles),
        in_specs=[
            pl.BlockSpec((bq, d), lambda i, j: (i, 0)),
            pl.BlockSpec((tiles * _TILE, d), lambda i, j: (j, 0)),
            pl.BlockSpec((tiles * _TILE,), lambda i, j: (j,)),
        ],
        out_specs=pl.BlockSpec((bq, tiles), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((qp, nt), jnp.float32),
        compiler_params=pl_triton.CompilerParams(
            num_warps=8 if bq >= 128 else 4, num_stages=3),
        interpret=interpret,
        name="rii_replica_scan",
    )(qb, decoded, norms)
    return keys[:qn]


@partial(jax.jit, static_argnames=("topk", "recall_target", "overfetch",
                                   "interpret"))
def replica_scan_topk(queries, decoded, norms, topk, codes=None,
                      codewords=None, recall_target=0.99, overfetch=2,
                      interpret=False):
    """Linear scan of the bf16 replica through the fused kernel.

    Same contract as ops/scan.linear_scan_topk_decoded (fold a subset mask
    into `norms` as +inf). With `codes`/`codewords` the selection overfetches
    ``max(overfetch * topk, topk + 8)`` candidates and re-ranks them in exact
    f32 ADC, so returned distances are exact; without, distances carry the
    bf16 cross term at packed-key precision.

    Returns (dists (Q, topk) f32 ascending, ids (Q, topk) int32, -1 where
    exhausted).
    """
    keys = replica_keys(queries, decoded, norms, interpret=interpret)
    if codes is None:
        return _merge_packed_keys(queries, keys, topk, recall_target)
    k_fetch = min(max(topk * overfetch, topk + 8), keys.shape[1])
    _, ids_a = _merge_packed_keys(queries, keys, k_fetch, recall_target)
    return _exact_rescore_codes(queries, ids_a, codes, codewords, norms, topk)
