"""Linear ADC scans (the batched re-design of QueryLinear, /root/reference/src/rii.h:195-242).

Layout/masking conventions used throughout the framework:

- Stored code arrays are padded to a static capacity; padded slots carry
  ``code_norms = +inf`` so they can never enter a top-k. This removes all
  validity masks from the hot path (a distance is ``-2 q.x_hat + ||x_hat||^2``,
  and the inf norm poisons padded slots for free).
- ``topk`` and block sizes are static; query batches are padded by the caller.
- Distances returned are exact squared-L2-to-reconstruction == ADC distances.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from rii_tpu.ops.decode import onehot_decode, onehot_decode_exact

_PREC = lax.Precision.HIGHEST

_TILE = 128             # slots folded to one packed (score, lane) key
_PACK_CLAMP = 3.0e38    # +inf clamped finite so packing can't produce NaN
_PACK_RESTORE = 2.9e38  # restored to +inf after unpacking (padding mask)
# Batch size from which Rii.exact_rescore="auto" turns the exact rescore off
# and _merge_packed_keys pre-reduces 8 tiles per key. Not yet measured on the
# GPU (ROADMAP S2f): the value is carried over unchanged.
_BIG_Q = 512


def _select_topk(neg_scores, k, recall_target):
    """Per-block top-k selector.

    recall_target=None is an exact lax.top_k. Otherwise lax.approx_max_k at
    that per-block recall target; the cross-block merge stays exact. Off the
    platforms with a hardware partial-reduce (GPU and CPU included),
    approx_max_k lowers to an exact top-k, so results are exact there either
    way. Selection's share of the scan on the GPU is not measured yet
    (ROADMAP S2a).
    """
    if recall_target is None:
        return lax.top_k(neg_scores, k)
    return lax.approx_max_k(neg_scores, k, recall_target=recall_target)


def _block_scores(q, codes_b, norms_b, codewords, precision):
    """Scores (Q, B) for one code block, WITHOUT the per-query ||q||^2 constant.

    The ||q||^2 term is rank-irrelevant; it is added back once after the top-k.
    """
    dec = onehot_decode(codes_b, codewords, dtype=q.dtype, precision=precision)  # (B, D)
    cross = jnp.dot(q, dec.T, precision=precision)  # (Q, B)
    return norms_b[None, :] - 2.0 * cross


def _block_scores_decoded(q, dec_b, norms_b, precision):
    """Scores (Q, B) from a pre-decoded (bf16) block: one bf16 GEMM with
    f32 accumulation. Exact-ADC distances still come out because norms are
    the f32 ||decode(code)||^2 and only the cross term is bf16.
    """
    cross = jnp.dot(q.astype(dec_b.dtype), dec_b.T,
                    preferred_element_type=jnp.float32, precision=precision)
    return norms_b[None, :] - 2.0 * cross


@partial(jax.jit, static_argnames=("topk", "block", "precision", "recall_target"))
def linear_scan_topk(queries, codes, code_norms, codewords, topk, mask=None,
                     block=8192, precision=_PREC, recall_target=None):
    """Exact ADC scan of all stored codes, blocked with per-block top-k.

    Args:
        queries: (Q, D) f32.
        codes: (cap, M) uint8, cap % block == 0 (padded slots have inf norms).
        code_norms: (cap,) f32, +inf on padded slots.
        codewords: (M, Ks, Ds) f32.
        topk: static k.
        mask: optional (cap,) bool; False rows are excluded (subset search).

    Returns:
        (dists (Q, topk) f32 ascending, ids (Q, topk) int32; -1 where exhausted).
    """
    cap = codes.shape[0]
    assert cap % block == 0, (cap, block)
    nb = cap // block
    q = queries.astype(jnp.float32)
    qsq = jnp.sum(q * q, axis=-1)  # (Q,)

    norms = jnp.where(mask, code_norms, jnp.inf) if mask is not None else code_norms
    codes_blocks = codes.reshape(nb, block, -1)
    norms_blocks = norms.reshape(nb, block)
    k_eff = min(topk, block)

    def block_fn(args):
        codes_b, norms_b, base = args
        s = _block_scores(q, codes_b, norms_b, codewords, precision)
        neg, idx = _select_topk(-s, k_eff, recall_target)  # (Q, k_eff)
        return neg, idx + base

    bases = jnp.arange(nb, dtype=jnp.int32) * block
    negs, idxs = lax.map(block_fn, (codes_blocks, norms_blocks, bases))
    # (nb, Q, k_eff) -> (Q, nb * k_eff) -> final exact top-k merge.
    negs = jnp.swapaxes(negs, 0, 1).reshape(q.shape[0], nb * k_eff)
    idxs = jnp.swapaxes(idxs, 0, 1).reshape(q.shape[0], nb * k_eff)
    neg_top, pos = lax.top_k(negs, topk)
    ids = jnp.take_along_axis(idxs, pos, axis=1)
    dists = -neg_top + qsq[:, None]
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids


@partial(jax.jit, static_argnames=("topk", "block", "precision",
                                   "recall_target", "overfetch"))
def linear_scan_topk_decoded(queries, decoded, code_norms, topk, codes=None,
                             codewords=None, mask=None, block=8192,
                             precision=_PREC, recall_target=None, overfetch=2):
    """Exact ADC scan over the decoded bf16 replica (plain XLA).

    Same contract as :func:`linear_scan_topk`; `decoded` is (cap, D) bf16 with
    arbitrary values on padded slots (their inf norms exclude them). With
    `codes`/`codewords`, the bf16 selection overfetches `overfetch * topk`
    candidates and the final top-k is re-ranked in exact f32 ADC (the shared
    epilogue, :func:`_exact_rescore_codes`); without, distances carry the
    documented bf16 cross-term class. ops/replica_scan.replica_scan_topk is
    the fused GPU kernel with the same contract.
    """
    cap = decoded.shape[0]
    assert cap % block == 0, (cap, block)
    nb = cap // block
    q = queries.astype(jnp.float32)
    qsq = jnp.sum(q * q, axis=-1)

    norms = jnp.where(mask, code_norms, jnp.inf) if mask is not None else code_norms
    dec_blocks = decoded.reshape(nb, block, -1)
    norms_blocks = norms.reshape(nb, block)
    k_sel = topk if codes is None else max(topk * overfetch, topk + 8)
    k_eff = min(k_sel, block)

    def block_fn(args):
        dec_b, norms_b, base = args
        s = _block_scores_decoded(q, dec_b, norms_b, precision)
        neg, idx = _select_topk(-s, k_eff, recall_target)
        return neg, idx + base

    bases = jnp.arange(nb, dtype=jnp.int32) * block
    negs, idxs = lax.map(block_fn, (dec_blocks, norms_blocks, bases))
    negs = jnp.swapaxes(negs, 0, 1).reshape(q.shape[0], nb * k_eff)
    idxs = jnp.swapaxes(idxs, 0, 1).reshape(q.shape[0], nb * k_eff)
    if codes is not None:
        k_fetch = min(k_sel, nb * k_eff)
        neg_top, pos = lax.top_k(negs, k_fetch)
        ids_a = jnp.take_along_axis(idxs, pos, axis=1)
        # masked/padded slots carry +inf scores (-inf negs): keep excluded
        ids_a = jnp.where(jnp.isfinite(neg_top), ids_a, -1)
        return _exact_rescore_codes(q, ids_a, codes, codewords, norms, topk)
    neg_top, pos = lax.top_k(negs, topk)
    ids = jnp.take_along_axis(idxs, pos, axis=1)
    dists = -neg_top + qsq[:, None]
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids


@partial(jax.jit, static_argnames=("topk", "precision", "overfetch"))
def subset_scan_topk_decoded(queries, decoded, code_norms, target_ids, n_targets,
                             topk, codes=None, codewords=None, precision=_PREC,
                             overfetch=2):
    """Subset (small-S) scan over the decoded bf16 replica. With
    `codes`/`codewords`, the final top-k is overfetched and re-ranked in
    exact f32 ADC (see linear_scan_topk_decoded); selection-invalid entries
    (padding repeats with +inf norms) stay excluded via the -inf guard."""
    q = queries.astype(jnp.float32)
    qsq = jnp.sum(q * q, axis=-1)
    s_pad = target_ids.shape[0]
    valid = jnp.arange(s_pad, dtype=jnp.int32) < n_targets
    dec_s = jnp.take(decoded, target_ids, axis=0)
    norms_s = jnp.where(valid, jnp.take(code_norms, target_ids), jnp.inf)
    s = _block_scores_decoded(q, dec_s, norms_s, precision)
    k_sel = topk if codes is None else max(topk * overfetch, topk + 8)
    k_eff = min(k_sel, s_pad)
    neg, pos = lax.top_k(-s, k_eff)
    ids = jnp.take(target_ids, pos)
    if codes is not None:
        ids_a = jnp.where(jnp.isfinite(neg), ids, -1)
        # code_norms lookup suffices: invalid candidates are already -1
        return _exact_rescore_codes(q, ids_a, codes, codewords, code_norms,
                                    topk)
    dists = -neg + qsq[:, None]
    if k_eff < topk:
        pad = topk - k_eff
        dists = jnp.concatenate([dists, jnp.full((q.shape[0], pad), jnp.inf)], axis=1)
        ids = jnp.concatenate([ids, jnp.full((q.shape[0], pad), -1, ids.dtype)], axis=1)
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids


@partial(jax.jit, static_argnames=("topk", "precision"))
def subset_scan_topk(queries, codes, code_norms, codewords, target_ids, n_targets,
                     topk, precision=_PREC):
    """Exact ADC scan over an explicit id subset (small-S fast path).

    Equivalent to the reference's QueryLinear-with-target_ids
    (/root/reference/src/rii.h:218-228) but gathers the S candidate code rows
    and scores them as one dense block.

    Args:
        target_ids: (S_pad,) int32, padded by REPEATING valid ids (any values);
        n_targets: scalar int32 — number of valid leading entries.

    Returns:
        (dists (Q, topk) f32 ascending, ids (Q, topk) int32, -1 where exhausted).
    """
    q = queries.astype(jnp.float32)
    qsq = jnp.sum(q * q, axis=-1)
    s_pad = target_ids.shape[0]
    valid = jnp.arange(s_pad, dtype=jnp.int32) < n_targets

    codes_s = jnp.take(codes, target_ids, axis=0)  # (S_pad, M)
    norms_s = jnp.where(valid, jnp.take(code_norms, target_ids), jnp.inf)
    s = _block_scores(q, codes_s, norms_s, codewords, precision)  # (Q, S_pad)
    k_eff = min(topk, s_pad)
    neg, pos = lax.top_k(-s, k_eff)
    ids = jnp.take(target_ids, pos)
    dists = -neg + qsq[:, None]
    if k_eff < topk:  # pad out to the static topk width
        pad = topk - k_eff
        dists = jnp.concatenate([dists, jnp.full((q.shape[0], pad), jnp.inf)], axis=1)
        ids = jnp.concatenate([ids, jnp.full((q.shape[0], pad), -1, ids.dtype)], axis=1)
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids


def _merge_packed_keys(queries, keys, topk, recall_target):
    """Top-k directly over PACKED keys (order-preserving, so selecting min
    keys == selecting min scores), unpacking only the topk winners — skips
    materializing full-width (Q, nt) vmin/amin arrays.

    keys: (Q, nt) f32 packed (low 7 mantissa bits = in-tile lane), as the
    fused replica kernel (ops/replica_scan.py) writes them.

    Big-Q approx mode adds a MIN-8 PRE-REDUCE: 3 more mantissa bits (7..9)
    carry the in-group column, one vectorized min folds 8 tile keys into
    one group key, and the selection runs over nt/8 columns. Candidate
    granularity coarsens to one per 1024 slots (~2^-13-relative key
    precision) — inside the recall_target accuracy class, and disabled in
    exact mode (recall_target=None).
    """
    qn, nt = keys.shape
    qsq = jnp.sum(queries.astype(jnp.float32) ** 2, axis=-1)
    pre8 = (recall_target is not None and qn >= _BIG_Q
            and nt >= 4096 and nt % 8 == 0 and topk <= nt // 8)
    if pre8:
        b = lax.bitcast_convert_type(keys, jnp.int32).reshape(qn, nt // 8, 8)
        col = lax.broadcasted_iota(jnp.int32, (qn, nt // 8, 8), 2)
        key2 = (b & jnp.int32(~0x3FF)) | (col << 7) | (b & jnp.int32(0x7F))
        keys = jnp.min(lax.bitcast_convert_type(key2, jnp.float32), axis=2)
        nt = nt // 8
    k_eff = min(topk, nt)
    neg, pos = _select_topk(-keys, k_eff, recall_target)
    bits = lax.bitcast_convert_type(-neg, jnp.int32)  # (Q, k_eff) packed
    lane = bits & jnp.int32(0x7F)
    if pre8:
        colw = (bits >> 7) & jnp.int32(0x7)
        vmin = lax.bitcast_convert_type(bits & jnp.int32(~0x3FF), jnp.float32)
        ids = (pos * 8 + colw) * _TILE + lane
    else:
        vmin = lax.bitcast_convert_type(bits & jnp.int32(~0x7F), jnp.float32)
        ids = pos * _TILE + lane
    vmin = jnp.where(vmin >= jnp.float32(_PACK_RESTORE), jnp.inf, vmin)
    dists = vmin + qsq[:, None]
    if k_eff < topk:
        pad = topk - k_eff
        dists = jnp.concatenate([dists, jnp.full((qn, pad), jnp.inf)], axis=1)
        ids = jnp.concatenate([ids, jnp.full((qn, pad), -1, ids.dtype)], axis=1)
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids


def _exact_rescore_codes(queries, ids_a, codes, codewords, norms_vec, topk):
    """Exact-ADC f32 re-rank of overfetched candidates (the shared epilogue).

    ids_a: (Q, k_fetch) int32 candidate ids, -1 = invalid. The candidates'
    exact decoded rows are reconstructed from the uint8 codes via
    onehot_decode_exact (a bf16 one-hot with 0/1 entries contracted against
    f32 codewords, so the decode is exact) and re-scored in f32 at HIGHEST
    precision: returned distances are exact ADC (reference semantics,
    /root/reference/src/rii.h:375-394), and selection noise from a
    lower-precision scoring pass is repaired within the overfetched pool.
    norms_vec: (cap,) f32 ||decode||^2 lookup (+inf on padded/masked slots —
    invalid candidates stay excluded).
    """
    qn, k_fetch = ids_a.shape
    safe = jnp.maximum(ids_a, 0)
    cand_codes = jnp.take(codes, safe, axis=0)  # (Q, k_fetch, M)
    dec = onehot_decode_exact(cand_codes.reshape(qn * k_fetch, -1),
                              codewords).reshape(qn, k_fetch, -1)
    q = queries.astype(jnp.float32)
    cross = jnp.einsum("qkd,qd->qk", dec, q,
                       precision=lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
    norms_c = jnp.take(norms_vec, safe)
    qsq = jnp.sum(q * q, axis=1)
    exact = jnp.where(ids_a >= 0, norms_c - 2.0 * cross + qsq[:, None], jnp.inf)
    k_out = min(topk, exact.shape[1])
    neg, pos = lax.top_k(-exact, k_out)
    ids = jnp.take_along_axis(ids_a, pos, axis=1)
    dists = -neg
    if k_out < topk:  # tiny caps: fewer tiles than topk
        pad = topk - k_out
        dists = jnp.concatenate([dists, jnp.full((qn, pad), jnp.inf)], axis=1)
        ids = jnp.concatenate([ids, jnp.full((qn, pad), -1, ids.dtype)], axis=1)
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids
