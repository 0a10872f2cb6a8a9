"""IVF probing scan (the batched re-design of QueryIvf, /root/reference/src/rii.h:244-326).

Differences from the reference, by design (SURVEY.md section 7, "hard parts"):

- Posting lists are stored as a *cluster-grouped* flat code array: codes are
  permuted so each cluster's members are contiguous (``bucket_start``/``order``),
  every bucket padded to a common static capacity window. Probing a cluster is a
  contiguous slice — one coalesced copy — instead of a ragged id walk.
- The reference's data-dependent early termination (stop at exactly L collected
  candidates, /root/reference/src/rii.h:302-309) does not map to SPMD. We score
  *all* members of the top-w probed clusters, with the same probe width
  ``w = round(L * nlist / N_or_S) + 3`` (src/rii.h:267-277). This evaluates >= the
  reference's candidate set, so recall is >= reference at equal L.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from rii_tpu.ops.decode import onehot_decode, onehot_decode_exact
from rii_tpu.ops.scan import _select_topk

_PREC = lax.Precision.HIGHEST


def _searchsorted_member(sorted_ids, n_valid, values):
    """True where `values` appears in sorted_ids[:n_valid]."""
    pos = jnp.searchsorted(sorted_ids, values)
    pos = jnp.clip(pos, 0, sorted_ids.shape[0] - 1)
    return (jnp.take(sorted_ids, pos) == values) & (pos < n_valid)


def _probe_topk(cscores, w, recall_target):
    """Probe selection: the w nearest (virtual) centers per query.

    Exact lax.top_k in exact mode (recall_target=None — preserves the
    provable probe-superset property, RECALL_PARITY.md), approx_max_k in the
    default fast mode (an exact top-k wherever the platform has no hardware
    partial-reduce; the merge stage is already approx in that mode, so the
    accuracy class is unchanged). NOTE a missed probe drops a whole bucket — a
    different failure class from bf16 selection noise (the exact rescore
    cannot recover it) — so the engine exposes ``Rii.probe_recall`` to force
    exact probes independently of the merge (measured impact:
    RECALL_PARITY.md probe A/B). Falls back to exact when w is too large a
    fraction of the row for the approx algorithm to pay off."""
    n = cscores.shape[-1]
    if recall_target is None or w * 8 > n:
        _, probe = lax.top_k(-cscores, w)
    else:
        _, probe = lax.approx_max_k(-cscores, w, recall_target=recall_target)
    return probe


def _coarse_scores(q_all, q16, centers_dec, centers_norms, exact):
    """Coarse ADC scores to the (virtual) centers: one small GEMM per batch.

    bf16 in the fast mode. f32 HIGHEST when probe selection is exact: on
    near-tie center-distance distributions (uniform data, where all nlist
    center distances sit in a band narrower than bf16's ~0.4% resolution)
    bf16 rounding reorders probe RANKS, so exact top_k over bf16 scores can
    still drop a bucket the reference's f32 walk visits — breaking the
    provable candidate-superset property the exact mode exists to provide
    (measured: exact-mode dominance 0.9938 on uniform N=1M before this fix,
    1.0 on clustered where center gaps exceed bf16 eps)."""
    if exact:
        return centers_norms[None, :] - 2.0 * jnp.dot(
            q_all, centers_dec.T.astype(jnp.float32), precision=_PREC,
            preferred_element_type=jnp.float32)
    return centers_norms[None, :] - 2.0 * jnp.dot(
        q16, centers_dec.T.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)


@partial(jax.jit, static_argnames=("w", "topk", "cap_u", "nlist_pad",
                                   "recall_target", "probe_recall",
                                   "overfetch", "codes_grouped"))
def ivf_union_scan_topk(queries, decoded_g, norms_g, order_g, centers_dec,
                        centers_norms, w, topk, cap_u, nlist_pad,
                        target_mask=None, recall_target=None, probes=None,
                        probe_recall="inherit", codes=None, codewords=None,
                        overfetch=2, codes_grouped=False):
    """Batched IVF probe via the UNION of the batch's probed buckets.

    The batched replacement for the reference's per-query posting-list walk
    (/root/reference/src/rii.h:244-326): instead of gathering candidate rows
    per query (random HBM access), the batch's w-nearest buckets are deduped
    into one sorted union and every union bucket — a contiguous (cap_u, D)
    block of the uniform grouped replica — is scored against ALL queries with
    one batched GEMM. Large contiguous copies, shared across the batch.

    Semantics vs the reference: each query's candidate set is the union of
    every bucket probed by ANY query in the batch (a superset of its own w
    probes), so recall >= the reference's at equal w/L. Distances are exact
    ADC (bf16 cross term). Duplicate union slots are masked so returned ids
    are unique.

    Args:
        queries: (Q, D) f32.
        decoded_g: (nlist_pad * cap_u, D) bf16 uniform grouped replica
            (models/ivf.py::build_uniform_layout).
        norms_g: (nlist_pad * cap_u,) f32, +inf on padding slots.
        order_g: (nlist_pad * cap_u,) int32 original ids, -1 on padding.
        centers_dec/centers_norms: (nlist_pad, D)/(nlist_pad,) decoded coarse
            centers, +inf norms on padded clusters.
        w: static probe width per query.
        cap_u/nlist_pad: static layout constants.
        target_mask: optional (nlist_pad * cap_u,) bool — False slots excluded
            (the subset-search filter, already mapped to grouped slots).
        probes: optional (flat (U,) int32 sorted window ids, dup (U,) bool/int
            duplicate-or-masked flags) — overrides steps (1)-(2); used by the
            sharded engine's deterministic global-probe selection.
        codes/codewords: optional; the final top-k is then re-ranked in
            exact f32 ADC from the uint8 codes of an overfetched pool.
            `codes` is the original-order (cap, M) array (rows addressed via
            order_g), or with codes_grouped=True the grouped (total, M)
            layout addressed by slot (the sharded engine's local store).

    Returns (dists (Q, topk) f32 ascending, ids (Q, topk) int32, -1 padded).
    """
    q_all = queries.astype(jnp.float32)
    qn = q_all.shape[0]
    d = q_all.shape[1]
    q16 = q_all.astype(jnp.bfloat16)

    if target_mask is not None:
        norms_g = jnp.where(target_mask, norms_g, jnp.inf)

    if probes is not None:
        flat, dup = probes
        flat = flat.astype(jnp.int32)
        dup = dup.astype(bool)
        u = flat.shape[0]
    else:
        # (1) coarse scoring + probe selection: one GEMM for the whole batch.
        pr = recall_target if probe_recall == "inherit" else probe_recall
        cscores = _coarse_scores(q_all, q16, centers_dec, centers_norms,
                                 exact=pr is None)
        probe = _probe_topk(cscores, w, pr)  # (Q, w)

        # (2) sorted, dup-masked union of probed buckets.
        if qn * w >= nlist_pad:
            u = nlist_pad
            flat = jnp.arange(nlist_pad, dtype=jnp.int32)
            dup = jnp.zeros((nlist_pad,), dtype=bool)
        else:
            u = qn * w
            flat = jnp.sort(probe.astype(jnp.int32).reshape(-1))
            dup = jnp.concatenate(
                [jnp.zeros((1,), bool), flat[1:] == flat[:-1]])

    # (3) chunked bucket-window scoring: gather whole buckets (contiguous
    # (cap_u, D) blocks) and run one (Uc*cap_u, D) x (D, Q) GEMM per chunk.
    # Chunk size bounds the (Uc, cap_u, Q) f32 score transient to ~64 MB.
    uc = max(1, min(u, (1 << 24) // max(1, cap_u * qn)))
    n_chunks = -(-u // uc)
    pad = n_chunks * uc - u
    if pad:
        flat = jnp.pad(flat, (0, pad), constant_values=nlist_pad - 1)
        dup = jnp.pad(dup, (0, pad), constant_values=True)

    dec3 = decoded_g.reshape(nlist_pad, cap_u, d)
    norms2 = norms_g.reshape(nlist_pad, cap_u)
    # per-chunk overfetch when an exact-codes rescore follows: with one chunk (the common small-union case) the final pool IS
    # the per-chunk pool, so the overfetch must happen here
    k_sel = topk if codes is None else max(topk * overfetch, topk + 8)
    k_eff = min(k_sel, uc * cap_u)

    def chunk_fn(args):
        fl, dp = args  # (uc,), (uc,)
        wins = jnp.take(dec3, fl, axis=0)  # (uc, cap_u, D) contiguous blocks
        nrm = jnp.take(norms2, fl, axis=0)  # (uc, cap_u)
        nrm = jnp.where(dp[:, None], jnp.inf, nrm)
        cross = jax.lax.dot_general(
            wins.reshape(uc * cap_u, d), q16.T,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)  # (uc*cap_u, Q)
        s = nrm.reshape(-1)[:, None] - 2.0 * cross  # (uc*cap_u, Q)
        neg, pos = _select_topk(-s.T, k_eff, recall_target)  # (Q, k_eff)
        slot = fl[pos // cap_u] * cap_u + (pos % cap_u)  # global grouped slot
        return neg, slot

    negs, slots = lax.map(chunk_fn, (flat.reshape(n_chunks, uc),
                                     dup.reshape(n_chunks, uc)))
    negs = jnp.swapaxes(negs, 0, 1).reshape(qn, n_chunks * k_eff)
    slots = jnp.swapaxes(slots, 0, 1).reshape(qn, n_chunks * k_eff)
    qsq = jnp.sum(q_all * q_all, axis=-1)
    if codes is not None:
        # exact f32 ADC re-rank of the overfetched pool
        k_fetch = min(k_sel, n_chunks * k_eff)
        neg_sel, pos = lax.top_k(negs, k_fetch)
        slot_top = jnp.take_along_axis(slots, pos, axis=1)
        rows = (slot_top if codes_grouped
                else jnp.take(order_g, jnp.maximum(slot_top, 0)))
        cand = jnp.take(codes, jnp.maximum(rows, 0), axis=0)
        dec_c = onehot_decode_exact(cand.reshape(qn * k_fetch, -1),
                                    codewords).reshape(qn, k_fetch, -1)
        cross = jnp.einsum("qkd,qd->qk", dec_c, q_all,
                           precision=lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
        nrm_c = jnp.take(norms_g, jnp.maximum(slot_top, 0))
        exact = nrm_c - 2.0 * cross + qsq[:, None]
        exact = jnp.where(jnp.isfinite(neg_sel), exact, jnp.inf)
        neg_top, pos2 = lax.top_k(-exact, min(topk, k_fetch))
        slot_top = jnp.take_along_axis(slot_top, pos2, axis=1)
        ids = jnp.take(order_g, slot_top)
        dists = -neg_top
    else:
        neg_top, pos = lax.top_k(negs, min(topk, n_chunks * k_eff))
        slot_top = jnp.take_along_axis(slots, pos, axis=1)
        ids = jnp.take(order_g, slot_top)
        dists = -neg_top + qsq[:, None]
    kk = dists.shape[1]
    if kk < topk:
        dists = jnp.concatenate(
            [dists, jnp.full((qn, topk - kk), jnp.inf)], axis=1)
        ids = jnp.concatenate(
            [ids, jnp.full((qn, topk - kk), -1, ids.dtype)], axis=1)
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids


@partial(jax.jit, static_argnames=("w", "topk", "cap_u", "nlist_pad",
                                   "recall_target", "probe_recall"))
def ivf_union_scan_topk_pq(queries, codes_g, norms_g, order_g, codewords,
                           centers_dec, centers_norms, w, topk, cap_u,
                           nlist_pad, target_mask=None, recall_target=None,
                           probes=None, probe_recall="inherit"):
    """Memory-lean union-bucket IVF over uint8 code windows (no replica).

    Same probe/union/merge scaffold as :func:`ivf_union_scan_topk`, but the
    stored windows are the raw (cap_u, M) uint8 PQ codes; each chunk is
    decoded in-flight with one-hot matmuls (ops/decode.onehot_decode)
    before the scoring GEMM. This is the IVF path for big-N deployments where
    the bf16 replica does not fit (e.g. SIFT1B-class shards): storage is
    N*M bytes + the grouped-layout padding.
    """
    q_all = queries.astype(jnp.float32)
    qn = q_all.shape[0]
    m = codes_g.shape[1]
    q16 = q_all.astype(jnp.bfloat16)

    if target_mask is not None:
        norms_g = jnp.where(target_mask, norms_g, jnp.inf)

    if probes is not None:
        flat, dup = probes
        flat = flat.astype(jnp.int32)
        dup = dup.astype(bool)
        u = flat.shape[0]
    else:
        pr = recall_target if probe_recall == "inherit" else probe_recall
        cscores = _coarse_scores(q_all, q16, centers_dec, centers_norms,
                                 exact=pr is None)
        probe = _probe_topk(cscores, w, pr)  # (Q, w)

        if qn * w >= nlist_pad:
            u = nlist_pad
            flat = jnp.arange(nlist_pad, dtype=jnp.int32)
            dup = jnp.zeros((nlist_pad,), dtype=bool)
        else:
            u = qn * w
            flat = jnp.sort(probe.astype(jnp.int32).reshape(-1))
            dup = jnp.concatenate(
                [jnp.zeros((1,), bool), flat[1:] == flat[:-1]])

    uc = max(1, min(u, (1 << 24) // max(1, cap_u * qn)))
    n_chunks = -(-u // uc)
    pad = n_chunks * uc - u
    if pad:
        flat = jnp.pad(flat, (0, pad), constant_values=nlist_pad - 1)
        dup = jnp.pad(dup, (0, pad), constant_values=True)

    codes3 = codes_g.reshape(nlist_pad, cap_u, m)
    norms2 = norms_g.reshape(nlist_pad, cap_u)
    k_eff = min(topk, uc * cap_u)

    # selection dtype: the XLA one-hot decode materializes (rows, M, Ks) in
    # HBM (~34 KB of traffic per candidate slot) and dominates this path; bf16
    # halves it. recall_target=None keeps f32 HIGHEST end-to-end (the
    # bit-exact mode); otherwise selection runs bf16 and the final top-k is
    # exactly rescored below, so returned distances are f32-exact either way.
    exact_sel = recall_target is None
    sel_dtype = jnp.float32 if exact_sel else jnp.bfloat16
    q_sel = q_all if exact_sel else q16

    def chunk_fn(args):
        fl, dp = args  # (uc,), (uc,)
        wins = jnp.take(codes3, fl, axis=0)  # (uc, cap_u, M) uint8
        nrm = jnp.take(norms2, fl, axis=0)  # (uc, cap_u)
        nrm = jnp.where(dp[:, None], jnp.inf, nrm)
        dec = onehot_decode(wins.reshape(uc * cap_u, m), codewords,
                            dtype=sel_dtype,
                            precision=_PREC if exact_sel else lax.Precision.DEFAULT)
        cross = jnp.dot(dec, q_sel.T,
                        precision=_PREC if exact_sel else lax.Precision.DEFAULT,
                        preferred_element_type=jnp.float32)
        s = nrm.reshape(-1)[:, None] - 2.0 * cross  # (uc*cap_u, Q)
        neg, pos = _select_topk(-s.T, k_eff, recall_target)  # (Q, k_eff)
        slot = fl[pos // cap_u] * cap_u + (pos % cap_u)
        return neg, slot

    negs, slots = lax.map(chunk_fn, (flat.reshape(n_chunks, uc),
                                     dup.reshape(n_chunks, uc)))
    negs = jnp.swapaxes(negs, 0, 1).reshape(qn, n_chunks * k_eff)
    slots = jnp.swapaxes(slots, 0, 1).reshape(qn, n_chunks * k_eff)
    neg_top, pos = lax.top_k(negs, min(topk, n_chunks * k_eff))
    slot_top = jnp.take_along_axis(slots, pos, axis=1)
    qsq = jnp.sum(q_all * q_all, axis=-1)
    if exact_sel:
        dists = -neg_top + qsq[:, None]
    else:
        # exact f32 rescore of the selected slots: decode their codes at
        # HIGHEST precision (Q * topk rows — negligible)
        kk_sel = slot_top.shape[1]
        safe = jnp.maximum(slot_top, 0)
        cand = jnp.take(codes_g, safe.reshape(-1), axis=0)  # (Q*kk, M)
        dec = onehot_decode(cand, codewords, dtype=jnp.float32,
                            precision=_PREC).reshape(qn, kk_sel, -1)
        cross = jnp.einsum("qkd,qd->qk", dec, q_all, precision=_PREC)
        nrm_c = jnp.take(norms_g, safe)
        exact = nrm_c - 2.0 * cross + qsq[:, None]
        exact = jnp.where(jnp.isfinite(-neg_top), exact, jnp.inf)
        neg2, pos2 = lax.top_k(-exact, kk_sel)
        slot_top = jnp.take_along_axis(slot_top, pos2, axis=1)
        dists = -neg2
    ids = jnp.take(order_g, slot_top)
    kk = dists.shape[1]
    if kk < topk:
        dists = jnp.concatenate(
            [dists, jnp.full((qn, topk - kk), jnp.inf)], axis=1)
        ids = jnp.concatenate(
            [ids, jnp.full((qn, topk - kk), -1, ids.dtype)], axis=1)
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids


@partial(jax.jit, static_argnames=("w", "topk", "cap_max", "chunk", "precision",
                                   "recall_target"))
def ivf_scan_topk_decoded(queries, decoded, centers_dec, centers_norms,
                          bucket_start, norms_grouped, order, slot_cluster,
                          w, topk, cap_max, target_ids=None, n_targets=None,
                          chunk=2048, precision=_PREC, recall_target=None):
    """Fully query-batched IVF probe over the bf16 decoded replica.

    Candidates are gathered as decoded rows (two-step gather: probe window slot
    -> original id -> replica row), so scoring is a batched matvec — no one-hot
    decode on the candidate path. Used when the engine keeps the bf16 replica.

    Args mirror :func:`ivf_scan_topk`, with `decoded` the (cap, D) bf16 replica
    in ORIGINAL id order (ids >= cap clip harmlessly to padded rows whose
    grouped norms are +inf).
    """
    q_all = queries.astype(jnp.float32)
    qn = q_all.shape[0]
    n_cand = w * cap_max
    chunk = min(chunk, n_cand)
    n_chunks = -(-n_cand // chunk)

    # (1) batched coarse scoring + probe selection: one GEMM for all queries
    # (probes are always exact top_k here; score f32 in exact mode so the
    # probed set matches the reference's f32 walk even on near-tie centers)
    cscores = _coarse_scores(q_all, q_all.astype(jnp.bfloat16), centers_dec,
                             centers_norms, exact=recall_target is None)
    _, probe = lax.top_k(-cscores, w)  # (Q, w)
    starts = jnp.take(bucket_start, probe)  # (Q, w)
    offs = jnp.arange(cap_max, dtype=jnp.int32)
    slots = (starts[:, :, None] + offs[None, None, :]).reshape(qn, n_cand)
    expect = jnp.broadcast_to(probe[:, :, None], (qn, w, cap_max)).reshape(qn, n_cand)
    pad = n_chunks * chunk - n_cand
    if pad:
        slots = jnp.pad(slots, ((0, 0), (0, pad)), constant_values=0)
        expect = jnp.pad(expect, ((0, 0), (0, pad)), constant_values=-2)

    q16 = q_all.astype(jnp.bfloat16)

    def chunk_fn(args):
        slots_c, expect_c = args  # (Q, chunk)
        valid = jnp.take(slot_cluster, slots_c) == expect_c
        ids_c = jnp.take(order, slots_c)  # (Q, chunk)
        norms_c = jnp.where(valid, jnp.take(norms_grouped, slots_c), jnp.inf)
        if target_ids is not None:
            member = _searchsorted_member(target_ids, n_targets, ids_c)
            norms_c = jnp.where(member, norms_c, jnp.inf)
        rows = jnp.take(decoded, jnp.maximum(ids_c, 0), axis=0)  # (Q, chunk, D)
        cross = jnp.einsum("qcd,qd->qc", rows, q16,
                           preferred_element_type=jnp.float32)
        s = norms_c - 2.0 * cross
        k_eff = min(topk, chunk)
        neg, pos = _select_topk(-s, k_eff, recall_target)
        return neg, jnp.take_along_axis(ids_c, pos, axis=1)

    slots_chunks = jnp.swapaxes(slots.reshape(qn, n_chunks, chunk), 0, 1)
    expect_chunks = jnp.swapaxes(expect.reshape(qn, n_chunks, chunk), 0, 1)
    negs, idsk = lax.map(chunk_fn, (slots_chunks, expect_chunks))
    k_eff = min(topk, chunk)
    negs = jnp.swapaxes(negs, 0, 1).reshape(qn, n_chunks * k_eff)
    idsk = jnp.swapaxes(idsk, 0, 1).reshape(qn, n_chunks * k_eff)
    neg_top, pos = lax.top_k(negs, min(topk, n_chunks * k_eff))
    ids = jnp.take_along_axis(idsk, pos, axis=1)
    qsq = jnp.sum(q_all * q_all, axis=-1)
    dists = -neg_top + qsq[:, None]
    kk = dists.shape[1]
    if kk < topk:
        dists = jnp.concatenate(
            [dists, jnp.full((qn, topk - kk), jnp.inf)], axis=1)
        ids = jnp.concatenate(
            [ids, jnp.full((qn, topk - kk), -1, ids.dtype)], axis=1)
    ids = jnp.where(jnp.isfinite(dists), ids, -1)
    return dists, ids


@partial(jax.jit, static_argnames=("w", "topk", "cap_max", "chunk", "precision",
                                   "recall_target"))
def ivf_scan_topk(queries, codewords, centers_dec, centers_norms, bucket_start,
                  codes_grouped, norms_grouped, order, slot_cluster, w, topk,
                  cap_max, target_ids=None, n_targets=None, chunk=4096,
                  precision=_PREC, recall_target=None):
    """Probe the w nearest coarse centers per query and ADC-score their members.

    Args:
        queries: (Q, D) f32.
        centers_dec: (nlist_pad, D) decoded coarse centers (f32).
        centers_norms: (nlist_pad,) ||center||^2, +inf on padded clusters.
        bucket_start: (nlist_pad,) slot offset of each cluster's segment.
        codes_grouped/norms_grouped/order: cluster-grouped storage; padded slots
            have norms=+inf and order=-1. The array has >= cap_max slots of tail
            padding so every (start, cap_max) window is in bounds.
        w: static probe width.
        topk: static k.
        cap_max: static per-cluster window (>= longest bucket, incl. padding).
        target_ids: optional (S_pad,) int32 SORTED ascending (pad with anything
            >= the max valid id); n_targets: scalar count of valid entries.

    Returns:
        (dists (Q, topk) f32 ascending, ids (Q, topk) int32, -1 where exhausted).
    """
    q_all = queries.astype(jnp.float32)
    n_cand = w * cap_max
    chunk = min(chunk, n_cand)
    # Round candidate count up to a multiple of chunk via extra tail windows.
    n_chunks = -(-n_cand // chunk)

    def one_query(q):
        qsq = jnp.sum(q * q)
        # (1) coarse ADC scoring == L2 to decoded centers (exact identity).
        cscores = centers_norms - 2.0 * jnp.dot(centers_dec, q, precision=precision)
        _, probe = lax.top_k(-cscores, w)  # (w,)
        starts = jnp.take(bucket_start, probe)  # (w,)
        slots = (starts[:, None] + jnp.arange(cap_max, dtype=jnp.int32)[None, :]).reshape(-1)
        slots = jnp.pad(slots, (0, n_chunks * chunk - n_cand), constant_values=0)
        # each window slot must belong to the cluster it was probed for —
        # windows that overrun a short bucket are masked out here.
        expect = jnp.broadcast_to(probe[:, None], (w, cap_max)).reshape(-1)
        expect = jnp.pad(expect, (0, n_chunks * chunk - n_cand), constant_values=-2)

        def chunk_fn(args):
            slots_c, expect_c = args
            valid_c = jnp.take(slot_cluster, slots_c) == expect_c
            codes_c = jnp.take(codes_grouped, slots_c, axis=0)  # (chunk, M)
            norms_c = jnp.where(valid_c, jnp.take(norms_grouped, slots_c), jnp.inf)
            ids_c = jnp.take(order, slots_c)
            if target_ids is not None:
                member = _searchsorted_member(target_ids, n_targets, ids_c)
                norms_c = jnp.where(member, norms_c, jnp.inf)
            # scores = ||x_hat||^2 - 2 <q, x_hat>
            dec = onehot_decode(codes_c, codewords, dtype=jnp.float32,
                                precision=precision)
            s = norms_c - 2.0 * jnp.dot(dec, q, precision=precision)
            k_eff = min(topk, chunk)
            neg, pos = _select_topk(-s[None, :], k_eff, recall_target)
            return neg[0], jnp.take(ids_c, pos[0])

        slots_chunks = slots.reshape(n_chunks, chunk)
        expect_chunks = expect.reshape(n_chunks, chunk)
        negs, idsk = lax.map(chunk_fn, (slots_chunks, expect_chunks))
        k_eff = min(topk, chunk)
        negs = negs.reshape(n_chunks * k_eff)
        idsk = idsk.reshape(n_chunks * k_eff)
        neg_top, pos = lax.top_k(negs, min(topk, n_chunks * k_eff))
        ids = jnp.take(idsk, pos)
        dists = -neg_top + qsq
        kk = dists.shape[0]
        if kk < topk:
            dists = jnp.concatenate([dists, jnp.full((topk - kk,), jnp.inf)])
            ids = jnp.concatenate([ids, jnp.full((topk - kk,), -1, ids.dtype)])
        ids = jnp.where(jnp.isfinite(dists), ids, -1)
        return dists, ids

    return lax.map(one_query, q_all)
