"""Fused replica-scan kernel tests (Pallas Triton route, interpret mode on CPU).

The kernel contract is the per-128-slot packed (min, argmin) key of the
scores ``norms - 2 q.dec``; it is tested against a numpy oracle. The top-k
wrapper is exact unless two true top-k fall in one tile, so it is compared
with the plain XLA scan (ops/scan.linear_scan_topk_decoded) at a realistic
tiles-per-k ratio, and with the exact f32 rescore against the ADC oracle.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from rii_tpu import PQ
from rii_tpu.models.ivf import code_norms_np
from rii_tpu.ops.decode import build_decoded_cache
from rii_tpu.ops.replica_scan import (
    _query_block,
    kernel_supports,
    replica_keys,
    replica_scan_topk,
)
from rii_tpu.ops.scan import _TILE, linear_scan_topk_decoded
from rii_tpu.utils.oracle import query_linear_oracle


def _index(n=2000, d=64, m=8, ks=32, cap=2048):
    rng = np.random.RandomState(3)
    x = rng.random((n, d)).astype(np.float32)
    pq = PQ(M=m, Ks=ks).fit(x)
    codes = pq.encode(x)
    codes_p = np.zeros((cap, m), np.uint8)
    codes_p[:n] = codes
    norms = np.full(cap, np.inf, np.float32)
    norms[:n] = code_norms_np(pq.codewords, codes)
    decoded = build_decoded_cache(jnp.asarray(codes_p),
                                  jnp.asarray(pq.codewords), block=cap)
    return x, pq, codes_p, norms, decoded


def _unpack(keys):
    bits = np.asarray(keys).view(np.int32)
    vmin = (bits & ~0x7F).view(np.float32)
    lane = bits & 0x7F
    return vmin, np.arange(keys.shape[1])[None, :] * _TILE + lane


@pytest.mark.parametrize("qn", [1, 8, 128, 600])
def test_replica_keys_match_tile_oracle(qn):
    """Each key holds its tile's min score (packed-key precision) and points
    at a slot whose score is that minimum up to bf16 near-ties."""
    x, pq, codes_p, norms, decoded = _index()
    rng = np.random.RandomState(qn)
    q = rng.random((qn, x.shape[1])).astype(np.float32)
    keys = replica_keys(jnp.asarray(q), decoded, jnp.asarray(norms),
                        interpret=True)
    assert keys.shape == (qn, len(norms) // _TILE)
    vmin, amin = _unpack(keys)
    dec = np.asarray(decoded, np.float32)
    qb = np.asarray(jnp.asarray(q).astype(jnp.bfloat16), np.float32)
    s = norms[None, :] - 2.0 * qb @ dec.T  # (Q, cap), +inf on padding
    ref = s.reshape(qn, -1, _TILE).min(axis=2)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(vmin[fin], ref[fin], rtol=1e-4, atol=1e-4)
    picked = np.take_along_axis(s, amin, axis=1)
    np.testing.assert_allclose(picked[fin], ref[fin], rtol=1e-4, atol=1e-4)
    assert (vmin[~fin] >= 2.9e38).all()  # padding tiles stay "infinite"


@pytest.mark.parametrize("qn", [1, 8, 128, 600])
@pytest.mark.parametrize("topk", [1, 10])
def test_replica_scan_topk_matches_xla(qn, topk):
    """Kernel and plain XLA scan agree: same ids up to tile collisions and
    near-ties, distances within the packed-key class."""
    x, pq, codes_p, norms, decoded = _index(n=8000, cap=8192)
    q = jnp.asarray(x[:qn] + 0.01)
    nr = jnp.asarray(norms)
    d_k, i_k = replica_scan_topk(q, decoded, nr, topk=topk,
                                 recall_target=None, interpret=True)
    d_x, i_x = linear_scan_topk_decoded(q, decoded, nr, topk=topk,
                                        block=2048)
    d_k, i_k, d_x, i_x = map(np.asarray, (d_k, i_k, d_x, i_x))
    assert d_k.shape == (qn, topk) and i_k.shape == (qn, topk)
    assert (i_k[:, 0] == i_x[:, 0]).mean() >= 0.97
    np.testing.assert_allclose(d_k[:, 0], d_x[:, 0], rtol=1e-3, atol=1e-3)
    # a kernel rank can only be worse than the exact scan's, never better
    assert (d_k >= d_x - 1e-3 * np.abs(d_x) - 1e-3).all()
    assert (np.diff(d_k, axis=1) >= 0).all()


@pytest.mark.parametrize("mask", ["none", "prefix", "random"])
def test_replica_scan_padding_and_masking(mask):
    """Padding slots are never selected; a subset mask folded into the norms
    as +inf keeps every result inside the subset."""
    x, pq, codes_p, norms, decoded = _index(n=300, cap=1024)
    keep = np.arange(len(norms)) < 300
    if mask == "prefix":
        keep &= np.arange(len(norms)) >= 150
    elif mask == "random":
        keep &= np.random.RandomState(5).random(len(norms)) < 0.3
    nr = np.where(keep, norms, np.inf).astype(np.float32)
    _, ids = replica_scan_topk(jnp.asarray(x[:8]), decoded, jnp.asarray(nr),
                               topk=2, interpret=True)
    ids = np.asarray(ids)
    assert (ids >= 0).all()
    assert keep[ids].all()


@pytest.mark.parametrize("qn", [1, 16])
def test_replica_scan_exact_rescore_matches_oracle(qn):
    """With the codes, returned distances are exact f32 ADC and the top-1 is
    the oracle's."""
    x, pq, codes_p, norms, decoded = _index()
    n = 2000
    q = x[:qn] + 0.01
    d, i = replica_scan_topk(jnp.asarray(q), decoded, jnp.asarray(norms),
                             topk=5, codes=jnp.asarray(codes_p),
                             codewords=jnp.asarray(pq.codewords),
                             interpret=True)
    d, i = np.asarray(d), np.asarray(i)
    for r in range(qn):
        ids_o, d_o = query_linear_oracle(q[r], 5, pq.codewords, codes_p[:n])
        assert i[r, 0] == ids_o[0]
        np.testing.assert_allclose(d[r, 0], d_o[0], rtol=1e-4)
        own = query_linear_oracle(q[r], n, pq.codewords, codes_p[:n])
        lut = dict(zip(own[0].tolist(), own[1].tolist()))
        np.testing.assert_allclose(d[r], [lut[k] for k in i[r]], rtol=1e-4)


@pytest.mark.parametrize("d,ok", [(8, False), (16, True), (96, False),
                                  (128, True), (200, False), (256, True)])
def test_kernel_supports_power_of_two_width(d, ok):
    assert kernel_supports(d) is ok


@pytest.mark.parametrize("qn,bq", [(1, 16), (16, 16), (17, 32), (100, 128),
                                   (1024, 128)])
def test_query_block_choice(qn, bq):
    assert _query_block(qn) == bq


def test_merge_packed_keys_min8_prereduce_big_q():
    """Big-Q merge: the min-8 pre-reduce (3 extra index bits) must return the
    exact top-k when the true top-k occupy distinct 1024-slot groups, and the
    packed id reconstruction (group, column, lane) must be exact."""
    from rii_tpu.ops.scan import _merge_packed_keys

    rng = np.random.RandomState(3)
    qn, nt, topk = 512, 4096, 10  # nt>=4096 + qn>=512 triggers the pre-reduce
    d = 4
    queries = np.zeros((qn, d), np.float32)  # qsq = 0: dists == scores
    scores = rng.uniform(1.0, 2.0, (qn, nt)).astype(np.float32)
    lanes = rng.randint(0, _TILE, (qn, nt)).astype(np.int32)
    # plant topk winners in DISTINCT groups of 8 tiles per query
    want_ids, want_vals = [], []
    for q in range(qn):
        groups = rng.choice(nt // 8, topk, replace=False)
        tiles = groups * 8 + rng.randint(0, 8, topk)
        vals = np.sort(rng.uniform(0.0, 0.5, topk)).astype(np.float32)
        scores[q, tiles] = vals
        want_ids.append(tiles * _TILE + lanes[q, tiles])
        want_vals.append(vals)
    bits = scores.view(np.int32)
    keys = ((bits & ~0x7F) | lanes).view(np.float32)
    dists, ids = _merge_packed_keys(jnp.asarray(queries), jnp.asarray(keys),
                                    topk, recall_target=0.99)
    dists, ids = np.asarray(dists), np.asarray(ids)
    for q in range(qn):
        assert set(ids[q].tolist()) == set(np.asarray(want_ids[q]).tolist()), q
        np.testing.assert_allclose(dists[q], want_vals[q], rtol=2e-4)
