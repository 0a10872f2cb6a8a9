"""PQk-means tests: decoded-domain implementation vs a numpy oracle that follows
the reference algorithm literally (symmetric-distance LUTs + sparse voting,
/root/reference/src/pqkmeans.cpp). Same init (seeded random pick), so results
must agree up to floating-point ties.
"""

import numpy as np

from rii_tpu import PQ
from rii_tpu.models.pqkmeans import pqkmeans_fit, pqkmeans_predict


def _fixture(n=800, d=32, m=4, ks=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.random((n, d)).astype(np.float32)
    pq = PQ(M=m, Ks=ks).fit(x)
    codes = pq.encode(x)
    return pq.codewords, codes


def _distance_matrices(codewords):
    m, ks, _ = codewords.shape
    dm = np.zeros((m, ks, ks), dtype=np.float64)
    for mm in range(m):
        diff = codewords[mm][:, None, :] - codewords[mm][None, :, :]
        dm[mm] = (diff.astype(np.float64) ** 2).sum(-1)
    return dm


def _sym_dists(dm, codes, centers):
    """(N, K) symmetric distances via LUTs — the reference formulation."""
    n, m = codes.shape
    d = np.zeros((n, len(centers)), dtype=np.float64)
    for mm in range(m):
        d += dm[mm][codes[:, mm].astype(int)][:, centers[:, mm].astype(int)]
    return d


def _oracle_fit(codewords, codes, k, iters, seed):
    """Literal reference semantics: assign via LUT argmin; sparse-voting update;
    update skipped on last iteration; empty clusters keep their center."""
    m, ks, _ = codewords.shape
    dm = _distance_matrices(codewords)
    pick = np.random.RandomState(seed).permutation(len(codes))[:k]
    centers = codes[pick].astype(int)
    assign = None
    for it in range(iters):
        assign = _sym_dists(dm, codes, centers).argmin(1)
        if it == iters - 1:
            break
        new = centers.copy()
        for kk in range(k):
            sel = codes[assign == kk].astype(int)
            if len(sel) == 0:
                continue
            for mm in range(m):
                freq = np.bincount(sel[:, mm], minlength=ks).astype(np.float64)
                vote = freq @ dm[mm]
                new[kk, mm] = int(vote.argmin())
        centers = new
    return centers.astype(np.uint8), assign.astype(np.int32)


def test_symmetric_distance_equals_decoded_l2():
    """SymmetricDistance(c1, c2) == ||decode(c1) - decode(c2)||^2 (the identity
    the whole decoded-domain design rests on)."""
    cw, codes = _fixture()
    dm = _distance_matrices(cw)
    m = cw.shape[0]
    dec = cw[np.arange(m)[None, :], codes[:50].astype(int)].reshape(50, -1)
    lut = _sym_dists(dm, codes[:50], codes[:50])
    l2 = ((dec[:, None, :] - dec[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(lut, l2, rtol=1e-4, atol=1e-4)


def test_fit_matches_oracle():
    cw, codes = _fixture()
    k, iters, seed = 10, 5, 0
    centers, assign = pqkmeans_fit(cw, codes, k=k, iters=iters, seed=seed)
    centers_o, assign_o = _oracle_fit(cw, codes, k=k, iters=iters, seed=seed)
    # identical up to fp ties: demand near-total agreement
    agree = (assign == assign_o).mean()
    assert agree > 0.98, agree
    assert (centers == centers_o).mean() > 0.95


def test_fit_deterministic():
    cw, codes = _fixture()
    c1, a1 = pqkmeans_fit(cw, codes, k=8, iters=4, seed=3)
    c2, a2 = pqkmeans_fit(cw, codes, k=8, iters=4, seed=3)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)


def test_fit_reduces_objective():
    cw, codes = _fixture(n=1000)
    dm = _distance_matrices(cw)

    def objective(centers):
        return _sym_dists(dm, codes, centers.astype(int)).min(1).mean()

    c1, _ = pqkmeans_fit(cw, codes, k=16, iters=1, seed=0)  # init only
    c5, _ = pqkmeans_fit(cw, codes, k=16, iters=6, seed=0)
    assert objective(c5) < objective(c1)


def test_predict_matches_oracle():
    cw, codes = _fixture()
    centers, _ = pqkmeans_fit(cw, codes, k=12, iters=3, seed=1)
    pred = pqkmeans_predict(cw, centers, codes)
    dm = _distance_matrices(cw)
    pred_o = _sym_dists(dm, codes, centers.astype(int)).argmin(1)
    assert (pred == pred_o).mean() > 0.99


def test_predict_empty():
    cw, codes = _fixture()
    centers, _ = pqkmeans_fit(cw, codes, k=4, iters=2, seed=0)
    out = pqkmeans_predict(cw, centers, codes[:0])
    assert out.shape == (0,)
