"""Recall parity vs a NumPy oracle of the reference's EXACT IVF semantics.

rii-tpu's fixed-width window probing evaluates a superset of the reference's
candidate walk at equal L (ops/ivf.py docstring), so its recall must be >=
the oracle's for every L, full and subset queries alike. The linear oracle
additionally pins the ADC identity: engine linear distances == dtable ADC.
"""

import numpy as np
import pytest

from rii_tpu import PQ, Rii
from rii_tpu.utils.oracle import query_ivf_oracle, query_linear_oracle


def _clustered(n, d, n_clusters, seed, spread=0.15):
    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 1, (n_clusters, d)).astype(np.float32)
    assign = rng.randint(0, n_clusters, n)
    x = centers[assign] + spread * rng.normal(0, 1, (n, d)).astype(np.float32)
    return np.ascontiguousarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def setup():
    n, d = 8000, 32
    X = _clustered(n, d, 40, seed=3)
    rng = np.random.RandomState(4)
    pq = PQ(M=4, Ks=64).fit(X[rng.choice(n, 2000, replace=False)], iter=5)
    e = Rii(pq)
    e.add_configure(X, nlist=40, iter=5)
    queries = X[rng.choice(n, 24, replace=False)] \
        + 0.02 * rng.normal(0, 1, (24, d)).astype(np.float32)
    # exact f32 ground truth
    d2 = ((queries[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    gt10 = np.argsort(d2, axis=1)[:, :10]
    tids = np.sort(rng.choice(n, 1500, replace=False)).astype(np.int64)
    gt10_sub = np.asarray([
        tids[np.argsort(d2[i, tids], kind="stable")[:10]] for i in range(24)])
    return e, X, queries, gt10, tids, gt10_sub


def _recall_at10(ids_rows, gt_rows):
    return np.mean([
        len(set(np.asarray(a).tolist()) & set(np.asarray(b).tolist())) / 10
        for a, b in zip(ids_rows, gt_rows)])


def test_linear_oracle_adc_identity(setup):
    """Engine linear distances must equal the dtable-ADC oracle
    (the decoded-domain identity ADC(q,c) == ||q - decode(c)||^2).

    Clustered data gives many EXACTLY tied distances (duplicate PQ codes), so
    id-set equality is not well-defined; the contract is on distances: the
    top-k distance multiset matches, and every engine id's oracle-ADC
    distance is within the oracle's k-th distance."""
    e, X, queries, *_ = setup
    from rii_tpu.utils.oracle import adc_np, dtable_np
    codes = e.codes
    for i in range(4):
        ids_o, d_o = query_linear_oracle(queries[i], 10, e.codewords, codes)
        ids_e, d_e = e.query(queries[i], topk=10, method="linear")
        np.testing.assert_allclose(np.sort(d_e), np.sort(d_o), rtol=1e-4)
        d_e_oracle = adc_np(dtable_np(queries[i], e.codewords), codes[ids_e])
        assert (d_e_oracle <= d_o[-1] * (1 + 1e-4) + 1e-6).all()


@pytest.mark.parametrize("L_frac", [0.02, 0.05, 0.125])
def test_ivf_distance_dominance_over_oracle_full(setup, L_frac):
    """rii-tpu's probe set is a superset of the reference's candidate walk at
    equal L, so its i-th best ADC distance must be <= the oracle's for every
    i (the provable form of 'recall >= reference'; recall itself is compared
    statistically in benchmarks/recall_parity.py — a superset can reorder
    tied/near candidates either way vs the f32 ground truth)."""
    e, X, queries, gt10, tids, gt10_sub = setup
    L = max(10, int(L_frac * e.N))
    pl = e.posting_lists
    codes = e.codes
    engine_ids, engine_d = e.query_batch(queries, topk=10, L=L, method="ivf")
    for qi, q in enumerate(queries):
        _, d_o = query_ivf_oracle(q, 10, L, e.codewords, e.coarse_centers,
                                  pl, codes)
        k = len(d_o)
        assert (engine_d[qi, :k] <= d_o * (1 + 1e-4) + 1e-6).all(), (qi, L)


def test_exact_probes_cover_f32_walk_on_near_tie_centers():
    """Exact-mode probe selection must reproduce the reference's f32 bucket
    walk even when coarse-center distances tie within bf16 resolution.

    K-means centroids of UNIFORM data concentrate near the distribution mean,
    so all nlist center distances sit in a band narrower than bf16's ~0.4%
    eps; bf16 coarse scoring reorders probe RANKS there (measured: 2-7 of the
    f32 top-32 missing at 1024 kmeans-like centroids), so exact lax.top_k
    over bf16 scores could still drop a bucket the reference's f32 walk
    visits; _coarse_scores scores in f32 in exact mode for this reason."""
    import jax.numpy as jnp
    from rii_tpu.ops.ivf import _coarse_scores, _probe_topk

    rng = np.random.RandomState(0)
    nc, d, w = 1024, 128, 32
    # kmeans-like centroids: each the mean of ~1000 uniform points
    C = (0.5 + rng.normal(0, (1 / np.sqrt(12)) / np.sqrt(1000),
                          (nc, d))).astype(np.float32)
    q = rng.random((8, d)).astype(np.float32)
    cn = (C.astype(np.float64) ** 2).sum(1).astype(np.float32)

    s_exact = _coarse_scores(jnp.asarray(q), jnp.asarray(q, jnp.bfloat16),
                             jnp.asarray(C), jnp.asarray(cn), exact=True)
    probes = np.asarray(_probe_topk(s_exact, w, None))

    # f64 reference walk order; boundary ties are accepted either way
    s_ref = (cn.astype(np.float64)[None, :]
             - 2.0 * q.astype(np.float64) @ C.astype(np.float64).T)
    for i in range(len(q)):
        order = np.argsort(s_ref[i])
        boundary = s_ref[i][order[w - 1]]
        missing = set(order[:w].tolist()) - set(probes[i].tolist())
        for m in missing:
            assert s_ref[i][m] >= boundary - 1e-4 * abs(boundary), (i, m)

    # guard: this centroid shape genuinely exercises the near-tie regime —
    # bf16 scoring diverges from the f32 walk here (if it ever stops
    # diverging, the test is no longer testing anything; revisit the shape)
    s_b16 = _coarse_scores(jnp.asarray(q), jnp.asarray(q, jnp.bfloat16),
                           jnp.asarray(C), jnp.asarray(cn), exact=False)
    probes_b16 = np.asarray(_probe_topk(s_b16, w, None))
    n_miss = sum(
        len(set(np.argsort(s_ref[i])[:w].tolist())
            - set(probes_b16[i].tolist())) for i in range(len(q)))
    assert n_miss > 0


@pytest.mark.parametrize("L_frac", [0.05, 0.125])
def test_ivf_distance_dominance_over_oracle_subset(setup, L_frac):
    e, X, queries, gt10, tids, gt10_sub = setup
    L = max(10, int(L_frac * len(tids)))
    pl = e.posting_lists
    codes = e.codes
    engine_ids, engine_d = e.query_batch(queries, topk=10, L=L,
                                         target_ids=tids, method="ivf")
    for qi, q in enumerate(queries):
        _, d_o = query_ivf_oracle(q, 10, L, e.codewords, e.coarse_centers,
                                  pl, codes, target_ids=tids)
        k = len(d_o)
        assert (engine_d[qi, :k] <= d_o * (1 + 1e-4) + 1e-6).all(), (qi, L)
    for row in engine_ids:
        assert set(row[row >= 0].tolist()) <= set(tids.tolist())
