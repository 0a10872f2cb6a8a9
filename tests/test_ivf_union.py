"""Union-bucket batched IVF scan (ops/ivf.py::ivf_union_scan_topk) on the
uniform grouped replica layout (models/ivf.py::build_uniform_layout).

Runs on CPU with scan_mode forced to "bf16" so the union path over the bf16
window replica (the GPU default) is exercised; selection is exact on CPU
(approx_max_k lowers to a sort).
"""

import numpy as np
import pytest

from rii_tpu import PQ, Rii
from rii_tpu.models.ivf import build_virtual_layout, code_norms_np


@pytest.fixture(scope="module")
def engine():
    rng = np.random.RandomState(42)
    N, D = 4000, 32
    X = rng.random((N, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32, verbose=False).fit(X[:1000], iter=3)
    e = Rii(pq)
    e.scan_mode = "bf16"
    e.add_configure(X, nlist=60, iter=3)
    return e, X


def test_virtual_layout_invariants(engine):
    e, X = engine
    codes = e.codes
    norms = code_norms_np(e.codewords, codes)
    assign = e._assignments()
    ul = build_virtual_layout(codes, norms, assign, e.nlist, cap_v=64)
    order = ul["order"]
    cap_v = ul["cap_v"]
    vreal = ul["vreal"]
    assert ul["total"] == ul["nlist_v_pad"] * cap_v
    # every id appears exactly once
    valid = order[order >= 0]
    assert sorted(valid.tolist()) == list(range(e.N))
    # every virtual bucket's members belong to its real bucket, ascending;
    # a real bucket's members are contiguous across its consecutive chunks
    for v in range(ul["nlist_v"]):
        seg = order[v * cap_v:(v + 1) * cap_v]
        members = seg[seg >= 0]
        if len(members):
            assert (assign[members] == vreal[v]).all()
        if len(members) > 1:
            assert (np.diff(members) > 0).all()
    counts = np.bincount(assign[assign >= 0], minlength=e.nlist)
    expect_chunks = np.maximum(1, -(-counts // cap_v))
    assert ul["nlist_v"] == int(expect_chunks.sum())
    # padding slots are masked with +inf norms; padded virtual buckets have
    # vreal == -1
    assert np.isinf(ul["norms_grouped"][order < 0]).all()
    assert (vreal[ul["nlist_v"]:] == -1).all()


def test_union_path_active(engine):
    e, _ = engine
    dc = e._ensure_cache()
    assert "decoded_g" in dc and "order_g" in dc and "norms_g" in dc


def test_ivf_full_L_matches_linear(engine):
    e, X = engine
    q = X[11]
    ids_l, d_l = e.query(q, topk=10, method="linear")
    ids_i, d_i = e.query(q, topk=10, L=e.N, method="ivf")
    assert set(ids_i.tolist()) == set(ids_l.tolist())
    np.testing.assert_allclose(np.sort(d_i), np.sort(d_l), rtol=1e-5)


def test_ivf_batch_contracts(engine):
    e, X = engine
    rng = np.random.RandomState(7)
    qs = X[rng.choice(e.N, 9, replace=False)]  # odd batch -> padding path
    ids, dists = e.query_batch(qs, topk=7, method="ivf")
    assert ids.shape == (9, 7) and dists.shape == (9, 7)
    assert (np.diff(dists, axis=1) >= 0).all()
    for row in ids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)  # no duplicate ids


def test_ivf_duplicate_probes_no_duplicate_ids(engine):
    """Identical queries in one batch make every union bucket a duplicate."""
    e, X = engine
    qs = np.stack([X[5]] * 8)
    ids, dists = e.query_batch(qs, topk=10, method="ivf")
    for row in ids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)
    # all rows identical (same query)
    assert (ids == ids[0]).all()


def test_ivf_subset_matches_linear_subset(engine):
    e, X = engine
    rng = np.random.RandomState(3)
    tids = np.sort(rng.choice(e.N, 900, replace=False)).astype(np.int64)
    q = X[int(tids[4])]
    ids_i, d_i = e.query(q, topk=10, L=e.N, target_ids=tids, method="ivf")
    ids_l, d_l = e.query(q, topk=10, target_ids=tids, method="linear")
    assert set(ids_i.tolist()) <= set(tids.tolist())
    assert set(ids_i.tolist()) == set(ids_l.tolist())


def test_ivf_union_recall_superset_of_per_query(engine):
    """Batched union probing must find at least what a solo query finds."""
    e, X = engine
    rng = np.random.RandomState(9)
    pick = rng.choice(e.N, 6, replace=False)
    qs = X[pick] + rng.normal(0, 0.005, (6, X.shape[1])).astype(np.float32)
    d_solo = np.stack([e.query_batch(qs[i:i + 1], topk=5, method="ivf")[1][0]
                       for i in range(6)])
    _, d_b = e.query_batch(qs, topk=5, method="ivf")
    # the batch scans a candidate superset of each solo query's probes, so
    # batch top-5 distances dominate elementwise — at bf16-class tolerance:
    # per-candidate distances are exact f32 (rescore epilogue), but the
    # overfetched rescore POOL is still cut by the bf16 selection, and the
    # two runs cut their pools from different candidate sets, so the bf16
    # bias no longer cancels between them (the pre-rescore engine compared
    # bf16 to bf16, which is why 1e-4 used to pass)
    assert (d_b <= d_solo * (1 + 5e-3) + 1e-6).all()


def test_ivf_small_w_returns_valid(engine):
    e, _ = engine
    rng = np.random.RandomState(1)
    qs = rng.random((4, 32)).astype(np.float32)
    ids, dists = e.query_batch(qs, topk=3, L=e.L0, method="ivf")
    assert (ids >= 0).all()
    assert np.isfinite(dists).all()


def test_pq_mode_union_ivf_matches_linear():
    """scan_mode='pq' (no replica): the memory-lean union path must match the
    exact linear pq scan at L=N, including subsets."""
    rng = np.random.RandomState(21)
    N, D = 3000, 32
    X = rng.random((N, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32, verbose=False).fit(X[:1000], iter=3)
    e = Rii(pq)
    e.scan_mode = "pq"
    e.add_configure(X, nlist=50, iter=3)
    dc = e._ensure_cache()
    assert "codes_g" in dc and "decoded_g" not in dc

    q = X[17]
    ids_l, d_l = e.query(q, topk=10, method="linear")
    ids_i, d_i = e.query(q, topk=10, L=N, method="ivf")
    assert set(ids_i.tolist()) == set(ids_l.tolist())
    np.testing.assert_allclose(np.sort(d_i), np.sort(d_l), rtol=1e-5)

    tids = np.sort(rng.choice(N, 700, replace=False)).astype(np.int64)
    q2 = X[int(tids[0])]
    ids_s, _ = e.query(q2, topk=10, L=N, target_ids=tids, method="ivf")
    ids_sl, _ = e.query(q2, topk=10, target_ids=tids, method="linear")
    assert set(ids_s.tolist()) == set(ids_sl.tolist())


def test_pq_union_op_bf16_selection_exact_rescore():
    """Op-level: with a recall target the pq union selects in bf16 but returned
    distances are f32-exact (match the recall_target=None path per id)."""
    import jax.numpy as jnp
    from rii_tpu.ops.ivf import ivf_union_scan_topk_pq

    rng = np.random.RandomState(2)
    N, D = 3000, 32
    X = rng.random((N, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32, verbose=False).fit(X[:1000], iter=3)
    e = Rii(pq)
    e.scan_mode = "pq"
    e.add_configure(X, nlist=50, iter=3)
    dc = e._ensure_cache()
    qd = jnp.asarray(np.ascontiguousarray(X[rng.choice(N, 8, replace=False)]))
    args = (qd, dc["codes_g"], dc["norms_g"], dc["order_g"], dc["codewords"],
            dc["centers_dec_v"], dc["centers_norms_v"])
    kw = dict(w=8, topk=10, cap_u=dc["cap_v"], nlist_pad=dc["nlist_v_pad"])
    d_x, i_x = ivf_union_scan_topk_pq(*args, **kw, recall_target=None)
    d_b, i_b = ivf_union_scan_topk_pq(*args, **kw, recall_target=0.99)
    # distances for common ids must agree to f32 tolerance (exact rescore)
    for q in range(8):
        ax = dict(zip(np.asarray(i_x)[q].tolist(), np.asarray(d_x)[q].tolist()))
        for id_, dist in zip(np.asarray(i_b)[q].tolist(),
                             np.asarray(d_b)[q].tolist()):
            if id_ in ax and id_ >= 0:
                np.testing.assert_allclose(dist, ax[id_], rtol=1e-5)


def test_probe_recall_knob():
    """probe_recall=None forces exact probe selection independently of the
    approx merge (a missed probe drops a whole bucket — ADVICE r3). On CPU
    approx lowers to exact, so both settings must return identical results;
    the test pins that the knob threads through every union kernel tier."""
    import numpy as np
    from rii_tpu import PQ, Rii

    rng = np.random.RandomState(41)
    X = rng.random((3000, 32)).astype(np.float32)
    q = X[:8]
    for mode in ("bf16", "int8", "pq"):
        e = Rii(fine_quantizer=PQ(M=4, Ks=32).fit(X[:512], iter=3))
        e.scan_mode = mode
        e.add_configure(X, nlist=48, iter=3)
        ids_a, d_a = e.query_batch(q, topk=5, L=300, method="ivf")
        e.probe_recall = None
        e._bump()  # new jit key path only; cache layout unchanged
        ids_b, d_b = e.query_batch(q, topk=5, L=300, method="ivf")
        assert np.array_equal(ids_a, ids_b), mode
        np.testing.assert_allclose(d_a, d_b, rtol=0, atol=0)


@pytest.fixture(scope="module", params=["bf16", "pq"])
def clustered_engine(request):
    """Clustered data (so probing matters) under each window tier."""
    rng = np.random.RandomState(3)
    n, d, nc = 16000, 32, 40
    centers = rng.normal(0, 1, (nc, d)).astype(np.float32)
    X = np.ascontiguousarray(
        centers[rng.randint(0, nc, n)]
        + 0.15 * rng.normal(0, 1, (n, d)).astype(np.float32))
    pq = PQ(M=4, Ks=64).fit(X[rng.choice(n, 2000, replace=False)], iter=5)
    e = Rii(pq)
    e.scan_mode = request.param
    e.add_configure(X, nlist=nc, iter=5)
    dc = e._ensure_cache()
    assert ("decoded_g" in dc) == (request.param == "bf16")
    assert ("codes_g" in dc) == (request.param == "pq")
    queries = X[rng.choice(n, 6, replace=False)] \
        + 0.02 * rng.normal(0, 1, (6, d)).astype(np.float32)
    tids = np.sort(rng.choice(n, 6000, replace=False)).astype(np.int64)
    return e, queries, tids


@pytest.mark.parametrize("subset", [False, True])
def test_xla_union_ivf_matches_ivf_oracle(clustered_engine, subset,
                                          monkeypatch):
    """The plain-XLA union IVF (the GPU's IVF path) against the NumPy oracle
    of the reference walk, on the engine's own centers and posting lists:
    returned distances are the exact ADC of the returned ids, ranks are
    never worse than the oracle's, and subset results stay in the subset."""
    from rii_tpu.utils.oracle import adc_np, dtable_np, query_ivf_oracle

    e, queries, tids = clustered_engine
    t = tids if subset else None
    # the union path must really run (no widening to the linear scan)
    monkeypatch.setattr(e, "_query_linear_batch", None)
    codes, pl = e.codes, e.posting_lists
    L = 400
    for q in queries:
        ids, d = e.query(q, topk=10, L=L, target_ids=t, method="ivf")
        ids_o, d_o = query_ivf_oracle(q, 10, L, e.codewords,
                                      e.coarse_centers, pl, codes,
                                      target_ids=t)
        assert len(d_o) == 10 and (ids >= 0).all()
        np.testing.assert_allclose(
            d, adc_np(dtable_np(q, e.codewords), codes[ids]), rtol=1e-4)
        assert (d <= d_o * (1 + 1e-4) + 1e-6).all()
        if subset:
            assert set(ids.tolist()) <= set(tids.tolist())
