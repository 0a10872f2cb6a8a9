"""Dynamic-growth behavior (BASELINE config 4, scaled down): add a large batch
post-build, query the stale index, reconfigure, query again."""

import numpy as np

from rii_tpu import PQ, Rii


def test_growth_then_reconfigure():
    rng = np.random.RandomState(11)
    D = 32
    X1 = rng.random((2000, D)).astype(np.float32)
    X2 = rng.random((4000, D)).astype(np.float32)
    e = Rii(fine_quantizer=PQ(M=4, Ks=32).fit(X1))
    e.add_configure(X1)
    nlist_before = e.nlist

    # stale-index phase: new codes join existing posting lists
    e.add(X2)  # auto -> update_posting_lists=True
    assert e.N == 6000
    assert e.nlist == nlist_before
    assert sum(len(pl) for pl in e.posting_lists) == 6000

    # new ids findable pre-reconfigure (ivf over stale lists)
    q = X2[123]
    ids, dists = e.query(q, topk=5, L=2000)
    assert 2000 + 123 in ids

    # reconfigure rebalances: nlist moves to sqrt(N)
    e.reconfigure()
    assert e.nlist == int(np.sqrt(6000))
    assert sum(len(pl) for pl in e.posting_lists) == 6000
    # at this coarse quantization (M=4) other codes may decode closer, so
    # check membership under an exact scan rather than rank-0 under ivf
    ids, dists = e.query(q, topk=5, method="linear")
    assert 2000 + 123 in ids


def test_add_without_update_is_invisible_to_ivf_until_reconfigure():
    rng = np.random.RandomState(12)
    X1 = rng.random((1000, 32)).astype(np.float32)
    X2 = rng.random((500, 32)).astype(np.float32)
    e = Rii(fine_quantizer=PQ(M=4, Ks=32).fit(X1))
    e.add_configure(X1, nlist=20)
    e.add(X2, update_posting_lists=False)
    assert e.N == 1500
    # posting lists still cover only the first 1000 (reference semantics)
    assert sum(len(pl) for pl in e.posting_lists) == 1000
    # linear scan sees everything
    ids, _ = e.query(X2[7], topk=3, method="linear")
    assert 1007 in ids
    # after reconfigure, ivf sees everything
    e.reconfigure(nlist=20)
    assert sum(len(pl) for pl in e.posting_lists) == 1500
    ids, _ = e.query(X2[7], topk=3, L=1500, method="ivf")
    assert 1007 in ids


def test_memory_breakdown_accounts_device_cache():
    rng = np.random.RandomState(15)
    X = rng.random((2000, 32)).astype(np.float32)
    e = Rii(fine_quantizer=PQ(M=4, Ks=32).fit(X[:512], iter=3))
    e.add_configure(X, nlist=20, iter=3)
    mb = e.memory_breakdown()
    assert mb["host_codes"] == 2000 * 4
    assert mb["host_assignments"] == 2000 * 4
    assert mb["device:codes_flat"] >= 2000 * 4  # padded capacity
    assert mb["device_total"] == sum(
        v for k, v in mb.items() if k.startswith("device:"))
    # mutation invalidates and rebuilds
    e.add(X[:100], update_posting_lists=True)
    mb2 = e.memory_breakdown()
    assert mb2["host_codes"] == 2100 * 4


def test_incremental_add_keeps_cache_and_matches_rebuild():
    """add() after a build must scatter into the live device cache (O(batch),
    the reference's AddCodes contract src/rii.h:158-193) and give the same
    results as a dropped-cache rebuild."""
    rng = np.random.RandomState(21)
    D = 32
    X1 = rng.random((3000, D)).astype(np.float32)
    X2 = rng.random((200, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32).fit(X1)
    e = Rii(pq)
    e.scan_mode = "bf16"
    e.topk_recall = None  # exact selection -> bit-comparable results
    e.add_configure(X1, nlist=40)
    dc_before = e._ensure_cache()
    ver_obj = id(dc_before)

    e.add(X2)  # auto -> update_posting_lists=True
    assert e._dc is not None, "incremental add must keep the device cache"
    assert id(e._dc) == ver_obj and e._dc["version"] == e._version
    assert e._dc["n_dev"] == 3200

    # reference engine: identical host state, cache rebuilt from scratch
    r = Rii(pq)
    r.scan_mode = "bf16"
    r.topk_recall = None
    r.add_configure(X1, nlist=40)
    r.add(X2)
    r._dc = None  # force the full rebuild path

    qs = np.ascontiguousarray(
        np.concatenate([X1[:4], X2[:4]]), dtype=np.float32)
    ids_e, d_e = e.query_batch(qs, topk=10, method="linear")
    ids_r, d_r = r.query_batch(qs, topk=10, method="linear")
    np.testing.assert_array_equal(ids_e, ids_r)
    np.testing.assert_allclose(d_e, d_r, rtol=0, atol=0)

    # IVF at L=N: full coverage on both layouts -> identical result sets
    ids_ei, d_ei = e.query_batch(qs, topk=10, L=e.N, method="ivf")
    ids_ri, d_ri = r.query_batch(qs, topk=10, L=r.N, method="ivf")
    for a, b in zip(ids_ei, ids_ri):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(np.sort(d_ei, 1), np.sort(d_ri, 1), rtol=1e-5)

    # partial-L IVF must find the new ids (they joined their posting lists)
    ids_p, _ = e.query_batch(X2[:8], topk=5, L=1000, method="ivf")
    hits = np.mean([3000 + i in ids_p[i] for i in range(8)])
    assert hits >= 0.75

    # posting-list property still reflects host truth
    assert sum(len(p) for p in e.posting_lists) == 3200


def test_incremental_add_overflow_falls_back_to_rebuild():
    """A batch larger than the spare capacity drops the cache (lazy rebuild)
    and stays correct."""
    rng = np.random.RandomState(22)
    D = 32
    X1 = rng.random((2000, D)).astype(np.float32)
    X2 = rng.random((3000, D)).astype(np.float32)  # >> headroom
    pq = PQ(M=4, Ks=32).fit(X1)
    e = Rii(pq)
    e.scan_mode = "bf16"
    e.add_configure(X1, nlist=30)
    e._ensure_cache()
    e.add(X2)
    # 3000 rows exceed both the pow2 cap (2048) and the window headroom
    assert e._dc is None
    ids, _ = e.query(X2[11], topk=3, method="linear")
    assert 2011 in ids


def test_incremental_add_without_update_invisible_to_ivf():
    """update_posting_lists=False rows join the linear structures only."""
    rng = np.random.RandomState(23)
    D = 32
    X1 = rng.random((3000, D)).astype(np.float32)
    X2 = rng.random((100, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32).fit(X1)
    e = Rii(pq)
    e.scan_mode = "bf16"
    e.add_configure(X1, nlist=40)
    e._ensure_cache()
    e.add(X2, update_posting_lists=False)
    assert e._dc is not None  # linear-only scatter keeps the cache
    ids, _ = e.query(X2[5], topk=3, method="linear")
    assert 3005 in ids
    assert sum(len(p) for p in e.posting_lists) == 3000


def test_incremental_add_pallas_cache_variants():
    """With the kernel hook on, the bf16 replica (scan_mode "bf16", or
    "int8" from older checkpoints) and the pq code windows take new rows by
    O(batch) scatters, and the fused kernel finds them."""
    import pytest as _pytest
    rng = np.random.RandomState(24)
    D = 32
    X1 = rng.random((3000, D)).astype(np.float32)
    X2 = rng.random((150, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32).fit(X1)
    for mode, key in (("bf16", "decoded_flat"), ("int8", "decoded_flat"),
                      ("pq", "codes_g")):
        e = Rii(pq)
        e.scan_mode = mode
        e.pallas_interpret = True
        e.add_configure(X1, nlist=40)
        dc = e._ensure_cache()
        assert key in dc, (mode, sorted(dc))
        e.add(X2)
        assert e._dc is not None, mode
        ids, _ = e.query_batch(X2[:4], topk=3, method="linear")
        hits = np.mean([3000 + i in ids[i] for i in range(4)])
        assert hits >= 0.75, mode  # tile-min selection can swap near-ties


def test_empty_add_keeps_cache():
    """An empty add() must not invalidate the device cache: the incremental
    path stamps the new version on the untouched cache instead of letting
    the next query pay a full O(N) rebuild."""
    rng = np.random.RandomState(31)
    D = 32
    X = rng.random((2000, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32).fit(X)
    e = Rii(pq)
    e.add_configure(X, nlist=30)
    e.query_batch(X[:2], topk=3)  # build the cache
    dc = e._dc
    assert dc is not None
    e.add(np.zeros((0, D), np.float32))
    assert e._dc is dc and dc["version"] == e._version
    ids, _ = e.query_batch(X[:2], topk=3)
    assert e._dc is dc  # same object: no rebuild happened
    assert ids[0, 0] == 0 and ids[1, 0] == 1


def test_reserve_keeps_cache_beyond_pow2():
    """reserve(n_expected) pre-sizes the cap so adds past pow2(N) still take
    the O(batch) scatter path (vector-reserve semantics)."""
    rng = np.random.RandomState(29)
    D = 32
    # N exactly a power of two: without a reservation the very first add
    # overflows the linear cap and drops the cache
    X1 = rng.random((2048, D)).astype(np.float32)
    X2 = rng.random((600, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32).fit(X1)

    e0 = Rii(pq)
    e0.scan_mode = "bf16"
    e0.add_configure(X1, nlist=32)
    e0._ensure_cache()
    e0.add(X2)
    assert e0._dc is None  # pow2 cap exhausted -> lazy rebuild

    e = Rii(pq)
    e.scan_mode = "bf16"
    e.reserve(2048 + 1024)
    e.add_configure(X1, nlist=32)
    dc = e._ensure_cache()
    assert dc["cap"] >= 2048 + 1024
    e.add(X2)
    assert e._dc is not None  # reservation absorbed the growth
    assert e._dc["n_dev"] == 2648

    # results identical to the unreserved engine (after its rebuild)
    q = np.ascontiguousarray(X2[:8])
    ids_a, d_a = e.query_batch(q, topk=5, method="linear")
    ids_b, d_b = e0.query_batch(q, topk=5, method="linear")
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6)

    # pickle round-trip keeps the reservation
    import pickle
    e2 = pickle.loads(pickle.dumps(e))
    assert e2._cap_reserve == 2048 + 1024


def test_reserve_scales_window_headroom():
    """A large reservation also reserves window slots: posting-list adds up
    to the reservation stay on the delta path."""
    rng = np.random.RandomState(31)
    D = 32
    X1 = rng.random((2000, D)).astype(np.float32)
    X2 = rng.random((900, D)).astype(np.float32)  # +45% > default 12.5%
    pq = PQ(M=4, Ks=32).fit(X1)
    e = Rii(pq)
    e.scan_mode = "bf16"
    e.reserve(3000)
    e.add_configure(X1, nlist=32)
    e._ensure_cache()
    e.add(X2, update_posting_lists=True)
    assert e._dc is not None, "reserved window headroom should absorb +45%"
    assert int(e._dc["v_counts"].sum()) == 2900


def test_failed_scatter_drops_cache_not_corrupts(monkeypatch):
    """A scatter failing MID-SEQUENCE (device OOM analog) must drop the
    cache — never leave it half-updated — and the add itself succeeds."""
    import rii_tpu.rii as rii_mod

    rng = np.random.RandomState(37)
    D = 32
    X1 = rng.random((3000, D)).astype(np.float32)
    X2 = rng.random((100, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32).fit(X1)
    e = Rii(pq)
    e.scan_mode = "bf16"
    e.add_configure(X1, nlist=40)
    e._ensure_cache()

    real = rii_mod._set_rows
    calls = [0]

    def flaky(arr, idx, rows):
        calls[0] += 1
        if calls[0] == 2:  # fail after the first scatter landed
            raise RuntimeError("RESOURCE_EXHAUSTED (injected)")
        return real(arr, idx, rows)

    monkeypatch.setattr(rii_mod, "_set_rows", flaky)
    e.add(X2)  # must not raise: host append succeeds, cache dropped
    monkeypatch.setattr(rii_mod, "_set_rows", real)
    assert e._dc is None, "half-updated cache must be dropped"
    assert e.N == 3100
    ids, _ = e.query(X2[5], topk=3, method="linear")
    assert 3005 in ids  # rebuilt lazily, new rows searchable


def test_sharded_failed_scatter_rebuilds(monkeypatch):
    from rii_tpu.parallel import ShardedRii
    import rii_tpu.rii as rii_mod

    rng = np.random.RandomState(38)
    D = 32
    X1 = rng.random((2048, D)).astype(np.float32)
    X2 = rng.random((128, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32).fit(X1[:512], iter=3)
    e = Rii(pq)
    e.add_configure(X1, nlist=32, iter=3)
    sr = ShardedRii(e)

    real = rii_mod._set_rows
    calls = [0]

    def flaky(arr, idx, rows):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("RESOURCE_EXHAUSTED (injected)")
        return real(arr, idx, rows)

    monkeypatch.setattr(rii_mod, "_set_rows", flaky)
    sr.add(X2)  # must not raise; rebuilds under the lock
    monkeypatch.setattr(rii_mod, "_set_rows", real)
    assert sr._n_dev == e.N == 2176
    qn = np.ascontiguousarray(X2[:4])
    ids, _ = sr.query_batch(qn, topk=1)
    assert (ids[:, 0] >= 2048).all()  # new rows searchable post-rebuild
    # results identical to a fresh wrapper
    ref = ShardedRii(e)
    q = np.ascontiguousarray(X1[10:18])
    ids_a, d_a = sr.query_batch(q, topk=5)
    ids_b, d_b = ref.query_batch(q, topk=5)
    np.testing.assert_array_equal(ids_a, ids_b)
