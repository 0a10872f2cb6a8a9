"""QueryServer: continuous batching must return exactly what direct
query_batch returns, under concurrent submission."""

import queue as queue_mod
import threading
import time

import numpy as np
import pytest

from rii_tpu import PQ, Rii
from rii_tpu.serving import QueryServer


@pytest.fixture(scope="module")
def engine():
    rng = np.random.RandomState(0)
    N, D = 4000, 32
    X = rng.random((N, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32, verbose=False).fit(X[:1000], iter=3)
    e = Rii(pq)
    e.add_configure(X, nlist=60, iter=3)
    return e, X


def test_single_request_matches_direct_and_squeezes(engine):
    e, X = engine
    with QueryServer(e) as srv:
        fut = srv.submit(X[3], topk=5)  # (D,) submission
        ids, dists = fut.result(timeout=60)
    # single-query (D,) submissions are squeezed to 1-D (the documented
    # contract, matching the reference's query())
    assert ids.shape == (5,) and dists.shape == (5,)
    ids_d, dists_d = e.query_batch(X[3:4], topk=5)
    np.testing.assert_array_equal(ids, ids_d[0])
    np.testing.assert_allclose(dists, dists_d[0], rtol=1e-6)


def test_minibatch_request_stays_2d(engine):
    e, X = engine
    with QueryServer(e) as srv:
        fut = srv.submit(X[3:6], topk=5)  # (3, D) submission
        ids, dists = fut.result(timeout=60)
    assert ids.shape == (3, 5) and dists.shape == (3, 5)
    ids_d, _ = e.query_batch(np.ascontiguousarray(X[3:6]), topk=5)
    np.testing.assert_array_equal(ids, ids_d)


def test_concurrent_submissions_batch_and_match(engine):
    e, X = engine
    rng = np.random.RandomState(1)
    picks = rng.choice(e.N, 32, replace=False)
    direct_ids, _ = e.query_batch(np.ascontiguousarray(X[picks]), topk=5)

    results = {}
    with QueryServer(e, max_batch=64, max_wait_ms=20) as srv:
        futs = {}

        def submit(i):
            futs[i] = srv.submit(X[picks[i]], topk=5)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, f in futs.items():
            results[i] = f.result(timeout=60)

    for i in range(32):
        ids, dists = results[i]
        np.testing.assert_array_equal(ids, direct_ids[i])

    stats = srv.stats()
    assert stats["served"] == 32
    assert stats["p50_s"] is not None


def test_mixed_topk_groups(engine):
    e, X = engine
    with QueryServer(e, max_wait_ms=5) as srv:
        f1 = srv.submit(X[1], topk=3)
        f2 = srv.submit(X[2], topk=7)  # incompatible topk: separate dispatch
        i1, d1 = f1.result(timeout=60)
        i2, d2 = f2.result(timeout=60)
    assert i1.shape == (3,) and i2.shape == (7,)
    d1_ref, _ = e.query_batch(X[1:2], topk=3)
    d2_ref, _ = e.query_batch(X[2:3], topk=7)
    np.testing.assert_array_equal(i1, d1_ref[0])
    np.testing.assert_array_equal(i2, d2_ref[0])


def test_incompatible_request_preserves_fifo(engine):
    """An incompatible request must lead the NEXT group, not be re-queued at
    the back (starvation under a steady compatible stream)."""
    e, X = engine
    srv = QueryServer(e, max_wait_ms=50)
    # enqueue before starting so the dispatcher sees them all at once
    f_a = srv.submit(X[1], topk=3)
    f_odd = srv.submit(X[2], topk=7)   # incompatible with the topk=3 group
    f_b = srv.submit(X[3], topk=3)
    followers = [srv.submit(X[4 + i], topk=3) for i in range(8)]
    srv.start()
    try:
        # the odd one must resolve even while compatible traffic keeps coming
        i_odd, _ = f_odd.result(timeout=60)
        assert i_odd.shape == (7,)
        for f in [f_a, f_b] + followers:
            f.result(timeout=60)
    finally:
        srv.stop()


def test_target_ids_request(engine):
    e, X = engine
    tids = np.arange(0, 2000, dtype=np.int64)
    with QueryServer(e) as srv:
        fut = srv.submit(X[5], topk=5, target_ids=tids)
        ids, _ = fut.result(timeout=60)
    assert set(ids.tolist()) <= set(tids.tolist())


def test_error_propagates(engine):
    e, X = engine
    with QueryServer(e) as srv:
        fut = srv.submit(X[0], topk=e.N + 1)  # invalid topk -> AssertionError
        with pytest.raises(AssertionError):
            fut.result(timeout=60)


def test_stop_drains_pending_and_rejects_new(engine):
    e, X = engine
    srv = QueryServer(e)
    # never started: pending futures must still be failed by stop()
    fut = srv.submit(X[0], topk=3)
    srv.stop()
    with pytest.raises(RuntimeError, match="server stopped"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="server stopped"):
        srv.submit(X[1], topk=3)


def test_query_server_over_sharded_engine(engine):
    """QueryServer accepts a ShardedRii: the serving layer composes with the
    multi-chip engine (same signature contract)."""
    from rii_tpu.parallel import ShardedRii
    e, X = engine
    sr = ShardedRii(e)
    with QueryServer(sr, max_wait_ms=5) as srv:
        fut = srv.submit(X[7], topk=5)
        ids, dists = fut.result(timeout=120)
    assert ids.shape == (5,)
    # the server submits with method='auto' (a single query routes to the
    # IVF probe union here): the same routing called directly agrees
    ids_d, dists_d = sr.query_batch(X[7:8], topk=5, method="auto")
    np.testing.assert_array_equal(ids, ids_d[0])
    np.testing.assert_allclose(dists, dists_d[0], rtol=1e-4)


def test_backpressure_bounded_queue(engine):
    e, X = engine
    srv = QueryServer(e, max_queue=2, submit_timeout_s=0.05)
    srv.submit(X[0], topk=3)
    srv.submit(X[1], topk=3)
    with pytest.raises(queue_mod.Full):
        srv.submit(X[2], topk=3)  # queue full, dispatcher not running
    srv.stop()


def test_same_mask_subset_requests_batch_and_resolve(engine):
    """Round-3: same-mask subset requests group into one dispatch (content
    fingerprint), different masks split, and a mixed subset/full stream
    completes correctly through the dispatcher pool."""
    e, X = engine
    tids_a = np.sort(np.random.RandomState(1).choice(
        e.N, 200, replace=False)).astype(np.int64)
    tids_b = np.sort(np.random.RandomState(2).choice(
        e.N, 150, replace=False)).astype(np.int64)
    with QueryServer(e, max_wait_ms=20, dispatchers=2) as srv:
        futs_a = [srv.submit(X[i], topk=3, target_ids=tids_a.copy())
                  for i in range(6)]
        futs_b = [srv.submit(X[i], topk=3, target_ids=tids_b)
                  for i in range(3)]
        futs_f = [srv.submit(X[i], topk=3) for i in range(4)]
        for i, f in enumerate(futs_a + futs_b):
            ids, _ = f.result(timeout=120)
            tset = tids_a if i < 6 else tids_b
            assert set(ids.tolist()) <= set(tset.tolist())
        for f in futs_f:
            ids, _ = f.result(timeout=120)
            assert ids.shape == (3,)
    # fingerprints: equal content -> equal key even for distinct arrays
    from rii_tpu.serving import _Request
    r1 = _Request(X[:1], 3, None, tids_a.copy(), "auto", True)
    r2 = _Request(X[:1], 3, None, tids_a.copy(), "auto", True)
    r3 = _Request(X[:1], 3, None, tids_b, "auto", True)
    assert r1.tid_key == r2.tid_key != r3.tid_key


def test_dispatcher_pool_subset_does_not_stall_stream(engine):
    """A subset-heavy mix must keep full-scan requests flowing (the round-2
    weak item: single dispatcher serialized behind singleton subset
    dispatches)."""
    e, X = engine
    rng = np.random.RandomState(5)
    with QueryServer(e, max_wait_ms=1, dispatchers=2) as srv:
        futs = []
        for i in range(12):
            if i % 2 == 0:
                tids = np.sort(rng.choice(e.N, 100 + i, replace=False)
                               ).astype(np.int64)
                futs.append(srv.submit(X[i], topk=2, target_ids=tids))
            else:
                futs.append(srv.submit(X[i], topk=2))
        for f in futs:
            ids, dists = f.result(timeout=120)
            assert np.isfinite(dists).all()
        st = srv.stats()
    assert st["served"] == 12


class _SlowEngine:
    """query_batch sleeps: models a device slower than the submit stream."""

    def __init__(self, delay_s):
        self.delay_s = delay_s

    def query_batch(self, batch, topk=1, L=None, target_ids=None,
                    method="auto"):
        time.sleep(self.delay_s)
        n = batch.shape[0]
        return (np.zeros((n, topk), np.int64),
                np.zeros((n, topk), np.float32))


def test_backpressure_holds_under_slow_dispatch():
    """A RUNNING server with a slow engine must still enforce max_queue: the
    bounded formed-group staging queue stops the group-former from draining
    submissions faster than dispatchers retire them (an unbounded staging
    queue silently disabled the documented backpressure)."""
    srv = QueryServer(_SlowEngine(0.3), max_batch=1, max_queue=2,
                      max_wait_ms=0.0, submit_timeout_s=0.05, dispatchers=1)
    srv.start()
    q = np.zeros(8, np.float32)
    try:
        with pytest.raises(queue_mod.Full):
            # in-flight ceiling is _q(2) + staged groups(2) + former/dispatch
            # hands: far fewer than 32 submits can be absorbed in one drain
            for _ in range(32):
                srv.submit(q, topk=1)
    finally:
        srv.stop()


def test_concurrent_cold_cache_builds_once(engine):
    """The dispatcher pool calls query_batch concurrently; a cold device
    cache must be built exactly once (racing builds would transiently double
    device memory and duplicate compiles)."""
    import types

    e, X = engine
    e._dc = None  # force a cold cache
    calls = []
    orig = type(e)._build_cache

    def counted(self):
        calls.append(threading.get_ident())
        time.sleep(0.05)  # widen the race window
        return orig(self)

    e._build_cache = types.MethodType(counted, e)
    try:
        errs = []

        def worker():
            try:
                e.query_batch(X[:4], topk=3, method="linear")
            except Exception as ex:  # pragma: no cover
                errs.append(ex)

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errs
        assert len(calls) == 1, calls
    finally:
        del e.__dict__["_build_cache"]
