"""Smoke tests for the observability helpers (SURVEY.md section 5 parity:
the reference's verbose timing prints -> jax.profiler traces + QPS harness)."""

import os

import numpy as np

from rii_tpu import PQ, Rii
from rii_tpu.utils.profiling import benchmark_queries, trace


def _engine():
    rng = np.random.RandomState(0)
    X = rng.random((2000, 32)).astype(np.float32)
    pq = PQ(M=4, Ks=16, verbose=False).fit(X[:500], iter=2)
    e = Rii(pq)
    e.add_configure(X, nlist=20, iter=2)
    return e, X


def test_benchmark_queries_reports_qps_and_recall():
    e, X = _engine()
    out = benchmark_queries(e, X[:16], topk=5, reps=1,
                            gt_ids=np.arange(16))
    assert out["qps"] > 0 and out["ms_per_query"] > 0
    assert 0.0 <= out["recall@1"] <= 1.0
    assert out["recall@5"] >= out["recall@1"]


def test_trace_writes_profile(tmp_path):
    e, X = _engine()
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        e.query_batch(X[:4], topk=3)
    # jax writes plugins/profile/<ts>/ under the logdir
    found = any("profile" in r for r, d, f in os.walk(logdir) for _ in [0])
    assert found or os.listdir(logdir)
