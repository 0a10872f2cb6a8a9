"""Profiling / observability helpers.

The reference's only tracing is verbose wall-clock prints inside PQk-means
(SURVEY.md section 5). The equivalents here: jax.profiler traces (viewable
in Perfetto/TensorBoard) and a wall-clock QPS/recall harness.
"""

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(logdir):
    """Capture a device trace: `with trace('/tmp/trace'): e.query_batch(...)`."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def benchmark_queries(engine, queries, topk=10, reps=3, gt_ids=None, **query_kw):
    """Steady-state QPS (+ optional recall) for a query batch, timed on the
    host clock end to end (query_batch returns host arrays, so transfers and
    device work are inside the window).

    Returns a dict: {'ms_per_query', 'qps', 'recall@1'?, 'recall@topk'?}.
    """
    engine.query_batch(queries, topk=topk, **query_kw)  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        ids, dists = engine.query_batch(queries, topk=topk, **query_kw)
    dt = max(1e-9, (time.perf_counter() - t0) / reps)
    out = {
        "ms_per_query": dt / len(queries) * 1e3,
        "qps": len(queries) / dt,
    }
    if gt_ids is not None:
        gt = np.asarray(gt_ids).reshape(-1)[: len(ids)]
        out["recall@1"] = float((ids[:, 0] == gt).mean())
        out[f"recall@{topk}"] = float((ids == gt[:, None]).any(1).mean())
    return out
