#!/usr/bin/env python
"""Serving-layer load benchmark: QueryServer under concurrent submitters.

Measures what a deployment sees: end-to-end QPS and p50/p99 latency of the
continuous-batching server (request coalescing into device batches) under K
concurrent client threads issuing single-query requests back-to-back, vs the
raw device throughput ceiling. Writes markdown to stdout.

Env: BENCH_N (default 1M on accelerator), BENCH_CLIENTS (default '1,8,64'),
BENCH_REQS total requests per level (default 2048).
"""

import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    on_accel = jax.default_backend() != "cpu"
    N = int(os.environ.get("BENCH_N", 1_000_000 if on_accel else 50_000))
    levels = [int(x) for x in
              os.environ.get("BENCH_CLIENTS", "1,8,64").split(",")]
    total_reqs = int(os.environ.get("BENCH_REQS", 2048))
    D, M, Ks = 128, 32, 256
    nlist = 1000 if N >= 500_000 else max(32, int(np.sqrt(N)))
    log(f"N={N} clients={levels} reqs={total_reqs} "
        f"backend={jax.default_backend()}")

    rng = np.random.RandomState(3)
    X = rng.random((N, D)).astype(np.float32)
    from rii_tpu import PQ, Rii
    from rii_tpu.serving import QueryServer

    pq = PQ(M=M, Ks=Ks).fit(X[:100_000], iter=8)
    e = Rii(pq)
    e.add_configure(X, nlist=nlist, iter=5)
    qpool = X[rng.choice(N, 4096, replace=False)]

    # raw ceiling: one big batched dispatch, amortized — same method as the
    # client traffic below so rows and ceiling compare identical work
    big = np.ascontiguousarray(qpool[:1024])
    e.query_batch(big, topk=10, method="linear")
    t0 = time.perf_counter()
    for _ in range(3):
        e.query_batch(big, topk=10, method="linear")
    ceiling = 3 * 1024 / (time.perf_counter() - t0)

    # warm every pow2 coalesced-batch bucket the levels can produce, so the
    # timed loops measure dispatch, not compiles
    b = 1
    while b <= min(1024, max(levels)):
        e.query_batch(np.ascontiguousarray(qpool[:b]), topk=10,
                      method="linear")
        b *= 2

    rows = []
    for k in levels:
        srv = QueryServer(e, max_batch=1024, max_wait_ms=2.0)
        srv.start()
        srv.submit(qpool[0], topk=10, method="linear").result(timeout=300)
        reqs_per_client = max(1, total_reqs // k)
        lats = []
        lock = threading.Lock()

        def client(cid):
            local = []
            r = np.random.RandomState(cid)
            for _ in range(reqs_per_client):
                q = qpool[r.randint(len(qpool))]
                t0 = time.perf_counter()
                srv.submit(q, topk=10, method="linear").result(timeout=300)
                local.append(time.perf_counter() - t0)
            with lock:
                lats.extend(local)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(k)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        srv.stop()
        lats.sort()
        row = dict(clients=k, reqs=k * reqs_per_client,
                   qps=k * reqs_per_client / wall,
                   p50_ms=lats[len(lats) // 2] * 1e3,
                   p99_ms=lats[int(len(lats) * 0.99)] * 1e3)
        rows.append(row)
        log(row)

    print("# Serving-layer load benchmark (QueryServer)\n")
    print(f"Config: N={N}, D={D}, M={M}, Ks={Ks}, single-query submissions, "
          f"topk=10, max_wait 2 ms, backend={jax.default_backend()}. Raw "
          f"batched-dispatch ceiling: {ceiling:.0f} QPS (Q=1024 batches); "
          f"the QPS column shows coalescing scaling.\n")
    print("| concurrent clients | requests | QPS | p50 ms | p99 ms |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['clients']} | {r['reqs']} | {r['qps']:.0f} | "
              f"{r['p50_ms']:.1f} | {r['p99_ms']:.1f} |")


if __name__ == "__main__":
    main()
