"""Continuous-batching serving demo: concurrent clients against a QueryServer.

Shows the throughput effect of request coalescing on the device: many independent
single-query submitters are served at batched-scan throughput.
"""

import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rii_tpu import PQ, Rii  # noqa: E402
from rii_tpu.serving import QueryServer  # noqa: E402


def main():
    n = int(os.environ.get("SERVE_N", 200_000))
    n_clients = int(os.environ.get("SERVE_CLIENTS", 32))
    per_client = int(os.environ.get("SERVE_REQS", 50))
    rng = np.random.RandomState(0)
    X = rng.random((n, 128)).astype(np.float32)

    print(f"building index (N={n}) ...", flush=True)
    e = Rii(PQ(M=32, Ks=256).fit(X[:50_000], iter=5))
    e.add_configure(X)
    e.query_batch(X[:8], topk=10)  # warm the compile caches

    def client(i, srv, out):
        lat = []
        my = rng.randint(0, n, per_client)
        for j in my:
            t0 = time.perf_counter()
            ids, dists = srv.submit(X[j], topk=10).result()
            lat.append(time.perf_counter() - t0)
            assert ids.shape == (1, 10)
        out[i] = lat

    with QueryServer(e, max_batch=1024, max_wait_ms=3.0) as srv:
        out = {}
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, srv, out))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stats = srv.stats()

    total = n_clients * per_client
    lat = sorted(sum(out.values(), []))
    print(f"{total} requests from {n_clients} clients in {wall:.2f}s "
          f"-> {total / wall:.0f} QPS")
    print(f"client-side p50={lat[len(lat)//2]*1e3:.1f} ms "
          f"p99={lat[int(len(lat)*0.99)]*1e3:.1f} ms; server stats: {stats}")


if __name__ == "__main__":
    main()
