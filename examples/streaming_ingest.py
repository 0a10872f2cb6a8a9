"""Streaming ingest demo: serve queries WHILE the index grows.

A producer thread appends fresh vectors in batches (`Rii.add`, the O(batch)
incremental path — scattered into spare device capacity, reference AddCodes
contract /root/reference/src/rii.h:158-193) while concurrent clients keep
querying through a continuous-batching QueryServer. The engine's
reader-writer lock makes this safe: queries share the lock, each add takes
it exclusively, so in-flight scans never observe a half-updated device
cache. Newly added vectors become searchable as soon as their add returns.

Env: INGEST_N initial rows (200k), INGEST_BATCHES x INGEST_BATCH streamed
rows (20 x 5000), INGEST_CLIENTS query threads (16).
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
    n0 = int(os.environ.get("INGEST_N", 200_000))
    n_batches = int(os.environ.get("INGEST_BATCHES", 20))
    batch = int(os.environ.get("INGEST_BATCH", 5_000))
    n_clients = int(os.environ.get("INGEST_CLIENTS", 16))
    d = 128
    rng = np.random.RandomState(0)
    # +1 row for the warm-up add, so every streamed batch keeps the SAME
    # shape (each distinct batch shape compiles its own scatter variants,
    # and a one-off tail batch would pay those compiles)
    X = rng.random((n0 + n_batches * batch + 1, d)).astype(np.float32)

    print(f"building index (N={n0}) ...", flush=True)
    e = Rii(PQ(M=32, Ks=256).fit(X[:50_000], iter=5))
    # vector-reserve: pre-size device caches for the whole stream so every
    # add below is an O(batch) scatter (no mid-stream rebuild)
    e.reserve(n0 + n_batches * batch + 1)
    e.add_configure(X[:n0])
    e.query_batch(X[:8], topk=10)     # warm the query compile cache
    e.add(X[n0:n0 + 1])               # warm the incremental-add scatters

    stop = threading.Event()
    counts = [0] * n_clients  # per-thread: no shared read-modify-write
    add_times = []

    errors = []

    def client(srv, i):
        # RandomState is not thread-safe: one instance per client
        crng = np.random.RandomState(1000 + i)
        try:
            while not stop.is_set():
                j = crng.randint(0, e.N)
                ids, _ = srv.submit(X[j], topk=10).result()
                assert ids.shape == (10,)  # (D,) submissions squeeze to 1-D
                counts[i] += 1
        except Exception as exc:  # noqa: BLE001 - surfaced after the run
            errors.append(exc)

    with QueryServer(e, max_batch=1024, max_wait_ms=3.0) as srv:
        threads = [threading.Thread(target=client, args=(srv, i))
                   for i in range(n_clients)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for b in range(n_batches):
            lo = n0 + 1 + b * batch
            chunk = X[lo:lo + batch]
            if not len(chunk):
                break
            t0 = time.perf_counter()
            e.add(chunk)              # O(batch): spare-capacity scatter
            dt = time.perf_counter() - t0
            add_times.append(dt)
            kept = e._dc is not None
            print(f"add(+{len(chunk)}) #{b}: {dt*1e3:.0f} ms "
                  f"(cache kept={kept}, N={e.N})", flush=True)
        stop.set()
        wall = time.perf_counter() - t_start
        for t in threads:
            t.join(timeout=30)

    # the last streamed rows must be immediately searchable
    probe = X[e.N - 4:e.N]
    ids, _ = e.query_batch(np.ascontiguousarray(probe), topk=1)
    hits = float((ids[:, 0] >= e.N - 4).mean())
    if errors:
        raise errors[0]
    print(f"\nserved ~{sum(counts) / wall:.0f} QPS while streaming "
          f"{n_batches}x{batch} rows; "
          f"median add {np.median(add_times)*1e3:.0f} ms; "
          f"new-row self-hit {hits:.2f}")


if __name__ == "__main__":
    main()
