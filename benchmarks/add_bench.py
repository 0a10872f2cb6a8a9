#!/usr/bin/env python
"""Incremental-add cost: add(+batch) must be O(batch), independent of N.

The reference's AddCodes is an O(new) append (/root/reference/src/rii.h:158-193);
round 3 gives the device cache the same contract: new rows are scattered into
spare capacity (pow2 linear caps + 12.5% per-bucket window headroom) under
jit donation, so the cache survives and only O(batch) work happens.

Reports, for each N in BENCH_NS (default "1000000,4000000,8000000"):
  - add(+BENCH_ADD) wall time with a live cache (the incremental path)
  - whether the cache survived (it must, until headroom is exhausted)
  - the full cache rebuild time for comparison (the round-2 behavior)

Run on the GPU; BENCH_ADD default 100k.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    ns = [int(x) for x in os.environ.get(
        "BENCH_NS", "1000000,4000000,8000000").split(",")]
    n_add = int(os.environ.get("BENCH_ADD", 100_000))
    D, M, Ks, nlist = 128, 32, 256, 1000
    rng = np.random.RandomState(3)

    from rii_tpu import PQ, Rii

    x_fit = rng.random((100_000, D)).astype(np.float32)
    pq = PQ(M=M, Ks=Ks).fit(x_fit, iter=5)
    x_add = rng.random((n_add, D)).astype(np.float32)

    for n in ns:
        e = Rii(pq)
        e.decoded_cache_budget = 8 << 30
        # vector-reserve semantics: pre-size for the adds so every batch
        # takes the O(batch) scatter path (without it, an N at an exact
        # power of two pays the amortized doubling rebuild on the first add)
        e.reserve(n + 3 * n_add)
        t0 = time.perf_counter()
        step = 1 << 20
        codes = np.empty((n, M), np.uint8)
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            codes[lo:hi] = pq.encode(
                rng.random((hi - lo, D)).astype(np.float32))
        e._add_codes(codes, False)
        e.reconfigure(nlist=nlist, iter=2)
        log(f"N={n}: host build {time.perf_counter()-t0:.0f}s")

        t0 = time.perf_counter()
        dc = e._ensure_cache()
        t_build = time.perf_counter() - t0
        log(f"N={n}: cache build {t_build:.2f}s mode={dc['mode']} "
            f"windows={'bf16' if 'decoded_g' in dc else 'pq'}")

        # warm the add path's jit variants with a tiny add first
        e.add(x_add[:128])
        kept_warm = e._dc is not None
        # first full-size add compiles the k=n_add scatter variants; the
        # SECOND same-shape add is the steady-state number
        x_add2 = rng.random((n_add, D)).astype(np.float32)
        t0 = time.perf_counter()
        e.add(x_add)
        t_add = time.perf_counter() - t0
        kept = e._dc is not None
        t0 = time.perf_counter()
        e.add(x_add2)
        t_add2 = time.perf_counter() - t0
        kept2 = e._dc is not None
        log(f"N={n}: add(+{n_add}) {t_add:.3f}s cache_kept={kept} "
            f"(warmup kept={kept_warm}); steady-state add {t_add2:.3f}s "
            f"cache_kept={kept2}")

        # compare: the round-2 behavior (full rebuild)
        e._dc = None
        t0 = time.perf_counter()
        e._ensure_cache()
        t_rebuild = time.perf_counter() - t0
        log(f"N={n}: full rebuild {t_rebuild:.2f}s "
            f"(steady-state incremental add is "
            f"{t_rebuild/max(t_add2,1e-9):.0f}x cheaper)")

        # sanity: new ids findable
        ids, _ = e.query_batch(x_add[:4], topk=5, method="linear")
        hits = np.mean([n + 128 + i in ids[i] for i in range(4)])
        log(f"N={n}: new-id self-hit {hits:.2f}")

        if os.environ.get("BENCH_SHARDED", "0") == "1":
            # same contract through ShardedRii's delta placement (on however
            # many devices this backend exposes)
            from rii_tpu.parallel import ShardedRii
            assigns = np.asarray(e._assignments()[:n]).copy()
            centers = e._centers
            e._dc = None  # free the single-chip device cache (HBM headroom)
            del e
            e2 = Rii(pq)
            e2.decoded_cache_budget = 8 << 30
            e2.reserve(n + 3 * n_add)
            e2._add_codes(codes, False)
            e2._centers = centers
            e2._assign_chunks = [assigns]
            sr = ShardedRii(e2)
            sr.add(x_add[:128])  # warm the scatter jit variants
            cache_id = id(sr._scan_cache)
            t0 = time.perf_counter()
            sr.add(x_add)  # first full-size add: includes k=n_add compiles
            t_sadd = time.perf_counter() - t0
            t0 = time.perf_counter()
            sr.add(x_add2)  # steady state
            t_sadd2 = time.perf_counter() - t0
            delta = id(sr._scan_cache) == cache_id  # refresh() replaces it
            t0 = time.perf_counter()
            sr.refresh()
            t_srefresh = time.perf_counter() - t0
            log(f"N={n}: sharded add(+{n_add}) {t_sadd:.3f}s, steady-state "
                f"{t_sadd2:.3f}s, delta_path={delta} vs full refresh "
                f"{t_srefresh:.2f}s "
                f"({t_srefresh/max(t_sadd2,1e-9):.0f}x cheaper)")
            del e2, sr
        else:
            del e


if __name__ == "__main__":
    main()
