#!/usr/bin/env python
"""Subset (target_ids) IVF against the masked linear scan, across subset
sizes: the reference makes subsets first-class inside the IVF walk
(/root/reference/src/rii.h:291-295); here the mask rides the union IVF as
+inf norms on the excluded slots.

Times are end to end through ``Rii.query_batch`` (median of 5 calls after a
warm-up, host clock). BENCH_N/BENCH_Q to shrink.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(e, queries, reps=5, **kw):
    out = e.query_batch(queries, **kw)  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = e.query_batch(queries, **kw)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def main():
    import jax

    dev = jax.devices()[0]
    N = int(os.environ.get("BENCH_N", 1_000_000))
    Q = int(os.environ.get("BENCH_Q", 64))
    D, M, Ks = 128, 32, 256
    nlist = 1000 if N >= 500_000 else max(16, int(np.sqrt(N)))
    topk = 10
    log(f"device={dev.platform}/{dev.device_kind} N={N} Q={Q}")

    rng = np.random.RandomState(123)
    X = rng.random((N, D)).astype(np.float32)
    queries = (X[rng.choice(N, Q, replace=False)]
               + rng.normal(0, 0.01, (Q, D))).astype(np.float32)

    from rii_tpu import PQ, Rii

    t0 = time.perf_counter()
    pq = PQ(M=M, Ks=Ks).fit(X[: min(N, 100_000)], iter=5)
    e = Rii(pq)
    e.add_configure(X, nlist=nlist, iter=3)
    log(f"build: {time.perf_counter()-t0:.0f}s nlist={e.nlist} L0={e.L0}")
    dc = e._ensure_cache()

    for s in (10_000, 100_000, 300_000):
        if s >= N:
            continue
        tids = np.sort(rng.choice(N, s, replace=False)).astype(np.int64)
        L = e._multiple_of_L0_covering_topk(topk)
        wv = e._probe_width_virtual(L, s, dc)
        union_slots = min(Q * wv, dc["nlist_v"]) * dc["cap_v"]
        log(f"|S|={s} L={L} wv={wv} union_slots={union_slots} "
            f"(cap={dc['cap']})")
        t_i, (i_k, _) = timed(e, queries, topk=topk, L=L, target_ids=tids,
                              method="ivf")
        t_l, (i_l, _) = timed(e, queries, topk=topk, target_ids=tids,
                              method="linear")
        ok_subset = np.isin(i_k[i_k >= 0], tids).all()
        rec = np.mean([len(set(a.tolist()) & set(b.tolist())) / topk
                       for a, b in zip(i_l, i_k)])
        log(f"  subset-ivf vs subset-linear: recall@{topk}={rec:.4f} "
            f"members-only={ok_subset}")
        log(f"  ivf:    {t_i*1e3:.3f} ms/batch, {t_i/Q*1e6:.2f} us/query")
        log(f"  linear: {t_l*1e3:.3f} ms/batch, {t_l/Q*1e6:.2f} us/query")


if __name__ == "__main__":
    main()
