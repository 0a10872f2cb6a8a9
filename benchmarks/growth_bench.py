#!/usr/bin/env python
"""Dynamic-growth benchmark: the reference's headline reconfigure story.

Reproduces the tutorial narrative (/root/reference/README.md:130-140) at
device scale (BASELINE.md "dynamic growth" config): build an index on clustered
data, add a large batch FROM A SHIFTED DISTRIBUTION (new clusters) with
posting-list updates — the coarse centers go stale: new vectors pile into
whichever old lists are nearest, so probing the same budget covers the new
regions poorly — then `reconfigure()` and measure again.

Reports device-resident IVF latency (fori-loop differencing, dispatch
cancels) and recall@10 of queries drawn from the NEW distribution, vs the
exact-ADC linear scan. Writes markdown to stdout.

Env: BENCH_N initial size (default 1M on accelerator), BENCH_ADD added size
(default = BENCH_N), BENCH_Q (default 64).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def clustered(n, d, n_clusters, rng, spread=0.2):
    centers = rng.normal(0, 1, (n_clusters, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    step = 1 << 18
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        a = rng.randint(0, n_clusters, hi - lo)
        out[lo:hi] = centers[a] + spread * rng.normal(
            0, 1, (hi - lo, d)).astype(np.float32)
    return out


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    on_accel = jax.default_backend() != "cpu"
    N0 = int(os.environ.get("BENCH_N", 1_000_000 if on_accel else 100_000))
    N_ADD = int(os.environ.get("BENCH_ADD", N0))
    Q = int(os.environ.get("BENCH_Q", 64))
    D, M, Ks = 128, 32, 256
    nlist = 1000 if N0 >= 500_000 else max(32, int(np.sqrt(N0)))
    topk, L = 10, 5000 if N0 >= 500_000 else None
    log(f"N0={N0} +{N_ADD} Q={Q} nlist={nlist} backend={jax.default_backend()}")

    rng = np.random.RandomState(7)
    X0 = clustered(N0, D, max(64, N0 // 200), rng)
    # the ADDED data comes from NEW clusters (distribution shift): the stale
    # coarse centers have no representatives near them
    X1 = clustered(N_ADD, D, max(64, N_ADD // 200), rng)

    from rii_tpu import PQ, Rii
    from rii_tpu.ops.ivf import ivf_union_scan_topk

    pq = PQ(M=M, Ks=Ks).fit(X0[:100_000], iter=8)
    e = Rii(pq)
    e.add_configure(X0, nlist=nlist, iter=5)
    if L is None:
        L = e._multiple_of_L0_covering_topk(topk)

    queries_all = (X1[rng.choice(N_ADD, Q, replace=False)]
                   + 0.02 * rng.normal(0, 1, (Q, D)).astype(np.float32)
                   ).astype(np.float32)

    def device_resident_ivf_ms(queries, L):
        qd = jnp.asarray(queries)
        dc = e._ensure_cache()
        if "decoded_g" not in dc:
            return float("nan")
        wv = e._probe_width_virtual(L, None, dc)
        rt = e.topk_recall
        Qn = queries.shape[0]

        @jax.jit
        def loop(reps, qb, dec_g, nrm_g, ord_g, cdec, cnrm):
            def body(i, acc):
                dd, _ = ivf_union_scan_topk(
                    qb + acc * 1e-30, dec_g, nrm_g, ord_g, cdec, cnrm,
                    w=wv, topk=topk, cap_u=dc["cap_v"],
                    nlist_pad=dc["nlist_v_pad"], recall_target=rt)
                return dd[0, 0]
            return lax.fori_loop(0, reps, body, jnp.float32(0.0))

        args = (qd, dc["decoded_g"], dc["norms_g"], dc["order_g"],
                dc["centers_dec_v"], dc["centers_norms_v"])
        _ = np.asarray(loop(jnp.int32(1), *args))

        def t(reps):
            best = np.inf
            for _ in range(3):
                t0 = time.perf_counter()
                _ = np.asarray(loop(jnp.int32(reps), *args))
                best = min(best, time.perf_counter() - t0)
            return best

        r1, r2 = 4, 16
        t1 = t(r1)
        t2 = t(r2)
        while t2 < t1 + 0.25 and r2 < 4096:
            r2 *= 4
            t2 = t(r2)
        return (t2 - t1) / (r2 - r1) / Qn * 1e3

    # two operating points: throughput (batch union covers many probes) and
    # tight latency (small batch, small budget — the stale-centers stress)
    points = [("batch Q=%d L=%d" % (Q, L), Q, L),
              ("tight Q=8 L=%d" % max(topk * 10, L // 5), 8,
               max(topk * 10, L // 5))]

    def measure(tag):
        out = []
        for pname, qn_, L_ in points:
            qs = queries_all[:qn_]
            ids, _ = e.query_batch(qs, topk=topk, L=L_, method="ivf")
            ids_l, _ = e.query_batch(qs, topk=topk, method="linear")
            rec = np.mean([len(set(a.tolist()) & set(b.tolist())) / topk
                           for a, b in zip(ids, ids_l)])
            ms = device_resident_ivf_ms(qs, L_)
            row = dict(stage=tag, point=pname, N=e.N, nlist=e.nlist,
                       L0=e.L0, us_q=ms * 1e3, recall10=rec)
            log(row)
            out.append(row)
        return out

    rows = measure(f"built at N={N0}")

    t0 = time.perf_counter()
    e.add(X1, update_posting_lists=True)  # posting lists grow, centers stale
    t_add = time.perf_counter() - t0
    log(f"add(+{N_ADD}, update_posting_lists=True): {t_add:.1f}s")
    rows += measure(f"after add(+{N_ADD}) shifted — stale centers")

    t0 = time.perf_counter()
    e.reconfigure(nlist=int(np.sqrt(e.N)))
    t_rec = time.perf_counter() - t0
    log(f"reconfigure(nlist={e.nlist}): {t_rec:.1f}s")
    rows += measure("after reconfigure()")

    print("# Dynamic growth: IVF before/after reconfigure\n")
    print(f"Config: clustered synthetic, D={D}, M={M}, Ks={Ks}, start "
          f"N={N0}, add {N_ADD} from NEW clusters (distribution shift) with "
          f"update_posting_lists=True, IVF L={L}, batch Q={Q}, "
          f"backend={jax.default_backend()}. Queries drawn from the added "
          f"distribution; recall@10 vs the exact-ADC linear scan; latency is "
          f"device-resident (dispatch-free). add: {t_add:.1f}s, "
          f"reconfigure: {t_rec:.1f}s.\n")
    print("| stage | operating point | N | nlist | L0 | IVF us/query | "
          "recall@10 vs linear |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['stage']} | {r['point']} | {r['N']} | {r['nlist']} | "
              f"{r['L0']} | {r['us_q']:.1f} | {r['recall10']:.3f} |")


if __name__ == "__main__":
    main()
