#!/usr/bin/env python
"""Stage-by-stage profile of query_batch at the SIFT1B config shape.

Rebuilds the engine at this shape and times each layer — public
query_batch, _query_ivf_batch, _query_linear_batch, and the raw pq union op
with the engine's own device-cache arrays — to locate fixed costs between
the op and the public entry point (ROADMAP S2b).

Env: SHAPE_N (default 32M), SHAPE_NLIST (default 31623).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, reps=5):
    fn()
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from rii_tpu import PQ, Rii
    from rii_tpu.ops.ivf import ivf_union_scan_topk_pq

    N = int(os.environ.get("SHAPE_N", 32 * (1 << 20)))
    NLIST = int(os.environ.get("SHAPE_NLIST", 31623))
    M, Ks, D = 8, 256, 128
    rng = np.random.RandomState(0)
    cw = rng.standard_normal((M, Ks, D // M)).astype(np.float32)
    pq = PQ.from_codewords(cw)
    e = Rii(pq)
    e.scan_mode = "pq"
    chunk = 1 << 22
    for s in range(0, N, chunk):
        e.add_codes(rng.randint(0, Ks, (min(chunk, N - s), M)).astype(
            np.uint8), update_posting_lists=False)
    t0 = time.perf_counter()
    e.reconfigure(nlist=NLIST)
    log(f"reconfigure: {time.perf_counter()-t0:.0f}s")
    q = rng.standard_normal((8, D)).astype(np.float32)
    t0 = time.perf_counter()
    e.query_batch(q, topk=10)
    log(f"first query: {time.perf_counter()-t0:.0f}s")
    dc = e._ensure_cache()
    log(f"mode={dc['mode']} nlist_v={dc.get('nlist_v')} "
        f"cap_v={dc.get('cap_v')} keys={sorted(dc.keys())}")

    L = e._multiple_of_L0_covering_topk(topk=10)
    wv = e._probe_width_virtual(L, None, dc)
    log(f"L={L} wv={wv}")

    t = timed(lambda: e.query_batch(q, topk=10))
    log(f"query_batch(auto):      {t*1e3:8.2f} ms")
    t = timed(lambda: e.query_batch(q, topk=10, method="ivf"))
    log(f"query_batch(ivf):       {t*1e3:8.2f} ms")
    with e._state_lock.read():
        t = timed(lambda: e._query_ivf_batch(q, 10, None, L))
        log(f"_query_ivf_batch:       {t*1e3:8.2f} ms")
        t = timed(lambda: e._query_linear_batch(q, 10, None))
        log(f"_query_linear_batch:    {t*1e3:8.2f} ms")

    qd = jnp.asarray(q)
    rt = e.topk_recall

    def kern():
        d_, i_ = ivf_union_scan_topk_pq(
            qd, dc["codes_g"], dc["norms_g"], dc["order_g"],
            dc["codewords"], dc["centers_dec_v"], dc["centers_norms_v"],
            w=wv, topk=10, cap_u=dc["cap_v"], nlist_pad=dc["nlist_v_pad"],
            recall_target=rt)
        np.asarray(d_)

    t = timed(kern)
    log(f"raw pq union op:        {t*1e3:8.2f} ms (engine dc arrays)")


if __name__ == "__main__":
    main()
