#!/usr/bin/env python
"""SIFT1B-config readiness run on ONE device, synthetic codes.

The reference's billion-scale flow (/root/reference/examples/benchmark/
run_sift1b.py:61-72) uses M=8, Ks=256, D=128, nlist=sqrt(1e9)~31623. The
real 255 GB dataset cannot be fetched here (no egress), so this exercises
the exact CONFIG SHAPE — the big-nlist host layout, the k=31623 PQk-means,
the 126k-virtual-window IVF — at a configurable N (SHAPE_N), with synthetic
codes ingested through the public add_codes migration path (what a real 1B
deployment sharded per device would do per shard).

Timed stages: add_codes ingest, reconfigure(nlist=31623) [fit 3.16M codes
to k=31623 + predict all N], first-query cache build (host layout + H2D),
steady-state query_batch at Q in {8, 64, 512}, O(batch) add(+100k).

Env: SHAPE_N (default 32M), SHAPE_Q_REPS (default 5), SHAPE_NLIST (31623).
Writes one JSON line to stdout; progress to stderr.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from rii_tpu import PQ, Rii

    N = int(os.environ.get("SHAPE_N", 32 * (1 << 20)))
    NLIST = int(os.environ.get("SHAPE_NLIST", 31623))
    REPS = int(os.environ.get("SHAPE_Q_REPS", 5))
    M, Ks, D = 8, 256, 128
    log(f"device={jax.devices()[0]} N={N} M={M} Ks={Ks} D={D} nlist={NLIST}")

    rng = np.random.RandomState(0)
    # synthetic codebooks + codes: timing readiness is shape-driven, not
    # data-driven (recall vs data shape is RECALL_PARITY/tips territory)
    cw = rng.standard_normal((M, Ks, D // M)).astype(np.float32)
    pq = PQ.from_codewords(cw)
    e = Rii(pq)
    e.scan_mode = "pq"  # the memory-lean tier is the 1B-scale operating point

    out = {"N": N, "nlist": NLIST, "M": M, "Ks": Ks, "D": D, "tier": "pq"}

    t0 = time.perf_counter()
    chunk = 1 << 22
    for s in range(0, N, chunk):
        codes = rng.randint(0, Ks, (min(chunk, N - s), M)).astype(np.uint8)
        e.add_codes(codes, update_posting_lists=False)
    out["ingest_s"] = time.perf_counter() - t0
    log(f"add_codes ingest {N} rows: {out['ingest_s']:.1f}s")

    t0 = time.perf_counter()
    e.reconfigure(nlist=NLIST)
    out["reconfigure_s"] = time.perf_counter() - t0
    out["reconfigure_stages"] = {
        k: round(v, 2) for k, v in e.last_reconfigure_stats.items()}
    log(f"reconfigure(nlist={NLIST}): {out['reconfigure_s']:.1f}s "
        f"(fit {min(N, NLIST*100)} codes to k={NLIST} + predict {N}) "
        f"stages={out['reconfigure_stages']}")

    q512 = rng.standard_normal((512, D)).astype(np.float32)
    t0 = time.perf_counter()
    e.query_batch(q512[:8], topk=10)
    out["first_query_s"] = time.perf_counter() - t0
    out["cache_build_stages"] = {
        k: (round(v, 2) if isinstance(v, float) else v)
        for k, v in getattr(e, "last_cache_build_stats", {}).items()}
    log(f"first query (cache build + compile): {out['first_query_s']:.1f}s "
        f"stages={out['cache_build_stages']}")

    # device-resident IVF timing of the union op (median call, ending in
    # block_until_ready; inputs on the device)
    import jax
    import jax.numpy as jnp
    from rii_tpu.ops.ivf import ivf_union_scan_topk_pq
    dc = e._ensure_cache()
    rt = e.topk_recall
    for Q in (8, 64, 512):
        qd = jnp.asarray(q512[:Q])
        L = e._multiple_of_L0_covering_topk(topk=10)
        wv = e._probe_width_virtual(L, None, dc)

        def once():
            return ivf_union_scan_topk_pq(
                qd, dc["codes_g"], dc["norms_g"], dc["order_g"],
                dc["codewords"], dc["centers_dec_v"], dc["centers_norms_v"],
                w=wv, topk=10, cap_u=dc["cap_v"],
                nlist_pad=dc["nlist_v_pad"], recall_target=rt)

        jax.block_until_ready(once())
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(once())
            ts.append(time.perf_counter() - t0)
        dt = float(np.median(ts))
        out[f"ivf_device_us_per_q_q{Q}"] = dt / Q * 1e6
        log(f"device-resident IVF Q={Q} (wv={wv}): {dt*1e3:.3f} ms/batch "
            f"({dt/Q*1e6:.2f} us/q)")

    for Q in (8, 64, 512):
        q = q512[:Q]
        for method in ("auto", "ivf"):
            e.query_batch(q, topk=10, method=method)  # warm this bucket
            best = np.inf
            for _ in range(REPS):
                t0 = time.perf_counter()
                e.query_batch(q, topk=10, method=method)
                best = min(best, time.perf_counter() - t0)
            out[f"query_ms_q{Q}_{method}"] = best * 1e3
            out[f"query_us_per_q_q{Q}_{method}"] = best * 1e6 / Q
            log(f"query_batch Q={Q} method={method}: {best*1e3:.2f} ms "
                f"({best*1e6/Q:.1f} us/q, "
                f"default L={e._multiple_of_L0_covering_topk(topk=10)})")

    add_codes = rng.randint(0, Ks, (100_000, M)).astype(np.uint8)
    t0 = time.perf_counter()
    e.add_codes(add_codes, update_posting_lists=True)
    out["add_100k_s"] = time.perf_counter() - t0
    ids, _ = e.query_batch(q512[:8], topk=10)
    out["post_add_query_ok"] = bool((ids >= 0).all())
    log(f"O(batch) add(+100k): {out['add_100k_s']:.2f}s; "
        f"post-add query ok={out['post_add_query_ok']}")

    if os.environ.get("SHAPE_CKPT"):
        # checkpoint v2 restore cost at this shape (round-5 VERDICT item 5):
        # the restored first query should skip the host layout rebuild and
        # pay only codes[order] gather + H2D + cached compiles
        import shutil
        import tempfile
        from rii_tpu.utils.serialization import load_index, save_index
        ckpt = os.path.join(tempfile.gettempdir(), "sift1b_ckpt")
        shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.perf_counter()
        save_index(e, ckpt)
        out["ckpt_save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        e2 = load_index(ckpt)
        out["ckpt_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids2, _ = e2.query_batch(q512[:8], topk=10)
        out["ckpt_first_query_s"] = time.perf_counter() - t0
        out["ckpt_cache_build_stages"] = {
            k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in getattr(e2, "last_cache_build_stats", {}).items()}
        out["ckpt_query_match"] = bool((ids2 == ids).all())
        log(f"checkpoint v2: save {out['ckpt_save_s']:.1f}s, "
            f"load {out['ckpt_load_s']:.1f}s, restored first query "
            f"{out['ckpt_first_query_s']:.1f}s (was 99 s rebuild), "
            f"match={out['ckpt_query_match']}")
        shutil.rmtree(ckpt, ignore_errors=True)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
