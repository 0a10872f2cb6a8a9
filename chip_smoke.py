#!/usr/bin/env python3
"""End-to-end smoke test of rii-tpu on an NVIDIA GPU at the SIFT1M shape.

    python chip_smoke.py               # one card: phases (a)-(f) below
    python chip_smoke.py --four-cards  # ShardedRii over four cards, only that

The configuration is the reference's SIFT1M setup (BASELINE.md): N=1,000,000,
D=128, M=32, Ks=256, nlist=1000, L=5000, PQ trained on 100k rows. The data is
a seeded Gaussian mixture at that shape (no dataset files are needed); the
queries are independent draws, not database rows.

Phases, each printing its own lines:
  (a) device: platform, kind, count, JAX version, XLA_FLAGS, compile cache,
      and the card's name and power limit from nvidia-smi;
  (b) build: PQ fit, add, reconfigure and the device cache, with wall times;
  (c) queries through the public API: query, query_batch (linear at Q=128 and
      Q=1024, IVF at L=5000), subsets of 1,000 and 100,000 ids, add then
      reconfigure, a QueryServer, a save_index/load_index round trip;
  (d) every result of (c) against the NumPy oracle (rii_tpu/utils/oracle.py)
      within the tolerances stated at ORACLE_* below;
  (e) the fused replica kernel against the plain XLA scan at N=1M, Q=128 and
      Q=1024: agreement, then median times; the XLA union-IVF time beside;
  (f) the last line: {"ok": true, "device": {...}}.

Without a GPU the script exits non-zero before printing any result. Any
failed check raises, so the script exits non-zero with the traceback.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

# --- oracle tolerances (phase d) -------------------------------------------
# Returned distances equal the oracle ADC of the returned ids: the exact
# rescore runs in f32 at Precision.HIGHEST (no TF32), so only summation order
# differs from the oracle's f32 table sums.
ORACLE_RTOL = 1e-4
# Linear recall@10 against the oracle's exact top-10: one candidate per
# 128-slot tile, with a 2x overfetched exact rescore (the tile-min class).
ORACLE_RECALL = 0.99
# Batches of Q >= 512 skip the exact rescore by default (Rii.exact_rescore
# "auto"): distances carry the bf16 cross term. Rounding q and x to bf16
# moves each product q_i x_i by at most 2^-8 of itself, so the distance moves
# by at most 2^-8 (||q||^2 + ||x||^2); near-ties at rank 10 can swap.
BF16_BOUND = 2.0 ** -8
BF16_RECALL = 0.95
# IVF: the share of (query, rank) entries whose distance is no worse than
# the oracle walk's at that rank (to ORACLE_RTOL). The probe union is a
# superset of the walk's candidates, so every rank; where the batch's union
# covers most of the index, the engine widens to the linear scan, whose
# tile-min class allows the share ORACLE_RECALL.
IVF_DOMINANCE = 1.0
N_CHECK = 32  # queries compared with the oracle per result

SIFT1M = dict(n=1_000_000, d=128, m=32, ks=256, nlist=1000, L=5000,
              n_train=100_000, n_add=10_000, n_clusters=1024,
              subsets=(1000, 100_000))
FOUR_CARDS = dict(SIFT1M, n=4_000_000, nlist=2000)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_lines():
    """The card's name and power limit, from a process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def make_data(cfg, seed, nq):
    """Seeded Gaussian mixture at the configuration's shape: database rows,
    extra rows for add(), and independent queries."""
    rng = np.random.default_rng(seed)
    d = cfg["d"]
    centers = rng.uniform(0.0, 64.0, (cfg["n_clusters"], d)).astype(
        np.float32)
    # low intrinsic dimension, as in SIFT: a 16-d latent spread over D
    basis = rng.normal(0.0, 3.0, (16, d)).astype(np.float32)

    def draw(k):
        lab = rng.integers(0, cfg["n_clusters"], k)
        z = rng.normal(0.0, 1.0, (k, 16)).astype(np.float32)
        return (centers[lab] + z @ basis
                + rng.normal(0.0, 1.0, (k, d)).astype(np.float32))

    x = draw(cfg["n"])
    x_add = draw(cfg["n_add"])
    q = draw(nq)
    return x, x_add, q


# --------------------------------------------------------------------------- #
# oracle comparisons (phase d)
# --------------------------------------------------------------------------- #

def oracle_adc(queries, codewords, codes):
    """(Q, N) exact ADC of every code, from the oracle's distance table."""
    from rii_tpu.utils.oracle import dtable_np
    m, ks, _ = codewords.shape
    flat = codes.astype(np.int64) + np.arange(m, dtype=np.int64) * ks
    out = np.empty((len(queries), len(codes)), np.float32)
    for i, q in enumerate(queries):
        out[i] = dtable_np(q, codewords).reshape(-1)[flat].sum(1)
    return out


def check_linear(name, ids, dists, adc, tids=None, bf16_scale=None):
    """Linear results of the first N_CHECK queries against the oracle.
    bf16_scale: ||q||^2 + ||x||^2 per result for a batch without the exact
    rescore, whose distance error is bounded by BF16_BOUND times it."""
    bf16 = bf16_scale is not None
    rtol = BF16_BOUND if bf16 else ORACLE_RTOL
    min_recall = BF16_RECALL if bf16 else ORACLE_RECALL
    ids, dists = ids[:N_CHECK], dists[:N_CHECK]
    nq, topk = ids.shape
    assert (ids >= 0).all(), f"{name}: missing results"
    cand = np.arange(adc.shape[1]) if tids is None else np.asarray(tids)
    if tids is not None:
        assert np.isin(ids, cand).all(), f"{name}: id outside the subset"
    sub = adc[:nq][:, cand]
    part = np.argpartition(sub, topk - 1, axis=1)[:, :topk]
    want = cand[part]
    recall = np.mean([len(set(a) & set(b)) / topk
                      for a, b in zip(ids.tolist(), want.tolist())])
    got = np.take_along_axis(adc[:nq], ids, axis=1)
    scale = bf16_scale[:nq] if bf16 else np.maximum(got, 1e-6)
    err = float(np.max(np.abs(dists - got) / scale))
    ok = recall >= min_recall and err <= rtol
    what = "dist err / (|q|^2+|x|^2)" if bf16 else "rel dist err"
    log("oracle", f"{name}: recall@{topk}={recall:.4f} (>= {min_recall}) "
        f"max {what}={err:.2e} (<= {rtol:.2e}) -> "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, name


def check_ivf(name, e, queries, ids, dists, L, adc, tids=None, union=None):
    """IVF results against the oracle's reference walk on the engine's own
    centers and posting lists: exact distances for the returned ids, and
    never worse than the oracle at any rank (see IVF_DOMINANCE)."""
    from rii_tpu.utils.oracle import query_ivf_oracle
    codes, pl, centers = e.codes, e.posting_lists, e.coarse_centers
    if union is None:
        union = ivf_union_runs(e, len(ids), L,
                               None if tids is None else len(tids))
    need = IVF_DOMINANCE if union else ORACLE_RECALL
    n = min(N_CHECK, len(ids))
    rel, err = [], 0.0
    for r in range(n):
        _, d_o = query_ivf_oracle(queries[r], ids.shape[1], L, e.codewords,
                                  centers, pl, codes, target_ids=tids)
        k = len(d_o)
        assert (ids[r, :k] >= 0).all(), f"{name}: missing results"
        if tids is not None:
            assert np.isin(ids[r, :k], tids).all(), f"{name}: outside subset"
        rel.append(dists[r, :k] / d_o - 1.0)
        got = adc[r, ids[r, :k]]
        err = max(err, float(np.max(np.abs(dists[r, :k] - got) / got)))
    rel = np.concatenate(rel)
    dom = float(np.mean(rel <= ORACLE_RTOL))
    ok = dom >= need and err <= ORACLE_RTOL
    log("oracle", f"{name} [{'union' if union else 'widened to linear'}]: "
        f"ranks no worse than the oracle walk "
        f"{dom:.4f} (>= {need}; worst {rel.max():+.2e}) "
        f"max rel dist err={err:.2e} (<= {ORACLE_RTOL}) -> "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, name


def ivf_union_runs(e, qn, L, s=None):
    """True when query_batch(method='ivf') scans the probe union instead of
    widening to the linear scan (Rii._query_ivf_batch's own rule)."""
    dc = e._ensure_cache()
    wv = e._probe_width_virtual(L, s, dc)
    qp = 1 << max(0, (qn - 1).bit_length())
    return (wv < dc["nlist_v"]
            and 2 * min(qp * wv, dc["nlist_v"]) * dc["cap_v"] < dc["cap"])


def median_time(fn, reps=20, warmup=3):
    """Median seconds of fn() on the host clock, each call ending in
    block_until_ready (fn's inputs already on the device)."""
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def timed(phase, what, fn):
    t0 = time.perf_counter()
    out = fn()
    log(phase, f"{what}: {time.perf_counter() - t0:.2f} s")
    return out


# --------------------------------------------------------------------------- #
# one card
# --------------------------------------------------------------------------- #

def build(cfg, x):
    from rii_tpu import PQ, Rii
    pq = timed("build", f"PQ fit (M={cfg['m']}, Ks={cfg['ks']}, "
               f"{cfg['n_train']} rows)",
               lambda: PQ(M=cfg["m"], Ks=cfg["ks"]).fit(x[:cfg["n_train"]]))
    e = Rii(pq)
    timed("build", f"add ({len(x)} rows, encode)",
          lambda: e.add(x, update_posting_lists=False))
    timed("build", f"reconfigure (nlist={cfg['nlist']})",
          lambda: e.reconfigure(nlist=cfg["nlist"]))
    dc = timed("build", "device cache", e._ensure_cache)
    stats = {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in e.last_cache_build_stats.items()}
    log("build", f"last_cache_build_stats: {stats}")
    log("build", f"resolved tier: {dc['mode']} "
        f"(replica budget {e._cache_budget()} bytes); linear path: "
        f"{'fused kernel' if e._use_replica_kernel(cfg['d']) else 'XLA'}; "
        f"IVF windows: {'bf16' if 'decoded_g' in dc else 'uint8 codes'}")
    return e


def run_queries(cfg, e, x_add, q):
    """Phases (c) and (d) on one engine."""
    from rii_tpu import QueryServer
    from rii_tpu.models.ivf import code_norms_np
    from rii_tpu.utils.serialization import load_index, save_index

    L, topk = cfg["L"], 10
    qc = q[:N_CHECK]
    adc = timed("oracle", f"oracle ADC for {N_CHECK} queries",
                lambda: oracle_adc(qc, e.codewords, e.codes))

    ids, d = e.query(q[0], topk=topk)
    l_auto = e._multiple_of_L0_covering_topk(topk)
    check_ivf("query (one query, method auto)", e, q[:1], ids[None],
              d[None], l_auto, adc,
              union=(not e._use_linear(e.N, l_auto)
                     and ivf_union_runs(e, 1, l_auto)))

    for qn in (128, 1024):
        ids, d = timed("query", f"query_batch linear Q={qn}",
                       lambda: e.query_batch(q[:qn], topk=topk,
                                             method="linear"))
        if e._resolve_rescore(qn):
            check_linear(f"linear Q={qn}", ids, d, adc)
        else:
            nq = min(N_CHECK, qn)
            scale = ((q[:nq] ** 2).sum(1)[:, None]
                     + code_norms_np(e.codewords,
                                     e.codes[ids[:nq].reshape(-1)]
                                     ).reshape(nq, -1))
            check_linear(f"linear Q={qn} (no rescore, bf16 class)", ids, d,
                         adc, bf16_scale=scale)
            e.exact_rescore = True
            ids, d = e.query_batch(q[:qn], topk=topk, method="linear")
            e.exact_rescore = "auto"
            check_linear(f"linear Q={qn} (exact_rescore=True)", ids, d, adc)

    for qn in (8, 64):
        ids, d = timed("query", f"query_batch ivf L={L} Q={qn}",
                       lambda: e.query_batch(q[:qn], topk=topk, L=L,
                                             method="ivf"))
        check_ivf(f"ivf L={L} Q={qn}", e, q, ids, d, L, adc)

    rng = np.random.default_rng(7)
    for s in cfg["subsets"]:
        tids = np.sort(rng.choice(e.N, s, replace=False)).astype(np.int64)
        ids, d = timed("query", f"query_batch subset |S|={s} Q={N_CHECK}",
                       lambda: e.query_batch(qc, topk=topk, target_ids=tids,
                                             method="linear"))
        check_linear(f"subset |S|={s}", ids, d, adc, tids=tids)

    timed("query", f"add {len(x_add)} rows", lambda: e.add(x_add))
    timed("query", f"reconfigure (nlist={cfg['nlist']})",
          lambda: e.reconfigure(nlist=cfg["nlist"]))
    adc = np.concatenate(
        [adc, oracle_adc(qc, e.codewords, e.codes[-len(x_add):])], axis=1)
    ids, d = timed("query", f"query_batch linear after add, N={e.N}",
                   lambda: e.query_batch(qc, topk=topk, method="linear"))
    check_linear("linear after add+reconfigure", ids, d, adc)
    ids, d = e.query_batch(q[:8], topk=topk, L=L, method="ivf")
    check_ivf("ivf after add+reconfigure", e, q, ids, d, L, adc)

    with QueryServer(e, max_batch=64, max_wait_ms=2.0) as srv:
        futs = [None] * N_CHECK

        def client(k):
            for r in range(k, N_CHECK, 4):
                futs[r] = srv.submit(qc[r], topk=topk, method="linear")

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        res = [f.result(timeout=300) for f in futs]
        st = srv.stats()
    ids = np.stack([r[0] for r in res])
    d = np.stack([r[1] for r in res])
    log("query", f"QueryServer: {N_CHECK} requests from 4 threads, "
        f"stats {st}")
    check_linear("QueryServer", ids, d, adc)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".smoke_index")
    try:
        timed("query", "save_index", lambda: save_index(e, path))
        e2 = timed("query", "load_index", lambda: load_index(path))
        ids2, d2 = timed("query", "first query after load (linear)",
                         lambda: e2.query_batch(qc, topk=topk,
                                                method="linear"))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    check_linear("after load_index", ids2, d2, adc)
    ids, d = e2.query_batch(q[:8], topk=topk, L=L, method="ivf")
    check_ivf("ivf after load_index", e2, q, ids, d, L, adc)
    return e


def kernel_vs_xla(cfg, e, q):
    """Phase (e): the fused replica kernel against the plain XLA scan."""
    import jax
    import jax.numpy as jnp
    from rii_tpu.ops.ivf import ivf_union_scan_topk
    from rii_tpu.ops.replica_scan import replica_scan_topk
    from rii_tpu.ops.scan import linear_scan_topk_decoded

    dc = e._ensure_cache()
    dec, nrm = dc["decoded_flat"], dc["norms_flat"]
    rt, topk = e.topk_recall, 10
    for qn in (128, 1024):
        qd = jnp.asarray(q[:qn])
        rs = e._resolve_rescore(qn)
        kw = dict(codes=dc["codes_flat"] if rs else None,
                  codewords=dc["codewords"] if rs else None,
                  recall_target=rt)

        def kern():
            return replica_scan_topk(qd, dec, nrm, topk=topk,
                                     interpret=e._interp(), **kw)

        def xla():
            return linear_scan_topk_decoded(qd, dec, nrm, topk=topk,
                                            block=dc["block_dec"], **kw)

        (dk, ik), (dx, ix) = map(np.asarray, kern()), map(np.asarray, xla())
        agree = np.mean([len(set(a) & set(b)) / topk
                         for a, b in zip(ik.tolist(), ix.tolist())])
        top1 = float((ik[:, 0] == ix[:, 0]).mean())
        log("kernel", f"Q={qn} rescore={rs}: kernel vs XLA recall@{topk}="
            f"{agree:.4f} top-1 agreement={top1:.4f}")
        assert agree >= ORACLE_RECALL and top1 >= ORACLE_RECALL, qn
        t_k, t_x = median_time(kern), median_time(xla)
        log("kernel", f"Q={qn} N={e.N}: fused kernel {t_k * 1e3:.3f} ms, "
            f"XLA scan {t_x * 1e3:.3f} ms (median call, block_until_ready)")

        qn_host = np.ascontiguousarray(q[:qn])

        def e2e():
            return e.query_batch(qn_host, topk=topk, method="linear")

        t_ke = median_time(e2e, reps=10)
        e._use_replica_kernel = lambda d: False  # this instance only
        try:
            t_xe = median_time(e2e, reps=10)
        finally:
            del e._use_replica_kernel
        log("kernel", f"Q={qn} end to end query_batch: with kernel "
            f"{t_ke * 1e3:.3f} ms, with XLA scan {t_xe * 1e3:.3f} ms")

    L, qn = cfg["L"], 8
    qd = jnp.asarray(q[:qn])
    wv = e._probe_width_virtual(L, None, dc)
    rs = e._resolve_rescore(qn)

    def ivf():
        return ivf_union_scan_topk(
            qd, dc["decoded_g"], dc["norms_g"], dc["order_g"],
            dc["centers_dec_v"], dc["centers_norms_v"], w=wv, topk=topk,
            cap_u=dc["cap_v"], nlist_pad=dc["nlist_v_pad"], recall_target=rt,
            codes=dc["codes_flat"] if rs else None,
            codewords=dc["codewords"] if rs else None)

    t_i = median_time(ivf)
    qh = np.ascontiguousarray(q[:qn])
    t_ie = median_time(lambda: e.query_batch(qh, topk=topk, L=L,
                                             method="ivf"), reps=10)
    log("kernel", f"XLA union IVF L={L} Q={qn} (wv={wv}): "
        f"{t_i * 1e3:.3f} ms per call, end to end query_batch "
        f"{t_ie * 1e3:.3f} ms")


def one_card(cfg, seed):
    x, x_add, q = timed("build", f"seeded data N={cfg['n']} D={cfg['d']}",
                        lambda: make_data(cfg, seed, 1024))
    e = build(cfg, x)
    del x
    run_queries(cfg, e, x_add, q)
    kernel_vs_xla(cfg, e, q)


# --------------------------------------------------------------------------- #
# four cards
# --------------------------------------------------------------------------- #

def compare(name, ids_s, d_s, ids_1, d_1):
    """Sharded against single-device answers: same ids (up to near-ties),
    same exact distances where the ids agree."""
    topk = ids_s.shape[1]
    agree = np.mean([len(set(a) & set(b)) / topk
                     for a, b in zip(ids_s.tolist(), ids_1.tolist())])
    same = ids_s == ids_1
    err = float(np.max(np.abs(d_s - d_1)[same] / d_1[same])) \
        if same.any() else 0.0
    ok = agree >= ORACLE_RECALL and err <= ORACLE_RTOL
    log("four", f"{name}: sharded vs one device recall@{topk}={agree:.4f} "
        f"max rel dist err={err:.2e} -> {'ok' if ok else 'FAIL'}")
    assert ok, name


def four_cards(cfg, seed):
    import jax
    from rii_tpu.parallel import make_mesh
    from rii_tpu.parallel.distributed import ShardedRii

    assert len(jax.devices()) >= 4, "--four-cards needs four devices"
    x, _, q = timed("build", f"seeded data N={cfg['n']} D={cfg['d']}",
                    lambda: make_data(cfg, seed, 128))
    e = build(cfg, x)  # the single-device reference, on device 0
    del x
    sr = timed("four", "ShardedRii over make_mesh(4)",
               lambda: ShardedRii(e, mesh=make_mesh(4)))
    log("four", f"shards: cap={sr.cap} tier="
        f"{'bf16' if sr.decoded is not None else 'pq'} "
        f"kernel={sr._use_kernel()} ivf={sr.ivf['mode']}")
    L, topk, qc = cfg["L"], 10, q[:N_CHECK]
    adc = timed("oracle", f"oracle ADC for {N_CHECK} queries",
                lambda: oracle_adc(qc, e.codewords, e.codes))
    tids = np.sort(np.random.default_rng(11).choice(
        e.N, e.N // 10, replace=False)).astype(np.int64)

    ids_s, d_s = timed("four", "sharded linear Q=128",
                       lambda: sr.query_batch(q, topk=topk))
    ids_1, d_1 = timed("four", "one-device linear Q=128",
                       lambda: e.query_batch(q, topk=topk, method="linear"))
    compare("linear Q=128", ids_s, d_s, ids_1, d_1)
    check_linear("sharded linear", ids_s, d_s, adc)

    ids_s, d_s = timed("four", "sharded subset 10% Q=32",
                       lambda: sr.query_batch(qc, topk=topk, target_ids=tids))
    ids_1, d_1 = e.query_batch(qc, topk=topk, target_ids=tids,
                               method="linear")
    compare("subset 10%", ids_s, d_s, ids_1, d_1)
    check_linear("sharded subset 10%", ids_s, d_s, adc, tids=tids)

    for t, lab in ((None, "ivf"), (tids, "ivf subset 10%")):
        ids_s, d_s = timed("four", f"sharded {lab} L={L} Q={N_CHECK}",
                           lambda: sr.query_ivf_batch(qc, topk=topk, L=L,
                                                      target_ids=t))
        ids_1, d_1 = e.query_batch(qc, topk=topk, L=L, target_ids=t,
                                   method="ivf")
        compare(f"{lab} Q={N_CHECK}", ids_s, d_s, ids_1, d_1)
        check_ivf(f"sharded {lab}", e, q, ids_s, d_s, L, adc, tids=t)


# --------------------------------------------------------------------------- #

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only ShardedRii over four cards (N=4M)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    import rii_tpu

    log("device", f"platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    log("device", f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile cache={jax.config.jax_compilation_cache_dir} "
        f"(rii_tpu {rii_tpu.__version__})")
    log("device", "nvidia-smi --query-gpu=name,power.limit:")
    for line in nvidia_smi_lines():
        print(line, flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(FOUR_CARDS, args.seed)
    else:
        one_card(SIFT1M, args.seed)
    for i, dev in enumerate(jax.devices()):
        ms = dev.memory_stats() or {}
        log("device", f"device {i} peak_bytes_in_use="
            f"{ms.get('peak_bytes_in_use')} bytes_limit="
            f"{ms.get('bytes_limit')}")
    log("device", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
