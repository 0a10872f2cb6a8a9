#!/usr/bin/env python
"""Headline benchmark: SIFT1M-scale exact ADC search on one device.

Config mirrors the reference's SIFT1M setup at BASELINE.json's bit-width
(N=1M, D=128, M=32, Ks=256, nlist=1000). Baseline to beat: the reference's
published 0.21 ms/query at N=1,011,000 / M=32 after reconfigure()
(/root/reference/README.md:140) => 4,762 QPS on CPU.

Every number is end to end through ``Rii.query_batch`` (host arrays in and
out, transfers included), on the host clock.

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": speedup,
   "device": {"platform": ..., "kind": ..., "count": ...}}
Auxiliary numbers (device, build time, recall, ivf latency) go to stderr.
"""

import json
import os
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def exact_nn_ids(X, queries, block=131072):
    """Ground-truth nearest neighbor ids (exact f32 L2) computed on device."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n, d = X.shape
    nb = -(-n // block)
    npad = nb * block
    Xp = np.zeros((npad, d), np.float32)
    Xp[:n] = X
    xsq = np.full(npad, np.inf, np.float32)
    xsq[:n] = (X.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = jnp.asarray(queries)

    @jax.jit
    def run(xb, sb):
        def f(args):
            xblk, sblk, base = args
            s = sblk[None, :] - 2.0 * jnp.dot(q, xblk.T,
                                              precision=lax.Precision.HIGHEST,
                                              preferred_element_type=jnp.float32)
            neg, idx = lax.top_k(-s, 1)
            return neg[:, 0], idx[:, 0] + base

        bases = jnp.arange(nb, dtype=jnp.int32) * block
        negs, idxs = lax.map(f, (xb, sb, bases))  # (nb, Q)
        best = jnp.argmax(negs, axis=0)  # (Q,)
        return jnp.take_along_axis(idxs, best[None, :], axis=0)[0]

    return np.asarray(run(jnp.asarray(Xp.reshape(nb, block, d)),
                          jnp.asarray(xsq.reshape(nb, block))))


def timed_query(e, queries, reps=5, **kw):
    """Median seconds of one query_batch call after a warm-up (compile)."""
    out = e.query_batch(queries, **kw)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = e.query_batch(queries, **kw)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def main():
    import jax
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")
    on_accel = dev.platform != "cpu"

    N = int(os.environ.get("BENCH_N", 1_000_000 if on_accel else 100_000))
    # defaults = the SIFT1M-class config; BENCH_D=96 BENCH_M=12 gives the
    # Deep1B-class config (BASELINE.md config 5)
    D = int(os.environ.get("BENCH_D", 128))
    M = int(os.environ.get("BENCH_M", 32))
    Ks = 256
    nlist = 1000 if N >= 500_000 else max(16, int(np.sqrt(N)))
    Q = int(os.environ.get("BENCH_Q", 1024 if on_accel else 256))
    topk = 10
    log(f"N={N} D={D} M={M} Ks={Ks} nlist={nlist} Q={Q} topk={topk}")

    rng = np.random.RandomState(123)
    X = rng.random((N, D)).astype(np.float32)
    qidx = rng.choice(N, Q, replace=False)
    queries = (X[qidx] + rng.normal(0, 0.01, (Q, D))).astype(np.float32)

    from rii_tpu import PQ, Rii

    t0 = time.perf_counter()
    pq = PQ(M=M, Ks=Ks).fit(X[: min(N, 100_000)], iter=10)
    t_fit = time.perf_counter() - t0
    log(f"PQ fit: {t_fit:.1f}s")

    t0 = time.perf_counter()
    e = Rii(fine_quantizer=pq)
    e.add_configure(X, nlist=nlist, iter=5)
    t_build = time.perf_counter() - t0
    log(f"add_configure: {t_build:.1f}s (nlist={e.nlist}, L0={e.L0})")

    # ---- linear exact-ADC scan throughput (the headline) ----
    dt, (ids, _) = timed_query(e, queries, topk=topk, method="linear")
    qps = Q / dt
    log(f"linear query_batch: {dt * 1e3:.3f} ms/batch, "
        f"{dt / Q * 1e3:.4f} ms/query, {qps:.0f} QPS "
        f"(tier={e._ensure_cache()['mode']})")

    # ---- recall@1 vs exact f32 ground truth on a query subset ----
    nq_gt = min(Q, 128)
    gt = exact_nn_ids(X, queries[:nq_gt])
    recall1 = float((ids[:nq_gt, :1] == gt[:, None]).any(1).mean())
    recall10 = float((ids[:nq_gt] == gt[:, None]).any(1).mean())
    log(f"recall@1={recall1:.3f} recall@10={recall10:.3f} (PQ M={M}, exact-ADC scan)")

    # ---- ivf path latency + recall (reference-style L) ----
    L = 5000 if N >= 500_000 else e._multiple_of_L0_covering_topk(topk)
    qiv = queries[:64]
    dt_ivf, (ids_ivf, _) = timed_query(e, qiv, topk=topk, L=L, method="ivf")
    nq_iv = min(len(qiv), nq_gt)
    ivf_r1 = float((ids_ivf[:nq_iv, :1] == gt[:nq_iv, None]).any(1).mean())
    ivf_r10 = float((ids_ivf[:nq_iv] == gt[:nq_iv, None]).any(1).mean())
    log(f"ivf (L={L}, Q={len(qiv)}): {dt_ivf / len(qiv) * 1e3:.4f} ms/query, "
        f"recall@1={ivf_r1:.3f} recall@10={ivf_r10:.3f}")

    baseline_qps = 1.0 / 0.21e-3  # 0.21 ms/query, README.md:140
    print(json.dumps({
        "metric": "sift1m_linear_adc_qps",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / baseline_qps, 2),
        "device": device,
    }))


if __name__ == "__main__":
    main()
