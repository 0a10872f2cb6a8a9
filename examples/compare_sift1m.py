#!/usr/bin/env python
"""SIFT1M multi-method comparison in the reference's report format
(/root/reference/examples/benchmark/run_sift1m.py:42-62): per method, train
time, add time, then "Runtime/query: {msec} [msec], Recall@{r}: {recall}" —
diffable against the reference's published Table-2 reproduction output.

Real SIFT1M is loaded when present under --data-dir (download_sift1m.sh);
otherwise a synthetic clustered set of the same shape is generated and the
ground truth computed exactly. Offline environments run the methods
`available_methods()` reports (rii + exact here; faiss/annoy/nmslib join
automatically when installed).

Usage:
    python examples/compare_sift1m.py [--data-dir data/sift] [--methods rii,exact]
        [--n 1000000] [--nq 1000] [--r 1] [--per-query]

--per-query times the reference's one-query-at-a-time loop; the default
times the batched dispatch (both report sec/query).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ann_methods  # noqa: E402
from rii_tpu.utils.io import fvecs_read, ivecs_read  # noqa: E402
from rii_tpu.utils.recall import recall_at_r  # noqa: E402


def load_or_synthesize(data_dir, n, nq, d=128):
    base = os.path.join(data_dir, "sift_base.fvecs")
    if os.path.exists(base):
        Xt = fvecs_read(os.path.join(data_dir, "sift_learn.fvecs"))
        Xb = fvecs_read(base, count=n)
        Xq = fvecs_read(os.path.join(data_dir, "sift_query.fvecs"), count=nq)
        gt = ivecs_read(os.path.join(data_dir, "sift_groundtruth.ivecs"),
                        count=nq)
        return Xt, Xb, Xq, gt, "sift1m"
    rng = np.random.RandomState(42)
    nc = max(64, n // 1000)
    centers = rng.normal(0, 1, (nc, d)).astype(np.float32)
    Xb = np.empty((n, d), np.float32)
    step = 1 << 18
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        a = rng.randint(0, nc, hi - lo)
        Xb[lo:hi] = centers[a] + 0.2 * rng.normal(0, 1, (hi - lo, d))
    Xt = Xb[rng.choice(n, min(n, 100_000), replace=False)].copy()
    Xq = (Xb[rng.choice(n, nq, replace=False)]
          + 0.02 * rng.normal(0, 1, (nq, d))).astype(np.float32)
    exact = ann_methods.ExactSearcher()
    exact.add(Xb)
    gt = exact.search_batch(Xq, 1).astype(np.int32)
    return Xt, Xb, Xq, gt, "synthetic"


def run(searcher, Xq, gt, r, per_query=False):
    """Runtime [sec/query] + recall@r — semantics of the reference's run()
    (/root/reference/examples/benchmark/run_sift1m.py:8-33)."""
    nq = Xq.shape[0]
    if per_query:
        I = np.zeros((nq, r), dtype=int)
        t0 = time.time()
        for i, q in enumerate(Xq):
            I[i] = np.asarray(searcher.search(q=q, topk=r))[:r]
        t1 = time.time()
    else:
        searcher.search_batch(Xq[: min(nq, 8)], r)  # warm the jit caches
        t0 = time.time()
        I = searcher.search_batch(Xq, r)
        t1 = time.time()
    duration = (t1 - t0) / nq
    return duration, recall_at_r(I, gt, r)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default="data/sift")
    ap.add_argument("--methods", default=None,
                    help="comma list; default = every available method")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--r", type=int, default=1)
    ap.add_argument("--per-query", action="store_true")
    args = ap.parse_args()

    methods = (args.methods.split(",") if args.methods
               else ann_methods.available_methods())
    Xt, Xb, Xq, gt, source = load_or_synthesize(args.data_dir, args.n,
                                                args.nq)
    print(f"dataset: {source} N={len(Xb)} Nq={len(Xq)} D={Xb.shape[1]}")

    for method in methods:
        print("=== method: {} ===".format(method))
        try:
            searcher = ann_methods.SEARCHERS[method]()
        except RuntimeError as ex:
            print(f"skipped: {ex}")
            continue

        print("Start to train:")
        t0 = time.time()
        searcher.train(Xt)
        print("Finish: {} [sec]".format(time.time() - t0))

        print("Start to add:")
        t0 = time.time()
        searcher.add(Xb)
        print("Finish: {} [sec]".format(time.time() - t0))

        duration, recall = run(searcher, Xq, gt, args.r,
                               per_query=args.per_query)
        print("Runtime/query: {} [msec], Recall@{}: {}".format(
            duration * 1000, args.r, recall))


if __name__ == "__main__":
    main()
