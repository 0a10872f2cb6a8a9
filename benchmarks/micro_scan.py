"""Microbenchmark of linear-scan variants on the current default device.

Each variant is timed as the median of several calls on the host clock,
each ending in block_until_ready (inputs already on the device).

Usage: python benchmarks/micro_scan.py [N_log2] [Q]
"""

import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax import lax


def timeit(f, *args, reps=8):
    jax.block_until_ready(f(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    nlog = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    Q = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    N = 1 << nlog
    D, K = 128, 10
    print(f"device={jax.devices()[0]} N={N} D={D} Q={Q} topk={K}", flush=True)

    rng = np.random.RandomState(0)
    dec = jnp.asarray(rng.random((N, D)).astype(np.float32)).astype(jnp.bfloat16)
    dec = jax.block_until_ready(dec)
    norms = jnp.asarray(rng.random(N).astype(np.float32))
    q = jnp.asarray(rng.random((Q, D)).astype(np.float32))

    from rii_tpu.ops.scan import linear_scan_topk_decoded
    from rii_tpu.ops.replica_scan import kernel_supports, replica_scan_topk

    def report(name, t):
        print(f"{name:<36}: {t*1e3:8.2f} ms ({t/Q*1e6:8.2f} us/q, "
              f"{Q/t:10.0f} qps)", flush=True)

    for block in (65536, 262144):
        if block > N:
            continue
        t = timeit(partial(linear_scan_topk_decoded, topk=K, block=block),
                   q, dec, norms)
        report(f"blocked exact top_k block={block}", t)

    if jax.devices()[0].platform == "gpu" and kernel_supports(D):
        report("fused replica kernel (Triton)",
               timeit(partial(replica_scan_topk, topk=K), q, dec, norms))

    @jax.jit
    def full_exact(q_, dec_, norms_):
        s = norms_[None, :] - 2.0 * jnp.dot(q_.astype(jnp.bfloat16), dec_.T,
                                            preferred_element_type=jnp.float32)
        neg, idx = lax.top_k(-s, K)
        return -neg, idx

    @jax.jit
    def full_approx(q_, dec_, norms_):
        s = norms_[None, :] - 2.0 * jnp.dot(q_.astype(jnp.bfloat16), dec_.T,
                                            preferred_element_type=jnp.float32)
        neg, idx = lax.approx_max_k(-s, K, recall_target=0.99)
        return -neg, idx

    if Q * N * 4 <= 6 << 30:
        report("full GEMM + exact top_k", timeit(full_exact, q, dec, norms))
        report("full GEMM + approx_max_k(.99)", timeit(full_approx, q, dec, norms))

    @partial(jax.jit, static_argnames=("block",))
    def blocked_approx(q_, dec_, norms_, block):
        nb = N // block
        qsq = jnp.sum(q_ * q_, -1)

        def f(args):
            d_b, n_b, base = args
            s = n_b[None, :] - 2.0 * jnp.dot(q_.astype(jnp.bfloat16), d_b.T,
                                             preferred_element_type=jnp.float32)
            neg, idx = lax.approx_max_k(-s, K, recall_target=0.99)
            return neg, idx + base

        bases = jnp.arange(nb, dtype=jnp.int32) * block
        negs, idxs = lax.map(f, (dec_.reshape(nb, block, D),
                                 norms_.reshape(nb, block), bases))
        negs = jnp.swapaxes(negs, 0, 1).reshape(Q, nb * K)
        idxs = jnp.swapaxes(idxs, 0, 1).reshape(Q, nb * K)
        neg, pos = lax.top_k(negs, K)
        return -neg + qsq[:, None], jnp.take_along_axis(idxs, pos, 1)

    for block in (262144,):
        if block <= N:
            t = timeit(partial(blocked_approx, block=block), q, dec, norms)
            report(f"blocked approx_max_k block={block}", t)

    @jax.jit
    def gemm_only(q_, dec_):
        return jnp.dot(q_.astype(jnp.bfloat16), dec_.T,
                       preferred_element_type=jnp.float32).sum(axis=1)

    t = timeit(gemm_only, q, dec)
    flops = 2 * Q * N * D
    print(f"pure GEMM (no topk)                 : {t*1e3:8.2f} ms "
          f"({flops/t/1e12:6.1f} TFLOP/s, mem {N*D*2/t/1e9:6.0f} GB/s)", flush=True)


if __name__ == "__main__":
    main()
