"""Engine-level GPU-path coverage on CPU: the `pallas_interpret` test hook
runs the path the GPU takes (the fused bf16 replica kernel with its exact
rescore, masked subsets folded into the norms) through Pallas interpret
mode, and compares against the plain CPU engine. scan_mode="int8" (older
checkpoints) resolves to the same bf16 path; "pq" keeps the codes only."""

import numpy as np
import pytest

from rii_tpu import PQ, Rii


def _build(scan_mode, n=6000, d=64, seed=9):
    rng = np.random.RandomState(seed)
    X = rng.random((n, d)).astype(np.float32)
    pq = PQ(M=8, Ks=32).fit(X[:1024], iter=3)
    e = Rii(pq)
    e.scan_mode = scan_mode
    e.pallas_interpret = True  # run the GPU kernel path via interpret
    e.add_configure(X, nlist=40, iter=3)
    ref = Rii(pq)
    ref.scan_mode = "pq"
    ref.topk_recall = None  # exact XLA baseline
    ref.add_configure(X, nlist=40, iter=3)
    return e, ref, X, rng


@pytest.mark.parametrize("scan_mode", ["bf16", "int8", "pq"])
def test_interpret_linear_matches_cpu_engine(scan_mode):
    e, ref, X, rng = _build(scan_mode)
    dc = e._ensure_cache()
    assert ("decoded_flat" in dc) == (scan_mode != "pq"), (scan_mode,
                                                          sorted(dc))
    q = X[:8]
    ids, d = e.query_batch(q, topk=5, method="linear")
    ids_r, d_r = ref.query_batch(q, topk=5, method="linear")
    np.testing.assert_allclose(d, d_r, rtol=3e-2, atol=3e-2)  # bf16 class
    assert (ids == ids_r).mean() > 0.8  # near-tie swaps only
    assert ids[0, 0] == ids_r[0, 0]


@pytest.mark.parametrize("scan_mode", ["bf16", "int8"])
def test_interpret_masked_subset(scan_mode):
    """Large subsets fold the mask into the norms the kernel reads."""
    e, ref, X, rng = _build(scan_mode)
    tids = np.sort(rng.choice(e.N, 5000, replace=False)).astype(np.int64)
    q = X[:4]
    ids, d = e.query_batch(q, topk=5, target_ids=tids, method="linear")
    ids_r, d_r = ref.query_batch(q, topk=5, target_ids=tids, method="linear")
    # documented accuracy class at tiny N: one candidate per 128-slot tile,
    # so a lower rank can slip when two of the true top-k share a tile —
    # per-rank distances can only be >= the exact scan's (never better)
    assert (d >= d_r - 3e-2).all()
    np.testing.assert_allclose(d[:, 0], d_r[:, 0], rtol=3e-2, atol=3e-2)
    for row in ids:
        assert set(row[row >= 0].tolist()) <= set(tids.tolist())
    assert ids[0, 0] == ids_r[0, 0]
