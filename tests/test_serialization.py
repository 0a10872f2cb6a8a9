"""Directory checkpoint save/load round-trip tests."""

import numpy as np

from rii_tpu import PQ, OPQ, Rii
from rii_tpu.utils.serialization import save_index, load_index


def _data(n=1000, d=40, seed=123):
    return np.random.RandomState(seed).random((n, d)).astype(np.float32)


def test_save_load_roundtrip(tmp_path):
    X = _data()
    e1 = Rii(fine_quantizer=PQ(M=4, Ks=20).fit(X))
    e1.add_configure(vecs=X, nlist=20)
    save_index(e1, str(tmp_path / "idx"))
    e2 = load_index(str(tmp_path / "idx"))
    assert (e1.M, e1.Ks, e1.N, e1.nlist) == (e2.M, e2.Ks, e2.N, e2.nlist)
    np.testing.assert_array_equal(e1.codes, e2.codes)
    np.testing.assert_array_equal(e1.coarse_centers, e2.coarse_centers)
    assert e1.posting_lists == e2.posting_lists
    np.testing.assert_array_equal(np.poly1d(e1.threshold).coeffs,
                                  np.poly1d(e2.threshold).coeffs)
    ids1, d1 = e1.query(X[0], topk=5)
    ids2, d2 = e2.query(X[0], topk=5)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_allclose(d1, d2)
    # restored engine stays mutable
    e2.add(X)
    assert e2.N == 2 * e1.N


def test_save_load_opq(tmp_path):
    X = _data()
    e1 = Rii(fine_quantizer=OPQ(M=4, Ks=20).fit(X, rotation_iter=2))
    e1.add_configure(vecs=X, nlist=10)
    save_index(e1, str(tmp_path / "idx"))
    e2 = load_index(str(tmp_path / "idx"))
    np.testing.assert_array_equal(e1.fine_quantizer.rotation_matrix,
                                  e2.fine_quantizer.rotation_matrix)
    ids1, _ = e1.query(X[3], topk=5)
    ids2, _ = e2.query(X[3], topk=5)
    np.testing.assert_array_equal(ids1, ids2)


def test_save_load_unbuilt(tmp_path):
    X = _data()
    e1 = Rii(fine_quantizer=PQ(M=4, Ks=20).fit(X))
    save_index(e1, str(tmp_path / "empty"))
    e2 = load_index(str(tmp_path / "empty"))
    assert e2.N == 0 and e2.nlist == 0 and e2.threshold is None
    e2.add_configure(X, nlist=10)
    assert e2.N == 1000


def test_v2_layout_adoption_identical_cache(tmp_path):
    """The adopted (v2) layout must reproduce the rebuilt layout EXACTLY:
    same device-cache arrays, same query results (checkpoint v2, round-5)."""
    X = _data(4000, 40)
    e1 = Rii(fine_quantizer=PQ(M=4, Ks=20).fit(X))
    e1.add_configure(vecs=X, nlist=30)
    q = X[:8]
    ids1, d1 = e1.query_batch(q, topk=5, method="ivf", L=400)
    save_index(e1, str(tmp_path / "idx"))

    e2 = load_index(str(tmp_path / "idx"))
    assert e2._layout_v is not None and e2._norms_cache is not None
    ids2, d2 = e2.query_batch(q, topk=5, method="ivf", L=400)
    # adoption is one-shot: consumed by the first cache build
    assert e2._layout_v is None and e2._norms_cache is None
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    dc1, dc2 = e1._ensure_cache(), e2._ensure_cache()
    for key in ("order_g", "norms_g", "codes_g", "codes_flat", "norms_flat"):
        if key in dc1:
            np.testing.assert_array_equal(np.asarray(dc1[key]),
                                          np.asarray(dc2[key]))
    for key in ("cap_v", "nlist_v", "nlist_v_pad", "cap"):
        assert dc1[key] == dc2[key], key


def test_v2_adoption_invalidated_by_mutation(tmp_path):
    """Post-load mutations must not see stale adopted state."""
    X = _data(3000, 40)
    e1 = Rii(fine_quantizer=PQ(M=4, Ks=20).fit(X))
    e1.add_configure(vecs=X, nlist=25)
    save_index(e1, str(tmp_path / "idx"))

    # reconfigure at the SAME (n, nlist) changes assignments: explicit drop
    e2 = load_index(str(tmp_path / "idx"))
    e2.reconfigure(nlist=25, iter=5)  # different iter => different centers
    assert e2._layout_v is None
    ids, d = e2.query_batch(X[:4], topk=5, method="ivf", L=300)
    assert np.isfinite(d).all()

    # add before first query changes n: the n-guard skips adoption
    e3 = load_index(str(tmp_path / "idx"))
    e3.add_codes(e3.fine_quantizer.encode(X[:100]))
    ids3, d3 = e3.query_batch(X[:4], topk=5, method="ivf", L=300)
    assert np.isfinite(d3).all() and e3.N == 3100

    # clear drops everything
    e4 = load_index(str(tmp_path / "idx"))
    e4.clear()
    assert e4._layout_v is None and e4._norms_cache is None


def test_v1_manifest_still_loads(tmp_path):
    """Directories written by the v1 format (no layout arrays) must load."""
    import json
    import os

    X = _data(1500, 40)
    e1 = Rii(fine_quantizer=PQ(M=4, Ks=20).fit(X))
    e1.add_configure(vecs=X, nlist=15)
    path = str(tmp_path / "idx")
    save_index(e1, path, layout=False)  # v2 writer, no layout arrays
    # downgrade the manifest to the literal v1 format
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    m["format"] = "rii_tpu.index.v1"
    m.pop("layout", None)
    m.pop("cap_reserve", None)
    with open(mpath, "w") as f:
        json.dump(m, f)
    e2 = load_index(path)
    assert e2._layout_v is None  # nothing to adopt; full rebuild path
    ids1, _ = e1.query(X[0], topk=5)
    ids2, _ = e2.query(X[0], topk=5)
    np.testing.assert_array_equal(ids1, ids2)
