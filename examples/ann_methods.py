"""ANN searchers with the shared train/add/search interface — the rii-tpu
re-expression of the reference's comparison harness
(/root/reference/examples/benchmark/ann_methods.py:18-127; design originally
inspired by ann-benchmarks). Each adapter exposes:

    train(vecs)            codebook / structure training
    add(vecs)              database ingestion
    search(q, topk) -> ids single query
    search_batch(Xq, topk) -> (Nq, topk) ids   [batched extension: the
                            engine's throughput comes from batched dispatch]

Competitor libraries (faiss / annoy / falconn / nmslib) are optional pip
installs and unavailable in offline environments; their adapters raise a
clear error at construction when the import failed, and `available_methods`
lists what can actually run here. `ExactSearcher` (NumPy brute force) is
always available as the ground-truth baseline.
"""

import numpy as np

import rii_tpu

try:  # pip install faiss-cpu
    import faiss  # type: ignore
except ImportError:
    faiss = None
try:  # pip install annoy
    import annoy  # type: ignore
except ImportError:
    annoy = None
try:  # pip install nmslib
    import nmslib  # type: ignore
except ImportError:
    nmslib = None


class RiiSearcher:
    """rii-tpu with the reference rii's SIFT1M benchmark hyper-parameters
    (L=5000, nlist=1000, M=64 — examples/benchmark/ann_methods.py:19-22)."""

    def __init__(self, L=5000, K=1000, M=64):
        self.L = L
        self.K = K
        self.M = M
        self.index = None

    def train(self, vecs):
        codec = rii_tpu.PQ(M=self.M, verbose=False).fit(vecs=vecs)
        self.index = rii_tpu.Rii(fine_quantizer=codec)

    def add(self, vecs):
        self.index.add_configure(vecs=vecs, nlist=self.K)

    def search(self, q, topk):
        ids, _ = self.index.query(q=q, L=self.L, topk=topk)
        return ids

    def search_batch(self, Xq, topk):
        ids, _ = self.index.query_batch(Xq, L=self.L, topk=topk)
        return ids


class ExactSearcher:
    """Brute-force float32 L2 — exact baseline, always available."""

    def __init__(self, block=4096):
        self.block = block
        self.X = None

    def train(self, vecs):
        pass

    def add(self, vecs):
        self.X = np.ascontiguousarray(vecs, dtype=np.float32)

    def search(self, q, topk):
        return self.search_batch(q[None, :], topk)[0]

    def search_batch(self, Xq, topk):
        Xq = np.ascontiguousarray(Xq, dtype=np.float32)
        xsq = (self.X ** 2).sum(1)
        out = np.empty((len(Xq), topk), dtype=np.int64)
        for lo in range(0, len(Xq), self.block):
            q = Xq[lo:lo + self.block]
            d = xsq[None, :] - 2.0 * (q @ self.X.T)
            part = np.argpartition(d, topk - 1, axis=1)[:, :topk]
            row = np.arange(len(q))[:, None]
            out[lo:lo + self.block] = np.take_along_axis(
                part, np.argsort(d[row, part], axis=1), axis=1)
        return out


class FaissIvfPqSearcher:
    """faiss IVFPQ at the reference's comparable configuration."""

    def __init__(self, M=64, K=1000, nprobe=32):
        if faiss is None:
            raise RuntimeError("faiss is not installed in this environment")
        self.M, self.K, self.nprobe = M, K, nprobe
        self.index = None

    def train(self, vecs):
        d = vecs.shape[1]
        quantizer = faiss.IndexFlatL2(d)
        self.index = faiss.IndexIVFPQ(quantizer, d, self.K, self.M, 8)
        self.index.train(vecs)

    def add(self, vecs):
        self.index.add(vecs)
        self.index.nprobe = self.nprobe

    def search(self, q, topk):
        return self.search_batch(q[None, :], topk)[0]

    def search_batch(self, Xq, topk):
        _, ids = self.index.search(np.ascontiguousarray(Xq, np.float32), topk)
        return ids


class AnnoySearcher:
    def __init__(self, n_trees=2000, k_search=400):
        if annoy is None:
            raise RuntimeError("annoy is not installed in this environment")
        self.n_trees, self.k_search = n_trees, k_search
        self.index = None

    def train(self, vecs):
        pass

    def add(self, vecs):
        self.index = annoy.AnnoyIndex(f=vecs.shape[1], metric="euclidean")
        for n, v in enumerate(vecs):
            self.index.add_item(n, v.tolist())
        self.index.build(self.n_trees)

    def search(self, q, topk):
        return self.index.get_nns_by_vector(q.tolist(), n=topk,
                                            search_k=self.k_search)

    def search_batch(self, Xq, topk):
        return np.stack([np.asarray(self.search(q, topk)) for q in Xq])


class NmslibSearcher:
    def __init__(self, ef_construction=500, ef_search=300):
        if nmslib is None:
            raise RuntimeError("nmslib is not installed in this environment")
        self.ef_construction, self.ef_search = ef_construction, ef_search
        self.index = None

    def train(self, vecs):
        pass

    def add(self, vecs):
        self.index = nmslib.init(method="hnsw", space="l2")
        self.index.addDataPointBatch(vecs)
        self.index.createIndex({"efConstruction": self.ef_construction,
                                "post": 2})
        self.index.setQueryTimeParams({"efSearch": self.ef_search})

    def search(self, q, topk):
        ids, _ = self.index.knnQuery(q, k=topk)
        return ids

    def search_batch(self, Xq, topk):
        res = self.index.knnQueryBatch(Xq, k=topk)
        return np.stack([np.asarray(ids[:topk]) for ids, _ in res])


SEARCHERS = {
    "rii": RiiSearcher,
    "exact": ExactSearcher,
    "faiss": FaissIvfPqSearcher,
    "annoy": AnnoySearcher,
    "nmslib": NmslibSearcher,
}


def available_methods():
    """Names whose adapters can construct in this environment."""
    out = ["rii", "exact"]
    if faiss is not None:
        out.append("faiss")
    if annoy is not None:
        out.append("annoy")
    if nmslib is not None:
        out.append("nmslib")
    return out
