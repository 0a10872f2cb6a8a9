"""The user-facing Rii engine: full API parity with the reference's ``rii.Rii``
(/root/reference/rii/rii.py) plus batched query APIs.

Responsibility split mirrors the reference (SURVEY.md section 1): this layer owns
*policy* — codec management, OPQ query rotation, default nlist/L, auto
linear-vs-ivf selection, argument validation, posting-list bookkeeping — while
*mechanism* lives in jitted ops (rii_tpu.ops) operating on a device cache of
padded arrays.

Canonical state is host-side numpy (uint8 codes, int32 assignments, uint8 coarse
centers); device arrays are a derived cache, rebuilt lazily when the index
mutates. Capacities grow in powers of two so the jit cache stays bounded.
"""

import copy
import threading
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from rii_tpu.models.pq import PQ
from rii_tpu.models.opq import OPQ
from rii_tpu.models.pqkmeans import (
    pqkmeans_fit,
    pqkmeans_predict,
    pqkmeans_predict_device,
    predict_upload,
)
from rii_tpu.models.ivf import (
    append_placement,
    build_grouped_layout,
    build_virtual_layout,
    code_norms_np,
    posting_lists_from_assignments,
)
from rii_tpu.ops.decode import build_decoded_cache
from rii_tpu.ops.replica_scan import kernel_supports, replica_scan_topk
from rii_tpu.ops.scan import (
    _BIG_Q,
    linear_scan_topk,
    linear_scan_topk_decoded,
    subset_scan_topk,
    subset_scan_topk_decoded,
)
from rii_tpu.ops.ivf import (
    ivf_scan_topk,
    ivf_scan_topk_decoded,
    ivf_union_scan_topk,
    ivf_union_scan_topk_pq,
)

_RECONFIGURE_SAMPLE_SEED = 123  # mirrors std::default_random_engine(123), src/rii.h:122
_PQKMEANS_SEED = 0  # mirrors mt19937(0), src/pqkmeans.cpp:186


def require_dtype(arr, dtype, name):
    """Strict input contract (the reference binding's ``.noconvert()``,
    /root/reference/src/main.cpp:18-26): wrong-dtype arrays are REJECTED,
    never silently cast — a silent f64->f32 cast changes results for a user
    porting reference code. Accepts any array-like already carrying the
    exact dtype; returns it as ndarray."""
    arr = np.asarray(arr)
    if arr.dtype != dtype:
        raise TypeError(
            f"{name} must be {np.dtype(dtype).name} (got {arr.dtype.name}); "
            f"cast explicitly with .astype(np.{np.dtype(dtype).name})")
    return arr


def _pow2_at_least(n, lo=1):
    v = max(1, lo)
    while v < n:
        v *= 2
    return v


def _pad_queries(queries):
    """Pad the query batch to a power-of-two bucket (repeat row 0)."""
    qn = queries.shape[0]
    bucket = _pow2_at_least(qn)
    if bucket == qn:
        return queries, qn
    pad = np.broadcast_to(queries[:1], (bucket - qn, queries.shape[1]))
    return np.concatenate([queries, pad], axis=0), qn


# jitted in-place cache updaters for the incremental-add path: donation lets
# XLA scatter into the existing device buffer, so an append costs O(batch),
# not O(N) (the reference's AddCodes contract, /root/reference/src/rii.h:158-193)
@partial(jax.jit, donate_argnums=(0,))
def _set_rows(arr, idx, rows):
    return arr.at[idx].set(rows)


class _RWLock:
    """Many concurrent readers (queries) or one exclusive writer (mutation).

    The incremental add path scatters into the live device cache with DONATED
    buffers (see _apply_add_to_cache), so a query dispatched concurrently with
    an add could hit a deleted array or observe a half-updated cache. Queries
    take the shared side (QueryServer's dispatcher pool stays concurrent);
    add/merge/clear/reconfigure take the exclusive side. Writer-preference:
    a waiting writer blocks NEW readers so a saturated query stream cannot
    starve mutations; a thread already holding the read side re-enters
    freely (tracked thread-locally), so nested reads cannot deadlock.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writing = False
        self._writers_waiting = 0
        self._tl = threading.local()  # per-thread read-hold count

    class _ReadSide:
        def __init__(self, lock):
            self._lock = lock

        def __enter__(self):
            lk = self._lock
            held = getattr(lk._tl, "reads", 0)
            if held:  # re-entrant read: already counted, never waits
                lk._tl.reads = held + 1
                return
            with lk._cond:
                while lk._writing or lk._writers_waiting:
                    lk._cond.wait()
                lk._readers += 1
                lk._tl.reads = 1

        def __exit__(self, *exc):
            lk = self._lock
            held = lk._tl.reads = getattr(lk._tl, "reads", 1) - 1
            if held:  # inner of a re-entrant read: nothing to release
                return
            with lk._cond:
                lk._readers -= 1
                lk._cond.notify_all()

    class _WriteSide:
        """Registers intent before blocking so new readers yield."""

        def __init__(self, lock):
            self._lock = lock

        def __enter__(self):
            lk = self._lock
            with lk._cond:
                lk._writers_waiting += 1
                try:
                    while lk._writing or lk._readers:
                        lk._cond.wait()
                    lk._writing = True
                finally:
                    lk._writers_waiting -= 1

        def __exit__(self, *exc):
            lk = self._lock
            with lk._cond:
                lk._writing = False
                lk._cond.notify_all()

    def read(self):
        return self._ReadSide(self)

    def write(self):
        return self._WriteSide(self)


@jax.jit
def _decode_rows(codes, codewords):
    """bf16 decoded rows, bit-identical to build_decoded_cache's blocks."""
    from rii_tpu.ops.decode import onehot_decode
    return onehot_decode(codes, codewords, dtype=jnp.float32).astype(
        jnp.bfloat16)


def platform():
    """Platform of the default device ("gpu", "cpu", ...): the one input
    to kernel and tier choice."""
    return jax.devices()[0].platform


_NO_LIMIT_BUDGET = 2 << 30


def default_cache_budget(device=None):
    """Replica budget in bytes: half of what the device's allocator may
    hold (``memory_stats()["bytes_limit"]``), or 2 GiB where the device
    reports no limit (the CPU)."""
    device = device or jax.devices()[0]
    try:
        stats = device.memory_stats() or {}
    except Exception:  # backends without allocator statistics
        stats = {}
    limit = stats.get("bytes_limit")
    return int(limit) // 2 if limit else _NO_LIMIT_BUDGET


class Rii:
    """Reconfigurable inverted index over PQ codes.

    Args:
        fine_quantizer: a trained :class:`rii_tpu.PQ` or :class:`rii_tpu.OPQ`.

    Attributes:
        fine_quantizer: deep copy of the codec (as in /root/reference/rii/rii.py:36).
        threshold: np.poly1d mapping L -> |S| threshold for linear-vs-ivf choice.
    """

    def __init__(self, fine_quantizer):
        assert isinstance(fine_quantizer, (PQ, OPQ))
        assert fine_quantizer.codewords is not None, "Please fit the PQ/OPQ instance first"
        assert fine_quantizer.Ks <= 256, "Ks must be <= 256 so that each code is uint8"
        self.fine_quantizer = copy.deepcopy(fine_quantizer)
        self.threshold = None
        # Linear-scan storage mode: "pq" scans uint8 codes (N*M bytes, decoded
        # per block), "bf16" additionally keeps a decoded bf16 replica (one
        # GEMM per block; +N*D*2 bytes), "auto" picks bf16 on the GPU when the
        # replica fits the budget. "int8" is accepted (older checkpoints) and
        # resolves as "bf16". Distances are exact ADC either way (cross term
        # bf16 in the replica mode).
        self.scan_mode = "auto"
        # replica budget in bytes; None = default_cache_budget() of the device
        self.decoded_cache_budget = None
        # Per-block top-k recall target (lax.approx_max_k; an exact top-k
        # where the platform has no hardware partial-reduce, GPU and CPU
        # included). The final cross-block merge is exact; None = bit-exact
        # selection everywhere and no fused kernel.
        self.topk_recall = 0.99
        # IVF probe-selection recall: "inherit" ties it to topk_recall
        # (approx probes in the fast mode). A missed probe drops a WHOLE
        # bucket — unrecoverable by the exact rescore, a different failure
        # class from bf16 selection noise — so None forces exact lax.top_k
        # probes while keeping the fast approx merge (probe A/B measured in
        # RECALL_PARITY.md).
        self.probe_recall = "inherit"
        # Exact-f32 rescore of the final overfetched candidates on the bf16
        # tier. "auto" = on below the big-Q crossover (ops/scan._BIG_Q, not
        # yet measured on the GPU: ROADMAP S2f); big batches keep the
        # documented bf16 accuracy class. True/False force it.
        self.exact_rescore = "auto"
        self._verbose = bool(fine_quantizer.verbose)
        self._code_chunks = []  # list of (n_i, M) uint8
        self._assign_chunks = []  # list of (n_i,) int32; -1 = not in any posting list
        self._n = 0
        self._centers = None  # (nlist, M) uint8
        self._version = 0
        self._codes_cache = None  # consolidated (N, M) uint8
        self._dc = None  # device cache dict
        # one-shot precomputed-state adoption (checkpoint v2, load_index):
        # consumed by the next _build_cache, so post-load mutations can never
        # see stale derived state (they bump the version, the cache rebuilds,
        # and these are already None by then)
        self._norms_cache = None  # (N,) f32 ||decode||^2
        self._layout_v = None  # saved virtual layout (utils/serialization.py)
        self._cap_reserve = 0  # see reserve()
        # serializes cold-cache builds: QueryServer's dispatcher pool calls
        # query_batch concurrently, and two racing _ensure_cache builds would
        # transiently double device memory and duplicate compiles
        self._cache_lock = threading.Lock()
        # queries shared / mutations exclusive (see _RWLock docstring)
        self._state_lock = _RWLock()

    # ------------------------------------------------------------------ #
    # properties (parity with /root/reference/rii/rii.py:40-121)
    # ------------------------------------------------------------------ #

    @property
    def M(self):
        """int: number of PQ sub-spaces."""
        return self.fine_quantizer.M

    @property
    def Ks(self):
        """int: codewords per sub-space."""
        return self.fine_quantizer.Ks

    @property
    def N(self):
        """int: number of stored PQ codes."""
        return self._n

    @property
    def nlist(self):
        """int: number of posting lists (0 before the first reconfigure)."""
        return 0 if self._centers is None else int(self._centers.shape[0])

    @property
    def codewords(self):
        """np.ndarray: (M, Ks, Ds) float32 codewords."""
        return self.fine_quantizer.codewords

    @property
    def coarse_centers(self):
        """np.ndarray: (nlist, M) uint8 coarse centers (PQ codes), or None."""
        if self.nlist == 0:
            return None
        return np.array(self._centers, dtype=self.fine_quantizer.code_dtype)

    @property
    def codes(self):
        """np.ndarray: (N, M) uint8 stored PQ codes, or None if empty."""
        if self._n == 0:
            return None
        return np.array(self._consolidated_codes(), copy=True)

    @property
    def posting_lists(self):
        """list[list[int]]: ids per coarse center, ascending within each list."""
        if self.nlist == 0:
            return []
        return posting_lists_from_assignments(self._assignments(), self.nlist)

    @property
    def verbose(self):
        """bool: verbose flag (rewritable)."""
        return self._verbose

    @verbose.setter
    def verbose(self, v):
        self._verbose = bool(v)
        self.fine_quantizer.verbose = bool(v)

    @property
    def L0(self):
        """int: average posting-list length round(N / nlist), or None."""
        if self.nlist == 0:
            return None
        return int(np.round(self._n / self.nlist))

    # ------------------------------------------------------------------ #
    # mutation
    # ------------------------------------------------------------------ #

    def reconfigure(self, nlist=None, iter=5, calibrate=False):
        """Re-cluster stored codes into nlist coarse centers and rebuild postings.

        Mirrors /root/reference/rii/rii.py:123-150 + src/rii.h:108-156:
        samples min(N, nlist*100) codes (fixed seed), runs PQk-means, then
        assigns all N codes. ``threshold`` is refreshed: analytically by default
        (cost model), or by the reference-style timed sweep when calibrate=True.
        """
        if nlist is None:
            nlist = int(np.sqrt(self._n))
        assert 0 < nlist, "nlist must be positive"
        assert nlist <= self._n, "nlist must be <= N"
        iter = max(1, int(iter))

        stats = {}
        with self._state_lock.write():  # exclusive vs in-flight queries
            t0 = time.perf_counter()
            codes = self._consolidated_codes()
            stats["consolidate_s"] = time.perf_counter() - t0
            n_train = min(self._n, nlist * 100)
            t0 = time.perf_counter()
            pick = np.random.RandomState(
                _RECONFIGURE_SAMPLE_SEED).permutation(self._n)[:n_train]
            sample = codes[pick]
            stats["sample_s"] = time.perf_counter() - t0
            if self._verbose:
                print(f"Training coarse centers on {n_train} codes "
                      f"(nlist={nlist})")
            # dispatch the all-N codes upload for the post-fit predict NOW:
            # jax transfers are async, so the 256 MB-class H2D (N=32M, M=8)
            # overlaps the fit's device time instead of serializing after it
            t0 = time.perf_counter()
            codes_blocks, n_up = predict_upload(codes)
            stats["predict_upload_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            centers, _ = pqkmeans_fit(
                self.codewords, sample, k=nlist, iters=iter,
                seed=_PQKMEANS_SEED, verbose=self._verbose,
            )
            stats["fit_s"] = time.perf_counter() - t0
            self._centers = centers
            t0 = time.perf_counter()
            assign = pqkmeans_predict_device(self.codewords, centers,
                                             codes_blocks, n_up)
            stats["predict_s"] = time.perf_counter() - t0
            del codes_blocks
            self._assign_chunks = [assign.astype(np.int32)]
            # new assignments invalidate any loaded layout adoption state
            # even at identical (n, nlist) — see load_index / _build_cache
            self._layout_v = None
            self._bump()
        # per-stage breakdown of the last reconfigure (metrics parity with
        # the reference's verbose prints)
        self.last_reconfigure_stats = stats
        if self._verbose:
            print("reconfigure stages:",
                  {k: round(v, 2) for k, v in stats.items()})

        # calibration issues queries itself, so it runs OUTSIDE the write lock
        if calibrate:
            probes = self.fine_quantizer.decode(codes[: min(100, self._n)])
            self.threshold = estimate_best_threshold_function(self, probes)
        else:
            self.threshold = self._analytic_threshold()
        return self

    def add(self, vecs, update_posting_lists="auto"):
        """Encode and append new vectors (see /root/reference/rii/rii.py:152-186)."""
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2
        assert vecs.dtype == np.float32
        codes = self.fine_quantizer.encode(vecs)
        self._add_codes(codes, self._resolve_update_posting_lists_flag(update_posting_lists))

    def add_codes(self, codes, update_posting_lists="auto"):
        """Append PRE-ENCODED uint8 PQ codes (N, M). The migration /
        streaming-ingestion path: codes produced by any quantizer sharing
        this engine's codewords decode identically, so an existing database
        from a reference/nanopq deployment (see PQ.from_codewords) is
        ingested without re-encoding. Returns self."""
        codes = np.ascontiguousarray(
            require_dtype(codes, np.uint8, "codes"))
        if codes.size and self.Ks < 256:
            # out-of-range codes would only raise on host numpy paths; device
            # gathers (jnp.take) CLIP silently and return plausible-but-wrong
            # distances — reject at the boundary instead
            assert int(codes.max()) < self.Ks, (
                f"code values must be < Ks={self.Ks} "
                f"(got max {int(codes.max())})")
        self._add_codes(
            codes,
            self._resolve_update_posting_lists_flag(update_posting_lists))
        return self

    def add_configure(self, vecs, nlist=None, iter=5):
        """add(update_posting_lists=False) then reconfigure. Returns self."""
        self.add(vecs=vecs, update_posting_lists=False)
        self.reconfigure(nlist=nlist, iter=iter)
        return self

    def merge(self, engine, update_posting_lists="auto"):
        """Append another engine's codes; ids continue after self.N.

        Keeps self's existing posting lists (parity: /root/reference/rii/rii.py:208-233).
        """
        assert isinstance(engine, Rii)
        assert self.fine_quantizer == engine.fine_quantizer, \
            "Two engines to be merged must have the same fine quantizer"
        if engine.N != 0:
            self._add_codes(engine._consolidated_codes().copy(),
                            self._resolve_update_posting_lists_flag(update_posting_lists))
        if self._verbose:
            print(f"The number of codes: {self._n}")

    def reserve(self, n_expected):
        """Pre-size device caches for growth to ``n_expected`` rows
        (vector-reserve semantics). The linear cap becomes
        pow2_at_least(n_expected) and the window layout reserves enough
        per-bucket slots that subsequent :meth:`add` batches scatter in
        O(batch) with no rebuild until N exceeds the reservation. Costs the
        reserved capacity in replica memory up front. Takes effect at the
        next cache (re)build; returns self."""
        self._cap_reserve = max(0, int(n_expected))
        return self

    def clear(self):
        """Drop codes, centers, postings, threshold. Codewords are kept."""
        with self._state_lock.write():
            self.threshold = None
            self._code_chunks = []
            self._assign_chunks = []
            self._n = 0
            self._centers = None
            self._codes_cache = None
            self._norms_cache = None
            self._layout_v = None
            self._bump()

    def _add_codes(self, codes, update_flag):
        """Append a code batch. Returns (n0, assign, version) captured
        atomically with the append (ShardedRii's delta placement needs the
        triple to refer to THIS batch, not whatever chunk lands last under
        concurrency; the post-append version lets it detect any OTHER
        mutation — e.g. an external reconfigure() — interleaved since its
        last sync and fall back to a full refresh)."""
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        assert codes.ndim == 2 and codes.shape[1] == self.M
        if update_flag and self._centers is None:
            raise RuntimeError(
                "reconfigure() must be called before add(vecs=X, update_posting_lists=True). "
                "If this is the first addition, please call add_configure(vecs=X)")

        # the assignment depends only on (codewords, centers): compute it
        # OUTSIDE the exclusive section so concurrent queries are not stalled
        # behind the O(k*nlist) predict; re-validate against a racing
        # reconfigure/clear (which replace _centers) inside the lock
        def _predict():
            if not update_flag:
                return np.full(codes.shape[0], -1, dtype=np.int32)
            return np.asarray(
                pqkmeans_predict(self.codewords, self._centers, codes),
                dtype=np.int32)

        c0 = self._centers
        assign = _predict()
        with self._state_lock.write():  # exclusive vs in-flight queries
            if self._centers is not c0:  # reconfigure/clear raced the predict
                if update_flag and self._centers is None:  # clear() won
                    raise RuntimeError(
                        "reconfigure() must be called before add(vecs=X, "
                        "update_posting_lists=True). If this is the first "
                        "addition, please call add_configure(vecs=X)")
                assign = _predict()
            self._code_chunks.append(codes)
            self._codes_cache = None
            self._assign_chunks.append(assign)
            n0 = self._n
            self._n += codes.shape[0]
            self._version += 1
            # incremental path: place only the new rows into the device
            # cache's spare capacity (O(batch) — the reference's AddCodes is
            # O(new), src/rii.h:158-193); falls back to a lazy full rebuild
            # on overflow. A scatter failing MID-SEQUENCE (e.g. device OOM)
            # leaves the cache half-updated — drop it so no query can
            # observe the inconsistent state (the host append succeeded).
            try:
                ok = self._apply_add_to_cache(codes, assign, n0)
            except Exception:
                ok = False
            if not ok:
                self._dc = None
            version = self._version
        if self._verbose:
            print(f"{codes.shape[0]} new vectors are added. Total: {self._n}")
        return n0, assign, version

    def _apply_add_to_cache(self, codes, assign, n0):
        """Scatter k new rows into the live device cache. Returns False when
        no cache exists or capacity is exhausted (caller drops the cache)."""
        dc = self._dc
        k = codes.shape[0]
        if dc is None:
            return False
        if k == 0:  # empty add: cache contents are already correct
            dc["version"] = self._version
            return True
        if dc.get("n_dev") is None or n0 + k > dc["cap"]:
            return False
        update_ivf = bool((assign >= 0).any())
        if update_ivf and "v_counts" not in dc:
            return False
        place = None
        if update_ivf:
            # placement + capacity check BEFORE mutating anything (shared
            # with the sharded delta-add: models/ivf.append_placement)
            place = append_placement(assign, dc["v_counts"], dc["v_vstart"],
                                     dc["cap_v"], dc["v_capacity"])
            if place is None:
                return False

        cw = np.asarray(self.codewords, dtype=np.float32)
        norms_new = code_norms_np(cw, codes)
        idx = jnp.asarray(np.arange(n0, n0 + k, dtype=np.int32))
        codes_j = jnp.asarray(codes)
        norms_j = jnp.asarray(norms_new)
        dc["codes_flat"] = _set_rows(dc["codes_flat"], idx, codes_j)
        dc["norms_flat"] = _set_rows(dc["norms_flat"], idx, norms_j)
        dec_new = None
        if "decoded_flat" in dc or "decoded_g" in dc:
            dec_new = _decode_rows(codes_j, dc["codewords"])  # (k, D) bf16
        if "decoded_flat" in dc:
            dc["decoded_flat"] = _set_rows(dc["decoded_flat"], idx, dec_new)

        if update_ivf:
            perm = place["perm"]
            slots_j = jnp.asarray(place["slots"].astype(np.int32))
            ids_new = jnp.asarray((n0 + perm).astype(np.int32))
            dc["order_g"] = _set_rows(dc["order_g"], slots_j, ids_new)
            dc["norms_g"] = _set_rows(dc["norms_g"], slots_j,
                                      jnp.asarray(norms_new[perm]))
            if "decoded_g" in dc:
                dc["decoded_g"] = _set_rows(dc["decoded_g"], slots_j,
                                            dec_new[jnp.asarray(perm)])
            if "codes_g" in dc:
                dc["codes_g"] = _set_rows(dc["codes_g"], slots_j,
                                          codes_j[jnp.asarray(perm)])
            dc["v_counts"] = place["new_counts"]
            # the legacy tight-packed grouped layout has no spare capacity;
            # drop it (dead for querying — the union layout always exists).
            # cap_max included: it is _ensure_legacy_grouped's built sentinel
            for key in ("order", "slot_cluster", "codes_grouped",
                        "norms_grouped", "bucket_start", "cap_max"):
                dc.pop(key, None)

        dc["n_dev"] = n0 + k
        dc["version"] = self._version
        return True

    # ------------------------------------------------------------------ #
    # query
    # ------------------------------------------------------------------ #

    def query(self, q, topk=1, L=None, target_ids=None, sort_target_ids=True,
              method="auto"):
        """Single-query ANN search; contract parity with /root/reference/rii/rii.py:235-320.

        Returns (ids (topk,) int64, dists (topk,) float64), dists ascending.
        """
        q = np.asarray(q)
        assert q.ndim == 1
        ids, dists = self.query_batch(
            q[None, :], topk=topk, L=L, target_ids=target_ids,
            sort_target_ids=sort_target_ids, method=method)
        return ids[0], dists[0]

    def query_batch(self, queries, topk=1, L=None, target_ids=None,
                    sort_target_ids=True, method="auto"):
        """Batched ANN search — the device-batched entry point.

        Same policy as :meth:`query` applied to (Q, D) queries sharing one
        target-id set. Returns (ids (Q, topk) int64, dists (Q, topk) float64).
        """
        # shared lock: concurrent with other queries, exclusive vs mutations
        # (add's donated in-place cache scatters would otherwise race reads)
        with self._state_lock.read():
            return self._query_batch_impl(queries, topk, L, target_ids,
                                          sort_target_ids, method)

    def _query_batch_impl(self, queries, topk, L, target_ids,
                          sort_target_ids, method):
        assert 0 < self._n, "No codes to be searched"
        assert 0 < self.nlist, "Posting lists are not available; call reconfigure first"
        assert method in ("auto", "linear", "ivf")
        queries = require_dtype(queries, np.float32, "queries")
        queries = np.ascontiguousarray(np.atleast_2d(queries))

        if topk is None:
            topk = self._n
        assert 1 <= topk <= self._n

        if L is None:
            L = self._multiple_of_L0_covering_topk(topk=topk)
        assert topk <= L <= self._n, \
            f"Make sure topk<=L<=N: topk={topk}, L={L}, N={self._n}"

        if target_ids is None:
            tids = None
            len_target_ids = self._n
        else:
            assert isinstance(target_ids, np.ndarray)
            target_ids = require_dtype(target_ids, np.int64, "target_ids")
            assert target_ids.ndim == 1
            tids = np.sort(target_ids) if sort_target_ids else target_ids
            len_target_ids = len(tids)
        assert topk <= len_target_ids <= self._n, \
            f"Make sure topk<=len(target_ids)<=N: topk={topk}, " \
            f"len(target_ids)={len_target_ids}, N={self._n}"

        if isinstance(self.fine_quantizer, OPQ):
            q_ = self.fine_quantizer.rotate(queries)
        else:
            q_ = queries

        if method == "auto":
            qn = queries.shape[0]
            # the union-IVF cost amortizes over the batch; the cache must
            # exist for the virtual-layout cost model to see its stats
            self._ensure_cache()
            method = "linear" if self._use_linear(len_target_ids, L, qn=qn) \
                else "ivf"
        if method == "linear":
            ids, dists = self._query_linear_batch(q_, topk, tids)
        else:
            ids, dists = self._query_ivf_batch(q_, topk, tids, L)
        return ids.astype(np.int64), dists.astype(np.float64)

    # low-level entry points (the analog of impl_cpp.query_linear / query_ivf;
    # they take queries already rotated into codec space).

    def query_linear(self, q, topk, target_ids=None):
        """Exact ADC linear scan. q: (D,) rotated query. Returns (ids, dists)."""
        q = require_dtype(q, np.float32, "q")
        with self._state_lock.read():
            ids, dists = self._query_linear_batch(
                np.ascontiguousarray(np.atleast_2d(q)), topk,
                None if target_ids is None or len(target_ids) == 0
                else require_dtype(target_ids, np.int64, "target_ids"))
        return ids[0].astype(np.int64), dists[0].astype(np.float64)

    def query_ivf(self, q, topk, target_ids, L):
        """IVF probing scan. q: (D,) rotated query. Returns (ids, dists)."""
        q = require_dtype(q, np.float32, "q")
        with self._state_lock.read():
            ids, dists = self._query_ivf_batch(
                np.ascontiguousarray(np.atleast_2d(q)), topk,
                None if target_ids is None or len(target_ids) == 0
                else require_dtype(target_ids, np.int64, "target_ids"), L)
        return ids[0].astype(np.int64), dists[0].astype(np.float64)

    def _resolve_rescore(self, qn):
        """Exact-rescore policy for the bf16 tiers (see __init__)."""
        mode = getattr(self, "exact_rescore", "auto")
        if mode == "auto":
            return qn < _BIG_Q
        return bool(mode)

    def _query_linear_batch(self, queries, topk, tids):
        dc = self._ensure_cache()
        qp, qn = _pad_queries(queries)
        qd = jnp.asarray(qp)
        decoded = dc.get("decoded_flat")
        rt = getattr(self, "topk_recall", None)
        # exact-f32 rescore epilogue on the bf16 tier: pass the codes so the
        # scan overfetches and re-ranks exactly (None = selection-only)
        rs = self._resolve_rescore(qd.shape[0])
        rs_codes = dc["codes_flat"] if rs else None
        rs_cw = dc["codewords"] if rs else None
        if tids is not None and len(tids) <= 4096:
            s = len(tids)
            s_pad = _pow2_at_least(s, 16)
            tids_pad = np.zeros(s_pad, dtype=np.int32)
            tids_pad[:s] = tids
            if decoded is not None:
                d, i = subset_scan_topk_decoded(qd, decoded, dc["norms_flat"],
                                                jnp.asarray(tids_pad),
                                                jnp.int32(s), topk=topk,
                                                codes=rs_codes,
                                                codewords=rs_cw)
            else:
                d, i = subset_scan_topk(qd, dc["codes_flat"], dc["norms_flat"],
                                        dc["codewords"], jnp.asarray(tids_pad),
                                        jnp.int32(s), topk=topk)
            return np.asarray(i)[:qn], np.asarray(d)[:qn]
        mask = None
        if tids is not None:
            # mid/large subsets: masked full scan (flat cost ~ one scan)
            # instead of row gathers of 10k-100k rows
            m = np.zeros(dc["cap"], dtype=bool)
            m[np.clip(tids, 0, dc["cap"] - 1)] = True
            mask = jnp.asarray(m)
        if decoded is not None and self._use_replica_kernel(decoded.shape[1]):
            norms = dc["norms_flat"]
            if mask is not None:  # the kernel reads the mask as +inf norms
                norms = jnp.where(mask, norms, jnp.inf)
            d, i = replica_scan_topk(qd, decoded, norms, topk=topk,
                                     codes=rs_codes, codewords=rs_cw,
                                     recall_target=rt,
                                     interpret=self._interp())
        elif decoded is not None:
            d, i = linear_scan_topk_decoded(qd, decoded, dc["norms_flat"],
                                            topk=topk, codes=rs_codes,
                                            codewords=rs_cw, mask=mask,
                                            block=dc["block_dec"],
                                            recall_target=rt)
        else:
            d, i = linear_scan_topk(qd, dc["codes_flat"], dc["norms_flat"],
                                    dc["codewords"], topk=topk, mask=mask,
                                    block=dc["block"], recall_target=rt)
        return np.asarray(i)[:qn], np.asarray(d)[:qn]

    def _probe_width(self, L, s):
        """w = round(L * nlist / N_or_S) + 3, clamped (src/rii.h:267-277), then
        rounded up to a power of two to bound the jit cache (recall only grows)."""
        nlist = self.nlist
        denom = self._n if s is None else s
        w = int(np.round(float(L) * nlist / denom)) + 3
        return min(nlist, _pow2_at_least(max(1, w)))

    def _probe_width_virtual(self, L, s, dc):
        """Virtual-bucket probe width with the reference's candidate budget
        (see _query_ivf_batch), pow2-rounded up to bound the jit cache."""
        denom = self._n if s is None else s
        slack = 3 * max(1, -(-dc["nlist_v"] // max(1, self.nlist)))
        wv = int(np.round(float(L) * dc["nlist_v"] / denom)) + slack
        return min(dc["nlist_v_pad"], _pow2_at_least(max(1, wv)))

    def _query_ivf_batch(self, queries, topk, tids, L, force_full=False):
        dc = self._ensure_cache()
        has_union = "decoded_g" in dc or "codes_g" in dc
        qp, qn = _pad_queries(queries)
        qd = jnp.asarray(qp)
        s = None if tids is None else len(tids)
        w = self.nlist if force_full else self._probe_width(L, s)
        w = min(w, dc["nlist_pad"])
        kwargs = {}
        if tids is not None:
            s_pad = _pow2_at_least(s, 16)
            tids_pad = np.full(s_pad, np.iinfo(np.int32).max, dtype=np.int32)
            tids_pad[:s] = tids  # sorted; pad with +inf-like sentinel keeps order
            kwargs = dict(target_ids=jnp.asarray(tids_pad), n_targets=jnp.int32(s))
        rt = getattr(self, "topk_recall", None)
        probe_full = w >= self.nlist
        if has_union:
            # union-bucket batched probe over the balanced virtual-bucket
            # replica: windows copied contiguously, scored for the batch in
            # one GEMM (ops/ivf.py::ivf_union_scan_topk). Probe width is in
            # VIRTUAL buckets, matching the reference's candidate budget:
            # its w = round(L*nlist/N_or_S)+3 full lists scan ~ (L*N/S + 3*L0)
            # members (src/rii.h:267-277), so the +3-list slack becomes
            # +3*avg_chunks windows here.
            wv = self._probe_width_virtual(L, s, dc)
            if force_full:
                wv = dc["nlist_v_pad"]
            probe_full = wv >= dc["nlist_v"]
            union_slots = min(qd.shape[0] * wv, dc["nlist_v"]) * dc["cap_v"]
            if probe_full or 2 * union_slots >= dc["cap"]:
                # the batch's probe union covers (most of) the database: the
                # contiguous-stream linear scan reads every row once, so it is
                # taken before full coverage (crossover not yet measured on
                # the GPU: ROADMAP S2g); semantics stay a candidate superset
                # of the probes
                return self._query_linear_batch(queries, topk, tids)
            tm = None
            if tids is not None:
                mask = np.zeros(dc["cap"], dtype=bool)
                mask[np.clip(tids, 0, dc["cap"] - 1)] = True
                tm = jnp.take(jnp.asarray(mask),
                              jnp.clip(dc["order_g"], 0, dc["cap"] - 1))
            if "decoded_g" in dc:
                rs = self._resolve_rescore(qd.shape[0])
                d, i = ivf_union_scan_topk(
                    qd, dc["decoded_g"], dc["norms_g"], dc["order_g"],
                    dc["centers_dec_v"], dc["centers_norms_v"], w=wv,
                    topk=topk, cap_u=dc["cap_v"], nlist_pad=dc["nlist_v_pad"],
                    target_mask=tm, recall_target=rt,
                    probe_recall=getattr(self, "probe_recall", "inherit"),
                    codes=dc["codes_flat"] if rs else None,
                    codewords=dc["codewords"] if rs else None)
            else:
                # memory-lean: uint8 code windows, decoded in flight
                d, i = ivf_union_scan_topk_pq(
                    qd, dc["codes_g"], dc["norms_g"], dc["order_g"],
                    dc["codewords"], dc["centers_dec_v"],
                    dc["centers_norms_v"], w=wv, topk=topk, cap_u=dc["cap_v"],
                    nlist_pad=dc["nlist_v_pad"], target_mask=tm,
                    recall_target=rt,
                    probe_recall=getattr(self, "probe_recall", "inherit"))
        elif "decoded_flat" in dc:
            # fully query-batched probe over the bf16 replica
            self._ensure_legacy_grouped(dc)
            d, i = ivf_scan_topk_decoded(
                qd, dc["decoded_flat"], dc["centers_dec"], dc["centers_norms"],
                dc["bucket_start"], dc["norms_grouped"], dc["order"],
                dc["slot_cluster"], w=w, topk=topk, cap_max=dc["cap_max"],
                recall_target=rt, **kwargs)
        else:
            self._ensure_legacy_grouped(dc)
            d, i = ivf_scan_topk(
                qd, dc["codewords"], dc["centers_dec"], dc["centers_norms"],
                dc["bucket_start"], dc["codes_grouped"], dc["norms_grouped"],
                dc["order"], dc["slot_cluster"], w=w, topk=topk,
                cap_max=dc["cap_max"], recall_target=rt, **kwargs)
        d = np.asarray(d)[:qn]
        i = np.asarray(i)[:qn]
        # If probing w clusters found fewer than topk eligible candidates, widen
        # to full coverage (the reference keeps walking lists until L candidates;
        # full coverage is the SPMD-deterministic superset of that behavior).
        if not force_full and not probe_full and not np.isfinite(d).all():
            return self._query_ivf_batch(queries, topk, tids, L, force_full=True)
        return i, d

    # ------------------------------------------------------------------ #
    # policy helpers (parity with /root/reference/rii/rii.py:374-400)
    # ------------------------------------------------------------------ #

    def _multiple_of_L0_covering_topk(self, topk):
        avglen = self.L0
        return min((topk // avglen + 1) * avglen, self._n)

    def _use_linear(self, len_target_ids, L, qn=1):
        if len_target_ids <= self.threshold(L):
            return True
        # Cost-model guard (what the reference's *measured* calibration
        # would discover). With the union-bucket scan, an IVF batch streams
        # min(Q*wv, nlist_v)*cap_v replica rows; the linear scan streams all
        # cap rows once for the whole batch, and a window read costs more
        # than a straight-line one, so prefer linear when the IVF row volume
        # is not clearly below the full scan. The rule is not yet measured on
        # the GPU (ROADMAP S2g).
        dc = self._dc
        s = None if len_target_ids >= self._n else len_target_ids
        if dc is not None and "nlist_v" in dc:
            wv = self._probe_width_virtual(L, s, dc)
            rows = min(qn * wv, dc["nlist_v"]) * dc["cap_v"]
            # aligned with _query_ivf_batch's internal linear fallback
            # (2 * union_slots >= cap): if the ivf path would switch to the
            # contiguous scan anyway, pick linear up front
            return 2 * rows >= dc["cap"]
        # legacy gather path: a gathered row is taken to cost 8 streamed ones
        w = self._probe_width(L, s)
        cap_max = self.L0 * 2 if self.L0 else 1
        if dc is not None and "cap_max" in dc:
            cap_max = dc["cap_max"]
        return w * cap_max * 8 >= self._n

    def _resolve_update_posting_lists_flag(self, flag):
        assert flag in ("auto", True, False)
        if flag == "auto":
            return 0 < self.nlist
        return flag

    def _analytic_threshold(self):
        """Cost-model threshold: ivf evaluates ~L candidates + nlist coarse
        centers; linear evaluates |S|. Crossover at |S| ~= L + nlist."""
        return np.poly1d([1.0, float(self.nlist)])

    # ------------------------------------------------------------------ #
    # internal state management
    # ------------------------------------------------------------------ #

    def _bump(self):
        self._version += 1
        self._dc = None

    def _use_decoded_cache(self, cap):
        return self._resolve_scan_mode(cap) == "bf16"

    def _cache_budget(self):
        """Replica bytes allowed on the device (see __init__)."""
        budget = getattr(self, "decoded_cache_budget", None)
        return default_cache_budget() if budget is None else int(budget)

    def _resolve_scan_mode(self, cap):
        """Resolve scan_mode ('auto'|'pq'|'bf16'|'int8') to a concrete mode.

        bf16: decoded replica (+cap*D*2 bytes), fastest, exact-ADC distances.
        pq:   uint8 codes only.
        'int8' (kept by older checkpoints) resolves as 'bf16'. 'auto' keeps
        the replica on the GPU only: XLA:CPU scans the codes as fast.
        """
        mode = getattr(self, "scan_mode", "auto")
        if mode == "pq" or (mode == "auto" and platform() != "gpu"):
            return "pq"
        d = self.M * self.fine_quantizer.Ds
        return "bf16" if cap * d * 2 <= self._cache_budget() else "pq"

    def _use_replica_kernel(self, d):
        """Fused replica kernel (ops/replica_scan.py) for a D-wide replica:
        on the GPU only, and for power-of-two D (kernel_supports).

        Slightly approximate selection (one candidate per 128-slot tile), same
        accuracy class as topk_recall=0.99 — so it is disabled when the user
        asks for bit-exact selection (topk_recall=None).

        `pallas_interpret=True` (a test hook) runs the kernel on CPU through
        Pallas interpret mode, so CI exercises the code the GPU runs.
        """
        if getattr(self, "topk_recall", None) is None or not kernel_supports(d):
            return False
        return (bool(getattr(self, "pallas_interpret", False))
                or platform() == "gpu")

    def _interp(self):
        return bool(getattr(self, "pallas_interpret", False))

    def _consolidated_codes(self):
        if self._codes_cache is None:
            if not self._code_chunks:
                self._codes_cache = np.zeros((0, self.M), dtype=np.uint8)
            elif len(self._code_chunks) == 1:
                self._codes_cache = self._code_chunks[0]
            else:
                self._codes_cache = np.concatenate(self._code_chunks, axis=0)
                self._code_chunks = [self._codes_cache]
        return self._codes_cache

    def _assignments(self):
        if not self._assign_chunks:
            return np.zeros((0,), dtype=np.int32)
        if len(self._assign_chunks) > 1:
            self._assign_chunks = [np.concatenate(self._assign_chunks)]
        return self._assign_chunks[0]

    def _ensure_cache(self):
        dc = self._dc
        if dc is not None and dc["version"] == self._version:
            return dc
        with self._cache_lock:  # one thread builds; late arrivals reuse
            dc = self._dc
            if dc is not None and dc["version"] == self._version:
                return dc
            return self._build_cache()

    def _build_cache(self):
        stats = {}
        t0 = time.perf_counter()
        codes = self._consolidated_codes()
        cw = np.asarray(self.codewords, dtype=np.float32)
        nc = self._norms_cache
        self._norms_cache = None
        if nc is not None and len(nc) == self._n:
            norms = np.asarray(nc, dtype=np.float32)  # checkpoint v2 adoption
        else:
            norms = code_norms_np(cw, codes)
        stats["norms_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cap = _pow2_at_least(max(self._n, self._cap_reserve, 1), 1024)
        block = min(8192, cap)  # pq path: bounds the one-hot decode transient
        block_dec = min(262144, cap)  # decoded replica path: GEMM-friendly
        codes_flat = np.zeros((cap, self.M), dtype=np.uint8)
        codes_flat[: self._n] = codes
        norms_flat = np.full(cap, np.inf, dtype=np.float32)
        norms_flat[: self._n] = norms
        dc = {
            "version": self._version,
            "cap": cap,
            "n_dev": self._n,
            "block": block,
            "block_dec": block_dec,
            "codewords": jnp.asarray(cw),
            "codes_flat": jnp.asarray(codes_flat),
            "norms_flat": jnp.asarray(norms_flat),
        }
        stats["flat_h2d_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resolved = self._resolve_scan_mode(cap)
        dc["mode"] = resolved
        if resolved == "bf16":
            # one row-major (cap, D) replica serves the fused kernel and XLA
            dc["decoded_flat"] = build_decoded_cache(dc["codes_flat"],
                                                     dc["codewords"])
        stats["replica_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self._centers is not None:
            nlist = self.nlist
            nlist_pad = _pow2_at_least(nlist, 8)
            # decoded coarse centers, padded with +inf norms
            dec = cw[np.arange(self.M)[None, :], self._centers.astype(np.int64)]
            centers_dec = np.zeros((nlist_pad, self.M * cw.shape[2]), dtype=np.float32)
            centers_dec[:nlist] = dec.reshape(nlist, -1)
            centers_norms = np.full(nlist_pad, np.inf, dtype=np.float32)
            centers_norms[:nlist] = (centers_dec[:nlist] ** 2).sum(axis=1)
            dc.update({
                "nlist_pad": nlist_pad,
                "centers_dec": jnp.asarray(centers_dec),
                "centers_norms": jnp.asarray(centers_norms),
            })
            # NOTE the legacy whole-bucket grouped layout (cap_max windows,
            # ivf_scan_topk fallbacks) is built LAZILY (_ensure_legacy_grouped):
            # the union tier below always serves queries when centers exist,
            # and skipping a second argsort+gather pass over all N rows cuts
            # the first-query host layout cost in half at the SIFT1B shape
            # balanced virtual-bucket layout for the union-bucket IVF scan:
            # big buckets split into cap_v-slot windows, each window a
            # contiguous copy, probe width scaled by nlist_v. bf16 mode keeps a
            # decoded window replica (gated on the replica budget); pq mode
            # keeps uint8 code windows and decodes in flight
            # (ivf_union_scan_topk_pq) — N*M bytes, no budget gate needed.
            # cap_v=256 keeps probe granularity FINER than whole lists, which
            # buys probe diversity: at equal candidate budget, 256-slot
            # windows recalled more than 1024-slot ones (recall@10 0.705 vs
            # 0.641) — recall parity with the reference wins over speed
            # 12.5% per-bucket headroom reserves spare window slots so
            # incremental adds place new rows in O(batch) (see
            # _apply_add_to_cache) instead of rebuilding the layout; a
            # reserve() call scales it to cover the reserved growth
            h = 0.125
            if self._cap_reserve > self._n > 0:
                h = max(h, self._cap_reserve / self._n - 1.0)
            lv = self._layout_v
            self._layout_v = None
            if (lv is not None and lv["n"] == self._n
                    and lv["nlist"] == nlist and lv["headroom"] == h):
                # checkpoint v2 adoption: the saved permutation replaces the
                # argsort+placement pass; grouped codes/norms are rebuilt by
                # one fancy-gather (codes[order]) — the cheap part
                order = lv["order"]
                total = order.shape[0]
                valid = order >= 0
                codes_grouped = np.zeros((total, self.M), dtype=np.uint8)
                codes_grouped[valid] = codes[order[valid]]
                norms_grouped = np.full(total, np.inf, dtype=np.float32)
                norms_grouped[valid] = norms[order[valid]]
                ul = {
                    "order": order, "codes_grouped": codes_grouped,
                    "norms_grouped": norms_grouped, "vreal": lv["vreal"],
                    "vstart": lv["vstart"],
                    "counts": lv["counts"], "cap_v": int(lv["cap_v"]),
                    "nlist_v": int(lv["nlist_v"]),
                    "nlist_v_pad": int(lv["nlist_v_pad"]), "total": int(total),
                }
            else:
                ul = build_virtual_layout(codes, norms, self._assignments(),
                                          nlist, headroom=h)
            stats["adopted_layout"] = lv is not None
            stats["layout_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            vreal_c = ul["vreal"]
            cdv_c = centers_dec[np.clip(vreal_c, 0, nlist_pad - 1)]
            cnv_c = np.where(vreal_c >= 0, centers_norms[
                np.clip(vreal_c, 0, nlist_pad - 1)], np.inf)
            vstart = ul["vstart"]
            dc.update({
                "cap_v": ul["cap_v"],
                "nlist_v": ul["nlist_v"],
                "nlist_v_pad": ul["nlist_v_pad"],
                "order_g": jnp.asarray(ul["order"]),
                "norms_g": jnp.asarray(ul["norms_grouped"]),
                "centers_dec_v": jnp.asarray(cdv_c),
                "centers_norms_v": jnp.asarray(cnv_c.astype(np.float32)),
                # host mirrors for the incremental-add placement
                "v_vstart": vstart[:nlist].astype(np.int64),
                "v_counts": ul["counts"].copy(),
                "v_capacity": ((vstart[1:] - vstart[:-1])
                               * ul["cap_v"]).astype(np.int64),
            })
            d_dim = self.M * cw.shape[2]
            # gate the COMBINED footprint: the linear replica (cap rows)
            # already holds its bytes, so the bf16 window replica is only
            # added if the sum stays inside the budget (otherwise deployments
            # sized to the knob could OOM at ~2x); else uint8 code windows
            flat_bytes = cap * (d_dim * 2 + 8 * 4) if "decoded_flat" in dc \
                else 0
            if (resolved == "bf16" and flat_bytes + ul["total"] * d_dim * 2
                    <= self._cache_budget()):
                codes_g = jnp.asarray(ul["codes_grouped"])
                dc["decoded_g"] = build_decoded_cache(
                    codes_g, dc["codewords"],
                    block=2048 if ul["total"] % 2048 == 0 else ul["cap_v"])
            else:
                dc["codes_g"] = jnp.asarray(ul["codes_grouped"])
            stats["windows_s"] = time.perf_counter() - t0
        # per-stage breakdown of the last cache build (timings include the
        # H2D each stage dispatches)
        self.last_cache_build_stats = stats
        self._dc = dc
        return dc

    def _ensure_legacy_grouped(self, dc):
        """Lazily add the whole-bucket grouped layout (the ivf_scan_topk
        fallback family's storage) to the device cache. The union-bucket
        virtual layout serves every IVF query whenever centers exist, so
        this second argsort+gather pass over all N rows is skipped on the
        normal path and built only if a fallback is actually hit or a
        caller (tests, benchmarks) asks for it explicitly."""
        if "cap_max" in dc:
            return dc
        with self._cache_lock:
            if "cap_max" in dc:  # raced builder finished first
                return dc
            codes = self._consolidated_codes()
            cw = np.asarray(self.codewords, dtype=np.float32)
            norms = code_norms_np(cw, codes)
            nlist = self.nlist
            layout = build_grouped_layout(codes, norms, self._assignments(),
                                          nlist)
            bucket_start = np.zeros(dc["nlist_pad"], dtype=np.int32)
            bucket_start[:nlist] = layout["bucket_start"]
            dc.update({
                "cap_max": layout["cap_max"],
                "order": jnp.asarray(layout["order"]),
                "slot_cluster": jnp.asarray(layout["slot_cluster"]),
                "codes_grouped": jnp.asarray(layout["codes_grouped"]),
                "norms_grouped": jnp.asarray(layout["norms_grouped"]),
                "bucket_start": jnp.asarray(bucket_start),
            })
        return dc

    # ------------------------------------------------------------------ #
    # diagnostics & serialization
    # ------------------------------------------------------------------ #

    def memory_breakdown(self):
        """Per-component device-cache footprint in bytes (+ host canonical).

        The reference documents its memory model as codes N*M + postings N*4
        + centers nlist*M bytes (/root/reference/src/rii.h:81-82); this
        engine adds the optional replicas and grouped layouts. The device
        cache is derived state — rebuilt lazily, dropped on mutation.
        """
        out = {"host_codes": self._n * self.M,
               "host_assignments": self._n * 4}
        dc = self._ensure_cache() if self._n else {}
        dev = 0
        for k, v in dc.items():
            nb = getattr(v, "nbytes", None)
            if (nb is not None and not np.isscalar(v)
                    and not isinstance(v, np.ndarray)):  # np = host mirrors
                out[f"device:{k}"] = int(nb)
                dev += int(nb)
        out["device_total"] = dev
        return out

    def print_params(self):
        """Diagnostic dump (parity with /root/reference/rii/rii.py:330-372)."""
        print("verbose:", self.verbose)
        print("M:", self.M)
        print("Ks:", self.Ks)
        print("fine_quantizer:", self.fine_quantizer)
        print("N:", self.N)
        print("nlist:", self.nlist)
        print("L0:", self.L0)
        print("codewords.shape:", self.codewords.shape)
        print("coarse_centers.shape:", None if self.nlist == 0 else self.coarse_centers.shape)
        print("codes.shape:", None if self.codes is None else self.codes.shape)
        lens = [len(pl) for pl in self.posting_lists[:11]]
        print("[len(poslist) for poslist in posting_lists]:", lens,
              "..." if self.nlist > 11 else "")
        for topk in (1, 10, 100):
            L = None if self.nlist == 0 else self._multiple_of_L0_covering_topk(topk)
            print(f"_multiple_of_L0_covering_topk(topk={topk}): {L}")
        print("threshold function thre_{|S|}=f(L):", self.threshold)
        for S in [10 ** (2 + n) for n in range(5)]:
            use_linear = None if self.threshold is None else self._use_linear(S, self.L0)
            print(f"_use_linear({S}, L={self.L0}): {use_linear}")

    def __getstate__(self):
        self._consolidated_codes()
        self._assignments()
        state = self.__dict__.copy()
        state["_dc"] = None
        state.pop("_cache_lock", None)  # locks do not pickle
        state.pop("_state_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_cap_reserve", 0)  # pre-0.3 pickles
        self._dc = None
        self._cache_lock = threading.Lock()
        self._state_lock = _RWLock()


def estimate_best_threshold_function(e, queries):
    """Timed calibration of the linear-vs-ivf threshold, reference algorithm
    (/root/reference/rii/rii.py:403-486): for a few L values, sweep |S| doubling
    from 128 to N timing both methods, binary-search the crossover, then fit a
    1-D polynomial threshold(L).

    Run on demand (``reconfigure(calibrate=True)``) because each (|S|, method)
    pair compiles a kernel variant; the analytic model is the cheap default.
    Probes are BATCHED — one device dispatch per (|S|, method) timing point
    instead of a per-query loop.
    """
    topk = 1

    def run(queries_, tids, L, method):
        qs = np.ascontiguousarray(np.atleast_2d(queries_), dtype=np.float32)
        # the private batch entries expect codec-space (OPQ-rotated) queries,
        # exactly as query()/query_batch() feed them in production
        if isinstance(e.fine_quantizer, OPQ):
            qs = np.ascontiguousarray(e.fine_quantizer.rotate(qs),
                                      dtype=np.float32)
        t0 = time.perf_counter()
        with e._state_lock.read():  # same shared lock as the public entries
            if method == "linear":
                e._query_linear_batch(qs, topk, tids)
            else:
                e._query_ivf_batch(qs, topk, tids, L)
        return (time.perf_counter() - t0) / qs.shape[0]

    def sweep(L):
        if e.N <= 128:
            return e.N
        sids = [128]
        while sids[-1] * 2 < e.N:
            sids.append(sids[-1] * 2)
        sids.append(e.N)
        for s in sids:
            tids = np.arange(s, dtype=np.int64)
            # warm up compilations so the timing reflects steady-state
            run(queries[:1], tids, L, "linear")
            run(queries[:1], tids, L, "ivf")
            t_linear = run(queries[:3], tids, L, "linear")
            t_ivf = run(queries[:3], tids, L, "ivf")
            if t_ivf < t_linear:
                if s == 128:
                    return 128
                s0, s1 = s // 2, s
                for _ in range(5):
                    s_mid = int(np.round((s0 + s1) / 2))
                    tids = np.arange(s_mid, dtype=np.int64)
                    if run(queries, tids, L, "ivf") < run(queries, tids, L, "linear"):
                        s1 = s_mid
                    else:
                        s0 = s_mid
                return s0
        return e.N

    xs, ys = [], []
    for L in [k * e._multiple_of_L0_covering_topk(k) for k in (1, 2, 4, 8, 16)]:
        if e.N < L:
            continue
        xs.append(L)
        ys.append(sweep(L))
        if ys[-1] == e.N:
            break
    z = [0, ys[0]] if len(xs) == 1 else np.polyfit(xs, ys, 1)
    p = np.poly1d(z)
    if e.verbose:
        print("L:", xs, "threshold:", ys, "poly:", p)
    return p
