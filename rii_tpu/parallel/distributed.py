"""ShardedRii: a Rii engine whose database is row-sharded over a device mesh.

The reference scales within one process via OpenMP threads (SURVEY.md 2.5); the
device equivalent is data-parallel shards over the cards of a host (NVLink)
and across hosts. For multi-host deployments call
:func:`init_distributed` first (jax.distributed), build the same Rii state on
every host, then wrap it — :func:`rii_tpu.parallel.mesh.put_sharded` transfers
only each host's addressable shard (`jax.make_array_from_process_local_data`).

Capability parity with the single-chip engine:

- ``target_ids`` subset search on BOTH query paths (the reference's headline
  feature, /root/reference/rii/rii.py:239-246): the sorted global id set is
  replicated and each shard filters by searchsorted membership against its
  local rows/windows — no per-shard mask materialization on the host.
- memory-lean pq-mode IVF (uint8 code windows decoded in flight,
  ops/ivf.ivf_union_scan_topk_pq) when the bf16 window replica is not kept —
  the big-N configuration (/root/reference/examples/benchmark/run_sift1b.py:61-72)
  where sharding matters most.
- ``add`` / ``reconfigure`` mutate the wrapped engine and rebuild the device
  state; ``reconfigure`` runs the distributed build
  (parallel/build.reconfigure_on_mesh — clustering fit + posting assignment
  SPMD on this mesh, bit-identical to the single-device build for mesh sizes
  dividing the canonical group count).

Semantics: identical results to the single-device engine (same exact-ADC math,
per-shard top-k + all-gather exact merge), verified in tests/test_sharded.py
and tests/test_distributed.py.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from rii_tpu.ops.decode import build_decoded_cache
from rii_tpu.ops.ivf import (
    _searchsorted_member,
    ivf_union_scan_topk,
    ivf_union_scan_topk_pq,
)
from rii_tpu.ops.replica_scan import replica_scan_topk
from rii_tpu.ops.scan import _BIG_Q, linear_scan_topk, linear_scan_topk_decoded
from rii_tpu.parallel.mesh import make_mesh, put_sharded, DATA_AXIS


def _pow2(n):
    v = 1
    while v < n:
        v *= 2
    return v


def _pow2_ge(n, lo):
    v = lo
    while v < n:
        v *= 2
    return v


def init_distributed(**kwargs):
    """Bring up the multi-host runtime (no-op if already initialized)."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized
    return jax.process_index(), jax.process_count()


class ShardedRii:
    """Sharded view of a built Rii engine (linear + IVF + subset search).

    Args:
        engine: a built rii_tpu.Rii (N > 0). Mutations through :meth:`add` /
            :meth:`reconfigure` rebuild the device state; mutating the engine
            directly requires calling :meth:`refresh`.
        mesh: 1-D ("data",) or 2-D ("hosts","chips") mesh (make_mesh_hc);
            defaults to all local devices.
        use_decoded: window/replica tier. True = bf16 decoded replicas;
            False = memory-lean uint8 code windows; None = follow the
            engine's scan-mode policy.
        overlap_chunks: linear-scan chunk count for collective/scan overlap.
    """

    def __init__(self, engine, mesh=None, use_decoded=None, overlap_chunks=4,
                 growth_headroom=0.125):
        if use_decoded not in (None, True, False):
            raise ValueError(
                f"use_decoded must be None, True or False (got {use_decoded!r})")
        self.engine = engine
        self.mesh = mesh or make_mesh()
        # 1-D ("data",) or 2-D ("hosts", "chips") meshes (make_mesh_hc):
        # rows shard over ALL axes; the 2-D merge stages the chip axis
        # (within a host) before the host axis
        self.axes = tuple(self.mesh.axis_names)
        self.ndev = int(np.prod([self.mesh.shape[a] for a in self.axes]))
        self._dim0 = self.axes if len(self.axes) > 1 else self.axes[0]
        # linear-scan chunking: per-chunk stage-1 collectives issue as soon
        # as each chunk's scan finishes, letting XLA overlap the gather of
        # chunk c with the scan of chunk c+1 (BASELINE north star)
        self.overlap_chunks = max(1, int(overlap_chunks))
        self._use_decoded_opt = use_decoded
        # spare capacity fraction reserved at refresh() so add()/merge()
        # place new rows with O(batch) scatters instead of an O(N) rebuild
        # (the single-chip cache reserves the same 12.5%; the reference's
        # AddCodes is O(new), /root/reference/src/rii.h:158-193). 0 disables
        # the delta path (every add falls back to a full refresh).
        self.growth_headroom = max(0.0, float(growth_headroom))
        self.refresh()

    # ------------------------------------------------------------------ #
    # device-state (re)build
    # ------------------------------------------------------------------ #

    def refresh(self):
        """Rebuild the sharded device state from the engine's host state.

        Runs under the engine's exclusive lock: the rebuild replaces cap /
        codes / ivf / scan-cache non-atomically, and a concurrent query
        observing a new cap against old-shape shards would compute wrong
        global-id offsets (or slice past an array end)."""
        with self.engine._state_lock.write():
            return self._refresh_locked()

    def _refresh_locked(self):
        engine = self.engine
        self.topk_recall = getattr(engine, "topk_recall", None)
        self.exact_rescore = getattr(engine, "exact_rescore", "auto")
        self._scan_cache = {}
        # snapshot the engine's mutation counter: the delta-add path only
        # trusts its O(batch) scatters when the engine's version advanced by
        # EXACTLY the one bump its own _add_codes produced — any interleaved
        # external mutation (reconfigure() changes assignments at unchanged
        # N, which the n0 guard alone cannot see) forces a full refresh
        self._engine_version = engine._version

        codes = engine._consolidated_codes()
        from rii_tpu.models.ivf import code_norms_np
        cw = np.asarray(engine.codewords, dtype=np.float32)
        norms = code_norms_np(cw, codes)

        n = len(codes)
        block = 1024  # shard capacity granule
        # growth headroom: spare tail rows (+inf norms, so scans ignore them)
        # that O(batch) delta-adds fill before forcing a rebuild; an
        # engine.reserve() call extends it to the reservation
        gh = self.growth_headroom
        if getattr(engine, "_cap_reserve", 0) > n > 0:
            gh = max(gh, engine._cap_reserve / n - 1.0)
        want = max(n, 1) + int(np.ceil(max(n, 1) * gh))
        cap = -(-want // (self.ndev * block)) * (self.ndev * block)
        codes_pad = np.zeros((cap, codes.shape[1]), np.uint8)
        codes_pad[:n] = codes
        norms_pad = np.full(cap, np.inf, np.float32)
        norms_pad[:n] = norms

        mesh = self.mesh
        self.cap = cap
        self._n_dev = n
        self.block = min(block, cap // self.ndev)
        self.codes = put_sharded(mesh, codes_pad, P(self._dim0, None))
        self.norms = put_sharded(mesh, norms_pad, P(self._dim0))
        self.codewords = put_sharded(mesh, cw, P())

        use_decoded = self._use_decoded_opt
        if use_decoded is None:
            use_decoded = engine._use_decoded_cache(cap)
        win_mode = "bf16" if use_decoded else "pq"
        self.decoded = None
        sh = jax.sharding.NamedSharding(mesh, P(self._dim0, None))
        if use_decoded:
            # decode under jit: sharding propagates row-wise, each device
            # decodes only its shard
            self.decoded = jax.jit(
                build_decoded_cache, static_argnames=("block",),
                out_shardings=sh)(self.codes, self.codewords, block=self.block)

        # sharded IVF over the balanced virtual-bucket layout: each shard owns
        # a contiguous range of virtual windows + their (replicated-center
        # derived) coarse rows; probing is per-shard local (see
        # query_ivf_batch). Mode: bf16 window replica when affordable, else
        # memory-lean uint8 code windows (decoded in flight).
        self.ivf = None
        if engine.nlist > 0:
            from rii_tpu.models.ivf import build_virtual_layout
            # same 12.5% per-bucket headroom as the single-chip cache so the
            # delta-add path can place rows at each bucket's contiguous tail
            # (gh already extended to any engine.reserve() reservation)
            ul = build_virtual_layout(codes, norms, engine._assignments(),
                                      engine.nlist, pad_to=8 * self.ndev,
                                      headroom=gh)
            # decode coarse centers on host — do NOT touch engine._ensure_cache
            # here: that would materialize the FULL single-device cache on one
            # chip, defeating sharding at the big-N scales ShardedRii targets
            nlist = engine.nlist
            nlist_pad = _pow2_ge(nlist, 8)
            dec = cw[np.arange(engine.M)[None, :],
                     engine._centers.astype(np.int64)]
            centers_dec = np.zeros((nlist_pad, cw.shape[0] * cw.shape[2]),
                                   np.float32)
            centers_dec[:nlist] = dec.reshape(nlist, -1)
            cn = np.full(nlist_pad, np.inf, np.float32)
            cn[:nlist] = (centers_dec[:nlist] ** 2).sum(axis=1)
            vreal = ul["vreal"]
            cdv = centers_dec[np.clip(vreal, 0, centers_dec.shape[0] - 1)]
            cnv = np.where(vreal >= 0,
                           cn[np.clip(vreal, 0, cn.shape[0] - 1)],
                           np.inf).astype(np.float32)
            codes_g = put_sharded(mesh, ul["codes_grouped"], P(self._dim0, None))
            order_g = put_sharded(mesh, ul["order"], P(self._dim0))
            vstart = ul["vstart"]
            self.ivf = {
                "mode": win_mode,
                "cap_v": ul["cap_v"],
                "nlist_v": ul["nlist_v"],
                "nlist_v_pad": ul["nlist_v_pad"],
                "order_g": order_g,
                "norms_g": put_sharded(mesh, ul["norms_grouped"], P(self._dim0)),
                "centers_dec_v": put_sharded(mesh, cdv, P(self._dim0, None)),
                "centers_norms_v": put_sharded(mesh, cnv, P(self._dim0)),
                # host mirrors for the O(batch) delta-add placement (same
                # contiguous-prefix invariant as the single-chip cache)
                "v_vstart": vstart[:nlist].astype(np.int64),
                "v_counts": ul["counts"].copy(),
                "v_capacity": ((vstart[1:] - vstart[:-1])
                               * ul["cap_v"]).astype(np.int64),
            }
            # uint8 code windows: the pq tier's store, and the bf16 tier's
            # exact-rescore source (addressed by grouped slot, N*M bytes)
            self.ivf["codes_g"] = codes_g
            if win_mode == "bf16":
                self.ivf["decoded_g"] = jax.jit(
                    build_decoded_cache, static_argnames=("block",),
                    out_shardings=sh)(codes_g, self.codewords,
                                      block=ul["cap_v"])
        return self

    def _rescore(self, qn):
        """Rii._resolve_rescore's policy: exact-f32 epilogue on the bf16
        tiers, auto-on below the big-Q crossover (distances then match the
        single-device engine's exactly)."""
        mode = getattr(self, "exact_rescore", "auto")
        return qn < _BIG_Q if mode == "auto" else bool(mode)

    def _use_kernel(self):
        """The fused replica kernel per shard: the engine's own decision."""
        return (self.decoded is not None
                and self.engine._use_replica_kernel(self.decoded.shape[1]))

    # ------------------------------------------------------------------ #
    # mutation (parity with Rii.add / Rii.reconfigure on the mesh)
    # ------------------------------------------------------------------ #

    def add(self, vecs, update_posting_lists="auto"):
        """Encode + append through the wrapped engine, then place ONLY the
        new rows into the sharded device state (O(batch) scatters into the
        spare capacity reserved at refresh() — the reference's O(new)
        AddCodes contract, /root/reference/src/rii.h:158-193). Falls back to
        a full refresh when capacity is exhausted."""
        e = self.engine
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2 and vecs.dtype == np.float32
        codes = e.fine_quantizer.encode(vecs)
        return self._append_codes(
            codes, e._resolve_update_posting_lists_flag(update_posting_lists))

    def merge(self, engine, update_posting_lists="auto"):
        """Append another engine's codes (Rii.merge semantics); same O(batch)
        delta placement as :meth:`add`."""
        from rii_tpu.rii import Rii
        e = self.engine
        assert isinstance(engine, Rii)
        assert e.fine_quantizer == engine.fine_quantizer, \
            "Two engines to be merged must have the same fine quantizer"
        if engine.N == 0:
            return self
        return self._append_codes(
            engine._consolidated_codes().copy(),
            e._resolve_update_posting_lists_flag(update_posting_lists))

    def _append_codes(self, codes, update_flag):
        # _add_codes returns (n0, assign, version) captured atomically with
        # the append — under concurrent adds, reading _code_chunks[-1] here
        # could hand us a DIFFERENT thread's batch
        n0, assign, ver = self.engine._add_codes(codes, update_flag)
        codes = np.ascontiguousarray(codes, np.uint8)
        # exclusive vs in-flight queries: the scatters donate live buffers
        with self.engine._state_lock.write():
            if ver != self._engine_version + 1:
                # some OTHER mutation (external reconfigure/clear/add)
                # interleaved since our last sync: v_vstart/v_counts may
                # describe stale assignments even at unchanged N — rebuild
                self._refresh_locked()
                return self
            try:
                ok = self._apply_add_sharded(codes, assign, n0)
                if ok:
                    self._engine_version = ver
            except Exception:
                # a scatter failing MID-SEQUENCE (e.g. device OOM) leaves
                # the sharded state half-updated; rebuild while still
                # holding the lock so no query can observe it (the host
                # append succeeded — the rebuilt state includes the batch)
                self._refresh_locked()
                return self
        return self if ok else self.refresh()

    def _apply_add_sharded(self, codes, assign, n0):
        """Scatter k new rows into the sharded device arrays. Returns False
        when spare capacity (rows or per-bucket window slots) is exhausted —
        the caller then pays the full refresh. Mirrors the single-chip
        Rii._apply_add_to_cache placement exactly: linear rows land at global
        positions [n0, n0+k); grouped rows land at their bucket's contiguous
        tail, keeping ids ascending within each bucket (reference push_back
        order, /root/reference/src/rii.h:356-358). The scatters run under jit
        on the mesh — replicated updates, sharded operands — so each device
        writes only the rows it owns and shapes/shardings are unchanged
        (zero recompiles of the cached scan functions)."""
        k = codes.shape[0]
        if k == 0:
            return True
        if n0 != self._n_dev:
            # stale sharded view (the engine grew outside this wrapper):
            # scattering at n0 would leave a +inf hole over the unseen rows;
            # fall back to the self-healing full refresh
            return False
        if n0 + k > self.cap:
            return False
        iv = self.ivf
        update_ivf = bool((assign >= 0).any())
        place = None
        if update_ivf:
            if iv is None or "v_counts" not in iv:
                return False
            # placement + capacity check BEFORE mutating anything (shared
            # with Rii._apply_add_to_cache: models/ivf.append_placement)
            from rii_tpu.models.ivf import append_placement
            place = append_placement(assign, iv["v_counts"], iv["v_vstart"],
                                     iv["cap_v"], iv["v_capacity"])
            if place is None:
                return False

        from rii_tpu.models.ivf import code_norms_np
        from rii_tpu.rii import _decode_rows, _set_rows
        mesh = self.mesh
        cw = np.asarray(self.engine.codewords, dtype=np.float32)
        norms_new = code_norms_np(cw, codes)
        idx = put_sharded(mesh, np.arange(n0, n0 + k, dtype=np.int32), P())
        codes_j = put_sharded(mesh, codes, P())
        norms_j = put_sharded(mesh, norms_new, P())
        self.codes = _set_rows(self.codes, idx, codes_j)
        self.norms = _set_rows(self.norms, idx, norms_j)
        dec_new = None
        if self.decoded is not None or (update_ivf and "decoded_g" in iv):
            dec_new = _decode_rows(codes_j, self.codewords)  # (k, D) bf16
        if self.decoded is not None:
            self.decoded = _set_rows(self.decoded, idx, dec_new)

        if update_ivf:
            perm = place["perm"]
            slots_j = put_sharded(mesh, place["slots"].astype(np.int32), P())
            permj = put_sharded(mesh, perm.astype(np.int32), P())
            ids_new = put_sharded(mesh, (n0 + perm).astype(np.int32), P())
            iv["order_g"] = _set_rows(iv["order_g"], slots_j, ids_new)
            iv["norms_g"] = _set_rows(
                iv["norms_g"], slots_j,
                put_sharded(mesh, norms_new[perm], P()))
            if "decoded_g" in iv:
                iv["decoded_g"] = _set_rows(iv["decoded_g"], slots_j,
                                            jnp.take(dec_new, permj, axis=0))
            if "codes_g" in iv:
                iv["codes_g"] = _set_rows(iv["codes_g"], slots_j,
                                          jnp.take(codes_j, permj, axis=0))
            iv["v_counts"] = place["new_counts"]

        self._n_dev = n0 + k
        return True

    def reconfigure(self, nlist=None, iter=5):
        """Distributed reconfigure: PQk-means fit + posting assignment run
        SPMD on this mesh (parallel/build.py), then shards are re-placed.
        The shard rebuild runs inside the SAME write-lock acquisition as the
        engine-state swap, so a concurrent query can never read new engine
        metadata (nlist/N/threshold) against old sharded arrays."""
        from rii_tpu.parallel.build import reconfigure_on_mesh
        reconfigure_on_mesh(self.engine, self.mesh, nlist=nlist, iter=iter,
                            on_swap=self._refresh_locked)
        return self

    # ------------------------------------------------------------------ #
    # query
    # ------------------------------------------------------------------ #

    def _rotated(self, queries):
        from rii_tpu.rii import require_dtype
        queries = np.ascontiguousarray(
            np.atleast_2d(require_dtype(queries, np.float32, "queries")))
        from rii_tpu.models.opq import OPQ
        if isinstance(self.engine.fine_quantizer, OPQ):
            queries = self.engine.fine_quantizer.rotate(queries)
        return queries

    def _prep_targets(self, target_ids, sort_target_ids=True):
        """(tids_padded jnp (S_pad,) int32 sorted w/ int32-max tail, n, S)."""
        if target_ids is None:
            return None, None, None
        from rii_tpu.rii import require_dtype
        tids = require_dtype(target_ids, np.int64, "target_ids")
        assert tids.ndim == 1
        tids = np.sort(tids) if sort_target_ids else tids
        s = len(tids)
        s_pad = _pow2(max(16, s))
        tp = np.full(s_pad, np.iinfo(np.int32).max, dtype=np.int32)
        tp[:s] = tids
        return jnp.asarray(tp), jnp.int32(s), s

    def _axis_index(self):
        """Linearized shard index over the mesh's (possibly 2-D) row axes."""
        if len(self.axes) == 1:
            return lax.axis_index(self.axes[0])
        nchips = self.mesh.shape[self.axes[1]]
        return lax.axis_index(self.axes[0]) * nchips + lax.axis_index(
            self.axes[1])

    def _scan_fn(self, topk, s_pad, rescore=False):
        use_kernel = self._use_kernel()
        key = (topk, self.decoded is not None, use_kernel, s_pad, rescore)
        if key in self._scan_cache:
            return self._scan_cache[key]
        shard_cap = self.cap // self.ndev
        blk = min(self.block, shard_cap)
        rt = self.topk_recall
        use_dec = self.decoded is not None
        has_tids = s_pad is not None
        axes = self.axes
        two_level = len(axes) == 2

        # chunking for collective/scan overlap: per-chunk caps keep the
        # block granule (a multiple of the kernel's 128-row tile)
        gran = min(blk, 1024)
        # largest chunk count <= the requested one whose chunks keep the
        # granule (never MORE chunks/collectives than asked for)
        nchunks = 1
        for c in range(max(1, int(self.overlap_chunks)), 0, -1):
            if shard_cap % (c * gran) == 0:
                nchunks = c
                break
        ck = shard_cap // nchunks

        def _merge_rows(d_flat, g_flat, k):
            neg, pos = lax.top_k(-d_flat, k)
            ids = jnp.take_along_axis(g_flat, pos, axis=1)
            ids = jnp.where(jnp.isfinite(-neg), ids, -1)
            return -neg, ids

        def _local(queries, codes_l, norms_l, codewords, dec_l, tids, nt):
            my = self._axis_index()
            qn = queries.shape[0]
            ax1 = axes[-1]  # stage-1 gather axis: chips when 2-D
            parts_d, parts_g = [], []
            for c in range(nchunks):
                lo = c * ck
                norms_c = lax.slice_in_dim(norms_l, lo, lo + ck)
                if has_tids:
                    # subset filter: membership of this chunk's GLOBAL row
                    # ids in the replicated sorted target set (the
                    # searchsorted re-design of src/rii.h:218-228)
                    gid_c = (my * shard_cap + lo
                             + jnp.arange(ck, dtype=jnp.int32))
                    member = _searchsorted_member(tids, nt, gid_c)
                    norms_c = jnp.where(member, norms_c, jnp.inf)
                # per-shard exact-f32 rescore (Rii.exact_rescore, resolved by
                # the caller): chunk-local ids index the chunk's code rows, so
                # the shared epilogue runs unchanged inside shard_map; each
                # shard's candidates then carry exact ADC distances into the
                # cross-shard merge (comparable across shards by construction)
                rs_codes = (lax.slice_in_dim(codes_l, lo, lo + ck)
                            if rescore else None)
                rs_cw = codewords if rescore else None
                if use_kernel:
                    d_c, i_c = replica_scan_topk(
                        queries, lax.slice_in_dim(dec_l, lo, lo + ck),
                        norms_c, topk=topk, codes=rs_codes, codewords=rs_cw,
                        recall_target=rt, interpret=self.engine._interp())
                elif use_dec:
                    d_c, i_c = linear_scan_topk_decoded(
                        queries, lax.slice_in_dim(dec_l, lo, lo + ck),
                        norms_c, topk=topk, codes=rs_codes, codewords=rs_cw,
                        block=min(blk, ck), recall_target=rt)
                else:
                    d_c, i_c = linear_scan_topk(
                        queries, lax.slice_in_dim(codes_l, lo, lo + ck),
                        norms_c, codewords, topk=topk, block=min(blk, ck),
                        recall_target=rt)
                g_c = jnp.where(i_c >= 0, i_c + my * shard_cap + lo, -1)
                # stage-1 collective issued per chunk: independent of chunk
                # c+1's scan, so XLA's scheduler overlaps them
                d_all = lax.all_gather(d_c, ax1)  # (n1, Q, k)
                g_all = lax.all_gather(g_c, ax1)
                parts_d.append(jnp.swapaxes(d_all, 0, 1).reshape(qn, -1))
                parts_g.append(jnp.swapaxes(g_all, 0, 1).reshape(qn, -1))
            d1, i1 = _merge_rows(jnp.concatenate(parts_d, axis=1),
                                 jnp.concatenate(parts_g, axis=1), topk)
            if two_level:
                # stage 2: the cross-host hop carries only the chip-stage
                # winners — nhosts*topk rows per query
                d_all = lax.all_gather(d1, axes[0])  # (nhosts, Q, k)
                g_all = lax.all_gather(i1, axes[0])
                d1, i1 = _merge_rows(
                    jnp.swapaxes(d_all, 0, 1).reshape(qn, -1),
                    jnp.swapaxes(g_all, 0, 1).reshape(qn, -1), topk)
            return d1, i1

        fn = jax.jit(shard_map(
            _local,
            mesh=self.mesh,
            in_specs=(P(), P(self._dim0, None), P(self._dim0), P(),
                      P(self._dim0, None), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        ))
        self._scan_cache[key] = fn
        return fn

    def _ivf_fn(self, topk, wv, s_pad, rescore=False):
        key = ("ivf", topk, wv, s_pad, rescore)
        if key in self._scan_cache:
            return self._scan_cache[key]
        iv = self.ivf
        nv_l = iv["nlist_v_pad"] // self.ndev
        cap_v = iv["cap_v"]
        rt = self.topk_recall
        mode = iv["mode"]
        has_tids = s_pad is not None

        def _local(queries, store_l, codes_l, norms_l, order_l, cdec_l,
                   cnorm_l, codewords, tids, nt):
            # DETERMINISTIC global probe selection: every shard scores its
            # local virtual centers, the scores are all-gathered, and each
            # query's GLOBAL top-wv window ids are computed identically on
            # every shard — each shard then scans owned-and-selected windows
            # (uniques-first compaction to the static budget below). The
            # candidate set therefore covers the single-chip engine's probe
            # set even under adversarial probe concentration on one shard
            # (reference probe-order semantics: src/rii.h:279-310).
            my = self._axis_index()
            qn = queries.shape[0]
            q16 = queries.astype(jnp.bfloat16)
            from rii_tpu.ops.ivf import _coarse_scores
            # f32 coarse scores in exact mode: bf16 rounding can reorder
            # probe ranks on near-tie centers (see ops/ivf._coarse_scores)
            cs_l = _coarse_scores(queries.astype(jnp.float32), q16, cdec_l,
                                  cnorm_l, exact=rt is None)  # (Q, nv_l)
            cs_all = lax.all_gather(cs_l, self.axes)  # (ndev, Q, nv_l)
            gscore = jnp.swapaxes(cs_all, 0, 1).reshape(qn, self.ndev * nv_l)
            w_eff = min(wv, self.ndev * nv_l)
            _, probe = lax.top_k(-gscore, w_eff)  # (Q, w_eff) GLOBAL ids
            pf = probe.reshape(-1)
            mine = (pf // nv_l) == my
            loc = jnp.where(mine, pf - my * nv_l, 0)
            sent = jnp.where(mine, 0, 1)
            # sort by (window, sentinel-last) so a real probe of window 0
            # precedes the sentinel copies; adjacent equal windows dedup
            keys = jnp.sort(loc * 2 + sent)
            flat_all = keys >> 1
            s_all = keys & 1
            dup_all = ((s_all == 1)
                       | jnp.concatenate([jnp.zeros((1,), bool),
                                          flat_all[1:] == flat_all[:-1]]))
            u_budget = min(pf.shape[0], nv_l)
            if u_budget < pf.shape[0]:
                # uniques-first stable compaction: every unique owned window
                # (<= nv_l of them) survives the truncation. Re-sort the kept
                # entries by (window, dup-last) so the union stays sorted
                # with duplicates adjacent to their unique copy
                keep = jnp.argsort(dup_all.astype(jnp.int32),
                                   stable=True)[:u_budget]
                k2 = jnp.sort(flat_all[keep] * 2
                              + dup_all[keep].astype(flat_all.dtype))
                flat_l = k2 >> 1
                dup_l = (k2 & 1) == 1
            else:
                flat_l, dup_l = flat_all, dup_all
            tm = None
            if has_tids:
                tm = _searchsorted_member(tids, nt, order_l)
            if mode == "bf16":
                # exact-f32 rescore from the shard's grouped code windows
                # (Rii.exact_rescore, resolved by the caller)
                d_l, i_l = ivf_union_scan_topk(
                    queries, store_l, norms_l, order_l, cdec_l, cnorm_l,
                    w=min(wv, nv_l), topk=topk, cap_u=cap_v,
                    nlist_pad=nv_l, target_mask=tm, recall_target=rt,
                    probes=(flat_l, dup_l),
                    codes=codes_l if rescore else None,
                    codewords=codewords if rescore else None,
                    codes_grouped=True)
            else:
                d_l, i_l = ivf_union_scan_topk_pq(
                    queries, store_l, norms_l, order_l, codewords,
                    cdec_l, cnorm_l, w=min(wv, nv_l), topk=topk,
                    cap_u=cap_v, nlist_pad=nv_l, target_mask=tm,
                    recall_target=rt, probes=(flat_l, dup_l))
            qn = queries.shape[0]
            # staged merge: chip-axis winners first, then the host hop
            d_all = lax.all_gather(d_l, self.axes[-1])  # (n1, Q, k)
            g_all = lax.all_gather(i_l, self.axes[-1])
            d_flat = jnp.swapaxes(d_all, 0, 1).reshape(qn, -1)
            g_flat = jnp.swapaxes(g_all, 0, 1).reshape(qn, -1)
            neg, pos = lax.top_k(-d_flat, topk)
            ids = jnp.take_along_axis(g_flat, pos, axis=1)
            ids = jnp.where(jnp.isfinite(-neg), ids, -1)
            if len(self.axes) == 2:
                d_all = lax.all_gather(-neg, self.axes[0])  # (nhosts, Q, k)
                g_all = lax.all_gather(ids, self.axes[0])
                d_flat = jnp.swapaxes(d_all, 0, 1).reshape(qn, -1)
                g_flat = jnp.swapaxes(g_all, 0, 1).reshape(qn, -1)
                neg, pos = lax.top_k(-d_flat, topk)
                ids = jnp.take_along_axis(g_flat, pos, axis=1)
                ids = jnp.where(jnp.isfinite(-neg), ids, -1)
            return -neg, ids

        fn = jax.jit(shard_map(
            _local,
            mesh=self.mesh,
            in_specs=(P(), P(self._dim0, None), P(self._dim0, None),
                      P(self._dim0), P(self._dim0), P(self._dim0, None),
                      P(self._dim0), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        ))
        self._scan_cache[key] = fn
        return fn

    def _use_linear(self, queries, topk, L, target_ids):
        """Sharded auto policy: the engine's threshold(L) + the union-volume
        guard, computed from the SHARDED layout stats (never touches the
        engine's single-device cache)."""
        e = self.engine
        if self.ivf is None or e.threshold is None:
            return True  # linear is the only available path
        s = e.N if target_ids is None else len(target_ids)
        L_eff = L if L is not None else e._multiple_of_L0_covering_topk(topk)
        if s <= e.threshold(L_eff):
            return True
        iv = self.ivf
        qn = np.atleast_2d(queries).shape[0]
        slack = 3 * max(1, -(-iv["nlist_v"] // max(1, e.nlist)))
        wv = int(np.round(float(L_eff) * iv["nlist_v"] / max(1, s))) + slack
        rows = min(qn * wv, iv["nlist_v"]) * iv["cap_v"]
        return 2 * rows >= self.cap

    def query_ivf_batch(self, queries, topk=1, L=None, target_ids=None,
                        sort_target_ids=True):
        """Sharded IVF probe with DETERMINISTIC global coverage: the global
        top-wv windows per query are selected from all-gathered replicated
        center scores, and each shard scans exactly the selected windows it
        owns — so the candidate set equals the single-chip engine's probe
        superset even when every hot window lives on one shard. Distances
        are exact, the merge is exact. target_ids is a global sorted id
        subset (the reference's subset search, /root/reference/src/rii.h:291-295),
        applied per shard by membership.
        """
        assert self.ivf is not None, "IVF requires a reconfigured engine"
        # shared lock: concurrent with other queries, exclusive vs the
        # donated delta-add scatters (see Rii._RWLock; re-entrant under
        # query_batch's read side)
        with self.engine._state_lock.read():
            return self._query_ivf_batch_impl(queries, topk, L, target_ids,
                                              sort_target_ids)

    def _query_ivf_batch_impl(self, queries, topk, L, target_ids,
                              sort_target_ids):
        e = self.engine
        iv = self.ivf
        if L is None:
            L = e._multiple_of_L0_covering_topk(topk=topk)
        s = None if target_ids is None else len(target_ids)
        denom = e.N if s is None else s
        slack = 3 * max(1, -(-iv["nlist_v"] // max(1, e.nlist)))
        wv = int(np.round(float(L) * iv["nlist_v"] / max(1, denom))) + slack
        wv = min(iv["nlist_v_pad"], _pow2(max(1, wv)))
        qn = np.atleast_2d(np.asarray(queries)).shape[0]
        # same internal fallback as the single-chip engine: when the batch's
        # global probe union covers (most of) the database, the contiguous
        # linear scan is strictly faster and a candidate superset
        union_slots = min(_pow2(qn) * wv, iv["nlist_v"]) * iv["cap_v"]
        if wv >= iv["nlist_v"] or 2 * union_slots >= self.cap:
            return self.query_batch(queries, topk=topk,
                                    target_ids=target_ids,
                                    sort_target_ids=sort_target_ids,
                                    method="linear")
        queries = self._rotated(queries)
        tids, nt, s = self._prep_targets(target_ids, sort_target_ids)
        qpad = _pow2(qn)
        if qpad != qn:
            queries = np.concatenate(
                [queries, np.broadcast_to(queries[:1], (qpad - qn,
                                                        queries.shape[1]))])
        zero = jnp.zeros((), jnp.int32)
        store = iv["decoded_g"] if iv["mode"] == "bf16" else iv["codes_g"]
        s_pad = None if tids is None else int(tids.shape[0])
        d, i = self._ivf_fn(topk, wv, s_pad, self._rescore(qpad))(
            jnp.asarray(queries), store, iv["codes_g"], iv["norms_g"],
            iv["order_g"],
            iv["centers_dec_v"], iv["centers_norms_v"], self.codewords,
            tids if tids is not None else zero,
            nt if nt is not None else zero)
        return (np.asarray(i)[:qn].astype(np.int64),
                np.asarray(d)[:qn].astype(np.float64))

    def query_batch(self, queries, topk=1, target_ids=None,
                    sort_target_ids=True, L=None, method="linear"):
        """Exact ADC scan over all shards, optionally restricted to a global
        target_ids subset; returns (ids int64, dists float64).

        The L/method kwargs make the signature serving-compatible
        (rii_tpu.serving.QueryServer accepts a ShardedRii as its engine):
        method='ivf' dispatches to :meth:`query_ivf_batch`; 'auto' follows
        the wrapped engine's threshold policy. Default 'linear' keeps the
        exact-scan contract.
        """
        assert method in ("auto", "linear", "ivf")
        if method == "auto":
            method = "linear" if self._use_linear(
                queries, topk, L, target_ids) else "ivf"
        if method == "ivf":
            return self.query_ivf_batch(queries, topk=topk, L=L,
                                        target_ids=target_ids,
                                        sort_target_ids=sort_target_ids)
        with self.engine._state_lock.read():
            return self._query_linear_impl(queries, topk, target_ids,
                                           sort_target_ids)

    def _query_linear_impl(self, queries, topk, target_ids, sort_target_ids):
        queries = self._rotated(queries)
        tids, nt, s = self._prep_targets(target_ids, sort_target_ids)
        dec = self.decoded
        if dec is None:
            # pass a tiny placeholder with the right sharding
            dec = self.norms[:, None]
        zero = jnp.zeros((), jnp.int32)
        s_pad = None if tids is None else int(tids.shape[0])
        d, i = self._scan_fn(topk, s_pad,
                             rescore=self._rescore(queries.shape[0]))(
            jnp.asarray(queries), self.codes, self.norms, self.codewords, dec,
            tids if tids is not None else zero,
            nt if nt is not None else zero)
        return (np.asarray(i).astype(np.int64),
                np.asarray(d).astype(np.float64))
