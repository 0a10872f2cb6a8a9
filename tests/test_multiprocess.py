"""REAL multi-process distributed runtime test: 2 jax.distributed processes
(Gloo collectives — the cross-host transport) x 4 virtual CPU devices each,
exercising ShardedRii queries (linear / IVF / subset), per-host ingestion
(put_sharded -> make_array_from_process_local_data) and the distributed
reconfigure, whose posting lists must be bit-identical to single-device.

The reference has no multi-process capability at all (SURVEY.md section 2.5);
this is the jax.distributed bring-up path that multi-host pods use.
"""

import os
import socket
import subprocess
import sys



_WORKER = r'''
import os, sys
import numpy as np
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="localhost:" + port,
                           num_processes=nproc, process_id=pid)
sys.path.insert(0, sys.argv[4])

from rii_tpu import PQ, Rii
from rii_tpu.parallel import ShardedRii
from jax.sharding import Mesh

rng = np.random.RandomState(5)
n, d = 4096, 32
X = rng.random((n, d)).astype(np.float32)     # same data on every host
pq = PQ(M=4, Ks=32).fit(X[:1024], iter=3)
e = Rii(pq); e.add_configure(X, nlist=48, iter=3)

mesh = Mesh(np.asarray(jax.devices()), ("data",))
sr = ShardedRii(e, mesh=mesh)
q = X[:8]
ids_s, d_s = sr.query_batch(q, topk=5)
ids_e, d_e = e.query_batch(q, topk=5, method="linear")
assert (ids_s == ids_e).mean() > 0.95
iv, dv = sr.query_ivf_batch(q, topk=5, L=n)
assert all(set(a.tolist()) == set(b.tolist()) for a, b in zip(iv, ids_s))
tids = np.sort(rng.choice(n, 500, replace=False)).astype(np.int64)
it, _ = sr.query_batch(q, topk=5, target_ids=tids)
assert all(set(r.tolist()) <= set(tids.tolist()) for r in it)

# O(batch) delta-add across processes: replicated updates scatter into the
# sharded state (per-host local placement), no rebuild, new rows searchable
n_dev0 = sr._n_dev
cache0 = sr._scan_cache
X2 = rng.random((128, d)).astype(np.float32)  # same rows on every host
sr.add(X2, update_posting_lists=True)
assert sr._n_dev == n_dev0 + 128
assert sr._scan_cache is cache0, "delta add must not rebuild"
ids_n, _ = sr.query_batch(X2[:4], topk=1)
assert (ids_n[:, 0] >= n).all()

sr.reconfigure(nlist=48, iter=3)
e2 = Rii(pq); e2.add(X, update_posting_lists=False)
e2.add(X2, update_posting_lists=False)  # mirror the delta-added rows
e2.reconfigure(nlist=48, iter=3)
assert sr.engine.posting_lists == e2.posting_lists, "not bit-identical"

# --- 2-D hosts x chips mesh with the HOST axis spanning the two REAL
# processes (process-major device order => mesh row h is host h's local
# devices): the staged chip-then-host merge crosses a real process boundary.
# Parity asserted against the 1-D-mesh run above on the SAME engine state.
from rii_tpu.parallel import make_mesh_hc
mesh_hc = make_mesh_hc()  # n_hosts = process_count() = 2, n_chips = 4
assert dict(mesh_hc.shape) == {"hosts": 2, "chips": 4}
assert all(d.process_index == h for h in range(2)
           for d in mesh_hc.devices[h]), "host axis must align to processes"
sr2 = ShardedRii(sr.engine, mesh=mesh_hc)
ids_1d, d_1d = sr.query_batch(q, topk=5)
ids_2d, d_2d = sr2.query_batch(q, topk=5)                       # linear
assert np.array_equal(ids_2d, ids_1d) and np.allclose(d_2d, d_1d)
iv2, dv2 = sr2.query_ivf_batch(q, topk=5, L=sr.engine.N)        # IVF
iv1, dv1 = sr.query_ivf_batch(q, topk=5, L=sr.engine.N)
assert np.allclose(np.sort(dv2, 1), np.sort(dv1, 1), rtol=1e-3)
it2, _ = sr2.query_batch(q, topk=5, target_ids=tids)            # subset
it1, _ = sr.query_batch(q, topk=5, target_ids=tids)
assert np.array_equal(it2, it1)
n_dev0 = sr2._n_dev
cache0 = sr2._scan_cache
X3 = rng.random((128, d)).astype(np.float32)
sr2.add(X3, update_posting_lists=True)                          # delta-add
assert sr2._n_dev == n_dev0 + 128
assert sr2._scan_cache is cache0, "2-D delta add must not rebuild"
ids_n2, _ = sr2.query_batch(X3[:4], topk=1)
assert (ids_n2[:, 0] >= n + 128).all()
sr2.reconfigure(nlist=48, iter=3)                               # reconfigure
e3 = Rii(pq)
for batch in (X, X2, X3):
    e3.add(batch, update_posting_lists=False)
e3.reconfigure(nlist=48, iter=3)
assert sr2.engine.posting_lists == e3.posting_lists, "2-D not bit-identical"
print(f"[p{pid}] MULTIPROCESS OK", flush=True)
'''


def test_two_process_distributed_runtime(tmp_path):
    worker = tmp_path / "mh_worker.py"
    worker.write_text(_WORKER)
    # free port for the coordinator
    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", port, repo],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(tmp_path)) for i in range(2)]
    try:
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:  # never leak workers on timeout/failure
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
        assert f"[p{i}] MULTIPROCESS OK" in out
