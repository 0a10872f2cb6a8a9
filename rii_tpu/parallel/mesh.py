"""Mesh construction and database sharding helpers."""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
HOST_AXIS = "hosts"
CHIP_AXIS = "chips"


def make_mesh(n_devices=None, axis_name=DATA_AXIS):
    """1-D mesh over all (or the first n) local devices; axis = database shard."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def make_mesh_hc(n_hosts=None, n_chips=None):
    """2-D ("hosts", "chips") mesh: the chip axis rides the links within a
    host, the host axis the network between hosts. ShardedRii shards rows
    over BOTH axes and stages its top-k merge chip-axis-first so the
    cross-host hop carries nhosts*topk rows instead of ndev*topk
    (SURVEY.md section 2.5 / BASELINE north star).

    Defaults: n_hosts = jax.process_count(), n_chips = devices per host.
    jax.devices() orders devices process-major, so row h of the mesh is
    exactly host h's local devices.
    """
    devs = jax.devices()
    if n_hosts is None:
        n_hosts = max(1, jax.process_count())
    if n_chips is None:
        n_chips = len(devs) // n_hosts
    assert n_hosts * n_chips <= len(devs), (n_hosts, n_chips, len(devs))
    arr = np.asarray(devs[: n_hosts * n_chips]).reshape(n_hosts, n_chips)
    return Mesh(arr, (HOST_AXIS, CHIP_AXIS))


def put_sharded(mesh, arr, spec):
    """Place a host array on the mesh with the given PartitionSpec.

    Single-process: a plain device_put. Multi-host (jax.distributed): each
    process hands over only its addressable row range via
    ``jax.make_array_from_process_local_data`` — the per-host ingestion path
    for pod-scale databases (every host holds the same canonical numpy state;
    only the local shard is transferred).
    """
    sh = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(arr, sh)
    # the local-slice computation below reads dim 0 of devices_indices_map
    # only; a spec sharding any other dim would silently mis-place data
    assert all(s is None for s in tuple(spec)[1:]), \
        f"put_sharded supports dim-0-sharded or replicated specs only: {spec}"
    imap = sh.devices_indices_map(arr.shape)
    pid = jax.process_index()
    rows = [idx[0] for d, idx in imap.items() if d.process_index == pid]
    lo = min((r.start or 0) for r in rows)
    hi = max(arr.shape[0] if r.stop is None else r.stop for r in rows)
    return jax.make_array_from_process_local_data(sh, np.asarray(arr)[lo:hi],
                                                  global_shape=arr.shape)


def shard_database(mesh, codes, norms, axis_name=DATA_AXIS):
    """Place (cap, M) codes and (cap,) norms row-sharded over the mesh.

    cap must be divisible by the mesh size (the caller pads capacity to a
    power of two, so any power-of-two mesh divides it).
    """
    ndev = mesh.shape[axis_name]
    assert codes.shape[0] % ndev == 0, (codes.shape, ndev)
    codes_sh = jax.device_put(codes, NamedSharding(mesh, P(axis_name, None)))
    norms_sh = jax.device_put(norms, NamedSharding(mesh, P(axis_name)))
    return codes_sh, norms_sh
