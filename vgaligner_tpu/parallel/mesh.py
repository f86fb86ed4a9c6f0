"""Device-mesh data parallelism for read mapping.

The reference is a single-process, single-threaded CLI (its rayon
parallelism is compiled out — SURVEY.md §2.3, kmer.rs:13-14,
index_main.rs:63-69); its per-read loop (map.rs:56-111) is the unit of
parallelism.  The device design distributes that loop:

  * 1-D mesh over a `data` axis (devices × hosts flattened);
  * the index (DeviceIndex arrays) is *replicated* — HLA-scale indexes
    are MBs; offset-sharding of the position table over the mesh is the
    planned path for pangenome-scale graphs;
  * the read batch (codes, lens) is sharded along axis 0;
  * the mapping step is pure per-read compute, so SPMD compilation
    inserts no collectives; GAF records are gathered on host (the
    deterministic-order merge the reference gets for free from its
    sequential loop).

Multi-host: call jax.distributed.initialize() before building the mesh;
jax.devices() then spans hosts and the same code paths apply, with the
batch sharded per-host by the input pipeline.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D data-parallel mesh over the first n available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("data",))


def shard_batch(mesh: Mesh, *arrays):
    """Place batch arrays sharded along axis 0 of the data mesh."""
    sharding = NamedSharding(mesh, P("data"))
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. DeviceIndex) across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sharding), tree)


def place_index(mesh: Mesh, dindex, shard_positions: bool = False):
    """Place a DeviceIndex on the mesh.

    shard_positions=False replicates everything (HLA-scale indexes are
    MBs).  shard_positions=True shards the position table
    (fo_start/fo_end — the dominant index memory at pangenome scale,
    analog of the reference's in-RAM kmer_pos_table, index.rs:37-90)
    along the data axis by table row, padded so every device owns an
    equal contiguous range; the code table / counts / offsets / LUT
    stay replicated.  Consumed by Mapper._device_map_sharded, which
    reassembles gathered rows with one psum per batch."""
    if not shard_positions:
        return replicate(mesh, dindex)
    import numpy as np

    nd = mesh.devices.size
    repl = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P("data"))

    def pad_rows(a):
        n = a.shape[0]
        n_pad = pad_batch_to_multiple(max(n, nd), nd)
        if n_pad != n:
            a = np.concatenate([np.asarray(a), np.zeros(n_pad - n, a.dtype)])
        return a

    return type(dindex)(
        kmer_codes=jax.device_put(dindex.kmer_codes, repl),
        fo_offsets=jax.device_put(dindex.fo_offsets, repl),
        fo_counts=jax.device_put(dindex.fo_counts, repl),
        fo_start=jax.device_put(pad_rows(dindex.fo_start), row),
        fo_end=jax.device_put(pad_rows(dindex.fo_end), row),
        node_starts=jax.device_put(dindex.node_starts, repl),
        dense_lut=None if dindex.dense_lut is None
        else jax.device_put(dindex.dense_lut, repl),
    )


def pad_batch_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
