"""Worker for the multi-process merge/mapping tests (test_parallel.py).

Each process maps its contiguous shard of the path-window reads on CPU
— on a LOCAL n_local-device data mesh when n_local > 1 (the multi-host
deployment shape: reads sharded per host, data-parallel mesh per host)
— and calls merge_gaf_shards; process 0 writes the merged GAF.  Run as:
    python _dist_merge_worker.py <coordinator> <n_procs> <pid> <out.gaf>
                                 [n_local_devices]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("VGALIGNER_DENSE_LUT_MAX", "0")
_n_local = int(sys.argv[5]) if len(sys.argv) > 5 else 1
if _n_local > 1:
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={_n_local}"
    ).strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    coordinator, n_procs, pid, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    )
    from vgaligner_tpu.parallel.distributed import (
        host_shard, initialize, merge_gaf_shards,
    )

    ppi, ppc = initialize(coordinator, n_procs, pid)
    assert ppc == n_procs, (ppi, ppc)

    from vgaligner_tpu.graph import graph_from_gfa
    from vgaligner_tpu.index import Index
    from vgaligner_tpu.io.fastx import read_seqs_from_file
    from vgaligner_tpu.models.mapper import Mapper

    g = graph_from_gfa(os.path.join(os.path.dirname(__file__), "data", "test.gfa"))
    index = Index.build(g, 11, 100, 100)
    queries = read_seqs_from_file(
        os.path.join(os.path.dirname(__file__), "golden", "path-window-reads.fa")
    )
    shard = queries[host_shard(len(queries), ppi, ppc)]
    mesh = None
    if _n_local > 1:
        from vgaligner_tpu.parallel import make_mesh

        local = jax.local_devices()
        assert len(local) == _n_local, local
        mesh = make_mesh(devices=local)
    mapper = Mapper(index, bandwidth=50, max_gap=1000,
                    chain_min_n_anchors=2, mesh=mesh)
    records = mapper.chains_to_gaf(mapper.map_reads(shard))

    merged = merge_gaf_shards(records, out_path, ppi, ppc)
    if ppi == 0:
        # both branches must return record objects, not strings
        from vgaligner_tpu.io.gaf import GAFAlignment

        assert merged and all(isinstance(r, GAFAlignment) for r in merged)
        print(f"MERGED {len(merged)}")
    else:
        assert merged is None
        print("SHARD OK")


if __name__ == "__main__":
    main()
