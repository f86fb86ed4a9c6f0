"""vgaligner: a variation-graph read aligner on JAX accelerators.

A from-scratch JAX/XLA re-design of the capabilities of
AlgoLab/rs-vgaligner (the reference):

  * graph linearization + k-mer index over a GFA variation graph
    (reference: src/utils.rs, src/kmer.rs, src/index.rs)
  * exact k-mer anchoring + minimap2-style chaining DP emitting GAF
    (reference: src/chain.rs, src/map.rs)
  * optional base-level partial-order alignment over the chain-implied
    subgraph (reference: src/align.rs; abPOA / rspoa engines)

Design notes (device-first, not a port):
  * The boomphf MPHF + linear membership scan (index.rs:229-236,319) is
    replaced by a sorted 2-bit-packed k-mer code table; lookup is a
    vectorized binary search (jnp.searchsorted) on device.
  * The O(seq_len) bitvector rank/select loops (index.rs:427-480) are
    replaced by a node-start prefix array + searchsorted.
  * The per-read scalar loops become batched, vmapped/shard_mapped device
    kernels; chains/POA DP run as scans with vectorized inner windows,
    and the POA DP as a hand-written CUDA kernel on NVIDIA GPUs
    (ops/cuda/poa_dp.cu).

float64 note: chain scores in the reference are f64 with
round-to-3-decimals (chain.rs:361-363); bit-identical GAF therefore
requires f64 on the exactness-critical DP path, so x64 is enabled
globally here.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when the
# environment sets it (JAX reads it itself), otherwise one fixed
# directory inside the checkout, so every process of a checkout reuses
# what an earlier one compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )

__version__ = "0.1.0"
