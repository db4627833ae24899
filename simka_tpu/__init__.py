"""simka-tpu: a JAX comparative-metagenomics engine.

A from-scratch rebuild of the capabilities of GATB/simka (Simka +
SimkaMin v1.5.3): per-sample k-mer spectra and all-pairs ecological
distance matrices, computed as XLA programs on one GPU (or a mesh of
them).

Architecture (vs the reference's disk-partitioned multi-process design):

- Reads are 2-bit packed host-side and streamed to the device as dense
  ``[batch, max_len]`` uint8 tensors.
- Canonical k-mer extraction, counting and the cross-sample join run as
  fused XLA programs: one global sort over (kmer, sample) replaces the
  reference's DSK superkmer machinery + disk partition files + k-way
  merge heap (reference: src/SimkaCount.cpp, src/SimkaMerge.cpp).
- All distance sufficient statistics (reference:
  src/core/SimkaAlgorithm.hpp:356-631) are exact integer reductions,
  computed per chunk with limb-split float32 matmuls (C^T@P, P^T@P,
  C^T@C) and elementwise pair reductions -- no scatter over pairs.
- Multi-device: the k-mer hash space is sharded over a
  ``jax.sharding.Mesh`` (the role of the reference's minimizer
  Repartitor, src/SimkaPotara.hpp:713-723); per-shard statistics are
  combined with ``psum`` (the reference's
  ``SimkaStatistics::operator+=``, src/core/SimkaDistance.cpp:156).

64-bit note: we enable jax_enable_x64 so that small accumulator arrays
can be held exactly in int64/float64; every hot tensor (packed reads,
k-mer keys as (hi, lo) uint32 pairs, per-chunk matmuls) stays 32-bit.

The backend is chosen by JAX itself (``JAX_PLATFORMS``).
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# The checkout's own compile-cache directory, used when the
# environment names none: a fixed path, so reruns of the same shape
# class hit the cache.
CHECKOUT_COMPILE_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def _configure_compile_cache() -> None:
    """Persistent compile cache: the fused count/join program is large
    and identical across runs of the same shape class.
    JAX_COMPILATION_CACHE_DIR, when set, is left to JAX alone."""
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", CHECKOUT_COMPILE_CACHE)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_configure_compile_cache()

__version__ = "0.1.0"

from simka_tpu.config import SimkaConfig  # noqa: E402,F401
