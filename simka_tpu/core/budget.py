"""Device-memory budget planning (the ConfigurationAlgorithm role).

The reference sizes jobs and partition counts so every merge fits the
user's -max-memory (src/SimkaPotara.hpp:617-713: per-dataset
ConfigurationAlgorithm memory split; :713-723 partition count). Here
the plan bounds the FUSED JOIN's working set by device memory: the
default device-resident paths accumulate extracted k-mer words on the
device until the join, so a run whose instance stream exceeds the budget must
fall back to the out-of-core route (count per-sample spectra ->
hash-range spill -> sweep, core/sweep.py) BEFORE the device allocator
fails mid-run.

Two guards compose:
- a cheap up-front estimate from input file sizes (run_simka) routes
  clearly-oversized runs straight to the out-of-core path;
- an exact mid-ingest check in the device paths raises
  HBMBudgetExceeded, and compute_statistics restarts out-of-core
  (inputs are re-iterable providers) -- wasted ingest is bounded by
  the budget itself.
"""

from __future__ import annotations

import os

# The fused join holds roughly this multiple of the raw row payload
# (sort buffers, compaction columns, segment scans; the pair stage's
# one-hot and limb temporaries are bounded per row chunk, see
# ops/intmatmul.chunked_sum) -- same factor core/sweep.choose_n_ranges
# uses for the host path. XLA:GPU's memory analysis of the 2^28-row
# join on an H100 gives 6.2-6.8x the 12-byte k <= 31 row for N=8
# (scripts/profiling/join_memory.py).
JOIN_WORKING_SET_FACTOR = 8

# Fraction of the device's reported memory the join may plan to use
# (headroom for the XLA runtime, programs and transient buffers).
HBM_PLAN_FRACTION = 0.6

# The CPU backend reports no allocator limit; the plan then assumes
# this much memory for its "device" (tests force smaller plans through
# SIMKA_TPU_HBM_MB).
CPU_BACKEND_BYTES = 8_000_000_000


class HBMBudgetExceeded(RuntimeError):
    """The device-resident ingest would exceed the memory plan; the
    caller must re-run through the out-of-core sweep."""


def device_memory_bytes() -> int:
    """Allocator limit of the first local device: the GPU's
    ``memory_stats()["bytes_limit"]`` (what XLA's client reserved for
    this process), or CPU_BACKEND_BYTES for a device that reports no
    memory stats."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    if stats is None:
        return CPU_BACKEND_BYTES
    return int(stats["bytes_limit"])


def hbm_budget_bytes() -> int:
    """Per-device bytes the join may plan with.

    SIMKA_TPU_HBM_MB overrides (also how tests force the out-of-core
    path on small inputs); otherwise the device's memory limit times
    the plan fraction.
    """
    env = os.environ.get("SIMKA_TPU_HBM_MB")
    if env:
        return int(float(env) * 1_000_000)
    return int(device_memory_bytes() * HBM_PLAN_FRACTION)


def instance_rows_budget(n_words: int, n_shards: int = 1) -> int:
    """Max k-mer instance rows the fused join may accumulate.

    Each instance carries n_words uint32 words + an int32 sample id;
    under hash sharding every device holds ~1/n_shards of the rows, so
    capacity scales with the mesh.
    """
    row_bytes = 4 * (n_words + 1)
    per_device = hbm_budget_bytes() // (
        row_bytes * JOIN_WORKING_SET_FACTOR
    )
    return max(int(per_device) * max(n_shards, 1), 1)


def spectrum_rows_budget(
    n_words: int, max_memory_mb: int, n_shards: int = 1
) -> int:
    """Max spectrum rows one sweep range's join may hold: the smaller
    of the HBM plan and the user's -max-memory declaration (the
    reference's knob, SimkaPotara.hpp:383-387)."""
    row_bytes = 4 * (n_words + 2)  # words + sid + count
    budget = min(
        hbm_budget_bytes() * max(n_shards, 1),
        max(max_memory_mb, 1) * 1_000_000,
    )
    return max(budget // (row_bytes * JOIN_WORKING_SET_FACTOR), 1)


def estimate_total_instances(datasets) -> int:
    """Crude instance-count estimate from input file sizes (the role
    of gatb Bank::estimate, SimkaAlgorithm.cpp:428-433): ~1 k-mer
    instance per base, ~1 byte per base in FASTA/FASTQ, gz ~4x.

    Used only to choose the cheaper route up front; the exact
    mid-ingest guard catches underestimates.
    """
    total = 0
    for d in datasets:
        for bank in d.banks:
            for f in bank:
                try:
                    size = os.path.getsize(f)
                except OSError:
                    continue
                if f.endswith(".gz"):
                    size *= 4
                total += size
    return total
