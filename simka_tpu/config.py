"""Configuration for the simka-tpu pipelines.

Mirrors the reference CLI surface (option tree built in
/root/reference/src/core/Simka.cpp:25-120 and forwarded to workers at
/root/reference/src/SimkaPotara.hpp:847-871) but as a plain dataclass;
the CLI in simka_tpu/cli.py maps flag names onto these fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SimkaConfig:
    """Options for the exact (full-spectrum) pipeline.

    Defaults follow the reference: k=21, abundance-min 2,
    abundance-max 999999999 (Simka.cpp:63-67), max-reads -1 = use all
    reads (Simka.cpp:84), read filters off.
    """

    input_filename: str = ""
    output_dir: str = "./simka_results"
    output_tmp_dir: Optional[str] = None

    kmer_size: int = 21
    abundance_min: int = 2
    abundance_max: int = 999_999_999
    min_kmer_shannon_index: float = 0.0  # parsed but inert in the
    # reference's live path (filter body commented out at
    # SimkaAlgorithm.hpp:226-232); we apply it for real when nonzero.

    max_reads: int = -1  # -1: all reads; 0: auto ((min+mean)/2,
    # SimkaAlgorithm.cpp:428-433); N: per-dataset cap.
    min_read_size: int = 0
    min_read_shannon_index: float = 0.0

    simple_dist: bool = False  # Chord, Hellinger, Kulczynski
    complex_dist: bool = False  # Whittaker, Jensen-Shannon, Canberra

    nb_cores: int = 0
    max_memory_mb: int = 5000
    keep_tmp: bool = False
    verbose: bool = True

    # device knobs (no reference equivalent)
    n_shards: int = 0  # 0: use all local devices for k-mer-space sharding
    sweep_ranges: int = 0  # out-of-core hash-range sweep (needs
    # -out-tmp): 0 = auto (sweep only when the projected join exceeds
    # the -max-memory budget), N = force N sequential ranges
    read_batch_size: int = 1 << 18  # reads per device batch
    n_policy: str = "skip"  # "skip": k-mers spanning non-ACGT are dropped

    def __post_init__(self):
        if self.kmer_size < 1 or self.kmer_size > 127:
            raise ValueError(
                f"kmer_size must be in [1, 127] (got {self.kmer_size}); "
                "this matches the reference's compiled spans "
                "(gatb-core-klist 32..128 => k up to 127, "
                "CMakeLists.txt:66-71)"
            )
        if not (0.0 <= self.min_read_shannon_index <= 2.0):
            # the reference clamps to [0, 2] (SimkaAlgorithm.cpp:185-197)
            self.min_read_shannon_index = min(
                max(self.min_read_shannon_index, 0.0), 2.0
            )
        if not (0.0 <= self.min_kmer_shannon_index <= 2.0):
            self.min_kmer_shannon_index = min(
                max(self.min_kmer_shannon_index, 0.0), 2.0
            )
