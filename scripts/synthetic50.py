"""50-sample synthetic metagenome run (BASELINE config #4).

Generates 50 synthetic samples from a shared pool of source genomes
(so samples overlap realistically), runs the full sharded pipeline at
k=31, and reports wall-clock + sanity checks. Works on the virtual
CPU mesh or a real chip.

Usage: python scripts/synthetic50.py [n_samples] [reads_per_sample]
"""

import sys
import time

import numpy as np


def make_genomes(rng, n_genomes=10, genome_len=20_000) -> np.ndarray:
    """[n_genomes, genome_len] random ASCII source genomes."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    return bases[rng.integers(0, 4, size=(n_genomes, genome_len))]


def make_reads(
    rng, genomes, picks, n_reads, read_len, weights=None, noise=0.005
) -> np.ndarray:
    """[n_reads, read_len] ASCII reads drawn from the genomes in
    ``picks`` (with relative abundances ``weights``), with ~``noise``
    substitution errors; half of the reads are reverse complements."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = np.asarray(picks)[rng.choice(len(picks), size=n_reads, p=weights)]
    start = rng.integers(0, genomes.shape[1] - read_len, size=n_reads)
    reads = genomes[g[:, None], start[:, None] + np.arange(read_len)]
    err = rng.random(reads.shape) < noise
    reads[err] = bases[rng.integers(0, 4, size=int(err.sum()))]
    comp = np.zeros(256, np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    flip = rng.random(n_reads) < 0.5
    reads[flip] = comp[reads[flip, ::-1]]
    return reads


def make_datasets(n_samples=50, reads_per_sample=400, read_len=120):
    """Samples as lists of read byte strings: 10 source genomes, each
    sample mixes 3 of them plus noise (so samples overlap)."""
    rng = np.random.default_rng(7)
    genomes = make_genomes(rng)
    datasets = []
    for _ in range(n_samples):
        picks = rng.choice(len(genomes), size=3, replace=False)
        reads = make_reads(rng, genomes, picks, reads_per_sample, read_len)
        datasets.append([r.tobytes() for r in reads])
    return datasets


def main():
    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    reads = int(sys.argv[2]) if len(sys.argv) > 2 else 400

    import jax

    from simka_tpu.config import SimkaConfig
    from simka_tpu.core.distances import compute_all_matrices
    from simka_tpu.core.pipeline import compute_statistics

    datasets = make_datasets(n_samples, reads)
    ids = [f"S{i:03d}" for i in range(n_samples)]
    config = SimkaConfig(
        kmer_size=31,
        abundance_min=2,
        simple_dist=True,
        complex_dist=True,
        verbose=False,
    )
    n_dev = len(jax.devices())
    t0 = time.time()
    stats = compute_statistics(datasets, ids, config)
    mats = compute_all_matrices(stats)
    dt = time.time() - t0

    bc = mats["mat_abundance_braycurtis"]
    assert bc.shape == (n_samples, n_samples)
    assert np.all(np.diag(bc) == 0)
    assert np.all((bc >= 0) & (bc <= 1.0000001))
    assert np.allclose(bc, bc.T)
    total_reads = n_samples * reads
    print(
        f"{n_samples} samples x {reads} reads, k=31, "
        f"{n_dev} device(s): {dt:.1f}s "
        f"({total_reads / dt:.0f} reads/s), "
        f"{stats.nb_distinct_kmers} distinct kmers, "
        f"{len(mats)} matrices"
    )
    print("mean off-diag Bray-Curtis:", round(float(
        bc[~np.eye(n_samples, dtype=bool)].mean()), 4))


if __name__ == "__main__":
    main()
