"""Large-N regression: the shift-pair join at N=50 samples.

Simka's headline use case is hundreds of samples
(upstream README.md use cases; simkaMin.py tiles at 100). The
oracle exploits pair locality: every distance matrix entry [i, j]
depends only on samples i and j (their spectra and per-bank totals),
so a 2-sample pipeline run is an exact oracle for any entry of the
50-sample run -- this validates the d_max<=50 shift-loop regime
without a Python recount over millions of k-mers.
"""

import numpy as np
import pytest

from scripts.synthetic50 import make_datasets

from simka_tpu.config import SimkaConfig
from simka_tpu.core.distances import compute_all_matrices
from simka_tpu.core.pipeline import compute_statistics

N = 50
READS = 200

# matrices whose [i, j] depends only on samples i and j
PAIR_LOCAL = [
    "mat_abundance_braycurtis",
    "mat_abundance_jaccard",
    "mat_presenceAbsence_jaccard",
    "mat_presenceAbsence_ochiai",
    "mat_presenceAbsence_chord",
    "mat_abundance_chord",
    "mat_abundance_hellinger",
    "mat_abundance_whittaker",
    "mat_abundance_jensenshannon",
    "mat_abundance_canberra",
]


@pytest.fixture(scope="module")
def big_run():
    datasets = make_datasets(N, READS)
    ids = [f"S{i:03d}" for i in range(N)]
    config = SimkaConfig(
        kmer_size=31,
        abundance_min=2,
        simple_dist=True,
        complex_dist=True,
        verbose=False,
        n_shards=1,
    )
    stats = compute_statistics(datasets, ids, config)
    return datasets, compute_all_matrices(stats), config


def test_large_n_properties(big_run):
    _, mats, _ = big_run
    bc = mats["mat_abundance_braycurtis"]
    assert bc.shape == (N, N)
    assert np.all(np.diag(bc) == 0)
    assert np.all((bc >= 0) & (bc <= 1.0000001))
    assert np.allclose(bc, bc.T)


def test_large_n_pairwise_oracle(big_run):
    datasets, mats, config = big_run
    rng = np.random.default_rng(0)
    pairs = [tuple(sorted(rng.choice(N, 2, replace=False)))
             for _ in range(4)]
    for i, j in pairs:
        stats2 = compute_statistics(
            [datasets[i], datasets[j]], ["a", "b"], config
        )
        mats2 = compute_all_matrices(stats2)
        for name in PAIR_LOCAL:
            assert name in mats, name
            got = mats[name][i, j]
            want = mats2[name][0, 1]
            # chord/jensenshannon ride the double-float f32 einsum
            # channels whose summation order differs with N; every
            # integer-exact channel must match to the last bit
            if name in (
                "mat_abundance_chord",
                "mat_abundance_jensenshannon",
            ):
                assert got == pytest.approx(want, rel=1e-9), (
                    name, i, j, got, want,
                )
            else:
                assert got == want, (name, i, j, got, want)
