"""Golden-file parity vs the reference's committed truth matrices.

Mirrors the reference's own test strategy
(/root/reference/tests/simple_test.py): run the full pipeline on the
5-sample example input for {k=21,31} x {abundance-min 0,2} with simple
+ complex distances on, and compare every produced matrix byte-for-byte
with tests/truth/results_k{21,31}_t{0,2}.
"""

import glob
import os

import pytest

from simka_tpu.config import SimkaConfig
from simka_tpu.core.distances import compute_all_matrices
from simka_tpu.core.output import format_matrix_csv
from simka_tpu.core.pipeline import compute_statistics
from simka_tpu.io.bank import read_dataset
from simka_tpu.io.dsl import parse_input_file

REF = "/root/reference"
EXAMPLE_INPUT = f"{REF}/example/simka_input.txt"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference checkout not available"
)

_seq_cache = {}


def load_example():
    if "d" not in _seq_cache:
        datasets = parse_input_file(EXAMPLE_INPUT)
        _seq_cache["d"] = (
            [d.id for d in datasets],
            [read_dataset(d.banks) for d in datasets],
        )
    return _seq_cache["d"]


_stats_cache = {}


def stats_for(k: int, t: int, n_shards: int = 0):
    key = (k, t, n_shards)
    if key not in _stats_cache:
        ids, seqs = load_example()
        config = SimkaConfig(
            kmer_size=k,
            abundance_min=t,
            simple_dist=True,
            complex_dist=True,
            verbose=False,
            n_shards=n_shards,
        )
        _stats_cache[key] = compute_statistics(seqs, ids, config)
    return _stats_cache[key]


# n_shards=0 takes the sharded path on the virtual 8-device mesh;
# n_shards=1 exercises the single-device fully-device-resident path
# (packed transfer + fused join) that single-GPU runs use
@pytest.mark.parametrize(
    "k,t,n_shards",
    [(21, 0, 0), (21, 2, 0), (31, 0, 0), (31, 2, 0),
     (21, 2, 1), (31, 0, 1)],
)
def test_truth_matrices(k, t, n_shards):
    truth_dir = f"{REF}/tests/truth/results_k{k}_t{t}"
    ids, _ = load_example()
    stats = stats_for(k, t, n_shards)
    matrices = compute_all_matrices(stats)

    truth_files = sorted(glob.glob(os.path.join(truth_dir, "*.csv")))
    assert truth_files, truth_dir
    failures = []
    for tf in truth_files:
        name = os.path.basename(tf)[: -len(".csv")]
        assert name in matrices, f"missing output matrix {name}"
        with open(tf) as f:
            truth = f.read()
        ours = format_matrix_csv(matrices[name], ids)
        if ours != truth:
            failures.append(name)
    assert not failures, f"k={k} t={t} mismatched: {failures}"
    # we must produce exactly the reference's output set; the truth dirs
    # omit mat_abundance_jaccard (derived from Bray-Curtis,
    # reference tests/simple_test.py:39-40) though real runs emit it
    produced = set(matrices)
    expected = {os.path.basename(t)[:-4] for t in truth_files}
    assert produced - expected <= {"mat_abundance_jaccard"}
    assert expected <= produced
