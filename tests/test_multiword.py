"""k > 31 (multi-word k-mer) end-to-end consistency.

No upstream truth exists beyond k=31, so the oracle is a
pure-python recount over the example reads: per-sample canonical
k-mer counts, abundance filtering, and the core pairwise sums.
"""

import collections
import math

import numpy as np
import pytest

from simka_tpu.config import SimkaConfig
from simka_tpu.core.pipeline import compute_statistics
from simka_tpu.io.bank import read_dataset
from simka_tpu.io.dsl import parse_input_file


def test_k_cap_matches_reference_spans():
    SimkaConfig(kmer_size=127)  # largest k of the gatb klist spans
    with pytest.raises(ValueError):
        SimkaConfig(kmer_size=128)
    with pytest.raises(ValueError):
        SimkaConfig(kmer_size=0)

CODE = {65: 0, 67: 1, 71: 2, 84: 3}
COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def oracle_counts(seqs, k):
    counts = collections.Counter()
    for s in seqs:
        bases = [CODE.get(b) for b in s]
        for i in range(len(bases) - k + 1):
            win = bases[i : i + k]
            if any(b is None for b in win):
                continue
            fwd = 0
            for b in win:
                fwd = fwd * 4 + b
            rc = 0
            for b in reversed(win):
                rc = rc * 4 + COMP[b]
            counts[min(fwd, rc)] += 1
    return counts


def _window_shannon(bases):
    n = len(bases)
    h = 0.0
    for b in range(4):
        f = bases.count(b) / n
        if f > 0:
            h += f * math.log2(f)
    return abs(h)


def test_k63_kmer_shannon_filter():
    """-kmer-shannon-index at k = 63 (multi-word values; the k <= 31
    limitation was lifted in round 4). Oracle: per-window base-entropy
    filter on the python recount -- entropy is invariant under
    complement so canonicalization does not change it."""
    k, thr = 63, 1.5
    rng = np.random.default_rng(7)
    reads = []
    for _ in range(40):
        # half low-complexity (AC-repeat dominated), half random, so
        # the filter genuinely splits the windows
        if rng.random() < 0.5:
            base = b"AC" * 40 + bytes(
                rng.choice(np.frombuffer(b"ACGT", np.uint8), size=10)
            )
            reads.append(base)
        else:
            reads.append(
                bytes(
                    rng.choice(np.frombuffer(b"ACGT", np.uint8), size=90)
                )
            )
    seqs = [reads, reads[::2]]
    config = SimkaConfig(
        kmer_size=k,
        abundance_min=1,
        min_kmer_shannon_index=thr,
        verbose=False,
        n_shards=1,
    )
    stats = compute_statistics(seqs, ["A", "B"], config)

    def oracle(sample):
        counts = collections.Counter()
        for s in sample:
            bases = [CODE.get(b) for b in s]
            for i in range(len(bases) - k + 1):
                win = bases[i : i + k]
                if any(b is None for b in win):
                    continue
                if _window_shannon(win) < thr:
                    continue
                fwd = 0
                for b in win:
                    fwd = fwd * 4 + b
                rc = 0
                for b in reversed(win):
                    rc = rc * 4 + COMP[b]
                counts[min(fwd, rc)] += 1
        return counts

    per_sample = [oracle(s) for s in seqs]
    assert 0 < len(per_sample[0]) < sum(
        max(len(s) - k + 1, 0) for s in seqs[0]
    ), "filter must drop some but not all windows"
    for i, f in enumerate(per_sample):
        assert int(stats.distinct_per_bank[i]) == len(f), i
        assert int(stats.solid_per_bank[i]) == sum(f.values()), i


@pytest.mark.parametrize("k", [33, 41, 63, 64, 75])
def test_k_gt_31_pipeline(k, example_input):
    # 63/64 cross the 4-word boundary (2k == 128 is the "2k % 32 == 0"
    # sentinel-headroom case in extract_canonical_kmers_multi); 75
    # exercises a 5-word k-mer (reference spans reach k=127,
    # CMakeLists.txt:66-71)
    datasets = parse_input_file(example_input)[:3]  # A, B, C
    ids = [d.id for d in datasets]
    seqs = [read_dataset(d.banks) for d in datasets]
    amin = 2

    config = SimkaConfig(
        kmer_size=k, abundance_min=amin, verbose=False, n_shards=1
    )
    stats = compute_statistics(seqs, ids, config)

    per_sample = [oracle_counts(s, k) for s in seqs]
    filtered = [
        {v: c for v, c in cnt.items() if c >= amin} for cnt in per_sample
    ]
    for i, f in enumerate(filtered):
        assert int(stats.distinct_per_bank[i]) == len(f), i
        assert int(stats.solid_per_bank[i]) == sum(f.values()), i
        assert int(stats.chord_n2_per_bank[i]) == sum(
            c * c for c in f.values()
        ), i

    union = set().union(*[set(f) for f in filtered])
    assert stats.nb_distinct_kmers == len(union)

    for i in range(3):
        for j in range(i + 1, 3):
            shared = set(filtered[i]) & set(filtered[j])
            assert int(stats.shared_distinct[i][j]) == len(shared), (i, j)
            assert int(stats.shared_kmers[i][j]) == sum(
                filtered[i][v] for v in shared
            ), (i, j)
            assert int(stats.bray_numerator[i][j]) == sum(
                min(filtered[i][v], filtered[j][v]) for v in shared
            ), (i, j)
