"""The references and helpers chip_smoke.py uses on the GPU, checked
here on the CPU: the numpy reference against compute_statistics and
the host sketch, the smoke's device report, the compile-cache
placement and the memory plan of a device without memory stats."""

import collections
import gzip
import os

import numpy as np
import pytest

import chip_smoke
import simka_tpu
from scripts.synthetic50 import make_genomes, make_reads
from simka_tpu import reference as ref
from simka_tpu.config import SimkaConfig
from simka_tpu.core import budget
from simka_tpu.core.pipeline import compute_statistics


def _samples(n=4, n_reads=120, read_len=60, seed=5):
    rng = np.random.default_rng(seed)
    genomes = make_genomes(rng, 4, 3000)
    out = []
    for _ in range(n):
        picks = rng.choice(4, size=2, replace=False)
        reads = make_reads(rng, genomes, picks, n_reads, read_len, noise=0.01)
        reads[rng.random(reads.shape) < 0.002] = ord("N")
        out.append(reads)
    return out


@pytest.mark.parametrize("k,amin", [(21, 2), (31, 0), (15, 1)])
def test_reference_matches_compute_statistics(k, amin):
    samples = _samples()
    stats = compute_statistics(
        [[r.tobytes() for r in s] for s in samples],
        [f"S{i}" for i in range(len(samples))],
        SimkaConfig(kmer_size=k, abundance_min=amin, simple_dist=True,
                    complex_dist=True, verbose=False, n_shards=1),
    )
    solid = [ref.solid_kmers(*ref.sample_counts(s, k), amin) for s in samples]
    for i, sk in enumerate(solid):
        assert ref.compare_stats(
            ref.pipeline_bank_totals(stats, i), ref.bank_totals(sk[1])
        ) == []
    for i in range(len(samples)):
        for j in range(i + 1, len(samples)):
            want = ref.pair_stats(solid[i], solid[j])
            assert want["shared_distinct"] > 0
            assert ref.compare_stats(
                ref.pipeline_pair_stats(stats, i, j), want
            ) == [], (i, j)


def test_canonical_kmers_match_python_oracle():
    code = {65: 0, 67: 1, 71: 2, 84: 3}
    seqs = [b"ACGTTGCANGGATCCA", b"TTTTACGTAC", b"GGGCCCAAATTTGG"]
    k = 5
    want = []
    for s in seqs:
        for p in range(len(s) - k + 1):
            win = [code.get(b) for b in s[p : p + k]]
            if None in win:
                continue
            fwd = rc = 0
            for b in win:
                fwd = fwd * 4 + b
            for b in reversed(win):
                rc = rc * 4 + (3 - b)
            want.append(min(fwd, rc))
    got = ref.canonical_kmers(ref.reads_matrix(seqs), k)
    assert got.tolist() == want


@pytest.mark.parametrize("sketch_size", [50, 100_000])
def test_bottom_sketch_matches_host_path(sketch_size):
    from simka_tpu.minhash.sketch import _compute_sketch_host

    reads = _samples(n=1, n_reads=300)[0]
    want = _compute_sketch_host([r.tobytes() for r in reads], 21,
                                sketch_size, 100)
    got = ref.bottom_sketch(reads, 21, sketch_size, 100)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_pair_stats_counts_by_hand():
    a = (np.array([1, 2, 5], np.uint64), np.array([3, 1, 4], np.int64))
    b = (np.array([2, 5, 9], np.uint64), np.array([2, 9, 1], np.int64))
    assert ref.pair_stats(a, b) == {
        "shared_distinct": 2,
        "bray_numerator": 1 + 4,
        "sum_a": 1 + 4,
        "sum_b": 2 + 9,
        "hellinger": 1 + 6,  # floor(sqrt(2)), floor(sqrt(36))
        "chord_ninj": 2.0 + 36.0,
    }


@pytest.mark.parametrize("fastq", [False, True])
def test_smoke_records_parse(tmp_path, fastq):
    from simka_tpu.io.bank import read_sequences

    reads = _samples(n=1, n_reads=7, read_len=33)[0]
    path = tmp_path / ("r.fastq.gz" if fastq else "r.fasta")
    data = chip_smoke._records(reads, fastq=fastq)
    if fastq:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)
    assert read_sequences(str(path)) == [r.tobytes() for r in reads]


def test_device_report_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.gpu_device_report()


def _config_updates(monkeypatch):
    calls = collections.OrderedDict()
    monkeypatch.setattr(
        simka_tpu._jax.config, "update",
        lambda name, value: calls.__setitem__(name, value),
    )
    return calls


def test_compile_cache_in_checkout_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _config_updates(monkeypatch)
    simka_tpu._configure_compile_cache()
    cache = calls["jax_compilation_cache_dir"]
    assert cache == simka_tpu.CHECKOUT_COMPILE_CACHE
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0


def test_compile_cache_env_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _config_updates(monkeypatch)
    simka_tpu._configure_compile_cache()
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0


class _Device:
    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize(
    "stats,want",
    [(None, budget.CPU_BACKEND_BYTES), ({"bytes_limit": 63_000_000_000},
                                        63_000_000_000)],
    ids=["no-stats", "gpu-limit"],
)
def test_memory_plan_source(monkeypatch, stats, want):
    import jax

    monkeypatch.delenv("SIMKA_TPU_HBM_MB", raising=False)
    monkeypatch.setattr(jax, "local_devices", lambda: [_Device(stats)])
    assert budget.device_memory_bytes() == want
    assert budget.hbm_budget_bytes() == int(want * budget.HBM_PLAN_FRACTION)
    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "2")
    assert budget.hbm_budget_bytes() == 2_000_000
