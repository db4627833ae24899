"""Out-of-core hash-range sweep: byte-identical to the direct join.

The reference's disk-partitioned architecture (SimkaPotara.hpp:713-723,
SimkaMerge.cpp:638-823) exists so runs larger than memory still work;
core/sweep.py replaces it with sequential hash-range sweeps on one
device. Ranges partition the k-mer space, so every statistic must come
out bit-identical -- including Whittaker/KL, which need the injected
global per-bank totals.
"""

import gzip
import json
import os

import pytest

from simka_tpu.config import SimkaConfig
from simka_tpu.core.pipeline import run_simka

REF = "/root/reference"
INPUT = f"{REF}/example/simka_input.txt"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference checkout not available"
)


def _read_all(outdir):
    out = {}
    for fn in sorted(os.listdir(outdir)):
        if fn.endswith(".csv.gz"):
            with gzip.open(os.path.join(outdir, fn), "rt") as f:
                out[fn] = f.read()
    return out


def _base_kw(**over):
    kw = dict(
        input_filename=INPUT,
        kmer_size=21,
        abundance_min=2,
        simple_dist=True,
        complex_dist=True,
        verbose=False,
        n_shards=1,
    )
    kw.update(over)
    return kw


def test_forced_sweep_matches_direct(tmp_path):
    out_direct = str(tmp_path / "direct")
    run_simka(SimkaConfig(output_dir=out_direct, **_base_kw()))

    out_sweep = str(tmp_path / "sweep")
    run_simka(
        SimkaConfig(
            output_dir=out_sweep,
            output_tmp_dir=str(tmp_path / "tmp"),
            sweep_ranges=3,
            **_base_kw(),
        )
    )
    a, b = _read_all(out_direct), _read_all(out_sweep)
    assert a and a == b
    # spill files removed without -keep-tmp
    assert not (tmp_path / "tmp" / "sweep").exists()


def test_auto_sweep_triggers_on_memory_budget(tmp_path):
    """A budget far below the spectra size must auto-select the sweep
    and still produce byte-exact truth matrices."""
    out = str(tmp_path / "auto")
    run_simka(
        SimkaConfig(
            output_dir=out,
            output_tmp_dir=str(tmp_path / "tmp"),
            max_memory_mb=1,
            keep_tmp=True,
            **_base_kw(),
        )
    )
    with open(os.path.join(out, "simka_metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["counters"]["sweep_ranges"] >= 2
    truth_dir = f"{REF}/tests/truth/results_k21_t2"
    for fn in os.listdir(truth_dir):
        with open(os.path.join(truth_dir, fn)) as f:
            truth = f.read()
        with gzip.open(os.path.join(out, fn + ".gz"), "rt") as f:
            assert f.read() == truth, fn
    # spill kept with -keep-tmp
    assert (tmp_path / "tmp" / "sweep").is_dir()
