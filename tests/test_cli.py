"""CLI surface: argument handling and error paths."""

import gzip
import os

import numpy as np

from simka_tpu.cli import main


def test_missing_input_clean_error(capsys):
    rc = main(["-in", "/nonexistent/input.txt", "-out", "/tmp/x"])
    assert rc == 1
    assert "error" in capsys.readouterr().err


def test_malformed_input_clean_error(tmp_path, capsys):
    p = tmp_path / "bad.txt"
    p.write_text("no colon here\n")
    rc = main(["-in", str(p), "-out", "/tmp/x"])
    assert rc == 1
    assert "invalid input line" in capsys.readouterr().err


def test_data_info(capsys, example_input):
    rc = main(["-in", example_input, "-out", "/tmp/x", "-data-info"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "A: 99 reads" in out
    assert "E: 402 reads" in out


def test_end_to_end_default_flags(tmp_path, example_input):
    out = str(tmp_path / "res")
    rc = main(
        ["-in", example_input, "-out", out, "-verbose", "0", "-n-shards", "1"]
    )
    assert rc == 0
    # default mode emits the 15 always-on matrices
    produced = [f for f in os.listdir(out) if f.endswith(".csv.gz")]
    assert len(produced) == 15
    with gzip.open(
        os.path.join(out, "mat_abundance_braycurtis.csv.gz"), "rt"
    ) as f:
        assert f.read().startswith(";A;B;C;D;E")
    metrics_path = os.path.join(out, "simka_metrics.json")
    assert os.path.exists(metrics_path)
    # the repartition skew diagnostic must appear on the DEFAULT
    # (in-memory) path too, not just -out-tmp (printCountInfo analog,
    # SimkaPotara.hpp:785-811)
    import json

    with open(metrics_path) as f:
        metrics = json.load(f)
    hist = metrics["counters"]["repartition_histogram"]
    assert len(hist) >= 2 and sum(hist) > 0


def test_min_info_roundtrip(tmp_path, capsys, example_input):
    sketch = str(tmp_path / "s.bin")
    rc = main(
        [
            "min",
            "sketch",
            "-in",
            example_input,
            "-out",
            sketch,
            "-kmer-size",
            "21",
            "-nb-kmers",
            "50",
        ]
    )
    assert rc == 0
    rc = main(["min", "info", "-in", sketch])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Nb datasets: 5" in out


def test_single_batch_of_power_of_two_rows(tmp_path):
    """One coalesced ingest batch whose valid windows fill a
    power-of-two class exactly (2 samples x 64 reads x 64 k=21
    windows): the batch's word columns are the join's columns, and
    freeing the batch must not free them."""
    rng = np.random.default_rng(0)
    lines = []
    for s in range(2):
        reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (64, 84))]
        path = tmp_path / f"s{s}.fasta"
        path.write_bytes(b"".join(b">r\n" + r.tobytes() + b"\n" for r in reads))
        lines.append(f"S{s}: {path}")
    inp = tmp_path / "input.txt"
    inp.write_text("\n".join(lines) + "\n")
    out = str(tmp_path / "res")
    rc = main(["-in", str(inp), "-out", out, "-verbose", "0",
               "-n-shards", "1", "-abundance-min", "1"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "mat_abundance_braycurtis.csv.gz"))
