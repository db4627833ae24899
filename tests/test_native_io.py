"""Native (C++) FASTX reader vs the pure-Python reader: identical
streams, identical filter decisions, identical pipeline output.

The native parser is the product ingest path (io/bank.py
iter_filtered_reads; the role of gatb Bank at
src/SimkaCount.cpp:188 upstream); the Python reader is the
fallback and the oracle here.
"""

import gzip
import os

import pytest
from conftest import EXAMPLE_READS

from simka_tpu.io import native
from simka_tpu.io.bank import (
    iter_filtered_reads,
    iter_sequences,
    read_dataset,
    sequence_passes,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native fastx library unavailable"
)

NAMES = sorted(EXAMPLE_READS)


@pytest.fixture
def FILES(example_dir):
    return [os.path.join(example_dir, n) for n in NAMES]


@pytest.mark.parametrize("name", NAMES)
def test_native_matches_python_unfiltered(name, example_dir):
    path = os.path.join(example_dir, name)
    py = list(iter_sequences(path))
    nat = list(native.iter_raw_reads(path))
    assert nat == py


@pytest.mark.parametrize(
    "min_size,min_shannon", [(0, 0.0), (80, 0.0), (0, 1.5), (60, 1.9)]
)
def test_native_matches_python_filtered(min_size, min_shannon, FILES):
    path = FILES[0]
    py = [
        s
        for s in iter_sequences(path)
        if sequence_passes(s, min_size, min_shannon)
    ]
    nat = list(native.iter_raw_reads(path, min_size, min_shannon))
    assert nat == py


def test_native_reads_gzip(tmp_path, FILES):
    gz = tmp_path / "a.fasta.gz"
    with open(FILES[0], "rb") as f:
        data = f.read()
    with gzip.open(gz, "wb") as f:
        f.write(data)
    assert list(native.iter_raw_reads(str(gz))) == list(
        iter_sequences(FILES[0])
    )


def test_native_fastq(tmp_path):
    fq = tmp_path / "a.fastq"
    seqs = [b"ACGTACGTAC", b"GGGTTTAAAC", b"ACACACACAGT"]
    with open(fq, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    assert list(native.iter_raw_reads(str(fq))) == seqs


def test_native_tiny_batches_split_and_resume(FILES):
    """Reads larger than the byte budget force pushback + buffer
    growth; the stream must still be complete and ordered."""
    py = list(iter_sequences(FILES[0]))
    nat = list(
        native.iter_raw_reads(FILES[0], batch_reads=3, batch_bytes=64)
    )
    assert nat == py


def test_read_dataset_same_with_and_without_native(monkeypatch, FILES):
    kw = dict(min_read_size=50, min_read_shannon_index=1.2, max_reads=30)
    with_native = read_dataset([FILES], **kw)
    monkeypatch.setenv("SIMKA_TPU_NO_NATIVE", "1")
    without = read_dataset([FILES], **kw)
    assert with_native == without and len(with_native) > 0


def test_iter_filtered_reads_uses_native_path(FILES):
    # guard against the round-1 regression: native code existing but
    # never called by the product
    import inspect

    src = inspect.getsource(iter_filtered_reads)
    assert "native" in src
    assert list(iter_filtered_reads(FILES[0], 0, 0.0)) == list(
        iter_sequences(FILES[0])
    )
