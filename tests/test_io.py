import numpy as np
import pytest

from simka_tpu.io.bank import (
    encode_batch,
    read_dataset,
    read_sequences,
    shannon_index_read,
)
from simka_tpu.io.dsl import parse_input_text

EXAMPLE = "/data/example"  # parse-only: no file is opened


def test_parse_dsl_example():
    text = (
        "A: A.fasta\n"
        "B: B.fasta\n"
        "D: D_paired_1.fasta ; D_paired_2.fasta\n"
        "E: A.fasta , A.fasta ; B.fasta , B.fasta"
    )
    ds = parse_input_text(text, base_dir=EXAMPLE)
    assert [d.id for d in ds] == ["A", "B", "D", "E"]
    assert len(ds[2].banks) == 2
    assert ds[3].banks[0] == [f"{EXAMPLE}/A.fasta"] * 2
    assert len(ds[3].files) == 4


def test_parse_dsl_errors():
    with pytest.raises(ValueError):
        parse_input_text("no_colon_line")
    with pytest.raises(ValueError):
        parse_input_text("A: f\nA: g")
    with pytest.raises(ValueError):
        parse_input_text("")


def test_read_fasta_counts(example_dir):
    # the example's read counts (upstream's, SURVEY.md §2.13)
    assert len(read_sequences(f"{example_dir}/A.fasta")) == 99
    assert len(read_sequences(f"{example_dir}/B.fasta")) == 102
    assert len(read_sequences(f"{example_dir}/C.fasta")) == 98
    assert len(read_sequences(f"{example_dir}/D_paired_1.fasta")) == 93
    assert len(read_sequences(f"{example_dir}/D_paired_2.fasta")) == 53


def test_read_dataset_cap_per_group(example_dir):
    # one group of two concatenated files: cap spans both
    d1 = f"{example_dir}/D_paired_1.fasta"
    d2 = f"{example_dir}/D_paired_2.fasta"
    one_group = [[d1, d2]]
    all_reads = read_dataset(one_group)
    assert len(all_reads) == 146
    # the first read of each file is "free" (uncounted by the
    # reference iterator): 93 (D1, counter ends at 92) + 1 free +
    # counters 93..99 -> 101 reads total
    capped = read_dataset(one_group, max_reads=100)
    assert len(capped) == 101
    assert capped == all_reads[:101]

    # two ';'-groups: the cap applies per group (reference
    # SimkaInputIterator treats each paired group as its own dataset)
    two_groups = [
        [d1],
        [d2],
    ]
    assert len(read_dataset(two_groups, max_reads=100)) == 146
    assert len(read_dataset(two_groups, max_reads=50)) == 100
    # flat list = single group
    flat = [d1, d2]
    assert len(read_dataset(flat, max_reads=100)) == 101


def test_encode_batch_padding():
    codes, lengths = encode_batch([b"ACGT", b"AANTA"])
    assert codes.shape == (2, 5)
    assert list(codes[0]) == [0, 1, 2, 3, 255]
    assert list(codes[1]) == [0, 0, 255, 3, 0]
    assert list(lengths) == [4, 5]


def test_shannon_index():
    # uniform ACGT -> 2 bits
    assert abs(shannon_index_read(b"ACGTACGT") - 2.0) < 1e-6
    assert shannon_index_read(b"AAAAAAA") == 0.0
    # half A half C -> 1 bit
    assert abs(shannon_index_read(b"AACC") - 1.0) < 1e-6


def test_fastq(tmp_path):
    p = tmp_path / "x.fastq"
    p.write_bytes(b"@r1\nACGTACGT\n+\nIIIIIIII\n@r2\nTTTT\n+\nIIII\n")
    seqs = read_sequences(str(p))
    assert seqs == [b"ACGTACGT", b"TTTT"]


def test_gzip_roundtrip(tmp_path):
    import gzip

    p = tmp_path / "x.fasta.gz"
    with gzip.open(p, "wb") as f:
        f.write(b">r1\nACGT\nACGT\n>r2\nTTTT\n")
    seqs = read_sequences(str(p))
    assert seqs == [b"ACGTACGT", b"TTTT"]


def test_estimate_dataset_reads_exact_on_small_files(tmp_path):
    """Files under the sample size estimate EXACTLY (so auto
    -max-reads is unchanged on test-scale data)."""
    import numpy as np

    from simka_tpu.io.bank import (
        count_dataset_reads,
        estimate_dataset_reads,
    )

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    f = tmp_path / "x.fasta"
    with open(f, "wb") as fh:
        for i in range(500):
            fh.write(b">r%d\n%s\n" % (i, bytes(rng.choice(bases, 70))))
    for filt in ((0, 0.0), (80, 0.0)):
        exact = count_dataset_reads([[str(f)]], *filt)
        est = estimate_dataset_reads([[str(f)]], *filt)
        assert est == exact


def test_estimate_dataset_reads_scales_large(tmp_path):
    """Above the sample size the estimate lands within ~10% of the
    true count (fixed-length reads -> near-exact scaling)."""
    import gzip as _gzip

    import numpy as np

    from simka_tpu.io.bank import (
        _estimate_file_reads,
        count_dataset_reads,
    )

    rng = np.random.default_rng(4)
    bases = np.frombuffer(b"ACGT", np.uint8)
    f = tmp_path / "big.fasta"
    n = 20_000
    with open(f, "wb") as fh:
        for i in range(n):
            fh.write(
                b">read%d\n%s\n" % (i, bytes(rng.choice(bases, 100)))
            )
    est = _estimate_file_reads(str(f), 0, 0.0, sample_bytes=1 << 16)
    assert abs(est - n) / n < 0.1

    fz = tmp_path / "big.fasta.gz"
    with open(f, "rb") as src, _gzip.open(fz, "wb") as dst:
        dst.write(src.read())
    est_gz = _estimate_file_reads(str(fz), 0, 0.0, sample_bytes=1 << 16)
    assert abs(est_gz - n) / n < 0.25
