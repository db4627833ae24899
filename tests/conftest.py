import os
import sys

import numpy as np
import pytest

# Tests run on a virtual 8-device CPU mesh unless JAX_PLATFORMS names
# another backend: sharding logic is exercised without accelerator
# hardware, and results must be identical to 1-device runs (the
# reference's resource-invariance test, tests/simple_test.py:78-83).
# Tests marked `gpu` need an NVIDIA GPU; they run with
# JAX_PLATFORMS=cuda,cpu and skip elsewhere.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# the repository root: chip_smoke.py and scripts/ import from here
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

REFERENCE_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_DIR)


# ---- synthetic stand-in for the upstream example input ----
# Same DSL shapes as upstream's example/simka_input.txt: plain banks,
# a paired ';' bank and a concatenated ',' bank. Read counts per file
# are fixed (the parser tests assert them); sequences come from a small
# shared genome pool so samples overlap and k-mers repeat, with wrapped
# FASTA lines, N bases and low-complexity reads for the filters.
EXAMPLE_READS = {
    "A.fasta": 99,
    "B.fasta": 102,
    "C.fasta": 98,
    "D_paired_1.fasta": 93,
    "D_paired_2.fasta": 53,
    "E_1.fasta": 150,
    "E_2.fasta": 100,
    "E_3.fasta": 152,
}
EXAMPLE_INPUT = (
    "A: A.fasta\n"
    "B: B.fasta\n"
    "C: C.fasta\n"
    "D: D_paired_1.fasta ; D_paired_2.fasta\n"
    "E: E_1.fasta , E_2.fasta ; E_3.fasta\n"
)
_WRAPPED = ("A.fasta", "C.fasta", "E_2.fasta")


def _example_read(rng, genomes) -> bytes:
    kind = rng.random()
    length = int(rng.integers(80, 151))
    if kind < 0.08:  # low complexity: fails the Shannon filters
        unit = (b"A", b"AC", b"AAC", b"ACGG")[int(rng.integers(4))]
        return (unit * length)[:length]
    g = genomes[int(rng.integers(len(genomes)))]
    start = int(rng.integers(0, len(g) - length))
    read = g[start : start + length].copy()
    subst = rng.random(length) < 0.01
    read[subst] = rng.choice(np.frombuffer(b"ACGT", np.uint8), subst.sum())
    if kind > 0.96:
        read[int(rng.integers(length))] = ord("N")
    if rng.random() < 0.5:  # reverse complement
        read = np.frombuffer(
            bytes(read[::-1]).translate(bytes.maketrans(b"ACGTN", b"TGCAN")),
            np.uint8,
        )
    return bytes(read)


def write_example(directory: str, seed: int = 2024) -> str:
    """Write the synthetic example files; return the input file path."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genomes = [bases[rng.integers(0, 4, 3000)] for _ in range(3)]
    for name, n_reads in EXAMPLE_READS.items():
        with open(os.path.join(directory, name), "wb") as f:
            for i in range(n_reads):
                seq = _example_read(rng, genomes)
                f.write(b">%s_%d\n" % (name.split(".")[0].encode(), i))
                if name in _WRAPPED:
                    for p in range(0, len(seq), 60):
                        f.write(seq[p : p + 60] + b"\n")
                else:
                    f.write(seq + b"\n")
    path = os.path.join(directory, "simka_input.txt")
    with open(path, "w") as f:
        f.write(EXAMPLE_INPUT)
    return path


@pytest.fixture(scope="session")
def example_dir(tmp_path_factory) -> str:
    """Directory holding the synthetic example and its input file."""
    d = tmp_path_factory.mktemp("example")
    write_example(str(d))
    return str(d)


@pytest.fixture(scope="session")
def example_input(example_dir) -> str:
    return os.path.join(example_dir, "simka_input.txt")
