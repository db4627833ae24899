"""REAL 2-process jax.distributed execution of the multi-host
pipeline (VERDICT r4 next-step 3): two CPU processes (localhost
coordinator, 4 virtual devices each = a global 8-device mesh) run
run_simka_multihost end-to-end, exercising the process_allgather /
make_array_from_process_local_data branches
(parallel/multihost.py:113-118, 308-335) that single-process CI only
runs in degenerate form. Matrices must be byte-identical to a
single-process run -- the reference's resource-invariance oracle
(tests/simple_test.py:126-131) across process counts, and its
cluster mode's correctness contract (SimkaPotara.hpp:884-897)."""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_CHILD = r"""
import sys
import jax

jax.config.update("jax_platforms", "cpu")
coord, pid, nproc, input_txt, out_dir, split = sys.argv[1:7]
if int(nproc) > 1:
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid),
    )
import os

os.environ["SIMKA_TPU_SPLIT_JOIN"] = split
from simka_tpu.config import SimkaConfig
from simka_tpu.parallel.multihost import run_simka_multihost

run_simka_multihost(
    SimkaConfig(
        input_filename=input_txt,
        output_dir=out_dir,
        kmer_size=21,
        abundance_min=1,
        simple_dist=True,
        complex_dist=True,
        verbose=False,
    )
)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_input(tmp_path, n_samples=5):
    rng = np.random.default_rng(23)
    bases = np.frombuffer(b"ACGT", np.uint8)
    shared = [
        bases[rng.integers(0, 4, 80)].tobytes() for _ in range(30)
    ]
    lines = []
    for s in range(n_samples):
        p = tmp_path / f"S{s}.fasta"
        with open(p, "wb") as f:
            for i in range(200):
                seq = (
                    shared[rng.integers(0, len(shared))]
                    if rng.random() < 0.4
                    else bases[rng.integers(0, 4, 80)].tobytes()
                )
                f.write(b">r%d\n" % i + seq + b"\n")
        lines.append(f"S{s}: {p}")
    input_txt = tmp_path / "input.txt"
    input_txt.write_text("\n".join(lines) + "\n")
    return str(input_txt)


def _run(nproc, coord, input_txt, out_dir, split, script):
    repo = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..")
    )
    env = dict(
        os.environ,
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_PLATFORMS="",
        PYTHONPATH=repo
        + os.pathsep
        + os.environ.get("PYTHONPATH", ""),
    )
    env.pop("SIMKA_TPU_SPLIT_JOIN", None)
    procs = [
        subprocess.Popen(
            [sys.executable, script, coord, str(pid), str(nproc),
             input_txt, out_dir, split],
            env=env,
            cwd=os.path.join(os.path.dirname(__file__), ".."),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]


@pytest.mark.parametrize("split", ["0", "1"])
def test_two_process_matches_single(tmp_path, split):
    """Both join programs (fused and singleton-prune split) must be
    process-count-invariant under REAL multi-process collectives."""
    input_txt = _write_input(tmp_path)
    script = str(tmp_path / "child.py")
    with open(script, "w") as f:
        f.write(_CHILD)

    out1 = str(tmp_path / "out_single")
    _run(1, "unused", input_txt, out1, split, script)
    out2 = str(tmp_path / "out_two")
    _run(2, f"localhost:{_free_port()}", input_txt, out2, split,
         script)

    names = sorted(
        f for f in os.listdir(out1) if f.endswith(".csv.gz")
    )
    assert names and names == sorted(
        f for f in os.listdir(out2) if f.endswith(".csv.gz")
    )
    for name in names:
        a = gzip.open(os.path.join(out1, name)).read()
        b = gzip.open(os.path.join(out2, name)).read()
        assert a == b, name
