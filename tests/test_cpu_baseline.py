"""The measured CPU baseline (scripts/profiling/cpu_baseline.cpp) must
compute exactly the statistics ops.countjoin computes on the same
instance stream -- otherwise its kmers/s is not comparable and
bench.py's measured vs_baseline would be meaningless."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(
    os.path.dirname(__file__), "..", "scripts", "profiling",
    "cpu_baseline.cpp",
)


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    out = str(tmp_path_factory.mktemp("cpub") / "cpu_baseline")
    subprocess.run(
        ["g++", "-O3", "-pthread", SRC, "-o", out],
        check=True, capture_output=True, timeout=180,
    )
    return out


def test_cpu_baseline_matches_countjoin(binary, tmp_path):
    import jax.numpy as jnp

    from simka_tpu.ops.countjoin import count_join_stats

    rng = np.random.default_rng(99)
    E, N = 1 << 14, 8
    vals = rng.integers(0, E // 2, size=E, dtype=np.uint64)
    sid = rng.integers(0, N, size=E).astype(np.uint8)

    fn = str(tmp_path / "stream.bin")
    with open(fn, "wb") as f:
        f.write(np.int64(E).tobytes())
        f.write(np.int32(N).tobytes())
        f.write(vals.tobytes())
        f.write(sid.tobytes())
    out = subprocess.run(
        [binary, "0", "0", "1", fn],
        check=True, capture_output=True, timeout=120, text=True,
    ).stdout.splitlines()
    got = json.loads(out[0])

    js = count_join_stats(
        jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(sid.astype(np.int32)),
        jnp.int32(1), jnp.int64(10**9),
        n_banks=N, hi_bits=0,
    )
    assert got["nb_distinct"] == int(js.nb_distinct)
    assert got["nb_shared"] == int(js.nb_shared)
    for name in (
        "shared_distinct", "shared_kmers_ab", "shared_kmers_ba",
        "bray_numerator",
    ):
        want = np.asarray(getattr(js, name)).astype(np.int64)
        have = np.array(got[name], np.int64).reshape(N, N)
        np.testing.assert_array_equal(have, want, err_msg=name)
