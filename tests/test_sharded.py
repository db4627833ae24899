"""Sharding invariance: 1 device vs N devices must be bit-identical.

Device translation of the reference's resource-invariance test
(/root/reference/tests/simple_test.py:123-131: different nb-cores /
memory must produce identical matrices).
"""

import jax
import numpy as np
import pytest

from simka_tpu.config import SimkaConfig
from simka_tpu.core.distances import compute_all_matrices
from simka_tpu.core.output import format_matrix_csv
from simka_tpu.core.stats import SimkaStatistics
from simka_tpu.ops.countjoin import count_join_stats
from simka_tpu.parallel.sharded import (
    make_mesh,
    shard_instances_by_hash,
    sharded_count_join_stats,
)


def random_instances(rng, n, n_banks, kspace=50_000):
    vals = rng.integers(0, kspace, size=n, dtype=np.uint64)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sid = rng.integers(0, n_banks, size=n).astype(np.int32)
    # sprinkle invalids
    inv = rng.random(n) < 0.05
    hi[inv] = 0xFFFFFFFF
    lo[inv] = 0xFFFFFFFF
    return hi, lo, sid


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_invariance(n_shards):
    if len(jax.devices()) < n_shards:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(42)
    n_banks = 6
    hi, lo, sid = random_instances(rng, 20_000, n_banks)

    js1 = count_join_stats(
        hi, lo, sid, np.int32(2), np.int64(10**9),
        n_banks=n_banks, simple=True, complex_=True,
    )
    mesh = make_mesh(n_shards)
    ws, ss = shard_instances_by_hash((hi, lo), sid, n_shards)
    jsN = sharded_count_join_stats(
        ws, ss, 2, 10**9,
        mesh=mesh, n_banks=n_banks, simple=True, complex_=True,
    )
    for name in js1._fields:
        a = np.asarray(getattr(js1, name))
        b = np.asarray(getattr(jsN, name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_shard_invariance_default_channels(n_shards):
    """Default channels take the pair-bin MXU path; under shard_map
    it must still match the single-device result bit-for-bit (the
    vary_axes/pcast handling of its fori carry)."""
    if len(jax.devices()) < n_shards:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(3)
    n_banks = 8
    hi, lo, sid = random_instances(rng, 20_000, n_banks)

    js1 = count_join_stats(
        hi, lo, sid, np.int32(1), np.int64(10**9), n_banks=n_banks
    )
    mesh = make_mesh(n_shards)
    ws, ss = shard_instances_by_hash((hi, lo), sid, n_shards)
    jsN = sharded_count_join_stats(
        ws, ss, 1, 10**9, mesh=mesh, n_banks=n_banks
    )
    for name in js1._fields:
        a = np.asarray(getattr(js1, name))
        b = np.asarray(getattr(jsN, name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_shard_invariance_matrices_bitexact():
    """Full pipeline: formatted CSVs identical across shard counts."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(7)
    n_banks = 4
    ids = [f"s{i}" for i in range(n_banks)]
    hi, lo, sid = random_instances(rng, 30_000, n_banks)

    outs = []
    for n_shards in (1, 4):
        mesh = make_mesh(n_shards)
        ws, ss = shard_instances_by_hash((hi, lo), sid, n_shards)
        js = sharded_count_join_stats(
            ws, ss, 1, 10**9,
            mesh=mesh, n_banks=n_banks, simple=True, complex_=True,
            )
        stats = SimkaStatistics.from_join_stats(
            js, ids, 21, np.ones(n_banks, np.int64), True, True
        )
        mats = compute_all_matrices(stats)
        outs.append(
            {k: format_matrix_csv(v, ids) for k, v in mats.items()}
        )
    assert outs[0] == outs[1]


@pytest.mark.parametrize("simple", [False, True], ids=["default", "all"])
def test_shard_invariance_chunked_reductions(simple, monkeypatch):
    """Under shard_map the chunked reductions (several row chunks per
    shard) must still match the single-device result bit for bit: the
    chunk loop's carry takes its shard-varying type from the data."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    from simka_tpu.ops import intmatmul
    from simka_tpu.parallel import sharded

    rng = np.random.default_rng(11)
    n_banks = 8
    hi, lo, sid = random_instances(rng, 60_000, n_banks)
    kw = dict(n_banks=n_banks, simple=simple, complex_=simple)
    js1 = count_join_stats(hi, lo, sid, np.int32(1), np.int64(10**9), **kw)
    monkeypatch.setattr(intmatmul, "CHUNK_ROWS", 4096)
    mesh = make_mesh(4)
    ws, ss = shard_instances_by_hash((hi, lo), sid, 4)
    jax.clear_caches()
    try:
        jsN = sharded.sharded_count_join_stats(ws, ss, 1, 10**9, mesh=mesh, **kw)
    finally:
        jax.clear_caches()
    for name in js1._fields:
        a = np.asarray(getattr(js1, name))
        b = np.asarray(getattr(jsN, name))
        if a.dtype.kind == "f":
            # float channels sum f32 panels whose rows differ per shard
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
