"""The singleton-pruned two-program join must be bit-identical to the
fused single-program join on every statistic (the reference's
`nbBankThatHaveKmer > 1` insert gate, src/SimkaMerge.cpp:1317-1325,
never changes results -- only skips no-op pair work)."""

import jax.numpy as jnp
import numpy as np
import pytest

from simka_tpu.ops.countjoin import (
    count_join_stats,
    count_join_stats_split,
    join_stats_from_spectra,
    join_stats_from_spectra_split,
)

SENTINEL = np.uint32(0xFFFFFFFF)

# chord_ninj / kullback_leibler ride the double-float f32 einsum whose
# rounding depends on panel grouping -- the split program's resized
# stream regroups panels, so those two channels agree to ~1e-7
# relative (same tolerance the sharding tests use); every integer
# accumulator must match bit-for-bit.
FLOAT_FIELDS = ("chord_ninj", "kullback_leibler")


def _assert_join_stats_equal(a, b):
    for name in a._fields:
        ga = np.asarray(getattr(a, name))
        gb = np.asarray(getattr(b, name))
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(
                ga, gb, rtol=1e-6, atol=1e-10, err_msg=name
            )
        else:
            np.testing.assert_array_equal(ga, gb, err_msg=name)


def _instances(rng, E, n_banks, hi_bits, singleton_frac):
    """Instance stream where ~singleton_frac of distinct k-mers are
    private to one bank (the regime the prune targets)."""
    space = E // 3 + 1
    vals = rng.integers(0, space, size=E, dtype=np.uint64)
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    # make a prefix of the value space single-bank: all instances of
    # value v < cut are forced to bank v % n_banks
    cut = int(space * singleton_frac)
    single = vals < cut
    sid[single] = (vals[single] % n_banks).astype(np.int32)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    if hi_bits == 0:
        hi[:] = 0
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    bad = rng.choice(E, size=E // 50, replace=False)
    hi[bad] = SENTINEL
    lo[bad] = SENTINEL
    return jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid)


@pytest.mark.parametrize(
    "n_banks,hi_bits,amin,simple,complex_",
    [
        (8, 10, 1, False, False),
        (8, 10, 2, True, True),
        (24, 0, 1, False, False),
        (50, 10, 2, False, False),
        (50, 32, 1, True, True),  # generic (unpacked) path
        (128, 10, 1, False, False),
    ],
)
@pytest.mark.parametrize("singleton_frac", [0.0, 0.7])
def test_split_matches_fused_instances(
    n_banks, hi_bits, amin, simple, complex_, singleton_frac
):
    rng = np.random.default_rng(n_banks + hi_bits)
    hi, lo, sid = _instances(rng, 1 << 13, n_banks, hi_bits, singleton_frac)
    kw = dict(
        n_banks=n_banks,
        simple=simple,
        complex_=complex_,
        count_bits=16,
        hi_bits=hi_bits,
    )
    args = (hi, lo, sid, jnp.int32(amin), jnp.int64(10**9))
    a = count_join_stats(*args, **kw)
    b = count_join_stats_split(*args, **kw)
    _assert_join_stats_equal(a, b)


def test_split_matches_fused_spectra():
    rng = np.random.default_rng(3)
    n_banks, E = 40, 5000
    vals = rng.integers(0, 2000, size=E, dtype=np.uint64)
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    # dedupe (kmer, sample): spectra hold one row per pair
    key = vals * n_banks + sid
    _, first = np.unique(key, return_index=True)
    vals, sid = vals[first], sid[first]
    E2 = len(vals)
    counts = rng.integers(1, 300, size=E2).astype(np.int32)
    hi = np.zeros(E2, np.uint32)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    override = rng.integers(10**6, 10**7, size=n_banks).astype(np.int64)
    kw = dict(
        n_banks=n_banks, simple=True, complex_=True,
        count_bits=16, hi_bits=11,
    )
    args = (
        (jnp.asarray(hi), jnp.asarray(lo)),
        jnp.asarray(sid),
        jnp.asarray(counts),
        jnp.int32(2),
        jnp.int64(10**9),
        jnp.asarray(override),
    )
    a = join_stats_from_spectra(*args, **kw)
    b = join_stats_from_spectra_split(*args, **kw)
    _assert_join_stats_equal(a, b)


def test_split_all_singletons():
    """Every k-mer private to one bank: the pair program runs on an
    (almost) empty stream and every pair matrix must be zero."""
    rng = np.random.default_rng(9)
    n_banks = 20
    E = 4096
    vals = np.arange(E, dtype=np.uint64)  # all distinct
    sid = (vals % n_banks).astype(np.int32)
    hi = np.zeros(E, np.uint32)
    lo = vals.astype(np.uint32)
    js = count_join_stats_split(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid),
        jnp.int32(1), jnp.int64(10**9),
        n_banks=n_banks, hi_bits=0,
    )
    assert int(js.nb_distinct) == E
    assert int(js.nb_shared) == 0
    assert np.asarray(js.shared_distinct).sum() == 0
    assert np.asarray(js.bray_numerator).sum() == 0


def test_sharded_split_matches_fused(monkeypatch):
    """Split join under an 8-shard mesh must match the fused sharded
    join (and hence the single-device result, by the existing
    1-vs-N invariance tests)."""
    import jax

    from simka_tpu.parallel.sharded import (
        make_mesh,
        shard_instances_by_hash,
        sharded_count_join_stats,
        sharded_count_join_stats_split,
    )

    rng = np.random.default_rng(21)
    n_banks = 40
    hi, lo, sid = _instances(rng, 1 << 13, n_banks, 10, 0.6)
    words_sh, sid_sh = shard_instances_by_hash(
        (np.asarray(hi), np.asarray(lo)), np.asarray(sid), 8
    )
    mesh = make_mesh(8)
    kw = dict(mesh=mesh, n_banks=n_banks, hi_bits=10)
    a = sharded_count_join_stats(words_sh, sid_sh, 1, 10**9, **kw)
    b = sharded_count_join_stats_split(words_sh, sid_sh, 1, 10**9, **kw)
    _assert_join_stats_equal(a, b)


def test_sharded_spectra_split_matches_fused():
    from simka_tpu.parallel.sharded import (
        make_mesh,
        shard_rows_by_hash,
        sharded_join_from_spectra,
        sharded_join_from_spectra_split,
    )

    rng = np.random.default_rng(31)
    n_banks, E = 40, 6000
    vals = rng.integers(0, 2500, size=E, dtype=np.uint64)
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    key = vals * n_banks + sid
    _, first = np.unique(key, return_index=True)
    vals, sid = vals[first], sid[first]
    counts = rng.integers(1, 300, size=len(vals)).astype(np.int32)
    words = (
        np.zeros(len(vals), np.uint32),
        vals.astype(np.uint32),
    )
    ws, ss, cs = shard_rows_by_hash(words, sid, counts, 8)
    mesh = make_mesh(8)
    kw = dict(
        mesh=mesh, n_banks=n_banks, simple=True, complex_=True,
        count_bits=16,
    )
    a = sharded_join_from_spectra(ws, ss, cs, 2, 10**9, **kw)
    b = sharded_join_from_spectra_split(
        ws, ss, cs, 2, 10**9, hi_bits=12, **kw
    )
    _assert_join_stats_equal(a, b)


def test_pipeline_split_forced_matches(monkeypatch, tmp_path, example_input):
    """Full pipeline with the split forced on vs off: identical
    matrices up to the double-float channels' ~1e-7 panel-regrouping
    tolerance (jensenshannon/chord; every other matrix is driven by
    bit-exact integer accumulators)."""
    from simka_tpu.config import SimkaConfig
    from simka_tpu.core.pipeline import run_simka

    results = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("SIMKA_TPU_SPLIT_JOIN", flag)
        out = tmp_path / f"out{flag}"
        config = SimkaConfig(
            input_filename=example_input,
            output_dir=str(out),
            kmer_size=21,
            abundance_min=2,
            simple_dist=True,
            complex_dist=True,
            verbose=False,
            n_shards=1,
        )
        results[flag] = run_simka(config)
    for name in results["0"]:
        np.testing.assert_allclose(
            results["0"][name],
            results["1"][name],
            rtol=1e-6,
            atol=1e-10,
            err_msg=name,
        )
