"""The packed u64-key fast path of count_join_stats must be
bit-identical to the generic multi-word path on every statistic."""

import jax.numpy as jnp
import numpy as np
import pytest

from simka_tpu.ops.countjoin import count_join_stats

SENTINEL = np.uint32(0xFFFFFFFF)


def _random_instances(rng, E, n_banks, hi_bits, n_sentinel):
    hi = rng.integers(0, max(1, 1 << hi_bits), size=E, dtype=np.uint64)
    lo = rng.integers(0, 1 << 12, size=E, dtype=np.uint64)  # collisions
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    hi = hi.astype(np.uint32)
    lo = lo.astype(np.uint32)
    if n_sentinel:
        bad = rng.choice(E, size=n_sentinel, replace=False)
        hi[bad] = SENTINEL
        lo[bad] = SENTINEL
    return jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid)


DEFAULT_FIELDS = [
    "nb_distinct",
    "nb_shared",
    "distinct_per_bank",
    "solid_per_bank",
    "chord_n2_per_bank",
    "shared_kmers_ab",
    "shared_kmers_ba",
    "shared_distinct",
    "bray_numerator",
]


@pytest.mark.parametrize(
    "n_banks,hi_bits,amin,amax",
    [(8, 10, 1, 10**9), (8, 10, 2, 3), (6, 0, 2, 10**9), (3, 21, 1, 2)],
)
def test_packed_path_matches_generic(n_banks, hi_bits, amin, amax):
    rng = np.random.default_rng(42)
    hi, lo, sid = _random_instances(rng, 4096, n_banks, hi_bits, 100)
    kw = dict(
        n_banks=n_banks, simple=True, complex_=True, count_bits=16
    )
    a = count_join_stats(
        hi, lo, sid, jnp.int32(amin), jnp.int64(amax),
        hi_bits=hi_bits, **kw,
    )
    b = count_join_stats(
        hi, lo, sid, jnp.int32(amin), jnp.int64(amax),
        hi_bits=32, **kw,  # forces the generic multi-word path
    )
    for name in a._fields:
        ga, gb = np.asarray(getattr(a, name)), np.asarray(
            getattr(b, name)
        )
        assert np.array_equal(ga, gb), (name, ga, gb)


@pytest.mark.parametrize(
    "n_banks,amin",
    [(2, 1), (3, 1), (8, 1), (8, 2), (16, 2), (64, 1)],
)
def test_pairbin_path_matches_shift_loop(n_banks, amin):
    """Default channels take the pair-bin MXU path (N <=
    PAIRBIN_MAX_BANKS; the larger-N case guards the shared loop
    path); running with simple+complex forces the per-shift loop,
    which computes the same default fields -- they must agree
    bit-for-bit."""
    rng = np.random.default_rng(7)
    hi, lo, sid = _random_instances(rng, 8192, n_banks, 10, 200)
    a = count_join_stats(
        hi, lo, sid, jnp.int32(amin), jnp.int64(10**9),
        n_banks=n_banks, hi_bits=10,
    )
    b = count_join_stats(
        hi, lo, sid, jnp.int32(amin), jnp.int64(10**9),
        n_banks=n_banks, hi_bits=10, simple=True, complex_=True,
    )
    for name in DEFAULT_FIELDS:
        ga, gb = np.asarray(getattr(a, name)), np.asarray(
            getattr(b, name)
        )
        assert np.array_equal(ga, gb), (name, ga, gb)


@pytest.mark.parametrize("n_banks,amin", [(24, 1), (32, 2)])
def test_pairbin_multi_block_matches_shift_loop(
    n_banks, amin, monkeypatch
):
    """The multi-block (> 128 triangle lanes) pair-bin regime is
    auto-off (PAIRBIN_MAX_BANKS=16), 
    so force the threshold up to actually exercise that einsum branch
    against the per-shift loop (ADVICE r4 #1: the plain N=24/32
    params compared the loop against itself)."""
    from simka_tpu.ops import countjoin

    monkeypatch.setattr(countjoin, "PAIRBIN_MAX_BANKS", 32)
    count_join_stats.clear_cache()
    try:
        rng = np.random.default_rng(7)
        hi, lo, sid = _random_instances(rng, 8192, n_banks, 10, 200)
        a = count_join_stats(
            hi, lo, sid, jnp.int32(amin), jnp.int64(10**9),
            n_banks=n_banks, hi_bits=10,
        )
        b = count_join_stats(
            hi, lo, sid, jnp.int32(amin), jnp.int64(10**9),
            n_banks=n_banks, hi_bits=10, simple=True, complex_=True,
        )
    finally:
        # drop traces specialized on the patched threshold
        count_join_stats.clear_cache()
    for name in DEFAULT_FIELDS:
        ga, gb = np.asarray(getattr(a, name)), np.asarray(
            getattr(b, name)
        )
        assert np.array_equal(ga, gb), (name, ga, gb)


def test_pairbin_path_multi_panel():
    """Rows spanning several einsum panels (incl. a ragged last
    panel) must fold identically."""
    rng = np.random.default_rng(5)
    hi, lo, sid = _random_instances(rng, 3 * 8192 + 1000, 8, 10, 300)
    a = count_join_stats(
        hi, lo, sid, jnp.int32(1), jnp.int64(10**9),
        n_banks=8, hi_bits=10,
    )
    b = count_join_stats(
        hi, lo, sid, jnp.int32(1), jnp.int64(10**9),
        n_banks=8, hi_bits=10, simple=True, complex_=True,
    )
    for name in DEFAULT_FIELDS:
        ga, gb = np.asarray(getattr(a, name)), np.asarray(
            getattr(b, name)
        )
        assert np.array_equal(ga, gb), (name, ga, gb)


def test_pairbin_path_multi_limb_counts():
    """Counts past 255 must flow through the higher limb lanes of
    the pair-bin path without losing exactness."""
    rng = np.random.default_rng(11)
    E, n_banks = 1 << 15, 4
    hi = np.zeros(E, np.uint32)
    lo = rng.integers(0, 24, size=E, dtype=np.uint64).astype(np.uint32)
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    args = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid),
            jnp.int32(1), jnp.int64(10**9))
    _, per_cell = np.unique(
        lo.astype(np.int64) * n_banks + sid, return_counts=True
    )
    assert per_cell.max() > 255  # multi-limb regime reached
    a = count_join_stats(*args, n_banks=n_banks, hi_bits=0)
    b = count_join_stats(
        *args, n_banks=n_banks, hi_bits=0, simple=True, complex_=True
    )
    for name in DEFAULT_FIELDS:
        ga, gb = np.asarray(getattr(a, name)), np.asarray(
            getattr(b, name)
        )
        assert np.array_equal(ga, gb), (name, ga, gb)


@pytest.mark.parametrize("n_banks", [17, 33, 65, 128])
@pytest.mark.parametrize("dup", [1, 600])
def test_wide_n_default_channels_consistent(n_banks, dup):
    """Wide-N (triangle > 128 bins) default channels must not depend
    on which optional channels ride along in the shift loop. ``dup``
    replicates instances to push counts past 255 (runtime multi-limb
    levels) and to lengthen segments (the d_max regime)."""
    rng = np.random.default_rng(n_banks * 7 + dup)
    E = 6000
    hi, lo, sid = _random_instances(rng, E, n_banks, 6, 50)
    if dup > 1:
        hi = jnp.concatenate([hi[:64]] * dup + [hi])
        lo = jnp.concatenate([lo[:64]] * dup + [lo])
        sid = jnp.concatenate([sid[:64]] * dup + [sid])
    amin, amax = np.int32(1), np.int64(10**9)
    # simple=True routes default channels through the 4-pass loop
    ref = count_join_stats(
        hi, lo, sid, amin, amax, n_banks=n_banks, simple=True
    )
    got = count_join_stats(
        hi, lo, sid, amin, amax, n_banks=n_banks
    )
    for name in DEFAULT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(ref, name)),
            err_msg=name,
        )


@pytest.mark.parametrize(
    "n_banks,simple,complex_,E",
    [(8, False, False, 40_000), (8, True, True, 40_000),
     (20, True, True, 32_768)],
    ids=["pairbin-ragged", "all-channels-ragged", "shift-loop-whole"],
)
def test_chunked_reductions_match_one_chunk(
    n_banks, simple, complex_, E, monkeypatch
):
    """The pair stage, the Whittaker all-rows term and binned_sum
    reduce row chunk by row chunk (ops/intmatmul.chunked_sum): many
    small chunks, a ragged last one included, must give the one-chunk
    result -- integer channels bit for bit."""
    from simka_tpu.ops import intmatmul

    rng = np.random.default_rng(7)
    hi, lo, sid = _random_instances(rng, E, n_banks, 10, 50)
    kw = dict(n_banks=n_banks, simple=simple, complex_=complex_,
              count_bits=16, hi_bits=10)
    args = (hi, lo, sid, jnp.int32(1), jnp.int64(10**9))
    one = count_join_stats(*args, **kw)
    monkeypatch.setattr(intmatmul, "CHUNK_ROWS", 8192)
    count_join_stats.clear_cache()
    try:
        many = count_join_stats(*args, **kw)
    finally:
        count_join_stats.clear_cache()
    for name in one._fields:
        a, b = np.asarray(getattr(one, name)), np.asarray(getattr(many, name))
        if name in ("chord_ninj", "kullback_leibler"):
            np.testing.assert_allclose(b, a, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
