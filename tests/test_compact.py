"""Unit tests for the stable row compaction (ops/compact.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from simka_tpu.ops.compact import compact_rows

SENT = np.uint32(0xFFFFFFFF)


def _ref(arrays, kept, fills):
    outs = []
    k = int(kept.sum())
    for a, f in zip(arrays, fills):
        o = np.full(a.shape, f, dtype=a.dtype)
        o[:k] = a[kept]
        outs.append(o)
    return outs


def test_compact_matches_numpy_randomized():
    rng = np.random.default_rng(7)
    for trial in range(20):
        E = int(rng.integers(1, 3000))
        block = int(rng.choice([8, 64, 256, 1024]))
        x = rng.integers(0, 2**31, size=E).astype(np.uint32)
        s = rng.integers(0, 64, size=E).astype(np.int32)
        c = rng.integers(0, 1000, size=E).astype(np.int32)
        kept = rng.random(E) < rng.random()
        got = compact_rows(
            (jnp.asarray(x), jnp.asarray(s), jnp.asarray(c)),
            jnp.asarray(kept),
            fills=(SENT, np.int32(0), np.int32(0)),
            block=block,
        )
        want = _ref((x, s, c), kept, (SENT, 0, 0))
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), w), (trial, block)


def test_compact_all_kept_and_all_dropped():
    E = 500
    x = np.arange(E, dtype=np.uint32)
    ones = np.ones(E, dtype=bool)
    (g,) = compact_rows((jnp.asarray(x),), jnp.asarray(ones), (SENT,), block=128)
    assert np.array_equal(np.asarray(g), x)
    (g,) = compact_rows((jnp.asarray(x),), jnp.asarray(~ones), (SENT,), block=128)
    assert np.all(np.asarray(g) == SENT)


def test_compact_preserves_order_within_kept():
    # kept rows must keep their original relative order (stability is
    # what preserves the (kmer, sample)-ascending pair invariant)
    E = 10_000
    rng = np.random.default_rng(1)
    x = np.sort(rng.integers(0, 100, size=E).astype(np.uint32))
    kept = rng.random(E) < 0.3
    (g,) = compact_rows((jnp.asarray(x),), jnp.asarray(kept), (SENT,), block=256)
    k = kept.sum()
    assert np.array_equal(np.asarray(g)[:k], x[kept])


FILL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.mark.parametrize("E", [4096, 5000, 100_000])
@pytest.mark.parametrize("frac", [0.0, 0.4, 1.0])
def test_compact_mixed_dtypes_ragged_blocks(E, frac):
    """Mixed u64/i32/u32 columns, block-aligned and ragged last
    blocks, empty/partial/full masks: bit-identical to numpy."""
    rng = np.random.default_rng(E + int(frac * 10))
    kept = rng.random(E) < frac
    cols = (
        rng.integers(0, 2**63, size=E, dtype=np.uint64),
        rng.integers(0, 2**31, size=E).astype(np.int32),
        rng.integers(0, 2**32, size=E, dtype=np.uint64).astype(np.uint32),
    )
    fills = (FILL64, np.int32(0), np.uint32(0xFFFFFFFF))
    got = compact_rows(
        tuple(jnp.asarray(c) for c in cols),
        jnp.asarray(kept),
        fills,
        block=4096,
    )
    for g, w in zip(got, _ref(cols, kept, fills)):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_compact_inside_jit():
    """compact_rows must trace under jit (the join programs call it
    inside larger jitted graphs)."""
    import jax

    rng = np.random.default_rng(3)
    E = 8192
    kept = rng.random(E) < 0.5
    col = rng.integers(0, 2**31, size=E).astype(np.int32)

    @jax.jit
    def run(c, k):
        return compact_rows((c,), k, (0,), block=2048)[0]

    got = np.asarray(run(jnp.asarray(col), jnp.asarray(kept)))
    (want,) = _ref((col,), kept, (np.int32(0),))
    np.testing.assert_array_equal(got, want)
