"""A/B of the singleton-prune program split vs the fused join at wide
N and realistic singleton fractions (ops/countjoin.SPLIT_MIN_BANKS).

Stream model: values below a cut are forced single-bank, so the
fraction of (kmer, bank) rows sitting in size-1 segments is ~f +
(1-f)/N -- 50-80% covers real metagenomes.

Run:  python scripts/profiling/bench_split_join.py [N ...]
"""

import functools
import sys

from harness import device_line, median_seconds

import jax.numpy as jnp
import numpy as np

from simka_tpu.ops.countjoin import (
    count_join_stats,
    count_join_stats_split,
)


def make_stream(rng, E, n_banks, singleton_frac):
    space = E // 2
    vals = rng.integers(0, space, size=E, dtype=np.uint64)
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    cut = int(space * singleton_frac)
    single = vals < cut
    sid[single] = (vals[single] % n_banks).astype(np.int32)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid)


def bench(fn, hi, lo, sid, n_banks):
    f = functools.partial(fn, n_banks=n_banks, hi_bits=10)
    args = (hi, lo, sid, jnp.int32(1), jnp.int64(10**9))
    dt = median_seconds(f, *args, iters=3)
    js = f(*args)
    check = (int(js.nb_distinct), np.asarray(js.bray_numerator).tobytes())
    return hi.shape[0] / dt, check


if __name__ == "__main__":
    dev = device_line()
    ns = [int(a) for a in sys.argv[1:]] or [50, 128]
    E = 1 << 23
    for n in ns:
        for frac in (0.5, 0.8):
            rng = np.random.default_rng(1)
            hi, lo, sid = make_stream(rng, E, n, frac)
            r_fused, c1 = bench(count_join_stats, hi, lo, sid, n)
            r_split, c2 = bench(count_join_stats_split, hi, lo, sid, n)
            flag = "" if c1 == c2 else "  CHECK MISMATCH"
            print(
                f"N={n:4d} f={frac}  fused {r_fused / 1e6:.3f}M  "
                f"split {r_split / 1e6:.3f}M kmers/s "
                f"({r_split / r_fused:.3f}x){flag} | {dev}",
                flush=True,
            )
