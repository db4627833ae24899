"""A/B of the multi-pass triangle pair-bin path vs the 4-pass
per-shift loop in the 16 < N <= 32 band (ops/countjoin.PAIRBIN_MAX_BANKS).

Flips ops.countjoin.PAIRBIN_MAX_BANKS between runs (clearing the jit
cache so the gate is re-traced) so both paths see identical inputs.

Run:  python scripts/profiling/bench_pairbin_threshold.py [N ...]
"""

import sys

from harness import device_line, median_seconds

import jax
import jax.numpy as jnp
import numpy as np

from simka_tpu.ops import countjoin


def bench_n(n_banks: int, E: int = 1 << 23):
    rng = np.random.default_rng(0)
    space = E // 2
    vals = rng.integers(0, space, size=E, dtype=np.uint64)
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    sid = jnp.asarray(rng.integers(0, n_banks, size=E).astype(np.int32))

    @jax.jit
    def step(hi, lo, sid):
        return countjoin.count_join_stats(
            hi, lo, sid, jnp.int32(1), jnp.int64(10**9),
            n_banks=n_banks, hi_bits=10,
        )

    dt = median_seconds(step, hi, lo, sid)
    js = step(hi, lo, sid)
    check = (int(js.nb_distinct), np.asarray(js.bray_numerator).tobytes())
    return E / dt, check


if __name__ == "__main__":
    dev = device_line()
    ns = [int(a) for a in sys.argv[1:]] or [20, 24, 32]
    for n in ns:
        results = {}
        for thresh in (32, 16):
            countjoin.PAIRBIN_MAX_BANKS = thresh
            countjoin.count_join_stats.clear_cache()
            path = "pair-bin" if n <= thresh else "4-pass loop"
            rate, check = bench_n(n)
            results[path] = (rate, check)
            print(
                f"N={n:3d}  thresh={thresh:3d} ({path:11s})  "
                f"{rate / 1e6:.3f} M kmers/s | {dev}",
                flush=True,
            )
        if len({c for _, c in results.values()}) != 1:
            print(f"N={n}: CHECK MISMATCH between the paths", flush=True)
