"""Tune compact_rows' block height (ops/compact.COMPACT_BLOCK).

The stable block compaction's cost splits between the batched 1-bit
block sorts (deeper for bigger blocks) and the sequential
dynamic_update_slice loop (more iterations for smaller blocks). This
times the payload shape of the packed-key join -- (u64 key, i32
count), ~50% kept -- across block heights in one process.

Run:  python scripts/profiling/bench_compact.py [logE]
"""

import sys

from harness import device_line, median_seconds

import jax
import jax.numpy as jnp
import numpy as np

from simka_tpu.ops.compact import compact_rows

LOG_E = int(sys.argv[1]) if len(sys.argv) > 1 else 24
E = 1 << LOG_E

rng = np.random.default_rng(0)
key = jnp.asarray(rng.integers(0, 1 << 45, size=E, dtype=np.uint64))
cnt = jnp.asarray(rng.integers(1, 30, size=E, dtype=np.int32))
kept = jnp.asarray(rng.random(E) < 0.5)
dev = device_line()

for block in (1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18):
    run = jax.jit(
        lambda key, cnt, kept, block=block: compact_rows(
            (key, cnt), kept,
            fills=(jnp.uint64(0xFFFFFFFFFFFFFFFF), 0),
            block=block,
        )
    )
    dt = median_seconds(run, key, cnt, kept)
    print(f"E=2^{LOG_E} block={block:7d}  {dt * 1e3:.3f} ms | {dev}",
          flush=True)
