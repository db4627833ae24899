"""Device memory of the fused count/join program, per channel set.

Compiles count_join_stats (no run) at E = 2^logE instance rows and
prints XLA's memory analysis per row: what core/budget's
JOIN_WORKING_SET_FACTOR must cover (the factor multiplies the 12-byte
instance row of k <= 31).

Run:  python scripts/profiling/join_memory.py [logE ...]
"""

import functools
import sys

from harness import device_line

import jax
import jax.numpy as jnp

from simka_tpu.core.budget import JOIN_WORKING_SET_FACTOR
from simka_tpu.ops.countjoin import count_join_stats

N = 8
dev = device_line()
for log_e in [int(a) for a in sys.argv[1:]] or [24, 28]:
    E = 1 << log_e
    u32 = jax.ShapeDtypeStruct((E,), jnp.uint32)
    i32 = jax.ShapeDtypeStruct((E,), jnp.int32)
    for simple, complex_ in ((False, False), (True, True)):
        for hi_bits in (10, 32):
            f = jax.jit(functools.partial(
                count_join_stats, n_banks=N, simple=simple,
                complex_=complex_, hi_bits=hi_bits))
            m = f.lower(u32, u32, i32, jnp.int32(2),
                        jnp.int64(10**9)).compile().memory_analysis()
            per_row = (m.temp_size_in_bytes + m.argument_size_in_bytes) / E
            print(f"E=2^{log_e} simple={simple} complex={complex_} "
                  f"hi_bits={hi_bits}: {per_row:.3f} B/row "
                  f"(temp {m.temp_size_in_bytes} B), "
                  f"{per_row / 12:.3f} x the 12 B row; plan factor "
                  f"{JOIN_WORKING_SET_FACTOR} | {dev}", flush=True)
