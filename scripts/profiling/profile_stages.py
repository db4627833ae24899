"""Stage-level profile of the fused count+join program (generic
3-key sort path, E=2^24, N=8): sort, run-length counts, compaction and
the pair stage, each as its own jitted program.

Run:  python scripts/profiling/profile_stages.py
"""

import functools

from harness import device_line, median_seconds

import jax
import jax.numpy as jnp
import numpy as np

from simka_tpu.ops.compact import compact_rows
from simka_tpu.ops.kmers import SENTINEL
from simka_tpu.ops import countjoin

n_banks = 8
E = 1 << 24
rng = np.random.default_rng(0)
space = E // 2
vals = rng.integers(0, space, size=E, dtype=np.uint64)
hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
sid = jnp.asarray(rng.integers(0, n_banks, size=E).astype(np.int32))


def _suffix_min(x):
    return jnp.flip(jax.lax.cummin(jnp.flip(x)))


@jax.jit
def stage_sort1(hi, lo, sid):
    return jax.lax.sort((hi, lo, sid), num_keys=3)


@jax.jit
def stage_pass1(hi, lo, sid):
    words = (hi, lo)
    nw = 2
    idx = jnp.arange(E, dtype=jnp.int32)
    sorted1 = jax.lax.sort((*words, sid), num_keys=nw + 1)
    words = sorted1[:nw]
    sid2 = sorted1[nw]
    prev_same = (sid2[1:] == sid2[:-1])
    for w in words:
        prev_same = prev_same & (w[1:] == w[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~prev_same])
    real = words[0] != SENTINEL
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)])
    next_start = _suffix_min(starts_after)
    count = next_start - idx
    kept = boundary & real & (count >= 1)
    return words, sid2, count, kept


@jax.jit
def stage_pass1_compact(hi, lo, sid):
    words = (hi, lo)
    nw = 2
    idx = jnp.arange(E, dtype=jnp.int32)
    sorted1 = jax.lax.sort((*words, sid), num_keys=nw + 1)
    words = sorted1[:nw]
    sid2 = sorted1[nw]
    prev_same = (sid2[1:] == sid2[:-1])
    for w in words:
        prev_same = prev_same & (w[1:] == w[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~prev_same])
    real = words[0] != SENTINEL
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)])
    next_start = _suffix_min(starts_after)
    count = next_start - idx
    kept = boundary & real & (count >= 1)
    return compact_rows((*words, sid2, count), kept,
                        fills=(SENTINEL, SENTINEL, 0, 0))


f = functools.partial(countjoin.count_join_stats, n_banks=n_banks)


@jax.jit
def stage_full(hi, lo, sid):
    return f(hi, lo, sid, jnp.int32(1), jnp.int64(10**9))


dev = device_line()


def timeit(fn, name):
    dt = median_seconds(fn, hi, lo, sid, iters=3)
    print(f"{name:22s} {dt * 1000:.3f} ms | {dev}")
    return dt


t_sort = timeit(stage_sort1, "sort1 only")
t_p1 = timeit(stage_pass1, "pass1 (sort+runlen)")
t_p1c = timeit(stage_pass1_compact, "pass1+compact")
t_all = timeit(stage_full, "full step")
print(f"-> compaction     {1000 * (t_p1c - t_p1):.3f} ms | {dev}")
print(f"-> pair stage     {1000 * (t_all - t_p1c):.3f} ms "
      f"(incl binned sums + seg) | {dev}")
