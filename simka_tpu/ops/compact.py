"""Stable row compaction without a global re-sort.

The join's pass 2 (ops/countjoin.py) only needs to make the surviving
(kmer, sample, count) rows CONTIGUOUS while preserving the pass-1
(kmer, sample) order -- dropping rows never reorders them.  That is a
stable compaction, not a sort, so a full-width 3-key ``lax.sort``
is overkill.  It corresponds to the reference's behaviour of simply
never *writing* abundance-filtered k-mers to the partition files
(SimkaCompressedProcessor::process, src/minikc/MiniKC.hpp:56) rather
than re-sorting them away.

Scheme (no gathers, no scatters):

  1. batched stable ``lax.sort`` of BLOCK-sized row groups on the
     1-bit drop key: the sort depth is log^2(BLOCK) instead of
     log^2(E) and there is a single 8-bit key instead of three u32
     keys;
  2. inter-block gaps are closed by a sequential ``fori_loop`` of
     in-place ``dynamic_update_slice`` writes at each block's global
     rank offset.  Writes are ordered, so a block's fill-masked tail
     is overwritten by the next block's head; the final tail keeps the
     fill value from the pre-initialized output.

Everything is a contiguous read/write.  On a GPU the same gap-close
could be one cumsum plus one scatter; which is faster there is not
yet measured (ROADMAP.md, speed item 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Block height for the local stable sorts.  Large enough that the
# dynamic_update_slice loop has few iterations (E/BLOCK), small enough
# that the batched block sort stays shallow.  The value was tuned on
# the system's earlier accelerator and is not yet measured on the GPU
# (scripts/profiling/bench_compact.py; ROADMAP.md, speed item 3).
COMPACT_BLOCK = 32768


def compact_rows(
    arrays, kept, fills, block: int = COMPACT_BLOCK, vary_axes: tuple = ()
):
    """Stably move rows with ``kept`` to the front; fill the tail.

    Args:
      arrays: tuple of [E] arrays (the row columns).
      kept: [E] bool.
      fills: per-array fill value for the tail (and dropped rows).
      block: local-sort block height.
      vary_axes: shard_map axes the inputs vary over (the fori_loop
        init carry must be annotated to match the body's data).

    Returns:
      tuple of [E] arrays with the kept rows first (original order
      preserved), every dropped/tail position holding the fill value.
    """
    arrays = tuple(arrays)
    E = arrays[0].shape[0]
    nblocks = -(-E // block)
    pad = nblocks * block - E
    kp = jnp.pad(kept, (0, pad), constant_values=False) if pad else kept
    cols = tuple(
        jnp.pad(a, (0, pad), constant_values=f) if pad else a
        for a, f in zip(arrays, fills)
    )

    # 1. block-local stable compaction (sort on the 1-bit drop key)
    key = jnp.where(kp, 0, 1).astype(jnp.uint8).reshape(nblocks, block)
    sorted_ = jax.lax.sort(
        (key, *[c.reshape(nblocks, block) for c in cols]),
        num_keys=1,
        is_stable=True,
    )
    counts = jnp.sum(
        (sorted_[0] == 0).astype(jnp.int32), axis=1
    )
    offs = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts).astype(jnp.int32)]
    )

    # fill the dropped tail of every block so ordered overwrites leave
    # fill values after the last kept row
    lidx = jnp.arange(block, dtype=jnp.int32)[None, :]
    tail = lidx >= counts[:, None]
    vals = tuple(
        jnp.where(tail, jnp.asarray(f, v.dtype), v)
        for v, f in zip(sorted_[1:], fills)
    )

    # 2. close the gaps: ordered in-place block writes at the global
    # rank offsets (later blocks overwrite earlier blocks' fill tails)
    outs = tuple(
        jnp.full((nblocks * block,), f, dtype=a.dtype)
        for a, f in zip(arrays, fills)
    )
    if vary_axes:
        outs = tuple(
            jax.lax.pcast(o, vary_axes, to="varying") for o in outs
        )

    def body(b, outs):
        off = offs[b]
        return tuple(
            jax.lax.dynamic_update_slice(o, v[b], (off,))
            for o, v in zip(outs, vals)
        )

    outs = jax.lax.fori_loop(0, nblocks, body, outs)
    return tuple(o[:E] for o in outs)
