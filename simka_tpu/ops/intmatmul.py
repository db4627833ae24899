"""Exact integer Gram matrices via limb decomposition.

The distance sufficient statistics need exact integer products
(C^T @ P, P^T @ P, C^T @ C) where C holds k-mer counts and P presence
masks. A float32 matmul loses exactness once a partial sum passes
2^24, and at default precision the GPU may round its operands to TF32
(10 explicit mantissa bits, 11 significant). Fix: split the integer
operand into limbs of at most 8 bits, compute one f32 matmul per limb
pair -- each exact by construction -- and recombine in int64.

Invariant: every operand of these matmuls is an integer <= 255 (or a
0/1 one-hot), which any operand format with >= 8 significant bits
(TF32, bf16, f32) holds exactly, and every panel sum stays < 2^24,
which the f32 accumulator holds exactly.

To keep per-matmul partial sums below 2^24 for arbitrarily tall
operands, rows are processed as a batch of BLOCK_ROWS-row panels via a
single batched einsum ('bri,brj->bij'); the b-axis reduction happens
in int64 afterwards. One XLA op per limb pair, no sequential loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BLOCK_ROWS = 8192  # panel height; 24 - log2(8192) = 11 bits of budget

# Rows per chunk of the panelled reductions. XLA materializes a
# matmul's operands on the GPU, so the one-hot and limb temporaries
# cost hundreds of bytes per row; reducing chunk by chunk keeps them
# to one chunk at a time instead of the whole stream.
CHUNK_ROWS = 1 << 21


def chunked_sum(fn, arrays, fills, init):
    """``init`` + the sum of ``fn(*chunk)`` over row chunks.

    ``arrays``: tuple of equal-length [E] arrays, padded with
    ``fills`` (values that contribute nothing) to whole chunks of
    CHUNK_ROWS rows (one chunk when E is smaller). ``fn`` maps one
    chunk's arrays to a pytree shaped like ``init``. Chunk 0 seeds
    the loop carry, so a carry that varies over shard_map axes gets
    that type from the data.
    """
    E = arrays[0].shape[0]
    ch = min(CHUNK_ROWS, E)
    n = -(-E // ch)
    pad = n * ch - E
    if pad:
        arrays = tuple(
            jnp.pad(a, (0, pad), constant_values=f)
            for a, f in zip(arrays, fills)
        )

    def chunk_terms(i):
        return fn(*(jax.lax.dynamic_slice_in_dim(a, i * ch, ch)
                    for a in arrays))

    acc = jax.tree.map(jnp.add, init, chunk_terms(0))
    if n > 1:
        acc = jax.lax.fori_loop(
            1, n,
            lambda i, acc: jax.tree.map(jnp.add, acc, chunk_terms(i)),
            acc,
        )
    return acc


def binned_sum(values, bins, n_bins: int, bits: int = 33):
    """Exact per-bin sums of non-negative int64 values, scatter-free.

    Equivalent to segment_sum(values, bins, n_bins) but computed as
    limb-split one-hot matmuls. Whether a plain integer segment_sum
    is faster on the GPU is not yet measured (ROADMAP.md, design
    item 4).

    Args:
      values: [R] int64, values < 2**bits.
      bins: [R] int32 in [0, n_bins); out-of-range bins are DROPPED
        (callers pass n_bins for masked rows, mirroring segment_sum
        with num_segments=n_bins).
    """
    def chunk_sum(values, bins):
        R = values.shape[0]
        nb = -(-R // BLOCK_ROWS)
        pad = nb * BLOCK_ROWS - R
        if pad:
            values = jnp.pad(values, (0, pad))
            bins = jnp.pad(bins, (0, pad), constant_values=n_bins)
        v3 = values.reshape(nb, BLOCK_ROWS)
        onehot = (
            bins.reshape(nb, BLOCK_ROWS)[..., None]
            == jnp.arange(n_bins, dtype=jnp.int32)[None, None, :]
        ).astype(jnp.float32)

        # 8-bit limbs: limb values <= 255 survive the default-precision
        # operand rounding (TF32 on the GPU) exactly; panel sums
        # <= 255 * BLOCK_ROWS < 2^21 stay exact in the f32 accumulator
        la = 8
        n_l = -(-bits // la)
        out = jnp.zeros((n_bins,), jnp.int64)
        for i in range(n_l):
            limb = ((v3 >> (la * i)) & ((1 << la) - 1)).astype(jnp.float32)
            part = jnp.einsum(
                "br,brn->bn", limb, onehot,
                preferred_element_type=jnp.float32,
            )
            out = out + (part.astype(jnp.int64).sum(axis=0) << (la * i))
        return out

    return chunked_sum(
        chunk_sum, (values, bins), (0, n_bins),
        jnp.zeros((n_bins,), jnp.int64),
    )


def _split_limbs(x, limb_bits: int, n_limbs: int):
    x = x.astype(jnp.int64)
    mask = (1 << limb_bits) - 1
    return [
        ((x >> (limb_bits * i)) & mask).astype(jnp.float32)
        for i in range(n_limbs)
    ]


def exact_int_matmul(a, b, a_bits: int = 32, b_bits: int = 1):
    """Exact a.T @ b for non-negative integer arrays of any height.

    Args:
      a: [R, N] integer array, values < 2**a_bits.
      b: [R, M] integer array, values < 2**b_bits.

    Returns [N, M] int64, exact. Requires a_bits + b_bits limbs to fit
    the panel budget: la + lb <= 24 - log2(BLOCK_ROWS) = 11.
    """
    R, N = a.shape
    M = b.shape[1]
    nb = -(-R // BLOCK_ROWS)
    pad = nb * BLOCK_ROWS - R
    if pad:
        a = jnp.pad(a, ((0, pad), (0, 0)))
        b = jnp.pad(b, ((0, pad), (0, 0)))
    a3 = a.reshape(nb, BLOCK_ROWS, N)
    b3 = b.reshape(nb, BLOCK_ROWS, M)

    # la + lb <= 11 keeps panel sums < 2^24 (f32-exact); each limb
    # <= 8 bits so values survive TF32 operand rounding exactly
    budget = 11
    if b_bits == 1:
        la, lb = min(budget - 1, 8), 1
    else:
        la = min(budget // 2, 8)
        lb = min(budget - la, 8)
    n_a = -(-a_bits // la)
    n_b = -(-b_bits // lb)

    out = jnp.zeros((N, M), jnp.int64)
    for i in range(n_a):
        al = ((a3.astype(jnp.int64) >> (la * i)) & ((1 << la) - 1)).astype(
            jnp.float32
        )
        for j in range(n_b):
            bl = (
                (b3.astype(jnp.int64) >> (lb * j)) & ((1 << lb) - 1)
            ).astype(jnp.float32)
            part = jnp.einsum(
                "bri,brj->bij",
                al,
                bl,
                preferred_element_type=jnp.float32,
            )
            out = out + (
                part.astype(jnp.int64).sum(axis=0) << (la * i + lb * j)
            )
    return out
