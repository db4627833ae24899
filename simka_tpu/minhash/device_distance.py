"""Batched sketch-intersection distances on device.

The host path (minhash/distance.py) walks one pair at a time; this
module evaluates BATCHES of pairs with vmapped sorted-array ops --
the N x N sketch-distance matrix becomes a few device dispatches.

Semantics are identical to the reference walk
(SimkaMinDistance.hpp:215-258) via the union-rank formulation: the
walk processes exactly the union elements of rank <= processed where
processed = min(min(s1, s2), rank(t_exh)) and t_exh = min(maxA, maxB)
(the walk can only break while consuming the exhausted stream's last
element). For every element its union rank is

    rank(a_i) = (#A <= a_i) + (#B <= a_i) - (#shared <= a_i)

computable with searchsorted + prefix sums -- no merged array needed.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _bitonic_merge(h, inv, tag, c):
    """Merge the concatenation of two lexicographically ASCENDING
    halves by (h, inv, tag), carrying ``c``.

    Both sketches arrive sorted (bottom-s prefixes are built
    ascending; padding sorts after via inv), so a full lax.sort pays
    log^2 compare stages where a MERGE needs log: reverse the second
    half (bitonic sequence), then log2(L) fixed-stride
    compare-exchange stages, each a reshape + elementwise min/max
    select -- no sort, no gathers.
    """
    L = h.shape[0]
    s = L // 2
    # Row width of the [L/W, W] view: stages with stride >= W are
    # elementwise over whole rows; the last log2(W) stages run as one
    # batched small sort. Set on the system's earlier accelerator
    # (its vector lane width); not yet measured on the GPU
    # (ROADMAP.md, speed item 7).
    W = 128
    arrs = [h, inv, tag, c]
    arrs = [
        jnp.concatenate([a[:s], jnp.flip(a[s:])]) for a in arrs
    ]
    d = s
    # row-level stages: partners live in different W-wide rows of the
    # [L/W, W] view, so every compare-exchange is a pure elementwise
    # min/max over whole rows
    while d >= W and L // (2 * d) >= 1:
        shaped = [a.reshape(L // (2 * d), 2, d // W, W) for a in arrs]
        a0 = [x[:, 0] for x in shaped]
        b0 = [x[:, 1] for x in shaped]
        gt = (
            (a0[0] > b0[0])
            | ((a0[0] == b0[0]) & (a0[1] > b0[1]))
            | (
                (a0[0] == b0[0])
                & (a0[1] == b0[1])
                & (a0[2] > b0[2])
            )
        )
        arrs = [
            jnp.stack(
                [jnp.where(gt, y, x), jnp.where(gt, x, y)], axis=1
            ).reshape(L)
            for x, y in zip(a0, b0)
        ]
        d //= 2
    if d >= 1:
        # every 2d-block (= W wide after the loop) is now bitonic; one
        # batched small sort finishes the lane-level stages
        blocks = [a.reshape(L // (2 * d), 2 * d) for a in arrs]
        sorted_ = jax.lax.sort(tuple(blocks), num_keys=3)
        arrs = [b.reshape(L) for b in sorted_]
    return tuple(arrs)


def _pair_kernel(hA, cA, lA, hB, cB, lB):
    """One pair: padded ascending u64 hashes, counts, valid lengths.
    Returns (jaccard, braycurtis) float32.

    MERGE formulation: both sketches are already ascending, so a
    bitonic merge (log stages of elementwise compare-exchange)
    replaces the earlier full lax.sort; every quantity of the
    reference walk (SimkaMinDistance.hpp:215-258) is then a
    boundary/cumsum scan (no data-dependent binary searches).

    Union-rank semantics: the walk processes exactly the union
    elements of rank <= processed, processed = min(min(lA, lB),
    rank(t_exh)) with t_exh the exhausted stream's last element.
    After the merge, an element's union rank is the inclusive cumsum
    of distinct-boundaries at its row. Validity rides as a compare
    key (not a sentinel), so a genuine all-ones hash stays exact.
    """
    s = hA.shape[0]
    idx = jnp.arange(s)
    invA = (idx >= lA).astype(jnp.uint32)
    invB = (idx >= lB).astype(jnp.uint32)

    h = jnp.concatenate([hA, hB])
    inv = jnp.concatenate([invA, invB])
    tag = jnp.concatenate(
        [jnp.zeros(s, jnp.uint32), jnp.ones(s, jnp.uint32)]
    )
    c = jnp.concatenate([cA, cB])
    h, inv, tag, c = _bitonic_merge(h, inv, tag, c)

    valid = inv == 0
    prev_same = jnp.concatenate(
        [jnp.array([False]), h[1:] == h[:-1]]
    ) & jnp.concatenate([jnp.array([False]), valid[:-1]])
    boundary = valid & ~prev_same
    # a shared element = a valid boundary row whose next row is the
    # same hash from the other sketch (hashes are distinct within one
    # sketch, so an equal-hash neighbor always has the other tag)
    next_same = jnp.concatenate([h[1:] == h[:-1], jnp.array([False])])
    next_valid = jnp.concatenate([valid[1:], jnp.array([False])])
    shared = boundary & next_same & next_valid

    rowrank = jnp.cumsum(boundary.astype(jnp.int32))
    L = jnp.minimum(lA, lB)
    lastA = hA[jnp.clip(lA - 1, 0, s - 1)]
    lastB = hB[jnp.clip(lB - 1, 0, s - 1)]
    t_exh = jnp.minimum(lastA, lastB)
    rank_exh = jnp.sum((boundary & (h <= t_exh)).astype(jnp.int32))
    processed = jnp.minimum(L, rank_exh)

    include = valid & (rowrank <= processed)
    sh_in = shared & (rowrank <= processed)
    distinct = processed
    shared_distinct = jnp.sum(sh_in.astype(jnp.int64))
    nb_kmers = jnp.sum(
        jnp.where(include, c.astype(jnp.int64), 0)
    )
    next_c = jnp.concatenate([c[1:], jnp.zeros(1, c.dtype)])
    shared_kmers = jnp.sum(
        jnp.where(
            sh_in, jnp.minimum(c, next_c).astype(jnp.int64), 0
        )
    )

    jaccard = jnp.where(
        distinct == 0,
        1.0,
        1.0 - shared_distinct.astype(jnp.float64) / jnp.maximum(distinct, 1),
    )
    braycurtis = jnp.where(
        nb_kmers == 0,
        1.0,
        1.0
        - (2.0 * shared_kmers.astype(jnp.float64))
        / jnp.maximum(nb_kmers, 1),
    )
    empty = (lA == 0) | (lB == 0)
    jaccard = jnp.where(empty, 1.0, jaccard)
    braycurtis = jnp.where(empty, 1.0, braycurtis)
    return jaccard.astype(jnp.float32), braycurtis.astype(jnp.float32)


@jax.jit
def _pair_batch_gather(H1, C1, L1, H2, C2, L2, ii, jj):
    """Gather the pair rows ON DEVICE and run the vmapped kernel: the
    [N, s] sketch matrices ship once instead of [pair_batch, s] slices
    per batch."""
    take = lambda M, idx: jnp.take(M, idx, axis=0)
    return jax.vmap(_pair_kernel)(
        take(H1, ii),
        take(C1, ii),
        jnp.take(L1, ii),
        take(H2, jj),
        take(C2, jj),
        jnp.take(L2, jj),
    )


@jax.jit
def _pair_all_batches(H1, C1, L1, H2, C2, L2, II, JJ):
    """EVERY pair batch in one program: lax.scan over [nb, pb] pair
    index chunks, each chunk a vmapped sort-merge kernel.

    One dispatch + one [nb, pb] fetch replaces nb separate dispatches;
    device memory stays bounded because XLA reuses the chunk buffers
    across scan steps."""

    def step(_, idx):
        ii, jj = idx
        return None, _pair_batch_gather(
            H1, C1, L1, H2, C2, L2, ii, jj
        )

    _, (jac, bc) = jax.lax.scan(step, None, (II, JJ))
    return jac, bc


def pad_sketches(
    sketches: List[Tuple[np.ndarray, np.ndarray]], s: int
):
    """Left-align trimmed sketches into [N, s] arrays padded with
    UINT64_MAX hashes (greater than any real hash)."""
    n = len(sketches)
    H = np.full((n, s), UINT64_MAX, np.uint64)
    C = np.zeros((n, s), np.int32)
    L = np.zeros(n, np.int32)
    for i, (h, c) in enumerate(sketches):
        m = min(len(h), s)
        H[i, :m] = h[:m]
        C[i, :m] = c[:m]
        L[i] = m
    return H, C, L


def compute_distance_block_device(
    sketches1,
    sketches2,
    symmetric_diag_block: bool,
    pair_batch: int = 0,
):
    """Drop-in device replacement for
    minhash.distance.compute_distance_block."""
    s = max(
        [len(h) for h, _ in sketches1]
        + [len(h) for h, _ in sketches2]
        + [1]
    )
    s = 1 << (s - 1).bit_length()  # stable compile shape classes
    H1, C1, L1 = pad_sketches(sketches1, s)
    H2, C2, L2 = pad_sketches(sketches2, s)

    import jax as _jax

    same = sketches2 is sketches1
    d1 = (
        _jax.device_put(H1),
        _jax.device_put(C1),
        _jax.device_put(L1),
    )
    d2 = d1 if same else (
        _jax.device_put(H2),
        _jax.device_put(C2),
        _jax.device_put(L2),
    )
    return distance_from_device_arrays(
        d1, d2, symmetric_diag_block, pair_batch
    )


def distance_from_device_arrays(
    d1, d2, symmetric_diag_block: bool, pair_batch: int = 0
):
    """All-pairs sketch distances from DEVICE-RESIDENT [N, s] padded
    arrays (H u64, C i32, L i32) -- the fast path of run_simka_min:
    device-built grids never travel to the host and back."""
    H1, _, _ = d1
    n1, s = H1.shape
    n2 = d2[0].shape[0]
    if not pair_batch:
        # bound per-batch intermediates (~10 arrays of
        # [pair_batch, s]) to a few hundred MB of HBM
        pair_batch = max(8, min(256, (1 << 23) // s))

    pairs = []
    for i in range(n1):
        j0 = i + 1 if symmetric_diag_block else 0
        for j in range(j0, n2):
            pairs.append((i, j))
    jac = np.zeros((n1, n2), np.float32)
    bc = np.zeros((n1, n2), np.float32)
    if not pairs:
        return jac, bc
    # ONE device program for every batch (scan over chunk rows) and
    # one fetch; tail-padded with pair 0 to a stable [nb, pb] shape
    n_real = len(pairs)
    nb = -(-n_real // pair_batch)
    ii = np.zeros(nb * pair_batch, np.int32)
    jj = np.zeros(nb * pair_batch, np.int32)
    ii[:n_real] = [p[0] for p in pairs]
    jj[:n_real] = [p[1] for p in pairs]
    ii[n_real:] = pairs[0][0]
    jj[n_real:] = pairs[0][1]
    jv, bv = _pair_all_batches(
        *d1, *d2,
        jnp.asarray(ii.reshape(nb, pair_batch)),
        jnp.asarray(jj.reshape(nb, pair_batch)),
    )
    jv = np.asarray(jv).ravel()[:n_real]
    bv = np.asarray(bv).ravel()[:n_real]
    ir, jr = ii[:n_real], jj[:n_real]
    jac[ir, jr] = jv
    bc[ir, jr] = bv
    if symmetric_diag_block:
        jac[jr, ir] = jv
        bc[jr, ir] = bv
    return jac, bc
