"""Canonical k-mer extraction as a fused XLA program.

Replaces gatb-core's ``Kmer<span>::ModelCanonical`` per-sequence
iterators (used by the reference at src/minikc/MiniKC.hpp:150-233 and
via DSK) with a vectorized formulation: every window position of every
read is computed in parallel on the VPU.

K-mers are (hi, lo) uint32 pairs holding the 2k-bit value (k <= 31), so
no 64-bit integer support is needed anywhere on the hot path. The
canonical form is min(forward, revcomp) compared lexicographically on
(hi, lo) -- same equivalence classes as the reference regardless of the
base-encoding convention.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

SENTINEL = jnp.uint32(0xFFFFFFFF)


def n_words_for_k(k: int) -> int:
    """uint32 words needed for a 2k-bit canonical k-mer value."""
    return max(1, -(-2 * k // 32))


@functools.partial(jax.jit, static_argnames=("k", "comp_xor"))
def extract_canonical_kmers_multi(codes, k: int, comp_xor: int = 3):
    """Canonical k-mers as a big-endian tuple of uint32 words.

    Supports any k with 2k bits across ``n_words_for_k(k)`` words
    (k <= 63 covers the reference's compiled spans, CMakeLists.txt:66).
    Returns (words, valid) where words[0] is the most significant.
    Invalid positions hold all-ones in every word (> any real k-mer,
    since the top word has < 32 payload bits... except when 2k is an
    exact multiple of 32, where we still reserve the sentinel by
    construction: k in {16, 32, 48} uses one extra leading word).
    """
    B, L = codes.shape
    if L < k:
        raise ValueError(f"read window {L} shorter than k={k}")
    W = L - k + 1
    nw = n_words_for_k(k)
    if 2 * k == 32 * nw:
        nw += 1  # keep headroom so the sentinel is unambiguous

    invalid = (codes >= 4).astype(jnp.int32)
    c32 = codes.astype(jnp.uint32)

    # Horner over window offsets as a fori_loop: keeps the compiled
    # graph small and compile times stable (an unrolled version
    # compiles for minutes)
    def horner(i, state):
        fwd, rc = state
        b_f = jax.lax.dynamic_slice_in_dim(c32, i, W, axis=1) & 3
        b_r = (
            jax.lax.dynamic_slice_in_dim(c32, k - 1 - i, W, axis=1) & 3
        ) ^ comp_xor
        fwd = [
            (fwd[w] << 2) | (fwd[w + 1] >> 30) for w in range(nw - 1)
        ] + [(fwd[nw - 1] << 2) | b_f]
        rc = [(rc[w] << 2) | (rc[w + 1] >> 30) for w in range(nw - 1)] + [
            (rc[nw - 1] << 2) | b_r
        ]
        return fwd, rc

    init = (
        [jnp.zeros((B, W), jnp.uint32) for _ in range(nw)],
        [jnp.zeros((B, W), jnp.uint32) for _ in range(nw)],
    )
    fwd, rc = jax.lax.fori_loop(0, k, horner, init)

    # lexicographic min(forward, revcomp)
    take_fwd = jnp.zeros((B, W), jnp.bool_)
    undecided = jnp.ones((B, W), jnp.bool_)
    for w in range(nw):
        take_fwd = take_fwd | (undecided & (fwd[w] < rc[w]))
        undecided = undecided & (fwd[w] == rc[w])
    take_fwd = take_fwd | undecided  # equal -> forward
    words = [jnp.where(take_fwd, fwd[w], rc[w]) for w in range(nw)]

    cum = jnp.cumsum(invalid, axis=1)
    cum = jnp.pad(cum, ((0, 0), (1, 0)))
    bad_in_window = (
        jax.lax.dynamic_slice_in_dim(cum, k, W, axis=1)
        - jax.lax.dynamic_slice_in_dim(cum, 0, W, axis=1)
    ) > 0
    valid = ~bad_in_window
    words = tuple(jnp.where(valid, w, SENTINEL) for w in words)
    return words, valid


@functools.partial(jax.jit, static_argnames=("k", "comp_xor"))
def extract_canonical_kmers(codes, k: int, comp_xor: int = 3):
    """Extract all canonical k-mers from a batch of encoded reads.

    Args:
      codes: uint8 [B, L] base codes (0..3; INVALID_CODE=255 for
        non-ACGT and padding).
      k: k-mer size (1..31), static.
      comp_xor: XOR mask realizing base complement in the chosen
        encoding: 3 for A=0,C=1,G=2,T=3 (ours); 2 for gatb-core's
        A=0,C=1,T=2,G=3 (needed when k-mer VALUES must match gatb,
        e.g. SimkaMin murmur hashing).

    Returns:
      (hi, lo, valid): uint32 [B, W], uint32 [B, W], bool [B, W] with
      W = L - k + 1. Windows touching any invalid base are invalid.
      Invalid positions have hi = lo = SENTINEL so that a (hi, lo)
      ascending sort pushes them past every real k-mer (real k-mers
      have hi < 2**30 for k <= 31).
    """
    B, L = codes.shape
    if L < k:
        raise ValueError(f"read window {L} shorter than k={k}")
    W = L - k + 1

    invalid = (codes >= 4).astype(jnp.int32)
    # windows[i] = codes[:, i : i + W]
    c32 = codes.astype(jnp.uint32)

    # Horner over the k window offsets, fully vectorized over [B, W].
    # forward value = sum_i base[i] * 4^(k-1-i); revcomp value
    # = sum_i (comp(base[i])) * 4^i -- the same Horner walked backwards.
    # fori_loop (not unrolled) to keep compile size/time bounded.
    def horner(i, state):
        fwd_hi, fwd_lo, rc_hi, rc_lo = state
        b_f = jax.lax.dynamic_slice_in_dim(c32, i, W, axis=1) & 3
        b_r = (
            jax.lax.dynamic_slice_in_dim(c32, k - 1 - i, W, axis=1) & 3
        ) ^ comp_xor
        return (
            (fwd_hi << 2) | (fwd_lo >> 30),
            (fwd_lo << 2) | b_f,
            (rc_hi << 2) | (rc_lo >> 30),
            (rc_lo << 2) | b_r,
        )

    zeros = jnp.zeros((B, W), jnp.uint32)
    fwd_hi, fwd_lo, rc_hi, rc_lo = jax.lax.fori_loop(
        0, k, horner, (zeros, zeros, zeros, zeros)
    )

    take_fwd = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo <= rc_lo))
    hi = jnp.where(take_fwd, fwd_hi, rc_hi)
    lo = jnp.where(take_fwd, fwd_lo, rc_lo)

    # validity: no invalid base among the k window bases. Prefix sums
    # give the per-window invalid count in O(L).
    cum = jnp.cumsum(invalid, axis=1)
    cum = jnp.pad(cum, ((0, 0), (1, 0)))
    bad_in_window = (
        jax.lax.dynamic_slice_in_dim(cum, k, W, axis=1)
        - jax.lax.dynamic_slice_in_dim(cum, 0, W, axis=1)
    ) > 0
    valid = ~bad_in_window

    hi = jnp.where(valid, hi, SENTINEL)
    lo = jnp.where(valid, lo, SENTINEL)
    return hi, lo, valid


def pack_codes_host(codes):
    """Host-side 2-bit packing of a [B, W] uint8 code batch (W % 8 == 0).

    Packing sends 0.25 B/base plus a 1-bit/base validity bitmap
    instead of 1 byte/base (SURVEY.md §7.2's packed-transfer design;
    the reference's gatb Bank keeps reads 2-bit packed on disk for the
    same reason).
    """
    import numpy as np

    valid = codes != 255
    c = np.where(valid, codes, 0).astype(np.uint8)
    packed = (
        c[:, 0::4]
        | (c[:, 1::4] << 2)
        | (c[:, 2::4] << 4)
        | (c[:, 3::4] << 6)
    )
    validbits = np.packbits(valid, axis=1, bitorder="little")
    return packed, validbits


@functools.partial(jax.jit, static_argnames=("k", "comp_xor", "multi"))
def extract_packed(packed, validbits, k: int, comp_xor: int = 3,
                   multi: bool = False):
    """Device-side unpack of pack_codes_host output + k-mer extraction.

    Returns the words tuple (2 words for the fast path, n_words_for_k
    for multi=True) with SENTINEL at invalid windows. One fused XLA
    program: the unpacked codes never round-trip to the host.
    """
    B, Wq = packed.shape
    W = Wq * 4
    j = jnp.arange(W, dtype=jnp.int32)
    rep = jnp.repeat(packed, 4, axis=1)
    codes = (rep >> ((j % 4) * 2).astype(jnp.uint8)) & 3
    rep8 = jnp.repeat(validbits, 8, axis=1)
    bit = (rep8 >> (j % 8).astype(jnp.uint8)) & 1
    codes = jnp.where(bit == 1, codes, jnp.uint8(255))
    if multi:
        words, _ = extract_canonical_kmers_multi(codes, k, comp_xor)
        return words
    hi, lo, _ = extract_canonical_kmers(codes, k, comp_xor)
    return (hi, lo)


def kmer_shannon_index(hi, lo, k: int):
    """Per-k-mer Shannon index over the 4 base frequencies (k <= 31).

    Mirrors SimkaCountProcessorSimple::getShannonIndex
    (src/core/SimkaAlgorithm.hpp:634-658). Inert in the reference's
    live path (the call site is commented out) but exposed for the
    -kmer-shannon-index option.
    """
    return kmer_shannon_index_words((hi, lo), k)


def kmer_shannon_index_words(words, k: int):
    """Shannon index from a big-endian uint32 word tuple (any k).

    ``words[0]`` is the most significant word; base i (0 = the LAST
    base appended by the Horner loop) occupies bits [2i, 2i+2) counted
    from the least significant end of the concatenated value.
    """
    words = tuple(w.astype(jnp.uint32) for w in words)
    nw = len(words)
    counts = [jnp.zeros(words[0].shape, jnp.float32) for _ in range(4)]
    for i in range(k):
        bits = 2 * i
        w = nw - 1 - bits // 32
        code = (words[w] >> (bits % 32)) & 3
        for base in range(4):
            counts[base] = counts[base] + (code == base).astype(
                jnp.float32
            )
    freqs = jnp.stack(counts, axis=-1) / jnp.float32(k)
    logf = jnp.where(freqs > 0, jnp.log(freqs) / jnp.log(2.0), 0.0)
    return jnp.abs(jnp.sum(freqs * logf, axis=-1))


def mix_hash(hi, lo):
    """Cheap 32-bit mix of a (hi, lo) k-mer for shard routing.

    Plays the role of the reference's minimizer->partition Repartitor
    (src/SimkaPotara.hpp:713-723): any fixed hash that all samples
    share yields mergeable shards; uniformity replaces the sampled
    balancing table.
    """
    h = (hi ^ jnp.uint32(0x9E3779B9)) * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = (h ^ lo) * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h
