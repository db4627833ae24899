"""Fused k-mer counting + cross-sample join + distance statistics.

This single XLA program replaces the reference's entire L2+L3 stack
(SURVEY.md §1): per-sample DSK counting (src/SimkaCount.cpp), the gz
partition files, the k-way merge heap (src/SimkaMerge.cpp:1189-1264)
and the pair-loop accumulators
(SimkaCountProcessorSimple::updateDistance*,
src/core/SimkaAlgorithm.hpp:341-631).

Design:
  1. one global sort of (kmer_hi, kmer_lo, sample) triples groups equal
     (kmer, sample) runs -> per-sample counts by run-length;
  2. the per-sample abundance filter (reference applies it at count
     time, MiniKC.hpp:56 -- order matters!) drops rows *before* the
     cross-sample join;
  3. surviving rows are made contiguous by a stable COMPACTION (the
     pass-1 order is already (kmer, sample)-ascending and dropping
     rows preserves it; see ops/compact.py) -> the abundance-vector
     join; rows within a k-mer are in ascending sample order, so every
     co-present pair appears exactly once as (a, b) with a < b at some
     fixed offset d;
  4. pair statistics are accumulated SCATTER-FREE: for each offset
     d in 1..max_multiplicity-1, neighbor rows d apart that share a
     k-mer form pairs, and each value type is binned into the [N, N]
     upper triangle by a panelled one-hot einsum (a scatter-free
     formulation; whether an integer segment_sum is faster on the GPU
     is not yet measured -- ROADMAP.md, speed item 5).

Single-presence terms of the complex distances (the reference's
asymmetric zero-count branches, SimkaAlgorithm.hpp:488-515) are NOT
accumulated per k-mer: they collapse to closed forms over the global
per-bank totals and the co-presence sums, applied at finalization
(see SimkaStatistics.from_join_stats).

Exactness: all reference accumulators are (surprisingly) exact integer
sums -- even `_hellinger_SqrtNiNj` and `_canberra` truncate into
u_int64_t on every += (SimkaDistance.hpp:105,111), so hellinger
contributes floor(sqrt(Ni*Nj)) per k-mer and canberra degenerates to
the closed form b+c. We reproduce those semantics bit-exactly through
limb-split f32 einsums, which also makes every reduction
order-independent -> deterministic across device counts (the
reference's §4 invariance test). Only chord_NiNj and the
Kullback-Leibler pair sums are floating-point (double-float f32
einsums, ~1e-7 relative), matching the reference's own use of long
double there.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from simka_tpu.ops.compact import compact_rows
from simka_tpu.ops.intmatmul import BLOCK_ROWS, binned_sum, chunked_sum
from simka_tpu.ops.kmers import SENTINEL

LOG2 = 0.6931471805599453

# Widest N the triangle pair-bin path auto-selects for. The path
# generalizes to ceil(N(N-1)/2 / 128) one-hot blocks per shift, which
# on pass count should beat the 4-pass per-shift loop up to N = 32.
# The value 16 (the single-block regime, tri <= 128 columns) was set
# by an A/B on the system's earlier accelerator and is not yet
# measured on the GPU (scripts/profiling/bench_pairbin_threshold.py;
# ROADMAP.md, speed item 5).
PAIRBIN_MAX_BANKS = 16

# Auto threshold for the singleton-prune program split (see Prejoin):
# the prune pays a second compaction + one host sync to shrink every
# pair-pass operand, so it wins where the pair stage dominates -- the
# wide-N per-shift-loop regime -- and loses at small N, where the
# extra compaction costs more than it saves. The split turns on where
# the loop does; the value was set by an A/B on the system's earlier
# accelerator and is not yet measured on the GPU
# (scripts/profiling/bench_split_join.py; ROADMAP.md, speed item 5).
SPLIT_MIN_BANKS = 33


def use_split_join(n_banks: int):
    """Tri-state SIMKA_TPU_SPLIT_JOIN: '1' force on, '0' force off,
    unset -> auto by sample count."""
    import os

    v = os.environ.get("SIMKA_TPU_SPLIT_JOIN")
    if v == "1":
        return True
    if v == "0":
        return False
    return n_banks >= SPLIT_MIN_BANKS

class JoinStats(NamedTuple):
    """Raw sufficient statistics, all order-independent reductions.

    Fields mirror SimkaStatistics (src/core/SimkaDistance.hpp:68-139).
    Pairwise arrays hold UPPER-TRIANGLE pair sums here (plus the
    asymmetric pair of shared_kmers_* matrices); symmetrization,
    diagonal fill and the closed-form single-presence terms happen at
    finalization.
    """

    nb_distinct: jnp.ndarray  # scalar: distinct k-mers in the union
    nb_shared: jnp.ndarray  # scalar: distinct k-mers in >= 2 banks
    distinct_per_bank: jnp.ndarray  # [N] i64 (_nbSolidDistinctKmersPerBank)
    solid_per_bank: jnp.ndarray  # [N] i64 (_nbSolidKmersPerBank)
    chord_n2_per_bank: jnp.ndarray  # [N] i64 (sum of count^2)
    shared_kmers_ab: jnp.ndarray  # [N, N] i64 upper: sum C_a over pairs
    shared_kmers_ba: jnp.ndarray  # [N, N] i64 upper: sum C_b over pairs
    shared_distinct: jnp.ndarray  # [N, N] i64 upper: co-present count
    bray_numerator: jnp.ndarray  # [N, N] i64 upper: sum min(Ca, Cb)
    chord_ninj: jnp.ndarray  # [N, N] f64 upper: sum Ca*Cb (simple)
    hellinger: jnp.ndarray  # [N, N] i64 upper: sum isqrt(Ca*Cb) (simple)
    whittaker: jnp.ndarray  # [N, N] i64 upper, int32-wrap pair terms (complex)
    # Whittaker per-k-mer channels with the reference's exact int32
    # wrap, including SINGLE-presence terms (SimkaAlgorithm.hpp:481,
    # 505: abs((int)((u64)(cI*K_j) - (u64)(cJ*K_i))), one abundance 0
    # in the single branches). whittaker_all[i][j] (ordered, full) =
    # sum over ALL solid rows (k, i, c) of |int32(u64(c*K_j))|;
    # whittaker_s12 (upper) = sum over CO-PRESENT pairs of
    # |int32(u64(cI*K_j))| + |int32(u64(cJ*K_i))|. The finalizer
    # assembles W = A + A^T - (S12 + S12^T) + (w + w^T): the A terms
    # over-count shared k-mers as if they were single-presence, S12
    # removes exactly that, w restores the wrapped-difference pair
    # term -- closing PARITY divergence 3 without a warning.
    whittaker_all: jnp.ndarray  # [N, N] i64 ordered (complex)
    whittaker_s12: jnp.ndarray  # [N, N] i64 upper (complex)
    kullback_leibler: jnp.ndarray  # [N, N] f64 upper pair terms (complex)
    max_count: jnp.ndarray  # scalar i64: max per-(kmer, bank) count;
    # drives the runtime einsum limb level. pmax, not psum, under
    # sharding.


def _suffix_min(x):
    return jnp.flip(jax.lax.cummin(jnp.flip(x)))


def _panels(x, fill=0):
    """[E] -> [nb, BLOCK_ROWS] zero-padded panels."""
    E = x.shape[0]
    nb = -(-E // BLOCK_ROWS)
    pad = nb * BLOCK_ROWS - E
    if pad:
        x = jnp.pad(x, (0, pad), constant_values=fill)
    return x.reshape(nb, BLOCK_ROWS)


def _shift_padded(arrays, fills, padlen: int):
    """Append ``padlen`` fill rows to each array so a dynamic_slice at
    offset d <= padlen never reads out of bounds (shared scaffold of
    the per-shift and pair-bin accumulation passes)."""
    return tuple(
        jnp.concatenate([a, jnp.full((padlen,), f, a.dtype)])
        for a, f in zip(arrays, fills)
    )


def _shift_window(padded, d, E: int):
    """Rows d..d+E of each padded array (the partner rows at offset d)."""
    return tuple(
        jax.lax.dynamic_slice_in_dim(a, d, E) for a in padded
    )


def _pair_bin_int(
    oh_a, oh_b, values, bits: int, max_value=None, vary_axes: tuple = ()
):
    """Exact [N, N] integer pair binning via limb-split f32 einsums.

    oh_a/oh_b: [nb, B, N] f32 one-hots; values: [nb, B] int64 >= 0,
    < 2**bits. Returns [N, N] int64 with
    out[i][j] = sum over rows of value * oh_a[i] * oh_b[j].

    8-bit limbs: a float32 matmul at default precision may round its
    operands (TF32 on the GPU keeps 10 explicit mantissa bits); limb
    values <= 255 convert exactly under any operand format with at
    least 8 significant bits, and panel sums stay < 2^21, exact in
    the f32 accumulator.

    ``max_value``: optional traced i64 upper bound on ``values``.
    Limbs above the bound are skipped AT RUNTIME via lax.cond --
    typical low-coverage metagenomes have counts << 256, so the
    worst-case ``bits`` static bound would otherwise pay 4x the
    einsums (the reference never pays this: its accumulators are
    plain u64 adds, SimkaAlgorithm.hpp:369-374).
    """
    la = 8
    n_l = max(1, -(-bits // la))
    N_a = oh_a.shape[-1]
    N_b = oh_b.shape[-1]
    out = None
    for i in range(n_l):

        def term_i(i=i):
            limb = ((values >> (la * i)) & ((1 << la) - 1)).astype(
                jnp.float32
            )
            part = jnp.einsum(
                "bri,brj->bij",
                oh_a * limb[..., None],
                oh_b,
                preferred_element_type=jnp.float32,
            )
            return part.astype(jnp.int64).sum(axis=0) << (la * i)

        if i == 0 or max_value is None:
            term = term_i()
        else:

            def zeros_i():
                z = jnp.zeros((N_a, N_b), jnp.int64)
                if vary_axes:
                    # under shard_map the skipped branch must carry the
                    # same varying axes as the computed one
                    z = jax.lax.pcast(z, vary_axes, to="varying")
                return z

            term = jax.lax.cond(
                max_value >= (1 << (la * i)), term_i, zeros_i
            )
        out = term if out is None else out + term
    return out


def _abs_wrap32(prod_f64):
    """|int32 reinterpretation of (u64)(double product)| as int64.

    The reference's Whittaker accumulators cast a DOUBLE product to
    u64 and truncate to signed int32 (SimkaAlgorithm.hpp:481, 505);
    f64 mod 2^32 of the same rounded product is exact (the difference
    of two f64s agreeing in their high bits), so this matches the
    reference bit-for-bit including the double rounding itself."""
    low = jnp.mod(prod_f64, 2.0**32)
    signed = jnp.where(low >= 2.0**31, low - 2.0**32, low)
    return jnp.abs(signed).astype(jnp.int64)


def _whittaker_all_banks(sid_m, cnt_m, K, *, n_banks: int):
    """A[i][j] = sum over solid rows (k, i, c) of |int32(u64(c*K_j))|.

    The exact-wrap replacement of the old UNwrapped single-presence
    closed form (PARITY.md divergence 3): per j-block, the wrapped
    values are limb-split into 8-bit limbs and contracted against the
    bank one-hot by a float32 matmul (exact: one-hot x <=255 operands
    survive TF32 operand rounding, panel sums < 2^21 in the f32
    accumulator).

    ``sid_m``/``cnt_m``: per-row bank and count with dropped rows
    masked to the sentinel bank N / count 0. ``K``: GLOBAL per-bank
    solid totals. Runs only under complex_ (static).
    """
    N = n_banks

    def chunk_terms(sid_m, cnt_m):
        oh = (
            _panels(sid_m, fill=N)[..., None]
            == jnp.arange(N, dtype=jnp.int32)[None, None, :]
        ).astype(jnp.float32)
        cnt_p = _panels(cnt_m).astype(jnp.float64)
        blocks = []
        JB = 8  # j-block width bounds the [nb, B, JB] wrapped-value temp
        for j0 in range(0, N, JB):
            Kb = K[j0 : j0 + JB].astype(jnp.float64)
            v = _abs_wrap32(cnt_p[..., None] * Kb[None, None, :])
            blk = None
            for limb in range(4):  # values < 2^31
                lv = ((v >> (8 * limb)) & 0xFF).astype(jnp.float32)
                part = (
                    jnp.einsum(
                        "bri,brj->bij",
                        oh,
                        lv,
                        preferred_element_type=jnp.float32,
                    )
                    .astype(jnp.int64)
                    .sum(axis=0)
                    << (8 * limb)
                )
                blk = part if blk is None else blk + part
            blocks.append(blk)
        return (
            blocks[0]
            if len(blocks) == 1
            else jnp.concatenate(blocks, axis=1)
        )

    return chunked_sum(
        chunk_terms, (sid_m, cnt_m), (N, 0), jnp.zeros((N, N), jnp.int64)
    )


def _pair_bin_float(oh_a, oh_b, values_f64):
    """[N, N] f64 pair binning via double-float (hi+lo) f32 einsums.

    precision=HIGHEST forces true-f32 operands (the default may round
    them to TF32 on the GPU, which would destroy the double-float
    decomposition). Each panel sums in float32, so results differ
    from the CPU backend's in the last bits (~1e-7 relative)."""
    v_hi = values_f64.astype(jnp.float32)
    v_lo = (values_f64 - v_hi.astype(jnp.float64)).astype(jnp.float32)
    out = jnp.zeros(
        (oh_a.shape[-1], oh_b.shape[-1]), jnp.float64
    )
    for v in (v_hi, v_lo):
        part = jnp.einsum(
            "bri,brj->bij",
            oh_a * v[..., None],
            oh_b,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        out = out + part.astype(jnp.float64).sum(axis=0)
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_banks",
        "simple",
        "complex_",
        "count_bits",
        "vary_axes",
        "psum_axis",
        "hi_bits",
    ),
)
def count_join_stats(
    hi,
    lo,
    sid,
    abundance_min,
    abundance_max,
    *,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    count_bits: int = 32,
    vary_axes: tuple = (),
    psum_axis: str = "",
    hi_bits: int = 32,
) -> JoinStats:
    """Compute all distance sufficient statistics for one k-mer shard.

    Args:
      hi, lo: uint32 [E] canonical k-mer words (SENTINEL = invalid).
        For k > 31, ``hi`` may be a TUPLE of big-endian uint32 words
        and ``lo`` the final (least significant) word -- any word
        count is supported; grouping is lexicographic over the words.
      sid: int32 [E] sample index per k-mer instance.
      abundance_min/max: per-sample solidity bounds (traced scalars;
        reference filter at MiniKC.hpp:56: keep amin <= c <= amax).
      n_banks: number of samples N (static).
      count_bits: static bound on per-sample counts (drives the limb
        count of the exact integer einsums; the returned stats are
        wrong if a count exceeds 2**count_bits -- callers can check
        solid_per_bank totals or simply leave the 32-bit default).
      vary_axes/psum_axis: set when running under shard_map over
        disjoint k-mer hash shards; per-bank totals are made global
        before the pair terms consume them and every output is
        psum-reduced.
      hi_bits: static PROMISE that real (non-SENTINEL) ``hi`` values
        fit in this many bits (= max(0, 2k - 32) for k <= 31). When
        32 + hi_bits + sid bits <= 63 the whole (kmer, sid) key packs
        into one uint64, turning the 3-word sort into a 1-word sort
        and the 4-column compaction into 3.
    """
    rows = _rows_from_instances(
        hi, lo, sid, abundance_min, abundance_max,
        n_banks=n_banks, hi_bits=hi_bits, vary_axes=vary_axes,
    )
    return _stats_from_rows(
        *rows[:4],
        rows_compacted=rows[4],
        n_banks=n_banks,
        simple=simple,
        complex_=complex_,
        count_bits=count_bits,
        vary_axes=vary_axes,
        psum_axis=psum_axis,
    )


def _rows_from_instances(
    hi, lo, sid, abundance_min, abundance_max,
    *, n_banks: int, hi_bits: int, vary_axes: tuple,
):
    """Sort + run-length count + abundance-filter one instance shard.

    Returns (words, sid, count, kept, rows_compacted): one row per
    (k-mer, sample) with its count, kept=True at surviving rows.
    ``rows_compacted`` (static) promises kept rows are contiguous at
    the front in (kmer, sample)-ascending order.
    """
    words = (tuple(hi) if isinstance(hi, (tuple, list)) else (hi,)) + (
        lo,
    )
    nw = len(words)
    E = words[0].shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    sbits = max(1, (n_banks - 1).bit_length())

    if nw == 2 and 32 + hi_bits + sbits <= 63:
        # ---- packed fast path: one u64 key carries (kmer, sid) ----
        key = (
            (
                (words[0].astype(jnp.uint64) << 32)
                | words[1].astype(jnp.uint64)
            )
            << sbits
        ) | sid.astype(jnp.uint64)
        key = jax.lax.sort((key,), num_keys=1)[0]
        boundary = jnp.concatenate(
            [jnp.array([True]), key[1:] != key[:-1]]
        )
        # SENTINEL rows pack to >= 2**64 - 2**sbits, above any real key
        real = key < jnp.uint64(1 << (32 + hi_bits + sbits))

        starts_after = jnp.concatenate(
            [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
        )
        count = _suffix_min(starts_after) - idx

        kept = (
            boundary
            & real
            & (count >= abundance_min)
            & (count <= abundance_max)
        )
        key_fill = jnp.uint64(0xFFFFFFFFFFFFFFFF)
        key_c, cnt_c = compact_rows(
            (key, count), kept, fills=(key_fill, 0),
            vary_axes=vary_axes,
        )
        kept2 = key_c != key_fill
        sid2 = (key_c & jnp.uint64((1 << sbits) - 1)).astype(jnp.int32)
        val = key_c >> sbits
        hi2 = jnp.where(kept2, (val >> 32).astype(jnp.uint32), SENTINEL)
        lo2 = jnp.where(kept2, val.astype(jnp.uint32), SENTINEL)
        return (
            (hi2, lo2),
            jnp.where(kept2, sid2, 0),
            cnt_c,
            kept2,
            True,
        )

    # ---- pass 1: group (kmer, sample) -> per-sample counts ----
    sorted1 = jax.lax.sort((*words, sid), num_keys=nw + 1)
    words = sorted1[:nw]
    sid = sorted1[nw]
    prev_same = (sid[1:] == sid[:-1])
    for w in words:
        prev_same = prev_same & (w[1:] == w[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~prev_same])
    real = words[0] != SENTINEL

    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    next_start = _suffix_min(starts_after)
    count = next_start - idx  # valid at boundary positions

    kept = (
        boundary
        & real
        & (count >= abundance_min)
        & (count <= abundance_max)
    )
    return (words, sid, count, kept, False)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_banks",
        "simple",
        "complex_",
        "count_bits",
        "vary_axes",
        "psum_axis",
        "hi_bits",
    ),
)
def join_stats_from_spectra(
    words,
    sid,
    counts,
    abundance_min,
    abundance_max,
    solid_override=None,
    *,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    count_bits: int = 32,
    vary_axes: tuple = (),
    psum_axis: str = "",
    hi_bits: int = 32,
) -> JoinStats:
    """Statistics from pre-counted per-sample spectra.

    ``words``/``sid``/``counts`` hold one row per (distinct k-mer,
    sample) pair -- the checkpointed output of the count phase (the
    reference's partition files, reloaded on resume / when adding new
    datasets with -keep-tmp, README.md:205-207). Rows need not be
    sorted; SENTINEL first-words mark padding.

    ``solid_override``: optional [n_banks] i64 GLOBAL per-bank solid
    totals. The Whittaker/Kullback-Leibler pair terms depend on
    whole-sample totals (the reference's merge reads them from the
    count_synchro metadata, SimkaDistance.cpp:114-152); when this call
    only sees one hash range of the k-mer space (the out-of-core
    sweep, core/sweep.py), the caller must inject the global totals.
    """
    rows = _rows_from_spectra(
        words, sid, counts, abundance_min, abundance_max,
        n_banks=n_banks, hi_bits=hi_bits,
    )
    return _stats_from_rows(
        *rows[:4],
        rows_compacted=True,
        solid_override=solid_override,
        n_banks=n_banks,
        simple=simple,
        complex_=complex_,
        count_bits=count_bits,
        vary_axes=vary_axes,
        psum_axis=psum_axis,
    )


def _rows_from_spectra(
    words, sid, counts, abundance_min, abundance_max,
    *, n_banks: int, hi_bits: int,
):
    """Sort + abundance-filter pre-counted spectrum rows.

    The abundance filter depends only on the row itself here, so
    masking dropped rows to SENTINEL *before* the sort folds the
    compaction into it: kept rows come out contiguous, (kmer,
    sample)-ascending (sid is a key -> the a < b pair invariant),
    and no second pass is needed. Returns (words, sid, counts, kept)
    with kept rows compacted at the front.
    """
    words = tuple(words)
    nw = len(words)
    dropped = (counts < abundance_min) | (counts > abundance_max)
    sbits = max(1, (n_banks - 1).bit_length())
    if nw == 2 and 32 + hi_bits + sbits <= 63:
        # packed fast path: one u64 (kmer, sid) key + count payload
        # (see count_join_stats); dropped/padding rows get all-ones
        key = (
            (
                (words[0].astype(jnp.uint64) << 32)
                | words[1].astype(jnp.uint64)
            )
            << sbits
        ) | sid.astype(jnp.uint64)
        key_fill = jnp.uint64(0xFFFFFFFFFFFFFFFF)
        key = jnp.where(dropped | (words[0] == SENTINEL), key_fill, key)
        key, counts = jax.lax.sort((key, counts), num_keys=1)
        kept = key != key_fill
        sid = jnp.where(
            kept, (key & jnp.uint64((1 << sbits) - 1)).astype(jnp.int32), 0
        )
        val = key >> sbits
        words = (
            jnp.where(kept, (val >> 32).astype(jnp.uint32), SENTINEL),
            jnp.where(kept, val.astype(jnp.uint32), SENTINEL),
        )
        return words, sid, counts, kept
    words = (jnp.where(dropped, SENTINEL, words[0]), *words[1:])
    sorted_ = jax.lax.sort((*words, sid, counts), num_keys=nw + 1)
    words = sorted_[:nw]
    sid = sorted_[nw]
    counts = sorted_[nw + 1]
    kept = words[0] != SENTINEL
    return words, sid, counts, kept


class Prejoin(NamedTuple):
    """Program-A output of the singleton-pruned two-program join.

    The reference's merge NEVER pays pair-loop work for k-mers present
    in only one bank: `insert` calls the pair processor only when
    nbBankThatHaveKmer > 1 (src/SimkaMerge.cpp:1317-1325). With XLA's
    static shapes, pruning only pays if the array SHRINKS, which
    forces a program split: program A (this) sorts, counts, filters,
    compacts and drops singleton segments, returning the exact kept
    count; the host re-pads to a size class and program B
    (pair_stats_shared) runs the pair loop on the smaller stream.
    Correct for EVERY channel: a single-row segment generates no
    (a, b) pair at any shift offset, and the single-presence terms of
    the complex distances are closed forms over the global totals
    carried here (see the module docstring).
    """

    words_shared: tuple  # of [E] uint32, shared rows compacted front
    sid_shared: jnp.ndarray  # [E] i32 (0 at padding)
    cnt_shared: jnp.ndarray  # [E] i32 (0 at padding)
    n_rows_shared: jnp.ndarray  # i32 scalar (per shard under shard_map)
    nb_distinct: jnp.ndarray
    nb_shared: jnp.ndarray
    distinct_per_bank: jnp.ndarray
    solid_per_bank: jnp.ndarray
    chord_n2_per_bank: jnp.ndarray
    # [N, N] i64: the exact-wrap Whittaker all-rows term (must see
    # EVERY solid row, so it lives in program A, not the shared-only
    # program B); zeros unless complex_
    whittaker_all: jnp.ndarray
    max_count: jnp.ndarray


def _prejoin_from_rows(
    words,
    sid,
    count,
    kept,
    *,
    n_banks: int,
    vary_axes: tuple,
    psum_axis: str,
    rows_compacted: bool,
    complex_: bool = False,
    solid_override=None,
) -> Prejoin:
    """Totals + compaction + singleton-segment drop (program A).

    ``complex_`` also computes the exact-wrap Whittaker all-rows term
    here (it needs every solid row; program B only sees shared rows);
    ``solid_override`` injects GLOBAL per-bank totals for it when this
    program only sees one hash range (the out-of-core sweep)."""
    nw = len(words)
    N = n_banks
    count = count.astype(jnp.int32)
    count64 = count.astype(jnp.int64)
    sid_clip = jnp.where(kept, sid, N)
    distinct_per_bank = binned_sum(
        jnp.where(kept, 1, 0).astype(jnp.int64), sid_clip, N, bits=33
    )
    solid_per_bank = binned_sum(
        jnp.where(kept, count64, 0), sid_clip, N, bits=44
    )
    chord_n2_per_bank = binned_sum(
        jnp.where(kept, count64 * count64, 0), sid_clip, N, bits=63
    )
    if psum_axis:
        distinct_per_bank = jax.lax.psum(distinct_per_bank, psum_axis)
        solid_per_bank = jax.lax.psum(solid_per_bank, psum_axis)
        chord_n2_per_bank = jax.lax.psum(chord_n2_per_bank, psum_axis)

    if rows_compacted:
        words2, sid2, cnt2 = words, sid, count
    else:
        compacted = compact_rows(
            (*words, sid, count),
            kept,
            fills=(SENTINEL,) * nw + (0, 0),
            vary_axes=vary_axes,
        )
        words2 = compacted[:nw]
        sid2 = compacted[nw]
        cnt2 = compacted[nw + 1]
    kept2 = words2[0] != SENTINEL
    _, _, _, _, n_distinct, n_shared = _segment_rows(words2, kept2)
    max_cnt = jnp.max(jnp.where(kept2, cnt2, 0)).astype(jnp.int64)

    # a row is in a multi-row segment iff an adjacent row holds the
    # same k-mer (rows are kmer-grouped after compaction; padding rows
    # are excluded by kept2 even though SENTINEL == SENTINEL)
    same_next = kept2[1:] & kept2[:-1]
    for w in words2:
        same_next = same_next & (w[1:] == w[:-1])
    false1 = jnp.zeros((1,), jnp.bool_)
    shared_row = kept2 & (
        jnp.concatenate([false1, same_next])
        | jnp.concatenate([same_next, false1])
    )
    comp2 = compact_rows(
        (*words2, sid2, cnt2),
        shared_row,
        fills=(SENTINEL,) * nw + (0, 0),
        vary_axes=vary_axes,
    )
    n_rows = jnp.sum(shared_row.astype(jnp.int32))

    if complex_:
        K = (
            solid_per_bank  # already global (psum'd above)
            if solid_override is None
            else solid_override
        )
        w_all = _whittaker_all_banks(
            jnp.where(kept2, sid2, n_banks),
            jnp.where(kept2, cnt2, 0),
            K,
            n_banks=n_banks,
        )
    else:
        w_all = jnp.zeros((n_banks, n_banks), jnp.int64)
        if vary_axes:
            w_all = jax.lax.pcast(w_all, vary_axes, to="varying")

    if psum_axis:
        n_distinct = jax.lax.psum(n_distinct, psum_axis)
        n_shared = jax.lax.psum(n_shared, psum_axis)
        max_cnt = jax.lax.pmax(max_cnt, psum_axis)
        w_all = jax.lax.psum(w_all, psum_axis)
    return Prejoin(
        words_shared=comp2[:nw],
        sid_shared=comp2[nw],
        cnt_shared=comp2[nw + 1],
        n_rows_shared=n_rows,
        nb_distinct=n_distinct,
        nb_shared=n_shared,
        distinct_per_bank=distinct_per_bank,
        solid_per_bank=solid_per_bank,
        chord_n2_per_bank=chord_n2_per_bank,
        whittaker_all=w_all,
        max_count=max_cnt,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_banks", "hi_bits", "vary_axes", "psum_axis", "complex_",
    ),
)
def count_join_prejoin(
    hi,
    lo,
    sid,
    abundance_min,
    abundance_max,
    solid_override=None,
    *,
    n_banks: int,
    hi_bits: int = 32,
    vary_axes: tuple = (),
    psum_axis: str = "",
    complex_: bool = False,
) -> Prejoin:
    """Program A over raw k-mer instances (args as count_join_stats)."""
    rows = _rows_from_instances(
        hi, lo, sid, abundance_min, abundance_max,
        n_banks=n_banks, hi_bits=hi_bits, vary_axes=vary_axes,
    )
    return _prejoin_from_rows(
        *rows[:4],
        rows_compacted=rows[4],
        n_banks=n_banks,
        vary_axes=vary_axes,
        psum_axis=psum_axis,
        complex_=complex_,
        solid_override=solid_override,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_banks", "hi_bits", "vary_axes", "psum_axis", "complex_",
    ),
)
def join_spectra_prejoin(
    words,
    sid,
    counts,
    abundance_min,
    abundance_max,
    solid_override=None,
    *,
    n_banks: int,
    hi_bits: int = 32,
    vary_axes: tuple = (),
    psum_axis: str = "",
    complex_: bool = False,
) -> Prejoin:
    """Program A over pre-counted spectrum rows (args as
    join_stats_from_spectra)."""
    rows = _rows_from_spectra(
        words, sid, counts, abundance_min, abundance_max,
        n_banks=n_banks, hi_bits=hi_bits,
    )
    return _prejoin_from_rows(
        *rows,
        rows_compacted=True,
        n_banks=n_banks,
        vary_axes=vary_axes,
        psum_axis=psum_axis,
        complex_=complex_,
        solid_override=solid_override,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_banks",
        "simple",
        "complex_",
        "count_bits",
        "vary_axes",
        "psum_axis",
    ),
)
def pair_stats_shared(
    words,
    sid,
    cnt,
    solid_global,
    max_count,
    *,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    count_bits: int = 32,
    vary_axes: tuple = (),
    psum_axis: str = "",
):
    """Program B: the pair pass over a shared-only compacted stream.

    ``words``/``sid``/``cnt`` are the (host-resized) Prejoin outputs;
    ``solid_global`` the GLOBAL per-bank solid totals (the reference's
    count_synchro metadata, SimkaDistance.cpp:114-152) and
    ``max_count`` the global max per-(kmer, bank) count (drives the
    runtime limb level). Returns the acc dict of pair matrices.
    """
    words = tuple(words)
    kept2 = words[0] != SENTINEL
    seg_e, _, _, d_max, _, _ = _segment_rows(words, kept2)
    acc = _pair_accumulate(
        seg_e,
        sid,
        cnt.astype(jnp.int32),
        kept2,
        d_max,
        max_count,
        solid_global,
        n_banks=n_banks,
        simple=simple,
        complex_=complex_,
        count_bits=count_bits,
        vary_axes=vary_axes,
    )
    if psum_axis:
        acc = {
            k: jax.lax.psum(v, psum_axis) for k, v in acc.items()
        }
    return acc


def _join_stats_from_split(pre: Prejoin, acc) -> JoinStats:
    return JoinStats(
        nb_distinct=pre.nb_distinct,
        nb_shared=pre.nb_shared,
        distinct_per_bank=pre.distinct_per_bank,
        solid_per_bank=pre.solid_per_bank,
        chord_n2_per_bank=pre.chord_n2_per_bank,
        shared_kmers_ab=acc["shared_kmers_ab"],
        shared_kmers_ba=acc["shared_kmers_ba"],
        shared_distinct=acc["shared_distinct"],
        bray_numerator=acc["bray"],
        chord_ninj=acc["chord"],
        hellinger=acc["hellinger"],
        whittaker=acc["whittaker"],
        whittaker_all=pre.whittaker_all,
        whittaker_s12=acc["whittaker_s12"],
        kullback_leibler=acc["kl"],
        max_count=pre.max_count,
    )


def shared_size_class(n_rows: int, E: int) -> int:
    """Static program-B length for a shared-row count (power-of-two
    classes bound recompiles; never above the program-A length)."""
    from simka_tpu.utils.sizeclass import pad_size_class

    return min(pad_size_class(n_rows), E)


def count_join_stats_split(
    hi,
    lo,
    sid,
    abundance_min,
    abundance_max,
    *,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    count_bits: int = 32,
    hi_bits: int = 32,
) -> JoinStats:
    """Two-program singleton-pruned join (single device).

    Equivalent to count_join_stats bit-for-bit; pays one host sync of
    the shared-row count plus a second compaction to shrink the pair
    pass to the shared rows only -- the reference's
    `nbBankThatHaveKmer > 1` insert gate (SimkaMerge.cpp:1317-1325).
    Wins when the pair stage dominates (wide N) and singleton
    fractions are high (50-80% on real metagenomes).
    """
    pre = count_join_prejoin(
        hi, lo, sid, abundance_min, abundance_max,
        n_banks=n_banks, hi_bits=hi_bits, complex_=complex_,
    )
    import numpy as np

    E = pre.sid_shared.shape[0]
    E2 = shared_size_class(int(np.asarray(pre.n_rows_shared)), E)
    acc = pair_stats_shared(
        tuple(w[:E2] for w in pre.words_shared),
        pre.sid_shared[:E2],
        pre.cnt_shared[:E2],
        pre.solid_per_bank,
        pre.max_count,
        n_banks=n_banks,
        simple=simple,
        complex_=complex_,
        count_bits=count_bits,
    )
    return _join_stats_from_split(pre, acc)


def join_stats_from_spectra_split(
    words,
    sid,
    counts,
    abundance_min,
    abundance_max,
    solid_override=None,
    *,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    count_bits: int = 32,
    hi_bits: int = 32,
) -> JoinStats:
    """Two-program singleton-pruned join over spectrum rows."""
    pre = join_spectra_prejoin(
        words, sid, counts, abundance_min, abundance_max,
        solid_override,
        n_banks=n_banks, hi_bits=hi_bits, complex_=complex_,
    )
    import numpy as np

    E = pre.sid_shared.shape[0]
    E2 = shared_size_class(int(np.asarray(pre.n_rows_shared)), E)
    K = (
        pre.solid_per_bank
        if solid_override is None
        else solid_override
    )
    acc = pair_stats_shared(
        tuple(w[:E2] for w in pre.words_shared),
        pre.sid_shared[:E2],
        pre.cnt_shared[:E2],
        K,
        pre.max_count,
        n_banks=n_banks,
        simple=simple,
        complex_=complex_,
        count_bits=count_bits,
    )
    return _join_stats_from_split(pre, acc)


def _stats_from_rows(
    words,
    sid,
    count,
    kept,
    *,
    n_banks: int,
    simple: bool,
    complex_: bool,
    count_bits: int,
    vary_axes: tuple,
    psum_axis: str,
    rows_compacted: bool = False,
    solid_override=None,
) -> JoinStats:
    """Shared pass 2+3 over (kmer, sample, count) rows with validity.

    ``rows_compacted=True`` promises kept rows are already contiguous
    at the front in (kmer, sample)-ascending order with SENTINEL
    first-words everywhere else (callers that fold the drop mask into
    their own sort), skipping the compaction pass.
    """
    nw = len(words)
    E = words[0].shape[0]
    N = n_banks
    idx = jnp.arange(E, dtype=jnp.int32)
    count = count.astype(jnp.int32)
    count64 = count.astype(jnp.int64)
    sid_clip = jnp.where(kept, sid, N)
    distinct_per_bank = binned_sum(
        jnp.where(kept, 1, 0).astype(jnp.int64), sid_clip, N, bits=33
    )
    solid_per_bank = binned_sum(
        jnp.where(kept, count64, 0), sid_clip, N, bits=44
    )
    chord_n2_per_bank = binned_sum(
        jnp.where(kept, count64 * count64, 0), sid_clip, N, bits=63
    )

    if psum_axis:
        # running under shard_map over disjoint k-mer hash ranges:
        # per-bank totals must be GLOBAL before the pair terms use
        # them (the reference's merge reads whole-sample counts from
        # the count_synchro metadata, SimkaDistance.cpp:114-152 --
        # Whittaker and Kullback-Leibler depend on them)
        distinct_per_bank = jax.lax.psum(distinct_per_bank, psum_axis)
        solid_per_bank = jax.lax.psum(solid_per_bank, psum_axis)
        chord_n2_per_bank = jax.lax.psum(chord_n2_per_bank, psum_axis)

    # ---- pass 2: group surviving rows by kmer (the join) ----
    # Dropped rows are removed by a stable COMPACTION so kept rows are
    # CONTIGUOUS: pair iteration then reads fixed-offset shifted
    # slices, which are contiguous reads. Pass-1 order is already
    # (kmer, sample)-ascending, so compaction preserves the grouping
    # and the a < b pair invariant -- no re-sort needed.
    if rows_compacted:
        words2, sid2, cnt2 = words, sid, count
    else:
        compacted = compact_rows(
            (*words, sid, count),
            kept,
            fills=(SENTINEL,) * nw + (0, 0),
            vary_axes=vary_axes,
        )
        words2 = compacted[:nw]
        sid2 = compacted[nw]
        cnt2 = compacted[nw + 1]
    kept2 = words2[0] != SENTINEL
    seg_e, newk, seg_len, d_max, n_distinct, n_shared = _segment_rows(
        words2, kept2
    )
    max_cnt = jnp.max(jnp.where(kept2, cnt2, 0)).astype(jnp.int64)

    # global totals feeding the Whittaker/KL pair terms; a sweep over
    # hash ranges must inject the whole-space totals here
    K = solid_per_bank if solid_override is None else solid_override
    acc = _pair_accumulate(
        seg_e,
        sid2,
        cnt2,
        kept2,
        d_max,
        max_cnt,
        K,
        n_banks=N,
        simple=simple,
        complex_=complex_,
        count_bits=count_bits,
        vary_axes=vary_axes,
    )
    if complex_:
        w_all = _whittaker_all_banks(
            jnp.where(kept2, sid2, N),
            jnp.where(kept2, cnt2, 0),
            K,
            n_banks=N,
        )
    else:
        w_all = jnp.zeros((N, N), jnp.int64)
        if vary_axes:
            w_all = jax.lax.pcast(w_all, vary_axes, to="varying")
    return _assemble_join_stats(
        acc,
        w_all,
        n_distinct,
        n_shared,
        distinct_per_bank,
        solid_per_bank,
        chord_n2_per_bank,
        max_cnt,
        psum_axis,
    )


def _segment_rows(words2, kept2):
    """Group compacted rows into equal-k-mer segments.

    Returns (seg_e, newk, seg_len, d_max, n_distinct, n_shared):
    per-row segment id (E at padding), first-row-of-segment mask,
    run lengths (valid at newk rows), the max segment multiplicity,
    and the distinct / shared-distinct scalar counts.
    """
    E = words2[0].shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    changed = words2[0][1:] != words2[0][:-1]
    for w in words2[1:]:
        changed = changed | (w[1:] != w[:-1])
    newk = jnp.concatenate([jnp.array([True]), changed]) & kept2
    seg = jnp.cumsum(newk.astype(jnp.int32)) - 1
    seg_e = jnp.where(kept2, seg, E)
    n_distinct = (
        jnp.max(jnp.where(kept2, seg, -1)) + 1
    ).astype(jnp.int64)

    # per-segment multiplicity by run-length (no scatter)
    seg_starts_after = jnp.concatenate(
        [jnp.where(newk, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    seg_next = _suffix_min(seg_starts_after)
    n_valid = jnp.sum(kept2.astype(jnp.int32))
    seg_len = jnp.minimum(seg_next, n_valid) - idx  # valid at newk rows
    d_max = jnp.max(jnp.where(newk, seg_len, 0))
    n_shared = jnp.sum(newk & (seg_len >= 2)).astype(jnp.int64)
    return seg_e, newk, seg_len, d_max, n_distinct, n_shared


def _pair_accumulate(
    seg_e,
    sid2,
    cnt2,
    kept2,
    d_max,
    max_cnt,
    K,
    *,
    n_banks: int,
    simple: bool,
    complex_: bool,
    count_bits: int,
    vary_axes: tuple,
):
    """Pass 3: accumulate every pairwise channel over shift offsets.

    Returns the full acc dict (shared_kmers_ab/ba, shared_distinct,
    bray, chord, hellinger, whittaker, kl) with zeros for channels the
    static flags leave off. ``K``: the GLOBAL per-bank solid totals
    consumed by the Whittaker/KL pair terms.
    """
    N = n_banks
    E = seg_e.shape[0]
    # Default channels at N <= PAIRBIN_MAX_BANKS take the PAIR-BIN
    # path: per shift, one lhs channel stack (pair flag + count limbs)
    # is contracted against one-hot(s) over the UPPER-TRIANGLE pair
    # bin (rows within a k-mer are sample-ascending, so every pair
    # satisfies a < b -- the reference's own flattened symmetric
    # index, SimkaAlgorithm.hpp:364); bins beyond 128 split into
    # 128-column blocks that reuse the same lhs. Beyond the threshold
    # the 4-pass per-shift loop runs.
    use_packed = (
        (not simple) and (not complex_) and N <= PAIRBIN_MAX_BANKS
    )

    # max_cnt doubles as the runtime bound on every count-derived
    # einsum value: lets _pair_bin_int skip high limbs when coverage
    # is low (the common case; see its docstring)
    if use_packed:
        acc = _pairbin_pass(
            seg_e,
            jnp.where(kept2, sid2, N),
            jnp.where(kept2, cnt2, 0),
            kept2,
            d_max,
            max_cnt,
            n_banks=N,
            count_bits=count_bits,
            vary_axes=vary_axes,
        )
        zero_f = jnp.zeros((N, N), jnp.float64)
        zero_i = jnp.zeros((N, N), jnp.int64)
        if vary_axes:
            zero_f = jax.lax.pcast(zero_f, vary_axes, to="varying")
            zero_i = jax.lax.pcast(zero_i, vary_axes, to="varying")
        return dict(
            acc,
            chord=zero_f,
            hellinger=zero_i,
            whittaker=zero_i,
            whittaker_s12=zero_i,
            kl=zero_f,
        )

    # pad so a dynamic_slice at offset d (< N) never reads OOB
    seg_p, sid_p, cnt_p, kept_p = _shift_padded(
        (seg_e, sid2, cnt2, kept2), (E, 0, 0, False), N + 1
    )
    bank_range = jnp.arange(N, dtype=jnp.int32)[None, None, :]
    keys = ["shared_kmers_ab", "shared_kmers_ba", "shared_distinct", "bray"]
    if simple:
        keys += ["hellinger", "chord"]
    if complex_:
        keys += ["whittaker", "whittaker_s12", "kl"]

    def pair_terms(seg_a, sid_a, cnt_a, kept_a, seg_b, sid_b, cnt_b, kept_b):
        """One row chunk's contribution at the current shift: row r
        pairs with row r + d when both hold the same k-mer."""
        m = kept_a & kept_b & (seg_a == seg_b)
        # panel padding MUST fill with N (the masked bank), not 0: the
        # stacked-einsum dist block is unweighted, so pad rows one-hot
        # at bank 0 would count as pairs
        oh_a = (
            _panels(jnp.where(kept_a, sid_a, N), fill=N)[..., None]
            == bank_range
        ).astype(jnp.float32)
        va = jnp.where(m, cnt_a, 0).astype(jnp.int64)
        vb = jnp.where(m, cnt_b, 0).astype(jnp.int64)
        va_p = _panels(va)
        vb_p = _panels(vb)
        oh_b = (
            _panels(jnp.where(m, sid_b, N), fill=N)[..., None]
            == bank_range
        ).astype(jnp.float32)

        out = {}
        out["shared_kmers_ab"] = _pair_bin_int(
            oh_a, oh_b, va_p, count_bits, max_value=max_cnt,
            vary_axes=vary_axes,
        )
        out["shared_kmers_ba"] = _pair_bin_int(
            oh_a, oh_b, vb_p, count_bits, max_value=max_cnt,
            vary_axes=vary_axes,
        )
        out["shared_distinct"] = _pair_bin_int(
            oh_a, oh_b, _panels(m.astype(jnp.int64)), 1
        )
        out["bray"] = _pair_bin_int(
            oh_a, oh_b, jnp.minimum(va_p, vb_p), count_bits,
            max_value=max_cnt, vary_axes=vary_axes,
        )
        if simple:
            prod = (va_p * vb_p).astype(jnp.float64)
            out["hellinger"] = _pair_bin_int(
                oh_a,
                oh_b,
                jnp.floor(jnp.sqrt(prod)).astype(jnp.int64),
                1 + count_bits,  # isqrt of a 2*count_bits product
                max_value=max_cnt,  # isqrt(Ca*Cb) <= max(Ca, Cb)
                vary_axes=vary_axes,
            )
            out["chord"] = _pair_bin_float(oh_a, oh_b, prod)
        if complex_:
            # Whittaker pair term: the reference computes
            # abs((int)((u64)(Ca*Kb) - (u64)(Cb*Ka)))
            # (SimkaAlgorithm.hpp:481) -- the difference wraps to
            # 32-bit signed. Emulate on the rounded double products.
            Ka = K[sid_a].astype(jnp.float64)
            Kb = K[jnp.clip(sid_b, 0, N - 1)].astype(jnp.float64)
            p1 = jnp.mod(cnt_a.astype(jnp.float64) * Kb, 2.0**32)
            p2 = jnp.mod(cnt_b.astype(jnp.float64) * Ka, 2.0**32)
            low = jnp.mod(p1 - p2, 2.0**32).astype(jnp.int64)
            wrapped = jnp.where(low >= 2**31, low - 2**32, low)
            wval = jnp.where(m, jnp.abs(wrapped), 0)
            out["whittaker"] = _pair_bin_int(oh_a, oh_b, _panels(wval), 32)
            # s12 = |wrap32(cI*K_j)| + |wrap32(cJ*K_i)| over co-present
            # pairs: subtracted from the all-rows A term at
            # finalization so shared k-mers keep only the wrapped
            # difference (see the JoinStats field docstring)
            s12 = jnp.where(
                m,
                _abs_wrap32(cnt_a.astype(jnp.float64) * Kb)
                + _abs_wrap32(cnt_b.astype(jnp.float64) * Ka),
                0,
            )
            out["whittaker_s12"] = _pair_bin_int(
                oh_a, oh_b, _panels(s12), 33
            )

            # Kullback-Leibler pair term (both present,
            # SimkaAlgorithm.hpp:437-446):
            # xY = Ca*Kb, yX = Cb*Ka
            # d1 = (Ca/Ka) * log(2*xY/(xY+yX))
            # d2 = (Cb/Kb) * log(2*yX/(xY+yX))
            caf = cnt_a.astype(jnp.float64)
            cbf = cnt_b.astype(jnp.float64)
            xY = caf * Kb
            yX = cbf * Ka
            den = jnp.where(m, xY + yX, 1.0)
            d1 = (caf / jnp.maximum(Ka, 1.0)) * jnp.log(
                jnp.where(m, 2.0 * xY / den, 1.0)
            )
            d2 = (cbf / jnp.maximum(Kb, 1.0)) * jnp.log(
                jnp.where(m, 2.0 * yX / den, 1.0)
            )
            out["kl"] = _pair_bin_float(
                oh_a, oh_b, _panels(jnp.where(m, d1 + d2, 0.0))
            )
        return out

    def shift_body(d, acc):
        seg_b, sid_b, cnt_b, kept_b = _shift_window(
            (seg_p, sid_p, cnt_p, kept_p), d, E
        )
        part = chunked_sum(
            pair_terms,
            (seg_e, sid2, cnt2, kept2, seg_b, sid_b, cnt_b, kept_b),
            (E, 0, 0, False, E, 0, 0, False),
            {k: acc[k] for k in keys},
        )
        return dict(acc, **part)

    acc0 = {
        "shared_kmers_ab": jnp.zeros((N, N), jnp.int64),
        "shared_kmers_ba": jnp.zeros((N, N), jnp.int64),
        "shared_distinct": jnp.zeros((N, N), jnp.int64),
        "bray": jnp.zeros((N, N), jnp.int64),
        "chord": jnp.zeros((N, N), jnp.float64),
        "hellinger": jnp.zeros((N, N), jnp.int64),
        "whittaker": jnp.zeros((N, N), jnp.int64),
        "whittaker_s12": jnp.zeros((N, N), jnp.int64),
        "kl": jnp.zeros((N, N), jnp.float64),
    }
    if vary_axes:
        # under shard_map the loop body mixes in device-varying data;
        # the initial carry must carry the same varying axes
        acc0 = jax.tree.map(
            lambda x: jax.lax.pcast(x, vary_axes, to="varying"), acc0
        )
    return jax.lax.fori_loop(1, d_max, shift_body, acc0)


def _assemble_join_stats(
    acc,
    whittaker_all,
    n_distinct,
    n_shared,
    distinct_per_bank,
    solid_per_bank,
    chord_n2_per_bank,
    max_cnt,
    psum_axis,
):
    out = JoinStats(
        nb_distinct=n_distinct,
        nb_shared=n_shared,
        distinct_per_bank=distinct_per_bank,
        solid_per_bank=solid_per_bank,
        chord_n2_per_bank=chord_n2_per_bank,
        shared_kmers_ab=acc["shared_kmers_ab"],
        shared_kmers_ba=acc["shared_kmers_ba"],
        shared_distinct=acc["shared_distinct"],
        bray_numerator=acc["bray"],
        chord_ninj=acc["chord"],
        hellinger=acc["hellinger"],
        whittaker=acc["whittaker"],
        whittaker_all=whittaker_all,
        whittaker_s12=acc["whittaker_s12"],
        kullback_leibler=acc["kl"],
        max_count=max_cnt,
    )
    if psum_axis:
        # per-bank totals are already global (psum'd above); everything
        # else is additive over disjoint shards
        out = out._replace(
            nb_distinct=jax.lax.psum(out.nb_distinct, psum_axis),
            nb_shared=jax.lax.psum(out.nb_shared, psum_axis),
            shared_kmers_ab=jax.lax.psum(out.shared_kmers_ab, psum_axis),
            shared_kmers_ba=jax.lax.psum(out.shared_kmers_ba, psum_axis),
            shared_distinct=jax.lax.psum(out.shared_distinct, psum_axis),
            bray_numerator=jax.lax.psum(out.bray_numerator, psum_axis),
            chord_ninj=jax.lax.psum(out.chord_ninj, psum_axis),
            hellinger=jax.lax.psum(out.hellinger, psum_axis),
            whittaker=jax.lax.psum(out.whittaker, psum_axis),
            whittaker_all=jax.lax.psum(out.whittaker_all, psum_axis),
            whittaker_s12=jax.lax.psum(out.whittaker_s12, psum_axis),
            kullback_leibler=jax.lax.psum(out.kullback_leibler, psum_axis),
            max_count=jax.lax.pmax(out.max_count, psum_axis),
        )
    return out


def _pairbin_pass(
    seg_e,
    sid_m,
    cnt_m,
    kept2,
    d_max,
    max_cnt,
    *,
    n_banks: int,
    count_bits: int,
    vary_axes: tuple,
):
    """Default-channel pair accumulation binned by the JOINT pair id.

    Replaces the reference's per-pair scalar accumulator loops
    (SimkaAlgorithm.hpp:356-378) for the default distance channels at
    N(N-1)/2 <= 128. The per-shift einsum path issues 4 one-hot
    matmul passes per offset d, each [B, N]x[B, N] -- tiny matmuls
    that leave a matrix unit mostly idle. Here ONE pass per shift
    carries everything:

      rhs [B, tri]:      one-hot of the UPPER-TRIANGLE pair bin
        tri_idx(a, b) = a*(2N-a-1)/2 + (b-a-1) -- rows within a k-mer
        are sample-ascending so a < b always holds (the reference's
        own flattened symmetric index, SimkaAlgorithm.hpp:364); the
        pair mask is folded in: unpaired rows get the out-of-range
        sentinel bin
      lhs [B, 1 + 3*L]:  channels [pair(0/1)] + one 8-bit limb triple
        [C_a, C_b, min(Ca, Cb)] per active limb

    The [C, tri] output holds co-presence, sum C_a, sum C_b and
    sum min(Ca, Cb) for every pair a < b -- every channel x bin
    product is consumed; there are no discarded blocks, and triangle
    packing fits N <= 16 in one 128-column pass (the square N*N layout
    caps out at N = 11). Extra count limbs ride as extra lhs columns
    in the SAME matmul pass; the number of active limbs L is picked
    ONCE at runtime from max_cnt via lax.switch over per-level loops
    (typical low-coverage metagenomes run the 1-limb level).

    Exactness: operands are one-hots (0/1) and 8-bit limbs (<= 255),
    exact under the GPU's default TF32 operand rounding (10 explicit
    mantissa bits); panel sums stay < BLOCK_ROWS * 255 < 2^21, exact
    in the f32 accumulator; cross-panel sums are int64.

    Args: ``sid_m``/``cnt_m`` are per-row bank and count with dropped
    rows already masked to the sentinel bank N / count 0.
    """
    N = n_banks
    E = seg_e.shape[0]
    NB = max(N * (N - 1) // 2, 1)  # upper-triangle pair bins
    n_limbs = max(1, -(-count_bits // 8))
    seg_p, sid_p, cnt_p = _shift_padded(
        (seg_e, sid_m, cnt_m), (E, N, 0), N + 1
    )
    bin_iota = jnp.arange(NB, dtype=jnp.int32)
    # static [tri] -> (a, b) unpacking map for the scatter back to the
    # [N, N] upper triangle
    tri_a, tri_b = [], []
    for a in range(N):
        for b in range(a + 1, N):
            tri_a.append(a)
            tri_b.append(b)
    tri_a = tuple(tri_a) or (0,)
    tri_b = tuple(tri_b) or (0,)

    def to_square(flat):
        """[..., tri] pair sums -> [..., N, N] upper-triangle array."""
        sq = jnp.zeros(flat.shape[:-1] + (N, N), flat.dtype)
        return sq.at[..., jnp.array(tri_a), jnp.array(tri_b)].set(
            flat[..., : len(tri_a)] if N >= 2 else flat * 0
        )

    def make_loop(active_limbs):
        def run():
            def pair_terms(seg_a, sid_a, cnt_a, kept_a, seg_b, sid_b,
                           cnt_b):
                m = kept_a & (seg_a == seg_b)
                # a < b within a segment -> triangle index
                tri = (
                    sid_a * (2 * N - sid_a - 1) // 2
                    + (sid_b - sid_a - 1)
                )
                pairbin = jnp.where(m, tri, NB)
                pb = _panels(pairbin, fill=NB)
                mn = jnp.minimum(cnt_a, cnt_b)
                chans = [m.astype(jnp.int32)]
                for limb in range(active_limbs):
                    sh = 8 * limb
                    chans += [
                        (cnt_a >> sh) & 0xFF,
                        (cnt_b >> sh) & 0xFF,
                        (mn >> sh) & 0xFF,
                    ]
                ch = jnp.stack(
                    [_panels(c).astype(jnp.float32) for c in chans],
                    axis=-1,
                )
                # bins split into <= 128-column blocks; each block's
                # rhs one-hot is a plain compare-vs-iota slice (an
                # operand form XLA keeps fused) and every block
                # reuses the SAME lhs channel stack
                outs = []
                for p0 in range(0, NB, 128):
                    oh = (
                        pb[..., None] == bin_iota[p0 : p0 + 128]
                    ).astype(jnp.float32)
                    outs.append(
                        jnp.einsum(
                            "brc,brn->bcn",
                            ch,
                            oh,
                            preferred_element_type=jnp.float32,
                        ).astype(jnp.int64).sum(axis=0)
                    )
                out = (
                    outs[0]
                    if len(outs) == 1
                    else jnp.concatenate(outs, axis=-1)
                )
                ab = ba = bray = None
                for limb in range(active_limbs):
                    sh = 8 * limb
                    a_l = out[1 + 3 * limb] << sh
                    b_l = out[2 + 3 * limb] << sh
                    m_l = out[3 + 3 * limb] << sh
                    ab = a_l if ab is None else ab + a_l
                    ba = b_l if ba is None else ba + b_l
                    bray = m_l if bray is None else bray + m_l
                return {
                    "shared_distinct": out[0],
                    "shared_kmers_ab": ab,
                    "shared_kmers_ba": ba,
                    "bray": bray,
                }

            def shift_body(d, acc):
                seg_b, sid_b, cnt_b = _shift_window(
                    (seg_p, sid_p, cnt_p), d, E
                )
                return chunked_sum(
                    pair_terms,
                    (seg_e, sid_m, cnt_m, kept2, seg_b, sid_b, cnt_b),
                    (E, N, 0, False, E, N, 0),
                    acc,
                )

            acc0 = {
                "shared_distinct": jnp.zeros((NB,), jnp.int64),
                "shared_kmers_ab": jnp.zeros((NB,), jnp.int64),
                "shared_kmers_ba": jnp.zeros((NB,), jnp.int64),
                "bray": jnp.zeros((NB,), jnp.int64),
            }
            if vary_axes:
                acc0 = jax.tree.map(
                    lambda x: jax.lax.pcast(x, vary_axes, to="varying"),
                    acc0,
                )
            acc = jax.lax.fori_loop(1, d_max, shift_body, acc0)
            return jax.tree.map(to_square, acc)

        return run

    if n_limbs == 1:
        return make_loop(1)()
    # runtime limb level: 0 while max_cnt < 256, 1 below 2^16, ...
    level = jnp.sum(
        jnp.asarray(
            [max_cnt >= (1 << (8 * L)) for L in range(1, n_limbs)]
        ).astype(jnp.int32)
    )
    return jax.lax.switch(
        level, [make_loop(L + 1) for L in range(n_limbs)]
    )
