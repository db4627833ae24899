"""On-device SimkaMin sketch math: MurmurHash3 + bottom-s selection.

The reference hashes every canonical k-mer instance with
MurmurHash3_x64_128 and keeps the s smallest distinct h1 values in a
streaming max-heap (SelectKmersCommand,
/root/reference/src/simkaMin/SimkaMinCount.hpp:217-267, 311-338).
Here the hash is a handful of uint64 vector ops fused into the same
program as the k-mer extraction's output, and the bottom-s
selection is the standard sort + run-length + prefix pattern used by
the exact pipeline (ops/spectrum.py).

Exactness: u64 multiply/xor/shift are exact integer ops on any
backend; no floating-point matmul is involved, so device hashes are
bit-identical to the host murmur (tests/test_minhash_device.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from simka_tpu.ops.kmers import SENTINEL

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_F1 = 0xFF51AFD7ED558CCD
_F2 = 0xC4CEB9FE1A85EC53

FULL64 = jnp.uint64(0xFFFFFFFFFFFFFFFF)


def _rotl64(x, r: int):
    return (x << jnp.uint64(r)) | (x >> jnp.uint64(64 - r))


def _fmix64(h):
    h = h ^ (h >> jnp.uint64(33))
    h = h * jnp.uint64(_F1)
    h = h ^ (h >> jnp.uint64(33))
    h = h * jnp.uint64(_F2)
    h = h ^ (h >> jnp.uint64(33))
    return h


def murmur3_u64_device(values, seed: int):
    """h1 of MurmurHash3_x64_128 over each uint64 (as 8 LE bytes).

    Mirrors minhash/murmur.py (the numpy specialization of Appleby's
    public-domain algorithm for 8-byte keys: one k1 tail mix + the
    finalization); reference call site SimkaMinCount.hpp:248-250.
    """
    values = values.astype(jnp.uint64)
    h1 = jnp.full(values.shape, jnp.uint64(seed))
    h2 = jnp.full(values.shape, jnp.uint64(seed))
    k1 = values * jnp.uint64(_C1)
    k1 = _rotl64(k1, 31)
    k1 = k1 * jnp.uint64(_C2)
    h1 = h1 ^ k1
    length = jnp.uint64(8)
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    # h2 += h1 omitted: only h1 is used
    return h1


@functools.partial(jax.jit, static_argnames=("seed",))
def hash_kmer_words(hi, lo, *, seed: int):
    """Murmur-hash canonical k-mer words on device.

    ``hi``/``lo``: uint32 arrays (any shape) with SENTINEL marking
    invalid windows. Returns (h uint64, valid bool) of the same shape;
    invalid positions hash to FULL64 (callers should still mask by
    ``valid`` -- a real hash can collide with FULL64).
    """
    valid = hi != SENTINEL
    v = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    h = murmur3_u64_device(v, seed)
    return jnp.where(valid, h, FULL64), valid


def _suffix_min(x):
    return jnp.flip(jax.lax.cummin(jnp.flip(x)))


@functools.partial(jax.jit, static_argnames=("seed", "sketch_size"))
def device_sketch_update(hi, lo, *, seed: int, sketch_size: int):
    """One-program bottom-s sketch of a k-mer instance stream.

    hash -> sort -> run-length distinct counts -> bottom-s prefix,
    entirely on device (the fused analog of the reference's
    SelectKmersCommand hot loop, SimkaMinCount.hpp:217-267). Invalid
    windows (SENTINEL ``hi``) are excluded.

    Returns (hashes [s] uint64 ascending, counts [s] uint32); unused
    slots (fewer than s distinct hashes) hold FULL64 / 0.

    NOTE the streaming-heap count quirk of the largest sketch member
    (minhash/sketch.py docstring) depends on instance ORDER, which the
    sort destroys -- product sketching applies that correction from
    the first/second-occurrence positions (ops.spectrum.hash_spectrum);
    this fused program is the order-free fast path used by benchmarks
    and by callers that only need membership + total counts.
    """
    E = hi.size
    h, _valid = hash_kmer_words(hi.ravel(), lo.ravel(), seed=seed)
    h = jax.lax.sort((h,), num_keys=1)[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    boundary = jnp.concatenate([jnp.array([True]), h[1:] != h[:-1]])
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    count = _suffix_min(starts_after) - idx
    uniq = boundary & (h != FULL64)
    key = jnp.where(uniq, h, FULL64)
    cnt = jnp.where(uniq, count, 0).astype(jnp.uint32)
    key, cnt = jax.lax.sort((key, cnt), num_keys=1)
    s = min(sketch_size, E)
    out_h = key[:s]
    out_c = jnp.where(out_h != FULL64, cnt[:s], 0)
    if s < sketch_size:
        pad = sketch_size - s
        out_h = jnp.concatenate([out_h, jnp.full((pad,), FULL64)])
        out_c = jnp.concatenate([out_c, jnp.zeros((pad,), jnp.uint32)])
    return out_h, out_c


@functools.partial(
    jax.jit, static_argnames=("sketch_size", "use_filter")
)
def sketch_prefix_device(
    h, *, sketch_size: int, use_filter: bool
):
    """Bottom-s prefix WITH occurrence positions, from a device-resident
    per-instance hash stream (invalid/padding instances hold FULL64).

    One program: sort -> run-length distinct counts + first/second
    occurrence positions -> filter -> stable compaction -> [s] prefix.
    Only the prefix (plus three scalars) ever leaves the device -- the
    O(E) instance stream stays put (round 2 fetched it twice per
    sample; the reference's heap loop is
    /root/reference/src/simkaMin/SimkaMinCount.hpp:311-338).

    Returns (hashes [s] u64 ascending, counts [s] i32, entry_pos [s]
    i32, n_distinct, n_full64) where entry_pos is the heap-entry
    position (first occurrence; second when use_filter, matching the
    count-initialized-to-2 entry at SimkaMinCount.hpp:353), n_distinct
    counts the kept distinct hashes and n_full64 the stream's FULL64
    instances (the caller compares it against its invalid tally to
    detect the 2^-64 corner of a GENUINE all-ones hash, which falls
    back to the host-exact path).
    """
    E = h.shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    hh = (h >> jnp.uint64(32)).astype(jnp.uint32)
    hl = h.astype(jnp.uint32)
    hh, hl, pos = jax.lax.sort((hh, hl, idx), num_keys=2)
    same = (hh[1:] == hh[:-1]) & (hl[1:] == hl[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~same])
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    count = _suffix_min(starts_after) - idx
    second = jnp.concatenate([pos[1:], pos[-1:]])

    is_full = (hh == jnp.uint32(0xFFFFFFFF)) & (
        hl == jnp.uint32(0xFFFFFFFF)
    )
    n_full64 = jnp.sum(is_full.astype(jnp.int64))
    keep = boundary & ~is_full
    if use_filter:
        keep = keep & (count >= 2)
        entry = second
    else:
        entry = pos

    from simka_tpu.ops.compact import compact_rows

    hh_c, hl_c, cnt_c, ent_c = compact_rows(
        (hh, hl, count, entry),
        keep,
        fills=(0xFFFFFFFF, 0xFFFFFFFF, 0, 0),
    )
    n_distinct = jnp.sum(keep.astype(jnp.int64))
    s = min(sketch_size, E)
    hashes = (hh_c[:s].astype(jnp.uint64) << jnp.uint64(32)) | hl_c[
        :s
    ].astype(jnp.uint64)
    counts = cnt_c[:s]

    # streaming-heap quirk of the largest member, applied IN-PROGRAM
    # (SimkaMinCount.hpp:324; module docstring of minhash/sketch.py):
    # once every smaller member has entered the full heap, h_max's
    # occurrences stop counting. Folding it here saves two host
    # syncs per sample.
    full = n_distinct >= sketch_size
    sel = jnp.minimum(
        jnp.maximum(n_distinct.astype(jnp.int32), 1), s
    ) - 1
    h_max = hashes[sel]
    sidx = jnp.arange(s, dtype=jnp.int32)
    t_last = jnp.max(
        jnp.where(sidx < sel, ent_c[:s], 0)
    )
    n_before = jnp.sum(
        (
            (h == h_max)
            & (jnp.arange(E, dtype=jnp.int32) < t_last)
        ).astype(jnp.int64)
    )
    base = 2 if use_filter else 1
    corrected = jnp.maximum(base, n_before).astype(counts.dtype)
    counts = jnp.where(
        full & (sidx == sel), corrected, counts
    )
    return hashes, counts, ent_c[:s], n_distinct, n_full64


@functools.partial(jax.jit, static_argnames=("sketch_size",))
def sketch_stream_step(
    h, st_h, st_c, corr_h, corr_n, n_full_acc, *, sketch_size: int
):
    """Fold one super-batch of the per-instance hash stream into the
    streaming bottom-s sketch state (non-filter semantics).

    The reference's heap state after any stream prefix is exactly the
    s smallest distinct hashes seen so far with their total counts --
    EXCEPT the largest member, whose occurrences stop counting once
    every smaller member has entered (minhash/sketch.py docstring;
    SimkaMinCount.hpp:311-338). Three facts make that exactly
    streamable in O(s) state:

    - a member always enters the heap at its FIRST occurrence (its
      entry can never be pre-rejected: the top is always >= the final
      h_max >= any member), so "new members" of a batch merge first
      occurred IN that batch;
    - entries permanently add members (evicted hashes can never
      re-enter: the top only decreases), so the member SET changes in
      a batch iff any entry happened there -- the global last entry
      T lives in the last batch whose end-of-batch set changed;
    - only the final largest member h_max ever has occurrences
      dropped, exactly those at positions >= T.

    So at every set-changing batch this program recomputes the
    correction for the CURRENT largest member m: carried count of m
    (its occurrences in earlier batches) plus its occurrences in this
    batch before the batch's last entry position. The final state's
    correction then belongs to the final h_max.

    Args: ``h`` [E] uint64 instance hashes in stream order (FULL64 =
    invalid/padding); ``st_h``/``st_c`` [s] carried members
    (ascending, FULL64/0 padding); ``corr_h``/``corr_n`` the carried
    correction; ``n_full_acc`` running FULL64 tally.

    Returns (st_h, st_c, corr_h, corr_n, n_full_acc) updated.
    """
    E = h.shape[0]
    s = sketch_size
    idx = jnp.arange(E, dtype=jnp.int32)

    # ---- batch bottom-s distinct prefix with counts + first pos ----
    hh = (h >> jnp.uint64(32)).astype(jnp.uint32)
    hl = h.astype(jnp.uint32)
    hh, hl, pos = jax.lax.sort((hh, hl, idx), num_keys=2)
    same = (hh[1:] == hh[:-1]) & (hl[1:] == hl[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~same])
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    count = _suffix_min(starts_after) - idx
    is_full = (hh == jnp.uint32(0xFFFFFFFF)) & (
        hl == jnp.uint32(0xFFFFFFFF)
    )
    n_full_acc = n_full_acc + jnp.sum(is_full.astype(jnp.int64))
    keep = boundary & ~is_full

    from simka_tpu.ops.compact import compact_rows

    hh_c, hl_c, cnt_c, first_c = compact_rows(
        (hh, hl, count, pos), keep, fills=(0xFFFFFFFF, 0xFFFFFFFF, 0, 0)
    )
    sb = min(s, E)
    bh = (hh_c[:sb].astype(jnp.uint64) << jnp.uint64(32)) | hl_c[
        :sb
    ].astype(jnp.uint64)
    bc = cnt_c[:sb].astype(jnp.int64)
    bf = first_c[:sb].astype(jnp.int32)
    if sb < s:
        bh = jnp.concatenate([bh, jnp.full((s - sb,), FULL64)])
        bc = jnp.concatenate([bc, jnp.zeros((s - sb,), jnp.int64)])
        bf = jnp.concatenate([bf, jnp.zeros((s - sb,), jnp.int32)])

    # ---- merge carried [s] + batch [s] (carried side sorts first) ----
    mh = jnp.concatenate([st_h, bh])
    mc = jnp.concatenate([st_c, bc])
    mf = jnp.concatenate([jnp.zeros((s,), jnp.int32), bf])
    side = jnp.concatenate(
        [jnp.zeros((s,), jnp.uint32), jnp.ones((s,), jnp.uint32)]
    )
    m_hi = (mh >> jnp.uint64(32)).astype(jnp.uint32)
    m_lo = mh.astype(jnp.uint32)
    m_hi, m_lo, side, mc, mf = jax.lax.sort(
        (m_hi, m_lo, side, mc, mf), num_keys=3
    )
    mh = (m_hi.astype(jnp.uint64) << jnp.uint64(32)) | m_lo.astype(
        jnp.uint64
    )
    same2 = mh[1:] == mh[:-1]
    bnd2 = jnp.concatenate([jnp.array([True]), ~same2])
    next_c = jnp.concatenate([mc[1:], jnp.zeros((1,), jnp.int64)])
    has_next = jnp.concatenate([same2, jnp.array([False])])
    comb_c = mc + jnp.where(has_next, next_c, 0)
    valid2 = mh != FULL64
    keep2 = bnd2 & valid2
    # a boundary row on the batch side has no carried twin -> NEW
    new_row = keep2 & (side == 1)

    nh_c, nc_c, nnew, nf_c = compact_rows(
        (mh, comb_c, new_row.astype(jnp.int32), mf),
        keep2,
        fills=(FULL64, 0, 0, 0),
    )
    nh = nh_c[:s]
    nc = jnp.where(nh != FULL64, nc_c[:s], 0)
    new_in = (nnew[:s] == 1) & (nh != FULL64)
    changed = jnp.any(new_in)

    # ---- correction update at a set change ----
    num_valid = jnp.sum((nh != FULL64).astype(jnp.int32))
    m_val = nh[jnp.maximum(num_valid - 1, 0)]
    # last entry position in this batch = max first-pos of new members
    p_local = jnp.max(jnp.where(new_in, nf_c[:s], -1))
    pre_cnt = jnp.sum(jnp.where(st_h == m_val, st_c, 0))
    batch_before = jnp.sum(
        ((h == m_val) & (idx < p_local)).astype(jnp.int64)
    )
    corr_h = jnp.where(changed, m_val, corr_h)
    corr_n = jnp.where(changed, pre_cnt + batch_before, corr_n)
    return nh, nc, corr_h, corr_n, n_full_acc


def _segmented_cummax_by_sid(values_plus1, sidk):
    """Per-segment inclusive running max of ``values_plus1`` (>= 0)
    where segments are runs of the ASCENDING ``sidk``.

    One plain f64 cummax over the composite key sid*2^32 + v: rows of
    earlier segments always compare below any row of a later segment
    (their sid term is strictly smaller), so the running max never
    leaks across a segment boundary. Exact while sid*2^32 + v < 2^53.
    (An associative_scan formulation's odd/even strided slicing
    explodes the HLO at 2^25 elements.)
    """
    comp = (
        sidk.astype(jnp.float64) * 2.0**32
        + values_plus1.astype(jnp.float64)
    )
    run = jax.lax.cummax(comp)
    return (run - sidk.astype(jnp.float64) * 2.0**32).astype(
        jnp.int64
    )


@functools.partial(
    jax.jit,
    static_argnames=("n_samples", "sketch_size", "use_filter", "cap"),
)
def sketch_multi_prefix(
    h, sid, *, n_samples: int, sketch_size: int, use_filter: bool,
    cap: int,
):
    """Bottom-s prefixes of MANY samples from ONE fused program.

    Instead of one device program chain per sample, this is the
    sketch analog of the exact path's coalesced ingest: the per-instance
    hash streams of every sample arrive concatenated with a per-
    instance sample id, and one sort + run-length + per-sample-rank
    compaction produces every sample's bottom-s prefix at once (the
    reference instead threads one SelectKmersCommand heap per dataset,
    /root/reference/src/simkaMin/SimkaMinCount.hpp:1085-1123).

    Args: ``h`` [E] uint64 instance hashes (FULL64 = invalid/padding)
    in per-sample stream order (instances of one sample must appear in
    its read order; interleaving between samples is free -- the heap
    correction below only ever compares positions within a sample);
    ``sid`` [E] int32 sample ids.

    Returns (hashes [cap] u64, counts [cap] i32, n_kept [N] i64,
    n_full64 i64): sample n's prefix is the rows
    [sum_{m<n} min(n_kept[m], s), +min(n_kept[n], s)) of the compacted
    output, hash-ascending. ``cap`` must be >= min(E, N*s).
    n_full64 counts FULL64 instances -- the caller compares it to its
    independent invalid tally to detect the 2^-64 corner of a genuine
    all-ones hash (fallback: host-exact path).

    The streaming-heap count quirk of each sample's largest member
    (module docstring of minhash/sketch.py; SimkaMinCount.hpp:324) is
    applied in-program per sample, exactly as sketch_prefix_device
    does for one: for full sketches, h_max's count becomes its
    occurrences before the last heap entry of the smaller members.
    """
    E = h.shape[0]
    N = n_samples
    s = sketch_size
    idx = jnp.arange(E, dtype=jnp.int32)
    hh = (h >> jnp.uint64(32)).astype(jnp.uint32)
    hl = h.astype(jnp.uint32)
    is_full_in = (hh == jnp.uint32(0xFFFFFFFF)) & (
        hl == jnp.uint32(0xFFFFFFFF)
    )
    n_full64 = jnp.sum(is_full_in.astype(jnp.int64))
    # invalid rows sort to the end via the sentinel sample id N; the
    # (sid, hash_hi) pair packs into one u64 sort key, and pos as a
    # trailing KEY makes every run first-occurrence-ascending (no
    # reliance on sort stability)
    sidk = jnp.where(is_full_in, N, sid).astype(jnp.int32)
    key1 = (sidk.astype(jnp.uint64) << jnp.uint64(32)) | hh.astype(
        jnp.uint64
    )
    key1, hl, pos = jax.lax.sort((key1, hl, idx), num_keys=3)
    sidk = (key1 >> jnp.uint64(32)).astype(jnp.int32)
    hh = key1.astype(jnp.uint32)

    same = (key1[1:] == key1[:-1]) & (hl[1:] == hl[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~same])
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    count = _suffix_min(starts_after) - idx
    second = jnp.concatenate([pos[1:], pos[-1:]])

    is_full = sidk == N
    keep = boundary & ~is_full
    if use_filter:
        # exact >= 2 semantics; heap entry at the SECOND occurrence
        # (count initialized to 2, SimkaMinCount.hpp:353)
        keep = keep & (count >= 2)
        entry = second
    else:
        entry = pos

    # per-sample rank of each kept row: kept rows before it within its
    # sample's segment (rows are (sid, hash)-sorted, so segments are
    # contiguous and the rank is hash-ascending). EVERYTHING per-row:
    # segment arithmetic + composite cummax fills replace gathers of
    # [N] tables by sid.
    keep_i = keep.astype(jnp.int32)
    incl = jnp.cumsum(keep_i)
    excl = incl - keep_i
    seg_start = jnp.concatenate(
        [jnp.array([True]), sidk[1:] != sidk[:-1]]
    )
    # excl is non-decreasing, so the running max over segment starts
    # is the excl value at the MOST RECENT segment start
    base = jax.lax.cummax(jnp.where(seg_start, excl, -1))
    rank = excl - base
    # per-row kept-total of the row's own segment: incl at the
    # segment's LAST row (the next seg_end at or after this row)
    seg_end = jnp.concatenate(
        [sidk[1:] != sidk[:-1], jnp.array([True])]
    )
    seg_total = (
        _suffix_min(jnp.where(seg_end, incl, E + 1)) - base
    )
    sel_row = jnp.minimum(seg_total, s) - 1
    full_row = seg_total >= s

    from simka_tpu.ops.intmatmul import binned_sum

    sid_keep = jnp.where(keep, sidk, N)
    n_kept = binned_sum(keep.astype(jnp.int64), sid_keep, N, bits=1)

    # ---- per-sample h_max heap-quirk correction (full sketches) ----
    # The h_max member is the rank sel = s-1 row of a full segment;
    # its instances are exactly its RUN (boundary + duplicates). TL
    # (last heap entry + 1 among the s-1 smaller members) is the
    # segmented running max of member entry positions read AT that
    # boundary row, then forward-filled through the run with a
    # (run_id, TL) composite cummax; occurrences before the last
    # entry are then a per-row predicate, binned by sample. The
    # corrected count itself is applied on HOST to the fetched
    # prefix's last member (exactly like the streaming finalize).
    is_hmax = keep & full_row & (rank == sel_row)
    ev1 = jnp.where(keep & (rank < sel_row), entry + 1, 0)
    seg_max1 = _segmented_cummax_by_sid(ev1, sidk)
    # Two composite fills keyed by the H_MAX-run ordinal (<= N), so
    # exactness only needs n_samples * 2^(bl+1) + E < 2^53 -- E can
    # grow to the HBM plan. fillTL carries the boundary's TL through
    # everything after it; fillRID carries the boundary's run id, and
    # a row contributes only when its OWN run id matches (i.e. it is
    # inside that h_max run, not merely after it).
    run_id = jnp.cumsum(boundary.astype(jnp.int32)).astype(
        jnp.float64
    )
    hrun = jnp.cumsum(is_hmax.astype(jnp.int32)).astype(jnp.float64)
    scale = 2.0 ** (E.bit_length() + 1)  # > max(TL, run_id)
    base_h = hrun * scale
    tl_fill = jax.lax.cummax(
        base_h + jnp.where(is_hmax, seg_max1, 0).astype(jnp.float64)
    ) - base_h
    rid_fill = jax.lax.cummax(
        base_h + jnp.where(is_hmax, run_id, 0.0)
    ) - base_h
    contrib = (run_id == rid_fill) & (
        (pos.astype(jnp.float64) + 1.0) < tl_fill
    )
    n_before = binned_sum(
        contrib.astype(jnp.int64),
        jnp.where(contrib, sidk, N), N, bits=1,
    )

    out_keep = keep & (rank < s)
    from simka_tpu.ops.compact import compact_rows

    hh_c, hl_c, cnt_c = compact_rows(
        (hh, hl, count), out_keep,
        fills=(0xFFFFFFFF, 0xFFFFFFFF, 0),
    )
    hashes = (hh_c[:cap].astype(jnp.uint64) << jnp.uint64(32)) | hl_c[
        :cap
    ].astype(jnp.uint64)
    return hashes, cnt_c[:cap], n_kept, n_before, n_full64


@functools.partial(jax.jit, static_argnames=("k", "seed", "n_samples"))
def hash_packed_sid_batch(
    packed, validbits, sid_row, thresh, k: int, seed: int,
    n_samples: int,
):
    """Extract + murmur-hash one COALESCED multi-sample packed batch.

    ``sid_row`` [B] int32: per-read sample id (core.pipeline's
    coalesced ingest layout). ``thresh``: traced u64 KEEP bound --
    instances with hash <= thresh survive (FULL64-1 = keep every
    valid instance; smaller values implement the bottom-s prefilter:
    a hash above every sample's plausible s-th smallest can never
    enter a sketch, so the fused sort never sees it -- the device
    analog of a streaming heap's early reject, SimkaMinCount.hpp:324).

    Returns (h [B*W] u64 with surviving windows stably compacted to
    the front (FULL64 fills behind), sid [B*W] i32 likewise,
    n_valid i64 (pre-filter), inst_total [N] i64 per-sample valid
    instances, inst_kept [N] i64 per-sample surviving instances) --
    one fused program per batch, the sketch analog of the exact
    path's coalesced extract + valid-window compaction. The caller
    slices the compacted prefix by host-known counts so padding
    never inflates the fused sketch program's sort class.
    """
    from simka_tpu.ops.compact import compact_rows
    from simka_tpu.ops.intmatmul import binned_sum
    from simka_tpu.ops.kmers import extract_packed

    hi, lo = extract_packed(packed, validbits, k, comp_xor=2)
    h, valid = hash_kmer_words(hi.ravel(), lo.ravel(), seed=seed)
    sid_e = jnp.repeat(sid_row, hi.shape[1])
    valid = valid.ravel()
    keep = valid & (h <= thresh)
    N = n_samples
    inst_total = binned_sum(
        valid.astype(jnp.int64), jnp.where(valid, sid_e, N), N,
        bits=1,
    )
    inst_kept = binned_sum(
        keep.astype(jnp.int64), jnp.where(keep, sid_e, N), N, bits=1
    )
    h_c, sid_c = compact_rows((h, sid_e), keep, fills=(FULL64, 0))
    return (
        h_c,
        sid_c,
        jnp.sum(valid.astype(jnp.int64)),
        inst_total,
        inst_kept,
    )


@functools.partial(jax.jit, static_argnames=("n", "s_pad", "base_c"))
def assemble_sketch_grid(
    hashes, counts, offs, lens, n_before, full, *, n: int,
    s_pad: int, base_c: int,
):
    """Compacted per-sample prefixes -> [n, s_pad] padded grids, on
    device (the distance phase consumes these directly, so sketches
    never travel to the host and back).

    ``offs``/``lens`` [n] i32 (host-derived): each sample's start and
    valid length in the compacted stream; ``n_before``/``full``: the
    h_max heap-quirk correction per sample, applied to the last valid
    member here exactly as the host file-write path applies it.
    Padding rows hold FULL64 / 0 (pad_sketches layout).
    """
    pad_h = jnp.concatenate([hashes, jnp.full((s_pad,), FULL64)])
    pad_c = jnp.concatenate(
        [counts, jnp.zeros((s_pad,), counts.dtype)]
    )
    j = jnp.arange(s_pad, dtype=jnp.int32)

    def body(i, HC):
        H, C = HC
        h_i = jax.lax.dynamic_slice(pad_h, (offs[i],), (s_pad,))
        c_i = jax.lax.dynamic_slice(pad_c, (offs[i],), (s_pad,))
        m = j < lens[i]
        corr = jnp.maximum(base_c, n_before[i]).astype(c_i.dtype)
        c_i = jnp.where(
            full[i] & (j == lens[i] - 1), corr, c_i
        )
        h_i = jnp.where(m, h_i, FULL64)
        c_i = jnp.where(m, c_i, 0)
        H = jax.lax.dynamic_update_slice(H, h_i[None], (i, 0))
        C = jax.lax.dynamic_update_slice(C, c_i[None], (i, 0))
        return H, C

    H0 = jnp.full((n, s_pad), FULL64)
    C0 = jnp.zeros((n, s_pad), jnp.int32)
    return jax.lax.fori_loop(0, n, body, (H0, C0))


@functools.partial(jax.jit, static_argnames=("k", "seed"))
def hash_packed_batch(packed, validbits, k: int, seed: int):
    """Extract canonical k-mers from one 2-bit-packed read batch and
    murmur-hash them, fused in one device program (gatb encoding,
    comp_xor=2; reference hot loop SimkaMinCount.hpp:217-267).

    Returns (h [B*W] uint64 with FULL64 at invalid windows, n_valid).
    """
    from simka_tpu.ops.kmers import extract_packed

    hi, lo = extract_packed(packed, validbits, k, comp_xor=2)
    h, valid = hash_kmer_words(hi.ravel(), lo.ravel(), seed=seed)
    return h, jnp.sum(valid.astype(jnp.int64))
