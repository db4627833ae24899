"""Sketch computation: seeded bottom-s MinHash with abundances.

Reference: SelectKmersCommand (src/simkaMin/SimkaMinCount.hpp:89-384).
The reference maintains a streaming max-heap of the s smallest murmur
hashes. Analysis of the update rule shows:

- membership is order-independent: any hash in the final sketch
  entered on its first (non-filter) occurrence and was never evicted
  (the heap top only decreases), so the sketch is exactly the s
  smallest distinct hashes;
- counts are total occurrence counts EXCEPT for one element: an
  occurrence is silently dropped when the heap is full and the hash
  equals the current top (the `kmerHashed < top` test at
  SimkaMinCount.hpp:324 excludes equality). Only the final sketch's
  LARGEST member can ever be the top of the full heap (the top
  decreases monotonically to it), so exactly one count needs a
  stream-order correction: occurrences of h_max arriving after every
  smaller member has entered are lost. That correction is a closed
  form over first-occurrence positions -- no sequential replay needed.

`-filter` divergence (documented): the reference interposes a Bloom
filter so only k-mers seen >= 2 times enter the sketch
(SimkaMinCount.hpp:341-382) -- approximately, with false positives
that depend on gatb-core's Bloom internals. We implement the exact
semantics (total count >= 2), which is deterministic and strictly more
accurate; byte parity with reference `-filter` runs is not guaranteed
when a Bloom false positive would have fired.

Hash input parity: the reference hashes the canonical k-mer VALUE in
gatb-core's 2-bit encoding (A=0,C=1,T=2,G=3; canonical = numeric min
under that encoding). We extract with the same encoding so hashes --
and hence sketch contents -- match exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from simka_tpu.io.bank import encode_batch
from simka_tpu.ops.kmers import extract_canonical_kmers

# gatb-core base codes: (ascii >> 1) & 3 => A=0, C=1, T=2, G=3
_GATB_LUT = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACTG", range(4)):
    _GATB_LUT[_b] = _c
    _GATB_LUT[_b + 32] = _c


def encode_batch_gatb(seqs, max_len=None):
    codes, lengths = encode_batch(seqs, max_len=max_len)
    # remap our ACGT codes to gatb's ACTG ordering: 0,1,2,3 -> 0,1,3,2
    remap = np.array([0, 1, 3, 2], dtype=np.uint8)
    valid = codes < 4
    out = codes.copy()
    out[valid] = remap[codes[valid]]
    return out, lengths


def _sketch_stream_threshold() -> int:
    """Instance count above which the sketch folds super-batches
    instead of holding the whole hash stream on the device (a sample
    larger than device memory would not fit). ~1/8 of the device plan at
    8 B/instance; SIMKA_TPU_SKETCH_STREAM_WINDOWS overrides (tests
    force it low)."""
    import os

    env = os.environ.get("SIMKA_TPU_SKETCH_STREAM_WINDOWS")
    if env:
        return max(int(env), 1)
    from simka_tpu.core.budget import hbm_budget_bytes

    return max(hbm_budget_bytes() // 64, 1 << 22)


def _bail(reason: str) -> None:
    """One stderr line when the batched sketch falls back -- the
    per-sample path is much slower at wide N, so silent fallbacks
    look like mystery regressions."""
    import sys

    print(f"[simka-tpu min] batched sketch fallback: {reason}",
          file=sys.stderr, flush=True)


def _batched_instance_limit() -> int:
    """Max total k-mer instances the coalesced multi-sample sketch
    holds on device at once. Per instance inside the fused program:
    (u64 hash, i32 sid, i32 pos) sort operands, roughly doubled for
    the sort + scan temps."""
    from simka_tpu.core.budget import hbm_budget_bytes

    # 2^27 cap bounds the fused program's sort working set; the f64
    # composite fills are exact far beyond it (minhash/device.py)
    return min(max(hbm_budget_bytes() // 48, 1 << 20), 1 << 27)


def _estimate_sample_windows(src) -> "int | None":
    """Crude upper-ish estimate of one sample's valid k-mer windows
    from its input file sizes (~1 base/byte for FASTA/FASTQ, gz ~4x;
    the gatb Bank::estimate role). Drives the bottom-s prefilter
    threshold only -- under- and over-shoot are both caught by the
    post-run trust checks."""
    import os as _os

    banks = getattr(src, "banks", None)
    if not banks:
        return None
    total = 0
    for group in banks:
        for f in group:
            try:
                size = _os.path.getsize(f)
            except OSError:
                return None
            if str(f).endswith(".gz"):
                size *= 4
            total += size
    return total


def _batched_device_sketch(
    sources,
    kmer_size: int,
    sketch_size: int,
    seed: int,
    use_filter: bool = False,
    batch_reads: int = 1 << 15,
):
    """Device half of the coalesced multi-sample sketch: coalesced
    ingest -> fused sketch_multi_prefix -> SMALL fetch (per-sample
    kept counts + correction scalars + the all-ones-corner check).

    Returns a dict bundle holding the DEVICE-resident compacted
    prefix plus host metadata -- the bulk prefix has NOT been fetched
    yet, so callers can overlap the big fetch with further device work
    (the device-resident distance phase). None = fall back to the
    per-sample path (device memory plan exceeded / 2^-64
    corner); the bundle has ``empty=True`` when no instances exist.
    """
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from simka_tpu.core.pipeline import _packed_batch_stream
    from simka_tpu.minhash.device import (
        FULL64,
        hash_packed_sid_batch,
        sketch_multi_prefix,
    )
    from simka_tpu.utils.sizeclass import pad_size_class

    import time as _time

    _t0 = _time.perf_counter()
    k = kmer_size
    n = len(sources)
    limit = _batched_instance_limit()
    nb_reads = np.zeros(n, np.int64)
    stream = _packed_batch_stream(
        sources, [str(i) for i in range(n)], k, nb_reads,
        None, batch_reads, coalesce=True,
    )

    # ---- bottom-s hash-threshold prefilter (the device analog of the
    # reference heap's early reject, SimkaMinCount.hpp:324): an
    # instance whose hash exceeds every sample's plausible s-th
    # smallest can never enter a sketch, so it never reaches the
    # fused sort. The keep probability is thresh/2^64; underfilled
    # or clipped outcomes are DETECTED afterwards (per-sample
    # instance accounting) and fall back, so the 8x slack only ever
    # costs performance, never correctness. ----
    FULLM1 = (1 << 64) - 2  # keep every valid instance (<= bound)
    thresh_int = FULLM1
    d_min = None
    for src in sources:
        est = _estimate_sample_windows(src)
        if est is None:
            d_min = None
            break
        d_min = est if d_min is None else min(d_min, est)
    # -filter (exact >= 2) sketches are bottom-s of the QUALIFYING
    # hashes, typically far fewer than s: the n_kept >= s trust
    # check would chronically fail and force the fallback, so the
    # prefilter stays off there
    if d_min and d_min > 0 and not use_filter:
        frac = min(8.0 * sketch_size / d_min, 1.0)
        if frac < 0.25:
            thresh_int = int(frac * (2.0**64))
    thresholding = thresh_int < FULLM1
    thresh = jnp.asarray(np.uint64(thresh_int))

    h_parts = []  # device [E_b] u64
    sid_parts = []  # device [E_b] i32
    nv_parts = []  # device i64 scalars
    it_parts = []  # device [N] per-sample valid-instance totals
    ik_parts = []  # device [N] per-sample surviving instances
    caps = []  # host slice caps (overflow check at the end)
    total = 0

    def pull():
        item = next(stream, None)
        if item is None:
            return None
        sid_row, packed, vb, nv = item
        return (
            jax.device_put(packed),
            jax.device_put(vb),
            jax.device_put(np.ascontiguousarray(sid_row)),
            nv,
        )

    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = ex.submit(pull)
        while True:
            res = pending.result()
            if res is None:
                break
            pending = ex.submit(pull)
            packed, vb, sid_row, nv_host = res
            h, sid_e, nv, it_b, ik_b = hash_packed_sid_batch(
                packed, vb, sid_row, thresh, k, seed, n_samples=n
            )
            rows = int(h.shape[0])
            cap_b = rows
            if thresholding:
                # the SLICE must track the binomial mean tightly or
                # the reduction evaporates (a 4x slack cap kept ~76%
                # of the stream); at these counts 1.15x + floor is
                # still hundreds of sigma above the mean, and the
                # end-of-run check catches any overflow regardless
                exp_keep = rows * (thresh_int / 2.0**64)
                cap_b = min(rows, int(1.15 * exp_keep) + 2048)
            elif nv_host is not None:
                cap_b = min(rows, int(nv_host))
            if cap_b < rows:
                h = h[:cap_b]
                sid_e = sid_e[:cap_b]
            caps.append(cap_b)
            h_parts.append(h)
            sid_parts.append(sid_e)
            nv_parts.append(nv)
            it_parts.append(it_b)
            ik_parts.append(ik_b)
            total += int(h.shape[0])
            if total > limit:
                # outgrew the multi-sample HBM plan: the per-sample
                # path has an O(s) streaming state for exactly this
                _bail("stream %d > limit %d" % (total, limit))
                return None

    if total == 0:
        return {"empty": True, "n": n}

    target = pad_size_class(total, min_bits=16)
    if target > total:
        h_parts.append(jnp.full((target - total,), FULL64))
        sid_parts.append(jnp.zeros((target - total,), jnp.int32))
    h_all = (
        jnp.concatenate(h_parts) if len(h_parts) > 1 else h_parts[0]
    )
    sid_all = (
        jnp.concatenate(sid_parts)
        if len(sid_parts) > 1
        else sid_parts[0]
    )
    import os
    import time

    dbg = os.environ.get("SIMKA_TPU_DEBUG_TIMERS") == "1"
    if dbg:
        jax.device_get(nv_parts)  # drain the ingest dispatch queue
        print(
            f"[sketch-batched] ingest(+hash dispatch) "
            f"{time.perf_counter() - _t0:.2f}s "
            f"({len(nv_parts)} batches, {total} windows)",
            flush=True,
        )
    t_ing = time.perf_counter()
    cap = min(target, n * sketch_size)
    hashes_d, cnt_d, nk_d, nb_d, nfull_d = sketch_multi_prefix(
        h_all, sid_all,
        n_samples=n, sketch_size=sketch_size,
        use_filter=use_filter, cap=cap,
    )
    # SMALL fetch: per-sample scalars + the correctness checks; the
    # bulk prefix stays on device
    n_kept, n_before, n_full64, nv_all, it_all, ik_all = (
        jax.device_get(
            (nk_d, nb_d, nfull_d, nv_parts, it_parts, ik_parts)
        )
    )
    if dbg:
        t_prog = time.perf_counter()
        print(
            f"[sketch-batched] E={target} cap={cap} "
            f"thresh_frac={thresh_int / 2.0**64:.3f} "
            f"program+scalars {t_prog - t_ing:.2f}s",
            flush=True,
        )
    n_kept = np.asarray(n_kept, np.int64)
    if thresholding:
        # (a) no batch's survivors were clipped by its slice cap;
        # (b) every sample is trustworthy: its sketch filled to s,
        #     or nothing of it was filtered at all. Otherwise the
        #     threshold may have cut into a bottom-s -> recompute
        #     without it (rare: 8x slack over the expected need).
        for cap_b, ik_b in zip(caps, ik_all):
            if int(np.asarray(ik_b).sum()) > cap_b:
                _bail(
                    "prefilter slice overflow: kept %d > cap %d"
                    % (int(np.asarray(ik_b).sum()), cap_b)
                )
                return None
        inst_total = np.sum(np.asarray(it_all, np.int64), axis=0)
        inst_kept = np.sum(np.asarray(ik_all, np.int64), axis=0)
        if not np.all(
            (n_kept >= sketch_size) | (inst_total == inst_kept)
        ):
            bad = np.nonzero(
                ~((n_kept >= sketch_size) | (inst_total == inst_kept))
            )[0]
            _bail(
                "prefilter underfill: samples %s (n_kept %s)"
                % (bad[:5].tolist(), n_kept[bad[:5]].tolist())
            )
            return None
    else:
        total_valid = int(np.sum(np.asarray(nv_all, np.int64)))
        if int(n_full64) != target - total_valid:
            # a real k-mer hashed to all-ones: indistinguishable
            # from padding on device; the caller recomputes exactly
            _bail("FULL64 corner: %d != %d"
                  % (int(n_full64), target - total_valid))
            return None
    return {
        "empty": False,
        "n": n,
        "sketch_size": sketch_size,
        "use_filter": use_filter,
        "hashes_d": hashes_d,
        "cnt_d": cnt_d,
        "n_kept": np.asarray(n_kept, np.int64),
        "n_before": np.asarray(n_before, np.int64),
    }


def fetch_batched_sketches(bundle):
    """Host half: fetch the compacted prefix (the 12 B/record bulk
    transfer) and slice/patch per sample -- the (hashes, counts)
    list every file-write path consumes."""
    import jax

    n = bundle["n"]
    if bundle["empty"]:
        return [
            (np.empty(0, np.uint64), np.empty(0, np.uint32))
        ] * n
    sketch_size = bundle["sketch_size"]
    n_kept = bundle["n_kept"]
    n_before = bundle["n_before"]
    hashes_all, cnt_all = jax.device_get(
        (bundle["hashes_d"], bundle["cnt_d"])
    )
    base_c = 2 if bundle["use_filter"] else 1
    out = []
    off = 0
    for i in range(n):
        m = int(min(n_kept[i], sketch_size))
        hashes = np.asarray(hashes_all[off : off + m])
        counts = np.asarray(cnt_all[off : off + m]).astype(np.int64)
        if n_kept[i] >= sketch_size and m >= 1:
            # streaming-heap quirk of the largest member (module
            # docstring): its device count is the RAW total;
            # occurrences after the last smaller-member heap entry
            # are dropped by the reference -- patch from the
            # in-program occurrence count, exactly like the
            # streaming finalize does
            counts[-1] = max(base_c, int(n_before[i]))
        out.append((hashes, counts.astype(np.uint32)))
        off += m
    return out


def compute_sketches_batched(
    sources,
    kmer_size: int,
    sketch_size: int,
    seed: int,
    use_filter: bool = False,
    batch_reads: int = 1 << 15,
):
    """Bottom-s sketches of MANY samples via coalesced device batches.

    The wide-N path: the per-sample sketch path pays several host
    syncs per sample (dispatches + the prefix fetch). Here every
    sample's packed reads ride the SAME coalesced batches (per-row
    sample ids, exactly like the exact pipeline's ingest,
    core/pipeline.py:361-480), the per-instance (hash, sid) stream
    accumulates on device, and ONE fused program + ONE transfer
    produce every sample's sketch (minhash/device.sketch_multi_prefix;
    the reference threads one SelectKmersCommand per dataset instead,
    SimkaMinCount.hpp:1085-1123).

    ``sources``: list of PackedReadSource (gatb encoding). Returns a
    list of (hashes, counts) per sample, or None when the caller must
    fall back to the per-sample path: the total instance stream
    outgrew the HBM plan (the O(s) streaming state there has no
    multi-sample analog), or a genuine all-ones murmur hash made
    device padding ambiguous (the 2^-64 corner).
    """
    bundle = _batched_device_sketch(
        sources, kmer_size, sketch_size, seed, use_filter,
        batch_reads,
    )
    if bundle is None:
        return None
    return fetch_batched_sketches(bundle)


def compute_sketch(
    seqs,
    kmer_size: int,
    sketch_size: int,
    seed: int,
    use_filter: bool = False,
    batch_reads: int = 1 << 15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bottom-s sketch of one sample, device-resident.

    ``seqs``: list, iterator, or zero-arg provider of read byte
    strings (streamed in O(batch) host memory).

    The pipeline is the SimkaMin analog of the exact pipeline's
    ingest: a prefetch thread encodes + 2-bit packs + ships batch i+1
    while the device extracts AND murmur-hashes batch i in one fused
    program; the per-instance hash stream stays on device through the
    spectrum sort, and only the bottom-s prefix (plus scalars) is
    fetched (round 2 fetched the full stream twice per sample; the
    reference threads one SelectKmersCommand per dataset instead,
    SimkaMinCount.hpp:1085-1123).

    The 2^-64 corner of a GENUINE all-ones murmur hash (which the
    device stream cannot distinguish from invalid-window padding)
    falls back to the host-exact path -- ``seqs`` must be re-iterable
    (a list or provider; every product caller passes one) for that
    branch.

    Returns (hashes ascending uint64, counts uint32), length <= s.
    """
    from concurrent.futures import ThreadPoolExecutor
    from itertools import islice

    import jax
    import jax.numpy as jnp

    from simka_tpu.minhash.device import (
        FULL64,
        hash_packed_batch,
        sketch_prefix_device,
        sketch_stream_step,
    )
    from simka_tpu.ops.kmers import pack_codes_host

    k = kmer_size
    parts = []  # device [E_b] uint64 hash streams
    n_valid_parts = []  # device scalars
    total_windows = 0
    stream_threshold = _sketch_stream_threshold()
    pending_windows = 0
    padded_total = 0
    state = None  # streaming (st_h, st_c, corr_h, corr_n, n_full)
    filter_overflow = False

    def fold_pending():
        """Fold the pending parts into the O(s) streaming state (one
        fused sort+merge program per super-batch; the instance stream
        never accumulates past the threshold)."""
        nonlocal parts, pending_windows, padded_total, state
        if not parts:
            return
        tw = sum(int(p.shape[0]) for p in parts)
        from simka_tpu.utils.sizeclass import pad_size_class

        target = pad_size_class(tw, min_bits=16)
        if target > tw:
            parts.append(jnp.full((target - tw,), FULL64))
        stream = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        padded_total += target
        if state is None:
            state = (
                jnp.full((sketch_size,), FULL64),
                jnp.zeros((sketch_size,), jnp.int64),
                FULL64,
                jnp.int64(0),
                jnp.int64(0),
            )
        state = sketch_stream_step(
            stream, *state, sketch_size=sketch_size
        )
        parts = []
        pending_windows = 0

    if (
        hasattr(seqs, "iter_packed")
        and getattr(seqs, "encoding", "") == "gatb"
    ):
        # native parse+filter+2-bit-pack single pass (gatb base codes
        # for murmur hash-input parity); no Python read objects
        packed_iter = seqs.iter_packed(batch_reads, k=k)

        def pull_and_prep():
            item = next(packed_iter, None)
            if item is None:
                return None
            packed, vb, _n, _nv = item
            return jax.device_put(packed), jax.device_put(vb)

    else:
        it = iter(seqs() if callable(seqs) else seqs)

        def pull_and_prep():
            chunk = list(islice(it, batch_reads))
            if not chunk:
                return None
            max_len = max((len(s) for s in chunk), default=k)
            width = -(-max(max_len, k) // 8) * 8
            # gatb base encoding (A=0,C=1,T=2,G=3): hash-input parity
            codes, _ = encode_batch_gatb(chunk, max_len=width)
            pad_b = -(-len(chunk) // 256) * 256 - len(chunk)
            if pad_b:
                codes = np.concatenate(
                    [codes, np.full((pad_b, width), 255, np.uint8)]
                )
            packed, validbits = pack_codes_host(codes)
            return jax.device_put(packed), jax.device_put(validbits)

    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = ex.submit(pull_and_prep)
        while True:
            res = pending.result()
            if res is None:
                break
            pending = ex.submit(pull_and_prep)
            packed, validbits = res
            # comp_xor=2: gatb complements A<->T (0<->2), C<->G (1<->3)
            h, n_valid = hash_packed_batch(packed, validbits, k, seed)
            total_windows += int(h.shape[0])
            parts.append(h)
            n_valid_parts.append(n_valid)
            pending_windows += int(h.shape[0])
            if pending_windows >= stream_threshold:
                if use_filter:
                    # the exact >=2 filter needs global counts of
                    # hashes an O(s) bottom-s state cannot bound;
                    # oversized filtered samples run the host-exact
                    # path (host-RAM bound instead of HBM)
                    filter_overflow = True
                    break
                fold_pending()

    if filter_overflow:
        return _compute_sketch_host(
            seqs, kmer_size, sketch_size, seed, use_filter, batch_reads
        )
    if state is not None:
        # ---- streaming finalize ----
        fold_pending()
        st_h, st_c, corr_h, corr_n, n_full = state
        total_valid = sum(int(np.asarray(v)) for v in n_valid_parts)
        if int(np.asarray(n_full)) != padded_total - total_valid:
            # a real k-mer hashed to all-ones: indistinguishable from
            # padding on device; recompute exactly on host
            return _compute_sketch_host(
                seqs, kmer_size, sketch_size, seed, use_filter,
                batch_reads,
            )
        hashes_all = np.asarray(st_h)
        counts_all = np.asarray(st_c).astype(np.int64)
        n_members = int((hashes_all != np.uint64(FULL64)).sum())
        if n_members == 0:
            return np.empty(0, np.uint64), np.empty(0, np.uint32)
        hashes = hashes_all[:n_members].copy()
        out_counts = counts_all[:n_members]
        if n_members >= sketch_size:
            # streaming-heap quirk of the largest member, folded
            # incrementally at the last set-changing batch; the
            # carried correction MUST belong to the final largest
            # member -- if the invariant ever breaks, recompute
            # exactly on host rather than emit a silently wrong count
            # (an assert would vanish under python -O)
            if int(np.asarray(corr_h)) != int(hashes[-1]):
                return _compute_sketch_host(
                    seqs, kmer_size, sketch_size, seed, use_filter,
                    batch_reads,
                )
            out_counts[-1] = max(1, int(np.asarray(corr_n)))
        return hashes, out_counts.astype(np.uint32)

    if not parts:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)

    # stable size classes bound recompiles of the spectrum program
    from simka_tpu.utils.sizeclass import pad_size_class

    target = pad_size_class(total_windows)
    pad = target - total_windows
    if pad:
        parts.append(jnp.full((pad,), FULL64))
    stream = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    hashes_d, cnt_d, _ent_d, n_distinct_d, n_full64_d = (
        sketch_prefix_device(
            stream, sketch_size=sketch_size, use_filter=use_filter
        )
    )
    # ONE transfer for everything (the h_max heap-quirk correction is
    # applied in-program)
    hashes_all, counts_all, n_distinct, n_full64, valid_parts = (
        jax.device_get(
            (
                hashes_d,
                cnt_d,
                n_distinct_d,
                n_full64_d,
                n_valid_parts,
            )
        )
    )
    n_distinct = int(n_distinct)
    total_valid = int(np.sum(np.asarray(valid_parts, np.int64)))
    if int(n_full64) != target - total_valid:
        # a real k-mer hashed to all-ones: indistinguishable from
        # padding on device; recompute exactly on host
        return _compute_sketch_host(
            seqs, kmer_size, sketch_size, seed, use_filter, batch_reads
        )
    if n_distinct == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)

    s = min(sketch_size, n_distinct)
    return (
        np.asarray(hashes_all)[:s].copy(),
        np.asarray(counts_all)[:s].astype(np.uint32),
    )


def _compute_sketch_host(
    seqs,
    kmer_size: int,
    sketch_size: int,
    seed: int,
    use_filter: bool = False,
    batch_reads: int = 1 << 15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side reference sketcher (exact oracle for the device path;
    also the FULL64-corner fallback of compute_sketch)."""
    from itertools import islice

    k = kmer_size
    hash_parts = []
    it = iter(seqs() if callable(seqs) else seqs)
    while True:
        chunk = list(islice(it, batch_reads))
        if not chunk:
            break
        max_len = max((len(s) for s in chunk), default=k)
        width = -(-max(max_len, k) // 32) * 32
        codes, _ = encode_batch_gatb(chunk, max_len=width)
        pad_b = -(-len(chunk) // 256) * 256 - len(chunk)
        if pad_b:
            codes = np.concatenate(
                [codes, np.full((pad_b, width), 255, np.uint8)]
            )
        import jax.numpy as jnp

        from simka_tpu.minhash.device import hash_kmer_words

        # comp_xor=2: gatb encoding complements A<->T (0<->2), C<->G (1<->3)
        hi, lo, _ = extract_canonical_kmers(
            jnp.asarray(codes), k, comp_xor=2
        )
        h, valid = hash_kmer_words(hi, lo, seed=seed)
        h = np.asarray(h).ravel()
        hash_parts.append(h[np.asarray(valid).ravel()])
    if not hash_parts:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)

    # per-INSTANCE hash stream in read order (the h_max correction
    # below depends on occurrence positions); grouping runs on device
    stream = np.concatenate(hash_parts)
    if len(stream) == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    from simka_tpu.ops.spectrum import hash_spectrum

    uniq, counts, first_idx, second_idx = hash_spectrum(
        (stream >> np.uint64(32)).astype(np.uint32),
        (stream & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )

    entry_pos = first_idx
    base = 1
    if use_filter:
        # exact >= 2 semantics; a member's heap entry happens at its
        # SECOND occurrence (count initialized to 2,
        # SimkaMinCount.hpp:353)
        keep = counts >= 2
        uniq, counts = uniq[keep], counts[keep]
        entry_pos = second_idx[keep]
        base = 2

    if len(uniq) == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)

    # uniq is already hash-ascending: the bottom-s sketch is a prefix
    s = min(sketch_size, len(uniq))
    hashes = uniq[:s].copy()
    out_counts = counts[:s].astype(np.int64)

    if len(uniq) >= sketch_size and s >= 1:
        # the largest member stops counting once every smaller member
        # has entered the (full) heap: from then on it IS the top and
        # `hash < top` fails (SimkaMinCount.hpp:324)
        h_max = hashes[s - 1]
        if s >= 2:
            t_last = int(entry_pos[: s - 1].max())
        else:
            t_last = 0
        n_before = int(np.count_nonzero(stream[:t_last] == h_max))
        out_counts[s - 1] = max(base, n_before)

    return hashes, out_counts.astype(np.uint32)
