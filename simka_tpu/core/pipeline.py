"""End-to-end exact-mode pipeline (the reference's `simka` executable).

Replaces the Potara multi-process orchestration
(src/SimkaPotara.hpp:259-326: parse -> setup -> config -> count ->
merge -> stats) with: host read ingestion -> device k-mer extraction ->
one fused count+join+stats program -> host distance formulas -> csv.gz.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simka_tpu.config import SimkaConfig
from simka_tpu.core.distances import compute_all_matrices
from simka_tpu.core.output import write_all_matrices
from simka_tpu.core.stats import SimkaStatistics
from simka_tpu.io.bank import (
    count_dataset_reads,
    encode_batch,
    iter_dataset_reads,
)
from simka_tpu.io.dsl import check_input_validity, parse_input_file
from simka_tpu.utils.sizeclass import pad_size_class
from simka_tpu.ops.countjoin import (
    count_join_stats,
    count_join_stats_split,
    use_split_join,
)
from simka_tpu.ops.kmers import (
    extract_canonical_kmers,
    extract_canonical_kmers_multi,
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_max_reads(read_counts: Sequence[int], max_reads: int) -> int:
    """-1: use all (0 internally); 0: auto-normalize to
    (min + mean) / 2 (reference SimkaAlgorithm::computeMaxReads,
    src/core/SimkaAlgorithm.cpp:376-445, using exact counts where the
    reference uses bank estimates); N: literal cap."""
    if max_reads == -1:
        return 0
    if max_reads == 0:
        counts = np.asarray(read_counts, np.int64)
        mean = int(counts.sum()) // len(counts)
        return (int(counts.min()) + mean) // 2
    return max_reads


def _iter_read_chunks(seqs, batch_reads: int):
    """Yield lists of <= batch_reads reads from a list, an iterator,
    or a zero-arg provider callable returning an iterator."""
    from itertools import islice

    it = iter(seqs() if callable(seqs) else seqs)
    while True:
        chunk = list(islice(it, batch_reads))
        if not chunk:
            return
        yield chunk


def extract_dataset_kmers(
    seqs,
    k: int,
    batch_reads: int = 1 << 15,
    min_kmer_shannon_index: float = 0.0,
) -> Tuple[Tuple[np.ndarray, ...], int]:
    """Encode + extract canonical k-mers for one sample.

    ``seqs``: a list of read byte strings, an iterator of them, or a
    zero-arg provider callable (the streaming ingest path -- host RSS
    stays O(batch)).

    Returns (words, n_reads): a tuple of big-endian uint32 word arrays
    covering ALL window positions (invalid ones hold SENTINEL in every
    word). Two words for k <= 31; more via the multi-word extractor
    for larger k (reference spans 32..128, CMakeLists.txt:66). Batches
    are padded to stable shape classes to bound recompilation.
    """
    parts: List[List[np.ndarray]] = []
    n_reads = 0
    for chunk in _iter_read_chunks(seqs, batch_reads):
        n_reads += len(chunk)
        max_len = max((len(s) for s in chunk), default=k)
        width = _round_up(max(max_len, k), 32)
        codes, _ = encode_batch(chunk, max_len=width)
        pad_b = _round_up(len(chunk), 256) - len(chunk)
        if pad_b:
            codes = np.concatenate(
                [codes, np.full((pad_b, width), 255, np.uint8)]
            )
        if k <= 31:
            hi, lo, _ = extract_canonical_kmers(jnp.asarray(codes), k)
            batch_words = (hi, lo)
        else:
            batch_words, _ = extract_canonical_kmers_multi(
                jnp.asarray(codes), k
            )
        if min_kmer_shannon_index > 0.0:
            # the reference parses -kmer-shannon-index but its live
            # call site is commented out (SimkaAlgorithm.hpp:226-232);
            # we apply it for real at count time, at any k
            from simka_tpu.ops.kmers import (
                SENTINEL,
                kmer_shannon_index_words,
            )

            keep = (
                kmer_shannon_index_words(batch_words, k)
                >= min_kmer_shannon_index
            )
            batch_words = tuple(
                jnp.where(keep, w, SENTINEL) for w in batch_words
            )
        if not parts:
            parts = [[] for _ in batch_words]
        for i, w in enumerate(batch_words):
            parts[i].append(np.asarray(w).ravel())
    if not parts:
        nw = 2 if k <= 31 else len(parts)
        return tuple(np.empty(0, np.uint32) for _ in range(max(nw, 2))), 0
    return tuple(np.concatenate(p) for p in parts), n_reads


def compute_statistics(
    dataset_seqs,
    dataset_ids: List[str],
    config: SimkaConfig,
    log=None,
    observer: Optional[dict] = None,
) -> SimkaStatistics:
    """Full statistics from per-dataset reads (lists or streams).

    ``dataset_seqs[s]``: a list of read byte strings OR a zero-arg
    provider callable returning an iterator (the streaming ingest
    path; host RSS stays O(batch) per dataset).

    Runs single-device (fully device-resident), or -- when the config
    requests shards / more than one local device exists -- sharded
    over the k-mer hash space with a psum reduction (bit-identical
    either way; see tests/test_sharded.py).
    """
    import jax

    from simka_tpu.core.budget import HBMBudgetExceeded

    n_shards = config.n_shards or len(jax.devices())
    try:
        if not (n_shards > 1 and len(jax.devices()) >= n_shards):
            return _compute_statistics_device(
                dataset_seqs, dataset_ids, config, log=log,
                observer=observer,
            )
        stats = _compute_statistics_sharded_device(
            dataset_seqs, dataset_ids, config, n_shards, log=log,
            observer=observer,
        )
    except HBMBudgetExceeded as e:
        # the instance stream outgrew the HBM plan mid-ingest:
        # restart through the out-of-core spectra sweep (inputs are
        # re-iterable providers; wasted ingest is bounded by the
        # budget itself)
        if log is not None:
            log(f"HBM budget: {e}; restarting out-of-core")
        return _compute_statistics_out_of_core(
            dataset_seqs, dataset_ids, config, n_shards,
            log=log, observer=observer,
        )
    if stats is not None:
        return stats
    # route capacity overflowed (vanishingly rare; see route_capacity)
    # or there were no batches: exact host-routed fallback. Requires
    # re-iterable inputs -- lists or zero-arg providers, which is what
    # every caller passes.
    return _compute_statistics_host_routed(
        dataset_seqs, dataset_ids, config, n_shards
    )


def _compute_statistics_out_of_core(
    dataset_seqs,
    dataset_ids: List[str],
    config: SimkaConfig,
    n_shards: int = 1,
    log=None,
    observer: Optional[dict] = None,
):
    """Out-of-core statistics: per-sample counted spectra, hash-range
    spill, sequential sweep -- composed with the device mesh when
    shards are available (core/sweep.py). The reference's disk
    architecture under any core/partition configuration
    (SimkaPotara.hpp:617-723); here the defended resource is HBM: one
    range's join working set fits the device plan, counting streams
    in O(batch), and spectra live in host RAM (or on disk when
    -out-tmp is set)."""
    import jax

    from simka_tpu.core.budget import spectrum_rows_budget
    from simka_tpu.core.sweep import (
        RamSpill,
        SpectrumSpill,
        filtered_solid_per_bank,
        sweep_join_stats,
    )
    from simka_tpu.ops.kmers import n_words_for_k

    k = config.kmer_size
    n = len(dataset_ids)
    nw = 2 if k <= 31 else n_words_for_k(k)
    eff_shards = (
        n_shards
        if n_shards > 1 and len(jax.devices()) >= n_shards
        else 1
    )
    budget_rows = spectrum_rows_budget(
        nw, config.max_memory_mb, eff_shards
    )

    # ---- spill tier selection: device memory > host RAM > disk. The
    # host tiers move every spectrum row between host and device
    # TWICE (count fetch + range re-upload); the device tier keeps
    # rows on the device when they fit beside the join working set.
    # The gate (a third of the plan) was set on the system's earlier
    # accelerator; not yet measured on the GPU (ROADMAP.md, reach
    # item 4). SIMKA_TPU_SPILL=device/ram overrides (tests force both
    # tiers). ----
    import os as _os

    from simka_tpu.core.budget import hbm_budget_bytes
    from simka_tpu.core.sweep import DeviceSpill

    est_rows = None
    if all(hasattr(s, "banks") for s in dataset_seqs):
        from simka_tpu.core.budget import estimate_total_instances

        est_rows = estimate_total_instances(dataset_seqs)
    env_tier = _os.environ.get("SIMKA_TPU_SPILL")
    use_device_spill = (
        not config.output_tmp_dir
        and eff_shards == 1
        and est_rows is not None
        and est_rows * 4 * (nw + 1) <= hbm_budget_bytes() // 3
    )
    if env_tier == "device":
        use_device_spill = (
            not config.output_tmp_dir and eff_shards == 1
        )
    elif env_tier in ("ram", "disk"):
        use_device_spill = False
    if use_device_spill:
        # resident spectra share HBM with each range's join: shrink
        # the per-range budget accordingly
        budget_rows = max(budget_rows * 3 // 5, 1)

    spill = None
    solid = np.zeros(n, np.int64)
    nb_reads = []
    repart = np.zeros(16, np.int64)

    if use_device_spill:
        # two samples in flight: sample i+1's native parse + device
        # dispatch overlaps sample i's programs, and the per-sample
        # row-count/stat fetches are DEFERRED to one batch at the end
        # (each fetch is a host sync)
        from concurrent.futures import ThreadPoolExecutor

        def count_one(seqs):
            return count_dataset_spectrum_device(
                seqs, k,
                min_kmer_shannon_index=config.min_kmer_shannon_index,
                defer_n_rows=True,
            )

        pool = ThreadPoolExecutor(max_workers=1)
        pending = None
        deferred = []  # (sample, solid_d, hist_d)
    for s, seqs in enumerate(dataset_seqs):
        if log is not None:
            log(f"count [{s + 1}/{n}] {dataset_ids[s]} (out-of-core)")
        if use_device_spill:
            if pending is None:
                pending = pool.submit(count_one, seqs)
            words, counts, n_rows_d, nr = pending.result()
            pending = (
                pool.submit(count_one, dataset_seqs[s + 1])
                if s + 1 < n
                else None
            )
            n_rows = (
                int(np.asarray(n_rows_d))
                if spill is None
                else words[0].shape[0]  # class sizing only
            )
        else:
            words, counts, nr = count_dataset_spectrum(
                seqs, k,
                min_kmer_shannon_index=config.min_kmer_shannon_index,
            )
            n_rows = len(counts)
        if spill is None:
            # provision ranges from the WORSE of (a) the first
            # sample's spectrum projected over all samples and (b)
            # the up-front file-size instance estimate: a small first
            # dataset must not under-provision the sweep for larger
            # later ones (ADVICE r4 #2) -- ranges cannot be re-split
            # once spilling starts, and over-provisioning only costs
            # extra (cheaper) sweep passes
            projected = max(int(n_rows * n * 1.3), 1)
            if est_rows is not None:
                projected = max(projected, est_rows)
            n_ranges = max(1, -(-projected // budget_rows))
            if use_device_spill:
                spill = DeviceSpill(n_ranges)
            elif config.output_tmp_dir:
                spill = SpectrumSpill(config.output_tmp_dir, n_ranges)
            else:
                spill = RamSpill(n_ranges)
            if log is not None:
                log(
                    f"out-of-core sweep: {n_ranges} hash ranges "
                    f"({type(spill).__name__}, projected "
                    f"{projected} rows, budget "
                    f"{budget_rows}/range, {eff_shards} shard(s))"
                )
        if use_device_spill:
            sd, hd = _spill_stats_device(
                words, counts,
                jnp.int64(config.abundance_min),
                jnp.int64(config.abundance_max),
            )
            deferred.append((s, sd, hd))
            spill.spill_sample(s, words, counts, n_rows)
        else:
            repart += repartition_histogram(
                [(words, counts)],
                config.abundance_min,
                config.abundance_max,
            )
            spill.spill_sample(s, words, counts)
            solid[s] = filtered_solid_per_bank(
                [counts], config.abundance_min, config.abundance_max
            )[0]
        nb_reads.append(nr)
    if use_device_spill:
        pool.shutdown(wait=False)
        if deferred:
            fetched = jax.device_get(
                [(sd, hd) for _, sd, hd in deferred]
            )
            for (s, _, _), (sd, hd) in zip(deferred, fetched):
                solid[s] = int(sd)
                repart += np.asarray(hd, np.int64)
    if spill is None:
        raise ValueError("no datasets")
    if observer is not None:
        observer["repartition_instances"] = repart
        observer["sweep_ranges"] = spill.n_ranges
        observer["spill_tier"] = type(spill).__name__
    js = sweep_join_stats(
        spill,
        n,
        config.abundance_min,
        config.abundance_max,
        solid,
        simple=config.simple_dist,
        complex_=config.complex_dist,
        hi_bits=max(0, 2 * k - 32) if k <= 31 else 32,
        verbose_log=log if log is not None else (lambda m: None),
        n_shards=eff_shards,
    )
    if not config.keep_tmp:
        spill.cleanup()
    return SimkaStatistics.from_join_stats(
        js,
        dataset_ids,
        k,
        np.asarray(nb_reads, np.int64),
        config.simple_dist,
        config.complex_dist,
    )


def _compute_statistics_host_routed(
    dataset_seqs,
    dataset_ids: List[str],
    config: SimkaConfig,
    n_shards: int,
) -> SimkaStatistics:
    """Sharded statistics with HOST-side hash routing (exact fallback
    for the device-routed path; also the reference layout for its
    equivalence tests)."""
    k = config.kmer_size
    word_parts: List[List[np.ndarray]] = []
    sids = []
    nb_reads = []
    for s, seqs in enumerate(dataset_seqs):
        words, n = extract_dataset_kmers(
            seqs, k,
            min_kmer_shannon_index=config.min_kmer_shannon_index,
        )
        if not word_parts:
            word_parts = [[] for _ in words]
        for i, w in enumerate(words):
            word_parts[i].append(w)
        sids.append(np.full(words[0].shape, s, np.int32))
        nb_reads.append(n)

    words = tuple(np.concatenate(p) for p in word_parts)
    sid = np.concatenate(sids) if sids else np.empty(0, np.int32)

    from simka_tpu.parallel.sharded import (
        make_mesh,
        shard_instances_by_hash,
        sharded_count_join_stats,
        sharded_count_join_stats_split,
    )

    mesh = make_mesh(n_shards)
    words_sh, sid_sh = shard_instances_by_hash(words, sid, n_shards)
    join = (
        sharded_count_join_stats_split
        if use_split_join(len(dataset_ids))
        else sharded_count_join_stats
    )
    js = join(
        words_sh,
        sid_sh,
        config.abundance_min,
        config.abundance_max,
        mesh=mesh,
        n_banks=len(dataset_ids),
        simple=config.simple_dist,
        complex_=config.complex_dist,
        hi_bits=max(0, 2 * k - 32) if k <= 31 else 32,
    )
    return SimkaStatistics.from_join_stats(
        js,
        dataset_ids,
        k,
        np.asarray(nb_reads, np.int64),
        config.simple_dist,
        config.complex_dist,
    )


def _coalesced_row_class(r: int) -> int:
    """Row class for a coalesced multi-sample batch: ~3-bit mantissa
    granularity bounds both padding waste (<= 12.5%) and the number
    of distinct extract-program shapes."""
    g = max(256, 1 << max(0, r.bit_length() - 3))
    return -(-r // g) * g


def _packed_batch_stream(
    dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads,
    timers=None, valid_tally=None, coalesce=False,
):
    """Yield packed host batches for every dataset: the native
    parse+filter+2-bit-pack single pass when the source is a
    PackedReadSource (io/packed.py), the Python encode+pack otherwise.

    Yields (sample_id:int, packed, validbits, n_valid) per batch --
    or, with ``coalesce=True``, (row_sid:np.ndarray, packed,
    validbits, n_valid) where several SAMPLES' batches of equal width
    are concatenated up to ~batch_reads rows with a per-row sample
    id. Coalescing exists for wide-N runs: without it 100 samples
    mean 100+ extract dispatches, each with its own fixed cost.

    Stage time accumulates in ``timers['parse_pack_s']``; the exact
    valid-window total (when the native counter knows it) in
    ``valid_tally`` -- poisoned to None the moment any batch's count
    is unknown."""
    from simka_tpu.io.packed import host_pack_chunk

    buf = []  # (sample, packed, vb, n_valid) awaiting coalesce
    buf_rows = 0

    def flush():
        nonlocal buf, buf_rows
        if not buf:
            return None
        if len(buf) == 1:
            sample, packed, vb, nv = buf[0]
            sid_row = np.full(packed.shape[0], sample, np.int32)
        else:
            rows = sum(b[1].shape[0] for b in buf)
            target = min(_coalesced_row_class(rows), batch_reads)
            pad = max(target - rows, 0)
            wq = buf[0][1].shape[1]
            packed = np.concatenate(
                [b[1] for b in buf]
                + ([np.zeros((pad, wq), np.uint8)] if pad else [])
            )
            vb = np.concatenate(
                [b[2] for b in buf]
                + (
                    [np.zeros((pad, wq // 2), np.uint8)]
                    if pad
                    else []
                )
            )
            sid_row = np.concatenate(
                [
                    np.full(b[1].shape[0], b[0], np.int32)
                    for b in buf
                ]
                + ([np.zeros(pad, np.int32)] if pad else [])
            )
            nv = 0
            for b in buf:
                if b[3] is None:
                    nv = None
                    break
                nv += b[3]
        buf = []
        buf_rows = 0
        return sid_row, packed, vb, nv

    def emit(sample, packed, vb, n_valid):
        """Route one source batch: straight through, or buffered."""
        if valid_tally is not None:
            if n_valid is None:
                valid_tally["n"] = None
            elif valid_tally["n"] is not None:
                valid_tally["n"] += n_valid
        if not coalesce:
            return [(sample, packed, vb, n_valid)]
        nonlocal buf, buf_rows
        out = []
        if buf and (
            buf[0][1].shape[1] != packed.shape[1]
            or buf_rows + packed.shape[0] > batch_reads
        ):
            out.append(flush())
        buf.append((sample, packed, vb, n_valid))
        buf_rows += packed.shape[0]
        if buf_rows >= batch_reads:
            out.append(flush())
        return out

    for s, src in enumerate(dataset_seqs):
        if log is not None:
            # reference count-phase progress, SimkaPotara.hpp:835
            log(
                f"count [{s + 1}/{len(dataset_seqs)}] "
                f"{dataset_ids[s]}"
            )
        t0 = time.perf_counter()
        if hasattr(src, "iter_packed"):
            for packed, vb, n, n_valid in src.iter_packed(
                batch_reads, k=k
            ):
                nb_reads[s] += n
                items = emit(s, packed, vb, n_valid)
                if timers is not None:
                    timers["parse_pack_s"] += time.perf_counter() - t0
                yield from items
                t0 = time.perf_counter()
        else:
            if valid_tally is not None:
                valid_tally["n"] = None
            for chunk in _iter_read_chunks(src, batch_reads):
                nb_reads[s] += len(chunk)
                packed, vb = host_pack_chunk(chunk, k)
                items = emit(s, packed, vb, None)
                if timers is not None:
                    timers["parse_pack_s"] += time.perf_counter() - t0
                yield from items
                t0 = time.perf_counter()
    tail = flush()
    if tail is not None:
        yield tail


def _pipelined_ingest(stream, ship, consume):
    """Three-stage ingest pipeline: parse/pack (worker A) || H2D ship
    (worker B) || device dispatch (main thread). One batch in flight
    per stage -- parse of batch i+2, ship of batch i+1 and the
    device's extraction of batch i overlap (the reference keeps its
    Bank reader ahead of the counters with a dispatcher pool,
    src/SimkaCount.cpp:188)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as parse_ex, \
            ThreadPoolExecutor(max_workers=1) as ship_ex:
        pull = lambda: next(stream, None)
        pending = parse_ex.submit(pull)
        shipped = deque()
        while True:
            item = pending.result()
            if item is not None:
                pending = parse_ex.submit(pull)
            if shipped:
                consume(*shipped.popleft().result())
            if item is None:
                break
            shipped.append(ship_ex.submit(ship, item))
        while shipped:
            consume(*shipped.popleft().result())


def _compute_statistics_sharded_device(
    dataset_seqs,
    dataset_ids: List[str],
    config: SimkaConfig,
    n_shards: int,
    batch_reads: int = 1 << 17,
    log=None,
    observer: Optional[dict] = None,
) -> Optional[SimkaStatistics]:
    """Device-resident multi-device path: packed reads broadcast to the
    mesh, k-mers extracted AND hash-routed on device, joined per shard
    with a psum reduction -- extracted words never round-trip through
    the host (the reference's Repartitor shuffle,
    src/SimkaPotara.hpp:713-723, as on-device selection instead of
    partition files). Reads stream in O(batch) host memory with the
    same double-buffered prefetch as the single-device path.

    Returns None when a routed batch overflowed its static capacity
    (probability ~e^-245 per batch, see route_capacity) or no reads
    arrived -- the caller falls back to exact host routing.
    """
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from simka_tpu.parallel.sharded import (
        device_fill,
        make_mesh,
        route_capacity,
        route_packed_batch,
        sharded_count_join_stats,
    )

    k = config.kmer_size
    from simka_tpu.core.budget import (
        HBMBudgetExceeded,
        instance_rows_budget,
    )
    from simka_tpu.ops.kmers import n_words_for_k

    mesh = make_mesh(n_shards)
    replicated = NamedSharding(mesh, P())

    batches = []  # (words_sh tuple, n_kept dev array, cap, sample id)
    nb_reads = [0] * len(dataset_seqs)
    # every device holds the concatenation of all batch caps, so the
    # per-device budget bounds the cap SUM (core/budget.py)
    rows_budget = instance_rows_budget(2 if k <= 31 else n_words_for_k(k))
    state = {"cap_sum": 0}
    timers = {
        "parse_pack_s": 0.0,
        "h2d_s": 0.0,
        "extract_dispatch_s": 0.0,
        "join_s": 0.0,
    }

    stream = _packed_batch_stream(
        dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads,
        timers=timers, coalesce=True,
    )

    def ship(item):
        sid_row, packed, vb, n_valid = item
        t0 = time.perf_counter()
        out = (
            jax.device_put(sid_row, replicated),
            jax.device_put(packed, replicated),
            jax.device_put(vb, replicated),
            n_valid,
        )
        timers["h2d_s"] += time.perf_counter() - t0
        return out

    def consume(sid_row, packed, validbits, n_valid):
        t0 = time.perf_counter()
        n_windows = packed.shape[0] * packed.shape[1] * 4
        # the native parser's exact valid-window count shrinks the
        # routed capacity (invalid windows never survive routing);
        # the Chernoff slack bounds the binomial on the VALID count
        cap = route_capacity(
            n_windows if n_valid is None else n_valid, n_shards
        )
        words_sh, sid_sh, n_kept = route_packed_batch(
            packed,
            validbits,
            sid_row,
            k,
            mesh=mesh,
            n_shards=n_shards,
            cap=cap,
            min_kmer_shannon_index=config.min_kmer_shannon_index,
        )
        batches.append((words_sh, sid_sh, n_kept, cap))
        timers["extract_dispatch_s"] += time.perf_counter() - t0
        state["cap_sum"] += cap
        if state["cap_sum"] > rows_budget:
            raise HBMBudgetExceeded(
                f"{state['cap_sum']} routed rows/device exceed the "
                f"plan of {rows_budget}"
            )

    _pipelined_ingest(stream, ship, consume)
    if observer is not None:
        observer["stage_timers"] = timers

    if not batches:
        return None
    shard_hist = np.zeros(n_shards, np.int64)
    for _, _, n_kept, cap in batches:
        kept = np.asarray(n_kept)
        shard_hist += kept.astype(np.int64)
        if int(kept.max()) > cap:
            return None  # overflow: exact fallback takes over
    if observer is not None:
        # instances per shard: the sharded-path repartition diagnostic
        # (free -- the routed kept counts double as the histogram)
        observer["repartition_instances"] = shard_hist

    nw = len(batches[0][0])
    total = sum(b[3] for b in batches)
    target = pad_size_class(total)
    pad = target - total
    word_cols = []
    for i in range(nw):
        cols = [b[0][i] for b in batches]
        if pad:
            cols.append(
                device_fill(
                    mesh, (n_shards, pad), 0xFFFFFFFF, np.uint32
                )
            )
        word_cols.append(jnp.concatenate(cols, axis=1))
    # sample ids were routed alongside the words (batches hold mixed
    # samples since the coalescing ingest), so the sid column is a
    # device-resident sharded array -- nothing ships from the host
    sid_cols = [b[1] for b in batches]
    if pad:
        sid_cols.append(
            device_fill(mesh, (n_shards, pad), 0, np.int32)
        )
    sid_sh = jnp.concatenate(sid_cols, axis=1)

    join = (
        sharded_count_join_stats_split
        if use_split_join(len(dataset_ids))
        else sharded_count_join_stats
    )
    t_join = time.perf_counter()
    js = join(
        tuple(word_cols),
        sid_sh,
        config.abundance_min,
        config.abundance_max,
        mesh=mesh,
        n_banks=len(dataset_ids),
        simple=config.simple_dist,
        complex_=config.complex_dist,
        hi_bits=max(0, 2 * k - 32) if k <= 31 else 32,
    )
    stats = SimkaStatistics.from_join_stats(
        js,
        dataset_ids,
        k,
        np.asarray(nb_reads, np.int64),
        config.simple_dist,
        config.complex_dist,
    )
    timers["join_s"] = time.perf_counter() - t_join
    return stats


import functools as _functools

import jax as _jax


@_functools.partial(
    _jax.jit,
    static_argnames=("k", "multi", "min_shannon", "with_hist"),
)
def _extract_windows_program(
    packed, validbits, row_sid, *, k: int, multi: bool,
    min_shannon: float, with_hist: bool,
):
    """One fused device program per ingest batch: unpack + canonical
    k-mer extraction + optional k-mer-shannon mask + per-row sample-id
    broadcast + optional repartition histogram, fused into one
    dispatch instead of 2-3."""
    from simka_tpu.ops.intmatmul import binned_sum
    from simka_tpu.ops.kmers import (
        SENTINEL,
        extract_packed,
        kmer_shannon_index_words,
        mix_hash,
    )

    from simka_tpu.ops.compact import compact_rows

    words = extract_packed(packed, validbits, k, multi=multi)
    if min_shannon > 0.0:
        keep = kmer_shannon_index_words(words, k) >= min_shannon
        words = tuple(jnp.where(keep, w, SENTINEL) for w in words)
    sid = jnp.broadcast_to(
        row_sid[:, None], words[0].shape
    ).ravel()
    flat = tuple(w.ravel() for w in words)
    if with_hist:
        h = flat[0]
        for w in flat[1:]:
            h = mix_hash(h, w)
        valid = flat[0] != SENTINEL
        bucket = jnp.where(
            valid, (h % jnp.uint32(16)).astype(jnp.int32), 16
        )
        hist = binned_sum(
            valid.astype(jnp.int64), bucket, 16, bits=40
        )
    else:
        hist = ()
    # valid windows compacted to the front IN the same program: when
    # the native parser's window count is host-known, the caller
    # slices each batch near its real size, so per-read width/row
    # padding never reaches the join's sort and the old global
    # compaction pass (one extra full-stream program) disappears
    nw = len(flat)
    comp = compact_rows(
        (*flat, sid),
        flat[0] != SENTINEL,
        fills=(SENTINEL,) * nw + (0,),
    )
    return comp[:nw], comp[nw], hist





@_functools.partial(
    _jax.jit, static_argnames=("k", "multi", "min_shannon")
)
def _extract_flat_program(
    packed, validbits, *, k: int, multi: bool, min_shannon: float
):
    """Fused unpack + extraction (+ optional shannon mask) for the
    COUNT phase (no sample ids: one sample per call)."""
    from simka_tpu.ops.kmers import (
        SENTINEL,
        extract_packed,
        kmer_shannon_index_words,
    )

    words = extract_packed(packed, validbits, k, multi=multi)
    if min_shannon > 0.0:
        keep = kmer_shannon_index_words(words, k) >= min_shannon
        words = tuple(jnp.where(keep, w, SENTINEL) for w in words)
    return tuple(w.ravel() for w in words)


@_functools.partial(_jax.jit, static_argnames=("out_len",))
def _compact_valid_rows(words, sid, out_len: int):
    """Compact SENTINEL rows out of the concatenated window stream and
    slice to the target class (one stable-compaction program; see
    _compute_statistics_device)."""
    from simka_tpu.ops.compact import compact_rows
    from simka_tpu.ops.kmers import SENTINEL

    nw = len(words)
    comp = compact_rows(
        (*words, sid),
        words[0] != SENTINEL,
        fills=(0xFFFFFFFF,) * nw + (0,),
    )
    return (
        tuple(c[:out_len] for c in comp[:nw]),
        comp[nw][:out_len],
    )


def _compute_statistics_device(
    dataset_seqs,
    dataset_ids: List[str],
    config: SimkaConfig,
    batch_reads: int = 1 << 17,
    log=None,
    observer: Optional[dict] = None,
) -> SimkaStatistics:
    """Single-device path: every k-mer word stays on the device from
    extraction through the fused join (no host round-trip), and reads
    STREAM through in O(batch) host memory (gatb IBank's role,
    /root/reference/src/core/SimkaCommons.hpp:159-314 -- datasets may
    be larger than host RAM).

    Ingest is DOUBLE-BUFFERED: a worker thread pulls, encodes, packs
    and ships batch i+1 while the device extracts batch i (the
    reference keeps its gatb Bank reader ahead of the counters with a
    dispatcher thread pool, src/SimkaCount.cpp:188; here the split is
    host-prep-vs-device-compute instead of reader-vs-counter).
    """
    from concurrent.futures import ThreadPoolExecutor

    from simka_tpu.core.budget import (
        HBMBudgetExceeded,
        instance_rows_budget,
    )
    from simka_tpu.ops.kmers import extract_packed, n_words_for_k

    import jax

    k = config.kmer_size
    batches = []  # (words tuple, sid flat device array)
    nb_reads = [0] * len(dataset_seqs)
    hists = []  # per-batch bucket histograms (device arrays)
    rows_budget = instance_rows_budget(2 if k <= 31 else n_words_for_k(k))
    nonlocal_rows = [0]
    timers = {
        "parse_pack_s": 0.0,
        "h2d_s": 0.0,
        "extract_dispatch_s": 0.0,
        "join_s": 0.0,
    }
    valid_tally = {"n": 0}

    def device_extract(row_sid, packed, validbits, n_valid=None):
        flat, sid, hist = _extract_windows_program(
            packed,
            validbits,
            row_sid,
            k=k,
            multi=k > 31,
            min_shannon=float(config.min_kmer_shannon_index),
            with_hist=observer is not None,
        )
        if observer is not None:
            hists.append(hist)
        if n_valid is not None:
            # windows are valid-compacted in-program; slice near the
            # native parser's count, rounded to a ~3-bit-mantissa
            # class so downstream concat shapes stay stable
            cls = _coalesced_row_class(max(int(n_valid), 1))
            if cls < flat[0].shape[0]:
                flat = tuple(w[:cls] for w in flat)
                sid = sid[:cls]
        batches.append((flat, sid))
        nonlocal_rows[0] += flat[0].shape[0]
        if nonlocal_rows[0] > rows_budget:
            # the HBM plan cannot hold the join working set (the
            # ConfigurationAlgorithm role, core/budget.py): abort to
            # the out-of-core sweep before the allocator fails
            raise HBMBudgetExceeded(
                f"{nonlocal_rows[0]} instance rows exceed the device "
                f"plan of {rows_budget}"
            )

    stream = _packed_batch_stream(
        dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads,
        timers=timers, valid_tally=valid_tally, coalesce=True,
    )

    def ship(item):
        sid_row, packed, vb, n_valid = item
        t0 = time.perf_counter()
        out = (
            jax.device_put(sid_row),
            jax.device_put(packed),
            jax.device_put(vb),
            n_valid,
        )
        timers["h2d_s"] += time.perf_counter() - t0
        return out

    def consume(sid_row, packed, vb, n_valid):
        t0 = time.perf_counter()
        device_extract(sid_row, packed, vb, n_valid)
        timers["extract_dispatch_s"] += time.perf_counter() - t0

    _pipelined_ingest(stream, ship, consume)
    if observer is not None:
        observer["stage_timers"] = timers

    if not batches:
        nw = 2 if k <= 31 else 3
        batches = [
            (
                tuple(
                    jnp.full((1,), 0xFFFFFFFF, jnp.uint32)
                    for _ in range(nw)
                ),
                jnp.zeros((1,), jnp.int32),
            )
        ]
    nw = len(batches[0][0])
    E = sum(b[0][0].shape[0] for b in batches)
    # pad to a stable size class so repeated runs reuse the program
    target = pad_size_class(E)
    pad = target - E
    sid_cols = [b[1] for b in batches]
    if pad:
        sid_cols.append(jnp.zeros((pad,), jnp.int32))
    sid = jnp.concatenate(sid_cols)
    word_cols = []
    for i in range(nw):
        cols = [b[0][i] for b in batches]
        if pad:
            cols.append(jnp.full((pad,), 0xFFFFFFFF, jnp.uint32))
        col = jnp.concatenate(cols)
        word_cols.append(col)
        # free each word's per-batch arrays as soon as its
        # concatenated column exists: at 2^26+ rows the doubled
        # residency is whole gigabytes of device memory. A lone
        # unpadded batch IS the column (concatenate returns it).
        for b in batches:
            if b[0][i] is not col:
                b[0][i].delete()

    total_valid = valid_tally["n"]
    if (
        total_valid is not None
        and pad_size_class(total_valid) < target
    ):
        # the native parser counted the exact valid windows (no device
        # sync): when they fit a smaller power-of-two class, compact
        # the SENTINEL rows out BEFORE the join's sort pays for them
        # (per-read width padding + row padding are 25-55% of the
        # stream; XLA's sort cost quantizes at the padded class)
        out_len = pad_size_class(total_valid)
        word_cols, sid = _compact_valid_rows(
            tuple(word_cols), sid, out_len=out_len
        )
        word_cols = list(word_cols)

    join = (
        count_join_stats_split
        if use_split_join(len(dataset_ids))
        else count_join_stats
    )
    t_join = time.perf_counter()
    js = join(
        tuple(word_cols[:-1]),
        word_cols[-1],
        sid,
        jnp.int32(config.abundance_min),
        jnp.int64(config.abundance_max),
        n_banks=len(dataset_ids),
        simple=config.simple_dist,
        complex_=config.complex_dist,
        # k <= 31 kmers have exactly max(0, 2k-32) payload bits in hi:
        # enables the packed single-u64-key sort fast path
        hi_bits=max(0, 2 * k - 32) if k <= 31 else 32,
    )
    if observer is not None and hists:
        total = hists[0]
        for h in hists[1:]:
            total = total + h
        observer["repartition_instances"] = np.asarray(total)
    stats = SimkaStatistics.from_join_stats(
        js,
        dataset_ids,
        k,
        np.asarray(nb_reads, np.int64),
        config.simple_dist,
        config.complex_dist,
    )
    # from_join_stats materializes every accumulator, so this spans
    # all queued device work: extraction backlog + the fused join
    timers["join_s"] = time.perf_counter() - t_join
    return stats


def compute_statistics_from_spectra(
    spectra,
    dataset_ids: List[str],
    nb_reads: List[int],
    config: SimkaConfig,
) -> SimkaStatistics:
    """Statistics from per-dataset counted spectra (checkpoint path).

    ``spectra[s]`` = (words tuple, counts) for sample s.
    """
    import jax

    word_parts: List[List[np.ndarray]] = []
    sids, cnts = [], []
    for s, (words, counts) in enumerate(spectra):
        if not word_parts:
            word_parts = [[] for _ in words]
        for i, w in enumerate(words):
            word_parts[i].append(w)
        sids.append(np.full(words[0].shape, s, np.int32))
        cnts.append(counts.astype(np.int32))
    words = tuple(np.concatenate(p) for p in word_parts)
    sid = np.concatenate(sids)
    counts = np.concatenate(cnts)

    # the host knows every count here: size the exact-einsum limbs to
    # the actual maximum (1 limb pass for typical low-coverage data
    # instead of 3 for the worst-case 32-bit bound)
    max_count = int(counts.max()) if len(counts) else 1
    count_bits = min(32, max(11, max_count.bit_length()))

    n_shards = config.n_shards or len(jax.devices())
    if n_shards > 1 and len(jax.devices()) >= n_shards:
        from simka_tpu.parallel.sharded import (
            make_mesh,
            shard_rows_by_hash,
            sharded_join_from_spectra,
            sharded_join_from_spectra_split,
        )

        mesh = make_mesh(n_shards)
        ws, ss, cs = shard_rows_by_hash(words, sid, counts, n_shards)
        if use_split_join(len(dataset_ids)):
            js = sharded_join_from_spectra_split(
                ws,
                ss,
                cs,
                config.abundance_min,
                config.abundance_max,
                mesh=mesh,
                n_banks=len(dataset_ids),
                simple=config.simple_dist,
                complex_=config.complex_dist,
                count_bits=count_bits,
                hi_bits=(
                    max(0, 2 * config.kmer_size - 32)
                    if config.kmer_size <= 31
                    else 32
                ),
            )
        else:
            js = sharded_join_from_spectra(
                ws,
                ss,
                cs,
                config.abundance_min,
                config.abundance_max,
                mesh=mesh,
                n_banks=len(dataset_ids),
                simple=config.simple_dist,
                complex_=config.complex_dist,
                count_bits=count_bits,
            )
    else:
        from simka_tpu.ops.countjoin import (
            join_stats_from_spectra,
            join_stats_from_spectra_split,
        )

        E = max(len(words[0]), 1)
        target = pad_size_class(E)
        pad = target - len(words[0])
        if pad:
            words = tuple(
                np.concatenate([w, np.full(pad, 0xFFFFFFFF, np.uint32)])
                for w in words
            )
            sid = np.concatenate([sid, np.zeros(pad, np.int32)])
            counts = np.concatenate([counts, np.zeros(pad, np.int32)])
        join = (
            join_stats_from_spectra_split
            if use_split_join(len(dataset_ids))
            else join_stats_from_spectra
        )
        js = join(
            tuple(jnp.asarray(w) for w in words),
            jnp.asarray(sid),
            jnp.asarray(counts),
            jnp.int32(config.abundance_min),
            jnp.int64(config.abundance_max),
            n_banks=len(dataset_ids),
            simple=config.simple_dist,
            complex_=config.complex_dist,
            count_bits=count_bits,
            hi_bits=(
                max(0, 2 * config.kmer_size - 32)
                if config.kmer_size <= 31
                else 32
            ),
        )
    return SimkaStatistics.from_join_stats(
        js,
        dataset_ids,
        config.kmer_size,
        np.asarray(nb_reads, np.int64),
        config.simple_dist,
        config.complex_dist,
    )


def count_dataset_spectrum(
    seqs,
    k: int,
    stream_batch_reads: int = 1 << 20,
    min_kmer_shannon_index: float = 0.0,
):
    """Count phase for one sample: extract + device sort/run-length.

    ``seqs``: list, iterator, or zero-arg provider of read byte
    strings. Samples larger than ``stream_batch_reads`` are counted
    in super-batches whose spectra are folded together on device
    (ops.spectrum.merge_spectra), bounding peak host memory by the
    batch size instead of the sample size -- the role the reference's
    ConfigurationAlgorithm memory planning plays for DSK
    (SimkaPotara.hpp:617-657).
    """
    from simka_tpu.ops.spectrum import count_spectrum, merge_spectra

    partials = []
    n_reads = 0
    if hasattr(seqs, "iter_packed") and getattr(
        seqs, "encoding", "acgt"
    ) == "acgt":
        # packed fast path: native parse+pack, fused device extraction
        # (the checkpoint and out-of-core count phases previously paid
        # the per-read Python stream)
        import jax

        parts = None
        part_rows = 0
        n_reads = 0
        for packed, vb, n, _n_valid in seqs.iter_packed(
            min(stream_batch_reads, 1 << 17), k=k
        ):
            n_reads += n
            flat = _extract_flat_program(
                jax.device_put(packed),
                jax.device_put(vb),
                k=k,
                multi=k > 31,
                min_shannon=float(min_kmer_shannon_index),
            )
            if parts is None:
                parts = [[] for _ in flat]
            for i, w in enumerate(flat):
                parts[i].append(w)
            part_rows += flat[0].shape[0]
            if part_rows >= stream_batch_reads * 32:
                partials.append(
                    count_spectrum(
                        *(jnp.concatenate(pp) for pp in parts)
                    )
                )
                parts = None
                part_rows = 0
        if parts is not None:
            partials.append(
                count_spectrum(
                    *(jnp.concatenate(pp) for pp in parts)
                )
            )
        if not partials:
            nw = 2 if k <= 31 else 3
            return (
                tuple(np.empty(0, np.uint32) for _ in range(nw)),
                np.empty(0, np.int64),
                0,
            )
        if len(partials) == 1:
            uw, counts = partials[0]
        else:
            uw, counts = merge_spectra(partials)
        return uw, counts, n_reads

    for chunk in _iter_read_chunks(seqs, stream_batch_reads):
        n_reads += len(chunk)
        words, _ = extract_dataset_kmers(
            chunk, k, min_kmer_shannon_index=min_kmer_shannon_index
        )
        partials.append(count_spectrum(*words))
    if not partials:
        words, _ = extract_dataset_kmers(
            [], k, min_kmer_shannon_index=min_kmer_shannon_index
        )
        uw, counts = count_spectrum(*words)
        return uw, counts, 0
    if len(partials) == 1:
        uw, counts = partials[0]
    else:
        uw, counts = merge_spectra(partials)
    return uw, counts, n_reads


def count_dataset_spectrum_device(
    seqs,
    k: int,
    stream_batch_reads: int = 1 << 20,
    min_kmer_shannon_index: float = 0.0,
    defer_n_rows: bool = False,
):
    """count_dataset_spectrum whose spectrum STAYS ON DEVICE
    (compacted rows + SENTINEL fills): the device-resident spill
    tier's count phase. Only the row count reaches the host -- the
    host spill tiers fetch every row (~12 B/row).

    Returns (words_d tuple, counts_d i32, n_rows, n_reads).
    """
    import jax

    from simka_tpu.ops.spectrum import (
        count_spectrum_device,
        merge_spectra_device,
    )

    partials = []
    parts = None
    part_rows = 0
    n_reads = 0
    if not (
        hasattr(seqs, "iter_packed")
        and getattr(seqs, "encoding", "acgt") == "acgt"
    ):
        # non-packed providers take the host path, then ship once
        words, counts, n_reads = count_dataset_spectrum(
            seqs, k, stream_batch_reads, min_kmer_shannon_index
        )
        return (
            tuple(jnp.asarray(w) for w in words),
            jnp.asarray(counts, jnp.int32),
            len(counts),
            n_reads,
        )
    for packed, vb, n, _n_valid in seqs.iter_packed(
        min(stream_batch_reads, 1 << 17), k=k
    ):
        n_reads += n
        flat = _extract_flat_program(
            jax.device_put(packed),
            jax.device_put(vb),
            k=k,
            multi=k > 31,
            min_shannon=float(min_kmer_shannon_index),
        )
        if parts is None:
            parts = [[] for _ in flat]
        for i, w in enumerate(flat):
            parts[i].append(w)
        part_rows += flat[0].shape[0]
        if part_rows >= stream_batch_reads * 32:
            partials.append(
                count_spectrum_device(
                    *(jnp.concatenate(pp) for pp in parts),
                    defer_n_rows=True,
                )
            )
            parts = None
            part_rows = 0
    if parts is not None:
        partials.append(
            count_spectrum_device(
                *(jnp.concatenate(pp) for pp in parts),
                defer_n_rows=True,
            )
        )
    if not partials:
        from simka_tpu.ops.kmers import n_words_for_k

        nw = 2 if k <= 31 else n_words_for_k(k)
        return (
            tuple(jnp.empty(0, jnp.uint32) for _ in range(nw)),
            jnp.empty(0, jnp.int32),
            0,
            0,
        )
    ws, cs, n_rows = merge_spectra_device(
        partials, defer_n_rows=defer_n_rows
    )
    if len(partials) == 1 and not defer_n_rows:
        import numpy as _np

        n_rows = int(_np.asarray(n_rows))
    return ws, cs, n_rows, n_reads


@functools.partial(jax.jit, static_argnames=("n_buckets",))
def _spill_stats_device(
    words, counts, abundance_min, abundance_max, n_buckets: int = 16
):
    """Per-sample spill-time statistics ON DEVICE: the post-filter
    solid total (count_synchro metadata role) and the 16-bucket
    repartition histogram (same chained mix as the host
    repartition_histogram) -- tiny fetches instead of row fetches."""
    from simka_tpu.ops.intmatmul import binned_sum
    from simka_tpu.ops.kmers import SENTINEL, mix_hash

    real = words[0] != SENTINEL
    c = counts.astype(jnp.int64)
    keep = real & (c >= abundance_min) & (c <= abundance_max)
    solid = jnp.sum(jnp.where(keep, c, 0))
    h = words[0]
    for w in words[1:]:
        h = mix_hash(h, w)
    bucket = jnp.where(
        keep,
        (h % jnp.uint32(n_buckets)).astype(jnp.int32),
        n_buckets,
    )
    hist = binned_sum(
        keep.astype(jnp.int64), bucket, n_buckets, bits=1
    )
    return solid, hist


def repartition_histogram(
    spectra_iter,
    abundance_min: int,
    abundance_max: int,
    n_buckets: int = 16,
) -> np.ndarray:
    """Distinct solid k-mers per hash bucket, summed over samples.

    Analog of the reference's printCountInfo repartition histogram
    (src/SimkaPotara.hpp:785-811), which sums each bank's
    kmercount_per_partition counts per partition: a skew diagnostic
    for the k-mer-space sharding.
    """
    from simka_tpu.parallel.sharded import _mix_hash_np

    hist = np.zeros(n_buckets, np.int64)
    for words, counts in spectra_iter:
        h = words[0]
        for w in words[1:]:
            h = _mix_hash_np(h, w)
        keep = (counts >= abundance_min) & (counts <= abundance_max)
        hist += np.bincount(
            (h[keep] % np.uint32(n_buckets)).astype(np.int64),
            minlength=n_buckets,
        )
    return hist


def count_one_dataset(d, config: SimkaConfig, cap: int, ckpt=None,
                      log=lambda m: None):
    """Count phase for one dataset: checkpoint reuse plus the
    reference's retry-x4 wrapper (simkaCountProcess,
    src/minikc/SimkaCountProcess.cpp:21-28).

    Returns (words, counts, n_reads, resumed). Shared by the
    single-host and multi-host orchestrators so both have identical
    failure-recovery and resume semantics.
    """
    key = None
    if ckpt is not None:
        from simka_tpu.core.checkpoint import count_key

        key = count_key(
            d.files,
            config.kmer_size,
            config.min_read_size,
            config.min_read_shannon_index,
            cap,
            config.min_kmer_shannon_index,
        )
        cached = ckpt.load(d.id, key)
        if cached is not None:
            words, counts, n = cached
            log(f"count {d.id}: resumed from checkpoint "
                f"({len(counts)} distinct k-mers)")
            return words, counts, n, True
    from simka_tpu.io.packed import PackedReadSource

    source = PackedReadSource(
        d.banks,
        config.min_read_size,
        config.min_read_shannon_index,
        max_reads=cap,
    )
    last_err = None
    for attempt in range(4):
        try:
            # stream packed batches through the counter (the source is
            # re-iterable per attempt); the dataset never materializes
            # on the host
            words, counts, n = count_dataset_spectrum(
                source,
                config.kmer_size,
                min_kmer_shannon_index=config.min_kmer_shannon_index,
            )
            last_err = None
            break
        except (OSError, RuntimeError) as e:
            last_err = e
            log(f"count {d.id}: attempt {attempt + 1} failed ({e}); "
                "retrying")
    if last_err is not None:
        raise last_err
    if ckpt is not None:
        ckpt.save(d.id, key, words, counts, n)
    log(f"count {d.id}: {n} reads -> {len(counts)} distinct k-mers")
    return words, counts, n, False


def run_simka(config: SimkaConfig) -> Dict[str, np.ndarray]:
    """The `simka` tool: input file -> distance matrices on disk.

    With ``output_tmp_dir`` set, per-dataset counted spectra are
    checkpointed there and reused on resume (the reference's
    sentinel-file system, SimkaPotara.hpp:838-842); ``keep_tmp``
    preserves them so later runs can add datasets without recounting.
    """
    from simka_tpu.utils.metrics import Metrics

    metrics = Metrics()
    t0 = time.time()
    datasets = parse_input_file(config.input_filename)
    check_input_validity(datasets)
    ids = [d.id for d in datasets]
    metrics.set("n_datasets", len(ids))
    metrics.set("kmer_size", config.kmer_size)

    if config.max_reads == 0:
        # auto mode: per-GROUP read counts (the reference divides each
        # dataset's read estimate by its ';'-group count,
        # SimkaPotara.hpp:646), from O(sample) bank estimates like
        # the reference's Bank::estimate (SimkaAlgorithm.cpp:428-433;
        # exact on files under the sample size) -- a full counting
        # pass would double ingest wall-clock on large inputs.
        from simka_tpu.io.bank import estimate_dataset_reads

        raw_counts = [
            estimate_dataset_reads(
                d.banks,
                config.min_read_size,
                config.min_read_shannon_index,
            )
            // max(len(d.banks), 1)
            for d in datasets
        ]
        cap = resolve_max_reads(raw_counts, 0)
    else:
        cap = resolve_max_reads([], config.max_reads)

    def log(msg):
        if config.verbose:
            print(f"[simka-tpu] {msg}", flush=True)

    if config.output_tmp_dir:
        from simka_tpu.core.checkpoint import CountCheckpoint
        from simka_tpu.core.sweep import (
            SpectrumSpill,
            choose_n_ranges,
            filtered_solid_per_bank,
            sweep_join_stats,
        )

        ckpt = CountCheckpoint(config.output_tmp_dir)
        spectra, nb_reads = [], []
        total_reads = 0
        rows_so_far = 0
        spill = None
        solid_acc = np.zeros(len(datasets), np.int64)
        import jax as _jax

        from simka_tpu.core.budget import hbm_budget_bytes

        _n_sh = config.n_shards or len(_jax.devices())
        eff_shards = (
            _n_sh
            if _n_sh > 1 and len(_jax.devices()) >= _n_sh
            else 1
        )
        # the join must fit BOTH the user's -max-memory declaration
        # and the device HBM plan (scaled by the mesh)
        budget_bytes = min(
            max(config.max_memory_mb, 1) * 1_000_000,
            hbm_budget_bytes() * eff_shards,
        )
        repart_hist = np.zeros(16, np.int64)
        with metrics.stage("count"):
            for idx, d in enumerate(datasets):
                log(f"count [{idx + 1}/{len(datasets)}] {d.id}")
                words, counts, n, resumed = count_one_dataset(
                    d, config, cap, ckpt=ckpt, log=log
                )
                repart_hist += repartition_histogram(
                    [(words, counts)],
                    config.abundance_min,
                    config.abundance_max,
                )
                if resumed:
                    metrics.count("datasets_resumed", 1)
                rows_so_far += len(counts)
                row_bytes = 4 * (len(words) + 2)
                over_budget = rows_so_far * row_bytes * 8 > budget_bytes
                if spill is None and (
                    config.sweep_ranges > 0 or over_budget
                ):
                    # switch to the out-of-core hash-range sweep: the
                    # projected in-memory join would blow the -max-
                    # memory budget (the reference's disk partitions,
                    # SimkaPotara.hpp:713-723). Project total rows
                    # from the per-sample average seen so far.
                    projected = (
                        rows_so_far * len(datasets) * 1.3 / (idx + 1)
                    )
                    n_ranges = choose_n_ranges(
                        int(projected),
                        len(words),
                        config.max_memory_mb,
                        config.sweep_ranges,
                    )
                    spill = SpectrumSpill(
                        config.output_tmp_dir, n_ranges
                    )
                    log(
                        f"out-of-core sweep: {n_ranges} hash ranges "
                        f"(projected {int(projected)} rows)"
                    )
                    for s_prev, prev in enumerate(spectra):
                        w_prev, c_prev = prev
                        spill.spill_sample(s_prev, w_prev, c_prev)
                        solid_acc[s_prev] = filtered_solid_per_bank(
                            [c_prev],
                            config.abundance_min,
                            config.abundance_max,
                        )[0]
                        spectra[s_prev] = None  # free host RAM
                if spill is not None:
                    spill.spill_sample(idx, words, counts)
                    solid_acc[idx] = filtered_solid_per_bank(
                        [counts],
                        config.abundance_min,
                        config.abundance_max,
                    )[0]
                    spectra.append(None)
                else:
                    spectra.append((words, counts))
                nb_reads.append(n)
                total_reads += n
                metrics.count("kmer_instances", int(counts.sum()))
        metrics.count("reads", total_reads)
        # reference printCountInfo (SimkaPotara.hpp:785-811): the
        # k-mer repartition over hash shards, as a skew diagnostic
        metrics.set("repartition_histogram", repart_hist.tolist())
        if repart_hist.sum():
            log(
                "kmer repartition over 16 hash buckets: "
                f"min {int(repart_hist.min())} "
                f"mean {int(repart_hist.mean())} "
                f"max {int(repart_hist.max())}"
            )
        log(f"count phase: {total_reads} reads in "
            f"{metrics.timings['count']:.2f}s")
        with metrics.stage("merge"):
            if spill is not None:
                metrics.set("sweep_ranges", spill.n_ranges)
                js = sweep_join_stats(
                    spill,
                    len(ids),
                    config.abundance_min,
                    config.abundance_max,
                    solid_acc,
                    simple=config.simple_dist,
                    complex_=config.complex_dist,
                    hi_bits=(
                        max(0, 2 * config.kmer_size - 32)
                        if config.kmer_size <= 31
                        else 32
                    ),
                    verbose_log=log,
                    n_shards=eff_shards,
                )
                stats = SimkaStatistics.from_join_stats(
                    js,
                    ids,
                    config.kmer_size,
                    np.asarray(nb_reads, np.int64),
                    config.simple_dist,
                    config.complex_dist,
                )
                if not config.keep_tmp:
                    spill.cleanup()
            else:
                stats = compute_statistics_from_spectra(
                    spectra, ids, nb_reads, config
                )
        log(f"merge+distances: {metrics.timings['merge']:.2f}s")
    else:
        # stream every dataset through the counters: no List[bytes]
        # materialization (gatb IBank streaming, SimkaCommons.hpp:159).
        # PackedReadSource adds the native parse+filter+2-bit-pack
        # single pass for the device ingest while still satisfying the
        # raw-read provider protocol for every fallback path
        from simka_tpu.io.packed import PackedReadSource

        providers = [
            PackedReadSource(
                d.banks,
                config.min_read_size,
                config.min_read_shannon_index,
                max_reads=cap,
            )
            for d in datasets
        ]
        observer: dict = {}
        from simka_tpu.core.budget import (
            estimate_total_instances,
            instance_rows_budget,
        )
        from simka_tpu.ops.kmers import n_words_for_k

        import jax as _jax

        _n_sh = config.n_shards or len(_jax.devices())
        eff_shards = (
            _n_sh
            if _n_sh > 1 and len(_jax.devices()) >= _n_sh
            else 1
        )
        nw = (
            2 if config.kmer_size <= 31
            else n_words_for_k(config.kmer_size)
        )
        est = estimate_total_instances(datasets)
        budget = instance_rows_budget(nw, eff_shards)
        with metrics.stage("count"):
            if est > budget:
                # clearly over the HBM plan: go straight out-of-core
                # (the mid-ingest guard would catch it anyway, after
                # wasting up to a budget's worth of ingest)
                log(
                    f"estimated ~{est} instances > device plan "
                    f"{budget}: out-of-core route"
                )
                stats = _compute_statistics_out_of_core(
                    providers, ids, config, eff_shards,
                    log=log if config.verbose else None,
                    observer=observer,
                )
            else:
                stats = compute_statistics(
                    providers, ids, config,
                    log=log if config.verbose else None,
                    observer=observer,
                )
        if "sweep_ranges" in observer:
            metrics.set("route", "out_of_core")
            metrics.set("sweep_ranges", observer["sweep_ranges"])
            metrics.set("spill_tier", observer["spill_tier"])
        else:
            metrics.set("route", "in_memory")
        if "stage_timers" in observer:
            # ingest/join stage breakdown: where e2e wall-clock goes
            for name, v in observer["stage_timers"].items():
                metrics.set(f"stage_{name}", round(v, 4))
        total = int(np.sum(stats.dataset_nb_reads))
        metrics.count("reads", total)
        hist = observer.get("repartition_instances")
        if hist is not None:
            # reference printCountInfo analog on the DEFAULT path too
            # (SimkaPotara.hpp:785-811): skew diagnostic of the hash
            # sharding, by k-mer instances
            metrics.set("repartition_histogram", hist.tolist())
            if hist.sum():
                log(
                    f"kmer repartition over {len(hist)} hash "
                    f"buckets: min {int(hist.min())} "
                    f"mean {int(hist.mean())} max {int(hist.max())}"
                )
        log(f"{len(ids)} datasets, {total} reads")

    with metrics.stage("output"):
        matrices = compute_all_matrices(stats)
        os.makedirs(config.output_dir, exist_ok=True)
        write_all_matrices(config.output_dir, matrices, ids)
    metrics.set("nb_distinct_kmers", stats.nb_distinct_kmers)
    metrics.save(os.path.join(config.output_dir, "simka_metrics.json"))
    if config.verbose:
        print(stats.summary())

    if config.output_tmp_dir and not config.keep_tmp:
        # the reference removes temp dirs unless -keep-tmp
        # (SimkaPotara.hpp:288-315)
        import shutil

        shutil.rmtree(
            os.path.join(config.output_tmp_dir, "count"),
            ignore_errors=True,
        )

    log(
        f"wrote {len(matrices)} matrices to {config.output_dir} "
        f"in {time.time() - t0:.2f}s"
    )
    return matrices


def run_data_info(config: SimkaConfig) -> List[Tuple[str, int]]:
    """The reference's -data-info mode (Simka.cpp:30): only compute and
    display input statistics."""
    datasets = parse_input_file(config.input_filename)
    check_input_validity(datasets)
    out = []
    for d in datasets:
        n = count_dataset_reads(
            d.banks,
            config.min_read_size,
            config.min_read_shannon_index,
        )
        out.append((d.id, n))
        if config.verbose:
            print(f"{d.id}: {n} reads")
    return out
