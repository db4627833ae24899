"""Multi-device execution: k-mer-space sharding over a device mesh.

The reference shards the k-mer space into partitions via a minimizer
repartition table and runs one merge process per partition
(src/SimkaPotara.hpp:713-723, 974-1124), synchronizing through the
filesystem. Here each device owns a disjoint hash range of the k-mer
space; every device runs the same fused count/join program on its
shard and the final `SimkaStatistics` reduction is a ``psum``
(the reference's `operator+=`, src/core/SimkaDistance.cpp:156-213).

Because every accumulator is an order-independent integer sum
(see ops/countjoin.py), results are bit-identical for any device count
-- the device version of the reference's resource-invariance test.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from simka_tpu.ops.compact import compact_rows
from simka_tpu.ops.countjoin import (
    JoinStats,
    Prejoin,
    _join_stats_from_split,
    count_join_prejoin,
    count_join_stats,
    join_spectra_prejoin,
    join_stats_from_spectra,
    pair_stats_shared,
    shared_size_class,
)
from simka_tpu.ops.kmers import SENTINEL, extract_packed, mix_hash


def make_mesh(n_devices: int = 0, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("shards",))


def _mix_hash_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host copy of ops.kmers.mix_hash (numpy, uint32 wraparound)."""
    with np.errstate(over="ignore"):
        h = (hi ^ np.uint32(0x9E3779B9)) * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = (h ^ lo) * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h


def shard_instances_by_hash(
    words,
    sid: np.ndarray,
    n_shards: int,
    pad_multiple: int = 1024,
    hash_words: int = 0,
):
    """Route k-mer instances to shards by hash (host-side, exact).

    All instances of a given k-mer land on the same shard, which is the
    property that makes per-shard counting exact (the reference gets it
    from the shared Repartitor, src/SimkaCount.cpp:218-228).

    Args:
      words: tuple of big-endian uint32 word arrays [E] (2 for k<=31).

    Returns (words_sh, sid_sh): tuple of [n_shards, E_shard] arrays
    padded with SENTINEL rows, plus the shard-major sample ids.
    """
    words = tuple(words)
    first = words[0]
    valid = first != np.uint32(0xFFFFFFFF)
    key_words = words[: hash_words or len(words)]
    h = key_words[0]
    for w in key_words[1:]:
        h = _mix_hash_np(h, w)
    shard = np.where(valid, h % np.uint32(n_shards), n_shards).astype(
        np.int64
    )
    order = np.argsort(shard, kind="stable")
    shard_sorted = shard[order]
    counts = np.bincount(shard_sorted, minlength=n_shards + 1)[:n_shards]
    cap = int(counts.max()) if len(counts) else 0
    cap = max(pad_multiple, -(-cap // pad_multiple) * pad_multiple)

    out_words = tuple(
        np.full((n_shards, cap), 0xFFFFFFFF, np.uint32) for _ in words
    )
    out_sid = np.zeros((n_shards, cap), np.int32)
    start = 0
    for s in range(n_shards):
        n = int(counts[s])
        sel = order[start : start + n]
        for ow, w in zip(out_words, words):
            ow[s, :n] = w[sel]
        out_sid[s, :n] = sid[sel]
        start += n
    return out_words, out_sid


def sharded_count_join_stats(
    words_sh,
    sid_sh,
    abundance_min,
    abundance_max,
    *,
    mesh: Mesh,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    hi_bits: int = 32,
) -> JoinStats:
    """Run the fused count/join on every shard and psum-reduce.

    Inputs are tuples of [n_shards, E_shard] word arrays laid out along
    the mesh's 'shards' axis (the device-routed ingest also routes the
    sample ids, so ``sid_sh`` is a sharded matrix too). Every
    JoinStats field is additive over disjoint k-mer sets, so a single
    psum yields global statistics.
    """
    words_sh = tuple(words_sh)
    nw = len(words_sh)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple(P("shards") for _ in range(nw)),
            P("shards"),
            P(),
            P(),
        ),
        out_specs=jax.tree.map(
            lambda _: P(), JoinStats(*[0] * len(JoinStats._fields))
        ),
    )
    def step(words, sid, amin, amax):
        # psum_axis makes the per-bank totals global BEFORE the pair
        # terms consume them, then reduces every pairwise accumulator
        return count_join_stats(
            tuple(w[0] for w in words[:-1]),
            words[-1][0],
            sid[0],
            amin,
            amax,
            n_banks=n_banks,
            simple=simple,
            complex_=complex_,
            vary_axes=("shards",),
            psum_axis="shards",
            hi_bits=hi_bits,
        )

    return step(
        tuple(jnp.asarray(w) for w in words_sh),
        jnp.asarray(sid_sh),
        jnp.asarray(abundance_min, jnp.int32),
        jnp.asarray(abundance_max, jnp.int64),
    )


def _sharded_split_join(
    prejoin_step,
    prejoin_args,
    *,
    mesh: Mesh,
    n_banks: int,
    simple: bool,
    complex_: bool,
    count_bits: int,
    solid_override=None,
) -> JoinStats:
    """Shared program-B half of the sharded two-program join: size the
    pair pass from the max per-shard shared-row count, run it under
    shard_map with a psum, and assemble. ``solid_override``: GLOBAL
    per-bank solid totals injected when this join only sees one hash
    range of the k-mer space (the out-of-core sweep)."""
    pre = prejoin_step(*prejoin_args)
    if jax.process_count() > 1:
        # n_rows_shared spans every process's devices; fetching it
        # directly raises (found by the real 2-process CI test,
        # tests/test_multiprocess_distributed.py). Reduce the local
        # shards and allgather the max -- every process must agree on
        # the program-B size class.
        from jax.experimental import multihost_utils

        local_max = max(
            (
                int(np.asarray(s.data).max())
                for s in pre.n_rows_shared.addressable_shards
            ),
            default=0,
        )
        n_max = int(
            multihost_utils.process_allgather(
                np.asarray([local_max], np.int64)
            ).max()
        )
    else:
        n_max = int(np.asarray(pre.n_rows_shared).max())
    E = pre.sid_shared.shape[1]
    cap = shared_size_class(n_max, E)

    nw = len(pre.words_shared)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple(P("shards", None) for _ in range(nw)),
            P("shards", None),
            P("shards", None),
            P(),
            P(),
        ),
        out_specs={
            k: P()
            for k in (
                "shared_kmers_ab",
                "shared_kmers_ba",
                "shared_distinct",
                "bray",
                "chord",
                "hellinger",
                "whittaker",
                "whittaker_s12",
                "kl",
            )
        },
    )
    def pair_step(words, sid, cnt, solid, max_cnt):
        return pair_stats_shared(
            tuple(w[0] for w in words),
            sid[0],
            cnt[0],
            solid,
            max_cnt,
            n_banks=n_banks,
            simple=simple,
            complex_=complex_,
            count_bits=count_bits,
            vary_axes=("shards",),
            psum_axis="shards",
        )

    solid = (
        pre.solid_per_bank
        if solid_override is None
        else jnp.asarray(solid_override, jnp.int64)
    )
    acc = pair_step(
        tuple(w[:, :cap] for w in pre.words_shared),
        pre.sid_shared[:, :cap],
        pre.cnt_shared[:, :cap],
        solid,
        pre.max_count,
    )
    return _join_stats_from_split(pre, acc)


def _prejoin_out_specs(nw: int):
    return Prejoin(
        words_shared=tuple(P("shards", None) for _ in range(nw)),
        sid_shared=P("shards", None),
        cnt_shared=P("shards", None),
        n_rows_shared=P("shards"),
        nb_distinct=P(),
        nb_shared=P(),
        distinct_per_bank=P(),
        solid_per_bank=P(),
        chord_n2_per_bank=P(),
        whittaker_all=P(),
        max_count=P(),
    )


def sharded_count_join_stats_split(
    words_sh,
    sid_sh,
    abundance_min,
    abundance_max,
    *,
    mesh: Mesh,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    count_bits: int = 32,
    hi_bits: int = 32,
) -> JoinStats:
    """Singleton-pruned two-program variant of sharded_count_join_stats
    (the reference's nbBankThatHaveKmer > 1 insert gate composed with
    hash sharding): program A per shard drops singleton segments and
    returns exact kept counts; the host sizes program B to the max
    shard's shared rows; program B psum-reduces the pair matrices."""
    words_sh = tuple(words_sh)
    nw = len(words_sh)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple(P("shards") for _ in range(nw)),
            P("shards"),
            P(),
            P(),
        ),
        out_specs=_prejoin_out_specs(nw),
    )
    def pre_step(words, sid, amin, amax):
        pre = count_join_prejoin(
            tuple(w[0] for w in words[:-1]),
            words[-1][0],
            sid[0],
            amin,
            amax,
            n_banks=n_banks,
            hi_bits=hi_bits,
            vary_axes=("shards",),
            psum_axis="shards",
            complex_=complex_,
        )
        return pre._replace(
            words_shared=tuple(w[None, :] for w in pre.words_shared),
            sid_shared=pre.sid_shared[None, :],
            cnt_shared=pre.cnt_shared[None, :],
            n_rows_shared=pre.n_rows_shared[None],
        )

    return _sharded_split_join(
        pre_step,
        (
            tuple(jnp.asarray(w) for w in words_sh),
            jnp.asarray(sid_sh),
            jnp.asarray(abundance_min, jnp.int32),
            jnp.asarray(abundance_max, jnp.int64),
        ),
        mesh=mesh,
        n_banks=n_banks,
        simple=simple,
        complex_=complex_,
        count_bits=count_bits,
    )


def sharded_join_from_spectra_split(
    words_sh,
    sid_sh,
    counts_sh,
    abundance_min,
    abundance_max,
    solid_override=None,
    *,
    mesh: Mesh,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    count_bits: int = 32,
    hi_bits: int = 32,
) -> JoinStats:
    """Singleton-pruned two-program variant of
    sharded_join_from_spectra (checkpoint/resume path)."""
    words_sh = tuple(words_sh)
    nw = len(words_sh)

    has_override = solid_override is not None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple(P("shards") for _ in range(nw)),
            P("shards"),
            P("shards"),
            P(),
            P(),
            P(),
        ),
        out_specs=_prejoin_out_specs(nw),
    )
    def pre_step(words, sid, counts, amin, amax, solid_ov):
        pre = join_spectra_prejoin(
            tuple(w[0] for w in words),
            sid[0],
            counts[0],
            amin,
            amax,
            # the exact-wrap Whittaker all-rows term needs GLOBAL
            # totals; under the sweep each shard only sees one hash
            # range, so psum'd in-program totals are range-local
            solid_ov if has_override else None,
            n_banks=n_banks,
            hi_bits=hi_bits,
            vary_axes=("shards",),
            psum_axis="shards",
            complex_=complex_,
        )
        return pre._replace(
            words_shared=tuple(w[None, :] for w in pre.words_shared),
            sid_shared=pre.sid_shared[None, :],
            cnt_shared=pre.cnt_shared[None, :],
            n_rows_shared=pre.n_rows_shared[None],
        )

    return _sharded_split_join(
        pre_step,
        (
            tuple(jnp.asarray(w) for w in words_sh),
            jnp.asarray(sid_sh),
            jnp.asarray(counts_sh),
            jnp.asarray(abundance_min, jnp.int32),
            jnp.asarray(abundance_max, jnp.int64),
            jnp.asarray(
                solid_override
                if has_override
                else np.zeros(n_banks, np.int64),
                jnp.int64,
            ),
        ),
        mesh=mesh,
        n_banks=n_banks,
        simple=simple,
        complex_=complex_,
        count_bits=count_bits,
        solid_override=solid_override,
    )


@functools.lru_cache(maxsize=128)
def _fill_program(mesh: Mesh, shape, value, dtype_name: str):
    sharding = jax.sharding.NamedSharding(mesh, P("shards", None))
    return jax.jit(
        lambda: jnp.full(shape, value, jnp.dtype(dtype_name)),
        out_shardings=sharding,
    )


def device_fill(mesh: Mesh, shape, value, dtype):
    """A [n_shards, ...] constant created ON the mesh (no H2D): padding
    the routed batches to a stable size class would otherwise ship
    n_shards x pad columns from the host."""
    return _fill_program(mesh, tuple(shape), value, np.dtype(dtype).name)()


def route_capacity(n_windows: int, n_shards: int) -> int:
    """Static per-shard row capacity for one routed batch.

    A uniform 32-bit mix hash splits E windows ~binomially across
    shards; mean E/n plus 30% slack plus a 4096 absolute floor puts the
    overflow probability far below any practical concern (Chernoff:
    P[Bin(E, 1/n) > 1.3 E/n + 4096] < e^-245 already at E/n = 2^13).
    Overflow is still DETECTED exactly (route_packed_batch returns the
    true kept count) and the caller falls back to host routing, so
    correctness never rests on this bound.
    """
    cap = int(n_windows / n_shards * 1.3) + 4096
    cap = -(-cap // 1024) * 1024
    return min(cap, max(1024, -(-n_windows // 1024) * 1024))


@functools.lru_cache(maxsize=64)
def _route_program(
    mesh: Mesh,
    k: int,
    n_shards: int,
    cap: int,
    min_kmer_shannon_index: float,
):
    from simka_tpu.ops.kmers import n_words_for_k

    nw = 2 if k <= 31 else n_words_for_k(k)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(
            tuple(P("shards", None) for _ in range(nw)),
            P("shards", None),
            P("shards"),
        ),
    )
    def route(packed, validbits, row_sid):
        words = extract_packed(packed, validbits, k, multi=k > 31)
        # per-row sample ids broadcast to windows and ROUTED alongside
        # the words: batches may hold several samples (the wide-N
        # ingest coalesces them to amortize dispatch latency)
        sid = jnp.broadcast_to(
            row_sid[:, None], words[0].shape
        ).ravel()
        words = tuple(w.ravel() for w in words)
        if min_kmer_shannon_index > 0.0:
            from simka_tpu.ops.kmers import kmer_shannon_index_words

            keep_sh = (
                kmer_shannon_index_words(words, k)
                >= min_kmer_shannon_index
            )
            words = tuple(
                jnp.where(keep_sh, w, SENTINEL) for w in words
            )
        h = words[0]
        for w in words[1:]:
            h = mix_hash(h, w)
        my = jax.lax.axis_index("shards").astype(jnp.uint32)
        keep = (words[0] != SENTINEL) & (
            h % jnp.uint32(n_shards) == my
        )
        comp = compact_rows(
            (*words, sid),
            keep,
            fills=(0xFFFFFFFF,) * nw + (0,),
            vary_axes=("shards",),
        )
        n_kept = jnp.sum(keep.astype(jnp.int32))
        return (
            tuple(c[:cap][None, :] for c in comp[:nw]),
            comp[nw][:cap][None, :],
            n_kept[None],
        )

    return route


def route_packed_batch(
    packed,
    validbits,
    row_sid,
    k: int,
    *,
    mesh: Mesh,
    n_shards: int,
    cap: int,
    min_kmer_shannon_index: float = 0.0,
):
    """Device-resident shard routing of one 2-bit-packed read batch.

    The packed reads (0.25 B/base + 1 bit/base validity) are broadcast
    to every device; each device extracts ALL canonical k-mers and
    keeps only the ones whose mix-hash lands in its shard, stably
    compacted to a static [cap] slice. Recompute-over-communicate:
    extraction is one cheap fused VPU pass, so duplicating it across
    shards beats a dynamically-sized all_to_all of extracted words --
    and the extracted words never touch the host (the round-2
    single-device property, now on the sharded path; the reference's
    equivalent shuffle is the Repartitor-driven partition-file write,
    src/SimkaPotara.hpp:713-723).

    Returns (words_sh, sid_sh, n_kept): tuples of [n_shards, cap]
    arrays laid out on the mesh (SENTINEL-padded words, routed sample
    ids), plus the exact per-shard kept counts [n_shards] for
    overflow detection (n_kept > cap means the slice dropped rows and
    the caller must fall back to exact host routing).
    """
    route = _route_program(
        mesh, k, n_shards, cap, min_kmer_shannon_index
    )
    return route(packed, validbits, row_sid)


def shard_rows_by_hash(words, sid, counts, n_shards: int):
    """Route pre-counted spectrum rows to shards (same hash routing as
    instances; counts ride along)."""
    words = tuple(words)
    words_sh, sid_sh = shard_instances_by_hash(
        words + (counts.astype(np.uint32),),
        sid,
        n_shards,
        hash_words=len(words),  # hash the KMER only, not the count
    )
    # counts were carried as an extra "word"; peel them off (padding
    # rows got the 0xFFFFFFFF fill -- harmless, their first word is
    # SENTINEL so they are dropped in the kernel)
    return words_sh[:-1], sid_sh, words_sh[-1].astype(np.int32)


def sharded_join_from_spectra(
    words_sh,
    sid_sh,
    counts_sh,
    abundance_min,
    abundance_max,
    solid_override=None,
    *,
    mesh: Mesh,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
    count_bits: int = 32,
) -> JoinStats:
    """Sharded variant of join_stats_from_spectra (checkpoint/resume
    path): every shard joins its spectrum rows, psum-reduced.

    ``solid_override``: GLOBAL per-bank solid totals, required when the
    call only sees one hash range of the k-mer space (the out-of-core
    sweep composed with sharding) -- the psum makes totals global over
    SHARDS but not over RANGES."""
    words_sh = tuple(words_sh)
    nw = len(words_sh)
    has_override = solid_override is not None
    ov = (
        jnp.asarray(solid_override, jnp.int64)
        if has_override
        else jnp.zeros((n_banks,), jnp.int64)
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple(P("shards") for _ in range(nw)),
            P("shards"),
            P("shards"),
            P(),
            P(),
            P(),
        ),
        out_specs=jax.tree.map(
            lambda _: P(), JoinStats(*[0] * len(JoinStats._fields))
        ),
    )
    def step(words, sid, counts, amin, amax, ov):
        return join_stats_from_spectra(
            tuple(w[0] for w in words),
            sid[0],
            counts[0],
            amin,
            amax,
            ov if has_override else None,
            n_banks=n_banks,
            simple=simple,
            complex_=complex_,
            count_bits=count_bits,
            vary_axes=("shards",),
            psum_axis="shards",
        )

    return step(
        tuple(jnp.asarray(w) for w in words_sh),
        jnp.asarray(sid_sh),
        jnp.asarray(counts_sh),
        jnp.asarray(abundance_min, jnp.int32),
        jnp.asarray(abundance_max, jnp.int64),
        ov,
    )
