"""Multi-host execution: sample-sharded counting + device all-to-all join.

The reference's multi-node story is job scripts + a shared filesystem
(qsub templates, sentinel polling -- SimkaPotara.hpp:884-897). The
design here:

1. every host counts the per-sample spectra of ITS datasets locally
   (pure data parallelism over samples, no communication -- the role
   of the count jobs);
2. spectrum rows are binned by k-mer hash to their owner device and
   exchanged with ONE ``lax.all_to_all`` over the global mesh (the
   role of the N x P partition-file shuffle on the shared FS);
3. each device joins its hash range and the statistics are
   psum-reduced (the role of simkaMerge + the stats merge).

Everything here runs unchanged on a single process with virtual
devices (how it is tested) and on several real hosts after
``jax.distributed.initialize`` -- the all_to_all rides the device
interconnect.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from simka_tpu.ops.countjoin import (
    JoinStats,
    join_spectra_prejoin,
    join_stats_from_spectra,
    use_split_join,
)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed for a multi-host run (no-op when
    unconfigured / single-host)."""
    if coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def run_simka_multihost(config) -> None:
    """Multi-host `simka`: every process counts its manifest datasets
    locally and joins over the global mesh.

    Replaces the reference's cluster mode (job templates + qsub +
    shared-FS sentinels, SimkaPotara.hpp:884-897): launch one process
    per host with identical arguments plus -coordinator/-num-hosts/
    -host-id; process 0 writes the matrices.

    Single-process invocations degenerate to the standard pipeline
    over the local mesh (that path is what CI exercises).
    """
    import os

    import numpy as np

    from simka_tpu.core.distances import compute_all_matrices
    from simka_tpu.core.output import write_all_matrices
    from simka_tpu.core.pipeline import (
        count_one_dataset,
        resolve_max_reads,
    )
    from simka_tpu.io.bank import count_dataset_reads
    from simka_tpu.core.stats import SimkaStatistics
    from simka_tpu.io.dsl import check_input_validity, parse_input_file
    from simka_tpu.utils.metrics import Metrics

    datasets = parse_input_file(config.input_filename)
    check_input_validity(datasets)
    ids = [d.id for d in datasets]
    n = len(ids)
    pid = jax.process_index()
    n_proc = jax.process_count()
    mine = datasets_for_process(n, pid, n_proc)
    metrics = Metrics()
    metrics.set("n_datasets", n)
    metrics.set("n_processes", n_proc)

    def log(msg):
        if config.verbose:
            print(f"[simka-tpu host {pid}] {msg}", flush=True)

    # -max-reads 0 (auto) must resolve to the SAME cap on every host:
    # each process counts the per-group reads of ITS datasets, the
    # vectors are allgathered, and (min + mean) / 2 is taken over the
    # global list (reference computeMaxReads semantics,
    # src/core/SimkaAlgorithm.cpp:376-445).
    if config.max_reads == 0:
        from simka_tpu.io.bank import estimate_dataset_reads

        local_counts = np.zeros(n, np.int64)
        for s in mine:
            local_counts[s] = estimate_dataset_reads(
                datasets[s].banks,
                config.min_read_size,
                config.min_read_shannon_index,
            ) // max(len(datasets[s].banks), 1)
        if n_proc > 1:
            from jax.experimental import multihost_utils

            local_counts = multihost_utils.process_allgather(
                local_counts
            ).sum(axis=0)
        cap = resolve_max_reads(local_counts.tolist(), 0)
        log(f"auto -max-reads resolved globally to {cap}")
    else:
        cap = resolve_max_reads([], config.max_reads)

    ckpt = None
    if config.output_tmp_dir:
        from simka_tpu.core.checkpoint import CountCheckpoint

        # per-host checkpoint dirs: hosts only ever recount their own
        # manifest datasets (the reference's count_synchro sentinels
        # live per-dataset on the shared FS, SimkaPotara.hpp:838-842)
        ckpt = CountCheckpoint(
            os.path.join(config.output_tmp_dir, f"host{pid}")
        )

    word_parts, sids, cnts = [], [], []
    nb_reads = np.zeros(n, np.int64)
    with metrics.stage("count"):
        for s in mine:
            words, counts, nr, resumed = count_one_dataset(
                datasets[s], config, cap, ckpt=ckpt, log=log
            )
            if resumed:
                metrics.count("datasets_resumed", 1)
            if not word_parts:
                word_parts = [[] for _ in words]
            for i, w in enumerate(words):
                word_parts[i].append(w)
            sids.append(np.full(words[0].shape, s, np.int32))
            cnts.append(counts.astype(np.int32))
            nb_reads[s] = nr
    metrics.count("reads", int(nb_reads.sum()))

    words = tuple(np.concatenate(p) for p in word_parts)
    sid = np.concatenate(sids)
    counts = np.concatenate(cnts)

    mesh = Mesh(
        np.asarray(jax.devices()), axis_names=("shards",)
    )
    js = multihost_join_from_spectra(
        words,
        sid,
        counts,
        config.abundance_min,
        config.abundance_max,
        mesh=mesh,
        n_banks=n,
        simple=config.simple_dist,
        complex_=config.complex_dist,
    )
    if n_proc > 1:
        from jax.experimental import multihost_utils

        nb_reads = multihost_utils.process_allgather(nb_reads).sum(
            axis=0
        )
    if pid == 0:
        stats = SimkaStatistics.from_join_stats(
            js,
            ids,
            config.kmer_size,
            nb_reads,
            config.simple_dist,
            config.complex_dist,
        )
        matrices = compute_all_matrices(stats)
        os.makedirs(config.output_dir, exist_ok=True)
        write_all_matrices(config.output_dir, matrices, ids)
        metrics.set("nb_distinct_kmers", stats.nb_distinct_kmers)
        metrics.save(
            os.path.join(config.output_dir, "simka_metrics.json")
        )
        if config.verbose:
            print(stats.summary())


def datasets_for_process(
    n_datasets: int, process_id: int, num_processes: int
) -> List[int]:
    """Static sample-sharding manifest: which dataset indices this
    host ingests and counts (round-robin for balance)."""
    return list(range(process_id, n_datasets, num_processes))


def _bin_rows_by_dest(words, sid, cnt, n_dev: int, cap: int, vary_axes: tuple = ()):
    """On-device binning of spectrum rows into [n_dev, cap] blocks by
    owner-device hash, scatter-free.

    Sort rows by destination, compute each row's within-destination
    rank from run starts, map to slot = dest*cap + rank, then
    materialize the dense slot layout with a filler sort: concatenate
    one filler row per slot, sort by (slot, is_filler) and keep the
    first row per slot -- data beats filler, empty slots keep their
    filler (SENTINEL). Replaces a host-side binning: rows never leave
    the device between
    upload and the all_to_all.
    """
    from simka_tpu.ops.kmers import SENTINEL, mix_hash

    R = words[0].shape[0]
    valid = words[0] != SENTINEL
    h = words[0]
    for w in words[1:]:
        h = mix_hash(h, w)
    dest = jnp.where(
        valid, (h % jnp.uint32(n_dev)).astype(jnp.int32), n_dev
    )
    rows = (*words, sid.astype(jnp.int32), cnt.astype(jnp.int32))
    sorted_ = jax.lax.sort((dest, *rows), num_keys=1)
    d_s = sorted_[0]
    rows_s = sorted_[1:]
    idx = jnp.arange(R, dtype=jnp.int32)
    boundary = jnp.concatenate(
        [jnp.array([True]), d_s[1:] != d_s[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(boundary, idx, 0))
    within = idx - run_start
    S = n_dev * cap
    slot = jnp.where(
        (d_s < n_dev) & (within < cap),
        d_s * cap + within,
        S + idx,  # invalid rows (and impossible overflow) past all slots
    )

    fills = (0xFFFFFFFF,) * len(words) + (0, 0)
    keys = jnp.concatenate(
        [slot, jnp.arange(S, dtype=jnp.int32)]
    )
    flag = jnp.concatenate(
        [jnp.zeros((R,), jnp.int32), jnp.ones((S,), jnp.int32)]
    )
    merged = [
        jnp.concatenate([r, jnp.full((S,), f, r.dtype)])
        for r, f in zip(rows_s, fills)
    ]
    sorted2 = jax.lax.sort((keys, flag, *merged), num_keys=2)
    k2 = sorted2[0]
    out_rows = sorted2[2:]
    first = jnp.concatenate([jnp.array([True]), k2[1:] != k2[:-1]])

    from simka_tpu.ops.compact import compact_rows

    comp = compact_rows(
        tuple(out_rows), first, fills=fills, vary_axes=vary_axes
    )
    return tuple(c[:S].reshape(n_dev, cap) for c in comp)


def multihost_join_from_spectra(
    words: Tuple[np.ndarray, ...],
    sid: np.ndarray,
    counts: np.ndarray,
    abundance_min: int,
    abundance_max: int,
    *,
    mesh: Mesh,
    n_banks: int,
    simple: bool = False,
    complex_: bool = False,
) -> JoinStats:
    """Join this process's local spectrum rows with every other host's
    via an in-program all_to_all, then compute global statistics.

    ``words``/``sid``/``counts`` are the rows counted BY THIS PROCESS
    (its manifest datasets). The function must be called on every
    process with the same mesh.

    Rows are uploaded ONCE, unpadded, striped over the local devices;
    destination binning runs ON DEVICE (_bin_rows_by_dest) and the
    binned blocks ride the all_to_all directly -- no host routing and
    no padded-cap upload (the per-(src, dest) capacity comes from a
    tiny device histogram program whose pmax makes it globally
    agreed). The spectra themselves touch the host exactly once, as
    the count phase's checkpointable artifact -- the role of the
    reference's partition FILES (src/SimkaCount.cpp:248-257).
    """
    devices = mesh.devices.reshape(-1)
    n_dev = len(devices)
    local = [d for d in devices if d.process_index == jax.process_index()]
    n_local = max(len(local), 1)
    words = tuple(words)
    nw = len(words)
    R_local = len(words[0])

    # stripe local rows across local devices, padded to a size class
    # agreed across processes (the global array must be regular)
    per_dev = -(-max(R_local, 1) // n_local)
    per_dev = 1 << max(8, (per_dev - 1).bit_length())
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        per_dev = int(
            multihost_utils.process_allgather(
                np.asarray([per_dev], np.int64)
            ).max()
        )

    def blockify(arr, fill, dtype):
        pad = n_local * per_dev - len(arr)
        return np.concatenate(
            [
                np.asarray(arr, dtype),
                np.full(pad, fill, dtype),
            ]
        ).reshape(n_local, per_dev)

    blocks = [blockify(w, 0xFFFFFFFF, np.uint32) for w in words]
    blocks.append(blockify(sid, 0, np.int32))
    blocks.append(blockify(counts, 0, np.int32))
    sharding = NamedSharding(mesh, P("shards"))
    garrs = [
        jax.make_array_from_process_local_data(
            sharding, b, global_shape=(n_dev, per_dev)
        )
        for b in blocks
    ]

    from simka_tpu.ops.intmatmul import binned_sum
    from simka_tpu.ops.kmers import SENTINEL, mix_hash

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=tuple(P("shards") for _ in range(nw)),
        out_specs=P(),
    )
    def cap_prog(*wargs):
        wb = tuple(a[0] for a in wargs)
        valid = wb[0] != SENTINEL
        h = wb[0]
        for w in wb[1:]:
            h = mix_hash(h, w)
        dest = jnp.where(
            valid, (h % jnp.uint32(n_dev)).astype(jnp.int32), n_dev
        )
        hist = binned_sum(
            valid.astype(jnp.int64), dest, n_dev, bits=33
        )
        return jax.lax.pmax(jnp.max(hist), "shards")

    cap_needed = int(np.asarray(cap_prog(*garrs[:nw])))
    cap = 1 << max(8, (max(cap_needed, 1) - 1).bit_length())

    def bin_and_exchange(args):
        wb = tuple(a[0] for a in args[:nw])
        sid_b = args[nw][0]
        cnt_b = args[nw + 1][0]
        binned = _bin_rows_by_dest(
            wb, sid_b, cnt_b, n_dev, cap, vary_axes=("shards",)
        )

        def a2a(x):
            y = jax.lax.all_to_all(
                x, "shards", split_axis=0, concat_axis=0, tiled=True
            )
            return y.reshape(-1)

        return tuple(a2a(b) for b in binned)

    if use_split_join(n_banks):
        # wide N: the singleton-prune two-program join, with the
        # exchange folded into program A (parallel/sharded.py's
        # _sharded_split_join sizes and runs program B)
        from simka_tpu.parallel.sharded import (
            _prejoin_out_specs,
            _sharded_split_join,
        )

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=tuple(P("shards") for _ in range(nw + 2)),
            out_specs=_prejoin_out_specs(nw),
        )
        def pre_step(*args):
            exchanged = bin_and_exchange(args)
            pre = join_spectra_prejoin(
                exchanged[:nw],
                exchanged[nw],
                exchanged[nw + 1],
                jnp.int32(abundance_min),
                jnp.int64(abundance_max),
                # psum'd in-program totals are global here: the
                # exchange spans the whole hash space
                n_banks=n_banks,
                vary_axes=("shards",),
                psum_axis="shards",
                complex_=complex_,
            )
            return pre._replace(
                words_shared=tuple(
                    w[None, :] for w in pre.words_shared
                ),
                sid_shared=pre.sid_shared[None, :],
                cnt_shared=pre.cnt_shared[None, :],
                n_rows_shared=pre.n_rows_shared[None],
            )

        return _sharded_split_join(
            pre_step,
            tuple(garrs),
            mesh=mesh,
            n_banks=n_banks,
            simple=simple,
            complex_=complex_,
            count_bits=32,
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=tuple(P("shards") for _ in range(nw + 2)),
        out_specs=jax.tree.map(
            lambda _: P(), JoinStats(*[0] * len(JoinStats._fields))
        ),
    )
    def step(*args):
        exchanged = bin_and_exchange(args)
        return join_stats_from_spectra(
            exchanged[:nw],
            exchanged[nw],
            exchanged[nw + 1],
            jnp.int32(abundance_min),
            jnp.int64(abundance_max),
            n_banks=n_banks,
            simple=simple,
            complex_=complex_,
            vary_axes=("shards",),
            psum_axis="shards",
        )

    return step(*garrs)
