"""SimkaMin pipelines: sketch / distance / export / append / update.

Covers the `simkaMinCore` subcommands (src/simkaMin/SimkaMin.cpp:87-107)
plus the simkaMin.py and simkaMin_update.py driver flows
(/root/reference/simkaMin/).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from simka_tpu.core.output import dump_matrix_csv_gz
from simka_tpu.io.dsl import check_input_validity, parse_input_file
from simka_tpu.minhash.distance import (
    MATRIX_NAMES,
    BinaryMatrix,
    compute_distance_block,
    merge_matrices,
)
from simka_tpu.minhash.sketch import compute_sketch
from simka_tpu.minhash.sketch_file import SketchFile


def sketch_command(
    input_filename: str,
    output_path: str,
    kmer_size: int = 21,
    sketch_size: int = 100_000,
    seed: int = 100,
    use_filter: bool = False,
    max_reads: int = 0,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
    verbose: bool = True,
    bloom_bits: int | None = None,
) -> SketchFile:
    """`simkaMinCore sketch`: one bottom-s sketch per dataset.

    SimkaMin's -max-reads default is 0 = use all reads
    (SimkaMinCount.hpp:1402), unlike exact simka's auto mode.

    ``bloom_bits``: opt-in reference-fidelity Bloom `-filter`
    emulation (minhash/bloom.py) instead of the default exact >= 2
    semantics; implies use_filter.
    """
    datasets = parse_input_file(input_filename)
    check_input_validity(datasets)
    sf = SketchFile.create(
        output_path, kmer_size, sketch_size, seed, len(datasets)
    )
    from concurrent.futures import ThreadPoolExecutor

    from simka_tpu.io.packed import PackedReadSource

    def make_source(ds):
        return PackedReadSource(
            ds.banks,
            min_read_size,
            min_read_shannon_index,
            max_reads=max_reads,
            encoding="gatb",
        )

    if bloom_bits is None and len(datasets) >= 2:
        # coalesced multi-sample path: every sample's packed reads
        # ride shared device batches and ONE fused program + ONE
        # transfer produce all sketches (minhash/sketch.py)
        from simka_tpu.minhash.sketch import compute_sketches_batched

        batched = compute_sketches_batched(
            [make_source(ds) for ds in datasets],
            kmer_size, sketch_size, seed, use_filter,
        )
        if batched is not None:
            for i, (ds, (hashes, counts)) in enumerate(
                zip(datasets, batched)
            ):
                sf.write_slot(i, hashes, counts)
                if verbose:
                    print(
                        f"[simka-tpu min] sketched {ds.id}: "
                        f"{len(hashes)} sketch k-mers"
                    )
            sf.write_ids([d.id for d in datasets])
            return sf

    def sketch_one(ds):
        # stream packed batches through the sketcher (native parse +
        # gatb 2-bit pack in one C pass; the source also satisfies the
        # raw-read provider protocol for the bloom/host fallbacks)
        source = make_source(ds)
        if bloom_bits is not None:
            from simka_tpu.minhash.bloom import compute_sketch_bloom

            return compute_sketch_bloom(
                source, kmer_size, sketch_size, seed, bloom_bits
            )
        return compute_sketch(
            source, kmer_size, sketch_size, seed, use_filter
        )

    # two samples in flight: sample i+1's parse/dispatch overlaps
    # sample i's device work and its sketch-prefix fetch (the
    # reference threads one SelectKmersCommand per dataset,
    # SimkaMinCount.hpp:1085-1123; results stay order-deterministic)
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(sketch_one, ds) for ds in datasets]
        for i, (ds, fut) in enumerate(zip(datasets, futs)):
            hashes, counts = fut.result()
            sf.write_slot(i, hashes, counts)
            if verbose:
                print(
                    f"[simka-tpu min] sketched {ds.id}: "
                    f"{len(hashes)} sketch k-mers"
                )
    sf.write_ids([d.id for d in datasets])
    return sf


def _load_sketch_block(sf: SketchFile, start: int, n: int):
    return [sf.read_slot(start + i) for i in range(n)]


def distance_command(
    in1: str,
    in2: str,
    output_dir: str,
    start_i: int = 0,
    start_j: int = 0,
    n_i: int = 0,
    n_j: int = 0,
) -> None:
    """`simkaMinCore distance`: fill a block of the binary matrices.

    Symmetric mode (reference SimkaMinDistance.hpp:619-753) triggers
    when both inputs are the same file AND start_i == start_j.
    """
    sf1, sf2 = SketchFile(in1), SketchFile(in2)
    h1, h2 = sf1.header(), sf2.header()
    if h1.kmer_size != h2.kmer_size or h1.seed != h2.seed:
        # reference enforces k and seed equality
        # (SimkaMinDistance.hpp:990-998)
        raise ValueError("sketch files differ in kmer-size or seed")
    n_i = n_i or h1.nb_datasets
    n_j = n_j or h2.nb_datasets

    same = os.path.abspath(in1) == os.path.abspath(in2)
    symmetric = same and start_i == start_j
    nmat1 = h1.nb_datasets
    nmat2 = h2.nb_datasets

    s1 = _load_sketch_block(sf1, start_i, n_i)
    s2 = s1 if symmetric else _load_sketch_block(sf2, start_j, n_j)
    # device path amortizes once the pair workload is non-trivial
    # (batched vmapped searchsorted; exact-match tested against the
    # host walk emulation in tests/test_device_distance.py)
    n_pairs = (
        n_i * (n_i - 1) // 2 if symmetric else n_i * n_j
    )
    max_s = max((len(h) for h, _ in s1 + s2), default=0)
    if n_pairs * max_s >= 1_000_000:
        from simka_tpu.minhash.device_distance import (
            compute_distance_block_device,
        )

        jac, bc = compute_distance_block_device(s1, s2, symmetric)
    else:
        jac, bc = compute_distance_block(s1, s2, symmetric)

    os.makedirs(output_dir, exist_ok=True)
    for name, block in zip(MATRIX_NAMES, (jac, bc)):
        mat = BinaryMatrix(
            os.path.join(output_dir, name + ".bin"), nmat1, nmat2
        )
        mat.write_block(start_i, start_j, block)
        if same and not symmetric:
            # off-diagonal tile of a symmetric matrix: mirror it
            mat.write_block(start_j, start_i, block.T)


def export_command(
    distance_dir: str,
    in1: str,
    in2: str,
    output_dir: str,
) -> List[str]:
    """`simkaMinCore export`: binary matrices -> csv.gz with ids
    (reference SimkaMinDistanceMatrixExporterAlgorithm,
    SimkaMinDistanceMatrixExporter.hpp:233-446)."""
    ids1 = SketchFile(in1).ids()
    ids2 = SketchFile(in2).ids()
    os.makedirs(output_dir, exist_ok=True)
    out = []
    for fname in sorted(os.listdir(distance_dir)):
        if not (fname.startswith("mat_") and fname.endswith(".bin")):
            continue
        name = fname[: -len(".bin")]
        mat = np.fromfile(
            os.path.join(distance_dir, fname), dtype=np.float32
        ).reshape(len(ids1), len(ids2))
        out.append(dump_matrix_csv_gz(output_dir, name, mat, ids1))
    return out


def append_command(in1: str, in2: str) -> None:
    """`simkaMinCore append`: merge sketch file 2 into file 1."""
    SketchFile(in1).append(SketchFile(in2))


def info_command(path: str) -> str:
    return SketchFile(path).info()


def matrix_update_command(
    existing_dir: str, existing_vs_new_dir: str, new_vs_new_dir: str,
    n_old: int, n_new: int,
) -> None:
    """`simkaMinCore matrix-update` (hidden subcommand): grow every
    binary matrix in `existing_dir` in place."""
    for name in MATRIX_NAMES:
        fn = name + ".bin"
        existing = np.fromfile(
            os.path.join(existing_dir, fn), dtype=np.float32
        ).reshape(n_old, n_old)
        evn = np.fromfile(
            os.path.join(existing_vs_new_dir, fn), dtype=np.float32
        ).reshape(n_old, n_new)
        nvn = np.fromfile(
            os.path.join(new_vs_new_dir, fn), dtype=np.float32
        ).reshape(n_new, n_new)
        merged = merge_matrices(existing, evn, nvn)
        merged.tofile(os.path.join(existing_dir, fn))


def _run_min_device_resident(
    datasets,
    output_dir: str,
    kmer_size: int,
    sketch_size: int,
    seed: int,
    use_filter: bool,
    max_reads: int,
    min_read_size: int,
    min_read_shannon_index: float,
    verbose: bool,
):
    """Device-resident SimkaMin: coalesced multi-sample sketch ->
    device-built [N, s] grids -> device distance, with the sketch
    FILE written by a background thread that overlaps the distance
    compute. The bulk prefix is fetched to the host exactly once (the
    sketch.bin artifact -- byte-identical to the per-sample path's),
    and the distance phase reads the device-built grids directly.

    Returns the exported csv paths, or None to fall back (stream
    over the HBM plan / all-ones-hash corner / grid over budget).
    """
    import threading

    import jax
    import jax.numpy as jnp

    from simka_tpu.core.budget import hbm_budget_bytes
    from simka_tpu.io.packed import PackedReadSource
    from simka_tpu.minhash.device import assemble_sketch_grid
    from simka_tpu.minhash.device_distance import (
        distance_from_device_arrays,
    )
    from simka_tpu.minhash.sketch import (
        _batched_device_sketch,
        fetch_batched_sketches,
    )

    n = len(datasets)
    s_pad = 1 << (max(sketch_size, 2) - 1).bit_length()
    if n * s_pad * 16 > hbm_budget_bytes() // 3:
        return None  # grids would crowd the pair workspace
    srcs = [
        PackedReadSource(
            ds.banks,
            min_read_size,
            min_read_shannon_index,
            max_reads=max_reads,
            encoding="gatb",
        )
        for ds in datasets
    ]
    bundle = _batched_device_sketch(
        srcs, kmer_size, sketch_size, seed, use_filter
    )
    if bundle is None:
        return None

    sketch_dir = os.path.join(output_dir, "sketch")
    dist_dir = os.path.join(output_dir, "distance")
    os.makedirs(sketch_dir, exist_ok=True)
    os.makedirs(dist_dir, exist_ok=True)
    sketch_path = os.path.join(sketch_dir, "sketch.bin")
    sf = SketchFile.create(
        sketch_path, kmer_size, sketch_size, seed, n
    )

    def write_file():
        sketches = fetch_batched_sketches(bundle)
        for i, (h, c) in enumerate(sketches):
            sf.write_slot(i, h, c)
            if verbose:
                print(
                    f"[simka-tpu min] sketched {datasets[i].id}: "
                    f"{len(h)} sketch k-mers"
                )
        sf.write_ids([d.id for d in datasets])

    import time as _time

    dbg = os.environ.get("SIMKA_TPU_DEBUG_TIMERS") == "1"
    t0 = _time.perf_counter()
    writer = threading.Thread(target=write_file)
    writer.start()
    try:
        if bundle["empty"]:
            jac = np.ones((n, n), np.float32)
            bc = np.ones((n, n), np.float32)
            np.fill_diagonal(jac, 0.0)
            np.fill_diagonal(bc, 0.0)
        else:
            import numpy as _np

            n_kept = bundle["n_kept"]
            lens = _np.minimum(n_kept, sketch_size).astype(_np.int32)
            offs = _np.zeros(n, _np.int32)
            offs[1:] = _np.cumsum(lens)[:-1].astype(_np.int32)
            H, C = assemble_sketch_grid(
                bundle["hashes_d"],
                bundle["cnt_d"],
                jnp.asarray(offs),
                jnp.asarray(lens),
                jnp.asarray(bundle["n_before"].astype(_np.int32)),
                jnp.asarray(n_kept >= sketch_size),
                n=n,
                s_pad=s_pad,
                base_c=2 if use_filter else 1,
            )
            L = jax.device_put(jnp.asarray(lens))
            jac, bc = distance_from_device_arrays(
                (H, C, L), (H, C, L), True
            )
            if dbg:
                print(
                    f"[min-device] grid+distance "
                    f"{_time.perf_counter() - t0:.2f}s",
                    flush=True,
                )
    finally:
        t_j = _time.perf_counter()
        writer.join()
        if dbg:
            print(
                f"[min-device] writer extra wait "
                f"{_time.perf_counter() - t_j:.2f}s",
                flush=True,
            )
    for name, block in zip(MATRIX_NAMES, (jac, bc)):
        mat = BinaryMatrix(
            os.path.join(dist_dir, name + ".bin"), n, n
        )
        mat.write_block(0, 0, block)
    return export_command(dist_dir, sketch_path, sketch_path, output_dir)


def run_simka_min(
    input_filename: str,
    output_dir: str,
    kmer_size: int = 21,
    sketch_size: int = 1_000_000,
    seed: int = 100,
    use_filter: bool = False,
    max_reads: int = 0,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
    tile: int = 100,
    verbose: bool = True,
    bloom_bits: int | None = None,
) -> List[str]:
    """The simkaMin.py driver flow: sketch -> tiled distance -> export.

    The 100-dataset tiling (simkaMin.py:158-187) exists to bound the
    reference's RAM; we keep the same block structure as the unit of
    work. When the coalesced device sketch applies (N >= 2, no
    bloom), the whole pipeline runs device-resident
    (_run_min_device_resident) with the same on-disk artifacts."""
    os.makedirs(output_dir, exist_ok=True)
    if bloom_bits is None:
        datasets = parse_input_file(input_filename)
        check_input_validity(datasets)
        if len(datasets) >= 2:
            out = _run_min_device_resident(
                datasets, output_dir, kmer_size, sketch_size, seed,
                use_filter, max_reads, min_read_size,
                min_read_shannon_index, verbose,
            )
            if out is not None:
                return out
    sketch_dir = os.path.join(output_dir, "sketch")
    dist_dir = os.path.join(output_dir, "distance")
    os.makedirs(sketch_dir, exist_ok=True)
    os.makedirs(dist_dir, exist_ok=True)
    sketch_path = os.path.join(sketch_dir, "sketch.bin")

    sf = sketch_command(
        input_filename,
        sketch_path,
        kmer_size,
        sketch_size,
        seed,
        use_filter,
        max_reads,
        min_read_size,
        min_read_shannon_index,
        verbose=verbose,
        bloom_bits=bloom_bits,
    )
    n = sf.header().nb_datasets
    steps = -(-n // tile)
    for bi in range(steps):
        ni = min(tile, n - bi * tile)
        for bj in range(bi, steps):
            nj = min(tile, n - bj * tile)
            distance_command(
                sketch_path,
                sketch_path,
                dist_dir,
                start_i=bi * tile,
                start_j=bj * tile,
                n_i=ni,
                n_j=nj,
            )
    return export_command(dist_dir, sketch_path, sketch_path, output_dir)


def run_simka_min_update(
    existing_output_dir: str,
    new_input_filename: str,
    use_filter: bool = False,
    max_reads: int = 0,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
    verbose: bool = True,
    bloom_bits: int | None = None,
) -> List[str]:
    """The simkaMin_update.py flow: sketch new datasets with the
    existing header's (k, s, seed), distance existing-vs-new and
    new-vs-new, matrix-update, append, re-export.

    Filter/read options apply to the NEW datasets' sketch pass -- the
    reference update driver forwards -filter/-max-reads/
    -min-read-size/-min-shannon-index the same way
    (simkaMin_update.py:119-130); the sketch header does not record
    them, so keeping them consistent with the original run is the
    caller's responsibility there as here."""
    sketch_path = os.path.join(existing_output_dir, "sketch", "sketch.bin")
    dist_dir = os.path.join(existing_output_dir, "distance")
    h = SketchFile(sketch_path).header()
    n_old = h.nb_datasets

    new_sketch = sketch_path + ".new"
    sketch_command(
        new_input_filename,
        new_sketch,
        h.kmer_size,
        h.sketch_size,
        h.seed,
        use_filter,
        max_reads,
        min_read_size,
        min_read_shannon_index,
        verbose=verbose,
        bloom_bits=bloom_bits,
    )
    n_new = SketchFile(new_sketch).header().nb_datasets

    evn_dir = os.path.join(dist_dir, "existingVsNew")
    nvn_dir = os.path.join(dist_dir, "newVsNew")
    os.makedirs(evn_dir, exist_ok=True)
    os.makedirs(nvn_dir, exist_ok=True)
    distance_command(sketch_path, new_sketch, evn_dir)
    distance_command(new_sketch, new_sketch, nvn_dir)
    matrix_update_command(dist_dir, evn_dir, nvn_dir, n_old, n_new)
    SketchFile(sketch_path).append(SketchFile(new_sketch))
    os.remove(new_sketch)
    import shutil

    shutil.rmtree(evn_dir)
    shutil.rmtree(nvn_dir)
    return export_command(
        dist_dir, sketch_path, sketch_path, existing_output_dir
    )
