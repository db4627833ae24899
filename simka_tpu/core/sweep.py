"""Out-of-core execution: sequential sweep over k-mer hash ranges.

The reference's whole disk architecture exists so that N samples whose
combined k-mer content vastly exceeds RAM still run: counting spills
minimizer-partitioned files (src/SimkaPotara.hpp:713-723), each
partition is merged independently and its statistics saved, and the
orchestrator folds the per-partition stats with operator+=
(src/SimkaPotara.hpp:1152-1187, src/SimkaMerge.cpp:638-823).

Device equivalent: the k-mer hash space is split into R ranges.
The count phase spills every sample's spectrum rows per range to disk
(npz), bounding what the join ever holds to ~1/R of the union; one
device then sweeps the ranges sequentially, running the fused join
kernel per range and summing the (elementwise-additive) JoinStats on
the host. Because ranges partition the k-mer space, every per-range
reduction is disjoint and the summed statistics are bit-identical to
a single in-memory join -- except the Whittaker/Kullback-Leibler pair
terms, which need whole-sample totals; those are computed at spill
time and injected into every range join (``solid_override``).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Sequence, Tuple

import jax
import numpy as np

from simka_tpu.ops.countjoin import (
    JoinStats,
    join_stats_from_spectra,
    join_stats_from_spectra_split,
    use_split_join,
)
from simka_tpu.parallel.sharded import _mix_hash_np

SENTINEL32 = np.uint32(0xFFFFFFFF)


def _range_of(words: Tuple[np.ndarray, ...], n_ranges: int) -> np.ndarray:
    h = words[0]
    for w in words[1:]:
        h = _mix_hash_np(h, w)
    # second mix DECORRELATES the range id from the shard id (which is
    # the same chained mix % n_shards, parallel/sharded.py): without
    # it, n_ranges sharing a factor with n_shards leaves most
    # (shard, range) cells empty when the sweep composes with the mesh
    h = _mix_hash_np(h, np.uint32(0x27D4EB2F))
    return (h % np.uint32(n_ranges)).astype(np.int64)


class SpectrumSpill:
    """Disk store of per-(sample, hash-range) spectrum rows.

    Plays the role of the reference's ``solid/part_<p>/__p__<bank>.gz``
    partition files (src/SimkaCount.cpp:248-257) with npz instead of
    gatb Bag records.
    """

    def __init__(self, tmp_dir: str, n_ranges: int):
        self.dir = os.path.join(tmp_dir, "sweep")
        self.n_ranges = n_ranges
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, sample: int, r: int) -> str:
        return os.path.join(self.dir, f"s{sample}_r{r}.npz")

    def spill_sample(
        self,
        sample: int,
        words: Tuple[np.ndarray, ...],
        counts: np.ndarray,
    ) -> None:
        rng = _range_of(tuple(words), self.n_ranges)
        order = np.argsort(rng, kind="stable")
        rs = rng[order]
        bounds = np.searchsorted(rs, np.arange(self.n_ranges + 1))
        for r in range(self.n_ranges):
            sel = order[bounds[r] : bounds[r + 1]]
            payload = {
                f"w{i}": w[sel] for i, w in enumerate(words)
            }
            payload["counts"] = counts[sel]
            np.savez(self._path(sample, r), **payload)

    def load_range(
        self, r: int, n_samples: int
    ) -> Tuple[Tuple[np.ndarray, ...], np.ndarray, np.ndarray]:
        """All samples' rows for one range: (words, sid, counts)."""
        wparts: List[List[np.ndarray]] = []
        sids, cnts = [], []
        for s in range(n_samples):
            z = np.load(self._path(s, r))
            nw = len([k for k in z.files if k.startswith("w")])
            if not wparts:
                wparts = [[] for _ in range(nw)]
            for i in range(nw):
                wparts[i].append(z[f"w{i}"])
            sids.append(np.full(z["w0"].shape, s, np.int32))
            cnts.append(z["counts"].astype(np.int32))
        words = tuple(np.concatenate(p) for p in wparts)
        return words, np.concatenate(sids), np.concatenate(cnts)

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class RamSpill:
    """Host-RAM variant of SpectrumSpill (same interface) for runs
    without an -out-tmp directory: the out-of-core property defended
    is DEVICE memory -- the join working set exceeds HBM long before
    the counted spectra exceed host RAM. With -out-tmp set the disk
    spill is used instead (datasets larger than host RAM too)."""

    def __init__(self, n_ranges: int):
        self.n_ranges = n_ranges
        self._store = {}

    def spill_sample(
        self,
        sample: int,
        words: Tuple[np.ndarray, ...],
        counts: np.ndarray,
    ) -> None:
        rng = _range_of(tuple(words), self.n_ranges)
        order = np.argsort(rng, kind="stable")
        rs = rng[order]
        bounds = np.searchsorted(rs, np.arange(self.n_ranges + 1))
        for r in range(self.n_ranges):
            sel = order[bounds[r] : bounds[r + 1]]
            self._store[(sample, r)] = (
                tuple(w[sel] for w in words),
                counts[sel],
            )

    def load_range(self, r: int, n_samples: int):
        wparts: List[List[np.ndarray]] = []
        sids, cnts = [], []
        for s in range(n_samples):
            words, counts = self._store[(s, r)]
            if not wparts:
                wparts = [[] for _ in words]
            for i, w in enumerate(words):
                wparts[i].append(w)
            sids.append(np.full(words[0].shape, s, np.int32))
            cnts.append(counts.astype(np.int32))
        return (
            tuple(np.concatenate(p) for p in wparts),
            np.concatenate(sids),
            np.concatenate(cnts),
        )

    def cleanup(self) -> None:
        self._store.clear()


class DeviceSpill:
    """Device-memory-resident tier of the spectrum spill (same
    interface).

    The host spill tiers move every spectrum row between host and
    device twice (count-phase fetch + per-range re-upload). The
    defended resource is the JOIN working set (~8x row bytes), which
    exceeds the memory plan long before the raw spectra (12 B/row) do:
    this tier keeps every sample's rows ON DEVICE (SENTINEL-padded
    to size classes) and extracts each hash range with ONE traced
    program over the concatenated stream (mask + stable compaction)
    -- per-sample device slicing would compile a program per ragged
    shape. Tier selection (core/pipeline.py) falls back to
    RamSpill/SpectrumSpill when the spectra themselves would crowd
    device memory.

    ``spill_sample`` accepts device or host rows (host rows ship
    once); rows may be class-padded with SENTINEL first-words beyond
    ``n_rows``.
    """

    def __init__(self, n_ranges: int):
        self.n_ranges = n_ranges
        self._samples = {}
        self._concat = None

    def spill_sample(self, sample, words, counts, n_rows=None) -> None:
        import jax.numpy as jnp

        from simka_tpu.utils.sizeclass import pad_size_class

        if self._concat is not None:
            # the per-sample arrays are dropped when the concat is
            # built (HBM residency); the sweep is strictly
            # spill-then-load, so a late spill is a caller bug
            raise RuntimeError(
                "DeviceSpill: spill_sample after load_range"
            )
        if n_rows is None:
            n_rows = len(words[0])
        target = pad_size_class(max(n_rows, 1), min_bits=10)
        ws = tuple(jnp.asarray(w) for w in words)
        cs = jnp.asarray(counts, jnp.int32)
        if ws[0].shape[0] != target:
            ws, cs = _pad_rows_class(
                ws, cs, np.int32(n_rows), nw=len(ws), target=target
            )
        self._samples[sample] = (ws, cs, int(n_rows))
        self._concat = None

    def _ensure_concat(self, n_samples: int):
        import jax.numpy as jnp

        if self._concat is not None:
            return self._concat
        nw = len(self._samples[0][0])
        starts = np.zeros(n_samples + 1, np.int64)
        for s in range(n_samples):
            starts[s + 1] = (
                starts[s] + self._samples[s][0][0].shape[0]
            )
        words = tuple(
            jnp.concatenate(
                [self._samples[s][0][i] for s in range(n_samples)]
            )
            for i in range(nw)
        )
        counts = jnp.concatenate(
            [self._samples[s][1] for s in range(n_samples)]
        )
        # the per-sample arrays are dead once the concat exists --
        # keeping both doubled HBM residency right at the point the
        # range joins need their workspace
        self._samples.clear()
        self._concat = (words, counts, starts)
        return self._concat

    def load_range(self, r: int, n_samples: int):
        import jax.numpy as jnp

        from simka_tpu.utils.sizeclass import pad_size_class

        words, counts, starts = self._ensure_concat(n_samples)
        nw = len(words)
        ws, sid, cs, n = _range_extract(
            words,
            counts,
            jnp.asarray(starts.astype(np.int32)),
            jnp.int32(r),
            nw=nw,
            n_ranges=self.n_ranges,
            n_samples=n_samples,
        )
        cap = pad_size_class(int(np.asarray(n)), min_bits=10)
        cap = min(cap, words[0].shape[0])
        return (
            tuple(w[:cap] for w in ws),
            sid[:cap],
            cs[:cap],
        )

    def cleanup(self) -> None:
        self._samples.clear()
        self._concat = None


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("nw", "target"))
def _pad_rows_class(words, counts, n_rows, *, nw, target):
    """Pad/trim one sample's rows to ``target`` with SENTINEL
    first-words beyond ``n_rows`` (rows arriving pre-padded keep
    their own fills consistent)."""
    import jax.numpy as jnp

    R = words[0].shape[0]
    if R < target:
        words = tuple(
            jnp.concatenate(
                [w, jnp.full((target - R,), SENTINEL32, jnp.uint32)]
            )
            for w in words
        )
        counts = jnp.concatenate(
            [counts, jnp.zeros((target - R,), counts.dtype)]
        )
    else:
        words = tuple(w[:target] for w in words)
        counts = counts[:target]
    idx = jnp.arange(target, dtype=jnp.int32)
    real = idx < n_rows
    words = (
        jnp.where(real, words[0], SENTINEL32),
        *words[1:],
    )
    return words, jnp.where(real, counts, 0)


@_functools.partial(
    jax.jit, static_argnames=("nw", "n_ranges", "n_samples")
)
def _range_extract(words, counts, starts, r, *, nw, n_ranges, n_samples):
    """One hash range's rows from the concatenated all-sample stream:
    per-row sample id from the start offsets, range mask, stable
    compaction. Returns (words, sid, counts, n) with SENTINEL fills
    past n -- exactly the join's expected layout."""
    import jax.numpy as jnp

    from simka_tpu.ops.compact import compact_rows
    from simka_tpu.ops.kmers import mix_hash

    E = words[0].shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    sid = jnp.zeros(E, jnp.int32)
    for s in range(1, n_samples):
        sid = sid + (idx >= starts[s]).astype(jnp.int32)
    real = words[0] != SENTINEL32
    h = words[0]
    for w in words[1:]:
        h = mix_hash(h, w)
    h = mix_hash(h, jnp.uint32(0x27D4EB2F))
    keep = real & ((h % jnp.uint32(n_ranges)).astype(jnp.int32) == r)
    comp = compact_rows(
        (*words, sid, counts),
        keep,
        fills=(SENTINEL32,) * nw + (0, 0),
    )
    return (
        comp[:nw],
        comp[nw],
        comp[nw + 1],
        jnp.sum(keep.astype(jnp.int64)),
    )


def _add_join_stats(a: JoinStats, b: JoinStats) -> JoinStats:
    """Elementwise fold (the reference's SimkaStatistics::operator+=,
    SimkaDistance.cpp:156-213) -- every field is additive over
    disjoint k-mer ranges EXCEPT the per-bank totals, which the
    caller already made global via ``solid_override``/recomputation."""
    vals = {
        f: (
            np.maximum(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
            if f == "max_count"  # a max, not a sum, over ranges
            else np.asarray(getattr(a, f)) + np.asarray(getattr(b, f))
        )
        for f in JoinStats._fields
    }
    return JoinStats(**vals)


def sweep_join_stats(
    spill: SpectrumSpill,
    n_samples: int,
    abundance_min: int,
    abundance_max: int,
    global_solid: np.ndarray,
    *,
    simple: bool = False,
    complex_: bool = False,
    hi_bits: int = 32,
    verbose_log=lambda msg: None,
    n_shards: int = 1,
) -> JoinStats:
    """Sequentially join every hash range and fold the statistics.

    ``global_solid`` must be the post-filter whole-space per-bank k-mer
    totals (computed at spill time) -- the Whittaker/KL pair terms use
    them in every range (SimkaDistance.cpp:114-152 semantics).

    ``n_shards`` > 1 composes the sweep with the device mesh: each
    range's rows are hash-routed over the shards and joined under
    shard_map with a psum (the reference's disk architecture works
    under ANY core/partition configuration, SimkaPotara.hpp:617-723 --
    this is the device analog: out-of-core x multi-device).
    """
    import jax.numpy as jnp

    if n_shards > 1:
        from simka_tpu.parallel.sharded import (
            make_mesh,
            shard_rows_by_hash,
            sharded_join_from_spectra,
            sharded_join_from_spectra_split,
        )

        mesh = make_mesh(n_shards)

    total: JoinStats = None
    for r in range(spill.n_ranges):
        words, sid, counts = spill.load_range(r, n_samples)
        E = max(len(words[0]), 1)
        max_count = int(counts.max()) if len(counts) else 1
        count_bits = min(32, max(11, max_count.bit_length()))
        split = use_split_join(n_samples)
        if n_shards > 1:
            ws, ss, cs = shard_rows_by_hash(
                words, sid, counts, n_shards
            )
            join = (
                sharded_join_from_spectra_split
                if split
                else sharded_join_from_spectra
            )
            js = join(
                ws,
                ss,
                cs,
                abundance_min,
                abundance_max,
                np.asarray(global_solid, np.int64),
                mesh=mesh,
                n_banks=n_samples,
                simple=simple,
                complex_=complex_,
                count_bits=count_bits,
                **({"hi_bits": hi_bits} if split else {}),
            )
        else:
            from simka_tpu.utils.sizeclass import pad_size_class

            target = pad_size_class(E)
            pad = target - len(words[0])
            if pad:
                words = tuple(
                    np.concatenate(
                        [w, np.full(pad, SENTINEL32, np.uint32)]
                    )
                    for w in words
                )
                sid = np.concatenate([sid, np.zeros(pad, np.int32)])
                counts = np.concatenate(
                    [counts, np.zeros(pad, np.int32)]
                )
            join = (
                join_stats_from_spectra_split
                if split
                else join_stats_from_spectra
            )
            js = join(
                tuple(jnp.asarray(w) for w in words),
                jnp.asarray(sid),
                jnp.asarray(counts),
                jnp.int32(abundance_min),
                jnp.int64(abundance_max),
                jnp.asarray(global_solid, jnp.int64),
                n_banks=n_samples,
                simple=simple,
                complex_=complex_,
                count_bits=count_bits,
                hi_bits=hi_bits,
            )
        js = jax.tree.map(np.asarray, js)
        total = js if total is None else _add_join_stats(total, js)
        verbose_log(
            f"sweep range {r + 1}/{spill.n_ranges}: {E} rows joined"
            + (f" over {n_shards} shards" if n_shards > 1 else "")
        )
    return total


def filtered_solid_per_bank(
    counts_per_sample: Sequence[np.ndarray],
    abundance_min: int,
    abundance_max: int,
) -> np.ndarray:
    """Whole-space per-bank solid totals under the count-time abundance
    filter (MiniKC.hpp:56) -- exactly what the reference's merge reads
    from the count_synchro .ok metadata."""
    out = np.zeros(len(counts_per_sample), np.int64)
    for s, c in enumerate(counts_per_sample):
        c = np.asarray(c, np.int64)
        keep = (c >= abundance_min) & (c <= abundance_max)
        out[s] = int(c[keep].sum())
    return out


def choose_n_ranges(
    total_rows: int,
    n_words: int,
    max_memory_mb: int,
    requested: int = 0,
) -> int:
    """Number of hash ranges so one range's join working set fits the
    memory budget (the role of the reference's ConfigurationAlgorithm
    partition-count estimate, SimkaPotara.hpp:617-713).

    The fused join holds roughly 8x the row payload (sort buffers,
    panels, one-hot operands), so budget_rows = budget / (row_bytes*8).
    """
    if requested:
        return max(1, requested)
    row_bytes = 4 * (n_words + 2)
    budget = max(max_memory_mb, 1) * 1_000_000
    budget_rows = max(budget // (row_bytes * 8), 1)
    return max(1, -(-int(total_rows) // int(budget_rows)))
