"""Distance sufficient-statistics container.

Host-side mirror of the reference's ``SimkaStatistics``
(src/core/SimkaDistance.hpp:68-139, .cpp:27-213): everything the 20+
distance formulas need, as exact numpy arrays. Addition is elementwise
(the reference's ``operator+=``, SimkaDistance.cpp:156-213), which is
what makes multi-shard / multi-device reduction trivial (psum on device,
``+`` on host).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SimkaStatistics:
    dataset_ids: List[str]
    kmer_size: int
    compute_simple: bool
    compute_complex: bool

    nb_distinct_kmers: int = 0  # union distinct (post-filter)
    nb_shared_kmers: int = 0  # distinct present in >= 2 samples
    dataset_nb_reads: np.ndarray = None  # [N] i64

    distinct_per_bank: np.ndarray = None  # [N] i64
    solid_per_bank: np.ndarray = None  # [N] i64
    chord_n2_per_bank: np.ndarray = None  # [N] i64 (sum count^2)

    shared_kmers: np.ndarray = None  # [N, N] i64, asymmetric
    shared_distinct: np.ndarray = None  # [N, N] i64, symmetric
    bray_numerator: np.ndarray = None  # [N, N] i64, symmetric
    chord_ninj: np.ndarray = None  # [N, N] f64
    hellinger: np.ndarray = None  # [N, N] i64
    whittaker: np.ndarray = None  # [N, N] i64
    kullback_leibler: np.ndarray = None  # [N, N] f64

    @property
    def n_banks(self) -> int:
        return len(self.dataset_ids)

    @classmethod
    def zeros(
        cls,
        dataset_ids: List[str],
        kmer_size: int,
        compute_simple: bool = False,
        compute_complex: bool = False,
    ) -> "SimkaStatistics":
        n = len(dataset_ids)
        return cls(
            dataset_ids=list(dataset_ids),
            kmer_size=kmer_size,
            compute_simple=compute_simple,
            compute_complex=compute_complex,
            dataset_nb_reads=np.zeros(n, np.int64),
            distinct_per_bank=np.zeros(n, np.int64),
            solid_per_bank=np.zeros(n, np.int64),
            chord_n2_per_bank=np.zeros(n, np.int64),
            shared_kmers=np.zeros((n, n), np.int64),
            shared_distinct=np.zeros((n, n), np.int64),
            bray_numerator=np.zeros((n, n), np.int64),
            chord_ninj=np.zeros((n, n), np.float64),
            hellinger=np.zeros((n, n), np.int64),
            whittaker=np.zeros((n, n), np.int64),
            kullback_leibler=np.zeros((n, n), np.float64),
        )

    @classmethod
    def from_join_stats(
        cls,
        js,
        dataset_ids: List[str],
        kmer_size: int,
        dataset_nb_reads,
        compute_simple: bool,
        compute_complex: bool,
    ) -> "SimkaStatistics":
        """Finalize a (device) JoinStats result into reference layout.

        The device kernel returns upper-triangle PAIR sums
        (ops/countjoin.py); here we symmetrize, fill diagonals, and add
        the closed-form single-presence terms of the complex distances
        (the reference's asymmetric zero-count branches,
        SimkaAlgorithm.hpp:488-515):

        - Whittaker: a k-mer present in i with count c but absent in j
          contributes abs((int)(u64)(c*K_j - 0)) = c*K_j (assuming no
          int32 wrap for single terms), so the pairwise total is
          (K_i - sharedK[i][j]) * K_j + (K_j - sharedK[j][i]) * K_i.
        - Kullback-Leibler: the zero-count branch collapses to
          (c/K_i)*log(2) per k-mer, i.e.
          log2 * ((K_i - sharedK[i][j])/K_i + (K_j - sharedK[j][i])/K_j).
        """
        n = len(dataset_ids)
        # ONE transfer for every accumulator instead of ~14
        # sequential per-field device syncs
        try:
            import jax

            if any(
                isinstance(getattr(js, f), jax.Array)
                for f in js._fields
            ):
                js = type(js)(*jax.device_get(tuple(js)))
        except ImportError:  # pragma: no cover - jax always present
            pass
        solid = np.asarray(js.solid_per_bank, np.int64)
        distinct = np.asarray(js.distinct_per_bank, np.int64)
        ab = np.asarray(js.shared_kmers_ab, np.int64)
        ba = np.asarray(js.shared_kmers_ba, np.int64)
        shared_kmers = ab + ba.T + np.diag(solid)
        sd = np.asarray(js.shared_distinct, np.int64)
        shared_distinct = sd + sd.T + np.diag(distinct)
        br = np.asarray(js.bray_numerator, np.int64)
        bray = br + br.T + np.diag(solid)
        ch = np.asarray(js.chord_ninj, np.float64)
        chord = ch + ch.T
        he = np.asarray(js.hellinger, np.int64)
        hell = he + he.T

        wh = np.asarray(js.whittaker, np.int64)
        whitt = wh + wh.T
        kl_p = np.asarray(js.kullback_leibler, np.float64)
        kl = kl_p + kl_p.T
        if compute_complex and n:
            # Whittaker with the reference's EXACT int32 wrap on every
            # term, single-presence included (SimkaAlgorithm.hpp:481,
            # 505; closes PARITY divergence 3): the per-kmer all-rows
            # channel A counts every solid row against every other
            # bank's total as |int32(u64(c*K_j))|; co-present pairs
            # must instead contribute the wrapped DIFFERENCE, so their
            # s1+s2 is removed and the pair channel w restored:
            # W = A + A^T - (S12 + S12^T) + (w + w^T).
            K_i = solid[:, None].astype(np.float64)
            K_j = solid[None, :].astype(np.float64)
            only_i = (solid[:, None] - shared_kmers).astype(np.float64)
            only_j = (solid[None, :] - shared_kmers.T).astype(np.float64)
            off = ~np.eye(n, dtype=bool)
            A = np.asarray(js.whittaker_all, np.int64)
            S12 = np.asarray(js.whittaker_s12, np.int64)
            whitt = np.where(
                off, A + A.T - (S12 + S12.T) + whitt, 0
            )
            with np.errstate(divide="ignore", invalid="ignore"):
                kl_single = np.log(2.0) * (
                    np.where(K_i > 0, only_i / K_i, 0.0)
                    + np.where(K_j > 0, only_j / K_j, 0.0)
                )
            kl = kl + np.where(off, kl_single, 0.0)

        return cls(
            dataset_ids=list(dataset_ids),
            kmer_size=kmer_size,
            compute_simple=compute_simple,
            compute_complex=compute_complex,
            nb_distinct_kmers=int(js.nb_distinct),
            nb_shared_kmers=int(js.nb_shared),
            dataset_nb_reads=np.asarray(dataset_nb_reads, np.int64),
            distinct_per_bank=distinct,
            solid_per_bank=solid,
            chord_n2_per_bank=np.asarray(js.chord_n2_per_bank, np.int64),
            shared_kmers=shared_kmers,
            shared_distinct=shared_distinct,
            bray_numerator=bray,
            chord_ninj=chord,
            hellinger=hell,
            whittaker=whitt,
            kullback_leibler=kl,
        )

    def __iadd__(self, other: "SimkaStatistics") -> "SimkaStatistics":
        """Partition/shard reduction (reference operator+=,
        SimkaDistance.cpp:156-213). Per-bank global counters
        (distinct/solid/chord/reads) are whole-sample quantities that
        every shard run recomputes only for its shard, so they DO sum
        here (each k-mer lives in exactly one shard)."""
        assert self.dataset_ids == other.dataset_ids
        self.nb_distinct_kmers += other.nb_distinct_kmers
        self.nb_shared_kmers += other.nb_shared_kmers
        self.dataset_nb_reads = self.dataset_nb_reads  # reads counted once
        self.distinct_per_bank += other.distinct_per_bank
        self.solid_per_bank += other.solid_per_bank
        self.chord_n2_per_bank += other.chord_n2_per_bank
        self.shared_kmers += other.shared_kmers
        self.shared_distinct += other.shared_distinct
        self.bray_numerator += other.bray_numerator
        self.chord_ninj += other.chord_ninj
        self.hellinger += other.hellinger
        self.whittaker += other.whittaker
        self.kullback_leibler += other.kullback_leibler
        return self

    # -- derived quantities ------------------------------------------------

    @property
    def chord_sqrt_n2(self) -> np.ndarray:
        # reference: sqrt of the u64 read back from the .ok metadata
        # (SimkaDistance.cpp:139)
        return np.sqrt(self.chord_n2_per_bank.astype(np.float64))

    @property
    def canberra(self) -> np.ndarray:
        """Closed form of the reference's `_canberra` accumulator.

        `_canberra` is u_int64_t (SimkaDistance.hpp:111); each
        += abs(Ni-Nj)/(Ni+Nj) truncates, so only the exact-1.0 events
        (one count zero) survive: canberra[i][j] == b + c.
        """
        d = self.distinct_per_bank
        return d[:, None] + d[None, :] - 2 * self.shared_distinct

    # -- persistence (the reference's stats/part_i.gz role,
    #    SimkaDistance.cpp:344-601, but as npz) ---------------------------

    def save(self, filename: str) -> None:
        np.savez_compressed(
            filename,
            dataset_ids=np.array(self.dataset_ids),
            kmer_size=self.kmer_size,
            compute_simple=self.compute_simple,
            compute_complex=self.compute_complex,
            nb_distinct_kmers=self.nb_distinct_kmers,
            nb_shared_kmers=self.nb_shared_kmers,
            dataset_nb_reads=self.dataset_nb_reads,
            distinct_per_bank=self.distinct_per_bank,
            solid_per_bank=self.solid_per_bank,
            chord_n2_per_bank=self.chord_n2_per_bank,
            shared_kmers=self.shared_kmers,
            shared_distinct=self.shared_distinct,
            bray_numerator=self.bray_numerator,
            chord_ninj=self.chord_ninj,
            hellinger=self.hellinger,
            whittaker=self.whittaker,
            kullback_leibler=self.kullback_leibler,
        )

    @classmethod
    def load(cls, filename: str) -> "SimkaStatistics":
        z = np.load(filename, allow_pickle=False)
        return cls(
            dataset_ids=[str(s) for s in z["dataset_ids"]],
            kmer_size=int(z["kmer_size"]),
            compute_simple=bool(z["compute_simple"]),
            compute_complex=bool(z["compute_complex"]),
            nb_distinct_kmers=int(z["nb_distinct_kmers"]),
            nb_shared_kmers=int(z["nb_shared_kmers"]),
            dataset_nb_reads=z["dataset_nb_reads"],
            distinct_per_bank=z["distinct_per_bank"],
            solid_per_bank=z["solid_per_bank"],
            chord_n2_per_bank=z["chord_n2_per_bank"],
            shared_kmers=z["shared_kmers"],
            shared_distinct=z["shared_distinct"],
            bray_numerator=z["bray_numerator"],
            chord_ninj=z["chord_ninj"],
            hellinger=z["hellinger"],
            whittaker=z["whittaker"],
            kullback_leibler=z["kullback_leibler"],
        )

    def summary(self) -> str:
        """Global stats print (reference SimkaStatistics::print,
        SimkaDistance.cpp:215-281).

        Field-set parity note: the reference's print RETURNS right
        after the mean-coverage line (`return;`,
        SimkaDistance.cpp:283) -- the richer "Statistics on kmer
        intersections" block below it (286-342: solid rates,
        erroneous k-mers, shared-by-T-banks table) is dead code, so
        the live output is exactly this block, M/G suffixes included.
        """

        def mg(v: int) -> str:
            return f"{v}    {v // 10**6}M    {v // 10**9}G"

        n = self.n_banks
        reads = self.dataset_nb_reads
        total = int(reads.sum())
        coverage = np.divide(
            self.solid_per_bank,
            np.maximum(self.distinct_per_bank, 1),
            dtype=np.float64,
        )
        lines = [
            "Stats",
            "\tReads",
            f"\t\tTotal:    {mg(total)}",
            f"\t\tMin:    {mg(int(reads.min()) if n else 0)}",
            f"\t\tMax:    {mg(int(reads.max()) if n else 0)}",
            f"\t\tAverage:    {mg(total // n if n else 0)}",
            "\tKmers",
            f"\t\tDistinct Kmers (before merging):    {mg(int(self.distinct_per_bank.sum()))}",
            f"\t\tDistinct Kmers (after merging):    {mg(int(self.nb_distinct_kmers))}",
            f"\t\tShared distinct Kmers:    {mg(int(self.nb_shared_kmers))}",
            f"\t\tKmers:    {mg(int(self.solid_per_bank.sum()))}",
            f"\t\tMean k-mer coverage: {coverage.mean() if n else 0:g}",
        ]
        return "\n".join(lines)
