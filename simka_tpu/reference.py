"""Plain numpy reference for the exact statistics and the SimkaMin sketch.

Independent of the device code on purpose: canonical k-mers come from
vectorised 2-bit packing of ASCII reads, per-sample counts from
``np.unique``, pair sums from ``np.intersect1d``, and the bottom-s
sketch from the numpy MurmurHash3 (minhash/murmur.py). chip_smoke.py
and the tests hold the device pipeline to these answers. Pair
statistics are local to a pair: entry [i, j] of an N-sample run
depends only on samples i and j, so a reference over two samples
checks any entry of a wide run.

Reads are a 2-D uint8 array of ASCII bases (one read per row; pad
ragged reads with ``N``, which no valid window contains). k <= 32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# base -> 2-bit code; 255 marks a non-ACGT base
_ACGT = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ACGT[_b] = _ACGT[_b + 32] = _i
# SimkaMin hashes gatb's encoding (A=0, C=1, T=2, G=3)
_GATB = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACTG"):
    _GATB[_b] = _GATB[_b + 32] = _i


def reads_matrix(seqs) -> np.ndarray:
    """List of read byte strings -> [n, max_len] ASCII, padded with N."""
    width = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), width), ord("N"), np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = np.frombuffer(s, np.uint8)
    return out


def canonical_kmers(
    reads: np.ndarray, k: int, encoding: str = "acgt", chunk: int = 1 << 15
) -> np.ndarray:
    """Canonical k-mer values (min of forward and reverse complement)
    of every valid window, in read order then window order."""
    if not 1 <= k <= 32:
        raise ValueError("the numpy reference packs k <= 32 into a uint64")
    lut, comp = (_GATB, 2) if encoding == "gatb" else (_ACGT, 3)
    n, length = reads.shape
    w = length - k + 1
    if w <= 0:
        return np.empty(0, np.uint64)
    out = []
    for r0 in range(0, n, chunk):
        codes = lut[reads[r0 : r0 + chunk]]
        bad = np.zeros((codes.shape[0], length + 1), np.int32)
        np.cumsum(codes == 255, axis=1, out=bad[:, 1:])
        valid = (bad[:, k:] - bad[:, :w]) == 0
        fwd = np.zeros((codes.shape[0], w), np.uint64)
        rc = np.zeros((codes.shape[0], w), np.uint64)
        for j in range(k):
            c = (codes[:, j : j + w] & 3).astype(np.uint64)
            fwd = (fwd << np.uint64(2)) | c
            if encoding == "gatb":
                cc = c ^ np.uint64(comp)
            else:
                cc = np.uint64(comp) - c
            rc |= cc << np.uint64(2 * j)
        out.append(np.minimum(fwd, rc)[valid])
    return np.concatenate(out)


def count_kmers(kmers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(distinct k-mers ascending, their counts as int64)."""
    uniq, counts = np.unique(kmers, return_counts=True)
    return uniq, counts.astype(np.int64)


def sample_counts(reads: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """count_kmers(canonical_kmers(reads, k)): one sample's spectrum."""
    return count_kmers(canonical_kmers(reads, k))


def solid_kmers(
    uniq: np.ndarray, counts: np.ndarray, abundance_min: int,
    abundance_max: int = 999_999_999,
) -> Tuple[np.ndarray, np.ndarray]:
    """The abundance filter, applied per sample before any join."""
    keep = (counts >= abundance_min) & (counts <= abundance_max)
    return uniq[keep], counts[keep]


def bank_totals(counts: np.ndarray) -> Dict[str, int]:
    """Per-bank totals over one sample's solid k-mers."""
    return {
        "distinct": int(len(counts)),
        "solid": int(counts.sum()),
        "chord_n2": int((counts * counts).sum()),
    }


def pair_stats(a, b) -> Dict[str, float]:
    """Pair sums over the k-mers solid in both samples ``a`` and ``b``
    (each a (uniq, counts) pair): co-presence, sum min, sum C_a, sum
    C_b, sum floor(sqrt(C_a*C_b)) (the reference truncates a double
    sqrt into u64) and sum C_a*C_b (a float channel)."""
    _, ia, ib = np.intersect1d(
        a[0], b[0], assume_unique=True, return_indices=True
    )
    ca, cb = a[1][ia], b[1][ib]
    prod = ca * cb
    return {
        "shared_distinct": int(len(ia)),
        "bray_numerator": int(np.minimum(ca, cb).sum()),
        "sum_a": int(ca.sum()),
        "sum_b": int(cb.sum()),
        "hellinger": int(np.floor(np.sqrt(prod.astype(np.float64))).sum()),
        "chord_ninj": float(prod.sum()),
    }


def pipeline_pair_stats(stats, i: int, j: int) -> Dict[str, float]:
    """The same quantities read from a SimkaStatistics (i < j)."""
    return {
        "shared_distinct": int(stats.shared_distinct[i][j]),
        "bray_numerator": int(stats.bray_numerator[i][j]),
        "sum_a": int(stats.shared_kmers[i][j]),
        "sum_b": int(stats.shared_kmers[j][i]),
        "hellinger": int(stats.hellinger[i][j]),
        "chord_ninj": float(stats.chord_ninj[i][j]),
    }


def pipeline_bank_totals(stats, i: int) -> Dict[str, int]:
    return {
        "distinct": int(stats.distinct_per_bank[i]),
        "solid": int(stats.solid_per_bank[i]),
        "chord_n2": int(stats.chord_n2_per_bank[i]),
    }


FLOAT_CHANNELS = ("chord_ninj",)


def compare_stats(got: Dict, want: Dict, rtol: float = 1e-6) -> list:
    """Mismatch messages: integer channels must be equal, float
    channels within ``rtol`` relative."""
    bad = []
    for key, w in want.items():
        g = got[key]
        if key in FLOAT_CHANNELS:
            if abs(g - w) > rtol * abs(w):
                bad.append(f"{key}: {g!r} vs {w!r}")
        elif g != w:
            bad.append(f"{key}: {g!r} vs {w!r}")
    return bad


def bottom_sketch(
    reads: np.ndarray, k: int, sketch_size: int, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """SimkaMin's bottom-s sketch of one sample without -filter:
    the s smallest distinct murmur hashes of the canonical k-mers and
    their counts, with the reference heap's quirk for the largest
    member (its occurrences stop counting once every smaller member
    has entered the full heap, SimkaMinCount.hpp:324)."""
    from simka_tpu.minhash.murmur import murmur3_u64

    stream = murmur3_u64(canonical_kmers(reads, k, "gatb"), seed)
    uniq, first, counts = np.unique(
        stream, return_index=True, return_counts=True
    )
    s = min(sketch_size, len(uniq))
    hashes = uniq[:s].copy()
    out = counts[:s].astype(np.int64)
    if len(uniq) >= sketch_size and s >= 1:
        t_last = int(first[: s - 1].max()) if s >= 2 else 0
        out[s - 1] = max(1, int(np.count_nonzero(stream[:t_last] == hashes[-1])))
    return hashes, out.astype(np.uint32)
