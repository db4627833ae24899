"""Per-sample k-mer spectrum: sort + run-length count on device.

The single-sample specialization of the fused count/join (the role of
the reference's per-sample DSK run, src/SimkaCount.cpp:289-300). Used
by the SimkaMin sketch path and by the count-phase checkpoints (the
reference's partition files + kmercount_per_partition metadata).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simka_tpu.ops.kmers import SENTINEL


@functools.partial(jax.jit, static_argnames=("nw",))
def _count_spectrum_device(words, nw: int):
    E = words[0].shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    words = jax.lax.sort(tuple(words), num_keys=nw)
    if nw == 1:
        words = (words,)
    same = words[0][1:] == words[0][:-1]
    for w in words[1:]:
        same = same & (w[1:] == w[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~same])
    real = words[0] != SENTINEL
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    next_start = jnp.flip(jax.lax.cummin(jnp.flip(starts_after)))
    count = next_start - idx
    uniq = boundary & real
    return words, count, uniq


def count_spectrum(*word_arrays) -> Tuple:
    """Distinct canonical k-mers + counts for one sample.

    Args: one or more uint32 word arrays (big-endian significance).
    Returns host-compacted (words tuple, counts int64), k-mer-sorted.
    """
    words = tuple(jnp.asarray(w) for w in word_arrays)
    ws, c, m = _count_spectrum_device(words, nw=len(words))
    m = np.asarray(m)
    return (
        tuple(np.asarray(w)[m] for w in ws),
        np.asarray(c)[m].astype(np.int64),
    )


@functools.partial(jax.jit, static_argnames=("nw",))
def _compact_spectrum_device(words, counts, uniq, nw: int):
    """Compact distinct rows to the front ON DEVICE (SENTINEL fills):
    the device-resident spill keeps spectra in device memory, so the
    host-side boolean-mask fetch of count_spectrum never happens --
    only the row-count scalar reaches the host."""
    from simka_tpu.ops.compact import compact_rows

    comp = compact_rows(
        (*words, counts.astype(jnp.int32)),
        uniq,
        fills=(SENTINEL,) * nw + (0,),
    )
    return (
        comp[:nw],
        comp[nw],
        jnp.sum(uniq.astype(jnp.int64)),
    )


def count_spectrum_device(*word_arrays, defer_n_rows: bool = False):
    """Device-resident count_spectrum: returns (words tuple, counts
    i32, n_rows) with rows compacted at the front and SENTINEL
    fills behind -- arrays stay on device. ``defer_n_rows`` keeps
    n_rows a device scalar (no host sync; the out-of-core count phase
    fetches them in one batch at the end)."""
    words = tuple(jnp.asarray(w) for w in word_arrays)
    ws, c, m = _count_spectrum_device(words, nw=len(words))
    ws2, c2, n = _compact_spectrum_device(ws, c, m, nw=len(words))
    return ws2, c2, (n if defer_n_rows else int(np.asarray(n)))


def merge_spectra_device(spectra_list, defer_n_rows: bool = False):
    """Device-resident merge_spectra: fold per-batch (words, counts,
    n_rows) device spectra of ONE sample into one compacted device
    spectrum. Padding rows (SENTINEL words, zero counts) merge
    harmlessly: they group under the SENTINEL key, which the uniq
    mask drops."""
    spectra_list = list(spectra_list)
    if len(spectra_list) == 1:
        return spectra_list[0]
    nw = len(spectra_list[0][0])
    words = tuple(
        jnp.concatenate([s[0][i] for s in spectra_list])
        for i in range(nw)
    )
    counts = jnp.concatenate(
        [s[1].astype(jnp.int64) for s in spectra_list]
    )
    ws, total, m = _merge_spectra_device(words, counts, nw)
    ws2, c2, n = _compact_spectrum_device(ws, total, m, nw=nw)
    return ws2, c2, (n if defer_n_rows else int(np.asarray(n)))


@functools.partial(jax.jit, static_argnames=("nw",))
def _merge_spectra_device(words, counts, nw: int):
    """Merge (kmer, count) rows with duplicate kmers: sort rows and
    sum counts per group via prefix differences (no scatter)."""
    E = words[0].shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    sorted_ = jax.lax.sort((*words, counts), num_keys=nw)
    words = sorted_[:nw]
    counts = sorted_[nw]
    same = words[0][1:] == words[0][:-1]
    for w in words[1:]:
        same = same & (w[1:] == w[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~same])
    real = words[0] != SENTINEL
    csum = jnp.cumsum(counts.astype(jnp.int64))
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    next_start = jnp.flip(jax.lax.cummin(jnp.flip(starts_after)))
    # group total = csum[next_start-1] - csum[idx-1]
    upper = csum[jnp.clip(next_start - 1, 0, E - 1)]
    lower = jnp.where(idx > 0, csum[jnp.clip(idx - 1, 0, E - 1)], 0)
    total = upper - lower
    uniq = boundary & real
    return words, total, uniq


def merge_spectra(spectra_list):
    """Combine per-batch spectra of ONE sample into a single spectrum.

    ``spectra_list``: iterable of (words tuple, counts) with possibly
    overlapping k-mers (the streaming count path: each read batch is
    counted separately and folded in, bounding peak memory the way the
    reference's ConfigurationAlgorithm memory planning bounds DSK).
    """
    spectra_list = list(spectra_list)
    if len(spectra_list) == 1:
        return spectra_list[0]
    nw = len(spectra_list[0][0])
    if sum(len(s[1]) for s in spectra_list) == 0:
        return (
            tuple(np.empty(0, np.uint32) for _ in range(nw)),
            np.empty(0, np.int64),
        )
    words = tuple(
        jnp.asarray(np.concatenate([s[0][i] for s in spectra_list]))
        for i in range(nw)
    )
    counts = jnp.asarray(
        np.concatenate(
            [s[1].astype(np.int64) for s in spectra_list]
        )
    )
    ws, total, m = _merge_spectra_device(words, counts, nw)
    m = np.asarray(m)
    return (
        tuple(np.asarray(w)[m] for w in ws),
        np.asarray(total)[m].astype(np.int64),
    )


@jax.jit
def _hash_spectrum_device(h_hi, h_lo):
    """Group a 64-bit hash stream (as u32 pairs): per distinct hash,
    (count, first-occurrence position, second-occurrence position).

    The occurrence positions feed SimkaMin's streaming-heap count
    emulation (minhash/sketch.py): lax.sort is stable, so within an
    equal-hash run the original positions stay ascending.
    """
    E = h_hi.shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    h_hi, h_lo, pos = jax.lax.sort((h_hi, h_lo, idx), num_keys=2)
    same = (h_hi[1:] == h_hi[:-1]) & (h_lo[1:] == h_lo[:-1])
    boundary = jnp.concatenate([jnp.array([True]), ~same])
    starts_after = jnp.concatenate(
        [jnp.where(boundary, idx, E)[1:], jnp.array([E], jnp.int32)]
    )
    next_start = jnp.flip(jax.lax.cummin(jnp.flip(starts_after)))
    count = next_start - idx
    # second occurrence = next row in the same run (garbage when the
    # run has length 1; callers only use it when count >= 2).
    # NOTE no sentinel filtering here: hash streams are pre-filtered
    # and any 64-bit value is a legitimate hash.
    second = jnp.concatenate([pos[1:], pos[-1:]])
    return h_hi, h_lo, count, pos, second, boundary


def hash_spectrum(
    h_hi: np.ndarray, h_lo: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Distinct 64-bit hashes (ascending) + counts + 1st/2nd positions."""
    hh, hl, c, first, second, m = _hash_spectrum_device(
        jnp.asarray(h_hi), jnp.asarray(h_lo)
    )
    m = np.asarray(m)
    hashes = (
        np.asarray(hh)[m].astype(np.uint64) << np.uint64(32)
    ) | np.asarray(hl)[m].astype(np.uint64)
    return (
        hashes,
        np.asarray(c)[m].astype(np.int64),
        np.asarray(first)[m],
        np.asarray(second)[m],
    )
