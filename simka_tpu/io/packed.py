"""Packed dataset read sources: parse -> 2-bit pack in one native pass.

Host work dominated end-to-end wall-clock while the native parser
produced one Python bytes object per read, which numpy then
re-encoded and re-packed.
`PackedReadSource` moves the whole parse+filter+2-bit-pack pipeline
into fastx.cpp (one C pass, GIL released), so Python only moves
[B, W/4]+[B, W/8] arrays to the device -- the role gatb-core's Bank
plays for the reference (SURVEY.md §2.9), including the
SimkaInputIterator per-group -max-reads quirks
(/root/reference/src/core/SimkaCommons.hpp:226-290).

The source still satisfies the zero-arg provider protocol (calling it
yields raw filtered reads), so every fallback path -- out-of-core
counting, host routing, checkpoints -- works unchanged.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from simka_tpu.io.bank import encode_batch, iter_dataset_reads


def host_pack_chunk(chunk, k: int, encoding: str = "acgt"):
    """Python fallback of the native packed batch: encode + 2-bit pack
    one list of reads (the pre-round-4 host path)."""
    from simka_tpu.ops.kmers import pack_codes_host

    if encoding == "gatb":
        from simka_tpu.minhash.sketch import encode_batch_gatb as enc
    else:
        enc = encode_batch
    max_len = max((len(s) for s in chunk), default=k)
    width = -(-max(max_len, k) // 8) * 8
    codes, _ = enc(chunk, max_len=width)
    pad_b = -(-len(chunk) // 256) * 256 - len(chunk)
    if pad_b:
        codes = np.concatenate(
            [codes, np.full((pad_b, width), 255, np.uint8)]
        )
    return pack_codes_host(codes)


class PackedReadSource:
    """One dataset's reads as device-ready 2-bit packed batches.

    ``banks``: the dataset's ';'-group list (io.dsl.Dataset.banks);
    ``max_reads`` applies per group with the reference's
    SimkaInputIterator quirks (first passing read of each file is
    uncounted; the read whose increment reaches the cap is dropped) --
    byte-parity-verified against the Python stream in
    tests/test_packed_source.py.
    """

    def __init__(
        self,
        banks,
        min_read_size: int = 0,
        min_read_shannon_index: float = 0.0,
        max_reads: int = 0,
        encoding: str = "acgt",
    ):
        banks = list(banks)
        if banks and isinstance(banks[0], (str, bytes, os.PathLike)):
            banks = [banks]
        self.banks = banks
        self.min_read_size = min_read_size
        self.min_read_shannon_index = min_read_shannon_index
        self.max_reads = max_reads
        self.encoding = encoding

    def __call__(self) -> Iterator[bytes]:
        """Provider protocol: the filtered, capped raw-read stream."""
        return iter_dataset_reads(
            self.banks,
            self.min_read_size,
            self.min_read_shannon_index,
            max_reads=self.max_reads,
        )

    def iter_packed(
        self, batch_reads: int, k: int = 21
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, int, "int | None"]]:
        """Yield (packed [B, W/4], validbits [B, W/8], n_reads,
        n_valid_windows) batches in pack_codes_host layout. Rows past
        n_reads are all-invalid; n_valid_windows is the exact count of
        valid k-mer windows (None when unknown: the Python fallback,
        or a cap-trimmed batch). Native when available."""
        native = None
        if os.environ.get("SIMKA_TPU_NO_NATIVE") != "1":
            try:
                from simka_tpu.io import native as _native

                if _native.available():
                    native = _native
            except (OSError, RuntimeError):
                pass
        if native is None:
            yield from self._iter_packed_python(batch_reads, k)
            return
        # start narrow and let the reader grow to the true read
        # length rounded to 8 (not 32): every width slot beyond the
        # longest read becomes a padded k-mer window in the join
        width0 = max(64, -(-k // 8) * 8)
        cap = self.max_reads
        for group in self.banks:
            c = 0
            capped = False
            for path in group:
                first_of_file = True
                for packed, vb, n, n_valid in native.iter_packed_batches(
                    path,
                    batch_reads,
                    self.min_read_size,
                    self.min_read_shannon_index,
                    encoding=self.encoding,
                    width=width0,
                    kmer_size=k,
                ):
                    if cap:
                        # SimkaInputIterator quirks
                        # (SimkaCommons.hpp:226-290): the first
                        # passing read of each file is "free", and
                        # the read whose increment reaches the cap is
                        # dropped
                        free = 1 if first_of_file else 0
                        countable = n - free
                        keep = free + min(
                            countable, max(cap - 1 - c, 0)
                        )
                        if countable >= cap - c:
                            capped = True
                        c += min(countable, cap - c)
                    else:
                        keep = n
                    first_of_file = False
                    if keep < n:
                        packed[keep:] = 0
                        vb[keep:] = 0
                        n_valid = None  # dropped rows' windows unknown
                    if keep > 0:
                        # trim to a 256-row class (the Python
                        # encoder's rounding): the native buffer is
                        # always batch_reads rows, but partial batches
                        # (file tails, cap trims) must not pay
                        # full-batch extraction or window padding --
                        # pow2 rounding cost the round-4 e2e bench 31%
                        # extra join rows
                        rows = min(len(packed), -(-keep // 256) * 256)
                        yield packed[:rows], vb[:rows], keep, n_valid
                    if capped:
                        break
                if capped:
                    break
            if capped:
                continue  # next group restarts its own counter

    def _iter_packed_python(self, batch_reads: int, k: int):
        from itertools import islice

        it = iter(self())
        while True:
            chunk = list(islice(it, batch_reads))
            if not chunk:
                return
            packed, vb = host_pack_chunk(chunk, k, self.encoding)
            yield packed, vb, len(chunk), None
