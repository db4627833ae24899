"""ctypes bindings for the native FASTA/FASTQ parser (fastx.cpp).

Compiled on first use with g++ (cached next to the source); callers
fall back to the pure-Python reader in simka_tpu.io.bank when the
toolchain or zlib is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastx.cpp")
_LIB = os.path.join(_DIR, "libfastx.so")

_lib = None
_tried = False


def _build() -> Optional[str]:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(
        _SRC
    ):
        return _LIB
    # build beside the target and rename: concurrent processes (test
    # workers) must never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        _SRC,
        "-o",
        tmp,
        "-lz",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, _LIB)
    return _LIB


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.fastx_read_batch.restype = ctypes.c_int64
    lib.fastx_read_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fastx_count_reads.restype = ctypes.c_int64
    lib.fastx_count_reads.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.c_float,
    ]
    lib.fastx_read_raw_batch.restype = ctypes.c_int64
    lib.fastx_read_raw_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastx_read_packed_batch.restype = ctypes.c_int64
    lib.fastx_read_packed_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastx_error.restype = ctypes.c_char_p
    lib.fastx_error.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _raise_if_malformed(lib, h, path: str) -> None:
    """A batch loop ending may mean EOF -- or a malformed FASTQ
    record the reader refused to mis-parse. Raise the reader's
    message instead of silently truncating the stream."""
    msg = lib.fastx_error(h)
    if msg:
        raise ValueError(f"{path}: {msg.decode()}")


def iter_code_batches(
    path: str,
    batch_reads: int,
    max_len: int,
    min_read_size: int = 0,
    min_shannon: float = 0.0,
    encoding: str = "acgt",
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (codes [n, max_len] uint8, lengths [n] int32) batches."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastx library unavailable")
    h = lib.fastx_open(path.encode())
    if not h:
        raise IOError(f"cannot open sequence file: {path}")
    enc = 1 if encoding == "gatb" else 0
    try:
        while True:
            codes = np.empty((batch_reads, max_len), np.uint8)
            lengths = np.empty(batch_reads, np.int32)
            n = lib.fastx_read_batch(
                h,
                batch_reads,
                max_len,
                min_read_size,
                min_shannon,
                enc,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if n <= 0:
                _raise_if_malformed(lib, h, path)
                break
            yield codes[:n], lengths[:n]
            if n < batch_reads:
                _raise_if_malformed(lib, h, path)
                break
    finally:
        lib.fastx_close(h)


def iter_packed_batches(
    path: str,
    batch_reads: int,
    min_read_size: int = 0,
    min_shannon: float = 0.0,
    encoding: str = "acgt",
    width: int = 64,
    kmer_size: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int, int]]:
    """Yield (packed [B, width/4], validbits [B, width/8], n_reads,
    n_valid_windows) batches in pack_codes_host layout, filtered and
    2-bit packed at parse time (one C pass; Python never touches read
    bytes). ``width`` grows automatically when a longer read arrives
    (rounded to 8: every width slot beyond the longest read becomes a
    padded k-mer window downstream). ``kmer_size`` > 0 also counts
    the valid k-mer windows per batch."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastx library unavailable")
    h = lib.fastx_open(path.encode())
    if not h:
        raise IOError(f"cannot open sequence file: {path}")
    enc = 1 if encoding == "gatb" else 0
    width = -(-max(width, 8) // 8) * 8
    try:
        while True:
            packed = np.empty((batch_reads, width // 4), np.uint8)
            validbits = np.empty((batch_reads, width // 8), np.uint8)
            n_valid = ctypes.c_int64(0)
            n = lib.fastx_read_packed_batch(
                h,
                batch_reads,
                width,
                min_read_size,
                min_shannon,
                enc,
                kmer_size,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                validbits.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)
                ),
                ctypes.byref(n_valid),
            )
            if n == 0:
                _raise_if_malformed(lib, h, path)
                break
            if n < 0:  # a read longer than width: widen + retry
                width = -(-max(-n, width + 8) // 8) * 8
                continue
            yield packed, validbits, int(n), int(n_valid.value)
            # no early EOF inference: a short batch can also mean a
            # pending longer-than-width read was pushed back
    finally:
        lib.fastx_close(h)


def iter_raw_reads(
    path: str,
    min_read_size: int = 0,
    min_shannon: float = 0.0,
    batch_reads: int = 1 << 16,
    batch_bytes: int = 1 << 24,
) -> Iterator[bytes]:
    """Yield FILTERED raw sequence byte strings at native parse speed.

    Drop-in replacement for the pure-Python
    ``iter_sequences`` + ``sequence_passes`` stream in io.bank (same
    filter semantics: the C++ Shannon index mirrors
    SimkaSequenceFilter, /root/reference/src/core/SimkaCommons.hpp:393-432).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastx library unavailable")
    h = lib.fastx_open(path.encode())
    if not h:
        raise IOError(f"cannot open sequence file: {path}")
    try:
        buf = np.empty(batch_bytes, np.uint8)
        offsets = np.empty(batch_reads + 1, np.int64)
        while True:
            n = lib.fastx_read_raw_batch(
                h,
                batch_reads,
                buf.shape[0],
                min_read_size,
                min_shannon,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if n == 0:
                _raise_if_malformed(lib, h, path)
                break
            if n < 0:  # one read larger than the buffer: grow + retry
                buf = np.empty(max(-n, 2 * buf.shape[0]), np.uint8)
                continue
            raw = bytes(buf[: offsets[n]])
            for i in range(n):
                yield raw[offsets[i] : offsets[i + 1]]
    finally:
        lib.fastx_close(h)


def count_reads(
    path: str, min_read_size: int = 0, min_shannon: float = 0.0
) -> int:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastx library unavailable")
    n = lib.fastx_count_reads(path.encode(), min_read_size, min_shannon)
    if n == -2:
        raise ValueError(f"{path}: malformed FASTQ record")
    if n < 0:
        raise IOError(f"cannot open sequence file: {path}")
    return n
