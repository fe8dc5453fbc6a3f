"""ctypes bindings + lazy build for the native FASTQ codec.

The shared library compiles on first use with g++ -O3 (cached beside the
source); if the toolchain is unavailable the caller falls back to the
NumPy encoder (io/fastq.py) with identical semantics.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator

import numpy as np

from ngs_barcode_count_tpu.io.fastq import EncodedReads, FastqFormatError

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_native", "fastq_codec.cpp")
_SRC2 = os.path.join(_DIR, "_native", "dedup_store.cpp")
_SO = os.path.join(_DIR, "_native", "fastq_codec.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


class PackedReads:
    """A fixed-size batch in wire format: 2-bit packed bases + sparse
    exceptions (see fastq_codec.cpp fastq_next_batch_packed).  ``quals``
    is None when the quality gate is off."""

    __slots__ = ("packed", "lengths", "exc_idx", "exc_val", "quals",
                 "n_reads", "width", "next_offset", "transposed",
                 "range_id", "quals_packed", "qual_codebook", "qual_bits",
                 "qual_mode")

    def __init__(self, packed, lengths, exc_idx, exc_val, quals, n_reads,
                 width, next_offset=-1, transposed=False, range_id=0):
        self.packed = packed
        self.lengths = lengths
        self.exc_idx = exc_idx
        self.exc_val = exc_val
        self.quals = quals
        # lossless packed Phred wire (parallel_ingest._maybe_pack_quals):
        # when set, ``quals`` is None and the consumer reconstructs it
        # as qual_codebook[qual_bits-wide fields of quals_packed]
        # (qual_bits = 2 when the batch has <= 4 distinct values —
        # typical RTA binning — else 4 for <= 16, else raw)
        self.quals_packed = None
        self.qual_codebook = None
        self.qual_bits = 0
        # resolved quality-wire mode ("pack"/"raw"/"host") — set by
        # parallel_ingest._maybe_pack_quals; the runner's two-phase
        # host gate triggers on qual_mode == "host"
        self.qual_mode = None
        self.n_reads = n_reads
        self.width = width
        # byte offset of the next unread record (-1 when unknown):
        # checkpoint/resume restarts ingest exactly here
        self.next_offset = next_offset
        # column-major wire layout (see parallel_ingest._maybe_transpose)
        self.transposed = transposed
        # which parallel-ingest byte range produced this batch: the
        # checkpoint frontier is a per-range offset vector, so T readers
        # stay checkpointable (round 2 forced a single reader)
        self.range_id = range_id


def _build() -> bool:
    # per-process temporary output: concurrent first uses (test workers)
    # each build their own copy and atomically rename it into place
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        _SRC, _SRC2, "-lz", "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """The loaded shared library, or None if native is unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
            os.path.getmtime(_SRC), os.path.getmtime(_SRC2)
        ):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        lib.fastq_open.restype = ctypes.c_void_p
        lib.fastq_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t,
        ]
        lib.fastq_close.argtypes = [ctypes.c_void_p]
        lib.fastq_total_reads.restype = ctypes.c_uint64
        lib.fastq_total_reads.argtypes = [ctypes.c_void_p]
        lib.fastq_next_batch.restype = ctypes.c_int64
        lib.fastq_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fastq_scan_max_len.restype = ctypes.c_int64
        lib.fastq_scan_max_len.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.fastq_next_batch_packed.restype = ctypes.c_int64
        lib.fastq_next_batch_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int8),
        ]
        lib.fastq_tell.restype = ctypes.c_uint64
        lib.fastq_tell.argtypes = [ctypes.c_void_p]
        lib.fastq_has_pending.restype = ctypes.c_int
        lib.fastq_has_pending.argtypes = [ctypes.c_void_p]
        lib.fastq_open_range.restype = ctypes.c_void_p
        lib.fastq_open_range.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        U64P = ctypes.POINTER(ctypes.c_uint64)
        lib.dedup_create.restype = ctypes.c_void_p
        lib.dedup_create.argtypes = [ctypes.c_uint64]
        lib.dedup_free.argtypes = [ctypes.c_void_p]
        lib.dedup_size.restype = ctypes.c_uint64
        lib.dedup_size.argtypes = [ctypes.c_void_p]
        lib.dedup_observe.restype = ctypes.c_uint64
        lib.dedup_observe.argtypes = [
            ctypes.c_void_p, U64P, U64P, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.dedup_export.argtypes = [ctypes.c_void_p, U64P, U64P]
        lib.dedup_import.argtypes = [
            ctypes.c_void_p, U64P, U64P, ctypes.c_int64,
        ]
        lib.radix_argsort_u64.argtypes = [
            U64P, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def radix_argsort(keys) -> "np.ndarray":
    """Stable argsort of a contiguous uint64 key vector via the native
    LSD radix sort (~8x numpy's comparison argsort on 131k keys); falls
    back to numpy when the codec is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None or keys.dtype != np.uint64 or not keys.flags.c_contiguous:
        return np.argsort(keys, kind="stable")
    order = np.empty(keys.shape[0], np.int32)
    lib.radix_argsort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        keys.shape[0],
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return order


def available() -> bool:
    return get_lib() is not None


def read_fastq_native(
    path: str,
    min_width: int = 0,
    batch_reads: int = 1 << 17,
    check_format: bool = True,
    width_multiple: int = 32,
) -> Iterator[EncodedReads]:
    """Native equivalent of io.fastq.read_fastq: yields EncodedReads of up
    to ``batch_reads`` rows, already padded to a fixed width determined by
    a pre-scan of the file head (re-widened on demand if a longer read
    appears later)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    if path.endswith("fastq.gz"):
        gz = 1
    elif path.endswith("fastq"):
        gz = 0
    else:
        raise FastqFormatError(
            "This program only works with *.fastq files and *.fastq.gz "
            "files.  The latter is still experimental"
        )

    first = ctypes.c_int(0)
    second = ctypes.c_int(0)
    maxlen = lib.fastq_scan_max_len(
        path.encode(), gz, 4 << 20, ctypes.byref(first), ctypes.byref(second)
    )
    if maxlen < 0:
        raise FileNotFoundError(path)
    if check_format and maxlen > 0:
        if first.value:
            raise FastqFormatError(
                "The first line within the FASTQ contains DNA sequences.  "
                "Check the FASTQ format"
            )
        if not second.value:
            raise FastqFormatError(
                "The second line within the FASTQ file is not a sequence. "
                "Check the FASTQ format"
            )

    width = max(int(maxlen), min_width, 1)
    width = -(-width // width_multiple) * width_multiple

    h = lib.fastq_open(path.encode(), gz, 8 << 20)
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            bases = np.empty((batch_reads, width), dtype=np.int8)
            quals = np.empty((batch_reads, width), dtype=np.int8)
            lengths = np.empty(batch_reads, dtype=np.int32)
            n = lib.fastq_next_batch(
                h, batch_reads, width,
                bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                quals.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if n == 0:
                break
            if n < 0:
                # a read wider than the buffer: widen and retry (the
                # record is held inside the native reader, nothing lost)
                width = -(-(-n) // width_multiple) * width_multiple
                continue
            if n == batch_reads:
                yield EncodedReads(bases, quals, lengths)
            else:
                yield EncodedReads(bases[:n], quals[:n], lengths[:n])
    finally:
        lib.fastq_close(h)


def read_fastq_native_packed(
    path: str,
    min_width: int = 0,
    batch_reads: int = 1 << 17,
    with_quals: bool = False,
    check_format: bool = True,
    width_multiple: int = 32,
    start_offset: int = 0,
) -> Iterator[PackedReads]:
    """Wire-format reader: yields PackedReads of EXACTLY ``batch_reads``
    rows (the final batch zero-padded; consumers mask by n_reads).  The
    2-bit pack quarters host->device traffic vs int8 codes, and Phred
    bytes are only materialized when the quality gate needs them."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    if path.endswith("fastq.gz"):
        gz = 1
    elif path.endswith("fastq"):
        gz = 0
    else:
        raise FastqFormatError(
            "This program only works with *.fastq files and *.fastq.gz "
            "files.  The latter is still experimental"
        )
    first = ctypes.c_int(0)
    second = ctypes.c_int(0)
    maxlen = lib.fastq_scan_max_len(
        path.encode(), gz, 4 << 20, ctypes.byref(first), ctypes.byref(second)
    )
    if maxlen < 0:
        raise FileNotFoundError(path)
    if check_format and maxlen > 0:
        if first.value:
            raise FastqFormatError(
                "The first line within the FASTQ contains DNA sequences.  "
                "Check the FASTQ format"
            )
        if not second.value:
            raise FastqFormatError(
                "The second line within the FASTQ file is not a sequence. "
                "Check the FASTQ format"
            )

    width_multiple = max(width_multiple, 4)
    width = max(int(maxlen), min_width, 1)
    width = -(-width // width_multiple) * width_multiple
    cap_exc = max(4096, batch_reads * width // 64)

    if start_offset > 0:
        if gz:
            raise ValueError(
                "resume from a byte offset requires an uncompressed fastq"
            )
        h = lib.fastq_open_range(
            path.encode(), 8 << 20, start_offset, (1 << 63) - 1
        )
    else:
        h = lib.fastq_open(path.encode(), gz, 8 << 20)
    if not h:
        raise FileNotFoundError(path)
    I8 = ctypes.POINTER(ctypes.c_int8)
    try:
        while True:
            packed = np.zeros((batch_reads, width // 4), dtype=np.uint8)
            lengths = np.zeros(batch_reads, dtype=np.int32)
            exc_idx = np.full(cap_exc, -1, dtype=np.int32)
            exc_val = np.zeros(cap_exc, dtype=np.int8)
            quals = (
                np.zeros((batch_reads, width), dtype=np.int8)
                if with_quals
                else None
            )
            nexc = ctypes.c_int64(0)
            n = lib.fastq_next_batch_packed(
                h, batch_reads, width,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                cap_exc,
                exc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                exc_val.ctypes.data_as(I8),
                ctypes.byref(nexc),
                quals.ctypes.data_as(I8) if with_quals else I8(),
            )
            if n == 0:
                break
            if n == -1:  # exception capacity: grow to what the codec needs
                cap_exc = max(cap_exc * 2, -nexc.value)
                continue
            if n < -1:  # width growth
                width = -(-(-n) // width_multiple) * width_multiple
                continue
            ne = nexc.value
            exc_idx[ne:] = -1
            tell = (
                int(lib.fastq_tell(h))
                if not gz and not lib.fastq_has_pending(h)
                else -1
            )
            # ship only a power-of-two bucket of the exception buffer:
            # typical FASTQs have ~0 exceptions and the full capacity
            # would dominate wire traffic
            bucket = 1024
            while bucket < ne:
                bucket *= 2
            bucket = min(bucket, cap_exc)
            # int16 lengths halve wire bytes; fall back to int32 for
            # pathological >32k-base reads
            ldtype = np.int16 if width <= 32767 else np.int32
            yield PackedReads(
                packed, lengths.astype(ldtype), exc_idx[:bucket],
                exc_val[:bucket], quals, int(n), width,
                next_offset=tell,
            )
    finally:
        lib.fastq_close(h)
