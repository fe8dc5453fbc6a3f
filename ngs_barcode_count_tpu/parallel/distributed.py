"""Multi-host orchestration (SURVEY.md C15 / section 5 "distributed
communication backend" — all new design surface; the reference is a
single process).

Topology: ``jax.distributed.initialize`` forms the global mesh across
hosts; each host streams its OWN byte range of the FASTQ (aligned to
record boundaries) through the native codec into its addressable
devices; count tensors and counter vectors merge with one psum at flush
(parallel/mesh.py).  No host ever ships read data to another host — the
only cross-host traffic is the final count merge.
"""

from __future__ import annotations

import os

import numpy as np


def initialize(coordinator: str | None, num_processes: int, process_id: int):
    """jax.distributed.initialize wrapper (no-op for single process)."""
    if num_processes <= 1:
        return
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def _looks_like_record_start(lines: list[bytes], i: int) -> bool:
    """lines[i] starts a FASTQ record: '@' description, sequence-ish
    line, '+' line (the classic unambiguous test needs the '+' two lines
    down; quality lines can also start with '@')."""
    if i + 2 >= len(lines):
        return False
    if not lines[i].startswith(b"@"):
        return False
    if not lines[i + 2].startswith(b"+"):
        return False
    seq = lines[i + 1]
    dna = sum(seq.count(c) for c in (b"A", b"C", b"G", b"T", b"N"))
    return not (dna < len(seq) // 2)


def align_to_record(path: str, offset: int, window: int = 1 << 20) -> int:
    """Smallest record-start offset >= ``offset`` in a plain FASTQ."""
    size = os.path.getsize(path)
    if offset <= 0:
        return 0
    if offset >= size:
        return size
    with open(path, "rb") as f:
        f.seek(offset)
        blob = f.read(window)
    # land on a line start
    first_nl = blob.find(b"\n")
    if first_nl < 0:
        return size
    base = offset + first_nl + 1
    tail = blob[first_nl + 1 :]
    lines = tail.split(b"\n")
    pos = 0
    for i in range(max(len(lines) - 3, 0)):
        if _looks_like_record_start(lines, i):
            return base + pos
        pos += len(lines[i]) + 1
    if offset + len(blob) >= size:
        return size  # inside the file's final record: nothing after
    raise ValueError(
        f"could not find a FASTQ record boundary near offset {offset}"
    )


def sub_byte_range(
    path: str, start: int, end: int, i: int, n: int
) -> tuple[int, int]:
    """The i-th of n record-aligned slices of [start, end) in a plain
    FASTQ.  Cut points align identically from both sides, so slice i's
    end equals slice i+1's start and every record lands in exactly one
    slice."""
    size = os.path.getsize(path)
    raw_s = start + (end - start) * i // n
    raw_e = start + (end - start) * (i + 1) // n
    s = start if raw_s <= start else align_to_record(path, raw_s)
    if raw_e >= end:
        e = end
    elif raw_e >= size:
        e = size
    else:
        e = align_to_record(path, raw_e)
    return min(s, end), min(e, end)


def host_byte_range(path: str, host_id: int, n_hosts: int) -> tuple[int, int]:
    """This host's [start, end) slice of a plain FASTQ, record-aligned.
    A record belongs to the host whose range contains its first byte."""
    return sub_byte_range(
        path, 0, os.path.getsize(path), host_id, n_hosts
    )


def read_fastq_range(
    path: str,
    start: int,
    end: int,
    min_width: int = 0,
    batch_reads: int = 1 << 17,
    width_multiple: int = 32,
):
    """Native-codec iterator over a byte range of a plain FASTQ (the
    per-host ingest path).  Gzip inputs cannot be range-sharded without
    an index; callers fall back to whole-file reading on host 0."""
    import ctypes

    from ngs_barcode_count_tpu.io import native
    from ngs_barcode_count_tpu.io.fastq import EncodedReads

    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("native codec unavailable")

    first = ctypes.c_int(0)
    second = ctypes.c_int(0)
    maxlen = lib.fastq_scan_max_len(
        path.encode(), 0, 4 << 20, ctypes.byref(first), ctypes.byref(second)
    )
    width = max(int(maxlen), min_width, 1)
    width = -(-width // width_multiple) * width_multiple

    h = lib.fastq_open_range(path.encode(), 8 << 20, start, end)
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
                width = -(-(-n) // width_multiple) * width_multiple
                continue
            yield EncodedReads(bases[:n], quals[:n], lengths[:n])
    finally:
        lib.fastq_close(h)
