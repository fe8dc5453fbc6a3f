"""Multi-threaded wire-format ingest.

The reference dedicates one thread to reading and N-1 to parsing over a
mutex deque (main.rs:69-121).  Here the equivalent producer pool is T
threads, each running the native codec over its own record-aligned byte
range of the FASTQ (parallel/distributed.py's host-sharding machinery,
reused intra-host); the ctypes call releases the GIL, so packing runs
truly parallel.  Batches flow through a small bounded queue to the
device-dispatch (main) thread, which overlaps transfers/compute with
parsing.

Order across shards is arbitrary — counting is order-independent, as is
every stat counter.  Gzip inputs cannot be range-split (no seekable
members) and use a single producer thread, which still overlaps with
device work.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

from ngs_barcode_count_tpu.io import native
from ngs_barcode_count_tpu.io.native import PackedReads
from ngs_barcode_count_tpu.parallel import distributed as dist

_SENTINEL = None


def _default_qual_wire() -> str:
    """Quality wire mode when NGS_QUAL_WIRE is unset and the caller gave
    no consumer-aware choice (runner.decode_file picks "host" for dense
    single-device runs on slow measured links — +95% config-3 e2e vs the
    2-bit wire, same-phase A/B, BENCH.md round 5).

    - "pack": 2/4-bit per-batch codebook wire, decoded in-kernel.
    - "raw": raw Phred bytes.
    - "host": round-5 two-phase gate — NO quality bytes cross the link;
      the device sends a 2B/read gate wire down and the host returns a
      1-bit/read mask (runner._step_packed_gate).  Dense-mode only; the
      ingest side just keeps pb.quals as a host array.
    """
    return "pack"


def _qual_wire_mode(override: str | None = None) -> str:
    return (
        os.environ.get("NGS_QUAL_WIRE") or override or _default_qual_wire()
    )


def _maybe_pack_quals(pb: PackedReads, qual_mode: str | None = None) -> None:
    """Lossless 4-bit Phred wire (VERDICT r3 weak #4): Illumina RTA bins
    quality to 4-8 distinct values, so a per-batch value codebook packs
    two bases per byte (FOUR when <= 4 distinct values) — halving the quality bytes that dominate
    quality-gated runs on byte-limited links (raw Phred is ~4x the
    2-bit base payload).  Exact: any batch with >16 distinct values
    (rare; pre-RTA data) ships raw.  Runs on the producer thread
    (~3 numpy passes over the batch); the runner reconstructs the
    identical int8 tensor on device (ops.decode.unpack_quals_wire).
    NGS_QUAL_WIRE=raw disables."""
    if pb.quals is None:
        return
    pb.qual_mode = _qual_wire_mode(qual_mode)
    if pb.qual_mode != "pack":
        return
    q8 = pb.quals.view(np.uint8)
    hist = np.bincount(q8.reshape(-1), minlength=256)
    vals = np.flatnonzero(hist)
    if len(vals) > 16:
        return  # raw fallback, bit-exact either way
    codebook = np.zeros(16, np.int8)
    codebook[: len(vals)] = vals.astype(np.uint8).view(np.int8)
    lut = np.zeros(256, np.uint8)
    lut[vals] = np.arange(len(vals), dtype=np.uint8)
    codes = lut[q8]
    if len(vals) <= 4:
        # 2-bit wire: 4 values/byte (typical 3-4-level RTA binning)
        pb.quals_packed = (
            codes[:, 0::4] | (codes[:, 1::4] << 2)
            | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6)
        )
        pb.qual_bits = 2
    else:
        pb.quals_packed = codes[:, 0::2] | (codes[:, 1::2] << 4)
        pb.qual_bits = 4
    pb.qual_codebook = codebook
    pb.quals = None


def _maybe_transpose(pb: PackedReads,
                     qual_mode: str | None = None) -> PackedReads:
    """Column-major wire layout: bytes from the same read position land
    adjacent, so a slow link's stream compression sees long repetitive
    runs (constants/adapters align across reads) — measured +29% raw
    link throughput and +5-60% e2e, never a loss.  The transpose runs
    here on the producer thread, overlapped with device work; the decode
    step transposes back on device (~0.1ms).  Default: col on slow
    proxied links (where bytes are the ceiling — classified by the
    measured round-trip probe, utils.linkprobe), row on direct-attached
    hardware (no link benefit, saves host CPU); NGS_WIRE_LAYOUT
    overrides."""
    from ngs_barcode_count_tpu.utils import linkprobe

    # never initializes a backend: ingest-only contexts (no device in
    # play yet) default to the row layout
    default = "col" if linkprobe.is_slow_link() else "row"
    if os.environ.get("NGS_WIRE_LAYOUT", default) == "col":
        if os.environ.get("NGS_WIRE_SORT", "1") == "1" and pb.n_reads > 1:
            _sort_batch_rows(pb)
        _maybe_pack_quals(pb, qual_mode)  # after the sort (it reorders)
        pb.packed = np.ascontiguousarray(pb.packed.T)
        if pb.quals_packed is not None:
            # same col-major trick for the quality nibbles: per-position
            # columns are long runs of few distinct values
            pb.quals_packed = np.ascontiguousarray(pb.quals_packed.T)
        pb.transposed = True
    else:
        _maybe_pack_quals(pb, qual_mode)
    return pb


def _sort_batch_rows(pb: PackedReads) -> None:
    """Cluster similar reads before the col-major transpose: counting is
    read-order independent (every mode, every counter), so sorting the
    live rows by their leading 8 packed bytes (flank offset + sample +
    first barcode) is free semantically and lengthens the column
    stream's runs — measured zlib1 ratio 0.364 -> 0.256 on the flagship
    DEL wire (-30% link bytes) at ~25 ms per 131k-read batch on the
    producer thread.  NGS_WIRE_SORT=0 disables."""
    n = pb.n_reads
    R = pb.packed
    key = R[:n, :8].copy().view(np.uint64).byteswap().ravel()
    order = native.radix_argsort(key)
    R[:n] = R[:n][order]
    pb.lengths[:n] = pb.lengths[:n][order]
    if pb.quals is not None:
        pb.quals[:n] = pb.quals[:n][order]
    ei = pb.exc_idx
    live = ei >= 0
    if live.any():
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        r = ei[live] // pb.width
        p = ei[live] % pb.width
        ei[live] = (inv[r] * pb.width + p).astype(ei.dtype)


def plan_ranges(
    path: str, n_threads: int = 0, start: int = 0,
    end: int | None = None,
) -> list[tuple[int, int]] | None:
    """The byte ranges read_fastq_packed_parallel would use for this
    file (from record-aligned byte ``start``), or None when it would
    use a single sequential reader (gzip, small remainders, or one
    thread).  This is the ONE source of truth for range selection:
    the generator itself plans through it, checkpointing runs call it
    up front so the saved frontier (one offset per range) matches the
    reader pool exactly, and offset-style resumes plan the remainder
    [start, size) so they keep the full reader pool.  ``end`` bounds
    the plan to [start, end) — the per-host slice of a multi-host
    run's checkpointing frontier."""
    if n_threads <= 0:
        n_threads = int(
            os.environ.get("NGS_INGEST_THREADS", 0)
        ) or min(4, os.cpu_count() or 1)
    if path.endswith(".gz"):
        return None
    size = os.path.getsize(path) if end is None else end
    if size - start < _range_min_bytes() or n_threads == 1:
        return None
    ranges = [
        dist.sub_byte_range(path, start, size, t, n_threads)
        for t in range(n_threads)
    ]
    return [(s, e) for s, e in ranges if e > s]


def _range_min_bytes() -> int:
    """Files below this split threshold use one sequential reader
    (range-splitting overhead dominates on small files; tests shrink
    it to exercise the parallel paths on tiny fixtures)."""
    return int(os.environ.get("NGS_RANGE_MIN_BYTES", 64 << 20))


def read_fastq_packed_parallel(
    path: str,
    min_width: int = 0,
    batch_reads: int = 1 << 17,
    with_quals: bool = False,
    n_threads: int = 0,
    queue_depth: int = 4,
    start_offset: int = 0,
    byte_range: tuple[int, int] | None = None,
    ranges: list[tuple[int, int]] | None = None,
    qual_mode: str | None = None,
) -> Iterator[PackedReads]:
    """Yields PackedReads from T parallel range readers (plain FASTQ) or
    one background reader (gzip / tiny files / resume).

    ``byte_range`` restricts reading to a record-aligned [start, end)
    slice of a plain FASTQ (the per-host share of a multi-host run);
    thread sub-ranges are carved inside it.

    ``ranges`` overrides the reader pool with explicit byte ranges
    (checkpoint/resume: each range restarts at its saved frontier
    offset); batches carry ``range_id`` = index into this list.

    ``qual_mode`` is the consumer-aware quality-wire choice (pack/raw/
    host) — decode_file picks it from the accumulator mode + link probe;
    NGS_QUAL_WIRE still overrides everything."""
    if ranges is not None:
        yield from _from_ranges(
            path, ranges, min_width, batch_reads, with_quals, queue_depth,
            qual_mode,
        )
        return
    if n_threads <= 0:
        # a slow link's stream compression competes for the same cores:
        # NGS_INGEST_THREADS caps the reader pool when ingest is not the
        # bottleneck (it rarely is — the C++ codec does ~3M reads/s/core)
        n_threads = int(
            os.environ.get("NGS_INGEST_THREADS", 0)
        ) or min(4, os.cpu_count() or 1)
    gz = path.endswith(".gz")
    size = os.path.getsize(path)
    if byte_range is not None:
        if gz:
            from ngs_barcode_count_tpu.io import bgzf

            table = bgzf.member_table(path)
            if table is None:
                raise ValueError(
                    "byte-range ingest requires a plain or BGZF FASTQ "
                    "(generic gzip is one unsplittable DEFLATE stream)"
                )
            # map the byte range to a member span: a member belongs to
            # the range containing its first byte (same tiling rule as
            # records, so host shares partition the member list exactly)
            offsets = table[0]
            r_start, r_end = byte_range
            lo = sum(1 for o in offsets if o < r_start)
            hi = sum(1 for o in offsets if o < r_end)
            yield from bgzf.read_fastq_bgzf_parallel(
                path, min_width=min_width, batch_reads=batch_reads,
                with_quals=with_quals, n_threads=n_threads,
                queue_depth=queue_depth, member_range=(lo, hi),
            )
            return
        r_start, r_end = byte_range
        if r_end <= r_start:
            return
        if n_threads > 1 and (r_end - r_start) > (64 << 20):
            ranges = [
                dist.sub_byte_range(path, r_start, r_end, t, n_threads)
                for t in range(n_threads)
            ]
            ranges = [(s, e) for s, e in ranges if e > s]
        else:
            ranges = [(r_start, r_end)]
        yield from _from_ranges(
            path, ranges, min_width, batch_reads, with_quals, queue_depth,
            qual_mode,
        )
        return
    if gz and n_threads > 1 and start_offset == 0 and size > (8 << 20):
        from ngs_barcode_count_tpu.io import bgzf

        if bgzf.is_bgzf(path):
            # block-gzip: members parallelize (io/bgzf.py); generic gzip
            # is one DEFLATE stream and stays on the single producer
            yield from bgzf.read_fastq_bgzf_parallel(
                path, min_width=min_width, batch_reads=batch_reads,
                with_quals=with_quals, n_threads=n_threads,
                queue_depth=queue_depth,
            )
            return
    # Small files or resume-from-offset: one background thread.  (The
    # runner's checkpoint/resume path plans parallel resume ranges
    # itself via plan_ranges(start=...) and passes them as ``ranges``;
    # a bare start_offset here keeps single-reader semantics.)
    if gz or start_offset > 0:
        ranges = None
    else:
        ranges = plan_ranges(path, n_threads)

    q: queue.Queue = queue.Queue(maxsize=queue_depth)
    errors: list[BaseException] = []
    stop = threading.Event()

    def produce_whole():
        try:
            for pb in native.read_fastq_native_packed(
                path,
                min_width=min_width,
                batch_reads=batch_reads,
                with_quals=with_quals,
                start_offset=start_offset,
            ):
                if stop.is_set():
                    return
                q.put(_maybe_transpose(pb, qual_mode))
        except BaseException as e:  # surfaced in the consumer
            errors.append(e)
        finally:
            q.put(_SENTINEL)

    def produce_range(start: int, end: int, check_format: bool,
                      range_id: int):
        try:
            it = _packed_range_iter(
                path, start, end, min_width, batch_reads, with_quals,
                check_format, range_id,
            )
            for pb in it:
                if stop.is_set():
                    return
                q.put(_maybe_transpose(pb, qual_mode))
        except BaseException as e:
            errors.append(e)
        finally:
            q.put(_SENTINEL)

    if ranges is None:
        threads = [threading.Thread(target=produce_whole, daemon=True)]
    else:
        threads = [
            threading.Thread(
                target=produce_range, args=(s, e, i == 0, i), daemon=True
            )
            for i, (s, e) in enumerate(ranges)
        ]
    for t in threads:
        t.start()
    live = len(threads)
    try:
        while live:
            item = q.get()
            if item is _SENTINEL:
                live -= 1
                continue
            yield item
        if errors:
            raise errors[0]
    finally:
        stop.set()
        # drain so producers blocked on put() can exit
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def _from_ranges(
    path: str,
    ranges: list[tuple[int, int]],
    min_width: int,
    batch_reads: int,
    with_quals: bool,
    queue_depth: int,
    qual_mode: str | None = None,
) -> Iterator[PackedReads]:
    """Producer pool over explicit byte ranges (the byte_range path)."""
    q: queue.Queue = queue.Queue(maxsize=queue_depth)
    errors: list[BaseException] = []
    stop = threading.Event()

    def produce(start: int, end: int, check_format: bool, range_id: int):
        try:
            for pb in _packed_range_iter(
                path, start, end, min_width, batch_reads, with_quals,
                check_format, range_id,
            ):
                if stop.is_set():
                    return
                q.put(_maybe_transpose(pb, qual_mode))
        except BaseException as e:
            errors.append(e)
        finally:
            q.put(_SENTINEL)

    threads = [
        threading.Thread(
            target=produce, args=(s, e, i == 0, i), daemon=True
        )
        for i, (s, e) in enumerate(ranges)
    ]
    for t in threads:
        t.start()
    live = len(threads)
    try:
        while live:
            item = q.get()
            if item is _SENTINEL:
                live -= 1
                continue
            yield item
        if errors:
            raise errors[0]
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def _packed_range_iter(
    path: str,
    start: int,
    end: int,
    min_width: int,
    batch_reads: int,
    with_quals: bool,
    check_format: bool,
    range_id: int = 0,
):
    """read_fastq_native_packed over a byte range (plain files)."""
    import ctypes

    import numpy as np

    from ngs_barcode_count_tpu.io.fastq import FastqFormatError

    lib = native.get_lib()
    first = ctypes.c_int(0)
    second = ctypes.c_int(0)
    maxlen = lib.fastq_scan_max_len(
        path.encode(), 0, 4 << 20, ctypes.byref(first), ctypes.byref(second)
    )
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
    width = -(-width // 4) * 4
    width = -(-width // 32) * 32
    cap_exc = max(4096, batch_reads * width // 64)

    h = lib.fastq_open_range(path.encode(), 8 << 20, start, end)
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
            if n == -1:
                cap_exc = max(cap_exc * 2, -nexc.value)
                continue
            if n < -1:
                width = -(-(-n) // 32) * 32
                continue
            ne = nexc.value
            exc_idx[ne:] = -1
            # frontier offset for checkpointing: absolute file offset of
            # the next unconsumed record in THIS range (valid only when
            # the codec holds no pending record)
            tell = (
                int(lib.fastq_tell(h))
                if not lib.fastq_has_pending(h)
                else -1
            )
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
                next_offset=tell, range_id=range_id,
            )
    finally:
        lib.fastq_close(h)
