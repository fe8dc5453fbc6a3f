#!/usr/bin/env python
"""Parallel synthetic-FASTQ fixture generator for the north-star-scale
benchmarks (the reference's published run is 418.77M reads,
/root/reference/README.md:155-172; BASELINE.md's target is a 400M-read
run).  bench.prepare_inputs generates sequentially at ~250k reads/s/core
— fine for 10M, ~27 min for 400M — so this pre-generates the same-shaped
fixture with N worker processes, each pwriting fixed-size 145-byte
records at its own byte offset (records are fixed-length, so workers
never contend).

The barcode/sample CSVs and the scheme are written exactly as
bench.prepare_inputs writes them (same rng seed for the barcode sets),
so a later bench/fullscale run reuses this file as a cache hit.

Usage:
  python scripts/gen_fixture.py 400000000 [workdir] [--workers N]
        [--random]   # append an (8) random slot to the scheme (config-4
                     # shape) — writes bench_rand_{n}.fastq
"""

import argparse
import os
import sys
from multiprocessing import Process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

CHUNK = 1_000_000


def _worker(
    path: str,
    scheme_text: str,
    samples,
    sets,
    start_read: int,
    n_reads: int,
    rec_bytes: int,
    seed: int,
):
    from ngs_barcode_count_tpu.scheme import parse_scheme_text
    from ngs_barcode_count_tpu.utils import simulate_fast

    scheme = parse_scheme_text(scheme_text)
    rng = np.random.default_rng(seed)
    fd = os.open(path, os.O_WRONLY)
    try:
        done = 0
        while done < n_reads:
            n = min(CHUNK, n_reads - done)
            seq, qual = simulate_fast.generate_reads(
                rng, scheme, n, samples, sets, sub_error_rate=0.01
            )
            L = seq.shape[1]
            rec = 3 + (L + 1) + 2 + (L + 1)
            assert rec == rec_bytes, (rec, rec_bytes)
            buf = np.empty((n, rec), dtype=np.uint8)
            buf[:, 0] = ord("@")
            buf[:, 1] = ord("r")
            buf[:, 2] = ord("\n")
            buf[:, 3 : 3 + L] = seq
            buf[:, 3 + L] = ord("\n")
            buf[:, 4 + L] = ord("+")
            buf[:, 5 + L] = ord("\n")
            buf[:, 6 + L : 6 + 2 * L] = qual
            buf[:, 6 + 2 * L] = ord("\n")
            os.pwrite(fd, buf.tobytes(), (start_read + done) * rec_bytes)
            done += n
    finally:
        os.close(fd)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_reads", type=int)
    ap.add_argument("workdir", nargs="?", default=os.environ.get(
        "NGS_BENCH_DIR", os.path.join(ROOT, ".bench")))
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--random", action="store_true",
                    help="config-4 shape: scheme gains an (8) random slot")
    args = ap.parse_args()

    from bench import SAMPLES, SCHEME_TEXT, _barcode_sets
    from ngs_barcode_count_tpu.scheme import parse_scheme_text

    scheme_text = SCHEME_TEXT
    name = f"bench_{args.n_reads}.fastq"
    if args.random:
        scheme_text = SCHEME_TEXT + "(8)\nGACT\n"
        name = f"bench_rand_{args.n_reads}.fastq"

    os.makedirs(args.workdir, exist_ok=True)
    path = os.path.join(args.workdir, name)
    if os.path.exists(path):
        print(f"{path} exists; nothing to do")
        return

    rng = np.random.default_rng(2024)
    scheme = parse_scheme_text(scheme_text)
    sets = _barcode_sets(rng)

    # same side files bench.prepare_inputs writes (content-identical)
    with open(os.path.join(args.workdir, "scheme.txt"), "w") as f:
        f.write(SCHEME_TEXT)
    if args.random:
        with open(os.path.join(args.workdir, "scheme_rand.txt"), "w") as f:
            f.write(scheme_text)
    with open(os.path.join(args.workdir, "samples.csv"), "w") as f:
        f.write("Barcode,Sample_ID\n")
        for i, s in enumerate(SAMPLES):
            f.write(f"{s},Sample_{i + 1}\n")
    with open(os.path.join(args.workdir, "barcodes.csv"), "w") as f:
        f.write("Barcode,Barcode_ID,Barcode_Number\n")
        for pos, bset in enumerate(sets, start=1):
            for j, b in enumerate(bset):
                f.write(f"{b},BC{pos}_{j},{pos}\n")

    L = scheme.length + 4 + 6  # flank_left + F + flank_right
    rec_bytes = 3 + (L + 1) + 2 + (L + 1)
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.truncate(args.n_reads * rec_bytes)

    per = (args.n_reads + args.workers - 1) // args.workers
    procs = []
    for w in range(args.workers):
        start = w * per
        n = min(per, args.n_reads - start)
        if n <= 0:
            break
        p = Process(
            target=_worker,
            args=(tmp, scheme_text, SAMPLES, sets, start, n, rec_bytes,
                  2024 + 7919 * w),
        )
        p.start()
        procs.append(p)
    rc = 0
    for p in procs:
        p.join()
        rc |= p.exitcode or 0
    if rc:
        print(f"worker failed (rc={rc}); leaving {tmp}", file=sys.stderr)
        sys.exit(1)
    os.rename(tmp, path)
    print(f"wrote {path} ({args.n_reads} reads, "
          f"{args.n_reads * rec_bytes / 1e9:.1f} GB)")


if __name__ == "__main__":
    main()
