#!/usr/bin/env python
"""BASELINE config 4 benchmark: random-barcode (PCR-dedup) mode with a
combo space too large for the device bytemap, i.e. the keyed wire path
with host-side dedup.  Prints one JSON line (same shape as bench.py).

Env: NGS_BENCH_READS (default 4M), NGS_BENCH_BATCH, NGS_BENCH_DIR.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BASELINE_READS_PER_S = 294_000.0

SCHEME_TEXT = """\
[10]
AGCTACGAATCG
{6}
TGGA
{6}
TGGA
{6}
ACTAGAT
(8)
TAGA
"""


def main():
    n_reads = int(os.environ.get("NGS_BENCH_READS", 4_000_000))
    batch_size = int(os.environ.get("NGS_BENCH_BATCH", 1 << 17))
    workdir = os.environ.get("NGS_BENCH_DIR", os.path.join(ROOT, ".bench"))
    os.makedirs(workdir, exist_ok=True)

    from bench import SAMPLES, _barcode_sets

    from ngs_barcode_count_tpu.runner import (
        CountAccumulator,
        RunConfig,
        _enable_compile_cache,
        decode_file,
        setup,
    )
    from ngs_barcode_count_tpu.scheme import parse_scheme_text
    from ngs_barcode_count_tpu.utils import simulate_fast

    rng = np.random.default_rng(2024)
    scheme = parse_scheme_text(SCHEME_TEXT)
    sets = _barcode_sets(rng)
    scheme_path = os.path.join(workdir, "scheme_random.txt")
    fastq = os.path.join(workdir, f"bench_random_{n_reads}.fastq")
    samples_path = os.path.join(workdir, "samples.csv")
    barcodes_path = os.path.join(workdir, "barcodes.csv")
    with open(scheme_path, "w") as f:
        f.write(SCHEME_TEXT)
    with open(samples_path, "w") as f:
        f.write("Barcode,Sample_ID\n")
        for i, s in enumerate(SAMPLES):
            f.write(f"{s},Sample_{i + 1}\n")
    with open(barcodes_path, "w") as f:
        f.write("Barcode,Barcode_ID,Barcode_Number\n")
        for pos, bset in enumerate(sets, start=1):
            for j, b in enumerate(bset):
                f.write(f"{b},BC{pos}_{j},{pos}\n")
    if not os.path.exists(fastq):
        left, first = n_reads, True
        while left > 0:
            n = min(1_000_000, left)
            seq, qual = simulate_fast.generate_reads(
                rng, scheme, n, SAMPLES, sets, sub_error_rate=0.01
            )
            simulate_fast.write_fastq_bytes(fastq, seq, qual, append=not first)
            first = False
            left -= n

    _enable_compile_cache()
    cfg = RunConfig(
        fastq=fastq, format=scheme_path,
        sample_barcodes_option=samples_path,
        counted_barcodes_option=barcodes_path,
        output_dir=workdir, prefix="bench_random",
        batch_size=batch_size, progress=False,
    )
    scheme, conv, me, plan, _ = setup(cfg)
    assert not plan.dense_counts
    mode = None  # derived from the accumulator actually built below
    # (the runner's NGS_DEVICE_DEDUP default is link-aware since r4)

    # big-combo path only: forbid the bytemap even if it would fit;
    # the production default then engages the device hash-set dedup
    # (NGS_DEVICE_DEDUP=0 measures the host keyed path instead)
    os.environ["NGS_BITMAP_LIMIT_BYTES"] = "1"

    # warmup (compile)
    acc0 = CountAccumulator(plan, conv)
    decode_file(cfg, plan, scheme, acc0, limit_batches=1)
    acc0.finalize()

    times = []
    for _ in range(2):
        acc = CountAccumulator(plan, conv)
        if mode is None:
            mode = (
                "device_hashset" if acc.hashset is not None
                else "device_bitmap" if acc.bitmap is not None
                else "host_keyed"
            )
        t0 = time.perf_counter()
        total = decode_file(cfg, plan, scheme, acc)
        acc.finalize()
        times.append(time.perf_counter() - t0)
    elapsed = sum(times) / len(times)
    rps = total / elapsed
    from ngs_barcode_count_tpu import stats as S

    print(json.dumps({
        "metric": "random_mode_reads_per_second",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_S, 3),
        "detail": {
            "n_reads": total,
            "elapsed_s": round(elapsed, 3),
            "best_pass_reads_per_s": round(total / min(times), 1),
            "matched": int(acc.seq_errors.counters[S.MATCHED]),
            "duplicates": int(acc.seq_errors.counters[S.DUPLICATES]),
            "batch_size": batch_size,
            "mode": mode,
        },
    }))


if __name__ == "__main__":
    main()
