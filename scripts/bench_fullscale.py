#!/usr/bin/env python
"""Production-scale run: the BASELINE north star is a 400M-read DEL run
(reference README.md:154-189 ran 418.77M reads in ~24 min on 8 CPU
threads).  This drives the real pipeline — CLI-equivalent config, merged
+ enriched outputs, periodic checkpointing — over the largest cached
fixture (default 200M reads; NGS_FULLSCALE_READS overrides) and writes
fullscale.json in NGS_BENCH_DIR with compute/total throughput and the
stat counters.

Run on the GPU:
  python scripts/bench_fullscale.py
"""

import datetime as dt
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BASELINE_READS_PER_S = 294_000.0


def main():
    workdir = os.environ.get("NGS_BENCH_DIR", os.path.join(ROOT, ".bench"))
    n_reads = int(os.environ.get("NGS_FULLSCALE_READS", 200_000_000))
    from bench import prepare_inputs

    from ngs_barcode_count_tpu.output import (
        WriteFiles,
        WriterConfig,
        elapsed_display,
    )
    from ngs_barcode_count_tpu.runner import (
        CountAccumulator,
        RunConfig,
        _enable_compile_cache,
        decode_file,
        setup,
    )

    _enable_compile_cache()
    fastq, scheme_path, samples_path, barcodes_path = prepare_inputs(
        workdir, n_reads
    )
    out_dir = os.path.join(workdir, "fullscale")
    os.makedirs(out_dir, exist_ok=True)
    cfg = RunConfig(
        fastq=fastq,
        format=scheme_path,
        sample_barcodes_option=samples_path,
        counted_barcodes_option=barcodes_path,
        output_dir=out_dir,
        prefix="fs",
        batch_size=int(os.environ.get("NGS_BENCH_BATCH", 1 << 17)),
        progress=False,
        merge_output=True,
        enrich=True,
        checkpoint_interval_s=float(
            os.environ.get("NGS_FULLSCALE_CKPT_S", 300)
        ),
    )
    scheme, conv, max_errors, plan, _ = setup(cfg)

    start = dt.datetime.now()
    t0 = time.perf_counter()
    acc = CountAccumulator(plan, conv)
    total = decode_file(cfg, plan, scheme, acc)
    acc.finalize()
    compute_s = time.perf_counter() - t0

    results = acc.results_view()
    wcfg = WriterConfig(
        fastq=cfg.fastq, format=cfg.format,
        sample_barcodes_option=cfg.sample_barcodes_option,
        counted_barcodes_option=cfg.counted_barcodes_option,
        output_dir=out_dir, prefix="fs", merge_output=True, enrich=True,
    )
    t1 = time.perf_counter()
    writer = WriteFiles(
        results, scheme, conv.counted_barcodes_hash,
        conv.samples_barcode_hash, wcfg,
    )
    writer.write_counts_files()
    writer.write_stats_file(
        start, max_errors, acc.seq_errors, total, scheme
    )
    write_s = time.perf_counter() - t1
    total_s = time.perf_counter() - t0

    rec = {
        "metric": "fullscale_reads_per_second",
        "value": round(total / compute_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(total / compute_s / BASELINE_READS_PER_S, 3),
        "detail": {
            "n_reads": total,
            "compute_s": round(compute_s, 1),
            "write_s": round(write_s, 1),
            "total_s": round(total_s, 1),
            "total_elapsed_display": elapsed_display(
                dt.datetime.now() - start
            ),
            "counters": [int(c) for c in acc.seq_errors.counters],
            "matched": acc.seq_errors.matched,
            "output_files": writer.output_files,
            "checkpoint_interval_s": cfg.checkpoint_interval_s,
        },
    }
    print(json.dumps(rec))
    with open(os.path.join(workdir, "fullscale.json"), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
