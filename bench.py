#!/usr/bin/env python
"""Benchmark: end-to-end decode throughput (reads/s) on a DEL workload.

Prints ONE JSON line:
  {"metric": "reads_per_second", "value": N, "unit": "reads/s",
   "vs_baseline": N / 294_000}

Baseline: the reference's published 418.77M reads in 23m43s compute on 8
CPU threads = ~294k reads/s (BASELINE.md, reference README.md:155-172).

The measured window is the steady-state pipeline — FASTQ bytes on disk
-> host encode -> device decode/count -> final count fetch — after one
untimed warmup batch (the first compile is a one-time set-up cost).

Runs on the GPU; with no GPU it exits non-zero unless JAX_PLATFORMS=cpu
pins it to the CPU backend on purpose.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np

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
TAGA
"""

SAMPLES = ["AGCATACGTT", "AACTTACCAT", "TTGGCATCAG", "CGATTACAGT"]


def _barcode_sets(rng, n_per_pos=96, length=6, positions=3):
    sets = []
    for _ in range(positions):
        seen = set()
        while len(seen) < n_per_pos:
            seen.add("".join("ACGT"[i] for i in rng.integers(0, 4, length)))
        sets.append(sorted(seen))
    return sets


def prepare_inputs(workdir: str, n_reads: int):
    from ngs_barcode_count_tpu.scheme import parse_scheme_text
    from ngs_barcode_count_tpu.utils import simulate_fast

    os.makedirs(workdir, exist_ok=True)
    scheme_path = os.path.join(workdir, "scheme.txt")
    fastq_path = os.path.join(workdir, f"bench_{n_reads}.fastq")
    samples_path = os.path.join(workdir, "samples.csv")
    barcodes_path = os.path.join(workdir, "barcodes.csv")

    rng = np.random.default_rng(2024)
    scheme = parse_scheme_text(SCHEME_TEXT)
    sets = _barcode_sets(rng)

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

    if not os.path.exists(fastq_path):
        chunk = 1_000_000
        first = True
        left = n_reads
        while left > 0:
            n = min(chunk, left)
            seq, qual = simulate_fast.generate_reads(
                rng, scheme, n, SAMPLES, sets, sub_error_rate=0.01
            )
            simulate_fast.write_fastq_bytes(
                fastq_path, seq, qual, append=not first
            )
            first = False
            left -= n
    return fastq_path, scheme_path, samples_path, barcodes_path


def _rowmajor(pb):
    """Direct PackedReads consumers: undo the col-major wire layout."""
    if getattr(pb, "transposed", False):
        import numpy as _np

        pb.packed = _np.ascontiguousarray(pb.packed.T)
        if getattr(pb, "quals_packed", None) is not None:
            pb.quals_packed = _np.ascontiguousarray(pb.quals_packed.T)
        pb.transposed = False
    return pb

def require_gpu():
    """JAX's devices, or exit non-zero when they are not GPUs and the run
    was not pinned to the CPU on purpose (JAX_PLATFORMS=cpu)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        sys.exit(
            f"bench.py: no GPU found (platform {devs[0].platform}); "
            "set JAX_PLATFORMS=cpu to measure the CPU backend"
        )
    return devs


def main():
    import jax

    devs = require_gpu()
    from ngs_barcode_count_tpu.utils.tracing import gpu_name_and_power_limit

    print(
        f"[bench] device platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)} "
        f"nvidia-smi: {gpu_name_and_power_limit()}",
        file=sys.stderr,
    )

    workdir = os.environ.get("NGS_BENCH_DIR", os.path.join(ROOT, ".bench"))
    # default: the longest FASTQ already generated in the workdir (a 50M
    # sustained run when cached; 10M otherwise — generating 50M fresh
    # costs ~12 CPU-minutes, too slow for a default)
    default_reads = 10_000_000
    for n in (50_000_000, 20_000_000):
        if os.path.exists(os.path.join(workdir, f"bench_{n}.fastq")):
            default_reads = n
            break
    n_reads = int(os.environ.get("NGS_BENCH_READS", default_reads))
    batch_size = int(os.environ.get("NGS_BENCH_BATCH", 1 << 17))
    fastq, scheme_path, samples_path, barcodes_path = prepare_inputs(
        workdir, n_reads
    )

    from ngs_barcode_count_tpu.runner import (
        CountAccumulator,
        RunConfig,
        _enable_compile_cache,
        decode_file,
        setup,
    )

    _enable_compile_cache()
    cfg = RunConfig(
        fastq=fastq,
        format=scheme_path,
        sample_barcodes_option=samples_path,
        counted_barcodes_option=barcodes_path,
        output_dir=workdir,
        prefix="bench",
        batch_size=batch_size,
        progress=False,
    )
    scheme, conv, max_errors, plan, _ = setup(cfg)

    # Warmup: compile the step, untimed.
    acc0 = CountAccumulator(plan, conv)
    decode_file(cfg, plan, scheme, acc0, limit_batches=1)
    acc0.finalize()

    # Timed end-to-end passes.  The headline is the SUSTAINED number
    # (total reads / total time across both passes); the best pass is
    # reported in detail.
    times = []
    for _ in range(2):
        acc = CountAccumulator(plan, conv)
        t0 = time.perf_counter()
        total = decode_file(cfg, plan, scheme, acc)
        acc.finalize()
        times.append(time.perf_counter() - t0)
    elapsed = sum(times) / len(times)
    rps = total / elapsed
    best_rps = total / min(times)

    # Device-resident decode throughput: one batch staged on device, K
    # repeated steps — isolates the decode+count step from the host.
    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )
    from ngs_barcode_count_tpu.ops import decode as dec

    pb = _rowmajor(next(iter(read_fastq_packed_parallel(
        fastq, min_width=scheme.length, batch_reads=batch_size,
    ))))
    d_packed = jax.device_put(pb.packed)
    d_lengths = jax.device_put(pb.lengths)
    d_exc_i = jax.device_put(pb.exc_idx)
    d_exc_v = jax.device_put(pb.exc_val)
    d_n = jax.device_put(np.array([pb.n_reads], np.int32))

    def dev_step(state, counters):
        return dec.dense_count_step_packed(
            plan, state, counters, d_packed, d_lengths, d_exc_i, d_exc_v,
            pb.width, d_n,
        )

    def time_dev(step_fn, K=20):
        acc_w = CountAccumulator(plan, conv)
        state, counters = step_fn(acc_w.dense_state, acc_w.dense_counters)
        counters.block_until_ready()
        acc_t = CountAccumulator(plan, conv)
        state, counters = acc_t.dense_state, acc_t.dense_counters
        t0 = time.perf_counter()
        for _ in range(K):
            state, counters = step_fn(state, counters)
        counters.block_until_ready()
        return K * pb.n_reads / (time.perf_counter() - t0)

    dev_rps = time_dev(dev_step)

    # ingest-only throughput (host side, no device work)
    t0 = time.perf_counter()
    n_ing = 0
    for pb2 in read_fastq_packed_parallel(
        fastq, min_width=scheme.length, batch_reads=batch_size,
    ):
        n_ing += pb2.n_reads
    ingest_rps = n_ing / (time.perf_counter() - t0)

    matched = acc.seq_errors.matched
    print(
        json.dumps(
            {
                "metric": "reads_per_second",
                "value": round(rps, 1),
                "unit": "reads/s",
                "vs_baseline": round(rps / BASELINE_READS_PER_S, 3),
                "detail": {
                    "platform": devs[0].platform,
                    "device_kind": devs[0].device_kind,
                    "device_count": len(devs),
                    "gpu_name_power_limit": gpu_name_and_power_limit(),
                    "n_reads": total,
                    "elapsed_s": round(elapsed, 3),
                    "best_pass_reads_per_s": round(best_rps, 1),
                    "matched": matched,
                    "batch_size": batch_size,
                    "device_resident_reads_per_s": round(dev_rps, 1),
                    "device_resident_vs_baseline": round(
                        dev_rps / BASELINE_READS_PER_S, 2
                    ),
                    "ingest_reads_per_s": round(ingest_rps, 1),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
