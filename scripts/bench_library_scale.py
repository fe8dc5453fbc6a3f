#!/usr/bin/env python
"""Library-size scaling: decode throughput vs candidate-set size.

The reference's fix_error (parse.rs:553-593) is a linear scan — decode
cost grows ~linearly with the barcode library. Here matching is a
matmul against the candidate matrix, so throughput should stay nearly
flat into the tens of thousands of candidates per position (the DEL
mega-library case). This script measures the device-resident packed
dense XLA step for geometrically growing per-position library sizes and
prints one JSON line with the sweep.

Run on the GPU:
    python scripts/bench_library_scale.py
Env: NGS_LIB_SIZES (default "96,1024,4096,16384"), NGS_PROF_BATCH,
NGS_PROF_REPS, NGS_BENCH_DIR.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BASELINE_READS_PER_S = 294_000.0


def _sets(rng, n_per_pos, length, positions=3):
    sets = []
    for _ in range(positions):
        seen = set()
        while len(seen) < n_per_pos:
            chunk = rng.integers(0, 4, (4096, length))
            for row in chunk:
                seen.add("".join("ACGT"[int(i)] for i in row))
                if len(seen) == n_per_pos:
                    break
        sets.append(sorted(seen))
    return sets


def main():
    sizes = [
        int(s)
        for s in os.environ.get(
            "NGS_LIB_SIZES", "96,1024,4096,16384"
        ).split(",")
    ]
    batch = int(os.environ.get("NGS_PROF_BATCH", 1 << 17))
    reps = int(os.environ.get("NGS_PROF_REPS", 10))
    workdir = os.environ.get("NGS_BENCH_DIR", os.path.join(ROOT, ".bench"))
    os.makedirs(workdir, exist_ok=True)
    blen = 9  # 9-mers: 262k possible codes (CRISPR guide / bar-seq case)

    from ngs_barcode_count_tpu.conversions import (
        BarcodeConversions,
        BarcodeSet,
    )
    from ngs_barcode_count_tpu.errors import MaxSeqErrors
    from ngs_barcode_count_tpu.ops import decode as dec
    from ngs_barcode_count_tpu.runner import _enable_compile_cache
    from ngs_barcode_count_tpu.scheme import parse_scheme_text
    from ngs_barcode_count_tpu.utils import simulate_fast

    _enable_compile_cache()
    # ONE counted position, as in CRISPR-guide / bar-seq mega-libraries
    # (multi-position DEL spaces stay per-position <= a few hundred; a
    # single position is where libraries reach 10k-100k candidates)
    scheme = parse_scheme_text(
        "[10]\nAGCTACGAATCG\n{9}\nACTAGAT\nTAGA\n"
    )
    samples = ["AGCATACGTT", "AACTTACCAT", "TTGGCATCAG", "CGATTACAGT"]
    rng = np.random.default_rng(7)
    big = _sets(rng, max(sizes), blen, positions=1)

    # one FASTQ drawn from the LARGEST library, reused for every size
    # (smaller libraries then see many barcode-mismatch reads — decode
    # cost is what we measure, not match rate)
    fq = os.path.join(workdir, f"bench_lib_{max(sizes)}_{batch}.fastq")
    if not os.path.exists(fq):
        seq, qual = simulate_fast.generate_reads(
            rng, scheme, batch, samples, big, sub_error_rate=0.01
        )
        simulate_fast.write_fastq_bytes(fq, seq, qual, append=False)

    import jax

    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )
    pb = next(iter(read_fastq_packed_parallel(
        fq, min_width=scheme.length, batch_reads=batch,
    )))
    if getattr(pb, "transposed", False):
        pb.packed = np.ascontiguousarray(pb.packed.T)
        pb.transposed = False
    d = [
        jax.device_put(pb.packed), jax.device_put(pb.lengths),
        jax.device_put(pb.exc_idx), jax.device_put(pb.exc_val),
        jax.device_put(np.array([pb.n_reads], np.int32)),
    ]
    sweep = []
    for n in sizes:
        sets = [s[:n] for s in big]
        conv = BarcodeConversions()
        conv.samples_barcode_hash = {
            s: f"S{i}" for i, s in enumerate(samples)
        }
        conv.sample_set = BarcodeSet.from_pairs(
            [(s, f"S{i}") for i, s in enumerate(samples)], 10
        )
        conv.counted_barcodes_hash = [
            {b: f"B{i}_{j}" for j, b in enumerate(s)}
            for i, s in enumerate(sets)
        ]
        conv.counted_sets = [
            BarcodeSet.from_pairs(
                [(b, f"B{i}_{j}") for j, b in enumerate(s)], blen
            )
            for i, s in enumerate(sets)
        ]
        me = MaxSeqErrors.create(
            None, 10, None, [blen], None,
            scheme.constant_region_length, 0.0,
        )
        plan = dec.make_plan(scheme, conv, me)
        import jax.numpy as jnp

        from ngs_barcode_count_tpu import stats

        def step(state, ctr, plan=plan):
            return dec.dense_count_step_packed(
                plan, state, ctr, d[0], d[1], d[2], d[3], pb.width, d[4],
            )

        state = jnp.zeros(plan.n_samples * plan.n_combos, jnp.int32)
        ctr = jnp.zeros(stats.NUM_COUNTERS, jnp.int32)
        state, ctr = step(state, ctr)
        np.asarray(ctr)  # real sync
        t0 = time.perf_counter()
        for _ in range(reps):
            state, ctr = step(state, ctr)
        matched = int(np.asarray(ctr)[stats.MATCHED])
        el = time.perf_counter() - t0
        rps = reps * pb.n_reads / el
        sweep.append({
            "library_per_position": n,
            "reads_per_s": round(rps, 1),
            "ns_per_read": round(1e9 * el / (reps * pb.n_reads), 1),
            "matched_total": matched,
        })
        print(f"# n={n:6d} {rps/1e6:7.2f} M reads/s",
              file=sys.stderr, flush=True)

    base = sweep[0]["reads_per_s"]
    print(json.dumps({
        "metric": "library_scale_device_reads_per_second",
        "value": sweep[-1]["reads_per_s"],
        "unit": "reads/s",
        "vs_baseline": round(sweep[-1]["reads_per_s"] / BASELINE_READS_PER_S, 3),
        "detail": {
            "sweep": sweep,
            "slowdown_96_to_max": round(base / sweep[-1]["reads_per_s"], 2),
            "batch": pb.n_reads,
        },
    }))


if __name__ == "__main__":
    main()
