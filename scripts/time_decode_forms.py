#!/usr/bin/env python
"""Time the XLA dense step's tuned forms, host ingest and the device's
busy share, on the flagship DEL inputs of chip_smoke.py.

  1. the dense step, device-resident, for each scan-lane pad (8/16/32/128)
     and each scan one-hot form: the kept ``jax.nn.one_hot(axis=1)``
     form and the concatenation of five compares it replaced; every
     variant must give the same counts;
  2. ingest only: draining ``read_fastq_packed_parallel`` over the FASTQ;
  3. the dense CLI run untraced and with ``--profile-dir``: the device's
     busy time is the union of the events on the GPU's stream lines in
     the trace; the idle share is given over the traced run's host span
     and, beside it, the busy share over the untraced decode window.

    python scripts/time_decode_forms.py     # on a GPU, 3M reads

Inputs and the trace go to <repo>/.bench/time_decode_forms.
"""

import glob
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ngs_barcode_count_tpu import stats  # noqa: E402
from ngs_barcode_count_tpu.io.parallel_ingest import (  # noqa: E402
    read_fastq_packed_parallel,
)
from ngs_barcode_count_tpu.ops import decode as dec  # noqa: E402
from ngs_barcode_count_tpu.runner import RunConfig, setup  # noqa: E402

WORKDIR = os.path.join(ROOT, ".bench", "time_decode_forms")
LANES = (8, 16, 32, 128)


def concat_onehot(bases):
    """The replaced scan one-hot: five compares concatenated c-major."""
    return jnp.concatenate(
        [(bases == c).astype(jnp.bfloat16) for c in range(5)], axis=1
    )


FORMS = {"one_hot": dec._onehot_cmajor, "concat": concat_onehot}


def fresh_plan(files, batch):
    """A new DecodePlan (identity-hashed, so the step traces anew)."""
    f = files["flagship"]
    cfg = RunConfig(fastq=f["fastq"], format=f["scheme"],
                    sample_barcodes_option=files["samples"],
                    counted_barcodes_option=files["barcodes"],
                    batch_size=batch, progress=False)
    return setup(cfg)


def first_batch(files, batch):
    scheme = fresh_plan(files, batch)[0]
    gen = read_fastq_packed_parallel(
        files["flagship"]["fastq"], min_width=scheme.length,
        batch_reads=batch,
    )
    pb = next(iter(gen))
    gen.close()
    if pb.transposed:
        pb.packed = np.ascontiguousarray(pb.packed.T)
    return pb


def time_forms(files, batch, steps=100, rounds=2):
    """{(form, lane): [seconds per step, one per round]}; raises if any
    variant's counts differ from the first."""
    pb = first_batch(files, batch)
    args = [jax.device_put(x) for x in (
        pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
        np.array([pb.n_reads], np.int32),
    )]
    saved = dec.SCAN_LANE, dec._onehot_cmajor
    times, ref = {}, None
    try:
        for _ in range(rounds):
            for form, fn in FORMS.items():
                for lane in LANES:
                    dec.SCAN_LANE, dec._onehot_cmajor = lane, fn
                    plan = fresh_plan(files, batch)[3]

                    def zeros():
                        return (
                            jnp.zeros(plan.n_samples * plan.n_combos,
                                      jnp.int32),
                            jnp.zeros(stats.NUM_COUNTERS, jnp.int32),
                        )

                    def step(c, k):
                        return dec.dense_count_step_packed(
                            plan, c, k, args[0], args[1], args[2], args[3],
                            pb.width, args[4],
                        )

                    c, k = step(*zeros())
                    got = np.asarray(c)
                    if ref is None:
                        ref = got
                    elif not np.array_equal(got, ref):
                        raise AssertionError(
                            f"{form}/{lane}: counts differ"
                        )
                    c, k = zeros()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        c, k = step(c, k)
                    k.block_until_ready()
                    dt = (time.perf_counter() - t0) / steps
                    times.setdefault((form, lane), []).append(dt)
    finally:
        dec.SCAN_LANE, dec._onehot_cmajor = saved
    return times, pb.n_reads


def ingest_rate(files, batch) -> float:
    scheme = fresh_plan(files, batch)[0]
    t0 = time.perf_counter()
    n = 0
    for b in read_fastq_packed_parallel(
        files["flagship"]["fastq"], min_width=scheme.length,
        batch_reads=batch,
    ):
        n += b.n_reads
    return n / (time.perf_counter() - t0)


def device_busy(trace_dir):
    """(busy ns on the GPU stream lines, host span ns) of one trace."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    intervals, host = [], []
    for plane in ProfileData.from_file(path).planes:
        for line in plane.lines:
            evs = [(e.start_ns, e.end_ns) for e in line.events]
            if not evs:
                continue
            if (plane.name.startswith("/device:GPU")
                    and "stream" in line.name.lower()):
                intervals += evs
            elif plane.name.startswith("/host"):
                host += evs
    intervals.sort()
    busy, cur = 0, None
    for s, e in intervals:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    span = (max(e for _, e in host) - min(s for s, _ in host)) if host else 0
    return busy, span


def main() -> int:
    batch = cs.BATCH_SIZE
    from ngs_barcode_count_tpu.runner import _enable_compile_cache
    from ngs_barcode_count_tpu.utils.tracing import gpu_name_and_power_limit

    _enable_compile_cache()
    devs = jax.devices()
    print(f"devices: {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
          f"nvidia-smi: {gpu_name_and_power_limit()}", flush=True)
    files = cs.make_inputs(WORKDIR, cs.READS, oracle_reads=1)

    times, rows = time_forms(files, batch)
    for (form, lane), ts in times.items():
        print(f"step {form} lane {lane}: "
              + ", ".join(f"{t * 1e3:.3f}" for t in ts)
              + f" ms/step ({rows} reads), counts equal", flush=True)
    for _ in range(2):
        print(f"ingest-only: {ingest_rate(files, batch):.0f} reads/s "
              f"(cpu_count {os.cpu_count()})", flush=True)

    out = os.path.join(WORKDIR, "out")
    trace = os.path.join(WORKDIR, "trace")
    shutil.rmtree(trace, ignore_errors=True)  # one trace in the directory
    for d in (out, trace):
        os.makedirs(d, exist_ok=True)
    args = cs.phase_args("dense", files, files["flagship"]["fastq"], out,
                         batch)
    log = os.path.join(WORKDIR, "cli.log")
    cs.run_cli(args, log)  # warm: compile outside the measured runs
    rc, rec = cs.run_cli(args, log)
    rc_t, rec_t = cs.run_cli(args + ["--profile-dir", trace], log)
    if rc or rc_t:
        print(f"CLI run failed (rc {rc}, {rc_t}); see {log}", file=sys.stderr)
        return 1
    plain, traced = rec["result"], rec_t["result"]
    busy, span = device_busy(trace)
    print(f"untraced: {plain.reads_per_second:.0f} reads/s, decode window "
          f"{plain.compute_seconds * 1e3:.1f} ms", flush=True)
    print(f"traced: {traced.reads_per_second:.0f} reads/s, decode window "
          f"{traced.compute_seconds * 1e3:.1f} ms", flush=True)
    print(f"device busy {busy / 1e6:.1f} ms; idle share over the traced "
          f"host span ({span / 1e6:.1f} ms): "
          f"{1 - busy / span if span else float('nan'):.4f}; busy share "
          f"of the untraced decode window: "
          f"{busy / 1e9 / plain.compute_seconds:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
