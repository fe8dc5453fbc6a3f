#!/usr/bin/env python
"""Smoke check: the counter's main path on one NVIDIA GPU.

Drives the CLI (``ngs_barcode_count_tpu.cli.main``) in this process,
phase by phase, at the flagship DEL shape of bench.py ([10]/{6}x3, 4
samples, 3 positions x 96 six-mers: a 14 MB dense count tensor), on
FASTQs generated from a fixed seed:

  dense    -s -c -m -e: the dense count tensor on the device
  quality  --min-quality 20 over binned Phred scores
  keyed    -s only: counted barcodes keyed by raw DNA (BASELINE config 1)
  random   an (8) random barcode: device hash-set PCR-duplicate dedup
  resume   dense with --checkpoint-interval, stopped after the first
           snapshot, then --resume

Every phase's count CSVs and stats counters must be byte-identical to
the same CLI run on the CPU, made by a child process pinned with
JAX_PLATFORMS=cpu (so only this process opens the card), and on the
first 20k reads both must equal the string oracle.  Any failure exits
non-zero; the last line of stdout is the JSON result only when every
phase passed.

    python chip_smoke.py          # one GPU, five phases (.smoke/)
    python chip_smoke.py --four   # the sharded engines on four GPUs
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from bench import SAMPLES, SCHEME_TEXT, _barcode_sets  # noqa: E402

PREFIX = "smoke"
SEED = 2024
# reads per FASTQ: one GPU, and --four (the resume phase stops at a batch
# boundary after its first snapshot, so a FASTQ must exceed two batches)
READS = 3_000_000
READS_FOUR = 2_000_000
BATCH_SIZE = 1 << 17
WORKDIR = os.path.join(ROOT, ".smoke")  # inputs and outputs: several GB
ORACLE_READS = 20_000
RANDOM_SCHEME_TEXT = SCHEME_TEXT.replace("ACTAGAT\nTAGA", "ACTAGAT\n(8)\nTAGA")
# binned Phred levels and their shares, as 4-level binning sequencers
# write them; the quality phase's --min-quality 20 drops a share of reads
QUAL_LEVELS = np.array([2, 12, 23, 37], np.uint8)
QUAL_CUM = np.cumsum([0.05, 0.10, 0.25, 0.60])
PHASES = ("dense", "quality", "keyed", "random", "resume")


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def make_inputs(workdir: str, n_reads: int, oracle_reads: int = ORACLE_READS,
                seed: int = SEED) -> dict:
    """Sample and barcode files, and for each scheme (flagship and
    random-barcode) its scheme file, a FASTQ of ``n_reads`` and a prefix
    FASTQ of its first ``oracle_reads`` reads (kept as strings for the
    oracle)."""
    from ngs_barcode_count_tpu.scheme import parse_scheme_text
    from ngs_barcode_count_tpu.utils import simulate_fast

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sets = _barcode_sets(rng)
    files = {
        "samples": os.path.join(workdir, "samples.csv"),
        "barcodes": os.path.join(workdir, "barcodes.csv"),
    }
    with open(files["samples"], "w") as f:
        f.write("Barcode,Sample_ID\n")
        for i, s in enumerate(SAMPLES):
            f.write(f"{s},Sample_{i + 1}\n")
    with open(files["barcodes"], "w") as f:
        f.write("Barcode,Barcode_ID,Barcode_Number\n")
        for pos, bset in enumerate(sets, start=1):
            for j, b in enumerate(bset):
                f.write(f"{b},BC{pos}_{j},{pos}\n")
    for name, text in (("flagship", SCHEME_TEXT),
                       ("random", RANDOM_SCHEME_TEXT)):
        scheme_path = os.path.join(workdir, f"{name}_scheme.txt")
        with open(scheme_path, "w") as f:
            f.write(text)
        scheme = parse_scheme_text(text)
        fq = os.path.join(workdir, f"{name}.fastq")
        pre = os.path.join(workdir, f"{name}_prefix.fastq")
        reads = quals = None
        left, first = n_reads, True
        while left > 0:
            n = min(1_000_000, left)
            seq, _ = simulate_fast.generate_reads(
                rng, scheme, n, SAMPLES, sets, sub_error_rate=0.01
            )
            qual = QUAL_LEVELS[
                np.searchsorted(QUAL_CUM, rng.random(seq.shape))
            ] + np.uint8(33)
            simulate_fast.write_fastq_bytes(fq, seq, qual, append=not first)
            if first:
                k = min(oracle_reads, n)
                simulate_fast.write_fastq_bytes(pre, seq[:k], qual[:k])
                reads = [r.tobytes().decode() for r in seq[:k]]
                quals = [q.tobytes().decode() for q in qual[:k]]
            left -= n
            first = False
        files[name] = {"scheme": scheme_path, "fastq": fq, "prefix": pre,
                       "reads": reads, "quals": quals}
    return files


def phase_args(phase: str, files: dict, fastq: str, out_dir: str,
               batch_size: int, extra: tuple = ()) -> list[str]:
    """CLI arguments of one phase's run over ``fastq``."""
    f = files["random" if phase == "random" else "flagship"]
    args = [
        "-f", fastq, "-q", f["scheme"], "-s", files["samples"],
        "-o", out_dir, "-p", PREFIX, "--no-progress",
        "--batch-size", str(batch_size),
    ]
    if phase != "keyed":
        args += ["-c", files["barcodes"]]
    if phase in ("dense", "resume"):
        args += ["-m", "-e"]
    if phase == "quality":
        args += ["--min-quality", "20"]
    if phase == "resume":
        args += ["--checkpoint-interval", "0.01"]
    return args + list(extra)


# ---------------------------------------------------------------------------
# running the CLI in-process and recording what it chose
# ---------------------------------------------------------------------------


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, and how many
    programs its persistent cache supplied or missed, from its
    monitoring events."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.hits = self.misses = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)
        jax.monitoring.register_event_listener(self._on_event)

    def _on(self, event, duration, **kwargs):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration

    def _on_event(self, event, **kwargs):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def snapshot(self):
        return self.seconds, self.hits, self.misses


@contextlib.contextmanager
def recording(rec: dict):
    """Wrap the CLI's call into the runner so one CLI call records its
    RunConfig and RunResult (which names the engine and wire chosen)."""
    from ngs_barcode_count_tpu import cli

    saved = cli.run

    def run(config):
        rec["config"] = config
        rec["result"] = saved(config)
        return rec["result"]

    cli.run = run
    try:
        yield rec
    finally:
        cli.run = saved


def run_cli(args: list[str], log_path: str, stop_after_snapshot=False):
    """One in-process CLI run; returns (rc, record).  With
    ``stop_after_snapshot`` the run is interrupted at the first batch
    boundary after its first checkpoint has been written."""
    from ngs_barcode_count_tpu import cli, runner

    rec: dict = {}
    patches = []
    if stop_after_snapshot:
        saver_cls = runner._AsyncCheckpointer
        acc_cls = runner.CountAccumulator
        orig_submit, orig_throttle = saver_cls.submit, acc_cls._throttle
        written = []

        def submit(self, *a, **k):
            ok = orig_submit(self, *a, **k)
            if ok:
                self.join()  # the snapshot is on disk before the stop
                written.append(True)
            return ok

        def throttle(self):
            if written:
                raise KeyboardInterrupt  # as a kill between batches
            return orig_throttle(self)

        saver_cls.submit, acc_cls._throttle = submit, throttle
        patches = [(saver_cls, "submit", orig_submit),
                   (acc_cls, "_throttle", orig_throttle)]
    try:
        with open(log_path, "w") as lf, contextlib.redirect_stdout(lf), \
                recording(rec):
            rc = cli.main(args)
    finally:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
    return rc, rec


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def stats_counters(path: str) -> list[str]:
    """The reproducible part of a _barcode_stats.txt: the -RESULTS- block
    and the output file names with their counts (times and input paths
    differ between runs)."""
    with open(path) as f:
        lines = f.read().splitlines()
    out, keep = [], False
    for ln in lines:
        if ln.startswith("-RESULTS-"):
            keep = True
        elif ln.startswith("-OUTPUT FILES-"):
            keep = False
        elif ln.startswith("File & barcodes counted:"):
            name, count = ln.split(":", 1)[1].strip().rsplit("\t", 1)
            out.append(f"{os.path.basename(name)}\t{count}")
            continue
        if keep:
            out.append(ln)
    return out


def compare_dirs(got: str, want: str) -> int:
    """Byte-compare every count CSV and the stats counters of two output
    directories; returns the number of CSVs compared."""
    names = sorted(n for n in os.listdir(got) if n.endswith(".csv"))
    want_names = sorted(n for n in os.listdir(want) if n.endswith(".csv"))
    if names != want_names:
        raise PhaseError(f"CSV sets differ: {names} vs {want_names}")
    if not names:
        raise PhaseError(f"no CSVs written in {got}")
    for n in names:
        if not filecmp.cmp(os.path.join(got, n), os.path.join(want, n),
                           shallow=False):
            raise PhaseError(f"{n} differs between {got} and {want}")
    stats = f"{PREFIX}_barcode_stats.txt"
    a = stats_counters(os.path.join(got, stats))
    b = stats_counters(os.path.join(want, stats))
    if a != b:
        raise PhaseError(f"stats counters differ:\n{a}\nvs\n{b}")
    return len(names)


def check_oracle(rec: dict, reads: list[str], quals: list[str]) -> None:
    """The run's counts and six counters equal the string oracle's."""
    from ngs_barcode_count_tpu import stats as S
    from ngs_barcode_count_tpu.oracle import oracle_counts

    exp, tallies = oracle_counts(rec["config"], reads, quals)
    result = rec["result"]
    got = {k: dict(v) for k, v in result.results.per_sample.items()}
    if got != exp:
        raise PhaseError("per-sample counts differ from the oracle")
    c = result.seq_errors.counters
    for key, idx in (("matched", S.MATCHED),
                     ("constant_region", S.CONSTANT_REGION),
                     ("sample_barcode", S.SAMPLE_BARCODE),
                     ("barcode", S.BARCODE),
                     ("low_quality", S.LOW_QUALITY),
                     ("duplicates", S.DUPLICATES)):
        if int(c[idx]) != tallies[key]:
            raise PhaseError(
                f"counter {key}: {int(c[idx])} != oracle {tallies[key]}"
            )


def cpu_reference(runs: list[dict]) -> None:
    """Run each CLI call of ``runs`` ({"args", "log"}) in this process;
    the caller has pinned JAX to the CPU."""
    for r in runs:
        rc, _ = run_cli(r["args"], r["log"])
        if rc != 0:
            raise PhaseError(f"CPU reference run failed (rc {rc}): {r['log']}")


def cpu_reference_child(runs: list[dict], workdir: str) -> None:
    """cpu_reference in a child process with JAX_PLATFORMS=cpu."""
    spec = os.path.join(workdir, "cpu_runs.json")
    with open(spec, "w") as f:
        json.dump(runs, f)
    # no persistent cache in the child: CPU executables cached on another
    # host's CPU model may not run on this one
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference", spec],
        env=env, cwd=ROOT, timeout=900,
    )
    if proc.returncode != 0:
        raise PhaseError(f"CPU reference process exited {proc.returncode}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def run_phase(phase: str, files: dict, workdir: str, batch_size: int,
              clock: CompileClock) -> dict:
    """The device runs of one phase: the oracle-sized prefix (first call:
    compiles) and the full FASTQ.  Returns the phase record; the CPU
    reference runs it lists under ``cpu_runs`` are compared later by
    check_phase."""
    f = files["random" if phase == "random" else "flagship"]
    pdir = os.path.join(workdir, phase)
    shutil.rmtree(pdir, ignore_errors=True)
    dirs = {k: os.path.join(pdir, k) for k in
            ("dev_prefix", "dev_full", "cpu_prefix", "cpu_full")}
    for d in dirs.values():
        os.makedirs(d)
    out = {"phase": phase, "dirs": dirs}

    t_c, h_c, m_c = clock.snapshot()
    rc, rec = run_cli(
        phase_args(phase, files, f["prefix"], dirs["dev_prefix"], batch_size),
        os.path.join(pdir, "dev_prefix.log"),
    )
    if rc != 0:
        raise PhaseError(f"{phase}: prefix run exited {rc}")
    out["compile_s"] = clock.seconds - t_c
    out["cache"] = (clock.hits - h_c, clock.misses - m_c)
    check_oracle(rec, f["reads"], f["quals"])

    full = phase_args(phase, files, f["fastq"], dirs["dev_full"], batch_size)
    t0 = time.perf_counter()
    if phase == "resume":
        rc, rec0 = run_cli(full, os.path.join(pdir, "dev_stopped.log"),
                           stop_after_snapshot=True)
        ckpt = os.path.join(dirs["dev_full"], f"{PREFIX}_checkpoint.npz")
        if rc != 130 or not os.path.exists(ckpt):
            raise PhaseError(
                f"resume: the first run was not stopped after a snapshot "
                f"(rc {rc})"
            )
        out["stopped_after_reads"] = _checkpointed_reads(ckpt)
        rc, rec = run_cli(full + ["--resume"],
                          os.path.join(pdir, "dev_full.log"))
    else:
        rc, rec = run_cli(full, os.path.join(pdir, "dev_full.log"))
    if rc != 0:
        raise PhaseError(f"{phase}: full run exited {rc}")
    out["wall_s"] = time.perf_counter() - t0
    res = rec["result"]
    out["reads"] = res.total_reads
    out["reads_per_s"] = res.reads_per_second
    out["engine"] = res.engine
    out["wire"] = res.wire
    if not (res.engine and res.wire):
        raise PhaseError(f"{phase}: the run did not report its engine/wire")
    ref_phase = "dense" if phase == "resume" else phase
    out["cpu_runs"] = [
        {"args": phase_args(ref_phase, files, f["prefix"], dirs["cpu_prefix"],
                            batch_size),
         "log": os.path.join(pdir, "cpu_prefix.log")},
        {"args": phase_args(ref_phase, files, f["fastq"], dirs["cpu_full"],
                            batch_size),
         "log": os.path.join(pdir, "cpu_full.log")},
    ]
    return out


def _checkpointed_reads(path: str) -> int:
    """Reads the stopped run had committed to its checkpoint."""
    with np.load(path) as z:
        return int(z["total_reads"])


def check_phase(out: dict) -> None:
    d = out["dirs"]
    out["csvs"] = compare_dirs(d["dev_full"], d["cpu_full"])
    compare_dirs(d["dev_prefix"], d["cpu_prefix"])


def device_step(files: dict, batch_size: int, steps: int = 50) -> dict:
    """The XLA dense step alone, device-resident: one flagship batch on
    the device, ``steps`` chained steps, timed to block_until_ready."""
    import jax

    from ngs_barcode_count_tpu import stats
    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )
    from ngs_barcode_count_tpu.ops import decode as dec
    from ngs_barcode_count_tpu.runner import RunConfig, setup

    f = files["flagship"]
    cfg = RunConfig(fastq=f["fastq"], format=f["scheme"],
                    sample_barcodes_option=files["samples"],
                    counted_barcodes_option=files["barcodes"],
                    batch_size=batch_size, progress=False)
    scheme, _, _, plan, _ = setup(cfg)
    gen = read_fastq_packed_parallel(
        f["fastq"], min_width=scheme.length, batch_reads=batch_size
    )
    pb = next(iter(gen))
    gen.close()
    if pb.transposed:
        pb.packed = np.ascontiguousarray(pb.packed.T)
    args = [jax.device_put(x) for x in (
        pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
        np.array([pb.n_reads], np.int32),
    )]

    def fresh():
        return (jax.numpy.zeros(plan.n_samples * plan.n_combos, np.int32),
                jax.numpy.zeros(stats.NUM_COUNTERS, np.int32))

    counts, counters = fresh()
    compiled = dec.dense_count_step_packed.lower(
        plan, counts, counters, args[0], args[1], args[2], args[3],
        pb.width, args[4],
    ).compile()
    mem = compiled.memory_analysis()

    def step(c, k):
        return dec.dense_count_step_packed(
            plan, c, k, args[0], args[1], args[2], args[3], pb.width, args[4]
        )

    counts, counters = step(*fresh())
    counters.block_until_ready()
    counts, counters = fresh()
    t0 = time.perf_counter()
    for _ in range(steps):
        counts, counters = step(counts, counters)
    counters.block_until_ready()
    dt = time.perf_counter() - t0
    return {
        "reads_per_s": steps * pb.n_reads / dt,
        "batch": pb.n_reads,
        "width": pb.width,
        "memory": {
            k: getattr(mem, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "alias_size_in_bytes",
                "generated_code_size_in_bytes",
            ) if mem is not None and hasattr(mem, k)
        },
    }


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def result_line(devices) -> str:
    """The last line: the devices as JAX reports them."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def check_devices():
    """Fail unless JAX's first device is a GPU; print what the run is
    measured on."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise PhaseError(
            f"expected a gpu device, JAX found "
            f"{devs[0].platform} ({devs[0].device_kind})"
        )
    from ngs_barcode_count_tpu.runner import _enable_compile_cache
    from ngs_barcode_count_tpu.utils import linkprobe
    from ngs_barcode_count_tpu.utils.tracing import gpu_name_and_power_limit

    _enable_compile_cache()
    log(f"devices: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    log(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    ms = devs[0].memory_stats() or {}
    log(f"device bytes_limit: {ms.get('bytes_limit')}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    rt = linkprobe.roundtrip_ms(allow_init=True)
    log(f"link probe: round trip {rt} ms, slow link: "
        f"{linkprobe.is_slow_link()}")
    return devs


def report_phase(out: dict) -> None:
    log(f"[{out['phase']}] engine: {out['engine']}")
    log(f"[{out['phase']}] wire: {out['wire']}")
    log(f"[{out['phase']}] first-call compile: {out['compile_s']:.2f} s "
        f"(persistent cache: {out['cache'][0]} hits, {out['cache'][1]} "
        "misses)")
    log(f"[{out['phase']}] end to end: {out['reads']} reads, "
        f"{out['reads_per_s']:.0f} reads/s (decode window), "
        f"{out['wall_s']:.2f} s wall with outputs")
    if "stopped_after_reads" in out:
        log(f"[resume] stopped after a snapshot at "
            f"{out['stopped_after_reads']} reads, resumed to the end")


def slow_link_branches(outs: list[dict]) -> str:
    wires = " ".join(o["wire"] for o in outs)
    engines = " ".join(o["engine"] for o in outs)
    fired = {
        "col-major wire": "col-major" in wires,
        "host quality gate": "host quality gate" in wires,
        "host-keyed dedup": any(o["phase"] == "random"
                                and "host keyed" in o["engine"]
                                for o in outs),
        "extra dispatch lanes": "dual-stream" in engines,
    }
    return ", ".join(f"{k}={'fired' if v else 'no'}" for k, v in fired.items())


def run_single() -> None:
    workdir = WORKDIR
    t0 = time.perf_counter()
    files = make_inputs(workdir, READS)
    log(f"inputs: 2 x {READS} reads generated in "
        f"{time.perf_counter() - t0:.1f} s (seed {SEED})")
    clock = CompileClock()
    outs = []
    for phase in PHASES:
        out = run_phase(phase, files, workdir, BATCH_SIZE, clock)
        report_phase(out)
        if phase == "dense":
            step = device_step(files, BATCH_SIZE)
            log(f"[dense] XLA step device-resident: "
                f"{step['reads_per_s']:.0f} reads/s "
                f"(batch {step['batch']}, width {step['width']})")
            log(f"[dense] memory_analysis: {json.dumps(step['memory'])}")
        outs.append(out)
    log(f"link probe branches: {slow_link_branches(outs)}")
    t0 = time.perf_counter()
    cpu_reference_child([r for o in outs for r in o["cpu_runs"]], workdir)
    log(f"CPU reference runs: {time.perf_counter() - t0:.1f} s")
    for out in outs:
        check_phase(out)
        log(f"[{out['phase']}] {out['csvs']} CSVs + stats counters "
            "byte-identical to the CPU run; prefix equals the oracle")


def run_four(devs) -> None:
    """The sharded engines on four devices against one-device runs of
    the same inputs."""
    if len(devs) < 4:
        raise PhaseError(f"--four needs 4 devices, found {len(devs)}")
    workdir = WORKDIR
    files = make_inputs(workdir, READS_FOUR, oracle_reads=1)
    for phase, extra in (
        ("dense", ()),
        ("dense", ("--devices", "4")),
        ("dense", ("--devices", "4", "--model-shards", "2")),
        ("random", ()),
        ("random", ("--devices", "4")),
    ):
        f = files["random" if phase == "random" else "flagship"]
        tag = phase + "".join(extra).replace("--", "_")
        out_dir = os.path.join(workdir, "four", tag)
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        rc, rec = run_cli(
            phase_args(phase, files, f["fastq"], out_dir, BATCH_SIZE, extra),
            os.path.join(workdir, "four", f"{tag}.log"),
        )
        if rc != 0:
            raise PhaseError(f"{tag}: exited {rc}")
        res = rec["result"]
        log(f"[{tag}] engine: {res.engine}; shards on devices "
            f"{list(res.state_devices)}; {res.total_reads} reads, "
            f"{res.reads_per_second:.0f} reads/s, "
            f"{time.perf_counter() - t0:.1f} s wall")
        if extra:
            if len(res.state_devices) != 4:
                raise PhaseError(
                    f"{tag}: state is not spread over 4 devices: "
                    f"{list(res.state_devices)}"
                )
            one = os.path.join(workdir, "four", phase)
            n = compare_dirs(out_dir, one)
            log(f"[{tag}] {n} CSVs + stats counters byte-identical to the "
                "one-device run")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run the sharded engines on four devices only")
    p.add_argument("--cpu-reference", metavar="SPEC",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.cpu_reference:
        with open(args.cpu_reference) as f:
            cpu_reference(json.load(f))
        return 0
    try:
        devs = check_devices()
        t0 = time.perf_counter()
        if args.four:
            run_four(devs)
        else:
            run_single()
        log(f"total: {time.perf_counter() - t0:.1f} s")
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
