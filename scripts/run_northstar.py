#!/usr/bin/env python
"""The north-star production run (VERDICT r4 next-step #1): a 400M-read
DEL run in config-5 shape — sample + counted conversion files,
--merge-output, --enrich, checkpoints every ~30s, production defaults —
killed once mid-run (SIGKILL) and resumed to completion via the real CLI.

Phases:
  C1  control (CPU, 10M reads): uninterrupted run
  C2  control (CPU, 10M reads): SIGKILL after the first checkpoint,
      --resume; output CSVs must be BYTE-IDENTICAL to C1
  M1  main (GPU, 400M reads): checkpoint every 30s, SIGKILL ~20s after
      the first snapshot lands
  M2  main (GPU): --resume to completion

Writes fullscale.json in NGS_BENCH_DIR: sustained decode reads/s across
M1+M2 (wall time
from first progress to counter print, parent-measured; includes all
checkpoint overhead), counter reconciliation, control equality, resume
evidence.  The FASTQ is pre-warmed into the page cache (a slow disk
would otherwise set the pace; recorded in the JSON).

Fixture: scripts/gen_fixture.py 400000000 (cached in NGS_BENCH_DIR).
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_READS_PER_S = 294_000.0

WORKDIR = os.environ.get("NGS_BENCH_DIR", os.path.join(ROOT, ".bench"))
N_MAIN = int(os.environ.get("NGS_NS_READS", 400_000_000))
N_CTRL = int(os.environ.get("NGS_NS_CTRL_READS", 10_000_000))

CPU_SHIM = (
    "import sys, jax;"
    "jax.config.update('jax_platforms','cpu');"
    f"sys.path.insert(0, {ROOT!r});"
    "from ngs_barcode_count_tpu.cli import main;"
    "sys.exit(main(sys.argv[1:]))"
)

_COUNTER_RE = {
    "matched": re.compile(r"Correctly matched sequences:\s+([\d,]+)"),
    "constant": re.compile(r"Constant region mismatches:\s+([\d,]+)"),
    "sample": re.compile(r"Sample barcode mismatches:\s+([\d,]+)"),
    "counted": re.compile(r"Counted barcode mismatches:\s+([\d,]+)"),
    "dup": re.compile(r"Duplicates:\s+([\d,]+)"),
    "lowq": re.compile(r"Low quality barcodes:\s+([\d,]+)"),
    "total": re.compile(r"Total sequences:\s+([\d,]+)"),
}


def log(msg):
    print(f"[northstar] {time.strftime('%H:%M:%S')} {msg}", flush=True)


def warm_cache(path):
    t0 = time.time()
    with open(path, "rb", buffering=0) as f:
        while f.read(64 << 20):
            pass
    log(f"page-cache warm of {path}: {time.time() - t0:.0f}s")


def cli_args(fastq, outdir, prefix, ckpt_s, resume, batch):
    a = [
        "-f", fastq,
        "-q", os.path.join(WORKDIR, "scheme.txt"),
        "-s", os.path.join(WORKDIR, "samples.csv"),
        "-c", os.path.join(WORKDIR, "barcodes.csv"),
        "-o", outdir, "-p", prefix, "-m", "-e",
        "--batch-size", str(batch),
    ]
    if ckpt_s:
        a += ["--checkpoint-interval", str(ckpt_s)]
    if resume:
        a += ["--resume"]
    return a


def launch(kind, args, logpath, extra_env=None):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    if extra_env:
        env.update(extra_env)
    if kind == "cpu":
        cmd = [sys.executable, "-u", "-c", CPU_SHIM] + args
    else:
        env["PYTHONPATH"] = ROOT
        cmd = [sys.executable, "-u", "-m", "ngs_barcode_count_tpu"] + args
    lf = open(logpath, "wb")
    return subprocess.Popen(
        cmd, stdout=lf, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
        start_new_session=True,
    )


def read_log(path):
    try:
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")
    except FileNotFoundError:
        return ""


def wait_marker(logpath, marker, proc=None, timeout=2400):
    """Poll the log for a marker; returns its first-seen wall time."""
    t_end = time.time() + timeout
    while time.time() < t_end:
        if marker in read_log(logpath):
            return time.time()
        if proc is not None and proc.poll() is not None:
            return None
        time.sleep(0.2)
    raise TimeoutError(f"{marker!r} not seen in {logpath}")


def parse_counters(text):
    out = {}
    for k, rx in _COUNTER_RE.items():
        hits = rx.findall(text)
        if hits:
            out[k] = int(hits[-1].replace(",", ""))
    return out


def run_killed_then_resumed(kind, fastq, outdir, prefix, ckpt_s, batch,
                            kill_after_ckpt_s, tag):
    """Phase A: run, SIGKILL kill_after_ckpt_s after the first
    checkpoint; Phase B: --resume to completion.  Returns metrics."""
    os.makedirs(outdir, exist_ok=True)
    ckpt = os.path.join(outdir, f"{prefix}_checkpoint.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    log_a = os.path.join(outdir, "phase_a.log")
    log_b = os.path.join(outdir, "phase_b.log")

    p = launch(kind, cli_args(fastq, outdir, prefix, ckpt_s, False, batch),
               log_a)
    t_prog = wait_marker(log_a, "Total sequences:", proc=p)
    assert t_prog is not None, "phase A exited before decoding"
    log(f"{tag} phase A decoding (pid {p.pid})")
    deadline = time.time() + 2400
    while not os.path.exists(ckpt):
        assert p.poll() is None, (
            f"phase A finished before any checkpoint:\n"
            + read_log(log_a)[-2000:]
        )
        assert time.time() < deadline, "no checkpoint within budget"
        time.sleep(0.5)
    t_first_ckpt = time.time()
    if os.environ.get("NGS_NS_KILL_AFTER_SNAPSHOT") == "1":
        # kill right AFTER the next snapshot lands: the resume then
        # re-decodes only a couple of seconds of work, so the sustained
        # number reflects the pipeline, not the kill placement
        m0 = os.path.getmtime(ckpt)
        deadline2 = time.time() + 120
        while time.time() < deadline2 and p.poll() is None:
            if os.path.getmtime(ckpt) != m0:
                break
            time.sleep(0.5)
        time.sleep(2.0)
    else:
        time.sleep(kill_after_ckpt_s)
    assert p.poll() is None, "phase A finished before the kill"
    os.kill(p.pid, signal.SIGKILL)
    t_kill = time.time()
    p.wait()
    win_a = t_kill - t_prog
    log(f"{tag} phase A killed {t_kill - t_first_ckpt:.0f}s after first "
        f"checkpoint ({win_a:.0f}s of decode)")

    p = launch(kind, cli_args(fastq, outdir, prefix, ckpt_s, True, batch),
               log_b)
    t_prog_b = wait_marker(log_b, "Resumed from", proc=p, timeout=2400)
    assert t_prog_b is not None, (
        "phase B exited before resuming:\n" + read_log(log_b)[-2000:]
    )
    t_done = wait_marker(log_b, "Correctly matched", proc=p, timeout=2400)
    assert t_done is not None, (
        "phase B exited before finishing:\n" + read_log(log_b)[-2000:]
    )
    rc = p.wait()
    win_b = t_done - t_prog_b
    text_b = read_log(log_b)
    c = parse_counters(text_b)
    m = re.search(r"Resumed from \S+: ([\d,]+) reads done", text_b)
    resumed_at = int(m.group(1).replace(",", "")) if m else None
    log(f"{tag} phase B resumed at {resumed_at:,} reads, finished in "
        f"{win_b:.0f}s (rc={rc})")
    return {
        "decode_s_phase_a": round(win_a, 1),
        "decode_s_phase_b": round(win_b, 1),
        "resumed_at_reads": resumed_at,
        "first_ckpt_s_into_decode": round(t_first_ckpt - t_prog, 1),
        "counters": c,
        "rc": rc,
    }


def run_plain(kind, fastq, outdir, prefix, batch, tag):
    os.makedirs(outdir, exist_ok=True)
    lp = os.path.join(outdir, "run.log")
    p = launch(kind, cli_args(fastq, outdir, prefix, 0, False, batch), lp)
    t_prog = wait_marker(lp, "Total sequences:", proc=p)
    t_done = wait_marker(lp, "Correctly matched", proc=p, timeout=2400)
    rc = p.wait()
    c = parse_counters(read_log(lp))
    log(f"{tag} finished in {t_done - t_prog:.0f}s (rc={rc})")
    return {"decode_s": round(t_done - t_prog, 1), "counters": c, "rc": rc}


def compare_csvs(dir_a, dir_b, prefix):
    files_a = sorted(
        f for f in os.listdir(dir_a)
        if f.startswith(prefix) and f.endswith(".csv")
    )
    files_b = sorted(
        f for f in os.listdir(dir_b)
        if f.startswith(prefix) and f.endswith(".csv")
    )
    if files_a != files_b:
        return False, f"file sets differ: {files_a} vs {files_b}"
    for f in files_a:
        with open(os.path.join(dir_a, f), "rb") as fa, open(
            os.path.join(dir_b, f), "rb"
        ) as fb:
            if fa.read() != fb.read():
                return False, f"{f} differs"
    return True, f"{len(files_a)} files byte-identical"


def main():
    fq_main = os.path.join(WORKDIR, f"bench_{N_MAIN}.fastq")
    fq_ctrl = os.path.join(WORKDIR, f"bench_{N_CTRL}.fastq")
    for path, n in ((fq_main, N_MAIN), (fq_ctrl, N_CTRL)):
        if not os.path.exists(path):
            log(f"generating {path}")
            subprocess.run(
                [sys.executable,
                 os.path.join(ROOT, "scripts", "gen_fixture.py"),
                 str(n), WORKDIR],
                check=True,
            )

    rec = {"metric": "fullscale_reads_per_second", "unit": "reads/s"}
    det = rec["detail"] = {"n_reads_target": N_MAIN}

    # -- controls (CPU; ~10M reads each) --
    if os.environ.get("NGS_NS_SKIP_CONTROL") != "1":
        ctrl_full = os.path.join(WORKDIR, "ns_ctrl_full")
        ctrl_res = os.path.join(WORKDIR, "ns_ctrl_resumed")
        det["control_full"] = run_plain(
            "cpu", fq_ctrl, ctrl_full, "fs", 1 << 15, "C1")
        det["control_resumed"] = run_killed_then_resumed(
            "cpu", fq_ctrl, ctrl_res, "fs", 1.0, 1 << 15, 2.0, "C2")
        eq, why = compare_csvs(ctrl_full, ctrl_res, "fs")
        det["control_csvs_equal"] = eq
        det["control_csvs_note"] = why
        log(f"control equality: {eq} ({why})")
        assert eq, why

    # -- main run (GPU) --
    warm_cache(fq_main)
    det["page_cache_prewarmed"] = True
    outdir = os.path.join(WORKDIR, "northstar")
    main_m = run_killed_then_resumed(
        "gpu", fq_main, outdir, "fs",
        float(os.environ.get("NGS_NS_CKPT_S", 30)),
        int(os.environ.get("NGS_BENCH_BATCH", 1 << 17)),
        float(os.environ.get("NGS_NS_KILL_AFTER_S", 20)),
        "M",
    )
    det["main"] = main_m
    c = main_m["counters"]
    total = c.get("total", 0)
    recon = (
        c.get("matched", 0) + c.get("constant", 0) + c.get("sample", 0)
        + c.get("counted", 0) + c.get("lowq", 0) + c.get("dup", 0)
    )
    det["counters_reconcile"] = recon == total == N_MAIN
    decode_s = main_m["decode_s_phase_a"] + main_m["decode_s_phase_b"]
    rps = total / decode_s if decode_s else 0.0
    rec["value"] = round(rps, 1)
    rec["vs_baseline"] = round(rps / BASELINE_READS_PER_S, 3)
    det["decode_s_total"] = round(decode_s, 1)
    det["output_files"] = sorted(
        f for f in os.listdir(outdir) if f.endswith((".csv", ".txt"))
    )

    print(json.dumps(rec))
    with open(os.path.join(WORKDIR, "fullscale.json"), "w") as f:
        json.dump(rec, f, indent=1)
    ok = det["counters_reconcile"] and det.get("control_csvs_equal", True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    main()
