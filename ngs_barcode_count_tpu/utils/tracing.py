"""Tracing / profiling (SURVEY.md section 5: the reference has only
coarse chrono wall-clock prints, main.rs:126-134; this build adds real
profiler hooks).

- ``profile_to(dir)``: context manager around ``jax.profiler`` producing
  a Perfetto/TensorBoard-compatible trace of the decode steps.
- ``Throughput``: rolling reads/s meter used by the runner's progress
  line and logged per batch when NGS_TRACE=1.
- ``gpu_name_and_power_limit()``: the card's name and power limit, which
  every device measurement is reported beside.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time


@contextlib.contextmanager
def profile_to(trace_dir: str | None):
    """jax.profiler trace around the decode loop (no-op when dir unset)."""
    if not trace_dir:
        yield
        return
    import jax

    os.makedirs(trace_dir, exist_ok=True)
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Throughput:
    """Rolling reads/s with optional per-batch structured logging."""

    def __init__(self, log: bool | None = None, out=None):
        self.t0 = time.perf_counter()
        self.last_t = self.t0
        self.total = 0
        self.batches = 0
        self.log = (
            log if log is not None else os.environ.get("NGS_TRACE") == "1"
        )
        # Resolved at print time: jax.profiler.start_trace re-redirects
        # fd 2, so a stream captured here could outlive its redirect.
        self.out = out

    def update(self, n_reads: int) -> None:
        self.total += n_reads
        self.batches += 1
        now = time.perf_counter()
        if self.log:
            rec = {
                "event": "batch",
                "batch": self.batches,
                "reads": n_reads,
                "total_reads": self.total,
                "batch_s": round(now - self.last_t, 4),
                "reads_per_s": round(
                    self.total / max(now - self.t0, 1e-9), 1
                ),
            }
            print(json.dumps(rec), file=self.out or sys.stderr, flush=True)
        self.last_t = now

    @property
    def reads_per_second(self) -> float:
        return self.total / max(time.perf_counter() - self.t0, 1e-9)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each, or a note saying why it could not be read.  A card set
    below its maximum power runs slower under load, so timings are
    reported beside this."""
    cmd = [
        "nvidia-smi", "--query-gpu=name,power.limit",
        "--format=csv,noheader",
    ]
    try:
        out = subprocess.run(
            cmd, capture_output=True, text=True, timeout=30, check=True
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()
