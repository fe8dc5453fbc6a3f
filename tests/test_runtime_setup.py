"""Run-time setup that depends on the machine: where the compile cache
goes, how big the device dedup table gets, the benchmark's refusal to
measure without a GPU, and the single- and multi-device entry points."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax

from ngs_barcode_count_tpu import runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    return calls


def test_compile_cache_default_is_fixed_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _config_updates(monkeypatch)
    runner._enable_compile_cache()
    assert calls["jax_compilation_cache_dir"] == os.path.join(
        ROOT, ".jax_cache"
    )
    assert runner.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _config_updates(monkeypatch)
    runner._enable_compile_cache()
    assert "jax_compilation_cache_dir" not in calls


def _fake_device(bytes_limit, in_use):
    return types.SimpleNamespace(
        platform="gpu",
        memory_stats=lambda: {
            "bytes_limit": bytes_limit, "bytes_in_use": in_use,
        },
    )


@pytest.mark.parametrize(
    "bytes_limit,in_use,want",
    [
        # an 80 GB card with JAX's default 75% reservation: the clamp
        (63_763_120_128, 1 << 30, 1 << 30),
        # a small card: the 2^26 floor
        (1 << 30, 0, 1 << 26),
    ],
)
def test_dedup_table_slots_from_free_memory(monkeypatch, bytes_limit, in_use,
                                            want):
    monkeypatch.delenv("NGS_DEDUP_TABLE_SLOTS", raising=False)
    monkeypatch.setattr(
        jax, "devices", lambda *a: [_fake_device(bytes_limit, in_use)]
    )
    assert runner._dedup_table_slots() == want


def test_sharded_table_total_fits_int32_slot_ids(tmp_path, monkeypatch):
    """Four devices of 2^30 slots each would need 2^32 global slot ids;
    the total is capped at MAX_SHARDED_SLOTS and split evenly."""
    from ngs_barcode_count_tpu.parallel.sharded_dedup import (
        ShardedHashsetEngine,
    )
    from tests.test_end_to_end import (
        SCHEME_RANDOM_TEXT, _mk_config, write_inputs,
    )

    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg = _mk_config(tmp_path, "x.fastq", paths)
    scheme, conv, me, plan, _ = runner.setup(cfg)
    monkeypatch.delenv("NGS_DEDUP_TABLE_SLOTS", raising=False)
    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")
    monkeypatch.setattr(runner, "_dedup_table_slots", lambda: 1 << 30)
    seen = {}

    class Stop(Exception):
        pass

    def build(plan_, mesh, n_slots):
        seen["n"] = n_slots
        seen["engine"] = ShardedHashsetEngine(
            plan=plan_, mesh=mesh, n_data=4,
            s_local=max(n_slots // 4, 8),
        )
        raise Stop  # no 8 GB table on the test host

    monkeypatch.setattr(ShardedHashsetEngine, "build", staticmethod(build))
    with pytest.raises(Stop):
        runner.CountAccumulator(plan, conv, n_devices=4)
    assert seen["n"] == runner.MAX_SHARDED_SLOTS == 1 << 31
    assert 4 * seen["engine"].s_local <= 1 << 31


def test_bench_exits_nonzero_without_gpu():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["JAX_PLATFORMS"] = ""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert proc.stdout.strip() == ""


def test_bench_runs_on_cpu_only_when_pinned(monkeypatch):
    import bench

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert bench.require_gpu()[0].platform == "cpu"
    monkeypatch.setenv("JAX_PLATFORMS", "")
    with pytest.raises(SystemExit):
        bench.require_gpu()


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge

    from ngs_barcode_count_tpu import stats

    fn, args = ge.entry()
    counts, counters = jax.jit(fn)(*args)
    counters = np.asarray(counters)
    # every read lands in exactly one outcome counter
    assert counters.sum() == args[2].shape[0]
    assert int(np.asarray(counts).sum()) == counters[stats.MATCHED]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    import __graft_entry__ as ge

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    ge.dryrun_multichip(n)
