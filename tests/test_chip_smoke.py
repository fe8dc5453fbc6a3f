"""chip_smoke.py off the card: its phases run end to end on the CPU at a
tiny size (device runs, CPU reference runs, oracle and byte comparisons),
and the script itself refuses to report success without a GPU."""

import json
import os
import shutil
import subprocess
import sys
import importlib.util
import types

import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke_inputs(tmp_path_factory):
    from ngs_barcode_count_tpu.io import native

    if not native.available():
        pytest.skip("native codec not built")
    workdir = str(tmp_path_factory.mktemp("smoke"))
    files = cs.make_inputs(workdir, 1500, oracle_reads=300)
    return workdir, files, cs.CompileClock()


@pytest.mark.parametrize("phase", cs.PHASES)
def test_phase_matches_cpu_reference_and_oracle(smoke_inputs, phase):
    workdir, files, clock = smoke_inputs
    out = cs.run_phase(phase, files, workdir, 256, clock)
    assert out["reads"] == 1500
    assert out["engine"] and out["wire"].startswith("step_packed")
    if phase == "resume":
        assert 0 < out["stopped_after_reads"] < out["reads"]
    if phase == "random":
        assert out["engine"].startswith("device hash-set dedup")
    if phase == "keyed":
        assert out["engine"] == "host keyed"
    cs.cpu_reference(out["cpu_runs"])
    cs.check_phase(out)
    assert out["csvs"] >= 4


def test_time_decode_forms_variants_agree(smoke_inputs):
    """scripts/time_decode_forms.py times every scan-lane pad and one-hot
    form of the dense step, and every variant counts the same."""
    spec = importlib.util.spec_from_file_location(
        "time_decode_forms",
        os.path.join(ROOT, "scripts", "time_decode_forms.py"),
    )
    tdf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tdf)
    from ngs_barcode_count_tpu.ops import decode as dec

    saved = dec.SCAN_LANE, dec._onehot_cmajor
    times, rows = tdf.time_forms(smoke_inputs[1], 256, steps=1, rounds=1)
    assert (dec.SCAN_LANE, dec._onehot_cmajor) == saved
    assert rows == 256
    assert set(times) == {(f, lane) for f in tdf.FORMS for lane in tdf.LANES}


def test_result_line_has_contract_keys():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    line = json.loads(cs.result_line([dev, dev, dev, dev]))
    assert line == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100", "count": 4},
    }


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "expected a gpu device" in proc.stderr


def test_exits_nonzero_alone(tmp_path):
    """Copied into a directory without the rest of the repository, the
    script fails instead of reporting a result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
