"""Wire-format (2-bit packed + exception) path: must equal the int8 path
exactly, including N-heavy reads (exception scatter), quality-gated runs,
and partial final batches."""

import numpy as np
import pytest

from ngs_barcode_count_tpu.io import native
from ngs_barcode_count_tpu.runner import (
    CountAccumulator,
    RunConfig,
    decode_file,
    setup,
)
from ngs_barcode_count_tpu.utils import simulate

from tests.test_end_to_end import (
    SCHEME_TEXT,
    gen_fastq,
    oracle_counts,
    write_inputs,
    _mk_config,
    assert_counts_equal,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native codec not built"
)


def _run_both(tmp_path, cfg, n_expected):
    """Run once packed (default) and once forced-NumPy; compare."""
    import os

    scheme, conv, me, plan, _ = setup(cfg)
    acc_packed = CountAccumulator(plan, conv)
    n1 = decode_file(cfg, plan, scheme, acc_packed)
    acc_packed.finalize()

    os.environ["NGS_FORCE_NUMPY_INGEST"] = "1"
    try:
        acc_plain = CountAccumulator(plan, conv)
        n2 = decode_file(cfg, plan, scheme, acc_plain)
        acc_plain.finalize()
    finally:
        del os.environ["NGS_FORCE_NUMPY_INGEST"]

    assert n1 == n2 == n_expected
    np.testing.assert_array_equal(
        acc_packed.seq_errors.counters, acc_plain.seq_errors.counters
    )
    np.testing.assert_array_equal(
        np.asarray(acc_packed.dense_state), np.asarray(acc_plain.dense_state)
    )
    return acc_packed


def test_packed_equals_plain_with_ns(tmp_path, rng):
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 500, rng)
    # salt reads with Ns and odd characters (exception path)
    noisy = []
    for r in reads:
        r = list(r)
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, len(r)))] = "N"
        noisy.append("".join(r))
    fq2 = str(tmp_path / "noisy.fastq")
    simulate.write_fastq(fq2, noisy, quals)
    cfg = _mk_config(tmp_path, fq2, paths)
    # batch_size 128 -> several batches + partial final batch
    cfg.batch_size = 128
    acc = _run_both(tmp_path, cfg, len(noisy))
    exp, tallies = oracle_counts(cfg, noisy, quals)
    from ngs_barcode_count_tpu import stats as S

    assert acc.seq_errors.counters[S.MATCHED] == tallies["matched"]


def test_packed_quality_gate(tmp_path, rng):
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 300, rng, quality_range=(15, 41)
    )
    cfg = _mk_config(tmp_path, fq, paths, min_average_quality_score=30.0)
    cfg.batch_size = 256
    acc = _run_both(tmp_path, cfg, len(reads))
    exp, tallies = oracle_counts(cfg, reads, quals)
    from ngs_barcode_count_tpu import stats as S

    assert tallies["low_quality"] > 0
    assert acc.seq_errors.counters[S.LOW_QUALITY] == tallies["low_quality"]
    assert acc.seq_errors.counters[S.MATCHED] == tallies["matched"]


def test_packed_reader_roundtrip(tmp_path, rng):
    """PackedReads unpacks to the exact base codes of the plain reader."""
    from ngs_barcode_count_tpu import dna
    from ngs_barcode_count_tpu.io import fastq as F

    reads = []
    for _ in range(77):
        r = list(simulate.random_seq(rng, int(rng.integers(20, 60))))
        for _ in range(int(rng.integers(0, 6))):
            r[int(rng.integers(0, len(r)))] = "NX?"[int(rng.integers(0, 3))]
        reads.append("".join(r))
    p = tmp_path / "x.fastq"
    simulate.write_fastq(str(p), reads)

    import jax

    from ngs_barcode_count_tpu.ops.decode import unpack_bases

    got = []
    for pb in native.read_fastq_native_packed(str(p), batch_reads=32):
        bases = np.asarray(
            jax.jit(unpack_bases, static_argnums=3)(
                pb.packed, pb.exc_idx, pb.exc_val, pb.width
            )
        )
        for i in range(pb.n_reads):
            got.append(dna.decode(bases[i, : pb.lengths[i]]))
    want = [
        "".join(
            c if c in "ACGTN" else "?" for c in r
        )
        for r in reads
    ]
    assert got == want


def _noisy(reads, rng, p=5):
    out = []
    for r in reads:
        r = list(r)
        for _ in range(int(rng.integers(0, p))):
            r[int(rng.integers(0, len(r)))] = "N"
        out.append("".join(r))
    return out


@pytest.mark.parametrize("min_quality", [0.0, 30.0])
def test_packed_sharded_engine_equals_single(tmp_path, rng, min_quality):
    """The wire format routed through the sharded mesh engine (packed rows
    + per-shard exception buckets over the data axis) must reproduce the
    single-device packed path exactly, with and without the quality
    gate."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, conv, me, plan, _ = setup(cfg0)
    fq, reads, quals0 = gen_fastq(
        tmp_path, scheme, 700, rng, quality_range=(20, 41)
    )
    noisy = _noisy(reads, rng)
    fq2 = str(tmp_path / "noisy.fastq")
    simulate.write_fastq(fq2, noisy, quals0)
    cfg = _mk_config(
        tmp_path, fq2, paths, min_average_quality_score=min_quality,
    )
    cfg.batch_size = 128
    scheme, conv, me, plan, _ = setup(cfg)

    acc1 = CountAccumulator(plan, conv)
    n1 = decode_file(cfg, plan, scheme, acc1)
    acc1.finalize()

    acc4 = CountAccumulator(plan, conv, n_devices=4)
    assert acc4.engine is not None
    n4 = decode_file(cfg, plan, scheme, acc4, n_devices=4)
    acc4.finalize()

    assert n1 == n4 == len(noisy)
    np.testing.assert_array_equal(
        acc1.seq_errors.counters, acc4.seq_errors.counters
    )
    np.testing.assert_array_equal(
        np.asarray(acc1.dense_state), np.asarray(acc4.dense_state)
    )


def test_col_major_wire_equals_row(tmp_path, rng, monkeypatch):
    """NGS_WIRE_LAYOUT=col ships the packed matrix transposed (slow-link
    compression likes aligned columns); counts must be identical."""
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, conv, me, plan, _ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 600, rng)
    noisy = _noisy(reads, rng)
    fq2 = str(tmp_path / "noisy.fastq")
    simulate.write_fastq(fq2, noisy, quals)
    cfg = _mk_config(tmp_path, fq2, paths)
    cfg.batch_size = 128
    scheme, conv, me, plan, _ = setup(cfg)

    acc_row = CountAccumulator(plan, conv)
    n1 = decode_file(cfg, plan, scheme, acc_row)
    acc_row.finalize()

    monkeypatch.setenv("NGS_WIRE_LAYOUT", "col")
    acc_col = CountAccumulator(plan, conv)
    n2 = decode_file(cfg, plan, scheme, acc_col)
    acc_col.finalize()

    assert n1 == n2 == len(noisy)
    np.testing.assert_array_equal(
        acc_row.seq_errors.counters, acc_col.seq_errors.counters
    )
    np.testing.assert_array_equal(
        np.asarray(acc_row.dense_state), np.asarray(acc_col.dense_state)
    )


@pytest.mark.parametrize("min_q", [0.0, 30.0])
def test_sorted_col_wire_equals_unsorted(tmp_path, rng, monkeypatch, min_q):
    """The producer-side batch sort (reads clustered by leading packed
    bytes before the col-major transpose, -30% link bytes) must be
    invisible to every consumer: lengths, Phred lanes, and the sparse N
    exceptions all permute consistently.  Random-barcode keyed mode +
    quality gate + N-salted reads is the worst case."""
    from tests.test_end_to_end import SCHEME_RANDOM_TEXT

    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, conv, me, plan, _ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 700, rng, quality_range=(20, 41)
    )
    noisy = _noisy(reads, rng)
    fq2 = str(tmp_path / "noisy.fastq")
    simulate.write_fastq(fq2, noisy, quals)
    cfg = _mk_config(tmp_path, fq2, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = min_q
    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")
    monkeypatch.setenv("NGS_DEVICE_DEDUP", "0")
    scheme, conv, me, plan, _ = setup(cfg)

    monkeypatch.setenv("NGS_WIRE_LAYOUT", "col")
    monkeypatch.setenv("NGS_WIRE_SORT", "0")
    acc_u = CountAccumulator(plan, conv, allow_bitmap=False)
    n1 = decode_file(cfg, plan, scheme, acc_u)
    acc_u.finalize()

    monkeypatch.setenv("NGS_WIRE_SORT", "1")
    acc_s = CountAccumulator(plan, conv, allow_bitmap=False)
    n2 = decode_file(cfg, plan, scheme, acc_s)
    acc_s.finalize()

    assert n1 == n2 == len(noisy)
    np.testing.assert_array_equal(
        acc_u.seq_errors.counters, acc_s.seq_errors.counters
    )
    assert acc_u.results_view().per_sample == acc_s.results_view().per_sample


def test_dual_stream_equals_single(tmp_path, rng):
    """NGS_DUAL_STREAM=1 (two dispatch threads, two count lanes merged at
    the end) must be bit-identical to the single-stream loop."""
    import os

    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 3000, rng)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 256  # many small batches so both threads get work
    scheme, conv, me, plan, _ = setup(cfg)

    acc_single = CountAccumulator(plan, conv)
    n1 = decode_file(cfg, plan, scheme, acc_single)

    os.environ["NGS_DUAL_STREAM"] = "1"
    try:
        acc_dual = CountAccumulator(plan, conv)
        n2 = decode_file(cfg, plan, scheme, acc_dual)
    finally:
        del os.environ["NGS_DUAL_STREAM"]

    assert n1 == n2 == 3000
    assert getattr(acc_dual, "_dual_streamed", False)
    assert not getattr(acc_single, "_dual_streamed", False)
    np.testing.assert_array_equal(
        np.asarray(acc_single.dense_counters),
        np.asarray(acc_dual.dense_counters),
    )
    np.testing.assert_array_equal(
        np.asarray(acc_single.dense_state), np.asarray(acc_dual.dense_state)
    )
    acc_single.finalize()
    acc_dual.finalize()
    assert acc_single.results_view().per_sample == \
        acc_dual.results_view().per_sample


def test_dual_stream_lane_failure_stops_other_lane(
    tmp_path, rng, monkeypatch
):
    """A failing lane must stop the run promptly: the surviving lane
    checks the failure flag and the shared ingest generator is closed,
    instead of decoding the rest of the file before the error surfaces."""
    import os

    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 3000, rng)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 256
    scheme, conv, me, plan, _ = setup(cfg)

    calls = {"n": 0}
    orig = CountAccumulator.step_packed

    def failing(self, pb):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected lane failure")
        return orig(self, pb)

    monkeypatch.setattr(CountAccumulator, "step_packed", failing)
    monkeypatch.setenv("NGS_DUAL_STREAM", "1")
    acc = CountAccumulator(plan, conv)
    with pytest.raises(RuntimeError, match="injected lane failure"):
        decode_file(cfg, plan, scheme, acc)
    # 3000 reads / 256 = 12 batches; the prompt stop means the surviving
    # lane processed at most a few more batches, not the whole file
    assert calls["n"] < 6, f"lane kept running: {calls['n']} step calls"
