"""Lossless 4-bit Phred wire (VERDICT r3 weak #4): the per-batch
codebook packing must reconstruct the exact int8 tensor, fall back to
raw beyond 16 distinct values, and leave every quality-gated engine's
results bit-identical."""

import os

import numpy as np
import pytest

from ngs_barcode_count_tpu.io import native
from ngs_barcode_count_tpu.io.parallel_ingest import _maybe_pack_quals
from ngs_barcode_count_tpu.io.native import PackedReads
from ngs_barcode_count_tpu.ops.decode import unpack_quals_wire
from ngs_barcode_count_tpu.runner import CountAccumulator, decode_file, setup

from tests.test_end_to_end import gen_fastq, write_inputs, _mk_config

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native codec not built"
)


def _pb_with_quals(q):
    B, W = q.shape
    return PackedReads(
        packed=np.zeros((B, W // 4), np.uint8),
        lengths=np.full(B, W, np.int16),
        exc_idx=np.full(64, -1, np.int32),
        exc_val=np.zeros(64, np.int8),
        quals=q, n_reads=B, width=W,
    )


@pytest.mark.parametrize("n_vals", [1, 4, 8, 16])
def test_qual_pack_roundtrip(rng, n_vals):
    vals = np.sort(rng.choice(64, size=n_vals, replace=False)).astype(
        np.int8
    )
    q = vals[rng.integers(0, n_vals, (256, 64))]
    pb = _pb_with_quals(q.copy())
    _maybe_pack_quals(pb)
    assert pb.quals is None and pb.quals_packed is not None
    bits = 2 if n_vals <= 4 else 4
    assert pb.qual_bits == bits
    assert pb.quals_packed.shape == (256, 64 * bits // 8)
    out = np.asarray(unpack_quals_wire(
        pb.quals_packed, pb.qual_codebook, 64, bits
    ))
    np.testing.assert_array_equal(out, q)


def test_qual_pack_raw_fallback(rng):
    q = rng.integers(0, 40, (64, 32)).astype(np.int8)  # >16 distinct
    assert len(np.unique(q)) > 16
    pb = _pb_with_quals(q)
    _maybe_pack_quals(pb)
    assert pb.quals is not None and pb.quals_packed is None


def test_qual_pack_disabled_env(rng, monkeypatch):
    monkeypatch.setenv("NGS_QUAL_WIRE", "raw")
    q = np.full((64, 32), 30, np.int8)
    pb = _pb_with_quals(q)
    _maybe_pack_quals(pb)
    assert pb.quals is not None and pb.quals_packed is None


def _counters_and_view(cfg, env, monkeypatch, n_devices=1):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    scheme, conv, me, plan, _ = setup(cfg)
    acc = CountAccumulator(plan, conv, n_devices=n_devices)
    n = decode_file(cfg, plan, scheme, acc, n_devices=n_devices)
    acc.finalize()
    return n, acc.seq_errors.counters.copy(), acc.results_view().per_sample


@pytest.mark.parametrize("scheme_kw", ["dense", "random"])
def test_qual_wire_e2e_bit_identical(tmp_path, rng, monkeypatch, scheme_kw):
    """Quality-gated runs with the packed quality wire equal raw-wire
    runs exactly — dense mode and random (bitmap) mode.  Binned Phred
    (8 values, RTA-style) so the packing engages."""
    from tests.test_end_to_end import SCHEME_RANDOM_TEXT

    if scheme_kw == "random":
        paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    else:
        paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 800, rng, quality_range=(10, 41),
    )
    # rebin to 8 RTA-style values so the 4-bit wire engages
    binned = []
    levels = np.array([2, 12, 17, 22, 27, 32, 37, 40])
    for q in quals:
        arr = np.frombuffer(q.encode(), np.uint8) - 33
        idx = np.clip((arr // 5), 0, 7)
        binned.append(
            "".join(chr(int(levels[i]) + 33) for i in idx)
        )
    from ngs_barcode_count_tpu.utils import simulate

    simulate.write_fastq(fq, reads, binned)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 25.0

    n1, c1, v1 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "raw"},
                                    monkeypatch)
    n2, c2, v2 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "pack"},
                                    monkeypatch)
    assert n1 == n2 == 800
    np.testing.assert_array_equal(c1, c2)
    assert v1 == v2
    assert c1[-1] > 0 or c1[5] > 0  # the gate actually fired somewhere


def test_qual_wire_col_major_roundtrip(tmp_path, rng, monkeypatch):
    """Col-major wire layout transposes the quality nibbles too; the
    device untranspose + unpack must reconstruct exactly (the full
    sorted+transposed+packed pipeline vs raw)."""
    monkeypatch.setenv("NGS_WIRE_LAYOUT", "col")
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 500, rng, quality_range=(30, 38),
    )
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 33.0

    n1, c1, v1 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "raw"},
                                    monkeypatch)
    n2, c2, v2 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "pack"},
                                    monkeypatch)
    np.testing.assert_array_equal(c1, c2)
    assert v1 == v2


def test_qual_wire_sharded_engine(tmp_path, rng, monkeypatch):
    """Packed quality through the 8-device sharded dense engine."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 512, rng, quality_range=(30, 38),
    )
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 33.0
    n1, c1, v1 = _counters_and_view(
        cfg, {"NGS_QUAL_WIRE": "raw"}, monkeypatch, n_devices=8
    )
    n2, c2, v2 = _counters_and_view(
        cfg, {"NGS_QUAL_WIRE": "pack"}, monkeypatch, n_devices=8
    )
    np.testing.assert_array_equal(c1, c2)
    assert v1 == v2


@pytest.mark.parametrize("n_levels", [5, 3])
def test_q4_kernel_bit_identical(tmp_path, rng, monkeypatch, n_levels):
    """The packed quality wire (4-bit at 5 levels, 2-bit at 3 levels),
    expanded on device, through dense_count_step_packed_q must equal the
    same step on the raw int8 Phred batch bit-for-bit."""
    import tempfile

    import jax.numpy as jnp

    from ngs_barcode_count_tpu import stats
    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )
    from ngs_barcode_count_tpu.ops.decode import (
        dense_count_step_packed_q,
        unpack_quals_wire,
    )
    from ngs_barcode_count_tpu.utils import simulate
    from tests.test_decode_steps import _strip_random
    from tests.test_decode_vs_oracle import build_plan
    from tests.test_end_to_end import BC1, BC2, BC3, SAMPLES

    scheme = _strip_random(None)
    plan, oracle, conv = build_plan(scheme, min_quality=30.0)
    levels = [22, 27, 32, 37, 40][:n_levels] if n_levels == 5 else [
        25, 32, 40
    ]
    reads, quals = [], []
    for _ in range(300):
        r = simulate.make_read(
            rng, scheme, list(SAMPLES)[rng.integers(0, 2)],
            [s[rng.integers(0, 3)] for s in (BC1, BC2, BC3)],
            flank_left=int(rng.integers(0, 6)),
            flank_right=int(rng.integers(0, 6)),
            n_errors=int(rng.integers(0, 5)),
        )
        reads.append(r)
        q = [levels[i] for i in rng.integers(0, len(levels), len(r))]
        quals.append("".join(chr(v + 33) for v in q))

    def batch(mode):
        monkeypatch.setenv("NGS_QUAL_WIRE", mode)
        with tempfile.TemporaryDirectory() as td:
            fq = td + "/q.fastq"
            simulate.write_fastq(fq, reads, quals)
            pb = next(iter(read_fastq_packed_parallel(
                fq, min_width=scheme.length, batch_reads=512,
                with_quals=True,
            )))
        if getattr(pb, "transposed", False):
            pb.packed = np.ascontiguousarray(pb.packed.T)
            if pb.quals_packed is not None:
                pb.quals_packed = np.ascontiguousarray(pb.quals_packed.T)
            pb.transposed = False
        return pb

    def step(pb, q):
        return dense_count_step_packed_q(
            plan, jnp.zeros(plan.n_samples * plan.n_combos, jnp.int32),
            jnp.zeros(stats.NUM_COUNTERS, jnp.int32), pb.packed,
            pb.lengths, pb.exc_idx, pb.exc_val, q, pb.width,
            np.array([pb.n_reads], np.int32),
        )

    pb = batch("pack")
    assert pb.quals_packed is not None
    bits = 2 if len(levels) <= 4 else 4
    assert pb.qual_bits == bits
    q_wire = unpack_quals_wire(
        pb.quals_packed, pb.qual_codebook, pb.width, bits
    )
    raw = batch("raw")
    assert raw.quals is not None and raw.quals_packed is None
    np.testing.assert_array_equal(np.asarray(q_wire), raw.quals)
    c_w, k_w = step(pb, q_wire)
    c_r, k_r = step(raw, raw.quals)
    np.testing.assert_array_equal(np.asarray(c_w), np.asarray(c_r))
    np.testing.assert_array_equal(np.asarray(k_w), np.asarray(k_r))
    assert int(np.asarray(k_r)[stats.LOW_QUALITY]) > 0  # the gate fired


def test_qual_wire_hashset_engine(tmp_path, rng, monkeypatch):
    """Packed quality through the device hash-set dedup mode (big combo
    space): pack vs raw bit-identical."""
    from tests.test_end_to_end import SCHEME_RANDOM_TEXT

    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")  # force hashset
    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 600, rng, quality_range=(25, 41),
    )
    # bin to 4 levels so the 4-bit wire engages
    binned = []
    levels = np.array([25, 30, 35, 40])
    for q in quals:
        arr = np.frombuffer(q.encode(), np.uint8) - 33
        idx = np.clip((arr - 25) // 5, 0, 3)
        binned.append("".join(chr(int(levels[i]) + 33) for i in idx))
    from ngs_barcode_count_tpu.utils import simulate

    simulate.write_fastq(fq, reads, binned)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 32.0

    n1, c1, v1 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "raw"},
                                    monkeypatch)
    n2, c2, v2 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "pack"},
                                    monkeypatch)
    np.testing.assert_array_equal(c1, c2)
    assert v1 == v2
    assert c1[-1] > 0  # quality gate fired


def test_host_gate_e2e_bit_identical(tmp_path, rng, monkeypatch):
    """NGS_QUAL_WIRE=host (round 5): the two-phase host-side gate — no
    quality bytes on the wire, 2B/read gate wire down, 1-bit mask up —
    must equal the raw-wire in-device gate exactly (counters AND counts),
    including repaired reads (post-repair quality offset 0 quirk)."""
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 900, rng, quality_range=(10, 41),
    )
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 25.0

    n1, c1, v1 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "raw"},
                                    monkeypatch)
    n3, c3, v3 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "host"},
                                    monkeypatch)
    assert n1 == n3 == 900
    np.testing.assert_array_equal(c1, c3)
    assert v1 == v3
    assert c1[-1] > 0 or c1[5] > 0  # the gate actually fired


def test_host_gate_fix_quirks_and_col_major(tmp_path, rng, monkeypatch):
    """Host gate under --fix-quirks (true-window quality offsets) and the
    col-major sorted wire: rows reorder on the producer thread, so the
    host-retained Phred matrix must reorder identically."""
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 700, rng, quality_range=(10, 41),
    )
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 25.0
    cfg.fix_quirks = True
    monkeypatch.setenv("NGS_WIRE_LAYOUT", "col")
    monkeypatch.setenv("NGS_WIRE_SORT", "1")

    n1, c1, v1 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "raw"},
                                    monkeypatch)
    n3, c3, v3 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "host"},
                                    monkeypatch)
    assert n1 == n3 == 700
    np.testing.assert_array_equal(c1, c3)
    assert v1 == v3


def test_host_gate_checkpoint_resume(tmp_path, rng, monkeypatch):
    """flush_pending drains the gate pipeline before snapshots: resumed
    host-gate runs equal uninterrupted ones."""
    from ngs_barcode_count_tpu import checkpoint as ckpt

    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 1200, rng, quality_range=(10, 41),
    )
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 25.0
    monkeypatch.setenv("NGS_QUAL_WIRE", "host")

    scheme, conv, me, plan, _ = setup(cfg)
    acc_full = CountAccumulator(plan, conv)
    n_full = decode_file(cfg, plan, scheme, acc_full)
    acc_full.finalize()

    # partial run -> snapshot -> resume
    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )

    acc_a = CountAccumulator(plan, conv)
    total_a = 0
    offset = None
    for i, pb in enumerate(read_fastq_packed_parallel(
        fq, min_width=scheme.length, batch_reads=cfg.batch_size,
        with_quals=True, n_threads=1,
    )):
        acc_a.step_packed(pb)
        total_a += pb.n_reads
        if i == 3:
            assert pb.next_offset > 0
            offset = pb.next_offset
            break
    acc_a.flush_pending()
    fp = ckpt.config_fingerprint(cfg)
    ckpt.save(cfg.checkpoint_path, acc_a, offset, total_a, fp)

    cfg.resume = True
    acc_b = CountAccumulator(plan, conv)
    n_b = decode_file(cfg, plan, scheme, acc_b)
    acc_b.finalize()
    assert n_b == n_full == 1200
    np.testing.assert_array_equal(
        np.asarray(acc_b.dense_state), np.asarray(acc_full.dense_state)
    )
    np.testing.assert_array_equal(
        acc_b.seq_errors.counters, acc_full.seq_errors.counters
    )


def test_host_gate_dual_stream_bit_identical(tmp_path, rng, monkeypatch):
    """Dual-stream lanes each own a host-gate pipeline; every lane's
    queue must drain into the merge (a round-5 hardware A/B caught 2/3 of
    counts silently dropped before the fix)."""
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 1100, rng, quality_range=(10, 41),
    )
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 25.0

    monkeypatch.setenv("NGS_DUAL_STREAM", "0")
    n1, c1, v1 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "raw"},
                                    monkeypatch)
    monkeypatch.setenv("NGS_DUAL_STREAM", "3")
    n3, c3, v3 = _counters_and_view(cfg, {"NGS_QUAL_WIRE": "host"},
                                    monkeypatch)
    assert n1 == n3 == 1100
    np.testing.assert_array_equal(c1, c3)
    assert v1 == v3
    assert c1[-1] > 0 or c1[5] > 0


def test_host_gate_dual_stream_checkpoint(tmp_path, rng, monkeypatch):
    """Dual-stream + host gate + checkpointing: snapshots must include
    every lane's pending gate batches (the frontier counts them)."""
    from ngs_barcode_count_tpu import checkpoint as ckpt

    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 4000, rng, quality_range=(10, 41),
    )
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 25.0
    monkeypatch.setenv("NGS_QUAL_WIRE", "host")
    monkeypatch.setenv("NGS_DUAL_STREAM", "2")

    scheme, conv, me, plan, _ = setup(cfg)
    acc_full = CountAccumulator(plan, conv)
    n_full = decode_file(cfg, plan, scheme, acc_full)
    acc_full.finalize()

    # checkpointed dual-stream run: every snapshot interval forces the
    # quiesce + gate-queue drain; resume from the LAST snapshot must
    # reproduce the full counts
    cfg2 = _mk_config(tmp_path, fq, paths)
    cfg2.batch_size = 128
    cfg2.min_average_quality_score = 25.0
    cfg2.checkpoint_interval_s = 1e-9
    acc_a = CountAccumulator(plan, conv)
    n_a = decode_file(cfg2, plan, scheme, acc_a)
    acc_a.finalize()
    np.testing.assert_array_equal(
        np.asarray(acc_a.dense_state), np.asarray(acc_full.dense_state)
    )
    assert os.path.exists(cfg2.checkpoint_path)

    import numpy as _np

    with _np.load(cfg2.checkpoint_path) as z:
        done = int(z["total_reads"])
    cfg2.resume = True
    acc_b = CountAccumulator(plan, conv)
    n_b = decode_file(cfg2, plan, scheme, acc_b)
    acc_b.finalize()
    assert n_b == n_full == 4000 and done <= n_b
    np.testing.assert_array_equal(
        np.asarray(acc_b.dense_state), np.asarray(acc_full.dense_state)
    )
    np.testing.assert_array_equal(
        acc_b.seq_errors.counters, acc_full.seq_errors.counters
    )


def test_host_gate_is_default_on_slow_link(tmp_path, rng, monkeypatch):
    """With no NGS_QUAL_WIRE set, dense single-device runs on a slow
    MEASURED link (NGS_LINK_RT_MS=40) choose the host gate; fast links
    keep the packed wire."""
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 600, rng, quality_range=(10, 41),
    )
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    cfg.min_average_quality_score = 25.0
    monkeypatch.delenv("NGS_QUAL_WIRE", raising=False)
    monkeypatch.setenv("NGS_DUAL_STREAM", "0")

    scheme, conv, me, plan, _ = setup(cfg)
    monkeypatch.setenv("NGS_LINK_RT_MS", "40")
    acc_slow = CountAccumulator(plan, conv)
    decode_file(cfg, plan, scheme, acc_slow)
    acc_slow.finalize()
    assert hasattr(acc_slow, "_pending_gate")  # the host gate engaged

    monkeypatch.setenv("NGS_LINK_RT_MS", "0.3")
    acc_fast = CountAccumulator(plan, conv)
    decode_file(cfg, plan, scheme, acc_fast)
    acc_fast.finalize()
    assert not hasattr(acc_fast, "_pending_gate")

    np.testing.assert_array_equal(
        np.asarray(acc_slow.dense_state), np.asarray(acc_fast.dense_state)
    )
    np.testing.assert_array_equal(
        acc_slow.seq_errors.counters, acc_fast.seq_errors.counters
    )
