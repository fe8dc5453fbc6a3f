"""Dedup-table saturation (VERDICT r2 weak #5).

Saturation: with a tiny fingerprint table, one batch overflows more rows
than its compacted buffer holds.  Round 2 aborted the run there; now the
batch replays through a lossless-capacity step (state-idempotent — see
runner._replay_saturated) and the run continues with lossless buffers.
Counts must stay EXACTLY equal to the host keyed+dedup path (reference
semantics info.rs:770-801)."""

import numpy as np
import pytest

from ngs_barcode_count_tpu.runner import (
    CountAccumulator,
    decode_file,
    setup,
)
from ngs_barcode_count_tpu.utils import simulate
from tests.test_end_to_end import (
    BC1,
    BC2,
    BC3,
    SAMPLES,
    SCHEME_RANDOM_TEXT,
    _mk_config,
    write_inputs,
)


def _gen_many_distinct(tmp_path, rng, n_reads, n_randoms):
    """Reads whose random barcodes draw from a pool big enough to
    saturate a tiny table fast, with enough reuse for real duplicates."""
    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    pool = set()
    while len(pool) < n_randoms:
        pool.add("".join("ACGT"[i] for i in rng.integers(0, 4, 8)))
    pool = sorted(pool)
    reads, quals = [], []
    for _ in range(n_reads):
        r = simulate.make_read(
            rng, scheme,
            list(SAMPLES)[rng.integers(0, 2)],
            [s[rng.integers(0, 3)] for s in (BC1, BC2, BC3)],
            random_barcode=pool[rng.integers(0, len(pool))],
        )
        reads.append(r)
        q = rng.integers(20, 41, len(r)) + 33
        quals.append("".join(chr(int(x)) for x in q))
    fq = tmp_path / "sat.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    return paths, str(fq)


def _host_keyed_reference(cfg, plan, scheme, conv):
    acc = CountAccumulator(plan, conv, allow_bitmap=False)
    assert acc.keyed is not None and acc.dedup is not None
    n = decode_file(cfg, plan, scheme, acc)
    acc.finalize()
    return acc, n


@pytest.mark.parametrize("min_q", [0.0, 25.0])
def test_saturation_recovers_single_device(tmp_path, rng, monkeypatch,
                                           min_q):
    """One 2048-read batch against a 64-slot table: ~1900 overflow rows
    vs a 1024-row buffer.  Round 2 raised RuntimeError here.  min_q>0
    exercises the quality-gated replay step (pb.quals ride along)."""
    paths, fq = _gen_many_distinct(tmp_path, rng, 3000, 2500)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 2048
    cfg.min_average_quality_score = min_q
    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")
    monkeypatch.setenv("NGS_DEDUP_TABLE_SLOTS", "64")
    scheme, conv, me, plan, _ = setup(cfg)

    acc = CountAccumulator(plan, conv)
    assert acc.hashset is not None
    n = decode_file(cfg, plan, scheme, acc)
    acc.finalize()
    assert n == 3000
    assert acc._cap_boost, "saturation should have fired the boost"

    acc_host, n_host = _host_keyed_reference(cfg, plan, scheme, conv)
    assert n_host == 3000
    np.testing.assert_array_equal(
        acc.seq_errors.counters, acc_host.seq_errors.counters
    )
    assert acc.results_view().per_sample == acc_host.results_view().per_sample


def test_saturation_recovers_sharded(tmp_path, rng, monkeypatch):
    """Same recovery through the sharded engine: per-device buffers
    (cap R//8=64) overflow on a 4-device mesh with a 64-slot table."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    paths, fq = _gen_many_distinct(tmp_path, rng, 3000, 2500)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 2048
    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")
    monkeypatch.setenv("NGS_DEDUP_TABLE_SLOTS", "64")
    scheme, conv, me, plan, _ = setup(cfg)

    acc = CountAccumulator(plan, conv, n_devices=4)
    assert acc.hashset_engine is not None
    n = decode_file(cfg, plan, scheme, acc, n_devices=4)
    acc.finalize()
    assert n == 3000
    assert acc._cap_boost

    acc_host, n_host = _host_keyed_reference(cfg, plan, scheme, conv)
    assert n_host == 3000
    np.testing.assert_array_equal(
        acc.seq_errors.counters, acc_host.seq_errors.counters
    )
    assert acc.results_view().per_sample == acc_host.results_view().per_sample


def test_overflow_pin_budget_harvests_early(monkeypatch):
    """The replay lookahead must not pin unbounded host memory: once the
    retained batches exceed NGS_OVERFLOW_PIN_MB, the queue harvests
    oldest-first down to the budget (keeping a >=2 floor)."""
    import types

    acc = CountAccumulator.__new__(CountAccumulator)  # isolated queue
    harvested = []
    acc._harvest_overflow = lambda over, n_over, pb=None: harvested.append(
        pb.tag
    )

    def fake_pb(tag, mb):
        pb = types.SimpleNamespace(tag=tag)
        pb.packed = np.zeros(mb << 20, np.uint8)
        pb.quals = None
        return pb

    monkeypatch.setenv("NGS_OVERFLOW_PIN_MB", "8")
    over = np.zeros((1 << 15, 2), np.uint32)  # depth cap stays large
    n_over = np.zeros(1, np.int32)
    for i in range(5):
        acc._push_overflow(over, n_over, fake_pb(i, 3))  # 3MB each
    # budget 8MB / 3MB each: every push past the 2nd trips the 9MB>8MB
    # check and harvests the oldest entry down to the 2-entry floor
    assert harvested == [0, 1, 2]
    assert len(acc._pending_over) == 2
    assert acc._pending_pin_bytes == 2 * (3 << 20)


@pytest.mark.parametrize("slots", ["64", "65536"])
@pytest.mark.parametrize("variant", [
    ("1", "0"), ("0", "1"), ("1", "1"), ("1", "2"),
])
def test_sorted_probe_tail_exact(tmp_path, rng, monkeypatch, slots,
                                 variant):
    """The round-4 dedup-tail perf variants (NGS_DEDUP_SORTED
    slot-ascending order, NGS_DEDUP_WINDOWED one-gather probe window,
    and their combination) must classify identically to the host
    keyed+dedup path — with a saturating 64-slot table (overflow/replay
    path) and with a comfortable table (pure probe path).  Table BIT
    layout may differ from the row-order formulation; counts/counters
    must not."""
    paths, fq = _gen_many_distinct(tmp_path, rng, 3000, 2500)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 2048
    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")
    monkeypatch.setenv("NGS_DEDUP_TABLE_SLOTS", slots)
    monkeypatch.setenv("NGS_DEDUP_SORTED", variant[0])
    monkeypatch.setenv("NGS_DEDUP_WINDOWED", variant[1])
    scheme, conv, me, plan, _ = setup(cfg)

    acc = CountAccumulator(plan, conv)
    assert acc.hashset is not None
    n = decode_file(cfg, plan, scheme, acc)
    acc.finalize()
    assert n == 3000

    acc_host, n_host = _host_keyed_reference(cfg, plan, scheme, conv)
    np.testing.assert_array_equal(
        acc.seq_errors.counters, acc_host.seq_errors.counters
    )
    assert acc.results_view().per_sample == acc_host.results_view().per_sample


@pytest.mark.parametrize("variant", [("0", "0"), ("1", "0"), ("1", "2")])
def test_sharded_n1_equals_single_device(tmp_path, rng, monkeypatch,
                                         variant):
    """An n_data=1 ShardedHashsetEngine must match the single-device
    hashset step EXACTLY (counts, counters, overflow rows) under every
    dedup variant — the round-4 sorted default regressed this on the
    chip when the engine's tail still ran row-order (round 4);
    both now share ops.decode.probe_insert."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ngs_barcode_count_tpu import stats
    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )
    from ngs_barcode_count_tpu.ops import decode as dec
    from ngs_barcode_count_tpu.parallel.sharded_dedup import (
        ShardedHashsetEngine,
    )

    monkeypatch.setenv("NGS_DEDUP_SORTED", variant[0])
    monkeypatch.setenv("NGS_DEDUP_WINDOWED", variant[1])
    paths, fq = _gen_many_distinct(tmp_path, rng, 2000, 1500)
    cfg = _mk_config(tmp_path, fq, paths)
    scheme, conv, me, plan, _ = setup(cfg)
    n_slots = 512  # tiny: probe chains + overflow both fire

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    hse = ShardedHashsetEngine.build(plan, mesh, n_slots)
    table_s, counts_s, ctr_s = hse.initial_state()
    table_1 = jnp.zeros(n_slots, jnp.uint32)
    counts_1 = jnp.zeros(plan.n_samples * plan.n_combos, jnp.int32)
    ctr_1 = jnp.zeros(stats.NUM_COUNTERS, jnp.int32)
    hstep = None
    over_s_all, over_1_all = [], []
    vstr = dec._dedup_variant()
    for pb in read_fastq_packed_parallel(
        fq, min_width=scheme.length, batch_reads=512,
    ):
        if getattr(pb, "transposed", False):
            pb.packed = np.ascontiguousarray(pb.packed.T)
            pb.transposed = False
        n = np.array([pb.n_reads], np.int32)
        B = pb.packed.shape[0]
        if hstep is None:
            hstep = hse.make_packed_step(
                pb.width, False, B, cap_over=hse.lossless_cap(B)
            )
        exc_i, exc_v = hse.split_exceptions(
            np.asarray(pb.exc_idx), np.asarray(pb.exc_val), B, pb.width
        )
        table_s, counts_s, ctr_s, ov_s, no_s = hstep(
            table_s, counts_s, ctr_s, pb.packed,
            np.asarray(pb.lengths), exc_i, exc_v, n, None,
        )
        cap = B  # lossless on both sides: overflow sets compare whole
        table_1, counts_1, ctr_1, ov_1, no_1 = (
            dec.random_hashset_step_packed(
                plan, table_1, counts_1, ctr_1, pb.packed, pb.lengths,
                pb.exc_idx, pb.exc_val, pb.width, cap, n, vstr,
            )
        )
        k_s = int(np.asarray(no_s).reshape(-1)[0])
        k_1 = int(np.asarray(no_1).reshape(-1)[0])
        assert k_s <= np.asarray(ov_s).reshape(-1, 2).shape[0]
        assert k_1 <= cap
        over_s_all.append(np.asarray(ov_s).reshape(-1, 2)[:k_s])
        over_1_all.append(np.asarray(ov_1)[:k_1])
    mc_s, mctr_s = hse.merge(counts_s, ctr_s)
    np.testing.assert_array_equal(np.asarray(mc_s), np.asarray(counts_1))
    np.testing.assert_array_equal(np.asarray(mctr_s), np.asarray(ctr_1))
    ov_s = np.concatenate(over_s_all)
    ov_1 = np.concatenate(over_1_all)
    assert len(ov_s) > 0  # the tiny table must actually overflow
    ov_s = ov_s[np.lexsort(ov_s.T)]
    ov_1 = ov_1[np.lexsort(ov_1.T)]
    np.testing.assert_array_equal(ov_s, ov_1)


@pytest.mark.parametrize("probes", ["1", "2", "8"])
@pytest.mark.parametrize("slots", ["64", "8192"])
def test_probe_count_variants_exact(tmp_path, rng, monkeypatch, probes,
                                    slots):
    """NGS_DEDUP_PROBES (round 5): any probe-window length classifies
    identically — rows that exhaust a shorter window route to the EXACT
    host overflow path, so only device/host traffic shifts."""
    paths, fq = _gen_many_distinct(tmp_path, rng, 3000, 2500)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 2048
    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")
    monkeypatch.setenv("NGS_DEDUP_TABLE_SLOTS", slots)
    monkeypatch.setenv("NGS_DEDUP_PROBES", probes)
    scheme, conv, me, plan, _ = setup(cfg)

    acc = CountAccumulator(plan, conv)
    assert acc.hashset is not None
    n = decode_file(cfg, plan, scheme, acc)
    acc.finalize()
    assert n == 3000

    acc_host, n_host = _host_keyed_reference(cfg, plan, scheme, conv)
    np.testing.assert_array_equal(
        acc.seq_errors.counters, acc_host.seq_errors.counters
    )
    assert acc.results_view().per_sample == acc_host.results_view().per_sample
