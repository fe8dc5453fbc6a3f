"""The XLA decode steps on the wire format: the packed-input steps the
runner dispatches (2-bit bases + exception list from the native codec)
must equal the unpacked decode on the same reads, and the oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ngs_barcode_count_tpu import stats
from ngs_barcode_count_tpu.io import native
from ngs_barcode_count_tpu.io.parallel_ingest import read_fastq_packed_parallel
from ngs_barcode_count_tpu.ops import decode as dec
from ngs_barcode_count_tpu.utils import simulate

from tests.test_decode_vs_oracle import (
    build_plan,
    encode_batch,
    gen_reads,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native codec not built"
)


def _strip_random(example_scheme):
    from ngs_barcode_count_tpu.scheme import parse_scheme_text
    from tests.conftest import EXAMPLE_SCHEME

    return parse_scheme_text(EXAMPLE_SCHEME.replace("(8)\n", ""))


@pytest.fixture(scope="module")
def dense_setup(request):
    scheme = _strip_random(None)
    plan, oracle, conv = build_plan(scheme)
    assert plan.dense_counts
    return scheme, plan, oracle, conv


def _packed(tmp_path, scheme, reads, quals, batch=512, with_quals=False):
    """The native codec's wire batch for ``reads`` (row-major)."""
    fq = tmp_path / "w.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    pb = next(iter(read_fastq_packed_parallel(
        str(fq), min_width=scheme.length, batch_reads=batch,
        with_quals=with_quals,
    )))
    if getattr(pb, "transposed", False):
        pb.packed = np.ascontiguousarray(pb.packed.T)
        pb.transposed = False
    return pb, np.array([pb.n_reads], np.int32)


def _noisy(rng, reads):
    out = []
    for r in reads:
        r = list(r)
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, len(r)))] = "N"
        out.append("".join(r))
    return out


def _zeros(plan):
    return (
        jnp.zeros(plan.n_samples * plan.n_combos, jnp.int32),
        jnp.zeros(stats.NUM_COUNTERS, jnp.int32),
    )


def test_packed_step_matches_decode_batch_random_reads(
    dense_setup, rng, tmp_path
):
    """Packed XLA step (native wire, on-device unpack) == the unpacked
    dense step on the Python-encoded batch: counts and counters."""
    scheme, plan, oracle, conv = dense_setup
    reads = _noisy(rng, gen_reads(rng, scheme, 96, err_range=(0, 12)))
    quals = ["I" * len(r) for r in reads]
    pb, n = _packed(tmp_path, scheme, reads, quals)
    assert (np.asarray(pb.exc_idx) >= 0).sum() > 0  # N exceptions shipped
    c_p, k_p = dec.dense_count_step_packed(
        plan, *_zeros(plan), pb.packed, pb.lengths, pb.exc_idx,
        pb.exc_val, pb.width, n,
    )
    bases, quality, lengths, mask = encode_batch(reads, quals)
    c_u, k_u = dec.dense_count_step(
        plan, *_zeros(plan), bases, quality, lengths, mask
    )
    np.testing.assert_array_equal(np.asarray(c_p), np.asarray(c_u))
    np.testing.assert_array_equal(np.asarray(k_p), np.asarray(k_u))
    assert int(np.asarray(k_p)[stats.MATCHED]) > 0


def test_xla_matches_oracle(dense_setup, rng):
    scheme, plan, oracle, conv = dense_setup
    reads = _noisy(rng, gen_reads(rng, scheme, 64, err_range=(0, 10)))
    quals = ["I" * len(r) for r in reads]
    bases, quality, lengths, mask = encode_batch(reads, quals)
    out = dec.keyed_decode_step(plan, bases, quality, lengths, mask)
    valid = np.asarray(out["valid"])
    for i, (r, q) in enumerate(zip(reads, quals)):
        o = oracle.decode(r, q)
        assert bool(valid[i]) == (o.outcome == "matched"), (i, r, o.outcome)


def test_packed_count_step(dense_setup, rng, tmp_path):
    """Per-combo counts of the packed step equal a host tally of the
    unpacked decode's (valid, flat) outputs."""
    scheme, plan, oracle, conv = dense_setup
    reads = gen_reads(rng, scheme, 64, err_range=(0, 8))
    quals = ["I" * len(r) for r in reads]
    pb, n = _packed(tmp_path, scheme, reads, quals)
    counts, counters = dec.dense_count_step_packed(
        plan, *_zeros(plan), pb.packed, pb.lengths, pb.exc_idx,
        pb.exc_val, pb.width, n,
    )
    bases, quality, lengths, mask = encode_batch(reads, quals)
    out = dec.keyed_decode_step(plan, bases, quality, lengths, mask)
    valid = np.asarray(out["valid"])
    flat = np.asarray(out["sample_idx"]) * plan.n_combos + np.asarray(
        out["combo_flat"]
    )
    want = np.bincount(flat[valid], minlength=plan.n_samples * plan.n_combos)
    np.testing.assert_array_equal(np.asarray(counts), want)
    np.testing.assert_array_equal(
        np.asarray(counters), np.asarray(out["counters"])
    )


def test_quality_gate(rng, tmp_path):
    """The packed quality step's segment-mean gate == the unpacked
    step's and the oracle's, strict quirk semantics included."""
    scheme = _strip_random(None)
    plan_q, oracle_q, conv_q = build_plan(scheme, min_quality=30.0)
    reads = gen_reads(rng, scheme, 64, err_range=(0, 8))
    quals = []
    for r in reads:
        q = rng.integers(22, 41, len(r)) + 33
        quals.append("".join(chr(int(x)) for x in q))
    bases, quality, lengths, mask = encode_batch(reads, quals)
    out = dec.keyed_decode_step(plan_q, bases, quality, lengths, mask)
    lowq = np.asarray(out["counters"])[stats.LOW_QUALITY]
    assert lowq > 0
    for i, (r, q) in enumerate(zip(reads, quals)):
        o = oracle_q.decode(r, q)
        assert bool(np.asarray(out["valid"])[i]) == (o.outcome == "matched")
    pb, n = _packed(tmp_path, scheme, reads, quals, with_quals=True)
    if pb.quals is None:
        pb.quals = dec.unpack_quals_wire(
            pb.quals_packed, pb.qual_codebook, pb.width, pb.qual_bits
        )
    _, ctr = dec.dense_count_step_packed_q(
        plan_q, *_zeros(plan_q), pb.packed, pb.lengths, pb.exc_idx,
        pb.exc_val, pb.quals, pb.width, n,
    )
    np.testing.assert_array_equal(
        np.asarray(ctr), np.asarray(out["counters"])
    )


def _wire_parity(tmp_path, scheme, plan, reads):
    quals = ["I" * len(r) for r in reads]
    pb, n = _packed(tmp_path, scheme, reads, quals)
    wire_p = np.asarray(dec.keyed_decode_step_packed(
        plan, pb.packed, pb.lengths, pb.exc_idx, pb.exc_val, pb.width, n,
    )["wire"])
    bases, quality, lengths, mask = encode_batch(reads, quals)
    out_x = dec.keyed_decode_step(plan, bases, quality, lengths, mask)
    wire_x = np.asarray(
        jax.jit(lambda: dec._keyed_packed_outputs(plan, out_x))()["wire"]
    )
    valid = np.asarray(out_x["valid"])
    B = len(reads)
    np.testing.assert_array_equal(wire_p[:B][valid], wire_x[valid])
    assert valid.sum() > 0
    return wire_p[:B], valid


def test_keyed_wire_parity(rng, tmp_path):
    """The packed keyed step emits the exact wire matrix of the unpacked
    decode (random-barcode scheme with conversion files -> fused layout,
    and raw-DNA scheme -> slot-word layout)."""
    from ngs_barcode_count_tpu.scheme import parse_scheme_text
    from tests.conftest import EXAMPLE_SCHEME

    scheme_r = parse_scheme_text(EXAMPLE_SCHEME)
    plan_r, _, _ = build_plan(scheme_r)
    wire, valid = _wire_parity(
        tmp_path, scheme_r, plan_r, gen_reads(rng, scheme_r, 64, err_range=(0, 8))
    )
    _, _, s_bits, c_bits = dec.keyed_wire_layout(plan_r)["fused"]
    np.testing.assert_array_equal(
        wire[:, 0] >> (s_bits + c_bits), valid.astype(np.int32)
    )
    scheme_s = parse_scheme_text("ACGTACGT\n{6}\nTTGGCCAA\n")
    plan_s, _, _ = build_plan(scheme_s, with_files=False)
    _wire_parity(
        tmp_path, scheme_s, plan_s, gen_reads(rng, scheme_s, 32, err_range=(0, 2))
    )


def test_front_key_overflow_fallback(dense_setup, rng, monkeypatch):
    """Exotic formats whose packed repair key would overflow int32 use
    the plain min/argmin selection; semantics must not change."""
    scheme, plan, oracle, conv = dense_setup
    reads = gen_reads(rng, scheme, 64, err_range=(0, 12))
    quals = ["I" * len(r) for r in reads]
    bases, quality, lengths, mask = encode_batch(reads, quals)
    want = dec.keyed_decode_step(plan, bases, quality, lengths, mask)
    monkeypatch.setattr(dec, "_front_key_bound", lambda *a: 1 << 40)
    plan2, _, _ = build_plan(scheme)  # fresh plan: forces a re-trace
    got = dec.keyed_decode_step(plan2, bases, quality, lengths, mask)
    for key in ("valid", "combo_flat", "sample_idx", "counters"):
        np.testing.assert_array_equal(
            np.asarray(got[key]), np.asarray(want[key]), err_msg=key
        )


def test_realign_matches_numpy(rng):
    """The log2 lane shifter is an exact gather: R[b,p]=src[b,shift+p]."""
    TB, L, F = 8, 40, 13
    O = L - F + 1
    src = rng.integers(0, 7, (TB, L)).astype(np.float32)
    shift = rng.integers(0, O, (TB, 1)).astype(np.int32)
    got = np.asarray(
        jax.jit(lambda s, sh: dec._realign(s, sh, L, O, TB, F))(src, shift)
    )
    want = np.stack(
        [src[b, shift[b, 0] : shift[b, 0] + F] for b in range(TB)]
    )
    np.testing.assert_array_equal(got, want)


def test_hashset_step_packed_equals_unpacked(tmp_path, rng):
    """The packed hash-set step (wire input) must produce bit-identical
    table/counts/counters/overflow to the unpacked step on the same
    reads, with a tiny table so probe chains and overflow both fire."""
    from tests.test_end_to_end import (
        SCHEME_RANDOM_TEXT, write_inputs, _mk_config, SAMPLES, BC1, BC2, BC3,
    )
    from ngs_barcode_count_tpu.runner import setup

    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg = _mk_config(tmp_path, "r.fastq", paths)
    scheme, conv, me, plan, _ = setup(cfg)
    randoms = ["ACGTACGT", "TTGGCCAA", "AAAATTTT", "CGCGCGCG", "NNACGTAC"]
    reads = []
    for _ in range(300):
        reads.append(simulate.make_read(
            rng, scheme, list(SAMPLES)[rng.integers(0, 2)],
            [s[rng.integers(0, 3)] for s in (BC1, BC2, BC3)],
            random_barcode=randoms[rng.integers(0, len(randoms))],
            flank_left=int(rng.integers(0, 6)),
            flank_right=int(rng.integers(0, 6)),
            n_errors=int(rng.integers(0, 6)),
        ))
    quals = ["I" * len(r) for r in reads]
    pb, n = _packed(tmp_path, scheme, reads, quals)
    cap, S = 64, 128

    def fresh():
        return (jnp.zeros(S, jnp.uint32),) + _zeros(plan)

    t_p, c_p, ctr_p, over_p, n_over_p = dec.random_hashset_step_packed(
        plan, *fresh(), pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
        pb.width, cap, n,
    )
    bases = dec.unpack_bases(pb.packed, pb.exc_idx, pb.exc_val, pb.width)
    mask = np.arange(bases.shape[0]) < pb.n_reads
    t_u, c_u, ctr_u, over_u, n_over_u = dec.random_hashset_step_unpacked(
        plan, *fresh(), bases, jnp.zeros((bases.shape[0], 1), jnp.int8),
        pb.lengths, mask, cap,
    )
    for a, b in ((t_p, t_u), (c_p, c_u), (ctr_p, ctr_u),
                 (n_over_p, n_over_u)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    k = int(np.asarray(n_over_p)[0])
    assert k > 0  # the tiny table must actually overflow
    np.testing.assert_array_equal(
        np.asarray(over_p)[:k], np.asarray(over_u)[:k]
    )
    assert int(np.asarray(ctr_p)[stats.DUPLICATES]) > 0


def test_bitmap_step_packed_equals_unpacked(tmp_path, rng):
    """The packed bytemap step (small-combo random mode) must be
    bit-identical to the unpacked step: bytemap and counters."""
    from ngs_barcode_count_tpu.conversions import BarcodeConversions, BarcodeSet
    from ngs_barcode_count_tpu.errors import MaxSeqErrors
    from ngs_barcode_count_tpu.scheme import parse_scheme_text

    scheme = parse_scheme_text("[4]\nACGT\n{5}\nTGCA\n(4)\nTAG\n")
    conv = BarcodeConversions()
    samples = ["AAAA", "CCCC"]
    conv.samples_barcode_hash = {s: f"S{i}" for i, s in enumerate(samples)}
    conv.sample_set = BarcodeSet.from_pairs(
        [(s, f"S{i}") for i, s in enumerate(samples)], 4
    )
    bcs = ["AAAAA", "CCCCC", "GGGGG"]
    conv.counted_barcodes_hash = [{b: f"B{j}" for j, b in enumerate(bcs)}]
    conv.counted_sets = [
        BarcodeSet.from_pairs([(b, f"B{j}") for j, b in enumerate(bcs)], 5)
    ]
    me = MaxSeqErrors.create(None, 4, None, [5], None,
                             scheme.constant_region_length, 0.0)
    plan = dec.make_plan(scheme, conv, me)
    reads = [
        simulate.make_read(
            rng, scheme, samples[rng.integers(0, 2)],
            [bcs[rng.integers(0, 3)]],
            flank_left=int(rng.integers(0, 5)),
            flank_right=int(rng.integers(0, 5)),
            n_errors=int(rng.integers(0, 4)),
        )
        for _ in range(300)
    ]
    pb, n = _packed(tmp_path, scheme, reads, ["I" * len(r) for r in reads])
    n_bytes = plan.n_samples * plan.n_combos * 6 ** scheme.random_slot.length

    def fresh():
        return (jnp.zeros(n_bytes, jnp.uint8),
                jnp.zeros(stats.NUM_COUNTERS, jnp.int32))

    bm_p, ctr_p = dec.random_bitmap_step_packed(
        plan, *fresh(), pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
        pb.width, n,
    )
    bases = dec.unpack_bases(pb.packed, pb.exc_idx, pb.exc_val, pb.width)
    mask = np.arange(bases.shape[0]) < pb.n_reads
    bm_u, ctr_u = dec.random_bitmap_step(
        plan, *fresh(), bases, jnp.zeros((bases.shape[0], 1), jnp.int8),
        pb.lengths, mask,
    )
    np.testing.assert_array_equal(np.asarray(ctr_p), np.asarray(ctr_u))
    np.testing.assert_array_equal(np.asarray(bm_p), np.asarray(bm_u))
    assert int(np.asarray(bm_p).sum()) > 0
