"""The decode engine's parity harness: the vectorized device path must
classify every read identically to the string-based oracle (which is a
literal restatement of the reference's parse.rs logic)."""

import numpy as np
import pytest

from ngs_barcode_count_tpu import dna, stats
from ngs_barcode_count_tpu.conversions import BarcodeConversions, BarcodeSet
from ngs_barcode_count_tpu.errors import MaxSeqErrors
from ngs_barcode_count_tpu.ops import decode as dec
from ngs_barcode_count_tpu.oracle import Oracle
from ngs_barcode_count_tpu.utils import simulate

SAMPLES = ["AGCATACGTT", "AACTTACCAT"]
BC1 = ["CAGAGA", "TGATTG", "AAGGCC"]
BC2 = ["ATGAAA", "GCGCCA", "TTTACG"]
BC3 = ["GATAGC", "TTAGCT", "CCATTG"]


def build_plan(scheme, with_files=True, min_quality=0.0):
    conv = BarcodeConversions()
    if with_files and scheme.sample_barcode:
        conv.samples_barcode_hash = {s: f"S{i}" for i, s in enumerate(SAMPLES)}
        conv.sample_set = BarcodeSet.from_pairs(
            [(s, f"S{i}") for i, s in enumerate(SAMPLES)], 10
        )
    if with_files:
        sets = [BC1, BC2, BC3][: scheme.barcode_num]
        conv.counted_barcodes_hash = [
            {b: f"B{i}_{j}" for j, b in enumerate(s)} for i, s in enumerate(sets)
        ]
        conv.counted_sets = [
            BarcodeSet.from_pairs(
                [(b, f"B{i}_{j}") for j, b in enumerate(s)],
                scheme.barcode_lengths[i],
            )
            for i, s in enumerate(sets)
        ]
    me = MaxSeqErrors.create(
        None,
        scheme.sample_length,
        None,
        scheme.barcode_lengths,
        None,
        scheme.constant_region_length,
        min_quality,
    )
    plan = dec.make_plan(scheme, conv, me)
    oracle = Oracle(
        scheme,
        me,
        list(conv.samples_barcode_hash.keys()),
        [s.sequences for s in conv.counted_sets],
        min_quality,
    )
    return plan, oracle, conv


def encode_batch(reads, quals, width=None):
    L = max(len(r) for r in reads)
    if width:
        L = max(L, width)
    L = -(-L // 32) * 32
    B = len(reads)
    bases = np.full((B, L), dna.PAD, np.int8)
    quality = np.zeros((B, L), np.int8)
    lengths = np.zeros(B, np.int32)
    for i, (r, q) in enumerate(zip(reads, quals)):
        bases[i, : len(r)] = dna.encode(r)
        quality[i, : len(q)] = np.frombuffer(q.encode(), np.uint8).astype(
            np.int16
        )[: len(q)] - 33
        lengths[i] = len(r)
    mask = np.ones(B, dtype=bool)
    return bases, quality, lengths, mask


def classify_device(plan, reads, quals):
    bases, quality, lengths, mask = encode_batch(reads, quals)
    out = dec.keyed_decode_step(plan, bases, quality, lengths, mask)
    return {k: np.asarray(v) for k, v in out.items() if not isinstance(v, list)} | {
        k: [np.asarray(x) for x in v]
        for k, v in out.items()
        if isinstance(v, list)
    }


def oracle_outcomes(oracle, reads, quals):
    return [oracle.decode(r, q) for r, q in zip(reads, quals)]


def _check_parity(plan, oracle, reads, quals, conv):
    res = classify_device(plan, reads, quals)
    orc = oracle_outcomes(oracle, reads, quals)
    valid = res["valid"]
    for i, o in enumerate(orc):
        assert bool(valid[i]) == (o.outcome == "matched"), (
            f"read {i}: device valid={bool(valid[i])} oracle={o.outcome}\n"
            f"{reads[i]}"
        )
        if o.outcome == "matched" and "combo_flat" in res:
            # reconstruct the device's barcode choice
            flat = int(res["combo_flat"][i])
            idxs = []
            for n in reversed([s.count for s in conv.counted_sets]):
                idxs.append(flat % n)
                flat //= n
            idxs = list(reversed(idxs))
            dev_bcs = tuple(
                conv.counted_sets[j].sequences[idx] for j, idx in enumerate(idxs)
            )
            assert dev_bcs == o.counted_barcodes, f"read {i}"
            if plan.dense_sample and oracle.scheme.sample_barcode:
                s_idx = int(res["sample_idx"][i])
                assert (
                    conv.sample_set.sequences[s_idx] == o.sample_barcode
                ), f"read {i}"
    # counter parity
    counts = {k: 0 for k in ["matched", "constant_region", "sample_barcode", "barcode", "low_quality"]}
    for o in orc:
        counts[o.outcome] += 1
    c = np.asarray(res["counters"])
    assert c[stats.CONSTANT_REGION] == counts["constant_region"]
    assert c[stats.SAMPLE_BARCODE] == counts["sample_barcode"]
    assert c[stats.BARCODE] == counts["barcode"]
    assert c[stats.LOW_QUALITY] == counts["low_quality"]


def gen_reads(rng, scheme, n, flanks=(0, 12), err_range=(0, 8)):
    reads = []
    for _ in range(n):
        sample = (
            SAMPLES[rng.integers(0, len(SAMPLES))]
            if scheme.sample_barcode
            else None
        )
        sets = [BC1, BC2, BC3][: scheme.barcode_num]
        counted = [s[rng.integers(0, len(s))] for s in sets]
        read = simulate.make_read(
            rng,
            scheme,
            sample,
            counted,
            flank_left=int(rng.integers(flanks[0], flanks[1] + 1)),
            flank_right=int(rng.integers(flanks[0], flanks[1] + 1)),
            n_errors=int(rng.integers(err_range[0], err_range[1] + 1)),
        )
        reads.append(read)
    return reads


def test_clean_reads_match(example_scheme, rng):
    plan, oracle, conv = build_plan(example_scheme)
    reads = gen_reads(rng, example_scheme, 64, err_range=(0, 0))
    quals = ["I" * len(r) for r in reads]
    res = classify_device(plan, reads, quals)
    assert res["valid"].all()
    _check_parity(plan, oracle, reads, quals, conv)


def test_constant_errors_and_repair(example_scheme, rng):
    plan, oracle, conv = build_plan(example_scheme)
    reads = gen_reads(rng, example_scheme, 256, err_range=(0, 14))
    quals = ["I" * len(r) for r in reads]
    _check_parity(plan, oracle, reads, quals, conv)


def test_barcode_substitutions(example_scheme, rng):
    plan, oracle, conv = build_plan(example_scheme)
    reads = []
    for _ in range(256):
        sample = SAMPLES[rng.integers(0, 2)]
        counted = [s[rng.integers(0, 3)] for s in [BC1, BC2, BC3]]
        read = simulate.make_read(
            rng, example_scheme, sample, counted, flank_left=3, flank_right=5
        )
        # mutate random positions anywhere (barcode slots included)
        n_mut = int(rng.integers(0, 6))
        pos = rng.choice(len(read), size=n_mut, replace=False)
        read = simulate.make_read(
            rng,
            example_scheme,
            sample,
            counted,
            flank_left=3,
            flank_right=5,
            error_positions=list(pos),
        )
        reads.append(read)
    quals = ["I" * len(r) for r in reads]
    _check_parity(plan, oracle, reads, quals, conv)


def test_n_bases_are_wildcards(example_scheme, rng):
    plan, oracle, conv = build_plan(example_scheme)
    reads = gen_reads(rng, example_scheme, 128, err_range=(0, 4))
    # sprinkle Ns
    noisy = []
    for r in reads:
        r = list(r)
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, len(r)))] = "N"
        noisy.append("".join(r))
    quals = ["I" * len(r) for r in noisy]
    _check_parity(plan, oracle, noisy, quals, conv)


def test_quality_gate(example_scheme, rng):
    plan, oracle, conv = build_plan(example_scheme, min_quality=30.0)
    reads = gen_reads(rng, example_scheme, 128, err_range=(0, 6))
    quals = []
    for r in reads:
        q = rng.integers(20, 41, len(r)) + 33
        quals.append("".join(chr(int(x)) for x in q))
    _check_parity(plan, oracle, reads, quals, conv)


def test_short_reads_dropped(example_scheme, rng):
    plan, oracle, conv = build_plan(example_scheme)
    reads = ["ACGT" * 5, "A" * (example_scheme.length - 1)]
    quals = ["I" * len(r) for r in reads]
    res = classify_device(plan, reads, quals)
    assert not res["valid"].any()
    assert np.asarray(res["counters"])[stats.CONSTANT_REGION] == 2


def test_simple_scheme_no_sample(simple_scheme, rng):
    plan, oracle, conv = build_plan(simple_scheme)
    reads = gen_reads(rng, simple_scheme, 128, err_range=(0, 4))
    quals = ["I" * len(r) for r in reads]
    _check_parity(plan, oracle, reads, quals, conv)


def test_raw_dna_mode(simple_scheme, rng):
    plan, oracle, conv = build_plan(simple_scheme, with_files=False)
    assert not plan.dense_counted
    reads = gen_reads(rng, simple_scheme, 64, err_range=(0, 3))
    quals = ["I" * len(r) for r in reads]
    res = classify_device(plan, reads, quals)
    orc = oracle_outcomes(oracle, reads, quals)
    for i, o in enumerate(orc):
        assert bool(res["valid"][i]) == (o.outcome == "matched")
        if o.outcome == "matched":
            codes = res["counted_codes"][0][i]
            assert dna.decode(codes) == o.counted_barcodes[0]


def test_tie_drop(example_scheme):
    """Two candidates at the same best distance => read dropped
    (parse.rs:577-592)."""
    scheme = example_scheme
    plan, oracle, conv = build_plan(scheme)
    rng = np.random.default_rng(7)
    # BC1[0]=CAGAGA, BC1[1]=TGATTG: craft a barcode equidistant from two
    # candidates at distance 1 each -> must be dropped even though budget=1.
    bc1_set = ["CAGAGA", "CAGAGT"]  # distance-2 apart
    conv.counted_sets[0] = BarcodeSet.from_pairs(
        [(b, f"X{j}") for j, b in enumerate(bc1_set)], 6
    )
    conv.counted_barcodes_hash[0] = {b: f"X{j}" for j, b in enumerate(bc1_set)}
    plan = dec.make_plan(scheme, conv, plan.max_errors)
    oracle.counted_barcode_seqs[0] = bc1_set
    # "CAGAGC" is distance 1 from both
    read = simulate.make_read(
        rng,
        scheme,
        SAMPLES[0],
        ["CAGAGC", BC2[0], BC3[0]],
        flank_left=2,
        flank_right=2,
    )
    quals = ["I" * len(read)]
    res = classify_device(plan, [read], quals)
    o = oracle.decode(read, quals[0])
    assert o.outcome == "barcode"
    assert not res["valid"][0]
    assert np.asarray(res["counters"])[stats.BARCODE] == 1


def test_lowercase_read_rejected_like_reference(example_scheme, rng):
    """The reference compares read sequences as-is against uppercased
    constants / [AGCT] / candidate strings (parse.rs:92, 569), so
    lowercase bases never match.  The tensor path encodes them as OTHER
    and must classify identically to the oracle."""
    plan, oracle, conv = build_plan(example_scheme)
    clean = simulate.make_read(
        rng, example_scheme, SAMPLES[0], [BC1[0], BC2[0], BC3[0]]
    )
    reads = [clean, clean.lower(), clean[:6] + clean[6:].lower()]
    quals = ["I" * len(r) for r in reads]
    res = classify_device(plan, reads, quals)
    for i, r in enumerate(reads):
        o = oracle.decode(r, quals[i])
        assert bool(res["valid"][i]) == (o.outcome == "matched"), (i, o.outcome)
    assert res["valid"][0]
    assert not res["valid"][1]


@pytest.mark.parametrize("lane", [8, 16, 32, 128])
def test_scan_lane_padding_is_bit_exact(example_scheme, rng, monkeypatch,
                                        lane):
    """The scan matmul's offset-axis padding (SCAN_LANE) must never
    change results: padded columns are index-masked, so every lane
    width classifies like the default and like the oracle."""
    reads = gen_reads(rng, example_scheme, 256, err_range=(0, 8))
    quals = ["I" * len(r) for r in reads]
    plan, oracle, conv = build_plan(example_scheme)
    want = classify_device(plan, reads, quals)
    monkeypatch.setattr(dec, "SCAN_LANE", lane)
    # fresh plan: DecodePlan hashes by identity, so this forces a
    # re-trace (a shared plan would hit the jit cache and silently
    # compare the default program against itself)
    plan, oracle, conv = build_plan(example_scheme)
    got = classify_device(plan, reads, quals)
    for key in want:
        np.testing.assert_array_equal(
            np.asarray(got[key]), np.asarray(want[key]),
            err_msg=f"lane padding changed {key}",
        )
    for i, o in enumerate(oracle_outcomes(oracle, reads, quals)):
        assert bool(got["valid"][i]) == (o.outcome == "matched")


@pytest.mark.parametrize("noise", ["clean", "n_other_pad"])
def test_onehot_matches_concat_form(rng, noise):
    """The scan's c-major one-hot equals the per-code compare/concat
    formulation it replaced, for every code incl. N, OTHER and PAD."""
    import jax.numpy as jnp

    hi = 4 if noise == "clean" else dna.NUM_SYMBOLS
    bases = rng.integers(0, hi, (64, 40)).astype(np.int8)
    got = np.asarray(dec._onehot_cmajor(jnp.asarray(bases)))
    want = np.concatenate(
        [(bases == c).astype(np.float32) for c in range(5)], axis=1
    )
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.astype(np.float32), want)
