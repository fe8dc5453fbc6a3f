"""Scheme-fuzz parity: randomized schemes (slot counts/lengths/order,
constants, explicit-N runs, optional sample/random regions) x randomized
reads (errors, Ns, flanks, short reads) — the tensor decode must
classify and key every read exactly like the string oracle.

This is breadth the fixed-scheme suites can't give: every run draws 8
fresh schemes; failures print the scheme text for replay.
"""

import numpy as np
import pytest

from ngs_barcode_count_tpu.conversions import BarcodeConversions, BarcodeSet
from ngs_barcode_count_tpu.errors import MaxSeqErrors
from ngs_barcode_count_tpu.ops import decode as dec
from ngs_barcode_count_tpu.oracle import Oracle
from ngs_barcode_count_tpu.scheme import parse_scheme_text
from ngs_barcode_count_tpu.utils import simulate

from tests.test_decode_vs_oracle import encode_batch


def _random_scheme_text(rng) -> str:
    """A random but valid scheme: constants interleaved with 1-3 counted
    slots, optional sample/random regions, occasional explicit-N runs."""
    parts = []

    def const(lo=4, hi=10):
        s = simulate.random_seq(rng, int(rng.integers(lo, hi)))
        if rng.random() < 0.3:  # splice an explicit-N wildcard run in
            k = int(rng.integers(1, 3))
            pos = int(rng.integers(0, len(s)))
            s = s[:pos] + "N" * k + s[pos:]
        return s

    if rng.random() < 0.6:
        parts += [f"[{int(rng.integers(6, 11))}]", const()]
    else:
        parts.append(const())
    n_counted = int(rng.integers(1, 4))
    for _ in range(n_counted):
        parts += [f"{{{int(rng.integers(4, 9))}}}", const(3, 7)]
    if rng.random() < 0.4:
        parts += [f"({int(rng.integers(4, 9))})", const(3, 6)]
    return "\n".join(parts) + "\n"


def _tables(rng, scheme):
    conv = BarcodeConversions()
    samples = []
    if scheme.sample_slot is not None:
        got = set()
        while len(got) < 3:
            got.add(simulate.random_seq(rng, scheme.sample_slot.length))
        samples = sorted(got)
        conv.samples_barcode_hash = {s: f"S{i}" for i, s in enumerate(samples)}
        conv.sample_set = BarcodeSet.from_pairs(
            [(s, f"S{i}") for i, s in enumerate(samples)],
            scheme.sample_slot.length,
        )
    sets = []
    for i, slot in enumerate(scheme.barcode_slots):
        got = set()
        while len(got) < int(rng.integers(3, 7)):
            got.add(simulate.random_seq(rng, slot.length))
        sets.append(sorted(got))
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
    return conv, samples, sets


def _reads(rng, scheme, samples, sets, n):
    reads, quals = [], []
    for _ in range(n):
        sample = samples[rng.integers(0, len(samples))] if samples else None
        counted = [s[rng.integers(0, len(s))] for s in sets]
        r = simulate.make_read(
            rng, scheme, sample, counted,
            flank_left=int(rng.integers(0, 7)),
            flank_right=int(rng.integers(0, 7)),
            n_errors=int(rng.integers(0, 7)),
        )
        # salt with Ns / truncations
        if rng.random() < 0.3:
            r = list(r)
            for _ in range(int(rng.integers(1, 4))):
                r[int(rng.integers(0, len(r)))] = "N"
            r = "".join(r)
        if rng.random() < 0.05:
            r = r[: max(int(rng.integers(1, len(r))), 1)]
        reads.append(r)
        q = rng.integers(20, 41, len(r)) + 33
        quals.append("".join(chr(int(x)) for x in q))
    return reads, quals


@pytest.mark.parametrize("seed", range(8))
def test_fuzzed_scheme_parity(seed):
    rng = np.random.default_rng(1000 + seed)
    text = _random_scheme_text(rng)
    scheme = parse_scheme_text(text)
    conv, samples, sets = _tables(rng, scheme)
    min_quality = 30.0 if rng.random() < 0.5 else 0.0
    me = MaxSeqErrors.create(
        None, scheme.sample_length, None, scheme.barcode_lengths, None,
        scheme.constant_region_length, min_quality,
    )
    plan = dec.make_plan(scheme, conv, me)
    oracle = Oracle(
        scheme, me, list(conv.samples_barcode_hash.keys()),
        [s.sequences for s in conv.counted_sets], min_quality,
    )
    reads, quals = _reads(rng, scheme, samples, sets, 192)
    bases, quality, lengths, mask = encode_batch(reads, quals)
    out = dec.keyed_decode_step(plan, bases, quality, lengths, mask)
    valid = np.asarray(out["valid"])
    combo = np.asarray(out["combo_flat"]) if "combo_flat" in out else None
    sample_idx = np.asarray(out["sample_idx"])
    for i, (r, q) in enumerate(zip(reads, quals)):
        o = oracle.decode(r, q)
        assert bool(valid[i]) == (o.outcome == "matched"), (
            seed, i, o.outcome, text
        )
        if valid[i] and combo is not None:
            idxs = []
            flat = int(combo[i])
            for nr in reversed(plan.combo_radix):
                idxs.append(flat % nr)
                flat //= nr
            got = tuple(
                conv.counted_sets[j].sequences[k]
                for j, k in enumerate(reversed(idxs))
            )
            assert got == o.counted_barcodes, (seed, i, text)
            if scheme.sample_slot is not None:
                assert (
                    conv.sample_set.sequences[int(sample_idx[i])]
                    == o.sample_barcode
                ), (seed, i, text)


@pytest.mark.parametrize("seed", range(4))
def test_fuzzed_scheme_e2e_pipeline(tmp_path, seed):
    """Same fuzzed schemes driven through the PRODUCTION pipeline: files
    on disk -> native codec wire format -> whatever mode the runner
    selects (dense / bytemap / device hash-set / keyed) -> counters must
    equal the oracle's tallies."""
    from ngs_barcode_count_tpu.io import native
    from ngs_barcode_count_tpu.runner import (
        CountAccumulator, RunConfig, decode_file, setup,
    )
    from ngs_barcode_count_tpu import stats as S
    from tests.test_end_to_end import oracle_counts

    if not native.available():
        pytest.skip("native codec not built")
    rng = np.random.default_rng(2000 + seed)
    text = _random_scheme_text(rng)
    scheme = parse_scheme_text(text)
    conv, samples, sets = _tables(rng, scheme)

    fmt = tmp_path / "scheme.txt"
    fmt.write_text(text)
    paths = {}
    if samples:
        sf = tmp_path / "samples.csv"
        sf.write_text(
            "Barcode,ID\n" + "".join(f"{b},S{i}\n"
                                     for i, b in enumerate(samples))
        )
        paths["samples"] = str(sf)
    cf = tmp_path / "bc.csv"
    cf.write_text(
        "Barcode,ID,Num\n" + "".join(
            f"{b},B{i}_{j},{i + 1}\n"
            for i, s in enumerate(sets) for j, b in enumerate(s)
        )
    )
    reads, quals = _reads(rng, scheme, samples, sets, 300)
    fq = tmp_path / "r.fastq"
    simulate.write_fastq(str(fq), reads, quals)

    min_quality = 30.0 if rng.random() < 0.5 else 0.0
    cfg = RunConfig(
        fastq=str(fq), format=str(fmt),
        sample_barcodes_option=paths.get("samples"),
        counted_barcodes_option=str(cf),
        output_dir=str(tmp_path), prefix="fz", batch_size=128,
        progress=False, min_average_quality_score=min_quality,
    )
    scheme2, conv2, me, plan, _ = setup(cfg)
    acc = CountAccumulator(plan, conv2)
    n = decode_file(cfg, plan, scheme2, acc)
    acc.finalize()
    assert n == len(reads)

    exp, tallies = oracle_counts(cfg, reads, quals)
    c = acc.seq_errors.counters
    assert c[S.MATCHED] == tallies["matched"], (seed, text)
    assert c[S.CONSTANT_REGION] == tallies["constant_region"], (seed, text)
    assert c[S.SAMPLE_BARCODE] == tallies["sample_barcode"], (seed, text)
    assert c[S.BARCODE] == tallies["barcode"], (seed, text)
    assert c[S.LOW_QUALITY] == tallies["low_quality"], (seed, text)
    assert c[S.DUPLICATES] == tallies["duplicates"], (seed, text)
    assert acc.results_view().per_sample == exp, (seed, text)


def _read_csv_counts(path):
    """{joined_code: [count columns]} from a written counts CSV.  Code
    columns are the header cells named Barcode/Barcode_i; the rest are
    count columns (one for per-sample files, one per sample in merged
    files)."""
    out = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split(",")
        n_code = sum(1 for h in header if h.startswith("Barcode"))
        for line in f:
            cells = line.rstrip("\n").split(",")
            out[",".join(cells[:n_code])] = [
                int(v) for v in cells[n_code:]
            ]
    return out


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_merge_enrich_gzip_outputs(tmp_path, seed):
    """Fuzzed schemes through the FULL runner with --merge-output and
    --enrich, half of them gzipped (VERDICT r2 next #9): the written
    per-sample / merged / enriched CSVs must equal an independent
    restatement of the reference's aggregation (output.rs:199-361
    merged dedup, info.rs:840-904 enrichment marginals) applied to the
    string oracle's counts."""
    from ngs_barcode_count_tpu.io import native
    from ngs_barcode_count_tpu.runner import RunConfig, run
    from tests.test_end_to_end import oracle_counts

    if not native.available():
        pytest.skip("native codec not built")
    rng = np.random.default_rng(3000 + seed)
    gz = seed % 2 == 1
    text = _random_scheme_text(rng)
    scheme = parse_scheme_text(text)
    conv, samples, sets = _tables(rng, scheme)

    fmt = tmp_path / "scheme.txt"
    fmt.write_text(text)
    sample_file = None
    if samples:
        sf = tmp_path / "samples.csv"
        sf.write_text(
            "Barcode,ID\n"
            + "".join(f"{b},S{i}\n" for i, b in enumerate(samples))
        )
        sample_file = str(sf)
    cf = tmp_path / "bc.csv"
    cf.write_text(
        "Barcode,ID,Num\n" + "".join(
            f"{b},B{i}_{j},{i + 1}\n"
            for i, s in enumerate(sets) for j, b in enumerate(s)
        )
    )
    reads, quals = _reads(rng, scheme, samples, sets, 250)
    fq = tmp_path / ("r.fastq" + (".gz" if gz else ""))
    simulate.write_fastq(str(fq), reads, quals, gzip_out=gz)

    cfg = RunConfig(
        fastq=str(fq), format=str(fmt),
        sample_barcodes_option=sample_file,
        counted_barcodes_option=str(cf),
        output_dir=str(tmp_path), prefix="fz", batch_size=128,
        progress=False, merge_output=True, enrich=True,
    )
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert result.seq_errors.matched == tallies["matched"], (seed, text)
    assert {k: dict(v) for k, v in result.results.per_sample.items()} \
        == exp, (seed, text)

    # independent restatement: convert oracle counts to IDs per sample
    id_of = [
        {b: f"B{i}_{j}" for j, b in enumerate(s)}
        for i, s in enumerate(sets)
    ]

    def convert(code):
        return ",".join(
            id_of[j][b] for j, b in enumerate(code.split(","))
        )

    names = {b: f"S{i}" for i, b in enumerate(samples)}
    conv_counts = {
        names.get(sb, "barcode" if samples else sb): {
            convert(c): n for c, n in d.items()
        }
        for sb, d in exp.items()
    }

    # per-sample full CSVs
    for name, d in conv_counts.items():
        got = _read_csv_counts(str(tmp_path / f"fz_{name}_counts.csv"))
        assert {k: v[0] for k, v in got.items()} == d, (seed, text, name)

    sorted_names = sorted(conv_counts)
    if len(conv_counts) > 1:
        got = _read_csv_counts(str(tmp_path / "fz_counts.all.csv"))
        exp_merged = {
            code: [conv_counts[nm].get(code, 0) for nm in sorted_names]
            for d in conv_counts.values() for code in d
        }
        assert got == exp_merged, (seed, text)
    else:
        assert not (tmp_path / "fz_counts.all.csv").exists()

    n_bc = scheme.barcode_num
    if n_bc >= 2:  # enrich demoted below 2 barcodes (main.rs:22-25)
        for name, d in conv_counts.items():
            single = {}
            for code, cnt in d.items():
                parts = code.split(",")
                for j in range(n_bc):
                    cols = [""] * n_bc
                    cols[j] = parts[j]
                    k = ",".join(cols)
                    single[k] = single.get(k, 0) + cnt
            got = _read_csv_counts(
                str(tmp_path / f"fz_{name}_counts.Single.csv")
            )
            assert {k: v[0] for k, v in got.items()} == single, (
                seed, text, name
            )
        if n_bc > 2:
            for name, d in conv_counts.items():
                double = {}
                for code, cnt in d.items():
                    parts = code.split(",")
                    for j in range(n_bc - 1):
                        for k2 in range(j + 1, n_bc):
                            cols = [""] * n_bc
                            cols[j] = parts[j]
                            cols[k2] = parts[k2]
                            kk = ",".join(cols)
                            double[kk] = double.get(kk, 0) + cnt
                got = _read_csv_counts(
                    str(tmp_path / f"fz_{name}_counts.Double.csv")
                )
                assert {k: v[0] for k, v in got.items()} == double, (
                    seed, text, name
                )
    else:
        assert not list(tmp_path.glob("*.Single.csv"))


def _packed_batch(scheme, reads, quals, batch=256):
    import tempfile

    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )

    with tempfile.TemporaryDirectory() as td:
        fq = td + "/f.fastq"
        simulate.write_fastq(fq, reads, quals)
        pb = next(iter(read_fastq_packed_parallel(
            fq, min_width=scheme.length, batch_reads=batch,
        )))
    if getattr(pb, "transposed", False):
        pb.packed = np.ascontiguousarray(pb.packed.T)
        pb.transposed = False
    return pb, np.array([pb.n_reads], np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_packed_input_kernel(tmp_path, seed):
    """Fuzzed dense schemes through the packed-input XLA step (native
    2-bit wire + exception list, unpacked on device): counters equal
    the string oracle's tallies and per-combo counts its counts, across
    scheme shapes — N runs, odd slot layouts, sample regions, short
    reads, read-Ns."""
    import jax.numpy as jnp

    from ngs_barcode_count_tpu import stats as S

    rng = np.random.default_rng(9000 + seed)
    checked = 0
    for _ in range(3):
        text = _random_scheme_text(rng)
        scheme = parse_scheme_text(text)
        conv, samples, sets = _tables(rng, scheme)
        me = MaxSeqErrors.create(
            None, scheme.sample_length, None, scheme.barcode_lengths,
            None, scheme.constant_region_length, 0.0,
        )
        plan = dec.make_plan(scheme, conv, me)
        if not plan.dense_counts:
            continue  # dense step only (random schemes -> keyed path)
        oracle = Oracle(
            scheme, me, list(conv.samples_barcode_hash.keys()),
            [s.sequences for s in conv.counted_sets], 0.0,
        )
        reads, quals = _reads(rng, scheme, samples, sets, 200)
        pb, n = _packed_batch(scheme, reads, quals)
        counts, ctr = dec.dense_count_step_packed(
            plan, jnp.zeros(plan.n_samples * plan.n_combos, jnp.int32),
            jnp.zeros(S.NUM_COUNTERS, jnp.int32), pb.packed, pb.lengths,
            pb.exc_idx, pb.exc_val, pb.width, n,
        )
        want = np.zeros(plan.n_samples * plan.n_combos, np.int64)
        tallies = {k: 0 for k in ("matched", "constant_region",
                                  "sample_barcode", "barcode")}
        samp = list(conv.samples_barcode_hash.keys())
        for r, q in zip(reads, quals):
            o = oracle.decode(r, q)
            tallies[o.outcome] += 1
            if o.outcome != "matched":
                continue
            flat = samp.index(o.sample_barcode) if samp else 0
            for j, code in enumerate(o.counted_barcodes):
                flat = flat * plan.combo_radix[j] + list(
                    conv.counted_sets[j].sequences
                ).index(code)
            want[flat] += 1
        ctr = np.asarray(ctr)
        assert ctr[S.MATCHED] == tallies["matched"], text
        assert ctr[S.CONSTANT_REGION] == tallies["constant_region"], text
        assert ctr[S.SAMPLE_BARCODE] == tallies["sample_barcode"], text
        assert ctr[S.BARCODE] == tallies["barcode"], text
        np.testing.assert_array_equal(np.asarray(counts), want, err_msg=text)
        checked += 1
    assert checked


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_packed_input_keyed_kernel(tmp_path, seed):
    """Keyed-mode packed XLA step (wire emission incl. 3-bit word
    packing) vs the unpacked keyed decode across fuzzed schemes with
    random/raw regions: identical valid flags and wire rows, and valid
    flags equal to the oracle's."""
    import jax

    from ngs_barcode_count_tpu.ops.decode import _keyed_packed_outputs

    rng = np.random.default_rng(31000 + seed)
    checked = 0
    while checked < 2:
        text = _random_scheme_text(rng)
        scheme = parse_scheme_text(text)
        if scheme.random_slot is None and rng.random() < 0.7:
            continue  # prefer keyed-shaped schemes
        conv, samples, sets = _tables(rng, scheme)
        me = MaxSeqErrors.create(
            None, scheme.sample_length, None, scheme.barcode_lengths,
            None, scheme.constant_region_length, 0.0,
        )
        plan = dec.make_plan(scheme, conv, me)
        if plan.dense_counts:
            continue
        reads, quals = _reads(rng, scheme, samples, sets, 200)
        pb, n = _packed_batch(scheme, reads, quals)
        wire_p = np.asarray(dec.keyed_decode_step_packed(
            plan, pb.packed, pb.lengths, pb.exc_idx, pb.exc_val, pb.width, n,
        )["wire"])[: len(reads)]
        bases, quality, lengths, mask = encode_batch(reads, quals)
        out = dec.keyed_decode_step(plan, bases, quality, lengths, mask)
        wire_u = np.asarray(
            jax.jit(lambda: _keyed_packed_outputs(plan, out))()["wire"]
        )
        valid = np.asarray(out["valid"])
        oracle = Oracle(
            scheme, me, list(conv.samples_barcode_hash.keys()),
            [s.sequences for s in conv.counted_sets], 0.0,
        )
        for i, (r, q) in enumerate(zip(reads, quals)):
            assert bool(valid[i]) == (
                oracle.decode(r, q).outcome == "matched"
            ), (i, text)
        # wire rows must agree on valid reads (invalid rows may hold
        # garbage slot words; the host masks by valid)
        np.testing.assert_array_equal(
            wire_p[valid], wire_u[valid], err_msg=text
        )
        checked += 1


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_host_gate_vs_oracle(tmp_path, seed, monkeypatch):
    """Fuzzed schemes through the round-5 two-phase HOST quality gate
    (NGS_QUAL_WIRE=host): counters and per-sample counts must equal the
    string oracle exactly, across random schemes (explicit-N runs,
    optional sample region), fuzzed reads, and a forced quality gate.
    Only dense-eligible draws exercise the gate; others fall through to
    the normal path and still must match."""
    from ngs_barcode_count_tpu.io import native
    from ngs_barcode_count_tpu.runner import (
        CountAccumulator, RunConfig, decode_file, setup,
    )
    from ngs_barcode_count_tpu import stats as S
    from tests.test_end_to_end import oracle_counts

    if not native.available():
        pytest.skip("native codec not built")
    monkeypatch.setenv("NGS_QUAL_WIRE", "host")
    rng = np.random.default_rng(7100 + seed)
    text = _random_scheme_text(rng)
    scheme = parse_scheme_text(text)
    conv, samples, sets = _tables(rng, scheme)

    fmt = tmp_path / "scheme.txt"
    fmt.write_text(text)
    paths = {}
    if samples:
        sf = tmp_path / "samples.csv"
        sf.write_text(
            "Barcode,ID\n" + "".join(f"{b},S{i}\n"
                                     for i, b in enumerate(samples))
        )
        paths["samples"] = str(sf)
    cf = tmp_path / "bc.csv"
    cf.write_text(
        "Barcode,ID,Num\n" + "".join(
            f"{b},B{i}_{j},{i + 1}\n"
            for i, s in enumerate(sets) for j, b in enumerate(s)
        )
    )
    reads, quals = _reads(rng, scheme, samples, sets, 300)
    fq = tmp_path / "r.fastq"
    simulate.write_fastq(str(fq), reads, quals)

    cfg = RunConfig(
        fastq=str(fq), format=str(fmt),
        sample_barcodes_option=paths.get("samples"),
        counted_barcodes_option=str(cf),
        output_dir=str(tmp_path), prefix="fz", batch_size=128,
        progress=False, min_average_quality_score=30.0,
    )
    scheme2, conv2, me, plan, _ = setup(cfg)
    acc = CountAccumulator(plan, conv2)
    n = decode_file(cfg, plan, scheme2, acc)
    acc.finalize()
    assert n == len(reads)

    exp, tallies = oracle_counts(cfg, reads, quals)
    c = acc.seq_errors.counters
    assert c[S.MATCHED] == tallies["matched"], (seed, text)
    assert c[S.CONSTANT_REGION] == tallies["constant_region"], (seed, text)
    assert c[S.SAMPLE_BARCODE] == tallies["sample_barcode"], (seed, text)
    assert c[S.BARCODE] == tallies["barcode"], (seed, text)
    assert c[S.LOW_QUALITY] == tallies["low_quality"], (seed, text)
    assert c[S.DUPLICATES] == tallies["duplicates"], (seed, text)
    assert acc.results_view().per_sample == exp, (seed, text)
