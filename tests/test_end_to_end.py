"""End-to-end runs over real files: synthetic FASTQ + the reference's
example scheme/barcode files, device pipeline vs oracle-aggregated counts
(the golden configs of BASELINE.json)."""

import gzip
import os

import numpy as np
import pytest

from ngs_barcode_count_tpu.oracle import oracle_counts
from ngs_barcode_count_tpu.runner import RunConfig, run, setup
from ngs_barcode_count_tpu.utils import simulate

SAMPLES = {"AGCATACGTT": "Sample_name_1", "AACTTACCAT": "Sample_name_2"}
BC1 = ["CAGAGA", "TGATTG", "AAGGCC"]
BC2 = ["ATGAAA", "GCGCCA", "TTTACG"]
BC3 = ["GATAGC", "TTAGCT", "CCATTG"]

SCHEME_TEXT = """\
# test scheme
[10]
AGCTACGAATCG
{6}
TGGA
{6}
TGGA
{6}
ACTAGAT
TAGA
"""

SCHEME_RANDOM_TEXT = SCHEME_TEXT.replace("ACTAGAT\nTAGA", "ACTAGAT\n(8)\nTAGA")


def write_inputs(tmp_path, scheme_text=SCHEME_TEXT, with_files=True):
    fmt = tmp_path / "scheme.txt"
    fmt.write_text(scheme_text)
    paths = {"format": str(fmt)}
    if with_files:
        sf = tmp_path / "samples.csv"
        sf.write_text(
            "Barcode,Sample_ID\n"
            + "".join(f"{b},{i}\n" for b, i in SAMPLES.items())
        )
        cf = tmp_path / "barcodes.csv"
        rows = []
        for pos, bcs in enumerate([BC1, BC2, BC3], start=1):
            for j, b in enumerate(bcs):
                rows.append(f"{b},BC{pos}_{j},{pos}\n")
        cf.write_text("Barcode,Barcode_ID,Barcode_Number\n" + "".join(rows))
        paths["samples"] = str(sf)
        paths["barcodes"] = str(cf)
    return paths


def gen_fastq(tmp_path, scheme, n, rng, gz=False, quality_range=None,
              err_range=(0, 10), name="reads.fastq"):
    reads, quals = [], []
    for _ in range(n):
        sample = list(SAMPLES)[rng.integers(0, 2)]
        counted = [s[rng.integers(0, 3)] for s in [BC1, BC2, BC3]]
        r = simulate.make_read(
            rng, scheme, sample, counted,
            flank_left=int(rng.integers(0, 8)),
            flank_right=int(rng.integers(0, 8)),
            n_errors=int(rng.integers(*err_range)),
        )
        reads.append(r)
        if quality_range:
            q = rng.integers(quality_range[0], quality_range[1], len(r)) + 33
            quals.append("".join(chr(int(x)) for x in q))
        else:
            quals.append("I" * len(r))
    path = tmp_path / (name + (".gz" if gz else ""))
    simulate.write_fastq(str(path), reads, quals, gzip_out=gz)
    return str(path), reads, quals


def assert_counts_equal(result, expected_per_sample, tallies):
    got = {k: dict(v) for k, v in result.results.per_sample.items()}
    assert got == expected_per_sample
    c = result.seq_errors.counters
    from ngs_barcode_count_tpu import stats as S

    assert c[S.MATCHED] == tallies["matched"]
    assert c[S.CONSTANT_REGION] == tallies["constant_region"]
    assert c[S.SAMPLE_BARCODE] == tallies["sample_barcode"]
    assert c[S.BARCODE] == tallies["barcode"]
    assert c[S.LOW_QUALITY] == tallies["low_quality"]
    assert c[S.DUPLICATES] == tallies["duplicates"]


def _mk_config(tmp_path, fq, paths, **kw):
    return RunConfig(
        fastq=fq,
        format=paths["format"],
        sample_barcodes_option=paths.get("samples"),
        counted_barcodes_option=paths.get("barcodes"),
        output_dir=str(tmp_path),
        prefix="test",
        batch_size=512,
        progress=False,
        **kw,
    )


def test_dense_mode_e2e(tmp_path, rng):
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 700, rng)
    cfg = _mk_config(tmp_path, fq, paths)
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert_counts_equal(result, exp, tallies)
    # CSV files written per sample
    for name in SAMPLES.values():
        assert (tmp_path / f"test_{name}_counts.csv").exists()
    assert (tmp_path / "test_barcode_stats.txt").exists()


def test_random_dedup_e2e(tmp_path, rng):
    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    # few distinct randoms so duplicates actually occur
    reads, quals = [], []
    randoms = ["ACGTACGT", "TTTTCCCC", "GGGGAAAA"]
    for _ in range(500):
        sample = list(SAMPLES)[rng.integers(0, 2)]
        counted = [s[rng.integers(0, 3)] for s in [BC1, BC2, BC3]]
        r = simulate.make_read(
            rng, scheme, sample, counted,
            random_barcode=randoms[rng.integers(0, 3)],
            flank_left=2, flank_right=3,
            n_errors=int(rng.integers(0, 4)),
        )
        reads.append(r)
        quals.append("I" * len(r))
    fq = tmp_path / "r.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    cfg = _mk_config(tmp_path, str(fq), paths)
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert tallies["duplicates"] > 0
    assert_counts_equal(result, exp, tallies)


def test_quality_and_gzip_e2e(tmp_path, rng):
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(
        tmp_path, scheme, 400, rng, gz=True, quality_range=(15, 41),
        name="q.fastq",
    )
    cfg = _mk_config(tmp_path, fq, paths, min_average_quality_score=30.0)
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert tallies["low_quality"] > 0
    assert_counts_equal(result, exp, tallies)


def test_raw_dna_mode_e2e(tmp_path, rng):
    """Config 1 of BASELINE.json: no conversion files, counts by raw DNA."""
    paths = write_inputs(tmp_path, with_files=False)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 300, rng, err_range=(0, 3))
    cfg = _mk_config(tmp_path, fq, paths)
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert_counts_equal(result, exp, tallies)


def test_sample_file_omitted_counted_present_e2e(tmp_path, rng):
    """Scheme HAS a sample region but only the counted file is given:
    sample keys are lazily inserted as raw DNA (info.rs:692-724
    sample_conversion_omited) while counted barcodes still
    error-correct against the dense candidate sets."""
    paths = write_inputs(tmp_path)
    del paths["samples"]
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 400, rng)
    cfg = _mk_config(tmp_path, fq, paths)
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert_counts_equal(result, exp, tallies)
    # keys are DNA sample barcodes, not IDs
    assert all(set(k) <= set("ACGTN") for k in result.results.per_sample)


def test_merged_and_enriched_output(tmp_path, rng):
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 300, rng, err_range=(0, 5))
    cfg = _mk_config(tmp_path, fq, paths, merge_output=True, enrich=True)
    result = run(cfg)
    assert (tmp_path / "test_counts.all.csv").exists()
    for name in SAMPLES.values():
        assert (tmp_path / f"test_{name}_counts.Single.csv").exists()
        assert (tmp_path / f"test_{name}_counts.Double.csv").exists()
    assert (tmp_path / "test_counts.all.Single.csv").exists()
    # merged file row counts: header + one row per distinct combo
    merged = (tmp_path / "test_counts.all.csv").read_text().splitlines()
    distinct = set()
    for s in result.results.per_sample.values():
        distinct.update(s.keys())
    assert len(merged) == 1 + len(distinct)
    # merged columns: Barcode_1..3 + 2 samples
    assert merged[0] == "Barcode_1,Barcode_2,Barcode_3,Sample_name_1,Sample_name_2"
    # single-enrichment row sums: each sample's single counts total
    # barcode_num * matched-for-that-sample
    single = (tmp_path / "test_counts.all.Single.csv").read_text().splitlines()
    assert single[0] == "Barcode_1,Barcode_2,Barcode_3,Sample_name_1,Sample_name_2"


def test_csv_content_parity_with_oracle(tmp_path, rng):
    """Sample CSV contents match an oracle-computed golden exactly."""
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 500, rng)
    cfg = _mk_config(tmp_path, fq, paths)
    result = run(cfg)
    exp, _ = oracle_counts(cfg, reads, quals)
    # golden CSV for sample 1, sorted rows, converted ids
    sb = [b for b, n in SAMPLES.items() if n == "Sample_name_1"][0]
    id_of = {}
    for pos, bcs in enumerate([BC1, BC2, BC3]):
        for j, b in enumerate(bcs):
            id_of[(pos, b)] = f"BC{pos + 1}_{j}"
    rows = []
    for code in sorted(exp[sb]):
        conv = ",".join(
            id_of[(i, b)] for i, b in enumerate(code.split(","))
        )
        rows.append(f"{conv},{exp[sb][code]}")
    golden = "Barcode_1,Barcode_2,Barcode_3,Count\n" + "\n".join(rows) + "\n"
    written = (tmp_path / "test_Sample_name_1_counts.csv").read_text()
    assert written == golden


def test_random_plus_quality_e2e(tmp_path, rng):
    """Random dedup + quality gate together (keyed wire path with Phred
    lanes shipped)."""
    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    reads, quals = [], []
    randoms = ["ACGTACGT", "TTTTCCCC"]
    for _ in range(400):
        sample = list(SAMPLES)[rng.integers(0, 2)]
        counted = [s[rng.integers(0, 3)] for s in [BC1, BC2, BC3]]
        r = simulate.make_read(
            rng, scheme, sample, counted,
            random_barcode=randoms[rng.integers(0, 2)],
            flank_left=2, flank_right=3,
            n_errors=int(rng.integers(0, 4)),
        )
        reads.append(r)
        q = rng.integers(25, 41, len(r)) + 33
        quals.append("".join(chr(int(x)) for x in q))
    fq = tmp_path / "rq.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    cfg = _mk_config(tmp_path, str(fq), paths,
                     min_average_quality_score=30.0)
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert tallies["low_quality"] > 0 and tallies["duplicates"] > 0
    assert_counts_equal(result, exp, tallies)


def test_random_bitmap_mode_engaged(tmp_path, rng):
    """The fully-device dedup bytemap engages for dense random schemes and
    its counts equal the host keyed/dedup path."""
    from ngs_barcode_count_tpu.runner import CountAccumulator, decode_file

    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    reads, quals = [], []
    randoms = ["ACGTACGT", "TTTTCCCC", "GGGGAAAA"]
    for _ in range(300):
        sample = list(SAMPLES)[rng.integers(0, 2)]
        counted = [s[rng.integers(0, 3)] for s in [BC1, BC2, BC3]]
        r = simulate.make_read(rng, scheme, sample, counted,
                               random_barcode=randoms[rng.integers(0, 3)],
                               flank_left=2, flank_right=3)
        reads.append(r)
        quals.append("I" * len(r))
    fq = tmp_path / "bm.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    cfg = _mk_config(tmp_path, str(fq), paths)
    cfg.batch_size = 128
    scheme, conv, me, plan, _ = setup(cfg)

    acc_bm = CountAccumulator(plan, conv)
    assert acc_bm.bitmap is not None  # bytemap mode engaged
    decode_file(cfg, plan, scheme, acc_bm)
    acc_bm.finalize()

    acc_host = CountAccumulator(plan, conv, allow_bitmap=False)
    assert acc_host.bitmap is None and acc_host.dedup is not None
    decode_file(cfg, plan, scheme, acc_host)
    acc_host.finalize()

    np.testing.assert_array_equal(
        acc_bm.seq_errors.counters, acc_host.seq_errors.counters
    )
    assert acc_bm.results_view().per_sample == acc_host.results_view().per_sample


def test_empty_fastq_run(tmp_path):
    paths = write_inputs(tmp_path)
    fq = tmp_path / "empty.fastq"
    fq.write_text("")
    cfg = _mk_config(tmp_path, str(fq), paths)
    result = run(cfg)
    assert result.total_reads == 0
    # pre-seeded samples still get header-only CSVs (Results::new parity)
    for name in SAMPLES.values():
        assert (tmp_path / f"test_{name}_counts.csv").read_text() == (
            "Barcode_1,Barcode_2,Barcode_3,Count\n"
        )


def test_mixed_read_lengths_e2e(tmp_path, rng):
    """Heterogeneous read lengths (width bucket growth mid-run)."""
    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    reads, quals = [], []
    for i in range(400):
        # late reads much longer: forces a width regrowth after batches
        fl = int(rng.integers(0, 6)) + (60 if i > 300 else 0)
        sample = list(SAMPLES)[rng.integers(0, 2)]
        counted = [s[rng.integers(0, 3)] for s in [BC1, BC2, BC3]]
        r = simulate.make_read(rng, scheme, sample, counted,
                               flank_left=fl,
                               flank_right=int(rng.integers(0, 6)),
                               n_errors=int(rng.integers(0, 6)))
        reads.append(r)
        quals.append("I" * len(r))
    fq = tmp_path / "mixed.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    cfg = _mk_config(tmp_path, str(fq), paths)
    cfg.batch_size = 64
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert_counts_equal(result, exp, tallies)


def test_barseq_long_raw_barcode(tmp_path, rng):
    """Bar-seq use case (reference README 'Uses'): a 30nt lineage barcode
    counted by raw DNA — too long for reversible 3-bit packing, so keys
    intern through the host table."""
    fmt = tmp_path / "scheme.txt"
    fmt.write_text("ACGTACGTAGCT\n{30}\nTTGGAACC\n")
    paths = {"format": str(fmt)}
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    lineages = [simulate.random_seq(np.random.default_rng(s), 30)
                for s in range(12)]
    reads, quals = [], []
    for _ in range(300):
        r = simulate.make_read(
            rng, scheme, None, [lineages[rng.integers(0, 12)]],
            flank_left=int(rng.integers(0, 5)),
            flank_right=int(rng.integers(0, 5)),
        )
        reads.append(r)
        quals.append("I" * len(r))
    fq = tmp_path / "barseq.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    cfg = _mk_config(tmp_path, str(fq), paths)
    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert_counts_equal(result, exp, tallies)
    assert sum(result.results.per_sample["barcode"].values()) == tallies[
        "matched"
    ]
    # every counted key is a full 30nt sequence
    assert all(
        len(k) == 30 for k in result.results.per_sample["barcode"]
    )



def test_device_hashset_dedup_equals_host_keyed(tmp_path, rng, monkeypatch):
    """The device hash-set dedup (big-combo random mode) must match the
    host keyed+dedup path exactly — including with a tiny table that
    forces probe chains and host overflow handling."""
    from tests.test_end_to_end import (
        SCHEME_RANDOM_TEXT, gen_fastq, write_inputs, _mk_config,
    )
    from ngs_barcode_count_tpu.runner import (
        CountAccumulator, decode_file, setup,
    )

    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    # few distinct randoms -> plenty of true PCR duplicates
    fq = tmp_path / "r.fastq"
    reads, quals = [], []
    randoms = ["ACGTACGT", "TTGGCCAA", "AAAATTTT", "CGCGCGCG"]
    from tests.test_end_to_end import SAMPLES, BC1, BC2, BC3
    for _ in range(900):
        r = simulate.make_read(
            rng, scheme, list(SAMPLES)[rng.integers(0, 2)],
            [s[rng.integers(0, 3)] for s in (BC1, BC2, BC3)],
            random_barcode=randoms[rng.integers(0, len(randoms))],
            flank_left=int(rng.integers(0, 6)),
            flank_right=int(rng.integers(0, 6)),
            n_errors=int(rng.integers(0, 6)),
        )
        reads.append(r)
        quals.append("I" * len(r))
    simulate.write_fastq(str(fq), reads, quals)
    cfg = _mk_config(tmp_path, str(fq), paths)
    cfg.batch_size = 128
    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")
    # 64-slot table: probing and overflow both fire constantly
    monkeypatch.setenv("NGS_DEDUP_TABLE_SLOTS", "64")
    scheme, conv, me, plan, _ = setup(cfg)

    acc_dev = CountAccumulator(plan, conv)
    assert acc_dev.hashset is not None
    n_dev = decode_file(cfg, plan, scheme, acc_dev)
    acc_dev.finalize()

    acc_host = CountAccumulator(plan, conv, allow_bitmap=False)
    assert acc_host.keyed is not None and acc_host.dedup is not None
    n_host = decode_file(cfg, plan, scheme, acc_host)
    acc_host.finalize()

    assert n_dev == n_host == 900
    np.testing.assert_array_equal(
        acc_dev.seq_errors.counters, acc_host.seq_errors.counters
    )
    assert acc_dev.results_view().per_sample == \
        acc_host.results_view().per_sample


@pytest.mark.parametrize("bucket_cap", [None, "3"])
def test_sharded_hashset_dedup_equals_single(tmp_path, rng, monkeypatch,
                                             bucket_cap):
    """Multi-device random mode: the table shards over the data mesh and
    triples route to owner devices via all_to_all; counts must equal the
    single-device hash set and the host keyed path exactly — including
    with a tiny table (probe overflow) and a tiny all_to_all bucket cap
    (bucket overflow)."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from ngs_barcode_count_tpu.runner import (
        CountAccumulator, decode_file, setup,
    )

    paths = write_inputs(tmp_path, scheme_text=SCHEME_RANDOM_TEXT)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 800, rng)
    cfg = _mk_config(tmp_path, fq, paths)
    cfg.batch_size = 128
    monkeypatch.setenv("NGS_BITMAP_LIMIT_BYTES", "1")
    monkeypatch.setenv("NGS_DEDUP_TABLE_SLOTS", "64")
    if bucket_cap:
        monkeypatch.setenv("NGS_DEDUP_BUCKET_CAP", bucket_cap)
    scheme, conv, me, plan, _ = setup(cfg)

    acc1 = CountAccumulator(plan, conv)
    assert acc1.hashset is not None
    n1 = decode_file(cfg, plan, scheme, acc1)
    acc1.finalize()

    acc4 = CountAccumulator(plan, conv, n_devices=4)
    assert acc4.hashset_engine is not None
    n4 = decode_file(cfg, plan, scheme, acc4, n_devices=4)
    acc4.finalize()

    assert n1 == n4 == 800
    np.testing.assert_array_equal(
        acc1.seq_errors.counters, acc4.seq_errors.counters
    )
    np.testing.assert_array_equal(
        np.asarray(acc1.dense_state), np.asarray(acc4.dense_state)
    )
    assert acc1.results_view().per_sample == acc4.results_view().per_sample


def test_mega_combo_space_demotes_to_keyed(tmp_path, rng):
    """Combo spaces whose mixed-radix id overflows int32 (mega-DEL:
    3 x 2000-candidate positions = 8e9 combos) must decode through the
    keyed path with per-position index wire columns and still match the
    oracle exactly — the reference's sparse hashmap has no size limit,
    so neither may we."""
    from ngs_barcode_count_tpu.ops import decode as dec

    paths = write_inputs(tmp_path, with_files=False)
    # 2000 distinct 6-mers per position (4096 possible)
    big = []
    for pos in range(3):
        seen = set()
        while len(seen) < 2000:
            seen.add("".join(
                "ACGT"[i] for i in rng.integers(0, 4, 6)
            ))
        big.append(sorted(seen))
    cf = tmp_path / "barcodes_big.csv"
    rows = []
    for pos, bcs in enumerate(big, start=1):
        for j, b in enumerate(bcs):
            rows.append(f"{b},BC{pos}_{j},{pos}\n")
    cf.write_text("Barcode,Barcode_ID,Barcode_Number\n" + "".join(rows))
    sf = tmp_path / "samples.csv"
    sf.write_text(
        "Barcode,Sample_ID\n"
        + "".join(f"{b},{i}\n" for b, i in SAMPLES.items())
    )
    paths["samples"] = str(sf)
    paths["barcodes"] = str(cf)

    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    reads, quals = [], []
    for _ in range(300):
        sample = list(SAMPLES)[rng.integers(0, 2)]
        counted = [s[rng.integers(0, 2000)] for s in big]
        r = simulate.make_read(
            rng, scheme, sample, counted,
            flank_left=int(rng.integers(0, 6)),
            flank_right=int(rng.integers(0, 6)),
            n_errors=int(rng.integers(0, 5)),
        )
        reads.append(r)
        quals.append("I" * len(r))
    fq = tmp_path / "mega.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    cfg = _mk_config(tmp_path, str(fq), paths)
    scheme2, conv, me, plan, _ = setup(cfg)
    assert plan.dense_counted and not plan.combo_fits_i32
    assert not plan.dense_counts  # demoted off the dense tensor
    layout = dec.keyed_wire_layout(plan)
    assert "counted_idx" in layout and "combo_flat" not in layout

    result = run(cfg)
    exp, tallies = oracle_counts(cfg, reads, quals)
    assert_counts_equal(result, exp, tallies)


def test_mega_combo_pallas_keyed_wire_parity(tmp_path, rng):
    """The packed keyed step's counted_idx wire columns (native wire
    input) must equal the unpacked decode's on a mega-combo plan."""
    import jax

    from ngs_barcode_count_tpu.conversions import (
        BarcodeConversions, BarcodeSet,
    )
    from ngs_barcode_count_tpu.errors import MaxSeqErrors
    from ngs_barcode_count_tpu.ops import decode as dec
    from tests.test_decode_vs_oracle import encode_batch

    paths = write_inputs(tmp_path, with_files=False)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    big = []
    for pos in range(3):
        seen = set()
        while len(seen) < 1300:  # 1300^3 > 2^31
            seen.add("".join("ACGT"[i] for i in rng.integers(0, 4, 6)))
        big.append(sorted(seen))
    conv = BarcodeConversions()
    conv.samples_barcode_hash = {b: i for b, i in SAMPLES.items()}
    conv.sample_set = BarcodeSet.from_pairs(
        [(b, i) for b, i in SAMPLES.items()], 10
    )
    conv.counted_barcodes_hash = [
        {b: f"B{i}_{j}" for j, b in enumerate(s)}
        for i, s in enumerate(big)
    ]
    conv.counted_sets = [
        BarcodeSet.from_pairs(
            [(b, f"B{i}_{j}") for j, b in enumerate(s)], 6
        )
        for i, s in enumerate(big)
    ]
    me = MaxSeqErrors.create(
        None, 10, None, [6, 6, 6], None, scheme.constant_region_length, 0.0
    )
    plan = dec.make_plan(scheme, conv, me)
    assert not plan.combo_fits_i32

    reads, quals = [], []
    for _ in range(64):
        r = simulate.make_read(
            rng, scheme, list(SAMPLES)[rng.integers(0, 2)],
            [s[rng.integers(0, 1300)] for s in big],
            flank_left=int(rng.integers(0, 6)),
            flank_right=int(rng.integers(0, 6)),
            n_errors=int(rng.integers(0, 4)),
        )
        reads.append(r)
        quals.append("I" * len(r))
    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )

    fq = tmp_path / "mega_wire.fastq"
    simulate.write_fastq(str(fq), reads, quals)
    pb = next(iter(read_fastq_packed_parallel(
        str(fq), min_width=scheme.length, batch_reads=128,
    )))
    if getattr(pb, "transposed", False):
        pb.packed = np.ascontiguousarray(pb.packed.T)
        pb.transposed = False
    n = np.array([pb.n_reads], np.int32)
    wire_p = np.asarray(dec.keyed_decode_step_packed(
        plan, pb.packed, pb.lengths, pb.exc_idx, pb.exc_val, pb.width, n,
    )["wire"])[: len(reads)]
    bases, quality, lengths, mask = encode_batch(reads, quals)
    out_x = dec.keyed_decode_step(plan, bases, quality, lengths, mask)
    from ngs_barcode_count_tpu.ops.decode import _keyed_packed_outputs

    compact = jax.jit(lambda: _keyed_packed_outputs(plan, out_x))()
    valid = np.asarray(out_x["valid"])
    np.testing.assert_array_equal(
        wire_p[valid], np.asarray(compact["wire"])[valid]
    )
    assert valid.sum() > 0
