"""Pure-Python oracle implementing the reference's per-read semantics.

This is the test harness the reference never had (SURVEY.md section 4): a
direct, string-based re-statement of barcode-count's decode logic
(parse.rs) used to validate the vectorized device path on synthetic FASTQs.
It deliberately reproduces the reference's quirks:

- regex search is leftmost-match, constants exact, explicit scheme-Ns are
  ``[AGCT]``, slots ``.{n}`` (info.rs:232-308);
- repair windows iterate offsets ``0..len-F`` EXCLUSIVE (parse.rs:295);
- fix_error tie at best distance => drop (parse.rs:577-592);
- repaired reads re-run the regex on the rebuilt sequence, and quality is
  then read from position 0 (parse.rs:98-119);
- the final non-constant region is never quality-checked (parse.rs:331-375).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ngs_barcode_count_tpu.errors import MaxSeqErrors
from ngs_barcode_count_tpu.scheme import (
    KIND_BARCODE,
    KIND_CONST,
    KIND_RANDOM,
    KIND_SAMPLE,
    KIND_WILD,
    SequenceScheme,
)


def build_regex(scheme: SequenceScheme) -> re.Pattern:
    """Rebuild the reference's regex from the compiled scheme."""
    parts = []
    p = 0
    F = scheme.length
    while p < F:
        k = scheme.kind[p]
        j = p
        while j < F and scheme.kind[j] == k:
            j += 1
        n = j - p
        if k == KIND_CONST:
            parts.append(re.escape(scheme.format_string[p:j]))
        elif k == KIND_WILD:
            parts.append("[AGCT]{%d}" % n)
        elif k == KIND_SAMPLE:
            parts.append("(?P<sample>.{%d})" % n)
        elif k == KIND_RANDOM:
            parts.append("(?P<random>.{%d})" % n)
        elif k == KIND_BARCODE:
            # consecutive different barcodes share the kind; split by slot
            for slot in scheme.barcode_slots:
                if slot.offset == p:
                    parts.append("(?P<barcode%d>.{%d})" % (slot.index + 1, slot.length))
                    j = p + slot.length
                    break
        p = j
    return re.compile("".join(parts))


def fix_error(mismatch_seq: str, possible_seqs, mismatches: int) -> str | None:
    """Literal restatement of parse.rs:553-593."""
    best_match = None
    best_mismatch_count = mismatches + 1
    keep = True
    for true_seq in possible_seqs:
        m = 0
        for pc, cc in zip(true_seq, mismatch_seq):
            if pc != cc and cc != "N" and pc != "N":
                m += 1
            if m > best_mismatch_count:
                break
        if m == best_mismatch_count:
            keep = False
        if m < best_mismatch_count:
            keep = True
            best_mismatch_count = m
            best_match = true_seq
    return best_match if keep and best_match is not None else None


def fix_constant_region(
    sequence: str, format_string: str, max_constant_errors: int,
    fix_quirks: bool = False,
) -> tuple[str, int]:
    """parse.rs:287-313: window scan + rebuild; returns (rebuilt sequence
    or "", window offset or -1).  fix_quirks includes the final alignment
    the reference's exclusive range skips."""
    length_diff = len(sequence) - len(format_string)
    stop = length_diff + 1 if fix_quirks else length_diff
    possible = [
        sequence[i : i + len(format_string)] for i in range(stop)
    ]
    best = fix_error(format_string, possible, max_constant_errors)
    if best is None:
        return "", -1
    offset = possible.index(best)
    rebuilt = "".join(
        oc if fc == "N" else fc for oc, fc in zip(best, format_string)
    )
    return rebuilt, offset


def low_quality(
    quality_values: str, min_average: float, regions_string: str, start: int
) -> bool:
    """parse.rs:331-375 verbatim, including the unflushed final run."""
    scores = [ord(ch) - 33 for ch in quality_values]
    acc: list[float] = []
    previous = "\0"
    for score, seq_type in zip(scores[start:], regions_string):
        if seq_type != previous:
            if acc:
                if sum(acc) / len(acc) < min_average:
                    return True
                acc = []
            previous = seq_type
            if seq_type != "C":
                acc = [float(score)]
        else:
            if seq_type != "C":
                acc.append(float(score))
    return False


@dataclass
class OracleResult:
    outcome: str  # matched / constant_region / sample_barcode / barcode / low_quality
    sample_barcode: str = ""
    counted_barcodes: tuple[str, ...] = ()
    random_barcode: str | None = None


class Oracle:
    """Per-read decoder with reference semantics; used by tests and by the
    runner's ``--engine oracle`` debug mode."""

    def __init__(
        self,
        scheme: SequenceScheme,
        max_errors: MaxSeqErrors,
        sample_seqs: list[str],
        counted_barcode_seqs: list[list[str]],
        min_quality: float = 0.0,
        fix_quirks: bool = False,
    ):
        self.scheme = scheme
        self.max_errors = max_errors
        self.regex = build_regex(scheme)
        self.sample_seqs = list(sample_seqs)
        self.counted_barcode_seqs = [list(s) for s in counted_barcode_seqs]
        self.min_quality = min_quality
        self.fix_quirks = fix_quirks

    def _low_quality_fixed(self, quality: str, qual_start: int) -> bool:
        """--fix-quirks quality: every barcode region checked (including a
        trailing one) at true format offsets from the matched window."""
        from ngs_barcode_count_tpu.ops.decode import quality_segments_fixed

        for seg in quality_segments_fixed(self.scheme):
            scores = [
                ord(ch) - 33
                for ch in quality[
                    qual_start + seg.start : qual_start + seg.start + seg.length
                ]
            ]
            if scores and sum(scores) / len(scores) < self.min_quality:
                return True
        return False

    def decode(self, sequence: str, quality: str) -> OracleResult:
        scheme = self.scheme
        m = self.regex.search(sequence)
        qual_start = m.start() if m is not None else 0
        if m is None:
            if len(sequence) < scheme.length:
                # reference would panic on usize underflow; we drop as a
                # constant-region error (documented divergence).
                return OracleResult("constant_region")
            sequence, rep_off = fix_constant_region(
                sequence, scheme.format_string,
                self.max_errors.constant_region, self.fix_quirks,
            )
            m = self.regex.search(sequence)
            if m is None:
                return OracleResult("constant_region")
            # reference quirk: rebuilt sequence starts at 0, so quality
            # reads from 0; --fix-quirks uses the true window offset
            qual_start = rep_off if self.fix_quirks else m.start()

        if self.min_quality > 0.0:
            if self.fix_quirks:
                if self._low_quality_fixed(quality, qual_start):
                    return OracleResult("low_quality")
            elif low_quality(
                quality, self.min_quality, scheme.regions_string, qual_start
            ):
                return OracleResult("low_quality")

        # sample barcode (parse.rs:449-474)
        sample_barcode = "barcode"
        if scheme.sample_barcode:
            s = m.group("sample")
            if not self.sample_seqs:
                sample_barcode = s
            elif s in self.sample_seqs:
                sample_barcode = s
            else:
                fixed = fix_error(
                    s, self.sample_seqs, self.max_errors.sample_barcode
                )
                if fixed is None:
                    return OracleResult("sample_barcode")
                sample_barcode = fixed

        # counted barcodes (parse.rs:477-507)
        counted: list[str] = []
        for i in range(scheme.barcode_num):
            bc = m.group(f"barcode{i + 1}")
            if self.counted_barcode_seqs:
                if bc not in self.counted_barcode_seqs[i]:
                    fixed = fix_error(
                        bc,
                        self.counted_barcode_seqs[i],
                        self.max_errors.barcode[i],
                    )
                    if fixed is None:
                        return OracleResult("barcode")
                    bc = fixed
            counted.append(bc)

        random_barcode = m.group("random") if scheme.random_barcode else None
        return OracleResult(
            "matched", sample_barcode, tuple(counted), random_barcode
        )


def oracle_counts(config, reads: list[str], quals: list[str]):
    """Aggregate a run's counts the reference way, read by read through
    the Oracle: returns ({sample DNA: {comma-joined barcode DNA: count}},
    {outcome: count} incl. PCR ``duplicates``) for a runner.RunConfig."""
    from ngs_barcode_count_tpu.runner import setup

    scheme, conv, max_errors, plan, enrich = setup(config)
    oracle = Oracle(
        scheme, max_errors,
        list(conv.samples_barcode_hash.keys()),
        [s.sequences for s in conv.counted_sets],
        max_errors.min_quality,
    )
    per_sample: dict[str, dict[str, int]] = {}
    if conv.has_sample_file:
        for sb in conv.samples_barcode_hash:
            per_sample[sb] = {}
    elif scheme.sample_slot is None:
        per_sample["barcode"] = {}
    seen_random = set()
    tallies = dict(matched=0, constant_region=0, sample_barcode=0,
                   barcode=0, low_quality=0, duplicates=0)
    for r, q in zip(reads, quals):
        o = oracle.decode(r, q)
        if o.outcome != "matched":
            tallies[o.outcome] += 1
            continue
        code = ",".join(o.counted_barcodes)
        if scheme.random_barcode:
            key = (o.sample_barcode, code, o.random_barcode)
            if key in seen_random:
                tallies["duplicates"] += 1
                continue
            seen_random.add(key)
        tallies["matched"] += 1
        per_sample.setdefault(o.sample_barcode, {})
        per_sample[o.sample_barcode][code] = (
            per_sample[o.sample_barcode].get(code, 0) + 1
        )
    return per_sample, tallies
