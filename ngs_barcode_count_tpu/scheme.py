"""Scheme (sequence-format) DSL compiler.

The reference parses its format file into a regex with named capture groups
and searches every read with it (reference info.rs:215-310, parse.rs:92).
There is no regex on an accelerator; instead the scheme compiles to static
tensors:

- ``fmt_codes  [F] int8`` — the format as base codes: constants are
  A/C/G/T, every barcode position and explicit ``N`` is the N wildcard.
- ``kind       [F] int8`` — per-position region kind (const / wildcard /
  sample / counted / random), the tensor form of the reference's
  ``regions_string`` plus explicit-N tracking.
- slot offset/length tables for the sample barcode, each counted barcode,
  and the random barcode.

The decode step then evaluates "does the regex match at offset o" for all
offsets of all reads at once as masked integer compares (see ops/decode.py).

Grammar (reference README.md:56-66, info.rs:232):
  ``[n]`` sample barcode (0-1), ``{n}`` counted barcode (1+),
  ``(n)`` random barcode (0-1), ``ACGT`` constants, ``N`` any-base
  wildcard; lines starting with ``#`` are comments.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ngs_barcode_count_tpu import dna

KIND_CONST = 0
KIND_WILD = 1  # explicit N in the scheme: matches A/C/G/T only (regex [AGCT])
KIND_SAMPLE = 2
KIND_BARCODE = 3
KIND_RANDOM = 4

# Token syntax identical to the reference's barcode_search regex
# (info.rs:232): counted {n} | sample [n] | random (n) | N-runs | constants.
_TOKEN_RE = re.compile(r"(\{\d+\})|(\[\d+\])|(\(\d+\))|N+|[ATGC]+", re.IGNORECASE)
_DIGITS_RE = re.compile(r"\d+")


@dataclass(frozen=True)
class Slot:
    """A variable region of the scheme: where it sits and how long it is."""

    kind: int  # KIND_SAMPLE / KIND_BARCODE / KIND_RANDOM
    index: int  # 0-based counted-barcode number (0 for sample/random)
    offset: int  # offset within the format
    length: int


@dataclass
class SequenceScheme:
    """Compiled scheme: everything the decode kernels need, all static.

    Mirrors the reference's ``SequenceFormat`` fields (info.rs:176-187) but
    holds tensor metadata instead of a regex.
    """

    format_string: str
    regions_string: str  # S/B/C/R codes, constants included, N-runs EXCLUDED
    fmt_codes: np.ndarray  # [F] int8 base codes (N for slots + wildcards)
    kind: np.ndarray  # [F] int8 KIND_*
    length: int
    constant_region_length: int
    barcode_num: int
    barcode_lengths: list[int] = field(default_factory=list)
    sample_slot: Slot | None = None
    random_slot: Slot | None = None
    barcode_slots: list[Slot] = field(default_factory=list)

    @property
    def sample_barcode(self) -> bool:
        return self.sample_slot is not None

    @property
    def random_barcode(self) -> bool:
        return self.random_slot is not None

    @property
    def sample_length(self) -> int | None:
        return self.sample_slot.length if self.sample_slot else None

    def display(self) -> str:
        """The "-FORMAT-" block, identical to the reference's Display impl
        (info.rs:313-335): format string, region codes, then a key listing
        each region code in first-appearance order."""
        key = ""
        seen: set[str] = set()
        names = {
            "S": "\nS: Sample barcode",
            "B": "\nB: Counted barcode",
            "C": "\nC: Constant region",
            "R": "\nR: Random barcode",
        }
        for ch in self.regions_string:
            if ch not in seen:
                seen.add(ch)
                key += names.get(ch, "")
        return f"-FORMAT-\n{self.format_string}\n{self.regions_string}{key}"


def parse_scheme_text(format_data: str) -> SequenceScheme:
    """Compile scheme text (comment lines already allowed) to a SequenceScheme."""
    # The reference concatenates non-comment lines with no separator
    # (info.rs:218-222).
    data = "".join(
        line for line in format_data.splitlines() if not line.startswith("#")
    )

    format_string = ""
    regions_string = ""
    kinds: list[int] = []
    codes: list[int] = []
    barcode_num = 0
    barcode_lengths: list[int] = []
    sample_slot: Slot | None = None
    random_slot: Slot | None = None
    barcode_slots: list[Slot] = []
    constant_region_length = 0

    for m in _TOKEN_RE.finditer(data):
        tok = m.group(0)
        offset = len(format_string)
        if tok.startswith("["):
            if sample_slot is not None:
                raise ValueError("scheme contains more than one sample barcode [n]")
            n = int(_DIGITS_RE.search(tok).group(0))
            sample_slot = Slot(KIND_SAMPLE, 0, offset, n)
            format_string += "N" * n
            regions_string += "S" * n
            kinds += [KIND_SAMPLE] * n
            codes += [dna.N] * n
        elif tok.startswith("{"):
            n = int(_DIGITS_RE.search(tok).group(0))
            barcode_slots.append(Slot(KIND_BARCODE, barcode_num, offset, n))
            barcode_num += 1
            barcode_lengths.append(n)
            format_string += "N" * n
            regions_string += "B" * n
            kinds += [KIND_BARCODE] * n
            codes += [dna.N] * n
        elif tok.startswith("("):
            if random_slot is not None:
                raise ValueError("scheme contains more than one random barcode (n)")
            n = int(_DIGITS_RE.search(tok).group(0))
            random_slot = Slot(KIND_RANDOM, 0, offset, n)
            format_string += "N" * n
            regions_string += "R" * n
            kinds += [KIND_RANDOM] * n
            codes += [dna.N] * n
        elif "N" in tok.upper():
            # Explicit N run: wildcard bases; regex side is [AGCT]{n}, and
            # the reference does NOT extend regions_string here
            # (info.rs:287-295) — we reproduce that for quality parity.
            n = len(tok)
            format_string += tok.upper()
            kinds += [KIND_WILD] * n
            codes += [dna.N] * n
        else:
            up = tok.upper()
            n = len(up)
            format_string += up
            regions_string += "C" * n
            kinds += [KIND_CONST] * n
            codes += [dna.ASCII_TO_CODE[ord(ch)] for ch in up]
            constant_region_length += n

    if barcode_num == 0:
        raise ValueError("scheme must contain at least one counted barcode {n}")

    return SequenceScheme(
        format_string=format_string,
        regions_string=regions_string,
        fmt_codes=np.array(codes, dtype=np.int8),
        kind=np.array(kinds, dtype=np.int8),
        length=len(format_string),
        constant_region_length=constant_region_length,
        barcode_num=barcode_num,
        barcode_lengths=barcode_lengths,
        sample_slot=sample_slot,
        random_slot=random_slot,
        barcode_slots=barcode_slots,
    )


def parse_scheme(path: str) -> SequenceScheme:
    """Compile a scheme file (the reference's ``--sequence-format`` input)."""
    with open(path, "r", encoding="utf-8") as f:
        return parse_scheme_text(f.read())
