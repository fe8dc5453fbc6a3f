"""Barcode conversion tables: CSV files -> one-hot match matrices.

The reference loads two CSVs into hashmaps and hashsets
(info.rs:338-457); we additionally compile each position's barcode set
into an int8 one-hot matrix ``[n_codes, len*4]`` so that error-tolerant
matching is a single matmul against a batch of extracted slots
(replacing the per-read ``fix_error`` scan, parse.rs:553-593).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ngs_barcode_count_tpu import dna


def _read_csv_rows(path: str, ncols: int) -> list[tuple[str, ...]]:
    """First ``ncols`` comma-separated fields of each line, header skipped —
    the reference's split/take pattern (info.rs:364-381, 390-407).  Rows
    with fewer than ``ncols`` fields become empty tuples like the
    reference's ``unwrap_or`` of empty strings."""
    rows: list[tuple[str, ...]] = []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    for line in lines[1:]:
        parts = line.split(",")[:ncols]
        if len(parts) < ncols:
            parts = [""] * ncols
        rows.append(tuple(parts))
    return rows


@dataclass
class BarcodeSet:
    """One position's known barcodes, in insertion order, plus the compiled
    one-hot matrix used by the Hamming-argmin matcher."""

    sequences: list[str]
    ids: list[str]
    length: int
    onehot: np.ndarray  # [n_codes, length*4] int8, N rows are all-ones
    has_n: bool  # any candidate contains N (needs matmul correction)
    n_mask: np.ndarray  # [n_codes, length] int8, 1 where candidate is N

    @classmethod
    def from_pairs(cls, pairs: list[tuple[str, str]], length: int) -> "BarcodeSet":
        seqs = [s for s, _ in pairs]
        ids = [i for _, i in pairs]
        # A wrong-length barcode is a malformed conversion file: padding or
        # truncating it silently would make it unmatchable (the reference's
        # fix_error zip-compares over the shorter length and can still
        # match, so the two implementations would diverge quietly).
        for s in seqs:
            if len(s) != length:
                raise ValueError(
                    f"conversion-file barcode '{s}' is {len(s)}nt but the "
                    f"scheme slot is {length}nt"
                )
        codes = (
            np.stack([dna.encode(s) for s in seqs])
            if seqs
            else np.zeros((0, length), dtype=np.int8)
        )
        onehot = dna.onehot_match(codes).reshape(len(seqs), length * 4)
        n_mask = (codes == dna.N).astype(np.int8)
        return cls(
            sequences=seqs,
            ids=ids,
            length=length,
            onehot=onehot,
            has_n=bool(n_mask.any()),
            n_mask=n_mask,
        )

    @property
    def count(self) -> int:
        return len(self.sequences)


@dataclass
class BarcodeConversions:
    """Loaded conversion tables (reference ``BarcodeConversions``,
    info.rs:338-343) plus compiled match matrices per counted-barcode
    position and for the sample barcode."""

    samples_barcode_hash: dict[str, str] = field(default_factory=dict)
    counted_barcodes_hash: list[dict[str, str]] = field(default_factory=list)
    sample_set: BarcodeSet | None = None
    counted_sets: list[BarcodeSet] = field(default_factory=list)

    def load_sample_file(self, path: str, sample_length: int) -> None:
        """Sample CSV: barcode,sample_ID (info.rs:364-381). Later duplicate
        barcodes overwrite earlier ones, as in a hashmap insert."""
        for barcode, sample_id in _read_csv_rows(path, 2):
            self.samples_barcode_hash[barcode] = sample_id
        pairs = list(self.samples_barcode_hash.items())
        self.sample_set = BarcodeSet.from_pairs(pairs, sample_length)

    def load_counted_file(
        self, path: str, barcode_num: int, barcode_lengths: list[int]
    ) -> None:
        """Counted CSV: barcode,ID,barcode_number(1-based). Validates every
        position 1..barcode_num is present, raising with the missing list
        like the reference (info.rs:420-431)."""
        self.counted_barcodes_hash = [dict() for _ in range(barcode_num)]
        seen: set[int] = set()
        for barcode, bc_id, num in _read_csv_rows(path, 3):
            try:
                pos = int(num) - 1
            except ValueError as e:
                raise ValueError(
                    "Third column of barcode file contains something other "
                    f"than an integer: {num}"
                ) from e
            seen.add(pos)
            self.counted_barcodes_hash[pos][barcode] = bc_id
        missing = [x for x in range(barcode_num) if x not in seen]
        if missing:
            raise ValueError(
                f"Barcode conversion file missing barcode numers {missing} "
                "in the third column"
            )
        self.counted_sets = [
            BarcodeSet.from_pairs(list(h.items()), barcode_lengths[i])
            for i, h in enumerate(self.counted_barcodes_hash)
        ]

    @property
    def has_sample_file(self) -> bool:
        return bool(self.samples_barcode_hash)

    @property
    def has_counted_file(self) -> bool:
        return bool(self.counted_barcodes_hash)
