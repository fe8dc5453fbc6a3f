"""The batched decode step: the core decode engine, plain JAX compiled by XLA.

This replaces the reference's entire per-read hot path (SequenceParser,
parse.rs:53-163 + fix_error parse.rs:553-593) with one jitted function over
a ``[B, L]`` batch of reads:

1.  **Offset scan** — the reference regex-searches each read for the format
    (constants exact, explicit-N runs ``[AGCT]``, barcode slots ``.{n}``;
    parse.rs:92).  Here ONE matmul of the c-major one-hot read tensor
    against a precomputed scan matrix yields, for every alignment offset
    at once: strict constant matches, N-wildcard-relaxed constant
    matches, and wild-position ACGT counts.  The leftmost offset where
    (strict == n_const and wild == n_wild) is the regex match.
2.  **Constant-region repair** — when no offset matches exactly, the
    reference slides a window over offsets ``0..len-F`` (exclusive; the
    final alignment is never tried — parse.rs:291-304) and picks the
    unique best window with mismatches <= budget via fix_error, treating
    'N' on either side as a wildcard.  That is exactly the relaxed channel
    of the same convolution: masked argmin with a tie-drop (count of
    minima != 1 => drop, parse.rs:577-592).
3.  **Quality gate** — the reference averages Phred scores over each
    non-constant region run, skipping the final run (loop-end bug,
    parse.rs:331-375) and, for repaired reads, reading scores from
    position 0 rather than the matched window (parse.rs:98-119 after
    repair rewrites the read).  Reproduced bit-for-bit.
4.  **Barcode matching** — the reference's fix_error linear scan becomes a
    one-hot read-slot x one-hot candidate-matrix matmul:
    match-count per candidate, argmin of mismatches, dropped when the
    minimum is not unique or exceeds the budget (parse.rs:438-524).
5.  **Counting** — per-read (sample, combo) flat indices scatter-add into
    a dense count tensor (info.rs:735-808's hashmap becomes
    ``[n_samples * prod(n_codes)]``), and six error counters are summed
    masks (info.rs:16-23's atomics become one ``[6]`` vector).
"""

from __future__ import annotations

import os

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ngs_barcode_count_tpu import dna
from ngs_barcode_count_tpu import stats
from ngs_barcode_count_tpu.conversions import BarcodeConversions
from ngs_barcode_count_tpu.errors import MaxSeqErrors
from ngs_barcode_count_tpu.scheme import (
    KIND_CONST,
    KIND_WILD,
    SequenceScheme,
)

_BIG = np.int32(1 << 20)


@dataclass(frozen=True)
class QualitySegment:
    """A non-constant run of the reference's regions_string that gets a
    mean-quality check (parse.rs:331-375).  ``start`` indexes the
    regions_string (which EXCLUDES explicit-N runs), matching the
    reference's zip of scores with regions_string."""

    start: int
    length: int


def quality_segments(regions_string: str) -> list[QualitySegment]:
    """Maximal non-'C' runs that are followed by a different region code.
    The final run is never flushed by the reference's loop, so a trailing
    non-constant region is never checked — reproduced here."""
    segs: list[QualitySegment] = []
    i = 0
    n = len(regions_string)
    while i < n:
        j = i
        while j < n and regions_string[j] == regions_string[i]:
            j += 1
        if regions_string[i] != "C" and j < n:
            segs.append(QualitySegment(start=i, length=j - i))
        i = j
    return segs


def quality_segments_fixed(scheme: SequenceScheme) -> list[QualitySegment]:
    """--fix-quirks variant: every barcode region (sample/counted/random)
    gets a check, including a trailing one, and segment offsets are true
    FORMAT positions, so quality stays aligned even when the scheme has
    explicit-N runs (which the reference's regions_string drops,
    info.rs:287-295)."""
    from ngs_barcode_count_tpu.scheme import (
        KIND_BARCODE,
        KIND_RANDOM,
        KIND_SAMPLE,
    )

    segs: list[QualitySegment] = []
    kinds = scheme.kind
    i = 0
    n = len(kinds)
    while i < n:
        j = i
        while j < n and kinds[j] == kinds[i]:
            j += 1
        if kinds[i] in (KIND_SAMPLE, KIND_BARCODE, KIND_RANDOM):
            segs.append(QualitySegment(start=i, length=j - i))
        i = j
    # consecutive counted barcodes share a kind but are distinct regions:
    # split on slot boundaries
    out: list[QualitySegment] = []
    boundaries = sorted(
        {s.offset for s in scheme.barcode_slots}
        | {s.offset + s.length for s in scheme.barcode_slots}
    )
    for seg in segs:
        cuts = [seg.start] + [
            b for b in boundaries if seg.start < b < seg.start + seg.length
        ] + [seg.start + seg.length]
        for a, b in zip(cuts, cuts[1:]):
            out.append(QualitySegment(start=a, length=b - a))
    return out


@dataclass(frozen=True, eq=False)  # identity hash: used as a jit static arg
class DecodePlan:
    """Static decode configuration compiled from scheme + conversions.

    Everything here is Python/NumPy constants closed over by the jitted
    step, so XLA sees a fully static program.
    """

    scheme: SequenceScheme
    max_errors: MaxSeqErrors
    # Matching matrices (None => raw-DNA mode for that region)
    sample_onehot: np.ndarray | None  # [n_samples, Ls*4] int8
    sample_n_mask: np.ndarray | None
    counted_onehots: tuple[np.ndarray, ...] | None  # per position
    counted_n_masks: tuple[np.ndarray, ...] | None
    qual_segments: tuple[QualitySegment, ...]
    min_quality: float
    fix_quirks: bool = False

    @property
    def dense_sample(self) -> bool:
        """Sample index is a dense id (file given, or no sample region)."""
        return self.sample_onehot is not None or self.scheme.sample_slot is None

    @property
    def dense_counted(self) -> bool:
        return self.counted_onehots is not None

    @property
    def combo_fits_i32(self) -> bool:
        """Mixed-radix combo ids fit an int32 wire column.  Mega-DEL
        spaces (e.g. 3 x 2000-candidate positions) overflow; the keyed
        wire then carries per-position indices instead."""
        return self.dense_counted and self.n_combos < 2**31

    @property
    def flat_fits_device(self) -> bool:
        """(sample, combo) flat ids fit int32 AND the dense count tensor
        is allocatable (NGS_DENSE_LIMIT_BYTES, default 4GB — the
        reference's sparse hashmap has no such bound, so oversized
        spaces demote to the host keyed store)."""
        if not (self.dense_sample and self.dense_counted):
            return False
        import os

        n_flat = self.n_samples * self.n_combos
        limit = int(os.environ.get("NGS_DENSE_LIMIT_BYTES", 4 << 30))
        return n_flat < 2**31 and 4 * n_flat <= limit

    @property
    def dense_counts(self) -> bool:
        """Counts accumulate fully on device: dense ids, no random
        barcode (random needs host-side PCR-duplicate dedup), and a
        combo space small enough for a device tensor."""
        return (
            self.dense_sample
            and self.dense_counted
            and not self.scheme.random_barcode
            and self.flat_fits_device
        )

    @property
    def n_samples(self) -> int:
        if self.scheme.sample_slot is None:
            return 1
        return self.sample_onehot.shape[0] if self.sample_onehot is not None else 0

    @property
    def combo_radix(self) -> tuple[int, ...]:
        assert self.counted_onehots is not None
        return tuple(oh.shape[0] for oh in self.counted_onehots)

    @property
    def n_combos(self) -> int:
        n = 1
        for r in self.combo_radix:
            n *= r
        return n


def make_plan(
    scheme: SequenceScheme,
    conversions: BarcodeConversions,
    max_errors: MaxSeqErrors,
    fix_quirks: bool = False,
) -> DecodePlan:
    sample_oh = sample_nm = None
    if conversions.sample_set is not None and conversions.sample_set.count:
        sample_oh = conversions.sample_set.onehot
        sample_nm = conversions.sample_set.n_mask
    counted_oh = counted_nm = None
    if conversions.counted_sets:
        counted_oh = tuple(s.onehot for s in conversions.counted_sets)
        counted_nm = tuple(s.n_mask for s in conversions.counted_sets)
    return DecodePlan(
        scheme=scheme,
        max_errors=max_errors,
        sample_onehot=sample_oh,
        sample_n_mask=sample_nm,
        counted_onehots=counted_oh,
        counted_n_masks=counted_nm,
        qual_segments=tuple(
            quality_segments_fixed(scheme)
            if fix_quirks
            else quality_segments(scheme.regions_string)
        ),
        min_quality=max_errors.min_quality,
        fix_quirks=fix_quirks,
    )


# ---------------------------------------------------------------------------
# Offset scan (regex search + repair window scan fused into one conv)
# ---------------------------------------------------------------------------


# Column alignment of the scan matmul's offset axis.  Padded columns are
# index-masked (offs < O), so any value is bit-exact
# (tests/test_decode_vs_oracle.py lane-equality test); 8 ran the dense
# step fastest of 8/16/32/128 on an H100 (PERF.md).
SCAN_LANE = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _scan_matrix(plan: DecodePlan, L: int, O: int, O_pad: int) -> np.ndarray:
    """[5L, 3*O_pad] f32 weight matrix.  Column layout (contiguous
    groups): [0, O_pad) strict-const matches per offset, [O_pad, 2*O_pad)
    wild-position ACGT hits, [2*O_pad, 3*O_pad) relaxed-const matches
    (read 'N' wildcard, parse.rs:569).  Input rows are c-major: c*L+l."""
    scheme = plan.scheme
    F = scheme.length
    W = np.zeros((5 * L, 3 * O_pad), dtype=np.float32)
    for o in range(O):
        for p in range(F):
            k = scheme.kind[p]
            l = o + p
            if l >= L:
                break
            if k == KIND_CONST:
                b = int(scheme.fmt_codes[p])
                W[b * L + l, o] += 1.0
                W[b * L + l, 2 * O_pad + o] += 1.0
                W[dna.N * L + l, 2 * O_pad + o] += 1.0
            elif k == KIND_WILD:
                for b in range(4):
                    W[b * L + l, O_pad + o] += 1.0
    return W


def _front_key_bound(n_const: int, O_pad: int, n_wild: int) -> int:
    """Max packed repair key in scan_offsets (must stay < 2^30)."""
    return (n_const + 1) * _next_pow2(O_pad) * _next_pow2(n_wild + 1)


def _realign(src, shift, L, O, TB, F):
    """R[b, p] = src[b, shift[b] + p] for shift in [0, O) via a log2
    shifter: ceil(log2(O)) conditional lane shifts instead of an
    O-iteration select loop or a per-slot gather."""
    work = src
    for k in range((O - 1).bit_length()):
        s = 1 << k
        shifted = jnp.concatenate(
            [work[:, s:], jnp.zeros((TB, s), work.dtype)], axis=1
        )
        bit = ((shift >> k) & 1) == 1  # [TB, 1]
        work = jnp.where(bit, shifted, work)
    return work[:, :F]


def _onehot_cmajor(bases: jnp.ndarray) -> jnp.ndarray:
    """[B, L] base codes -> [B, 5L] bf16 one-hot, c-major (row c*L + l is
    "position l holds code c"; codes >= 5 set no row)."""
    B, L = bases.shape
    return jax.nn.one_hot(bases, 5, dtype=jnp.bfloat16, axis=1).reshape(
        B, 5 * L
    )


def scan_offsets(plan: DecodePlan, bases: jnp.ndarray, lengths: jnp.ndarray):
    """For each read: the regex-match offset (leftmost exact), the repair
    offset (unique best window), and validity flags.

    Returns (has_exact, exact_off, repair_ok, rep_off, wild_ok_at, mism_min).
    """
    scheme = plan.scheme
    B, L = bases.shape
    F = scheme.length
    O = L - F + 1
    n_const = int(np.sum(scheme.kind == KIND_CONST))
    n_wild = int(np.sum(scheme.kind == KIND_WILD))

    # One matmul over a c-major one-hot replaces the natural 5-in /
    # 3-out-channel conv.  bf16 operands + f32 accumulation: every
    # operand is exactly 0/1 and every sum is below 2^24, so the match
    # counts stay exact integers.
    x1h = _onehot_cmajor(bases)  # [B, 5L] c-major
    O_pad = _round_up(O, SCAN_LANE)
    w = jnp.asarray(_scan_matrix(plan, L, O, O_pad), jnp.bfloat16)
    out = jnp.dot(x1h, w, preferred_element_type=jnp.float32)
    strict = out[:, :O_pad].astype(jnp.int32)
    wild = out[:, O_pad : 2 * O_pad].astype(jnp.int32)
    relax = out[:, 2 * O_pad :].astype(jnp.int32)

    offs = jnp.arange(O_pad, dtype=jnp.int32)[None, :]
    lengths = lengths.astype(jnp.int32)[:, None]
    # Regex can match wherever the window fits inside the true read.
    in_range = (offs + F <= lengths) & (offs < O)
    exact = (strict == n_const) & (wild == n_wild) & in_range
    # leftmost True: one min-reduction also yields has_exact
    exact_off = jnp.min(jnp.where(exact, offs, _BIG), axis=1).astype(
        jnp.int32
    )
    has_exact = exact_off != _BIG
    exact_off = jnp.where(has_exact, exact_off, 0)

    # Repair windows: the reference iterates 0..(len - F) EXCLUSIVE
    # (parse.rs:295), so the final alignment is never tried; --fix-quirks
    # includes it.
    if plan.fix_quirks:
        rep_in_range = (offs + F <= lengths) & (offs < O)
    else:
        rep_in_range = (offs + F < lengths) & (offs < O)
    max_const = plan.max_errors.constant_region
    if _front_key_bound(n_const, O_pad, n_wild) < (1 << 30):
        # Pack (mismatches, offset, wild-hits) into one int32 key per
        # lane and recover min-mism / first and last best offset (the
        # tie-drop) / wild count at the pick from TWO min-reductions
        # instead of the six O-wide reduction/gather ops of the natural
        # formulation.
        cw_bits = (_next_pow2(n_wild + 1) - 1).bit_length()
        op_bits = (_next_pow2(O_pad) - 1).bit_length()
        op_mask = (1 << op_bits) - 1
        big_key = jnp.int32(1 << 30)
        mism = n_const - relax
        key1 = jnp.where(
            rep_in_range,
            ((mism << op_bits) | offs) << cw_bits | wild,
            big_key,
        )
        key2 = jnp.where(
            rep_in_range,
            ((mism << op_bits) | (op_mask - offs)) << cw_bits,
            big_key,
        )
        k1 = jnp.min(key1, axis=1)
        k2 = jnp.min(key2, axis=1)
        mism_min = k1 >> (op_bits + cw_bits)  # huge when no window
        o_first = (k1 >> cw_bits) & op_mask
        wild_at_rep = k1 & ((1 << cw_bits) - 1)
        o_last = op_mask - ((k2 >> cw_bits) & op_mask)
        repair_ok = (
            (mism_min <= max_const) & (o_first == o_last)
            # After repair the regex re-runs on the rebuilt read:
            # explicit-N positions must be A/C/G/T there too
            # (info.rs:287-295's [AGCT]).
            & (wild_at_rep == n_wild)
        )
        rep_off = jnp.where(k1 == big_key, 0, o_first)
    else:  # exotic formats whose key would overflow int32
        mism = jnp.where(rep_in_range, n_const - relax, _BIG)
        mism_min = jnp.min(mism, axis=1)
        rep_off = jnp.argmin(mism, axis=1).astype(jnp.int32)
        n_best = jnp.sum((mism == mism_min[:, None]) & rep_in_range, axis=1)
        repair_ok = (
            (mism_min <= max_const)
            & (n_best == 1)
            & jnp.take_along_axis(
                wild == n_wild, rep_off[:, None], axis=1
            )[:, 0]
        )
    return has_exact, exact_off, repair_ok, rep_off


# ---------------------------------------------------------------------------
# Hamming-argmin matching (slot extraction is a static slice of the
# shifter-realigned region; see decode_batch)
# ---------------------------------------------------------------------------


def match_barcodes(
    slot_codes: jnp.ndarray,
    onehot: np.ndarray,
    n_mask: np.ndarray,
    budget: int,
):
    """Error-tolerant match of extracted slots against a barcode set.

    The reference's fix_error (parse.rs:553-593) scans candidates counting
    mismatches where neither char is 'N', keeps the unique best <= budget.
    Encoding the read with N = all-ones and candidates one-hot makes the
    per-position dot product the match indicator, so one matmul computes
    all mismatch counts at once; a both-N position double-counts (dot = 4) and
    is corrected with a second small matmul only when the candidate set
    actually contains Ns.

    Returns (idx [B] int32, ok [B] bool).
    """
    B, sl = slot_codes.shape
    r = (slot_codes[..., None] == jnp.arange(4, dtype=slot_codes.dtype)) | (
        slot_codes == dna.N
    )[..., None]
    # 0/1 operands in bf16, f32 accumulation: exact (sums < 2^24)
    r = r.reshape(B, sl * 4).astype(jnp.bfloat16)
    matches = jnp.dot(
        r, jnp.asarray(onehot, dtype=jnp.bfloat16).T,
        preferred_element_type=jnp.float32,
    )
    if n_mask.any():
        read_n = (slot_codes == dna.N).astype(jnp.bfloat16)
        matches = matches - 3.0 * jnp.dot(
            read_n, jnp.asarray(n_mask, dtype=jnp.bfloat16).T,
            preferred_element_type=jnp.float32,
        )
    m = sl - matches.astype(jnp.int32)  # [B, n_codes] mismatch counts
    nc = m.shape[1]
    ncp2 = 1 << max(nc - 1, 0).bit_length()
    if (sl + 1) * ncp2 < (1 << 30):
        # two packed-key min-reductions instead of min+argmin+sum: the
        # unique-best test is first-best column == last-best column
        nc_bits = (ncp2 - 1).bit_length()
        nc_mask = ncp2 - 1
        col = jnp.arange(nc, dtype=jnp.int32)[None, :]
        kA = jnp.min((m << nc_bits) | col, axis=1)
        kB = jnp.min((m << nc_bits) | (nc_mask - col), axis=1)
        m_min = kA >> nc_bits
        idx = kA & nc_mask
        unique = idx == (nc_mask - (kB & nc_mask))
    else:  # gigantic candidate sets: keep the 3-reduction form
        m_min = jnp.min(m, axis=1)
        idx = jnp.argmin(m, axis=1).astype(jnp.int32)
        unique = jnp.sum(m == m_min[:, None], axis=1) == 1
    ok = (m_min <= budget) & unique
    return idx, ok


# ---------------------------------------------------------------------------
# Quality gate
# ---------------------------------------------------------------------------


def low_quality_mask(
    plan: DecodePlan, quals: jnp.ndarray, qual_start: jnp.ndarray
) -> jnp.ndarray:
    """True where any checked region's mean Phred < min_quality.

    Scores index from ``qual_start`` + regions_string position, exactly as
    the reference zips ``quality_scores().skip(start)`` with
    regions_string (parse.rs:340-345) — including the quirk that for
    repaired reads start is 0.
    """
    if not plan.qual_segments:
        return jnp.zeros(quals.shape[0], dtype=bool)
    # one elementwise shifter realign of the Phred lanes, then each
    # segment is a static slice (no per-segment gathers)
    B, L = quals.shape
    F = max(s.start + s.length for s in plan.qual_segments)
    O = L - F + 1
    rq = _realign(quals, qual_start[:, None], L, O, B, F).astype(
        jnp.float32
    )
    bad = jnp.zeros(B, dtype=bool)
    for seg in plan.qual_segments:
        seg_q = jax.lax.slice_in_dim(
            rq, seg.start, seg.start + seg.length, axis=1
        )
        bad = bad | (jnp.mean(seg_q, axis=1) < plan.min_quality)
    return bad


# ---------------------------------------------------------------------------
# The full decode step
# ---------------------------------------------------------------------------


def decode_batch(plan: DecodePlan, bases, quals, lengths, read_mask):
    """Decode one batch.  Returns a dict of per-read results + counters.

    ``read_mask`` marks real reads (the final batch of a file is padded to
    the static batch size).
    """
    scheme = plan.scheme
    F = scheme.length
    lengths = lengths.astype(jnp.int32)
    len_ok = (lengths >= F) & read_mask

    has_exact, exact_off, repair_ok, rep_off = scan_offsets(plan, bases, lengths)
    const_ok = len_ok & (has_exact | repair_ok)
    offset = jnp.where(has_exact, exact_off, rep_off)
    # Reference quirk: a repaired read's rebuilt sequence starts at 0, so
    # quality is read from position 0, not the matched window;
    # --fix-quirks reads it from the true window.
    if plan.fix_quirks:
        qual_start = offset
    else:
        qual_start = jnp.where(has_exact, exact_off, 0)

    if plan.min_quality > 0.0:
        lowq = const_ok & low_quality_mask(plan, quals, qual_start)
    else:
        lowq = jnp.zeros_like(const_ok)
    alive = const_ok & ~lowq

    out = {}

    # ONE log2-conditional-shift realign of the whole format window:
    # every slot extraction becomes a static slice.  Elementwise, so XLA
    # fuses it instead of materializing a gather.
    B_, L_ = bases.shape
    O_ = L_ - F + 1
    R = _realign(bases, offset[:, None], L_, O_, B_, F)

    def slot_codes_of(slot):
        return jax.lax.slice_in_dim(
            R, slot.offset, slot.offset + slot.length, axis=1
        )

    # Sample barcode
    if scheme.sample_slot is None:
        sample_idx = jnp.zeros(bases.shape[0], dtype=jnp.int32)
        sample_ok = alive
    else:
        sample_codes = slot_codes_of(scheme.sample_slot)
        if plan.sample_onehot is not None:
            sample_idx, s_ok = match_barcodes(
                sample_codes,
                plan.sample_onehot,
                plan.sample_n_mask,
                plan.max_errors.sample_barcode,
            )
            sample_ok = alive & s_ok
        else:
            # Raw-DNA sample mode: emit the codes; host keys by sequence.
            out["sample_codes"] = sample_codes
            sample_idx = jnp.zeros(bases.shape[0], dtype=jnp.int32)
            sample_ok = alive
    sample_err = alive & ~sample_ok

    # Counted barcodes
    counted_ok = sample_ok
    if plan.counted_onehots is not None:
        combo_flat = jnp.zeros(bases.shape[0], dtype=jnp.int32)
        counted_idx = []
        for i, slot in enumerate(scheme.barcode_slots):
            codes = slot_codes_of(slot)
            idx, ok = match_barcodes(
                codes,
                plan.counted_onehots[i],
                plan.counted_n_masks[i],
                plan.max_errors.barcode[i],
            )
            counted_ok = counted_ok & ok
            counted_idx.append(idx)
            if plan.combo_fits_i32:
                combo_flat = combo_flat * plan.combo_radix[i] + idx
        if plan.combo_fits_i32:
            out["combo_flat"] = combo_flat
        else:
            # mega-DEL: the mixed-radix id would overflow int32; emit
            # per-position candidate indices for host keying
            out["counted_idx"] = counted_idx
    else:
        # Raw-DNA counted mode: emit per-slot codes for host keying.
        out["counted_codes"] = [
            slot_codes_of(slot) for slot in scheme.barcode_slots
        ]
    barcode_err = sample_ok & ~counted_ok
    valid = counted_ok

    if scheme.random_slot is not None:
        out["random_codes"] = slot_codes_of(scheme.random_slot)

    counters = jnp.zeros(stats.NUM_COUNTERS, dtype=jnp.int32)
    counters = counters.at[stats.CONSTANT_REGION].set(
        jnp.sum(read_mask & ~const_ok)
    )
    counters = counters.at[stats.LOW_QUALITY].set(jnp.sum(lowq))
    counters = counters.at[stats.SAMPLE_BARCODE].set(jnp.sum(sample_err))
    counters = counters.at[stats.BARCODE].set(jnp.sum(barcode_err))
    if plan.dense_counts:
        # matched is final on device; random-barcode dedup would move some
        # of these to duplicates on the host.
        counters = counters.at[stats.MATCHED].set(jnp.sum(valid))

    out["valid"] = valid
    out["sample_idx"] = sample_idx
    out["counters"] = counters
    return out


@partial(jax.jit, static_argnums=0, donate_argnums=(1, 2))
def dense_count_step(
    plan: DecodePlan, counts, counters, bases, quals, lengths, read_mask
):
    """Fully-on-device step for the dense mode: decode + scatter-add counts.

    ``counts`` is the carried ``[n_samples * n_combos]`` int32 tensor — the
    tensor form of the reference's Results hashmap (info.rs:661-809) — and
    ``counters`` the carried ``[6]`` stat vector.  Both stay on device for
    the whole run so the batch loop is pure async dispatch (nothing is
    fetched per batch; this matters doubly on high-latency interconnects).
    """
    r = decode_batch(plan, bases, quals, lengths, read_mask)
    flat = r["sample_idx"] * plan.n_combos + r["combo_flat"]
    flat = jnp.where(r["valid"], flat, 0)
    counts = counts.at[flat].add(r["valid"].astype(counts.dtype))
    return counts, counters + r["counters"]


@partial(jax.jit, static_argnums=0)
def keyed_decode_step(plan: DecodePlan, bases, quals, lengths, read_mask):
    """Decode step for raw-DNA / random-barcode modes: returns per-read
    outputs for host-side keyed accumulation and dedup."""
    return decode_batch(plan, bases, quals, lengths, read_mask)


def random_base6_index(codes: jnp.ndarray) -> jnp.ndarray:
    """[B, Lr] base codes (0..5: ACGT, N, OTHER) -> [B] base-6 index.

    Exact for every possible read character, so the device dedup bytemap
    distinguishes random barcodes precisely like the reference's string
    set (info.rs:770-801)."""
    B, Lr = codes.shape
    c = codes.astype(jnp.int32)
    idx = jnp.zeros((B,), jnp.int32)
    for i in range(Lr):
        idx = idx * 6 + c[:, i]
    return idx


@partial(jax.jit, static_argnums=0, donate_argnums=(1, 2))
def random_bitmap_step(
    plan: DecodePlan, bytemap, counters, bases, quals, lengths, read_mask
):
    """Fully-device random-barcode step: decode + dedup-bytemap update.

    ``bytemap`` is ``[n_flat * 6**Lr]`` uint8 — one byte per possible
    (sample, combo, random) triple, set to 1 on first sight via
    scatter-max.  Per-batch, counters[MATCHED] accumulates VALID reads;
    at flush the true matched count is the bytemap's popcount and
    duplicates = valid - popcount (runner.finalize)."""
    r = decode_batch(plan, bases, quals, lengths, read_mask)
    flat = r["sample_idx"] * plan.n_combos + r["combo_flat"]
    c6 = 6 ** plan.scheme.random_slot.length
    ridx = random_base6_index(r["random_codes"])
    byte_idx = jnp.where(r["valid"], flat * c6 + ridx, 0)
    bytemap = bytemap.at[byte_idx].max(r["valid"].astype(bytemap.dtype))
    counters = counters + r["counters"].at[stats.MATCHED].set(
        jnp.sum(r["valid"])
    )
    return bytemap, counters


@partial(jax.jit, static_argnums=(0, 7), donate_argnums=(1, 2))
def random_bitmap_step_packed(
    plan: DecodePlan, bytemap, counters, packed, lengths, exc_idx, exc_val,
    width: int, n_reads,
):
    """Wire-format variant of random_bitmap_step."""
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    quals = jnp.zeros((B, 1), jnp.int8)
    return random_bitmap_step.__wrapped__(
        plan, bytemap, counters, bases, quals, lengths, read_mask
    )


@partial(jax.jit, static_argnums=(0, 8), donate_argnums=(1, 2))
def random_bitmap_step_packed_q(
    plan: DecodePlan, bytemap, counters, packed, lengths, exc_idx, exc_val,
    quals, width: int, n_reads,
):
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    return random_bitmap_step.__wrapped__(
        plan, bytemap, counters, bases, quals, lengths, read_mask
    )


# ---------------------------------------------------------------------------
# Device hash-set dedup (random-barcode mode, combo spaces too large for
# the exact bytemap)
# ---------------------------------------------------------------------------
#
# The reference keeps a host HashSet of random-barcode strings
# (info.rs:770-801).  The bytemap replaces it exactly for small spaces;
# for large spaces this open-addressing fingerprint table keeps the
# dedup ON DEVICE so nothing per-read ever crosses the host link:
#
# - table[S] uint32: 0 = empty, else a 32-bit fingerprint of the
#   (sample, combo, random) triple.  Slot and fingerprint come from two
#   independent 32-bit mixes of the exact triple ids.
# - within a batch, first-occurrence is decided EXACTLY by a
#   lexicographic sort on (slot, fp) — later same-triple reads are
#   duplicates.
# - cross-batch: 4 linear probes; fp match = duplicate, first empty
#   slot = insert (scatter; the re-gather detects the winner among
#   same-slot contenders, losers continue probing).
# - reads that exhaust all probes (cluster full) compact into a
#   fixed-cap overflow buffer that the host dedups exactly; slots never
#   free, so every later occurrence of an overflowed triple overflows
#   too and host classification stays exact.
#
# The only inexactness is a 32-bit fingerprint collision inside one
# probe window (~2^-32 per comparison; expected well below one read per
# 400M-read run — documented in PARITY.md next to the 128-bit host-key
# note).

DEDUP_PROBES = 4


def _mix32(a, b, c1: int, c2: int):
    """32-bit avalanche mix of two int32 lanes (murmur3-style finalizer;
    wrapping uint32 arithmetic)."""
    h = (a.astype(jnp.uint32) * np.uint32(c1)) ^ (
        b.astype(jnp.uint32) * np.uint32(c2)
    )
    h = h ^ (h >> 15)
    h = h * np.uint32(0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = h * np.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    return h


def random_hashset_step(
    plan: DecodePlan, table, counts, counters, bases, quals, lengths,
    read_mask, cap: int, variant: str | None = None,
):
    """Decode + device hash-set dedup + dense count update.

    Returns (table, counts, counters, over_rows [cap, 2] int32,
    n_over [1] int32): over_rows[:n_over] are (flat, ridx) of reads the
    table could not place (probe cluster full) for exact host handling.
    """
    r = decode_batch(plan, bases, quals, lengths, read_mask)
    valid = r["valid"]
    flat = r["sample_idx"] * plan.n_combos + r["combo_flat"]
    flat = jnp.where(valid, flat, 0)
    ridx = random_base6_index(r["random_codes"])
    return hashset_update(
        plan, table, counts, counters, r["counters"], valid, flat, ridx,
        cap, variant,
    )


def _dedup_sorted() -> bool:
    """NGS_DEDUP_SORTED=1: run the probe/insert tail in slot-ascending
    (sorted) order instead of original row order.  The in-batch dedup
    sort already exists; staying in the sorted domain (a) drops the
    scatter that mapped first-occurrence flags back to row order and
    (b) makes every probe gather/scatter sweep the table in ascending
    address order — the memory-latency-bound part of the tail (VERDICT
    r3 weak #2).  Classification stays EXACT either way: same-slot
    contenders are distinct triples (in-batch repeats were already
    collapsed), so a different insert placement only moves which slot a
    triple lands in — lookups scan the whole probe window, and losers
    still overflow to the exact host path.  Final counts/counters are
    identical; only table bit layout differs.  Default on;
    NGS_DEDUP_SORTED=0 restores the row-order formulation."""
    return os.environ.get("NGS_DEDUP_SORTED", "1") == "1"


def _dedup_windowed() -> int:
    """NGS_DEDUP_WINDOWED=1: replace the 4-step sequential probe loop
    (4 x gather/scatter/gather = 12 dependent device-memory ops) with
    ONE [B, 4] window gather for
    duplicate detection plus two contention-resolved insert rounds
    (scatter + verify gathers each): ~6 dependent HBM ops.  Exact under
    the same fp-collision caveat: in-batch repeats were collapsed by
    the sort, so same-window contenders are distinct triples; a loser
    retries against the refreshed window and double-losers overflow to
    the exact host path (slots never free, so later occurrences of an
    overflowed triple keep overflowing).  =2 uses FOUR independent
    [B] gathers instead of one [B, 4] gather (independent gathers have
    no data dependency and can pipeline)."""
    v = os.environ.get("NGS_DEDUP_WINDOWED", "0")
    return int(v) if v in ("0", "1", "2") else 0


def _dedup_probes() -> int:
    """NGS_DEDUP_PROBES: linear-probe window length (default 4).  Fewer
    probes = fewer dependent HBM ops per read; rows that exhaust the
    window compact into the EXACT host overflow path, so any value is
    bit-correct — the knob trades device memory traffic against
    overflow volume."""
    v = int(os.environ.get("NGS_DEDUP_PROBES", DEDUP_PROBES))
    return max(1, min(v, 8))


def _dedup_variant() -> str:
    """Static fingerprint of the dedup-tail formulation (threaded into
    every jitted step as a static arg so env toggles retrace)."""
    w = _dedup_windowed()
    p = _dedup_probes()
    return (
        ("sorted" if _dedup_sorted() else "row")
        + ("" if p == DEDUP_PROBES else f"+p{p}")
        + ("" if not w else f"+win{w}")
    )


def _parse_variant(variant: str) -> tuple[bool, int, int]:
    """variant string -> (sorted_tail, windowed, n_probes)."""
    parts = variant.split("+")
    sorted_tail = parts[0] == "sorted"
    windowed = 0
    n_probes = DEDUP_PROBES
    for part in parts[1:]:
        if part.startswith("win"):
            windowed = int(part[3:])
        elif part.startswith("p"):
            n_probes = int(part[1:])
    return sorted_tail, windowed, n_probes




def probe_insert(table, slot, fp, active, S: int, windowed: int,
                 n_probes: int = DEDUP_PROBES):
    """The shared probe/insert core of the device dedup (single-device
    hashset_update AND the sharded owner-side tail use this, so variant
    toggles keep every engine bit-consistent).  ``active`` marks rows
    still seeking classification (in-batch repeats already collapsed).
    Returns (table, dup_hits, is_new, overflow)."""
    resolved = jnp.zeros_like(active)
    is_new = jnp.zeros_like(active)
    if windowed:
        cur4 = jnp.minimum(
            slot[:, None]
            + jnp.arange(n_probes, dtype=jnp.int32)[None, :],
            S,
        )

        def window(tab):
            if windowed == 1:  # one strided [B, 4] gather
                return tab.at[cur4].get(mode="fill", fill_value=1)
            # four INDEPENDENT [B] gathers: no data dependency between
            # them, so their HBM latencies overlap
            return jnp.stack(
                [
                    tab.at[jnp.minimum(slot + p, S)].get(
                        mode="fill", fill_value=1
                    )
                    for p in range(n_probes)
                ],
                axis=1,
            )

        win = window(table)
        hit = active & jnp.any(win == fp[:, None], axis=1)
        resolved = resolved | hit
        active = active & ~hit
        empty = win == 0
        for rnd in range(2):
            has_empty = jnp.any(empty, axis=1)
            first_e = jnp.argmax(empty, axis=1).astype(jnp.int32)
            want = active & has_empty
            pos = jnp.minimum(slot + first_e, S)
            table = table.at[jnp.where(want, pos, S)].set(
                fp, mode="drop"
            )
            got = table.at[pos].get(mode="fill", fill_value=1)
            won = want & (got == fp)
            is_new = is_new | won
            active = active & ~won
            if rnd == 0:
                win = window(table)
                empty = win == 0
    else:
        for p in range(n_probes):
            cur = jnp.minimum(slot + p, S)  # S = harmless OOB (clip/drop)
            t = table.at[cur].get(mode="fill", fill_value=1)
            hit = active & (t == fp)
            resolved = resolved | hit
            active = active & ~hit
            empty = active & (t == 0)
            table = table.at[jnp.where(empty, cur, S)].set(fp, mode="drop")
            t2 = table.at[cur].get(mode="fill", fill_value=1)
            won = empty & (t2 == fp)
            is_new = is_new | won
            active = active & ~won
    return table, resolved, is_new, active


def hashset_update(
    plan: DecodePlan, table, counts, counters, counters_add, valid, flat,
    ridx, cap: int, variant: str | None = None,
):
    """The dedup/count tail of random_hashset_step: in-batch exact
    dedup (lex sort), the
    linear-probe table update, count scatter, and overflow compaction.
    ``counters_add`` carries the decode front end's error tallies;
    MATCHED/DUPLICATES are overwritten here from the dedup outcome.
    ``variant`` (default: _dedup_variant() read at trace time) selects
    the slot-ascending order (_dedup_sorted) and/or the windowed probe
    formulation (_dedup_windowed); jitted callers must thread it as a
    STATIC arg so toggling the env vars retraces."""
    if variant is None:
        variant = _dedup_variant()
    sorted_tail, windowed, n_probes = _parse_variant(variant)
    S = table.shape[0]
    B = valid.shape[0]

    slot = (_mix32(flat, ridx, 0x85EBCA6B, 0xC2B2AE35) % np.uint32(S)).astype(
        jnp.int32
    )
    fp = _mix32(flat, ridx, 0x9E3779B1, 0x27D4EB2F)
    fp = jnp.where(fp == 0, np.uint32(1), fp)
    # invalid rows: sentinel slot past the table, fp 0 (matches nothing)
    slot = jnp.where(valid, slot, S)
    fp = jnp.where(valid, fp, 0)

    # exact in-batch first-occurrence via lexicographic sort on (slot, fp)
    row = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
    if sorted_tail:
        # carry the payload through the sort and stay in sorted order
        # for the whole tail (counts/counters/overflow are all
        # order-independent)
        slot, fp, _, flat, ridx = jax.lax.sort(
            (slot, fp, row, flat, ridx), num_keys=2
        )
        run_start = jnp.concatenate(
            [
                jnp.ones((1,), bool),
                (slot[1:] != slot[:-1]) | (fp[1:] != fp[:-1]),
            ]
        )
        valid = fp != 0
        first = run_start
    else:
        s_slot, s_fp, s_row = jax.lax.sort((slot, fp, row), num_keys=2)
        run_start = jnp.concatenate(
            [
                jnp.ones((1,), bool),
                (s_slot[1:] != s_slot[:-1]) | (s_fp[1:] != s_fp[:-1]),
            ]
        )
        first = jnp.zeros(B, bool).at[s_row].set(run_start)
    resolved_dup = valid & ~first
    active = valid & first
    table, probe_dups, is_new, overflow = probe_insert(
        table, slot, fp, active, S, windowed, n_probes
    )
    resolved_dup = resolved_dup | probe_dups

    counts = counts.at[jnp.where(is_new, flat, 0)].add(
        is_new.astype(counts.dtype)
    )
    add = counters_add
    add = add.at[stats.MATCHED].set(jnp.sum(is_new))
    add = add.at[stats.DUPLICATES].set(jnp.sum(resolved_dup))
    counters = counters + add

    # compact overflow rows to a fixed-cap prefix (host fetches [:n];
    # cumsum-scatter, ~7% cheaper than the sort-based compaction and
    # order does not matter: the host treats the rows as a set, and
    # n > cap aborts before any row is read)
    pos = jnp.cumsum(overflow.astype(jnp.int32)) - 1
    dst = jnp.where(overflow & (pos < cap), pos, cap)
    over_rows = jnp.zeros((cap, 2), jnp.int32).at[dst].set(
        jnp.stack([flat, ridx], axis=1), mode="drop"
    )
    n_over = jnp.sum(overflow.astype(jnp.int32))
    return table, counts, counters, over_rows, n_over[None]


@partial(jax.jit, static_argnums=(0, 8, 9), donate_argnums=(1, 2, 3))
def random_hashset_step_unpacked(
    plan: DecodePlan, table, counts, counters, bases, quals, lengths,
    read_mask, cap: int, variant: str | None = None,
):
    """Jitted entry for the int8 (NumPy-ingest fallback) path.
    ``variant`` None resolves _dedup_variant() at trace time (callers
    that toggle the env vars mid-process must pass it explicitly)."""
    return random_hashset_step(
        plan, table, counts, counters, bases, quals, lengths, read_mask,
        cap, variant,
    )


@partial(jax.jit, static_argnums=(0, 8, 9, 11), donate_argnums=(1, 2, 3))
def random_hashset_step_packed(
    plan: DecodePlan, table, counts, counters, packed, lengths, exc_idx,
    exc_val, width: int, cap: int, n_reads,
    variant: str | None = None,
):
    """Wire-format variant of random_hashset_step (no quality gate)."""
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    quals = jnp.zeros((B, 1), jnp.int8)
    return random_hashset_step(
        plan, table, counts, counters, bases, quals, lengths, read_mask,
        cap, variant,
    )


@partial(jax.jit, static_argnums=(0, 9, 10, 12), donate_argnums=(1, 2, 3))
def random_hashset_step_packed_q(
    plan: DecodePlan, table, counts, counters, packed, lengths, exc_idx,
    exc_val, quals, width: int, cap: int, n_reads,
    variant: str | None = None,
):
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    return random_hashset_step(
        plan, table, counts, counters, bases, quals, lengths, read_mask,
        cap, variant,
    )


@partial(jax.jit, static_argnums=0)
def random_bitmap_counts(plan: DecodePlan, bytemap):
    """Flush: per-(sample,combo) distinct-random counts = row sums."""
    c6 = 6 ** plan.scheme.random_slot.length
    n_flat = plan.n_samples * plan.n_combos
    return jnp.sum(
        bytemap.reshape(n_flat, c6).astype(jnp.int32), axis=1
    )


def pack_slot_words(codes: jnp.ndarray) -> jnp.ndarray:
    """[B, sl] int8 base codes -> [B, ceil(sl/10)] int32: 3 bits per base,
    10 bases per 30-bit word.  The host combines words j as
    ``sum(w_j << 30*j)``, which reproduces counting.pack_codes' 3-bit
    layout exactly, so results_view needs no changes."""
    B, sl = codes.shape
    n_words = -(-sl // 10)
    pad = n_words * 10 - sl
    c = codes.astype(jnp.int32)
    if pad:
        c = jnp.concatenate([c, jnp.zeros((B, pad), jnp.int32)], axis=1)
    c = c.reshape(B, n_words, 10)
    shifts = (3 * jnp.arange(10, dtype=jnp.int32))[None, None, :]
    return jnp.sum(c << shifts, axis=2).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Wire-format (2-bit packed) entry points
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2, 3))
def unpack_quals_wire(quals_packed, codebook, width: int, bits: int = 4):
    """[B, W/(8/bits)] uint8 packed quality wire + [16] int8 codebook ->
    [B, W] int8 Phred, bit-identical to the raw tensor the codec would
    have shipped (io.parallel_ingest._maybe_pack_quals; ``bits`` = 4
    for <= 16 distinct values, 2 for <= 4)."""
    B = quals_packed.shape[0]
    per = 8 // bits
    mask = (1 << bits) - 1
    fields = [
        ((quals_packed >> (bits * k)) & mask).astype(jnp.int32)
        for k in range(per)
    ]
    codes = jnp.stack(fields, axis=-1).reshape(B, -1)[:, :width]
    return codebook[codes]


def unpack_bases(packed, exc_idx, exc_val, width: int):
    """[B, W/4] uint8 wire format -> [B, W] int8 base codes.

    2-bit fields decode to A/C/G/T; the sparse exception list then
    scatters the true codes (N, OTHER) over the flat tensor.  Padding
    exception slots carry index -1 and are dropped by the scatter.
    """
    B = packed.shape[0]
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    bases = (packed[:, :, None] >> shifts[None, None, :]) & 3
    bases = bases.reshape(B, width).astype(jnp.int8)
    flat = bases.reshape(-1)
    flat = flat.at[exc_idx].set(exc_val, mode="drop")
    return flat.reshape(B, width)


@partial(jax.jit, static_argnums=(0, 7), donate_argnums=(1, 2))
def dense_count_step_packed(
    plan: DecodePlan, counts, counters, packed, lengths, exc_idx, exc_val,
    width: int, n_reads,
):
    """dense_count_step on wire-format input (quality gate off: Phred
    bytes never cross the host-device link).  ``n_reads`` is a [1] int32
    device scalar so partial final batches don't trigger a recompile."""
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    quals = jnp.zeros((B, 1), jnp.int8)  # unused: min_quality == 0
    return dense_count_step.__wrapped__(
        plan, counts, counters, bases, quals, lengths, read_mask
    )


@partial(jax.jit, static_argnums=(0, 8), donate_argnums=(1, 2))
def dense_count_step_packed_q(
    plan: DecodePlan, counts, counters, packed, lengths, exc_idx, exc_val,
    quals, width: int, n_reads,
):
    """Wire-format step with the quality gate on (Phred lanes shipped)."""
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    return dense_count_step.__wrapped__(
        plan, counts, counters, bases, quals, lengths, read_mask
    )


# ---------------------------------------------------------------------------
# Host-side quality gate (two-phase): config-3 runs on byte-limited links
# ship NO quality bytes at all.  Phase A decodes bases-only and sends a
# 2-byte/read gate wire down (qual_start + class); the host evaluates the
# segment-mean gate against the raw Phred bytes it still holds and sends
# a 1-bit/read low-quality mask up; phase B folds the mask into the
# counters and count scatter.  Bit-identical to the on-device gate:
# sample/counted classification never depends on quality, and the
# reference drops a low-quality read BEFORE barcode matching
# (parse.rs:98-119), which phase B's masking reproduces exactly.
# ---------------------------------------------------------------------------

GATE_PAD = np.int8(4)  # cls for padding rows past n_reads


@partial(jax.jit, static_argnums=(0, 5))
def dense_gate_probe_packed(
    plan: DecodePlan, packed, lengths, exc_idx, exc_val, width: int,
    n_reads,
):
    """Phase A: bases-only decode.  Returns dict with
    ``flat`` [B] int32 (stays ON DEVICE for phase B),
    ``cls`` [B] int8 (0=const_err 1=sample_err 2=counted_err 3=valid
    4=pad; stays on device), and ``wire`` [B, 2] int8 (fetched:
    col 0 = qual_start per the reference's post-repair-offset-0 quirk,
    col 1 = cls)."""
    scheme = plan.scheme
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    F = scheme.length
    lengths = lengths.astype(jnp.int32)
    len_ok = (lengths >= F) & read_mask

    has_exact, exact_off, repair_ok, rep_off = scan_offsets(
        plan, bases, lengths
    )
    const_ok = len_ok & (has_exact | repair_ok)
    offset = jnp.where(has_exact, exact_off, rep_off)
    if plan.fix_quirks:
        qual_start = offset
    else:
        qual_start = jnp.where(has_exact, exact_off, 0)
    alive = const_ok  # the gate masks later, in phase B

    B_, L_ = bases.shape
    O_ = L_ - F + 1
    R = _realign(bases, offset[:, None], L_, O_, B_, F)

    def slot_codes_of(slot):
        return jax.lax.slice_in_dim(
            R, slot.offset, slot.offset + slot.length, axis=1
        )

    if scheme.sample_slot is None:
        sample_idx = jnp.zeros(B, dtype=jnp.int32)
        sample_ok = alive
    else:
        sample_idx, s_ok = match_barcodes(
            slot_codes_of(scheme.sample_slot),
            plan.sample_onehot,
            plan.sample_n_mask,
            plan.max_errors.sample_barcode,
        )
        sample_ok = alive & s_ok
    counted_ok = sample_ok
    combo_flat = jnp.zeros(B, dtype=jnp.int32)
    for i, slot in enumerate(scheme.barcode_slots):
        idx, ok = match_barcodes(
            slot_codes_of(slot),
            plan.counted_onehots[i],
            plan.counted_n_masks[i],
            plan.max_errors.barcode[i],
        )
        counted_ok = counted_ok & ok
        combo_flat = combo_flat * plan.combo_radix[i] + idx

    cls = jnp.where(
        ~read_mask,
        jnp.int32(GATE_PAD),
        jnp.where(
            ~const_ok,
            0,
            jnp.where(~sample_ok, 1, jnp.where(~counted_ok, 2, 3)),
        ),
    )
    flat = jnp.where(
        counted_ok, sample_idx * plan.n_combos + combo_flat, 0
    )
    wire = jnp.stack(
        [qual_start.astype(jnp.int8), cls.astype(jnp.int8)], axis=1
    )
    return {"flat": flat, "cls": cls.astype(jnp.int8), "wire": wire}


def host_lowq_mask(
    plan: DecodePlan,
    quals: np.ndarray,
    qual_start: np.ndarray,
    applies: np.ndarray,
) -> np.ndarray:
    """Host-side segment-mean gate, grouped by qual_start so every
    segment is a contiguous slice (no per-read gathers).  Means
    accumulate in float32 to match the device formulation
    (low_quality_mask) decision-for-decision."""
    lowq = np.zeros(len(applies), bool)
    if not plan.qual_segments or not applies.any():
        return lowq
    thr = np.float32(plan.min_quality)
    for o in np.unique(qual_start[applies]).tolist():
        rows = np.flatnonzero(applies & (qual_start == o))
        q = quals[rows]
        bad = np.zeros(len(rows), bool)
        for seg in plan.qual_segments:
            m = q[:, o + seg.start : o + seg.start + seg.length].mean(
                axis=1, dtype=np.float32
            )
            bad |= m < thr
        lowq[rows] = bad
    return lowq


@partial(jax.jit, static_argnums=0, donate_argnums=(1, 2))
def dense_gate_apply(plan: DecodePlan, counts, counters, flat, cls,
                     lowq_bits):
    """Phase B: fold the host's 1-bit/read low-quality mask into the
    deferred counter/count updates.  Reference order (parse.rs:98-119):
    a low-quality read is dropped before barcode matching, so it counts
    ONLY as low_quality regardless of phase A's classification."""
    B = flat.shape[0]
    bits = jnp.repeat(lowq_bits, 8)[:B]
    lowq = (
        (bits >> (jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0)
                  .squeeze(-1) % 8)) & 1
    ).astype(bool)
    gate_applies = (cls >= 1) & (cls <= 3)
    lq = gate_applies & lowq
    add = jnp.zeros(stats.NUM_COUNTERS, jnp.int32)
    add = add.at[stats.CONSTANT_REGION].set(jnp.sum(cls == 0))
    add = add.at[stats.LOW_QUALITY].set(jnp.sum(lq))
    add = add.at[stats.SAMPLE_BARCODE].set(jnp.sum((cls == 1) & ~lowq))
    add = add.at[stats.BARCODE].set(jnp.sum((cls == 2) & ~lowq))
    valid = (cls == 3) & ~lowq
    add = add.at[stats.MATCHED].set(jnp.sum(valid))
    counts = counts.at[jnp.where(valid, flat, 0)].add(
        valid.astype(counts.dtype)
    )
    return counts, counters + add


def _keyed_packed_outputs(plan: DecodePlan, out: dict) -> dict:
    """Compress keyed-mode per-read outputs to ONE int32 matrix so the
    host needs a single device fetch per batch (device-to-host round
    trips dominate keyed-mode cost on high-latency links).

    Column layout (host side decodes via keyed_wire_layout):
      [0] valid flag, then sample (1 idx col or ceil(Ls/10) word cols),
      then combo (1 col) or per-slot 3-bit word cols, then random word
      cols when present.
    """
    fused = _fused_bits(plan)
    if fused is not None:
        s_bits, c_bits = fused
        col0 = (
            (out["valid"].astype(jnp.int32) << (s_bits + c_bits))
            | (out["sample_idx"] << c_bits)
            | out["combo_flat"]
        )
        cols = [col0[:, None]]
    else:
        cols = [out["valid"].astype(jnp.int32)[:, None]]
        if "sample_codes" in out:
            cols.append(pack_slot_words(out["sample_codes"]))
        elif plan.scheme.sample_slot is not None:
            cols.append(out["sample_idx"][:, None])
        # no sample region: the index is always 0, omit the column
        if "combo_flat" in out:
            cols.append(out["combo_flat"][:, None])
        elif "counted_idx" in out:
            for idx in out["counted_idx"]:
                cols.append(idx[:, None])
        else:
            for c in out["counted_codes"]:
                cols.append(pack_slot_words(c))
    if "random_codes" in out:
        cols.append(pack_slot_words(out["random_codes"]))
    return {
        "wire": jnp.concatenate(cols, axis=1),
        "counters": out["counters"],
    }


def _fused_bits(plan: DecodePlan):
    """(sample_bits, combo_bits) when valid+sample+combo fit one int32
    (the usual random-barcode DEL case), else None."""
    if not (plan.dense_sample and plan.dense_counted):
        return None
    s_bits = max(int(plan.n_samples - 1).bit_length(), 1)
    c_bits = max(int(plan.n_combos - 1).bit_length(), 1)
    return (s_bits, c_bits) if 1 + s_bits + c_bits <= 31 else None


def keyed_wire_layout(plan: DecodePlan) -> dict:
    """Column spans of the keyed wire matrix (see _keyed_packed_outputs)."""
    scheme = plan.scheme

    def words(n):
        return -(-n // 10)

    fused = _fused_bits(plan)
    if fused is not None:
        layout = {"fused": (0, 1, fused[0], fused[1])}
        pos = 1
        if scheme.random_slot is not None:
            w = words(scheme.random_slot.length)
            layout["random_words"] = (pos, w)
            pos += w
        layout["total"] = pos
        return layout

    layout = {"valid": (0, 1)}
    pos = 1

    if scheme.sample_slot is not None and plan.sample_onehot is None:
        w = words(scheme.sample_slot.length)
        layout["sample_words"] = (pos, w)
        pos += w
    elif scheme.sample_slot is not None:
        layout["sample_idx"] = (pos, 1)
        pos += 1
    # else: no sample region -> index constant 0, no column
    if plan.dense_counted and plan.combo_fits_i32:
        layout["combo_flat"] = (pos, 1)
        pos += 1
    elif plan.dense_counted:
        # mega-DEL: one matched-candidate-index column per position
        spans = []
        for _ in scheme.barcode_slots:
            spans.append((pos, 1))
            pos += 1
        layout["counted_idx"] = spans
    else:
        spans = []
        for s in scheme.barcode_slots:
            w = words(s.length)
            spans.append((pos, w))
            pos += w
        layout["counted_words"] = spans
    if scheme.random_slot is not None:
        w = words(scheme.random_slot.length)
        layout["random_words"] = (pos, w)
        pos += w
    layout["total"] = pos
    return layout


@partial(jax.jit, static_argnums=(0, 5))
def keyed_decode_step_packed(
    plan: DecodePlan, packed, lengths, exc_idx, exc_val, width: int, n_reads
):
    """Keyed-mode step on wire-format input, quality gate off."""
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    quals = jnp.zeros((B, 1), jnp.int8)
    out = decode_batch(plan, bases, quals, lengths, read_mask)
    return _keyed_packed_outputs(plan, out)


@partial(jax.jit, static_argnums=(0, 6))
def keyed_decode_step_packed_q(
    plan: DecodePlan, packed, lengths, exc_idx, exc_val, quals, width: int,
    n_reads,
):
    """Keyed-mode wire-format step with the quality gate on."""
    B = packed.shape[0]
    bases = unpack_bases(packed, exc_idx, exc_val, width)
    read_mask = (
        jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0).squeeze(-1)
        < n_reads[0]
    )
    out = decode_batch(plan, bases, quals, lengths, read_mask)
    return _keyed_packed_outputs(plan, out)
