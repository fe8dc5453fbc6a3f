"""Device-mesh parallelism (the layer the reference never had — its only
parallelism is a mutex deque between threads, main.rs:67-121 / C15 in
SURVEY.md).

Two mesh axes:

- ``data`` — read batches shard across devices (the DP analog).  Each
  device decodes its shard into a local count tensor and local counter
  vector; merging is a single ``psum`` at flush, so the steady-state loop
  has no cross-device traffic at all.
- ``model`` — candidate barcode matrices shard across devices (the TP
  analog, for DEL libraries whose barcode sets are too large to
  replicate).  Each device computes Hamming mismatches against its slice
  of candidates; the global unique-argmin reduces with ``pmin``/``psum``
  while preserving the reference's tie-drop semantics exactly: the
  global minimum count is the sum of per-shard counts at the global min.

Multi-host: the same mesh spans hosts via ``jax.distributed.initialize``;
each host feeds its own FASTQ shard into its addressable devices and the
psum rides the interconnect.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ngs_barcode_count_tpu import dna, stats
from ngs_barcode_count_tpu.ops import decode as dec
from ngs_barcode_count_tpu.ops.decode import DecodePlan


def make_mesh(n_data: int, n_model: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_data * n_model
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"))


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def shard_candidates(plan: DecodePlan, n_model: int):
    """Split every candidate matrix row-wise into n_model equal shards
    (padded with never-matching rows).  Returns (stacked arrays keyed like
    the plan, per-set true counts)."""

    def split(onehot, n_mask):
        n = onehot.shape[0]
        per = -(-n // n_model)
        oh = _pad_rows(onehot, per * n_model)
        nm = _pad_rows(n_mask, per * n_model)
        # padded rows are all-zero one-hots: mismatches = slot length,
        # never the argmin winner for real budgets; additionally masked
        # out via the true-count bound inside the kernel.
        return (
            oh.reshape(n_model, per, -1),
            nm.reshape(n_model, per, n_mask.shape[1]),
            n,
        )

    out = {}
    if plan.sample_onehot is not None:
        out["sample"] = split(plan.sample_onehot, plan.sample_n_mask)
    if plan.counted_onehots is not None:
        out["counted"] = [
            split(oh, nm)
            for oh, nm in zip(plan.counted_onehots, plan.counted_n_masks)
        ]
    return out


def match_barcodes_model_parallel(
    slot_codes: jnp.ndarray,
    onehot_shard: jnp.ndarray,  # [per, len*4] this device's slice
    n_mask_shard: jnp.ndarray,
    n_total: int,
    budget: int,
    axis: str = "model",
):
    """Tie-drop Hamming argmin with candidates sharded over ``axis``.

    Per-shard local (min, argmin, count-at-min) reduce to the global
    unique-min via pmin + psum, preserving parse.rs:553-593 semantics.
    """
    B, sl = slot_codes.shape
    per = onehot_shard.shape[0]
    shard_id = jax.lax.axis_index(axis)
    base = shard_id * per
    r = (slot_codes[..., None] == jnp.arange(4, dtype=slot_codes.dtype)) | (
        slot_codes == dna.N
    )[..., None]
    # 0/1 operands in bf16, f32 accumulation: exact (sums < 2^24)
    r = r.reshape(B, sl * 4).astype(jnp.bfloat16)
    matches = jnp.dot(
        r, onehot_shard.astype(jnp.bfloat16).T,
        preferred_element_type=jnp.float32,
    )
    if n_mask_shard.shape[-1]:
        read_n = (slot_codes == dna.N).astype(jnp.bfloat16)
        matches = matches - 3.0 * jnp.dot(
            read_n, n_mask_shard.astype(jnp.bfloat16).T,
            preferred_element_type=jnp.float32,
        )
    m = sl - matches.astype(jnp.int32)  # [B, per]
    # mask out padded candidate rows
    cand_ids = base + jnp.arange(per, dtype=jnp.int32)[None, :]
    is_real = cand_ids < n_total
    n_model = jax.lax.psum(1, axis)
    ncp2 = 1 << max(per * n_model - 1, 0).bit_length()
    if (sl + 1) * ncp2 < (1 << 30):
        # packed (mism, global col) keys: TWO pmin collectives give the
        # global first-best and last-best candidate; unique-best iff
        # they agree (vs 3 collectives for pmin/psum-count/pmin-idx)
        nc_bits = (ncp2 - 1).bit_length()
        nc_mask = ncp2 - 1
        big_key = jnp.int32(1 << 30)
        kA = jnp.min(
            jnp.where(is_real, (m << nc_bits) | cand_ids, big_key), axis=1
        )
        kB = jnp.min(
            jnp.where(
                is_real, (m << nc_bits) | (nc_mask - cand_ids), big_key
            ),
            axis=1,
        )
        kA = jax.lax.pmin(kA, axis)
        kB = jax.lax.pmin(kB, axis)
        m_min = kA >> nc_bits
        idx = kA & nc_mask
        uniq = idx == (nc_mask - (kB & nc_mask))
        ok = (m_min <= budget) & uniq
        return idx, ok
    m = jnp.where(is_real, m, dec._BIG)
    m_min_local = jnp.min(m, axis=1)
    idx_local = base + jnp.argmin(m, axis=1).astype(jnp.int32)
    m_min = jax.lax.pmin(m_min_local, axis)
    cnt_local = jnp.sum(m == m_min[:, None], axis=1)
    cnt = jax.lax.psum(cnt_local, axis)
    idx_cand = jnp.where(m_min_local == m_min, idx_local, jnp.int32(1 << 30))
    idx = jax.lax.pmin(idx_cand, axis)
    ok = (m_min <= budget) & (cnt == 1)
    return idx, ok


def decode_batch_sharded(
    plan: DecodePlan, cand, bases, quals, lengths, read_mask, model_axis="model"
):
    """decode_batch with model-parallel matching substituted in.  Runs
    inside shard_map: ``cand`` holds this device's candidate shards."""
    scheme = plan.scheme
    F = scheme.length
    lengths = lengths.astype(jnp.int32)
    len_ok = (lengths >= F) & read_mask
    has_exact, exact_off, repair_ok, rep_off = dec.scan_offsets(
        plan, bases, lengths
    )
    const_ok = len_ok & (has_exact | repair_ok)
    offset = jnp.where(has_exact, exact_off, rep_off)
    # Mirror ops.decode.decode_batch: reference quirk reads quality from 0
    # for repaired reads; --fix-quirks reads it from the matched window.
    if plan.fix_quirks:
        qual_start = offset
    else:
        qual_start = jnp.where(has_exact, exact_off, 0)

    if plan.min_quality > 0.0:
        lowq = const_ok & dec.low_quality_mask(plan, quals, qual_start)
    else:
        lowq = jnp.zeros_like(const_ok)
    alive = const_ok & ~lowq

    # one elementwise shifter realign; slot extraction = static slices
    # (same rationale as decode_batch)
    B_, L_ = bases.shape
    R = dec._realign(bases, offset[:, None], L_, L_ - F + 1, B_, F)

    def slot_codes_of(slot):
        return jax.lax.slice_in_dim(
            R, slot.offset, slot.offset + slot.length, axis=1
        )

    if scheme.sample_slot is None:
        sample_idx = jnp.zeros(bases.shape[0], dtype=jnp.int32)
        sample_ok = alive
    else:
        sample_codes = slot_codes_of(scheme.sample_slot)
        oh, nm, n_total = cand["sample"]
        sample_idx, s_ok = match_barcodes_model_parallel(
            sample_codes, oh, nm, n_total, plan.max_errors.sample_barcode,
            model_axis,
        )
        sample_ok = alive & s_ok
    sample_err = alive & ~sample_ok

    counted_ok = sample_ok
    combo_flat = jnp.zeros(bases.shape[0], dtype=jnp.int32)
    for i, slot in enumerate(scheme.barcode_slots):
        codes = slot_codes_of(slot)
        oh, nm, n_total = cand["counted"][i]
        idx, ok = match_barcodes_model_parallel(
            codes, oh, nm, n_total, plan.max_errors.barcode[i], model_axis
        )
        counted_ok = counted_ok & ok
        combo_flat = combo_flat * plan.combo_radix[i] + idx
    barcode_err = sample_ok & ~counted_ok
    valid = counted_ok

    counters = jnp.zeros(stats.NUM_COUNTERS, dtype=jnp.int32)
    counters = counters.at[stats.CONSTANT_REGION].set(
        jnp.sum(read_mask & ~const_ok)
    )
    counters = counters.at[stats.LOW_QUALITY].set(jnp.sum(lowq))
    counters = counters.at[stats.SAMPLE_BARCODE].set(jnp.sum(sample_err))
    counters = counters.at[stats.BARCODE].set(jnp.sum(barcode_err))
    counters = counters.at[stats.MATCHED].set(jnp.sum(valid))
    return valid, sample_idx, combo_flat, counters


@dataclass(frozen=True, eq=False)
class ShardedDenseEngine:
    """Dense-mode decode+count over a (data, model) mesh.

    Count state lives sharded over 'data' (one [n_flat] tensor per data
    row); each step is one shard_map call with zero per-batch host sync;
    ``finalize`` psums counts and counters across the mesh.
    """

    plan: DecodePlan
    mesh: Mesh
    cand: dict
    n_data: int
    n_model: int

    @classmethod
    def build(cls, plan: DecodePlan, mesh: Mesh) -> "ShardedDenseEngine":
        n_data = mesh.shape["data"]
        n_model = mesh.shape["model"]
        cand = shard_candidates(plan, n_model)
        return cls(plan=plan, mesh=mesh, cand=cand, n_data=n_data,
                   n_model=n_model)

    def _cand_device_arrays(self):
        """Candidate shards as mesh-sharded device arrays (arrays only —
        true candidate counts stay static): replicated over 'data', split
        over 'model'."""
        sh = NamedSharding(self.mesh, P("model", None, None))
        out = {}
        if "sample" in self.cand:
            oh, nm, _ = self.cand["sample"]
            out["sample"] = (jax.device_put(oh, sh), jax.device_put(nm, sh))
        if "counted" in self.cand:
            out["counted"] = [
                (jax.device_put(oh, sh), jax.device_put(nm, sh))
                for oh, nm, _ in self.cand["counted"]
            ]
        return out

    def _cand_totals(self):
        out = {}
        if "sample" in self.cand:
            out["sample"] = self.cand["sample"][2]
        if "counted" in self.cand:
            out["counted"] = [n for _, _, n in self.cand["counted"]]
        return out

    def initial_state(self):
        n_flat = self.plan.n_samples * self.plan.n_combos
        counts = jax.device_put(
            jnp.zeros((self.n_data, n_flat), jnp.int32),
            NamedSharding(self.mesh, P("data", None)),
        )
        counters = jax.device_put(
            jnp.zeros((self.n_data, stats.NUM_COUNTERS), jnp.int32),
            NamedSharding(self.mesh, P("data", None)),
        )
        return counts, counters

    def make_step(self):
        plan = self.plan
        mesh = self.mesh
        cand_arrays = self._cand_device_arrays()
        totals = self._cand_totals()

        cand_specs = jax.tree.map(lambda x: P("model", None, None), cand_arrays)

        def local_step(counts, counters, cand, bases, quals, lengths, mask):
            # inside shard_map: counts [1, n_flat], batch [B/n_data, L],
            # cand entries [1, per, len*4] on this device's model row.
            merged = {}
            if "sample" in cand:
                oh, nm = cand["sample"]
                merged["sample"] = (oh[0], nm[0], totals["sample"])
            if "counted" in cand:
                merged["counted"] = [
                    (oh[0], nm[0], totals["counted"][i])
                    for i, (oh, nm) in enumerate(cand["counted"])
                ]
            valid, sample_idx, combo_flat, batch_counters = (
                decode_batch_sharded(plan, merged, bases, quals, lengths, mask)
            )
            flat = sample_idx * plan.n_combos + combo_flat
            flat = jnp.where(valid, flat, 0)
            # model-replicated rows would double-count: only model rank 0
            # contributes counts (every model rank computed identical
            # results after the pmin/psum reductions).
            on_first = jax.lax.axis_index("model") == 0
            inc = (valid & on_first).astype(counts.dtype)
            counts = counts.at[0, flat].add(inc)
            counters = counters + jnp.where(
                on_first, batch_counters, 0
            )[None, :]
            return counts, counters

        step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(
                    P("data", None),
                    P("data", None),
                    cand_specs,
                    P("data", None),
                    P("data", None),
                    P("data"),
                    P("data"),
                ),
                out_specs=(P("data", None), P("data", None)),
                check_vma=False,
            ),
            donate_argnums=(0, 1),
        )

        def bound_step(counts, counters, bases, quals, lengths, mask):
            return step(
                counts, counters, cand_arrays, bases, quals, lengths, mask
            )

        return bound_step

    def make_packed_step(self, width: int, with_quals: bool):
        """Wire-format sharded step: 2-bit packed rows shard over 'data',
        each device unpacks its shard (with its own rebased exception
        bucket) and decodes it.  Count state stays sharded; merging
        remains the one psum at flush.
        """
        plan = self.plan
        mesh = self.mesh
        n_data = self.n_data
        cand_arrays = self._cand_device_arrays()
        totals = self._cand_totals()
        cand_specs = jax.tree.map(
            lambda x: P("model", None, None), cand_arrays
        )

        def local_step(counts, counters, cand, packed, lengths, exc_idx,
                       exc_val, n_reads, quals):
            # inside shard_map: packed [B/n_data, W/4], exc_* [1, cap]
            # rebased to the local flat index space, n_reads [1] global.
            from ngs_barcode_count_tpu.ops.decode import unpack_bases

            rows = packed.shape[0]
            data_rank = jax.lax.axis_index("data")
            local_n = jnp.clip(n_reads[0] - data_rank * rows, 0, rows)
            mask = (
                jax.lax.broadcasted_iota(jnp.int32, (rows, 1), 0).squeeze(-1)
                < local_n
            )
            on_first = jax.lax.axis_index("model") == 0
            bases = unpack_bases(packed, exc_idx[0], exc_val[0], width)
            q = (
                quals
                if quals is not None
                else jnp.zeros((rows, 1), jnp.int8)
            )
            merged = {}
            if "sample" in cand:
                oh, nm = cand["sample"]
                merged["sample"] = (oh[0], nm[0], totals["sample"])
            if "counted" in cand:
                merged["counted"] = [
                    (oh[0], nm[0], totals["counted"][i])
                    for i, (oh, nm) in enumerate(cand["counted"])
                ]
            valid, sample_idx, combo_flat, batch_counters = (
                decode_batch_sharded(
                    plan, merged, bases, q, lengths, mask
                )
            )
            flat = sample_idx * plan.n_combos + combo_flat
            flat = jnp.where(valid, flat, 0)
            inc = (valid & on_first).astype(counts.dtype)
            counts = counts.at[0, flat].add(inc)
            counters = counters + jnp.where(
                on_first, batch_counters, 0
            )[None, :]
            return counts, counters

        qual_spec = P("data", None) if with_quals else P()
        step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(
                    P("data", None),   # counts
                    P("data", None),   # counters
                    cand_specs,
                    P("data", None),   # packed
                    P("data"),         # lengths
                    P("data", None),   # exc_idx (per-shard buckets)
                    P("data", None),   # exc_val
                    P(),               # n_reads (replicated)
                    qual_spec,
                ),
                out_specs=(P("data", None), P("data", None)),
                check_vma=False,
            ),
            donate_argnums=(0, 1),
        )

        def bound_step(counts, counters, packed, lengths, exc_idx, exc_val,
                       n_reads, quals=None):
            return step(
                counts, counters, cand_arrays, packed, lengths, exc_idx,
                exc_val, n_reads, quals,
            )

        return bound_step

    def split_exceptions(self, exc_idx: np.ndarray, exc_val: np.ndarray,
                         rows: int, width: int):
        """Host-side: bucket the batch-flat exception list per data shard,
        rebasing indices to each shard's local flat space.  Returns
        ([n_data, cap] int32 padded with -1, [n_data, cap] int8); cap is
        bucketed to powers of two to bound recompiles."""
        n_data = self.n_data
        local_rows = rows // n_data
        span = local_rows * width
        live = exc_idx >= 0
        idx = exc_idx[live]
        val = exc_val[live]
        shard = idx // span
        local = idx - shard * span
        counts = np.bincount(shard, minlength=n_data)
        cap = 64
        m = int(counts.max()) if len(counts) else 0
        while cap < m:
            cap *= 2
        out_idx = np.full((n_data, cap), -1, np.int32)
        out_val = np.zeros((n_data, cap), np.int8)
        order = np.argsort(shard, kind="stable")
        pos = 0
        for s in range(n_data):
            c = counts[s]
            sel = order[pos : pos + c]
            out_idx[s, :c] = local[sel]
            out_val[s, :c] = val[sel]
            pos += c
        return out_idx, out_val

    @partial(jax.jit, static_argnums=0)
    def merge(self, counts, counters):
        """psum across the data axis (one collective per run, at flush)."""
        return jnp.sum(counts, axis=0), jnp.sum(counters, axis=0)

    def shard_batch(self, bases, quals, lengths, mask):
        sh2 = NamedSharding(self.mesh, P("data", None))
        sh1 = NamedSharding(self.mesh, P("data"))
        return (
            jax.device_put(bases, sh2),
            jax.device_put(quals, sh2),
            jax.device_put(lengths, sh1),
            jax.device_put(mask, sh1),
        )
