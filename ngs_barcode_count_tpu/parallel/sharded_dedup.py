"""Sharded device hash-set dedup: random-barcode PCR dedup that scales
over the data mesh (the multi-chip form of ops/decode.py's
single-device fingerprint table).

Topology per step, entirely inside one ``shard_map`` call:

1. each device decodes ITS shard of the packed batch (same wire format
   as the dense engine);
2. every valid read's (sample, combo, random) triple hashes to a global
   slot; the slot's OWNER device is ``slot // S_local``.  Reads
   bucketize by owner and ONE ``all_to_all`` routes (slot, fp, flat,
   ridx) tuples to their owners — nothing ever routes back: counts and
   matched/duplicate tallies accumulate at the owner, and the flush-time
   sum over devices (the same merge the dense engine does) is exact;
3. the owner dedups its received set exactly in-batch (lexicographic
   sort on (slot, fp)) and probes/inserts its LOCAL table shard with
   the same 4-probe open addressing as the single-device path;
4. reads that overflow their probe window — or their all_to_all bucket
   (skewed hashing) — compact into a fixed-cap per-device buffer that
   the host classifies exactly, so exactness never depends on table
   capacity.

Semantics match the single-device hash set (same fp-collision caveat,
PARITY.md); tests pin sharded == single-device == host keyed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ngs_barcode_count_tpu import stats
from ngs_barcode_count_tpu.ops import decode as dec
from ngs_barcode_count_tpu.ops.decode import DecodePlan, _mix32


@dataclass(frozen=True, eq=False)
class ShardedHashsetEngine:
    """Random-mode decode + sharded dedup + dense counts over a 1-D
    ('data',) mesh."""

    plan: DecodePlan
    mesh: Mesh
    n_data: int
    s_local: int  # table slots per device

    @classmethod
    def build(cls, plan: DecodePlan, mesh: Mesh,
              n_slots_total: int) -> "ShardedHashsetEngine":
        n_data = mesh.shape["data"]
        # floor: n_data * s_local never exceeds the int32 slot-id range
        # the caller budgeted (runner.MAX_SHARDED_SLOTS)
        s_local = max(n_slots_total // n_data, 8)
        return cls(plan=plan, mesh=mesh, n_data=n_data, s_local=s_local)

    def initial_state(self):
        sh = NamedSharding(self.mesh, P("data", None))
        n_flat = self.plan.n_samples * self.plan.n_combos
        table = jax.device_put(
            jnp.zeros((self.n_data, self.s_local), jnp.uint32), sh
        )
        counts = jax.device_put(
            jnp.zeros((self.n_data, n_flat), jnp.int32), sh
        )
        counters = jax.device_put(
            jnp.zeros((self.n_data, stats.NUM_COUNTERS), jnp.int32), sh
        )
        return table, counts, counters

    @partial(jax.jit, static_argnums=0)
    def merge(self, counts, counters):
        return jnp.sum(counts, axis=0), jnp.sum(counters, axis=0)

    def zero_counters(self):
        """A sharded zero counter vector (scratch for the lossless
        replay of a saturated batch — runner._replay_saturated)."""
        sh = NamedSharding(self.mesh, P("data", None))
        return jax.device_put(
            jnp.zeros((self.n_data, stats.NUM_COUNTERS), jnp.int32), sh
        )

    def bucket_cap(self, batch_rows: int) -> int:
        """all_to_all bucket capacity per (sender, owner) pair; uniform
        hashing concentrates ~R/n per bucket, 2x + slack absorbs skew."""
        R = batch_rows // self.n_data
        return int(os.environ.get(
            "NGS_DEDUP_BUCKET_CAP", 2 * (R // max(self.n_data, 1)) + 256
        ))

    def lossless_cap(self, batch_rows: int) -> int:
        """Overflow buffer size that can never truncate: a device's
        overflow candidates are every row it received (n x bucket_cap)
        plus every row it failed to send (its own R rows)."""
        R = batch_rows // self.n_data
        return self.n_data * self.bucket_cap(batch_rows) + R

    def split_exceptions(self, exc_idx, exc_val, rows: int, width: int):
        """Same host-side per-shard exception bucketing as the dense
        engine (parallel.mesh.ShardedDenseEngine)."""
        from ngs_barcode_count_tpu.parallel.mesh import ShardedDenseEngine

        return ShardedDenseEngine.split_exceptions(
            self, exc_idx, exc_val, rows, width
        )

    def make_packed_step(self, width: int, with_quals: bool,
                         batch_rows: int, cap_over: int | None = None):
        plan = self.plan
        mesh = self.mesh
        n = self.n_data
        S_local = self.s_local
        # owner-side tail follows the SAME dedup-variant knobs as the
        # single-device path (ops.decode.probe_insert), so an n=1 mesh
        # stays bit-identical to the unsharded step under any variant
        variant = dec._dedup_variant()
        sorted_tail, windowed, n_probes = dec._parse_variant(variant)
        R = batch_rows // n  # local rows per device
        # all_to_all bucket capacity per (sender, owner) pair; anything
        # past it goes to the exact host overflow path
        capb = self.bucket_cap(batch_rows)
        if cap_over is None:
            cap_over = max(R // 8, 256)
        c6 = 6 ** plan.scheme.random_slot.length

        def local_step(table, counts, counters, packed, lengths, exc_idx,
                       exc_val, n_reads, quals):
            from ngs_barcode_count_tpu.ops.decode import unpack_bases

            table = table[0]
            rows = packed.shape[0]
            rank = jax.lax.axis_index("data")
            local_n = jnp.clip(n_reads[0] - rank * rows, 0, rows)
            mask = (
                jax.lax.broadcasted_iota(jnp.int32, (rows, 1), 0)
                .squeeze(-1) < local_n
            )
            bases = unpack_bases(packed, exc_idx[0], exc_val[0], width)
            q = (
                quals if quals is not None
                else jnp.zeros((rows, 1), jnp.int8)
            )
            r = dec.decode_batch(plan, bases, q, lengths, mask)
            valid = r["valid"]
            flat = jnp.where(
                valid,
                r["sample_idx"] * plan.n_combos + r["combo_flat"], 0,
            )
            ridx = dec.random_base6_index(r["random_codes"])
            dec_counters = r["counters"]

            S_total = n * S_local
            slot_g = (
                _mix32(flat, ridx, 0x85EBCA6B, 0xC2B2AE35)
                % np.uint32(S_total)
            ).astype(jnp.int32)
            fp = _mix32(flat, ridx, 0x9E3779B1, 0x27D4EB2F)
            fp = jnp.where(fp == 0, np.uint32(1), fp)
            fp = jnp.where(valid, fp, 0)  # fp 0 = dead row everywhere
            # dead rows get owner n: they sort last, consume no bucket
            # capacity, and the send scatter drops them
            owner = jnp.where(valid, slot_g // S_local, n)
            slot_l = slot_g % S_local

            # ---- bucketize by owner, one all_to_all ----
            row_i = jax.lax.broadcasted_iota(
                jnp.int32, (rows, 1), 0
            ).squeeze(-1)
            o_s, sl_s, fp_s, fl_s, rx_s = jax.lax.sort(
                (owner, slot_l, fp, flat, ridx), num_keys=1
            )
            cnt = jnp.sum(
                o_s[None, :] == jnp.arange(n, dtype=jnp.int32)[:, None],
                axis=1,
            )  # [n] rows per owner
            starts = jnp.cumsum(cnt) - cnt
            pos_in_bucket = row_i - jnp.take(starts, o_s)
            fits = pos_in_bucket < capb
            # dead rows (fp 0) need not travel: drop them too
            live_s = fp_s != 0
            send_row = jnp.where(fits & live_s, o_s, n)  # n = OOB drop
            send_col = jnp.where(fits, pos_in_bucket, 0)
            send = jnp.zeros((n, capb, 4), jnp.uint32)
            vals = jnp.stack(
                [
                    sl_s.astype(jnp.uint32),
                    fp_s,
                    fl_s.astype(jnp.uint32),
                    rx_s.astype(jnp.uint32),
                ],
                axis=1,
            )
            send = send.at[send_row, send_col].set(vals, mode="drop")
            # bucket-dropped live rows -> this sender's host overflow
            sender_over = live_s & ~fits

            recv = jax.lax.all_to_all(
                send, "data", split_axis=0, concat_axis=0, tiled=True
            )  # [n, capb, 4]: row j = what device j sent me
            rv = recv.reshape(n * capb, 4)
            r_slot = rv[:, 0].astype(jnp.int32)
            r_fp = rv[:, 1]
            r_flat = rv[:, 2].astype(jnp.int32)
            r_ridx = rv[:, 3].astype(jnp.int32)
            r_live = r_fp != 0

            # ---- owner-side exact in-batch dedup ----
            M = n * capb
            key_slot = jnp.where(r_live, r_slot, S_local)
            m_row = jax.lax.broadcasted_iota(
                jnp.int32, (M, 1), 0
            ).squeeze(-1)
            if sorted_tail:
                # stay in (slot, fp)-sorted order for the whole tail —
                # identical processing order to the single-device sorted
                # formulation (counts/overflow are order-independent)
                key_slot, r_fp, _, r_flat, r_ridx = jax.lax.sort(
                    (key_slot, r_fp, m_row, r_flat, r_ridx), num_keys=2
                )
                run_start = jnp.concatenate(
                    [jnp.ones((1,), bool),
                     (key_slot[1:] != key_slot[:-1])
                     | (r_fp[1:] != r_fp[:-1])]
                )
                r_live = r_fp != 0
                first = run_start
                probe_slot = key_slot
            else:
                ks, kf, kr = jax.lax.sort(
                    (key_slot, r_fp, m_row), num_keys=2
                )
                run_start = jnp.concatenate(
                    [jnp.ones((1,), bool),
                     (ks[1:] != ks[:-1]) | (kf[1:] != kf[:-1])]
                )
                first = jnp.zeros(M, bool).at[kr].set(run_start)
                probe_slot = r_slot
            resolved_dup = r_live & ~first
            active = r_live & first
            table, probe_dups, is_new, probe_over = dec.probe_insert(
                table, probe_slot, r_fp, active, S_local, windowed,
                n_probes,
            )
            resolved_dup = resolved_dup | probe_dups

            counts = counts.at[0, jnp.where(is_new, r_flat, 0)].add(
                is_new.astype(counts.dtype)
            )
            add = dec_counters  # decode-side tallies from MY data shard
            add = add.at[stats.MATCHED].set(jnp.sum(is_new))
            add = add.at[stats.DUPLICATES].set(jnp.sum(resolved_dup))
            counters = counters + add[None, :]

            # ---- overflow compaction: probe overflow (owner side) +
            # bucket overflow (sender side) ----
            ov_flag = jnp.concatenate(
                [probe_over, sender_over]
            )
            ov_flat = jnp.concatenate([r_flat, fl_s])
            ov_ridx = jnp.concatenate([r_ridx, rx_s])
            # cumsum-scatter compaction (see ops.decode.hashset_update)
            pos = jnp.cumsum(ov_flag.astype(jnp.int32)) - 1
            dst = jnp.where(ov_flag & (pos < cap_over), pos, cap_over)
            over_rows = jnp.zeros((cap_over, 2), jnp.int32).at[dst].set(
                jnp.stack([ov_flat, ov_ridx], axis=1), mode="drop"
            )
            n_over = jnp.sum(ov_flag.astype(jnp.int32))
            return (
                table[None, :], counts, counters, over_rows[None],
                n_over[None, None],
            )

        qual_spec = P("data", None) if with_quals else P()
        step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(
                    P("data", None),   # table
                    P("data", None),   # counts
                    P("data", None),   # counters
                    P("data", None),   # packed
                    P("data"),         # lengths
                    P("data", None),   # exc_idx
                    P("data", None),   # exc_val
                    P(),               # n_reads
                    qual_spec,
                ),
                out_specs=(
                    P("data", None), P("data", None), P("data", None),
                    P("data", None, None), P("data", None),
                ),
                check_vma=False,
            ),
            donate_argnums=(0, 1, 2),
        )
        return step
