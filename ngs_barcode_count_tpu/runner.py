"""Run orchestrator (reference main.rs:11-166, redesigned for an accelerator).

The reference wires 1 reader thread + N-1 parser threads around a mutex
deque.  Here the pipeline is: chunked vectorized ingest -> fixed-shape
batches -> one jitted decode step per batch (async dispatch overlaps
host encode with device compute) -> dense device count tensor or host
keyed accumulation -> writers.  Multi-chip runs shard each batch across a
``jax.sharding.Mesh`` and psum-merge counts (parallel/mesh.py).
"""

from __future__ import annotations

import datetime as _dt
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from ngs_barcode_count_tpu import dna, stats
from ngs_barcode_count_tpu.conversions import BarcodeConversions
from ngs_barcode_count_tpu.counting import (
    DenseCounts,
    KeyedCounts,
    OverflowDedup,
    RandomDedup,
    pack_codes,
)
from ngs_barcode_count_tpu.errors import MaxSeqErrors
from ngs_barcode_count_tpu.io import batcher as batcher_mod
from ngs_barcode_count_tpu.io import fastq as fastq_mod
from ngs_barcode_count_tpu.ops import decode as dec
from ngs_barcode_count_tpu.output import ResultsView, WriteFiles, WriterConfig
from ngs_barcode_count_tpu.scheme import SequenceScheme, parse_scheme
from ngs_barcode_count_tpu.stats import SequenceErrors


@dataclass
class RunConfig:
    """CLI-equivalent configuration (reference arguments.rs:6-20) plus
    device knobs."""

    fastq: str
    format: str
    sample_barcodes_option: str | None = None
    counted_barcodes_option: str | None = None
    output_dir: str = "./"
    prefix: str = field(
        default_factory=lambda: _dt.date.today().strftime("%Y-%m-%d")
    )
    merge_output: bool = False
    enrich: bool = False
    barcodes_errors_option: int | None = None
    sample_errors_option: int | None = None
    constant_errors_option: int | None = None
    min_average_quality_score: float = 0.0
    # The reference's --threads maps onto the ingest reader pool here
    # (device parallelism comes from the mesh; 0 = auto)
    threads: int = 0
    batch_size: int = 1 << 17
    n_devices: int = 0  # 0 = all local devices
    # model-parallel candidate sharding: devices factor as
    # (data = n_devices/model_shards) x (model = model_shards); use for
    # DEL libraries whose candidate matrices are too large to replicate
    model_shards: int = 1
    progress: bool = True
    # checkpoint/resume (plain fastq, dense mode): snapshot every N
    # seconds; 0 disables.  resume=True restores from the checkpoint file
    checkpoint_interval_s: float = 0.0
    resume: bool = False
    profile_dir: str | None = None
    # --fix-quirks: corrected semantics instead of bug-for-bug reference
    # parity (inclusive final repair window, all quality segments checked,
    # post-repair quality from the true window offset)
    fix_quirks: bool = False

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(
            self.output_dir, f"{self.prefix}_checkpoint.npz"
        )


@dataclass
class RunResult:
    scheme: SequenceScheme
    conversions: BarcodeConversions
    max_errors: MaxSeqErrors
    seq_errors: SequenceErrors
    total_reads: int
    results: ResultsView
    compute_seconds: float
    reads_per_second: float
    # what the run chose: the count engine, the wire of its first batch,
    # and the ids of the devices that hold the count state
    engine: str = ""
    wire: str = ""
    state_devices: tuple = ()


def _device_dedup_default() -> str:
    """Random-mode dedup engine default: the on-device fingerprint table
    on direct-attached hardware, the host keyed path on slow proxied
    links (the table path's per-batch overflow fetches and
    donated-state chaining pipeline poorly through a blocking link,
    while the host path's deep keyed wire queue hides the round trips).
    The link class comes from a measured round-trip probe
    (utils.linkprobe), not from environment sniffing.
    NGS_DEVICE_DEDUP overrides."""
    import jax

    if jax.devices()[0].platform == "cpu":
        return "1"
    from ngs_barcode_count_tpu.utils import linkprobe

    # devices are already up here (the jax.devices() above), so the
    # probe is 3 tiny round trips, once per process
    return "0" if linkprobe.is_slow_link(allow_init=True) else "1"


def _dedup_table_slots() -> int:
    """PER-DEVICE dedup-table size (slots of uint32).
    NGS_DEDUP_TABLE_SLOTS overrides (interpreted as the TOTAL across the
    mesh — callers skip the per-device scaling when it is set);
    otherwise the table is sized from the device's ACTUAL free memory
    (a fixed 2^26 = ~45M triples at 70% load saturates below the
    reference's own published cardinality of 257.8M distinct triples).
    Budget: 25% of free device memory (leaves room for count state,
    batches and donation copies), clamped to [2^26, 2^30] slots; 2^30
    slots = 4 GB = ~750M triples at 70% load.  CPU backends (test
    meshes) keep a small table so the overflow path stays exercised."""
    env = os.environ.get("NGS_DEDUP_TABLE_SLOTS")
    if env:
        return int(env)
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return 1 << 16
    try:
        ms = dev.memory_stats()
        free = int(ms["bytes_limit"]) - int(ms["bytes_in_use"])
    except Exception:
        return 1 << 26  # no memory stats: the old conservative default
    budget = free // 4
    slots = 1 << max(int(budget // 4).bit_length() - 1, 0)
    return max(1 << 26, min(slots, 1 << 30))


# Global slot ids of the sharded dedup table are int32 lanes.
MAX_SHARDED_SLOTS = 1 << 31


def _bitmap_fits(plan: dec.DecodePlan) -> bool:
    """The dedup bytemap must fit HBM (one byte per possible
    (sample, combo, random) triple)."""
    limit = int(os.environ.get("NGS_BITMAP_LIMIT_BYTES", 2 << 30))
    c6 = 6 ** plan.scheme.random_slot.length
    return plan.n_samples * plan.n_combos * c6 <= limit


def describe_wire(step: str, pb) -> str:
    """The wire of one batch as the accumulator's ``step`` received it."""
    if step == "step":
        return "unpacked int8 batches (NumPy ingest)"
    if pb.quals_packed is not None:
        quals = f"{pb.qual_bits}-bit quality codebook"
    elif pb.qual_mode == "host":
        quals = "host quality gate"
    elif pb.quals is not None:
        quals = "raw int8 quality"
    else:
        quals = "no quality"
    layout = "col-major" if pb.transposed else "row-major"
    rows = pb.packed.shape[1] if pb.transposed else pb.packed.shape[0]
    return (f"{step}: 2-bit packed {layout}, {quals}, "
            f"{rows} rows x width {pb.width}")


def _batch_pin_bytes(pb) -> int:
    """Host bytes a pending overflow entry pins by retaining its source
    batch for lossless saturation replay (_push_overflow)."""
    if pb is None:
        return 0
    total = 0
    for name in ("packed", "bases", "quals"):
        arr = getattr(pb, name, None)
        total += getattr(arr, "nbytes", 0)
    return total


class CountAccumulator:
    """Owns the mode-dependent accumulation state for a run.

    ``n_devices > 1`` (dense mode only) switches the device side to the
    sharded mesh engine: batches shard over the 'data' axis and the count
    state lives distributed until one psum at finalize.
    """

    def __init__(
        self,
        plan: dec.DecodePlan,
        conversions: BarcodeConversions,
        n_devices: int = 1,
        allow_bitmap: bool = True,
        devices=None,
        triple_mode: bool = False,
        n_model: int = 1,
        allow_device_dedup: bool | None = None,
    ):
        # the hash-set dedup checkpoints (256MB table); the bytemap does
        # not (up to 2GB) — so checkpointing runs disable only the bytemap
        if allow_device_dedup is None:
            allow_device_dedup = allow_bitmap
        self.plan = plan
        self.conv = conversions
        self.n_devices = n_devices
        self.devices = devices
        # Multi-host random mode: accumulate distinct (sample, combo,
        # random) triples per host; the flush-time union across hosts is
        # the global dedup (multihost.merge_accumulator).
        self.triple_mode = triple_mode
        self.triple_valid = 0
        self.n_model = n_model
        self.shardings = None
        if n_devices > 1:
            # keyed/bitmap modes scale via jit auto-SPMD: inputs shard
            # over a 1-D data mesh, XLA partitions the step (dense mode
            # uses the explicit shard_map engine below instead)
            import jax
            from jax.sharding import (
                Mesh,
                NamedSharding,
                PartitionSpec as P,
            )

            devs = devices if devices is not None else jax.devices()
            mesh = Mesh(np.array(devs[:n_devices]), ("data",))
            self.shardings = {
                "rows2": NamedSharding(mesh, P("data", None)),
                "rows1": NamedSharding(mesh, P("data")),
                "repl": NamedSharding(mesh, P()),
            }
        self.seq_errors = SequenceErrors()
        # reported on RunResult: set by the first step and by finalize()
        self.wire = ""
        self.engine_desc = ""
        self.state_devices: tuple = ()
        self.dense = None
        self.dense_state = None
        self.dense_counters = None
        self.keyed: KeyedCounts | None = None
        self.dedup: RandomDedup | None = None
        self.engine = None
        self.engine_step = None
        self._dual_streamed = False  # set by _decode_dual_stream
        self.bitmap = None
        self.hashset = None
        self.hashset_engine = None
        random_dense_ids = (
            plan.scheme.random_barcode
            and plan.dense_sample
            and plan.dense_counted
            # bytemap/hashset modes key on int32 flat ids and keep a
            # dense count tensor; mega-DEL spaces demote to host keyed
            and plan.flat_fits_device
        )
        if (
            n_devices > 1
            and random_dense_ids
            and allow_device_dedup
            and plan.scheme.random_slot.length <= 11
            and os.environ.get(
                "NGS_DEVICE_DEDUP", _device_dedup_default()
            ) == "1"
        ):
            # multi-device random mode: the dedup table shards over the
            # data mesh; triples route to their slot's owner device with
            # one all_to_all per step (parallel/sharded_dedup.py)
            import jax
            import jax.numpy as jnp
            from jax.sharding import Mesh

            from ngs_barcode_count_tpu.parallel.sharded_dedup import (
                ShardedHashsetEngine,
            )

            devs = devices if devices is not None else jax.devices()
            mesh = Mesh(np.array(devs[:n_devices]), ("data",))
            n_slots = _dedup_table_slots()
            if not os.environ.get("NGS_DEDUP_TABLE_SLOTS"):
                # per-device budget -> total across the data mesh; global
                # slot ids are int32 (parallel/sharded_dedup.py)
                n_slots = min(n_slots * n_devices, MAX_SHARDED_SLOTS)
            self.dense = DenseCounts(plan.n_samples, plan.combo_radix)
            self.hashset_engine = ShardedHashsetEngine.build(
                plan, mesh, n_slots
            )
            (self.hashset, self.dense_state, self.dense_counters) = (
                self.hashset_engine.initial_state()
            )
            self._overflow = OverflowDedup()
            self._cap_boost = False
            return
        device_random_ok = n_devices == 1 and random_dense_ids
        if device_random_ok and allow_bitmap and _bitmap_fits(plan):
            # fully-device random-barcode mode: dedup bytemap on HBM, no
            # host-side key traffic at all (SURVEY.md section 7, item 6)
            import jax.numpy as jnp

            c6 = 6 ** plan.scheme.random_slot.length
            n_bytes = plan.n_samples * plan.n_combos * c6
            self.dense = DenseCounts(plan.n_samples, plan.combo_radix)
            self.bitmap = jnp.zeros(n_bytes, jnp.uint8)
            self.dense_counters = jnp.zeros(stats.NUM_COUNTERS, jnp.int32)
            return
        if (
            device_random_ok
            and allow_device_dedup
            and plan.scheme.random_slot.length <= 11  # 6^Lr < 2^31
            and os.environ.get(
                "NGS_DEVICE_DEDUP", _device_dedup_default()
            ) == "1"
        ):
            # combo space too large for the exact bytemap: open-addressing
            # fingerprint table on device (ops/decode.py hash-set dedup),
            # sized from free HBM; host only sees probe-overflow rows
            import jax.numpy as jnp

            n_slots = _dedup_table_slots()
            self.dense = DenseCounts(plan.n_samples, plan.combo_radix)
            self.hashset = jnp.zeros(n_slots, jnp.uint32)
            self.dense_state = jnp.zeros(
                plan.n_samples * plan.n_combos, jnp.int32
            )
            self.dense_counters = jnp.zeros(stats.NUM_COUNTERS, jnp.int32)
            self._overflow = OverflowDedup()
            self._cap_boost = False
            return
        if plan.dense_counts:
            self.dense = DenseCounts(plan.n_samples, plan.combo_radix)
            import jax.numpy as jnp

            if n_devices > 1:
                from ngs_barcode_count_tpu.parallel import mesh as pmesh

                if n_devices % n_model:
                    raise ValueError(
                        f"--devices {n_devices} not divisible by "
                        f"--model-shards {n_model}"
                    )
                mesh = pmesh.make_mesh(
                    n_devices // n_model, n_model, self.devices
                )
                self.engine = pmesh.ShardedDenseEngine.build(plan, mesh)
                self.dense_state, self.dense_counters = (
                    self.engine.initial_state()
                )
                self.engine_step = self.engine.make_step()
            else:
                self.dense_state = self.dense.initial()
                self.dense_counters = jnp.zeros(stats.NUM_COUNTERS, jnp.int32)
        else:
            self.keyed = KeyedCounts()
            if plan.scheme.random_barcode and not triple_mode:
                # triple mode keeps whole triples in KeyedCounts instead;
                # the cross-host union at flush is the dedup
                self.dedup = RandomDedup()

    def _throttle(self) -> None:
        """Bound the async dispatch frontier of the DENSE paths.

        jax dispatch is eager and gives the host no backpressure: when
        ingest outruns the device, the whole input can be dispatched
        long before the device finishes, so (a) checkpoint snapshots —
        which wait on device values — land only at run end, (b) a kill
        loses the whole in-flight backlog, and (c) host RAM stages
        gigabytes of pending transfers.  Every STRIDE batches this
        blocks on the counter vector from DEPTH batches ago (6 ints),
        so the frontier stays ~DEPTH batches ahead — deep enough to
        pipeline transfers, shallow enough that snapshots and kills are
        near-current.  NGS_DISPATCH_DEPTH=0 disables."""
        if self.dense_counters is None:
            return
        if not hasattr(self, "_inflight_tokens"):
            from collections import deque

            self._inflight_tokens = deque()
            self._throttle_count = 0
            self._throttle_depth = int(
                os.environ.get("NGS_DISPATCH_DEPTH", 32)
            )
            self._throttle_stride = max(
                int(os.environ.get("NGS_DISPATCH_STRIDE", 8)), 1
            )
        depth = self._throttle_depth
        stride = self._throttle_stride
        if depth <= 0:
            return
        self._throttle_count += 1
        if self._throttle_count % stride:
            return
        # a DERIVED scalar, not the chained buffer: later steps donate
        # the live counters and would delete a held reference
        if not hasattr(self, "_throttle_sum"):
            import jax

            self._throttle_sum = jax.jit(lambda c: c.sum())
        self._inflight_tokens.append(self._throttle_sum(self.dense_counters))
        while len(self._inflight_tokens) > max(depth // stride, 1):
            np.asarray(self._inflight_tokens.popleft())

    def _shard_packed(self, pb) -> None:
        """Multi-device keyed/bitmap runs: place batch rows sharded over
        the data mesh so jit partitions the step across chips."""
        if self.shardings is None:
            return
        import jax

        sh = self.shardings
        pb.packed = jax.device_put(pb.packed, sh["rows2"])
        pb.lengths = jax.device_put(np.asarray(pb.lengths), sh["rows1"])
        pb.exc_idx = jax.device_put(pb.exc_idx, sh["repl"])
        pb.exc_val = jax.device_put(pb.exc_val, sh["repl"])
        if pb.quals is not None:
            pb.quals = jax.device_put(pb.quals, sh["rows2"])

    def _untranspose(self, pb) -> None:
        """Column-major wire batches (NGS_WIRE_LAYOUT=col) transpose back
        on device: the link transfer already happened in the
        compression-friendly layout; the device-side transpose is a
        ~0.1ms copy."""
        if not getattr(pb, "transposed", False):
            return
        if not hasattr(self, "_untranspose_fn"):
            import jax

            self._untranspose_fn = jax.jit(lambda p: p.T)
        pb.packed = self._untranspose_fn(pb.packed)
        if getattr(pb, "quals_packed", None) is not None:
            pb.quals_packed = self._untranspose_fn(pb.quals_packed)
        pb.transposed = False

    def _ensure_raw_quals(self, pb) -> None:
        """4-bit quality wire -> the raw [B, W] int8 Phred tensor ON
        DEVICE (one tiny jit; the codebook gather reconstructs the
        identical tensor) for every step.  The wire saving already
        happened: quals_packed crossed the link at 4 bits/base."""
        if getattr(pb, "quals_packed", None) is None:
            return
        pb.quals = dec.unpack_quals_wire(
            pb.quals_packed, pb.qual_codebook, pb.width,
            getattr(pb, "qual_bits", 4) or 4,
        )
        pb.quals_packed = None
        pb.qual_codebook = None

    def _lengths_dev(self, lengths: np.ndarray):
        """Illumina batches usually have one uniform read length: cache
        the device copy per (value, batch) so repeat batches ship zero
        length bytes over the host-device link."""
        if len(lengths) == 0 or lengths[0] != lengths[-1]:
            return lengths
        v = int(lengths[0])
        if not (lengths == v).all():
            return lengths
        key = (v, len(lengths), lengths.dtype.str)
        if not hasattr(self, "_len_cache"):
            self._len_cache = {}
        dev = self._len_cache.get(key)
        if dev is None:
            import jax

            dev = jax.device_put(lengths)
            self._len_cache[key] = dev
        return dev

    def _engine_packed_step_for(self, width: int, with_quals: bool):
        if not hasattr(self, "_engine_packed_steps"):
            self._engine_packed_steps = {}
        key = (width, with_quals)
        if key not in self._engine_packed_steps:
            self._engine_packed_steps[key] = self.engine.make_packed_step(
                width, with_quals
            )
        return self._engine_packed_steps[key]

    def step_packed(self, pb) -> None:
        """Wire-format fast path (dense mode): 2-bit packed bases go
        straight to the device; quality ships as the 4-bit codebook wire
        when the gate is on and is expanded on device.  Multi-device
        dense runs keep the same wire format: rows shard over the mesh's
        data axis and each device decodes its shard."""
        self.wire = self.wire or describe_wire("step_packed", pb)
        plan = self.plan
        n = np.array([pb.n_reads], np.int32)
        self._untranspose(pb)
        # NGS_QUAL_WIRE=host: config-3's two-phase gate — quality bytes
        # never cross the link; a 2B/read gate wire comes down, the host
        # evaluates the segment means on its raw Phred bytes, and a
        # 1-bit/read mask goes back up (ops.decode.dense_gate_*)
        if (
            plan.min_quality > 0.0
            and getattr(pb, "qual_mode", None) == "host"
            and plan.dense_counts
            and getattr(pb, "quals", None) is not None
            and getattr(pb, "quals_packed", None) is None
            and isinstance(pb.quals, np.ndarray)
            and self.hashset_engine is None
            and self.hashset is None
            and self.engine is None
            and self.bitmap is None
            and self.shardings is None
            and pb.width - plan.scheme.length <= 127
        ):
            self._step_packed_gate(pb, n)
            return
        self._ensure_raw_quals(pb)
        if self.hashset_engine is not None:
            if not hasattr(self, "_hse_steps"):
                self._hse_steps = {}
            B = pb.packed.shape[0]
            # saturated-table mode: lossless overflow buffers (every new
            # triple routes to the exact host path; see _harvest_overflow)
            cap_over = (
                self.hashset_engine.lossless_cap(B)
                if self._cap_boost else None
            )
            key = (pb.width, pb.quals is not None, B, cap_over,
                   dec._dedup_variant())
            step = self._hse_steps.get(key)
            if step is None:
                step = self.hashset_engine.make_packed_step(
                    pb.width, pb.quals is not None, B, cap_over=cap_over
                )
                self._hse_steps[key] = step
            exc_i, exc_v = self.hashset_engine.split_exceptions(
                np.asarray(pb.exc_idx), np.asarray(pb.exc_val),
                B, pb.width,
            )
            (self.hashset, self.dense_state, self.dense_counters,
             over, n_over) = step(
                self.hashset, self.dense_state, self.dense_counters,
                pb.packed, np.asarray(pb.lengths), exc_i, exc_v, n,
                pb.quals,
            )
            self._push_overflow(over, n_over, pb)
            return
        if self.hashset is not None:
            cap = (
                pb.packed.shape[0]
                if self._cap_boost
                else max(pb.packed.shape[0] // 8, 1024)
            )
            pb.lengths = self._lengths_dev(pb.lengths)
            if pb.quals is not None:
                (self.hashset, self.dense_state, self.dense_counters,
                 over, n_over) = dec.random_hashset_step_packed_q(
                    plan, self.hashset, self.dense_state,
                    self.dense_counters, pb.packed, pb.lengths, pb.exc_idx,
                    pb.exc_val, pb.quals, pb.width, cap, n,
                    dec._dedup_variant(),
                )
            else:
                (self.hashset, self.dense_state, self.dense_counters,
                 over, n_over) = dec.random_hashset_step_packed(
                    plan, self.hashset, self.dense_state,
                    self.dense_counters, pb.packed, pb.lengths, pb.exc_idx,
                    pb.exc_val, pb.width, cap, n, dec._dedup_variant(),
                )
            self._push_overflow(over, n_over, pb)
            return
        if self.engine is not None:
            step = self._engine_packed_step_for(
                pb.width, pb.quals is not None
            )
            exc_i, exc_v = self.engine.split_exceptions(
                np.asarray(pb.exc_idx), np.asarray(pb.exc_val),
                pb.packed.shape[0], pb.width,
            )
            self.dense_state, self.dense_counters = step(
                self.dense_state, self.dense_counters, pb.packed,
                np.asarray(pb.lengths), exc_i, exc_v, n, pb.quals,
            )
            return
        pb.lengths = self._lengths_dev(pb.lengths)
        self._shard_packed(pb)
        if self.bitmap is not None:
            if pb.quals is not None:
                self.bitmap, self.dense_counters = (
                    dec.random_bitmap_step_packed_q(
                        plan, self.bitmap, self.dense_counters, pb.packed,
                        pb.lengths, pb.exc_idx, pb.exc_val, pb.quals,
                        pb.width, n,
                    )
                )
            else:
                self.bitmap, self.dense_counters = (
                    dec.random_bitmap_step_packed(
                        plan, self.bitmap, self.dense_counters, pb.packed,
                        pb.lengths, pb.exc_idx, pb.exc_val, pb.width, n,
                    )
                )
            return
        if pb.quals is not None:
            self.dense_state, self.dense_counters = (
                dec.dense_count_step_packed_q(
                    plan, self.dense_state, self.dense_counters, pb.packed,
                    pb.lengths, pb.exc_idx, pb.exc_val, pb.quals, pb.width, n,
                )
            )
        else:
            self.dense_state, self.dense_counters = (
                dec.dense_count_step_packed(
                    plan, self.dense_state, self.dense_counters, pb.packed,
                    pb.lengths, pb.exc_idx, pb.exc_val, pb.width, n,
                )
            )

    def _step_packed_gate(self, pb, n) -> None:
        """Dispatch phase A of the host-side quality gate and pipeline
        the harvest (gate-wire fetch + host segment means + phase B)
        ~2M reads deep, like _push_overflow, so the d2h round trip
        rides under later batches' uploads."""
        pb.lengths = self._lengths_dev(pb.lengths)
        out = dec.dense_gate_probe_packed(
            self.plan, pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
            pb.width, n,
        )
        try:
            out["wire"].copy_to_host_async()
        except Exception:
            pass
        if not hasattr(self, "_pending_gate"):
            from collections import deque

            self._pending_gate = deque()
        rows = int(out["wire"].shape[0]) or 1
        depth = max(2, (1 << 21) // rows)
        self._pending_gate.append((out, pb.quals))
        while len(self._pending_gate) > depth:
            self._harvest_gate(*self._pending_gate.popleft())

    def _harvest_gate(self, out, quals) -> None:
        wire = np.asarray(out["wire"])
        qual_start = wire[:, 0].astype(np.int64)
        cls = wire[:, 1]
        applies = (cls >= 1) & (cls <= 3)
        lowq = dec.host_lowq_mask(self.plan, quals, qual_start, applies)
        bits = np.packbits(lowq, bitorder="little")
        self.dense_state, self.dense_counters = dec.dense_gate_apply(
            self.plan, self.dense_state, self.dense_counters,
            out["flat"], out["cls"], bits,
        )

    def _push_overflow(self, over, n_over, pb=None) -> None:
        """Pipeline the (rare) hash-set overflow fetch deep enough that
        the d2h sync never stalls the h2d stream: a constant ~2M reads
        of lookahead (depth scales inversely with batch size; the
        buffers are cap = batch/8 rows, so the queue holds ~2MB on
        device regardless of batch size).  A shallow queue makes each
        harvest's scalar fetch interrupt the transfer pipeline.

        ``pb`` (the source batch) rides along so a saturating batch can
        be replayed losslessly (see _replay_saturated).  Each pending
        entry therefore pins its source batch in host RAM (packed wire
        + quality bytes); NGS_OVERFLOW_PIN_MB (default 256) bounds the
        total — when quality-gated batches are heavy, the queue
        harvests oldest-first early (shallower lookahead, bounded RSS)
        rather than pinning depth x batch bytes."""
        if not hasattr(self, "_pending_over"):
            from collections import deque

            self._pending_over = deque()
            self._pending_pin_bytes = 0
        rows = int(np.shape(over)[-2]) or 1  # cap = batch/8
        depth = max(2, (1 << 21) // (rows * 8))
        budget = int(
            os.environ.get("NGS_OVERFLOW_PIN_MB", 256)
        ) << 20
        self._pending_over.append((over, n_over, pb))
        self._pending_pin_bytes += _batch_pin_bytes(pb)
        while len(self._pending_over) > depth or (
            self._pending_pin_bytes > budget and len(self._pending_over) > 2
        ):
            entry = self._pending_over.popleft()
            self._pending_pin_bytes -= _batch_pin_bytes(entry[2])
            self._harvest_overflow(*entry)

    def _harvest_overflow(self, over, n_over, pb=None) -> None:
        """Exact host classification of probe-overflow triples: slots
        never free, so every occurrence of an overflowed triple reaches
        here and the host set is the complete truth for them.  Accepts
        the sharded engine's per-device stacks too ([n_dev, cap, 2] /
        [n_dev, 1]).

        Overflow counts beyond the buffer cap (a saturated table) do NOT
        abort the run: the saturating batch replays through a
        lossless-capacity step — replay is state-idempotent (triples the
        first pass inserted dedup as fingerprint hits; the counter delta
        is discarded), so only the complete overflow row set is consumed
        — and all later batches run with lossless buffers, which makes
        the host set the exact dedup authority for every new triple."""
        n_arr = np.asarray(n_over).reshape(-1)
        if np.asarray(over).ndim == 3:
            over_np = np.asarray(over)
            cap = over_np.shape[1]
            if (n_arr > cap).any():
                over_np, n_arr = self._replay_saturated(pb)
            for d in range(over_np.shape[0]):
                self._harvest_overflow(over_np[d], n_arr[d : d + 1])
            return
        n = int(n_arr[0])
        if n == 0:
            return
        cap = over.shape[0]
        if n > cap:
            over, n_arr = self._replay_saturated(pb)
            n = int(n_arr[0])
        rows = np.asarray(over[:n])
        c6 = 6 ** self.plan.scheme.random_slot.length
        keys = rows[:, 0].astype(np.uint64) * np.uint64(c6) + rows[
            :, 1
        ].astype(np.uint64)
        n_new, n_dup = self._overflow.observe(rows[:, 0], keys)
        self.seq_errors.correct_match(n_new)
        self.seq_errors.duplicated(n_dup)

    def _replay_saturated(self, pb):
        """Lossless recovery from a saturated dedup table (reference
        semantics info.rs:770-801 must stay exact; VERDICT r2 weak #5).

        One batch overflowed more rows than its compacted buffer holds,
        so rows past the cap never reached the host.  Re-running the
        SAME batch is safe and exact:

        - triples the first pass inserted now fingerprint-hit (slots
          never free), so the count scatter adds zero and the table is
          unchanged;
        - triples that overflowed overflow again (their probe windows
          only ever get fuller), so a replay with a batch-sized buffer
          captures the complete overflow row set;
        - the replay's counter delta is garbage (everything re-counts as
          duplicate) and is discarded via a scratch counter vector.

        After recovery every future step runs with lossless buffers
        (_cap_boost), so saturation can never drop a row again — the
        run degrades to more d2h traffic, not to an abort.

        Returns (over_rows, n_over) shaped like the step outputs."""
        if pb is None:  # flush-time entries always carry their batch
            raise RuntimeError(
                "dedup hash table overflow without a replayable batch: "
                "raise NGS_DEDUP_TABLE_SLOTS or set NGS_DEVICE_DEDUP=0"
            )
        import jax.numpy as jnp

        if not self._cap_boost:
            print(
                "dedup table saturated: replaying the batch losslessly "
                "and switching to lossless overflow buffers (exact host "
                "dedup takes over for new triples; consider raising "
                "NGS_DEDUP_TABLE_SLOTS)",
                file=sys.stderr,
            )
            self._cap_boost = True
        if not hasattr(pb, "packed"):  # unpacked ReadBatch fallback path
            scratch = jnp.zeros(stats.NUM_COUNTERS, jnp.int32)
            (self.hashset, self.dense_state, _discard, over, n_over) = (
                dec.random_hashset_step_unpacked(
                    self.plan, self.hashset, self.dense_state, scratch,
                    pb.bases, pb.quals, pb.lengths, pb.read_mask,
                    pb.bases.shape[0], dec._dedup_variant(),
                )
            )
            return np.asarray(over), np.asarray(n_over).reshape(-1)
        n = np.array([pb.n_reads], np.int32)
        B = pb.packed.shape[0]
        if self.hashset_engine is not None:
            eng = self.hashset_engine
            if not hasattr(self, "_hse_steps"):
                self._hse_steps = {}
            key = (pb.width, pb.quals is not None, B,
                   eng.lossless_cap(B), dec._dedup_variant())
            step = self._hse_steps.get(key)
            if step is None:
                step = eng.make_packed_step(
                    pb.width, pb.quals is not None, B, cap_over=key[3]
                )
                self._hse_steps[key] = step
            exc_i, exc_v = eng.split_exceptions(
                np.asarray(pb.exc_idx), np.asarray(pb.exc_val), B, pb.width
            )
            scratch = eng.zero_counters()
            (self.hashset, self.dense_state, _discard, over, n_over) = step(
                self.hashset, self.dense_state, scratch, pb.packed,
                np.asarray(pb.lengths), exc_i, exc_v, n, pb.quals,
            )
            return np.asarray(over), np.asarray(n_over).reshape(-1)
        scratch = jnp.zeros(stats.NUM_COUNTERS, jnp.int32)
        if pb.quals is not None:
            (self.hashset, self.dense_state, _discard, over, n_over) = (
                dec.random_hashset_step_packed_q(
                    self.plan, self.hashset, self.dense_state, scratch,
                    pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
                    pb.quals, pb.width, B, n, dec._dedup_variant(),
                )
            )
        else:
            (self.hashset, self.dense_state, _discard, over, n_over) = (
                dec.random_hashset_step_packed(
                    self.plan, self.hashset, self.dense_state, scratch,
                    pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
                    pb.width, B, n, dec._dedup_variant(),
                )
            )
        return np.asarray(over), np.asarray(n_over).reshape(-1)

    def step(self, batch: batcher_mod.ReadBatch) -> None:
        self.wire = self.wire or describe_wire("step", batch)
        plan = self.plan
        if self.hashset is not None:
            cap = (
                batch.bases.shape[0]
                if self._cap_boost
                else max(batch.bases.shape[0] // 8, 1024)
            )
            (self.hashset, self.dense_state, self.dense_counters,
             over, n_over) = dec.random_hashset_step_unpacked(
                plan, self.hashset, self.dense_state, self.dense_counters,
                batch.bases, batch.quals, batch.lengths, batch.read_mask,
                cap, dec._dedup_variant(),
            )
            self._push_overflow(over, n_over, batch)
            return
        if self.bitmap is not None:
            self.bitmap, self.dense_counters = dec.random_bitmap_step(
                plan, self.bitmap, self.dense_counters, batch.bases,
                batch.quals, batch.lengths, batch.read_mask,
            )
            return
        if self.engine is not None:
            sb, sq, sl, sm = self.engine.shard_batch(
                batch.bases, batch.quals, batch.lengths, batch.read_mask
            )
            self.dense_state, self.dense_counters = self.engine_step(
                self.dense_state, self.dense_counters, sb, sq, sl, sm
            )
            return
        if self.dense is not None:
            self.dense_state, self.dense_counters = dec.dense_count_step(
                plan,
                self.dense_state,
                self.dense_counters,
                batch.bases,
                batch.quals,
                batch.lengths,
                batch.read_mask,
            )
            return
        out = dec.keyed_decode_step(
            plan, batch.bases, batch.quals, batch.lengths, batch.read_mask
        )
        key_cols = self._key_columns(out)
        rnd = (
            pack_codes(np.asarray(out["random_codes"]))
            if "random_codes" in out
            else None
        )
        self._accumulate_keyed(out, key_cols, rnd)

    @staticmethod
    def _combine_words(words: np.ndarray) -> np.ndarray:
        """[B, n_words] int32 (30 bits each) -> [B] uint64, matching
        counting.pack_codes' 3-bit layout."""
        words = np.asarray(words).astype(np.uint64)
        out = np.zeros(words.shape[0], np.uint64)
        for j in range(words.shape[1]):
            out |= words[:, j] << np.uint64(30 * j)
        return out

    def step_packed_keyed(self, pb) -> None:
        """Wire-format keyed step: packed bases up, ONE int32 wire matrix
        down.  Dispatch is pipelined two batches deep: the previous
        batch's wire fetch (device-to-host, started async right after
        dispatch) and its host-side key accumulation overlap the current
        batch's upload + decode, so the loop pays max(link, decode,
        host), not their sum."""
        self.wire = self.wire or describe_wire("step_packed_keyed", pb)
        plan = self.plan
        n = np.array([pb.n_reads], np.int32)
        self._untranspose(pb)
        self._ensure_raw_quals(pb)
        pb.lengths = self._lengths_dev(pb.lengths)
        self._shard_packed(pb)
        if pb.quals is not None:
            out = dec.keyed_decode_step_packed_q(
                plan, pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
                pb.quals, pb.width, n,
            )
        else:
            out = dec.keyed_decode_step_packed(
                plan, pb.packed, pb.lengths, pb.exc_idx, pb.exc_val,
                pb.width, n,
            )
        try:  # start the d2h copy now; harvest reads it when ready
            out["wire"].copy_to_host_async()
        except Exception:
            pass
        if not hasattr(self, "_pending_keyed"):
            from collections import deque

            self._pending_keyed = deque()
        # Constant ~2M reads of lookahead (like _push_overflow): at small
        # batch sizes a fixed 2-deep queue forces one blocking d2h per
        # ~2 batches, stalling the h2d stream it shares with uploads.
        # Wire rows are <=16B/read, so the queue holds <=32MB on device.
        rows = int(out["wire"].shape[0]) or 1
        depth = max(2, (1 << 21) // rows)
        self._pending_keyed.append(out)
        while len(self._pending_keyed) > depth:
            self._harvest_keyed(self._pending_keyed.popleft())

    def flush_pending(self) -> None:
        """Drain pipelined keyed batches and hash-set overflow fetches
        (end of run, or before a checkpoint snapshot so saved state
        matches the saved offset)."""
        pend = getattr(self, "_pending_keyed", None)
        while pend:
            self._harvest_keyed(pend.popleft())
        pend = getattr(self, "_pending_gate", None)
        while pend:
            self._harvest_gate(*pend.popleft())
        pend = getattr(self, "_pending_over", None)
        while pend:
            self._harvest_overflow(*pend.popleft())
        self._pending_pin_bytes = 0

    def _harvest_keyed(self, out) -> None:
        plan = self.plan
        wire = np.asarray(out["wire"])  # the one big fetch
        layout = dec.keyed_wire_layout(plan)

        def span(key):
            s, w = layout[key][:2]
            return wire[:, s : s + w]

        cols: list[np.ndarray] = []
        if "fused" in layout:
            _, _, s_bits, c_bits = layout["fused"]
            col0 = wire[:, 0]
            valid = (col0 >> (s_bits + c_bits)).astype(bool)
            cols.append(
                ((col0 >> c_bits) & ((1 << s_bits) - 1)).astype(np.uint64)
            )
            cols.append((col0 & ((1 << c_bits) - 1)).astype(np.uint64))
            rnd = (
                self._combine_words(span("random_words"))
                if "random_words" in layout
                else None
            )
            self._accumulate_keyed(
                {"counters": out["counters"], "valid": valid}, cols, rnd
            )
            return

        valid = span("valid")[:, 0].astype(bool)
        if "sample_words" in layout:
            cols.append(self._combine_words(span("sample_words")))
        elif "sample_idx" in layout:
            cols.append(span("sample_idx")[:, 0].astype(np.uint64))
        else:  # no sample region: constant index 0
            cols.append(np.zeros(len(valid), np.uint64))
        if "combo_flat" in layout:
            cols.append(span("combo_flat")[:, 0].astype(np.uint64))
        elif "counted_idx" in layout:
            for s, _ in layout["counted_idx"]:
                cols.append(wire[:, s].astype(np.uint64))
        else:
            for s, w in layout["counted_words"]:
                cols.append(self._combine_words(wire[:, s : s + w]))
        rnd = (
            self._combine_words(span("random_words"))
            if "random_words" in layout
            else None
        )
        self._accumulate_keyed(
            {"counters": out["counters"], "valid": valid}, cols, rnd
        )

    @property
    def _sc_bits(self):
        """Combo bit-width when dense (sample, combo) key pairs pack into
        ONE uint64 column (the hot random-barcode DEL case): every host
        set-operation then runs on 1-D arrays.  None = unpackable or
        multi-host triple mode (whose merge needs separate columns)."""
        if getattr(self, "_sc_bits_cache", -1) != -1:
            return self._sc_bits_cache
        bits = None
        plan = self.plan
        if (
            not self.triple_mode
            and plan.dense_sample
            and plan.dense_counted
        ):
            s_bits = max(int(plan.n_samples - 1).bit_length(), 1)
            c_bits = max(int(plan.n_combos - 1).bit_length(), 1)
            if s_bits + c_bits <= 63:
                bits = c_bits
        self._sc_bits_cache = bits
        return bits

    def _accumulate_keyed(self, out, key_cols, rnd) -> None:
        self.seq_errors.add_vector(np.asarray(out["counters"]))
        valid = np.asarray(out["valid"])
        if self.triple_mode and rnd is not None:
            # MATCHED/DUPLICATES stay 0 until the cross-host triple union
            self.triple_valid += int(valid.sum())
            self.keyed.add_batch(key_cols + [rnd], valid)
            return
        sc_bits = self._sc_bits
        if sc_bits is not None and len(key_cols) == 2:
            key_cols = [
                (np.asarray(key_cols[0], np.uint64) << np.uint64(sc_bits))
                | np.asarray(key_cols[1], np.uint64)
            ]
        if self.dedup is not None and rnd is not None:
            new_mask = self.dedup.observe(key_cols + [rnd], valid)
            n_valid = int(valid.sum())
            n_new = int(new_mask.sum())
            self.seq_errors.correct_match(n_new)
            self.seq_errors.duplicated(n_valid - n_new)
            self.keyed.add_batch(key_cols, new_mask)
        else:
            self.seq_errors.correct_match(int(valid.sum()))
            self.keyed.add_batch(key_cols, valid)

    def _intern_codes(self, tag: str, codes: np.ndarray) -> np.ndarray:
        """Slots longer than 21nt cannot be 3-bit packed reversibly: map
        each distinct sequence to a stable id via a host dict (the
        bar-seq long-lineage-barcode case) and decode through
        interned_sequences at flush."""
        if not hasattr(self, "_interned"):
            self._interned: dict[str, dict[bytes, int]] = {}
            self._interned_rev: dict[str, list[np.ndarray]] = {}
        table = self._interned.setdefault(tag, {})
        rev = self._interned_rev.setdefault(tag, [])
        rows = np.ascontiguousarray(codes)
        uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
        ids = np.empty(len(uniq), np.uint64)
        for i, row in enumerate(uniq):
            key = row.tobytes()
            idx = table.get(key)
            if idx is None:
                idx = len(rev)
                table[key] = idx
                rev.append(row.copy())
            ids[i] = idx
        return ids[inverse]

    def interned_sequences(self, tag: str, idx: int) -> np.ndarray:
        return self._interned_rev[tag][idx]

    def _key_columns(self, out) -> list[np.ndarray]:
        cols: list[np.ndarray] = []
        scheme = self.plan.scheme
        if "sample_codes" in out:
            codes = np.asarray(out["sample_codes"])
            if codes.shape[1] <= 21:
                cols.append(pack_codes(codes))
            else:
                cols.append(self._intern_codes("sample", codes))
        else:
            cols.append(np.asarray(out["sample_idx"]).astype(np.uint64))
        if "combo_flat" in out:
            cols.append(np.asarray(out["combo_flat"]).astype(np.uint64))
        elif "counted_idx" in out:
            for idx in out["counted_idx"]:
                cols.append(np.asarray(idx).astype(np.uint64))
        else:
            for j, codes in enumerate(out["counted_codes"]):
                codes = np.asarray(codes)
                if codes.shape[1] <= 21:
                    cols.append(pack_codes(codes))
                else:
                    cols.append(self._intern_codes(f"bc{j}", codes))
        return cols

    # -- finalization ------------------------------------------------------

    def finalize(self) -> None:
        """Block on outstanding device work, psum the sharded state if a
        mesh engine is active, and fold the device counter vector into the
        host stats (once per run, not per batch)."""
        self.engine_desc = self.describe_engine()
        if hasattr(self.dense_state, "addressable_shards"):
            self.state_devices = tuple(sorted(
                {s.device.id for s in self.dense_state.addressable_shards}
            ))
        self.flush_pending()
        if self.hashset_engine is not None:
            counts, counters = self.hashset_engine.merge(
                self.dense_state, self.dense_counters
            )
            arr = np.asarray(counts).astype(np.int64)
            for f, c in self._overflow.counts.items():
                arr[f] += c
            self.dense_state = arr
            self.seq_errors.add_vector(np.asarray(counters))
            self.dense_counters = None
            self.hashset = None
            self.hashset_engine = None
            return
        if self.hashset is not None:
            arr = np.asarray(self.dense_state).astype(np.int64)
            for f, c in self._overflow.counts.items():
                arr[f] += c
            self.dense_state = arr
            self.seq_errors.add_vector(np.asarray(self.dense_counters))
            self.dense_counters = None
            self.hashset = None
            return
        if self.bitmap is not None:
            # popcount of the dedup bytemap IS the matched count; the
            # device MATCHED slot held valid reads until now
            self.dense_state = dec.random_bitmap_counts(
                self.plan, self.bitmap
            )
            ctr = np.asarray(self.dense_counters).copy()
            new_total = int(np.asarray(self.dense_state).sum())
            valid_total = int(ctr[stats.MATCHED])
            ctr[stats.MATCHED] = new_total
            ctr[stats.DUPLICATES] = valid_total - new_total
            self.seq_errors.add_vector(ctr)
            self.dense_counters = None
            self.bitmap = None
            return
        if self.engine is not None:
            self.dense_state, self.dense_counters = self.engine.merge(
                self.dense_state, self.dense_counters
            )
            self.engine = None  # merged: results_view uses the flat tensor
        if self.dense_counters is not None:
            self.seq_errors.add_vector(np.asarray(self.dense_counters))

    def describe_engine(self) -> str:
        """The count engine this accumulator runs (before finalize)."""
        if self.hashset_engine is not None:
            e = self.hashset_engine
            return (f"sharded hash-set dedup ({e.n_data} devices x "
                    f"{e.s_local} slots)")
        if self.hashset is not None:
            return f"device hash-set dedup ({self.hashset.shape[0]} slots)"
        if self.bitmap is not None:
            return "device dedup bytemap"
        if self.engine is not None:
            return (f"sharded dense (data {self.engine.n_data} x model "
                    f"{self.engine.n_model})")
        if self.dense is not None:
            lanes = " (dual-stream lanes)" if self._dual_streamed else ""
            return "dense count tensor" + lanes
        dedup = " + host dedup" if self.dedup is not None else ""
        return "host keyed" + dedup

    def _sample_key_of_index(self, idx: int) -> str:
        if self.plan.scheme.sample_slot is None:
            return "barcode"
        return self.conv.sample_set.sequences[idx]

    def results_view(self, lazy_dense: bool = False) -> ResultsView:
        """Final counts as ResultsView.  ``lazy_dense=True`` (the output
        path) skips materializing per-combo dicts when the dense tensor
        is present AND the writer's dense fast path can consume it
        directly (counted conversion file present) — per_sample then
        carries only the pre-seeded sample keys."""
        plan = self.plan
        per_sample: dict[str, dict[str, int]] = {}
        # Pre-seed sample keys like Results::new (info.rs:697-719): all
        # samples from the file, or the literal "barcode" key.
        if self.conv.has_sample_file:
            for sb in self.conv.samples_barcode_hash:
                per_sample[sb] = {}
        elif plan.scheme.sample_slot is None:
            per_sample["barcode"] = {}

        if self.dense is not None:
            arr = self.dense.to_numpy(self.dense_state)
            n_samples, _ = arr.shape
            skip_fill = lazy_dense and bool(self.conv.counted_barcodes_hash)
            sample_keys = []
            for s in range(n_samples):
                key = self._sample_key_of_index(s)
                sample_keys.append(key)
                if skip_fill:
                    per_sample.setdefault(key, {})
                    continue
                nz = np.flatnonzero(arr[s])
                if len(nz) == 0:
                    per_sample.setdefault(key, {})
                    continue
                idxs = self.dense.unflatten_combo(nz.copy())
                combos = per_sample.setdefault(key, {})
                for row in range(len(nz)):
                    code = ",".join(
                        self.conv.counted_sets[j].sequences[int(idxs[j][row])]
                        for j in range(len(idxs))
                    )
                    combos[code] = int(arr[s, nz[row]])
            return ResultsView(
                per_sample,
                dense_arr=arr.reshape(
                    (n_samples,) + tuple(plan.combo_radix)
                ),
                dense_sample_keys=sample_keys,
            )

        # keyed mode: unpack 3-bit keys back to DNA strings (interned
        # ids for slots longer than 21nt)
        scheme = plan.scheme
        slot_lengths = [s.length for s in scheme.barcode_slots]

        def _slot_str(tag, part, length):
            if length <= 21:
                return dna.decode(
                    dna.unpack_3bit(np.array(part, dtype=np.uint64), length)
                )
            return dna.decode(self.interned_sequences(tag, int(part)))

        sc_bits = self._sc_bits
        for key, count in self.keyed.counts.items():
            if sc_bits is not None and len(key) == 1:
                sc = int(key[0])
                key = (sc >> sc_bits, sc & ((1 << sc_bits) - 1))
            sample_part, rest = key[0], key[1:]
            if plan.dense_sample:
                skey = self._sample_key_of_index(int(sample_part))
            else:
                skey = _slot_str(
                    "sample", sample_part, scheme.sample_slot.length
                )
            if plan.dense_counted:
                if plan.combo_fits_i32:
                    idxs = []
                    flat = int(rest[0])
                    for n in reversed(plan.combo_radix):
                        idxs.append(flat % n)
                        flat //= n
                    idxs = list(reversed(idxs))
                else:  # mega-DEL wire: per-position indices already
                    idxs = [int(r_) for r_ in rest]
                code = ",".join(
                    self.conv.counted_sets[j].sequences[idxs[j]]
                    for j in range(len(idxs))
                )
            else:
                code = ",".join(
                    _slot_str(f"bc{j}", rest[j], slot_lengths[j])
                    for j in range(len(slot_lengths))
                )
            per_sample.setdefault(skey, {})[code] = count
        return ResultsView(per_sample)


def setup(config: RunConfig):
    """Scheme + conversions + budgets + plan (main.rs:16-65)."""
    scheme = parse_scheme(config.format)
    enrich = config.enrich
    if enrich and scheme.barcode_num < 2:
        print(
            "Fewer than 2 counted barcodes.  Too few for barcode enrichment.  "
            "Argument flag is ignored",
            file=sys.stderr,
        )
        enrich = False
    conv = BarcodeConversions()
    if config.sample_barcodes_option:
        if scheme.sample_slot is None:
            raise ValueError(
                "sample barcode file given but scheme has no sample region [n]"
            )
        conv.load_sample_file(
            config.sample_barcodes_option, scheme.sample_slot.length
        )
    if config.counted_barcodes_option:
        conv.load_counted_file(
            config.counted_barcodes_option, scheme.barcode_num,
            scheme.barcode_lengths,
        )
    max_errors = MaxSeqErrors.create(
        config.sample_errors_option,
        scheme.sample_length,
        config.barcodes_errors_option,
        scheme.barcode_lengths,
        config.constant_errors_option,
        scheme.constant_region_length,
        config.min_average_quality_score,
    )
    plan = dec.make_plan(scheme, conv, max_errors,
                         fix_quirks=config.fix_quirks)
    return scheme, conv, max_errors, plan, enrich


def encoded_chunks(path: str, min_width: int, batch_size: int):
    """FASTQ -> EncodedReads chunks: native C++ codec when built (31x the
    NumPy encoder's throughput), NumPy fallback otherwise — identical
    output either way (tests/test_native_codec.py)."""
    from ngs_barcode_count_tpu.io import native

    if os.environ.get("NGS_FORCE_NUMPY_INGEST") != "1" and native.available():
        return native.read_fastq_native(
            path, min_width=min_width, batch_reads=batch_size
        )
    return fastq_mod.read_fastq(path, min_width=min_width)


def _snap_copy(x):
    """Fresh on-device copy of a donated state buffer: the decode steps
    donate their count/counter arguments, so a background save must not
    hold the live reference (it would be deleted under it).  x + 0
    without donation cannot alias its input, so the result is a new
    buffer; dispatch-only (the fetch happens on the saver thread)."""
    import jax

    if not hasattr(_snap_copy, "_fn"):
        _snap_copy._fn = jax.jit(lambda v: v + 0)
    return _snap_copy._fn(x)


class _AsyncCheckpointer:
    """Background checkpoint writes for DENSE state (immutable jax
    arrays): the quiesce window only captures array references + a
    frontier copy; the d2h fetch and the (atomic tmp+rename) file write
    run on a worker thread, so the decode pipeline never drains at
    snapshot time.  One save in flight at a time — if the previous write
    is still running at the next interval, the snapshot is skipped (the
    following one covers strictly more reads)."""

    def __init__(self) -> None:
        self._thread = None

    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def submit(self, path, snap, front, total, fp, ranges) -> bool:
        if self.busy():
            return False
        import threading

        from ngs_barcode_count_tpu import checkpoint as ckpt

        self._thread = threading.Thread(
            target=ckpt.save,
            args=(path, snap, front, total, fp),
            kwargs={"ranges": ranges},
            daemon=True,
        )
        self._thread.start()
        return True

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()


def _plan_ckpt_ranges(config, checkpointing, start_offset, resume_ranges,
                      byte_range):
    """Reader ranges + checkpoint frontier for a run, shared by the
    single-stream and dual-stream loops.

    Checkpointing keeps ALL T parallel readers (round 2 forced a single
    reader for offset determinism): the frontier is one committed offset
    per reader range, saved together and resumed range by range.
    Returns (ranges, ckpt_ranges, frontier): ``ranges`` = explicit
    reader ranges for this run (None = let the generator plan),
    ``ckpt_ranges`` = the stable ranges recorded in checkpoints,
    ``frontier`` = per-range committed offsets (None = single offset)."""
    from ngs_barcode_count_tpu.io.parallel_ingest import plan_ranges

    ranges = None
    ckpt_ranges = None
    frontier = None
    if resume_ranges is not None:
        saved_rs, saved_offs = resume_ranges
        ckpt_ranges = [
            (int(s), int(e)) for s, e in np.asarray(saved_rs)
        ]
        frontier = [int(o) for o in np.asarray(saved_offs)]
        # each range restarts at its saved frontier; finished
        # ranges (offset >= end) yield nothing but keep their id
        ranges = [
            (off, e) for (s, e), off in zip(ckpt_ranges, frontier)
        ]
    elif checkpointing:
        # start= covers offset-style resumes (single-reader or
        # round-2-era checkpoints): the plan splits the REMAINDER
        # [start_offset, size) across the pool — planning the whole
        # file here would re-read the checkpointed prefix and
        # double-count it (and start_offset is ignored by the
        # generator whenever explicit ranges are passed).  Multi-host
        # runs plan inside THIS host's byte range so the per-range
        # frontier machinery works unchanged.
        if byte_range is not None:
            ckpt_ranges = plan_ranges(
                config.fastq, config.threads,
                start=byte_range[0], end=byte_range[1],
            ) or ([byte_range] if byte_range[1] > byte_range[0]
                  else [])
        else:
            ckpt_ranges = plan_ranges(
                config.fastq, config.threads, start=start_offset
            )
        if ckpt_ranges:
            ranges = ckpt_ranges
            frontier = [s for s, _ in ckpt_ranges]
        else:
            ckpt_ranges = None
    return ranges, ckpt_ranges, frontier


def decode_file(
    config: RunConfig,
    plan: dec.DecodePlan,
    scheme: SequenceScheme,
    acc: CountAccumulator,
    n_devices: int = 1,
    limit_batches: int | None = None,
    byte_range: tuple[int, int] | None = None,
) -> int:
    """Stream config.fastq through the accumulator; returns total reads.

    Dense single-device runs take the wire-format fast path (2-bit packed
    bases direct from the native codec, no Phred bytes when the quality
    gate is off); everything else goes through the EncodedReads batcher.
    """
    from ngs_barcode_count_tpu.io import native as native_mod
    from ngs_barcode_count_tpu.utils.tracing import Throughput

    meter = Throughput()  # logs per batch when NGS_TRACE=1
    min_width = scheme.length
    total_reads = 0
    n_batches = 0
    native_ok = (
        native_mod.available()
        and os.environ.get("NGS_FORCE_NUMPY_INGEST") != "1"
    )
    use_packed = (
        plan.dense_counts
        or acc.bitmap is not None
        or acc.hashset is not None
        or acc.hashset_engine is not None
    ) and native_ok
    # keyed wire path: 3-bit slot words fit a uint64 key only up to 21nt
    scheme_slots = [s.length for s in scheme.barcode_slots]
    if scheme.sample_slot is not None:
        scheme_slots.append(scheme.sample_slot.length)
    if scheme.random_slot is not None:
        scheme_slots.append(scheme.random_slot.length)
    use_packed_keyed = (
        not plan.dense_counts
        and native_ok
        and max(scheme_slots) <= 21
    )
    # Consumer-aware quality-wire choice (NGS_QUAL_WIRE still wins):
    # dense single-device runs on slow measured links use the two-phase
    # HOST gate — no Phred bytes on the wire; everything else
    # (keyed/engines/sharded, fast links) packs.
    qual_mode = None
    if plan.min_quality > 0.0 and use_packed:
        gate_ok = (
            plan.dense_counts
            and acc.engine is None
            and acc.hashset is None
            and acc.hashset_engine is None
            and acc.bitmap is None
            and acc.shardings is None
        )
        if gate_ok:
            from ngs_barcode_count_tpu.utils import linkprobe

            if linkprobe.is_slow_link(allow_init=True):
                qual_mode = "host"
    # Checkpointing covers every wire-format configuration (round 4):
    # single-device dense/keyed/hashset, the sharded mesh engines
    # (snapshot = merged canonical tensors, checkpoint.py), and
    # multi-host byte-range runs (one file per host, each host resuming
    # its own frontier).  Only the bytemap (up to 2GB of dedup state)
    # and gzip byte-range ingest (no per-range frontier) stay excluded.
    checkpointing = config.checkpoint_interval_s > 0 and (
        (use_packed and acc.bitmap is None) or use_packed_keyed
    ) and not (byte_range is not None and config.fastq.endswith(".gz"))
    if byte_range is not None and not native_ok:
        raise RuntimeError(
            "byte-range (multi-host) ingest requires the native codec"
        )
    # per-host checkpoint file + a fingerprint that pins the host count
    # and this host's byte range (resuming with a different host count
    # would reassign ranges and double- or under-count)
    ckpt_path = config.checkpoint_path
    fp_tag = ""
    if byte_range is not None:
        import jax

        ckpt_path = f"{config.checkpoint_path}.h{jax.process_index()}"
        fp_tag = (
            f"|hosts={jax.process_count()}:{jax.process_index()}"
            f"|range={byte_range[0]}-{byte_range[1]}"
        )
    start_offset = 0
    resume_ranges = None  # (ranges, offsets) from a parallel-ingest ckpt
    if config.resume:
        if not (use_packed or use_packed_keyed):
            raise ValueError(
                "resume requires the native wire-format path "
                "(plain fastq, single device)"
            )
        if byte_range is not None and config.fastq.endswith(".gz"):
            raise ValueError(
                "multi-host resume requires a plain (uncompressed) FASTQ"
            )
        from ngs_barcode_count_tpu import checkpoint as ckpt

        if byte_range is not None and not os.path.exists(ckpt_path):
            # this host never reached a snapshot (fast/empty range):
            # fresh start over its own range is exact — its state and
            # frontier are an atomic pair, both empty here
            resume_point, total_reads = byte_range[0], 0
        else:
            fp = ckpt.config_fingerprint(config) + fp_tag
            resume_point, total_reads = ckpt.load(ckpt_path, acc, fp)
        if isinstance(resume_point, tuple):
            resume_ranges = resume_point
            where = (
                f"{len(resume_ranges[0])} reader frontiers "
                f"{resume_ranges[1].tolist()}"
            )
        else:
            start_offset = resume_point
            where = f"offset {start_offset}"
        print(
            f"Resumed from {ckpt_path}: "
            f"{total_reads:,} reads done, {where}"
        )
    # NGS_DUAL_STREAM=N (>=1, 1 also accepted as "two lanes" for round-2
    # compatibility): N dispatch threads over N independent count lanes
    # merged at the end.  On slow links the dispatch thread BLOCKS
    # inside each batch's h2d transfer; extra lanes overlap the
    # Python-side dispatch overhead with the in-flight transfer (and on
    # CPU hosts let the XLA thread pool overlap decode chains).  Dense
    # unsharded runs only; exact (counts and counters add commutatively).
    # Unset, the default is 3 lanes on slow proxied links and off
    # elsewhere.  Checkpointing/resume run
    # dual-stream too since round 5: the coordinator quiesces lanes at
    # batch boundaries and snapshots the SUMMED canonical state, so the
    # checkpoint format matches single-stream exactly.
    lanes_env = os.environ.get("NGS_DUAL_STREAM")
    if lanes_env is None and use_packed:
        import jax

        from ngs_barcode_count_tpu.utils import linkprobe

        if jax.devices()[0].platform != "cpu" and linkprobe.is_slow_link(
            allow_init=True
        ):
            lanes_env = "3"
    if (
        int(lanes_env or 0) >= 1
        and use_packed
        and limit_batches is None
        and byte_range is None
        and acc.dense is not None
        and acc.engine is None
        and acc.hashset is None
        and acc.hashset_engine is None
        and acc.bitmap is None
    ):
        return _decode_dual_stream(
            config, plan, scheme, acc, min_width, meter,
            n_lanes=int(lanes_env or 0),
            checkpointing=checkpointing, ckpt_path=ckpt_path,
            fp_tag=fp_tag, start_offset=start_offset,
            resume_ranges=resume_ranges, total_reads0=total_reads,
            qual_mode=qual_mode,
        )
    if use_packed or use_packed_keyed:
        from ngs_barcode_count_tpu import checkpoint as ckpt
        from ngs_barcode_count_tpu.io.parallel_ingest import (
            plan_ranges,
            read_fastq_packed_parallel,
        )

        fp = (
            ckpt.config_fingerprint(config) + fp_tag if checkpointing
            else ""
        )
        last_ckpt = time.perf_counter()
        saver = _AsyncCheckpointer()
        step_fn = acc.step_packed if use_packed else acc.step_packed_keyed
        ranges, ckpt_ranges, frontier = _plan_ckpt_ranges(
            config, checkpointing, start_offset, resume_ranges, byte_range
        )
        clean = [True] * (len(ckpt_ranges) if ckpt_ranges else 1)
        single_off = start_offset
        for pb in read_fastq_packed_parallel(
            config.fastq,
            min_width=min_width,
            batch_reads=config.batch_size,
            with_quals=plan.min_quality > 0.0,
            start_offset=start_offset,
            n_threads=config.threads,
            byte_range=byte_range,
            ranges=ranges,
            qual_mode=qual_mode,
        ):
            step_fn(pb)
            acc._throttle()
            total_reads += pb.n_reads
            n_batches += 1
            meter.update(pb.n_reads)
            if checkpointing:
                rid = pb.range_id
                if pb.next_offset >= 0:
                    if frontier is not None:
                        frontier[rid] = pb.next_offset
                    else:
                        single_off = pb.next_offset
                    clean[rid] = True
                else:
                    # tell invalid (codec holds a pending record): state
                    # now includes reads past the last frontier, so no
                    # checkpoint until this range is clean again
                    clean[rid] = False
                if (
                    all(clean)
                    and time.perf_counter() - last_ckpt
                    >= config.checkpoint_interval_s
                    and not saver.busy()
                ):
                    # drain pipelined work so saved state matches the
                    # saved frontier exactly
                    acc.flush_pending()
                    front = (
                        list(frontier) if frontier is not None
                        else single_off
                    )
                    if (
                        acc.dense is not None
                        and acc.hashset is None
                        and acc.hashset_engine is None
                        and acc.engine is None
                        and acc.keyed is None
                    ):
                        # dense state is immutable jax arrays, but the
                        # NEXT step donates the live buffers — snapshot
                        # fresh copies (dispatch-only) and write in the
                        # background (no pipeline drain at snapshot time)
                        from types import SimpleNamespace

                        snap = SimpleNamespace(
                            dense_state=_snap_copy(acc.dense_state),
                            dense_counters=_snap_copy(acc.dense_counters),
                            keyed=None,
                        )
                        saver.submit(
                            ckpt_path, snap, front, total_reads, fp,
                            ranges=ckpt_ranges,
                        )
                    else:
                        # host-mutable stores (keyed dicts, overflow
                        # dedup): synchronous save keeps the snapshot
                        # consistent
                        ckpt.save(
                            ckpt_path, acc, front, total_reads, fp,
                            ranges=ckpt_ranges,
                        )
                    last_ckpt = time.perf_counter()
            if limit_batches and n_batches >= limit_batches:
                break
            if config.progress:
                print(
                    f"Total sequences:             {total_reads:,}\r", end=""
                )
        saver.join()
    else:
        if byte_range is not None:
            from ngs_barcode_count_tpu.parallel import distributed as dist

            chunks = (
                dist.read_fastq_range(
                    config.fastq, byte_range[0], byte_range[1],
                    min_width=min_width, batch_reads=config.batch_size,
                )
                if byte_range[1] > byte_range[0]
                else iter(())
            )
        else:
            chunks = encoded_chunks(config.fastq, min_width,
                                    config.batch_size)
        for batch in batcher_mod.batches(
            chunks,
            batch_size=config.batch_size,
            min_width=min_width,
        ):
            acc.step(batch)
            acc._throttle()
            total_reads += batch.n_reads
            n_batches += 1
            meter.update(batch.n_reads)
            if limit_batches and n_batches >= limit_batches:
                break
            if config.progress:
                print(
                    f"Total sequences:             {total_reads:,}\r", end=""
                )
    return total_reads


def _decode_dual_stream(
    config: RunConfig,
    plan: dec.DecodePlan,
    scheme: SequenceScheme,
    acc: CountAccumulator,
    min_width: int,
    meter,
    n_lanes: int = 0,
    checkpointing: bool = False,
    ckpt_path: str = "",
    fp_tag: str = "",
    start_offset: int = 0,
    resume_ranges=None,
    total_reads0: int = 0,
    qual_mode: str | None = None,
) -> int:
    """N dispatch threads, N count lanes, one merge (see decode_file).

    Each thread owns a full CountAccumulator lane, so its jit calls never
    share mutable state; the ingest generator and progress counters sit
    behind locks.  Extra lanes' tensors add into lane 1 at the end —
    dense counting is order-independent, so the result is bit-identical
    to the single-stream loop (tested in test_packed_path).

    Checkpointing (round 5, so north-star-scale production runs keep
    the full dual-stream throughput): each lane holds its lane lock
    across (step + frontier bookkeeping), so a coordinator that acquires
    ALL lane locks sees every lane at a batch boundary with the frontier
    exactly matching the states.  The snapshot is the summed lane
    tensors (a fresh array; lane chains are untouched), written in the
    SAME canonical format as the single-stream path — either loop can
    resume the other's checkpoint."""
    import threading

    from ngs_barcode_count_tpu.io.parallel_ingest import (
        read_fastq_packed_parallel,
    )

    if n_lanes < 1:
        n_lanes = max(int(os.environ.get("NGS_DUAL_STREAM", 1) or 1), 1)
    if n_lanes == 1:
        n_lanes = 2  # NGS_DUAL_STREAM=1 means "dual" (round-2 knob)

    fp = ""
    ranges = ckpt_ranges = frontier = None
    if checkpointing or resume_ranges is not None:
        ranges, ckpt_ranges, frontier = _plan_ckpt_ranges(
            config, checkpointing, start_offset, resume_ranges, None
        )
    if checkpointing:
        from ngs_barcode_count_tpu import checkpoint as ckpt

        fp = ckpt.config_fingerprint(config) + fp_tag
    clean = [True] * (len(ckpt_ranges) if ckpt_ranges else 1)
    single_off = [start_offset]
    # Per-range IN-ORDER commit queues: lanes step batches out of order,
    # but a range's frontier may only advance through the prefix of
    # batches whose state updates have completed — otherwise a snapshot
    # taken while an earlier batch is still in flight would record an
    # offset ahead of the state and the resume would skip those reads.
    from collections import deque as _deque

    inflight = [_deque() for _ in clean]

    gen = read_fastq_packed_parallel(
        config.fastq,
        min_width=min_width,
        batch_reads=config.batch_size,
        with_quals=plan.min_quality > 0.0,
        n_threads=config.threads,
        start_offset=start_offset,
        ranges=ranges,
        qual_mode=qual_mode,
    )
    lanes = [acc] + [
        CountAccumulator(plan, acc.conv) for _ in range(n_lanes - 1)
    ]
    it_lock = threading.Lock()
    stats_lock = threading.Lock()
    totals = [0] * n_lanes
    errors: list[BaseException] = []
    failed = threading.Event()
    # Checkpoint quiesce protocol: the coordinator raises ``pause``;
    # each lane finishes the batch it holds (state + in-order frontier
    # commit), then PARKS at the loop top before popping another.  Once
    # parked + finished == n_lanes, no batch is in flight anywhere, so
    # the summed lane states and the committed frontier are an exact
    # pair.  (Holding per-lane locks instead livelocks: a lane that
    # popped a batch but hasn't stepped it yet leaves the frontier
    # legitimately behind the pop forever.)
    pause = threading.Event()
    cv = threading.Condition()
    parked = [0]
    finished = [0]

    def drive(i: int) -> None:
        lane = lanes[i]
        try:
            while not failed.is_set():
                if pause.is_set():
                    with cv:
                        parked[0] += 1
                        cv.notify_all()
                        cv.wait_for(lambda: not pause.is_set())
                        parked[0] -= 1
                entry = None
                with it_lock:
                    pb = next(gen, None)
                    if pb is not None and checkpointing:
                        entry = [pb.next_offset, False]
                        inflight[pb.range_id].append(entry)
                if pb is None:
                    return
                lane.step_packed(pb)
                lane._throttle()
                with stats_lock:
                    totals[i] += pb.n_reads
                    if checkpointing:
                        rid = pb.range_id
                        entry[1] = True
                        dq = inflight[rid]
                        while dq and dq[0][1]:
                            off, _ = dq.popleft()
                            if off >= 0:
                                if frontier is not None:
                                    frontier[rid] = off
                                else:
                                    single_off[0] = off
                                clean[rid] = True
                            else:
                                clean[rid] = False
                    meter.update(pb.n_reads)
                    if config.progress:
                        print(
                            f"Total sequences:             "
                            f"{sum(totals):,}\r",
                            end="",
                        )
        except BaseException as e:  # surfaced after join
            errors.append(e)
            failed.set()  # stop the other lanes promptly
            pause.clear()
            with cv:
                cv.notify_all()
            with it_lock:
                gen.close()  # stop the ingest pool (producers check stop)
        finally:
            with cv:
                finished[0] += 1
                cv.notify_all()

    threads = [
        threading.Thread(target=drive, args=(i,), daemon=True)
        for i in range(n_lanes)
    ]
    for t in threads:
        t.start()
    saver = _AsyncCheckpointer()
    if checkpointing:
        from types import SimpleNamespace

        last_ckpt = time.perf_counter()
        poll = min(1.0, max(config.checkpoint_interval_s / 4, 0.01))
        while finished[0] < n_lanes and not failed.is_set():
            time.sleep(poll)
            if (
                time.perf_counter() - last_ckpt
                < config.checkpoint_interval_s
                or saver.busy()
            ):
                continue
            pause.set()
            try:
                with cv:
                    cv.wait_for(
                        lambda: parked[0] + finished[0] >= n_lanes
                        or failed.is_set()
                    )
                if failed.is_set():
                    break
                with stats_lock:
                    ok = all(clean) and not any(inflight)
                    front = (
                        list(frontier) if frontier is not None
                        else single_off[0]
                    )
                    done = total_reads0 + sum(totals)
                if not ok:
                    continue
                # dispatch-only capture: the summed arrays are immutable
                # functional values, so lanes resume immediately and the
                # fetch/write happen in the background.  Gate queues
                # (host-side quality) drain first — the frontier counts
                # their batches, so the snapshot must too (dispatch-only
                # as well: phase B is one jit per pending batch)
                for lane in lanes:
                    lane.flush_pending()
                merged_state = lanes[0].dense_state
                merged_counters = lanes[0].dense_counters
                for lane in lanes[1:]:
                    merged_state = merged_state + lane.dense_state
                    merged_counters = merged_counters + lane.dense_counters
                snap = SimpleNamespace(
                    dense_state=merged_state,
                    dense_counters=merged_counters,
                    keyed=None,
                )
                saver.submit(
                    ckpt_path, snap, front, done, fp, ranges=ckpt_ranges
                )
                last_ckpt = time.perf_counter()
            finally:
                pause.clear()
                with cv:
                    cv.notify_all()
    for t in threads:
        t.join()
    saver.join()
    if errors:
        raise errors[0]
    for lane in lanes[1:]:
        # drain each extra lane's pipelined work (host-gate queues)
        # BEFORE summing its tensors — lane 0's queue drains in
        # acc.finalize(); the others would silently drop their tails
        lane.flush_pending()
        acc.dense_state = acc.dense_state + lane.dense_state
        acc.dense_counters = acc.dense_counters + lane.dense_counters
    acc._dual_streamed = True
    return total_reads0 + sum(totals)


# Persistent XLA compilation cache used when JAX_COMPILATION_CACHE_DIR is
# unset: a fixed path inside the checkout (the path is part of the cache
# key, so it must not move between runs).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache: repeat runs skip recompiles.
    JAX reads JAX_COMPILATION_CACHE_DIR itself; only when it is unset
    does the program place the cache, at DEFAULT_CACHE_DIR."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


def run(config: RunConfig) -> RunResult:
    _enable_compile_cache()
    start_time = _dt.datetime.now()
    scheme, conv, max_errors, plan, enrich = setup(config)
    print(f"{scheme.display()}\n")
    print(f"{max_errors.display()}\n")

    import jax

    if jax.process_count() > 1:
        from ngs_barcode_count_tpu.parallel import multihost

        t0 = time.perf_counter()
        acc, total_reads = multihost.run_multihost(config, plan, scheme, conv)
        compute_s = time.perf_counter() - t0
        if jax.process_index() != 0:
            # only host 0 writes outputs
            return RunResult(
                scheme=scheme, conversions=conv, max_errors=max_errors,
                seq_errors=acc.seq_errors, total_reads=total_reads,
                results=ResultsView({}), compute_seconds=compute_s,
                reads_per_second=total_reads / max(compute_s, 1e-9),
            )
        return _write_outputs(
            config, scheme, conv, max_errors, acc, total_reads, enrich,
            start_time, compute_s,
        )

    n_devices = config.n_devices or 1
    if n_devices > len(jax.devices()):
        raise ValueError(
            f"--devices {n_devices} but only {len(jax.devices())} available"
        )

    if config.fastq.endswith("fastq.gz"):
        # reference input.rs:60-61 warning, printed at ingest start
        print(
            "If this program stops reading before the expected number of "
            "sequencing reads, unzip the gzipped fastq and rerun."
        )
        print()

    if config.model_shards > 1 and not plan.dense_counts:
        raise ValueError(
            "--model-shards requires dense-count mode (sample + counted "
            "barcode files, no random barcode)"
        )
    acc = CountAccumulator(
        plan, conv, n_devices=n_devices,
        allow_bitmap=not (config.checkpoint_interval_s > 0 or config.resume),
        allow_device_dedup=True,  # the hash table checkpoints fine
        n_model=config.model_shards,
    )
    t0 = time.perf_counter()
    from ngs_barcode_count_tpu.utils.tracing import profile_to

    with profile_to(config.profile_dir):
        total_reads = decode_file(config, plan, scheme, acc, n_devices)
        acc.finalize()  # blocks on outstanding device work
    compute_s = time.perf_counter() - t0
    print(f"Total sequences:             {total_reads:,}")

    return _write_outputs(
        config, scheme, conv, max_errors, acc, total_reads, enrich,
        start_time, compute_s,
    )


def _write_outputs(
    config, scheme, conv, max_errors, acc, total_reads, enrich, start_time,
    compute_s,
):
    print(f"{acc.seq_errors.display()}\n")
    elapsed = _dt.datetime.now() - start_time
    from ngs_barcode_count_tpu.output import elapsed_display

    print(f"Compute time: {elapsed_display(elapsed)}\n")

    print("-WRITING COUNTS-")
    # eager view: RunResult.results.per_sample is a public contract (and
    # its cost is bounded by the combo space, not the read count); the
    # writer still takes the dense fast path off results.dense_arr
    results = acc.results_view()
    writer_config = WriterConfig(
        fastq=config.fastq,
        format=config.format,
        sample_barcodes_option=config.sample_barcodes_option,
        counted_barcodes_option=config.counted_barcodes_option,
        output_dir=config.output_dir,
        prefix=config.prefix,
        merge_output=config.merge_output,
        enrich=enrich,
    )
    writer = WriteFiles(
        results,
        scheme,
        conv.counted_barcodes_hash,
        conv.samples_barcode_hash,
        writer_config,
    )
    writer.write_counts_files()
    writer.write_stats_file(
        start_time, max_errors, acc.seq_errors, total_reads, scheme
    )
    total_elapsed = _dt.datetime.now() - start_time
    print(f"\nTotal time: {elapsed_display(total_elapsed)}")
    return RunResult(
        scheme=scheme,
        conversions=conv,
        max_errors=max_errors,
        seq_errors=acc.seq_errors,
        total_reads=total_reads,
        results=results,
        compute_seconds=compute_s,
        reads_per_second=total_reads / compute_s if compute_s > 0 else 0.0,
        engine=acc.engine_desc,
        wire=acc.wire,
        state_devices=acc.state_devices,
    )
