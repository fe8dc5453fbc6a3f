"""Command-line interface (reference arguments.rs:22-205).

Same 13 options as the reference's clap parser — ``--fastq``,
``--sequence-format``, ``--sample-barcodes``, ``--counted-barcodes``,
``--output-dir``, ``--prefix``, ``--merge-output``, ``--enrich``,
``--max-errors-*``, ``--min-quality`` — with device additions
(``--batch-size``, ``--devices``); ``--threads`` sizes the host ingest
pool (device parallelism is the mesh).
"""

from __future__ import annotations

import argparse
import datetime as _dt
import sys

from ngs_barcode_count_tpu.runner import RunConfig, run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ngs-barcode-count-tpu",
        description="Counts barcodes located in sequencing data (JAX, on GPU)",
    )
    p.add_argument(
        "-V", "--version", action="version",
        version="%(prog)s 0.1.0",  # clap's -V/--version (arguments.rs:28)
    )
    p.add_argument("-f", "--fastq", required=True, help="FastQ file")
    p.add_argument(
        "-q", "--sequence-format", required=True, dest="format",
        help="Sequence format file",
    )
    p.add_argument(
        "-s", "--sample-barcodes", dest="sample_barcodes",
        help="Sample barcodes file",
    )
    p.add_argument(
        "-c", "--counted-barcodes", dest="counted_barcodes",
        help="Counted barcodes file",
    )
    p.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Number of FASTQ reader threads (0 = auto). Device "
        "parallelism comes from the mesh; this caps the host ingest "
        "pool, the analog of the reference's worker threads",
    )
    p.add_argument(
        "-o", "--output-dir", default="./",
        help="Directory to output the counts to",
    )
    p.add_argument(
        "-p", "--prefix", default=_dt.date.today().strftime("%Y-%m-%d"),
        help="File prefix name.  THe output will end with "
        "'_<sample_name>_counts.csv'",
    )
    p.add_argument(
        "-m", "--merge-output", action="store_true",
        help="Merge sample output counts into a single file.  Not necessary "
        "when there is only one sample",
    )
    p.add_argument(
        "-e", "--enrich", action="store_true",
        help="Create output files of enrichment for single and double "
        "synthons/barcodes",
    )
    p.add_argument(
        "--max-errors-counted-barcode", type=int, default=None,
        help="Maximimum number of sequence errors allowed within each counted "
        "barcode. Defaults to 20%% of the total.",
    )
    p.add_argument(
        "--max-errors-sample", type=int, default=None,
        help="Maximimum number of sequence errors allowed within sample "
        "barcode. Defaults to 20%% of the total.",
    )
    p.add_argument(
        "--max-errors-constant", type=int, default=None,
        help="Maximimum number of sequence errors allowed within constant "
        "region. Defaults to 20%% of the total.",
    )
    p.add_argument(
        "--min-quality", type=float, default=0.0,
        help="Minimum average read quality score per barcode",
    )
    # device additions
    p.add_argument(
        "--batch-size", type=int, default=1 << 17,
        help="Reads per device batch (static shape)",
    )
    p.add_argument(
        "--devices", type=int, default=0,
        help="Number of local devices to shard batches over (0 = all)",
    )
    p.add_argument(
        "--model-shards", type=int, default=1,
        help="Shard candidate barcode matrices over this many devices "
        "(model parallelism for huge DEL libraries); --devices must be "
        "a multiple",
    )
    p.add_argument(
        "--no-progress", action="store_true", help="Disable progress output"
    )
    p.add_argument(
        "--checkpoint-interval", type=float, default=0.0,
        help="Snapshot count state every N seconds (0 = off; plain fastq, "
        "dense mode)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="Resume from the run's checkpoint file",
    )
    p.add_argument(
        "--fix-quirks", action="store_true",
        help="Use corrected semantics instead of bug-for-bug reference "
        "parity: the repair scan tries the final window, every barcode "
        "region is quality-checked (including a trailing one), and "
        "repaired reads read quality from the matched window",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="Write a jax.profiler trace of the decode loop here",
    )
    # multi-host (jax.distributed): run the same command on every host
    p.add_argument(
        "--num-hosts", type=int, default=1,
        help="Total number of hosts in the distributed run",
    )
    p.add_argument(
        "--host-id", type=int, default=0,
        help="This host's process index (0..num-hosts-1)",
    )
    p.add_argument(
        "--coordinator", default=None,
        help="host:port of process 0 for jax.distributed.initialize",
    )
    return p


def device_line() -> str:
    """One line naming the devices the run will use (initialises the
    JAX backend; raises RuntimeError when that fails)."""
    import jax

    devs = jax.devices()
    return (
        f"Devices: platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}"
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.num_hosts > 1:
        from ngs_barcode_count_tpu.parallel import distributed as dist

        dist.initialize(args.coordinator, args.num_hosts, args.host_id)
    import sys as _sys

    config = RunConfig(
        fastq=args.fastq,
        format=args.format,
        threads=args.threads,
        sample_barcodes_option=args.sample_barcodes,
        counted_barcodes_option=args.counted_barcodes,
        output_dir=args.output_dir,
        prefix=args.prefix,
        merge_output=args.merge_output,
        enrich=args.enrich,
        barcodes_errors_option=args.max_errors_counted_barcode,
        sample_errors_option=args.max_errors_sample,
        constant_errors_option=args.max_errors_constant,
        min_average_quality_score=args.min_quality,
        batch_size=args.batch_size,
        n_devices=args.devices,
        model_shards=args.model_shards,
        progress=not args.no_progress,
        checkpoint_interval_s=args.checkpoint_interval,
        resume=args.resume,
        profile_dir=args.profile_dir,
        fix_quirks=args.fix_quirks,
    )
    try:
        print(device_line())
    except RuntimeError as e:  # backend initialisation failed
        print(f"Error: no JAX backend: {e}", file=_sys.stderr)
        return 1
    try:
        run(config)
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: {e}", file=_sys.stderr)
        return 1
    except KeyboardInterrupt:
        print("Interrupted", file=_sys.stderr)
        return 130
    return 0


if __name__ == "__main__":
    sys.exit(main())
