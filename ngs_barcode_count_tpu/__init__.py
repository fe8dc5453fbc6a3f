"""JAX-native NGS barcode counter, run on a GPU.

A JAX/XLA framework with the capabilities of
Roco-scientist/NGS-Barcode-Count (the Rust CLI ``barcode-count``
v0.11.1): streams FASTQ, decodes DEL/CRISPR/bar-seq barcodes with error
tolerance, and writes per-sample count CSVs — but designed as tensor
programs for an accelerator:

- reads are fixed-shape ``[B, L]`` int8 base/quality tensors,
- the reference's per-read regex search (parse.rs:92) becomes a vectorized
  valid-offset scan, its sliding-window constant-region repair
  (parse.rs:287-313) becomes a windowed mismatch argmin with tie-drop, and
  its ``fix_error`` Hamming scan (parse.rs:553-593) becomes a one-hot ×
  one-hot matmul with top-2 tie detection,
- counts accumulate into a dense ``[n_samples, prod(n_codes)]`` tensor via
  scatter-add and merge across a ``jax.sharding.Mesh`` with ``psum``.
"""

__version__ = "0.1.0"

from ngs_barcode_count_tpu.scheme import SequenceScheme, parse_scheme
from ngs_barcode_count_tpu.conversions import BarcodeConversions
from ngs_barcode_count_tpu.errors import MaxSeqErrors
from ngs_barcode_count_tpu.stats import SequenceErrors

__all__ = [
    "SequenceScheme",
    "parse_scheme",
    "BarcodeConversions",
    "MaxSeqErrors",
    "SequenceErrors",
]
