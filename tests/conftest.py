"""Test config: pin JAX to a virtual 8-device CPU platform so the
multi-device sharding paths run without accelerator hardware (the
standard JAX fake-multi-device trick, SURVEY.md section 4c).  Checks
that need the GPU live in chip_smoke.py, not in pytest."""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ngs_barcode_count_tpu.scheme import parse_scheme_text  # noqa: E402

EXAMPLE_SCHEME = """\
# example scheme mirroring the reference's scheme.example.txt
[10]
AGCTACGAATCG
{6}
TGGA
{6}
TGGA
{6}
ACTAGAT
(8)
TAGA
"""

# A scheme with no sample/random barcode, single counted barcode.
SIMPLE_SCHEME = """\
ACGTACGT
{6}
TTGGCCAA
"""


@pytest.fixture(scope="session")
def example_scheme():
    return parse_scheme_text(EXAMPLE_SCHEME)


@pytest.fixture(scope="session")
def simple_scheme():
    return parse_scheme_text(SIMPLE_SCHEME)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
