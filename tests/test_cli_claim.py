"""CLI device handling: the run names the devices it uses, and a backend
that fails to initialise exits cleanly with a clear message (not a
traceback) instead of carrying on elsewhere."""

import pytest

from tests.test_end_to_end import _mk_config, gen_fastq, write_inputs


def _cli_args(cfg):
    args = [
        "-f", cfg.fastq, "-q", cfg.format,
        "-o", cfg.output_dir, "-p", "cliclaim", "--no-progress",
    ]
    if cfg.sample_barcodes_option:
        args += ["-s", cfg.sample_barcodes_option]
    if cfg.counted_barcodes_option:
        args += ["-c", cfg.counted_barcodes_option]
    return args


@pytest.fixture()
def cli_inputs(tmp_path, rng):
    from ngs_barcode_count_tpu.runner import setup

    paths = write_inputs(tmp_path)
    cfg0 = _mk_config(tmp_path, "x.fastq", paths)
    scheme, *_ = setup(cfg0)
    fq, reads, quals = gen_fastq(tmp_path, scheme, 100, rng)
    return _mk_config(tmp_path, fq, paths)


def test_cli_claim_failure_is_clean_error(cli_inputs, monkeypatch, capsys,
                                          tmp_path):
    import jax

    from ngs_barcode_count_tpu import cli

    def down(*a, **k):
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", down)
    rc = cli.main(_cli_args(cli_inputs))
    assert rc == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: no JAX backend:")
    assert "Traceback" not in err
    assert not (tmp_path / "cliclaim_barcode_stats.txt").exists()


def test_cli_prints_device_line(cli_inputs, capsys, tmp_path):
    """Before decoding, one line names platform, device kind and count."""
    import jax

    from ngs_barcode_count_tpu import cli

    assert cli.main(_cli_args(cli_inputs)) == 0
    out = capsys.readouterr().out
    dev = jax.devices()[0]
    want = (f"Devices: platform={dev.platform} kind={dev.device_kind} "
            f"count={len(jax.devices())}")
    assert out.splitlines()[0] == want
    assert (tmp_path / "cliclaim_barcode_stats.txt").exists()
