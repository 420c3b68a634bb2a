"""Option-parsing parity tests (reference parse_args.zig:48-178)."""

import pytest

from oavif_jax.options import EncOptions, OptionError, TuneMode, parse_args


def test_defaults_match_reference_struct():
    d = EncOptions()
    assert d.quality_alpha == 0  # struct default, not the README display
    assert d.speed == 9
    assert d.max_threads == 1
    assert d.tile_rows_log2 == 0 and d.tile_cols_log2 == 0
    assert d.auto_tiling is True
    assert d.score_tgt == 80.0
    assert d.tenbit is True
    assert d.tune == TuneMode.IQ
    assert d.tolerance == 2.0
    assert d.max_pass == 6
    assert d.quality is None
    assert d.color_primaries == 2
    assert d.transfer_characteristics == 2
    assert d.matrix_coefficients == 2


def test_positional_in_out():
    p = parse_args(["in.png", "out.avif"])
    assert p.input_file == "in.png"
    assert p.output_file == "out.avif"


def test_third_positional_is_error():
    with pytest.raises(OptionError):
        parse_args(["a", "b", "c"])


def test_flags_and_aliases():
    p = parse_args(
        [
            "-s", "4", "-t", "85.5", "--tolerance", "3", "--max-pass", "8",
            "--tune", "ssimulacra2", "--tenbit", "0", "--quality-alpha", "50",
            "--tile-rows-log2", "2", "--tile-cols-log2", "3",
            "--auto-tiling", "0", "--max-threads", "16",
            "--color-primaries", "9", "--transfer-characteristics", "16",
            "--matrix-coefficients", "9", "in.png", "out.avif",
        ]
    )
    o = p.options
    assert o.speed == 4 and o.score_tgt == 85.5 and o.tolerance == 3.0
    assert o.max_pass == 8 and o.tune == TuneMode.SSIMULACRA2
    assert o.tenbit is False and o.quality_alpha == 50
    assert o.tile_rows_log2 == 2 and o.tile_cols_log2 == 3
    assert o.auto_tiling is False and o.max_threads == 16
    assert (o.color_primaries, o.transfer_characteristics, o.matrix_coefficients) == (9, 16, 9)


def test_quality_bypass_flag():
    p = parse_args(["-q", "60", "a.png", "b.avif"])
    assert p.options.quality == 60


@pytest.mark.parametrize(
    "args",
    [
        ["-s", "11"],
        ["-s", "-1"],
        ["-t", "29.9"],
        ["-t", "100.1"],
        ["--tolerance", "0.5"],
        ["--max-pass", "0"],
        ["--max-pass", "13"],
        ["-q", "101"],
        ["--tile-rows-log2", "7"],
        ["--auto-tiling", "2"],
        ["--tune", "butteraugli"],
        ["--color-primaries", "0"],
        ["--matrix-coefficients", "15"],
    ],
)
def test_out_of_range_rejected(args):
    with pytest.raises(OptionError):
        parse_args(args)


def test_missing_value_rejected():
    with pytest.raises(OptionError):
        parse_args(["-s"])
    # Value starting with '-' counts as missing (parse_args.zig:126).
    with pytest.raises(OptionError):
        parse_args(["--max-pass", "--speed", "3"])
