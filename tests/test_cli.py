"""End-to-end CLI tests against the oracle backend (reference main.zig flow)."""

import os
import re

import numpy as np
import pytest
from PIL import Image as PILImage

from oavif_jax.cli import run


@pytest.fixture(autouse=True)
def _oracle_backend(monkeypatch):
    monkeypatch.setenv("OAVIF_BACKEND", "oracle")


def _write_png(tmp_path, arr, name="in.png"):
    p = tmp_path / name
    PILImage.fromarray(arr).save(p)
    return str(p)


def test_help_exits_zero(capsys):
    assert run(["-h"]) == 0
    assert "usage:" in capsys.readouterr().err


def test_version_exits_zero(capsys):
    assert run(["-v"]) == 0
    assert "oavif-jax" in capsys.readouterr().err


def test_missing_files_is_error():
    assert run([]) == 1


def test_fixed_quality_bypass(tmp_path, test_rgb8, capsys):
    inp = _write_png(tmp_path, test_rgb8)
    outp = str(tmp_path / "out.avif")
    assert run(["-q", "60", "-s", "10", inp, outp]) == 0
    err = capsys.readouterr().err
    assert "Encoding [q60, speed 10, 10-bit]" in err
    assert re.search(r"Compressed to \d+ bytes \(\d+\.\d{3} bpp\)", err)
    # Output decodes as a valid AVIF via the independent decoder.
    dec = PILImage.open(outp)
    assert dec.size == (test_rgb8.shape[1], test_rgb8.shape[0])


def test_target_quality_search(tmp_path, test_rgb8, capsys):
    inp = _write_png(tmp_path, test_rgb8)
    outp = str(tmp_path / "out.avif")
    assert run(["-t", "75", "--max-pass", "4", "-s", "10", inp, outp]) == 0
    err = capsys.readouterr().err
    m = re.search(r"Found q(\d+) \(score (-?\d+\.\d{2}), (\d+) pass", err)
    assert m, err
    assert 1 <= int(m.group(3)) <= 4
    assert os.path.getsize(outp) > 0


def test_tune_modes_change_rate_allocation(tmp_path, test_rgb8):
    """--tune is live: ssim keeps chroma at the base quantizer while
    iq/ssimulacra2 apply the chroma delta-q (different streams)."""
    import numpy as np
    from oavif_jax.av1.encode import encode_avif_with_recon
    from oavif_jax.backend import EncCtx
    from oavif_jax.io.image import Image
    from oavif_jax.options import EncOptions, TuneMode

    h, w = test_rgb8.shape[:2]
    outs = {}
    for tune in (TuneMode.SSIM, TuneMode.IQ, TuneMode.SSIMULACRA2):
        img = Image(width=w, height=h, channels=3, hbd=False, data=test_rgb8)
        ctx = EncCtx(
            o=EncOptions(tenbit=False, tune=tune), src=img, rgb=test_rgb8,
            w=w, h=h, q=70,
        )
        data, _ = encode_avif_with_recon(ctx)
        outs[tune] = data
    assert outs[TuneMode.IQ] == outs[TuneMode.SSIMULACRA2]
    assert outs[TuneMode.SSIM] != outs[TuneMode.IQ]
    # chroma spends more bytes under ssim (no delta) than iq
    assert len(outs[TuneMode.SSIM]) > len(outs[TuneMode.IQ])


@pytest.mark.parametrize("name", ["in.jpg", "in.webp", "in.png"])
def test_missing_pillow_is_a_clean_error(tmp_path, test_rgb8, monkeypatch,
                                         capsys, name):
    """Without Pillow, the formats that need it end in "Error: ..." and
    exit 1, not a traceback."""
    import sys

    inp = _write_png(tmp_path, test_rgb8, name="src.png")
    os.rename(inp, tmp_path / name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert run(["-q", "60", str(tmp_path / name),
                str(tmp_path / "out.avif")]) == 1
    err = capsys.readouterr().err
    assert "Error:" in err and "Pillow" in err
