"""Corpus pipeline (tq/pipeline.py): equivalence with the sequential
driver and scheduling edge cases.

The pipeline must be a pure scheduling change: with the host C scorer
(the forced mode here) every image's search sees the same scores in the
same per-image order as tq/driver.py's sequential loop, so the selected
quantizer, pass count, and the shipped bytes must match exactly."""

import os

import numpy as np
import pytest

from oavif_jax.backend import EncCtx
from oavif_jax.backend.oavif import OavifBackend
from oavif_jax.io.image import Image
from oavif_jax.options import EncOptions
from oavif_jax.tq.driver import search_encode
from oavif_jax.tq.pipeline import search_encode_corpus


def _mk_ctx(img, **opt):
    h, w = img.shape[:2]
    return EncCtx(
        o=EncOptions(speed=9, **opt),
        src=Image(width=w, height=h, channels=3, hbd=False, data=img),
        rgb=img,
        w=w,
        h=h,
    )


def _imgs():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    smooth = np.clip(
        np.stack(
            [
                128 + 90 * np.sin(xx / 23) * np.cos(yy / 17),
                120 + 70 * np.cos(xx / 31),
                110 + 80 * np.sin((xx + yy) / 29),
            ],
            -1,
        )
        + rng.normal(0, 5, (256, 256, 3)),
        0,
        255,
    ).astype(np.uint8)
    blocks = np.full((256, 256, 3), 220, np.uint8)
    for _ in range(8):
        x0, y0 = rng.integers(0, 200, 2)
        blocks[y0 : y0 + 48, x0 : x0 + 48] = rng.integers(0, 255, 3)
    return [smooth, blocks]


@pytest.fixture(autouse=True)
def _force_c_scorer(monkeypatch):
    monkeypatch.setenv("OAVIF_PIPELINE_METRIC", "c")


def test_pipeline_matches_sequential_driver():
    imgs = _imgs()
    be = OavifBackend()
    seq = []
    for img in imgs:
        r, data = search_encode(_mk_ctx(img), be)
        seq.append((r.q, r.num_pass, len(data), data))
    piped = search_encode_corpus([_mk_ctx(i) for i in imgs], be)
    for (q, npass, nbytes, data), (r, pdata) in zip(seq, piped):
        assert r.q == q
        assert r.num_pass == npass
        assert pdata == data


def test_pipeline_single_image_and_empty():
    be = OavifBackend()
    assert search_encode_corpus([], be) == []
    img = _imgs()[0]
    out = search_encode_corpus([_mk_ctx(img)], be)
    assert len(out) == 1
    r, data = out[0]
    assert abs(r.score - 80.0) <= 2.0 or r.score >= 80.0
    assert len(data) > 100


def test_pipeline_deterministic_across_runs():
    imgs = _imgs()
    be = OavifBackend()
    a = search_encode_corpus([_mk_ctx(i) for i in imgs], be)
    b = search_encode_corpus([_mk_ctx(i) for i in imgs], be)
    for (ra, da), (rb, db) in zip(a, b):
        assert ra.q == rb.q
        assert da == db


def test_pipeline_respects_max_pass():
    img = _imgs()[0]
    be = OavifBackend()
    out = search_encode_corpus([_mk_ctx(img, max_pass=1)], be)
    assert out[0][0].num_pass == 1
