"""Corpus harness tests (scripts/measure.py — reference measure.py parity,
SURVEY.md §3.4)."""

import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "measure.py"


@pytest.fixture
def corpus(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        a = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        PILImage.fromarray(a).save(d / f"img{i}.png")
    return d


def test_pass_regex():
    sys.path.insert(0, str(SCRIPT.parent))
    import importlib
    m = importlib.import_module("measure")
    assert m.parse_pass_count("Found q60 (score 80.1, 3 passes)") == 3
    assert m.parse_pass_count("1 pass") == 1
    assert m.parse_pass_count("nothing") is None


def test_corpus_run_inprocess(corpus, tmp_path):
    out_csv = tmp_path / "out.csv"
    r = subprocess.run(
        [sys.executable, str(SCRIPT), str(corpus),
         "module:oavif_jax -q 60", str(out_csv)],
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-500:]
    rows = list(csv.DictReader(open(out_csv)))
    assert len(rows) == 3
    assert all(row["Status"] == "ok" for row in rows)
    assert all(int(row["Final Bytes"]) > 0 for row in rows)
    assert "Savings" in r.stdout


def test_corpus_sharding(corpus, tmp_path):
    csvs = []
    for k in range(2):
        out_csv = tmp_path / f"shard{k}.csv"
        r = subprocess.run(
            [sys.executable, str(SCRIPT), str(corpus),
             "module:oavif_jax -q 60", str(out_csv), "--shard", f"{k}/2"],
            capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 0, r.stderr[-500:]
        csvs.append(out_csv)
    merged = tmp_path / "merged.csv"
    r = subprocess.run(
        [sys.executable, str(SCRIPT), ".", "x", str(merged),
         "--merge"] + [str(c) for c in csvs],
        capture_output=True, text=True, timeout=60,
    )
    assert r.returncode == 0, r.stderr[-500:]
    rows = list(csv.DictReader(open(merged)))
    assert len(rows) == 3  # shards disjoint and complete
    assert len({row["Image"] for row in rows}) == 3


def test_corpus_resume(corpus, tmp_path):
    """--resume skips already-encoded images (checkpoint/resume analog of
    SURVEY.md §5; per-image rows are checkpointed after every encode)."""
    out_csv = tmp_path / "out.csv"
    env = {**__import__("os").environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, str(SCRIPT), str(corpus),
         "module:oavif_jax -q 60", str(out_csv)],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0
    rows1 = list(csv.DictReader(open(out_csv)))
    r = subprocess.run(
        [sys.executable, str(SCRIPT), str(corpus),
         "module:oavif_jax -q 60", str(out_csv), "--resume"],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0
    assert "3 done, 0 remaining" in r.stderr
    rows2 = list(csv.DictReader(open(out_csv)))
    assert rows1 == rows2


def test_corpus_run_pipelined_window(corpus, tmp_path):
    """--window N routes module:oavif_jax through tq/pipeline.py; rows
    must match the sequential in-process run (same searches, same
    bytes), with per-image time = that image's own host encode."""
    env = {**__import__("os").environ, "JAX_PLATFORMS": "cpu",
           "OAVIF_PIPELINE_METRIC": "c"}
    seq_csv, pipe_csv = tmp_path / "seq.csv", tmp_path / "pipe.csv"
    for out_csv, extra in ((seq_csv, []), (pipe_csv, ["--window", "3"])):
        r = subprocess.run(
            [sys.executable, str(SCRIPT), str(corpus),
             "module:oavif_jax -t 70", str(out_csv)] + extra,
            capture_output=True, text=True, timeout=300, env=env,
        )
        assert r.returncode == 0, r.stderr[-500:]
    seq = list(csv.DictReader(open(seq_csv)))
    pipe = list(csv.DictReader(open(pipe_csv)))
    assert len(pipe) == len(seq) == 3
    for a, b in zip(seq, pipe):
        assert b["Status"] == "ok"
        assert b["Image"] == a["Image"]
        assert b["Final Bytes"] == a["Final Bytes"]
        assert b["Passes"] == a["Passes"]
