"""Multi-host corpus sharding (SURVEY §2c corpus row / BASELINE config
5): two REAL jax.distributed processes on this machine, each running
measure.py with shard AUTO-DETECTION from (process_index,
process_count), then --merge over the shard CSVs.

This is the DCN leg of the scale-out story exercised with actual
process_index/count — not a simulated argument."""
import csv
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

_DRIVER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=pid)
assert jax.process_count() == 2 and jax.process_index() == pid
sys.path.insert(0, "%(repo)s/scripts")
import measure
# no --shard argument: the (process_index, process_count) auto-detect
# path must pick this process's shard
rc = measure.main([sys.argv[3], sys.argv[4], sys.argv[5],
                   "--tolerance", "40"])
sys.exit(rc or 0)
"""


def test_two_process_shard_and_merge(tmp_path):
    repo = Path(__file__).resolve().parent.parent
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    from PIL import Image as PILImage

    rng = np.random.default_rng(5)
    names = []
    for i in range(3):
        img = np.clip(
            128 + 60 * np.sin(np.arange(64)[:, None] / (3 + i))
            + rng.normal(0, 5, (64, 64)), 0, 255,
        ).astype(np.uint8)
        rgb = np.stack([img, img, 255 - img], -1)
        name = f"img{i}.png"
        PILImage.fromarray(rgb).save(corpus / name)
        names.append(name)

    driver = tmp_path / "driver.py"
    driver.write_text(_DRIVER % {"repo": repo})
    # a tiny wrapper binary path: measure.py shells out to the oavif CLI
    oavif = tmp_path / "oavif"
    oavif.write_text(
        "#!/bin/sh\nexec %s -m oavif_jax.cli \"$@\"\n" % sys.executable
    )
    oavif.chmod(0o755)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["OAVIF_DEVICE_PLANNER"] = "0"  # tiny images; no device dispatch
    env["PYTHONPATH"] = f"{repo}:" + env.get("PYTHONPATH", "")
    csvs = [tmp_path / f"shard{k}.csv" for k in (0, 1)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(driver), coord, str(k), str(corpus),
             str(oavif), str(csvs[k])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for k in (0, 1)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]

    # each shard processed its strided slice of the sorted corpus
    rows = {}
    for k in (0, 1):
        with open(csvs[k]) as f:
            rows[k] = [r["Image"] for r in csv.DictReader(f)]
    assert rows[0] == [names[0], names[2]]
    assert rows[1] == [names[1]]

    # --merge concatenates the shard CSVs and reprints the corpus summary
    merged = subprocess.run(
        [sys.executable, str(repo / "scripts" / "measure.py"),
         str(corpus), str(oavif), str(tmp_path / "merged.csv"),
         "--merge", str(csvs[0]), str(csvs[1])],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert merged.returncode == 0, merged.stderr[-2000:]
    out = merged.stdout + merged.stderr
    assert "3" in out  # all three images accounted for in the summary
