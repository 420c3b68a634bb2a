#!/usr/bin/env python3
"""Corpus benchmark harness, CLI- and CSV-compatible with the reference's
scripts/measure.py (behavior documented at SURVEY.md §3.4; written from
that spec, not copied):

    measure.py [--tolerance T] [--keep] [--shard K/N] [--jobs J] \
               images_dir oavif_path output_csv

  - collects *.png / *.jpg / *.jpeg (sorted) from images_dir
  - encodes each via the given encoder command (the reference binary, or
    "module:oavif_jax" to run this package in-process), timing the run and
    scraping "<N> pass(es)" from stderr
  - writes the same CSV schema (Image, Original Bytes, Final Bytes,
    Savings Bytes, Savings %, Encoding Time (ms), Passes, Status, Error)
    and prints the same summary statistics family (throughput, overall +
    geomean savings, time and pass dispersion)

Scale-out (BASELINE config 5): --shard K/N statically shards the sorted
corpus across N hosts (host K takes images[K::N]); under a
jax.distributed-initialized job the shard defaults to
(process_index, process_count). Each host writes its shard CSV; `--merge`
concatenates shard CSVs and reprints the summary.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

PASS_RE = re.compile(r"(\d+)\s+pass(?:es)?")


def parse_pass_count(stderr_text: str):
    m = None
    for m in PASS_RE.finditer(stderr_text):
        pass
    return int(m.group(1)) if m else None


def encode_one(enc_cmd, tolerance, in_path: Path, out_path: Path):
    """Run one encode; returns dict row fields."""
    row = {
        "Image": in_path.name,
        "Original Bytes": in_path.stat().st_size,
        "Final Bytes": "",
        "Savings Bytes": "",
        "Savings %": "",
        "Encoding Time (ms)": "",
        "Passes": "",
        "Status": "ok",
        "Error": "",
    }
    args = list(enc_cmd)
    if tolerance is not None:
        args += ["--tolerance", str(tolerance)]
    args += [str(in_path), str(out_path)]
    t0 = time.time()
    try:
        if args[0] == "module:oavif_jax":
            import contextlib
            import io as iomod

            repo_root = str(Path(__file__).resolve().parent.parent)
            if repo_root not in sys.path:
                sys.path.insert(0, repo_root)
            from oavif_jax.cli import run as cli_run

            buf = iomod.StringIO()
            with contextlib.redirect_stderr(buf):
                rc = cli_run(args[1:])
            stderr_text = buf.getvalue()
            if rc != 0:
                raise RuntimeError(f"exit {rc}: {stderr_text.strip()[-200:]}")
        else:
            proc = subprocess.run(args, capture_output=True, text=True)
            stderr_text = proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"exit {proc.returncode}: {stderr_text.strip()[-200:]}"
                )
        elapsed_ms = (time.time() - t0) * 1000
        final = out_path.stat().st_size
        row["Final Bytes"] = final
        row["Savings Bytes"] = row["Original Bytes"] - final
        row["Savings %"] = round(
            100.0 * (row["Original Bytes"] - final) / row["Original Bytes"], 2
        )
        row["Encoding Time (ms)"] = round(elapsed_ms, 1)
        p = parse_pass_count(stderr_text)
        row["Passes"] = p if p is not None else ""
    except Exception as e:  # per-image failure tolerated, like the reference
        row["Status"] = "error"
        row["Error"] = str(e)[:200]
    return row


def encode_window(enc_cmd, tolerance, images, out_dir: Path, keep: bool):
    """Pipelined in-process encode of one window of images
    (tq/pipeline.py): per-image time is that image's own host encode
    time; the corpus wall is what the overlap improves (printed by
    summarize). Flags after module:oavif_jax are parsed with the CLI's
    own option parser."""
    repo_root = str(Path(__file__).resolve().parent.parent)
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    from oavif_jax.backend import EncCtx
    from oavif_jax.backend import get_backend
    from oavif_jax.io.image import load_image, to_rgb8
    from oavif_jax.options import OptionError, parse_args as parse_opts
    from oavif_jax.tq.pipeline import search_encode_corpus

    flags = list(enc_cmd[1:])
    if tolerance is not None:
        flags += ["--tolerance", str(tolerance)]

    rows, ctxs, live = [], [], []
    for img in images:
        row = {
            "Image": img.name,
            "Original Bytes": img.stat().st_size,
            "Final Bytes": "", "Savings Bytes": "", "Savings %": "",
            "Encoding Time (ms)": "", "Passes": "",
            "Status": "ok", "Error": "",
        }
        rows.append(row)
        try:
            parsed = parse_opts(flags + [str(img), str(img) + ".avif"])
            src = load_image(str(img))
            rgb = to_rgb8(src)
            ctxs.append(EncCtx(o=parsed.options, src=src, rgb=rgb,
                               w=src.width, h=src.height))
            live.append(row)
        except (OptionError, OSError, ValueError) as e:
            row["Status"] = "error"
            row["Error"] = str(e)[:200]

    backend = get_backend(os.environ.get("OAVIF_BACKEND", "oavif"))
    results = search_encode_corpus(ctxs, backend)
    host_s = search_encode_corpus.last_host_s
    errors = search_encode_corpus.last_errors
    for row, (res, data), hs, err in zip(live, results, host_s, errors):
        if res is None:
            row["Status"] = "error"
            row["Error"] = (err or "search failed")[:200]
            continue
        name = row["Image"]
        out_path = out_dir / (Path(name).stem + ".avif")
        with open(out_path, "wb") as f:
            f.write(data)
        row["Final Bytes"] = len(data)
        row["Savings Bytes"] = row["Original Bytes"] - len(data)
        row["Savings %"] = round(
            100.0 * (row["Original Bytes"] - len(data))
            / row["Original Bytes"], 2)
        row["Encoding Time (ms)"] = round(hs * 1000, 1)
        row["Passes"] = res.num_pass
        if not keep and out_path.exists():
            out_path.unlink()
    return rows


def summarize(rows, wall_s):
    ok = [r for r in rows if r["Status"] == "ok"]
    print(f"\nImages: {len(ok)}/{len(rows)} ok in {wall_s:.1f}s "
          f"({len(ok) / wall_s:.2f} images/s)" if wall_s > 0 else "")
    if not ok:
        return
    in_bytes = sum(r["Original Bytes"] for r in ok)
    out_bytes = sum(r["Final Bytes"] for r in ok)
    print(f"Throughput: {in_bytes / wall_s / 1e6:.2f} MB/s in, "
          f"{out_bytes / wall_s / 1e6:.2f} MB/s out")
    overall = 100.0 * (in_bytes - out_bytes) / in_bytes
    ratios = [r["Final Bytes"] / r["Original Bytes"] for r in ok
              if r["Original Bytes"]]
    geo = 100.0 * (1.0 - math.exp(sum(math.log(x) for x in ratios) / len(ratios)))
    print(f"Savings: overall {overall:.2f}%, geomean {geo:.2f}%")
    times = [r["Encoding Time (ms)"] for r in ok if r["Encoding Time (ms)"] != ""]
    if times:
        sd = statistics.stdev(times) if len(times) > 1 else 0.0
        print(f"Time (ms): mean {statistics.mean(times):.1f}, "
              f"median {statistics.median(times):.1f}, stddev {sd:.1f}")
    passes = [r["Passes"] for r in ok if r["Passes"] != ""]
    if passes:
        sd = statistics.stdev(passes) if len(passes) > 1 else 0.0
        print(f"Passes: mean {statistics.mean(passes):.2f}, stddev {sd:.2f}, "
              f"min {min(passes)}, max {max(passes)}")


FIELDS = ["Image", "Original Bytes", "Final Bytes", "Savings Bytes",
          "Savings %", "Encoding Time (ms)", "Passes", "Status", "Error"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("images_dir")
    ap.add_argument("oavif_path",
                    help="encoder command, or module:oavif_jax for in-process")
    ap.add_argument("output_csv")
    ap.add_argument("--tolerance", type=float, default=None)
    ap.add_argument("--keep", action="store_true",
                    help="keep the encoded AVIF files")
    ap.add_argument("--shard", default=None,
                    help="K/N static corpus shard (defaults to the "
                         "jax.distributed process index when initialized)")
    ap.add_argument("--resume", action="store_true",
                    help="skip images already present as ok rows in the "
                         "output CSV (corpus-scale checkpoint/resume)")
    ap.add_argument("--merge", nargs="*", default=None,
                    help="merge shard CSVs given as arguments instead of "
                         "encoding (images_dir/oavif_path ignored)")
    ap.add_argument("--window", type=int, default=0,
                    help="pipeline this many images' searches concurrently "
                         "(module:oavif_jax only): the device worker "
                         "prefetches planners / scores probes while the "
                         "host encodes other images (tq/pipeline.py). "
                         "0 = sequential (reference semantics)")
    args = ap.parse_args(argv)

    if args.merge is not None:
        rows = []
        for path in args.merge:
            with open(path) as f:
                rows += list(csv.DictReader(f))
        for r in rows:
            for k in ("Original Bytes", "Final Bytes", "Savings Bytes"):
                r[k] = int(r[k]) if r[k] else ""
            r["Encoding Time (ms)"] = (
                float(r["Encoding Time (ms)"]) if r["Encoding Time (ms)"] else ""
            )
            r["Passes"] = int(r["Passes"]) if r["Passes"] else ""
        with open(args.output_csv, "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=FIELDS)
            wr.writeheader()
            wr.writerows(rows)
        times = [r["Encoding Time (ms)"] for r in rows
                 if r["Status"] == "ok" and r["Encoding Time (ms)"] != ""]
        summarize(rows, sum(times) / 1000 if times else 1.0)
        return 0

    images = sorted(
        p for p in Path(args.images_dir).iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    shard_k, shard_n = 0, 1
    if args.shard:
        shard_k, shard_n = (int(x) for x in args.shard.split("/"))
    else:
        # under a jax.distributed job, shard by process automatically.
        # Otherwise this process stays off JAX: opening the card here
        # would reserve its memory ahead of the encoder processes.
        jax = sys.modules.get("jax")
        if jax is not None and jax.distributed.is_initialized():
            shard_k, shard_n = jax.process_index(), jax.process_count()
    images = images[shard_k::shard_n]
    if not images:
        print("no images in shard", file=sys.stderr)
        return 1

    done_rows = []
    if args.resume and Path(args.output_csv).exists():
        with open(args.output_csv) as f:
            done_rows = [r for r in csv.DictReader(f) if r["Status"] == "ok"]
        done_names = {r["Image"] for r in done_rows}
        for r in done_rows:
            for k in ("Original Bytes", "Final Bytes", "Savings Bytes"):
                r[k] = int(r[k]) if r[k] else ""
            r["Encoding Time (ms)"] = (
                float(r["Encoding Time (ms)"]) if r["Encoding Time (ms)"] else ""
            )
            r["Passes"] = int(r["Passes"]) if r["Passes"] else ""
        images = [p for p in images if p.name not in done_names]
        print(f"resume: {len(done_rows)} done, {len(images)} remaining",
              file=sys.stderr)

    enc_cmd = args.oavif_path.split()
    out_dir = Path(args.output_csv).parent
    rows = list(done_rows) if args.resume and Path(args.output_csv).exists() else []
    t0 = time.time()
    if args.window > 1 and enc_cmd[0] == "module:oavif_jax":
        for i in range(0, len(images), args.window):
            batch = images[i : i + args.window]
            rows += encode_window(enc_cmd, args.tolerance, batch, out_dir,
                                  args.keep)
            # checkpoint after every window
            with open(args.output_csv, "w", newline="") as f:
                wr = csv.DictWriter(f, fieldnames=FIELDS)
                wr.writeheader()
                wr.writerows(rows)
    else:
        for img in images:
            out_path = out_dir / (img.stem + ".avif")
            rows.append(encode_one(enc_cmd, args.tolerance, img, out_path))
            if not args.keep and out_path.exists():
                out_path.unlink()
            # checkpoint after every image so an interrupted corpus run
            # resumes
            with open(args.output_csv, "w", newline="") as f:
                wr = csv.DictWriter(f, fieldnames=FIELDS)
                wr.writeheader()
                wr.writerows(rows)
    wall_s = time.time() - t0

    with open(args.output_csv, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=FIELDS)
        wr.writeheader()
        wr.writerows(rows)
    summarize(rows, wall_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
