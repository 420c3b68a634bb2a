#!/usr/bin/env python3
"""Smoke test of the encoder's main path on an NVIDIA GPU.

    python chip_smoke.py               # phases (a)-(f), one card
    python chip_smoke.py --four-cards  # phase (g) only, four cards

  (a) environment: the card, JAX, the C runtime and its AVX-512 paths,
      Pillow, libavif;
  (b) planner parity: the jitted planning step on the GPU against the
      same step on JAX's CPU backend, on the 12 MP tiles and the six 512²
      corpus images, at qindex 40/90/160 and duel levels 0/1;
  (c) metric parity: the JAX SSIMULACRA2 on the GPU against the host C
      scorer (ssimu2.c), identity and batch-vs-single checks;
  (d) the CLI on a seeded 12 MP 1/f photo (4032x3024, two tiles), at
      -q 60 and with the default target search;
  (e) the corpus pipeline on the six 512² classes, which scores probes on
      the device;
  (f) device_stage levels on the GPU against a float64 host recompute;
  (g) --four-cards: the 12 MP image in 4 tile columns with its tile
      planners spread over four cards, byte-equal to every planner on
      card 0, then __graft_entry__.dryrun_multichip(4).

Every check raises on failure. The last line of standard output is
{"ok": true, "device": {...}} only when every phase ran and passed; with
no GPU, or outside the repository, the script exits non-zero first.
Phase (d) writes its .avif files and recon digests to smoke_out/;
tools/check_recon.py decodes them with libavif (on a machine that has it)
and compares.

Tolerances: plans must be identical. Metric scores agree with the C
scorer within 0.05 (tests/test_metric.py), identity scores 100 +- 1e-3,
batch and single within 1e-3; the metric's convolutions and opsin
product run at Precision.HIGHEST, which keeps them out of TF32.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "smoke_out"  # gitignored
QINDEXES = (40, 90, 160)
DUEL_LEVELS = (0, 1)  # speeds 7-9 and 6; speeds <= 5 plan on the host
PHOTO_HW = (3024, 4032)  # 12 MP phone photo, above the single-tile area
CLI_FLAGS = ["-s", "9", "--tenbit", "1", "--max-threads", "1",
             "--auto-tiling", "1"]


def log(msg: str = "") -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Checks shared with tests/test_gpu.py
# ---------------------------------------------------------------------------


def yuv_planes(rgb8, bitdepth: int):
    """The encoder's YUV444 planes for an RGB8 image (its depth
    conversion, then its colour transform)."""
    from oavif_jax.av1.encode import _depth_convert
    from oavif_jax.av1.yuv import rgb_to_yuv444

    return rgb_to_yuv444(_depth_convert(rgb8, False, bitdepth), bitdepth)


def tile_planes(planes, tile_cols_log2: int = 0, tile_rows_log2: int = 0):
    """Split planes into the encoder's tiles (after its spec clamp)."""
    from oavif_jax.av1.obu import clamp_tile_log2s, tile_grid

    h, w = planes[0].shape
    tcl, trl = clamp_tile_log2s(w, h, tile_cols_log2, tile_rows_log2)
    cols, rows = tile_grid(w, h, tcl, trl)
    return [
        [p[r0 * 64:min(r1 * 64, h), c0 * 64:min(c1 * 64, w)] for p in planes]
        for r0, r1 in zip(rows[:-1], rows[1:])
        for c0, c1 in zip(cols[:-1], cols[1:])
    ]


def plan_mismatches(planes, bitdepth, devices, qindexes=QINDEXES,
                    duel_levels=DUEL_LEVELS, nmodes=13):
    """Run the planning step on each of two devices on the same padded
    planes; returns [(qindex, duel_level, {field: mismatch count})]."""
    import numpy as np

    from oavif_jax.av1 import device_plan as DP
    from oavif_jax.av1.tables import ac_q

    fps = [DP.FramePlanner(planes, bitdepth, nmodes=nmodes, device=d)
           for d in devices]
    pnby, pnbx = fps[0].psby * 2, fps[0].psbx * 2
    n64, n32 = (pnby // 2) * (pnbx // 2), pnby * pnbx
    fields = {"plan64": slice(0, n64), "mode32": slice(n64, n64 + n32),
              "split32": slice(n64 + n32, n64 + 2 * n32),
              "mode16": slice(n64 + 2 * n32, None)}
    rows = []
    for q in qindexes:
        for duel in duel_levels:
            packed = [
                np.asarray(DP._plan_device(
                    *fp.dev, np.float32(ac_q(q, bitdepth)), np.float32(q),
                    pnby, pnbx, bitdepth, nmodes, duel))
                for fp in fps
            ]
            rows.append((q, duel, {
                k: int((packed[0][s] != packed[1][s]).sum())
                for k, s in fields.items()}))
    return rows


def distortions(rgb8, seed: int):
    """Two seeded distortions of an RGB8 image: mild noise, and a coarse
    requantisation with noise (scores around 90 and around 50-70)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rgb8.astype(np.int16)
    mild = np.clip(x + rng.integers(-3, 4, x.shape), 0, 255)
    coarse = np.clip((x // 12) * 12 + 6 + rng.integers(-8, 9, x.shape),
                     0, 255)
    return [mild.astype(np.uint8), coarse.astype(np.uint8)]


def metric_deltas(ref, dists):
    """[(jax score on the default device, C score)] for each distortion."""
    from oavif_jax.metric import compute_ssimulacra2
    from oavif_jax.metric.native import compute_ssimulacra2_native

    return [(compute_ssimulacra2(ref, d), compute_ssimulacra2_native(ref, d))
            for d in dists]


def device_level_errors(rgb8, qindex: int):
    """Device-stage levels against a float64 host recompute of the same
    open-loop round-half quantisation, on every consumed 16x16 block.
    Returns (blocks checked, max |level diff|, max differing levels in
    one block); tests/test_device_stage.py holds them to (>50, <=1, <=4)."""
    import numpy as np

    from oavif_jax.av1.frame import _attach_device_levels, _get_planner
    from oavif_jax.av1.intra import build_edges, predict
    from oavif_jax.av1.tables import ac_q, dc_q
    from oavif_jax.av1.transform import fwd_matrices
    from oavif_jax.av1.yuv import rgb_to_yuv444

    pl = [p.astype(np.int32) for p in rgb_to_yuv444(rgb8, 8)]
    planner = _get_planner(pl, 8, 13, 0, 0)
    plan = dict(planner.plan(qindex))
    _attach_device_levels(planner, plan, qindex, 8)
    lv, mask, m16 = plan["lv16"], plan["lv16_mask"], plan["mode16"]
    fh, fw = fwd_matrices(16, 16, "dct_dct")
    dq = np.full(256, float(ac_q(qindex, 8)))
    dq[0] = float(dc_q(qindex, 8))
    y = pl[0]
    checked, worst, worst_n = 0, 0, 0
    for i, j in zip(*np.nonzero(mask)):
        x0, y0 = j * 16, i * 16
        a, l = build_edges(y, x0, y0, 16, 16, True, True, 8)
        pred = predict(int(m16[i, j]) & 0xFF, a, l, 16, 16, True, True,
                       bitdepth=8)
        resid = (y[y0:y0 + 16, x0:x0 + 16] - pred).astype(np.float64)
        cf = (fh @ resid @ fw.T).reshape(-1)
        mag = np.floor(np.abs(cf) / dq + 0.5)
        ref = np.where(cf < 0, -mag, mag).astype(np.int64)
        d = np.abs(ref - lv[i, j].astype(np.int64))
        checked += 1
        worst = max(worst, int(d.max()))
        worst_n = max(worst_n, int((d > 0).sum()))
    return checked, worst, worst_n


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


class Compiles:
    """Accumulates XLA backend compile time (JAX's monitoring events)."""

    def __init__(self):
        import jax

        self.secs = 0.0
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            self.secs += duration
            self.count += 1

    def take(self):
        out = (self.count, round(self.secs, 2))
        self.secs, self.count = 0.0, 0
        return out


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def avx512_macros():
    """The AVX-512 macros gcc -march=native defines here: the C runtime
    compiles its AVX-512 paths exactly when these are set."""
    r = subprocess.run(["gcc", "-march=native", "-dM", "-E", "-x", "c",
                        os.devnull], capture_output=True, text=True,
                       check=True)
    return sorted(m for m in ("__AVX512F__", "__AVX512BW__", "__AVX512DQ__",
                              "__AVX512VL__", "__AVX512VNNI__")
                  if f"#define {m} " in r.stdout)


def steady_ms(fn, reps: int = 10) -> float:
    """Median wall of reps calls after a warm-up, each ending in
    block_until_ready."""
    import statistics

    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def mem_line(compiled) -> str:
    m = compiled.memory_analysis()
    mib = 1 << 20
    return (f"args {m.argument_size_in_bytes / mib:.1f} MiB, "
            f"out {m.output_size_in_bytes / mib:.2f} MiB, "
            f"temp {m.temp_size_in_bytes / mib:.1f} MiB, "
            f"code {m.generated_code_size_in_bytes / mib:.2f} MiB")


def phase_env(gpu):
    import ctypes

    import jax

    from oavif_jax.av1.entropy.fast import get_lib

    log(f"card: {nvidia_smi()}")
    log(f"jax {jax.__version__}: {len(jax.devices())} x "
        f"{gpu.device_kind} ({gpu.platform}); cpu backend "
        f"{len(jax.devices('cpu'))} device(s)")
    if get_lib() is None:
        raise RuntimeError("the C runtime did not load")
    log(f"C runtime loaded; AVX-512 macros: {avx512_macros() or 'none'}")
    try:
        import PIL

        log(f"Pillow {PIL.__version__} importable")
    except ImportError:
        log("Pillow absent")
    try:
        ctypes.CDLL("libavif.so.15")
        log("libavif.so.15 loadable")
        return True
    except OSError:
        log("libavif.so.15 absent")
        return False


def phase_planner(gpu, photo):
    import jax
    import numpy as np

    from oavif_jax.av1 import device_plan as DP
    from oavif_jax.av1.tables import ac_q

    import bench

    cpu = jax.devices("cpu")[0]
    sets = [(f"12MP tile {k}", t)
            for k, t in enumerate(tile_planes(yuv_planes(photo, 10)))]
    sets += [(f"512 {n}", yuv_planes(img, 10))
             for n, img in bench.corpus(512).items()]
    total = 0
    for name, planes in sets:
        rows = plan_mismatches(planes, 10, (gpu, cpu))
        bad = [(q, d, m) for q, d, m in rows if any(m.values())]
        total += sum(sum(m.values()) for _, _, m in rows)
        log(f"  {name} {planes[0].shape}: "
            + ("identical at every (qindex, duel)" if not bad else
               "; ".join(f"q{q} duel{d} {m}" for q, d, m in bad)))
    fp = DP.FramePlanner(sets[0][1], 10, device=gpu)
    pnby, pnbx = fp.psby * 2, fp.psbx * 2
    args = (*fp.dev, np.float32(ac_q(40, 10)), np.float32(40))
    comp = DP._plan_device.lower(
        *args, nby=pnby, nbx=pnbx, bitdepth=10, nmodes=13,
        duel_level=0).compile()
    log(f"  memory_analysis, planner step at the 12 MP tile: "
        f"{mem_line(comp)}")
    log(f"  planner step at the 12 MP tile, steady: "
        f"{steady_ms(lambda: comp(*args)):.3f} ms")
    if total:
        raise AssertionError(f"{total} planner fields differ GPU vs CPU")


def phase_metric(photo):
    import jax.numpy as jnp
    import numpy as np

    from oavif_jax.metric import compute_ssimulacra2, compute_ssimulacra2_batch
    from oavif_jax.metric.ssimulacra2 import _score_pair

    import bench

    worst = 0.0
    pairs = [(f"512 {n}", img, distortions(img, k))
             for k, (n, img) in enumerate(bench.corpus(512).items())]
    pairs.append(("12MP", photo, distortions(photo, 99)[:1]))
    for name, ref, dists in pairs:
        ident = compute_ssimulacra2(ref, ref)
        if abs(ident - 100.0) >= 1e-3:
            raise AssertionError(f"{name}: identity scored {ident}")
        for jx, c in metric_deltas(ref, dists):
            worst = max(worst, abs(jx - c))
            log(f"  {name}: jax(gpu) {jx:.4f}  c {c:.4f}  "
                f"|d| {abs(jx - c):.4f}")
            if abs(jx - c) >= 0.05:
                raise AssertionError(f"{name}: |jax - c| >= 0.05")
    ref = pairs[1][1]
    batch = compute_ssimulacra2_batch(ref, np.stack(pairs[1][2]))
    single = [compute_ssimulacra2(ref, d) for d in pairs[1][2]]
    if np.max(np.abs(batch - single)) >= 1e-3:
        raise AssertionError(f"batch {batch} vs single {single}")
    log(f"  identity 100 +- 1e-3 on all; batch-vs-single "
        f"{np.max(np.abs(batch - single)):.2e}; worst |jax - c| {worst:.4f}")
    ref, dist = jnp.asarray(photo), jnp.asarray(pairs[-1][2][0])
    comp = _score_pair.lower(ref, dist).compile()
    log(f"  memory_analysis, metric step at 12 MP: {mem_line(comp)}")
    log(f"  metric step at 12 MP (both pyramids), steady: "
        f"{steady_ms(lambda: comp(ref, dist), 5):.3f} ms")


def write_pam(path: Path, rgb8) -> None:
    h, w = rgb8.shape[:2]
    path.write_bytes(
        f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\n"
        f"ENDHDR\n".encode() + rgb8.tobytes())


def recon_digest(planes) -> str:
    import numpy as np

    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p, dtype=np.int32).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def encode_probes():
    """Records, for every encode: whether each tile took a device plan
    and the C coder, and the recon digest of each AVIF produced."""
    from oavif_jax.av1 import encode as EN
    from oavif_jax.av1.entropy import fast

    rec = {"tiles": [], "recon": {}, "last": None}
    orig_tile, orig_mux, orig_rgb = (fast.tile_encode_native, EN.mux_avif,
                                     EN.yuv444_to_rgb)

    def tile_hook(planes, qindex, bitdepth, speed, plan, *a, **k):
        res = orig_tile(planes, qindex, bitdepth, speed, plan, *a, **k)
        rec["tiles"].append((plan is not None, res is not None))
        return res

    def mux_hook(*a, **k):
        rec["last"] = orig_mux(*a, **k)
        return rec["last"]

    def rgb_hook(planes, bitdepth=8):
        rec["recon"][hashlib.sha256(rec["last"]).hexdigest()] = \
            recon_digest(planes)
        return orig_rgb(planes, bitdepth=bitdepth)

    fast.tile_encode_native, EN.mux_avif, EN.yuv444_to_rgb = (
        tile_hook, mux_hook, rgb_hook)
    try:
        yield rec
    finally:
        fast.tile_encode_native, EN.mux_avif, EN.yuv444_to_rgb = (
            orig_tile, orig_mux, orig_rgb)


def run_cli(args, out: Path, compiles: Compiles):
    """cli.run with its stderr captured; returns (stderr lines, wall s,
    compiles, probe record, avif bytes)."""
    from oavif_jax import cli

    buf = io.StringIO()
    with encode_probes() as rec, contextlib.redirect_stderr(buf):
        t0 = time.perf_counter()
        rc = cli.run(args + [str(out)])
        wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    if rc != 0:
        raise RuntimeError(f"cli exit {rc}: {lines[-3:]}")
    return lines, wall, compiles.take(), rec, out.read_bytes()


def check_planners_on(device):
    from oavif_jax.av1 import frame as FR

    placed = {d for fp in FR._PLANNER_CACHE.values() if fp.dev
              for a in fp.dev for d in a.devices()}
    if not placed or placed != {device}:
        raise AssertionError(f"planner buffers live on {placed}, "
                             f"not {device}")


def phase_cli(gpu, photo, compiles, libavif):
    from oavif_jax.av1 import frame as FR

    pam = OUT / "photo_12mp.pam"
    write_pam(pam, photo)
    digests = {}
    runs = (("q60", ["-q", "60"]),
            ("search", ["-t", "80", "--tolerance", "2", "--max-pass", "6"]))
    os.environ["OAVIF_VERBOSE"] = "1"
    try:
        for label, extra in runs:
            out = OUT / f"photo_12mp_{label}.avif"
            lines, wall, (n_comp, comp_s), rec, data = run_cli(
                CLI_FLAGS + extra + [str(pam)], out, compiles)
            for ln in lines:
                log(f"  | {ln}")
            tiles = rec["tiles"]
            if not tiles or not all(p and c for p, c in tiles):
                raise AssertionError(
                    f"{label}: tile encodes (device plan, C coder) {tiles}")
            check_planners_on(gpu)
            digest = rec["recon"][hashlib.sha256(data).hexdigest()]
            digests[out.name] = digest
            log(f"  {label}: wall {wall:.2f} s, {len(tiles)} tile encodes "
                f"all device-planned in C; {n_comp} compiles "
                f"{comp_s} s; planners on {gpu}")
    finally:
        os.environ.pop("OAVIF_VERBOSE", None)
        pam.unlink()
    (OUT / "recon_digests.json").write_text(json.dumps(digests, indent=1))
    if libavif:
        from oavif_jax.io.avif_ctypes import decode_to_yuv

        for name, digest in digests.items():
            yuv, _, _ = decode_to_yuv((OUT / name).read_bytes())
            if recon_digest(yuv) != digest:
                raise AssertionError(f"{name}: libavif decode != recon")
        log("  libavif decode == recon for both outputs")
    FR._PLANNER_CACHE.clear()


def phase_pipeline():
    import bench
    from oavif_jax.backend.oavif import OavifBackend
    from oavif_jax.tq.pipeline import search_encode_corpus

    names = list(bench.corpus(512))
    ctxs = [bench._make_ctx(img) for img in bench.corpus(512).values()]
    results = search_encode_corpus(ctxs, OavifBackend())
    errors = search_encode_corpus.last_errors
    if any(errors):
        raise AssertionError(f"pipeline errors: {errors}")
    mode = search_encode_corpus.last_mode
    n_dev = search_encode_corpus.last_device_scores
    if mode != "hybrid" or n_dev < 1:
        raise AssertionError(f"scorer {mode}, {n_dev} device scores")
    for name, (res, data) in zip(names, results):
        log(f"  {name}: q{res.q} score {res.score:.2f} "
            f"{res.num_pass} passes {len(data)} bytes")
    log(f"  scorer {mode}, {n_dev} probe scores on the device; wall "
        f"{search_encode_corpus.last_wall:.2f} s")


def phase_device_stage():
    import bench

    checked, worst, worst_n = device_level_errors(bench.corpus(512)["fractal"],
                                                  40)
    log(f"  {checked} blocks; max |level diff| {worst}, max differing "
        f"levels per block {worst_n}")
    if checked <= 50 or worst > 1 or worst_n > 4:
        raise AssertionError("device levels off the host recompute")


def phase_four_cards(photo):
    from unittest import mock

    import jax

    import __graft_entry__
    from oavif_jax.av1 import frame as FR

    devs = jax.devices()
    if len(devs) < 4 or any(d.platform != "gpu" for d in devs[:4]):
        raise RuntimeError(f"--four-cards needs four GPUs, found {devs}")
    pam = OUT / "photo_12mp.pam"
    write_pam(pam, photo)
    compiles = Compiles()
    try:
        outs = {}
        for label, visible in (("4 cards", devs), ("card 0", devs[:1])):
            FR._PLANNER_CACHE.clear()
            with mock.patch.object(jax, "devices", lambda *a: visible):
                lines, wall, comp, rec, data = run_cli(
                    CLI_FLAGS + ["-q", "60", "--tile-cols-log2", "2",
                                 str(pam)], OUT / "four.avif", compiles)
            placed = {d for fp in FR._PLANNER_CACHE.values()
                      for a in fp.dev for d in a.devices()}
            log(f"  {label}: {len(rec['tiles'])} tiles, planners on "
                f"{sorted(str(d) for d in placed)}, {len(data)} bytes, "
                f"wall {wall:.2f} s")
            if not all(p and c for p, c in rec["tiles"]):
                raise AssertionError(f"tile encodes {rec['tiles']}")
            outs[label] = (data, placed)
        if len(outs["4 cards"][1]) != 4:
            raise AssertionError("tile planners did not spread over 4 cards")
        if outs["4 cards"][0] != outs["card 0"][0]:
            raise AssertionError("4-card bytes differ from card-0 bytes")
        log("  4-card tiled bytes == card-0 bytes")
    finally:
        pam.unlink()
        (OUT / "four.avif").unlink(missing_ok=True)
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    log(f"  dryrun_multichip(4) passed in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase (g) on four cards, and no other phase")
    args = ap.parse_args(argv)

    # phase (b) compares the card with JAX's CPU backend in this process
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, str(REPO))
    from oavif_jax.runtime import enable_compile_cache, require_gpu

    import jax

    enable_compile_cache()
    try:
        gpu = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    import bench

    OUT.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    photo = bench._img_fractal(*PHOTO_HW, seed=5)
    if args.four_cards:
        log(f"card: {nvidia_smi()}")
        log("(g) four cards")
        phase_four_cards(photo)
    else:
        compiles = Compiles()

        def phase(name, fn):
            t0 = time.perf_counter()
            log(name)
            compiles.take()
            out = fn()
            n_comp, comp_s = compiles.take()
            log(f"  [{time.perf_counter() - t0:.1f} s; {n_comp} XLA "
                f"compiles, {comp_s} s]")
            return out

        libavif = phase("(a) environment", lambda: phase_env(gpu))
        phase("(b) planner parity, GPU vs CPU backend",
              lambda: phase_planner(gpu, photo))
        phase("(c) metric parity, JAX on GPU vs ssimu2.c",
              lambda: phase_metric(photo))
        phase("(d) CLI end to end, 12 MP",
              lambda: phase_cli(gpu, photo, compiles, libavif))
        phase("(e) corpus pipeline, 6 x 512",
              phase_pipeline)
        phase("(f) device_stage levels vs float64 host", phase_device_stage)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
