"""gprof harness for oav1tile.c's tile_encode.

The shared library can't be gprof'd through ctypes, so this runs ONE
product encode with OAVIF_DUMP_TILE_INPUTS set (fast.py dumps every
marshaled buffer at the ctypes boundary — the dump therefore always
matches the real ABI), then builds a small C main that replays the call
N times with -pg. Run:

    python tools/profile_c_tile.py [image] [quality] [passes]
    # image: any bench.py class (sinusoid|fractal|edges|oriented|text|mixed)
    # passes: 1 = profile the RECORD (first-probe) encode,
    #         2 = profile the REPLAY encode (decisions consumed)
    cd /tmp/prof3 && ./prof_tile 30 && gprof ./prof_tile gmon.out | head -40
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/root/.cache/jax_comp")

OUT = Path(os.environ.get("PROF_DIR", "/tmp/prof3"))

PROF_MAIN = r"""
/* gprof harness: load dumped tile_encode inputs, run N iterations. */
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
#include <string.h>

size_t tile_encode(
    const int32_t *const *src_planes, int32_t *const *recon_out,
    int nplanes, int w, int h, int bitdepth, int speed, int qindex,
    int dq_dc, int dq_ac, int dq_ac_uv,
    uint16_t *const *cdf_ptrs, const int32_t *const *scans,
    const int32_t *const *sm_weights,
    const double *const *fhs, const double *const *fws,
    const int32_t *dr_deriv,
    const int32_t *plan, int plan_nbx, int plan_nby,
    int32_t *blocks_out, int32_t *n_blocks_out,
    int32_t *dec_buf, int32_t *dec_len_io, int dec_mode,
    int screen_tools, int filter_intra, const int32_t *fi_taps,
    const int32_t *lr_cfg, int sb128,
    uint8_t **out_payload);
void tile_payload_free(uint8_t *p);

static void *load(const char *dir, const char *name, long *sz) {
    char path[512];
    snprintf(path, sizeof path, "%s/%s", dir, name);
    FILE *f = fopen(path, "rb");
    if (!f) { fprintf(stderr, "missing %s\n", path); exit(1); }
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    void *buf = malloc((size_t)n);
    if (fread(buf, 1, (size_t)n, f) != (size_t)n) exit(1);
    fclose(f);
    if (sz) *sz = n;
    return buf;
}

int main(int argc, char **argv) {
    const char *dir = getenv("PROF_DIR") ? getenv("PROF_DIR") : "/tmp/prof3";
    int iters = argc > 1 ? atoi(argv[1]) : 20;
    int w, h, nplanes, bitdepth, speed, qindex, dq_dc, dq_ac, dq_ac_uv;
    int plan_nbx, plan_nby, dec_mode, dec_len, screen_tools, filter_intra;
    int has_lr, sb128, ncdf;
    {
        char path[512];
        snprintf(path, sizeof path, "%s/meta.txt", dir);
        FILE *f = fopen(path, "r");
        if (!f) { fprintf(stderr, "missing meta\n"); return 1; }
        if (fscanf(f, "%d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d",
                   &w, &h, &nplanes, &bitdepth, &speed, &qindex, &dq_dc,
                   &dq_ac, &dq_ac_uv, &plan_nbx, &plan_nby, &dec_mode,
                   &dec_len, &screen_tools, &filter_intra, &has_lr, &sb128,
                   &ncdf) != 18)
            return 1;
        fclose(f);
    }
    int32_t *src[3];
    int32_t *recon[3];
    int mi_cols = 2 * ((w + 7) >> 3), mi_rows = 2 * ((h + 7) >> 3);
    char nm[64];
    for (int p = 0; p < nplanes; p++) {
        snprintf(nm, sizeof nm, "src_%d.bin", p);
        src[p] = (int32_t *)load(dir, nm, NULL);
        recon[p] = (int32_t *)calloc((size_t)mi_rows * 4 * mi_cols * 4, 4);
    }
    uint16_t *cdfs[64];
    long cdf_sz[64];
    uint16_t *cdfs0[64];
    for (int i = 0; i < ncdf; i++) {
        snprintf(nm, sizeof nm, "cdf_%d.bin", i);
        cdfs[i] = (uint16_t *)load(dir, nm, &cdf_sz[i]);
        cdfs0[i] = (uint16_t *)malloc((size_t)cdf_sz[i]);
        memcpy(cdfs0[i], cdfs[i], (size_t)cdf_sz[i]);
    }
    int32_t *scans[6];
    for (int i = 0; i < 6; i++) {
        snprintf(nm, sizeof nm, "scan_%d.bin", i);
        scans[i] = (int32_t *)load(dir, nm, NULL);
    }
    int32_t *sms[5];
    for (int i = 0; i < 5; i++) {
        snprintf(nm, sizeof nm, "sm_%d.bin", i);
        sms[i] = (int32_t *)load(dir, nm, NULL);
    }
    double *fhs[11], *fws[11];
    for (int i = 0; i < 11; i++) {
        snprintf(nm, sizeof nm, "fh_%d.bin", i);
        fhs[i] = (double *)load(dir, nm, NULL);
        snprintf(nm, sizeof nm, "fw_%d.bin", i);
        fws[i] = (double *)load(dir, nm, NULL);
    }
    int32_t *dr = (int32_t *)load(dir, "dr.bin", NULL);
    int32_t *plan = NULL;
    if (plan_nbx > 0) plan = (int32_t *)load(dir, "plan.bin", NULL);
    int32_t *dec = NULL, *dec0 = NULL;
    long dec_bytes = 0;
    if (dec_mode) {
        dec = (int32_t *)load(dir, "dec.bin", &dec_bytes);
        dec0 = (int32_t *)malloc((size_t)dec_bytes);
        memcpy(dec0, dec, (size_t)dec_bytes);
    }
    int32_t *fi = (int32_t *)load(dir, "fi.bin", NULL);
    int32_t *lr = NULL;
    if (has_lr) lr = (int32_t *)load(dir, "lr.bin", NULL);

    size_t total = 0;
    for (int it = 0; it < iters; it++) {
        uint8_t *payload = NULL;
        int32_t dl = dec_len;
        size_t n = tile_encode(
            (const int32_t *const *)src, (int32_t *const *)recon, nplanes, w,
            h, bitdepth, speed, qindex, dq_dc, dq_ac, dq_ac_uv,
            (uint16_t *const *)cdfs, (const int32_t *const *)scans,
            (const int32_t *const *)sms, (const double *const *)fhs,
            (const double *const *)fws, dr, plan, plan_nbx, plan_nby,
            NULL, NULL, dec, dec_mode ? &dl : NULL, dec_mode,
            screen_tools, filter_intra, fi, lr, sb128, &payload);
        total += n;
        tile_payload_free(payload);
        /* CDFs adapt (and record-mode writes dec) in place — restore for
         * identical work per iteration */
        for (int i = 0; i < ncdf; i++)
            memcpy(cdfs[i], cdfs0[i], (size_t)cdf_sz[i]);
        if (dec) memcpy(dec, dec0, (size_t)dec_bytes);
    }
    printf("payload bytes/iter: %zu\n", total / (size_t)iters);
    return 0;
}
"""


def main():
    img_name = sys.argv[1] if len(sys.argv) > 1 else "fractal"
    quality = int(sys.argv[2]) if len(sys.argv) > 2 else 86
    passes = int(sys.argv[3]) if len(sys.argv) > 3 else 1

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "benchmod", str(Path(__file__).resolve().parent.parent / "bench.py"))
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)

    from oavif_jax.backend import EncCtx
    from oavif_jax.backend.oavif import OavifBackend
    from oavif_jax.io.image import Image
    from oavif_jax.options import EncOptions

    img = getattr(bm, f"_img_{img_name}")(512, 512)
    ctx = EncCtx(
        o=EncOptions(speed=int(os.environ.get("PROF_SPEED", "9"))),
        src=Image(width=512, height=512, channels=3, hbd=False, data=img),
        rgb=img, w=512, h=512, q=quality,
    )
    be = OavifBackend()
    # passes=1 dumps the record-mode (first) encode; passes=2 warms the
    # decision cache first, then dumps a replay encode
    for i in range(passes):
        if i == passes - 1:
            os.environ["OAVIF_DUMP_TILE_INPUTS"] = str(OUT)
        be.encode_with_recon(ctx)
        os.environ.pop("OAVIF_DUMP_TILE_INPUTS", None)

    (OUT / "prof_main.c").write_text(PROF_MAIN)
    ent = Path(__file__).resolve().parent.parent / "oavif_jax/av1/entropy"
    subprocess.run(
        ["gcc", "-O3", "-march=native", "-pg",
         "--param", "vect-max-version-for-alias-checks=40",
         "-o", str(OUT / "prof_tile"), str(OUT / "prof_main.c"),
         str(ent / "oav1ec.c"), str(ent / "oav1tile.c"), "-lm"],
        check=True)
    print(f"built {OUT}/prof_tile  (image={img_name} q={quality} "
          f"passes={passes})")


if __name__ == "__main__":
    main()
