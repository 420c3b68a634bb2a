#!/usr/bin/env python3
"""Check that AVIF files decode to the encoder's reconstruction.

    python tools/check_recon.py smoke_out

Reads recon_digests.json from the directory (written by chip_smoke.py's
CLI phase: {file name: sha256 of the recon's int32 Y, U, V planes}),
decodes each named .avif with the system libavif and compares the digest
of the decoded planes. Exits non-zero on any mismatch.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv) -> int:
    from chip_smoke import recon_digest
    from oavif_jax.io.avif_ctypes import decode_to_yuv

    out = Path(argv[0])
    digests = json.loads((out / "recon_digests.json").read_text())
    bad = 0
    for name, want in sorted(digests.items()):
        yuv, depth, _ = decode_to_yuv((out / name).read_bytes())
        ok = recon_digest(yuv) == want
        bad += not ok
        print(f"{name}: {yuv[0].shape[1]}x{yuv[0].shape[0]} {depth}-bit, "
              f"decode {'==' if ok else '!='} recon")
    return 1 if bad or not digests else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
