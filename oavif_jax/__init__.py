"""oavif-jax: a target-quality AVIF still-image encoder.

A from-scratch JAX + C re-design of the capability surface of
Enter-tainer/oavif: given an input image and a target SSIMULACRA2 score,
search the quantizer that meets the target within a tolerance and pass
budget, and emit a standard .avif file.

Layering:
  - ``oavif_jax.cli``      — the command line (reference src/main.zig).
  - ``oavif_jax.options``  — encoder options + CLI arg parsing (parity with
    reference src/parse_args.zig:48-122).
  - ``oavif_jax.tq``       — the target-quality search engine (parity with
    reference src/tq.zig:124-210), batched speculative probing and the
    corpus pipeline.
  - ``oavif_jax.io``       — host-side image ingestion (PNG/PAM/JPEG/WebP/
    AVIF) and the libavif decoder binding used for conformance checks.
  - ``oavif_jax.metric``   — SSIMULACRA2 in JAX on the device, its host C
    twin, and a width-sharded variant for several devices.
  - ``oavif_jax.av1``      — the AV1 intra encoder: the device planner
    (device_plan), the host C tile coder with its Python mirror, loop
    filters, OBU writer and ISOBMFF/AVIF muxer.
  - ``oavif_jax.backend``  — encoder backends: ``oavif`` (ours) and
    ``oracle`` (libavif/libaom via Pillow — conformance oracle + baseline
    only).
  - ``oavif_jax.runtime``  — process set-up for the entry points (compile
    cache, GPU check).
"""

__version__ = "0.2.0"
