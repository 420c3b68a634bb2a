"""Search drivers: glue between the TQ algorithms and an encoder backend.

The sequential driver replicates the reference loop exactly (one encode +
decode + score per pass, tq.zig:124-210). The batched driver is the
device-batched variant (BASELINE.json config 2): each round encodes a small
vector of candidate quantizers concurrently (tile encodes run in the C
runtime with the GIL released) and scores the whole batch in ONE device
step (vmapped SSIMULACRA2 against the precomputed reference pyramid), so
wall-clock per round ≈ one encode + one device call.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace
from typing import Dict, Tuple

import numpy as np

from ..backend import EncBuffer, EncCtx
from .search import (
    SearchResult,
    find_target_quality,
    find_target_quality_batched,
    predict_q_native,
)


def make_probe(ctx: EncCtx, backend, metric):
    """One search pass: encode at q, reconstruct/decode, score, cache the
    bitstream (reference tq.zig:21-38). The product backend scores its own
    reconstruction (== decoder output) instead of round-tripping bytes."""

    def probe(q: int) -> float:
        t0 = time.time()
        ctx.q = q
        if hasattr(backend, "encode_with_recon"):
            data, decoded = backend.encode_with_recon(ctx)
        else:
            data = backend.encode(ctx)
            decoded = backend.decode_to_rgb8(data)
        ctx.num_pass += 1
        ctx.buf = EncBuffer(q=q, data=data, size=len(data))
        probe.cache[q] = data
        score = float(metric(ctx.rgb, decoded))
        probe.timings.append(round((time.time() - t0) * 1000, 1))
        return score

    probe.cache = {}
    probe.timings = []
    return probe


def make_probe_batch(ctx: EncCtx, backend, batch_width: int):
    """Batched probe: encode each candidate concurrently, score the recon
    batch in one vmapped device step. Pads the batch to a fixed width so
    every round reuses one compiled executable."""
    from concurrent.futures import ThreadPoolExecutor

    from ..metric.native import score_batch_auto

    def probe_batch(qs):
        t0 = time.time()

        def enc(q):
            return backend.encode_with_recon(replace(ctx, q=q))

        # Concurrency pays only with real cores: the C tile encoder releases
        # the GIL, but on a single-core host threads just thrash the cache.
        workers = min(len(qs), os.cpu_count() or 1)
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                outs = list(ex.map(enc, qs))
        else:
            outs = [enc(q) for q in qs]
        recons = [r for (_, r) in outs]
        batch = np.stack(recons + [recons[-1]] * (batch_width - len(recons)))
        scores = score_batch_auto(ctx.rgb, batch)[: len(qs)]
        for q, (data, _) in zip(qs, outs):
            ctx.buf = EncBuffer(q=q, data=data, size=len(data))
            probe_batch.cache[q] = data
        # pass accounting counts ENCODES so the stderr "N passes" line
        # stays apples-to-apples with the reference's one-encode-per-pass
        # semantics (a batched round performs len(qs) encodes); the round
        # count is tracked separately for the verbose report
        ctx.num_pass += len(qs)
        ctx.num_rounds = getattr(ctx, "num_rounds", 0) + 1
        probe_batch.timings.append(round((time.time() - t0) * 1000, 1))
        return [float(s) for s in scores]

    probe_batch.cache = {}
    probe_batch.timings = []
    return probe_batch


def search_encode(
    ctx: EncCtx, backend, metric=None
) -> Tuple[SearchResult, bytes]:
    """Run the target-quality search for ctx.o and return (result, final
    AVIF bytes), reusing a cached bitstream when the selected quantizer was
    already probed (reference main.zig:109-113).

    Batched speculative probing is the default on backends that expose
    encode_with_recon; OAVIF_TQ_BATCH=0 forces the reference's sequential
    loop, OAVIF_TQ_BATCH_WIDTH sets candidates per round (default 4).
    """
    o = ctx.o
    # Batched speculative probing trades candidate encodes for fewer
    # sequential rounds. Even on a single core a 2-wide bracket pays: the
    # two candidates straddle the target so one round usually decides
    # (measured: 3-4 rounds → 1 on the bench corpus), and each round
    # amortizes one device scoring step. Wider batches only pay with real
    # cores to encode on. Env overrides: OAVIF_TQ_BATCH=0/1, _WIDTH=N.
    batch_env = os.environ.get("OAVIF_TQ_BATCH")
    if batch_env is not None:
        use_batch = batch_env != "0"
    else:
        # Batched speculative probing amortizes one device metric call
        # over several candidate encodes. With the host-native metric the
        # reference's sequential loop (1 encode per round, seed usually
        # within tolerance) is used; which is faster on the GPU host is
        # not measured yet.
        from ..metric.native import metric_impl

        use_batch = metric_impl() != "c"
    use_batch = use_batch and hasattr(backend, "encode_with_recon")
    cache: Dict[int, bytes]
    if use_batch:
        default_w = "4" if (os.cpu_count() or 1) >= 4 else "2"
        bw = max(1, int(os.environ.get("OAVIF_TQ_BATCH_WIDTH", default_w)))
        probe_b = make_probe_batch(ctx, backend, bw)
        result = find_target_quality_batched(
            probe_b, o.score_tgt, o.tolerance, o.max_pass, batch_width=bw,
            seed_fn=predict_q_native,
        )
        cache = probe_b.cache
    else:
        if metric is None:
            from ..metric.native import compute_ssimulacra2_native, metric_impl

            if metric_impl() == "c":
                metric = lambda r, d: compute_ssimulacra2_native(r, d)  # noqa: E731
            else:
                # reference pyramid stays device-resident across probes
                from ..metric import make_ref_scorer

                metric = make_ref_scorer(ctx.rgb)
        probe = make_probe(ctx, backend, metric)
        result = find_target_quality(
            probe, o.score_tgt, o.tolerance, o.max_pass,
            seed_fn=predict_q_native, slope_prior=(2.1, 0.7),
        )
        cache = probe.cache

    ctx.q = result.q
    data = cache.get(result.q)
    if data is None:
        data = backend.encode(ctx)
    probe_obj = probe_b if use_batch else probe
    search_encode.last_timings = list(probe_obj.timings)
    return result, data
