"""Corpus search pipeline: interleave many TQ searches over one host core
with asynchronous device scoring.

The reference encodes a corpus strictly sequentially: for each image, each
pass runs encode -> decode -> metric on the host before the next step
(scripts/measure.py over src/main.zig). Here the host core and the GPU are
separate resources: while the card scores image A's reconstruction
(SSIMULACRA2 against A's device-resident reference pyramid,
metric/ssimulacra2.py), the host core is free to encode image B's next
probe. This module schedules exactly that:

  - every image's search is the UNCHANGED reference loop
    (tq/search.py search_quality_gen — the same generator that backs
    find_target_quality, trace-golden-tested);
  - a single device worker thread owns all device traffic: per-image
    reference pyramids, per-probe scoring, and next-image plan prefetch
    (av1/encode.py prefetch_plan), so the device round trips hide behind
    host encodes;
  - the host thread round-robins over images whose next quantizer is
    known, encoding one probe at a time (the C tile encoder releases the
    GIL, so the worker's waits never block it).

Scoring implementation: "hybrid" on a GPU backend, the host C scorer on
the CPU backend (OAVIF_PIPELINE_METRIC=c|jax|hybrid forces one). The JAX
and C scorers agree within the tested epsilon (tests/test_metric.py), so
a pipelined search may settle on a quantizer one step away from the
sequential one — both satisfy the same tolerance contract.

Wall-clock accounting: per-image `host_s` is that image's own encode time
(comparable to the reference's per-image encode wall); the corpus
throughput number must use the single overall wall, since that is what
the pipeline improves.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..backend import EncBuffer, EncCtx
from .search import SearchResult, predict_q_native, search_quality_gen


def _pick_scorer_mode() -> str:
    """The scorer: "hybrid" on a device backend, where each probe's
    score goes to the device worker WHEN another image has a probe ready
    for the host core to encode (the device round trip then hides behind
    that encode), and runs inline on the host C scorer when the pipeline
    would otherwise stall (the corpus tail, where a device round trip's
    latency lands on the wall). On the CPU backend the "device" is the same core, so the
    C scorer is used throughout. OAVIF_PIPELINE_METRIC=c|jax|hybrid
    forces a mode."""
    mode = os.environ.get("OAVIF_PIPELINE_METRIC", "auto").lower()
    if mode in ("c", "jax", "hybrid"):
        return mode
    import jax

    return "c" if jax.default_backend() == "cpu" else "hybrid"


@dataclass(eq=False)
class _ImgState:
    index: int
    ctx: EncCtx
    gen: object
    scorer: object = None  # device closure or C ctx
    pending_q: Optional[int] = None  # next quantizer to encode
    future: object = None  # in-flight score
    future_q: int = -1
    result: Optional[SearchResult] = None
    error: Optional[str] = None
    cache: Dict[int, bytes] = field(default_factory=dict)
    host_s: float = 0.0
    timings: List[float] = field(default_factory=list)
    t_probe0: float = 0.0


def search_encode_corpus(
    ctxs: List[EncCtx], backend
) -> List[Tuple[SearchResult, bytes]]:
    """Run the target-quality search for every ctx, software-pipelined.

    Returns [(SearchResult, avif bytes)] in input order. Semantics per
    image match tq/driver.py search_encode's sequential loop (same
    search generator, same cached-bitstream final selection,
    main.zig:109-113); only the scheduling and the scoring transport
    differ."""
    mode = _pick_scorer_mode()
    states: List[_ImgState] = []
    for idx, ctx in enumerate(ctxs):
        gen = search_quality_gen(
            ctx.o.score_tgt, ctx.o.tolerance, ctx.o.max_pass,
            seed_fn=predict_q_native, slope_prior=(2.1, 0.7),
        )
        st = _ImgState(index=idx, ctx=ctx, gen=gen)
        try:
            st.pending_q = next(gen)
        except StopIteration as stop:  # max_pass == 0 degenerate
            st.result = stop.value
        states.append(st)

    worker = ThreadPoolExecutor(max_workers=1)
    prefetches = []
    device_scores = [0]

    def _make_scorer(st: _ImgState, kind: str):
        if kind == "jax":
            from ..metric import make_ref_scorer

            fn = make_ref_scorer(st.ctx.rgb)
            return lambda d: float(fn(None, d))
        from ..metric.native import _get_ctx

        cctx = _get_ctx(st.ctx.rgb)
        return lambda d: float(cctx.score(d))

    def _score_task(st: _ImgState, recon, kind: str):
        # st.scorer caches per-kind closures: the device one owns the
        # image's device-resident reference pyramid, the C one the host
        # metric context; hybrid mode may use both over one search
        if st.scorer is None:
            st.scorer = {}
        if kind not in st.scorer:
            st.scorer[kind] = _make_scorer(st, kind)
        score = st.scorer[kind](recon)
        if kind == "jax":
            device_scores[0] += 1
        return score

    def _prefetch_task(st: _ImgState):
        from ..av1.encode import prefetch_plan

        prefetch_plan(st.ctx, st.pending_q if st.pending_q is not None
                      else predict_q_native(st.ctx.o.score_tgt))

    prefetched = [False] * len(states)

    def _advance(st: _ImgState, score: float):
        st.timings.append(round((time.time() - st.t_probe0) * 1000, 1))
        try:
            st.pending_q = st.gen.send(score)
        except StopIteration as stop:
            st.result = stop.value
            st.pending_q = None

    def _reap(block_on: Optional[_ImgState] = None):
        for st in states:
            if st.future is None:
                continue
            if st is block_on or st.future.done():
                score = st.future.result()
                st.future = None
                _advance(st, score)

    t_corpus0 = time.perf_counter()
    # prefetch the first image's plan inline-equivalent: submit now; the
    # chain below prefetches image k+1 when image k first encodes
    if states:
        prefetches.append(worker.submit(_prefetch_task, states[0]))

    while True:
        _reap()
        ready = [st for st in states
                 if st.result is None and st.error is None
                 and st.pending_q is not None and st.future is None]
        if not ready:
            waiting = [st for st in states if st.future is not None]
            if not waiting:
                break
            _reap(block_on=waiting[0])
            continue
        st = ready[0]
        i = st.index
        if not prefetched[i]:
            prefetched[i] = True
            if i + 1 < len(states):
                prefetches.append(
                    worker.submit(_prefetch_task, states[i + 1]))
        q = st.pending_q
        st.pending_q = None
        st.t_probe0 = time.time()
        t0 = time.perf_counter()
        ctx = st.ctx
        ctx.q = q
        try:
            data, recon = backend.encode_with_recon(ctx)
        except Exception as e:  # per-image failure: the corpus continues
            st.error = f"{type(e).__name__}: {e}"
            st.host_s += time.perf_counter() - t0
            continue
        st.host_s += time.perf_counter() - t0
        ctx.num_pass += 1
        ctx.buf = EncBuffer(q=q, data=data, size=len(data))
        st.cache[q] = data
        st.future_q = q
        if mode == "jax":
            st.future = worker.submit(_score_task, st, recon, "jax")
        elif mode == "hybrid" and any(
            s2.pending_q is not None and s2.result is None
            and s2.error is None for s2 in states if s2 is not st
        ):
            # another image can keep the host core busy: ship this score
            # to the device worker so its round-trip hides behind that
            # image's encode (single-core host: an inline C score would
            # serialize with every encode)
            st.future = worker.submit(_score_task, st, recon, "jax")
        else:
            # host scorer: scoring can't overlap the host encode on the
            # same core, so run it inline (sequential semantics); the
            # worker still hides the next image's planner round-trip.
            # hybrid lands here at the corpus tail, where no other host
            # work exists to hide a device round-trip behind
            t0 = time.perf_counter()
            score = _score_task(st, recon, "c")
            st.host_s += time.perf_counter() - t0
            _advance(st, score)

    corpus_wall = time.perf_counter() - t_corpus0
    worker.shutdown(wait=True)
    for f in prefetches:
        f.result()  # a failed plan prefetch raises here, not silently

    out: List[Tuple[Optional[SearchResult], bytes]] = []
    for st in states:
        r = st.result
        if r is None:  # per-image failure (st.error carries the reason)
            out.append((None, b""))
            continue
        st.ctx.q = r.q
        data = st.cache.get(r.q)
        if data is None:
            data = backend.encode(st.ctx)
        out.append((r, data))
    search_encode_corpus.last_wall = corpus_wall
    search_encode_corpus.last_errors = [st.error for st in states]
    search_encode_corpus.last_host_s = [st.host_s for st in states]
    search_encode_corpus.last_timings = [st.timings for st in states]
    search_encode_corpus.last_mode = mode
    search_encode_corpus.last_device_scores = device_scores[0]
    return out
