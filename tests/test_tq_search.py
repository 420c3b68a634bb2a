"""Search-trace goldens for the TQ engine (SURVEY.md §4c).

The traces below were derived by hand-executing the reference algorithm
(/root/reference/src/tq.zig:124-210) against synthetic monotone score
models, asserting the exact (q, score) probe sequence and final selection.
"""

import math

from oavif_jax.tq import (
    PassResult,
    find_target_quality,
    interpolate_quantizer,
    predict_q_from_score,
)
from oavif_jax.tq.search import find_target_quality_batched


def test_seed_prediction_matches_reference_formula():
    # q = round(6.83 * e^(0.0282*tgt)), capped at 100 (tq.zig:40-43)
    assert predict_q_from_score(80.0) == round(6.83 * math.exp(0.0282 * 80.0))
    assert predict_q_from_score(80.0) == 65
    assert predict_q_from_score(100.0) == 100  # 114.9 capped
    assert predict_q_from_score(30.0) == 16


def test_interpolate_empty_history_bisects():
    assert interpolate_quantizer(0, 100, [], 80.0) == 50
    assert interpolate_quantizer(10, 31, [], 80.0) == 20


def test_interpolate_single_point_bisects():
    hist = [PassResult(q=65, score=85.0)]
    assert interpolate_quantizer(40, 65, hist, 80.0) == 52


def test_interpolate_two_points_linear():
    # scores sorted ascending: (70→q40), (90→q80); target 80 → q60
    hist = [PassResult(q=80, score=90.0), PassResult(q=40, score=70.0)]
    assert interpolate_quantizer(0, 100, hist, 80.0) == 60


def test_interpolate_equal_scores_falls_back_to_bisect():
    hist = [PassResult(q=80, score=75.0), PassResult(q=40, score=75.0)]
    assert interpolate_quantizer(0, 100, hist, 80.0) == 50


def test_interpolate_three_points_quadratic():
    # y = q: score = q → exact quadratic through (60,60),(70,70),(90,90);
    # target 80 → q 80.
    hist = [
        PassResult(q=90, score=90.0),
        PassResult(q=60, score=60.0),
        PassResult(q=70, score=70.0),
    ]
    assert interpolate_quantizer(0, 100, hist, 80.0) == 80


def test_clamps_to_bounds():
    hist = [PassResult(q=80, score=90.0), PassResult(q=40, score=70.0)]
    assert interpolate_quantizer(65, 100, hist, 80.0) == 65


def _linear_score_model(q):
    # score(q) = q * 0.9 + 15 → hits 80 at q ≈ 72.2
    return q * 0.9 + 15.0


def test_search_trace_linear_model():
    probes = []

    def probe(q):
        probes.append(q)
        return _linear_score_model(q)

    res = find_target_quality(probe, 80.0, 2.0, 6)
    # Hand-derived reference trace:
    # pass0: q=65 → 73.5, under → lo=65, hi=min(100,65+ceil(6.5)*4=28)=93
    # pass1: 1 point → bisect (65+93)//2=79 → 86.1, over → hi=79
    # pass2: linear through (73.5,65),(86.1,79) → q≈72.2 → 72 → 79.8 within tol
    assert probes == [65, 79, 72]
    assert res.q == 72
    assert abs(res.score - 79.8) < 1e-9
    assert res.num_pass == 3


def test_search_trace_immediate_hit():
    res = find_target_quality(lambda q: 80.5, 80.0, 2.0, 6)
    assert res.q == 65 and res.num_pass == 1


def test_search_selects_lowest_q_meeting_target():
    # A model that never lands within tolerance: score jumps across target.
    def probe(q):
        return 95.0 if q >= 60 else 60.0

    res = find_target_quality(probe, 80.0, 1.0, 6)
    # All probed q >= 60 score 95; the final pick is the lowest probed q
    # with score >= 80.
    assert res.score == 95.0
    assert res.q == min(h.q for h in res.history if h.score >= 80.0)


def test_search_all_below_target_picks_highest_scoring():
    def probe(q):
        return q * 0.5  # max 50, never reaches 80

    res = find_target_quality(probe, 80.0, 1.0, 4)
    best = max(res.history, key=lambda h: (max(h.score, 0.0)))
    assert res.score == best.score


def test_search_duplicate_q_terminates():
    # Constant score → interpolation denominators vanish → bisect repeats.
    calls = []

    def probe(q):
        calls.append(q)
        return 50.0

    res = find_target_quality(probe, 80.0, 1.0, 12)
    assert len(calls) == len(set(calls))  # never re-probes
    assert res.num_pass <= 12


def test_search_range_collapse():
    # Sharp model: overshoot at pass 0 with tiny error bound.
    def probe(q):
        return 82.5 if q >= 65 else 20.0

    res = find_target_quality(probe, 80.0, 1.0, 12)
    # pass0: q65 → 82.5, err 2.5 → bound ceil(2.5)*4=12 → hi=65, lo=53
    assert res.history[0] == PassResult(q=65, score=82.5)
    assert res.q >= 53


def test_batched_search_converges_fewer_rounds():
    def probe_batch(qs):
        return [_linear_score_model(q) for q in qs]

    res = find_target_quality_batched(probe_batch, 80.0, 2.0, 6, batch_width=4)
    assert abs(res.score - 80.0) < 2.0
    # Sequential needs 3 passes on this model; batched should need ≤ 2 rounds.
    assert res.num_pass <= 2


def test_batched_search_matches_selection_policy():
    def probe_batch(qs):
        return [q * 0.5 for q in qs]  # never reaches target

    res = find_target_quality_batched(probe_batch, 80.0, 1.0, 4)
    assert res.score == max(max(h.score, 0.0) for h in res.history)


def test_search_encode_batched_hits_target(monkeypatch):
    """The batched driver must hit the target within tolerance on the real
    encoder and reuse a cached bitstream for the selected quantizer."""
    import numpy as np
    from oavif_jax.backend import EncCtx
    from oavif_jax.backend.oavif import OavifBackend
    from oavif_jax.io.image import Image
    from oavif_jax.options import EncOptions
    from oavif_jax.tq.driver import search_encode

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float64)
    img = np.stack(
        [128 + 90 * np.sin(xx / 13) * np.cos(yy / 17),
         120 + 70 * np.cos(xx / 23),
         100 + 80 * np.sin((xx + yy) / 29)], -1)
    img = np.clip(img + rng.normal(0, 5, img.shape), 0, 255).astype(np.uint8)

    src = Image(width=128, height=128, channels=3, hbd=False, data=img)
    ctx = EncCtx(o=EncOptions(tenbit=False), src=src, rgb=img, w=128, h=128)
    monkeypatch.setenv("OAVIF_TQ_BATCH", "1")
    res, data = search_encode(ctx, OavifBackend())
    assert data[:12].endswith(b"ftyp" + b"avif") or data[4:8] == b"ftyp"
    assert res.num_pass <= ctx.o.max_pass
    # either within tolerance or the best-achievable endpoint
    assert res.score >= ctx.o.score_tgt - ctx.o.tolerance or res.q == 100
