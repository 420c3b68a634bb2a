"""Range coder round-trip property tests.

The encoder/decoder pair must be mutually exact for any symbol sequence;
conformance against dav1d is separately anchored by full-bitstream decode
(tests/test_conformance.py).
"""

import numpy as np
import pytest

from oavif_jax.av1.entropy import RangeDecoder, RangeEncoder, update_cdf


def _random_icdf(rng, nsyms):
    """Random strictly-decreasing ICDF with headroom for EC_MIN_PROB."""
    cuts = np.sort(rng.choice(np.arange(1, 32768 // 32), nsyms - 1, replace=False))
    icdf = (32768 - cuts * 32).astype(np.int64).tolist()
    return icdf + [0]


@pytest.mark.parametrize("seed", range(8))
def test_roundtrip_static_cdfs(seed):
    rng = np.random.default_rng(seed)
    enc = RangeEncoder()
    plan = []
    for _ in range(500):
        nsyms = int(rng.integers(2, 16))
        icdf = _random_icdf(rng, nsyms)
        s = int(rng.integers(0, nsyms))
        plan.append((s, icdf, nsyms))
        enc.encode_symbol(s, icdf, nsyms)
    data = enc.done()
    dec = RangeDecoder(data)
    for s, icdf, nsyms in plan:
        assert dec.decode_symbol(icdf, nsyms) == s


@pytest.mark.parametrize("seed", range(4))
def test_roundtrip_adaptive_cdfs(seed):
    # Both sides adapt the CDFs identically (normative update_cdf).
    rng = np.random.default_rng(100 + seed)
    ncdf = 8
    enc_cdfs = []
    dec_cdfs = []
    for _ in range(ncdf):
        nsyms = int(rng.integers(2, 14))
        icdf = _random_icdf(rng, nsyms)
        enc_cdfs.append((list(icdf) + [0], nsyms))  # +counter slot
        dec_cdfs.append(([*icdf, 0], nsyms))

    enc = RangeEncoder()
    plan = []
    for _ in range(800):
        k = int(rng.integers(0, ncdf))
        icdf, nsyms = enc_cdfs[k]
        s = int(rng.integers(0, nsyms))
        plan.append((k, s))
        enc.encode_symbol(s, icdf, nsyms)
        update_cdf(icdf, s, nsyms)
    data = enc.done()

    dec = RangeDecoder(data)
    for k, s in plan:
        icdf, nsyms = dec_cdfs[k]
        got = dec.decode_symbol(icdf, nsyms)
        assert got == s
        update_cdf(icdf, s, nsyms)


def test_roundtrip_bools_and_literals():
    rng = np.random.default_rng(7)
    enc = RangeEncoder()
    plan = []
    for _ in range(2000):
        kind = rng.integers(0, 3)
        if kind == 0:
            b = int(rng.integers(0, 2))
            f = int(rng.integers(256, 32500))
            plan.append(("bool", b, f))
            enc.encode_bool_q15(b, f)
        elif kind == 1:
            bits = int(rng.integers(1, 16))
            v = int(rng.integers(0, 1 << bits))
            plan.append(("lit", v, bits))
            enc.encode_literal(v, bits)
        else:
            nsyms = int(rng.integers(2, 16))
            icdf = _random_icdf(rng, nsyms)
            s = int(rng.integers(0, nsyms))
            plan.append(("sym", s, (icdf, nsyms)))
            enc.encode_symbol(s, icdf, nsyms)
    data = enc.done()
    dec = RangeDecoder(data)
    for kind, v, extra in plan:
        if kind == "bool":
            assert dec.decode_bool_q15(extra) == v
        elif kind == "lit":
            assert dec.decode_literal(extra) == v
        else:
            icdf, nsyms = extra
            assert dec.decode_symbol(icdf, nsyms) == v


def test_update_cdf_moves_toward_coded_symbol():
    icdf = [24000, 16000, 8000, 0, 0]  # 4 symbols + counter
    before = list(icdf)
    update_cdf(icdf, 0, 4)
    # coding symbol 0 increases its probability; in inverse-CDF form the
    # cumulative through 0 rises, so icdf[0] falls toward 0
    assert icdf[0] < before[0]
    assert icdf[3] == 0
    assert icdf[4] == 1  # counter incremented


def test_skewed_cdf_many_symbols():
    # extreme skew exercises renormalization paths
    icdf = [64, 32, 16, 0]
    enc = RangeEncoder()
    seq = [0] * 100 + [3] * 5 + [0] * 100 + [1, 2] * 10
    for s in seq:
        enc.encode_symbol(s, icdf, 4)
    data = enc.done()
    dec = RangeDecoder(data)
    for s in seq:
        assert dec.decode_symbol(icdf, 4) == s


def test_empty_and_single_symbol():
    enc = RangeEncoder()
    enc.encode_bool_q15(1, 16384)
    data = enc.done()
    assert len(data) >= 1
    dec = RangeDecoder(data)
    assert dec.decode_bool_q15(16384) == 1
