"""Batched device CAVLC vs the scalar host codec (ops/cavlc.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from h264_fer.bitstream.bitio import BitWriter
from h264_fer.ops import cavlc
from h264_fer.ops.cavlc_jax import (
    block_symbols_bulk,
    finalize_symbols,
    nc_to_ctx,
    pack_symbols,
    se_bits,
    ue_bits,
    words_to_bytes,
)


def _flush(w: BitWriter) -> bytes:
    if w.bit_position % 8:
        w.write(0, 8 - w.bit_position % 8)
    return w.getvalue()


def _random_levels(rng, n, L, density, amp):
    lv = rng.integers(-amp, amp + 1, (n, L)).astype(np.int32)
    mask = rng.random((n, L)) < density
    lv = np.where(mask, lv, 0)
    return lv


@pytest.mark.parametrize("L,mnc", [(16, 16), (15, 15), (4, 4)])
def test_block_symbols_bulk_matches_scalar(L, mnc):
    rng = np.random.default_rng(L)
    cases = []
    for density, amp in ((0.1, 2), (0.3, 4), (0.7, 30), (1.0, 3000), (0.0, 1)):
        cases.append(_random_levels(rng, 64, L, density, amp))
    levels = np.concatenate(cases)
    out = block_symbols_bulk(jnp.asarray(levels), mnc)
    tc = np.asarray(out["tc"])
    rest = np.asarray(out["rest_bits"])
    ct_len = np.asarray(out["ct_len"])
    vals = np.asarray(out["vals"])
    lens = np.asarray(out["lens"])
    ncs = [-1] if mnc == 4 else [0, 2, 4, 8]
    for i in range(levels.shape[0]):
        for nc in ncs:
            syms, tc_ref = cavlc.block_symbols(list(levels[i]), nc, mnc)
            assert tc[i] == tc_ref
            total_ref = sum(n for _, n in syms)
            ctx = cavlc.nc_context(nc)
            assert int(rest[i] + ct_len[i, ctx]) == total_ref, (i, nc)
        # bit-level identity of the fused symbol stream (at ctx of nc=0 or -1)
        nc = ncs[0]
        ctx = cavlc.nc_context(nc)
        syms, _ = cavlc.block_symbols(list(levels[i]), nc, mnc)
        w = BitWriter()
        for v, n in syms:
            w.write(v, n)
        w2 = BitWriter()
        fv, fl = finalize_symbols(
            {k: jnp.asarray(v[i : i + 1]) for k, v in
             (("ct_val", np.asarray(out["ct_val"])), ("ct_len", ct_len),
              ("vals", vals), ("lens", lens))},
            jnp.asarray([ctx]),
        )
        for v, n in zip(np.asarray(fv)[0], np.asarray(fl)[0]):
            if n > 0:
                w2.write(int(v), int(n))
        assert w.bit_position == w2.bit_position
        assert _flush(w) == _flush(w2), i


def test_nc_to_ctx():
    for nc in range(0, 32):
        assert int(nc_to_ctx(jnp.asarray(nc))) == cavlc.nc_context(nc)


def test_ue_se_bits():
    from h264_fer.bitstream.expgolomb import ue_code as host_ue

    vs = np.array([0, 1, 2, 3, 4, 7, 8, 100, 65534], np.int32)
    nb = np.asarray(ue_bits(jnp.asarray(vs)))
    for v, n in zip(vs, nb):
        assert n == host_ue(int(v))[1]
    sv = np.array([0, 1, -1, 2, -2, 17, -300], np.int32)
    snb = np.asarray(se_bits(jnp.asarray(sv)))
    for v, n in zip(sv, snb):
        u = 2 * v - 1 if v > 0 else -2 * v
        assert n == host_ue(int(u))[1]


def test_pack_symbols_matches_bitwriter():
    rng = np.random.default_rng(7)
    n = 5000
    lens = rng.integers(0, 29, n).astype(np.int32)
    vals = np.array(
        [rng.integers(0, 1 << max(l, 1)) for l in lens], np.int32
    )
    # symbols with length 0 are skipped
    w = BitWriter()
    for v, l in zip(vals, lens):
        if l > 0:
            w.write(int(v), int(l))
    words, total, ok = pack_symbols(jnp.asarray(vals), jnp.asarray(lens))
    assert bool(ok)
    assert int(total) == w.bit_position
    got = words_to_bytes(np.asarray(words), int(total))
    assert got == _flush(w)


@pytest.mark.parametrize("n,cap,maxlen,sparse", [
    (64, 8, 9, 0.5),        # single real group, tier-8 layout
    (200_000, 8, 9, 0.5),   # 1080p-class symbol count, tier-8
    (200_000, 24, 13, 0.0), # dense mid tier
    (150_000, None, 29, 0.0),  # worst-case tier (never overflows)
])
def test_pack_symbols_tiers_at_scale(n, cap, maxlen, sparse):
    """Every capacity tier must be bit-exact at frame scale: the one-hot
    GEMM placement once silently corrupted payloads at default (bf16)
    matmul precision — caught only beyond the small-n einsum paths."""
    rng = np.random.default_rng(n + (cap or 0))
    lens = rng.integers(0, maxlen, n).astype(np.int32)
    if sparse:
        lens[rng.random(n) < sparse] = 0
    vals = rng.integers(0, 1 << 29, n).astype(np.int32) & ((1 << np.maximum(lens, 1)) - 1)
    csum = np.cumsum(lens, dtype=np.int64)
    total_ref = int(csum[-1])
    nw = total_ref // 32 + 3
    words, total, ok = pack_symbols(jnp.asarray(vals), jnp.asarray(lens),
                                    nw=nw, cap=cap)
    assert int(total) == total_ref
    if not bool(ok):  # tier overflow is a legal outcome — caller escalates
        words, total, ok = pack_symbols(jnp.asarray(vals), jnp.asarray(lens),
                                        nw=nw, cap=None)
        assert bool(ok)
    # reference pack via vectorized numpy (BitWriter is too slow at 200k)
    off = csum - lens
    nbits = total_ref
    bits = np.zeros(nbits, np.uint8)
    for k in range(maxlen):
        m = lens > k
        # bit k from the MSB side of each symbol
        pos = off[m] + k
        bits[pos] = (vals[m] >> (lens[m] - 1 - k)) & 1
    ref = np.packbits(bits).tobytes()
    got = words_to_bytes(np.asarray(words), int(total))
    assert got == ref
