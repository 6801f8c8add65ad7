"""Device P-frame bulk stages vs the host encoder's NumPy equivalents.

Every map the wavefront consumes must be bit-identical to what the host
_search_mb / _mc_mb compute (ops/interp.py, codec/encoder.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from h264_fer.codec.device_pframe import (
    adaptive_maxdiff,
    integer_score_map,
    mc_chroma_bulk,
    mc_luma_bulk,
    mb_window_gather,
    qpel_refine_map,
)
from h264_fer.ops.interp import (
    interpolated_planes,
    interpolated_planes_jax,
    mc_macroblock_from_planes,
    pad_chroma,
    pad_chroma_jax,
)

W, H = 64, 48
EXT = 10  # window 16 -> W/2 + 2
WIN = 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 256, (H, W)).astype(np.int32)
    src = np.clip(ref + rng.integers(-12, 13, (H, W)), 0, 255).astype(np.int32)
    return ref, src


def test_interp_planes_jax_bit_identical(data):
    ref, _ = data
    want = interpolated_planes(ref, ext=EXT)
    got = np.asarray(interpolated_planes_jax(jnp.asarray(ref), ext=EXT))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("metric_id", [0, 1, 2])
def test_integer_score_map(data, metric_id):
    ref, src = data
    planes = interpolated_planes(ref, ext=EXT)
    got = np.asarray(integer_score_map(
        jnp.asarray(src), jnp.asarray(planes[0]), EXT, WIN, metric_id))
    from numpy.lib.stride_tricks import sliding_window_view

    refp = np.pad(ref, WIN, mode="edge")
    hb, wb = H // 8, W // 8
    S = 2 * WIN + 1
    for bi in [0, 5, hb * wb - 1, wb, wb - 1]:
        by, bx = divmod(bi, wb)
        sb = src[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8]
        cands = sliding_window_view(
            refp[by * 8 : by * 8 + 2 * WIN + 8, bx * 8 : bx * 8 + 2 * WIN + 8],
            (8, 8),
        )
        d = cands.astype(np.int64) - sb
        d = np.abs(d) if metric_id == 0 else (
            d * d if metric_id == 1 else 2 * d * d)
        want = d.sum(axis=(2, 3)).reshape(S * S)
        assert np.array_equal(want, got[bi])


def test_qpel_refine_map_matches_plane_windows(data):
    ref, src = data
    planes = interpolated_planes(ref, ext=EXT)
    rng = np.random.default_rng(5)
    hb, wb = H // 8, W // 8
    nb = hb * wb
    lim = EXT * 4 - 4
    centers = rng.integers(-(lim - 3), lim - 2, (nb, 2)).astype(np.int32)
    got = np.asarray(qpel_refine_map(
        jnp.asarray(src), jnp.asarray(planes), jnp.asarray(centers),
        EXT, 1, radius=3))
    for bi in [0, 7, nb - 1]:
        by, bx = divmod(bi, wb)
        sb = src[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8].astype(np.int64)
        k = 0
        for dy in range(-3, 4):
            for dx in range(-3, 4):
                mvx = int(centers[bi, 0]) + dx
                mvy = int(centers[bi, 1]) + dy
                frac = (mvy & 3) * 4 + (mvx & 3)
                px = bx * 8 + (mvx >> 2) + EXT
                py = by * 8 + (mvy >> 2) + EXT
                pred = planes[frac][py : py + 8, px : px + 8]
                want = ((pred - sb) ** 2).sum()
                assert got[bi, k] == want, (bi, dy, dx)
                k += 1


def test_adaptive_maxdiff(data):
    _, src = data
    wmb, hmb = W // 16, H // 16
    got = np.asarray(adaptive_maxdiff(jnp.asarray(src), wmb, hmb, -1))
    for curr in range(wmb * hmb):
        x0, y0 = (curr % wmb) * 16, (curr // wmb) * 16
        mb = src[y0 : y0 + 16, x0 : x0 + 16]
        mean = int(mb.sum()) // 256
        want = max(3, int(np.abs(mb - mean).sum()) // 256)
        assert got[curr] == want
    got0 = np.asarray(adaptive_maxdiff(jnp.asarray(src), wmb, hmb, 5))
    assert (got0 == 5).all()


def test_mc_bulk_matches_host_planes_mc(data):
    ref, _ = data
    rng = np.random.default_rng(11)
    wmb, hmb = W // 16, H // 16
    nmb = wmb * hmb
    lim = EXT * 4 - 4
    mv = rng.integers(-lim, lim + 1, (nmb, 4, 2)).astype(np.int32)
    planes = interpolated_planes(ref, ext=EXT)
    ext_c = EXT // 2 + 1
    ref_cb = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    ref_cr = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    cb_pad, cr_pad = pad_chroma(ref_cb, ext_c), pad_chroma(ref_cr, ext_c)

    got_l = np.asarray(mc_luma_bulk(
        jnp.asarray(planes), jnp.asarray(mv), EXT, wmb, hmb))
    got_cb = np.asarray(mc_chroma_bulk(
        pad_chroma_jax(jnp.asarray(ref_cb), ext_c), jnp.asarray(mv),
        ext_c, wmb, hmb))
    got_cr = np.asarray(mc_chroma_bulk(
        pad_chroma_jax(jnp.asarray(ref_cr), ext_c), jnp.asarray(mv),
        ext_c, wmb, hmb))

    for curr in range(nmb):
        mv4 = np.repeat(mv[curr][:, None, :], 4, axis=1)  # (4, 4, 2) fanned
        pl, pcb, pcr = mc_macroblock_from_planes(
            planes, cb_pad, cr_pad, curr % wmb, curr // wmb, mv4, EXT, ext_c)
        x0, y0 = (curr % wmb) * 16, (curr // wmb) * 16
        assert np.array_equal(got_l[y0 : y0 + 16, x0 : x0 + 16], pl)
        assert np.array_equal(
            got_cb[y0 // 2 : y0 // 2 + 8, x0 // 2 : x0 // 2 + 8], pcb)
        assert np.array_equal(
            got_cr[y0 // 2 : y0 // 2 + 8, x0 // 2 : x0 // 2 + 8], pcr)


def test_mb_window_gather(data):
    ref, _ = data
    planes = interpolated_planes(ref, ext=EXT)
    rng = np.random.default_rng(13)
    wmb, hmb = W // 16, H // 16
    lim = EXT * 4 - 4
    n = 6
    mv = rng.integers(-lim, lim + 1, (n, 2)).astype(np.int32)
    mbx = rng.integers(0, wmb, n).astype(np.int32)
    mby = rng.integers(0, hmb, n).astype(np.int32)
    got = np.asarray(mb_window_gather(
        jnp.asarray(planes), jnp.asarray(mv), jnp.asarray(mbx),
        jnp.asarray(mby), EXT))
    for i in range(n):
        frac = (int(mv[i, 1]) & 3) * 4 + (int(mv[i, 0]) & 3)
        px = int(mbx[i]) * 16 + (int(mv[i, 0]) >> 2) + EXT
        py = int(mby[i]) * 16 + (int(mv[i, 1]) >> 2) + EXT
        assert np.array_equal(got[i], planes[frac][py : py + 16, px : px + 16])
