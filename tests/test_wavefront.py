"""Device wavefront I16 reconstruction vs a sequential host reference."""

import numpy as np
import pytest

import jax.numpy as jnp

from h264_fer.codec.device_intra import intra_mode_decision
from h264_fer.kernels.wavefront import (
    wavefront_i16_frame,
    wavefront_i16_luma,
)
from h264_fer.ops import intra, transform
from h264_fer.ops.intra import INTRA16_TO_CHROMA_MODE
from h264_fer.ops.tables import INTRA4X4_SCAN_ORDER_XY


def host_i16_recon(y, modes, wmb, hmb, qp):
    """Sequential raster reconstruction (the encoder's exact semantics)."""
    recon = np.zeros_like(y)
    dc_all = np.zeros((wmb * hmb, 16), np.int32)
    ac_all = np.zeros((wmb * hmb, 16, 15), np.int32)
    for mb in range(wmb * hmb):
        r, c = mb // wmb, mb % wmb
        x0, y0 = c * 16, r * 16
        p = np.full(33, -1, np.int32)
        if x0 > 0 and y0 > 0:
            p[0] = recon[y0 - 1, x0 - 1]
        if x0 > 0:
            p[1:17] = recon[y0 : y0 + 16, x0 - 1]
        if y0 > 0:
            p[17:33] = recon[y0 - 1, x0 : x0 + 16]
        pred = intra.predict_16x16(p, int(modes[mb]))
        src = y[y0 : y0 + 16, x0 : x0 + 16]
        blocks = np.stack([
            (src - pred)[by : by + 4, bx : bx + 4]
            for bx, by in INTRA4X4_SCAN_ORDER_XY
        ])
        q = transform.quantize_residual(
            transform.forward_transform_4x4(blocks.astype(np.int32)), qp, True
        )
        dc = np.zeros((4, 4), np.int32)
        for b, (bx, by) in enumerate(INTRA4X4_SCAN_ORDER_XY):
            dc[by // 4, bx // 4] = q[b, 0, 0]
        qdc = transform.forward_dc_luma(dc, qp)
        dc_all[mb] = transform.zigzag_scan(qdc)
        ac_all[mb] = transform.zigzag_scan(q)[:, 1:]
        dcv = transform.inverse_dc_luma(qdc, qp)
        out = np.zeros((16, 16), np.int32)
        for b, (bx, by) in enumerate(INTRA4X4_SCAN_ORDER_XY):
            lst = np.zeros(16, np.int32)
            lst[0] = dcv[by // 4, bx // 4]
            lst[1:] = ac_all[mb, b]
            res = transform.inverse_residual(
                transform.zigzag_unscan(lst), qp, True
            )
            out[by : by + 4, bx : bx + 4] = res
        recon[y0 : y0 + 16, x0 : x0 + 16] = np.clip(pred + out, 0, 255)
    return recon, dc_all, ac_all


@pytest.mark.parametrize("qp", [20, 32])
def test_wavefront_matches_sequential(qp):
    rng = np.random.default_rng(qp)
    hmb, wmb = 5, 7
    y = rng.integers(0, 256, (hmb * 16, wmb * 16)).astype(np.int32)
    modes = rng.integers(0, 3, hmb * wmb).astype(np.int32)  # V/H/DC mix
    # availability: first row can't use V? mode 0 needs top — make row 0 DC,
    # col 0 not H
    modes[: wmb] = 2
    modes[:: wmb] = np.where(modes[::wmb] == 1, 2, modes[::wmb])
    gold = host_i16_recon(y, modes, wmb, hmb, qp)
    got = wavefront_i16_luma(jnp.asarray(y), jnp.asarray(modes),
                             wmb=wmb, hmb=hmb, qp=qp)
    np.testing.assert_array_equal(np.asarray(got[0]), gold[0])
    np.testing.assert_array_equal(np.asarray(got[1]), gold[1])
    np.testing.assert_array_equal(np.asarray(got[2]), gold[2])


def host_i4_recon(y, modes, wmb, hmb, qp):
    """Sequential reference for the Intra_4x4 wavefront."""
    recon = np.zeros_like(y)
    lv = np.zeros((wmb * hmb, 16, 16), np.int32)
    W = y.shape[1]
    for mb in range(wmb * hmb):
        r, c = mb // wmb, mb % wmb
        x0, y0 = c * 16, r * 16
        for blk in range(16):
            bx, by = INTRA4X4_SCAN_ORDER_XY[blk]
            x, yy = x0 + bx, y0 + by
            p = np.full(13, -1, np.int32)
            if x > 0 and yy > 0:
                p[0] = recon[yy - 1, x - 1]
            if x > 0:
                p[1:5] = recon[yy : yy + 4, x - 1]
            if yy > 0:
                p[5:9] = recon[yy - 1, x : x + 4]
                xf = x + 4
                edge = (xf >= W) or (bx == 12 and by > 0)
                if edge or blk in (3, 11):
                    p[9:13] = recon[yy - 1, x + 3]
                else:
                    p[9:13] = recon[yy - 1, xf : xf + 4]
            pred = intra.predict_4x4(p, int(modes[mb, blk]))
            src = y[yy : yy + 4, x : x + 4]
            q = transform.quantize_residual(
                transform.forward_transform_4x4((src - pred).astype(np.int32)),
                qp, False,
            )
            lv[mb, blk] = transform.zigzag_scan(q)
            res = transform.inverse_residual(q, qp, False)
            recon[yy : yy + 4, x : x + 4] = np.clip(pred + res, 0, 255)
    return recon, lv


@pytest.mark.parametrize("hmb,wmb,qp", [(4, 6, 28), (3, 3, 20), (6, 2, 35), (9, 2, 28)])
def test_i4x4_wavefront_matches_sequential(hmb, wmb, qp):
    from h264_fer.kernels.wavefront import wavefront_i4x4_luma

    rng = np.random.default_rng(qp)
    y = rng.integers(0, 256, (hmb * 16, wmb * 16)).astype(np.int32)
    modes = rng.integers(0, 9, (hmb * wmb, 16)).astype(np.int32)
    for mb in range(hmb * wmb):
        r, c = mb // wmb, mb % wmb
        for blk in range(16):
            bx, by = INTRA4X4_SCAN_ORDER_XY[blk]
            no_top = r == 0 and by == 0
            no_left = c == 0 and bx == 0
            m = modes[mb, blk]
            if no_top and no_left and m != 2:
                modes[mb, blk] = 2
            elif no_top and m in (0, 3, 4, 5, 6, 7):
                modes[mb, blk] = 2
            elif no_left and m in (1, 4, 5, 6, 8):
                modes[mb, blk] = 2
    gold = host_i4_recon(y, modes, wmb, hmb, qp)
    got = wavefront_i4x4_luma(jnp.asarray(y), jnp.asarray(modes),
                              wmb=wmb, hmb=hmb, qp=qp)
    np.testing.assert_array_equal(np.asarray(got[0]), gold[0])
    np.testing.assert_array_equal(np.asarray(got[1]), gold[1])


def host_chroma_recon(cbs, crs, modes, wmb, hmb, qp):
    rb = np.zeros_like(cbs)
    rr = np.zeros_like(crs)
    dc = np.zeros((2, wmb * hmb, 4), np.int32)
    ac = np.zeros((2, wmb * hmb, 4, 15), np.int32)
    for mb in range(wmb * hmb):
        r, c = mb // wmb, mb % wmb
        x0, y0 = c * 8, r * 8
        for ci, (src, plane) in enumerate([(cbs, rb), (crs, rr)]):
            p = np.full(17, -1, np.int32)
            if x0 > 0 and y0 > 0:
                p[0] = plane[y0 - 1, x0 - 1]
            if x0 > 0:
                p[1:9] = plane[y0 : y0 + 8, x0 - 1]
            if y0 > 0:
                p[9:17] = plane[y0 - 1, x0 : x0 + 8]
            pred = intra.predict_chroma(p, int(modes[mb]))
            diff = (src[y0 : y0 + 8, x0 : x0 + 8] - pred).astype(np.int32)
            blocks = np.stack([
                diff[(b // 2) * 4 : (b // 2) * 4 + 4, (b % 2) * 4 : (b % 2) * 4 + 4]
                for b in range(4)
            ])
            q = transform.quantize_residual(
                transform.forward_transform_4x4(blocks), qp, True)
            dc2 = np.array([[q[0, 0, 0], q[1, 0, 0]], [q[2, 0, 0], q[3, 0, 0]]],
                           np.int32)
            qdc = transform.forward_dc_chroma(dc2, qp)
            dc[ci, mb] = qdc.reshape(4)
            ac[ci, mb] = transform.zigzag_scan(q)[:, 1:]
            dcv = transform.inverse_dc_chroma(qdc, qp)
            rmb = np.zeros((8, 8), np.int32)
            for b in range(4):
                lst = np.zeros(16, np.int32)
                lst[0] = dcv[b // 2, b % 2]
                lst[1:] = ac[ci, mb, b]
                res = transform.inverse_residual(
                    transform.zigzag_unscan(lst), qp, True)
                rmb[(b // 2) * 4 : (b // 2) * 4 + 4,
                    (b % 2) * 4 : (b % 2) * 4 + 4] = res
            plane[y0 : y0 + 8, x0 : x0 + 8] = np.clip(pred + rmb, 0, 255)
    return rb, rr, dc, ac


@pytest.mark.parametrize("hmb,wmb,qp", [(4, 5, 26), (3, 3, 32), (2, 6, 20), (9, 2, 30)])
def test_chroma_wavefront_matches_sequential(hmb, wmb, qp):
    from h264_fer.kernels.wavefront import wavefront_chroma

    rng = np.random.default_rng(qp)
    cbs = rng.integers(0, 256, (hmb * 8, wmb * 8)).astype(np.int32)
    crs = rng.integers(0, 256, (hmb * 8, wmb * 8)).astype(np.int32)
    modes = rng.integers(0, 4, hmb * wmb).astype(np.int32)
    for mb in range(hmb * wmb):
        r, c = mb // wmb, mb % wmb
        m = modes[mb]
        if r == 0 and m == 2:
            modes[mb] = 0
        if c == 0 and m == 1:
            modes[mb] = 0
        if (r == 0 or c == 0) and m == 3:
            modes[mb] = 0
    gold = host_chroma_recon(cbs, crs, modes, wmb, hmb, qp)
    got = wavefront_chroma(jnp.asarray(cbs), jnp.asarray(crs),
                           jnp.asarray(modes), wmb=wmb, hmb=hmb, qp=qp)
    for g, h in zip(got, gold):
        np.testing.assert_array_equal(np.asarray(g), h)


@pytest.mark.parametrize("hmb,wmb,qp", [(5, 7, 28), (9, 2, 24)])
def test_i16_wavefront_tall_and_skewed(hmb, wmb, qp):
    from h264_fer.kernels.wavefront import (
        wavefront_i16_luma,
        wavefront_i16_luma_skewed,
    )

    rng = np.random.default_rng(hmb * 31 + wmb)
    y = rng.integers(0, 256, (hmb * 16, wmb * 16)).astype(np.int32)
    modes = rng.integers(0, 3, hmb * wmb).astype(np.int32)
    modes[:wmb] = 2
    modes[::wmb] = np.where(modes[::wmb] == 1, 2, modes[::wmb])
    gold = host_i16_recon(y, modes, wmb, hmb, qp)
    for fn in (wavefront_i16_luma, wavefront_i16_luma_skewed):
        got = fn(jnp.asarray(y), jnp.asarray(modes), wmb=wmb, hmb=hmb, qp=qp)
        for g, h in zip(got, gold):
            np.testing.assert_array_equal(np.asarray(g), h)


@pytest.mark.parametrize("wh", [(176, 144), (80, 176)])  # wide and tall grids
@pytest.mark.parametrize("qp", [10, 26, 40])
def test_i16_frame_wavefront_matches_sequential(wh, qp):
    """The fused 3-plane I16 frame wavefront (the device I-frame's
    reconstruction stage) against the sequential host luma and chroma
    references, with modes from the device mode decision."""
    W, H = wh
    wmb, hmb = W // 16, H // 16
    qpc = transform.chroma_qp(qp)
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    cb = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    cr = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    m16 = intra_mode_decision(jnp.asarray(y), wmb=wmb, hmb=hmb,
                              qp=qp)["mode16"]
    cmodes = jnp.asarray(INTRA16_TO_CHROMA_MODE)[m16]

    got = wavefront_i16_frame(jnp.asarray(y), jnp.asarray(cb),
                              jnp.asarray(cr), m16, cmodes,
                              wmb=wmb, hmb=hmb, qp=qp, qpc=qpc)
    luma = host_i16_recon(y, np.asarray(m16), wmb, hmb, qp)
    rb, rr, cdc, cac = host_chroma_recon(cb, cr, np.asarray(cmodes),
                                         wmb, hmb, qpc)
    want = (*luma, rb, rr, cdc, cac)
    names = ("frame", "i16dc", "ac", "cb", "cr", "cdc", "cac")
    for name, g, h in zip(names, got, want):
        np.testing.assert_array_equal(
            np.asarray(g), h, err_msg=f"{name} @ {W}x{H} qp{qp}")


def test_frame_stacked_wavefront_matches_per_frame():
    """GOP-batch stacking: B frames stacked vertically with frame_hmb
    produce the same modes/recon/levels as B independent runs."""
    from h264_fer.kernels.wavefront import wavefront_i16_scan

    W, H, B, qp, qpc = 176, 144, 3, 26, 24
    wmb, hmb = W // 16, H // 16
    nmb = wmb * hmb
    rng = np.random.default_rng(2)
    ys = rng.integers(0, 256, (B, H, W)).astype(np.int32)
    cbs = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    crs = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    cmap = jnp.asarray(INTRA16_TO_CHROMA_MODE)

    ystk = jnp.asarray(ys.reshape(B * H, W))
    cbstk = jnp.asarray(cbs.reshape(B * H // 2, W // 2))
    crstk = jnp.asarray(crs.reshape(B * H // 2, W // 2))
    m16s = intra_mode_decision(
        ystk, wmb=wmb, hmb=B * hmb, qp=qp, frame_hmb=hmb, modes_only=True
    )["mode16"]
    got = wavefront_i16_scan(
        ystk, cbstk, crstk, m16s, cmap[m16s],
        wmb=wmb, hmb=B * hmb, qp=qp, qpc=qpc, frame_hmb=hmb,
    )

    for k in range(B):
        yk = jnp.asarray(ys[k])
        m16k = intra_mode_decision(yk, wmb=wmb, hmb=hmb, qp=qp)["mode16"]
        np.testing.assert_array_equal(
            np.asarray(m16k), np.asarray(m16s[k * nmb : (k + 1) * nmb]),
            err_msg=f"modes frame {k}",
        )
        ref = wavefront_i16_frame(
            yk, jnp.asarray(cbs[k]), jnp.asarray(crs[k]), m16k, cmap[m16k],
            wmb=wmb, hmb=hmb, qp=qp, qpc=qpc,
        )
        slices = (
            got[0][k * H : (k + 1) * H],
            got[1][k * nmb : (k + 1) * nmb],
            got[2][k * nmb : (k + 1) * nmb],
            got[3][k * H // 2 : (k + 1) * H // 2],
            got[4][k * H // 2 : (k + 1) * H // 2],
            got[5][:, k * nmb : (k + 1) * nmb],
            got[6][:, k * nmb : (k + 1) * nmb],
        )
        for name, r, g in zip(("frame", "dc", "ac", "cb", "cr", "cdc", "cac"),
                              ref, slices):
            np.testing.assert_array_equal(
                np.asarray(r), np.asarray(g), err_msg=f"{name} frame {k}"
            )
