"""P-frame decision wavefront vs the host encoder's per-MB loop.

pframe_decide (kernels/wavefront_p.py), driven by the bulk maps
(codec/device_pframe.py), must reproduce the host _inter_encode_mb decisions
exactly: skip flags, mb_type, final quadrant MVs, and mvds."""

import numpy as np
import pytest

import jax.numpy as jnp

from h264_fer.codec.encoder import MB_SKIP, Encoder, EncoderConfig
from h264_fer.codec.device_pframe import pframe_maps
from h264_fer.kernels.wavefront_p import pframe_decide
from h264_fer.ops.interp import interpolated_planes_jax
from h264_fer.vio.y4m import Y4MReader


def _check_decisions(frames, w, h, qp, window_size=16):
    """Encode frames (I then P) on the host and check every P frame's
    device decisions against the host per-MB loop."""
    wmb, hmb = w // 16, h // 16
    nmb = wmb * hmb

    enc = Encoder(w, h, EncoderConfig(qp=qp, intra_every=100,
                                      window_size=window_size,
                                      lossy_prefilter=False,
                                      scene_cut_idr=False))
    rec = {}
    orig = Encoder._inter_encode_mb

    def wrap(self, curr):
        res = orig(self, curr)
        rec[curr] = None if res is None else (res[0], res[2].copy())
        return res

    Encoder._inter_encode_mb = wrap
    try:
        enc.encode_frame(*frames[0])  # I
        for fi in range(1, len(frames)):
            ref_y = enc.ref_y.copy()
            prev_mv = enc.prev_mv[:, :, 0, :].copy()  # (nmb, 4, 2)
            rec.clear()
            enc.encode_frame(*frames[fi])
            host_mv = enc.mv[:, :, 0, :].copy()
            host_type = enc.mb_type.copy()

            window = enc.cfg.window_size // 2
            planes = interpolated_planes_jax(
                jnp.asarray(ref_y), ext=window + 2)
            src = jnp.asarray(frames[fi][0].astype(np.int32))
            maps = pframe_maps(src, planes, jnp.asarray(prev_mv),
                               wmb, hmb, window, qp)
            out = pframe_decide(
                src, planes, maps["int_map"], maps["c1mv"], maps["q1map"],
                maps["c2mv"], maps["q2map"], maps["q2ok"],
                jnp.asarray(np.asarray(
                    _host_maxdiff(frames[fi][0], wmb, hmb))),
                wmb=wmb, hmb=hmb, window=window, ext=maps["ext"],
                metric_id=maps["metric_id"], lam=maps["lam"])

            skip = np.asarray(out["skip"])
            mbt = np.asarray(out["mb_type"])
            mv = np.asarray(out["mv"])
            mvd = np.asarray(out["mvd"])
            for curr in range(nmb):
                host_skip = rec[curr] is None
                assert skip[curr] == host_skip, (fi, curr)
                assert np.array_equal(mv[curr], host_mv[curr]), (
                    fi, curr, mv[curr], host_mv[curr])
                if host_skip:
                    assert host_type[curr] == MB_SKIP
                    continue
                ht, hmvd = rec[curr]
                assert mbt[curr] == ht, (fi, curr, mbt[curr], ht)
                nparts = [1, 2, 2, 4, 4][ht]
                assert np.array_equal(mvd[curr, :nparts], hmvd[:nparts]), (
                    fi, curr, mvd[curr], hmvd)
    finally:
        Encoder._inter_encode_mb = orig


@pytest.mark.parametrize("qp", [28, 40, 46])
def test_pframe_decisions_match_host(fixtures_dir, qp):
    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:3]
    _check_decisions(frames, 176, 144, qp)


@pytest.mark.parametrize(
    "H,W,window,qp,seed",
    [
        (64, 96, 8, 28, 0),   # SAD tier
        (96, 64, 8, 40, 0),   # SSD tier; tall geometry
        (48, 80, 4, 46, 0),   # 2*SSD tier; small window
        (64, 96, 8, 28, 1),   # SAD tier, other content
    ],
)
def test_pframe_decide_matches_host_shapes(H, W, window, qp, seed):
    """pframe_decide on small wide, tall and narrow-window geometries:
    shifted, noisy content over three frames, so the second P frame has
    non-zero temporal refinement centers. The last MB is pure noise so
    it is always coded: a trailing skip run would be dropped by the
    host's decoder emulation, which pframe_decide leaves to its
    callers."""
    rng = np.random.default_rng(7 * H + W + qp + 101 * seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = ((xx * 3 + yy * 5) % 180 + rng.integers(0, 60, (H, W)))
    frames = []
    for i in range(3):
        y = np.roll(base, (2 * i, 3 * i), (0, 1))
        y = np.clip(y + rng.integers(-6, 7, (H, W)), 0, 255)
        y[-16:, -16:] = rng.integers(0, 256, (16, 16))
        cb = rng.integers(100, 140, (H // 2, W // 2))
        cr = rng.integers(100, 140, (H // 2, W // 2))
        frames.append(tuple(p.astype(np.uint8) for p in (y, cb, cr)))
    _check_decisions(frames, W, H, qp, window_size=2 * window)


@pytest.mark.parametrize("qp", [28, 40])
def test_pframe_residual_recon_matches_host(fixtures_dir, qp):
    from h264_fer.codec.device_pframe import (
        adaptive_maxdiff,
        mc_chroma_bulk,
        mc_luma_bulk,
        pframe_residual_recon,
    )
    from h264_fer.ops.interp import pad_chroma_jax

    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:2]
    w, h = 176, 144
    wmb, hmb = w // 16, h // 16
    nmb = wmb * hmb

    enc = Encoder(w, h, EncoderConfig(qp=qp, intra_every=100))
    rec = {}
    orig = Encoder._inter_encode_mb

    def wrap(self, curr):
        res = orig(self, curr)
        rec[curr] = res
        return res

    Encoder._inter_encode_mb = wrap
    try:
        enc.encode_frame(*frames[0])
        ref_y = enc.ref_y.copy()
        ref_cb = enc.ref_cb.copy()
        ref_cr = enc.ref_cr.copy()
        prev_mv = enc.prev_mv[:, :, 0, :].copy()
        enc.encode_frame(*frames[1])
        host_mv = enc.mv[:, :, 0, :].copy()
    finally:
        Encoder._inter_encode_mb = orig

    window = enc.cfg.window_size // 2
    ext = window + 2
    planes = interpolated_planes_jax(jnp.asarray(ref_y), ext=ext)
    src_y = jnp.asarray(frames[1][0].astype(np.int32))
    mv = jnp.asarray(host_mv)
    skip = jnp.asarray(np.array([rec[c] is None for c in range(nmb)]))
    maxdiff = adaptive_maxdiff(src_y, wmb, hmb, -1)
    pred_y = mc_luma_bulk(planes, mv, ext, wmb, hmb)
    ext_c = ext // 2 + 1
    pred_cb = mc_chroma_bulk(
        pad_chroma_jax(jnp.asarray(ref_cb), ext_c), mv, ext_c, wmb, hmb)
    pred_cr = mc_chroma_bulk(
        pad_chroma_jax(jnp.asarray(ref_cr), ext_c), mv, ext_c, wmb, hmb)
    levels, ry, rcb, rcr = pframe_residual_recon(
        src_y, jnp.asarray(frames[1][1].astype(np.int32)),
        jnp.asarray(frames[1][2].astype(np.int32)),
        pred_y, pred_cb, pred_cr, skip, maxdiff, wmb, hmb,
        enc.qpy, enc.qpc, prefilter=qp < 36)

    assert np.array_equal(np.asarray(ry), enc.y)
    assert np.array_equal(np.asarray(rcb), enc.cb)
    assert np.array_equal(np.asarray(rcr), enc.cr)
    lv = np.asarray(levels["luma"])
    cdc = np.asarray(levels["cdc"])
    cac = np.asarray(levels["cac"])
    for curr in range(nmb):
        if rec[curr] is None:
            assert not lv[curr].any()
            continue
        (_, _, _, _, _, _, h_lv, h_cdc, h_cac, h_cbpl, h_cbpc) = rec[curr]
        assert np.array_equal(lv[curr], h_lv), curr
        assert np.array_equal(cdc[:, curr], h_cdc), curr
        assert np.array_equal(cac[:, curr], h_cac), curr


def _host_maxdiff(src_y, wmb, hmb):
    out = np.zeros(wmb * hmb, np.int32)
    s = src_y.astype(np.int32)
    for curr in range(wmb * hmb):
        x0, y0 = (curr % wmb) * 16, (curr // wmb) * 16
        mb = s[y0 : y0 + 16, x0 : x0 + 16]
        mean = int(mb.sum()) // 256
        out[curr] = max(3, int(np.abs(mb - mean).sum()) // 256)
    return out
