"""Device P-frame pipeline — bulk stages (no loop-carried dependencies).

Device decomposition of the reference's P-frame hot path
(moestimation.cpp:392-585 interEncoding + mocomp.cpp MC): everything that
does NOT depend on the in-frame MV-prediction chain runs as whole-frame
batched work here; the sequential decisions (P_Skip, per-quadrant argmin
with the |mv − mvp| cost, unify, mb_type merge, mvd) run in the MB
wavefront (kernels/wavefront_p.py) consuming only these precomputed maps —
no pixel work in the wavefront except the one skip-test/unify gather.

Bulk stages:
  - 16-phase interpolated planes (ops/interp.py interpolated_planes_jax,
    the FillInterpolatedRefFrame analog, moestimation.cpp:74-173)
  - per-8x8-block integer score map over the ±window full search
    (basicInterEncoding envelope, moestimation.cpp:298-390) via shifted
    whole-plane metric passes — no gathers
  - two 49-position quarter-pel refinement maps per block, centered on
    (1) the pure-distortion integer argmin and (2) the previous frame's
    co-located MV (codec/encoder.py _search_mb's centers)
  - per-MB adaptive MAXDIFF (moestimation.cpp:407-419)

The distortion metric matches the host exactly (encoder._me_metric):
SAD below QP36, SSD at QP36+, 2*SSD at QP45+ (with λ = 1/2/3).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


def device_p_frame_impl(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
                        prev_mv, wmb: int, hmb: int, window: int, qp: int,
                        qpc: int, cfg_maxdiff: int, prefilter: bool,
                        nw: int | None = None, cap: int | None = None):
    """Fully-device P-frame encode: interp planes → bulk ME maps →
    decision wavefront → MC + residual + reconstruction → whole-slice
    entropy. One jitted program per geometry; the host reads back the
    packed payload, the per-MB state, and the recon planes.

    src/ref planes: int32 (uint8 accepted); prev_mv: (nmb, 4, 2) previous
    frame's final quadrant MVs (zeros after IDR). window = ±search range
    in full pel (cfg.window_size // 2). Bit-identical to the host
    per-MB path (tests/test_device_pframe.py).
    """
    from ..kernels.wavefront_p import pframe_decide_impl as pframe_decide
    from ..ops.interp import interpolated_planes_jax, pad_chroma_jax
    from .device_entropy import p_slice_entropy_impl as p_slice_entropy

    src_y = src_y.astype(jnp.int32)
    src_cb = src_cb.astype(jnp.int32)
    src_cr = src_cr.astype(jnp.int32)
    ref_y = ref_y.astype(jnp.int32)
    ext = window + 2
    planes = interpolated_planes_jax(ref_y, ext)
    maps = pframe_maps(src_y, planes, prev_mv, wmb, hmb, window, qp)
    maxdiff = adaptive_maxdiff(src_y, wmb, hmb, cfg_maxdiff)
    dec = pframe_decide(
        src_y, planes, maps["int_map"], maps["c1mv"], maps["q1map"],
        maps["c2mv"], maps["q2map"], maps["q2ok"], maxdiff,
        wmb=wmb, hmb=hmb, window=window, ext=ext,
        metric_id=maps["metric_id"], lam=maps["lam"])

    ext_c = ext // 2 + 1
    cb_pad = pad_chroma_jax(ref_cb.astype(jnp.int32), ext_c)
    cr_pad = pad_chroma_jax(ref_cr.astype(jnp.int32), ext_c)
    pred_y = mc_luma_bulk(planes, dec["mv"], ext, wmb, hmb)
    pred_cb = mc_chroma_bulk(cb_pad, dec["mv"], ext_c, wmb, hmb)
    pred_cr = mc_chroma_bulk(cr_pad, dec["mv"], ext_c, wmb, hmb)
    levels, recon_y, recon_cb, recon_cr = pframe_residual_recon(
        src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr, dec["skip"],
        maxdiff, wmb, hmb, qp, qpc, prefilter)
    ent = p_slice_entropy(
        dec["skip"], dec["mb_type"], dec["mvd"], levels["luma"],
        levels["cdc"], levels["cac"], wmb=wmb, hmb=hmb, nw=nw, cap=cap)
    return {
        "recon_y": recon_y,
        "recon_cb": recon_cb,
        "recon_cr": recon_cr,
        "skip": dec["skip"],
        "raw_type": dec["mb_type"],
        "mv": dec["mv"],
        **ent,
    }


# jitted top-level entry (see codec/device_intra.py on the jax-0.9
# nested-jit const-lifting bug for why embedders use the _impl)
device_p_frame = functools.partial(jax.jit, static_argnames=(
    "wmb", "hmb", "window", "qp", "qpc", "cfg_maxdiff", "prefilter", "nw",
    "cap"))(device_p_frame_impl)


def me_params(qp: int) -> tuple[int, int]:
    """(metric_id, lambda): 0=SAD/λ1, 1=SSD/λ2, 2=2·SSD/λ3 — must match
    encoder._me_metric/_me_lambda."""
    if qp >= 45:
        return 2, 3
    if qp >= 36:
        return 1, 2
    return 0, 1


def _metric(d, metric_id: int):
    if metric_id == 0:
        return jnp.abs(d)
    d = d * d
    return 2 * d if metric_id == 2 else d


def block_sums_8x8(x, hb: int, wb: int):
    """(H, W) -> per-8x8-block sums (hb*wb,) in raster block order."""
    return x.reshape(hb, 8, wb, 8).sum(axis=(1, 3)).reshape(hb * wb)


def integer_score_map(src_y, plane0, ext: int, window: int, metric_id: int):
    """Distortion of every 8x8 block vs every integer shift in ±window.

    plane0: planes[0] from interpolated_planes_jax (edge-extended by ext >=
    window). Returns (nb, S*S) int32, shift index s = (dy+W)*(2W+1)+(dx+W)
    — row-major (dy, dx), matching np.argmin tie-break order in the host.
    """
    H, W = src_y.shape
    hb, wb = H // 8, W // 8
    S = 2 * window + 1

    # one serial step per dy ROW of the search window, all S dx shifts of
    # that row vectorized: S sequential steps at S-way batch width
    # instead of a flat lax.map over S^2 dependent shifts
    def row_shifts(dy):
        strip = jax.lax.dynamic_slice(
            plane0, (ext - window + dy, 0), (H, plane0.shape[1]))

        def one_dx(dx):
            win = jax.lax.dynamic_slice(
                strip, (0, ext - window + dx), (H, W))
            return block_sums_8x8(_metric(win - src_y, metric_id), hb, wb)

        return jax.vmap(one_dx)(jnp.arange(S))  # (S, nb)

    m = jax.lax.map(row_shifts, jnp.arange(S))  # (S, S, nb)
    return m.reshape(S * S, hb * wb).T.astype(jnp.int32)


def qpel_refine_map(src_y, planes, center_mv, ext: int, metric_id: int,
                    radius: int = 3):
    """Distortion at the (2r+1)^2 qpel offsets around a per-block center.

    src_y: (H, W); planes: (16, he, we); center_mv: (nb, 2) qpel MVs whose
    every offset stays inside the planes (callers range-check).
    Returns (nb, (2r+1)^2) int32, offset index k = (dy+r)*(2r+1)+(dx+r).
    """
    H, W = src_y.shape
    hb, wb = H // 8, W // 8
    nb = hb * wb
    src_blk = src_y.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)  # (hb,wb,8,8)
    src_blk = src_blk.reshape(nb, 8, 8)
    bx0 = (jnp.arange(nb) % wb) * 8
    by0 = (jnp.arange(nb) // wb) * 8
    ii = jnp.arange(8)

    cols = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            mvx = center_mv[:, 0] + dx
            mvy = center_mv[:, 1] + dy
            frac = (mvy & 3) * 4 + (mvx & 3)  # (nb,)
            px = bx0 + (mvx >> 2) + ext
            py = by0 + (mvy >> 2) + ext
            # (nb, 8, 8) gather from the 16-plane stack
            win = planes[frac[:, None, None],
                         py[:, None, None] + ii[None, :, None],
                         px[:, None, None] + ii[None, None, :]]
            cols.append(_metric(win - src_blk, metric_id).sum(axis=(1, 2)))
    return jnp.stack(cols, axis=-1).astype(jnp.int32)


def adaptive_maxdiff(src_y, wmb: int, hmb: int, cfg_maxdiff: int):
    """Per-MB MAXDIFF (moestimation.cpp:407-419): mean |src - mean|, floor
    3 — or the configured constant."""
    nmb = wmb * hmb
    mb = src_y.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    mb = mb.reshape(nmb, 256)
    if cfg_maxdiff != -1:
        return jnp.full((nmb,), cfg_maxdiff, jnp.int32)
    mean = mb.sum(axis=1) // 256
    mad = jnp.abs(mb - mean[:, None]).sum(axis=1) // 256
    return jnp.maximum(mad, 3).astype(jnp.int32)


def _blocks_to_mbq(x, wmb: int, hmb: int):
    """(nb, ...) raster 8x8-block order -> (nmb, 4, ...) MB-quadrant order
    (block (2r+qy, 2c+qx) = quadrant q of MB (r, c))."""
    tail = x.shape[1:]
    x = x.reshape(hmb, 2, wmb, 2, *tail)
    x = jnp.moveaxis(x, 2, 1)  # (hmb, wmb, 2, 2, ...)
    return x.reshape(hmb * wmb, 4, *tail)


def pframe_maps(src_y, planes, prev_mv, wmb: int, hmb: int, window: int,
                qp: int):
    """All bulk ME maps for the decision wavefront, MB-quadrant layout.

    src_y: (H, W) int32; planes: interpolated_planes_jax(ref_y, ext) with
    ext = window + 2; prev_mv: (nmb, 4, 2) previous frame's final MVs
    (zeros after IDR). Returns dict consumed by
    kernels/wavefront_p.pframe_decide.
    """
    ext = window + 2
    metric_id, lam = me_params(qp)
    S = 2 * window + 1
    im = integer_score_map(src_y, planes[0], ext, window, metric_id)
    k = jnp.argmin(im, axis=1)  # pure-distortion argmin, (dy, dx) ties
    c1 = jnp.stack([(k % S - window) * 4, (k // S - window) * 4],
                   axis=-1).astype(jnp.int32)
    lim = ext * 4 - 4
    c2_mbq = prev_mv.astype(jnp.int32)
    q2ok = (jnp.abs(c2_mbq) <= lim - 3).all(axis=-1)  # (nmb, 4)
    c2_blk = jnp.clip(  # clamp so masked-out gathers stay in bounds
        _mbq_to_blocks(c2_mbq, wmb, hmb), -(lim - 3), lim - 3)
    q1 = qpel_refine_map(src_y, planes, c1, ext, metric_id)
    q2 = qpel_refine_map(src_y, planes, c2_blk, ext, metric_id)
    return {
        "int_map": _blocks_to_mbq(im, wmb, hmb),
        "c1mv": _blocks_to_mbq(c1, wmb, hmb),
        "q1map": _blocks_to_mbq(q1, wmb, hmb),
        "c2mv": jnp.clip(c2_mbq, -(lim - 3), lim - 3),
        "q2map": _blocks_to_mbq(q2, wmb, hmb),
        "q2ok": q2ok,
        "metric_id": metric_id,
        "lam": lam,
        "ext": ext,
    }


def _mbq_to_blocks(x, wmb: int, hmb: int):
    """(nmb, 4, ...) -> (nb, ...) inverse of _blocks_to_mbq."""
    tail = x.shape[2:]
    x = x.reshape(hmb, wmb, 2, 2, *tail)
    x = jnp.moveaxis(x, 1, 2)  # (hmb, 2, wmb, 2, ...)
    return x.reshape(hmb * 2 * wmb * 2, *tail)


def mb_window_gather(planes, mv, mb_x, mb_y, ext: int):
    """16x16 luma prediction windows at per-MB qpel MVs (one MV per MB).

    planes: (16, he, we); mv: (n, 2); mb_x/mb_y: (n,) MB coords.
    Returns (n, 16, 16) int32. Used by the wavefront's skip test and unify
    scoring (the only pixel work inside the wavefront).
    """
    frac = (mv[:, 1] & 3) * 4 + (mv[:, 0] & 3)
    px = mb_x * 16 + (mv[:, 0] >> 2) + ext
    py = mb_y * 16 + (mv[:, 1] >> 2) + ext
    ii = jnp.arange(16)
    return planes[frac[:, None, None],
                  py[:, None, None] + ii[None, :, None],
                  px[:, None, None] + ii[None, None, :]]


def mc_luma_bulk(planes, mv, ext: int, wmb: int, hmb: int):
    """Whole-frame luma MC at the final per-quadrant MVs.

    mv: (nmb, 4, 2) quadrant-major qpel MVs. Returns (H, W) int32 pred.
    """
    nmb = wmb * hmb
    q = jnp.arange(4)
    mb = jnp.arange(nmb)
    mbx = (mb % wmb)[:, None] * 16 + (q[None, :] & 1) * 8
    mby = (mb // wmb)[:, None] * 16 + (q[None, :] >> 1) * 8
    mvx = mv[:, :, 0]
    mvy = mv[:, :, 1]
    frac = (mvy & 3) * 4 + (mvx & 3)
    px = mbx + (mvx >> 2) + ext
    py = mby + (mvy >> 2) + ext
    ii = jnp.arange(8)
    win = planes[frac[:, :, None, None],
                 py[:, :, None, None] + ii[None, None, :, None],
                 px[:, :, None, None] + ii[None, None, None, :]]
    # (nmb, 4, 8, 8) -> (H, W)
    win = win.reshape(hmb, wmb, 2, 2, 8, 8)
    win = win.transpose(0, 2, 4, 1, 3, 5)
    return win.reshape(hmb * 16, wmb * 16)


def _mb_zblocks(frame, wmb: int, hmb: int):
    """(H, W) -> (nmb, 16, 4, 4) Z-scan 4x4 blocks (Intra4x4ScanOrder)."""
    nmb = wmb * hmb
    g = frame.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    g = g.reshape(nmb, 16, 16)
    b = g.reshape(nmb, 2, 2, 4, 2, 2, 4)
    b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
    return b.reshape(nmb, 16, 4, 4)


def _zblocks_mb(blocks, wmb: int, hmb: int):
    """(nmb, 16, 4, 4) Z-scan -> (H, W); inverse of _mb_zblocks."""
    nmb = wmb * hmb
    b = blocks.reshape(nmb, 2, 2, 2, 2, 4, 4)
    b = jnp.moveaxis(b, (-6, -5, -4, -3), (-6, -3, -5, -2))
    g = b.reshape(hmb, wmb, 16, 16)
    return g.transpose(0, 2, 1, 3).reshape(hmb * 16, wmb * 16)


def _mb_cblocks(frame, wmb: int, hmb: int):
    """(H/2, W/2) -> (nmb, 4, 4, 4) raster 4x4 chroma blocks."""
    nmb = wmb * hmb
    g = frame.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3).reshape(nmb, 8, 8)
    b = g.reshape(nmb, 2, 4, 2, 4)
    return b.transpose(0, 1, 3, 2, 4).reshape(nmb, 4, 4, 4)


def _cblocks_mb(blocks, wmb: int, hmb: int):
    nmb = wmb * hmb
    b = blocks.reshape(nmb, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4)
    g = b.reshape(hmb, wmb, 8, 8)
    return g.transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)


def pframe_residual_recon(src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr,
                          skip, maxdiff, wmb: int, hmb: int, qp: int,
                          qpc: int, prefilter: bool):
    """Bulk residual transform/quant + reconstruction for a decided
    P frame (the per-MB quantizationTransform + transform-decoding pipe,
    quantizationTransform.cpp:349-486 / inttransform.cpp:133-321, plus
    the MAXDIFF source prefilter moestimation.cpp:570-584).

    Returns (levels dict, recon planes). Skipped MBs get zero levels and
    recon = clip(pred) (transformDecodingP_Skip).
    """
    from ..ops import transform

    nmb = wmb * hmb
    skip_px = jnp.repeat(jnp.repeat(
        skip.reshape(hmb, wmb), 16, axis=0), 16, axis=1)
    md_px = jnp.repeat(jnp.repeat(
        maxdiff.reshape(hmb, wmb), 16, axis=0), 16, axis=1)
    if prefilter:
        lm = (jnp.abs(src_y - pred_y) < md_px) & ~skip_px
        src_y = jnp.where(lm, pred_y, src_y)
        md_c = md_px[::2, ::2]
        sk_c = skip_px[::2, ::2]
        cm_b = (jnp.abs(src_cb - pred_cb) <= md_c) & ~sk_c
        src_cb = jnp.where(cm_b, pred_cb, src_cb)
        cm_r = (jnp.abs(src_cr - pred_cr) <= md_c) & ~sk_c
        src_cr = jnp.where(cm_r, pred_cr, src_cr)

    # luma: 16 Z-scan 4x4 blocks per MB, inter quant (no DC bypass)
    diff = _mb_zblocks(src_y - pred_y, wmb, hmb)
    d = transform.forward_transform_4x4(diff)
    q = transform.quantize_residual(d, qp, False)
    luma_levels = transform.zigzag_scan(q)  # (nmb, 16, 16)
    luma_levels = jnp.where(skip[:, None, None], 0, luma_levels)

    # chroma: 4 raster blocks per MB per plane + 2x2 DC Hadamard
    cdc_list = []
    cac_list = []
    for src_c, pred_c in ((src_cb, pred_cb), (src_cr, pred_cr)):
        dc_ = _mb_cblocks(src_c - pred_c, wmb, hmb)
        dcq = transform.quantize_residual(
            transform.forward_transform_4x4(dc_), qpc, True)
        dc2 = dcq[:, :, 0, 0].reshape(nmb, 2, 2)
        qdc = transform.forward_dc_chroma(dc2, qpc)
        cdc_list.append(qdc.reshape(nmb, 4))
        cac_list.append(transform.zigzag_scan(dcq)[:, :, 1:])
    cdc = jnp.stack(cdc_list)  # (2, nmb, 4)
    cac = jnp.stack(cac_list)  # (2, nmb, 4, 15)
    cdc = jnp.where(skip[None, :, None], 0, cdc)
    cac = jnp.where(skip[None, :, None, None], 0, cac)

    # reconstruction
    res_y = transform.inverse_residual(
        transform.zigzag_unscan(luma_levels), qp, False)
    recon_y = jnp.clip(pred_y + _zblocks_mb(res_y, wmb, hmb), 0, 255)
    recon_c = []
    for ci, pred_c in enumerate((pred_cb, pred_cr)):
        dcv = transform.inverse_dc_chroma(cdc[ci].reshape(nmb, 2, 2), qpc)
        full = jnp.concatenate(
            [dcv.reshape(nmb, 4, 1), cac[ci]], axis=-1)
        res = transform.inverse_residual(
            transform.zigzag_unscan(full), qpc, True)
        recon_c.append(jnp.clip(pred_c + _cblocks_mb(res, wmb, hmb), 0, 255))

    levels = {"luma": luma_levels, "cdc": cdc, "cac": cac}
    return levels, recon_y, recon_c[0], recon_c[1]


def mc_chroma_bulk(c_pad, mv, ext_c: int, wmb: int, hmb: int):
    """Whole-frame chroma MC (eighth-pel bilinear, mocomp.cpp:176-195).

    c_pad: pad_chroma_jax(ref_c, ext_c); mv: (nmb, 4, 2). Returns
    (H/2, W/2) int32 pred for one chroma plane.
    """
    nmb = wmb * hmb
    q = jnp.arange(4)
    mb = jnp.arange(nmb)
    cx0 = (mb % wmb)[:, None] * 8 + (q[None, :] & 1) * 4
    cy0 = (mb // wmb)[:, None] * 8 + (q[None, :] >> 1) * 4
    mvx = mv[:, :, 0]
    mvy = mv[:, :, 1]
    cx = cx0 + (mvx >> 3) + ext_c + 1
    cy = cy0 + (mvy >> 3) + ext_c + 1
    fx = (mvx & 7)[:, :, None, None]
    fy = (mvy & 7)[:, :, None, None]
    ii = jnp.arange(4)
    ys = cy[:, :, None, None] + ii[None, None, :, None]
    xs = cx[:, :, None, None] + ii[None, None, None, :]
    a = c_pad[ys, xs]
    b = c_pad[ys, xs + 1]
    c = c_pad[ys + 1, xs]
    d = c_pad[ys + 1, xs + 1]
    out = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
           + (8 - fx) * fy * c + fx * fy * d + 32) >> 6
    out = out.reshape(hmb, wmb, 2, 2, 4, 4)
    out = out.transpose(0, 2, 4, 1, 3, 5)
    return out.reshape(hmb * 8, wmb * 8)
