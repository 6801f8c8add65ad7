"""Device in-loop deblocking filter (norm 8.7) — exact per-MB-order
equivalent on device (SURVEY.md §7 stage 7; superset feature, the reference
has no filter at all).

The norm filters MBs in raster order: each MB's 4 vertical edges
left→right, then its 4 horizontal edges top→bottom. An MB's filtering
reads AND writes 4 pixels into its left and top neighbours, so plain
per-row or per-diagonal (d = r + c) parallelism is wrong: MB (r, c)
writes its top neighbour's bottom rows while (r−1, c+1) — same r+c
diagonal — writes that neighbour's right columns, and the two windows
share the 4×4 corner. The knight-move wavefront d = 2·r + c (the same
schedule as the Intra_4x4 reconstruction wavefront) orders every
conflicting pair correctly, and same-wave MBs touch pairwise-disjoint
20×20 windows, so each wave batch-filters its MBs with one gather →
8 in-window edge steps → one scatter.

Boundary strengths (8.7.2.1, this codec's envelope — single slice, one
reference, progressive) depend only on pre-filter syntax state
(intra flags, per-4x4 coded flags, quadrant MVs), so all bS values are
computed in bulk before the wavefront.

Bit-identical to the host oracle `codec/loopfilter.deblock_frame`
(tests/test_deblock_device.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.deblock import ALPHA, BETA, TC0
from ..ops.tables import RASTER_TO_LUMA_BLOCK

# np table, NOT a module-level jnp Array (see kernels/wavefront_p.py
# on the jax-0.9 cross-trace const-interning leak)
_TC0 = np.asarray(TC0)
# mv quadrant of each raster 4x4 block (loopfilter._blk_mv)
_RASTER_Q = np.array([(b // 8) * 2 + (b % 4) // 2 for b in range(16)])


def _bs_maps(mb_intra, nz_raster, mvq, wmb: int, hmb: int):
    """Bulk bS for every edge. Returns (bs_v (nmb, 4, 4), bs_h (nmb, 4, 4))
    — bs_v[mb, xblk, yblk] for the vertical edge at luma x = 16·mbx+4·xblk,
    bs_h[mb, yblk, xblk] for the horizontal edge at y = 16·mby+4·yblk.
    Frame-boundary edges get bS = 0 (not filtered)."""
    nmb = wmb * hmb
    mb = jnp.arange(nmb)
    mbx = mb % wmb
    mby = mb // wmb
    left_mb = jnp.maximum(mb - 1, 0)
    top_mb = jnp.maximum(mb - wmb, 0)

    def pair(intra_p, intra_q, nz_p, nz_q, mv_p, mv_q, mb_edge: bool):
        bs_intra = 4 if mb_edge else 3
        mv_far = (
            (jnp.abs(mv_p[..., 0] - mv_q[..., 0]) >= 4)
            | (jnp.abs(mv_p[..., 1] - mv_q[..., 1]) >= 4)
        )
        return jnp.where(
            intra_p | intra_q, bs_intra,
            jnp.where(nz_p | nz_q, 2, jnp.where(mv_far, 1, 0)))

    bs_v = []
    for xblk in range(4):
        col = []
        for yblk in range(4):
            q_blk = yblk * 4 + xblk
            if xblk == 0:
                p_mb, p_blk, mb_edge = left_mb, yblk * 4 + 3, True
            else:
                p_mb, p_blk, mb_edge = mb, q_blk - 1, False
            bs = pair(mb_intra[p_mb], mb_intra[mb],
                      nz_raster[p_mb, p_blk], nz_raster[mb, q_blk],
                      mvq[p_mb, p_blk], mvq[mb, q_blk], mb_edge)
            if xblk == 0:
                bs = jnp.where(mbx == 0, 0, bs)
            col.append(bs)
        bs_v.append(jnp.stack(col, axis=-1))
    bs_v = jnp.stack(bs_v, axis=-2)  # (nmb, 4 xblk, 4 yblk)

    bs_h = []
    for yblk in range(4):
        row = []
        for xblk in range(4):
            q_blk = yblk * 4 + xblk
            if yblk == 0:
                p_mb, p_blk, mb_edge = top_mb, 12 + xblk, True
            else:
                p_mb, p_blk, mb_edge = mb, q_blk - 4, False
            bs = pair(mb_intra[p_mb], mb_intra[mb],
                      nz_raster[p_mb, p_blk], nz_raster[mb, q_blk],
                      mvq[p_mb, p_blk], mvq[mb, q_blk], mb_edge)
            if yblk == 0:
                bs = jnp.where(mby == 0, 0, bs)
            row.append(bs)
        bs_h.append(jnp.stack(row, axis=-1))
    bs_h = jnp.stack(bs_h, axis=-2)  # (nmb, 4 yblk, 4 xblk)
    return bs_v, bs_h


def _clip3(lo, hi, v):
    return jnp.minimum(hi, jnp.maximum(lo, v))


def _filter_lines(p, q, bs, alpha: int, beta: int, idx_a: int,
                  chroma: bool):
    """One edge for a batch of lines. p/q: (..., 4) int32 with index 0
    nearest the edge; bs: (...,) int32 0..4. Exact ops/deblock math."""
    p0, p1, p2, p3 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    filt = (
        (jnp.abs(p0 - q0) < alpha)
        & (jnp.abs(p1 - p0) < beta)
        & (jnp.abs(q1 - q0) < beta)
    )
    ap = jnp.abs(p2 - p0)
    aq = jnp.abs(q2 - q0)

    # --- bS 1..3 (normal) ---
    tc0 = jnp.asarray(_TC0)[jnp.clip(bs, 1, 3) - 1, idx_a]
    if chroma:
        tc = tc0 + 1
    else:
        tc = tc0 + (ap < beta) + (aq < beta)
    nfilt = filt & (bs > 0)
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
    n_p0 = jnp.where(nfilt, jnp.clip(p0 + delta, 0, 255), p0)
    n_q0 = jnp.where(nfilt, jnp.clip(q0 - delta, 0, 255), q0)
    if chroma:
        n_p1, n_q1 = p1, q1
    else:
        dp1 = _clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1)
        dq1 = _clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1)
        n_p1 = jnp.where(nfilt & (ap < beta), p1 + dp1, p1)
        n_q1 = jnp.where(nfilt & (aq < beta), q1 + dq1, q1)
    n_p2, n_q2 = p2, q2

    # --- bS 4 (strong) ---
    if chroma:
        s_p0 = jnp.where(filt, ((p1 << 1) + p0 + q1 + 2) >> 2, p0)
        s_q0 = jnp.where(filt, ((q1 << 1) + q0 + p1 + 2) >> 2, q0)
        s_p1, s_q1, s_p2, s_q2 = p1, q1, p2, q2
    else:
        strong = jnp.abs(p0 - q0) < ((alpha >> 2) + 2)
        sp = filt & strong & (ap < beta)
        sq = filt & strong & (aq < beta)
        s_p0 = jnp.where(
            sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
            jnp.where(filt, ((p1 << 1) + p0 + q1 + 2) >> 2, p0))
        s_p1 = jnp.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
        s_p2 = jnp.where(
            sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
        s_q0 = jnp.where(
            sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
            jnp.where(filt, ((q1 << 1) + q0 + p1 + 2) >> 2, q0))
        s_q1 = jnp.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
        s_q2 = jnp.where(
            sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    use_s = bs == 4
    out_p = jnp.stack([
        jnp.where(use_s, s_p0, n_p0),
        jnp.where(use_s, s_p1, n_p1),
        jnp.where(use_s, s_p2, n_p2),
        p3,
    ], axis=-1)
    out_q = jnp.stack([
        jnp.where(use_s, s_q0, n_q0),
        jnp.where(use_s, s_q1, n_q1),
        jnp.where(use_s, s_q2, n_q2),
        q3,
    ], axis=-1)
    return out_p, out_q


def _edge_v(patch, x: int, bs4, alpha, beta, idx_a, chroma, lines: int):
    """Vertical edge at patch column x; bs4: (slots, 4) per 4-line group."""
    rows = slice(4, 4 + lines)
    p = patch[:, rows, x - 4 : x][..., ::-1]
    q = patch[:, rows, x : x + 4]
    bs = jnp.repeat(bs4, lines // 4, axis=-1)  # (slots, lines)
    np_, nq_ = _filter_lines(p, q, bs, alpha, beta, idx_a, chroma)
    patch = patch.at[:, rows, x - 4 : x].set(np_[..., ::-1])
    patch = patch.at[:, rows, x : x + 4].set(nq_)
    return patch


def _edge_h(patch, y: int, bs4, alpha, beta, idx_a, chroma, lines: int):
    cols = slice(4, 4 + lines)
    p = jnp.moveaxis(patch[:, y - 4 : y, cols], 1, 2)[..., ::-1]
    q = jnp.moveaxis(patch[:, y : y + 4, cols], 1, 2)
    bs = jnp.repeat(bs4, lines // 4, axis=-1)
    np_, nq_ = _filter_lines(p, q, bs, alpha, beta, idx_a, chroma)
    patch = patch.at[:, y - 4 : y, cols].set(
        jnp.moveaxis(np_[..., ::-1], 2, 1))
    patch = patch.at[:, y : y + 4, cols].set(jnp.moveaxis(nq_, 2, 1))
    return patch


def deblock_frame_device_impl(y, cb, cr, mb_intra, nz_luma, mv,
                              wmb: int, hmb: int, qp: int, qpc: int):
    """Filter the three planes, bit-identical to loopfilter.deblock_frame.

    y: (H, W) int32; cb/cr: (H/2, W/2); mb_intra (nmb,) bool;
    nz_luma (nmb, 16) bool (Z-scan); mv (nmb, 4, 4, 2) int32.
    """
    nmb = wmb * hmb
    idx_y = int(np.clip(qp, 0, 51))
    idx_c = int(np.clip(qpc, 0, 51))
    a_y, b_y = int(ALPHA[idx_y]), int(BETA[idx_y])
    a_c, b_c = int(ALPHA[idx_c]), int(BETA[idx_c])

    nz_raster = nz_luma[:, jnp.asarray(RASTER_TO_LUMA_BLOCK)]
    mvq = mv[:, jnp.asarray(_RASTER_Q), 0, :]  # (nmb, 16, 2)
    bs_v, bs_h = _bs_maps(mb_intra, nz_raster, mvq, wmb, hmb)

    if a_y == 0 or b_y == 0:
        if a_c == 0 or b_c == 0:
            return y, cb, cr  # QP below any filtering threshold

    # pad 4 left/top (neighbour windows) + one scratch MB row at bottom
    # for inactive wavefront slots
    yp = jnp.pad(y, ((4, 20), (4, 16)))
    cbp = jnp.pad(cb, ((4, 12), (4, 8)))
    crp = jnp.pad(cr, ((4, 12), (4, 8)))

    ndiag = 2 * (hmb - 1) + wmb
    slot = jnp.arange(hmb)
    ar20 = jnp.arange(20)
    ar12 = jnp.arange(12)

    def step(d, planes):
        yp, cbp, crp = planes
        rs = slot
        cs = d - 2 * rs
        valid = (cs >= 0) & (cs < wmb)
        rc = jnp.where(valid, rs, 0)
        cc = jnp.where(valid, cs, 0)
        mb = rc * wmb + cc
        # scratch rows for inactive slots (below the real frame)
        ry = jnp.where(valid, rc * 16, hmb * 16 + 4)
        rch = jnp.where(valid, rc * 8, hmb * 8 + 4)

        # gather 20x20 luma / 12x12 chroma windows (origin 4 px up-left)
        gy = yp[ry[:, None, None] + ar20[None, :, None],
                (cc * 16)[:, None, None] + ar20[None, None, :]]
        gcb = cbp[rch[:, None, None] + ar12[None, :, None],
                  (cc * 8)[:, None, None] + ar12[None, None, :]]
        gcr = crp[rch[:, None, None] + ar12[None, :, None],
                  (cc * 8)[:, None, None] + ar12[None, None, :]]

        v = bs_v[mb]  # (slots, 4, 4) [xblk, yblk]
        h = bs_h[mb]  # (slots, 4, 4) [yblk, xblk]
        v = jnp.where(valid[:, None, None], v, 0)
        h = jnp.where(valid[:, None, None], h, 0)

        # vertical edges left→right, then horizontal top→bottom (8.7)
        for xblk in range(4):
            gy = _edge_v(gy, 4 + 4 * xblk, v[:, xblk], a_y, b_y, idx_y,
                         False, 16)
            if xblk in (0, 2):
                # chroma bS per 2-line group = luma bS per 4-line group
                cbs = v[:, xblk]
                gcb = _edge_v(gcb, 4 + 2 * xblk, cbs, a_c, b_c, idx_c,
                              True, 8)
                gcr = _edge_v(gcr, 4 + 2 * xblk, cbs, a_c, b_c, idx_c,
                              True, 8)
        for yblk in range(4):
            gy = _edge_h(gy, 4 + 4 * yblk, h[:, yblk], a_y, b_y, idx_y,
                         False, 16)
            if yblk in (0, 2):
                gcb = _edge_h(gcb, 4 + 2 * yblk, h[:, yblk], a_c, b_c,
                              idx_c, True, 8)
                gcr = _edge_h(gcr, 4 + 2 * yblk, h[:, yblk], a_c, b_c,
                              idx_c, True, 8)

        yp = yp.at[ry[:, None, None] + ar20[None, :, None],
                   (cc * 16)[:, None, None] + ar20[None, None, :]].set(gy)
        cbp = cbp.at[rch[:, None, None] + ar12[None, :, None],
                     (cc * 8)[:, None, None] + ar12[None, None, :]].set(gcb)
        crp = crp.at[rch[:, None, None] + ar12[None, :, None],
                     (cc * 8)[:, None, None] + ar12[None, None, :]].set(gcr)
        return yp, cbp, crp

    yp, cbp, crp = jax.lax.fori_loop(0, ndiag, step, (yp, cbp, crp))
    H, W = hmb * 16, wmb * 16
    return (yp[4 : 4 + H, 4 : 4 + W],
            cbp[4 : 4 + H // 2, 4 : 4 + W // 2],
            crp[4 : 4 + H // 2, 4 : 4 + W // 2])


# jitted top-level entry; device programs embedding this call the _impl
# (see codec/device_intra.py on the jax-0.9 nested-jit const-lifting bug)
deblock_frame_device = functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "qp", "qpc"))(
        deblock_frame_device_impl)
