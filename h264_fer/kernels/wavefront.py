"""Exact intra reconstruction as an anti-diagonal wavefront on device.

The spec's loop-carried dependency (intra prediction reads *reconstructed*
left/top neighbors, SURVEY.md §7 "hard parts") allows min(hmb, wmb)-way
parallelism along MB anti-diagonals. This module implements the
Intra_16x16 luma wavefront: a `lax.fori_loop` over diagonals; each step
batch-processes one diagonal's MBs (predict → forward quant → dequant →
reconstruct) with gather/scatter on an (hmb, wmb, 16, 16) MB-grid layout —
no dynamic slices, pure indexed gathers, fully jittable.

This replaces the host's sequential reconstruction for I16-coded MBs; the
Intra_4x4 wavefront (16-sub-block dependency) and chroma follow the same
scheme (round 2).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import intra, transform


@functools.partial(jax.jit, static_argnames=("wmb", "hmb", "qp"))
def wavefront_i16_luma(y_src, modes, wmb: int, hmb: int, qp: int):
    """Reconstruct a frame where every MB is Intra_16x16 luma.

    y_src: (H, W) int32 source; modes: (nmb,) int32 I16 modes (caller
    guarantees availability-valid modes, e.g. from intra_mode_decision).
    Returns (recon (H, W) int32, i16dc (nmb, 16), ac (nmb, 16, 15)).
    """
    nmb = wmb * hmb
    ndiag = hmb + wmb - 1
    # slots are ABSOLUTE MB rows: must cover every row (a diagonal in a
    # tall grid reaches rows >= min(hmb, wmb))
    dmax = hmb

    src_grid = (
        y_src.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    )  # (hmb, wmb, 16, 16)
    modes_grid = modes.reshape(hmb, wmb)

    # Z-scan block geometry for the DC/AC paths
    from ..ops.tables import INTRA4X4_SCAN_ORDER_XY

    bxy = INTRA4X4_SCAN_ORDER_XY  # (16, 2) x, y

    def mb_blocks(mb):  # (..., 16, 16) -> (..., 16, 4, 4) Z-scan
        b = mb.reshape(*mb.shape[:-2], 2, 2, 4, 2, 2, 4)
        b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
        return b.reshape(*mb.shape[:-2], 16, 4, 4)

    def blocks_mb(blocks):  # inverse of mb_blocks
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 2, 2, 4, 4)
        b = jnp.moveaxis(b, (-6, -5, -4, -3), (-6, -3, -5, -2))
        return b.reshape(*blocks.shape[:-3], 16, 16)

    slot = jnp.arange(dmax)

    def step(d, carry):
        recon, dc_out, ac_out = carry
        rs = slot
        cs = d - slot
        valid = (rs < hmb) & (cs >= 0) & (cs < wmb)
        # invalid slots gather from (0,0) but SCATTER to the scratch row hmb
        rc = jnp.where(valid, rs, 0)
        cc = jnp.where(valid, cs, 0)
        rw = jnp.where(valid, rs, hmb)  # scratch row for invalid writes

        # neighbors from the reconstructed grid (−1 when unavailable)
        left_ok = (cc > 0) & valid
        top_ok = (rc > 0) & valid
        corner_ok = left_ok & top_ok
        lcol = recon[rc, jnp.maximum(cc - 1, 0), :, 15]  # (dmax, 16)
        trow = recon[jnp.maximum(rc - 1, 0), cc, 15, :]
        corner = recon[jnp.maximum(rc - 1, 0), jnp.maximum(cc - 1, 0), 15, 15]
        lcol = jnp.where(left_ok[:, None], lcol, -1)
        trow = jnp.where(top_ok[:, None], trow, -1)
        corner = jnp.where(corner_ok, corner, -1)
        p33 = jnp.concatenate([corner[:, None], lcol, trow], axis=-1)

        m = modes_grid[rc, cc]  # (dmax,)
        preds = intra.predict_16x16_all_modes(p33)  # (4, dmax, 16, 16)
        pred = jnp.take_along_axis(preds, m[None, :, None, None], axis=0)[0]

        srcs = src_grid[rc, cc]  # (dmax, 16, 16)
        diff = mb_blocks(srcs - pred)  # (dmax, 16, 4, 4)
        dq = transform.forward_transform_4x4(diff)
        q = transform.quantize_residual(dq, qp, True)
        # DC path: raster-ordered 4x4 of the per-block DC coefficients
        zx = bxy[:, 0] // 4
        zy = bxy[:, 1] // 4
        dc = jnp.zeros((dmax, 4, 4), jnp.int32)
        dc = dc.at[:, zy, zx].set(q[:, :, 0, 0])
        qdc = transform.forward_dc_luma(dc, qp)
        i16dc_list = transform.zigzag_scan(qdc)  # (dmax, 16)
        ac_list = transform.zigzag_scan(q)[:, :, 1:]  # (dmax, 16, 15)

        # inverse: DC hadamard + per-block residual, reconstruct + clip
        dcv = transform.inverse_dc_luma(transform.zigzag_unscan(i16dc_list), qp)
        full = jnp.concatenate(
            [dcv[:, zy, zx][..., None], ac_list], axis=-1
        )  # (dmax, 16, 16) zigzag lists incl. DC
        res = transform.inverse_residual(
            transform.zigzag_unscan(full), qp, True
        )
        out_mb = jnp.clip(pred + blocks_mb(res), 0, 255)

        recon = recon.at[rw, cc].set(out_mb)
        idx = jnp.where(valid, rc * wmb + cc, nmb)  # nmb = scratch slot
        dc_out = dc_out.at[idx].set(i16dc_list)
        ac_out = ac_out.at[idx].set(ac_list)
        return recon, dc_out, ac_out

    recon0 = jnp.zeros((hmb + 1, wmb, 16, 16), jnp.int32)  # +scratch row
    dc0 = jnp.zeros((nmb + 1, 16), jnp.int32)
    ac0 = jnp.zeros((nmb + 1, 16, 15), jnp.int32)
    recon, dc_out, ac_out = jax.lax.fori_loop(
        0, ndiag, step, (recon0, dc0, ac0)
    )
    frame = recon[:hmb].transpose(0, 2, 1, 3).reshape(hmb * 16, wmb * 16)
    return frame, dc_out[:nmb], ac_out[:nmb]


@functools.partial(jax.jit, static_argnames=("wmb", "hmb", "qp"))
def wavefront_i4x4_luma(y_src, modes, wmb: int, hmb: int, qp: int):
    """Reconstruct a frame where every MB is Intra_4x4 luma.

    The 4x4-block dependency set (left, top, top-right, top-left) admits a
    knight-move wavefront d = 2*R + C over the global block grid
    (R = 4*mb_row + block_row, C = 4*mb_col + block_col): every
    dependency of a block on wave d lies on a wave < d.

    modes: (nmb, 16) Z-scan per-block modes. Returns
    (recon (H, W) int32, levels (nmb, 16, 16) zig-zag coefficient lists).
    """
    from ..ops.tables import RASTER_TO_LUMA_BLOCK

    nmb = wmb * hmb
    HB, WB = 4 * hmb, 4 * wmb
    nwave = 2 * (HB - 1) + WB
    smax = min(HB, WB // 2 + 1)  # max distinct rows on one knight-diagonal

    # source as a (HB, WB, 4, 4) block grid
    src_grid = y_src.reshape(HB, 4, WB, 4).transpose(0, 2, 1, 3)

    # per-global-block mode lookup: mode_grid[R, C]
    rast_to_z = jnp.asarray(RASTER_TO_LUMA_BLOCK)  # raster in MB -> z index
    Rg, Cg = jnp.meshgrid(jnp.arange(HB), jnp.arange(WB), indexing="ij")
    z_idx = rast_to_z[(Rg % 4) * 4 + (Cg % 4)]
    mb_idx = (Rg // 4) * wmb + (Cg // 4)
    mode_grid = modes[mb_idx, z_idx]  # (HB, WB)
    zsel_grid = z_idx
    mb_grid = mb_idx

    slot = jnp.arange(smax)

    def step(d, carry):
        recon, lv_out = carry
        r0 = jnp.maximum(0, (d - WB + 2) // 2)  # first row with C < WB
        R = r0 + slot
        C = d - 2 * R
        valid = (R < HB) & (C >= 0) & (C < WB)
        Rc = jnp.where(valid, R, 0)
        Cc = jnp.where(valid, C, 0)
        Rw = jnp.where(valid, R, HB)  # scratch row

        left_ok = (Cc > 0) & valid
        top_ok = (Rc > 0) & valid
        corner_ok = left_ok & top_ok
        Rm1 = jnp.maximum(Rc - 1, 0)
        Cm1 = jnp.maximum(Cc - 1, 0)
        Cp1 = jnp.minimum(Cc + 1, WB - 1)
        corner = jnp.where(corner_ok, recon[Rm1, Cm1, 3, 3], -1)
        lcol = jnp.where(left_ok[:, None], recon[Rc, Cm1, :, 3], -1)
        trow = jnp.where(top_ok[:, None], recon[Rm1, Cc, 3, :], -1)
        # above-right with the replication rule (intra.cpp:345-370)
        bx = Cc % 4
        by = Rc % 4
        repl = (
            (Cc + 1 >= WB)
            | ((bx == 3) & (by > 0))
            | ((bx == 1) & ((by == 1) | (by == 3)))
        )
        ar_raw = recon[Rm1, Cp1, 3, :]  # (smax, 4)
        last = trow[:, 3]
        ar = jnp.where(
            (repl | ~top_ok)[:, None], last[:, None], ar_raw
        )
        ar = jnp.where(top_ok[:, None], ar, -1)
        p13 = jnp.concatenate([corner[:, None], lcol, trow, ar], axis=-1)

        m = mode_grid[Rc, Cc]
        preds = intra.predict_4x4_all_modes(p13)  # (9, smax, 4, 4)
        pred = jnp.take_along_axis(preds, m[None, :, None, None], axis=0)[0]

        srcs = src_grid[Rc, Cc]
        q = transform.quantize_residual(
            transform.forward_transform_4x4(srcs - pred), qp, False
        )
        res = transform.inverse_residual(q, qp, False)
        out_blk = jnp.clip(pred + res, 0, 255)

        recon = recon.at[Rw, Cc].set(out_blk)
        flat = jnp.where(
            valid, mb_grid[Rc, Cc] * 16 + zsel_grid[Rc, Cc], nmb * 16
        )
        lv_out = lv_out.at[flat].set(transform.zigzag_scan(q))
        return recon, lv_out

    recon0 = jnp.zeros((HB + 1, WB, 4, 4), jnp.int32)
    lv0 = jnp.zeros((nmb * 16 + 1, 16), jnp.int32)
    recon, lv_out = jax.lax.fori_loop(0, nwave, step, (recon0, lv0))
    frame = recon[:HB].transpose(0, 2, 1, 3).reshape(HB * 4, WB * 4)
    return frame, lv_out[: nmb * 16].reshape(nmb, 16, 16)


def wavefront_chroma_impl(cb_src, cr_src, modes, wmb: int, hmb: int,
                          qp: int, band=None):
    """Reconstruct intra chroma for a frame (all MBs intra, per-MB modes).

    cb_src/cr_src: (H/2, W/2) int32; modes: (nmb,) chroma modes; qp is the
    CHROMA QP. MB-diagonal wavefront (left/top/corner deps only).
    Returns (cb, cr, dc (2, nmb, 4), ac (2, nmb, 4, 15)).

    band: optional (axis_name, n_tile, hmb_total, vary_axes) for MB-row
    band tile sharding — hmb is then the LOCAL row count, the wavefront
    runs the GLOBAL schedule, and the band above's reconstructed bottom
    chroma rows arrive via a per-wave ppermute halo (the chroma analog of
    parallel/tile.py's banded I16 exchange, margin exactly 1).
    """
    nmb = wmb * hmb
    if band is not None:
        axis, n_tile, hmb_total, vary_axes = band
        t_idx = jax.lax.axis_index(axis)
        row0 = t_idx * hmb
        has_top = t_idx > 0
        perm = [(i, i + 1) for i in range(n_tile - 1)]
    else:
        hmb_total = hmb
        row0 = 0
    ndiag = hmb_total + wmb - 1
    # slots are ABSOLUTE MB rows: must cover every row (a diagonal in a
    # tall grid reaches rows >= min(hmb, wmb))
    dmax = hmb

    def to_grid(p):
        return p.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3)

    src = jnp.stack([to_grid(cb_src), to_grid(cr_src)])  # (2, hmb, wmb, 8, 8)
    modes_grid = modes.reshape(hmb, wmb)
    slot = jnp.arange(dmax)

    def blocks_of(mb):  # (..., 8, 8) -> (..., 4, 4, 4) raster 4x4 blocks
        b = mb.reshape(*mb.shape[:-2], 2, 4, 2, 4)
        b = jnp.moveaxis(b, -3, -2)
        return b.reshape(*mb.shape[:-2], 4, 4, 4)

    def mb_of(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 4, 4)
        b = jnp.moveaxis(b, -2, -3)
        return b.reshape(*blocks.shape[:-3], 8, 8)

    def step(d, carry):
        recon, dc_out, ac_out, halo_c = carry  # recon: (2, hmb+1, wmb, 8, 8)
        rs = slot
        cs = d - row0 - slot
        valid = (rs < hmb) & (cs >= 0) & (cs < wmb)
        rc = jnp.where(valid, rs, 0)
        cc = jnp.where(valid, cs, 0)
        rw = jnp.where(valid, rs, hmb)

        left_ok = (cc > 0) & valid
        top_in = (rc > 0) & valid
        if band is not None:
            top_halo = (rc == 0) & has_top & valid
        else:
            top_halo = jnp.zeros_like(top_in)
        top_ok = top_in | top_halo
        corner_ok = left_ok & top_ok
        rm1 = jnp.maximum(rc - 1, 0)
        cm1 = jnp.maximum(cc - 1, 0)
        # advanced-indexing axis order: contiguous advanced blocks stay in
        # place ((2, dmax, ...)); the slice-interrupted lcol gather moves
        # them to the front and needs a moveaxis
        corner_in = recon[:, rm1, cm1, 7, 7]
        trow_in = recon[:, rm1, cc, 7, :]
        if band is not None:
            corner_in = jnp.where(top_in[None], corner_in,
                                  halo_c[:, cm1, 7])
            trow_in = jnp.where(top_in[None, :, None], trow_in,
                                halo_c[:, cc])
        corner = jnp.where(corner_ok[None, :], corner_in, -1)
        lcol = jnp.where(
            left_ok[None, :, None], jnp.moveaxis(recon[:, rc, cm1, :, 7], 0, 1), -1
        )
        trow = jnp.where(top_ok[None, :, None], trow_in, -1)
        p17 = jnp.concatenate([corner[..., None], lcol, trow], axis=-1)

        m = modes_grid[rc, cc]
        preds = intra.predict_chroma_all_modes(p17)  # (4, 2, dmax, 8, 8)
        pred = jnp.take_along_axis(
            preds, m[None, None, :, None, None], axis=0
        )[0]  # (2, dmax, 8, 8)

        diff = blocks_of(src[:, rc, cc] - pred)  # (2, dmax, 4, 4, 4)
        q = transform.quantize_residual(
            transform.forward_transform_4x4(diff), qp, True
        )
        dc2 = q[..., 0, 0].reshape(2, dmax, 2, 2)
        qdc = transform.forward_dc_chroma(dc2, qp)
        dcv = transform.inverse_dc_chroma(qdc, qp)
        ac_list = transform.zigzag_scan(q)[..., 1:]  # (2, dmax, 4, 15)
        full = jnp.concatenate(
            [dcv.reshape(2, dmax, 4)[..., None], ac_list], axis=-1
        )
        res = transform.inverse_residual(
            transform.zigzag_unscan(full), qp, True
        )
        out_mb = jnp.clip(pred + mb_of(res), 0, 255)

        recon = recon.at[:, rw, cc].set(out_mb)
        idx = jnp.where(valid, rc * wmb + cc, nmb)
        dc_out = dc_out.at[:, idx].set(qdc.reshape(2, dmax, 4))
        ac_out = ac_out.at[:, idx].set(ac_list)
        if band is not None:
            # boundary exchange: this wave's bottom-row reconstructed
            # chroma rows go to tile t+1, whose matching read is one
            # wave later (parallel/tile.py timing)
            seg_c = out_mb[:, hmb - 1, 7, :]  # (2, 8)
            seg_c = jax.lax.ppermute(seg_c, axis, perm)
            icol = d - row0 + 1
            ivalid = (icol >= 0) & (icol < wmb) & has_top
            ic = jnp.clip(icol, 0, wmb - 1)
            halo_c = halo_c.at[:, ic].set(
                jnp.where(ivalid, seg_c, halo_c[:, ic]))
        return recon, dc_out, ac_out, halo_c

    recon0 = jnp.zeros((2, hmb + 1, wmb, 8, 8), jnp.int32)
    dc0 = jnp.zeros((2, nmb + 1, 4), jnp.int32)
    ac0 = jnp.zeros((2, nmb + 1, 4, 15), jnp.int32)
    halo0 = jnp.zeros((2, wmb, 8), jnp.int32)
    carry0 = (recon0, dc0, ac0, halo0)
    if band is not None:
        axes = tuple(vary_axes) or (axis,)
        carry0 = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, axes, to="varying"), carry0)
    recon, dc_out, ac_out, _ = jax.lax.fori_loop(0, ndiag, step, carry0)

    def from_grid(g):
        return g[:hmb].transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)

    return (from_grid(recon[0]), from_grid(recon[1]),
            dc_out[:, :nmb], ac_out[:, :nmb])


# jitted top-level entry; device programs embedding this call the _impl
# (see codec/device_intra.py on the jax-0.9 nested-jit const-lifting bug)
wavefront_chroma = functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "qp"))(wavefront_chroma_impl)


@functools.partial(jax.jit, static_argnames=("wmb", "hmb", "qp"))
def wavefront_i16_luma_skewed(y_src, modes, wmb: int, hmb: int, qp: int):
    """Skewed-layout variant of wavefront_i16_luma (identical outputs).

    The MB grid is stored diagonal-major: skew[d, i] = MB(r=i, c=d-i), so a
    wavefront step reads rows d-1 / d-2 with dynamic slices and writes row d
    with one dynamic update — no gather/scatter, much lower per-step cost.
    """
    nmb = wmb * hmb
    ndiag = hmb + wmb - 1
    # slots are ABSOLUTE MB rows: must cover every row (a diagonal in a
    # tall grid reaches rows >= min(hmb, wmb))
    dmax = hmb

    src_grid = y_src.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    modes_grid = modes.reshape(hmb, wmb)

    from ..ops.tables import INTRA4X4_SCAN_ORDER_XY

    bxy = INTRA4X4_SCAN_ORDER_XY
    zx = bxy[:, 0] // 4
    zy = bxy[:, 1] // 4

    def mb_blocks(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 2, 4, 2, 2, 4)
        b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
        return b.reshape(*mb.shape[:-2], 16, 4, 4)

    def blocks_mb(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 2, 2, 4, 4)
        b = jnp.moveaxis(b, (-6, -5, -4, -3), (-6, -3, -5, -2))
        return b.reshape(*blocks.shape[:-3], 16, 16)

    slot = jnp.arange(dmax)

    # pre-skew the source and modes: skew[d, i] = (r=i, c=d-i).
    # Built with per-row pads + stack, which compiles much faster than an
    # equivalent fancy gather at 1080p.
    ds = jnp.arange(ndiag)[:, None]
    rr = jnp.broadcast_to(slot[None, :], (ndiag, dmax))
    cc_all = ds - rr
    val_all = (rr < hmb) & (cc_all >= 0) & (cc_all < wmb)

    def skew(grid):
        # grid: (hmb, wmb, ...) → (ndiag, dmax, ...): row r shifted right by r
        rows = []
        for r in range(min(hmb, dmax)):
            pad = [(r, ndiag - wmb - r)] + [(0, 0)] * (grid.ndim - 2)
            rows.append(jnp.pad(grid[r], pad))
        return jnp.stack(rows, axis=1)  # (ndiag, dmax, ...)

    src_skew = skew(src_grid)         # (ndiag, dmax, 16, 16)
    modes_skew = skew(modes_grid)     # (ndiag, dmax)

    def step(d, carry):
        recon, dc_out, ac_out = carry  # recon: (ndiag+2, dmax, 16, 16)
        # +2 offset so rows d-1 / d-2 exist for d = 0, 1
        row_valid = jax.lax.dynamic_slice(val_all, (d, 0), (1, dmax))[0]
        cs = d - slot
        left_ok = (cs > 0) & row_valid
        top_ok = (slot > 0) & row_valid
        corner_ok = left_ok & top_ok

        prev1 = jax.lax.dynamic_slice(
            recon, (d + 1, 0, 0, 0), (1, dmax, 16, 16))[0]
        prev2 = jax.lax.dynamic_slice(
            recon, (d, 0, 0, 0), (1, dmax, 16, 16))[0]
        # left MB (r=i, c-1) = prev1[i]; top MB (r=i-1, c) = prev1[i-1];
        # top-left = prev2[i-1]
        lcol = jnp.where(left_ok[:, None], prev1[:, :, 15], -1)
        top_sh = jnp.roll(prev1, 1, axis=0)
        trow = jnp.where(top_ok[:, None], top_sh[:, 15, :], -1)
        corner_sh = jnp.roll(prev2, 1, axis=0)
        corner = jnp.where(corner_ok, corner_sh[:, 15, 15], -1)
        p33 = jnp.concatenate([corner[:, None], lcol, trow], axis=-1)

        m = jax.lax.dynamic_slice(modes_skew, (d, 0), (1, dmax))[0]
        preds = intra.predict_16x16_all_modes(p33)
        pred = jnp.take_along_axis(preds, m[None, :, None, None], axis=0)[0]

        srcs = jax.lax.dynamic_slice(
            src_skew, (d, 0, 0, 0), (1, dmax, 16, 16))[0]
        diff = mb_blocks(srcs - pred)
        q = transform.quantize_residual(
            transform.forward_transform_4x4(diff), qp, True)
        dc = jnp.zeros((dmax, 4, 4), jnp.int32)
        dc = dc.at[:, zy, zx].set(q[:, :, 0, 0])
        qdc = transform.forward_dc_luma(dc, qp)
        i16dc_list = transform.zigzag_scan(qdc)
        ac_list = transform.zigzag_scan(q)[:, :, 1:]

        dcv = transform.inverse_dc_luma(transform.zigzag_unscan(i16dc_list), qp)
        full = jnp.concatenate([dcv[:, zy, zx][..., None], ac_list], axis=-1)
        res = transform.inverse_residual(transform.zigzag_unscan(full), qp, True)
        out_mb = jnp.clip(pred + blocks_mb(res), 0, 255)

        recon = jax.lax.dynamic_update_slice(
            recon, out_mb[None], (d + 2, 0, 0, 0))
        dc_out = jax.lax.dynamic_update_slice(dc_out, i16dc_list[None], (d, 0, 0))
        ac_out = jax.lax.dynamic_update_slice(ac_out, ac_list[None], (d, 0, 0, 0))
        return recon, dc_out, ac_out

    recon0 = jnp.zeros((ndiag + 2, dmax, 16, 16), jnp.int32)
    dc0 = jnp.zeros((ndiag, dmax, 16), jnp.int32)
    ac0 = jnp.zeros((ndiag, dmax, 16, 15), jnp.int32)
    recon, dc_out, ac_out = jax.lax.fori_loop(0, ndiag, step, (recon0, dc0, ac0))

    # unskew: grid[r, c] = skew[r + c, r]
    rg = jnp.arange(hmb)[:, None]
    cg = jnp.arange(wmb)[None, :]
    grid = recon[2 + rg + cg, jnp.broadcast_to(rg, (hmb, wmb))]
    frame = grid.transpose(0, 2, 1, 3).reshape(hmb * 16, wmb * 16)
    dcg = dc_out[rg + cg, jnp.broadcast_to(rg, (hmb, wmb))].reshape(nmb, 16)
    acg = ac_out[rg + cg, jnp.broadcast_to(rg, (hmb, wmb))].reshape(nmb, 16, 15)
    return frame, dcg, acg


@functools.partial(jax.jit, static_argnames=("wmb", "hmb", "qp"))
def wavefront_chroma_skewed(cb_src, cr_src, modes, wmb: int, hmb: int, qp: int):
    """Skewed-layout chroma wavefront (identical outputs to wavefront_chroma)."""
    nmb = wmb * hmb
    ndiag = hmb + wmb - 1
    dmax = hmb

    def to_grid(p):
        return p.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3)

    src = jnp.stack([to_grid(cb_src), to_grid(cr_src)])  # (2, hmb, wmb, 8, 8)
    modes_grid = modes.reshape(hmb, wmb)
    slot = jnp.arange(dmax)

    ds = jnp.arange(ndiag)[:, None]
    rr = jnp.broadcast_to(slot[None, :], (ndiag, dmax))
    cc_all = ds - rr
    val_all = (rr < hmb) & (cc_all >= 0) & (cc_all < wmb)

    def skew(grid, lead=0):
        rows = []
        for r in range(min(hmb, dmax)):
            g = grid[(slice(None),) * lead + (r,)]
            pad = [(0, 0)] * lead + [(r, ndiag - wmb - r)] + [(0, 0)] * (g.ndim - 1 - lead)
            rows.append(jnp.pad(g, pad))
        return jnp.stack(rows, axis=lead + 1)

    src_skew = skew(src, lead=1)       # (2, ndiag, dmax, 8, 8)
    modes_skew = skew(modes_grid)      # (ndiag, dmax)

    def blocks_of(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 4, 2, 4)
        b = jnp.moveaxis(b, -3, -2)
        return b.reshape(*mb.shape[:-2], 4, 4, 4)

    def mb_of(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 4, 4)
        b = jnp.moveaxis(b, -2, -3)
        return b.reshape(*blocks.shape[:-3], 8, 8)

    def step(d, carry):
        recon, dc_out, ac_out = carry  # recon: (2, ndiag+2, dmax, 8, 8)
        row_valid = jax.lax.dynamic_slice(val_all, (d, 0), (1, dmax))[0]
        cs = d - slot
        left_ok = (cs > 0) & row_valid
        top_ok = (slot > 0) & row_valid
        corner_ok = left_ok & top_ok

        prev1 = jax.lax.dynamic_slice(
            recon, (0, d + 1, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        prev2 = jax.lax.dynamic_slice(
            recon, (0, d, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        lcol = jnp.where(left_ok[None, :, None], prev1[:, :, :, 7], -1)
        top_sh = jnp.roll(prev1, 1, axis=1)
        trow = jnp.where(top_ok[None, :, None], top_sh[:, :, 7, :], -1)
        corner_sh = jnp.roll(prev2, 1, axis=1)
        corner = jnp.where(corner_ok[None, :], corner_sh[:, :, 7, 7], -1)
        p17 = jnp.concatenate([corner[..., None], lcol, trow], axis=-1)

        m = jax.lax.dynamic_slice(modes_skew, (d, 0), (1, dmax))[0]
        preds = intra.predict_chroma_all_modes(p17)  # (4, 2, dmax, 8, 8)
        pred = jnp.take_along_axis(
            preds, m[None, None, :, None, None], axis=0)[0]

        srcs = jax.lax.dynamic_slice(
            src_skew, (0, d, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        diff = blocks_of(srcs - pred)
        q = transform.quantize_residual(
            transform.forward_transform_4x4(diff), qp, True)
        dc2 = q[..., 0, 0].reshape(2, dmax, 2, 2)
        qdc = transform.forward_dc_chroma(dc2, qp)
        dcv = transform.inverse_dc_chroma(qdc, qp)
        ac_list = transform.zigzag_scan(q)[..., 1:]
        full = jnp.concatenate(
            [dcv.reshape(2, dmax, 4)[..., None], ac_list], axis=-1)
        res = transform.inverse_residual(
            transform.zigzag_unscan(full), qp, True)
        out_mb = jnp.clip(pred + mb_of(res), 0, 255)

        recon = jax.lax.dynamic_update_slice(
            recon, out_mb[:, None], (0, d + 2, 0, 0, 0))
        dc_out = jax.lax.dynamic_update_slice(
            dc_out, qdc.reshape(2, dmax, 4)[:, None], (0, d, 0, 0))
        ac_out = jax.lax.dynamic_update_slice(
            ac_out, ac_list[:, None], (0, d, 0, 0, 0))
        return recon, dc_out, ac_out

    recon0 = jnp.zeros((2, ndiag + 2, dmax, 8, 8), jnp.int32)
    dc0 = jnp.zeros((2, ndiag, dmax, 4), jnp.int32)
    ac0 = jnp.zeros((2, ndiag, dmax, 4, 15), jnp.int32)
    recon, dc_out, ac_out = jax.lax.fori_loop(0, ndiag, step, (recon0, dc0, ac0))

    rg = jnp.arange(hmb)[:, None]
    cg = jnp.arange(wmb)[None, :]
    rb = jnp.broadcast_to(rg, (hmb, wmb))
    grid = recon[:, 2 + rg + cg, rb]  # (2, hmb, wmb, 8, 8)? advanced adjacency

    def from_grid(g):
        return g.transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)

    cbp = from_grid(grid[0])
    crp = from_grid(grid[1])
    dcg = dc_out[:, rg + cg, rb].reshape(2, nmb, 4)
    acg = ac_out[:, rg + cg, rb].reshape(2, nmb, 4, 15)
    return cbp, crp, dcg, acg


def wavefront_i16_frame_impl(y_src, cb_src, cr_src, modes, cmodes,
                             wmb: int, hmb: int, qp: int, qpc: int,
                             frame_hmb: int | None = None):
    """Fused luma+chroma I16 wavefront: one diagonal loop reconstructs all
    three planes (halves the per-step dispatch overhead of running the two
    skewed wavefronts back to back). Outputs match the separate kernels.

    `frame_hmb`: per-frame MB rows when `y_src` is a vertical stack of
    B = hmb/frame_hmb frames (GOP batch). MB rows at multiples of
    frame_hmb have no top neighbor, so frames stay independent while
    their wavefronts pipeline through one diagonal sweep (B*frame_hmb +
    wmb - 1 steps for B frames instead of B*(frame_hmb + wmb - 1)).
    """
    nmb = wmb * hmb
    ndiag = hmb + wmb - 1
    dmax = hmb
    fh = frame_hmb if frame_hmb is not None else hmb
    assert hmb % fh == 0

    from ..ops.tables import INTRA4X4_SCAN_ORDER_XY

    bxy = INTRA4X4_SCAN_ORDER_XY
    zx = bxy[:, 0] // 4
    zy = bxy[:, 1] // 4

    ysrc_grid = y_src.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    csrc = jnp.stack([
        cb_src.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3),
        cr_src.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3),
    ])
    modes_grid = modes.reshape(hmb, wmb)
    cmodes_grid = cmodes.reshape(hmb, wmb)
    slot = jnp.arange(dmax)

    ds = jnp.arange(ndiag)[:, None]
    rr = jnp.broadcast_to(slot[None, :], (ndiag, dmax))
    cc_all = ds - rr
    val_all = (rr < hmb) & (cc_all >= 0) & (cc_all < wmb)

    def skew(grid, lead=0):
        rows = []
        for r in range(hmb):
            g = grid[(slice(None),) * lead + (r,)]
            pad = [(0, 0)] * lead + [(r, ndiag - wmb - r)] + [(0, 0)] * (g.ndim - 1 - lead)
            rows.append(jnp.pad(g, pad))
        return jnp.stack(rows, axis=lead + 1)

    ysk = skew(ysrc_grid)
    csk = skew(csrc, lead=1)
    msk = skew(modes_grid)
    cmsk = skew(cmodes_grid)

    def mb_blocks(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 2, 4, 2, 2, 4)
        b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
        return b.reshape(*mb.shape[:-2], 16, 4, 4)

    def blocks_mb(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 2, 2, 4, 4)
        b = jnp.moveaxis(b, (-6, -5, -4, -3), (-6, -3, -5, -2))
        return b.reshape(*blocks.shape[:-3], 16, 16)

    def cblocks_of(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 4, 2, 4)
        b = jnp.moveaxis(b, -3, -2)
        return b.reshape(*mb.shape[:-2], 4, 4, 4)

    def cmb_of(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 4, 4)
        b = jnp.moveaxis(b, -2, -3)
        return b.reshape(*blocks.shape[:-3], 8, 8)

    def step(d, carry):
        yrec, crec, dc_out, ac_out, cdc_out, cac_out = carry
        row_valid = jax.lax.dynamic_slice(val_all, (d, 0), (1, dmax))[0]
        cs = d - slot
        left_ok = (cs > 0) & row_valid
        top_ok = (slot % fh > 0) & row_valid
        corner_ok = left_ok & top_ok

        # --- luma ---
        prev1 = jax.lax.dynamic_slice(yrec, (d + 1, 0, 0, 0), (1, dmax, 16, 16))[0]
        prev2 = jax.lax.dynamic_slice(yrec, (d, 0, 0, 0), (1, dmax, 16, 16))[0]
        lcol = jnp.where(left_ok[:, None], prev1[:, :, 15], -1)
        trow = jnp.where(top_ok[:, None], jnp.roll(prev1, 1, axis=0)[:, 15, :], -1)
        corner = jnp.where(corner_ok, jnp.roll(prev2, 1, axis=0)[:, 15, 15], -1)
        p33 = jnp.concatenate([corner[:, None], lcol, trow], axis=-1)
        m = jax.lax.dynamic_slice(msk, (d, 0), (1, dmax))[0]
        preds = intra.predict_16x16_all_modes(p33)
        pred = jnp.take_along_axis(preds, m[None, :, None, None], axis=0)[0]
        srcs = jax.lax.dynamic_slice(ysk, (d, 0, 0, 0), (1, dmax, 16, 16))[0]
        q = transform.quantize_residual(
            transform.forward_transform_4x4(mb_blocks(srcs - pred)), qp, True)
        dc = jnp.zeros((dmax, 4, 4), jnp.int32).at[:, zy, zx].set(q[:, :, 0, 0])
        qdc = transform.forward_dc_luma(dc, qp)
        i16dc_list = transform.zigzag_scan(qdc)
        ac_list = transform.zigzag_scan(q)[:, :, 1:]
        dcv = transform.inverse_dc_luma(transform.zigzag_unscan(i16dc_list), qp)
        full = jnp.concatenate([dcv[:, zy, zx][..., None], ac_list], axis=-1)
        res = transform.inverse_residual(transform.zigzag_unscan(full), qp, True)
        out_y = jnp.clip(pred + blocks_mb(res), 0, 255)
        yrec = jax.lax.dynamic_update_slice(yrec, out_y[None], (d + 2, 0, 0, 0))
        dc_out = jax.lax.dynamic_update_slice(dc_out, i16dc_list[None], (d, 0, 0))
        ac_out = jax.lax.dynamic_update_slice(ac_out, ac_list[None], (d, 0, 0, 0))

        # --- chroma ---
        cp1 = jax.lax.dynamic_slice(crec, (0, d + 1, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        cp2 = jax.lax.dynamic_slice(crec, (0, d, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        clcol = jnp.where(left_ok[None, :, None], cp1[:, :, :, 7], -1)
        ctrow = jnp.where(top_ok[None, :, None], jnp.roll(cp1, 1, axis=1)[:, :, 7, :], -1)
        ccorner = jnp.where(corner_ok[None, :], jnp.roll(cp2, 1, axis=1)[:, :, 7, 7], -1)
        p17 = jnp.concatenate([ccorner[..., None], clcol, ctrow], axis=-1)
        cm = jax.lax.dynamic_slice(cmsk, (d, 0), (1, dmax))[0]
        cpreds = intra.predict_chroma_all_modes(p17)
        cpred = jnp.take_along_axis(cpreds, cm[None, None, :, None, None], axis=0)[0]
        csrcs = jax.lax.dynamic_slice(csk, (0, d, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        cq = transform.quantize_residual(
            transform.forward_transform_4x4(cblocks_of(csrcs - cpred)), qpc, True)
        cdc2 = cq[..., 0, 0].reshape(2, dmax, 2, 2)
        cqdc = transform.forward_dc_chroma(cdc2, qpc)
        cdcv = transform.inverse_dc_chroma(cqdc, qpc)
        cac_list = transform.zigzag_scan(cq)[..., 1:]
        cfull = jnp.concatenate(
            [cdcv.reshape(2, dmax, 4)[..., None], cac_list], axis=-1)
        cres = transform.inverse_residual(transform.zigzag_unscan(cfull), qpc, True)
        out_c = jnp.clip(cpred + cmb_of(cres), 0, 255)
        crec = jax.lax.dynamic_update_slice(crec, out_c[:, None], (0, d + 2, 0, 0, 0))
        cdc_out = jax.lax.dynamic_update_slice(
            cdc_out, cqdc.reshape(2, dmax, 4)[:, None], (0, d, 0, 0))
        cac_out = jax.lax.dynamic_update_slice(
            cac_out, cac_list[:, None], (0, d, 0, 0, 0))
        return yrec, crec, dc_out, ac_out, cdc_out, cac_out

    carry0 = (
        jnp.zeros((ndiag + 2, dmax, 16, 16), jnp.int32),
        jnp.zeros((2, ndiag + 2, dmax, 8, 8), jnp.int32),
        jnp.zeros((ndiag, dmax, 16), jnp.int32),
        jnp.zeros((ndiag, dmax, 16, 15), jnp.int32),
        jnp.zeros((2, ndiag, dmax, 4), jnp.int32),
        jnp.zeros((2, ndiag, dmax, 4, 15), jnp.int32),
    )
    yrec, crec, dc_out, ac_out, cdc_out, cac_out = jax.lax.fori_loop(
        0, ndiag, step, carry0)

    rg = jnp.arange(hmb)[:, None]
    cg = jnp.arange(wmb)[None, :]
    rb = jnp.broadcast_to(rg, (hmb, wmb))
    frame = yrec[2 + rg + cg, rb].transpose(0, 2, 1, 3).reshape(hmb * 16, wmb * 16)
    cgrid = crec[:, 2 + rg + cg, rb]
    cbp = cgrid[0].transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)
    crp = cgrid[1].transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)
    return (
        frame,
        dc_out[rg + cg, rb].reshape(nmb, 16),
        ac_out[rg + cg, rb].reshape(nmb, 16, 15),
        cbp, crp,
        cdc_out[:, rg + cg, rb].reshape(2, nmb, 4),
        cac_out[:, rg + cg, rb].reshape(2, nmb, 4, 15),
    )


# jitted top-level entry; device programs embedding this call the _impl
# (see codec/device_intra.py on the jax-0.9 nested-jit const-lifting bug)
wavefront_i16_frame = functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "qp", "qpc", "frame_hmb"))(
        wavefront_i16_frame_impl)


@functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "qp", "qpc", "frame_hmb"))
def wavefront_i16_recon(y_src, cb_src, cr_src, modes, cmodes,
                        wmb: int, hmb: int, qp: int, qpc: int,
                        frame_hmb: int | None = None):
    """Recon-only skewed I16 wavefront: wavefront_i16_frame minus the
    in-loop coefficient-list collection (zig-zag scans, DC scatters and
    their dynamic_update_slice buffers). Callers recompute the lists in
    one batched pass from the finished recon — bit-identical, with fewer
    sequential per-diagonal ops.
    """
    ndiag = hmb + wmb - 1
    dmax = hmb
    fh = frame_hmb if frame_hmb is not None else hmb
    assert hmb % fh == 0

    from ..ops.tables import INTRA4X4_SCAN_ORDER_XY

    bxy = INTRA4X4_SCAN_ORDER_XY
    zx = bxy[:, 0] // 4
    zy = bxy[:, 1] // 4

    ysrc_grid = y_src.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    csrc = jnp.stack([
        cb_src.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3),
        cr_src.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3),
    ])
    modes_grid = modes.reshape(hmb, wmb)
    cmodes_grid = cmodes.reshape(hmb, wmb)
    slot = jnp.arange(dmax)

    ds = jnp.arange(ndiag)[:, None]
    rr = jnp.broadcast_to(slot[None, :], (ndiag, dmax))
    cc_all = ds - rr
    val_all = (rr < hmb) & (cc_all >= 0) & (cc_all < wmb)

    def skew(grid, lead=0):
        rows = []
        for r in range(hmb):
            g = grid[(slice(None),) * lead + (r,)]
            pad = [(0, 0)] * lead + [(r, ndiag - wmb - r)] + [(0, 0)] * (g.ndim - 1 - lead)
            rows.append(jnp.pad(g, pad))
        return jnp.stack(rows, axis=lead + 1)

    ysk = skew(ysrc_grid)
    csk = skew(csrc, lead=1)
    msk = skew(modes_grid)
    cmsk = skew(cmodes_grid)

    def mb_blocks(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 2, 4, 2, 2, 4)
        b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
        return b.reshape(*mb.shape[:-2], 16, 4, 4)

    def blocks_mb(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 2, 2, 4, 4)
        b = jnp.moveaxis(b, (-6, -5, -4, -3), (-6, -3, -5, -2))
        return b.reshape(*blocks.shape[:-3], 16, 16)

    def cblocks_of(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 4, 2, 4)
        b = jnp.moveaxis(b, -3, -2)
        return b.reshape(*mb.shape[:-2], 4, 4, 4)

    def cmb_of(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 4, 4)
        b = jnp.moveaxis(b, -2, -3)
        return b.reshape(*blocks.shape[:-3], 8, 8)

    def step(d, carry):
        yrec, crec = carry
        row_valid = jax.lax.dynamic_slice(val_all, (d, 0), (1, dmax))[0]
        cs = d - slot
        left_ok = (cs > 0) & row_valid
        top_ok = (slot % fh > 0) & row_valid
        corner_ok = left_ok & top_ok

        prev1 = jax.lax.dynamic_slice(yrec, (d + 1, 0, 0, 0), (1, dmax, 16, 16))[0]
        prev2 = jax.lax.dynamic_slice(yrec, (d, 0, 0, 0), (1, dmax, 16, 16))[0]
        lcol = jnp.where(left_ok[:, None], prev1[:, :, 15], -1)
        trow = jnp.where(top_ok[:, None], jnp.roll(prev1, 1, axis=0)[:, 15, :], -1)
        corner = jnp.where(corner_ok, jnp.roll(prev2, 1, axis=0)[:, 15, 15], -1)
        p33 = jnp.concatenate([corner[:, None], lcol, trow], axis=-1)
        m = jax.lax.dynamic_slice(msk, (d, 0), (1, dmax))[0]
        preds = intra.predict_16x16_all_modes(p33)
        pred = jnp.take_along_axis(preds, m[None, :, None, None], axis=0)[0]
        srcs = jax.lax.dynamic_slice(ysk, (d, 0, 0, 0), (1, dmax, 16, 16))[0]
        q = transform.quantize_residual(
            transform.forward_transform_4x4(mb_blocks(srcs - pred)), qp, True)
        dc = jnp.zeros((dmax, 4, 4), jnp.int32).at[:, zy, zx].set(q[:, :, 0, 0])
        qdc = transform.forward_dc_luma(dc, qp)
        dcv = transform.inverse_dc_luma(qdc, qp)
        res_in = q.at[:, :, 0, 0].set(dcv[:, zy, zx])
        res = transform.inverse_residual(res_in, qp, True)
        out_y = jnp.clip(pred + blocks_mb(res), 0, 255)
        yrec = jax.lax.dynamic_update_slice(yrec, out_y[None], (d + 2, 0, 0, 0))

        cp1 = jax.lax.dynamic_slice(crec, (0, d + 1, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        cp2 = jax.lax.dynamic_slice(crec, (0, d, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        clcol = jnp.where(left_ok[None, :, None], cp1[:, :, :, 7], -1)
        ctrow = jnp.where(top_ok[None, :, None], jnp.roll(cp1, 1, axis=1)[:, :, 7, :], -1)
        ccorner = jnp.where(corner_ok[None, :], jnp.roll(cp2, 1, axis=1)[:, :, 7, 7], -1)
        p17 = jnp.concatenate([ccorner[..., None], clcol, ctrow], axis=-1)
        cm = jax.lax.dynamic_slice(cmsk, (d, 0), (1, dmax))[0]
        cpreds = intra.predict_chroma_all_modes(p17)
        cpred = jnp.take_along_axis(cpreds, cm[None, None, :, None, None], axis=0)[0]
        csrcs = jax.lax.dynamic_slice(csk, (0, d, 0, 0, 0), (2, 1, dmax, 8, 8))[:, 0]
        cq = transform.quantize_residual(
            transform.forward_transform_4x4(cblocks_of(csrcs - cpred)), qpc, True)
        cdc2 = cq[..., 0, 0].reshape(2, dmax, 2, 2)
        cqdc = transform.forward_dc_chroma(cdc2, qpc)
        cdcv = transform.inverse_dc_chroma(cqdc, qpc)
        cres_in = cq.at[..., 0, 0].set(cdcv.reshape(2, dmax, 4))
        cres = transform.inverse_residual(cres_in, qpc, True)
        out_c = jnp.clip(cpred + cmb_of(cres), 0, 255)
        crec = jax.lax.dynamic_update_slice(crec, out_c[:, None], (0, d + 2, 0, 0, 0))
        return yrec, crec

    carry0 = (
        jnp.zeros((ndiag + 2, dmax, 16, 16), jnp.int32),
        jnp.zeros((2, ndiag + 2, dmax, 8, 8), jnp.int32),
    )
    yrec, crec = jax.lax.fori_loop(0, ndiag, step, carry0)

    rg = jnp.arange(hmb)[:, None]
    cg = jnp.arange(wmb)[None, :]
    rb = jnp.broadcast_to(rg, (hmb, wmb))
    frame = yrec[2 + rg + cg, rb].transpose(0, 2, 1, 3).reshape(hmb * 16, wmb * 16)
    cgrid = crec[:, 2 + rg + cg, rb]
    cbp = cgrid[0].transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)
    crp = cgrid[1].transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)
    return frame, cbp, crp


@functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "qp", "qpc", "frame_hmb"))
def wavefront_i16_scan(y_src, cb_src, cr_src, modes, cmodes,
                       wmb: int, hmb: int, qp: int, qpc: int,
                       frame_hmb: int | None = None):
    """lax.scan formulation of the fused I16 wavefront (same outputs as
    wavefront_i16_frame, bit-identical).

    The skewed fori_loop variants carry the full reconstruction (13 MB at
    1080p, ~110 MB for a 4-frame stack) through the loop and dynamic-slice
    it every diagonal — XLA moves the whole buffer per step. Here the
    loop-carried state is ONLY the previous diagonal's boundary pixels
    (bottom rows / right columns / corner, ~20 KB): per-step inputs arrive
    as scan xs and per-step outputs leave as scan ys, which XLA writes
    in place.
    """
    nmb = wmb * hmb
    ndiag = hmb + wmb - 1
    dmax = hmb
    fh = frame_hmb if frame_hmb is not None else hmb
    assert hmb % fh == 0

    from ..ops.tables import INTRA4X4_SCAN_ORDER_XY

    bxy = INTRA4X4_SCAN_ORDER_XY
    zx = bxy[:, 0] // 4
    zy = bxy[:, 1] // 4

    ysrc_grid = y_src.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    csrc = jnp.stack([
        cb_src.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3),
        cr_src.reshape(hmb, 8, wmb, 8).transpose(0, 2, 1, 3),
    ])
    modes_grid = modes.reshape(hmb, wmb)
    cmodes_grid = cmodes.reshape(hmb, wmb)
    slot = jnp.arange(dmax)

    ds = jnp.arange(ndiag)[:, None]
    rr = jnp.broadcast_to(slot[None, :], (ndiag, dmax))
    cc_all = ds - rr
    val_all = (rr < hmb) & (cc_all >= 0) & (cc_all < wmb)
    left_ok_all = val_all & (cc_all > 0)
    top_ok_all = val_all & ((rr % fh) > 0)

    def skew(grid, lead=0):
        rows = []
        for r in range(hmb):
            g = grid[(slice(None),) * lead + (r,)]
            pad = [(0, 0)] * lead + [(r, ndiag - wmb - r)] + [(0, 0)] * (
                g.ndim - 1 - lead)
            rows.append(jnp.pad(g, pad))
        return jnp.stack(rows, axis=lead + 1)

    ysk = skew(ysrc_grid)                       # (ndiag, dmax, 16, 16)
    csk = jnp.moveaxis(skew(csrc, lead=1), 0, 1)  # (ndiag, 2, dmax, 8, 8)
    msk = skew(modes_grid)
    cmsk = skew(cmodes_grid)

    def mb_blocks(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 2, 4, 2, 2, 4)
        b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
        return b.reshape(*mb.shape[:-2], 16, 4, 4)

    def blocks_mb(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 2, 2, 4, 4)
        b = jnp.moveaxis(b, (-6, -5, -4, -3), (-6, -3, -5, -2))
        return b.reshape(*blocks.shape[:-3], 16, 16)

    def cblocks_of(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 4, 2, 4)
        b = jnp.moveaxis(b, -3, -2)
        return b.reshape(*mb.shape[:-2], 4, 4, 4)

    def cmb_of(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 4, 4)
        b = jnp.moveaxis(b, -2, -3)
        return b.reshape(*blocks.shape[:-3], 8, 8)

    def step(carry, xs):
        # carry: boundary pixels of diagonals d-1 (rows/cols) and d-2 (corner)
        trow_p, lcol_p, cor_p, ctrow_p, clcol_p, ccor_p = carry
        srcs, csrcs, m, cm, left_ok, top_ok = xs
        corner_ok = left_ok & top_ok

        lcol = jnp.where(left_ok[:, None], lcol_p, -1)           # (dmax, 16)
        trow = jnp.where(top_ok[:, None], jnp.roll(trow_p, 1, axis=0), -1)
        corner = jnp.where(corner_ok, jnp.roll(cor_p, 1, axis=0), -1)
        p33 = jnp.concatenate([corner[:, None], lcol, trow], axis=-1)
        preds = intra.predict_16x16_all_modes(p33)
        pred = jnp.take_along_axis(preds, m[None, :, None, None], axis=0)[0]
        q = transform.quantize_residual(
            transform.forward_transform_4x4(mb_blocks(srcs - pred)), qp, True)
        dc = jnp.zeros((dmax, 4, 4), jnp.int32).at[:, zy, zx].set(q[:, :, 0, 0])
        qdc = transform.forward_dc_luma(dc, qp)
        i16dc_list = transform.zigzag_scan(qdc)
        ac_list = transform.zigzag_scan(q)[:, :, 1:]
        dcv = transform.inverse_dc_luma(qdc, qp)
        res = transform.inverse_residual(
            q.at[:, :, 0, 0].set(dcv[:, zy, zx]), qp, True)
        out_y = jnp.clip(pred + blocks_mb(res), 0, 255)

        clcol = jnp.where(left_ok[None, :, None], clcol_p, -1)   # (2, dmax, 8)
        ctrow = jnp.where(top_ok[None, :, None], jnp.roll(ctrow_p, 1, axis=1), -1)
        ccorner = jnp.where(corner_ok[None, :], jnp.roll(ccor_p, 1, axis=1), -1)
        p17 = jnp.concatenate([ccorner[..., None], clcol, ctrow], axis=-1)
        cpreds = intra.predict_chroma_all_modes(p17)
        cpred = jnp.take_along_axis(
            cpreds, cm[None, None, :, None, None], axis=0)[0]
        cq = transform.quantize_residual(
            transform.forward_transform_4x4(cblocks_of(csrcs - cpred)), qpc, True)
        cdc2 = cq[..., 0, 0].reshape(2, dmax, 2, 2)
        cqdc = transform.forward_dc_chroma(cdc2, qpc)
        cdcv = transform.inverse_dc_chroma(cqdc, qpc)
        cac_list = transform.zigzag_scan(cq)[..., 1:]
        cres = transform.inverse_residual(
            cq.at[..., 0, 0].set(cdcv.reshape(2, dmax, 4)), qpc, True)
        out_c = jnp.clip(cpred + cmb_of(cres), 0, 255)

        new_carry = (
            out_y[:, 15, :],            # bottom rows   (dmax, 16)
            out_y[:, :, 15],            # right cols    (dmax, 16)
            trow_p[:, 15],              # d-1 bottom-right → next step's d-2
            out_c[:, :, 7, :],          # chroma bottom (2, dmax, 8)
            out_c[:, :, :, 7],          # chroma right  (2, dmax, 8)
            ctrow_p[:, :, 7],           # (2, dmax)
        )
        ys = (out_y, i16dc_list, ac_list, out_c,
              cqdc.reshape(2, dmax, 4), cac_list)
        return new_carry, ys

    carry0 = (
        jnp.zeros((dmax, 16), jnp.int32),
        jnp.zeros((dmax, 16), jnp.int32),
        jnp.zeros((dmax,), jnp.int32),
        jnp.zeros((2, dmax, 8), jnp.int32),
        jnp.zeros((2, dmax, 8), jnp.int32),
        jnp.zeros((2, dmax), jnp.int32),
    )
    _, ys = jax.lax.scan(
        step, carry0, (ysk, csk, msk, cmsk, left_ok_all, top_ok_all))
    yrec, dc_out, ac_out, crec, cdc_out, cac_out = ys

    rg = jnp.arange(hmb)[:, None]
    cg = jnp.arange(wmb)[None, :]
    rb = jnp.broadcast_to(rg, (hmb, wmb))
    frame = yrec[rg + cg, rb].transpose(0, 2, 1, 3).reshape(hmb * 16, wmb * 16)
    cgrid = crec[rg + cg, :, rb]  # (hmb, wmb, 2, 8, 8)
    cbp = cgrid[:, :, 0].transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)
    crp = cgrid[:, :, 1].transpose(0, 2, 1, 3).reshape(hmb * 8, wmb * 8)
    dcg = dc_out[rg + cg, rb].reshape(nmb, 16)
    acg = ac_out[rg + cg, rb].reshape(nmb, 16, 15)
    cdcg = jnp.moveaxis(cdc_out[rg + cg, :, rb].reshape(nmb, 2, 4), 1, 0)
    cacg = jnp.moveaxis(cac_out[rg + cg, :, rb].reshape(nmb, 2, 4, 15), 1, 0)
    return frame, dcg, acg, cbp, crp, cdcg, cacg
