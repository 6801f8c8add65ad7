"""Device mixed-mode I-frame wavefront: exact Intra_4x4-vs-Intra_16x16
arbitration by coded bit size, on device.

The reference decides I4x4-vs-I16 per MB by the exact bit cost of the
fully coded macroblock (intra.cpp:1088-1107 calling the coded_mb_size
oracle, rbsp_encoding.cpp:330-488) — a decision that is loop-carried
three ways: the winner's reconstruction feeds the neighbors' predictions,
its TotalCoeff feeds their nC contexts, and its coding class feeds their
most-probable-mode derivation. This kernel fuses all of it into a single
knight-move MB wavefront (wave d = 2·row + col, so the top-right MB a
4x4 block's above-right samples come from is always on an earlier wave):
each wave batch-processes its MBs — I16 candidate (predict/quant/recon),
I4x4 candidate (16 sequential in-MB block steps, z-scan order exactly
like the host loop), exact CAVLC bit sizes for both via the batched
symbol machinery (ops/cavlc_jax.py, sizes_only), arbitration, state
update.

Byte-level parity: with the same pre-decided modes, streams built from
this kernel's outputs are identical to the host encoder's
(tests/test_wavefront_mixed.py).

Chroma is independent of the luma arbitration (prediction reads only
chroma planes; the chroma mode is tied to the I16 mode; chroma bits
appear in both candidates whenever either emits a residual section), so
the caller runs the chroma wavefront separately and passes the resulting
per-MB cbp_chroma and exact chroma residual bit counts in.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..codec.decoder import _luma_blk_neighbors
from ..ops import intra, transform
from ..ops.cavlc_jax import block_symbols_bulk, nc_to_ctx, ue_bits
from ..ops.tables import INTRA4X4_SCAN_ORDER_XY

_BXY = [(int(INTRA4X4_SCAN_ORDER_XY[z, 0]), int(INTRA4X4_SCAN_ORDER_XY[z, 1]))
        for z in range(16)]
_NBR = [_luma_blk_neighbors(z) for z in range(16)]


def _gated_tc(tc, cbp, blk: int):
    """n_of (residual.cpp allNeighbouringZero semantics): 0 when the
    block's 8x8 quadrant is not coded."""
    return jnp.where((cbp >> (blk // 4)) & 1 != 0, tc[..., blk], 0)


def wavefront_mixed_luma_impl(y_src, mode16, mode4, cmode, cbp_c,
                              chroma_bits, wmb: int, hmb: int, qp: int,
                              band=None, m4_halo=None):
    """Returns dict with the winner reconstruction + levels + syntax state.

    y_src: (H, W) int32; mode16 (nmb,), mode4 (nmb, 16) pre-decided modes;
    cmode (nmb,) chroma modes; cbp_c (nmb,) coded-block-pattern chroma;
    chroma_bits (nmb,) exact chroma residual bits (0 when cbp_c == 0).

    band: optional (axis_name, n_tile, hmb_total, vary_axes) for MB-row
    band tile sharding — hmb is then the LOCAL row count, the knight
    wavefront runs the GLOBAL schedule, and the band above's final
    bottom-row state (reconstructed pixel row, I4-vs-I16 choice,
    TotalCoeff, CBP) arrives via a per-wave ppermute halo with margin 1
    (d = 2r + c puts the consumer exactly one wave after the sender,
    like kernels/wavefront_p.py's band mode). m4_halo: (wmb, 16) the
    band above's last-row pre-decided I4x4 modes (static input — modes
    are inputs, so one pre-wavefront exchange suffices).
    """
    nmb = wmb * hmb
    if band is not None:
        axis, n_tile, hmb_total, vary_axes = band
        t_idx = jax.lax.axis_index(axis)
        row0 = t_idx * hmb
        has_top = t_idx > 0
        perm = [(i, i + 1) for i in range(n_tile - 1)]
        nwave = 2 * (hmb_total - 1) + wmb
        smax = hmb
    else:
        row0 = 0
        nwave = 2 * (hmb - 1) + wmb
        smax = min(hmb, wmb // 2 + 1)

    src_grid = y_src.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)
    mode16_g = mode16.reshape(hmb, wmb)
    mode4_g = mode4.reshape(hmb, wmb, 16)
    cmode_g = cmode.reshape(hmb, wmb)
    cbpc_g = cbp_c.reshape(hmb, wmb)
    cbits_g = chroma_bits.reshape(hmb, wmb)

    zx = jnp.asarray([b[0] // 4 for b in _BXY])
    zy = jnp.asarray([b[1] // 4 for b in _BXY])

    def mb_blocks(mb):  # (..., 16, 16) → (..., 16, 4, 4) Z-scan
        b = mb.reshape(*mb.shape[:-2], 2, 2, 4, 2, 2, 4)
        b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
        return b.reshape(*mb.shape[:-2], 16, 4, 4)

    def blocks_mb(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 2, 2, 4, 4)
        b = jnp.moveaxis(b, (-6, -5, -4, -3), (-6, -3, -5, -2))
        return b.reshape(*blocks.shape[:-3], 16, 16)

    slot = jnp.arange(smax)

    from ..ops.tables import CBP_TO_CODENUM_INTRA

    cbp_code_tab = jnp.asarray(CBP_TO_CODENUM_INTRA)

    def step(d, carry):
        (recon, tcl, cbpl, i4flag,
         o_choice, o_i16dc, o_i16ac, o_lv4, o_pf, o_rm, o_cbp,
         h_row, h_i4, h_tc, h_cbp) = carry
        if band is None:
            r0 = jnp.maximum(0, (d - wmb + 2) // 2)
            rs = r0 + slot
            cs = d - 2 * rs
        else:
            rs = slot
            cs = d - 2 * (row0 + rs)
        valid = (rs < hmb) & (cs >= 0) & (cs < wmb)
        rc = jnp.where(valid, rs, 0)
        cc = jnp.where(valid, cs, 0)
        rw = jnp.where(valid, rs, hmb)  # scratch row for invalid writes

        left_ok = (cc > 0) & valid
        top_in = (rc > 0) & valid
        if band is not None:
            top_halo = (rc == 0) & has_top & valid
        else:
            top_halo = jnp.zeros_like(top_in)
        top_ok = top_in | top_halo
        corner_ok = left_ok & top_ok
        tr_ok = top_ok & (cc + 1 < wmb)
        rm1 = jnp.maximum(rc - 1, 0)
        cm1 = jnp.maximum(cc - 1, 0)
        cp1 = jnp.minimum(cc + 1, wmb - 1)

        left_mb = recon[rc, cm1]  # (smax, 16, 16)
        top_mb = recon[rm1, cc]
        tl_mb = recon[rm1, cm1]
        tr_mb = recon[rm1, cp1]
        # every cross-MB read below touches only ROW 15 of the top-side
        # MBs: swap in the exchanged bottom-row halo at the band's top
        top_row15 = top_mb[:, 15, :]
        tl_r15 = tl_mb[:, 15, :]
        tr_r15 = tr_mb[:, 15, :]
        if band is not None:
            top_row15 = jnp.where(top_in[:, None], top_row15, h_row[cc])
            tl_r15 = jnp.where(top_in[:, None], tl_r15, h_row[cm1])
            tr_r15 = jnp.where(top_in[:, None], tr_r15, h_row[cp1])

        srcs = src_grid[rc, cc]  # (smax, 16, 16)
        src_zblocks = mb_blocks(srcs)  # (smax, 16, 4, 4)

        # ---------------- I16 candidate --------------------------------
        lcol = jnp.where(left_ok[:, None], left_mb[:, :, 15], -1)
        trow = jnp.where(top_ok[:, None], top_row15, -1)
        corner = jnp.where(corner_ok, tl_r15[:, 15], -1)
        p33 = jnp.concatenate([corner[:, None], lcol, trow], axis=-1)
        m16 = mode16_g[rc, cc]
        preds16 = intra.predict_16x16_all_modes(p33)
        pred16 = jnp.take_along_axis(
            preds16, m16[None, :, None, None], axis=0)[0]
        diff16 = mb_blocks(srcs - pred16)
        q16 = transform.quantize_residual(
            transform.forward_transform_4x4(diff16), qp, True)
        dc = jnp.zeros((smax, 4, 4), jnp.int32)
        dc = dc.at[:, zy, zx].set(q16[:, :, 0, 0])
        qdc = transform.forward_dc_luma(dc, qp)
        i16dc_list = transform.zigzag_scan(qdc)  # (smax, 16)
        i16ac_list = transform.zigzag_scan(q16)[:, :, 1:]  # (smax, 16, 15)
        dcv = transform.inverse_dc_luma(
            transform.zigzag_unscan(i16dc_list), qp)
        full = jnp.concatenate(
            [dcv[:, zy, zx][..., None], i16ac_list], axis=-1)
        res16 = transform.inverse_residual(
            transform.zigzag_unscan(full), qp, True)
        recon16 = jnp.clip(pred16 + blocks_mb(res16), 0, 255)

        # ---------------- I4x4 candidate (16 in-MB z-scan steps) -------
        work = srcs  # progressively replaced by reconstructed blocks
        lv4 = jnp.zeros((smax, 16, 16), jnp.int32)
        pf = jnp.zeros((smax, 16), bool)
        rm = jnp.zeros((smax, 16), jnp.int32)
        i4_left = (i4flag[rc, cm1] != 0) & left_ok
        i4_top_v = i4flag[rm1, cc]
        m4_top = mode4_g[rm1, cc]
        if band is not None:
            i4_top_v = jnp.where(top_in, i4_top_v, h_i4[cc])
            m4_top = jnp.where(top_in[:, None], m4_top, m4_halo[cc])
        i4_top = (i4_top_v != 0) & top_ok
        m4_left = mode4_g[rc, cm1]  # (smax, 16)
        m4_own = mode4_g[rc, cc]
        for z in range(16):
            bx, by = _BXY[z]
            # p13 assembly (exactly _fetch_p13 / intra.cpp:294-378)
            if bx > 0:
                l4 = work[:, by : by + 4, bx - 1]
            else:
                l4 = jnp.where(left_ok[:, None],
                               left_mb[:, by : by + 4, 15], -1)
            if by > 0:
                t4 = work[:, by - 1, bx : bx + 4]
            else:
                t4 = jnp.where(top_ok[:, None], top_row15[:, bx : bx + 4],
                               -1)
            if bx > 0 and by > 0:
                cn = work[:, by - 1, bx - 1]
            elif bx == 0 and by > 0:
                cn = jnp.where(left_ok, left_mb[:, by - 1, 15], -1)
            elif bx > 0 and by == 0:
                cn = jnp.where(top_ok, top_row15[:, bx - 1], -1)
            else:
                cn = jnp.where(corner_ok, tl_r15[:, 15], -1)
            last = t4[:, 3]
            repl = z in (3, 11) or (bx == 12 and by > 0)
            if repl:
                ar = jnp.broadcast_to(last[:, None], (smax, 4))
            elif by > 0:
                ar = work[:, by - 1, bx + 4 : bx + 8]
            elif bx == 12:  # z == 5: above-right lives in the NE MB
                ar = jnp.where(tr_ok[:, None], tr_r15[:, 0:4],
                               last[:, None])
            else:
                ar = top_row15[:, bx + 4 : bx + 8]
            if by == 0:
                # frame-top edge: whole p[5:13] stays -1 like the host
                ar = jnp.where(top_ok[:, None], ar, -1)
            p13 = jnp.concatenate(
                [cn[:, None], l4, t4, ar], axis=-1)

            # MPM (setIntra4x4PredMode, intra.cpp:878-942)
            a_same, a_blk, b_same, b_blk = _NBR[z]
            if a_same:
                mode_a = m4_own[:, a_blk]
                a_ok = valid
            else:
                mode_a = jnp.where(i4_left, m4_left[:, a_blk], 2)
                a_ok = left_ok
            if b_same:
                mode_b = m4_own[:, b_blk]
                b_ok = valid
            else:
                mode_b = jnp.where(i4_top, m4_top[:, b_blk], 2)
                b_ok = top_ok
            unavail = ~(a_ok & b_ok)
            mode_a = jnp.where(unavail, 2, mode_a)
            mode_b = jnp.where(unavail, 2, mode_b)
            mpm = jnp.minimum(mode_a, mode_b)
            m = m4_own[:, z]
            pf = pf.at[:, z].set(m == mpm)
            rm = rm.at[:, z].set(jnp.where(m < mpm, m, m - 1))

            preds4 = intra.predict_4x4_all_modes(p13)  # (9, smax, 4, 4)
            pred = jnp.take_along_axis(
                preds4, m[None, :, None, None], axis=0)[0]
            sblk = srcs[:, by : by + 4, bx : bx + 4]
            q4 = transform.quantize_residual(
                transform.forward_transform_4x4(sblk - pred), qp, False)
            lv4 = lv4.at[:, z].set(transform.zigzag_scan(q4))
            res4 = transform.inverse_residual(q4, qp, False)
            out_blk = jnp.clip(pred + res4, 0, 255)
            work = work.at[:, by : by + 4, bx : bx + 4].set(out_blk)
        recon4 = work

        # ---------------- exact bit sizes (coded_mb_size) ---------------
        cbp16 = jnp.where(i16ac_list.reshape(smax, -1).any(axis=-1), 15, 0)
        quad_nz = lv4.any(axis=-1).reshape(smax, 4, 4).any(axis=-1)
        cbp4 = (
            quad_nz[:, 0] * 1 + quad_nz[:, 1] * 2
            + quad_nz[:, 2] * 4 + quad_nz[:, 3] * 8
        ).astype(jnp.int32)

        dc_blk = block_symbols_bulk(i16dc_list, 16, sizes_only=True)
        ac_blk = block_symbols_bulk(i16ac_list, 15, sizes_only=True)
        l4_blk = block_symbols_bulk(lv4, 16, sizes_only=True)
        tc16 = ac_blk["tc"]  # (smax, 16)
        tc4 = l4_blk["tc"]

        tcl_left = tcl[rc, cm1]
        tcl_top = tcl[rm1, cc]
        cbp_left = cbpl[rc, cm1]
        cbp_top = cbpl[rm1, cc]
        if band is not None:
            tcl_top = jnp.where(top_in[:, None], tcl_top, h_tc[cc])
            cbp_top = jnp.where(top_in, cbp_top, h_cbp[cc])

        def nc_grid(tc_own, cbp_own):
            cols = []
            for z in range(16):
                a_same, a_blk, b_same, b_blk = _NBR[z]
                if a_same:
                    nA = _gated_tc(tc_own, cbp_own, a_blk)
                    a_ok = valid
                else:
                    nA = _gated_tc(tcl_left, cbp_left, a_blk)
                    a_ok = left_ok
                if b_same:
                    nB = _gated_tc(tc_own, cbp_own, b_blk)
                    b_ok = valid
                else:
                    nB = _gated_tc(tcl_top, cbp_top, b_blk)
                    b_ok = top_ok
                nc = jnp.where(
                    a_ok & b_ok, (nA + nB + 1) >> 1,
                    jnp.where(a_ok, nA, jnp.where(b_ok, nB, 0)))
                cols.append(nc)
            return jnp.stack(cols, axis=-1)  # (smax, 16)

        def ct_of(blk_out, ctx):
            return jnp.take_along_axis(
                blk_out["ct_len"], ctx[..., None], axis=-1)[..., 0]

        nc16 = nc_grid(tc16, cbp16)
        nc4 = nc_grid(tc4, cbp4)
        dc_bits = ct_of(dc_blk, nc_to_ctx(nc16[:, 0])) + dc_blk["rest_bits"]
        ac_bits = (ct_of(ac_blk, nc_to_ctx(nc16)) + ac_blk["rest_bits"])
        l4_bits = (ct_of(l4_blk, nc_to_ctx(nc4)) + l4_blk["rest_bits"])
        quad_gate = ((cbp4[:, None] >> (jnp.arange(16) // 4)) & 1) != 0
        l4_bits_sum = jnp.where(quad_gate, l4_bits, 0).sum(axis=-1)

        cmode_s = cmode_g[rc, cc]
        cbpc_s = cbpc_g[rc, cc]
        cbits_s = cbits_g[rc, cc]
        mbtype16 = 1 + m16 + 4 * cbpc_s + jnp.where(cbp16 == 15, 12, 0)
        size16 = (
            ue_bits(mbtype16) + ue_bits(cmode_s) + 1
            + dc_bits
            + jnp.where(cbp16 == 15, ac_bits.sum(axis=-1), 0)
            + cbits_s
        )
        predmode_bits = jnp.where(pf, 1, 4).sum(axis=-1)
        cbp_code = cbp_code_tab[(cbpc_s << 4) | cbp4]
        resid4 = (cbp4 > 0) | (cbpc_s > 0)
        size4 = (
            1 + predmode_bits + ue_bits(cmode_s) + ue_bits(cbp_code)
            + jnp.where(resid4, 1 + l4_bits_sum + cbits_s, 0)
        )
        choice = size4 < size16  # intra.cpp:1088 strict comparison

        # ---------------- state update ---------------------------------
        recon_new = jnp.where(choice[:, None, None], recon4, recon16)
        recon = recon.at[rw, cc].set(recon_new)
        dc_tc_state = jnp.concatenate(
            [dc_blk["tc"][:, None], jnp.zeros((smax, 15), jnp.int32)],
            axis=-1)
        tc16_state = jnp.where((cbp16 == 15)[:, None], tc16, dc_tc_state)
        tc4_state = jnp.where(quad_gate, tc4, 0)
        tcl = tcl.at[rw, cc].set(
            jnp.where(choice[:, None], tc4_state, tc16_state))
        cbp_w = jnp.where(choice, cbp4, cbp16)
        cbpl = cbpl.at[rw, cc].set(cbp_w)
        i4flag = i4flag.at[rw, cc].set(choice.astype(jnp.int32))

        idx = jnp.where(valid, rc * wmb + cc, nmb)
        o_choice = o_choice.at[idx].set(choice)
        o_i16dc = o_i16dc.at[idx].set(i16dc_list)
        o_i16ac = o_i16ac.at[idx].set(i16ac_list)
        o_lv4 = o_lv4.at[idx].set(lv4)
        o_pf = o_pf.at[idx].set(pf)
        o_rm = o_rm.at[idx].set(rm)
        o_cbp = o_cbp.at[idx].set(cbp_w)
        if band is not None:
            # bottom-row final state to tile t+1 (margin 1: its matching
            # read is at the next wave under d = 2r + c)
            seg = (recon_new[hmb - 1, 15, :],
                   choice.astype(jnp.int32)[hmb - 1],
                   jnp.where(choice[:, None], tc4_state,
                             tc16_state)[hmb - 1],
                   cbp_w[hmb - 1])
            seg = jax.lax.ppermute(seg, axis, perm)
            icol = d - 2 * row0 + 2
            ivalid = (icol >= 0) & (icol < wmb) & has_top
            ic = jnp.clip(icol, 0, wmb - 1)
            h_row = h_row.at[ic].set(jnp.where(ivalid, seg[0], h_row[ic]))
            h_i4 = h_i4.at[ic].set(jnp.where(ivalid, seg[1], h_i4[ic]))
            h_tc = h_tc.at[ic].set(jnp.where(ivalid, seg[2], h_tc[ic]))
            h_cbp = h_cbp.at[ic].set(jnp.where(ivalid, seg[3], h_cbp[ic]))
        return (recon, tcl, cbpl, i4flag,
                o_choice, o_i16dc, o_i16ac, o_lv4, o_pf, o_rm, o_cbp,
                h_row, h_i4, h_tc, h_cbp)

    carry0 = (
        jnp.zeros((hmb + 1, wmb, 16, 16), jnp.int32),
        jnp.zeros((hmb + 1, wmb, 16), jnp.int32),
        jnp.zeros((hmb + 1, wmb), jnp.int32),
        jnp.zeros((hmb + 1, wmb), jnp.int32),
        jnp.zeros((nmb + 1,), bool),
        jnp.zeros((nmb + 1, 16), jnp.int32),
        jnp.zeros((nmb + 1, 16, 15), jnp.int32),
        jnp.zeros((nmb + 1, 16, 16), jnp.int32),
        jnp.zeros((nmb + 1, 16), bool),
        jnp.zeros((nmb + 1, 16), jnp.int32),
        jnp.zeros((nmb + 1,), jnp.int32),
        jnp.zeros((wmb, 16), jnp.int32),
        jnp.zeros((wmb,), jnp.int32),
        jnp.zeros((wmb, 16), jnp.int32),
        jnp.zeros((wmb,), jnp.int32),
    )
    if band is not None:
        axes = tuple(vary_axes) or (axis,)
        carry0 = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, axes, to="varying"), carry0)
    out = jax.lax.fori_loop(0, nwave, step, carry0)
    (recon, tcl, cbpl, i4flag,
     o_choice, o_i16dc, o_i16ac, o_lv4, o_pf, o_rm, o_cbp,
     _, _, _, _) = out
    frame = recon[:hmb].transpose(0, 2, 1, 3).reshape(hmb * 16, wmb * 16)
    return {
        "recon_y": frame,
        "choice4": o_choice[:nmb],
        "i16dc": o_i16dc[:nmb],
        "i16ac": o_i16ac[:nmb],
        "lv4": o_lv4[:nmb],
        "prev_flags": o_pf[:nmb],
        "rem_modes": o_rm[:nmb],
        "cbp_luma": o_cbp[:nmb],
        "tc_luma": tcl[:hmb].reshape(nmb, 16),
    }


# jitted top-level entry; device programs embedding this call the _impl
# (see codec/device_intra.py on the jax-0.9 nested-jit const-lifting bug)
wavefront_mixed_luma = functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "qp"))(wavefront_mixed_luma_impl)
