"""Device whole-slice entropy for I16 frames (SURVEY §7 "CAVLC on device").

The counterpart of the reference's per-MB writer loop
(rbsp_encoding.cpp:175-305 + residual.cpp:374-666) as a fully parallel
device program: for an all-Intra_16x16 frame, every macroblock_layer
symbol is a pure function of the (already wavefront-reconstructed) level
arrays — the nC context only needs the *final* TotalCoeff of the left/top
MBs, which are known in bulk. So unlike reconstruction, entropy needs NO
wavefront: per-MB header symbols (ue/se) and per-block CAVLC symbols are
computed for all MBs at once (ops/cavlc_jax.py), then a prefix scan over
symbol lengths assembles the whole slice's payload bits on device.

Host involvement per frame: read back the packed words + per-MB state and
insert emulation-prevention bytes. Bit-identical to the native C++ packer
(native/cavlc_native.cpp i16_frame_entropy) — tests/test_device_entropy.py.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import tables as T
from ..ops.cavlc_jax import (
    block_symbols_bulk,
    finalize_symbols,
    nc_to_ctx,
    pack_symbols,
    se_code,
    ue_code,
)

# static neighbor maps (z-scan): (a_same, a_blk, b_same, b_blk) per block
from .decoder import _chroma_blk_neighbors, _luma_blk_neighbors

_LUMA_NBR = [_luma_blk_neighbors(b) for b in range(16)]
_CHROMA_NBR = [_chroma_blk_neighbors(b) for b in range(4)]


def _nc_luma_grid(tc_own, tc_state, cbp_own, cbp_state, wmb: int, hmb: int,
                  top_ctx=None):
    """Per-block luma nC for every MB (residual.cpp:251-294 derivation +
    allNeighbouringZero CBP gating).

    tc_own/cbp_own: this MB's own (candidate) TCs (nmb, 16) / CBP (nmb,)
    used for in-MB chaining; tc_state/cbp_state: the final per-MB state
    grids used for cross-MB reads (identical to own for the all-I16 path).
    top_ctx: optional (top_tc (wmb, 16), top_cbp (wmb,), top_valid bool
    scalar) — the final state of the MB row above the first row, for
    MB-row-band tile sharding (parallel/tile.py); top_valid is False on
    the topmost tile. Returns (nmb, 16) int32 nC.
    """
    nmb = wmb * hmb
    mb = jnp.arange(nmb)
    left_edge = mb % wmb == 0
    top_edge = mb < wmb
    # neighbour reads are raster-index shifts — pad+slice, never gather
    # (a per-element gather breaks the surrounding fusion)
    tc_L = jnp.concatenate([tc_state[:1], tc_state[:-1]], axis=0)
    cbp_L = jnp.concatenate([cbp_state[:1], cbp_state[:-1]], axis=0)
    tc_T = jnp.concatenate([tc_state[:wmb], tc_state[:-wmb]], axis=0)
    cbp_T = jnp.concatenate([cbp_state[:wmb], cbp_state[:-wmb]], axis=0)

    cols = []
    for blk in range(16):
        a_same, a_blk, b_same, b_blk = _LUMA_NBR[blk]
        if a_same:
            nA = jnp.where((cbp_own >> (a_blk // 4)) & 1 != 0,
                           tc_own[:, a_blk], 0)
            a_ok = jnp.ones(nmb, bool)
        else:
            nA = jnp.where((cbp_L >> (a_blk // 4)) & 1 != 0,
                           tc_L[:, a_blk], 0)
            a_ok = ~left_edge
        if b_same:
            nB = jnp.where((cbp_own >> (b_blk // 4)) & 1 != 0,
                           tc_own[:, b_blk], 0)
            b_ok = jnp.ones(nmb, bool)
        else:
            nB = jnp.where((cbp_T >> (b_blk // 4)) & 1 != 0,
                           tc_T[:, b_blk], 0)
            b_ok = ~top_edge
            if top_ctx is not None:
                top_tc, top_cbp, top_valid = top_ctx
                pad_n = nmb - wmb
                halo_tc = jnp.concatenate(
                    [top_tc[:, b_blk], jnp.zeros((pad_n,), jnp.int32)])
                halo_cbp = jnp.concatenate(
                    [top_cbp, jnp.zeros((pad_n,), top_cbp.dtype)])
                nB_halo = jnp.where(
                    (halo_cbp >> (b_blk // 4)) & 1 != 0, halo_tc, 0)
                nB = jnp.where(top_edge, nB_halo, nB)
                b_ok = b_ok | (top_edge & top_valid)
        nc = jnp.where(
            a_ok & b_ok, (nA + nB + 1) >> 1,
            jnp.where(a_ok, nA, jnp.where(b_ok, nB, 0)),
        )
        cols.append(nc)
    return jnp.stack(cols, axis=-1)


def _nc_chroma_grid(tc_c, cbp_c, wmb: int, hmb: int, top_ctx=None):
    """(2, nmb, 4) chroma AC nC (cbp_chroma & 2 gating). top_ctx:
    optional (top_tc_c (2, wmb, 4), top_cbp_c (wmb,), top_valid) tile
    halo — see _nc_luma_grid."""
    nmb = wmb * hmb
    mb = jnp.arange(nmb)
    left_edge = mb % wmb == 0
    top_edge = mb < wmb
    tc_Lc = jnp.concatenate([tc_c[:, :1], tc_c[:, :-1]], axis=1)
    cbp_Lc = jnp.concatenate([cbp_c[:1], cbp_c[:-1]], axis=0)
    tc_Tc = jnp.concatenate([tc_c[:, :wmb], tc_c[:, :-wmb]], axis=1)
    cbp_Tc = jnp.concatenate([cbp_c[:wmb], cbp_c[:-wmb]], axis=0)

    cols = []
    for blk in range(4):
        a_same, a_blk, b_same, b_blk = _CHROMA_NBR[blk]
        if a_same:
            nA = jnp.where((cbp_c & 2) != 0, tc_c[:, :, a_blk], 0)
            a_ok = jnp.ones(nmb, bool)
        else:
            nA = jnp.where((cbp_Lc & 2) != 0, tc_Lc[:, :, a_blk], 0)
            a_ok = ~left_edge
        if b_same:
            nB = jnp.where((cbp_c & 2) != 0, tc_c[:, :, b_blk], 0)
            b_ok = jnp.ones(nmb, bool)
        else:
            nB = jnp.where((cbp_Tc & 2) != 0, tc_Tc[:, :, b_blk], 0)
            b_ok = ~top_edge
            if top_ctx is not None:
                top_tc, top_cbp, top_valid = top_ctx
                pad_n = nmb - wmb
                halo_tc = jnp.concatenate(
                    [top_tc[:, :, b_blk],
                     jnp.zeros((2, pad_n), jnp.int32)], axis=1)
                halo_cbp = jnp.concatenate(
                    [top_cbp, jnp.zeros((pad_n,), top_cbp.dtype)])
                nB_halo = jnp.where((halo_cbp & 2) != 0, halo_tc, 0)
                nB = jnp.where(top_edge[None], nB_halo, nB)
                b_ok = b_ok | (top_edge & top_valid)
        nc = jnp.where(
            (a_ok & b_ok)[None], (nA + nB + 1) >> 1,
            jnp.where(a_ok[None], nA, jnp.where(b_ok[None], nB, 0)),
        )
        cols.append(nc)  # (2, nmb)
    return jnp.stack(cols, axis=-1)  # (2, nmb, 4)


def chroma_setup(cdc, cac, wmb: int, hmb: int, top_ctx=None):
    """Chroma-side entropy quantities, independent of the luma I4-vs-I16
    arbitration: cbp_chroma, final chroma TC state, nC contexts, per-MB
    exact chroma residual bit count, and the chroma symbol streams.

    cdc: (2, nmb, 4); cac: (2, nmb, 4, 15). top_ctx: optional chroma nC
    tile halo (top_tc_c (2, wmb, 4), top_cbp_c (wmb,), top_valid) — see
    _nc_chroma_grid.
    """
    nmb = wmb * hmb
    has_cdc = cdc.reshape(2, nmb, -1).any(axis=(0, 2))
    has_cac = cac.reshape(2, nmb, -1).any(axis=(0, 2))
    cbp_c = jnp.where(has_cac, 2, jnp.where(has_cdc, 1, 0))
    cdc_blk = block_symbols_bulk(cdc, 4)
    cac_blk = block_symbols_bulk(cac, 15)
    tc_chroma = jnp.where((cbp_c == 2)[None, :, None], cac_blk["tc"], 0)
    nc_c = _nc_chroma_grid(tc_chroma, cbp_c, wmb, hmb, top_ctx=top_ctx)
    cdc_vals, cdc_lens = finalize_symbols(
        cdc_blk, jnp.full((2, nmb), 4, jnp.int32))
    cac_vals, cac_lens = finalize_symbols(cac_blk, nc_to_ctx(nc_c))
    cdc_lens = jnp.where((cbp_c > 0)[None, :, None], cdc_lens, 0)
    cac_lens = jnp.where((cbp_c == 2)[None, :, None, None], cac_lens, 0)
    bits = cdc_lens.sum(axis=(0, 2)) + cac_lens.sum(axis=(0, 2, 3))
    return {
        "cbp_chroma": cbp_c,
        "tc_chroma": tc_chroma,
        "bits": bits,
        "cdc_vals": cdc_vals, "cdc_lens": cdc_lens,
        "cac_vals": cac_vals, "cac_lens": cac_lens,
    }


def mixed_slice_entropy_impl(choice4, mode16, cmode, i16dc, i16ac, lv4,
                             prev_flags, rem_modes, cbp_luma, tc_luma,
                             cdc, cac, wmb: int, hmb: int,
                             nw: int | None = None, cap: int | None = None,
                             top_ctx=None, valid=None):
    """Whole-slice macroblock_layer bits for a mixed I4x4/I16 frame.

    choice4/cbp_luma/tc_luma/prev_flags/rem_modes come from the
    arbitration wavefront (kernels/wavefront_mixed.py); level arrays hold
    both candidates' levels (the winner is selected here by `choice4`).
    Returns the same dict shape as i16_slice_entropy.

    top_ctx / valid: cross-tile nC context and uneven-band MB gating for
    MB-row-band sharding — the i16_slice_entropy contract: top_ctx is
    (top_tc_luma (wmb, 16), top_cbp_luma (wmb,), top_tc_chroma
    (2, wmb, 4), top_cbp_chroma (wmb,), top_valid).
    """
    nmb = wmb * hmb
    if top_ctx is not None:
        t_tc_l, t_cbp_l, t_tc_c, t_cbp_c, t_valid = top_ctx
        luma_top = (t_tc_l, t_cbp_l, t_valid)
        chroma_top = (t_tc_c, t_cbp_c, t_valid)
    else:
        luma_top = chroma_top = None
    ch = chroma_setup(cdc, cac, wmb, hmb, top_ctx=chroma_top)
    cbp_c = ch["cbp_chroma"]
    mbtype16 = 1 + mode16 + 4 * cbp_c + jnp.where(cbp_luma == 15, 12, 0)
    mb_type = jnp.where(choice4, 0, mbtype16)

    # luma blocks: symbols for both candidates, winner selected per MB
    dc_blk = block_symbols_bulk(i16dc, 16)
    ac_blk = block_symbols_bulk(i16ac, 15)
    l4_blk = block_symbols_bulk(lv4, 16)
    nc_l = _nc_luma_grid(tc_luma, tc_luma, cbp_luma, cbp_luma, wmb, hmb,
                         top_ctx=luma_top)
    dc_vals, dc_lens = finalize_symbols(dc_blk, nc_to_ctx(nc_l[:, 0]))
    ac_vals, ac_lens = finalize_symbols(ac_blk, nc_to_ctx(nc_l))
    l4_vals, l4_lens = finalize_symbols(l4_blk, nc_to_ctx(nc_l))
    dc_lens = jnp.where(choice4[:, None], 0, dc_lens)
    quad_gate = (
        ((cbp_luma[:, None] >> (jnp.arange(16) // 4)) & 1) != 0
    )  # (nmb, 16); for I16 winners cbp is 0 or 15 so this is the AC gate
    ac_lens = jnp.where(
        (~choice4[:, None] & quad_gate)[..., None], ac_lens, 0)
    l4_lens = jnp.where(
        (choice4[:, None] & quad_gate)[..., None], l4_lens, 0)
    # pad the 33-slot AC streams to the 35-slot I4 width and merge
    pad = ((0, 0), (0, 0), (0, l4_vals.shape[-1] - ac_vals.shape[-1]))
    ac_vals = jnp.pad(ac_vals, pad)
    ac_lens = jnp.pad(ac_lens, pad)
    luma_vals = jnp.where(choice4[:, None, None], l4_vals, ac_vals)
    luma_lens = jnp.where(choice4[:, None, None], l4_lens, ac_lens)

    # header: ue(mb_type); 16 pred-mode symbols (I4 only: flag=1 in 1 bit,
    # or flag 0 + 3-bit rem_mode fused into 4 bits); ue(chroma mode);
    # ue(CBP code, I4 only); se(0) mb_qp_delta when a residual follows
    h0v, h0l = ue_code(mb_type)
    pm_vals = jnp.where(prev_flags, 1, rem_modes)
    pm_lens = jnp.where(prev_flags, 1, 4) * choice4[:, None].astype(jnp.int32)
    h1v, h1l = ue_code(cmode)
    cbp_tab = jnp.asarray(T.CBP_TO_CODENUM_INTRA)
    cbp_code = cbp_tab[(cbp_c << 4) | jnp.where(choice4, cbp_luma, 0)]
    h2v, h2l = ue_code(cbp_code)
    h2l = jnp.where(choice4, h2l, 0)
    has_resid = ~choice4 | (cbp_luma > 0) | (cbp_c > 0)
    qdl = has_resid.astype(jnp.int32)
    vals = jnp.concatenate([
        h0v[:, None], pm_vals,
        h1v[:, None], h2v[:, None], jnp.ones((nmb, 1), jnp.int32),
        dc_vals,
        luma_vals.reshape(nmb, -1),
        jnp.moveaxis(ch["cdc_vals"], 1, 0).reshape(nmb, -1),
        jnp.moveaxis(ch["cac_vals"], 1, 0).reshape(nmb, -1),
    ], axis=-1)
    lens = jnp.concatenate([
        h0l[:, None], pm_lens,
        h1l[:, None], h2l[:, None], qdl[:, None],
        dc_lens,
        luma_lens.reshape(nmb, -1),
        jnp.moveaxis(ch["cdc_lens"], 1, 0).reshape(nmb, -1),
        jnp.moveaxis(ch["cac_lens"], 1, 0).reshape(nmb, -1),
    ], axis=-1)
    if valid is not None:
        lens = jnp.where(valid[:, None], lens, 0)
    words, nbits, pack_ok = pack_symbols(
        vals.reshape(-1), lens.reshape(-1), nw=nw, cap=cap)

    nz_luma = jnp.where(
        choice4[:, None], lv4.any(axis=-1),
        i16ac.any(axis=2) | i16dc.any(axis=1)[:, None])
    return {
        "words": words,
        "nbits": nbits,
        "pack_ok": pack_ok,
        # one-readback sync word: [nbits, pack_ok] — callers fetch this
        # single tiny array instead of two scalar readbacks
        "meta": jnp.stack([nbits, pack_ok.astype(jnp.int32)]),
        "mb_type": mb_type,
        "cbp_luma": cbp_luma,
        "cbp_chroma": cbp_c,
        "tc_luma": tc_luma,
        "tc_chroma": ch["tc_chroma"],
        "nz_luma": nz_luma,
    }


# jitted top-level entry; device programs embedding this call the _impl
# (see codec/device_intra.py on the jax-0.9 nested-jit const-lifting bug)
mixed_slice_entropy = functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "nw", "cap"))(
        mixed_slice_entropy_impl)


def p_slice_entropy_impl(skip, mb_type, mvd, luma_levels, cdc, cac,
                         wmb: int, hmb: int, nw: int | None = None,
                         cap: int | None = None, top_ctx=None,
                         run_ctx=None):
    """Whole-slice macroblock_layer bits for a P frame, on device.

    The P-slice analog of i16_slice_entropy covering the reference's
    inter syntax (rbsp_encoding.cpp:179-299): mb_skip_run run-lengths,
    ue(mb_type), sub_mb_types for P_8x8, se(mvd) per partition, the
    inter CBP mapping, and the CBP-gated residual blocks with
    neighbour-TotalCoeff nC (skip MBs contribute tc=0 through the
    cbp gating, matching encoder._nc_pair's MB_SKIP rule).

    skip: (nmb,) bool; mb_type: (nmb,) raw inter type 0..4 (ignored at
    skip MBs); mvd: (nmb, 4, 2) per-part mvds; luma_levels:
    (nmb, 16, 16) Z-scan; cdc: (2, nmb, 4); cac: (2, nmb, 4, 15) —
    levels must be zero at skip MBs.

    Returns dict: words, nbits, trail_bits (bits of the trailing
    mb_skip_run symbol — 0 when the slice ends on a coded MB; the host
    needs it for the decoder's trailing-skip-drop emulation), cbp_luma,
    cbp_chroma, tc_luma, tc_chroma, nz_luma.

    MB-row-band tile sharding (parallel/tile_p.py) passes:
      top_ctx — (top_tc_l (wmb, 16), top_cbp_l (wmb,), top_tc_c
        (2, wmb, 4), top_cbp_c (wmb,), top_valid): the band-above's
        last-row nC state;
      run_ctx — (lead_extra, emit_trailing, trail_total): the
        mb_skip_run chain across bands — lead_extra adds the preceding
        bands' trailing-skip count to this band's FIRST coded MB's run,
        and only the band holding the slice's last coded MB emits the
        trailing run symbol ue(trail_total).
    """
    nmb = wmb * hmb
    coded = ~skip
    idx = jnp.arange(nmb, dtype=jnp.int32)

    # mb_skip_run before each coded MB (exclusive running max of coded idx)
    marks = jnp.where(coded, idx, -1)
    inc = jax.lax.associative_scan(jnp.maximum, marks)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), inc[:-1]])
    run = idx - prev - 1
    last_coded = inc[-1]
    trail_run = nmb - 1 - last_coded  # 0 when the last MB is coded
    if run_ctx is not None:
        lead_extra, emit_trailing, trail_total = run_ctx
        first_coded = jnp.min(jnp.where(coded, idx, nmb))
        run = run + jnp.where(idx == first_coded, lead_extra, 0)
        trail_run = trail_total

    # CBP from levels (setCodedBlockPattern; levels zero at skip MBs)
    quad_any = luma_levels.reshape(nmb, 4, 64).any(axis=-1)  # Z-scan quads
    cbp_l = (quad_any.astype(jnp.int32)
             << jnp.arange(4, dtype=jnp.int32)).sum(axis=-1)
    if top_ctx is not None:
        t_tc_l, t_cbp_l, t_tc_c, t_cbp_c, t_valid = top_ctx
        luma_top = (t_tc_l, t_cbp_l, t_valid)
        chroma_top = (t_tc_c, t_cbp_c, t_valid)
    else:
        luma_top = chroma_top = None
    ch = chroma_setup(cdc, cac, wmb, hmb, top_ctx=chroma_top)
    cbp_c = ch["cbp_chroma"]

    # luma residual symbols: 16 blocks of maxNumCoeff 16 per MB
    lv_blk = block_symbols_bulk(luma_levels, 16)
    quad_gate = quad_any[:, :, None] & jnp.ones((1, 1, 4), bool)
    quad_gate = quad_gate.reshape(nmb, 16)  # per-block: its quad coded
    tc_luma = jnp.where(quad_gate, lv_blk["tc"], 0)
    nc_l = _nc_luma_grid(tc_luma, tc_luma, cbp_l, cbp_l, wmb, hmb,
                         top_ctx=luma_top)
    lv_vals, lv_lens = finalize_symbols(lv_blk, nc_to_ctx(nc_l))
    lv_lens = jnp.where(quad_gate[..., None], lv_lens, 0)

    # header symbols
    h_run_v, h_run_l = ue_code(run)
    h_t_v, h_t_l = ue_code(mb_type)
    sub_v = jnp.ones((nmb, 4), jnp.int32)
    sub_l = jnp.where((mb_type >= 3)[:, None], 1, 0) * jnp.ones(
        (nmb, 4), jnp.int32)
    nparts = jnp.asarray(np.array([1, 2, 2, 4, 4], np.int32))[
        jnp.clip(mb_type, 0, 4)]
    mvd_v, mvd_l = se_code(mvd.reshape(nmb, 8))
    part_ok = (jnp.arange(4)[None] < nparts[:, None])
    mvd_l = mvd_l * jnp.repeat(part_ok, 2, axis=1).astype(jnp.int32)
    cbp_tab = jnp.asarray(T.CBP_TO_CODENUM_INTER)
    h_c_v, h_c_l = ue_code(cbp_tab[(cbp_c << 4) | cbp_l])
    has_resid = (cbp_l > 0) | (cbp_c > 0)
    qdl = has_resid.astype(jnp.int32)

    vals = jnp.concatenate([
        h_run_v[:, None], h_t_v[:, None], sub_v, mvd_v,
        h_c_v[:, None], jnp.ones((nmb, 1), jnp.int32),
        lv_vals.reshape(nmb, -1),
        jnp.moveaxis(ch["cdc_vals"], 1, 0).reshape(nmb, -1),
        jnp.moveaxis(ch["cac_vals"], 1, 0).reshape(nmb, -1),
    ], axis=-1)
    lens = jnp.concatenate([
        h_run_l[:, None], h_t_l[:, None], sub_l, mvd_l,
        h_c_l[:, None], qdl[:, None],
        lv_lens.reshape(nmb, -1),
        jnp.moveaxis(ch["cdc_lens"], 1, 0).reshape(nmb, -1),
        jnp.moveaxis(ch["cac_lens"], 1, 0).reshape(nmb, -1),
    ], axis=-1)
    lens = jnp.where(coded[:, None], lens, 0)

    # trailing skip run (written when the slice ends on skips)
    t_v, t_l = ue_code(trail_run)
    t_l = jnp.where(trail_run > 0, t_l, 0)
    if run_ctx is not None:
        t_l = jnp.where(emit_trailing, t_l, 0)
    flat_v = jnp.concatenate([vals.reshape(-1), t_v[None]])
    flat_l = jnp.concatenate([lens.reshape(-1), t_l[None]])
    words, nbits, pack_ok = pack_symbols(flat_v, flat_l, nw=nw, cap=cap)

    return {
        "words": words,
        "nbits": nbits,
        "pack_ok": pack_ok,
        # one-readback sync word: [nbits, pack_ok, trail_bits] — callers
        # fetch this single tiny array instead of three scalar readbacks
        "meta": jnp.stack([nbits, pack_ok.astype(jnp.int32), t_l]),
        "trail_bits": t_l,
        "cbp_luma": cbp_l,
        "cbp_chroma": cbp_c,
        "tc_luma": tc_luma,
        "tc_chroma": ch["tc_chroma"],
        "nz_luma": luma_levels.any(axis=-1),
        "coded_blk": quad_gate,
    }


p_slice_entropy = functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "nw", "cap"))(p_slice_entropy_impl)


def i16_slice_entropy_impl(mode16, cmode, i16dc, i16ac, cdc, cac,
                           wmb: int, hmb: int, nw: int | None = None,
                           cap: int | None = None, top_ctx=None,
                           valid=None):
    """Whole-slice macroblock_layer bits for an all-I16 frame, on device.

    Returns dict: words (uint32 payload, bit 0 = first payload bit),
    nbits, mb_type, cbp_luma, cbp_chroma, tc_luma (nmb, 16),
    tc_chroma (2, nmb, 4) — the exact state the host writes back
    (matches native i16_frame_entropy).

    top_ctx: optional cross-tile nC context for MB-row-band sharding
    (parallel/tile.py): (top_tc_luma (wmb, 16), top_cbp_luma (wmb,),
    top_tc_chroma (2, wmb, 4), top_cbp_chroma (wmb,), top_valid bool).

    valid: optional (nmb,) bool — MBs with valid=False emit ZERO bits
    (uneven-band tile sharding pads the last band with rows below the
    real frame; padded MBs sit after every real MB in raster order, so
    gating their symbol lengths to 0 truncates the payload exactly at
    the last real MB).
    """
    nmb = wmb * hmb

    # CBP derivation (setCodedBlockPattern, rbsp_encoding.cpp:21-105)
    cbp_l = jnp.where(i16ac.reshape(nmb, -1).any(axis=-1), 15, 0)
    has_cdc = cdc.reshape(2, nmb, -1).any(axis=(0, 2))
    has_cac = cac.reshape(2, nmb, -1).any(axis=(0, 2))
    cbp_c = jnp.where(has_cac, 2, jnp.where(has_cdc, 1, 0))
    mb_type = 1 + mode16 + 4 * cbp_c + jnp.where(cbp_l == 15, 12, 0)

    # per-block CAVLC symbols (nC-independent parts), all blocks at once
    dc_blk = block_symbols_bulk(i16dc, 16)  # (nmb, ·)
    ac_blk = block_symbols_bulk(i16ac, 15)  # (nmb, 16, ·)
    cdc_blk = block_symbols_bulk(cdc, 4)  # (2, nmb, ·)
    cac_blk = block_symbols_bulk(cac, 15)  # (2, nmb, 4, ·)

    # final TC state (native writeback semantics: DC tc at blk 0 when the
    # AC blocks are not coded; zeros elsewhere)
    ac_tc = ac_blk["tc"]  # (nmb, 16)
    dc_tc = dc_blk["tc"]  # (nmb,)
    tc_luma = jnp.where(
        (cbp_l == 15)[:, None], ac_tc,
        jnp.concatenate(
            [dc_tc[:, None], jnp.zeros((nmb, 15), jnp.int32)], axis=-1
        ),
    )
    cac_tc = cac_blk["tc"]  # (2, nmb, 4)
    tc_chroma = jnp.where((cbp_c == 2)[None, :, None], cac_tc, 0)

    # nC resolution (cross-MB reads use the final state; in-MB chaining
    # uses the same arrays — identical here since every MB is I16)
    if top_ctx is not None:
        t_tc_l, t_cbp_l, t_tc_c, t_cbp_c, t_valid = top_ctx
        luma_top = (t_tc_l, t_cbp_l, t_valid)
        chroma_top = (t_tc_c, t_cbp_c, t_valid)
    else:
        luma_top = chroma_top = None
    nc_l = _nc_luma_grid(tc_luma, tc_luma, cbp_l, cbp_l, wmb, hmb,
                         top_ctx=luma_top)
    nc_c = _nc_chroma_grid(tc_chroma, cbp_c, wmb, hmb, top_ctx=chroma_top)

    # coeff_token contexts; the DC block uses the luma nC of block 0
    dc_vals, dc_lens = finalize_symbols(dc_blk, nc_to_ctx(nc_l[:, 0]))
    ac_vals, ac_lens = finalize_symbols(ac_blk, nc_to_ctx(nc_l))
    cdc_vals, cdc_lens = finalize_symbols(
        cdc_blk, jnp.full((2, nmb), 4, jnp.int32)
    )
    cac_vals, cac_lens = finalize_symbols(cac_blk, nc_to_ctx(nc_c))

    # emission gating
    ac_lens = jnp.where((cbp_l == 15)[:, None, None], ac_lens, 0)
    cdc_lens = jnp.where((cbp_c > 0)[None, :, None], cdc_lens, 0)
    cac_lens = jnp.where((cbp_c == 2)[None, :, None, None], cac_lens, 0)

    # header symbols: ue(mb_type), ue(chroma_mode), se(0) (=1 bit '1')
    h0v, h0l = ue_code(mb_type)
    h1v, h1l = ue_code(cmode)
    hdr_vals = jnp.stack([h0v, h1v, jnp.ones(nmb, jnp.int32)], axis=-1)
    hdr_lens = jnp.stack([h0l, h1l, jnp.ones(nmb, jnp.int32)], axis=-1)

    # per-MB symbol stream in macroblock_layer order:
    # header, I16DC, 16×AC, 2×chromaDC, 2×4 chromaAC
    vals = jnp.concatenate([
        hdr_vals,
        dc_vals,
        ac_vals.reshape(nmb, -1),
        jnp.moveaxis(cdc_vals, 1, 0).reshape(nmb, -1),
        jnp.moveaxis(cac_vals, 1, 0).reshape(nmb, -1),
    ], axis=-1)
    lens = jnp.concatenate([
        hdr_lens,
        dc_lens,
        ac_lens.reshape(nmb, -1),
        jnp.moveaxis(cdc_lens, 1, 0).reshape(nmb, -1),
        jnp.moveaxis(cac_lens, 1, 0).reshape(nmb, -1),
    ], axis=-1)
    if valid is not None:
        lens = jnp.where(valid[:, None], lens, 0)

    words, nbits, pack_ok = pack_symbols(
        vals.reshape(-1), lens.reshape(-1), nw=nw, cap=cap)
    return {
        "words": words,
        "nbits": nbits,
        "pack_ok": pack_ok,
        # one-readback sync word: [nbits, pack_ok] — callers fetch this
        # single tiny array instead of two scalar readbacks
        "meta": jnp.stack([nbits, pack_ok.astype(jnp.int32)]),
        "mb_type": mb_type,
        "cbp_luma": cbp_l,
        "cbp_chroma": cbp_c,
        "tc_luma": tc_luma,
        "tc_chroma": tc_chroma,
    }


# jitted top-level entry; device programs embedding this call the _impl
# (see codec/device_intra.py on the jax-0.9 nested-jit const-lifting bug)
i16_slice_entropy = functools.partial(
    jax.jit, static_argnames=("wmb", "hmb", "nw", "cap"))(
        i16_slice_entropy_impl)
