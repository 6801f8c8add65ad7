"""MB-row tile parallelism: the full device I-frame encode sharded across
chips (SURVEY.md §2.4 tile row, §7 stage 8).

Each device owns a band of MB rows. The three loop-carried dependencies of
an H.264 intra frame cross the band boundary and each rides a collective:

- **mode decision** reads the source pixel row above the band — one
  ppermute before the wavefront (same halo as parallel/mesh.py);
- **wavefront reconstruction** reads the *reconstructed* bottom pixel row
  of the band above, which only materializes as that band's wavefront
  advances — so the bands run ONE GLOBAL wavefront together, and every
  wave step ppermutes the newly reconstructed bottom-row segment (16 luma
  + 2×8 chroma pixels) to the next band. Band t's first wave is t·rows
  steps in, i.e. the bands pipeline exactly like the reference's raster
  scan unrolled onto a diagonal (the codec analog of ring-attention's
  per-step neighbour exchange);
- **CAVLC nC context** needs the final TotalCoeff/CBP of the band-above's
  last MB row — one ppermute after the wavefront, feeding
  device_entropy.i16_slice_entropy's ``top_ctx``.

Each band then packs its own MBs' macroblock_layer bits on device
(MB raster order makes band payloads contiguous slice substreams), and the
host splices them bit-exactly in tile order: the stitched stream is
byte-identical to the single-device device_i16_frame path
(tests/test_tile.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitWriter
from ..bitstream.params import I_SLICE, PPS, SPS, SliceHeader
from ..codec.device_entropy import (
    chroma_setup,
    i16_slice_entropy_impl,
    mixed_slice_entropy_impl,
)
from ..codec.device_intra import intra_mode_decision_impl
from ..ops import intra, transform
from ..ops.cavlc_jax import words_to_bytes
from ..ops.intra import INTRA16_TO_CHROMA_MODE
from ..ops.tables import INTRA4X4_SCAN_ORDER_XY


def _banded_i16_wavefront(y, cb, cr, m16, cmode,
                          wmb: int, hloc: int, hmb: int,
                          qp: int, qpc: int, axis: str,
                          vary_axes: tuple = ()):
    """Fused luma+chroma I16 wavefront over one MB-row band, exchanging
    reconstructed boundary rows with the neighbouring bands per wave.

    y: (hloc*16, W) int32 band (the mode-decision source halo is handled
    by the caller). Runs the GLOBAL hmb+wmb-1 wave steps; local MBs activate when
    the global diagonal enters the band. Returns recon planes + levels,
    bit-identical to kernels/wavefront.wavefront_i16_frame on the full
    frame.
    """
    nmbl = wmb * hloc
    ndiag = hmb + wmb - 1
    dmax = hloc
    t = jax.lax.axis_index(axis)
    n_tile = hmb // hloc
    has_top = t > 0
    row0 = t * hloc  # global MB row of the band's first local row

    bxy = INTRA4X4_SCAN_ORDER_XY
    zx = bxy[:, 0] // 4
    zy = bxy[:, 1] // 4

    ysrc = y.reshape(hloc, 16, wmb, 16).transpose(0, 2, 1, 3)
    csrc = jnp.stack([
        cb.reshape(hloc, 8, wmb, 8).transpose(0, 2, 1, 3),
        cr.reshape(hloc, 8, wmb, 8).transpose(0, 2, 1, 3),
    ])  # (2, hloc, wmb, 8, 8)
    m16g = m16.reshape(hloc, wmb)
    cmg = cmode.reshape(hloc, wmb)
    slot = jnp.arange(dmax)
    perm = [(i, i + 1) for i in range(n_tile - 1)]

    def mb_blocks(mb):
        b = mb.reshape(*mb.shape[:-2], 2, 2, 4, 2, 2, 4)
        b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
        return b.reshape(*mb.shape[:-2], 16, 4, 4)

    def blocks_mb(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 2, 2, 4, 4)
        b = jnp.moveaxis(b, (-6, -5, -4, -3), (-6, -3, -5, -2))
        return b.reshape(*blocks.shape[:-3], 16, 16)

    def cblocks_of(mb):  # (..., 8, 8) -> (..., 4, 4, 4)
        b = mb.reshape(*mb.shape[:-2], 2, 4, 2, 4)
        b = jnp.moveaxis(b, -3, -2)
        return b.reshape(*mb.shape[:-2], 4, 4, 4)

    def cmb_of(blocks):
        b = blocks.reshape(*blocks.shape[:-3], 2, 2, 4, 4)
        b = jnp.moveaxis(b, -2, -3)
        return b.reshape(*blocks.shape[:-3], 8, 8)

    def step(d, carry):
        (recon, crecon, dc_out, ac_out, cdc_out, cac_out,
         halo_y, halo_c) = carry
        rs = slot  # local MB rows
        cs = d - row0 - slot  # global diagonal → local columns
        valid = (rs < hloc) & (cs >= 0) & (cs < wmb)
        rc = jnp.where(valid, rs, 0)
        cc = jnp.where(valid, cs, 0)
        rw = jnp.where(valid, rs, hloc)  # scratch row for invalid writes

        left_ok = (cc > 0) & valid
        top_in = (rc > 0) & valid  # top neighbour inside the band
        top_halo = (rc == 0) & has_top & valid  # top row via the ppermute halo
        top_ok = top_in | top_halo
        corner_ok = left_ok & top_ok
        rm1 = jnp.maximum(rc - 1, 0)
        cm1 = jnp.maximum(cc - 1, 0)

        # ---- luma neighbours: in-band recon or the exchanged halo row
        lcol = recon[rc, cm1, :, 15]
        trow_in = recon[rm1, cc, 15, :]
        trow = jnp.where(top_in[:, None], trow_in, halo_y[cc])
        corner_in = recon[rm1, cm1, 15, 15]
        corner = jnp.where(top_in, corner_in, halo_y[cm1, 15])
        lcol = jnp.where(left_ok[:, None], lcol, -1)
        trow = jnp.where(top_ok[:, None], trow, -1)
        corner = jnp.where(corner_ok, corner, -1)
        p33 = jnp.concatenate([corner[:, None], lcol, trow], axis=-1)

        m = m16g[rc, cc]
        preds = intra.predict_16x16_all_modes(p33)
        pred = jnp.take_along_axis(preds, m[None, :, None, None], axis=0)[0]
        srcs = ysrc[rc, cc]
        diff = mb_blocks(srcs - pred)
        q = transform.quantize_residual(
            transform.forward_transform_4x4(diff), qp, True)
        dc = jnp.zeros((dmax, 4, 4), jnp.int32)
        dc = dc.at[:, zy, zx].set(q[:, :, 0, 0])
        qdc = transform.forward_dc_luma(dc, qp)
        i16dc_list = transform.zigzag_scan(qdc)
        ac_list = transform.zigzag_scan(q)[:, :, 1:]
        dcv = transform.inverse_dc_luma(
            transform.zigzag_unscan(i16dc_list), qp)
        full = jnp.concatenate([dcv[:, zy, zx][..., None], ac_list], axis=-1)
        res = transform.inverse_residual(
            transform.zigzag_unscan(full), qp, True)
        out_y = jnp.clip(pred + blocks_mb(res), 0, 255)

        # ---- chroma (same diagonal; deps are left/top/corner only)
        clcol = jnp.where(
            left_ok[None, :, None],
            jnp.moveaxis(crecon[:, rc, cm1, :, 7], 0, 1), -1)
        ctrow_in = crecon[:, rm1, cc, 7, :]
        ctrow = jnp.where(top_in[None, :, None], ctrow_in, halo_c[:, cc])
        ctrow = jnp.where(top_ok[None, :, None], ctrow, -1)
        ccorner_in = crecon[:, rm1, cm1, 7, 7]
        ccorner = jnp.where(top_in[None], ccorner_in, halo_c[:, cm1, 7])
        ccorner = jnp.where(corner_ok[None], ccorner, -1)
        p17 = jnp.concatenate([ccorner[..., None], clcol, ctrow], axis=-1)

        cm = cmg[rc, cc]
        cpreds = intra.predict_chroma_all_modes(p17)
        cpred = jnp.take_along_axis(
            cpreds, cm[None, None, :, None, None], axis=0)[0]
        cdiff = cblocks_of(csrc[:, rc, cc] - cpred)
        cq = transform.quantize_residual(
            transform.forward_transform_4x4(cdiff), qpc, True)
        cdc2 = cq[..., 0, 0].reshape(2, dmax, 2, 2)
        cqdc = transform.forward_dc_chroma(cdc2, qpc)
        cdcv = transform.inverse_dc_chroma(cqdc, qpc)
        cac_list = transform.zigzag_scan(cq)[..., 1:]
        cfull = jnp.concatenate(
            [cdcv.reshape(2, dmax, 4)[..., None], cac_list], axis=-1)
        cres = transform.inverse_residual(
            transform.zigzag_unscan(cfull), qpc, True)
        out_c = jnp.clip(cpred + cmb_of(cres), 0, 255)

        # ---- state updates
        recon = recon.at[rw, cc].set(out_y)
        crecon = crecon.at[:, rw, cc].set(out_c)
        idx = jnp.where(valid, rc * wmb + cc, nmbl)
        dc_out = dc_out.at[idx].set(i16dc_list)
        ac_out = ac_out.at[idx].set(ac_list)
        cdc_out = cdc_out.at[:, idx].set(cqdc.reshape(2, dmax, 4))
        cac_out = cac_out.at[:, idx].set(cac_list)

        # ---- boundary exchange: the bottom-row MB just reconstructed
        # (local row hloc-1, global diagonal position) goes to tile t+1,
        # becoming its top halo for the SAME column one wave later.
        bcol = d - row0 - (hloc - 1)  # this wave's bottom-row column
        bvalid = (bcol >= 0) & (bcol < wmb)
        seg_y = out_y[hloc - 1, 15, :]  # (16,)
        seg_c = out_c[:, hloc - 1, 7, :]  # (2, 8)
        seg_y, seg_c = jax.lax.ppermute((seg_y, seg_c), axis, perm)
        # receiver: the sender's bottom row is OUR global row row0-1, so
        # the segment's column at wave d is d - (row0 - 1) = d - row0 + 1
        icol = d - row0 + 1
        ivalid = (icol >= 0) & (icol < wmb) & has_top
        ic = jnp.clip(icol, 0, wmb - 1)
        halo_y = halo_y.at[ic].set(
            jnp.where(ivalid, seg_y, halo_y[ic]))
        halo_c = halo_c.at[:, ic].set(
            jnp.where(ivalid, seg_c, halo_c[:, ic]))
        _ = bvalid  # sender-side validity is implied by the receiver's
        return (recon, crecon, dc_out, ac_out, cdc_out, cac_out,
                halo_y, halo_c)

    carry0 = (
        jnp.zeros((hloc + 1, wmb, 16, 16), jnp.int32),
        jnp.zeros((2, hloc + 1, wmb, 8, 8), jnp.int32),
        jnp.zeros((nmbl + 1, 16), jnp.int32),
        jnp.zeros((nmbl + 1, 16, 15), jnp.int32),
        jnp.zeros((2, nmbl + 1, 4), jnp.int32),
        jnp.zeros((2, nmbl + 1, 4, 15), jnp.int32),
        jnp.zeros((wmb, 16), jnp.int32),
        jnp.zeros((2, wmb, 8), jnp.int32),
    )
    # the loop body makes every carry component vary over the tile axis
    # (ppermute / axis_index) — and over every other manual mesh axis the
    # captured inputs are sharded on (e.g. "gop" in the 2-D program);
    # mark the replicated zeros accordingly
    axes = tuple(vary_axes) or (axis,)
    carry0 = jax.tree_util.tree_map(
        lambda x: jax.lax.pcast(x, axes, to="varying"), carry0)
    (recon, crecon, dc_out, ac_out, cdc_out, cac_out, _, _) = \
        jax.lax.fori_loop(0, ndiag, step, carry0)
    ry = recon[:hloc].transpose(0, 2, 1, 3).reshape(hloc * 16, wmb * 16)
    rcb = crecon[0, :hloc].transpose(0, 2, 1, 3).reshape(hloc * 8, wmb * 8)
    rcr = crecon[1, :hloc].transpose(0, 2, 1, 3).reshape(hloc * 8, wmb * 8)
    return (ry, rcb, rcr, dc_out[:nmbl], ac_out[:nmbl],
            cdc_out[:, :nmbl], cac_out[:, :nmbl])


def _band_state_last_row(i16dc, i16ac, cdc, cac, wmb: int, hloc: int):
    """Final TC/CBP state of the band's LAST MB row (the next band's nC
    top context; i16_slice_entropy writeback semantics)."""
    nmbl = wmb * hloc
    last = slice(nmbl - wmb, nmbl)
    acl = i16ac[last]  # (wmb, 16, 15)
    dcl = i16dc[last]  # (wmb, 16)
    cbp_l = jnp.where(acl.reshape(wmb, -1).any(axis=-1), 15, 0)
    ac_tc = (acl != 0).sum(axis=-1)
    dc_tc = (dcl != 0).sum(axis=-1)
    tc_l = jnp.where(
        (cbp_l == 15)[:, None], ac_tc,
        jnp.concatenate([dc_tc[:, None], jnp.zeros((wmb, 15), jnp.int32)],
                        axis=-1))
    cdcl = cdc[:, last]  # (2, wmb, 4)
    cacl = cac[:, last]  # (2, wmb, 4, 15)
    has_cdc = cdcl.reshape(2, wmb, -1).any(axis=(0, 2))
    has_cac = cacl.reshape(2, wmb, -1).any(axis=(0, 2))
    cbp_c = jnp.where(has_cac, 2, jnp.where(has_cdc, 1, 0))
    tc_c = jnp.where((cbp_c == 2)[None, :, None],
                     (cacl != 0).sum(axis=-1), 0)
    return tc_l, cbp_l, tc_c, cbp_c


def _chroma_state_last_row(cdc, cac, wmb: int, hloc: int):
    """Final chroma TC/CBP of the band's last MB row (the next band's
    chroma nC top context — chroma_setup writeback semantics)."""
    nmbl = wmb * hloc
    last = slice(nmbl - wmb, nmbl)
    cdcl = cdc[:, last]
    cacl = cac[:, last]
    has_cdc = cdcl.reshape(2, wmb, -1).any(axis=(0, 2))
    has_cac = cacl.reshape(2, wmb, -1).any(axis=(0, 2))
    cbp_c = jnp.where(has_cac, 2, jnp.where(has_cdc, 1, 0))
    tc_c = jnp.where((cbp_c == 2)[None, :, None],
                     (cacl != 0).sum(axis=-1), 0)
    return tc_c, cbp_c


def _make_band(wmb: int, hmb: int, hloc: int, n_tile: int, qp: int,
               qpc: int, nw, cap, vary_axes: tuple = (),
               hmb_real: int | None = None, mode: str = "i16"):
    """Per-band device I-frame encode step (one MB-row band of one frame):
    source-halo ppermute → mode decision → global banded wavefront →
    cross-band nC-context ppermute → per-band slice entropy. Collectives
    ride the ``tile`` mesh axis; shared by the 1-D tile and 2-D
    (gop, tile) programs.

    hmb_real: the frame's true MB rows when hmb is the padded row count
    of an uneven split (hmb = n_tile * hloc >= hmb_real); padded MBs are
    reconstructed (their outputs discarded) but emit zero payload bits.

    mode: "i16" or "mixed" — mixed runs the banded chroma wavefront,
    then the banded exact I4x4-vs-I16 arbitration wavefront
    (kernels/wavefront_mixed.py band mode: reconstructed-row, choice,
    TotalCoeff and CBP halos per wave, plus a static pre-exchanged
    bottom-row mode4 halo for the MPM derivation)."""
    perm = [(i, i + 1) for i in range(n_tile - 1)]
    uneven = hmb_real is not None and hmb_real != hmb
    if mode == "mixed":
        return _make_band_mixed(wmb, hmb, hloc, n_tile, qp, qpc, nw, cap,
                                vary_axes, hmb_real, perm)

    def band(y, cb, cr):
        # local shapes: y (hloc*16, W), cb/cr (hloc*8, W/2)
        y = y.astype(jnp.int32)
        cb = cb.astype(jnp.int32)
        cr = cr.astype(jnp.int32)
        t = jax.lax.axis_index("tile")
        # source top halo for the mode decision
        top_row = jax.lax.ppermute(y[-1], "tile", perm)
        top_row = jnp.where(t > 0, top_row, -1)
        md = intra_mode_decision_impl(y, wmb=wmb, hmb=hloc, qp=qp,
                                      top_row=top_row, modes_only=True,
                                      i16_only=True)
        m16 = md["mode16"]
        cmode = jnp.asarray(INTRA16_TO_CHROMA_MODE)[m16]
        (ry, rcb, rcr, i16dc, i16ac, cdc, cac) = _banded_i16_wavefront(
            y, cb, cr, m16, cmode,
            wmb=wmb, hloc=hloc, hmb=hmb, qp=qp, qpc=qpc, axis="tile",
            vary_axes=vary_axes)
        # cross-band nC context: last-row TC/CBP state to the next band
        state = _band_state_last_row(i16dc, i16ac, cdc, cac, wmb, hloc)
        t_tc_l, t_cbp_l, t_tc_c, t_cbp_c = jax.lax.ppermute(
            state, "tile", perm)
        valid = None
        if uneven:
            grow = t * hloc + jnp.arange(wmb * hloc) // wmb  # global MB row
            valid = grow < hmb_real
        ent = i16_slice_entropy_impl(
            m16, cmode, i16dc, i16ac, cdc, cac,
            wmb=wmb, hmb=hloc, nw=nw, cap=cap,
            top_ctx=(t_tc_l, t_cbp_l, t_tc_c, t_cbp_c, t > 0),
            valid=valid)
        return (ent["words"], ent["nbits"], ent["pack_ok"], ry, rcb, rcr)

    return band


def _make_band_mixed(wmb: int, hmb: int, hloc: int, n_tile: int, qp: int,
                     qpc: int, nw, cap, vary_axes: tuple,
                     hmb_real: int | None, perm):
    uneven = hmb_real is not None and hmb_real != hmb
    from ..kernels.wavefront import wavefront_chroma_impl
    from ..kernels.wavefront_mixed import wavefront_mixed_luma_impl

    def band(y, cb, cr):
        y = y.astype(jnp.int32)
        cb = cb.astype(jnp.int32)
        cr = cr.astype(jnp.int32)
        t = jax.lax.axis_index("tile")
        has_top = t > 0
        bspec = ("tile", n_tile, hmb, tuple(vary_axes))
        # source top halo for the mode decision (I16 + I4x4 SATD both
        # read the pre-decision SOURCE row above, like the GPU fast path)
        top_row = jax.lax.ppermute(y[-1], "tile", perm)
        top_row = jnp.where(has_top, top_row, -1)
        md = intra_mode_decision_impl(y, wmb=wmb, hmb=hloc, qp=qp,
                                      top_row=top_row, modes_only=True)
        m16 = md["mode16"]
        mode4 = md["mode4"]
        cmode = jnp.asarray(INTRA16_TO_CHROMA_MODE)[m16]
        # banded chroma wavefront (recon-row halos per wave)
        rcb8, rcr8, cdc, cac = wavefront_chroma_impl(
            cb, cr, cmode, wmb=wmb, hmb=hloc, qp=qpc, band=bspec)
        # chroma nC context from the band above (chroma_setup feeds the
        # arbitration's exact chroma bit counts)
        t_tc_c, t_cbp_c = jax.lax.ppermute(
            _chroma_state_last_row(cdc, cac, wmb, hloc), "tile", perm)
        ch = chroma_setup(cdc, cac, wmb, hloc,
                          top_ctx=(t_tc_c, t_cbp_c, has_top))
        # static mode4 halo: the band above's last-row pre-decided modes
        hm4 = jax.lax.ppermute(
            mode4.reshape(hloc, wmb, 16)[-1], "tile", perm)
        mx = wavefront_mixed_luma_impl(
            y, m16, mode4, cmode, ch["cbp_chroma"], ch["bits"],
            wmb=wmb, hmb=hloc, qp=qp, band=bspec, m4_halo=hm4)
        # luma nC context for the entropy stage: the band's final
        # last-row TotalCoeff/CBP state (identical to the per-wave halo)
        nmbl = wmb * hloc
        last = slice(nmbl - wmb, nmbl)
        t_tc_l, t_cbp_l = jax.lax.ppermute(
            (mx["tc_luma"][last], mx["cbp_luma"][last]), "tile", perm)
        valid = None
        if uneven:
            grow = t * hloc + jnp.arange(nmbl) // wmb
            valid = grow < hmb_real
        ent = mixed_slice_entropy_impl(
            mx["choice4"], m16, cmode, mx["i16dc"], mx["i16ac"],
            mx["lv4"], mx["prev_flags"], mx["rem_modes"],
            mx["cbp_luma"], mx["tc_luma"], cdc, cac,
            wmb=wmb, hmb=hloc, nw=nw, cap=cap,
            top_ctx=(t_tc_l, t_cbp_l, t_tc_c, t_cbp_c, has_top),
            valid=valid)
        return (ent["words"], ent["nbits"], ent["pack_ok"],
                mx["recon_y"], rcb8, rcr8)

    return band


class TileIntraEncoder:
    """All-intra encoder with each frame's encode sharded over an MB-row
    ``tile`` mesh: mode decision, wavefront reconstruction, and per-band
    CAVLC packing all on device, cross-band context via collectives; the host
    splices band payloads + EPB. Streams are byte-identical to the
    single-device device_i16_frame path."""

    def __init__(self, width: int, height: int, qp: int,
                 devices=None, mode: str = "i16") -> None:
        assert width % 16 == 0 and height % 16 == 0
        self.w, self.h, self.qp = width, height, qp
        self.mode = mode
        self.wmb, self.hmb = width // 16, height // 16
        self.qpc = transform.chroma_qp(qp, 0)
        self.devices = list(devices) if devices is not None else jax.devices()
        n_tile = len(self.devices)
        self.n_tile = n_tile
        # uneven split: pad the frame to n_tile*hloc MB rows (edge
        # replication); padded MBs emit zero payload bits
        self.hloc = -(-self.hmb // n_tile)
        self.hmb_pad = self.hloc * n_tile
        self.mesh = Mesh(np.asarray(self.devices), ("tile",))
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp)
        self.idr_pic_id = -1
        self._cache = {}

    def _program(self, nw, cap):
        if (nw, cap) in self._cache:
            return self._cache[nw, cap]
        band = _make_band(self.wmb, self.hmb_pad, self.hloc, self.n_tile,
                          self.qp, self.qpc, nw, cap,
                          hmb_real=self.hmb, mode=self.mode)

        def one(y, cb, cr):
            ent_words, ent_nbits, ent_ok, ry, rcb, rcr = band(y, cb, cr)
            return (ent_words[None], ent_nbits[None], ent_ok[None],
                    ry[None], rcb[None], rcr[None])

        fn = shard_map(
            one, mesh=self.mesh,
            in_specs=(P("tile", None), P("tile", None), P("tile", None)),
            out_specs=(P("tile", None), P("tile"), P("tile"),
                       P("tile", None), P("tile", None), P("tile", None)),
        )
        self._cache[nw, cap] = jax.jit(fn)
        return self._cache[nw, cap]

    def headers(self) -> bytes:
        w = BitWriter()
        self.sps.write(w)
        w.rbsp_trailing_bits()
        out = nal_mod.write_nal_unit(1, nal_mod.NAL_SPS, w.getvalue())
        w = BitWriter()
        self.pps.write(w)
        w.rbsp_trailing_bits()
        return out + nal_mod.write_nal_unit(1, nal_mod.NAL_PPS, w.getvalue())

    def _pad_rows(self, p, rows):
        pad = rows - p.shape[0]
        return p if pad == 0 else np.concatenate(
            [p, np.repeat(p[-1:], pad, axis=0)])

    def encode_frame(self, y, cb, cr) -> bytes:
        nmb_band = self.wmb * self.hloc
        y = self._pad_rows(np.asarray(y), self.hmb_pad * 16)
        cb = self._pad_rows(np.asarray(cb), self.hmb_pad * 8)
        cr = self._pad_rows(np.asarray(cr), self.hmb_pad * 8)
        for nw, cap in ((nmb_band * 24, 8), (nmb_band * 192, 24),
                        (None, None)):
            words, nbits, pok, ry, rcb, rcr = self._program(nw, cap)(
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
            nbits_h = np.asarray(nbits)
            if ((nw is None or int(nbits_h.max()) <= 32 * nw)
                    and bool(np.asarray(pok).all())):
                break
        words_h = np.asarray(words)
        hp, w2 = self.hmb_pad * 16, self.w
        self.recon = (
            np.asarray(ry).reshape(hp, w2)[: self.h],
            np.asarray(rcb).reshape(hp // 2, w2 // 2)[: self.h // 2],
            np.asarray(rcr).reshape(hp // 2, w2 // 2)[: self.h // 2])
        self.idr_pic_id += 1
        shd = SliceHeader(
            slice_type=I_SLICE, frame_num=0,
            idr_pic_id=self.idr_pic_id, pic_order_cnt_lsb=0,
            slice_qp_delta=-14, disable_deblocking_filter_idc=1)
        w = BitWriter()
        shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
        for tix in range(self.n_tile):  # band payloads are contiguous
            w.append_bits(words_to_bytes(words_h[tix], int(nbits_h[tix])),
                          int(nbits_h[tix]))
        w.rbsp_trailing_bits()
        return nal_mod.write_nal_unit(1, nal_mod.NAL_IDR, w.getvalue())

    def encode_sequence(self, frames) -> bytes:
        out = bytearray(self.headers())
        for y, cb, cr in frames:
            out += self.encode_frame(y, cb, cr)
        return bytes(out)


class GopTileIntraEncoder:
    """All-intra encoder over a 2-D ``(gop, tile)`` device mesh — the full
    BASELINE.json config-4+5 composition in ONE jitted program: frames
    shard across the ``gop`` axis (data parallelism over IDR frames) and
    each frame's MB-row bands shard across the ``tile`` axis (spatial
    parallelism with per-wave reconstructed-row + nC-context ppermute
    halos via ppermute). The host stitches NALs frame-major, band-minor;
    streams are byte-identical to the serial device path."""

    def __init__(self, width: int, height: int, qp: int,
                 n_gop: int, n_tile: int, devices=None,
                 mode: str = "i16") -> None:
        assert width % 16 == 0 and height % 16 == 0
        self.w, self.h, self.qp = width, height, qp
        self.mode = mode
        self.wmb, self.hmb = width // 16, height // 16
        self.qpc = transform.chroma_qp(qp, 0)
        devs = list(devices) if devices is not None else jax.devices()
        assert len(devs) >= n_gop * n_tile
        self.n_gop, self.n_tile = n_gop, n_tile
        self.hloc = -(-self.hmb // n_tile)  # uneven: pad the last band
        self.hmb_pad = self.hloc * n_tile
        self.mesh = Mesh(
            np.asarray(devs[: n_gop * n_tile]).reshape(n_gop, n_tile),
            ("gop", "tile"))
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp)
        self._cache = {}

    def _program(self, nw, cap):
        if (nw, cap) in self._cache:
            return self._cache[nw, cap]
        band = _make_band(self.wmb, self.hmb_pad, self.hloc, self.n_tile,
                          self.qp, self.qpc, nw, cap,
                          vary_axes=("gop", "tile"), hmb_real=self.hmb,
                          mode=self.mode)

        def shard(y, cb, cr):
            # local: y (B/n_gop, hloc*16, W) — vmap the band step over the
            # local frame batch; 'tile' collectives apply per mesh row
            outs = jax.vmap(band)(y, cb, cr)
            return jax.tree_util.tree_map(lambda x: x[:, None], outs)

        fn = shard_map(
            shard, mesh=self.mesh,
            in_specs=(P("gop", "tile", None),) * 3,
            out_specs=(P("gop", "tile", None), P("gop", "tile"),
                       P("gop", "tile"), P("gop", "tile", None),
                       P("gop", "tile", None), P("gop", "tile", None)),
        )
        self._cache[nw, cap] = jax.jit(fn)
        return self._cache[nw, cap]

    def headers(self) -> bytes:
        w = BitWriter()
        self.sps.write(w)
        w.rbsp_trailing_bits()
        out = nal_mod.write_nal_unit(1, nal_mod.NAL_SPS, w.getvalue())
        w = BitWriter()
        self.pps.write(w)
        w.rbsp_trailing_bits()
        return out + nal_mod.write_nal_unit(1, nal_mod.NAL_PPS, w.getvalue())

    def encode_sequence(self, frames) -> bytes:
        b = len(frames)
        pad = (-b) % self.n_gop  # shard evenly; padded frames discarded
        # (B, H, W): dim 0 shards over gop, dim 1 (pixel rows) over tile
        ys = np.stack([f[0] for f in frames] + [frames[-1][0]] * pad)
        cbs = np.stack([f[1] for f in frames] + [frames[-1][1]] * pad)
        crs = np.stack([f[2] for f in frames] + [frames[-1][2]] * pad)
        if self.hmb_pad != self.hmb:  # uneven bands: edge-replicate rows
            rep = lambda a, rows: np.concatenate(  # noqa: E731
                [a, np.repeat(a[:, -1:], rows - a.shape[1], axis=1)], axis=1)
            ys = rep(ys, self.hmb_pad * 16)
            cbs = rep(cbs, self.hmb_pad * 8)
            crs = rep(crs, self.hmb_pad * 8)
        nmb_band = self.wmb * self.hloc
        for nw, cap in ((nmb_band * 24, 8), (nmb_band * 192, 24),
                        (None, None)):
            words, nbits, pok, _, _, _ = self._program(nw, cap)(
                jnp.asarray(ys), jnp.asarray(cbs), jnp.asarray(crs))
            nbits_h = np.asarray(nbits)
            if ((nw is None or int(nbits_h.max()) <= 32 * nw)
                    and bool(np.asarray(pok).all())):
                break
        words_h = np.asarray(words)
        out = bytearray(self.headers())
        for i in range(b):  # frame-major, band-minor ordered stitch
            shd = SliceHeader(
                slice_type=I_SLICE, frame_num=0, idr_pic_id=i,
                pic_order_cnt_lsb=0, slice_qp_delta=-14,
                disable_deblocking_filter_idc=1)
            w = BitWriter()
            shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
            for tix in range(self.n_tile):
                w.append_bits(
                    words_to_bytes(words_h[i, tix], int(nbits_h[i, tix])),
                    int(nbits_h[i, tix]))
            w.rbsp_trailing_bits()
            out += nal_mod.write_nal_unit(1, nal_mod.NAL_IDR, w.getvalue())
        return bytes(out)
