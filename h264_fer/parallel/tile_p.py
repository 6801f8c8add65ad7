"""MB-row tile parallelism for P frames: the full device P-frame pipeline
sharded across chips (SURVEY.md §2.4 tile row — "±(search range+pad)
reference windows" halo, the analog of moestimation.cpp:74-173 +
mocomp.cpp:80-107).

Each device owns a band of MB rows. Four dependencies cross the band
boundary, each riding a collective:

- **reference windows** (ME + MC): each band needs the previous frame's
  reconstructed planes ext(+taps) pixel rows beyond its band — one
  bulk ppermute of ext+4 luma / ext_c+2 chroma rows per frame, after
  which the band builds its interpolated planes locally
  (ops/interp.interpolated_planes_banded_jax — bit-identical to the
  full-frame planes' row window);
- **MV prediction chain**: the decision wavefront's left/top/top-right
  dependencies cross at the band's first row — a per-wave ppermute of
  the band-above's just-decided bottom-row (mv, mb_type) state
  (kernels/wavefront_p.pframe_decide_impl band mode);
- **CAVLC nC context**: the band-above's last-row TotalCoeff/CBP state —
  one ppermute before entropy (p_slice_entropy_impl top_ctx);
- **mb_skip_run chain**: skip runs flow across band boundaries — one
  all_gather of per-band (any_coded, last_coded) resolves every band's
  leading-run correction and elects the single band that emits the
  trailing run symbol (p_slice_entropy_impl run_ctx).

The host splices band payloads in order; streams are byte-identical to
the serial Encoder(device_iframe=True, device_pframe=True) IPPP encoder
(tests/test_tile_p.py).
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
from ..bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader
from ..codec.device_entropy import p_slice_entropy_impl
from ..ops import transform
from ..ops.cavlc_jax import words_to_bytes
from ..ops.interp import interpolated_planes_banded_jax
from .tile import _make_band


def _vhalo_exchange(plane, vh: int, axis: str, n_tile: int, t, edge_rep=True):
    """Build (hband + 2*vh, W) from a band plane: vh REAL rows from each
    neighbouring band via ppermute; frame edges replicate the band's own
    edge rows (matching the full-frame edge padding)."""
    fwd = [(i, i + 1) for i in range(n_tile - 1)]  # to next (their top)
    bwd = [(i + 1, i) for i in range(n_tile - 1)]  # to prev (their bottom)
    top = jax.lax.ppermute(plane[-vh:], axis, fwd)
    bot = jax.lax.ppermute(plane[:vh], axis, bwd)
    rep_top = jnp.broadcast_to(plane[:1], (vh,) + plane.shape[1:])
    rep_bot = jnp.broadcast_to(plane[-1:], (vh,) + plane.shape[1:])
    top = jnp.where(t > 0, top, rep_top)
    bot = jnp.where(t < n_tile - 1, bot, rep_bot)
    return jnp.concatenate([top, plane, bot], axis=0)


def _p_last_row_state(luma_levels, cdc, cac, wmb: int, hloc: int):
    """nC state (tc/cbp, luma + chroma) of the band's LAST MB row — the
    next band's entropy top context (p_slice_entropy_impl's own
    derivation restricted to one row; levels are zero at skip MBs)."""
    nmbl = wmb * hloc
    last = slice(nmbl - wmb, nmbl)
    lv = luma_levels[last]  # (wmb, 16, 16) Z-scan
    quad_any = lv.reshape(wmb, 4, 64).any(axis=-1)
    cbp_l = (quad_any.astype(jnp.int32)
             << jnp.arange(4, dtype=jnp.int32)).sum(axis=-1)
    quad_gate = (quad_any[:, :, None]
                 & jnp.ones((1, 1, 4), bool)).reshape(wmb, 16)
    tc_l = jnp.where(quad_gate, (lv != 0).sum(axis=-1), 0)
    cdcl = cdc[:, last]
    cacl = cac[:, last]
    has_cdc = cdcl.reshape(2, wmb, -1).any(axis=(0, 2))
    has_cac = cacl.reshape(2, wmb, -1).any(axis=(0, 2))
    cbp_c = jnp.where(has_cac, 2, jnp.where(has_cdc, 1, 0))
    tc_c = jnp.where((cbp_c == 2)[None, :, None],
                     (cacl != 0).sum(axis=-1), 0)
    return tc_l, cbp_l, tc_c, cbp_c


def _make_p_band(wmb: int, hmb: int, hloc: int, n_tile: int, window: int,
                 qp: int, qpc: int, cfg_maxdiff: int, prefilter: bool,
                 nw, cap, vary_axes: tuple = ()):
    """Per-band device P-frame encode step. Local inputs: source band
    planes, previous-frame reconstructed band planes, prev_mv band, and
    the slice-header bit count. Returns payload + per-band state +
    recon/mv bands (post trailing-skip drop)."""
    from ..codec.device_pframe import (
        adaptive_maxdiff,
        mc_chroma_bulk,
        mc_luma_bulk,
        pframe_maps,
        pframe_residual_recon,
    )
    from ..kernels.wavefront_p import pframe_decide_impl

    ext = window + 2
    ext_c = ext // 2 + 1
    nmbl = wmb * hloc
    nmb_total = wmb * hmb
    axes = tuple(vary_axes) or ("tile",)

    def band(y, cb, cr, ref_y, ref_cb, ref_cr, prev_mv, hdr_bits):
        t = jax.lax.axis_index("tile")
        base = t * nmbl  # global MB index of the band's first MB
        src_y = y.astype(jnp.int32)
        src_cb = cb.astype(jnp.int32)
        src_cr = cr.astype(jnp.int32)
        ref_y = ref_y.astype(jnp.int32)
        ref_cb = ref_cb.astype(jnp.int32)
        ref_cr = ref_cr.astype(jnp.int32)

        # ---- reference halos + local interp planes ---------------------
        ref_v = _vhalo_exchange(ref_y, ext + 4, "tile", n_tile, t)
        planes = interpolated_planes_banded_jax(ref_v, ext)
        cb_pad = jnp.pad(
            _vhalo_exchange(ref_cb, ext_c + 1, "tile", n_tile, t),
            ((0, 0), (ext_c + 1, ext_c + 1)), mode="edge")
        cr_pad = jnp.pad(
            _vhalo_exchange(ref_cr, ext_c + 1, "tile", n_tile, t),
            ((0, 0), (ext_c + 1, ext_c + 1)), mode="edge")

        # ---- bulk maps + banded decision wavefront ---------------------
        maps = pframe_maps(src_y, planes, prev_mv, wmb, hloc, window, qp)
        maxdiff = adaptive_maxdiff(src_y, wmb, hloc, cfg_maxdiff)
        dec = pframe_decide_impl(
            src_y, planes, maps["int_map"], maps["c1mv"], maps["q1map"],
            maps["c2mv"], maps["q2map"], maps["q2ok"], maxdiff,
            wmb=wmb, hmb=hloc, window=window, ext=ext,
            metric_id=maps["metric_id"], lam=maps["lam"],
            band=("tile", n_tile, hmb, axes))

        # ---- MC + residual + reconstruction ----------------------------
        pred_y = mc_luma_bulk(planes, dec["mv"], ext, wmb, hloc)
        pred_cb = mc_chroma_bulk(cb_pad, dec["mv"], ext_c, wmb, hloc)
        pred_cr = mc_chroma_bulk(cr_pad, dec["mv"], ext_c, wmb, hloc)
        levels, recon_y, recon_cb, recon_cr = pframe_residual_recon(
            src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr, dec["skip"],
            maxdiff, wmb, hloc, qp, qpc, prefilter)

        # ---- cross-band entropy context --------------------------------
        perm = [(i, i + 1) for i in range(n_tile - 1)]
        state = _p_last_row_state(levels["luma"], levels["cdc"],
                                  levels["cac"], wmb, hloc)
        t_tc_l, t_cbp_l, t_tc_c, t_cbp_c = jax.lax.ppermute(
            state, "tile", perm)

        # skip-run chain: gather (any_coded, last_coded) of every band
        coded = ~dec["skip"]
        idx = jnp.arange(nmbl, dtype=jnp.int32)
        any_coded = coded.any()
        local_last = jnp.max(jnp.where(coded, idx, -1))
        glast_local = jnp.where(any_coded, base + local_last, -1)
        all_glast = jax.lax.all_gather(glast_local, "tile")  # (n_tile,)
        tiles = jnp.arange(n_tile)
        prev_last = jnp.max(jnp.where(tiles < t, all_glast, -1))
        global_last = jnp.max(all_glast)
        # the band's local run already counts its own leading skips; the
        # correction is the distance from the global previous coded MB
        # to the band start
        lead_extra = base - prev_last - 1
        trail_total = jnp.where(global_last >= 0,
                                nmb_total - 1 - global_last, nmb_total)
        emit_trailing = jnp.where(
            global_last >= 0, any_coded & (glast_local == global_last),
            t == 0)

        ent = p_slice_entropy_impl(
            dec["skip"], dec["mb_type"], dec["mvd"], levels["luma"],
            levels["cdc"], levels["cac"], wmb=wmb, hmb=hloc,
            nw=nw, cap=cap,
            top_ctx=(t_tc_l, t_cbp_l, t_tc_c, t_cbp_c, t > 0),
            run_ctx=(lead_extra, emit_trailing, trail_total))

        # ---- trailing-skip drop emulation (cross-band) -----------------
        total_bits = hdr_bits + jax.lax.psum(ent["nbits"], "tile")
        trail_bits = jax.lax.psum(ent["trail_bits"], "tile")
        rbsp_len = (total_bits + 1 + 7) // 8
        drop = ((trail_bits > 0) & (global_last >= 0)
                & ((total_bits - trail_bits) // 8 >= rbsp_len - 1))
        gidx = base + idx
        mask_mb = (gidx > global_last) & drop
        mpx = jnp.repeat(jnp.repeat(
            mask_mb.reshape(hloc, wmb), 16, axis=0), 16, axis=1)
        recon_y = jnp.where(mpx, ref_y, recon_y)
        mpc = mpx[::2, ::2]
        recon_cb = jnp.where(mpc, ref_cb, recon_cb)
        recon_cr = jnp.where(mpc, ref_cr, recon_cr)
        mv_final = jnp.where(mask_mb[:, None, None], prev_mv, dec["mv"])

        return (ent["words"], ent["nbits"], ent["pack_ok"],
                recon_y, recon_cb, recon_cr, mv_final)

    return band


class TileIpppEncoder:
    """IPPP sequence encoder with EVERY frame's encode sharded over an
    MB-row ``tile`` mesh: the I-frame band program (parallel/tile.py) and
    the P-frame band program above, chained by band-resident recon + MV
    state. Streams are byte-identical to the serial
    ``Encoder(device_iframe=True, device_pframe=True, intra_every=gop_len,
    scene_cut_idr=False)`` (deblock off)."""

    def __init__(self, width: int, height: int, qp: int, gop_len: int,
                 window_size: int = 16, maxdiff: int = -1,
                 lossy_prefilter: bool = True, devices=None) -> None:
        assert width % 16 == 0 and height % 16 == 0
        assert gop_len >= 2
        self.w, self.h, self.qp, self.T = width, height, qp, gop_len
        self.wmb, self.hmb = width // 16, height // 16
        self.qpc = transform.chroma_qp(qp, 0)
        self.window = window_size // 2
        self.maxdiff = maxdiff
        self.prefilter = bool(lossy_prefilter and qp < 36)
        self.devices = list(devices) if devices is not None else jax.devices()
        n_tile = len(self.devices)
        assert self.hmb % n_tile == 0, \
            "P-frame banding needs an even row split (no uneven pad yet)"
        self.n_tile = n_tile
        self.hloc = self.hmb // n_tile
        self.mesh = Mesh(np.asarray(self.devices), ("tile",))
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp)
        self._cache = {}

    def headers(self) -> bytes:
        w = BitWriter()
        self.sps.write(w)
        w.rbsp_trailing_bits()
        out = nal_mod.write_nal_unit(1, nal_mod.NAL_SPS, w.getvalue())
        w = BitWriter()
        self.pps.write(w)
        w.rbsp_trailing_bits()
        return out + nal_mod.write_nal_unit(1, nal_mod.NAL_PPS, w.getvalue())

    def _i_program(self, nw, cap):
        key = ("i", nw, cap)
        if key not in self._cache:
            iband = _make_band(self.wmb, self.hmb, self.hloc, self.n_tile,
                               self.qp, self.qpc, nw, cap)

            def one(y, cb, cr):
                words, nbits, ok, ry, rcb, rcr = iband(y, cb, cr)
                return (words[None], nbits[None], ok[None],
                        ry[None], rcb[None], rcr[None])

            self._cache[key] = jax.jit(shard_map(
                one, mesh=self.mesh,
                in_specs=(P("tile", None),) * 3,
                out_specs=(P("tile", None), P("tile"), P("tile"),
                           P("tile", None), P("tile", None),
                           P("tile", None))))
        return self._cache[key]

    def _p_program(self, nw, cap):
        key = ("p", nw, cap)
        if key not in self._cache:
            pband = _make_p_band(
                self.wmb, self.hmb, self.hloc, self.n_tile, self.window,
                self.qp, self.qpc, self.maxdiff, self.prefilter, nw, cap)

            def one(y, cb, cr, ry, rcb, rcr, pmv, hdr_bits):
                outs = pband(y, cb, cr, ry[0], rcb[0], rcr[0], pmv[0],
                             hdr_bits)
                return tuple(o[None] for o in outs)

            self._cache[key] = jax.jit(shard_map(
                one, mesh=self.mesh,
                in_specs=(P("tile", None),) * 3
                + (P("tile"), P("tile"), P("tile"), P("tile"), None),
                out_specs=(P("tile", None), P("tile"), P("tile"),
                           P("tile"), P("tile"), P("tile"), P("tile"))))
        return self._cache[key]

    def encode_sequence(self, frames) -> bytes:
        nmb_band = self.wmb * self.hloc
        tiers = ((nmb_band * 24, 8), (nmb_band * 192, 24), (None, None))
        out = bytearray(self.headers())
        recon = None  # (ry, rcb, rcr) band-stacked device arrays
        pmv = None
        for i, (y, cb, cr) in enumerate(frames):
            j = i % self.T
            if j == 0:
                for nw, cap in tiers:
                    words, nbits, pok, ry, rcb, rcr = self._i_program(
                        nw, cap)(jnp.asarray(y), jnp.asarray(cb),
                                 jnp.asarray(cr))
                    nb = np.asarray(nbits)
                    if ((nw is None or int(nb.max()) <= 32 * nw)
                            and bool(np.asarray(pok).all())):
                        break
                shd = SliceHeader(
                    slice_type=I_SLICE, frame_num=0, idr_pic_id=0,
                    pic_order_cnt_lsb=0, slice_qp_delta=-14,
                    disable_deblocking_filter_idc=1)
                w = BitWriter()
                shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
                words_h = np.asarray(words)
                for tix in range(self.n_tile):
                    w.append_bits(
                        words_to_bytes(words_h[tix], int(nb[tix])),
                        int(nb[tix]))
                w.rbsp_trailing_bits()
                out += nal_mod.write_nal_unit(1, nal_mod.NAL_IDR,
                                              w.getvalue())
                recon = (ry.reshape(self.n_tile, self.hloc * 16, self.w),
                         rcb.reshape(self.n_tile, self.hloc * 8,
                                     self.w // 2),
                         rcr.reshape(self.n_tile, self.hloc * 8,
                                     self.w // 2))
                pmv = jnp.zeros((self.n_tile, nmb_band, 4, 2), jnp.int32)
            else:
                shd = SliceHeader(
                    slice_type=P_SLICE,
                    frame_num=j & (self.sps.max_frame_num - 1),
                    idr_pic_id=0,
                    pic_order_cnt_lsb=(2 * j) & (
                        (1 << self.sps.log2_max_pic_order_cnt_lsb) - 1),
                    slice_qp_delta=-14, disable_deblocking_filter_idc=1)
                w = BitWriter()
                shd.write(w, self.sps, self.pps, nal_mod.NAL_NOT_IDR, 1)
                hdr_bits = jnp.int32(w.bit_position)
                for nw, cap in tiers:
                    (words, nbits, pok, ry, rcb, rcr, mv) = \
                        self._p_program(nw, cap)(
                            jnp.asarray(y), jnp.asarray(cb),
                            jnp.asarray(cr), *recon, pmv, hdr_bits)
                    nb = np.asarray(nbits)
                    if ((nw is None or int(nb.max()) <= 32 * nw)
                            and bool(np.asarray(pok).all())):
                        break
                words_h = np.asarray(words)
                for tix in range(self.n_tile):
                    w.append_bits(
                        words_to_bytes(words_h[tix], int(nb[tix])),
                        int(nb[tix]))
                w.rbsp_trailing_bits()
                out += nal_mod.write_nal_unit(1, nal_mod.NAL_NOT_IDR,
                                              w.getvalue())
                recon = (ry, rcb, rcr)
                pmv = mv
        return bytes(out)


def _make_gop_band(wmb: int, hmb: int, hloc: int, n_tile: int, window: int,
                   qp: int, qpc: int, cfg_maxdiff: int, prefilter: bool,
                   nw, cap, vary_axes: tuple = ()):
    """Whole-GOP band program: banded I-frame + a lax.scan over the banded
    P-frame steps, carrying the band's DPB + MV state on device — the
    (gop, tile) composition of codec/device_gop.device_gop_ippp."""
    iband = _make_band(wmb, hmb, hloc, n_tile, qp, qpc, nw, cap,
                       vary_axes=vary_axes)
    pband = _make_p_band(wmb, hmb, hloc, n_tile, window, qp, qpc,
                         cfg_maxdiff, prefilter, nw, cap,
                         vary_axes=vary_axes)
    nmbl = wmb * hloc

    def gop(ys, cbs, crs, p_hdr_bits):
        # local band stacks: ys (T, hloc*16, W), p_hdr_bits (T-1,)
        iw, ib, iok, ry, rcb, rcr = iband(ys[0], cbs[0], crs[0])

        def body(carry, xs):
            ref_y, ref_cb, ref_cr, pmv = carry
            y, cb, cr, hdr_bits = xs
            (words, nbits, pok, ny, ncb, ncr, mv) = pband(
                y, cb, cr, ref_y, ref_cb, ref_cr, pmv, hdr_bits)
            return (ny, ncb, ncr, mv), (words, nbits, pok)

        pmv0 = jnp.zeros((nmbl, 4, 2), jnp.int32)
        # replicated zero init must be marked varying over the manual
        # mesh axes the scan body's collectives touch (scan-vma typing)
        pmv0 = jax.lax.pcast(pmv0, tuple(vary_axes) or ("tile",),
                             to="varying")
        carry0 = (ry.astype(jnp.int32), rcb.astype(jnp.int32),
                  rcr.astype(jnp.int32), pmv0)
        _, (wp, nbp, okp) = jax.lax.scan(
            body, carry0,
            (ys[1:].astype(jnp.int32), cbs[1:].astype(jnp.int32),
             crs[1:].astype(jnp.int32), p_hdr_bits.astype(jnp.int32)))
        return iw, ib, iok, wp, nbp, okp

    return gop


class GopTileIpppEncoder:
    """IPPP encoder over a 2-D ``(gop, tile)`` mesh: whole GOPs shard
    across the ``gop`` axis (each a device-resident I + scanned-P band
    program) while every frame's MB-row bands shard across ``tile`` with
    the full halo set (reference windows, MV chain, nC, skip runs)
    exchanged by collectives. Byte-identical to the serial device-path IPPP encoder."""

    def __init__(self, width: int, height: int, qp: int, gop_len: int,
                 n_gop: int, n_tile: int, window_size: int = 16,
                 maxdiff: int = -1, lossy_prefilter: bool = True,
                 devices=None) -> None:
        assert width % 16 == 0 and height % 16 == 0 and gop_len >= 2
        self.w, self.h, self.qp, self.T = width, height, qp, gop_len
        self.wmb, self.hmb = width // 16, height // 16
        self.qpc = transform.chroma_qp(qp, 0)
        self.window = window_size // 2
        self.maxdiff = maxdiff
        self.prefilter = bool(lossy_prefilter and qp < 36)
        devs = list(devices) if devices is not None else jax.devices()
        assert len(devs) >= n_gop * n_tile
        assert self.hmb % n_tile == 0
        self.n_gop, self.n_tile = n_gop, n_tile
        self.hloc = self.hmb // n_tile
        self.mesh = Mesh(
            np.asarray(devs[: n_gop * n_tile]).reshape(n_gop, n_tile),
            ("gop", "tile"))
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp)
        # deterministic P slice headers (see GopIpppEncoder)
        self._p_hdrs = []
        for j in range(1, gop_len):
            shd = SliceHeader(
                slice_type=P_SLICE,
                frame_num=j & (self.sps.max_frame_num - 1), idr_pic_id=0,
                pic_order_cnt_lsb=(2 * j) & (
                    (1 << self.sps.log2_max_pic_order_cnt_lsb) - 1),
                slice_qp_delta=-14, disable_deblocking_filter_idc=1)
            w = BitWriter()
            shd.write(w, self.sps, self.pps, nal_mod.NAL_NOT_IDR, 1)
            bits = w.bit_position
            if w.bit_position % 8:
                w.write(0, 8 - w.bit_position % 8)
            self._p_hdrs.append((w.getvalue(), bits))
        self._hdr_bits = np.asarray([b for _, b in self._p_hdrs], np.int32)
        self._cache = {}

    def headers(self) -> bytes:
        w = BitWriter()
        self.sps.write(w)
        w.rbsp_trailing_bits()
        out = nal_mod.write_nal_unit(1, nal_mod.NAL_SPS, w.getvalue())
        w = BitWriter()
        self.pps.write(w)
        w.rbsp_trailing_bits()
        return out + nal_mod.write_nal_unit(1, nal_mod.NAL_PPS, w.getvalue())

    def _program(self, nw, cap):
        if (nw, cap) in self._cache:
            return self._cache[nw, cap]
        gop = _make_gop_band(self.wmb, self.hmb, self.hloc, self.n_tile,
                             self.window, self.qp, self.qpc, self.maxdiff,
                             self.prefilter, nw, cap,
                             vary_axes=("gop", "tile"))

        def shard(ys, cbs, crs, hdr_bits):
            # local: (G_loc, T, hloc*16, W); vmap over the GOP batch
            outs = jax.vmap(gop, in_axes=(0, 0, 0, None))(
                ys, cbs, crs, hdr_bits)
            return jax.tree_util.tree_map(lambda x: x[:, None], outs)

        self._cache[nw, cap] = jax.jit(shard_map(
            shard, mesh=self.mesh,
            in_specs=(P("gop", None, "tile", None),) * 3 + (None,),
            out_specs=(P("gop", "tile"), P("gop", "tile"),
                       P("gop", "tile"), P("gop", "tile"),
                       P("gop", "tile"), P("gop", "tile"))))
        return self._cache[nw, cap]

    def encode_sequence(self, frames) -> bytes:
        b = len(frames)
        T = self.T
        fpad = (-b) % T
        padded = list(frames) + [frames[-1]] * fpad
        n_gop = len(padded) // T
        gpad = (-n_gop) % self.n_gop
        ys = np.stack([f[0] for f in padded]).reshape(
            n_gop, T, self.h, self.w)
        cbs = np.stack([f[1] for f in padded]).reshape(
            n_gop, T, self.h // 2, self.w // 2)
        crs = np.stack([f[2] for f in padded]).reshape(
            n_gop, T, self.h // 2, self.w // 2)
        if gpad:
            rep = lambda a: np.concatenate(  # noqa: E731
                [a, np.repeat(a[-1:], gpad, axis=0)])
            ys, cbs, crs = rep(ys), rep(cbs), rep(crs)
        hdr_bits = jnp.asarray(self._hdr_bits)
        nmb_band = self.wmb * self.hloc
        for nw, cap in ((nmb_band * 24, 8), (nmb_band * 192, 24),
                        (None, None)):
            iw, ib, iok, wp, nbp, okp = self._program(nw, cap)(
                jnp.asarray(ys), jnp.asarray(cbs), jnp.asarray(crs),
                hdr_bits)
            ib_h, nbp_h = np.asarray(ib), np.asarray(nbp)
            size_ok = nw is None or (
                int(ib_h.max()) <= 32 * nw
                and (nbp_h.size == 0 or int(nbp_h.max()) <= 32 * nw))
            if size_ok and bool(np.asarray(iok).all()) \
                    and bool(np.asarray(okp).all()):
                break
        iw_h, wp_h = np.asarray(iw), np.asarray(wp)
        out = bytearray(self.headers())
        for g in range(n_gop):
            for j in range(T):
                if g * T + j >= b:
                    break
                w = BitWriter()
                if j == 0:
                    shd = SliceHeader(
                        slice_type=I_SLICE, frame_num=0, idr_pic_id=0,
                        pic_order_cnt_lsb=0, slice_qp_delta=-14,
                        disable_deblocking_filter_idc=1)
                    shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
                    for tix in range(self.n_tile):
                        nb = int(ib_h[g, tix])
                        w.append_bits(words_to_bytes(iw_h[g, tix], nb), nb)
                    w.rbsp_trailing_bits()
                    out += nal_mod.write_nal_unit(
                        1, nal_mod.NAL_IDR, w.getvalue())
                else:
                    hdr_bytes, hb = self._p_hdrs[j - 1]
                    w.append_bits(hdr_bytes, hb)
                    for tix in range(self.n_tile):
                        nb = int(nbp_h[g, tix, j - 1])
                        w.append_bits(
                            words_to_bytes(wp_h[g, tix, j - 1], nb), nb)
                    w.rbsp_trailing_bits()
                    out += nal_mod.write_nal_unit(
                        1, nal_mod.NAL_NOT_IDR, w.getvalue())
        return bytes(out)
