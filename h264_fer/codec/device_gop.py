"""Whole-GOP device encode: IDR + P-frame chain in ONE jitted program.

The temporal axis of the codec (SURVEY.md §2.4 GOP row): an IDR-delimited
GOP is encoded end-to-end on device — frame 0 through the fully-device
I-frame program (codec/device_iframe.py) and every following P frame through
the fully-device P pipeline (codec/device_pframe.py) chained by a
``lax.scan`` whose carry is exactly the codec's cross-frame state: the
reconstructed reference planes (the depth-1 DPB, ref_frames.cpp:17-35)
and the previous frame's final MVs (the temporal qpel-refinement centers
of encoder._search_mb).

The host contributes only per-P-frame slice-header bit counts (known in
advance: frame_num/POC sequences are deterministic), which the scan needs
for the decoder's trailing-skip drop emulation — the one place slice
byte-alignment feeds back into reconstruction state (see
encoder._encode_slice). Streams stitched from the outputs are
byte-identical to the serial Encoder(device_iframe=True, device_pframe=True)
(tests/test_gop_device.py).

GOPs are mutually independent (encoder zeroes the MV field at IDR), so
parallel/gop_device.GopIpppEncoder shards a batch of GOPs over the
``gop`` mesh axis — data parallelism over the sequence dimension, the
codec analog of DP over batch (BASELINE.json config 5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def device_gop_ippp_impl(ys, cbs, crs, p_hdr_bits,
                         wmb: int, hmb: int, window: int, qp: int, qpc: int,
                         cfg_maxdiff: int, prefilter: bool,
                         nw_i: int | None = None, cap_i: int | None = None,
                         nw_p: int | None = None, cap_p: int | None = None):
    """ys/cbs/crs: (T, ...) uint8 planes, frame 0 is the IDR.
    p_hdr_bits: (T-1,) int32 slice-header bit counts of the P frames.
    Returns words_i/meta_i for the IDR and stacked words_p (T-1, nw_p) /
    meta_p (T-1, 3) for the P frames (meta = [nbits, pack_ok, trail_bits]).
    """
    from ..kernels.wavefront_p import pframe_decide_impl as pframe_decide
    from ..ops.interp import interpolated_planes_jax, pad_chroma_jax
    from .device_entropy import p_slice_entropy_impl as p_slice_entropy
    from .device_iframe import device_i16_frame_impl as device_i16_frame
    from .device_pframe import (
        adaptive_maxdiff,
        mc_chroma_bulk,
        mc_luma_bulk,
        pframe_maps,
        pframe_residual_recon,
    )

    nmb = wmb * hmb
    ext = window + 2
    ext_c = ext // 2 + 1

    i_out = device_i16_frame(ys[0], cbs[0], crs[0], wmb=wmb, hmb=hmb,
                             qp=qp, qpc=qpc, nw=nw_i, cap=cap_i)

    def body(carry, xs):
        ref_y, ref_cb, ref_cr, prev_mv = carry
        y, cb, cr, hdr_bits = xs
        src_y = y.astype(jnp.int32)
        src_cb = cb.astype(jnp.int32)
        src_cr = cr.astype(jnp.int32)

        planes = interpolated_planes_jax(ref_y, ext)
        maps = pframe_maps(src_y, planes, prev_mv, wmb, hmb, window, qp)
        maxdiff = adaptive_maxdiff(src_y, wmb, hmb, cfg_maxdiff)
        dec = pframe_decide(
            src_y, planes, maps["int_map"], maps["c1mv"], maps["q1map"],
            maps["c2mv"], maps["q2map"], maps["q2ok"], maxdiff,
            wmb=wmb, hmb=hmb, window=window, ext=ext,
            metric_id=maps["metric_id"], lam=maps["lam"])

        cb_pad = pad_chroma_jax(ref_cb, ext_c)
        cr_pad = pad_chroma_jax(ref_cr, ext_c)
        pred_y = mc_luma_bulk(planes, dec["mv"], ext, wmb, hmb)
        pred_cb = mc_chroma_bulk(cb_pad, dec["mv"], ext_c, wmb, hmb)
        pred_cr = mc_chroma_bulk(cr_pad, dec["mv"], ext_c, wmb, hmb)
        levels, recon_y, recon_cb, recon_cr = pframe_residual_recon(
            src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr, dec["skip"],
            maxdiff, wmb, hmb, qp, qpc, prefilter)
        ent = p_slice_entropy(
            dec["skip"], dec["mb_type"], dec["mvd"], levels["luma"],
            levels["cdc"], levels["cac"], wmb=wmb, hmb=hmb,
            nw=nw_p, cap=cap_p)

        # trailing-skip drop emulation (encoder._encode_slice /
        # _device_pframe_encode_full): when everything after the last
        # coded MB fits in the final RBSP byte, decoders never read the
        # trailing run — those MBs keep their previous-frame pixels and
        # MV state, which feeds the next frame's reference and centers.
        skip = dec["skip"]
        idx = jnp.arange(nmb)
        coded_any = (~skip).any()
        last_coded = jnp.max(jnp.where(~skip, idx, -1))
        trail_bits = ent["meta"][2]
        total_bits = hdr_bits + ent["nbits"]
        rbsp_len = (total_bits + 1 + 7) // 8  # + rbsp stop bit
        drop = ((trail_bits > 0) & coded_any
                & ((total_bits - trail_bits) // 8 >= rbsp_len - 1))
        mask_mb = (idx > last_coded) & drop  # the trailing skip run
        mpx = jnp.repeat(jnp.repeat(
            mask_mb.reshape(hmb, wmb), 16, axis=0), 16, axis=1)
        recon_y = jnp.where(mpx, ref_y, recon_y)
        mpc = mpx[::2, ::2]
        recon_cb = jnp.where(mpc, ref_cb, recon_cb)
        recon_cr = jnp.where(mpc, ref_cr, recon_cr)
        mv_final = jnp.where(mask_mb[:, None, None], prev_mv, dec["mv"])

        new_carry = (recon_y, recon_cb, recon_cr, mv_final)
        return new_carry, (ent["words"], ent["meta"])

    carry0 = (
        i_out["recon_y"],
        i_out["recon_cb"],
        i_out["recon_cr"],
        jnp.zeros((nmb, 4, 2), jnp.int32),
    )
    (fy, fcb, fcr, _), (words_p, meta_p) = jax.lax.scan(
        body, carry0,
        (ys[1:].astype(jnp.int32), cbs[1:].astype(jnp.int32),
         crs[1:].astype(jnp.int32), p_hdr_bits.astype(jnp.int32)))
    return {
        "words_i": i_out["words"],
        "meta_i": i_out["meta"],
        "words_p": words_p,
        "meta_p": meta_p,
        "recon_y": fy,
        "recon_cb": fcb,
        "recon_cr": fcr,
    }


# jitted top-level entry; the sharded batched path embeds the _impl
# (see codec/device_intra.py on the jax-0.9 nested-jit const-lifting bug)
device_gop_ippp = functools.partial(jax.jit, static_argnames=(
    "wmb", "hmb", "window", "qp", "qpc", "cfg_maxdiff", "prefilter",
    "nw_i", "cap_i", "nw_p", "cap_p"))(device_gop_ippp_impl)
