"""Fully-device I-frame encode: modes → wavefront recon → slice entropy.

One jitted program per frame geometry covering everything the reference's
I-frame hot loop does (rbsp_encoding.cpp:175-305): whole-frame Intra_16x16
mode decision (the exact-QP generalization of intra_kernels.cl:308-335),
exact 3-plane wavefront reconstruction, and the whole slice's
macroblock_layer bits packed on device (codec/device_entropy.py). The host
reads back only the packed payload (content-sized — hundreds of KB at
1080p, not the ~16 MB of level arrays the round-1 path moved) and inserts
emulation-prevention bytes; reconstruction and per-MB syntax state stay
device-resident for the next frame.

The ``*_impl`` variants are unjitted bodies for embedding inside larger
device programs (codec/device_gop.py, parallel/gop_device.py batched paths);
see codec/device_intra.py on the jax-0.9 nested-jit const-lifting bug that
makes calling the jitted entries from inside another jit unsafe.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..kernels.wavefront import wavefront_i16_frame_impl
from ..ops.intra import INTRA16_TO_CHROMA_MODE
from .device_entropy import i16_slice_entropy_impl
from .device_intra import intra_mode_decision_impl


def _deblock_intra(recon_y, recon_cb, recon_cr, nz_luma,
                   wmb: int, hmb: int, qp: int, qpc: int):
    """In-loop filter for an all-intra device frame (every edge bS 4/3;
    intra prediction already read the unfiltered samples per 8.3, so the
    filter applies once after the whole frame reconstructs)."""
    from ..kernels.deblock_device import deblock_frame_device_impl

    nmb = wmb * hmb
    return deblock_frame_device_impl(
        recon_y, recon_cb, recon_cr,
        jnp.ones((nmb,), bool), nz_luma,
        jnp.zeros((nmb, 4, 4, 2), jnp.int32),
        wmb=wmb, hmb=hmb, qp=qp, qpc=qpc)


def device_i16_frame_impl(y, cb, cr, wmb: int, hmb: int, qp: int, qpc: int,
                          nw: int | None = None, cap: int | None = None,
                          deblock: bool = False):
    """y/cb/cr: uint8 or int32 source planes (device). Returns dict with
    recon planes, entropy payload words/nbits, and per-MB syntax state.
    nw: static payload capacity in words (None = worst case); when
    nbits > 32*nw the payload is truncated — callers retry larger.
    deblock: apply the in-loop filter to the returned recon planes on
    device (the bitstream itself is unaffected — the filter is
    post-reconstruction; callers must signal it in PPS/slice headers)."""
    y = y.astype(jnp.int32)
    cb = cb.astype(jnp.int32)
    cr = cr.astype(jnp.int32)
    out = intra_mode_decision_impl(
        y, wmb=wmb, hmb=hmb, qp=qp, modes_only=True, i16_only=True)
    m16 = out["mode16"]
    cmode = jnp.asarray(INTRA16_TO_CHROMA_MODE)[m16]
    (recon_y, i16dc, i16ac, recon_cb, recon_cr, cdc, cac) = \
        wavefront_i16_frame_impl(y, cb, cr, m16, cmode,
                                 wmb=wmb, hmb=hmb, qp=qp, qpc=qpc)
    ent = i16_slice_entropy_impl(m16, cmode, i16dc, i16ac, cdc, cac,
                                 wmb=wmb, hmb=hmb, nw=nw, cap=cap)
    nz_luma = i16ac.any(axis=2) | i16dc.any(axis=1)[:, None]
    if deblock:
        recon_y, recon_cb, recon_cr = _deblock_intra(
            recon_y, recon_cb, recon_cr, nz_luma, wmb, hmb, qp, qpc)
    return {
        "recon_y": recon_y,
        "recon_cb": recon_cb,
        "recon_cr": recon_cr,
        "nz_luma": nz_luma,
        **ent,
    }


device_i16_frame = functools.partial(
    jax.jit,
    static_argnames=("wmb", "hmb", "qp", "qpc", "nw", "cap", "deblock"))(
        device_i16_frame_impl)


def device_mixed_frame_impl(y, cb, cr, wmb: int, hmb: int, qp: int,
                            qpc: int, nw: int | None = None,
                            cap: int | None = None,
                            deblock: bool = False):
    """Mixed-mode device I-frame: exact Intra_4x4-vs-Intra_16x16
    arbitration by coded bit size (kernels/wavefront_mixed.py), chroma
    wavefront, and the whole slice's bits packed on device. Byte-identical
    to the host encoder's exact path driven by the same pre-decided modes
    (the device_pipeline-assisted host path)."""
    from ..kernels.wavefront import wavefront_chroma_impl
    from ..kernels.wavefront_mixed import wavefront_mixed_luma_impl
    from .device_entropy import chroma_setup, mixed_slice_entropy_impl

    y = y.astype(jnp.int32)
    cb = cb.astype(jnp.int32)
    cr = cr.astype(jnp.int32)
    out = intra_mode_decision_impl(y, wmb=wmb, hmb=hmb, qp=qp,
                                   modes_only=True)
    m16 = out["mode16"]
    mode4 = out["mode4"]
    cmode = jnp.asarray(INTRA16_TO_CHROMA_MODE)[m16]
    recon_cb, recon_cr, cdc, cac = wavefront_chroma_impl(
        cb, cr, cmode, wmb=wmb, hmb=hmb, qp=qpc)
    ch = chroma_setup(cdc, cac, wmb, hmb)
    mx = wavefront_mixed_luma_impl(
        y, m16, mode4, cmode, ch["cbp_chroma"], ch["bits"],
        wmb=wmb, hmb=hmb, qp=qp)
    ent = mixed_slice_entropy_impl(
        mx["choice4"], m16, cmode, mx["i16dc"], mx["i16ac"], mx["lv4"],
        mx["prev_flags"], mx["rem_modes"], mx["cbp_luma"], mx["tc_luma"],
        cdc, cac, wmb=wmb, hmb=hmb, nw=nw, cap=cap)
    recon_y = mx["recon_y"]
    if deblock:
        recon_y, recon_cb, recon_cr = _deblock_intra(
            recon_y, recon_cb, recon_cr, ent["nz_luma"], wmb, hmb, qp, qpc)
    return {
        "recon_y": recon_y,
        "recon_cb": recon_cb,
        "recon_cr": recon_cr,
        "choice4": mx["choice4"],
        "i4x4_mode": mode4,
        **ent,
    }


device_mixed_frame = functools.partial(
    jax.jit,
    static_argnames=("wmb", "hmb", "qp", "qpc", "nw", "cap", "deblock"))(
        device_mixed_frame_impl)


@functools.partial(jax.jit, static_argnames=())
def frame_sad(a, b):
    """Whole-frame SAD for the scene-cut IDR decision on device
    (selectNALUnitType / subtractFramesCL analog)."""
    return jnp.abs(a.astype(jnp.int64) - b.astype(jnp.int64)).sum()
