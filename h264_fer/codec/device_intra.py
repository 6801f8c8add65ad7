"""Device whole-frame intra pipeline (jitted JAX).

The generalization of the reference's GPU offload (intra_kernels.cl:308-708:
one work-item per MB / per 4x4 block, modes decided on the *source* frame as
an accepted approximation, thesis-measured +0.18–1.01 % bitrate) — except we
evaluate SATD at the *actual* QP instead of the reference's hardcoded qp=12
(openCL_functions.cpp:238), which strictly improves its decisions.

Everything here is batched over all MBs of a frame and jit-compiled once per
frame geometry:
  - Intra16x16: all 4 modes × all MBs, SATD argmin with availability gating
  - Intra4x4:   all 9 modes × all 16 blocks × all MBs
  - forward transform + quantization of the winning I16 predictions
  - per-MB SATD totals for the 4x4-vs-16x16 pre-choice

The host encoder (codec/encoder.py, given a DeviceIntraPipeline) consumes
the decided modes and runs the exact reconstruction + CAVLC; the
fully-device I-frame path (codec/device_iframe.py) reuses the mode
decision ahead of its wavefront reconstruction and slice entropy.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import intra, transform


def _mb_blocks(x):
    """(..., 16, 16) MB images → (..., 16, 4, 4) 4x4 blocks in Z-scan order.

    Z-scan: quadrant-major (Intra4x4ScanOrder, h264_globals.cpp:209-214).
    """
    *lead, H, W = x.shape
    assert H == 16 and W == 16
    # (..., qr, 2, 4, qc, 2, 4): quadrant row, sub row, y, quadrant col, ...
    b = x.reshape(*lead, 2, 2, 4, 2, 2, 4)
    # order: quadrant (qr, qc), then sub-block (sr, sc)
    b = jnp.moveaxis(b, (-6, -3, -5, -2), (-6, -5, -4, -3))
    return b.reshape(*lead, 16, 4, 4)


def _satd_blocks(diff_blocks, qp: int):
    """Σ|quantized transformed diff| per block (satdLuma4x4, intra.cpp:819)."""
    d = transform.forward_transform_4x4(diff_blocks)
    q = transform.quantize_residual(d, qp, False)
    return jnp.abs(q).sum(axis=(-2, -1))


def intra_mode_decision_impl(y, wmb: int, hmb: int, qp: int, top_row=None,
                             modes_only: bool = False,
                             frame_hmb: int | None = None,
                             i16_only: bool = False):
    """Whole-frame intra mode pre-decision on the source frame.

    y: (H, W) int32 luma. `top_row`: optional (W,) int32 halo — the last
    pixel row of the MB-row tile above (for sharded tiles; -1 entries mean
    unavailable). Returns dict with per-MB i16 modes, per-block i4x4 modes,
    and their SATD totals.
    """
    nmb = wmb * hmb
    fh = frame_hmb if frame_hmb is not None else hmb
    assert hmb % fh == 0
    # pad with -1 (or the tile halo) on top, -1 on left/right
    if top_row is None:
        yp = jnp.pad(y, ((1, 0), (1, 4)), constant_values=-1)
    else:
        yp = jnp.concatenate([top_row[None, :], y], axis=0)
        yp = jnp.pad(yp, ((0, 0), (1, 4)), constant_values=-1)

    # MB source blocks: (nmb, 16, 16)
    src = y.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3).reshape(nmb, 16, 16)

    # --- Intra16x16 p33 for every MB (pure strided slicing, no gathers) ---
    H, W = hmb * 16, wmb * 16
    corner = yp[0 : H : 16, 0 : W : 16]  # (hmb, wmb) at (-1,-1) of each MB
    # left columns: rows 1..H of the MB-origin columns
    lefts = yp[1 : H + 1, 0 : W : 16].reshape(hmb, 16, wmb).transpose(0, 2, 1)
    # top rows: MB-origin rows, cols 1..W
    tops = yp[0 : H : 16, 1 : W + 1].reshape(hmb, wmb, 16)
    if fh != hmb:
        # frame-stack boundaries: rows k*fh have no top neighbor
        fedge = (jnp.arange(hmb) % fh) == 0
        tops = jnp.where(fedge[:, None, None], -1, tops)
        corner = jnp.where(fedge[:, None], -1, corner)
    p33 = jnp.concatenate(
        [corner[..., None], lefts, tops], axis=-1
    ).reshape(nmb, 33)

    preds16 = intra.predict_16x16_all_modes(p33)  # (4, nmb, 16, 16)
    diffs = _mb_blocks(src[None] - preds16)  # (4, nmb, 16, 4, 4)
    satd16 = _satd_blocks(diffs, qp).sum(axis=-1)  # (4, nmb)

    mbr = jnp.arange(nmb) // wmb
    mbc = jnp.arange(nmb) % wmb
    # availability from fetched samples (handles the tile halo uniformly)
    top_ok = tops[..., 0].reshape(nmb) != -1
    left_ok = lefts[..., 0].reshape(nmb) != -1
    corner_ok = corner.reshape(nmb) != -1
    BIG = jnp.int32(1 << 30)
    gate16 = jnp.stack([
        jnp.where(top_ok, 0, BIG),     # V
        jnp.where(left_ok, 0, BIG),    # H
        jnp.zeros(nmb, jnp.int32),     # DC
        jnp.where(corner_ok, 0, BIG),  # Plane
    ])
    satd16g = satd16 + gate16
    mode16 = jnp.argmin(satd16g, axis=0)  # (nmb,)
    best16_satd = satd16g.min(axis=0)

    if i16_only:
        # the all-device I16 path needs no Intra_4x4 trial at all
        return {"mode16": mode16, "satd16": best16_satd}

    # --- Intra4x4 p13 for every block of every MB ------------------------
    # Constructed from strided slices over the global 4x4-block grid
    # (HB x WB blocks, raster order), then permuted raster→Z per MB.
    from ..ops.tables import INTRA4X4_SCAN_ORDER_XY, RASTER_TO_LUMA_BLOCK

    HB, WB = hmb * 4, wmb * 4
    # corner: pixel (-1,-1) of each block = yp[4R, 4C]
    corner_g = yp[0 : H : 4, 0 : W : 4]  # (HB, WB)
    # left column: pixels (4C-1, 4R+i), i=0..3 = yp[4R+1+i, 4C]
    left_g = yp[1 : H + 1, 0 : W : 4].reshape(HB, 4, WB).transpose(0, 2, 1)
    # top row + above-right: pixels (4C+j, 4R-1), j=0..7 = yp[4R, 4C+1+j];
    # j 0..3 from block C, j 4..7 from block C+1 (shifted view; the right
    # pad of yp covers the frame edge)
    trow_wide = yp[0 : H : 4, 1 : W + 5].reshape(HB, WB + 1, 4)
    top4_g = trow_wide[:, :WB, :]
    ar4_g = trow_wide[:, 1 : WB + 1, :]
    # above-right replication rule (intra.cpp:345-370)
    bx_g = jnp.arange(WB)[None, :] * 4  # block x origin per column
    x0s_g = (jnp.arange(WB) % 4)[None, :] * 4  # x0 within MB
    y0s_g = (jnp.arange(HB) % 4)[:, None] * 4
    # Z-index of each raster position (for the blk in {3, 11} rule)
    rast_z = jnp.asarray(RASTER_TO_LUMA_BLOCK).reshape(4, 4)
    z_g = rast_z[jnp.arange(HB)[:, None] % 4, jnp.arange(WB)[None, :] % 4]
    repl_g = (
        (bx_g + 4 >= W)
        | ((x0s_g == 12) & (y0s_g > 0))
        | (z_g == 3)
        | (z_g == 11)
    )  # (HB, WB)
    if fh != hmb:
        bedge = (jnp.arange(HB) % (4 * fh)) == 0
        top4_g = jnp.where(bedge[:, None, None], -1, top4_g)
        ar4_g = jnp.where(bedge[:, None, None], -1, ar4_g)
        corner_g = jnp.where(bedge[:, None], -1, corner_g)
    last_g = top4_g[..., 3]
    ar_g = jnp.where(repl_g[..., None], last_g[..., None], ar4_g)
    p13_g = jnp.concatenate(
        [corner_g[..., None], left_g, top4_g, ar_g], axis=-1
    )  # (HB, WB, 13)
    # raster block grid → (nmb, 16 raster) → Z order
    p13_r = (
        p13_g.reshape(hmb, 4, wmb, 4, 13)
        .transpose(0, 2, 1, 3, 4)
        .reshape(nmb, 16, 13)
    )
    inv_z = jnp.asarray(np.argsort(np.asarray(RASTER_TO_LUMA_BLOCK)))
    p13 = p13_r[:, inv_z, :]
    top8 = p13[..., 5:13]
    left4 = p13[..., 1:5]
    corner4 = p13[..., 0]

    preds4 = intra.predict_4x4_all_modes(p13)  # (9, nmb, 16, 4, 4)
    src_blocks = _mb_blocks(src)  # (nmb, 16, 4, 4)
    satd4 = _satd_blocks(src_blocks[None] - preds4, qp)  # (9, nmb, 16)

    t_ok = top8[..., 0] != -1  # (nmb, 16)
    l_ok = left4[..., 0] != -1
    c_ok = corner4 != -1
    Z = jnp.zeros_like(t_ok, dtype=jnp.int32)

    def g(ok):
        return jnp.where(ok, 0, BIG)

    gate4 = jnp.stack([
        g(t_ok), g(l_ok), Z, g(t_ok), g(c_ok), g(c_ok), g(c_ok), g(t_ok), g(l_ok)
    ])
    satd4g = satd4 + gate4
    mode4 = jnp.argmin(satd4g, axis=0)  # (nmb, 16)
    best4_satd = satd4g.min(axis=0).sum(axis=-1)  # (nmb,)

    if modes_only:
        # wavefront callers recompute prediction/levels themselves
        return {
            "mode16": mode16,
            "satd16": best16_satd,
            "mode4": mode4,
            "satd4": best4_satd,
        }

    # winning I16 prediction + its quantized levels (DC path + AC)
    pred16 = jnp.take_along_axis(
        preds16, mode16[None, :, None, None], axis=0
    )[0]  # (nmb, 16, 16)
    diff16 = _mb_blocks(src - pred16)
    d16 = transform.forward_transform_4x4(diff16)
    q16 = transform.quantize_residual(d16, qp, True)

    return {
        "mode16": mode16,
        "satd16": best16_satd,
        "mode4": mode4,
        "satd4": best4_satd,
        "pred16": pred16,
        "q16": q16,
    }


# Jitted top-level entry. Device programs that EMBED the mode decision
# (device_iframe, parallel/tile, parallel/mesh) must call
# intra_mode_decision_impl instead: nesting an already-executed jitted
# function inside another jit trips a jax-0.9 const-lifting bug where the
# outer executable expects the inner trace's hoisted table constants as
# parameters that dispatch never supplies ("Execution supplied 4 buffers
# but compiled program expected 128 buffers").
intra_mode_decision = functools.partial(
    jax.jit,
    static_argnames=("wmb", "hmb", "qp", "modes_only", "frame_hmb",
                     "i16_only"))(intra_mode_decision_impl)


class DeviceIntraPipeline:
    """Session wrapper: jit-compiled per frame geometry, device-resident."""

    def __init__(self, width: int, height: int, qp: int) -> None:
        self.wmb, self.hmb, self.qp = width // 16, height // 16, qp

    def __call__(self, y: np.ndarray):
        out = intra_mode_decision(
            jnp.asarray(y, jnp.int32), wmb=self.wmb, hmb=self.hmb, qp=self.qp
        )
        return out

    def modes_to_host(self, out):
        return (
            np.asarray(out["mode16"]),
            np.asarray(out["mode4"]),
            np.asarray(out["satd16"]),
            np.asarray(out["satd4"]),
        )
